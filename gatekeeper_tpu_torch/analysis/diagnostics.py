# Copied from gatekeeper_tpu/analysis/diagnostics.py for the PyTorch port.
"""Diagnostic records for the static-analysis pass.

A :class:`Diagnostic` is the unit finding emitted by both analysis
stages (the Rego front-end vetter and the lowered-IR verifier).  Codes
follow the reference gatekeeper's ``status.byPod[].errors`` shape
(``rego_parse_error``, ``rego_type_error``, ...): a short snake_case
string keyed by family prefix — ``rego_*`` for Stage-1 AST findings,
``ir_*`` for Stage-2 device-program findings — so a controller can
forward a finding into status unchanged (see
controllers/constrainttemplate.py).

Severity is two-valued: ``error`` findings reject the template at
install time; ``warning`` findings are recorded but admit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from gatekeeper_tpu_torch.errors import Location

ERROR = "error"
WARNING = "warning"


@dataclass(frozen=True)
class Diagnostic:
    code: str
    severity: str           # "error" | "warning"
    message: str
    location: Location = field(default_factory=Location)

    def format(self) -> str:
        """``file:row:col severity code: message`` — the probe --lint
        output line (file part dropped when unset)."""
        loc = self.location
        pos = f"{loc.row}:{loc.col}"
        if loc.file:
            pos = f"{loc.file}:{pos}"
        return f"{pos} {self.severity} {self.code}: {self.message}"


def errors(diags: list[Diagnostic]) -> list[Diagnostic]:
    return [d for d in diags if d.severity == ERROR]


def has_errors(diags: list[Diagnostic]) -> bool:
    return any(d.severity == ERROR for d in diags)


def format_all(diags: list[Diagnostic]) -> str:
    return "\n".join(d.format() for d in diags)
