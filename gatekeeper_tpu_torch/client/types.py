# Copied from gatekeeper_tpu/client/types.py for the PyTorch port.
"""Result/Response types returned by Review/Audit.

Mirrors the constraint framework's types package (reference:
vendor/.../constraint/pkg/types/validation.go:11-91) so control-plane code
(audit manager, webhook) consumes the same shapes.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass
class Result:
    msg: str = ""
    metadata: dict = dataclasses.field(default_factory=dict)
    constraint: dict | None = None      # the full constraint object
    review: Any = None                  # target-specific review payload
    resource: Any = None                # set by HandleViolation for audit hits
    enforcement_action: str = "deny"


ENFORCEMENT_ACTIONS = ("deny", "dryrun", "warn")
"""Recognized ``spec.enforcementAction`` values (reference:
apis/constraints ValidActions).  Anything else is treated as deny —
fail closed on typos."""


def enforcement_action_of(constraint: dict | None) -> str:
    """A constraint's effective enforcement action, normalized."""
    action = ((constraint or {}).get("spec") or {}).get("enforcementAction")
    if isinstance(action, str) and action in ENFORCEMENT_ACTIONS:
        return action
    return "deny"


@dataclasses.dataclass
class Response:
    target: str
    results: list[Result] = dataclasses.field(default_factory=list)
    trace: str | None = None
    input: Any = None

    def trace_dump(self) -> str:
        lines = [f"Target: {self.target}"]
        if self.trace is not None:
            lines += ["Trace:", self.trace]
        else:
            lines.append("Trace: TRACING DISABLED")
        if self.input is not None:
            lines += ["Input:", json.dumps(self.input, indent=2, default=str)]
        return "\n".join(lines)


@dataclasses.dataclass
class Responses:
    by_target: dict[str, Response] = dataclasses.field(default_factory=dict)
    handled: dict[str, bool] = dataclasses.field(default_factory=dict)

    def results(self) -> list[Result]:
        out: list[Result] = []
        for t in sorted(self.by_target):
            out.extend(self.by_target[t].results)
        return out

    def trace_dump(self) -> str:
        return "\n\n".join(r.trace_dump() for _, r in sorted(self.by_target.items()))
