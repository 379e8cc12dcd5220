# Copied from gatekeeper_tpu/errors.py for the PyTorch port.
"""Framework error taxonomy.

Mirrors the error surfaces of the reference: Rego parse/compile errors are
reported with code + message + location (so they can land in
``status.byPod[].errors`` the way the reference records template errors,
cf. constrainttemplate_controller.go:143-158), while client-level errors
(unknown template, bad constraint, path conflicts) are distinct types.
"""

from __future__ import annotations

import dataclasses


class GatekeeperError(Exception):
    """Base class for all framework errors."""


@dataclasses.dataclass
class Location:
    """Source location of a parse/compile diagnostic."""

    row: int = 0
    col: int = 0
    file: str = ""

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.file or '<rego>'}:{self.row}:{self.col}"


class RegoError(GatekeeperError):
    """A Rego front-end error with an error code and location.

    Codes follow the reference's shape (`rego_parse_error`,
    `rego_type_error`, ...) so status reporting looks familiar.
    """

    def __init__(self, code: str, message: str, location: Location | None = None):
        self.code = code
        self.location = location or Location()
        super().__init__(f"{code}: {message} ({self.location})")
        self.message = message


class ParseError(RegoError):
    def __init__(self, message: str, location: Location | None = None):
        super().__init__("rego_parse_error", message, location)


class CompileError(RegoError):
    def __init__(self, message: str, location: Location | None = None):
        super().__init__("rego_compile_error", message, location)


class TypeError_(RegoError):
    def __init__(self, message: str, location: Location | None = None):
        super().__init__("rego_type_error", message, location)


class VetError(RegoError):
    """Static-analysis rejection (gatekeeper_tpu/analysis): the template
    carries at least one error-severity finding.  ``code``/``message``/
    ``location`` describe the FIRST error finding (so existing RegoError
    status plumbing works unchanged); the full list — warnings included —
    rides in ``diagnostics`` for callers that can record more than one
    ``status.byPod[].errors`` entry."""

    def __init__(self, diagnostics):
        errs = [d for d in diagnostics if d.severity == "error"]
        first = errs[0] if errs else diagnostics[0]
        self.diagnostics = list(diagnostics)
        super().__init__(first.code, first.message, first.location)


class EvalError(GatekeeperError):
    """Runtime evaluation error (conflict, builtin failure with strictness)."""


class ConflictError(EvalError):
    """Complete rule / function produced two different values."""


class ExternalDataError(GatekeeperError):
    """External-data provider failure surfaced under failurePolicy Fail.

    Deliberately NOT a BuiltinError subclass: builtin errors route to
    undefined (rule silently doesn't fire -> request admitted), which is
    exactly the wrong outcome for a fail-closed provider.  This type
    propagates out of evaluation so the webhook denies with 500 and the
    audit sweep can contain the failure per template kind."""


class StorageError(GatekeeperError):
    """Path-addressed data store errors (conflicts, missing parents)."""


class ClientError(GatekeeperError):
    """Constraint-framework client errors (bad template/constraint, etc.)."""


class ApiError(GatekeeperError):
    """Cluster API errors (the k8s apierrors analogue)."""


class NotFoundError(ApiError):
    """Object does not exist (apierrors.IsNotFound)."""


class AlreadyExistsError(ApiError):
    """Create of an existing object (apierrors.IsAlreadyExists)."""


class ApiConflictError(ApiError):
    """Optimistic-concurrency conflict on update (apierrors.IsConflict) —
    drives the controllers' Requeue paths."""
