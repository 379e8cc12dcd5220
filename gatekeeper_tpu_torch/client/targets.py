# Copied from gatekeeper_tpu/client/targets.py for the PyTorch port.
"""TargetHandler contract.

The native redesign of the reference's TargetHandler interface
(vendor/.../constraint/pkg/client/client.go:103-135).  Where the reference
target supplies a ~230-line *Rego* matching library rendered into the
engine (pkg/target/target.go:29-257), a TPU-native target supplies the
same semantics as host code (`matching_constraints`, `autoreject_review`,
`make_review`) that the drivers call directly — the vectorized driver
additionally builds match *masks* from the same spec (engine/match.py).
"""

from __future__ import annotations

import abc
from typing import Any, Iterable

from gatekeeper_tpu_torch.client.types import Result
from gatekeeper_tpu_torch.store.table import ResourceMeta, ResourceTable


class UnhandledData(Exception):
    """ProcessData/HandleReview: object is not for this target."""


class WipeData:
    """Sentinel passed to remove_data to wipe all cached data for a target
    (reference: pkg/target/target.go WipeData, config_controller.go:185)."""


class TargetHandler(abc.ABC):
    name: str

    @abc.abstractmethod
    def process_data(self, obj: Any) -> tuple[str, ResourceMeta, dict]:
        """Map an object to (cache path key, identity meta, stored doc).
        Raises UnhandledData if the target does not own this object."""

    @abc.abstractmethod
    def handle_review(self, obj: Any) -> dict:
        """Convert a review request into the review payload dict.
        Raises UnhandledData if not recognized."""

    @abc.abstractmethod
    def handle_violation(self, result: Result) -> None:
        """Populate result.resource from result.review."""

    @abc.abstractmethod
    def match_schema(self) -> dict:
        """JSONSchema for constraint spec.match."""

    @abc.abstractmethod
    def validate_constraint(self, constraint: dict) -> None:
        """Raise ClientError on invalid constraint content."""

    # --- native match library (replaces Library() Rego) ---

    @abc.abstractmethod
    def matching_constraints(self, review: dict, constraints: Iterable[dict],
                             table: ResourceTable) -> Iterable[dict]:
        """Constraints whose spec.match selects this review."""

    @abc.abstractmethod
    def autoreject_review(self, review: dict, constraints: Iterable[dict],
                          table: ResourceTable) -> list[tuple[dict, str, dict]]:
        """[(constraint, msg, details)] for constraints that must autoreject
        this review (e.g. namespaceSelector with uncached namespace)."""

    @abc.abstractmethod
    def make_review(self, meta: ResourceMeta, obj: dict) -> dict:
        """Review payload for a cached resource during audit."""

    def make_match_engine(self, table: ResourceTable):
        """Optional vectorized matcher: an object with
        ``mask(constraints) -> bool [n_constraints, n_rows]`` agreeing
        with matching_constraints.  None -> the jax driver matches
        scalar-side (generic test targets)."""
        return None
