# Copied from gatekeeper_tpu/whatif/__init__.py for the PyTorch port.
"""What-if engine: policy simulation on the audit kernels.

Only the fleet audit is ported (:mod:`.fleet`): stack N clusters'
columnar stores along a leading cluster axis and evaluate each kind as
one batched sweep with a per-cluster capped top-k, behind the Stage-5
footprint and Stage-6 partition-plan gates; a per-cluster loop is the
bit-identical oracle.  The shadow policy-set and replay entry points of
the JAX package are not ported yet.

Verdicts are reported in one normalized form (`normalize_results`) whose
sha256 digest (`verdict_digest`) is the parity currency of the package
and its tests.
"""

from __future__ import annotations

import hashlib

SHADOW_SEP = "__WHATIF__"
"""Kind-name separator for shadow policy-set versions (copy of the JAX
package's analysis/policyset.py ``SHADOW_SEP``)."""


def split_shadow_kind(kind: str) -> tuple[str, str | None]:
    """(logical kind, version tag or None for the live set); copy of
    the JAX package's analysis/policyset.py ``split_shadow_kind``."""
    base, sep, tag = kind.partition(SHADOW_SEP)
    return (base, tag) if sep else (base, None)


def normalize_result(r) -> tuple:
    """One Result -> a driver-independent verdict tuple.  Shadow kinds
    collapse to their logical kind."""
    con = r.constraint or {}
    kind, _tag = split_shadow_kind(con.get("kind", ""))
    cname = (con.get("metadata") or {}).get("name", "")
    review = r.review if isinstance(r.review, dict) else {}
    rk = review.get("kind") or {}
    return (kind, cname,
            rk.get("group", ""), rk.get("version", ""), rk.get("kind", ""),
            review.get("namespace") or "", review.get("name", ""),
            r.msg)


def normalize_results(results) -> list[tuple]:
    return sorted(normalize_result(r) for r in results)


def verdict_digest(verdicts: list[tuple]) -> str:
    """Order-independent sha256 over normalized verdicts — 16 hex
    chars."""
    return hashlib.sha256(
        repr(sorted(verdicts)).encode()).hexdigest()[:16]


from gatekeeper_tpu_torch.whatif.fleet import (FleetReport, fleet_audit,  # noqa: E402
                                               fleet_loop_oracle,
                                               make_cluster)

__all__ = [
    "normalize_result", "normalize_results", "verdict_digest",
    "FleetReport", "fleet_audit", "fleet_loop_oracle", "make_cluster",
]
