# Copied from gatekeeper_tpu/whatif/__init__.py for the PyTorch port.
"""What-if engine: policy simulation on the audit kernels.

Three entry points over one engine path:

- ``shadow`` — stage a candidate policy set *beside* the live one under
  a version tag and evaluate both in a single forced full sweep; the
  dedup plan shares canonical conjuncts across the versions, an
  unchanged twin kind takes its live kind's device result, and the
  report is a would-be-denied diff (``added`` / ``cleared`` violations
  per constraint) plus a parity digest bit-identical to installing the
  candidate standalone.
- ``replay`` — re-audit a store snapshot payload, or re-review a
  recorded admission-stream corpus (obs/flightrecorder), against either
  policy set: "what would this change have rejected last week?".
- ``fleet`` — stack N clusters' columnar stores along a leading cluster
  axis and evaluate each kind as one batched sweep with a per-cluster
  capped top-k, behind the Stage-5 footprint and Stage-6 partition-plan
  gates; a per-cluster loop is the bit-identical oracle.

Verdicts are reported in one normalized form (`normalize_results`) whose
sha256 digest (`verdict_digest`) is the parity currency of the package
and its tests.
"""

from __future__ import annotations

import hashlib

from gatekeeper_tpu_torch.analysis.policyset import split_shadow_kind


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


from gatekeeper_tpu_torch.whatif.shadow import (  # noqa: E402
    ShadowReport, ShadowSession, standalone_candidate_verdicts)
from gatekeeper_tpu_torch.whatif.replay import (  # noqa: E402
    ReplayReport, StreamReplayReport, load_historical_store,
    replay_admissions, replay_admissions_batched, replay_snapshot)
from gatekeeper_tpu_torch.whatif.fleet import (FleetReport, fleet_audit,  # noqa: E402
                                               fleet_loop_oracle,
                                               make_cluster)

__all__ = [
    "normalize_result", "normalize_results", "verdict_digest",
    "ShadowSession", "ShadowReport", "standalone_candidate_verdicts",
    "ReplayReport", "StreamReplayReport", "load_historical_store",
    "replay_snapshot", "replay_admissions", "replay_admissions_batched",
    "FleetReport", "fleet_audit", "fleet_loop_oracle", "make_cluster",
]
