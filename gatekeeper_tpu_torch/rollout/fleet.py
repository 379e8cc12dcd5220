# Copied from gatekeeper_tpu/rollout/fleet.py for the PyTorch port.
"""Fleet-scale evidence-gated graduation.

Extends the stacked-cluster ``fleet_audit`` (whatif/fleet.py) into a
map-reduce tree:

- **map**: clusters are grouped into device-sized blocks
  (``GATEKEEPER_FLEET_BLOCK``, default 8).  Each block runs two batched
  audits over the stacked cluster axis (K3b, K1b, K2b a kind) — one
  under the live (baseline) policy set, one under the candidate set
  built over the same store contents — so a 100-cluster fleet costs
  ~2·⌈100/8⌉ stacked dispatches a kind instead of 200 audits.
- **reduce**: host-side, per cluster: the baseline→candidate verdict
  diff (msg-insensitive, the ShadowSession ``_diff_key`` convention)
  rolls up into per-cluster evidence — ``added`` violations are the
  would-be-unexpected-denials that block that cluster's graduation.

Failure isolation is per cluster, not per fleet: a straggler cluster
(the ``fleet_straggler`` injected fault, or a per-cluster error of the
engine's own kinds, ``GatekeeperError``) marks only itself ``held``; a
block whose clusters cannot stack (``FleetStackError``) runs the
per-cluster loop oracle, counted in ``loop_blocks``, so its healthy
members still graduate with evidence.  Unlike the reference, which
falls back on any failure of the stacked audit, every other exception
of an audit (a kernel's build or launch among them) is raised.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

from gatekeeper_tpu_torch.errors import GatekeeperError
from gatekeeper_tpu_torch.whatif.fleet import (FleetCluster,
                                               FleetStackError, fleet_audit,
                                               fleet_loop_oracle,
                                               make_cluster)

GRADUATED = "graduated"
BLOCKED = "blocked"
HELD = "held"


def fleet_block_size() -> int:
    try:
        return max(1, int(os.environ.get("GATEKEEPER_FLEET_BLOCK", "8")))
    except ValueError:
        return 8


def _diff_key(v: tuple) -> tuple:
    return v[:-1]                      # msg-insensitive, shadow.py idiom


@dataclasses.dataclass
class ClusterEvidence:
    name: str
    status: str                        # graduated | blocked | held
    added: int = 0                     # candidate-only violations
    cleared: int = 0                   # baseline-only violations
    baseline_digest: str = ""
    candidate_digest: str = ""
    error: str = ""


@dataclasses.dataclass
class FleetGraduationReport:
    n_clusters: int
    n_blocks: int
    block_size: int
    graduated: int
    blocked: int
    held: int
    per_cluster: List[ClusterEvidence]
    device_dispatches: int
    wall_s: float
    loop_blocks: int = 0               # audits run per cluster (no stack)

    def headline(self) -> str:
        return (f"fleet: {self.graduated}/{self.n_clusters} graduated, "
                f"{self.blocked} blocked, {self.held} held "
                f"({self.n_blocks} blocks × ≤{self.block_size}, "
                f"{self.device_dispatches} stacked dispatches, "
                f"{self.wall_s:.2f}s)")


def _store_state(cluster: FleetCluster) -> dict:
    return cluster.driver._state(cluster.handler.name).table.snapshot_state()


def _candidate_twin(cluster: FleetCluster, templates: List[dict],
                    constraints: List[dict]) -> FleetCluster:
    """A fresh cluster with the candidate set over this cluster's
    store contents, on a ``TorchDriver`` on the cluster's device.  The
    injected straggler fault trips here — one cluster per process, by
    faults.take's one-shot contract."""
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.resilience import faults
    if faults.take("fleet_straggler"):
        raise RuntimeError(f"fleet_straggler: {cluster.name}")
    device = cluster.driver.device
    return make_cluster(cluster.name, templates, constraints,
                        store_state=_store_state(cluster),
                        driver_factory=lambda: TorchDriver(device=device))


def _audit_block(block: List[FleetCluster], limit: int):
    """Stacked block audit: returns (verdicts_by_name, digests_by_name,
    errors_by_name, dispatches, looped).  A block whose clusters cannot
    stack runs the per-cluster loop (``looped`` True), whose
    per-cluster ``GatekeeperError`` holds only its cluster.  Any other
    exception is raised: the reference falls back to the loop on every
    failure, which would hide a broken batched kernel behind the
    per-cluster sweeps."""
    verdicts: Dict[str, list] = {}
    digests: Dict[str, str] = {}
    errors: Dict[str, str] = {}
    try:
        rep = fleet_audit(block, limit)
    except FleetStackError:
        pass
    else:
        for i, cl in enumerate(block):
            verdicts[cl.name] = rep.verdicts[i]
            digests[cl.name] = rep.digests[i]
        return verdicts, digests, errors, rep.device_dispatches, False
    for cl in block:
        try:
            v, d, _w = fleet_loop_oracle([cl], limit)
            verdicts[cl.name] = v[0]
            digests[cl.name] = d[0]
        except GatekeeperError as e:
            errors[cl.name] = str(e)
    return verdicts, digests, errors, 0, True


def graduate_fleet(clusters: List[FleetCluster], templates: List[dict],
                   constraints: List[dict], *,
                   limit_per_constraint: int = 20,
                   block_size: Optional[int] = None
                   ) -> FleetGraduationReport:
    """Graduate a candidate policy set across the whole fleet in one
    map-reduce pass, with per-cluster evidence."""
    from gatekeeper_tpu_torch.obs.trace import get_tracer
    if not clusters:
        raise ValueError("graduate_fleet needs at least one cluster")
    t0 = time.perf_counter()
    limit = limit_per_constraint
    bsz = block_size or fleet_block_size()
    blocks = [clusters[i:i + bsz] for i in range(0, len(clusters), bsz)]
    per_cluster: List[ClusterEvidence] = []
    dispatches = looped = 0
    with get_tracer().span("fleet_graduate", cat="rollout",
                           clusters=len(clusters), blocks=len(blocks)):
        for bi, block in enumerate(blocks):
            with get_tracer().span(f"fleet_block:{bi}", cat="rollout",
                                   size=len(block)):
                base_v, base_d, base_err, n, lp = _audit_block(block,
                                                               limit)
                dispatches += n
                looped += lp
                twins: List[FleetCluster] = []
                held: Dict[str, str] = {}
                for cl in block:
                    if cl.name in base_err:
                        held[cl.name] = base_err[cl.name]
                        continue
                    try:
                        twins.append(_candidate_twin(cl, templates,
                                                     constraints))
                    except Exception as e:      # noqa: BLE001
                        held[cl.name] = str(e)
                cand_v, cand_d, cand_err, n, lp = \
                    _audit_block(twins, limit) if twins \
                    else ({}, {}, {}, 0, False)
                dispatches += n
                looped += lp
                held.update(cand_err)
                for cl in block:
                    if cl.name in held:
                        per_cluster.append(ClusterEvidence(
                            name=cl.name, status=HELD,
                            error=held[cl.name]))
                        continue
                    base_keys = {_diff_key(v) for v in base_v[cl.name]}
                    cand_keys = {_diff_key(v) for v in cand_v[cl.name]}
                    added = sum(1 for v in cand_v[cl.name]
                                if _diff_key(v) not in base_keys)
                    cleared = sum(1 for v in base_v[cl.name]
                                  if _diff_key(v) not in cand_keys)
                    per_cluster.append(ClusterEvidence(
                        name=cl.name,
                        status=BLOCKED if added else GRADUATED,
                        added=added, cleared=cleared,
                        baseline_digest=base_d[cl.name],
                        candidate_digest=cand_d[cl.name]))
    return FleetGraduationReport(
        n_clusters=len(clusters), n_blocks=len(blocks), block_size=bsz,
        graduated=sum(1 for c in per_cluster if c.status == GRADUATED),
        blocked=sum(1 for c in per_cluster if c.status == BLOCKED),
        held=sum(1 for c in per_cluster if c.status == HELD),
        per_cluster=per_cluster, device_dispatches=dispatches,
        wall_s=time.perf_counter() - t0, loop_blocks=looped)
