# Copied from gatekeeper_tpu/whatif/fleet.py for the PyTorch port.
"""Multi-cluster batched audit: N stores, one batched sweep per kind.

Every cluster runs the SAME policy programs, so the fleet sweep pads
each cluster's bound arrays to a common shape, stacks them along a
leading cluster axis, and evaluates each kind in one batched device
sweep (item B9): batched K3 for its regex tables, batched K1 for the
violation masks of all N clusters, batched K2 for the per-cluster
count and capped top-k (engine/executor.run_topk_batched).  Host
formatting then runs per cluster through the same scalar oracle the
single-cluster sweep uses, so `fleet_loop_oracle` (a plain per-cluster
audit loop) is bit-identical by construction.

Eligibility reuses the install-time certificates: a kind is stacked
only when its Stage-5 footprint certifies row-locality with no external
providers AND its Stage-6 partition plan (when present) is eligible.
Everything else (scalar templates, cross-row inventory joins) runs the
per-cluster replicated path inside the same call.

Padding safety: padded rows are dead (``__alive__`` False) and every
gather in the evaluator is clamped or sentinel-guarded, so zero-fill is
sound — EXCEPT the per-constraint ``.any``/``.all``/``.bitmap`` tables,
whose u-axis pad must replicate the sentinel column (an ``.all`` row for
an empty-param constraint is vacuously True everywhere, and
out-of-range value ids land on the LAST column after stacking).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

_EDGE_PAD_SUFFIXES = (".any", ".all", ".bitmap")


@dataclasses.dataclass
class FleetCluster:
    name: str
    client: object
    driver: object
    handler: object


def make_cluster(name: str, templates: list[dict], constraints: list[dict],
                 objs: list | None = None,
                 store_state: dict | None = None,
                 driver_factory=None) -> FleetCluster:
    """One simulated cluster: a fresh driver (``driver_factory()``,
    default ``TorchDriver()`` on CUDA) and client with the shared policy
    set and either an object batch or a store snapshot."""
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
    if driver_factory is None:
        from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
        driver_factory = TorchDriver
    driver = driver_factory()
    handler = K8sValidationTarget()
    client = Backend(driver).new_client([handler])
    for doc in templates:
        client.add_template(doc)
    for doc in constraints:
        client.add_constraint(doc)
    if store_state is not None:
        driver.adopt_store(handler.name, store_state)
    if objs:
        client.add_data_batch(objs)
    return FleetCluster(name=name, client=client, driver=driver,
                        handler=handler)


@dataclasses.dataclass
class FleetReport:
    n_clusters: int
    verdicts: list[list[tuple]]      # per cluster, normalized
    digests: list[str]               # per cluster
    kinds_stacked: list[str]
    kinds_replicated: dict           # kind -> reason
    device_dispatches: int           # stacked dispatches (1 per kind)
    wall_s: float


def _pad_to(arr: np.ndarray, shape: tuple, edge: bool) -> np.ndarray:
    if arr.shape == shape:
        return arr
    widths = [(0, t - s) for s, t in zip(arr.shape, shape)]
    return np.pad(arr, widths, mode="edge" if edge else "constant")


def _stack_reason(driver, st, kind, compiled) -> str | None:
    """Why a kind can NOT ride the stacked path (None: eligible)."""
    if compiled.vectorized is None:
        return "scalar_template"
    if driver.scalar_only:
        return "backend_degraded"
    fp = st.footprints.get(kind)
    if fp is None:
        return "no_footprint"
    if not fp.row_local:
        return "not_row_local"
    if fp.providers:
        return "external_providers"
    sp = st.shardplans.get(kind)
    if sp is not None and not getattr(sp, "eligible", False):
        return "partition_plan_ineligible"
    return None


def fleet_audit(clusters: list[FleetCluster],
                limit_per_constraint: int = 20) -> FleetReport:
    """The stacked sweep.  Single-threaded entry point — per-cluster
    driver internals are driven directly under each driver's prep lock.
    The batched kernels run on the first cluster's executor, so every
    cluster's driver must be on the same device."""
    from gatekeeper_tpu_torch.engine.executor import pad_rank
    from gatekeeper_tpu_torch.engine.torch_driver import TRIVIAL_MATCH
    from gatekeeper_tpu_torch.whatif import normalize_results, verdict_digest

    if not clusters:
        raise ValueError("fleet_audit needs at least one cluster")
    devices = {str(c.driver.device) for c in clusters}
    if len(devices) > 1:
        raise ValueError(f"fleet clusters' drivers are on different "
                         f"devices: {sorted(devices)}")
    t0 = time.perf_counter()
    limit = limit_per_constraint
    target = clusters[0].handler.name
    drivers = [c.driver for c in clusters]
    executor = drivers[0].executor
    sts = [d._state(target) for d in drivers]
    orders = [d._ensure_order(st) for d, st in zip(drivers, sts)]
    ranks = [d._row_rank(st, ro) for d, st, (_o, ro)
             in zip(drivers, sts, orders)]

    kinds = sorted(sts[0].templates)
    for st in sts[1:]:
        if sorted(st.templates) != kinds:
            raise ValueError("fleet clusters must share one policy set")

    tagged = [[] for _ in clusters]
    rcaches: list[dict] = [{} for _ in clusters]
    kinds_stacked: list[str] = []
    kinds_replicated: dict = {}
    dispatches = 0

    def _replicated(kind, reason, cons_by_cluster, masks):
        kinds_replicated[kind] = reason
        for i, (d, st) in enumerate(zip(drivers, sts)):
            cons = cons_by_cluster[i]
            if not cons:
                continue
            mask = masks[i] if masks is not None else None
            if mask is None or mask is TRIVIAL_MATCH:
                mask = None
            ordered_rows, row_order = orders[i]
            d._scalar_kind(st, target, clusters[i].handler,
                           st.templates[kind], cons, mask, ordered_rows,
                           row_order, kind, limit, None, tagged[i],
                           rcaches[i])

    for kind in kinds:
        cons_by_cluster = [d._kind_constraints(st, kind)
                           for d, st in zip(drivers, sts)]
        if not any(cons_by_cluster):
            continue
        if any(c != cons_by_cluster[0] for c in cons_by_cluster[1:]):
            raise ValueError(
                f"fleet clusters disagree on constraints for {kind}")
        compiled = sts[0].templates[kind]
        reason = None
        for d, st in zip(drivers, sts):
            reason = _stack_reason(d, st, kind, st.templates[kind])
            if reason is not None:
                break
        if reason is not None:
            _replicated(kind, reason, cons_by_cluster, None)
            continue

        # per-cluster host prep through the same seams the single
        # cluster sweep uses: exact match mask, bindings, rank gate
        per_arrays: list[dict] = []
        masks = []
        try:
            for i, (d, st) in enumerate(zip(drivers, sts)):
                with d._prep_lock:
                    cons = cons_by_cluster[i]
                    mask, _dirty, padded = d._kind_mask(st, target, kind,
                                                        cons)
                    masks.append(mask)
                    if mask is None:
                        raise LookupError("no vector matcher")
                    b = d._kind_bindings(st, kind, st.templates[kind], cons)
                    if b.f32_unsafe:
                        raise LookupError("f32_unsafe")
                    arrays = dict(b.arrays)
                    arrays.pop("__match__", None)
                    if mask is not TRIVIAL_MATCH:
                        pm = padded
                        if pm is None or pm.shape != (b.c_pad, b.r_pad):
                            pm = np.zeros((b.c_pad, b.r_pad), dtype=bool)
                            pm[:mask.shape[0], :mask.shape[1]] = mask
                        arrays["__match__"] = pm
                    arrays["__rank__"] = pad_rank(ranks[i], b.r_pad)
                    per_arrays.append(arrays)
        except LookupError as e:
            masks += [None] * (len(clusters) - len(masks))
            _replicated(kind, str(e), cons_by_cluster, masks)
            continue
        if any(m is TRIVIAL_MATCH for m in masks) and \
                any(m is not TRIVIAL_MATCH for m in masks):
            # mixed trivial/real masks would need per-instance input
            # sets; constraints are identical so this cannot happen,
            # but fail safe to the oracle path if it ever does
            _replicated(kind, "mixed_match_gates", cons_by_cluster, masks)
            continue

        names = sorted(per_arrays[0])
        if any(sorted(a) != names for a in per_arrays[1:]):
            _replicated(kind, "binding_name_mismatch", cons_by_cluster,
                        masks)
            continue
        ckey = compiled.vectorized.program.cache_key()
        if any(st.templates[kind].vectorized.program.cache_key() != ckey
               for st in sts[1:]):
            _replicated(kind, "program_mismatch", cons_by_cluster, masks)
            continue
        stacked = {}
        for nm in names:
            arrs = [a[nm] for a in per_arrays]
            shape = tuple(max(s) for s in zip(*[x.shape for x in arrs]))
            edge = nm.endswith(_EDGE_PAD_SUFFIXES)
            stacked[nm] = np.stack([_pad_to(x, shape, edge) for x in arrs])

        program = compiled.vectorized.program
        counts, rows, valid = executor.run_topk_batched(program, stacked,
                                                        limit)
        dispatches += 1
        kinds_stacked.append(kind)

        full_cand = None

        def _full_mask(i, stacked=stacked, program=program):
            nonlocal full_cand
            if full_cand is None:
                full_cand = executor.run_mask_batched(program, stacked)
            return full_cand[i]

        for i, (d, st) in enumerate(zip(drivers, sts)):
            cons = cons_by_cluster[i]
            _ordered, row_order = orders[i]
            handler = clusters[i].handler
            cl_compiled = st.templates[kind]
            for ci, c in enumerate(cons):
                sel = [int(r) for r, v in zip(rows[i, ci], valid[i, ci])
                       if v]
                sel = sorted((r for r in sel if r in row_order),
                             key=row_order.__getitem__)
                emitted = d._emit_rows(st, target, handler, cl_compiled, c,
                                       sel, row_order, kind, limit, None,
                                       tagged[i], rcaches[i])
                if emitted < limit and int(counts[i, ci]) > len(sel):
                    # over-approximated pairs left the cap under-filled:
                    # widen to this cluster's slice of the (lazily
                    # computed, still stacked) full mask
                    sel_set = set(sel)
                    rest = sorted(
                        (ri for ri in map(int,
                                          np.nonzero(_full_mask(i)[ci])[0])
                         if ri in row_order and ri not in sel_set),
                        key=row_order.__getitem__)
                    d._emit_rows(st, target, handler, cl_compiled, c, rest,
                                 row_order, kind, limit - emitted, None,
                                 tagged[i], rcaches[i])

    verdicts: list[list[tuple]] = []
    digests: list[str] = []
    for i, cl in enumerate(clusters):
        tagged[i].sort(key=lambda kv: kv[0])
        results = [r for _key, r in tagged[i]]
        for r in results:
            cl.handler.handle_violation(r)
        v = normalize_results(results)
        verdicts.append(v)
        digests.append(verdict_digest(v))
    return FleetReport(
        n_clusters=len(clusters), verdicts=verdicts, digests=digests,
        kinds_stacked=kinds_stacked, kinds_replicated=kinds_replicated,
        device_dispatches=dispatches, wall_s=time.perf_counter() - t0)


def fleet_loop_oracle(clusters: list[FleetCluster],
                      limit_per_constraint: int = 20):
    """The bit-identical baseline: one full single-cluster audit per
    cluster.  Returns (per-cluster normalized verdicts, digests,
    wall_s)."""
    from gatekeeper_tpu_torch.whatif import normalize_results, verdict_digest
    t0 = time.perf_counter()
    verdicts = []
    for cl in clusters:
        resp = cl.client.audit(limit_per_constraint=limit_per_constraint,
                               full=True)
        verdicts.append(normalize_results(resp.results()))
    return (verdicts, [verdict_digest(v) for v in verdicts],
            time.perf_counter() - t0)
