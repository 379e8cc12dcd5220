"""The ``torch`` driver: the capped audit sweep on a CUDA device.

Port of the JAX package's engine/jax_driver.py ``JaxDriver`` along its
audit path only, plugged into the same Driver seam (client/interface.py):

  1. per template kind: lowered program + bindings (columns, host
     tables, per-constraint tensors) — cached by (table generation,
     constraint-set version), with incremental host updates under churn;
  2. device: violation mask [n_constraints, n_resources] (K1 + K3),
     ANDed with the vectorized match mask (engine/match.py), then the
     per-constraint count + top-k (K2) when the audit is capped;
  3. host: only the capped violating pairs are re-evaluated with the
     scalar oracle to produce exact messages/details.

This is the reference's legacy full-kind sweep — the path JaxDriver
takes with ``GATEKEEPER_PAGES=off GATEKEEPER_FOOTPRINT=off
GATEKEEPER_DEDUP=off`` — which the reference documents as a
bit-identical oracle for its later layers.  Templates outside the
lowerable subset, kinds whose numbers are not float32-exact, and
workloads below ``SMALL_WORKLOAD_EVALS`` run on the scalar oracle.
Admission review batches, the churn delta plan, device pages, what-if
and sharding are not part of this port yet; the review path is the
scalar engine's (LocalDriver).
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from gatekeeper_tpu_torch.api.templates import CompiledTemplate
from gatekeeper_tpu_torch.client.interface import QueryOpts
from gatekeeper_tpu_torch.client.local_driver import (LocalDriver,
                                                      TargetState, locked,
                                                      locked_read)
from gatekeeper_tpu_torch.client.types import Result
from gatekeeper_tpu_torch.engine.executor import ProgramExecutor, pad_rank
from gatekeeper_tpu_torch.ir.lower import CannotLower, lower_template
from gatekeeper_tpu_torch.ir.prep import build_bindings
from gatekeeper_tpu_torch.rego.values import freeze
from gatekeeper_tpu_torch.utils.metrics import Metrics


class _TrivialMatch:
    """Sentinel mask: every alive row matches every constraint (no
    spec.match anywhere).  Indexable like the real mask so host-side
    candidate checks stay uniform."""

    def __getitem__(self, _idx):
        return True

    def __bool__(self):
        return True


TRIVIAL_MATCH = _TrivialMatch()


class _RowOrder:
    """Dict-like row -> sorted-key position, backed by an inverse
    permutation array (building a 1M-entry Python dict is a measurable
    cold-start tax; formatting only ever probes a capped handful)."""

    __slots__ = ("_pos", "_n")

    def __init__(self, ordered_rows: np.ndarray):
        n = int(ordered_rows.max()) + 1 if len(ordered_rows) else 0
        self._pos = np.full((n,), -1, dtype=np.int64)
        self._pos[ordered_rows] = np.arange(len(ordered_rows), dtype=np.int64)
        self._n = len(ordered_rows)

    def __len__(self) -> int:
        return self._n

    def __contains__(self, row) -> bool:
        return 0 <= row < len(self._pos) and self._pos[row] >= 0

    def __getitem__(self, row) -> int:
        p = self._pos[row] if 0 <= row < len(self._pos) else -1
        if p < 0:
            raise KeyError(row)
        return int(p)


SMALL_WORKLOAD_EVALS = 20_000
"""Below this many (resource, constraint) pairs per kind, the scalar
engine serves the kind: a device dispatch and fetch has a fixed cost
that only amortizes over enough work.  The scalar path produces
identical results (it is the oracle), so routing is purely a latency
decision.  Tests set it to 0 to drive the device path at small sizes."""


class TorchTargetState(TargetState):
    def __init__(self):
        super().__init__()
        self.con_version: dict[str, int] = {}      # kind -> bump on change
        self.bindings_cache: dict[str, tuple] = {}  # kind -> (cache key, b)
        self.bindings_retired: dict[str, tuple] = {}  # kind -> (ver, old b)
        self.mask_cache: dict[str, tuple] = {}
        # kind -> the padded mask currently installed as a bindings
        # __match__ array: that buffer may still be referenced by host
        # formatting and by the device cache, so the mask ping-pong must
        # never overwrite it in place
        self.installed_match: dict[str, object] = {}
        self.rank_cache: tuple | None = None       # (generation, rank arr)
        self.order_cache: tuple | None = None      # (gen, ordered_rows, row_order)
        self.fmt_cache: dict[str, tuple] = {}      # kind -> (con_ver, {(cname,row): (ver, results)})
        self.match_engine = None

    def bump(self, kind: str) -> None:
        self.con_version[kind] = self.con_version.get(kind, 0) + 1


class TorchDriver(LocalDriver):
    """Driver with a device-evaluated capped audit.  ``device`` is CUDA
    unless the caller asks otherwise; on a host without a GPU the
    default raises (utils/device.resolve_device)."""

    def __init__(self, tracing: bool = False, device=None):
        super().__init__(tracing=tracing)
        self.executor = ProgramExecutor(device)
        self.device = self.executor.device
        self.metrics = Metrics()
        # serializes reader-side cache fills (bindings/mask prep):
        # racing audit readers would otherwise interleave interner
        # appends and column/cache mutations across kinds
        self._prep_lock = threading.Lock()

    def init(self, targets) -> None:
        self.targets = dict(targets)
        for name in targets:
            self.state.setdefault(name, TorchTargetState())

    # ------------------------------------------------------------------
    # templates and constraints

    @locked
    def put_template(self, target: str, kind: str,
                     compiled: CompiledTemplate) -> None:
        if compiled.vectorized is None:
            try:
                compiled.vectorized = lower_template(compiled.module,
                                                     compiled.interp)
            except CannotLower:
                compiled.vectorized = None  # scalar fallback
        st = self._state(target)
        st.templates[kind] = compiled
        st.bump(kind)

    @locked
    def delete_template(self, target: str, kind: str) -> None:
        super().delete_template(target, kind)
        self._state(target).bump(kind)

    @locked
    def put_constraint(self, target: str, kind: str, name: str,
                       constraint: dict) -> None:
        super().put_constraint(target, kind, name, constraint)
        self._state(target).bump(kind)

    @locked
    def delete_constraint(self, target: str, kind: str, name: str) -> None:
        super().delete_constraint(target, kind, name)
        self._state(target).bump(kind)

    # ------------------------------------------------------------------
    # per-kind host prep

    def _match_engine(self, st: TorchTargetState, target: str):
        if st.match_engine is None:
            st.match_engine = self.targets[target].make_match_engine(st.table)
        return st.match_engine

    def _kind_constraints(self, st: TargetState, kind: str) -> list[dict]:
        return [st.constraints[kind][n]
                for n in sorted(st.constraints.get(kind, {}))]

    def _kind_mask(self, st: TorchTargetState, target: str, kind: str,
                   constraints: list[dict]):
        """(mask [C, n_rows] view, padded).  The mask
        is kept in its padded [c_pad, r_pad] form (the device layout) and
        delta-maintained under churn: one copy + dirty-column writes per
        generation instead of full re-matching + re-padding.  Delta is
        bypassed when a Namespace object changed (namespaceSelector
        results of unchanged rows may shift, table.namespaces_dirty_since)
        or rows were remapped."""
        from gatekeeper_tpu_torch.ir.prep import audit_pads
        from gatekeeper_tpu_torch.store.table import delta_worthwhile
        engine = self._match_engine(st, target)
        if engine is None:
            return None, None
        if all(not (c.get("spec") or {}).get("match") for c in constraints):
            # no constraint carries match criteria: every alive resource
            # matches; the device gates on __alive__ alone and no [C, R]
            # mask is built or shipped
            return TRIVIAL_MATCH, None
        table = st.table
        gen, remap = table.generation, table.remap_generation
        conver = self.con_version_of(st, kind)
        n = table.n_rows
        n_con = len(constraints)
        r_pad, c_pad = audit_pads(n, n_con)
        hit = st.mask_cache.get(kind)
        if hit is not None and hit[0] == (gen, conver):
            padded = hit[2]
            return padded[:n_con, :n], padded
        if hit is not None and hit[1] == (conver, remap) \
                and hit[2].shape == (c_pad, r_pad):
            prev_gen = hit[0][0]
            old = hit[3]            # retired (gen, padded) or None
            # ping-pong: overwrite the retired buffer (two updates old)
            # at the rows dirty since ITS generation — O(|dirty|) writes
            # instead of an O(c_pad*r_pad) copy.  Requires (a) no
            # Namespace churn since the buffer's generation and (b) the
            # buffer not being the one currently installed in the
            # bindings arrays.
            if old is not None and old[1].shape == (c_pad, r_pad) \
                    and old[1] is not hit[2] \
                    and old[1] is not st.installed_match.get(kind) \
                    and not table.namespaces_dirty_since(old[0]):
                buf, since = old[1], min(old[0], prev_gen)
            elif not table.namespaces_dirty_since(prev_gen):
                buf, since = None, prev_gen        # copy-on-write path
            else:
                buf = since = -1                   # full rebuild
            if since != -1:
                rows = table.dirty_rows_since(since)
                if delta_worthwhile(len(rows), n):
                    sub, rows = engine.mask_rows_since(constraints, since) \
                        if len(rows) else (None, rows)
                    if buf is None:
                        buf = hit[2].copy()
                    if len(rows):
                        flat = (np.arange(n_con, dtype=np.int64)[:, None]
                                * buf.shape[1] + rows[None, :]).ravel()
                        buf.ravel()[flat] = sub.ravel()
                    st.mask_cache[kind] = ((gen, conver), (conver, remap),
                                           buf, (prev_gen, hit[2]))
                    return buf[:n_con, :n], buf
        padded = np.zeros((c_pad, r_pad), dtype=bool)
        padded[:n_con, :n] = engine.mask(constraints)
        st.mask_cache[kind] = ((gen, conver), (conver, remap), padded, None)
        return padded[:n_con, :n], padded

    def _kind_bindings(self, st: TorchTargetState, kind: str,
                       compiled: CompiledTemplate, constraints: list[dict]):
        """Per-kind bindings with incremental host updates under churn.
        Retired bindings (two updates old) are recycled as write buffers
        (ping-pong); the executor copies every array it uploads, so the
        recycled numpy buffers never alias device data."""
        from gatekeeper_tpu_torch.ir.prep import update_bindings
        key = (st.table.generation, self.con_version_of(st, kind))
        hit = st.bindings_cache.get(kind)
        if hit is not None and hit[0] == key:
            return hit[1]
        if hit is not None and hit[0][1] == key[1]:
            retired = st.bindings_retired.get(kind)
            recycle = retired[1] if retired is not None \
                and retired[0] == key[1] else None
            b = update_bindings(compiled.vectorized.spec, st.table,
                                constraints, hit[1], recycle=recycle)
            if b is not None:
                # carry the gate-source identities so unchanged gates
                # are not re-installed
                for attr in ("_match_src", "_rank_src"):
                    if attr in hit[1].__dict__:
                        b.__dict__[attr] = hit[1].__dict__[attr]
                self.metrics.counter("bindings_delta_updates").inc()
                st.bindings_retired[kind] = (key[1], hit[1])
                st.bindings_cache[kind] = (key, b)
                return b
        bindings = build_bindings(compiled.vectorized.spec, st.table,
                                  constraints)
        self.metrics.counter("bindings_full_builds").inc()
        st.bindings_retired.pop(kind, None)
        st.bindings_cache[kind] = (key, bindings)
        return bindings

    def _ensure_order(self, st):
        """Sorted-cache-key row order (matches the scalar driver) with
        its key_generation-keyed cache; pure updates never re-sort."""
        kgen = st.table.key_generation
        if st.order_cache is not None and st.order_cache[0] == kgen:
            _, ordered_rows, row_order = st.order_cache
            return ordered_rows, row_order
        items = list(st.table.rows_items())
        if len(items) > 65536:
            # numpy lexicographic sort of the key strings instead of a
            # Python tuple sort
            keys = np.array([k for k, _ in items])
            rows_arr = np.fromiter((r for _, r in items),
                                   dtype=np.int64, count=len(items))
            order = np.argsort(keys, kind="stable")
            ordered_np = rows_arr[order]
            ordered_rows = ordered_np.tolist()
            row_order = _RowOrder(ordered_np)
        else:
            ordered_rows = [row for _, row in sorted(items)]
            row_order = {row: i for i, row in enumerate(ordered_rows)}
        st.order_cache = (kgen, ordered_rows, row_order)
        return ordered_rows, row_order

    def _install_gates(self, st, kind: str, bindings,
                       mask: np.ndarray | None,
                       rank: np.ndarray | None,
                       padded: np.ndarray | None = None) -> None:
        """Attach the padded match mask and rank as regular bindings
        arrays ("__match__", "__rank__") so they ride the same per-name
        device cache as the columns.  `padded` is the mask's canonical
        padded form from _kind_mask, installed without any copy."""
        # bindings.arrays is REBOUND (never mutated in place): concurrent
        # readers may be iterating the old dict
        d = bindings.__dict__
        if mask is TRIVIAL_MATCH:
            if "__match__" in bindings.arrays:
                # constraints lost their match criteria: drop the stale
                # gate (alive-only gating is exact now)
                bindings.arrays = {k: v for k, v in bindings.arrays.items()
                                   if k != "__match__"}
                d.pop("_match_src", None)
            st.installed_match.pop(kind, None)
            mask = None
        if mask is not None \
                and bindings.arrays.get("__match__") is not padded \
                and d.get("_match_src") is not mask:
            if padded is None or \
                    padded.shape != (bindings.c_pad, bindings.r_pad):
                padded = np.zeros((bindings.c_pad, bindings.r_pad),
                                  dtype=bool)
                padded[: mask.shape[0], : mask.shape[1]] = mask
            bindings.arrays = {**bindings.arrays, "__match__": padded}
            d["_match_src"] = mask
            st.installed_match[kind] = padded
        if rank is not None and d.get("_rank_src") is not rank:
            bindings.arrays = {**bindings.arrays,
                               "__rank__": pad_rank(rank, bindings.r_pad)}
            d["_rank_src"] = rank

    def _row_rank(self, st: TorchTargetState, row_order) -> np.ndarray:
        """[n_rows] int32: row -> sorted-cache-key rank.  The device
        top-k scores by this rank so the capped subset matches the
        scalar driver's cap order.  Keyed on key_generation — pure
        updates reuse one array instance (device cache stays hot)."""
        kgen = st.table.key_generation
        if st.rank_cache is not None and st.rank_cache[0] == kgen:
            return st.rank_cache[1]
        n = st.table.n_rows
        rank = np.full((n,), n - 1, dtype=np.int32)
        if isinstance(row_order, _RowOrder):
            m = min(len(row_order._pos), n)
            pos = row_order._pos[:m]
            valid = pos >= 0
            rank[:m][valid] = pos[valid].astype(np.int32)
        elif row_order:
            rows = np.fromiter(row_order.keys(), dtype=np.int64,
                               count=len(row_order))
            rank[rows] = np.fromiter(row_order.values(), dtype=np.int32,
                                     count=len(row_order))
        st.rank_cache = (kgen, rank)
        return rank

    @staticmethod
    def con_version_of(st, kind: str) -> int:
        return st.con_version.get(kind, 0)

    # ------------------------------------------------------------------
    # the audit sweep

    @locked_read
    def query_audit(self, target: str, opts: QueryOpts | None = None) \
            -> tuple[list[Result], str | None]:
        t_start = time.perf_counter()
        st = self._state(target)
        if not isinstance(st, TorchTargetState):
            return super().query_audit(target, opts)
        handler = self.targets[target]
        tracing = opts.tracing if opts is not None else self.default_tracing
        limit = opts.limit_per_constraint if opts is not None else None
        full = opts.full if opts is not None else False
        trace: list | None = [] if tracing else None
        m = self.metrics

        if full:
            # forced full sweep: drop every layer of sweep memoization
            # (rebind, never .clear(): concurrent readers keep theirs)
            with self._prep_lock:
                st.mask_cache = {}
                st.bindings_cache = {}
                st.bindings_retired = {}
                st.installed_match = {}
                st.fmt_cache = {}

        ordered_rows, row_order = self._ensure_order(st)
        rank = self._row_rank(st, row_order)
        # phase 1, on the sweep thread: host prep and dispatch per kind.
        # Launches are asynchronous, so kind N's device work overlaps
        # kind N+1's host prep.
        specs: list[tuple] = []
        with self._prep_lock:
            for kind in sorted(st.templates):
                compiled = st.templates[kind]
                constraints = self._kind_constraints(st, kind)
                if not constraints:
                    continue
                mask, padded = self._kind_mask(st, target, kind,
                                               constraints)
                small = len(ordered_rows) * len(constraints) \
                    < SMALL_WORKLOAD_EVALS
                if compiled.vectorized is None or mask is None or small:
                    # unlowerable template — or a workload too small to
                    # amortize a device dispatch
                    specs.append(("scalar", kind, compiled, constraints,
                                  None, None, mask, None))
                    continue
                bindings = self._kind_bindings(st, kind, compiled,
                                               constraints)
                if bindings.f32_unsafe:
                    # some bound numeric value does not survive a float32
                    # round-trip: device ordering compares could
                    # mis-order, so this kind runs on the scalar oracle
                    m.counter("f32_unsafe_scalar_fallbacks").inc()
                    specs.append(("scalar", kind, compiled, constraints,
                                  None, None, mask, None))
                    continue
                self._install_gates(st, kind, bindings, mask, rank, padded)
                prog = compiled.vectorized.program
                if limit is not None:
                    handle = self.executor.run_topk_async(prog, bindings,
                                                          limit)
                    mode = "topk"
                else:
                    handle = self.executor.run_async(prog, bindings)
                    mode = "mask"
                specs.append((mode, kind, compiled, constraints, prog,
                              bindings, mask, handle))
        t_prep = time.perf_counter()
        m.timer("audit_prep_submit").observe(t_prep - t_start)

        # phase 2: resolve handles and host-format per kind, in sorted
        # kind order; the tagged sort restores the scalar driver's order
        rcache: dict[int, tuple] = {}
        tagged: list[tuple[tuple, Result]] = []
        for mode, kind, compiled, constraints, prog, bindings, mask, \
                handle in specs:
            if mode == "topk":
                self._format_topk(st, target, handler, compiled,
                                  constraints, prog, bindings, row_order,
                                  kind, limit, trace, tagged, handle,
                                  rcache)
            elif mode == "mask":
                self._format_pairs(st, target, handler, compiled,
                                   constraints, handle.get(), row_order,
                                   kind, limit, trace, tagged, rcache)
            else:
                self._scalar_kind(st, target, handler, compiled,
                                  constraints, mask, ordered_rows,
                                  row_order, kind, limit, trace, tagged,
                                  rcache)
        tagged.sort(key=lambda kv: kv[0])
        m.timer("audit_format").observe(time.perf_counter() - t_prep)
        m.counter("audit_sweeps").inc()
        m.counter("audit_results").inc(len(tagged))
        m.timer("audit_sweep_wall").observe(time.perf_counter() - t_start)
        m.gauge("audit_resources").set(len(ordered_rows))
        return [r for _, r in tagged], \
            ("\n".join(trace) if trace is not None else None)

    # ------------------------------------------------------------------
    # host formatting through the scalar oracle

    def _pair_results(self, st, target, kind, compiled, c, row, review,
                      frozen, trace, shared=None) -> list:
        """Memoized per-pair formatting: the oracle re-evaluation is
        skipped when neither the row (its table version) nor the kind's
        constraint set changed.  Inventory-reading templates key on the
        whole table generation; tracing bypasses the cache."""
        if trace is not None:
            return list(self._eval_pair(st, target, compiled, review, frozen,
                                        c, trace))
        con_ver = self.con_version_of(st, kind)
        hit = st.fmt_cache.get(kind)
        if hit is None or hit[0] != con_ver:
            hit = (con_ver, {})
            st.fmt_cache[kind] = hit
        entries = hit[1]
        ver = st.table.generation if compiled.uses_inventory \
            else st.table.version_at(row)
        cname = (c.get("metadata") or {}).get("name", "")
        key = (cname, row)
        ent = entries.get(key)
        if ent is None or ent[0] != ver:
            self.metrics.counter("format_memo_misses").inc()
            results = list(self._eval_pair(st, target, compiled, review,
                                           frozen, c, trace, shared))
            if len(entries) > 65536:     # bound growth across churn
                entries.clear()
            entries[key] = ent = (ver, results)
        else:
            self.metrics.counter("format_memo_hits").inc()
        # fresh copies (own metadata dict too): downstream sets
        # .resource and owns result.metadata
        return [dataclasses.replace(r, metadata=dict(r.metadata))
                for r in ent[1]]

    def _row_review(self, st, handler, row, rcache):
        """(review, frozen_review, shared_memo) for a table row, cached
        per sweep; None if the row is dead."""
        hit = rcache.get(row)
        if hit is None:
            meta = st.table.meta_at(row)
            if meta is None:
                return None
            review = handler.make_review(meta, st.table.object_at(row))
            hit = (review, freeze(review), {})
            rcache[row] = hit
        return hit

    def _format_pairs(self, st, target, handler, compiled, constraints,
                      cand: np.ndarray, row_order, kind, limit, trace,
                      tagged, rcache):
        """Host-format violating (constraint, resource) pairs via the
        scalar oracle; over-approximated pairs yield no results."""
        for ci, c in enumerate(constraints):
            rows = np.nonzero(cand[ci])[0]
            rows = sorted((r for r in rows.tolist() if r in row_order),
                          key=row_order.__getitem__)
            self._emit_rows(st, target, handler, compiled, c, rows,
                            row_order, kind, limit, trace, tagged, rcache)

    def _format_topk(self, st, target, handler, compiled, constraints,
                     prog, bindings, row_order, kind, limit, trace, tagged,
                     handle, rcache):
        """Capped audit: the device found the first-k candidate rows per
        constraint (in scalar cap order, via rank); the host formats only
        those.  If over-approximated pairs leave the cap under-filled
        while more candidates exist, fall back to the full mask for that
        constraint."""
        t0 = time.perf_counter()
        counts, rows, valid = handle.get()
        self.metrics.timer("device_wait").observe(time.perf_counter() - t0)
        full_cand = None
        for ci, c in enumerate(constraints):
            sel = [int(r) for r, v in zip(rows[ci], valid[ci]) if v]
            sel = sorted((r for r in sel if r in row_order),
                         key=row_order.__getitem__)
            emitted = self._emit_rows(st, target, handler, compiled, c, sel,
                                      row_order, kind, limit, trace, tagged,
                                      rcache)
            if emitted < limit and int(counts[ci]) > len(sel):
                if full_cand is None:
                    full_cand = self.executor.run(prog, bindings)
                sel_set = set(sel)
                rest = sorted((ri for ri in
                               map(int, np.nonzero(full_cand[ci])[0])
                               if ri in row_order and ri not in sel_set),
                              key=row_order.__getitem__)
                self._emit_rows(st, target, handler, compiled, c, rest,
                                row_order, kind, limit - emitted, trace,
                                tagged, rcache)

    def _emit_rows(self, st, target, handler, compiled, c, rows, row_order,
                   kind, limit, trace, tagged, rcache) -> int:
        emitted = 0
        cname = (c.get("metadata") or {}).get("name", "")
        for row in rows:
            if limit is not None and emitted >= limit:
                break
            pair = self._row_review(st, handler, row, rcache)
            if pair is None:
                continue
            review, frozen, shared = pair
            results = self._pair_results(st, target, kind, compiled, c, row,
                                         review, frozen, trace, shared)
            for r in results:
                tagged.append(((row_order[row], kind, cname), r))
            emitted += len(results)
        return emitted

    def _scalar_kind(self, st, target, handler, compiled, constraints,
                     mask, ordered_rows, row_order, kind, limit, trace,
                     tagged, rcache):
        """Scalar oracle for unlowerable or routed kinds, restricted to
        match-mask candidates when a vector matcher exists."""
        emitted = {ci: 0 for ci in range(len(constraints))}
        for row in ordered_rows:
            if limit is not None and all(e >= limit
                                         for e in emitted.values()):
                break            # every constraint capped: stop scanning
            if st.table.meta_at(row) is None:
                continue
            pair = None
            for ci, c in enumerate(constraints):
                if limit is not None and emitted[ci] >= limit:
                    continue
                if mask is not None:
                    if not mask[ci, row]:
                        continue
                else:
                    if pair is None:
                        pair = self._row_review(st, handler, row, rcache)
                    if not any(True for _ in handler.matching_constraints(
                            pair[0], [c], st.table)):
                        continue
                if pair is None:
                    pair = self._row_review(st, handler, row, rcache)
                review, frozen, shared = pair
                results = self._pair_results(st, target, kind, compiled, c,
                                             row, review, frozen, trace,
                                             shared)
                for r in results:
                    tagged.append(((row_order[row], kind,
                                    (c.get("metadata") or {}).get("name",
                                                                  "")), r))
                emitted[ci] += len(results)
