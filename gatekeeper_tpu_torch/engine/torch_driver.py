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

Non-full, untraced sweeps take the reference's default route
(``GATEKEEPER_PAGES`` on): every page-eligible kind — lowered, with a
row-local Stage-5 footprint and no provider or inventory reads — is
served from the target's VerdictLedger (enforce/ledger.py), which the
sweep first brings current by re-evaluating only the rows of dirty
pages through the scalar oracle (``_paged_kind``), or, under
``GATEKEEPER_DEVPAGES=on``, by consuming the device's delta stream
against the resident mask (``_devpaged_kind``: K4, K7, K3, K1, then
K6).  Under devpages a kind whose only cross-row dependency is a lowered
inventory join (K8sUniqueIngressHost) is paged too: K7 recomputes the
join over the whole table on every delta sweep.  Under
``GATEKEEPER_DEVPAGES_BUDGET_BYTES`` a kind's resident mask keeps only
its LRU-hot pages on the device between sweeps (the residency planner,
enforce/devpages.py, with K8).
Every other kind, and every kind under ``GATEKEEPER_PAGES=off``, takes
the legacy full-kind sweep, where two reuse layers sit, each with its
reference's ``=off`` oracle:
- footprint-driven selective reuse (``GATEKEEPER_FOOTPRINT``, on): a
  non-full, untraced sweep replays a row-local kind's captured K1/K2
  payload when no column path its template reads was dirtied since
  (``_selective_reuse``); a later churn that does touch the kind
  re-evaluates every row dirtied since its mask was computed;
- the cross-template dedup of forced full sweeps (``GATEKEEPER_DEDUP``,
  on): a conjunct several templates share is computed once on the host
  (analysis/policyset.py's twin of the plain evaluator) and injected as
  a bool column that each member's rewritten program reads
  (``_apply_dedup``), spliced at the dirty rows across sweeps.
With shadow kinds staged (whatif/shadow.py), a forced full sweep hands
an unchanged twin its live kind's K1/K2 result
(``GATEKEEPER_WHATIF_SHARE``).  ``GATEKEEPER_BINDING_DELTA=off`` rebuilds
bindings whole (the oracle of the delta chain).  Templates outside the
lowerable subset, kinds whose numbers are not float32-exact, and
workloads below ``SMALL_WORKLOAD_EVALS`` run on the scalar oracle.
Under churn the host masks and bindings are delta-maintained, and the
executor keeps the violation mask on the device: dirty rows are
scattered into the device columns and re-evaluated into the stored mask
(engine/executor.py "delta" plan).
Template install runs the Stage-2 IR verifier (analysis/ir_verifier.py:
a malformed lowered program is pinned to the scalar oracle) and the
Stage-5 footprint and Stage-6 partition-plan certifiers
(analysis/footprint.py, analysis/shardplan.py): the paged route reads
the first, the fleet audit (whatif/fleet.py) both; the Stage-8
memory-surface certificate (analysis/memsurface.py) gates the install
against the device-memory budget, sizes the residency planner and orders
a forced full sweep's kinds and the largest admission batch.

A batch ingest of ``MIRROR_EAGER_MIN_ROWS`` rows or more builds each
kind's bindings at once (the eager mirror) and compiles each kind's full
K1 variant, and its dedup rewrite's, on background ``ingest-prewarm``
threads, so the first sweep finds its kernels built; the delta warm-up
after the first capped sweep does the same for the rewrites.  An
admission micro-batch (``query_review_batch``) of
``REVIEW_BATCH_MIN_EVALS`` (review, constraint) pairs or more runs as
one [C, B] device pass per kind (K3, K1) over a throwaway mini table,
and only its candidates are verified on the host;
``predict_review_batch_seconds`` prices a batch with the static cost
model.  ``react_kind`` and ``resync_kind`` fold the store's
dirty pages into the ledger between sweeps for the watch-driven reactor
(enforce/reactor.py).  A forced full sweep (``QueryOpts.full``) drops
every memo layer and dispatches its kinds one at a time, each finished
before the next kind's prep, with its host prep, upload, device and
format seconds, bytes uploaded and overlap reported in
``last_sweep_phases``: the reference's ``GATEKEEPER_FULL_SWEEP_SERIAL``
mode.  The reference's default, a pool of 8 dispatch threads, lost to
it on the card's host at every store measured (ROADMAP Queue C).
``explain_pair`` dumps one (constraint, resource) pair through the plain
evaluator.  Sharding is not part of this port yet.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import threading
import time

import numpy as np
import torch

from gatekeeper_tpu_torch.api.templates import CompiledTemplate
from gatekeeper_tpu_torch.client.interface import QueryOpts
from gatekeeper_tpu_torch.client.local_driver import (LocalDriver,
                                                      TargetState, locked,
                                                      locked_read)
from gatekeeper_tpu_torch.client.types import Result, enforcement_action_of
from gatekeeper_tpu_torch.errors import ExternalDataError
from gatekeeper_tpu_torch.engine.executor import (BG_SHUTDOWN,
                                                  ProgramExecutor, pad_rank,
                                                  spawn_bg)
from gatekeeper_tpu_torch.ir.lower import CannotLower, lower_template
from gatekeeper_tpu_torch.ir.prep import build_bindings
from gatekeeper_tpu_torch.rego.values import Obj, freeze
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

MIRROR_EAGER_MIN_ROWS = 50_000
"""Batch ingests at/above this row count eagerly materialize the
columnar mirror (element axes + per-kind bindings) and start background
compiles of each kind's full K1 variant, so the first audit after a
restart spends its wall on dispatch and fetch, not on prep the store
could have done at write time.  Keyed to the batch, not the table: a
steady stream of small watch batches on a large table must not re-run
mirror prep under the writer lock on every write."""


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


REVIEW_BATCH_MIN_EVALS = _env_int("GATEKEEPER_REVIEW_BATCH_MIN_EVALS",
                                  4096 * 200 + 1)
"""Below this many (review, constraint) pairs, a coalesced admission
batch stays on the scalar engine.  ``GATEKEEPER_REVIEW_BATCH_MIN_EVALS``
overrides it at import; ``query_review_batch`` reads the module
attribute at each call, so tests may set it.

Measured by ``chip_smoke.py``'s admission phase on an NVIDIA H100 80GB
HBM3 at 700 W (2026-10-18, two runs of the whole script from a clean
checkout), with both routing thresholds at 0, over 200 constraints
(K8sRequiredLabels and K8sAllowedRepos): the scalar engine served 82.5
and 66.7 reviews/s on one thread, the device batch 97.9 and 71.5,
74.0 and 68.8, 71.0 and 61.7, 77.8 and 69.2 reviews/s (means of the
timed batches) at 64, 256, 1,024 and 4,096 reviews.  The differences
are inside the spread of either side (at 64 the slowest batch ran at
82.4 and 66.7 reviews/s): the host still confirms every candidate
pair, and on this workload nearly every pair is a candidate.  No size
wins, so the threshold stays above the largest batch measured, 4,096 x
200 pairs.  A batch size the process has not seen also compiles its K1
variants first (1.1-1.8 s a kind at 64 reviews on that card's host),
which no deadline fit sees."""

DEFAULT_PREWARM_CAP = 20
"""Cap assumed for prewarmed audit variants: the audit manager's
per-constraint violation cap (Gatekeeper's pkg/audit/manager.go:35)."""


class _ResolvedHandle:
    """Pre-resolved stand-in for a PendingTopK/PendingMask handle:
    selective reuse replays a payload captured on a previous sweep
    instead of launching, and the format path only ever calls
    ``.get()``/``.block()``."""

    def __init__(self, payload):
        self._payload = payload

    def get(self):
        return self._payload

    def block(self):
        return self


SWEEP_CACHE_MAX_BYTES = 64 * 1024 * 1024
"""Per-kind payload cap for the selective-reuse sweep cache: top-k
payloads are tiny; uncapped [C, R] masks at cluster scale are not worth
holding for a maybe-reuse."""


def _semantic_fields(frozen) -> tuple:
    """What of a frozen constraint document can move its verdicts: its
    ``spec`` (match criteria, parameters, enforcement action) and its
    labels and annotations, the fields the upstream constraint
    framework's ``SemanticEqual`` compares.  ``status`` and the
    server-side metadata (``resourceVersion``, ``managedFields``) are
    outside it: what the audit manager's status writes and the
    controllers' byPod reports change (see ROADMAP, Queue C)."""
    if not isinstance(frozen, Obj):
        return (frozen,)
    meta = frozen.get("metadata")
    if not isinstance(meta, Obj):
        return (frozen.get("spec"), meta)
    return (frozen.get("spec"), meta.get("labels"), meta.get("annotations"))


def _ledger_digest(constraints: list[dict]) -> str:
    """The ledger entry's constraint-set digest over what can move a
    kind's verdicts: each constraint's kind and name, its ``spec`` and
    its labels and annotations.  The reference digests whole documents,
    so every audit's status writes, coming back as constraint re-puts,
    rebuild every paged kind at the next sweep or react; here, as for
    ``put_constraint``'s version (``_semantic_fields``), they do not
    (ROADMAP Queue C)."""
    from gatekeeper_tpu_torch.enforce.ledger import constraints_digest
    view = []
    for c in constraints:
        meta = c.get("metadata") or {}
        view.append({"kind": c.get("kind"), "name": meta.get("name"),
                     "labels": meta.get("labels"),
                     "annotations": meta.get("annotations"),
                     "spec": c.get("spec")})
    return constraints_digest(view)


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
        # install-time certificates (analysis/footprint.py, Stage 5;
        # analysis/shardplan.py, Stage 6): the footprint gates the paged
        # route and both gate the fleet audit's stacking
        self.footprints: dict[str, object] = {}
        self.shardplans: dict[str, object] = {}
        # Stage-8 memory-surface certificates (analysis/memsurface.py):
        # the devpages residency planner sizes its claim from them and
        # forced full sweeps order their kinds by them
        self.memsurfaces: dict[str, object] = {}
        # continuous enforcement (enforce/ledger.py): the target's
        # VerdictLedger (created on the first paged sweep), a restored
        # pagemap awaiting adoption (always None: the port has no
        # snapshot tier yet), and the dirty-log overflow watermark
        # already exported to metrics
        self.ledger = None
        self.ledger_restored: dict | None = None
        self.dirtylog_overflows_seen = 0
        # device-resident pages (enforce/devpages.py): per-kind
        # KindPages (resident mask + page table), and snapshot geometry
        # awaiting adoption (always None without a snapshot tier)
        self.devpages: dict[str, object] = {}
        self.devpages_geom: dict | None = None
        # kind -> last device sweep payload + guards, for footprint-
        # driven selective reuse (_selective_reuse)
        self.sweep_cache: dict[str, dict] = {}
        # dedup shared-conjunct columns carried across full sweeps:
        # digest -> (gen, remap, col); churn re-evaluates only the
        # dirty-row slice (policyset.eval_shared_host rows=...)
        self.dedup_shared_cache: dict = {}
        # added to the table's write generation by store_generation: an
        # adopted table's counters restart, so the offset moves past
        # every generation the old table reported
        self.generation_base = 0

    def bump(self, kind: str) -> None:
        self.con_version[kind] = self.con_version.get(kind, 0) + 1


@dataclasses.dataclass
class DeltaWarm:
    """The background warm-up that a driver starts after its first
    capped sweep: the churn-delta variants (K5) of the kinds it swept
    (``kinds``) and the full K1 variants of the dedup rewrites of those
    kinds (``rewritten``), which a forced full sweep runs; its thread,
    its seconds once it ended, and the exception it ended with, which
    the driver's next ``query_audit`` raises."""

    thread: threading.Thread | None = None
    kinds: int = 0
    rewritten: int = 0
    seconds: float | None = None
    error: BaseException | None = None


@dataclasses.dataclass
class IngestWarm:
    """The background compile of each kind's full K1 variant that a large
    batch ingest starts (``ingest-prewarm`` threads draining one queue),
    for the kinds' programs (``kinds``) and for their dedup rewrites
    (``rewritten``): its threads, its seconds once the last thread
    ended, and the first exception a thread ended with, which the
    driver's next ``query_audit`` raises."""

    threads: list = dataclasses.field(default_factory=list)
    kinds: int = 0
    rewritten: int = 0
    seconds: float | None = None
    error: BaseException | None = None


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
        # the last sweep's stanzas: "pages" (ledger route) and
        # "devpages" (device-resident deltas), as the reference reports
        self.last_sweep_phases: dict = {}
        # the warm-up of the churn-delta variants, one a driver (the
        # reference's _delta_warmed)
        self.delta_warm: DeltaWarm | None = None
        # the compile of each kind's full variant at a large batch
        # ingest (the newest; a later ingest waits for the one before)
        self.ingest_warm: IngestWarm | None = None
        # predict_review_batch_seconds' units by (batch size, kinds,
        # constraints)
        self._predict_cache: dict[tuple, float] = {}
        # target -> (policy-set digest, DedupPlan): the cross-template
        # dedup plan of the installed set (_audit_dedup_plan)
        self._dedup_plan_memo: dict[str, tuple] = {}

    def init(self, targets) -> None:
        self.targets = dict(targets)
        for name in targets:
            self.state.setdefault(name, TorchTargetState())

    @property
    def scalar_only(self) -> bool:
        """True when the device path is degraded and every kind must
        run on the scalar oracle.  The port has no resilience supervisor
        yet (the reference's health probes and breaker), so the device
        path is never degraded here: always False."""
        return False

    def _start_delta_warm(self, items: list, rewritten: list = (),
                          st=None) -> None:
        """Compile each ``(program, bindings)``'s K5 delta variant on a
        background ``delta-warmup`` thread (the reference's warm-up
        after the first capped sweep, ``jax_driver.py`` query_audit):
        the compiles hide in the audit interval instead of adding
        seconds to the first churned sweep.  Then each item of
        ``rewritten`` (:meth:`_rewritten_warm_items` over the target
        state ``st``) compiles the full K1 variant of a kind's dedup
        rewrite, which the first forced full sweep would otherwise
        compile, as the ingest warm does (:meth:`_warm_item`).  Unlike
        the reference's, an exception is kept, not swallowed:
        :meth:`query_audit` raises it, as a kernel-layer error of a
        sweep ends the sweep."""
        warm = self.delta_warm = DeltaWarm(kinds=len(items),
                                           rewritten=len(rewritten))
        executor = self.executor

        def run():
            t0 = time.perf_counter()
            try:
                for prog, bindings in items:
                    if BG_SHUTDOWN.is_set():
                        return
                    executor.prewarm_deltas(prog, bindings)
                for item in rewritten:
                    if BG_SHUTDOWN.is_set():
                        return
                    self._warm_item(st, item)
            except Exception as exc:    # raised by the next query_audit
                warm.error = exc
            finally:
                warm.seconds = time.perf_counter() - t0

        warm.thread = spawn_bg(run, "delta-warmup")

    def wait_delta_warm(self, timeout: float | None = None) -> float | None:
        """Join the delta warm-up if one was started and raise its
        exception, as the next :meth:`query_audit` would; its seconds,
        or None when none ran (or it still runs after ``timeout``)."""
        warm = self.delta_warm
        if warm is None or warm.thread is None:
            return None
        warm.thread.join(timeout)
        self._raise_warm_error()
        return warm.seconds

    def _raise_warm_error(self) -> None:
        for warm in (self.ingest_warm, self.delta_warm):
            if warm is not None and warm.error is not None:
                err, warm.error = warm.error, None
                raise err

    def _warm_item(self, st, item: tuple) -> None:
        """Compile one ``(kind, program, bindings, with_match, shared
        shapes)``'s full K1 variant, and load K2 and K3
        (``prewarm_audit_exec``), under ``_prep_lock``, which every
        sweep holds while it stages, migrates or rebuilds bindings: the
        warm's uploads into the per-bindings device cache never
        interleave with a sweep's.  An item whose bindings are no longer
        the kind's current ones (a churn or a forced full sweep replaced
        them, and the driver may recycle their host buffers) is skipped:
        the next sweep compiles what it needs itself."""
        kind, prog, bindings, with_match, extra = item
        with self._prep_lock:
            cur = st.bindings_cache.get(kind)
            if cur is None or cur[1] is not bindings:
                return
            self.executor.prewarm_audit_exec(prog, bindings,
                                             DEFAULT_PREWARM_CAP,
                                             with_match=with_match,
                                             extra=extra)

    def _start_ingest_warm(self, st: TorchTargetState,
                           items: list) -> None:
        """Compile each ``(kind, program, bindings, with_match, shared
        shapes)``'s full K1 variant, and load K2 and K3, on up to 4
        ``ingest-prewarm`` threads draining one queue (the reference's
        ingest prewarm, ``jax_driver.py`` _materialize_mirror): the
        compiles overlap the time until the first sweep instead of
        landing inside it.  Each item runs as :meth:`_warm_item`.

        A warm still running from an earlier ingest is joined first, and
        its unraised error carried over.  Unlike the reference's, an
        exception is kept, not swallowed: :meth:`query_audit` and
        :meth:`wait_ingest_warm` raise it."""
        prev = self.ingest_warm
        warm = self.ingest_warm = IngestWarm(
            kinds=sum(1 for it in items if it[4] is None),
            rewritten=sum(1 for it in items if it[4] is not None))
        if prev is not None:
            for t in prev.threads:
                t.join()
            warm.error = prev.error
        queue = list(items)
        qlock = threading.Lock()
        t0 = time.perf_counter()

        def drain():
            try:
                while not BG_SHUTDOWN.is_set():
                    with qlock:
                        if not queue or warm.error is not None:
                            return
                        item = queue.pop(0)
                    self._warm_item(st, item)
            except Exception as exc:    # raised by the next query_audit
                with qlock:
                    if warm.error is None:
                        warm.error = exc
            finally:
                with qlock:
                    # the last thread to end sets the warm's seconds
                    warm.seconds = time.perf_counter() - t0

        warm.threads = [spawn_bg(drain, "ingest-prewarm")
                        for _ in range(min(4, len(items)))]

    def wait_ingest_warm(self, timeout: float | None = None) \
            -> float | None:
        """Join the ingest warm if one was started and raise its
        exception, as the next :meth:`query_audit` would; its seconds,
        or None when none ran (or it still runs after ``timeout``)."""
        warm = self.ingest_warm
        if warm is None or not warm.threads:
            return None
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in warm.threads:
            t.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
        if warm.error is not None:
            err, warm.error = warm.error, None
            raise err
        if any(t.is_alive() for t in warm.threads):
            return None
        return warm.seconds

    @locked
    def adopt_store(self, target: str, state: dict) -> None:
        """Swap the target's columnar store for a fresh table built
        from a ``snapshot_state()`` payload: the load-a-snapshot-as-a-
        secondary-store path (whatif/replay.py).  Valid on a non-empty
        driver: every table-derived cache layer is dropped, because the
        new table's generation counters restart and would otherwise
        collide with cached keys from the old table.  Beyond the
        reference's layers that covers the port's own: the executor's
        device arrays and stored masks (they hang off the dropped
        bindings), device-resident pages, and the store generation the
        reactor compares (``store_generation`` moves past the old
        table's instead of restarting)."""
        from gatekeeper_tpu_torch.store.table import ResourceTable
        st = self._state(target)
        old_gen = self.store_generation(target) \
            if isinstance(st, TorchTargetState) else 0
        st.table = ResourceTable.from_state(state)
        st._inv_cache = None
        if isinstance(st, TorchTargetState):
            st.generation_base = old_gen + 1
            st.sweep_cache = {}
            st.dedup_shared_cache = {}
            st.devpages = {}
            st.devpages_geom = None
            st.bindings_cache = {}
            st.bindings_retired = {}
            st.mask_cache = {}
            st.installed_match = {}
            st.rank_cache = None
            st.order_cache = None
            st.fmt_cache = {}
            st.match_engine = None
            # the ledger's row ids and generation guards are meaningless
            # against the swapped table (its counters restart)
            st.ledger = None
            st.ledger_restored = None
            st.dirtylog_overflows_seen = 0
            for kind in list(st.templates):
                st.bump(kind)

    # ------------------------------------------------------------------
    # ingest: the eager mirror and the ingest warm

    @locked
    def put_data_batch(self, target: str, entries) -> None:
        # the parent method is itself @locked: run its body under this
        # writer hold
        LocalDriver.put_data_batch.__wrapped__(self, target, entries)
        st = self._state(target)
        if isinstance(st, TorchTargetState) \
                and len(entries) >= MIRROR_EAGER_MIN_ROWS:
            self._materialize_mirror(st, target)

    def _materialize_mirror(self, st, target: str) -> None:
        """Eagerly build what the first audit would otherwise build
        lazily: the shared element-axis extraction, each device kind's
        bindings, the sorted row order and the rank gate (a columnar
        store maintains its mirror on write).  On CUDA each kind's full
        K1 variant then compiles on background threads
        (:meth:`_start_ingest_warm`), with the gate set the first sweep
        installs: ``__match__`` when a constraint carries match
        criteria, ``__rank__`` always.  A kind whose bindings need an
        external-data provider that fails is left to the sweep.  Not
        warmed: a kind with float32-unsafe bindings (the sweep runs it
        on the scalar oracle), and, while the paged route is on
        (``GATEKEEPER_PAGES``, the default), a kind it serves: its
        sweeps re-evaluate pages on the host or, under devpages, launch
        the delta variant, never the full one.  With ``GATEKEEPER_DEDUP``
        on, the full variant of each kind's dedup rewrite in the current
        plan is warmed too (forced full sweeps run it, whatever the
        route)."""
        from gatekeeper_tpu_torch.enforce.ledger import pages_mode
        t0 = time.perf_counter()
        warm: list[tuple] = []
        paged = pages_mode()
        with self._prep_lock:
            self._prefetch_axes(st)
            for kind in sorted(st.templates):
                compiled = st.templates[kind]
                cons = self._kind_constraints(st, kind)
                if compiled.vectorized is None or not cons:
                    continue
                if self.scalar_only or \
                        st.table.n_rows * len(cons) < SMALL_WORKLOAD_EVALS:
                    continue
                try:
                    bindings = self._kind_bindings(st, kind, compiled, cons)
                except ExternalDataError:
                    continue
                if bindings.f32_unsafe or (
                        paged and self._pages_ineligible(st, kind, compiled)
                        is None):
                    continue
                with_match = any((c.get("spec") or {}).get("match")
                                 for c in cons)
                warm.append((kind, compiled.vectorized.program, bindings,
                             with_match, None))
            if self._dedup_on() and not self.scalar_only:
                plan = self._audit_dedup_plan(st, target)
                if plan is not None:
                    warm.extend(self._rewritten_warm_items(st, plan))
        _, row_order = self._ensure_order(st)
        self._row_rank(st, row_order)
        self.metrics.timer("mirror_materialize").observe(
            time.perf_counter() - t0)
        if warm and self.device.type == "cuda":
            self._start_ingest_warm(st, warm)

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
            if compiled.vectorized is not None:
                compiled.vectorized = self._verify_lowered(
                    kind, compiled.vectorized)
        st = self._state(target)
        if isinstance(st, TorchTargetState):
            # stage 5 (dependency footprint), then stage 6 (partition
            # plan, which reads stage 5's cross-row reason)
            fp = None
            if compiled.vectorized is not None:
                fp = self._footprint_lowered(kind, compiled)
            if fp is not None:
                st.footprints[kind] = fp
            else:
                st.footprints.pop(kind, None)
            sp = None
            if compiled.vectorized is not None:
                sp = self._shardplan_lowered(kind, compiled)
            if sp is not None:
                st.shardplans[kind] = sp
            else:
                st.shardplans.pop(kind, None)
            # stage 8 (memory surface): the conservative peak device
            # bytes; strict rejects an install over the budget
            ms_cert = self._memsurface_lowered(kind, compiled)
            if ms_cert is not None:
                st.memsurfaces[kind] = ms_cert
            else:
                st.memsurfaces.pop(kind, None)
        st.templates[kind] = compiled
        st.bump(kind)

    @staticmethod
    def _verify_lowered(kind: str, lowered):
        """Stage-2 IR verification (analysis/ir_verifier.py) on every
        program before a kernel can run it.  Structural checks only —
        the engine has no provider registry in scope.  A malformed
        program falls back to the scalar oracle (identical semantics,
        no device path) unless GATEKEEPER_IR_VERIFY=strict, which raises
        VetError instead; GATEKEEPER_IR_VERIFY=off skips the pass."""
        import os
        mode = os.environ.get("GATEKEEPER_IR_VERIFY", "fallback")
        if mode == "off":
            return lowered
        from gatekeeper_tpu_torch.analysis import verify_program
        from gatekeeper_tpu_torch.analysis.diagnostics import format_all
        diags = verify_program(lowered, providers=None, file=kind)
        if not diags:
            return lowered
        if mode == "strict":
            from gatekeeper_tpu_torch.errors import VetError
            raise VetError(diags)
        import logging
        logging.getLogger(__name__).warning(
            "IR verification failed for %s; falling back to the scalar "
            "oracle:\n%s", kind, format_all(diags))
        return None

    def _footprint_lowered(self, kind: str, compiled: CompiledTemplate):
        """Stage-5 dependency analysis (analysis/footprint.py) behind
        GATEKEEPER_FOOTPRINT=off|on|strict.  An analysis error must not
        take the install down: it is counted and the kind has no
        footprint.  ``strict`` (perturbation validation) is not ported
        and raises ClientError here, outside the error guard, so the
        install fails instead of carrying on without a footprint."""
        from gatekeeper_tpu_torch.analysis import footprint
        if footprint.mode() == "off":
            return None
        try:
            fp = footprint.certify(kind, compiled.vectorized)
        except Exception as e:   # noqa: BLE001 — analysis must not take
            # template install down with it
            from gatekeeper_tpu_torch.utils.log import logger
            logger("engine.torch_driver").warning(
                "footprint analysis errored", kind=kind, err=str(e))
            self.metrics.counter("footprint_errors").inc()
            return None
        if not fp.row_local:
            self.metrics.counter("footprint_cross_row").inc()
        return fp

    def _shardplan_lowered(self, kind: str, compiled: CompiledTemplate):
        """Stage-6 partition-plan certification (analysis/shardplan.py)
        behind GATEKEEPER_SHARDPLAN=off|warn|strict.  Never fails an
        install: an analysis error is counted and the kind has no plan.
        Ineligible plans (cross-row templates) ARE returned — callers
        read ``plan.eligible``.  ``strict`` (simulated-mesh validation)
        is not ported and raises ClientError outside the error guard."""
        from gatekeeper_tpu_torch.analysis import shardplan
        if shardplan.mode() == "off":
            return None
        try:
            plan = shardplan.certify(kind, compiled.vectorized)
        except Exception as e:   # noqa: BLE001 — analysis must not take
            # template install down with it
            from gatekeeper_tpu_torch.utils.log import logger
            logger("engine.torch_driver").warning(
                "shardplan analysis errored", kind=kind, err=str(e))
            self.metrics.counter("shardplan_errors").inc()
            return None
        if not plan.eligible:
            self.metrics.counter("shardplan_ineligible").inc()
        return plan

    def _memsurface_lowered(self, kind: str, compiled: CompiledTemplate):
        """Stage-8 memory-surface certification (analysis/memsurface.py)
        behind GATEKEEPER_HBM_BUDGET=off|warn|strict.  warn (default):
        certify the conservative peak device bytes and count budget
        breaches but serve anyway; strict: a template whose
        worst-signature peak exceeds the budget (GATEKEEPER_HBM_BUDGET_BYTES,
        else this driver's card's memory) fails the install with
        ``hbm_budget_exceeded``.  A scalar-pinned template gets the empty
        certificate.  The analysis is host code: an error in it is
        counted and leaves the kind without a certificate."""
        from gatekeeper_tpu_torch.analysis import memsurface
        if memsurface.mode() == "off":
            return None
        if compiled.vectorized is None:
            return memsurface.scalar_surface(kind)
        try:
            cert = memsurface.certify(kind, compiled, compiled.vectorized,
                                      self.device)
        except Exception as e:   # noqa: BLE001 — analysis must not take
            # template install down with it; no certificate just means
            # no budget gating or residency planning for this kind
            from gatekeeper_tpu_torch.utils.log import logger
            logger("engine.torch_driver").warning(
                "memory-surface analysis errored", kind=kind, err=str(e))
            self.metrics.counter("memsurface_errors").inc()
            return None
        reason = memsurface.budget_reason(cert, self.device)
        if reason is not None:
            self.metrics.counter("hbm_budget_exceeded").inc()
            from gatekeeper_tpu_torch.utils.log import logger
            logger("engine.torch_driver").warning(
                "memory surface exceeds the device-memory budget",
                kind=kind, reason=reason)
            if memsurface.mode() == "strict":
                from gatekeeper_tpu_torch.analysis.diagnostics import \
                    Diagnostic
                from gatekeeper_tpu_torch.errors import VetError
                raise VetError([Diagnostic(code="hbm_budget_exceeded",
                                           severity="error",
                                           message=f"{kind}: {reason}")])
        return cert

    def memsurface_sweep_order(self, st, kinds: list[str]) -> list[str]:
        """Stage-8 consumer: the dispatch order of a forced full sweep.
        Launches are asynchronous — while kind i's kernels drain, kind
        i+1's uploads and intermediates are already materializing, so
        the transient claims of *adjacent* kinds coexist.  Weaving the
        certified-peak order (largest, smallest, second-largest, ...)
        minimizes the worst adjacent-pair sum without changing the
        result: phase 2 re-sorts the tagged results into a total order.
        Sorted order when the stage is off, below three kinds, or when
        any kind lacks a certificate."""
        from gatekeeper_tpu_torch.analysis import memsurface
        base = sorted(kinds)
        if memsurface.mode() == "off" or len(base) < 3:
            return base
        peaks = {}
        for k in base:
            cert = st.memsurfaces.get(k)
            if not isinstance(cert, memsurface.MemorySurface):
                return base
            peaks[k] = 0 if cert.scalar_pin else cert.peak_bytes()
        ranked = sorted(base, key=lambda k: (-peaks[k], k))
        woven: list[str] = []
        lo, hi = 0, len(ranked) - 1
        while lo <= hi:
            woven.append(ranked[lo])
            if lo != hi:
                woven.append(ranked[hi])
            lo += 1
            hi -= 1
        self.metrics.counter("memsurface_sweep_reorders").inc()
        return woven

    @locked
    def delete_template(self, target: str, kind: str) -> None:
        super().delete_template(target, kind)
        st = self._state(target)
        if isinstance(st, TorchTargetState):
            st.footprints.pop(kind, None)
            st.shardplans.pop(kind, None)
            st.memsurfaces.pop(kind, None)
        st.bump(kind)

    @locked
    def put_constraint(self, target: str, kind: str, name: str,
                       constraint: dict) -> None:
        """Install (or re-install) a constraint; the kind's constraint
        version moves unless the new document's spec, labels and
        annotations equal the installed snapshot's
        (:func:`_semantic_fields`).  The snapshot is the frozen copy
        taken at the previous put, so an edit made in place to the
        installed dict still shows.  The reference bumps on every put,
        so in its manager process every audit's status writes
        (``auditTimestamp``, reconciled back into the engine by the
        constraint controller) make the next sweep a full one; here the
        next sweep keeps the churn delta plan.  The new document is
        installed either way, and cached formatted results carry it
        (:meth:`_pair_results`)."""
        st = self._state(target)
        old = st._frozen_constraints.get((kind, name))
        super().put_constraint(target, kind, name, constraint)
        if old is not None and _semantic_fields(old) == _semantic_fields(
                st._frozen_constraints[(kind, name)]):
            self.metrics.counter("constraint_status_only_puts").inc()
            return
        st.bump(kind)

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
        """(mask [C, n_rows] view, mask_delta, padded).  The mask
        is kept in its padded [c_pad, r_pad] form (the device layout) and
        delta-maintained under churn: one copy + dirty-column writes per
        generation instead of full re-matching + re-padding.  Delta is
        bypassed when a Namespace object changed (namespaceSelector
        results of unchanged rows may shift, table.namespaces_dirty_since)
        or rows were remapped.  ``mask_delta`` is (base buffer, rows):
        the padded buffer this one was derived from and the rows dirty
        since it, or None after a full rebuild."""
        from gatekeeper_tpu_torch.ir.prep import audit_pads
        from gatekeeper_tpu_torch.store.table import delta_worthwhile
        engine = self._match_engine(st, target)
        if engine is None:
            return None, None, None
        if all(not (c.get("spec") or {}).get("match") for c in constraints):
            # no constraint carries match criteria: every alive resource
            # matches; the device gates on __alive__ alone and no [C, R]
            # mask is built or shipped
            return TRIVIAL_MATCH, None, None
        table = st.table
        gen, remap = table.generation, table.remap_generation
        conver = self.con_version_of(st, kind)
        n = table.n_rows
        n_con = len(constraints)
        r_pad, c_pad = audit_pads(n, n_con)
        hit = st.mask_cache.get(kind)
        if hit is not None and hit[0] == (gen, conver):
            padded = hit[2]
            return padded[:n_con, :n], None, padded
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
                    base_rows = rows if since == prev_gen else \
                        table.dirty_rows_since(prev_gen)
                    st.mask_cache[kind] = ((gen, conver), (conver, remap),
                                           buf, (prev_gen, hit[2]))
                    # the rows are dirty relative to hit[2] only: the
                    # device sync must check that its base is that buffer
                    return buf[:n_con, :n], (hit[2], base_rows), buf
        padded = np.zeros((c_pad, r_pad), dtype=bool)
        padded[:n_con, :n] = engine.mask(constraints)
        st.mask_cache[kind] = ((gen, conver), (conver, remap), padded, None)
        return padded[:n_con, :n], None, padded

    @staticmethod
    def _binding_delta_on() -> bool:
        """GATEKEEPER_BINDING_DELTA: the incremental update_bindings
        chain (O(dirty) host work and row-sized device scatters).
        ``off`` rebuilds bindings whole on every store generation: the
        bit-identical oracle of the delta chain."""
        return os.environ.get(
            "GATEKEEPER_BINDING_DELTA", "on").lower() not in ("off", "0")

    def _kind_bindings(self, st: TorchTargetState, kind: str,
                       compiled: CompiledTemplate, constraints: list[dict]):
        """Per-kind bindings with incremental host updates under churn
        (unless ``GATEKEEPER_BINDING_DELTA=off``).  Retired bindings (two
        updates old) are recycled as write buffers (ping-pong); the
        executor copies every array it uploads, so the recycled numpy
        buffers never alias device data."""
        from gatekeeper_tpu_torch.ir.prep import update_bindings
        key = (st.table.generation, self.con_version_of(st, kind))
        hit = st.bindings_cache.get(kind)
        if hit is not None and hit[0] == key:
            return hit[1]
        if hit is not None and hit[0][1] == key[1] \
                and self._binding_delta_on():
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

    def _prefetch_axes(self, st) -> None:
        """Union-prefetch the element-axis extractions
        (jax_driver.py:1821): kinds sharing an axis pay one full-table
        walk, and per-kind build_bindings slice the table's superset
        cache.  It also fixes when element values reach the interner —
        before any kind's bindings — so interner-indexed tables get the
        reference's shape buckets."""
        axis_union: dict[tuple, set] = {}
        for kind in st.templates:
            lowered = st.templates[kind].vectorized
            if lowered is None or not self._kind_constraints(st, kind):
                continue
            abase = dict(lowered.spec.axes)
            for _axis, base in lowered.spec.axes:
                axis_union.setdefault(base, set())
            for ec in lowered.spec.e_cols:
                axis_union[abase[ec.axis]].add((ec.rel, ec.mode))
        for base, rels in axis_union.items():
            # only on a first build: churned sweeps re-extract dirty
            # rows inside update_bindings
            if base not in st.table._elem_cache:
                st.table.prefetch_elem_arrays(base, sorted(rels))

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
                       mask_delta: tuple | None,
                       rank: np.ndarray | None,
                       padded: np.ndarray | None = None) -> None:
        """Attach the padded match mask and rank as regular bindings
        arrays ("__match__", "__rank__") so they ride the same per-name
        device cache and row-scatter path as the columns.  `padded` is
        the mask's canonical padded form from _kind_mask, installed
        without any copy; `mask_delta` = (base buffer, rows) from
        _kind_mask.  A device row scatter of __match__ is recorded only
        when the bindings' inherited __match__ IS that base buffer (a
        scalar-routed sweep can advance the mask cache without the
        device; syncing from the wrong frame would miss rows)."""
        # bindings.arrays / base_dirty are REBOUND (never mutated in
        # place): concurrent readers may be iterating the old dicts
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
            old = bindings.arrays.get("__match__")
            bindings.arrays = {**bindings.arrays, "__match__": padded}
            d["_match_src"] = mask
            st.installed_match[kind] = padded
            if bindings.base is not None and mask_delta is not None \
                    and old is not None and old is mask_delta[0] \
                    and old.shape == padded.shape:
                bindings.base_dirty = {**bindings.base_dirty,
                                       "__match__": mask_delta[1]}
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
    # reuse: footprint-driven selective reuse and the cross-template
    # dedup of full sweeps

    @staticmethod
    def _reuse_eligible(st, kind: str, compiled: CompiledTemplate) -> bool:
        """A kind whose verdicts depend only on its own rows' columns
        that the table's column diff can see: row-local, no external
        providers, no inventory reads."""
        fp = st.footprints.get(kind)
        return fp is not None and fp.row_local and not fp.providers \
            and not compiled.uses_inventory

    def _selective_reuse(self, st: TorchTargetState, kind: str,
                         compiled: CompiledTemplate, limit):
        """Footprint-driven selective reuse: the cached sweep entry and
        bindings when this kind's verdicts provably cannot have changed
        since they were captured — no dirty column path
        (store.table.dirty_paths_since) intersects the template's
        validated read-set (footprint object paths plus the constraint
        match criteria paths), the key set, row ids and constraint set
        are unchanged, and the template is reuse-eligible.  The bindings
        stay as they were: a later churn that does touch the kind
        derives its dirty rows from the bindings' own delta state, so
        the device-resident mask is scattered and re-evaluated at every
        row dirtied since it was last computed.  Caller holds
        ``_prep_lock``."""
        ent = st.sweep_cache.get(kind)
        if ent is None or not self._reuse_eligible(st, kind, compiled):
            return None
        fp = st.footprints[kind]
        table = st.table
        conver = self.con_version_of(st, kind)
        if ent["conver"] != conver or ent["limit"] != limit \
                or ent["kgen"] != table.key_generation \
                or ent["remap"] != table.remap_generation \
                or ent["n_rows"] != table.n_rows:
            return None
        if table.generation != ent["gen"]:
            if table.namespaces_dirty_since(ent["gen"]):
                return None
            changed = table.dirty_paths_since(ent["gen"])
            if changed is None:     # window predates the path log
                return None
            from gatekeeper_tpu_torch.analysis.footprint import (
                MATCH_PATHS, paths_intersect)
            read = set(fp.object_paths()) | set(MATCH_PATHS)
            for c in changed:
                if any(paths_intersect(c, r) for r in read):
                    return None
        hitb = st.bindings_cache.get(kind)
        if hitb is None or hitb[1] is not ent["bindings"]:
            return None
        # move the cache key to the current generation: the dirty
        # columns provably do not feed this kind, so its bindings are
        # current.  A later update_bindings derives its dirty window from
        # the bindings' own delta state, not from this key
        st.bindings_cache[kind] = ((table.generation, conver), hitb[1])
        ent["gen"] = table.generation
        self.metrics.counter("footprint_kind_sweeps_skipped").inc()
        return ent, hitb[1]

    def _capture_sweep(self, st: TorchTargetState, kind: str,
                       compiled: CompiledTemplate, spec: tuple, payload,
                       limit) -> None:
        """Store one kind's resolved device payload and its reuse guards,
        so a later churned sweep whose dirty columns miss this kind's
        read-set can replay it (:meth:`_selective_reuse`).  The entry
        keeps the kind's own program even when a dedup rewrite computed
        the payload (the two agree): the shared columns the rewrite reads
        leave the bindings when the full sweep ends."""
        if not self._reuse_eligible(st, kind, compiled):
            return
        parts = payload if isinstance(payload, tuple) else (payload,)
        if sum(int(a.nbytes) for a in parts) > SWEEP_CACHE_MAX_BYTES:
            return
        table = st.table
        with self._prep_lock:
            st.sweep_cache[kind] = {
                "mode": spec[0], "payload": payload,
                "prog": compiled.vectorized.program,
                "bindings": spec[5], "mask": spec[6],
                "gen": table.generation, "kgen": table.key_generation,
                "remap": table.remap_generation, "n_rows": table.n_rows,
                "conver": self.con_version_of(st, kind), "limit": limit,
            }

    @staticmethod
    def _dedup_on() -> bool:
        """GATEKEEPER_DEDUP: the cross-template dedup of forced full
        sweeps (default on); ``off`` is the oracle."""
        return os.environ.get("GATEKEEPER_DEDUP", "on") != "off"

    def _audit_dedup_plan(self, st, target: str):
        """The cross-template predicate dedup plan of the installed set,
        or None when no kind is lowered and constrained.  Memoized by
        the set's digest (templates' sources and constraint documents),
        so a template or constraint change makes a new plan.  Unlike the
        reference's, an exception of the build is raised: the sweep
        ends with it.  Caller holds ``_prep_lock``."""
        import hashlib
        import json
        from gatekeeper_tpu_torch.analysis.policyset import build_dedup_plan
        dkinds = {}
        for k in sorted(st.templates):
            cons = self._kind_constraints(st, k)
            if st.templates[k].vectorized is not None and cons:
                dkinds[k] = (st.templates[k].vectorized, cons)
        if not dkinds:
            return None
        h = hashlib.sha256()
        for k, (_low, cons) in dkinds.items():
            h.update(f"{k}|{st.templates[k].source}|".encode())
            h.update(json.dumps(cons, sort_keys=True, default=str).encode())
        pdigest = h.hexdigest()
        memo = self._dedup_plan_memo.get(target)
        if memo is not None and memo[0] == pdigest:
            return memo[1]
        plan = build_dedup_plan(dkinds)
        self._dedup_plan_memo[target] = (pdigest, plan)
        # plan changed: drop cross-sweep shared columns whose digest is
        # no longer in the live group set
        live = set(plan.groups)
        st.dedup_shared_cache = {d: v for d, v in
                                 st.dedup_shared_cache.items() if d in live}
        return plan

    @locked_read
    def prepare_audit(self, target: str) -> bool:
        """Build what a forced full sweep needs before the first one: the
        cross-template dedup plan and, on CUDA, the full K1 variant of
        every rewritten program over its kind's bindings, so a
        (re)started process pays both before it declares itself ready.
        Returns True when a plan is ready (False: dedup off, or nothing
        lowered).  The reference's Stage-7 AOT compile of certified
        signatures is not ported (ROADMAP A8)."""
        st = self.state.get(target)
        if not isinstance(st, TorchTargetState) or self.scalar_only \
                or not self._dedup_on():
            return False
        with self._prep_lock:
            plan = self._audit_dedup_plan(st, target)
            if plan is None:
                return False
            if self.device.type == "cuda":
                for kind, prog, bindings, with_match, extra in \
                        self._rewritten_warm_items(st, plan):
                    self.executor.prewarm_audit_exec(
                        prog, bindings, DEFAULT_PREWARM_CAP,
                        with_match=with_match, extra=extra)
        return True

    def _rewritten_warm_items(self, st, plan) -> list[tuple]:
        """``(kind, rewritten program, bindings, with_match, shared
        shapes)`` for every kind of ``plan`` that a full sweep would run
        on the device (bindings built, float32-exact): what a warm
        compiles so the first full sweep finds each rewritten program's
        K1 variant built.  Caller holds ``_prep_lock``."""
        items = []
        for kind in sorted(plan.rewritten):
            compiled = st.templates.get(kind)
            cons = self._kind_constraints(st, kind)
            if compiled is None or compiled.vectorized is None or not cons \
                    or st.table.n_rows * len(cons) < SMALL_WORKLOAD_EVALS:
                continue
            try:
                bindings = self._kind_bindings(st, kind, compiled, cons)
            except ExternalDataError:
                continue
            if bindings.f32_unsafe:
                continue
            with_match = any((c.get("spec") or {}).get("match")
                             for c in cons)
            items.append((kind, plan.rewritten[kind], bindings, with_match,
                          self._shared_shapes(plan, kind, bindings)))
        return items

    @staticmethod
    def _shared_shapes(plan, kind: str, bindings) -> dict:
        """binding name -> shape of each shared column ``kind``'s
        rewritten program reads, at ``bindings``' pads."""
        out = {}
        for digest in plan.kind_digests[kind]:
            g = plan.groups[digest]
            out[g.binding] = (bindings.r_pad, bindings.e_pads.get(g.axis)) \
                if g.ekind == "e" else (bindings.r_pad,)
        return out

    def _shared_col(self, st, plan, kind: str, digest: str, bindings):
        """One shared conjunct's host column, carried ACROSS full sweeps:
        a geometry-stable cache hit re-evaluates only the rows the store
        dirtied since the cached generation and splices them into a COPY
        (the previous sweep's bindings may still reference the cached
        array).  Sound because shared subtrees are row-local by
        construction (own columns and digest-stable interner tables; the
        interner is append-only, so an unchanged row's ids resolve
        identically).  A constraint-set change changes the digest, a
        remap or resize misses the guards."""
        from gatekeeper_tpu_torch.analysis.policyset import eval_shared_host
        g = plan.groups[digest]
        member = g.members[kind]
        table = st.table
        want_shape = (bindings.r_pad, bindings.e_pads.get(g.axis)) \
            if g.ekind == "e" else (bindings.r_pad,)
        hit = st.dedup_shared_cache.get(digest)
        if hit is not None:
            c_gen, c_remap, c_col = hit
            if c_remap == table.remap_generation \
                    and c_col.shape == want_shape:
                if c_gen == table.generation:
                    return c_col
                dirty = table.dirty_rows_since(c_gen)
                if len(dirty) <= max(64, table.n_rows // 4):
                    sub = eval_shared_host(
                        plan.originals[kind], member.node_idx,
                        bindings.arrays, g.ekind, rows=dirty)
                    col = c_col.copy()
                    col[dirty] = sub
                    st.dedup_shared_cache[digest] = (
                        table.generation, table.remap_generation, col)
                    self.metrics.counter("dedup_shared_delta_evals").inc()
                    return col
        col = eval_shared_host(plan.originals[kind], member.node_idx,
                               bindings.arrays, g.ekind)
        st.dedup_shared_cache[digest] = (
            table.generation, table.remap_generation, col)
        return col

    def _apply_dedup(self, st, plan, kind: str, bindings,
                     shared_cols: dict, applied: dict):
        """Swap one kind's program for its dedup rewrite
        (analysis/policyset.py), injecting the shared predicate columns
        as plain bool bindings.  The column of a digest is computed ONCE
        a sweep, on the host, from the first member kind's bound arrays
        (the numpy twin of the plain evaluator), and handed to every
        member as the same object; member kinds bind identical arrays
        for identical canonical inputs, which the shape guard re-checks
        per kind.  A shape mismatch keeps the kind on its original
        program and counts ``dedup_fallbacks``; an exception of the twin
        is raised (the reference swallows it).  Returns the rewritten
        Program or None."""
        add: dict = {}
        for digest in plan.kind_digests[kind]:
            g = plan.groups[digest]
            col = shared_cols.get(digest)
            if col is None:
                col = self._shared_col(st, plan, kind, digest, bindings)
                shared_cols[digest] = col
            want = (bindings.r_pad, bindings.e_pads.get(g.axis)) \
                if g.ekind == "e" else (bindings.r_pad,)
            if col.shape != want:
                self.metrics.counter("dedup_fallbacks").inc()
                return None
            add[g.binding] = col
        # rebind, never mutate (see _install_gates): readers may hold the
        # previous arrays dict
        bindings.arrays = {**bindings.arrays, **add}
        for digest in plan.kind_digests[kind]:
            applied[digest] = applied.get(digest, 0) \
                + plan.groups[digest].members[kind].sites
        return plan.rewritten[kind]

    def _drop_shared_columns(self, rebound: list) -> None:
        """Take a forced full sweep's shared dedup columns out of the
        bindings :meth:`_apply_dedup` bound them into, once the sweep
        ended (formatted or failed), and keep each rewrite's mask as the
        kind's own program's (the two are equal).  A later non-full
        sweep then runs each member kind's own program over the arrays
        it passed before the full sweep, and reuses or delta-updates
        that mask as it does a kind that was not rewritten: no full K1
        launch, no variant that no warm built, no dead column uploaded.
        The reference leaves the columns in."""
        if not rebound:
            return
        with self._prep_lock:
            for bindings, names, rewritten, own in rebound:
                self.executor.alias_stored_mask(rewritten, own, bindings,
                                                names)
                # rebind, never mutate (see _install_gates)
                bindings.arrays = {k: v for k, v in bindings.arrays.items()
                                   if k not in names}

    @staticmethod
    def _twin_bindings_equal(a, b) -> bool:
        """True when two kinds' bound arrays are bit-identical: same
        names, shapes, dtypes, contents.  Shared dedup columns are the
        same objects in both dicts, so identity short-circuits them;
        everything else pays one host comparison."""
        if a is None or b is None:
            return False
        if a.c_pad != b.c_pad or a.r_pad != b.r_pad:
            return False
        if set(a.arrays) != set(b.arrays):
            return False
        for name, x in a.arrays.items():
            y = b.arrays[name]
            if x is y:
                continue
            xa, ya = np.asarray(x), np.asarray(y)
            if xa.shape != ya.shape or xa.dtype != ya.dtype \
                    or not np.array_equal(xa, ya):
                return False
        return True

    def _twin_handle(self, twin_src: dict, mode: str, kind: str, prog,
                     bindings, specs: list):
        """What-if (shadow) sweeps' whole-kind sharing.  A shadow install
        stages the candidate set beside the live one under mangled kinds
        (analysis/policyset.shadow_kind).  For every template the
        candidate did not change, the shadow twin lowers to the same
        program over bit-identical bound arrays, so its launches would
        recompute the live kind's payload exactly.  Live kinds register
        their spec's index; a shadow kind whose live twin ran before it
        with an equal program and equal bindings gets the twin's
        finished handle (a forced full sweep waits for each kind before
        the next, and a handle's ``get`` is a pure copy to the host),
        else None and it launches its own K1 and K2."""
        from gatekeeper_tpu_torch.analysis.policyset import split_shadow_kind
        base, tag = split_shadow_kind(kind)
        if tag is None:
            twin_src[(kind, mode)] = len(specs)
            return None
        si = twin_src.get((base, mode))
        if si is None:
            return None
        s_prog, s_bind, s_handle = specs[si][4], specs[si][5], specs[si][7]
        if s_prog is None or s_prog.cache_key() != prog.cache_key():
            return None
        if not self._twin_bindings_equal(s_bind, bindings):
            return None
        self.metrics.counter("whatif_twin_dispatches_shared").inc()
        return s_handle

    # ------------------------------------------------------------------
    # continuous enforcement: the paged sweep and its ledger

    def _devpages_active(self, compiled: CompiledTemplate) -> bool:
        """Device-resident pages are usable for this template right
        now: GATEKEEPER_DEVPAGES on, a lowered program to evaluate, and
        a live device path."""
        from gatekeeper_tpu_torch.enforce.devpages import devpages_mode
        return devpages_mode() and compiled.vectorized is not None \
            and not self.scalar_only

    @staticmethod
    def _inv_join_only(fp, compiled: CompiledTemplate) -> bool:
        """True when a template is cross-row SOLELY through lowered
        inventory joins (spec.inv_joins) — the one cross-row shape the
        devpages sweep evaluates on the device (K7), which is what makes
        e.g. K8sUniqueIngressHost page-eligible.  Any other cross-row
        reason (or an inventory read the lowering did not capture as a
        join) keeps the kind ineligible."""
        if compiled.vectorized is None:
            return False
        if not getattr(compiled.vectorized.spec, "inv_joins", ()):
            return False
        reasons = tuple(getattr(fp, "cross_row_reasons", ()) or ())
        return bool(reasons) and all(
            r.startswith("inventory join") for r in reasons)

    def _pages_ineligible(self, st: TorchTargetState, kind: str,
                          compiled: CompiledTemplate) -> str | None:
        """None when the kind can serve from the VerdictLedger, else
        the fallback reason: only a row-local template with no
        provider/inventory reads has verdicts that per-page
        re-evaluation can maintain exactly.  Under GATEKEEPER_DEVPAGES
        one relaxation: a kind whose only cross-row dependency is a
        lowered inventory join is admitted — the device join (K7) sees
        the whole table every delta sweep, so page locality is not
        assumed (and on a devpages fallback such a kind takes a full
        rebuild, never the host page loop)."""
        if compiled.vectorized is None:
            return "scalar-pin"
        fp = st.footprints.get(kind)
        if fp is None:
            return "no-footprint"
        dev_ij = self._devpages_active(compiled) \
            and self._inv_join_only(fp, compiled)
        if not fp.row_local and not dev_ij:
            return "cross-row"
        if fp.providers:
            return "external-providers"
        if compiled.uses_inventory and not dev_ij:
            return "inventory-read"
        return None

    @staticmethod
    def _observable_kinds(compiled: CompiledTemplate,
                          constraints: list[dict]) -> frozenset | None:
        """Resource kinds whose churn can change this template kind's
        verdicts: the union of every constraint's ``spec.match.kinds``
        plus the kinds its inventory joins read.  None = wildcard
        (some constraint matches every kind — cannot scope).  Drives
        the per-kind widen scoping: a dirty-log widen marker whose
        churned-kind union is disjoint from this set is skippable."""
        out: set[str] = set()
        if compiled.vectorized is not None:
            for ij in getattr(compiled.vectorized.spec, "inv_joins", ()):
                out.add(ij.kind)
        for c in constraints:
            match = (c.get("spec") or {}).get("match") or {}
            kl = match.get("kinds")
            if not isinstance(kl, list):
                return None         # absent/malformed kinds: wildcard
            for ks in kl:
                knames = (ks or {}).get("kinds") or []
                if "*" in knames:
                    return None
                out.update(k for k in knames if isinstance(k, str))
        return frozenset(out)

    def _devpages_reject(self, dv: dict, kind: str, reason: str) -> None:
        """Record one kind falling back from the device-resident path
        (stats + flight recorder + labeled counter)."""
        dv["kinds_fallback"] += 1
        dv["fallback_reasons"][kind] = reason
        self.metrics.counter("devpages_fallbacks", kind=kind).inc()
        from gatekeeper_tpu_torch.obs.flightrecorder import record_event
        record_event("devpages_fallback", kind=kind, reason=reason)

    def _devpaged_kind(self, st, target, handler, compiled, constraints,
                       kind, led, ent, conver, rcache, pg, dv,
                       refresh_only: bool = False) -> bool:
        """One kind's sweep on the device-resident paged store.

        The kind's columns stay resident on the device (the bindings
        delta chain scatters row-sized records to dirty rows, K4), the
        inventory joins' input records ride the same discipline, and
        ``eval_mask_delta`` computes the joins (K7) and the violation
        mask (K3, K1), gathers it through the on-device page table and
        returns the compact appear/clear delta stream against the
        previous resident mask (K6).  Consumption keeps the ledger's
        exact-event contract:

          * dirty rows with any candidate bit, and every ``+`` delta
            row, re-confirm through the exact scalar path
            (_ledger_apply_row) — messages stay oracle-identical;
          * dirty rows with NO candidate bit are direct full-row clears
            (mask bit 0 = definitely no violation — sound by the
            over-approximation contract);
          * ``-`` deltas on non-dirty rows (cross-row inventory-join
            flips) drop just that constraint's verdicts — same
            identity, so no phantom clear+appear pair.

        Returns True when the ledger was brought current (or, with
        ``refresh_only``, the resident state rebuilt after a host full
        build); False = the caller falls back to the host page loop (a
        full rebuild for a kind that is not row-local), for the
        reference's host-side reasons (external-data failure, f32-unsafe
        bindings, a delta stream that overflows twice).  An error raised
        by the kernel layer propagates: the reference's catch-all
        fallback would hide a kernel that does not build or launch."""
        from gatekeeper_tpu_torch.analysis.costmodel import \
            scatter_worthwhile
        from gatekeeper_tpu_torch.enforce import devpages as _dvp
        table = st.table
        ex = self.executor
        kp = st.devpages.get(kind)
        if kp is None:
            kp = st.devpages[kind] = _dvp.KindPages(kind=kind)
        h2d0 = ex.h2d_bytes
        sc0, sr0 = ex.h2d_scatter_bytes, ex.h2d_scatter_rows
        try:
            bindings = self._kind_bindings(st, kind, compiled, constraints)
        except ExternalDataError:
            self._devpages_reject(dv, kind, "external-data-failure")
            return False
        if bindings.f32_unsafe:
            self._devpages_reject(dv, kind, "f32-unsafe")
            return False
        r_pad, c_pad = bindings.r_pad, bindings.c_pad
        # inventory-join device input records (r:ij.<join>.*): cold
        # upload once, then row-sized scatters of just the changed
        # entries — rebound per update, never written in place
        ij_specs_raw = tuple(getattr(compiled.vectorized.spec, "inv_joins",
                                     ()))
        ij_dev: dict = {}
        for req in ij_specs_raw:
            host = _dvp.build_inv_join_inputs(req, table, r_pad)
            for nm, arr in host.items():
                prev_h = kp.ij_host.get(nm)
                prev_d = kp.ij_dev.get(nm)
                if prev_h is None or prev_d is None \
                        or prev_h.shape != arr.shape:
                    dev = ex._put(nm, arr)
                elif np.array_equal(prev_h, arr):
                    dev = prev_d
                else:
                    changed = np.nonzero(prev_h != arr)[0]
                    if scatter_worthwhile(len(changed), arr.shape[0]):
                        dev = ex._scatter_rows(nm, prev_d, arr, changed)
                    else:
                        dev = ex._put(nm, arr)
                kp.ij_host = {**kp.ij_host, nm: arr}
                kp.ij_dev = {**kp.ij_dev, nm: dev}
                ij_dev[nm] = dev
        if ij_specs_raw:
            dv["inv_joins_device"] += len(ij_specs_raw)
        ij_sig = tuple((req.name, bool(req.exclude_same_name))
                       for req in ij_specs_raw)
        n_ids = len(table.interner)
        # on-device page table: row -> slot indirection ([r_pad] int32,
        # identity while row ids are stable); rebuilt — rebound, not
        # written — on remap or slot-capacity change
        if kp.page_table is None or kp.slots != r_pad \
                or kp.remap != table.remap_generation:
            kp.page_table = ex._put("__pagetable__",
                                    np.arange(r_pad, dtype=np.int32))
            kp.slots = r_pad
            kp.page_rows = table.page_rows
            kp.n_pages = table.n_pages
        kp.free = tuple(table.free_slots())
        # Stage-8 residency planning: under a devpages budget that the
        # certified claim of the full resident mask exceeds, the mask
        # lives split across a hot device slot buffer and a host spill
        # mirror (enforce/devpages.ResidencyPlanner, K8) and is rebuilt
        # bit-identically here before the delta sweep
        planner = kp.resident
        budget = _dvp.residency_budget_bytes()
        if budget is None:
            planner = kp.resident = None
        elif planner is None \
                or not planner.compatible(c_pad, r_pad, table.page_rows):
            planner = kp.resident = _dvp.ResidencyPlanner(
                budget, c_pad, r_pad, table.page_rows,
                cert=st.memsurfaces.get(kind))
        planner_holds = planner is not None \
            and planner.holds(c_pad, r_pad)
        spills0 = planner.spills if planner is not None else 0
        restores0 = planner.restores if planner is not None else 0
        have_mask = planner_holds or (
            kp.mask is not None and tuple(kp.mask.shape) == (c_pad, r_pad))
        mask_valid = (have_mask and kp.gen == ent.gen
                      and kp.remap == table.remap_generation
                      and kp.conver == conver
                      and kp.c_pad == c_pad and kp.slots == r_pad)
        if refresh_only or not mask_valid:
            # cold rebuild after a geometry/generation change
            old_mask = torch.zeros((c_pad, r_pad), dtype=torch.bool,
                                   device=ex.device)
        elif planner_holds:
            old_mask = planner.expand(ex)
        else:
            old_mask = kp.mask
        k = max(kp.k, _dvp.DELTA_K_MIN)
        dirty = table.dirty_rows_since(ent.gen) \
            if not refresh_only else np.empty((0,), dtype=np.int64)
        program = compiled.vectorized.program
        new_mask, idx, signs, count, row_any = ex.eval_mask_delta(
            program, bindings, None, old_mask, kp.page_table, k, ij_sig,
            ij_dev, n_ids)
        if count > k and not refresh_only:
            # the compact stream overflowed its width: widen to the
            # next bucket and re-dispatch
            dv["delta_overflows"] += 1
            k = min(_dvp.delta_bucket(count) * _dvp.DELTA_K_LADDER,
                    c_pad * r_pad)
            kp.k = k
            new_mask, idx, signs, count, row_any = ex.eval_mask_delta(
                program, bindings, None, old_mask, kp.page_table, k,
                ij_sig, ij_dev, n_ids)
            if count > k:
                self._devpages_reject(dv, kind, "delta-overflow")
                return False
        if not refresh_only:
            n_rows = table.n_rows
            cnames = [(c.get("metadata") or {}).get("name", "")
                      for c in constraints]
            valid = int(min(count, k))
            plus_rows: set[int] = set()
            plus_bits: set[tuple[int, int]] = set()
            minus_by_row: dict[int, list[str]] = {}
            for i in range(valid):
                flat = int(idx[i])
                if flat < 0:
                    continue
                ci, row = flat // r_pad, flat % r_pad
                if ci >= len(cnames) or row >= n_rows:
                    continue    # padded constraint/row space
                if bool(signs[i]):
                    plus_rows.add(row)
                    plus_bits.add((ci, row))
                else:
                    minus_by_row.setdefault(row, []).append(cnames[ci])
            dirty_set = set(int(r) for r in dirty)
            confirm = {r for r in dirty_set if bool(row_any[r])} \
                | plus_rows
            involved = sorted(dirty_set | plus_rows | set(minus_by_row))
            for row in involved:
                if row in confirm:
                    self._ledger_apply_row(st, target, handler, compiled,
                                           constraints, kind, led, rcache,
                                           row, pg)
                elif row in dirty_set:
                    # no candidate bit anywhere on a dirty row: the
                    # device proved no constraint can violate — direct
                    # full-row clear, no scalar eval
                    meta = table.meta_at(row)
                    ident = () if meta is None \
                        else (meta.namespace, meta.name)
                    pg["events"] += len(led.set_row(kind, row, ident, {}))
                    dv["direct_clears"] += 1
                else:
                    # '-' delta on a clean row: that constraint's bit
                    # went definitely-no-violation — drop exactly its
                    # verdicts, same identity (no clear+appear pair)
                    old = ent.rows.get(row)
                    if old is None:
                        continue
                    ident, by_c = old
                    drop = set(minus_by_row[row])
                    new_by_c = {cn: rs for cn, rs in by_c.items()
                                if cn not in drop}
                    if len(new_by_c) != len(by_c):
                        pg["events"] += len(
                            led.set_row(kind, row, ident, new_by_c))
                        dv["direct_clears"] += 1
            if not mask_valid and ent.rows:
                # reconcile sweep (resize/toggle): the previous resident
                # mask is unknown, so '-' deltas don't exist — prune
                # stale ledger verdicts by the new mask's bits instead
                # (vs zeros, every 1-bit is in the '+' stream)
                cset = set(cnames)
                cidx = {cn: i for i, cn in enumerate(cnames)}
                for row, (ident, by_c) in list(ent.rows.items()):
                    if row in confirm or row in dirty_set:
                        continue
                    new_by_c = {cn: rs for cn, rs in by_c.items()
                                if cn in cset
                                and (cidx[cn], row) in plus_bits}
                    if len(new_by_c) != len(by_c):
                        pg["events"] += len(
                            led.set_row(kind, row, ident, new_by_c))
                        dv["direct_clears"] += 1
            dv["delta_events"] += int(count)
            dv["scatter_rows"] += ex.h2d_scatter_rows - sr0
            dv["rows_confirmed"] += len(confirm)
            pg["rows_reevaluated"] += len(confirm)
            pg["evaluations_saved"] += \
                max(0, n_rows - len(confirm)) * len(constraints)
            pg["pages_skipped"] += max(
                0, table.n_pages
                - len({r // table.page_rows for r in involved}))
        else:
            dv["mask_builds"] += 1
        if planner is not None and planner.active:
            # LRU bump the pages this sweep touched, then split the
            # fresh mask across the slot buffer and the host mirror: the
            # full-size device mask is released
            if not refresh_only:
                planner.touch({r // planner.page_rows for r in involved})
            planner.store(new_mask)
            kp.mask = None
            dv["resident_spills"] += planner.spills - spills0
            dv["resident_restores"] += planner.restores - restores0
            dv["resident_pages_device"] += len(planner.slot_of)
        else:
            kp.mask = new_mask
        kp.gen = table.generation
        kp.remap = table.remap_generation
        kp.conver = conver
        kp.c_pad = c_pad
        kp.n_pages = table.n_pages
        kp.page_rows = table.page_rows
        dv["kinds_device"] += 1
        dv["h2d_bytes"] += (ex.h2d_bytes - h2d0) \
            + (ex.h2d_scatter_bytes - sc0)
        dv["h2d_scatter_bytes"] += ex.h2d_scatter_bytes - sc0
        return True

    def _paged_kind(self, st, target, handler, compiled, constraints,
                    ordered_rows, row_order, kind, limit, tagged, rcache,
                    pg, dirty_pages_out, dv=None) -> None:
        """Serve one kind from the VerdictLedger, first applying the
        deltas for every page dirtied since the entry's generation.
        Rows re-evaluate through the exact scalar path (match + oracle
        + fmt memo), so the ledger holds exactly the confirmed
        violating rows; capped output walks them in rank order —
        bit-identical to the full path's top-k + refill emission."""
        from gatekeeper_tpu_torch.analysis.footprint import (MATCH_PATHS,
                                                             paths_intersect)
        from gatekeeper_tpu_torch.enforce.ledger import VerdictLedger
        table = st.table
        if st.ledger is None:
            st.ledger = VerdictLedger(target)
        led = st.ledger
        ent = led.entry(kind)
        conver = self.con_version_of(st, kind)
        condigest = _ledger_digest(constraints)
        rebuild = None
        if ent.gen < 0:
            rebuild = "cold"
        elif ent.conver != conver or ent.condigest != condigest:
            rebuild = "constraints-changed"
        elif ent.remap != table.remap_generation:
            rebuild = "rows-remapped"
        elif table.namespaces_dirty_since(ent.gen):
            # namespace label edits shift namespaceSelector matching of
            # OTHER rows — page locality doesn't hold
            rebuild = "namespace-churn"
        entries = None
        if rebuild is None and table.generation != ent.gen:
            entries = table.dirty_page_entries_since(ent.gen)
            if entries is None:
                # window predates the log floor: the dirty PAGES are
                # unattributable, but the row space itself is intact
                # (a shrink would have bumped remap_generation), so
                # re-evaluate every page through the delta path below
                pg["widen_fallbacks"] += 1
                self.metrics.counter("widen_fallbacks", kind=kind).inc()
                entries = [(table.generation, None,
                            frozenset(range(table.n_pages)), None)]
        dev_done = False
        if rebuild is None and entries and dv is not None \
                and self._devpages_active(compiled):
            # device-resident delta path; when it returns False (host-side
            # reasons only) a row-local kind falls back to the host page
            # loop, and a cross-row (inventory-join) kind, whose verdicts
            # the page loop cannot maintain, to one full rebuild
            dev_done = self._devpaged_kind(
                st, target, handler, compiled, constraints, kind, led,
                ent, conver, rcache, pg, dv)
            if not dev_done:
                fp = st.footprints.get(kind)
                if fp is None or not fp.row_local:
                    rebuild = "devpages-fallback"
        if dev_done:
            pass        # ledger brought current on the device path
        elif rebuild is not None:
            # full build: clear rows that died since (sorted — the
            # canonical event order puts dead-row clears first), then
            # every live row in rank order
            for row in sorted(ent.rows):
                if row >= table.n_rows or table.meta_at(row) is None:
                    pg["events"] += len(led.set_row(kind, row, (), {}))
            for row in ordered_rows:
                self._ledger_apply_row(st, target, handler, compiled,
                                       constraints, kind, led, rcache, row,
                                       pg)
            ent.full_builds += 1
            pg["full_builds"] += 1
            pg["pages_evaluated"] += table.n_pages
            pg["rows_reevaluated"] += len(ordered_rows)
            if dv is not None and self._devpages_active(compiled):
                # refresh the device-resident mask after a host full
                # build so the NEXT sweep deltas instead of reconciling
                self._devpaged_kind(st, target, handler, compiled,
                                    constraints, kind, led, ent, conver,
                                    rcache, pg, dv, refresh_only=True)
        elif entries:
            fp = st.footprints[kind]
            read = set(fp.object_paths()) | set(MATCH_PATHS)
            obs_kinds = self._observable_kinds(compiled, constraints)
            kgen_changed = ent.kgen != table.key_generation
            pages: set[int] = set()
            for _g, paths, pgs, ekinds in entries:
                if paths is None:
                    # cap-overflow widen marker: its paths are
                    # unattributable, but its resource-kind union is
                    # exact — a template whose observable kinds are
                    # disjoint skips the dropped half outright
                    if ekinds is not None and obs_kinds is not None \
                            and not (obs_kinds & ekinds):
                        continue
                    pg["widen_fallbacks"] += 1
                    self.metrics.counter("widen_fallbacks",
                                         kind=kind).inc()
                    pages |= pgs
                    continue
                # page filtering by read-set intersection is only exact
                # for pure replaces: key-set churn includes every
                # touched page
                if kgen_changed or not paths or any(
                        paths_intersect(p, r) for p in paths
                        for r in read):
                    pages |= pgs
            R = table.page_rows
            n_rows = table.n_rows
            rows_seen = 0
            for p in sorted(pages):
                start, end = p * R, (p + 1) * R
                if start >= n_rows:
                    continue    # stale page beyond the row space
                pg["rows_padded"] += max(0, end - n_rows)
                for row in range(start, min(end, n_rows)):
                    self._ledger_apply_row(st, target, handler, compiled,
                                           constraints, kind, led, rcache,
                                           row, pg)
                    rows_seen += 1
            dirty_pages_out |= pages
            pg["pages_evaluated"] += len(pages)
            pg["pages_skipped"] += max(0, table.n_pages - len(pages))
            pg["rows_reevaluated"] += rows_seen
            pg["evaluations_saved"] += \
                max(0, len(ordered_rows) - rows_seen) * len(constraints)
        else:
            # generation unchanged (or every entry already applied):
            # the ledger is current — pure serve
            pg["pages_skipped"] += table.n_pages
            pg["evaluations_saved"] += len(ordered_rows) * len(constraints)
        ent.gen = table.generation
        ent.kgen = table.key_generation
        ent.remap = table.remap_generation
        ent.n_rows = table.n_rows
        ent.conver = conver
        ent.condigest = condigest
        if tagged is not None:
            # the reactor's rungs (react_kind) maintain without serving
            self._ledger_serve(ent, constraints, row_order, kind, limit,
                               tagged)

    def _ledger_apply_row(self, st, target, handler, compiled, constraints,
                          kind, led, rcache, row, pg) -> int:
        """Re-evaluate one row against the kind's constraints through
        the exact scalar path and replace its ledger verdicts, emitting
        the delta events.  Returns evaluations performed."""
        table = st.table
        meta = table.meta_at(row)
        if meta is None:
            pg["events"] += len(led.set_row(kind, row, (), {}))
            return 0
        pair = self._row_review(st, handler, row, rcache)
        if pair is None:
            pg["events"] += len(led.set_row(kind, row, (), {}))
            return 0
        review, frozen, shared = pair
        by_c: dict[str, list] = {}
        n_evals = 0
        for c in constraints:
            if not any(True for _ in handler.matching_constraints(
                    review, [c], table)):
                continue
            n_evals += 1
            results = self._pair_results(st, target, kind, compiled, c,
                                         row, review, frozen, None, shared)
            if results:
                by_c[(c.get("metadata") or {}).get("name", "")] = results
        pg["events"] += len(led.set_row(kind, row,
                                        (meta.namespace, meta.name), by_c))
        return n_evals

    def _ledger_serve(self, ent, constraints, row_order, kind, limit,
                      tagged) -> None:
        """Emit capped results from the ledger's confirmed rows.  Rank
        order + whole-row emission with the cap checked at the top of
        the loop reproduces _format_topk/_scalar_kind exactly (top-k by
        rank plus full-mask refill IS "walk confirmed rows in rank
        order until the result count reaches the cap")."""
        for c in constraints:
            cname = (c.get("metadata") or {}).get("name", "")
            rows = [row for row, (_ident, by_c) in ent.rows.items()
                    if cname in by_c and row in row_order]
            rows.sort(key=row_order.__getitem__)
            emitted = 0
            for row in rows:
                if limit is not None and emitted >= limit:
                    break
                results = ent.rows[row][1][cname]
                for r in results:
                    # fresh copies: downstream sets .resource and owns
                    # result.metadata; the ledger's canon stays pristine
                    tagged.append(((row_order[row], kind, cname),
                                   dataclasses.replace(
                                       r, metadata=dict(r.metadata))))
                emitted += len(results)

    # ------------------------------------------------------------------
    # continuous-enforcement entry points (enforce/reactor.py)

    def _react_kinds(self, st, kind: str | None) -> list[str]:
        """The template kinds a react or resync of ``kind`` covers: every
        kind for None, the kind itself for a template kind, and for a
        resource kind (what the reactor's watch streams carry: ``Pod``)
        every template kind whose constraints can match it
        (``_observable_kinds``; a wildcard match counts).  The reference
        looks a resource kind up among the template kinds, finds none,
        and leaves the ledger to the next sweep (ROADMAP Queue C)."""
        if kind is None:
            return sorted(st.templates)
        if kind in st.templates:
            return [kind]
        out = []
        for k in sorted(st.templates):
            obs = self._observable_kinds(st.templates[k],
                                         self._kind_constraints(st, k))
            if obs is None or kind in obs:
                out.append(k)
        return out

    def react_kind(self, target: str,
                   kind: str | None = None) -> dict | None:
        """Rung 1 of the reactor's resync ladder: fold the store's
        dirty pages into the VerdictLedger for one kind (every eligible
        kind when None; the template kinds that can match it for a
        resource kind) with no sweep in between — the single-event →
        single-page re-eval path.  Serving is skipped (verdicts are
        *maintained*; the next audit formats from the updated ledger).
        Under ``GATEKEEPER_DEVPAGES`` a kind with dirty pages takes the
        device-resident route (K4, K7, K3, K1, K6).  Returns the paged
        accounting dict, or None when pages are off or nothing was
        eligible."""
        from gatekeeper_tpu_torch.enforce.devpages import (
            devpages_mode as _dv_mode, fresh_stats as _dv_fresh)
        from gatekeeper_tpu_torch.enforce.ledger import pages_mode
        if not pages_mode():
            return None
        st = self._state(target)
        if not isinstance(st, TorchTargetState):
            return None
        handler = self.targets[target]
        pg = {"pages_evaluated": 0, "pages_skipped": 0, "rows_padded": 0,
              "rows_reevaluated": 0, "evaluations_saved": 0,
              "widen_fallbacks": 0, "full_builds": 0, "events": 0}
        dirty: set[int] = set()
        dv = _dv_fresh() if (_dv_mode() and not self.scalar_only) else None
        reacted = 0
        with self._prep_lock:
            ordered_rows, row_order = self._ensure_order(st)
            rcache: dict[int, tuple] = {}
            for k in self._react_kinds(st, kind):
                compiled = st.templates.get(k)
                if compiled is None:
                    continue
                constraints = self._kind_constraints(st, k)
                if not constraints:
                    continue
                if self._pages_ineligible(st, k, compiled) is not None:
                    continue
                self._paged_kind(st, target, handler, compiled,
                                 constraints, ordered_rows, row_order, k,
                                 None, None, rcache, pg, dirty, dv)
                reacted += 1
        if reacted == 0:
            return None
        pg["kinds"] = reacted
        pg["dirty_pages"] = len(dirty)
        if dv is not None:
            pg["devpages"] = dv
        m = self.metrics
        m.counter("reactor_reacts_total").inc()
        if st.ledger is not None:
            m.gauge("ledger_violations").set(
                st.ledger.total_violations())
        return pg

    def resync_kind(self, target: str,
                    kind: str | None = None) -> dict | None:
        """Rungs 2/3: force a whole-kind rebuild that DIFF-APPLIES
        against the existing ledger rows — the entry is marked cold but
        keeps its verdicts, so a clean resync emits zero events and a
        divergent one emits exactly the true appear/clear delta, never
        a drop-and-replay phantom storm.  (The reference also discards
        the kind's pending snapshot adoption here: the port has no
        snapshot tier, ROADMAP A8.)"""
        from gatekeeper_tpu_torch.enforce.ledger import pages_mode
        if not pages_mode():
            return None
        st = self._state(target)
        if not isinstance(st, TorchTargetState):
            return None
        with self._prep_lock:
            led = st.ledger
            for k in self._react_kinds(st, kind):
                if led is not None:
                    ent = led.entries.get(k)
                    if ent is not None:
                        ent.gen = -1
        # _prep_lock released: react_kind re-acquires it (plain Lock,
        # not reentrant)
        out = self.react_kind(target, kind)
        self.metrics.counter("reactor_resyncs_total").inc()
        return out

    @locked_read
    def devpages_report(self, target: str) -> dict:
        """Per-kind device-residency eligibility for ``probe --pages``:
        kind -> None (device-resident eligible) or the blocking
        reason.  Reflects the live gates — with GATEKEEPER_DEVPAGES
        off the cross-row relaxation is off too, so an inventory-join
        kind reports its host-path reason."""
        from gatekeeper_tpu_torch.enforce.devpages import devpages_mode
        st = self._state(target)
        out: dict[str, str | None] = {}
        if not isinstance(st, TorchTargetState):
            return out
        on = devpages_mode()
        for kind in sorted(st.templates):
            compiled = st.templates[kind]
            reason = self._pages_ineligible(st, kind, compiled)
            if reason is None:
                if not on:
                    reason = "devpages-off"
                elif self.scalar_only:
                    reason = "scalar-only"
                elif compiled.vectorized is None:
                    reason = "not-vectorized"
            out[kind] = reason
        return out

    @locked_read
    def page_of_object(self, target: str, obj) -> int | None:
        """Row page an event object lands in — the reactor's
        coalescing hint.  None when unhandled or not resident."""
        handler = self.targets.get(target)
        if handler is None:
            return None
        try:
            key, _meta, _doc = handler.process_data(obj)
        except Exception:   # noqa: BLE001 — unhandled/malformed event
            return None
        st = self._state(target)
        row = st.table.lookup(key)
        return None if row is None else st.table.page_of(row)

    @locked_read
    def kind_residents(self, target: str, api_version: str,
                       kind: str) -> list[str]:
        """Store keys of every resident row of (apiVersion, kind) — the
        deletion scan for a rung-2 relist (Client.sync_kind)."""
        st = self._state(target)
        table = st.table
        out: list[str] = []
        for key, row in list(table.rows_items()):
            meta = table.meta_at(row)
            if meta is not None and meta.kind == kind \
                    and meta.api_version == api_version:
                out.append(key)
        return out

    def ledger_rv(self, target: str, kind: str) -> int:
        """The kind's live RV watermark (0 = none recorded) — seeds the
        reactor's first-event staleness check.  (The reference also
        reads a restored snapshot's watermark map here: the port has no
        snapshot tier, ROADMAP A8, so nothing fills ``ledger_restored``.)"""
        st = self._state(target)
        if not isinstance(st, TorchTargetState):
            return 0
        led = st.ledger
        if led is not None:
            ent = led.entries.get(kind)
            if ent is not None and ent.rv:
                return int(ent.rv)
        return 0

    def store_generation(self, target: str) -> int:
        """The store's write generation: the reactor re-reacts a kind it
        reacted moments ago when this moved (a sync controller's write
        that landed after the react).  Monotonic across ``adopt_store``."""
        st = self._state(target)
        return int(getattr(st, "generation_base", 0) + st.table.generation)

    # ------------------------------------------------------------------
    # external data: the key-collection half of the two-phase design

    def _ext_specs(self, st) -> list[tuple[str, tuple[str, ...]]]:
        """(provider, review-column path) pairs across the target's
        lowered kinds — the sweep-level key-collection scan of the
        two-phase external-data design."""
        specs: list[tuple[str, tuple[str, ...]]] = []
        for kind in sorted(st.templates):
            lowered = st.templates[kind].vectorized
            if lowered is None or not self._kind_constraints(st, kind):
                continue
            for tr in lowered.spec.tables:
                if not tr.ext_providers or not tr.src.startswith("r:val:"):
                    # e-col-keyed lookups are rare; the build-time
                    # prefetch hook still batches them per table build
                    continue
                path = tuple(tr.src[len("r:val:"):].split("."))
                for provider in tr.ext_providers:
                    specs.append((provider, path))
        return specs

    def _prefetch_external(self, st, specs) -> dict:
        """Bulk-warm every (provider, distinct key) pair the sweep's
        external-data tables will gather — one batched round per
        provider (single-flight in the provider cache dedupes against
        the build-time hook racing it).  Returns the audit report's
        ``bulk_prefetch`` numbers."""
        from gatekeeper_tpu_torch.externaldata.runtime import get_runtime
        from gatekeeper_tpu_torch.ir.encode import decode_value
        from gatekeeper_tpu_torch.store.columns import ColSpec
        rt = get_runtime()
        t0 = time.perf_counter()
        interner = st.table.interner
        by_provider: dict[str, dict] = {}
        for provider, path in specs:
            want = by_provider.setdefault(provider, {})
            ids = np.unique(st.table.column(ColSpec(path, "val")).ids)
            for uid in ids[ids >= 0].tolist():
                v = decode_value(interner.string(uid))
                if isinstance(v, str):
                    want[v] = True
        n_keys = 0
        for provider, want in by_provider.items():
            n_keys += len(want)
            if want and rt is not None:
                rt.prefetch(provider, list(want))
        return {"providers": len(by_provider), "keys": n_keys,
                "prefetch_s": round(time.perf_counter() - t0, 6)}

    def _start_external_warm(self, st, tracer, sweep_ctx):
        """Start the sweep's bulk external-data warm on an
        ``external-prefetch`` thread of its own (the reference submits
        it to its sweep pool), so the provider round overlaps the kinds'
        host prep: a Future of its stats, which the sweep reads before
        its report (raising the warm's exception, never swallowing it).
        None when no runtime is installed or no lowered kind reads a
        provider."""
        from gatekeeper_tpu_torch.externaldata.runtime import get_runtime
        if get_runtime() is None:
            return None
        specs = self._ext_specs(st)
        if not specs:
            return None

        def run():
            t0 = time.perf_counter()
            try:
                return self._prefetch_external(st, specs)
            finally:
                tracer.add_complete("external.prefetch", cat="external",
                                    t0=t0, t1=time.perf_counter(),
                                    parent=sweep_ctx)
        pool = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="external-prefetch")
        try:
            return pool.submit(run)
        finally:
            pool.shutdown(wait=False)

    @staticmethod
    def _external_sweep_stats(bulk: dict | None) -> dict | None:
        """Sweep-report payload: the bulk warm's numbers plus every
        provider's breaker state / cache hit ratio / fetch timings.
        None when no runtime or no provider is configured."""
        from gatekeeper_tpu_torch.externaldata.runtime import get_runtime
        rt = get_runtime()
        if rt is None or not rt.provider_names():
            return None
        out: dict = {"providers": rt.stats()}
        if bulk is not None:
            out["bulk_prefetch"] = bulk
        return out

    @locked_read
    def prefetch_external_for_reviews(self, target: str,
                                      reviews: list[dict]) -> None:
        """Batched external-data warm for an admission micro-batch: one
        fetch round per provider covering every key any review in the
        batch will look up.  Wired ahead of MicroBatcher evaluation so
        fetch latency is paid once per batch — including batches small
        enough to fall back to per-review scalar queries, which would
        otherwise fetch key-by-key."""
        from gatekeeper_tpu_torch.externaldata.runtime import get_runtime
        rt = get_runtime()
        if rt is None:
            return
        st = self._state(target)
        if not isinstance(st, TorchTargetState):
            return
        specs = self._ext_specs(st)
        if not specs:
            return
        from gatekeeper_tpu_torch.store.columns import iter_path
        by_provider: dict[str, dict] = {}
        for provider, path in specs:
            want = by_provider.setdefault(provider, {})
            for rv in reviews:
                obj = rv.get("object") if isinstance(rv, dict) else None
                if not isinstance(obj, dict):
                    continue
                for v in iter_path(obj, path):
                    if isinstance(v, str):
                        want[v] = True
        for provider, want in by_provider.items():
            if want:
                rt.prefetch(provider, list(want))

    # ------------------------------------------------------------------
    # the audit sweep

    @locked_read
    def query_audit(self, target: str, opts: QueryOpts | None = None) \
            -> tuple[list[Result], str | None]:
        self._raise_warm_error()
        t_start = time.perf_counter()
        st = self._state(target)
        if not isinstance(st, TorchTargetState):
            return super().query_audit(target, opts)
        tracing = opts.tracing if opts is not None else self.default_tracing
        limit = opts.limit_per_constraint if opts is not None else None
        full = opts.full if opts is not None else False

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
        # the sweep's root span; the stages' spans, recorded after they
        # ran, name it as their parent
        from gatekeeper_tpu_torch.obs.trace import get_tracer
        tracer = get_tracer()
        with tracer.span("audit.sweep", cat="audit", target=target,
                         full=full, rows=len(ordered_rows)) as sweep_sp:
            sweep_ctx = tracer.current()
            ext_warm = self._start_external_warm(st, tracer, sweep_ctx)
            rebound: list = []
            try:
                out = self._sweep(st, target, ordered_rows, row_order,
                                  tracing, limit, full, tracer, sweep_ctx,
                                  t_start, ext_warm, rebound)
            finally:
                self._drop_shared_columns(rebound)
                if ext_warm is not None:
                    # a sweep that failed leaves with its own error
                    concurrent.futures.wait([ext_warm])
            if sweep_sp is not None:
                sweep_sp.args["results"] = len(out[0])
        return out

    def _sweep(self, st, target, ordered_rows, row_order, tracing, limit,
               full, tracer, sweep_ctx, t_start, ext_warm=None,
               rebound: list | None = None) \
            -> tuple[list[Result], str | None]:
        """The body of :meth:`query_audit` under its ``audit.sweep``
        span.

        Phase 1, under ``_prep_lock``: host prep of each kind, then its
        launch.  A non-full sweep's launches run on while the next kind
        is prepared; a forced full sweep stages each kind's uploads and
        waits for its kernels before the next kind's prep, so each
        stage's seconds are its own.  Phase 2: each kind formatted in
        dispatch order; the tagged sort restores the scalar driver's
        order.  A full sweep reports its stage seconds in
        ``last_sweep_phases``, with the per-template attribution of its
        device time (obs/attribution.py).  ``ext_warm``, the sweep's bulk
        external-data warm, runs beside phase 1 and is joined before the
        report, so its ``bulk_prefetch`` numbers are always in the
        ``external`` stanza (the reference reads them only if its future
        is done).  A kind whose provider fails under failurePolicy Fail
        is contained: its results are unknown this sweep
        (``external_data_kind_failures``), every other kind's stand.
        Each bindings that a dedup rewrite bound shared columns into is
        appended to ``rebound`` with those columns' names, the rewrite
        and the kind's own program, for :meth:`_drop_shared_columns`
        when the sweep ends."""
        handler = self.targets[target]
        trace: list | None = [] if tracing else None
        m = self.metrics
        ex = self.executor
        rank = self._row_rank(st, row_order)
        # continuous enforcement (enforce/): on non-full, untraced
        # sweeps eligible kinds skip the per-kind device sweep — only
        # dirty pages (or, under GATEKEEPER_DEVPAGES, the device's delta
        # stream) update the VerdictLedger, which serves the capped
        # results.  GATEKEEPER_PAGES=off is the oracle (the legacy path)
        from gatekeeper_tpu_torch.enforce.devpages import (
            devpages_mode, fresh_stats)
        from gatekeeper_tpu_torch.enforce.ledger import pages_mode
        pg_on = pages_mode()
        pg_kinds: list[str] = []
        pg_fallback: dict[str, str] = {}
        pg_stats = {"pages_evaluated": 0, "pages_skipped": 0,
                    "rows_padded": 0, "rows_reevaluated": 0,
                    "evaluations_saved": 0, "widen_fallbacks": 0,
                    "full_builds": 0, "events": 0}
        pg_dirty_pages: set[int] = set()
        dv_on = pg_on and devpages_mode() and not self.scalar_only
        dv_stats = fresh_stats() if dv_on else None
        # cross-template predicate dedup (analysis/policyset.py): forced
        # full sweeps only; GATEKEEPER_DEDUP=off is the oracle
        dedup_plan = None
        dedup_cols: dict = {}
        dedup_applied: dict = {}
        dedup_host_s = 0.0
        # footprint-driven selective reuse (analysis/footprint.py): a
        # non-full, untraced sweep replays a kind's captured payload when
        # no dirty column path meets its read-set;
        # GATEKEEPER_FOOTPRINT=off is the oracle
        from gatekeeper_tpu_torch.analysis.footprint import mode as fp_mode
        fp_enabled = not self.scalar_only and fp_mode() != "off"
        fp_skipped: list[str] = []
        fp_saved = 0
        # what-if twin sharing (whatif/shadow.py): with shadow kinds
        # staged, a forced full sweep's unchanged twin takes the live
        # kind's handle; GATEKEEPER_WHATIF_SHARE=off is the oracle
        twin_src: dict | None = None
        twin_shared: list[str] = []
        if full and not self.scalar_only and \
                os.environ.get("GATEKEEPER_WHATIF_SHARE", "on") != "off":
            from gatekeeper_tpu_torch.analysis.policyset import \
                is_shadow_kind
            if any(is_shadow_kind(k) for k in st.templates):
                twin_src = {}
        # a full sweep's phase sums, each measured on the sweep thread
        # where its stage ran; every kind's stages end before the next
        # kind's begin, so their sum stays within the sweep's wall
        ph = {"host_prep_s": 0.0, "h2d_s": 0.0, "device_s": 0.0,
              "format_s": 0.0, "h2d_bytes": 0}
        per_kind_dev: dict[str, float] = {}

        def launch(mode, prog, bindings):
            if mode == "topk":
                return ex.run_topk_async(prog, bindings, limit)
            return ex.run_async(prog, bindings)

        def dispatch(mode, kind, prog, bindings):
            # a full sweep's kind: staging its uploads migrates (so the
            # launch takes the full plan), and device_s runs from the
            # first launch until the kind's end event completed
            t0 = time.perf_counter()
            ex.stage_uploads(bindings)
            t1 = time.perf_counter()
            handle = launch(mode, prog, bindings).block()
            t2 = time.perf_counter()
            tracer.add_complete("kind.h2d", cat="h2d", t0=t0, t1=t1,
                                parent=sweep_ctx, kind=kind)
            tracer.add_complete("kind.device", cat="device", t0=t1, t1=t2,
                                parent=sweep_ctx, kind=kind, mode=mode)
            ph["h2d_s"] += t1 - t0
            ph["device_s"] += t2 - t1
            ph["h2d_bytes"] += bindings.nbytes()
            per_kind_dev[kind] = per_kind_dev.get(kind, 0.0) + (t2 - t1)
            return handle

        def prep_done(kind, t0):
            now = time.perf_counter()
            tracer.add_complete("kind.host_prep", cat="host_prep", t0=t0,
                                t1=now, parent=sweep_ctx, kind=kind)
            ph["host_prep_s"] += now - t0

        # phase 1, on the sweep thread: host prep and dispatch per kind.
        # Launches are asynchronous, so on a non-full sweep kind N's
        # device work overlaps kind N+1's host prep
        specs: list[tuple] = []
        t_pipe = time.perf_counter()
        with self._prep_lock:
            tk = time.perf_counter()
            self._prefetch_axes(st)
            if full and not self.scalar_only and self._dedup_on():
                dedup_plan = self._audit_dedup_plan(st, target)
            prep_done("__axes_and_plan__", tk)
            sweep_kinds = sorted(st.templates)
            if full and trace is None and not self.scalar_only:
                # forced full sweeps (no paged kinds) dispatch in the
                # Stage-8 order; phase 2's tagged sort keeps the results
                sweep_kinds = self.memsurface_sweep_order(st, sweep_kinds)
            for kind in sweep_kinds:
                tk = time.perf_counter()
                compiled = st.templates[kind]
                constraints = self._kind_constraints(st, kind)
                if not constraints:
                    continue
                if pg_on and not full and trace is None:
                    reason = self._pages_ineligible(st, kind, compiled)
                    if reason is None:
                        # no dispatch: the paged serve runs in phase 2
                        # (sorted-kind order — deterministic ledger
                        # event order)
                        specs.append(("pages", kind, compiled, constraints,
                                      None, None, None, None))
                        pg_kinds.append(kind)
                        continue
                    pg_fallback[kind] = reason
                if fp_enabled and not full and trace is None:
                    reuse = self._selective_reuse(st, kind, compiled, limit)
                    if reuse is not None:
                        # no launch: phase 2 formats the captured payload
                        ent, bindings = reuse
                        specs.append((ent["mode"], kind, compiled,
                                      constraints, ent["prog"], bindings,
                                      ent["mask"],
                                      _ResolvedHandle(ent["payload"])))
                        fp_skipped.append(kind)
                        fp_saved += len(ordered_rows) * len(constraints)
                        prep_done(kind, tk)
                        continue
                mask, mask_delta, padded = self._kind_mask(
                    st, target, kind, constraints)
                small = len(ordered_rows) * len(constraints) \
                    < SMALL_WORKLOAD_EVALS
                if compiled.vectorized is None or mask is None or small:
                    # unlowerable template — or a workload too small to
                    # amortize a device dispatch
                    specs.append(("scalar", kind, compiled, constraints,
                                  None, None, mask, None))
                    prep_done(kind, tk)
                    continue
                try:
                    bindings = self._kind_bindings(st, kind, compiled,
                                                   constraints)
                except ExternalDataError:
                    # failurePolicy Fail during this kind's table build:
                    # contained per kind — its violations are unknown
                    # this sweep, every other template is unaffected
                    m.counter("external_data_kind_failures").inc()
                    prep_done(kind, tk)
                    continue
                if bindings.f32_unsafe:
                    # some bound numeric value does not survive a float32
                    # round-trip: device ordering compares could
                    # mis-order, so this kind runs on the scalar oracle
                    m.counter("f32_unsafe_scalar_fallbacks").inc()
                    specs.append(("scalar", kind, compiled, constraints,
                                  None, None, mask, None))
                    prep_done(kind, tk)
                    continue
                self._install_gates(st, kind, bindings, mask, mask_delta,
                                    rank, padded)
                prog = compiled.vectorized.program
                if dedup_plan is not None and kind in dedup_plan.rewritten:
                    t_dd = time.perf_counter()
                    prog2 = self._apply_dedup(st, dedup_plan, kind, bindings,
                                              dedup_cols, dedup_applied)
                    if prog2 is not None:
                        prog = prog2
                        if rebound is not None:
                            rebound.append((bindings, {
                                dedup_plan.groups[d].binding
                                for d in dedup_plan.kind_digests[kind]},
                                prog2, compiled.vectorized.program))
                    t_dd2 = time.perf_counter()
                    tracer.add_complete("dedup.host_eval", cat="dedup",
                                        t0=t_dd, t1=t_dd2, parent=sweep_ctx,
                                        kind=kind)
                    dedup_host_s += t_dd2 - t_dd
                mode = "topk" if limit is not None else "mask"
                prep_done(kind, tk)
                if twin_src is not None:
                    handle = self._twin_handle(twin_src, mode, kind, prog,
                                               bindings, specs)
                    if handle is not None:
                        twin_shared.append(kind)
                        specs.append((mode, kind, compiled, constraints, prog,
                                      bindings, mask, handle))
                        continue
                if full:
                    handle = dispatch(mode, kind, prog, bindings)
                else:
                    with tracer.span("device.dispatch", cat="device",
                                     parent=sweep_ctx, kind=kind,
                                     mode=mode):
                        handle = launch(mode, prog, bindings)
                specs.append((mode, kind, compiled, constraints, prog,
                              bindings, mask, handle))
        t_prep = time.perf_counter()
        m.timer("audit_prep_submit").observe(t_prep - t_start)

        # phase 2: resolve handles and host-format per kind, in sorted
        # kind order; the tagged sort restores the scalar driver's order
        rcache: dict[int, tuple] = {}
        tagged: list[tuple[tuple, Result]] = []
        for spec in specs:
            mode, kind, compiled, constraints, prog, bindings, mask, \
                handle = spec
            tf = time.perf_counter()
            # resolve the device payload once: the format path reads it
            # through a resolved handle, and a fresh (not replayed)
            # payload is captured for selective reuse by later sweeps
            payload = None
            fresh = not isinstance(handle, _ResolvedHandle)
            if handle is not None and mode in ("topk", "mask"):
                payload = handle.get()
                if fresh and mode == "topk":
                    m.timer("device_wait").observe(time.perf_counter() - tf)
                handle = _ResolvedHandle(payload)
            try:
                self._format_kind(st, target, handler, mode, kind, compiled,
                                  constraints, prog, bindings, mask, handle,
                                  ordered_rows, row_order, limit, trace,
                                  tagged, rcache, pg_stats, pg_dirty_pages,
                                  dv_stats)
            except ExternalDataError:
                # the scalar oracle's re-check hit a Fail-policy provider
                # failure: the same per-kind containment as phase 1
                m.counter("external_data_kind_failures").inc()
            else:
                if fp_enabled and fresh and payload is not None:
                    self._capture_sweep(st, kind, compiled, spec, payload,
                                        limit)
            tf2 = time.perf_counter()
            tracer.add_complete("kind.format", cat="format", t0=tf, t1=tf2,
                                parent=sweep_ctx, kind=kind, mode=mode)
            ph["format_s"] += tf2 - tf
        pipeline_wall = time.perf_counter() - t_pipe
        m.timer("audit_format").observe(ph["format_s"])
        tagged.sort(key=lambda kv: kv[0])
        # warm the churn-delta variants in the background once: the
        # first sweep after data churn otherwise compiles one per kind
        if limit is not None and self.delta_warm is None \
                and not self.scalar_only and self.device.type == "cuda":
            warm = [(sp[4], sp[5]) for sp in specs if sp[0] == "topk"]
            if warm:
                rewritten: list = []
                if self._dedup_on():
                    with self._prep_lock:
                        plan = self._audit_dedup_plan(st, target)
                        if plan is not None:
                            rewritten = self._rewritten_warm_items(st, plan)
                self._start_delta_warm(warm, rewritten, st)
        m.counter("audit_sweeps").inc()
        m.counter("audit_results").inc(len(tagged))
        m.timer("audit_sweep_wall").observe(time.perf_counter() - t_start)
        m.gauge("audit_resources").set(len(ordered_rows))
        phases: dict = {"full": full}
        if full:
            # overlap_fraction: the share of the summed stage seconds
            # hidden under other stages, the reference's key; the stages
            # here run one after another, so it stays 0
            sum_ph = ph["host_prep_s"] + ph["h2d_s"] + ph["device_s"] \
                + ph["format_s"]
            overlap = max(0.0, (sum_ph - pipeline_wall) / sum_ph) \
                if sum_ph > 0 else 0.0
            phases.update({
                "serial": True,
                "host_prep_s": round(ph["host_prep_s"], 6),
                "h2d_s": round(ph["h2d_s"], 6),
                "device_s": round(ph["device_s"], 6),
                "format_s": round(ph["format_s"], 6),
                "h2d_bytes": int(ph["h2d_bytes"]),
                "pipeline_wall_s": round(pipeline_wall, 6),
                "overlap_fraction": round(overlap, 4),
            })
            # the measured device time apportioned per template by the
            # cost model's units; the per-kind seconds anchor the drift
            # report and the audit calibration (obs/attribution.py)
            dev_entries = [(sp[1], sp[2].vectorized, len(sp[3]))
                           for sp in specs if sp[0] in ("topk", "mask")]
            if dev_entries and ph["device_s"] > 0:
                from gatekeeper_tpu_torch.obs.attribution import \
                    attribute_sweep
                phases["attribution"] = attribute_sweep(
                    dev_entries, ph["device_s"], len(ordered_rows),
                    measured=per_kind_dev, metrics=m)
            if dedup_plan is not None:
                n_res = len(ordered_rows)
                saved = sum(max(0, c - 1) * n_res
                            for c in dedup_applied.values())
                shared_n = sum(1 for c in dedup_applied.values() if c >= 2)
                phases["dedup"] = {
                    "enabled": True,
                    "groups": len(dedup_plan.groups),
                    "subprograms_shared": shared_n,
                    "evaluations_saved": int(saved),
                    "host_eval_s": round(dedup_host_s, 6),
                }
                m.counter("dedup_shared_subprograms").inc(shared_n)
                m.counter("dedup_evaluations_saved").inc(saved)
            else:
                phases["dedup"] = {"enabled": False}
            if twin_src is not None:
                phases["whatif"] = {
                    "twin_shared_kinds": len(twin_shared),
                    "twin_dispatched_kinds": sum(
                        1 for sp in specs if sp[0] in ("topk", "mask"))
                    - len(twin_shared),
                }
            m.counter("full_sweeps").inc()
            m.timer("full_sweep_host_prep").observe(ph["host_prep_s"])
            m.timer("full_sweep_h2d").observe(ph["h2d_s"])
            m.timer("full_sweep_device").observe(ph["device_s"])
            m.timer("full_sweep_format").observe(ph["format_s"])
            m.gauge("full_sweep_h2d_bytes").set(float(ph["h2d_bytes"]))
            m.gauge("full_sweep_overlap_fraction").set(overlap)
        # the selective-reuse stanza (both sweep shapes): kinds that
        # replayed a captured payload against kinds that ran, and the
        # (constraint x row) evaluations the replays saved
        phases["footprint"] = {
            "enabled": fp_enabled,
            "kinds_skipped": len(fp_skipped),
            "kinds_evaluated": len(specs) - len(fp_skipped),
            "evaluations_saved": int(fp_saved),
        }
        if fp_saved:
            m.counter("footprint_evaluations_saved").inc(fp_saved)
        # continuous-enforcement stanzas: which kinds served from the
        # ledger vs fell back (with reasons), page-level work, the delta
        # events emitted, and the device-resident path's accounting
        led = st.ledger
        phases["pages"] = {
            "enabled": pg_on,
            "page_rows": st.table.page_rows,
            "n_pages": st.table.n_pages,
            "kinds_paged": len(pg_kinds),
            "kinds_fallback": len(pg_fallback),
            "fallback_reasons": dict(pg_fallback),
            "pages_evaluated": int(pg_stats["pages_evaluated"]),
            "pages_skipped": int(pg_stats["pages_skipped"]),
            "rows_padded": int(pg_stats["rows_padded"]),
            "rows_reevaluated": int(pg_stats["rows_reevaluated"]),
            "evaluations_saved": int(pg_stats["evaluations_saved"]),
            "widen_fallbacks": int(pg_stats["widen_fallbacks"]),
            "ledger_full_builds": int(pg_stats["full_builds"]),
            "ledger_violations": led.total_violations()
            if led is not None else 0,
            "events": int(pg_stats["events"]),
        }
        phases["devpages"] = {"enabled": dv_on} \
            if dv_stats is None else {"enabled": True, **dv_stats}
        ext = self._external_sweep_stats(
            ext_warm.result() if ext_warm is not None else None)
        if ext is not None:
            phases["external"] = ext
        self.last_sweep_phases = phases
        if dv_stats is not None:
            m.counter("store_h2d_bytes_total").inc(int(dv_stats["h2d_bytes"]))
            m.gauge("devpages_scatter_rows").set(
                float(dv_stats["scatter_rows"]))
            m.gauge("devpages_delta_events").set(
                float(dv_stats["delta_events"]))
        m.gauge("store_pages_total").set(float(st.table.n_pages))
        if pg_kinds:
            m.gauge("store_pages_dirty").set(float(len(pg_dirty_pages)))
        if led is not None:
            m.gauge("ledger_violations").set(float(led.total_violations()))
        overflows = st.table.dirtylog_overflows
        if overflows > st.dirtylog_overflows_seen:
            m.counter("store_dirtylog_overflow_total").inc(
                overflows - st.dirtylog_overflows_seen)
            st.dirtylog_overflows_seen = overflows
        # flight recorder: one event a sweep, so a later dump shows the
        # sweeps that led up to it
        from gatekeeper_tpu_torch.obs.flightrecorder import record_event
        record_event("sweep", full=full, results=len(tagged),
                     wall_s=time.perf_counter() - t_start,
                     device_s=ph["device_s"] if full else None,
                     scalar_only=self.scalar_only)
        return [r for _, r in tagged], \
            ("\n".join(trace) if trace is not None else None)

    def _format_kind(self, st, target, handler, mode, kind, compiled,
                     constraints, prog, bindings, mask, handle, ordered_rows,
                     row_order, limit, trace, tagged, rcache, pg_stats,
                     pg_dirty_pages, dv_stats) -> None:
        """Phase 2 of :meth:`_sweep` for one kind: resolve its handle and
        format its results into ``tagged``."""
        if mode == "pages":
            # the devpages path fills the reader-side caches
            # (_kind_bindings) that _prep_lock serializes
            with self._prep_lock:
                self._paged_kind(st, target, handler, compiled, constraints,
                                 ordered_rows, row_order, kind, limit,
                                 tagged, rcache, pg_stats, pg_dirty_pages,
                                 dv_stats)
        elif mode == "topk":
            self._format_topk(st, target, handler, compiled, constraints,
                              prog, bindings, row_order, kind, limit, trace,
                              tagged, handle, rcache)
        elif mode == "mask":
            self._format_pairs(st, target, handler, compiled, constraints,
                               handle.get(), row_order, kind, limit, trace,
                               tagged, rcache)
        else:
            self._scalar_kind(st, target, handler, compiled, constraints,
                              mask, ordered_rows, row_order, kind, limit,
                              trace, tagged, rcache)

    # ------------------------------------------------------------------
    # admission: the review micro-batch on the device

    @locked_read
    def query_review_batch(self, target: str, reviews: list[dict],
                           opts: QueryOpts | None = None) -> list[tuple]:
        """Admission micro-batch as one [C, B] device pass per template
        kind (the reference's ``query_review_batch``).

        The B review objects become a throwaway mini resource table (own
        interner: admission strings must not grow the inventory's);
        lowered programs and a namespace-over-approximated match mask
        give candidate (constraint, review) pairs on the device (K3 for
        each regex table, then K1), and only candidates are re-evaluated
        exactly on the host (autoreject, namespaceSelector against the
        real cached namespaces, the scalar oracle): the same
        over-approximate-then-verify contract as the audit path, so the
        results equal per-review ``query_review`` exactly.

        Tracing (which must observe evaluation), a degraded device path,
        an empty batch and a batch of fewer than
        ``REVIEW_BATCH_MIN_EVALS`` (review, constraint) pairs run
        per-review scalar queries instead."""
        st = self._state(target)
        handler = self.targets[target]
        tracing = opts.tracing if opts is not None else self.default_tracing
        shed = (opts.shed_actions if opts is not None else None) or None
        constraints_all = list(st.all_constraints())
        if shed:
            # brownout: shed-action constraints are excluded before any
            # evaluation (device mask, host verify, all of it)
            constraints_all = [c for c in constraints_all
                               if enforcement_action_of(c) not in shed]
        n_reviews = len(reviews)
        if tracing or self.scalar_only \
                or not isinstance(st, TorchTargetState) or not n_reviews \
                or n_reviews * len(constraints_all) < REVIEW_BATCH_MIN_EVALS:
            return [self.query_review(target, r, opts) for r in reviews]

        from gatekeeper_tpu_torch.engine.match import MatchEngine
        from gatekeeper_tpu_torch.obs.trace import get_tracer
        from gatekeeper_tpu_torch.store.table import (ResourceMeta,
                                                      ResourceTable)
        t_batch = time.perf_counter()
        mt = ResourceTable()
        for i, rv in enumerate(reviews):
            k = rv.get("kind") or {}
            g, v = k.get("group", ""), k.get("version", "")
            api = f"{g}/{v}" if g else (v or "v1")
            obj = rv.get("object")
            mt.upsert(f"r{i:06d}", obj if isinstance(obj, dict) else {},
                      ResourceMeta(api_version=api, kind=k.get("kind", ""),
                                   name=str(rv.get("name", "")),
                                   namespace=rv.get("namespace")))
        mini = MatchEngine(mt)

        plans: list[tuple] = []
        for kind in sorted(st.templates):
            compiled = st.templates[kind]
            cons = self._kind_constraints(st, kind)
            if shed:
                cons = [c for c in cons
                        if enforcement_action_of(c) not in shed]
            if not cons:
                continue
            cmask = mini.mask(cons, overapprox_ns=True)
            lowered = compiled.vectorized
            # the mini table encodes every review as a CREATE, so a kind
            # reading $meta.operation would mis-gate UPDATE/DELETE
            # reviews (an under-approximation): it keeps the match gate
            uses_op = lowered is not None and any(
                rc.path[:1] == ("$meta",) and rc.path[1:] == ("operation",)
                for rc in lowered.spec.r_cols)
            ops_ok = all(r.get("operation", "CREATE") == "CREATE"
                         for r in reviews) if uses_op else True
            # an inventory join over the mini table would see only the
            # batch, not the real inventory (dropped violations): such
            # kinds keep the match gate and the exact host evaluation
            if lowered is not None and lowered.spec.inv_joins:
                lowered = None
            if lowered is not None and ops_ok:
                bindings = build_bindings(lowered.spec, mt, cons)
                if bindings.f32_unsafe:
                    # a float32 round trip could mis-order a compare and
                    # drop a real violation: keep the match gate
                    plans.append((kind, compiled, cons, cmask, None))
                    continue
                h = self.executor.run_async(lowered.program, bindings,
                                            match=cmask)
                plans.append((kind, compiled, cons, cmask, h))
            else:
                plans.append((kind, compiled, cons, cmask, None))
        gates = [(kind, compiled, cons, (h.get() if h is not None else cmask))
                 for kind, compiled, cons, cmask, h in plans]

        ns_sel_cons = [c for c in constraints_all
                       if ((c.get("spec") or {}).get("match") or {})
                       .get("namespaceSelector") is not None]
        out: list[tuple] = []
        for i, rv in enumerate(reviews):
            results: list[Result] = []
            if ns_sel_cons:
                for c, msg, details in handler.autoreject_review(
                        rv, ns_sel_cons, st.table):
                    results.append(Result(
                        msg=msg, metadata={"details": details},
                        constraint=c, review=rv,
                        enforcement_action=enforcement_action_of(c)))
            frozen = freeze(rv)
            # one review, many constraints: share review-pure
            # comprehension results, as query_review does
            shared: dict = {}
            for kind, compiled, cons, gate in gates:
                for ci, c in enumerate(cons):
                    if not gate[ci, i]:
                        continue
                    # exact matching (namespaceSelector against the real
                    # inventory included) before the exact evaluation
                    if not any(True for _ in handler.matching_constraints(
                            rv, [c], st.table)):
                        continue
                    results.extend(self._eval_pair(st, target, compiled, rv,
                                                   frozen, c, None, shared))
            out.append((results, None))
        m = self.metrics
        m.counter("review_batches_device").inc()
        m.counter("reviews_device").inc(n_reviews)
        get_tracer().add_complete(
            "admission.device_batch", cat="device", t0=t_batch,
            t1=time.perf_counter(), n_reviews=n_reviews, kinds=len(gates))
        return out

    @locked_read
    def predict_review_batch_seconds(self, target: str,
                                     n_reviews: int) -> float | None:
        """Cost-model-predicted wall seconds for a review batch of
        ``n_reviews`` against the installed constraint set: the static
        cost vector priced by the calibrated seconds-per-unit scale, or
        by the card's static prior while uncalibrated
        (costmodel.effective_scale), so deadline-aware batch shrinking
        has an opinion from the very first batch.  None only when there
        is nothing to predict (no reviews, prior disabled and no
        samples): callers treat None as "no opinion", never as zero."""
        from gatekeeper_tpu_torch.analysis import costmodel
        scale = costmodel.effective_scale()
        if scale <= 0.0 or n_reviews <= 0:
            return None
        st = self._state(target)
        key = (n_reviews, len(st.templates),
               sum(len(v) for v in st.constraints.values()))
        units = self._predict_cache.get(key)
        if units is None:
            units = 0.0
            for kind in st.templates:
                lowered = st.templates[kind].vectorized
                if lowered is None:
                    continue
                n_cons = len(st.constraints.get(kind, {}))
                if not n_cons:
                    continue
                units += costmodel.estimate(lowered, n_reviews,
                                            n_cons).units()
            if len(self._predict_cache) > 64:
                self._predict_cache.clear()
            self._predict_cache[key] = units
        return costmodel.predict_seconds(units, scale)

    @locked_read
    def memsurface_review_cap(self, target: str) -> int | None:
        """Stage-8 consumer: the largest review-batch rung whose worst
        per-kind dispatch footprint fits the device-memory budget left
        after the installed set's certified resident arrays.  A review
        batch pads its mini table to ``bucket(B)`` rows and dispatches
        one kind at a time, so the in-flight claim is the max (not the
        sum) over installed kinds of the peak at that row geometry.
        None when the stage is off or nothing is certified.  (The
        reference also clips its Stage-7 certified rungs with it; the
        port has no Stage 7 yet, so the micro-batcher halves blindly.)"""
        from gatekeeper_tpu_torch.analysis import memsurface
        from gatekeeper_tpu_torch.ir.prep import bucket, bucket_ladder
        if memsurface.mode() == "off":
            return None
        st = self.state.get(target)
        if not isinstance(st, TorchTargetState):
            return None
        certs = [c for c in st.memsurfaces.values()
                 if isinstance(c, memsurface.MemorySurface)
                 and not c.scalar_pin]
        if not certs:
            return None
        remaining = memsurface.budget_bytes(self.device) - sum(
            c.resident_bytes(memsurface.cap_dims()) for c in certs)
        if remaining <= 0:
            return 1
        best = 1
        for rung in [1] + list(bucket_ladder(8, memsurface._cap("r"))):
            dims = memsurface.cap_dims()
            dims["r"] = bucket(max(rung, 1))
            claim = max(c.peak_bytes(dims, devpages=False) for c in certs)
            if claim <= remaining:
                best = rung
            else:
                break
        return best

    @locked_read
    def explain_pair(self, target: str, kind: str, constraint_name: str,
                     resource_key: str) -> str:
        """Mask dump for one (constraint, resource) pair: every IR node's
        value on that slice plus rule verdicts (the tracing equivalent of
        the vectorized engine), with the scalar oracle's verdict
        appended for cross-checking.  It runs the plain evaluator on the
        sliced bindings (engine/executor.py ``explain``), never K1."""
        from gatekeeper_tpu_torch.engine.executor import explain
        st = self._state(target)
        compiled = st.templates.get(kind)
        if compiled is None:
            return f"no template {kind!r}"
        row = st.table.lookup(resource_key)
        if row is None:
            return f"no resource {resource_key!r}"
        constraints = self._kind_constraints(st, kind)
        names = [(c.get("metadata") or {}).get("name") for c in constraints]
        if constraint_name not in names:
            return f"no constraint {constraint_name!r} of kind {kind!r}"
        ci = names.index(constraint_name)
        if compiled.vectorized is None:
            return f"template {kind!r} runs on the scalar engine (not lowered)"
        with self._prep_lock:
            bindings = self._kind_bindings(st, kind, compiled, constraints)
            mask, _, _ = self._kind_mask(st, target, kind, constraints)
        out = explain(compiled.vectorized.program, bindings, ci, row,
                      match=mask if mask is not TRIVIAL_MATCH else None)
        handler = self.targets[target]
        meta = st.table.meta_at(row)
        review = handler.make_review(meta, st.table.object_at(row))
        matched = any(True for _ in handler.matching_constraints(
            review, [constraints[ci]], st.table))
        oracle = list(self._eval_pair(st, target, compiled, review,
                                      freeze(review), constraints[ci], None)) \
            if matched else []
        return out + f"\n  oracle: {len(oracle)} violation(s)" + "".join(
            f"\n    msg={r.msg!r}" for r in oracle)

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
        # .resource and owns result.metadata.  They carry the installed
        # constraint document: a status-only re-put keeps the cache
        return [dataclasses.replace(r, metadata=dict(r.metadata),
                                    constraint=c)
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
        counts, rows, valid = handle.get()
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
