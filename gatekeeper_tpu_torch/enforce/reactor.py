# Copied from gatekeeper_tpu/enforce/reactor.py for the PyTorch port.
"""Watch-driven continuous enforcement: the event reactor.

The verdict set is delta-maintained (`enforce/ledger.py`), but without
this module dirty bits are folded in only when the next audit sweep
runs, so sweep cadence bounds detection latency.  The reactor couples
the live watch stream to the row-paged store: a single-object event
becomes a single-page re-eval (``Client.react`` ->
``TorchDriver.react_kind``) with no sweep in between — wrapped in the
robustness machinery that earns ``GATEKEEPER_PAGES`` its default-on:

* a **bounded per-kind event queue** with page-granular coalescing
  (repeat events for an object collapse to the latest; events landing
  in an already-pending row page cost nothing downstream — the store's
  per-page dirty bits are the unit of re-evaluation) and backpressure:
  a full queue is an ``overflow`` pathology that escalates to a relist,
  never an unbounded buffer or a silent drop;

* a **sequence / resourceVersion gap detector**: every event is stamped
  with a per-kind transport sequence at the ingest edge (the analogue
  of counting chunks on the HTTP watch stream).  Delivery classifies
  pathology — ``duplicate`` (seq already delivered; dropped, verdict
  application is idempotent anyway), ``out_of_order`` (late arrival
  below the high-water seq; *heals* a suspected gap, no resync),
  ``gap`` (a seq still missing after a grace window — something was
  dropped on the wire), ``stale_rv`` (an event older than the kind's
  resync watermark; dropped), and ``overflow`` (queue cap exceeded);

* a **three-rung resync ladder**: rung 1 re-evaluates pending dirty
  pages (``Client.react``); rung 2 relists the kind from the cluster
  (``Client.sync_kind``) and forces a whole-kind diff re-apply against
  the existing ledger entry (``Client.resync``) — missed appears
  surface, phantoms clear, and a *clean* resync is event-free; rung 3
  (a kind needing rung 2 twice inside the escalation window, or a
  reconnect after total stream loss) relists every attached kind and
  diff-rebuilds them all: the paged equivalent of upstream's
  fixed-interval full audit resync, but emitting exactly the true diff;

* **reconnect under exponential backoff + jitter** when the stream
  stalls, and graceful degradation to the existing sweep-cadence mode
  while unhealthy: ``live -> degraded(sweep-cadence) -> resyncing ->
  live``, every transition flight-recorded (``reactor_state`` events)
  and mirrored into ``probe --health`` and ``GET /debug/violations``.

Podracer (PAPERS.md) is the shape: event ingest stays decoupled from
device evaluation, so a sick stream degrades the *cadence*, never the
*verdicts* — while degraded, the audit sweep remains the source of
truth exactly as before this module existed.

Lock discipline: ``_rx_lock`` is a leaf.  Watch callbacks only enqueue
under it; ``pump()`` snapshots work under it, releases it, then calls
into the client (client RWLock -> driver locks).  No client or driver
call ever happens while ``_rx_lock`` is held, so the reactor adds no
edge into the engine's lock-order graph (``selflint --lockorder``).

Differences of the port (ROADMAP Queue C, each held by
tests/test_torch_reactor.py):

* **Errors are kept.**  The reference counts every exception of a rung
  (``react_errors``, ``resync_errors``) and of the pump loop
  (``pump_errors``) and carries on.  The port keeps the same counters
  and also keeps the first exception of ``client.react``,
  ``client.resync`` and the pump loop as ``Reactor.error``: the next
  ``AuditManager.audit_once`` raises it once, and ``stop()`` raises it
  if no sweep took it, so a failed kernel launch on the devpaged route
  cannot hide behind the sweep cadence.  Data errors of
  ``apply_objects`` (``apply_errors``) are only counted, as in the
  reference.
* **Rung 1 follows the store's writer.**  With ``apply_objects`` off
  (the manager: the sync controllers own store writes, on their own
  thread) a react can run before the controller's write of the event's
  object lands, and find a clean page.  Each react records the store's
  write generation (``driver.store_generation``) read before it; a pump
  that finds the generation moved since a kind's last react reacts it
  again (``rereacts``), so the write reaches the ledger one pump later
  however late it lands, instead of at the next sweep.  It is still the
  one write path: the reactor only schedules.
"""

from __future__ import annotations

import collections
import os
import random
import threading
import time
import weakref
from typing import Any, Callable, Iterable

from gatekeeper_tpu_torch.api.config import GVK
from gatekeeper_tpu_torch.resilience import faults

# state machine: live -> degraded(sweep-cadence) -> resyncing -> live
LIVE = "live"
DEGRADED = "degraded"
RESYNCING = "resyncing"

PATHOLOGIES = ("gap", "duplicate", "out_of_order", "stale_rv", "overflow")

_STATE_GAUGE = {LIVE: 0, RESYNCING: 1, DEGRADED: 2}


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_i(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def queue_cap() -> int:
    """Per-kind pending-event bound (coalesced objects)."""
    return max(1, _env_i("GATEKEEPER_REACTOR_QUEUE", 256))


def gap_grace_s() -> float:
    """How long a missing transport seq may stay missing before it is
    confirmed as a ``gap`` (reordered frames arrive within this)."""
    return _env_f("GATEKEEPER_REACTOR_GAP_GRACE_S", 0.25)


def stall_timeout_s() -> float:
    """How long the stream may stall before the reactor declares the
    connection dead and degrades to sweep cadence."""
    return _env_f("GATEKEEPER_REACTOR_STALL_S", 0.5)


def backoff_base_s() -> float:
    return _env_f("GATEKEEPER_REACTOR_BACKOFF_S", 0.5)


def escalate_window_s() -> float:
    """Two rung-2 resyncs of the same kind inside this window take
    rung 3 instead."""
    return _env_f("GATEKEEPER_REACTOR_ESCALATE_S", 10.0)


def _rv_of(obj: Any) -> int | None:
    try:
        rv = (obj.get("metadata") or {}).get("resourceVersion")
    except AttributeError:
        return None
    if isinstance(rv, str) and rv.isdigit():
        return int(rv)
    if isinstance(rv, int):
        return rv
    return None


def _ident_of(obj: Any) -> tuple[str, str]:
    meta = (obj.get("metadata") or {}) if isinstance(obj, dict) else {}
    return (meta.get("namespace") or "", meta.get("name") or "")


class _KindStream:
    """Per-kind stream state: transport sequencing, gap suspicion, the
    coalesced pending queue, and the RV watermark guard."""

    def __init__(self, gvk: GVK, rv_floor: int = 0):
        self.gvk = gvk
        self.next_tseq = 1          # transport stamp counter (wire edge)
        self.hwm = 0                # highest tseq delivered
        self.delivered: set[int] = set()
        self.missing: dict[int, float] = {}    # tseq -> grace deadline
        # coalesced queue: object identity -> (event type, latest obj).
        # Insertion order is delivery order; re-delivery moves to end.
        self.pending: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()
        self.pending_pages: set = set()
        self.last_rv = 0
        self.rv_floor = rv_floor    # warm-restart watermark
        self.rv_checked = rv_floor <= 0
        # recent object cache so watch_flood can replay a realistic
        # redundant-event storm (bounded by the kind's live set)
        self.recent: "collections.OrderedDict[tuple, dict]" = \
            collections.OrderedDict()
        self.resync_rung = 0        # highest rung requested, 0 = none
        self.resync_times: collections.deque = collections.deque(maxlen=4)
        self.reason = ""
        # the store generation read before the kind's last react
        # (apply_objects off): a pump that finds it moved re-reacts
        self.react_gen: int | None = None

    def reset_stream(self) -> None:
        """A reconnect starts a fresh transport stream: suspicion state
        is meaningless across it (seqs keep counting monotonically)."""
        self.hwm = self.next_tseq - 1
        self.delivered.clear()
        self.missing.clear()


class Reactor:
    """Couples cluster watch streams to the paged verdict ledger."""

    def __init__(self, client, cluster=None, target: str | None = None,
                 apply_objects: bool = False, seed: int = 0,
                 metrics=None, name: str = "reactor"):
        self._client = client
        self._cluster = cluster
        self._target = target or next(iter(client.targets))
        # apply_objects: the reactor itself upserts/removes event
        # objects into the store before reacting (chaos/bench/test
        # fixtures).  In the manager the sync controllers own store
        # writes and the reactor only schedules re-evaluation.
        self._apply_objects = apply_objects
        self._rng = random.Random(seed)
        self.metrics = metrics if metrics is not None \
            else getattr(client.driver, "metrics", None)
        self.name = name

        # _rx_lock is a LEAF: never held across client/driver calls.
        self._rx_lock = threading.RLock()
        self._streams: dict[str, _KindStream] = {}
        self._subs: dict[str, tuple[GVK, Callable[[], None]]] = {}
        self.state = LIVE
        self.state_since = time.monotonic()
        self.transitions: collections.deque = collections.deque(maxlen=64)
        self.counters: collections.Counter = collections.Counter()
        # stall / reconnect machinery
        self._stall_buf: list[tuple[str, Any]] = []
        self._stall_since: float | None = None
        self._reconnect_at: float | None = None
        self._backoff_n = 0
        self._last_sweep: float | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # the first exception of client.react / client.resync or of the
        # pump loop, kept until a sweep or stop() raises it
        self.error: BaseException | None = None
        faults.check_armed()
        _registry.add(self)

    # ------------------------------------------------------------------
    # subscriptions

    def attach(self, gvk: GVK) -> None:
        """Subscribe to one GVK's watch stream.  The kind's RV floor is
        seeded from the adopted ledger watermark (warm restart): if the
        first event observed does not extend the watermark the snapshot
        was built at, the pg tier adopted stale state and the kind gets
        one forced resync."""
        kind = gvk.kind
        floor = 0
        fn = getattr(self._client.driver, "ledger_rv", None)
        if fn is not None:
            try:
                floor = int(fn(self._target, kind) or 0)
            except Exception:
                floor = 0
        with self._rx_lock:
            if kind in self._subs:
                return
            self._streams.setdefault(kind, _KindStream(gvk, rv_floor=floor))
        unsub = None
        if self._cluster is not None:
            unsub = self._cluster.watch(
                gvk, lambda ev, _k=kind: self.ingest(_k, ev))
        with self._rx_lock:
            self._subs[kind] = (gvk, unsub or (lambda: None))

    def detach(self, kind: str) -> None:
        with self._rx_lock:
            sub = self._subs.pop(kind, None)
            self._streams.pop(kind, None)
        if sub is not None:
            sub[1]()

    def sync_subscriptions(self, gvks: Iterable[GVK]) -> None:
        """Reconcile attached streams against the watch manager's
        active roster (called from the manager's poll loop)."""
        want = {g.kind: g for g in gvks}
        with self._rx_lock:
            have = set(self._subs)
        for kind in have - set(want):
            self.detach(kind)
        for kind, gvk in want.items():
            if kind not in have:
                self.attach(gvk)

    # ------------------------------------------------------------------
    # ingest: the wire edge

    def ingest(self, kind: str, event: Any) -> None:
        """Watch callback.  Stamps the transport sequence and delivers,
        with the watch-class fault seams applied in wire order: a stall
        buffers *before* stamping (bytes stuck in the socket), gap /
        duplicate / reorder act on stamped frames (the chunk made it
        onto the wire and was then lost / repeated / swapped), a flood
        replays recent frames after the real one."""
        with self._rx_lock:
            st = self._streams.get(kind)
            if st is None:
                return
            if faults.active("watch_stall"):
                if self._stall_since is None:
                    self._stall_since = time.monotonic()
                self._stall_buf.append((kind, event))
                self.counters["stalled_events"] += 1
                return
            self._flush_stall_locked()
            tseq = st.next_tseq
            st.next_tseq += 1
            if faults.take("watch_gap"):
                # frame lost on the wire: seq consumed, never delivered
                self.counters["faults_watch_gap"] += 1
                st.missing[tseq] = time.monotonic() + gap_grace_s()
                return
            if faults.take("watch_reorder"):
                # frame swapped with its successor: deliver seq+1's
                # payload slot first by holding this one until the next
                # frame is stamped — modelled by marking it missing now
                # and delivering late below the high-water mark
                self.counters["faults_watch_reorder"] += 1
                st.missing[tseq] = time.monotonic() + gap_grace_s()
                st.hwm = max(st.hwm, tseq)
                self._deliver_locked(st, tseq, event, late=True)
                return
            self._deliver_locked(st, tseq, event)
            if faults.take("watch_duplicate"):
                self.counters["faults_watch_duplicate"] += 1
                self._deliver_locked(st, tseq, event)
            if faults.active("watch_flood"):
                self.counters["faults_watch_flood"] += 1
                for obj in list(st.recent.values()):
                    fseq = st.next_tseq
                    st.next_tseq += 1
                    self._deliver_locked(
                        st, fseq, _Replay("MODIFIED", obj))

    def _flush_stall_locked(self) -> None:
        """Short stall (cleared before the timeout): the socket drained
        — stamp and deliver the buffered frames in order."""
        if not self._stall_buf:
            self._stall_since = None
            return
        buf, self._stall_buf = self._stall_buf, []
        self._stall_since = None
        for kind, ev in buf:
            st = self._streams.get(kind)
            if st is None:
                continue
            tseq = st.next_tseq
            st.next_tseq += 1
            self._deliver_locked(st, tseq, ev)

    def _deliver_locked(self, st: _KindStream, tseq: int, event: Any,
                        late: bool = False) -> None:
        """Classify one stamped frame and enqueue its work."""
        self.counters["events"] += 1
        if tseq in st.delivered:
            self._pathology_locked(st, "duplicate")
            return
        if tseq <= st.hwm:
            # late arrival below the high-water mark: heals a suspected
            # gap — the frame was reordered, not lost
            self._pathology_locked(st, "out_of_order")
            if st.missing.pop(tseq, None) is None and not late:
                # below hwm yet never suspected: stream restarted its
                # counter — treat as a gap-class break
                st.resync_rung = max(st.resync_rung, 2)
                st.reason = st.reason or "seq_regression"
        elif tseq == st.hwm + 1:
            st.hwm = tseq
            # contiguous advance may close the window over older seqs
            while st.hwm + 1 in st.delivered:
                st.delivered.discard(st.hwm + 1)
                st.hwm += 1
        else:
            # jumped ahead: everything between is a suspected gap with
            # a grace deadline (reordering heals it; expiry confirms)
            deadline = time.monotonic() + gap_grace_s()
            for s in range(st.hwm + 1, tseq):
                st.missing.setdefault(s, deadline)
            st.hwm = tseq
        st.delivered.add(tseq)
        if len(st.delivered) > 4096:
            st.delivered = {s for s in st.delivered if s > st.hwm - 1024}

        obj = getattr(event, "obj", None)
        etype = getattr(event, "type", "MODIFIED")
        rv = _rv_of(obj)
        if rv is not None:
            if not st.rv_checked:
                st.rv_checked = True
                if rv <= st.rv_floor:
                    # warm restart: first observed RV does not extend the
                    # adopted snapshot watermark — the pg tier may hold
                    # verdicts for state this stream never saw
                    self._pathology_locked(st, "stale_rv")
                    st.resync_rung = max(st.resync_rung, 2)
                    st.reason = st.reason or "stale_rv_watermark"
                    return
            elif rv <= st.rv_floor:
                # pre-relist leftover: already incorporated by a resync
                self._pathology_locked(st, "stale_rv")
                return
            st.last_rv = max(st.last_rv, rv)

        ident = _ident_of(obj) if isinstance(obj, dict) else ("", "")
        if etype == "DELETED":
            st.recent.pop(ident, None)
        elif isinstance(obj, dict):
            st.recent[ident] = obj
            while len(st.recent) > 4 * queue_cap():
                st.recent.popitem(last=False)

        page = self._page_hint(obj)
        if page is not None and page in st.pending_pages \
                and ident in st.pending:
            self.counters["coalesced_pages"] += 1
        st.pending.pop(ident, None)     # re-delivery moves to end
        st.pending[ident] = (etype, obj)
        if page is not None:
            st.pending_pages.add(page)
        if len(st.pending) > queue_cap():
            # backpressure: drop the queue, escalate — the relist
            # supersedes every queued frame
            st.pending.clear()
            st.pending_pages.clear()
            self._pathology_locked(st, "overflow")
            st.resync_rung = max(st.resync_rung, 2)
            st.reason = st.reason or "queue_overflow"

    def _page_hint(self, obj: Any) -> int | None:
        """Row page of an event object, for coalescing accounting.
        Driver call, but read-only and internally locked; returns None
        for objects not (yet) resident."""
        fn = getattr(self._client.driver, "page_of_object", None)
        if fn is None or not isinstance(obj, dict):
            return None
        try:
            return fn(self._target, obj)
        except Exception:
            return None

    def _pathology_locked(self, st: _KindStream, cls: str) -> None:
        self.counters[f"pathology_{cls}"] += 1
        if self.metrics is not None:
            self.metrics.counter(f"reactor_pathology_{cls}_total").inc()

    # ------------------------------------------------------------------
    # pump: drain queues, confirm gaps, run the ladder

    def pump(self, budget: int | None = None) -> dict:
        """Process pending work.  Never called with ``_rx_lock`` held
        across client/driver calls: work is snapshotted under the lock,
        the lock released, then applied."""
        now = time.monotonic()
        summary = {"reacted": [], "resynced": [], "rung3": False}

        with self._rx_lock:
            # stall watchdog: a buffered stream older than the timeout
            # is a dead connection
            if self._stall_since is not None \
                    and now - self._stall_since > stall_timeout_s() \
                    and self.state != DEGRADED:
                self._stall_buf.clear()
                self._backoff_n = 0
                self._reconnect_at = now + self._next_backoff()
                self._set_state_locked(DEGRADED, "watch stream stalled")
            elif self._stall_since is None and self._stall_buf:
                self._flush_stall_locked()
            # confirm expired gap suspicions
            for st in self._streams.values():
                expired = [s for s, dl in st.missing.items() if dl <= now]
                if expired:
                    for s in expired:
                        st.missing.pop(s, None)
                        st.delivered.add(s)     # stop re-suspecting it
                    self._pathology_locked(st, "gap")
                    st.resync_rung = max(st.resync_rung, 2)
                    st.reason = st.reason or "gap_confirmed"

            degraded = self.state == DEGRADED
            reconnect_due = degraded and self._reconnect_at is not None \
                and now >= self._reconnect_at

        if degraded:
            if reconnect_due:
                self._try_reconnect()
            return summary

        # the store's write generation, read outside the lock, for the
        # kinds reacted before (apply_objects off)
        with self._rx_lock:
            reacted = any(st.react_gen is not None
                          for st in self._streams.values())
        gen = self._store_generation() if reacted else None

        # snapshot per-kind work under the lock, apply outside it
        with self._rx_lock:
            work: list[tuple[str, int, list, str]] = []
            rereact: list[str] = []
            for kind, st in self._streams.items():
                if st.resync_rung or st.pending:
                    batch = list(st.pending.values())
                    work.append((kind, st.resync_rung, batch, st.reason))
                    st.pending.clear()
                    st.pending_pages.clear()
                    st.resync_rung = 0
                    st.reason = ""
                    if budget is not None:
                        budget -= 1
                        if budget <= 0:
                            break
                elif gen is not None and st.react_gen is not None \
                        and gen != st.react_gen:
                    # a store write landed after the kind's last react
                    rereact.append(kind)

        for kind in rereact:
            self.counters["rereacts"] += 1
            self._apply_batch(kind, [], rung1=False)
        rung3 = False
        for kind, rung, batch, reason in work:
            if rung >= 2:
                with self._rx_lock:
                    st = self._streams.get(kind)
                    if st is not None:
                        recent = [t for t in st.resync_times
                                  if now - t < escalate_window_s()]
                        st.resync_times.append(now)
                        if recent:
                            rung3 = True
                if rung3:
                    break
                self._resync_kind(kind, reason)
                summary["resynced"].append(kind)
            else:
                self._apply_batch(kind, batch)
                summary["reacted"].append(kind)
        if rung3:
            self._full_resync("escalated: repeated kind resync")
            summary["rung3"] = True

        with self._rx_lock:
            if self.state == RESYNCING and not any(
                    st.resync_rung for st in self._streams.values()):
                self._set_state_locked(LIVE, "resync complete")
        return summary

    # -- ladder rungs (no _rx_lock held) --------------------------------

    def _apply_batch(self, kind: str, batch: list,
                     rung1: bool = True) -> None:
        """Rung 1: fold the kind's dirty pages into the ledger.  With
        ``apply_objects`` off it records the store generation read before
        the react, for the pump's re-react; ``rung1`` False is such a
        re-react."""
        if self._apply_objects:
            for etype, obj in batch:
                if not isinstance(obj, dict):
                    continue
                try:
                    if etype == "DELETED":
                        self._client.remove_data(obj)
                    else:
                        self._client.add_data(obj)
                except Exception:
                    self.counters["apply_errors"] += 1
        gen = None if self._apply_objects else self._store_generation()
        try:
            self._client.react(kind)
            if rung1:
                self.counters["rung1"] += 1
                if self.metrics is not None:
                    self.metrics.counter("reactor_react_total").inc()
        except Exception as e:
            self.counters["react_errors"] += 1
            self._keep_error(e)
        if gen is not None:
            with self._rx_lock:
                st = self._streams.get(kind)
                if st is not None:
                    st.react_gen = gen

    def _store_generation(self) -> int | None:
        """The driver's store write generation (None when the driver
        has no such accessor).  A driver call: never under _rx_lock."""
        fn = getattr(self._client.driver, "store_generation", None)
        return None if fn is None else fn(self._target)

    def _keep_error(self, e: BaseException) -> None:
        with self._rx_lock:
            if self.error is None:
                self.error = e

    def take_error(self) -> BaseException | None:
        """The kept exception, once: the caller raises it."""
        with self._rx_lock:
            err, self.error = self.error, None
        return err

    def _resync_kind(self, kind: str, reason: str) -> None:
        """Rung 2: relist the kind, then force a whole-kind diff
        re-apply against the existing ledger entry."""
        with self._rx_lock:
            if self.state == LIVE:
                self._set_state_locked(RESYNCING, f"{kind}: {reason}")
            st = self._streams.get(kind)
            gvk = st.gvk if st is not None else None
        listed_rv = 0
        try:
            if gvk is not None and self._cluster is not None \
                    and self._apply_objects:
                objs = self._cluster.list(gvk)
                self._client.sync_kind(gvk.group_version, kind, objs)
                listed_rv = max(
                    [r for r in (_rv_of(o) for o in objs)
                     if r is not None], default=0)
            try:
                self._client.resync(kind)
            except Exception as e:
                self._keep_error(e)
                raise
            self.counters["rung2"] += 1
            if self.metrics is not None:
                self.metrics.counter("reactor_resync_total").inc()
        except Exception:
            self.counters["resync_errors"] += 1
        with self._rx_lock:
            st = self._streams.get(kind)
            if st is not None:
                st.reset_stream()
                if listed_rv:
                    st.rv_floor = max(st.rv_floor, listed_rv)
                    st.last_rv = max(st.last_rv, listed_rv)
                st.rv_checked = True

    def _full_resync(self, reason: str) -> None:
        """Rung 3: relist + diff-rebuild every attached kind — the
        paged analogue of upstream's full audit resync."""
        with self._rx_lock:
            if self.state != RESYNCING:
                self._set_state_locked(RESYNCING, reason)
            kinds = list(self._streams)
            for st in self._streams.values():
                st.pending.clear()
                st.pending_pages.clear()
                st.resync_rung = 0
                st.reason = ""
        for kind in kinds:
            self._resync_kind(kind, reason)
        self.counters["rung3"] += 1

    # -- reconnect ------------------------------------------------------

    def _next_backoff(self) -> float:
        base = backoff_base_s() * (2 ** self._backoff_n)
        self._backoff_n = min(self._backoff_n + 1, 8)
        delay = min(base, 30.0)
        return delay * (1.0 + 0.25 * self._rng.random())

    def _try_reconnect(self) -> None:
        """One reconnect attempt.  The stall fault models the server
        still refusing the stream: attempts while it is active fail and
        re-arm the (exponential, jittered) backoff."""
        self.counters["reconnect_attempts"] += 1
        if faults.active("watch_stall"):
            with self._rx_lock:
                self._stall_buf.clear()
                self._reconnect_at = time.monotonic() + self._next_backoff()
            return
        with self._rx_lock:
            self._stall_buf.clear()
            self._stall_since = None
            self._reconnect_at = None
            self._backoff_n = 0
            self._set_state_locked(RESYNCING, "reconnected; resyncing")
            kinds = list(self._streams)
            for st in self._streams.values():
                st.reset_stream()
                st.pending.clear()
                st.pending_pages.clear()
        self.counters["reconnects"] += 1
        for kind in kinds:
            self._resync_kind(kind, "post-reconnect relist")
        with self._rx_lock:
            self._set_state_locked(LIVE, "post-reconnect resync complete")

    # ------------------------------------------------------------------
    # state + introspection

    def _set_state_locked(self, state: str, reason: str) -> None:
        if state == self.state:
            return
        prev, self.state = self.state, state
        self.state_since = time.monotonic()
        self.transitions.append(
            {"from": prev, "to": state, "reason": reason,
             "t": time.time()})
        self.counters[f"state_{state}"] += 1
        if self.metrics is not None:
            self.metrics.gauge("reactor_state").set(_STATE_GAUGE[state])
        try:
            from gatekeeper_tpu_torch.obs.flightrecorder import record_event
            record_event("reactor_state", reactor=self.name,
                         prev=prev, state=state, reason=reason)
        except Exception:
            pass

    def note_sweep(self) -> None:
        """Audit-manager hook: a full sweep just completed.  While
        degraded this is the sweep-cadence fallback actually doing the
        enforcement; record it so health output can show the cadence."""
        with self._rx_lock:
            self._last_sweep = time.monotonic()
            self.counters["sweeps_observed"] += 1

    def state_payload(self) -> dict:
        with self._rx_lock:
            now = time.monotonic()
            return {
                "name": self.name,
                "state": self.state,
                "state_age_s": round(now - self.state_since, 3),
                "kinds": {
                    k: {"pending": len(st.pending),
                        "pending_pages": len(st.pending_pages),
                        "hwm": st.hwm,
                        "suspected_gaps": len(st.missing),
                        "last_rv": st.last_rv,
                        "rv_floor": st.rv_floor}
                    for k, st in self._streams.items()},
                "counters": dict(self.counters),
                "transitions": list(self.transitions)[-8:],
                "last_sweep_age_s": (
                    round(now - self._last_sweep, 3)
                    if self._last_sweep is not None else None),
            }

    def healthy(self) -> bool:
        return self.state == LIVE

    # ------------------------------------------------------------------
    # pump thread

    def start(self, interval: float = 0.05) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.pump()
                except Exception as e:
                    self.counters["pump_errors"] += 1
                    self._keep_error(e)
                self._stop.wait(interval)

        self._thread = threading.Thread(
            target=loop, name=f"{self.name}-pump", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the pump thread and every subscription, then raise the
        kept exception if no sweep took it."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
        for kind in list(self._subs):
            self.detach(kind)
        err = self.take_error()
        if err is not None:
            raise err


class _Replay:
    """A flood-replayed frame (shaped like cluster.fake.Event)."""

    __slots__ = ("type", "obj")

    def __init__(self, etype: str, obj: dict):
        self.type = etype
        self.obj = obj


# ----------------------------------------------------------------------
# module registry: /debug/violations and probe --health enumerate live
# reactors the same way ledger.export_all() enumerates ledgers

_registry: "weakref.WeakSet[Reactor]" = weakref.WeakSet()


def export_state() -> list[dict]:
    return [r.state_payload() for r in list(_registry)]
