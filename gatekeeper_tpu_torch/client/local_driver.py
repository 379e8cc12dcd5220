# Copied from gatekeeper_tpu/client/local_driver.py for the PyTorch port.
"""The ``local`` driver: scalar oracle engine.

Evaluates the hooks dataflow (reference: regolib/src.go — violation =
autoreject ∪ (matching_constraints × template violation); audit =
matching_reviews_and_constraints × template violation) entirely on host
with the scalar interpreter.  This is the conformance reference and the
development engine, playing the role of drivers/local in the reference
(in-process OPA, local.go:28).  The jax driver must agree with it
everywhere.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Iterator

from gatekeeper_tpu_torch.api.templates import CompiledTemplate
from gatekeeper_tpu_torch.client.interface import Driver, QueryOpts
from gatekeeper_tpu_torch.client.targets import TargetHandler
from gatekeeper_tpu_torch.client.types import Result, enforcement_action_of
from gatekeeper_tpu_torch.errors import ClientError
from gatekeeper_tpu_torch.rego.values import Obj, freeze, thaw
from gatekeeper_tpu_torch.store.table import ResourceMeta, ResourceTable


class TargetState:
    def __init__(self):
        self.table = ResourceTable()
        self.templates: dict[str, CompiledTemplate] = {}
        self.constraints: dict[str, dict[str, dict]] = {}  # kind -> name -> raw
        self._frozen_constraints: dict[tuple[str, str], Any] = {}
        self._inv_cache: tuple[int, Any] | None = None

    def all_constraints(self) -> Iterator[dict]:
        for kind in sorted(self.constraints):
            for name in sorted(self.constraints[kind]):
                yield self.constraints[kind][name]

    def inventory_doc(self) -> Any:
        """Frozen {"cluster": ..., "namespace": ...} doc — the shape of
        data.external[target] that templates see as data.inventory
        (regolib/src.go:55-60).  Cached per table generation."""
        gen = self.table.generation
        if self._inv_cache is not None and self._inv_cache[0] == gen:
            return self._inv_cache[1]
        import urllib.parse

        cluster: dict = {}
        namespace: dict = {}
        for key, row in self.table.rows_items():
            meta = self.table.meta_at(row)
            obj = self.table.object_at(row)
            if meta is None:
                continue
            escaped = urllib.parse.quote(meta.api_version, safe="")
            if meta.namespace is None:
                cluster.setdefault(escaped, {}).setdefault(meta.kind, {})[meta.name] = obj
            else:
                namespace.setdefault(meta.namespace, {}).setdefault(
                    escaped, {}).setdefault(meta.kind, {})[meta.name] = obj
        frozen = freeze({"inventory": {"cluster": cluster, "namespace": namespace}})
        self._inv_cache = (gen, frozen)
        return frozen


class RWLock:
    """Readers-writer lock mirroring the reference drivers' RWMutex
    (local.go:43-48): queries run concurrently, mutations are exclusive.
    Same-thread re-entrance is allowed for writes (JaxDriver overrides
    call super()) and for reads taken while holding the write lock.

    Reader-side cache fills (mask/bindings/format memos) are safe
    concurrently: with writers excluded the table is stable, so racing
    readers compute identical values and last-write-wins is benign."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer: int | None = None
        self._depth = 0
        self._waiting_writers = 0
        # per-thread read depth: re-entrant reads must not block behind
        # a waiting writer (they would deadlock against it)
        self._local = threading.local()

    def acquire_read(self):
        me = threading.get_ident()
        held = getattr(self._local, "depth", 0)
        with self._cond:
            if self._writer == me:       # read within own write: nest
                self._depth += 1
                return
            if held:                     # re-entrant read: already admitted
                self._readers += 1
                self._local.depth = held + 1
                return
            # writer preference (Go sync.RWMutex semantics): fresh
            # readers queue behind pending writers so sustained read
            # load cannot starve mutations indefinitely
            while self._writer is not None or self._waiting_writers:
                self._cond.wait()
            self._readers += 1
            self._local.depth = 1

    def release_read(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._depth -= 1
                return
            self._readers -= 1
            self._local.depth = getattr(self._local, "depth", 1) - 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._depth += 1
                return
            self._waiting_writers += 1
            try:
                while self._writer is not None or self._readers:
                    self._cond.wait()
            finally:
                self._waiting_writers -= 1
            self._writer = me
            self._depth = 1

    def release_write(self):
        with self._cond:
            self._depth -= 1
            if self._depth == 0:
                self._writer = None
                self._cond.notify_all()

    @contextlib.contextmanager
    def read(self):
        """Shared-lock context manager (queries run concurrently)."""
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextlib.contextmanager
    def write(self):
        """Exclusive-lock context manager (mutations)."""
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()


def locked(fn):
    """Exclusive (writer) lock around a mutating Driver method."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        self._lock.acquire_write()
        try:
            return fn(self, *args, **kwargs)
        finally:
            self._lock.release_write()
    return wrapper


def locked_read(fn):
    """Shared (reader) lock around a query Driver method."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        self._lock.acquire_read()
        try:
            return fn(self, *args, **kwargs)
        finally:
            self._lock.release_read()
    return wrapper


class LocalDriver(Driver):
    """Scalar reference engine (tracing mirrors local.New(local.Tracing(true)),
    main.go:68: construction-time default, overridable per query).
    Thread-safe via one re-entrant instance lock (see `locked`)."""

    def __init__(self, tracing: bool = False):
        self.default_tracing = tracing
        self.targets: dict[str, TargetHandler] = {}
        self.state: dict[str, TargetState] = {}
        self._lock = RWLock()

    # ------------------------------------------------------------------

    def init(self, targets: dict[str, TargetHandler]) -> None:
        self.targets = dict(targets)
        for name in targets:
            self.state.setdefault(name, TargetState())

    def _state(self, target: str) -> TargetState:
        st = self.state.get(target)
        if st is None:
            raise ClientError(f"unknown target {target!r}")
        return st

    @locked
    def put_template(self, target: str, kind: str, compiled: CompiledTemplate) -> None:
        self._state(target).templates[kind] = compiled

    @locked
    def delete_template(self, target: str, kind: str) -> None:
        st = self._state(target)
        st.templates.pop(kind, None)
        st.constraints.pop(kind, None)
        for k in [k for k in st._frozen_constraints if k[0] == kind]:
            del st._frozen_constraints[k]

    @locked
    def put_constraint(self, target: str, kind: str, name: str, constraint: dict) -> None:
        st = self._state(target)
        st.constraints.setdefault(kind, {})[name] = constraint
        st._frozen_constraints[(kind, name)] = freeze(constraint)

    @locked
    def delete_constraint(self, target: str, kind: str, name: str) -> None:
        st = self._state(target)
        st.constraints.get(kind, {}).pop(name, None)
        st._frozen_constraints.pop((kind, name), None)

    @locked
    def put_data(self, target: str, key: str, meta: ResourceMeta, obj: dict) -> None:
        self._state(target).table.upsert(key, obj, meta)

    @locked
    def put_data_batch(self, target: str,
                       entries: list[tuple[str, ResourceMeta, dict]]) -> None:
        """Bulk ingest under ONE writer acquisition (initial list-sync
        floods; per-object locking dominates at 1M objects).  One
        generation bump for the whole batch keeps downstream delta
        caches seeing a single churn event."""
        self._state(target).table.bulk_upsert(
            [(key, obj, meta) for key, meta, obj in entries])

    @locked
    def delete_data(self, target: str, key: str) -> bool:
        return self._state(target).table.remove(key)

    @locked
    def wipe_data(self, target: str) -> None:
        self._state(target).table.wipe()

    # ------------------------------------------------------------------

    def _frozen_constraint(self, st: TargetState, c: dict) -> Any:
        kind = (c.get("kind"), (c.get("metadata") or {}).get("name"))
        return st._frozen_constraints.get(kind) or freeze(c)

    def _eval_pair(self, st: TargetState, target: str, compiled: CompiledTemplate,
                   review: dict, frozen_review: Any, constraint: dict,
                   trace: list | None,
                   shared: dict | None = None) -> Iterator[Result]:
        """One (review, constraint) evaluation — the regolib violation body
        (src.go:19-34): input = {review, constraint}, data.inventory = inv.

        ``shared``: per-review memo dict reused across the constraint
        loop — review-pure comprehensions (rego/closures) evaluate once
        per review instead of once per (review, constraint).  Skipped
        under tracing (the tracer must observe evaluation)."""
        input_doc = Obj({"review": frozen_review,
                         "constraint": self._frozen_constraint(st, constraint)})
        # freezing the whole inventory is O(cache size); skip it for
        # templates that never read data.inventory
        inv = st.inventory_doc() if compiled.uses_inventory else None
        tracer: list | None = [] if trace is not None else None
        step = None
        if trace is not None:
            # per-step event trace (OPA topdown/trace.go equivalent):
            # tracing already bypasses memo caches, so the extra cost of
            # the stepped oracle path is confined to this debug surface
            from gatekeeper_tpu_torch.rego.trace import StepTracer
            step = StepTracer()
        for v in compiled.interp.query_set(
                "violation", input_doc, inv, tracer=tracer, step_tracer=step,
                shared_memo=None if trace is not None else shared):
            if not isinstance(v, Obj) or "msg" not in v:
                continue  # regolib accesses r.msg; absent msg -> no response
            details = v["details"] if "details" in v else Obj()
            yield Result(
                msg=v["msg"] if isinstance(v["msg"], str) else str(thaw(v["msg"])),
                metadata={"details": thaw(details)},
                constraint=constraint,
                review=review,
                enforcement_action=enforcement_action_of(constraint),
            )
        if trace is not None:
            cname = (constraint.get("metadata") or {}).get("name")
            for line in tracer or ():
                trace.append(f"[{compiled.kind}/{cname}] {line}")
            if step is not None and step.events:
                trace.append(f"[{compiled.kind}/{cname}] steps:")
                trace.extend(f"[{compiled.kind}/{cname}] {ln}"
                             for ln in step.pretty().splitlines())

    @locked_read
    def query_review(self, target: str, review: dict,
                     opts: QueryOpts | None = None) -> tuple[list[Result], str | None]:
        st = self._state(target)
        handler = self.targets[target]
        tracing = opts.tracing if opts is not None else self.default_tracing
        trace: list | None = [] if tracing else None
        results: list[Result] = []

        constraints = list(st.all_constraints())
        shed = opts.shed_actions if opts is not None else None
        if shed:
            # brownout: shed-action constraints skipped wholesale — no
            # matching, no autoreject, no evaluation (overload.py)
            constraints = [c for c in constraints
                           if enforcement_action_of(c) not in shed]
        # autoreject (regolib src.go:7-17)
        for c, msg, details in handler.autoreject_review(review, constraints, st.table):
            results.append(Result(msg=msg, metadata={"details": details},
                                  constraint=c, review=review,
                                  enforcement_action=enforcement_action_of(c)))
        frozen_review = freeze(review)
        shared: dict = {}    # one review, many constraints: share
        #                      review-pure comprehension results
        for c in handler.matching_constraints(review, constraints, st.table):
            compiled = st.templates.get(c.get("kind", ""))
            if compiled is None:
                continue
            if trace is not None:
                trace.append(f"eval {c.get('kind')}/{(c.get('metadata') or {}).get('name')} "
                             f"review={review.get('name')}")
            results.extend(self._eval_pair(st, target, compiled, review,
                                           frozen_review, c, trace, shared))
        return results, ("\n".join(trace) if trace is not None else None)

    @locked_read
    def query_audit(self, target: str,
                    opts: QueryOpts | None = None) -> tuple[list[Result], str | None]:
        """The audit cross-product (regolib src.go:38-52 +
        matching_reviews_and_constraints target.go:69-81): every cached
        resource × every constraint.  No autoreject in the audit hook."""
        st = self._state(target)
        handler = self.targets[target]
        tracing = opts.tracing if opts is not None else self.default_tracing
        trace: list | None = [] if tracing else None
        results: list[Result] = []
        constraints = list(st.all_constraints())
        for key, row in sorted(st.table.rows_items()):
            meta = st.table.meta_at(row)
            obj = st.table.object_at(row)
            if meta is None:
                continue
            review = handler.make_review(meta, obj)
            frozen_review = freeze(review)
            shared: dict = {}
            for c in handler.matching_constraints(review, constraints, st.table):
                compiled = st.templates.get(c.get("kind", ""))
                if compiled is None:
                    continue
                results.extend(self._eval_pair(st, target, compiled, review,
                                               frozen_review, c, trace,
                                               shared))
        return results, ("\n".join(trace) if trace is not None else None)

    @locked_read
    def dump(self) -> dict:
        """All templates + constraints + data (local.go:251-284).
        Deep-copied: the snapshot must stay consistent after the lock
        is released, not alias live driver state."""
        import copy
        out: dict = {}
        for tname, st in self.state.items():
            out[tname] = {
                "templates": {k: t.source for k, t in st.templates.items()},
                "constraints": copy.deepcopy(st.constraints),
                "data": copy.deepcopy(
                    {key: st.table.object_at(row)
                     for key, row in sorted(st.table.rows_items())}),
            }
        return out
