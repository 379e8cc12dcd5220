# Copied from gatekeeper_tpu/client/client.py for the PyTorch port.
"""The policy client — the façade every control-plane component calls.

Reference: vendor/.../constraint/pkg/client/client.go:24-47 (interface),
462-509 (init), 545-612 (Review/Audit).  Lifecycle and semantics follow
the reference: templates compile + register per target, constraints
validate against the generated CRD, data flows through target
ProcessData, Review/Audit fan out over targets and reconstruct violating
resources via HandleViolation.
"""

from __future__ import annotations

import os
import threading
from typing import Any

from gatekeeper_tpu_torch.api.templates import (
    CompiledTemplate, ConstraintTemplate, compile_target_rego)
from gatekeeper_tpu_torch.client.crd_helpers import (
    CONSTRAINT_GROUP, CONSTRAINT_VERSION, build_crd, validate_cr)
from gatekeeper_tpu_torch.client.interface import Driver, QueryOpts
from gatekeeper_tpu_torch.client.targets import TargetHandler, UnhandledData, WipeData
from gatekeeper_tpu_torch.client.types import Response, Responses
from gatekeeper_tpu_torch.errors import ClientError


class Client:
    def __init__(self, driver: Driver, targets: list[TargetHandler]):
        if not targets:
            raise ClientError("at least one target is required")
        self.driver = driver
        self.targets: dict[str, TargetHandler] = {}
        for t in targets:
            if t.name in self.targets:
                raise ClientError(f"duplicate target {t.name!r}")
            self.targets[t.name] = t
        # kind -> {target -> CompiledTemplate}; plus the generated CRD
        self.templates: dict[str, dict[str, CompiledTemplate]] = {}
        self.crds: dict[str, dict] = {}
        self.constraints: dict[str, dict[str, dict]] = {}
        # readers-writer, mirroring the reference client RWMutex
        # (client.go:545,584 — Review/Audit take RLock, mutations Lock):
        # concurrent admission reviews never serialize on each other
        from gatekeeper_tpu_torch.client.local_driver import RWLock
        self._lock = RWLock()
        driver.init(self.targets)

    # ------------------------------------------------------------------
    # templates (client.go:211-300)

    def _compile_template(self, tmpl: ConstraintTemplate):
        """(compiled_by_target, crd) for a template.  Multi-target
        templates compile per target (``spec.targets[]`` is plural in
        the CRD, constrainttemplate_types.go:27-98; the framework keys
        templates[target][Kind], client.go:211-213); the CRD's match
        schema comes from the first target, mirroring the reference's
        single-schema CRD build."""
        if not tmpl.targets:
            raise ClientError("template has no targets")
        compiled_by_target: dict[str, CompiledTemplate] = {}
        first_handler = None
        for tt in tmpl.targets:
            if tt.target in compiled_by_target:
                raise ClientError(f"duplicate target {tt.target!r}")
            handler = self.targets.get(tt.target)
            if handler is None:
                raise ClientError(f"unknown target {tt.target!r}")
            if first_handler is None:
                first_handler = handler
            # (the JAX package's warm-restart snapshot branch is not
            # part of the port yet: every template compiles cold)
            compiled = compile_target_rego(tmpl.kind, tt.target, tt.rego)
            # Stage-1 static vet (analysis/vetter.py): error findings
            # reject the template at ingestion, before anything is
            # registered.  providers=None here — the client has no
            # provider registry in scope (providers may legitimately be
            # registered after the template); the reconciler enforces
            # provider existence with the live set.
            from gatekeeper_tpu_torch.analysis import has_errors, vet_module
            diags = vet_module(compiled.module, providers=None,
                               file=tmpl.kind)
            if has_errors(diags):
                from gatekeeper_tpu_torch.errors import VetError
                raise VetError(diags)
            compiled_by_target[tt.target] = compiled
        return compiled_by_target, build_crd(tmpl, first_handler.match_schema())

    def create_crd(self, template_doc: dict) -> dict:
        """Validate the template and build its constraint CRD without
        registering anything (used by the webhook's synchronous template
        validation, policy.go:211-227)."""
        _, crd = self._compile_template(ConstraintTemplate.from_dict(template_doc))
        return crd

    def add_template(self, template_doc: dict) -> Responses:
        with self._lock.write():
            tmpl = ConstraintTemplate.from_dict(template_doc)
            compiled_by_target, crd = self._compile_template(tmpl)
            self.templates[tmpl.kind] = compiled_by_target
            self.crds[tmpl.kind] = crd
            self.constraints.setdefault(tmpl.kind, {})
            handled = {}
            for target, compiled in compiled_by_target.items():
                self.driver.put_template(target, tmpl.kind, compiled)
                handled[target] = True
            return Responses(handled=handled)

    def remove_template(self, template_doc: dict) -> Responses:
        with self._lock.write():
            tmpl = ConstraintTemplate.from_dict(template_doc)
            handled = {}
            targets = self.templates.pop(tmpl.kind, {})
            self.crds.pop(tmpl.kind, None)
            self.constraints.pop(tmpl.kind, None)
            for target in targets:
                self.driver.delete_template(target, tmpl.kind)
                handled[target] = True
            return Responses(handled=handled)

    # ------------------------------------------------------------------
    # constraints (client.go:340-432)

    def validate_constraint(self, constraint: dict) -> None:
        kind = constraint.get("kind", "")
        crd = self.crds.get(kind)
        if crd is None:
            raise ClientError(f"no template registered for constraint kind {kind!r}")
        validate_cr(constraint, crd)
        for target, handler in self.targets.items():
            if target in self.templates.get(kind, {}):
                handler.validate_constraint(constraint)

    def add_constraint(self, constraint: dict) -> Responses:
        with self._lock.write():
            self.validate_constraint(constraint)
            kind = constraint["kind"]
            name = constraint["metadata"]["name"]
            self.constraints.setdefault(kind, {})[name] = constraint
            handled = {}
            for target in self.templates.get(kind, {}):
                self.driver.put_constraint(target, kind, name, constraint)
                handled[target] = True
            return Responses(handled=handled)

    def remove_constraint(self, constraint: dict) -> Responses:
        with self._lock.write():
            kind = constraint.get("kind", "")
            name = (constraint.get("metadata") or {}).get("name", "")
            self.constraints.get(kind, {}).pop(name, None)
            handled = {}
            for target in self.templates.get(kind, {}):
                self.driver.delete_constraint(target, kind, name)
                handled[target] = True
            return Responses(handled=handled)

    # ------------------------------------------------------------------
    # data (client.go:152-209)

    def add_data(self, obj: Any) -> Responses:
        with self._lock.write():
            handled = {}
            for name, handler in self.targets.items():
                if isinstance(obj, WipeData) or obj is WipeData:
                    self.driver.wipe_data(name)
                    handled[name] = True
                    continue
                try:
                    key, meta, doc = handler.process_data(obj)
                except UnhandledData:
                    continue
                self.driver.put_data(name, key, meta, doc)
                handled[name] = True
            return Responses(handled=handled)

    def add_data_batch(self, objs: list) -> Responses:
        """Bulk AddData: one lock acquisition + one driver batch write
        per target for the whole list.  Semantically identical to
        looping add_data (same paths, same per-object UnhandledData
        skips); the reference has no batch AddData because its informer
        delivers events singly — but its initial list-sync is exactly a
        batch, and at 1M objects per-call overhead dominates."""
        import gc
        with self._lock.write():
            # cyclic-GC passes during the bulk loop traverse the whole
            # (million-object) resource graph repeatedly; pause
            # collection for the bounded duration of the batch (~30%
            # of 1M-object ingest time)
            gc_was_enabled = gc.isenabled()
            gc.disable()
            try:
                handled = {}
                any_wipe = any(isinstance(o, WipeData) or o is WipeData
                               for o in objs)
                for name, handler in self.targets.items():
                    batch_fn = getattr(handler, "process_data_batch", None)
                    if batch_fn is not None and not any_wipe:
                        # wipe-free batches (the overwhelmingly common
                        # case) take the target's native batch extractor
                        entries = [e for e in batch_fn(objs)
                                   if e is not None]
                        if entries:
                            self.driver.put_data_batch(name, entries)
                            handled[name] = True
                        continue
                    entries: list = []

                    def flush():
                        if entries:
                            self.driver.put_data_batch(name, entries)
                            entries.clear()
                            handled[name] = True

                    for obj in objs:
                        if isinstance(obj, WipeData) or obj is WipeData:
                            # order matters: objects queued BEFORE the
                            # wipe must land before it (and be wiped),
                            # exactly as the looped form behaves
                            flush()
                            self.driver.wipe_data(name)
                            handled[name] = True
                            continue
                        try:
                            entries.append(handler.process_data(obj))
                        except UnhandledData:
                            continue
                    flush()
                return Responses(handled=handled)
            finally:
                if len(objs) >= 65536 and \
                        os.environ.get("GATEKEEPER_NO_GC_FREEZE") != "1":
                    # a million-object resource cache makes every later
                    # cyclic-GC pass traverse the whole graph (~4s per
                    # large allocation burst).  The cache is long-lived
                    # and acyclic (parsed JSON), so move the current
                    # heap to GC's permanent generation — refcounting
                    # still reclaims it; only cycle *detection* skips it.
                    # Young-generation collect only: a full pass would
                    # itself traverse the million objects we are about
                    # to freeze (~3.5s at 1M for nothing)
                    gc.collect(1)
                    gc.freeze()
                if gc_was_enabled:
                    gc.enable()

    def remove_data(self, obj: Any) -> Responses:
        with self._lock.write():
            handled = {}
            for name, handler in self.targets.items():
                if isinstance(obj, WipeData) or obj is WipeData:
                    self.driver.wipe_data(name)
                    handled[name] = True
                    continue
                try:
                    key, _, _ = handler.process_data(obj)
                except UnhandledData:
                    continue
                self.driver.delete_data(name, key)
                handled[name] = True
            return Responses(handled=handled)

    # ------------------------------------------------------------------
    # queries (client.go:545-612)

    def review(self, obj: Any, tracing: bool = False,
               shed_actions: frozenset[str] | None = None) -> Responses:
        # queries take the READ side (client.go:545 RLock): concurrent
        # admission reviews proceed in parallel, excluded only by
        # mutations
        with self._lock.read():
            return self._review_locked(obj, tracing, shed_actions)

    def _review_locked(self, obj: Any, tracing: bool,
                       shed_actions: frozenset[str] | None = None
                       ) -> Responses:
        responses = Responses()
        for name, handler in self.targets.items():
            try:
                review = handler.handle_review(obj)
            except UnhandledData:
                continue
            results, trace = self.driver.query_review(
                name, review, QueryOpts(tracing=tracing,
                                        shed_actions=shed_actions))
            for r in results:
                handler.handle_violation(r)
            responses.by_target[name] = Response(
                target=name, results=results, trace=trace,
                input={"review": review} if tracing else None)
            responses.handled[name] = True
        return responses

    def review_batch(self, objs: list, tracing: bool = False,
                     shed_actions: frozenset[str] | None = None
                     ) -> list[Responses]:
        """Review a micro-batch under one read-lock acquisition /
        constraint snapshot (the webhook batcher's engine pass).

        When the driver exposes ``query_review_batch`` (the jax driver's
        [B, C] device pass, SURVEY §7 step 7) the whole batch is
        evaluated as one matrix per target; otherwise per-review scalar
        queries run under the shared snapshot.  ``shed_actions`` is the
        brownout controller's shed set — those enforcement actions are
        skipped before any evaluation (webhook/overload.py)."""
        with self._lock.read():
            if tracing:
                return [self._review_locked(obj, tracing, shed_actions)
                        for obj in objs]
            batched = self.driver.query_review_batch
            responses = [Responses() for _ in objs]
            for name, handler in self.targets.items():
                idx: list[int] = []
                reviews: list = []
                for i, obj in enumerate(objs):
                    try:
                        reviews.append(handler.handle_review(obj))
                        idx.append(i)
                    except UnhandledData:
                        continue
                if not reviews:
                    continue
                outs = batched(name, reviews,
                               QueryOpts(tracing=False,
                                         shed_actions=shed_actions))
                for i, (results, trace) in zip(idx, outs):
                    for r in results:
                        handler.handle_violation(r)
                    responses[i].by_target[name] = Response(
                        target=name, results=results, trace=trace)
                    responses[i].handled[name] = True
            return responses

    def predict_review_seconds(self, n_reviews: int) -> float | None:
        """Cost-model-predicted seconds to evaluate a review batch of
        ``n_reviews`` (summed over targets).  None when the driver has
        no predictor or the model is uncalibrated — the batcher treats
        None as "no opinion" and never sheds on it."""
        fn = getattr(self.driver, "predict_review_batch_seconds", None)
        if fn is None:
            return None
        total: float | None = None
        for name in self.targets:
            pred = fn(name, n_reviews)
            if pred is not None:
                total = pred if total is None else total + pred
        return total

    def certified_review_rungs(self, max_n: int | None = None
                               ) -> list[int] | None:
        """Batch sizes inside every target's Stage-7 certified compile
        surface (the micro-batcher's deadline-shrink ladder), or None
        when any target lacks a fully certified surface — the batcher
        then falls back to blind halving."""
        fn = getattr(self.driver, "certified_review_rungs", None)
        if fn is None:
            return None
        out: set[int] | None = None
        for name in self.targets:
            rungs = fn(name, max_n)
            if rungs is None:
                return None
            out = set(rungs) if out is None else out & set(rungs)
        return sorted(out) if out else None

    def prefetch_external(self, objs: list) -> None:
        """Warm the external-data provider caches for a micro-batch
        ahead of evaluation (the webhook batcher wires this in): one
        batched fetch round per provider covering every key any review
        in the batch will look up.  Best-effort and a no-op on drivers
        without the prefetch surface."""
        fn = getattr(self.driver, "prefetch_external_for_reviews", None)
        if fn is None:
            return
        with self._lock.read():
            for name, handler in self.targets.items():
                reviews: list = []
                for obj in objs:
                    try:
                        reviews.append(handler.handle_review(obj))
                    except UnhandledData:
                        continue
                if reviews:
                    fn(name, reviews)

    def audit(self, tracing: bool = False,
              limit_per_constraint: int | None = None,
              full: bool = False) -> Responses:
        """Full cross-product audit.  ``limit_per_constraint`` pushes the
        audit manager's violations cap (reference manager.go:35) down to
        the driver, where the jax engine turns it into a device top-k
        instead of formatting everything and truncating on the host.
        ``full=True`` defeats the driver's sweep memoization (mask /
        bindings / format caches) so the sweep measures a genuine
        re-preparation + re-upload + re-evaluation of every pair."""
        with self._lock.read():
            return self._audit_locked(tracing, limit_per_constraint, full)

    def _audit_locked(self, tracing: bool,
                      limit_per_constraint: int | None = None,
                      full: bool = False) -> Responses:
        responses = Responses()
        for name, handler in self.targets.items():
            results, trace = self.driver.query_audit(
                name, QueryOpts(tracing=tracing,
                                limit_per_constraint=limit_per_constraint,
                                full=full))
            for r in results:
                handler.handle_violation(r)
            responses.by_target[name] = Response(target=name, results=results,
                                                 trace=trace)
            responses.handled[name] = True
        return responses

    # ------------------------------------------------------------------
    # continuous enforcement (enforce/reactor.py rides these)

    def react(self, kind: str | None = None) -> dict | None:
        """Fold the store's dirty pages for one resource ``kind`` (or
        all kinds when None) into the verdict ledger — the reactor's
        rung 1: a single-object event becomes a single-page re-eval
        with no sweep in between.  Reader lock, like audit: the table
        is not mutated, the ledger has its own lock.  No-op (None) on
        drivers without the paged surface or with pages off."""
        fn = getattr(self.driver, "react_kind", None)
        if fn is None:
            return None
        with self._lock.read():
            out: dict | None = None
            for name in self.targets:
                r = fn(name, kind)
                if r is not None:
                    out = r if out is None else {
                        k: out.get(k, 0) + v for k, v in r.items()}
            return out

    def resync(self, kind: str | None = None) -> dict | None:
        """Force a whole-kind diff re-apply against the existing ledger
        entry (rungs 2/3): the entry is marked cold but keeps its rows,
        so the rebuild emits exactly the true appear/clear diff — a
        clean resync is event-free, never a phantom storm."""
        fn = getattr(self.driver, "resync_kind", None)
        if fn is None:
            return None
        with self._lock.read():
            out: dict | None = None
            for name in self.targets:
                r = fn(name, kind)
                if r is not None:
                    out = r if out is None else {
                        k: out.get(k, 0) + v for k, v in r.items()}
            return out

    def sync_kind(self, api_version: str, kind: str, objs: list) -> int:
        """Replace the store's residents of one (apiVersion, kind) with
        ``objs`` — the relist half of a rung-2 resync.  Listed objects
        are upserted; residents absent from the list are removed.
        Returns the number of stale residents deleted."""
        removed = 0
        with self._lock.write():
            residents = getattr(self.driver, "kind_residents", None)
            for name, handler in self.targets.items():
                live_keys = set()
                for obj in objs:
                    try:
                        key, meta, doc = handler.process_data(obj)
                    except UnhandledData:
                        continue
                    live_keys.add(key)
                    self.driver.put_data(name, key, meta, doc)
                if residents is None:
                    continue
                for key in residents(name, api_version, kind):
                    if key not in live_keys:
                        self.driver.delete_data(name, key)
                        removed += 1
        return removed

    def reset(self) -> None:
        with self._lock.write():
            for kind, targets in list(self.templates.items()):
                for target in targets:
                    self.driver.delete_template(target, kind)
            for name in self.targets:
                self.driver.wipe_data(name)
            self.templates.clear()
            self.crds.clear()
            self.constraints.clear()

    def dump(self) -> dict:
        return self.driver.dump()


class Backend:
    """One-client-per-backend guard (backend.go:10-67)."""

    def __init__(self, driver: Driver):
        self.driver = driver
        self._has_client = False

    def new_client(self, targets: list[TargetHandler]) -> Client:
        if self._has_client:
            raise ClientError("only one client per backend is allowed")
        self._has_client = True
        return Client(self.driver, targets)
