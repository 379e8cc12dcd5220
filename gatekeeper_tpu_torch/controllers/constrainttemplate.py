# Copied from gatekeeper_tpu/controllers/constrainttemplate.py for the PyTorch port.
"""ConstraintTemplate reconciler.

Reference: pkg/controller/constrainttemplate/constrainttemplate_controller.go:124-331.
Lifecycle: validate + build the constraint-kind CRD (CreateCRD), record
parse errors in ``status.byPod[].errors``, load the template into the
engine (AddTemplate), register the constraint kind with the watch
registrar, create/update the CRD object in-cluster, and on delete tear
all of that down behind a finalizer with requeue-based deadlock
recovery.

Deviation (fixes a reference bug): a terminating template whose Rego no
longer compiles still tears down — the reference returns after the
CreateCRD error and would leak the finalizer forever; here deletion
proceeds with the CRD identity derived from the template kind alone.

Translation-validation, footprint and shardplan statuses read the
port's own ``analysis/transval.py``, ``analysis/footprint.py`` and
``analysis/shardplan.py``.
"""

from __future__ import annotations

from gatekeeper_tpu_torch.api.config import GVK
from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.cluster.fake import FakeCluster
from gatekeeper_tpu_torch.controllers.runtime import (DONE, REQUEUE, ReconcileResult,
                                                Reconciler, Request)
from gatekeeper_tpu_torch.errors import (AlreadyExistsError, ApiConflictError,
                                   ClientError, NotFoundError, RegoError)
from gatekeeper_tpu_torch.utils.finalizers import (add_finalizer, has_finalizer,
                                             strip_finalizer)
from gatekeeper_tpu_torch.utils.ha_status import get_ha_status, set_ha_status
from gatekeeper_tpu_torch.watch.manager import Registrar

TEMPLATE_GVK = GVK("templates.gatekeeper.sh", "v1alpha1", "ConstraintTemplate")
CRD_GVK = GVK("apiextensions.k8s.io", "v1beta1", "CustomResourceDefinition")
CRD_V1_GVK = GVK("apiextensions.k8s.io", "v1", "CustomResourceDefinition")


def crd_try_get(cluster, name: str):
    """Look the constraint CRD up under either apiextensions version
    (v1-first real clusters store it under v1)."""
    found = cluster.try_get(CRD_GVK, name)
    if found is None:
        found = cluster.try_get(CRD_V1_GVK, name)
    return found


def crd_create(cluster, crd: dict) -> None:
    """Create the constraint CRD, converting to apiextensions v1 when
    the apiserver no longer serves v1beta1 (k8s >= 1.22).  Stamps the
    spec-hash annotation so the first reconcile after create sees the
    object as up to date (see _crd_up_to_date)."""
    from gatekeeper_tpu_torch.client.crd_helpers import crd_to_v1
    def stamped(doc: dict) -> dict:
        doc = dict(doc)
        md = dict(doc.get("metadata") or {})
        anns = dict(md.get("annotations") or {})
        anns[SPEC_HASH_ANNOTATION] = _spec_hash(doc.get("spec"))
        md["annotations"] = anns
        doc["metadata"] = md
        return doc
    try:
        cluster.create(stamped(crd))
    except NotFoundError:
        v1 = crd_to_v1(crd)
        cluster.create(stamped(v1))


def crd_delete(cluster, name: str) -> None:
    try:
        cluster.delete(CRD_GVK, name)
    except NotFoundError:
        cluster.delete(CRD_V1_GVK, name)


CONSTRAINT_GROUP = "constraints.gatekeeper.sh"
FINALIZER = "constrainttemplate.finalizers.gatekeeper.sh"


def make_constraint_gvk(kind: str) -> GVK:
    """makeGvk (:306-312): constraints are always
    constraints.gatekeeper.sh/v1alpha1/<Kind>."""
    return GVK(CONSTRAINT_GROUP, "v1alpha1", kind)


SPEC_HASH_ANNOTATION = "gatekeeper.sh/spec-hash"


def _spec_hash(spec) -> str:
    import hashlib
    import json
    return hashlib.sha256(
        json.dumps(spec, sort_keys=True, default=str).encode()).hexdigest()


def _crd_up_to_date(crd: dict, found: dict) -> bool:
    """Whether the stored constraint CRD already reflects our generated
    spec.  A real apiserver defaults fields crd_to_v1 never emits
    (names.listKind, conversion strategy, schema normalization), so
    plain spec equality would fail every reconcile and issue a no-op
    update per pass — perpetual churn.  Instead the update path stamps
    a hash of the spec *we wrote* as an annotation; defaults never
    touch annotations, and any template edit (including pure field
    removals) changes the hash."""
    anns = (found.get("metadata") or {}).get("annotations") or {}
    return anns.get(SPEC_HASH_ANNOTATION) == _spec_hash(crd.get("spec"))


def _error_entries(err: Exception) -> list[dict]:
    """status.byPod[].errors entries for a rejected template.  A
    VetError carries the whole diagnostic list — every error-severity
    finding gets its own entry, matching the reference's per-error
    rows; other errors keep the single-entry shape."""
    from gatekeeper_tpu_torch.errors import VetError
    if isinstance(err, VetError):
        return [{"code": d.code, "message": d.message,
                 "location": str(d.location)}
                for d in err.diagnostics if d.severity == "error"]
    entry = {"code": getattr(err, "code", "create_error"),
             "message": getattr(err, "message", str(err))}
    loc = getattr(err, "location", None)
    if loc is not None:
        entry["location"] = str(loc)
    return [entry]


def _template_kind(instance: dict) -> str:
    spec = instance.get("spec") or {}
    names = (((spec.get("crd") or {}).get("spec") or {}).get("names") or {})
    return names.get("kind", "")


class ReconcileConstraintTemplate(Reconciler):
    name = "constrainttemplate-controller"

    def __init__(self, cluster: FakeCluster, client: Client,
                 watcher: Registrar):
        self.cluster = cluster
        self.client = client
        self.watcher = watcher

    def reconcile(self, request: Request) -> ReconcileResult:
        instance = self.cluster.try_get(TEMPLATE_GVK, request.name)
        if instance is None:
            return DONE
        terminating = bool((instance.get("metadata") or {})
                           .get("deletionTimestamp"))

        status = get_ha_status(instance)
        status.pop("errors", None)
        status.pop("warnings", None)
        try:
            crd = self.client.create_crd(instance)
            # full static vet with the LIVE provider set: create_crd
            # already ran the structural vet (providers unknown at the
            # client); here dangling external_data references become
            # install-time rejections.  Warnings are recorded but admit.
            self._vet_instance(instance, status)
        except (RegoError, ClientError) as err:
            if terminating:
                # tear down anyway: CRD identity from the kind alone
                kind = _template_kind(instance)
                crd = {"metadata": {
                    "name": f"{kind.lower()}.{CONSTRAINT_GROUP}"}}
                return self._handle_delete(instance, crd)
            # parse/validation errors land in status.byPod[].errors
            # (:143-158) and the template is otherwise left alone; a
            # VetError expands to one entry per error-severity finding
            status.setdefault("errors", []).extend(_error_entries(err))
            set_ha_status(instance, status)
            _, result = self._update(instance)
            return result
        set_ha_status(instance, status)

        if terminating:
            return self._handle_delete(instance, crd)
        crd_name = (crd.get("metadata") or {}).get("name", "")
        found = crd_try_get(self.cluster, crd_name)
        if found is None:
            return self._handle_create(instance, crd)
        return self._handle_update(instance, crd, found)

    # ------------------------------------------------------------------

    def _handle_create(self, instance: dict, crd: dict) -> ReconcileResult:
        """:184-230 handleCreate."""
        if add_finalizer(instance, FINALIZER):
            instance, result = self._update(instance)
            if instance is None:
                return result
        if not self._add_template(instance):
            return DONE
        self._transval_status(instance)
        self._footprint_status(instance)
        self._shardplan_status(instance)
        self.watcher.add_watch(make_constraint_gvk(_template_kind(instance)))
        try:
            crd_create(self.cluster, crd)
        except AlreadyExistsError:
            pass  # another replica won the create race (HA note at :210)
        instance.setdefault("status", {})["created"] = True
        _, result = self._update(instance)
        return result

    def _handle_update(self, instance: dict, crd: dict,
                       found: dict) -> ReconcileResult:
        """:233-266 handleUpdate: engine reload is unconditional (the
        engine may have restarted and needs code re-loaded)."""
        if not self._add_template(instance):
            return DONE
        self._transval_status(instance)
        self._footprint_status(instance)
        self._shardplan_status(instance)
        self.watcher.add_watch(make_constraint_gvk(_template_kind(instance)))
        if found.get("apiVersion") == "apiextensions.k8s.io/v1":
            # compare/update in the stored object's shape, not ours
            from gatekeeper_tpu_torch.client.crd_helpers import crd_to_v1
            crd = crd_to_v1(crd)
        if not _crd_up_to_date(crd, found):
            found["spec"] = crd["spec"]
            found.setdefault("metadata", {}).setdefault(
                "annotations", {})[SPEC_HASH_ANNOTATION] = \
                _spec_hash(crd.get("spec"))
            try:
                self.cluster.update(found)
            except ApiConflictError:
                return REQUEUE
        instance.setdefault("status", {})["created"] = True
        _, result = self._update(instance)
        return result

    def _handle_delete(self, instance: dict, crd: dict) -> ReconcileResult:
        """:269-304 handleDelete: CRD delete → wait for it to vanish
        (re-adding the watch first recovers an offline finalizer
        deadlock) → remove watch → remove template → drop finalizer."""
        if not has_finalizer(instance, FINALIZER):
            return DONE
        crd_name = (crd.get("metadata") or {}).get("name", "")
        try:
            crd_delete(self.cluster, crd_name)
        except NotFoundError:
            pass
        if crd_try_get(self.cluster, crd_name) is not None:
            # child CRD not gone yet (constraints still finalizing):
            # keep their watch alive and requeue
            self.watcher.add_watch(make_constraint_gvk(_template_kind(instance)))
            return REQUEUE
        self.watcher.remove_watch(make_constraint_gvk(_template_kind(instance)))
        self.client.remove_template(instance)
        strip_finalizer(instance, FINALIZER)
        _, result = self._update(instance)
        return result

    # ------------------------------------------------------------------

    def _vet_instance(self, instance: dict, status: dict) -> None:
        """Run the Stage-1 vetter over every target's Rego with the
        live external-data provider set.  Error findings raise VetError
        (rejecting the template before it reaches the engine); warning
        findings land in ``status.byPod[].warnings``.  When no
        ExternalDataRuntime exists the provider-existence check is
        skipped — the subsystem is disabled, not misconfigured."""
        from gatekeeper_tpu_torch.analysis import has_errors, vet_module
        from gatekeeper_tpu_torch.errors import VetError
        from gatekeeper_tpu_torch.externaldata.runtime import get_runtime
        from gatekeeper_tpu_torch.rego.parser import parse_module

        rt = get_runtime()
        providers = set(rt.provider_names()) if rt is not None else None
        kind = _template_kind(instance)
        diags = []
        for tt in ((instance.get("spec") or {}).get("targets") or ()):
            rego = tt.get("rego") or ""
            diags.extend(vet_module(parse_module(rego),
                                    providers=providers, file=kind))
        if has_errors(diags):
            raise VetError(diags)
        for d in diags:
            status.setdefault("warnings", []).append(
                {"code": d.code, "message": d.message,
                 "location": str(d.location)})
        self._policyset_vet(instance, kind, status)

    def _policyset_vet(self, instance: dict, kind: str,
                       status: dict) -> None:
        """Stage-3 policy-set vet (analysis/policyset.py): price the
        lowered program against the static cost budget (strict mode
        raises VetError, rejecting the template) and flag predicate
        subprograms already installed under another template
        (``set_duplicate_predicate`` — informational; the audit sweep
        dedups them).  Scalar-fallback templates have no lowered
        program and no device cost to gate."""
        from gatekeeper_tpu_torch.analysis import costmodel, has_errors
        from gatekeeper_tpu_torch.analysis.policyset import (
            dfa_subset_warnings, duplicate_predicate_warnings,
            vet_template_cost)
        from gatekeeper_tpu_torch.errors import VetError

        lowered = self._lower_instance(instance)
        if lowered is None:
            return
        diags = vet_template_cost(lowered, kind)
        # regex_off_dfa: constant patterns this template matches through
        # host lookup tables instead of the in-program DFA, and why
        diags.extend(dfa_subset_warnings(kind, lowered))
        others = {}
        for st in (getattr(self.client.driver, "state", None) or {}).values():
            for okind, compiled in getattr(st, "templates", {}).items():
                low = getattr(compiled, "vectorized", None)
                if low is not None and okind != kind:
                    others[okind] = low
        diags.extend(duplicate_predicate_warnings(kind, lowered, others))
        if has_errors(diags):
            raise VetError(diags)
        for d in diags:
            status.setdefault("warnings", []).append(
                {"code": d.code, "message": d.message,
                 "location": str(d.location)})
        metrics = getattr(self.client.driver, "metrics", None)
        if metrics is not None:
            cv = costmodel.estimate(lowered, costmodel.REF_ROWS, 1)
            metrics.gauge(f"template_cost_units_{kind}").set(cv.units())

    def _transval_status(self, instance: dict) -> None:
        """Stage-4 surface: when strict translation validation
        (GATEKEEPER_TRANSVAL=strict, analysis/transval.py) found a
        counterexample during AddTemplate, the engine already pinned
        the template to the scalar fallback; record
        ``translation_unvalidated`` in ``status.byPod[].errors`` so the
        operator sees *why* the device path is off.  Unlike VetError
        this does not reject — the scalar oracle serves the template
        with reference semantics."""
        from gatekeeper_tpu_torch.analysis import transval
        if transval.mode() != "strict":
            return
        ce = transval.failure_for(_template_kind(instance))
        if ce is None:
            return
        status = get_ha_status(instance)
        status.setdefault("errors", []).append(
            {"code": "translation_unvalidated",
             "message": (f"lowered program failed translation validation "
                         f"({ce.note}; oracle={ce.expected} "
                         f"device={ce.actual}); pinned to the scalar "
                         "fallback")})
        set_ha_status(instance, status)

    def _footprint_status(self, instance: dict) -> None:
        """Stage-5 surface (analysis/footprint.py): templates whose
        lowered program is NOT row-local — the verdict for row *i*
        reads other rows' columns (inventory joins, aggregations) —
        get a ``cross_row_dependency`` warning in
        ``status.byPod[].warnings``: they are ineligible for
        resource-axis shard_map and are excluded from footprint-driven
        selective invalidation (any churn re-evaluates them).
        Informational, never rejects — cross-row semantics are valid,
        just unshardable."""
        from gatekeeper_tpu_torch.analysis import footprint
        if footprint.mode() == "off":
            return
        reason = footprint.locality_for(_template_kind(instance))
        if reason is None:
            return
        status = get_ha_status(instance)
        status.setdefault("warnings", []).append(
            {"code": "cross_row_dependency",
             "message": (f"verdict is not row-local ({reason}); "
                         "shard_map ineligible, selective invalidation "
                         "disabled for this template")})
        set_ha_status(instance, status)

    def _shardplan_status(self, instance: dict) -> None:
        """Stage-6 surface (analysis/shardplan.py): templates whose
        partition plan is shard-INELIGIBLE (cross-row verdicts, or a
        binding with no known shard layout) get a ``shard_ineligible``
        warning in ``status.byPod[].warnings``: under
        ``GATEKEEPER_SHARDS=N`` they pin to the replicated path.
        Informational, never rejects — the replicated path is always
        correct, sharding is a performance contract."""
        from gatekeeper_tpu_torch.analysis import shardplan
        if shardplan.mode() == "off":
            return
        reason = shardplan.ineligible_for(_template_kind(instance))
        if reason is None:
            return
        status = get_ha_status(instance)
        status.setdefault("warnings", []).append(
            {"code": "shard_ineligible",
             "message": (f"no resource-axis partition plan ({reason}); "
                         "pinned to the replicated path under "
                         "GATEKEEPER_SHARDS")})
        set_ha_status(instance, status)

    @staticmethod
    def _lower_instance(instance: dict):
        """Lowered device program of a template doc, or None when it
        takes the scalar fallback (CannotLower) or fails to compile —
        compile errors are the Stage-1 vet's job, not this pass's."""
        from gatekeeper_tpu_torch.api.templates import compile_target_rego
        from gatekeeper_tpu_torch.ir.lower import CannotLower, lower_template
        kind = _template_kind(instance)
        for tt in ((instance.get("spec") or {}).get("targets") or ()):
            try:
                compiled = compile_target_rego(
                    kind, tt.get("target", ""), tt.get("rego") or "")
                return lower_template(compiled.module, compiled.interp)
            except CannotLower:
                return None
            except Exception:
                return None
        return None

    def _add_template(self, instance: dict) -> bool:
        """AddTemplate with update_error status reporting (:198-205)."""
        try:
            self.client.add_template(instance)
            return True
        except (RegoError, ClientError) as err:
            status = get_ha_status(instance)
            status.setdefault("errors", []).append(
                {"code": "update_error",
                 "message": f"Could not update CRD: {err}"})
            set_ha_status(instance, status)
            self._update(instance)
            return False

    def _update(self, instance: dict) -> tuple[dict | None, ReconcileResult]:
        """Persist; returns (updated object | None, result).  The caller
        must continue with the returned object — the stored
        resourceVersion advances on success."""
        try:
            return self.cluster.update(instance), DONE
        except ApiConflictError:
            return None, REQUEUE
        except NotFoundError:
            return None, DONE
