"""The port's control plane against the reference: the flows of
tests/test_control_plane.py on the port's FakeCluster, watch manager and
controllers (the port's LocalDriver and TorchDriver(device="cpu")), and
the cluster objects both control planes leave after the same writes
(JaxDriver on the CPU for the reference), equal field for field with
only timestamps masked.
"""

import copy
import glob
import os

import pytest
import yaml

from gatekeeper_tpu_torch.api.config import GVK, empty_config_object
from gatekeeper_tpu_torch.client.client import Backend
from gatekeeper_tpu_torch.client.local_driver import LocalDriver
from gatekeeper_tpu_torch.cluster.fake import (ADDED, DELETED, MODIFIED,
                                               FakeCluster)
from gatekeeper_tpu_torch.controllers.config import CONFIG_GVK
from gatekeeper_tpu_torch.controllers.constrainttemplate import (
    CRD_GVK, TEMPLATE_GVK)
from gatekeeper_tpu_torch.controllers.registry import add_to_manager
from gatekeeper_tpu_torch.controllers.runtime import ControllerManager
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.library import LIBRARY, constraint_doc, template_doc
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.errors import (AlreadyExistsError,
                                         ApiConflictError, NotFoundError)
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
from gatekeeper_tpu_torch.utils.ha_status import get_ha_status, set_ha_status
from gatekeeper_tpu_torch.watch.manager import WatchManager
from tests.test_control_plane import constraint_obj, ns_obj, template_obj

NS_GVK = GVK("", "v1", "Namespace")

# ---------------------------------------------------------------------------
# fake cluster semantics


class TestFakeCluster:
    def test_crud_roundtrip(self):
        c = FakeCluster()
        c.create(ns_obj("a", {"x": "1"}))
        got = c.get(NS_GVK, "a")
        assert got["metadata"]["labels"] == {"x": "1"}
        assert got["metadata"]["resourceVersion"]
        with pytest.raises(AlreadyExistsError):
            c.create(ns_obj("a"))
        with pytest.raises(NotFoundError):
            c.get(NS_GVK, "zzz")

    def test_update_conflict_and_noop(self):
        c = FakeCluster()
        created = c.create(ns_obj("a"))
        stale = dict(created)
        fresh = c.update({**created, "metadata": {
            **created["metadata"], "labels": {"k": "v"}}})
        assert fresh["metadata"]["resourceVersion"] != \
            created["metadata"]["resourceVersion"]
        with pytest.raises(ApiConflictError):
            c.update({**stale, "metadata": {**stale["metadata"],
                                            "labels": {"other": "w"}}})
        # no-op update: same content -> same resourceVersion, no event
        events = []
        c.watch(NS_GVK, events.append)
        again = c.update(fresh)
        assert again["metadata"]["resourceVersion"] == \
            fresh["metadata"]["resourceVersion"]
        assert events == []

    def test_finalizer_semantics(self):
        c = FakeCluster()
        obj = ns_obj("a")
        obj["metadata"]["finalizers"] = ["f1"]
        c.create(obj)
        events = []
        c.watch(NS_GVK, events.append)
        c.delete(NS_GVK, "a")
        # finalizer present -> terminating, not deleted
        got = c.get(NS_GVK, "a")
        assert got["metadata"]["deletionTimestamp"]
        assert events[-1].type == MODIFIED
        # stripping the last finalizer removes the object
        got["metadata"]["finalizers"] = []
        c.update(got)
        assert events[-1].type == DELETED
        with pytest.raises(NotFoundError):
            c.get(NS_GVK, "a")

    def test_crd_registers_discovery(self):
        c = FakeCluster()
        with pytest.raises(NotFoundError):
            c.server_resources_for_group_version("constraints.gatekeeper.sh/v1alpha1")
        crd = {"apiVersion": "apiextensions.k8s.io/v1beta1",
               "kind": "CustomResourceDefinition",
               "metadata": {"name": "k8srequiredlabels.constraints.gatekeeper.sh"},
               "spec": {"group": "constraints.gatekeeper.sh",
                        "version": "v1alpha1",
                        "names": {"kind": "K8sRequiredLabels",
                                  "plural": "k8srequiredlabels"}}}
        c.create(crd)
        kinds = c.server_resources_for_group_version("constraints.gatekeeper.sh/v1alpha1")
        assert kinds == [{"kind": "K8sRequiredLabels",
                          "name": "k8srequiredlabels"}]
        assert c.kind_served(GVK("constraints.gatekeeper.sh", "v1alpha1",
                                 "K8sRequiredLabels"))
        c.delete(CRD_GVK, "k8srequiredlabels.constraints.gatekeeper.sh")
        with pytest.raises(NotFoundError):
            c.server_resources_for_group_version("constraints.gatekeeper.sh/v1alpha1")

    def test_watch_events(self):
        c = FakeCluster()
        events = []
        unsub = c.watch(NS_GVK, events.append)
        c.create(ns_obj("a"))
        assert [e.type for e in events] == [ADDED]
        unsub()
        c.create(ns_obj("b"))
        assert len(events) == 1


# ---------------------------------------------------------------------------
# ha_status


class TestHAStatus:
    def test_roundtrip_two_pods(self):
        obj = {}
        s1 = get_ha_status(obj, "pod-1")
        assert s1 == {"id": "pod-1"}
        s1["enforced"] = True
        set_ha_status(obj, s1, "pod-1")
        set_ha_status(obj, {"enforced": False}, "pod-2")
        assert get_ha_status(obj, "pod-1")["enforced"] is True
        assert get_ha_status(obj, "pod-2")["enforced"] is False
        # replace keeps one slot per pod
        set_ha_status(obj, {"enforced": False}, "pod-1")
        by_pod = obj["status"]["byPod"]
        assert [s["id"] for s in by_pod] == ["pod-1", "pod-2"]
        assert get_ha_status(obj, "pod-1")["enforced"] is False


# ---------------------------------------------------------------------------
# watch manager


def make_client(driver=None):
    driver = driver or LocalDriver()
    return Backend(driver).new_client([K8sValidationTarget()])


class TestWatchManager:
    def test_roster_and_pending(self):
        cluster = FakeCluster()
        mgr = ControllerManager(cluster)
        wm = WatchManager(cluster, mgr)
        seen = []

        class Rec:
            name = "rec"

            def __init__(self, gvk):
                self.gvk = gvk

            def reconcile(self, request):
                seen.append((self.gvk.kind, request.name))
                from gatekeeper_tpu_torch.controllers.runtime import DONE
                return DONE

        reg = wm.new_registrar("r", Rec)
        gvk = GVK("g.example.com", "v1", "Widget")
        reg.add_watch(gvk)
        # not served by discovery yet -> pending
        assert wm.pending_gvks() == {gvk}
        assert wm.watched_gvks() == set()
        cluster.register_kind(gvk, "widgets")
        cluster.create({"apiVersion": "g.example.com/v1", "kind": "Widget",
                        "metadata": {"name": "w1"}})
        wm.poll_once()
        assert wm.watched_gvks() == {gvk}
        mgr.run_until_idle()
        assert ("Widget", "w1") in seen  # initial list replayed

        # replace to empty roster stops the watch
        reg.replace_watch([])
        assert wm.watched_gvks() == set()

    def test_pause_unpause_resyncs(self):
        cluster = FakeCluster()
        mgr = ControllerManager(cluster)
        wm = WatchManager(cluster, mgr)
        hits = []

        class Rec:
            name = "rec"

            def __init__(self, gvk):
                pass

            def reconcile(self, request):
                hits.append(request.name)
                from gatekeeper_tpu_torch.controllers.runtime import DONE
                return DONE

        reg = wm.new_registrar("r", Rec)
        gvk = GVK("", "v1", "Namespace")
        cluster.register_kind(gvk, "namespaces")
        cluster.create(ns_obj("a"))
        reg.add_watch(gvk)
        mgr.run_until_idle()
        assert hits == ["a"]
        wm.pause()
        cluster.create(ns_obj("b"))  # dropped while paused
        mgr.run_until_idle()
        assert hits == ["a"]
        wm.unpause()
        mgr.run_until_idle()
        assert sorted(hits[1:]) == ["a", "b"]  # resync re-lists everything


# ---------------------------------------------------------------------------
# controllers: the minimum end-to-end slice


@pytest.fixture(params=["local", "torch"])
def plane(request, monkeypatch):
    # small stores take the device path (the JAX conftest does the same
    # for JaxDriver)
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    cluster = FakeCluster()
    cluster.register_kind(TEMPLATE_GVK, "constrainttemplates")
    cluster.register_kind(CONFIG_GVK, "configs")
    cluster.register_kind(NS_GVK, "namespaces")
    driver = LocalDriver() if request.param == "local" \
        else TorchDriver(device="cpu")
    client = make_client(driver)
    return add_to_manager(cluster, client)


class TestControllersEndToEnd:
    def test_minimum_slice(self, plane):
        cluster, client = plane.cluster, plane.client

        # 1. Config with syncOnly [v1/Namespace] -> sync watch ingests
        cfg = empty_config_object()
        cfg["spec"] = {"sync": {"syncOnly": [
            {"group": "", "version": "v1", "kind": "Namespace"}]}}
        cluster.create(cfg)
        for i in range(10):
            labels = {"gatekeeper": "on"} if i % 2 else None
            cluster.create(ns_obj(f"ns{i}", labels))
        plane.run_until_idle()

        # namespaces got the sync finalizer and are cached in the engine
        ns0 = cluster.get(NS_GVK, "ns0")
        assert "finalizers.gatekeeper.sh/sync" in ns0["metadata"]["finalizers"]

        # 2. template -> engine + constraint CRD + discovery + watch
        cluster.create(template_obj())
        plane.run_until_idle()
        tmpl = cluster.get(TEMPLATE_GVK, "k8srequiredlabels")
        assert tmpl["status"]["created"] is True
        crd = cluster.get(CRD_GVK, "k8srequiredlabels.constraints.gatekeeper.sh")
        assert crd["spec"]["names"]["kind"] == "K8sRequiredLabels"
        con_gvk = GVK("constraints.gatekeeper.sh", "v1alpha1",
                      "K8sRequiredLabels")
        assert con_gvk in plane.watch_manager.watched_gvks()

        # 3. constraint -> engine, status enforced
        cluster.create(constraint_obj())
        plane.run_until_idle()
        con = cluster.get(con_gvk, "ns-must-have-gk")
        st = get_ha_status(con)
        assert st.get("enforced") is True

        # 4. audit matches the expected violations (5 unlabeled namespaces)
        resp = client.audit()
        results = resp.results()
        assert len(results) == 5
        assert {r.resource["metadata"]["name"] for r in results} == \
            {f"ns{i}" for i in range(10) if i % 2 == 0}
        assert all("you must provide labels" in r.msg for r in results)

        # 5. review path: a namespace without the label is denied
        req = {"kind": {"group": "", "version": "v1", "kind": "Namespace"},
               "operation": "CREATE", "name": "bad",
               "object": ns_obj("bad")}
        resp = client.review(req)
        assert len(resp.results()) == 1

        # 6. delete the template: CRD gone, engine cleared, finalizer freed
        cluster.delete(TEMPLATE_GVK, "k8srequiredlabels")
        plane.run_until_idle()
        assert cluster.try_get(TEMPLATE_GVK, "k8srequiredlabels") is None
        assert cluster.try_get(
            CRD_GVK, "k8srequiredlabels.constraints.gatekeeper.sh") is None
        assert client.audit().results() == []
        assert con_gvk not in plane.watch_manager.watched_gvks()

    def test_template_rego_error_lands_in_status(self, plane):
        cluster = plane.cluster
        bad = template_obj(rego="package foo\nthis is not rego")
        cluster.create(bad)
        plane.run_until_idle()
        tmpl = cluster.get(TEMPLATE_GVK, "k8srequiredlabels")
        errors = get_ha_status(tmpl).get("errors")
        assert errors and errors[0]["code"] == "rego_parse_error"
        assert not tmpl.get("status", {}).get("created")

    def test_config_change_wipes_and_cleans_finalizers(self, plane):
        cluster, client = plane.cluster, plane.client
        cfg = empty_config_object()
        cfg["spec"] = {"sync": {"syncOnly": [
            {"group": "", "version": "v1", "kind": "Namespace"}]}}
        cluster.create(cfg)
        cluster.create(ns_obj("a"))
        plane.run_until_idle()
        assert "finalizers.gatekeeper.sh/sync" in \
            cluster.get(NS_GVK, "a")["metadata"]["finalizers"]
        assert client.dump()["admission.k8s.gatekeeper.sh"]["data"]

        # drop Namespace from syncOnly -> data wiped + finalizers cleaned
        cfg = cluster.get(CONFIG_GVK, "config", "gatekeeper-system")
        cfg["spec"] = {"sync": {"syncOnly": []}}
        cluster.update(cfg)
        plane.run_until_idle()
        assert not cluster.get(NS_GVK, "a")["metadata"].get("finalizers")
        assert not client.dump()["admission.k8s.gatekeeper.sh"]["data"]
        cfg = cluster.get(CONFIG_GVK, "config", "gatekeeper-system")
        assert get_ha_status(cfg).get("allFinalizers") in ([], None)

    def test_constraint_delete_via_finalizer(self, plane):
        cluster, client = plane.cluster, plane.client
        cluster.create(template_obj())
        plane.run_until_idle()
        cluster.create(constraint_obj())
        plane.run_until_idle()
        con_gvk = GVK("constraints.gatekeeper.sh", "v1alpha1",
                      "K8sRequiredLabels")
        cluster.delete(con_gvk, "ns-must-have-gk")
        plane.run_until_idle()
        assert cluster.try_get(con_gvk, "ns-must-have-gk") is None
        # engine no longer has the constraint
        assert client.constraints.get("K8sRequiredLabels") == {}


# ---------------------------------------------------------------------------
# lifecycle deadlock regressions (round-2 code-review findings)


class TestLifecycleDeadlocks:
    def test_broken_template_still_deletable(self, plane):
        """A template whose Rego stops compiling must still tear down on
        delete (the reference leaks its finalizer in this case)."""
        cluster, client = plane.cluster, plane.client
        cluster.create(template_obj())
        plane.run_until_idle()
        assert "K8sRequiredLabels" in client.templates
        # break the rego in-place
        tmpl = cluster.get(TEMPLATE_GVK, "k8srequiredlabels")
        tmpl["spec"]["targets"][0]["rego"] = "package foo\nnot rego at all"
        cluster.update(tmpl)
        plane.run_until_idle()
        # now delete: finalizer must be released and everything torn down
        cluster.delete(TEMPLATE_GVK, "k8srequiredlabels")
        plane.run_until_idle()
        assert cluster.try_get(TEMPLATE_GVK, "k8srequiredlabels") is None
        assert cluster.try_get(
            CRD_GVK, "k8srequiredlabels.constraints.gatekeeper.sh") is None
        assert "K8sRequiredLabels" not in client.templates

    def test_template_delete_cascades_constraints(self, plane):
        """CRD delete cascades to constraints; their finalizers are
        stripped by the (still-watching) constraint reconciler before the
        CRD finishes terminating."""
        cluster, client = plane.cluster, plane.client
        cluster.create(template_obj())
        plane.run_until_idle()
        cluster.create(constraint_obj())
        plane.run_until_idle()
        con_gvk = GVK("constraints.gatekeeper.sh", "v1alpha1",
                      "K8sRequiredLabels")
        cluster.delete(TEMPLATE_GVK, "k8srequiredlabels")
        plane.run_until_idle()
        assert cluster.try_get(con_gvk, "ns-must-have-gk") is None
        assert cluster.try_get(TEMPLATE_GVK, "k8srequiredlabels") is None
        assert cluster.try_get(
            CRD_GVK, "k8srequiredlabels.constraints.gatekeeper.sh") is None
        assert client.constraints.get("K8sRequiredLabels") is None

    def test_config_delete_waits_for_cleanup(self, plane):
        """Config deletion must not release its own finalizer while sync
        finalizers remain (the durable allFinalizers record would die
        with the object)."""
        cluster = plane.cluster
        cfg = empty_config_object()
        cfg["spec"] = {"sync": {"syncOnly": [
            {"group": "", "version": "v1", "kind": "Namespace"}]}}
        cluster.create(cfg)
        cluster.create(ns_obj("a"))
        plane.run_until_idle()
        assert "finalizers.gatekeeper.sh/sync" in \
            cluster.get(NS_GVK, "a")["metadata"]["finalizers"]
        # fail the first cleanup attempt, then delete the config
        cluster.inject_update_failures(1)
        cluster.delete(CONFIG_GVK, "config", "gatekeeper-system")
        plane.run_until_idle()
        # the retry succeeded: namespace finalizer stripped, config gone
        assert not cluster.get(NS_GVK, "a")["metadata"].get("finalizers")
        assert cluster.try_get(CONFIG_GVK, "config",
                               "gatekeeper-system") is None

    def test_reconciler_exception_does_not_kill_worker(self):
        cluster = FakeCluster()
        mgr = ControllerManager(cluster, max_attempts=3)

        class Boom:
            name = "boom"

            def reconcile(self, request):
                raise ValueError("not an ApiError")

        from gatekeeper_tpu_torch.controllers.runtime import Request
        mgr.start()
        try:
            mgr.enqueue(Boom(), Request(name="x"))
            import time
            deadline = time.time() + 5
            while not mgr.errors and time.time() < deadline:
                time.sleep(0.01)
            assert mgr.errors
            # worker still alive: a well-behaved item is processed
            seen = []

            class Ok:
                name = "ok"

                def reconcile(self, request):
                    seen.append(request.name)
                    from gatekeeper_tpu_torch.controllers.runtime import DONE
                    return DONE

            mgr.enqueue(Ok(), Request(name="y"))
            deadline = time.time() + 5
            while not seen and time.time() < deadline:
                time.sleep(0.01)
            assert seen == ["y"]
        finally:
            mgr.stop()


# ---------------------------------------------------------------------------
# the cluster objects against the reference's control plane

DEMO = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "demo")


LIBRARY_KINDS = ("K8sUniqueIngressHost", "K8sImageDigests",
                 "K8sDisallowLatestTag", "K8sRequiredServiceAccount",
                 "K8sPriorityClass")


EXT_REGO = """package k8sexternalcheck
violation[{"msg": msg}] {
  resp := external_data({"provider": "image-signer", "keys": ["a"]})
  count(resp.errors) > 0
  msg := "unsigned"
}
"""


def _load(*parts) -> dict:
    with open(os.path.join(DEMO, *parts)) as f:
        return yaml.safe_load(f)


def _both_planes():
    """The reference's control plane (JaxDriver on the CPU) and the
    port's (TorchDriver(device="cpu")), each on its own FakeCluster with
    the same served kinds."""
    from gatekeeper_tpu.api.config import GVK as RGVK
    from gatekeeper_tpu.client.client import Backend as RBackend
    from gatekeeper_tpu.cluster.fake import FakeCluster as RFakeCluster
    from gatekeeper_tpu.controllers.config import CONFIG_GVK as RCONFIG
    from gatekeeper_tpu.controllers.constrainttemplate import \
        TEMPLATE_GVK as RTEMPLATE
    from gatekeeper_tpu.controllers.registry import \
        add_to_manager as radd
    from gatekeeper_tpu.engine.jax_driver import JaxDriver
    from gatekeeper_tpu.target.k8s import K8sValidationTarget as RTarget
    ref = RFakeCluster()
    port = FakeCluster()
    for cluster, gvk_cls, tmpl, cfg in ((ref, RGVK, RTEMPLATE, RCONFIG),
                                        (port, GVK, TEMPLATE_GVK,
                                         CONFIG_GVK)):
        cluster.register_kind(tmpl, "constrainttemplates")
        cluster.register_kind(cfg, "configs")
        for kind, plural in (("Namespace", "namespaces"), ("Pod", "pods"),
                             ("Service", "services")):
            cluster.register_kind(gvk_cls("", "v1", kind), plural)
    ref_plane = radd(ref, RBackend(JaxDriver()).new_client([RTarget()]))
    port_plane = add_to_manager(port, Backend(TorchDriver(
        device="cpu")).new_client([K8sValidationTarget()]))
    return ref_plane, port_plane


def _objects(cluster) -> dict:
    """Every stored object by (group, version, kind, namespace, name)."""
    out = {}
    for gvk, store in cluster._objects.items():
        for (ns, name), obj in store.items():
            out[(gvk.group, gvk.version, gvk.kind, ns or "", name)] = obj
    return out


def _writes():
    """The write sequence: the basic and agilebank demos' sync config,
    namespaces, templates (one that does not compile), constraints (plus
    a shadowed, an unreachable and a mistyped-action one), resources,
    then a constraint delete and a template delete (the cascade)."""
    sync = _load("agilebank", "sync.yaml")
    yield "create", sync
    for name, labels in (("advanced-transaction-system", None),
                         ("payments", {"owner": "me.agilebank.demo",
                                       "gatekeeper": "on"}),
                         ("no-label", None)):
        yield "create", ns_obj(name, labels)
    for demo in ("basic", "agilebank"):
        for path in sorted(glob.glob(os.path.join(DEMO, demo, "templates",
                                                  "*.yaml"))):
            yield "create", _load(path)
    # library templates that carry the footprint and shardplan findings
    # (an inventory join) and shared predicates (the Pod gates)
    for kind in LIBRARY_KINDS:
        yield "create", template_doc(kind, LIBRARY[kind][0])
    # an external_data call: with no Provider installed both vets reject
    # it against the live (empty) provider set
    yield "create", template_obj(kind="K8sExternalCheck", rego=EXT_REGO)
    bad = _load("basic", "bad", "bad_template.yaml")
    bad["metadata"]["name"] = "k8sbrokentemplate"
    bad["spec"]["crd"]["spec"]["names"]["kind"] = "K8sBrokenTemplate"
    yield "create", bad
    for demo in ("basic", "agilebank"):
        for path in sorted(glob.glob(os.path.join(DEMO, demo, "constraints",
                                                  "*.yaml"))):
            yield "create", _load(path)
    for kind in LIBRARY_KINDS:
        yield "create", constraint_doc(kind, f"lib-{kind.lower()}",
                                       LIBRARY[kind][1])
    base = _load("basic", "constraints", "all_ns_must_have_gatekeeper.yaml")
    shadowed = copy.deepcopy(base)
    shadowed["metadata"]["name"] = "ns-must-have-gk-shadowed"
    shadowed["spec"]["match"]["namespaces"] = ["payments"]
    yield "create", shadowed
    unreachable = copy.deepcopy(base)
    unreachable["metadata"]["name"] = "ns-must-have-gk-nowhere"
    unreachable["spec"]["match"]["namespaces"] = []
    yield "create", unreachable
    typo = copy.deepcopy(base)
    typo["metadata"]["name"] = "ns-must-have-gk-typo"
    typo["spec"]["enforcementAction"] = "audit-only"
    yield "create", typo
    for path in sorted(glob.glob(os.path.join(DEMO, "agilebank",
                                              "good_resources", "*.yaml"))):
        yield "create", _load(path)
    yield "delete", ("constraints.gatekeeper.sh", "v1alpha1",
                     "K8sRequiredLabels", "ns-must-have-gk-typo")
    yield "delete", ("templates.gatekeeper.sh", "v1alpha1",
                     "ConstraintTemplate", "k8suniquelabel")


def _apply(plane, gvk_cls, op, arg) -> None:
    if op == "create":
        plane.cluster.create(copy.deepcopy(arg))
    else:
        group, version, kind, name = arg
        plane.cluster.delete(gvk_cls(group, version, kind), name)
    plane.run_until_idle()


def test_cluster_objects_equal_the_reference(monkeypatch):
    """After the same writes, every object in the port's FakeCluster
    equals the reference's — template status.byPod[] errors and warnings
    (the Stage-1 vet, the policy-set, footprint and shardplan findings),
    constraint statuses (enforced, set_* warnings), finalizers, the
    constraint CRDs and the resource versions — with timestamps masked."""
    from gatekeeper_tpu.api.config import GVK as RGVK
    from gatekeeper_tpu.engine import jax_driver
    from gatekeeper_tpu.externaldata import runtime
    monkeypatch.setattr(jax_driver, "SMALL_WORKLOAD_EVALS", 0)
    # fresh runtimes (no Provider registered), as a process that has
    # just started has
    from gatekeeper_tpu_torch.externaldata import runtime as truntime
    monkeypatch.setattr(runtime, "_runtime", None)
    monkeypatch.setattr(truntime, "_runtime", None)
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    ref_plane, port_plane = _both_planes()
    for op, arg in _writes():
        _apply(ref_plane, RGVK, op, arg)
        _apply(port_plane, GVK, op, arg)
        assert _masked(_objects(port_plane.cluster)) == \
            _masked(_objects(ref_plane.cluster)), (op, arg)
    objs = _objects(port_plane.cluster)
    tmpl = objs[("templates.gatekeeper.sh", "v1alpha1", "ConstraintTemplate",
                 "", "k8sbrokentemplate")]
    assert get_ha_status(tmpl).get("errors")
    ext = objs[("templates.gatekeeper.sh", "v1alpha1", "ConstraintTemplate",
                "", "k8sexternalcheck")]
    assert [e["code"] for e in get_ha_status(ext)["errors"]] == \
        ["rego_bad_provider_ref"]
    codes = {w["code"] for o in objs.values()
             for w in get_ha_status(o).get("warnings") or []}
    assert {"set_shadowed", "set_unreachable", "cross_row_dependency",
            "shard_ineligible", "set_duplicate_predicate"} <= codes, codes
    assert ("templates.gatekeeper.sh", "v1alpha1", "ConstraintTemplate", "",
            "k8suniquelabel") not in objs
    assert port_plane.client.constraints.get("K8sUniqueLabel") is None


def _masked(objs: dict) -> dict:
    out = copy.deepcopy(objs)
    for obj in out.values():
        st = obj.get("status")
        if isinstance(st, dict):
            st.pop("auditTimestamp", None)
        obj.get("metadata", {}).pop("deletionTimestamp", None)
    return out


def test_transval_strict_is_refused(monkeypatch):
    """GATEKEEPER_TRANSVAL=strict runs Stage 4 as the reference does (the
    test keeps the name it had while the port refused the mode): the
    template reconciles, is certified and stays on the device path with
    no status error, and the reference's plane over the same write
    reaches the same status."""
    from gatekeeper_tpu.client.client import Backend as RBackend
    from gatekeeper_tpu.cluster.fake import FakeCluster as RFakeCluster
    from gatekeeper_tpu.controllers.constrainttemplate import \
        TEMPLATE_GVK as RTEMPLATE
    from gatekeeper_tpu.controllers.registry import add_to_manager as radd
    from gatekeeper_tpu.engine.jax_driver import JaxDriver
    from gatekeeper_tpu.target.k8s import K8sValidationTarget as RTarget
    from gatekeeper_tpu.utils.ha_status import get_ha_status as rstatus
    from gatekeeper_tpu_torch.analysis import transval
    monkeypatch.setenv("GATEKEEPER_TRANSVAL", "strict")
    monkeypatch.setattr(transval, "_memo", {})
    monkeypatch.setattr(transval, "failures", {})
    monkeypatch.setattr(transval, "validations_run", 0)
    cluster = FakeCluster()
    cluster.register_kind(TEMPLATE_GVK, "constrainttemplates")
    driver = TorchDriver(device="cpu")
    plane = add_to_manager(cluster, make_client(driver))
    cluster.create(template_obj())
    plane.run_until_idle()
    assert not plane.mgr.errors
    ref = RFakeCluster()
    ref.register_kind(RTEMPLATE, "constrainttemplates")
    rplane = radd(ref, RBackend(JaxDriver()).new_client([RTarget()]))
    ref.create(template_obj())
    rplane.run_until_idle()
    name = template_obj()["metadata"]["name"]
    got = get_ha_status(cluster.get(TEMPLATE_GVK, name))
    assert got.get("errors") == rstatus(ref.get(RTEMPLATE, name)).get(
        "errors") is None
    (kind, compiled), = driver.state[
        "admission.k8s.gatekeeper.sh"].templates.items()
    assert compiled.vectorized is not None
    assert transval.validations_run == 1
    # one validation; each reconcile of the template re-certifies from
    # the memo
    assert driver.metrics.counter("transval_certified").value >= 1


def test_control_plane_installs_the_runtime_and_reconciles_providers():
    """As the reference does, add_to_manager installs the process-global
    external-data runtime (or reuses an installed one) and, where
    discovery serves the Provider kind, a provider controller: a
    Provider object is registered into the runtime, its template then
    vets clean against the live provider set, and the reference's plane
    over the same writes reaches the same statuses."""
    from gatekeeper_tpu.api.config import GVK as RGVK
    from gatekeeper_tpu.client.client import Backend as RBackend
    from gatekeeper_tpu.cluster.fake import FakeCluster as RFakeCluster
    from gatekeeper_tpu.controllers.constrainttemplate import \
        TEMPLATE_GVK as RTEMPLATE
    from gatekeeper_tpu.controllers.registry import add_to_manager as radd
    from gatekeeper_tpu.engine.jax_driver import JaxDriver
    from gatekeeper_tpu.externaldata import runtime as rruntime
    from gatekeeper_tpu.target.k8s import K8sValidationTarget as RTarget
    from gatekeeper_tpu_torch.api.externaldata import PROVIDER_GVK
    from gatekeeper_tpu_torch.externaldata import runtime as truntime
    rprev, tprev = rruntime.get_runtime(), truntime.get_runtime()
    rruntime.set_runtime(None)
    truntime.set_runtime(None)
    try:
        port = FakeCluster()
        ref = RFakeCluster()
        planes = []
        for cluster, gvk_cls, tmpl, add, client in (
                (port, GVK, TEMPLATE_GVK, add_to_manager, make_client()),
                (ref, RGVK, RTEMPLATE, radd, RBackend(JaxDriver())
                 .new_client([RTarget()]))):
            cluster.register_kind(tmpl, "constrainttemplates")
            cluster.register_kind(gvk_cls("externaldata.gatekeeper.sh",
                                          "v1beta1", "Provider"),
                                  "providers")
            planes.append(add(cluster, client))
        tplane, rplane = planes
        assert tplane.external_data is truntime.get_runtime()
        assert tplane.provider_controller is not None
        assert set(port._watchers) == {TEMPLATE_GVK, CONFIG_GVK,
                                       PROVIDER_GVK}
        # a second plane in the process shares the installed runtime
        assert add_to_manager(FakeCluster(), make_client()).external_data \
            is tplane.external_data
        provider = {"apiVersion": "externaldata.gatekeeper.sh/v1beta1",
                    "kind": "Provider", "metadata": {"name": "image-signer"},
                    "spec": {"url": "fake://signer",
                             "failurePolicy": "Ignore"}}
        for plane in planes:
            plane.cluster.create(copy.deepcopy(provider))
            plane.run_until_idle()
            plane.cluster.create(template_obj(kind="K8sExternalCheck",
                                              rego=EXT_REGO))
            plane.run_until_idle()
        assert tplane.external_data.provider_names() == ["image-signer"]
        tobjs, robjs = _objects(port), _objects(ref)
        assert _masked(tobjs) == _masked(robjs)
        tmpl = tobjs[("templates.gatekeeper.sh", "v1alpha1",
                      "ConstraintTemplate", "", "k8sexternalcheck")]
        assert not get_ha_status(tmpl).get("errors")
        prov = tobjs[("externaldata.gatekeeper.sh", "v1beta1", "Provider",
                      "", "image-signer")]
        assert prov["status"]["byPod"] == [{"state": "Active"}]
        # a cluster that does not serve the kind gets no provider watch
        bare = FakeCluster()
        assert add_to_manager(bare, make_client()).provider_controller \
            is None
    finally:
        rruntime.set_runtime(rprev)
        truntime.set_runtime(tprev)