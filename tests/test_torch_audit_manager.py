"""The port's audit manager against the reference: the flows of
tests/test_audit_manager.py (sweep semantics, cap, truncation, status
writes with backoff, the loop) over the port's LocalDriver and
TorchDriver(device="cpu"); the constraint statuses it writes over a
make_mixed cluster under the whole library, capped at 20, equal to the
reference AuditManager's (JaxDriver on the CPU) with GATEKEEPER_PAGES on
and off; and its trims (no backend posture in the report, the audit
warm's error raised by the next sweep).
"""

import copy
import random

import pytest

from gatekeeper_tpu_torch.api.config import GVK
from gatekeeper_tpu_torch.audit.manager import (CRD_NAME, AuditManager,
                                          truncate_message)
from gatekeeper_tpu_torch.client.client import Backend
from gatekeeper_tpu_torch.client.local_driver import LocalDriver
from gatekeeper_tpu_torch.cluster.fake import FakeCluster
from gatekeeper_tpu_torch.controllers.constrainttemplate import (CRD_GVK,
                                                           TEMPLATE_GVK)
from gatekeeper_tpu_torch.controllers.registry import add_to_manager
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.library import make_mixed
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
from tests.test_control_plane import constraint_obj, ns_obj, template_obj

CON_GVK = GVK("constraints.gatekeeper.sh", "v1alpha1", "K8sRequiredLabels")
NS_GVK = GVK("", "v1", "Namespace")


def template_crd_obj():
    return {"apiVersion": "apiextensions.k8s.io/v1beta1",
            "kind": "CustomResourceDefinition",
            "metadata": {"name": CRD_NAME},
            "spec": {"group": "templates.gatekeeper.sh",
                     "version": "v1alpha1",
                     "names": {"kind": "ConstraintTemplate",
                               "plural": "constrainttemplates"}}}


@pytest.fixture(params=["local", "torch"])
def setup(request, monkeypatch):
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    cluster = FakeCluster()
    cluster.register_kind(TEMPLATE_GVK, "constrainttemplates")
    cluster.register_kind(NS_GVK, "namespaces")
    driver = LocalDriver() if request.param == "local" \
        else TorchDriver(device="cpu")
    client = Backend(driver).new_client([K8sValidationTarget()])
    plane = add_to_manager(cluster, client)
    cluster.create(template_crd_obj())
    sleeps = []
    am = AuditManager(cluster, client, sleep=sleeps.append)
    return cluster, client, plane, am, sleeps


def ingest_namespaces(cluster, client, n=30, labeled_every=3):
    for i in range(n):
        labels = {"gatekeeper": "on"} if i % labeled_every == 0 else None
        obj = ns_obj(f"ns{i:03d}", labels)
        cluster.create(obj)
        client.add_data(obj)


class TestTruncation:
    def test_truncate_rules(self):
        assert truncate_message("x" * 256) == "x" * 256
        out = truncate_message("x" * 300)
        assert len(out) == 256 and out.endswith("...")


class TestAuditManager:
    def test_skips_without_crd(self, setup):
        cluster, client, plane, am, _ = setup
        cluster.delete(CRD_GVK, CRD_NAME)
        report = am.audit_once()
        assert report["skipped"] is True

    def test_sweep_writes_statuses(self, setup):
        cluster, client, plane, am, _ = setup
        ingest_namespaces(cluster, client, n=30)
        cluster.create(template_obj())
        plane.run_until_idle()
        cluster.create(constraint_obj())
        plane.run_until_idle()

        report = am.audit_once()
        assert report["skipped"] is False
        assert report["violations"] == 20  # capped at the default limit
        assert report["constraints_updated"] == 1

        con = cluster.get(CON_GVK, "ns-must-have-gk")
        viol = con["status"]["violations"]
        assert len(viol) == 20
        assert con["status"]["auditTimestamp"]
        assert all(v["kind"] == "Namespace" for v in viol)
        assert all(v["enforcementAction"] == "deny" for v in viol)
        assert all(len(v["message"]) <= 256 for v in viol)

    def test_empty_violations_removed(self, setup):
        cluster, client, plane, am, _ = setup
        ingest_namespaces(cluster, client, n=6, labeled_every=1)  # all labeled
        cluster.create(template_obj())
        plane.run_until_idle()
        cluster.create(constraint_obj())
        plane.run_until_idle()
        # seed a stale violations status
        con = cluster.get(CON_GVK, "ns-must-have-gk")
        con.setdefault("status", {})["violations"] = [{"kind": "Namespace"}]
        cluster.update(con)

        report = am.audit_once()
        assert report["violations"] == 0
        con = cluster.get(CON_GVK, "ns-must-have-gk")
        assert "violations" not in con["status"]
        assert con["status"]["auditTimestamp"]

    def test_status_write_backoff(self, setup):
        cluster, client, plane, am, sleeps = setup
        ingest_namespaces(cluster, client, n=4, labeled_every=100)
        cluster.create(template_obj())
        plane.run_until_idle()
        cluster.create(constraint_obj())
        plane.run_until_idle()

        cluster.inject_update_failures(2)
        report = am.audit_once()
        assert report["constraints_updated"] == 1
        assert sleeps == [1.0, 2.0]  # exponential backoff rounds
        con = cluster.get(CON_GVK, "ns-must-have-gk")
        assert len(con["status"]["violations"]) == 3

    def test_loop_runs_and_stops(self, setup):
        cluster, client, plane, am, _ = setup
        am.interval = 0.01
        am._sleep = lambda s: None
        am.start()
        import time
        deadline = time.time() + 5
        while not am.last_sweep and time.time() < deadline:
            time.sleep(0.01)
        am.stop()
        assert am.last_sweep  # at least one sweep ran
        assert am.metrics.counter("audit_sweeps").value >= 1


# ---------------------------------------------------------------------------
# the written statuses against the reference's AuditManager

MIXED_ROWS = 120


def _mixed_plane(pkg: str, rows: list[dict]):
    """A control plane of package ``pkg`` ("ref" or "port") over its own
    FakeCluster, with every library template and constraint and ``rows``
    created as cluster objects, reconciled and synced."""
    import importlib
    if pkg == "ref":
        base, driver = "gatekeeper_tpu", "jax"
    else:
        base, driver = "gatekeeper_tpu_torch", "torch"
    mod = lambda name: importlib.import_module(f"{base}.{name}")
    gvk_cls = mod("api.config").GVK
    cluster = mod("cluster.fake").FakeCluster()
    cluster.register_kind(mod("controllers.constrainttemplate").TEMPLATE_GVK,
                          "constrainttemplates")
    cluster.register_kind(mod("controllers.config").CONFIG_GVK, "configs")
    kinds = sorted({(r["apiVersion"], r["kind"]) for r in rows})
    for api, kind in kinds:
        cluster.register_kind(gvk_cls.from_api_version(api, kind))
    drv = mod("engine.jax_driver").JaxDriver() if driver == "jax" \
        else TorchDriver(device="cpu")
    client = mod("client.client").Backend(drv).new_client(
        [mod("target.k8s").K8sValidationTarget()])
    plane = mod("controllers.registry").add_to_manager(cluster, client)
    cfg = mod("api.config").empty_config_object()
    cfg["spec"] = {"sync": {"syncOnly": [
        gvk_cls.from_api_version(api, kind).to_dict()
        for api, kind in kinds]}}
    cluster.create(cfg)
    for t, c in mod("library").all_docs():
        cluster.create(copy.deepcopy(t))
        plane.run_until_idle()
        cluster.create(copy.deepcopy(c))
    for r in rows:
        cluster.create(copy.deepcopy(r))
    plane.run_until_idle()
    cluster.create(template_crd_obj())
    am = mod("audit.manager").AuditManager(cluster, client,
                                           sleep=lambda s: None)
    return plane, am, gvk_cls


def _statuses(cluster) -> dict:
    out = {}
    for gvk, store in cluster._objects.items():
        if gvk.group != "constraints.gatekeeper.sh":
            continue
        for (_, name), obj in store.items():
            st = copy.deepcopy(obj.get("status") or {})
            assert st.pop("auditTimestamp")
            out[(gvk.kind, name)] = st
    return out


@pytest.mark.parametrize("pages", ["on", "off"])
def test_statuses_equal_the_reference(pages, monkeypatch):
    """Every constraint's written status (violations capped at 20,
    messages truncated, enforcement actions, byPod) equals the
    reference AuditManager's over the same cluster: a make_mixed store
    under the whole library, synced through the controllers, swept,
    then churned (relabels and a delete) and swept again."""
    from gatekeeper_tpu.engine import jax_driver
    monkeypatch.setenv("GATEKEEPER_PAGES", pages)
    monkeypatch.setattr(jax_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    rows = make_mixed(random.Random(7), MIXED_ROWS)
    planes = [_mixed_plane(pkg, rows) for pkg in ("ref", "port")]
    reports = [am.audit_once() for _, am, _ in planes]
    want, got = (_statuses(p.cluster) for p, _, _ in planes)
    assert got == want
    capped = [k for k, st in got.items() if len(st.get("violations") or ())
              == 20]
    assert capped, "no constraint reached the cap"
    assert reports[1]["violations"] == reports[0]["violations"]
    assert reports[1]["constraints_updated"] == \
        reports[0]["constraints_updated"] == len(got)
    # churn: relabel every fifth row, delete one, sweep again
    for plane, _, gvk_cls in planes:
        cluster = plane.cluster
        for i, r in enumerate(rows):
            gvk = gvk_cls.from_api_version(r["apiVersion"], r["kind"])
            meta = r["metadata"]
            if i == 3:
                cluster.delete(gvk, meta["name"], meta.get("namespace"))
            elif i % 5 == 0:
                obj = cluster.get(gvk, meta["name"], meta.get("namespace"))
                obj["metadata"]["labels"] = {"churned": str(i)}
                cluster.update(obj)
        plane.run_until_idle()
    for _, am, _ in planes:
        am.audit_once()
    want, got = (_statuses(p.cluster) for p, _, _ in planes)
    assert got == want


# ---------------------------------------------------------------------------
# the port's trims


def test_report_states_no_backend_posture(setup, monkeypatch, tmp_path):
    """The sweep report carries the serving posture of the driver's
    device, as the reference's does: ``backend_state`` healthy, then,
    once the device is lost, ``degraded`` with its reason and the same
    violations from the scalar oracle (a LocalDriver has no device to
    lose).  Under GATEKEEPER_SNAPSHOT_DIR each sweep persists the store,
    which a fresh driver restores.  The test keeps the name it had while
    the port's report carried no posture."""
    from gatekeeper_tpu_torch.resilience import supervisor as tsup
    from gatekeeper_tpu_torch.target.k8s import TARGET_NAME
    monkeypatch.setenv("GATEKEEPER_SUPERVISOR_REPROBE", "0")
    monkeypatch.setenv("GATEKEEPER_SNAPSHOT_DIR", str(tmp_path))
    cluster, client, plane, am, _ = setup
    ingest_namespaces(cluster, client, n=6)
    cluster.create(template_obj())
    plane.run_until_idle()
    cluster.create(constraint_obj())
    plane.run_until_idle()
    tsup.reset_for_tests()
    try:
        report = am.audit_once()
        assert report["skipped"] is False and report["violations"] == 4
        assert report["backend_state"] == "healthy"
        assert "degraded" not in report
        if not isinstance(client.driver, TorchDriver):
            return
        fresh = TorchDriver(device="cpu")
        fresh.init(client.driver.targets)
        assert fresh.restore_store_snapshot(TARGET_NAME)
        assert len(fresh._state(TARGET_NAME).table) == 6
        client.driver.supervisor.report_failure("card lost")
        report = am.audit_once(full=True)
        assert report["violations"] == 4
        assert report["backend_state"] == "degraded"
        assert report["degraded"] is True
        assert report["degraded_reason"] == "card lost"
        assert am.metrics.counter("audit_sweeps_degraded").value == 1
    finally:
        tsup.reset_for_tests()


class _FailingAudit:
    """A driver stand-in whose query_audit fails once, as a warm's
    kernel build error would."""

    def __init__(self, driver):
        self._driver = driver
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._driver, name)

    def query_audit(self, target, opts=None):
        self.calls.append(opts)
        if len(self.calls) == 1:
            raise RuntimeError("kernel build failed")
        return self._driver.query_audit(target, opts)


def test_warm_error_is_raised_by_the_next_audit(monkeypatch):
    """start() warms the capped audit on an ``audit-warmup`` thread (one
    capped query_audit a target); its error is raised once, by the next
    audit_once, not swallowed as the reference does."""
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    cluster = FakeCluster()
    cluster.register_kind(TEMPLATE_GVK, "constrainttemplates")
    client = Backend(TorchDriver(device="cpu")).new_client(
        [K8sValidationTarget()])
    cluster.create(template_crd_obj())
    failing = _FailingAudit(client.driver)
    client.driver = failing
    am = AuditManager(cluster, client, interval=3600)
    am.start()
    try:
        warm = am._warms[0]
        warm.thread.join(30)
        assert warm.thread.name == "audit-warmup"
        assert failing.calls[0].limit_per_constraint == 20
        with pytest.raises(RuntimeError, match="kernel build failed"):
            am.audit_once()
        assert am.audit_once()["skipped"] is False
    finally:
        am.stop()


def test_no_warm_for_a_driver_without_an_executor(monkeypatch):
    cluster = FakeCluster()
    client = Backend(LocalDriver()).new_client([K8sValidationTarget()])
    am = AuditManager(cluster, client, interval=3600)
    am.start()
    am.stop()
    assert am._warms == []


def test_stop_joins_the_warm_and_keeps_its_error():
    """stop() joins the audit warm-ups too (no thread launches once the
    manager stopped); the warm's error stays for the next audit_once."""
    client = Backend(TorchDriver(device="cpu")).new_client(
        [K8sValidationTarget()])
    failing = _FailingAudit(client.driver)
    client.driver = failing
    am = AuditManager(FakeCluster(), client, interval=3600)
    am.start()
    am.stop()
    assert not am._warms[0].thread.is_alive()
    with pytest.raises(RuntimeError, match="kernel build failed"):
        am.audit_once()
    assert am.audit_once()["skipped"] is True     # raised once


def test_status_writes_keep_the_churn_delta_plan(monkeypatch):
    """Each sweep's status writes come back to the engine through the
    constraint controller as status-only re-puts.  The port keeps the
    kind's constraint version for them (the reference bumps it, and its
    next sweep re-evaluates every pair): after a pod churn the next
    sweep takes the delta plan.  A spec edit still takes the full plan."""
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    pod_gvk = GVK("", "v1", "Pod")
    cluster = FakeCluster()
    cluster.register_kind(TEMPLATE_GVK, "constrainttemplates")
    cluster.register_kind(pod_gvk, "pods")
    drv = TorchDriver(device="cpu")
    client = Backend(drv).new_client([K8sValidationTarget()])
    plane = add_to_manager(cluster, client)
    cluster.create(template_crd_obj())
    cluster.create({
        "apiVersion": "config.gatekeeper.sh/v1alpha1", "kind": "Config",
        "metadata": {"name": "config", "namespace": "gatekeeper-system"},
        "spec": {"sync": {"syncOnly": [
            {"group": "", "version": "v1", "kind": "Pod"}]}}})
    for i in range(30):
        cluster.create({"apiVersion": "v1", "kind": "Pod",
                        "metadata": {"name": f"p{i:03d}", "namespace": "d",
                                     "labels": {"gatekeeper": "on"}
                                     if i % 3 == 0 else {}}})
    cluster.create(template_obj())
    plane.run_until_idle()
    con = constraint_obj()
    con["spec"]["match"]["kinds"][0]["kinds"] = ["Pod"]
    cluster.create(con)
    plane.run_until_idle()
    am = AuditManager(cluster, client, sleep=lambda s: None)
    assert am.audit_once()["violations"] == 20
    plane.run_until_idle()          # the status writes' re-puts
    assert drv.metrics.counter("constraint_status_only_puts").value >= 1
    x = drv.executor
    pod = cluster.get(pod_gvk, "p001", "d")
    pod["metadata"]["labels"] = {"gatekeeper": "on"}
    cluster.update(pod)
    plane.run_until_idle()
    before = (x.mask_evals, x.delta_evals)
    am.audit_once()
    assert (x.mask_evals - before[0], x.delta_evals - before[1]) == (0, 1)
    con = cluster.get(CON_GVK, "ns-must-have-gk")
    assert "p001" not in {v["name"] for v in con["status"]["violations"]}
    # a parameter edit is not status-only: the full plan
    con["spec"]["parameters"]["labels"] = ["other"]
    cluster.update(con)
    plane.run_until_idle()
    before = x.mask_evals
    am.audit_once()
    assert x.mask_evals == before + 1
    con = cluster.get(CON_GVK, "ns-must-have-gk")
    assert "p001" in {v["name"] for v in con["status"]["violations"]}


def test_reput_of_an_edited_object_still_bumps(monkeypatch):
    """A constraint edited in place and put again is compared with the
    frozen snapshot of the previous put, so the edit shows and bumps."""
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    drv = TorchDriver(device="cpu")
    client = Backend(drv).new_client([K8sValidationTarget()])
    client.add_template(template_obj())
    con = constraint_obj()
    client.add_constraint(con)
    for i in range(6):
        client.add_data(ns_obj(f"ns{i}", {"gatekeeper": "on"}
                               if i % 2 else None))
    assert len(client.audit().results()) == 3
    con["spec"]["parameters"]["labels"] = ["other"]
    client.add_constraint(con)
    assert len(client.audit().results()) == 6
    # a fresh document differing only in status keeps the version
    fresh = copy.deepcopy(con)
    fresh["status"] = {"auditTimestamp": "now"}
    client.add_constraint(fresh)
    assert drv.metrics.counter("constraint_status_only_puts").value == 1
    assert len(client.audit().results()) == 6


def test_deep_copy_of_an_in_place_edit_takes_the_full_plan(monkeypatch):
    """The caller edits the installed dict in place and puts a deep
    copy of it.  The two documents are equal, but the snapshot of the
    previous put is not: the version moves, the next sweep takes the
    full plan and its verdicts are the edited constraint's.  Labels and
    annotations move the version too; resourceVersion and managedFields
    do not."""
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    drv = TorchDriver(device="cpu")
    client = Backend(drv).new_client([K8sValidationTarget()])
    client.add_template(template_obj())
    con = constraint_obj()
    client.add_constraint(con)
    for i in range(6):
        client.add_data(ns_obj(f"ns{i}", {"gatekeeper": "on"}
                               if i % 2 else None))
    x = drv.executor
    assert len(client.audit().results()) == 3
    con["spec"]["parameters"]["labels"] = ["other"]
    before = x.mask_evals
    client.add_constraint(copy.deepcopy(con))
    assert drv.metrics.counter("constraint_status_only_puts").value == 0
    res = client.audit().results()
    assert x.mask_evals == before + 1
    assert sorted(r.resource["metadata"]["name"] for r in res) == \
        [f"ns{i}" for i in range(6)]
    assert all("other" in r.msg for r in res)
    puts = 0
    for key, val, moves in (("resourceVersion", "7", False),
                            ("managedFields", [{"manager": "m"}], False),
                            ("labels", {"team": "a"}, True),
                            ("annotations", {"note": "b"}, True)):
        fresh = copy.deepcopy(con)
        fresh["metadata"][key] = val
        before = x.mask_evals
        client.add_constraint(fresh)
        con = fresh
        puts += not moves
        assert drv.metrics.counter("constraint_status_only_puts").value \
            == puts
        assert len(client.audit().results()) == 6
        assert x.mask_evals == before + moves, key
