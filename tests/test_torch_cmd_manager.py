"""The port's process entry point (``gatekeeper_tpu_torch.cmd.manager``)
against the reference: the flows of tests/test_cmd_manager.py with
``--device cpu``; the demo/basic walkthrough (demo/basic/demo.py's
steps) over HTTP against the port's Manager, read from the in-repo
YAMLs; the demo flow's statuses equal the reference Manager's;
``python -m gatekeeper_tpu_torch.cmd.manager --demo --device cpu`` in a
subprocess; the default device (cuda, raising without a card); a
manager over an engine worker (``--engine-worker-url``) equal to the
in-process one; the admission corpus under
``GATEKEEPER_FLIGHT_ADMISSION``; and every trimmed variable refused by
name.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch
import yaml

from gatekeeper_tpu_torch.api.config import GVK
from gatekeeper_tpu_torch.audit.manager import gvk_of_constraint
from gatekeeper_tpu_torch.cmd.manager import Manager, parse_args, run_demo
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASIC = os.path.join(REPO, "demo", "basic")
CPU = ["--device", "cpu"]


def test_demo_flow_end_to_end():
    args = parse_args(["--port", "-1"] + CPU)
    mgr = Manager(args)
    assert isinstance(mgr.client.driver, TorchDriver)
    assert mgr.client.driver.device == torch.device("cpu")
    out = run_demo(mgr, n_namespaces=40)
    assert out["sweep"]["skipped"] is False
    assert out["sweep"]["violations"] == 20       # capped
    assert out["status_violations"] == 20
    assert out["audit_timestamp"]


def test_demo_statuses_equal_the_reference():
    """The demo flow's constraint status on the port's Manager equals
    the reference Manager's (JaxDriver on the CPU), the timestamp
    masked."""
    from gatekeeper_tpu.cmd import manager as ref
    from gatekeeper_tpu.externaldata import runtime
    prev = runtime.get_runtime()
    try:
        ref_mgr = ref.Manager(ref.parse_args(["--port", "-1"]))
        ref.run_demo(ref_mgr, n_namespaces=40)
    finally:
        runtime.set_runtime(prev)
    mgr = Manager(parse_args(["--port", "-1"] + CPU))
    run_demo(mgr, n_namespaces=40)
    statuses = []
    for m, gvk in ((ref_mgr, ref.GVK), (mgr, GVK)):
        con = m.cluster.get(gvk("constraints.gatekeeper.sh", "v1alpha1",
                                "K8sRequiredLabels"), "ns-must-have-gk")
        st = dict(con["status"])
        assert st.pop("auditTimestamp")
        statuses.append(st)
    assert statuses[1] == statuses[0]
    assert len(statuses[1]["violations"]) == 20


def _wait_for(cond, seconds: float = 10.0) -> bool:
    deadline = time.time() + seconds
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def test_threaded_start_stop():
    args = parse_args(["--port", "0", "--audit-interval", "3600"] + CPU)
    earlier = set(threading.enumerate())    # other tests' threads
    mgr = Manager(args)
    mgr.start()
    try:
        assert mgr.webhook.port > 0
        # control plane is live: a template applied to the cluster is
        # reconciled into the engine by the worker thread
        mgr.cluster.create({
            "apiVersion": "templates.gatekeeper.sh/v1alpha1",
            "kind": "ConstraintTemplate",
            "metadata": {"name": "k8sdenyall"},
            "spec": {"crd": {"spec": {"names": {"kind": "K8sDenyAll"}}},
                     "targets": [{"target": "admission.k8s.gatekeeper.sh",
                                  "rego": 'package k8sdenyall\n'
                                          'violation[{"msg": "deny"}] '
                                          '{ 1 == 1 }\n'}]},
        })
        assert _wait_for(lambda: "K8sDenyAll" in mgr.client.templates)
    finally:
        mgr.stop()
    # stop() joined every thread the manager (and its driver) started
    names = {"reconcile-worker", "admission-batcher", "webhook-server",
             "audit-manager", "watch-roster-poll", "audit-warmup",
             "delta-warmup", "ingest-prewarm"}
    assert not [t.name for t in threading.enumerate()
                if t.name in names and t.is_alive() and t not in earlier]


def test_live_watch_roster_poll():
    """A GVK whose CRD becomes served AFTER registration must get its
    watch started by the periodic roster poll (reference
    updateManagerLoop, watch/manager.go:165-178) — with no roster
    mutation and no deterministic pump."""
    args = parse_args(["--port", "-1", "--audit-interval", "3600",
                       "--watch-poll-interval", "0.1"] + CPU)
    mgr = Manager(args)
    gvk = GVK(group="example.com", version="v1", kind="Widget")
    mgr.plane.sync_registrar.add_watch(gvk)
    assert gvk in mgr.plane.watch_manager.pending_gvks()
    mgr.start()
    try:
        mgr.cluster.create({
            "apiVersion": "apiextensions.k8s.io/v1beta1",
            "kind": "CustomResourceDefinition",
            "metadata": {"name": "widgets.example.com"},
            "spec": {"group": "example.com", "version": "v1",
                     "names": {"kind": "Widget", "plural": "widgets"}},
        })
        assert _wait_for(
            lambda: gvk in mgr.plane.watch_manager.watched_gvks()), \
            "poll loop never picked up the newly-served CRD"
    finally:
        mgr.stop()


# ---------------------------------------------------------------------------
# demo/basic over HTTP


def _load(rel: str) -> dict:
    with open(os.path.join(BASIC, rel)) as f:
        return yaml.safe_load(f)


def _admit(port: int, obj: dict) -> dict:
    meta = obj.get("metadata") or {}
    group, _, version = obj.get("apiVersion", "v1").rpartition("/")
    body = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": "demo",
                        "kind": {"group": group, "version": version,
                                 "kind": obj.get("kind", "")},
                        "name": meta.get("name", ""),
                        "namespace": meta.get("namespace"),
                        "operation": "CREATE", "object": obj,
                        "userInfo": {"username": "demo-user"}}}
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/admit", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        out = json.load(resp)
    assert out["response"]["uid"] == "demo"
    return out["response"]


def test_basic_demo_walkthrough_over_http():
    """demo/basic/demo.py's steps through the port's Manager: sync
    config, a pre-policy namespace, the required-labels and unique-label
    policies, good and bad namespaces and malformed Gatekeeper resources
    admitted over HTTP (kubectl-apply style: allowed objects land in the
    cluster), then one audit sweep.  Five denials, the unique-label
    inventory join's message, and the audit's catch-up of the
    pre-policy namespace."""
    mgr = Manager(parse_args(["--port", "0", "--audit-interval", "3600"]
                             + CPU))
    mgr.start()
    cluster, port = mgr.cluster, mgr.webhook.port
    denied: dict[str, dict] = {}

    def apply(rel: str) -> None:
        obj = _load(rel)
        resp = _admit(port, obj)
        if resp["allowed"]:
            cluster.create(obj)
        else:
            denied[os.path.basename(rel)] = resp

    def settle(pred) -> None:
        assert _wait_for(pred, 30)

    try:
        cluster.create(_load("sync.yaml"))
        cluster.create({"apiVersion": "v1", "kind": "Namespace",
                        "metadata": {"name": "no-label"}})
        settle(lambda: mgr.client.dump()[
            "admission.k8s.gatekeeper.sh"]["data"])
        for rel in ("templates/k8srequiredlabels_template.yaml",
                    "constraints/all_ns_must_have_gatekeeper.yaml"):
            cluster.create(_load(rel))
            settle(lambda: mgr.client.constraints.get("K8sRequiredLabels")
                   if rel.startswith("constraints") else
                   "K8sRequiredLabels" in mgr.client.templates)
        apply("bad/bad_ns.yaml")
        apply("good/good_ns.yaml")
        settle(lambda: len(mgr.client.dump()[
            "admission.k8s.gatekeeper.sh"]["data"]) >= 1
            and "payments" in json.dumps(mgr.client.dump(), default=str))
        cluster.create(_load("templates/k8suniquelabel_template.yaml"))
        settle(lambda: "K8sUniqueLabel" in mgr.client.templates)
        cluster.create(_load("constraints/all_ns_gatekeeper_label_unique"
                             ".yaml"))
        settle(lambda: mgr.client.constraints.get("K8sUniqueLabel"))
        apply("good/no_dupe_ns.yaml")
        apply("bad/no_dupe_ns_2.yaml")
        for rel in ("bad/bad_template.yaml", "bad/bad_schema.yaml",
                    "bad/bad_constraint_labelselector.yaml"):
            apply(rel)
        report = mgr.audit.audit_once()
        con = _load("constraints/all_ns_must_have_gatekeeper.yaml")
        obj = cluster.get(gvk_of_constraint(con), "ns-must-have-gk")
    finally:
        mgr.stop()
    assert sorted(denied) == sorted(
        ["bad_ns.yaml", "no_dupe_ns_2.yaml", "bad_template.yaml",
         "bad_schema.yaml", "bad_constraint_labelselector.yaml"])
    assert denied["bad_ns.yaml"]["status"]["code"] == 403
    assert "[denied by ns-must-have-gk]" in \
        denied["bad_ns.yaml"]["status"]["message"]
    dup = denied["no_dupe_ns_2.yaml"]["status"]
    assert dup["code"] == 403
    assert "[denied by ns-gk-label-unique]" in dup["message"]
    assert "already taken by namespace" in dup["message"]
    for name in ("bad_template.yaml", "bad_schema.yaml",
                 "bad_constraint_labelselector.yaml"):
        assert denied[name]["status"]["code"] == 422, denied[name]
    assert report["skipped"] is False
    names = {v.get("name") for v in obj["status"].get("violations", [])}
    assert "no-label" in names


# ---------------------------------------------------------------------------
# the entry point, the device, the trims


def test_module_demo_runs_in_a_subprocess():
    """``python -m gatekeeper_tpu_torch.cmd.manager --demo --device cpu``
    seeds demo/basic at 1,000 namespaces, sweeps once, prints the
    report: 20 capped status violations."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("GATEKEEPER_SNAPSHOT_DIR",
                        "GATEKEEPER_FLIGHT_ADMISSION")}
    out = subprocess.run([sys.executable, "-m",
                          "gatekeeper_tpu_torch.cmd.manager", "--demo",
                          "--device", "cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    doc = json.loads(out.stdout[out.stdout.index("{"):])
    assert doc["status_violations"] == 20
    assert doc["sweep"]["violations"] == 20
    assert doc["audit_timestamp"]


def test_device_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    assert parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Manager(parse_args(["--port", "-1"]))


@pytest.mark.parametrize("argv, env, item", [
    ([], {"GATEKEEPER_SNAPSHOT_DIR": "snapshots"}, "ROADMAP A8"),
    ([], {"GATEKEEPER_FAULT": "device_lost"}, "ROADMAP A8"),
])
def test_unported_flags_and_variables_raise(argv, env, item, monkeypatch,
                                            tmp_path):
    """The variables ROADMAP A8 brought are accepted as the reference
    accepts them: the manager builds its driver, and its demo sweep
    holds the reference's 20 capped status violations.  Under
    GATEKEEPER_SNAPSHOT_DIR the sweep persists the store there; with
    ``device_lost`` armed the device is lost mid-sweep, the sweep
    completes on the scalar oracle and reports the device degraded.
    The test keeps the name, and ``item`` the case ids, it had while
    the port refused these variables; nothing raises now."""
    from gatekeeper_tpu_torch.resilience import faults
    from gatekeeper_tpu_torch.resilience import snapshot as snap
    from gatekeeper_tpu_torch.resilience import supervisor as tsup
    monkeypatch.setenv("GATEKEEPER_SUPERVISOR_REPROBE", "0")
    for k, v in env.items():
        monkeypatch.setenv(k, str(tmp_path / v) if k.endswith("_DIR")
                           else v)
    tsup.reset_for_tests()
    faults.reset_for_tests()
    try:
        mgr = Manager(parse_args(["--port", "-1"] + CPU + argv))
        assert isinstance(mgr.client.driver, TorchDriver)
        out = run_demo(mgr, n_namespaces=40)
        assert out["status_violations"] == 20
        if "GATEKEEPER_SNAPSHOT_DIR" in env:
            assert out["sweep"]["backend_state"] == "healthy"
            assert snap.load_store(
                "admission.k8s.gatekeeper.sh") is not None
        else:
            assert out["sweep"]["backend_state"] == "degraded"
            assert "device_lost" in out["sweep"]["degraded_reason"]
    finally:
        tsup.reset_for_tests()
        faults.reset_for_tests()


def test_kubeconfig_builds_a_kube_cluster(tmp_path, monkeypatch):
    """``--kubeconfig`` binds the manager to a real apiserver through
    cluster/kube.py (here the HTTP stub of tests/fake_apiserver.py),
    and builds as well under GATEKEEPER_SNAPSHOT_DIR."""
    from gatekeeper_tpu.cluster.fake import FakeCluster as StubCluster
    from gatekeeper_tpu_torch.cluster.kube import KubeCluster
    from tests.fake_apiserver import FakeApiServer
    from gatekeeper_tpu.api.config import GVK as StubGVK
    fc = StubCluster()
    fc.register_kind(StubGVK("apiextensions.k8s.io", "v1beta1",
                             "CustomResourceDefinition"),
                     "customresourcedefinitions")
    stub = FakeApiServer(fc).start()
    path = tmp_path / "kubeconfig"
    path.write_text(yaml.safe_dump({
        "current-context": "c",
        "contexts": [{"name": "c", "context": {"cluster": "c", "user": "u"}}],
        "clusters": [{"name": "c", "cluster": {"server": stub.url + "/"}}],
        "users": [{"name": "u", "user": {"token": "t"}}]}))
    try:
        mgr = Manager(parse_args(["--kubeconfig", str(path), "--port", "-1"]
                                 + CPU))
        mgr.cluster.close()
        assert isinstance(mgr.cluster, KubeCluster) and mgr.async_cluster
        assert mgr.cluster._server == stub.url
        assert mgr.cluster._headers == {"Authorization": "Bearer t"}
        with monkeypatch.context() as m:
            m.setenv("GATEKEEPER_SNAPSHOT_DIR", str(tmp_path / "snaps"))
            mgr = Manager(parse_args(["--kubeconfig", str(path), "--port",
                                      "-1"] + CPU))
            mgr.cluster.close()
            assert isinstance(mgr.cluster, KubeCluster)
    finally:
        stub.stop()


def _namespace_review(name: str) -> dict:
    return {"uid": "u1", "kind": {"group": "", "version": "v1",
                                  "kind": "Namespace"},
            "operation": "CREATE", "name": name,
            "userInfo": {"username": "alice", "groups": []},
            "object": {"apiVersion": "v1", "kind": "Namespace",
                       "metadata": {"name": name}}}


def test_engine_worker_url_serves_through_a_worker():
    """``--engine-worker-url`` builds a RemoteDriver to an engine worker
    (here ``EngineWorker`` over ``TorchDriver(device="cpu")`` on a
    thread): the demo flow's statuses and a webhook answer equal the
    in-process manager's, and ``audit_once(full=True)`` runs a forced
    full sweep in the worker."""
    from gatekeeper_tpu_torch.client.remote_driver import (EngineWorker,
                                                           RemoteDriver)
    worker = EngineWorker(lambda: TorchDriver(device="cpu"))
    worker.start()
    try:
        remote = Manager(parse_args(["--port", "-1", "--engine-worker-url",
                                     worker.url]))
        assert isinstance(remote.client.driver, RemoteDriver)
        local = Manager(parse_args(["--port", "-1"] + CPU))
        outs = [run_demo(m, n_namespaces=40) for m in (remote, local)]
        statuses = []
        for m in (remote, local):
            con = m.cluster.get(GVK("constraints.gatekeeper.sh", "v1alpha1",
                                    "K8sRequiredLabels"), "ns-must-have-gk")
            st = dict(con["status"])
            assert st.pop("auditTimestamp")
            statuses.append(st)
        assert statuses[0] == statuses[1]
        assert len(statuses[0]["violations"]) == 20
        req = _namespace_review("unlabelled")
        answer = remote.handler.handle(req)
        assert answer == local.handler.handle(req)
        assert answer["allowed"] is False
        report = remote.audit.audit_once(full=True)
        assert worker.driver.last_sweep_phases["full"] is True
        assert report["violations"] == outs[1]["sweep"]["violations"]
    finally:
        worker.stop()


def test_flight_admission_records_the_corpus(monkeypatch, tmp_path):
    """``GATEKEEPER_FLIGHT_ADMISSION=1`` builds the manager, and its
    webhook handler persists each admission into the corpus, which
    reads back with the handler's answer."""
    from gatekeeper_tpu_torch.obs import flightrecorder
    from gatekeeper_tpu_torch.obs.flightrecorder import \
        load_admission_corpus
    # a recorder of this test's own: the process-wide one must not keep
    # a capture log open for later tests' handlers
    monkeypatch.setattr(flightrecorder, "_recorder", None)
    monkeypatch.setenv("GATEKEEPER_FLIGHT_ADMISSION", "1")
    monkeypatch.setenv("GATEKEEPER_FLIGHT_DIR", str(tmp_path))
    mgr = Manager(parse_args(["--port", "-1"] + CPU))
    run_demo(mgr, n_namespaces=4)
    out = mgr.handler.handle(_namespace_review("corpus-ns"))
    events = [e for e in load_admission_corpus(str(tmp_path))
              if e["request"]["name"] == "corpus-ns"]
    assert len(events) == 1
    assert events[0]["allowed"] is out["allowed"] is False
    assert [v["name"] for v in events[0]["verdicts"]] == ["ns-must-have-gk"]


def test_main_sets_no_snapshot_dir(monkeypatch, capsys, tmp_path):
    """``main`` turns warm-restart snapshots on by default, as the
    reference's does: GATEKEEPER_SNAPSHOT_DIR becomes
    ``<cache_root>/snapshots``; one set by the caller (an empty one
    disables them) is left alone.  The test keeps the name it had while
    the port's ``main`` set none."""
    from gatekeeper_tpu_torch.cmd import manager as cmd
    monkeypatch.setenv("GATEKEEPER_TORCH_CACHE_DIR", str(tmp_path))
    # setenv then delenv: monkeypatch records the variable's absence, so
    # the value ``main`` writes is removed at teardown, not leaked into
    # the rest of the process.
    monkeypatch.setenv("GATEKEEPER_SNAPSHOT_DIR", "")
    monkeypatch.delenv("GATEKEEPER_SNAPSHOT_DIR")
    monkeypatch.setattr(cmd, "run_demo", lambda mgr: {"ok": True})
    assert cmd.main(["--demo", "--port", "-1"] + CPU) == 0
    assert os.environ["GATEKEEPER_SNAPSHOT_DIR"] == \
        os.path.join(str(tmp_path), "snapshots")
    assert json.loads(capsys.readouterr().out) == {"ok": True}
    monkeypatch.setenv("GATEKEEPER_SNAPSHOT_DIR", "")
    assert cmd.main(["--demo", "--port", "-1"] + CPU) == 0
    assert os.environ["GATEKEEPER_SNAPSHOT_DIR"] == ""
    capsys.readouterr()


def test_reactor_under_pages_and_the_provider_kind_served(monkeypatch):
    """With GATEKEEPER_PAGES on (the default) the manager builds an event
    reactor and attaches it to the audit manager, as the reference does;
    with pages off it builds none.  Its sweeps take the paged route.  The
    Provider kind is served and its CRD applied, and the manager's
    external-data runtime is the process-global one, as the reference's
    cmd/manager.py installs it."""
    from gatekeeper_tpu_torch.enforce.reactor import Reactor
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    assert Manager(parse_args(["--port", "-1"] + CPU)).reactor is None
    monkeypatch.delenv("GATEKEEPER_PAGES")
    mgr = Manager(parse_args(["--port", "-1"] + CPU))
    assert isinstance(mgr.reactor, Reactor)
    assert mgr.audit._reactor is mgr.reactor
    assert mgr.reactor._apply_objects is False
    from gatekeeper_tpu_torch.externaldata.runtime import get_runtime
    assert mgr.cluster.kind_served(
        GVK("externaldata.gatekeeper.sh", "v1beta1", "Provider"))
    assert mgr.cluster.try_get(
        GVK("apiextensions.k8s.io", "v1", "CustomResourceDefinition"),
        "providers.externaldata.gatekeeper.sh") is not None
    assert get_runtime() is mgr.external_data is mgr.plane.external_data
    assert mgr.plane.provider_controller is not None
    out = run_demo(mgr, n_namespaces=40)
    assert out["sweep"]["pages"]["enabled"] is True
    assert out["sweep"]["pages"]["kinds_paged"] == 1


EXT_SIG = """package k8sextsig
violation[{"msg": msg}] {
  image := input.review.object.spec.image
  verdict := object.get(external_data({"provider": "sig-prov", "keys": [image]}), ["responses", image], "missing")
  verdict == "invalid"
  msg := sprintf("image %v rejected: %v", [image, verdict])
}
"""


def test_manager_serves_external_data_through_a_provider(monkeypatch):
    """A Provider object created in the manager's cluster is registered
    into its runtime by the provider controller; a template calling
    ``external_data`` then audits on the device path (statuses name the
    pods whose image the provider marks invalid, fetched in one batched
    round) and admits (403 for an invalid image, allowed for a valid
    one)."""
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    from gatekeeper_tpu_torch.externaldata.fake import (FakeProvider,
                                                        clear_fakes,
                                                        register_fake)
    from gatekeeper_tpu_torch.externaldata.runtime import (get_runtime,
                                                           set_runtime)
    prev = get_runtime()
    fake = register_fake("sig", FakeProvider(
        {f"img-{i}": ("invalid" if i % 4 == 0 else "valid")
         for i in range(8)}))
    try:
        mgr = Manager(parse_args(["--port", "-1"] + CPU))
        cluster = mgr.cluster
        cluster.create({"apiVersion": "externaldata.gatekeeper.sh/v1beta1",
                        "kind": "Provider", "metadata": {"name": "sig-prov"},
                        "spec": {"url": "fake://sig",
                                 "failurePolicy": "Ignore",
                                 "caching": {"ttlSeconds": 600}}})
        cfg = {"apiVersion": "config.gatekeeper.sh/v1alpha1",
               "kind": "Config", "metadata": {
                   "name": "config", "namespace": "gatekeeper-system"},
               "spec": {"sync": {"syncOnly": [
                   {"group": "", "version": "v1", "kind": "Pod"}]}}}
        cluster.create(cfg)
        cluster.create({
            "apiVersion": "templates.gatekeeper.sh/v1alpha1",
            "kind": "ConstraintTemplate",
            "metadata": {"name": "k8sextsig"},
            "spec": {"crd": {"spec": {"names": {"kind": "K8sExtSig"}}},
                     "targets": [{"target": "admission.k8s.gatekeeper.sh",
                                  "rego": EXT_SIG}]}})
        mgr.plane.run_until_idle()
        assert mgr.external_data.provider_names() == ["sig-prov"]
        cluster.create({"apiVersion": "constraints.gatekeeper.sh/v1alpha1",
                        "kind": "K8sExtSig",
                        "metadata": {"name": "sig-check"},
                        "spec": {"match": {"kinds": [
                            {"apiGroups": [""], "kinds": ["Pod"]}]}}})
        for i in range(12):
            cluster.create({"apiVersion": "v1", "kind": "Pod",
                            "metadata": {"name": f"p{i:02d}",
                                         "namespace": "default"},
                            "spec": {"image": f"img-{i % 8}"}})
        mgr.plane.run_until_idle()
        calls = fake.calls
        mgr.audit.audit_once()
        assert fake.calls - calls == 1
        con = cluster.get(GVK("constraints.gatekeeper.sh", "v1alpha1",
                              "K8sExtSig"), "sig-check")
        names = sorted(v["name"] for v in con["status"]["violations"])
        assert names == ["p00", "p04", "p08"]
        answers = []
        for image in ("img-4", "img-5"):
            resp = mgr.handler.handle({
                "uid": "u", "kind": {"group": "", "version": "v1",
                                     "kind": "Pod"},
                "operation": "CREATE", "name": "new", "namespace": "default",
                "userInfo": {"username": "alice", "groups": []},
                "object": {"apiVersion": "v1", "kind": "Pod",
                           "metadata": {"name": "new",
                                        "namespace": "default"},
                           "spec": {"image": image}}})
            answers.append((resp["allowed"],
                            (resp.get("status") or {}).get("code")))
        assert answers == [(False, 403), (True, 200)]
        mgr.stop()
    finally:
        set_runtime(prev)
        clear_fakes()
