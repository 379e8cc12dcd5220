"""The port's real-apiserver adapter (cluster/kube.py) against the
reference's, over the HTTP apiserver stub (tests/fake_apiserver.py).

The seven flows of tests/test_kube_cluster.py: protocol conformance,
CRUD with the error mapping, namespaced objects, discovery and its
refresh after a CRD, watch streams, the demo flow through ``Manager``
with ``--kubeconfig``, and TLS serving with the webhook's bootstrap.
Each flow runs on the port's KubeCluster and on the reference's (each
over a stub of its own), and where the flow has no HTTP in it on the
port's FakeCluster used directly: the outcomes (values, error classes,
events) are equal.  One more flow runs the port's manager with
``--kubeconfig`` and its event reactor, whose subscriptions ride the
stub's HTTP watch streams: an update made through the apiserver reaches
the verdict ledger with no sweep, equal to a pages-off oracle.
"""

import copy
import json
import ssl
import time
import urllib.request

import pytest
import yaml

from gatekeeper_tpu.api.config import GVK as JGVK
from gatekeeper_tpu.cluster.fake import FakeCluster as JFake
from gatekeeper_tpu.cluster.kube import KubeCluster as JKube
from gatekeeper_tpu.cluster.protocol import Cluster as JCluster

from gatekeeper_tpu_torch.api.config import GVK as TGVK
from gatekeeper_tpu_torch.client.client import Backend
from gatekeeper_tpu_torch.cluster.fake import FakeCluster as TFake
from gatekeeper_tpu_torch.cluster.kube import KubeCluster as TKube
from gatekeeper_tpu_torch.cluster.protocol import Cluster as TCluster
from gatekeeper_tpu_torch.cmd.manager import Manager, parse_args, run_demo
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.enforce.reactor import Reactor
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
from tests.fake_apiserver import FakeApiServer

CRD = ("apiextensions.k8s.io", "v1beta1", "CustomResourceDefinition")
DEADLINE_S = 30.0


def _registered(fc, gvk):
    fc.register_kind(gvk("", "v1", "Namespace"), "namespaces")
    fc.register_kind(gvk("", "v1", "Pod"), "pods")
    fc.register_kind(gvk(*CRD), "customresourcedefinitions")
    return fc


@pytest.fixture
def sides():
    """side -> (cluster, GVK class): the port's and the reference's
    KubeCluster, each over a stub of its own, and the port's FakeCluster
    used directly."""
    stubs = [FakeApiServer(_registered(JFake(), JGVK)).start()
             for _ in range(2)]
    out = {"ref": (JKube({"server": stubs[0].url, "ssl": None,
                          "headers": {}}, watch_backoff=0.05), JGVK),
           "port": (TKube({"server": stubs[1].url, "ssl": None,
                           "headers": {}}, watch_backoff=0.05), TGVK),
           "direct": (_registered(TFake(), TGVK), TGVK)}
    out["stubs"] = stubs
    yield out
    for kc in (out["ref"][0], out["port"][0]):
        kc.close()
    for s in stubs:
        s.stop()


def ns(name, labels=None, rv=None):
    obj = {"apiVersion": "v1", "kind": "Namespace",
           "metadata": {"name": name, "labels": labels or {}}}
    if rv is not None:
        obj["metadata"]["resourceVersion"] = rv
    return obj


def _outcome(fn):
    """A call's value, or the class name of what it raised."""
    try:
        return ("ok", fn())
    except Exception as e:      # noqa: BLE001 — compared across sides
        return ("raised", type(e).__name__)


def wait_for(cond, what: str, timeout: float = DEADLINE_S,
             state=lambda: "") -> None:
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, \
            f"{what}: no progress {state()}"
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# CRUD, discovery


def test_protocol_conformance(sides):
    assert isinstance(sides["port"][0], TCluster)
    assert isinstance(sides["ref"][0], JCluster)
    assert isinstance(sides["direct"][0], TCluster)


def crud(kc, gvk) -> list:
    nsg = gvk("", "v1", "Namespace")
    out = []
    created = kc.create(ns("alpha", {"env": "prod"}))
    out.append(bool(created["metadata"]["resourceVersion"]))
    out.append(_outcome(lambda: kc.create(ns("alpha"))))
    got = kc.get(nsg, "alpha")
    out.append(got["metadata"]["labels"])
    # conflict on a stale resourceVersion (optimistic concurrency)
    out.append(_outcome(lambda: kc.update(ns("alpha", {"env": "dev"},
                                             rv="999999"))))
    fresh = copy.deepcopy(got)
    fresh["metadata"]["labels"] = {"env": "dev"}
    out.append(kc.update(fresh)["metadata"]["labels"])
    out.append(kc.try_get(nsg, "missing"))
    out.append(_outcome(lambda: kc.get(nsg, "missing")))
    kc.delete(nsg, "alpha")
    out.append(kc.try_get(nsg, "alpha"))
    out.append(_outcome(lambda: kc.delete(nsg, "alpha")))
    return out


def namespaced(kc, gvk) -> list:
    podg = gvk("", "v1", "Pod")
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": "p1", "namespace": "default"},
           "spec": {"containers": []}}
    kc.create(pod)
    out = [kc.get(podg, "p1", "default")["metadata"]["namespace"],
           [o["metadata"]["name"] for o in kc.list(podg)],
           [o["kind"] for o in kc.list(podg)]]
    kc.delete(podg, "p1", "default")
    out.append(kc.list(podg))
    return out


@pytest.mark.parametrize("flow", [crud, namespaced],
                         ids=["crud_and_error_mapping", "namespaced"])
def test_flow_equals_the_reference_and_the_fake(sides, flow):
    got = {side: flow(*sides[side]) for side in ("ref", "port", "direct")}
    assert got["port"] == got["ref"]
    assert got["port"] == got["direct"]
    if flow is crud:
        assert got["port"][1] == ("raised", "AlreadyExistsError")
        assert got["port"][3] == ("raised", "ApiConflictError")
        assert got["port"][6] == ("raised", "NotFoundError")


def test_discovery(sides):
    got = {}
    for side in ("ref", "port"):
        kc, gvk = sides[side]
        got[side] = (
            kc.kind_served(gvk("", "v1", "Namespace")),
            kc.kind_served(gvk("nope.io", "v1", "Gone")),
            kc.server_resources_for_group_version("v1"),
            _outcome(lambda: kc.server_resources_for_group_version(
                "nope.io/v1")))
    assert got["port"] == got["ref"]
    assert got["port"][:2] == (True, False)
    assert {"kind": "Namespace", "name": "namespaces"} in got["port"][2]
    assert got["port"][3] == ("raised", "NotFoundError")
    direct = sides["direct"][0]
    assert direct.kind_served(TGVK("", "v1", "Namespace"))
    assert not direct.kind_served(TGVK("nope.io", "v1", "Gone"))


def test_discovery_refreshes_after_crd(sides):
    """A kind served only after CRD creation is discoverable without
    restarting the adapter (the watch manager's pending-CRD poll)."""
    for side in ("ref", "port"):
        kc, gvk = sides[side]
        widget = gvk("example.com", "v1", "Widget")
        assert not kc.kind_served(widget)
        kc.create({"apiVersion": "apiextensions.k8s.io/v1beta1",
                   "kind": "CustomResourceDefinition",
                   "metadata": {"name": "widgets.example.com"},
                   "spec": {"group": "example.com", "version": "v1",
                            "names": {"kind": "Widget",
                                      "plural": "widgets"}}})

        def served():
            kc._invalidate("example.com/v1")
            return kc.kind_served(widget)
        wait_for(served, f"{side}: discovery of the new kind")


# ---------------------------------------------------------------------------
# watch streams


def watch_flow(kc, gvk) -> list:
    """Sentinel creates until the stream is up, then one create and one
    delete: the (type, name) of the events after the sentinels."""
    nsg = gvk("", "v1", "Namespace")
    events = []
    unsub = kc.watch(nsg, events.append)
    try:
        i = 0
        t0 = time.monotonic()
        while not events:
            assert time.monotonic() - t0 < DEADLINE_S, "no watch stream"
            kc.create(ns(f"sentinel{i}"))
            i += 1
            time.sleep(0.1)
        kc.create(ns("w1"))
        kc.delete(nsg, "w1")
        wait_for(lambda: any(e.type == "DELETED" for e in events),
                 "the DELETED event")
    finally:
        unsub()
    return [(e.type, e.obj["metadata"]["name"]) for e in events
            if not e.obj["metadata"]["name"].startswith("sentinel")]


def test_watch_stream_delivers_events(sides):
    got = {side: watch_flow(*sides[side])
           for side in ("ref", "port", "direct")}
    assert got["port"] == got["ref"] == got["direct"] == \
        [("ADDED", "w1"), ("DELETED", "w1")]


# ---------------------------------------------------------------------------
# the manager on a KubeCluster


def kubeconfig(tmp_path, url: str) -> str:
    path = tmp_path / "kubeconfig"
    path.write_text(yaml.safe_dump({
        "apiVersion": "v1", "kind": "Config", "current-context": "stub",
        "contexts": [{"name": "stub",
                      "context": {"cluster": "stub", "user": "stub"}}],
        "clusters": [{"name": "stub", "cluster": {"server": url}}],
        "users": [{"name": "stub", "user": {"token": "t"}}]}))
    return str(path)


def test_demo_flow_through_the_kubeconfig(sides, tmp_path):
    """demo/basic (template -> CRD -> constraint -> sync config ->
    resources -> audit -> statuses) through the port's Manager built
    from ``--kubeconfig``: the statuses it writes into the apiserver
    equal the reference Manager's over its own KubeCluster."""
    from gatekeeper_tpu.cmd import manager as ref
    from gatekeeper_tpu.externaldata import runtime
    statuses = []
    prev = runtime.get_runtime()
    try:
        ref_mgr = ref.Manager(ref.parse_args(
            ["--port", "-1", "--audit-interval", "3600"]),
            cluster=sides["ref"][0])
        ref.run_demo(ref_mgr, n_namespaces=40)
    finally:
        runtime.set_runtime(prev)
    mgr = Manager(parse_args([
        "--kubeconfig", kubeconfig(tmp_path, sides["stubs"][1].url),
        "--port", "-1", "--audit-interval", "3600", "--device", "cpu"]))
    assert isinstance(mgr.cluster, TKube) and mgr.async_cluster
    assert mgr.reactor is not None              # pages on, the default
    try:
        out = run_demo(mgr, n_namespaces=40)
    finally:
        mgr.cluster.close()
    assert out["status_violations"] == 20 and out["audit_timestamp"]
    for stub in sides["stubs"]:
        con = stub.cluster.get(JGVK("constraints.gatekeeper.sh", "v1alpha1",
                                    "K8sRequiredLabels"), "ns-must-have-gk")
        st = dict(con["status"])
        assert st.pop("auditTimestamp")
        statuses.append(st)
    assert statuses[1] == statuses[0]


def test_reactor_events_ride_the_http_watch(sides, tmp_path, monkeypatch):
    """The manager started on a KubeCluster: its reactor attaches to the
    synced Pod kind through the stub's HTTP watch stream, and an update
    made through the apiserver reaches the ledger with no sweep; the
    ledger then equals a pages-off oracle over the apiserver's objects."""
    from gatekeeper_tpu_torch.library import all_docs
    from gatekeeper_tpu_torch.library import make_mixed
    import random
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.setenv("GATEKEEPER_PAGES", "on")
    monkeypatch.setenv("GATEKEEPER_PAGE_ROWS", "8")
    stub = sides["stubs"][1]
    stub.cluster.register_kind(JGVK("apps", "v1", "Deployment"),
                               "deployments")
    mgr = Manager(parse_args([
        "--kubeconfig", kubeconfig(tmp_path, stub.url), "--port", "-1",
        "--audit-interval", "3600", "--device", "cpu",
        "--watch-poll-interval", "0.2"]))
    kc = mgr.cluster
    rx: Reactor = mgr.reactor
    mgr.start()
    try:
        kc.create({"apiVersion": "config.gatekeeper.sh/v1alpha1",
                   "kind": "Config",
                   "metadata": {"name": "config",
                                "namespace": "gatekeeper-system"},
                   "spec": {"sync": {"syncOnly": [
                       {"group": "", "version": "v1", "kind": "Pod"}]}}})
        docs = [(t, c) for t, c in all_docs()
                if t["spec"]["crd"]["spec"]["names"]["kind"]
                == "K8sAllowedRepos"]
        for t, c in docs:
            kc.create(copy.deepcopy(t))
        con_gvk = TGVK("constraints.gatekeeper.sh", "v1alpha1",
                       "K8sAllowedRepos")

        def served():
            kc._invalidate(con_gvk.group_version)
            return kc.kind_served(con_gvk)
        wait_for(served, "the constraint kind's CRD")
        for t, c in docs:
            kc.create(copy.deepcopy(c))
        pods = [o for o in make_mixed(random.Random(5), 60)
                if o["kind"] == "Pod"][:12]
        for p in pods:
            kc.create(copy.deepcopy(p))
        st = mgr.client.driver.state["admission.k8s.gatekeeper.sh"]
        wait_for(lambda: st.table.n_rows == len(pods)
                 and "Pod" in rx._subs and mgr.client.constraints
                 and not mgr.plane.mgr._queue, "the ingest")
        wait_for(lambda: all(k["pending"] == 0 for k in
                             rx.state_payload()["kinds"].values()),
                 "the reactor's list events")
        mgr.audit.audit_once()                  # the cold ledger build
        led = st.ledger
        seen = []
        led.subscribe(seen.append)
        victim = pods[0]["metadata"]
        obj = kc.get(TGVK("", "v1", "Pod"), victim["name"],
                     victim["namespace"])
        obj["spec"]["containers"][0]["image"] = "evil.io/through-http:1"
        rung1 = rx.counters["rung1"]
        kc.update(obj)
        wait_for(lambda: any(e["op"] == "appear"
                             and e["resource"].endswith(victim["name"])
                             for e in seen), "the appear event",
                 state=lambda: (dict(rx.counters), rx.state, rx.error,
                                len(seen)))
        assert rx.counters["rung1"] > rung1
        assert rx.state == "live" and rx.error is None
        assert mgr.audit.last_sweep["timestamp"]    # only the cold sweep
        got = sorted((kind, cname, ident[1], r.msg)
                     for kind, ent in led.entries.items()
                     for _row, (ident, by_c) in ent.rows.items()
                     for cname, rs in by_c.items() for r in rs)
        oracle = Backend(TorchDriver(device="cpu")).new_client(
            [K8sValidationTarget()])
        for t, c in docs:
            oracle.add_template(t)
            oracle.add_constraint(kc.get(con_gvk, c["metadata"]["name"]))
        oracle.add_data_batch(kc.list(TGVK("", "v1", "Pod")))
        monkeypatch.setenv("GATEKEEPER_PAGES", "off")
        want = sorted((r.constraint["kind"],
                       r.constraint["metadata"]["name"],
                       r.resource["metadata"]["name"], r.msg)
                      for r in oracle.audit().results())
        assert got == want and any(v[2] == victim["name"] for v in got)
    finally:
        mgr.stop()
        kc.close()


# ---------------------------------------------------------------------------
# TLS serving and the webhook's self-registration


def test_https_serving_and_bootstrap(sides, tmp_path):
    """TLS serving from a cert dir (policy.go:76-79) and the
    self-registration of secret, service and VWC (policy.go:81-100),
    written through each side's KubeCluster: the same webhook entry."""
    from gatekeeper_tpu.webhook import bootstrap as jboot
    from gatekeeper_tpu_torch.client.local_driver import LocalDriver
    from gatekeeper_tpu_torch.webhook.bootstrap import (VWC_GVK,
                                                        bootstrap_webhook,
                                                        ensure_certs)
    from gatekeeper_tpu_torch.webhook.policy import ValidationHandler
    from gatekeeper_tpu_torch.webhook.server import WebhookServer

    cert_dir = str(tmp_path / "certs")
    ca = ensure_certs(cert_dir)
    assert ca and ca.startswith("-----BEGIN CERTIFICATE")
    client = Backend(LocalDriver()).new_client([K8sValidationTarget()])
    srv = WebhookServer(ValidationHandler(client), port=0, cert_dir=cert_dir)
    assert srv.tls
    srv.start()
    try:
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        body = {"apiVersion": "admission.k8s.io/v1beta1",
                "kind": "AdmissionReview",
                "request": {"uid": "u1",
                            "kind": {"group": "", "version": "v1",
                                     "kind": "Pod"},
                            "name": "p", "operation": "CREATE",
                            "object": {"apiVersion": "v1", "kind": "Pod",
                                       "metadata": {"name": "p"}},
                            "userInfo": {"username": "t"}}}
        req = urllib.request.Request(
            f"https://127.0.0.1:{srv.port}/v1/admit",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, context=ctx) as resp:
            out = json.loads(resp.read())
        assert out["response"]["allowed"] is True
    finally:
        srv.stop()
    hooks = []
    for side, boot in (("ref", jboot.bootstrap_webhook),
                       ("port", bootstrap_webhook)):
        kc, gvk = sides[side]
        stub = sides["stubs"][0 if side == "ref" else 1]
        stub.cluster.register_kind(JGVK("", "v1", "Secret"), "secrets")
        stub.cluster.register_kind(JGVK("", "v1", "Service"), "services")
        stub.cluster.register_kind(jboot.VWC_GVK,
                                   "validatingwebhookconfigurations")
        for _ in range(2):                      # create, then the update
            assert boot(kc, cert_dir, srv.port)
        vwc = kc.get(gvk(VWC_GVK.group, VWC_GVK.version, VWC_GVK.kind),
                     "validation.gatekeeper.sh")
        hook = vwc["webhooks"][0]
        assert hook["clientConfig"]["caBundle"]
        hooks.append({k: v for k, v in hook.items() if k != "clientConfig"}
                     | {"service": hook["clientConfig"]["service"]})
    assert hooks[1] == hooks[0]
    assert hooks[1]["service"]["path"] == "/v1/admit"
    assert hooks[1]["rules"][0]["operations"] == ["CREATE", "UPDATE"]
