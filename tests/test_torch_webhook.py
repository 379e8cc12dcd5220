"""The port's webhook against the reference: the 20 flows of
tests/test_webhook.py (Handle semantics, enforcementAction routing, the
micro-batcher, HTTP, /metrics and the server's hardening) on the port's
ValidationHandler and WebhookServer over its LocalDriver and
TorchDriver(device="cpu"); a parity sequence of the basic and agilebank
demo YAMLs through the port's handler and the reference's (JaxDriver on
the CPU), equal field for field; the port's trims (/healthz, the
refused admission corpus); and the endpoints under admission load.
"""

import collections
import copy
import glob
import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest
import yaml

from gatekeeper_tpu_torch.client.client import Backend
from gatekeeper_tpu_torch.client.local_driver import LocalDriver
from gatekeeper_tpu_torch.cluster.fake import FakeCluster
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.errors import ClientError
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
from gatekeeper_tpu_torch.webhook.batcher import MicroBatcher
from gatekeeper_tpu_torch.webhook.policy import ValidationHandler
from gatekeeper_tpu_torch.webhook.server import WebhookServer
from tests.test_control_plane import (constraint_obj, ns_obj, template_obj)


def review_request(obj, operation="CREATE", user="alice", old=None,
                   kind=None):
    k = kind or {"group": "", "version": "v1", "kind": obj.get("kind", "")}
    req = {"uid": "u1", "kind": k, "operation": operation,
           "name": (obj.get("metadata") or {}).get("name", ""),
           "userInfo": {"username": user, "groups": []},
           "object": obj}
    if old is not None:
        req["oldObject"] = old
    return req


@pytest.fixture(params=["local", "torch"])
def handler(request, monkeypatch):
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    driver = LocalDriver() if request.param == "local" \
        else TorchDriver(device="cpu")
    client = Backend(driver).new_client([K8sValidationTarget()])
    client.add_template(template_obj())
    client.add_constraint(constraint_obj())
    return ValidationHandler(client)


class TestHandle:
    def test_deny_and_allow(self, handler):
        resp = handler.handle(review_request(ns_obj("bad")))
        assert resp["allowed"] is False
        assert resp["status"]["code"] == 403
        assert "[denied by ns-must-have-gk]" in resp["status"]["message"]
        assert "you must provide labels" in resp["status"]["message"]

        resp = handler.handle(review_request(
            ns_obj("good", {"gatekeeper": "on"})))
        assert resp["allowed"] is True

    def test_self_skip(self, handler):
        req = review_request(ns_obj("bad"))
        req["userInfo"]["groups"] = ["system:serviceaccounts:gatekeeper-system"]
        resp = handler.handle(req)
        assert resp["allowed"] is True
        assert "self-manage" in resp["status"]["message"]

    def test_delete_uses_old_object(self, handler):
        # DELETE without oldObject -> 500 (apiserver too old)
        req = review_request(ns_obj("bad"), operation="DELETE")
        req["object"] = None
        resp = handler.handle(req)
        assert resp["allowed"] is False and resp["status"]["code"] == 500

        # DELETE with violating oldObject -> denied
        req = review_request(ns_obj("x"), operation="DELETE",
                             old=ns_obj("bad"))
        req["object"] = None
        resp = handler.handle(req)
        assert resp["allowed"] is False and resp["status"]["code"] == 403

    def test_template_validated_synchronously(self, handler):
        good = template_obj(kind="K8sOtherPolicy",
                            rego="package k8sotherpolicy\n"
                                 "violation[{\"msg\": \"no\"}] { 1 > 2 }")
        req = review_request(
            good, kind={"group": "templates.gatekeeper.sh",
                        "version": "v1alpha1", "kind": "ConstraintTemplate"})
        assert handler.handle(req)["allowed"] is True

        bad = template_obj(rego="package foo\nnot valid rego!")
        req = review_request(
            bad, kind={"group": "templates.gatekeeper.sh",
                       "version": "v1alpha1", "kind": "ConstraintTemplate"})
        resp = handler.handle(req)
        assert resp["allowed"] is False and resp["status"]["code"] == 422

    def test_constraint_validated_synchronously(self, handler):
        bad = constraint_obj(name="bad-op")
        bad["spec"]["match"]["labelSelector"] = {
            "matchExpressions": [{"key": "k", "operator": "Bogus"}]}
        req = review_request(
            bad, kind={"group": "constraints.gatekeeper.sh",
                       "version": "v1alpha1", "kind": "K8sRequiredLabels"})
        resp = handler.handle(req)
        assert resp["allowed"] is False and resp["status"]["code"] == 422

    def test_trace_toggles(self, handler):
        logs = []
        handler.log = logs.append
        handler.injected_config = {
            "spec": {"validation": {"traces": [
                {"user": "alice",
                 "kind": {"group": "", "version": "v1", "kind": "Namespace"},
                 "dump": "All"}]}}}
        resp = handler.handle(review_request(ns_obj("bad"), user="alice"))
        assert resp["allowed"] is False
        assert len(logs) == 2  # trace dump + state dump
        assert "Trace" in str(logs[0])

        logs.clear()
        handler.handle(review_request(ns_obj("bad"), user="bob"))
        assert logs == []  # other users don't trace


class TestEnforcementAction:
    """spec.enforcementAction routing (reference webhook semantics):
    deny blocks, warn admits with AdmissionResponse warnings, dryrun
    admits silently — all three still count the violation."""

    @pytest.fixture(params=["local", "torch"])
    def make_handler(self, request, monkeypatch):
        monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)

        def driver():
            return LocalDriver() if request.param == "local" \
                else TorchDriver(device="cpu")

        def make(action=None):
            client = Backend(driver()).new_client([K8sValidationTarget()])
            client.add_template(template_obj())
            con = constraint_obj()
            if action is not None:
                con["spec"]["enforcementAction"] = action
            client.add_constraint(con)
            return ValidationHandler(client)
        return make

    def test_deny_blocks(self, make_handler):
        resp = make_handler("deny").handle(review_request(ns_obj("bad")))
        assert resp["allowed"] is False
        assert resp["status"]["code"] == 403
        assert "warnings" not in resp

    def test_warn_admits_with_warnings(self, make_handler):
        handler = make_handler("warn")
        resp = handler.handle(review_request(ns_obj("bad")))
        assert resp["allowed"] is True
        assert resp["warnings"] == \
            ["[warn by ns-must-have-gk] you must provide labels: "
             "{\"gatekeeper\"}"]
        assert handler.metrics.counter(
            "admission_warn_violations").value == 1
        # a compliant object stays warning-free
        resp = handler.handle(review_request(
            ns_obj("good", {"gatekeeper": "on"})))
        assert resp["allowed"] is True and "warnings" not in resp

    def test_dryrun_admits_silently(self, make_handler):
        handler = make_handler("dryrun")
        resp = handler.handle(review_request(ns_obj("bad")))
        assert resp["allowed"] is True
        assert "warnings" not in resp
        assert handler.metrics.counter(
            "admission_dryrun_violations").value == 1
        assert handler.metrics.counter("admission_denied").value == 0

    def test_unknown_action_fails_closed(self, make_handler):
        resp = make_handler("audit-only").handle(
            review_request(ns_obj("bad")))
        assert resp["allowed"] is False
        assert resp["status"]["code"] == 403

    def test_warn_rides_the_http_envelope(self, make_handler):
        """The warnings list must survive the AdmissionReview envelope
        (k8s surfaces response.warnings to kubectl users)."""
        server = WebhookServer(make_handler("warn"), port=0)
        server.start()
        try:
            body = {"apiVersion": "admission.k8s.io/v1beta1",
                    "kind": "AdmissionReview",
                    "request": review_request(ns_obj("bad"))}
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/v1/admit",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as resp:
                out = json.loads(resp.read())
            assert out["response"]["allowed"] is True
            assert out["response"]["warnings"], out["response"]
            assert "[warn by ns-must-have-gk]" in \
                out["response"]["warnings"][0]
        finally:
            server.stop()


class TestBatcher:
    def test_batches_coalesce(self, handler):
        batcher = MicroBatcher(
            lambda reqs: handler.client.review_batch(reqs),
            max_batch=16, max_wait=0.01)
        handler.batcher = batcher
        handler.batch_mode = "always"   # force coalescing for the test
        batcher.start()
        try:
            results = [None] * 8

            def call(i):
                obj = ns_obj(f"ns{i}") if i % 2 else \
                    ns_obj(f"ns{i}", {"gatekeeper": "on"})
                results[i] = handler.handle(review_request(obj))

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for i, r in enumerate(results):
                assert r["allowed"] is (i % 2 == 0), (i, r)
            assert batcher.metrics.counter("admission_batches").value >= 1
            # coalescing happened: fewer batches than requests
            assert batcher.metrics.counter("admission_batches").value < 8
        finally:
            batcher.stop()


class TestHTTP:
    def test_http_roundtrip(self, handler):
        server = WebhookServer(handler, port=0)
        server.start()
        try:
            body = {"apiVersion": "admission.k8s.io/v1beta1",
                    "kind": "AdmissionReview",
                    "request": review_request(ns_obj("bad"))}
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/v1/admit",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as resp:
                out = json.loads(resp.read())
            assert out["kind"] == "AdmissionReview"
            assert out["response"]["uid"] == "u1"
            assert out["response"]["allowed"] is False
            assert out["response"]["status"]["code"] == 403
        finally:
            server.stop()


class TestMetricsEndpoint:
    def test_metrics_export(self, handler):
        """GET /metrics serves the Prometheus text exposition of the
        shared registry (SURVEY §5: exported counters)."""
        server = WebhookServer(handler, port=0)
        server.start()
        try:
            # generate some admission traffic first
            body = {"apiVersion": "admission.k8s.io/v1beta1",
                    "kind": "AdmissionReview",
                    "request": review_request(ns_obj("bad"))}
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/v1/admit",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req).read()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/metrics") as resp:
                assert resp.headers["Content-Type"].startswith("text/plain")
                text = resp.read().decode()
            assert "# TYPE gatekeeper_admission_seconds_seconds summary" \
                in text or "gatekeeper_admission_seconds" in text
            assert "gatekeeper_admission_denied" in text or \
                "_count" in text
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/v1/admit") as resp:
                pass
        except urllib.error.HTTPError as e:
            assert e.code == 404   # GET on the admit path is not served
        finally:
            server.stop()


class TestHardening:
    """Production hardening (round-3 VERDICT missing #4): request
    timeout, body-size cap, graceful drain.  The reference rides
    controller-runtime's hardened server (policy.go:57-79); these pin
    the same guarantees onto this build's stdlib server."""

    def test_oversized_body_rejected(self, handler):
        server = WebhookServer(handler, port=0, max_body_bytes=1024)
        server.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/v1/admit",
                data=b"x" * 4096,
                headers={"Content-Type": "application/json"})
            try:
                urllib.request.urlopen(req)
                assert False, "oversized body must be rejected"
            except urllib.error.HTTPError as e:
                assert e.code == 413
        finally:
            server.stop()

    def test_chunked_body_rejected(self, handler):
        server = WebhookServer(handler, port=0)
        server.start()
        try:
            import http.client
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=5)
            conn.putrequest("POST", "/v1/admit")
            conn.putheader("Transfer-Encoding", "chunked")
            conn.endheaders()
            conn.send(b"5\r\nhello\r\n0\r\n\r\n")
            resp = conn.getresponse()
            assert resp.status == 411
            conn.close()
        finally:
            server.stop()

    def test_slowloris_connection_cut(self, handler):
        """A client trickling a request must be cut off by the read
        timeout, not hold a handler thread forever."""
        import socket
        server = WebhookServer(handler, port=0, request_timeout=0.5)
        server.start()
        try:
            s = socket.create_connection(("127.0.0.1", server.port),
                                         timeout=5)
            s.sendall(b"POST /v1/admit HTTP/1.1\r\nHost: x\r\n")
            # never finish the headers; server must close within ~0.5s
            s.settimeout(5)
            t0 = time.monotonic()
            got = s.recv(1024)     # b"" == closed by server
            elapsed = time.monotonic() - t0
            assert got == b""
            assert elapsed < 4, f"connection lingered {elapsed:.1f}s"
            s.close()
        finally:
            server.stop()

    def test_slowloris_trickling_body_cut_at_deadline(self, handler):
        """A client that keeps the connection LIVELY — one byte at a
        time, never idle — must still be cut off by the wall-clock body
        deadline (_DeadlineBody); the idle timeout alone never fires
        for this client (round-4 advisor finding)."""
        import socket
        server = WebhookServer(handler, port=0, request_timeout=1.0)
        server.start()
        try:
            s = socket.create_connection(("127.0.0.1", server.port),
                                         timeout=5)
            s.sendall(b"POST /v1/admit HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Length: 10000\r\n\r\n")
            t0 = time.monotonic()
            cut = None
            for _ in range(200):           # ~0.05s per byte: never idle
                try:
                    s.sendall(b"x")
                except OSError:
                    cut = time.monotonic() - t0
                    break
                time.sleep(0.05)
                # the server closing only surfaces on send on some
                # platforms; poll for the FIN too
                s.setblocking(False)
                try:
                    if s.recv(1) == b"":
                        cut = time.monotonic() - t0
                        break
                except BlockingIOError:
                    pass
                finally:
                    s.setblocking(True)
            assert cut is not None, "trickling body was never cut off"
            assert cut < 6, f"deadline fired late: {cut:.1f}s"
            s.close()
        finally:
            server.stop()

    def test_body_deadline_writes_400(self, handler):
        """When the wall-clock body deadline expires, the client gets a
        real 400 response — the near-zero socket timeout the deadline
        reads shrank is restored (in a finally) before the error is
        written, so the 400 doesn't die mid-send."""
        import socket
        server = WebhookServer(handler, port=0, request_timeout=1.0)
        server.start()
        try:
            s = socket.create_connection(("127.0.0.1", server.port),
                                         timeout=5)
            s.sendall(b"POST /v1/admit HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Length: 10000\r\n\r\n")
            s.sendall(b"x" * 10)       # partial body, then stall
            s.settimeout(8)
            data = b""
            try:
                while True:
                    chunk = s.recv(4096)
                    if not chunk:
                        break
                    data += chunk
            except socket.timeout:
                pass
            # stdlib BaseHTTPRequestHandler speaks HTTP/1.0 by default —
            # assert the status token, not the version prefix
            first = data.split(b"\r\n", 1)[0]
            assert b" 400" in first, data or b"<connection cut, no 400>"
            s.close()
        finally:
            server.stop()

    def test_stop_drains_inflight(self, handler):
        """stop() must let an in-flight admission finish (graceful
        drain), not kill it mid-response."""
        release = threading.Event()
        orig = handler.handle

        def slow_handle(request, deadline=None):
            release.wait(5)
            return orig(request, deadline=deadline)

        handler.handle = slow_handle
        server = WebhookServer(handler, port=0, drain_timeout=10)
        server.start()
        result = {}

        def call():
            body = {"apiVersion": "admission.k8s.io/v1beta1",
                    "kind": "AdmissionReview",
                    "request": review_request(ns_obj("bad"))}
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/v1/admit",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                result["out"] = json.loads(resp.read())

        t = threading.Thread(target=call)
        t.start()
        # wait until the request is in flight, then stop + release
        for _ in range(100):
            with server._inflight_cv:
                if server._inflight > 0:
                    break
            time.sleep(0.02)
        stopper = threading.Thread(target=server.stop)
        stopper.start()
        time.sleep(0.1)
        release.set()
        t.join(10)
        stopper.join(10)
        assert result["out"]["response"]["allowed"] is False


# ---------------------------------------------------------------------------
# parity: the demo YAMLs through the port's handler and the reference's

DEMO = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "demo")


def _load(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def _demo(demo: str, sub: str) -> list[dict]:
    return [_load(p) for p in sorted(glob.glob(
        os.path.join(DEMO, demo, sub, "*.yaml")))]


def _request(obj: dict, operation: str = "CREATE", uid: str = "u",
             old: dict | None = None) -> dict:
    """An AdmissionRequest for ``obj`` with the kind's group and version
    from its apiVersion (as the apiserver sends it)."""
    meta = obj.get("metadata") or {}
    group, _, version = obj.get("apiVersion", "v1").rpartition("/")
    req = {"uid": uid, "kind": {"group": group, "version": version,
                                "kind": obj.get("kind", "")},
           "name": meta.get("name", ""), "namespace": meta.get("namespace"),
           "operation": operation, "object": obj,
           "userInfo": {"username": "demo-user", "groups": []}}
    if old is not None:
        req["oldObject"] = old
        req["object"] = None
    return req


def _installed() -> tuple[list[dict], list[dict], list[dict]]:
    """The demos' templates, their constraints (plus a warn and a dryrun
    copy of two agilebank ones) and the objects synced as inventory."""
    templates = _demo("basic", "templates") + _demo("agilebank", "templates")
    constraints = _demo("basic", "constraints") \
        + _demo("agilebank", "constraints")
    by_name = {c["metadata"]["name"]: c for c in constraints}
    for name, action in (("prod-repo-is-approved", "warn"),
                         ("container-must-have-limits", "dryrun")):
        c = copy.deepcopy(by_name[name])
        c["metadata"]["name"] = f"{name}-{action}"
        c["spec"]["enforcementAction"] = action
        constraints.append(c)
    data = [ns_obj("payments", {"gatekeeper": "on",
                                "owner": "me.agilebank.demo"}),
            ns_obj("production", {"owner": "me.agilebank.demo"})] \
        + _demo("agilebank", "good_resources")
    return templates, constraints, data


def _requests() -> list[dict]:
    """Good and bad objects of both demos (CREATE, then DELETE with
    oldObject, then a DELETE without it), template and constraint writes
    (the bad ones included), and the Gatekeeper service account."""
    templates, constraints, _ = _installed()
    objs = _demo("basic", "good") + [
        _load(p) for p in sorted(glob.glob(os.path.join(
            DEMO, "basic", "bad", "*.yaml")))] \
        + _demo("agilebank", "bad_resources") \
        + _demo("agilebank", "good_resources")
    out = []
    for i, obj in enumerate(objs + templates + constraints):
        out.append(_request(obj, uid=f"c{i}"))
    for i, obj in enumerate(_demo("agilebank", "bad_resources")
                            + _demo("basic", "good")):
        out.append(_request(obj, "DELETE", uid=f"d{i}", old=obj))
    gone = _request(objs[0], "DELETE", uid="gone")
    gone["object"] = None
    out.append(gone)
    sa = _request(objs[0], uid="sa")
    sa["userInfo"]["groups"] = ["system:serviceaccounts:gatekeeper-system"]
    out.append(sa)
    return out


def _client_with(backend, target, driver):
    templates, constraints, data = _installed()
    client = backend(driver).new_client([target()])
    for t in templates:
        client.add_template(t)
    for c in constraints:
        client.add_constraint(c)
    for o in data:
        client.add_data(o)
    return client


def test_demo_requests_answer_as_the_reference(monkeypatch):
    """Every response of the port's handler (TorchDriver on the CPU)
    equals the reference handler's (JaxDriver on the CPU), field for
    field: allowed, status code and message (the [denied by ...] lines,
    the 422 validation errors, the DELETE 500), and warnings."""
    from gatekeeper_tpu.client.client import Backend as RBackend
    from gatekeeper_tpu.engine.jax_driver import JaxDriver
    from gatekeeper_tpu.target.k8s import K8sValidationTarget as RTarget
    from gatekeeper_tpu.webhook.policy import \
        ValidationHandler as RValidationHandler
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    ref = RValidationHandler(_client_with(RBackend, RTarget, JaxDriver()))
    port = ValidationHandler(_client_with(Backend, K8sValidationTarget,
                                          TorchDriver(device="cpu")))
    seen = collections.Counter()
    for req in _requests():
        want = ref.handle(copy.deepcopy(req))
        got = port.handle(copy.deepcopy(req))
        assert got == want, req["uid"]
        seen[(got["allowed"], got["status"]["code"],
              bool(got.get("warnings")))] += 1
    # the sequence reaches every answer shape
    assert {(False, 403, False), (True, 200, False), (False, 422, False),
            (False, 500, False), (False, 403, True)} <= set(seen), seen
    for name in ("admission_denied", "admission_warn_violations",
                 "admission_dryrun_violations", "admission_requests"):
        assert port.metrics.counter(name).value == \
            ref.metrics.counter(name).value, name


# ---------------------------------------------------------------------------
# the port's trims


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as resp:
        return resp.status, resp.headers, resp.read()


class TestPortEndpoints:
    def test_healthz_states_the_drivers_device(self, handler):
        """No backend supervisor in the port: /healthz answers 200,
        healthy, with the driver's device as the backend."""
        server = WebhookServer(handler, port=0)
        server.start()
        try:
            status, headers, body = _get(server.port, "/healthz")
        finally:
            server.stop()
        assert status == 200
        assert headers["Content-Type"] == "application/json"
        want = "cpu" if isinstance(handler.client.driver, TorchDriver) \
            else "scalar"
        assert json.loads(body) == {"state": "healthy", "backend": want}

    def test_debug_violations_has_no_reactors(self, handler):
        """``/debug/violations`` carries ``reactors``, every live event
        reactor's ``state_payload()``, keyed and shaped as the
        reference's."""
        import gc

        from gatekeeper_tpu.enforce.reactor import Reactor as JReactor
        from gatekeeper_tpu_torch.enforce.reactor import Reactor
        gc.collect()                # reactors of earlier tests
        rx = Reactor(handler.client, name="debug-reactor")
        ref = JReactor(handler.client, name="debug-reactor")
        server = WebhookServer(handler, port=0)
        server.start()
        try:
            handler.client.audit()
            status, _, body = _get(server.port, "/debug/violations")
        finally:
            server.stop()
        doc = json.loads(body)
        assert status == 200 and "ledgers" in doc
        mine = [r for r in doc["reactors"] if r["name"] == "debug-reactor"]
        want = ref.state_payload()
        assert len(mine) == 1 and mine[0].keys() == want.keys()
        assert mine[0]["state"] == want["state"] == "live"
        assert mine[0]["kinds"] == want["kinds"] == {}
        del rx, ref

    def test_metrics_carry_no_supervisor_registry(self, handler):
        server = WebhookServer(handler, port=0)
        server.start()
        try:
            handler.handle(review_request(ns_obj("bad")))
            _, _, body = _get(server.port, "/metrics")
        finally:
            server.stop()
        text = body.decode()
        assert "gatekeeper_admission_requests" in text
        assert "gatekeeper_supervisor" not in text


class TestAdmissionCorpus:
    @pytest.mark.parametrize("value", ["1", "yes"])
    def test_corpus_variable_is_refused(self, value, monkeypatch):
        """GATEKEEPER_FLIGHT_ADMISSION asks for the admission corpus,
        which is not ported: building a handler raises instead of
        recording nothing (the reference swallows a recorder failure)."""
        monkeypatch.setenv("GATEKEEPER_FLIGHT_ADMISSION", value)
        client = Backend(LocalDriver()).new_client([K8sValidationTarget()])
        with pytest.raises(ClientError, match="not yet ported"):
            ValidationHandler(client)

    @pytest.mark.parametrize("value", ["", "0"])
    def test_corpus_off_builds(self, value, monkeypatch):
        monkeypatch.setenv("GATEKEEPER_FLIGHT_ADMISSION", value)
        client = Backend(LocalDriver()).new_client([K8sValidationTarget()])
        assert ValidationHandler(client).client is client

    def test_ring_gets_the_admission_summary(self, handler):
        """The ring half of the reference's record_admission stays: one
        summary event per admission."""
        from gatekeeper_tpu_torch.obs.flightrecorder import \
            get_flight_recorder
        handler.handle(review_request(ns_obj("bad")))
        ev = [e for e in get_flight_recorder().snapshot()
              if e["type"] == "admission"][-1]
        assert (ev["operation"], ev["kind"], ev["name"], ev["allowed"],
                ev["verdicts"]) == ("CREATE", "Namespace", "bad", False, 1)


def test_batching_pays_reads_the_ports_threshold(monkeypatch):
    """"auto" batches only when a full batch clears the port's own
    REVIEW_BATCH_MIN_EVALS, read at each call."""
    client = Backend(TorchDriver(device="cpu")).new_client(
        [K8sValidationTarget()])
    client.add_template(template_obj())
    client.add_constraint(constraint_obj())
    h = ValidationHandler(client, batcher=MicroBatcher(
        client.review_batch, max_batch=64))
    monkeypatch.setattr(torch_driver, "REVIEW_BATCH_MIN_EVALS", 64)
    assert h._batching_pays() is True
    monkeypatch.setattr(torch_driver, "REVIEW_BATCH_MIN_EVALS", 65)
    assert h._batching_pays() is False
    h.batch_mode = "always"
    assert h._batching_pays() is True
    h.batch_mode = "never"
    assert h._batching_pays() is False


# ---------------------------------------------------------------------------
# the endpoints under admission load (counterpart of
# tests/test_obs.py::TestEndpointsUnderLoad, counted in reads rather
# than in a wall-clock window)

LOAD_READS = 5


def test_metrics_and_trace_serve_during_admission():
    """/metrics and /debug/trace stay well-formed while two client
    threads keep admitting: the test waits for LOAD_READS reads of each
    taken while admissions flow (the reference's counterpart counts
    reads in a fixed 2 s window, which a loaded host can starve)."""
    client = Backend(LocalDriver()).new_client([K8sValidationTarget()])
    client.add_template(template_obj())
    client.add_constraint(constraint_obj())
    handler = ValidationHandler(client)
    server = WebhookServer(handler, port=0)
    server.start()
    stop = threading.Event()
    errors: list = []
    admitted = [0, 0]
    try:
        base = f"http://127.0.0.1:{server.port}"

        def hammer(tid):
            i = 0
            try:
                while not stop.is_set():
                    obj = ns_obj(f"ns-{tid}-{i}",
                                 {"gatekeeper": "on"} if i % 2 else None)
                    body = {"apiVersion": "admission.k8s.io/v1beta1",
                            "kind": "AdmissionReview",
                            "request": review_request(obj)}
                    req = urllib.request.Request(
                        f"{base}/v1/admit", data=json.dumps(body).encode(),
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=30) as resp:
                        json.loads(resp.read())
                    admitted[tid] += 1
                    i += 1
            except Exception as e:      # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=hammer, args=(t,))
                   for t in range(2)]
        for t in threads:
            t.start()
        reads = 0
        while reads < LOAD_READS:
            before = sum(admitted)
            with urllib.request.urlopen(f"{base}/metrics",
                                        timeout=30) as resp:
                text = resp.read().decode()
            for line in text.splitlines():
                if not line or line.startswith("#"):
                    continue
                name, _, value = line.rpartition(" ")
                assert name and value, f"torn exposition line: {line!r}"
                float(value)
            with urllib.request.urlopen(f"{base}/debug/trace",
                                        timeout=30) as resp:
                assert resp.headers["Content-Type"].startswith(
                    "application/json")
                doc = json.loads(resp.read())
            assert isinstance(doc["traceEvents"], list)
            assert not errors, errors
            # a read counts once admissions are flowing around it
            if sum(admitted) > before or reads:
                reads += 1
        stop.set()
        for t in threads:
            t.join(30)
        assert not errors, errors
        assert all(admitted), admitted
        assert "gatekeeper_admission_seconds_bucket" in text
        names = {e["name"] for e in doc["traceEvents"]}
        assert "admission.request" in names
    finally:
        stop.set()
        server.stop()


# ---------------------------------------------------------------------------
# in-cluster registration


def test_bootstrap_registers_like_the_reference(tmp_path):
    """bootstrap_webhook writes the serving secret, the service and the
    ValidatingWebhookConfiguration through the cluster protocol, as the
    reference's does; the VWC's posture annotations state what /healthz
    states (healthy, on the driver's device) and the registered webhook
    equals the reference's.  The server then speaks TLS from the
    generated cert."""
    import ssl

    from gatekeeper_tpu.api.config import GVK as RGVK
    from gatekeeper_tpu.cluster.fake import FakeCluster as RFakeCluster
    from gatekeeper_tpu.webhook import bootstrap as rboot
    from gatekeeper_tpu_torch.api.config import GVK
    from gatekeeper_tpu_torch.webhook import bootstrap
    cert_dir = str(tmp_path / "certs")
    cluster = FakeCluster()
    assert bootstrap.bootstrap_webhook(cluster, cert_dir, 8443,
                                       backend="cuda:0")
    vwc_gvk = GVK("admissionregistration.k8s.io", "v1",
                  "ValidatingWebhookConfiguration")
    vwc = cluster.get(vwc_gvk, bootstrap.DEFAULT_WEBHOOK_NAME)
    assert vwc["metadata"]["annotations"] == {
        "gatekeeper.sh/backend-state": "healthy",
        "gatekeeper.sh/backend": "cuda:0"}
    ref = RFakeCluster()
    assert rboot.bootstrap_webhook(ref, cert_dir, 8443)
    rvwc = ref.get(RGVK("admissionregistration.k8s.io", "v1",
                        "ValidatingWebhookConfiguration"),
                   rboot.DEFAULT_WEBHOOK_NAME)
    assert vwc["webhooks"] == rvwc["webhooks"]
    for kind, name in (("Secret", bootstrap.SECRET_NAME),
                       ("Service", bootstrap.SERVICE_NAME)):
        got = cluster.get(GVK("", "v1", kind), name, bootstrap.NAMESPACE)
        want = ref.get(RGVK("", "v1", kind), name, bootstrap.NAMESPACE)
        assert got == want
    # the server speaks TLS from that cert dir
    client = Backend(LocalDriver()).new_client([K8sValidationTarget()])
    server = WebhookServer(ValidationHandler(client), port=0,
                           cert_dir=cert_dir)
    server.start()
    try:
        assert server.tls
        ctx = ssl.create_default_context(cafile=os.path.join(cert_dir,
                                                             "tls.crt"))
        with urllib.request.urlopen(f"https://localhost:{server.port}"
                                    "/healthz", context=ctx,
                                    timeout=10) as resp:
            assert json.loads(resp.read()) == {"state": "healthy",
                                               "backend": "scalar"}
    finally:
        server.stop()
