# Copied from gatekeeper_tpu/webhook/server.py for the PyTorch port.
"""Webhook HTTP server: POST /v1/admit with an AdmissionReview envelope.

Reference: pkg/webhook/policy.go:56-79 — controller-runtime's webhook
server at path /v1/admit, port flag default 443.  This build serves the
same contract over stdlib http.server (threaded, one handler instance):
request body is a v1beta1 AdmissionReview; the response echoes the
request UID.  TLS/cert bootstrap (policy.go:81-100) is deployment
machinery a cluster would provide; the serving semantics live here.

Trimmed for the port: ``/healthz`` answers 200 with ``state: healthy``
and the driver's device (the reference's backend supervisor and its
restart-cache counters are ROADMAP A8) and ``/metrics`` carries no
supervisor registry.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from gatekeeper_tpu_torch.utils.log import logger
from gatekeeper_tpu_torch.webhook.policy import ValidationHandler

_log = logger("webhook")

WEBHOOK_PATH = "/v1/admit"
DEFAULT_PORT = 8443          # the reference defaults to 443 (policy.go:48)

# Hardening bounds (controller-runtime's webhook server enforces the
# same classes of limit — read timeouts and a bounded decoder —
# pkg/webhook/policy.go:57-79 rides that server):
REQUEST_TIMEOUT_S = 10.0     # idle timeout per read AND the wall-clock
#                              deadline for reading one request's body
MAX_BODY_BYTES = 10 << 20    # AdmissionReview objects are etcd-bounded
DRAIN_TIMEOUT_S = 15.0       # stop(): wait for in-flight admissions


def backend_of(client) -> str:
    """The backend admissions are served on, as ``/healthz`` and the
    webhook registration's annotations state it: the driver's torch
    device (``cuda:0``, ``cpu``), or ``scalar`` for a driver without
    one (LocalDriver)."""
    device = getattr(getattr(client, "driver", None), "device", None)
    return str(device) if device is not None else "scalar"


def _parse_timeout_param(query: str) -> float | None:
    """Extract the apiserver's per-request timeout from the webhook
    URL query string (``timeout=10s`` — k8s Duration, but apiservers
    only ever send integer seconds; bootstrap.py registers the URL
    with it appended).  None when absent or unparseable."""
    for part in query.split("&"):
        k, _, v = part.partition("=")
        if k != "timeout" or not v:
            continue
        v = v.rstrip("s")
        try:
            t = float(v)
        except ValueError:
            return None
        return t if t > 0 else None
    return None


class _DeadlineBody:
    """Body reader with a hard wall-clock deadline.

    The handler-class ``timeout`` below is only an *idle* timeout
    (settimeout on the connection): a slowloris client trickling one
    byte every few seconds never goes idle and would pin a handler
    thread through an arbitrarily long body read.  This wrapper reads
    the body in single-recv slices (``read1``) and checks the wall
    clock between slices, so a request's body phase is cut off at
    ``deadline`` no matter how lively the trickle is.  (The
    header-line phase keeps the idle timeout: header sizes/counts are
    bounded by http.server itself.)"""

    def __init__(self, raw, conn, deadline: float):
        self._raw = raw
        self._conn = conn
        self._deadline = deadline

    def read(self, size: int) -> bytes:
        import socket as _socket
        out = bytearray()
        while len(out) < size:
            remaining = self._deadline - time.monotonic()
            if remaining <= 0:
                raise _socket.timeout("request body deadline exceeded")
            self._conn.settimeout(remaining)
            chunk = self._raw.read1(size - len(out))
            if not chunk:
                break               # EOF short read; caller json-fails
            out += chunk
        return bytes(out)


class WebhookServer:
    """Serves /v1/admit (+ /metrics).  With ``cert_dir`` holding
    tls.crt/tls.key the server speaks HTTPS — the reference serves the
    webhook over TLS from cert dir /certs (policy.go:76-79); an
    apiserver will not call back over plain HTTP."""

    def __init__(self, handler: ValidationHandler, port: int = DEFAULT_PORT,
                 host: str | None = None, metrics=None,
                 cert_dir: str | None = None,
                 request_timeout: float = REQUEST_TIMEOUT_S,
                 max_body_bytes: int = MAX_BODY_BYTES,
                 drain_timeout: float = DRAIN_TIMEOUT_S):
        # Default bind: all interfaces when serving TLS (in-cluster the
        # apiserver calls back through a Service to the pod IP — a
        # loopback bind would refuse every callback and, with
        # failurePolicy: Ignore, silently disable admission), loopback
        # when plain HTTP (dev mode must not expose an unauthenticated
        # admit endpoint on the network).
        if host is None:
            host = "" if cert_dir else "127.0.0.1"
        self.handler = handler
        self.metrics = metrics if metrics is not None else handler.metrics
        self.cert_dir = cert_dir
        self.drain_timeout = drain_timeout
        # graceful drain: in-flight admissions finish before stop()
        # returns (the reference rides controller-runtime's server,
        # which drains on shutdown; a killed-mid-admission request
        # surfaces to the apiserver as a webhook failure and, with
        # failurePolicy: Ignore, silently skips policy)
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        outer = self

        class _HTTPHandler(BaseHTTPRequestHandler):
            # IDLE timeout per socket read (StreamRequestHandler applies
            # it via connection.settimeout) — cuts off a client that
            # stops sending, NOT one that trickles; the body read below
            # additionally enforces a wall-clock deadline (_DeadlineBody)
            timeout = request_timeout

            def log_message(self, *args):  # quiet
                pass

            def do_GET(self):
                """GET /metrics — Prometheus text exposition of the
                shared registry (audit/admission/device counters).
                GET /healthz — the serving posture as JSON, always 200
                with ``state: healthy`` and the driver's device as the
                backend (no supervisor in the port).  GET
                /debug/violations and /debug/trace — the ledgers' and
                the tracer's JSON exports."""
                if self.path == "/healthz":
                    # the keys the port can state: the reference's body
                    # is its backend supervisor's status with restart
                    # cache counters (ROADMAP A8).  The port has no
                    # supervisor and no fallback backend — a kernel
                    # error ends the sweep or the batch — so a serving
                    # process is healthy on the driver's own device
                    import json as _json
                    payload = _json.dumps(
                        {"state": "healthy",
                         "backend": backend_of(outer.handler.client)}
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                if self.path.split("?", 1)[0] == "/debug/violations":
                    # the continuously-true violation set + the recent
                    # delta event stream (enforce/ledger.py): one JSON
                    # document per live VerdictLedger
                    import json as _json
                    from gatekeeper_tpu_torch.enforce.ledger import \
                        export_all
                    from gatekeeper_tpu_torch.enforce.reactor import \
                        export_state
                    doc = export_all()
                    doc["reactors"] = export_state()
                    payload = _json.dumps(doc, default=str).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                if self.path.split("?", 1)[0] == "/debug/trace":
                    # Chrome trace-event JSON of the tracer's span ring
                    # — load in Perfetto / chrome://tracing
                    import json as _json
                    from gatekeeper_tpu_torch.obs.trace import get_tracer
                    payload = _json.dumps(get_tracer().export()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                if self.path != "/metrics":
                    self.send_error(404)
                    return
                # (the reference appends its backend supervisor's own
                # registry under the gatekeeper_supervisor prefix:
                # ROADMAP A8, no supervisor in the port)
                text = outer.metrics.render_prometheus()
                payload = text.encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_POST(self):
                # the apiserver appends its per-request timeout to the
                # registered URL (bootstrap.py: ?timeout=10s) — split it
                # off the path and turn it into the admission deadline
                path, _, query = self.path.partition("?")
                if path != WEBHOOK_PATH:
                    self.send_error(404)
                    return
                apiserver_timeout = _parse_timeout_param(query)
                if "chunked" in (self.headers.get(
                        "Transfer-Encoding") or "").lower():
                    # unbounded chunked bodies defeat the size cap; the
                    # apiserver always sends Content-Length
                    self.send_error(411, "Content-Length required")
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    self.send_error(400, "bad Content-Length")
                    return
                if length < 0:
                    # rfile.read(-1) would read to EOF — unbounded
                    self.send_error(400, "bad Content-Length")
                    return
                if length > max_body_bytes:
                    self.send_error(413, "request body too large")
                    return
                with outer._inflight_cv:
                    outer._inflight += 1
                try:
                    rbody = _DeadlineBody(
                        self.rfile, self.connection,
                        time.monotonic() + request_timeout)
                    try:
                        payload = rbody.read(length)
                    finally:
                        # restore the idle timeout the deadline reads
                        # shrank — in a finally, because when the read
                        # itself times out the 400 below would otherwise
                        # be written against a near-zero socket timeout
                        # and die mid-send (keep-alive: the next request
                        # starts fresh either way)
                        self.connection.settimeout(request_timeout)
                    body = json.loads(payload or b"{}")
                    request = body.get("request") or {}
                    # admission deadline: the tightest of the
                    # apiserver's ?timeout= and this server's own
                    # request budget — propagated so batch formation
                    # drops the request the moment it expires instead
                    # of evaluating for a caller that already gave up
                    budget = request_timeout
                    if apiserver_timeout is not None:
                        budget = min(budget, apiserver_timeout)
                    response = outer.handler.handle(
                        request, deadline=time.monotonic() + budget)
                    envelope = {
                        "apiVersion": body.get("apiVersion",
                                               "admission.k8s.io/v1beta1"),
                        "kind": "AdmissionReview",
                        "response": {"uid": request.get("uid", ""),
                                     **response},
                    }
                    payload = json.dumps(envelope).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                except Exception as e:  # malformed body etc.
                    try:
                        self.send_error(400, str(e))
                    except Exception:
                        pass   # client already gone
                finally:
                    with outer._inflight_cv:
                        outer._inflight -= 1
                        outer._inflight_cv.notify_all()

        self._server = ThreadingHTTPServer((host, port), _HTTPHandler)
        self.tls = False
        if cert_dir:
            import os
            import ssl
            crt = os.path.join(cert_dir, "tls.crt")
            key = os.path.join(cert_dir, "tls.key")
            if os.path.exists(crt) and os.path.exists(key):
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                ctx.load_cert_chain(crt, key)
                self._server.socket = ctx.wrap_socket(
                    self._server.socket, server_side=True)
                self.tls = True
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        _log.info("webhook serving", port=self.port,
                  tls=getattr(self, "tls", False))
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever, daemon=True,
                name="webhook-server")
            self._thread.start()

    def stop(self) -> None:
        """Stop accepting, drain in-flight admissions, then close."""
        self._server.shutdown()          # stop the accept loop
        deadline = time.monotonic() + self.drain_timeout
        with self._inflight_cv:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    _log.info("webhook drain timeout",
                              inflight=self._inflight)
                    break
                self._inflight_cv.wait(remaining)
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
