# Copied from gatekeeper_tpu/client/remote_driver.py for the PyTorch port.
"""The ``remote`` driver: out-of-process engine worker over HTTP.

The reference ships two drivers behind its seam: in-process OPA
(drivers/local) and an HTTP client speaking to a remote OPA
(vendor/.../drivers/remote/remote.go:49-100, one URL per API:
PutModule -> PUT /v1/policies/<name>, Query -> POST /v1/data/...).
This is that second kind for the port's engine: the control plane
(controllers, webhook, audit manager) runs in one process while the
evaluation engine — typically a TorchDriver owning the CUDA card — runs
in a worker process (cmd/worker.py).  The wire protocol is one POST per
Driver-seam method with JSON bodies; templates travel as Rego source and
are re-compiled worker-side (exactly how the reference's remote OPA
receives modules).

``EngineWorker`` hosts any Driver implementation; ``RemoteDriver`` is
the client half, implementing the same seam so ``Backend``/``Client``
cannot tell the difference (the conformance suite runs against it).

Unlike the JAX package's wire, the port's carries ``QueryOpts.full`` in
both directions, so ``audit(full=True)`` through a worker runs a forced
full sweep there (the reference's ``_opts_to_wire`` drops it and the
worker runs a memoized sweep).  The worker's accept queue holds 128
connections, not socketserver's 5: a webhook's concurrent request
threads each open a keep-alive connection, and a burst past 5 was reset.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

from gatekeeper_tpu_torch.api.templates import CompiledTemplate, compile_target_rego
from gatekeeper_tpu_torch.client.interface import Driver, QueryOpts
from gatekeeper_tpu_torch.client.targets import TargetHandler
from gatekeeper_tpu_torch.client.types import Result
from gatekeeper_tpu_torch.errors import ClientError
from gatekeeper_tpu_torch.store.table import ResourceMeta

# worker-side registry: target name -> handler factory (handlers are
# code, not data — the worker constructs its own, like a remote OPA
# owning its own regolib)
TARGET_REGISTRY: dict[str, Callable[[], TargetHandler]] = {}


def register_target(name: str, factory: Callable[[], TargetHandler]) -> None:
    TARGET_REGISTRY[name] = factory


def _default_registry() -> None:
    from gatekeeper_tpu_torch.target.k8s import TARGET_NAME, K8sValidationTarget
    TARGET_REGISTRY.setdefault(TARGET_NAME, K8sValidationTarget)


def _result_to_wire(r: Result) -> dict:
    return {"msg": r.msg, "metadata": r.metadata, "constraint": r.constraint,
            "review": r.review, "resource": r.resource,
            "enforcement_action": r.enforcement_action}


def _result_from_wire(d: dict) -> Result:
    return Result(msg=d.get("msg", ""), metadata=d.get("metadata") or {},
                  constraint=d.get("constraint"), review=d.get("review"),
                  resource=d.get("resource"),
                  enforcement_action=d.get("enforcement_action", "deny"))


def _opts_to_wire(opts: QueryOpts | None) -> dict | None:
    if opts is None:
        return None
    return {"tracing": opts.tracing,
            "limit_per_constraint": opts.limit_per_constraint,
            "full": opts.full,
            "shed_actions": sorted(opts.shed_actions)
            if opts.shed_actions else None}


def _opts_from_wire(d: dict | None) -> QueryOpts | None:
    if d is None:
        return None
    shed = d.get("shed_actions")
    return QueryOpts(tracing=bool(d.get("tracing")),
                     limit_per_constraint=d.get("limit_per_constraint"),
                     full=bool(d.get("full")),
                     shed_actions=frozenset(shed) if shed else None)


class WorkerUnreachableError(ClientError):
    """Transport-level failure talking to an engine worker (connect,
    timeout, torn connection) — retriable on another replica, unlike a
    semantic 4xx the worker actually answered with."""


class EngineWorker:
    """HTTP server hosting a Driver (usually a TorchDriver owning the
    card).  One POST endpoint per seam method.  ``driver`` may be
    an instance or a zero-arg factory; with a factory, each ``init``
    from a (re)connecting control plane gets a FRESH driver — a
    restarted manager must not inherit templates/constraints/data a
    previous manager synced (they would never be garbage-collected)."""

    def __init__(self, driver: Driver | Callable[[], Driver],
                 host: str = "127.0.0.1", port: int = 0):
        _default_registry()
        if callable(driver) and not isinstance(driver, Driver):
            self._factory: Callable[[], Driver] | None = driver
            self.driver = driver()
        else:
            self._factory = None
            self.driver = driver
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            # keep-alive: the client reuses one connection per thread
            # instead of a TCP handshake per Driver call (admission is
            # call-per-review); Nagle off, or the header/body write
            # pair interacts with delayed ACK for ~40ms per call
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    method = self.path.strip("/").split("/")[-1]
                    out = outer._dispatch(method, body)
                    payload = json.dumps(out).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                except ClientError as e:
                    self.send_error(400, str(e))
                except Exception as e:  # worker must not die on a bad call
                    self.send_error(500, f"{type(e).__name__}: {e}")

        class _Server(ThreadingHTTPServer):
            # a burst of new keep-alive connections (each request thread
            # of a webhook opens its own) must fit the accept queue: past
            # socketserver's default of 5 the kernel resets the rest
            request_queue_size = 128

        self._server = _Server((host, port), _Handler)
        self.port = self._server.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------

    def _dispatch(self, method: str, b: dict) -> Any:
        d = self.driver
        if method == "init":
            targets = {}
            for name in b["targets"]:
                factory = TARGET_REGISTRY.get(name)
                if factory is None:
                    raise ClientError(f"worker has no target {name!r}")
                targets[name] = factory()
            if self._factory is not None:
                self.driver = d = self._factory()   # fresh state per client
            d.init(targets)
            return {"ok": True}
        if method == "put_template":
            compiled = compile_target_rego(b["kind"], b["target"], b["source"])
            d.put_template(b["target"], b["kind"], compiled)
            return {"ok": True}
        if method == "delete_template":
            d.delete_template(b["target"], b["kind"])
            return {"ok": True}
        if method == "put_constraint":
            d.put_constraint(b["target"], b["kind"], b["name"], b["constraint"])
            return {"ok": True}
        if method == "delete_constraint":
            d.delete_constraint(b["target"], b["kind"], b["name"])
            return {"ok": True}
        if method == "put_data":
            m = b["meta"]
            meta = ResourceMeta(m["api_version"], m["kind"], m["name"],
                                m.get("namespace"))
            d.put_data(b["target"], b["key"], meta, b["obj"])
            return {"ok": True}
        if method == "put_data_batch":
            entries = []
            for e in b["entries"]:
                m = e["meta"]
                entries.append((e["key"],
                                ResourceMeta(m["api_version"], m["kind"],
                                             m["name"], m.get("namespace")),
                                e["obj"]))
            d.put_data_batch(b["target"], entries)
            return {"ok": True}
        if method == "delete_data":
            return {"removed": d.delete_data(b["target"], b["key"])}
        if method == "wipe_data":
            d.wipe_data(b["target"])
            return {"ok": True}
        if method == "query_review":
            results, trace = d.query_review(b["target"], b["review"],
                                            _opts_from_wire(b.get("opts")))
            return {"results": [_result_to_wire(r) for r in results],
                    "trace": trace}
        if method == "query_review_batch":
            opts = _opts_from_wire(b.get("opts"))
            pairs = d.query_review_batch(b["target"], b["reviews"], opts)
            return {"batch": [{"results": [_result_to_wire(r) for r in rs],
                               "trace": tr} for rs, tr in pairs]}
        if method == "query_audit":
            results, trace = d.query_audit(b["target"],
                                           _opts_from_wire(b.get("opts")))
            return {"results": [_result_to_wire(r) for r in results],
                    "trace": trace}
        if method == "dump":
            return {"dump": d.dump()}
        raise ClientError(f"unknown method {method!r}")

    # ------------------------------------------------------------------

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._server.serve_forever,
                                            daemon=True, name="engine-worker")
            self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            # BaseServer.shutdown blocks on an event only serve_forever
            # sets — calling it without a running thread hangs forever
            self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


class RemoteDriver(Driver):
    """Driver-seam client forwarding every call to an EngineWorker."""

    def __init__(self, url: str, timeout: float = 60.0):
        self.url = url.rstrip("/")
        self.timeout = timeout
        p = urllib.parse.urlparse(self.url)
        self._host = p.hostname or "127.0.0.1"
        self._port = p.port or 80
        self._local = threading.local()   # per-thread keep-alive conn

    def _conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(self._host, self._port,
                                              timeout=self.timeout)
            self._local.conn = conn
        return conn

    def _call(self, method: str, body: dict,
              no_retry: bool = False) -> dict:
        """One POST per Driver-seam call over a per-thread persistent
        connection (a fresh TCP handshake per admission review costs
        more than the evaluation itself).  A failure on a REUSED
        connection is retried once — the server closing an idle
        keep-alive between requests is routine — but never a timeout
        (the call may still be executing) and never when `no_retry`
        (non-idempotent answers, e.g. delete_data's removed flag)."""
        payload = json.dumps(body).encode()
        for attempt in (0, 1):
            conn = self._conn()
            was_reused = conn.sock is not None
            try:
                if conn.sock is None:
                    conn.connect()
                    # Nagle off: request = two small writes (headers,
                    # body); coalescing against delayed ACK can cost
                    # ~40ms per call
                    conn.sock.setsockopt(socket.IPPROTO_TCP,
                                         socket.TCP_NODELAY, 1)
                conn.request("POST", f"/v1/{method}", body=payload,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
            except socket.timeout:
                conn.close()
                self._local.conn = None
                raise WorkerUnreachableError(
                    f"worker {method} timed out after {self.timeout}s")
            except (ConnectionError, OSError,
                    http.client.HTTPException) as e:
                conn.close()
                self._local.conn = None
                if attempt == 0 and was_reused and not no_retry:
                    continue    # stale keep-alive: reconnect once
                raise WorkerUnreachableError(
                    f"worker unreachable at {self.url}: {e}")
            if resp.status != 200:
                detail = data.decode(errors="replace")[:500]
                raise ClientError(
                    f"worker {method} failed: {resp.status} {detail}")
            return json.loads(data)
        raise AssertionError("unreachable")

    # ------------------------------------------------------------------

    def init(self, targets: dict[str, TargetHandler]) -> None:
        self._call("init", {"targets": sorted(targets)})

    def put_template(self, target: str, kind: str,
                     compiled: CompiledTemplate) -> None:
        self._call("put_template", {"target": target, "kind": kind,
                                    "source": compiled.source})

    def delete_template(self, target: str, kind: str) -> None:
        self._call("delete_template", {"target": target, "kind": kind})

    def put_constraint(self, target: str, kind: str, name: str,
                       constraint: dict) -> None:
        self._call("put_constraint", {"target": target, "kind": kind,
                                      "name": name, "constraint": constraint})

    def delete_constraint(self, target: str, kind: str, name: str) -> None:
        self._call("delete_constraint", {"target": target, "kind": kind,
                                         "name": name})

    def put_data(self, target: str, key: str, meta: ResourceMeta,
                 obj: dict) -> None:
        self._call("put_data", {
            "target": target, "key": key, "obj": obj,
            "meta": {"api_version": meta.api_version, "kind": meta.kind,
                     "name": meta.name, "namespace": meta.namespace}})

    def put_data_batch(self, target: str, entries) -> None:
        self._call("put_data_batch", {"target": target, "entries": [
            {"key": key, "obj": obj,
             "meta": {"api_version": meta.api_version, "kind": meta.kind,
                      "name": meta.name, "namespace": meta.namespace}}
            for key, meta, obj in entries]})

    def delete_data(self, target: str, key: str) -> bool:
        return bool(self._call("delete_data", {"target": target, "key": key},
                               no_retry=True)["removed"])

    def wipe_data(self, target: str) -> None:
        self._call("wipe_data", {"target": target})

    def query_review(self, target: str, review: dict,
                     opts: QueryOpts | None = None):
        out = self._call("query_review", {"target": target, "review": review,
                                          "opts": _opts_to_wire(opts)})
        return [_result_from_wire(r) for r in out["results"]], out.get("trace")

    def query_review_batch(self, target: str, reviews: list[dict],
                           opts: QueryOpts | None = None) -> list[tuple]:
        out = self._call("query_review_batch",
                         {"target": target, "reviews": reviews,
                          "opts": _opts_to_wire(opts)})
        return [([_result_from_wire(r) for r in e["results"]], e.get("trace"))
                for e in out["batch"]]

    def query_audit(self, target: str, opts: QueryOpts | None = None):
        out = self._call("query_audit", {"target": target,
                                         "opts": _opts_to_wire(opts)})
        return [_result_from_wire(r) for r in out["results"]], out.get("trace")

    def dump(self) -> dict:
        return self._call("dump", {})["dump"]
