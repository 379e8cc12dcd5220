# Copied from gatekeeper_tpu/cluster/kube.py for the PyTorch port.
"""Real-apiserver cluster adapter over raw HTTPS.

Implements the ``cluster.protocol.Cluster`` surface against any
conformant kube-apiserver — the role controller-runtime's client +
discovery + informer stack plays in the reference
(cmd/manager/main.go:43-51; informer-driven sync ingest
sync_controller.go:99-148; discovery audit/manager.go:153-159).  No
kubernetes client package: kubeconfig parsing, TLS/client-cert/token
auth, REST mapping via discovery, and chunked list+watch streams are
implemented directly on the standard library.

Watch semantics: one daemon thread per subscribed GVK runs
list → stream(?watch=1&resourceVersion=N) → reconnect; on HTTP 410
(resourceVersion too old) it re-lists and re-emits MODIFIED for every
object — reconcilers are idempotent by contract (SURVEY §5 failure
detection), so replayed events are safe.
"""

from __future__ import annotations

import base64
import json
import os
import ssl
import tempfile
import threading
import urllib.error
import urllib.request
from typing import Callable

from gatekeeper_tpu_torch.utils.log import logger
from gatekeeper_tpu_torch.api.config import GVK
from gatekeeper_tpu_torch.cluster.fake import ADDED, DELETED, MODIFIED, Event
from gatekeeper_tpu_torch.errors import (AlreadyExistsError, ApiConflictError,
                                   ApiError, NotFoundError)

_log = logger("kube")


def load_kubeconfig(path: str) -> dict:
    """Minimal kubeconfig resolution: current-context -> (server, ssl
    context, auth headers).  Supports certificate-authority(-data),
    client-certificate/key(-data), token, and insecure-skip-tls-verify."""
    import yaml
    with open(path) as f:
        cfg = yaml.safe_load(f)
    ctx_name = cfg.get("current-context")
    ctx = next(c["context"] for c in cfg.get("contexts", [])
               if c["name"] == ctx_name)
    cluster = next(c["cluster"] for c in cfg.get("clusters", [])
                   if c["name"] == ctx["cluster"])
    user = next(u["user"] for u in cfg.get("users", [])
                if u["name"] == ctx["user"])
    server = cluster["server"]
    headers: dict[str, str] = {}
    sslctx = None
    if server.startswith("https"):
        sslctx = ssl.create_default_context()
        if cluster.get("insecure-skip-tls-verify"):
            sslctx.check_hostname = False
            sslctx.verify_mode = ssl.CERT_NONE
        elif cluster.get("certificate-authority"):
            sslctx.load_verify_locations(cluster["certificate-authority"])
        elif cluster.get("certificate-authority-data"):
            sslctx.load_verify_locations(cadata=base64.b64decode(
                cluster["certificate-authority-data"]).decode())
        cert = user.get("client-certificate")
        keyf = user.get("client-key")
        tmp_paths: list[str] = []
        if user.get("client-certificate-data") and user.get("client-key-data"):
            cf = tempfile.NamedTemporaryFile("wb", delete=False,
                                             suffix=".pem")
            cf.write(base64.b64decode(user["client-certificate-data"]))
            cf.close()
            kf = tempfile.NamedTemporaryFile("wb", delete=False,
                                             suffix=".pem")
            kf.write(base64.b64decode(user["client-key-data"]))
            kf.close()
            cert, keyf = cf.name, kf.name
            tmp_paths = [cf.name, kf.name]
        if cert and keyf:
            try:
                sslctx.load_cert_chain(cert, keyf)
            finally:
                # load_cert_chain reads eagerly; inline key material
                # must not persist on disk past this call
                for p in tmp_paths:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
    if user.get("token"):
        headers["Authorization"] = f"Bearer {user['token']}"
    elif user.get("tokenFile"):
        with open(user["tokenFile"]) as f:
            headers["Authorization"] = f"Bearer {f.read().strip()}"
    return {"server": server.rstrip("/"), "ssl": sslctx, "headers": headers}


def in_cluster_config() -> dict:
    """The pod-mounted serviceaccount config (what the reference's
    rest.InClusterConfig resolves when no kubeconfig is given)."""
    sa = "/var/run/secrets/kubernetes.io/serviceaccount"
    host = os.environ["KUBERNETES_SERVICE_HOST"]
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    sslctx = ssl.create_default_context()
    sslctx.load_verify_locations(f"{sa}/ca.crt")
    with open(f"{sa}/token") as f:
        token = f.read().strip()
    return {"server": f"https://{host}:{port}", "ssl": sslctx,
            "headers": {"Authorization": f"Bearer {token}"}}


class KubeCluster:
    def __init__(self, config: dict, watch_backoff: float = 1.0,
                 resync_seconds: float = 300.0):
        self._server = config["server"]
        self._ssl = config.get("ssl")
        self._headers = dict(config.get("headers") or {})
        self._watch_backoff = watch_backoff
        # informer-style periodic resync: when the stream yields nothing
        # for this long, re-list and re-emit (heals events lost in the
        # list->stream gap or across silent connection loss; reconcilers
        # are idempotent, so replays are free)
        self._resync = resync_seconds
        self._lock = threading.Lock()
        # discovery cache: group_version -> {kind -> {"name": plural,
        # "namespaced": bool}}; invalidated on NotFound lookups
        self._disc: dict[str, dict[str, dict]] = {}
        self._stop = threading.Event()

    @classmethod
    def from_kubeconfig(cls, path: str | None = None) -> "KubeCluster":
        if path:
            return cls(load_kubeconfig(path))
        env = os.environ.get("KUBECONFIG")
        if env:
            return cls(load_kubeconfig(env.split(":")[0]))
        return cls(in_cluster_config())

    def close(self) -> None:
        self._stop.set()

    # ------------------------------------------------------------------
    # HTTP

    def _request(self, method: str, path: str, body: dict | None = None,
                 timeout: float = 30.0):
        req = urllib.request.Request(self._server + path, method=method)
        for k, v in self._headers.items():
            req.add_header(k, v)
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            req.add_header("Content-Type", "application/json")
        try:
            resp = urllib.request.urlopen(req, data=data, timeout=timeout,
                                          context=self._ssl)
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:512]
            if e.code == 404:
                raise NotFoundError(f"{method} {path}: {detail}") from e
            if e.code == 409:
                if "AlreadyExists" in detail or method == "POST":
                    raise AlreadyExistsError(f"{path}: {detail}") from e
                raise ApiConflictError(f"{path}: {detail}") from e
            raise ApiError(f"{method} {path}: HTTP {e.code} {detail}") from e
        except urllib.error.URLError as e:
            raise ApiError(f"{method} {path}: {e.reason}") from e
        return resp

    def _json(self, method: str, path: str, body: dict | None = None) -> dict:
        with self._request(method, path, body) as resp:
            return json.loads(resp.read() or b"{}")

    # ------------------------------------------------------------------
    # discovery / REST mapping

    def _resources(self, group_version: str) -> dict[str, dict]:
        with self._lock:
            hit = self._disc.get(group_version)
        if hit is not None:
            return hit
        prefix = "/api/v1" if group_version == "v1" else \
            f"/apis/{group_version}"
        doc = self._json("GET", prefix)
        out: dict[str, dict] = {}
        for r in doc.get("resources", []):
            if "/" in r.get("name", ""):
                continue              # subresources (pods/status, ...)
            out[r["kind"]] = {"name": r["name"],
                              "namespaced": bool(r.get("namespaced"))}
        with self._lock:
            self._disc[group_version] = out
        return out

    def _invalidate(self, group_version: str) -> None:
        with self._lock:
            self._disc.pop(group_version, None)

    def kind_served(self, gvk: GVK) -> bool:
        try:
            return gvk.kind in self._resources(gvk.group_version)
        except NotFoundError:
            return False
        except ApiError:
            return False

    def server_resources_for_group_version(self, group_version: str) -> list[dict]:
        self._invalidate(group_version)   # discovery must be live here
        res = self._resources(group_version)
        if not res:
            raise NotFoundError(f"no resources for {group_version}")
        return [{"kind": k, "name": v["name"]}
                for k, v in sorted(res.items())]

    def _collection(self, gvk: GVK, namespace: str | None) -> str:
        res = self._resources(gvk.group_version).get(gvk.kind)
        if res is None:
            self._invalidate(gvk.group_version)
            res = self._resources(gvk.group_version).get(gvk.kind)
        if res is None:
            raise NotFoundError(
                f"kind {gvk.kind} not served under {gvk.group_version}")
        prefix = "/api/v1" if gvk.group == "" else \
            f"/apis/{gvk.group}/{gvk.version}"
        if res["namespaced"] and namespace:
            return f"{prefix}/namespaces/{namespace}/{res['name']}"
        return f"{prefix}/{res['name']}"

    # ------------------------------------------------------------------
    # CRUD

    def create(self, obj: dict) -> dict:
        gvk = GVK.from_api_version(obj.get("apiVersion", ""),
                                   obj.get("kind", ""))
        ns = (obj.get("metadata") or {}).get("namespace")
        return self._json("POST", self._collection(gvk, ns), obj)

    def update(self, obj: dict) -> dict:
        gvk = GVK.from_api_version(obj.get("apiVersion", ""),
                                   obj.get("kind", ""))
        meta = obj.get("metadata") or {}
        path = (self._collection(gvk, meta.get("namespace"))
                + f"/{meta.get('name', '')}")
        return self._json("PUT", path, obj)

    def delete(self, gvk: GVK, name: str, namespace: str | None = None) -> None:
        self._json("DELETE", self._collection(gvk, namespace) + f"/{name}")

    def get(self, gvk: GVK, name: str, namespace: str | None = None) -> dict:
        return self._json("GET", self._collection(gvk, namespace) + f"/{name}")

    def try_get(self, gvk: GVK, name: str,
                namespace: str | None = None) -> dict | None:
        try:
            return self.get(gvk, name, namespace)
        except NotFoundError:
            return None

    def list(self, gvk: GVK) -> list[dict]:
        doc = self._json("GET", self._collection(gvk, None))
        items = doc.get("items") or []
        for it in items:
            # list items omit apiVersion/kind; restore them
            it.setdefault("apiVersion", gvk.group_version
                          if gvk.group else gvk.version)
            it.setdefault("kind", gvk.kind)
        return items

    def _list_rv(self, gvk: GVK) -> tuple[list[dict], str]:
        doc = self._json("GET", self._collection(gvk, None))
        rv = (doc.get("metadata") or {}).get("resourceVersion", "")
        return doc.get("items") or [], rv

    # ------------------------------------------------------------------
    # watch

    def watch(self, gvk: GVK, callback: Callable[[Event], None]):
        stop = threading.Event()
        t = threading.Thread(target=self._watch_loop,
                             args=(gvk, callback, stop), daemon=True,
                             name=f"watch-{gvk.kind}")
        t.start()

        def unsubscribe():
            stop.set()
        return unsubscribe

    def _watch_loop(self, gvk: GVK, callback, stop: threading.Event) -> None:
        rv = ""
        known: set[tuple] = set()     # (ns, name) seen alive on this watch
        api_version = gvk.group_version if gvk.group else gvk.version

        def key_of(obj) -> tuple:
            m = obj.get("metadata") or {}
            return (m.get("namespace"), m.get("name", ""))

        while not (stop.is_set() or self._stop.is_set()):
            try:
                if not rv:
                    items, rv = self._list_rv(gvk)
                    fresh = set()
                    for it in items:
                        it.setdefault("apiVersion", api_version)
                        it.setdefault("kind", gvk.kind)
                        fresh.add(key_of(it))
                        callback(Event(MODIFIED, it))
                    # objects deleted while the watch was down never get
                    # a DELETED on the new stream: synthesize them from
                    # the key-set diff (informers compute deletions on
                    # re-list the same way)
                    for ns, name in known - fresh:
                        obj = {"apiVersion": api_version, "kind": gvk.kind,
                               "metadata": {"name": name}}
                        if ns is not None:
                            obj["metadata"]["namespace"] = ns
                        callback(Event(DELETED, obj))
                    known = fresh
                path = (self._collection(gvk, None)
                        + f"?watch=1&resourceVersion={rv}"
                        + "&allowWatchBookmarks=true")
                with self._request("GET", path,
                                   timeout=self._resync) as resp:
                    for line in resp:
                        if stop.is_set() or self._stop.is_set():
                            return
                        if not line.strip():
                            continue
                        ev = json.loads(line)
                        etype, obj = ev.get("type"), ev.get("object") or {}
                        if etype == "BOOKMARK":
                            rv = (obj.get("metadata") or {}) \
                                .get("resourceVersion", rv)
                            continue
                        if etype == "ERROR":
                            rv = ""       # 410 Gone: re-list
                            break
                        if etype in (ADDED, MODIFIED, DELETED):
                            rv = (obj.get("metadata") or {}) \
                                .get("resourceVersion", rv)
                            k = key_of(obj)
                            if etype == DELETED:
                                known.discard(k)
                            else:
                                known.add(k)
                            callback(Event(etype, obj))
            except NotFoundError:
                # the resource (CRD) vanished from the apiserver: drop
                # the cached discovery entry so kind_served() turns
                # false and the watch manager can retire this GVK
                # instead of re-listing 404s forever
                _log.info("watched resource gone; invalidating discovery",
                          gvk=str(gvk))
                self._invalidate(gvk.group_version)
                rv = ""
                stop.wait(self._watch_backoff)
            except (ApiError, OSError, ValueError) as e:
                # connection drop / transient failure: back off, re-list
                _log.debug("watch stream interrupted; re-listing",
                           gvk=str(gvk), error=e)
                rv = ""
                stop.wait(self._watch_backoff)
