# Copied from gatekeeper_tpu/client/replica_pool.py for the PyTorch port.
"""Replicated engine pool: the reference's HA story as a Driver.

The reference scales admission horizontally: N webhook pods each hold a
FULL copy of the engine state (templates, constraints, synced data —
rebuilt per pod from watches) and the Service load-balances admission
requests across them (deploy/gatekeeper.yaml:161 StatefulSet +
pkg/util/ha_status.go per-pod status slots; no state is sharded).

``ReplicaPool`` packages that shape behind the Driver seam: mutations
broadcast to every replica (the watch-replication analogue), reviews
round-robin across replicas (the Service analogue), audits run on one
replica (the reference audits per pod too — results are idempotent
status writes).  With subprocess workers (``spawn_workers``) this turns
the GIL-bound scalar admission path into true multi-core serving on one
host, exactly as multiple pods would on one node.
"""

from __future__ import annotations

import itertools
import os
import subprocess
import sys
import threading
from typing import Any

from gatekeeper_tpu_torch.client.interface import Driver, QueryOpts
from gatekeeper_tpu_torch.client.remote_driver import (RemoteDriver,
                                                 WorkerUnreachableError)
from gatekeeper_tpu_torch.client.targets import TargetHandler
from gatekeeper_tpu_torch.errors import ClientError
from gatekeeper_tpu_torch.store.table import ResourceMeta


class ReplicaPool(Driver):
    """Driver fan-out over N equivalent replicas."""

    def __init__(self, drivers: list[Driver]):
        if not drivers:
            raise ClientError("ReplicaPool needs at least one replica")
        self.drivers = list(drivers)
        self._rr = itertools.count()
        self._procs: list[subprocess.Popen] = []

    # -- replica selection ------------------------------------------------

    def _next(self) -> Driver:
        return self.drivers[next(self._rr) % len(self.drivers)]

    def _all(self, fn: str, *args) -> list:
        """Apply a mutation on every replica.  A replica whose
        broadcast fails is EVICTED from rotation before the error
        surfaces — the remaining replicas stay mutually consistent and
        queries never round-robin onto half-updated state (the
        reference analogue: a failing pod drops out of the Service on
        readiness; it does not keep receiving admission traffic)."""
        out: list = []
        failed: list[tuple[Driver, Exception]] = []
        for d in list(self.drivers):
            try:
                out.append(getattr(d, fn)(*args))
            except Exception as e:
                failed.append((d, e))
        if failed:
            dead = {id(d) for d, _e in failed}
            survivors = [d for d in self.drivers if id(d) not in dead]
            if not survivors:
                raise ClientError(
                    f"all replicas failed {fn}: {failed[0][1]}")
            self.drivers = survivors     # atomic swap for readers
            raise ClientError(
                f"{len(failed)} replica(s) evicted after failed {fn}: "
                f"{failed[0][1]}")
        return out

    # -- Driver seam: mutations broadcast ---------------------------------

    def init(self, targets: dict[str, TargetHandler]) -> None:
        self._all("init", targets)

    def put_template(self, target: str, kind: str, compiled) -> None:
        self._all("put_template", target, kind, compiled)

    def delete_template(self, target: str, kind: str) -> None:
        self._all("delete_template", target, kind)

    def put_constraint(self, target: str, kind: str, name: str,
                       constraint: dict) -> None:
        self._all("put_constraint", target, kind, name, constraint)

    def delete_constraint(self, target: str, kind: str, name: str) -> None:
        self._all("delete_constraint", target, kind, name)

    def put_data(self, target: str, key: str, meta: ResourceMeta,
                 obj: dict) -> None:
        self._all("put_data", target, key, meta, obj)

    def put_data_batch(self, target: str, entries) -> None:
        self._all("put_data_batch", target, entries)

    def delete_data(self, target: str, key: str) -> bool:
        return any(self._all("delete_data", target, key))

    def wipe_data(self, target: str) -> None:
        self._all("wipe_data", target)

    # -- Driver seam: queries distributed ---------------------------------

    def _failover(self, fn_name: str, *args):
        """Run a query on the next replica; a replica that errors is
        evicted and the query fails over to the survivors (a crashed
        worker must not fail admission — the Service analogue routes
        around a dead pod).  Raises only when every replica failed."""
        last: Exception | None = None
        for _attempt in range(len(self.drivers)):
            d = self._next()
            try:
                return getattr(d, fn_name)(*args)
            except WorkerUnreachableError as e:
                # transport failure only: a semantic error (4xx the
                # worker answered with) would fail identically on
                # every replica and must surface, not cascade-evict
                last = e
                self.drivers = [x for x in self.drivers if x is not d] \
                    or self.drivers
                if len(self.drivers) == 1 and self.drivers[0] is d:
                    break       # d was the only replica left
        raise ClientError(f"all replicas failed {fn_name}: {last}")

    def query_review(self, target: str, review: dict,
                     opts: QueryOpts | None = None):
        return self._failover("query_review", target, review, opts)

    def query_review_batch(self, target: str, reviews: list[dict],
                           opts: QueryOpts | None = None) -> list[tuple]:
        return self._failover("query_review_batch", target, reviews, opts)

    def query_audit(self, target: str, opts: QueryOpts | None = None):
        # audits are whole-state queries; any single replica answers
        # (the reference runs the audit on each pod independently and
        # the status writes are last-writer-wins, ha_status.go)
        return self._failover("query_audit", target, opts)

    def dump(self) -> dict:
        return self.drivers[0].dump()

    # -- subprocess worker management -------------------------------------

    @classmethod
    def spawn_workers(cls, n: int, timeout: float = 60.0,
                      env: dict | None = None,
                      device: str = "cuda") -> "ReplicaPool":
        """Launch ``n`` engine-worker subprocesses
        (``python -m gatekeeper_tpu_torch.cmd.worker --device <device>``)
        on ephemeral ports and return a pool of RemoteDrivers over them.
        Workers are separate OS processes, so scalar admission
        evaluation escapes the GIL — one host serves like ``n`` webhook
        pods.  On a card each worker is a CUDA context of its own holding
        a whole copy of the store.  A worker that does not come up
        (``--device cuda`` without a card raises in it) makes this raise
        after every started worker is terminated; nothing falls back to
        the CPU.  The JAX package pins its children's ``JAX_PLATFORMS``
        when its own backend fell back; the port passes ``--device``."""
        procs: list[tuple[subprocess.Popen, str]] = []
        try:
            for _ in range(n):
                proc = subprocess.Popen(
                    [sys.executable, "-m", "gatekeeper_tpu_torch.cmd.worker",
                     "--port", "0", "--device", device],
                    stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                    env={**os.environ, **(env or {})}, text=True,
                    cwd=os.path.dirname(os.path.dirname(
                        os.path.dirname(os.path.abspath(__file__)))))
                procs.append((proc, ""))
                # the worker prints "engine worker up at <url>" once
                # ready; read it on a thread so a silently-hung worker
                # (stuck import, buffered output) cannot block past the
                # deadline — readline() alone would wait forever
                line = _readline_with_timeout(
                    proc.stderr, timeout,
                    lambda ln: "engine worker up at" in ln)
                if line is None or "engine worker up at" not in line:
                    raise ClientError(
                        f"worker failed to start within {timeout}s "
                        f"(exit={proc.poll()})")
                url = line.rsplit(" ", 1)[-1].strip()
                procs[-1] = (proc, url)
                # drain further stderr so the pipe never blocks the child
                threading.Thread(target=_drain, args=(proc.stderr,),
                                 daemon=True).start()
            pool = cls([RemoteDriver(url) for _proc, url in procs])
            pool._procs = [p for p, _u in procs]
            return pool
        except Exception:
            for proc, _url in procs:
                proc.terminate()
            for proc, _url in procs:
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
            raise

    def close(self) -> None:
        for proc in self._procs:
            proc.terminate()
        for proc in self._procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
        self._procs.clear()

    def __enter__(self) -> "ReplicaPool":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def _drain(stream) -> None:
    try:
        for _ in stream:
            pass
    except Exception:
        pass


def _readline_with_timeout(stream, timeout: float, want) -> str | None:
    """First line matching `want` (or the line that ended the stream),
    or None on timeout.  Runs the blocking readline on a daemon thread;
    on timeout the thread is abandoned (the caller terminates the
    subprocess, which unblocks it)."""
    box: list[str | None] = [None]
    done = threading.Event()

    def run():
        while True:
            ln = stream.readline()
            if not ln or want(ln):
                box[0] = ln or None
                done.set()
                return

    t = threading.Thread(target=run, daemon=True)
    t.start()
    done.wait(timeout)
    return box[0]
