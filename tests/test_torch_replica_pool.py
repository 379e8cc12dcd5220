"""The port's ReplicaPool: the eight flows of tests/test_replica_pool.py
over ``EngineWorker(TorchDriver(device="cpu"))`` replicas — broadcast
mutations and round-robin reviews indistinguishable from one JaxDriver,
eviction of a replica whose broadcast fails, failover of queries — and
``spawn_workers(..., device="cpu")`` for the subprocess flow, plus a
worker that cannot start making ``spawn_workers`` raise.
"""

import pytest

from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch.client.client import Backend
from gatekeeper_tpu_torch.client.remote_driver import (EngineWorker,
                                                       RemoteDriver)
from gatekeeper_tpu_torch.client.replica_pool import ReplicaPool
from gatekeeper_tpu_torch.client.targets import WipeData
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.errors import ClientError
from gatekeeper_tpu_torch.library import constraint_doc, template_doc
from gatekeeper_tpu_torch.library.templates import LIBRARY
from gatekeeper_tpu_torch.target.k8s import TARGET_NAME, K8sValidationTarget


def _ns(name, labels):
    return {"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": name, "labels": labels}}


def _setup(client):
    client.add_template(template_doc("K8sRequiredLabels",
                                     LIBRARY["K8sRequiredLabels"][0]))
    client.add_constraint(constraint_doc("K8sRequiredLabels", "need-owner",
                                         {"labels": ["owner"]}))
    client.add_data_batch([_ns("good", {"owner": "me"}), _ns("bad-a", {}),
                           _ns("bad-b", {})])


def _audit_names(client):
    resp = client.audit(limit_per_constraint=20)
    return sorted((r.resource or {}).get("metadata", {}).get("name")
                  for r in resp.by_target[TARGET_NAME].results)


def _review(name, labels):
    return {"kind": {"group": "", "version": "v1", "kind": "Namespace"},
            "name": name, "operation": "CREATE", "object": _ns(name, labels)}


def _kill(driver):
    """Point a replica's RemoteDriver at a port nothing listens on."""
    driver.url = "http://127.0.0.1:1"
    driver._host, driver._port = "127.0.0.1", 1
    driver._local.__dict__.clear()


@pytest.fixture(autouse=True)
def _device_path_at_test_sizes(monkeypatch):
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)


@pytest.fixture()
def pool2():
    workers = [EngineWorker(TorchDriver(device="cpu")),
               EngineWorker(TorchDriver(device="cpu"))]
    for w in workers:
        w.start()
    pool = ReplicaPool([RemoteDriver(w.url) for w in workers])
    yield pool
    for w in workers:
        w.stop()


class TestReplicaPool:
    def test_matches_single_driver(self, pool2):
        ref = JBackend(JaxDriver()).new_client([JTarget()])
        _setup(ref)
        c = Backend(pool2).new_client([K8sValidationTarget()])
        _setup(c)
        assert _audit_names(c) == _audit_names(ref) == ["bad-a", "bad-b"]

    def test_reviews_consistent_across_replicas(self, pool2):
        ref = JBackend(JaxDriver()).new_client([JTarget()])
        _setup(ref)
        c = Backend(pool2).new_client([K8sValidationTarget()])
        _setup(c)
        # round-robin: consecutive reviews land on different replicas
        # and must return the reference's verdict
        want = [r.msg for r in ref.review(_review("n", {}))
                .by_target[TARGET_NAME].results]
        outs = [[r.msg for r in c.review(_review("n", {}))
                 .by_target[TARGET_NAME].results] for _ in range(4)]
        assert len(want) == 1 and all(o == want for o in outs)

    def test_mutations_reach_every_replica(self, pool2):
        c = Backend(pool2).new_client([K8sValidationTarget()])
        _setup(c)
        c.remove_data(_ns("bad-b", {}))
        for d in pool2.drivers:
            results, _ = d.query_audit(TARGET_NAME, None)
            names = sorted((r.review or {}).get("name") for r in results)
            assert names == ["bad-a"], names

    def test_wipe_broadcasts(self, pool2):
        c = Backend(pool2).new_client([K8sValidationTarget()])
        _setup(c)
        c.remove_data(WipeData())
        for d in pool2.drivers:
            results, _ = d.query_audit(TARGET_NAME, None)
            assert results == []


class TestEviction:
    def test_failed_replica_leaves_rotation(self, pool2):
        c = Backend(pool2).new_client([K8sValidationTarget()])
        _setup(c)
        _kill(pool2.drivers[1])
        with pytest.raises(ClientError, match="evicted"):
            c.add_data(_ns("late", {}))
        assert len(pool2.drivers) == 1
        assert "late" in _audit_names(c)
        assert len(c.review(_review("q", {})).by_target[TARGET_NAME]
                   .results) == 1


class TestQueryFailover:
    def test_review_fails_over_to_survivor(self, pool2):
        c = Backend(pool2).new_client([K8sValidationTarget()])
        _setup(c)
        _kill(pool2.drivers[0])
        for _ in range(4):
            assert len(c.review(_review("n", {})).by_target[TARGET_NAME]
                       .results) == 1
        assert len(pool2.drivers) == 1

    def test_all_dead_raises(self, pool2):
        c = Backend(pool2).new_client([K8sValidationTarget()])
        _setup(c)
        for victim in list(pool2.drivers):
            _kill(victim)
        with pytest.raises(ClientError, match="all replicas failed"):
            c.review(_review("n", {}))


class TestSpawnWorkers:
    def test_subprocess_worker_end_to_end(self):
        with ReplicaPool.spawn_workers(1, timeout=120,
                                       device="cpu") as pool:
            procs = list(pool._procs)
            assert len(procs) == 1
            c = Backend(pool).new_client([K8sValidationTarget()])
            _setup(c)
            assert _audit_names(c) == ["bad-a", "bad-b"]
            assert c.review(_review("x", {"owner": "me"})) \
                .by_target[TARGET_NAME].results == []
        assert all(p.poll() is not None for p in procs)

    def test_a_worker_that_cannot_start_raises(self):
        """A worker whose device does not come up exits before it serves:
        ``spawn_workers`` raises and leaves no process running, and never
        retries on another device."""
        with pytest.raises(ClientError, match="failed to start"):
            ReplicaPool.spawn_workers(1, timeout=120, device="no-such")
