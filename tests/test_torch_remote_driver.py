"""The port's engine worker split: the six flows of
tests/test_remote_driver.py on ``EngineWorker(TorchDriver(device="cpu"))``,
results equal to JaxDriver's and the scalar oracle's through the HTTP
seam; the ``full`` wire difference against the reference's worker; and
``python -m gatekeeper_tpu_torch.cmd.worker`` defaulting to the card.
"""

import random

import pytest
import torch

from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.client.local_driver import LocalDriver
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch.client.client import Backend
from gatekeeper_tpu_torch.client.interface import QueryOpts
from gatekeeper_tpu_torch.client.remote_driver import (EngineWorker,
                                                       RemoteDriver)
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.errors import ClientError
from gatekeeper_tpu_torch.target.k8s import TARGET_NAME, K8sValidationTarget
from tests.test_jax_driver import (_rand_pod, _results_key, _setup,
                                   constraint_doc, template_doc)
from tests.test_lowering import REQUIRED_LABELS

REVIEW = {"kind": {"group": "", "version": "v1", "kind": "Pod"},
          "name": "x", "namespace": "prod", "operation": "CREATE",
          "object": {"metadata": {"name": "x", "namespace": "prod"},
                     "spec": {"containers": [{"name": "c",
                                              "image": "docker.io/evil"}]}}}


@pytest.fixture(autouse=True)
def _device_path_at_test_sizes(monkeypatch):
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)


@pytest.fixture()
def worker():
    w = EngineWorker(TorchDriver(device="cpu"))
    w.start()
    yield w
    w.stop()


def _remote(worker):
    return Backend(RemoteDriver(worker.url)).new_client(
        [K8sValidationTarget()])


def test_remote_matches_reference(worker):
    """Audit and review through the worker equal JaxDriver's and the
    scalar oracle's on the same store."""
    ref = JBackend(JaxDriver()).new_client([JTarget()])
    local = JBackend(LocalDriver()).new_client([JTarget()])
    remote = _remote(worker)
    for c in (ref, local, remote):
        _setup(c, n_pods=25)
    rres = [_results_key(r) for r in remote.audit().results()]
    assert rres
    assert rres == [_results_key(r) for r in ref.audit().results()] \
        == [_results_key(r) for r in local.audit().results()]
    rrev = [_results_key(r) for r in remote.review(REVIEW).results()]
    assert rrev
    assert rrev == [_results_key(r) for r in ref.review(REVIEW).results()]
    # a Result's metadata and review survive the JSON round trip
    got = remote.audit(limit_per_constraint=20).results()
    want = ref.audit(limit_per_constraint=20).results()
    assert [(r.metadata, r.review, r.enforcement_action) for r in got] == \
        [(r.metadata, r.review, r.enforcement_action) for r in want]
    assert worker.driver.executor.reduces > 0   # the device path ran


def test_remote_lifecycle_and_caps(worker):
    remote = _remote(worker)
    _setup(remote, n_pods=30)
    capped, _ = remote.driver.query_audit(
        TARGET_NAME, QueryOpts(limit_per_constraint=2))
    by: dict = {}
    for r in capped:
        by.setdefault(r.constraint["metadata"]["name"], set()).add(
            (r.review or {}).get("name"))
    assert by and all(len(v) <= 2 for v in by.values())
    remote.remove_constraint(constraint_doc("K8sRequiredLabels", "need-app"))
    res = remote.audit().results()
    assert not any(r.constraint["metadata"]["name"] == "need-app"
                   for r in res)
    assert TARGET_NAME in remote.driver.dump()


def test_remote_worker_error_surfaces(worker):
    with pytest.raises(ClientError):
        RemoteDriver(worker.url).query_audit("no-such-target")


def test_remote_unreachable():
    drv = RemoteDriver("http://127.0.0.1:9")   # discard port, nothing listens
    with pytest.raises(ClientError):
        drv.dump()


def test_factory_worker_resets_on_init():
    """A factory-backed worker gives each (re)connecting control plane a
    fresh engine: state from a previous manager must not leak."""
    w = EngineWorker(lambda: TorchDriver(device="cpu"))
    w.start()
    try:
        c1 = Backend(RemoteDriver(w.url)).new_client([K8sValidationTarget()])
        c1.add_template(template_doc("K8sRequiredLabels", REQUIRED_LABELS))
        c1.add_constraint(constraint_doc("K8sRequiredLabels", "stale",
                                         {"labels": ["x"]}))
        c1.add_data(_rand_pod(random.Random(1), 1))
        assert c1.audit().results()
        first = w.driver
        c2 = Backend(RemoteDriver(w.url)).new_client([K8sValidationTarget()])
        assert w.driver is not first
        assert c2.audit().results() == []
        assert c2.driver.dump()[TARGET_NAME]["templates"] == {}
    finally:
        w.stop()


def test_worker_stop_without_start_does_not_hang():
    w = EngineWorker(TorchDriver(device="cpu"))
    w.stop()   # must return promptly (regression: shutdown() deadlock)


@pytest.mark.parametrize("package", ["reference", "port"])
def test_full_crosses_the_wire_only_in_the_port(package, monkeypatch):
    """The reference's wire drops QueryOpts.full
    (gatekeeper_tpu/client/remote_driver.py:64-79): a remote
    ``audit(full=True)`` runs a memoized sweep in its worker, whose
    bindings cache survives.  The port's carries it: its worker runs a
    forced full sweep and rebuilds the cache.  Results equal either
    way."""
    from gatekeeper_tpu.client import remote_driver as ref
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    if package == "reference":
        w = ref.EngineWorker(JaxDriver())
        w.start()
        c = JBackend(ref.RemoteDriver(w.url)).new_client([JTarget()])
    else:
        w = EngineWorker(TorchDriver(device="cpu"))
        w.start()
        c = _remote(w)
    try:
        _setup(c, n_pods=25)
        memo = [_results_key(r) for r in c.audit().results()]
        before = w.driver.state[TARGET_NAME].bindings_cache
        assert before
        full = [_results_key(r) for r in c.audit(full=True).results()]
        assert full == memo
        rebuilt = w.driver.state[TARGET_NAME].bindings_cache is not before
        assert rebuilt is (package == "port")
        assert w.driver.last_sweep_phases["full"] is (package == "port")
    finally:
        w.stop()


def test_worker_defaults_to_the_card_and_raises_without_one(monkeypatch):
    from gatekeeper_tpu_torch.cmd import worker as cmd
    assert cmd.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cmd.main(["--port", "0"])


def test_a_burst_of_new_connections_is_served(worker):
    """64 threads open their keep-alive connections at once (a webhook's
    request threads each do): every call is answered.  With
    socketserver's accept queue of 5, as the reference's worker has,
    most of them were reset."""
    import threading
    drv = RemoteDriver(worker.url)
    barrier = threading.Barrier(64)
    errors: list = []

    def call():
        barrier.wait(timeout=30)
        try:
            drv.dump()
        except ClientError as e:
            errors.append(repr(e))

    threads = [threading.Thread(target=call) for _ in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
