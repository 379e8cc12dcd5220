"""The port's admission micro-batcher (``webhook/batcher.py``), on the CPU.

Ports of the batcher-only tests of the JAX package: the bounded queue
and the deadline handling of ``tests/test_overload.py``
(``TestBoundedQueue``; ``TestDeadlines`` but the server's timeout
parser, which the port lacks), the coalescing of
``tests/test_webhook.py::test_batches_coalesce`` over a port client (no
validation handler yet: ``Client.review_batch`` is the evaluator), and
the uncalibrated-predictor tests of ``tests/test_memsurface.py``
(``TestCostPrior``) on ``TorchDriver(device="cpu")``.  A last case
serves concurrent submits through ``client.review_batch`` with the
driver's device pass forced on and holds every response to the
per-review answer.
"""

import random
import threading
import time

import pytest

from gatekeeper_tpu.library import all_docs, make_mixed
from tests.test_control_plane import constraint_obj, ns_obj, template_obj
from tests.test_webhook import review_request

from gatekeeper_tpu_torch.analysis import costmodel
from gatekeeper_tpu_torch.client.client import Backend
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.target.k8s import TARGET_NAME, K8sValidationTarget
from gatekeeper_tpu_torch.webhook.batcher import (MicroBatcher, QueueFull,
                                                  SubmitTimeout,
                                                  queue_capacity_env)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in ("GATEKEEPER_ADMISSION_QUEUE", "GATEKEEPER_COST_PRIOR_UPS"):
        monkeypatch.delenv(var, raising=False)
    costmodel.reset_calibration()
    yield
    costmodel.reset_calibration()


# ---------------------------------------------------------------------------
# bounded queue


class TestBoundedQueue:
    def test_burst_over_capacity_sheds_not_buffers(self):
        """A burst at 4x max_batch against a stalled evaluator must keep
        the queue at its bound and reject the overflow with QueueFull —
        bounded memory, not an unbounded buffer."""
        release = threading.Event()
        max_batch, capacity = 8, 16

        def evaluate(reqs):
            release.wait(10)
            return [{"i": r["i"]} for r in reqs]

        b = MicroBatcher(evaluate, max_batch=max_batch, max_wait=0,
                         capacity=capacity, submit_timeout=10)
        b.start()
        n = 4 * max_batch + capacity
        outcomes: list = [None] * n
        threads = []

        def submit(i):
            try:
                outcomes[i] = b.submit({"i": i})
            except QueueFull:
                outcomes[i] = "queue_full"

        try:
            for i in range(n):
                threads.append(threading.Thread(target=submit, args=(i,)))
                threads[-1].start()
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                settled = sum(o == "queue_full" for o in outcomes)
                if settled + b.depth() + max_batch >= n:
                    break
                time.sleep(0.01)
            assert b.depth() <= capacity
            bounced = sum(o == "queue_full" for o in outcomes)
            assert bounced >= n - capacity - max_batch
        finally:
            release.set()
            for t in threads:
                t.join(5)
            b.stop()
        assert all(o is not None for o in outcomes)
        shed = b.metrics.snapshot().get(
            'admission_shed_total{reason="queue_full"}', 0)
        assert shed == bounced > 0

    def test_capacity_env(self, monkeypatch):
        monkeypatch.setenv("GATEKEEPER_ADMISSION_QUEUE", "3")
        b = MicroBatcher(lambda reqs: [None] * len(reqs))
        assert b.capacity == 3
        assert queue_capacity_env() == 3
        monkeypatch.setenv("GATEKEEPER_ADMISSION_QUEUE", "bogus")
        assert MicroBatcher(lambda r: r).capacity == 2048
        monkeypatch.setenv("GATEKEEPER_ADMISSION_QUEUE", "0")
        assert queue_capacity_env() == 1


# ---------------------------------------------------------------------------
# deadline propagation


class TestDeadlines:
    def test_pre_expired_deadline_rejected_without_queueing(self):
        b = MicroBatcher(lambda reqs: [None] * len(reqs), submit_timeout=5)
        b.start()
        try:
            with pytest.raises(SubmitTimeout):
                b.submit({"x": 1}, deadline=time.monotonic() - 0.01)
            assert b.metrics.snapshot().get(
                "admission_expired_dropped", 0) == 1
        finally:
            b.stop()

    def test_expired_entries_dropped_at_formation(self):
        """Entries whose deadline passes while queued are dropped at
        batch formation — never evaluated — and their waiters get
        SubmitTimeout."""
        stall = threading.Event()
        evaluated: list = []

        def evaluate(reqs):
            evaluated.extend(r["i"] for r in reqs)
            return [None] * len(reqs)

        b = MicroBatcher(evaluate, max_batch=4, max_wait=0,
                         submit_timeout=5)
        b.start()

        def slow_first(reqs):
            stall.wait(2)
            evaluated.extend(r["i"] for r in reqs)
            return [None] * len(reqs)
        b.evaluate_batch = slow_first
        errs: list = []

        def submit_short(i):
            try:
                b.submit({"i": i}, deadline=time.monotonic() + 0.15)
            except SubmitTimeout as e:
                errs.append((i, str(e)))

        t0 = threading.Thread(target=submit_short, args=(0,))
        t0.start()
        time.sleep(0.05)           # worker now stalled on batch [0]
        t1 = threading.Thread(target=submit_short, args=(1,))
        t1.start()
        time.sleep(0.3)            # entry 1 expires while queued
        b.evaluate_batch = evaluate
        stall.set()
        t0.join(5)
        t1.join(5)
        b.stop()
        assert 1 not in evaluated  # formation dropped it before dispatch
        assert len(errs) == 2      # both callers saw SubmitTimeout

    def test_cost_model_shrinks_batch_to_tightest_deadline(self):
        """With a predictor saying a big batch misses the tightest
        deadline, formation halves the batch until it fits and re-queues
        the remainder."""
        gate = threading.Event()
        first_taken = threading.Event()
        sizes: list = []

        def evaluate(reqs):
            sizes.append(len(reqs))
            first_taken.set()
            gate.wait(5)
            return [None] * len(reqs)

        b = MicroBatcher(evaluate, max_batch=8, max_wait=0,
                         submit_timeout=5,
                         predict_seconds=lambda n: 10.0 if n > 4 else 0.01)
        b.start()
        threads = [threading.Thread(
            target=lambda: b.submit({"x": 1},
                                    deadline=time.monotonic() + 5.0))
            for _ in range(8)]
        threads[0].start()
        assert first_taken.wait(2)
        for t in threads[1:]:
            t.start()
        deadline = time.monotonic() + 2
        while b.depth() < 7 and time.monotonic() < deadline:
            time.sleep(0.01)
        gate.set()
        for t in threads:
            t.join(5)
        b.stop()
        assert max(sizes[1:]) <= 4
        assert sum(sizes) == 8
        assert b.metrics.snapshot().get(
            "admission_batch_deadline_shrinks", 0) >= 1


# ---------------------------------------------------------------------------
# coalescing over a port client


def _ns_client():
    client = Backend(TorchDriver(device="cpu")).new_client(
        [K8sValidationTarget()])
    client.add_template(template_obj())
    client.add_constraint(constraint_obj())
    return client


def _allowed(responses) -> bool:
    return not any(r.results for r in responses.by_target.values())


def test_batches_coalesce():
    client = _ns_client()
    batcher = MicroBatcher(lambda reqs: client.review_batch(reqs),
                           max_batch=16, max_wait=0.01)
    batcher.start()
    try:
        results = [None] * 8

        def call(i):
            obj = ns_obj(f"ns{i}") if i % 2 else \
                ns_obj(f"ns{i}", {"gatekeeper": "on"})
            results[i] = batcher.submit(review_request(obj))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, r in enumerate(results):
            assert _allowed(r) is (i % 2 == 0), (i, r)
        assert batcher.metrics.counter("admission_batches").value >= 1
        assert batcher.metrics.counter("admission_batches").value < 8
    finally:
        batcher.stop()


def _keys(responses):
    return sorted((r.msg, r.constraint["metadata"]["name"])
                  for resp in responses.by_target.values()
                  for r in resp.results)


def test_concurrent_submits_through_the_device_pass(monkeypatch):
    """Concurrent submits coalesce into ``client.review_batch`` batches
    that take the driver's device pass (thresholds at 1), and every
    response equals the per-review answer."""
    monkeypatch.setattr(torch_driver, "REVIEW_BATCH_MIN_EVALS", 1)
    client = Backend(TorchDriver(device="cpu")).new_client(
        [K8sValidationTarget()])
    for t, c in all_docs():
        client.add_template(t)
        client.add_constraint(c)
    objs = make_mixed(random.Random(13), 48)
    reqs = [review_request(o, kind={"group": "", "version": "v1",
                                    "kind": o.get("kind", "")})
            for o in objs]
    for r, o in zip(reqs, objs):
        r["namespace"] = o["metadata"].get("namespace")
    want = [_keys(client.review(r)) for r in reqs]
    batcher = MicroBatcher(client.review_batch, max_batch=16, max_wait=0.01,
                           predict_seconds=client.predict_review_seconds)
    batcher.start()
    got = [None] * len(reqs)
    try:
        def worker(w):
            for i in range(w, len(reqs), 6):
                got[i] = _keys(batcher.submit(reqs[i]))

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        batcher.stop()
    assert got == want
    assert any(want)
    assert client.driver.metrics.counter("review_batches_device").value \
        == batcher.metrics.counter("admission_batches").value >= 1


# ---------------------------------------------------------------------------
# the static prior: deadline shrinking before calibration


class _FakePending:
    def __init__(self, deadline):
        self.request = {}
        self.ctx = None
        self.deadline = deadline
        self.withdrawn = False
        self.error = None
        self.response = None
        self.event = threading.Event()


def _kinds_driver():
    kinds = ["K8sRequiredLabels", "K8sAllowedRepos", "K8sContainerLimits"]
    by_kind = {d["spec"]["crd"]["spec"]["names"]["kind"]: (d, c)
               for d, c in all_docs()}
    drv = TorchDriver(device="cpu")
    client = Backend(drv).new_client([K8sValidationTarget()])
    for k in kinds:
        client.add_template(by_kind[k][0])
        client.add_constraint(by_kind[k][1])
    client.add_data_batch(make_mixed(random.Random(3), 40))
    return drv, client


def test_uncalibrated_predictor_has_an_opinion():
    drv, client = _kinds_driver()
    assert costmodel.current_scale() == 0.0
    pred = drv.predict_review_batch_seconds(TARGET_NAME, 16)
    assert pred is not None and pred > 0.0
    assert client.predict_review_seconds(16) == pred
    # Stage 7 (analysis/compilesurface.py): deadline shrinks step down
    # the certified rungs, 1 and the pow2 ladder from 8
    assert client.certified_review_rungs(64) == [1, 8, 16, 32, 64]


def test_deadline_shrink_uncalibrated():
    """With no calibration sample, the card's prior still prices a batch,
    so a deadline the batch cannot make shrinks it."""
    drv, _client = _kinds_driver()
    mb = MicroBatcher(
        evaluate_batch=lambda reqs: [None] * len(reqs),
        max_batch=64,
        predict_seconds=lambda n: drv.predict_review_batch_seconds(
            TARGET_NAME, n))
    take = [_FakePending(time.monotonic() + 1e-9) for _ in range(20)]
    keep = mb._fit_to_deadline(take)
    assert len(keep) < 20
    assert mb.depth() == 20 - len(keep)
