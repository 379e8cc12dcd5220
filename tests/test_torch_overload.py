"""The port's overload control held to the reference on the flows of
tests/test_overload.py: the bounded queue, deadline propagation and
cost-model batch sizing of the MicroBatcher, the brownout ladder's rungs
(deny never fails open) on the OverloadController and ValidationHandler,
and the QueueFull envelope.  Each flow runs on both packages (``pkg``:
"ref" and "port"); the parity tests drive one depth trace through both
OverloadControllers and one request sequence at every rung through both
ValidationHandlers (LocalDriver against LocalDriver, JaxDriver against
TorchDriver(device="cpu")) and hold the rungs and the answers equal.
The supervisor floor is always HEALTHY in the port (no backend
supervisor).
"""

import copy
import importlib
import random
import threading
import time
import types

import pytest

from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.webhook import overload as ol
from gatekeeper_tpu_torch.webhook.overload import OverloadController
from tests.test_control_plane import (constraint_obj, ns_obj, template_obj)
from tests.test_torch_webhook import review_request


def _pkg(name: str) -> types.SimpleNamespace:
    """The overload layer of package ``name`` ("ref" or "port")."""
    base = "gatekeeper_tpu" if name == "ref" else "gatekeeper_tpu_torch"
    mod = lambda n: importlib.import_module(f"{base}.{n}")
    batcher = mod("webhook.batcher")

    def device_driver():
        if name == "ref":
            return mod("engine.jax_driver").JaxDriver()
        return TorchDriver(device="cpu")

    return types.SimpleNamespace(
        name=name, ol=mod("webhook.overload"),
        MicroBatcher=batcher.MicroBatcher, QueueFull=batcher.QueueFull,
        SubmitTimeout=batcher.SubmitTimeout,
        ValidationHandler=mod("webhook.policy").ValidationHandler,
        parse_timeout=mod("webhook.server")._parse_timeout_param,
        Backend=mod("client.client").Backend,
        LocalDriver=mod("client.local_driver").LocalDriver,
        Target=mod("target.k8s").K8sValidationTarget,
        device_driver=device_driver,
        recorder=mod("obs.flightrecorder").get_flight_recorder)


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return _pkg(request.param)


# ---------------------------------------------------------------------------
# bounded queue


class TestBoundedQueue:
    def test_burst_over_capacity_sheds_not_buffers(self, pkg):
        """A burst at 4x max_batch against a stalled evaluator must keep
        the queue at its bound and reject the overflow with QueueFull —
        bounded memory, not an unbounded buffer."""
        release = threading.Event()
        max_batch, capacity = 8, 16

        def evaluate(reqs):
            release.wait(10)
            return [{"i": r["i"]} for r in reqs]

        b = pkg.MicroBatcher(evaluate, max_batch=max_batch, max_wait=0,
                         capacity=capacity, submit_timeout=10)
        b.start()
        n = 4 * max_batch + capacity
        outcomes: list = [None] * n
        threads = []

        def submit(i):
            try:
                outcomes[i] = b.submit({"i": i})
            except pkg.QueueFull:
                outcomes[i] = "queue_full"

        try:
            for i in range(n):
                threads.append(threading.Thread(target=submit, args=(i,)))
                threads[-1].start()
            # wait until every submit either queued or bounced
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                settled = sum(o == "queue_full" for o in outcomes)
                # queued = in the queue or taken into the stalled batch
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
        # everyone either evaluated or was explicitly shed — no losses
        assert all(o is not None for o in outcomes)
        shed = b.metrics.snapshot().get(
            'admission_shed_total{reason="queue_full"}', 0)
        assert shed == bounced > 0

    def test_capacity_env(self, pkg, monkeypatch):
        monkeypatch.setenv("GATEKEEPER_ADMISSION_QUEUE", "3")
        b = pkg.MicroBatcher(lambda reqs: [None] * len(reqs))
        assert b.capacity == 3
        monkeypatch.setenv("GATEKEEPER_ADMISSION_QUEUE", "bogus")
        assert pkg.MicroBatcher(lambda r: r).capacity == 2048


# ---------------------------------------------------------------------------
# deadline propagation


class TestDeadlines:
    def test_pre_expired_deadline_rejected_without_queueing(self, pkg):
        b = pkg.MicroBatcher(lambda reqs: [None] * len(reqs), submit_timeout=5)
        b.start()
        try:
            with pytest.raises(pkg.SubmitTimeout):
                b.submit({"x": 1}, deadline=time.monotonic() - 0.01)
            assert b.metrics.snapshot().get(
                "admission_expired_dropped", 0) == 1
        finally:
            b.stop()

    def test_expired_entries_dropped_at_formation(self, pkg):
        """Entries whose deadline passes while queued are dropped at
        batch formation — never evaluated — and their waiters get
        SubmitTimeout."""
        stall = threading.Event()
        evaluated: list = []

        def evaluate(reqs):
            evaluated.extend(r["i"] for r in reqs)
            return [None] * len(reqs)

        b = pkg.MicroBatcher(evaluate, max_batch=4, max_wait=0,
                         submit_timeout=5)
        # no worker yet: queue entries by hand through submit on threads
        b.start()
        # jam the worker with a slow first batch so later entries expire
        def slow_first(reqs):
            stall.wait(2)
            evaluated.extend(r["i"] for r in reqs)
            return [None] * len(reqs)
        b.evaluate_batch = slow_first
        errs: list = []

        def submit_short(i):
            try:
                b.submit({"i": i}, deadline=time.monotonic() + 0.15)
            except pkg.SubmitTimeout as e:
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

    def test_cost_model_shrinks_batch_to_tightest_deadline(self, pkg):
        """With a calibrated predictor saying a big batch misses the
        tightest deadline, formation halves the batch until it fits and
        re-queues the remainder."""
        gate = threading.Event()
        first_taken = threading.Event()
        sizes: list = []

        def evaluate(reqs):
            sizes.append(len(reqs))
            first_taken.set()
            gate.wait(5)
            return [None] * len(reqs)

        # predictor: >4 reviews blows the budget, <=4 fits easily
        b = pkg.MicroBatcher(evaluate, max_batch=8, max_wait=0,
                         submit_timeout=5,
                         predict_seconds=lambda n: 10.0 if n > 4 else 0.01)
        b.start()
        threads = [threading.Thread(
            target=lambda: b.submit({"x": 1},
                                    deadline=time.monotonic() + 5.0))
            for _ in range(8)]
        threads[0].start()
        assert first_taken.wait(2)  # worker now parked on gate
        for t in threads[1:]:
            t.start()
        deadline = time.monotonic() + 2
        while b.depth() < 7 and time.monotonic() < deadline:
            time.sleep(0.01)
        gate.set()
        for t in threads:
            t.join(5)
        b.stop()
        # the 7 queued entries predicted over-budget: halved to 3, the
        # rest re-queued and served in a following, fitting, batch
        assert max(sizes[1:]) <= 4
        assert sum(sizes) == 8
        assert b.metrics.snapshot().get(
            "admission_batch_deadline_shrinks", 0) >= 1

    def test_parse_timeout_param(self, pkg):
        assert pkg.parse_timeout("timeout=10s") == 10.0
        assert pkg.parse_timeout("timeout=2") == 2.0
        assert pkg.parse_timeout("a=b&timeout=5s&c=d") == 5.0
        assert pkg.parse_timeout("") is None
        assert pkg.parse_timeout("timeout=") is None
        assert pkg.parse_timeout("timeout=wat") is None
        assert pkg.parse_timeout("timeout=0s") is None


# ---------------------------------------------------------------------------
# the brownout ladder


def _client(pkg, driver=None, actions=("deny",)):
    c = pkg.Backend(driver or pkg.LocalDriver()).new_client([pkg.Target()])
    c.add_template(template_obj())
    for i, a in enumerate(actions):
        con = constraint_obj(name=f"c-{a}-{i}")
        if a != "deny":
            con["spec"]["enforcementAction"] = a
        c.add_constraint(con)
    return c


class TestLadder:
    def test_rung_thresholds_and_hysteresis(self, pkg, monkeypatch):
        monkeypatch.setenv("GATEKEEPER_BROWNOUT", "auto")
        monkeypatch.setenv("GATEKEEPER_BROWNOUT_DECAY_S", "0.05")
        depth = [0]
        c = pkg.ol.OverloadController(lambda: depth[0], capacity=100)
        assert c.rung() == pkg.ol.HEALTHY
        depth[0] = 55
        assert c.rung() == pkg.ol.SHED_DRYRUN
        depth[0] = 96
        assert c.rung() == pkg.ol.FAIL_STATIC     # escalation is instant
        depth[0] = 0
        assert c.rung() == pkg.ol.FAIL_STATIC     # arms the calm timer
        time.sleep(0.07)
        assert c.rung() == pkg.ol.SCALAR_ONLY     # one rung per window
        assert c.rung() == pkg.ol.SCALAR_ONLY     # re-arms the timer
        time.sleep(0.07)
        assert c.rung() == pkg.ol.SHED_WARN

    def test_forced_rung_env(self, pkg, monkeypatch):
        monkeypatch.setenv("GATEKEEPER_BROWNOUT", "3")
        c = pkg.ol.OverloadController(lambda: 0, capacity=10)
        assert c.rung() == pkg.ol.SCALAR_ONLY
        monkeypatch.setenv("GATEKEEPER_BROWNOUT", "off")
        assert c.rung() == pkg.ol.HEALTHY

    def test_shed_sets_never_contain_deny(self, pkg):
        c = pkg.ol.OverloadController(lambda: 0, capacity=10)
        for rung in range(5):
            assert "deny" not in c.shed_actions(rung)

    @pytest.mark.parametrize("rung", [1, 2, 3])
    def test_deny_enforced_at_every_evaluating_rung(self, pkg, rung,
                                                    monkeypatch):
        """Rungs 1-3 still evaluate deny constraints — a violating
        request is denied 403 with the same message as healthy."""
        monkeypatch.setenv("GATEKEEPER_BROWNOUT", str(rung))
        client = _client(pkg, actions=("deny", "warn", "dryrun"))
        c = pkg.ol.OverloadController(lambda: 0, capacity=10)
        h = pkg.ValidationHandler(client, overload=c)
        resp = h.handle(review_request(ns_obj("bad")))
        assert resp["allowed"] is False
        assert resp["status"]["code"] == 403
        assert "[denied by c-deny-0]" in resp["status"]["message"]
        # and a clean request still passes
        ok = h.handle(review_request(ns_obj("ok", {"gatekeeper": "on"})))
        assert ok["allowed"] is True

    def test_fail_static_fails_closed_with_deny_installed(self, pkg,
                                                          monkeypatch):
        monkeypatch.setenv("GATEKEEPER_BROWNOUT", "4")
        client = _client(pkg, actions=("deny",))
        c = pkg.ol.OverloadController(lambda: 0, capacity=10)
        h = pkg.ValidationHandler(client, overload=c)
        resp = h.handle(review_request(ns_obj("bad")))
        assert resp["allowed"] is False
        assert resp["status"]["code"] == 429
        assert h.metrics.snapshot().get("admission_failclosed", 0) == 1

    def test_fail_static_fails_open_without_deny(self, pkg, monkeypatch):
        monkeypatch.setenv("GATEKEEPER_BROWNOUT", "4")
        client = _client(pkg, actions=("warn", "dryrun"))
        c = pkg.ol.OverloadController(lambda: 0, capacity=10)
        h = pkg.ValidationHandler(client, overload=c)
        resp = h.handle(review_request(ns_obj("bad")))
        assert resp["allowed"] is True
        assert h.metrics.snapshot().get("admission_failopen", 0) == 1

    def test_shed_rungs_drop_warn_and_dryrun_output(self, pkg, monkeypatch):
        client = _client(pkg, actions=("deny", "warn", "dryrun"))
        c = pkg.ol.OverloadController(lambda: 0, capacity=10)
        h = pkg.ValidationHandler(client, overload=c)
        monkeypatch.setenv("GATEKEEPER_BROWNOUT", "0")
        healthy = h.handle(review_request(ns_obj("bad")))
        assert healthy.get("warnings")          # warn constraint speaks
        monkeypatch.setenv("GATEKEEPER_BROWNOUT", "2")
        browned = h.handle(review_request(ns_obj("bad")))
        assert not browned.get("warnings")      # warn shed
        assert browned["allowed"] is False      # deny intact
        shed = {k: v for k, v in c.metrics.snapshot().items()
                if k.startswith("admission_shed_total")}
        assert shed.get('admission_shed_total{reason="shed_warn"}', 0) >= 1
        assert shed.get('admission_shed_total{reason="shed_dryrun"}', 0) >= 1

    def test_transitions_reach_the_flight_recorder(self, pkg, monkeypatch):
        monkeypatch.setenv("GATEKEEPER_BROWNOUT", "auto")
        depth = [0]
        seen = []
        c = pkg.ol.OverloadController(lambda: depth[0], capacity=100)
        c.add_listener(lambda frm, to, p: seen.append((frm, to)))
        depth[0] = 72
        assert c.rung() == pkg.ol.SHED_WARN
        assert seen == [(pkg.ol.HEALTHY, pkg.ol.SHED_WARN)]
        ev = [e for e in pkg.recorder().snapshot()
              if e["type"] == "brownout_rung"][-1]
        assert (ev["frm"], ev["to"]) == ("healthy", "shed_warn")


class _Clock:
    """A monotonic clock the test moves by hand."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now


def test_ladder_trace_equals_the_reference(monkeypatch):
    """One seeded trace of queue depths, SCALAR_ONLY bypasses, clock
    steps and GATEKEEPER_BROWNOUT settings drives both
    OverloadControllers: the rung after every step, the transitions the
    listeners see, the high-water mark and the gauge are equal."""
    monkeypatch.setenv("GATEKEEPER_BROWNOUT_DECAY_S", "0.5")
    rng = random.Random(7)
    sides = []
    for name in ("ref", "port"):
        p = _pkg(name)
        clock = _Clock()
        monkeypatch.setattr(p.ol, "time", clock)
        depth = [0]
        c = p.ol.OverloadController(lambda: depth[0], capacity=100)
        seen = []
        c.add_listener(lambda frm, to, pr, seen=seen: seen.append((frm, to)))
        sides.append((c, clock, depth, seen))
    rungs = {0: [], 1: []}
    modes = ["auto"] * 12 + ["off", "0", "1", "2", "3", "4", "bogus"]
    for step in range(600):
        mode = rng.choice(modes) if step % 40 == 39 else "auto"
        monkeypatch.setenv("GATEKEEPER_BROWNOUT", mode)
        if step % 30 == 0:      # a new load regime: calm to saturated,
            # with the hysteresis band below each engage threshold
            level = rng.choice([0, 0, 10, 30, 43, 49, 50, 63, 69, 70, 78,
                                84, 85, 88, 94, 95, 100])
        d = max(0, min(100, level + rng.randint(-3, 3)))
        dt = rng.choice([0.0, 0.1, 0.3, 0.5, 0.6])
        bypass = rng.random() < 0.1
        for i, (c, clock, depth, _) in enumerate(sides):
            depth[0] = d
            clock.now += dt
            if bypass:
                c.scalar_begin()
            rungs[i].append(c.rung())
            if bypass:
                c.scalar_end()
    assert rungs[0] == rungs[1]
    assert set(rungs[1]) == set(range(5))      # the trace visits every rung
    (rc, _, _, rseen), (pc, _, _, pseen) = sides
    assert pseen == rseen and len(pseen) > 20
    assert pc.max_rung == rc.max_rung
    assert pc.metrics.snapshot() == rc.metrics.snapshot()


def _brownout_requests() -> list[dict]:
    reqs = [review_request(ns_obj("bad")),
            review_request(ns_obj("ok", {"gatekeeper": "on"})),
            review_request(ns_obj("other", {"team": "a"}), user="bob"),
            review_request(ns_obj("gone"), operation="DELETE",
                           old=ns_obj("gone")),
            review_request(ns_obj("fixed", {"gatekeeper": "on"}),
                           operation="UPDATE", old=ns_obj("fixed"))]
    for i, r in enumerate(reqs):
        r["uid"] = f"u{i}"
    return reqs


@pytest.mark.parametrize("driver", ["local", "device"])
def test_brownout_answers_equal_the_reference(driver, monkeypatch):
    """The same requests at every forced GATEKEEPER_BROWNOUT rung, with
    deny, warn and dryrun constraints installed or only warn and dryrun,
    through the reference's ValidationHandler (LocalDriver or JaxDriver)
    and the port's (LocalDriver or TorchDriver on the CPU): every answer
    is equal field for field, and so are the shed, fail-open and
    fail-closed counters."""
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    shapes = set()
    for actions in (("deny", "warn", "dryrun"), ("warn", "dryrun")):
        handlers = []
        for name in ("ref", "port"):
            p = _pkg(name)
            drv = p.LocalDriver() if driver == "local" else p.device_driver()
            c = p.ol.OverloadController(lambda: 0, capacity=10)
            handlers.append(p.ValidationHandler(
                _client(p, drv, actions), overload=c))
        ref, port = handlers
        for mode in ("off", "auto", "0", "1", "2", "3", "4"):
            monkeypatch.setenv("GATEKEEPER_BROWNOUT", mode)
            for req in _brownout_requests():
                want = ref.handle(copy.deepcopy(req))
                got = port.handle(copy.deepcopy(req))
                assert got == want, (actions, mode, req["uid"])
                shapes.add((got["allowed"], got["status"]["code"],
                            bool(got.get("warnings"))))
        for h_ref, h_port in ((ref, port), (ref.overload, port.overload)):
            # the counters and gauges (latency histograms differ)
            want = {k: v for k, v in h_ref.metrics.snapshot().items()
                    if k.startswith("admission_") and not isinstance(v, dict)}
            got = {k: v for k, v in h_port.metrics.snapshot().items()
                   if k.startswith("admission_") and not isinstance(v, dict)}
            assert got == want and got
    # the sequence reaches every answer shape: denied, allowed with and
    # without warnings, fail-closed
    assert {(False, 403, True), (True, 200, True), (True, 200, False),
            (False, 429, False)} <= shapes, shapes


def _queue_full_answer(pkg, driver: str) -> dict:
    """A full queue (the worker held, its one slot taken) and a third
    request: the handler's answer."""
    drv = pkg.LocalDriver() if driver == "local" else pkg.device_driver()
    client = _client(pkg, drv, actions=("deny",))
    release = threading.Event()

    def evaluate(reqs):
        release.wait(5)
        return client.review_batch(reqs)

    b = pkg.MicroBatcher(evaluate, max_batch=1, max_wait=0, capacity=1,
                         submit_timeout=5)
    c = pkg.ol.OverloadController(b.depth, capacity=1)
    h = pkg.ValidationHandler(client, batcher=b, overload=c,
                              batch_mode="always")
    b.start()
    threads = []
    try:
        # occupy the worker + fill the 1-slot queue
        for name in ("a", "b"):
            threads.append(threading.Thread(
                target=lambda n=name: h.handle(review_request(ns_obj(n)))))
            threads[-1].start()
            time.sleep(0.1)
        return h.handle(review_request(ns_obj("c")))
    finally:
        release.set()
        for t in threads:
            t.join(5)
        b.stop()


class TestQueueFullEnvelope:
    @pytest.mark.parametrize("driver", ["local", "device"])
    def test_queue_full_rides_failure_policy(self, driver, monkeypatch):
        """A full queue surfaces as QueueFull, and the handler answers
        per failurePolicy: 429 fail-closed with deny installed, the
        port's answer equal to the reference's."""
        monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
        want = _queue_full_answer(_pkg("ref"), driver)
        got = _queue_full_answer(_pkg("port"), driver)
        assert got == want
        assert got["allowed"] is False
        assert got["status"]["code"] == 429
        assert "retry" in got["status"]["message"]


class TestSupervisorFloor:
    def test_floor_is_always_healthy(self, monkeypatch):
        """A ladder handed no supervisor (a driver without a device) has
        nothing to floor: a calm queue reads HEALTHY.  The floor of a
        ladder with a supervisor is the next test's; this one keeps the
        name it had while the port's ladder had no floor."""
        monkeypatch.setenv("GATEKEEPER_BROWNOUT", "auto")
        c = OverloadController(lambda: 0, capacity=10)
        assert c._supervisor_floor() == ol.HEALTHY
        assert c.rung() == ol.HEALTHY
        assert c.max_rung == ol.HEALTHY

    @pytest.mark.parametrize("state, want", [
        ("healthy", ol.HEALTHY), ("degraded", ol.SHED_DRYRUN),
        ("recovering", ol.SHED_DRYRUN), ("poisoned", ol.SCALAR_ONLY)])
    def test_floor_per_state_equals_the_reference(self, state, want,
                                                  monkeypatch):
        """The floor of each supervisor state, the port's ladder reading
        the supervisor of its driver's device, the reference's its
        process supervisor; a calm queue sits on the floor."""
        from gatekeeper_tpu.resilience import supervisor as jsup
        from gatekeeper_tpu.utils import device_probe
        from gatekeeper_tpu.webhook.overload import \
            OverloadController as JController
        from gatekeeper_tpu_torch.resilience import supervisor as tsup
        monkeypatch.setenv("GATEKEEPER_BROWNOUT", "auto")
        monkeypatch.setenv("GATEKEEPER_SUPERVISOR_REPROBE", "0")
        tsup.reset_for_tests()
        device_probe.reset_for_tests()
        try:
            drv = TorchDriver(device="cpu")
            rs = jsup.get_supervisor()
            assert rs.state == jsup.HEALTHY
            for sup in (drv.supervisor, rs):
                sup._state = state
            c = OverloadController(lambda: 0, capacity=10,
                                   supervisor=drv.supervisor)
            assert c._supervisor_floor() == \
                JController(lambda: 0, capacity=10)._supervisor_floor() \
                == want
            assert c.rung() == want
        finally:
            tsup.reset_for_tests()
            device_probe.reset_for_tests()
