"""The port's policy promotion and fleet graduation against the JAX
package, on the CPU (tests/test_rollout.py TestPromotionController,
TestFleetGraduation, TestPromotionStorm and TestFleetScale through
``gatekeeper_tpu_torch.rollout``).

The promotion state machine graduates only on recorded evidence (a
shadow sweep, then a batched corpus replay equal to the scalar one),
rejects on any unexpected denial, and rolls back atomically on a
brownout escalation.  Evidence digests equal the reference's on the
same live set, store and corpus.  The port has no snapshot tier (ROADMAP
A8): ``resume`` refuses under ``GATEKEEPER_SNAPSHOT_DIR`` where the
reference's warm-restart case resumes, and returns False without it.
Fleet graduation runs the stacked kernels (K3b, K1b, K2b) per block,
and the ``fleet_straggler`` fault holds only its cluster.
"""

import copy
import random
import threading
import time

import pytest

from gatekeeper_tpu import rollout as jrollout
from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.library import all_docs, make_mixed
from gatekeeper_tpu.resilience import faults as jfaults
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget
from gatekeeper_tpu.whatif import make_cluster as jmake_cluster

from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.obs import flightrecorder as tfr
from gatekeeper_tpu_torch.resilience import faults
from gatekeeper_tpu_torch.rollout import (BLOCKED, GRADUATED, HELD, REJECTED,
                                          ROLLED_BACK, PromotionController,
                                          graduate_fleet,
                                          live_enforcement_fingerprint)
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget
from gatekeeper_tpu_torch.webhook.overload import OverloadController
from gatekeeper_tpu_torch.webhook.policy import ValidationHandler
from gatekeeper_tpu_torch.whatif import make_cluster

N_TEMPLATES = 4          # tests/test_rollout.py's library prefix
N_ROWS = 60

# a pod the first-4 library constraints all allow (tests/test_rollout.py)
_GOOD_POD = {
    "apiVersion": "v1", "kind": "Pod",
    "metadata": {"name": "good-pod", "namespace": "default"},
    "spec": {
        "securityContext": {"seccompProfile": {"type": "RuntimeDefault"}},
        "containers": [
            {"name": "app", "image": "gcr.io/org/app:1.2",
             "securityContext": {
                 "allowPrivilegeEscalation": False,
                 "seccompProfile": {"type": "RuntimeDefault"}}}]}}


@pytest.fixture(autouse=True)
def _rollout_env(monkeypatch):
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    for var in ("GATEKEEPER_SNAPSHOT_DIR", "GATEKEEPER_FAULT",
                "GATEKEEPER_BROWNOUT"):
        monkeypatch.delenv(var, raising=False)
    faults.reset_for_tests()
    jfaults.reset_for_tests()
    yield
    faults.reset_for_tests()
    jfaults.reset_for_tests()


def _policy_subset(n=N_TEMPLATES):
    pairs = all_docs()[:n]
    return [t for t, _c in pairs], [c for _t, c in pairs]


def _mk_client(templates, constraints, n_rows=N_ROWS, seed=7):
    driver = TorchDriver(device="cpu")
    client = TBackend(driver).new_client([TTarget()])
    for d in templates:
        client.add_template(d)
    for d in constraints:
        client.add_constraint(d)
    client.add_data_batch(make_mixed(random.Random(seed), n_rows))
    return driver, client


def _mk_ref_client(templates, constraints, n_rows=N_ROWS, seed=7):
    client = JBackend(JaxDriver()).new_client([JTarget()])
    for d in templates:
        client.add_template(d)
    for d in constraints:
        client.add_constraint(d)
    client.add_data_batch(make_mixed(random.Random(seed), n_rows))
    return client


def _record_corpus(client, monkeypatch, tmp_path, n=24, seed=23,
                   extra_objs=()):
    """n admissions through the port's webhook handler into a capture
    log under tmp_path; the loaded events."""
    corpus = str(tmp_path / "corpus")
    monkeypatch.setenv("GATEKEEPER_FLIGHT_DIR", corpus)
    monkeypatch.setenv("GATEKEEPER_FLIGHT_ADMISSION", "1")
    monkeypatch.setattr(tfr, "_recorder", None)
    vh = ValidationHandler(client)
    objs = make_mixed(random.Random(seed), n) + list(extra_objs)
    for obj in objs:
        vh.handle({
            "uid": "u", "operation": "CREATE",
            "kind": {"group": "", "version": "v1",
                     "kind": obj.get("kind", "")},
            "name": (obj.get("metadata") or {}).get("name", ""),
            "userInfo": {"username": "t", "groups": []},
            "object": obj})
    events = tfr.load_admission_corpus(corpus)
    assert len(events) == len(objs)
    return events


def _evidence(ctrl):
    """The controller's evidence less its wall seconds."""
    return {rung: {k: v for k, v in ev.items() if not k.endswith("wall_s")}
            for rung, ev in ctrl.evidence.items()}


# ---------------------------------------------------------------------------
# the promotion controller


class TestPromotionController:
    def test_graduates_to_deny_with_the_reference_evidence(self, monkeypatch,
                                                           tmp_path):
        templates, constraints = _policy_subset()
        _d, client = _mk_client(templates, constraints)
        events = _record_corpus(client, monkeypatch, tmp_path)
        candidate = [dict(c) for c in constraints[1:]]     # drop one
        ctrl = PromotionController(client, templates, candidate,
                                   name="t-clean", events=events,
                                   verify_parity=True)
        assert ctrl.run(target_rung="deny") == "deny"
        assert [h["to"] for h in ctrl.history] == \
            ["shadow", "replayed", "dryrun", "warn", "deny"]
        g = ctrl.evidence["replay_gate"]
        assert g["parity"] is True and g["unexpected_denials"] == 0
        assert g["replayed"] == len(events)
        assert g["scalar_digest"] == g["batched_digest"]
        assert ctrl.evidence["shadow"]["oracle_parity"] is True
        for c in candidate:
            doc = client.constraints[c["kind"]][c["metadata"]["name"]]
            assert doc["spec"]["enforcementAction"] == "deny"
        # the reference, on the same live set, store and corpus
        jclient = _mk_ref_client(templates, constraints)
        jctrl = jrollout.PromotionController(
            jclient, templates, candidate, name="t-clean", events=events,
            verify_parity=True)
        assert jctrl.run(target_rung="deny") == "deny"
        assert _evidence(ctrl) == _evidence(jctrl)
        assert live_enforcement_fingerprint(client) == \
            jrollout.live_enforcement_fingerprint(jclient)

    def test_rejects_on_unexpected_denial(self, monkeypatch, tmp_path):
        templates, constraints = _policy_subset()
        _d, client = _mk_client(templates, constraints)
        events = _record_corpus(client, monkeypatch, tmp_path, n=32,
                                extra_objs=[copy.deepcopy(_GOOD_POD)])
        good = [e for e in events
                if (e["request"].get("object") or {})
                .get("metadata", {}).get("name") == "good-pod"]
        assert good and good[0]["allowed"] is True
        strict = copy.deepcopy(next(c for c in constraints
                                    if c["kind"] == "K8sAllowedRepos"))
        strict["metadata"]["name"] = "repos-strict"
        strict["spec"]["parameters"]["repos"] = ["registry.invalid/"]
        before = live_enforcement_fingerprint(client)
        cand = [dict(c) for c in constraints] + [strict]
        ctrl = PromotionController(client, templates, cand, name="t-widen",
                                   events=events)
        assert ctrl.run(target_rung="deny") == REJECTED
        assert ctrl.history[-1]["reason"] == "unexpected_denials"
        off = ctrl.evidence[REJECTED]["offending"][0]
        assert off["recorded_allowed"] is True
        assert off["replayed_allowed"] is False
        assert ctrl.installed is None
        assert live_enforcement_fingerprint(client) == before
        jctrl = jrollout.PromotionController(
            _mk_ref_client(templates, constraints), templates, cand,
            name="t-widen", events=events)
        assert jctrl.run(target_rung="deny") == REJECTED
        assert _evidence(ctrl) == _evidence(jctrl)

    def test_rejects_without_evidence(self):
        templates, constraints = _policy_subset()
        _d, client = _mk_client(templates, constraints)
        ctrl = PromotionController(client, templates, constraints[1:],
                                   name="t-empty", events=[])
        assert ctrl.run(target_rung="deny") == REJECTED
        assert ctrl.history[-1]["reason"] == "no_evidence"
        assert ctrl.installed is None

    def test_brownout_rolls_back_and_restores(self, monkeypatch, tmp_path):
        templates, constraints = _policy_subset()
        _d, client = _mk_client(templates, constraints)
        events = _record_corpus(client, monkeypatch, tmp_path)
        before = live_enforcement_fingerprint(client)
        ctrl = PromotionController(client, templates,
                                   [dict(c) for c in constraints[1:]],
                                   name="t-brown", events=events)
        assert ctrl.run(target_rung="warn") == "warn"
        assert live_enforcement_fingerprint(client) != before
        ovl = OverloadController(lambda: 0, capacity=10)
        ctrl.attach_overload(ovl)
        monkeypatch.setenv("GATEKEEPER_BROWNOUT", "2")
        ovl.rung()                              # escalate -> listener
        assert ctrl.state == ROLLED_BACK
        ev = ctrl.evidence[ROLLED_BACK]
        assert ev["restored"] is True
        assert ev["from_rung"] == "warn"
        assert ev["brownout"]["to"] >= 2
        assert live_enforcement_fingerprint(client) == before
        assert ctrl.installed is None

    def test_low_brownout_rung_does_not_abort(self, monkeypatch, tmp_path):
        templates, constraints = _policy_subset()
        _d, client = _mk_client(templates, constraints)
        events = _record_corpus(client, monkeypatch, tmp_path)
        ctrl = PromotionController(client, templates,
                                   [dict(c) for c in constraints[1:]],
                                   name="t-low", events=events)
        assert ctrl.run(target_rung="dryrun") == "dryrun"
        ctrl._on_brownout(0, 1, 0.5)            # below SHED_WARN
        assert ctrl.state == "dryrun"

    def test_rollback_before_install_is_noop(self):
        templates, constraints = _policy_subset()
        _d, client = _mk_client(templates, constraints)
        ctrl = PromotionController(client, templates, constraints[1:],
                                   name="t-noop", events=[])
        assert ctrl.rollback(reason="nothing") is False
        assert ctrl.state == "candidate"

    def test_resume_under_a_snapshot_dir_names_its_item(self, monkeypatch,
                                                        tmp_path):
        """The reference's warm restart: kill the process at warn
        (simulated by a fresh client and controller), resume from the
        ninth snapshot tier, re-apply the rung, and finish the ladder."""
        from gatekeeper_tpu_torch.resilience import snapshot as snap
        monkeypatch.setenv("GATEKEEPER_SNAPSHOT_DIR", str(tmp_path / "s"))
        templates, constraints = _policy_subset()
        _d, client = _mk_client(templates, constraints)
        events = _record_corpus(client, monkeypatch, tmp_path)
        candidate = [dict(c) for c in constraints[1:]]
        ctrl = PromotionController(client, templates, candidate,
                                   name="t-resume", events=events)
        assert ctrl.run(target_rung="warn") == "warn"
        ro_hits_before = snap.stats.ro_hits

        _d2, client2 = _mk_client(templates, constraints)
        ctrl2 = PromotionController(client2, templates, candidate,
                                    name="t-resume", events=events)
        assert ctrl2.resume() is True
        assert snap.stats.ro_hits > ro_hits_before
        assert ctrl2.state == "warn" and ctrl2.installed == "warn"
        for c in candidate:
            doc = client2.constraints[c["kind"]][c["metadata"]["name"]]
            assert doc["spec"]["enforcementAction"] == "warn"
        assert ctrl2.step() == "deny"

    def test_a_shadow_sweep_error_is_raised(self, monkeypatch, tmp_path):
        """Unlike the reference, an error of the shadow sweep itself is
        raised, not recorded as a rejection; the staged candidate is
        taken out all the same."""
        from gatekeeper_tpu_torch.whatif import shadow as tshadow
        templates, constraints = _policy_subset()
        _d, client = _mk_client(templates, constraints)
        events = _record_corpus(client, monkeypatch, tmp_path)
        kinds = sorted(client.constraints)

        def broken(self, limit_per_constraint=20):
            raise RuntimeError("K1 launch failed")
        monkeypatch.setattr(tshadow.ShadowSession, "sweep", broken)
        ctrl = PromotionController(client, templates, constraints[1:],
                                   name="t-broken", events=events)
        with pytest.raises(RuntimeError, match="K1 launch failed"):
            ctrl.run(target_rung="deny")
        assert sorted(client.constraints) == kinds

    def test_resume_without_snapshot_is_false(self):
        templates, constraints = _policy_subset()
        _d, client = _mk_client(templates, constraints)
        ctrl = PromotionController(client, templates, constraints[1:],
                                   name="t-none", events=[])
        assert ctrl.resume() is False


# ---------------------------------------------------------------------------
# fleet graduation


def _mk_fleet(templates, constraints, n_clusters, rows=30, ref=False):
    if ref:
        return [jmake_cluster(f"c{i}", templates, constraints,
                              objs=make_mixed(random.Random(100 + i), rows))
                for i in range(n_clusters)]
    return [make_cluster(f"c{i}", templates, constraints,
                         objs=make_mixed(random.Random(100 + i), rows),
                         driver_factory=lambda: TorchDriver(device="cpu"))
            for i in range(n_clusters)]


def _per_cluster(rep):
    return [(e.name, e.status, e.added, e.cleared, e.baseline_digest,
             e.candidate_digest) for e in rep.per_cluster]


class TestFleetGraduation:
    def test_clean_candidate_graduates_everywhere(self):
        templates, constraints = _policy_subset()
        cand = [dict(c) for c in constraints[1:]]
        rep = graduate_fleet(_mk_fleet(templates, constraints, 5),
                             templates, cand, block_size=2)
        assert rep.n_clusters == 5 and rep.n_blocks == 3
        assert rep.graduated == 5 and rep.blocked == rep.held == 0
        assert all(ev.status == GRADUATED and ev.added == 0
                   for ev in rep.per_cluster)
        assert "5/5 graduated" in rep.headline()
        jrep = jrollout.graduate_fleet(
            _mk_fleet(templates, constraints, 5, ref=True), templates,
            cand, block_size=2)
        assert _per_cluster(rep) == _per_cluster(jrep)
        assert rep.device_dispatches == jrep.device_dispatches > 0

    def test_widening_candidate_blocks_with_evidence(self):
        templates, constraints = _policy_subset()
        cand = [dict(c) for c in constraints]
        rep = graduate_fleet(_mk_fleet(templates, constraints[1:], 3),
                             templates, cand, block_size=2)
        blocked = [ev for ev in rep.per_cluster if ev.status == BLOCKED]
        assert blocked and rep.blocked == len(blocked)
        assert all(ev.added > 0 for ev in blocked)
        jrep = jrollout.graduate_fleet(
            _mk_fleet(templates, constraints[1:], 3, ref=True), templates,
            cand, block_size=2)
        assert _per_cluster(rep) == _per_cluster(jrep)

    def test_straggler_fault_holds_only_itself(self, monkeypatch):
        templates, constraints = _policy_subset()
        fleet = _mk_fleet(templates, constraints, 4)
        monkeypatch.setenv("GATEKEEPER_FAULT", "fleet_straggler")
        assert faults.active("fleet_straggler")     # the seam is ported
        rep = graduate_fleet(fleet, templates,
                             [dict(c) for c in constraints[1:]],
                             block_size=2)
        held = [ev for ev in rep.per_cluster if ev.status == HELD]
        assert len(held) == 1 and rep.held == 1
        assert held[0].name == "c0"
        assert "fleet_straggler" in held[0].error
        assert rep.graduated == 3

    def test_a_stacked_audit_error_is_raised(self, monkeypatch):
        """Unlike the reference, a failure of the stacked audit (a
        batched kernel's build or launch) is raised, not replaced by the
        per-cluster loop."""
        from gatekeeper_tpu_torch.rollout import fleet as rfleet
        templates, constraints = _policy_subset()
        fleet = _mk_fleet(templates, constraints, 2)

        def broken(block, limit):
            raise RuntimeError("K1b launch failed")
        monkeypatch.setattr(rfleet, "fleet_audit", broken)
        with pytest.raises(RuntimeError, match="K1b launch failed"):
            graduate_fleet(fleet, templates,
                           [dict(c) for c in constraints[1:]])

    def test_clusters_that_cannot_stack_run_the_loop(self):
        """A block whose clusters do not share one policy set runs the
        per-cluster loop, counted in ``loop_blocks``, with the
        reference's evidence."""
        templates, constraints = _policy_subset()
        fleet = _mk_fleet(templates, constraints, 2) + \
            [make_cluster("c2", templates, constraints[1:],
                          objs=make_mixed(random.Random(102), 30),
                          driver_factory=lambda: TorchDriver(device="cpu"))]
        jfleet = _mk_fleet(templates, constraints, 2, ref=True) + \
            [jmake_cluster("c2", templates, constraints[1:],
                           objs=make_mixed(random.Random(102), 30))]
        cand = [dict(c) for c in constraints[1:]]
        rep = graduate_fleet(fleet, templates, cand, block_size=3)
        jrep = jrollout.graduate_fleet(jfleet, templates, cand,
                                       block_size=3)
        assert rep.loop_blocks == 1 and rep.held == 0
        assert _per_cluster(rep) == _per_cluster(jrep)

    def test_the_stacked_kernels_run_per_block(self):
        from gatekeeper_tpu_torch.kernels import ir_eval, topk
        templates, constraints = _policy_subset()
        fleet = _mk_fleet(templates, constraints, 4)
        calls = (ir_eval.eval_mask_batched, topk.topk_packed_batched)
        before = [f.plain_calls for f in calls]
        rep = graduate_fleet(fleet, templates,
                             [dict(c) for c in constraints[1:]],
                             block_size=2)
        assert rep.graduated == 4
        assert all(f.plain_calls > b for f, b in zip(calls, before))


# ---------------------------------------------------------------------------
# a brownout storm during a promotion (the reference's chaos soak's
# invariants 9 and 10, resilience/chaos.py _promotion_storm: its soak
# harness is ROADMAP A8, so the storm runs here directly)


def _storm(client, templates, candidate, events, name):
    """One storm event: a promotion to deny on its own thread with a
    soak window, a brownout pinned at SHED_WARN once a rung installed;
    (rolled back, restored, fingerprint equal)."""
    before = live_enforcement_fingerprint(client)
    ctrl = PromotionController(client, templates,
                               [copy.deepcopy(c) for c in candidate],
                               name=name, events=events, soak_s=30.0)
    ovl = OverloadController(lambda: 0, capacity=10)
    ctrl.attach_overload(ovl)
    t = threading.Thread(target=ctrl.run, kwargs={"target_rung": "deny"},
                         daemon=True, name="storm-promotion")
    t.start()
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline and ctrl.installed is None \
            and ctrl.state not in (REJECTED, ROLLED_BACK):
        time.sleep(0.01)
    assert ctrl.installed is not None, ctrl.history
    import os
    os.environ["GATEKEEPER_BROWNOUT"] = "2"
    try:
        ovl.rung()                   # escalate -> listener -> rollback
    finally:
        os.environ.pop("GATEKEEPER_BROWNOUT", None)
    t.join(timeout=30.0)
    assert not t.is_alive()
    return (ctrl.state == ROLLED_BACK,
            ctrl.evidence.get(ROLLED_BACK, {}).get("restored"),
            live_enforcement_fingerprint(client) == before)


class TestPromotionStorm:
    def test_storm_rolls_back_and_restores_twice(self, monkeypatch,
                                                 tmp_path):
        templates, constraints = _policy_subset()
        _d, client = _mk_client(templates, constraints)
        events = _record_corpus(client, monkeypatch, tmp_path)
        for i in range(2):
            assert _storm(client, templates, constraints[1:], events,
                          f"storm-{i}") == (True, True, True)


class TestFleetScale:
    @pytest.mark.slow
    def test_hundred_cluster_fleet_single_pass(self):
        templates, constraints = _policy_subset(3)
        fleet = _mk_fleet(templates, constraints, 100, rows=10)
        rep = graduate_fleet(fleet, templates,
                             [dict(c) for c in constraints[1:]])
        assert rep.n_clusters == 100
        assert rep.graduated == 100
        assert rep.n_blocks == (100 + rep.block_size - 1) // rep.block_size
