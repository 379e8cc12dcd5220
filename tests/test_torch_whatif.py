"""The port's what-if engine against the JAX package, on the CPU:
shadow policy-set sweeps and historical replay (tests/test_whatif.py
TestShadow and TestReplay through ``gatekeeper_tpu_torch.whatif``).

The contracts are bit-exact: a ShadowSession sweep's candidate half
equals a standalone install of the candidate, replaying a store
snapshot reproduces the live verdicts, a recorded admission stream
replays exactly, scalar and batched — and every digest equals the
reference's on the same store.  An unchanged shadow twin takes its live
kind's K1 and K2 result (``whatif`` stanza equal to the reference's),
and ``GATEKEEPER_WHATIF_SHARE=off`` is the oracle.
"""

import random

import pytest

from gatekeeper_tpu import whatif as jwhatif
from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.library import all_docs, make_mixed
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch import whatif
from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget
from gatekeeper_tpu_torch.whatif import (ShadowSession, normalize_results,
                                         replay_admissions,
                                         replay_admissions_batched,
                                         replay_snapshot,
                                         standalone_candidate_verdicts,
                                         verdict_digest)

N_TEMPLATES = 8          # tests/test_whatif.py's library prefix
N_ROWS = 120


@pytest.fixture(autouse=True)
def _device_path_at_test_sizes(monkeypatch):
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.delenv("GATEKEEPER_WHATIF_SHARE", raising=False)
    monkeypatch.delenv("GATEKEEPER_DEDUP", raising=False)


def _policy_subset(n=N_TEMPLATES):
    pairs = all_docs()[:n]
    return [t for t, _c in pairs], [c for _t, c in pairs]


def _mk(package, templates, constraints, n_rows=N_ROWS, seed=7):
    if package == "port":
        driver = TorchDriver(device="cpu")
        handler = TTarget()
        client = TBackend(driver).new_client([handler])
    else:
        driver = JaxDriver()
        handler = JTarget()
        client = JBackend(driver).new_client([handler])
    for d in templates:
        client.add_template(d)
    for d in constraints:
        client.add_constraint(d)
    client.add_data_batch(make_mixed(random.Random(seed), n_rows))
    return driver, handler, client


@pytest.fixture(scope="module")
def live():
    saved = torch_driver.SMALL_WORKLOAD_EVALS
    torch_driver.SMALL_WORKLOAD_EVALS = 0
    try:
        templates, constraints = _policy_subset()
        out = {"templates": templates, "constraints": constraints}
        for pkg, norm in (("port", normalize_results),
                          ("ref", jwhatif.normalize_results)):
            driver, handler, client = _mk(pkg, templates, constraints)
            out[pkg] = {
                "driver": driver, "handler": handler, "client": client,
                "state": driver._state(handler.name).table.snapshot_state(),
                "baseline": norm(client.audit(limit_per_constraint=20,
                                              full=True).results())}
        assert out["port"]["baseline"] == out["ref"]["baseline"]
        return out
    finally:
        torch_driver.SMALL_WORKLOAD_EVALS = saved


# ---------------------------------------------------------------------------
# shadow installs


class TestShadow:
    def test_candidate_parity_is_bit_identical(self, live):
        """One sweep over live ∪ shadow, the shadow half bit-identical to
        installing the candidate alone, and both equal to the
        reference's."""
        cand = [dict(c) for c in live["constraints"][1:]]   # drop one
        reps = {}
        for pkg, mod in (("port", whatif), ("ref", jwhatif)):
            sess = mod.ShadowSession(live[pkg]["client"], tag="v2")
            sess.stage(live["templates"], cand)
            try:
                reps[pkg] = sess.sweep(limit_per_constraint=20)
            finally:
                sess.unstage()
        oracle = standalone_candidate_verdicts(
            live["templates"], cand, live["port"]["state"], 20,
            device="cpu")
        rep = reps["port"]
        assert rep.shadow == oracle == reps["ref"].shadow
        assert rep.shadow_digest == verdict_digest(oracle) \
            == reps["ref"].shadow_digest
        assert rep.live_digest == reps["ref"].live_digest
        assert rep.dedup == reps["ref"].dedup
        assert rep.dedup["groups_cross_version"] > 0

    def test_live_half_unchanged_and_diff_shape(self, live):
        dropped = live["constraints"][0]
        cand = [dict(c) for c in live["constraints"][1:]]
        with ShadowSession(live["port"]["client"], tag="diff") as sess:
            sess.stage(live["templates"], cand)
            rep = sess.sweep(limit_per_constraint=20)
        assert rep.live == live["port"]["baseline"]
        assert rep.added == []
        dropped_name = dropped["metadata"]["name"]
        assert rep.cleared and all(v[1] == dropped_name for v in rep.cleared)
        cleared_in_live = [v for v in live["port"]["baseline"]
                           if v[1] == dropped_name]
        assert [v[:-1] for v in rep.cleared] == \
            [v[:-1] for v in cleared_in_live]
        assert rep.by_constraint.get(dropped_name, {}).get("cleared") == \
            len(rep.cleared)

    def test_unstage_restores_live_set(self, live):
        client = live["port"]["client"]
        sess = ShadowSession(client, tag="undo")
        sess.stage(live["templates"], [dict(c) for c in live["constraints"]])
        sess.unstage()
        after = normalize_results(
            client.audit(limit_per_constraint=20, full=True).results())
        assert after == live["port"]["baseline"]

    def test_stage_failure_unwinds(self, live):
        client = live["port"]["client"]
        bad = {"kind": "NoSuchTemplateKind", "metadata": {"name": "x"},
               "spec": {}}
        sess = ShadowSession(client, tag="boom")
        with pytest.raises(Exception):
            sess.stage(live["templates"], [bad])
        assert sess._templates == [] and sess._constraints == []
        after = normalize_results(
            client.audit(limit_per_constraint=20, full=True).results())
        assert after == live["port"]["baseline"]

    @staticmethod
    def _twin_sweeps(monkeypatch, package, cand, n_rows=600):
        """A 3-template live set with ``cand`` staged beside it: the
        shadow sweep with twin sharing and with
        GATEKEEPER_WHATIF_SHARE=off (equal, and the oracle sweep has no
        ``whatif`` stanza); (report, stanza, driver)."""
        templates, constraints = _policy_subset(3)
        mod = whatif if package == "port" else jwhatif
        driver, _h, client = _mk(package, templates, constraints,
                                 n_rows=n_rows)
        sess = mod.ShadowSession(client, tag="twin")
        sess.stage(templates, cand)
        try:
            monkeypatch.delenv("GATEKEEPER_WHATIF_SHARE", raising=False)
            on = sess.sweep(limit_per_constraint=20)
            stanza = driver.last_sweep_phases.get("whatif")
            monkeypatch.setenv("GATEKEEPER_WHATIF_SHARE", "off")
            off = sess.sweep(limit_per_constraint=20)
            assert driver.last_sweep_phases.get("whatif") is None
            monkeypatch.delenv("GATEKEEPER_WHATIF_SHARE")
        finally:
            sess.unstage()
        assert (on.shadow, on.live) == (off.shadow, off.live)
        return on, stanza, driver

    @pytest.mark.parametrize("changed", [False, True])
    def test_twin_sharing_equals_the_reference_in_sorted_order(
            self, monkeypatch, changed):
        """With the Stage-8 dispatch order off (sorted kinds, each live
        kind before its twin) the ``whatif`` stanzas and every verdict
        equal the reference's: an unchanged twin takes the live kind's
        handle, a twin whose match criteria differ launches its own K1
        and K2."""
        monkeypatch.setenv("GATEKEEPER_HBM_BUDGET", "off")
        _t, constraints = _policy_subset(3)
        cand = [dict(c) for c in constraints]
        if changed:
            cand[0] = {**cand[0], "spec": {**cand[0].get("spec", {}),
                                           "match": {"namespaces": ["prod"]}}}
        rep, stanza, driver = self._twin_sweeps(monkeypatch, "port", cand)
        jrep, jstanza, _ = self._twin_sweeps(monkeypatch, "ref", cand)
        assert stanza == jstanza == {"twin_shared_kinds": 3 - changed,
                                     "twin_dispatched_kinds": 3 + changed}
        assert (rep.shadow, rep.live) == (jrep.shadow, jrep.live)
        assert rep.shadow_digest == jrep.shadow_digest
        assert driver.executor.mask_evals > 0

    def test_twin_sharing_equals_the_reference_under_the_stage8_order(
            self, monkeypatch):
        """Under the default Stage-8 dispatch order the port keeps the
        reference's weave: a shadow kind dispatched before its live twin
        launches its own K1 and K2, and the ``whatif`` stanza and every
        verdict equal the reference's."""
        _t, constraints = _policy_subset(3)
        cand = [dict(c) for c in constraints]
        rep, stanza, driver = self._twin_sweeps(monkeypatch, "port", cand)
        jrep, jstanza, _ = self._twin_sweeps(monkeypatch, "ref", cand)
        assert stanza == jstanza
        assert stanza["twin_shared_kinds"] + \
            stanza["twin_dispatched_kinds"] == 6
        assert (rep.shadow, rep.live) == (jrep.shadow, jrep.live)
        assert rep.shadow_digest == jrep.shadow_digest

    def test_shadow_kind_helpers(self):
        from gatekeeper_tpu_torch.analysis.policyset import (
            is_shadow_kind, shadow_kind, split_shadow_kind)
        sk = shadow_kind("K8sFoo", "v2")
        assert is_shadow_kind(sk) and not is_shadow_kind("K8sFoo")
        assert split_shadow_kind(sk) == ("K8sFoo", "v2")
        assert whatif.split_shadow_kind is split_shadow_kind
        with pytest.raises(ValueError):
            shadow_kind(sk, "v3")
        with pytest.raises(ValueError):
            shadow_kind("K8sFoo", "bad tag")


# ---------------------------------------------------------------------------
# historical replay


class TestReplay:
    def test_snapshot_replay_parity(self, live):
        rep = replay_snapshot(live["templates"], live["constraints"],
                              live["port"]["state"], 20, device="cpu")
        assert rep.verdicts == live["port"]["baseline"]
        assert rep.digest == verdict_digest(live["port"]["baseline"])
        assert rep.n_resources > 0

    def test_replay_of_the_reference_tables_state(self, live):
        """The reference table's ``snapshot_state()``, carried across
        packages, replays to the reference's digest."""
        rep = replay_snapshot(live["templates"], live["constraints"],
                              live["ref"]["state"], 20, device="cpu")
        jrep = jwhatif.replay_snapshot(live["templates"],
                                       live["constraints"],
                                       live["ref"]["state"], 20)
        assert rep.digest == jrep.digest
        assert rep.verdicts == jrep.verdicts == live["ref"]["baseline"]
        assert rep.n_resources == jrep.n_resources

    def test_snapshot_replay_under_candidate_set(self, live):
        cand = [dict(c) for c in live["constraints"][1:]]
        rep = replay_snapshot(live["templates"], cand,
                              live["port"]["state"], 20, device="cpu")
        oracle = standalone_candidate_verdicts(
            live["templates"], cand, live["port"]["state"], 20,
            device="cpu")
        assert rep.verdicts == oracle

    def test_load_historical_store_names_its_item(self, live, monkeypatch,
                                                  tmp_path):
        """The reference's round trip: a store snapshot written under one
        root reads back as a HISTORICAL root while the live env points
        nowhere, and replays to the live verdicts.  The port's entry and
        the reference's, under one root, do not cross."""
        from gatekeeper_tpu.resilience import snapshot as jsnap
        from gatekeeper_tpu_torch.resilience import snapshot as snap
        root = str(tmp_path / "snaps")
        name = live["port"]["handler"].name
        monkeypatch.setenv("GATEKEEPER_SNAPSHOT_DIR", root)
        assert snap.save_store(name, live["port"]["state"])
        assert jsnap.save_store(name, live["ref"]["state"])
        monkeypatch.delenv("GATEKEEPER_SNAPSHOT_DIR")
        assert whatif.load_historical_store(name) is None
        got = whatif.load_historical_store(name, root=root)
        assert got == live["port"]["state"]
        rep = replay_snapshot(live["templates"], live["constraints"], got,
                              20, device="cpu")
        assert rep.verdicts == live["port"]["baseline"]
        assert jwhatif.load_historical_store(name, root=root) == \
            live["ref"]["state"]

    def test_admission_stream_replay_is_exact(self, live, monkeypatch,
                                              tmp_path):
        """A webhook admission stream recorded into the corpus replays
        exactly through the same policy set, scalar and batched, with
        the reference's stream digest on the same corpus."""
        from gatekeeper_tpu_torch.obs import flightrecorder as fr
        from gatekeeper_tpu_torch.webhook.policy import ValidationHandler
        monkeypatch.setenv("GATEKEEPER_FLIGHT_DIR", str(tmp_path))
        monkeypatch.setenv("GATEKEEPER_FLIGHT_ADMISSION", "1")
        monkeypatch.setattr(fr, "_recorder", None)
        handler = ValidationHandler(live["port"]["client"])
        reviews = make_mixed(random.Random(11), 12)
        for obj in reviews:
            handler.handle({
                "uid": "u", "operation": "CREATE",
                "kind": {"group": "", "version": "v1",
                         "kind": obj.get("kind", "")},
                "name": (obj.get("metadata") or {}).get("name", ""),
                "userInfo": {"username": "alice", "groups": []},
                "object": obj})
        events = fr.load_admission_corpus(str(tmp_path))
        assert len(events) == len(reviews)
        srep = replay_admissions(events, live["port"]["client"])
        brep = replay_admissions_batched(events, live["port"]["client"])
        assert srep.exact, srep.mismatches[:2]
        assert brep.exact and brep.batched
        assert srep.replayed == srep.matched == len(reviews)
        assert srep.digest == brep.digest
        jrep = jwhatif.replay_admissions(events, live["ref"]["client"])
        assert jrep.exact and jrep.digest == srep.digest

    def test_batched_stream_through_the_device_batch(self, live,
                                                     monkeypatch):
        """With the admission threshold at 0 the batched replay takes the
        device micro-batch (``query_review_batch``) and still equals the
        scalar replay's digest."""
        monkeypatch.setattr(torch_driver, "REVIEW_BATCH_MIN_EVALS", 0)
        client = live["port"]["client"]
        events = []
        for obj in make_mixed(random.Random(13), 16):
            req = {"uid": "u", "operation": "CREATE",
                   "kind": {"group": "", "version": "v1",
                            "kind": obj.get("kind", "")},
                   "name": (obj.get("metadata") or {}).get("name", ""),
                   "namespace": (obj.get("metadata") or {}).get("namespace"),
                   "object": obj}
            results = client.review(req).results()
            events.append({
                "request": req,
                "allowed": not any(r.enforcement_action not in
                                   ("warn", "dryrun") for r in results),
                "verdicts": [{"kind": r.constraint["kind"],
                              "name": r.constraint["metadata"]["name"],
                              "action": r.enforcement_action,
                              "msg": r.msg} for r in results]})
        before = live["port"]["driver"].metrics.snapshot().get(
            "review_batches_device", 0)
        brep = replay_admissions_batched(events, client)
        srep = replay_admissions(events, client)
        assert brep.exact and srep.exact and brep.digest == srep.digest
        assert live["port"]["driver"].metrics.snapshot()[
            "review_batches_device"] > before

    @staticmethod
    def _stream(client, n=12, seed=17):
        """Recorded-shape events of ``n`` mixed objects, with the
        verdicts ``client`` gives them now."""
        events = []
        for obj in make_mixed(random.Random(seed), n):
            req = {"uid": "u", "operation": "CREATE",
                   "kind": {"group": "", "version": "v1",
                            "kind": obj.get("kind", "")},
                   "name": (obj.get("metadata") or {}).get("name", ""),
                   "namespace": (obj.get("metadata") or {}).get("namespace"),
                   "object": obj}
            results = client.review(req).results()
            events.append({
                "request": req,
                "allowed": not any(r.enforcement_action not in
                                   ("warn", "dryrun") for r in results),
                "verdicts": [{"kind": r.constraint["kind"],
                              "name": r.constraint["metadata"]["name"],
                              "action": r.enforcement_action,
                              "msg": r.msg} for r in results]})
        return events

    def test_a_batch_error_no_event_explains_is_raised(self, live):
        """Unlike the reference, a failed device pass is not replayed on
        the scalar engine: when every event of the chunk reviews on its
        own, the batch's exception is raised."""
        client = live["port"]["client"]
        events = self._stream(client)

        class Broken:
            def review(self, request):
                return client.review(request)

            def review_batch(self, requests):
                raise RuntimeError("K1 launch failed")
        with pytest.raises(RuntimeError, match="K1 launch failed"):
            replay_admissions_batched(events, Broken())

    def test_a_poisoned_event_is_isolated_and_the_rest_rebatched(self, live):
        """A chunk that fails because of one request: that event is
        skipped, as the scalar replay skips it, the others go through
        ``review_batch`` again, and the chunk is counted."""
        client = live["port"]["client"]
        events = self._stream(client)
        poison = events[3]["request"]["name"]
        batches = []

        class Poisoned:
            def review(self, request):
                if request.get("name") == poison:
                    raise ValueError("poisoned request")
                return client.review(request)

            def review_batch(self, requests):
                batches.append([r.get("name") for r in requests])
                if any(r.get("name") == poison for r in requests):
                    raise ValueError("poisoned request")
                return client.review_batch(requests)
        brep = replay_admissions_batched(events, Poisoned())
        srep = replay_admissions(events, Poisoned())
        assert brep.isolated_chunks == 1 and len(batches) == 2
        assert poison not in batches[1] and len(batches[1]) == 11
        assert brep.skipped == srep.skipped == 1
        assert brep.replayed == srep.replayed == 11
        assert brep.digest == srep.digest
        assert brep.mismatches == srep.mismatches

    def test_truncated_events_are_skipped(self, live):
        events = [{"request": {"object": {"__truncated__": True}},
                   "allowed": True, "verdicts": []}]
        srep = replay_admissions(events, live["port"]["client"])
        assert srep.skipped_oversize == 1
        assert srep.skipped == 0 and srep.replayed == 0
        assert not srep.exact
        brep = replay_admissions_batched(events, live["port"]["client"])
        assert brep.skipped_oversize == 1 and brep.skipped == 0
