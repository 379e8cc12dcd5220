"""The port's selective reuse, its binding-delta oracle and explain_pair
against the JAX package, on the CPU.

A non-full, untraced sweep replays a kind's captured K1/K2 payload when
no column path its template reads was dirtied since
(``TorchDriver._selective_reuse``); ``GATEKEEPER_FOOTPRINT=off`` is the
oracle.  The port keeps each kind's violation mask on the device across
sweeps, so a churn that touches a replayed kind later must still scatter
and re-evaluate every row dirtied since the mask was computed.
``GATEKEEPER_BINDING_DELTA=off`` rebuilds bindings whole: the oracle of
the delta chain.  ``explain_pair`` dumps one pair through the plain
evaluator.
"""

import copy
import random

import pytest

from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.client.local_driver import LocalDriver
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.library import all_docs, make_mixed
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget

from test_jax_driver import _setup

TARGET = "admission.k8s.gatekeeper.sh"
# tests/test_footprint.py TestSelectiveInvalidation's kinds
KINDS = ("K8sRequiredLabels", "K8sAllowedRepos", "K8sBlockNodePort")


@pytest.fixture(autouse=True)
def _device_path_at_test_sizes(monkeypatch):
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    for var in ("GATEKEEPER_FOOTPRINT", "GATEKEEPER_BINDING_DELTA",
                "GATEKEEPER_DEDUP"):
        monkeypatch.delenv(var, raising=False)


def _verdicts(results):
    return sorted(
        ((r.constraint or {}).get("kind", ""),
         ((r.constraint or {}).get("metadata") or {}).get("name", ""),
         (r.review or {}).get("namespace") or "",
         (r.review or {}).get("name", ""), r.msg)
        for r in results)


def _three(kinds=KINDS):
    """TorchDriver(cpu), JaxDriver and LocalDriver with ``kinds`` of the
    library, one constraint each."""
    drivers = (TorchDriver(device="cpu"), JaxDriver(), LocalDriver())
    clients = (TBackend(drivers[0]).new_client([TTarget()]),
               JBackend(drivers[1]).new_client([JTarget()]),
               JBackend(drivers[2]).new_client([JTarget()]))
    for tdoc, cdoc in all_docs():
        if tdoc["spec"]["crd"]["spec"]["names"]["kind"] in kinds:
            for c in clients:
                c.add_template(tdoc)
                c.add_constraint(cdoc)
    return drivers, clients


def _audit(client, **kw):
    return _verdicts(client.audit(**kw).results())


def _footprint(driver):
    return dict(driver.last_sweep_phases.get("footprint") or {})


def _annotate(clients, resources, rows):
    """Annotation-only churn, outside every installed template's
    read-set, with fresh objects (a watch decodes a new dict per
    event)."""
    for i in rows:
        o = copy.deepcopy(resources[i])
        o.setdefault("metadata", {}).setdefault(
            "annotations", {})["fp-test"] = f"r{i}"
        for c in clients:
            c.add_data(copy.deepcopy(o))


def _image_edit(clients, resources, image="evil.io/fp-test:1", skip=0):
    """An image edit of the ``skip``-th container pod: inside
    K8sAllowedRepos' read-set only."""
    idx = [i for i, r in enumerate(resources)
           if (r.get("spec") or {}).get("containers")][skip]
    o = copy.deepcopy(resources[idx])
    o["spec"]["containers"][0]["image"] = image
    resources[idx] = o
    for c in clients:
        c.add_data(copy.deepcopy(o))


# ---------------------------------------------------------------------------
# tests/test_footprint.py TestSelectiveInvalidation through the port


@pytest.mark.parametrize("pages", ["on", "off"])
def test_selective_invalidation_equals_the_reference(monkeypatch, pages):
    """The reference's flow on both drivers: a full sweep, a steady one,
    annotation churn (every row-local kind replays), then an image edit
    (K8sAllowedRepos re-sweeps): results equal the scalar oracle and
    the footprint stanzas equal the reference's."""
    monkeypatch.setenv("GATEKEEPER_PAGES", pages)
    (td, jd, ld), clients = _three()
    ct, cj, cl = clients
    resources = make_mixed(random.Random(3), 80)
    for c in clients:
        c.add_data_batch(copy.deepcopy(resources))
    stanzas = []
    for step in ("full", "steady", "annotate", "image"):
        if step == "annotate":
            _annotate(clients, resources, (0, 3, 7))
        elif step == "image":
            _image_edit(clients, resources)
        full = step == "full"
        got = _audit(ct, limit_per_constraint=20, full=full)
        assert got == _audit(cj, limit_per_constraint=20, full=full)
        assert _footprint(td) == _footprint(jd)
        stanzas.append(_footprint(td))
    if pages == "off":
        assert stanzas[2]["kinds_skipped"] == len(KINDS)
        assert stanzas[2]["evaluations_saved"] > 0
        assert stanzas[3]["kinds_skipped"] == len(KINDS) - 1
    else:
        # every kind is served from the verdict ledger before reuse
        assert all(s["kinds_skipped"] == 0 for s in stanzas)


@pytest.mark.parametrize("fp", ["on", "off"])
def test_oracle_mode_equals_the_reference(monkeypatch, fp):
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    monkeypatch.setenv("GATEKEEPER_FOOTPRINT", fp)
    (td, jd, ld), clients = _three()
    ct, cj, cl = clients
    resources = make_mixed(random.Random(3), 80)
    for c in clients:
        c.add_data_batch(copy.deepcopy(resources))
    _audit(ct, limit_per_constraint=20)
    _audit(cj, limit_per_constraint=20)
    _annotate(clients, resources, (1, 2))
    got = _audit(ct, limit_per_constraint=20)
    assert got == _audit(cj, limit_per_constraint=20)
    assert _footprint(td) == _footprint(jd)
    assert _footprint(td)["enabled"] is (fp == "on")
    snap = td.metrics.snapshot()
    assert snap.get("footprint_kind_sweeps_skipped", 0) == \
        jd.metrics.snapshot().get("footprint_kind_sweeps_skipped", 0)


def test_a_replayed_kind_launches_nothing(monkeypatch):
    from gatekeeper_tpu_torch.kernels import ir_eval, topk
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    (td, _jd, _ld), clients = _three()
    ct = clients[0]
    resources = make_mixed(random.Random(3), 80)
    for c in clients[:1]:
        c.add_data_batch(copy.deepcopy(resources))
    _audit(ct, limit_per_constraint=20)
    _annotate(clients[:1], resources, (0, 3, 7))
    before = (ir_eval.eval_mask.plain_calls, topk.topk_packed.plain_calls,
              td.executor.mask_evals, td.executor.delta_evals,
              td.executor.reduces)
    _audit(ct, limit_per_constraint=20)
    assert _footprint(td)["kinds_skipped"] == len(KINDS)
    assert (ir_eval.eval_mask.plain_calls, topk.topk_packed.plain_calls,
            td.executor.mask_evals, td.executor.delta_evals,
            td.executor.reduces) == before


@pytest.mark.parametrize("rounds", [1, 3])
def test_replay_then_a_read_path_churn(monkeypatch, rounds):
    """Churn an unread path (the kinds replay, their device masks stay
    as they were) ``rounds`` times, each beside an image edit that only
    K8sAllowedRepos reads; then edit the read path of every kind.  The
    re-evaluated masks must cover every row dirtied since each kind
    last ran: results equal JaxDriver's and LocalDriver's each round."""
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    (td, jd, ld), clients = _three()
    ct, cj, cl = clients
    resources = make_mixed(random.Random(9), 120)
    for c in clients:
        c.add_data_batch(copy.deepcopy(resources))

    def check():
        got = _audit(ct, limit_per_constraint=20)
        assert got == _audit(cj, limit_per_constraint=20)
        assert _footprint(td) == _footprint(jd)
        return _footprint(td)

    check()
    for k in range(rounds):
        _annotate(clients, resources, (k, 10 + k, 40 + k))
        _image_edit(clients, resources, image=f"evil.io/r{k}:1", skip=k)
        assert check()["kinds_skipped"] == len(KINDS) - 1
    # read-path churn of every kind: labels, images, node ports
    rng = random.Random(4)
    for i in rng.sample(range(len(resources)), 12):
        o = copy.deepcopy(resources[i])
        o.setdefault("metadata", {})["labels"] = {"owner": "x"} \
            if rng.random() < 0.5 else {}
        if (o.get("spec") or {}).get("containers"):
            o["spec"]["containers"][0]["image"] = "docker.io/bad:9"
        resources[i] = o
        for c in clients:
            c.add_data(copy.deepcopy(o))
    assert check()["kinds_skipped"] == 0
    assert td.executor.delta_evals > 0
    # and a steady sweep after it replays everything again
    assert check()["kinds_skipped"] == len(KINDS)
    # uncapped, every violation equals the scalar oracle's
    assert _audit(ct) == _audit(cj) == _audit(cl)


def test_status_writes_replay_where_the_reference_resweeps(monkeypatch):
    """A deliberate difference (ROADMAP Queue C): the port keeps the
    constraint version when a re-put changes only a constraint's status
    (the audit manager's status writes), so the next sweep replays;
    the reference bumps the version on every put and re-sweeps.  Results
    stay equal; only the footprint stanza differs."""
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    (td, jd, ld), clients = _three()
    ct, cj, cl = clients
    resources = make_mixed(random.Random(3), 60)
    for c in clients:
        c.add_data_batch(copy.deepcopy(resources))
    _audit(ct, limit_per_constraint=20)
    _audit(cj, limit_per_constraint=20)
    for tdoc, cdoc in all_docs():
        if tdoc["spec"]["crd"]["spec"]["names"]["kind"] in KINDS:
            doc = copy.deepcopy(cdoc)
            doc["status"] = {"auditTimestamp": "2026-10-18T00:00:00Z",
                             "totalViolations": 3}
            for c in clients:
                c.add_constraint(copy.deepcopy(doc))
    got = _audit(ct, limit_per_constraint=20)
    assert got == _audit(cj, limit_per_constraint=20)
    assert _footprint(td)["kinds_skipped"] == len(KINDS)
    assert _footprint(jd)["kinds_skipped"] == 0
    # a spec edit moves the version on both sides
    _annotate(clients, resources, (5,))
    got = _audit(ct, limit_per_constraint=20)
    assert got == _audit(cj, limit_per_constraint=20)
    assert _footprint(td) == _footprint(jd)


# ---------------------------------------------------------------------------
# GATEKEEPER_BINDING_DELTA=off


@pytest.mark.parametrize("delta", ["on", "off"])
def test_binding_delta_oracle_equals_the_reference(monkeypatch, delta):
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    monkeypatch.setenv("GATEKEEPER_FOOTPRINT", "off")
    monkeypatch.setenv("GATEKEEPER_BINDING_DELTA", delta)
    (td, jd, ld), clients = _three()
    ct, cj, cl = clients
    resources = make_mixed(random.Random(5), 100)
    for c in clients:
        c.add_data_batch(copy.deepcopy(resources))
    rng = random.Random(6)
    for _round in range(3):
        got = _audit(ct, limit_per_constraint=20)
        assert got == _audit(cj, limit_per_constraint=20)
        for i in rng.sample(range(len(resources)), 5):
            o = copy.deepcopy(resources[i])
            o.setdefault("metadata", {})["labels"] = {"app": f"a{_round}"}
            for c in clients:
                c.add_data(copy.deepcopy(o))
    tsnap, jsnap = td.metrics.snapshot(), jd.metrics.snapshot()
    for name in ("bindings_full_builds", "bindings_delta_updates"):
        assert tsnap.get(name, 0) == jsnap.get(name, 0), name
    if delta == "off":
        assert tsnap.get("bindings_delta_updates", 0) == 0
        assert tsnap["bindings_full_builds"] == 3 * len(KINDS)
    else:
        assert tsnap["bindings_delta_updates"] > 0


# ---------------------------------------------------------------------------
# explain_pair (tests/test_jax_driver.py test_explain_pair_mask_dump)


def _explain_clients():
    td, jd = TorchDriver(device="cpu"), JaxDriver()
    ct = TBackend(td).new_client([TTarget()])
    cj = JBackend(jd).new_client([JTarget()])
    _setup(ct, n_pods=5)
    _setup(cj, n_pods=5)
    return td, jd


@pytest.mark.parametrize("kind, cname", [
    ("K8sRequiredLabels", "need-app"),
    ("K8sRequiredLabels", "need-owner-prod"),
    ("K8sAllowedRepos", "gcr-only"),
    ("K8sContainerLimits", "cpu-cap"),
])
def test_explain_pair_equals_the_reference_line_for_line(kind, cname):
    td, jd = _explain_clients()
    keys = [k for k, _row in
            td.state[TARGET].table.rows_items()]
    assert keys == [k for k, _row in jd.state[TARGET].table.rows_items()]
    fired = set()
    for key in keys:
        out = td.explain_pair(TARGET, kind, cname, key)
        assert out == jd.explain_pair(TARGET, kind, cname, key), key
        assert "explain constraint=" in out and "oracle:" in out
        fires = "FIRES" in out
        n_oracle = int(out.split("oracle: ")[1].split(" ")[0])
        assert fires == (n_oracle > 0), out
        fired.add(fires)
    if cname == "need-app":
        assert fired == {True, False}


def test_explain_pair_refusals_equal_the_reference():
    td, jd = _explain_clients()
    key = next(iter(td.state[TARGET].table.rows_items()))[0]
    for args in (("NoKind", "x", key), ("K8sRequiredLabels", "nope", key),
                 ("K8sRequiredLabels", "need-app", "no/such/key")):
        assert td.explain_pair(TARGET, *args) == \
            jd.explain_pair(TARGET, *args)
