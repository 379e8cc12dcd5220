"""TorchDriver(device="cpu") against JaxDriver and LocalDriver.

The port's driver must return the same result lists as the JAX
reference (capped and uncapped) and as the scalar oracle (uncapped: the
oracle ignores the cap) on demo/basic, on a small north-star workload
and on the randomized templates of tests/test_fuzz_parity.py, and its
executor counters must show that the device path (the kernels' plain
versions, on the CPU) actually ran.
"""

import glob
import os
import random

import pytest
import yaml

from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.client.local_driver import LocalDriver
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.library.templates import LIBRARY as JLIBRARY
from gatekeeper_tpu.library.templates import constraint_doc as jconstraint
from gatekeeper_tpu.library.templates import template_doc as jtemplate
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.kernels import ir_eval, topk
from gatekeeper_tpu_torch.library.north_star import (make_resources,
                                                     setup_north_star)
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget

from test_fuzz_parity import (LABELS, PROBES, REPOS, cdoc, gen_match,
                              gen_pod, gen_template, tdoc)

TARGET = "admission.k8s.gatekeeper.sh"
DEMO = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "demo", "basic")


@pytest.fixture(autouse=True)
def _device_path_at_test_sizes(monkeypatch):
    """Drive the device path at test sizes (the port's own copy of the
    small-workload threshold; conftest zeroes the reference's)."""
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)


def _key(r):
    return (r.constraint["kind"], r.constraint["metadata"]["name"], r.msg,
            repr(r.metadata), r.enforcement_action,
            (r.resource or {}).get("metadata", {}).get("name"))


def _three():
    jd, td, ld = JaxDriver(), TorchDriver(device="cpu"), LocalDriver()
    return (jd, td, ld), (JBackend(jd).new_client([JTarget()]),
                          TBackend(td).new_client([TTarget()]),
                          JBackend(ld).new_client([JTarget()]))


def _audits(clients, limit):
    return [[_key(r) for r in c.audit(limit_per_constraint=limit).results()]
            for c in clients]


def _assert_parity(clients, limits=(None, 20, 2)):
    """Audit every client at each cap; returns the port's results at
    the first cap."""
    out = None
    for limit in limits:
        jx, tr, lo = _audits(clients, limit)
        assert tr == jx, f"limit={limit}"
        if limit is None:
            assert tr == lo
        out = tr if out is None else out
    return out


def test_demo_basic_matches_reference():
    _, clients = _three()
    load = lambda p: yaml.safe_load(open(p))
    for c in clients:
        for p in sorted(glob.glob(os.path.join(DEMO, "templates", "*.yaml"))):
            c.add_template(load(p))
        for p in sorted(glob.glob(os.path.join(DEMO, "constraints",
                                               "*.yaml"))):
            c.add_constraint(load(p))
        for p in sorted(glob.glob(os.path.join(DEMO, "good", "*.yaml"))) + [
                os.path.join(DEMO, "bad", "bad_ns.yaml"),
                os.path.join(DEMO, "bad", "no_dupe_ns_2.yaml")]:
            c.add_data(load(p))
    res = _assert_parity(clients)
    # the missing-label namespace and the duplicate label (both copies)
    assert {(k[1], k[5]) for k in res} == {
        ("ns-must-have-gk", "unlabeled"),
        ("ns-gk-label-unique", "payments"),
        ("ns-gk-label-unique", "payments-copy")}


def _jax_north_star(driver, resources, rng, c_per_kind):
    """The reference side of library/north_star.setup_north_star."""
    client = JBackend(driver).new_client([JTarget()])
    for kind in ("K8sRequiredLabels", "K8sAllowedRepos",
                 "K8sContainerLimits"):
        client.add_template(jtemplate(kind, JLIBRARY[kind][0]))
    for j in range(c_per_kind):
        client.add_constraint(jconstraint(
            "K8sRequiredLabels", f"labels-{j:03d}",
            {"labels": rng.sample([f"l{x}" for x in range(10)], k=2)}))
        client.add_constraint(jconstraint(
            "K8sAllowedRepos", f"repos-{j:03d}",
            {"repos": rng.sample(["gcr.io/", "docker.io/", "quay.io/",
                                  "ghcr.io/"], k=2)}))
        client.add_constraint(jconstraint(
            "K8sContainerLimits", f"cpu-{j:03d}",
            {"cpu": rng.choice(["500m", "1", "2"]),
             "memory": rng.choice(["512Mi", "2Gi"])}))
    client.add_data_batch(resources)
    return client


def test_small_north_star_matches_reference(monkeypatch):
    """~600 pods x 12 constraints, capped and uncapped; then churn.  The
    executor counters below are the legacy sweep's, so the paged route
    (default on) is switched off on both drivers."""
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    resources = make_resources(600, random.Random(1))
    jd, td, ld = JaxDriver(), TorchDriver(device="cpu"), LocalDriver()
    clients = (_jax_north_star(jd, resources, random.Random(2), 4),
               setup_north_star(td, resources, random.Random(2),
                                c_per_kind=4),
               _jax_north_star(ld, resources, random.Random(2), 4))
    evals, plain_k1, plain_k2 = (td.executor.mask_evals,
                                 ir_eval.eval_mask.plain_calls,
                                 topk.topk_packed.plain_calls)
    res = _assert_parity(clients)
    assert len(res) > 100
    # three kinds evaluated on the device path, through the wrappers
    assert td.executor.mask_evals - evals >= 3
    assert ir_eval.eval_mask.plain_calls - plain_k1 >= 3
    assert topk.topk_packed.plain_calls - plain_k2 >= 6
    # a steady sweep over unchanged bindings only reduces
    evals = td.executor.mask_evals
    reduces = td.executor.reduces
    _assert_parity(clients, limits=(20,))
    assert td.executor.mask_evals == evals
    assert td.executor.reduces == reduces + 3
    # churn: updated and removed pods re-evaluate, results still agree
    churn = make_resources(40, random.Random(9))
    for c in clients:
        for p in churn[:20]:
            c.add_data(p)
        for p in resources[100:110]:
            c.remove_data(p)
    _assert_parity(clients, limits=(None, 20))
    assert td.executor.mask_evals > evals


def test_full_sweep_and_tracing_match_reference():
    resources = make_resources(200, random.Random(3))
    jd, td = JaxDriver(), TorchDriver(device="cpu")
    jc = _jax_north_star(jd, resources, random.Random(4), 2)
    tc = setup_north_star(td, resources, random.Random(4), c_per_kind=2)
    for kw in ({"full": True, "limit_per_constraint": 20},
               {"tracing": True, "limit_per_constraint": 5}):
        a = jc.audit(**kw)
        b = tc.audit(**kw)
        assert [_key(r) for r in b.results()] == \
            [_key(r) for r in a.results()]
        if kw.get("tracing"):
            assert b.trace_dump() == a.trace_dump()


def test_large_caps_match_reference():
    """Caps past 128 (a user sets the audit cap freely): K2 fills them in
    several passes on the card; here the plain top-k must still give
    the reference's rows, also where the cap exceeds the violations."""
    resources = make_resources(300, random.Random(5))
    jd, td = JaxDriver(), TorchDriver(device="cpu")
    jc = _jax_north_star(jd, resources, random.Random(6), 2)
    tc = setup_north_star(td, resources, random.Random(6), c_per_kind=2)
    for limit in (129, 250, 1000):
        a = [_key(r) for r in jc.audit(limit_per_constraint=limit).results()]
        b = [_key(r) for r in tc.audit(limit_per_constraint=limit).results()]
        assert b == a and b, limit


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_driver_parity(seed, monkeypatch):
    """The randomized templates and churn rounds of test_fuzz_parity.py
    through all three drivers, along the legacy sweep whose device path
    the counters below check (tests/test_torch_pages.py runs the same
    scenario along the paged route)."""
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    rng = random.Random(seed * 7919)
    (_, td, _), clients = _three()
    anchor = ('package fuzzanchor\nviolation[{"msg": msg}] {\n'
              '  input.review.object.spec.replicas > 3\n'
              '  msg := sprintf("anchor fired on %v", '
              '[input.review.object.metadata.name])\n}\n')
    for c in clients:
        c.add_template(tdoc(f"Fuzz{seed}Anchor", anchor))
        c.add_constraint(cdoc(f"Fuzz{seed}Anchor", "anchor", {}))
    for i in range(5):
        src = gen_template(rng, i)
        kind = f"Fuzz{seed}T{i}"
        params = {"labels": rng.sample(LABELS, k=2),
                  "repos": rng.sample(REPOS, k=rng.randint(1, 2)),
                  "probes": rng.sample(PROBES, k=rng.randint(1, 2)),
                  "allowed": [rng.choice(REPOS) + f"app{k}" for k in range(2)],
                  "slack": rng.randrange(4),
                  "bigbound": rng.choice([2**24, 2**24 + 1, 2**24 + 2])}
        match = gen_match(rng)
        for c in clients:
            c.add_template(tdoc(kind, src))
            c.add_constraint(cdoc(kind, f"f{i}", params, match))
    pods = [gen_pod(rng, i) for i in range(60)]
    for c in clients:
        for ns in ("d", "p"):
            c.add_data({"apiVersion": "v1", "kind": "Namespace",
                        "metadata": {"name": ns, "labels": {"team": ns}}})
        for p in pods:
            c.add_data(p)
    evals = td.executor.mask_evals
    _assert_parity(clients, limits=(None, 3))
    st = td.state[TARGET]
    if any(t.vectorized is not None for t in st.templates.values()):
        assert td.executor.mask_evals > evals, "device path never ran"
    for round_ in range(2):
        for idx in rng.sample(range(60), 8):
            p = gen_pod(rng, idx)
            for c in clients:
                c.add_data(p)
        if round_ == 1:
            victim = pods[rng.randrange(60)]
            nsu = {"apiVersion": "v1", "kind": "Namespace",
                   "metadata": {"name": "d",
                                "labels": {"team": rng.choice(["d", "zzz"])}}}
            for c in clients:
                c.remove_data(victim)
                c.add_data(nsu)
        _assert_parity(clients, limits=(None, 3))
