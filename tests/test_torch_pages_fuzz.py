"""The randomized templates of tests/test_fuzz_parity.py on the paged
route, JaxDriver beside TorchDriver(device="cpu"), with the harness of
tests/test_torch_pages.py: random templates with match criteria, float32
bounds past 2^24 (f32-unsafe kinds fall back from the device path),
inventory joins (paged under devpages through K7), the library's
K8sUniqueIngressHost over Ingresses that share hosts, Namespace churn and
deletes.  Its own file so the test workers split it from the rest."""

import random

import pytest

from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.client.interface import QueryOpts as JOpts
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.library import all_docs as jall_docs
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.client.interface import QueryOpts as TOpts
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.library import all_docs as tall_docs
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget

from test_fuzz_parity import (LABELS, PROBES, REPOS, cdoc, gen_match,
                              gen_pod, gen_template, tdoc)
from test_torch_pages import TARGET, Harness, Side, _ingress
from test_torch_pages import _isolated  # noqa: F401  (autouse fixture)


JOIN_KIND = "K8sUniqueIngressHost"


def _library_doc(docs, kind):
    return next((t, c) for t, c in docs()
                if t["spec"]["crd"]["spec"]["names"]["kind"] == kind)


def gen_ingress(rng, idx):
    """Ingress ``idx`` in namespace d or p with a host from a pool of 5,
    so hosts repeat across Ingresses (and across namespaces)."""
    return _ingress(f"ing{idx}", f"shared{rng.randrange(5)}.example.com",
                    rng.choice(["d", "p"]))


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_paged_parity(monkeypatch, seed):
    """tests/test_torch_driver.py's fuzz scenario (random templates with
    match criteria, a float32 bound past 2^24, Namespace churn, deletes)
    plus the library's K8sUniqueIngressHost over 12 Ingresses with
    shared hosts (re-hosted and deleted as the pods churn) on the paged
    route — devpages on for even seeds: equal results, ledger events and
    stanzas on both drivers, and results equal to the port's own
    GATEKEEPER_PAGES=off sweep."""
    monkeypatch.delenv("GATEKEEPER_PAGE_ROWS")
    rng = random.Random(seed * 7919)
    jd, td, oracle = JaxDriver(), TorchDriver(device="cpu"), \
        TorchDriver(device="cpu")
    h = Harness(monkeypatch, seed % 2 == 0,
                Side(jd, JBackend(jd).new_client([JTarget()]), JOpts),
                Side(td, TBackend(td).new_client([TTarget()]), TOpts),
                Side(oracle, TBackend(oracle).new_client([TTarget()]),
                     TOpts))
    clients = [s.client for s in h.sides]
    for i in range(5):
        src, kind = gen_template(rng, i), f"Fuzz{seed}T{i}"
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
    for c, docs in zip(clients, (jall_docs, tall_docs, tall_docs)):
        tdoc_, cdoc_ = _library_doc(docs, JOIN_KIND)
        c.add_template(tdoc_)
        c.add_constraint(cdoc_)
    pods = [gen_pod(rng, i) for i in range(60)]
    ingresses = [gen_ingress(rng, i) for i in range(12)]
    h.apply([("upsert", {"apiVersion": "v1", "kind": "Namespace",
                         "metadata": {"name": ns, "labels": {"team": ns}}})
             for ns in ("d", "p")] + [("upsert", p) for p in pods]
            + [("upsert", o) for o in ingresses])
    joins_on_device = 0
    for limit in (None, 3):
        h.sweep(limit)
        joins_on_device += h.dv.get("inv_joins_device", 0)
    for round_ in range(2):
        batch = [("upsert", gen_pod(rng, idx))
                 for idx in rng.sample(range(60), 8)]
        # re-host some Ingresses (same identity) and delete one
        for idx in rng.sample(range(12), 3):
            o = gen_ingress(rng, idx)
            o["metadata"]["namespace"] = \
                ingresses[idx]["metadata"]["namespace"]
            ingresses[idx] = o
            batch.append(("upsert", o))
        batch.append(("remove", ingresses[rng.randrange(12)]))
        if round_ == 1:
            batch += [("remove", pods[rng.randrange(60)]),
                      ("upsert", {"apiVersion": "v1", "kind": "Namespace",
                                  "metadata": {"name": "d", "labels": {
                                      "team": rng.choice(["d", "zzz"])}}})]
        h.apply(batch)
        for limit in (None, 3):
            h.sweep(limit)
            joins_on_device += h.dv.get("inv_joins_device", 0)
    assert h.pages["enabled"]
    # under devpages the library join (and any fuzzed one) ran on the
    # device: the cold sweep's resident-mask build and each churned sweep
    assert (joins_on_device > 0) == h.devpages
    if h.devpages:
        assert JOIN_KIND in h.t.drv._state(TARGET).ledger.entries
