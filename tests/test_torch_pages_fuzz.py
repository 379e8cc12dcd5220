"""The randomized templates of tests/test_fuzz_parity.py on the paged
route, JaxDriver beside TorchDriver(device="cpu"), with the harness of
tests/test_torch_pages.py: random templates with match criteria, float32
bounds past 2^24 (f32-unsafe kinds fall back from the device path),
inventory joins (the named gap under devpages), Namespace churn and
deletes.  Its own file so the test workers split it from the rest."""

import random

import pytest

from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.client.interface import QueryOpts as JOpts
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.client.interface import QueryOpts as TOpts
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget

from test_fuzz_parity import (LABELS, PROBES, REPOS, cdoc, gen_match,
                              gen_pod, gen_template, tdoc)
from test_torch_pages import Harness, Side
from test_torch_pages import _isolated  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_paged_parity(monkeypatch, seed):
    """tests/test_torch_driver.py's fuzz scenario (random templates with
    match criteria, a float32 bound past 2^24, Namespace churn, deletes)
    on the paged route — devpages on for even seeds: equal results,
    ledger events and stanzas on both drivers, and results equal to the
    port's own GATEKEEPER_PAGES=off sweep."""
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
    pods = [gen_pod(rng, i) for i in range(60)]
    h.apply([("upsert", {"apiVersion": "v1", "kind": "Namespace",
                         "metadata": {"name": ns, "labels": {"team": ns}}})
             for ns in ("d", "p")] + [("upsert", p) for p in pods])
    for limit in (None, 3):
        h.sweep(limit)
    for round_ in range(2):
        batch = [("upsert", gen_pod(rng, idx))
                 for idx in rng.sample(range(60), 8)]
        if round_ == 1:
            batch += [("remove", pods[rng.randrange(60)]),
                      ("upsert", {"apiVersion": "v1", "kind": "Namespace",
                                  "metadata": {"name": "d", "labels": {
                                      "team": rng.choice(["d", "zzz"])}}})]
        h.apply(batch)
        for limit in (None, 3):
            h.sweep(limit)
    assert h.pages["enabled"]
