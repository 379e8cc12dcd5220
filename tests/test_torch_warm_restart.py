"""Warm restart of the port: the two-process smoke and the ledger's
adoption flows, each against the reference.

- The two-process cold and warm restart of ``python -m
  gatekeeper_tpu_torch.resilience.smoke --device cpu`` against one
  snapshot directory, and a vandalized directory that rebuilds cold and
  then goes warm again (tests/test_warm_restart.py's flows).
- The pagemap adoption flows of tests/test_pages.py
  (``TestPagemapSnapshot``, ``TestWatchWatermark``) and the devpages
  geometry flow of tests/test_devpages.py (``TestGeometrySnapshot``),
  each run through JaxDriver and ``TorchDriver(device="cpu")``: equal
  verdicts, ``pages`` stanzas (adoption means 0 ``ledger_full_builds``
  and 0 events), geometry adoptions, reactor resyncs and
  ``ledger_rv``'s snapshot-watermark floors.  The two packages write
  their entries under one snapshot root without crossing
  (resilience/snapshot.py).
"""

import copy
import json
import os
import random
import subprocess
import sys
import types

import pytest

from gatekeeper_tpu.engine import jax_driver
from gatekeeper_tpu.library import make_mixed as jmake_mixed
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.library import make_mixed as tmake_mixed
from tests.test_torch_reactor import KINDS, TARGET, _mapped, _pkg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# two processes


def _smoke(snapdir: str, n: int = 120) -> dict:
    env = {**os.environ,
           "GATEKEEPER_SNAPSHOT_DIR": snapdir,
           "GATEKEEPER_SMOKE_N": str(n)}
    for var in ("GATEKEEPER_FAULT", "GATEKEEPER_PAGES",
                "GATEKEEPER_DEVPAGES"):
        env.pop(var, None)
    out = subprocess.run(
        [sys.executable, "-m", "gatekeeper_tpu_torch.resilience.smoke",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _snap_files(snapdir: str) -> list[str]:
    found = []
    for root, _dirs, files in os.walk(snapdir):
        found.extend(os.path.join(root, f)
                     for f in files if f.endswith(".snap"))
    return sorted(found)


def test_two_process_warm_restart(tmp_path):
    snapdir = str(tmp_path)
    cold = _smoke(snapdir)
    warm = _smoke(snapdir)

    # the cold process did the real work and persisted it
    assert cold["lowerings"] > 0
    assert cold["store_restored"] is False
    assert _snap_files(snapdir), "cold run wrote no snapshot entries"
    # Stages 4 and 7 (warn), cold: every lowered template validated and
    # precompiled (two library programs share one surface digest)
    assert cold["validations"] == cold["aot_precompiles"] == 48
    assert cold["compile_surfaces"] == 47

    # the warm process reused it: no Rego re-lowering, no certificate
    # or automaton re-derived, restored store, restart hits and no
    # misses — and bit-identical verdicts
    assert warm["restart_persistent_cache_hits"] > 0
    assert warm["restart_persistent_cache_misses"] == 0
    assert warm["lowerings"] == 0
    for key in ("footprints", "shardplans", "memsurfaces", "dfa_compiles",
                "validations", "compile_surfaces", "aot_precompiles"):
        assert cold[key] > 0 and warm[key] == 0, key
    assert warm["store_restored"] is True
    assert warm["templates"] == cold["templates"]
    assert warm["n_rows"] == cold["n_rows"]
    assert warm["n_results"] == cold["n_results"]
    assert warm["verdict_digest"] == cold["verdict_digest"]
    # nothing is built on the CPU: the build caches count nothing
    assert warm["builds"]["hits"] == warm["builds"]["misses"] == 0
    assert set(warm) >= {"startup_seconds", "serving_seconds",
                         "compile_surfaces", "aot_precompiles"}


def test_corrupted_snapshot_dir_rebuilds_cold(tmp_path):
    snapdir = str(tmp_path)
    cold = _smoke(snapdir)
    files = _snap_files(snapdir)
    assert files
    # vandalize EVERY entry: truncate half of them, garbage the rest
    for i, path in enumerate(files):
        with open(path, "rb") as f:
            raw = f.read()
        with open(path, "wb") as f:
            f.write(raw[:len(raw) // 2] if i % 2 else b"\x00garbage\xff")

    # the restarted process must never crash on corruption: every bad
    # entry is discarded and rebuilt on the cold path, and the verdicts
    # still come out bit-identical
    warm = _smoke(snapdir)
    assert warm["lowerings"] == cold["lowerings"]   # rebuilt, not reused
    assert warm["store_restored"] is False
    assert warm["verdict_digest"] == cold["verdict_digest"]

    # ...and the rebuild re-persisted good entries: a third process is
    # warm again
    warm2 = _smoke(snapdir)
    assert warm2["lowerings"] == 0
    assert warm2["restart_persistent_cache_hits"] > 0
    assert warm2["verdict_digest"] == cold["verdict_digest"]


# ---------------------------------------------------------------------------
# the adoption flows, through both packages


@pytest.fixture
def sides(monkeypatch, tmp_path):
    """Both packages on every kind's device path, with one snapshot root
    (each package keeps its own subdirectory)."""
    monkeypatch.setattr(jax_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.setenv("GATEKEEPER_SNAPSHOT_DIR", str(tmp_path))
    for var in ("GATEKEEPER_PAGES", "GATEKEEPER_DEVPAGES",
                "GATEKEEPER_FAULT"):
        monkeypatch.delenv(var, raising=False)
    out = {}
    for side, mk in (("ref", jmake_mixed), ("port", tmake_mixed)):
        pkg = _pkg(side)
        out[side] = types.SimpleNamespace(**vars(pkg), make_mixed=mk)
    return out


def _mk(pkg):
    drv = pkg.driver()
    c = pkg.Backend(drv).new_client([pkg.Target()])
    for tdoc, cdoc in pkg.docs():
        if tdoc["spec"]["crd"]["spec"]["names"]["kind"] in KINDS:
            c.add_template(tdoc)
            c.add_constraint(cdoc)
    return drv, c


def _sweep(drv, pkg, pages=True, devpages=False, cap=20):
    saved = {k: os.environ.get(k) for k in ("GATEKEEPER_PAGES",
                                             "GATEKEEPER_DEVPAGES")}
    os.environ["GATEKEEPER_PAGES"] = "on" if pages else "off"
    os.environ["GATEKEEPER_DEVPAGES"] = "on" if devpages else "off"
    try:
        return drv.query_audit(TARGET, pkg.Opts(limit_per_constraint=cap))[0]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _verdicts(results):
    return sorted(
        ((r.constraint or {}).get("kind", ""),
         ((r.constraint or {}).get("metadata") or {}).get("name", ""),
         ((r.resource or {}).get("metadata") or {}).get("name", ""),
         r.msg)
        for r in results)


def _pages(drv) -> dict:
    return dict(drv.last_sweep_phases.get("pages") or {})


def _restart(pkg, drv):
    """Save the snapshot of ``drv`` (pages on, as a paged deployment
    saves it) and restore it into a fresh driver of the same package."""
    os.environ["GATEKEEPER_PAGES"] = "on"
    try:
        assert drv.save_store_snapshot(TARGET)
        drv2, c2 = _mk(pkg)
        assert drv2.restore_store_snapshot(TARGET) is True
        assert drv2._state(TARGET).ledger_restored is not None
    finally:
        os.environ.pop("GATEKEEPER_PAGES", None)
    return drv2, c2


def _adopts_ledger(pkg) -> dict:
    resources = pkg.make_mixed(random.Random(3), 50)
    drv, c = _mk(pkg)
    c.add_data_batch(copy.deepcopy(resources))
    cold = _verdicts(_sweep(drv, pkg))
    cold_pages = _pages(drv)
    drv2, _c2 = _restart(pkg, drv)
    warm = _verdicts(_sweep(drv2, pkg))
    return {"cold": cold, "cold_pages": cold_pages, "warm": warm,
            "warm_pages": _pages(drv2),
            "seq": drv2._state(TARGET).ledger.seq}


def test_warm_restart_adopts_ledger(sides):
    got = {side: _adopts_ledger(pkg) for side, pkg in sides.items()}
    assert got["port"] == got["ref"]
    port = got["port"]
    assert port["cold_pages"]["ledger_full_builds"] > 0
    assert port["warm"] == port["cold"]         # bit-identical verdicts
    assert port["warm_pages"]["ledger_full_builds"] == 0   # adopted
    assert port["warm_pages"]["events"] == 0 and port["seq"] == 0


def _drift(pkg, c):
    for tdoc, cdoc in pkg.docs():
        if tdoc["spec"]["crd"]["spec"]["names"]["kind"] == \
                "K8sRequiredLabels":
            drifted = copy.deepcopy(cdoc)
            drifted["spec"]["parameters"]["labels"] = ["pages-drift"]
            c.add_constraint(drifted)


def _drift_rejects(pkg) -> dict:
    resources = pkg.make_mixed(random.Random(3), 50)
    drv, c = _mk(pkg)
    c.add_data_batch(copy.deepcopy(resources))
    _sweep(drv, pkg)
    drv2, c2 = _restart(pkg, drv)
    _drift(pkg, c2)
    oracle, co = _mk(pkg)
    co.add_data_batch(copy.deepcopy(resources))
    _drift(pkg, co)
    warm = _verdicts(_sweep(drv2, pkg))
    return {"warm": warm, "want": _verdicts(_sweep(oracle, pkg,
                                                   pages=False)),
            "pages": _pages(drv2)}


def test_constraint_drift_rejects_adoption(sides):
    got = {side: _drift_rejects(pkg) for side, pkg in sides.items()}
    assert got["port"] == got["ref"]
    assert got["port"]["warm"] == got["port"]["want"]
    assert got["port"]["pages"]["ledger_full_builds"] > 0


def _geometry(pkg) -> dict:
    resources = pkg.make_mixed(random.Random(3), 50)
    drv, c = _mk(pkg)
    c.add_data_batch(copy.deepcopy(resources))
    cold = _verdicts(_sweep(drv, pkg, devpages=True))
    kinds_device = drv.last_sweep_phases["devpages"]["kinds_device"]
    drv2, c2 = _restart(pkg, drv)
    warm = _verdicts(_sweep(drv2, pkg, devpages=True))
    warm_pages = _pages(drv2)
    dvp = dict(drv2.last_sweep_phases.get("devpages") or {})
    st = drv2._state(TARGET)
    adopted = sorted(k for k, kp in st.devpages.items()
                     if getattr(kp, "geometry_adopted", False))
    # a churned pod after the restart: both sides bring the ledger
    # current through the device delta stream
    churn = copy.deepcopy(resources[0])
    churn["metadata"].setdefault("labels", {})["churned"] = "1"
    c2.add_data(churn)
    after = _verdicts(_sweep(drv2, pkg, devpages=True))
    oracle, co = _mk(pkg)
    co.add_data_batch(copy.deepcopy(resources))
    co.add_data(copy.deepcopy(churn))
    return {"cold": cold, "kinds_device": kinds_device, "warm": warm,
            "pages": warm_pages,
            "geometry_adopted": dvp.get("geometry_adopted", 0),
            "adopted": adopted, "after": after,
            "want_after": _verdicts(_sweep(oracle, pkg, pages=False)),
            "rows_confirmed": drv2.last_sweep_phases["devpages"][
                "rows_confirmed"]}


def test_warm_restart_adopts_device_pagemap(sides):
    """The ledger is adopted (0 rebuilds, 0 re-emitted events) AND the
    device pagemap geometry came from the snapshot, on both packages.
    The port also seeds each adopted kind's resident mask from the
    restored table (one K1, one K6), so its first churned sweep confirms
    the churned row alone where the reference, reconciling against
    zeros, confirms every violating row (ROADMAP Queue C)."""
    got = {side: _geometry(pkg) for side, pkg in sides.items()}
    port, ref = got["port"], got["ref"]
    for key in ("cold", "kinds_device", "warm", "pages",
                "geometry_adopted", "adopted", "after", "want_after"):
        assert port[key] == ref[key], key
    assert port["kinds_device"] > 0
    assert port["warm"] == port["cold"]
    assert port["pages"]["ledger_full_builds"] == 0
    assert port["pages"]["events"] == 0
    assert port["geometry_adopted"] == len(KINDS)
    assert port["adopted"] == sorted(KINDS)
    assert port["after"] == port["want_after"]
    assert port["rows_confirmed"] <= 1 < ref["rows_confirmed"]


def _cluster_fixture(pkg, n=24, seed=11):
    resources = pkg.make_mixed(random.Random(seed), n)
    cluster = pkg.fake.FakeCluster()
    for o in resources:
        cluster.create(copy.deepcopy(o))
    gvks = sorted({pkg.fake.gvk_of(o) for o in resources},
                  key=lambda g: g.kind)
    drv, c = _mk(pkg)
    objs = [o for g in gvks for o in cluster.list(g)]
    c.add_data_batch(copy.deepcopy(objs))
    return cluster, gvks, resources, drv, c


def _clean_restart(pkg) -> dict:
    cluster, gvks, resources, drv, _c = _cluster_fixture(pkg)
    _sweep(drv, pkg)
    drv2, c2 = _restart(pkg, drv)
    if pkg.side == "ref":
        _mapped(c2, drv2)
    floors = {g.kind: drv2.ledger_rv(TARGET, g.kind) for g in gvks}
    per_kind = {k: drv2.ledger_rv(TARGET, k) for k in KINDS}
    os.environ["GATEKEEPER_PAGES"] = "on"
    try:
        rx = pkg.reactor.Reactor(c2, cluster=cluster, apply_objects=True)
        for g in gvks:
            rx.attach(g)
        warm = _verdicts(_sweep(drv2, pkg))
        seq = drv2._state(TARGET).ledger.seq
        src = resources[0]
        cur = cluster.get(pkg.fake.gvk_of(src), src["metadata"]["name"],
                          src["metadata"].get("namespace"))
        o = copy.deepcopy(cur)
        o.setdefault("metadata", {}).setdefault("labels", {})["wm"] = "x"
        cluster.update(o)
        rx.pump()
        counters = {k: rx.counters[k] for k in ("pathology_stale_rv",
                                                "rung2", "rung3")}
        state = rx.state
        rx.stop()
    finally:
        os.environ.pop("GATEKEEPER_PAGES", None)
    return {"floors": floors, "per_kind": per_kind, "warm": warm,
            "seq": seq, "counters": counters, "state": state,
            "live": _verdicts(_sweep(drv, pkg))}


def test_clean_warm_restart_replays_nothing(sides):
    """The pagemap tier records the watch RV watermark; ``ledger_rv``
    seeds each resource kind's floor from it before any adoption (the
    snapshot-watermark branch), a clean restart replays nothing, and the
    live stream extends the watermark: no stale-RV resync."""
    got = {side: _clean_restart(pkg) for side, pkg in sides.items()}
    port = got["port"]
    assert port == got["ref"]
    assert any(v > 0 for v in port["floors"].values())
    assert all(v > 0 for v in port["per_kind"].values())
    assert port["seq"] == 0
    assert port["counters"] == {"pathology_stale_rv": 0, "rung2": 0,
                                "rung3": 0}
    assert port["state"] == "live"
    assert port["warm"] == port["live"]


def _stale_restart(pkg) -> dict:
    cluster_a, gvks, resources, drv, c = _cluster_fixture(pkg)
    # pump cluster A's RVs well past what a fresh cluster restarts at,
    # so the snapshot watermark is unambiguously ahead
    for _round in range(3):
        for src in resources:
            cur = cluster_a.get(pkg.fake.gvk_of(src),
                                src["metadata"]["name"],
                                src["metadata"].get("namespace"))
            o = copy.deepcopy(cur)
            o.setdefault("metadata", {}).setdefault(
                "labels", {})["bump"] = str(_round)
            cluster_a.update(o)
    objs = [o for g in gvks for o in cluster_a.list(g)]
    c.add_data_batch(copy.deepcopy(objs))
    _sweep(drv, pkg)
    # "restart" against a DIFFERENT watch epoch: a fresh cluster whose
    # RVs restart from 1, with diverged objects
    cluster_b = pkg.fake.FakeCluster()
    for o in resources:
        o2 = copy.deepcopy(o)
        o2.setdefault("metadata", {}).setdefault("labels", {})["epoch"] = "b"
        cluster_b.create(o2)
    drv2, c2 = _restart(pkg, drv)
    if pkg.side == "ref":
        _mapped(c2, drv2)
    os.environ["GATEKEEPER_PAGES"] = "on"
    try:
        rx = pkg.reactor.Reactor(c2, cluster=cluster_b, apply_objects=True)
        for g in gvks:
            rx.attach(g)
        # first observed event per kind fails to extend the watermark ->
        # one forced resync each, relisted from B
        for g in gvks:
            src = next(o for o in resources if o["kind"] == g.kind)
            cur = cluster_b.get(g, src["metadata"]["name"],
                                src["metadata"].get("namespace"))
            o = copy.deepcopy(cur)
            o.setdefault("metadata", {}).setdefault(
                "labels", {})["poke"] = "1"
            cluster_b.update(o)
        rx.pump()
        counters = {k: rx.counters[k] for k in ("pathology_stale_rv",
                                                "rung2", "rung3")}
        state = rx.state
        got = _verdicts(_sweep(drv2, pkg))
        rx.stop()
    finally:
        os.environ.pop("GATEKEEPER_PAGES", None)
    # the store converged to cluster B, not the adopted snapshot
    oracle, co = _mk(pkg)
    co.add_data_batch(copy.deepcopy(
        [o for g in gvks for o in cluster_b.list(g)]))
    return {"counters": counters, "state": state, "got": got,
            "want": _verdicts(_sweep(oracle, pkg, pages=False)),
            "n_gvks": len(gvks),
            "pending": sorted(drv2._state(TARGET).ledger_restored or {})}


def test_stale_watermark_forces_kind_resync(sides):
    """A watermark the live stream cannot extend means the adopted state
    is from another watch epoch: each kind gets one forced resync, which
    also discards the kind's pending adoption."""
    got = {side: _stale_restart(pkg) for side, pkg in sides.items()}
    port = got["port"]
    assert port == got["ref"]
    assert port["counters"]["pathology_stale_rv"] >= port["n_gvks"]
    assert port["counters"]["rung2"] + port["counters"]["rung3"] >= 1
    assert port["state"] == "live"
    assert port["got"] == port["want"]
    assert not set(port["pending"]) & set(KINDS)
