"""Backend supervisor + warm-restart snapshot tests of the port
(gatekeeper_tpu_torch/resilience/), the flows of tests/test_resilience.py
on ``TorchDriver(device="cpu")``, and the port's own rules.

Deterministic by construction: the supervisors' background re-probe
loop is disabled (``GATEKEEPER_SUPERVISOR_REPROBE=0``) and transitions
are driven by hand via ``reprobe_now()`` — except the one test whose
subject IS the background loop, which runs it with a tiny backoff.  The
port's re-probe runs its real op on the supervised device (here the
CPU); a test that needs it to fail patches ``_device_check``.  Snapshot
persistence activates only inside tests that point
``GATEKEEPER_SNAPSHOT_DIR`` at a tmp_path.  ``probe_retry_primitive``
of the reference has no counterpart: the port resolves its device with
utils/device.py, which answers or raises.
"""

import dataclasses
import json
import os
import pickle
import random
import time

import pytest
import torch

from gatekeeper_tpu_torch.client import probe
from gatekeeper_tpu_torch.engine import torch_driver as td_mod
from gatekeeper_tpu_torch.resilience import faults
from gatekeeper_tpu_torch.resilience import snapshot as snap
from gatekeeper_tpu_torch.resilience import supervisor as sup_mod
from gatekeeper_tpu_torch.resilience.smoke import _verdict_digest

TARGET = "admission.k8s.gatekeeper.sh"
KINDS = ("K8sRequiredLabels", "K8sAllowedRepos", "K8sDisallowedTags")
CPU = torch.device("cpu")


@pytest.fixture
def clean_backend(monkeypatch):
    """Fresh supervisors (the port's and the reference's) + fault
    harnesses, auto-reprobe off (tests drive transitions by hand),
    snapshots off, every kind on the device path."""
    from gatekeeper_tpu.resilience import faults as jfaults
    from gatekeeper_tpu.utils import device_probe
    monkeypatch.setenv("GATEKEEPER_SUPERVISOR_REPROBE", "0")
    for var in ("GATEKEEPER_FAULT", "GATEKEEPER_SNAPSHOT_DIR",
                "GATEKEEPER_PROBE_TEST_HANG", "GATEKEEPER_PROBE_TEST_FAIL"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(td_mod, "SMALL_WORKLOAD_EVALS", 0)
    sup_mod.reset_for_tests()
    faults.reset_for_tests()
    device_probe.reset_for_tests()
    jfaults.reset_for_tests()
    yield
    sup_mod.reset_for_tests()
    faults.reset_for_tests()
    device_probe.reset_for_tests()
    jfaults.reset_for_tests()


def _mk_client(driver=None, n=24, seed=7, with_data=True, ref=False):
    """A small 3-template policy set over a deterministic inventory, on
    the port (``TorchDriver(device="cpu")``) or, with ``ref``, the
    reference (``JaxDriver``)."""
    if ref:
        from gatekeeper_tpu.client.client import Backend
        from gatekeeper_tpu.engine.jax_driver import JaxDriver
        from gatekeeper_tpu.library import make_mixed
        from gatekeeper_tpu.library.templates import (LIBRARY,
                                                      constraint_doc,
                                                      template_doc)
        from gatekeeper_tpu.target.k8s import K8sValidationTarget
        driver = driver or JaxDriver()
    else:
        from gatekeeper_tpu_torch.client.client import Backend
        from gatekeeper_tpu_torch.library import make_mixed
        from gatekeeper_tpu_torch.library.templates import (LIBRARY,
                                                            constraint_doc,
                                                            template_doc)
        from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
        driver = driver or td_mod.TorchDriver(device="cpu")
    client = Backend(driver).new_client([K8sValidationTarget()])
    for kind in KINDS:
        rego, params = LIBRARY[kind]
        client.add_template(template_doc(kind, rego))
        client.add_constraint(constraint_doc(kind, kind.lower() + "-1",
                                             params))
    if with_data:
        client.add_data_batch(make_mixed(random.Random(seed), n))
    return driver, client


def _audit(driver, ref=False):
    if ref:
        from gatekeeper_tpu.client.interface import QueryOpts
    else:
        from gatekeeper_tpu_torch.client.interface import QueryOpts
    results, _trace = driver.query_audit(TARGET, QueryOpts(full=True))
    return results


def _counts(metrics) -> dict:
    return {k: metrics.counter(k).value
            for k in ("backend_degradations", "backend_recoveries",
                      "backend_reprobe_failures")}


# ----------------------------------------------------------------------
# supervisor state machine


def test_supervisor_demote_reprobe_recover(clean_backend, monkeypatch):
    s = sup_mod.get_supervisor(CPU)
    assert s is sup_mod.get_supervisor("cpu")
    assert s.state == sup_mod.HEALTHY
    assert s.use_device()
    # never seeded degraded: the resolved device was the first probe
    assert s.status()["last_probe_at"] is not None

    s.report_failure("card flake")
    assert s.state == sup_mod.DEGRADED
    assert not s.use_device()
    st = s.status()
    assert st["reason"] == "card flake"
    assert st["backend"] == "cpu-fallback"

    # a failed re-probe lands back in degraded, not healthy
    real = s._device_check
    monkeypatch.setattr(s, "_device_check",
                        lambda t: (False, 0, "", "still down"))
    assert s.reprobe_now() is False
    assert s.state == sup_mod.DEGRADED
    assert s.status()["reprobe_attempts"] == 1
    assert s.metrics.counter("backend_reprobe_failures").value == 1

    # the real probe op on the device restores healthy
    monkeypatch.setattr(s, "_device_check", real)
    assert s.reprobe_now() is True
    assert s.state == sup_mod.HEALTHY
    assert s.use_device()
    assert s.status()["backend"] == "cpu"
    assert s.reason == "recovered: 1 cpu device(s)"
    assert s.metrics.counter("backend_recoveries").value == 1


def test_poisoned_is_terminal(clean_backend, monkeypatch):
    s = sup_mod.get_supervisor(CPU)
    s.report_failure("hung mid-dispatch", poisoned=True)
    assert s.state == sup_mod.POISONED
    # poisoned never re-probes: the hung thread may sit in the driver
    monkeypatch.setattr(
        s, "_device_check",
        lambda t: pytest.fail("poisoned supervisor must not re-probe"))
    assert s.reprobe_now() is False
    assert s.state == sup_mod.POISONED
    s.report_failure("later flake")         # cannot un-poison either
    assert s.state == sup_mod.POISONED


def test_a_hung_reprobe_poisons(clean_backend, monkeypatch):
    """``probe_hang``: the re-probe's thread parks past its join
    deadline, and the supervisor is poisoned — its thread may still sit
    inside the CUDA driver."""
    s = sup_mod.get_supervisor(CPU)
    s.report_failure("card flake")
    monkeypatch.setenv("GATEKEEPER_FAULT", "probe_hang")
    assert s.reprobe_now(timeout_s=0.2) is False
    assert s.state == sup_mod.POISONED
    assert "re-probe hung" in s.reason
    assert s.status()["reprobe_attempts"] == 1


def test_background_reprobe_loop_with_backoff(clean_backend, monkeypatch):
    monkeypatch.setenv("GATEKEEPER_SUPERVISOR_REPROBE", "1")
    monkeypatch.setenv("GATEKEEPER_SUPERVISOR_BACKOFF_S", "0.05")
    s = sup_mod.get_supervisor(CPU)
    assert s.state == sup_mod.HEALTHY
    calls = []
    real = s._device_check

    def check(timeout_s):
        calls.append(timeout_s)
        if len(calls) < 3:
            return (False, 0, "", "still down")
        return real(timeout_s)

    monkeypatch.setattr(s, "_device_check", check)
    s.report_failure("transient flake")
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and s.state != sup_mod.HEALTHY:
        time.sleep(0.02)
    assert s.state == sup_mod.HEALTHY, f"loop never recovered: {s.status()}"
    assert len(calls) >= 3              # two failures, then recovery
    assert s.metrics.counter("backend_recoveries").value == 1


def test_a_cpu_supervisor_is_not_demoted_by_another_devices_fault(
        clean_backend):
    """One supervisor a device: the card's fault leaves a CPU driver
    (the tests' oracle, chip_smoke.py's plain checks) on its device
    path, and the reverse."""
    drv, _ = _mk_client()
    card = sup_mod.get_supervisor(torch.device("cuda", 0))
    card.report_failure("card lost")
    assert card.state == sup_mod.DEGRADED
    assert drv.supervisor is sup_mod.get_supervisor(CPU)
    assert drv.supervisor.state == sup_mod.HEALTHY
    assert not drv.scalar_only
    drv.supervisor.report_failure("cpu lost")
    assert drv.scalar_only
    assert card.reason == "card lost"


# ----------------------------------------------------------------------
# device_lost mid-sweep


def test_device_lost_mid_sweep_completes_then_recovers(
        clean_backend, monkeypatch):
    """The reference's flow on both packages: the card dies after the
    first kind dispatches; the sweep completes with the healthy
    verdicts, the supervisor is degraded with the reference's state,
    reason and transition counts, and a re-probe brings it back with
    one ``backend_rejits``."""
    from gatekeeper_tpu.engine import jax_driver as jd_mod
    from gatekeeper_tpu.resilience import supervisor as jsup
    monkeypatch.setattr(jd_mod, "SMALL_WORKLOAD_EVALS", 0)
    jd0, _ = _mk_client(seed=7, ref=True)
    want = _audit(jd0, ref=True)
    assert want, "workload must produce violations"
    want_digest = _verdict_digest(want)
    healthy, _ = _mk_client(seed=7)
    assert _verdict_digest(_audit(healthy)) == want_digest

    monkeypatch.setenv("GATEKEEPER_FAULT", "device_lost")
    jd, _ = _mk_client(seed=7, ref=True)
    ref_got = _audit(jd, ref=True)
    drv, _ = _mk_client(seed=7)
    evals0 = drv.executor.mask_evals
    got = _audit(drv)
    s, rs = drv.supervisor, jd.supervisor
    assert s.state == rs.state == sup_mod.DEGRADED == jsup.DEGRADED
    assert s.reason == rs.reason
    assert "device_lost" in s.reason
    assert drv.scalar_only and jd.scalar_only
    # only the kind dispatched before the seam fired reached the device
    assert drv.executor.mask_evals - evals0 == 1
    assert _verdict_digest(got) == _verdict_digest(ref_got) == want_digest
    assert _counts(s.metrics) == _counts(rs.metrics)

    monkeypatch.delenv("GATEKEEPER_FAULT")
    monkeypatch.setattr(rs, "_device_check", lambda t: (True, 8, "cpu", ""))
    assert s.reprobe_now() is True and rs.reprobe_now() is True
    assert s.state == rs.state == sup_mod.HEALTHY
    assert not drv.scalar_only
    assert _counts(s.metrics) == _counts(rs.metrics)
    assert drv.metrics.counter("backend_rejits").value == \
        jd.metrics.counter("backend_rejits").value == 1
    evals0 = drv.executor.mask_evals
    assert _verdict_digest(_audit(drv)) == want_digest
    assert drv.executor.mask_evals - evals0 == len(KINDS)


def test_a_kernel_exception_ends_the_sweep_and_leaves_the_supervisor_healthy(
        clean_backend, monkeypatch):
    """Nothing catches a kernel error in order to demote: a launch that
    raises ends its sweep, and the supervisor stays healthy."""
    drv, _ = _mk_client()

    def broken(*a, **k):
        raise RuntimeError("K1 launch failed")
    monkeypatch.setattr(drv.executor, "_full_mask", broken)
    with pytest.raises(RuntimeError, match="K1 launch failed"):
        _audit(drv)
    assert drv.supervisor.state == sup_mod.HEALTHY
    assert not drv.scalar_only
    assert drv.supervisor.metrics.counter("backend_degradations").value == 0


# ----------------------------------------------------------------------
# snapshot persistence


def test_snapshot_corruption_never_crashes(clean_backend, monkeypatch,
                                           tmp_path):
    monkeypatch.setenv("GATEKEEPER_SNAPSHOT_DIR", str(tmp_path))
    payload = ({"x": 1, "y": [1, 2, 3]}, True)
    assert snap.save_template_module("K", TARGET, "src", payload)
    key = f"mod:{snap.template_digest('K', TARGET, 'src')}"
    path = snap._entry_path("mod", key)
    with open(path, "rb") as f:
        raw = f.read()

    hit = snap.load_template_module("K", TARGET, "src")
    assert hit is not None and hit[0] == payload

    corruptions = [
        ("truncated", raw[:-3]),
        ("bad magic", raw.replace(snap.MAGIC.encode(), b"not-a-snapshot", 1)),
        ("version skew", raw.replace(
            f'"version": {snap.VERSION}'.encode(), b'"version": 9999', 1)),
        ("payload bitflip", raw[:-1] + bytes([raw[-1] ^ 0xFF])),
        ("garbage", b"\x00\x01 not even a header"),
    ]
    for why, bad in corruptions:
        with open(path, "wb") as f:
            f.write(bad)
        before = snap.stats.snapshot()
        assert snap.load_template_module("K", TARGET, "src") is None, why
        delta = snap.stats.delta_since(before)
        assert delta["corrupt_discarded"] == 1, why
        assert delta["mod_misses"] == 1 and delta["mod_hits"] == 0, why
        # the bad entry is deleted so the cold rebuild can re-save it
        assert not os.path.exists(path), why
        assert snap.save_template_module("K", TARGET, "src", payload), why
    hit = snap.load_template_module("K", TARGET, "src")
    assert hit is not None and hit[0] == payload


def test_snapshot_corrupt_fault_is_one_shot(clean_backend, monkeypatch,
                                            tmp_path):
    monkeypatch.setenv("GATEKEEPER_SNAPSHOT_DIR", str(tmp_path))
    assert snap.save_dedup_plan("abc", {"plan": 1})
    monkeypatch.setenv("GATEKEEPER_FAULT", "snapshot_corrupt")
    before = snap.stats.snapshot()
    assert snap.load_dedup_plan("abc") is None      # injected corruption
    assert snap.stats.delta_since(before)["corrupt_discarded"] == 1
    # one-shot: after the single injected failure, the rebuilt entry
    # loads fine even with the fault still armed in the env
    assert snap.save_dedup_plan("abc", {"plan": 2})
    hit = snap.load_dedup_plan("abc")
    assert hit is not None and hit[0] == {"plan": 2}
    # re-armed, it fires once more
    faults.rearm("snapshot_corrupt")
    assert snap.load_dedup_plan("abc") is None


def test_warm_restart_in_process_skips_lowering(clean_backend, monkeypatch,
                                                tmp_path):
    monkeypatch.setenv("GATEKEEPER_SNAPSHOT_DIR", str(tmp_path))
    drv_cold, _ = _mk_client(seed=3)
    # a cold process prepares its audit before it serves, as the smoke
    # and the manager's start do: the Stage-7 precompile stamps its
    # geometry in the cs tier, which the warm prepare_audit reads back
    assert drv_cold.prepare_audit(TARGET) is True
    cold_digest = _verdict_digest(_audit(drv_cold))
    assert drv_cold.save_store_snapshot(TARGET)

    base = snap.stats.snapshot()

    def boom(*a, **k):
        raise AssertionError("warm path must not re-lower Rego")

    monkeypatch.setattr(td_mod, "lower_template", boom)
    drv_warm, _ = _mk_client(with_data=False)       # would raise if lowering
    assert drv_warm.restore_store_snapshot(TARGET) is True
    assert drv_warm.prepare_audit(TARGET) is True
    warm_digest = _verdict_digest(_audit(drv_warm))

    assert warm_digest == cold_digest               # bit-identical verdicts
    delta = snap.stats.delta_since(base)
    hits, misses = snap.tier_counts(delta)
    assert misses == 0, delta
    assert delta["ir_hits"] == 3                    # one per template
    assert delta["mod_hits"] == 3                   # parse+vet skipped too
    assert delta["store_hits"] == 1
    assert delta["plan_hits"] == 1
    assert delta["pg_hits"] == 1      # pagemap tier (pages default-on)
    assert delta["cs_hits"] == 1      # the precompile's geometry stamp
    assert hits == 10
    assert drv_warm.metrics.counter("template_ir_snapshot_hits").value == 3

    # repeat prepare_audit is satisfied from the in-memory memo, not
    # another disk read (monkeypatched loader would fail the call)
    monkeypatch.setattr(
        snap, "load_dedup_plan",
        lambda *a, **k: pytest.fail("memo must satisfy repeat prepare_audit"))
    assert drv_warm.prepare_audit(TARGET) is True


@pytest.mark.parametrize("freeze_min, frozen", [(10**9, False), (1, True)])
def test_restore_pauses_the_collector_as_the_ingest_does(
        clean_backend, monkeypatch, tmp_path, freeze_min, frozen):
    """The store restore, the cold ingest's counterpart, loads with the
    cyclic GC paused (utils/gcpause.BulkLoad) and leaves it enabled;
    past FREEZE_MIN_OBJECTS resources it freezes the heap after the
    load, as ``Client.add_data_batch`` does.  The verdicts hold."""
    import gc
    from gatekeeper_tpu_torch.utils import gcpause
    monkeypatch.setenv("GATEKEEPER_SNAPSHOT_DIR", str(tmp_path))
    drv_cold, _ = _mk_client(seed=3)
    assert drv_cold.save_store_snapshot(TARGET)
    drv_warm, _ = _mk_client(with_data=False)
    monkeypatch.setattr(gcpause, "FREEZE_MIN_OBJECTS", freeze_min)
    table = drv_warm._state(TARGET).table
    collecting = []

    def restore_state(state, real=table.restore_state):
        collecting.append(gc.isenabled())
        real(state)
    monkeypatch.setattr(table, "restore_state", restore_state)
    assert gc.isenabled()
    before = gc.get_freeze_count()
    try:
        assert drv_warm.restore_store_snapshot(TARGET)
        assert collecting == [False] and gc.isenabled()
        assert (gc.get_freeze_count() > before) is frozen
    finally:
        gc.unfreeze()
    assert _verdict_digest(_audit(drv_warm)) == \
        _verdict_digest(_audit(drv_cold))


def test_snapshot_disabled_is_inert(clean_backend):
    assert not snap.enabled()
    assert snap.load_template_ir("K", TARGET, "src") is None
    assert snap.save_template_ir("K", TARGET, "src", None) is False
    assert snap.load_store(TARGET) is None
    assert snap.snapshot_dir() is None
    drv, _ = _mk_client()
    assert drv.save_store_snapshot(TARGET) is False
    assert drv.restore_store_snapshot(TARGET) is False


def _walk_tensors(obj, seen=None):
    """Every torch.Tensor reachable from an unpickled entry (containers,
    dataclasses and plain objects' attributes)."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield obj
        return
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _walk_tensors(k, seen)
            yield from _walk_tensors(v, seen)
    elif isinstance(obj, (list, tuple, set, frozenset)):
        for v in obj:
            yield from _walk_tensors(v, seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _walk_tensors(getattr(obj, f.name, None), seen)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type) \
            and not callable(obj):
        yield from _walk_tensors(vars(obj), seen)


def test_no_snapshot_entry_holds_a_device_tensor(clean_backend, monkeypatch,
                                                 tmp_path):
    """Every entry a paged, devpaged warm-restart flow writes unpickles
    to host data only, and the pickler refuses a tensor on any device
    but the CPU (a CUDA tensor would load onto a card at unpickle
    time, outside the driver's device and Stage 8's accounting)."""
    monkeypatch.setenv("GATEKEEPER_SNAPSHOT_DIR", str(tmp_path))
    monkeypatch.setenv("GATEKEEPER_PAGES", "on")
    monkeypatch.setenv("GATEKEEPER_DEVPAGES", "on")
    from gatekeeper_tpu_torch.client.interface import QueryOpts
    drv, _ = _mk_client(seed=3)
    drv.query_audit(TARGET, QueryOpts(limit_per_constraint=20))
    assert drv._state(TARGET).devpages, "devpages must have run"
    assert drv.save_store_snapshot(TARGET)
    files = [os.path.join(r, f) for r, _d, fs in os.walk(tmp_path)
             for f in fs if f.endswith(".snap")]
    cats = {os.path.basename(f).split("-")[0] for f in files}
    assert {"ir", "mod", "store", "pg"} <= cats
    n_tensors = 0
    for path in files:
        with open(path, "rb") as f:
            raw = f.read()
        obj = pickle.loads(raw[raw.index(b"\n") + 1:])
        for t in _walk_tensors(obj):
            n_tensors += 1
            assert t.device.type == "cpu", (path, t.device)
    assert n_tensors == 0
    before = snap.stats.snapshot()
    assert snap.save_dedup_plan("dev", {"mask": torch.empty(2, device="meta")}) \
        is False
    assert snap.stats.delta_since(before)["save_errors"] == 1
    assert snap.load_dedup_plan("dev") is None


def test_a_reference_entry_in_the_same_directory_is_a_miss(
        clean_backend, monkeypatch, tmp_path):
    """One GATEKEEPER_SNAPSHOT_DIR under both packages: neither reads the
    other's entries, and neither counts the other's a corruption (it is
    never opened, never deleted)."""
    from gatekeeper_tpu.resilience import snapshot as jsnap
    monkeypatch.setenv("GATEKEEPER_SNAPSHOT_DIR", str(tmp_path))
    payload = ({"x": 1}, False)
    assert jsnap.save_template_module("K", TARGET, "src", payload)
    before = snap.stats.snapshot()
    assert snap.load_template_module("K", TARGET, "src") is None
    delta = snap.stats.delta_since(before)
    assert delta["mod_misses"] == 1 and delta["corrupt_discarded"] == 0
    assert jsnap.load_template_module("K", TARGET, "src")[0] == payload

    assert snap.save_template_module("K", TARGET, "src", ({"y": 2}, True))
    jbefore = jsnap.stats.snapshot()
    assert jsnap.load_template_module("K", TARGET, "src")[0] == payload
    assert jsnap.stats.delta_since(jbefore)["corrupt_discarded"] == 0
    assert snap.load_template_module("K", TARGET, "src")[0] == \
        ({"y": 2}, True)
    assert snap.snapshot_dir() != jsnap.snapshot_dir()
    assert os.path.basename(snap.snapshot_dir()).startswith("torch-")


# ----------------------------------------------------------------------
# probe --health


def test_probe_health_healthy_and_degraded(clean_backend, capsys):
    """``--health``: the reference's JSON line, exit 0 only while the
    device asked for is healthy."""
    from gatekeeper_tpu.client import probe as jprobe
    rc = probe.main(["--health", "--device", "cpu"])
    out = capsys.readouterr().out
    doc = json.loads(out.strip().splitlines()[0])
    assert rc == 0
    assert doc["state"] == "healthy"
    assert "HEALTH OK (cpu)" in out
    assert "restart_persistent_cache_hits" in doc
    assert doc["last_probe_at"] is not None
    assert jprobe.run_health() == 0
    jdoc = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert set(doc) == set(jdoc)

    sup_mod.get_supervisor(CPU).report_failure("card lost")
    rc = probe.main(["--health", "--device", "cpu"])
    out = capsys.readouterr().out
    doc = json.loads(out.strip().splitlines()[0])
    assert rc == 2
    assert doc["state"] == "degraded"
    assert doc["backend"] == "cpu-fallback"
    assert doc["reason"] == "card lost"
    assert "HEALTH FAIL" in out
