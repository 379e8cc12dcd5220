"""The eager mirror and the ingest warm of the port, on the CPU.

A batch ingest of ``MIRROR_EAGER_MIN_ROWS`` rows or more builds each
device kind's bindings, the row order and the rank gate at once (the
reference's ``JaxDriver._materialize_mirror``), and on CUDA compiles each
kind's full K1 variant on background ``ingest-prewarm`` threads
(``ProgramExecutor.prewarm_audit_exec``).  These tests hold:

- the mirror against the reference's: the same kinds, each with the same
  binding names in the same order, shapes, dtypes and host bytes;
- no warm thread on the CPU, and none below the row threshold;
- the plan key, through a stub Triton launcher (as
  ``tests/test_torch_prewarm.py`` stubs it): the warm makes exactly the
  plan and the compiled entry that the cold sweep's first K1 launch of
  each kind then reuses, so the sweep compiles nothing;
- the kinds warmed: none that the paged route (the default) serves;
- the thread mechanics: a warm error is raised by the next
  ``query_audit`` (and by ``wait_ingest_warm``), once; ``BG_SHUTDOWN``
  stops the queue; a later large ingest waits for the warm before it;
  a sweep waits for a warm stopped mid-upload, and a warm whose
  bindings a churn replaced skips them, so sweeps and churns beside a
  live warm give the results of a driver with no warm.

The ``cuda``-marked test holds the same on the card: the cold sweep
after the ingest warm compiles no Triton variant.  This file imports jax
only inside the reference comparison, so on a machine with a card and
no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_ingest_warm.py
"""

import random
import threading
import time
import types

import numpy as np
import pytest
import torch

from gatekeeper_tpu_torch.client.client import Backend
from gatekeeper_tpu_torch.client.interface import QueryOpts
from gatekeeper_tpu_torch.engine import executor as tex
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import IngestWarm, TorchDriver
from gatekeeper_tpu_torch.kernels import dfa, ir_eval, topk
from gatekeeper_tpu_torch.library import all_docs
from gatekeeper_tpu_torch.library.north_star import (make_resources,
                                                     setup_north_star)
from gatekeeper_tpu_torch.library.templates import (LIBRARY, constraint_doc,
                                                    template_doc)
from gatekeeper_tpu_torch.target.k8s import TARGET_NAME, K8sValidationTarget

CAP = QueryOpts(limit_per_constraint=20)


@pytest.fixture(autouse=True)
def _device_path(monkeypatch):
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.setattr(torch_driver, "MIRROR_EAGER_MIN_ROWS", 50)
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")


def _warm_threads():
    return [t for t in threading.enumerate()
            if t.name == "ingest-prewarm" and t.is_alive()]


def _north_star(device="cpu", pods=200, digests=True):
    """The north-star set (3 kinds) plus K8sImageDigests (a regex
    table), ``pods`` pods ingested in one batch."""
    drv = TorchDriver(device=device)
    resources = make_resources(pods, random.Random(1))
    client = Backend(drv).new_client([K8sValidationTarget()])
    if digests:
        rego, params = LIBRARY["K8sImageDigests"]
        client.add_template(template_doc("K8sImageDigests", rego))
        client.add_constraint(constraint_doc("K8sImageDigests", "digests",
                                             params))
    setup_north_star(drv, resources, random.Random(2), c_per_kind=2)
    return drv, client, resources


def _items(drv, st):
    """The warm's queue as ``_materialize_mirror`` makes it, for every
    kind with bindings: ``(kind, program, bindings, with_match)``."""
    out = []
    for kind in sorted(st.bindings_cache):
        cons = drv._kind_constraints(st, kind)
        out.append((kind, st.templates[kind].vectorized.program,
                    st.bindings_cache[kind][1],
                    any((c.get("spec") or {}).get("match") for c in cons)))
    return out


def _card_stand_in(monkeypatch, ex):
    """Let ``ex.prewarm_audit_exec`` run its card path on the CPU: the
    executor's device reads as CUDA, and its uploads stay host copies."""
    monkeypatch.setattr(ex, "device", types.SimpleNamespace(type="cuda"))
    monkeypatch.setattr(ex, "_upload", lambda host: torch.from_numpy(
        np.ascontiguousarray(host)).clone())


def _stub_launcher(monkeypatch):
    """A stub Triton launcher for every K1 plan, and the sweep's K1
    wrapper launching through it on CPU tensors (then computing the
    plain mask); returns (the stub, the plans the sweep launched)."""
    stub = _StubKernel()
    monkeypatch.setattr(ir_eval, "_PLANS", {})
    monkeypatch.setattr(ir_eval, "_kernel_for",
                        lambda program, sig: (stub, ["__alive__"], [], []))
    swept = []

    def launching(program, arrays):
        out = torch.empty((arrays["__cvalid__"].shape[0],
                           arrays["__alive__"].shape[0]), dtype=torch.bool)
        swept.append(ir_eval._launch(program, arrays, out, None,
                                     "eval_mask"))
        return tex._eval_mask(program, arrays)

    monkeypatch.setattr(ir_eval, "eval_mask", launching)
    return stub, swept


def _keys(results):
    return [(r.constraint["metadata"]["name"], r.msg) for r in results]


def test_mirror_builds_the_reference_bindings(monkeypatch):
    """Every library kind's eager bindings equal the reference's in
    names (and their order), shapes, dtypes and host bytes; the row
    order and rank are built; the mirror is timed once."""
    from gatekeeper_tpu.client.client import Backend as JBackend
    from gatekeeper_tpu.engine import jax_driver
    from gatekeeper_tpu.engine.jax_driver import JaxDriver
    from gatekeeper_tpu.library import make_mixed
    from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget
    monkeypatch.setattr(jax_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.setattr(jax_driver, "MIRROR_EAGER_MIN_ROWS", 50)
    jd = JaxDriver()
    # the reference's warm threads compile XLA executables; the bindings
    # are what is compared here
    monkeypatch.setattr(jd.executor, "prewarm_audit_exec",
                        lambda *a, **k: None)
    td = TorchDriver(device="cpu")
    objs = make_mixed(random.Random(1), 60)
    for drv, backend, target in ((jd, JBackend, JTarget),
                                 (td, Backend, K8sValidationTarget)):
        c = backend(drv).new_client([target()])
        for t, con in all_docs():
            c.add_template(t)
            c.add_constraint(con)
        c.add_data_batch(objs)
    js, ts = jd.state[TARGET_NAME], td.state[TARGET_NAME]
    assert sorted(ts.bindings_cache) == sorted(js.bindings_cache)
    assert len(ts.bindings_cache) >= 40
    for kind in sorted(js.bindings_cache):
        jb = js.bindings_cache[kind][1]
        tb = ts.bindings_cache[kind][1]
        assert list(tb.arrays) == list(jb.arrays), kind
        for nm, a in jb.arrays.items():
            assert tb.arrays[nm].shape == a.shape, (kind, nm)
            assert str(tb.arrays[nm].dtype) == str(a.dtype), (kind, nm)
        assert sum(a.nbytes for a in tb.arrays.values()) == \
            sum(a.nbytes for a in jb.arrays.values()), kind
        assert (tb.c_pad, tb.r_pad) == (jb.c_pad, jb.r_pad)
    assert ts.order_cache is not None and ts.rank_cache is not None
    assert td.metrics.timer("mirror_materialize").count == 1
    assert td.metrics.counter("bindings_full_builds").value == \
        len(ts.bindings_cache)


def test_no_warm_thread_on_the_cpu():
    before = set(_warm_threads())
    drv, _client, _res = _north_star()
    assert drv.ingest_warm is None
    assert set(_warm_threads()) <= before
    assert drv.wait_ingest_warm() is None
    st = drv._state(TARGET_NAME)
    assert len(st.bindings_cache) == 4
    assert drv.metrics.timer("mirror_materialize").count == 1
    # and the first sweep finds the bindings built
    builds = drv.metrics.counter("bindings_full_builds").value
    drv.query_audit(TARGET_NAME, CAP)
    assert drv.metrics.counter("bindings_full_builds").value == builds
    # the CPU executor launches nothing for a warm
    b = st.bindings_cache["K8sRequiredLabels"][1]
    prog = st.templates["K8sRequiredLabels"].vectorized.program
    assert drv.executor.prewarm_audit_exec(prog, b, 20) is False


def test_small_batches_build_no_mirror(monkeypatch):
    monkeypatch.setattr(torch_driver, "MIRROR_EAGER_MIN_ROWS", 10_000)
    drv, _client, _res = _north_star()
    assert drv._state(TARGET_NAME).bindings_cache == {}
    assert drv.metrics.timer("mirror_materialize").count == 0


# -- the plan key, through a stub Triton launcher


class _StubCompiled:
    """What Triton's JIT launch returns: launched by ``[grid](*args)``."""

    def __init__(self, log):
        self.log = log

    def __getitem__(self, grid):
        return lambda *args: self.log.append("cached")


class _StubKernel:
    def __init__(self):
        self.log = []

    def __getitem__(self, grid):
        def launch(*args, **kw):
            self.log.append("jit")
            return _StubCompiled(self.log)
        return launch


def test_warm_plan_is_the_cold_sweeps_plan(monkeypatch):
    """The warm's launch of each kind makes the plan and the compiled
    entry that the cold sweep's first K1 launch of that kind reuses:
    the sweep makes no plan and takes no JIT launch (no compile), and
    the warm loads K2 and, for the regex kind, K3."""
    loads = []
    monkeypatch.setattr(topk, "load", lambda: loads.append("K2"))
    monkeypatch.setattr(dfa, "load", lambda: loads.append("K3"))
    drv, _client, _res = _north_star()
    stub, swept = _stub_launcher(monkeypatch)
    st = drv._state(TARGET_NAME)
    ex = drv.executor
    device = ex.device
    _card_stand_in(monkeypatch, ex)
    for _kind, prog, bindings, with_match in _items(drv, st):
        assert ex.prewarm_audit_exec(prog, bindings,
                                     torch_driver.DEFAULT_PREWARM_CAP,
                                     with_match) is True
    monkeypatch.setattr(ex, "device", device)
    assert sorted(loads) == ["K2"] * 4 + ["K3"]
    plans = set(map(id, ir_eval._PLANS.values()))
    assert len(plans) == 4 and stub.log == ["jit"] * 4
    assert ex.mask_evals == 0 and swept == []

    n_plans = len(ir_eval._PLANS)
    res, _ = drv.query_audit(TARGET_NAME, CAP)
    assert len(swept) == 4
    assert {id(p) for p in swept} == plans
    assert len(ir_eval._PLANS) == n_plans
    assert stub.log == ["jit"] * 4 + ["cached"] * 4
    monkeypatch.setattr(ir_eval, "eval_mask", tex._eval_mask)
    cpu, _c, _r = _north_star()
    want, _ = cpu.query_audit(TARGET_NAME, CAP)
    assert _keys(res) == _keys(want)


@pytest.mark.parametrize("pages", ["on", "off"])
def test_the_warm_skips_kinds_the_paged_route_serves(monkeypatch, pages):
    """Under the paged route (the default) the four row-local kinds are
    served from the verdict ledger and never launch the full variant,
    so the mirror builds their bindings but warms none of them; with
    the route off, all four are warmed."""
    monkeypatch.setenv("GATEKEEPER_PAGES", pages)
    drv, _client, _res = _north_star()
    st = drv._state(TARGET_NAME)
    queued = []
    monkeypatch.setattr(drv, "device", types.SimpleNamespace(type="cuda"))
    monkeypatch.setattr(drv, "_start_ingest_warm",
                        lambda st_, items: queued.extend(items))
    drv._materialize_mirror(st)
    assert len(st.bindings_cache) == 4
    if pages == "on":
        assert queued == []
    else:
        assert [(k, wm) for k, _p, _b, wm in queued] == \
            [(k, wm) for k, _p, _b, wm in _items(drv, st)]


def test_a_trivial_match_kind_warms_without_the_match_gate(monkeypatch):
    """Constraints without match criteria get no ``__match__`` at the
    sweep, so the warm leaves it out too (else it compiles a variant the
    sweep never asks for)."""
    drv, _client, _res = _north_star(digests=False)
    st = drv._state(TARGET_NAME)
    b = st.bindings_cache["K8sRequiredLabels"][1]
    prog = st.templates["K8sRequiredLabels"].vectorized.program
    with_gate = drv.executor.audit_warm_arrays(prog, b, 20, True)
    without = drv.executor.audit_warm_arrays(prog, b, 20, False)
    assert list(with_gate)[-2:] == ["__match__", "__rank__"]
    assert "__match__" not in without and list(without)[-1] == "__rank__"
    assert with_gate["__match__"].shape == (b.c_pad, b.r_pad)
    assert with_gate["__rank__"].dtype == torch.int32
    assert "__rank__" not in drv.executor.audit_warm_arrays(prog, b)


# -- the thread mechanics (driven directly: on the CPU no warm starts)


def test_warm_error_is_raised_by_the_next_audit(monkeypatch):
    drv, _client, _res = _north_star()
    st = drv._state(TARGET_NAME)

    def refused(*args, **kw):
        raise RuntimeError("warm launch refused")

    monkeypatch.setattr(drv.executor, "prewarm_audit_exec", refused)
    items = _items(drv, st)
    drv._start_ingest_warm(st, items)
    for t in drv.ingest_warm.threads:
        t.join(30)
    assert len(drv.ingest_warm.threads) == 4
    with pytest.raises(RuntimeError, match="warm launch refused"):
        drv.query_audit(TARGET_NAME, CAP)
    res, _ = drv.query_audit(TARGET_NAME, CAP)     # raised once
    assert res
    drv._start_ingest_warm(st, items[:1])
    with pytest.raises(RuntimeError, match="warm launch refused"):
        drv.wait_ingest_warm(timeout=30)
    assert drv.wait_ingest_warm(timeout=30) is not None


def test_warm_drains_every_kind_once(monkeypatch):
    drv, _client, _res = _north_star()
    st = drv._state(TARGET_NAME)
    seen = []
    lock = threading.Lock()

    def record(prog, bindings, k, with_match=False):
        with lock:
            seen.append((id(prog), k, with_match))
        return True

    monkeypatch.setattr(drv.executor, "prewarm_audit_exec", record)
    items = [(k, p, b, k != "K8sImageDigests")
             for k, p, b, _wm in _items(drv, st)]
    drv._start_ingest_warm(st, items)
    secs = drv.wait_ingest_warm(timeout=30)
    assert secs is not None and secs >= 0.0
    assert sorted(seen) == sorted((id(p), torch_driver.DEFAULT_PREWARM_CAP,
                                   wm) for _k, p, _b, wm in items)
    assert drv.ingest_warm.kinds == 4 and drv.ingest_warm.error is None


def test_bg_shutdown_stops_the_queue(monkeypatch):
    drv, _client, _res = _north_star()
    stop = threading.Event()
    stop.set()
    monkeypatch.setattr(torch_driver, "BG_SHUTDOWN", stop)
    seen = []
    monkeypatch.setattr(drv.executor, "prewarm_audit_exec",
                        lambda *a, **k: seen.append(a))
    st = drv._state(TARGET_NAME)
    drv._start_ingest_warm(st, _items(drv, st)[:3])
    drv.wait_ingest_warm(timeout=30)
    assert seen == [] and drv.ingest_warm.error is None


def test_a_later_ingest_waits_for_the_warm_and_keeps_its_error(monkeypatch):
    drv, _client, _res = _north_star()
    release = threading.Event()
    calls = []

    def slow(*args, **kw):
        release.wait(30)
        calls.append(1)
        raise RuntimeError("first warm failed")

    monkeypatch.setattr(drv.executor, "prewarm_audit_exec", slow)
    st = drv._state(TARGET_NAME)
    items = _items(drv, st)[:1]
    drv._start_ingest_warm(st, items)
    first = drv.ingest_warm
    release.set()
    monkeypatch.setattr(drv.executor, "prewarm_audit_exec",
                        lambda *a, **k: True)
    drv._start_ingest_warm(st, items)
    assert not any(t.is_alive() for t in first.threads)
    assert calls == [1]
    with pytest.raises(RuntimeError, match="first warm failed"):
        drv.wait_ingest_warm(timeout=30)


def _relabel(client, resources, rnd, n=20):
    """Churn: ``n`` pods, each with a new label, upserted one at a
    time."""
    for i in range(rnd * n, rnd * n + n):
        o = dict(resources[i])
        meta = dict(o["metadata"])
        meta["labels"] = {**(meta.get("labels") or {}), f"churn{rnd}": "x"}
        o["metadata"] = meta
        client.add_data(o)


def test_sweeps_and_churns_beside_a_live_warm(monkeypatch):
    """A warm stopped mid-upload holds the sweep's prep lock, so a
    sweep started then waits for it instead of staging and migrating
    the same bindings' device caches beside it; the warm items left
    after two churns find their bindings replaced and skip them.  Every
    sweep equals a driver's with no warm, and every plan is compiled
    (JIT-launched) once."""
    loads = []
    monkeypatch.setattr(topk, "load", lambda: loads.append("K2"))
    monkeypatch.setattr(dfa, "load", lambda: loads.append("K3"))
    drv, client, resources = _north_star()
    stub, swept = _stub_launcher(monkeypatch)
    st = drv._state(TARGET_NAME)
    ex = drv.executor
    uploads = ex._upload
    _card_stand_in(monkeypatch, ex)
    blocked, release = threading.Event(), threading.Event()
    warm_uploads = []

    def upload(host):
        if threading.current_thread().name == "ingest-prewarm":
            warm_uploads.append(host.shape)
            if len(warm_uploads) == 2:
                blocked.set()
                release.wait(30)
        return torch.from_numpy(np.ascontiguousarray(host)).clone()

    monkeypatch.setattr(ex, "_upload", upload)
    drv._start_ingest_warm(st, _items(drv, st))
    assert blocked.wait(30)
    got = []
    sweeper = threading.Thread(
        target=lambda: got.append(drv.query_audit(TARGET_NAME, CAP)[0]))
    sweeper.start()
    time.sleep(0.3)
    assert sweeper.is_alive()           # waiting for the warm's item
    release.set()
    sweeper.join(30)
    assert not sweeper.is_alive()
    for rnd in range(2):
        _relabel(client, resources, rnd)
        got.append(drv.query_audit(TARGET_NAME, CAP)[0])
    drv.wait_ingest_warm(timeout=30)
    assert drv.ingest_warm.error is None
    assert len(warm_uploads) >= 2

    monkeypatch.setattr(ex, "_upload", uploads)
    monkeypatch.setattr(ir_eval, "eval_mask", tex._eval_mask)
    cpu, cpu_client, cpu_resources = _north_star()
    want = [cpu.query_audit(TARGET_NAME, CAP)[0]]
    for rnd in range(2):
        _relabel(cpu_client, cpu_resources, rnd)
        want.append(cpu.query_audit(TARGET_NAME, CAP)[0])
    assert [_keys(r) for r in got] == [_keys(r) for r in want]
    assert all(want)
    assert stub.log.count("jit") == len(ir_eval._PLANS) >= 4
    assert len(swept) >= 4


def test_ingest_warm_dataclass_defaults():
    w = IngestWarm()
    assert (w.threads, w.kinds, w.seconds, w.error) == ([], 0, None, None)
    assert tex.spawn_bg is torch_driver.spawn_bg


# -- on a CUDA card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ingest warm launches K1 only on "
                    "the GPU")
    return torch.device("cuda")


def _variants():
    n = 0
    for kern, *_ in list(ir_eval._KERNELS.values()):
        caches = getattr(kern, "device_caches", None)
        if caches is not None:
            n += sum(len(c[0]) for c in caches.values())
        else:
            n += sum(len(c) for c in kern.cache.values())
    return n


@pytest.mark.cuda
def test_cold_sweep_after_the_ingest_warm_compiles_nothing_on_card(card):
    """The ingest warm compiles each kind's full variant off the sweep,
    counts in no launch counter, and the cold sweep after it compiles no
    Triton variant and matches the CPU driver."""
    launches = (ir_eval.eval_mask.launches, topk.topk_packed.launches,
                dfa.dfa_table.launches)
    v0 = _variants()
    drv, _client, _res = _north_star(device=None, pods=2000)
    warm = drv.ingest_warm
    assert warm is not None and warm.kinds == 4
    assert drv.wait_ingest_warm(timeout=600) is not None
    assert (ir_eval.eval_mask.launches, topk.topk_packed.launches,
            dfa.dfa_table.launches) == launches
    assert drv.executor.mask_evals == 0
    v1 = _variants()
    assert v1 > v0
    got, _ = drv.query_audit(TARGET_NAME, CAP)
    torch.cuda.synchronize()
    assert _variants() == v1
    assert ir_eval.eval_mask.launches - launches[0] == 4
    cpu, _c, _r = _north_star(pods=2000)
    want, _ = cpu.query_audit(TARGET_NAME, CAP)
    key = [(r.constraint["metadata"]["name"], r.msg) for r in want]
    assert [(r.constraint["metadata"]["name"], r.msg) for r in got] == key
    assert key
    drv.wait_delta_warm(timeout=600)
