"""The churn-delta warm-up: K5's delta variant compiled off the sweep.

Since full and delta evaluation are two Triton variants of one
generated kernel (``kernels/ir_eval.py``, the ``DELTA`` constexpr), the
first churned sweep of a process would compile each kind's delta variant
on the sweep.  The reference compiles its delta executables on a
background ``delta-warmup`` thread after the first capped sweep
(``gatekeeper_tpu/engine/jax_driver.py`` query_audit, ``veval.py``
``ProgramExecutor.prewarm_deltas``); the port does the same with one real
K5 launch per kind (``ProgramExecutor.prewarm_deltas``).

On the CPU these tests hold the mechanism: no warm-up on CPU bindings or
a CPU driver, the thread and its error path through a stub, and plans
and compiles that stay single under concurrent launches through a stub
launcher.  The ``cuda``-marked tests hold it on the card: the first
churned sweep after the warm-up compiles no Triton variant, the warm-up
counts in no launch counter, and an error in it is raised by the next
audit.  This file imports jax only inside CPU tests, so on a machine
with a card and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_prewarm.py
"""

import copy
import random
import sys
import threading
import time

import pytest
import torch

from gatekeeper_tpu_torch.client.interface import QueryOpts
from gatekeeper_tpu_torch.engine import executor as tex
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.kernels import ir_eval
from gatekeeper_tpu_torch.kernels.op_cases import every_op_case
from gatekeeper_tpu_torch.library.north_star import (make_resources,
                                                     setup_north_star)

TARGET = "admission.k8s.gatekeeper.sh"
CAP = QueryOpts(limit_per_constraint=20)


@pytest.fixture(autouse=True)
def _legacy_device_path(monkeypatch):
    # the warm-up follows the legacy capped sweep; the paged route is the
    # port's default and runs no K5
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")


def _key(r):
    return (r.constraint["kind"], r.constraint["metadata"]["name"], r.msg,
            (r.resource or {}).get("metadata", {}).get("name"))


def _north_star(device=None, pods=300, seed=1):
    drv = TorchDriver() if device is None else TorchDriver(device=device)
    resources = make_resources(pods, random.Random(seed))
    client = setup_north_star(drv, resources, random.Random(2),
                              c_per_kind=2)
    return drv, client, resources


def _relabel(clients, resources, n, seed):
    rng = random.Random(seed)
    for i in rng.sample(range(len(resources)), n):
        o = copy.deepcopy(resources[i])
        o["metadata"]["labels"] = {f"l{j}": "v" for j in range(10)
                                   if rng.random() < 0.35}
        resources[i] = o
        for c in clients:
            c.add_data(o)


def _counters(drv):
    return (ir_eval.delta_mask.launches, ir_eval.delta_mask.plain_calls,
            ir_eval.eval_mask.launches, drv.executor.delta_evals,
            drv.executor.mask_evals)


# -- on the CPU


def test_prewarm_deltas_on_cpu_launches_nothing():
    """prewarm_deltas on CPU bindings a sweep stored a mask on: nothing
    launched, nothing counted, no plain call."""
    drv, _client, _res = _north_star("cpu")
    drv.query_audit(TARGET, CAP)
    st = drv._state(TARGET)
    before = _counters(drv)
    for kind, (_gen, bindings) in sorted(st.bindings_cache.items()):
        prog = st.templates[kind].vectorized.program
        assert drv.executor.prewarm_deltas(prog, bindings) is False
    assert _counters(drv) == before


def test_cpu_driver_starts_no_warm_and_matches_reference(monkeypatch):
    """A TorchDriver(device="cpu") capped audit, churn and audit start no
    warm-up thread, and the results stay the reference's."""
    from test_torch_driver import _jax_north_star, _key as jkey

    from gatekeeper_tpu.engine.jax_driver import JaxDriver
    spawned = []
    monkeypatch.setattr(torch_driver, "spawn_bg",
                        lambda target, name: spawned.append(name))
    drv, client, resources = _north_star("cpu")
    jd = JaxDriver()
    jclient = _jax_north_star(jd, list(resources), random.Random(2), 2)
    for rnd in range(2):
        got = [jkey(r) for r in client.audit(limit_per_constraint=20)
               .results()]
        want = [jkey(r) for r in jclient.audit(limit_per_constraint=20)
                .results()]
        assert got == want and got, rnd
        _relabel([client, jclient], resources, 3, 40 + rnd)
    assert spawned == [] and drv.delta_warm is None
    assert not any(t.name == "delta-warmup" for t in threading.enumerate())


def test_warm_runs_each_kind_once_on_a_named_thread(monkeypatch):
    """_start_delta_warm hands each (program, bindings) to prewarm_deltas
    in order on a daemon ``delta-warmup`` thread that the exit drain
    knows, and records its seconds."""
    drv, _client, _res = _north_star("cpu")
    seen = []
    monkeypatch.setattr(drv.executor, "prewarm_deltas",
                        lambda prog, b: seen.append(
                            (prog, b, threading.current_thread().name)))
    items = [("p0", "b0"), ("p1", "b1"), ("p2", "b2")]
    drv._start_delta_warm(items)
    warm = drv.delta_warm
    assert warm.thread.name == "delta-warmup" and warm.thread.daemon
    assert warm.thread in tex._BG_THREADS
    assert drv.wait_delta_warm(timeout=30) is not None
    assert not warm.thread.is_alive()
    assert seen == [(p, b, "delta-warmup") for p, b in items]
    assert warm.error is None and warm.kinds == 3
    drv.query_audit(TARGET, CAP)


def test_warm_error_is_raised_by_the_next_audit(monkeypatch):
    """An exception of the warm-up is kept and raised, once, by the next
    query_audit (the reference swallows it; the port lets kernel-layer
    errors end the sweep)."""
    drv, _client, _res = _north_star("cpu")
    want, _ = drv.query_audit(TARGET, CAP)

    def boom(prog, bindings):
        raise RuntimeError("warm-up launch refused")

    monkeypatch.setattr(drv.executor, "prewarm_deltas", boom)
    drv._start_delta_warm([("p", "b")])
    drv.delta_warm.thread.join(timeout=30)
    with pytest.raises(RuntimeError, match="warm-up launch refused"):
        drv.query_audit(TARGET, CAP)
    got, _ = drv.query_audit(TARGET, CAP)
    assert [_key(r) for r in got] == [_key(r) for r in want]
    # waiting for the warm-up raises it too, once
    drv._start_delta_warm([("p", "b")])
    with pytest.raises(RuntimeError, match="warm-up launch refused"):
        drv.wait_delta_warm(timeout=30)
    assert drv.wait_delta_warm(timeout=30) is not None
    drv.query_audit(TARGET, CAP)


def test_warm_stops_at_shutdown(monkeypatch):
    """Once the exit drain has set the shutdown event, the warm-up
    compiles no further kind."""
    drv, _client, _res = _north_star("cpu")
    stop = threading.Event()
    stop.set()
    monkeypatch.setattr(torch_driver, "BG_SHUTDOWN", stop)
    seen = []
    monkeypatch.setattr(drv.executor, "prewarm_deltas",
                        lambda prog, b: seen.append(prog))
    drv._start_delta_warm([("p", "b")])
    drv.wait_delta_warm(timeout=30)
    assert seen == [] and drv.delta_warm.error is None


class _StubCompiled:
    """What Triton's JIT launch returns: launched by ``[grid](*args)``."""

    def __init__(self, log):
        self.log = log

    def __getitem__(self, grid):
        return lambda *args: self.log.append("cached")


class _StubKernel:
    """A JIT function whose launch "compiles" slowly and records whether
    two launches ever ran through it at once."""

    def __init__(self):
        self.lock = threading.Lock()
        self.active = 0
        self.overlap = False
        self.log = []

    def __getitem__(self, grid):
        def launch(*args, **kw):
            with self.lock:
                self.active += 1
                self.overlap |= self.active > 1
            time.sleep(0.005)
            with self.lock:
                self.active -= 1
            self.log.append(("jit", kw["DELTA"]))
            return _StubCompiled(self.log)
        return launch


def test_concurrent_launches_make_one_plan_and_one_compile(monkeypatch):
    """Threads launching one program at once, in full and in delta mode,
    leave one plan per key in _PLANS and one JIT launch (the compile)
    per plan; every other launch takes the compiled kernel, and no two
    JIT launches overlap."""
    stub = _StubKernel()
    made = []
    make = ir_eval._make_plan
    monkeypatch.setattr(ir_eval, "_PLANS", {})
    monkeypatch.setattr(ir_eval, "_kernel_for",
                        lambda program, sig: (stub, ["__alive__"], [], []))

    def counted(*args):
        time.sleep(0.002)
        made.append(args[2])
        return make(*args)

    monkeypatch.setattr(ir_eval, "_make_plan", counted)
    prog, _host = every_op_case(0, c_pad=8, r_pad=64)
    arrays = {"__alive__": torch.ones((64,), dtype=torch.bool),
              "__cvalid__": torch.ones((8,), dtype=torch.bool)}
    rows = torch.zeros((8,), dtype=torch.int32)
    n = 24
    start = threading.Barrier(n)
    plans = [None] * n

    def worker(i):
        out = torch.zeros((8, 64), dtype=torch.bool)
        start.wait()
        plans[i] = ir_eval._launch(prog, arrays, out,
                                   rows if i % 2 else None, "stub")

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert len(made) == 2 and set(made) == {None, 8}
    assert len(ir_eval._PLANS) == 2
    assert {id(p) for p in plans[0::2]} | {id(p) for p in plans[1::2]} \
        == {id(p) for p in ir_eval._PLANS.values()}
    jit = [e for e in stub.log if e != "cached"]
    assert sorted(jit) == [("jit", False), ("jit", True)]
    assert stub.log.count("cached") == n - 2 and not stub.overlap


# -- on a CUDA card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the warm-up launches K5 only on "
                    "the GPU")
    return torch.device("cuda")


def _variants():
    """Compiled Triton variants over every K1 kernel of this process."""
    n = 0
    for kern, *_ in list(ir_eval._KERNELS.values()):
        caches = getattr(kern, "device_caches", None)
        if caches is not None:
            n += sum(len(c[0]) for c in caches.values())
        else:
            n += sum(len(c) for c in kern.cache.values())
    return n


@pytest.mark.cuda
def test_first_churned_sweep_after_the_warm_compiles_nothing_on_card(card):
    """After the first capped sweep the driver warms each swept kind's
    delta variant on a background thread; the warm-up counts in no
    launch counter, and the first churned sweep after it compiles no
    Triton variant, takes 3 K5 launches and matches the CPU driver."""
    drv, client, resources = _north_star(pods=2000)
    cpu, cpu_client, _ = _north_star("cpu", pods=2000)
    drv.query_audit(TARGET, CAP)
    warm = drv.delta_warm
    assert warm is not None and warm.kinds == 3
    after_sweep = _counters(drv)
    assert drv.wait_delta_warm(timeout=600) is not None
    assert warm.error is None and not warm.thread.is_alive()
    assert _counters(drv) == after_sweep
    v0 = _variants()
    _relabel([client, cpu_client], resources, 20, 7)
    launches = ir_eval.delta_mask.launches
    got, _ = drv.query_audit(TARGET, CAP)
    torch.cuda.synchronize()
    assert _variants() == v0
    assert ir_eval.delta_mask.launches - launches == 3
    want, _ = cpu.query_audit(TARGET, CAP)
    assert [_key(r) for r in got] == [_key(r) for r in want] and got
    assert drv.delta_warm is warm       # one warm-up per driver


@pytest.mark.cuda
def test_warm_error_is_raised_by_the_next_audit_on_card(card, monkeypatch):
    """A warm-up launch that raises on the card makes the driver's next
    query_audit raise it."""
    def refused(program, arrays, viol_old, rows):
        raise RuntimeError("warm-up launch refused")

    monkeypatch.setattr(ir_eval, "warm_delta", refused)
    drv, _client, _res = _north_star(pods=500)
    drv.query_audit(TARGET, CAP)
    drv.delta_warm.thread.join(timeout=600)
    with pytest.raises(RuntimeError, match="warm-up launch refused"):
        drv.query_audit(TARGET, CAP)
    drv.query_audit(TARGET, CAP)
