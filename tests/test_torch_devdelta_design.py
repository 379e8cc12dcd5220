"""K6 (the devpages delta) and K7 (the inventory join) as single-pass
kernels: their packed outputs, persistent tables and host copies.

K6 (``csrc/devdelta.cu``) is one launch with a decoupled look-back; its
``idx``, ``count``, ``signs`` and ``row_any`` are views of one packed
buffer (``kernels/devdelta.layout``) that ``executor.eval_mask_delta``
copies to the host once.  K7 (``csrc/invjoin.cu``) keeps its per-value
table across calls, one epoch-tagged word a value id.  On the CPU these
tests hold the layout, the views and the executor's results against the
plain versions; the ``cuda``-marked tests hold both kernels bit for bit
against their plain versions on the card at the edges of the design (a
look-back across thousands of tiles, changes only in the last tile, the
fill past the count in the kernel and in its second launch, ragged
shapes, CUDA-graph replays, back-to-back joins and the epoch's wrap).
This file imports neither jax nor the JAX package, so on a machine with
a card and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_devdelta_design.py
"""

import random

import numpy as np
import pytest
import torch

from gatekeeper_tpu_torch.client.interface import QueryOpts
from gatekeeper_tpu_torch.engine import executor as tex
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.kernels import devdelta, invjoin
from gatekeeper_tpu_torch.library.north_star import (make_resources,
                                                     setup_north_star)

TARGET = "admission.k8s.gatekeeper.sh"
OUTPUTS = ("new_g", "idx", "signs", "count", "row_any")


def _case(c_rows, n_rows, density, seed, pt_kind="identity"):
    """(new, pt, old): ``old`` is the gathered ``new`` with ``density``
    of its bits flipped; ``pt`` identity or a permutation."""
    rng = np.random.default_rng(seed)
    new = torch.from_numpy(rng.random((c_rows, n_rows)) < 0.4)
    pt = np.arange(n_rows, dtype=np.int32)
    if pt_kind == "permuted":
        pt = rng.permutation(n_rows).astype(np.int32)
    pt = torch.from_numpy(pt)
    g = devdelta.mask_delta_plain(new, pt, torch.zeros_like(new), 1)[0]
    old = g ^ torch.from_numpy(rng.random((c_rows, n_rows)) < density)
    return new, pt, old


def _packed_like_the_kernel(outs, c_rows, n_rows, k):
    """A uint8 buffer laid out as K6 writes it, from plain outputs."""
    lay = devdelta.layout(c_rows, n_rows, k)
    buf = torch.zeros((lay["size"],), dtype=torch.uint8)
    _g, idx, signs, count, row_any = outs
    buf[: 4 * k] = idx.view(torch.uint8)
    buf[lay["count"]: lay["count"] + 4] = \
        count.reshape(1).view(torch.uint8)
    buf[lay["signs"]: lay["signs"] + k] = signs.view(torch.uint8)
    buf[lay["row_any"]: lay["host"]] = row_any.view(torch.uint8)
    return buf, lay


# -- on the CPU


@pytest.mark.parametrize("c_rows,n_rows,k", [
    (4, 131072, 256), (128, 131072, 4096), (3, 4097, 20000), (1, 1, 1),
    (5, 1000, 64), (4, 8192, 1 << 20)])
def test_layout_is_the_kernels(c_rows, n_rows, k):
    """The packed layout gk_devdelta checks its buffer against: idx at 0,
    count after it, signs after that, row_any and the status words on 16
    bytes, 8 bytes a tile and a ticket, a 16-byte aligned end."""
    lay = devdelta.layout(c_rows, n_rows, k)
    n_tiles = -(-(c_rows * n_rows) // devdelta.TILE)
    assert (lay["idx"], lay["count"], lay["signs"]) == (0, 4 * k, 4 * k + 4)
    assert lay["row_any"] >= 5 * k + 4 and lay["row_any"] % 16 == 0
    assert lay["host"] == lay["row_any"] + n_rows
    assert lay["status"] >= lay["host"] and lay["status"] % 16 == 0
    assert lay["size"] >= lay["status"] + 8 * n_tiles + 4
    assert lay["size"] % 16 == 0 and lay["size"] - lay["status"] < \
        8 * n_tiles + 4 + 16
    assert lay["row_any"] - (5 * k + 4) < 16
    assert lay["status"] - lay["host"] < 16


@pytest.mark.parametrize("c_rows,n_rows,density,k", [
    (4, 4096, 0.01, 256), (3, 4097, 0.5, 20000), (5, 1000, 0.05, 64),
    (2, 64, 0.0, 1), (8, 512, 0.3, 10)])
def test_packed_views_have_the_plain_outputs(c_rows, n_rows, density, k):
    """The four views of the packed buffer (and its host bytes) have the
    plain version's dtypes, shapes and values."""
    new, pt, old = _case(c_rows, n_rows, density, c_rows + n_rows)
    want = devdelta.mask_delta_plain(new, pt, old, k)
    buf, lay = _packed_like_the_kernel(want, c_rows, n_rows, k)
    for name, a, b in zip(OUTPUTS[1:],
                          devdelta._views(buf.view(torch.int32), lay, k),
                          want[1:]):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    idx, signs, count, row_any = devdelta._unpack(buf.numpy(), lay, k)
    np.testing.assert_array_equal(idx, want[1].numpy())
    np.testing.assert_array_equal(signs, want[2].numpy())
    np.testing.assert_array_equal(row_any, want[4].numpy())
    assert (idx.dtype, signs.dtype, row_any.dtype) == \
        (np.int32, np.bool_, np.bool_)
    assert count == int(want[3]) and isinstance(count, int)


def test_to_host_reads_cpu_outputs_as_they_are():
    new, pt, old = _case(4, 512, 0.02, 3)
    outs = devdelta.mask_delta_plain(new, pt, old, 64)
    err = invjoin.error_flag("cpu")
    idx, signs, count, row_any, flag = devdelta.to_host(outs, err)
    np.testing.assert_array_equal(idx, outs[1].numpy())
    np.testing.assert_array_equal(signs, outs[2].numpy())
    np.testing.assert_array_equal(row_any, outs[4].numpy())
    assert count == int(outs[3]) and flag.tolist() == [0]
    assert devdelta.to_host(outs)[4] is None


@pytest.fixture
def cpu_bindings(monkeypatch):
    """A TorchDriver(device="cpu") after one legacy capped sweep of the
    north-star kinds: (driver, [(program, bindings)])."""
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    drv = TorchDriver(device="cpu")
    setup_north_star(drv, make_resources(300, random.Random(1)),
                     random.Random(2), c_per_kind=2)
    drv.query_audit(TARGET, QueryOpts(limit_per_constraint=20))
    st = drv._state(TARGET)
    return drv, [(st.templates[kind].vectorized.program, b)
                 for kind, (_g, b) in sorted(st.bindings_cache.items())]


@pytest.mark.parametrize("pt_kind", ["identity", "permuted"])
def test_eval_mask_delta_returns_the_plain_delta(cpu_bindings, pt_kind):
    """executor.eval_mask_delta on the CPU: the new mask as a tensor, idx
    int32, signs and row_any bool as numpy, the count as an int, each
    the plain K1 + K6 composition's, with one plain K6 call a delta."""
    drv, pairs = cpu_bindings
    ex = drv.executor
    rng = np.random.default_rng(5)
    for prog, b in pairs:
        arrays = {nm: a for nm, a in ex._arrays(b, None).items()
                  if nm != "__match__"}
        new = tex._eval_mask(prog, arrays)
        pt = torch.arange(b.r_pad, dtype=torch.int32)
        if pt_kind == "permuted":
            pt = torch.from_numpy(rng.permutation(b.r_pad).astype(np.int32))
        old = torch.from_numpy(rng.random((b.c_pad, b.r_pad)) < 0.1)
        for k in (1, 256, b.c_pad * b.r_pad + 3):
            calls = devdelta.mask_delta.plain_calls
            got = ex.eval_mask_delta(prog, b, None, old, pt, k)
            assert devdelta.mask_delta.plain_calls == calls + 1
            want = devdelta.mask_delta_plain(new, pt, old, k)
            assert torch.equal(got[0], want[0])
            for a, w in zip(got[1:], (want[1], want[2], None, want[4])):
                if w is None:
                    assert isinstance(a, int) and a == int(want[3])
                else:
                    assert isinstance(a, np.ndarray) and \
                        a.dtype == w.numpy().dtype
                    np.testing.assert_array_equal(a, w.numpy())


def test_join_table_grows_and_keeps_epochs_per_device():
    """The K7 table of a device: zeroed at first use and when n_ids
    outgrows it, one epoch a call, zeroed again before the epoch
    wraps."""
    dev = torch.device("cpu")
    saved = invjoin._TABLES.pop(dev, None)
    try:
        w1, e1 = invjoin._table_for(dev, 10)
        w2, e2 = invjoin._table_for(dev, 4)
        assert w2 is w1 and (e1, e2) == (1, 2) and w1.numel() == 10
        w3, e3 = invjoin._table_for(dev, 11)
        assert w3.numel() == 11 and e3 == 1 and not w3.any()
        w3.fill_(7)
        invjoin._TABLES[dev].epoch = invjoin.EPOCH_LIMIT - 1
        w4, e4 = invjoin._table_for(dev, 11)
        assert w4 is w3 and e4 == 1 and not w4.any()
    finally:
        invjoin._TABLES.pop(dev, None)
        if saved is not None:
            invjoin._TABLES[dev] = saved


# -- on a CUDA card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6 and K7 run only on the GPU")
    return torch.device("cuda")


def _k6_equal(ins, k):
    got = devdelta.mask_delta(*ins, k)
    torch.cuda.synchronize()
    want = devdelta.mask_delta_plain(*ins, k)
    for name, a, b in zip(OUTPUTS, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("c_rows,n_rows,flip", [
    (4, 131072, "last"), (128, 131072, "last"), (3, 6000, "last"),
    (4, 131072, "first"), (128, 131072, "one_per_tile")])
def test_k6_changes_at_the_tile_edges_on_card(card, c_rows, n_rows, flip):
    """Changes only in the last tile (every earlier tile publishes an
    empty aggregate), only at flat 0, or one in every tile (the
    look-back carries a prefix across thousands of tiles)."""
    new, pt, _ = _case(c_rows, n_rows, 0.0, 11)
    g = devdelta.mask_delta_plain(new, pt, torch.zeros_like(new), 1)[0]
    flat = g.clone().reshape(-1)
    total = flat.numel()
    if flip == "last":
        at = torch.arange(total - 50, total)
    elif flip == "first":
        at = torch.tensor([0])
    else:
        at = torch.arange(devdelta.TILE - 1, total, devdelta.TILE)
    flat[at] = ~flat[at]
    ins = tuple(t.to(card) for t in (new, pt, flat.reshape(g.shape)))
    for k in (1, at.numel(), at.numel() + 100):
        got = _k6_equal(ins, k)
        assert int(got[3]) == at.numel()


@pytest.mark.cuda
def test_k6_graph_replay_on_card(card):
    """K6 captured in a CUDA graph (the memset beside the launch and the
    launch itself) gives, on every replay, the eager call's outputs."""
    new, pt, old = (t.to(card) for t in _case(4, 131072, 1e-3, 2))
    for k in (256, 1 << 15):     # the last block fills; the fill launch
        devdelta.mask_delta(new, pt, old, k)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = devdelta.mask_delta(new, pt, old, k)
        want = devdelta.mask_delta_plain(new, pt, old, k)
        for _ in range(3):
            for t in got:
                t.fill_(True if t.dtype == torch.bool else -7)
            graph.replay()
            torch.cuda.synchronize()
            for name, a, b in zip(OUTPUTS, got, want):
                assert torch.equal(a, b), name
        del graph


@pytest.mark.cuda
def test_k6_to_host_is_one_copy_on_card(card, monkeypatch):
    """to_host reads the packed buffer and K7's flag with one
    synchronisation and returns the plain version's values."""
    new, pt, old = (t.to(card) for t in _case(128, 131072, 1e-4, 4,
                                               "permuted"))
    outs = devdelta.mask_delta(new, pt, old, 4096)
    err = invjoin.error_flag(card)
    err.fill_(1)
    syncs = []
    real = torch.cuda.Event.synchronize
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda ev: (syncs.append(1), real(ev))[1])
    idx, signs, count, row_any, flag = devdelta.to_host(outs, err)
    assert syncs == [1] and flag.tolist() == [1]
    want = devdelta.mask_delta_plain(new, pt, old, 4096)
    np.testing.assert_array_equal(idx, want[1].cpu().numpy())
    np.testing.assert_array_equal(signs, want[2].cpu().numpy())
    np.testing.assert_array_equal(row_any, want[4].cpu().numpy())
    assert count == int(want[3])


def _k7_ins(n, n_vals, seed, card):
    rng = np.random.default_rng(seed)
    src = rng.integers(-1, n_vals, n).astype(np.int32)
    inv = rng.integers(-1, n_vals, n).astype(np.int32)
    names = rng.integers(-1, 6, n).astype(np.int32)
    sel = rng.random(n) < 0.6
    return tuple(torch.from_numpy(a).to(card) for a in (src, inv, sel, names))


@pytest.mark.cuda
def test_k7_back_to_back_and_across_the_epoch_wrap_on_card(card):
    """Back-to-back joins with other inputs at one n_ids, then past the
    epoch's wrap: no word of an earlier call is read as this call's."""
    dev = torch.device("cuda", torch.cuda.current_device())
    invjoin._table_for(dev, 3000)
    tab = invjoin._TABLES[dev]
    for step in range(6):
        if step == 3:
            tab.epoch = invjoin.EPOCH_LIMIT - 2
        ins = _k7_ins(131072, 2000 if step % 2 else 3000, 60 + step, card)
        for exclude in (True, False):
            err = invjoin.error_flag(card)
            got = invjoin.inv_join_mask(*ins, exclude, 3000, err)
            invjoin.check_error(err, 3000)
            want = invjoin.inv_join_mask_plain(*ins, exclude, 3000)
            assert torch.equal(got, want), (step, exclude)
    assert 0 < tab.epoch < 10


@pytest.mark.cuda
def test_k7_graph_replay_on_card(card):
    """K7 captured in a CUDA graph (its epoch an argument) gives the
    eager call's verdicts on every replay of the same inputs."""
    ins = _k7_ins(131072, 5000, 3, card)
    err = invjoin.error_flag(card)
    want = invjoin.inv_join_mask_plain(*ins, True, 5000)
    invjoin.inv_join_mask(*ins, True, 5000, err)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = invjoin.inv_join_mask(*ins, True, 5000, err)
    for _ in range(3):
        got.fill_(True)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    invjoin.check_error(err, 5000)
    del graph
