"""The port's kernel wrappers and executor plans, without the reference.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a CUDA card and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

On the CPU the wrappers take their plain versions; the ``cuda``-marked
tests hold K1-K8 and the fleet audit's batched K1, K2 and K3 against
those plain versions on the card, bit for bit, and skip where there is
no card.
"""

import random

import numpy as np
import pytest
import torch

from gatekeeper_tpu_torch import convert
from gatekeeper_tpu_torch.engine import executor as tex
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.ir.program import Program
from gatekeeper_tpu_torch.kernels import devdelta
from gatekeeper_tpu_torch.kernels import dfa as tdfa
from gatekeeper_tpu_torch.kernels import invjoin, ir_eval, residency
from gatekeeper_tpu_torch.kernels import topk as ttopk
from gatekeeper_tpu_torch.kernels import scatter as tscatter
from gatekeeper_tpu_torch.kernels.op_cases import (every_op_case,
                                                   stacked_every_op_case)
from gatekeeper_tpu_torch.library.north_star import (make_resources,
                                                     setup_north_star)


def _packed_equal(got, want, k):
    """Counts, valid flags and the rows of valid slots (invalid slots'
    rows depend on tie order and are not part of the contract)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    gv, wv = got[:, 1 + k:], want[:, 1 + k:]
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(got[:, 1:1 + k] * gv, want[:, 1:1 + k] * wv)


def test_every_op_rules_each_fire():
    """Each rule of the every-op program fires somewhere, so the case
    really exercises every op."""
    prog, arrays = every_op_case(0, c_pad=16, r_pad=256)
    dev = convert.arrays_to_device(arrays, "cpu")
    for rule in prog.rules:
        one = Program(prog.nodes, (rule,))
        assert tex._eval_mask(one, dev).any(), rule


def test_narrow_id_columns_widen():
    """int8/int16 id columns (the executor's narrow transfer) evaluate
    exactly like their int32 originals."""
    prog, arrays = every_op_case(5, c_pad=8, r_pad=64)
    dev = convert.arrays_to_device(arrays, "cpu")
    want = tex._eval_mask(prog, dev)
    for dt in (torch.int8, torch.int16):
        narrow = {k: (v.to(dt) if v.dtype == torch.int32
                      and not k.endswith(".trans") else v)
                  for k, v in dev.items()}
        assert torch.equal(tex._eval_mask(prog, narrow), want)


def test_chunked_plain_mask_matches_unchunked():
    prog, arrays = every_op_case(6, c_pad=4, r_pad=2 * tex.R_CHUNK, e_pad=2)
    dev = convert.arrays_to_device(arrays, "cpu")
    chunked = tex._eval_mask(prog, dev)
    whole = tex._eval_program(prog, tex._with_dfa_tables(
        prog, dev, tdfa.dfa_table_plain))
    assert torch.equal(chunked, whole)


def test_cpu_wrappers_run_plain_versions():
    """On CPU tensors every kernel wrapper takes its plain version and
    counts a plain call, never a launch."""
    prog, arrays = every_op_case(1)
    dev = convert.arrays_to_device(arrays, "cpu")
    before = (ir_eval.eval_mask.plain_calls, ttopk.topk_packed.plain_calls,
              tdfa.dfa_table.plain_calls)
    launches = (ir_eval.eval_mask.launches, ttopk.topk_packed.launches,
                tdfa.dfa_table.launches)
    d = tex._with_dfa_tables(prog, dev, tdfa.dfa_table)
    mask = ir_eval.eval_mask(prog, d)
    ttopk.topk_packed(mask, None, 20)
    assert (ir_eval.eval_mask.plain_calls, ttopk.topk_packed.plain_calls,
            tdfa.dfa_table.plain_calls) == tuple(x + 1 for x in before)
    assert (ir_eval.eval_mask.launches, ttopk.topk_packed.launches,
            tdfa.dfa_table.launches) == launches


def test_executor_reuses_stored_mask():
    """A second sweep over unchanged bindings only reduces; new host
    arrays re-upload and re-evaluate."""
    prog, arrays = every_op_case(2)
    b = convert.bindings_from_plain(arrays, 6, 60, 8, 64)
    ex = tex.ProgramExecutor(device="cpu")
    first = ex.run_topk(prog, b, 20)
    assert ex.mask_evals == 1 and ex.reduces == 1
    h2d = ex.h2d_bytes
    again = ex.run_topk(prog, b, 20)
    assert ex.mask_evals == 1 and ex.reduces == 2 and ex.h2d_bytes == h2d
    for a, c in zip(first, again):
        np.testing.assert_array_equal(a, c)
    mask = ex.run(prog, b)
    assert ex.mask_evals == 1
    assert mask.shape == (6, 60)
    b.arrays = {**b.arrays, "__alive__": b.arrays["__alive__"].copy()}
    ex.run(prog, b)
    assert ex.mask_evals == 2


def _packed(topk):
    """(counts, rows, valid) from run_topk back in the packed layout."""
    counts, rows, valid = topk
    return np.concatenate([counts[:, None], rows, valid.astype(np.int32)],
                          axis=1)


def _churned(b, dirty, rng):
    """A bindings generation derived from ``b`` the way update_bindings
    derives one: new host arrays that differ from the base only at the
    rows ``dirty`` of every r-axis array, recorded in base_dirty."""
    arrays = dict(b.arrays)
    base_dirty = {}
    for nm, a in b.arrays.items():
        ax = tex._r_axis(nm)
        if ax is None or nm == "__match__":
            continue
        new = a.copy()
        idx = [slice(None)] * a.ndim
        idx[ax] = dirty
        src = [slice(None)] * a.ndim
        src[ax] = rng.permutation(a.shape[ax])[: len(dirty)]
        new[tuple(idx)] = a[tuple(src)]         # other rows' values
        arrays[nm] = new
        base_dirty[nm] = dirty
    return convert.bindings_from_plain(arrays, b.n_constraints,
                                       b.n_resources, b.c_pad, b.r_pad), \
        base_dirty


def _delta_round(ex, prog, b, rng, n_dirty):
    """One churned generation of ``b`` through ``ex``: returns the new
    bindings and its capped top-k, after checking the plan was delta."""
    dirty = np.sort(rng.choice(b.n_resources, size=n_dirty, replace=False))
    nb, base_dirty = _churned(b, dirty, rng)
    nb.base, nb.base_dirty = b, base_dirty
    evals, deltas = ex.mask_evals, ex.delta_evals
    got = ex.run_topk(prog, nb, 20)
    assert (ex.mask_evals, ex.delta_evals) == (evals, deltas + 1)
    assert nb.base is None and nb.base_dirty == {}
    return nb, got


def test_executor_delta_plan_matches_full():
    """A derived generation migrates by row scatter, re-evaluates only
    its dirty rows into the base's stored mask (the delta plan) and
    gives what a full evaluation of the same arrays gives."""
    prog, arrays = every_op_case(4, c_pad=8, r_pad=128)
    b = convert.bindings_from_plain(arrays, 6, 120, 8, 128)
    ex = tex.ProgramExecutor(device="cpu")
    ex.run_topk(prog, b, 20)
    rng = np.random.default_rng(0)
    for n_dirty in (1, 9, 14):
        rows = ex.h2d_scatter_rows
        h2d = ex.h2d_bytes
        nb, got = _delta_round(ex, prog, b, rng, n_dirty)
        assert ex.h2d_bytes == h2d           # nothing uploaded whole
        assert ex.h2d_scatter_rows > rows
        fresh = tex.ProgramExecutor(device="cpu")
        want = fresh.run_topk(prog, convert.bindings_from_plain(
            nb.arrays, 6, 120, 8, 128), 20)
        assert fresh.mask_evals == 1
        _packed_equal(_packed(got), _packed(want), 20)
        np.testing.assert_array_equal(ex.run(prog, nb),
                                      fresh.run(prog, nb))
        b = nb


def test_executor_delta_needs_matching_base():
    """The delta plan falls back to a full evaluation where the
    reference's does: an array changed outside the dirty rows."""
    prog, arrays = every_op_case(5, c_pad=8, r_pad=64)
    b = convert.bindings_from_plain(arrays, 6, 60, 8, 64)
    ex = tex.ProgramExecutor(device="cpu")
    ex.run(prog, b)
    nb, base_dirty = _churned(b, np.array([3, 7]), np.random.default_rng(1))
    nb.arrays["__cvalid__"] = ~b.arrays["__cvalid__"]
    nb.base, nb.base_dirty = b, base_dirty
    ex.run(prog, nb)
    assert (ex.mask_evals, ex.delta_evals) == (2, 0)


# -- the kernels themselves, on a CUDA card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1, K2 and K3 run only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, {"c_pad": 128, "r_pad": 4096, "e_pad": 8}),
    (2, {"c_pad": 16, "r_pad": 256, "e_pad": 2}),
])
def test_k1_k3_match_plain_on_card(card, seed, kw):
    """K3 then K1 on a program using every IR op, with int32 and with
    narrowed (int8/int16) id columns, against the plain versions."""
    prog, arrays = every_op_case(seed, **kw)
    t = convert.arrays_to_device(arrays, card)
    for dt in (None, torch.int8, torch.int16):
        x = t if dt is None else {
            k: (v.to(dt) if v.dtype == torch.int32
                and not k.endswith(".trans") else v)
            for k, v in t.items()}
        d = tex._with_dfa_tables(prog, x, tdfa.dfa_table)
        assert torch.equal(d["dfa0.devtab"], tex._dfa_device_table(x, "dfa0"))
        assert torch.equal(ir_eval.eval_mask(prog, d),
                           tex._eval_mask(prog, x)), dt


@pytest.mark.cuda
def test_k3_narrow_transition_table_on_card(card):
    _, arrays = every_op_case(3, t_pad=512, width=40, n_states=100)
    t = convert.arrays_to_device(arrays, card)
    ins = [t["dfa0.trans"], t["dfa0.accept"], t["__strbytes__"],
           t["__strdfaok__"], t["dfa0.xv"], 3]
    want = tdfa.dfa_table_plain(*ins)
    for dt in (torch.int32, torch.int16, torch.int8):
        ins[0] = t["dfa0.trans"].to(dt)
        assert torch.equal(tdfa.dfa_table(*ins), want), dt


def _k2_case(rng, shape, density, ranked):
    """A random mask and rank for K2: ``ranked`` True a permutation,
    False no rank, "pad" ``pad_rank``'s shape (a permutation of the first
    three quarters, ``r_pad - 1`` after; live rows violate rarely, so the
    repeated scores hold the threshold), "equal" four distinct ranks (a
    threshold bin past the tie region)."""
    r_pad = shape[-1]
    viol = rng.random(shape) < density
    if not ranked:
        return viol, None
    if ranked == "pad":
        live = r_pad * 3 // 4
        rank = np.full((r_pad,), r_pad - 1, np.int64)
        rank[:live] = rng.permutation(live)
        viol[..., :live] &= rng.random(shape[:-1] + (live,)) < 1e-4
    elif ranked == "equal":
        rank = rng.integers(0, 4, r_pad)
    else:
        rank = rng.permutation(r_pad)
    return viol, rank.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("c_pad,r_pad,k,density,ranked", [
    (128, 1 << 17, 20, 0.2, True),
    (128, 1 << 17, 20, 1e-4, True),
    (4, 8, 20, 0.5, True),                # r_pad < k: padded slots
    (16, 1000, 20, 0.01, False),          # no rank, unaligned rows
    (8, 64, 100, 0.9, True),
    (8, 4096, 300, 0.5, True),
    (16, 1000, 129, 0.3, False),
    (4, 512, 400, 0.3, True),             # under-filled: fewer than k
    (4, 16, 5, 0.0, True),
    (128, 1 << 17, 20, 0.2, "equal"),     # threshold bin past the ties
    (8, 20001, 300, 0.5, "equal"),
    (128, 1 << 17, 20, 0.5, "pad"),       # repeated r_pad - 1
    (16, 1 << 17, 300, 0.5, "pad"),
    (128, 1 << 17, 1, 0.3, True),
    (128, 1 << 17, 300, 0.3, True),
    (4, 1 << 17, 65536, 0.5, True),       # past one shared-memory sort
    (4, 1 << 17, 65536, 0.5, "equal"),
    (8, 20001, 20, 0.3, True),            # r_pad not a multiple of 16
    (8, 20001, 20, 0.7, True),            # dense: from the top region
    (16, 1 << 17, 20, 0.7, False),
    (8, 1 << 17, 20, 0.005, True),        # too sparse for the top region
])
def test_k2_matches_plain_on_card(card, c_pad, r_pad, k, density, ranked):
    rng = np.random.default_rng(c_pad + r_pad + k)
    viol, rank = _k2_case(rng, (c_pad, r_pad), density, ranked)
    viol = torch.from_numpy(viol).to(card)
    rank = torch.from_numpy(rank).to(card) if rank is not None else None
    _packed_equal(ttopk.topk_packed(viol, rank, k).cpu(),
                  ttopk.topk_packed_plain(viol, rank, k).cpu(), k)


@pytest.mark.cuda
def test_driver_on_card_matches_cpu(card, monkeypatch):
    """A small north star through TorchDriver() on the card and
    TorchDriver(device="cpu"): equal results, capped and uncapped, with
    K1 and K2 launched."""
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    # K1/K2 launches are the legacy sweep's: the paged route is off
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    resources = make_resources(600, random.Random(1))
    gpu, cpu = TorchDriver(), TorchDriver(device="cpu")
    clients = [setup_north_star(d, resources, random.Random(2), c_per_kind=4)
               for d in (gpu, cpu)]
    k1, k2 = ir_eval.eval_mask.launches, ttopk.topk_packed.launches
    for limit in (None, 20, 2, 300):
        a, b = ([(r.constraint["metadata"]["name"], r.msg,
                  r.resource["metadata"]["name"])
                 for r in c.audit(limit_per_constraint=limit).results()]
                for c in clients)
        assert a == b and a, limit
    assert ir_eval.eval_mask.launches - k1 >= 3
    assert ttopk.topk_packed.launches - k2 >= 6


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axis,dtype", [
    ((1 << 17,), 0, torch.bool),            # __alive__
    ((1 << 17,), 0, torch.int32),           # r: id column
    ((1 << 17,), 0, torch.int8),            # narrow-transferred column
    ((1 << 17,), 0, torch.float32),         # r: number column
    ((4096, 8), 0, torch.int16),            # e: [R, E]
    ((128, 1 << 17), 1, torch.bool),        # __match__ [C, R]
    ((5, 4096), 1, torch.bool),             # m [L, R]
    ((3, 4096, 4), 1, torch.bool),          # ek [K, R, E]
    ((1000, 128), 0, torch.uint8),          # __strbytes__ id axis
    ((64, 33), 1, torch.int64),             # 8-byte elements, odd rows
])
def test_k4_matches_plain_on_card(card, shape, axis, dtype):
    """K4 against index_copy_ on a clone: a new tensor with the dirty
    rows written (duplicate padding rows included), the old one as it
    was."""
    rng = np.random.default_rng(len(shape) * 1000 + shape[axis])
    n = shape[axis]
    for n_dirty in (1, 5, 300):
        n_dirty = min(n_dirty, n)
        dirty = np.sort(rng.choice(n, size=n_dirty, replace=False))
        rows = tex.pad_rows(dirty).astype(np.int32)
        vshape = shape[:axis] + (len(rows),) + shape[axis + 1:]
        if dtype == torch.bool:
            host, vals = rng.random(shape) < 0.5, rng.random(vshape) < 0.5
        else:
            host = rng.integers(-100, 100, size=shape)
            vals = rng.integers(-100, 100, size=vshape)
        dev = torch.from_numpy(np.asarray(host)).to(dtype).to(card)
        v = torch.from_numpy(np.asarray(vals)).to(dtype)
        # padding rows repeat the first row with its values
        pad = [slice(None)] * len(shape)
        pad[axis] = slice(n_dirty, None)
        first = [slice(None)] * len(shape)
        first[axis] = slice(0, 1)
        v[tuple(pad)] = v[tuple(first)]
        v = v.to(card)
        r = torch.from_numpy(rows).to(card)
        keep = dev.clone()
        launches = tscatter.scatter_rows.launches
        got = tscatter.scatter_rows(dev, r, v, axis)
        torch.cuda.synchronize()
        assert tscatter.scatter_rows.launches == launches + 1
        assert torch.equal(got, tscatter.scatter_rows_plain(dev, r, v, axis))
        assert torch.equal(dev, keep)


def _k4_on(card, rng, shape, axis, dtype, n_dirty, offset=0):
    """One K4 job ``(dev, rows, vals, axis)`` on the card, ``dev`` and
    ``vals`` each starting ``offset`` bytes into a larger buffer (so
    their addresses are only as aligned as ``offset``); the bucket's
    padding rows repeat the first row with its values."""
    n = shape[axis]
    dirty = np.sort(rng.choice(n, size=min(n_dirty, n), replace=False))
    rows = tex.pad_rows(dirty).astype(np.int32)
    vshape = shape[:axis] + (len(rows),) + shape[axis + 1:]

    def place(a):
        t = torch.from_numpy(np.asarray(a)).to(dtype)
        size = t.numel() * t.element_size()
        buf = torch.zeros(size + 32, dtype=torch.uint8, device=card)
        out = buf[offset: offset + size].view(dtype).view(t.shape)
        out.copy_(t.to(card))
        return out

    if dtype == torch.bool:
        host, vals = rng.random(shape) < 0.5, rng.random(vshape) < 0.5
    else:
        host = rng.integers(-100, 100, size=shape)
        vals = rng.integers(-100, 100, size=vshape)
    pad = [slice(None)] * len(shape)
    pad[axis] = slice(len(dirty), None)
    first = [slice(None)] * len(shape)
    first[axis] = slice(0, 1)
    vals[tuple(pad)] = vals[tuple(first)]
    return (place(host), torch.from_numpy(rows).to(card), place(vals),
            axis)


# (shape, axis, dtype, byte offset of dev and vals): odd inner widths,
# every word width the kernel picks, and addresses off 16-byte alignment
K4_MANY_CASES = [
    ((3, 999, 5), 1, torch.int16, 0),       # 10-byte segments: 2-byte words
    ((7, 33, 3), 1, torch.bool, 0),         # 3-byte segments: bytes
    ((101, 12), 0, torch.int32, 0),         # 48-byte segments: 16-byte words
    ((64, 33), 1, torch.int64, 0),          # one 8-byte element
    ((128, 4096), 1, torch.bool, 1),        # the mask along R, odd address
    ((4096, 16), 0, torch.uint8, 3),        # 16-byte rows at an odd address
    ((999, 8), 0, torch.int16, 2),          # 16-byte rows, 2-aligned
    ((3, 500, 4), 1, torch.float32, 4),     # 16-byte rows, 4-aligned
    ((1 << 15,), 0, torch.int8, 5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n_jobs,dirty", [
    (1, (1, 7, 300)), (9, (1, 7, 300)),
    (2 * 64 + 2, (1, 7, 300)),        # more jobs than one launch holds
    (9, (5, 3000, 300)),              # 4,096-row jobs: copy, then write
    (70, (2000, 1, 9)),
])
def test_k4_many_matches_plain_on_card(card, n_jobs, dirty):
    """The batched K4 entry against the single plain version job by job,
    bit for bit: odd inner widths, every word width, unaligned values
    and columns, more jobs than one launch's parameters hold, and jobs
    of more rows than a fused launch scans; one launch per 64 jobs (two
    where one of them has more than FUSED_ROWS rows) on both counters,
    the old columns as they were."""
    rng = np.random.default_rng(n_jobs + sum(dirty))
    jobs = []
    for k in range(n_jobs):
        shape, axis, dtype, offset = K4_MANY_CASES[k % len(K4_MANY_CASES)]
        jobs.append(_k4_on(card, rng, shape, axis, dtype, dirty[k % 3],
                           offset))
    keep = [j[0].clone() for j in jobs]
    single, many = tscatter.scatter_rows.launches, \
        tscatter.scatter_rows_many.launches
    got = tscatter.scatter_rows_many(jobs)
    torch.cuda.synchronize()
    launches = sum(
        1 if max(j[1].numel() for j in jobs[k: k + tscatter.MAX_JOBS])
        <= tscatter.FUSED_ROWS else 2
        for k in range(0, n_jobs, tscatter.MAX_JOBS))
    assert tscatter.scatter_rows.launches == single + launches
    assert tscatter.scatter_rows_many.launches == many + launches
    for k, (out, job, before) in enumerate(zip(got, jobs, keep)):
        assert out.dtype == job[0].dtype and out.shape == job[0].shape
        assert torch.equal(out, tscatter.scatter_rows_plain(*job)), k
        assert torch.equal(job[0], before), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_MANY_CASES,
                         ids=[f"{c[0]}-ax{c[1]}-off{c[3]}"
                              for c in K4_MANY_CASES])
def test_k4_single_at_unaligned_addresses_on_card(card, case):
    """The single K4 entry at the same layouts and addresses, with 9
    rows (one fused launch) and with 3,000 (4,096 with the padding: a
    copy launch, then a write launch)."""
    shape, axis, dtype, offset = case
    rng = np.random.default_rng(offset)
    for n_dirty, n_launches in ((9, 1), (3000, 2)):
        job = _k4_on(card, rng, shape, axis, dtype, n_dirty, offset)
        launches = tscatter.scatter_rows.launches
        got = tscatter.scatter_rows(*job)
        torch.cuda.synchronize()
        want = n_launches if job[1].numel() > tscatter.FUSED_ROWS else 1
        assert tscatter.scatter_rows.launches == launches + want
        assert torch.equal(got, tscatter.scatter_rows_plain(*job))


@pytest.mark.cuda
@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, {"c_pad": 128, "r_pad": 4096, "e_pad": 8}),
    (2, {"c_pad": 16, "r_pad": 256, "e_pad": 2}),
])
def test_k5_matches_plain_on_card(card, seed, kw):
    """K5 (K1's kernel in row-index mode) against the plain gather /
    evaluate / index_copy_, on every-op programs at random rows, with
    int32 and narrowed id columns; and one full launch after it is
    still K1's result."""
    prog, arrays = every_op_case(seed, **kw)
    t = convert.arrays_to_device(arrays, card)
    c_pad, r_pad = t["__match__"].shape
    rng = np.random.default_rng(seed)
    for dt in (None, torch.int8, torch.int16):
        x = t if dt is None else {
            k: (v.to(dt) if v.dtype == torch.int32
                and not k.endswith(".trans") else v)
            for k, v in t.items()}
        d = tex._with_dfa_tables(prog, x, tdfa.dfa_table)
        viol_old = torch.from_numpy(rng.random((c_pad, r_pad)) < 0.5) \
            .to(card)
        for n_dirty in (1, 7, min(r_pad, 40)):
            dirty = np.sort(rng.choice(r_pad, size=n_dirty, replace=False))
            rows = torch.from_numpy(
                tex.pad_rows(dirty).astype(np.int32)).to(card)
            launches = ir_eval.delta_mask.launches
            got = ir_eval.delta_mask(prog, d, viol_old, rows)
            torch.cuda.synchronize()
            assert ir_eval.delta_mask.launches == launches + 1
            assert torch.equal(got, tex._delta_mask(prog, x, viol_old,
                                                    rows)), (dt, n_dirty)
        assert torch.equal(ir_eval.eval_mask(prog, d),
                           tex._eval_mask(prog, x)), dt


@pytest.mark.cuda
def test_executor_delta_on_card_matches_cpu(card):
    """The executor's churn path on the card (K4 scatters, K5 delta,
    K2 reduce) against the same generations on the CPU."""
    prog, arrays = every_op_case(6, c_pad=16, r_pad=1024)
    b = convert.bindings_from_plain(arrays, 14, 1000, 16, 1024)
    gpu, cpu = tex.ProgramExecutor(), tex.ProgramExecutor(device="cpu")
    gpu.run_topk(prog, b, 20)
    cpu.run_topk(prog, b, 20)
    k4, k5 = tscatter.scatter_rows.launches, ir_eval.delta_mask.launches
    rng_g, rng_c = np.random.default_rng(2), np.random.default_rng(2)
    bg = bc = b
    for n_dirty in (3, 60):
        bg, got = _delta_round(gpu, prog, bg, rng_g, n_dirty)
        bc, want = _delta_round(cpu, prog, bc, rng_c, n_dirty)
        _packed_equal(_packed(got), _packed(want), 20)
        np.testing.assert_array_equal(gpu.run(prog, bg), cpu.run(prog, bc))
    assert tscatter.scatter_rows.launches > k4
    assert ir_eval.delta_mask.launches == k5 + 2


# -- the fleet audit's batched kernels (item B9), on a CUDA card


@pytest.mark.cuda
@pytest.mark.parametrize("n,kw", [
    (1, {}),
    (2, {"c_pad": 16, "r_pad": 256}),
    (3, {"c_pad": 128, "r_pad": 2048, "t_pad": 512, "u": 16}),
    (5, {"c_pad": 8, "r_pad": 64, "n_states": 40}),
])
def test_batched_k1_k3_match_plain_on_card(card, n, kw):
    """Batched K3 then batched K1 on N every-op cases of ragged sizes,
    stacked as the fleet stacks them, against the per-cluster plain
    versions on the stacked slices."""
    prog, stacked = stacked_every_op_case(n, **kw)
    d = convert.arrays_to_device(stacked, card)
    ins = (d["dfa0.trans"], d["dfa0.accept"], d["__strbytes__"],
           d["__strdfaok__"], d["dfa0.xv"], 3)
    tab = tdfa.dfa_table_batched(*ins)
    assert torch.equal(tab, tdfa.dfa_table_batched_plain(*ins))
    dd = dict(d, **{"dfa0.devtab": tab})
    assert torch.equal(ir_eval.eval_mask_batched(prog, dd),
                       tex._eval_mask_batched(prog, dd))


@pytest.mark.cuda
@pytest.mark.parametrize("n,c_pad,r_pad,k,density", [
    (1, 128, 1 << 15, 20, 0.2),
    (4, 128, 1 << 15, 20, 1e-3),
    (3, 8, 64, 2, 0.5),
    (5, 4, 16, 20, 0.3),                  # r_pad < k
    (2, 16, 4096, 300, 0.5),
    (4, 128, 1 << 17, 20, 0.3),           # the fleet's shape
    (4, 128, 1 << 17, 300, 0.3),
    (3, 16, 20001, 1, 0.5),               # r_pad not a multiple of 16
])
def test_batched_k2_matches_plain_on_card(card, n, c_pad, r_pad, k,
                                          density):
    rng = np.random.default_rng(n + c_pad + r_pad + k)
    viol = torch.from_numpy(rng.random((n, c_pad, r_pad)) < density) \
        .to(card)
    rank = torch.from_numpy(np.stack([rng.permutation(r_pad)
                                      for _ in range(n)]).astype(np.int32)) \
        .to(card)
    got = ttopk.topk_packed_batched(viol, rank, k).cpu()
    want = ttopk.topk_packed_batched_plain(viol, rank, k).cpu()
    for i in range(n):
        _packed_equal(got[i], want[i], k)


# -- K6, the devpages delta (item B6)


def _k6_case(c_pad, r_pad, density, pt_kind, seed):
    """(new, pt, old) with ``old`` the gathered ``new`` flipped at random
    bits (``density`` of them), so the delta stream is sparse as under
    churn; ``pt`` identity, a permutation, or a permutation with entries
    outside [0, r_pad) (negatives count from the end, the rest read
    True, as jnp.take reads them)."""
    rng = np.random.default_rng(seed)
    new = torch.from_numpy(rng.random((c_pad, r_pad)) < 0.4)
    pt = np.arange(r_pad, dtype=np.int32)
    if pt_kind != "identity":
        pt = rng.permutation(r_pad).astype(np.int32)
    if pt_kind == "out_of_range":
        n_bad = min(r_pad, 6)
        pt[rng.choice(r_pad, n_bad, replace=False)] = \
            [-1, r_pad, -r_pad - 1, 2 * r_pad, -r_pad, r_pad + 3][:n_bad]
    pt = torch.from_numpy(pt)
    g = devdelta.mask_delta_plain(new, pt, torch.zeros_like(new), 1)[0]
    old = g ^ torch.from_numpy(rng.random((c_pad, r_pad)) < density)
    return new, pt, old


def test_k6_plain_fill_and_overflow():
    """The plain version's contract on the CPU: ascending flat indices,
    -1 past the count with the first element's sign, the true count
    when it exceeds k, and row_any of the gathered mask."""
    new, pt, old = _k6_case(3, 50, 0.1, "permuted", 0)
    calls = devdelta.mask_delta.plain_calls
    g, idx, signs, count, row_any = devdelta.mask_delta(new, pt, old, 400)
    assert devdelta.mask_delta.plain_calls == calls + 1
    diff = torch.nonzero((g ^ old).reshape(-1)).reshape(-1)
    n = int(count)
    assert n == diff.numel() > 0
    assert torch.equal(idx[:n].long(), diff)
    assert (idx[n:] == -1).all() and (signs[n:] == g[0, 0]).all()
    assert torch.equal(signs[:n], g.reshape(-1)[diff])
    assert torch.equal(row_any, g.any(0))
    assert torch.equal(g, new[:, pt.long()])
    g2, idx2, _s, count2, _r = devdelta.mask_delta(new, pt, old, 5)
    assert int(count2) == n and torch.equal(idx2, idx[:5])


@pytest.mark.cuda
@pytest.mark.parametrize("c_pad,r_pad,density,pt_kind,k", [
    (4, 1 << 17, 1e-3, "identity", 256),       # count > k: overflow
    (4, 1 << 17, 1e-4, "identity", 256),       # the devpages shape
    (128, 1 << 17, 1e-4, "permuted", 4096),    # the main phase's shape
    (128, 1 << 17, 0.0, "identity", 256),      # no change at all
    (5, 1000, 0.05, "out_of_range", 64),       # ragged tail tile
    (3, 4097, 0.5, "permuted", 20000),         # k past the flat size
    (1, 1, 1.0, "identity", 1),
    (2, 4096, 1.0, "identity", 8192),          # every bit flips, k == n
    (256, 1 << 17, 1e-4, "identity", 4096),    # 8,192 tiles to look back on
    (8, 4096, 0.0, "identity", 1),             # count 0, k 1
    (4, 1 << 17, 1e-3, "permuted", 1),         # k 1, overflowing
    (4, 8192, 0.01, "identity", 4 * 8192),     # k == c_pad * r_pad
    (4, 8192, 0.01, "identity", 4 * 8192 + 5000),   # k past it
    (2, 70000, 0.01, "out_of_range", 512),     # ragged r_pad, big tiles
])
def test_k6_matches_plain_on_card(card, c_pad, r_pad, density, pt_kind, k):
    """K6 against its plain version, all five outputs bit for bit, its
    inputs untouched."""
    new, pt, old = (t.to(card) for t in _k6_case(c_pad, r_pad, density,
                                                 pt_kind, c_pad + r_pad))
    keep = (new.clone(), pt.clone(), old.clone())
    launches = devdelta.mask_delta.launches
    got = devdelta.mask_delta(new, pt, old, k)
    torch.cuda.synchronize()
    assert devdelta.mask_delta.launches == launches + 1
    want = devdelta.mask_delta_plain(new, pt, old, k)
    for name, a, b in zip(("new_g", "idx", "signs", "count", "row_any"),
                          got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for a, b in zip((new, pt, old), keep):
        assert torch.equal(a, b)


# -- K7, the inventory join


def _k7_case(n, n_vals, seed, missing=0.2, sel_p=0.6, n_names=None):
    """int32 src / inv / names and bool sel of ``n`` rows: values from
    ``n_vals`` ids (so they repeat), names from ``n_names`` (few names:
    equal (value, name) pairs), ``missing`` of each id column -1."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vals, n).astype(np.int32)
    inv = rng.integers(0, n_vals, n).astype(np.int32)
    names = rng.integers(0, n_names or 4 * n + 8, n).astype(np.int32)
    for a in (src, inv, names):
        a[rng.random(n) < missing] = -1
    sel = rng.random(n) < sel_p
    return tuple(torch.from_numpy(a) for a in (src, inv, sel, names))


def _k7_direct(src, inv, sel, names, exclude):
    """The join by its definition, pair by pair: row r violates iff some
    selected inventory row j has inv[j] == src[r] >= 0 and, with the
    exclusion, names[r] < 0 or names[j] != names[r]."""
    out = []
    for s, nm in zip(src.tolist(), names.tolist()):
        out.append(s >= 0 and any(
            sj and v == s and (not exclude or nm < 0 or nj != nm)
            for sj, v, nj in zip(sel.tolist(), inv.tolist(),
                                 names.tolist())))
    return torch.tensor(out, dtype=torch.bool)


@pytest.mark.parametrize("exclude", [True, False])
@pytest.mark.parametrize("n,n_vals,n_names,sel_p", [
    (1, 2, None, 1.0), (9, 3, 3, 0.6), (64, 8, 4, 0.6), (200, 40, None, 0.7),
    (50, 5, 5, 0.0)])
def test_k7_plain_is_the_join_by_definition(n, n_vals, n_names, sel_p,
                                            exclude):
    """The plain version's per-value form (count, least and greatest
    name per value) equals the pair-by-pair definition on the CPU, and
    the CPU wrapper counts a plain call, never a launch."""
    ins = _k7_case(n, n_vals, n * 13 + n_vals, n_names=n_names,
                   sel_p=sel_p)
    calls, launches = (invjoin.inv_join_mask.plain_calls,
                       invjoin.inv_join_mask.launches)
    got = invjoin.inv_join_mask(*ins, exclude, n_vals,
                                invjoin.error_flag("cpu"))
    assert invjoin.inv_join_mask.plain_calls == calls + 1
    assert invjoin.inv_join_mask.launches == launches
    assert torch.equal(got, _k7_direct(*ins, exclude))
    assert torch.equal(invjoin.inv_join_mask_plain(*ins, exclude, n_vals),
                       got)


@pytest.mark.cuda
@pytest.mark.parametrize("exclude", [True, False])
@pytest.mark.parametrize("n,n_vals,n_names,missing,sel_p", [
    (1, 1, None, 0.0, 1.0),
    (7, 3, 2, 0.2, 0.6),
    (1 << 17, 20_000, None, 0.05, 0.02),    # the devpages ingress shape
    (1 << 17, 50, 30, 0.3, 0.9),            # heavy atomic contention
    (4099, 100, None, 0.5, 0.0),            # sel all False
    (1 << 20, 300_000, None, 0.1, 0.5),
])
def test_k7_matches_plain_on_card(card, n, n_vals, n_names, missing, sel_p,
                                  exclude):
    """K7 against its plain version bit for bit, its inputs untouched,
    one launch."""
    ins = tuple(t.to(card) for t in _k7_case(n, n_vals, n + n_vals,
                                             missing, sel_p, n_names))
    keep = tuple(t.clone() for t in ins)
    launches = invjoin.inv_join_mask.launches
    err = invjoin.error_flag(card)
    got = invjoin.inv_join_mask(*ins, exclude, n_vals, err)
    invjoin.check_error(err, n_vals)
    assert invjoin.inv_join_mask.launches == launches + 1
    want = invjoin.inv_join_mask_plain(*ins, exclude, n_vals)
    assert got.dtype == want.dtype == torch.bool
    assert torch.equal(got, want)
    for a, b in zip(ins, keep):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k7_out_of_range_id_raises_on_card(card):
    """A value id at or past n_ids never indexes the kernel's tables: the
    launch sets the caller's flag and check_error raises, and a smaller
    n_ids than the interner's is caught the same way; an id on an
    unselected inventory row is never read."""
    src, inv, sel, names = (t.to(card) for t in _k7_case(4096, 64, 5))

    def join(s, i, exclude, n_ids):
        err = invjoin.error_flag(card)
        out = invjoin.inv_join_mask(s, i, sel, names, exclude, n_ids, err)
        invjoin.check_error(err, n_ids)
        return out

    join(src, inv, True, 64)
    bad = src.clone()
    bad[17] = 64
    with pytest.raises(IndexError, match="outside"):
        join(bad, inv, True, 64)
    bad = inv.clone()
    bad[sel.nonzero()[0, 0]] = 1 << 30
    with pytest.raises(IndexError, match="outside"):
        join(src, bad, False, 64)
    with pytest.raises(IndexError, match="outside"):
        join(src, inv, True, 10)
    bad = inv.clone()
    bad[(~sel).nonzero()[0, 0]] = 1 << 30
    got = join(src, bad, True, 64)
    assert torch.equal(got, invjoin.inv_join_mask_plain(src, inv, sel,
                                                        names, True, 64))


@pytest.mark.cuda
def test_k7_follows_the_interner_growth_on_card(card):
    """A call with more ids (new hosts interned between sweeps) and
    values past the earlier calls' size is exact, and so are the calls
    after it with fewer ids and other inputs."""
    small = tuple(t.to(card) for t in _k7_case(5000, 100, 1))
    big = tuple(t.to(card) for t in _k7_case(5000, 90_000, 2))
    other = tuple(t.to(card) for t in _k7_case(5000, 100, 3))
    for ins, n_ids in ((small, 100), (big, 90_000), (small, 100),
                       (other, 100), (small, 100), (big, 90_000)):
        err = invjoin.error_flag(card)
        got = invjoin.inv_join_mask(*ins, True, n_ids, err)
        invjoin.check_error(err, n_ids)
        assert torch.equal(got,
                           invjoin.inv_join_mask_plain(*ins, True, n_ids))


@pytest.mark.cuda
def test_invjoin_devpages_on_card_matches_cpu(card, monkeypatch):
    """K8sUniqueIngressHost under devpages through TorchDriver() on the
    card and TorchDriver(device="cpu"): equal results and ledger events
    over a cold sweep and churn that clears and re-appears duplicates
    on rows that never churned, one K7 launch per delta evaluation."""
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.library import all_docs
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.setenv("GATEKEEPER_PAGES", "on")
    monkeypatch.setenv("GATEKEEPER_DEVPAGES", "on")
    monkeypatch.setenv("GATEKEEPER_PAGE_ROWS", "16")

    def ingress(name, host):
        return {"apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
                "metadata": {"name": name, "namespace": "default"},
                "spec": {"host": host}}

    gpu, cpu = TorchDriver(), TorchDriver(device="cpu")
    clients = []
    for d in (gpu, cpu):
        c = Backend(d).new_client([K8sValidationTarget()])
        for tdoc, cdoc in all_docs():
            if tdoc["spec"]["crd"]["spec"]["names"]["kind"] == \
                    "K8sUniqueIngressHost":
                c.add_template(tdoc)
                c.add_constraint(cdoc)
        c.add_data_batch(make_resources(200, random.Random(1))
                         + [ingress(f"ing{i}", f"h{i % 7}.example.com")
                            for i in range(20)])
        clients.append(c)
    steps = [[], [("remove", ingress("ing0", "h0.example.com"))],
             [("add", ingress("ing-new", "h6.example.com"))]]
    for step in steps:
        for c in clients:
            for op, o in step:
                (c.add_data if op == "add" else c.remove_data)(dict(o))
        launches = invjoin.inv_join_mask.launches
        a, b = ([(r.constraint["metadata"]["name"], r.msg,
                  r.resource["metadata"]["name"])
                 for r in c.audit().results()] for c in clients)
        assert a == b and a
        dv = gpu.last_sweep_phases["devpages"]
        assert dv["inv_joins_device"] == 1 and dv["kinds_device"] == 1
        assert invjoin.inv_join_mask.launches - launches == \
            1 + dv["delta_overflows"]
    ga, ca = (d._state("admission.k8s.gatekeeper.sh").ledger.export()
              for d in (gpu, cpu))
    assert ga == ca


# -- K8, the residency planner's page gather and page scatter


def test_k8_plain_gathers_and_scatters_by_definition():
    """K8's plain versions against a loop over the pages: an empty slot
    gathers row 0 and scatters nothing, the tail page repeats the last
    row, and the scatter leaves every other row zero."""
    rng = np.random.default_rng(3)
    mask = torch.from_numpy(rng.random((3, 50)) < 0.5)
    slot_pages = torch.tensor([2, -1, 6, 0], dtype=torch.int32)
    cold = torch.tensor([1, 3, 4, 5], dtype=torch.int32)
    buf, staging = residency.page_gather(mask, slot_pages, cold, 8)
    assert buf.shape == (3, 32) and staging.shape == (3, 32)

    def rows(p):
        return [0] * 8 if p < 0 else [min(p * 8 + j, 49) for j in range(8)]

    assert torch.equal(buf, mask[:, sum((rows(p) for p in [2, -1, 6, 0]),
                                        [])])
    assert torch.equal(staging, mask[:, sum((rows(p) for p in [1, 3, 4, 5]),
                                            [])])
    full = residency.page_scatter(buf, slot_pages, 50, 8)
    want = torch.zeros_like(mask)
    for p in (2, 6, 0):
        want[:, rows(p)] = mask[:, rows(p)]
    assert torch.equal(full, want)
    none = residency.page_scatter(buf, torch.full((4,), -1,
                                                  dtype=torch.int32), 50, 8)
    assert not none.any()


def _k8_case(c_pad, r_pad, page_rows, n_empty, tail, seed):
    """(mask, slot_pages, cold_pages): half the pages in slots (``tail``
    "hot" puts the ragged last page in slot 0, "cold" among the cold
    pages), ``n_empty`` of the other slots emptied (-1)."""
    rng = np.random.default_rng(seed)
    mask = torch.from_numpy(rng.random((c_pad, r_pad)) < 0.3)
    n_pages = -(-r_pad // page_rows)
    n_slots = n_pages // 2
    pages = [int(p) for p in rng.permutation(n_pages - 1)]
    pages = [n_pages - 1] + pages if tail == "hot" \
        else pages[:n_slots] + [n_pages - 1] + pages[n_slots:]
    slot = np.array(pages[:n_slots], dtype=np.int32)
    slot[1 + rng.choice(n_slots - 1, n_empty, replace=False)] = -1
    cold = np.sort(np.array(pages[n_slots:], dtype=np.int32))
    return mask, torch.from_numpy(slot), torch.from_numpy(cold)


@pytest.mark.cuda
@pytest.mark.parametrize("c_pad,r_pad,page_rows,n_empty,tail", [
    (4, 1 << 17, 32, 0, "hot"),       # the devpages budget geometry
    (4, 1 << 17, 32, 7, "cold"),
    (1, 1000, 16, 3, "hot"),          # ragged tail page (rows 992-999)
    (1, 1000, 16, 3, "cold"),
    (128, 4100, 48, 1, "hot"),        # 48-row pages, ragged tail
    (128, 1 << 17, 32, 0, "cold"),
    (4, 64, 1, 5, "hot"),             # one-row pages
    (3, 1000, 24, 2, "hot"),          # 24-row pages: 8-byte words
    (2, 1001, 16, 1, "cold"),         # odd R: byte words
    (5, 4096, 16, 3, "cold"),         # 16-byte words, no tail
])
def test_k8_matches_plain_on_card(card, c_pad, r_pad, page_rows, n_empty,
                                  tail):
    """K8's gather and scatter against their plain versions, bit for bit
    (bool outputs, an empty slot's row-0 bits included), inputs
    untouched."""
    mask, slot, cold = (t.to(card) for t in _k8_case(
        c_pad, r_pad, page_rows, n_empty, tail, c_pad + r_pad))
    keep = (mask.clone(), slot.clone(), cold.clone())
    gathers = residency.page_gather.launches
    scatters = residency.page_scatter.launches
    buf, staging = residency.page_gather(mask, slot, cold, page_rows)
    full = residency.page_scatter(buf, slot, r_pad, page_rows)
    torch.cuda.synchronize()
    assert residency.page_gather.launches == gathers + 1
    assert residency.page_scatter.launches == scatters + 1
    want_buf, want_staging = residency.page_gather_plain(mask, slot, cold,
                                                         page_rows)
    for got, want in ((buf, want_buf), (staging, want_staging),
                      (full, residency.page_scatter_plain(
                          want_buf, slot, r_pad, page_rows))):
        assert got.dtype == want.dtype == torch.bool
        assert torch.equal(got, want)
    for a, b in zip((mask, slot, cold), keep):
        assert torch.equal(a, b)
    # no cold pages at all: an empty staging buffer
    buf2, staging2 = residency.page_gather(
        mask, slot, cold[:0], page_rows)
    assert staging2.shape == (c_pad, 0) and torch.equal(buf2, want_buf)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 8])
def test_k8_at_unaligned_addresses_on_card(card, offset):
    """K8 with the mask and the slot buffer starting ``offset`` bytes
    into larger buffers (the word narrows to what the addresses allow),
    bit for bit against the plain versions."""
    c_pad, r_pad, page_rows = 4, 4096, 32
    mask, slot, cold = (t.to(card) for t in _k8_case(
        c_pad, r_pad, page_rows, 3, "cold", offset))

    def shifted(t):
        buf = torch.zeros(t.numel() + 32, dtype=torch.bool, device=card)
        out = buf[offset: offset + t.numel()].view(t.shape)
        out.copy_(t)
        return out

    mask = shifted(mask)
    buf, staging = residency.page_gather(mask, slot, cold, page_rows)
    want_buf, want_staging = residency.page_gather_plain(mask, slot, cold,
                                                         page_rows)
    assert torch.equal(buf, want_buf) and torch.equal(staging, want_staging)
    buf = shifted(buf)
    full = residency.page_scatter(buf, slot, r_pad, page_rows)
    torch.cuda.synchronize()
    assert torch.equal(full, residency.page_scatter_plain(buf, slot, r_pad,
                                                          page_rows))
