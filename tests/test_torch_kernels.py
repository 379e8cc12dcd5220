"""The port's kernel wrappers and executor plans, without the reference.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a CUDA card and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

On the CPU the wrappers take their plain versions; the ``cuda``-marked
tests hold K1, K2 and K3 against those plain versions on the card, bit
for bit, and skip where there is no card.
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
from gatekeeper_tpu_torch.kernels import dfa as tdfa
from gatekeeper_tpu_torch.kernels import ir_eval, topk as ttopk
from gatekeeper_tpu_torch.kernels.op_cases import every_op_case
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


@pytest.mark.cuda
@pytest.mark.parametrize("c_pad,r_pad,k,density,ranked", [
    (128, 1 << 17, 20, 0.2, True),
    (128, 1 << 17, 20, 1e-4, True),
    (4, 8, 20, 0.5, True),                # r_pad < k: padded slots
    (16, 1000, 20, 0.01, False),          # no rank, unaligned rows
    (8, 64, 100, 0.9, True),
    (8, 4096, 300, 0.5, True),            # k past one pass: three passes
    (16, 1000, 129, 0.3, False),          # one slot into the second pass
    (4, 512, 400, 0.3, True),             # under-filled in the second pass
    (4, 16, 5, 0.0, True),
])
def test_k2_matches_plain_on_card(card, c_pad, r_pad, k, density, ranked):
    rng = np.random.default_rng(c_pad + r_pad + k)
    viol = torch.from_numpy(rng.random((c_pad, r_pad)) < density).to(card)
    rank = torch.from_numpy(rng.permutation(r_pad).astype(np.int32)) \
        .to(card) if ranked else None
    _packed_equal(ttopk.topk_packed(viol, rank, k).cpu(),
                  ttopk.topk_packed_plain(viol, rank, k).cpu(), k)


@pytest.mark.cuda
def test_driver_on_card_matches_cpu(card, monkeypatch):
    """A small north star through TorchDriver() on the card and
    TorchDriver(device="cpu"): equal results, capped and uncapped, with
    K1 and K2 launched."""
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
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
