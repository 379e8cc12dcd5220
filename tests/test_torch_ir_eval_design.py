"""The generated IR evaluator's design: its source, split and tile plan.

K1, K1b and K5 are one generated Triton kernel (``kernels/ir_eval.py``)
in three modes.  On the CPU, without Triton or a card, this file holds
the emitted source of the every-op programs, the three north-star
programs and every library template's program:

  * it parses in full mode and in delta mode (the ``DELTA`` constexpr
    branch resolved either way);
  * the row prologue holds no node whose value carries the constraint
    axis and uses no name of the constraint body, the body holds every
    node that does, and each reachable node is emitted exactly once;
  * full mode never reads ``rows``;

and the tile plan at the path's shapes: powers of two that divide the
padded axes, at least two programs per SM wherever the axes allow it.

The ``cuda``-marked tests hold K1, K1b and K5 bit for bit against their
plain versions at the tile edges on a card.  This file imports neither
jax nor the JAX package, so those run on the card's machine with

    python -m pytest --noconftest -m cuda tests/test_torch_ir_eval_design.py
"""

import ast
import contextlib
import os
import random

import numpy as np
import pytest
import torch

from gatekeeper_tpu_torch import convert
from gatekeeper_tpu_torch.client.client import Backend
from gatekeeper_tpu_torch.client.interface import QueryOpts
from gatekeeper_tpu_torch.engine import executor as tex
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.kernels import dfa as tdfa
from gatekeeper_tpu_torch.kernels import ir_eval
from gatekeeper_tpu_torch.kernels.op_cases import (every_op_case,
                                                   ordering_case,
                                                   stacked_every_op_case)
from gatekeeper_tpu_torch.library import all_docs, make_mixed
from gatekeeper_tpu_torch.library.north_star import (make_resources,
                                                     setup_north_star)
from gatekeeper_tpu_torch.library.templates import LIBRARY
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget

TARGET = "admission.k8s.gatekeeper.sh"
LOOP = "for c0 in range(0, CPS, BC):"

EVERY_OP = [(0, {}), (1, {"c_pad": 128, "r_pad": 4096, "e_pad": 8}),
            (2, {"c_pad": 4, "r_pad": 8, "e_pad": 1}),
            (3, {"c_pad": 16, "r_pad": 256, "e_pad": 16, "l_keys": 40})]


def _programs_of(drv):
    """(kind, program, arrays with every regex verdict table) of each
    kind the driver swept on the device path."""
    st = drv._state(TARGET)
    out = []
    for kind in sorted(st.bindings_cache):
        prog = st.templates[kind].vectorized.program
        arrays = drv.executor._arrays(st.bindings_cache[kind][1], None)
        out.append((kind, prog, tex._with_dfa_tables(
            prog, arrays, tdfa.dfa_table_plain)))
    return out


@contextlib.contextmanager
def _device_sweeps():
    """Every kind on the device path: no small-workload routing, and the
    legacy sweep (the paged route serves kinds from the ledger)."""
    saved = torch_driver.SMALL_WORKLOAD_EVALS, os.environ.get(
        "GATEKEEPER_PAGES")
    torch_driver.SMALL_WORKLOAD_EVALS = 0
    os.environ["GATEKEEPER_PAGES"] = "off"
    try:
        yield
    finally:
        torch_driver.SMALL_WORKLOAD_EVALS = saved[0]
        if saved[1] is None:
            os.environ.pop("GATEKEEPER_PAGES", None)
        else:
            os.environ["GATEKEEPER_PAGES"] = saved[1]


@pytest.fixture(scope="module")
def north_star_programs():
    with _device_sweeps():
        drv = TorchDriver(device="cpu")
        setup_north_star(drv, make_resources(200, random.Random(1)),
                         random.Random(2))
        drv.query_audit(TARGET, QueryOpts(limit_per_constraint=20))
        return _programs_of(drv)


@pytest.fixture(scope="module")
def library_programs():
    with _device_sweeps():
        drv = TorchDriver(device="cpu")
        client = Backend(drv).new_client([K8sValidationTarget()])
        for tdoc, cdoc in all_docs():
            client.add_template(tdoc)
            client.add_constraint(cdoc)
        client.add_data_batch(make_mixed(random.Random(0), 300))
        drv.query_audit(TARGET, QueryOpts(limit_per_constraint=20))
        return {kind: (prog, arrays)
                for kind, prog, arrays in _programs_of(drv)}


def _kernel_def(src: str) -> ast.FunctionDef:
    (fn,) = [n for n in ast.parse(src).body
             if isinstance(n, ast.FunctionDef) and n.name == "ir_kernel"]
    return fn


def _resolve_mode(src: str, delta: bool) -> ast.FunctionDef:
    """The kernel with its ``if DELTA:`` branch resolved, re-parsed."""
    fn = _kernel_def(src)
    body = []
    for stmt in fn.body:
        if isinstance(stmt, ast.If) and isinstance(stmt.test, ast.Name) \
                and stmt.test.id == "DELTA":
            body.extend(stmt.body if delta else stmt.orelse)
        else:
            body.append(stmt)
    fn.body = body
    return _kernel_def(ast.unparse(ast.Module(body=[fn], type_ignores=[])))


def _names(nodes) -> set:
    return {n.id for stmt in nodes for n in ast.walk(stmt)
            if isinstance(n, ast.Name)}


def _reachable(program) -> set:
    todo = [ci for rule in program.rules for ci in rule.conjuncts]
    seen = set()
    while todo:
        i = todo.pop()
        if i not in seen:
            seen.add(i)
            todo.extend(program.nodes[i].args)
    return seen


def _check_design(program, arrays, lead: int = 0) -> str:
    """Every property of the emitted source this file holds; returns
    the source."""
    src, em = ir_eval.emit_source(program, ir_eval.array_signature(
        arrays, lead))
    full, delta = _resolve_mode(src, False), _resolve_mode(src, True)
    # full mode never reads rows; delta mode does
    assert "rows" not in _names(full.body)
    assert "rows" in _names(delta.body)
    # the prologue is everything before the constraint loop
    (loop,) = [s for s in full.body if isinstance(s, ast.For)
               and isinstance(s.target, ast.Name) and s.target.id == "c0"]
    prologue = full.body[:full.body.index(loop)]
    body_defs = {t.id for stmt in loop.body for n in ast.walk(stmt)
                 if isinstance(n, (ast.Assign, ast.AugAssign))
                 for t in ([n.target] if isinstance(n, ast.AugAssign)
                           else n.targets) if isinstance(t, ast.Name)}
    assert not _names(prologue) & (body_defs | {"oc", "c3", "c2", "c0"})
    # node markers: each reachable node once, where its axes put it
    text = src.splitlines()
    at = next(i for i, line in enumerate(text) if line.strip() == LOOP)
    placed = {}
    for i, line in enumerate(text):
        s = line.strip()
        if s.startswith("# n") and s[3:].split(" ")[0].isdigit():
            node = int(s[3:].split(" ")[0])
            assert node not in placed, f"node {node} emitted twice"
            placed[node] = i > at
    has_c = ["c" in a for a in ir_eval.node_axes(program)]
    assert set(placed) == _reachable(program)
    for node, in_body in placed.items():
        assert in_body == has_c[node], (node, program.nodes[node])
    assert em.ptrs and "@triton.jit" in src
    return src


@pytest.mark.parametrize("seed,kw", EVERY_OP)
def test_every_op_source_design(seed, kw):
    prog, arrays = every_op_case(seed, **kw)
    arrays["dfa0.devtab"] = arrays["dfa0.xv"]
    _check_design(prog, arrays)


def test_ordering_compares_take_the_extremum():
    """Each rule of the ordering case has one per-(c, r, e) term, an
    ordering compare of a row value with a constraint value: the source
    takes the max (> and >=) or min (< and <=) over the element axis in
    the prologue, with a NaN guard for floats, and compares per (c, r)
    in the body."""
    prog, arrays = ordering_case(0)
    src = _check_design(prog, arrays)
    pro = src[:src.index(LOOP)]
    assert pro.count("tl.max(tl.where(") == 13
    assert pro.count("tl.min(tl.where(") == 12
    assert "to(tl.float32, bitcast=True)" in pro
    # the plain evaluator fires each rule somewhere, not everywhere
    dev = convert.arrays_to_device(arrays, "cpu")
    for rule in prog.rules:
        one = type(prog)(prog.nodes, (rule,))
        fired = tex._eval_mask(one, dev)
        assert 0 < int(fired.sum()) < fired.numel(), rule


def test_every_op_batched_source_is_the_unbatched_one():
    """Batched and unbatched launches of one mode share the source."""
    prog, stacked = stacked_every_op_case(3)
    stacked["dfa0.devtab"] = np.zeros(stacked["dfa0.xv"].shape, dtype=bool)
    one = {nm: a[0] for nm, a in stacked.items()}
    assert _check_design(prog, stacked, lead=1) == \
        ir_eval.emit_source(prog, ir_eval.array_signature(one))[0]


def test_north_star_source_design(north_star_programs):
    kinds = [k for k, _, _ in north_star_programs]
    assert kinds == ["K8sAllowedRepos", "K8sContainerLimits",
                     "K8sRequiredLabels"]
    for kind, prog, arrays in north_star_programs:
        src = _check_design(prog, arrays)
        # the row-only work runs once per row tile: the element id
        # loads, table and .vmap gathers are in the prologue
        pro = src[:src.index(LOOP)]
        body = src[src.index(LOOP):]
        for nm in arrays:
            if nm.startswith(("e:val:", "t0.", "t2.", "pt0.vmap", "m1")) \
                    and nm in ir_eval.emit_source(
                        prog, ir_eval.array_signature(arrays))[1].ptrs:
                p = ir_eval.emit_source(
                    prog, ir_eval.array_signature(arrays))[1].ptrs.index(nm)
                assert f"tl.load(p{p} " in pro, (kind, nm)
                assert f"tl.load(p{p} " not in body, (kind, nm)


@pytest.mark.parametrize("kind", sorted(LIBRARY))
def test_library_source_design(library_programs, kind):
    if kind not in library_programs:
        # kinds the lowerer keeps on the scalar path have no program
        assert kind in ("K8sRequiredResources",)
        return
    prog, arrays = library_programs[kind]
    _check_design(prog, arrays)


@pytest.mark.parametrize("case", [every_op_case, ordering_case])
def test_node_axes_match_the_plain_evaluators_shapes(case):
    """A node's axes are exactly those along which the plain evaluator's
    (defined, value) broadcast is wider than 1."""
    prog, arrays = case(7, c_pad=8, r_pad=16, e_pad=4)
    ev = tex._Evaluator(prog, tex._with_dfa_tables(
        prog, convert.arrays_to_device(arrays, "cpu"),
        tdfa.dfa_table_plain))
    for i, axes in enumerate(ir_eval.node_axes(prog)):
        shape = torch.broadcast_shapes(*(t.shape for t in ev.node(i)))
        assert {"c": shape[0] > 1, "r": shape[1] > 1, "e": shape[2] > 1} \
            == {a: a in axes for a in "cre"}, (i, prog.nodes[i], shape)


def test_key_count_is_part_of_the_kernel_key():
    """The source unrolls over a cset's key count, so two counts are two
    sources."""
    srcs = set()
    for l_keys in (5, 40):
        prog, arrays = every_op_case(0, l_keys=l_keys)
        arrays["dfa0.devtab"] = arrays["dfa0.xv"]
        src, _ = ir_eval.emit_source(prog, ir_eval.array_signature(arrays))
        srcs.add(src)
        assert f"tl.static_range(32, 40)" in src or l_keys < 32
    assert len(srcs) == 2


# (c_pad, n_rows, e_max, n_b, delta): the north star, fleet (a), fleet
# (b)'s library kinds, a 1% churn and the tile edges
PLAN_SHAPES = [
    (128, 131072, 4, 1, False), (128, 131072, 1, 1, False),
    (128, 131072, 4, 4, False), (128, 131072, 1, 4, False),
    (4, 4096, 4, 4, False), (4, 4096, 8, 4, False), (4, 4096, 1, 4, False),
    (4, 4096, 2, 1, False), (128, 1024, 4, 1, True),
    (128, 1000, 4, 1, True), (128, 1024, 1, 1, True), (4, 8, 1, 1, False),
    (4, 8, 1, 1, True), (8, 64, 2, 3, False), (256, 64, 16, 1, False),
    (256, 131072, 16, 1, False), (128, 1 << 20, 4, 1, False),
    (4, 131072, 16, 1, True), (128, 1, 4, 1, True), (8, 16, 4, 1, True),
]


@pytest.mark.parametrize("c_pad,n_rows,e_max,n_b,delta", PLAN_SHAPES)
def test_tile_plan(c_pad, n_rows, e_max, n_b, delta):
    bc, br, split, warps = ir_eval.tile_plan(c_pad, n_rows, e_max, n_b,
                                             delta)
    for x in (bc, br, split, warps):
        assert x >= 1 and x & (x - 1) == 0
    assert c_pad % (bc * split) == 0
    if not delta:
        assert n_rows % br == 0
        assert br >= min(16, n_rows)      # 16-byte mask runs
    programs = n_b * -(-n_rows // br) * split
    rows_p2 = n_rows if not delta else 1 << (n_rows - 1).bit_length()
    most = n_b * -(-n_rows // min(ir_eval.MIN_BR, rows_p2)) * c_pad
    assert programs >= min(ir_eval.MIN_PROGRAMS, most)
    assert ir_eval.MIN_PROGRAMS == 264
    # a prologue block stays near ROW_POINTS lattice points
    assert br * e_max <= max(ir_eval.ROW_POINTS, ir_eval.MIN_BR * e_max)


def test_tile_plan_at_the_path_shapes():
    """The plans PERF.md records for the main path's shapes."""
    assert ir_eval.tile_plan(128, 131072, 4)[:3] == (2, 256, 1)
    assert ir_eval.tile_plan(128, 131072, 4, 4)[:3] == (2, 256, 1)
    assert ir_eval.tile_plan(128, 131072, 1)[:3] == (8, 256, 1)
    assert ir_eval.tile_plan(4, 4096, 4, 4)[:3] == (4, 32, 1)
    bc, br, split, _ = ir_eval.tile_plan(128, 1024, 4, delta=True)
    assert 1024 // br * split >= 264


# -- on a card: K1, K1b and K5 against their plain versions at the tile
# edges, bit for bit


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1, K1b and K5 run only on the GPU")
    return torch.device("cuda")


def _narrow(t: dict, dt):
    return t if dt is None else {
        k: (v.to(dt) if v.dtype == torch.int32
            and not k.endswith(".trans") else v) for k, v in t.items()}


CARD_SHAPES = [
    (4, 8, 1), (8, 64, 2), (128, 4096, 4), (256, 4096, 8), (4, 131072, 16),
    (128, 131072, 4), (256, 64, 16), (8, 4096, 1), (256, 131072, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("c_pad,r_pad,e_pad", CARD_SHAPES)
def test_k1_k5_tile_edges_on_card(card, c_pad, r_pad, e_pad):
    prog, arrays = every_op_case(c_pad + r_pad + e_pad, c_pad=c_pad,
                                 r_pad=r_pad, e_pad=e_pad)
    t = convert.arrays_to_device(arrays, card)
    rng = np.random.default_rng(r_pad + e_pad)
    br_full = ir_eval.tile_plan(c_pad, r_pad, e_pad)[1]
    br_delta = ir_eval.tile_plan(c_pad, 1024, e_pad, delta=True)[1]
    ds = {1, max(1, r_pad // 100)}
    for b in (br_full, br_delta):
        ds |= {b - 1, b, b + 1}
    for dt in (None, torch.int8, torch.int16):
        x = _narrow(t, dt)
        d = tex._with_dfa_tables(prog, x, tdfa.dfa_table)
        assert torch.equal(ir_eval.eval_mask(prog, d),
                           tex._eval_mask(prog, x)), dt
        viol_old = torch.from_numpy(rng.random((c_pad, r_pad)) < 0.5) \
            .to(card)
        for n in sorted(v for v in ds if 1 <= v <= r_pad):
            # drawn with replacement: duplicate rows
            rows = torch.from_numpy(rng.integers(0, r_pad, size=n)
                                    .astype(np.int32)).to(card)
            got = ir_eval.delta_mask(prog, d, viol_old, rows)
            assert torch.equal(got, tex._delta_mask(prog, x, viol_old,
                                                    rows)), (dt, n)


@pytest.mark.cuda
@pytest.mark.parametrize("c_pad,r_pad,e_pad", [(4, 8, 1), (8, 64, 4),
                                               (128, 4096, 8),
                                               (128, 131072, 4)])
def test_ordering_extremum_on_card(card, c_pad, r_pad, e_pad):
    """The max / min rewrite against the plain compares, with NaN,
    infinities and signed zeros, in K1, K5 and K1b."""
    prog, arrays = ordering_case(c_pad + r_pad, c_pad=c_pad, r_pad=r_pad,
                                 e_pad=e_pad)
    t = convert.arrays_to_device(arrays, card)
    rng = np.random.default_rng(c_pad)
    for dt in (None, torch.int8, torch.int16):
        x = _narrow(t, dt)
        want = tex._eval_mask(prog, x)
        assert torch.equal(ir_eval.eval_mask(prog, x), want), dt
        rows = torch.from_numpy(rng.integers(0, r_pad, size=min(r_pad, 100))
                                .astype(np.int32)).to(card)
        old = ~want
        assert torch.equal(ir_eval.delta_mask(prog, x, old, rows),
                           tex._delta_mask(prog, x, old, rows)), dt
        stacked = {nm: torch.stack([a, a.flip(0)]) for nm, a in x.items()}
        assert torch.equal(ir_eval.eval_mask_batched(prog, stacked),
                           tex._eval_mask_batched(prog, stacked)), dt


@pytest.mark.cuda
@pytest.mark.parametrize("n,c_pad,r_pad", [
    (1, 4, 8), (3, 8, 64), (4, 128, 4096), (3, 256, 4096), (4, 4, 32768),
])
def test_k1b_ragged_clusters_on_card(card, n, c_pad, r_pad):
    prog, stacked = stacked_every_op_case(n, c_pad=c_pad, r_pad=r_pad)
    d = convert.arrays_to_device(stacked, card)
    for dt in (None, torch.int8, torch.int16):
        x = _narrow(d, dt)
        x["dfa0.devtab"] = tdfa.dfa_table_batched(
            x["dfa0.trans"], x["dfa0.accept"], x["__strbytes__"],
            x["__strdfaok__"], x["dfa0.xv"], 3)
        assert torch.equal(ir_eval.eval_mask_batched(prog, x),
                           tex._eval_mask_batched(prog, x)), dt
