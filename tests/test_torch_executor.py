"""The PyTorch port's executor against the JAX reference, on the CPU.

The same lowered programs and the same numpy bindings (carried across
with gatekeeper_tpu_torch.convert) go through ``veval._eval_mask`` and
through the port's plain evaluator; masks, packed top-k and DFA tables
must be equal bit for bit.  K1's emitter must produce parseable Triton
source for every library program without importing triton.  The kernels
themselves are held against these plain versions on the card by
tests/test_torch_kernels.py.
"""

import ast
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatekeeper_tpu.client.client import Backend
from gatekeeper_tpu.client.local_driver import LocalDriver
from gatekeeper_tpu.engine import veval
from gatekeeper_tpu.ir.lower import CannotLower, lower_template
from gatekeeper_tpu.ir.prep import build_bindings
from gatekeeper_tpu.ir.program import Node as JNode
from gatekeeper_tpu.ir.program import Program as JProgram
from gatekeeper_tpu.ir.program import RuleSpec as JRule
from gatekeeper_tpu.library import all_docs, make_mixed
from gatekeeper_tpu.target.k8s import K8sValidationTarget, TARGET_NAME

from gatekeeper_tpu_torch import convert
from gatekeeper_tpu_torch.engine import executor as tex
from gatekeeper_tpu_torch.ir import lower as tlower
from gatekeeper_tpu_torch.ir import prep as tprep
from gatekeeper_tpu_torch.ir.program import Node, Program, RuleSpec
from gatekeeper_tpu_torch.kernels import dfa as tdfa
from gatekeeper_tpu_torch.kernels import ir_eval, topk as ttopk
from gatekeeper_tpu_torch.kernels.op_cases import every_op_case
from gatekeeper_tpu_torch.store.table import (ResourceMeta as TMeta,
                                              ResourceTable as TTable)

LIBRARY_KINDS = sorted(t["spec"]["crd"]["spec"]["names"]["kind"]
                       for t, _ in all_docs())
ROWS = 300


def _plain_program(prog):
    return ([(n.op, n.args, n.meta) for n in prog.nodes],
            [(r.conjuncts, r.elem_axis) for r in prog.rules])


def _jax_program(nodes, rules):
    return JProgram(tuple(JNode(o, tuple(a), tuple(m)) for o, a, m in nodes),
                    tuple(JRule(tuple(c), e) for c, e in rules))


def _jax_mask(prog, arrays, jit=False):
    """The reference mask; ``jit`` compiles the evaluation as the
    JaxDriver does (faster than eager for large programs)."""
    fn = (lambda d: veval._eval_mask(prog, d))
    if jit:
        fn = jax.jit(fn)
    return np.asarray(fn({k: jnp.asarray(v) for k, v in arrays.items()}))


@pytest.fixture(scope="module")
def library():
    """The reference's store: every library template and sample
    constraint over make_mixed rows, with each kind's lowering and
    bindings (None where the template does not lower)."""
    drv = LocalDriver()
    client = Backend(drv).new_client([K8sValidationTarget()])
    for t, con in all_docs():
        client.add_template(t)
        client.add_constraint(con)
    client.add_data_batch(make_mixed(random.Random(0), ROWS))
    st = drv._state(TARGET_NAME)
    out = {}
    for kind, comp in st.templates.items():
        try:
            lp = lower_template(comp.module, comp.interp)
        except CannotLower:
            out[kind] = (comp, None, None)
            continue
        cons = [st.constraints[kind][n]
                for n in sorted(st.constraints.get(kind, {}))]
        out[kind] = (comp, lp, build_bindings(lp.spec, st.table, cons))
    return out


def test_library_lowers_48_of_49(library):
    assert len(library) == 49
    assert sum(1 for _, lp, _ in library.values() if lp is not None) == 48


@pytest.mark.parametrize("kind", LIBRARY_KINDS)
def test_library_mask_matches_reference(library, kind):
    comp, lp, b = library[kind]
    if lp is None:
        # the port's own copy of the lowerer rejects the same template
        from gatekeeper_tpu_torch.api.templates import compile_target_rego
        pc = compile_target_rego(kind, TARGET_NAME, comp.source)
        with pytest.raises(tlower.CannotLower):
            tlower.lower_template(pc.module, pc.interp)
        return
    nodes, rules = _plain_program(lp.program)
    prog = convert.program_from_plain(nodes, rules)
    assert convert.program_to_plain(prog) == (
        [(o, tuple(a), tuple(m)) for o, a, m in nodes],
        [(tuple(c), e) for c, e in rules])
    ref = _jax_mask(lp.program, b.arrays)
    got = tex._eval_mask(prog, convert.arrays_to_device(b.arrays, "cpu"))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.shape == (b.c_pad, b.r_pad)
    # K1's emitter writes parseable Triton source for the program
    arrays = tex._with_dfa_tables(
        prog, convert.arrays_to_device(b.arrays, "cpu"),
        tdfa.dfa_table_plain)
    src, em = ir_eval.emit_source(prog, ir_eval.array_signature(arrays))
    ast.parse(src)
    assert "@triton.jit" in src and em.ptrs


def test_every_op_case_matches_reference():
    """One program using every IR op (incl. arith with zero divisors,
    keyed_val, elem_keys_missing, per-constraint in_cset, count_e) over
    random bindings with out-of-range ids, several seeds and shapes."""
    for seed, kw in ((0, {}), (1, {}), (2, {"e_pad": 2}),
                     (3, {"c_pad": 4, "r_pad": 8}),
                     (4, {"c_pad": 16, "r_pad": 128, "e_pad": 8})):
        prog, arrays = every_op_case(seed, **kw)
        jp = _jax_program(*convert.program_to_plain(prog))
        ref = _jax_mask(jp, arrays, jit=True)
        got = tex._eval_mask(prog, convert.arrays_to_device(arrays, "cpu"))
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=str(seed))
        assert 0 < ref.sum() < ref.size
        src, _ = ir_eval.emit_source(
            prog, ir_eval.array_signature({**arrays,
                                           "dfa0.devtab": arrays["dfa0.xv"]}))
        ast.parse(src)


# -- hand-built programs of tests/test_ir_eval.py, through the port


def _mk_table(objs):
    t = TTable()
    for i, o in enumerate(objs):
        meta = TMeta(api_version="v1", kind=o.get("kind", "Pod"),
                     name=o.get("metadata", {}).get("name", f"r{i}"),
                     namespace=o.get("metadata", {}).get("namespace"))
        t.upsert(f"k{i}", o, meta)
    return t


def _run_both(prog, spec, objs, constraints):
    b = tprep.build_bindings(spec, _mk_table(objs), constraints)
    got = tex.ProgramExecutor(device="cpu").run(prog, b)
    ref = _jax_mask(_jax_program(*convert.program_to_plain(prog)), b.arrays)
    np.testing.assert_array_equal(
        got, ref[: b.n_constraints, : b.n_resources])
    return got


def test_required_labels_program():
    objs = [
        {"kind": "Namespace", "metadata": {"name": "a", "labels": {"gk": "x"}}},
        {"kind": "Namespace", "metadata": {"name": "b", "labels": {"other": "y"}}},
        {"kind": "Namespace", "metadata": {"name": "c"}},
    ]
    constraints = [
        {"kind": "K8sRequiredLabels", "metadata": {"name": "need-gk"},
         "spec": {"parameters": {"labels": ["gk"]}}},
        {"kind": "K8sRequiredLabels", "metadata": {"name": "need-two"},
         "spec": {"parameters": {"labels": ["gk", "owner"]}}},
    ]
    spec = tprep.PrepSpec(
        csets=(tprep.CSetReq("req",
                             lambda c: c["spec"]["parameters"]["labels"]),),
        membs=(tprep.MembReq("labmemb", "req", ("metadata", "labels")),),
    )
    prog = Program(
        nodes=(Node("cset_not_subset_memb", (), ("req", "labmemb")),),
        rules=(RuleSpec(conjuncts=(0,)),),
    )
    mask = _run_both(prog, spec, objs, constraints)
    assert mask.tolist() == [[False, True, True], [True, True, True]]


def test_allowed_repos_program():
    objs = [
        {"kind": "Pod", "metadata": {"name": "p1"},
         "spec": {"containers": [{"name": "a", "image": "gcr.io/org/app:1"}]}},
        {"kind": "Pod", "metadata": {"name": "p2"},
         "spec": {"containers": [{"name": "a", "image": "gcr.io/org/app:1"},
                                 {"name": "b", "image": "docker.io/evil:2"}]}},
        {"kind": "Pod", "metadata": {"name": "p3"}, "spec": {"containers": []}},
    ]
    constraints = [
        {"kind": "K8sAllowedRepos", "metadata": {"name": "gcr-only"},
         "spec": {"parameters": {"repos": ["gcr.io/"]}}},
        {"kind": "K8sAllowedRepos", "metadata": {"name": "anything"},
         "spec": {"parameters": {"repos": ["gcr.io/", "docker.io/"]}}},
    ]
    spec = tprep.PrepSpec(
        e_cols=(tprep.EColReq("img", "spec.containers",
                              ("spec", "containers"), ("image",), "str"),),
        axes=(("spec.containers", ("spec", "containers")),),
        ptables=(tprep.PTableReq("sw", "img",
                                 lambda c: c["spec"]["parameters"]["repos"],
                                 lambda s, p: s.startswith(p)),),
    )
    prog = Program(
        nodes=(
            Node("input", (), ("img", "e_id")),
            Node("ptable_any", (0,), ("sw", "sw")),
            Node("not", (1,)),
        ),
        rules=(RuleSpec(conjuncts=(0, 2), elem_axis="spec.containers"),),
    )
    mask = _run_both(prog, spec, objs, constraints)
    assert mask.tolist() == [[False, True, False], [False, False, False]]


def test_numeric_compare_and_cval():
    objs = [
        {"kind": "Deployment", "metadata": {"name": "d1"}, "spec": {"replicas": 5}},
        {"kind": "Deployment", "metadata": {"name": "d2"}, "spec": {"replicas": 1}},
        {"kind": "Deployment", "metadata": {"name": "d3"}, "spec": {}},
    ]
    constraints = [
        {"kind": "K8sMaxReplicas", "metadata": {"name": "max3"},
         "spec": {"parameters": {"max": 3}}},
        {"kind": "K8sMaxReplicas", "metadata": {"name": "nomax"},
         "spec": {"parameters": {}}},
    ]
    spec = tprep.PrepSpec(
        r_cols=(tprep.RColReq("reps", ("spec", "replicas"), "num"),),
        cvals=(tprep.CValReq("mx", "num",
                             lambda c: c["spec"]["parameters"].get("max")),),
    )
    prog = Program(
        nodes=(
            Node("input", (), ("reps", "r_num")),
            Node("input", (), ("mx", "c_num")),
            Node("cmp", (0, 1), (">",)),
        ),
        rules=(RuleSpec(conjuncts=(2,)),),
    )
    mask = _run_both(prog, spec, objs, constraints)
    assert mask.tolist() == [[True, False, False], [False, False, False]]


def test_arith_division_by_zero_is_undefined():
    """replicas / divisor > 1 with zero and missing divisors: a zero
    divisor makes the quotient undefined, so the rule cannot fire."""
    objs = [{"kind": "Deployment", "metadata": {"name": f"d{i}"},
             "spec": {"replicas": r, **({"div": d} if d is not None else {})}}
            for i, (r, d) in enumerate([(4, 2), (4, 0), (1, 3), (9, None),
                                        (-6, -2), (7, 0.5)])]
    constraints = [{"kind": "K", "metadata": {"name": "c"},
                    "spec": {"parameters": {}}}]
    spec = tprep.PrepSpec(r_cols=(
        tprep.RColReq("reps", ("spec", "replicas"), "num"),
        tprep.RColReq("div", ("spec", "div"), "num")))
    prog = Program(
        nodes=(Node("input", (), ("reps", "r_num")),
               Node("input", (), ("div", "r_num")),
               Node("arith", (0, 1), ("/",)),
               Node("const", (), (1.0, "float32")),
               Node("cmp", (2, 3), (">",))),
        rules=(RuleSpec(conjuncts=(4,)),))
    mask = _run_both(prog, spec, objs, constraints)
    assert mask.tolist() == [[True, False, False, False, True, True]]


# -- top-k and DFA plain versions against the reference


def _packed_equal(got, ref, k):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    gv, rv = got[:, 1 + k:], ref[:, 1 + k:]
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(got[:, 1:1 + k] * gv, ref[:, 1:1 + k] * rv)


def _case(*args, rank="perm"):
    """A parameter set; the permutation cases keep their earlier ids."""
    return pytest.param(*args, rank,
                        id="-".join(map(str, args)) + ("" if rank == "perm"
                                                       else f"-{rank}"))


@pytest.mark.parametrize("c_pad,r_pad,k,density,rank_kind", [
    _case(8, 64, 20, 0.3),
    _case(4, 8, 20, 0.6),                  # r_pad < k: padded slots
    _case(8, 2 * veval.R_CHUNK, 20, 0.01),  # R > R_CHUNK: chunked reference
    _case(16, 1024, 5, 0.0),
    _case(16, 1024, 100, 0.9),
    # veval.pad_rank's shape: live rows permuted, padded rows r_pad - 1
    # past both chunks' boundary, the padded rows violating
    _case(8, 2 * veval.R_CHUNK, 20, 0.5, rank="pad"),
    _case(4, 2 * veval.R_CHUNK, 300, 0.5, rank="pad"),
    _case(8, 64, 1, 0.3),
    _case(16, 1024, 129, 0.3),
    _case(8, 4096, 300, 0.5),
    _case(4, 100, 150, 0.5),               # k > r_pad
    _case(4, 512, 20, 1.0),                # every row violates
    _case(4, 512, 300, 1.0),
])
def test_topk_packed_matches_reduce_fn(c_pad, r_pad, k, density, rank_kind):
    rng = np.random.default_rng(c_pad * r_pad + k)
    viol = rng.random((c_pad, r_pad)) < density
    if rank_kind == "pad":
        live = r_pad * 5 // 8
        rank = veval.pad_rank(rng.permutation(live).astype(np.int32), r_pad)
        viol[:, :live] &= rng.random((c_pad, live)) < 2e-4
    else:
        rank = rng.permutation(r_pad).astype(np.int32)
    ref = veval.ProgramExecutor()._reduce_fn(
        k, (c_pad, r_pad), (r_pad,))(jnp.asarray(viol), jnp.asarray(rank))
    got = ttopk.topk_packed(torch.from_numpy(viol), torch.from_numpy(rank),
                            k)
    assert got.dtype == torch.int32 and got.shape == (c_pad, 1 + 2 * k)
    _packed_equal(got.numpy(), ref, k)
    rc, rr, rv = veval.topk_reduce(jnp.asarray(viol), k, jnp.asarray(rank))
    gc, gr, gvld = tex.topk_reduce(torch.from_numpy(viol), k,
                                   torch.from_numpy(rank))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(gvld.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gr.numpy() * gvld.numpy(),
                                  np.asarray(rr) * np.asarray(rv))


def test_topk_without_rank_uses_row_order():
    rng = np.random.default_rng(3)
    viol = rng.random((4, 64)) < 0.4
    ref = veval.ProgramExecutor()._reduce_fn(20, (4, 64), None)(
        jnp.asarray(viol))
    got = ttopk.topk_packed(torch.from_numpy(viol), None, 20)
    _packed_equal(got.numpy(), ref, 20)


def test_dfa_table_matches_reference(library):
    """Random automata over random byte rows, and the library's regex
    template's real tables."""
    cases = []
    for seed in range(3):
        _, arrays = every_op_case(seed, t_pad=64, width=24, n_states=9)
        cases.append(arrays)
    regex = [(b.arrays, n.meta[0]) for _, lp, b in library.values()
             if lp is not None for n in lp.program.nodes
             if n.op == "dfa_match"]
    assert regex, "the library has an in-program regex template"
    for arrays, name in [(a, "dfa0") for a in cases] + regex:
        ref = np.asarray(veval._dfa_device_table(
            {k: jnp.asarray(v) for k, v in arrays.items()}, name))
        t = convert.arrays_to_device(arrays, "cpu")
        got = tex._dfa_device_table(t, name)
        np.testing.assert_array_equal(got.numpy(), ref)
        ins = (t[name + ".trans"], t[name + ".accept"], t["__strbytes__"],
               t["__strdfaok__"], t[name + ".xv"], 3)
        assert torch.equal(tdfa.dfa_table(*ins), got)
        assert torch.equal(tdfa.dfa_table(ins[0].to(torch.int16), *ins[1:]),
                           got)
