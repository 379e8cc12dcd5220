"""The port's fleet audit against the JAX package, on the CPU.

The fleet audit stacks N clusters' stores along a leading cluster axis
and audits each kind in one batched sweep (item B9: batched K3, K1 and
K2 on the card; their plain per-cluster versions here).  Which kinds
stack is decided by the install-time Stage-5 footprint and Stage-6
partition plan, which the port now computes.  Here, bit for bit:

  * the port's footprints and partition plans equal the reference's for
    every library template and the demo/basic templates;
  * the port's batched evaluation (``run_topk_batched``,
    ``run_mask_batched``) equals the reference's vmapped
    ``whatif.fleet._topk_fn`` / ``_mask_fn`` on the same stacked numpy
    arrays, over ragged cluster sizes, N from 1 to 4, caps 20 and 2;
  * the port's ``fleet_audit`` over ``TorchDriver(device="cpu")``
    clusters equals the reference's over ``JaxDriver`` clusters, its own
    ``fleet_loop_oracle`` and the scalar ``LocalDriver``.
"""

import glob
import os
import random

import numpy as np
import pytest
import torch
import yaml

from gatekeeper_tpu.analysis import costmodel as jcostmodel
from gatekeeper_tpu.analysis import footprint as jfootprint
from gatekeeper_tpu.analysis import shardplan as jshardplan
from gatekeeper_tpu.api.templates import compile_target_rego as jcompile
from gatekeeper_tpu.ir.lower import CannotLower as JCannotLower
from gatekeeper_tpu.ir.lower import lower_template as jlower
from gatekeeper_tpu.ir.program import Node as JNode
from gatekeeper_tpu.ir.program import Program as JProgram
from gatekeeper_tpu.ir.program import RuleSpec as JRule
from gatekeeper_tpu.library import all_docs as jall_docs
from gatekeeper_tpu.library import make_mixed
from gatekeeper_tpu.whatif import fleet as jfleet

from gatekeeper_tpu_torch import convert
from gatekeeper_tpu_torch.analysis import (costmodel, footprint,
                                           shardplan)
from gatekeeper_tpu_torch.api.templates import compile_target_rego
from gatekeeper_tpu_torch.client.client import Backend
from gatekeeper_tpu_torch.client.local_driver import LocalDriver
from gatekeeper_tpu_torch.engine import executor as tex
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.errors import ClientError
from gatekeeper_tpu_torch.ir.lower import CannotLower, lower_template
from gatekeeper_tpu_torch.kernels import dfa as tdfa
from gatekeeper_tpu_torch.kernels import ir_eval
from gatekeeper_tpu_torch.kernels import topk as ttopk
from gatekeeper_tpu_torch.kernels.op_cases import (every_op_case,
                                                   stacked_every_op_case)
from gatekeeper_tpu_torch.library import all_docs as tall_docs
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
from gatekeeper_tpu_torch.whatif import (fleet, fleet_audit,
                                         fleet_loop_oracle, make_cluster,
                                         normalize_results)

TARGET = "admission.k8s.gatekeeper.sh"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu():
    return TorchDriver(device="cpu")


@pytest.fixture(autouse=True)
def _device_path_at_test_sizes(monkeypatch):
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)


# ---------------------------------------------------------------------------
# Stage 5 and Stage 6 against the reference


def _template_sources() -> list[tuple[str, str]]:
    """(kind, rego) of every library template and the demo/basic ones."""
    out = []
    for t, _c in tall_docs():
        out.append((t["spec"]["crd"]["spec"]["names"]["kind"],
                    t["spec"]["targets"][0]["rego"]))
    for path in sorted(glob.glob(os.path.join(REPO, "demo", "basic",
                                              "templates", "*.yaml"))):
        with open(path) as f:
            doc = yaml.safe_load(f)
        out.append((doc["spec"]["crd"]["spec"]["names"]["kind"],
                    doc["spec"]["targets"][0]["rego"]))
    return out


SOURCES = dict(_template_sources())


def _lowered_pair(kind):
    """(reference lowering, port lowering); both None where neither
    lowers (a template only one of them lowers fails here)."""
    src = SOURCES[kind]
    jc = jcompile(kind, TARGET, src)
    tc = compile_target_rego(kind, TARGET, src)
    try:
        jl = jlower(jc.module, jc.interp)
    except JCannotLower:
        with pytest.raises(CannotLower):
            lower_template(tc.module, tc.interp)
        return None, None
    return jl, lower_template(tc.module, tc.interp)


def _columns(fp):
    return [(c.path, c.source, c.sensitivity) for c in fp.columns]


@pytest.fixture
def fresh_certifiers():
    """Both packages' Stage-5/6 process-global state, reset around the
    test (the memo and the published cross-row reasons)."""
    def reset():
        footprint.reset()
        shardplan.reset()
        for mod in (jfootprint, jshardplan):
            mod._memo.clear()
        jfootprint.cross_row.clear()
        jshardplan.plans.clear()
        jshardplan.ineligible.clear()
    reset()
    yield
    reset()


@pytest.mark.parametrize("kind", sorted(SOURCES))
def test_footprint_matches_reference(kind, fresh_certifiers):
    jl, tl = _lowered_pair(kind)
    if jl is None:
        return
    assert costmodel.reachable_nodes(tl.program) == \
        jcostmodel.reachable_nodes(jl.program)
    assert costmodel.node_axes(tl.program) == \
        jcostmodel.node_axes(jl.program)
    want = jfootprint.analyze(kind, jl)
    got = footprint.analyze(kind, tl)
    assert got.digest == want.digest
    assert _columns(got) == _columns(want)
    assert got.providers == want.providers
    assert got.row_local == want.row_local
    assert got.cross_row_reasons == want.cross_row_reasons
    assert footprint.locality_for(kind) == jfootprint.locality_for(kind)


@pytest.mark.parametrize("kind", sorted(SOURCES))
def test_shardplan_matches_reference(kind, fresh_certifiers):
    jl, tl = _lowered_pair(kind)
    if jl is None:
        return
    # put_template runs Stage 5 first: the plan reuses its reason
    jfootprint.analyze(kind, jl)
    footprint.analyze(kind, tl)
    want = jshardplan.analyze(kind, jl)
    got = shardplan.analyze(kind, tl)
    assert got.digest == want.digest
    assert got.eligible == want.eligible
    assert got.reason == want.reason
    assert got.layout == want.layout
    assert got.collectives == want.collectives
    assert got.padding == want.padding
    assert got.node_shardings == want.node_shardings


def test_library_cross_row_kinds_are_the_reference_ones(fresh_certifiers):
    """Only the inventory-join templates are cross-row and
    shard-ineligible, in both packages."""
    cross, jcross = set(), set()
    for kind in SOURCES:
        jl, tl = _lowered_pair(kind)
        if jl is None:
            continue
        if not footprint.analyze(kind, tl).row_local:
            cross.add(kind)
            assert not shardplan.analyze(kind, tl).eligible
        if not jfootprint.analyze(kind, jl).row_local:
            jcross.add(kind)
    # K8sUniqueLabel (demo/basic) joins the inventory too, but lowers in
    # neither package: it has no footprint at all
    assert cross == jcross == {"K8sUniqueIngressHost"}


def test_install_certifies_and_delete_drops(fresh_certifiers):
    """put_template runs Stage 5 then Stage 6; the memo answers the same
    lowering again; delete_template drops both certificates."""
    drv = _cpu()
    client = Backend(drv).new_client([K8sValidationTarget()])
    docs = tall_docs()
    for t, c in docs[:3]:
        client.add_template(t)
        client.add_constraint(c)
    st = drv._state(TARGET)
    kinds = sorted(st.templates)
    assert sorted(st.footprints) == kinds == sorted(st.shardplans)
    assert footprint.analyses_run == shardplan.analyses_run == 3
    drv2 = _cpu()
    client2 = Backend(drv2).new_client([K8sValidationTarget()])
    client2.add_template(docs[0][0])
    assert footprint.analyses_run == 3         # memo hit
    client.remove_template(docs[0][0])
    assert kinds[0] not in st.footprints and kinds[0] not in st.shardplans
    assert drv.scalar_only is False


@pytest.mark.parametrize("env,value", [
    ("GATEKEEPER_SHARDPLAN", "strict"),
])
def test_strict_modes_raise_not_yet_ported(monkeypatch, fresh_certifiers,
                                           env, value):
    """Strict partition-plan validation (the simulated mesh, ROADMAP
    A10) is not ported: the install fails with the not-yet-ported error
    instead of running as the default mode (the driver's error guard
    must not swallow it)."""
    monkeypatch.setenv(env, value)
    drv = _cpu()
    client = Backend(drv).new_client([K8sValidationTarget()])
    with pytest.raises(ClientError, match="not yet ported"):
        client.add_template(tall_docs()[0][0])


def test_footprint_strict_validates_and_stacks_as_default(monkeypatch,
                                                          fresh_certifiers):
    """GATEKEEPER_FOOTPRINT=strict perturbation-validates every library
    footprint at install (ported with the small-model worlds), with the
    reference's row-locality verdicts; the fleet audit then stacks the
    same kinds, with the same digests, as under the default mode."""
    from gatekeeper_tpu_torch.whatif import fleet_audit, make_cluster
    docs = tall_docs()
    templates = [t for t, _c in docs]
    constraints = [c for _t, c in docs]

    def run():
        footprint.reset()
        shardplan.reset()
        clusters = [make_cluster(f"c{i}", templates, constraints,
                                 objs=make_mixed(random.Random(40 + i), 30),
                                 driver_factory=_cpu) for i in range(2)]
        return clusters, fleet_audit(clusters, 20)

    base_clusters, base = run()
    monkeypatch.setenv("GATEKEEPER_FOOTPRINT", "strict")
    clusters, rep = run()
    fps = clusters[0].client.driver._state(TARGET).footprints
    assert fps and all(fp.validated for fp in fps.values())
    assert not footprint.violations
    want = {}
    for tdoc, _c in jall_docs():
        kind = tdoc["spec"]["crd"]["spec"]["names"]["kind"]
        tt = tdoc["spec"]["targets"][0]
        try:
            jc = jcompile(kind, tt["target"], tt["rego"])
            low = jlower(jc.module, jc.interp)
        except JCannotLower:
            continue
        want[kind] = jfootprint.analyze(kind, low).row_local
    assert {k: fp.row_local for k, fp in fps.items()} == want
    assert rep.kinds_stacked == base.kinds_stacked
    assert rep.digests == base.digests


def test_analysis_error_is_counted_and_kind_replicates(monkeypatch,
                                                       fresh_certifiers):
    """An analysis error does not fail the install: it is counted, the
    kind has no footprint, and the fleet audit runs it replicated."""
    def boom(*a, **k):
        raise RuntimeError("analysis bug")
    monkeypatch.setattr(footprint, "certify", boom)
    t, c = tall_docs()[0]
    cl = make_cluster("a", [t], [c], objs=make_mixed(random.Random(3), 40),
                      driver_factory=_cpu)
    st = cl.driver._state(TARGET)
    assert st.footprints == {}
    assert cl.driver.metrics.counter("footprint_errors").value == 1
    rep = fleet_audit([cl])
    kind = t["spec"]["crd"]["spec"]["names"]["kind"]
    assert rep.kinds_replicated == {kind: "no_footprint"}
    assert rep.digests == fleet_loop_oracle([cl])[1]


def test_footprint_off_replicates_every_kind(monkeypatch, fresh_certifiers):
    monkeypatch.setenv("GATEKEEPER_FOOTPRINT", "off")
    docs = tall_docs()[:4]
    cl = make_cluster("a", [t for t, _ in docs], [c for _, c in docs],
                      objs=make_mixed(random.Random(4), 50),
                      driver_factory=_cpu)
    rep = fleet_audit([cl])
    assert rep.kinds_stacked == [] and rep.device_dispatches == 0
    assert set(rep.kinds_replicated.values()) <= {"no_footprint",
                                                  "scalar_template"}
    assert rep.digests == fleet_loop_oracle([cl])[1]


# ---------------------------------------------------------------------------
# B9: the batched evaluation against the reference's vmapped functions


def _jax_program(prog):
    nodes, rules = convert.program_to_plain(prog)
    return JProgram(tuple(JNode(o, tuple(a), tuple(m)) for o, a, m in nodes),
                    tuple(JRule(tuple(c), e) for c, e in rules))


LIB_SIZES = (40, 75, 110, 23)       # ragged: r_pad 64, 128, 128, 32


@pytest.fixture(scope="module")
def lib_clusters():
    docs = tall_docs()
    return [make_cluster(f"c{i}", [t for t, _ in docs], [c for _, c in docs],
                         objs=make_mixed(random.Random(200 + i), n),
                         driver_factory=_cpu)
            for i, n in enumerate(LIB_SIZES)]


@pytest.fixture(scope="module")
def stacked_inputs(lib_clusters):
    """kind -> {n_clusters: (program, stacked)}: what fleet_audit hands
    the executor, recorded over the first n library clusters."""
    torch_driver.SMALL_WORKLOAD_EVALS = 0
    out: dict = {}
    orig = tex.ProgramExecutor.run_topk_batched

    def rec(self, program, stacked, k):
        out.setdefault(rec.kind_of[id(program)], {})[
            stacked["__alive__"].shape[0]] = (program, stacked)
        return orig(self, program, stacked, k)

    # two kinds may lower to equal programs: key on the program object
    # the fleet takes from the first cluster
    st = lib_clusters[0].driver._state(TARGET)
    rec.kind_of = {id(c.vectorized.program): k
                   for k, c in st.templates.items()
                   if c.vectorized is not None}
    tex.ProgramExecutor.run_topk_batched = rec
    try:
        for n in range(1, 5):
            fleet_audit(lib_clusters[:n])
    finally:
        tex.ProgramExecutor.run_topk_batched = orig
        torch_driver.SMALL_WORKLOAD_EVALS = 20_000
    return out


STACKED_KINDS = sorted(
    t["spec"]["crd"]["spec"]["names"]["kind"] for t, _ in tall_docs()
    if t["spec"]["crd"]["spec"]["names"]["kind"]
    not in ("K8sRequiredResources", "K8sUniqueIngressHost"))


def _b9_case(i):
    """Cluster count and cap of the i-th stacked kind: every N from 1
    to 4 at caps 20 and 2 across the library."""
    return 1 + i % 4, (20, 2)[(i // 4) % 2]


def _assert_topk_equal(got, want):
    counts, rows, valid = got
    wc, wr, ws = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(counts, wc)
    np.testing.assert_array_equal(valid, ws > 0)
    np.testing.assert_array_equal(np.where(valid, rows, 0),
                                  np.where(ws > 0, wr, 0))


@pytest.mark.parametrize("kind", STACKED_KINDS)
def test_b9_plain_matches_reference_vmap(stacked_inputs, kind):
    n, cap = _b9_case(STACKED_KINDS.index(kind))
    program, stacked = stacked_inputs[kind][n]
    jprog = _jax_program(program)
    ex = tex.ProgramExecutor("cpu")
    _assert_topk_equal(ex.run_topk_batched(program, stacked, cap),
                       jfleet._topk_fn(jprog, cap)(stacked))
    np.testing.assert_array_equal(ex.run_mask_batched(program, stacked),
                                  np.asarray(jfleet._mask_fn(jprog)(stacked)))


def test_b9_covers_every_cluster_count_and_cap(stacked_inputs):
    cases = {_b9_case(i) for i in range(len(STACKED_KINDS))}
    assert cases == {(n, c) for n in range(1, 5) for c in (20, 2)}
    assert sorted(stacked_inputs) == STACKED_KINDS
    regex = [k for k in STACKED_KINDS
             if tex.dfa_names(stacked_inputs[k][4][0])]
    assert regex == ["K8sImageDigests"]


def _every_op_stacked(n):
    return stacked_every_op_case(n)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("cap", [20, 2])
def test_b9_every_op_matches_reference_vmap(n, cap):
    """Every IR op (the library reaches a subset), with a regex table
    whose state count differs per cluster, through the batched plain
    versions and the reference's vmapped top-k and mask."""
    prog, stacked = _every_op_stacked(n)
    jprog = _jax_program(prog)
    ex = tex.ProgramExecutor("cpu")
    _assert_topk_equal(ex.run_topk_batched(prog, stacked, cap),
                       jfleet._topk_fn(jprog, cap)(stacked))
    np.testing.assert_array_equal(ex.run_mask_batched(prog, stacked),
                                  np.asarray(jfleet._mask_fn(jprog)(stacked)))


def test_batched_plain_is_the_per_cluster_plain_on_stacked_slices():
    """Each batched wrapper's plain version is its unbatched plain
    version on ``stacked[nm][i]``, and on CPU tensors the wrappers count
    plain calls, never launches."""
    prog, stacked = _every_op_stacked(3)
    d = convert.arrays_to_device(stacked, "cpu")
    before = (tdfa.dfa_table_batched.launches,
              ir_eval.eval_mask_batched.launches,
              ttopk.topk_packed_batched.launches)
    plain = (tdfa.dfa_table_batched.plain_calls,
             ir_eval.eval_mask_batched.plain_calls,
             ttopk.topk_packed_batched.plain_calls)
    tab = tdfa.dfa_table_batched(d["dfa0.trans"], d["dfa0.accept"],
                                 d["__strbytes__"], d["__strdfaok__"],
                                 d["dfa0.xv"], 3)
    dd = dict(d, **{"dfa0.devtab": tab})
    mask = ir_eval.eval_mask_batched(prog, dd)
    packed = ttopk.topk_packed_batched(mask, d["__rank__"], 20)
    for i in range(3):
        one = {nm: a[i] for nm, a in d.items()}
        assert torch.equal(tab[i], tex._dfa_device_table(one, "dfa0"))
        assert torch.equal(mask[i], tex._eval_mask(prog, one))
        assert torch.equal(packed[i], ttopk.topk_packed_plain(
            mask[i], one["__rank__"], 20))
    assert (tdfa.dfa_table_batched.launches,
            ir_eval.eval_mask_batched.launches,
            ttopk.topk_packed_batched.launches) == before
    assert (tdfa.dfa_table_batched.plain_calls,
            ir_eval.eval_mask_batched.plain_calls,
            ttopk.topk_packed_batched.plain_calls) == tuple(
                p + 1 for p in plain)


def test_batched_kernel_source_shares_the_unbatched_signature():
    """K1's source takes the cluster from grid axis 2 and rebases every
    array and the output by a runtime per-cluster count; the kernel is
    keyed on the per-cluster signature, so batched and unbatched
    launches of one program use one kernel source."""
    prog, stacked = _every_op_stacked(2)
    stacked["dfa0.devtab"] = np.zeros(stacked["dfa0.xv"].shape, dtype=bool)
    one = {nm: a[0] for nm, a in stacked.items()}
    sig_b = ir_eval.array_signature(stacked, lead=1)
    sig_1 = ir_eval.array_signature(one)
    assert {nm: dt for nm, (dt, _) in sig_b.items()} == \
        {nm: dt for nm, (dt, _) in sig_1.items()}
    src, em = ir_eval.emit_source(prog, sig_b)
    assert src == ir_eval.emit_source(prog, sig_1)[0]
    assert "pid_b = tl.program_id(2).to(tl.int64)" in src
    assert "out = out + pid_b * SB_OUT" in src
    for i in range(len(em.ptrs)):
        assert f"p{i} = p{i} + pid_b * sb{i}" in src


def test_padded_rows_never_score(stacked_inputs, lib_clusters):
    """Ranks are padded per cluster to its r_pad, then zero-padded to
    the stacked R; the padded rows are dead, so no valid top-k slot
    ever names a row past a cluster's own rows."""
    kind = "K8sRequiredLabels"
    program, stacked = stacked_inputs[kind][4]
    alive, rank = stacked["__alive__"], stacked["__rank__"]
    r_pads = [cl.driver._state(TARGET).bindings_cache[kind][1].r_pad
              for cl in lib_clusters]
    assert sorted(set(r_pads)) == [32, 64, 128] and alive.shape[1] == 128
    ex = tex.ProgramExecutor("cpu")
    counts, rows, valid = ex.run_topk_batched(program, stacked, 1000)
    for i, (n, r_pad) in enumerate(zip(LIB_SIZES, r_pads)):
        assert not alive[i, n:].any()
        assert (rank[i, n:r_pad] == r_pad - 1).all()
        assert (rank[i, r_pad:] == 0).all()
        picked = rows[i][valid[i]]
        assert len(picked) and (picked < n).all()
        assert counts[i].sum() == valid[i].sum()


def test_edge_padded_tables(stacked_inputs, lib_clusters):
    """``.any``/``.all``/``.bitmap`` tables replicate their last
    (sentinel) column across the pad; every other array pads with
    zeros.  The library's tables have one width in every cluster (it is
    set by the shared constraints), so the ragged widths come from the
    every-op case; the library shows each cluster's own arrays at the
    head of its stacked slice and zeros past them."""
    assert fleet._pad_to(np.array([[True, False, True]]), (2, 5), True) \
        .tolist() == [[True, False, True, True, True]] * 2
    assert fleet._pad_to(np.array([[3, 1]]), (1, 4), False).tolist() == \
        [[3, 1, 0, 0]]
    seen = 0
    for i in range(3):
        _prog, own = every_op_case(40 + i, c_pad=8, r_pad=32 << (i % 3),
                                   t_pad=16 << (i % 2), u=4 + 2 * i,
                                   n_states=5 + i)
        _prog, stacked = _every_op_stacked(3)
        for nm in ("pt0.any", "pt0.all", "cs0.bitmap"):
            c, u = own[nm].shape
            assert u < stacked[nm].shape[2] or i == 2
            np.testing.assert_array_equal(stacked[nm][i, :, :u], own[nm])
            np.testing.assert_array_equal(
                stacked[nm][i, :, u:],
                np.repeat(own[nm][:, -1:], stacked[nm].shape[2] - u, axis=1))
            seen += u < stacked[nm].shape[2]
    assert seen == 6
    sts = [cl.driver._state(TARGET) for cl in lib_clusters]
    for kind, by_n in stacked_inputs.items():
        _program, stacked = by_n[4]
        for nm, arr in stacked.items():
            if nm in ("__match__", "__rank__"):
                continue
            for i, st in enumerate(sts):
                own = st.bindings_cache[kind][1].arrays[nm]
                head = tuple(slice(0, d) for d in own.shape)
                np.testing.assert_array_equal(arr[i][head], own)
                rest = arr[i].copy()
                rest[head] = 0
                assert not rest.any(), (kind, nm)


# ---------------------------------------------------------------------------
# the fleet audit against the reference, its loop oracle and LocalDriver


def _jax_clusters(docs, sizes, seed0):
    return [jfleet.make_cluster(f"c{i}", [t for t, _ in docs],
                                [c for _, c in docs],
                                objs=make_mixed(random.Random(seed0 + i), n))
            for i, n in enumerate(sizes)]


def _torch_clusters(docs, sizes, seed0, factory=_cpu):
    return [make_cluster(f"c{i}", [t for t, _ in docs], [c for _, c in docs],
                         objs=make_mixed(random.Random(seed0 + i), n),
                         driver_factory=factory)
            for i, n in enumerate(sizes)]


@pytest.mark.parametrize("n_docs,sizes,seed0", [
    (8, (60, 90, 120), 100),        # the stores of test_whatif's TestFleet
    (None, (70, 45, 130), 300),     # the whole library
])
def test_fleet_matches_reference(n_docs, sizes, seed0):
    jdocs = jall_docs()[:n_docs]
    tdocs = tall_docs()[:n_docs]
    want = jfleet.fleet_audit(_jax_clusters(jdocs, sizes, seed0), 20)
    tcl = _torch_clusters(tdocs, sizes, seed0)
    got = fleet_audit(tcl, 20)
    assert got.digests == want.digests
    assert got.verdicts == want.verdicts
    # no kind is pinned to the scalar path by a reference certifier the
    # port lacks (Stages 2, 4, 7, 8): the stacked sets are equal
    assert got.kinds_stacked == want.kinds_stacked
    assert got.kinds_replicated == want.kinds_replicated
    assert got.device_dispatches == len(got.kinds_stacked) \
        == want.device_dispatches
    verdicts, digests, _ = fleet_loop_oracle(tcl, 20)
    assert got.digests == digests and got.verdicts == verdicts


def test_fleet_uncapped_matches_local_driver():
    """At a cap above every count, the stacked fleet's verdicts are the
    scalar oracle's full audit of each store."""
    docs = tall_docs()
    sizes = (50, 90, 20)
    tcl = _torch_clusters(docs, sizes, 500)
    rep = fleet_audit(tcl, 10_000)
    assert len(rep.kinds_stacked) == 47
    for i, n in enumerate(sizes):
        local = LocalDriver()
        client = Backend(local).new_client([K8sValidationTarget()])
        for t, c in docs:
            client.add_template(t)
            client.add_constraint(c)
        client.add_data_batch(make_mixed(random.Random(500 + i), n))
        assert rep.verdicts[i] == normalize_results(
            client.audit().results())


def test_under_filled_cap_widens_through_the_batched_mask(monkeypatch):
    """When the device's top-k leaves a cap under-filled while more
    candidates exist, the fleet widens through ``run_mask_batched`` —
    forced here by a top-k that reports the counts but no valid slot."""
    docs = tall_docs()[:6]
    tcl = _torch_clusters(docs, (40, 80), 600)
    want = fleet_loop_oracle(tcl, 20)
    orig = tex.ProgramExecutor.run_topk_batched
    calls = []

    def empty_slots(self, program, stacked, k):
        counts, rows, valid = orig(self, program, stacked, k)
        return counts, rows, np.zeros_like(valid)

    def mask(self, program, stacked):
        calls.append(program.cache_key())
        return orig_mask(self, program, stacked)

    orig_mask = tex.ProgramExecutor.run_mask_batched
    monkeypatch.setattr(tex.ProgramExecutor, "run_topk_batched", empty_slots)
    monkeypatch.setattr(tex.ProgramExecutor, "run_mask_batched", mask)
    rep = fleet_audit(tcl, 20)
    assert calls and len(set(calls)) == len(calls)    # once per kind
    assert rep.digests == want[1] and rep.verdicts == want[0]


def test_cluster_from_store_state():
    """A cluster seeded from a store snapshot audits as the client the
    snapshot came from, through the stacked path too."""
    docs = tall_docs()[:8]
    src = _torch_clusters(docs, (80,), 7)[0]
    state = src.driver._state(TARGET).table.snapshot_state()
    baseline = normalize_results(
        src.client.audit(limit_per_constraint=20, full=True).results())
    cl = make_cluster("snap", [t for t, _ in docs], [c for _, c in docs],
                      store_state=state, driver_factory=_cpu)
    assert fleet_loop_oracle([cl], 20)[0][0] == baseline
    rep = fleet_audit([cl, src], 20)
    assert rep.verdicts == [baseline, baseline]
    assert rep.kinds_stacked


def test_adopt_store_drops_table_caches(monkeypatch):
    # the legacy sweep fills the bindings cache (the paged route is off)
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    docs = tall_docs()[:3]
    a, b = _torch_clusters(docs, (30, 60), 11)
    a.client.audit(limit_per_constraint=20)
    st = a.driver._state(TARGET)
    assert st.bindings_cache
    a.driver.adopt_store(TARGET, b.driver._state(TARGET).table
                         .snapshot_state())
    assert st.bindings_cache == {} and st.mask_cache == {}
    assert st.order_cache is None and st.rank_cache is None
    assert fleet_loop_oracle([a], 20)[1] == fleet_loop_oracle([b], 20)[1]


def test_policy_set_mismatch_rejected():
    docs = tall_docs()[:3]
    a = make_cluster("a", [t for t, _ in docs], [c for _, c in docs],
                     objs=[], driver_factory=_cpu)
    b = make_cluster("b", [t for t, _ in docs[:2]],
                     [c for _, c in docs[:2]], objs=[], driver_factory=_cpu)
    with pytest.raises(ValueError, match="share one policy set"):
        fleet_audit([a, b])


def test_disagreeing_constraints_rejected():
    docs = tall_docs()[:2]
    a = make_cluster("a", [t for t, _ in docs], [c for _, c in docs],
                     objs=[], driver_factory=_cpu)
    other = dict(docs[0][1], metadata={"name": "renamed"})
    b = make_cluster("b", [t for t, _ in docs], [other, docs[1][1]],
                     objs=[], driver_factory=_cpu)
    with pytest.raises(ValueError, match="disagree on constraints"):
        fleet_audit([a, b])


def test_empty_fleet_rejected():
    with pytest.raises(ValueError):
        fleet_audit([])


def test_mixed_devices_rejected():
    docs = tall_docs()[:1]
    a, b = _torch_clusters(docs, (10, 10), 1)
    b.driver.device = torch.device("meta")
    with pytest.raises(ValueError, match="different devices"):
        fleet_audit([a, b])


def test_default_driver_is_cuda():
    """make_cluster's default driver is TorchDriver() on CUDA: without a
    card it raises instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default driver succeeds")
    with pytest.raises(RuntimeError):
        make_cluster("a", [], [])
