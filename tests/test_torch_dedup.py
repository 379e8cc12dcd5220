"""The port's cross-template dedup against the JAX package, on the CPU.

A forced full sweep rewrites every member program of a shared canonical
conjunct to read one injected bool column, which the host twin
(``analysis/policyset.eval_shared_host``) computes once a sweep and
splices under churn.  Here the port's plan, host twin, sweeps, stanzas
and whole-set report are held to the reference's on the same templates,
constraints and store, bit for bit, and every shared column also to the
same node's fires in the port's plain evaluator (the version K1 is held
to on the card).  Unlike the reference, a twin exception ends the sweep
(ROADMAP Queue C); a shape mismatch keeps the kind on its original
program and is counted.
"""

import copy
import random

import numpy as np
import pytest
import torch

from gatekeeper_tpu.analysis import policyset as jps
from gatekeeper_tpu.client import probe as jprobe
from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.library import LIBRARY, constraint_doc, template_doc
from gatekeeper_tpu.library import all_docs, make_mixed
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch.analysis import policyset as tps
from gatekeeper_tpu_torch.client import probe as tprobe
from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.engine import executor as tex
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget
from gatekeeper_tpu_torch.whatif.shadow import (shadow_constraint_doc,
                                                shadow_template_doc)

TARGET = "admission.k8s.gatekeeper.sh"
# the library kinds that share a canonical predicate subprogram
# (tests/test_policyset.py DEDUP_KINDS)
DEDUP_KINDS = ("K8sAllowedSeccompProfiles", "K8sAutomountServiceAccountToken",
               "K8sImagePullSecrets", "K8sPriorityClass",
               "K8sRequiredServiceAccount")


@pytest.fixture(autouse=True)
def _device_path_at_test_sizes(monkeypatch):
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.delenv("GATEKEEPER_DEDUP", raising=False)


def _pair():
    td, jd = TorchDriver(device="cpu"), JaxDriver()
    return (td, jd), (TBackend(td).new_client([TTarget()]),
                      JBackend(jd).new_client([JTarget()]))


def _dedup_set(client):
    for kind in DEDUP_KINDS:
        rego, params = LIBRARY[kind]
        client.add_template(template_doc(kind, rego))
        client.add_constraint(constraint_doc(kind, f"{kind.lower()}-1",
                                             params=params))


def _with_shadow_twins(client):
    """The library, and its shadow twin under the tag ``twin``: every
    template's conjuncts then share across versions, which gives groups
    of every shareable op and of both ekinds."""
    for tdoc, cdoc in all_docs():
        client.add_template(tdoc)
        client.add_constraint(cdoc)
    for tdoc, cdoc in all_docs():
        client.add_template(shadow_template_doc(tdoc, "twin"))
        client.add_constraint(shadow_constraint_doc(cdoc, "twin"))


def _verdicts(results):
    return sorted(((r.constraint or {}).get("kind", ""),
                   ((r.constraint or {}).get("metadata") or {}).get("name"),
                   ((r.resource or {}).get("metadata") or {}).get("name"),
                   r.msg) for r in results)


def _stanza(phases):
    """The ``dedup`` stanza less its host seconds."""
    return {k: v for k, v in (phases.get("dedup") or {}).items()
            if k != "host_eval_s"}


def _plan_view(plan):
    """A package-neutral view of a DedupPlan: groups with their members
    and sites, the kinds' digests, and the rewritten programs."""
    def prog(p):
        return ([(n.op, tuple(n.args), repr(n.meta)) for n in p.nodes],
                [(tuple(r.conjuncts), r.elem_axis) for r in p.rules])
    return {
        "groups": {d: (g.ekind, g.axis, g.binding, g.total_sites,
                       {k: (m.node_idx, m.sites)
                        for k, m in g.members.items()})
                   for d, g in plan.groups.items()},
        "kind_digests": dict(plan.kind_digests),
        "rewritten": {k: prog(p) for k, p in plan.rewritten.items()},
        "originals": {k: prog(p) for k, p in plan.originals.items()},
    }


# ---------------------------------------------------------------------------
# the plan


def test_library_plan_equals_the_reference():
    t = {k: (low, cons) for k, low, cons in tprobe._library_entries()
         if low is not None}
    j = {k: (low, cons) for k, low, cons in jprobe._library_entries()
         if low is not None}
    assert sorted(t) == sorted(j)
    tplan, jplan = tps.build_dedup_plan(t), jps.build_dedup_plan(j)
    assert _plan_view(tplan) == _plan_view(jplan)
    shared = [g for g in tplan.groups.values() if g.total_sites >= 2]
    assert shared and tplan.rewritten
    assert set(tplan.groups[shared[0].digest].members) >= set(DEDUP_KINDS)


def test_shadow_twin_plan_equals_the_reference():
    """A staged twin of the whole library: the plan spans versions, with
    groups of both ekinds, and equals the reference's."""
    (td, jd), (ct, cj) = _pair()
    for c in (ct, cj):
        _with_shadow_twins(c)
    t = {k: (td._state(TARGET).templates[k].vectorized,
             td._kind_constraints(td._state(TARGET), k))
         for k in td._state(TARGET).templates}
    j = {k: (jd._state(TARGET).templates[k].vectorized,
             jd._kind_constraints(jd._state(TARGET), k))
         for k in jd._state(TARGET).templates}
    tplan, jplan = tps.build_dedup_plan(t), jps.build_dedup_plan(j)
    assert _plan_view(tplan) == _plan_view(jplan)
    assert {g.ekind for g in tplan.groups.values()} == {"r", "e"}
    assert tps.cross_version_groups(tplan) == jps.cross_version_groups(jplan)
    assert tps.cross_version_groups(tplan)["groups_cross_version"] > 0


def test_analyze_policy_set_equals_the_reference():
    def view(report):
        return {**report, "findings": [
            (d.code, d.severity, d.message, d.location.file)
            for d in report["findings"]]}
    assert view(tps.analyze_policy_set(tprobe._library_entries())) == \
        view(jps.analyze_policy_set(jprobe._library_entries()))


def test_shadow_kind_helpers_equal_the_reference():
    for kind in ("K8sFoo", "K8sFoo__WHATIF__v2"):
        assert tps.split_shadow_kind(kind) == jps.split_shadow_kind(kind)
        assert tps.is_shadow_kind(kind) == jps.is_shadow_kind(kind)
    assert tps.shadow_kind("K8sFoo", "v-2_x") == \
        jps.shadow_kind("K8sFoo", "v-2_x")
    for bad in (("K8sFoo__WHATIF__a", "b"), ("K8sFoo", "bad tag"),
                ("K8sFoo", "")):
        with pytest.raises(ValueError):
            tps.shadow_kind(*bad)


# ---------------------------------------------------------------------------
# the host twin


def test_every_shared_column_equals_the_plain_evaluator_and_the_reference():
    """Every group of the library and its shadow twin, each member: the
    port's twin column over the port's bound arrays equals the same
    node's fires in the port's plain evaluator, and the reference twin's
    column over the reference's bound arrays of the same store."""
    (td, jd), (ct, cj) = _pair()
    for c in (ct, cj):
        _with_shadow_twins(c)
        c.add_data_batch(make_mixed(random.Random(11), 150))
        c.audit(limit_per_constraint=20, full=True)
    tst, jst = td._state(TARGET), jd._state(TARGET)
    tplan = td._dedup_plan_memo[TARGET][1]
    jplan = jd._dedup_plan_memo[TARGET][1]
    checked = 0
    for digest, g in tplan.groups.items():
        for kind, m in g.members.items():
            tb = tst.bindings_cache[kind][1]
            jb = jst.bindings_cache[kind][1]
            prog = tplan.originals[kind]
            col = tps.eval_shared_host(prog, m.node_idx, tb.arrays, g.ekind)
            ref = jps.eval_shared_host(jplan.originals[kind], m.node_idx,
                                       jb.arrays, g.ekind)
            ev = tex._Evaluator(prog, {nm: torch.from_numpy(
                np.ascontiguousarray(a)) for nm, a in tb.arrays.items()})
            # constraint row 0 (a shared subtree is constraint-uniform)
            f = tex._fires(ev.node(m.node_idx))[0].numpy()
            plain = f if g.ekind == "e" else f[:, 0]
            assert col.dtype == np.bool_ and col.shape == plain.shape
            assert np.array_equal(col, plain), (kind, digest)
            assert np.array_equal(col, ref), (kind, digest)
            checked += 1
    assert checked >= 2 * len(tplan.groups)


def test_row_sliced_twin_equals_the_whole_column():
    (td, _jd), (ct, _cj) = _pair()
    _dedup_set(ct)
    ct.add_data_batch(make_mixed(random.Random(3), 120))
    ct.audit(limit_per_constraint=20, full=True)
    plan = td._dedup_plan_memo[TARGET][1]
    rows = np.array([0, 5, 7, 64, 119])
    for g in plan.groups.values():
        for kind, m in g.members.items():
            arrays = td._state(TARGET).bindings_cache[kind][1].arrays
            whole = tps.eval_shared_host(plan.originals[kind], m.node_idx,
                                         arrays, g.ekind)
            part = tps.eval_shared_host(plan.originals[kind], m.node_idx,
                                        arrays, g.ekind, rows=rows)
            assert np.array_equal(part, whole[rows])


# ---------------------------------------------------------------------------
# the sweep (tests/test_policyset.py TestDedup)


def _dedup_sweep(monkeypatch, driver_cls, dedup: str, resources):
    monkeypatch.setenv("GATEKEEPER_DEDUP", dedup)
    if driver_cls is TorchDriver:
        d = TorchDriver(device="cpu")
        c = TBackend(d).new_client([TTarget()])
    else:
        d = JaxDriver()
        c = JBackend(d).new_client([JTarget()])
    _dedup_set(c)
    c.add_data_batch(resources)
    resp = c.audit(limit_per_constraint=50, full=True)
    return _verdicts(resp.results()), _stanza(d.last_sweep_phases), d


@pytest.mark.parametrize("rows", [200, 40])
def test_sweep_parity_and_savings(monkeypatch, rows):
    resources = make_mixed(random.Random(11), rows)
    v_off, st_off, _ = _dedup_sweep(monkeypatch, TorchDriver, "off",
                                    resources)
    v_on, st_on, td = _dedup_sweep(monkeypatch, TorchDriver, "on",
                                   resources)
    j_on, jst_on, _ = _dedup_sweep(monkeypatch, JaxDriver, "on", resources)
    j_off, jst_off, _ = _dedup_sweep(monkeypatch, JaxDriver, "off",
                                     resources)
    assert st_off == jst_off == {"enabled": False}
    assert v_on == v_off == j_on == j_off
    assert st_on == jst_on
    assert st_on["enabled"] is True
    assert st_on["subprograms_shared"] >= 1
    assert st_on["evaluations_saved"] > 0
    snap = td.metrics.snapshot()
    assert snap["dedup_shared_subprograms"] == st_on["subprograms_shared"]
    assert snap["dedup_evaluations_saved"] == st_on["evaluations_saved"]
    # the shared columns are uploaded with the kinds' bindings, and
    # leave them when the sweep ends
    phases = td.last_sweep_phases
    st = td._state(TARGET)
    plan = td._dedup_plan_memo[TARGET][1]
    shared = sum(st.dedup_shared_cache[d][2].nbytes
                 for k in plan.rewritten for d in plan.kind_digests[k])
    assert shared > 0
    assert phases["h2d_bytes"] == shared + sum(
        b.nbytes() for _k, b in st.bindings_cache.values())
    assert not any(nm.startswith("__shared__:")
                   for _k, b in st.bindings_cache.values()
                   for nm in b.arrays)


@pytest.mark.parametrize("stage8", ["warn", "off"])
def test_library_sweeps_with_twins_equal_the_reference(monkeypatch, stage8):
    """The library beside its shadow twin, forced full sweeps with
    dedup on: results and the ``dedup`` and ``whatif`` stanzas equal the
    reference's, in the Stage-8 dispatch order (the default) and in
    sorted order."""
    monkeypatch.setenv("GATEKEEPER_HBM_BUDGET", stage8)
    (td, jd), (ct, cj) = _pair()
    for c in (ct, cj):
        _with_shadow_twins(c)
        c.add_data_batch(make_mixed(random.Random(5), 80))
    for _ in range(2):
        got = _verdicts(ct.audit(limit_per_constraint=20,
                                 full=True).results())
        assert got == _verdicts(cj.audit(limit_per_constraint=20,
                                         full=True).results())
        assert _stanza(td.last_sweep_phases) == _stanza(jd.last_sweep_phases)
        assert td.last_sweep_phases["whatif"] == jd.last_sweep_phases["whatif"]


def test_churned_full_sweep_splices_dirty_rows():
    """A second full sweep after a churn of a few rows re-evaluates only
    their slice of each shared column, as the reference does, and
    both equal the oracle."""
    (td, jd), (ct, cj) = _pair()
    resources = make_mixed(random.Random(11), 200)
    for c in (ct, cj):
        _dedup_set(c)
        c.add_data_batch(resources)
        c.audit(limit_per_constraint=20, full=True)
    churn = random.Random(4)
    for r in churn.sample(resources, 6):
        r = copy.deepcopy(r)
        spec = r.setdefault("spec", {})
        spec["serviceAccountName"] = "churned"
        spec["automountServiceAccountToken"] = churn.random() < 0.5
        for c in (ct, cj):
            c.add_data(copy.deepcopy(r))
    got = _verdicts(ct.audit(limit_per_constraint=20, full=True).results())
    assert got == _verdicts(cj.audit(limit_per_constraint=20,
                                     full=True).results())
    assert _stanza(td.last_sweep_phases) == _stanza(jd.last_sweep_phases)
    t_delta = td.metrics.snapshot().get("dedup_shared_delta_evals", 0)
    j_delta = jd.metrics.snapshot().get("dedup_shared_delta_evals", 0)
    assert t_delta == j_delta > 0
    # the spliced column equals a whole re-evaluation
    plan = td._dedup_plan_memo[TARGET][1]
    st = td._state(TARGET)
    for digest, g in plan.groups.items():
        kind, m = next(iter(g.members.items()))
        whole = tps.eval_shared_host(plan.originals[kind], m.node_idx,
                                     st.bindings_cache[kind][1].arrays,
                                     g.ekind)
        assert np.array_equal(st.dedup_shared_cache[digest][2], whole)


def test_a_twin_exception_ends_the_sweep(monkeypatch):
    (td, _jd), (ct, _cj) = _pair()
    _dedup_set(ct)
    ct.add_data_batch(make_mixed(random.Random(11), 60))

    def boom(*a, **kw):
        raise RuntimeError("twin failed")
    monkeypatch.setattr(tps, "eval_shared_host", boom)
    with pytest.raises(RuntimeError, match="twin failed"):
        ct.audit(limit_per_constraint=20, full=True)


def test_a_plan_build_exception_ends_the_sweep(monkeypatch):
    (td, _jd), (ct, _cj) = _pair()
    _dedup_set(ct)
    ct.add_data_batch(make_mixed(random.Random(11), 60))

    def boom(*a, **kw):
        raise RuntimeError("plan failed")
    monkeypatch.setattr(tps, "build_dedup_plan", boom)
    with pytest.raises(RuntimeError, match="plan failed"):
        ct.audit(limit_per_constraint=20, full=True)
    # a memoized sweep builds no plan
    ct.audit(limit_per_constraint=20)


def test_a_shape_mismatch_keeps_the_original_program(monkeypatch):
    resources = make_mixed(random.Random(11), 60)
    want, _st, _ = _dedup_sweep(monkeypatch, TorchDriver, "off", resources)
    orig = TorchDriver._shared_col

    def short(self, *a, **kw):
        return orig(self, *a, **kw)[:-1]
    monkeypatch.setattr(TorchDriver, "_shared_col", short)
    got, st, td = _dedup_sweep(monkeypatch, TorchDriver, "on", resources)
    assert got == want
    n = td.metrics.snapshot()["dedup_fallbacks"]
    assert n == len(td._dedup_plan_memo[TARGET][1].rewritten) > 0
    assert st["subprograms_shared"] == 0 and st["evaluations_saved"] == 0


def test_prepare_audit_builds_the_plan(monkeypatch):
    (td, jd), (ct, cj) = _pair()
    for c in (ct, cj):
        _dedup_set(c)
        c.add_data_batch(make_mixed(random.Random(2), 40))
    assert td.prepare_audit(TARGET) is True
    assert jd.prepare_audit(TARGET) is True
    assert _plan_view(td._dedup_plan_memo[TARGET][1]) == \
        _plan_view(jd._dedup_plan_memo[TARGET][1])
    monkeypatch.setenv("GATEKEEPER_DEDUP", "off")
    assert td.prepare_audit(TARGET) is False
    assert TorchDriver(device="cpu").prepare_audit(TARGET) is False


# ---------------------------------------------------------------------------
# the warms compile the rewritten programs' variants


def _sig(arrays):
    return sorted((nm, str(a.dtype), tuple(a.shape))
                  for nm, a in arrays.items())


def test_the_delta_warm_targets_the_full_sweeps_variants(monkeypatch):
    """After a capped sweep the delta warm also warms each rewritten
    program, with the ingest warm's items (``_rewritten_warm_items``),
    over arrays of the names, dtypes and shapes the next forced full
    sweep's K1 launch passes (K1's variant keys on them)."""
    from types import SimpleNamespace
    from gatekeeper_tpu_torch.kernels import ir_eval
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")     # the legacy route
    (td, _jd), (ct, _cj) = _pair()
    _dedup_set(ct)
    ct.add_data_batch(make_mixed(random.Random(2), 60))
    started = []
    monkeypatch.setattr(td, "device", SimpleNamespace(type="cuda"))
    monkeypatch.setattr(td, "_start_delta_warm",
                        lambda items, rewritten, st_: started.append(
                            (st_, items, rewritten)))
    ct.audit(limit_per_constraint=20)
    monkeypatch.setattr(td, "device", torch.device("cpu"))
    st = td._state(TARGET)
    plan = td._audit_dedup_plan(st, TARGET)
    [(st_, items, rewritten)] = started
    assert st_ is st and len(items) == len(DEDUP_KINDS)
    assert [it[:2] for it in rewritten] == \
        [(k, plan.rewritten[k]) for k in sorted(plan.rewritten)]
    warmed = {}
    monkeypatch.setattr(td.executor, "device",
                        SimpleNamespace(type="cuda"))
    monkeypatch.setattr(ir_eval, "warm_mask", lambda prog, d: warmed.
                        setdefault(id(prog), _sig(d)))
    monkeypatch.setattr(tex._topk, "load", lambda: None)
    monkeypatch.setattr(tex._dfa, "load", lambda: None)
    for item in rewritten:
        td._warm_item(st, item)
    monkeypatch.setattr(td.executor, "device", torch.device("cpu"))
    monkeypatch.setattr(ir_eval, "warm_mask", None)
    launched = {}
    orig = ir_eval.eval_mask

    def record(prog, d):
        launched.setdefault(id(prog), _sig(d))
        return orig(prog, d)
    # the wrapper counts on the function its module's name refers to
    record.launches = record.plain_calls = 0
    monkeypatch.setattr(ir_eval, "eval_mask", record)
    ct.audit(limit_per_constraint=20, full=True)
    assert set(warmed) == {id(p) for p in plan.rewritten.values()}
    for key, sig in warmed.items():
        assert launched[key] == sig


def test_a_capped_sweep_after_a_full_sweep_passes_its_earlier_arrays(
        monkeypatch):
    """The shared columns leave the bindings when the forced full sweep
    ends: each member kind's next capped sweep passes K1 or K5 the
    array names, dtypes and shapes that its capped sweep passed before
    the full sweep (a variant already built), not the dead columns."""
    from gatekeeper_tpu_torch.kernels import ir_eval
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")     # the legacy route
    (td, _jd), (ct, _cj) = _pair()
    _dedup_set(ct)
    objs = make_mixed(random.Random(2), 60)
    ct.add_data_batch(objs)
    seen: list = []
    for name in ("eval_mask", "delta_mask"):
        orig = getattr(ir_eval, name)

        def record(prog, d, *a, _orig=orig, **kw):
            seen.append((prog.cache_key(), tuple(_sig(d))))
            return _orig(prog, d, *a, **kw)
        record.launches = record.plain_calls = 0
        monkeypatch.setattr(ir_eval, name, record)
    ct.audit(limit_per_constraint=20)
    before = set(seen)
    assert len(before) == len(DEDUP_KINDS)
    ct.audit(limit_per_constraint=20, full=True)
    assert td.last_sweep_phases["dedup"]["subprograms_shared"] >= 1
    assert any(nm.startswith("__shared__:") for _k, sig in seen[len(before):]
               for nm, _dt, _sh in sig)
    st = td._state(TARGET)
    assert not any(nm.startswith("__shared__:")
                   for _k, b in st.bindings_cache.values()
                   for nm in b.arrays)
    # each member keeps the rewrite's mask as its own program's: a capped
    # sweep with no churn launches no kernel that evaluates
    evals = (td.executor.mask_evals, td.executor.delta_evals)
    ct.audit(limit_per_constraint=20)
    assert (td.executor.mask_evals, td.executor.delta_evals) == evals
    # then one after churn: K5 on the members, over their earlier arrays
    for i in range(2):
        o = copy.deepcopy(objs[i])
        o.setdefault("spec", {})["serviceAccountName"] = f"churned-{i}"
        ct.add_data(o)
    del seen[:]
    for _ in range(2):
        ct.audit(limit_per_constraint=20)
    assert seen and set(seen) <= before
    assert td.executor.mask_evals == evals[0]


def test_the_ingest_warm_queues_each_rewritten_program(monkeypatch):
    from types import SimpleNamespace
    (td, _jd), (ct, _cj) = _pair()
    _dedup_set(ct)
    ct.add_data_batch(make_mixed(random.Random(2), 60))
    st = td._state(TARGET)
    queued = []
    monkeypatch.setattr(td, "device", SimpleNamespace(type="cuda"))
    monkeypatch.setattr(td, "_start_ingest_warm",
                        lambda st_, items: queued.extend(items))
    td._materialize_mirror(st, TARGET)
    plan = td._dedup_plan_memo[TARGET][1]
    rewritten = [it for it in queued if it[4] is not None]
    assert sorted(it[0] for it in rewritten) == sorted(plan.rewritten)
    for kind, prog, bindings, _wm, extra in rewritten:
        assert prog is plan.rewritten[kind]
        assert extra == {plan.groups[d].binding: (bindings.r_pad,)
                         for d in plan.kind_digests[kind]}
    queued.clear()
    monkeypatch.setenv("GATEKEEPER_DEDUP", "off")
    td._materialize_mirror(st, TARGET)
    assert all(it[4] is None for it in queued)
