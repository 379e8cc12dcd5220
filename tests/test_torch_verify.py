"""Stage-2 IR verification in the port (analysis/ir_verifier.py and
``TorchDriver._verify_lowered``) against the JAX reference, on the CPU.

- The tamper cases of tests/test_analysis.py ``TestIRVerifier`` run
  through both verifiers, on programs lowered by each package: equal
  diagnostics (code, severity, message).
- A tampered program installed in TorchDriver(device="cpu") under the
  default ``GATEKEEPER_IR_VERIFY`` is pinned to the scalar oracle, as in
  JaxDriver: results equal LocalDriver's and no kernel wrapper runs;
  ``strict`` raises VetError on both; ``off`` installs it unchecked.
"""

import dataclasses
import random

import pytest

from gatekeeper_tpu.analysis import ir_verifier as jverifier
from gatekeeper_tpu.analysis import verify_program as jverify
from gatekeeper_tpu.api.templates import compile_target_rego as jcompile
from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.engine import jax_driver
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.errors import VetError as JVetError
from gatekeeper_tpu.ir import program as jprogram
from gatekeeper_tpu.ir.lower import CannotLower as JCannotLower
from gatekeeper_tpu.ir.lower import lower_template as jlower
from gatekeeper_tpu.library import LIBRARY as JLIBRARY
from gatekeeper_tpu.library import all_docs as jall_docs
from gatekeeper_tpu.library import make_mixed
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch.analysis import ir_verifier as tverifier
from gatekeeper_tpu_torch.analysis import verify_program as tverify
from gatekeeper_tpu_torch.api.templates import compile_target_rego as tcompile
from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.client.interface import QueryOpts as TOpts
from gatekeeper_tpu_torch.client.local_driver import LocalDriver
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.errors import VetError as TVetError
from gatekeeper_tpu_torch.ir import program as tprogram
from gatekeeper_tpu_torch.ir.lower import CannotLower as TCannotLower
from gatekeeper_tpu_torch.ir.lower import lower_template as tlower
from gatekeeper_tpu_torch.kernels import ir_eval
from gatekeeper_tpu_torch.library import LIBRARY as TLIBRARY
from gatekeeper_tpu_torch.library import all_docs as tall_docs
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget

from gatekeeper_tpu.client.interface import QueryOpts as JOpts

TARGET = "admission.k8s.gatekeeper.sh"

# (reference compile, lower, Node, Program, verify) and the port's
SIDES = ((jcompile, jlower, jprogram.Node, jprogram.Program, jverify,
          JLIBRARY),
         (tcompile, tlower, tprogram.Node, tprogram.Program, tverify,
          TLIBRARY))


def _lower(side, kind):
    compile_, lower, _n, _p, _v, library = side
    rego, _params = library[kind]
    ct = compile_(kind, TARGET, rego)
    return lower(ct.module, ct.interp)


def _tamper(side, lp, nodes):
    _c, _l, _n, program, _v, _lib = side
    return dataclasses.replace(lp, program=program(
        nodes=tuple(nodes), rules=lp.program.rules))


# each takes (Node class, the program's nodes) -> tampered nodes

def _dangling_table_ref(node, nodes):
    return [node("table", n.args, ("t_nope",)) if n.op == "table" else n
            for n in nodes]


def _unknown_op(node, nodes):
    return list(nodes) + [node("frob", (), ())]


def _arity_shape_mismatch(node, nodes):
    return [node("and", (n.args[0],), n.meta) if n.op == "not" else n
            for n in nodes]


def _forward_reference(node, nodes):
    nodes = list(nodes)
    i = next(i for i, n in enumerate(nodes) if n.args)
    nodes[i] = node(nodes[i].op, (len(nodes) + 3,) + nodes[i].args[1:],
                    nodes[i].meta)
    return nodes


def _cmp_type_mismatch(node, nodes):
    nodes = list(nodes)
    b = next(i for i, n in enumerate(nodes)
             if n.op in ("table", "not", "in_cset"))
    return nodes + [node("cmp", (b, b), ("<",))]


def _gather_src_mismatch(node, nodes):
    """A gather of the program's table indexed by a computed node rather
    than the column the table was built over (appended, so the index
    node precedes it whatever the program's order)."""
    nodes = list(nodes)
    ti = next(i for i, n in enumerate(nodes) if n.op == "table")
    ci = next(i for i, n in enumerate(nodes) if n.op != "input")
    return nodes + [node("table", (ci,), nodes[ti].meta)]


TAMPERS = {
    "dangling_table_ref": ("K8sDisallowLatestTag", _dangling_table_ref,
                           {"ir_dangling_ref"}),
    "unknown_op": ("K8sAllowedRepos", _unknown_op, {"ir_unknown_op"}),
    "arity_shape_mismatch": ("K8sAllowedRepos", _arity_shape_mismatch,
                             {"ir_shape_mismatch"}),
    "forward_reference_breaks_ssa": ("K8sAllowedRepos", _forward_reference,
                                     {"ir_dangling_ref"}),
    "cmp_type_mismatch": ("K8sAllowedRepos", _cmp_type_mismatch,
                          {"ir_type_mismatch"}),
    "gather_src_mismatch": ("K8sDisallowLatestTag", _gather_src_mismatch,
                            {"ir_shape_mismatch", "ir_type_mismatch"}),
}


def _diag_tuples(diags):
    return [(d.code, d.severity, d.message, d.location.file)
            for d in diags]


def _tampered(side, case):
    kind, fn, _codes = TAMPERS[case]
    lp = _lower(side, kind)
    return _tamper(side, lp, fn(side[2], lp.program.nodes))


@pytest.mark.parametrize("case", sorted(TAMPERS))
def test_tampered_program_diagnostics_match_reference(case):
    kind, _fn, codes = TAMPERS[case]
    got, want = (_tampered(side, case) for side in reversed(SIDES))
    assert got.program != _lower(SIDES[1], kind).program
    td = tverify(got, file=kind)
    jd = jverify(want, file=kind)
    assert _diag_tuples(td) == _diag_tuples(jd)
    assert codes & {d.code for d in td}
    assert all(d.severity == "error" for d in td)


def test_library_programs_verify_clean_on_both():
    """Every library program either lowers on both sides and verifies
    clean on both, or lowers on neither."""
    lowered = 0
    for kind in sorted(TLIBRARY):
        out = []
        for side, cannot in zip(SIDES, (JCannotLower, TCannotLower)):
            try:
                out.append(_lower(side, kind))
            except cannot:
                out.append(None)
        assert (out[0] is None) == (out[1] is None), kind
        if out[1] is None:
            continue
        lowered += 1
        assert jverify(out[0], file=kind) == []
        assert tverify(out[1], file=kind) == []
    assert lowered >= 40


def test_install_runs_the_verifier_on_every_lowered_program(monkeypatch):
    # a snapshot directory would serve the lowered IR from its tier and
    # skip lowering (and the verifier) on both drivers
    monkeypatch.delenv("GATEKEEPER_SNAPSHOT_DIR", raising=False)
    for mod in (jverifier, tverifier):
        mod.reset_counters()
    for drv, backend, target, docs in (
            (JaxDriver(), JBackend, JTarget, jall_docs),
            (TorchDriver(device="cpu"), TBackend, TTarget, tall_docs)):
        c = backend(drv).new_client([target()])
        for tdoc, _cdoc in docs():
            c.add_template(tdoc)
    assert tverifier.VERIFY_RUNS == jverifier.VERIFY_RUNS >= 40
    assert tverifier.VERIFY_VIOLATIONS == jverifier.VERIFY_VIOLATIONS == 0


# ---------------------------------------------------------------------------
# install-time wiring: both drivers with one tampered lowering


KIND = "K8sAllowedRepos"


def _tampered_lowering(side, real):
    """``lower_template`` that returns ``KIND``'s program with an
    ordering compare of a bool node appended (ir_type_mismatch) and
    lowers every other template as ``real`` does."""
    node = side[2]

    def lower(module, interp):
        lp = real(module, interp)
        if tuple(module.package)[-1] == KIND.lower():
            lp = _tamper(side, lp, _cmp_type_mismatch(node,
                                                      lp.program.nodes))
        return lp
    return lower


@pytest.fixture
def tampered(monkeypatch):
    monkeypatch.setattr(jax_driver, "lower_template",
                        _tampered_lowering(SIDES[0], jlower))
    monkeypatch.setattr(torch_driver, "lower_template",
                        _tampered_lowering(SIDES[1], tlower))
    monkeypatch.setattr(jax_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    monkeypatch.delenv("GATEKEEPER_IR_VERIFY", raising=False)
    monkeypatch.delenv("GATEKEEPER_SNAPSHOT_DIR", raising=False)


def _client(drv, backend, target, docs, kinds):
    c = backend(drv).new_client([target()])
    for tdoc, cdoc in docs():
        if tdoc["spec"]["crd"]["spec"]["names"]["kind"] in kinds:
            c.add_template(tdoc)
            c.add_constraint(cdoc)
    return c


def _results(results):
    return sorted((r.constraint["kind"], r.constraint["metadata"]["name"],
                   ((r.review or {}).get("object") or {}).get(
                       "metadata", {}).get("name"), r.msg)
                  for r in results)


KINDS = (KIND, "K8sRequiredLabels")


def test_tampered_program_takes_the_scalar_path(tampered):
    """Default GATEKEEPER_IR_VERIFY (fallback): the tampered kind is
    pinned to the scalar oracle on both drivers, the untampered one
    keeps its device program, and results equal LocalDriver's."""
    resources = make_mixed(random.Random(7), 80)
    jd, td, ld = JaxDriver(), TorchDriver(device="cpu"), LocalDriver()
    clients = [_client(jd, JBackend, JTarget, jall_docs, KINDS),
               _client(td, TBackend, TTarget, tall_docs, KINDS),
               _client(ld, TBackend, TTarget, tall_docs, KINDS)]
    for c in clients:
        c.add_data_batch([dict(o) for o in resources])
    for d in (jd, td):
        st = d._state(TARGET)
        assert st.templates[KIND].vectorized is None
        assert st.templates["K8sRequiredLabels"].vectorized is not None
    plain = ir_eval.eval_mask.plain_calls
    got = td.query_audit(TARGET, TOpts(limit_per_constraint=500))[0]
    # one device evaluation: K8sRequiredLabels only
    assert ir_eval.eval_mask.plain_calls == plain + 1
    want = ld.query_audit(TARGET, TOpts(limit_per_constraint=500))[0]
    ref = jd.query_audit(TARGET, JOpts(limit_per_constraint=500))[0]
    assert _results(got) == _results(want) == _results(ref)
    assert any(k == KIND for k, *_ in _results(got))


def test_strict_mode_raises(tampered, monkeypatch):
    monkeypatch.setenv("GATEKEEPER_IR_VERIFY", "strict")
    for drv, backend, target, docs, err in (
            (JaxDriver(), JBackend, JTarget, jall_docs, JVetError),
            (TorchDriver(device="cpu"), TBackend, TTarget, tall_docs,
             TVetError)):
        with pytest.raises(err) as ei:
            _client(drv, backend, target, docs, (KIND,))
        assert ei.value.code == "ir_type_mismatch"


def test_off_mode_installs_unchecked(tampered, monkeypatch):
    monkeypatch.setenv("GATEKEEPER_IR_VERIFY", "off")
    for drv, backend, target, docs in (
            (JaxDriver(), JBackend, JTarget, jall_docs),
            (TorchDriver(device="cpu"), TBackend, TTarget, tall_docs)):
        _client(drv, backend, target, docs, (KIND,))
        lp = drv._state(TARGET).templates[KIND].vectorized
        assert lp is not None
        assert lp.program.nodes[-1].op == "cmp"
        assert lp.program.nodes[-1].meta == ("<",)
