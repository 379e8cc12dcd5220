"""Stage 4 of the port (translation validation over the small-model
worlds, analysis/transval.py + analysis/smallmodel.py) and the
footprint validator's strict mode (analysis/footprint.py), against the
JAX reference, on the CPU.

The port evaluates each world's lowered side with the evaluator that
serves on the driver's device (``transval._device_mask``: a
``ProgramExecutor`` of that device, so K1's plain version here); the
reference evaluates it eagerly (``veval._eval_program``).  Every
comparison is exact:

- on each of the 48 lowered library templates, the port's certificate
  equals the reference's (models, constraints, over-approximations,
  excusals, truncation, budget), and so does the seeded miscompile's
  result (the minimized counterexample: resources, focus, constraint,
  expected, actual, note);
- the plan and the worlds themselves (``derive_plan``,
  ``enumerate_models``) equal the reference's;
- every corpus case replays to the reference's outcome, clean on the
  current compiler and dirty on a miscompiled one;
- the driver: ``strict`` pins a refuted kind to the scalar oracle with
  results equal to ``LocalDriver``'s, ``warn`` serves on the device, a
  second driver over the ``cert`` tier validates nothing, the driver's
  own device reaches ``_device_mask``, a host-side analysis error is
  contained and a launch error inside ``_device_mask`` ends the install;
- the reconciler writes the reference's ``translation_unvalidated``
  status;
- footprint strict: ``validate_footprint`` on every library template
  gives the reference's findings (none), a seeded under-claim is caught
  on both, and the driver refuses that install on both.
"""

import dataclasses
import os
import random

import pytest
import torch

from gatekeeper_tpu.analysis import footprint as jfootprint
from gatekeeper_tpu.analysis import smallmodel as jsmall
from gatekeeper_tpu.analysis import transval as jtv
from gatekeeper_tpu.api.templates import compile_target_rego as jcompile
from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.cluster.fake import FakeCluster as JFakeCluster
from gatekeeper_tpu.controllers.constrainttemplate import \
    TEMPLATE_GVK as JTEMPLATE_GVK
from gatekeeper_tpu.controllers.registry import add_to_manager as jadd
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.errors import VetError as JVetError
from gatekeeper_tpu.ir.lower import CannotLower as JCannotLower
from gatekeeper_tpu.ir.lower import lower_template as jlower
from gatekeeper_tpu.library import all_docs as jall_docs
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget
from gatekeeper_tpu.utils.ha_status import get_ha_status as jget_status

from gatekeeper_tpu_torch.analysis import footprint as tfootprint
from gatekeeper_tpu_torch.analysis import smallmodel as tsmall
from gatekeeper_tpu_torch.analysis import transval as ttv
from gatekeeper_tpu_torch.api.templates import compile_target_rego as tcompile
from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.client.local_driver import LocalDriver
from gatekeeper_tpu_torch.cluster.fake import FakeCluster as TFakeCluster
from gatekeeper_tpu_torch.controllers.constrainttemplate import \
    TEMPLATE_GVK as TTEMPLATE_GVK
from gatekeeper_tpu_torch.controllers.registry import add_to_manager as tadd
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.errors import VetError as TVetError
from gatekeeper_tpu_torch.ir.lower import CannotLower as TCannotLower
from gatekeeper_tpu_torch.ir.lower import lower_template as tlower
from gatekeeper_tpu_torch.kernels import ir_eval
from gatekeeper_tpu_torch.library import all_docs as tall_docs
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget
from gatekeeper_tpu_torch.utils.ha_status import get_ha_status as tget_status

TARGET = "admission.k8s.gatekeeper.sh"
CORPUS = os.path.join(os.path.dirname(__file__), "corpus", "transval")
ENV = ("GATEKEEPER_TRANSVAL", "GATEKEEPER_TRANSVAL_TEST_MISCOMPILE",
       "GATEKEEPER_TRANSVAL_MODELS", "GATEKEEPER_SNAPSHOT_DIR",
       "GATEKEEPER_FOOTPRINT", "GATEKEEPER_FOOTPRINT_TEST_NARROW",
       "GATEKEEPER_FOOTPRINT_MODELS")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Validator and footprint state is process-global on both sides."""
    for tv in (jtv, ttv):
        monkeypatch.setattr(tv, "failures", {})
        monkeypatch.setattr(tv, "_memo", {})
        monkeypatch.setattr(tv, "validations_run", 0)
    for fp in (jfootprint, tfootprint):
        monkeypatch.setattr(fp, "_memo", {})
        monkeypatch.setattr(fp, "cross_row", {})
        monkeypatch.setattr(fp, "violations", {})
        monkeypatch.setattr(fp, "analyses_run", 0)
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)


def _library() -> dict:
    """kind -> (template doc, sample constraint doc) of the library."""
    return {t["spec"]["crd"]["spec"]["names"]["kind"]: (t, c)
            for t, c in tall_docs()}


def _compiled(side: str, kind: str):
    """(compiled, lowered or None) of one library kind on one side."""
    tdoc = (_library() if side == "port" else
            {t["spec"]["crd"]["spec"]["names"]["kind"]: (t, c)
             for t, c in jall_docs()})[kind][0]
    tt = tdoc["spec"]["targets"][0]
    compile_, lower, cannot = ((tcompile, tlower, TCannotLower)
                               if side == "port" else
                               (jcompile, jlower, JCannotLower))
    compiled = compile_(kind, tt["target"], tt["rego"])
    try:
        return compiled, lower(compiled.module, compiled.interp)
    except cannot:
        return compiled, None


LOWERED = sorted(k for k in _library() if _compiled("port", k)[1] is not None)


def _fields(result) -> dict:
    """A certificate or counterexample as a dict, less the digest (a
    hash over each package's own program repr)."""
    d = dataclasses.asdict(result)
    d.pop("digest", None)
    d["type"] = type(result).__name__
    return d


def test_the_library_lowers_48_templates():
    assert len(LOWERED) == 48
    assert LOWERED == sorted(k for k in _library()
                             if _compiled("ref", k)[1] is not None)


# ---------------------------------------------------------------------------
# the validator, template by template


@pytest.mark.parametrize("kind", LOWERED)
def test_certificate_equals_reference(kind):
    """The sample constraint (and its numeric-bumped twin) over the
    bounded universe: the port certifies exactly as the reference."""
    cdoc = _library()[kind][1]
    jc, jl = _compiled("ref", kind)
    tc, tl = _compiled("port", kind)
    ref = jtv.validate_template(kind, jc, jl, [cdoc])
    got = ttv.validate_template(kind, tc, tl, [cdoc], device="cpu")
    assert isinstance(got, ttv.Certificate)
    assert _fields(got) == _fields(ref)
    assert got.models_checked >= 4


@pytest.mark.parametrize("kind", LOWERED)
def test_miscompile_result_equals_reference(kind):
    """The seeded miscompile (the first compare flipped, or the first
    and/or swapped): the port's result equals the reference's, the
    minimized counterexample field for field.  Programs with no such
    node raise on both."""
    cdoc = _library()[kind][1]
    jc, jl = _compiled("ref", kind)
    tc, tl = _compiled("port", kind)
    try:
        jbad = jtv.miscompile(jl)
    except ValueError:
        with pytest.raises(ValueError, match="no miscompilable node"):
            ttv.miscompile(tl)
        return
    ref = jtv.validate_template(kind, jc, jbad, [cdoc])
    got = ttv.validate_template(kind, tc, ttv.miscompile(tl), [cdoc],
                                device="cpu")
    assert _fields(got) == _fields(ref)
    if isinstance(got, ttv.Counterexample):
        assert ttv.failure_for(kind) is got
        assert got.expected and not got.actual


@pytest.mark.parametrize("kind", ["K8sAllowedRepos", "K8sContainerLimits",
                                  "K8sReplicaLimits", "K8sImageDigests",
                                  "K8sUniqueIngressHost"])
def test_worlds_equal_reference(kind):
    """derive_plan's slots and the enumerated worlds equal the
    reference's (the absent sentinel compared by position)."""
    cdoc = _library()[kind][1]
    jc, jl = _compiled("ref", kind)
    tc, tl = _compiled("port", kind)

    def norm(v, absent):
        return "<absent>" if v is absent else v

    plans = []
    for mod, tv, c, low in ((jsmall, jtv, jc, jl), (tsmall, ttv, tc, tl)):
        cons = tv.expand_constraints(kind, [cdoc])
        plan = mod.derive_plan(low, cons, module=c.module)
        models = mod.enumerate_models(plan, 96)
        plans.append((
            [(s.kind, s.path, s.axis, s.default,
              [norm(v, mod.ABSENT) for v in s.domain]) for s in plan.slots],
            plan.axes, plan.truncated,
            [(m.resources, m.focus, m.note) for m in models]))
    assert plans[1] == plans[0]


def test_install_time_default_constraint():
    """No sample docs (install time): the universe runs over the empty
    parameter document, as the reference's."""
    kind = "K8sRequiredLabels"
    jc, jl = _compiled("ref", kind)
    tc, tl = _compiled("port", kind)
    got = ttv.certify(kind, tc, tl, device="cpu")
    assert _fields(got) == _fields(jtv.certify(kind, jc, jl))
    assert got.constraints_checked == 1


# ---------------------------------------------------------------------------
# the corpus


def _corpus() -> list:
    cases = ttv.load_corpus(CORPUS)
    assert cases == jtv.load_corpus(CORPUS)
    return cases


@pytest.mark.parametrize("name", [n for n, _ in
                                  ttv.load_corpus(CORPUS)])
def test_corpus_case_replays_as_the_reference(name):
    """Each case replays clean against the current compiler on both, and
    dirty, with the same description, against its miscompiled lowering."""
    case = dict(_corpus())[name]
    assert ttv.replay_case(case, device="cpu") is None
    assert jtv.replay_case(case) is None
    tc = tcompile(case["kind"], case["target"], case["rego"])
    jc = jcompile(case["kind"], case["target"], case["rego"])
    got = ttv.replay_case(
        case, lowered=ttv.miscompile(tlower(tc.module, tc.interp)),
        device="cpu")
    want = jtv.replay_case(
        case, lowered=jtv.miscompile(jlower(jc.module, jc.interp)))
    assert got == want and got is not None


def test_counterexample_corpus_round_trip(tmp_path):
    """A counterexample saved by the port loads and replays as one saved
    by the reference: the same file name and content."""
    kind = "K8sReplicaLimits"
    cdoc = _library()[kind][1]
    jc, jl = _compiled("ref", kind)
    tc, tl = _compiled("port", kind)
    got = ttv.validate_template(kind, tc, ttv.miscompile(tl), [cdoc],
                                device="cpu")
    ref = jtv.validate_template(kind, jc, jtv.miscompile(jl), [cdoc])
    tp = ttv.save_counterexample(str(tmp_path / "port"), got)
    jp = jtv.save_counterexample(str(tmp_path / "ref"), ref)
    assert os.path.basename(tp) == os.path.basename(jp)
    assert open(tp).read() == open(jp).read()
    (name, case), = ttv.load_corpus(str(tmp_path / "port"))
    assert ttv.replay_case(case, lowered=ttv.miscompile(tl),
                           device="cpu") is not None


# ---------------------------------------------------------------------------
# the driver

PIN_REGO = """package strictpin
violation[{"msg": msg}] {
  input.review.object.spec.replicas > 3
  msg := sprintf("too many replicas on %v",
                 [input.review.object.metadata.name])
}
"""


def _tdoc(kind, rego):
    return {"apiVersion": "templates.gatekeeper.sh/v1alpha1",
            "kind": "ConstraintTemplate",
            "metadata": {"name": kind.lower()},
            "spec": {"crd": {"spec": {"names": {"kind": kind}}},
                     "targets": [{"target": TARGET, "rego": rego}]}}


def _cdoc(kind, name="pin"):
    return {"apiVersion": "constraints.gatekeeper.sh/v1alpha1",
            "kind": kind, "metadata": {"name": name},
            "spec": {"parameters": {}}}


def _pods(n=8):
    return [{"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"p{i}", "namespace": "default"},
             "spec": {"replicas": i}} for i in range(n)]


def _pin_client(driver, backend=TBackend, target=TTarget):
    client = backend(driver).new_client([target()])
    client.add_template(_tdoc("StrictPin", PIN_REGO))
    client.add_constraint(_cdoc("StrictPin"))
    for p in _pods():
        client.add_data(p)
    results = sorted(
        (r.msg, (r.resource or {}).get("metadata", {}).get("name", ""))
        for r in client.audit().results())
    return client, results


def test_strict_pins_a_refuted_kind_to_the_scalar_oracle(monkeypatch):
    """strict + the miscompile seam: on both drivers the kind is pinned
    exactly like a template that never lowered, and the port's results
    equal LocalDriver's and the reference's."""
    monkeypatch.setenv("GATEKEEPER_TRANSVAL", "strict")
    monkeypatch.setenv("GATEKEEPER_TRANSVAL_TEST_MISCOMPILE", "StrictPin")
    drv = TorchDriver(device="cpu")
    _, got = _pin_client(drv)
    _, ref = _pin_client(JaxDriver(), JBackend, JTarget)
    assert drv.state[TARGET].templates["StrictPin"].vectorized is None
    assert drv.metrics.counter("transval_counterexamples").value == 1
    assert _fields(ttv.failure_for("StrictPin")) == \
        _fields(jtv.failure_for("StrictPin"))
    monkeypatch.delenv("GATEKEEPER_TRANSVAL")
    monkeypatch.delenv("GATEKEEPER_TRANSVAL_TEST_MISCOMPILE")
    _, oracle = _pin_client(LocalDriver())
    assert got == oracle == ref
    assert len(got) == 4                 # replicas 4..7 fire


def test_warn_serves_on_the_device_and_strict_keeps_clean_kinds(monkeypatch):
    monkeypatch.setenv("GATEKEEPER_TRANSVAL", "warn")
    monkeypatch.setenv("GATEKEEPER_TRANSVAL_TEST_MISCOMPILE", "StrictPin")
    drv = TorchDriver(device="cpu")
    before = ir_eval.eval_mask.plain_calls
    _, got = _pin_client(drv)
    assert drv.state[TARGET].templates["StrictPin"].vectorized is not None
    assert ttv.failure_for("StrictPin") is not None
    assert ir_eval.eval_mask.plain_calls > before
    monkeypatch.setenv("GATEKEEPER_TRANSVAL", "strict")
    monkeypatch.delenv("GATEKEEPER_TRANSVAL_TEST_MISCOMPILE")
    monkeypatch.setattr(ttv, "_memo", {})
    drv = TorchDriver(device="cpu")
    _pin_client(drv)
    assert drv.state[TARGET].templates["StrictPin"].vectorized is not None
    assert ttv.failure_for("StrictPin") is None
    assert drv.metrics.counter("transval_certified").value == 1


def test_library_install_certifies_every_lowered_template(monkeypatch):
    """strict over the whole library: both drivers certify every lowered
    template (48 validations), pin none, and serve equal results."""
    monkeypatch.setenv("GATEKEEPER_TRANSVAL", "strict")
    out = []
    for drv, backend, target, docs in (
            (JaxDriver(), JBackend, JTarget, jall_docs),
            (TorchDriver(device="cpu"), TBackend, TTarget, tall_docs)):
        c = backend(drv).new_client([target()])
        for tdoc, _cdoc_ in docs():
            c.add_template(tdoc)
        out.append(drv)
    assert ttv.validations_run == jtv.validations_run == 48
    assert out[1].metrics.counter("transval_certified").value == \
        out[0].metrics.counter("transval_certified").value == 48
    assert sorted(k for k, t in out[1].state[TARGET].templates.items()
                  if t.vectorized is not None) == LOWERED


def test_cert_tier_makes_a_warm_install_validate_nothing(monkeypatch,
                                                         tmp_path):
    monkeypatch.setenv("GATEKEEPER_TRANSVAL", "strict")
    monkeypatch.setenv("GATEKEEPER_SNAPSHOT_DIR", str(tmp_path))
    kinds = ("K8sRequiredLabels", "K8sAllowedRepos", "K8sReplicaLimits")
    lib = _library()

    def install():
        drv = TorchDriver(device="cpu")
        c = TBackend(drv).new_client([TTarget()])
        for k in kinds:
            c.add_template(lib[k][0])
        return drv

    install()
    assert ttv.validations_run == 3
    monkeypatch.setattr(ttv, "_memo", {})
    drv = install()
    assert ttv.validations_run == 3          # nothing validated warm
    assert drv.metrics.counter("transval_certified").value == 3


def test_the_drivers_device_reaches_the_worlds(monkeypatch):
    """_certify_lowered hands the driver's own device to the world
    evaluation (a certificate certifies the evaluator that serves)."""
    seen = []
    real = ttv._device_mask

    def spy(lowered, st, constraints, device):
        seen.append(torch.device(device))
        return real(lowered, st, constraints, device)

    monkeypatch.setattr(ttv, "_device_mask", spy)
    monkeypatch.setenv("GATEKEEPER_TRANSVAL", "warn")
    _pin_client(TorchDriver(device="cpu"))
    assert seen == [torch.device("cpu")]


def test_a_launch_error_in_the_worlds_ends_the_install(monkeypatch):
    """Deliberate difference from the reference (ROADMAP Queue C): an
    error raised by the evaluator's launch inside _device_mask is no
    analysis error, and propagates from put_template; nothing answers
    from another evaluator instead."""
    def boom(program, arrays):
        raise RuntimeError("K1 launch failed")

    monkeypatch.setattr(ir_eval, "eval_mask", boom)
    monkeypatch.setenv("GATEKEEPER_TRANSVAL", "strict")
    drv = TorchDriver(device="cpu")
    c = TBackend(drv).new_client([TTarget()])
    with pytest.raises(RuntimeError, match="K1 launch failed"):
        c.add_template(_tdoc("StrictPin", PIN_REGO))
    assert "StrictPin" not in drv.state[TARGET].templates
    assert drv.metrics.counter("transval_errors").value == 0


def test_a_host_side_analysis_error_is_contained(monkeypatch):
    """As in the reference: an error of the host-side analysis (here the
    world plan) is counted; strict pins the kind, warn serves it."""
    def broken(*a, **k):
        raise ValueError("plan failed")

    monkeypatch.setattr(ttv, "derive_plan", broken)
    for mode, pinned in (("strict", True), ("warn", False)):
        monkeypatch.setenv("GATEKEEPER_TRANSVAL", mode)
        drv = TorchDriver(device="cpu")
        _pin_client(drv)
        low = drv.state[TARGET].templates["StrictPin"].vectorized
        assert (low is None) is pinned
        assert drv.metrics.counter("transval_errors").value == 1


# ---------------------------------------------------------------------------
# the reconciler's status

STATUS_REGO = """package statuspin
violation[{"msg": msg}] {
  input.review.object.spec.replicas > 3
  msg := "too many"
}
"""


@pytest.mark.parametrize("seeded", [True, False])
def test_reconciler_status_equals_reference(seeded, monkeypatch):
    """strict: a refuted template gets the reference's
    ``translation_unvalidated`` error and is still admitted (scalar);
    a clean one gets no error."""
    monkeypatch.setenv("GATEKEEPER_TRANSVAL", "strict")
    if seeded:
        monkeypatch.setenv("GATEKEEPER_TRANSVAL_TEST_MISCOMPILE",
                           "StatusPin")
    statuses = []
    for fake, gvk, add, backend, driver, target, status in (
            (JFakeCluster, JTEMPLATE_GVK, jadd, JBackend, JaxDriver(),
             JTarget, jget_status),
            (TFakeCluster, TTEMPLATE_GVK, tadd, TBackend,
             TorchDriver(device="cpu"), TTarget, tget_status)):
        cluster = fake()
        cluster.register_kind(gvk, "constrainttemplates")
        plane = add(cluster, backend(driver).new_client([target()]))
        doc = _tdoc("StatusPin", STATUS_REGO)
        doc["metadata"]["name"] = "statuspin"
        cluster.create(doc)
        plane.run_until_idle()
        st = status(cluster.get(gvk, "statuspin"))
        statuses.append(st.get("errors"))
        assert "StatusPin" in plane.client.templates
        low = driver.state[TARGET].templates["StatusPin"].vectorized
        assert (low is None) is seeded
    assert statuses[1] == statuses[0]
    assert bool(statuses[1]) is seeded
    if seeded:
        assert statuses[1][0]["code"] == "translation_unvalidated"


# ---------------------------------------------------------------------------
# footprint strict


@pytest.mark.parametrize("kind", LOWERED)
def test_footprint_validation_equals_reference(kind):
    """validate_footprint over the small-model worlds (perturbing every
    unclaimed column) finds what the reference finds: nothing."""
    cdoc = _library()[kind][1]
    jc, jl = _compiled("ref", kind)
    tc, tl = _compiled("port", kind)
    jfp = jfootprint.analyze(kind, jl)
    tfp = tfootprint.analyze(kind, tl)
    ref = jfootprint.validate_footprint(kind, jc, jl, jfp, [cdoc])
    got = tfootprint.validate_footprint(kind, tc, tl, tfp, [cdoc],
                                        device="cpu")
    assert [dataclasses.asdict(v) for v in got] == \
        [dataclasses.asdict(v) for v in ref] == []


@pytest.mark.parametrize("kind", ["K8sRequiredLabels", "K8sAllowedRepos",
                                  "K8sContainerLimits", "K8sReplicaLimits"])
def test_a_narrowed_footprint_is_caught(kind, monkeypatch):
    """The NARROW seam drops one claimed column: strict validation
    reports the same violation on both sides, and both drivers refuse
    the same install with footprint_violation — the template's, or the
    first constraint's where the parameterless default document leaves
    the check vacuous (the constraint install re-validates)."""
    cdoc = _library()[kind][1]
    jc, jl = _compiled("ref", kind)
    tc, tl = _compiled("port", kind)
    ref = jfootprint.validate_footprint(
        kind, jc, jl, jfootprint.narrow(jfootprint.analyze(kind, jl)),
        [cdoc])
    got = tfootprint.validate_footprint(
        kind, tc, tl, tfootprint.narrow(tfootprint.analyze(kind, tl)),
        [cdoc], device="cpu")
    assert got and [v.format() for v in got] == [v.format() for v in ref]
    monkeypatch.setenv("GATEKEEPER_FOOTPRINT", "strict")
    monkeypatch.setenv("GATEKEEPER_FOOTPRINT_TEST_NARROW", kind)
    refused = []
    for drv, backend, target, err, docs in (
            (JaxDriver(), JBackend, JTarget, JVetError, jall_docs),
            (TorchDriver(device="cpu"), TBackend, TTarget, TVetError,
             tall_docs)):
        tdoc, cd = {t["spec"]["crd"]["spec"]["names"]["kind"]: (t, c)
                    for t, c in docs()}[kind]
        c = backend(drv).new_client([target()])
        try:
            c.add_template(tdoc)
        except err as e:
            assert "footprint_violation" in str(e) or "verdict" in str(e)
            refused.append("template")
        else:
            with pytest.raises(err, match="footprint_violation|verdict"):
                c.add_constraint(cd)
            refused.append("constraint")
            assert drv.state[TARGET].footprints.get(kind) is None
        assert drv.metrics.counter("footprint_violations").value >= 1
    assert refused[1] == refused[0]


def test_footprint_strict_installs_the_library(monkeypatch):
    """GATEKEEPER_FOOTPRINT=strict over the library: every footprint is
    validated on both drivers, none violates, the same kinds are
    row-local, and a second strict install hits the memo."""
    monkeypatch.setenv("GATEKEEPER_FOOTPRINT", "strict")
    fps = []
    for drv, backend, target, docs in (
            (JaxDriver(), JBackend, JTarget, jall_docs),
            (TorchDriver(device="cpu"), TBackend, TTarget, tall_docs)):
        c = backend(drv).new_client([target()])
        for tdoc, _c in docs():
            c.add_template(tdoc)
        fps.append({k: (fp.validated, fp.row_local)
                    for k, fp in drv.state[TARGET].footprints.items()})
    assert fps[1] == fps[0]
    assert len(fps[1]) == 48 and all(v for v, _ in fps[1].values())
    assert tfootprint.analyses_run == jfootprint.analyses_run >= 47
    assert not tfootprint.violations


def test_the_world_mask_is_the_executors_on_the_given_device():
    """_device_mask over one world equals a ProgramExecutor run on that
    device over the same bindings (K1's plain version here) and the
    reference's eager evaluation."""
    from gatekeeper_tpu.library import make_mixed as jmake
    kind = "K8sContainerLimits"
    cdoc = _library()[kind][1]
    jc, jl = _compiled("ref", kind)
    tc, tl = _compiled("port", kind)
    objs = jmake(random.Random(3), 30)
    jst, _, _ = jtv._world_state(objs)
    tst, _, _ = ttv._world_state(objs)
    jm, _ = jtv._device_mask(jl, jst, [cdoc])
    before = ir_eval.eval_mask.plain_calls
    tm, _ = ttv._device_mask(tl, tst, [cdoc], "cpu")
    assert ir_eval.eval_mask.plain_calls == before + 1
    assert tm.shape == jm.shape == (1, 30)
    assert (tm == jm).all()
