"""The static cost model's predictor half in the port
(``analysis/costmodel.py``) against the JAX reference's, on the CPU.

``estimate(...)`` over every lowered library template at three workload
sizes gives the same cost vector, field by field (so the same
``units()``); ``calibrate``, ``predict_seconds``, the sample window and
``effective_scale`` agree with and without samples (the priors differ
by design, the card's against the reference's, so the uncalibrated case
sets ``GATEKEEPER_COST_PRIOR_UPS`` on both); and the drivers'
``predict_review_batch_seconds`` agree on one installed set.
"""

import dataclasses
import random

import pytest

from gatekeeper_tpu.analysis import costmodel as jcm
from gatekeeper_tpu.api.templates import compile_target_rego as jcompile
from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.ir.lower import CannotLower as JCannotLower
from gatekeeper_tpu.ir.lower import lower_template as jlower
from gatekeeper_tpu.library import all_docs, make_mixed
from gatekeeper_tpu.library.templates import LIBRARY
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch.analysis import costmodel as tcm
from gatekeeper_tpu_torch.api.templates import compile_target_rego as tcompile
from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.ir.lower import CannotLower as TCannotLower
from gatekeeper_tpu_torch.ir.lower import lower_template as tlower
from gatekeeper_tpu_torch.target.k8s import TARGET_NAME
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("GATEKEEPER_COST_PRIOR_UPS", raising=False)
    for cm in (jcm, tcm):
        cm.reset_calibration()
    yield
    for cm in (jcm, tcm):
        cm.reset_calibration()


def _lowered(kind):
    rego = LIBRARY[kind][0]
    out = []
    for compile_, lower, cannot in ((jcompile, jlower, JCannotLower),
                                    (tcompile, tlower, TCannotLower)):
        ct = compile_(kind, TARGET_NAME, rego)
        try:
            out.append(lower(ct.module, ct.interp))
        except cannot:
            out.append(None)
    return out


@pytest.mark.parametrize("kind", sorted(LIBRARY))
def test_estimate_equals_the_reference(kind):
    jl, tl = _lowered(kind)
    assert (jl is None) == (tl is None)
    if tl is None:
        pytest.skip(f"{kind} does not lower")
    for n_rows, n_cons in ((1, 1), (1000, 7), (100_000, 67)):
        want = jcm.estimate(jl, n_rows, n_cons)
        got = tcm.estimate(tl, n_rows, n_cons)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.units() == want.units()
        assert got.as_dict() == want.as_dict()
        assert got.padding_waste() == want.padding_waste()


def test_cost_vector_arithmetic_and_weights():
    assert tcm.WEIGHTS == jcm.WEIGHTS
    assert (tcm.DEFAULT_E_PAD, tcm.DEFAULT_SET_LEN, tcm.REF_ROWS) == \
        (jcm.DEFAULT_E_PAD, jcm.DEFAULT_SET_LEN, jcm.REF_ROWS)
    a = tcm.CostVector(gathers=3, compares=5, matmul_flops=40,
                       live_cells=10, padded_cells=16)
    b = tcm.CostVector(logicals=8, arith=2, reductions=1)
    ja = jcm.CostVector(**dataclasses.asdict(a))
    jb = jcm.CostVector(**dataclasses.asdict(b))
    assert dataclasses.asdict(a + b) == dataclasses.asdict(ja + jb)
    assert (a + b).units() == (ja + jb).units()


def test_calibration_window_and_prediction():
    samples = [(1e6, 0.002), (4e6, 0.007), (2.5e7, 0.05), (0, 1.0),
               (3e6, -1.0)]
    assert tcm.calibrate(samples) == jcm.calibrate(samples)
    assert tcm.calibrate([]) == jcm.calibrate([]) == 0.0
    assert tcm.predict_seconds(1e7, 3e-9) == jcm.predict_seconds(1e7, 3e-9)
    assert tcm._CAL_WINDOW == jcm._CAL_WINDOW
    rng = random.Random(4)
    for _ in range(tcm._CAL_WINDOW + 40):    # past the window: oldest drop
        u, s = rng.uniform(1e5, 1e8), rng.uniform(1e-4, 0.5)
        tcm.record_sample(u, s)
        jcm.record_sample(u, s)
    tcm.record_sample(0, 1.0)       # ignored on both
    jcm.record_sample(0, 1.0)
    assert tcm.current_scale() == jcm.current_scale() > 0.0
    assert tcm.calibration_info() == jcm.calibration_info()
    assert tcm.effective_scale() == jcm.effective_scale() \
        == tcm.current_scale()
    tcm.reset_calibration()
    assert tcm.calibration_info() == {"samples": 0, "scale": 0.0}


def test_prior_without_samples(monkeypatch):
    # the port's own prior: positive, and the scale until a sample lands
    assert tcm.current_scale() == 0.0
    assert tcm.prior_scale() == pytest.approx(1.0 / tcm._PRIOR_UNITS_PER_SECOND)
    assert tcm.effective_scale() == tcm.prior_scale() > 0.0
    # the override and the off switch, as the reference reads them
    for raw in ("1e6", "0", "-3", "abc"):
        monkeypatch.setenv("GATEKEEPER_COST_PRIOR_UPS", raw)
        if raw == "abc":
            assert tcm.prior_scale() == pytest.approx(
                1.0 / tcm._PRIOR_UNITS_PER_SECOND)
        else:
            assert tcm.prior_scale() == jcm.prior_scale()
            assert tcm.effective_scale() == jcm.effective_scale()


def _clients():
    kinds = ["K8sRequiredLabels", "K8sAllowedRepos", "K8sContainerLimits",
             "K8sImageDigests"]
    by_kind = {d["spec"]["crd"]["spec"]["names"]["kind"]: (d, c)
               for d, c in all_docs()}
    t = TBackend(TorchDriver(device="cpu")).new_client([TTarget()])
    j = JBackend(JaxDriver()).new_client([JTarget()])
    for c in (t, j):
        for k in kinds:
            c.add_template(by_kind[k][0])
            c.add_constraint(by_kind[k][1])
        c.add_data_batch(make_mixed(random.Random(2), 30))
    return t, j


@pytest.mark.parametrize("calibrated", [False, True])
def test_predict_review_batch_seconds_equals_the_reference(monkeypatch,
                                                           calibrated):
    t, j = _clients()
    td, jd = t.driver, j.driver
    if calibrated:
        for cm in (tcm, jcm):
            cm.record_sample(2e7, 0.013)
            cm.record_sample(5e6, 0.004)
    else:
        monkeypatch.setenv("GATEKEEPER_COST_PRIOR_UPS", "3e8")
    for n in (1, 7, 64, 1000, 4096):
        got = td.predict_review_batch_seconds(TARGET_NAME, n)
        assert got is not None and got > 0.0
        assert got == jd.predict_review_batch_seconds(TARGET_NAME, n)
        # the cached units answer the second call the same
        assert got == td.predict_review_batch_seconds(TARGET_NAME, n)
    assert td.predict_review_batch_seconds(TARGET_NAME, 0) is None
    monkeypatch.setenv("GATEKEEPER_COST_PRIOR_UPS", "0")
    tcm.reset_calibration()
    assert td.predict_review_batch_seconds(TARGET_NAME, 64) is None


def test_client_predict_review_seconds(monkeypatch):
    """``Client.predict_review_seconds`` finds the port driver's
    predictor (it returned None while the driver had none)."""
    monkeypatch.setenv("GATEKEEPER_COST_PRIOR_UPS", "3e8")
    t, _j = _clients()
    want = t.driver.predict_review_batch_seconds(TARGET_NAME, 256)
    assert want is not None
    assert t.predict_review_seconds(256) == want
