"""Stage 7 of the port (analysis/compilesurface.py) against the JAX
reference, on the CPU: the certificates, the precompile, the certified
review rungs and the retrace sentinel.

- On each of the 48 lowered library templates the port's certificate
  equals the reference's (``bounded``, ``n_signatures``, the ladders,
  the per-binding classes, the delta rungs, ``reason``), under the
  default caps and under a row cap below the pad minimum; the
  TEST_UNBOUNDED seam excludes a kind on both drivers.
- ``precompile`` issues the reference's count cold (one launch a
  certified kind; on the CPU nothing compiles and nothing launches) and
  0 on a second driver over the same ``cs`` tier.
- ``certified_review_rungs`` equals the reference's (capped, uncapped,
  unbounded, stage off), and the micro-batcher steps down those rungs.
- The sentinel (``ProgramExecutor._guard_miss``): a signature outside
  the certificate is counted in ``retrace_uncertified_total`` and
  flight-recorded under ``warn`` and served; under ``strict`` it raises
  ``UncertifiedRetrace`` before the evaluator runs (or, on the card,
  anything compiles), again on every retry; a certified sweep under
  strict counts nothing, and each signature asks the guard once.
"""

import dataclasses
import random
import threading
import time

import pytest

from gatekeeper_tpu.analysis import compilesurface as jcs
from gatekeeper_tpu.api.templates import compile_target_rego as jcompile
from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.ir.lower import CannotLower as JCannotLower
from gatekeeper_tpu.ir.lower import lower_template as jlower
from gatekeeper_tpu.library import all_docs as jall_docs
from gatekeeper_tpu.library import make_mixed
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch.analysis import compilesurface as tcs
from gatekeeper_tpu_torch.api.templates import compile_target_rego as tcompile
from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.client.interface import QueryOpts
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.ir.lower import CannotLower as TCannotLower
from gatekeeper_tpu_torch.ir.lower import lower_template as tlower
from gatekeeper_tpu_torch.kernels import dfa, ir_eval
from gatekeeper_tpu_torch.library import all_docs as tall_docs
from gatekeeper_tpu_torch.obs import flightrecorder as fr
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget
from gatekeeper_tpu_torch.webhook.batcher import MicroBatcher

TARGET = "admission.k8s.gatekeeper.sh"
KINDS = ["K8sRequiredLabels", "K8sAllowedRepos", "K8sContainerLimits"]
ENV = ("GATEKEEPER_COMPILE_SURFACE", "GATEKEEPER_CS_TEST_UNBOUNDED",
       "GATEKEEPER_CS_MAX_ROWS", "GATEKEEPER_CS_MAX_CONSTRAINTS",
       "GATEKEEPER_CS_MAX_TABLE", "GATEKEEPER_CS_MAX_ELEMS",
       "GATEKEEPER_SNAPSHOT_DIR", "GATEKEEPER_HBM_BUDGET",
       "GATEKEEPER_HBM_BUDGET_BYTES", "GATEKEEPER_TRANSVAL")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Certifier state is process-global on both sides.  The reference
    driver is built unsharded (its precompile is the unsharded seam;
    the port has no mesh)."""
    for cs in (jcs, tcs):
        monkeypatch.setattr(cs, "_memo", {})
        monkeypatch.setattr(cs, "surfaces", {})
        monkeypatch.setattr(cs, "unbounded", {})
        monkeypatch.setattr(cs, "_registry", {})
        monkeypatch.setattr(cs, "analyses_run", 0)
        monkeypatch.setattr(cs, "precompiles_run", 0)
        monkeypatch.setattr(cs, "uncertified_total", 0)
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("GATEKEEPER_SHARDS", "1")
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)


def _lowered(side: str) -> dict:
    """kind -> lowered program of every library template that lowers."""
    docs, compile_, lower, cannot = (
        (tall_docs, tcompile, tlower, TCannotLower) if side == "port"
        else (jall_docs, jcompile, jlower, JCannotLower))
    out = {}
    for tdoc, _c in docs():
        kind = tdoc["spec"]["crd"]["spec"]["names"]["kind"]
        tt = tdoc["spec"]["targets"][0]
        compiled = compile_(kind, tt["target"], tt["rego"])
        try:
            out[kind] = lower(compiled.module, compiled.interp)
        except cannot:
            pass
    return out


PORT = _lowered("port")
LOWERED = sorted(PORT)


def _fields(cert) -> dict:
    d = dataclasses.asdict(cert)
    d.pop("digest")
    return d


@pytest.mark.parametrize("kind", LOWERED)
def test_certificate_equals_reference(kind):
    ref = _lowered_ref()[kind]
    got = tcs.analyze(kind, PORT[kind])
    assert got.bounded and got.reason is None
    assert _fields(got) == _fields(jcs.analyze(kind, ref))
    assert got.n_signatures > 0 and got.delta_rungs > 0


_REF_CACHE: dict = {}


def _lowered_ref() -> dict:
    if not _REF_CACHE:
        _REF_CACHE.update(_lowered("ref"))
    return _REF_CACHE


def test_the_library_lowers_48_templates():
    assert len(LOWERED) == 48 and LOWERED == sorted(_lowered_ref())


@pytest.mark.parametrize("env, value", [
    ("GATEKEEPER_CS_MAX_ROWS", "4"),
    ("GATEKEEPER_CS_MAX_ROWS", "4096"),
    ("GATEKEEPER_CS_MAX_CONSTRAINTS", "64"),
    ("GATEKEEPER_CS_TEST_UNBOUNDED", "K8sContainerLimits"),
])
def test_caps_and_the_seam_certify_as_the_reference(env, value,
                                                    monkeypatch):
    """A cap below the pad minimum makes every surface unbounded, a
    smaller cap shortens the ladders, and the seam rejects its kind:
    the same certificates and reasons on both sides."""
    monkeypatch.setenv(env, value)
    for kind in KINDS:
        got = tcs.analyze(kind, PORT[kind])
        assert _fields(got) == _fields(jcs.analyze(kind,
                                                   _lowered_ref()[kind]))
    bounded = tcs.analyze("K8sContainerLimits",
                          PORT["K8sContainerLimits"]).bounded
    assert bounded is (value not in ("4", "K8sContainerLimits"))


def test_scalar_surface_and_digest():
    pin = tcs.scalar_surface("K8sFoo")
    assert _fields(pin) == _fields(jcs.scalar_surface("K8sFoo"))
    a = tcs.surface_digest(PORT["K8sRequiredLabels"])
    assert a != tcs.surface_digest(PORT["K8sAllowedRepos"])


# ---------------------------------------------------------------------------
# the drivers


def _drivers(kinds=KINDS, n_rows=40, seed=3):
    """(JaxDriver, its client, TorchDriver on the CPU, its client) over
    the same templates, constraints and store."""
    by_t = {t["spec"]["crd"]["spec"]["names"]["kind"]: (t, c)
            for t, c in tall_docs()}
    by_j = {t["spec"]["crd"]["spec"]["names"]["kind"]: (t, c)
            for t, c in jall_docs()}
    out = []
    for drv, backend, target, docs in (
            (JaxDriver(), JBackend, JTarget, by_j),
            (TorchDriver(device="cpu"), TBackend, TTarget, by_t)):
        client = backend(drv).new_client([target()])
        for k in kinds:
            client.add_template(docs[k][0])
            client.add_constraint(docs[k][1])
        client.add_data_batch(make_mixed(random.Random(seed), n_rows))
        out += [drv, client]
    return out


def test_install_publishes_the_reference_certificates():
    jd, _jc, td, _tc = _drivers()
    tst, jst = td.state[TARGET], jd.state[TARGET]
    assert sorted(tst.compilesurfaces) == sorted(jst.compilesurfaces) \
        == sorted(KINDS)
    for k in KINDS:
        assert _fields(tst.compilesurfaces[k]) == \
            _fields(jst.compilesurfaces[k])
    assert tcs.surface_for(KINDS[0]) is tst.compilesurfaces[KINDS[0]]


def test_unbounded_seam_excludes_the_kind(monkeypatch, tmp_path):
    monkeypatch.setenv("GATEKEEPER_CS_TEST_UNBOUNDED", "K8sAllowedRepos")
    monkeypatch.setenv("GATEKEEPER_SNAPSHOT_DIR", str(tmp_path))
    jd, jc, td, tc = _drivers()
    assert not td.state[TARGET].compilesurfaces["K8sAllowedRepos"].bounded
    assert tcs.unbounded_for("K8sAllowedRepos") == \
        jcs.unbounded_for("K8sAllowedRepos")
    assert td.metrics.counter("compile_surface_unbounded").value == 1
    # excluded from the precompile and from the rungs
    assert td.precompile(TARGET) == jd.precompile(TARGET) == 2
    assert tc.certified_review_rungs(64) is None
    assert jc.certified_review_rungs(64) is None


def test_precompile_counts_as_the_reference_cold_and_0_warm(monkeypatch,
                                                           tmp_path):
    """One precompile launch a certified kind cold, the reference's
    count; a second driver at the same geometry reads the ``aot:``
    stamp from the cs tier and issues none.  On the CPU the launch is
    a no-op: the plain evaluator compiles nothing and runs nothing."""
    monkeypatch.setenv("GATEKEEPER_SNAPSHOT_DIR", str(tmp_path))
    jd, _jc, td, _tc = _drivers()
    before = ir_eval.eval_mask.plain_calls
    assert td.prepare_audit(TARGET) is True
    jd.prepare_audit(TARGET)
    assert tcs.precompiles_run == jcs.precompiles_run == len(KINDS)
    assert td.metrics.counter("compile_surface_precompiles").value == 3
    assert ir_eval.eval_mask.plain_calls == before
    jd2, _jc2, td2, _tc2 = _drivers()
    assert td2.precompile(TARGET) == jd2.precompile(TARGET) == 0
    assert tcs.precompiles_run == jcs.precompiles_run == len(KINDS)
    monkeypatch.setenv("GATEKEEPER_COMPILE_SURFACE", "off")
    assert td2.precompile(TARGET) == 0


@pytest.mark.parametrize("env, value, max_n", [
    (None, None, 64), (None, None, None),
    ("GATEKEEPER_CS_MAX_ROWS", "4096", 64),
    ("GATEKEEPER_CS_MAX_ROWS", "4096", None),
    ("GATEKEEPER_COMPILE_SURFACE", "off", 64),
    ("GATEKEEPER_HBM_BUDGET_BYTES", "50000000", None),
])
def test_certified_review_rungs_equal_the_reference(env, value, max_n,
                                                    monkeypatch):
    if env:
        monkeypatch.setenv(env, value)
    jd, jc, td, tc = _drivers()
    got = td.certified_review_rungs(TARGET, max_n)
    assert got == jd.certified_review_rungs(TARGET, max_n)
    assert tc.certified_review_rungs(max_n) == \
        jc.certified_review_rungs(max_n) == got
    if env == "GATEKEEPER_COMPILE_SURFACE":
        assert got is None
    else:
        assert got[:2] == [1, 8]


class _Pending:
    def __init__(self, deadline):
        self.request = {}
        self.ctx = None
        self.deadline = deadline
        self.withdrawn = False
        self.error = None
        self.response = None
        self.event = threading.Event()


def test_the_batcher_steps_down_the_drivers_rungs(monkeypatch):
    """The micro-batcher over the port's client: a deadline-pressed
    batch of 20 shrinks to the certified rung below (16), not to half
    (10), as the manager wires it (``certified_rungs``)."""
    monkeypatch.setenv("GATEKEEPER_CS_MAX_ROWS", "4096")
    _jd, _jc, _td, tc = _drivers()
    mb = MicroBatcher(
        evaluate_batch=lambda reqs: [None] * len(reqs), max_batch=64,
        predict_seconds=lambda n: 10.0 if n > 16 else 0.001,
        certified_rungs=lambda: tc.certified_review_rungs(64))
    keep = mb._fit_to_deadline([_Pending(time.monotonic() + 1.0)
                                for _ in range(20)])
    assert len(keep) == 16 and mb.depth() == 4
    assert mb.metrics.snapshot().get("admission_batch_rung_shrinks") == 1


# ---------------------------------------------------------------------------
# the sentinel


def _seeded(monkeypatch, mode):
    """A 200-review batch under GATEKEEPER_CS_MAX_ROWS=64 pads its review
    mini table to 256 rows: a signature outside every certificate."""
    monkeypatch.setenv("GATEKEEPER_CS_MAX_ROWS", "64")
    monkeypatch.setenv("GATEKEEPER_COMPILE_SURFACE", mode)
    monkeypatch.setattr(torch_driver, "REVIEW_BATCH_MIN_EVALS", 0)
    drv = TorchDriver(device="cpu")
    client = TBackend(drv).new_client([TTarget()])
    by_t = {t["spec"]["crd"]["spec"]["names"]["kind"]: (t, c)
            for t, c in tall_docs()}
    for k in KINDS:
        client.add_template(by_t[k][0])
        client.add_constraint(by_t[k][1])
    client.add_data_batch(make_mixed(random.Random(3), 40))
    reviews = [{"object": o, "operation": "CREATE"}
               for o in make_mixed(random.Random(7), 200)]
    return drv, reviews


def test_warn_counts_records_and_serves(monkeypatch):
    drv, reviews = _seeded(monkeypatch, "warn")
    rec = fr.FlightRecorder(ring=256)
    monkeypatch.setattr(fr, "_recorder", rec)
    results = drv.query_review_batch(TARGET, reviews, QueryOpts())
    assert len(results) == len(reviews)          # served, not refused
    n = drv.executor.retrace_uncertified
    assert n > 0
    assert drv.metrics.counter("retrace_uncertified_total").value == n
    assert tcs.uncertified_total == n
    evs = [e for e in rec.snapshot() if e["type"] == "retrace_uncertified"]
    assert len(evs) == n and evs[0]["mode"] == "warn"
    # a launched signature asks nothing the second time
    drv.query_review_batch(TARGET, reviews, QueryOpts())
    assert drv.executor.retrace_uncertified == n


def test_strict_refuses_before_the_evaluator_runs(monkeypatch):
    drv, reviews = _seeded(monkeypatch, "strict")
    k1, k3 = ir_eval.eval_mask.plain_calls, dfa.dfa_table.plain_calls
    for attempt in (1, 2):
        with pytest.raises(tcs.UncertifiedRetrace, match="outside the "
                           "certified compile surface"):
            drv.query_review_batch(TARGET, reviews, QueryOpts())
        assert drv.executor.retrace_uncertified == attempt
    assert ir_eval.eval_mask.plain_calls == k1
    assert dfa.dfa_table.plain_calls == k3


def test_a_store_grown_past_the_cap_is_refused_under_strict(monkeypatch):
    """Certified at 40 rows (R_pad 64 under a 64-row cap), a forced full
    sweep serves; once the store grows to the next bucket (128) the next
    sweep's launch is outside the certificate and refused."""
    monkeypatch.setenv("GATEKEEPER_CS_MAX_ROWS", "64")
    monkeypatch.setenv("GATEKEEPER_COMPILE_SURFACE", "strict")
    _jd, _jc, td, tc = _drivers()
    full = QueryOpts(limit_per_constraint=20, full=True)
    assert td.query_audit(TARGET, full)[0]
    assert td.executor.retrace_uncertified == 0
    tc.add_data_batch(make_mixed(random.Random(9), 60))
    with pytest.raises(tcs.UncertifiedRetrace):
        td.query_audit(TARGET, full)
    assert td.executor.retrace_uncertified == 1


def test_certified_sweeps_are_clean_under_strict(monkeypatch):
    """prepare_audit and two forced full sweeps under strict: nothing is
    outside the certificate, the results equal a warn driver's, and the
    guard was asked once a signature."""
    monkeypatch.setenv("GATEKEEPER_COMPILE_SURFACE", "strict")
    _jd, _jc, td, _tc = _drivers()
    asked = []
    guard = td.executor.surface_guard

    def spy(program, arrays, delta_k):
        asked.append(program.cache_key())
        return guard(program, arrays, delta_k)

    td.executor.surface_guard = spy
    td.prepare_audit(TARGET)
    full = QueryOpts(limit_per_constraint=20, full=True)
    first = td.query_audit(TARGET, full)[0]
    n_asked = len(asked)
    second = td.query_audit(TARGET, full)[0]
    assert td.executor.retrace_uncertified == 0
    assert len(asked) == n_asked == len(KINDS)
    monkeypatch.setenv("GATEKEEPER_COMPILE_SURFACE", "warn")
    _jd2, _jc2, td2, _tc2 = _drivers()
    want = td2.query_audit(TARGET, full)[0]

    def key(rs):
        return sorted((r.constraint["metadata"]["name"],
                       ((r.resource or {}).get("metadata") or {}).get("name"),
                       r.msg) for r in rs)
    assert key(first) == key(second) == key(want)


def test_dispatch_membership_equals_the_reference(monkeypatch):
    import numpy as np
    jd, _jc, td, _tc = _drivers()
    for drv, cs in ((jd, jcs), (td, tcs)):
        st = drv.state[TARGET]
        kind = KINDS[0]
        program = st.templates[kind].vectorized.program
        b = drv._kind_bindings(st, kind, st.templates[kind],
                               list(st.constraints[kind].values()))
        assert cs.dispatch_certified(program, b.arrays)
        bad = dict(b.arrays)
        bad["__alive__"] = np.ones(7, dtype=bool)    # off the pow2 ladder
        assert not cs.dispatch_certified(program, bad)
        assert not cs.dispatch_certified(program, b.arrays, delta_k=100)
        assert cs.dispatch_certified(program, b.arrays, delta_k=256)


def test_a_precompile_launch_error_is_raised(monkeypatch):
    """Deliberate difference from the reference, which swallows a
    failed AOT compile (ROADMAP Queue C): the port's precompile raises
    the first launch error, as its ingest and delta warms do; a binding
    build error skips its kind, as in the reference."""
    _jd, _jc, td, _tc = _drivers()

    def boom(program, bindings, k=None, with_match=False, extra=None):
        raise RuntimeError("K1 launch failed")

    monkeypatch.setattr(td.executor, "prewarm_audit_exec", boom)
    with pytest.raises(RuntimeError, match="K1 launch failed"):
        td.prepare_audit(TARGET)
    assert tcs.precompiles_run == 0

    def no_bindings(*a, **k):
        raise ValueError("no bindings")

    monkeypatch.setattr(td, "_kind_bindings", no_bindings)
    assert td.precompile(TARGET) == 0


@pytest.mark.parametrize("kinds", [KINDS, LOWERED])
def test_the_precompile_launches_every_signature_of_the_sweep(kinds,
                                                              monkeypatch):
    """'Inside the certificate' must mean 'compiled by the precompile':
    every full-mask launch of a forced full sweep after ``prepare_audit``
    has the signature (program, array names in order, dtypes, shapes)
    of one of the precompile's launches.  Deliberate difference from the
    reference (ROADMAP Queue C): the port's precompile interns the
    element axes first, as a sweep does, so interner-indexed tables pad
    to the sweep's bucket.  Dedup off: rewritten programs are warmed by
    ``prepare_audit``'s own step, not the precompile."""
    monkeypatch.setenv("GATEKEEPER_DEDUP", "off")
    _jd, _jc, td, _tc = _drivers(kinds)
    ex = td.executor

    def sig(program, arrays):
        return (program.cache_key(),
                tuple((nm, str(a.dtype), tuple(a.shape))
                      for nm, a in arrays.items()
                      if not nm.endswith(".devtab")))

    warmed = []

    def warm(program, bindings, k=None, with_match=False, extra=None):
        warmed.append(sig(program, ex.audit_warm_arrays(
            program, bindings, k, with_match, extra)))
        return True

    monkeypatch.setattr(ex, "prewarm_audit_exec", warm)
    td.prepare_audit(TARGET)
    launched = []
    full_mask = ex._full_mask

    def spy(program, arrays):
        launched.append(sig(program, arrays))
        return full_mask(program, arrays)

    monkeypatch.setattr(ex, "_full_mask", spy)
    td.query_audit(TARGET, QueryOpts(limit_per_constraint=20, full=True))
    assert len(warmed) == len(launched) == len(kinds)
    assert set(launched) <= set(warmed)
