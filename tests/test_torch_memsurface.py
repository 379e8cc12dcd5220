"""Stage 8 and the devpages residency planner of the port, against the
JAX reference, on the CPU.

- The port's memory-surface certificate (analysis/memsurface.py) equals
  the reference's byte model for every library template (bindings,
  liveness points, ``has_r``, ``scalar_pin``) and dominates the arrays
  ``ir/prep.build_bindings`` builds; the TEST_UNDER seam fails that
  check on both sides (tests/test_memsurface.py ``TestOverApprox``).
- The install gate (``TestBudgetGate``): warn counts, strict rejects and
  off skips exactly the installs the reference's does; the default
  budget is the card's memory, never the reference's TPU figure.
- The residency planner (``TestResidencyPlanner``) on K8's plain
  version: after every ``touch``/``store``/``expand`` its state equals
  the reference planner's (slots, free list, LRU order, spill sets,
  host mirror, counters, slot buffer), ragged tail pages and one-slot
  ladders included.
- Budgeted devpages sweeps (``TestResidencySweepParity``, budget 256,
  16-row pages): the port equals JaxDriver under the same budget in
  results, ledger events and the ``devpages`` stanza (its ``resident_*``
  counters included), the port unbudgeted, the GATEKEEPER_PAGES=off
  oracle and the scalar LocalDriver.
- The sweep-order consumer (``TestDriverConsumers``).

Every comparison is exact: the certificates are integer byte models and
the masks are bool.
"""

import copy
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatekeeper_tpu.analysis import memsurface as jms
from gatekeeper_tpu.analysis.transval import _world_state
from gatekeeper_tpu.api.templates import compile_target_rego as jcompile
from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.client.interface import QueryOpts as JOpts
from gatekeeper_tpu.engine import jax_driver
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.enforce import devpages as jdevpages
from gatekeeper_tpu.errors import VetError as JVetError
from gatekeeper_tpu.ir import prep as jprep
from gatekeeper_tpu.ir.lower import lower_template as jlower
from gatekeeper_tpu.library import all_docs as jall_docs
from gatekeeper_tpu.library import make_mixed
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch.analysis import memsurface as tms
from gatekeeper_tpu_torch.api.templates import compile_target_rego as tcompile
from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.client.interface import QueryOpts as TOpts
from gatekeeper_tpu_torch.client.local_driver import LocalDriver, TargetState
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.executor import ProgramExecutor
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.enforce import devpages as tdevpages
from gatekeeper_tpu_torch.errors import VetError as TVetError
from gatekeeper_tpu_torch.ir import prep as tprep
from gatekeeper_tpu_torch.ir.lower import lower_template as tlower
from gatekeeper_tpu_torch.kernels import residency
from gatekeeper_tpu_torch.library import all_docs as tall_docs
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget

from test_torch_pages import (TARGET, Side, _client, _results,
                              library_harness)
from test_torch_pages import _isolated  # noqa: F401  (autouse fixture)

KINDS = ["K8sRequiredLabels", "K8sAllowedRepos", "K8sContainerLimits"]
ENV = ("GATEKEEPER_HBM_BUDGET", "GATEKEEPER_HBM_BUDGET_BYTES",
       "GATEKEEPER_MEMSURFACE_TEST_UNDER", "GATEKEEPER_MS_MAX_ROWS",
       "GATEKEEPER_MS_MAX_CONSTRAINTS", "GATEKEEPER_MS_MAX_TABLE",
       "GATEKEEPER_MS_MAX_ELEMS", "GATEKEEPER_DEVPAGES_BUDGET_BYTES")


@pytest.fixture(autouse=True)
def _reset_memsurface_state(monkeypatch):
    """Certifier state is process-global on both sides."""
    for ms in (jms, tms):
        monkeypatch.setattr(ms, "_memo", {})
        monkeypatch.setattr(ms, "surfaces", {})
        monkeypatch.setattr(ms, "over_budget", {})
        monkeypatch.setattr(ms, "analyses_run", 0)
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


def _by_kind(all_docs):
    return {t["spec"]["crd"]["spec"]["names"]["kind"]: (t, c)
            for t, c in all_docs()}


def _library(kind: str):
    """((compiled, lowered, constraint doc) of the reference, of the
    port) for one library kind."""
    out = []
    for all_docs, compile_, lower in ((jall_docs, jcompile, jlower),
                                      (tall_docs, tcompile, tlower)):
        tdoc, cdoc = _by_kind(all_docs)[kind]
        tt = tdoc["spec"]["targets"][0]
        compiled = compile_(kind, tt["target"], tt["rego"])
        out.append((compiled, lower(compiled.module, compiled.interp), cdoc))
    return out


def _model(cert) -> tuple:
    return (cert.bindings, cert.points, cert.has_r, cert.scalar_pin,
            cert.bounded, cert.reason, cert.version)


def _drivers(kinds, n_rows=40, seed=3):
    """(JaxDriver, its client, TorchDriver(cpu), its client) with the
    library's template and sample constraint of each kind over
    ``n_rows`` make_mixed rows."""
    out = []
    for drv, backend, target, all_docs in (
            (JaxDriver(), JBackend, JTarget, jall_docs),
            (TorchDriver(device="cpu"), TBackend, TTarget, tall_docs)):
        c = backend(drv).new_client([target()])
        docs = _by_kind(all_docs)
        for kind in kinds:
            c.add_template(docs[kind][0])
            c.add_constraint(docs[kind][1])
        c.add_data_batch(make_mixed(random.Random(seed), n_rows))
        out += [drv, c]
    return out


# ---------------------------------------------------------------------------
# the byte model and the over-approximation contract


def _under_claims(cert, bindings) -> list[str]:
    """tests/test_memsurface.py's validation core: per modeled base name,
    the certificate's itemsize x worst-shape claim must dominate the
    bytes build_bindings materialized."""
    suffixes = (".v", ".p", ".B", ".bitmap")
    model_item: dict[str, int] = {}
    for name, _dcls, itemsize in cert.bindings:
        model_item[name] = max(model_item.get(name, 0), itemsize)
    grouped: dict[str, list] = {}
    for aname, arr in bindings.arrays.items():
        mname = aname
        if mname not in model_item:
            for suf in suffixes:
                if aname.endswith(suf) and aname[:-len(suf)] in model_item:
                    mname = aname[:-len(suf)]
                    break
        grouped.setdefault(mname, []).append(arr)
    under = []
    for mname, arrs in sorted(grouped.items()):
        built = sum(int(a.nbytes) for a in arrs)
        if mname not in model_item:
            under.append(f"{mname} unmodeled ({built} B built)")
            continue
        claimed = model_item[mname] * max(
            int(np.prod(a.shape)) for a in arrs)
        if claimed < built:
            under.append(f"{mname} claims {claimed} B < {built} B")
    return under


def _port_world(resources):
    """The port's TargetState with every resource upserted (the
    reference's ``transval._world_state``)."""
    handler = TTarget()
    st = TargetState()
    for obj in resources:
        key, meta, obj2 = handler.process_data(obj)
        st.table.upsert(key, obj2, meta)
    return st


class TestOverApprox:
    def _check(self, kind, n=48, seed=11):
        """(port certificate, port under-claims), held equal to the
        reference's on the same rows."""
        (_jc, jlow, jcdoc), (_tc, tlow, tcdoc) = _library(kind)
        assert jlow is not None and tlow is not None
        jcert = jms.analyze(kind, jlow)
        tcert = tms.analyze(kind, tlow)
        assert _model(tcert) == _model(jcert)
        assert tcert.version == tms.MS_VERSION == jms.MS_VERSION
        rows = make_mixed(random.Random(seed), n)
        jst, _rows, _h = _world_state(copy.deepcopy(rows))
        jb = jprep.build_bindings(jlow.spec, jst.table, [jcdoc])
        tb = tprep.build_bindings(
            tlow.spec, _port_world(copy.deepcopy(rows)).table, [tcdoc])
        under = _under_claims(tcert, tb)
        assert under == _under_claims(jcert, jb)
        return tcert, under

    def test_table_heavy_template_dominates(self):
        cert, under = self._check("K8sContainerLimits")
        assert under == []
        names = {n for n, _d, _i in cert.bindings}
        assert any(".ok" in n or ".v" not in n for n in names)

    def test_dfa_template_dominates(self):
        cert, under = self._check("K8sImageDigests")
        assert under == []
        assert any(n.startswith("dfa") for n, _d, _i in cert.bindings)

    def test_cross_row_join_template_dominates(self):
        cert, under = self._check("K8sUniqueIngressHost")
        assert under == []
        assert cert.has_r

    def test_seeded_underclaim_fails_the_check(self, monkeypatch):
        monkeypatch.setenv("GATEKEEPER_MEMSURFACE_TEST_UNDER",
                           "K8sContainerLimits")
        cert, under = self._check("K8sContainerLimits")
        assert under
        assert "under-claimed" in (cert.reason or "")

    def test_claim_is_monotone_in_geometry(self):
        (_j, jlow, _d), (_t, tlow, _e) = _library("K8sRequiredLabels")
        j = jms.analyze("K8sRequiredLabels", jlow)
        t = tms.analyze("K8sRequiredLabels", tlow)
        for dims in ({"c": 8, "r": 64}, {"c": 16, "r": 4096},
                     {"c": 4, "r": 131072}):
            assert t.resident_bytes(dims) == j.resident_bytes(dims)
            assert t.transient_bytes(dims) == j.transient_bytes(dims)
            assert t.devpages_bytes(dims, delta_k=0) \
                == j.devpages_bytes(dims, delta_k=0)
            assert t.peak_bytes(dims) == j.peak_bytes(dims)
        small = t.resident_bytes({"c": 8, "r": 64})
        assert 0 < small < t.resident_bytes({"c": 16, "r": 4096})
        assert t.peak_bytes({"c": 8, "r": 64}) >= small
        assert t.peak_bytes() == j.peak_bytes()

    def test_scalar_pin_claims_nothing(self):
        cert = tms.scalar_surface("K8sRequiredResources")
        assert _model(cert) == _model(
            jms.scalar_surface("K8sRequiredResources"))
        assert cert.scalar_pin and cert.bounded
        assert cert.peak_bytes() == 0
        assert tms.budget_reason(cert) is None

    def test_budget_reason_fires_under_tiny_budget(self, monkeypatch):
        (_j, jlow, _d), (_t, tlow, _e) = _library("K8sRequiredLabels")
        j = jms.analyze("K8sRequiredLabels", jlow)
        t = tms.analyze("K8sRequiredLabels", tlow)
        assert tms.budget_reason(t) is None
        monkeypatch.setenv("GATEKEEPER_HBM_BUDGET_BYTES", "1024")
        reason = tms.budget_reason(t)
        assert reason is not None and reason == jms.budget_reason(j)
        assert reason.startswith("hbm_budget_exceeded")


def test_every_library_certificate_equals_the_reference():
    """Every library template installed on both drivers: the same kinds
    certified, scalar pins alike, and each certificate's byte model
    equal to the reference's."""
    jd, _jc, td, _tc = _drivers([k for k in _by_kind(jall_docs)],
                                n_rows=1)
    jcerts = jd.state[TARGET].memsurfaces
    tcerts = td.state[TARGET].memsurfaces
    assert sorted(tcerts) == sorted(jcerts) == sorted(_by_kind(tall_docs))
    for kind in jcerts:
        assert _model(tcerts[kind]) == _model(jcerts[kind]), kind
    assert sum(c.scalar_pin for c in tcerts.values()) >= 1
    assert sum(c.has_r for c in tcerts.values()) >= 40


def test_default_budget_is_the_cards_memory(monkeypatch):
    """Unset, the budget is the CUDA device's own memory, or the H100
    80GB's on the CPU — never the reference's TPU default."""
    assert tms.budget_bytes() == tms.budget_bytes("cpu") \
        == tms.H100_80GB_BYTES != jms.DEFAULT_BUDGET_BYTES

    class Props:
        total_memory = 85_000_000_000

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    assert tms.budget_bytes("cuda") == Props.total_memory
    monkeypatch.setenv("GATEKEEPER_HBM_BUDGET_BYTES", "4096")
    assert tms.budget_bytes("cuda") == 4096
    monkeypatch.setenv("GATEKEEPER_HBM_BUDGET_BYTES", "lots")
    assert tms.budget_bytes("cuda") == Props.total_memory


# ---------------------------------------------------------------------------
# the install-time budget gate


class TestBudgetGate:
    def test_warn_counts_breaches_and_serves(self, monkeypatch):
        monkeypatch.setenv("GATEKEEPER_HBM_BUDGET", "warn")
        monkeypatch.setenv("GATEKEEPER_HBM_BUDGET_BYTES", "4096")
        jd, _jc, td, _tc = _drivers(KINDS)
        assert set(td.state[TARGET].memsurfaces) == set(KINDS)
        assert td.metrics.counter("hbm_budget_exceeded").value \
            == jd.metrics.counter("hbm_budget_exceeded").value >= len(KINDS)
        assert tms.over_budget == jms.over_budget != {}
        for reason in tms.over_budget.values():
            assert "hbm_budget_exceeded" in reason
        got = td.query_audit(TARGET, TOpts(full=True))[0]
        want = jd.query_audit(TARGET, JOpts(full=True))[0]
        assert got and _results(got) == _results(want)

    def test_strict_rejects_the_install(self, monkeypatch):
        monkeypatch.setenv("GATEKEEPER_HBM_BUDGET", "strict")
        monkeypatch.setenv("GATEKEEPER_HBM_BUDGET_BYTES", "4096")
        for drv, backend, target, all_docs, err in (
                (JaxDriver(), JBackend, JTarget, jall_docs, JVetError),
                (TorchDriver(device="cpu"), TBackend, TTarget, tall_docs,
                 TVetError)):
            client = backend(drv).new_client([target()])
            with pytest.raises(err, match="hbm_budget_exceeded"):
                client.add_template(_by_kind(all_docs)[
                    "K8sRequiredLabels"][0])
            assert drv.state[TARGET].memsurfaces.get(
                "K8sRequiredLabels") is None

    def test_strict_within_budget_installs(self, monkeypatch):
        monkeypatch.setenv("GATEKEEPER_HBM_BUDGET", "strict")
        _jd, _jc, td, _tc = _drivers(KINDS)
        assert set(td.state[TARGET].memsurfaces) == set(KINDS)
        assert not tms.over_budget

    def test_strict_and_warn_pick_the_references_installs(self,
                                                          monkeypatch):
        """A budget between the library's certified peaks: strict rejects
        and warn counts the same templates on both drivers."""
        _jd, _jc, td, _tc = _drivers(sorted(_by_kind(tall_docs)), n_rows=1)
        peaks = sorted(c.peak_bytes() for c in
                       td.state[TARGET].memsurfaces.values()
                       if not c.scalar_pin)
        monkeypatch.setenv("GATEKEEPER_HBM_BUDGET_BYTES",
                           str(peaks[len(peaks) // 2]))
        rejected = []
        for drv, backend, target, all_docs, err in (
                (JaxDriver(), JBackend, JTarget, jall_docs, JVetError),
                (TorchDriver(device="cpu"), TBackend, TTarget, tall_docs,
                 TVetError)):
            monkeypatch.setenv("GATEKEEPER_HBM_BUDGET", "strict")
            client = backend(drv).new_client([target()])
            out = set()
            for kind, (tdoc, _cdoc) in sorted(_by_kind(all_docs).items()):
                try:
                    client.add_template(tdoc)
                except err:
                    out.add(kind)
            rejected.append(out)
        assert rejected[0] == rejected[1] != set()
        monkeypatch.setenv("GATEKEEPER_HBM_BUDGET", "warn")
        jd, _jc, td, _tc = _drivers(sorted(_by_kind(tall_docs)), n_rows=1)
        assert td.metrics.counter("hbm_budget_exceeded").value \
            == jd.metrics.counter("hbm_budget_exceeded").value \
            == len(rejected[1])
        assert set(tms.over_budget) == set(jms.over_budget) == rejected[1]

    def test_off_skips_certification(self, monkeypatch):
        monkeypatch.setenv("GATEKEEPER_HBM_BUDGET", "off")
        jd, _jc, td, _tc = _drivers(KINDS)
        assert not td.state[TARGET].memsurfaces
        assert not jd.state[TARGET].memsurfaces
        assert tms.analyses_run == jms.analyses_run == 0

    def test_analysis_error_is_counted_and_installs(self, monkeypatch):
        """An error of the host analysis leaves the kind without a
        certificate and the install standing, as in the reference."""
        def broken(*_a, **_k):
            raise ValueError("analysis fault")

        monkeypatch.setattr(jms, "certify", broken)
        monkeypatch.setattr(tms, "certify", broken)
        jd, _jc, td, _tc = _drivers(KINDS[:1])
        for d in (jd, td):
            assert d.metrics.counter("memsurface_errors").value == 1
            assert d.state[TARGET].memsurfaces == {}
            assert KINDS[0] in d.state[TARGET].templates


class TestPersistence:
    def test_memo_runs_one_analysis(self):
        (jc, jlow, _d), (tc, tlow, _e) = _library("K8sRequiredLabels")
        a = tms.certify("K8sRequiredLabels", tc, tlow)
        b = tms.certify("K8sRequiredLabels", tc, tlow)
        assert a == b
        assert tms.analyses_run == 1
        assert tms.surface_for("K8sRequiredLabels") == a
        assert _model(a) == _model(jms.certify("K8sRequiredLabels", jc,
                                               jlow))

    def test_seam_bypasses_the_memo(self, monkeypatch):
        (_jc, _jl, _d), (tc, tlow, _e) = _library("K8sRequiredLabels")
        honest = tms.certify("K8sRequiredLabels", tc, tlow)
        monkeypatch.setenv("GATEKEEPER_MEMSURFACE_TEST_UNDER",
                           "K8sRequiredLabels")
        seeded = tms.certify("K8sRequiredLabels", tc, tlow)
        assert "under-claimed" in (seeded.reason or "")
        assert tms.analyses_run == 2
        monkeypatch.delenv("GATEKEEPER_MEMSURFACE_TEST_UNDER")
        assert tms.certify("K8sRequiredLabels", tc, tlow) == honest
        assert tms.analyses_run == 2


# ---------------------------------------------------------------------------
# the residency planner on K8's plain version, step for step


class _JEx:
    """The reference test's stub of the executor's row-scatter seam."""

    @staticmethod
    def _scatter_rows(name, full, host, rows, accum, axis=1):
        return full.at[:, rows].set(jnp.asarray(host[:, rows]))


def _planners(budget, c_pad, r_pad, page_rows):
    return (jdevpages.ResidencyPlanner(budget, c_pad, r_pad, page_rows),
            tdevpages.ResidencyPlanner(budget, c_pad, r_pad, page_rows))


def _assert_same_state(j, t):
    assert (t.n_slots, t.n_pages, t.active, t.has_mask) \
        == (j.n_slots, j.n_pages, j.active, j.has_mask)
    assert t.slot_of == j.slot_of
    assert list(t.slot_of) == list(j.slot_of)
    assert t.free == j.free
    assert list(t.lru) == j.lru
    assert t.spilled == j.spilled and t.spilled_any == j.spilled_any
    assert (t.spills, t.restores) == (j.spills, j.restores)
    np.testing.assert_array_equal(t.host_mask, j.host_mask)
    if j.dev_buf is None:
        assert t.dev_buf is None
    else:
        assert t.dev_buf.dtype == torch.bool
        np.testing.assert_array_equal(t.dev_buf.numpy(),
                                      np.asarray(j.dev_buf))


def _store_both(j, t, mask):
    calls = residency.page_gather.plain_calls
    j.store(jnp.asarray(mask))
    t.store(torch.from_numpy(mask))
    assert residency.page_gather.plain_calls == calls + 1
    _assert_same_state(j, t)


def _expand_both(j, t, ex):
    want = np.asarray(j.expand(_JEx()))
    got = t.expand(ex)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    _assert_same_state(j, t)
    return want


class TestResidencyPlanner:
    """tests/test_memsurface.py's planner cases, the port's planner on
    K8's plain version beside the reference's."""

    def test_spill_restore_roundtrip_is_bit_identical(self):
        j, t = _planners(256, 8, 128, 16)
        assert t.active and t.n_slots < t.n_pages
        host = np.random.RandomState(7).rand(8, 128) < 0.1
        for p in (j, t):
            p.touch(range(p.n_pages))
        _store_both(j, t, host)
        assert t.spills == t.n_pages - t.n_slots
        scat = residency.page_scatter.plain_calls
        full = _expand_both(j, t, ProgramExecutor("cpu"))
        assert residency.page_scatter.plain_calls == scat + 1
        assert np.array_equal(full, host)
        assert t.restores > 0

    def test_all_zero_pages_restore_for_free(self):
        j, t = _planners(256, 8, 128, 16)
        host = np.zeros((8, 128), dtype=bool)
        host[3, 5] = True
        for p in (j, t):
            p.touch([0])
        _store_both(j, t, host)
        ex = ProgramExecutor("cpu")
        rows0 = ex.h2d_scatter_rows
        assert np.array_equal(_expand_both(j, t, ex), host)
        assert t.restores == 0 and ex.h2d_scatter_rows == rows0

    def test_freed_slots_are_reused_on_working_set_shift(self):
        j, t = _planners(256, 8, 128, 16)
        rng = np.random.RandomState(8)
        host1 = rng.rand(8, 128) < 0.1
        for p in (j, t):
            p.touch(range(p.n_pages))
        _store_both(j, t, host1)
        spills1, hot1 = t.spills, set(t.slot_of)
        host2 = rng.rand(8, 128) < 0.1
        for p in (j, t):
            p.touch(range(p.n_slots))
        _store_both(j, t, host2)
        assert set(t.slot_of) == set(range(t.n_slots)) != hot1
        assert set(t.slot_of.values()) <= set(range(t.n_slots))
        assert len(t.free) + len(t.slot_of) == t.n_slots
        assert t.spills > spills1
        assert np.array_equal(_expand_both(j, t, ProgramExecutor("cpu")),
                              host2)

    def test_inactive_when_claim_fits_budget(self):
        j, t = _planners(1 << 30, 8, 128, 16)
        assert not t.active and not j.active
        assert t.n_slots == j.n_slots

    @pytest.mark.parametrize("budget,c_pad,r_pad,page_rows,density", [
        (256, 8, 128, 16, 0.1),       # the reference test's geometry
        (300, 4, 100, 16, 0.2),       # ragged tail page (rows 96-99)
        (1, 4, 100, 16, 0.05),        # n_slots 1
        (4096, 1, 1000, 32, 0.01),    # c_pad 1, ragged, 8 slots
        (512, 4, 2048, 32, 0.0),      # all-zero masks: no restores
        (64, 2, 50, 1, 0.3),          # one-row pages
    ])
    def test_planner_state_follows_the_reference(self, budget, c_pad, r_pad,
                                                 page_rows, density):
        """Six rounds of touch, store and expand over random masks, the
        touched pages drifting from the lowest to the highest (the
        working set shifts): equal state after every call, and every
        expand equal to the mask stored."""
        j, t = _planners(budget, c_pad, r_pad, page_rows)
        assert t.active
        ex = ProgramExecutor("cpu")
        rng = np.random.default_rng(budget + r_pad)
        n_pages = t.n_pages
        for rnd in range(6):
            lo = rnd * n_pages // 6
            pages = set(rng.integers(lo, min(n_pages, lo + t.n_slots + 2),
                                     size=max(1, t.n_slots // 2)).tolist())
            pages |= {n_pages, -1}          # out of range: ignored
            for p in (j, t):
                p.touch(pages)
            _assert_same_state(j, t)
            mask = rng.random((c_pad, r_pad)) < density
            _store_both(j, t, mask)
            assert len(t.slot_of) == min(t.n_slots, n_pages)
            assert np.array_equal(_expand_both(j, t, ex), mask)
        if density:
            assert t.restores > 0 and t.spills > 0


# ---------------------------------------------------------------------------
# budgeted devpages sweeps: the port against the reference, the port
# unbudgeted and the oracle


def _churn_rounds(resources):
    """tests/test_memsurface.py TestResidencySweepParity's churn: three
    rounds that each give 3 sampled pods a disallowed image."""
    pods = [o for o in resources if (o.get("spec") or {}).get("containers")]
    rng = random.Random(17)
    rounds = []
    for j in range(3):
        batch = []
        for o in rng.sample(pods, 3):
            o = copy.deepcopy(o)
            o["spec"]["containers"][0]["image"] = f"evil.io/memsurface:{j}"
            batch.append(("upsert", o))
        rounds.append(batch)
    return rounds


class TestResidencySweepParity:
    KINDS = ("K8sRequiredLabels", "K8sAllowedRepos", "K8sBlockNodePort")

    def test_budgeted_sweeps_match_reference_unbudgeted_and_oracle(
            self, monkeypatch):
        resources = make_mixed(random.Random(5), 60)
        monkeypatch.setenv("GATEKEEPER_DEVPAGES_BUDGET_BYTES", "256")
        h = library_harness(monkeypatch, self.KINDS, resources, True)
        ud = TorchDriver(device="cpu")
        uc = _client(ud, TBackend, TTarget, tall_docs, self.KINDS)
        uc.add_data_batch(copy.deepcopy(resources))
        u = Side(ud, uc, TOpts)
        sc = _client(LocalDriver(), TBackend, TTarget, tall_docs, self.KINDS)
        sc.add_data_batch(copy.deepcopy(resources))
        gathers = residency.page_gather.plain_calls
        scatters = residency.page_scatter.plain_calls
        totals = {"resident_spills": 0, "resident_restores": 0}
        for rnd, batch in enumerate([[]] + _churn_rounds(resources)):
            h.apply(batch)
            for op, obj in batch:
                u.apply(op, obj)
                sc.add_data(copy.deepcopy(obj))
            got, evs, _oracle = h.sweep(limit=10_000)
            assert sorted(_results(got), key=repr) == sorted(
                _results(sc.audit().results()), key=repr)
            monkeypatch.delenv("GATEKEEPER_DEVPAGES_BUDGET_BYTES")
            plain = u.sweep(monkeypatch, 10_000, True, True)
            monkeypatch.setenv("GATEKEEPER_DEVPAGES_BUDGET_BYTES", "256")
            assert _results(got) == _results(plain)
            assert evs == u.new_events()
            dv = h.dv
            udv = ud.last_sweep_phases["devpages"]
            assert udv["resident_pages_device"] == 0
            assert {k: v for k, v in dv.items() if "resident" not in k
                    and "h2d" not in k and k != "scatter_rows"} == \
                {k: v for k, v in udv.items() if "resident" not in k
                 and "h2d" not in k and k != "scatter_rows"}
            assert dv["kinds_device"] == 3
            assert dv["resident_pages_device"] > 0
            for key in totals:
                totals[key] += dv[key]
        planners = [kp.resident for kp in
                    h.t.drv._state(TARGET).devpages.values()]
        assert len(planners) == 3 and all(p.active for p in planners)
        assert all(kp.mask is None for kp in
                   h.t.drv._state(TARGET).devpages.values())
        assert totals["resident_spills"] > 0
        assert totals["resident_restores"] > 0
        assert residency.page_gather.plain_calls == gathers + 3 * 4
        assert residency.page_scatter.plain_calls == scatters + 3 * 3

    def test_unparsable_budget_means_unbounded(self, monkeypatch):
        """GATEKEEPER_DEVPAGES_BUDGET_BYTES=abc: no planner on either
        side, the full mask stays resident, the counters stay 0."""
        monkeypatch.setenv("GATEKEEPER_DEVPAGES_BUDGET_BYTES", "abc")
        assert tdevpages.residency_budget_bytes() is None
        assert jdevpages.residency_budget_bytes() is None
        resources = make_mixed(random.Random(5), 40)
        h = library_harness(monkeypatch, self.KINDS, resources, True)
        for batch in [[]] + _churn_rounds(resources)[:1]:
            h.apply(batch)
            h.sweep()
            assert h.dv["kinds_device"] == 3
            assert h.dv["resident_pages_device"] == 0
        for kp in h.t.drv._state(TARGET).devpages.values():
            assert kp.resident is None and kp.mask is not None


# ---------------------------------------------------------------------------
# the sweep-order consumer


class TestDriverConsumers:
    def test_sweep_order_weaves_largest_smallest(self, monkeypatch):
        jd, _jc, td, _tc = _drivers(KINDS)
        st = td.state[TARGET]
        order = td.memsurface_sweep_order(st, list(KINDS))
        assert order == jd.memsurface_sweep_order(jd.state[TARGET],
                                                  list(KINDS))
        assert sorted(order) == sorted(KINDS)
        peaks = {k: st.memsurfaces[k].peak_bytes() for k in KINDS}
        assert peaks[order[0]] == max(peaks.values())
        assert peaks[order[1]] == min(peaks.values())
        assert td.metrics.counter("memsurface_sweep_reorders").value == 1
        # a forced full sweep dispatches in that order, same results
        dispatched = []
        kind_bindings = td._kind_bindings

        def recording(st_, kind, *a, **k):
            dispatched.append(kind)
            return kind_bindings(st_, kind, *a, **k)

        monkeypatch.setattr(td, "_kind_bindings", recording)
        monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
        monkeypatch.setattr(jax_driver, "SMALL_WORKLOAD_EVALS", 0)
        got = td.query_audit(TARGET, TOpts(full=True))[0]
        want = jd.query_audit(TARGET, JOpts(full=True))[0]
        assert dispatched == order
        assert _results(got) == _results(want)
        assert td.metrics.counter("memsurface_sweep_reorders").value == 2
        monkeypatch.setenv("GATEKEEPER_HBM_BUDGET", "off")
        assert td.memsurface_sweep_order(st, list(KINDS)) == sorted(KINDS)
        assert td.metrics.counter("memsurface_sweep_reorders").value == 2

    def test_sweep_order_sorted_below_three_kinds(self):
        jd, _jc, td, _tc = _drivers(KINDS[:2])
        assert td.memsurface_sweep_order(td.state[TARGET], list(KINDS[:2])) \
            == jd.memsurface_sweep_order(jd.state[TARGET], list(KINDS[:2])) \
            == sorted(KINDS[:2])
