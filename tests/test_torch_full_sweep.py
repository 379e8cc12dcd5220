"""Forced full sweeps through the port against the reference.

The four flows of tests/test_full_sweep.py (library parity under churn,
device-path parity and phases, serial against pipelined, the audit
manager's full report) on TorchDriver(device="cpu"), JaxDriver and
LocalDriver over the same store, with the port's SMALL_WORKLOAD_EVALS at
0: results equal, the phase report carries the reference's keys less the
stanzas of layers the port has not got (dedup, footprint, shard,
external, what-if), and ``h2d_bytes`` equals the reference's (the same
bindings, ``Bindings.nbytes()`` on both sides).  The two flows of
tests/test_obs.py::TestAttribution through the port, units and shares
equal to the reference's for the same sweep.  The port dispatches a
forced full sweep's kinds one at a time (the reference's serial mode),
so its sweep is held against both of the reference's modes.  Then what
the port adds: its spans, an error of one kind's dispatch ending the
sweep, one evaluation a kind across the library, and the audit
calibration window kept apart from the price of an admission batch.
"""

import random

import pytest

from gatekeeper_tpu.analysis import costmodel as ref_costmodel
from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.client.local_driver import LocalDriver
from gatekeeper_tpu.engine import jax_driver
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.library import (LIBRARY, all_docs, constraint_doc,
                                    template_doc)
from gatekeeper_tpu.library.templates import constraint_doc as lib_cdoc
from gatekeeper_tpu.library.workload import make_mixed
from gatekeeper_tpu.obs.attribution import \
    attribute_sweep as ref_attribute_sweep
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch.analysis import costmodel
from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.client.interface import QueryOpts
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.obs.attribution import attribute_sweep
from gatekeeper_tpu_torch.obs.flightrecorder import get_flight_recorder
from gatekeeper_tpu_torch.obs.trace import get_tracer
from gatekeeper_tpu_torch.target.k8s import TARGET_NAME
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget

# the reference's phase stanzas of layers the port has not got yet:
# dedup and footprint (ROADMAP A6), shard (A10), whatif (A7).  The
# ``external`` stanza is compared: it appears on both sides exactly when
# a provider is registered
UNPORTED_STANZAS = {"dedup", "footprint", "shard", "whatif"}
FULL_KEYS = {"full", "serial", "host_prep_s", "h2d_s", "device_s",
             "format_s", "h2d_bytes", "pipeline_wall_s", "overlap_fraction",
             "attribution", "pages", "devpages"}


@pytest.fixture(autouse=True)
def _device_path_at_test_sizes(monkeypatch):
    """Drive the device path at test sizes (the port's own copy of the
    small-workload threshold; conftest zeroes the reference's), with no
    external-data runtime installed in either package, as a process that
    has just started has (the ``external`` stanza appears only with a
    provider registered)."""
    from gatekeeper_tpu.externaldata import runtime as j_runtime
    from gatekeeper_tpu_torch.externaldata import runtime as t_runtime
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.setattr(j_runtime, "_runtime", None)
    monkeypatch.setattr(t_runtime, "_runtime", None)


def _keys(results):
    return [(r.msg, r.constraint["metadata"]["name"],
             (r.review or {}).get("name")) for r in results]


def _three():
    td, jd, ld = TorchDriver(device="cpu"), JaxDriver(), LocalDriver()
    return (td, jd, ld), (TBackend(td).new_client([TTarget()]),
                          JBackend(jd).new_client([JTarget()]),
                          JBackend(ld).new_client([JTarget()]))


def _fill_library(client, resources):
    for tdoc, cdoc in all_docs():
        client.add_template(tdoc)
        client.add_constraint(cdoc)
    for r in resources:
        client.add_data(r)


def _small_device(client, rng_seed, n=150, n_con=3):
    """tests/test_full_sweep.py's small device workload: K8sRequiredLabels
    with three constraints over 150 namespaces."""
    rng = random.Random(rng_seed)
    labels = ["l0", "l1", "l2", "l3", "l4"]
    resources = []
    for i in range(n):
        resources.append({
            "apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": f"ns-{i:04d}",
                         "labels": {k: "v" for k in labels
                                    if rng.random() < 0.4}}})
    params = [rng.sample(labels, k=2) for _ in range(n_con)]
    client.add_template(template_doc("K8sRequiredLabels",
                                     LIBRARY["K8sRequiredLabels"][0]))
    for j, p in enumerate(params):
        client.add_constraint(constraint_doc(
            "K8sRequiredLabels", f"labels-{j}", {"labels": p}))
    client.add_data_batch(resources)


def test_full_sweep_parity_library_under_churn():
    """audit(full=True) through the port equals the reference's forced
    full sweep, the scalar oracle and the port's memoized sweeps on
    unchanged data, across the library — before and after churn."""
    resources = make_mixed(random.Random(5), 120)
    (td, jd, _ld), (ct, cj, cl) = _three()
    for c in (ct, cj, cl):
        _fill_library(c, resources)

    memo1 = _keys(ct.audit().results())
    memo2 = _keys(ct.audit().results())
    full1 = _keys(ct.audit(full=True).results())
    assert td.last_sweep_phases["device_s"] > 0
    memo3 = _keys(ct.audit().results())
    assert memo1 == memo2 == full1 == memo3
    assert len(full1) > 50
    assert full1 == _keys(cj.audit(full=True).results())
    assert full1 == _keys(cl.audit().results())

    churn = random.Random(7)
    for r in churn.sample(resources, len(resources) // 3):
        md = r.setdefault("metadata", {})
        md["labels"] = {k: "v" for k in ["l0", "owner", "team"]
                        if churn.random() < 0.5}
        for c in (ct, cj, cl):
            c.add_data(r)
    full_churned = _keys(ct.audit(full=True).results())
    assert full_churned == _keys(cj.audit(full=True).results())
    assert full_churned == _keys(cl.audit().results())
    assert _keys(ct.audit().results()) == full_churned


def test_full_sweep_device_path_parity_and_phases(monkeypatch):
    """Device-path forced full sweep: the reference's results, a rebuilt
    memo layer, the reference's phase keys (less unported stanzas) and
    upload bytes, the full-sweep metrics, and the sweep's spans."""
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    (td, jd, _ld), (ct, cj, cl) = _three()
    for c in (ct, cj, cl):
        _small_device(c, 3)

    memo = _keys(ct.audit().results())
    st = td.state[TARGET_NAME]
    cache_before = st.bindings_cache
    assert cache_before
    get_tracer().reset()
    full = _keys(ct.audit(full=True).results())
    ref_full = _keys(cj.audit(full=True).results())
    assert full == memo == ref_full == _keys(cl.audit().results())
    assert td.state[TARGET_NAME].bindings_cache is not cache_before
    assert td.state[TARGET_NAME].bindings_cache

    phases, ref = td.last_sweep_phases, jd.last_sweep_phases
    assert set(phases) == FULL_KEYS
    assert set(phases) == set(ref) - UNPORTED_STANZAS
    assert phases["full"] is True and phases["serial"] is True
    assert phases["host_prep_s"] > 0 and phases["device_s"] > 0
    # the same bindings on both sides: equal upload bytes
    assert phases["h2d_bytes"] == ref["h2d_bytes"] > 0
    assert phases["h2d_bytes"] == sum(
        b.nbytes() for _k, b in td.state[TARGET_NAME]
        .bindings_cache.values())
    # one kind's stages end before the next kind's begin
    assert phases["overlap_fraction"] == 0.0
    assert phases["pipeline_wall_s"] > 0
    snap = td.metrics.snapshot()
    assert snap["full_sweeps"] == 1
    assert "full_sweep_overlap_fraction" in snap
    assert snap["full_sweep_h2d_bytes"] == phases["h2d_bytes"]
    assert snap["full_sweep_device"]["count"] == 1

    # the root span and its four stage children, parented by the
    # explicit sweep context
    events = get_tracer().export()["traceEvents"]
    (root,) = [e for e in events if e["name"] == "audit.sweep"]
    assert root["args"]["full"] is True
    assert root["args"]["results"] == len(full)
    kids = {e["name"] for e in events
            if e["args"].get("parent_span_id") == root["args"]["span_id"]}
    assert {"kind.host_prep", "kind.h2d", "kind.device",
            "kind.format"} <= kids
    sweeps = [e for e in get_flight_recorder().snapshot()
              if e["type"] == "sweep"]
    assert sweeps[-1]["full"] is True and sweeps[-1]["device_s"] > 0

    # a memoized sweep records no phase breakdown
    ct.audit()
    assert set(td.last_sweep_phases) == {"full", "pages", "devpages"}
    assert td.last_sweep_phases["full"] is False
    cj.audit()
    assert set(jd.last_sweep_phases) - UNPORTED_STANZAS == \
        {"full", "pages", "devpages"}


def test_full_sweep_serial_mode_matches_pipelined(monkeypatch):
    """The port's forced full sweep, which dispatches one kind at a time
    and says so in its phase record, equals the reference's in both of
    its modes, pipelined and FULL_SWEEP_SERIAL, sweep after sweep."""
    (td, jd, _ld), (ct, cj, _cl) = _three()
    for c in (ct, cj):
        _small_device(c, 9)
    first = _keys(ct.audit(full=True).results())
    piped = _keys(cj.audit(full=True).results())
    assert jd.last_sweep_phases["serial"] is False
    monkeypatch.setattr(jax_driver, "FULL_SWEEP_SERIAL", True)
    serial = _keys(cj.audit(full=True).results())
    assert jd.last_sweep_phases["serial"] is True
    assert first == _keys(ct.audit(full=True).results()) == serial == piped
    phases = td.last_sweep_phases
    assert phases["full"] is True and phases["serial"] is True
    assert phases["device_s"] > 0 and phases["overlap_fraction"] == 0.0


def test_audit_manager_full_report():
    """AuditManager.audit_once(full=True) carries the per-phase sweep
    metrics into its report and its flight event, as the reference's
    does, with the same violations."""
    from gatekeeper_tpu.audit.manager import AuditManager as JAuditManager
    from gatekeeper_tpu.cluster.fake import FakeCluster as JFakeCluster
    from gatekeeper_tpu.controllers.constrainttemplate import \
        TEMPLATE_GVK as JTEMPLATE_GVK
    from gatekeeper_tpu.controllers.registry import \
        add_to_manager as jadd_to_manager
    from gatekeeper_tpu_torch.audit.manager import AuditManager
    from gatekeeper_tpu_torch.cluster.fake import FakeCluster
    from gatekeeper_tpu_torch.controllers.constrainttemplate import \
        TEMPLATE_GVK
    from gatekeeper_tpu_torch.controllers.registry import add_to_manager
    from tests.test_audit_manager import template_crd_obj
    from tests.test_control_plane import (NS_GVK, constraint_obj, ns_obj,
                                          template_obj)

    reports = {}
    for name, (cluster, driver, gvk, add, am_cls) in {
            "port": (FakeCluster(), TorchDriver(device="cpu"), TEMPLATE_GVK,
                     add_to_manager, AuditManager),
            "ref": (JFakeCluster(), JaxDriver(), JTEMPLATE_GVK,
                    jadd_to_manager, JAuditManager)}.items():
        backend = TBackend if name == "port" else JBackend
        target = TTarget if name == "port" else JTarget
        cluster.register_kind(gvk, "constrainttemplates")
        cluster.register_kind(NS_GVK, "namespaces")
        client = backend(driver).new_client([target()])
        plane = add(cluster, client)
        cluster.create(template_crd_obj())
        cluster.create(template_obj())
        plane.run_until_idle()
        cluster.create(constraint_obj())
        plane.run_until_idle()
        for i in range(10):
            obj = ns_obj(f"ns{i:03d}", {"gatekeeper": "on"} if i % 2
                         else None)
            cluster.create(obj)
            client.add_data(obj)
        am = am_cls(cluster, client, sleep=lambda _s: None)
        memo = am.audit_once()
        assert memo["full"] is False and "host_prep_s" not in memo
        reports[name] = (memo, am.audit_once(full=True))
    memo, report = reports["port"]
    ref_memo, ref_report = reports["ref"]
    assert report["skipped"] is False and report["full"] is True
    for k in ("host_prep_s", "h2d_s", "device_s", "overlap_fraction",
              "attribution"):
        assert k in report and k in ref_report, k
    assert report["device_s"] > 0
    assert report["violations"] == memo["violations"] \
        == ref_report["violations"] == ref_memo["violations"] > 0
    ev = [e for e in get_flight_recorder().snapshot()
          if e["type"] == "audit_sweep"][-1]
    assert ev["full"] is True
    assert (ev["device_s"], ev["host_prep_s"], ev["overlap_fraction"]) == \
        (round(report["device_s"], 6), round(report["host_prep_s"], 6),
         round(report["overlap_fraction"], 6))


# ----------------------------------------------------------------------
# tests/test_obs.py::TestAttribution through the port

def _attribution_client(backend, driver, target, n=24, seed=7):
    client = backend(driver).new_client([target()])
    for kind in ("K8sRequiredLabels", "K8sAllowedRepos",
                 "K8sDisallowedTags"):
        rego, params = LIBRARY[kind]
        client.add_template(template_doc(kind, rego))
        client.add_constraint(constraint_doc(kind, kind.lower() + "-1",
                                             params))
    client.add_data_batch(make_mixed(random.Random(seed), n))
    return client


class TestAttribution:
    def test_unit_fallback_weights_sum_exactly(self):
        entries = [("A", object(), 2), ("B", object(), 3),
                   ("C", object(), 1)]
        costmodel.reset_calibration()
        ref_costmodel.reset_calibration()
        out = attribute_sweep(entries, device_s=0.9, n_rows=100)
        rows = out["templates"]
        assert [r["template"] for r in rows] == ["A", "B", "C"]
        assert abs(sum(r["device_seconds"] for r in rows) - 0.9) < 1e-9
        assert all(abs(r["share"] - 1 / 3) < 1e-6 for r in rows)
        assert costmodel.calibration_info("audit")["samples"] == 3
        assert costmodel.calibration_info()["samples"] == 0
        assert out == ref_attribute_sweep(entries, device_s=0.9,
                                          n_rows=100)

    def test_full_sweep_attribution_sums_to_device_time(self):
        costmodel.reset_calibration()
        td, jd = TorchDriver(device="cpu"), JaxDriver()
        _attribution_client(TBackend, td, TTarget)
        _attribution_client(JBackend, jd, JTarget)
        got, _ = td.query_audit(TARGET_NAME, QueryOpts(full=True))
        assert got, "workload must produce violations"
        att = td.last_sweep_phases.get("attribution")
        assert att is not None
        total = sum(r["device_seconds"] for r in att["templates"])
        assert att["device_s"] > 0
        assert abs(total - att["device_s"]) / att["device_s"] < 0.01
        assert {r["template"] for r in att["templates"]} == {
            "K8sRequiredLabels", "K8sAllowedRepos", "K8sDisallowedTags"}
        assert all(r["measured_seconds"] for r in att["templates"])
        assert costmodel.calibration_info("audit")["samples"] >= 3
        text = td.metrics.render_prometheus()
        assert ('gatekeeper_template_device_seconds'
                '{template="K8sRequiredLabels"}') in text
        # the reference's units and shares for the same sweep
        jd.query_audit(TARGET_NAME, QueryOpts(full=True))
        ref_att = jd.last_sweep_phases["attribution"]
        assert [(r["template"], r["units"]) for r in att["templates"]] == \
            [(r["template"], r["units"]) for r in ref_att["templates"]]
        assert [r["share"] for r in att["templates"]] == \
            [r["share"] for r in ref_att["templates"]]
        td.query_audit(TARGET_NAME, QueryOpts(full=False))
        assert "attribution" not in td.last_sweep_phases


# ----------------------------------------------------------------------
# what the port adds

def test_a_dispatch_error_ends_the_sweep(monkeypatch):
    """An exception of one kind's dispatch ends the forced full sweep
    (no host fallback), and the next sweep runs whole."""
    td = TorchDriver(device="cpu")
    c = _attribution_client(TBackend, td, TTarget)
    run = td.executor.run_topk_async
    victim = td.state[TARGET_NAME].templates["K8sAllowedRepos"] \
        .vectorized.program

    def broken(program, bindings, k, *a, **kw):
        if program is victim:
            raise RuntimeError("launch refused")
        return run(program, bindings, k, *a, **kw)

    monkeypatch.setattr(td.executor, "run_topk_async", broken)
    with pytest.raises(RuntimeError, match="launch refused"):
        c.audit(limit_per_constraint=20, full=True)
    monkeypatch.setattr(td.executor, "run_topk_async", run)
    assert c.audit(limit_per_constraint=20, full=True).results()


def test_library_full_sweep_counts_one_eval_per_kind():
    """A forced full sweep of the whole library evaluates each device
    kind once and reduces it once, and the bytes it meters equal the
    kinds' bindings', sweep after sweep."""
    resources = make_mixed(random.Random(11), 60)
    td = TorchDriver(device="cpu")
    c = TBackend(td).new_client([TTarget()])
    _fill_library(c, resources)
    ex = td.executor
    for _ in range(3):
        before = (ex.mask_evals, ex.reduces)
        c.audit(limit_per_constraint=20, full=True)
        kinds = td.state[TARGET_NAME].bindings_cache
        assert (ex.mask_evals - before[0], ex.reduces - before[1]) == \
            (len(kinds), len(kinds))
        assert td.last_sweep_phases["h2d_bytes"] == sum(
            b.nbytes() for _k, b in kinds.values())
    assert len(kinds) > 30


def test_full_sweep_leaves_admission_prediction_unchanged():
    """A forced full sweep's per-template device seconds calibrate the
    audit window only: the admission batch price the micro-batcher fits
    to deadlines (predict_review_batch_seconds, the review window or its
    static prior) is the same after the sweep as before it."""
    costmodel.reset_calibration()
    try:
        td = TorchDriver(device="cpu")
        c = _attribution_client(TBackend, td, TTarget)
        before = td.predict_review_batch_seconds(TARGET_NAME, 64)
        assert before is not None and before > 0
        for _ in range(2):
            c.audit(limit_per_constraint=20, full=True)
        assert td.last_sweep_phases["attribution"]["templates"]
        assert costmodel.calibration_info("audit")["samples"] == 6
        assert costmodel.calibration_info()["samples"] == 0
        assert td.predict_review_batch_seconds(TARGET_NAME, 64) == before
    finally:
        costmodel.reset_calibration()


EXT_SIG = """package k8sextsig
violation[{"msg": msg}] {
  image := input.review.object.spec.image
  verdict := object.get(external_data({"provider": "sig-prov", "keys": [image]}), ["responses", image], "missing")
  verdict == "invalid"
  msg := sprintf("image %v rejected: %v", [image, verdict])
}
"""


@pytest.mark.parametrize("full", [True, False])
def test_external_stanza_is_compared_with_a_provider(full, monkeypatch):
    """With a provider registered in each package's runtime (a fake over
    the same data) a forced full sweep and a memoized one carry the
    ``external`` stanza on both sides, with the same keys, provider
    keys and bulk-warm keys; the phase keys equal the reference's less
    the unported stanzas; results equal the scalar oracle's."""
    import gatekeeper_tpu.api.externaldata as j_api
    import gatekeeper_tpu.externaldata as j_ext
    import gatekeeper_tpu_torch.api.externaldata as t_api
    import gatekeeper_tpu_torch.externaldata as t_ext
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    data = {f"img-{i}": ("invalid" if i % 3 == 0 else "valid")
            for i in range(8)}
    try:
        for api, ext in ((t_api, t_ext), (j_api, j_ext)):
            rt = ext.ExternalDataRuntime()
            ext.set_runtime(rt)
            ext.register_fake("sig", ext.FakeProvider(dict(data)))
            rt.register(api.Provider(name="sig-prov", url="fake://sig",
                                     failure_policy="Ignore"))
        (td, jd, _ld), (ct, cj, cl) = _three()
        rng = random.Random(4)
        pods = [{"apiVersion": "v1", "kind": "Pod",
                 "metadata": {"name": f"p{i}", "namespace": "default"},
                 "spec": {"image": f"img-{rng.randrange(10)}"}}
                for i in range(40)]
        for c in (ct, cj, cl):
            _small_device(c, 3)
            c.add_template(template_doc("K8sExtSig", EXT_SIG))
            c.add_constraint(lib_cdoc("K8sExtSig", "sig-check", match={
                "kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}))
            c.add_data_batch(pods)
        got = _keys(ct.audit(full=full).results())
        assert got == _keys(cj.audit(full=full).results()) \
            == _keys(cl.audit().results())
        assert sum(1 for r in got if "rejected" in r[0]) > 0
        phases, ref = td.last_sweep_phases, jd.last_sweep_phases
        assert set(phases) == set(ref) - UNPORTED_STANZAS
        assert "external" in phases
        t_ext_st, j_ext_st = phases["external"], ref["external"]
        assert sorted(t_ext_st) == sorted(j_ext_st) \
            == ["bulk_prefetch", "providers"]
        assert sorted(t_ext_st["providers"]["sig-prov"]) == \
            sorted(j_ext_st["providers"]["sig-prov"])
        assert sorted(t_ext_st["bulk_prefetch"]) == \
            sorted(j_ext_st["bulk_prefetch"])
        assert t_ext_st["bulk_prefetch"]["keys"] == \
            j_ext_st["bulk_prefetch"]["keys"] == len(
                {p["spec"]["image"] for p in pods})
    finally:
        for ext in (t_ext, j_ext):
            ext.set_runtime(None)
            ext.clear_fakes()
