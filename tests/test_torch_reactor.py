"""The port's event reactor (enforce/reactor.py) and its driver entry
points against the reference, on the CPU.

- The ten flows of tests/test_reactor.py (single event, coalescing, gap,
  duplicate, reorder, overflow, stall, stale RV, clean resync, detach),
  each run on the reference (JaxDriver) and on the port
  (TorchDriver(device="cpu")) over the same make_mixed cluster, with
  GATEKEEPER_DEVPAGES on and off: the same state transitions, reactor
  counters (pathologies, rungs), ledger events and final verdicts, and
  verdicts equal to a GATEKEEPER_PAGES=off oracle over the cluster.
  The reference's reactor hands ``Client.react``/``resync`` the watch
  stream's resource kind (``Pod``), which its ``react_kind`` looks up
  among the template kinds and so folds nothing until the next sweep;
  the port's ``react_kind`` maps a resource kind to the template kinds
  that can match it.  So the reference side runs its own ``react_kind``
  and ``resync_kind`` once for each of those template kinds
  (``_mapped``); ``test_reference_rung1_folds_nothing`` holds the
  difference itself (ROADMAP Queue C).
- The six driver entry points against the reference's on make_mixed
  (seed 5): ``devpages_report``, ``page_of_object``, ``kind_residents``,
  ``ledger_rv`` and the accounting dicts of ``react_kind`` and
  ``resync_kind``.
- resilience/faults.py against the reference's: parsing, one-shot
  ``take``, ``rearm``; arming a fault whose seam the port lacks raises.
- The kept error: a react whose kernel raises makes the next
  ``audit_once`` raise once, after its sweep, or ``stop()`` when no
  sweep took it, with counters equal to the reference's; under the
  running audit loop the sweeps go on and the error stays kept.
- The re-react: with ``apply_objects`` off, a store write that lands
  after the react, however late, reaches the ledger one pump later.
- tests/test_concurrency.py's paged-reactor writers test, both devpages
  modes, and the ``queue_storm`` seam through both micro-batchers.
"""

import collections
import copy
import functools
import os
import random
import threading
import time
import traceback
import types

import pytest

from gatekeeper_tpu.analysis import footprint as jfootprint
from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.client.interface import QueryOpts as JOpts
from gatekeeper_tpu.cluster import fake as jfake
from gatekeeper_tpu.engine import jax_driver
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.enforce import reactor as jreactor
from gatekeeper_tpu.library import all_docs as jall_docs
from gatekeeper_tpu.library import make_mixed
from gatekeeper_tpu.resilience import faults as jfaults
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch.analysis import footprint as tfootprint
from gatekeeper_tpu_torch.audit.manager import AuditManager
from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.client.interface import QueryOpts as TOpts
from gatekeeper_tpu_torch.cluster import fake as tfake
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.enforce import reactor as treactor
from gatekeeper_tpu_torch.kernels import devdelta
from gatekeeper_tpu_torch.library import all_docs as tall_docs
from gatekeeper_tpu_torch.resilience import faults as tfaults
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget

TARGET = "admission.k8s.gatekeeper.sh"
KINDS = ("K8sRequiredLabels", "K8sAllowedRepos")
EVENT_KEYS = ("seq", "target", "op", "kind", "constraint", "resource", "msg")
REACTOR_ENV = ("GATEKEEPER_FAULT", "GATEKEEPER_REACTOR_QUEUE",
               "GATEKEEPER_REACTOR_STALL_S", "GATEKEEPER_REACTOR_BACKOFF_S",
               "GATEKEEPER_REACTOR_GAP_GRACE_S",
               "GATEKEEPER_REACTOR_ESCALATE_S",
               "GATEKEEPER_SNAPSHOT_DIR",
               "GATEKEEPER_DEVPAGES_BUDGET_BYTES", "GATEKEEPER_FAULT_STALL_S")
DEADLINE_S = 30.0


@pytest.fixture(autouse=True)
def _reactor_env(monkeypatch):
    """The reference test's environment on both sides; footprint state
    is process-global on both and feeds page eligibility."""
    for fp in (jfootprint, tfootprint):
        monkeypatch.setattr(fp, "_memo", {})
        monkeypatch.setattr(fp, "cross_row", {})
        monkeypatch.setattr(fp, "violations", {})
        monkeypatch.setattr(fp, "analyses_run", 0)
    monkeypatch.setenv("GATEKEEPER_PAGES", "on")
    monkeypatch.setenv("GATEKEEPER_PAGE_ROWS", "8")
    for name in REACTOR_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(jax_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    jfaults.reset_for_tests()
    tfaults.reset_for_tests()
    yield
    jfaults.reset_for_tests()
    tfaults.reset_for_tests()


def wait_for(cond, what: str, timeout: float = DEADLINE_S) -> None:
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, f"{what}: no progress"
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# the two sides


def _pkg(side: str) -> types.SimpleNamespace:
    if side == "ref":
        return types.SimpleNamespace(
            side=side, driver=JaxDriver, Backend=JBackend, Target=JTarget,
            docs=jall_docs, Opts=JOpts, fake=jfake, reactor=jreactor,
            faults=jfaults)
    return types.SimpleNamespace(
        side=side, driver=lambda: TorchDriver(device="cpu"),
        Backend=TBackend, Target=TTarget, docs=tall_docs, Opts=TOpts,
        fake=tfake, reactor=treactor, faults=tfaults)


def _client(pkg, kinds=KINDS):
    drv = pkg.driver()
    c = pkg.Backend(drv).new_client([pkg.Target()])
    for tdoc, cdoc in pkg.docs():
        if tdoc["spec"]["crd"]["spec"]["names"]["kind"] in kinds:
            c.add_template(tdoc)
            c.add_constraint(cdoc)
    return drv, c


def _mapped(client, jd) -> None:
    """Run the reference client's ``react``/``resync`` of a resource kind
    as its own ``react_kind``/``resync_kind`` once for each template kind
    whose constraints can match that kind (the reference's
    ``_observable_kinds``), which is what the port's driver does for a
    resource kind.  None and template kinds pass through."""
    react, resync = client.react, client.resync

    def kinds_of(kind):
        st = jd.state[TARGET]
        if kind is None or kind in st.templates:
            return [kind]
        out = []
        for k in sorted(st.templates):
            obs = jd._observable_kinds(st.templates[k],
                                       jd._kind_constraints(st, k))
            if obs is None or kind in obs:
                out.append(k)
        return out

    def over(fn):
        def run(kind=None):
            out = None
            for k in kinds_of(kind):
                r = fn(k)
                if r is not None:
                    out = r if out is None else {
                        key: out.get(key, 0) + v for key, v in r.items()
                        if not isinstance(v, dict)}
            return out
        return run

    client.react, client.resync = over(react), over(resync)


def _verdicts(results):
    return sorted(
        ((r.constraint or {}).get("kind", ""),
         ((r.constraint or {}).get("metadata") or {}).get("name", ""),
         (((r.resource or {}).get("metadata") or {}).get("name")
          or (r.review or {}).get("name", "")),
         r.msg) for r in results)


class _Fixture:
    """tests/test_reactor.py's fixture on one side: cluster + live
    reactor-fed client (apply_objects on), with a pages-off oracle
    rebuilt from the cluster on demand."""

    def __init__(self, side: str, n: int = 24, seed: int = 5,
                 mapped: bool = True):
        self.pkg = pkg = _pkg(side)
        self.rng = random.Random(seed)
        self.resources = make_mixed(self.rng, n)
        self.cluster = pkg.fake.FakeCluster()
        for o in self.resources:
            self.cluster.create(copy.deepcopy(o))
        self.gvks = sorted({pkg.fake.gvk_of(o) for o in self.resources},
                           key=lambda g: g.kind)
        self.jd, self.client = _client(pkg)
        if side == "ref" and mapped:
            _mapped(self.client, self.jd)
        objs = [o for g in self.gvks for o in self.cluster.list(g)]
        self.client.add_data_batch(copy.deepcopy(objs))
        self.rx = pkg.reactor.Reactor(self.client, cluster=self.cluster,
                                      apply_objects=True, seed=seed)
        for g in self.gvks:
            self.rx.attach(g)
        self.opts = pkg.Opts(limit_per_constraint=100)
        self.jd.query_audit(TARGET, self.opts)      # cold build

    @property
    def ledger(self):
        return self.jd.state[TARGET].ledger

    def live_verdicts(self):
        return _verdicts(self.jd.query_audit(TARGET, self.opts)[0])

    def oracle_verdicts(self):
        drv, c = _client(_pkg("port"))
        objs = [o for g in self.gvks for o in self.cluster.list(g)]
        c.add_data_batch(copy.deepcopy(objs))
        os.environ["GATEKEEPER_PAGES"] = "off"
        try:
            return _verdicts(drv.query_audit(TARGET, TOpts(
                limit_per_constraint=100))[0])
        finally:
            os.environ["GATEKEEPER_PAGES"] = "on"

    def mutate(self, label_val):
        src = self.rng.choice(self.resources)
        gvk = self.pkg.fake.gvk_of(src)
        cur = self.cluster.get(gvk, src["metadata"]["name"],
                               src["metadata"].get("namespace"))
        o = copy.deepcopy(cur)
        o.setdefault("metadata", {}).setdefault(
            "labels", {})["t"] = str(label_val)
        return self.cluster.update(o)

    def events(self):
        led = self.ledger
        return [] if led is None else \
            [tuple(e[k] for k in EVENT_KEYS) for e in led.events]

    def record(self) -> dict:
        live, oracle = self.live_verdicts(), self.oracle_verdicts()
        assert live == oracle
        return {"counters": dict(self.rx.counters),
                "transitions": [(t["from"], t["to"], t["reason"])
                                for t in self.rx.transitions],
                "state": self.rx.state, "events": self.events(),
                "verdicts": live}


def _set(name, value):
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


# -- the ten flows of tests/test_reactor.py, on one side --------------------


def flow_single_event(fx):
    updated = fx.mutate("one")
    payload = fx.rx.state_payload()
    kind = updated["kind"]
    assert payload["kinds"][kind]["pending"] == 1
    assert payload["kinds"][kind]["pending_pages"] == 1
    assert fx.jd.state[TARGET].table.n_pages > 1
    fx.rx.pump()
    assert fx.rx.counters["events"] == 1
    assert fx.rx.counters["rung1"] == 1
    assert fx.rx.counters["rung2"] == 0


def flow_coalescing(fx):
    for i in range(10):
        fx.mutate(i)
    fx.rx.pump()
    assert fx.rx.counters["events"] == 10
    assert fx.rx.counters["rung1"] <= len(fx.gvks)


def _expire_gaps(fx):
    """Wait until every suspected gap's grace deadline has passed."""
    wait_for(lambda: all(dl <= time.monotonic()
                         for st in fx.rx._streams.values()
                         for dl in st.missing.values()), "gap grace")


def flow_gap(fx):
    _set("GATEKEEPER_REACTOR_GAP_GRACE_S", "0.05")
    _set("GATEKEEPER_FAULT", "watch_gap")
    lost = fx.mutate("lost")            # this frame never arrives
    _set("GATEKEEPER_FAULT", None)
    _expire_gaps(fx)
    fx.rx.pump()
    assert fx.rx.counters["pathology_gap"] == 1
    assert fx.rx.counters["rung2"] >= 1
    assert lost["kind"] in [g.kind for g in fx.gvks]
    assert fx.rx.state == fx.pkg.reactor.LIVE


def flow_duplicate(fx):
    _set("GATEKEEPER_FAULT", "watch_duplicate")
    fx.mutate("dup")
    _set("GATEKEEPER_FAULT", None)
    fx.rx.pump()
    assert fx.rx.counters["pathology_duplicate"] == 1
    assert fx.rx.counters["rung2"] == 0


def flow_reorder(fx):
    # a grace no run outlasts: the late frame must heal the suspicion
    _set("GATEKEEPER_REACTOR_GAP_GRACE_S", "600")
    _set("GATEKEEPER_FAULT", "watch_reorder")
    fx.mutate("late")
    fx.mutate("after")
    _set("GATEKEEPER_FAULT", None)
    fx.rx.pump()
    assert fx.rx.counters["pathology_out_of_order"] >= 1
    assert fx.rx.counters["pathology_gap"] == 0
    assert fx.rx.counters["rung2"] == 0


def flow_overflow(fx):
    _set("GATEKEEPER_REACTOR_QUEUE", "2")
    kind = collections.Counter(
        o["kind"] for o in fx.resources).most_common(1)[0][0]
    targets = [o for o in fx.resources if o["kind"] == kind]
    assert len(targets) > 3
    gvk_of = fx.pkg.fake.gvk_of
    for i, src in enumerate(targets):
        cur = fx.cluster.get(gvk_of(src), src["metadata"]["name"],
                             src["metadata"].get("namespace"))
        o = copy.deepcopy(cur)
        o.setdefault("metadata", {}).setdefault("labels", {})["t"] = str(i)
        fx.cluster.update(o)
    fx.rx.pump()
    _set("GATEKEEPER_FAULT", "watch_flood")
    for i, src in enumerate(targets[:3]):
        cur = fx.cluster.get(gvk_of(src), src["metadata"]["name"],
                             src["metadata"].get("namespace"))
        o = copy.deepcopy(cur)
        o.setdefault("metadata", {}).setdefault("labels", {})["f"] = str(i)
        fx.cluster.update(o)
    _set("GATEKEEPER_FAULT", None)
    fx.rx.pump()
    fx.rx.pump()
    assert fx.rx.counters["pathology_overflow"] >= 1
    assert fx.rx.counters["rung2"] >= 1


def flow_stall(fx):
    """Degrade, one failed reconnect while the fault stays armed, then a
    reconnect: each pump once its timer has passed (no fixed window)."""
    _set("GATEKEEPER_REACTOR_STALL_S", "0.05")
    _set("GATEKEEPER_REACTOR_BACKOFF_S", "0.02")
    rx, mod = fx.rx, fx.pkg.reactor
    _set("GATEKEEPER_FAULT", "watch_stall")
    for i in range(3):
        fx.mutate(f"s{i}")              # frames buffer unstamped
    wait_for(lambda: rx._stall_since is not None
             and time.monotonic() - rx._stall_since > 0.05, "stall")
    rx.pump()                           # watchdog: stream is dead
    assert rx.state == mod.DEGRADED
    wait_for(lambda: time.monotonic() >= rx._reconnect_at, "backoff")
    rx.pump()                           # reconnect attempt fails (armed)
    assert rx.state == mod.DEGRADED
    assert rx.counters["reconnect_attempts"] == 1
    _set("GATEKEEPER_FAULT", None)
    wait_for(lambda: time.monotonic() >= rx._reconnect_at, "backoff")
    rx.pump()
    assert rx.state == mod.LIVE
    assert rx.counters["reconnects"] == 1
    states = [t["to"] for t in rx.transitions]
    assert states[-1] == mod.LIVE and mod.DEGRADED in states


def flow_stale_rv(fx):
    kind = fx.gvks[0].kind
    st = fx.rx._streams[kind]
    st.rv_floor = 10 ** 9
    st.rv_checked = False
    gvk_of = fx.pkg.fake.gvk_of
    src = next(o for o in fx.resources if o["kind"] == kind)
    cur = fx.cluster.get(gvk_of(src), src["metadata"]["name"],
                         src["metadata"].get("namespace"))
    o = copy.deepcopy(cur)
    o.setdefault("metadata", {}).setdefault("labels", {})["t"] = "rv"
    fx.cluster.update(o)
    fx.rx.pump()
    assert fx.rx.counters["pathology_stale_rv"] >= 1
    assert fx.rx.counters["rung2"] >= 1
    assert fx.rx._streams[kind].rv_checked
    fx.mutate("post")
    fx.rx.pump()
    assert fx.rx.state == fx.pkg.reactor.LIVE


def flow_clean_resync(fx):
    for i in range(6):
        fx.mutate(i)
    fx.rx.pump()
    seq0 = fx.ledger.seq
    fx.client.resync(None)              # whole-ladder forced resync
    assert fx.ledger.seq == seq0        # no phantom appear/clear events


def flow_detach(fx):
    for g in fx.gvks:
        fx.rx.detach(g.kind)
    fx.mutate("ignored")
    fx.rx.pump()
    assert fx.rx.counters["events"] == 0


FLOWS = {"single_event": flow_single_event, "coalescing": flow_coalescing,
         "gap": flow_gap, "duplicate": flow_duplicate,
         "reorder": flow_reorder, "overflow": flow_overflow,
         "stall": flow_stall, "stale_rv": flow_stale_rv,
         "clean_resync": flow_clean_resync, "detach": flow_detach}


def run_flow(side: str, flow: str, devpages: bool) -> dict:
    saved = {k: os.environ.get(k) for k in REACTOR_ENV
             + ("GATEKEEPER_DEVPAGES",)}
    _set("GATEKEEPER_DEVPAGES", "on" if devpages else "off")
    try:
        fx = _Fixture(side)
        FLOWS[flow](fx)
        return fx.record()
    finally:
        for k, v in saved.items():
            _set(k, v)


@functools.lru_cache(maxsize=None)
def _reference_record(flow: str, devpages: bool) -> dict:
    jfaults.reset_for_tests()
    return run_flow("ref", flow, devpages)


@pytest.mark.parametrize("devpages", [False, True], ids=["host", "devpages"])
@pytest.mark.parametrize("side", ["ref", "port"])
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_flow(flow, side, devpages):
    """One flow on one side: the reference test's own checks and the
    pages-off oracle; the port's run equals the reference's in state
    transitions, counters, ledger events and verdicts."""
    if side == "ref":
        _reference_record.cache_clear()
        rec = _reference_record(flow, devpages)
        assert rec["events"], "the flow never built the ledger"
        return
    got = run_flow("port", flow, devpages)
    want = _reference_record(flow, devpages)
    assert got["transitions"] == want["transitions"]
    assert got["state"] == want["state"]
    assert got["counters"] == want["counters"]
    assert got["events"] == want["events"]
    assert got["verdicts"] == want["verdicts"]


@pytest.mark.parametrize("devpages", [False, True], ids=["host", "devpages"])
def test_reference_rung1_folds_nothing(devpages, monkeypatch):
    """ROADMAP Queue C: the reference's rung 1 hands ``react_kind`` the
    watch stream's resource kind, which it looks up among the template
    kinds: the ledger does not move until the next sweep.  The port's
    rung 1 folds the event's page at once; after the next sweep both
    ledgers hold the same events and verdicts.  This test fails if the
    reference turns out to fold the page."""
    monkeypatch.setenv("GATEKEEPER_DEVPAGES", "on" if devpages else "off")
    ref, port = _Fixture("ref", mapped=False), _Fixture("port")
    seqs = []
    for fx in (ref, port):
        pod = next(o for o in fx.resources if o["kind"] == "Pod")
        gvk = fx.pkg.fake.gvk_of(pod)
        cur = copy.deepcopy(fx.cluster.get(gvk, pod["metadata"]["name"],
                                           pod["metadata"]["namespace"]))
        cur["metadata"]["labels"] = {}
        cur["spec"]["containers"][0]["image"] = "evil.io/reactor:1"
        fx.cluster.update(cur)
        seq0 = fx.ledger.seq
        assert fx.rx.pump()["reacted"] == ["Pod"]
        seqs.append(fx.ledger.seq - seq0)
    assert seqs[0] == 0 and seqs[1] > 0
    assert ref.record()["events"] == port.record()["events"]


# ---------------------------------------------------------------------------
# the driver's entry points


ENTRY_KINDS = ("K8sRequiredLabels", "K8sAllowedRepos", "K8sBlockNodePort",
               "K8sUniqueIngressHost")


def _strip_bytes(d):
    """An accounting dict without the scatter bytes of its devpages
    stanza (the port ships int32 row ids, ROADMAP Queue C), which
    tests/test_torch_pages.py holds on their own."""
    if not isinstance(d, dict):
        return d
    out = dict(d)
    dv = out.get("devpages")
    if isinstance(dv, dict):
        out["devpages"] = {k: v for k, v in dv.items()
                           if k not in ("h2d_bytes", "h2d_scatter_bytes")}
    return out


@pytest.mark.parametrize("devpages", [False, True], ids=["host", "devpages"])
def test_driver_entry_points_equal_the_reference(devpages, monkeypatch):
    monkeypatch.setenv("GATEKEEPER_DEVPAGES", "on" if devpages else "off")
    resources = make_mixed(random.Random(5), 60)
    sides = []
    for side in ("ref", "port"):
        drv, c = _client(_pkg(side), ENTRY_KINDS)
        c.add_data_batch(copy.deepcopy(resources))
        sides.append((drv, c))
    (jd, jc), (td, tc) = sides
    opts = (JOpts(limit_per_constraint=20), TOpts(limit_per_constraint=20))
    for (drv, _), o in zip(sides, opts):
        drv.query_audit(TARGET, o)
    assert td.devpages_report(TARGET) == jd.devpages_report(TARGET)
    for o in resources + [{"apiVersion": "v1", "kind": "Pod",
                           "metadata": {"name": "absent",
                                        "namespace": "x"}}, "not-an-obj"]:
        assert td.page_of_object(TARGET, o) == jd.page_of_object(TARGET, o)
    for av, kind in sorted({(o["apiVersion"], o["kind"])
                            for o in resources}):
        assert sorted(td.kind_residents(TARGET, av, kind)) == \
            sorted(jd.kind_residents(TARGET, av, kind))
    for kind in ENTRY_KINDS + ("Pod",):
        assert td.ledger_rv(TARGET, kind) == jd.ledger_rv(TARGET, kind) == 0
    # churn on both stores, then every rung entry point over template
    # kinds and over all kinds
    rng = random.Random(9)
    for o in rng.sample(resources, 6):
        o = copy.deepcopy(o)
        o.setdefault("metadata", {})["labels"] = {"churn": "x"}
        if (o.get("spec") or {}).get("containers"):
            o["spec"]["containers"][0]["image"] = "evil.io/entry:1"
        jc.add_data(copy.deepcopy(o))
        tc.add_data(copy.deepcopy(o))
    for kind in ("K8sAllowedRepos", None):
        assert _strip_bytes(td.react_kind(TARGET, kind)) == \
            _strip_bytes(jd.react_kind(TARGET, kind))
    for kind in ("K8sRequiredLabels", None):
        assert _strip_bytes(td.resync_kind(TARGET, kind)) == \
            _strip_bytes(jd.resync_kind(TARGET, kind))
    events = [[tuple(e[k] for k in EVENT_KEYS)
               for e in drv.state[TARGET].ledger.events] for drv, _ in sides]
    assert events[0] == events[1]
    assert td.metrics.counter("reactor_reacts_total").value == \
        jd.metrics.counter("reactor_reacts_total").value
    assert td.metrics.counter("reactor_resyncs_total").value == \
        jd.metrics.counter("reactor_resyncs_total").value
    # pages off: no rung runs, on either side
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    assert td.react_kind(TARGET) is None and jd.react_kind(TARGET) is None
    assert td.resync_kind(TARGET) is None and jd.resync_kind(TARGET) is None


def test_a_resource_kind_reacts_the_kinds_that_can_match_it():
    """The port's mapping: a resource kind reacts the template kinds
    whose constraints can match it (``spec.match.kinds``, or an
    inventory join over it), a kind nothing matches none, a template
    kind itself, None every kind."""
    matched = {"K8sAllowedRepos": "Pod", "K8sRequiredLabels": "Namespace",
               "K8sBlockNodePort": "Service",
               "K8sUniqueIngressHost": "Ingress"}
    td = TorchDriver(device="cpu")
    tc = TBackend(td).new_client([TTarget()])
    for tdoc, cdoc in tall_docs():
        kind = tdoc["spec"]["crd"]["spec"]["names"]["kind"]
        if kind in matched:
            cdoc = copy.deepcopy(cdoc)
            cdoc["spec"]["match"] = {"kinds": [
                {"apiGroups": ["*"], "kinds": [matched[kind]]}]}
            tc.add_template(tdoc)
            tc.add_constraint(cdoc)
    st = td.state[TARGET]
    for template in matched:
        assert td._react_kinds(st, template) == [template]
    assert td._react_kinds(st, "Pod") == ["K8sAllowedRepos"]
    assert td._react_kinds(st, "Ingress") == ["K8sUniqueIngressHost"]
    assert td._react_kinds(st, "ConfigMap") == []
    assert td._react_kinds(st, None) == sorted(matched)


# ---------------------------------------------------------------------------
# resilience/faults.py


@pytest.mark.parametrize("spec", ["", "watch_gap", " watch_gap , watch_stall",
                                  "watch_duplicate,,queue_storm", "nonsense"])
def test_faults_parse_and_fire_like_the_reference(spec, monkeypatch):
    monkeypatch.setenv("GATEKEEPER_FAULT", spec)
    names = ("watch_gap", "watch_stall", "watch_duplicate", "queue_storm",
             "watch_reorder", "watch_flood", "nonsense")
    for name in names:
        assert tfaults.active(name) == jfaults.active(name)
    fired = [[mod.take(n) for n in names for _ in range(2)]
             for mod in (jfaults, tfaults)]
    assert fired[0] == fired[1]
    for mod in (jfaults, tfaults):
        mod.rearm("watch_gap")
    assert tfaults.take("watch_gap") == jfaults.take("watch_gap")
    assert tfaults.take("watch_gap") is jfaults.take("watch_gap") is False


@pytest.mark.parametrize("name, item", [
    ("probe_hang", "A8"), ("device_lost", "A8"), ("snapshot_corrupt", "A8")])
def test_an_unported_seam_raises(name, item, monkeypatch):
    """The seams of the supervisor and the snapshot tier (ROADMAP A8) are
    ported: armed beside a watch seam, nothing raises any more, a reactor
    builds, and each is active and fires once as the reference's does.
    The test keeps the name, and ``item`` the case ids, it had while the
    port refused these seams."""
    monkeypatch.setenv("GATEKEEPER_FAULT", f"watch_gap,{name}")
    for mod in (jfaults, tfaults):
        mod.reset_for_tests()
    assert tfaults.active("watch_gap") == jfaults.active("watch_gap")
    assert tfaults.active(name) is jfaults.active(name) is True
    fired = [[mod.take(n) for n in ("watch_gap", name) for _ in range(2)]
             for mod in (jfaults, tfaults)]
    assert fired[0] == fired[1] == [True, False, True, False]
    drv, c = _client(_pkg("port"))
    treactor.Reactor(c)
    for mod in (jfaults, tfaults):
        mod.reset_for_tests()


@pytest.mark.parametrize("stall", ["0.2", "0.35"])
def test_slow_provider_seam_stalls_fetches(stall, monkeypatch):
    """``slow_provider`` is ported with external data: armed, it is no
    longer refused (a reactor builds), and each provider fetch round
    stalls for GATEKEEPER_FAULT_STALL_S before its transport call, on
    the port as on the reference, with no breaker trip."""
    import gatekeeper_tpu.api.externaldata as j_api
    import gatekeeper_tpu.externaldata as j_ext
    import gatekeeper_tpu_torch.api.externaldata as t_api
    import gatekeeper_tpu_torch.externaldata as t_ext
    monkeypatch.setenv("GATEKEEPER_FAULT", "watch_gap,slow_provider")
    monkeypatch.setenv("GATEKEEPER_FAULT_STALL_S", stall)
    assert tfaults.active("slow_provider") == jfaults.active("slow_provider")
    _drv, c = _client(_pkg("port"))
    treactor.Reactor(c)
    for api, ext in ((t_api, t_ext), (j_api, j_ext)):
        slept = []
        pc = ext.ProviderClient(sleep=slept.append)
        out = pc.fetch(api.Provider(name="p", url="fake://x", retries=0),
                       lambda provider, keys: {k: "v" for k in keys}, ["a"])
        assert out == {"a": "v"}
        assert slept == [float(stall)]
        assert pc.breaker(api.Provider(name="p", url="fake://x")).state \
            == "closed"


# ---------------------------------------------------------------------------
# the kept error


def _failing_react(side, fx, monkeypatch):
    """Make the side's rung 1 raise: the port's K6 (its plain version on
    the CPU) under devpages, the reference's react_kind."""
    boom = RuntimeError("K6 launch failed")

    def raise_(*_a, **_kw):
        raise boom
    if side == "port":
        monkeypatch.setattr(devdelta, "mask_delta", raise_)
    else:
        monkeypatch.setattr(fx.jd, "react_kind", raise_)
    return boom


@pytest.mark.parametrize("taker", ["audit_once", "stop"])
def test_a_react_error_is_kept_and_raised_once(taker, monkeypatch):
    monkeypatch.setenv("GATEKEEPER_DEVPAGES", "on")
    counters = {}
    for side in ("ref", "port"):
        fx = _Fixture(side)
        boom = _failing_react(side, fx, monkeypatch)
        fx.mutate("boom")
        fx.rx.pump()
        counters[side] = dict(fx.rx.counters)
        if side == "ref":
            assert fx.rx.counters["react_errors"] == 1
            fx.rx.stop()                # the reference swallows it
            continue
        assert fx.rx.error is boom
        if taker == "audit_once":
            am = AuditManager(fx.cluster, fx.client)
            am.attach_reactor(fx.rx)
            with pytest.raises(RuntimeError, match="K6 launch failed"):
                am.audit_once()
            assert am.last_sweep["skipped"]     # swept first; no CRD here
            am.last_sweep = None
            assert am.audit_once()["skipped"]   # raised once
            fx.rx.stop()
        else:
            with pytest.raises(RuntimeError, match="K6 launch failed"):
                fx.rx.stop()
            fx.rx.stop()                        # once
    assert counters["ref"] == counters["port"]


def test_the_audit_loop_sweeps_and_keeps_a_react_error(monkeypatch):
    """A react error under the running audit loop: the loop's sweeps go
    on (the sweep is the fallback that repairs the ledger), the error
    stays kept, and the reactor's ``stop()`` raises it."""
    monkeypatch.setenv("GATEKEEPER_DEVPAGES", "on")
    fx = _Fixture("port")
    with monkeypatch.context() as m:
        boom = _failing_react("port", fx, m)
        fx.mutate("boom")
        fx.rx.pump()
    assert fx.rx.error is boom and fx.rx.counters["react_errors"] == 1
    fx.cluster.create({
        "apiVersion": "apiextensions.k8s.io/v1beta1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "constrainttemplates.templates.gatekeeper.sh"},
        "spec": {"group": "templates.gatekeeper.sh", "version": "v1alpha1",
                 "names": {"kind": "ConstraintTemplate",
                           "plural": "constrainttemplates"}}})
    am = AuditManager(fx.cluster, fx.client, interval=0.01)
    am.attach_reactor(fx.rx)
    am.start()
    try:
        wait_for(lambda: am.metrics.counter("audit_sweeps").value >= 2,
                 "two loop sweeps")
    finally:
        am.stop()
    assert not am.last_sweep["skipped"]
    assert am.metrics.counter("audit_errors").value == 0
    assert fx.rx.error is boom
    assert fx.live_verdicts() == fx.oracle_verdicts()
    with pytest.raises(RuntimeError, match="K6 launch failed"):
        fx.rx.stop()


def test_a_resync_error_and_a_pump_error_are_kept(monkeypatch):
    fx = _Fixture("port")
    boom = RuntimeError("resync failed")

    def raise_(*_a, **_kw):
        raise boom
    monkeypatch.setattr(fx.client, "resync", raise_)
    fx.rx._resync_kind("Pod", "test")
    assert fx.rx.counters["resync_errors"] == 1
    assert fx.rx.take_error() is boom and fx.rx.take_error() is None
    # the pump thread's own exceptions
    monkeypatch.setattr(fx.rx, "pump", lambda: (_ for _ in ()).throw(boom))
    fx.rx.start(interval=0.001)
    wait_for(lambda: fx.rx.counters["pump_errors"] > 0, "pump error")
    with pytest.raises(RuntimeError, match="resync failed"):
        fx.rx.stop()


def test_apply_errors_are_only_counted():
    fx = _Fixture("port")
    fx.rx._apply_batch("Pod", [("MODIFIED", {"apiVersion": "v1",
                                              "kind": "Pod",
                                              "metadata": "not-a-dict"})])
    assert fx.rx.counters["apply_errors"] == 1
    assert fx.rx.error is None


# ---------------------------------------------------------------------------
# the re-react (apply_objects off)


@pytest.mark.parametrize("devpages", [False, True], ids=["host", "devpages"])
def test_a_write_after_the_react_reaches_the_ledger(devpages, monkeypatch):
    """The manager's shape: the reactor only schedules, the store write
    comes from elsewhere.  A react that runs before the write finds a
    clean page; the next pump finds the store generation moved since
    that react and re-reacts, with no new watch event, however late the
    write lands; a pump with the store unmoved re-reacts nothing."""
    monkeypatch.setenv("GATEKEEPER_DEVPAGES", "on" if devpages else "off")
    fx = _Fixture("port")
    rx = treactor.Reactor(fx.client, cluster=fx.cluster, seed=5)
    fx.rx.stop()
    for g in fx.gvks:
        rx.attach(g)
    pod = next(o for o in fx.resources if o["kind"] == "Pod")
    gvk = tfake.gvk_of(pod)
    cur = copy.deepcopy(fx.cluster.get(gvk, pod["metadata"]["name"],
                                       pod["metadata"]["namespace"]))
    cur["spec"]["containers"][0]["image"] = "evil.io/late-write:1"
    new = fx.cluster.update(cur)
    seq0 = fx.ledger.seq
    rx.pump()                                   # before the write
    assert fx.ledger.seq == seq0 and rx.counters["rung1"] == 1
    rx.pump()                                   # the store has not moved
    assert rx.counters["rereacts"] == 0
    fx.client.add_data(new)                     # the writer's store write
    rx.pump()
    assert rx.counters["rereacts"] == 1
    assert fx.ledger.seq > seq0
    assert fx.live_verdicts() == fx.oracle_verdicts()
    rx.pump()                                   # nothing moved since
    assert rx.counters["rereacts"] == 1
    # a write long after its event's react: no window to outlast
    cur = copy.deepcopy(new)
    cur["spec"]["containers"][0]["image"] = "evil.io/later-write:1"
    new = fx.cluster.update(cur)
    rx.pump()                                   # the react
    time.sleep(2.5)                             # past any short window
    seq1 = fx.ledger.seq
    fx.client.add_data(new)
    rx.pump()
    assert rx.counters["rereacts"] == 2 and fx.ledger.seq > seq1
    assert fx.live_verdicts() == fx.oracle_verdicts()
    rx.stop()


# ---------------------------------------------------------------------------
# concurrency: tests/test_concurrency.py's paged-reactor writers


@pytest.mark.parametrize("devpages", [False, True], ids=["host", "devpages"])
def test_concurrent_writers_paged_reactor_no_lost_page(devpages,
                                                       monkeypatch):
    """Two writer threads churn disjoint halves of a FakeCluster while
    the reactor pumps page-granular re-evals and a sweeper runs paged
    audits: final paged verdicts equal a pages-off oracle over the final
    cluster state, and no thread wedges."""
    monkeypatch.setenv("GATEKEEPER_DEVPAGES", "on" if devpages else "off")
    fx = _Fixture("port", n=32, seed=3)
    cluster, rx = fx.cluster, fx.rx
    errors: list = []
    stop = threading.Event()
    writes = [0, 0]

    def writer(half):
        mine = fx.resources[half::2]            # disjoint: no RV races
        wrng = random.Random(100 + half)
        while not stop.is_set():
            writes[half] += 1
            src = wrng.choice(mine)
            try:
                cur = cluster.get(tfake.gvk_of(src), src["metadata"]["name"],
                                  src["metadata"].get("namespace"))
                o = copy.deepcopy(cur)
                o.setdefault("metadata", {}).setdefault(
                    "labels", {})[f"w{half}"] = str(writes[half])
                cluster.update(o)
            except Exception:
                errors.append(("writer", traceback.format_exc()))

    sweeps = [0]

    def sweeper():
        while not stop.is_set():
            try:
                fx.jd.query_audit(TARGET, fx.opts)
                sweeps[0] += 1
            except Exception:
                errors.append(("sweep", traceback.format_exc()))

    rx.start(interval=0.005)
    threads = [threading.Thread(target=writer, args=(h,)) for h in (0, 1)]
    threads.append(threading.Thread(target=sweeper))
    for t in threads:
        t.start()
    # run until each side has made progress, not for a fixed window
    wait_for(lambda: min(writes) >= 40 and sweeps[0] >= 3
             and rx.counters["rung1"] >= 3 or errors, "the writers")
    stop.set()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "thread wedged"
    rx.stop()
    for _ in range(20):                         # drain residual events
        rx.pump()
        if all(k["pending"] == 0
               for k in rx.state_payload()["kinds"].values()):
            break
    assert not errors, errors[:3]
    assert rx.counters["events"] > 0
    assert fx.live_verdicts() == fx.oracle_verdicts()


# ---------------------------------------------------------------------------
# the queue_storm seam of webhook/batcher.py, both packages


def _storm(side: str) -> tuple:
    """Armed once: the first batch formation stalls, the bounded queue
    fills and sheds, the overload ladder climbs; later batches form at
    once.  Returns (answers, QueueFull count, peak rung, max rung)."""
    from tests.test_torch_overload import _pkg as overload_pkg
    pkg = overload_pkg(side)
    faults = jfaults if side == "ref" else tfaults
    faults.reset_for_tests()
    saved = {k: os.environ.get(k)
             for k in ("GATEKEEPER_FAULT", "GATEKEEPER_FAULT_STALL_S")}
    _set("GATEKEEPER_FAULT", "queue_storm")
    _set("GATEKEEPER_FAULT_STALL_S", "5")
    b = pkg.MicroBatcher(lambda reqs: [("ok", r["uid"]) for r in reqs],
                         max_batch=4, max_wait=0.0, capacity=6,
                         submit_timeout=60)
    ctl = pkg.ol.OverloadController(b.depth, b.capacity)
    b.start()
    out = {"ok": [], "full": 0}
    lock = threading.Lock()

    def submit(i):
        try:
            r = b.submit({"uid": i})
            with lock:
                out["ok"].append(r)
        except pkg.QueueFull:
            with lock:
                out["full"] += 1

    try:
        first = threading.Thread(target=submit, args=(0,))
        first.start()
        wait_for(lambda: "queue_storm" in faults._fired, "the stall")
        burst = [threading.Thread(target=submit, args=(i,))
                 for i in range(1, 11)]
        for t in burst:
            t.start()
        wait_for(lambda: b.depth() == 6 and out["full"] == 5, "the burst")
        peak = ctl.rung()
        for t in [first] + burst:
            t.join(60)
        # one-shot: a later batch forms without a stall
        t0 = time.monotonic()
        assert b.submit({"uid": 99}) == ("ok", 99)
        assert time.monotonic() - t0 < 5
    finally:
        b.stop()
        for k, v in saved.items():
            _set(k, v)
    assert len(out["ok"]) == 6 and ("ok", 0) in out["ok"]
    return (len(out["ok"]), out["full"], peak, ctl.max_rung)


@functools.lru_cache(maxsize=None)
def _reference_storm() -> tuple:
    return _storm("ref")


@pytest.mark.parametrize("side", ["ref", "port"])
def test_queue_storm_stalls_batch_formation_once(side):
    """Through both packages' micro-batchers: the same single stall, the
    same shed count and the same overload rungs."""
    if side == "ref":
        _reference_storm.cache_clear()
        got = _reference_storm()
        assert got[1] == 5
        return
    got = _storm("port")
    assert got == _reference_storm()
    assert got[2] == got[3] == 4            # FAIL_STATIC at a full queue


# ---------------------------------------------------------------------------
# status writes and the ledger


@pytest.mark.parametrize("devpages", [False, True], ids=["host", "devpages"])
def test_status_writes_keep_the_ledger(devpages, monkeypatch):
    """ROADMAP Queue C: every audit's status writes come back as
    constraint re-puts.  The reference's ledger digests whole constraint
    documents (and its version moves on every put), so the next paged
    sweep, or a react, rebuilds every kind on the host; the port's
    digest covers kind, name, spec, labels and annotations, so its next
    sweep only serves.  Both serve the same results; a spec edit still
    rebuilds the port's kind."""
    monkeypatch.setenv("GATEKEEPER_DEVPAGES", "on" if devpages else "off")
    resources = make_mixed(random.Random(5), 40)
    sides = {}
    for side in ("ref", "port"):
        pkg = _pkg(side)
        drv, c = _client(pkg)
        c.add_data_batch(copy.deepcopy(resources))
        sides[side] = (drv, c, pkg.Opts(limit_per_constraint=20))
    cons = [cdoc for tdoc, cdoc in tall_docs()
            if tdoc["spec"]["crd"]["spec"]["names"]["kind"] in KINDS]

    def sweep(side):
        drv, _c, opts = sides[side]
        out = _verdicts(drv.query_audit(TARGET, opts)[0])
        return out, drv.last_sweep_phases["pages"]["ledger_full_builds"]

    cold = {side: sweep(side) for side in sides}
    assert cold["port"] == cold["ref"] and cold["port"][1] == len(KINDS)
    for side, (drv, c, _o) in sides.items():
        for cdoc in cons:
            doc = copy.deepcopy(cdoc)
            doc["metadata"]["resourceVersion"] = "7"
            doc["status"] = {"auditTimestamp": "2026-01-01T00:00:00Z",
                             "violations": [{"name": "x"}]}
            c.add_constraint(doc)
    after = {side: sweep(side) for side in sides}
    assert after["port"][0] == after["ref"][0] == cold["port"][0]
    assert after["ref"][1] == len(KINDS) and after["port"][1] == 0
    for side, (drv, c, _o) in sides.items():
        doc = copy.deepcopy(cons[0])
        doc["spec"].setdefault("match", {})["namespaces"] = ["nowhere"]
        c.add_constraint(doc)
    edited = {side: sweep(side) for side in sides}
    assert edited["port"] == edited["ref"] and edited["port"][1] == 1
