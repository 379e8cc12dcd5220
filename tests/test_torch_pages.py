"""The paged audit and the device-resident delta sweep of the port,
against the JAX reference, on the CPU.

- K6's plain version, through the port's ``eval_mask_delta``, equals the
  reference's ``ProgramExecutor.eval_mask_delta`` on the same store:
  identity and permuted page tables, a changed-bit count below, equal to
  and above the stream width, an all-zero resident mask.
- The port's VerdictLedger emits the reference's events for the same
  ``set_row`` sequences.
- The scenarios of tests/test_pages.py (``TestPagedSweep``,
  ``TestOverflowWiden``) and tests/test_devpages.py (``TestDeltaStream``,
  ``TestWidenByKind``, ``TestObservableKinds``) run through JaxDriver and
  TorchDriver(device="cpu") side by side, with pages on and devpages on
  and off: equal results, ledger event streams and "pages"/"devpages"
  stanzas, and results equal to the GATEKEEPER_PAGES=off oracle.  The
  stanzas' bytes are equal but for the scatter row ids: the port ships
  them as int32 where the reference counts int64 ones, 4 bytes fewer per
  scattered row (ROADMAP Queue C).
- Under devpages both drivers page the inventory-join kind
  K8sUniqueIngressHost (kernel B7, the port's K7) beside row-local kinds,
  with equal events (tests/test_torch_invjoin.py ports
  ``TestCrossRowInventoryJoin``).

The snapshot and reactor scenarios of those files
(``TestPagemapSnapshot``, ``TestWatchWatermark``, ``TestGeometrySnapshot``)
wait for the slices that port them.
"""

import collections
import copy
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatekeeper_tpu.analysis import footprint as jfootprint
from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.engine import jax_driver
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.enforce.ledger import VerdictLedger as JLedger
from gatekeeper_tpu.library import all_docs as jall_docs
from gatekeeper_tpu.library import make_mixed
from gatekeeper_tpu.store import table as jtable
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch.analysis import footprint as tfootprint
from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.client.interface import QueryOpts as TOpts
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.enforce import devpages as tdevpages
from gatekeeper_tpu_torch.enforce.ledger import VerdictLedger as TLedger
from gatekeeper_tpu_torch.kernels import devdelta
from gatekeeper_tpu_torch.library import all_docs as tall_docs
from gatekeeper_tpu_torch.store import table as ttable
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget

from gatekeeper_tpu.client.interface import QueryOpts as JOpts

TARGET = "admission.k8s.gatekeeper.sh"
EVENT_KEYS = ("seq", "target", "op", "kind", "constraint", "resource", "msg")
# the port ships int32 scatter row ids where the reference counts int64
# ones: 4 bytes fewer per scattered row, all other bytes equal
BYTE_KEYS = ("h2d_bytes", "h2d_scatter_bytes")
ROW_ID_BYTES_SAVED = 4
ROUTE_ENV = ("GATEKEEPER_PAGES", "GATEKEEPER_DEVPAGES",
             "GATEKEEPER_PAGE_ROWS", "GATEKEEPER_FOOTPRINT",
             "GATEKEEPER_SNAPSHOT_DIR", "GATEKEEPER_DEVPAGES_BUDGET_BYTES")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Footprint state is process-global on both sides and feeds page
    eligibility; the routing env is set per sweep."""
    for fp in (jfootprint, tfootprint):
        monkeypatch.setattr(fp, "_memo", {})
        monkeypatch.setattr(fp, "cross_row", {})
        monkeypatch.setattr(fp, "violations", {})
        monkeypatch.setattr(fp, "analyses_run", 0)
    for name in ROUTE_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(jax_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.setenv("GATEKEEPER_PAGE_ROWS", "16")
    for cls in (JaxDriver, TorchDriver):
        monkeypatch.setattr(cls, "_devpaged_kind",
                            _counting_scatter_rows(cls._devpaged_kind))


def _counting_scatter_rows(devpaged_kind):
    """``_devpaged_kind`` that adds the row ids it scattered (mask
    builds included, which the stanza's ``scatter_rows`` leaves out) to
    the driver's ``devpaged_scatter_rows``."""
    def counted(self, *args, **kwargs):
        r0 = self.executor.h2d_scatter_rows
        try:
            return devpaged_kind(self, *args, **kwargs)
        finally:
            self.devpaged_scatter_rows = \
                getattr(self, "devpaged_scatter_rows", 0) \
                + self.executor.h2d_scatter_rows - r0
    return counted


# ---------------------------------------------------------------------------
# K6: the plain version through eval_mask_delta, against the reference


KINDS3 = ("K8sRequiredLabels", "K8sAllowedRepos", "K8sBlockNodePort")


def _client(driver, backend, target, docs, kinds, match=None):
    """A client with the library's template and sample constraint of
    each kind; ``match`` maps a kind to its constraint's spec.match."""
    c = backend(driver).new_client([target()])
    for tdoc, cdoc in docs():
        kind = tdoc["spec"]["crd"]["spec"]["names"]["kind"]
        if kind in kinds:
            if match is not None and kind in match:
                cdoc = copy.deepcopy(cdoc)
                cdoc.setdefault("spec", {})["match"] = match[kind]
            c.add_template(tdoc)
            c.add_constraint(cdoc)
    return c


def _pair(kinds, resources, match=None):
    """(JaxDriver, its client, TorchDriver(cpu), its client) over the
    same store."""
    jd, td = JaxDriver(), TorchDriver(device="cpu")
    jc = _client(jd, JBackend, JTarget, jall_docs, kinds, match)
    tc = _client(td, TBackend, TTarget, tall_docs, kinds, match)
    for c in (jc, tc):
        c.add_data_batch(copy.deepcopy(resources))
    return jd, jc, td, tc


@pytest.fixture(scope="module")
def delta_case():
    """Both drivers' bindings of K8sAllowedRepos over 300 make_mixed rows
    (R_pad 512, C_pad 8), with the lowered programs."""
    resources = make_mixed(random.Random(3), 300)
    jd, _jc, td, _tc = _pair(("K8sAllowedRepos",), resources)
    out = []
    for drv in (jd, td):
        st = drv._state(TARGET)
        comp = st.templates["K8sAllowedRepos"]
        cons = drv._kind_constraints(st, "K8sAllowedRepos")
        out.append((drv, comp.vectorized.program,
                    drv._kind_bindings(st, "K8sAllowedRepos", comp, cons)))
    return out


def _delta_both(delta_case, old, pt, k):
    (jd, jprog, jb), (td, tprog, tb) = delta_case
    want = jd.executor.eval_mask_delta(jprog, jb, None, jnp.asarray(old),
                                       jnp.asarray(pt), k)
    calls = devdelta.mask_delta.plain_calls
    got = td.executor.eval_mask_delta(tprog, tb, None, torch.from_numpy(old),
                                      torch.from_numpy(pt), k)
    assert devdelta.mask_delta.plain_calls == calls + 1
    return got, (np.asarray(want[0]),) + tuple(want[1:])


@pytest.mark.parametrize("pt_kind", ["identity", "permuted", "out_of_range"])
@pytest.mark.parametrize("old_kind,k_kind", [
    ("zeros", "below"), ("random", "below"), ("random", "equal"),
    ("random", "above"), ("zeros", "above"), ("flips", "equal")])
def test_k6_plain_matches_reference(delta_case, pt_kind, old_kind, k_kind):
    """All five outputs equal the reference's, fill slots included: the
    gathered mask, ascending flat indices padded with -1, their signs (a
    -1 slot reads the first element, as jnp.clip makes it), the true
    count and row_any."""
    tb = delta_case[1][2]
    c_pad, r_pad = tb.c_pad, tb.r_pad
    rng = np.random.default_rng(
        ["identity", "permuted", "out_of_range"].index(pt_kind) * 10
        + len(old_kind) + len(k_kind))
    pt = np.arange(r_pad, dtype=np.int32)
    if pt_kind == "permuted":
        pt = rng.permutation(r_pad).astype(np.int32)
    elif pt_kind == "out_of_range":
        # take's reading: negatives count from the end, the rest fill True
        pt = rng.permutation(r_pad).astype(np.int32)
        pt[rng.choice(r_pad, 12, replace=False)] = \
            [-1, -r_pad, -r_pad - 1, r_pad, r_pad + 5, -7, 3 * r_pad,
             -2, r_pad + 1, -3, -r_pad - 9, 2 * r_pad]
    new0 = delta_case[1][0].executor.eval_mask_delta(
        delta_case[1][1], tb, None,
        torch.zeros((c_pad, r_pad), dtype=torch.bool),
        torch.from_numpy(pt), 1)[0].numpy()
    if old_kind == "zeros":
        old = np.zeros((c_pad, r_pad), dtype=bool)
    elif old_kind == "random":
        old = rng.random((c_pad, r_pad)) < 0.3
    else:
        # a handful of flipped bits against the new mask itself
        old = new0.copy()
        flips = rng.choice(c_pad * r_pad, 9, replace=False)
        old.reshape(-1)[flips] ^= True
    count = int((new0 ^ old).sum())
    assert count > 0
    k = {"below": count + 37, "equal": count,
         "above": max(1, count // 3)}[k_kind]
    got, want = _delta_both(delta_case, old, pt, k)
    new_mask, idx, signs, n, row_any = got
    np.testing.assert_array_equal(new_mask.numpy(), want[0])
    np.testing.assert_array_equal(idx, want[1])
    assert idx.dtype == want[1].dtype == np.int32
    np.testing.assert_array_equal(signs, want[2])
    assert n == want[3] == count
    np.testing.assert_array_equal(row_any, want[4])


def test_devdelta_compile_accounting_matches_reference(delta_case):
    """A new width counts a compile, a repeat a hit, on both sides."""
    (jd, jprog, jb), (td, tprog, tb) = delta_case
    old = np.zeros((tb.c_pad, tb.r_pad), dtype=bool)
    pt = np.arange(tb.r_pad, dtype=np.int32)
    before = [(d.executor.compiles, d.executor.cache_hits) for d in (jd, td)]
    for k in (4096, 4096, 8192, 4096):
        _delta_both(delta_case, old, pt, k)
    after = [(d.executor.compiles, d.executor.cache_hits) for d in (jd, td)]
    assert [(a[0] - b[0], a[1] - b[1]) for a, b in zip(after, before)] \
        == [(2, 2), (2, 2)]


# ---------------------------------------------------------------------------
# the ledger itself


class _R:
    def __init__(self, msg):
        self.msg = msg


SET_ROWS = [
    ("K8sA", 0, ("default", "a"), {"c1": ["m1", "m2"], "c0": ["z"]}),
    ("K8sA", 1, ("default", "b"), {"c1": ["m1"]}),
    ("K8sA", 0, ("default", "a"), {"c1": ["m2", "m3", "m3"]}),
    ("K8sB", 4, (None, "cluster-x"), {"b": ["x"]}),
    ("K8sA", 1, ("other", "c"), {"c1": ["m1"]}),     # slot reuse
    ("K8sA", 0, (), {}),                              # dead row
    ("K8sB", 4, (None, "cluster-x"), {"b": ["x"]}),   # no change
    ("K8sA", 7, ("default", "q"), {}),
]


def test_ledger_events_and_export_match_reference():
    j, t = JLedger("tgt"), TLedger("tgt")
    for kind, row, ident, by_c in SET_ROWS:
        ej = j.set_row(kind, row, ident, {c: [_R(m) for m in ms]
                                          for c, ms in by_c.items()})
        et = t.set_row(kind, row, ident, {c: [_R(m) for m in ms]
                                          for c, ms in by_c.items()})
        assert et == ej
    assert [dict(e) for e in t.events] == [dict(e) for e in j.events]
    assert t.export() == j.export() and t.seq == j.seq > 0
    assert t.total_violations() == j.total_violations()
    assert t.snapshot_payload().keys() == j.snapshot_payload().keys()


# ---------------------------------------------------------------------------
# sweep parity: the reference's scenarios, both drivers side by side


def _results(results):
    out = []
    for r in results:
        obj = (r.review or {}).get("object") or {}
        out.append(((r.constraint or {}).get("kind", ""),
                    ((r.constraint or {}).get("metadata") or {}).get("name"),
                    (obj.get("metadata") or {}).get("namespace"),
                    (obj.get("metadata") or {}).get("name"), r.msg))
    return out


def _vcounter(results):
    out = collections.Counter()
    for kind, cname, ns, name, msg in _results(results):
        out[(kind, cname, f"{ns}/{name}" if ns else str(name), msg)] += 1
    return out


class Side:
    """One driver under test beside its client and its ledger cursor."""

    def __init__(self, drv, client, opts_cls):
        self.drv, self.client, self.opts_cls = drv, client, opts_cls
        self.seq = 0

    def apply(self, op, obj):
        o = copy.deepcopy(obj)
        (self.client.add_data if op == "upsert"
         else self.client.remove_data)(o)

    def sweep(self, monkeypatch, limit, pages, devpages):
        monkeypatch.setenv("GATEKEEPER_PAGES", "on" if pages else "off")
        monkeypatch.setenv("GATEKEEPER_DEVPAGES", "on" if devpages else "off")
        return self.drv.query_audit(TARGET, self.opts_cls(
            limit_per_constraint=limit))[0]

    def new_events(self):
        led = self.drv._state(TARGET).ledger
        if led is None:
            return []
        evs = [{k: e[k] for k in EVENT_KEYS} for e in led.events
               if e["seq"] > self.seq]
        self.seq = led.seq
        return evs

    def stanzas(self):
        """The last sweep's "pages" and "devpages" stanzas, and the row
        ids its devpages sweeps scattered."""
        ph = self.drv.last_sweep_phases
        rows = getattr(self.drv, "devpaged_scatter_rows", 0)
        self.drv.devpaged_scatter_rows = 0
        return ph.get("pages"), ph.get("devpages"), rows


def assert_devpages_stanza_equal(tdv, jdv, t_rows, j_rows):
    """The port's "devpages" stanza equals the reference's: every key
    exactly, the whole-array bytes exactly, and the scatter bytes after
    the row-id width, over the same scattered rows on both sides."""
    if tdv is None or jdv is None or "h2d_bytes" not in jdv:
        assert tdv == jdv
        return
    assert {k: v for k, v in tdv.items() if k not in BYTE_KEYS} == \
        {k: v for k, v in jdv.items() if k not in BYTE_KEYS}
    assert tdv["h2d_bytes"] - tdv["h2d_scatter_bytes"] == \
        jdv["h2d_bytes"] - jdv["h2d_scatter_bytes"]
    assert t_rows == j_rows
    assert tdv["h2d_scatter_bytes"] + ROW_ID_BYTES_SAVED * t_rows == \
        jdv["h2d_scatter_bytes"]


class Harness:
    """JaxDriver and TorchDriver(cpu) under the paged route, and a
    TorchDriver(cpu) oracle under GATEKEEPER_PAGES=off, on one store."""

    def __init__(self, monkeypatch, devpages, j, t, o):
        self.mp, self.devpages = monkeypatch, devpages
        self.j, self.t, self.o = j, t, o
        self.sides = (j, t, o)

    def apply(self, batch):
        for op, obj in batch:
            for s in self.sides:
                s.apply(op, obj)

    def sweep(self, limit=20):
        """One paged sweep on both drivers and one oracle sweep: equal
        results, events and stanzas.  Returns (results, events, oracle
        results) of the port."""
        want = self.j.sweep(self.mp, limit, True, self.devpages)
        got = self.t.sweep(self.mp, limit, True, self.devpages)
        oracle = self.o.sweep(self.mp, limit, False, False)
        assert _results(got) == _results(want)
        assert sorted(_results(got), key=repr) == \
            sorted(_results(oracle), key=repr)
        evs, ref_evs = self.t.new_events(), self.j.new_events()
        (tp, tdv, t_rows), (jp, jdv, j_rows) = \
            self.t.stanzas(), self.j.stanzas()
        assert evs == ref_evs
        assert tp == jp
        assert_devpages_stanza_equal(tdv, jdv, t_rows, j_rows)
        return got, evs, oracle

    @property
    def pages(self):
        return self.t.drv.last_sweep_phases["pages"]

    @property
    def dv(self):
        return self.t.drv.last_sweep_phases["devpages"]


def library_harness(monkeypatch, kinds, resources, devpages, match=None):
    """A Harness over the library's templates of ``kinds`` and
    ``resources``."""
    jd, jc, td, tc = _pair(kinds, resources, match)
    oracle = TorchDriver(device="cpu")
    oc = _client(oracle, TBackend, TTarget, tall_docs, kinds, match)
    oc.add_data_batch(copy.deepcopy(resources))
    return Harness(monkeypatch, devpages, Side(jd, jc, JOpts),
                   Side(td, tc, TOpts), Side(oracle, oc, TOpts))


def _paged_sweep_rounds(resources, rng):
    """tests/test_pages.py TestPagedSweep._churn_rounds: metadata noise,
    verdict-flipping edits, deletes + fresh inserts, restores."""
    pods = [o for o in resources if (o.get("spec") or {}).get("containers")]
    rounds = []
    batch = []
    for o in rng.sample(resources, 4):
        o = copy.deepcopy(o)
        o.setdefault("metadata", {}).setdefault(
            "annotations", {})["pages-test"] = "noise"
        batch.append(("upsert", o))
    rounds.append(batch)
    flipped = rng.sample(pods, 2)
    batch = []
    for o in flipped:
        o = copy.deepcopy(o)
        o["spec"]["containers"][0]["image"] = "evil.io/pages:1"
        batch.append(("upsert", o))
    for o in rng.sample(resources, 2):
        o = copy.deepcopy(o)
        o.setdefault("metadata", {})["labels"] = {}
        batch.append(("upsert", o))
    rounds.append(batch)
    batch = [("remove", copy.deepcopy(o)) for o in rng.sample(resources, 3)]
    batch += [("upsert", o) for o in make_mixed(random.Random(77), 5)]
    rounds.append(batch)
    rounds.append([("upsert", copy.deepcopy(o)) for o in flipped])
    return rounds


def _delta_stream_rounds(resources, rng):
    """tests/test_devpages.py TestDeltaStream: flips, deletes that free
    slots, inserts of different identities into them, label noise."""
    pods = [o for o in resources if (o.get("spec") or {}).get("containers")]
    rounds = []
    batch = []
    for o in rng.sample(pods, 3):
        o = copy.deepcopy(o)
        o["spec"]["containers"][0]["image"] = "evil.io/devpages:1"
        batch.append(("upsert", o))
    rounds.append(batch)
    rounds.append([("remove", copy.deepcopy(o))
                   for o in rng.sample(resources, 4)])
    rounds.append([("upsert", o) for o in make_mixed(random.Random(99), 4)])
    rounds.append([("upsert", copy.deepcopy(o)) for o in
                   (dict(o, metadata={**o.get("metadata", {}), "labels": {}})
                    for o in rng.sample(resources, 2))])
    return rounds


ROUNDS = {"paged_sweep": (_paged_sweep_rounds, 9),
          "delta_stream": (_delta_stream_rounds, 13)}


@pytest.mark.parametrize("devpages", [False, True], ids=["host", "devpages"])
@pytest.mark.parametrize("scenario,limit", [
    ("paged_sweep", 20),          # TestPagedSweep oracle parity
    ("paged_sweep", 10_000),      # TestPagedSweep event stream = diff
    ("delta_stream", 10_000),     # TestDeltaStream slot reuse
])
def test_sweep_parity_under_churn(monkeypatch, devpages, scenario, limit):
    """Each round's ledger events equal the reference's and the diff of
    consecutive oracle sweeps (uncapped), on both drivers; every kind
    paged, and under devpages every churned sweep on the device."""
    resources = make_mixed(random.Random(5), 60)
    h = library_harness(monkeypatch, KINDS3, resources, devpages)
    make_rounds, seed = ROUNDS[scenario]
    rounds = make_rounds(resources, random.Random(seed))
    prev = collections.Counter()
    for i, rnd in enumerate([[]] + rounds):
        h.apply(rnd)
        _got, evs, oracle = h.sweep(limit)
        assert h.pages["enabled"] and h.pages["kinds_paged"] == 3
        assert h.pages["kinds_fallback"] == 0
        if devpages:
            assert h.dv["kinds_device"] == 3 and h.dv["kinds_fallback"] == 0
            # the cold sweep builds the resident masks, churn rides deltas
            assert h.dv["mask_builds"] == (3 if i == 0 else 0)
        else:
            assert h.dv == {"enabled": False}
        if limit < 10_000:
            continue
        cur = _vcounter(oracle)
        key = lambda e: (e["kind"], e["constraint"], e["resource"], e["msg"])
        assert collections.Counter(key(e) for e in evs
                                   if e["op"] == "appear") == cur - prev
        assert collections.Counter(key(e) for e in evs
                                   if e["op"] == "clear") == prev - cur
        assert [e["seq"] for e in evs] == sorted({e["seq"] for e in evs})
        prev = cur
    if limit == 10_000:
        led = h.t.drv._state(TARGET).ledger
        assert led.total_violations() == sum(prev.values())


@pytest.mark.parametrize("devpages", [False, True], ids=["host", "devpages"])
def test_metadata_noise_skips_pages(monkeypatch, devpages):
    """An annotation edit intersects no read-set: nothing re-evaluated
    on the host path, no events on either."""
    resources = make_mixed(random.Random(5), 60)
    h = library_harness(monkeypatch, KINDS3, resources, devpages)
    h.sweep()
    o = copy.deepcopy(resources[3])
    o.setdefault("metadata", {}).setdefault(
        "annotations", {})["pages-test"] = "noise"
    h.apply([("upsert", o)])
    _got, evs, _ = h.sweep()
    assert evs == [] and h.pages["events"] == 0
    assert h.pages["pages_skipped"] > 0 and h.pages["evaluations_saved"] > 0
    if not devpages:
        assert h.pages["pages_evaluated"] == 0


@pytest.mark.parametrize("devpages", [False, True], ids=["host", "devpages"])
def test_tail_page_padding_parity(monkeypatch, devpages):
    """60 rows at 16 a page: churn a row of the padded tail page."""
    resources = make_mixed(random.Random(5), 60)
    h = library_harness(monkeypatch, KINDS3, resources, devpages)
    h.sweep()
    table = h.t.drv._state(TARGET).table
    assert table.n_rows % table.page_rows != 0
    obj = copy.deepcopy(table.object_at(table.n_rows - 1))
    obj.setdefault("metadata", {})["labels"] = {}
    h.apply([("upsert", obj)])
    h.sweep()
    if devpages:
        assert h.dv["kinds_device"] == 3
    else:
        assert h.pages["rows_padded"] > 0


@pytest.mark.parametrize("devpages", [False, True], ids=["host", "devpages"])
def test_overflow_widen_falls_back_and_recovers(monkeypatch, devpages):
    """tests/test_pages.py TestOverflowWiden: 20 single-object events
    overflow a dirty-path log capped at 8; the host path widens every
    kind once, the device path's dirty set never reads the log."""
    for mod in (jtable, ttable):
        monkeypatch.setattr(mod, "PATH_LOG_CAP", 8)
    kinds = ("K8sRequiredLabels", "K8sAllowedRepos")
    resources = make_mixed(random.Random(5), 40)
    h = library_harness(monkeypatch, kinds, resources, devpages)
    h.sweep()
    for i in range(20):
        o = copy.deepcopy(resources[i % len(resources)])
        o.setdefault("metadata", {}).setdefault(
            "annotations", {})["widen"] = str(i)
        h.apply([("upsert", o)])
    assert h.t.drv._state(TARGET).table.dirtylog_overflows > 0
    h.sweep()
    assert h.pages["widen_fallbacks"] == (0 if devpages else len(kinds))
    o = copy.deepcopy(resources[0])
    o.setdefault("metadata", {}).setdefault(
        "annotations", {})["widen"] = "post"
    h.apply([("upsert", o)])
    h.sweep()
    assert h.pages["widen_fallbacks"] == 0 and h.pages["pages_skipped"] > 0


def test_devpages_churn_h2d_is_row_sized(monkeypatch):
    """tests/test_devpages.py test_churn_h2d_is_row_sized: one churned
    row moves row-sized records, well under the cold resident build."""
    resources = make_mixed(random.Random(5), 240)
    h = library_harness(monkeypatch, KINDS3, resources, True)
    h.sweep()
    cold = dict(h.dv)
    assert cold["kinds_device"] > 0 and cold["h2d_bytes"] > 0
    o = copy.deepcopy(resources[7])
    o.setdefault("metadata", {})["labels"] = {}
    h.apply([("upsert", o)])
    h.sweep()
    assert h.dv["kinds_device"] > 0
    assert h.dv["h2d_bytes"] * 5 < cold["h2d_bytes"]


def test_widen_scoped_to_churned_kinds(monkeypatch):
    """tests/test_devpages.py TestWidenByKind: an overflowed window of
    Pod churn widens only the Pod-observing kind (host-paged path)."""
    for mod in (jtable, ttable):
        monkeypatch.setattr(mod, "PATH_LOG_CAP", 8)
    match = {kind: {"kinds": [{"apiGroups": ["*"], "kinds": [natural]}]}
             for kind, natural in (("K8sAllowedRepos", "Pod"),
                                   ("K8sHttpsOnly", "Ingress"))}
    resources = make_mixed(random.Random(5), 40)
    h = library_harness(monkeypatch, tuple(match), resources, False, match=match)
    h.sweep(50)
    for s in h.sides:
        s.drv._state(TARGET).table.compact()
    h.sweep(50)                       # absorb the remap
    pods = [o for o in resources if (o.get("spec") or {}).get("containers")]
    for i in range(20):
        o = copy.deepcopy(pods[i % len(pods)])
        o.setdefault("metadata", {}).setdefault(
            "annotations", {})["widen"] = str(i)
        h.apply([("upsert", o)])
    assert h.t.drv._state(TARGET).table.dirtylog_overflows > 0
    h.sweep(50)
    assert h.pages["widen_fallbacks"] == 1


def test_observable_kinds_match_reference():
    """tests/test_devpages.py TestObservableKinds on both drivers."""
    class _C:
        vectorized = None

    def con(kinds_field):
        return {"spec": {"match": {"kinds": kinds_field}}}

    cases = [[con([{"kinds": ["Pod"]}]),
              con([{"kinds": ["Ingress", "Service"]}])],
             [con([{"kinds": ["*"]}])], [con("Pod")],
             [{"spec": {"match": {}}}], []]
    for cons in cases:
        assert TorchDriver._observable_kinds(_C(), cons) == \
            JaxDriver._observable_kinds(_C(), cons)
    assert TorchDriver._observable_kinds(_C(), cases[0]) == \
        frozenset({"Pod", "Ingress", "Service"})


# ---------------------------------------------------------------------------
# the inventory-join kind, the __match__ hazard, and what must not be
# hidden


def _ingress(name, host, ns="default"):
    return {"apiVersion": "extensions/v1beta1", "kind": "Ingress",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"host": host, "rules": [{"host": host}],
                     "tls": [{"secretName": "tls"}]}}


def test_inventory_join_kind_is_paged_under_devpages(monkeypatch):
    """K8sUniqueIngressHost (cross-row through one inventory join) beside
    a row-local kind: under devpages both drivers page both kinds (the
    port through K7) with equal results, ledger events and stanzas, and
    both ledgers hold the join kind."""
    kinds = ("K8sUniqueIngressHost", "K8sAllowedRepos")
    resources = make_mixed(random.Random(5), 40) + [
        _ingress("dup-a", "same.example.com"),
        _ingress("dup-b", "same.example.com"),
        _ingress("solo", "solo.example.com")]
    h = library_harness(monkeypatch, kinds, resources, True)
    steps = [([], True, ()),
             ([("remove", _ingress("dup-b", "same.example.com"))], False,
              ("dup-a", "dup-b")),
             ([("upsert", _ingress("dup-c", "same.example.com"))], True,
              ("dup-a", "dup-c"))]
    for batch, dup_a, changed in steps:
        h.apply(batch)
        got, evs, _ = h.sweep()
        # dup-a violates beside dup-b, clears once dup-b is gone and
        # violates again beside dup-c, its own row never churning
        assert any(k == "K8sUniqueIngressHost" and name == "dup-a"
                   for k, _c, _ns, name, _m in _results(got)) == dup_a
        assert h.pages["kinds_paged"] == 2
        assert h.pages["kinds_fallback"] == 0
        assert h.dv["kinds_device"] == 2
        assert h.dv["mask_builds"] == (0 if batch else 2)
        assert h.dv["inv_joins_device"] == 1
        if batch:
            assert sorted(e["resource"] for e in evs
                          if e["kind"] == "K8sUniqueIngressHost") == \
                [f"default/{name}" for name in changed]
        for d in (h.j.drv, h.t.drv):
            assert "K8sUniqueIngressHost" in d._state(TARGET).ledger.entries


def test_resident_mask_excludes_a_stale_match_gate(monkeypatch):
    """A kind with match criteria that first took the legacy route has
    ``__match__`` installed in its bindings, and update_bindings carries
    it into later generations.  The devpages mask must not read it: a
    row that starts to match (labelSelector) and violates is confirmed,
    not cleared, and the port agrees with the oracle.  The reference
    reads the stale gate into its resident mask and misses the row
    (ROADMAP Queue C): run here beside the port, it is the witness."""
    kinds = ("K8sAllowedRepos",)
    resources = make_mixed(random.Random(5), 40)
    pod = copy.deepcopy(next(o for o in resources if o["kind"] == "Pod"))
    pod["metadata"]["name"] = "late-matcher"
    pod["metadata"]["labels"] = {}
    pod["spec"]["containers"][0]["image"] = "evil.io/late:1"
    resources.append(pod)
    match = {"K8sAllowedRepos": {"labelSelector": {
        "matchLabels": {"tier": "web"}}}}
    jd, jc, td, tc = _pair(kinds, resources, match)
    oracle = TorchDriver(device="cpu")
    oc = _client(oracle, TBackend, TTarget, tall_docs, kinds, match)
    oc.add_data_batch(copy.deepcopy(resources))

    def sweep(pages, devpages):
        """(port, reference, oracle) results of one sweep each."""
        monkeypatch.setenv("GATEKEEPER_PAGES", "on" if pages else "off")
        monkeypatch.setenv("GATEKEEPER_DEVPAGES", "on" if devpages else "off")
        got = _results(td.query_audit(TARGET, TOpts(
            limit_per_constraint=50))[0])
        ref = _results(jd.query_audit(TARGET, JOpts(
            limit_per_constraint=50))[0])
        monkeypatch.setenv("GATEKEEPER_PAGES", "off")
        want = _results(oracle.query_audit(TARGET, TOpts(
            limit_per_constraint=50))[0])
        assert got == want
        return got, ref, want

    def late(results):
        return any(name == "late-matcher" for _k, _c, _ns, name, _m in results)

    got, ref, _ = sweep(False, False)       # legacy: installs __match__
    assert ref == got
    for d in (td, jd):
        b = d._state(TARGET).bindings_cache["K8sAllowedRepos"][1]
        assert "__match__" in b.arrays
    got, ref, _ = sweep(True, True)         # cold ledger build + resident mask
    assert ref == got and not late(got)
    pod["metadata"]["labels"] = {"tier": "web"}
    for c in (jc, tc, oc):
        c.add_data(copy.deepcopy(pod))
    got, ref, want = sweep(True, True)      # the pod is dirty and now violates
    for d in (td, jd):
        assert d.last_sweep_phases["devpages"]["kinds_device"] == 1
    assert late(got) and late(want)
    # the reference's fault: its resident mask still carries the gate of
    # the generation before the relabel, so the row reads as clear
    assert not late(ref)
    assert sorted(ref) == sorted(r for r in want
                                 if r[3] != "late-matcher")


def test_budget_env_runs_the_residency_planner(monkeypatch):
    """GATEKEEPER_DEVPAGES_BUDGET_BYTES below a kind's certified resident
    claim: the devpages sweep keeps only the planner's slot buffer on the
    device between sweeps and serves the host page loop's results, with
    pages spilled and, after churn, restored."""
    resources = make_mixed(random.Random(5), 30)
    td, host = TorchDriver(device="cpu"), TorchDriver(device="cpu")
    tc = _client(td, TBackend, TTarget, tall_docs, KINDS3)
    hc = _client(host, TBackend, TTarget, tall_docs, KINDS3)
    for c in (tc, hc):
        c.add_data_batch(copy.deepcopy(resources))
    monkeypatch.setenv("GATEKEEPER_DEVPAGES_BUDGET_BYTES", "256")
    assert tdevpages.residency_budget_bytes() == 256
    opts = TOpts(limit_per_constraint=20)
    spills = restores = 0
    for rnd in range(2):
        if rnd:
            o = copy.deepcopy(resources[7])
            o.setdefault("metadata", {})["labels"] = {}
            for c in (tc, hc):
                c.add_data(copy.deepcopy(o))
        monkeypatch.setenv("GATEKEEPER_DEVPAGES", "on")
        got = _results(td.query_audit(TARGET, opts)[0])
        dv = td.last_sweep_phases["devpages"]
        monkeypatch.setenv("GATEKEEPER_DEVPAGES", "off")
        assert got == _results(host.query_audit(TARGET, opts)[0])
        assert dv["kinds_device"] == 3 and dv["resident_pages_device"] > 0
        spills += dv["resident_spills"]
        restores += dv["resident_restores"]
    assert spills > 0 and restores > 0
    for kp in td._state(TARGET).devpages.values():
        assert kp.mask is None and kp.resident.active
        assert tuple(kp.resident.dev_buf.shape) == \
            (kp.c_pad, kp.resident.n_slots * kp.page_rows)


def test_k6_launch_error_ends_the_sweep(monkeypatch):
    """The reference falls back to the host page loop on any devpages
    error; the port lets an error of the kernel layer end the sweep, so
    a K6 that does not build or launch cannot hide behind the host."""
    resources = make_mixed(random.Random(5), 60)
    td = TorchDriver(device="cpu")
    tc = _client(td, TBackend, TTarget, tall_docs, KINDS3)
    tc.add_data_batch(copy.deepcopy(resources))
    monkeypatch.setenv("GATEKEEPER_DEVPAGES", "on")
    opts = TOpts(limit_per_constraint=20)
    td.query_audit(TARGET, opts)
    assert td.last_sweep_phases["devpages"]["kinds_device"] == 3
    o = copy.deepcopy(resources[7])
    o.setdefault("metadata", {})["labels"] = {}
    tc.add_data(o)

    def broken(*_a, **_k):
        raise RuntimeError("devdelta launch: CUDA error 98")

    monkeypatch.setattr(devdelta, "mask_delta", broken)
    with pytest.raises(RuntimeError, match="devdelta launch"):
        td.query_audit(TARGET, opts)


def test_adopt_store_drops_the_ledger(monkeypatch):
    """The ledger's row ids and guards belong to the old table: adopting
    a store drops it, and the next paged sweep builds it cold."""
    resources = make_mixed(random.Random(5), 40)
    td = TorchDriver(device="cpu")
    tc = _client(td, TBackend, TTarget, tall_docs, KINDS3)
    tc.add_data_batch(copy.deepcopy(resources))
    opts = TOpts(limit_per_constraint=20)
    before = _results(td.query_audit(TARGET, opts)[0])
    st = td._state(TARGET)
    assert st.ledger is not None and st.ledger.total_violations() > 0
    td.adopt_store(TARGET, st.table.snapshot_state())
    assert st.ledger is None and st.dirtylog_overflows_seen == 0
    assert _results(td.query_audit(TARGET, opts)[0]) == before
    assert td.last_sweep_phases["pages"]["ledger_full_builds"] == 3
