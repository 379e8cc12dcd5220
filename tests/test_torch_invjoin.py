"""K7, the inventory join, and the inventory-join kind under devpages,
against the JAX reference, on the CPU.

- K7's plain version (kernels/invjoin.py) equals the reference's
  sort-based ``engine/veval.py`` ``_inv_join_mask`` bit for bit on
  synthetic columns, and equals it and the host builders
  (``ir/prep.build_inv_join`` of both packages) on the columns of real
  stores: duplicate hosts, one name in several namespaces, missing
  hosts, names and inventory values, no inventory at all, at 1, 7,
  1,024 and 4,099 rows, with and without the same-name exclusion.
- tests/test_devpages.py ``TestCrossRowInventoryJoin`` runs through
  JaxDriver and TorchDriver(device="cpu") side by side: results, ledger
  events and ``devpages`` stanzas (``inv_joins_device`` included) equal,
  and a verdict that flips on a row that never churned arrives as a
  device delta.
- No hidden fallback: a K7 that fails to launch ends the sweep, and an
  inventory-join kind that declines devpages for a host-side reason
  takes a full ledger rebuild, never the host page loop.
"""

import copy
import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.engine import jax_driver
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.engine.veval import _inv_join_mask
from gatekeeper_tpu.errors import ExternalDataError as JExternalDataError
from gatekeeper_tpu.ir import prep as jprep
from gatekeeper_tpu.library import all_docs as jall_docs
from gatekeeper_tpu.library import make_mixed
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.enforce import devpages as tdevpages
from gatekeeper_tpu_torch.errors import ExternalDataError as TExternalDataError
from gatekeeper_tpu_torch.ir import prep as tprep
from gatekeeper_tpu_torch.ir.prep import bucket
from gatekeeper_tpu_torch.kernels import invjoin
from gatekeeper_tpu_torch.library import all_docs as tall_docs
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget

from test_torch_pages import (TARGET, _client, _ingress, _results,
                              library_harness)
from test_torch_pages import _isolated  # noqa: F401  (autouse fixture)

KIND = "K8sUniqueIngressHost"
ROWS = (1, 7, 1024, 4099)
CASES = ("duplicates", "shared_names", "missing", "no_inventory")


def _reference(src, inv, sel, names, exclude):
    return np.asarray(_inv_join_mask(jnp.asarray(src), jnp.asarray(inv),
                                     jnp.asarray(sel), jnp.asarray(names),
                                     exclude))


def _plain(src, inv, sel, names, exclude, n_ids):
    """The plain K7 on the columns, and the CPU wrapper (one plain call,
    the same mask) beside it."""
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (src, inv, sel, names)]
    out = invjoin.inv_join_mask_plain(*t, exclude, n_ids)
    calls = invjoin.inv_join_mask.plain_calls
    wrapped = invjoin.inv_join_mask(*t, exclude, n_ids,
                                    invjoin.error_flag("cpu"))
    assert invjoin.inv_join_mask.plain_calls == calls + 1
    assert torch.equal(wrapped, out)
    assert out.dtype == torch.bool and tuple(out.shape) == src.shape
    return out.numpy()


# ---------------------------------------------------------------------------
# the plain K7 against the reference's sort-based join


def _synthetic(n, case, seed):
    """int32 src / inv / names and bool sel of ``n`` rows for ``case``:
    values from a small pool (so values repeat), names from a pool as
    small as the values' for shared_names (equal (value, name) pairs),
    a third of every column MISSING for missing, sel all False for
    no_inventory."""
    rng = np.random.default_rng(seed)
    n_vals = max(2, n // 4)
    src = rng.integers(0, n_vals, n).astype(np.int32)
    inv = rng.integers(0, n_vals, n).astype(np.int32)
    n_names = n_vals if case == "shared_names" else 4 * n + 8
    names = rng.integers(0, n_names, n).astype(np.int32)
    sel = rng.random(n) < 0.7
    if case == "missing":
        for a in (src, inv, names):
            a[rng.random(n) < 0.33] = -1
    if case == "no_inventory":
        sel[:] = False
    return src, inv, sel, names


@pytest.mark.parametrize("exclude", [True, False], ids=["exclude", "any"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", ROWS)
def test_plain_matches_reference_on_synthetic_columns(n, case, exclude):
    cols = _synthetic(n, case, n * 31 + CASES.index(case))
    want = _reference(*cols, exclude)
    n_ids = int(max(cols[0].max(), cols[1].max())) + 1
    np.testing.assert_array_equal(_plain(*cols, exclude, n_ids), want)
    np.testing.assert_array_equal(_plain(*cols, exclude, n_ids + 1 + n % 3),
                                  want)
    if case != "no_inventory" and n >= 1024:
        assert want.any() and not want.all()


def _store_objects(n, case, seed):
    """``n`` objects whose hosts join: Ingresses in 3 namespaces with
    hosts from a small pool; shared_names gives each name to one
    Ingress in each namespace; missing leaves a third without a host and
    mixes in pods that carry hosts (review values with no inventory
    row); no_inventory has no Ingress, only such pods."""
    rng = random.Random(seed)
    n_hosts = max(2, n // 4)
    out = []
    for i in range(n):
        host = f"h{rng.randrange(n_hosts)}.example.com"
        name = f"ing-{i // 3}" if case == "shared_names" else f"ing-{i}"
        ns = f"ns-{i % 3}"
        if case == "no_inventory" or (case == "missing" and i % 5 == 4):
            out.append({"apiVersion": "v1", "kind": "Pod",
                        "metadata": {"name": f"pod-{i}", "namespace": ns},
                        "spec": {"host": host}})
            continue
        obj = _ingress(name, host, ns)
        if case == "missing" and rng.random() < 0.33:
            del obj["spec"]["host"]
        out.append(obj)
    return out


_STORES: dict = {}


def _stores(n, case):
    """(reference table, port table, reference join request, port join
    request) over the same ``n`` objects, built once per (n, case)."""
    key = (n, case)
    if key not in _STORES:
        objs = _store_objects(n, case, n * 7 + CASES.index(case))
        out = []
        for drv, backend, target, docs in (
                (JaxDriver(), JBackend, JTarget, jall_docs),
                (TorchDriver(device="cpu"), TBackend, TTarget, tall_docs)):
            c = _client(drv, backend, target, docs, (KIND,))
            c.add_data_batch(copy.deepcopy(objs))
            st = drv._state(TARGET)
            (req,) = st.templates[KIND].vectorized.spec.inv_joins
            out.append((st.table, req))
        (jt, jreq), (tt, treq) = out
        assert jt.n_rows == tt.n_rows == n
        _STORES[key] = (jt, tt, jreq, treq)
    return _STORES[key]


@pytest.mark.parametrize("exclude", [True, False], ids=["exclude", "any"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", ROWS)
def test_plain_matches_reference_on_store_columns(n, case, exclude):
    """The device input records of a real store (devpages'
    build_inv_join_inputs) through the plain K7 equal the reference's
    ``_inv_join_mask`` on the same records and both packages' host
    builder ``build_inv_join`` on the same store."""
    jt, tt, jreq, treq = _stores(n, case)
    assert jreq.exclude_same_name and treq.exclude_same_name
    jreq = dataclasses.replace(jreq, exclude_same_name=exclude)
    treq = dataclasses.replace(treq, exclude_same_name=exclude)
    r_pad = bucket(n)
    recs = tdevpages.build_inv_join_inputs(treq, tt, r_pad)
    cols = [recs[nm] for nm in tdevpages.inv_join_binding_names(treq.name)]
    assert all(a.shape == (r_pad,) for a in cols)
    got = _plain(*cols, exclude, len(tt.interner))
    np.testing.assert_array_equal(got, _reference(*cols, exclude))
    np.testing.assert_array_equal(got, jprep.build_inv_join(jreq, jt, r_pad))
    np.testing.assert_array_equal(got, tprep.build_inv_join(treq, tt, r_pad))
    assert not got[n:].any()
    if case in ("duplicates", "missing") and n >= 7:
        assert got.any()
    if case == "no_inventory":
        assert not got.any()


def test_plain_raises_on_an_id_past_n_ids():
    src, inv, sel, names = _synthetic(64, "duplicates", 3)
    n_ids = int(max(src.max(), inv.max())) + 1
    _plain(src, inv, sel, names, True, n_ids)
    bad = src.copy()
    bad[5] = n_ids
    with pytest.raises(IndexError, match="outside"):
        _plain(bad, inv, sel, names, True, n_ids)
    bad = inv.copy()
    bad[np.nonzero(sel)[0][0]] = n_ids + 3
    with pytest.raises(IndexError, match="outside"):
        _plain(src, bad, sel, names, True, n_ids)
    # an unselected inventory row is never read
    bad = inv.copy()
    bad[np.nonzero(~sel)[0][0]] = n_ids + 3
    _plain(src, bad, sel, names, True, n_ids)


# ---------------------------------------------------------------------------
# the inventory-join kind under devpages, both drivers side by side


def _cross_row_harness(monkeypatch):
    """tests/test_devpages.py TestCrossRowInventoryJoin._drivers: three
    Ingresses, two sharing a host, beside 20 make_mixed rows, 8 rows a
    page."""
    monkeypatch.setenv("GATEKEEPER_PAGE_ROWS", "8")
    objs = [_ingress("ing-a", "dup.example.com"),
            _ingress("ing-b", "dup.example.com"),
            _ingress("ing-c", "solo.example.com")]
    objs += make_mixed(random.Random(3), 20)
    return library_harness(monkeypatch, (KIND,), objs, True)


def _dup_names(results):
    return {name for kind, _c, _ns, name, msg in _results(results)
            if kind == KIND and "duplicate ingress host" in msg}


def test_cross_row_inventory_join_matches_reference(monkeypatch):
    """The join is device-resident on both drivers; deleting ing-b
    clears ing-a's verdict although ing-a's row never churned (a '-'
    delta on a clean row); ing-d inserted with the same host into the
    freed slot makes both duplicates re-appear.  Results, events and
    stanzas equal the reference's at every step (Harness.sweep)."""
    h = _cross_row_harness(monkeypatch)
    got, evs, _ = h.sweep(100)
    assert _dup_names(got) == {"ing-a", "ing-b"}
    st = h.t.drv._state(TARGET)
    monkeypatch.setenv("GATEKEEPER_DEVPAGES", "on")
    assert h.t.drv._pages_ineligible(st, KIND, st.templates[KIND]) is None
    assert h.pages["kinds_paged"] == 1 and h.pages["kinds_fallback"] == 0
    assert h.dv["kinds_device"] == 1 and h.dv["inv_joins_device"] == 1
    assert [e["op"] for e in evs] == ["appear", "appear"]
    h.apply([("remove", _ingress("ing-b", "dup.example.com"))])
    got, evs, _ = h.sweep(100)
    assert _dup_names(got) == set()
    assert h.dv["inv_joins_device"] == 1 and h.dv["rows_confirmed"] == 0
    assert sorted((e["op"], e["resource"]) for e in evs) == \
        [("clear", "default/ing-a"), ("clear", "default/ing-b")]
    h.apply([("upsert", _ingress("ing-d", "dup.example.com"))])
    got, evs, _ = h.sweep(100)
    assert _dup_names(got) == {"ing-a", "ing-d"}
    assert sorted((e["op"], e["resource"]) for e in evs) == \
        [("appear", "default/ing-a"), ("appear", "default/ing-d")]
    # ing-a's appear came from the device join: its row is not dirty
    assert h.dv["delta_events"] == 2 and h.dv["rows_confirmed"] == 2


def test_same_name_in_another_namespace_is_a_duplicate(monkeypatch):
    """Two Ingresses of one name in two namespaces with one host: the
    same-name exclusion is by name alone (the template's ``not
    input.review.object.metadata.name == name``), so neither violates;
    a third of another name makes all three violate, and removing it
    clears all three, on both drivers."""
    monkeypatch.setenv("GATEKEEPER_PAGE_ROWS", "8")
    objs = [_ingress("web", "same.example.com", "ns-a"),
            _ingress("web", "same.example.com", "ns-b")]
    objs += make_mixed(random.Random(4), 12)
    h = library_harness(monkeypatch, (KIND,), objs, True)
    got, _, _ = h.sweep(100)
    assert _dup_names(got) == set()
    other = _ingress("api", "same.example.com", "ns-a")
    h.apply([("upsert", other)])
    got, evs, _ = h.sweep(100)
    assert _dup_names(got) == {"web", "api"}
    assert sum(e["op"] == "appear" for e in evs) == 3
    h.apply([("remove", other)])
    got, evs, _ = h.sweep(100)
    assert _dup_names(got) == set()
    assert sum(e["op"] == "clear" for e in evs) == 3
    assert h.dv["inv_joins_device"] == 1


def test_k7_launch_error_ends_the_sweep(monkeypatch):
    """The port lets an error of the kernel layer end the sweep, so a K7
    that does not build or launch cannot hide behind the host path."""
    h = _cross_row_harness(monkeypatch)
    h.sweep(100)
    h.apply([("remove", _ingress("ing-b", "dup.example.com"))])

    def broken(*_a, **_k):
        raise RuntimeError("invjoin launch: CUDA error 98")

    monkeypatch.setattr(invjoin, "inv_join_mask", broken)
    monkeypatch.setenv("GATEKEEPER_PAGES", "on")
    monkeypatch.setenv("GATEKEEPER_DEVPAGES", "on")
    with pytest.raises(RuntimeError, match="invjoin launch"):
        h.t.drv.query_audit(TARGET, h.t.opts_cls(limit_per_constraint=100))


def test_declined_join_kind_takes_a_full_rebuild(monkeypatch):
    """An inventory-join kind whose devpages sweep declines for a
    host-side reason (here an external-data failure while building its
    bindings) is rebuilt whole through the scalar oracle — the host page
    loop cannot keep cross-row verdicts — on both drivers, with equal
    results, events and stanzas."""
    h = _cross_row_harness(monkeypatch)
    h.sweep(100)
    for cls, err in ((JaxDriver, JExternalDataError),
                     (TorchDriver, TExternalDataError)):
        real = cls._kind_bindings

        def failing(self, st, kind, *a, _real=real, _err=err, **k):
            if kind == KIND and getattr(self, "fail_bindings", False):
                raise _err("provider down")
            return _real(self, st, kind, *a, **k)

        monkeypatch.setattr(cls, "_kind_bindings", failing)
    for s in (h.j, h.t):
        s.drv.fail_bindings = True
    h.apply([("remove", _ingress("ing-b", "dup.example.com"))])
    got, evs, _ = h.sweep(100)
    assert _dup_names(got) == set()
    assert sorted((e["op"], e["resource"]) for e in evs) == \
        [("clear", "default/ing-a"), ("clear", "default/ing-b")]
    assert h.dv["fallback_reasons"] == {KIND: "external-data-failure"}
    assert h.pages["ledger_full_builds"] == 1
    assert h.pages["pages_evaluated"] == h.pages["n_pages"]
    for s in (h.j, h.t):
        s.drv.fail_bindings = False
    h.apply([("upsert", _ingress("ing-d", "dup.example.com"))])
    got, _, _ = h.sweep(100)
    assert _dup_names(got) == {"ing-a", "ing-d"}
    assert h.pages["ledger_full_builds"] == 0
    assert h.dv["kinds_device"] == 1 and h.dv["kinds_fallback"] == 0


def test_join_inputs_scatter_only_changed_entries(monkeypatch):
    """After the cold upload the join's input records move as row-sized
    scatters of the changed entries (the reference's
    ``scatter_worthwhile`` seam), and an unchanged record is reused."""
    h = _cross_row_harness(monkeypatch)
    h.sweep(100)
    kp = h.t.drv._state(TARGET).devpages[KIND]
    before = dict(kp.ij_dev)
    assert len(before) == 4
    o = copy.deepcopy(_ingress("ing-c", "solo.example.com"))
    o["metadata"]["annotations"] = {"noise": "1"}
    h.apply([("upsert", o)])
    h.sweep(100)
    assert kp.ij_dev == before      # no record changed: same tensors
    h.apply([("upsert", _ingress("ing-c", "dup.example.com"))])
    h.sweep(100)
    (req,) = h.t.drv._state(TARGET).templates[KIND].vectorized.spec \
        .inv_joins
    src, inv, sel, names = tdevpages.inv_join_binding_names(req.name)
    # ing-c's host is its review value and its inventory value
    assert {nm for nm in before if kp.ij_dev[nm] is not before[nm]} == \
        {src, inv}
    assert h.dv["scatter_rows"] > 0


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    monkeypatch.setattr(jax_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
