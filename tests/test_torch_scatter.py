"""K4's batched row scatter and K8's plain versions against the JAX
package, on the CPU.

- ``scatter_rows_many_plain`` (the plain version of the batched K4
  entry) equals ``scatter_rows_plain`` job by job and the reference's
  functional update ``dev.at[rows].set(vals)``, over every dtype the
  executor scatters, axes 0, 1 and 2, ragged ``inner`` widths and the
  bucket padding's duplicate rows.
- ``ProgramExecutor._migrate`` scatters all of a generation's dirty
  arrays in one batched K4 call; over three churn rounds it leaves
  every device array and both scatter counters equal to the per-array
  path's and to JaxDriver's.
- K8's plain versions equal the reference planner's ``store`` and
  ``expand`` expressions over ragged tail pages and empty slots, and
  ``store`` uploads its page tables in one copy.

The kernels themselves run on a card: ``tests/test_torch_kernels.py``
holds them against these plain versions there.
"""

import copy
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.enforce import devpages as jdevpages

from gatekeeper_tpu_torch.engine import executor as tex
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.enforce import devpages as tdevpages
from gatekeeper_tpu_torch.kernels import residency
from gatekeeper_tpu_torch.kernels import scatter as tscatter
from gatekeeper_tpu_torch.library.north_star import (make_resources,
                                                     setup_north_star)

from test_torch_driver import _jax_north_star, _key

TARGET = "admission.k8s.gatekeeper.sh"
LEGACY = {"GATEKEEPER_PAGES": "off", "GATEKEEPER_FOOTPRINT": "off",
          "GATEKEEPER_DEDUP": "off"}
ROW_ID_BYTES_SAVED = 4        # int32 row ids against the reference's int64

DTYPES = {"bool": (np.bool_, torch.bool), "int8": (np.int8, torch.int8),
          "int16": (np.int16, torch.int16), "int32": (np.int32, torch.int32),
          "float32": (np.float32, torch.float32)}
# (shape, axis): axes 0, 1 and 2; inner widths 1, 3, 5 and 7 elements
LAYOUTS = [((37,), 0), ((37, 3), 0), ((5, 37), 1), ((3, 37, 5), 1),
           ((4, 37, 7), 1), ((2, 3, 37), 2)]


def _array(rng, shape, np_dtype):
    if np_dtype == np.bool_:
        return rng.random(shape) < 0.5
    if np_dtype == np.float32:
        return rng.normal(size=shape).astype(np.float32)
    return rng.integers(-100, 100, size=shape).astype(np_dtype)


def _job(rng, shape, axis, np_dtype, n_dirty):
    """(old, rows, vals) on the host: ``n_dirty`` distinct rows padded
    to their bucket by repeating the first with its values."""
    dirty = np.sort(rng.choice(shape[axis], size=n_dirty, replace=False))
    rows = tex.pad_rows(dirty).astype(np.int32)
    vshape = shape[:axis] + (len(rows),) + shape[axis + 1:]
    vals = _array(rng, vshape, np_dtype)
    first = [slice(None)] * len(shape)
    first[axis] = slice(0, 1)
    pad = [slice(None)] * len(shape)
    pad[axis] = slice(n_dirty, None)
    vals[tuple(pad)] = vals[tuple(first)]
    return _array(rng, shape, np_dtype), rows, vals


@pytest.mark.parametrize("shape,axis", LAYOUTS,
                         ids=[f"{s}-ax{a}" for s, a in LAYOUTS])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_many_plain_matches_per_job_and_reference(dtype, shape, axis):
    """Three jobs of one layout (1, 5 and 9 dirty rows: buckets 8, 8 and
    16, the padding repeating the first row) through the batched plain
    version: each result equals the single plain version's and the
    reference's ``at[].set``, and leaves its old column as it was."""
    np_dtype, t_dtype = DTYPES[dtype]
    rng = np.random.default_rng(LAYOUTS.index((shape, axis)) * 10
                                + sorted(DTYPES).index(dtype))
    host = [_job(rng, shape, axis, np_dtype, n) for n in (1, 5, 9)]
    jobs = [(torch.from_numpy(old).to(t_dtype), torch.from_numpy(rows),
             torch.from_numpy(vals).to(t_dtype), axis)
            for old, rows, vals in host]
    keep = [j[0].clone() for j in jobs]
    calls = tscatter.scatter_rows_many.plain_calls
    got = tscatter.scatter_rows_many(jobs)
    assert tscatter.scatter_rows_many.plain_calls == calls + 1
    assert len(got) == 3
    for out, job, (old, rows, vals), before in zip(got, jobs, host, keep):
        assert out.dtype == t_dtype and out.shape == job[0].shape
        assert torch.equal(out, tscatter.scatter_rows_plain(*job))
        idx = (slice(None),) * axis + (jnp.asarray(rows),)
        want = np.asarray(jnp.asarray(old).at[idx].set(jnp.asarray(vals)))
        np.testing.assert_array_equal(out.numpy(), want)
        assert torch.equal(job[0], before)


def test_many_plain_keeps_job_order_across_layouts():
    """One batch of every dtype and layout, more jobs than one launch
    takes on a card: results in the jobs' order, each its own."""
    rng = np.random.default_rng(99)
    jobs, want = [], []
    for k in range(tscatter.MAX_JOBS + 6):
        shape, axis = LAYOUTS[k % len(LAYOUTS)]
        np_dtype, t_dtype = DTYPES[sorted(DTYPES)[k % len(DTYPES)]]
        old, rows, vals = _job(rng, shape, axis, np_dtype, 1 + k % 9)
        jobs.append((torch.from_numpy(old).to(t_dtype),
                     torch.from_numpy(rows), torch.from_numpy(vals)
                     .to(t_dtype), axis))
        idx = (slice(None),) * axis + (jnp.asarray(rows),)
        want.append(np.asarray(jnp.asarray(old).at[idx].set(
            jnp.asarray(vals))))
    got = tscatter.scatter_rows_many(jobs)
    for out, w in zip(got, want):
        np.testing.assert_array_equal(out.numpy(), w)
    assert tscatter.scatter_rows_many([]) == []


# -- the batched migration against the per-array path and JaxDriver


def _per_array(ex):
    """``ex._scatter_many`` replaced by one single-array K4 call per
    spec (the layout of the executor before batching)."""
    def run(specs, batched=True):
        return [tex.ProgramExecutor._scatter_many(ex, [spec],
                                                  batched=False)[0]
                for spec in specs]
    return run


def _device_arrays(driver, ex):
    st = driver.state[TARGET]
    out = {}
    for kind, (_, b) in sorted(st.bindings_cache.items()):
        cache = b.__dict__.get("_device_caches", {}).get(id(ex), {})
        out[kind] = {nm: np.asarray(v[1]) for nm, v in cache.items()}
    return out


def test_batched_migrate_matches_per_array_and_reference(monkeypatch):
    """Three churn rounds (relabels, then new images that grow the
    interner's tables, then relabels) on JaxDriver and two CPU
    TorchDrivers, one scattering a generation's dirty arrays in one
    batched call and one array by array: equal results, equal device
    arrays (dtype and bits) on all three, equal ``h2d_scatter_rows`` and
    ``h2d_bytes``, and scatter bytes that differ from the reference's
    only by the 4 bytes a row id saves."""
    for k, v in LEGACY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    objs = make_resources(200, random.Random(1))
    jd, tb, tp = JaxDriver(), TorchDriver(device="cpu"), \
        TorchDriver(device="cpu")
    monkeypatch.setattr(tp.executor, "_scatter_many", _per_array(tp.executor))
    clients = [_jax_north_star(jd, objs, random.Random(2), 3),
               setup_north_star(tb, objs, random.Random(2), c_per_kind=3),
               setup_north_star(tp, objs, random.Random(2), c_per_kind=3)]
    for c in clients:
        c.audit(limit_per_constraint=20)
    exs = (jd.executor, tb.executor, tp.executor)
    rng = random.Random(8)
    scattered = 0
    for rnd in range(3):
        batch = []
        for i in rng.sample(range(len(objs)), 10):
            o = copy.deepcopy(objs[i])
            if rnd == 1 and o["kind"] == "Pod":
                for ctr in o["spec"]["containers"]:
                    ctr["image"] = f"evil.io/new{i}:1"
            else:
                o["metadata"]["labels"] = {
                    f"l{j}": "v" for j in range(10) if rng.random() < 0.4}
            objs[i] = o
            batch.append(o)
        for c in clients:
            for o in batch:
                c.add_data(copy.deepcopy(o))
        before = [(e.h2d_scatter_bytes, e.h2d_scatter_rows, e.h2d_bytes)
                  for e in exs]
        many = tscatter.scatter_rows_many.plain_calls
        single = tscatter.scatter_rows.plain_calls
        res = [[_key(r) for r in c.audit(limit_per_constraint=20).results()]
               for c in clients]
        assert res[0] == res[1] == res[2] and res[0], rnd
        d = [tuple(a - b for a, b in zip((e.h2d_scatter_bytes,
                                          e.h2d_scatter_rows, e.h2d_bytes),
                                         prev))
             for e, prev in zip(exs, before)]
        assert d[1] == d[2], rnd
        assert d[1][1] == d[0][1] > 0, rnd
        assert d[1][0] + ROW_ID_BYTES_SAVED * d[1][1] == d[0][0], rnd
        assert d[1][2] == d[0][2], rnd
        # one batched call per migrating kind on tb, one single call
        # per array on tp
        n_many = tscatter.scatter_rows_many.plain_calls - many
        n_single = tscatter.scatter_rows.plain_calls - single
        assert 0 < n_many <= 3 and n_single >= n_many, \
            (rnd, n_many, n_single)
        scattered += n_single
        arrays = [_device_arrays(drv, drv.executor)
                  for drv in (jd, tb, tp)]
        assert arrays[0].keys() == arrays[1].keys() == arrays[2].keys()
        for kind in arrays[0]:
            assert arrays[1][kind].keys() == arrays[2][kind].keys()
            assert arrays[0][kind].keys() <= arrays[1][kind].keys()
            for nm, got in arrays[1][kind].items():
                per = arrays[2][kind][nm]
                assert got.dtype == per.dtype, (kind, nm)
                np.testing.assert_array_equal(got, per, err_msg=nm)
                if nm in arrays[0][kind]:
                    ref = arrays[0][kind][nm]
                    assert got.dtype == ref.dtype, (kind, nm)
                    np.testing.assert_array_equal(got, ref, err_msg=nm)
    assert scattered >= 9


def test_one_spec_scatter_rows_is_the_single_entry():
    """``_scatter_rows`` keeps its one-array form for its other callers
    (the inventory-join inputs, the planner's restores): one
    ``scatter_rows`` call, no batched one, the same counters as a
    one-spec batch."""
    rng = np.random.default_rng(5)
    host = rng.random((4, 64)) < 0.5
    a, b = tex.ProgramExecutor("cpu"), tex.ProgramExecutor("cpu")
    dev = a._put("__match__", host)
    new = host.copy()
    new[:, [3, 9]] = ~new[:, [3, 9]]
    single, many = (tscatter.scatter_rows.plain_calls,
                    tscatter.scatter_rows_many.plain_calls)
    got = a._scatter_rows("__match__", dev, new, np.array([3, 9]))
    assert (tscatter.scatter_rows.plain_calls,
            tscatter.scatter_rows_many.plain_calls) == (single + 1, many)
    (got_b,) = b._scatter_many([("__match__", dev, new, np.array([3, 9]),
                                 None)])
    assert tscatter.scatter_rows_many.plain_calls == many + 1
    np.testing.assert_array_equal(got.numpy(), new)
    assert torch.equal(got, got_b)
    assert (a.h2d_scatter_bytes, a.h2d_scatter_rows) == \
        (b.h2d_scatter_bytes, b.h2d_scatter_rows) == (4 * 8 + 4 * 8, 8)


def test_narrow_overflow_reuploads_inside_a_batch():
    """A batch whose second array is a narrow column outgrowing its
    range: that array alone re-uploads whole (counted in h2d_bytes),
    the others scatter; the results keep the specs' order."""
    rng = np.random.default_rng(6)
    ex = tex.ProgramExecutor("cpu")
    alive = rng.random(1 << 16) < 0.5
    ids = rng.integers(0, 100, size=1 << 16).astype(np.int32)
    d_alive, d_ids = ex._put("__alive__", alive), ex._put("r:x", ids)
    assert d_ids.dtype == torch.int8
    alive2, ids2 = alive.copy(), ids.copy()
    alive2[[1, 2]] = ~alive2[[1, 2]]
    ids2[5] = 40_000
    h2d = ex.h2d_bytes
    got = ex._scatter_many([("__alive__", d_alive, alive2, np.array([1, 2]),
                             None),
                            ("r:x", d_ids, ids2, np.array([5]), None)])
    np.testing.assert_array_equal(got[0].numpy(), alive2)
    assert got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1].numpy(), ids2)
    assert ex.h2d_bytes - h2d == ids2.nbytes
    assert (ex.h2d_scatter_bytes, ex.h2d_scatter_rows) == (8 + 32, 8)


# -- K8's plain versions against the reference planner's expressions


def _k8_geometry(c_pad, r_pad, page_rows, n_slots, n_empty, seed):
    """(mask, slot -> page table with ``n_empty`` empty slots, cold
    pages): the ragged tail page held in a slot when ``seed`` is even,
    cold when odd."""
    rng = np.random.default_rng(seed)
    n_pages = -(-r_pad // page_rows)
    order = [int(p) for p in rng.permutation(n_pages - 1)]
    order = ([n_pages - 1] + order) if seed % 2 == 0 \
        else (order[:n_slots] + [n_pages - 1] + order[n_slots:])
    slot = np.array(order[:n_slots], dtype=np.int32)
    if n_empty:
        slot[rng.choice(n_slots - 1, n_empty, replace=False) + 1] = -1
    held = {int(p) for p in slot if p >= 0}
    cold = np.array([p for p in range(n_pages) if p not in held],
                    dtype=np.int32)
    return rng.random((c_pad, r_pad)) < 0.3, slot, cold


@pytest.mark.parametrize("c_pad,r_pad,page_rows,n_slots,n_empty", [
    (4, 100, 16, 3, 1),           # ragged tail page (rows 96-99)
    (3, 50, 8, 4, 2),
    (1, 1000, 32, 8, 0),          # ragged, no empty slot
    (2, 64, 1, 16, 5),            # one-row pages
    (5, 4100, 48, 20, 3),         # 48-row pages, ragged tail
])
@pytest.mark.parametrize("seed", [0, 1])
def test_k8_plain_matches_reference_store_and_expand(c_pad, r_pad,
                                                     page_rows, n_slots,
                                                     n_empty, seed):
    """``page_gather_plain`` against the reference ``store``'s two
    ``jnp.take``s (an empty slot gathers row 0, the tail page repeats row
    r_pad - 1), and ``page_scatter_plain`` of that slot buffer against
    its ``expand``'s ``zeros().at[:, rows].set(take(dev_buf, idx))``."""
    mask, slot, cold = _k8_geometry(c_pad, r_pad, page_rows, n_slots,
                                    n_empty, seed)
    ref = jdevpages.ResidencyPlanner(1, c_pad, r_pad, page_rows)
    gather = np.zeros((n_slots * page_rows,), dtype=np.int64)
    for s, p in enumerate(slot.tolist()):
        if p >= 0:
            gather[s * page_rows:(s + 1) * page_rows] = \
                ref._page_rows_abs(p)
    want_buf = np.asarray(jnp.take(jnp.asarray(mask), jnp.asarray(gather),
                                   axis=1))
    cold_rows = np.concatenate([ref._page_rows_abs(p) for p in cold])
    want_staging = np.asarray(jnp.take(jnp.asarray(mask),
                                       jnp.asarray(cold_rows), axis=1))
    buf, staging = residency.page_gather(
        torch.from_numpy(mask), torch.from_numpy(slot),
        torch.from_numpy(cold), page_rows)
    np.testing.assert_array_equal(buf.numpy(), want_buf)
    np.testing.assert_array_equal(staging.numpy(), want_staging)

    held = sorted((int(p), s) for s, p in enumerate(slot.tolist()) if p >= 0)
    rows = np.concatenate([ref._page_rows_abs(p) for p, _ in held])
    idx = np.concatenate([np.arange(s * page_rows, (s + 1) * page_rows)
                          for _, s in held])
    want_full = np.asarray(jnp.zeros((c_pad, r_pad), dtype=bool)
                           .at[:, rows].set(jnp.take(jnp.asarray(want_buf),
                                                     jnp.asarray(idx),
                                                     axis=1)))
    full = residency.page_scatter(buf, torch.from_numpy(slot), r_pad,
                                  page_rows)
    np.testing.assert_array_equal(full.numpy(), want_full)
    # every held page's rows come back, every other row is zero
    back = np.zeros_like(mask)
    back[:, rows] = mask[:, rows]
    np.testing.assert_array_equal(full.numpy(), back)


def test_store_uploads_its_page_tables_once(monkeypatch):
    """``store`` ships the slot table and the cold list in one int32
    host-to-device copy: the gather's two tables are views of one
    buffer, the slot -> page table first."""
    t = tdevpages.ResidencyPlanner(256, 8, 100, 16)
    t.touch(range(t.n_pages))
    seen = []
    orig = residency.page_gather

    def spy(mask, slot_pages, cold_pages, page_rows):
        seen.append((slot_pages, cold_pages))
        return orig(mask, slot_pages, cold_pages, page_rows)

    # the wrapper counts on what its module's name refers to
    spy.plain_calls = spy.launches = 0
    monkeypatch.setattr(tdevpages._residency, "page_gather", spy)
    t.store(torch.from_numpy(np.random.default_rng(1).random((8, 100))
                             < 0.2))
    (slot, cold), = seen
    assert slot.untyped_storage().data_ptr() == \
        cold.untyped_storage().data_ptr()
    assert cold.storage_offset() == slot.storage_offset() + t.n_slots
    table = np.full((t.n_slots,), -1, dtype=np.int32)
    for p, s in t.slot_of.items():
        table[s] = p
    np.testing.assert_array_equal(slot.numpy(), table)
    np.testing.assert_array_equal(
        cold.numpy(), [p for p in range(t.n_pages) if p not in t.slot_of])
