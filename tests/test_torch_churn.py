"""The port's churned audit sweep against the JAX package, on the CPU.

Under churn the executor keeps the violation mask on the device: dirty
rows are scattered into the device columns (K4, the reference's
``ProgramExecutor._scatter_rows``) and re-evaluated into the stored mask
(K5, the reference's ``_delta_fn``).  Here the kernels' plain versions
run against the reference on the same numpy inputs, bit for bit, and
the three drivers (JaxDriver, TorchDriver(device="cpu"), LocalDriver)
must agree after every churn round: upserts, adds, removes, Namespace
churn, new images (interner growth) and a constraint edit.  The port
must also cut each bindings generation's lineage once its device arrays
are migrated, so old generations, their device arrays and their stored
masks are freed.
"""

import copy
import gc
import random
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.client.local_driver import LocalDriver
from gatekeeper_tpu.engine import veval
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.library import all_docs as jall_docs
from gatekeeper_tpu.library import make_mixed
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch import convert
from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.engine import executor as tex
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.kernels import ir_eval
from gatekeeper_tpu_torch.kernels import scatter as tscatter
from gatekeeper_tpu_torch.library import all_docs as tall_docs
from gatekeeper_tpu_torch.library.north_star import (make_resources,
                                                     setup_north_star)
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget

from test_torch_driver import _assert_parity, _jax_north_star, _key
from test_torch_executor import LIBRARY_KINDS, _plain_program
from test_torch_executor import library  # noqa: F401  (module fixture)

TARGET = "admission.k8s.gatekeeper.sh"
LEGACY = {"GATEKEEPER_PAGES": "off", "GATEKEEPER_FOOTPRINT": "off",
          "GATEKEEPER_DEDUP": "off"}


@pytest.fixture(autouse=True)
def _device_path_at_test_sizes(monkeypatch):
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)


@pytest.fixture(scope="module")
def ref_executor():
    return veval.ProgramExecutor()


# -- K4: the row scatter against the reference's _scatter_rows

R, C, E, L, K, T, W = 64, 8, 4, 5, 3, 32, 16


def _values(rng, shape, dtype, hi=100):
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if dtype == np.float32:
        return rng.normal(size=shape).astype(np.float32)
    return rng.integers(-1, hi, size=shape).astype(dtype)


# (binding name, shape, dtype, explicit axis): every axis layout the
# prep names give, along the r axis, and the id axis of append-only
# interner tables
SCATTER_CASES = [
    ("__alive__", (R,), np.bool_, None),
    ("r:x", (R,), np.int32, None),
    ("r:n.v", (R,), np.float32, None),
    ("e:x", (R, E), np.int32, None),
    ("__elem__:0", (R, E), np.bool_, None),
    ("__match__", (C, R), np.bool_, None),
    ("m0", (L, R), np.bool_, None),
    ("kl0.kv", (K, R), np.int32, None),
    ("ek0", (K, R, E), np.bool_, None),
    ("t0.ok", (T,), np.bool_, 0),
    ("t0.v", (T,), np.int32, 0),
    ("__strbytes__", (T, W), np.uint8, 0),
]


@pytest.mark.parametrize("n_rows", [1, 5, 9, 20])
@pytest.mark.parametrize("name,shape,dtype,axis", SCATTER_CASES,
                         ids=[c[0] for c in SCATTER_CASES])
def test_scatter_rows_matches_reference(ref_executor, name, shape, dtype,
                                        axis, n_rows):
    """Bucket padding (1, 5 -> 8; 9 -> 16; 20 -> 32 rows, the first row
    repeated), every layout and dtype: the same device array, the same
    padded row count, the old array untouched."""
    rng = np.random.default_rng(
        [c[0] for c in SCATTER_CASES].index(name) * 100 + n_rows)
    ax = axis if axis is not None else tex._r_axis(name)
    old = _values(rng, shape, dtype)
    rows = np.sort(rng.choice(shape[ax], size=n_rows, replace=False))
    new = old.copy()
    idx = [slice(None)] * len(shape)
    idx[ax] = rows
    new[tuple(idx)] = _values(rng, new[tuple(idx)].shape, dtype)

    ex = tex.ProgramExecutor(device="cpu")
    dev = ex._put(name, old)
    calls = tscatter.scatter_rows.plain_calls
    got = ex._scatter_rows(name, dev, new, rows, axis=axis)
    assert tscatter.scatter_rows.plain_calls == calls + 1

    rows_before = ref_executor.h2d_scatter_rows
    rdev = ref_executor._put(name, old, False)
    want = np.asarray(ref_executor._scatter_rows(name, rdev, new, rows,
                                                 False, axis=axis))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), new)
    np.testing.assert_array_equal(dev.numpy(), old)
    b = max(8, 1 << (n_rows - 1).bit_length())
    assert ex.h2d_scatter_rows == b == \
        ref_executor.h2d_scatter_rows - rows_before
    assert ex.h2d_scatter_bytes == old.nbytes // shape[ax] * b + 4 * b


@pytest.mark.parametrize("name,shape,narrow,new_hi", [
    ("r:x", (1 << 16,), np.int8, 100),        # fits: scattered narrow
    ("r:x", (1 << 16,), np.int8, 40_000),     # overflows: whole upload
    ("kl0.kv", (2, 1 << 15), np.int16, 30_000),
    ("kl0.kv", (2, 1 << 15), np.int16, 40_000),
])
def test_scatter_rows_narrow_column(ref_executor, name, shape, narrow,
                                    new_hi):
    """A column of 2^16+ int32 elements ships narrow (_put); new values
    that still fit are scattered narrow, values that overflow it force a
    whole re-upload, as in the reference."""
    rng = np.random.default_rng(new_hi)
    hi = np.iinfo(narrow).max - 1
    old = rng.integers(-1, hi, size=shape).astype(np.int32)
    ax = tex._r_axis(name)
    rows = np.sort(rng.choice(shape[ax], size=7, replace=False))
    new = old.copy()
    idx = [slice(None)] * len(shape)
    idx[ax] = rows
    new[tuple(idx)] = new_hi

    ex = tex.ProgramExecutor(device="cpu")
    dev = ex._put(name, old)
    rh2d, rows0 = ref_executor.h2d_bytes, ref_executor.h2d_scatter_rows
    rdev = ref_executor._put(name, old, False)
    assert dev.dtype == {np.int8: torch.int8, np.int16: torch.int16}[narrow]
    assert ex.h2d_bytes == ref_executor.h2d_bytes - rh2d == \
        dev.numel() * dev.element_size()
    h2d, rh2d = ex.h2d_bytes, ref_executor.h2d_bytes
    got = ex._scatter_rows(name, dev, new, rows)
    want = np.asarray(ref_executor._scatter_rows(name, rdev, new, rows,
                                                 False))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().astype(np.int32), new)
    fits = new_hi <= np.iinfo(narrow).max
    assert got.dtype == (dev.dtype if fits else torch.int32)
    assert ex.h2d_scatter_rows == (8 if fits else 0) == \
        ref_executor.h2d_scatter_rows - rows0
    assert ex.h2d_bytes - h2d == ref_executor.h2d_bytes - rh2d == \
        (0 if fits else new.nbytes)


# -- K5: the dirty-row evaluation against the reference's _delta_fn


@pytest.mark.parametrize("kind", LIBRARY_KINDS)
def test_delta_matches_reference(library, ref_executor, kind):  # noqa: F811
    """The library programs of test_torch_executor's fixture: a random
    stored mask with random dirty rows re-evaluated, through the port's
    plain delta and the reference's delta program, bit for bit."""
    comp, lp, b = library[kind]
    if lp is None:
        pytest.skip(f"{kind} does not lower (test_torch_executor checks "
                    "that the port rejects it too)")
    rng = np.random.default_rng(sum(map(ord, kind)))
    viol_old = rng.random((b.c_pad, b.r_pad)) < 0.5
    dirty = np.sort(rng.choice(b.n_resources, size=11, replace=False))
    rows = tex.pad_rows(dirty).astype(np.int32)
    assert rows.shape == (16,) and (rows[11:] == dirty[0]).all()
    names = tuple(sorted(b.arrays))
    fn = ref_executor._delta_fn(lp.program, names, len(rows))
    want = np.asarray(fn(jnp.asarray(viol_old), jnp.asarray(rows),
                         *(jnp.asarray(b.arrays[nm]) for nm in names)))
    prog = convert.program_from_plain(*_plain_program(lp.program))
    calls = ir_eval.delta_mask.plain_calls
    got = ir_eval.delta_mask(prog, convert.arrays_to_device(b.arrays, "cpu"),
                             torch.from_numpy(viol_old),
                             torch.from_numpy(rows))
    assert ir_eval.delta_mask.plain_calls == calls + 1
    np.testing.assert_array_equal(got.numpy(), want)
    # the clean rows keep the stored mask; the dirty ones are the full
    # evaluation's
    full = tex._eval_mask(prog, convert.arrays_to_device(b.arrays, "cpu"))
    clean = np.setdiff1d(np.arange(b.r_pad), dirty)
    np.testing.assert_array_equal(got.numpy()[:, clean], viol_old[:, clean])
    np.testing.assert_array_equal(got.numpy()[:, dirty],
                                  full.numpy()[:, dirty])


# -- the drivers under churn rounds


def _relabel(objs, rng, n, keys, values):
    """Pure upserts: labels drawn from strings the store already holds
    on n existing objects, names unchanged."""
    out = []
    for i in rng.sample(range(len(objs)), n):
        o = copy.deepcopy(objs[i])
        o["metadata"]["labels"] = {k: rng.choice(values) for k in keys
                                   if rng.random() < 0.4}
        objs[i] = o
        out.append(o)
    return out


def _reimage(objs, rng, n, tag):
    """Upserts that intern new image strings (interner growth)."""
    out = []
    pods = [i for i, o in enumerate(objs) if o["kind"] == "Pod"]
    for i in rng.sample(pods, n):
        o = copy.deepcopy(objs[i])
        for c in o["spec"]["containers"]:
            c["image"] = rng.choice(["gcr.io/", "docker.io/", "evil.io/"]) \
                + f"new{tag}-{rng.randrange(4)}:1"
        objs[i] = o
        out.append(o)
    return out


class _Scenario:
    """The same store on JaxDriver, TorchDriver(device="cpu") and
    LocalDriver, driven through churn rounds."""

    def __init__(self, name):
        self.name = name
        self.drivers = (JaxDriver(), TorchDriver(device="cpu"),
                        LocalDriver())
        self.td = self.drivers[1]
        if name == "north_star":
            self.objs = make_resources(250, random.Random(1))
            self.clients = (
                _jax_north_star(self.drivers[0], self.objs,
                                random.Random(2), 3),
                setup_north_star(self.td, self.objs, random.Random(2),
                                 c_per_kind=3),
                _jax_north_star(self.drivers[2], self.objs,
                                random.Random(2), 3))
            self.fresh = make_resources(280, random.Random(7))[250:]
            self.labels = ([f"l{j}" for j in range(10)], ["v"])
            self.constraint = ("K8sRequiredLabels", "labels-001",
                               {"labels": ["l1", "l2"]})
        else:
            self.objs = make_mixed(random.Random(0), 250)
            self.clients = (JBackend(self.drivers[0]).new_client([JTarget()]),
                            TBackend(self.td).new_client([TTarget()]),
                            JBackend(self.drivers[2]).new_client([JTarget()]))
            for c, docs in zip(self.clients, (jall_docs(), tall_docs(),
                                              jall_docs())):
                for t, con in docs:
                    c.add_template(t)
                    c.add_constraint(con)
                c.add_data_batch(copy.deepcopy(self.objs))
            self.fresh = make_mixed(random.Random(5), 280)[250:]
            self.labels = (["env", "owner", "app"],
                           ["prod", "dev", "x", "y"])
            self.constraint = ("K8sRequiredLabels",
                               "k8srequiredlabels-sample",
                               {"labels": ["owner", "env"]})

    def upsert(self, objs):
        for c in self.clients:
            for o in objs:
                c.add_data(copy.deepcopy(o))

    def remove(self, objs):
        for c in self.clients:
            for o in objs:
                c.remove_data(o)

    def edit_constraint(self):
        """New parameters and match criteria: the kind rebuilds, and
        from then on carries a [C, R] match mask."""
        kind, name, params = self.constraint
        for c in self.clients:
            c.add_constraint({
                "apiVersion": "constraints.gatekeeper.sh/v1alpha1",
                "kind": kind, "metadata": {"name": name},
                "spec": {"match": {"kinds": [{"apiGroups": [""],
                                              "kinds": ["Pod"]}]},
                         "parameters": params}})


def _round(sc, rng, what, r):
    if what == "upsert":
        sc.upsert(_relabel(sc.objs, rng, 12, *sc.labels))
    elif what == "images":
        sc.upsert(_reimage(sc.objs, rng, 6, r))
    elif what == "add":
        sc.upsert([sc.fresh.pop() for _ in range(8)])
    elif what == "remove":
        gone = [sc.objs.pop(rng.randrange(len(sc.objs))) for _ in range(6)]
        sc.remove(gone)
    elif what == "namespace":
        sc.upsert([{"apiVersion": "v1", "kind": "Namespace",
                    "metadata": {"name": ns, "labels": {"team": f"t{r}"}}}
                   for ns in ("ns3", "prod")])
    elif what == "constraint":
        sc.edit_constraint()
    else:
        raise ValueError(what)


ROUNDS = ("upsert", "images", "upsert", "add", "remove", "upsert",
          "namespace", "upsert", "constraint", "upsert")


def _full_builds(td) -> int:
    return td.metrics.counter("bindings_full_builds").value


@pytest.mark.parametrize("scenario", ["north_star", "library"])
def test_churn_rounds_match_reference(scenario, monkeypatch):
    """Every round: equal results at caps None, 20 and 2 (LocalDriver
    uncapped).  Pure-upsert rounds take the delta plan on every device
    kind whose host bindings were delta-updated: delta evaluations rise,
    and full evaluations rise only by the kinds whose bindings had to be
    rebuilt (update_bindings bails out when, say, the interner outgrew a
    kind's table bucket; the reference's prep is the same code).  The
    counters are the legacy sweep's: the paged route is switched off."""
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    sc = _Scenario(scenario)
    ex = sc.td.executor
    _assert_parity(sc.clients)
    assert ex.mask_evals > 0
    rng = random.Random(11)
    clean = 0
    for r, what in enumerate(ROUNDS):
        _round(sc, rng, what, r)
        mask_evals, delta_evals = ex.mask_evals, ex.delta_evals
        builds = _full_builds(sc.td)
        res = _assert_parity(sc.clients)
        assert res, (what, r)
        if what == "upsert":
            rebuilt = _full_builds(sc.td) - builds
            assert ex.mask_evals - mask_evals == rebuilt, (what, r)
            assert ex.delta_evals > delta_evals, (what, r)
            clean += rebuilt == 0
    assert clean >= 3


def test_scatter_rows_count_matches_reference(monkeypatch):
    """On the same churn sequence the port row-scatters exactly the
    rows the reference does, along its legacy full-kind path; pure
    upserts upload no whole array."""
    for k, v in LEGACY.items():
        monkeypatch.setenv(k, v)
    sc = _Scenario("north_star")
    jex, tex_ = sc.drivers[0].executor, sc.td.executor
    clients = sc.clients[:2]
    for c in clients:
        c.audit(limit_per_constraint=20)
    rng = random.Random(3)
    for r, what in enumerate(("upsert", "images", "upsert", "add", "upsert",
                              "remove", "upsert", "namespace", "upsert",
                              "constraint", "upsert", "upsert")):
        _round(sc, rng, what, r)
        builds = _full_builds(sc.td)
        before = (jex.h2d_scatter_rows, tex_.h2d_scatter_rows,
                  tex_.h2d_bytes)
        a, b = ([_key(x) for x in c.audit(limit_per_constraint=20).results()]
                for c in clients)
        assert a == b and a, (what, r)
        rows = (jex.h2d_scatter_rows - before[0],
                tex_.h2d_scatter_rows - before[1])
        assert rows[0] == rows[1], (what, r, rows)
        if what == "upsert":
            assert rows[1] > 0, (what, r)
        if what == "upsert" and _full_builds(sc.td) == builds:
            assert tex_.h2d_bytes == before[2], (what, r)


def test_old_generations_are_freed(monkeypatch):
    """After each churned sweep the newest bindings of every kind have
    no base left, and a generation three sweeps old is gone: the driver
    keeps only the current and the retired one (with their device
    arrays and stored masks).  Along the legacy sweep, which keeps the
    stored masks (the paged route is switched off)."""
    monkeypatch.setenv("GATEKEEPER_PAGES", "off")
    objs = make_resources(300, random.Random(4))
    td = TorchDriver(device="cpu")
    client = setup_north_star(td, objs, random.Random(5), c_per_kind=3)
    client.audit(limit_per_constraint=20)
    st = td.state[TARGET]
    rng = random.Random(6)
    gens = []
    for _ in range(6):
        for o in _relabel(objs, rng, 5, ["l1", "l4"], ["v"]):
            client.add_data(o)
        client.audit(limit_per_constraint=20)
        gens.append({k: weakref.ref(v[1])
                     for k, v in st.bindings_cache.items()})
    assert len(gens[-1]) == 3
    assert td.executor.delta_evals == 18 and td.executor.mask_evals == 3
    for kind, (_, b) in st.bindings_cache.items():
        assert b.base is None and not b.base_dirty, kind
        assert len(b.__dict__["_viol_masks"]) == 1
    gc.collect()
    for kind, ref in gens[-4].items():
        assert ref() is None, kind
    for kind, ref in gens[-2].items():      # the retired generation
        assert ref() is st.bindings_retired[kind][1]


# -- the churn scenarios of tests/test_delta.py and tests/test_full_sweep.py,
# driven through TorchDriver beside the reference drivers


def _three_clients():
    drivers = (LocalDriver(), JaxDriver(), TorchDriver(device="cpu"))
    return drivers, (JBackend(drivers[0]).new_client([JTarget()]),
                     JBackend(drivers[1]).new_client([JTarget()]),
                     TBackend(drivers[2]).new_client([TTarget()]))


def _sorted_keys(client, limit=None, full=False):
    return sorted(_key(r) for r in client.audit(limit_per_constraint=limit,
                                                full=full).results())


def test_library_churn_scenario_matches_reference():
    """tests/test_delta.py's library churn: updates that reuse names,
    add + delete, and a Namespace relabel; uncapped results equal the
    scalar oracle and JaxDriver, capped ones JaxDriver."""
    rng = random.Random(23)
    (_, _, td), clients = _three_clients()
    for i, c in enumerate(clients):
        for t, con in (tall_docs() if i == 2 else jall_docs()):
            c.add_template(t)
            c.add_constraint(con)
    objs = make_mixed(rng, 120)
    for ns in ("default", "prod", "dev"):
        objs.append({"apiVersion": "v1", "kind": "Namespace",
                     "metadata": {"name": ns, "labels": {"env": ns}}})
    for c in clients:
        for o in objs:
            c.add_data(copy.deepcopy(o))

    def check(r):
        local, jx, tr = (_sorted_keys(c) for c in clients)
        assert tr == local == jx, f"round {r}"
        assert _sorted_keys(clients[2], 3) == \
            _sorted_keys(clients[1], 3), f"round {r}"

    check(-1)
    deltas = td.metrics.counter("bindings_delta_updates").value
    for r in range(4):
        for o in make_mixed(rng, 8):
            o["metadata"]["name"] = f"pod{rng.randrange(120)}"
            o["kind"], o["apiVersion"] = "Pod", "v1"
            for c in clients:
                c.add_data(copy.deepcopy(o))
        if r == 1:
            new = make_mixed(rng, 3)
            for c in clients:
                for o in new:
                    c.add_data(copy.deepcopy(o))
                for o in objs[:2]:
                    c.remove_data(o)
        if r == 2:
            for c in clients:
                c.add_data({"apiVersion": "v1", "kind": "Namespace",
                            "metadata": {"name": "prod",
                                         "labels": {"env": "changed"}}})
        check(r)
    # every round adds keys (most reused names are new pods), so the
    # device takes the full plan as the reference's does; the host
    # bindings still update by delta
    assert td.metrics.counter("bindings_delta_updates").value > deltas


def _ingress(name, ns, host):
    return {"apiVersion": "extensions/v1beta1", "kind": "Ingress",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"host": host}}


def test_inventory_join_churn_matches_reference():
    """tests/test_delta.py's K8sUniqueIngressHost churn: an upsert or a
    removal elsewhere flips this row's duplicate verdict (the join's
    cross-row dirty rows), through the port's delta path."""
    from gatekeeper_tpu.library.templates import LIBRARY as JLIB
    from gatekeeper_tpu.library.templates import constraint_doc, template_doc
    from gatekeeper_tpu_torch.library.templates import LIBRARY as TLIB
    from gatekeeper_tpu_torch.library.templates import (
        constraint_doc as tconstraint, template_doc as ttemplate)
    (_, _, td), clients = _three_clients()
    for i, c in enumerate(clients):
        if i == 2:
            c.add_template(ttemplate("K8sUniqueIngressHost",
                                     TLIB["K8sUniqueIngressHost"][0]))
            c.add_constraint(tconstraint("K8sUniqueIngressHost", "uniq"))
        else:
            c.add_template(template_doc("K8sUniqueIngressHost",
                                        JLIB["K8sUniqueIngressHost"][0]))
            c.add_constraint(constraint_doc("K8sUniqueIngressHost", "uniq"))
    assert td.state[TARGET].templates["K8sUniqueIngressHost"] \
        .vectorized is not None
    objs = [_ingress("a", "ns1", "x.com"), _ingress("b", "ns2", "x.com"),
            _ingress("c", "ns1", "y.com"), _ingress("c2", "ns3", "z.com"),
            _ingress("d", "ns1", "w.com"), _ingress("d", "ns2", "w.com"),
            {"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": "p", "namespace": "ns1"},
             "spec": {"host": "x.com", "containers": []}}]
    steps = [("add", objs),
             ("add", [_ingress("c", "ns1", "x.com")]),
             ("remove", [_ingress("a", "ns1", "x.com")]),
             ("add", [_ingress("c2", "ns3", "x.com")]),
             ("remove", [_ingress("b", "ns2", "x.com"),
                         _ingress("c", "ns1", "x.com"),
                         _ingress("c2", "ns3", "x.com")])]
    names = []
    for op, batch in steps:
        for c in clients:
            for o in batch:
                (c.add_data if op == "add" else c.remove_data)(
                    copy.deepcopy(o))
        local, jx, tr = (_sorted_keys(c) for c in clients)
        assert tr == local == jx, (op, batch)
        names.append({k[5] for k in tr})
    assert names[:3] == [{"a", "b", "p"}, {"a", "b", "c", "p"},
                         {"b", "c", "p"}]
    assert names[-1] == set()
    assert td.executor.delta_evals > 0


def test_full_sweep_under_churn_matches_reference():
    """tests/test_full_sweep.py's library scenario: audit(full=True)
    equals the memoized sweep and the scalar oracle, before and after a
    third of the rows are relabelled; the forced full sweep stages its
    uploads first and so evaluates whole, as the reference does."""
    resources = make_mixed(random.Random(5), 120)
    (ld, _, td), (cl, _, ct) = _three_clients()
    for c, docs in ((cl, jall_docs()), (ct, tall_docs())):
        for t, con in docs:
            c.add_template(t)
            c.add_constraint(con)
        c.add_data_batch(copy.deepcopy(resources))
    memo1 = _sorted_keys(ct, 20)
    evals = td.executor.mask_evals
    full1 = _sorted_keys(ct, 20, full=True)
    assert td.executor.mask_evals > evals and td.executor.delta_evals == 0
    assert memo1 == full1 == _sorted_keys(ct, 20)
    assert _sorted_keys(ct) == _sorted_keys(cl)
    churn = random.Random(7)
    for r in churn.sample(resources, len(resources) // 3):
        r.setdefault("metadata", {})["labels"] = {
            k: "v" for k in ["l0", "owner", "team"] if churn.random() < 0.5}
        cl.add_data(copy.deepcopy(r))
        ct.add_data(copy.deepcopy(r))
    evals, deltas = td.executor.mask_evals, td.executor.delta_evals
    full = _sorted_keys(ct, full=True)
    assert td.executor.delta_evals == deltas
    assert td.executor.mask_evals > evals
    assert full == _sorted_keys(cl) == _sorted_keys(ct)
