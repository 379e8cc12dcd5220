"""The admission micro-batch of the port (``TorchDriver.query_review_batch``)
against its own per-review ``query_review`` and the JAX reference's
``JaxDriver.query_review_batch``, on the CPU.

Ports of ``tests/test_delta.py::TestDeviceBatchReview`` and
``::TestBatchReviewInventoryGuard``: the same seeded reviews go through
``TorchDriver(device="cpu")`` (whose device pass runs K1's and K3's plain
versions) and ``JaxDriver``, both routing thresholds set to 1, and every
review's results must be equal, exactly, as (msg, constraint name) lists:
CREATE/UPDATE/DELETE mixed under the whole library, a namespaceSelector
constraint against cached namespaces, an inventory-join kind, shed
enforcement actions and an f32-unsafe binding.  Below the threshold,
under tracing and with the device path degraded the batch is the
per-review scalar loop.  ``memsurface_review_cap`` equals the
reference's on one installed set at several budgets.
"""

import random

import pytest

from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.client.interface import QueryOpts as JOpts
from gatekeeper_tpu.engine import jax_driver
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.library import all_docs, make_mixed
from gatekeeper_tpu.library.templates import (LIBRARY, constraint_doc,
                                              template_doc)
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.client.interface import QueryOpts as TOpts
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.kernels import ir_eval
from gatekeeper_tpu_torch.target.k8s import TARGET_NAME
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget

# the shipped default, read before any test sets it
SHIPPED_MIN_EVALS = torch_driver.REVIEW_BATCH_MIN_EVALS


@pytest.fixture(autouse=True)
def _thresholds(monkeypatch):
    for mod in (jax_driver, torch_driver):
        monkeypatch.setattr(mod, "SMALL_WORKLOAD_EVALS", 1)
        monkeypatch.setattr(mod, "REVIEW_BATCH_MIN_EVALS", 1)
    for var in ("GATEKEEPER_HBM_BUDGET", "GATEKEEPER_HBM_BUDGET_BYTES",
                "GATEKEEPER_MS_MAX_ROWS"):
        monkeypatch.delenv(var, raising=False)


def _clients(templates, constraints, objs=()):
    """A port client on the CPU and a reference client, same documents
    and cached objects."""
    t = TBackend(TorchDriver(device="cpu")).new_client([TTarget()])
    j = JBackend(JaxDriver()).new_client([JTarget()])
    for c in (t, j):
        for doc in templates:
            c.add_template(doc)
        for doc in constraints:
            c.add_constraint(doc)
        for o in objs:
            c.add_data(o)
    return t, j


def _library_clients(objs=()):
    docs = all_docs()
    return _clients([d for d, _ in docs], [c for _, c in docs], objs)


NAMESPACES = [{"apiVersion": "v1", "kind": "Namespace",
               "metadata": {"name": ns, "labels": labels}}
              for ns, labels in (("default", {"env": "prod"}), ("dev", {}))]


def _reviews(objs, ops=("CREATE", "UPDATE", "DELETE")):
    out = []
    for i, o in enumerate(objs):
        out.append({
            "kind": {"group": "", "version": "v1",
                     "kind": o.get("kind", "Pod")},
            "name": o["metadata"]["name"],
            "namespace": o["metadata"].get("namespace",
                                           ["default", "nowhere"][i % 2]),
            "operation": ops[i % len(ops)], "object": o})
    return out


def _keys(results):
    return [(r.msg, r.constraint["metadata"]["name"]) for r in results]


def _check(t, j, reviews, opts=None, device=True, kernel=True):
    """The port's batch equals its per-review loop and the reference's
    batch, review by review; returns the port's batch.  ``device``: the
    batch took the device pass; ``kernel``: some kind of it ran K1 (its
    plain version here), not only the match gate."""
    topts = TOpts(**(opts or {}))
    jopts = JOpts(**(opts or {}))
    td, jd = t.driver, j.driver
    b0 = td.metrics.counter("review_batches_device").value
    plain0 = ir_eval.eval_mask.plain_calls
    batched = td.query_review_batch(TARGET_NAME, reviews, topts)
    ran = td.metrics.counter("review_batches_device").value - b0
    single = [td.query_review(TARGET_NAME, r, topts) for r in reviews]
    ref = jd.query_review_batch(TARGET_NAME, reviews, jopts)
    assert len(batched) == len(single) == len(ref) == len(reviews)
    for i, ((br, _), (sr, _), (jr, _)) in enumerate(zip(batched, single,
                                                        ref)):
        assert _keys(br) == _keys(sr), f"review {i}: batch != per-review"
        assert _keys(br) == _keys(jr), f"review {i}: port != reference"
    if device:
        assert ran == 1
        assert td.metrics.counter("reviews_device").value >= len(reviews)
        assert (ir_eval.eval_mask.plain_calls > plain0) == kernel
    else:
        assert ran == 0
    return batched


def test_library_batch_mixed_operations():
    """Every library template, cached namespaces, CREATE/UPDATE/DELETE
    mixed: the operation gate, the regex kind (K3's plain version) and
    unlowerable kinds all take part."""
    t, j = _library_clients(NAMESPACES)
    reviews = _reviews(make_mixed(random.Random(31), 40))
    out = _check(t, j, reviews)
    assert any(br for br, _ in out)
    assert j.driver.metrics.counter("review_batches_device").value == 1


def test_create_only_batch_runs_every_lowered_kind_on_device():
    """A CREATE-only batch puts even the $meta.operation kinds through
    the device gate."""
    t, j = _library_clients(NAMESPACES)
    reviews = _reviews(make_mixed(random.Random(7), 24), ops=("CREATE",))
    _check(t, j, reviews)


def test_namespace_selector_against_cached_namespaces():
    """A namespaceSelector constraint matches against the real cached
    namespaces on the host (the mini table over-approximates it), and an
    uncached namespace is auto-rejected."""
    sel = constraint_doc("K8sRequiredLabels", "sel-prod",
                         {"labels": ["owner"]})
    sel["spec"]["match"] = {"kinds": [{"apiGroups": [""],
                                       "kinds": ["Pod"]}],
                            "namespaceSelector": {
                                "matchLabels": {"env": "prod"}}}
    plain = constraint_doc("K8sRequiredLabels", "plain",
                           {"labels": ["team"]})
    t, j = _clients([template_doc("K8sRequiredLabels",
                                  LIBRARY["K8sRequiredLabels"][0])],
                    [sel, plain], NAMESPACES)
    objs = make_mixed(random.Random(3), 30)
    pods = [o for o in objs if o.get("kind") == "Pod"]
    for i, o in enumerate(pods):
        o["metadata"]["namespace"] = ["default", "dev", "nowhere"][i % 3]
    out = _check(t, j, _reviews(pods, ops=("CREATE",)))
    names = {n for br, _ in out for _m, n in _keys(br)}
    assert "sel-prod" in names and "plain" in names


def test_inventory_join_kind_sees_the_real_inventory():
    """An inventory-join kind keeps the match gate and the exact host
    evaluation: a new Ingress duplicating a cached host is flagged
    although no other review in the batch shares it."""
    existing = {"apiVersion": "extensions/v1beta1", "kind": "Ingress",
                "metadata": {"name": "existing", "namespace": "ns1"},
                "spec": {"host": "x.com"}}
    t, j = _clients([template_doc("K8sUniqueIngressHost",
                                  LIBRARY["K8sUniqueIngressHost"][0])],
                    [constraint_doc("K8sUniqueIngressHost", "uniq")],
                    [existing])
    new = {"apiVersion": "extensions/v1beta1", "kind": "Ingress",
           "metadata": {"name": "incoming", "namespace": "ns2"},
           "spec": {"host": "x.com"}}
    other = {"apiVersion": "extensions/v1beta1", "kind": "Ingress",
             "metadata": {"name": "other", "namespace": "ns2"},
             "spec": {"host": "y.com"}}
    reviews = [{"kind": {"group": "extensions", "version": "v1beta1",
                         "kind": "Ingress"},
                "name": o["metadata"]["name"], "namespace": "ns2",
                "operation": "CREATE", "object": o} for o in (new, other)]
    out = _check(t, j, reviews, kernel=False)
    assert any("duplicate ingress host" in m for m, _ in _keys(out[0][0]))
    assert _keys(out[1][0]) == []


def test_shed_actions_drop_constraints_before_evaluation():
    """Constraints whose enforcement action is shed take no part, on the
    device or the host."""
    docs = all_docs()
    cons = []
    for i, (_t, c) in enumerate(docs):
        c = dict(c, spec=dict(c.get("spec") or {}))
        c["spec"]["enforcementAction"] = ("deny", "warn", "dryrun")[i % 3]
        cons.append(c)
    t, j = _clients([d for d, _ in docs], cons, NAMESPACES)
    reviews = _reviews(make_mixed(random.Random(11), 30))
    full = _check(t, j, reviews)
    shed = _check(t, j, reviews, {"shed_actions": frozenset({"dryrun"})})
    acts = {r.enforcement_action for br, _ in shed for r in br}
    assert "dryrun" not in acts
    assert sum(map(len, (br for br, _ in shed))) \
        < sum(map(len, (br for br, _ in full)))


F32_TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1alpha1",
    "kind": "ConstraintTemplate",
    "metadata": {"name": "k8smaxquota"},
    "spec": {"crd": {"spec": {"names": {"kind": "K8sMaxQuota"}}},
             "targets": [{"target": TARGET_NAME, "rego": """package k8smaxquota
violation[{"msg": msg}] {
  input.review.object.spec.quota > input.constraint.spec.parameters.max
  msg := sprintf("quota %v over max", [input.review.object.spec.quota])
}
"""}]},
}


def test_f32_unsafe_binding_keeps_the_match_gate():
    """2^24 and 2^24 + 1 collapse to one float32: a batch whose bindings
    are not float32-exact keeps the match gate and lets the oracle
    decide, so exactly the larger quota violates max = 2^24."""
    con = {"apiVersion": "constraints.gatekeeper.sh/v1alpha1",
           "kind": "K8sMaxQuota", "metadata": {"name": "maxq"},
           "spec": {"parameters": {"max": 2 ** 24}}}
    t, j = _clients([F32_TEMPLATE], [con])
    quotas = [2 ** 24, 2 ** 24 + 1, 3, 2 ** 25]
    objs = [{"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"p{i}", "namespace": "d"},
             "spec": {"quota": q}} for i, q in enumerate(quotas)]
    out = _check(t, j, _reviews(objs, ops=("CREATE",)), kernel=False)
    assert [bool(br) for br, _ in out] == [False, True, False, True]


def test_below_threshold_runs_the_scalar_loop(monkeypatch):
    monkeypatch.setattr(torch_driver, "REVIEW_BATCH_MIN_EVALS", 10 ** 9)
    monkeypatch.setattr(jax_driver, "REVIEW_BATCH_MIN_EVALS", 10 ** 9)
    t, j = _library_clients(NAMESPACES)
    _check(t, j, _reviews(make_mixed(random.Random(5), 12)), device=False)
    assert t.driver.metrics.counter("review_batches_device").value == 0


def test_tracing_runs_the_scalar_loop():
    t, j = _library_clients(NAMESPACES)
    reviews = _reviews(make_mixed(random.Random(6), 8))
    out = _check(t, j, reviews, {"tracing": True}, device=False)
    assert all(trace is not None for _r, trace in out)


def test_degraded_device_path_runs_the_scalar_loop(monkeypatch):
    monkeypatch.setattr(TorchDriver, "scalar_only",
                        property(lambda self: True))
    monkeypatch.setattr(JaxDriver, "scalar_only",
                        property(lambda self: True))
    t, j = _library_clients(NAMESPACES)
    _check(t, j, _reviews(make_mixed(random.Random(8), 10)), device=False)


def test_empty_batch():
    t, _j = _library_clients()
    assert t.driver.query_review_batch(TARGET_NAME, [], TOpts()) == []
    assert t.driver.metrics.counter("review_batches_device").value == 0


@pytest.mark.parametrize("budget", [None, "100000", "2000000000",
                                    "40000000000"])
def test_memsurface_review_cap_equals_the_reference(monkeypatch, budget):
    """Stage 8's review consumer over one installed set: the largest
    rung whose worst per-kind dispatch fits what the resident arrays
    leave of the budget, as the reference computes it (the default
    budgets differ, the card's against the reference's, so the default
    case only checks the port returns a rung)."""
    kinds = ["K8sRequiredLabels", "K8sAllowedRepos", "K8sContainerLimits"]
    by_kind = {d["spec"]["crd"]["spec"]["names"]["kind"]: (d, c)
               for d, c in all_docs()}
    t, j = _clients([by_kind[k][0] for k in kinds],
                    [by_kind[k][1] for k in kinds],
                    make_mixed(random.Random(3), 40))
    if budget is None:
        cap = t.driver.memsurface_review_cap(TARGET_NAME)
        assert isinstance(cap, int) and cap >= 1
        return
    monkeypatch.setenv("GATEKEEPER_HBM_BUDGET_BYTES", budget)
    got = t.driver.memsurface_review_cap(TARGET_NAME)
    assert got == j.driver.memsurface_review_cap(TARGET_NAME)
    assert got >= 1
    monkeypatch.setenv("GATEKEEPER_HBM_BUDGET", "off")
    assert t.driver.memsurface_review_cap(TARGET_NAME) is None
    assert j.driver.memsurface_review_cap(TARGET_NAME) is None


def test_the_shipped_threshold_keeps_measured_batches_scalar(monkeypatch):
    """No batch size the card measured (up to 4,096 reviews x 200
    constraints) beat the scalar loop by more than its own spread, so
    the shipped default keeps them all on the scalar loop; the
    environment variable overrides it, and a malformed value falls back
    to the default."""
    assert SHIPPED_MIN_EVALS == 4096 * 200 + 1
    monkeypatch.setenv("GATEKEEPER_REVIEW_BATCH_MIN_EVALS", "640")
    assert torch_driver._env_int("GATEKEEPER_REVIEW_BATCH_MIN_EVALS", 7) \
        == 640
    monkeypatch.setenv("GATEKEEPER_REVIEW_BATCH_MIN_EVALS", "many")
    assert torch_driver._env_int("GATEKEEPER_REVIEW_BATCH_MIN_EVALS", 7) == 7
