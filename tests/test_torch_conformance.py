"""The engine conformance table through the port, and the checks of
the reference's suite that no other port test holds.

- The 27 scenarios of tests/test_client_conformance.py (the reference
  framework's driver-agnostic table, e2e_tests.go:63, with the test
  target of test_handler.go:14-119) on the port's ``local`` driver,
  ``torch`` (TorchDriver on the CPU) and ``remote`` (a RemoteDriver over
  ``EngineWorker(TorchDriver(device="cpu"))``).  The test target is
  written here over the port's TargetHandler (the reference's
  ``client/probe.ProbeTarget`` waits for ROADMAP A12) and registered on
  the worker side.
- tests/test_f32_guard.py::TestDriverRouting on the port: a kind with a
  value past float32's exact range runs on the scalar oracle.
- The seeded race harness of tests/test_race_harness.py on
  TorchDriver(device="cpu"), with forced full sweeps (every memo layer
  dropped under the other threads' reviews and churn) among its audits.
"""

import random
import threading
import traceback

import pytest

from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.client.interface import QueryOpts as JQueryOpts
from gatekeeper_tpu.client.local_driver import LocalDriver as JLocalDriver
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget

from gatekeeper_tpu_torch.client.client import Backend
from gatekeeper_tpu_torch.client.interface import QueryOpts
from gatekeeper_tpu_torch.client.local_driver import LocalDriver
from gatekeeper_tpu_torch.client.remote_driver import (EngineWorker,
                                                       RemoteDriver,
                                                       register_target)
from gatekeeper_tpu_torch.client.targets import (TargetHandler,
                                                 UnhandledData, WipeData)
from gatekeeper_tpu_torch.client.types import Result
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.errors import ClientError, CompileError
from gatekeeper_tpu_torch.library import constraint_doc as lib_constraint
from gatekeeper_tpu_torch.library import template_doc as lib_template
from gatekeeper_tpu_torch.library.templates import LIBRARY
from gatekeeper_tpu_torch.store.table import ResourceMeta
from gatekeeper_tpu_torch.target.k8s import TARGET_NAME, K8sValidationTarget
from tests.test_f32_guard import TEMPLATE as F32_TEMPLATE
from tests.test_f32_guard import _constraint as f32_constraint
from tests.test_f32_guard import _pod as f32_pod


class TestTarget(TargetHandler):
    """The framework's test handler (test_handler.go:14-119), as the
    reference's ``client/probe.ProbeTarget`` writes it: data keyed by
    Name, constraints match when their kind equals the review's
    ForConstraint, autoreject when a constraint carries a
    namespaceSelector while no v1/Namespace is cached."""

    __test__ = False
    name = "test.target"

    def process_data(self, obj):
        if isinstance(obj, dict) and "Name" in obj:
            meta = ResourceMeta(api_version="v1", kind="ProbeData",
                                name=obj["Name"], namespace=None)
            return obj["Name"], meta, obj
        raise UnhandledData(f"unhandled: {obj!r}")

    def handle_review(self, obj):
        if isinstance(obj, dict) and "Name" in obj:
            return obj
        raise UnhandledData(f"unhandled review: {obj!r}")

    def handle_violation(self, result: Result):
        result.resource = result.review

    def match_schema(self):
        return {"properties": {"label": {"type": "string"}}}

    def validate_constraint(self, constraint):
        return None

    def make_review(self, meta, obj):
        return obj

    def matching_constraints(self, review, constraints, table):
        for c in constraints:
            if c.get("kind") == review.get("ForConstraint"):
                yield c

    def autoreject_review(self, review, constraints, table):
        has_ns = any(
            (m := table.meta_at(row)) is not None and m.kind == "Namespace"
            and m.api_version == "v1"
            for _, row in table.rows_items())
        out = []
        for c in constraints:
            match = (c.get("spec") or {}).get("match") or {}
            if "namespaceSelector" in match and not has_ns:
                out.append((c, "REJECTION", {}))
        return out


DENY_ALL = """package foo
violation[{"msg": "DENIED", "details": {}}] {
	"always" == "always"
}"""


def template_doc(kind: str, rego: str) -> dict:
    return {
        "apiVersion": "templates.gatekeeper.sh/v1alpha1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": kind.lower()},
        "spec": {
            "crd": {"spec": {
                "names": {"kind": kind},
                "validation": {"openAPIV3Schema": {
                    "properties": {"expected": {"type": "string"}}}},
            }},
            "targets": [{"target": "test.target", "rego": rego}],
        },
    }


def constraint_doc(kind: str, name: str, params=None) -> dict:
    doc = {
        "apiVersion": "constraints.gatekeeper.sh/v1alpha1",
        "kind": kind,
        "metadata": {"name": name},
        "spec": {},
    }
    if params:
        doc["spec"]["parameters"] = params
    return doc


DRIVERS = ["local", "torch", "remote"]


@pytest.fixture(autouse=True)
def _device_path_at_test_sizes(monkeypatch):
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)


@pytest.fixture()
def make_driver():
    """A driver factory by name; every engine worker it starts is
    stopped after the test."""
    workers = []

    def make(name: str):
        if name == "local":
            return LocalDriver()
        if name == "torch":
            return TorchDriver(device="cpu")
        if name == "remote":
            register_target(TestTarget.name, TestTarget)
            register_target(SecondTarget.name, SecondTarget)
            w = EngineWorker(lambda: TorchDriver(device="cpu"))
            w.start()
            workers.append(w)
            return RemoteDriver(w.url)
        raise ValueError(name)

    yield make
    for w in workers:
        w.stop()


@pytest.fixture(params=DRIVERS)
def client(request, make_driver):
    backend = Backend(make_driver(request.param))
    return backend.new_client([TestTarget()])


class TestScenarios:
    def test_add_template(self, client):
        client.add_template(template_doc("Foo", DENY_ALL))

    def test_deny_all(self, client):
        client.add_template(template_doc("Foo", DENY_ALL))
        cstr = constraint_doc("Foo", "ph")
        client.add_constraint(cstr)
        rsps = client.review({"Name": "Sara", "ForConstraint": "Foo"})
        assert rsps.by_target
        results = rsps.results()
        assert len(results) == 1
        assert results[0].constraint == cstr
        assert results[0].msg == "DENIED"

    def test_deny_all_audit(self, client):
        client.add_template(template_doc("Foo", DENY_ALL))
        cstr = constraint_doc("Foo", "ph")
        client.add_constraint(cstr)
        obj = {"Name": "Sara", "ForConstraint": "Foo"}
        client.add_data(obj)
        rsps = client.audit()
        results = rsps.results()
        assert len(results) == 1
        assert results[0].constraint == cstr
        assert results[0].msg == "DENIED"
        assert results[0].resource == obj

    def test_deny_all_audit_x2(self, client):
        client.add_template(template_doc("Foo", DENY_ALL))
        cstr = constraint_doc("Foo", "ph")
        client.add_constraint(cstr)
        client.add_data({"Name": "Sara", "ForConstraint": "Foo"})
        client.add_data({"Name": "Max", "ForConstraint": "Foo"})
        results = client.audit().results()
        assert len(results) == 2
        for r in results:
            assert r.constraint == cstr
            assert r.msg == "DENIED"

    def test_autoreject_all(self, client):
        client.add_template(template_doc("Foo", DENY_ALL))
        cstr = constraint_doc("Foo", "foo-pod")
        cstr["spec"]["match"] = {
            "kinds": [{"apiGroups": [""], "kinds": ["Pod"]}],
            "namespaceSelector": {"matchExpressions": [
                {"key": "someKey", "operator": "Blah", "values": ["some value"]}]},
        }
        cstr["spec"]["parameters"] = {"key": ["value"]}
        client.add_constraint(cstr)
        results = client.review({"Name": "Sara", "ForConstraint": "Foo"}).results()
        assert len(results) == 2
        msgs = sorted(r.msg for r in results)
        assert "REJECTION" in msgs
        for r in results:
            if r.msg == "REJECTION":
                assert r.constraint == cstr

    def test_remove_data(self, client):
        client.add_template(template_doc("Foo", DENY_ALL))
        client.add_constraint(constraint_doc("Foo", "ph"))
        obj = {"Name": "Sara", "ForConstraint": "Foo"}
        obj2 = {"Name": "Max", "ForConstraint": "Foo"}
        client.add_data(obj)
        client.add_data(obj2)
        assert len(client.audit().results()) == 2
        client.remove_data(obj2)
        results = client.audit().results()
        assert len(results) == 1
        assert results[0].resource == obj

    def test_remove_constraint(self, client):
        client.add_template(template_doc("Foo", DENY_ALL))
        cstr = constraint_doc("Foo", "ph")
        client.add_constraint(cstr)
        client.add_data({"Name": "Sara", "ForConstraint": "Foo"})
        assert len(client.audit().results()) == 1
        client.remove_constraint(cstr)
        assert client.audit().results() == []

    def test_remove_template(self, client):
        tmpl = template_doc("Foo", DENY_ALL)
        client.add_template(tmpl)
        client.add_constraint(constraint_doc("Foo", "ph"))
        client.add_data({"Name": "Sara", "ForConstraint": "Foo"})
        assert len(client.audit().results()) == 1
        client.remove_template(tmpl)
        assert client.audit().results() == []

    def test_tracing_off(self, client):
        client.add_template(template_doc("Foo", DENY_ALL))
        client.add_constraint(constraint_doc("Foo", "ph"))
        rsps = client.review({"Name": "Sara", "ForConstraint": "Foo"})
        assert len(rsps.results()) == 1
        for r in rsps.by_target.values():
            assert r.trace is None

    def test_tracing_on(self, client):
        client.add_template(template_doc("Foo", DENY_ALL))
        client.add_constraint(constraint_doc("Foo", "ph"))
        rsps = client.review({"Name": "Sara", "ForConstraint": "Foo"}, tracing=True)
        assert len(rsps.results()) == 1
        for r in rsps.by_target.values():
            assert r.trace is not None

    def test_audit_tracing_enabled(self, client):
        client.add_template(template_doc("Foo", DENY_ALL))
        client.add_constraint(constraint_doc("Foo", "ph"))
        client.add_data({"Name": "Sara", "ForConstraint": "Foo"})
        client.add_data({"Name": "Max", "ForConstraint": "Foo"})
        rsps = client.audit(tracing=True)
        assert len(rsps.results()) == 2
        for r in rsps.by_target.values():
            assert r.trace is not None

    def test_audit_tracing_disabled(self, client):
        client.add_template(template_doc("Foo", DENY_ALL))
        client.add_constraint(constraint_doc("Foo", "ph"))
        client.add_data({"Name": "Sara", "ForConstraint": "Foo"})
        rsps = client.audit(tracing=False)
        for r in rsps.by_target.values():
            assert r.trace is None


class TestClientValidation:
    """Template/constraint validation (client_test.go:132-294 +
    rego_helpers_test.go equivalents)."""

    def test_template_missing_violation_rule(self, client):
        with pytest.raises(CompileError, match="violation"):
            client.add_template(template_doc("Foo", "package foo\nx = 1 { true }"))

    def test_template_bad_rego(self, client):
        with pytest.raises(Exception):
            client.add_template(template_doc("Foo", "package foo\nviolation[{]"))

    def test_template_import_banned(self, client):
        with pytest.raises(CompileError, match="import"):
            client.add_template(template_doc(
                "Foo", "package foo\nimport data.x\nviolation[{\"msg\": \"m\"}] { true }"))

    def test_template_data_ref_restricted(self, client):
        with pytest.raises(CompileError, match="data.inventory"):
            client.add_template(template_doc(
                "Foo", 'package foo\nviolation[{"msg": "m"}] { data.external.x }'))

    def test_template_data_inventory_allowed(self, client):
        client.add_template(template_doc(
            "Foo", 'package foo\nviolation[{"msg": "m"}] { data.inventory.cluster }'))

    def test_template_name_must_match_kind(self, client):
        doc = template_doc("Foo", DENY_ALL)
        doc["metadata"]["name"] = "wrongname"
        with pytest.raises(ClientError, match="lowercase"):
            client.add_template(doc)

    def test_constraint_unknown_kind(self, client):
        with pytest.raises(ClientError, match="no template"):
            client.add_constraint(constraint_doc("Nope", "x"))

    def test_constraint_bad_group(self, client):
        client.add_template(template_doc("Foo", DENY_ALL))
        c = constraint_doc("Foo", "ph")
        c["apiVersion"] = "wrong.group/v1"
        with pytest.raises(ClientError, match="apiVersion"):
            client.add_constraint(c)

    def test_constraint_bad_name(self, client):
        client.add_template(template_doc("Foo", DENY_ALL))
        with pytest.raises(ClientError, match="DNS-1123"):
            client.add_constraint(constraint_doc("Foo", "Bad_Name!"))

    def test_constraint_schema_type_mismatch(self, client):
        client.add_template(template_doc("Foo", DENY_ALL))
        c = constraint_doc("Foo", "ph", params={"expected": 42})
        with pytest.raises(ClientError, match="expected string"):
            client.add_constraint(c)

    def test_wipe_data(self, client):
        client.add_template(template_doc("Foo", DENY_ALL))
        client.add_constraint(constraint_doc("Foo", "ph"))
        client.add_data({"Name": "Sara", "ForConstraint": "Foo"})
        assert len(client.audit().results()) == 1
        client.remove_data(WipeData())
        assert client.audit().results() == []

    def test_dump(self, client):
        client.add_template(template_doc("Foo", DENY_ALL))
        client.add_constraint(constraint_doc("Foo", "ph"))
        client.add_data({"Name": "Sara", "ForConstraint": "Foo"})
        d = client.dump()
        assert "Foo" in d["test.target"]["templates"]
        assert "Sara" in d["test.target"]["data"]

    def test_reset(self, client):
        client.add_template(template_doc("Foo", DENY_ALL))
        client.add_constraint(constraint_doc("Foo", "ph"))
        client.add_data({"Name": "Sara", "ForConstraint": "Foo"})
        client.reset()
        assert client.audit().results() == []

    def test_backend_single_client(self):
        backend = Backend(LocalDriver())
        backend.new_client([TestTarget()])
        with pytest.raises(ClientError, match="one client"):
            backend.new_client([TestTarget()])


class SecondTarget(TestTarget):
    """A second registered target for multi-target templates."""

    name = "second.target"

    def process_data(self, obj):
        if isinstance(obj, dict) and "Alias" in obj:
            meta = ResourceMeta(api_version="v1", kind="AliasData",
                                name=obj["Alias"], namespace=None)
            return obj["Alias"], meta, obj
        raise UnhandledData(f"unhandled: {obj!r}")

    def handle_review(self, obj):
        if isinstance(obj, dict) and "Alias" in obj:
            return obj
        raise UnhandledData(f"unhandled review: {obj!r}")


@pytest.mark.parametrize("driver_name", DRIVERS)
def test_multi_target_template(driver_name, make_driver):
    """spec.targets[] is plural (constrainttemplate_types.go:27-98) and
    the framework keys templates[target][Kind] (client.go:211-213):
    one template with two targets must review/audit through BOTH."""
    backend = Backend(make_driver(driver_name))
    client = backend.new_client([TestTarget(), SecondTarget()])
    doc = template_doc("K8sMulti", DENY_ALL)
    doc["spec"]["targets"] = [
        {"target": "test.target", "rego": DENY_ALL},
        {"target": "second.target",
         "rego": 'package foo\nviolation[{"msg": "ALIAS-DENIED", '
                 '"details": {}}] { 1 == 1 }'},
    ]
    resp = client.add_template(doc)
    assert resp.handled == {"test.target": True, "second.target": True}
    client.add_constraint(constraint_doc("K8sMulti", "deny"))
    client.add_data({"Name": "n1", "ForConstraint": "K8sMulti"})
    client.add_data({"Alias": "a1", "ForConstraint": "K8sMulti"})

    # review routes per target via handle_review
    r1 = client.review({"Name": "x", "ForConstraint": "K8sMulti"})
    assert [r.msg for r in r1.results()] == ["DENIED"]
    assert list(r1.by_target) == ["test.target"]
    r2 = client.review({"Alias": "y", "ForConstraint": "K8sMulti"})
    assert [r.msg for r in r2.results()] == ["ALIAS-DENIED"]
    assert list(r2.by_target) == ["second.target"]

    # audit spans both targets' caches with per-target rego
    audit = client.audit()
    by_target = {t: [r.msg for r in resp.results]
                 for t, resp in audit.by_target.items()}
    assert by_target == {"test.target": ["DENIED"],
                         "second.target": ["ALIAS-DENIED"]}

    # removal unregisters from every target
    client.remove_template(doc)
    assert client.audit().results() == []


# ----------------------------------------------------------------------
# tests/test_f32_guard.py::TestDriverRouting on the port

def _f32_clients():
    """(name, driver, client, QueryOpts class) of the port, the
    reference and the scalar oracle."""
    out = []
    for name, drv, backend, target, opts in (
            ("torch", TorchDriver(device="cpu"), Backend,
             K8sValidationTarget, QueryOpts),
            ("jax", JaxDriver(), JBackend, JTarget, JQueryOpts),
            ("local", JLocalDriver(), JBackend, JTarget, JQueryOpts)):
        out.append((name, drv, backend(drv).new_client([target()]), opts))
    return out


def _f32_names(drv, opts, limit=None):
    got, _ = drv.query_audit(TARGET_NAME, opts(limit_per_constraint=limit))
    return sorted((r.review or {}).get("name", "") for r in got)


class TestDriverRouting:
    @pytest.fixture(autouse=True)
    def _legacy_sweep(self, monkeypatch):
        # the guard lives in the legacy device sweep (the paged route
        # re-evaluates rows on the host)
        monkeypatch.setenv("GATEKEEPER_PAGES", "off")

    def _run(self, quotas, mx, limit=None):
        res = {}
        for nm, drv, c, opts in _f32_clients():
            c.add_template(F32_TEMPLATE)
            c.add_constraint(f32_constraint(mx))
            for i, q in enumerate(quotas):
                c.add_data(f32_pod(i, q))
            res[nm] = _f32_names(drv, opts, limit)
            if nm != "local":
                res[nm + " fallbacks"] = drv.metrics.counter(
                    "f32_unsafe_scalar_fallbacks").value
        return res

    def test_adjacent_past_2_24_parity(self):
        rng = random.Random(0)
        quotas = [2**24, 2**24 + 1] + [rng.randrange(100) for _ in range(40)]
        for limit in (None, 20):
            res = self._run(quotas, 2**24, limit)
            assert res["torch"] == res["jax"] == res["local"] == ["p0001"]
            assert res["torch fallbacks"] == res["jax fallbacks"] >= 1

    def test_small_numbers_stay_on_device(self):
        res = self._run(list(range(40)), 20)
        assert res["torch"] == res["jax"] == res["local"]
        assert res["torch fallbacks"] == res["jax fallbacks"] == 0

    def test_unsafe_constraint_param(self):
        res = self._run([2**24 + 2, 5, 9], 2**24 + 1)
        assert res["torch"] == res["jax"] == res["local"] == ["p0000"]
        assert res["torch fallbacks"] == res["jax fallbacks"] >= 1

    def test_churn_introduces_unsafe_value(self):
        clients = _f32_clients()
        for _nm, _drv, c, _opts in clients:
            c.add_template(F32_TEMPLATE)
            c.add_constraint(f32_constraint(2**24))
            for i in range(40):
                c.add_data(f32_pod(i, i))
        assert [_f32_names(d, o) for _n, d, _c, o in clients] == [[]] * 3
        for _nm, _drv, c, _opts in clients:
            c.add_data(f32_pod(3, 2**24 + 1))
        assert [_f32_names(d, o) for _n, d, _c, o in clients] == \
            [["p0003"]] * 3
        assert clients[0][1].metrics.counter(
            "f32_unsafe_scalar_fallbacks").value >= 1


# ----------------------------------------------------------------------
# the seeded race harness of tests/test_race_harness.py on the port

RACE_KINDS = ["K8sRequiredLabels", "K8sAllowedRepos", "K8sContainerLimits"]
RACE_PARAMS = {
    "K8sRequiredLabels": [{"labels": ["app"]}, {"labels": ["env", "app"]}],
    "K8sAllowedRepos": [{"repos": ["gcr.io/"]}, {"repos": ["quay.io/"]}],
    "K8sContainerLimits": [{"cpu": "1", "memory": "1Gi"}],
}


def _race_pod(rng, i):
    labels = {k: rng.choice("abc") for k in ("app", "env", "tier")
              if rng.random() < 0.6}
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"pod-{i:04d}",
                         "namespace": f"ns{i % 7}", "labels": labels},
            "spec": {"containers": [{
                "name": "c",
                "image": rng.choice(["gcr.io/", "quay.io/", "bad.io/"]) + "app",
                "resources": {"limits": {"cpu": rng.choice(["100m", "2"]),
                                         "memory": "512Mi"}}}]}}


class _Actor(threading.Thread):
    def __init__(self, client, seed, stop, errors, role):
        super().__init__(name=f"{role}-{seed}", daemon=True)
        self.c = client
        self.rng = random.Random(seed)
        self.stop = stop
        self.errors = errors
        self.role = role

    def run(self):
        try:
            while not self.stop.is_set():
                getattr(self, self.role)()
        except Exception:       # noqa: BLE001 - harness collects
            self.errors.append((self.role, traceback.format_exc()))

    def reviewer(self):
        pod = _race_pod(self.rng, self.rng.randrange(500))
        req = {"kind": {"group": "", "version": "v1", "kind": "Pod"},
               "name": pod["metadata"]["name"],
               "namespace": pod["metadata"]["namespace"],
               "operation": "CREATE", "object": pod}
        if self.rng.random() < 0.3:
            self.c.review_batch([req] * self.rng.randint(1, 4))
        else:
            self.c.review(req)

    def auditor(self):
        # a third of the audits are forced full sweeps: they drop every
        # memo layer the other threads read
        opts = QueryOpts(limit_per_constraint=self.rng.choice(
            [1, 5, 20, None]), full=self.rng.random() < 0.35)
        self.c.driver.query_audit(TARGET_NAME, opts)

    def data_churner(self):
        r = self.rng.random()
        if r < 0.75:
            self.c.add_data(_race_pod(self.rng, self.rng.randrange(120)))
        elif r < 0.85:
            batch = [_race_pod(self.rng, self.rng.randrange(120))
                     for _ in range(self.rng.randint(2, 10))]
            self.c.add_data_batch(batch)
        elif r < 0.97:
            self.c.remove_data(_race_pod(self.rng, self.rng.randrange(120)))
        else:
            self.c.add_data(WipeData())

    def lifecycle_churner(self):
        kind = self.rng.choice(RACE_KINDS)
        r = self.rng.random()
        if r < 0.55:
            name = f"{kind.lower()}-{self.rng.randrange(3)}"
            self.c.add_constraint(lib_constraint(
                kind, name, self.rng.choice(RACE_PARAMS[kind])))
        elif r < 0.8:
            name = f"{kind.lower()}-{self.rng.randrange(3)}"
            self.c.remove_constraint(lib_constraint(kind, name))
        elif r < 0.93:
            self.c.add_template(lib_template(kind, LIBRARY[kind][0]))
        else:
            self.c.driver.dump()


def _race_scenario(driver, seed, duration=1.2,
                   roles=("reviewer", "reviewer", "auditor",
                          "data_churner", "lifecycle_churner")):
    c = Backend(driver).new_client([K8sValidationTarget()])
    rng = random.Random(seed)
    for kind in RACE_KINDS:
        c.add_template(lib_template(kind, LIBRARY[kind][0]))
        c.add_constraint(lib_constraint(
            kind, f"{kind.lower()}-0", RACE_PARAMS[kind][0]))
    c.add_data_batch([_race_pod(rng, i) for i in range(60)])

    stop = threading.Event()
    errors: list = []
    actors = [_Actor(c, seed * 100 + i, stop, errors, role)
              for i, role in enumerate(roles)]
    for a in actors:
        a.start()
    threading.Event().wait(duration)
    stop.set()
    for a in actors:
        a.join(timeout=30)
        assert not a.is_alive(), f"{a.name} wedged"
    assert not errors, errors[:2]

    # quiesced audits are idempotent, a forced full sweep among them
    def key(r):
        return (r.msg, (r.constraint or {}).get("metadata", {}).get("name"),
                (r.resource or {}).get("metadata", {}).get("name"))

    c1 = sorted(map(key, c.audit(limit_per_constraint=5).results()))
    c2 = sorted(map(key, c.audit(limit_per_constraint=5,
                                 full=True).results()))
    assert c1 == c2, "capped audit not idempotent after quiesce"
    a1 = sorted(map(key, c.audit().results()))
    a2 = sorted(map(key, c.audit(full=True).results()))
    assert a1 == a2, "audit not idempotent after quiesce"

    # a fresh scalar driver fed the final state agrees
    st = c.driver.state[TARGET_NAME]
    fresh = Backend(LocalDriver()).new_client([K8sValidationTarget()])
    for kind in st.templates:
        fresh.add_template(lib_template(kind, LIBRARY[kind][0]))
    for kind in st.constraints:
        for _name, con in sorted(st.constraints[kind].items()):
            fresh.add_constraint(con)
    fresh.add_data_batch([st.table.object_at(row)
                          for _k, row in sorted(st.table.rows_items())])
    a3 = sorted(map(key, fresh.audit().results()))
    assert a1 == a3, "incremental state diverged from fresh replay"
    assert not [t for t in threading.enumerate()
                if t.name.startswith("audit-dispatch") and t.is_alive()]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_torch_driver_scenario(seed):
    _race_scenario(TorchDriver(device="cpu"), seed)


def test_heavy_wipe_and_template_churn():
    _race_scenario(TorchDriver(device="cpu"), 11, duration=1.5,
                   roles=("reviewer", "auditor", "auditor",
                          "data_churner", "data_churner",
                          "lifecycle_churner", "lifecycle_churner"))
