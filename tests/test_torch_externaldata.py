"""External data through the port against the reference.

The flows of tests/test_externaldata.py on the port's own provider
runtime (``gatekeeper_tpu_torch.externaldata``): the TTL cache and
single-flight, the breaker, retries and the deadline, the provider
spec, lowering with the provider tag, one batched fetch round per
audit, the failure policies through the webhook (403 / 500 / admit /
``UseDefault`` / unknown provider), audit containment and recovery, the
builtin, and the Provider controller's lifecycle.  Each package has its
own process-global runtime; each flow installs both, each with a fake
over the same data, and holds TorchDriver(device="cpu") to the
reference's JaxDriver and to the port's scalar LocalDriver: equal
results, answers, fetch-round counts and ``external`` stanza keys.
Then what the port adds: forced full and memoized sweeps, the paged
route's ``external-providers`` fallback under devpages, the
``slow_provider`` fault seam, the admission batch's prefetch, and the
bulk warm joined before the report (its numbers always reported, its
error raised by the sweep).
"""

import threading
import time
import types

import pytest

import gatekeeper_tpu.api.externaldata as j_api
import gatekeeper_tpu.externaldata as j_ext
from gatekeeper_tpu.client.client import Backend as JBackend
from gatekeeper_tpu.engine.jax_driver import JaxDriver
from gatekeeper_tpu.target.k8s import K8sValidationTarget as JTarget
from gatekeeper_tpu.webhook.policy import ValidationHandler as JHandler

import gatekeeper_tpu_torch.api.externaldata as t_api
import gatekeeper_tpu_torch.externaldata as t_ext
from gatekeeper_tpu_torch.api.externaldata import (FAIL, IGNORE,
                                                   PROVIDER_GVK,
                                                   USE_DEFAULT, Provider)
from gatekeeper_tpu_torch.client.client import Backend as TBackend
from gatekeeper_tpu_torch.client.interface import QueryOpts
from gatekeeper_tpu_torch.client.local_driver import LocalDriver
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.errors import ClientError, ExternalDataError
from gatekeeper_tpu_torch.externaldata.breaker import (CLOSED, HALF_OPEN,
                                                       OPEN, CircuitBreaker)
from gatekeeper_tpu_torch.externaldata.cache import (ERROR_TTL_CAP_S,
                                                     Outcome, TTLCache)
from gatekeeper_tpu_torch.externaldata.client import (FetchError,
                                                      ProviderClient)
from gatekeeper_tpu_torch.externaldata.fake import FakeProvider
from gatekeeper_tpu_torch.externaldata.runtime import (ExternalDataRuntime,
                                                       get_runtime,
                                                       set_runtime)
from gatekeeper_tpu_torch.library.templates import (constraint_doc,
                                                    template_doc)
from gatekeeper_tpu_torch.resilience import faults
from gatekeeper_tpu_torch.target.k8s import TARGET_NAME
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget as TTarget
from gatekeeper_tpu_torch.webhook.policy import ValidationHandler as THandler

EXT_SIG = """package k8sextsig
violation[{"msg": msg}] {
  image := input.review.object.spec.image
  verdict := object.get(external_data({"provider": "sig-prov", "keys": [image]}), ["responses", image], "missing")
  verdict == "invalid"
  msg := sprintf("image %v rejected: %v", [image, verdict])
}
"""

REQUIRED_LABEL = """package reqlabel
violation[{"msg": msg}] {
  not input.review.object.metadata.labels.app
  msg := "missing label app"
}
"""

DATA = {"img-a": "valid", "img-b": "invalid"}
SIDES = ("torch", "jax", "local")
# each side's package: its API, its provider runtime and fake registry,
# its client surface
PKG = {
    "torch": types.SimpleNamespace(api=t_api, ext=t_ext, Backend=TBackend,
                                   Target=TTarget, Handler=THandler),
    "jax": types.SimpleNamespace(api=j_api, ext=j_ext, Backend=JBackend,
                                 Target=JTarget, Handler=JHandler),
}
PKG["local"] = PKG["torch"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """The port's device path at test sizes; both packages' runtimes and
    fake registries restored after each test."""
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    monkeypatch.delenv("GATEKEEPER_FAULT", raising=False)
    prev = (t_ext.get_runtime(), j_ext.get_runtime())
    yield
    t_ext.set_runtime(prev[0])
    j_ext.set_runtime(prev[1])
    t_ext.clear_fakes()
    j_ext.clear_fakes()


@pytest.fixture
def runtime():
    rt = ExternalDataRuntime()
    set_runtime(rt)
    return rt


def _install(side, data=None, policy=IGNORE, register=True, **kw):
    """A fresh runtime for ``side``'s package, installed process-wide,
    with a fake over ``data`` registered as provider ``sig-prov``."""
    p = PKG[side]
    rt = p.ext.ExternalDataRuntime()
    p.ext.set_runtime(rt)
    fake = p.ext.register_fake("sig", p.ext.FakeProvider(
        dict(DATA if data is None else data)))
    if register:
        rt.register(p.api.Provider(name="sig-prov", url="fake://sig",
                                   failure_policy=policy, **kw))
    return rt, fake


def _driver(side):
    return {"torch": lambda: TorchDriver(device="cpu"), "jax": JaxDriver,
            "local": LocalDriver}[side]()


def _pod(name, image, ns="default", labels=None):
    meta = {"name": name, "namespace": ns}
    if labels:
        meta["labels"] = labels
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta,
            "spec": {"image": image}}


POD_MATCH = {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}


def _ext_client(side, driver=None, extra_templates=()):
    p = PKG[side]
    drv = driver if driver is not None else _driver(side)
    c = p.Backend(drv).new_client([p.Target()])
    c.add_template(template_doc("K8sExtSig", EXT_SIG))
    c.add_constraint(constraint_doc("K8sExtSig", "sig-check",
                                    match=POD_MATCH))
    for kind, rego in extra_templates:
        c.add_template(template_doc(kind, rego))
        c.add_constraint(constraint_doc(kind, f"{kind.lower()}-c",
                                        match=POD_MATCH))
    return c, drv


def _keys(results):
    return [(r.msg, r.constraint["metadata"]["name"],
             ((r.resource or {}).get("metadata") or {}).get("name"))
            for r in results]


def _stanza_keys(ext):
    """The ``external`` stanza's key structure (values vary by timing)."""
    if ext is None:
        return None
    return {"top": sorted(ext),
            "providers": {n: sorted(s) for n, s in ext["providers"].items()},
            "bulk": sorted(ext.get("bulk_prefetch") or ())}


# ---------------------------------------------------------------------------
# cache


class TestTTLCache:
    def test_ttl_expiry_refetches(self):
        now = [0.0]
        c = TTLCache(ttl_s=10.0, clock=lambda: now[0])
        c.put("k", Outcome(value="v"))
        assert c.get("k").value == "v"
        now[0] = 9.9
        assert c.get("k") is not None
        now[0] = 10.1
        assert c.get("k") is None
        c.put("k", Outcome(value="v2"))
        assert c.get("k").value == "v2"

    def test_error_ttl_capped(self):
        now = [0.0]
        c = TTLCache(ttl_s=3600.0, clock=lambda: now[0])
        c.put("bad", Outcome(error="boom"))
        now[0] = ERROR_TTL_CAP_S + 0.1
        assert c.get("bad") is None
        assert ERROR_TTL_CAP_S == j_ext.ERROR_TTL_CAP_S

    def test_lru_bound(self):
        c = TTLCache(max_entries=2, ttl_s=100.0)
        for k in ("a", "b", "c"):
            c.put(k, Outcome(value=k))
        assert len(c) == 2 and c.evictions == 1
        assert c.get("a") is None and c.get("c").value == "c"

    @pytest.mark.parametrize("side", ["torch", "jax"])
    def test_runtime_ttl_expiry_refetches(self, side):
        rt, fake = _install(side, cache_ttl_s=0.05)
        rt.prefetch("sig-prov", ["img-a"])
        rt.prefetch("sig-prov", ["img-a"])
        assert fake.calls == 1
        time.sleep(0.08)
        out = rt.prefetch("sig-prov", ["img-a"])
        assert fake.calls == 2 and out["img-a"].value == "valid"

    @pytest.mark.parametrize("side", ["torch", "jax"])
    def test_single_flight_dedupes_concurrent_misses(self, side):
        rt, fake = _install(side)
        fake.latency_s = 0.05
        outs = []

        def worker():
            outs.append(rt.prefetch("sig-prov", ["img-a", "img-b"]))

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert fake.calls == 1
        assert len(outs) == 8
        for o in outs:
            assert o["img-a"].value == "valid"
            assert o["img-b"].value == "invalid"


# ---------------------------------------------------------------------------
# breaker + fetch client


class TestBreaker:
    def test_opens_half_opens_closes(self):
        now = [0.0]
        br = CircuitBreaker(failure_threshold=3, cooldown_s=30.0,
                            clock=lambda: now[0])
        for _ in range(2):
            br.record_failure()
        assert br.state == CLOSED
        br.record_failure()
        assert br.state == OPEN
        assert not br.allow() and br.short_circuits == 1
        now[0] = 30.5
        assert br.state == HALF_OPEN
        assert br.allow()
        assert not br.allow()
        br.record_success()
        assert br.state == CLOSED
        assert br.transitions == [CLOSED, OPEN, HALF_OPEN, CLOSED]

    def test_failed_probe_reopens(self):
        now = [0.0]
        br = CircuitBreaker(failure_threshold=1, cooldown_s=10.0,
                            clock=lambda: now[0])
        br.record_failure()
        now[0] = 10.5
        assert br.allow()
        br.record_failure()
        assert br.state == OPEN
        now[0] = 15.0
        assert br.state == OPEN

    def test_success_resets_consecutive_count(self):
        br = CircuitBreaker(failure_threshold=2)
        br.record_failure()
        br.record_success()
        br.record_failure()
        assert br.state == CLOSED

    @pytest.mark.parametrize("side", ["torch", "jax"])
    def test_runtime_outage_opens_breaker_and_short_circuits(self, side):
        rt, fake = _install(side, retries=0, breaker_threshold=2,
                            cache_ttl_s=0.0)
        fake.outage = True
        rt.prefetch("sig-prov", ["k1"])
        rt.prefetch("sig-prov", ["k2"])
        calls = fake.calls
        out = rt.prefetch("sig-prov", ["k3"])
        assert fake.calls == calls
        assert not out["k3"].ok
        assert rt.stats()["sig-prov"]["breaker_state"] == "open"

    def test_retries_bounded_with_backoff(self):
        """The port's backoff sequence equals the reference's (the same
        seeded jitter)."""
        seqs = []
        for pc_cls, p in ((ProviderClient, Provider), (
                j_ext.ProviderClient, j_api.Provider)):
            sleeps = []
            pc = pc_cls(sleep=sleeps.append)
            attempts = []

            def transport(provider, keys, attempts=attempts):
                attempts.append(list(keys))
                if len(attempts) < 3:
                    raise RuntimeError("flaky")
                return {k: "v" for k in keys}

            assert pc.fetch(p(name="p", url="fake://x", retries=2,
                              timeout_s=5.0), transport, ["a"]) == {"a": "v"}
            assert len(attempts) == 3 and len(sleeps) == 2
            assert sleeps[1] > sleeps[0] * 0.5
            seqs.append(sleeps)
        assert seqs[0] == seqs[1]

    def test_retries_exhausted_records_round_failure(self):
        pc = ProviderClient(sleep=lambda s: None)
        p = Provider(name="p", url="fake://x", retries=1, timeout_s=5.0,
                     breaker_threshold=1)

        def transport(provider, keys):
            raise RuntimeError("down")

        with pytest.raises(FetchError):
            pc.fetch(p, transport, ["a"])
        assert pc.breaker(p).state == OPEN

    def test_deadline_enforced(self):
        pc = ProviderClient(sleep=lambda s: None)
        p = Provider(name="p", url="fake://x", retries=0, timeout_s=0.05)

        def transport(provider, keys):
            time.sleep(1.0)
            return {}

        t0 = time.monotonic()
        with pytest.raises(FetchError, match="deadline"):
            pc.fetch(p, transport, ["a"])
        assert time.monotonic() - t0 < 0.5


# ---------------------------------------------------------------------------
# provider spec


SPEC = {"metadata": {"name": "x"},
        "spec": {"url": "fake://x", "timeout": 2,
                 "failurePolicy": "UseDefault", "default": "ok",
                 "caching": {"ttlSeconds": 5, "maxEntries": 10},
                 "circuitBreaker": {"failureThreshold": 3,
                                    "cooldownSeconds": 7}}}


class TestProviderSpec:
    def test_from_dict_round_trip(self):
        p = Provider.from_dict(SPEC)
        assert p.timeout_s == 2.0 and p.failure_policy == USE_DEFAULT
        assert p.cache_ttl_s == 5.0 and p.breaker_threshold == 3
        assert Provider.from_dict(p.to_dict()) == p
        assert p.to_dict() == j_api.Provider.from_dict(SPEC).to_dict()
        j = j_api.PROVIDER_GVK
        assert (PROVIDER_GVK.group, PROVIDER_GVK.version,
                PROVIDER_GVK.kind) == (j.group, j.version, j.kind)

    @pytest.mark.parametrize("spec", [
        {},
        {"url": "fake://x", "failurePolicy": "Explode"},
        {"url": "fake://x", "timeout": 0},
        {"url": "fake://x", "retries": -1},
    ])
    def test_validation_rejects(self, spec):
        doc = {"metadata": {"name": "x"}, "spec": spec}
        with pytest.raises(ValueError) as te:
            Provider.from_dict(doc)
        with pytest.raises(ValueError) as je:
            j_api.Provider.from_dict(doc)
        assert str(te.value) == str(je.value)

    def test_unknown_scheme_rejected(self, runtime):
        with pytest.raises(ValueError, match="scheme"):
            runtime.register(Provider(name="x", url="gopher://x"))


# ---------------------------------------------------------------------------
# lowering: the key-collection pass, one batched round an audit


def _audit_side(side, images, full=False, limit=None, **kw):
    """A fresh runtime and driver for ``side``, pods of ``images``, one
    audit: (results, fetch rounds, batches, driver)."""
    _rt, fake = _install(side, **kw)
    c, drv = _ext_client(side)
    for i, img in enumerate(images):
        c.add_data(_pod(f"p{i}", img))
    res = _keys(c.audit(limit_per_constraint=limit, full=full).results())
    return res, fake.calls, [sorted(b) for b in fake.batches], drv


class TestLowering:
    def test_ext_template_lowers_with_provider_tag(self):
        tags = {}
        for side in ("torch", "jax"):
            _install(side)
            _c, drv = _ext_client(side)
            compiled = drv._state(TARGET_NAME).templates["K8sExtSig"]
            assert compiled.vectorized is not None
            tags[side] = [(t.src, t.ext_providers)
                          for t in compiled.vectorized.spec.tables
                          if t.ext_providers]
        assert len(tags["torch"]) == 1
        assert tags["torch"][0][1] == ("sig-prov",)
        assert tags["torch"] == tags["jax"]

    @pytest.mark.parametrize("full", [False, True])
    def test_audit_prefetch_is_one_batched_round(self, full):
        """4 rows, 3 distinct keys: ONE batched fetch a sweep on the port
        and on the reference, the same batch; results equal the scalar
        oracle's."""
        images = ["img-a", "img-b", "img-c", "img-a"]
        out = {s: _audit_side(s, images, full=full) for s in SIDES}
        for side in ("torch", "jax"):
            assert out[side][1] == 1
            assert out[side][2] == [["img-a", "img-b", "img-c"]]
        assert out["torch"][0] == out["jax"][0] == out["local"][0]
        assert [r[2] for r in out["torch"][0]] == ["p1"]

    def test_parity_device_gather_vs_scalar_oracle(self):
        images = ["img-a", "img-b", "img-c", "img-a", "img-b"]
        out = {s: _audit_side(s, images) for s in SIDES}
        assert out["torch"][0] == out["jax"][0] == out["local"][0]
        assert len(out["torch"][0]) == 2
        # the device path ran on the port
        assert out["torch"][3].executor.mask_evals > 0

    @pytest.mark.parametrize("full", [False, True])
    def test_sweep_report_carries_provider_stats(self, full):
        """The ``external`` stanza carries the reference's keys on a
        memoized and on a forced full sweep; its counts equal."""
        stanzas = {}
        for side in ("torch", "jax"):
            _res, _calls, _b, drv = _audit_side(
                side, ["img-b"] * 3, full=full, limit=20)
            ext = drv.last_sweep_phases.get("external")
            assert ext is not None
            stats = ext["providers"]["sig-prov"]
            assert stats["breaker_state"] == "closed"
            assert stats["fetch_batches"] >= 1
            assert 0.0 <= stats["cache_hit_ratio"] <= 1.0
            stanzas[side] = ext
        assert _stanza_keys(stanzas["torch"]) == _stanza_keys(stanzas["jax"])
        # the port joins its bulk warm before the report, so the
        # bulk_prefetch numbers are always there (ROADMAP Queue C)
        bulk = stanzas["torch"]["bulk_prefetch"]
        assert bulk["providers"] == 1 and bulk["keys"] == 1
        for key in ("fetch_batches", "fetch_keys", "fetch_errors",
                    "breaker_transitions", "short_circuits"):
            assert stanzas["torch"]["providers"]["sig-prov"][key] == \
                stanzas["jax"]["providers"]["sig-prov"][key]

    def test_memoized_and_full_sweeps_agree_and_fetch_once(self):
        """A cold sweep fetches once; memoized and forced full sweeps
        after it hit the cache (600 s TTL) and return the same results."""
        _rt, fake = _install("torch", cache_ttl_s=600.0)
        c, drv = _ext_client("torch", extra_templates=[
            ("ReqLabel", REQUIRED_LABEL)])
        for i, img in enumerate(["img-a", "img-b", "img-c", "img-b"]):
            c.add_data(_pod(f"p{i}", img))
        cold = _keys(c.audit(limit_per_constraint=20).results())
        assert fake.calls == 1
        memo = _keys(c.audit(limit_per_constraint=20).results())
        full = _keys(c.audit(limit_per_constraint=20, full=True).results())
        assert cold == memo == full
        assert fake.calls == 1
        assert drv.last_sweep_phases["full"] is True
        assert drv.last_sweep_phases["external"]["bulk_prefetch"]["keys"] \
            == 3
        _install("jax", cache_ttl_s=600.0)
        cj, _ = _ext_client("jax", extra_templates=[
            ("ReqLabel", REQUIRED_LABEL)])
        for i, img in enumerate(["img-a", "img-b", "img-c", "img-b"]):
            cj.add_data(_pod(f"p{i}", img))
        assert _keys(cj.audit(limit_per_constraint=20, full=True)
                     .results()) == full

    def test_devpages_falls_back_with_external_providers(self, monkeypatch):
        """Under pages and devpages the external kind is not paged: the
        stanza gives ``external-providers``, as the reference's does, and
        the plain label kind is paged; results equal."""
        monkeypatch.setenv("GATEKEEPER_PAGES", "on")
        monkeypatch.setenv("GATEKEEPER_DEVPAGES", "on")
        out = {}
        for side in ("torch", "jax"):
            _install(side)
            c, drv = _ext_client(side, extra_templates=[
                ("ReqLabel", REQUIRED_LABEL)])
            for i, img in enumerate(["img-a", "img-b", "img-b", "img-c"]):
                c.add_data(_pod(f"p{i}", img))
            res = _keys(c.audit(limit_per_constraint=20).results())
            pages = drv.last_sweep_phases["pages"]
            out[side] = (res, pages["fallback_reasons"],
                         pages["kinds_paged"],
                         _stanza_keys(drv.last_sweep_phases.get("external")))
        assert out["torch"] == out["jax"]
        assert out["torch"][1] == {"K8sExtSig": "external-providers"}
        assert out["torch"][2] == 1


# ---------------------------------------------------------------------------
# failure policies end to end through the webhook


def _review(image):
    return {"uid": "u1",
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "operation": "CREATE", "name": "p",
            "userInfo": {"username": "alice", "groups": []},
            "object": _pod("p", image)}


def _answer(resp):
    st = resp.get("status") or {}
    return resp["allowed"], st.get("code"), st.get("message")


class TestFailurePolicies:
    def _answers(self, images, register=True, outage=False, **kw):
        """Each side's webhook answer for each image, each side on a
        fresh runtime; the three sides' answers equal."""
        out = {}
        for side in SIDES:
            _rt, fake = _install(side, register=register, **kw)
            fake.outage = outage
            handler = PKG[side].Handler(_ext_client(side)[0])
            out[side] = [_answer(handler.handle(_review(img)))
                         for img in images]
        assert out["torch"] == out["jax"] == out["local"]
        return out["torch"]

    def test_invalid_key_denied_403(self):
        (allowed, code, msg), = self._answers(["img-b"])
        assert allowed is False and code == 403
        assert "rejected: invalid" in msg

    def test_fail_policy_denies_500_on_outage(self):
        (allowed, code, msg), = self._answers(["img-a"], outage=True,
                                               policy=FAIL, retries=0)
        assert allowed is False and code == 500
        assert "external_data" in msg

    def test_ignore_policy_admits_on_outage(self):
        (allowed, _code, _msg), = self._answers(["img-b"], outage=True,
                                                 policy=IGNORE, retries=0)
        assert allowed is True

    def test_use_default_substitutes(self):
        a = self._answers(["unknown-img", "img-a"], policy=USE_DEFAULT,
                          default="invalid")
        assert a[0][0] is False and a[0][1] == 403
        assert "rejected: invalid" in a[0][2]
        assert a[1][0] is True

    def test_unknown_provider_is_policy_error(self):
        (allowed, code, msg), = self._answers(["img-a"], register=False)
        assert allowed is False and code == 500
        assert "not registered" in msg

    @pytest.mark.parametrize("side", SIDES)
    def test_batch_prefetch_warms_cache(self, side):
        _rt, fake = _install(side)
        client, _ = _ext_client(side)
        reviews = [_review("img-a"), _review("img-b")]
        client.prefetch_external(reviews)
        if side == "local":
            # the scalar driver has no key-collection pass: its reviews
            # fetch key by key, as the reference's LocalDriver does
            assert fake.calls == 0
            return
        assert fake.calls == 1 and sorted(fake.batches[0]) == \
            ["img-a", "img-b"]
        for rv in reviews:
            client.review(rv)
        assert fake.calls == 1


# ---------------------------------------------------------------------------
# audit outage containment


def _mixed(side, driver=None):
    c, drv = _ext_client(side, driver=driver,
                         extra_templates=[("ReqLabel", REQUIRED_LABEL)])
    for i, img in enumerate(["img-a", "img-b", "img-b"]):
        c.add_data(_pod(f"p{i}", img))
    return c, drv


class TestAuditContainment:
    @pytest.mark.parametrize("full", [False, True])
    def test_ignore_outage_sweep_completes_breaker_opens(self, full):
        out = {}
        for side in SIDES:
            rt, fake = _install(side, retries=0, breaker_threshold=1)
            fake.outage = True
            c, _ = _mixed(side)
            res = _keys(c.audit(full=full).results())
            msgs = [r[0] for r in res]
            assert msgs.count("missing label app") == 3
            assert not any("rejected" in m for m in msgs)
            assert rt.stats()["sig-prov"]["breaker_state"] == "open"
            out[side] = res
        assert out["torch"] == out["jax"] == out["local"]

    @pytest.mark.parametrize("full", [False, True])
    def test_fail_outage_contained_per_kind(self, full):
        out = {}
        for side in ("torch", "jax"):
            _rt, fake = _install(side, policy=FAIL, retries=0,
                                 breaker_threshold=1)
            fake.outage = True
            c, drv = _mixed(side)
            res = _keys(c.audit(full=full).results())     # must not raise
            msgs = [r[0] for r in res]
            assert msgs.count("missing label app") == 3
            assert not any("rejected" in m for m in msgs)
            n = drv.metrics.counter("external_data_kind_failures").value
            assert n >= 1
            out[side] = (res, n, fake.calls)
        assert out["torch"] == out["jax"]

    def test_fail_contained_on_the_scalar_recheck(self):
        """A provider that answers the sweep's prefetch and table builds
        and then fails before the oracle's re-check (its cache dropped by
        a re-registration) fails the kind in phase 2; the other kind's
        results stand."""
        out = {}
        for side in ("torch", "jax"):
            rt, fake = _install(side, policy=FAIL, retries=0)
            c, drv = _mixed(side)
            orig = drv._format_topk

            def format_topk(*a, rt=rt, fake=fake, side=side, orig=orig,
                            **kw):
                if not fake.outage:
                    fake.outage = True
                    rt.register(PKG[side].api.Provider(
                        name="sig-prov", url="fake://sig",
                        failure_policy=FAIL, retries=0))
                return orig(*a, **kw)
            drv._format_topk = format_topk
            res = _keys(c.audit(limit_per_constraint=20, full=True)
                        .results())
            n = drv.metrics.counter("external_data_kind_failures").value
            out[side] = (res, n)
        assert out["torch"] == out["jax"]
        assert out["torch"][1] == 1
        assert [r[0] for r in out["torch"][0]] == ["missing label app"] * 3

    def test_recovery_after_outage(self):
        states = {}
        for side in ("torch", "jax"):
            rt, fake = _install(side, retries=0, breaker_threshold=1,
                                breaker_cooldown_s=0.05, cache_ttl_s=0.0)
            fake.outage = True
            c, _ = _mixed(side)
            c.audit()
            assert rt.stats()["sig-prov"]["breaker_state"] != "closed"
            fake.outage = False
            time.sleep(0.08)
            out = rt.prefetch("sig-prov", ["img-b"])
            assert out["img-b"].value == "invalid"
            states[side] = rt.stats()["sig-prov"]["breaker_state"]
            c.audit()
        assert states == {"torch": "closed", "jax": "closed"}


# ---------------------------------------------------------------------------
# the builtin


class TestBuiltin:
    def test_registered_and_impure(self):
        from gatekeeper_tpu_torch.rego import builtins as bi
        assert ("external_data",) in bi.REGISTRY
        assert ("external_data",) in bi.IMPURE_BUILTINS

    def test_http_send_points_at_external_data(self):
        from gatekeeper_tpu_torch.rego import builtins as bi
        with pytest.raises(bi.BuiltinError, match="external_data"):
            bi.REGISTRY[("http", "send")]()

    def test_probe_lists_external_data(self):
        from gatekeeper_tpu.client.probe import list_builtins as ref_list
        from gatekeeper_tpu_torch.client.probe import list_builtins
        listing = "\n".join(list_builtins())
        assert "external_data" in listing
        assert "UNSUPPORTED" in listing
        assert list_builtins() == ref_list()

    def test_no_runtime_is_builtin_error(self):
        from gatekeeper_tpu_torch.rego import builtins as bi
        from gatekeeper_tpu_torch.rego.values import freeze
        set_runtime(None)
        with pytest.raises(bi.BuiltinError, match="runtime"):
            bi.REGISTRY[("external_data",)](
                freeze({"provider": "p", "keys": ["k"]}))

    def test_fail_policy_raises_external_data_error(self):
        from gatekeeper_tpu_torch.rego import builtins as bi
        from gatekeeper_tpu_torch.rego.values import freeze
        _rt, fake = _install("torch", policy=FAIL, retries=0)
        fake.outage = True
        with pytest.raises(ExternalDataError):
            bi.REGISTRY[("external_data",)](
                freeze({"provider": "sig-prov", "keys": ["k"]}))

    def test_answers_equal_the_reference(self):
        from gatekeeper_tpu.rego import builtins as jbi
        from gatekeeper_tpu.rego.values import freeze as jfreeze
        from gatekeeper_tpu.rego.values import thaw as jthaw
        from gatekeeper_tpu_torch.rego import builtins as tbi
        from gatekeeper_tpu_torch.rego.values import freeze, thaw
        _install("torch", policy=USE_DEFAULT, default="dflt")
        _install("jax", policy=USE_DEFAULT, default="dflt")
        req = {"provider": "sig-prov", "keys": ["img-a", "img-b", "nope"]}
        got = thaw(tbi.REGISTRY[("external_data",)](freeze(req)))
        want = jthaw(jbi.REGISTRY[("external_data",)](jfreeze(req)))
        assert got == want
        assert got["responses"] == {"img-a": "valid", "img-b": "invalid",
                                    "nope": "dflt"}


# ---------------------------------------------------------------------------
# the Provider controller


class TestProviderController:
    def _plane(self):
        from gatekeeper_tpu_torch.cluster.fake import FakeCluster
        from gatekeeper_tpu_torch.controllers.registry import add_to_manager
        cluster = FakeCluster()
        cluster.register_kind(PROVIDER_GVK, "providers")
        client = TBackend(LocalDriver()).new_client([TTarget()])
        rt = ExternalDataRuntime()
        plane = add_to_manager(cluster, client, external_data=rt)
        return cluster, plane, rt

    def test_lifecycle(self):
        cluster, plane, rt = self._plane()
        assert plane.external_data is rt
        obj = Provider(name="sig-prov", url="fake://sig",
                       failure_policy=IGNORE).to_dict()
        cluster.create(obj)
        plane.run_until_idle()
        assert rt.provider("sig-prov").failure_policy == IGNORE
        status = cluster.get(PROVIDER_GVK, "sig-prov")["status"]
        assert status["byPod"] == [{"state": "Active"}]
        obj = cluster.get(PROVIDER_GVK, "sig-prov")
        obj["spec"]["failurePolicy"] = FAIL
        cluster.update(obj)
        plane.run_until_idle()
        assert rt.provider("sig-prov").failure_policy == FAIL
        cluster.delete(PROVIDER_GVK, "sig-prov")
        plane.run_until_idle()
        assert rt.provider("sig-prov") is None

    def test_invalid_spec_recorded_not_registered(self):
        cluster, plane, rt = self._plane()
        cluster.create({
            "apiVersion": "externaldata.gatekeeper.sh/v1beta1",
            "kind": "Provider", "metadata": {"name": "broken"},
            "spec": {"url": "fake://x", "failurePolicy": "Explode"}})
        plane.run_until_idle()
        assert rt.provider("broken") is None
        status = cluster.get(PROVIDER_GVK, "broken").get("status") or {}
        assert status["byPod"][0]["state"] == "Error"
        assert "failurePolicy" in status["byPod"][0]["error"]

    def test_unsupported_scheme_recorded(self):
        cluster, plane, rt = self._plane()
        cluster.create(Provider(name="gopher", url="gopher://x").to_dict())
        plane.run_until_idle()
        assert rt.provider("gopher") is None
        st = cluster.get(PROVIDER_GVK, "gopher")["status"]["byPod"][0]
        assert st["state"] == "Error" and "scheme" in st["error"]


# ---------------------------------------------------------------------------
# what the port adds


def test_slow_provider_drives_deadline_expiry(monkeypatch):
    """GATEKEEPER_FAULT=slow_provider stalls each fetch round for
    GATEKEEPER_FAULT_STALL_S before its transport call: no breaker trip,
    the stall is paid a round, and a deadline-bound caller (the bounded
    wait on another caller's single-flight lease) gives up."""
    monkeypatch.setenv("GATEKEEPER_FAULT", "slow_provider")
    monkeypatch.setenv("GATEKEEPER_FAULT_STALL_S", "0.3")
    assert faults.active("slow_provider")   # the seam is ported now
    rt, fake = _install("torch", timeout_s=0.05, retries=0)
    t0 = time.monotonic()
    out = rt.prefetch("sig-prov", ["img-b"])
    assert time.monotonic() - t0 >= 0.3
    assert out["img-b"].value == "invalid"   # saturated, not broken
    assert rt.stats()["sig-prov"]["breaker_state"] == "closed"
    # a second caller of a key in flight waits at most
    # timeout * (retries + 2) for the stalled leader, then gives up
    rt.register(Provider(name="sig-prov", url="fake://sig", timeout_s=0.05,
                         retries=0, failure_policy=IGNORE))
    lead = threading.Thread(target=rt.prefetch, args=("sig-prov", ["img-a"]))
    lead.start()
    time.sleep(0.05)
    out = rt.prefetch("sig-prov", ["img-a"])
    lead.join()
    assert out["img-a"].error == "single-flight wait expired"
    # a sweep pays the stall once, in its one batched round (a deadline
    # long enough for the table build to wait for the bulk warm)
    rt.register(Provider(name="sig-prov", url="fake://sig", timeout_s=1.0,
                         retries=0, failure_policy=IGNORE))
    c, _ = _ext_client("torch")
    for i, img in enumerate(["img-b", "img-c", "img-b"]):
        c.add_data(_pod(f"q{i}", img))
    calls = fake.calls
    res = _keys(c.audit().results())
    assert fake.calls == calls + 1
    assert [r[2] for r in res] == ["q0", "q2"]


def test_admission_batch_prefetch_is_one_round():
    """The manager's micro-batcher calls the prefetch hook once a batch:
    one provider round for 16 reviews of 6 images, answers equal to the
    per-review scalar answers."""
    from gatekeeper_tpu_torch.webhook.batcher import MicroBatcher
    images = [f"img-{i % 6}" for i in range(16)]
    data = {f"img-{i}": ("invalid" if i % 3 == 0 else "valid")
            for i in range(6)}
    _rt, fake = _install("torch", data=data)
    client, _ = _ext_client("torch")
    reviews = [dict(_review(img), name=f"r{i}")
               for i, img in enumerate(images)]
    b = MicroBatcher(client.review_batch, max_batch=64, max_wait=0.2,
                     prefetch=client.prefetch_external)
    got = [None] * len(reviews)

    def submit(i):
        got[i] = b.submit(reviews[i])
    b.start()
    try:
        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(len(reviews))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        b.stop()
    # one round a batch at most, and every image fetched once: no
    # review fetched key by key
    assert fake.calls <= b.metrics.counter("admission_batches").value
    assert sorted(sum(fake.batches, [])) == sorted(set(images))
    _install("torch", data=data)
    oracle, _ = _ext_client("torch", driver=LocalDriver())
    want = [_keys(oracle.review(rv).results()) for rv in reviews]
    assert [_keys(g.results()) for g in got] == want
    assert sum(len(w) for w in want) == 6


def test_bulk_warm_error_is_raised_by_the_sweep(monkeypatch):
    """An exception on the sweep's bulk-warm thread is raised by the
    sweep, never swallowed; the next sweep runs clean."""
    _install("torch")
    c, drv = _ext_client("torch")
    c.add_data(_pod("p0", "img-b"))
    boom = RuntimeError("bulk warm failed")

    def broken(st, specs):
        raise boom
    monkeypatch.setattr(drv, "_prefetch_external", broken)
    with pytest.raises(RuntimeError, match="bulk warm failed"):
        drv.query_audit(TARGET_NAME, QueryOpts(limit_per_constraint=20))
    monkeypatch.undo()
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    res, _ = drv.query_audit(TARGET_NAME, QueryOpts(limit_per_constraint=20))
    assert [r.msg for r in res] == ["image img-b rejected: invalid"]


def test_no_bulk_warm_without_a_provider_kind(monkeypatch):
    """A sweep with a runtime but no lowered kind reading a provider
    starts no warm thread and reports the providers alone."""
    _install("torch")
    drv = TorchDriver(device="cpu")
    c = TBackend(drv).new_client([TTarget()])
    c.add_template(template_doc("ReqLabel", REQUIRED_LABEL))
    c.add_constraint(constraint_doc("ReqLabel", "c", match=POD_MATCH))
    c.add_data(_pod("p0", "img-a"))
    seen = []
    orig = threading.Thread.start

    def spy(self):
        seen.append(self.name)
        return orig(self)
    monkeypatch.setattr(threading.Thread, "start", spy)
    c.audit()
    monkeypatch.setattr(threading.Thread, "start", orig)
    assert not [n for n in seen if n.startswith("external-prefetch")]
    assert get_runtime() is not None
    ext = drv.last_sweep_phases["external"]
    assert sorted(ext) == ["providers"]


def test_unported_message_is_gone():
    """``external_data`` no longer raises the port's not-yet-ported
    ClientError anywhere on the path."""
    _install("torch")
    c, _ = _ext_client("torch")
    c.add_data(_pod("p0", "img-b"))
    try:
        res = c.audit().results()
    except ClientError as e:                 # pragma: no cover
        pytest.fail(f"raised {e}")
    assert len(res) == 1
