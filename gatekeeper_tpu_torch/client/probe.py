# Copied from gatekeeper_tpu/client/probe.py for the PyTorch port.
"""Self-test probe: run the conformance scenario table against a live
driver.

Native port of the constraint framework's Probe
(vendor/.../constraint/pkg/client/probe_client.go:10-50): wrap a
Driver in a fresh Backend/Client over the built-in probe target and
expose each e2e scenario (e2e_tests.go) as a runnable check.  The
framework ships this so an embedding application can self-validate an
engine at startup/readiness; a failure message carries the engine
dump, exactly like the Go (`probe_client.go:42-46`).

The scenario semantics are the same table
tests/test_torch_conformance.py pins in CI; the probe is the
runtime-callable twin.

The port carries the probe's engine half: the scenarios on the
``local`` and ``torch`` drivers (``main``, on the card unless
``--device cpu``), ``--builtins``, ``--lint`` (with ``--strict`` and
the scalar-fallback pins of library/lowering_buckets.json) and
``--cost`` (a forced full sweep on a ``TorchDriver``).  The other
subcommands need layers the port has not got yet and raise
``ClientError`` naming their ROADMAP item (``UNPORTED``).
"""

from __future__ import annotations

from typing import Callable

from gatekeeper_tpu_torch.client.targets import TargetHandler, UnhandledData
from gatekeeper_tpu_torch.client.types import Result
from gatekeeper_tpu_torch.store.table import ResourceMeta


class ProbeTarget(TargetHandler):
    """The probe's target handler — a native transcription of the
    framework's test handler (vendor/.../client/test_handler.go:14-119):
    data keyed by Name, constraints match when their kind equals the
    review's ForConstraint, autoreject when a constraint carries a
    namespaceSelector while no v1/Namespace is cached."""

    name = "probe.target"

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


_DENY_ALL = """package foo
violation[{"msg": "DENIED", "details": {}}] {
	"always" == "always"
}"""


def _template(kind: str = "Foo") -> dict:
    return {"apiVersion": "templates.gatekeeper.sh/v1alpha1",
            "kind": "ConstraintTemplate",
            "metadata": {"name": kind.lower()},
            "spec": {"crd": {"spec": {"names": {"kind": kind}}},
                     "targets": [{"target": ProbeTarget.name,
                                  "rego": _DENY_ALL}]}}


def _constraint(kind: str = "Foo", name: str = "ph",
                match: dict | None = None) -> dict:
    spec: dict = {}
    if match is not None:
        spec["match"] = match
    return {"apiVersion": "constraints.gatekeeper.sh/v1alpha1",
            "kind": kind, "metadata": {"name": name}, "spec": spec}


def _data(name: str) -> dict:
    return {"Name": name, "ForConstraint": "Foo"}


class ProbeError(Exception):
    pass


def _want(cond: bool, msg: str, rsps) -> None:
    if not cond:
        raise ProbeError(f"{msg}: {rsps!r}")


# --- the scenario table (e2e_tests.go:65-540, same names) -------------

def _add_template(c):
    c.add_template(_template())


def _deny_all(c):
    c.add_template(_template())
    c.add_constraint(_constraint())
    rsps = c.review(_data("Sara"))
    res = rsps.results()
    _want(len(res) == 1 and res[0].msg == "DENIED", "deny all", rsps)


def _deny_all_audit(c, n: int = 1):
    c.add_template(_template())
    c.add_constraint(_constraint())
    for i in range(n):
        c.add_data(_data(f"obj{i}"))
    rsps = c.audit()
    res = rsps.results()
    _want(len(res) == n and all(r.msg == "DENIED" for r in res),
          f"audit x{n}", rsps)


def _autoreject_all(c):
    # e2e_tests.go:183-246: the rejectable constraint yields BOTH the
    # REJECTION and its normal evaluation result (2 results total)
    c.add_template(_template())
    c.add_constraint(_constraint(match={"namespaceSelector": {
        "matchLabels": {"hi": "there"}}}))
    rsps = c.review(_data("Sara"))
    msgs = sorted(str(r.msg) for r in rsps.results())
    _want(len(msgs) == 2 and "REJECTION" in msgs, "autoreject", rsps)


def _remove_data(c):
    c.add_template(_template())
    c.add_constraint(_constraint())
    c.add_data(_data("Sara"))
    c.add_data(_data("Max"))
    _want(len(c.audit().results()) == 2, "pre-remove audit", None)
    c.remove_data(_data("Max"))
    rsps = c.audit()
    _want(len(rsps.results()) == 1, "post-remove audit", rsps)


def _remove_constraint(c):
    c.add_template(_template())
    c.add_constraint(_constraint())
    c.add_data(_data("Sara"))
    _want(len(c.audit().results()) == 1, "pre-remove audit", None)
    c.remove_constraint(_constraint())
    rsps = c.audit()
    _want(len(rsps.results()) == 0, "post-remove audit", rsps)


def _remove_template(c):
    c.add_template(_template())
    c.add_constraint(_constraint())
    c.add_data(_data("Sara"))
    c.remove_template(_template())
    rsps = c.audit()
    _want(len(rsps.results()) == 0, "post-remove-template audit", rsps)


def _tracing(c, on: bool):
    c.add_template(_template())
    c.add_constraint(_constraint())
    rsps = c.review(_data("Sara"), tracing=on)
    for resp in rsps.by_target.values():
        if on:
            _want(resp.trace is not None, "trace expected", rsps)
        else:
            _want(resp.trace is None, "no trace expected", rsps)


def _audit_tracing(c, on: bool):
    c.add_template(_template())
    c.add_constraint(_constraint())
    c.add_data(_data("Sara"))
    rsps = c.audit(tracing=on)
    for resp in rsps.by_target.values():
        if on:
            _want(resp.trace is not None, "audit trace expected", rsps)
        else:
            _want(resp.trace is None, "no audit trace expected", rsps)


SCENARIOS: dict[str, Callable] = {
    "Add Template": _add_template,
    "Deny All": _deny_all,
    "Deny All Audit": lambda c: _deny_all_audit(c, 1),
    "Deny All Audit x2": lambda c: _deny_all_audit(c, 2),
    "Autoreject All": _autoreject_all,
    "Remove Data": _remove_data,
    "Remove Constraint": _remove_constraint,
    "Remove Template": _remove_template,
    "Tracing Off": lambda c: _tracing(c, False),
    "Tracing On": lambda c: _tracing(c, True),
    "Audit Tracing Enabled": lambda c: _audit_tracing(c, True),
    "Audit Tracing Disabled": lambda c: _audit_tracing(c, False),
}


class Probe:
    """probe_client.go Probe: a client over the probe target, exposing
    each scenario as a zero-arg callable returning None or raising
    ProbeError with the engine dump appended."""

    def __init__(self, driver):
        from gatekeeper_tpu_torch.client.client import Backend
        # a FRESH driver only (the Go Probe likewise constructs its own
        # Backend): registering the probe target on a driver that is
        # already serving a client would clobber that client's target
        # registry — the exact hazard the one-client-per-backend guard
        # exists to prevent
        if getattr(driver, "targets", None):
            raise ValueError(
                "Probe requires a fresh driver; this one already serves "
                f"targets {sorted(driver.targets)} — construct a new "
                "driver instance for the probe")
        self.client = Backend(driver).new_client([ProbeTarget()])

    def test_funcs(self) -> dict[str, Callable[[], None]]:
        return {name: self._run_test(name) for name in SCENARIOS}

    def _run_test(self, name: str) -> Callable[[], None]:
        def run() -> None:
            self.client.reset()
            try:
                SCENARIOS[name](self.client)
            except Exception as e:
                try:
                    dump = self.client.dump()
                except Exception as e2:     # noqa: BLE001
                    dump = str(e2)
                raise ProbeError(
                    f"Error: {e}\n\nEngine dump: {dump}") from e
        return run


def list_builtins() -> list[str]:
    """``--builtins``: one line per registered Rego builtin, dotted
    name sorted, with unsupported stubs marked and their recorded
    reason shown (the `_unsupported` factory tags its stubs).  The
    sanctioned-egress pointer lives here too: readers checking why
    http.send is refused find external_data in the same listing."""
    from gatekeeper_tpu_torch.rego import builtins as bi
    lines = []
    for name in sorted(bi.REGISTRY):
        dotted = ".".join(name)
        fn = bi.REGISTRY[name]
        reason = getattr(fn, "unsupported_reason", None)
        if reason is not None:
            lines.append(f"  {dotted:36s} UNSUPPORTED: {reason}")
        elif name == ("external_data",):
            lines.append(f"  {dotted:36s} provider lookups (batched, "
                         "TTL-cached, circuit-broken; see Provider CRs)")
        else:
            lines.append(f"  {dotted}")
    return lines


def lint_template_doc(doc: dict, file: str = "") -> list:
    """Run both static-analysis stages over one ConstraintTemplate doc
    (gatekeeper_tpu_torch/analysis): the Stage-1 AST vet, then an attempted
    lowering with Stage-2 IR verification.  A template the vectorizer
    cannot lower is a warning (``rego_not_vectorizable``): it still
    evaluates on the scalar oracle, just not on the device path.
    Providers come from the live ExternalDataRuntime when one exists;
    otherwise provider references are not checked (same contract as
    Client ingestion)."""
    from gatekeeper_tpu_torch.analysis import vet_module, verify_program
    from gatekeeper_tpu_torch.analysis.diagnostics import WARNING, Diagnostic
    from gatekeeper_tpu_torch.api.templates import compile_target_rego
    from gatekeeper_tpu_torch.errors import Location, RegoError
    from gatekeeper_tpu_torch.externaldata.runtime import get_runtime
    from gatekeeper_tpu_torch.ir.lower import CannotLower, lower_template

    rt = get_runtime()
    providers = set(rt.provider_names()) if rt is not None else None
    kind = ((((doc.get("spec") or {}).get("crd") or {}).get("spec") or {})
            .get("names") or {}).get("kind") or \
        (doc.get("metadata") or {}).get("name") or "<template>"
    label = file or kind
    diags = []
    for tt in ((doc.get("spec") or {}).get("targets") or ()):
        try:
            compiled = compile_target_rego(kind, tt.get("target") or "",
                                           tt.get("rego") or "")
        except RegoError as err:
            loc = err.location
            diags.append(Diagnostic(err.code, "error", err.message,
                                    Location(loc.row, loc.col, label)))
            continue
        diags.extend(vet_module(compiled.module, providers=providers,
                                file=label))
        try:
            lowered = lower_template(compiled.module, compiled.interp)
        except CannotLower as e:
            diags.append(Diagnostic(
                "rego_not_vectorizable", WARNING,
                f"template does not lower to a device program ({e}); "
                "it will evaluate on the scalar oracle",
                Location(file=label)))
            continue
        diags.extend(verify_program(lowered, providers=providers,
                                    file=label))
    return diags


def _doc_kind(doc: dict) -> str:
    return ((((doc.get("spec") or {}).get("crd") or {}).get("spec") or {})
            .get("names") or {}).get("kind") or \
        (doc.get("metadata") or {}).get("name") or "<template>"


def _scalar_fallback_pins() -> set:
    """Template kinds pinned ``scalar-fallback`` in
    library/lowering_buckets.json — the acknowledgment record a strict
    lint honors: a pinned kind's ``rego_not_vectorizable`` warning is
    expected, not a regression (keys are ``Kind`` or ``Kind (path)``)."""
    import json as _json
    import os as _os
    path = _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), "library", "lowering_buckets.json")
    try:
        with open(path, encoding="utf-8") as fh:
            data = _json.load(fh)
    except (OSError, ValueError):
        return set()
    return {k.split(" (")[0] for k, v in data.items()
            if isinstance(v, str) and v.startswith("scalar-fallback")}


def _severity_rc(n_err: int, n_warn: int) -> int:
    """The analysis-subcommand exit contract, shared by --lint /
    --policyset / --cost / --certify: 0 clean, 1 warning-severity
    findings only, 2 any error-severity finding (or unreadable
    input)."""
    return 2 if n_err else (1 if n_warn else 0)


def run_lint(paths: list[str], use_library: bool = False,
             strict: bool = False) -> int:
    """``--lint``: print diagnostics with locations.  Exit contract
    (:func:`_severity_rc`): 2 on any error-severity finding or
    unreadable input, 1 on warnings-that-matter (``--strict``
    escalates warnings, except a pinned kind's
    ``rego_not_vectorizable`` — see :func:`_scalar_fallback_pins`),
    0 clean."""
    import yaml
    docs: list[tuple[str, dict]] = []
    for p in paths:
        try:
            with open(p, encoding="utf-8") as fh:
                loaded = list(yaml.safe_load_all(fh))
        except (OSError, yaml.YAMLError) as e:
            import sys
            print(f"{p}: cannot load: {e}", file=sys.stderr)
            return 2
        docs.extend((p, d) for d in loaded
                    if isinstance(d, dict)
                    and d.get("kind") == "ConstraintTemplate")
    if use_library:
        from gatekeeper_tpu_torch.library import all_docs
        docs.extend(("<library>", tdoc) for tdoc, _c in all_docs())
    pins = _scalar_fallback_pins() if strict else set()
    n_err = 0
    n_warn = 0
    for label, doc in docs:
        kind = _doc_kind(doc)
        for d in lint_template_doc(doc, file=label):
            print(d.format())
            if d.severity == "error":
                n_err += 1
            elif strict and not (d.code == "rego_not_vectorizable"
                                 and kind in pins):
                n_warn += 1
    tail = f", {n_warn} unpinned warning(s)" if strict else ""
    print(f"lint: {len(docs)} template(s), {n_err} error(s){tail}")
    return _severity_rc(n_err, n_warn)


def _library_entries() -> list:
    """(kind, LoweredProgram | None, [example constraint doc]) per
    built-in library template — the policy set the --policyset/--cost
    reports analyze."""
    from gatekeeper_tpu_torch.api.templates import compile_target_rego
    from gatekeeper_tpu_torch.ir.lower import CannotLower, lower_template
    from gatekeeper_tpu_torch.library import all_docs
    entries = []
    for tdoc, cdoc in all_docs():
        kind = _doc_kind(tdoc)
        lowered = None
        for tt in ((tdoc.get("spec") or {}).get("targets") or ()):
            try:
                compiled = compile_target_rego(
                    kind, tt.get("target") or "", tt.get("rego") or "")
                lowered = lower_template(compiled.module, compiled.interp)
            except (CannotLower, Exception):    # noqa: B014
                lowered = None
            break
        entries.append((kind, lowered, [cdoc]))
    return entries


def run_cost(device=None) -> int:
    """``--cost``: predicted-vs-measured static cost over the built-in
    library.  Builds a GATEKEEPER_COST_PROBE_N-row mixed workload (one
    constraint per template) on a ``TorchDriver`` on ``device`` (the
    card by default), runs one warm forced full sweep for the measured
    ``device_s``, fits the seconds-per-unit scale (costmodel.calibrate),
    and reports the per-template predicted seconds that scale
    implies."""
    import os as _os
    import random
    from gatekeeper_tpu_torch.analysis import costmodel
    from gatekeeper_tpu_torch.client.client import Backend
    import gatekeeper_tpu_torch.engine.torch_driver as td_mod
    from gatekeeper_tpu_torch.library import all_docs, make_mixed
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget

    n = int(_os.environ.get("GATEKEEPER_COST_PROBE_N", "2000"))
    entries = _library_entries()
    units = {kind: costmodel.estimate(low, n, 1).units()
             for kind, low, _c in entries if low is not None}
    total_units = sum(units.values())
    td = td_mod.TorchDriver(device=device)
    c = Backend(td).new_client([K8sValidationTarget()])
    for tdoc, cdoc in all_docs():
        c.add_template(tdoc)
        c.add_constraint(cdoc)
    c.add_data_batch(make_mixed(random.Random(7), n))
    measured = None
    if not td.scalar_only:
        saved = td_mod.SMALL_WORKLOAD_EVALS
        td_mod.SMALL_WORKLOAD_EVALS = 0
        try:
            c.audit(limit_per_constraint=20, full=True)   # compile warm
            c.audit(limit_per_constraint=20, full=True)
        finally:
            td_mod.SMALL_WORKLOAD_EVALS = saved
        measured = (td.last_sweep_phases or {}).get("device_s")
    # the exit contract's warning tier: templates over the configured
    # install-time unit budget (the same knob the reconciler gate uses)
    budget_env = _os.environ.get("GATEKEEPER_COST_BUDGET_UNITS")
    n_over = 0
    if budget_env:
        try:
            budget_units = float(budget_env)
        except ValueError:
            budget_units = None
        if budget_units is not None:
            for kind, u in sorted(units.items()):
                if u > budget_units:
                    n_over += 1
                    print(f"  over-budget {kind}: {u:.3g} units "
                          f"> {budget_units:.3g}")
    if measured is None or total_units <= 0:
        print(f"cost: {len(units)} lowered template(s), "
              f"{total_units:.3g} units at n={n}; no device measurement "
              "(scalar-only backend)")
        return _severity_rc(0, n_over)
    scale = costmodel.calibrate([(total_units, measured)])
    for kind in sorted(units, key=lambda k: -units[k]):
        pred = costmodel.predict_seconds(units[kind], scale)
        print(f"  {kind}: {units[kind]:.3g} units -> "
              f"predicted {pred * 1e3:.3f} ms")
    total_s = costmodel.predict_seconds(total_units, scale)
    print(f"cost: n={n}, measured device_s={measured:.4f}, "
          f"predicted total={total_s:.4f} "
          f"(scale={scale:.3e} s/unit, {len(units)} templates)")
    return _severity_rc(0, n_over)


UNPORTED = {
    "--policyset": "ROADMAP A6, the policy-set dedup plan",
    "--footprint": "ROADMAP A8, the footprint validator's worlds",
    "--certify": "ROADMAP A8, translation validation",
    "--health": "ROADMAP A8, the backend supervisor",
    "--trace": "ROADMAP A8",
    "--pages": "ROADMAP A8",
    "--compilesurface": "ROADMAP A8, the compile-surface certifier",
    "--memsurface": "ROADMAP A8",
    "--whatif": "ROADMAP A7, what-if",
    "--rollout": "ROADMAP A7, rollout",
    "--shardplan": "ROADMAP A10, the simulated mesh",
}
"""The reference's subcommands the port has not got, each with the item
that brings it: asking for one raises ``ClientError`` naming it."""


def _refuse(flag: str):
    from gatekeeper_tpu_torch.errors import ClientError
    raise ClientError(f"{flag}: not yet ported to gatekeeper_tpu_torch "
                      f"({UNPORTED[flag]})")


def _run_subcommand(argv: list[str], device=None) -> int | None:
    """One dispatcher for every analysis subcommand: flag matching,
    ``--library``/``--strict`` extraction and positional (yaml path)
    splitting live here; the shared 0/1/2 exit contract is
    :func:`_severity_rc` inside each runner.  Returns None when no
    analysis flag is present (the caller falls through to the engine
    probe)."""
    for flag in UNPORTED:
        if flag in argv:
            _refuse(flag)
    use_library = "--library" in argv
    strict = "--strict" in argv
    pos = [a for a in argv if a not in ("--library", "--strict")]
    table = (
        ("--cost", lambda rest: run_cost(device)),
        ("--lint", lambda rest: run_lint(
            rest, use_library=use_library, strict=strict)),
    )
    for flag, fn in table:
        if flag in argv:
            return fn([a for a in pos if a != flag])
    return None


def _split_device(argv: list[str]) -> tuple[list[str], str | None]:
    """``--device DEV`` out of argv: the driver's device (the card when
    absent, as cmd/manager does)."""
    argv = list(argv)
    if "--device" not in argv:
        return argv, None
    i = argv.index("--device")
    if i + 1 >= len(argv):
        raise SystemExit("--device needs a value (cuda, cpu, ...)")
    device = argv[i + 1]
    del argv[i:i + 2]
    return argv, device


def main(argv=None) -> int:
    """``python -m gatekeeper_tpu_torch.client.probe``: self-validate
    both engines, the scalar ``local`` driver and ``TorchDriver`` (the
    readiness wiring the reference's Probe exists for).  The
    ``TorchDriver`` runs on the card unless ``--device cpu`` is passed;
    without a card it cannot be built, and the verdict says so.
    ``--builtins`` lists the builtin registry instead of probing;
    ``--lint <template.yaml>... [--library] [--strict]`` runs the
    static-analysis pass and ``--cost`` the cost model against a
    measured sweep; analysis subcommands share one exit contract: 0
    clean, 1 warnings only, 2 any error-severity finding or unreadable
    input.

    The verdict line names the device that served the [torch]
    scenarios, or ``unavailable`` when the driver could not be built
    (no scenario ran on it)."""
    import sys

    argv = sys.argv[1:] if argv is None else argv
    argv, device = _split_device(argv)
    if "--builtins" in argv:
        print("\n".join(list_builtins()))
        return 0
    rc = _run_subcommand(argv, device)
    if rc is not None:
        return rc

    from gatekeeper_tpu_torch.client.local_driver import LocalDriver
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    failures = 0
    backend = "unavailable"
    for label, make in (("local", LocalDriver),
                        ("torch", lambda: TorchDriver(device=device))):
        try:
            probe = Probe(make())
        except Exception as e:      # noqa: BLE001 — a readiness probe
            failures += 1           # must render a verdict, not a trace
            print(f"  FAIL [{label}] <driver construction>: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            continue
        if label == "torch":
            backend = str(probe.client.driver.device)
        for name, fn in probe.test_funcs().items():
            try:
                fn()
                print(f"  ok   [{label}] {name}")
            except Exception as e:  # noqa: BLE001 — incl. ProbeError
                failures += 1
                print(f"  FAIL [{label}] {name}: "
                      f"{str(e).splitlines()[0]}", file=sys.stderr)
    print(("PROBE FAIL" if failures else "PROBE PASS")
          + f" (torch engine served by: {backend})")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
