# Copied from gatekeeper_tpu/analysis/transval.py for the PyTorch port.
"""Stage 4: install-time translation validation (Rego ↔ lowered IR).

The lowering contract (ir/lower.py) allows the device mask to
*over*-approximate — fired (constraint, resource) pairs are re-evaluated
on host by the scalar oracle before any message is emitted — but an
*under*-approximation (oracle says violation, device mask silent) is a
silent enforcement hole.  Today that direction is only checked
dynamically (tests/test_fuzz_parity.py).  This module checks it at
install time: enumerate the template's bounded small-model universe
(:mod:`.smallmodel`), evaluate every world through both semantics, and
emit either a :class:`Certificate` (persisted as the fifth snapshot tier
in resilience/snapshot.py, keyed by IR digest, so warm restarts skip
re-validation) or a concrete :class:`Counterexample` (minimal world +
constraint + expected/actual verdicts) that serializes into
``tests/corpus/transval/`` and replays forever as a regression test.

Known, excused deviation: worlds whose numeric bindings are not exactly
float32-representable (``Bindings.f32_unsafe``) — the driver already
routes those kinds to the scalar oracle at serve time, so a
disagreement there is unreachable in production and is counted as
``excused_f32`` rather than refuting the translation.

The port evaluates the lowered side of every world with the evaluator
that serves on the driver's device: K1 (``kernels/ir_eval.eval_mask``,
after K3 for regex tables) over the world's bindings uploaded to the
card, or K1's plain version when the device is the CPU.  The device is
always passed in (``TorchDriver._certify_lowered`` passes its own), so a
certificate certifies the kernel that serves, never its twin.  An error
raised while the device evaluates a world is not an analysis error: it
reaches the caller as :class:`DeviceEvalFailed`, whose ``__cause__`` is
the original exception, and the driver re-raises that.

Modes (``GATEKEEPER_TRANSVAL``): ``off`` (default), ``warn`` (validate,
log, serve on device regardless), ``strict`` (a counterexample pins the
template to the scalar fallback exactly as if it had never lowered, and
the reconciler writes ``translation_unvalidated`` into
``status.byPod[].errors``).
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import os
from typing import Any

import numpy as np

from gatekeeper_tpu_torch.analysis import smallmodel
from gatekeeper_tpu_torch.analysis.smallmodel import derive_plan, enumerate_models
from gatekeeper_tpu_torch.utils.log import logger

log = logger("analysis.transval")

# bump whenever the model universe or checking semantics change: stale
# certificates must not excuse a re-lowered program from re-validation
TRANSVAL_VERSION = "transval-v1"

DEFAULT_BUDGET = 96

# kind -> counterexample summary, for the reconciler's status writer
failures: dict[str, "Counterexample"] = {}

# process-lifetime count of full validations actually executed (memo /
# snapshot hits do not count) — resilience/smoke.py asserts this is 0
# on a warm restart
validations_run = 0

_memo: dict[str, Any] = {}


def mode() -> str:
    return os.environ.get("GATEKEEPER_TRANSVAL", "off").strip().lower()


def model_budget() -> int:
    try:
        return max(4, int(os.environ.get("GATEKEEPER_TRANSVAL_MODELS",
                                         str(DEFAULT_BUDGET))))
    except ValueError:
        return DEFAULT_BUDGET


# ---------------------------------------------------------------------------
# results


@dataclasses.dataclass
class Certificate:
    """Proof token: the lowered program agreed with the interpreter on
    every world of the bounded universe (minus excused f32 worlds)."""

    kind: str
    digest: str
    models_checked: int
    constraints_checked: int
    fp_models: int          # device over-approximations (allowed)
    excused_f32: int
    excused_mixed: int      # mixed-type ordering (lower.py known dev.)
    truncated: bool
    budget: int
    version: str = TRANSVAL_VERSION


@dataclasses.dataclass
class Counterexample:
    """One concrete world refuting the translation: the oracle derives
    a violation the device mask misses (or, in replay, any parity
    break on the recorded world)."""

    kind: str
    target: str
    rego: str
    constraint: dict
    resources: list
    focus: int
    expected: bool
    actual: bool
    note: str = ""

    def to_json(self) -> dict:
        return {"version": TRANSVAL_VERSION, "kind": self.kind,
                "target": self.target, "rego": self.rego,
                "constraint": self.constraint, "resources": self.resources,
                "focus": self.focus, "expected": self.expected,
                "actual": self.actual, "note": self.note}

    @staticmethod
    def from_json(doc: dict) -> "Counterexample":
        return Counterexample(
            kind=doc["kind"], target=doc["target"], rego=doc["rego"],
            constraint=doc["constraint"], resources=doc["resources"],
            focus=doc.get("focus", 0), expected=doc["expected"],
            actual=doc["actual"], note=doc.get("note", ""))


def certificate_digest(lowered, constraints: list[dict],
                       budget: int) -> str:
    """Key of one validation run: the exact program (Program.cache_key
    reprs deterministically — tuples of scalars only, no sets/dicts),
    the constraint docs checked against, and the universe bound."""
    parts = (TRANSVAL_VERSION, repr(lowered.program.cache_key()),
             json.dumps(constraints, sort_keys=True, default=repr),
             str(budget))
    return hashlib.sha256("\x1f".join(parts).encode()).hexdigest()


# ---------------------------------------------------------------------------
# world evaluation: both semantics over one shared world


def _world_state(resources: list):
    """(TargetState, [(row, resource_index)]) with every resource
    upserted — both semantics must see the identical world."""
    from gatekeeper_tpu_torch.client.local_driver import TargetState
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget

    handler = K8sValidationTarget()
    st = TargetState()
    rows: list[tuple[int, int]] = []
    for ri, obj in enumerate(resources):
        key, meta, obj2 = handler.process_data(obj)
        rows.append((st.table.upsert(key, obj2, meta), ri))
    return st, rows, handler


class DeviceEvalFailed(Exception):
    """The device evaluation of a world raised (a kernel launch, an
    upload): its ``__cause__`` is the original exception.  Callers that
    contain analysis errors re-raise the cause instead."""


def _device_mask(lowered, st, constraints: list[dict], device):
    """The lowered program over one world, on ``device``: the world's
    bindings go through a fresh ``ProgramExecutor`` of that device (its
    uploads, K3 for regex tables, then K1; K1's plain version on the
    CPU), one launch for the whole table.  Returns the bool mask trimmed
    to [n_constraints, n_resources] plus the Bindings (for the
    f32_unsafe flag)."""
    from gatekeeper_tpu_torch.engine.executor import ProgramExecutor
    from gatekeeper_tpu_torch.ir.prep import build_bindings

    bindings = build_bindings(lowered.spec, st.table, constraints)
    try:
        mask = ProgramExecutor(device).run(lowered.program, bindings)
    except Exception as e:
        raise DeviceEvalFailed(
            f"world evaluation on {device} failed: {e}") from e
    return np.asarray(mask)[:len(constraints), :len(st.table._objs)], \
        bindings


def _interp_fires(compiled, handler, st, row: int, frozen_c,
                  inv) -> bool:
    """Reference semantics for one (constraint, row): does the oracle
    derive at least one violation Obj carrying a msg?  (regolib
    filters results without msg — local_driver._eval_pair.)"""
    from gatekeeper_tpu_torch.rego.values import Obj, freeze

    meta = st.table.meta_at(row)
    obj = st.table.object_at(row)
    if meta is None:
        return False
    review = handler.make_review(meta, obj)
    input_doc = Obj({"review": freeze(review), "constraint": frozen_c})
    try:
        results = compiled.interp.query_set("violation", input_doc, inv)
    except Exception as e:   # noqa: BLE001 — oracle error == undefined
        log.warning("transval oracle error", kind=compiled.kind, err=str(e))
        return False
    return any(isinstance(v, Obj) and "msg" in v for v in results)


def _has_ordering_cmp(program) -> bool:
    return any(nd.op == "cmp" and nd.meta
               and nd.meta[0] in ("<", "<=", ">", ">=")
               for nd in program.nodes)


def _elements_at(obj, base: tuple) -> list:
    """Element dicts of one axis base path ('*' descends every element
    of the outer list)."""
    cur = [obj]
    for seg in base:
        nxt: list = []
        for c in cur:
            if seg == "*":
                if isinstance(c, list):
                    nxt.extend(c)
            elif isinstance(c, dict) and seg in c:
                nxt.append(c[seg])
        cur = nxt
    out: list = []
    for c in cur:
        if isinstance(c, list):
            out.extend(e for e in c if isinstance(e, dict))
    return out


def _mixed_numeric_world(spec, resources: list) -> bool:
    """Does some num-mode column read a present non-numeric raw value
    (string/null/bool/compound where a number is expected)?  Ordering
    over such values follows OPA's cross-type total order on the oracle
    but is undefined on device — the second documented lowering
    deviation (ir/lower.py:32-34), excused like f32."""
    def mismatched(v) -> bool:
        return v is not smallmodel.ABSENT and (
            isinstance(v, bool) or not isinstance(v, (int, float)))

    for obj in resources:
        for rc in spec.r_cols:
            if rc.mode != "num" or (rc.path and rc.path[0] == "$meta"):
                continue
            cur = obj
            for seg in rc.path:
                cur = (cur.get(seg, smallmodel.ABSENT)
                       if isinstance(cur, dict) else smallmodel.ABSENT)
            if mismatched(cur):
                return True
        for ec in spec.e_cols:
            if ec.mode != "num":
                continue
            for elem in _elements_at(obj, ec.base):
                cur = elem
                for seg in ec.rel:
                    cur = (cur.get(seg, smallmodel.ABSENT)
                           if isinstance(cur, dict) else smallmodel.ABSENT)
                if mismatched(cur):
                    return True
    return False


def _check_world(compiled, lowered, constraints: list[dict],
                 resources: list, device):
    """Evaluate one isolated world through both semantics.

    Returns (status, detail): status 'excused_f32' | 'excused_mixed' |
    'agree' | 'disagree'; detail on disagreement is (constraint_index,
    resource_index, expected, actual) for the first under-approximated
    pair.  Over-approximation is NOT a disagreement (the lowering
    contract allows it; fired pairs re-evaluate on host)."""
    from gatekeeper_tpu_torch.rego.values import freeze

    st, rows, handler = _world_state(resources)
    mask, bindings = _device_mask(lowered, st, constraints, device)
    if bindings.f32_unsafe:
        return "excused_f32", None
    inv = st.inventory_doc() if compiled.uses_inventory else None
    for ci, c in enumerate(constraints):
        fc = freeze(c)
        for row, ri in rows:
            expected = _interp_fires(compiled, handler, st, row, fc, inv)
            actual = bool(mask[ci, row])
            if expected and not actual:
                if (_has_ordering_cmp(lowered.program)
                        and _mixed_numeric_world(lowered.spec, resources)):
                    return "excused_mixed", None
                return "disagree", (ci, ri, expected, actual)
    return "agree", None


# ---------------------------------------------------------------------------
# counterexample minimization


_PROTECTED = {("apiVersion",), ("kind",), ("metadata",),
              ("metadata", "name")}


def _delete_path(obj: dict, path: tuple) -> bool:
    cur = obj
    for seg in path[:-1]:
        cur = cur.get(seg) if isinstance(cur, dict) else None
        if cur is None:
            return False
    if isinstance(cur, dict) and path[-1] in cur:
        del cur[path[-1]]
        return True
    return False


def _all_paths(obj, prefix=()):
    if isinstance(obj, dict):
        for k in sorted(obj, key=repr):
            yield prefix + (k,)
            yield from _all_paths(obj[k], prefix + (k,))


def _get_path(obj, path):
    cur = obj
    for seg in path:
        cur = cur.get(seg) if isinstance(cur, dict) else None
    return cur


def _minimize(compiled, lowered, constraint: dict, resources: list,
              focus: int, device, steps: int = 40) -> list:
    """Greedy shrink: drop object subtrees / truncate lists of the
    focus resource while the under-approximation still reproduces in
    isolation.  Deepest paths first so leaves go before containers."""
    world = copy.deepcopy(resources)

    def still_fails(candidate: list) -> bool:
        status, _ = _check_world(compiled, lowered, [constraint], candidate,
                                 device)
        return status == "disagree"

    for _ in range(steps):
        shrunk = False
        paths = sorted(_all_paths(world[focus]),
                       key=lambda p: (-len(p), p))
        for path in paths:
            if path in _PROTECTED or (path and path[0] == "metadata"
                                      and len(path) == 1):
                continue
            trial = copy.deepcopy(world)
            if not _delete_path(trial[focus], path):
                continue
            if still_fails(trial):
                world = trial
                shrunk = True
                break
        if not shrunk:
            # second pass: shorten lists instead of deleting them
            for path in sorted(_all_paths(world[focus]),
                               key=lambda p: (-len(p), p)):
                v = _get_path(world[focus], path)
                if isinstance(v, list) and len(v) > 1:
                    trial = copy.deepcopy(world)
                    tv = _get_path(trial[focus], path)
                    del tv[1:]
                    if still_fails(trial):
                        world = trial
                        shrunk = True
                        break
            if not shrunk:
                break
    return world


# ---------------------------------------------------------------------------
# the validator


def _bump_numbers(doc):
    if isinstance(doc, bool):
        return doc
    if isinstance(doc, (int, float)):
        return doc + 1
    if isinstance(doc, dict):
        return {k: _bump_numbers(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_bump_numbers(v) for v in doc]
    return doc


def expand_constraints(kind: str, constraints: list[dict] | None) -> list[dict]:
    """The constraint axis of the universe.  Install-time validation
    (reconcile order: templates before constraints) uses the empty
    parameter document — the same stand-in policyset.template_digests
    uses; callers with real sample docs (probe --certify, tests) get a
    numeric-bumped variant appended so param-folded tables/csets are
    exercised at two operating points."""
    if not constraints:
        return [{"kind": kind, "metadata": {"name": "tv-default"},
                 "spec": {"parameters": {}}}]
    out = [copy.deepcopy(c) for c in constraints[:2]]
    for c in list(out):
        params = ((c.get("spec") or {}).get("parameters")) or {}
        if params and len(out) < 3:
            bumped = copy.deepcopy(c)
            bumped.setdefault("metadata", {})
            bumped["metadata"] = dict(bumped["metadata"],
                                      name=(bumped["metadata"].get("name", "c")
                                            + "-bumped"))
            bumped["spec"]["parameters"] = _bump_numbers(params)
            out.append(bumped)
    return out


def validate_template(kind: str, compiled, lowered=None,
                      constraints: list[dict] | None = None,
                      budget: int | None = None, device="cuda"
                      ) -> "Certificate | Counterexample":
    """Run the bounded-model equivalence check for one template.

    `lowered` defaults to compiled.vectorized (tests pass a corrupted
    program explicitly); `constraints` are raw constraint docs (the
    sample axis) — see expand_constraints for the default.  The lowered
    side runs on `device` (the card unless the caller names the CPU)."""
    global validations_run
    lowered = lowered if lowered is not None else compiled.vectorized
    if lowered is None:
        raise ValueError(f"{kind}: nothing to validate (not lowered)")
    budget = budget or model_budget()
    cons = expand_constraints(kind, constraints)
    digest = certificate_digest(lowered, cons, budget)
    validations_run += 1

    plan = derive_plan(lowered, cons, module=compiled.module)
    models = enumerate_models(plan, budget)

    # one shared world: every model's resources co-resident in one
    # table, ONE build_bindings + ONE eager program evaluation.  Sound
    # because both semantics see the identical world — co-residency can
    # only perturb which abstract states get visited, never the
    # per-(constraint, row) comparison itself.
    from gatekeeper_tpu_torch.rego.values import freeze

    all_res: list = []
    owner: list[tuple[int, int]] = []     # flat index -> (model, res idx)
    for mi, m in enumerate(models):
        for ri, obj in enumerate(m.resources):
            all_res.append(obj)
            owner.append((mi, ri))
    st, rows, handler = _world_state(all_res)
    mask, bindings = _device_mask(lowered, st, cons, device)
    batch_f32_unsafe = bindings.f32_unsafe
    inv = st.inventory_doc() if compiled.uses_inventory else None

    fp_models = 0
    excused = 0
    excused_mixed = 0
    frozen = [freeze(c) for c in cons]
    for ci, c in enumerate(cons):
        for flat, (row, _ri) in enumerate(rows):
            expected = _interp_fires(compiled, handler, st, row,
                                     frozen[ci], inv)
            actual = bool(mask[ci, row])
            if expected == actual:
                continue
            if actual and not expected:
                fp_models += 1          # over-approximation: allowed
                continue
            # under-approximation: re-check the owning model isolated —
            # the big-batch table may carry f32-unsafe numerics from
            # *other* models that a production table for this world
            # would not
            mi, _ = owner[flat]
            model = models[mi]
            status, _detail = _check_world(compiled, lowered, [c],
                                           model.resources, device)
            if status == "excused_f32":
                excused += 1
                continue
            if status == "excused_mixed":
                excused_mixed += 1
                continue
            if status == "agree":
                if batch_f32_unsafe:
                    excused += 1        # artifact of co-resident numerics
                    continue
                # cross-world-dependent disagreement (e.g. interner or
                # join effects): report the full world, unminimized
                ce = Counterexample(
                    kind=kind, target=compiled.target, rego=compiled.source,
                    constraint=c, resources=copy.deepcopy(all_res),
                    focus=flat, expected=expected, actual=actual,
                    note=f"batch-context dependent ({model.note})")
                failures[kind] = ce
                return ce
            minimal = _minimize(compiled, lowered, c, model.resources,
                                model.focus if len(model.resources) > 1
                                else 0, device)
            ce = Counterexample(
                kind=kind, target=compiled.target, rego=compiled.source,
                constraint=c, resources=minimal,
                focus=model.focus, expected=expected, actual=actual,
                note=f"model {model.note}")
            failures[kind] = ce
            return ce

    failures.pop(kind, None)
    return Certificate(kind=kind, digest=digest,
                       models_checked=len(models),
                       constraints_checked=len(cons),
                       fp_models=fp_models, excused_f32=excused,
                       excused_mixed=excused_mixed,
                       truncated=plan.truncated, budget=budget)


def certify(kind: str, compiled, lowered,
            constraints: list[dict] | None = None, device="cuda"
            ) -> "Certificate | Counterexample":
    """Memoized/snapshot-backed entry point the engine and probe use;
    a validation runs the lowered side on `device`.

    Certificates persist through the cert snapshot tier so a warm
    restart skips validation entirely (validations_run stays 0);
    counterexamples are memoized in-process only — a cold process
    re-derives them so a fixed lowering is immediately re-admitted."""
    budget = model_budget()
    cons = expand_constraints(kind, constraints)
    digest = certificate_digest(lowered, cons, budget)
    cached = _memo.get(digest)
    if cached is not None:
        if isinstance(cached, Counterexample):
            failures[kind] = cached
        return cached
    from gatekeeper_tpu_torch.resilience import snapshot as _snap

    hit = _snap.load_cert(digest)
    if hit is not None:
        _memo[digest] = hit[0]
        failures.pop(kind, None)
        return hit[0]
    result = validate_template(kind, compiled, lowered=lowered,
                               constraints=cons, budget=budget,
                               device=device)
    _memo[digest] = result
    if isinstance(result, Certificate):
        _snap.save_cert(digest, result)
    return result


def failure_for(kind: str) -> "Counterexample | None":
    return failures.get(kind)


def maybe_miscompiled(kind: str, lowered):
    """Fault-injection seam (GATEKEEPER_TRANSVAL_TEST_MISCOMPILE=<Kind>,
    comma-separable): hand the validator a deliberately corrupted
    program for the named kinds, proving end-to-end that a real
    miscompile would be caught, pinned, and surfaced in status."""
    target = os.environ.get("GATEKEEPER_TRANSVAL_TEST_MISCOMPILE", "")
    if not target:
        return lowered
    if kind in {t.strip() for t in target.split(",") if t.strip()}:
        return miscompile(lowered)
    return lowered


def miscompile(lowered):
    """A minimal deliberate translation bug: flip the first comparison
    (fallback: swap the first and/or).  Used by the fixture tests and
    the GATEKEEPER_TRANSVAL_TEST_MISCOMPILE hook."""
    import dataclasses as dc

    from gatekeeper_tpu_torch.ir.program import Program

    flip_cmp = {"==": "!=", "!=": "==", "<": ">=", "<=": ">",
                ">": "<=", ">=": "<"}
    nodes = list(lowered.program.nodes)
    for i, nd in enumerate(nodes):
        if nd.op == "cmp":
            nodes[i] = dc.replace(nd, meta=(flip_cmp[nd.meta[0]],))
            break
        if nd.op in ("and", "or"):
            nodes[i] = dc.replace(nd, op="or" if nd.op == "and" else "and")
            break
    else:
        raise ValueError("no miscompilable node in program")
    program = Program(nodes=tuple(nodes), rules=lowered.program.rules)
    return dc.replace(lowered, program=program)


# ---------------------------------------------------------------------------
# counterexample corpus (tests/corpus/transval/)


def save_counterexample(dirpath: str, ce: Counterexample) -> str:
    os.makedirs(dirpath, exist_ok=True)
    doc = ce.to_json()
    tag = hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()[:10]
    path = os.path.join(dirpath, f"{ce.kind.lower()}-{tag}.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_corpus(dirpath: str) -> list[tuple[str, dict]]:
    if not os.path.isdir(dirpath):
        return []
    out = []
    for name in sorted(os.listdir(dirpath)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(dirpath, name)) as f:
            out.append((name, json.load(f)))
    return out


def replay_case(case: dict, lowered=None, device="cuda") -> str | None:
    """Replay one corpus case against the CURRENT compiler.  Returns
    None when parity holds on the recorded world (the historical bug
    stays fixed), else a description of the surviving violation.
    `lowered` overrides the freshly-lowered program (fixture tests
    replay against a known-corrupted program to prove the case bites);
    the lowered side runs on `device`."""
    from gatekeeper_tpu_torch.api.templates import compile_target_rego
    from gatekeeper_tpu_torch.ir.lower import CannotLower, lower_template

    compiled = compile_target_rego(case["kind"], case["target"],
                                   case["rego"])
    if lowered is None:
        try:
            lowered = lower_template(compiled.module, compiled.interp)
        except CannotLower:
            return None   # no device program: nothing to miscompile
    status, detail = _check_world(compiled, lowered, [case["constraint"]],
                                  case["resources"], device)
    if status == "disagree":
        ci, ri, expected, actual = detail
        return (f"{case['kind']}: under-approximation replayed on "
                f"resource {ri} (expected={expected} actual={actual})")
    return None
