# Copied from gatekeeper_tpu/analysis/policyset.py for the PyTorch port.
"""Stage 3, part 2: whole-policy-set analysis.

Stages 1 and 2 vet one template in isolation; this module reasons over
the *set* of installed policies:

- **Cross-template predicate digests** — conjunct subtrees of lowered
  programs are canonically hashed (:func:`canonical_conjuncts`): input
  leaves normalize to their prep-request identity (resource path +
  extraction mode, not the per-template serial name) and per-constraint
  scalars backed by a value that is uniform across the kind's
  constraints (string literals lower this way — ir/lower._as_id) fold
  to the resolved constant.  Subtrees appearing under more than one
  template therefore collide — e.g. the ``input.review.object.kind ==
  "Pod"`` gate most library templates open with — and the template
  reconciler reports them (``set_duplicate_predicate``).

- **Match shadowing / unreachability** — the match-criteria semantics
  of engine/match.py lifted to a static subsumption order:
  constraint B is *shadowed* when an installed A of the same kind with
  JSON-equal parameters matches a superset of B's objects at
  equal-or-stricter enforcement, and *unreachable* when its match
  criteria statically match nothing (non-list/empty ``kinds``, empty
  ``namespaces``).

- **Cost-budget admission** — every template is priced by the static
  cost model (:mod:`.costmodel`) at reference scale and gated on
  ``GATEKEEPER_COST_BUDGET=warn|strict|off``.

All findings are :class:`.diagnostics.Diagnostic` records in the
``cost_*`` / ``set_*`` families so the reconcilers forward them into
``status.byPod[]`` unchanged.  Upstream Gatekeeper has no equivalent
pass — see BASELINE.md.

Only the install-time half is part of the port: the reconcilers'
findings above.  The dedup plan that rewrites member programs to read a
shared predicate once per sweep (``build_dedup_plan``,
``eval_shared_host``), the what-if shadow-kind helpers and the whole-set
report wait for ROADMAP A6 and A7; until then the port's sweep
evaluates a shared predicate once per member kind.
"""

from __future__ import annotations

import hashlib
import json

from gatekeeper_tpu_torch.analysis import costmodel
from gatekeeper_tpu_torch.analysis.diagnostics import (
    ERROR, WARNING, Diagnostic,
)
from gatekeeper_tpu_torch.errors import Location
from gatekeeper_tpu_torch.ir.program import Node, Program

# ---------------------------------------------------------------------------
# canonical conjunct hashing


class _Unshareable(Exception):
    """Subtree cannot be proven identical across templates."""


# ops whose semantics are closed over canonicalized inputs; everything
# else (ptable_*, in_cset, cset_*_memb, elem_keys_missing, keyed_val)
# is inherently per-constraint-parameter and never shared
_SHAREABLE_OPS = frozenset({
    "const", "input", "table", "dfa_match", "cmp", "and", "or", "not",
    "arith", "any_e", "all_e", "count_e",
})

_SIMPLE_SCALARS = (str, int, float, bool, bytes, type(None))


def _stable_repr(v) -> str:
    """repr() with container contents in sorted order.  Canonical
    digests feed sha1 — a frozenset-valued cval (encoded membership
    set) must hash identically under every PYTHONHASHSEED, but
    ``repr(frozenset(...))`` follows hash-table order."""
    if isinstance(v, (set, frozenset)):
        return "{" + ", ".join(sorted(_stable_repr(x) for x in v)) + "}"
    if isinstance(v, dict):
        items = sorted((_stable_repr(k), _stable_repr(x))
                       for k, x in v.items())
        return "{" + ", ".join(f"{k}: {x}" for k, x in items) + "}"
    if isinstance(v, tuple):
        return "(" + ", ".join(_stable_repr(x) for x in v) + ",)"
    if isinstance(v, list):
        return "[" + ", ".join(_stable_repr(x) for x in v) + "]"
    return repr(v)


def _fn_fingerprint(fn) -> tuple | None:
    """Structural identity of a host-table fn: code object + closure
    cells + defaults, admitted only when every captured value is a
    simple scalar or a named callable.  None = not provable equal."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return None

    def _cell(v):
        if isinstance(v, _SIMPLE_SCALARS):
            return ("v", type(v).__name__, repr(v))
        if callable(v) and getattr(v, "__qualname__", None):
            return ("f", getattr(v, "__module__", ""), v.__qualname__)
        raise _Unshareable()

    try:
        cells = tuple(_cell(c.cell_contents)
                      for c in (fn.__closure__ or ()))
        defaults = tuple(_cell(v) for v in (fn.__defaults__ or ()))
    except (_Unshareable, ValueError):
        return None
    return (code.co_filename, code.co_firstlineno, code.co_code.hex(),
            cells, defaults)


def _spec_maps(spec) -> dict:
    return {
        "r": {rc.name: rc for rc in spec.r_cols},
        "e": {ec.name: ec for ec in spec.e_cols},
        "cv": {cv.name: cv for cv in spec.cvals},
        "t": {t.name: t for t in spec.tables},
        "d": {d.name: d for d in getattr(spec, "dfas", ())},
        "ij": {ij.name: ij for ij in spec.inv_joins},
    }


class _Canon:
    """Canonicalizer for one kind's program: node index -> (form,
    r-dependent, unreduced element axes, compute-node count)."""

    def __init__(self, program: Program, spec, constraints: list[dict]):
        self.p = program
        self.maps = _spec_maps(spec)
        self.constraints = constraints
        self.cache: dict[int, tuple] = {}

    def node(self, i: int) -> tuple:
        hit = self.cache.get(i)
        if hit is None:
            hit = self._canon(self.p.nodes[i])
            self.cache[i] = hit
        return hit

    def _uniform_cval(self, name: str) -> tuple:
        """Fold a per-constraint scalar whose resolved value is the
        same for every constraint of the kind (string/encoded literals
        always are — the same literal resolves identically under every
        constraint) into a canonical constant."""
        cv = self.maps["cv"].get(name)
        if cv is None or not self.constraints:
            raise _Unshareable()
        try:
            vals = [cv.fn(c) for c in self.constraints]
        except Exception:
            raise _Unshareable() from None
        v0 = vals[0]
        if v0 is None or any(type(v) is not type(v0) or v != v0
                             for v in vals[1:]):
            raise _Unshareable()
        return ("cconst", cv.kind, _stable_repr(v0))

    def _canon(self, n: Node) -> tuple:
        op = n.op
        if op not in _SHAREABLE_OPS:
            raise _Unshareable()
        if op == "const":
            value, dtype = n.meta
            return (("const", _stable_repr(value), dtype), False,
                    frozenset(), 0)
        if op == "input":
            name, kind = n.meta
            axis_char = kind[0]
            if axis_char == "r":
                rc = self.maps["r"].get(name)
                if rc is not None:
                    return (("rcol", rc.path, rc.mode), True,
                            frozenset(), 0)
                ij = self.maps["ij"].get(name)
                if ij is not None:
                    return (("ij", ij.kind, ij.inv_path, ij.src_path,
                             ij.exclude_same_name, ij.namespaced_only),
                            True, frozenset(), 0)
                raise _Unshareable()
            if axis_char == "e":
                ec = self.maps["e"].get(name)
                if ec is None:
                    raise _Unshareable()
                return (("ecol", ec.axis, ec.rel, ec.mode), True,
                        frozenset({ec.axis}), 0)
            return (self._uniform_cval(name), False, frozenset(), 0)
        arg = [self.node(a) for a in n.args]
        r = any(a[1] for a in arg)
        eaxes = frozenset().union(*(a[2] for a in arg)) if arg \
            else frozenset()
        compute = 1 + sum(a[3] for a in arg)
        forms = tuple(a[0] for a in arg)
        if op == "table":
            t = self.maps["t"].get(n.meta[0])
            if t is None or t.ext_providers:
                # provider-backed tables can observe breaker/cache state
                # that shifts between member binding builds mid-sweep
                raise _Unshareable()
            fp = _fn_fingerprint(t.fn)
            if fp is None:
                raise _Unshareable()
            form = ("table", forms[0], t.out, t.src_val, t.regex, fp)
        elif op == "dfa_match":
            d = self.maps["d"].get(n.meta[0])
            if d is None:
                raise _Unshareable()
            # fully determined by the source column + pattern: two
            # templates matching the same regex over the same column
            # share one devtab gather
            form = ("dfa", forms[0], d.pattern)
        elif op in ("cmp", "arith"):
            form = (op, n.meta[0], forms[0], forms[1])
        elif op in ("and", "or"):
            form = (op, forms[0], forms[1])
        elif op == "not":
            form = ("not", forms[0])
        else:                               # any_e / all_e / count_e
            form = (op, n.meta[0], forms[0])
            eaxes = frozenset()             # the element axis is reduced
        if len(eaxes) > 1:
            raise _Unshareable()            # no single injectable shape
        return (form, r, eaxes, compute)


def canonical_conjuncts(lowered, constraints: list[dict]) -> dict:
    """node_idx -> (digest, ekind, axis) for every rule-conjunct root
    that qualifies for cross-template sharing: canonicalizable, varies
    over the resource (or element) axis, and contains at least one
    compute node (a bare input is cheaper to read directly than to
    share)."""
    program = lowered.program
    canon = _Canon(program, lowered.spec, constraints)
    out: dict[int, tuple] = {}
    roots = {ci for rule in program.rules for ci in rule.conjuncts}
    for idx in sorted(roots):
        try:
            form, r, eaxes, compute = canon.node(idx)
        except _Unshareable:
            continue
        if compute < 1 or not (r or eaxes):
            continue
        digest = hashlib.sha1(repr(form).encode()).hexdigest()[:12]
        if eaxes:
            out[idx] = (digest, "e", next(iter(eaxes)))
        else:
            out[idx] = (digest, "r", None)
    return out


def template_digests(lowered, constraints: list[dict] | None = None) -> set:
    """Digest set of one template's shareable conjuncts.  Without
    constraints (template install time, none exist yet) a parameterless
    dummy stands in: literal-backed scalars still resolve, genuinely
    parameter-dependent ones drop out as unshareable."""
    if lowered is None:
        return set()
    cons = constraints or [{"spec": {"parameters": {}}}]
    return {d for d, _, _ in canonical_conjuncts(lowered, cons).values()}


# ---------------------------------------------------------------------------
# match shadowing / unreachability (static mirror of engine/match._View.mask)

ENFORCE_RANK = {"dryrun": 0, "warn": 1, "deny": 2}


def _rank(doc: dict) -> int:
    action = (doc.get("spec") or {}).get("enforcementAction", "deny")
    return ENFORCE_RANK.get(action, 2)


def match_unreachable(match: dict) -> str | None:
    """Reason string when the criteria statically match nothing, by the
    exact engine semantics: non-list / empty ``kinds`` zeroes the kind
    mask, empty ``namespaces`` zeroes the namespace mask."""
    if "kinds" in match:
        kinds = match["kinds"]
        if not isinstance(kinds, list):
            return "spec.match.kinds is not a list — matches no object"
        live = False
        for ks in kinds:
            if not isinstance(ks, dict):
                continue
            groups = ks.get("apiGroups") or []
            knames = ks.get("kinds") or []
            g_ok = "*" in groups or any(isinstance(g, str) for g in groups)
            k_ok = "*" in knames or any(isinstance(k, str) for k in knames)
            if g_ok and k_ok:
                live = True
        if not live:
            return ("no spec.match.kinds entry names both an apiGroup "
                    "and a kind — matches no object")
    ns = match.get("namespaces")
    if "namespaces" in match and isinstance(ns, list) and not ns:
        return "spec.match.namespaces is empty — matches no object"
    return None


def _kinds_entry_covers(a: dict, b: dict) -> bool:
    ag = a.get("apiGroups") or []
    bg = b.get("apiGroups") or []
    ak = a.get("kinds") or []
    bk = b.get("kinds") or []
    g = "*" in ag or ("*" not in bg and set(bg) <= set(ag))
    k = "*" in ak or ("*" not in bk and set(bk) <= set(ak))
    return g and k


def match_subsumes(a: dict, b: dict) -> bool:
    """True when A's criteria match a superset of B's under the engine
    semantics — only the four clauses the engine evaluates (kinds,
    namespaces, namespaceSelector, labelSelector) exist; selectors are
    covered only by exact equality or absence in A.  A statically
    unreachable B is the set_unreachable finding's job, not this
    one's."""
    if match_unreachable(b) is not None:
        return False
    if "kinds" in a:
        a_kinds = a["kinds"]
        if not isinstance(a_kinds, list):
            return False                    # A matches nothing
        if "kinds" not in b:
            return False                    # B kind-wildcard, A restricted
        for be in b["kinds"]:
            if not isinstance(be, dict):
                continue
            if not any(isinstance(ae, dict) and _kinds_entry_covers(ae, be)
                       for ae in a_kinds):
                return False
    a_ns = a.get("namespaces")
    if "namespaces" in a and a_ns is not None:
        b_ns = b.get("namespaces")
        if "namespaces" not in b or not isinstance(b_ns, list) \
                or not isinstance(a_ns, list) \
                or not set(s for s in b_ns if isinstance(s, str)) \
                <= set(s for s in a_ns if isinstance(s, str)):
            return False
    if a.get("namespaceSelector") is not None:
        if json.dumps(a.get("namespaceSelector"), sort_keys=True) != \
                json.dumps(b.get("namespaceSelector"), sort_keys=True):
            return False
    if a.get("labelSelector"):
        if json.dumps(a.get("labelSelector"), sort_keys=True) != \
                json.dumps(b.get("labelSelector"), sort_keys=True):
            return False
    return True


def _params_equal(a: dict, b: dict) -> bool:
    pa = (a.get("spec") or {}).get("parameters")
    pb = (b.get("spec") or {}).get("parameters")
    return json.dumps(pa, sort_keys=True) == json.dumps(pb, sort_keys=True)


def constraint_set_warnings(kind: str, name: str, doc: dict,
                            installed: list) -> list[Diagnostic]:
    """set_* findings for one reconciled constraint against the other
    installed constraints of its kind (``installed``: (name, doc)
    pairs, the reconciled constraint excluded)."""
    out: list[Diagnostic] = []
    loc = Location(file=f"{kind}/{name}")
    match = (doc.get("spec") or {}).get("match") or {}
    reason = match_unreachable(match)
    if reason is not None:
        out.append(Diagnostic("set_unreachable", WARNING, reason, loc))
    for oname, odoc in installed:
        if oname == name or not _params_equal(doc, odoc):
            continue
        omatch = (odoc.get("spec") or {}).get("match") or {}
        if match_subsumes(omatch, match) and _rank(odoc) >= _rank(doc):
            out.append(Diagnostic(
                "set_shadowed", WARNING,
                f"subsumed by constraint {oname!r}: identical parameters, "
                f"superset match criteria, equal-or-stricter enforcement "
                f"— this constraint can never add a violation", loc))
        elif match_subsumes(match, omatch) and _rank(doc) >= _rank(odoc):
            out.append(Diagnostic(
                "set_shadows", WARNING,
                f"subsumes constraint {oname!r}: identical parameters, "
                f"superset match criteria, equal-or-stricter enforcement "
                f"— {oname!r} can never add a violation", loc))
    return out


# ---------------------------------------------------------------------------
# cost-budget admission + duplicate-predicate vetting (reconcile-time)


def vet_template_cost(lowered, kind: str) -> list[Diagnostic]:
    """cost_* findings for one template at reference scale.  strict
    mode escalates a blown budget to an error (the reconciler rejects
    the template); warn records it; off skips."""
    mode = costmodel.budget_mode()
    if mode == "off" or lowered is None:
        return []
    cv = costmodel.estimate(lowered, costmodel.REF_ROWS, 1)
    units = cv.units()
    budget = costmodel.budget_units()
    if units <= budget:
        return []
    sev = ERROR if mode == "strict" else WARNING
    return [Diagnostic(
        "cost_budget_exceeded", sev,
        f"predicted static cost {units:.3g} units at {costmodel.REF_ROWS} "
        f"rows exceeds GATEKEEPER_COST_BUDGET_UNITS={budget:.3g} "
        f"(mode={mode}; gathers={cv.gathers} compares={cv.compares} "
        f"matmul_flops={cv.matmul_flops})",
        Location(file=kind))]


def dfa_subset_warnings(kind: str, lowered) -> list[Diagnostic]:
    """regex_off_dfa findings: constant regex/glob patterns of the
    template that stayed on the host lookup-table path, and why
    (unsupported construct, DFA state blowup, or GATEKEEPER_DFA=off).
    Informational — results are identical either way; only the
    high-cardinality rebuild cost differs."""
    out: list[Diagnostic] = []
    for pattern, reason in getattr(lowered, "regex_offdfa", ()) or ():
        out.append(Diagnostic(
            "regex_off_dfa", WARNING,
            f"pattern {pattern!r} is outside the in-program DFA subset "
            f"({reason}); its matches run as a host lookup table, rebuilt "
            f"per unique value on churn",
            Location(file=kind)))
    return out


def duplicate_predicate_warnings(kind: str, lowered,
                                 others: dict) -> list[Diagnostic]:
    """set_duplicate_predicate findings: conjuncts of the new template
    whose canonical digest already appears in an installed template
    (``others``: kind -> LoweredProgram).  Informational — the audit
    sweep dedups them automatically."""
    mine = template_digests(lowered)
    if not mine:
        return []
    out: list[Diagnostic] = []
    for okind in sorted(others):
        if okind == kind:
            continue
        shared = mine & template_digests(others[okind])
        if shared:
            out.append(Diagnostic(
                "set_duplicate_predicate", WARNING,
                f"{len(shared)} predicate subprogram(s) identical to "
                f"template {okind!r} ({', '.join(sorted(shared))}); the "
                f"audit sweep evaluates each once per sweep (dedup)",
                Location(file=kind)))
    return out
