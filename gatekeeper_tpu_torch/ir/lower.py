# Copied from gatekeeper_tpu/ir/lower.py for the PyTorch port.
"""Rego -> vectorized IR lowering.

The compiler stage that replaces OPA's planner (reference:
internal/planner/planner.go:20 lowering Rego to imperative IR for Wasm;
ours targets the tensor IR in ir/program.py).  The strategy is
*dependency factoring*: every subexpression of a violation rule is
classified by what it reads —

  - nothing              -> folded at lower time (constant literals)
  - constraint only      -> host-evaluated per constraint with the
                            scalar oracle (n_constraints is small):
                            cvals / csets / cvalid closures
  - one review/elem leaf -> host-evaluated per *unique* value into a
                            lookup table (strings/regex/quantity parsing
                            never reach the device)
  - leaf x constraint    -> parametric table + per-constraint index set
  - mixtures             -> residual device ops: compares, boolean
                            algebra, membership, masked reductions

plus fused recognitions for the gatekeeper-library patterns:
label-key set comprehensions, required-set difference + count
(K8sRequiredLabels), param-list iteration/any (K8sAllowedRepos), and
element iteration over one list axis (``spec.containers[_]``).
User-defined template functions are either table-evaluated (scalar
args, e.g. ``canonify_cpu``) or symbolically inlined (compound args,
e.g. ``missing(obj, field)``).

Soundness contract: the device mask may *over*-approximate the oracle
(violating pairs are re-evaluated on host for exact messages, so false
positives only cost host work); anything that could under-approximate
must raise CannotLower, which routes the template to the scalar
fallback.  Known deviations (documented, not load-bearing for k8s
data): float32 ordering comparisons near 2^24, and ordering (not
equality) between mixed types.

Templates that reach into ``data.inventory`` lower when they match the
duplicate-detection join shape (``_try_inventory_join`` below — one
host-built InvJoinReq column per join, e.g. K8sUniqueIngressHost);
other inventory access raises CannotLower and runs on the scalar
oracle.  The shipped corpus's bucket per template is pinned in
library/lowering_buckets.json (CI-checked).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable

from gatekeeper_tpu_torch.ir.prep import (
    CSetReq, CValReq, DfaReq, EColReq, ElemKeysReq, InvJoinReq, KeyedValReq,
    MembReq, PrepSpec, PTableReq, RColReq, TableReq)
from gatekeeper_tpu_torch.ir.program import CMP_OPS, Node, Program, RuleSpec
from gatekeeper_tpu_torch.ops import regex_dfa
from gatekeeper_tpu_torch.rego import builtins as bi
from gatekeeper_tpu_torch.rego.ast_nodes import (
    ArrayTerm, Assign, BinOp, Call, Compare, Comprehension, Literal, Module,
    ObjectTerm, Ref, Rule, Scalar, SetTerm, SomeDecl, Term, UnaryMinus, Var)
from gatekeeper_tpu_torch.rego.interp import Interpreter, UNDEFINED
from gatekeeper_tpu_torch.rego.values import freeze, is_truthy

META_PATHS = {
    ("kind", "group"), ("kind", "version"), ("kind", "kind"),
    ("name",), ("namespace",), ("operation",),
}

_MAX_INLINE_DEPTH = 8


class CannotLower(Exception):
    """Template (or rule) outside the vectorizable subset; the caller
    falls back to the scalar oracle — never an error (SURVEY §7.3)."""


# ---------------------------------------------------------------------------
# symbolic values


@dataclasses.dataclass(frozen=True)
class LeafId:
    root: str                 # 'obj' | 'meta' | element axis key
    path: tuple[str, ...]


class Sym:
    pass


@dataclasses.dataclass(frozen=True)
class SConst(Sym):
    value: Any


@dataclasses.dataclass(frozen=True)
class SLeaf(Sym):
    leaf: LeafId


@dataclasses.dataclass(frozen=True)
class SCTerm(Sym):
    """Constraint-only term (may reference env vars that are themselves
    constraint-only)."""

    term: Term
    env_vars: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class SCIter(Sym):
    """Constraint-only term that *iterates* (e.g. params.repos[_]):
    evaluating yields one value per element."""

    term: Term
    env_vars: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class SNode(Sym):
    nid: int
    kind: str                 # 'bool' | 'num' | 'id_val' | 'id_str'
    # exact=False marks an over-approximation (an inlined user function
    # whose clauses have computed head values fires even where the head
    # would evaluate to `false`; host re-eval filters the false
    # positives).  Negating an inexact node would flip the
    # over-approximation into an under-approximation — silently dropped
    # violations — so _as_conjunct raises CannotLower instead
    # (soundness contract: anything that could under-approximate must
    # fall back to the scalar path).
    exact: bool = True


@dataclasses.dataclass(frozen=True)
class SLeafExpr(Sym):
    """Computed expression of exactly one leaf (plus constants):
    becomes a unique-value host table at materialization."""

    term: Term                # with leaf refs replaced by Var("__leaf0__")
    leaf: LeafId


@dataclasses.dataclass(frozen=True)
class SLabelKeys(Sym):
    path: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class SSetDiff(Sym):
    cset: Sym                 # SCTerm evaluating to a set/list
    keys: SLabelKeys


@dataclasses.dataclass(frozen=True)
class SCount(Sym):
    inner: Sym


@dataclasses.dataclass(frozen=True)
class SParamPred(Sym):
    """[pred | p = <constraint list>[_]; pred = f(leaf, p)] — the
    allowedrepos comprehension; any()/all() consume it.

    ``origin`` decides negation semantics in statement position:
    - 'gen':   p was generator-bound by an EARLIER literal
               (p := params[_]; not pred(x, p)) — `not` applies per
               binding, so negated = ∃p ¬pred = ¬(∀p pred);
    - 'local': the iteration is embedded INSIDE the term
               (not pred(x, params[_])) — the wildcard scopes under the
               negation-as-failure, so negated = ¬∃p pred;
    - 'compr': a comprehension value ([g | ...]) — as a statement it is
               always truthy (even empty), so positive folds away and
               negated can never fire."""

    iter_term: Term           # the iterating constraint ref (yields params)
    iter_env: tuple[str, ...]
    pvar: str
    pred_term: Term           # with leaf refs replaced by __leaf0__
    leaf: LeafId
    origin: str = "gen"       # 'gen' | 'local' | 'compr'


@dataclasses.dataclass
class _Deps:
    leaves: set = dataclasses.field(default_factory=set)
    constraint: bool = False
    env_vars: set = dataclasses.field(default_factory=set)
    device: bool = False      # reaches through an already-emitted node

    def merge(self, other: "_Deps") -> "_Deps":
        self.leaves |= other.leaves
        self.constraint |= other.constraint
        self.env_vars |= other.env_vars
        self.device |= other.device
        return self

    @property
    def constraint_only(self) -> bool:
        return not self.leaves and not self.device

    @property
    def const_only(self) -> bool:
        return not self.leaves and not self.device and not self.constraint


@dataclasses.dataclass
class LoweredProgram:
    program: Program
    spec: PrepSpec
    n_rules_total: int
    n_rules_lowered: int
    # constant regex/glob patterns this template evaluates that fell
    # outside the in-program DFA subset (or had the lowering disabled):
    # ((pattern, reason), ...) — surfaced by probe --policyset and the
    # reconciler's status warnings.  Defaulted so pickled IR snapshots
    # from before the field existed still load.
    regex_offdfa: tuple = ()


# ---------------------------------------------------------------------------


def _collect_vars(term, out: set) -> None:
    if isinstance(term, Var):
        out.add(term.name)
    elif isinstance(term, Ref):
        _collect_vars(term.base, out)
        for p in term.path:
            _collect_vars(p, out)
    elif isinstance(term, (ArrayTerm, SetTerm)):
        for t in term.items:
            _collect_vars(t, out)
    elif isinstance(term, ObjectTerm):
        for k, v in term.pairs:
            _collect_vars(k, out)
            _collect_vars(v, out)
    elif isinstance(term, Call):
        for a in term.args:
            _collect_vars(a, out)
    elif isinstance(term, BinOp):
        _collect_vars(term.lhs, out)
        _collect_vars(term.rhs, out)
    elif isinstance(term, UnaryMinus):
        _collect_vars(term.operand, out)
    elif isinstance(term, Comprehension):
        for h in term.head:
            _collect_vars(h, out)
        for lit in term.body:
            _collect_lit_vars(lit, out)


def _collect_lit_vars(lit: Literal, out: set) -> None:
    e = lit.expr
    if isinstance(e, (Compare, Assign)):
        _collect_vars(e.lhs, out)
        _collect_vars(e.rhs, out)
    elif isinstance(e, SomeDecl):
        pass
    else:
        _collect_vars(e, out)
    for w in lit.withs:
        _collect_vars(w.value, out)


def _subst(term, mapping: dict):
    """Structural substitution: Var name -> replacement term; also used
    to splice function args into inlined bodies."""
    if isinstance(term, Var):
        return mapping.get(term.name, term)
    if isinstance(term, Ref):
        base = _subst(term.base, mapping)
        path = tuple(_subst(p, mapping) for p in term.path)
        if isinstance(base, Ref):
            return Ref(base.base, base.path + path)
        return Ref(base, path)
    if isinstance(term, ArrayTerm):
        return ArrayTerm(tuple(_subst(t, mapping) for t in term.items))
    if isinstance(term, SetTerm):
        return SetTerm(tuple(_subst(t, mapping) for t in term.items))
    if isinstance(term, ObjectTerm):
        return ObjectTerm(tuple((_subst(k, mapping), _subst(v, mapping))
                                for k, v in term.pairs))
    if isinstance(term, Call):
        return Call(term.name, tuple(_subst(a, mapping) for a in term.args))
    if isinstance(term, BinOp):
        return BinOp(term.op, _subst(term.lhs, mapping), _subst(term.rhs, mapping))
    if isinstance(term, UnaryMinus):
        return UnaryMinus(_subst(term.operand, mapping))
    if isinstance(term, Comprehension):
        return Comprehension(term.kind,
                             tuple(_subst(h, mapping) for h in term.head),
                             tuple(_subst_lit(l, mapping) for l in term.body))
    return term


def _subst_lit(lit: Literal, mapping: dict) -> Literal:
    e = lit.expr
    if isinstance(e, Compare):
        e2: Any = Compare(e.op, _subst(e.lhs, mapping), _subst(e.rhs, mapping))
    elif isinstance(e, Assign):
        e2 = Assign(e.op, _subst(e.lhs, mapping), _subst(e.rhs, mapping))
    elif isinstance(e, SomeDecl):
        e2 = e
    else:
        e2 = _subst(e, mapping)
    return Literal(expr=e2, negated=lit.negated, withs=lit.withs, loc=lit.loc)


class _RuleNeverFires(Exception):
    pass


class _AllVars(set):
    """used_later sentinel for inlined bodies: every var counts as used."""

    def __contains__(self, item) -> bool:
        return True


_ALL_VARS = _AllVars()


# ---------------------------------------------------------------------------


class Lowerer:
    def __init__(self, module: Module, interp: Interpreter):
        self.module = module
        self.interp = interp
        self.nodes: list[Node] = []
        self.rules_out: list[RuleSpec] = []
        self.serial = itertools.count()
        # prep accumulators (deduped by name)
        self.rcols: dict[tuple, str] = {}
        self.ecols: dict[tuple, str] = {}
        self.axes: dict[str, tuple[str, ...]] = {}
        self.r_reqs: list[RColReq] = []
        self.e_reqs: list[EColReq] = []
        self.tables: list[TableReq] = []
        self.ptables: list[PTableReq] = []
        self.dfas: dict[tuple[str, str], DfaReq] = {}   # (src, pattern) ->
        self.regex_offdfa: dict[str, str] = {}          # pattern -> reason
        self.csets: list[CSetReq] = []
        self.cvals: list[CValReq] = []
        self.membs: list[MembReq] = []
        self.elem_keys: list[ElemKeysReq] = []
        self.keyed_vals: list[KeyedValReq] = []
        self.spec_inv_joins: list[InvJoinReq] = []
        self.cvalid_fns: list[Callable] = []
        self.uses_inventory_lowered = False
        self._leaf_nodes: dict[tuple, int] = {}
        self._no_negate_nodes: set[int] = set()
        self._fn_purity: dict[str, bool] = {}
        # per-rule state
        self.env: dict[str, Sym] = {}
        self.elem: tuple[str, tuple[str, ...]] | None = None
        self.conjuncts: list[int] = []
        self._retired_axes: set[str] = set()
        self._rule_axis_leaves: set[str] = set()   # axis roots emitted in this rule
        self._inline_depth = 0
        # set by _inline_function when the subtree being lowered contains
        # an inexact (over-approximating) inlined call, so exactness
        # propagates through nested inlining
        self._subtree_inexact = False

    # -- entry ---------------------------------------------------------

    def lower(self) -> LoweredProgram:
        vrules = [r for r in self.module.rules if r.name == "violation"
                  and r.kind == "partial_set"]
        n_total = len(vrules)
        for rule in vrules:
            self.env = {}
            self.elem = None
            self.conjuncts = []
            self._retired_axes = set()
            self._rule_axis_leaves = set()
            try:
                self._lower_rule(rule)
            except _RuleNeverFires:
                continue
            self.rules_out.append(RuleSpec(
                conjuncts=tuple(self.conjuncts),
                elem_axis=self.elem[0] if self.elem else None))
        spec = PrepSpec(
            r_cols=tuple(self.r_reqs), e_cols=tuple(self.e_reqs),
            axes=tuple(sorted(self.axes.items())),
            tables=tuple(self.tables), ptables=tuple(self.ptables),
            csets=tuple(self.csets), cvals=tuple(self.cvals),
            membs=tuple(self.membs), elem_keys=tuple(self.elem_keys),
            keyed_vals=tuple(self.keyed_vals),
            inv_joins=tuple(self.spec_inv_joins),
            dfas=tuple(self.dfas.values()),
            cvalid_fns=tuple(self.cvalid_fns))
        return LoweredProgram(
            program=Program(nodes=tuple(self.nodes), rules=tuple(self.rules_out)),
            spec=spec, n_rules_total=n_total, n_rules_lowered=len(self.rules_out),
            regex_offdfa=tuple(sorted(self.regex_offdfa.items())))

    # -- node emission -------------------------------------------------

    def _emit(self, op: str, args: tuple[int, ...] = (), meta: tuple = ()) -> int:
        self.nodes.append(Node(op, args, meta))
        return len(self.nodes) - 1

    def _emit_leaf(self, leaf: LeafId, mode: str) -> int:
        if leaf.root in self._retired_axes:
            # the parent of a nested flattened axis carries no device
            # columns in this rule — a conjunct here would mix axes
            raise CannotLower("conjunct on the parent of a nested axis")
        if leaf.root not in ("obj", "meta"):
            self._rule_axis_leaves.add(leaf.root)
        key = (leaf, mode)
        hit = self._leaf_nodes.get(key)
        if hit is not None:
            return hit
        if leaf.root == "obj":
            name = f"r:{mode}:" + ".".join(leaf.path)
            self.r_reqs.append(RColReq(name, leaf.path, mode))
            kind = {"str": "r_id", "val": "r_id", "num": "r_num", "len": "r_num",
                    "truthy": "r_bool", "present": "r_bool"}[mode]
        elif leaf.root == "meta":
            name = "r:meta:" + ".".join(leaf.path)
            self.r_reqs.append(RColReq(name, ("$meta",) + leaf.path, "str"))
            kind = "r_id"
        else:  # element axis
            axis = leaf.root
            name = f"e:{mode}:{axis}:" + ".".join(leaf.path)
            self.e_reqs.append(EColReq(name, axis, self.axes[axis], leaf.path, mode))
            kind = {"str": "e_id", "val": "e_id", "num": "e_num", "len": "e_num",
                    "truthy": "e_bool", "present": "e_bool"}[mode]
        nid = self._emit("input", (), (name, kind))
        self._leaf_nodes[key] = nid
        return nid

    # -- dependency analysis -------------------------------------------

    def _deps(self, term, bound: frozenset = frozenset()) -> _Deps:
        d = _Deps()
        if isinstance(term, Scalar):
            return d
        if isinstance(term, Var):
            if term.is_wildcard or term.name in bound:
                return d
            if term.name in self.env:
                d.env_vars.add(term.name)
                return d.merge(self._sym_deps(self.env[term.name]))
            if term.name == "input":
                raise CannotLower("bare `input` reference")
            if term.name == "data":
                raise CannotLower("data reference")
            if term.name in self.interp.rules:
                return d.merge(self._rule_deps(term.name))
            # unbound: binds here (iteration/pattern position)
            return d
        if isinstance(term, Ref):
            base = term.base
            resolved = _resolve_ref_leaf(term, self.axes, self.env)
            if resolved is not None:
                d.leaves.add(resolved)
                return d
            if isinstance(base, Var) and base.name == "input":
                return d.merge(self._input_ref_deps(term, bound))
            if isinstance(base, Var) and base.name == "data":
                raise CannotLower("data.inventory access")
            if isinstance(base, Var) and isinstance(self.env.get(base.name), SLeaf):
                sym = self.env[base.name]
                mid, lastp = term.path[:-1], (term.path[-1] if term.path else None)
                if isinstance(lastp, Var) and lastp.is_wildcard \
                        and all(isinstance(p, Scalar) for p in mid):
                    # nested iteration (containers[_].env[_]): a leaf dep
                    # of the (future) flattened axis — _try_nested_elem
                    # resolves it at assignment time
                    d.leaves.add(LeafId(sym.leaf.root,
                                        sym.leaf.path
                                        + tuple(p.value for p in mid)))
                    return d
                if not mid and isinstance(lastp, Var) \
                        and lastp.name in self.env:
                    kd = self._sym_deps(self.env[lastp.name])
                    if kd.constraint_only:
                        # <elem>[<constraint key>]: handled by the
                        # elem-key-missing / keyed recognizers
                        d.leaves.add(sym.leaf)
                        d.constraint = True
                        return d
                raise CannotLower("dynamic path under a leaf binding")
            db = self._deps(base, bound)
            d.merge(db)
            for p in term.path:
                d.merge(self._deps(p, bound))
            return d
        if isinstance(term, Call):
            if len(term.name) == 1 and term.name[0] in self.interp.rules:
                if not self._function_pure(term.name[0]):
                    raise CannotLower(f"impure function {term.name[0]}")
            elif term.name not in bi.REGISTRY and term.name != ("trace",):
                raise CannotLower(f"unknown builtin {'.'.join(term.name)}")
            for a in term.args:
                d.merge(self._deps(a, bound))
            return d
        if isinstance(term, BinOp):
            d.merge(self._deps(term.lhs, bound))
            return d.merge(self._deps(term.rhs, bound))
        if isinstance(term, UnaryMinus):
            return d.merge(self._deps(term.operand, bound))
        if isinstance(term, (ArrayTerm, SetTerm)):
            for t in term.items:
                d.merge(self._deps(t, bound))
            return d
        if isinstance(term, ObjectTerm):
            for k, v in term.pairs:
                d.merge(self._deps(k, bound))
                d.merge(self._deps(v, bound))
            return d
        if isinstance(term, Comprehension):
            # comprehension-local vars: assigned lhs + some-decls; other
            # unbound vars fall through to the Var case ("binds here")
            inner_bound = set(bound)
            for lit in term.body:
                e = lit.expr
                if isinstance(e, Assign) and isinstance(e.lhs, Var):
                    inner_bound.add(e.lhs.name)
                if isinstance(e, SomeDecl):
                    inner_bound.update(e.names)
            fb = frozenset(inner_bound)
            for lit in term.body:
                d.merge(self._lit_deps(lit, fb))
            for h in term.head:
                d.merge(self._deps(h, fb))
            return d
        raise CannotLower(f"unanalyzable term {type(term).__name__}")

    def _lit_deps(self, lit: Literal, bound: frozenset) -> _Deps:
        if lit.withs:
            raise CannotLower("with modifier")
        e = lit.expr
        d = _Deps()
        if isinstance(e, (Compare, Assign)):
            d.merge(self._deps(e.lhs, bound))
            d.merge(self._deps(e.rhs, bound))
        elif isinstance(e, SomeDecl):
            pass
        else:
            d.merge(self._deps(e, bound))
        return d

    def _input_ref_deps(self, term: Ref, bound: frozenset) -> _Deps:
        d = _Deps()
        path = term.path
        if not path or not isinstance(path[0], Scalar):
            raise CannotLower("dynamic input path")
        head = path[0].value
        if head == "review":
            rest = path[1:]
            if rest and isinstance(rest[0], Scalar) and rest[0].value == "object":
                for p in rest[1:]:
                    if isinstance(p, Scalar) and isinstance(p.value, str):
                        continue
                    if isinstance(p, Var) and (p.is_wildcard or p.name not in bound
                                               and p.name not in self.env):
                        # iteration point — only valid inside recognized
                        # patterns; deps-wise it's still this leaf
                        continue
                    if isinstance(p, Var) and p.name in self.env:
                        psym = self.env[p.name]
                        pd = self._sym_deps(psym)
                        if pd.constraint_only:
                            # constraint-param key (labels[key]): the
                            # keyed-lookup recognizer handles it
                            d.constraint = True
                            continue
                    raise CannotLower("computed key under review.object")
                scal = tuple(p.value for p in rest[1:] if isinstance(p, Scalar))
                d.leaves.add(LeafId("obj", scal))
                return d
            scal = tuple(p.value for p in rest if isinstance(p, Scalar))
            if len(scal) != len(rest) or scal not in META_PATHS:
                raise CannotLower(f"unsupported review field {scal!r}")
            d.leaves.add(LeafId("meta", scal))
            return d
        if head == "constraint":
            d.constraint = True
            for p in path[1:]:
                if isinstance(p, (Scalar, Var)):
                    continue
                d.merge(self._deps(p, bound))
            return d
        raise CannotLower(f"unsupported input.{head}")

    def _sym_deps(self, sym: Sym) -> _Deps:
        d = _Deps()
        if isinstance(sym, SConst):
            return d
        if isinstance(sym, SLeaf):
            d.leaves.add(sym.leaf)
            return d
        if isinstance(sym, (SCTerm, SCIter)):
            d.constraint = True
            return d
        if isinstance(sym, SLeafExpr):
            d.leaves.add(sym.leaf)
            return d
        if isinstance(sym, SNode):
            d.device = True
            return d
        if isinstance(sym, SLabelKeys):
            d.leaves.add(LeafId("obj", sym.path))
            return d
        if isinstance(sym, SSetDiff):
            d.constraint = True
            d.leaves.add(LeafId("obj", sym.keys.path))
            return d
        if isinstance(sym, SCount):
            return self._sym_deps(sym.inner)
        if isinstance(sym, SParamPred):
            d.constraint = True
            d.leaves.add(sym.leaf)
            return d
        raise CannotLower(f"deps of {type(sym).__name__}")

    def _rule_deps(self, name: str) -> _Deps:
        d = _Deps()
        for top in self.interp.rules.get(name, []):
            # walk the whole else chain: an else clause touching review
            # must count toward the rule's dependencies or host-eval
            # caching would misclassify it as constraint-only
            rule = top
            while rule is not None:
                params = {a.name for a in (rule.args or ())
                          if isinstance(a, Var)}
                fb = frozenset(params)
                # params SHADOW the enclosing rule's lowering env: a
                # function param named like an outer iteration var
                # (`port`) must not resolve to the outer leaf, or an
                # args-only function gets misclassified as impure
                shadowed = {p: self.env.pop(p) for p in params
                            if p in self.env}
                try:
                    for lit in rule.body:
                        d.merge(self._lit_deps(lit, fb))
                    if rule.value is not None:
                        d.merge(self._deps(rule.value, fb))
                finally:
                    self.env.update(shadowed)
                rule = rule.els
        return d

    def _function_extends_args(self, name: str) -> bool:
        """Does any clause body dereference into a parameter
        (Ref(base=param))?  If so the arg is compound and the function
        must be inlined rather than value-tabled."""
        for rule in self.interp.rules.get(name, []):
            params = {a.name for a in (rule.args or ()) if isinstance(a, Var)}
            found: list[bool] = []

            def check(t, _p=params, _f=found):
                if isinstance(t, Ref) and isinstance(t.base, Var) \
                        and t.base.name in _p:
                    _f.append(True)

            from gatekeeper_tpu_torch.rego.ast_nodes import walk_terms
            walk_terms(rule, check)
            if found:
                return True
        return False

    def _function_pure(self, name: str) -> bool:
        """A function is table-safe when its body reads only its args and
        constants (no input/data) — true for canonify_cpu & friends."""
        hit = self._fn_purity.get(name)
        if hit is not None:
            return hit
        self._fn_purity[name] = False  # recursion guard
        try:
            d = self._rule_deps(name)
            ok = not d.leaves and not d.constraint and not d.device
        except CannotLower:
            ok = False
        self._fn_purity[name] = ok
        return ok

    # -- constraint-side host evaluation -------------------------------

    def _ceval_env(self, constraint_frozen, env_vars: tuple[str, ...],
                   env_map: dict[str, Sym]) -> dict | None:
        """env_map is the *rule-scope env snapshot captured when the
        closure was created* — never self.env, which at build-bindings
        time holds whatever rule lowered last (a var name reused across
        rules would silently resolve to the wrong definition, or crash
        for names absent from the final rule)."""
        out: dict = {}
        for v in env_vars:
            sym = env_map.get(v)
            if isinstance(sym, SConst):
                out[v] = freeze(sym.value)
            elif isinstance(sym, SCTerm):
                val = self._ceval_term(constraint_frozen, sym.term,
                                       sym.env_vars, env_map)
                if val is UNDEFINED:
                    return None
                out[v] = val
            else:
                raise CannotLower(f"var {v} not constraint-only")
        return out

    def _ceval_term(self, constraint_frozen, term: Term,
                    env_vars: tuple[str, ...], env_map: dict[str, Sym]):
        env = self._ceval_env(constraint_frozen, env_vars, env_map)
        if env is None:
            return UNDEFINED
        ctx = self.interp._ctx(constraint_frozen, None, None)
        for v, _ in self.interp._eval_term(ctx, term, env):
            return v
        return UNDEFINED

    def _ceval_iter(self, constraint_frozen, term: Term,
                    env_vars: tuple[str, ...], env_map: dict[str, Sym]) -> list:
        env = self._ceval_env(constraint_frozen, env_vars, env_map)
        if env is None:
            return []
        ctx = self.interp._ctx(constraint_frozen, None, None)
        return [v for v, _ in self.interp._eval_term(ctx, term, env)]

    def _cinput(self, constraint: dict):
        return freeze({"constraint": constraint})

    def _check_cenv(self, env_vars, env_map, seen=None) -> None:
        """Eagerly verify every env var a constraint-side closure needs
        resolves to a constraint-only symbol.  Without this the failure
        surfaces as CannotLower at build_bindings time — far past the
        put_template scalar-fallback seam — and crashes the audit."""
        if seen is None:
            seen = set()
        for v in env_vars:
            if v in seen:
                continue
            seen.add(v)
            sym = env_map.get(v)
            if isinstance(sym, SConst):
                continue
            if isinstance(sym, SCTerm):
                self._check_cenv(sym.env_vars, env_map, seen)
                continue
            raise CannotLower(f"var {v} not constraint-only")

    def _make_cval(self, sym: SCTerm, kind: str) -> str:
        name = f"cv{next(self.serial)}"
        term, env_vars = sym.term, sym.env_vars
        env_map = dict(self.env)
        self._check_cenv(env_vars, env_map)

        def fn(c, _t=term, _ev=env_vars, _k=kind, _em=env_map):
            v = self._ceval_term(self._cinput(c), _t, _ev, _em)
            if v is UNDEFINED:
                return None
            # 'val' keeps compounds (frozen) — ir/encode.py interns a
            # canonical serialization so compound equality stays exact;
            # num/str/bool kinds are scalar-typed by construction
            return v if _k == "val" else _thaw_scalar(v)

        self.cvals.append(CValReq(name, kind, fn))
        return name

    def _make_cset(self, term: Term, env_vars: tuple[str, ...],
                   iterate: bool, encode: str, member_ref: bool = False) -> str:
        name = f"cs{next(self.serial)}"
        env_map = dict(self.env)
        self._check_cenv(env_vars, env_map)

        def fn(c, _t=term, _ev=env_vars, _it=iterate, _em=env_map,
               _mr=member_ref):
            if _it:
                vals = self._ceval_iter(self._cinput(c), _t, _ev, _em)
            elif _mr:
                # coll[x] statement semantics, exact per collection kind:
                #   set    -> fires iff x ∈ set and the member isn't
                #             literal false      -> members minus false
                #   array  -> index access: fires iff x is an in-range
                #             int and arr[x] isn't false -> truthy indices
                #   object -> field access: fires iff x is a key and the
                #             value isn't false  -> truthy keys
                #   other/undefined -> never fires -> empty set
                v = self._ceval_term(self._cinput(c), _t, _ev, _em)
                if v is UNDEFINED:
                    vals = []
                elif isinstance(v, frozenset):
                    vals = [x for x in sorted(v, key=repr) if x is not False]
                elif isinstance(v, tuple):
                    vals = [i for i, el in enumerate(v) if el is not False]
                else:
                    try:
                        items = list(v.items())
                    except AttributeError:
                        items = None
                    vals = ([k for k, val in items if val is not False]
                            if items is not None else [])
            else:
                v = self._ceval_term(self._cinput(c), _t, _ev, _em)
                if v is UNDEFINED:
                    return None
                vals = list(v) if isinstance(v, (frozenset, tuple)) else None
                if vals is None:
                    return None
                if isinstance(v, frozenset):
                    vals = sorted(vals, key=repr)
            # elements stay frozen: prep's encode_value handles scalars
            # and compounds alike (a compound element must match only
            # equal compounds, never null)
            return list(vals)

        self.csets.append(CSetReq(name, fn, encode=encode))
        return name

    # -- tables --------------------------------------------------------

    def _leaf_col_name(self, leaf: LeafId, mode: str) -> str:
        self._emit_leaf(leaf, mode)  # ensures the column request exists
        if leaf.root == "obj":
            return f"r:{mode}:" + ".".join(leaf.path)
        if leaf.root == "meta":
            return "r:meta:" + ".".join(leaf.path)
        return f"e:{mode}:{leaf.root}:" + ".".join(leaf.path)

    @staticmethod
    def _collect_ext_providers(term: Term) -> tuple[str, ...]:
        """Providers consulted by external_data calls keyed on the table's
        leaf — the key-collection pass.  Only the canonical shape
        ``external_data({"provider": <const>, "keys": [.. __leaf0__ ..]})``
        is recognized (the regex-detection precedent: exact shape or
        nothing): for it, the table's distinct source-column values ARE
        the provider's key set, so prep can warm them in one batched
        round before the per-value host loop runs."""
        found: list[str] = []

        def walk(t):
            if isinstance(t, Call) and t.name == ("external_data",) \
                    and len(t.args) == 1 \
                    and isinstance(t.args[0], ObjectTerm):
                provider = None
                keyed_on_leaf = False
                for k, v in t.args[0].pairs:
                    if isinstance(k, Scalar) and k.value == "provider" \
                            and isinstance(v, Scalar) \
                            and isinstance(v.value, str):
                        provider = v.value
                    if isinstance(k, Scalar) and k.value == "keys" \
                            and isinstance(v, ArrayTerm) \
                            and any(isinstance(it, Var)
                                    and it.name == "__leaf0__"
                                    for it in v.items):
                        keyed_on_leaf = True
                if provider and keyed_on_leaf:
                    found.append(provider)
            for f in getattr(t, "__dataclass_fields__", ()):
                v = getattr(t, f)
                if isinstance(v, Term):
                    walk(v)
                elif isinstance(v, tuple):
                    for it in v:
                        if isinstance(it, Term):
                            walk(it)
                        elif isinstance(it, tuple):
                            for sub in it:
                                if isinstance(sub, Term):
                                    walk(sub)
        walk(term)
        return tuple(dict.fromkeys(found))

    def _table_node(self, sym: SLeafExpr, out: str) -> int:
        """out: 'bool' | 'num' | 'id_val' | 'id_str'."""
        src = self._leaf_col_name(sym.leaf, "val")
        tname = f"t{next(self.serial)}"
        term = sym.term
        interp = self.interp

        def fn(value, _t=term):
            env = {"__leaf0__": freeze(value)}
            ctx = interp._ctx(UNDEFINED, None, None)
            if out == "bool":
                for v, _ in interp._eval_term(ctx, _t, env):
                    if is_truthy(v):
                        return True
                return None
            for v, _ in interp._eval_term(ctx, _t, env):
                # frozen pass-through: prep type-checks per `out` ('num'
                # wants numbers, 'id_str' strings, 'id_val' any value —
                # compounds included via the canonical encoding)
                return v
            return None

        # pure re_match(<const>, leaf) / glob.match(<const>, <const>, leaf):
        # extract the constant pattern.  When GATEKEEPER_DFA is on and the
        # pattern compiles (ops/regex_dfa subset), skip the host lookup
        # table entirely — emit a dfa_match node whose [S, 256] transition
        # table scans the interner's packed byte matrix inside the jitted
        # sweep (no per-unique-value host loop, no table rebuild on
        # churn).  Otherwise mark the TableReq so prep can still route
        # high-cardinality builds through the batched DFA engine
        # (topdown/regex.go semantics either way).
        regex = self._regex_pattern(term) if out == "bool" else None
        if regex is not None and regex_dfa.dfa_enabled():
            key = (src, regex)
            req = self.dfas.get(key)
            if req is None and regex_dfa.cached_dfa(regex) is not None:
                req = DfaReq(f"dfa{len(self.dfas)}", src, regex)
                self.dfas[key] = req
            if req is not None:
                idx = self._emit_leaf(sym.leaf, "val")
                return self._emit("dfa_match", (idx,), (req.name,))
            self.regex_offdfa.setdefault(
                regex,
                regex_dfa.unsupported_reason(regex) or "outside DFA subset")
        elif regex is not None:
            self.regex_offdfa.setdefault(regex, "GATEKEEPER_DFA=off")
        self.tables.append(TableReq(tname, src, fn, out=out, src_val=True,
                                    regex=regex,
                                    ext_providers=self._collect_ext_providers(
                                        term)))
        idx = self._emit_leaf(sym.leaf, "val")
        return self._emit("table", (idx,), (tname,))

    def _regex_pattern(self, term: Term) -> str | None:
        """The constant regex this boolean leaf term applies to
        ``__leaf0__``, if it is exactly one regex-shaped builtin call:
        ``re_match``/``regex.match`` directly, ``glob.match`` with
        constant delimiters via ``_glob_to_regex`` (the translation is
        ``\\A..\\Z``-anchored, so search and match semantics coincide and
        the TableReq ``regex=`` batch path stays sound on fallback)."""
        if not isinstance(term, Call):
            return None
        if term.name in (("re_match",), ("regex", "match")) \
                and len(term.args) == 2 \
                and isinstance(term.args[0], Scalar) \
                and isinstance(term.args[0].value, str) \
                and isinstance(term.args[1], Var) \
                and term.args[1].name == "__leaf0__":
            return term.args[0].value
        if term.name == ("glob", "match") and len(term.args) == 3 \
                and isinstance(term.args[0], Scalar) \
                and isinstance(term.args[0].value, str) \
                and isinstance(term.args[2], Var) \
                and term.args[2].name == "__leaf0__":
            d = term.args[1]
            if isinstance(d, Scalar) and d.value is None:
                delims: tuple[str, ...] | None = (".",)
            elif isinstance(d, ArrayTerm) and all(
                    isinstance(it, Scalar) and isinstance(it.value, str)
                    for it in d.items):
                delims = tuple(it.value for it in d.items)
            else:
                delims = None          # dynamic delimiters: host path
            if delims is not None:
                return bi._glob_to_regex(term.args[0].value, delims)
        return None

    def _ptable_node(self, leaf: LeafId, pred_term: Term, pvar: str,
                     iter_term: Term, iter_env: tuple[str, ...],
                     mode: str = "any") -> int:
        src = self._leaf_col_name(leaf, "val")
        tname = f"pt{next(self.serial)}"
        interp = self.interp
        env_map = dict(self.env)

        def cparams(c, _t=iter_term, _ev=iter_env, _em=env_map):
            return [_thaw_scalar(v) for v in
                    self._ceval_iter(self._cinput(c), _t, _ev, _em)]

        def fn(value, param, _t=pred_term, _pv=pvar):
            env = {"__leaf0__": freeze(value), _pv: freeze(param)}
            ctx = interp._ctx(UNDEFINED, None, None)
            for v, _ in interp._eval_term(ctx, _t, env):
                if is_truthy(v):
                    return True
            return False

        self.ptables.append(PTableReq(tname, src, cparams, fn, src_val=True))
        idx = self._emit_leaf(leaf, "val")
        op = "ptable_any" if mode == "any" else "ptable_all"
        return self._emit(op, (idx,), (tname, tname))

    # -- leaf-expression extraction ------------------------------------

    def _to_leaf_expr(self, term: Term, leaf: LeafId) -> Term:
        """Rewrite every reference to `leaf` (syntactic input refs and
        env vars bound to it) as Var("__leaf0__"); constant env vars are
        spliced in so the host closure is self-contained."""
        mapping: dict[str, Term] = {}
        for v, sym in self.env.items():
            if isinstance(sym, SLeaf) and sym.leaf == leaf:
                mapping[v] = Var("__leaf0__")
            elif isinstance(sym, SConst):
                mapping[v] = Scalar(sym.value)
        term = _subst(term, mapping)
        return _replace_leaf_refs(term, leaf, self.axes, self.env)

    # -- materialization helpers ---------------------------------------

    def _as_num(self, sym: Sym) -> int:
        if isinstance(sym, SConst):
            if not isinstance(sym.value, (int, float)) or isinstance(sym.value, bool):
                raise CannotLower(f"non-numeric const {sym.value!r} in numeric context")
            return self._emit("const", (), (float(sym.value), "float32"))
        if isinstance(sym, SLeaf):
            return self._emit_leaf(sym.leaf, "num")
        if isinstance(sym, SNode):
            if sym.kind != "num":
                raise CannotLower("non-numeric node in numeric context")
            return sym.nid
        if isinstance(sym, SCTerm):
            name = self._make_cval(sym, "num")
            return self._emit("input", (), (name, "c_num"))
        if isinstance(sym, SLeafExpr):
            return self._table_node(sym, "num")
        if isinstance(sym, SCount):
            inner = sym.inner
            if isinstance(inner, SLeaf):
                return self._emit_leaf(inner.leaf, "len")
            raise CannotLower("count() of unsupported value")
        raise CannotLower(f"numeric materialization of {type(sym).__name__}")

    def _as_id(self, sym: Sym, ns: str) -> int:
        """ns 'val' (encoded scalars) or 'str' (raw strings)."""
        if isinstance(sym, SConst):
            name = f"cv{next(self.serial)}"
            v = sym.value
            if ns == "str":
                self.cvals.append(CValReq(name, "str",
                                          lambda c, _v=v: _v if isinstance(_v, str) else None))
            else:
                self.cvals.append(CValReq(name, "val", lambda c, _v=v: _v))
            return self._emit("input", (), (name, "c_id"))
        if isinstance(sym, SLeaf):
            mode = "str" if sym.leaf.root == "meta" else ns if ns == "val" else "str"
            return self._emit_leaf(sym.leaf, mode if sym.leaf.root != "meta" else "str")
        if isinstance(sym, SCTerm):
            name = self._make_cval(sym, "str" if ns == "str" else "val")
            return self._emit("input", (), (name, "c_id"))
        if isinstance(sym, SNode):
            if sym.kind != ("id_str" if ns == "str" else "id_val"):
                raise CannotLower("id-namespace mismatch")
            return sym.nid
        if isinstance(sym, SLeafExpr):
            return self._table_node(sym, "id_str" if ns == "str" else "id_val")
        raise CannotLower(f"id materialization of {type(sym).__name__}")

    def _as_conjunct(self, sym: Sym, negated: bool = False) -> int | None:
        """Node whose fires() is the literal's truth; None = const-true."""
        if isinstance(sym, SConst):
            truthy = sym.value is not False and sym.value is not None
            if truthy != negated:
                return None
            raise _RuleNeverFires()
        if isinstance(sym, SLeaf):
            nid = self._emit_leaf(sym.leaf, "truthy")
        elif isinstance(sym, SNode):
            if negated and sym.nid in self._no_negate_nodes:
                raise CannotLower(
                    "negation of an existential-over-params node "
                    "(elem_keys_missing) would under-approximate")
            if negated and not sym.exact:
                raise CannotLower(
                    "negation of an over-approximating inlined function "
                    "(clauses with computed head values)")
            if not sym.exact:
                # positive use keeps the over-approximation (host re-eval
                # filters), but any enclosing inlined function is now
                # over-approximating too — without this, an inexact node
                # laundered through an env var into a wrapper function
                # (x := f(...); g uses x) would mark g exact and let
                # `not g(x)` under-approximate
                self._subtree_inexact = True
            nid = sym.nid
        elif isinstance(sym, SLeafExpr):
            nid = self._table_node(sym, "bool")
        elif isinstance(sym, SParamPred):
            # statement semantics depend on where the iteration binds
            # (see SParamPred.origin); every form is exact — the
            # predicate is host-evaluated per (value, param)
            if sym.origin == "compr":
                # a comprehension value is always truthy as a statement
                if negated:
                    raise _RuleNeverFires()
                return None
            if negated and sym.origin == "gen":
                # p bound earlier: not applies per binding -> ¬(∀p pred)
                mode = "all"
            else:
                # positive (∃p pred), or negation over an embedded
                # wildcard (¬∃p pred — negation-as-failure scopes it)
                mode = "any"
            nid = self._ptable_node(sym.leaf, sym.pred_term, sym.pvar,
                                    sym.iter_term, sym.iter_env, mode=mode)
        else:
            raise CannotLower(f"conjunct from {type(sym).__name__}")
        return self._emit("not", (nid,)) if negated else nid

    # -- rule lowering -------------------------------------------------

    def _lower_rule(self, rule: Rule) -> None:
        body = self._try_inventory_join(rule.body)
        # vars used by later literals (head msg/details are host-formatted,
        # so assigns feeding only the head are skipped)
        used_later: list[set] = [set() for _ in body]
        acc: set = set()
        for i in range(len(body) - 1, -1, -1):
            used_later[i] = set(acc)
            _collect_lit_vars(body[i], acc)
        for i, lit in enumerate(body):
            self._lower_literal(lit, used_later[i])

    # -- inventory joins (data.inventory duplicate detection) ----------

    @staticmethod
    def _parse_inv_iter(rhs) -> tuple | None:
        """Match ``data.inventory.namespace[ns][gv]["Kind"][name]`` (or
        the cluster form ``data.inventory.cluster[gv]["Kind"][name]``):
        -> (kind, name_var, namespaced_only, bound_vars)."""
        if not (isinstance(rhs, Ref) and isinstance(rhs.base, Var)
                and rhs.base.name == "data"):
            return None
        p = rhs.path
        if len(p) < 2 or not (isinstance(p[0], Scalar)
                              and p[0].value == "inventory"):
            return None
        if not isinstance(p[1], Scalar):
            return None
        scope = p[1].value
        rest = p[2:]
        if scope == "namespace" and len(rest) == 4:
            ns_v, gv_v, kind_t, name_t = rest
            free = (ns_v, gv_v)
            namespaced = True
        elif scope == "cluster" and len(rest) == 3:
            gv_v, kind_t, name_t = rest
            free = (gv_v,)
            namespaced = False
        else:
            return None
        if not all(isinstance(v, Var) for v in free):
            return None
        if not (isinstance(kind_t, Scalar) and isinstance(kind_t.value, str)):
            return None
        if not isinstance(name_t, Var):
            return None
        bound = {v.name for v in free if not v.is_wildcard}
        return kind_t.value, name_t, namespaced, bound

    def _try_inventory_join(self, body) -> list:
        """Recognize the duplicate-detection join shape and replace its
        literals with one host-built InvJoinReq column (SURVEY §7 /
        VERDICT: per-sweep inventory index so K8sUniqueIngressHost runs
        on device).  Supported shape:

          other := data.inventory.namespace[ns][_]["Kind"][name]
          other.<path> == <review leaf>          (either operand order)
          not <review name leaf> == name         (optional, either order)

        with the inventory vars referenced nowhere else in the body
        (the head is host-formatted by the oracle on candidate pairs, so
        head references are fine).  Anything else leaves the body
        unchanged — the standard path will raise CannotLower and route
        the template to the scalar oracle."""
        inv_idx = None
        parsed = other_var = None
        for i, lit in enumerate(body):
            e = lit.expr
            if isinstance(e, Assign) and isinstance(e.lhs, Var) \
                    and not lit.negated:
                p = self._parse_inv_iter(e.rhs)
                if p is not None:
                    if inv_idx is not None:
                        return body          # two joins: scalar fallback
                    inv_idx, parsed, other_var = i, p, e.lhs.name
        if inv_idx is None:
            return body
        kind, name_t, namespaced, bound_free = parsed
        name_var = None if name_t.is_wildcard else name_t.name
        join = None          # (inv_path, src_leaf)
        guard = False
        consumed = {inv_idx}
        inv_vars = {other_var} | bound_free | ({name_var} if name_var else set())

        # syntactic env: the pre-pass runs before any literal lowers, so
        # resolve `v := input.review.object...` chains from the body text
        syn_env: dict[str, Sym] = {}
        for lit in body:
            e = lit.expr
            if not lit.negated and isinstance(e, Assign) \
                    and isinstance(e.lhs, Var) and isinstance(e.rhs, Ref):
                leaf = _resolve_ref_leaf(e.rhs, self.axes, syn_env)
                if leaf is not None:
                    syn_env[e.lhs.name] = SLeaf(leaf)

        def refs_inv(term) -> bool:
            found: list = []

            def chk(t):
                if isinstance(t, Var) and t.name in inv_vars:
                    found.append(t)
            from gatekeeper_tpu_torch.rego.ast_nodes import walk_terms
            walk_terms(term, chk)
            return bool(found)

        def review_leaf_of(term):
            if isinstance(term, Ref):
                return _resolve_ref_leaf(term, self.axes, syn_env)
            if isinstance(term, Var):
                sym = syn_env.get(term.name)
                if isinstance(sym, SLeaf):
                    return sym.leaf
            return None

        for i, lit in enumerate(body):
            # walk the LITERAL (walk_terms does not descend into bare
            # Compare/Assign exprs)
            if i == inv_idx or not refs_inv(lit):
                continue
            e = lit.expr
            if isinstance(e, (Compare, Assign)) and \
                    getattr(e, "op", None) in ("==", "="):
                lhs, rhs = e.lhs, e.rhs
                # join: other.<path> == <review leaf>
                for a, b in ((lhs, rhs), (rhs, lhs)):
                    if join is None and not lit.negated \
                            and isinstance(a, Ref) \
                            and isinstance(a.base, Var) \
                            and a.base.name == other_var \
                            and all(isinstance(s, Scalar) for s in a.path) \
                            and not refs_inv(b):
                        leaf = review_leaf_of(b)
                        if leaf is not None and leaf.root == "obj":
                            join = (tuple(s.value for s in a.path), leaf)
                            consumed.add(i)
                            break
                if i in consumed:
                    continue
                # guard: not <review name> == name
                if lit.negated and name_var is not None and not guard:
                    for a, b in ((lhs, rhs), (rhs, lhs)):
                        if isinstance(a, Var) and a.name == name_var \
                                and not refs_inv(b):
                            leaf = review_leaf_of(b)
                            if leaf is not None and (
                                    leaf == LeafId("obj", ("metadata", "name"))
                                    or leaf == LeafId("meta", ("name",))):
                                guard = True
                                consumed.add(i)
                                break
                    if i in consumed:
                        continue
            return body       # unsupported use of an inventory var
        if join is None:
            return body
        inv_path, src_leaf = join
        name = f"ij{next(self.serial)}"
        self.spec_inv_joins.append(InvJoinReq(
            name=name, kind=kind, inv_path=inv_path,
            src_path=src_leaf.path, exclude_same_name=guard,
            namespaced_only=namespaced))
        # definedness of the review-side leaf rides the column build
        # (MISSING src never counts); emit the join verdict conjunct
        self.conjuncts.append(self._emit("input", (), (name, "r_bool")))
        self.uses_inventory_lowered = True
        return [lit for i, lit in enumerate(body) if i not in consumed]

    def _lower_literal(self, lit: Literal, used_later: set) -> None:
        if lit.withs:
            raise CannotLower("with modifier")
        e = lit.expr
        if isinstance(e, SomeDecl):
            for n in e.names:
                self.env.pop(n, None)
            return
        # constant / constraint-only literals: fold or host-evaluate
        d = self._lit_deps(lit, frozenset())
        for v in list(d.env_vars):
            d.merge(self._sym_deps(self.env[v]))
        if d.const_only and not isinstance(e, Assign):
            self._fold_const_literal(lit)
            return
        if d.constraint_only and not isinstance(e, Assign):
            self._cvalid_literal(lit, tuple(sorted(d.env_vars)))
            return

        if isinstance(e, Assign):
            self._lower_assign(e, lit, used_later)
            return
        if isinstance(e, Compare):
            nid = self._emit_compare(e.op, e.lhs, e.rhs)
            self.conjuncts.append(self._emit("not", (nid,)) if lit.negated else nid)
            return
        # plain term statement
        if lit.negated:
            ekn = self._try_elem_key_missing(e)
            if ekn is not None:
                self.conjuncts.append(ekn)
                return
        sym = self._lower_value(e)
        nid = self._as_conjunct(sym, negated=lit.negated)
        if nid is not None:
            self.conjuncts.append(nid)

    def _fold_const_literal(self, lit: Literal) -> None:
        ctx = self.interp._ctx(UNDEFINED, None, None)
        fired = False
        for _ in self.interp._eval_literal(ctx, lit, {}):
            fired = True
            break
        if not fired:
            raise _RuleNeverFires()

    def _cvalid_literal(self, lit: Literal, env_vars: tuple[str, ...]) -> None:
        """Constraint-only literal -> per-constraint bool node.  Emitted
        as a rule conjunct (NOT folded into the global validity vector:
        that would suppress *other* rules of the template for constraints
        failing this rule's condition)."""
        name = f"cb{next(self.serial)}"
        interp = self.interp
        env_map = dict(self.env)
        self._check_cenv(env_vars, env_map)

        def fn(c, _lit=lit, _ev=env_vars, _em=env_map):
            env = self._ceval_env(self._cinput(c), _ev, _em)
            if env is None:
                # an earlier constraint-only assignment was undefined: the
                # rule cannot fire for this constraint
                return None
            ctx = interp._ctx(self._cinput(c), None, None)
            for _ in interp._eval_literal(ctx, _lit, env):
                return True
            return False

        self.cvals.append(CValReq(name, "bool", fn))
        self.conjuncts.append(self._emit("input", (), (name, "c_bool")))

    # -- assignment ----------------------------------------------------

    def _lower_assign(self, e: Assign, lit: Literal, used_later: set) -> None:
        lhs, rhs = e.lhs, e.rhs
        if not isinstance(lhs, Var):
            if isinstance(rhs, Var) and e.op == "=":
                lhs, rhs = rhs, lhs
            else:
                # ground unification -> equality conjunct
                nid = self._emit_compare("==", e.lhs, e.rhs)
                self.conjuncts.append(
                    self._emit("not", (nid,)) if lit.negated else nid)
                return
        if lit.negated:
            raise CannotLower("negated assignment")
        var = lhs.name
        if not lhs.is_wildcard and var not in used_later:
            # feeds only the head (msg/details) — host formats those; but
            # an undefined leaf inside the rhs would have failed the
            # assignment, so keep definedness conjuncts (exact: outside
            # comprehensions, an undefined ref makes the whole term
            # undefined in the oracle's _eval_term)
            for leaf in self._direct_leaves(rhs):
                if leaf.root in self._retired_axes:
                    # parent-axis field feeding only the head: skip the
                    # definedness conjunct (over-approximation — host
                    # re-eval filters pairs whose msg is undefined)
                    continue
                self.conjuncts.append(self._emit_leaf(leaf, "present"))
            return
        sym = self._rhs_sym(rhs)
        if not lhs.is_wildcard:
            self.env[var] = sym
        elif isinstance(sym, (SLeaf, SLeafExpr)):
            # wildcard assign still requires definedness
            nid = self._as_conjunct(sym)
            if nid is not None:
                self.conjuncts.append(nid)

    def _direct_leaves(self, term) -> set[LeafId]:
        """Leaves referenced outside comprehension bodies (whose
        undefinedness fails the enclosing term rather than being
        swallowed by an empty comprehension)."""
        out: set[LeafId] = set()
        if isinstance(term, Comprehension):
            return out
        if isinstance(term, Var):
            sym = self.env.get(term.name)
            if isinstance(sym, SLeaf):
                out.add(sym.leaf)
            return out
        if isinstance(term, Ref):
            leaf = _resolve_ref_leaf(term, self.axes, self.env)
            if leaf is not None:
                out.add(leaf)
            return out
        if isinstance(term, Call):
            for a in term.args:
                out |= self._direct_leaves(a)
        elif isinstance(term, BinOp):
            out |= self._direct_leaves(term.lhs)
            out |= self._direct_leaves(term.rhs)
        elif isinstance(term, UnaryMinus):
            out |= self._direct_leaves(term.operand)
        elif isinstance(term, (ArrayTerm, SetTerm)):
            for t in term.items:
                out |= self._direct_leaves(t)
        elif isinstance(term, ObjectTerm):
            for k, v in term.pairs:
                out |= self._direct_leaves(k)
                out |= self._direct_leaves(v)
        return out

    def _rhs_sym(self, rhs: Term) -> Sym:
        # element iteration: x := input.review.object.<base>[_]
        elem = self._try_elem_binding(rhs)
        if elem is not None:
            return elem
        elem = self._try_nested_elem(rhs)
        if elem is not None:
            return elem
        # constraint-list iteration: p := input.constraint...xs[_]
        it = self._try_citer(rhs)
        if it is not None:
            return it
        kl = self._try_keyed_lookup(rhs)
        if kl is not None:
            return kl
        return self._lower_value(rhs)

    def _try_elem_binding(self, rhs: Term) -> Sym | None:
        if not isinstance(rhs, Ref):
            return None
        if not (isinstance(rhs.base, Var) and rhs.base.name == "input"):
            return None
        path = rhs.path
        if len(path) < 3 or not all(isinstance(p, Scalar) for p in path[:-1]):
            return None
        if not (path[0].value == "review" and path[1].value == "object"):
            return None
        last = path[-1]
        if not (isinstance(last, Var) and (last.is_wildcard
                or (last.name not in self.env and last.name not in self.interp.rules))):
            return None
        if not last.is_wildcard:
            # a named index var would bind the position; only `[_]` is
            # supported (what the library templates use)
            raise CannotLower("named index var in element iteration")
        base = tuple(p.value for p in path[2:-1])
        if not base:
            raise CannotLower("iteration directly over review.object")
        axis = ".".join(base)
        if self.elem is not None and self.elem[0] != axis:
            raise CannotLower("multiple element axes in one rule")
        self.elem = (axis, base)
        self.axes[axis] = base
        return SLeaf(LeafId(axis, ()))

    def _try_nested_elem(self, rhs: Term) -> Sym | None:
        """``x := <elem-var>.<path>[_]`` — nested list iteration under an
        element binding (``containers[_].env[_]``), lowered as ONE
        flattened element axis (prep flattens at the ``"*"`` segment).
        The parent axis then carries no device columns in this rule:
        parent fields may feed the head (host-formatted, presence
        over-approximated) but not conjuncts."""
        if not isinstance(rhs, Ref) or not isinstance(rhs.base, Var):
            return None
        sym = self.env.get(rhs.base.name)
        if not isinstance(sym, SLeaf) or sym.leaf.root in ("obj", "meta"):
            return None
        path = rhs.path
        if not path:
            return None
        last = path[-1]
        if not (isinstance(last, Var) and last.is_wildcard):
            return None
        if not all(isinstance(p, Scalar) for p in path[:-1]):
            raise CannotLower("computed key in nested iteration")
        parent_key = sym.leaf.root
        if parent_key in self._rule_axis_leaves:
            # a conjunct of THIS rule already emitted a device column on
            # the parent axis (other rules' columns don't conflict —
            # each rule reduces over its own elem_axis)
            raise CannotLower("parent-axis leaf before nested iteration")
        rel = sym.leaf.path + tuple(p.value for p in path[:-1])
        if not rel:
            raise CannotLower("nested iteration directly over the element")
        base = self.axes[parent_key] + ("*",) + rel
        key = ".".join(base)
        if self.elem is not None and self.elem[0] not in (parent_key, key):
            raise CannotLower("multiple element axes in one rule")
        self.elem = (key, base)
        self.axes[key] = base
        self._retired_axes.add(parent_key)
        return SLeaf(LeafId(key, ()))

    def _try_elem_key_missing(self, e: Term) -> int | None:
        """``not <elem>[<probe>]`` with probe := params[_] — fires iff
        SOME required key fails the coll[key] statement for the element
        (the K8sRequiredProbes pattern; `not` applies per generator
        binding of probe).  Exact for every element type: prep mirrors
        the oracle's coll[key] semantics (dict -> truthy string key,
        list -> truthy int index, other -> undefined); the device does
        a B x ~ekm matmul over the key axis.  This node is consumed
        directly as a conjunct — it must NOT be re-negated (that would
        need the all-keys-present dual, not `not` of this node)."""
        if not (isinstance(e, Ref) and isinstance(e.base, Var)
                and len(e.path) == 1 and isinstance(e.path[0], Var)):
            return None
        esym = self.env.get(e.base.name)
        if not (isinstance(esym, SLeaf) and esym.leaf.root not in ("obj", "meta")
                and esym.leaf.path == ()):
            return None
        ksym = self.env.get(e.path[0].name)
        if not isinstance(ksym, SCIter):
            return None
        axis = esym.leaf.root
        if axis in self._retired_axes:
            raise CannotLower("conjunct on the parent of a nested axis")
        self._rule_axis_leaves.add(axis)
        csname = self._make_cset(ksym.term, ksym.env_vars, iterate=True,
                                 encode="str")
        ekname = f"ek{next(self.serial)}"
        self.elem_keys.append(ElemKeysReq(ekname, csname, axis))
        nid = self._emit("elem_keys_missing", (), (csname, ekname))
        # the node is existential over the probe bindings: negating it
        # computes all-present, NOT per-binding not-not — any enclosing
        # negation (e.g. `not f(c, p)` around an inlined clause) must
        # refuse and take the scalar fallback
        self._no_negate_nodes.add(nid)
        return nid

    def _try_keyed_lookup(self, rhs: Term) -> Sym | None:
        """``value := <review.object path>[key]`` with a constraint-only
        key var — per-(constraint, row) dynamic dict lookup, lowered to
        the keyed_val op over a [needed_keys, rows] value-id matrix
        (ir/prep.KeyedValReq).  Exact: values are val-encoded
        (compounds included) and definedness tracks both the
        constraint's key and the row's entry."""
        if not isinstance(rhs, Ref) or not isinstance(rhs.base, Var) \
                or rhs.base.name != "input":
            return None
        path = rhs.path
        if len(path) < 4:
            return None
        if not (isinstance(path[0], Scalar) and path[0].value == "review"
                and isinstance(path[1], Scalar) and path[1].value == "object"):
            return None
        last = path[-1]
        if not (isinstance(last, Var) and not last.is_wildcard):
            return None
        ksym = self.env.get(last.name)
        if not isinstance(ksym, (SCTerm, SConst)):
            return None
        mid = path[2:-1]
        if not all(isinstance(p, Scalar) and isinstance(p.value, str)
                   for p in mid):
            return None
        dict_path = tuple(p.value for p in mid)
        if isinstance(ksym, SConst) and isinstance(ksym.value, str):
            # statically-known string key: identical to labels["env"],
            # which the leaf machinery already handles (deduped column)
            return SLeaf(LeafId("obj", dict_path + (ksym.value,)))
        name = f"kl{next(self.serial)}"
        if isinstance(ksym, SConst):
            v = ksym.value

            def key_fn(c, _v=v):
                return _v
        else:
            env_map = dict(self.env)
            self._check_cenv(ksym.env_vars, env_map)

            def key_fn(c, _t=ksym.term, _ev=ksym.env_vars, _em=env_map):
                val = self._ceval_term(self._cinput(c), _t, _ev, _em)
                return _thaw_scalar(val) if val is not UNDEFINED else None

        self.keyed_vals.append(KeyedValReq(name, dict_path, key_fn))
        nid = self._emit("keyed_val", (), (name,))
        return SNode(nid, "id_val")

    def _try_citer(self, rhs: Term) -> Sym | None:
        if not isinstance(rhs, Ref):
            return None
        if not (isinstance(rhs.base, Var) and rhs.base.name == "input"):
            return None
        path = rhs.path
        if len(path) < 2 or not isinstance(path[0], Scalar) \
                or path[0].value != "constraint":
            return None
        last = path[-1]
        if not (isinstance(last, Var) and (last.is_wildcard
                or last.name not in self.env)):
            return None
        if not all(isinstance(p, Scalar) for p in path[:-1]):
            return None
        return SCIter(rhs, ())

    # -- value lowering ------------------------------------------------

    def _lower_value(self, term: Term) -> Sym:
        # a var bound to a constraint-list iterator stays an iterator
        # (the membership/ptable recognizers consume it); wrapping it as
        # a plain constraint term would lose the per-element semantics
        if isinstance(term, Var) and isinstance(self.env.get(term.name), SCIter):
            return self.env[term.name]
        d = self._deps(term)
        for v in list(d.env_vars):
            d.merge(self._sym_deps(self.env[v]))
        if d.const_only:
            # lower-time evaluation: the current rule env is the right scope
            v = self._ceval_term(freeze({}), term, tuple(sorted(d.env_vars)),
                                 self.env)
            if v is UNDEFINED:
                raise _RuleNeverFires()
            sv = _thaw_scalar(v)
            if sv is None and v is not None:
                # compound constant (sets/objects): keep as SCTerm
                return SCTerm(term, tuple(sorted(d.env_vars)))
            return SConst(sv)
        if d.constraint_only:
            return SCTerm(term, tuple(sorted(d.env_vars)))

        if isinstance(term, Var):
            sym = self.env.get(term.name)
            if sym is None:
                raise CannotLower(f"unbound var {term.name}")
            return sym
        if isinstance(term, Ref):
            leaf = _resolve_ref_leaf(term, self.axes, self.env)
            if leaf is not None:
                return SLeaf(leaf)
            memb = self._try_cset_member_ref(term)
            if memb is not None:
                return memb
            raise CannotLower("unresolvable reference")
        if isinstance(term, Comprehension):
            pat = self._try_label_keys(term)
            if pat is not None:
                return pat
            pat = self._try_param_pred(term)
            if pat is not None:
                return pat
            raise CannotLower("unrecognized comprehension")
        if isinstance(term, BinOp):
            return self._lower_binop(term, d)
        if isinstance(term, Call):
            return self._lower_call(term, d)
        if isinstance(term, UnaryMinus):
            a = self._as_num(self._lower_value(term.operand))
            zero = self._emit("const", (), (0.0, "float32"))
            return SNode(self._emit("arith", (zero, a), ("-",)), "num")
        raise CannotLower(f"cannot lower {type(term).__name__}")

    def _lower_binop(self, term: BinOp, d: _Deps) -> Sym:
        if term.op == "-":
            ls = self._lower_value(term.lhs)
            rs = self._lower_value(term.rhs)
            if isinstance(rs, SLabelKeys) and isinstance(ls, (SCTerm, SConst)):
                cs = ls if isinstance(ls, SCTerm) else SCTerm(term.lhs, ())
                return SSetDiff(cset=cs, keys=rs)
            a, b = self._as_num(ls), self._as_num(rs)
            return SNode(self._emit("arith", (a, b), ("-",)), "num")
        if term.op in ("+", "*", "/"):
            a = self._as_num(self._lower_value(term.lhs))
            b = self._as_num(self._lower_value(term.rhs))
            return SNode(self._emit("arith", (a, b), (term.op,)), "num")
        raise CannotLower(f"binop {term.op}")

    def _lower_call(self, term: Call, d: _Deps) -> Sym:
        name = term.name
        if name == ("count",):
            inner = self._lower_value(term.args[0])
            return SCount(inner)
        if name in (("any",), ("all",)):
            inner = self._lower_value(term.args[0])
            if isinstance(inner, SParamPred):
                return SNode(self._ptable_node(
                    inner.leaf, inner.pred_term, inner.pvar,
                    inner.iter_term, inner.iter_env,
                    mode="any" if name == ("any",) else "all"), "bool")
            raise CannotLower("any/all of unrecognized collection")
        # functions that path-extend their args (missing(obj, field) does
        # `obj[field]`) receive compound values — a unique-value table
        # over a scalar column would under-approximate; inline instead
        if len(name) == 1 and name[0] in self.interp.rules \
                and self._function_extends_args(name[0]):
            return self._inline_function(term)
        # single-leaf expression -> host table
        if len(d.leaves) == 1 and not d.constraint and not d.device:
            leaf = next(iter(d.leaves))
            if leaf.path == () and leaf.root in ("obj",):
                raise CannotLower("whole-object host table")
            return SLeafExpr(self._to_leaf_expr(term, leaf), leaf)
        # (leaf, constraint-iterator) predicate -> parametric table
        if len(d.leaves) == 1 and d.constraint:
            leaf = next(iter(d.leaves))
            pred = self._try_mixed_pred(term, leaf)
            if pred is not None:
                return pred
        # user function with compound args: symbolic inlining
        if len(name) == 1 and name[0] in self.interp.rules:
            return self._inline_function(term)
        raise CannotLower(f"call {'.'.join(name)} with mixed dependencies")

    def _try_mixed_pred(self, term: Call, leaf: LeafId) -> Sym | None:
        """Call referencing one leaf and constraint-only parts.  If the
        constraint parts are (a) a single iterating var (SCIter) or (b)
        plain constraint terms, rewrite to a parametric table keyed by a
        synthetic param var."""
        cvars = set()
        _collect_vars(term, cvars)
        iter_vars = [v for v in cvars
                     if isinstance(self.env.get(v), SCIter)]
        if len(iter_vars) == 1:
            v = iter_vars[0]
            it: SCIter = self.env[v]  # type: ignore[assignment]
            pred = self._to_leaf_expr(term, leaf)
            return SParamPred(iter_term=it.term, iter_env=it.env_vars,
                              pvar=v, pred_term=pred, leaf=leaf,
                              origin="gen")
        if len(iter_vars) > 1:
            raise CannotLower("two constraint iterators in one predicate")
        # plain constraint subterms: single-param table (param per constraint)
        cargs = [a for a in term.args
                 if self._deps(a).constraint and not self._deps(a).leaves]
        if len(cargs) == 1:
            carg = cargs[0]
            dv = self._deps(carg)
            pvar = "__param0__"
            pred = self._to_leaf_expr(_subst_call_arg(term, carg, Var(pvar)), leaf)
            wrapped = ArrayTerm((carg,))  # iterate a singleton list
            return SParamPred(iter_term=Ref(wrapped, (Var("$p"),)),
                              iter_env=tuple(sorted(dv.env_vars)),
                              pvar=pvar, pred_term=pred, leaf=leaf,
                              origin="local")
        return None

    def _inline_function(self, term: Call) -> Sym:
        """Predicate-position inlining of a user function: OR over
        clauses of AND over lowered body conjuncts.  Head values are
        ignored (over-approximation: a clause whose head value would be
        `false` still counts as firing — host re-eval filters)."""
        if self._inline_depth >= _MAX_INLINE_DEPTH:
            raise CannotLower("inline depth exceeded")
        fname = term.name[0]
        chains = [r for r in self.interp.rules.get(fname, [])
                  if r.kind == "function" and len(r.args or ()) == len(term.args)]
        if not chains:
            raise CannotLower(f"no matching clauses for {fname}")
        # flatten else chains: in predicate position only definedness
        # matters, and a chain is defined iff ANY clause body succeeds
        # (b1 OR (not b1 AND b2) == b1 OR b2 — the prefix negation is
        # absorbed by the OR).  Which clause supplies the value is a
        # head-value question, covered by the inexact over-approximation
        # below exactly as for multi-clause functions.
        rules = []
        for clause in chains:
            while clause is not None:
                rules.append(clause)
                clause = clause.els
        self._inline_depth += 1
        outer_inexact = self._subtree_inexact
        self._subtree_inexact = False
        try:
            clause_nodes: list[int] = []
            for rule in rules:
                mapping: dict[str, Term] = {}
                guards: list[tuple[Term, Term]] = []
                ok = True
                for param, arg in zip(rule.args or (), term.args):
                    if isinstance(param, Var):
                        mapping[param.name] = arg
                    elif isinstance(param, Scalar):
                        guards.append((param, arg))
                    else:
                        ok = False
                        break
                if not ok:
                    raise CannotLower("destructuring function params")
                nid = self._inline_clause(rule, mapping, guards)
                if nid is not None:
                    clause_nodes.append(nid)
            if not clause_nodes:
                raise _RuleNeverFires()
            # a clause with a computed head value fires even where the
            # head would be `false` — over-approximation
            own_inexact = any(
                r.value is not None
                and not (isinstance(r.value, Scalar) and r.value.value is True)
                for r in rules)
            inexact = own_inexact or self._subtree_inexact
            self._subtree_inexact = inexact   # propagate to enclosing inline
            out = clause_nodes[0]
            for nid in clause_nodes[1:]:
                out = self._emit("or", (out, nid))
            if any(nid in self._no_negate_nodes for nid in clause_nodes):
                self._no_negate_nodes.add(out)
            return SNode(out, "bool", exact=not inexact)
        finally:
            self._inline_depth -= 1
            self._subtree_inexact = outer_inexact or self._subtree_inexact

    def _inline_clause(self, rule: Rule, mapping: dict,
                       guards: list[tuple[Term, Term]]) -> int | None:
        """AND-node of the clause body with args substituted; None if the
        clause can never fire (constant-false guard)."""
        parts: list[int] = []
        saved = (self.conjuncts, self.env)
        self.conjuncts = []
        self.env = dict(saved[1])
        try:
            for lit_pat, arg in guards:
                nid = self._emit_compare("==", lit_pat, arg)
                self.conjuncts.append(nid)
            for lit in rule.body:
                self._lower_literal(_subst_lit(lit, mapping), used_later=_ALL_VARS)
            parts = self.conjuncts
        except _RuleNeverFires:
            return None
        finally:
            self.conjuncts, self.env = saved
        if not parts:
            return self._emit("const", (), (True, "bool"))
        out = parts[0]
        for nid in parts[1:]:
            out = self._emit("and", (out, nid))
        if any(nid in self._no_negate_nodes for nid in parts):
            self._no_negate_nodes.add(out)
        return out

    # -- comparisons ---------------------------------------------------

    def _emit_compare(self, op: str, lhs: Term, rhs: Term) -> int:
        if op not in CMP_OPS:
            raise CannotLower(f"comparison {op}")
        ls = self._lower_value(lhs)
        rs = self._lower_value(rhs)
        # count(set-diff) vs 0 — the required-labels fusion
        fused = self._try_setdiff_cmp(op, ls, rs)
        if fused is not None:
            return fused
        # membership: leaf ==/in constraint-iterated list
        memb = self._try_membership_cmp(op, ls, rs)
        if memb is not None:
            return memb
        if op in ("<", "<=", ">", ">="):
            return self._emit("cmp", (self._as_num(ls), self._as_num(rs)), (op,))
        # equality: numbers compare numerically when either side is
        # device-num; otherwise type-aware via encoded-value ids
        if _surely_num(ls) or _surely_num(rs):
            return self._emit("cmp", (self._as_num(ls), self._as_num(rs)), (op,))
        ns = "str" if _has_meta(ls) or _has_meta(rs) else "val"
        return self._emit("cmp", (self._as_id(ls, ns), self._as_id(rs, ns)), (op,))

    def _try_setdiff_cmp(self, op: str, ls: Sym, rs: Sym) -> int | None:
        def fuse(count_sym, const_sym, cop):
            if not (isinstance(count_sym, SCount)
                    and isinstance(count_sym.inner, SSetDiff)
                    and isinstance(const_sym, SConst)):
                return None
            diff: SSetDiff = count_sym.inner
            c = const_sym.value
            nonempty = {(">", 0), ("!=", 0), (">=", 1)}
            empty = {("==", 0), ("<=", 0), ("<", 1)}
            if (cop, c) in nonempty:
                node_op = "cset_not_subset_memb"
            elif (cop, c) in empty:
                node_op = "cset_subset_memb"
            else:
                raise CannotLower(f"count() compared with {cop} {c!r}")
            cs = diff.cset
            csname = self._make_cset(cs.term, cs.env_vars, iterate=False,
                                     encode="str")
            mname = f"m{next(self.serial)}"
            self.membs.append(MembReq(mname, csname, diff.keys.path))
            return self._emit(node_op, (), (csname, mname))

        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "==", "!=": "!="}
        out = fuse(ls, rs, op)
        if out is not None:
            return out
        return fuse(rs, ls, flip[op])

    def _try_membership_cmp(self, op: str, ls: Sym, rs: Sym) -> int | None:
        if isinstance(ls, SCIter) and not isinstance(rs, SCIter):
            ls, rs = rs, ls
        if not isinstance(rs, SCIter):
            return None
        if op != "==":
            raise CannotLower(f"iterated comparison {op}")
        if isinstance(ls, SLeaf):
            ns = "str" if ls.leaf.root == "meta" else "val"
            idx = self._emit_leaf(ls.leaf, ns)
        elif isinstance(ls, SLeafExpr):
            ns = "val"
            idx = self._table_node(ls, "id_val")
        else:
            raise CannotLower("membership lhs not leaf-like")
        csname = self._make_cset(rs.term, rs.env_vars, iterate=True, encode=ns)
        return self._emit("in_cset", (idx,), (csname,))

    # -- comprehension patterns ----------------------------------------

    def _try_cset_member_ref(self, term: Ref) -> Sym | None:
        """``<constraint-set>[<leaf>]`` -> in_cset membership node (the
        K8sExternalIPs / allowed-set pattern).  Rego set[x] as a
        statement fires iff x ∈ set AND the member is truthy; literal
        ``false`` members are dropped from the device set so both
        polarities stay exact (a false member can never fire the
        statement in the oracle either)."""
        if not (isinstance(term.base, Var) and len(term.path) == 1):
            return None
        bsym = self.env.get(term.base.name)
        if not isinstance(bsym, SCTerm):
            return None
        key = term.path[0]
        ks: Sym | None = None
        if isinstance(key, Var):
            ks = self.env.get(key.name)
        elif isinstance(key, Ref):
            kleaf = _resolve_ref_leaf(key, self.axes, self.env)
            if kleaf is not None:
                ks = SLeaf(kleaf)
        if isinstance(ks, SNode) and ks.kind == "id_val":
            ns = "val"
            idx = ks.nid
        elif isinstance(ks, SLeaf):
            ns = "str" if ks.leaf.root == "meta" else "val"
            idx = self._emit_leaf(ks.leaf, ns)
        elif isinstance(ks, SLeafExpr):
            ns = "val"
            idx = self._table_node(ks, "id_val")
        else:
            return None
        csname = self._make_cset(bsym.term, bsym.env_vars, iterate=False,
                                 encode=ns, member_ref=True)
        return SNode(self._emit("in_cset", (idx,), (csname,)), "bool")

    def _try_label_keys(self, term: Comprehension) -> Sym | None:
        """{k | input.review.object.<path>[k]} -> ragged key set."""
        if term.kind != "set" or len(term.body) != 1 or len(term.head) != 1:
            return None
        head = term.head[0]
        lit = term.body[0]
        if lit.negated or lit.withs or not isinstance(head, Var):
            return None
        e = lit.expr
        if not isinstance(e, Ref) or not isinstance(e.base, Var) \
                or e.base.name != "input":
            return None
        path = e.path
        if len(path) < 3 or not all(isinstance(p, Scalar) for p in path[:-1]):
            return None
        if path[0].value != "review" or path[1].value != "object":
            return None
        last = path[-1]
        if not (isinstance(last, Var) and last.name == head.name):
            return None
        return SLabelKeys(tuple(p.value for p in path[2:-1]))

    def _try_param_pred(self, term: Comprehension) -> Sym | None:
        """[g | p = <citer>; g = pred(leaf, p)] (array or set)."""
        if term.kind not in ("array", "set") or len(term.head) != 1:
            return None
        if len(term.body) != 2 or not isinstance(term.head[0], Var):
            return None
        gname = term.head[0].name
        litA, litB = term.body
        if litA.negated or litB.negated or litA.withs or litB.withs:
            return None
        a, b = litA.expr, litB.expr
        if not (isinstance(a, Assign) and isinstance(b, Assign)):
            return None

        def norm(asg: Assign) -> tuple[str, Term] | None:
            if isinstance(asg.lhs, Var):
                return asg.lhs.name, asg.rhs
            if isinstance(asg.rhs, Var) and asg.op == "=":
                return asg.rhs.name, asg.lhs
            return None

        na, nb = norm(a), norm(b)
        if na is None or nb is None:
            return None
        # one binds the iterator, the other binds the head var to the pred
        for (v1, t1), (v2, t2) in ((na, nb), (nb, na)):
            it = self._try_citer(t1)
            if it is None or v2 != gname:
                continue
            d = self._deps(t2, bound=frozenset({v1}))
            for ev in list(d.env_vars):
                d.merge(self._sym_deps(self.env[ev]))
            if len(d.leaves) != 1 or d.device or d.constraint:
                return None
            leaf = next(iter(d.leaves))
            pred = self._to_leaf_expr(t2, leaf)
            return SParamPred(iter_term=it.term, iter_env=it.env_vars,
                              pvar=v1, pred_term=pred, leaf=leaf,
                              origin="compr")
        return None


def _surely_num(sym: Sym) -> bool:
    if isinstance(sym, SNode):
        return sym.kind == "num"
    if isinstance(sym, SCount):
        return True
    return False


def _has_meta(sym: Sym) -> bool:
    return isinstance(sym, SLeaf) and sym.leaf.root == "meta"


def _subst_call_arg(term: Call, target: Term, replacement: Term) -> Call:
    return Call(term.name, tuple(replacement if a is target else a
                                 for a in term.args))


def lower_template(module: Module, interp: Interpreter) -> LoweredProgram:
    """Lower every violation rule; CannotLower propagates (the driver
    catches it and uses the scalar fallback for the whole template —
    partial lowering would still require full scalar evaluation of the
    unlowered rules, defeating the point)."""
    lw = Lowerer(module, interp)
    out = lw.lower()
    if out.n_rules_lowered < out.n_rules_total and out.n_rules_lowered >= 0:
        # rules dropped by _RuleNeverFires are exact (they can never
        # fire); CannotLower would have raised instead
        pass
    return out


def _thaw_scalar(v):
    from gatekeeper_tpu_torch.rego.values import Obj
    if isinstance(v, (Obj, tuple, frozenset)):
        return None
    return v


def _replace_leaf_refs(term, leaf: LeafId, axes: dict, env: dict):
    """Rewrite syntactic refs that resolve to `leaf` with __leaf0__
    (input.review.object.<path> or <elemvar>.<path>)."""
    if isinstance(term, Ref):
        resolved = _resolve_ref_leaf(term, axes, env)
        if resolved == leaf:
            return Var("__leaf0__")
    if isinstance(term, Call):
        return Call(term.name, tuple(_replace_leaf_refs(a, leaf, axes, env)
                                     for a in term.args))
    if isinstance(term, BinOp):
        return BinOp(term.op, _replace_leaf_refs(term.lhs, leaf, axes, env),
                     _replace_leaf_refs(term.rhs, leaf, axes, env))
    if isinstance(term, UnaryMinus):
        return UnaryMinus(_replace_leaf_refs(term.operand, leaf, axes, env))
    if isinstance(term, (ArrayTerm, SetTerm)):
        ctor = ArrayTerm if isinstance(term, ArrayTerm) else SetTerm
        return ctor(tuple(_replace_leaf_refs(t, leaf, axes, env) for t in term.items))
    if isinstance(term, ObjectTerm):
        return ObjectTerm(tuple((_replace_leaf_refs(k, leaf, axes, env),
                                 _replace_leaf_refs(v, leaf, axes, env))
                                for k, v in term.pairs))
    return term


def _resolve_ref_leaf(term: Ref, axes: dict, env: dict) -> LeafId | None:
    base = term.base
    scal = tuple(p.value for p in term.path if isinstance(p, Scalar))
    if len(scal) != len(term.path):
        return None
    if isinstance(base, Var) and base.name == "input":
        if len(scal) >= 2 and scal[0] == "review" and scal[1] == "object":
            return LeafId("obj", scal[2:])
        if scal and scal[0] == "review" and scal[1:] in META_PATHS:
            return LeafId("meta", scal[1:])
        return None
    if isinstance(base, Var):
        sym = env.get(base.name)
        if isinstance(sym, SLeaf):
            return LeafId(sym.leaf.root, sym.leaf.path + scal)
    return None
