# Copied from gatekeeper_tpu/rego/closures.py for the PyTorch port.
"""Closure compilation for the scalar engine's hot path.

The tree-walking interpreter (interp.py) re-decides every structural
question — node class dispatch, constant canonicalization, builtin
resolution, ref-path shape — on every evaluation.  Admission serves one
interpreted evaluation per (review, constraint) pair, so on a
single-core host the interpreter IS the admission throughput ceiling.

This module pre-compiles each rule body into a tree of Python closures:
every AST node becomes one closure with its branch decisions, constants,
and builtin lookups resolved at compile time.  It is the scalar
counterpart of the reference's own "compile the policy" precedent
(OPA's planner/IR/wasm pipeline, internal/planner/planner.go:20) — aimed
at CPython instead of Wasm, exactly as the device engine aims at XLA.

Semantics are transcribed branch-for-branch from interp.py, which
remains the oracle: tests/test_closures.py runs the full template
library and fuzz corpus through both paths and requires identical
results.  ``GATEKEEPER_NO_CLOSURES=1`` disables compilation (the
interpreter then runs its original recursive path).

Closure protocol:
  term closure:    f(ctx, env) -> iterator of (value, env)
  body closure:    f(ctx, env) -> iterator of env
  pattern closure: f(ctx, value, env) -> iterator of env
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

from gatekeeper_tpu_torch.analysis.purity import is_impure_call
from gatekeeper_tpu_torch.errors import EvalError
from gatekeeper_tpu_torch.rego import builtins as bi
from gatekeeper_tpu_torch.rego.ast_nodes import (
    ArrayTerm, Assign, BinOp, Call, Compare, Comprehension, Literal,
    ObjectTerm, Ref, Scalar, SetTerm, SomeDecl, Term, UnaryMinus, Var,
)
from gatekeeper_tpu_torch.rego.values import Obj, canon_num, is_truthy

UNDEFINED = bi.UNDEFINED


def _get_miss():
    # the ONE miss sentinel: _walk_const returns interp's _MISS — a
    # second sentinel here would compare unequal and leak as a value
    from gatekeeper_tpu_torch.rego.interp import _MISS
    return _MISS


_MISS = _get_miss()

_BUILTIN_ERRORS = (bi.BuiltinError, TypeError, ValueError, KeyError,
                   IndexError, ZeroDivisionError)


class ClosureCompiler:
    """Compiles bodies/terms of one Interpreter's module to closures.

    Holds no evaluation state: everything dynamic (documents, memo,
    tracer) still rides the interpreter's _Ctx, and rule/function
    evaluation delegates back to the interpreter (whose _eval_body
    re-enters compiled bodies, so recursion stays compiled)."""

    def __init__(self, interp):
        self.interp = interp
        self._bodies: dict[int, Callable] = {}
        self._terms: dict[int, Callable] = {}
        self._patterns: dict[int, Callable] = {}

    # -- caches -----------------------------------------------------------

    def body(self, body: tuple) -> Callable:
        fn = self._bodies.get(id(body))
        if fn is None:
            fn = self._compile_body(body)
            self._bodies[id(body)] = fn
        return fn

    def term(self, term: Term) -> Callable:
        fn = self._terms.get(id(term))
        if fn is None:
            fn = self._compile_term(term)
            self._terms[id(term)] = fn
        return fn

    def pattern(self, term: Term) -> Callable:
        fn = self._patterns.get(id(term))
        if fn is None:
            fn = self._compile_pattern(term)
            self._patterns[id(term)] = fn
        return fn

    # -- bodies / literals ------------------------------------------------

    def _compile_body(self, body: tuple) -> Callable:
        lits = [self._compile_literal(lit) for lit in body]
        if not lits:
            def empty(ctx, env):
                yield env
            return empty
        if len(lits) == 1:
            return lits[0]
        if len(lits) == 2:
            l0, l1 = lits

            def chain2(ctx, env):
                for e1 in l0(ctx, env):
                    yield from l1(ctx, e1)
            return chain2
        if len(lits) == 3:
            l0, l1, l2 = lits

            def chain3(ctx, env):
                for e1 in l0(ctx, env):
                    for e2 in l1(ctx, e1):
                        yield from l2(ctx, e2)
            return chain3
        if len(lits) == 4:
            l0, l1, l2, l3 = lits

            def chain4(ctx, env):
                for e1 in l0(ctx, env):
                    for e2 in l1(ctx, e1):
                        for e3 in l2(ctx, e2):
                            yield from l3(ctx, e3)
            return chain4

        def chain(ctx, env, _lits=tuple(lits)):
            # conjunction: literal i+1 runs under every env literal i
            # yields (interp._eval_body recursion, flattened)
            def rec(i, env):
                if i == len(_lits):
                    yield env
                    return
                for env2 in _lits[i](ctx, env):
                    yield from rec(i + 1, env2)
            return rec(0, env)
        return chain

    def _compile_literal(self, lit: Literal) -> Callable:
        expr = lit.expr
        if isinstance(expr, SomeDecl):
            names = tuple(expr.names)

            def some(ctx, env, _names=names):
                yield {k: v for k, v in env.items() if k not in _names}
            return some
        inner = self._compile_expr(expr)
        if lit.withs:
            interp, withs = self.interp, lit.withs
            plain_inner, negated = inner, lit.negated

            def with_lit(ctx, env):
                ctx2 = interp._apply_withs(ctx, withs, env)
                if ctx2 is None:     # undefined with-value => undefined
                    return
                if negated:
                    for _ in plain_inner(ctx2, env):
                        return
                    yield env
                    return
                yield from plain_inner(ctx2, env)
            return with_lit
        if lit.negated:
            def neg(ctx, env, _inner=inner):
                for _ in _inner(ctx, env):
                    return
                yield env
            return neg
        return inner

    def _compile_expr(self, expr) -> Callable:
        if isinstance(expr, Assign):
            return self._compile_unify(expr.lhs, expr.rhs)
        if isinstance(expr, Compare):
            lhs, rhs = self.term(expr.lhs), self.term(expr.rhs)
            from gatekeeper_tpu_torch.rego.interp import _compare
            op = expr.op

            def cmp(ctx, env):
                for lv, env1 in lhs(ctx, env):
                    for rv, env2 in rhs(ctx, env1):
                        if _compare(op, lv, rv):
                            yield env2
            return cmp
        term = self.term(expr)

        def stmt(ctx, env):
            for v, env2 in term(ctx, env):
                if is_truthy(v):
                    yield env2
        return stmt

    # -- unification ------------------------------------------------------

    def _compile_unify(self, lhs: Term, rhs: Term) -> Callable:
        interp = self.interp
        l_term, r_term = self.term(lhs), self.term(rhs)
        l_pat, r_pat = self.pattern(lhs), self.pattern(rhs)
        from gatekeeper_tpu_torch.rego.interp import _same_kind

        def unify(ctx, env):
            # pattern-ness is env-dependent (a var bound by an earlier
            # loop iteration stops being a binding position), so the
            # branch decision stays at runtime — interp._unify exactly
            if interp._is_pattern(lhs, env):
                for rv, env2 in r_term(ctx, env):
                    yield from l_pat(ctx, rv, env2)
            elif interp._is_pattern(rhs, env):
                for lv, env2 in l_term(ctx, env):
                    yield from r_pat(ctx, lv, env2)
            else:
                for lv, env1 in l_term(ctx, env):
                    for rv, env2 in r_term(ctx, env1):
                        if lv == rv and _same_kind(lv, rv):
                            yield env2

        if lhs.__class__ is Var and lhs.name not in interp.rules:
            # `x := expr` — the overwhelmingly common assignment shape:
            # bind directly while x is unbound; bound x (or a pattern
            # on the rhs) falls back to the generic machinery
            name = lhs.name

            def assign_var(ctx, env):
                if name not in env:
                    for rv, env2 in r_term(ctx, env):
                        env3 = dict(env2)
                        env3[name] = rv
                        yield env3
                    return
                yield from unify(ctx, env)
            return assign_var
        return unify

    def _compile_pattern(self, pat: Term) -> Callable:
        interp = self.interp
        from gatekeeper_tpu_torch.rego.interp import _same_kind
        if isinstance(pat, Var):
            name = pat.name
            is_rule = name in interp.rules

            def var_pat(ctx, value, env):
                bound = env.get(name, _MISS)
                if bound is not _MISS:
                    if bound == value and _same_kind(bound, value):
                        yield env
                elif is_rule:
                    rv = interp._rule_value(ctx, name)
                    if rv is not UNDEFINED and rv == value:
                        yield env
                else:
                    env2 = dict(env)
                    env2[name] = value
                    yield env2
            return var_pat
        if isinstance(pat, ArrayTerm):
            items = tuple(self.pattern(t) for t in pat.items)
            n = len(items)

            def arr_pat(ctx, value, env):
                if isinstance(value, tuple) and len(value) == n:
                    def rec(i, env):
                        if i == n:
                            yield env
                            return
                        for env2 in items[i](ctx, value[i], env):
                            yield from rec(i + 1, env2)
                    yield from rec(0, env)
            return arr_pat
        if isinstance(pat, ObjectTerm):
            pairs = tuple((self.term(k), self.pattern(v))
                          for k, v in pat.pairs)
            n = len(pairs)

            def obj_pat(ctx, value, env):
                # OPA object unification: identical key sets, not subset
                if isinstance(value, Obj) and n == len(value):
                    def rec(i, env):
                        if i == n:
                            yield env
                            return
                        kf, vf = pairs[i]
                        for kv, env1 in kf(ctx, env):
                            if kv in value:
                                for env2 in vf(ctx, value[kv], env1):
                                    yield from rec(i + 1, env2)
                    yield from rec(0, env)
            return obj_pat
        term = self.term(pat)

        def ground_pat(ctx, value, env):
            for pv, env2 in term(ctx, env):
                if pv == value and _same_kind(pv, value):
                    yield env2
        return ground_pat

    # -- terms ------------------------------------------------------------

    def _compile_term(self, term: Term) -> Callable:
        cls = term.__class__
        if cls is Scalar:
            v = term.value
            v = canon_num(v) if isinstance(v, (int, float)) else v

            def const(ctx, env, _v=v):
                yield _v, env
            return const
        if cls is Var:
            return self._compile_var(term)
        if cls is Ref:
            return self._compile_ref(term)
        if cls is ArrayTerm:
            return self._compile_seq(term.items, tuple)
        if cls is SetTerm:
            return self._compile_seq(term.items, frozenset)
        if cls is ObjectTerm:
            pairs = tuple((self.term(k), self.term(v))
                          for k, v in term.pairs)
            n = len(pairs)

            def obj(ctx, env):
                def rec(i, env, acc):
                    if i == n:
                        yield Obj(acc), env
                        return
                    kf, vf = pairs[i]
                    for kv, env1 in kf(ctx, env):
                        for vv, env2 in vf(ctx, env1):
                            yield from rec(i + 1, env2, acc + [(kv, vv)])
                return rec(0, env, [])
            return obj
        if cls is BinOp:
            from gatekeeper_tpu_torch.rego.interp import _binop
            lhs, rhs = self.term(term.lhs), self.term(term.rhs)
            op = term.op

            def binop(ctx, env):
                for lv, env1 in lhs(ctx, env):
                    for rv, env2 in rhs(ctx, env1):
                        v = _binop(op, lv, rv)
                        if v is not UNDEFINED:
                            yield v, env2
            return binop
        if cls is UnaryMinus:
            operand = self.term(term.operand)

            def neg(ctx, env):
                for v, env1 in operand(ctx, env):
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        yield canon_num(-v), env1
            return neg
        if cls is Call:
            return self._compile_call(term)
        if cls is Comprehension:
            return self._compile_comprehension(term)
        interp = self.interp

        def fallback(ctx, env):       # future node kinds: interpreter path
            yield from interp._eval_term(ctx, term, env)
        return fallback

    def _compile_var(self, term: Var) -> Callable:
        interp = self.interp
        name = term.name
        # resolution order mirrors the interpreter exactly:
        # env, then input/data, then rules, then unsafe
        if name == "input":
            def input_var(ctx, env):
                v = env.get(name, _MISS)
                if v is not _MISS:
                    yield v, env
                elif ctx.input is not UNDEFINED:
                    yield ctx.input, env
            return input_var
        if name == "data":
            def data_var(ctx, env):
                v = env.get(name, _MISS)
                yield (v if v is not _MISS else ctx.data), env
            return data_var
        is_rule = name in interp.rules

        def var(ctx, env):
            v = env.get(name, _MISS)
            if v is not _MISS:
                yield v, env
                return
            if is_rule:
                rv = interp._rule_value(ctx, name)
                if rv is not UNDEFINED:
                    yield rv, env
                return
            raise EvalError(f"unsafe variable: {name}")
        return var

    def _compile_ref(self, term: Ref) -> Callable:
        from gatekeeper_tpu_torch.rego.interp import _walk_const
        interp = self.interp
        keys = interp._constpath.get(id(term))
        base = term.base
        if keys is not None and base.__class__ is Var:
            name = base.name
            if name == "input":
                def input_ref(ctx, env, _keys=keys):
                    base_v = env.get(name, _MISS)
                    if base_v is _MISS:
                        if ctx.input is UNDEFINED:
                            return
                        base_v = ctx.input
                    v = _walk_const(base_v, _keys)
                    if v is not _MISS:
                        yield v, env
                return input_ref
            if name == "data":
                def data_ref(ctx, env, _keys=keys):
                    base_v = env.get(name, _MISS)
                    if base_v is _MISS:
                        base_v = ctx.data
                    v = _walk_const(base_v, _keys)
                    if v is not _MISS:
                        yield v, env
                return data_ref

            base_fn = self.term(base)

            def var_ref(ctx, env, _keys=keys):
                v = env.get(name, _MISS)
                if v is not _MISS:
                    v = _walk_const(v, _keys)
                    if v is not _MISS:
                        yield v, env
                    return
                for base_v, env1 in base_fn(ctx, env):
                    v = _walk_const(base_v, _keys)
                    if v is not _MISS:
                        yield v, env1
            return var_ref
        base_fn = self.term(base)
        if keys is not None:
            def const_ref(ctx, env, _keys=keys):
                for base_v, env1 in base_fn(ctx, env):
                    v = _walk_const(base_v, _keys)
                    if v is not _MISS:
                        yield v, env1
            return const_ref
        # general path: fuse maximal constant-key runs into single
        # _walk_const descents; only var/dynamic elements get a step
        # closure (containers[_].image = one iterate + one fused walk)
        steps: list = []
        const_run: list = []
        for op in term.path:
            if op.__class__ is Scalar:
                v = op.value
                const_run.append(canon_num(v) if isinstance(v, (int, float))
                                 else v)
                continue
            if const_run:
                steps.append(("const", tuple(const_run)))
                const_run = []
            steps.append(("step", self._compile_ref_step(op)))
        if const_run:
            steps.append(("const", tuple(const_run)))
        steps_t = tuple(steps)
        # segments alternate const/step by construction; unroll the two
        # dominant shapes: labels[k] (one step) and containers[_].image
        # (step then const run)
        if len(steps_t) == 1 and steps_t[0][0] == "step":
            s0 = steps_t[0][1]

            def walk1(ctx, env):
                for base_v, env1 in base_fn(ctx, env):
                    yield from s0(ctx, base_v, env1)
            return walk1
        if len(steps_t) == 2 and steps_t[0][0] == "step" \
                and steps_t[1][0] == "const":
            s0, keys1 = steps_t[0][1], steps_t[1][1]

            def walk2(ctx, env):
                for base_v, env1 in base_fn(ctx, env):
                    for v2, env2 in s0(ctx, base_v, env1):
                        v3 = _walk_const(v2, keys1)
                        if v3 is not _MISS:
                            yield v3, env2
            return walk2
        if len(steps_t) == 2 and steps_t[0][0] == "const" \
                and steps_t[1][0] == "step":
            keys0, s1 = steps_t[0][1], steps_t[1][1]

            def walk2b(ctx, env):
                for base_v, env1 in base_fn(ctx, env):
                    v2 = _walk_const(base_v, keys0)
                    if v2 is not _MISS:
                        yield from s1(ctx, v2, env1)
            return walk2b

        def walk(ctx, env):
            def rec(i, value, env):
                if i == len(steps_t):
                    yield value, env
                    return
                kind, s = steps_t[i]
                if kind == "const":
                    value = _walk_const(value, s)
                    if value is not _MISS:
                        yield from rec(i + 1, value, env)
                    return
                for v2, env2 in s(ctx, value, env):
                    yield from rec(i + 1, v2, env2)
            for base_v, env1 in base_fn(ctx, env):
                yield from rec(0, base_v, env1)
        return walk

    def _compile_ref_step(self, op: Term) -> Callable:
        """(ctx, value, env) -> iterator of (descended value, env) —
        one element of _walk_ref."""
        interp = self.interp
        maybe_binder = (op.__class__ is Var and op.name not in interp.rules
                        and op.name not in ("input", "data"))
        op_fn = self.term(op)
        name = op.name if maybe_binder else None

        def step(ctx, value, env):
            if maybe_binder and name not in env:
                # unbound var: iterate, binding key/index/member
                if isinstance(value, Obj):
                    for k, v in value.items():
                        env2 = dict(env)
                        env2[name] = k
                        yield v, env2
                elif isinstance(value, tuple):
                    for idx, v in enumerate(value):
                        env2 = dict(env)
                        env2[name] = idx
                        yield v, env2
                elif isinstance(value, frozenset):
                    for m in value:
                        env2 = dict(env)
                        env2[name] = m
                        yield m, env2
                return
            for kv, env2 in op_fn(ctx, env):
                if isinstance(value, Obj):
                    if kv in value:
                        yield value[kv], env2
                elif isinstance(value, tuple):
                    if isinstance(kv, int) and not isinstance(kv, bool) \
                            and 0 <= kv < len(value):
                        yield value[kv], env2
                elif isinstance(value, frozenset):
                    if kv in value:
                        yield kv, env2
        return step

    def _compile_seq(self, items, ctor) -> Callable:
        fns = tuple(self.term(t) for t in items)
        n = len(fns)

        def seq(ctx, env):
            def rec(i, env, acc):
                if i == n:
                    yield ctor(acc), env
                    return
                for v, env2 in fns[i](ctx, env):
                    yield from rec(i + 1, env2, acc + [v])
            return rec(0, env, [])
        return seq

    def _compile_call(self, term: Call) -> Callable:
        interp = self.interp
        name = term.name
        fn = interp._builtinfn.get(id(term))
        args = tuple(self.term(a) for a in term.args)
        if fn is not None:
            if len(args) == 1:
                a0f = args[0]

                def call1(ctx, env, _fn=fn):
                    for a0, env2 in a0f(ctx, env):
                        try:
                            v = _fn(a0)
                        except _BUILTIN_ERRORS:
                            continue
                        if v is not UNDEFINED:
                            yield v, env2
                return call1
            if len(args) == 2:
                a0f, a1f = args

                def call2(ctx, env, _fn=fn):
                    for a0, env1 in a0f(ctx, env):
                        for a1, env2 in a1f(ctx, env1):
                            try:
                                v = _fn(a0, a1)
                            except _BUILTIN_ERRORS:
                                continue
                            if v is not UNDEFINED:
                                yield v, env2
                return call2
            argseq = self._compile_seq(term.args, tuple)

            def calln(ctx, env, _fn=fn):
                for argvals, env2 in argseq(ctx, env):
                    try:
                        v = _fn(*argvals)
                    except _BUILTIN_ERRORS:
                        continue
                    if v is not UNDEFINED:
                        yield v, env2
            return calln
        # special forms and user functions keep the interpreter's exact
        # handling (trace/internal.compare/time.now_ns/walk/user fns and
        # the unknown-function error)
        def special(ctx, env):
            yield from interp._eval_call(ctx, term, env)
        return special

    def _review_shareable(self, term: Comprehension):
        """None, or the sorted free-var names that key a per-review
        shared-memo entry for this comprehension.

        Eligible when evaluation can only depend on (a) input.review
        paths and (b) variables visible in the entry env: no data/
        inventory refs, no input.constraint (or whole-input) refs, no
        rule or user-function references, no trace/clock builtins.
        Every var name mentioned anywhere in the comprehension (except
        wildcards and `input`) goes into the cache key from the ENTRY
        env — vars bound only during body evaluation read as a
        consistent miss sentinel there, and enclosing bindings (which
        may carry constraint-derived values) key the entry correctly."""
        interp = self.interp
        impure = False
        names: set[str] = set()

        def visit(t):
            nonlocal impure
            if impure or t is None:
                return
            cls = t.__class__
            if cls is Var:
                if t.name == "input":
                    # a BARE input var binds the whole document —
                    # including .constraint (the Ref branch below
                    # handles the safe input.review.* base inline, so
                    # this branch only sees whole-input references)
                    impure = True
                    return
                if t.is_wildcard:
                    return
                if t.name in interp.rules:
                    impure = True       # rule value: may read constraint
                else:
                    names.add(t.name)
                return
            if cls is Ref:
                base = t.base
                if base.__class__ is Var:
                    if base.name == "data":
                        impure = True   # inventory / external docs
                        return
                    if base.name == "input":
                        p0 = t.path[0] if t.path else None
                        if not (p0 is not None and p0.__class__ is Scalar
                                and p0.value == "review"):
                            impure = True   # input.constraint / dynamic
                            return
                        for p in t.path:
                            visit(p)
                        return
                visit(base)
                for p in t.path:
                    visit(p)
                return
            if cls is Call:
                nm = t.name
                if is_impure_call(nm, interp.rules):
                    impure = True       # impure builtin (clock/trace/jwt
                    return              # verify) or user function (may
                    #                     read constraint) — one gate
                    #                     shared with the template vetter
                    #                     (analysis/purity.py)
                for a in t.args:
                    visit(a)
                return
            if cls is Scalar:
                return
            if cls is Comprehension:
                for h in t.head:
                    visit(h)
                for lit in t.body:
                    _visit_lit(lit)
                return
            if cls in (ArrayTerm, SetTerm):
                for x in t.items:
                    visit(x)
                return
            if cls is ObjectTerm:
                for k, v in t.pairs:
                    visit(k)
                    visit(v)
                return
            if cls is BinOp:
                visit(t.lhs)
                visit(t.rhs)
                return
            if cls is UnaryMinus:
                visit(t.operand)
                return
            impure = True               # unknown node kind: stay safe

        def _visit_lit(lit):
            nonlocal impure
            if impure:
                return
            if lit.withs:
                impure = True           # document override inside
                return
            e = lit.expr
            if e.__class__ in (Compare, Assign):
                visit(e.lhs)
                visit(e.rhs)
            elif e.__class__ is SomeDecl:
                names.update(e.names)
            else:
                visit(e)

        for h in term.head:
            visit(h)
        for lit in term.body:
            _visit_lit(lit)
        return None if impure else tuple(sorted(names))

    def _memoize_review_pure(self, term: Comprehension,
                             inner: Callable) -> Callable:
        free = self._review_shareable(term)
        if free is None:
            return inner
        tid = id(term)

        def memo(ctx, env):
            cache = ctx.shared
            inp = ctx.input
            rev = inp["review"] if isinstance(inp, Obj) and "review" in inp \
                else _MISS
            if cache is None or rev is _MISS:
                yield from inner(ctx, env)
                return
            # the review object's identity is part of the entry and is
            # verified on hit: a memo dict (wrongly) reused across
            # reviews misses instead of serving another review's value
            key = (tid,) + tuple(env.get(v, _MISS) for v in free)
            hit = cache.get(key)
            if hit is not None and hit[0] is rev:
                yield hit[1], env
                return
            got = _MISS
            for v, _ in inner(ctx, env):
                got = v                 # comprehensions yield exactly once
            if got is _MISS:
                return                  # defensive: nothing to cache
            cache[key] = (rev, got)
            yield got, env
        return memo

    def _compile_comprehension(self, term: Comprehension) -> Callable:
        body = self.body(term.body)
        kind = term.kind
        if kind == "array":
            head = self.term(term.head[0])

            def arr(ctx, env):
                out = []
                for env2 in body(ctx, env):
                    for v, _ in head(ctx, env2):
                        out.append(v)
                yield tuple(out), env
            return self._memoize_review_pure(term, arr)
        if kind == "set":
            head = self.term(term.head[0])

            def st(ctx, env):
                out = []
                seen: set = set()
                for env2 in body(ctx, env):
                    for v, _ in head(ctx, env2):
                        if v not in seen:
                            seen.add(v)
                            out.append(v)
                yield frozenset(out), env
            return self._memoize_review_pure(term, st)
        khead = self.term(term.head[0])
        vhead = self.term(term.head[1])
        from gatekeeper_tpu_torch.errors import ConflictError

        def objc(ctx, env):
            pairs: dict = {}
            for env2 in body(ctx, env):
                for k, env3 in khead(ctx, env2):
                    for v, _ in vhead(ctx, env3):
                        if k in pairs and pairs[k] != v:
                            raise ConflictError(
                                "object comprehension: conflicting keys")
                        pairs[k] = v
            yield Obj(pairs), env
        return self._memoize_review_pure(term, objc)
