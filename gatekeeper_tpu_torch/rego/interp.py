# Copied from gatekeeper_tpu/rego/interp.py for the PyTorch port.
"""Scalar Rego-subset interpreter — the semantics oracle.

Replaces the reference's tree-walking evaluator (vendor
opa/topdown/eval.go — the `eval/evalExpr/biunify` core that is the hot
loop of both admission and audit, cf. SURVEY.md §3.2/3.3) for the template
subset.  The vectorized device engine is property-tested against this
implementation, and templates that cannot be lowered run here, restricted
to match-mask candidate pairs.

Semantics notes (OPA-compatible):
- undefined propagates: missing keys / failed builtins produce no results;
- statement truthiness: only `false` and undefined fail;
- `not e` succeeds iff e has no truthy result;
- complete rules / functions raise ConflictError on two distinct outputs;
- partial-set rules union results across clauses.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

from gatekeeper_tpu_torch.errors import ConflictError, EvalError
from gatekeeper_tpu_torch.rego import builtins as bi
from gatekeeper_tpu_torch.rego.ast_nodes import (
    ArrayTerm, Assign, BinOp, Call, Compare, Comprehension, Literal, Module,
    ObjectTerm, Ref, Rule, Scalar, SetTerm, SomeDecl, Term, UnaryMinus, Var,
)
from gatekeeper_tpu_torch.rego.values import Obj, canon_num, freeze, is_truthy, _sort_key

UNDEFINED = bi.UNDEFINED

_MAX_DEPTH = 64


@dataclasses.dataclass
class _Ctx:
    input: Any            # frozen value or UNDEFINED
    data: Any             # frozen Obj
    tracer: list | None
    memo: dict
    depth: int = 0
    # per-step event tracer (rego/trace.StepTracer) — when attached,
    # evaluation routes through the recursive oracle (closures bypassed:
    # the tracer must observe every literal)
    step: Any = None
    # cross-query memo shared by all constraint evaluations of ONE
    # review (rego/closures review-pure comprehension cache) — the
    # driver passes a fresh dict per review; None disables
    shared: Any = None


class Interpreter:
    """Evaluates rules of one module against (input, data) documents."""

    def __init__(self, module: Module):
        from gatekeeper_tpu_torch.rego.reorder import reorder_module

        self.module = reorder_module(module)
        self.rules: dict[str, list[Rule]] = {}
        for r in self.module.rules:
            self.rules.setdefault(r.name, []).append(r)
        # id-keyed side tables over the (immutable, kept-alive) AST:
        # per-node precomputation that the frozen dataclasses can't carry
        self._canon: dict[int, Any] = {}      # Scalar -> canonical value
        self._constpath: dict[int, tuple] = {}  # Ref -> all-constant keys
        self._builtinfn: dict[int, Any] = {}  # Call -> resolved builtin
        for r in self.module.rules:
            _walk_rule(r, self._index_term)
        # closure-compiled body tier (rego/closures.py): rule bodies run
        # as pre-compiled closure trees; the recursive path below stays
        # the oracle (GATEKEEPER_NO_CLOSURES=1 forces it, and the parity
        # suite diffs the two over the library + fuzz corpus)
        import os
        self._closures = None
        if os.environ.get("GATEKEEPER_NO_CLOSURES") != "1":
            from gatekeeper_tpu_torch.rego.closures import ClosureCompiler
            self._closures = ClosureCompiler(self)

    def _index_term(self, term) -> None:
        t = term.__class__
        if t is Scalar:
            v = term.value
            self._canon[id(term)] = canon_num(v) if isinstance(v, (int, float)) else v
        elif t is Ref:
            if all(p.__class__ is Scalar for p in term.path):
                keys = []
                for p in term.path:
                    v = p.value
                    keys.append(canon_num(v) if isinstance(v, (int, float)) else v)
                self._constpath[id(term)] = tuple(keys)
        elif t is Call:
            name = term.name
            if name not in (("trace",), ("internal", "compare"),
                            ("time", "now_ns")) and \
                    not (len(name) == 1 and name[0] in self.rules):
                fn = bi.REGISTRY.get(name)
                if fn is not None:
                    self._builtinfn[id(term)] = fn

    # ------------------------------------------------------------------
    # public entry points

    def query_set(self, name: str, input_doc: Any = UNDEFINED,
                  data_doc: Any = None, tracer: list | None = None,
                  step_tracer=None, shared_memo: dict | None = None) -> list:
        """Evaluate a partial-set rule; returns its members (frozen values)."""
        ctx = self._ctx(input_doc, data_doc, tracer, step_tracer,
                        shared_memo)
        st = ctx.step
        if st is not None:
            st.enter(name)
        out, seen = [], set()
        for rule in self.rules.get(name, []):
            if rule.kind != "partial_set":
                continue
            for env in self._eval_body(ctx, rule.body, 0, {}):
                for v, _ in self._term_eval(ctx, rule.key, env):
                    if v not in seen:
                        seen.add(v)
                        out.append(v)
        if st is not None:
            st.exit(name, out)
        return out

    def query_value(self, name: str, input_doc: Any = UNDEFINED,
                    data_doc: Any = None, tracer: list | None = None,
                    step_tracer=None) -> Any:
        """Evaluate a complete rule's value; UNDEFINED if no clause fires."""
        ctx = self._ctx(input_doc, data_doc, tracer, step_tracer)
        return self._rule_value(ctx, name)

    def _ctx(self, input_doc, data_doc, tracer, step_tracer=None,
             shared_memo=None) -> _Ctx:
        if input_doc is not UNDEFINED:
            input_doc = freeze(input_doc)
        data = freeze(data_doc) if data_doc is not None else Obj()
        return _Ctx(input=input_doc, data=data, tracer=tracer, memo={},
                    step=step_tracer, shared=shared_memo)

    # ------------------------------------------------------------------
    # rule evaluation

    def _term_eval(self, ctx: _Ctx, term, env: dict):
        """Rule-level term evaluation through the compiled tier when on."""
        if self._closures is not None and ctx.step is None:
            return self._closures.term(term)(ctx, env)
        return self._eval_term(ctx, term, env)

    def _rule_value(self, ctx: _Ctx, name: str) -> Any:
        key = ("rule", name)
        if key in ctx.memo:
            v = ctx.memo[key]
            if v is _IN_PROGRESS:
                raise EvalError(f"recursive rule reference: {name}")
            return v
        ctx.memo[key] = _IN_PROGRESS
        st = ctx.step
        if st is not None:
            rs = self.rules.get(name, [])
            st.enter(name, rs[0].loc if rs else None)
        rules = self.rules.get(name, [])
        value = UNDEFINED
        if rules and rules[0].kind == "partial_set":
            members = []
            seen: set = set()
            for rule in rules:
                if rule.is_default:
                    continue
                for env in self._eval_body(ctx, rule.body, 0, {}):
                    for v, _ in self._term_eval(ctx, rule.key, env):
                        if v not in seen:
                            seen.add(v)
                            members.append(v)
            value = frozenset(members)
        elif rules and rules[0].kind == "partial_obj":
            pairs: dict = {}
            for rule in rules:
                for env in self._eval_body(ctx, rule.body, 0, {}):
                    for k, env2 in self._term_eval(ctx, rule.key, env):
                        for v, _ in self._term_eval(ctx, rule.value, env2):
                            if k in pairs and not (pairs[k] == v and _same_kind(pairs[k], v)):
                                raise ConflictError(
                                    f"partial object rule {name}: conflicting values for key {k!r}")
                            pairs[k] = v
            value = Obj(pairs)
        else:
            results: list = []
            default_val = UNDEFINED
            for rule in rules:
                if rule.is_default:
                    for v, _ in self._term_eval(ctx, rule.value, {}):
                        default_val = v
                    continue
                # `else` chain: first clause that produces a value wins
                # for this definition (opa/ast/policy.go:154 Rule.Else;
                # topdown tries clauses in order); separate definitions
                # still conflict-check against each other below
                clause = rule
                while clause is not None:
                    clause_vals: list = []
                    for env in self._eval_body(ctx, clause.body, 0, {}):
                        if clause.value is None:
                            v = True
                        else:
                            got = list(self._term_eval(ctx, clause.value, env))
                            if not got:
                                continue
                            v = got[0][0]
                        if not _contains(clause_vals, v):
                            clause_vals.append(v)
                    if clause_vals:
                        for v in clause_vals:
                            if not _contains(results, v):
                                results.append(v)
                        break
                    clause = clause.els
            if len(results) > 1:
                raise ConflictError(f"complete rule {name} produced multiple values")
            value = results[0] if results else default_val
        ctx.memo[key] = value
        if st is not None:
            st.exit(name, value)
        return value

    def _call_function(self, ctx: _Ctx, name: str, argvals: tuple) -> Any:
        if ctx.depth > _MAX_DEPTH:
            raise EvalError(f"max call depth exceeded in {name}")
        rules = self.rules.get(name, [])
        st = ctx.step
        if st is not None:
            st.enter(name, rules[0].loc if rules else None)
        outputs: list = []
        ctx = dataclasses.replace(ctx, depth=ctx.depth + 1)
        for rule in rules:
            if rule.kind != "function" or len(rule.args or ()) != len(argvals):
                continue
            # `else` chain: clauses share the head's params; the first
            # clause whose body succeeds for these args provides this
            # definition's output (opa Rule.Else semantics)
            clause = rule
            while clause is not None:
                clause_out: list = []
                for env in self._match_args(ctx, clause.args, argvals, {}):
                    for env2 in self._eval_body(ctx, clause.body, 0, env):
                        if clause.value is None:
                            v = True
                        else:
                            got = list(self._term_eval(ctx, clause.value, env2))
                            if not got:
                                continue
                            v = got[0][0]
                        if not _contains(clause_out, v):
                            clause_out.append(v)
                if clause_out:
                    for v in clause_out:
                        if not _contains(outputs, v):
                            outputs.append(v)
                    break
                clause = clause.els
        # OPA: all function clauses that fire must agree on the output
        if len(outputs) > 1:
            raise ConflictError(f"function {name} produced multiple values for one input")
        out = outputs[0] if outputs else UNDEFINED
        if st is not None:
            st.exit(name, out)
        return out

    def _match_args(self, ctx: _Ctx, params, argvals, env) -> Iterator[dict]:
        def rec(i, env):
            if i == len(argvals):
                yield env
                return
            for env2 in self._match_pattern(ctx, params[i], argvals[i], env):
                yield from rec(i + 1, env2)
        yield from rec(0, env)

    # ------------------------------------------------------------------
    # body / literal evaluation

    def _eval_body(self, ctx: _Ctx, body, i: int, env: dict) -> Iterator[dict]:
        if self._closures is not None and i == 0 and ctx.step is None:
            yield from self._closures.body(body)(ctx, env)
            return
        if i >= len(body):
            yield env
            return
        for env2 in self._eval_literal(ctx, body[i], env):
            yield from self._eval_body(ctx, body, i + 1, env2)

    def _eval_literal(self, ctx: _Ctx, lit: Literal, env: dict) -> Iterator[dict]:
        if ctx.step is not None:
            yield from self._eval_literal_stepped(ctx, lit, env)
            return
        yield from self._eval_literal_raw(ctx, lit, env)

    def _eval_literal_stepped(self, ctx: _Ctx, lit: Literal,
                              env: dict) -> Iterator[dict]:
        """Emit Eval/Redo/Fail step events around one literal (OPA's
        per-literal op sequence, topdown/trace.go)."""
        st = ctx.step
        st.step("Eval", lit, env, lit.loc)
        n = 0
        for env2 in self._eval_literal_raw(ctx, lit, env):
            if n:
                st.step("Redo", lit, env2, lit.loc)
            n += 1
            yield env2
        if n == 0:
            st.step("Fail", lit, env, lit.loc)

    def _eval_literal_raw(self, ctx: _Ctx, lit: Literal,
                          env: dict) -> Iterator[dict]:
        if isinstance(lit.expr, SomeDecl):
            env2 = {k: v for k, v in env.items() if k not in lit.expr.names}
            yield env2
            return
        if lit.withs:
            ctx = self._apply_withs(ctx, lit.withs, env)
            if ctx is None:  # a with-value was undefined => literal undefined
                return
        if lit.negated:
            for _ in self._eval_expr(ctx, lit.expr, env):
                return
            yield env
            return
        yield from self._eval_expr(ctx, lit.expr, env)

    def _apply_withs(self, ctx: _Ctx, withs, env) -> _Ctx | None:
        from gatekeeper_tpu_torch.rego.values import thaw

        new_input, new_data = ctx.input, ctx.data
        for w in withs:
            vals = list(self._eval_term(ctx, w.value, env))
            if not vals:
                return None  # undefined with-value makes the literal undefined
            value = vals[0][0]
            names = [w.target.base.name] + [
                p.value for p in w.target.path if isinstance(p, Scalar)]
            if names == ["input"]:
                new_input = value
            elif names[0] == "data":
                doc = thaw(new_data)
                cur = doc
                for part in names[1:-1]:
                    cur = cur.setdefault(part, {})
                if len(names) > 1:
                    cur[names[-1]] = thaw(value)
                    new_data = freeze(doc)
                else:
                    new_data = value
            else:
                raise EvalError(f"unsupported with target: {'.'.join(names)}")
        memo: dict = {}
        # rule/value memos are invalid under overridden documents, but
        # the per-query clock instant is document-independent (OPA's
        # builtin cache also survives `with`)
        if ("time.now_ns",) in ctx.memo:
            memo[("time.now_ns",)] = ctx.memo[("time.now_ns",)]
        # the shared (per-review) memo keys on the ORIGINAL input
        # document; under an overridden input/data it must not serve
        return dataclasses.replace(ctx, input=new_input, data=new_data,
                                   memo=memo, shared=None)

    def _eval_expr(self, ctx: _Ctx, expr, env: dict) -> Iterator[dict]:
        if isinstance(expr, Assign):
            yield from self._unify(ctx, expr.lhs, expr.rhs, env)
            return
        if isinstance(expr, Compare):
            for lv, env1 in self._eval_term(ctx, expr.lhs, env):
                for rv, env2 in self._eval_term(ctx, expr.rhs, env1):
                    if _compare(expr.op, lv, rv):
                        yield env2
            return
        # plain term used as statement
        for v, env2 in self._eval_term(ctx, expr, env):
            if is_truthy(v):
                yield env2

    # ------------------------------------------------------------------
    # unification

    def _unify(self, ctx: _Ctx, lhs, rhs, env: dict) -> Iterator[dict]:
        if self._is_pattern(lhs, env):
            for rv, env2 in self._eval_term(ctx, rhs, env):
                yield from self._match_pattern(ctx, lhs, rv, env2)
        elif self._is_pattern(rhs, env):
            for lv, env2 in self._eval_term(ctx, lhs, env):
                yield from self._match_pattern(ctx, rhs, lv, env2)
        else:
            for lv, env1 in self._eval_term(ctx, lhs, env):
                for rv, env2 in self._eval_term(ctx, rhs, env1):
                    if lv == rv and _same_kind(lv, rv):
                        yield env2

    def _is_pattern(self, term: Term, env: dict) -> bool:
        """Does term contain unbound vars in binding positions?"""
        if isinstance(term, Var):
            return term.name not in env and term.name not in self.rules
        if isinstance(term, ArrayTerm):
            return any(self._is_pattern(t, env) for t in term.items)
        if isinstance(term, ObjectTerm):
            return any(self._is_pattern(v, env) for _, v in term.pairs)
        return False

    def _match_pattern(self, ctx: _Ctx, pat: Term, value, env: dict) -> Iterator[dict]:
        if isinstance(pat, Var):
            if pat.name in env:
                if env[pat.name] == value and _same_kind(env[pat.name], value):
                    yield env
            elif pat.name in self.rules:
                rv = self._rule_value(ctx, pat.name)
                if rv is not UNDEFINED and rv == value:
                    yield env
            else:
                env2 = dict(env)
                env2[pat.name] = value
                yield env2
            return
        if isinstance(pat, ArrayTerm):
            if isinstance(value, tuple) and len(value) == len(pat.items):
                def rec(i, env):
                    if i == len(pat.items):
                        yield env
                        return
                    for env2 in self._match_pattern(ctx, pat.items[i], value[i], env):
                        yield from rec(i + 1, env2)
                yield from rec(0, env)
            return
        if isinstance(pat, ObjectTerm):
            # OPA object unification requires identical key sets, not subset
            if isinstance(value, Obj) and len(pat.pairs) == len(value):
                def rec(i, env):
                    if i == len(pat.pairs):
                        yield env
                        return
                    kterm, vterm = pat.pairs[i]
                    for kv, env1 in self._eval_term(ctx, kterm, env):
                        if kv in value:
                            for env2 in self._match_pattern(ctx, vterm, value[kv], env1):
                                yield from rec(i + 1, env2)
                yield from rec(0, env)
            return
        # ground term: evaluate and compare
        for pv, env2 in self._eval_term(ctx, pat, env):
            if pv == value and _same_kind(pv, value):
                yield env2

    # ------------------------------------------------------------------
    # term evaluation

    def _eval_term(self, ctx: _Ctx, term: Term, env: dict) -> Iterator[tuple[Any, dict]]:
        cls = term.__class__
        if cls is Scalar:
            v = self._canon.get(id(term), _MISS)
            if v is _MISS:
                v = canon_num(term.value) if isinstance(term.value, (int, float)) \
                    else term.value
            yield v, env
            return
        if cls is Var:
            name = term.name
            if name in env:
                yield env[name], env
                return
            if name == "input":
                if ctx.input is not UNDEFINED:
                    yield ctx.input, env
                return
            if name == "data":
                yield ctx.data, env
                return
            if name in self.rules:
                v = self._rule_value(ctx, name)
                if v is not UNDEFINED:
                    yield v, env
                return
            raise EvalError(f"unsafe variable: {name}")
        if cls is Ref:
            keys = self._constpath.get(id(term))
            if keys is not None:
                # all-constant path: iterative descent, no per-element
                # generator frames
                base = term.base
                if base.__class__ is Var:
                    name = base.name
                    if name in env:
                        base_v = env[name]
                    elif name == "input":
                        if ctx.input is UNDEFINED:
                            return
                        base_v = ctx.input
                    elif name == "data":
                        base_v = ctx.data
                    else:
                        base_v = _MISS
                    if base_v is not _MISS:
                        v = _walk_const(base_v, keys)
                        if v is not _MISS:
                            yield v, env
                        return
                for base_v, env1 in self._eval_term(ctx, base, env):
                    v = _walk_const(base_v, keys)
                    if v is not _MISS:
                        yield v, env1
                return
            for base_v, env1 in self._eval_term(ctx, term.base, env):
                yield from self._walk_ref(ctx, base_v, term.path, 0, env1)
            return
        if isinstance(term, ArrayTerm):
            yield from self._eval_seq(ctx, term.items, env, tuple)
            return
        if isinstance(term, SetTerm):
            yield from self._eval_seq(ctx, term.items, env, frozenset)
            return
        if isinstance(term, ObjectTerm):
            def rec_obj(i, env, acc):
                if i == len(term.pairs):
                    yield Obj(acc), env
                    return
                kt, vt = term.pairs[i]
                for kv, env1 in self._eval_term(ctx, kt, env):
                    for vv, env2 in self._eval_term(ctx, vt, env1):
                        yield from rec_obj(i + 1, env2, acc + [(kv, vv)])
            yield from rec_obj(0, env, [])
            return
        if isinstance(term, BinOp):
            for lv, env1 in self._eval_term(ctx, term.lhs, env):
                for rv, env2 in self._eval_term(ctx, term.rhs, env1):
                    v = _binop(term.op, lv, rv)
                    if v is not UNDEFINED:
                        yield v, env2
            return
        if isinstance(term, UnaryMinus):
            for v, env1 in self._eval_term(ctx, term.operand, env):
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    yield canon_num(-v), env1
            return
        if isinstance(term, Call):
            yield from self._eval_call(ctx, term, env)
            return
        if isinstance(term, Comprehension):
            yield self._eval_comprehension(ctx, term, env), env
            return
        raise EvalError(f"cannot evaluate term {term!r}")

    def _eval_seq(self, ctx, items, env, ctor) -> Iterator[tuple[Any, dict]]:
        def rec(i, env, acc):
            if i == len(items):
                yield ctor(acc), env
                return
            for v, env2 in self._eval_term(ctx, items[i], env):
                yield from rec(i + 1, env2, acc + [v])
        yield from rec(0, env, [])

    def _walk_ref(self, ctx: _Ctx, value, path, i: int, env: dict) -> Iterator[tuple[Any, dict]]:
        if i == len(path):
            yield value, env
            return
        op = path[i]
        if isinstance(op, Var) and op.name not in env and op.name not in self.rules \
                and op.name not in ("input", "data"):
            # unbound var: iterate the collection, binding the key/index/member
            if isinstance(value, Obj):
                for k, v in value.items():
                    env2 = dict(env)
                    env2[op.name] = k
                    yield from self._walk_ref(ctx, v, path, i + 1, env2)
            elif isinstance(value, tuple):
                for idx, v in enumerate(value):
                    env2 = dict(env)
                    env2[op.name] = idx
                    yield from self._walk_ref(ctx, v, path, i + 1, env2)
            elif isinstance(value, frozenset):
                for m in value:
                    env2 = dict(env)
                    env2[op.name] = m
                    yield from self._walk_ref(ctx, m, path, i + 1, env2)
            return
        for kv, env2 in self._eval_term(ctx, op, env):
            if isinstance(value, Obj):
                if kv in value:
                    yield from self._walk_ref(ctx, value[kv], path, i + 1, env2)
            elif isinstance(value, tuple):
                if isinstance(kv, int) and not isinstance(kv, bool) and 0 <= kv < len(value):
                    yield from self._walk_ref(ctx, value[kv], path, i + 1, env2)
            elif isinstance(value, frozenset):
                if kv in value:
                    yield from self._walk_ref(ctx, kv, path, i + 1, env2)
        return

    def _eval_call(self, ctx: _Ctx, term: Call, env: dict) -> Iterator[tuple[Any, dict]]:
        fn = self._builtinfn.get(id(term))
        if fn is not None:
            # pre-resolved builtin: unrolled 1/2-arg paths skip the
            # _eval_seq accumulator machinery
            args = term.args
            n = len(args)
            if n == 1:
                for a0, env2 in self._eval_term(ctx, args[0], env):
                    try:
                        v = fn(a0)
                    except bi.BuiltinError:
                        continue
                    except (TypeError, ValueError, KeyError, IndexError,
                            ZeroDivisionError):
                        continue
                    if v is not UNDEFINED:
                        yield v, env2
                return
            if n == 2:
                for a0, env1 in self._eval_term(ctx, args[0], env):
                    for a1, env2 in self._eval_term(ctx, args[1], env1):
                        try:
                            v = fn(a0, a1)
                        except bi.BuiltinError:
                            continue
                        except (TypeError, ValueError, KeyError, IndexError,
                                ZeroDivisionError):
                            continue
                        if v is not UNDEFINED:
                            yield v, env2
                return
            for argvals, env2 in self._eval_seq(ctx, args, env, tuple):
                try:
                    v = fn(*argvals)
                except bi.BuiltinError:
                    continue
                except (TypeError, ValueError, KeyError, IndexError,
                        ZeroDivisionError):
                    continue
                if v is not UNDEFINED:
                    yield v, env2
            return
        name = term.name
        if name == ("trace",):
            for v, env2 in self._eval_term(ctx, term.args[0], env):
                if ctx.tracer is not None:
                    ctx.tracer.append(str(v))
                yield True, env2
            return
        if name == ("internal", "compare"):
            op_t = term.args[0]
            assert isinstance(op_t, Scalar)
            for lv, env1 in self._eval_term(ctx, term.args[1], env):
                for rv, env2 in self._eval_term(ctx, term.args[2], env1):
                    yield _compare(str(op_t.value), lv, rv), env2
            return
        if name == ("time", "now_ns"):
            # OPA memoizes the clock per query: every reference within
            # one evaluation sees the same instant
            v = ctx.memo.get(("time.now_ns",))
            if v is None:
                v = bi.REGISTRY[("time", "now_ns")]()
                ctx.memo[("time.now_ns",)] = v
            yield v, env
            return
        if name == ("walk",):
            # relation builtin (vendor opa/topdown/walk.go): yields every
            # (path, value) pair; 2-arg statement form unifies the pair,
            # 1-arg expression form yields the pairs as values
            for xv, env1 in self._eval_term(ctx, term.args[0], env):
                pairs = bi.walk_pairs(xv)
                if len(term.args) == 2:
                    for path, v in pairs:
                        for env2 in self._match_pattern(
                                ctx, term.args[1], (path, v), env1):
                            yield True, env2
                else:
                    for path, v in pairs:
                        yield (path, v), env1
            return
        if len(name) == 1 and name[0] in self.rules:
            # user-defined function
            for argvals, env2 in self._eval_seq(ctx, term.args, env, tuple):
                v = self._call_function(ctx, name[0], argvals)
                if v is not UNDEFINED:
                    yield v, env2
            return
        fn = bi.REGISTRY.get(name)
        if fn is None:
            raise EvalError(f"unknown function: {'.'.join(name)}")
        for argvals, env2 in self._eval_seq(ctx, term.args, env, tuple):
            try:
                v = fn(*argvals)
            except bi.BuiltinError:
                continue  # builtin error => undefined (OPA non-strict mode)
            except (TypeError, ValueError, KeyError, IndexError, ZeroDivisionError):
                continue
            if v is UNDEFINED:
                continue
            yield v, env2

    def _eval_comprehension(self, ctx: _Ctx, term: Comprehension, env: dict):
        if term.kind == "array":
            out = []
            for env2 in self._eval_body(ctx, term.body, 0, env):
                for v, _ in self._eval_term(ctx, term.head[0], env2):
                    out.append(v)
            return tuple(out)
        if term.kind == "set":
            out_set = []
            seen: set = set()
            for env2 in self._eval_body(ctx, term.body, 0, env):
                for v, _ in self._eval_term(ctx, term.head[0], env2):
                    if v not in seen:
                        seen.add(v)
                        out_set.append(v)
            return frozenset(out_set)
        # object comprehension
        pairs: dict = {}
        for env2 in self._eval_body(ctx, term.body, 0, env):
            for k, env3 in self._eval_term(ctx, term.head[0], env2):
                for v, _ in self._eval_term(ctx, term.head[1], env3):
                    if k in pairs and pairs[k] != v:
                        raise ConflictError("object comprehension: conflicting keys")
                    pairs[k] = v
        return Obj(pairs)


_IN_PROGRESS = object()
_MISS = object()


def _walk_rule(rule: Rule, visit) -> None:
    """Apply `visit` to every term in a rule (pre-order), including
    its whole else chain — chain clauses must reach the precomputed
    canon/const-path/builtin side tables like any other clause."""
    while rule is not None:
        for t in (rule.key, rule.value):
            if t is not None:
                _walk_term(t, visit)
        for a in rule.args or ():
            _walk_term(a, visit)
        _walk_body(rule.body, visit)
        rule = rule.els


def _walk_body(body, visit) -> None:
    for lit in body:
        for w in lit.withs or ():
            _walk_term(w.target, visit)
            _walk_term(w.value, visit)
        if not isinstance(lit.expr, SomeDecl):
            _walk_term(lit.expr, visit)


def _walk_term(term, visit) -> None:
    visit(term)
    t = term.__class__
    if t is Ref:
        _walk_term(term.base, visit)
        for p in term.path:
            _walk_term(p, visit)
    elif t in (ArrayTerm, SetTerm):
        for x in term.items:
            _walk_term(x, visit)
    elif t is ObjectTerm:
        for k, v in term.pairs:
            _walk_term(k, visit)
            _walk_term(v, visit)
    elif t is Call:
        for a in term.args:
            _walk_term(a, visit)
    elif t is BinOp:
        _walk_term(term.lhs, visit)
        _walk_term(term.rhs, visit)
    elif t is UnaryMinus:
        _walk_term(term.operand, visit)
    elif t is Comprehension:
        for h in term.head:
            if h is not None:
                _walk_term(h, visit)
        _walk_body(term.body, visit)
    elif t is Assign:
        _walk_term(term.lhs, visit)
        _walk_term(term.rhs, visit)
    elif t is Compare:
        _walk_term(term.lhs, visit)
        _walk_term(term.rhs, visit)


def _walk_const(value, keys):
    """Resolve an all-constant ref path iteratively; _MISS if undefined.
    Semantics identical to _walk_ref's ground branch."""
    for k in keys:
        tv = value.__class__
        if tv is Obj:
            value = value._d.get(k, _MISS)
            if value is _MISS:
                return _MISS
        elif tv is tuple:
            if k.__class__ is int and 0 <= k < len(value):
                value = value[k]
            else:
                return _MISS
        elif tv is frozenset:
            if k in value:
                value = k
            else:
                return _MISS
        else:
            return _MISS
    return value


def _contains(values: list, v) -> bool:
    """Membership that does not coerce bool==int (True vs 1 are distinct)."""
    return any(x == v and _same_kind(x, v) for x in values)


def _same_kind(a, b) -> bool:
    """Guard against bool==int / 1==True coercion surprises in unification."""
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    return True


def _compare(op: str, lv, rv) -> bool:
    if op == "==":
        return lv == rv and _same_kind(lv, rv)
    if op == "!=":
        return lv != rv or not _same_kind(lv, rv)
    # ordering: numbers compare numerically; otherwise OPA's type order
    if isinstance(lv, (int, float)) and not isinstance(lv, bool) and \
       isinstance(rv, (int, float)) and not isinstance(rv, bool):
        a, b = lv, rv
    else:
        a, b = _sort_key(lv), _sort_key(rv)
    try:
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        if op == ">=":
            return a >= b
    except TypeError:
        return False
    raise EvalError(f"unknown comparison op {op}")


def _binop(op: str, lv, rv):
    is_num = (lambda x: isinstance(x, (int, float)) and not isinstance(x, bool))
    if op == "+":
        if is_num(lv) and is_num(rv):
            return canon_num(lv + rv)
        return UNDEFINED
    if op == "-":
        if is_num(lv) and is_num(rv):
            return canon_num(lv - rv)
        if isinstance(lv, frozenset) and isinstance(rv, frozenset):
            return lv - rv
        return UNDEFINED
    if op == "*":
        if is_num(lv) and is_num(rv):
            return canon_num(lv * rv)
        return UNDEFINED
    if op == "/":
        if is_num(lv) and is_num(rv):
            if rv == 0:
                return UNDEFINED
            return canon_num(lv / rv)
        return UNDEFINED
    if op == "%":
        if isinstance(lv, int) and isinstance(rv, int) and not isinstance(lv, bool) \
                and not isinstance(rv, bool) and rv != 0:
            return lv % rv
        return UNDEFINED
    if op == "|":
        if isinstance(lv, frozenset) and isinstance(rv, frozenset):
            return lv | rv
        return UNDEFINED
    if op == "&":
        if isinstance(lv, frozenset) and isinstance(rv, frozenset):
            return lv & rv
        return UNDEFINED
    raise EvalError(f"unknown binary op {op}")
