# Copied from gatekeeper_tpu/rego/reorder.py for the PyTorch port.
"""Body-literal reordering for variable safety.

OPA's compiler reorders rule-body literals so every variable is bound
before it is consumed (reference: vendor opa/ast/compile.go's
rewrite/check stages, notably reorderBodyForSafety).  Rego is declarative:
real templates write `s = concat(":", [key, val])` *before* the literal
that generates `key`/`val` (e.g. k8suniqueserviceselector).  This pass
computes, per literal, the variables it NEEDS (must already be bound) and
the variables it can BIND (patterns, generative ref operands), then
greedily emits literals whose needs are satisfied, preserving source order
among eligible literals.  Comprehension bodies are reordered recursively.
"""

from __future__ import annotations

from gatekeeper_tpu_torch.rego.ast_nodes import (
    ArrayTerm, Assign, BinOp, Call, Compare, Comprehension, Literal, Module,
    ObjectTerm, Ref, Rule, Scalar, SetTerm, SomeDecl, Term, UnaryMinus, Var,
)

_GLOBALS = {"input", "data"}


def _is_wild(name: str) -> bool:
    return name.startswith("$")


class _Analysis:
    def __init__(self, rule_names: set[str]):
        self.rule_names = rule_names

    def term(self, t: Term, pattern: bool, needs: set, binds: set) -> None:
        if isinstance(t, Scalar):
            return
        if isinstance(t, Var):
            if t.name in _GLOBALS or t.name in self.rule_names or _is_wild(t.name):
                return
            (binds if pattern else needs).add(t.name)
            return
        if isinstance(t, Ref):
            self.term(t.base, False, needs, binds)
            for op in t.path:
                if isinstance(op, Var):
                    # unbound ref operands are generative (iteration binds them)
                    if op.name not in _GLOBALS and op.name not in self.rule_names \
                            and not _is_wild(op.name):
                        binds.add(op.name)
                else:
                    self.term(op, False, needs, binds)
            return
        if isinstance(t, (ArrayTerm, SetTerm)):
            for x in t.items:
                self.term(x, pattern, needs, binds)
            return
        if isinstance(t, ObjectTerm):
            for k, v in t.pairs:
                self.term(k, False, needs, binds)
                self.term(v, pattern, needs, binds)
            return
        if isinstance(t, Call):
            for a in t.args:
                self.term(a, False, needs, binds)
            return
        if isinstance(t, BinOp):
            self.term(t.lhs, False, needs, binds)
            self.term(t.rhs, False, needs, binds)
            return
        if isinstance(t, UnaryMinus):
            self.term(t.operand, False, needs, binds)
            return
        if isinstance(t, Comprehension):
            # free variables of the comprehension are outer needs
            inner_needs: set = set()
            inner_binds: set = set()
            for h in t.head:
                self.term(h, False, inner_needs, inner_binds)
            for lit in t.body:
                n, b = self.literal(lit)
                inner_needs |= n
                inner_binds |= b
            needs |= inner_needs - inner_binds
            return
        raise TypeError(f"unknown term {t!r}")

    def literal(self, lit: Literal) -> tuple[set, set]:
        needs: set = set()
        binds: set = set()
        e = lit.expr
        if isinstance(e, SomeDecl):
            return set(), set()
        if isinstance(e, Assign):
            if isinstance(e.lhs, (Var, ArrayTerm, ObjectTerm)):
                self.term(e.lhs, True, needs, binds)
            else:
                self.term(e.lhs, False, needs, binds)
            self.term(e.rhs, False, needs, binds)
        elif isinstance(e, Compare):
            self.term(e.lhs, False, needs, binds)
            self.term(e.rhs, False, needs, binds)
        else:
            self.term(e, False, needs, binds)
        for w in lit.withs:
            self.term(w.value, False, needs, binds)
        if lit.negated:
            # everything inside a negation must already be bound
            needs |= binds
            binds = set()
        return needs, binds


def reorder_body(body: tuple[Literal, ...], rule_names: set[str],
                 initially_bound: set[str]) -> tuple[Literal, ...]:
    if len(body) <= 1:
        return tuple(_map_comprehensions(l, rule_names) for l in body)
    an = _Analysis(rule_names)
    infos = [an.literal(l) for l in body]
    # vars with no binder anywhere are assumed bound by the outer scope
    all_binds = set().union(*(b for _, b in infos)) if infos else set()
    bound = set(initially_bound) | {
        v for n, _ in infos for v in n if v not in all_binds}
    remaining = list(range(len(body)))
    out: list[Literal] = []
    while remaining:
        picked = None
        for idx in remaining:
            needs, _ = infos[idx]
            if needs <= bound:
                picked = idx
                break
        if picked is None:
            # unsatisfiable ordering; emit rest in source order (runtime will
            # surface the unsafe-variable error with context)
            for idx in remaining:
                out.append(_map_comprehensions(body[idx], rule_names))
            break
        remaining.remove(picked)
        out.append(_map_comprehensions(body[picked], rule_names))
        bound |= infos[picked][1]
    return tuple(out)


def _map_comprehensions(lit: Literal, rule_names: set[str]) -> Literal:
    """Recursively reorder comprehension bodies inside a literal."""

    def map_term(t: Term) -> Term:
        if isinstance(t, Comprehension):
            new_body = reorder_body(t.body, rule_names, set())
            new_head = tuple(map_term(h) for h in t.head)
            return Comprehension(kind=t.kind, head=new_head, body=new_body)
        if isinstance(t, Ref):
            return Ref(base=map_term(t.base), path=tuple(map_term(p) for p in t.path))
        if isinstance(t, ArrayTerm):
            return ArrayTerm(tuple(map_term(x) for x in t.items))
        if isinstance(t, SetTerm):
            return SetTerm(tuple(map_term(x) for x in t.items))
        if isinstance(t, ObjectTerm):
            return ObjectTerm(tuple((map_term(k), map_term(v)) for k, v in t.pairs))
        if isinstance(t, Call):
            return Call(name=t.name, args=tuple(map_term(a) for a in t.args))
        if isinstance(t, BinOp):
            return BinOp(op=t.op, lhs=map_term(t.lhs), rhs=map_term(t.rhs))
        if isinstance(t, UnaryMinus):
            return UnaryMinus(map_term(t.operand))
        return t

    e = lit.expr
    if isinstance(e, Assign):
        e = Assign(op=e.op, lhs=map_term(e.lhs), rhs=map_term(e.rhs))
    elif isinstance(e, Compare):
        e = Compare(op=e.op, lhs=map_term(e.lhs), rhs=map_term(e.rhs))
    elif isinstance(e, SomeDecl):
        pass
    else:
        e = map_term(e)
    return Literal(expr=e, negated=lit.negated, withs=lit.withs, loc=lit.loc)


def _reorder_rule(r: Rule, rule_names: set[str]) -> Rule:
    params: set[str] = set()
    for p in (r.args or ()):
        _collect_pattern_vars(p, params)
    return Rule(
        name=r.name, kind=r.kind, args=r.args, key=r.key, value=r.value,
        body=reorder_body(r.body, rule_names, params),
        is_default=r.is_default, loc=r.loc,
        els=_reorder_rule(r.els, rule_names) if r.els is not None else None)


def reorder_module(module: Module) -> Module:
    rule_names = {r.name for r in module.rules}
    new_rules = [_reorder_rule(r, rule_names) for r in module.rules]
    return Module(package=module.package, rules=new_rules, imports=module.imports)


def _collect_pattern_vars(t: Term, out: set) -> None:
    if isinstance(t, Var):
        if not _is_wild(t.name):
            out.add(t.name)
    elif isinstance(t, (ArrayTerm, SetTerm)):
        for x in t.items:
            _collect_pattern_vars(x, out)
    elif isinstance(t, ObjectTerm):
        for _, v in t.pairs:
            _collect_pattern_vars(v, out)
