# Copied from gatekeeper_tpu/rego/ast_nodes.py for the PyTorch port.
"""Rego AST for the template subset.

Replaces OPA's ast term/rule model (reference: vendor opa/ast/term.go,
policy.go) with only what ConstraintTemplates exercise: complete rules,
partial-set rules, functions with multi-clause definitions, refs with
variable indexing, comprehensions, set/array/object literals, builtins,
`not`, `some`, and `with` modifiers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from gatekeeper_tpu_torch.errors import Location


class Term:
    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class Scalar(Term):
    value: Any  # None | bool | int | float | str


@dataclasses.dataclass(frozen=True)
class Var(Term):
    name: str

    @property
    def is_wildcard(self) -> bool:
        return self.name.startswith("$")


@dataclasses.dataclass(frozen=True)
class Ref(Term):
    """base followed by a path of operand terms.

    ``input.review.object`` = Ref(Var('input'), (Scalar('review'),
    Scalar('object'))).  Operands may be Vars (iteration) or arbitrary terms
    (computed keys).
    """

    base: Term
    path: tuple[Term, ...]


@dataclasses.dataclass(frozen=True)
class ArrayTerm(Term):
    items: tuple[Term, ...]


@dataclasses.dataclass(frozen=True)
class SetTerm(Term):
    items: tuple[Term, ...]


@dataclasses.dataclass(frozen=True)
class ObjectTerm(Term):
    pairs: tuple[tuple[Term, Term], ...]


@dataclasses.dataclass(frozen=True)
class Call(Term):
    """Builtin or user-function call; name is a dotted path ('array','concat')."""

    name: tuple[str, ...]
    args: tuple[Term, ...]


@dataclasses.dataclass(frozen=True)
class BinOp(Term):
    """Arithmetic / set operators: + - * / % | &  (minus and the set ops are
    resolved by operand type at runtime, as in OPA)."""

    op: str
    lhs: Term
    rhs: Term


@dataclasses.dataclass(frozen=True)
class UnaryMinus(Term):
    operand: Term


@dataclasses.dataclass(frozen=True)
class Comprehension(Term):
    kind: str  # 'array' | 'set' | 'object'
    head: tuple[Term, ...]  # (value,) or (key, value) for object
    body: tuple["Literal", ...]


# --- Literals (body statements) ---


@dataclasses.dataclass(frozen=True)
class WithMod:
    target: Ref  # e.g. input, data.inventory
    value: Term


@dataclasses.dataclass(frozen=True)
class Literal:
    """One statement in a rule/comprehension body.

    expr is one of: a Term used as an expression, Compare, Assign.
    """

    expr: Any
    negated: bool = False
    withs: tuple[WithMod, ...] = ()
    loc: Location = dataclasses.field(default_factory=Location)


@dataclasses.dataclass(frozen=True)
class Compare:
    op: str  # == != < > <= >=
    lhs: Term
    rhs: Term


@dataclasses.dataclass(frozen=True)
class Assign:
    """`lhs := rhs` (declare+bind) or `lhs = rhs` (unification)."""

    op: str  # ':=' | '='
    lhs: Term
    rhs: Term


@dataclasses.dataclass(frozen=True)
class SomeDecl:
    names: tuple[str, ...]


@dataclasses.dataclass
class Rule:
    name: str
    kind: str  # 'complete' | 'partial_set' | 'partial_obj' | 'function'
    args: Optional[tuple[Term, ...]]  # function params (None unless function)
    key: Optional[Term]               # partial set/obj key
    value: Optional[Term]             # head value (None => true)
    body: tuple[Literal, ...]
    is_default: bool = False
    loc: Location = dataclasses.field(default_factory=Location)
    # `else` chain, linked like OPA's AST (vendor opa/ast/policy.go:154
    # Rule.Else; linkage built at parser_ext.go:689): the next clause to
    # try when this clause's body fails.  First matching clause wins.
    els: Optional["Rule"] = None


@dataclasses.dataclass
class Module:
    package: tuple[str, ...]
    rules: list[Rule]
    imports: list[tuple[str, ...]] = dataclasses.field(default_factory=list)

    def rules_named(self, name: str) -> list[Rule]:
        return [r for r in self.rules if r.name == name]


def walk_terms(node, fn) -> None:
    """Depth-first visit of every Term inside a node (Rule/Literal/Term)."""
    if isinstance(node, Rule):
        for t in (node.args or ()):
            walk_terms(t, fn)
        if node.key is not None:
            walk_terms(node.key, fn)
        if node.value is not None:
            walk_terms(node.value, fn)
        for lit in node.body:
            walk_terms(lit, fn)
        if node.els is not None:
            walk_terms(node.els, fn)
        return
    if isinstance(node, Literal):
        e = node.expr
        if isinstance(e, (Compare, Assign)):
            walk_terms(e.lhs, fn)
            walk_terms(e.rhs, fn)
        elif isinstance(e, SomeDecl):
            pass
        else:
            walk_terms(e, fn)
        for w in node.withs:
            walk_terms(w.target, fn)
            walk_terms(w.value, fn)
        return
    if isinstance(node, Term):
        fn(node)
        if isinstance(node, Ref):
            walk_terms(node.base, fn)
            for p in node.path:
                walk_terms(p, fn)
        elif isinstance(node, (ArrayTerm, SetTerm)):
            for t in node.items:
                walk_terms(t, fn)
        elif isinstance(node, ObjectTerm):
            for k, v in node.pairs:
                walk_terms(k, fn)
                walk_terms(v, fn)
        elif isinstance(node, Call):
            for t in node.args:
                walk_terms(t, fn)
        elif isinstance(node, BinOp):
            walk_terms(node.lhs, fn)
            walk_terms(node.rhs, fn)
        elif isinstance(node, UnaryMinus):
            walk_terms(node.operand, fn)
        elif isinstance(node, Comprehension):
            for t in node.head:
                walk_terms(t, fn)
            for lit in node.body:
                walk_terms(lit, fn)
