# Copied from gatekeeper_tpu/rego/parser.py for the PyTorch port.
"""Recursive-descent parser for the Rego template subset.

Replaces OPA's generated PEG parser (vendor opa/ast/parser.go; grammar
vendor opa/ast/rego.peg) for the language subset ConstraintTemplates use.
Newlines separate rule-body literals (like Rego); inside brackets/parens
and comprehension bodies they are insignificant.
"""

from __future__ import annotations

import itertools

from gatekeeper_tpu_torch.errors import ParseError
from gatekeeper_tpu_torch.rego.ast_nodes import (
    ArrayTerm, Assign, BinOp, Call, Compare, Comprehension, Literal, Module,
    ObjectTerm, Ref, Rule, Scalar, SetTerm, SomeDecl, Term, UnaryMinus, Var,
    WithMod,
)
from gatekeeper_tpu_torch.rego.lexer import Token, tokenize

COMPARE_OPS = {"==", "!=", "<", ">", "<=", ">="}


class Parser:
    def __init__(self, src: str, filename: str = ""):
        self.toks: list[Token] = tokenize(src, filename)
        self.pos = 0
        self._nlskip = 0  # >0: newline tokens are transparently skipped
        # `|` is ambiguous inside `{...}`/`[...]`: comprehension separator vs
        # set union.  Like OPA's PEG, the comprehension reading wins for the
        # first expression; parens restore the union operator.
        self._union_ok = True
        self._wild = itertools.count()

    # --- token primitives ---

    def _peek_index(self) -> int:
        i = self.pos
        if self._nlskip > 0:
            while self.toks[i].kind == "newline":
                i += 1
        return i

    def cur(self) -> Token:
        return self.toks[self._peek_index()]

    def advance(self) -> Token:
        i = self._peek_index()
        t = self.toks[i]
        self.pos = i if t.kind == "eof" else i + 1
        return t

    def at(self, kind: str, value=None) -> bool:
        t = self.cur()
        return t.kind == kind and (value is None or t.value == value)

    def expect(self, kind: str, value=None) -> Token:
        t = self.cur()
        if t.kind != kind or (value is not None and t.value != value):
            want = value if value is not None else kind
            raise ParseError(f"expected {want!r}, got {t.value!r}", t.loc)
        return self.advance()

    def skip_newlines(self) -> None:
        while self.toks[self.pos].kind == "newline":
            self.pos += 1

    # --- module / rules ---

    def parse_module(self) -> Module:
        self.skip_newlines()
        self.expect("keyword", "package")
        pkg = self._parse_package_path()
        rules: list[Rule] = []
        imports: list[tuple[str, ...]] = []
        while True:
            self.skip_newlines()
            if self.at("eof"):
                break
            if self.at("keyword", "import"):
                # recorded so the compile stage can reject them, as the
                # constraint framework does (rego_helpers.go:23)
                self.advance()
                imports.append(self._parse_package_path())
                continue
            rules.append(self.parse_rule())
        return Module(package=pkg, rules=rules, imports=imports)

    def _parse_package_path(self) -> tuple[str, ...]:
        parts = [str(self.expect("ident").value)]
        while self.at("op", ".") or self.at("op", "["):
            if self.at("op", "."):
                self.advance()
                parts.append(str(self.expect("ident").value))
            else:
                self.advance()
                parts.append(str(self.expect("string").value))
                self.expect("op", "]")
        return tuple(parts)

    def parse_rule(self) -> Rule:
        loc = self.cur().loc
        is_default = False
        if self.at("keyword", "default"):
            is_default = True
            self.advance()
        name = str(self.expect("ident").value)

        args = None
        key = None
        value = None
        kind = "complete"

        if self.at("op", "("):
            kind = "function"
            self.advance()
            self._nlskip += 1
            params = []
            while not self.at("op", ")"):
                params.append(self.parse_expr())
                if self.at("op", ","):
                    self.advance()
            self.expect("op", ")")
            self._nlskip -= 1
            args = tuple(params)
        elif self.at("op", "["):
            self.advance()
            self._nlskip += 1
            key = self.parse_expr()
            self.expect("op", "]")
            self._nlskip -= 1
            kind = "partial_set"

        if self.at("op", "=") or self.at("op", ":="):
            self.advance()
            self._nlskip += 1
            value = self.parse_expr()
            # keep newline transparency only through the value expression
            # itself; the body brace (or a newline ending a bodiless rule)
            # must be seen by the caller
            self._nlskip -= 1
            if kind == "partial_set":
                kind = "partial_obj"
        if is_default and value is None:
            raise ParseError("default rule requires a value", loc)

        body: tuple[Literal, ...] = ()
        if self.at("op", "{"):
            body = self.parse_body()
        elif value is None and kind in ("complete", "partial_set"):
            t = self.cur()
            raise ParseError(f"expected rule body or value, got {t.value!r}", t.loc)
        els = None
        if self._at_else():
            # OPA accepts else only on complete rules and functions
            # (ast/parser_ext.go:689 else-linkage; rego.peg:39)
            if kind not in ("complete", "function") or is_default:
                raise ParseError(
                    "`else` is only valid on complete rules and functions",
                    self.cur().loc)
            els = self._parse_else_chain(name, kind, args)
        return Rule(name=name, kind=kind, args=args, key=key, value=value,
                    body=body, is_default=is_default, loc=loc, els=els)

    def _at_else(self) -> bool:
        """Is the next non-newline token `else`?  OPA's whitespace rule
        lets a chain clause start on its own line; `else` is a keyword
        so the lookahead is unambiguous (no rule can be named else).
        Consumes the newlines only when the answer is yes."""
        save = self.pos
        self.skip_newlines()
        if self.at("keyword", "else"):
            return True
        self.pos = save
        return False

    def _parse_else_chain(self, name: str, kind: str, args):
        """One `else [= value] { body }` clause (plus its own tail).
        Else clauses share the head's params — the clause head cannot
        rebind them (mirrors OPA's Rule.Else chain)."""
        loc = self.expect("keyword", "else").loc
        value = None
        if self.at("op", "=") or self.at("op", ":="):
            self.advance()
            self._nlskip += 1
            value = self.parse_expr()
            self._nlskip -= 1
        body: tuple[Literal, ...] = ()
        if self.at("op", "{"):
            body = self.parse_body()
        elif value is None:
            t = self.cur()
            raise ParseError(
                f"expected `= value` or body after else, got {t.value!r}",
                t.loc)
        els = None
        if self._at_else():
            els = self._parse_else_chain(name, kind, args)
        return Rule(name=name, kind=kind, args=args, key=None, value=value,
                    body=body, is_default=False, loc=loc, els=els)

    def parse_body(self) -> tuple[Literal, ...]:
        """`{` newline-or-semicolon separated literals `}`."""
        self.expect("op", "{")
        lits: list[Literal] = []
        while True:
            self.skip_newlines()
            while self.at("op", ";"):
                self.advance()
                self.skip_newlines()
            if self.at("op", "}"):
                self.advance()
                break
            lits.append(self.parse_literal())
            # literal must be followed by separator or }
            t = self.cur()
            if not (t.kind == "newline" or (t.kind == "op" and t.value in (";", "}"))):
                raise ParseError(f"expected newline, ';' or '}}' after statement, got {t.value!r}", t.loc)
        return tuple(lits)

    def _parse_query_semis(self) -> tuple[Literal, ...]:
        """Semicolon-separated query (comprehension bodies); newlines skipped."""
        lits = [self.parse_literal()]
        while self.at("op", ";"):
            self.advance()
            lits.append(self.parse_literal())
        return tuple(lits)

    def parse_literal(self) -> Literal:
        loc = self.cur().loc
        if self.at("keyword", "some"):
            self.advance()
            names = [str(self.expect("ident").value)]
            while self.at("op", ","):
                self.advance()
                names.append(str(self.expect("ident").value))
            return Literal(expr=SomeDecl(tuple(names)), loc=loc)
        negated = False
        if self.at("keyword", "not"):
            negated = True
            self.advance()
        expr = self.parse_expr_or_assign()
        withs = []
        while self.at("keyword", "with"):
            self.advance()
            target = self.parse_ref_only()
            self.expect("keyword", "as")
            val = self.parse_expr()
            withs.append(WithMod(target=target, value=val))
        return Literal(expr=expr, negated=negated, withs=tuple(withs), loc=loc)

    def parse_ref_only(self) -> Ref:
        t = self.expect("ident")
        base = Var(str(t.value))
        path = []
        while self.at("op", "."):
            self.advance()
            path.append(Scalar(str(self.expect("ident").value)))
        return Ref(base=base, path=tuple(path))

    def parse_expr_or_assign(self):
        lhs = self.parse_expr()
        if self.at("op", ":=") or self.at("op", "="):
            op = str(self.advance().value)
            self._nlskip += 1
            rhs = self.parse_expr()
            self._nlskip -= 1
            return Assign(op=op, lhs=lhs, rhs=rhs)
        return lhs

    # --- expressions (precedence climbing) ---
    # compare < set-union/inter < additive < multiplicative < unary < postfix

    def parse_expr(self):
        lhs = self.parse_setop()
        if self.at("op") and self.cur().value in COMPARE_OPS:
            op = str(self.advance().value)
            self._nlskip += 1
            rhs = self.parse_setop()
            self._nlskip -= 1
            return Compare(op=op, lhs=lhs, rhs=rhs)
        return lhs

    def parse_setop(self) -> Term:
        lhs = self.parse_additive()
        while (self.at("op", "|") and self._union_ok) or self.at("op", "&"):
            op = str(self.advance().value)
            self._nlskip += 1
            rhs = self.parse_additive()
            self._nlskip -= 1
            lhs = BinOp(op=op, lhs=lhs, rhs=rhs)
        return lhs

    def parse_additive(self) -> Term:
        lhs = self.parse_multiplicative()
        while self.at("op", "+") or self.at("op", "-"):
            op = str(self.advance().value)
            self._nlskip += 1
            rhs = self.parse_multiplicative()
            self._nlskip -= 1
            lhs = BinOp(op=op, lhs=lhs, rhs=rhs)
        return lhs

    def parse_multiplicative(self) -> Term:
        lhs = self.parse_unary()
        while self.at("op", "*") or self.at("op", "/") or self.at("op", "%"):
            op = str(self.advance().value)
            self._nlskip += 1
            rhs = self.parse_unary()
            self._nlskip -= 1
            lhs = BinOp(op=op, lhs=lhs, rhs=rhs)
        return lhs

    def parse_unary(self) -> Term:
        if self.at("op", "-"):
            self.advance()
            return UnaryMinus(self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self) -> Term:
        term = self.parse_primary()
        while True:
            if self.at("op", "."):
                self.advance()
                field = str(self.expect("ident").value)
                term = self._extend_ref(term, Scalar(field))
            elif self.at("op", "["):
                self.advance()
                self._nlskip += 1
                idx = self.parse_expr()
                self.expect("op", "]")
                self._nlskip -= 1
                term = self._extend_ref(term, idx)
            elif self.at("op", "("):
                term = self._parse_call(term)
            else:
                return term

    def _extend_ref(self, term: Term, operand: Term) -> Ref:
        if isinstance(term, Ref):
            return Ref(base=term.base, path=term.path + (operand,))
        return Ref(base=term, path=(operand,))

    def _parse_call(self, fn_term: Term) -> Term:
        # function name must be a dotted string ref over a var base
        name = self._ref_to_name(fn_term)
        if name is None:
            raise ParseError("cannot call a non-identifier", self.cur().loc)
        self.expect("op", "(")
        self._nlskip += 1
        saved_union = self._union_ok
        self._union_ok = True
        args = []
        while not self.at("op", ")"):
            args.append(self.parse_expr())
            if self.at("op", ","):
                self.advance()
            elif not self.at("op", ")"):
                raise ParseError(f"expected ',' or ')' in call args, got {self.cur().value!r}",
                                 self.cur().loc)
        self._union_ok = saved_union
        self.expect("op", ")")
        self._nlskip -= 1
        return Call(name=name, args=tuple(args))

    @staticmethod
    def _ref_to_name(term: Term) -> tuple[str, ...] | None:
        if isinstance(term, Var):
            return (term.name,)
        if isinstance(term, Ref) and isinstance(term.base, Var):
            parts = [term.base.name]
            for p in term.path:
                if not (isinstance(p, Scalar) and isinstance(p.value, str)):
                    return None
                parts.append(p.value)
            return tuple(parts)
        return None

    def _fresh_wildcard(self) -> Var:
        return Var(f"$w{next(self._wild)}")

    def parse_primary(self) -> Term:
        t = self.cur()
        if t.kind == "string":
            self.advance()
            return Scalar(t.value)
        if t.kind == "number":
            self.advance()
            return Scalar(t.value)
        if t.kind == "keyword" and t.value in ("true", "false", "null"):
            self.advance()
            return Scalar({"true": True, "false": False, "null": None}[str(t.value)])
        if t.kind == "ident":
            self.advance()
            if t.value == "_":
                return self._fresh_wildcard()
            return Var(str(t.value))
        if t.kind == "op" and t.value == "(":
            self.advance()
            self._nlskip += 1
            saved_union = self._union_ok
            self._union_ok = True
            inner = self.parse_expr()
            self._union_ok = saved_union
            self.expect("op", ")")
            self._nlskip -= 1
            if isinstance(inner, Compare):
                # parenthesized comparison used as a value-position bool expr
                return Call(name=("internal", "compare"),
                            args=(Scalar(inner.op), inner.lhs, inner.rhs))
            return inner
        if t.kind == "op" and t.value == "[":
            return self._parse_array_or_comprehension()
        if t.kind == "op" and t.value == "{":
            return self._parse_braced()
        raise ParseError(f"unexpected token {t.value!r} in expression", t.loc)

    def _parse_array_or_comprehension(self) -> Term:
        self.expect("op", "[")
        self._nlskip += 1
        saved_union = self._union_ok
        try:
            if self.at("op", "]"):
                self.advance()
                return ArrayTerm(())
            self._union_ok = False
            first = self.parse_expr()
            self._union_ok = saved_union
            if self.at("op", "|"):
                self.advance()
                body = self._parse_query_semis()
                self.expect("op", "]")
                return Comprehension(kind="array", head=(self._as_term(first),), body=body)
            items = [first]
            while self.at("op", ","):
                self.advance()
                if self.at("op", "]"):
                    break
                items.append(self.parse_expr())
            self.expect("op", "]")
            return ArrayTerm(tuple(self._as_term(i) for i in items))
        finally:
            self._union_ok = saved_union
            self._nlskip -= 1

    def _parse_braced(self) -> Term:
        """Set literal, object literal, set comprehension, or object comprehension."""
        self.expect("op", "{")
        self._nlskip += 1
        saved_union = self._union_ok
        try:
            if self.at("op", "}"):
                self.advance()
                return ObjectTerm(())  # {} is the empty OBJECT in Rego
            self._union_ok = False
            first = self.parse_expr()
            self._union_ok = saved_union
            if self.at("op", ":"):
                self.advance()
                self._union_ok = False
                val = self.parse_expr()
                self._union_ok = saved_union
                if self.at("op", "|"):
                    self.advance()
                    body = self._parse_query_semis()
                    self.expect("op", "}")
                    return Comprehension(kind="object",
                                         head=(self._as_term(first), self._as_term(val)),
                                         body=body)
                pairs = [(self._as_term(first), self._as_term(val))]
                while self.at("op", ","):
                    self.advance()
                    if self.at("op", "}"):
                        break
                    k = self.parse_expr()
                    self.expect("op", ":")
                    v = self.parse_expr()
                    pairs.append((self._as_term(k), self._as_term(v)))
                self.expect("op", "}")
                return ObjectTerm(tuple(pairs))
            if self.at("op", "|"):
                self.advance()
                body = self._parse_query_semis()
                self.expect("op", "}")
                return Comprehension(kind="set", head=(self._as_term(first),), body=body)
            items = [first]
            while self.at("op", ","):
                self.advance()
                if self.at("op", "}"):
                    break
                items.append(self.parse_expr())
            self.expect("op", "}")
            return SetTerm(tuple(self._as_term(i) for i in items))
        finally:
            self._union_ok = saved_union
            self._nlskip -= 1

    @staticmethod
    def _as_term(e) -> Term:
        if isinstance(e, Compare):
            return Call(name=("internal", "compare"), args=(Scalar(e.op), e.lhs, e.rhs))
        return e


def parse_module(src: str, filename: str = "") -> Module:
    return Parser(src, filename).parse_module()
