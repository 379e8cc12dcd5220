# Copied from gatekeeper_tpu/analysis/vetter.py for the PyTorch port.
"""Stage 1: the Rego front-end vetter.

Walks a parsed template module (rego/ast_nodes.py) and emits
:class:`Diagnostic` records for defects that today only surface when
the webhook or audit sweep actually evaluates the template:

==============================  ========  =============================
code                            severity  finding
==============================  ========  =============================
rego_unknown_builtin            error     call name not in the builtin
                                          registry and not a module
                                          function
rego_unsupported_builtin        warning   registered stub (``_unsupported``)
                                          that is undefined at eval
rego_impure_builtin             warning   IMPURE_BUILTINS member — the
                                          result can vary between
                                          evaluations (blocks sharing)
rego_unsafe_var                 error     variable consumed with no
                                          admissible binding order
rego_recursion                  error     rule participates in a
                                          reference cycle
rego_dead_rule                  warning   rule unreachable from any
                                          ``violation`` rule
rego_unbounded_comprehension    error     comprehension head variable
                                          has no generator in its body
rego_bad_provider_ref           error     ``external_data`` names a
                                          provider absent from the
                                          declared set (only checked
                                          when a provider set is given)
rego_dynamic_provider_ref       warning   ``external_data`` provider
                                          argument is not a string
                                          literal — unverifiable
                                          statically
==============================  ========  =============================

Safety analysis reuses the needs/binds computation the body reorderer
already trusts (rego/reorder.py ``_Analysis``) and replays its greedy
schedule: a clause where no admissible ordering exists is exactly the
case ``reorder_body`` gives up on and the interpreter later surfaces as
an eval-time unsafe-variable error — the vetter moves that to install
time.
"""

from __future__ import annotations

from gatekeeper_tpu_torch.analysis.diagnostics import ERROR, WARNING, Diagnostic
from gatekeeper_tpu_torch.errors import Location
from gatekeeper_tpu_torch.rego.ast_nodes import (
    Assign, Call, Compare, Comprehension, Literal, Module, ObjectTerm, Ref,
    Rule, Scalar, SomeDecl, Term, Var, walk_terms,
)
from gatekeeper_tpu_torch.rego.reorder import (
    _Analysis, _collect_pattern_vars, _GLOBALS, _is_wild,
)

# Call names the interpreter resolves specially, outside the registry
# (rego/interp.py _eval_call): trace's no-op fast path, the internal
# comparison shim the parser emits, and the walk generator.
_SPECIAL_CALLS = frozenset({("trace",), ("internal", "compare"), ("walk",)})


def vet_module(module: Module, providers: "set[str] | None" = None,
               file: str = "") -> list[Diagnostic]:
    """Vet one parsed module.  ``providers=None`` skips the
    provider-existence check (caller has no provider registry in scope —
    e.g. Client-side ingestion, where providers may legitimately be
    registered later); pass a concrete set (possibly empty) to enforce
    ``rego_bad_provider_ref``."""
    diags: list[Diagnostic] = []
    rule_names = {r.name for r in module.rules}
    for rule in module.rules:
        clause: Rule | None = rule
        while clause is not None:
            _vet_calls(rule, clause, rule_names, providers, file, diags)
            _vet_safety(rule, clause, rule_names, file, diags)
            clause = clause.els
    _vet_recursion(module, rule_names, file, diags)
    _vet_dead_rules(module, rule_names, file, diags)
    return diags


def _loc(loc: Location, file: str) -> Location:
    if file and not loc.file:
        return Location(row=loc.row, col=loc.col, file=file)
    return loc


# --- builtin / provider checks ----------------------------------------

def _vet_calls(rule: Rule, clause: Rule, rule_names: set,
               providers: "set[str] | None", file: str,
               diags: list[Diagnostic]) -> None:
    from gatekeeper_tpu_torch.analysis.purity import is_impure_builtin
    from gatekeeper_tpu_torch.rego import builtins as bi

    def visit(term: Term, loc: Location) -> None:
        if not isinstance(term, Call):
            return
        name = term.name
        dotted = ".".join(name)
        if name == ("external_data",):
            _vet_external_data(term, providers, loc, diags)
        if name in bi.REGISTRY:
            fn = bi.REGISTRY[name]
            reason = getattr(fn, "unsupported_reason", None)
            if reason is not None:
                diags.append(Diagnostic(
                    "rego_unsupported_builtin", WARNING,
                    f"builtin {dotted} is an unsupported stub "
                    f"({reason}); it is undefined at evaluation", loc))
            if is_impure_builtin(name):
                diags.append(Diagnostic(
                    "rego_impure_builtin", WARNING,
                    f"builtin {dotted} is impure: results may vary "
                    "between evaluations and block result sharing", loc))
        elif name in _SPECIAL_CALLS:
            pass
        elif len(name) == 1 and name[0] in rule_names:
            pass  # user-defined function
        else:
            diags.append(Diagnostic(
                "rego_unknown_builtin", ERROR,
                f"unknown builtin or function {dotted}", loc))

    _walk_clause_terms(clause, visit, _loc(rule.loc, file), file)


def _vet_external_data(call: Call, providers: "set[str] | None",
                       loc: Location, diags: list[Diagnostic]) -> None:
    provider_term: Term | None = None
    if len(call.args) == 1 and isinstance(call.args[0], ObjectTerm):
        for k, v in call.args[0].pairs:
            if isinstance(k, Scalar) and k.value == "provider":
                provider_term = v
    if isinstance(provider_term, Scalar) and isinstance(provider_term.value,
                                                       str):
        if providers is not None and provider_term.value not in providers:
            known = ", ".join(sorted(providers)) or "<none>"
            diags.append(Diagnostic(
                "rego_bad_provider_ref", ERROR,
                f"external_data references provider "
                f"{provider_term.value!r} which is not registered "
                f"(registered: {known})", loc))
    else:
        diags.append(Diagnostic(
            "rego_dynamic_provider_ref", WARNING,
            "external_data provider argument is not a string literal; "
            "the reference cannot be verified statically", loc))


def _walk_clause_terms(clause: Rule, visit, head_loc: Location,
                       file: str) -> None:
    """Visit every term of ONE clause (not the else chain), attributing
    head terms to the rule location and body terms to their literal."""
    for t in (clause.args or ()):
        walk_terms(t, lambda x: visit(x, head_loc))
    if clause.key is not None:
        walk_terms(clause.key, lambda x: visit(x, head_loc))
    if clause.value is not None:
        walk_terms(clause.value, lambda x: visit(x, head_loc))
    for lit in clause.body:
        lloc = _loc(lit.loc, file)
        walk_terms(lit, lambda x: visit(x, lloc))


# --- variable safety --------------------------------------------------

def _literal_info(an: _Analysis, lit: Literal) -> tuple[set, set]:
    """needs/binds of one literal, with the interpreter's ``walk``
    special case applied on top of the reorderer's analysis: the 2-arg
    statement form ``walk(x, [path, value])`` unifies its second
    argument as a pattern (rego/interp.py ``_eval_call``), so those
    variables are binds, not needs.  Negated literals keep the base
    analysis — everything under ``not`` must already be bound."""
    needs, binds = an.literal(lit)
    if lit.negated:
        return needs, binds
    walk_binds: set[str] = set()

    def visit(t: Term) -> None:
        if isinstance(t, Call) and t.name == ("walk",) and len(t.args) == 2:
            _collect_pattern_vars(t.args[1], walk_binds)

    walk_terms(lit, visit)
    if walk_binds:
        needs = needs - walk_binds
        binds = binds | walk_binds
    return needs, binds


def _vet_safety(rule: Rule, clause: Rule, rule_names: set, file: str,
                diags: list[Diagnostic]) -> None:
    an = _Analysis(rule_names)
    params: set[str] = set()
    for p in (clause.args or ()):
        _collect_pattern_vars(p, params)
    infos = [_literal_info(an, l) for l in clause.body]
    all_binds: set[str] = set(params)
    for _, b in infos:
        all_binds |= b

    # comprehension-head safety first: a head variable with no
    # generator gets its dedicated code, and is then excluded from the
    # generic unsafe-var reporting below (the outer analysis propagates
    # it as a clause-level need too — one finding, not two).  The outer
    # scope is over-approximated as everything the clause OR any of its
    # comprehension bodies can bind, so only genuinely generator-less
    # variables fire.
    comp_scope = all_binds | _all_comprehension_binds(clause, an)
    comp_flagged: set[str] = set()
    for lit in clause.body:
        lloc = _loc(lit.loc, file)
        walk_terms(lit, lambda t, _l=lloc: _vet_comprehension(
            t, rule, rule_names, comp_scope, _l, diags, comp_flagged))
    for t in [clause.key, clause.value]:
        if t is not None:
            walk_terms(t, lambda x: _vet_comprehension(
                x, rule, rule_names, comp_scope, _loc(rule.loc, file),
                diags, comp_flagged))

    # vars needed somewhere but bound nowhere in the clause
    reported: set[str] = set(comp_flagged)
    for lit, (needs, _) in zip(clause.body, infos):
        for v in sorted(needs - all_binds):
            if v not in reported:
                reported.add(v)
                diags.append(Diagnostic(
                    "rego_unsafe_var", ERROR,
                    f"variable {v!r} is unsafe in rule {rule.name!r}: "
                    "nothing in the clause binds it", _loc(lit.loc, file)))

    # replay the reorderer's greedy schedule; a stall = no admissible
    # ordering (mutually-dependent literals)
    bound = set(params) | reported
    remaining = list(range(len(clause.body)))
    while remaining:
        picked = None
        for idx in remaining:
            if infos[idx][0] <= bound:
                picked = idx
                break
        if picked is None:
            stuck = sorted(set().union(
                *(infos[i][0] for i in remaining)) - bound)
            diags.append(Diagnostic(
                "rego_unsafe_var", ERROR,
                f"no admissible binding order in rule {rule.name!r}: "
                f"variable(s) {', '.join(repr(v) for v in stuck)} cannot "
                "be bound before use", _loc(clause.body[remaining[0]].loc,
                                            file)))
            bound |= set().union(*(infos[i][1] for i in remaining))
            break
        remaining.remove(picked)
        bound |= infos[picked][1]

    # head terms may only consume bound variables
    head_needs: set[str] = set()
    for t in [clause.key, clause.value] + list(clause.args or ()):
        if t is not None:
            an.term(t, False, head_needs, set())
    for v in sorted(head_needs - bound - params):
        diags.append(Diagnostic(
            "rego_unsafe_var", ERROR,
            f"variable {v!r} in the head of rule {rule.name!r} is never "
            "bound by the body", _loc(rule.loc, file)))


def _all_comprehension_binds(clause: Rule, an: _Analysis) -> set:
    """Union of every comprehension body's binds anywhere in the clause
    — the over-approximated scope nested comprehensions see."""
    out: set[str] = set()

    def visit(t: Term) -> None:
        if isinstance(t, Comprehension):
            for lit in t.body:
                _n, b = _literal_info(an, lit)
                out.update(b)

    for lit in clause.body:
        walk_terms(lit, visit)
    for t in [clause.key, clause.value]:
        if t is not None:
            walk_terms(t, visit)
    return out


def _vet_comprehension(term: Term, rule: Rule, rule_names: set,
                       outer: set, loc: Location,
                       diags: list[Diagnostic], flagged: set) -> None:
    if not isinstance(term, Comprehension):
        return
    an = _Analysis(rule_names)
    inner_binds: set[str] = set()
    for lit in term.body:
        _n, b = _literal_info(an, lit)
        inner_binds |= b
    head_vars: set[str] = set()

    def head_visit(t: Term) -> None:
        if isinstance(t, Var) and t.name not in _GLOBALS \
                and t.name not in rule_names and not _is_wild(t.name):
            head_vars.add(t.name)

    for h in term.head:
        walk_terms(h, head_visit)
    scope = inner_binds | outer
    for v in sorted(head_vars - scope):
        if v in flagged:
            continue
        flagged.add(v)
        diags.append(Diagnostic(
            "rego_unbounded_comprehension", ERROR,
            f"comprehension in rule {rule.name!r} iterates variable "
            f"{v!r} with no generator: the head ranges over an "
            "unbounded domain", loc))


# --- rule graph: recursion + dead rules -------------------------------

def _rule_edges(module: Module, rule_names: set) -> dict[str, set[str]]:
    edges: dict[str, set[str]] = {r.name: set() for r in module.rules}

    def refs_of(clause: Rule) -> set[str]:
        out: set[str] = set()

        def visit(t: Term) -> None:
            if isinstance(t, Var) and t.name in rule_names:
                out.add(t.name)
            elif isinstance(t, Call) and len(t.name) == 1 \
                    and t.name[0] in rule_names:
                out.add(t.name[0])
            elif isinstance(t, Ref) and isinstance(t.base, Var) \
                    and t.base.name in rule_names:
                out.add(t.base.name)

        walk_terms(clause, visit)
        return out

    for rule in module.rules:
        clause: Rule | None = rule
        while clause is not None:
            edges[rule.name] |= refs_of(clause)
            clause = clause.els
    return edges


def _vet_recursion(module: Module, rule_names: set, file: str,
                   diags: list[Diagnostic]) -> None:
    edges = _rule_edges(module, rule_names)
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in edges}
    on_cycle: set[str] = set()

    def dfs(n: str, stack: list[str]) -> None:
        color[n] = GRAY
        stack.append(n)
        for m in sorted(edges[n]):
            if color[m] == GRAY:
                on_cycle.update(stack[stack.index(m):])
            elif color[m] == WHITE:
                dfs(m, stack)
        stack.pop()
        color[n] = BLACK

    for n in sorted(edges):
        if color[n] == WHITE:
            dfs(n, [])
    for rule in module.rules:
        if rule.name in on_cycle:
            diags.append(Diagnostic(
                "rego_recursion", ERROR,
                f"rule {rule.name!r} is recursive (rule references form "
                "a cycle)", _loc(rule.loc, file)))
            on_cycle.discard(rule.name)  # one finding per name


def _vet_dead_rules(module: Module, rule_names: set, file: str,
                    diags: list[Diagnostic]) -> None:
    if "violation" not in rule_names:
        return  # conformance checking rejects these modules already
    edges = _rule_edges(module, rule_names)
    live: set[str] = set()
    frontier = ["violation"]
    while frontier:
        n = frontier.pop()
        if n in live:
            continue
        live.add(n)
        frontier.extend(edges.get(n, ()))
    seen: set[str] = set()
    for rule in module.rules:
        if rule.name not in live and rule.name not in seen:
            seen.add(rule.name)
            diags.append(Diagnostic(
                "rego_dead_rule", WARNING,
                f"rule {rule.name!r} is not reachable from any "
                "'violation' rule", _loc(rule.loc, file)))
