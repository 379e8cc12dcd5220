# Copied from gatekeeper_tpu/rego/trace.py for the PyTorch port.
"""Per-step evaluation tracer for the scalar oracle.

Native equivalent of OPA's topdown tracer + PrettyTrace renderer
(reference: vendor opa/topdown/trace.go:17-160 — Event{Op, Node,
QueryID, Locals} emitted per evaluation step, rendered with one indent
level per query depth).  The op vocabulary matches OPA's:

  Enter  — a rule (or the query itself) starts evaluating
  Eval   — a body literal is evaluated
  Redo   — the literal is re-entered for another solution (backtrack)
  Fail   — the literal produced no solution
  Exit   — the rule completed with a value

The tracer observes the *recursive oracle* path: when a StepTracer is
attached, the interpreter bypasses the closure-compiled tier (same
contract as result-memo bypass under tracing — the tracer must observe
evaluation, rego/interp.py).  Step tracing is a debugging surface, not
a serving path.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from gatekeeper_tpu_torch.rego.ast_nodes import (ArrayTerm, Assign, BinOp, Call,
                                           Compare, Comprehension, Literal,
                                           ObjectTerm, Ref, Rule, Scalar,
                                           SetTerm, SomeDecl, Term,
                                           UnaryMinus, Var, WithMod)

_MAX_VALUE_CHARS = 64


def unparse(node: Any) -> str:
    """Render an AST node back to Rego-ish source for trace display."""
    if isinstance(node, Literal):
        body = unparse(node.expr)
        if node.negated:
            body = f"not {body}"
        if node.withs:
            body += "".join(
                f" with {unparse(w.target)} as {unparse(w.value)}"
                for w in node.withs)
        return body
    if isinstance(node, SomeDecl):
        return f"some {', '.join(node.names)}"
    if isinstance(node, (Compare, Assign)):
        return f"{unparse(node.lhs)} {node.op} {unparse(node.rhs)}"
    if isinstance(node, Scalar):
        v = node.value
        return "null" if v is None else (
            "true" if v is True else "false" if v is False else repr(v)
            if isinstance(v, str) else str(v))
    if isinstance(node, Var):
        return node.name
    if isinstance(node, Ref):
        out = unparse(node.base)
        for p in node.path:
            if isinstance(p, Scalar) and isinstance(p.value, str) \
                    and p.value.isidentifier():
                out += f".{p.value}"
            else:
                out += f"[{unparse(p)}]"
        return out
    if isinstance(node, Call):
        return f"{'.'.join(node.name)}({', '.join(unparse(a) for a in node.args)})"
    if isinstance(node, BinOp):
        return f"{unparse(node.lhs)} {node.op} {unparse(node.rhs)}"
    if isinstance(node, UnaryMinus):
        return f"-{unparse(node.operand)}"
    if isinstance(node, ArrayTerm):
        return f"[{', '.join(unparse(t) for t in node.items)}]"
    if isinstance(node, SetTerm):
        return "{%s}" % ", ".join(unparse(t) for t in node.items)
    if isinstance(node, ObjectTerm):
        return "{%s}" % ", ".join(
            f"{unparse(k)}: {unparse(v)}" for k, v in node.pairs)
    if isinstance(node, Comprehension):
        head = ": ".join(unparse(h) for h in node.head)
        body = "; ".join(unparse(l) for l in node.body)
        open_, close = {"array": "[]", "set": "{}",
                        "object": "{}"}[node.kind]
        return f"{open_}{head} | {body}{close}"
    if isinstance(node, WithMod):
        return f"with {unparse(node.target)} as {unparse(node.value)}"
    if isinstance(node, Rule):
        return node.name
    return str(node)


def _render_value(v: Any) -> str:
    s = repr(v)
    if len(s) > _MAX_VALUE_CHARS:
        s = s[: _MAX_VALUE_CHARS - 1] + "…"
    return s


@dataclasses.dataclass(frozen=True)
class Event:
    """One evaluation step (trace.go Event: Op, Node, QueryID, Locals)."""

    op: str                 # Enter | Eval | Redo | Fail | Exit
    node: str               # unparsed rule head / literal
    query_id: int
    depth: int
    loc: str = ""           # "row:col" when the AST carries it
    locals: tuple = ()      # ((var, rendered value), ...) bound at the step


class StepTracer:
    """Collects step events; attach via QueryOpts(tracing=True) paths
    or Interpreter.query_*(step_tracer=...)."""

    def __init__(self, with_locals: bool = True):
        self.events: list[Event] = []
        self.with_locals = with_locals
        self._depth = 0
        self._next_qid = 0
        self._qid_stack: list[int] = []   # innermost-open query last

    # -- emission hooks (called by the interpreter) ---------------------

    def enter(self, name: str, loc=None) -> int:
        self._next_qid += 1
        qid = self._next_qid
        self._qid_stack.append(qid)
        self.events.append(Event("Enter", name, qid, self._depth,
                                 _loc_str(loc)))
        self._depth += 1
        return qid

    def exit(self, name: str, value: Any) -> None:
        self._depth = max(0, self._depth - 1)
        qid = self._qid_stack.pop() if self._qid_stack else 0
        self.events.append(Event(
            "Exit", f"{name} = {_render_value(value)}", qid, self._depth))

    def step(self, op: str, lit: Any, env: dict | None = None,
             loc=None) -> None:
        locals_ = ()
        if self.with_locals and env:
            locals_ = tuple(sorted(
                (k, _render_value(v)) for k, v in env.items()
                if not k.startswith("$")))
        qid = self._qid_stack[-1] if self._qid_stack else 0
        self.events.append(Event(op, unparse(lit), qid, self._depth,
                                 _loc_str(loc), locals_))

    # -- rendering ------------------------------------------------------

    def pretty(self) -> str:
        """PrettyTrace-style rendering (trace.go:124-160): one line per
        event, indented by depth, locals appended on Eval steps."""
        lines = []
        for e in self.events:
            pad = "| " * (e.depth + 1)
            loc = f"  ({e.loc})" if e.loc else ""
            line = f"{pad}{e.op} {e.node}{loc}"
            if e.locals:
                line += "  {" + ", ".join(
                    f"{k}={v}" for k, v in e.locals) + "}"
            lines.append(line)
        return "\n".join(lines)


def _loc_str(loc) -> str:
    if loc is None:
        return ""
    row = getattr(loc, "row", None) or getattr(loc, "line", None)
    col = getattr(loc, "col", None) or getattr(loc, "column", None)
    if not row:
        return ""
    return f"{row}:{col}" if col else str(row)
