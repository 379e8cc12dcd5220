# Copied from gatekeeper_tpu/ir/program.py for the PyTorch port.
"""The vectorized predicate IR.

The TPU-side analogue of OPA's plan IR (reference:
internal/ir/ir.go:17-41 — ``Policy{Static, Plan{Blocks[Stmts]}}``, the
precedent for "compile Rego to a lower-level target", there aimed at
Wasm via internal/compiler/wasm/wasm.go:98).  Ours is aimed at XLA and
is *vectorized over the (constraints × resources) matrix* instead of
scalar per document.

A ``Program`` is a flat SSA list of ``Node``s plus one ``RuleSpec`` per
``violation`` clause of the template.  Evaluating a program yields a
boolean violation mask ``[n_constraints, n_resources]``.  Everything
string-shaped was resolved on the host during lowering/prep:

- per-resource string/number field columns (ids into the interner),
- per-element columns for one list axis (``spec.containers[*]``),
- host-evaluated lookup tables (unique value id -> predicate/number),
- parametric tables [n_params, n_values] for (value, constraint-param)
  predicates such as ``startswith(image, repo)``,
- per-constraint scalars and padded id-sets.

The device program is therefore pure integer/boolean/float tensor
algebra: gathers, compares, logic, and masked reductions — exactly what
XLA fuses well on TPU.

Tri-state semantics: every node evaluates to (defined, value).  A rule
fires for a (constraint, resource) pair when all conjuncts are defined
and truthy (with at most one existential element axis reduced by
``any``).  Undefined mirrors the oracle's UNDEFINED (rego/interp.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any

# Node ops.  `args` are child node indices; `meta` carries static
# parameters (input names, comparison op, ...).  Inputs are referenced by
# name into the Bindings dict produced by ir/prep.py.
#
#   const        meta=(value, dtype)
#   input        meta=(name, kind)        kind: 'r_id' | 'r_num' | 'r_bool'
#                                          | 'e_id' | 'e_num' | 'e_bool'
#                                          | 'c_id' | 'c_num' | 'c_bool'
#   table        args=(idx,) meta=(table_name,)        unary host table
#   dfa_match    args=(idx,) meta=(dfa_name,)   regex as in-program byte
#                  DFA: idx is an interned val-mode string-id column; the
#                  bound [S, 256] transition table scans the interner's
#                  packed byte matrix on device (no host table rebuild)
#   ptable_any   args=(idx,) meta=(table_name, cset_name)
#                  any over the constraint's param-set of tbl[p, idx]
#   ptable_all   args=(idx,) meta=(table_name, cset_name)
#   cmp          args=(a, b) meta=(op,)   op in == != < <= > >=
#   and/or       args=(a, b)
#   not          args=(a,)                Rego negation-as-failure
#   in_cset      args=(idx,) meta=(cset_name,)   id-membership
#   cset_not_subset_memb  args=() meta=(cset_name, memb_name)
#                  fused: exists id in constraint set NOT present in the
#                  resource's membership matrix memb[L, R]
#   any_e/all_e/count_e   args=(a,) reduce the element axis (masked)
#   arith        args=(a, b) meta=(op,)   + - * /

NUM_OPS = frozenset({"+", "-", "*", "/"})
CMP_OPS = frozenset({"==", "!=", "<", "<=", ">", ">="})


@dataclasses.dataclass(frozen=True)
class Node:
    op: str
    args: tuple[int, ...] = ()
    meta: tuple = ()


@dataclasses.dataclass(frozen=True)
class RuleSpec:
    """One violation clause: conjunct node ids + optional element axis.

    ``elem_axis`` names the dense element binding (a key into the
    Bindings' element-presence masks), e.g. ``"spec.containers"``.
    """

    conjuncts: tuple[int, ...]
    elem_axis: str | None = None


@dataclasses.dataclass(frozen=True)
class Program:
    nodes: tuple[Node, ...]
    rules: tuple[RuleSpec, ...]

    def cache_key(self) -> tuple:
        """Structural identity for the jit-executable cache (paired with
        shape buckets by the evaluator; cf. the reference recompiling all
        modules on every PutModule, local.go:65-93 — here an unchanged
        program + bucket never recompiles)."""
        return (self.nodes, self.rules)
