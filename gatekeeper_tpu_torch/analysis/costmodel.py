# Copied from gatekeeper_tpu/analysis/costmodel.py for the PyTorch port.
"""The IR axis walks the Stage-5 and Stage-6 certifiers read.

Only :func:`node_axes` and :func:`reachable_nodes` of the JAX package's
static cost model are ported: the footprint (:mod:`.footprint`) and the
partition plan (:mod:`.shardplan`) walk the nodes reachable from a
program's rule conjuncts.  The cost vector, its op-class weights and the
install-time cost budget are not part of the port yet.
"""

from __future__ import annotations


def node_axes(program) -> list[tuple[bool, bool, bool]]:
    """Per-node (c, r, e) axis dependence — which axes the node's value
    varies over.  Mirrors the broadcast semantics of the evaluator's
    ``_to3`` lattice: a node's lattice cell count is the product of the
    padded axes it depends on."""
    out: list[tuple[bool, bool, bool]] = []
    for n in program.nodes:
        arg = [out[a] for a in n.args]
        c = any(a[0] for a in arg)
        r = any(a[1] for a in arg)
        e = any(a[2] for a in arg)
        op = n.op
        if op == "const":
            ax = (False, False, False)
        elif op == "input":
            kind = n.meta[1]
            ax = {"c": (True, False, False),
                  "r": (False, True, False),
                  "e": (False, True, True)}[kind[0]]
        elif op in ("ptable_any", "ptable_all", "in_cset"):
            ax = (True, r, e)
        elif op == "keyed_val":
            ax = (True, True, False)
        elif op in ("cset_not_subset_memb", "cset_subset_memb"):
            ax = (True, True, False)
        elif op == "elem_keys_missing":
            ax = (True, True, True)
        elif op in ("any_e", "all_e", "count_e"):
            ax = (c, r, False)          # the element axis is reduced
        else:   # table / dfa_match / cmp / and / or / not / arith:
            ax = (c, r, e)          # broadcast of args
        out.append(ax)
    return out


def reachable_nodes(program) -> set[int]:
    """Node indices actually evaluated: the evaluator caches lazily, so
    only nodes reachable from rule conjuncts ever run (dead subtrees —
    e.g. those orphaned by a dedup rewrite — are free)."""
    seen: set[int] = set()
    stack = [ci for rule in program.rules for ci in rule.conjuncts]
    while stack:
        i = stack.pop()
        if i in seen or not (0 <= i < len(program.nodes)):
            continue
        seen.add(i)
        stack.extend(program.nodes[i].args)
    return seen
