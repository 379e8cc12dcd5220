# Copied from gatekeeper_tpu/analysis/costmodel.py for the PyTorch port.
"""The IR axis walks the Stage-5 and Stage-6 certifiers read, and the
devpages scatter price.

Of the JAX package's static cost model only :func:`node_axes`,
:func:`reachable_nodes` and :func:`scatter_worthwhile` are ported: the
footprint (:mod:`.footprint`) and the partition plan (:mod:`.shardplan`)
walk the nodes reachable from a program's rule conjuncts, and the
devpages sweep prices the inventory join's input records with the
third.  The cost vector, its op-class weights and the install-time cost
budget are not part of the port yet.
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


def scatter_worthwhile(n_changed: int, n_total: int,
                       row_bytes: int = 4,
                       dispatch_rows: int = 64) -> bool:
    """Price a row-sized scatter against a full re-upload for one
    device-resident column (the devpages churn seam).

    A scatter moves ``n_changed * row_bytes`` over H2D plus a fixed
    per-dispatch cost (index staging + scatter kernel launch, priced in
    row-equivalents); a re-upload moves ``n_total * row_bytes`` in one
    transfer.  The scatter wins while the churned fraction stays under
    ~50% after the dispatch overhead — at higher churn the dense copy's
    bandwidth beats the gather/scatter addressing."""
    if n_changed <= 0:
        return True
    if n_total <= 0:
        return False
    return (n_changed + dispatch_rows) * 2 <= n_total
