# Copied from gatekeeper_tpu/analysis/ir_verifier.py for the PyTorch port.
"""Stage 2: the lowered-IR verifier.

Validates a device program (ir/program.py) against its PrepSpec before
a kernel runs it: a malformed node would otherwise surface as a
shape/KeyError deep inside a generated kernel, or — worse —
silently gather garbage.  Checks, per node:

* **SSA form** — every ``args`` entry references an earlier node;
* **op universe / arity** — the op is one the evaluator
  (engine/executor.py, kernels/ir_eval.py) implements, with the
  argument count it expects;
* **binding resolution** — every meta name (input column, interned
  table, constraint set, membership matrix, keyed-val table, element
  axis) resolves to a request in the PrepSpec, with the input kind the
  spec's request implies (``ir_dangling_ref`` otherwise);
* **dtype classes** — operands carry the class (bool/num/id) the op
  consumes: comparisons never mix namespaces, ordering and arithmetic
  are numeric-only, masks are bool (``ir_type_mismatch``);
* **gather bounds** — a ``table``/``ptable_*`` gather's index operand
  must be the interned input column the table was built over
  (``TableReq.src``): the table's rows are indexed by exactly that
  column's intern ids, so the gather is in-bounds by construction.
  Any other index source cannot be proven in-bounds and is rejected
  (``ir_shape_mismatch``);
* **provider tags** — when a declared-provider set is given, every
  ``TableReq.ext_providers`` tag must resolve (``ir_bad_provider_ref``).

All findings are error severity: a device program is either
well-formed or it must not reach a kernel.  The engine treats findings as
"fall back to the scalar oracle" unless GATEKEEPER_IR_VERIFY=strict
(see engine/torch_driver.py); GATEKEEPER_IR_VERIFY=off skips the pass.

Module counters VERIFY_RUNS / VERIFY_VIOLATIONS let the test suite
assert the verifier actually ran over every program it lowered, with
zero violations.
"""

from __future__ import annotations

from gatekeeper_tpu_torch.analysis.diagnostics import ERROR, Diagnostic
from gatekeeper_tpu_torch.errors import Location
from gatekeeper_tpu_torch.ir.program import CMP_OPS, NUM_OPS, Node, Program

VERIFY_RUNS = 0
VERIFY_VIOLATIONS = 0

# arg-count per op (None = checked specially)
_ARITY = {
    "const": 0, "input": 0, "table": 1, "dfa_match": 1,
    "ptable_any": 1, "ptable_all": 1,
    "keyed_val": 0, "cmp": 2, "and": 2, "or": 2, "not": 1, "in_cset": 1,
    "cset_not_subset_memb": 0, "cset_subset_memb": 0,
    "elem_keys_missing": 0, "any_e": 1, "all_e": 1, "count_e": 1,
    "arith": 2,
}

_INPUT_KINDS = frozenset({
    "r_id", "r_num", "r_bool", "e_id", "e_num", "e_bool",
    "c_id", "c_num", "c_bool",
})

# RColReq/EColReq mode -> the input-node kind suffix lowering emits
_MODE_SUFFIX = {"str": "id", "val": "id", "num": "num", "len": "num",
                "truthy": "bool", "present": "bool"}
# CValReq kind -> input-node kind
_CVAL_KIND = {"num": "c_num", "str": "c_id", "val": "c_id", "bool": "c_bool"}
# TableReq out -> node dtype class
_TABLE_CLASS = {"bool": "bool", "num": "num", "id_str": "id", "id_val": "id"}


def _spec_bindings(spec) -> dict[str, str]:
    """name -> expected input-node kind, over every request family that
    lowering materializes as an ``input`` node."""
    out: dict[str, str] = {}
    for r in spec.r_cols:
        out[r.name] = "r_" + _MODE_SUFFIX.get(r.mode, "?")
    for e in spec.e_cols:
        out[e.name] = "e_" + _MODE_SUFFIX.get(e.mode, "?")
    for cv in spec.cvals:
        out[cv.name] = _CVAL_KIND.get(cv.kind, "?")
    for ij in spec.inv_joins:
        out[ij.name] = "r_bool"
    return out


def verify_program(lowered, providers: "set[str] | None" = None,
                   file: str = "") -> list[Diagnostic]:
    """Verify one LoweredProgram (ir/lower.py).  Returns a (possibly
    empty) list of error-severity diagnostics and bumps the module
    counters.  ``providers=None`` skips the provider-tag check (the
    engine verifies structure only; install-time callers pass the
    declared set)."""
    global VERIFY_RUNS, VERIFY_VIOLATIONS
    program: Program = lowered.program
    spec = lowered.spec
    # `loc` is rebound per node / per rule below so every diagnostic
    # carries the offending position (Location.row = node or rule index
    # in the lowered program — the IR has no source text, so the index
    # IS the address a debugger needs)
    loc = Location(file=file)
    diags: list[Diagnostic] = []

    def err(code: str, msg: str) -> None:
        diags.append(Diagnostic(code, ERROR, msg, loc))

    bindings = _spec_bindings(spec)
    tables = {t.name: t for t in spec.tables}
    ptables = {t.name: t for t in spec.ptables}
    dfas = {d.name: d for d in getattr(spec, "dfas", ())}
    csets = {c.name for c in spec.csets}
    membs = {m.name for m in spec.membs}
    elem_keys = {ek.name for ek in spec.elem_keys}
    keyed_vals = {kv.name for kv in spec.keyed_vals}
    axes = {ax for ax, _base in spec.axes}

    classes: list[str] = []  # per-node dtype class: bool | num | id | ?

    def input_node_named(nid: int, want_src: str) -> bool:
        n = program.nodes[nid]
        return n.op == "input" and n.meta and n.meta[0] == want_src

    for i, n in enumerate(program.nodes):
        loc = Location(row=i, file=file)
        cls = "?"
        if not isinstance(n, Node) or _ARITY.get(n.op) is None:
            err("ir_unknown_op", f"node {i}: unknown op {n.op!r}")
            classes.append(cls)
            continue
        if len(n.args) != _ARITY[n.op]:
            err("ir_shape_mismatch",
                f"node {i} ({n.op}): expected {_ARITY[n.op]} args, "
                f"got {len(n.args)}")
            classes.append(cls)
            continue
        if any(a < 0 or a >= i for a in n.args):
            err("ir_dangling_ref",
                f"node {i} ({n.op}): args {n.args} reference a node at "
                f"or after position {i} (program is not in SSA order)")
            classes.append(cls)
            continue
        acls = [classes[a] for a in n.args]

        if n.op == "const":
            if len(n.meta) != 2 or n.meta[1] not in ("float32", "bool"):
                err("ir_type_mismatch",
                    f"node {i} (const): meta must be (value, "
                    f"'float32'|'bool'), got {n.meta!r}")
            else:
                cls = "num" if n.meta[1] == "float32" else "bool"
        elif n.op == "input":
            if len(n.meta) != 2 or n.meta[1] not in _INPUT_KINDS:
                err("ir_type_mismatch",
                    f"node {i} (input): bad kind in meta {n.meta!r}")
            else:
                name, kind = n.meta
                want = bindings.get(name)
                if want is None:
                    err("ir_dangling_ref",
                        f"node {i} (input): column {name!r} has no "
                        "request in the PrepSpec")
                elif want != kind:
                    err("ir_type_mismatch",
                        f"node {i} (input): column {name!r} is bound as "
                        f"{want} but the node declares {kind}")
                cls = {"id": "id", "num": "num", "bool": "bool"}[
                    kind.split("_")[1]]
        elif n.op == "table":
            if len(n.meta) != 1:
                err("ir_shape_mismatch",
                    f"node {i} (table): meta must be (tname,), "
                    f"got {n.meta!r}")
            else:
                req = tables.get(n.meta[0])
                if req is None:
                    err("ir_dangling_ref",
                        f"node {i} (table): table {n.meta[0]!r} has no "
                        "TableReq in the PrepSpec")
                else:
                    cls = _TABLE_CLASS.get(req.out, "?")
                    if not input_node_named(n.args[0], req.src):
                        err("ir_shape_mismatch",
                            f"node {i} (table {req.name}): gather index "
                            f"is not the interned source column "
                            f"{req.src!r}; in-bounds access cannot be "
                            "proven")
                    elif acls[0] != "id":
                        err("ir_type_mismatch",
                            f"node {i} (table {req.name}): index operand "
                            f"must be an interned id column, got "
                            f"{acls[0]}")
                    if providers is not None:
                        for p in req.ext_providers:
                            if p not in providers:
                                err("ir_bad_provider_ref",
                                    f"node {i} (table {req.name}): "
                                    f"external-data tag {p!r} does not "
                                    "resolve to a declared provider")
        elif n.op == "dfa_match":
            if len(n.meta) != 1:
                err("ir_shape_mismatch",
                    f"node {i} (dfa_match): meta must be (dfa_name,), "
                    f"got {n.meta!r}")
            else:
                req = dfas.get(n.meta[0])
                if req is None:
                    err("ir_dangling_ref",
                        f"node {i} (dfa_match): dfa {n.meta[0]!r} has no "
                        "DfaReq in the PrepSpec")
                else:
                    if not input_node_named(n.args[0], req.src):
                        err("ir_shape_mismatch",
                            f"node {i} (dfa_match {req.name}): gather "
                            f"index is not the interned source column "
                            f"{req.src!r}; in-bounds access cannot be "
                            "proven")
                    elif acls[0] != "id":
                        err("ir_type_mismatch",
                            f"node {i} (dfa_match {req.name}): index "
                            f"operand must be an interned id column, got "
                            f"{acls[0]}")
            cls = "bool"
        elif n.op in ("ptable_any", "ptable_all"):
            if len(n.meta) != 2 or n.meta[0] != n.meta[1]:
                err("ir_shape_mismatch",
                    f"node {i} ({n.op}): meta must be (tname, tname), "
                    f"got {n.meta!r}")
            else:
                req = ptables.get(n.meta[0])
                if req is None:
                    err("ir_dangling_ref",
                        f"node {i} ({n.op}): ptable {n.meta[0]!r} has no "
                        "PTableReq in the PrepSpec")
                elif not input_node_named(n.args[0], req.src):
                    err("ir_shape_mismatch",
                        f"node {i} ({n.op} {req.name}): gather index is "
                        f"not the interned source column {req.src!r}")
                cls = "bool"
        elif n.op == "keyed_val":
            if len(n.meta) != 1 or n.meta[0] not in keyed_vals:
                err("ir_dangling_ref",
                    f"node {i} (keyed_val): {n.meta!r} has no "
                    "KeyedValReq in the PrepSpec")
            cls = "id"
        elif n.op == "in_cset":
            if len(n.meta) != 1 or n.meta[0] not in csets:
                err("ir_dangling_ref",
                    f"node {i} (in_cset): {n.meta!r} has no CSetReq in "
                    "the PrepSpec")
            if acls[0] != "id":
                err("ir_type_mismatch",
                    f"node {i} (in_cset): member operand must be an "
                    f"interned id, got {acls[0]}")
            cls = "bool"
        elif n.op in ("cset_not_subset_memb", "cset_subset_memb"):
            if len(n.meta) != 2:
                err("ir_shape_mismatch",
                    f"node {i} ({n.op}): meta must be (cset, memb), "
                    f"got {n.meta!r}")
            else:
                if n.meta[0] not in csets:
                    err("ir_dangling_ref",
                        f"node {i} ({n.op}): cset {n.meta[0]!r} has no "
                        "CSetReq in the PrepSpec")
                if n.meta[1] not in membs:
                    err("ir_dangling_ref",
                        f"node {i} ({n.op}): membership {n.meta[1]!r} "
                        "has no MembReq in the PrepSpec")
            cls = "bool"
        elif n.op == "elem_keys_missing":
            if len(n.meta) != 2:
                err("ir_shape_mismatch",
                    f"node {i} ({n.op}): meta must be (cset, elem_keys),"
                    f" got {n.meta!r}")
            else:
                if n.meta[0] not in csets:
                    err("ir_dangling_ref",
                        f"node {i} ({n.op}): cset {n.meta[0]!r} has no "
                        "CSetReq in the PrepSpec")
                if n.meta[1] not in elem_keys:
                    err("ir_dangling_ref",
                        f"node {i} ({n.op}): elem-keys {n.meta[1]!r} "
                        "has no ElemKeysReq in the PrepSpec")
            cls = "bool"
        elif n.op == "cmp":
            if len(n.meta) != 1 or n.meta[0] not in CMP_OPS:
                err("ir_shape_mismatch",
                    f"node {i} (cmp): meta must name one of {CMP_OPS}, "
                    f"got {n.meta!r}")
            else:
                cop = n.meta[0]
                if cop in ("<", "<=", ">", ">="):
                    if acls != ["num", "num"]:
                        err("ir_type_mismatch",
                            f"node {i} (cmp {cop}): ordering is "
                            f"numeric-only, got {acls}")
                elif not (acls == ["num", "num"] or acls == ["id", "id"]):
                    err("ir_type_mismatch",
                        f"node {i} (cmp {cop}): operands must both be "
                        f"num or both interned ids, got {acls}")
            cls = "bool"
        elif n.op == "arith":
            if len(n.meta) != 1 or n.meta[0] not in NUM_OPS:
                err("ir_shape_mismatch",
                    f"node {i} (arith): meta must name one of "
                    f"{NUM_OPS}, got {n.meta!r}")
            elif acls != ["num", "num"]:
                err("ir_type_mismatch",
                    f"node {i} (arith {n.meta[0]}): operands must be "
                    f"numeric, got {acls}")
            cls = "num"
        elif n.op in ("and", "or", "not"):
            # operands of any class: the evaluator's _fires() coerces
            # non-bool values to their definedness mask
            cls = "bool"
        elif n.op in ("any_e", "all_e", "count_e"):
            if len(n.meta) != 1 or n.meta[0] not in axes:
                err("ir_dangling_ref",
                    f"node {i} ({n.op}): element axis {n.meta!r} is not "
                    "declared in the PrepSpec")
            cls = "num" if n.op == "count_e" else "bool"
        classes.append(cls)

    nn = len(program.nodes)
    for ri, rule in enumerate(program.rules):
        loc = Location(row=ri, file=file)
        for ci in rule.conjuncts:
            if ci < 0 or ci >= nn:
                err("ir_dangling_ref",
                    f"rule {ri}: conjunct {ci} is out of range "
                    f"(program has {nn} nodes)")
        if rule.elem_axis is not None and rule.elem_axis not in axes:
            err("ir_dangling_ref",
                f"rule {ri}: element axis {rule.elem_axis!r} is not "
                "declared in the PrepSpec")

    VERIFY_RUNS += 1
    VERIFY_VIOLATIONS += len(diags)
    return diags


def reset_counters() -> None:
    global VERIFY_RUNS, VERIFY_VIOLATIONS
    VERIFY_RUNS = 0
    VERIFY_VIOLATIONS = 0
