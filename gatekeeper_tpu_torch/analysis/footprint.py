# Copied from gatekeeper_tpu/analysis/footprint.py for the PyTorch port.
"""Stage-5 dependency analysis: column read-set footprints.

An abstract interpreter over the lowered IR computes, per template,

  * the exact set of (source, column-path) reads — object columns,
    review ``$meta`` identity columns, and inventory columns of other
    kinds (inv-joins);
  * the external-data providers consulted by its tables;
  * a **row-locality certificate**: the verdict of row *i* depends only
    on row *i*'s columns.  Every IR op is elementwise along the
    resource axis except the inventory join, so a template is row-local
    iff no reachable node reads an inv-join column;
  * per-column sensitivity classes: ``equality`` (exact value
    matters), ``string-regex`` (value feeds a regex table), ``range``
    (only ordering matters) and ``existence`` (only presence matters).

The port's fleet audit (whatif/fleet.py) stacks a kind across clusters
only when its footprint is row-local with no external providers.

Footprints are *validated, not trusted*: under
``GATEKEEPER_FOOTPRINT=strict`` ``validate_footprint`` reuses the
small-model worlds (analysis/smallmodel.py) to perturb columns OUTSIDE
the claimed read-set and asserts the device mask is bit-identical; a
difference is a FootprintViolation and fails the template install.  The
worlds are evaluated as translation validation evaluates them
(``transval._device_mask``: K1 on the card, its plain version on the
CPU).  Validated footprints persist in the snapshot ``fp`` tier
(resilience/snapshot.py), so a warm restart re-runs zero analyses.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import os

import numpy as np

from gatekeeper_tpu_torch.utils.log import logger

log = logger("footprint")

FOOTPRINT_VERSION = "fp-1"

# fresh analyses this process (a memo hit re-analyzes nothing)
analyses_run = 0

_memo: dict[str, "Footprint"] = {}

# kind -> human reason, for templates whose verdicts read other rows
cross_row: dict[str, str] = {}

# kind -> violations from the most recent strict-mode validation
violations: dict[str, list["FootprintViolation"]] = {}

# sensitivity lattice: join = most value-sensitive class wins
_SENS_ORDER = {"existence": 0, "range": 1, "string-regex": 2, "equality": 3}

# constraint match criteria read these object paths (engine._kind_mask):
# kinds/groups from $meta, namespaces/name/labelSelector from metadata.
# The paged sweep unions them into every template's effective read-set.
MATCH_PATHS: tuple[tuple[str, ...], ...] = (
    ("metadata", "labels"),
    ("metadata", "name"),
    ("metadata", "namespace"),
    ("$meta",),
)

# perturbing these changes world structure (row keys, review identity),
# not column values — never candidate perturbation targets
_IDENTITY_PATHS: tuple[tuple[str, ...], ...] = (
    ("apiVersion",), ("kind",),
    ("metadata", "name"), ("metadata", "namespace"),
)


def mode() -> str:
    """off | on | strict.  ``on`` (default) runs the static analysis at
    install; ``strict`` additionally perturbation-validates every
    footprint at install and fails the install on any violation;
    ``off`` runs nothing."""
    return os.environ.get("GATEKEEPER_FOOTPRINT", "on").strip().lower()


def validation_budget() -> int:
    return int(os.environ.get("GATEKEEPER_FOOTPRINT_MODELS", "16"))


def reset() -> None:
    """Drop the process-global memo and published state (tests)."""
    global analyses_run
    analyses_run = 0
    _memo.clear()
    cross_row.clear()
    violations.clear()


# ---------------------------------------------------------------------------
# results


@dataclasses.dataclass(frozen=True)
class ColumnRead:
    """One column the template's verdict can depend on.

    source: "object" (the reviewed object), "meta" (review identity,
    path starts with "$meta"), or "inventory:<Kind>" (another kind's
    cached objects, via an inv-join).  Paths use "*" for list axes."""

    path: tuple[str, ...]
    source: str
    sensitivity: str

    def format(self) -> str:
        p = ".".join(self.path)
        src = "" if self.source == "object" else f" [{self.source}]"
        return f"{p}{src} ({self.sensitivity})"


@dataclasses.dataclass(frozen=True)
class FootprintViolation:
    """Perturbation validation found a column OUTSIDE the claimed
    read-set that changes the device verdict — an analysis bug."""

    kind: str
    path: tuple[str, ...]
    note: str = ""

    def format(self) -> str:
        return (f"{self.kind}: verdict changed when perturbing "
                f"unclaimed column {'.'.join(self.path)} ({self.note})")


@dataclasses.dataclass(frozen=True)
class Footprint:
    kind: str
    digest: str
    columns: tuple[ColumnRead, ...]
    providers: tuple[str, ...]
    row_local: bool
    cross_row_reasons: tuple[str, ...] = ()
    validated: bool = False
    version: str = FOOTPRINT_VERSION

    def object_paths(self) -> tuple[tuple[str, ...], ...]:
        """Object-column paths (including inventory columns: in the
        audit world the inventory IS the table)."""
        return tuple(c.path for c in self.columns
                     if c.source != "meta")

    def reads_meta(self) -> bool:
        return any(c.source == "meta" for c in self.columns)


# ---------------------------------------------------------------------------
# digest


def _spec_sig(spec) -> tuple:
    """Deterministic signature of every PrepSpec request the analysis
    reads (fn fields excluded — they are compare=False closures; the
    program cache_key pins the semantics that matter)."""
    return (
        tuple((r.name, r.path, r.mode) for r in spec.r_cols),
        tuple((e.name, e.axis, e.base, e.rel, e.mode) for e in spec.e_cols),
        tuple(spec.axes),
        tuple((t.name, t.src, t.out, t.src_val, t.regex, t.ext_providers)
              for t in spec.tables),
        tuple((p.name, p.src, p.src_val) for p in spec.ptables),
        tuple((d.name, d.src, d.pattern) for d in getattr(spec, "dfas", ())),
        tuple((m.name, m.cset, m.keys_path) for m in spec.membs),
        tuple((k.name, k.path) for k in spec.keyed_vals),
        tuple((e.name, e.cset, e.axis) for e in spec.elem_keys),
        tuple((j.name, j.kind, j.inv_path, j.src_path,
               j.exclude_same_name, j.namespaced_only)
              for j in spec.inv_joins),
    )


def footprint_digest(lowered) -> str:
    parts = (FOOTPRINT_VERSION, repr(lowered.program.cache_key()),
             repr(_spec_sig(lowered.spec)))
    return hashlib.sha256("\x1f".join(parts).encode()).hexdigest()


# ---------------------------------------------------------------------------
# the abstract interpreter


def paths_intersect(a: tuple, b: tuple) -> bool:
    """Does a write at path ``a`` affect a read at path ``b`` (or vice
    versa)?  True when one is a component-wise prefix of the other,
    with "*" matching any component — writes below a read subsume it
    and writes above it replace the whole subtree."""
    for x, y in zip(a, b):
        if x != y and x != "*" and y != "*":
            return False
    return True


class _Reads:
    def __init__(self):
        self.uses: dict[tuple[tuple, str], set[str]] = {}
        self.modes: dict[tuple[tuple, str], str] = {}

    def add(self, path: tuple, source: str, mode: str,
            use: str | None = None) -> None:
        key = (path, source)
        self.uses.setdefault(key, set())
        self.modes.setdefault(key, mode)
        if use is not None:
            self.uses[key].add(use)

    def columns(self) -> tuple[ColumnRead, ...]:
        out = []
        for (path, source), uses in self.uses.items():
            if not uses:
                # never consumed by a classifying op: the column's
                # extraction mode decides (a bare truthy/present
                # conjunct only observes existence)
                m = self.modes[(path, source)]
                uses = {"existence" if m in ("present", "truthy")
                        else "equality"}
            sens = max(uses, key=lambda u: _SENS_ORDER[u])
            out.append(ColumnRead(path=path, source=source,
                                  sensitivity=sens))
        return tuple(sorted(out, key=lambda c: (c.source, c.path)))


def _col_keys(name: str, spec, by_r, by_e) -> list[tuple[tuple, str, str]]:
    """(path, source, mode) for an r-/e-column binding name."""
    rc = by_r.get(name)
    if rc is not None:
        src = "meta" if rc.path[:1] == ("$meta",) else "object"
        return [(rc.path, src, rc.mode)]
    ec = by_e.get(name)
    if ec is not None:
        return [(ec.base + ("*",) + ec.rel, "object", ec.mode)]
    return []


def analyze(kind: str, lowered) -> Footprint:
    """Compute the footprint of one lowered template — the exact
    read-set of the nodes reachable from its rule conjuncts (dead
    subtrees read nothing)."""
    from gatekeeper_tpu_torch.analysis.costmodel import reachable_nodes

    spec = lowered.spec
    prog = lowered.program
    by_r = {r.name: r for r in spec.r_cols}
    by_e = {e.name: e for e in spec.e_cols}
    by_t = {t.name: t for t in spec.tables}
    by_pt = {p.name: p for p in spec.ptables}
    by_d = {d.name: d for d in getattr(spec, "dfas", ())}
    by_m = {m.name: m for m in spec.membs}
    by_kv = {k.name: k for k in spec.keyed_vals}
    by_ek = {e.name: e for e in spec.elem_keys}
    by_ij = {j.name: j for j in spec.inv_joins}
    axis_base = dict(spec.axes)

    reads = _Reads()
    providers: set[str] = set()
    reasons: list[str] = []
    reach = reachable_nodes(prog)
    # node index -> the (path, source, mode) keys its value carries
    carried: dict[int, list[tuple[tuple, str, str]]] = {}

    def record(keys, use):
        for path, source, m in keys:
            reads.add(path, source, m, use)

    for i in sorted(reach):
        n = prog.nodes[i]
        op = n.op
        keys: list[tuple[tuple, str, str]] = []
        if op == "input":
            name, _ikind = n.meta
            keys = _col_keys(name, spec, by_r, by_e)
            for path, source, m in keys:
                reads.add(path, source, m)
            ij = by_ij.get(name)
            if ij is not None:
                # the inv-join column is computed from OTHER rows of
                # `ij.kind`: cross-row by nature, and it reads the
                # inventory column plus this row's source/identity
                reads.add(ij.inv_path, f"inventory:{ij.kind}",
                          "val", "equality")
                reads.add(ij.src_path, "object", "val", "equality")
                if ij.exclude_same_name:
                    reads.add(("metadata", "name"), "object", "str",
                              "equality")
                if ij.namespaced_only:
                    reads.add(("metadata", "namespace"), "object", "str",
                              "equality")
                reasons.append(
                    f"inventory join {name}: ∃ other {ij.kind} with "
                    f"{'.'.join(ij.inv_path)} == this "
                    f"{'.'.join(ij.src_path)}")
        elif op in ("table", "ptable_any", "ptable_all"):
            tname = n.meta[0]
            t = by_t.get(tname) or by_pt.get(tname)
            if t is not None:
                use = "string-regex" if getattr(t, "regex", None) \
                    else "equality"
                src_keys = _col_keys(t.src, spec, by_r, by_e)
                record(src_keys, use)
                keys = src_keys
                providers.update(getattr(t, "ext_providers", ()))
        elif op == "dfa_match":
            # the in-program DFA reads the interned byte encoding of the
            # source column: any change to the string's bytes can flip
            # the verdict, so the claim is the column at string-regex
            # sensitivity — what the host-table lowering of the same
            # pattern claims
            d = by_d.get(n.meta[0])
            if d is not None:
                src_keys = _col_keys(d.src, spec, by_r, by_e)
                record(src_keys, "string-regex")
                keys = src_keys
        elif op == "keyed_val":
            (name,) = n.meta
            kv = by_kv.get(name)
            if kv is not None:
                # dict[param key]: any key under the path can be read
                reads.add(kv.path + ("*",), "object", "val", "equality")
                keys = [(kv.path + ("*",), "object", "val")]
        elif op in ("cset_not_subset_memb", "cset_subset_memb"):
            _cname, mname = n.meta
            m = by_m.get(mname)
            if m is not None:
                # the membership matrix observes the KEY SET of the
                # dict at keys_path; the whole subtree is claimed
                # (prefix semantics keep this sound)
                reads.add(m.keys_path, "object", "val", "equality")
        elif op == "elem_keys_missing":
            _cname, ekname = n.meta
            ek = by_ek.get(ekname)
            if ek is not None:
                base = axis_base.get(ek.axis, ())
                reads.add(tuple(base) + ("*",), "object", "val",
                          "existence")
        elif op == "cmp":
            (cop,) = n.meta
            arg_keys = [k for a in n.args for k in carried.get(a, [])]
            ordering = cop in ("<", "<=", ">", ">=")
            for path, source, m in arg_keys:
                use = "range" if ordering and m in ("num", "len") \
                    else "equality"
                reads.add(path, source, m, use)
            keys = arg_keys
        elif op == "in_cset":
            arg_keys = [k for a in n.args for k in carried.get(a, [])]
            record(arg_keys, "equality")
            keys = arg_keys
        else:
            # and/or/not/any_e/all_e/count_e/arith/const: columns flow
            # through unclassified
            keys = [k for a in n.args for k in carried.get(a, [])]
        carried[i] = keys

    row_local = not reasons
    if not row_local:
        cross_row[kind] = "; ".join(reasons)
    else:
        cross_row.pop(kind, None)
    return Footprint(kind=kind, digest=footprint_digest(lowered),
                     columns=reads.columns(),
                     providers=tuple(sorted(providers)),
                     row_local=row_local,
                     cross_row_reasons=tuple(reasons))


# ---------------------------------------------------------------------------
# perturbation validation (footprints are validated, not trusted)


def _leaf_paths(obj, prefix: tuple = (), depth: int = 6) -> set[tuple]:
    out: set[tuple] = set()
    if depth <= 0:
        return out
    if isinstance(obj, dict):
        for k, v in obj.items():
            if not isinstance(k, str):
                continue
            p = prefix + (k,)
            sub = _leaf_paths(v, p, depth - 1)
            out.update(sub if sub else {p})
    elif isinstance(obj, list):
        for v in obj:
            sub = _leaf_paths(v, prefix + ("*",), depth - 1)
            out.update(sub if sub else {prefix + ("*",)})
    return out


def _perturb(obj, path: tuple, token, delete: bool = False) -> None:
    """Set (or delete) the value at ``path`` in place; "*" fans out
    over list elements; missing intermediate dicts are created on the
    set path and end the walk on the delete path."""
    if not path:
        return
    head, rest = path[0], path[1:]
    if head == "*":
        if isinstance(obj, list):
            if rest:
                for el in obj:
                    _perturb(el, rest, token, delete)
            elif not delete:
                for j in range(len(obj)):
                    obj[j] = token
        return
    if not isinstance(obj, dict):
        return
    if not rest:
        if delete:
            obj.pop(head, None)
        else:
            obj[head] = token
        return
    nxt = obj.get(head)
    if nxt is None:
        if delete:
            return
        nxt = obj[head] = {}
    _perturb(nxt, rest, token, delete)


def validate_footprint(kind: str, compiled, lowered, fp: Footprint,
                       constraints: list[dict] | None = None,
                       budget: int | None = None,
                       max_candidates: int = 12, device="cuda"
                       ) -> list[FootprintViolation]:
    """Perturb columns OUTSIDE the claimed read-set over smallmodel
    worlds and assert the device mask is bit-identical.  Candidate
    columns come from the model resources themselves plus synthetic
    probe paths; identity fields are excluded (changing them changes
    world structure, not a column value).  Every world's mask is one
    evaluation on ``device`` (the card unless the caller names the
    CPU)."""
    from gatekeeper_tpu_torch.analysis import transval
    from gatekeeper_tpu_torch.analysis.smallmodel import (derive_plan,
                                                    enumerate_models)

    cons = transval.expand_constraints(kind, constraints)
    plan = derive_plan(lowered, cons, module=compiled.module)
    models = enumerate_models(plan, budget or validation_budget())
    all_res = [obj for m in models for obj in m.resources]
    if not all_res:
        return []
    st, _rows, _handler = transval._world_state(all_res)
    base_mask, _b = transval._device_mask(lowered, st, cons, device)

    claimed = set(fp.object_paths()) | set(_IDENTITY_PATHS) | {("$meta",)}
    candidates: set[tuple] = set()
    for obj in all_res:
        candidates.update(_leaf_paths(obj))
    candidates.add(("metadata", "annotations", "gatekeeper-fp-probe"))
    candidates.add(("spec", "gatekeeperFpProbe"))
    open_paths = sorted(
        p for p in candidates
        if not any(paths_intersect(p, c) for c in claimed))[:max_candidates]

    out: list[FootprintViolation] = []
    for pi, path in enumerate(open_paths):
        for variant, delete in (("mutate", False), ("delete", True)):
            perturbed = copy.deepcopy(all_res)
            for obj in perturbed:
                _perturb(obj, path, f"fp-perturbed-{pi}", delete=delete)
            st2, _r2, _h2 = transval._world_state(perturbed)
            mask2, _b2 = transval._device_mask(lowered, st2, cons,
                                                 device)
            if mask2.shape != base_mask.shape \
                    or not np.array_equal(mask2, base_mask):
                out.append(FootprintViolation(
                    kind=kind, path=path,
                    note=f"{variant} over {len(models)} model world(s)"))
                break
    return out


# ---------------------------------------------------------------------------
# fault seam + memoized entry point


def _narrow_kinds() -> set[str]:
    raw = os.environ.get("GATEKEEPER_FOOTPRINT_TEST_NARROW", "")
    return {t.strip() for t in raw.split(",") if t.strip()}


def maybe_narrowed(kind: str, fp: Footprint) -> Footprint:
    """Fault-injection seam: deliberately drop one claimed object
    column for the named kinds, proving end-to-end that perturbation
    validation catches a footprint that under-claims its reads."""
    if kind not in _narrow_kinds():
        return fp
    return narrow(fp)


def narrow(fp: Footprint) -> Footprint:
    """Drop one object column — prefer a spec-side read so the dropped
    path survives the validator's identity/match exclusions."""
    keep, dropped = [], None
    for c in fp.columns:
        if dropped is None and c.source == "object" \
                and c.path[:1] not in (("metadata",), ("$meta",)):
            dropped = c
            continue
        keep.append(c)
    if dropped is None:
        for c in list(keep):
            if c.source == "object":
                dropped = c
                keep.remove(c)
                break
    if dropped is None:
        return fp
    # drop ALL claims of that path (an inventory-source twin would
    # otherwise keep it out of the validator's candidate set)
    keep = [c for c in keep if c.path != dropped.path]
    log.warning("footprint deliberately narrowed (test seam)",
                kind=fp.kind, dropped=".".join(dropped.path))
    return dataclasses.replace(fp, columns=tuple(keep), validated=False)


def certify(kind: str, compiled, lowered,
            constraints: list[dict] | None = None,
            device="cuda") -> Footprint:
    """Memoized/snapshot-backed entry point the engine and probe use.

    The static analysis always runs (mode "on"); under "strict" the
    footprint is additionally perturbation-validated and any violation
    is recorded in ``violations[kind]`` (the engine then fails the
    install).  Validated footprints persist in the snapshot "fp" tier,
    so a warm restart re-runs zero analyses.  Validation evaluates its
    worlds on ``device``.  The NARROW seam bypasses both memo and
    snapshot — a narrowed footprint must reach the
    validator, not a cached honest one."""
    global analyses_run
    digest = footprint_digest(lowered)
    seam = kind in _narrow_kinds()
    if not seam:
        cached = _memo.get(digest)
        if cached is not None:
            _publish(kind, cached)
            return cached
        from gatekeeper_tpu_torch.resilience import snapshot as _snap
        hit = _snap.load_footprint(digest)     # 1-tuple or None (miss)
        if hit is not None and isinstance(hit[0], Footprint) \
                and hit[0].version == FOOTPRINT_VERSION:
            _memo[digest] = hit[0]
            _publish(kind, hit[0])
            return hit[0]

    fp = analyze(kind, lowered)
    analyses_run += 1
    fp = maybe_narrowed(kind, fp)
    found: list[FootprintViolation] = []
    if mode() == "strict":
        found = validate_footprint(kind, compiled, lowered, fp,
                                   constraints=constraints, device=device)
        fp = dataclasses.replace(fp, validated=not found)
    if found:
        violations[kind] = found
        for v in found:
            log.warning("footprint violation", kind=kind,
                        column=".".join(v.path), note=v.note)
    else:
        violations.pop(kind, None)
    if not seam and not found:
        _memo[digest] = fp
        from gatekeeper_tpu_torch.resilience import snapshot as _snap
        _snap.save_footprint(digest, fp)
    _publish(kind, fp)
    return fp


def _publish(kind: str, fp: Footprint) -> None:
    if fp.row_local:
        cross_row.pop(kind, None)
    else:
        cross_row[kind] = "; ".join(fp.cross_row_reasons) or "cross-row"


def locality_for(kind: str) -> str | None:
    """The cross-row reason for a kind, or None when row-local (or not
    yet analyzed)."""
    return cross_row.get(kind)


def violations_for(kind: str) -> list[FootprintViolation]:
    return violations.get(kind, [])
