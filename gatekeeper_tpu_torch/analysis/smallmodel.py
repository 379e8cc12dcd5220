# Copied from gatekeeper_tpu/analysis/smallmodel.py for the PyTorch port.
"""Small-model universe derivation for translation validation.

Stage 4, part 1 (see :mod:`.transval` for the checker): given one
template's lowered program, derive the *finite abstract domains* its
input columns actually range over, and enumerate a deterministic,
bounded universe of concrete worlds ("models") that exercises every
domain value at least once.

The key observation (the same one behind bounded model checking) is
that a lowered program is a finite circuit over a fixed set of typed
input slots — the PrepSpec requests (ir/prep.py).  Each slot only ever
flows into compares/gathers/membership tests against a *finite* set of
literals: constants in the Rego source, values folded out of the
constraint parameters, and the structural alternatives every extraction
mode distinguishes (absent vs present, truthy vs literal-false, empty
vs non-empty list).  Checking equivalence on one representative per
abstract class per slot — plus the float32 lattice boundary, where the
device's known ordering deviation lives — covers the program's entire
behavioral surface up to the mined literal set.

Everything here is deterministic: no clocks, no RNG, no iteration over
unsorted sets (the selflint nondeterminism rule applies to this module
in spirit — certificates must be bit-reproducible across processes and
PYTHONHASHSEED values).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any

# float32 has 24 mantissa bits: 2**24 is the last contiguous integer;
# 2**24 + 1 rounds to 2**24 on device (the lowering contract's known
# ordering deviation — ir/lower.py), which the validator must exercise
# so the f32-excusal path is itself covered.
F32_EDGE = 2 ** 24


class _Absent:
    """Domain sentinel: the slot's path is left out of the object."""

    def __repr__(self) -> str:  # pragma: no cover - debug only
        return "<absent>"


ABSENT = _Absent()


# ---------------------------------------------------------------------------
# literal mining


@dataclasses.dataclass
class LiteralPool:
    strs: tuple[str, ...] = ()
    nums: tuple[float, ...] = ()


def _walk_json(v: Any, strs: set, nums: set) -> None:
    if isinstance(v, str):
        strs.add(v)
    elif isinstance(v, bool):
        pass
    elif isinstance(v, (int, float)):
        nums.add(v)
    elif isinstance(v, dict):
        for k, x in v.items():
            if isinstance(k, str):
                strs.add(k)
            _walk_json(x, strs, nums)
    elif isinstance(v, (list, tuple, set, frozenset)):
        for x in v:
            _walk_json(x, strs, nums)


def mine_literals(module, constraints: list[dict]) -> LiteralPool:
    """Every scalar literal the program can compare against: Rego
    source scalars (module AST) + scalars reachable in the constraint
    docs' parameters.  Sorted + capped so domains stay small and
    deterministic."""
    strs: set = set()
    nums: set = set()
    if module is not None:
        from gatekeeper_tpu_torch.rego.ast_nodes import Scalar, walk_terms

        def spot(t):
            if isinstance(t, Scalar):
                _walk_json(t.value, strs, nums)

        for rule in module.rules:
            walk_terms(rule, spot)
    for c in constraints:
        _walk_json(((c.get("spec") or {}).get("parameters")) or {},
                   strs, nums)
    # identity-ish strings are never useful compare fodder
    strs.discard("")
    return LiteralPool(
        strs=tuple(sorted(strs))[:8],
        nums=tuple(sorted(n for n in nums if abs(n) < 2 ** 53))[:5],
    )


# ---------------------------------------------------------------------------
# slots & domains


@dataclasses.dataclass
class Slot:
    """One independently-varied degree of freedom of the model world.

    kind: 'scalar' (resource path), 'meta' (review identity field),
    'elem' (per-element rel path on an axis), 'memb' (dict whose keys
    a membership matrix tests), 'keyedval' (dict read through a
    constraint-chosen key), 'elemkeys' (per-element truthy-key set).
    """

    kind: str
    path: tuple[str, ...]
    domain: tuple
    default: int                    # index into domain
    axis: str | None = None


@dataclasses.dataclass
class ModelPlan:
    slots: list[Slot]
    # axis key -> base path, outer axes first (build order)
    axes: list[tuple[str, tuple[str, ...]]]
    inv_joins: list
    pool: LiteralPool
    truncated: bool = False

    def domain_sizes(self) -> dict:
        return {"slots": len(self.slots),
                "axes": len(self.axes),
                "values": sum(len(s.domain) for s in self.slots)}


# DFA-boundary strings for the in-program regex lowering
# (ops/regex_dfa): the empty string (start-state accept), the widest
# device-eligible row (raw 124 bytes -> encoded 127 < max_str_len, the
# trailing-terminator edge of the device scan), one byte past it
# (encoded 128: ineligible, host-xv route-back), and a non-ASCII
# payload (also routed back).  Deliberately NO trailing-newline
# strings: `$` ~ `\Z` on the device is a documented deviation and a
# counterexample here would pin every regex template to scalar.
_DFA_EDGE_STRS = ("", "x" * 124, "y" * 125, "café-ü")


def _str_domain(pool: LiteralPool) -> tuple:
    return (ABSENT, *pool.strs, "zzz-novel", 7, *_DFA_EDGE_STRS)


def _num_domain(pool: LiteralPool) -> tuple:
    vals: set = {0, 1}
    for v in pool.nums[:3]:
        vals.update({v - 1, v, v + 1})
    vals.update({F32_EDGE - 1, F32_EDGE + 1})
    return (ABSENT, *sorted(vals))


def _val_domain(pool: LiteralPool) -> tuple:
    return (ABSENT, *pool.strs[:3], *pool.nums[:2], False,
            {"httpGet": {}}, *_DFA_EDGE_STRS)


_MODE_DOMAIN = {
    "present": lambda pool: (ABSENT, "x"),
    "truthy": lambda pool: (ABSENT, False, "x"),
    "len": lambda pool: (ABSENT, [], [{"a": 1}], [1, 2, 3]),
    "str": _str_domain,
    "num": _num_domain,
    "val": _val_domain,
}

# default-value index per mode: prefer a literal (maximizes the number
# of conjuncts that fire under the default world, so each-choice flips
# explore deep program states rather than bouncing off the first
# undefined leaf)
_MODE_DEFAULT = {"present": 1, "truthy": 2, "len": 3,
                 "str": 1, "num": 1, "val": 1}


def _mode_slot(kind: str, path: tuple, mode: str, pool: LiteralPool,
               axis: str | None = None) -> Slot:
    domain = _MODE_DOMAIN[mode](pool)
    default = min(_MODE_DEFAULT[mode], len(domain) - 1)
    return Slot(kind=kind, path=path, domain=domain, default=default,
                axis=axis)


def _merge_domains(a: Slot, b: Slot) -> Slot:
    seen: list = []
    for v in (*a.domain, *b.domain):
        if not any(type(v) is type(x) and v == x for x in seen):
            seen.append(v)
    return dataclasses.replace(a, domain=tuple(seen))


def _eval_quiet(fn, *args):
    try:
        return fn(*args)
    except Exception:   # noqa: BLE001 — undefined under this constraint
        return None


def derive_plan(lowered, constraints: list[dict],
                module=None) -> ModelPlan:
    """ModelPlan for one template: one slot per distinct input path the
    PrepSpec extracts, with a finite abstract domain each."""
    spec = lowered.spec
    pool = mine_literals(module, constraints)
    axes = sorted(spec.axes, key=lambda ab: (len(ab[1]), ab[0]))
    axis_bases = {base for _k, base in axes}

    slots: dict[tuple, Slot] = {}

    def add(slot: Slot) -> None:
        key = (slot.kind, slot.path, slot.axis)
        prev = slots.get(key)
        slots[key] = _merge_domains(prev, slot) if prev else slot

    for rc in spec.r_cols:
        if rc.path and rc.path[0] == "$meta":
            tail = rc.path[1:]
            if tail in (("name",), ("operation",)):
                continue   # names are unique world keys; op is CREATE
            add(Slot(kind="meta", path=tail,
                     domain=(None,), default=0))
            continue
        if rc.path in axis_bases:
            continue       # the axis-length choice owns this path
        add(_mode_slot("scalar", rc.path, rc.mode, pool))
    for ec in spec.e_cols:
        add(_mode_slot("elem", ec.rel, ec.mode, pool, axis=ec.axis))

    # constraint-derived key sets
    cset_keys: dict[str, tuple[str, ...]] = {}
    for cs in spec.csets:
        keys: set = set()
        for c in constraints:
            got = _eval_quiet(cs.fn, c)
            if isinstance(got, (list, tuple, set, frozenset)):
                keys.update(k for k in got if isinstance(k, str))
        cset_keys[cs.name] = tuple(sorted(keys))
    for mb in spec.membs:
        keys = cset_keys.get(mb.cset, ())
        variants: list = [ABSENT, {}]
        if keys:
            variants.append({keys[0]: "v"})
            variants.append({k: "v" for k in keys})
        variants.append({**{k: "v" for k in keys}, "zzz-extra": "v"})
        add(Slot(kind="memb", path=mb.keys_path, domain=tuple(variants),
                 default=len(variants) - 1))
    for kv in spec.keyed_vals:
        keys = tuple(sorted({k for c in constraints
                             if isinstance(k := _eval_quiet(kv.key_fn, c),
                                           str)}))
        variants = [ABSENT, {}]
        for k in keys[:2]:
            for v in (*pool.strs[:2], False, 7):
                variants.append({k: v})
        add(Slot(kind="keyedval", path=kv.path, domain=tuple(variants),
                 default=min(2, len(variants) - 1)))
    for ek in spec.elem_keys:
        keys = cset_keys.get(ek.cset, ())
        variants = [{}]
        if keys:
            variants.append({keys[0]: {"t": 1}})
            variants.append({keys[0]: False})
            variants.append({k: {"t": 1} for k in keys})
        add(Slot(kind="elemkeys", path=(), domain=tuple(variants),
                 default=0, axis=ek.axis))

    ordered = [slots[k] for k in sorted(slots, key=repr)]
    return ModelPlan(slots=ordered, axes=axes,
                     inv_joins=list(spec.inv_joins), pool=pool)


# ---------------------------------------------------------------------------
# world construction


def _assign_path(obj: dict, path: tuple[str, ...], value) -> None:
    if value is ABSENT or not path:
        return
    cur = obj
    for seg in path[:-1]:
        nxt = cur.get(seg)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[seg] = nxt
        cur = nxt
    cur[path[-1]] = value


def _place_axis(obj: dict, base: tuple[str, ...], elems: list) -> None:
    """Install the element list at `base`; a ``"*"`` segment descends
    into the first element of the (already-built) outer axis list."""
    cur: Any = obj
    for i, seg in enumerate(base):
        last = i == len(base) - 1
        if seg == "*":
            if not (isinstance(cur, list) and cur):
                return           # outer axis empty: nested list nowhere
            cur = cur[0]
            continue
        if not isinstance(cur, dict):
            return
        if last:
            cur[seg] = elems
            return
        nxt = cur.get(seg)
        if not isinstance(nxt, (dict, list)):
            nxt = {}
            cur[seg] = nxt
        cur = nxt


@dataclasses.dataclass
class Model:
    """One concrete world: a list of resource objects (usually one;
    inventory-join models carry a partner row) plus the index of the
    row whose verdict this model is "about"."""

    resources: list
    focus: int = 0
    note: str = ""


def _meta_value(slot: Slot, pool: LiteralPool) -> tuple:
    """(domain, default index) for a review-identity slot."""
    if slot.path == ("kind", "kind"):
        return (("Pod", *pool.strs[:3]), 0)
    if slot.path == ("kind", "group"):
        return (("", *pool.strs[:2]), 0)
    if slot.path == ("kind", "version"):
        return (("v1", *pool.strs[:1]), 0)
    if slot.path == ("namespace",):
        return (("default", None, *pool.strs[:1]), 0)
    return ((None,), 0)


def finalize_plan(plan: ModelPlan) -> ModelPlan:
    """Resolve meta-slot domains (they need the pool) in place."""
    for i, s in enumerate(plan.slots):
        if s.kind == "meta":
            domain, default = _meta_value(s, plan.pool)
            plan.slots[i] = dataclasses.replace(s, domain=domain,
                                                default=default)
    return plan


def _build_resource(plan: ModelPlan, choice: dict[int, int],
                    axis_len: dict[str, int], name: str) -> dict:
    """One resource object from a slot-index assignment.  `choice`
    maps slot index -> domain index (missing = default)."""
    api, kind, ns = "v1", "Pod", "default"
    group = version = None
    for si, s in enumerate(plan.slots):
        if s.kind != "meta":
            continue
        v = s.domain[choice.get(si, s.default)]
        if s.path == ("kind", "kind") and isinstance(v, str) and v:
            kind = v
        elif s.path == ("kind", "group"):
            group = v
        elif s.path == ("kind", "version"):
            version = v
        elif s.path == ("namespace",):
            ns = v
    if group or (version and version != "v1"):
        api = f"{group}/{version or 'v1'}" if group else (version or "v1")
    obj: dict = {"apiVersion": api, "kind": kind,
                 "metadata": {"name": name}}
    if ns is not None:
        obj["metadata"]["namespace"] = ns

    # dict-shaped slots first so scalar assignments can merge into them
    for order in ("memb", "keyedval"):
        for si, s in enumerate(plan.slots):
            if s.kind == order:
                _assign_path(obj, s.path,
                             s.domain[choice.get(si, s.default)])
    for si, s in enumerate(plan.slots):
        if s.kind == "scalar":
            _assign_path(obj, s.path, s.domain[choice.get(si, s.default)])

    # axes, outer first; element e rotates each elem-slot's value so a
    # 2-element list shows two distinct abstract states per pass
    for axis_key, base in plan.axes:
        n_e = axis_len.get(axis_key, 1)
        elems = []
        for e in range(n_e):
            elem: dict = {}
            for si, s in enumerate(plan.slots):
                if s.axis != axis_key:
                    continue
                idx = (choice.get(si, s.default) + e) % len(s.domain)
                v = s.domain[idx]
                if s.kind == "elemkeys":
                    if isinstance(v, dict):
                        elem.update(v)
                elif s.kind == "elem":
                    _assign_path(elem, s.path, v)
            elems.append(elem)
        _place_axis(obj, base, elems)

    # identity invariants: the API server guarantees non-empty string
    # apiVersion/kind/name on every admitted object, and world keys
    # (kind/ns/name) must never collide across co-resident models — so
    # slots may not leave these fields invalid or non-unique
    if not (isinstance(obj.get("apiVersion"), str) and obj["apiVersion"]):
        obj["apiVersion"] = api
    if not (isinstance(obj.get("kind"), str) and obj["kind"]):
        obj["kind"] = kind
    md = obj.get("metadata")
    if not isinstance(md, dict):
        md = {}
        obj["metadata"] = md
    md["name"] = name
    mns = md.get("namespace")
    if mns is not None and not (isinstance(mns, str) and mns):
        del md["namespace"]
    return obj


def enumerate_models(plan: ModelPlan, budget: int = 96) -> list[Model]:
    """The bounded universe: the default world, every each-choice flip
    (one slot/axis varied at a time), inventory-join pairs, then
    deterministic mixed-radix combinations up to `budget` total."""
    finalize_plan(plan)
    counter = itertools.count()

    def name() -> str:
        return f"m{next(counter):03d}"

    models: list[Model] = []

    def emit(choice: dict, axis_len: dict, note: str) -> bool:
        if len(models) >= budget:
            plan.truncated = True
            return False
        models.append(Model(
            resources=[_build_resource(plan, choice, axis_len, name())],
            note=note))
        return True

    emit({}, {}, "default")
    for si, s in enumerate(plan.slots):
        for di in range(len(s.domain)):
            if di == s.default:
                continue
            if not emit({si: di}, {}, f"slot{si}={di}"):
                break
    for axis_key, _base in plan.axes:
        for n_e in (0, 2):
            emit({}, {axis_key: n_e}, f"axis:{axis_key}={n_e}")

    # inventory-join pairs: partner rows co-resident in the same world
    for ij in plan.inv_joins:
        for variant in ("dup", "nodup"):
            if len(models) >= budget:
                plan.truncated = True
                break
            focus = _build_resource(plan, {}, {}, name())
            focus["kind"] = ij.kind
            _assign_path(focus, ij.src_path, "joined-value")
            partner = _build_resource(plan, {}, {}, name())
            partner["kind"] = ij.kind
            _assign_path(partner, ij.inv_path,
                         "joined-value" if variant == "dup" else "other")
            models.append(Model(resources=[focus, partner], focus=0,
                                note=f"invjoin:{ij.name}:{variant}"))

    # deterministic mixed worlds fill the remaining budget
    k = 0
    while len(models) < budget and plan.slots and k < budget:
        choice = {si: (k * (si + 2) + (k >> 2) + 1) % len(s.domain)
                  for si, s in enumerate(plan.slots)}
        axis_len = {ax: (k + i) % 3
                    for i, (ax, _b) in enumerate(plan.axes)}
        emit(choice, axis_len, f"mix{k}")
        k += 1
    return models
