# Copied from gatekeeper_tpu/ir/prep.py for the PyTorch port.
"""Host-side binding preparation for vectorized programs.

Everything the device program consumes is built here, on host, from the
``ResourceTable`` and the current constraint set of one template kind:

- **columns**: per-resource (and per-element) field values as int32
  interner ids / float32 numbers / bools.  This replaces the reference's
  per-document tree walks over the inmem store (opa/storage/inmem) with
  one columnar pass that is amortized across every constraint.
- **tables**: host-evaluated lookup tables over *unique* values.  Any
  pure subexpression of one string/scalar leaf (``canonify_cpu(x)``,
  ``re_match(p, x)``...) is evaluated once per distinct value with the
  scalar oracle/builtins, then becomes a device gather.  Strings never
  reach the device; the regex/parse work rides the interner.
- **ptables**: [n_params, n_values] tables for predicates of
  (leaf value, constraint parameter), e.g. ``startswith(image, repo)``
  with per-constraint param index sets.
- **cvals / csets**: per-constraint host evaluation (n_constraints is
  small; the scalar oracle evaluates constraint-only subexpressions
  exactly, including through user-defined template functions).
- **membership matrices**: [n_needed, n_resources] bool for set ops
  against ragged per-resource key sets (``metadata.labels``).

Bindings are padded to power-of-two shape buckets so the jitted
executable cache (engine/veval.py) stays warm across inventory growth —
the reference instead recompiles every module on any change
(drivers/local/local.go:65-93).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from gatekeeper_tpu_torch.ir.encode import decode_value, encode_value
from gatekeeper_tpu_torch.store.columns import ColSpec, get_path, iter_path
from gatekeeper_tpu_torch.store.interner import Interner, MISSING
from gatekeeper_tpu_torch.store.table import ResourceTable


def bucket(n: int, minimum: int = 8) -> int:
    """Next power-of-two shape bucket (stable jit shapes, SURVEY §7.5)."""
    b = minimum
    while b < n:
        b <<= 1
    return b


def interner_bucket(n: int) -> int:
    """Shape bucket for interner-indexed arrays (.ok/.vmap/__strbytes__),
    sized with growth headroom: the interner is global and append-only,
    so a bucket sized exactly to ``len(interner)`` at build time is
    outgrown by the FIRST post-build string anyone interns — which
    permanently exiles every table-reading kind from the
    ``update_bindings`` delta path (the in-capacity delta sections
    host-eval only the new ids; the capacity bail rebuilds everything).
    25% + 8 slack keeps churn-era interning inside the bucket."""
    return bucket(n + (n >> 2) + 8, minimum=8)


def audit_pads(n_rows: int, n_constraints: int) -> tuple[int, int]:
    """(r_pad, c_pad) device shape buckets for an audit matrix — the
    single source of the padding formulas (build_bindings and the
    driver's padded match-mask cache must agree, or every sweep would
    silently re-pad and re-upload the mask)."""
    return bucket(max(n_rows, 1)), bucket(max(n_constraints, 1), minimum=4)


def binding_axes(name: str) -> tuple:
    """Logical axes of one bound array, by the prep naming convention:
    'c' (constraints), 'r' (resources), or None (replicated/table) per
    dim.  Single source of truth for multi-chip sharding
    (parallel/sharding.binding_spec) and R-chunking (engine/veval).
    Raises on unknown names — a new binding kind silently replicated or
    left unchunked would mis-shard or shape-crash downstream."""
    base = name.split(".")[0]
    if name == "__match__":
        return ("c", "r")
    if name in ("__alive__", "__rank__", "__pagetable__"):
        return ("r",)
    if name == "__cvalid__":
        return ("c",)
    if name.startswith("__elem__:") or base.startswith("e:"):
        return ("r", None)
    if base.startswith("r:"):
        return ("r",)
    if base.startswith("m") and base[1:].isdigit():
        return (None, "r")                       # memb [L, R]
    if base.startswith("kl") and base[2:].isdigit():
        if name.endswith(".kv"):
            return (None, "r")                   # keyed values [K, R]
        return ("c",)                            # .sel [C]
    if base.startswith("ek") and base[2:].isdigit():
        return (None, "r", None)                 # elem keys [K, R, E]
    if base.startswith("cs") and base[2:].isdigit():
        if name.endswith(".vmap"):
            return (None,)                       # global id -> dense u [T]
        return ("c", None)                       # .bitmap / .B [C, U|L]
    if base.startswith("cv") and base[2:].isdigit():
        return ("c",)                            # cval [C] (.v/.p too)
    if base.startswith("cb") and base[2:].isdigit():
        return ("c",)                            # per-constraint bool [C]
    if base.startswith("pt") and base[2:].isdigit():
        if name.endswith(".vmap"):
            return (None,)                       # global id -> dense u [T]
        return ("c", None)                       # .any / .all [C, U]
    if base.startswith("ij") and base[2:].isdigit():
        return ("r",)                            # inventory join bool [R]
    if base.startswith("t") and base[1:].isdigit():
        return (None,)                           # unary table [T]
    if name == "__strbytes__":
        return (None, None)                      # interner bytes [T, W]
    if name == "__strdfaok__":
        return (None,)                           # device-DFA eligible [T]
    if base.startswith("dfa") and base[3:].isdigit():
        if name.endswith(".trans"):
            return (None, None)                  # DFA table [S, 256]
        return (None,)                           # .accept [S] / .xv [T]
    if name.startswith("__shared_e__:"):
        return ("r", None)                       # dedup-injected [R, E]
    if name.startswith("__shared__:"):
        return ("r",)                            # dedup-injected [R]
    raise ValueError(f"binding_axes: unrecognized binding {name!r}; "
                     f"add its axes rule here")


# bumped whenever a padding formula above (bucket/interner_bucket/
# audit_pads) or a dim-class rule below changes shape semantics: the
# Stage-7 compile-surface certificates key on it, so a geometry change
# invalidates every persisted certificate instead of certifying stale
# ladders
PAD_GEOMETRY_VERSION = "padgeom-1"


def bucket_ladder(minimum: int, cap: int) -> tuple[int, ...]:
    """Every value :func:`bucket` (and :func:`interner_bucket`, whose
    image is the same power-of-two set) can produce between ``minimum``
    and ``cap`` inclusive — the finite growth ladder of one pad axis.
    Empty when the cap is below the minimum."""
    out = []
    p = 1
    while p < max(minimum, 1):
        p <<= 1
    while p <= cap:
        out.append(p)
        p <<= 1
    return tuple(out)


def binding_dim_classes(name: str) -> tuple[str, ...]:
    """Pad-geometry class of each dim of one bound array, by the same
    naming convention as :func:`binding_axes`:

      'r'      — resource axis, padded by ``bucket()`` (audit_pads /
                 review mini-tables / dirty-row delta buckets);
      'c'      — constraint axis, ``bucket(·, minimum=4)``;
      't'      — interner-table axis, ``interner_bucket()`` (grows with
                 distinct strings, headroom-stepped);
      'e'      — element axis, ``bucket(·, minimum=2)`` (grows with the
                 longest per-resource list);
      'static' — fixed at install time (constraint-set key counts, DFA
                 state counts, the interner byte width): exactly one
                 value per installed policy set, so it contributes no
                 growth rung.

    This is the single source the Stage-7 compile-surface certifier
    (analysis/compilesurface.py) enumerates signature ladders from.
    Raises on unknown names, mirroring binding_axes — an unclassified
    binding means the compile surface is not provably finite."""
    base = name.split(".")[0]
    if name == "__match__":
        return ("c", "r")
    if name in ("__alive__", "__rank__", "__pagetable__"):
        return ("r",)
    if name == "__cvalid__":
        return ("c",)
    if name.startswith("__elem__:") or base.startswith("e:"):
        return ("r", "e")
    if base.startswith("r:"):
        return ("r",)
    if base.startswith("m") and base[1:].isdigit():
        return ("static", "r")                   # memb [L, R]
    if base.startswith("kl") and base[2:].isdigit():
        if name.endswith(".kv"):
            return ("static", "r")               # keyed values [K, R]
        return ("c",)                            # .sel [C]
    if base.startswith("ek") and base[2:].isdigit():
        return ("static", "r", "e")              # elem keys [K, R, E]
    if base.startswith("cs") and base[2:].isdigit():
        if name.endswith(".vmap"):
            return ("t",)                        # global id -> dense u [T]
        return ("c", "static")                   # .bitmap / .B [C, U|L]
    if base.startswith("cv") and base[2:].isdigit():
        return ("c",)
    if base.startswith("cb") and base[2:].isdigit():
        return ("c",)
    if base.startswith("pt") and base[2:].isdigit():
        if name.endswith(".vmap"):
            return ("t",)                        # global id -> dense u [T]
        return ("c", "static")                   # .any / .all [C, U]
    if base.startswith("ij") and base[2:].isdigit():
        return ("r",)
    if base.startswith("t") and base[1:].isdigit():
        return ("t",)                            # unary table [T]
    if name == "__strbytes__":
        return ("t", "static")                   # interner bytes [T, W]
    if name == "__strdfaok__":
        return ("t",)
    if base.startswith("dfa") and base[3:].isdigit():
        if name.endswith(".trans"):
            return ("static", "static")          # DFA table [S, 256]
        if name.endswith(".xv"):
            return ("t",)                        # host route-back [T]
        return ("static",)                       # .accept [S]
    if name.startswith("__shared_e__:"):
        return ("r", "e")                        # dedup-injected [R, E]
    if name.startswith("__shared__:"):
        return ("r",)                            # dedup-injected [R]
    raise ValueError(f"binding_dim_classes: unrecognized binding "
                     f"{name!r}; add its pad-geometry rule here")


# ---------------------------------------------------------------------------
# prep spec: declarative requests emitted by the lowerer


@dataclasses.dataclass(frozen=True)
class RColReq:
    """Per-resource scalar column.

    mode: 'str' | 'num' | 'val' | 'present' | 'truthy' | 'len'.
    A path starting with "$meta" reads review metadata instead of the
    object (the audit review shape built by make_review,
    reference target.go:69-107): ("$meta","kind","group"|"version"|
    "kind"), ("$meta","name"), ("$meta","namespace"),
    ("$meta","operation") — always str ids, from the identity columns.
    """

    name: str
    path: tuple[str, ...]
    mode: str


@dataclasses.dataclass(frozen=True)
class EColReq:
    """Per-element column along one list axis (``base[*].rel``).

    Unlike store.columns CSR modes, elements are *aligned to the base
    list*: element i of every rel-column of the same axis refers to the
    same list entry (absent rel -> MISSING), so multi-field element
    predicates (image + name + resources) line up.
    """

    name: str
    axis: str                 # axis key, ".".join(base_path)
    base: tuple[str, ...]
    rel: tuple[str, ...]
    mode: str                 # 'str' | 'num' | 'val' | 'present' | 'truthy' | 'len'


@dataclasses.dataclass(frozen=True)
class TableReq:
    """Unary host table over the distinct values of a source column.

    src names an RColReq/EColReq with mode 'str' or 'val' (ids; src_val
    marks the encoded-value namespace, decoded before fn).  fn maps the
    python value -> output; exceptions / UNDEFINED -> undefined.
    out: 'bool' | 'num' | 'id_str' | 'id_val'.

    regex: set when fn is exactly re_match(<const pattern>, value) —
    at high unique-value cardinality the build routes through the
    batched DFA engine (ops/regex_dfa) instead of one Python
    re.search per distinct string.

    ext_providers: external-data providers consulted by fn with the
    column value as the lookup key.  The build warms every (provider,
    distinct value) pair through the runtime in ONE batched round per
    provider before running the per-value fn loop, so fn's
    external_data call is a cache hit — the "key-collection pass" of
    the two-phase prefetch/gather design.
    """

    name: str
    src: str
    fn: Callable[[Any], Any] = dataclasses.field(compare=False, hash=False)
    out: str = "bool"
    src_val: bool = False
    regex: str | None = None
    ext_providers: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class DfaReq:
    """In-program device regex (the ``dfa_match`` op): the compiled
    byte DFA of ``pattern`` (ops/regex_dfa) bound as program constants
    — ``.trans`` [S, 256] int32 and ``.accept`` [S] bool — plus a host
    fallback vector ``.xv`` [t_pad] bool for interned ids the device
    scan cannot represent exactly (non-ASCII, embedded NUL, rows
    truncated at the interner width).  src names a val-mode id column;
    matching gathers through the shared ``__strbytes__`` packed byte
    matrix inside the jitted program — no per-unique-value host loop,
    no table rebuild on churn.  Unlike TableReq this request is
    fn-free, so it hashes/pickles and participates in spec signatures
    and snapshots directly."""

    name: str
    src: str
    pattern: str


@dataclasses.dataclass(frozen=True)
class PTableReq:
    """Parametric table: fn(value_string, param_string) -> bool, evaluated
    for every distinct param across the constraint set."""

    name: str
    src: str
    cparams: Callable[[dict], list] = dataclasses.field(compare=False, hash=False)
    fn: Callable[[Any, Any], Any] = dataclasses.field(compare=False, hash=False)
    src_val: bool = False


@dataclasses.dataclass(frozen=True)
class CSetReq:
    """Per-constraint id set (padded): fn(constraint) -> list of scalars.

    encode 'str': strings intern raw (matching raw-string columns like
    label keys); non-string scalars intern their encoded form — a
    distinct id that matches no raw string, preserving exact Rego
    set semantics for heterogeneous parameter lists.
    encode 'val': every scalar interns encoded (matching val columns).
    """

    name: str
    fn: Callable[[dict], list] = dataclasses.field(compare=False, hash=False)
    encode: str = "str"


@dataclasses.dataclass(frozen=True)
class CValReq:
    """Per-constraint scalar: fn(constraint) -> value or None (undefined).
    kind: 'num' | 'str' | 'bool' | 'val'."""

    name: str
    kind: str
    fn: Callable[[dict], Any] = dataclasses.field(compare=False, hash=False)


@dataclasses.dataclass(frozen=True)
class KeyedValReq:
    """Per-constraint dynamic-key lookup into a per-resource dict
    (``value := labels[key]`` with a constraint-param key).

    key_fn(constraint) -> str key or None (undefined).  Builds:
      .kv  [K_pad, r_pad] int32 — val-encoded id of dict[k] per needed
           key k and row (MISSING when the key/dict is absent);
      .sel [c_pad] int32 — each constraint's local key index (-1 =
           undefined key for that constraint)."""

    name: str
    path: tuple[str, ...]
    key_fn: Callable[[dict], Any] = dataclasses.field(compare=False, hash=False)


@dataclasses.dataclass(frozen=True)
class ElemKeysReq:
    """Element-axis truthy-key membership vs a per-constraint key set
    (``not container[probe]`` with probe := params[_]).

    keys come from the paired cset (re-indexed local like MembReq);
    output ``ekm`` [K_pad, r_pad, e_pad] bool: key k present AND not
    literal false in element (r, e) of the axis."""

    name: str
    cset: str
    axis: str


@dataclasses.dataclass(frozen=True)
class InvJoinReq:
    """Duplicate-detection join against the inventory (the
    K8sUniqueIngressHost pattern, regolib src.go:55-60 inventory access):

      ∃ another cached object of `kind` (namespace-scoped when
      `namespaced_only`) whose value at `inv_path` equals the review
      object's value at `src_path`, with a different metadata.name when
      `exclude_same_name`.

    Lowered to a per-row bool column `name` ([r_pad]) built from interned
    value counts (np.unique/bincount over the kind's rows) — the device
    sees a plain r_bool input; no per-pair join ever materializes.
    Cross-row by nature: delta updates recompute the column and diff
    against the previous one to find the true dirty set."""

    name: str
    kind: str
    inv_path: tuple[str, ...]
    src_path: tuple[str, ...]
    exclude_same_name: bool = True
    namespaced_only: bool = True


@dataclasses.dataclass(frozen=True)
class MembReq:
    """Membership matrix vs a ragged per-resource key set.

    keys_path points at a dict (its keys are the set, e.g.
    metadata.labels); needed ids come from the paired cset; output is
    memb[L, R] plus the cset re-indexed into [0, L)."""

    name: str
    cset: str
    keys_path: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class PrepSpec:
    r_cols: tuple[RColReq, ...] = ()
    e_cols: tuple[EColReq, ...] = ()
    axes: tuple[tuple[str, tuple[str, ...]], ...] = ()   # (axis key, base path)
    tables: tuple[TableReq, ...] = ()
    ptables: tuple[PTableReq, ...] = ()
    csets: tuple[CSetReq, ...] = ()
    cvals: tuple[CValReq, ...] = ()
    membs: tuple[MembReq, ...] = ()
    elem_keys: tuple[ElemKeysReq, ...] = ()
    keyed_vals: tuple[KeyedValReq, ...] = ()
    inv_joins: tuple[InvJoinReq, ...] = ()
    dfas: tuple[DfaReq, ...] = ()
    # constraint-only conjuncts, folded into one validity vector
    cvalid_fns: tuple[Callable[[dict], bool], ...] = ()


# ---------------------------------------------------------------------------
# element-aligned column extraction


def _elem_rows(obj: Any, base: tuple[str, ...]):
    """Elements of the list at `base`.  A ``"*"`` segment flattens an
    intermediate list axis (``spec.containers.*.env`` yields every env
    entry of every container, nested iteration ``containers[_].env[_]``
    collapsed onto one flattened element axis)."""
    cur = [obj]
    for p in base:
        if p == "*":
            nxt: list = []
            for v in cur:
                if isinstance(v, list):
                    nxt.extend(v)
            cur = nxt
        else:
            cur = [v[p] for v in cur if isinstance(v, dict) and p in v]
    out: list = []
    for v in cur:
        if isinstance(v, list):
            out.extend(v)
    return out


def build_elem_arrays(objs: list, base: tuple[str, ...], rels: list[tuple[tuple[str, ...], str]],
                      interner: Interner):
    """One pass over the base list producing aligned CSR columns for every
    (rel, mode) request plus per-row element counts.  Rides the native
    extractor (gatekeeper_tpu/native) when available; this Python body
    is the semantics contract the extension is tested against."""
    from gatekeeper_tpu_torch import native
    if native.available:
        counts, cols = native.elem_arrays(
            objs, base, [r for r, _m in rels],
            [native.MODE_CODES[m] for _r, m in rels],
            interner._ids, interner._strings, encode_value)
        return counts, {rm: col for rm, col in zip(rels, cols)}
    n = len(objs)
    counts = np.zeros((n,), dtype=np.int32)
    outs: dict[tuple[tuple[str, ...], str], list] = {rm: [] for rm in rels}
    for i, o in enumerate(objs):
        elems = _elem_rows(o, base) if o is not None else []
        counts[i] = len(elems)
        for e in elems:
            for (rel, mode) in rels:
                col = outs[(rel, mode)]
                v = get_path(e, rel) if rel else e
                has = _rel_has(e, rel)
                if mode == "str":
                    col.append(interner.intern(v) if isinstance(v, str) else MISSING)
                elif mode == "val":
                    key = encode_value(v) if has else None
                    col.append(interner.intern(key) if key is not None else MISSING)
                elif mode == "num":
                    ok = isinstance(v, (int, float)) and not isinstance(v, bool)
                    try:
                        col.append(float(v) if ok else np.nan)
                    except OverflowError:
                        col.append(np.nan)   # beyond float64: absent
                elif mode == "len":
                    ok = isinstance(v, (list, dict, str))
                    col.append(float(len(v)) if ok else np.nan)
                elif mode == "present":
                    col.append(has)
                elif mode == "truthy":
                    col.append(has and v is not False)
                else:
                    raise ValueError(f"bad elem mode {mode}")
    return counts, outs


def _rel_has(e: Any, rel: tuple[str, ...]) -> bool:
    if not rel:
        return True
    cur = e
    for p in rel:
        if not isinstance(cur, dict) or p not in cur:
            return False
        cur = cur[p]
    return True


# ---------------------------------------------------------------------------
# bindings


@dataclasses.dataclass
class Bindings:
    """name -> np.ndarray, plus shape info.  Split into device-bound
    arrays (``arrays``) and host-only metadata.

    Delta lineage (steady-state churn, SURVEY §7.5 / inmem txn.go
    precedent): ``base`` points at the Bindings this one was derived
    from by ``update_bindings`` and ``base_dirty`` maps each changed
    r-axis array name to the dirty row indices — the device executor
    uses it to scatter-update cached device arrays instead of
    re-uploading whole columns.  ``delta_state`` carries the host-side
    bookkeeping (evaluated table ids, ptable slot maps, element counts)
    that makes the next incremental update possible."""

    arrays: dict[str, np.ndarray]
    n_constraints: int
    n_resources: int
    c_pad: int
    r_pad: int
    e_pads: dict[str, int]
    delta_state: dict = dataclasses.field(default_factory=dict)
    base: "Bindings | None" = None
    base_dirty: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # arrays changed vs base WITHOUT a row-dirty footprint but in an
    # append-only way (value tables gaining entries for ids that only
    # dirty rows reference) — row-sliced delta evaluation stays sound
    base_append_only: set = dataclasses.field(default_factory=set)
    # axis-0 indices appended per append-only array whose existing
    # entries are untouched: the executor scatters just these rows
    # into its cached device copy (a full __strbytes__ re-upload per
    # newly interned string would dwarf the churn itself).  Arrays in
    # ``base_append_only`` but not here (ptable .any/.all, which grow
    # along the value axis) re-upload whole — they are tiny.
    base_append_rows: dict[str, np.ndarray] = \
        dataclasses.field(default_factory=dict)
    # True when some numeric value bound for the device is not exactly
    # representable in float32 (|v| past 2^24 off the even lattice):
    # device ordering compares could silently mis-order such values
    # (ir/lower.py "known deviations"), so the driver routes this
    # kind's evaluation to the scalar oracle instead.
    f32_unsafe: bool = False

    def shapes_key(self) -> tuple:
        return tuple(sorted((k, v.shape, str(v.dtype)) for k, v in self.arrays.items()))

    def nbytes(self) -> int:
        """Host-side bytes of every device-bound array — the H2D upload
        footprint of a cold or forced-full sweep (a memoized steady
        sweep re-uploads none of it; a churn sweep scatters only dirty
        rows)."""
        return int(sum(a.nbytes for a in self.arrays.values()))


def _f32_exact(a) -> bool:
    """Every finite value in `a` survives a float32 round-trip exactly.
    False means a device float32 ordering compare could mis-order
    (integers past 2^24, or floats needing >24 mantissa bits)."""
    a = np.asarray(a, dtype=np.float64)
    if a.size == 0:
        return True
    with np.errstate(invalid="ignore", over="ignore"):
        rt = a.astype(np.float32).astype(np.float64)
        return bool(np.all(np.isnan(a) | (a == rt)))


_STR_PREFIX = b"\x00s:"
"""Interned byte image of an encoded string value (ir/encode:
``_P + _ser(str)`` = NUL + "s:" + raw).  The device DFA scan skips
these 3 prefix bytes; only ids carrying the prefix can ever appear in
a val-mode source column, so everything else is vacuously False."""


def _dfa_eligible(mat: np.ndarray, lens: np.ndarray, max_len: int):
    """(eligible, str_prefixed) bool [n] over interner byte rows.

    eligible: the row is an exact NUL-free ASCII image of an encoded
    string — the in-jit DFA scan over ``__strbytes__`` reproduces the
    host ``re.search`` bit-for-bit.  str_prefixed but not eligible
    (non-ASCII payload, embedded NUL, or a row at the width cap that
    may be truncated): the per-dfa host fallback vector ``.xv`` serves
    those few ids instead."""
    if mat.shape[0] == 0:
        z = np.zeros((0,), dtype=bool)
        return z, z
    pref = ((lens >= 3) & (mat[:, 0] == _STR_PREFIX[0])
            & (mat[:, 1] == _STR_PREFIX[1]) & (mat[:, 2] == _STR_PREFIX[2]))
    payload = mat[:, 3:]
    ascii_ok = (payload <= 127).all(axis=1)
    no_nul = (payload != 0).sum(axis=1, dtype=np.int64) == (lens - 3)
    return pref & ascii_ok & no_nul & (lens < max_len), pref


def _dfa_xv_fill(pattern: str, interner, xv: np.ndarray,
                 host_ids: np.ndarray) -> None:
    """Host-oracle verdicts for the device-ineligible string ids (the
    exact fallback _regex_table_batch uses for packer-rejected
    entries).  Non-string decodes stay False — a val column id that
    decodes to a non-string makes ``re_match`` undefined, and False
    collapses identically through the fires lattice."""
    if not len(host_ids):
        return
    import re
    rx = re.compile(pattern)
    for uid in host_ids.tolist():
        arg = decode_value(interner.string(uid))
        if isinstance(arg, str):
            xv[uid] = rx.search(arg) is not None


def _regex_table_batch(tr, uids: list, interner, ok, vals) -> bool:
    """Batched DFA route for pure-regex bool tables at high unique
    cardinality (ops/regex_dfa): one vectorized transition gather per
    character position instead of one Python re.search per distinct
    string.  Returns False (caller keeps the per-value host loop) when
    the table is not a regex, is small, or the pattern/input falls
    outside the DFA subset — results are bit-identical either way."""
    if tr.regex is None or tr.out != "bool":
        return False
    from gatekeeper_tpu_torch.ops import regex_dfa
    if len(uids) < regex_dfa.TABLE_MIN_UNIQUES:
        return False
    dfa = regex_dfa.cached_dfa(tr.regex)
    if dfa is None:
        return False
    str_uids, strs = [], []
    for uid in uids:
        key = interner.string(uid)
        arg = decode_value(key) if tr.src_val else key
        if isinstance(arg, str):
            str_uids.append(uid)
            strs.append(arg)
    if not strs:
        return True              # no string values: all undefined
    matched = regex_dfa.match_strings(
        dfa, strs, device=len(strs) >= regex_dfa.TABLE_DEVICE_MIN_UNIQUES)
    idx = np.asarray(str_uids, dtype=np.int64)
    # the bool-table host fn returns True or None (never False):
    # `ok` encodes defined AND truthy — mirror that exactly
    ok[idx] = matched
    vals[idx] = matched
    return True


def _eval_host(fn, *args):
    """Host table/cval evaluation: exceptions and UNDEFINED -> None."""
    from gatekeeper_tpu_torch.rego.builtins import UNDEFINED, BuiltinError
    try:
        v = fn(*args)
    except BuiltinError:
        return None
    except (TypeError, ValueError, KeyError, IndexError, ZeroDivisionError):
        return None
    if v is UNDEFINED:
        return None
    return v


def _ext_prefetch(tr, uids, interner) -> None:
    """Key-collection prefetch for external-data tables: warm every
    (provider, distinct column value) pair in ONE batched round per
    provider before the per-value fn loop, so each fn call's
    external_data lookup is a cache hit.  Single-flight in the cache
    dedupes against any concurrently running bulk warm (the audit
    sweep's overlapped prefetch).  Never raises: fetch failures are
    cached outcomes; failurePolicy is applied when fn calls the
    builtin."""
    if not tr.ext_providers:
        return
    from gatekeeper_tpu_torch.errors import ClientError
    raise ClientError("external_data: external data is not yet ported "
                      "to gatekeeper_tpu_torch")


def build_inv_join(req: InvJoinReq, table: ResourceTable,
                   r_pad: int) -> np.ndarray:
    """[r_pad] bool: the review row has a same-valued other object.
    All-vectorized: unique-value counts over the kind's rows, pair
    counts for the same-name exclusion, gathers for the per-row verdict.
    The review row itself is among the kind's rows during an audit, and
    the same-name exclusion removes it exactly like the oracle's
    ``not review.name == name`` guard."""
    interner = table.interner
    ident = table.identity()
    n = table.n_rows
    kid = interner.lookup(req.kind)
    out = np.zeros((r_pad,), dtype=bool)
    if kid == MISSING or n == 0:
        return out      # joined kind uncached: O(1), no column build
    src = table.column(ColSpec(req.src_path, "val")).ids
    sel = ident.alive & (ident.kind_ids == kid)
    if req.namespaced_only:
        sel &= ident.ns_ids != MISSING
    inv_vals = table.column(ColSpec(req.inv_path, "val")).ids
    h = inv_vals[sel]
    h = h[h != MISSING]
    if not len(h):
        return out
    uh, cnt = np.unique(h, return_counts=True)
    pos = np.searchsorted(uh, src)
    pos_c = np.clip(pos, 0, len(uh) - 1)
    valid = (src != MISSING) & (uh[pos_c] == src)
    total = np.where(valid, cnt[pos_c], 0)
    own = np.zeros((n,), dtype=np.int64)
    if req.exclude_same_name:
        big = np.int64(len(interner) + 1)
        names_inv = ident.name_ids[sel][inv_vals[sel] != MISSING]
        pair_inv = h.astype(np.int64) * big + names_inv
        up, ucnt = np.unique(pair_inv, return_counts=True)
        # review-side name: the object's metadata.name equals the cached
        # meta name (ProcessData derives the key from it)
        pair_rev = src.astype(np.int64) * big + ident.name_ids
        ppos = np.clip(np.searchsorted(up, pair_rev), 0, len(up) - 1)
        pvalid = valid & (ident.name_ids != MISSING) & (up[ppos] == pair_rev)
        own = np.where(pvalid, ucnt[ppos], 0)
    out[:n] = (total - own) > 0
    return out


def build_bindings(spec: PrepSpec, table: ResourceTable,
                   constraints: list[dict]) -> Bindings:
    """Materialize every requested array, padded to shape buckets."""
    interner = table.interner
    objs = table._objs
    n = len(objs)
    n_con = len(constraints)
    r_pad, c_pad = audit_pads(n, n_con)
    out: dict[str, np.ndarray] = {}
    f32_unsafe = False
    # bookkeeping that makes the next update_bindings() possible
    state: dict = {"gen": table.generation, "remap": table.remap_generation,
                   "tables": {}, "ptables": {}, "csets": {},
                   "elem_counts": {}, "interner_size": len(interner)}

    alive = np.zeros((r_pad,), dtype=bool)
    for i, m in enumerate(table._metas):
        if m is not None:
            alive[i] = True
    out["__alive__"] = alive

    # ---- per-resource scalar columns
    for rc in spec.r_cols:
        if rc.path and rc.path[0] == "$meta":
            ids = np.full((r_pad,), MISSING, dtype=np.int32)
            ids[:n] = _meta_ids(table, rc.path[1:])
            out[rc.name] = ids
        elif rc.mode in ("str", "val"):
            col = table.column(ColSpec(rc.path, rc.mode))
            ids = np.full((r_pad,), MISSING, dtype=np.int32)
            ids[:n] = col.ids
            out[rc.name] = ids
        elif rc.mode in ("num", "len"):
            col = table.column(ColSpec(rc.path, rc.mode))
            v = np.zeros((r_pad,), dtype=np.float32)
            p = np.zeros((r_pad,), dtype=bool)
            v[:n] = col.values.astype(np.float32)
            p[:n] = col.present
            f32_unsafe = f32_unsafe or not _f32_exact(col.values[col.present])
            out[rc.name + ".v"] = v
            out[rc.name + ".p"] = p
        elif rc.mode in ("present", "truthy"):
            col = table.column(ColSpec(rc.path, rc.mode))
            b = np.zeros((r_pad,), dtype=bool)
            b[:n] = col.present
            out[rc.name] = b
        else:
            raise ValueError(f"bad r_col mode {rc.mode}")

    # ---- element axes (one extraction pass per axis)
    axis_cols: dict[str, list[EColReq]] = {}
    for ec in spec.e_cols:
        axis_cols.setdefault(ec.axis, []).append(ec)
    axis_base = dict(spec.axes)
    e_pads: dict[str, int] = {}
    for axis, base in spec.axes:
        ecs = axis_cols.get(axis, [])
        rels = sorted({(ec.rel, ec.mode) for ec in ecs})
        # served from the table's per-(base, generation) superset cache
        # — kinds sharing an axis share ONE extraction walk
        counts, cols = table.elem_arrays(base, rels)
        state["elem_counts"][axis] = counts
        e_max = int(counts.max()) if n else 0
        e_pad = bucket(max(e_max, 1), minimum=2)
        e_pads[axis] = e_pad
        offs = np.zeros((n + 1,), dtype=np.int64)
        np.cumsum(counts, out=offs[1:])
        pres = np.zeros((r_pad, e_pad), dtype=bool)
        idx_r, idx_e = _csr_to_dense_idx(counts, offs)
        pres[idx_r, idx_e] = True
        out[f"__elem__:{axis}"] = pres
        for ec in ecs:
            flat = cols[(ec.rel, ec.mode)]
            if ec.mode in ("str", "val"):
                arr = np.full((r_pad, e_pad), MISSING, dtype=np.int32)
                if len(flat):
                    arr[idx_r, idx_e] = np.asarray(flat, dtype=np.int32)
                out[ec.name] = arr
            elif ec.mode in ("num", "len"):
                fv = np.asarray(flat, dtype=np.float64) if len(flat) else np.zeros((0,))
                v = np.zeros((r_pad, e_pad), dtype=np.float32)
                p = np.zeros((r_pad, e_pad), dtype=bool)
                if len(flat):
                    v[idx_r, idx_e] = np.nan_to_num(fv).astype(np.float32)
                    p[idx_r, idx_e] = ~np.isnan(fv)
                    f32_unsafe = f32_unsafe or not _f32_exact(fv)
                out[ec.name + ".v"] = v
                out[ec.name + ".p"] = p
            else:  # present / truthy
                b = np.zeros((r_pad, e_pad), dtype=bool)
                if len(flat):
                    b[idx_r, idx_e] = np.asarray(flat, dtype=bool)
                out[ec.name] = b

    # ---- dynamic-key container lookups
    #
    # Built BEFORE any table/cset/ptable: the value fill interns new
    # ids, and those table constructors size their lookup arrays by
    # bucket(len(interner)) — interning after sizing would make device
    # gathers go out of bounds (XLA clamps, silently aliasing unseen
    # values onto the last table entry).
    #
    # Key/container semantics mirror the oracle's _walk_ref ground
    # branch: dict -> key membership (any scalar key), list -> int
    # (non-bool) in-range index, anything else -> undefined.
    for kl in spec.keyed_vals:
        from gatekeeper_tpu_torch.rego.values import canon_num
        keys = []
        for c in constraints:
            k = _eval_host(kl.key_fn, c)
            if isinstance(k, (int, float)) and not isinstance(k, bool):
                k = canon_num(k)           # 1.0 and 1 index identically
            elif not isinstance(k, (str, bool)):
                k = None                   # non-scalar key: undefined
            keys.append(k)
        needed = sorted({k for k in keys if k is not None}, key=repr)
        local = {k: i for i, k in enumerate(needed)}
        k_pad = bucket(max(len(needed), 1), minimum=2)
        kv = np.full((k_pad, r_pad), MISSING, dtype=np.int32)
        for row, o in enumerate(objs):
            if o is None:
                continue
            d = get_path(o, kl.path)
            if isinstance(d, dict):
                for k in needed:
                    if k in d:
                        ekey = encode_value(d[k])
                        if ekey is not None:
                            kv[local[k], row] = interner.intern(ekey)
            elif isinstance(d, list):
                for k in needed:
                    if isinstance(k, int) and not isinstance(k, bool) \
                            and 0 <= k < len(d):
                        ekey = encode_value(d[k])
                        if ekey is not None:
                            kv[local[k], row] = interner.intern(ekey)
        sel = np.full((c_pad,), -1, dtype=np.int32)
        for ci, k in enumerate(keys):
            if k is not None:
                sel[ci] = local[k]
        out[kl.name + ".kv"] = kv
        out[kl.name + ".sel"] = sel

    # ---- unary tables over distinct column values
    for tr in spec.tables:
        src_ids = _src_ids(out, tr.src)
        uniq = np.unique(src_ids)
        uniq = uniq[uniq >= 0]
        t_pad = interner_bucket(len(interner))
        ok = np.zeros((t_pad,), dtype=bool)
        if tr.out == "num":
            vals = np.zeros((t_pad,), dtype=np.float32)
        elif tr.out in ("id_str", "id_val"):
            vals = np.full((t_pad,), MISSING, dtype=np.int32)
        else:
            vals = np.zeros((t_pad,), dtype=bool)
        if _regex_table_batch(tr, uniq.tolist(), interner, ok, vals):
            out[tr.name + ".ok"] = ok
            out[tr.name + ".v"] = vals
            state["tables"][tr.name] = set(uniq.tolist())
            continue
        _ext_prefetch(tr, uniq.tolist(), interner)
        for uid in uniq.tolist():
            key = interner.string(uid)
            arg = decode_value(key) if tr.src_val else key
            v = _eval_host(tr.fn, arg)
            if v is None:
                continue
            if tr.out == "num":
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    ok[uid] = True
                    vals[uid] = np.float32(v)
                    f32_unsafe = f32_unsafe or not _f32_exact([v])
            elif tr.out == "id_str":
                if isinstance(v, str):
                    ok[uid] = True
                    vals[uid] = interner.intern(v)
            elif tr.out == "id_val":
                ekey = encode_value(v)
                if ekey is not None:
                    ok[uid] = True
                    vals[uid] = interner.intern(ekey)
            else:
                ok[uid] = True
                vals[uid] = bool(v) if isinstance(v, bool) else True
        out[tr.name + ".ok"] = ok
        out[tr.name + ".v"] = vals
        state["tables"][tr.name] = set(uniq.tolist())

    # ---- parametric tables, pre-combined per constraint
    #
    # The [n_params, n_values] predicate table and the per-constraint
    # param index sets are folded on host into dense per-constraint
    # tables over the *distinct* source values:
    #   vmap  [t_pad]      global value id -> dense u (sentinel = U-1)
    #   .any  [c_pad, U]   OR  over the constraint's params of fn(v, p)
    #   .all  [c_pad, U]   AND over the constraint's params (vacuous True)
    # The device never materializes a [C, K, R, E] per-param axis — one
    # gather per evaluation, O(C*U) bytes of table.
    for pt in spec.ptables:
        per_con: list[list] = []
        distinct: dict[str, int] = {}
        for c in constraints:
            params = _eval_host(pt.cparams, c)
            lst = []
            if isinstance(params, (list, tuple)):
                for p in params:
                    if isinstance(p, str):
                        if p not in distinct:
                            distinct[p] = len(distinct)
                        lst.append(distinct[p])
            per_con.append(lst)
        src_ids = _src_ids(out, pt.src)
        uniq = np.unique(src_ids)
        uniq = uniq[uniq >= 0]
        t_pad = interner_bucket(len(interner))
        u_pad = bucket(len(uniq) + 1, minimum=2)   # +1: sentinel slot
        vmap = np.full((t_pad,), u_pad - 1, dtype=np.int32)
        vmap[uniq] = np.arange(len(uniq), dtype=np.int32)
        tbl = np.zeros((len(distinct), u_pad), dtype=bool)
        for pi, pstr in enumerate(distinct):
            for u, uid in enumerate(uniq.tolist()):
                key = interner.string(uid)
                arg = decode_value(key) if pt.src_val else key
                v = _eval_host(pt.fn, arg, pstr)
                tbl[pi, u] = bool(v) if v is not None and v is not False else False
        t_any = np.zeros((c_pad, u_pad), dtype=bool)
        t_all = np.zeros((c_pad, u_pad), dtype=bool)
        for ci, lst in enumerate(per_con):
            if lst:
                t_any[ci] = tbl[lst].any(axis=0)
                t_all[ci] = tbl[lst].all(axis=0)
            else:
                t_all[ci] = True                   # vacuous all-of-none
        out[pt.name + ".vmap"] = vmap
        out[pt.name + ".any"] = t_any
        out[pt.name + ".all"] = t_all
        state["ptables"][pt.name] = {
            "u_of": {int(g): u for u, g in enumerate(uniq.tolist())},
            "distinct": dict(distinct), "per_con": per_con, "tbl": tbl}

    # ---- per-constraint id sets
    #
    # Three consumption forms, all K-axis-free on device:
    # - with a paired membership matrix (subset ops): a [c_pad, l_pad]
    #   indicator ``B`` — the subset test becomes one bf16 matmul
    #   B @ ~memb on the MXU (engine/veval.py);
    # - otherwise (``in_cset``): ``vmap`` [t_pad] global id -> dense u
    #   over the union of set values, plus a [c_pad, U] ``bitmap``
    #   (sentinel column U-1 = not in any constraint's set).
    memb_by_cset = {m.cset: m for m in spec.membs}
    ekeys_by_cset = {e.cset: e for e in spec.elem_keys}
    cset_state = state["csets"]
    for cs in spec.csets:
        per_con = []
        for c in constraints:
            vals = _eval_host(cs.fn, c)
            lst = []
            if isinstance(vals, (list, tuple, frozenset, set)):
                seq = sorted(vals, key=repr) if isinstance(vals, (frozenset, set)) else vals
                for v in seq:
                    if cs.encode == "str" and isinstance(v, str):
                        lst.append(interner.intern(v))
                    else:
                        key = encode_value(v)
                        if key is not None:
                            lst.append(interner.intern(key))
            per_con.append(lst)
        m = memb_by_cset.get(cs.name)
        ek = ekeys_by_cset.get(cs.name)
        needed = sorted({i for lst in per_con for i in lst})
        local = {gid: li for li, gid in enumerate(needed)}
        cset_state[cs.name] = {"needed": needed, "local": local}
        if ek is not None:
            # elem-axis truthy-key membership + per-constraint indicator.
            # Element semantics mirror the oracle's coll[key] statement:
            # dict -> string key present and not false; list -> int
            # (non-bool) index in range and element not false; any other
            # element type has no keys (coll[key] undefined).
            e_pad = e_pads[ek.axis]
            k_pad = bucket(max(len(needed), 1), minimum=2)
            ekm = np.zeros((k_pad, r_pad, e_pad), dtype=bool)
            str_local: dict = {}
            int_local: dict = {}
            for gid in needed:
                ks = interner.string(gid)
                k = decode_value(ks) if ks.startswith("\x00") else ks
                if isinstance(k, str):
                    str_local[k] = local[gid]
                elif isinstance(k, int) and not isinstance(k, bool):
                    int_local[k] = local[gid]
            base_path = dict(spec.axes)[ek.axis]
            for row, o in enumerate(objs):
                if o is None:
                    continue
                for ei, elem in enumerate(_elem_rows(o, base_path)):
                    if ei >= e_pad:
                        continue
                    if isinstance(elem, dict):
                        # O(|needed|): probe the tiny key map against
                        # the element, not the other way around
                        for k, li in str_local.items():
                            if k in elem and elem[k] is not False:
                                ekm[li, row, ei] = True
                    elif isinstance(elem, list):
                        for k, li in int_local.items():
                            if 0 <= k < len(elem) and elem[k] is not False:
                                ekm[li, row, ei] = True
            out[ek.name] = ekm
        if ek is not None or m is not None:
            if m is not None:
                l_pad = bucket(max(len(needed), 1), minimum=2)
                memb = np.zeros((l_pad, r_pad), dtype=bool)
                _fill_membership(memb, objs, m.keys_path, needed, local,
                                 interner)
                out[m.name] = memb
            else:
                l_pad = bucket(max(len(needed), 1), minimum=2)
            # shared per-constraint key/label indicator
            B = np.zeros((c_pad, l_pad), dtype=bool)
            for ci, lst in enumerate(per_con):
                for gid in lst:
                    B[ci, local[gid]] = True
            out[cs.name + ".B"] = B
        else:
            t_pad = interner_bucket(len(interner))
            u_pad = bucket(len(needed) + 1, minimum=2)   # +1: sentinel
            vmap = np.full((t_pad,), u_pad - 1, dtype=np.int32)
            for gid, li in local.items():
                vmap[gid] = li
            bitmap = np.zeros((c_pad, u_pad), dtype=bool)
            for ci, lst in enumerate(per_con):
                for gid in lst:
                    bitmap[ci, local[gid]] = True
            out[cs.name + ".vmap"] = vmap
            out[cs.name + ".bitmap"] = bitmap

    # ---- per-constraint scalars
    for cv in spec.cvals:
        if cv.kind == "num":
            v = np.zeros((c_pad,), dtype=np.float32)
            p = np.zeros((c_pad,), dtype=bool)
            for ci, c in enumerate(constraints):
                x = _eval_host(cv.fn, c)
                if isinstance(x, (int, float)) and not isinstance(x, bool):
                    v[ci] = np.float32(x)
                    p[ci] = True
                    f32_unsafe = f32_unsafe or not _f32_exact([x])
            out[cv.name + ".v"] = v
            out[cv.name + ".p"] = p
        elif cv.kind == "str":
            ids = np.full((c_pad,), MISSING, dtype=np.int32)
            for ci, c in enumerate(constraints):
                x = _eval_host(cv.fn, c)
                if isinstance(x, str):
                    ids[ci] = interner.intern(x)
            out[cv.name] = ids
        elif cv.kind == "val":
            ids = np.full((c_pad,), MISSING, dtype=np.int32)
            for ci, c in enumerate(constraints):
                x = _eval_host(cv.fn, c)
                key = encode_value(x) if x is not None else None
                if key is not None:
                    ids[ci] = interner.intern(key)
            out[cv.name] = ids
        else:  # bool
            b = np.zeros((c_pad,), dtype=bool)
            for ci, c in enumerate(constraints):
                x = _eval_host(cv.fn, c)
                b[ci] = bool(x) if x is not None else False
            out[cv.name] = b

    # ---- inventory joins (cross-row duplicate detection)
    for ij in spec.inv_joins:
        out[ij.name] = build_inv_join(ij, table, r_pad)

    # ---- constraint validity (constraint-only conjuncts)
    cvalid = np.zeros((c_pad,), dtype=bool)
    for ci, c in enumerate(constraints):
        ok = True
        for fn in spec.cvalid_fns:
            v = _eval_host(fn, c)
            if v is None or v is False:
                ok = False
                break
        cvalid[ci] = ok
    out["__cvalid__"] = cvalid

    # ---- in-program regex DFAs (built LAST: every section above may
    # intern, and the byte matrix must cover the final interner)
    if spec.dfas:
        from gatekeeper_tpu_torch.ops import regex_dfa
        mat, lens = interner.bytes_table()
        t_pad = interner_bucket(len(interner))
        sb = np.zeros((t_pad, interner.max_str_len), dtype=np.uint8)
        sb[: mat.shape[0]] = mat
        elig, prefixed = _dfa_eligible(mat, lens, interner.max_str_len)
        okv = np.zeros((t_pad,), dtype=bool)
        okv[: len(elig)] = elig
        out["__strbytes__"] = sb
        out["__strdfaok__"] = okv
        host_ids = np.nonzero(prefixed & ~elig)[0]
        for dr in spec.dfas:
            dfa = regex_dfa.cached_dfa(dr.pattern)
            if dfa is None:      # lowering only emits dfa_match for
                # compilable patterns; hitting this means version skew
                raise ValueError(
                    f"dfa_match binding {dr.name}: pattern "
                    f"{dr.pattern!r} no longer DFA-compilable")
            xv = np.zeros((t_pad,), dtype=bool)
            _dfa_xv_fill(dr.pattern, interner, xv, host_ids)
            out[dr.name + ".trans"] = dfa.trans
            out[dr.name + ".accept"] = np.asarray(dfa.accept, dtype=bool)
            out[dr.name + ".xv"] = xv
        state["dfa_size"] = len(interner)

    return Bindings(arrays=out, n_constraints=n_con, n_resources=n,
                    c_pad=c_pad, r_pad=r_pad, e_pads=e_pads,
                    delta_state=state, f32_unsafe=f32_unsafe)


def update_bindings(spec: PrepSpec, table: ResourceTable,
                    constraints: list[dict],
                    prev: Bindings,
                    recycle: Bindings | None = None) -> Bindings | None:
    """Incrementally derive a new Bindings from `prev` by re-extracting
    only the rows dirty since prev was built (prev.delta_state["gen"]).

    Returns None when a full rebuild is required: row-id remap
    (wipe/compact), shape-bucket growth (rows, element widths, interner
    past its table bucket, new ptable value slots), or a dirty set too
    large for the delta to pay off.  The caller must treat None as
    "call build_bindings".

    prev and its arrays are never mutated — changed arrays get fresh
    identities and their rows-dirty-since-prev are recorded in
    ``base_dirty`` so the device cache can scatter-update instead of
    re-uploading (engine/veval.ProgramExecutor._arrays).

    ``recycle`` (optional) is a RETIRED Bindings at least one update
    older than prev whose numpy buffers may be overwritten in place —
    the ping-pong that turns per-sweep O(r_pad) array copies into
    O(|dirty|) writes.  Writes then cover the rows dirty since
    *recycle* (a superset of base_dirty's rows); vs prev the result
    still differs only at base_dirty rows, which is the device-sync
    contract.  The caller owns the safety argument: nothing else may
    read the recycled buffers as current data (the driver hands out
    only the newest bindings per kind, and device arrays are immutable
    snapshots — see engine/jax_driver._kind_bindings).  Constraint-set
    changes are NOT handled here (caller keys on the constraint version
    and rebuilds) — all per-constraint arrays are shared as-is."""
    from gatekeeper_tpu_torch.store.table import delta_worthwhile
    st0 = prev.delta_state
    if not st0 or st0.get("remap") != table.remap_generation:
        return None
    objs = table._objs
    n = len(objs)
    if audit_pads(n, 0)[0] != prev.r_pad:
        return None
    prev_gen = st0["gen"]
    base_rows = table.dirty_rows_since(prev_gen)
    rec_state = recycle.delta_state if recycle is not None else None
    if rec_state and rec_state.get("remap") == table.remap_generation \
            and recycle.r_pad == prev.r_pad and recycle is not prev:
        dirty = table.dirty_rows_since(min(rec_state["gen"], prev_gen))
        rec_arrays = recycle.arrays
    else:
        dirty = base_rows
        rec_arrays = {}
    if not delta_worthwhile(len(dirty), n):
        return None
    interner = table.interner
    r_pad, c_pad = prev.r_pad, prev.c_pad
    out = dict(prev.arrays)
    base_dirty: dict[str, np.ndarray] = {}
    append_only: set = set()
    append_rows: dict[str, np.ndarray] = {}
    state: dict = {"gen": table.generation, "remap": table.remap_generation,
                   "tables": {}, "ptables": {}, "csets": st0["csets"],
                   "elem_counts": {}, "interner_size": 0}
    if len(dirty) == 0:
        st1 = dict(st0)
        st1["gen"] = table.generation
        return dataclasses.replace(prev, delta_state=st1, base=prev,
                                   base_dirty={}, base_append_only=set(),
                                   base_append_rows={})
    dirty_objs = [objs[int(i)] for i in dirty]

    def cow(name: str) -> np.ndarray:
        cur = out[name]
        rec = rec_arrays.get(name)
        if rec is not None and rec is not cur and rec.shape == cur.shape \
                and rec.dtype == cur.dtype:
            arr = rec            # overwrite the retired buffer in place
        else:
            arr = cur.copy()
        out[name] = arr
        base_dirty[name] = base_rows
        return arr

    f32_unsafe = prev.f32_unsafe
    alive = cow("__alive__")
    alive[dirty] = [table._metas[int(i)] is not None for i in dirty]

    # ---- per-resource scalar columns (table.column is itself delta-
    # maintained, so the slice below costs O(dirty))
    for rc in spec.r_cols:
        if rc.path and rc.path[0] == "$meta":
            cow(rc.name)[dirty] = _meta_ids(table, rc.path[1:])[dirty]
        elif rc.mode in ("str", "val"):
            col = table.column(ColSpec(rc.path, rc.mode))
            cow(rc.name)[dirty] = col.ids[dirty]
        elif rc.mode in ("num", "len"):
            col = table.column(ColSpec(rc.path, rc.mode))
            cow(rc.name + ".v")[dirty] = col.values[dirty].astype(np.float32)
            cow(rc.name + ".p")[dirty] = col.present[dirty]
            f32_unsafe = f32_unsafe or not _f32_exact(
                col.values[dirty][col.present[dirty]])
        else:  # present / truthy
            col = table.column(ColSpec(rc.path, rc.mode))
            cow(rc.name)[dirty] = col.present[dirty]

    # ---- element axes: re-extract dirty rows only
    axis_cols: dict[str, list[EColReq]] = {}
    for ec in spec.e_cols:
        axis_cols.setdefault(ec.axis, []).append(ec)
    for axis, base in spec.axes:
        ecs = axis_cols.get(axis, [])
        rels = sorted({(ec.rel, ec.mode) for ec in ecs})
        counts_sub, cols_sub = build_elem_arrays(dirty_objs, base, rels,
                                                 interner)
        e_pad = prev.e_pads[axis]
        if len(counts_sub) and int(counts_sub.max()) > e_pad:
            return None                      # element bucket outgrown
        old_counts = st0["elem_counts"][axis]
        counts = np.zeros((n,), dtype=np.int32)
        counts[: len(old_counts)] = old_counts
        counts[dirty] = counts_sub
        state["elem_counts"][axis] = counts
        offs = np.zeros((len(dirty) + 1,), dtype=np.int64)
        np.cumsum(counts_sub, out=offs[1:])
        total = int(offs[-1])
        idx_r = dirty[np.repeat(np.arange(len(dirty)), counts_sub)]
        idx_e = np.arange(total, dtype=np.int64) - \
            np.repeat(offs[:-1], counts_sub)
        pres = cow(f"__elem__:{axis}")
        pres[dirty] = False
        pres[idx_r, idx_e] = True
        for ec in ecs:
            flat = cols_sub[(ec.rel, ec.mode)]
            if ec.mode in ("str", "val"):
                arr = cow(ec.name)
                arr[dirty] = MISSING
                if len(flat):
                    arr[idx_r, idx_e] = np.asarray(flat, dtype=np.int32)
            elif ec.mode in ("num", "len"):
                fv = np.asarray(flat, dtype=np.float64) if len(flat) else np.zeros((0,))
                v = cow(ec.name + ".v")
                p = cow(ec.name + ".p")
                v[dirty] = 0.0
                p[dirty] = False
                if len(flat):
                    v[idx_r, idx_e] = np.nan_to_num(fv).astype(np.float32)
                    p[idx_r, idx_e] = ~np.isnan(fv)
                    f32_unsafe = f32_unsafe or not _f32_exact(fv)
            else:
                b = cow(ec.name)
                b[dirty] = False
                if len(flat):
                    b[idx_r, idx_e] = np.asarray(flat, dtype=bool)

    # ---- dynamic-key container lookups: refill dirty columns
    for kl in spec.keyed_vals:
        from gatekeeper_tpu_torch.rego.values import canon_num
        keys = []
        for c in constraints:
            k = _eval_host(kl.key_fn, c)
            if isinstance(k, (int, float)) and not isinstance(k, bool):
                k = canon_num(k)
            elif not isinstance(k, (str, bool)):
                k = None
            keys.append(k)
        needed = sorted({k for k in keys if k is not None}, key=repr)
        local = {k: i for i, k in enumerate(needed)}
        kv = cow(kl.name + ".kv")
        kv[:, dirty] = MISSING
        for di, o in zip(dirty, dirty_objs):
            if o is None:
                continue
            d = get_path(o, kl.path)
            if isinstance(d, dict):
                for k in needed:
                    if k in d:
                        ekey = encode_value(d[k])
                        if ekey is not None:
                            kv[local[k], di] = interner.intern(ekey)
            elif isinstance(d, list):
                for k in needed:
                    if isinstance(k, int) and not isinstance(k, bool) \
                            and 0 <= k < len(d):
                        ekey = encode_value(d[k])
                        if ekey is not None:
                            kv[local[k], di] = interner.intern(ekey)

    # ---- unary tables: evaluate fn only for ids never seen before
    for tr in spec.tables:
        src = out[tr.src]                     # id column (str/val mode)
        cand = np.unique(src[dirty].ravel())
        cand = cand[cand >= 0]
        evaluated = st0["tables"][tr.name]
        new_ids = [int(u) for u in cand.tolist() if u not in evaluated]
        t_pad = out[tr.name + ".ok"].shape[0]
        if new_ids and max(new_ids) >= t_pad:
            return None                      # interner outgrew the bucket
        if new_ids:
            ok = out[tr.name + ".ok"] = out[tr.name + ".ok"].copy()
            vals = out[tr.name + ".v"] = out[tr.name + ".v"].copy()
            append_only.update((tr.name + ".ok", tr.name + ".v"))
            id_rows = np.asarray(sorted(new_ids), dtype=np.int64)
            append_rows[tr.name + ".ok"] = id_rows
            append_rows[tr.name + ".v"] = id_rows
            if _regex_table_batch(tr, list(new_ids), interner, ok, vals):
                state["tables"][tr.name] = evaluated | set(new_ids)
                continue
            _ext_prefetch(tr, new_ids, interner)
            for uid in new_ids:
                key = interner.string(uid)
                arg = decode_value(key) if tr.src_val else key
                v = _eval_host(tr.fn, arg)
                if v is None:
                    continue
                if tr.out == "num":
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        ok[uid] = True
                        vals[uid] = np.float32(v)
                        f32_unsafe = f32_unsafe or not _f32_exact([v])
                elif tr.out == "id_str":
                    if isinstance(v, str):
                        ok[uid] = True
                        vals[uid] = interner.intern(v)
                elif tr.out == "id_val":
                    ekey = encode_value(v)
                    if ekey is not None:
                        ok[uid] = True
                        vals[uid] = interner.intern(ekey)
                else:
                    ok[uid] = True
                    vals[uid] = bool(v) if isinstance(v, bool) else True
        state["tables"][tr.name] = evaluated | set(new_ids)

    # ---- parametric tables: new distinct values get new dense slots
    for pt in spec.ptables:
        pst = st0["ptables"][pt.name]
        src = out[pt.src]
        cand = np.unique(src[dirty].ravel())
        cand = cand[cand >= 0]
        u_of = pst["u_of"]
        new_ids = [int(g) for g in cand.tolist() if g not in u_of]
        vmap_arr = out[pt.name + ".vmap"]
        t_pad = vmap_arr.shape[0]
        u_pad = out[pt.name + ".any"].shape[1]
        if new_ids and (max(new_ids) >= t_pad
                        or len(u_of) + len(new_ids) > u_pad - 1):
            return None                      # value-slot bucket outgrown
        if new_ids:
            u_of = dict(u_of)
            vmap_arr = out[pt.name + ".vmap"] = vmap_arr.copy()
            tbl = pst["tbl"].copy()           # already [n_distinct, u_pad]
            t_any = out[pt.name + ".any"] = out[pt.name + ".any"].copy()
            t_all = out[pt.name + ".all"] = out[pt.name + ".all"].copy()
            append_only.update((pt.name + ".vmap", pt.name + ".any",
                                pt.name + ".all"))
            # .vmap appends id-axis rows; .any/.all grow along the
            # value-slot axis and stay whole-upload (they are [C, u_pad])
            append_rows[pt.name + ".vmap"] = \
                np.asarray(sorted(new_ids), dtype=np.int64)
            distinct = pst["distinct"]
            for gid in new_ids:
                u = len(u_of)
                u_of[gid] = u
                vmap_arr[gid] = u
                key = interner.string(gid)
                arg = decode_value(key) if pt.src_val else key
                col = np.zeros((len(distinct),), dtype=bool)
                for pstr, pi in distinct.items():
                    v = _eval_host(pt.fn, arg, pstr)
                    col[pi] = bool(v) if v is not None and v is not False else False
                if tbl.shape[0]:
                    tbl[:, u] = col
                for ci, lst in enumerate(pst["per_con"]):
                    if lst:
                        t_any[ci, u] = col[lst].any()
                        t_all[ci, u] = col[lst].all()
                    else:
                        t_all[ci, u] = True
            pst = {"u_of": u_of, "distinct": pst["distinct"],
                   "per_con": pst["per_con"], "tbl": tbl}
        state["ptables"][pt.name] = pst

    # ---- membership matrices / element-key membership: refill dirty
    memb_by_cset = {m.cset: m for m in spec.membs}
    ekeys_by_cset = {e.cset: e for e in spec.elem_keys}
    axis_base = dict(spec.axes)
    for cs in spec.csets:
        cstate = st0["csets"][cs.name]
        needed, local = cstate["needed"], cstate["local"]
        m = memb_by_cset.get(cs.name)
        ek = ekeys_by_cset.get(cs.name)
        if m is not None:
            memb = cow(m.name)
            memb[:, dirty] = False
            if needed:
                sub = np.zeros((memb.shape[0], len(dirty)), dtype=bool)
                _fill_membership(sub, dirty_objs, m.keys_path, needed, local,
                                 interner)
                memb[:, dirty] = sub
        if ek is not None:
            ekm = cow(ek.name)
            ekm[:, dirty, :] = False
            e_pad = prev.e_pads[ek.axis]
            str_local: dict = {}
            int_local: dict = {}
            for gid in needed:
                ks = interner.string(gid)
                k = decode_value(ks) if ks.startswith("\x00") else ks
                if isinstance(k, str):
                    str_local[k] = local[gid]
                elif isinstance(k, int) and not isinstance(k, bool):
                    int_local[k] = local[gid]
            base_path = axis_base[ek.axis]
            for di, o in zip(dirty, dirty_objs):
                if o is None:
                    continue
                for ei, elem in enumerate(_elem_rows(o, base_path)):
                    if ei >= e_pad:
                        continue
                    if isinstance(elem, dict):
                        for k, li in str_local.items():
                            if k in elem and elem[k] is not False:
                                ekm[li, di, ei] = True
                    elif isinstance(elem, list):
                        for k, li in int_local.items():
                            if 0 <= k < len(elem) and elem[k] is not False:
                                ekm[li, di, ei] = True

    # ---- inventory joins: cross-row, so recompute and DIFF — the true
    # dirty set (rows whose join verdict changed) can exceed the table's
    # dirty rows (an upsert elsewhere flips this row's duplicate status)
    for ij in spec.inv_joins:
        new_col = build_inv_join(ij, table, r_pad)
        prev_col = prev.arrays[ij.name]
        changed = np.nonzero(new_col != prev_col)[0]
        if len(changed):
            out[ij.name] = new_col
            base_dirty[ij.name] = changed

    # ---- in-program regex DFAs: append byte rows + fallback verdicts
    # for ids interned since prev (existing rows never change, so the
    # row-sliced delta plan stays sound — append_only, not base_dirty).
    # Runs LAST among the interning sections for the same reason the
    # full build does: the byte matrix must cover the final interner.
    if spec.dfas:
        old_sz = st0.get("dfa_size", 0)
        new_sz = len(interner)
        t_pad = out["__strdfaok__"].shape[0]
        if new_sz > t_pad:
            return None                  # interner outgrew the bucket
        if new_sz > old_sz:
            mat, lens = interner.bytes_table()
            sub_e, sub_p = _dfa_eligible(mat[old_sz:new_sz],
                                         lens[old_sz:new_sz],
                                         interner.max_str_len)
            sb = out["__strbytes__"] = out["__strbytes__"].copy()
            okv = out["__strdfaok__"] = out["__strdfaok__"].copy()
            sb[old_sz:new_sz] = mat[old_sz:new_sz]
            okv[old_sz:new_sz] = sub_e
            append_only.update(("__strbytes__", "__strdfaok__"))
            dfa_rows = np.arange(old_sz, new_sz, dtype=np.int64)
            append_rows["__strbytes__"] = dfa_rows
            append_rows["__strdfaok__"] = dfa_rows
            host_ids = old_sz + np.nonzero(sub_p & ~sub_e)[0]
            if len(host_ids):
                for dr in spec.dfas:
                    xv = out[dr.name + ".xv"] = out[dr.name + ".xv"].copy()
                    append_only.add(dr.name + ".xv")
                    append_rows[dr.name + ".xv"] = dfa_rows
                    _dfa_xv_fill(dr.pattern, interner, xv, host_ids)
        state["dfa_size"] = new_sz

    # validity: every table-indexed array must still cover the interner
    # (late interning past the bucket would alias clamped device gathers)
    if (spec.tables or spec.ptables or
            any(cs.name not in memb_by_cset and cs.name not in ekeys_by_cset
                for cs in spec.csets)):
        sized = [out[tr.name + ".ok"].shape[0] for tr in spec.tables]
        sized += [out[pt.name + ".vmap"].shape[0] for pt in spec.ptables]
        sized += [out[cs.name + ".vmap"].shape[0] for cs in spec.csets
                  if cs.name + ".vmap" in out]
        if sized and len(interner) > min(sized):
            return None
    state["interner_size"] = len(interner)

    return Bindings(arrays=out, n_constraints=prev.n_constraints,
                    n_resources=n, c_pad=c_pad, r_pad=r_pad,
                    e_pads=prev.e_pads, delta_state=state,
                    base=prev, base_dirty=base_dirty,
                    base_append_only=append_only,
                    base_append_rows=append_rows, f32_unsafe=f32_unsafe)


_META_FIELDS = {
    ("kind", "group"): "group_ids",
    ("kind", "version"): "version_ids",
    ("kind", "kind"): "kind_ids",
    ("name",): "name_ids",
    ("namespace",): "ns_ids",
}


def _meta_ids(table: ResourceTable, path: tuple[str, ...]) -> np.ndarray:
    """Review-metadata str columns from the cached identity arrays
    (make_review fields, reference target.go:69-107)."""
    ident = table.identity()
    if path == ("operation",):
        # audit reviews are always CREATE (target.go make_review)
        op = table.interner.intern("CREATE")
        ids = np.full((len(ident.alive),), MISSING, dtype=np.int32)
        ids[ident.alive] = op
        return ids
    attr = _META_FIELDS.get(path)
    if attr is None:
        raise KeyError(f"unsupported $meta path {path}")
    return getattr(ident, attr)


def _src_ids(out: dict[str, np.ndarray], src: str) -> np.ndarray:
    arr = out.get(src)
    if arr is None:
        raise KeyError(f"table src column {src!r} not built")
    return arr.ravel()


def _csr_to_dense_idx(counts: np.ndarray, offs: np.ndarray):
    """(row, slot) indices for scattering CSR entries into dense [R, E]."""
    total = int(offs[-1])
    idx_r = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    idx_e = np.arange(total, dtype=np.int64) - np.repeat(offs[:-1], counts)
    return idx_r, idx_e


def _fill_membership(memb: np.ndarray, objs: list, keys_path: tuple[str, ...],
                     needed: list[int], local: dict[int, int],
                     interner: Interner) -> None:
    """memb[local_id, row] = key present in the dict at keys_path."""
    if not needed:
        return
    from gatekeeper_tpu_torch import native
    if native.available:
        native.memb_fill(objs, keys_path, local, interner._ids,
                         memb, len(objs), memb.shape[0])
        return
    needed_set = set(needed)
    for row, o in enumerate(objs):
        if o is None:
            continue
        d = get_path(o, keys_path)
        if not isinstance(d, dict):
            continue
        for k, v in d.items():
            # value `false` is excluded: the oracle's comprehension
            # statement `labels[k]` fails on a false value (is_truthy)
            if isinstance(k, str) and v is not False:
                gid = interner.lookup(k)
                if gid in needed_set:
                    memb[local[gid], row] = True
