# Copied from gatekeeper_tpu/rego/values.py for the PyTorch port.
"""Canonical (hashable) runtime value representation for the interpreter.

Rego values are JSON values plus sets.  The interpreter needs values to be
hashable (set members, object keys, dedup of partial-set results), so we
"freeze" Python JSON structures into immutable forms:

- null/bool/str        -> as-is
- numbers              -> int when integral, else float (Rego has one
                          `number` type; OPA preserves 1 vs 1.0 only
                          cosmetically)
- array                -> tuple
- object               -> Obj (an immutable, hashable mapping)
- set                  -> frozenset

`freeze`/`thaw` convert at the JSON boundary; sets thaw to sorted lists the
way OPA marshals sets to JSON arrays.

Known divergence from OPA: Python hashes True==1, so a set cannot hold both
`true` and `1` as distinct members (likewise object keys).  Scalar
comparisons and unification DO distinguish bool from number (see
interp._same_kind); only mixed bool/number *collection membership* is
affected, which no known ConstraintTemplate exercises.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Mapping


class Obj(Mapping):
    """Immutable hashable mapping with insertion-order-independent equality."""

    __slots__ = ("_d", "_hash")

    def __init__(self, items: Iterable[tuple[Any, Any]] | Mapping | None = None):
        d = {} if items is None else dict(items)
        object.__setattr__(self, "_d", d)
        object.__setattr__(self, "_hash", None)

    def __getitem__(self, k):
        return self._d[k]

    def __contains__(self, k) -> bool:
        # Mapping's default __contains__ probes via __getitem__ +
        # exception handling — measurably hot on the admission path
        return k in self._d

    def items(self):
        return self._d.items()

    def keys(self):
        return self._d.keys()

    def values(self):
        return self._d.values()

    def get(self, k, default=None):
        return self._d.get(k, default)

    def __iter__(self) -> Iterator:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __hash__(self) -> int:
        h = self._hash
        if h is None:
            h = hash(frozenset(self._d.items()))
            object.__setattr__(self, "_hash", h)
        return h

    def __eq__(self, other) -> bool:
        if isinstance(other, Obj):
            return self._d == other._d
        if isinstance(other, Mapping):
            return self._d == dict(other)
        return NotImplemented

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Obj({self._d!r})"

    def set(self, k, v) -> "Obj":
        d = dict(self._d)
        d[k] = v
        return Obj(d)

    def without(self, k) -> "Obj":
        d = dict(self._d)
        d.pop(k, None)
        return Obj(d)


EMPTY_OBJ = Obj()


def canon_num(x):
    """Collapse integral floats to int so 2.0 == 2 hashes identically."""
    if isinstance(x, bool):
        return x
    if isinstance(x, float) and x.is_integer() and abs(x) < 2**53:
        return int(x)
    return x


def freeze(v: Any) -> Any:
    """JSON-ish Python value -> canonical immutable value."""
    t = v.__class__
    if t is str or t is bool or v is None:
        return v
    if t is int:
        return v
    if t is float:
        return canon_num(v)
    if t is dict:
        return Obj({freeze(k): freeze(val) for k, val in v.items()})
    if t is list or t is tuple:
        return tuple(freeze(x) for x in v)
    if t is Obj:
        return v
    # subclass / abstract fallbacks
    if isinstance(v, (str, bool)):
        return v
    if isinstance(v, (int, float)):
        return canon_num(v)
    if isinstance(v, (list, tuple)):
        return tuple(freeze(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return frozenset(freeze(x) for x in v)
    if isinstance(v, Obj):
        return v
    if isinstance(v, Mapping):
        return Obj({freeze(k): freeze(val) for k, val in v.items()})
    raise TypeError(f"cannot freeze value of type {type(v).__name__}: {v!r}")


def _sort_key(v: Any):
    """Total order over heterogeneous frozen values (OPA's value ordering:
    null < bool < number < string < array < object < set)."""
    if v is None:
        return (0,)
    if isinstance(v, bool):
        return (1, v)
    if isinstance(v, (int, float)):
        return (2, v)
    if isinstance(v, str):
        return (3, v)
    if isinstance(v, tuple):
        return (4, tuple(_sort_key(x) for x in v))
    if isinstance(v, Obj):
        return (5, tuple(sorted((_sort_key(k), _sort_key(val)) for k, val in v.items())))
    if isinstance(v, frozenset):
        return (6, tuple(sorted(_sort_key(x) for x in v)))
    return (7, repr(v))


def sorted_values(vals: Iterable[Any]) -> list:
    return sorted(vals, key=_sort_key)


def thaw(v: Any) -> Any:
    """Canonical value -> plain JSON Python value (sets become sorted lists,
    matching OPA's JSON marshalling of sets)."""
    if isinstance(v, tuple):
        return [thaw(x) for x in v]
    if isinstance(v, frozenset):
        return [thaw(x) for x in sorted_values(v)]
    if isinstance(v, Obj):
        return {thaw(k): thaw(val) for k, val in v.items()}
    return v


def is_truthy(v: Any) -> bool:
    """Rego statement truthiness: only `false` fails; everything defined and
    non-false (including 0, "", empty collections) succeeds."""
    return v is not False
