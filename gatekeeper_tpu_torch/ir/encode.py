# Copied from gatekeeper_tpu/ir/encode.py for the PyTorch port.
"""Value encoding for variant ("val") columns.

Rego values are dynamically typed: a field may hold a string, number,
bool, null, or a compound (array/object/set), and equality is type-aware
(interp._compare/_same_kind — ``1 != true``, ``5 != "5"``).  Device
columns are int32 ids, so values are encoded into a reserved namespace
of the global string interner: two values get the same id iff they are
Rego-equal.  Raw string columns (label keys, kinds) intern strings
directly; the "\x00" prefix guarantees the namespaces never collide
(k8s strings are UTF-8 and never contain NUL).

Compounds use a canonical recursive serialization ("a:"/"o:"/"t:"
tags): children are netstring-framed (length-prefixed, no escaping),
object pairs and set elements are sorted by their serialized form —
serialization is injective, so two compounds serialize identically iff
they are Rego-equal, and equality over ids stays exact for arrays,
objects, and sets (e.g. ``spec.sel == parameters.sel`` with list
values, which a scalar-only encoding would leave permanently
undefined).
"""

from __future__ import annotations

from typing import Any

from gatekeeper_tpu_torch.rego.values import Obj, canon_num, freeze

_P = "\x00"


def _net(s: str) -> str:
    """Netstring framing: unambiguous concatenation of child strings."""
    return f"{len(s)}:{s},"


def _split_net(s: str) -> list[str]:
    out = []
    i = 0
    while i < len(s):
        j = s.index(":", i)
        n = int(s[i:j])
        out.append(s[j + 1: j + 1 + n])
        if s[j + 1 + n] != ",":
            raise ValueError(f"bad netstring framing at {j + 1 + n}")
        i = j + 2 + n
    return out


def _ser(v: Any) -> str:
    """Canonical serialization of a frozen value (values.freeze form)."""
    if isinstance(v, bool):
        return "b:1" if v else "b:0"
    if isinstance(v, str):
        return "s:" + v
    if isinstance(v, (int, float)):
        return "n:" + repr(canon_num(v))
    if v is None:
        return "z"
    if isinstance(v, tuple):
        return "a:" + "".join(_net(_ser(x)) for x in v)
    if isinstance(v, Obj):
        pairs = sorted((_ser(k), _ser(val)) for k, val in v.items())
        return "o:" + "".join(_net(ks) + _net(vs) for ks, vs in pairs)
    if isinstance(v, frozenset):
        return "t:" + "".join(_net(e) for e in sorted(_ser(x) for x in v))
    raise TypeError(f"cannot serialize {type(v).__name__}")


def _deser(s: str) -> Any:
    """Inverse of _ser; returns the frozen form."""
    if s == "z":
        return None
    tag = s[:2]
    if tag == "b:":
        return s == "b:1"
    if tag == "s:":
        return s[2:]
    if tag == "n:":
        text = s[2:]
        return float(text) if "." in text or "e" in text or "E" in text \
            else int(text)
    if tag == "a:":
        return tuple(_deser(x) for x in _split_net(s[2:]))
    if tag == "o:":
        parts = _split_net(s[2:])
        return Obj((_deser(parts[i]), _deser(parts[i + 1]))
                   for i in range(0, len(parts), 2))
    if tag == "t:":
        return frozenset(_deser(x) for x in _split_net(s[2:]))
    raise ValueError(f"bad serialized value: {s!r}")


def encode_value(v: Any) -> str | None:
    """Value -> interner key; None only for non-JSON-able values."""
    try:
        return _P + _ser(freeze(v))
    except TypeError:
        return None


def decode_value(key: str) -> Any:
    """Inverse of encode_value (table construction calls the user fn on the
    decoded value; compounds come back in frozen form, which the scalar
    oracle's freeze() accepts unchanged)."""
    if not key.startswith(_P):
        raise ValueError(f"not an encoded value: {key!r}")
    try:
        return _deser(key[1:])
    except (ValueError, IndexError) as e:
        raise ValueError(f"bad encoded value: {key!r}") from e
