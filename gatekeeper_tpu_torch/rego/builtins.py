# Copied from gatekeeper_tpu/rego/builtins.py for the PyTorch port.
"""Scalar builtin registry.

The reference embeds 103 OPA builtins (vendor opa/topdown/*.go); real
ConstraintTemplates exercise a few dozen.  This registry implements that
working set with OPA semantics: builtin *errors* (bad types, unparsable
numbers) make the expression undefined rather than failing the query, which
templates rely on (e.g. k8scontainerlimits uses `not canonify_cpu(x)` to
detect unparsable limits).

Formatting matches OPA: `sprintf` renders composite values in Rego syntax
(sets as {"a"}, arrays as ["a"]), which is what Gatekeeper's violation
messages contain.
"""

from __future__ import annotations

import json
import math
import re as _re
from typing import Any, Callable

from gatekeeper_tpu_torch.rego.values import Obj, canon_num, freeze, sorted_values

UNDEFINED = object()  # sentinel: builtin produced no value


class BuiltinError(Exception):
    """Raised by builtins on type/value errors; evaluator maps to undefined."""


def rego_repr(v: Any, top: bool = False) -> str:
    """Render a value the way OPA's ast String()/sprintf %v does."""
    if v is None:
        return "null"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, str):
        return v if top else json.dumps(v)
    if isinstance(v, (int, float)):
        return _num_repr(v)
    if isinstance(v, tuple):
        return "[" + ", ".join(rego_repr(x) for x in v) + "]"
    if isinstance(v, frozenset):
        if not v:
            return "set()"
        return "{" + ", ".join(rego_repr(x) for x in sorted_values(v)) + "}"
    if isinstance(v, Obj):
        return "{" + ", ".join(f"{rego_repr(k)}: {rego_repr(val)}" for k, val in v.items()) + "}"
    raise BuiltinError(f"unprintable value {v!r}")


def _num_repr(x) -> str:
    if isinstance(x, int):
        return str(x)
    # Go %v for float64 is %g-like
    s = repr(x)
    return s


def _need_string(x, op: str) -> str:
    if not isinstance(x, str):
        raise BuiltinError(f"{op}: operand must be string, got {type(x).__name__}")
    return x


def _need_number(x, op: str):
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        raise BuiltinError(f"{op}: operand must be number, got {type(x).__name__}")
    return x


def _need_collection(x, op: str):
    if isinstance(x, (tuple, frozenset, Obj, str)):
        return x
    raise BuiltinError(f"{op}: operand must be a collection or string")


def _need_set(x, op: str):
    if not isinstance(x, frozenset):
        raise BuiltinError(f"{op}: operand must be set")
    return x


def _need_array(x, op: str):
    if not isinstance(x, tuple):
        raise BuiltinError(f"{op}: operand must be array")
    return x


# --- regex (Go RE2 syntax ~ Python re for the common subset) ---

_RE_CACHE: dict[str, "_re.Pattern[str]"] = {}


def compile_go_regex(pattern: str) -> "_re.Pattern[str]":
    pat = _RE_CACHE.get(pattern)
    if pat is None:
        try:
            pat = _re.compile(pattern)
        except _re.error as e:
            raise BuiltinError(f"invalid regex {pattern!r}: {e}")
        _RE_CACHE[pattern] = pat
    return pat


def _re_match(pattern, value):
    p = compile_go_regex(_need_string(pattern, "re_match"))
    return p.search(_need_string(value, "re_match")) is not None


# --- glob (github.com/gobwas/glob semantics, as vendored by OPA) ---

def _glob_to_regex(pattern: str, delims: tuple[str, ...]) -> str:
    """Translate a glob to a regex: `*` matches any run NOT crossing a
    delimiter, `**` crosses them, `?` is one non-delimiter char, `[...]`
    char classes and `{a,b}` alternates pass through."""
    delim_cls = "".join(_re.escape(d) for d in delims)
    single = f"[^{delim_cls}]" if delim_cls else "."
    out = []
    i, n = 0, len(pattern)
    while i < n:
        c = pattern[i]
        if c == "*":
            if i + 1 < n and pattern[i + 1] == "*":
                out.append(".*")
                i += 2
            else:
                out.append(f"{single}*")
                i += 1
        elif c == "?":
            out.append(single)
            i += 1
        elif c == "[":
            j = i + 1
            if j < n and pattern[j] in "!^":
                j += 1
            if j < n and pattern[j] == "]":
                j += 1
            while j < n and pattern[j] != "]":
                j += 1
            if j >= n:
                out.append(_re.escape(c))
                i += 1
            else:
                cls = pattern[i + 1 : j]
                if cls.startswith("!"):
                    cls = "^" + cls[1:]
                out.append(f"[{cls}]")
                i = j + 1
        elif c == "{":
            j = pattern.find("}", i)
            if j < 0:
                out.append(_re.escape(c))
                i += 1
            else:
                alts = pattern[i + 1 : j].split(",")
                out.append("(?:" + "|".join(
                    _glob_to_regex(a, delims)[2:-2] or "" for a in alts) + ")")
                i = j + 1
        else:
            out.append(_re.escape(c))
            i += 1
    return r"\A" + "".join(out) + r"\Z"


def _glob_match(pattern, delimiters, value):
    pat = _need_string(pattern, "glob.match")
    val = _need_string(value, "glob.match")
    if delimiters is None:
        delims: tuple[str, ...] = (".",)
    elif isinstance(delimiters, tuple):
        delims = tuple(_need_string(d, "glob.match") for d in delimiters)
        if not delims:
            delims = ()
    else:
        raise BuiltinError("glob.match: delimiters must be array or null")
    key = ("glob", pat, delims)
    rx = _RE_CACHE.get(key)  # type: ignore[arg-type]
    if rx is None:
        try:
            rx = _re.compile(_glob_to_regex(pat, delims))
        except _re.error as e:
            raise BuiltinError(f"glob.match: bad pattern {pat!r}: {e}")
        _RE_CACHE[key] = rx  # type: ignore[index]
    return rx.match(val) is not None


# --- sprintf ---

_VERB = _re.compile(r"%[-+# 0]*\d*(?:\.\d+)?[vdsfgtexXoqb%]")


_FMT_CACHE: dict = {}
"""fmt -> [(literal segment, verb | None), ...] — violation messages
re-use a handful of format strings across millions of pairs; parsing
the verbs once per distinct string, not per call, is a measured ~10%
of the scalar admission path."""


def _fmt_segments(fmt: str):
    segs = _FMT_CACHE.get(fmt)
    if segs is None:
        segs = []
        pos = 0
        for m in _VERB.finditer(fmt):
            segs.append((fmt[pos: m.start()], m.group(0)))
            pos = m.end()
        segs.append((fmt[pos:], None))
        if len(_FMT_CACHE) < 4096:
            _FMT_CACHE[fmt] = segs
    return segs


def opa_sprintf(fmt: str, args) -> str:
    fmt = _need_string(fmt, "sprintf")
    arglist = list(_need_array(args, "sprintf"))
    out = []
    idx = 0
    for lit, verb in _fmt_segments(fmt):
        if lit:
            out.append(lit)
        if verb is None:
            continue
        kind = verb[-1]
        if kind == "%":
            out.append("%")
            continue
        if idx >= len(arglist):
            out.append(f"%!{kind}(MISSING)")
            continue
        a = arglist[idx]
        idx += 1
        if kind == "v":
            out.append(rego_repr(a, top=True))
        elif kind in "dxXob":
            try:
                iv = int(a)
            except (TypeError, ValueError):
                out.append(f"%!{kind}({a!r})")
                continue
            base = {"d": "d", "x": "x", "X": "X", "o": "o", "b": "b"}[kind]
            out.append(format(iv, base))
        elif kind in "fge":
            try:
                out.append(verb.replace("v", kind) % float(a))
            except (TypeError, ValueError):
                out.append(f"%!{kind}({a!r})")
        elif kind == "s":
            out.append(a if isinstance(a, str) else rego_repr(a, top=True))
        elif kind == "q":
            out.append(json.dumps(a if isinstance(a, str) else rego_repr(a, top=True)))
        elif kind == "t":
            out.append("true" if a is True else "false" if a is False else f"%!t({a!r})")
    return "".join(out)


# --- numbers ---

def _to_number(x):
    if isinstance(x, bool):
        return 1 if x else 0
    if isinstance(x, (int, float)):
        return x
    if x is None:
        return 0
    if isinstance(x, str):
        try:
            return canon_num(json.loads(x)) if _NUMRE.match(x) else _raise_num(x)
        except (json.JSONDecodeError, ValueError):
            raise BuiltinError(f"to_number: cannot parse {x!r}")
    raise BuiltinError(f"to_number: bad operand {x!r}")


_NUMRE = _re.compile(r"^-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][-+]?[0-9]+)?$")


def _raise_num(x):
    raise BuiltinError(f"to_number: cannot parse {x!r}")


def _count(x):
    c = _need_collection(x, "count")
    return len(c)


def _sum(x):
    if isinstance(x, (tuple, frozenset)):
        total = 0
        for v in x:
            total += _need_number(v, "sum")
        return canon_num(total)
    raise BuiltinError("sum: operand must be array or set")


def _product(x):
    if isinstance(x, (tuple, frozenset)):
        total = 1
        for v in x:
            total *= _need_number(v, "product")
        return canon_num(total)
    raise BuiltinError("product: operand must be array or set")


def _max(x):
    if isinstance(x, (tuple, frozenset)) and len(x):
        return sorted_values(x)[-1]
    raise BuiltinError("max: empty or non-collection")


def _min(x):
    if isinstance(x, (tuple, frozenset)) and len(x):
        return sorted_values(x)[0]
    raise BuiltinError("min: empty or non-collection")


def _abs(x):
    return canon_num(abs(_need_number(x, "abs")))


def _round(x):
    # Go math.Round: half away from zero (floor(x+0.5) would send -0.5 to 0)
    v = _need_number(x, "round")
    return int(math.floor(v + 0.5)) if v >= 0 else int(math.ceil(v - 0.5))


def _ceil(x):
    return int(math.ceil(_need_number(x, "ceil")))


def _floor(x):
    return int(math.floor(_need_number(x, "floor")))


# --- strings ---

def _concat(delim, coll):
    d = _need_string(delim, "concat")
    if isinstance(coll, tuple):
        items = list(coll)
    elif isinstance(coll, frozenset):
        items = sorted_values(coll)
    else:
        raise BuiltinError("concat: operand must be array or set")
    for i in items:
        _need_string(i, "concat")
    return d.join(items)


def _split(s, delim):
    return tuple(_need_string(s, "split").split(_need_string(delim, "split")))


def _substring(s, start, length):
    s = _need_string(s, "substring")
    start = int(_need_number(start, "substring"))
    length = int(_need_number(length, "substring"))
    if start < 0:
        raise BuiltinError("substring: negative start")
    if start >= len(s):
        return ""
    if length < 0:
        return s[start:]
    return s[start : start + length]


def _trim(s, cutset):
    return _need_string(s, "trim").strip(_need_string(cutset, "trim"))


def _indexof(s, sub):
    return _need_string(s, "indexof").find(_need_string(sub, "indexof"))


def _format_int(x, base):
    return format(int(_need_number(x, "format_int")), {2: "b", 8: "o", 10: "d", 16: "x"}[int(base)])


# --- aggregates over bools ---

def _all(x):
    if isinstance(x, (tuple, frozenset)):
        return all(v is True for v in x)
    raise BuiltinError("all: operand must be array or set")


def _any(x):
    if isinstance(x, (tuple, frozenset)):
        return any(v is True for v in x)
    raise BuiltinError("any: operand must be array or set")


# --- sets/arrays/objects ---

def _sort(x):
    if isinstance(x, (tuple, frozenset)):
        return tuple(sorted_values(x))
    raise BuiltinError("sort: operand must be array or set")


def _array_concat(a, b):
    return _need_array(a, "array.concat") + _need_array(b, "array.concat")


def _array_slice(a, lo, hi):
    arr = _need_array(a, "array.slice")
    lo = max(0, int(_need_number(lo, "array.slice")))
    hi = min(len(arr), int(_need_number(hi, "array.slice")))
    return arr[lo:hi] if lo < hi else ()


def _intersection(sets):
    ss = _need_set(sets, "intersection")
    result = None
    for s in ss:
        s = _need_set(s, "intersection")
        result = s if result is None else result & s
    return result if result is not None else frozenset()


def _union(sets):
    ss = _need_set(sets, "union")
    result = frozenset()
    for s in ss:
        result |= _need_set(s, "union")
    return result


def _object_get(obj, key, default):
    if not isinstance(obj, Obj):
        raise BuiltinError("object.get: operand must be object")
    if isinstance(key, tuple):
        # OPA >= 0.34 (topdown/object.go builtinObjectGet): an array key
        # is a path walked element-by-element, with `default` on any miss
        cur = obj
        for k in key:
            if isinstance(cur, Obj) and k in cur:
                cur = cur[k]
            elif isinstance(cur, tuple) and isinstance(k, (int, float)) \
                    and not isinstance(k, bool) and int(k) == k \
                    and 0 <= int(k) < len(cur):
                cur = cur[int(k)]
            else:
                return default
        return cur
    return obj[key] if key in obj else default


def _cast_array(x):
    if isinstance(x, tuple):
        return x
    if isinstance(x, frozenset):
        return tuple(sorted_values(x))
    raise BuiltinError("cast_array: operand must be array or set")


def _cast_set(x):
    if isinstance(x, frozenset):
        return x
    if isinstance(x, tuple):
        return frozenset(x)
    raise BuiltinError("cast_set: operand must be array or set")


def _to_set_members(x):
    """Members iterable for set(x) style coercions."""
    if isinstance(x, (tuple, frozenset)):
        return x
    raise BuiltinError("expected array or set")


# --- json ---

def _json_marshal(x):
    from gatekeeper_tpu_torch.rego.values import thaw

    # OPA (Go) marshals object keys sorted
    return json.dumps(thaw(x), separators=(",", ":"), sort_keys=True)


def _json_unmarshal(s):
    try:
        return freeze(json.loads(_need_string(s, "json.unmarshal")))
    except json.JSONDecodeError as e:
        raise BuiltinError(f"json.unmarshal: {e}")


# --- type checks ---

def _is_number(x):
    return not isinstance(x, bool) and isinstance(x, (int, float))


_BIN_UNITS = {"ki": 2**10, "mi": 2**20, "gi": 2**30, "ti": 2**40,
              "pi": 2**50, "ei": 2**60}
_DEC_UNITS = {"": 1, "k": 10**3, "m": 10**6, "g": 10**9, "t": 10**12,
              "p": 10**15, "e": 10**18}
_MILLI_UNITS = {"m": 0.001}


def _units_parse_bytes(s):
    """units.parse_bytes: k8s-style byte quantities ("1Gi", "512Mi",
    "128974848", "1G"); case-insensitive suffix, optional trailing "b"
    (vendor opa/topdown/parse_bytes.go semantics)."""
    raw = _need_string(s, "units.parse_bytes").strip().strip('"')
    low = raw.lower()
    i = len(low)
    while i > 0 and (low[i - 1].isalpha()):
        i -= 1
    num, suffix = low[:i], low[i:]
    if suffix.endswith("b"):
        suffix = suffix[:-1]
    if not num:
        raise BuiltinError(f"units.parse_bytes: no amount in {raw!r}")
    mult = _BIN_UNITS.get(suffix)
    if mult is None:
        mult = _DEC_UNITS.get(suffix)
    if mult is None:
        raise BuiltinError(f"units.parse_bytes: unknown unit {suffix!r}")
    try:
        val = float(num)
    except ValueError:
        raise BuiltinError(f"units.parse_bytes: bad number {num!r}")
    return canon_num(val * mult)


def _units_parse(s):
    """units.parse: like parse_bytes plus lowercase milli ("200m") and
    decimal units; binary suffixes allowed (vendor opa/topdown/parse.go)."""
    raw = _need_string(s, "units.parse").strip().strip('"')
    i = len(raw)
    while i > 0 and raw[i - 1].isalpha():
        i -= 1
    num, suffix = raw[:i], raw[i:]
    if not num:
        raise BuiltinError(f"units.parse: no amount in {raw!r}")
    mult = _MILLI_UNITS.get(suffix)
    if mult is None:
        mult = _BIN_UNITS.get(suffix.lower())
    if mult is None:
        # decimal units: K and k both 10^3; M is mega here (unlike milli)
        mult = _DEC_UNITS.get(suffix.lower())
    if mult is None:
        raise BuiltinError(f"units.parse: unknown unit {suffix!r}")
    try:
        val = float(num)
    except ValueError:
        raise BuiltinError(f"units.parse: bad number {num!r}")
    return canon_num(val * mult)


def _object_union(a, b):
    if not isinstance(a, Obj) or not isinstance(b, Obj):
        raise BuiltinError("object.union: operands must be objects")
    d = dict(a.items())
    d.update(b.items())
    return Obj(d)


def _object_remove(obj, keys):
    if not isinstance(obj, Obj):
        raise BuiltinError("object.remove: operand must be object")
    if isinstance(keys, (tuple, frozenset)):
        drop = set(keys)
    elif isinstance(keys, Obj):
        drop = set(keys)
    else:
        raise BuiltinError("object.remove: keys must be array/set/object")
    return Obj({k: v for k, v in obj.items() if k not in drop})


def _object_filter(obj, keys):
    if not isinstance(obj, Obj):
        raise BuiltinError("object.filter: operand must be object")
    if isinstance(keys, (tuple, frozenset)):
        keep = set(keys)
    elif isinstance(keys, Obj):
        keep = set(keys)
    else:
        raise BuiltinError("object.filter: keys must be array/set/object")
    return Obj({k: v for k, v in obj.items() if k in keep})


def _base64_encode(s):
    import base64
    return base64.b64encode(_need_string(s, "base64.encode").encode()).decode()


def _base64_decode(s):
    import base64
    try:
        return base64.b64decode(_need_string(s, "base64.decode"),
                                validate=True).decode()
    except Exception as e:
        raise BuiltinError(f"base64.decode: {e}")


def _base64url_encode(s):
    import base64
    return base64.urlsafe_b64encode(
        _need_string(s, "base64url.encode").encode()).decode()


def _base64url_decode(s):
    import base64
    try:
        return base64.urlsafe_b64decode(
            _need_string(s, "base64url.decode")).decode()
    except Exception as e:
        raise BuiltinError(f"base64url.decode: {e}")


def _numbers_range(a, b):
    if not isinstance(a, int) or not isinstance(b, int) or \
            isinstance(a, bool) or isinstance(b, bool):
        raise BuiltinError("numbers.range: operands must be integers")
    step = 1 if b >= a else -1
    return tuple(range(a, b + step, step))


def _regex_split(pattern, s):
    p = compile_go_regex(_need_string(pattern, "regex.split"))
    return tuple(p.split(_need_string(s, "regex.split")))


def walk_pairs(x):
    """All (path, value) pairs of a document, OPA walk() order
    (vendor opa/topdown/walk.go): the node itself first, then children."""
    out = []

    def rec(path, v):
        out.append((tuple(path), v))
        if isinstance(v, Obj):
            for k, val in v.items():
                rec(path + [k], val)
        elif isinstance(v, tuple):
            for i, val in enumerate(v):
                rec(path + [i], val)
        elif isinstance(v, frozenset):
            for m in sorted_values(v):
                rec(path + [m], m)
    rec([], x)
    return out


def _crypto_md5(s):
    import hashlib
    return hashlib.md5(_need_string(s, "crypto.md5").encode()).hexdigest()


def _crypto_sha1(s):
    import hashlib
    return hashlib.sha1(_need_string(s, "crypto.sha1").encode()).hexdigest()


def _crypto_sha256(s):
    import hashlib
    return hashlib.sha256(_need_string(s, "crypto.sha256").encode()).hexdigest()


def _net_cidr_contains(cidr, ip):
    import ipaddress
    try:
        net = ipaddress.ip_network(_need_string(cidr, "net.cidr_contains"),
                                   strict=False)
        addr = _need_string(ip, "net.cidr_contains")
        if "/" in addr:
            sub = ipaddress.ip_network(addr, strict=False)
            return sub.subnet_of(net)
        return ipaddress.ip_address(addr) in net
    except (ValueError, TypeError) as e:   # TypeError: mixed IP versions
        raise BuiltinError(f"net.cidr_contains: {e}")


def _net_cidr_intersects(a, b):
    import ipaddress
    try:
        na = ipaddress.ip_network(_need_string(a, "net.cidr_intersects"),
                                  strict=False)
        nb = ipaddress.ip_network(_need_string(b, "net.cidr_intersects"),
                                  strict=False)
        return na.overlaps(nb)
    except (ValueError, TypeError) as e:
        raise BuiltinError(f"net.cidr_intersects: {e}")


_NUM = r"(?:0|[1-9]\d*)"
_PRE_ID = r"(?:0|[1-9]\d*|\d*[A-Za-z-][0-9A-Za-z-]*)"
_SEMVER_RE = _re.compile(
    rf"^({_NUM})\.({_NUM})\.({_NUM})"
    rf"(?:-({_PRE_ID}(?:\.{_PRE_ID})*))?"
    r"(?:\+[0-9A-Za-z-]+(?:\.[0-9A-Za-z-]+)*)?$")


def _semver_parse(s):
    m = _SEMVER_RE.match(_need_string(s, "semver"))
    if m is None:
        raise BuiltinError(f"semver: invalid version {s!r}")
    pre = m.group(4)
    pre_ids: tuple = ()
    if pre is not None:
        pre_ids = tuple((0, int(p)) if p.isdigit() else (1, p)
                        for p in pre.split("."))
    return (int(m.group(1)), int(m.group(2)), int(m.group(3)),
            pre is None, pre_ids)


def _semver_compare(a, b):
    va, vb = _semver_parse(a), _semver_parse(b)
    if va[:3] != vb[:3]:
        return -1 if va[:3] < vb[:3] else 1
    # release > any pre-release of the same core
    if va[3] != vb[3]:
        return 1 if va[3] else -1
    if va[4] == vb[4]:
        return 0
    return -1 if va[4] < vb[4] else 1


def _semver_is_valid(s):
    return isinstance(s, str) and _SEMVER_RE.match(s) is not None


def _time_now_ns():
    import time as _time
    return _time.time_ns()


def _time_parse_rfc3339_ns(s):
    from datetime import datetime
    raw = _need_string(s, "time.parse_rfc3339_ns")
    iso = raw.replace("Z", "+00:00")
    # integer arithmetic: datetime holds microseconds, and
    # fromisoformat on Python < 3.11 rejects fractions longer than 6
    # digits outright — so split the fraction off the string and carry
    # it as integer nanoseconds ourselves
    ns_frac = 0
    if "." in iso:
        head, rest = iso.split(".", 1)
        i = 0
        while i < len(rest) and rest[i].isdigit():
            i += 1
        if i == 0:
            raise BuiltinError(
                f"time.parse_rfc3339_ns: empty fractional second in {raw!r}")
        ns_frac = int((rest[:i] + "000000000")[:9])
        iso = head + rest[i:]
    try:
        dt = datetime.fromisoformat(iso)
    except ValueError as e:
        raise BuiltinError(f"time.parse_rfc3339_ns: {e}")
    if dt.tzinfo is None:
        raise BuiltinError(
            f"time.parse_rfc3339_ns: missing timezone offset in {raw!r}")
    return int(dt.timestamp()) * 1_000_000_000 + ns_frac


def _ns_to_utc(ns, op):
    from datetime import datetime, timezone
    # integer seconds only: float division would round .999999999 up
    # into the next second/day, and float64 ULP at ~1.8e18 ns is ~256ns
    secs, _ = divmod(int(_need_number(ns, op)), 1_000_000_000)
    return datetime.fromtimestamp(secs, tz=timezone.utc)


def _time_date(ns):
    dt = _ns_to_utc(ns, "time.date")
    return (dt.year, dt.month, dt.day)


def _time_clock(ns):
    dt = _ns_to_utc(ns, "time.clock")
    return (dt.hour, dt.minute, dt.second)


def _strings_replace_n(patterns, s):
    """Single left-to-right pass (Go strings.NewReplacer semantics):
    replaced text is never re-scanned; patterns try in sorted-key order
    at each position."""
    text = _need_string(s, "strings.replace_n")
    if not isinstance(patterns, Obj):
        raise BuiltinError("strings.replace_n: patterns must be object")
    pairs = []
    for old in sorted(patterns, key=str):
        pairs.append((_need_string(old, "strings.replace_n"),
                      _need_string(patterns[old], "strings.replace_n")))
    out = []
    i = 0
    while i < len(text):
        for old, new in pairs:
            if old and text.startswith(old, i):
                out.append(new)
                i += len(old)
                break
        else:
            out.append(text[i])
            i += 1
    return "".join(out)


def _regex_is_valid(p):
    if not isinstance(p, str):
        return False
    try:
        compile_go_regex(p)
        return True
    except BuiltinError:
        return False


def _regex_find_n(pattern, s, n):
    p = compile_go_regex(_need_string(pattern, "regex.find_n"))
    limit = int(_need_number(n, "regex.find_n"))
    out = [m.group(0) for m in p.finditer(_need_string(s, "regex.find_n"))]
    return tuple(out if limit < 0 else out[:limit])


def _yaml_marshal(v):
    import yaml as _yaml
    from gatekeeper_tpu_torch.rego.values import thaw
    return _yaml.safe_dump(thaw(v), default_flow_style=False)


def _yaml_unmarshal(s):
    import yaml as _yaml
    try:
        return freeze(_yaml.safe_load(_need_string(s, "yaml.unmarshal")))
    except (_yaml.YAMLError, TypeError) as e:
        # TypeError: YAML-native values with no Rego equivalent
        # (unquoted dates/timestamps/binary)
        raise BuiltinError(f"yaml.unmarshal: {e}")


# ---------------------------------------------------------------------------
# parity stragglers (SURVEY §2.3: the reference embeds 103 builtins;
# templates use a few dozen — these close the inventory)


def _cast_string(x):
    if not isinstance(x, str):
        raise BuiltinError("cast_string: not a string")
    return x


def _cast_boolean(x):
    if not isinstance(x, bool):
        raise BuiltinError("cast_boolean: not a boolean")
    return x


def _cast_null(x):
    if x is not None:
        raise BuiltinError("cast_null: not null")
    return None


def _cast_object(x):
    if not isinstance(x, Obj):
        raise BuiltinError("cast_object: not an object")
    return x


def _set_diff(a, b):
    if not isinstance(a, frozenset) or not isinstance(b, frozenset):
        raise BuiltinError("set_diff: sets required")
    return a - b


def _glob_quote_meta(s):
    if not isinstance(s, str):
        raise BuiltinError("glob.quote_meta: string required")
    out = []
    for ch in s:
        if ch in "*?[]{}\\":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


def _time_parse_ns(layout, value):
    """Go-layout time parsing for the common layouts (RFC3339 and the
    reference date stamps); unknown layouts error -> undefined."""
    if not isinstance(layout, str) or not isinstance(value, str):
        raise BuiltinError("time.parse_ns: strings required")
    import datetime
    go_to_py = {
        "2006-01-02T15:04:05Z07:00": None,     # RFC3339: use fromisoformat
        "2006-01-02": "%Y-%m-%d",
        "2006-01-02 15:04:05": "%Y-%m-%d %H:%M:%S",
        "15:04:05": "%H:%M:%S",
        "01/02/2006": "%m/%d/%Y",
        "Mon Jan  2 15:04:05 2006": "%a %b %d %H:%M:%S %Y",
    }
    if layout not in go_to_py:
        raise BuiltinError(f"time.parse_ns: unsupported layout {layout!r}")
    fmt = go_to_py[layout]
    try:
        if fmt is None:
            dt = datetime.datetime.fromisoformat(value.replace("Z", "+00:00"))
        else:
            dt = datetime.datetime.strptime(value, fmt)
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=datetime.timezone.utc)
        return int(dt.timestamp() * 1e9)
    except ValueError as e:
        raise BuiltinError(str(e))


_DUR_UNITS = {"ns": 1, "us": 1_000, "µs": 1_000, "ms": 1_000_000,
              "s": 1_000_000_000, "m": 60_000_000_000,
              "h": 3_600_000_000_000}


def _time_parse_duration_ns(s):
    """Go time.ParseDuration: e.g. "1h30m", "-2.5s", "300ms"."""
    if not isinstance(s, str) or not s:
        raise BuiltinError("time.parse_duration_ns: string required")
    m = _re.fullmatch(
        r"([+-])?((?:\d+(?:\.\d*)?|\.\d+)(?:ns|us|µs|ms|s|m|h))+", s)
    if not m:
        raise BuiltinError(f"invalid duration {s!r}")
    sign = -1 if s[0] == "-" else 1
    total = 0.0
    for num, unit in _re.findall(r"(\d+(?:\.\d*)?|\.\d+)(ns|us|µs|ms|s|m|h)",
                                 s):
        total += float(num) * _DUR_UNITS[unit]
    return int(sign * total)


def _time_weekday(ns):
    if isinstance(ns, bool) or not isinstance(ns, (int, float)):
        raise BuiltinError("time.weekday: number required")
    import datetime
    dt = datetime.datetime.fromtimestamp(ns / 1e9, tz=datetime.timezone.utc)
    return ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
            "Saturday", "Sunday"][dt.weekday()]


def _urlquery_encode(s):
    if not isinstance(s, str):
        raise BuiltinError("urlquery.encode: string required")
    import urllib.parse
    return urllib.parse.quote_plus(s)


def _urlquery_decode(s):
    if not isinstance(s, str):
        raise BuiltinError("urlquery.decode: string required")
    import urllib.parse
    return urllib.parse.unquote_plus(s)


def _urlquery_encode_object(obj):
    if not isinstance(obj, Obj):
        raise BuiltinError("urlquery.encode_object: object required")
    import urllib.parse
    parts = []
    for k in sorted(obj.keys()):
        v = obj[k]
        if not isinstance(k, str):
            raise BuiltinError("urlquery.encode_object: string keys required")
        vals = v if isinstance(v, (tuple, frozenset)) else (v,)
        for item in (sorted_values(vals) if isinstance(v, frozenset) else vals):
            if not isinstance(item, str):
                raise BuiltinError("urlquery.encode_object: string values")
            parts.append(f"{urllib.parse.quote_plus(k)}="
                         f"{urllib.parse.quote_plus(item)}")
    return "&".join(parts)


def _b64url_pad(s: str) -> bytes:
    import base64
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _io_jwt_decode(token):
    """[header, payload, signature-hex] (vendor opa/topdown/tokens.go)."""
    if not isinstance(token, str) or token.count(".") != 2:
        raise BuiltinError("io.jwt.decode: malformed token")
    h, p, sig = token.split(".")
    try:
        header = freeze(json.loads(_b64url_pad(h)))
        payload = freeze(json.loads(_b64url_pad(p)))
        sighex = _b64url_pad(sig).hex()
    except Exception as e:
        raise BuiltinError(f"io.jwt.decode: {e}")
    return (header, payload, sighex)


def _io_jwt_verify_hs256(token, secret):
    if not isinstance(token, str) or not isinstance(secret, str) \
            or token.count(".") != 2:
        raise BuiltinError("io.jwt.verify_hs256: bad arguments")
    import hashlib
    import hmac
    h, p, sig = token.split(".")
    mac = hmac.new(secret.encode(), f"{h}.{p}".encode(),
                   hashlib.sha256).digest()
    try:
        return hmac.compare_digest(mac, _b64url_pad(sig))
    except Exception:
        return False


def _io_jwt_decode_verify(token, constraints):
    """HS256-only verification (no asymmetric-crypto library is
    vendored): [valid, header, payload]."""
    if not isinstance(constraints, Obj):
        raise BuiltinError("io.jwt.decode_verify: object constraints")
    header, payload, _ = _io_jwt_decode(token)
    alg = header["alg"] if "alg" in header else None
    secret = constraints["secret"] if "secret" in constraints else None
    valid = alg == "HS256" and isinstance(secret, str) and \
        _io_jwt_verify_hs256(token, secret)
    if valid and "iss" in constraints:
        valid = ("iss" in payload and payload["iss"] == constraints["iss"])
    if valid and "aud" in constraints:
        aud = payload["aud"] if "aud" in payload else None
        want = constraints["aud"]
        if isinstance(aud, str):
            valid = aud == want
        elif isinstance(aud, (list, tuple)):
            valid = want in list(aud)
        else:
            valid = False
    elif valid and "aud" in payload:
        valid = False   # token bound to an audience the caller didn't claim
    if valid:
        # exp/nbf are enforced by default against current time
        # (opa topdown/tokens.go builtinJWTDecodeVerify): "time" in
        # constraints overrides the clock, in nanoseconds
        now_ns = constraints["time"] if "time" in constraints else \
            _time_now_ns()
        if not isinstance(now_ns, (int, float)) or isinstance(now_ns, bool):
            raise BuiltinError("io.jwt.decode_verify: time must be a number")
        now_s = now_ns / 1e9
        exp = payload["exp"] if "exp" in payload else None
        nbf = payload["nbf"] if "nbf" in payload else None
        if isinstance(exp, (int, float)) and not isinstance(exp, bool) \
                and now_s >= exp:
            valid = False
        if isinstance(nbf, (int, float)) and not isinstance(nbf, bool) \
                and now_s < nbf:
            valid = False
    if not valid:
        return (False, Obj({}), Obj({}))
    return (True, header, payload)


def _unsupported(name: str, why: str):
    def fn(*_a, **_k):
        raise BuiltinError(f"{name}: {why}")
    # the probe CLI's --builtins listing reads these to mark stubs
    fn.builtin_name = name
    fn.unsupported_reason = why
    return fn


def _external_data(req):
    """external_data({"provider": p, "keys": [...]}) — the sanctioned
    egress path (reference: frameworks' externaldata builtin).  Resolves
    through the process-global ExternalDataRuntime: batched, TTL-cached,
    circuit-broken, with the provider's failurePolicy applied.  Returns
    {"responses": {key: value}, "errors": {key: reason},
    "system_error": ""} — a keyed map rather than the reference's
    [key, value] pair list so `object.get(.., ["responses", k], ..)`
    stays a pure lookup (documented deviation).

    On the vectorized path this builtin never runs per-review: lowering
    collects (provider, key) pairs host-side, prefetches them in one
    batched round per provider, and the kernel gathers from the interned
    device table.  This body is the scalar oracle + host-prep evaluator,
    which by then serves from the same warmed cache."""
    if not isinstance(req, Obj):
        raise BuiltinError("external_data: request must be an object")
    provider = req["provider"] if "provider" in req else None
    keys = req["keys"] if "keys" in req else None
    if not isinstance(provider, str) or not provider:
        raise BuiltinError("external_data: \"provider\" must be a "
                           "non-empty string")
    if not isinstance(keys, (tuple, frozenset)):
        raise BuiltinError("external_data: \"keys\" must be an array")
    key_list = sorted_values(keys) if isinstance(keys, frozenset) else \
        list(keys)
    for k in key_list:
        if not isinstance(k, str):
            raise BuiltinError("external_data: keys must be strings")
    from gatekeeper_tpu_torch.errors import ClientError
    raise ClientError("external_data: external data is not yet ported "
                      "to gatekeeper_tpu_torch")


def _arith_check(x):
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        raise BuiltinError("arithmetic: number required")
    return x


def _regex_template_match(template, s, start, end):
    """Match s against template where {start}...{end} delimit inline
    regexes and everything else is literal (topdown regex.go)."""
    for a in (template, s, start, end):
        if not isinstance(a, str):
            raise BuiltinError("regex.template_match: strings required")
    if not start or not end:
        raise BuiltinError("regex.template_match: empty delimiter")
    out, i = [], 0
    while i < len(template):
        j = template.find(start, i)
        if j < 0:
            out.append(_re.escape(template[i:]))
            break
        k = template.find(end, j + len(start))
        if k < 0:
            raise BuiltinError("regex.template_match: unbalanced delimiter")
        out.append(_re.escape(template[i:j]))
        out.append("(" + template[j + len(start):k] + ")")
        i = k + len(end)
    try:
        return _re.fullmatch("".join(out), s) is not None
    except _re.error as e:
        raise BuiltinError(f"regex.template_match: {e}")


REGISTRY: dict[tuple[str, ...], Callable] = {
    # ---- parity stragglers
    ("cast_string",): _cast_string,
    ("cast_boolean",): _cast_boolean,
    ("cast_null",): _cast_null,
    ("cast_object",): _cast_object,
    ("set_diff",): _set_diff,
    ("glob", "quote_meta"): _glob_quote_meta,
    ("time", "parse_ns"): _time_parse_ns,
    ("time", "parse_duration_ns"): _time_parse_duration_ns,
    ("time", "weekday"): _time_weekday,
    ("urlquery", "encode"): _urlquery_encode,
    ("urlquery", "decode"): _urlquery_decode,
    ("urlquery", "encode_object"): _urlquery_encode_object,
    ("io", "jwt", "decode"): _io_jwt_decode,
    ("io", "jwt", "verify_hs256"): _io_jwt_verify_hs256,
    ("io", "jwt", "decode_verify"): _io_jwt_decode_verify,
    ("regex", "template_match"): _regex_template_match,
    # infix call forms (opa ast/builtins.go declares them as builtins)
    ("plus",): lambda a, b: _arith_check(a) + _arith_check(b),
    ("minus",): lambda a, b: (a - b) if isinstance(a, frozenset)
    and isinstance(b, frozenset) else _arith_check(a) - _arith_check(b),
    ("mul",): lambda a, b: _arith_check(a) * _arith_check(b),
    ("div",): lambda a, b: _arith_check(a) / _arith_check(b),
    ("rem",): lambda a, b: _arith_check(a) % _arith_check(b),
    ("eq",): lambda a, b: a == b,
    ("equal",): lambda a, b: a == b,
    ("neq",): lambda a, b: a != b,
    ("lt",): lambda a, b: a < b,
    ("lte",): lambda a, b: a <= b,
    ("gt",): lambda a, b: a > b,
    ("gte",): lambda a, b: a >= b,
    # deliberately-unsupported stubs: evaluate to undefined with a
    # recorded reason instead of crashing template loads (OPA would
    # halt; routing to undefined keeps audits alive — documented
    # deviation).  http.send is OPA's "unsafe" posture (no egress).
    ("http", "send"): _unsupported(
        "http.send", "ad-hoc egress from the policy engine is not "
        "allowed; declare a Provider and use "
        'external_data({"provider": ..., "keys": [...]}) — the '
        "batched, cached, circuit-broken egress path"),
    # the sanctioned egress path (see externaldata/)
    ("external_data",): _external_data,
    ("opa", "runtime"): lambda: Obj({}),
    ("rego", "parse_module"): _unsupported("rego.parse_module",
                                           "OPA-AST output not vendored"),
    ("crypto", "x509", "parse_certificates"): _unsupported(
        "crypto.x509.parse_certificates", "no x509 parser vendored"),
    ("io", "jwt", "verify_rs256"): _unsupported(
        "io.jwt.verify_rs256", "no asymmetric-crypto library vendored"),
    ("io", "jwt", "verify_ps256"): _unsupported(
        "io.jwt.verify_ps256", "no asymmetric-crypto library vendored"),
    ("io", "jwt", "verify_es256"): _unsupported(
        "io.jwt.verify_es256", "no asymmetric-crypto library vendored"),
    ("regex", "globs_match"): _unsupported(
        "regex.globs_match", "glob-intersection engine not vendored"),
    # aggregates
    ("count",): _count,
    ("sum",): _sum,
    ("product",): _product,
    ("max",): _max,
    ("min",): _min,
    ("all",): _all,
    ("any",): _any,
    ("sort",): _sort,
    # numbers
    ("abs",): _abs,
    ("round",): _round,
    ("ceil",): _ceil,
    ("floor",): _floor,
    ("to_number",): _to_number,
    # strings
    ("startswith",): lambda s, p: _need_string(s, "startswith").startswith(_need_string(p, "startswith")),
    ("endswith",): lambda s, p: _need_string(s, "endswith").endswith(_need_string(p, "endswith")),
    ("contains",): lambda s, p: _need_string(p, "contains") in _need_string(s, "contains"),
    ("concat",): _concat,
    ("split",): _split,
    ("replace",): lambda s, old, new: _need_string(s, "replace").replace(
        _need_string(old, "replace"), _need_string(new, "replace")),
    ("substring",): _substring,
    ("sprintf",): opa_sprintf,
    ("lower",): lambda s: _need_string(s, "lower").lower(),
    ("upper",): lambda s: _need_string(s, "upper").upper(),
    ("trim",): _trim,
    ("trim_space",): lambda s: _need_string(s, "trim_space").strip(),
    ("trim_prefix",): lambda s, p: s[len(p):] if _need_string(s, "trim_prefix").startswith(_need_string(p, "trim_prefix")) else s,
    ("trim_suffix",): lambda s, p: s[: len(s) - len(p)] if _need_string(s, "trim_suffix").endswith(_need_string(p, "trim_suffix")) else s,
    ("indexof",): _indexof,
    ("format_int",): _format_int,
    # regex / glob
    ("re_match",): _re_match,
    ("regex", "match"): _re_match,
    ("glob", "match"): _glob_match,
    # arrays / sets / objects
    ("array", "concat"): _array_concat,
    ("array", "slice"): _array_slice,
    ("intersection",): _intersection,
    ("union",): _union,
    ("object", "get"): _object_get,
    ("cast_array",): _cast_array,
    ("cast_set",): _cast_set,
    ("object", "union"): _object_union,
    ("object", "remove"): _object_remove,
    ("object", "filter"): _object_filter,
    # units (container limits quantities, parse_bytes.go)
    ("units", "parse_bytes"): _units_parse_bytes,
    ("units", "parse"): _units_parse,
    # encoding
    ("base64", "encode"): _base64_encode,
    ("base64", "decode"): _base64_decode,
    ("base64url", "encode"): _base64url_encode,
    ("base64url", "decode"): _base64url_decode,
    # numbers
    ("numbers", "range"): _numbers_range,
    ("regex", "split"): _regex_split,
    ("regex", "is_valid"): _regex_is_valid,
    ("regex", "find_n"): _regex_find_n,
    ("strings", "replace_n"): _strings_replace_n,
    # crypto digests
    ("crypto", "md5"): _crypto_md5,
    ("crypto", "sha1"): _crypto_sha1,
    ("crypto", "sha256"): _crypto_sha256,
    # net
    ("net", "cidr_contains"): _net_cidr_contains,
    ("net", "cidr_intersects"): _net_cidr_intersects,
    ("net", "cidr_overlap"): _net_cidr_contains,   # OPA's old alias
    # semver
    ("semver", "is_valid"): _semver_is_valid,
    ("semver", "compare"): _semver_compare,
    # time
    ("time", "now_ns"): _time_now_ns,
    ("time", "parse_rfc3339_ns"): _time_parse_rfc3339_ns,
    ("time", "date"): _time_date,
    ("time", "clock"): _time_clock,
    # yaml
    ("yaml", "marshal"): _yaml_marshal,
    ("yaml", "unmarshal"): _yaml_unmarshal,
    # json
    ("json", "marshal"): _json_marshal,
    ("json", "unmarshal"): _json_unmarshal,
    # types
    ("is_number",): _is_number,
    ("is_string",): lambda x: isinstance(x, str),
    ("is_boolean",): lambda x: isinstance(x, bool),
    ("is_array",): lambda x: isinstance(x, tuple),
    ("is_object",): lambda x: isinstance(x, Obj),
    ("is_set",): lambda x: isinstance(x, frozenset),
    ("is_null",): lambda x: x is None,
    ("type_name",): lambda x: (
        "null" if x is None else
        "boolean" if isinstance(x, bool) else
        "number" if isinstance(x, (int, float)) else
        "string" if isinstance(x, str) else
        "array" if isinstance(x, tuple) else
        "set" if isinstance(x, frozenset) else
        "object"),
}


# Builtins whose result can change between two calls with identical
# arguments (clocks, tracing side effects, signature verification that
# consults the clock for exp/nbf).  Any cross-constraint or cross-review
# memoization layer (rego/closures._review_shareable, and whatever comes
# next) must refuse to cache a computation that calls one of these.
# New clock/random/IO builtins belong here the day they are registered.
IMPURE_BUILTINS: frozenset[tuple[str, ...]] = frozenset({
    ("trace",),                         # tracer side effect per call
    ("time", "now_ns"),                 # per-query clock
    ("io", "jwt", "decode_verify"),     # checks exp/nbf against the clock
    ("external_data",),                 # remote data varies between calls
})
