# Copied from gatekeeper_tpu/ops/regex_dfa.py for the PyTorch port.
"""Batched regex evaluation: regex -> byte DFA -> vectorized matching.

The scalar engine evaluates ``re_match`` per document via Python's
``re`` (rego/builtins.py:108, search semantics — the Go engine's
``regexp.MatchString``, vendor opa/topdown/regex.go).  The device
engine host-evaluates regex into per-unique-value lookup tables
(ir/lower.py) — a fast design while unique-value counts stay modest,
but every unique string costs one host ``re.search`` per full table
(re)build.  This module is the high-cardinality answer (round-3
VERDICT #10 / SURVEY §7 hard-part 3):

- ``compile_dfa``: a supported-subset regex compiles through Thompson
  NFA construction + subset construction into a dense byte-transition
  table ``[n_states, 256]`` (None when the pattern uses constructs
  outside the subset — the caller keeps the per-value host path).
- ``match_packed``: one numpy gather per character position over the
  whole batch — no Python per string.
- (the device scan lives in the port's kernels/dfa.py)

Search semantics: a self-loop on the start state makes the match
unanchored on the left; accepting states absorb (a match anywhere
wins); ``$`` consumes the NUL terminator each packed string ends with
(k8s strings never contain NUL).  Category classes (\\d \\w \\s) are
ASCII — non-ASCII inputs are detected by the packer and routed back to
the host path, so the byte-level approximation never changes results.
"""

from __future__ import annotations

import dataclasses

import numpy as np

try:                                    # CPython 3.11+
    import re._parser as _sre_parse
    import re._constants as _sre
except ImportError:                     # pragma: no cover - older layouts
    import sre_parse as _sre_parse      # type: ignore
    import sre_constants as _sre        # type: ignore

TERM = 0                    # per-string terminator byte (strings are NUL-free)

# Routing thresholds (tests/bench override the module attributes):
# below TABLE_MIN_UNIQUES the per-value host loop wins (DFA compile +
# packing overhead); at TABLE_DEVICE_MIN_UNIQUES the lax.scan device
# twin takes over from the numpy path.
TABLE_MIN_UNIQUES = 4096
TABLE_DEVICE_MIN_UNIQUES = 262144

DFA_VERSION = 1
"""Automaton format/semantics version.  Bump whenever compile_dfa's
output for a given pattern can change — snapshot entries are keyed by
(pattern, DFA_VERSION), so a stale persisted table can never serve a
newer engine."""

_dfa_cache: dict = {}
DFA_CACHE_MAX = 1024
"""In-process memo bound: patterns come from installed templates (a few
hundred at most), but probe/what-if tooling can sweep arbitrary
candidate patterns through ``cached_dfa`` — evict oldest-inserted past
the cap instead of growing without bound."""

compiles_run = 0
"""Process-wide count of actual ``compile_dfa`` executions (memo and
snapshot hits excluded) — the restart-smoke stage asserts this stays 0
on a warm start, like transval.validations_run for certificates."""


def dfa_enabled() -> bool:
    """``GATEKEEPER_DFA`` gate for the in-program lowering (ir/lower.py
    emitting ``dfa_match`` nodes).  Default on; ``off``/``0``/``false``
    keeps the host lookup-table path as a bit-identical parity oracle —
    the same graduation contract as ``GATEKEEPER_PAGES``."""
    import os
    return os.environ.get("GATEKEEPER_DFA", "on").strip().lower() not in (
        "off", "0", "false")


def dfa_digest(pattern: str) -> str:
    import hashlib
    return hashlib.sha256(
        f"dfa-v{DFA_VERSION}\x00{pattern}".encode()).hexdigest()[:24]


def cached_dfa(pattern: str):
    """compile_dfa with a bounded process-wide memo (None results
    cached too: unsupported patterns should not re-parse per rebuild).
    The port has no snapshot tier yet, so every process compiles each
    pattern once."""
    global compiles_run
    if pattern in _dfa_cache:
        return _dfa_cache[pattern]
    compiles_run += 1
    dfa = compile_dfa(pattern)
    while len(_dfa_cache) >= DFA_CACHE_MAX:
        _dfa_cache.pop(next(iter(_dfa_cache)))
    _dfa_cache[pattern] = dfa
    return dfa
MAX_NFA_STATES = 512
MAX_DFA_STATES = 1024
MAX_REPEAT_EXPAND = 64

_DIGITS = frozenset(range(ord("0"), ord("9") + 1))
_WORD = (_DIGITS | frozenset(range(ord("a"), ord("z") + 1))
         | frozenset(range(ord("A"), ord("Z") + 1)) | {ord("_")})
_SPACE = frozenset(b" \t\n\r\f\v")
_ANY = frozenset(range(1, 256)) - {ord("\n")}     # `.`: not newline, not NUL
_ALL = frozenset(range(1, 256))


@dataclasses.dataclass
class DFA:
    trans: np.ndarray      # int32 [n_states, 256]
    accept: np.ndarray     # bool [n_states]
    start: int
    pattern: str


class _Unsupported(Exception):
    pass


class _NFA:
    """Thompson construction: states with epsilon edges and
    byte-class edges."""

    def __init__(self):
        self.eps: list[set[int]] = []
        self.edges: list[list[tuple[frozenset, int]]] = []

    def state(self) -> int:
        if len(self.eps) >= MAX_NFA_STATES:
            raise _Unsupported("too many NFA states")
        self.eps.append(set())
        self.edges.append([])
        return len(self.eps) - 1

    def add_eps(self, a: int, b: int) -> None:
        self.eps[a].add(b)

    def add_edge(self, a: int, syms: frozenset, b: int) -> None:
        if syms:
            self.edges[a].append((syms, b))


def _category_bytes(cat) -> frozenset:
    name = str(cat).rsplit("_", 1)[-1].lower()
    neg = "not" in str(cat).lower()
    base = {"digit": _DIGITS, "word": _WORD, "space": _SPACE}.get(name)
    if base is None:
        raise _Unsupported(f"category {cat}")
    return (_ALL - base) if neg else base


def _in_bytes(items) -> frozenset:
    out: set[int] = set()
    negate = False
    for op, arg in items:
        if op is _sre.NEGATE:
            negate = True
        elif op is _sre.LITERAL:
            if arg > 127:
                raise _Unsupported("non-ASCII literal in class")
            out.add(arg)
        elif op is _sre.RANGE:
            lo, hi = arg
            if hi > 127:
                raise _Unsupported("non-ASCII range in class")
            out.update(range(lo, hi + 1))
        elif op is _sre.CATEGORY:
            out.update(_category_bytes(arg))
        else:
            raise _Unsupported(f"class item {op}")
    return frozenset(_ALL - out) if negate else frozenset(out)


def _literal_bytes(cp: int) -> list[frozenset]:
    """One character -> a sequence of single-byte classes (UTF-8)."""
    return [frozenset((b,)) for b in chr(cp).encode("utf-8")]


def _build(nfa: _NFA, tokens, start: int, end: int,
           at_start: bool) -> None:
    """Wire `tokens` between NFA states start..end."""
    if not tokens:
        # empty sequence matches the empty string ("", "^", "a|") —
        # without this epsilon the DFA would reject everything
        nfa.add_eps(start, end)
        return
    cur = start
    n = len(tokens)
    for i, (op, arg) in enumerate(tokens):
        last = i == n - 1
        nxt = end if last else nfa.state()
        if op is _sre.LITERAL:
            seq = _literal_bytes(arg)
            mid = cur
            for j, syms in enumerate(seq):
                dst = nxt if j == len(seq) - 1 else nfa.state()
                nfa.add_edge(mid, syms, dst)
                mid = dst
        elif op is _sre.NOT_LITERAL:
            if arg > 127:
                raise _Unsupported("non-ASCII not-literal")
            nfa.add_edge(cur, _ALL - {arg}, nxt)
        elif op is _sre.IN:
            nfa.add_edge(cur, _in_bytes(arg), nxt)
        elif op is _sre.ANY:
            nfa.add_edge(cur, _ANY, nxt)
        elif op is _sre.AT:
            # ^ is handled at compile_dfa level (leading token only):
            # a restart edge to a post-^ state would un-anchor it
            if arg in (_sre.AT_END, _sre.AT_END_STRING):
                # `$` ≈ `\Z`: both consume the NUL terminator (known
                # deviation: `$` before a trailing newline is treated
                # as \Z — k8s identifier fields never end in \n)
                nfa.add_edge(cur, frozenset((TERM,)), nxt)
            else:
                raise _Unsupported(f"anchor {arg}")
        elif op is _sre.SUBPATTERN:
            _g, add_flags, del_flags, sub = arg
            if add_flags or del_flags:
                raise _Unsupported("inline flags")
            _build(nfa, list(sub), cur, nxt, at_start and i == 0)
        elif op is _sre.BRANCH:
            _none, alts = arg
            for alt in alts:
                a, b = nfa.state(), nfa.state()
                nfa.add_eps(cur, a)
                nfa.add_eps(b, nxt)
                _build(nfa, list(alt), a, b, at_start and i == 0)
        elif op in (_sre.MAX_REPEAT, _sre.MIN_REPEAT):
            lo, hi, sub = arg
            sub = list(sub)
            if lo > MAX_REPEAT_EXPAND or (
                    hi is not _sre.MAXREPEAT and hi > MAX_REPEAT_EXPAND):
                raise _Unsupported("huge bounded repeat")
            mid = cur
            for _ in range(lo):                      # mandatory copies
                dst = nfa.state()
                _build(nfa, sub, mid, dst, False)
                mid = dst
            if hi is _sre.MAXREPEAT:                 # star tail
                a = nfa.state()
                nfa.add_eps(mid, a)
                b = nfa.state()
                _build(nfa, sub, a, b, False)
                nfa.add_eps(b, a)
                nfa.add_eps(a, nxt)
            else:
                for _ in range(hi - lo):             # optional copies
                    dst = nfa.state()
                    _build(nfa, sub, mid, dst, False)
                    nfa.add_eps(mid, nxt)
                    mid = dst
                nfa.add_eps(mid, nxt)
        else:
            raise _Unsupported(f"op {op}")
        cur = nxt


def _compile(pattern: str) -> DFA:
    """Compile to a byte DFA with unanchored-search semantics; raises
    ``_Unsupported`` (with a human-readable reason) when the pattern
    falls outside the supported subset."""
    try:
        parsed = _sre_parse.parse(pattern)
    except Exception as e:                  # noqa: BLE001 - sre raises re.error
        raise _Unsupported(f"unparseable: {e}") from None
    tokens = list(parsed)
    anchored_left = bool(tokens) and tokens[0][0] is _sre.AT \
        and tokens[0][1] in (_sre.AT_BEGINNING, _sre.AT_BEGINNING_STRING)
    if anchored_left:
        tokens = tokens[1:]
    nfa = _NFA()
    start, end = nfa.state(), nfa.state()
    _build(nfa, tokens, start, end, at_start=True)

    def closure(states: frozenset) -> frozenset:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    # left-unanchored: self-loop on the start set (any byte restarts a
    # potential match); right-unanchored: accepting is absorbing
    start_set = closure(frozenset((start,)))
    dfa_states: dict[frozenset, int] = {start_set: 0}
    order = [start_set]
    trans_rows: list[np.ndarray] = []
    accept: list[bool] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        acc = end in cur
        accept.append(acc)
        row = np.zeros((256,), dtype=np.int32)
        if acc:
            # absorbing accept: a match has been seen, nothing unsees it
            row[:] = dfa_states[cur]
            trans_rows.append(row)
            continue
        # collect byte -> next NFA state set
        move: dict[int, set] = {}
        for s in cur:
            for syms, dst in nfa.edges[s]:
                for b in syms:
                    move.setdefault(b, set()).add(dst)
        for b in range(256):
            nxt = frozenset(move.get(b, ()))
            # restart edge: unanchored search may begin at any byte
            # (suppressed for left-anchored patterns: a restart would
            # resurrect the post-^ continuation mid-string)
            if b != TERM and not anchored_left:
                nxt = nxt | frozenset((start,))
            nxt = closure(nxt)
            if nxt not in dfa_states:
                if len(dfa_states) >= MAX_DFA_STATES:
                    raise _Unsupported("too many DFA states")
                dfa_states[nxt] = len(order)
                order.append(nxt)
            row[b] = dfa_states[nxt]
        trans_rows.append(row)
    return DFA(trans=np.stack(trans_rows), accept=np.asarray(accept),
               start=0, pattern=pattern)


def compile_dfa(pattern: str) -> DFA | None:
    """``_compile`` with the reason swallowed: None means "keep the
    per-value host path" (never an error)."""
    try:
        return _compile(pattern)
    except _Unsupported:
        return None


def unsupported_reason(pattern: str) -> str | None:
    """Why ``pattern`` is outside the DFA subset, or None when it
    compiles.  Diagnostic-path only (probe --policyset, reconciler
    status warnings) — runs a full compile, no memo."""
    try:
        _compile(pattern)
        return None
    except _Unsupported as e:
        return str(e)


def pack_strings(strings, max_len: int | None = None):
    """Encode to a NUL-terminated uint8 batch [U, L+1].  Returns
    (packed, ascii_ok [U]) — entries with non-ASCII bytes or length
    over the cap must stay on the exact host path (byte-level category
    classes are ASCII approximations)."""
    bs = [s.encode("utf-8") for s in strings]
    if max_len is None:
        max_len = max((len(b) for b in bs), default=0)
    packed = np.zeros((len(bs), max_len + 1), dtype=np.uint8)
    ok = np.ones((len(bs),), dtype=bool)
    for i, b in enumerate(bs):
        if len(b) > max_len or any(c == 0 or c > 127 for c in b):
            ok[i] = False
            continue
        packed[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return packed, ok


def match_packed(dfa: DFA, packed: np.ndarray) -> np.ndarray:
    """bool [U]: one vectorized transition gather per character
    position — no per-string Python."""
    flat = dfa.trans.ravel()
    state = np.full((packed.shape[0],), dfa.start, dtype=np.int32)
    for j in range(packed.shape[1]):
        state = flat[state * 256 + packed[:, j]]
    return dfa.accept[state]


MAX_PACK_LEN = 512
"""Dense-pack length cap: the batch is [U, L+1] bytes, so one huge
outlier (a last-applied-configuration annotation) must not inflate the
whole allocation — overlong entries take the exact host path via the
packer's ok-mask."""


def match_strings(dfa: DFA, strings) -> np.ndarray:
    """Convenience: pack + match + exact host fallback for entries the
    packer rejected (non-ASCII / NUL / longer than MAX_PACK_LEN)."""
    import re
    longest = max((len(x) for x in strings), default=0)
    packed, ok = pack_strings(strings, max_len=min(longest, MAX_PACK_LEN))
    out = np.asarray(match_packed(dfa, packed), dtype=bool)
    if not ok.all():
        rx = re.compile(dfa.pattern)
        for i in np.nonzero(~ok)[0]:
            out[i] = rx.search(strings[i]) is not None
    return out
