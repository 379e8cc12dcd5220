"""K1: the IR evaluator as one generated Triton kernel per Program.

Replaces the JAX package's ``engine/veval.py`` ``_Evaluator._eval``,
``_eval_program`` and ``_eval_mask`` (item B1): XLA fused the jitted
evaluator on the TPU; on the H100 the port writes the fused pass itself.
:func:`emit_source` walks ``program.nodes`` and ``program.rules`` and
writes the source of one ``@triton.jit`` kernel; :func:`eval_mask`
launches it for CUDA tensors and runs the plain evaluator
(``engine/executor._eval_mask``) only for tensors on the CPU.

Kernel shape: row-tile major.  A program owns ``BR`` rows and a range
of ``CPS`` constraints.  A node's value is a block of shape
``[BC|1, BR|1, E|1]`` (the reference's ``_to3`` lattice), with the
element axis a ``tl.constexpr`` block equal to the binding's padded
width.  The emitter splits the nodes by whether their value carries the
constraint axis (:func:`node_axes`): the *row prologue* (r-axis and
element columns, ``e:val`` id loads, ``.vmap`` and table gathers,
presence flags, and each rule's AND of its row-only conjuncts) is
evaluated once per row tile as ``[1, BR, E]`` blocks and stays in
registers; the *constraint body* runs in a loop over ``BC``-wide
constraint tiles inside the program and stores one ``[BC, BR]`` slab a
tile.  Each node is emitted once, into one of the two.  Gathers
(``table``, ``ptable_*``, ``in_cset``, ``keyed_val``, ``dfa_match``)
are loads at computed offsets, clamped as XLA clamps them; the 0/1
products of ``cset_*_memb`` and ``elem_keys_missing`` are 32-bit words
of key bits (a row's missing keys in the prologue, a constraint's keys
in the body, one AND a word); float arithmetic uses round-to-nearest
PTX (``add.rn`` ... and ``div.rn``) so neither FMA contraction nor
Triton's approximate fp32 division can change a bit.  A rule fires
where the ANY over its element axis of (conjuncts & presence) holds,
ANDed with ``__alive__`` and ``__cvalid__``, ORed across rules and
ANDed with ``__match__``; one bool per (c, r) is stored.  A node's
defined-ness is a set of terms, so each rule ANDs its row terms in the
prologue and its constraint-only terms (constant along R and E) after
the ANY; a rule whose one remaining term is an ordering compare of a row
value with a constraint value takes the max (or min) over E in the
prologue and compares once per (c, r).  All of these are exact
rewrites of the reference's lattice arithmetic.

Two modes, one source: ``DELTA`` is a ``tl.constexpr``, so each program
and signature compiles one variant per mode.  In full mode (K1) row
``j`` of the tile is addressed directly with contiguity hints, so the
r-axis column loads and the mask store vectorize and ``rows`` is never
read.  K5, the churn delta (item B5, the reference's ``_delta_fn``), is
the row-index mode: a runtime row vector ``rows`` of length ``D > 0``
(duplicates allowed; lanes past ``D`` repeat the last row) replaces the
tile's own rows, and every r-axis load and the mask store address the
full ``R_PAD``-strided arrays at ``rows[j]``.  :func:`delta_mask`
launches it into a copy of the stored mask; :func:`warm_delta` makes the
same launch uncounted, so the driver's background warm-up compiles the
delta variant before the first churned sweep needs it.

The fleet audit's batched evaluator (item B9, the reference's
``whatif/fleet.py`` ``_mask_fn`` and the evaluator inside ``_topk_fn``:
``jax.vmap`` over a leading cluster axis) is the same kernel again: grid
axis 2 runs over the N clusters, and every array pointer and the output
advance by ``pid_b`` times their per-cluster element count, a runtime
argument (``sb<i>``, ``SB_OUT``).  :func:`eval_mask_batched` launches it
once for all N clusters.  Unbatched launches pass the same per-cluster
counts with ``pid_b`` 0, so over equal per-cluster shapes and an equal
tile plan the two take one compiled variant (Triton specialises an
integer argument only on being 1 or a multiple of 16, and equal counts
agree on both).

Tile plan (:func:`tile_plan`): chosen by occupancy.  ``BR`` keeps a
prologue block near ``ROW_POINTS`` lattice points and ``BC`` a body
block near ``BODY_POINTS``; where the grid has fewer than two programs
per SM, ``BR`` halves down to 16 rows (a 16-byte mask run), then the
constraint loop splits across the grid (``SPLIT`` programs a row tile,
``CPS`` constraints each), then ``BC`` halves.  Delta launches take
the plan of ``DELTA_ROWS`` rows whatever their row count, so each
program compiles one delta variant.

Bound on the H100: bytes for most programs (each bound column read
once, the ``[C_pad, R_pad]`` mask written once), element operations for
the wide per-constraint gathers.  Row-only work is done once per row
tile (once per split), intermediates stay in registers, and the r-axis
columns a body reads (``memb``, ``.kv``) are re-read once per
constraint tile from L1/L2.

Kernels are cached by ``program.cache_key()`` plus the bound arrays'
names, dtypes and ranks (and each cset's key count, which the source
unrolls); Triton specialises each on the element widths and the tile
plan.  A launch plan (argument order, per-cluster counts, sizes, grid,
constexprs and the compiled kernel) is cached per device, program,
mode, batching, row count and array shapes, so a repeated call checks
its tensors and launches the compiled kernel directly.  Plans are made
under a lock, and every launch through Triton's JIT launcher (the one
that may compile) holds a second one, so a sweep and the warm-up thread
never compile one variant twice.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import os
import threading

import numpy as np
import torch

from gatekeeper_tpu_torch.ir.prep import binding_axes
from gatekeeper_tpu_torch.ir.program import Program
from gatekeeper_tpu_torch.kernels import build
from gatekeeper_tpu_torch.utils import compile_cache

_ALWAYS = "ONE"     # the all-true [1, 1, 1] block: "always defined"

_TL_DT = {"float32": "tl.float32", "int32": "tl.int32", "bool": "tl.int1"}

_HELPERS = '''
import triton
import triton.language as tl


@triton.jit
def _add_rn(a, b):
    a, b = tl.broadcast(a, b)
    return tl.inline_asm_elementwise("add.rn.f32 $0, $1, $2;", "=f,f,f",
                                     [a, b], dtype=tl.float32,
                                     is_pure=True, pack=1)


@triton.jit
def _sub_rn(a, b):
    a, b = tl.broadcast(a, b)
    return tl.inline_asm_elementwise("sub.rn.f32 $0, $1, $2;", "=f,f,f",
                                     [a, b], dtype=tl.float32,
                                     is_pure=True, pack=1)


@triton.jit
def _mul_rn(a, b):
    a, b = tl.broadcast(a, b)
    return tl.inline_asm_elementwise("mul.rn.f32 $0, $1, $2;", "=f,f,f",
                                     [a, b], dtype=tl.float32,
                                     is_pure=True, pack=1)


@triton.jit
def _div_rn(a, b):
    a, b = tl.broadcast(a, b)
    return tl.inline_asm_elementwise("div.rn.f32 $0, $1, $2;", "=f,f,f",
                                     [a, b], dtype=tl.float32,
                                     is_pure=True, pack=1)


@triton.jit
def _clamp(x, hi):
    return tl.minimum(tl.maximum(x, 0), hi)
'''


def _kind_of(dtype: str) -> str:
    if dtype == "bool":
        return "b"
    if dtype.startswith("float"):
        return "f"
    return "i"


class _Emitter:
    """Writes the kernel source for one (program, array signature): a
    row prologue (``pro``, once per row tile) and a constraint body
    (``body``, once per constraint tile).  A node's defined-ness is a
    tuple of boolean terms (empty: always defined), so a rule ANDs its
    row-only terms in the prologue and only the rest in the body."""

    def __init__(self, program: Program, sig: dict[str, tuple[str, tuple]]):
        self.p = program
        self.sig = sig                       # name -> (dtype, shape)
        self.axes = node_axes(program)
        self.has_c = ["c" in a for a in self.axes]
        self.cur_axes = _ALL_AXES            # of what assign() writes
        self.vaxes: dict[str, frozenset] = {}
        self.cmp_of: dict[str, int] = {}     # cmp value variable -> node
        self.pro: list[str] = []
        self.body: list[str] = []
        self.sec = self.pro                  # where emit() writes
        self.cvars: set[str] = set()         # variables of the body
        self.ptrs: list[str] = []            # array names, in arg order
        self.ints: list[tuple[str, str, int]] = []   # (arg, array, dim)
        self.consts: list[tuple[str, str, int]] = []  # constexpr dims
        self.loaded: dict[tuple, str] = {}
        self.vals: dict[int, tuple[tuple, str, str]] = {}
        self.conjs: dict[frozenset, str] = {}
        self.tmp = 0

    # -- argument bookkeeping
    def ptr(self, name: str) -> str:
        if name not in self.sig:
            raise KeyError(name)
        if name not in self.ptrs:
            self.ptrs.append(name)
        return f"p{self.ptrs.index(name)}"

    def dim(self, name: str, d: int) -> str:
        arg = f"{self.ptr(name)}_d{d}"
        if (arg, name, d) not in self.ints:
            self.ints.append((arg, name, d))
        return arg

    def edim(self, name: str, d: int) -> str:
        arg = f"E_{self.ptr(name)}"
        if (arg, name, d) not in self.consts:
            self.consts.append((arg, name, d))
        return arg

    def emit(self, line: str) -> None:
        self.sec.append(line)

    def assign(self, expr: str) -> str:
        """A fresh variable set to ``expr`` in the current section."""
        self.tmp += 1
        var = f"t{self.tmp}"
        self.emit(f"{var} = {expr}")
        if self.sec is self.body:
            self.cvars.add(var)
        self.vaxes[var] = self.cur_axes
        return var

    @contextlib.contextmanager
    def section(self, body: bool):
        saved, self.sec = self.sec, (self.body if body else self.pro)
        try:
            yield
        finally:
            self.sec = saved

    def kind(self, name: str) -> str:
        return _kind_of(self.sig[name][0])

    def _load_expr(self, name: str, off: str) -> str:
        p = self.ptr(name)
        k = self.kind(name)
        if k == "b":
            return f"(tl.load({p} + {off}) != 0)"
        if k == "i":
            return f"tl.load({p} + {off}).to(tl.int32)"
        return f"tl.load({p} + {off})"

    def load(self, name: str, axes: str) -> str:
        """A bound array as a block: 'c' -> [BC,1,1] and 'c2' -> [BC,1]
        (body); 'r' -> [1,BR,1], 'r2' -> [1,BR] and 'e' -> [1,BR,E]
        (prologue)."""
        key = (name, axes)
        hit = self.loaded.get(key)
        if hit is not None:
            return hit
        if axes in ("c", "r", "c2", "r2"):
            off = axes + "3" if len(axes) == 1 else axes
        elif axes == "e":
            E = self.edim(name, 1)
            off = f"r3 * {E} + tl.arange(0, {E})[None, None, :]"
        else:
            raise ValueError(axes)
        with self.section(axes[0] == "c"):
            hit = self.loaded[key] = self.assign(self._load_expr(name, off))
        self.vaxes[hit] = _AXES_OF_LOAD[axes]
        return hit

    def gather(self, name: str, idx: str) -> str:
        """name[clamp(idx, 0, len - 1)] for a 1-d array."""
        n = self.dim(name, 0)
        return self.assign(self._load_expr(name, f"_clamp({idx}, {n} - 1)"))

    # -- values: (defined terms, value, kind)
    def node(self, i: int):
        hit = self.vals.get(i)
        if hit is None:
            n = self.p.nodes[i]
            for a in n.args:
                self.node(a)
            saved, self.cur_axes = self.cur_axes, self.axes[i]
            try:
                with self.section(self.has_c[i]):
                    self.emit(f"# n{i} {n.op}")
                    hit = self.vals[i] = self._node(i)
            finally:
                self.cur_axes = saved
            if n.op == "cmp":
                self.cmp_of[hit[1]] = i
        return hit

    def fires(self, i: int) -> tuple:
        """The terms whose AND is 'defined and truthy'."""
        d, v, k = self.node(i)
        return _join(d, (v,)) if k == "b" else d

    def conj(self, terms: tuple) -> str:
        """The AND of ``terms`` as one variable, emitted once: the row
        terms in the prologue, the constraint terms after them in the
        body."""
        if not terms:
            return _ALWAYS
        if len(terms) == 1:
            return terms[0]
        key = frozenset(terms)
        hit = self.conjs.get(key)
        if hit is None:
            row = tuple(t for t in terms if t not in self.cvars)
            col = tuple(t for t in terms if t in self.cvars)
            if row and col:
                acc, rest = self.conj(row), col
            else:
                acc, rest = terms[0], terms[1:]
            with self.section(bool(col)):
                for t in rest:
                    acc = self.assign(f"{acc} & {t}")
                    self.vaxes[acc] = frozenset().union(
                        *(self.vaxes.get(x, _ALL_AXES) for x in terms))
            hit = self.conjs[key] = acc
        return hit

    def any_e(self, x: str) -> str:
        """The ANY over the element axis: [.., .., E] -> [.., ..]."""
        return self.assign(f"tl.max({x}.to(tl.int32), axis=2) != 0")

    def missing_keys(self, bname: str, arr: str, elem: bool) -> str:
        """[BC, BR, 1|E] bool: some key l with ``B[c, l]`` set and
        ``arr[l, r(, e)]`` clear — the count the reference takes as a
        0/1 product, as 32-bit words of key bits: a row's clear keys in
        the prologue, a constraint's keys in the body, one AND a word."""
        hit = self.loaded.get((bname, arr))
        if hit is not None:
            return hit
        nkeys = self.sig[bname][1][1]
        if nkeys == 0:
            hit = self.loaded[(bname, arr)] = self.assign(
                "tl.zeros([1, 1, 1], tl.int1)")
            return hit
        if elem:
            E = self.edim(arr, 2)
            off = (f"l * R64 * {E} + r3 * {E} "
                   f"+ tl.arange(0, {E})[None, None, :]")
            width = E
        else:
            off, width = "l * R64 + r3", 1
        hits = []
        for w0 in range(0, nkeys, 32):
            w1 = min(nkeys, w0 + 32)
            with self.section(False):
                rb = self.assign(f"tl.zeros([1, BR, {width}], tl.int32)")
                self.emit(f"for l in tl.static_range({w0}, {w1}):")
                self.emit(f"    {rb} |= ({self._load_expr(arr, off)} == 0)"
                          f".to(tl.int32) << (l - {w0})")
            cb = self.assign("tl.zeros([BC, 1, 1], tl.int32)")
            self.emit(f"for l in tl.static_range({w0}, {w1}):")
            key = self._load_expr(bname, f"c3 * {nkeys} + l")
            self.emit(f"    {cb} |= {key}.to(tl.int32) << (l - {w0})")
            hits.append(self.assign(f"({cb} & {rb}) != 0"))
        hit = self.loaded[(bname, arr)] = hits[0] if len(hits) == 1 \
            else self.assign(" | ".join(hits))
        return hit

    def _node(self, i: int):
        n = self.p.nodes[i]
        op = n.op
        if op == "const":
            value, dtype = n.meta
            dt = np.dtype(dtype).name
            if dt == "bool":
                lit = "1" if bool(value) else "0"
            elif dt.startswith("float"):
                f = float(np.float32(value))
                if not np.isfinite(f):
                    raise ValueError(f"non-finite IR constant {value!r}")
                lit = repr(f)
            else:
                lit = repr(int(value))
            v = self.assign(f"tl.full([1, 1, 1], {lit}, {_TL_DT[dt]})")
            return (), v, _kind_of(dt)
        if op == "input":
            name, kind = n.meta
            axes = kind[0]
            if kind.endswith("_num"):
                v = self.load(name + ".v", axes)
                d = self.load(name + ".p", axes)
                return (d,), v, self.kind(name + ".v")
            v = self.load(name, axes)
            if kind.endswith("_id"):
                return (self.assign(f"{v} >= 0"),), v, "i"
            return (), v, "b"
        if op == "table":
            (tname,) = n.meta
            d_i, idx, _ = self.node(n.args[0])
            ci = self.assign(f"tl.maximum({idx}, 0)")
            ok = self.gather(tname + ".ok", ci)
            val = self.gather(tname + ".v", ci)
            return _join(d_i, (ok,)), val, self.kind(tname + ".v")
        if op == "dfa_match":
            (dname,) = n.meta
            d_i, idx, _ = self.node(n.args[0])
            ci = self.assign(f"tl.maximum({idx}, 0)")
            v = self.gather(dname + ".devtab", ci)
            return _join(d_i, (v,)), v, "b"
        if op in ("ptable_any", "ptable_all", "in_cset"):
            if op == "in_cset":
                (cname,) = n.meta
                vmap, tbl = cname + ".vmap", cname + ".bitmap"
            else:
                tname, _ = n.meta
                vmap = tname + ".vmap"
                tbl = tname + (".any" if op == "ptable_any" else ".all")
            d_i, idx, _ = self.node(n.args[0])
            idx_c = self.has_c[n.args[0]]
            if idx_c and op != "in_cset":
                # the reference reads tbl[:, u[0]] — constraint 0's ids
                raise ValueError(f"{op}: per-constraint index operand is "
                                 f"not supported by the K1 emitter")
            T = self.dim(vmap, 0)
            U = self.dim(tbl, 1)
            with self.section(idx_c):       # the dense id, once per row
                u = self.assign(
                    f"_clamp(tl.where(({idx} >= 0) & ({idx} < {T}), "
                    f"{self._load_expr(vmap, f'_clamp({idx}, {T} - 1)')}, "
                    f"{U} - 1), {U} - 1)")
            v = self.assign(self._load_expr(tbl, f"c3 * {U} + {u}"))
            return d_i, v, "b"
        if op == "keyed_val":
            (name,) = n.meta
            sel = self.load(name + ".sel", "c")
            K = self.dim(name + ".kv", 0)
            off = f"_clamp({sel}, {K} - 1).to(tl.int64) * R_PAD + r3"
            v = self.assign(self._load_expr(name + ".kv", off))
            return (self.assign(f"({sel} >= 0) & ({v} >= 0)"),), v, "i"
        if op == "cmp":
            (cop,) = n.meta
            da, va, ka = self.node(n.args[0])
            db, vb, kb = self.node(n.args[1])
            if cop not in ("==", "!=") and "b" in (ka, kb):
                # i1 compares are signed in LLVM (True < False); compare
                # bools as 0/1 integers like the reference does
                if ka == "b":
                    va = f"{va}.to(tl.int32)"
                if kb == "b":
                    vb = f"{vb}.to(tl.int32)"
            return _join(da, db), self.assign(f"{va} {cop} {vb}"), "b"
        if op in ("and", "or"):
            a = self.conj(self.fires(n.args[0]))
            b = self.conj(self.fires(n.args[1]))
            return (), self.assign(
                f"{a} {'&' if op == 'and' else '|'} {b}"), "b"
        if op == "not":
            a = self.conj(self.fires(n.args[0]))
            return (), self.assign(f"{a} == 0"), "b"
        if op in ("cset_not_subset_memb", "cset_subset_memb"):
            cname, mname = n.meta
            miss = self.missing_keys(cname + ".B", mname, elem=False)
            if op == "cset_subset_memb":
                miss = self.assign(f"{miss} == 0")
            return (), miss, "b"
        if op == "elem_keys_missing":
            cname, ekname = n.meta
            return (), self.missing_keys(cname + ".B", ekname, elem=True), "b"
        if op in ("any_e", "all_e", "count_e"):
            (axis,) = n.meta
            pres = self.load(f"__elem__:{axis}", "e")
            a = self.conj(self.fires(n.args[0]))
            if op == "any_e":
                x = pres if a == _ALWAYS else f"({a} & {pres})"
                return (), self.assign(f"tl.max({x}.to(tl.int32), axis=2)"
                                       f"[:, :, None] != 0"), "b"
            if op == "all_e":
                return (), self.assign(
                    f"tl.min(({a} | ({pres} == 0)).to(tl.int32), axis=2)"
                    f"[:, :, None] != 0"), "b"
            x = pres if a == _ALWAYS else f"({a} & {pres})"
            return (), self.assign(f"tl.sum({x}.to(tl.float32), axis=2)"
                                   f"[:, :, None]"), "f"
        if op == "arith":
            (aop,) = n.meta
            da, va, ka = self.node(n.args[0])
            db, vb, kb = self.node(n.args[1])
            d = _join(da, db)
            flt = "f" in (ka, kb) or aop == "/"
            if flt:
                if ka != "f":
                    va = f"{va}.to(tl.float32)"
                if kb != "f":
                    vb = f"{vb}.to(tl.float32)"
            if aop == "/":
                nz = self.assign(f"{vb} != 0")
                v = self.assign(f"_div_rn({va}, tl.where({nz}, {vb}, 1.0))")
                d = _join(d, (nz,))
            elif flt:
                fn = {"+": "_add_rn", "-": "_sub_rn", "*": "_mul_rn"}[aop]
                v = self.assign(f"{fn}({va}, {vb})")
            else:
                v = self.assign(f"{va} {aop} {vb}")
            return d, v, "f" if flt else "i"
        raise ValueError(f"unknown IR op {op!r}")

    def _rules(self) -> tuple[str | None, list[str]]:
        """Each rule's ANY over its element axis: the rules without a
        constraint-axis term ORed into one [1, BR] prologue value, the
        others one [BC, BR] body value each.  A rule's terms split
        three ways: row terms (its row-only conjuncts, the row parts of
        the others' defined-ness, its presence mask) are ANDed in the
        prologue; constraint-only terms are constant along R and E, so
        they are ANDed after the ANY, once per (c, r); only the rest is
        ANDed per (c, r, e) in the body (or, for one ordering compare,
        rewritten by :meth:`_extremum`)."""
        row_any, body_any = None, []
        for rule in self.p.rules:
            terms = ()
            for ci in rule.conjuncts:
                terms = _join(terms, self.fires(ci))
            if rule.elem_axis is not None:
                terms = _join(terms, (self.load(
                    f"__elem__:{rule.elem_axis}", "e"),))
            row = tuple(t for t in terms if t not in self.cvars)
            conly = tuple(t for t in terms if t in self.cvars
                          and self.vaxes.get(t, _ALL_AXES) <= {"c"})
            mixed = tuple(t for t in terms if t in self.cvars
                          and t not in conly)
            if len(mixed) == 1:
                row, mixed = self._extremum(row, mixed[0]) or (row, mixed)
            part = self.conj(row)
            if mixed:
                total = self.conj(_join((part,) if row else (), mixed))
                with self.section(True):
                    f = self.any_e(total)
            else:
                with self.section(False):
                    f = self.any_e(part)
                if not conly:
                    with self.section(False):
                        row_any = f if row_any is None else \
                            self.assign(f"{row_any} | {f}")
                    continue
            if conly:
                with self.section(True):
                    f = self.assign(f"{f} & {self.any_e(self.conj(conly))}")
            body_any.append(f)
        return row_any, body_any

    def _extremum(self, row: tuple, m: str):
        """For a rule whose one per-(c, r, e) term is an ordering compare
        ``x OP y`` of a row value x and a constraint-only value y: the ANY
        over E of (row terms & x_e OP y) is (some e passes the row terms,
        with x_e not NaN) & (max over those e of x_e) OP y for > and >=,
        the min for < and <= — exact, since a float conversion and the
        order are monotone and a NaN x_e passes no compare.  Returns the
        rule's new (row terms, per-(c, r) terms), or None where the rule
        is not of that form."""
        i = self.cmp_of.get(m)
        if i is None:
            return None
        (cop,) = self.p.nodes[i].meta
        a, b = self.p.nodes[i].args
        if cop not in _FLIP:
            return None
        if "c" not in self.axes[a] and self.axes[b] <= {"c"}:
            x, y = a, b
        elif "c" not in self.axes[b] and self.axes[a] <= {"c"}:
            x, y, cop = b, a, _FLIP[cop]
        else:
            return None
        _, vx, kx = self.node(x)
        _, vy, ky = self.node(y)
        if kx == "b":           # bools order as 0/1 (see the cmp node)
            vx, kx = f"{vx}.to(tl.int32)", "i"
        if ky == "b":
            vy = f"{vy}.to(tl.int32)"
        big = cop in (">", ">=")
        with self.section(False):
            part = self.conj(row)
            if kx == "f":
                ok = f"({vx} == {vx})"
                part = ok if part == _ALWAYS else \
                    self.assign(f"{part} & {ok}")
                sent = (f"tl.full([1, 1, 1], {-8388608 if big else 2139095040}"
                        f", tl.int32).to(tl.float32, bitcast=True)")
            else:
                sent = str(-2147483648 if big else 2147483647)
            some = self.assign(f"tl.max({part}.to(tl.int32), axis=2)"
                               f"[:, :, None] != 0")
            ext = self.assign(f"tl.{'max' if big else 'min'}(tl.where("
                              f"{part}, {vx}, {sent}), axis=2)[:, :, None]")
        with self.section(True):
            hit = self.assign(f"{ext} {cop} {vy}")
        return (some,), (hit,)

    def source(self) -> str:
        self.emit(f"{_ALWAYS} = tl.full([1, 1, 1], 1, tl.int1)")
        alive = self.load("__alive__", "r2")
        row_any, body_any = self._rules()
        cvalid = self.load("__cvalid__", "c2")
        with self.section(True):
            terms = body_any + ([row_any] if row_any else [])
            self.emit("viol = " + (" | ".join(terms) if terms
                                   else "tl.zeros([BC, BR], tl.int1)"))
            self.emit(f"viol = viol & {alive} & {cvalid}")
            off2 = "oc.to(tl.int64)[:, None] * R_PAD + r2"
            if "__match__" in self.sig:
                self.emit(f"viol = viol & {self._load_expr('__match__', off2)}")
            self.emit(f"tl.store(out + {off2}, viol.to(tl.uint8))")
        n = len(self.ptrs)
        params = ["out"] + [f"p{i}" for i in range(n)] \
            + ["rows", "R_PAD", "D", "SB_OUT"] + [f"sb{i}" for i in range(n)] \
            + [a for a, _, _ in self.ints] \
            + [f"{c}: tl.constexpr" for c in
               ("BC", "BR", "CPS", "SPLIT", "DELTA")] \
            + [f"{a}: tl.constexpr" for a, _, _ in self.consts]
        # D is a runtime value that Triton must not specialise on, so
        # every delta launch of one plan shares one compiled variant
        head = ["", "", '@triton.jit(do_not_specialize=["D"])',
                f"def ir_kernel({', '.join(params)}):"]
        # batched mode (B9): grid axis 2 is the cluster; every array and
        # the output advance by their per-cluster element count
        rebase = ["pid_b = tl.program_id(2).to(tl.int64)",
                  "out = out + pid_b * SB_OUT"] \
            + [f"p{i} = p{i} + pid_b * sb{i}" for i in range(n)]
        # grid axis 0: SPLIT programs per row tile, each over CPS
        # constraints from c_lo
        tile = ["pid = tl.program_id(0)",
                "pid_r = pid // SPLIT",
                "c_lo = (pid % SPLIT) * CPS",
                "R64 = R_PAD.to(tl.int64)",
                "if DELTA:",
                "    # row-index mode (K5): lane j evaluates row rows[j];",
                "    # lanes past D repeat the last one",
                "    j = pid_r * BR + tl.arange(0, BR)",
                "    orr = _clamp(tl.load(rows + tl.minimum(j, D - 1)), "
                "R_PAD - 1)",
                "else:",
                "    orr = tl.max_contiguous(tl.multiple_of(",
                "        pid_r * BR + tl.arange(0, BR), BR), BR)",
                "r3 = orr[None, :, None]",
                "r2 = orr[None, :]"]
        loop = ["for c0 in range(0, CPS, BC):",
                "    oc = c_lo + c0 + tl.arange(0, BC)",
                "    c3 = oc[:, None, None]",
                "    c2 = oc[:, None]"]
        lines = head + ["    " + x for x in rebase + tile + self.pro] \
            + ["    " + x for x in loop] \
            + ["        " + x for x in self.body]
        return _HELPERS + "\n".join(lines) + "\n"


def _join(a: tuple, b: tuple) -> tuple:
    """The terms of ``a`` and ``b``, each once, in order."""
    return tuple(dict.fromkeys(a + b))


_ALL_AXES = frozenset("cre")
_AXES_OF_LOAD = {"c": frozenset("c"), "c2": frozenset("c"),
                 "r": frozenset("r"), "r2": frozenset("r"),
                 "e": frozenset("re")}
_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}


def node_axes(program: Program) -> list[frozenset]:
    """Per node, the lattice axes its value varies along: 'c'
    (constraints), 'r' (rows), 'e' (elements).  A node without 'c'
    belongs to the row prologue."""
    out: list[frozenset] = []
    for i, n in enumerate(program.nodes):
        if any(a >= i for a in n.args):
            raise ValueError(f"IR node {i} reads a later node")
        args = frozenset().union(*(out[a] for a in n.args))
        op = n.op
        if op == "input":
            ax = {"c": "c", "r": "r", "e": "re"}[n.meta[1][0]]
        elif op in ("ptable_any", "ptable_all", "in_cset"):
            ax = args | {"c"}
        elif op in ("keyed_val", "cset_not_subset_memb", "cset_subset_memb"):
            ax = "cr"
        elif op == "elem_keys_missing":
            ax = "cre"
        elif op in ("any_e", "all_e", "count_e"):
            ax = (args - {"e"}) | {"r"}
        else:                   # const, table, dfa_match, cmp, arith, logic
            ax = args
        out.append(frozenset(ax))
    return out


def array_signature(arrays: dict, lead: int = 0) \
        -> dict[str, tuple[str, tuple]]:
    """name -> (dtype name, shape) for torch tensors or numpy arrays;
    ``lead`` leading (batch) dims are left out of the shape."""
    out = {}
    for nm, a in arrays.items():
        dt = str(a.dtype).replace("torch.", "")
        out[nm] = (dt, tuple(int(s) for s in a.shape[lead:]))
    return out


def emit_source(program: Program, sig: dict[str, tuple[str, tuple]]):
    """(source, emitter) of the Triton kernel for ``program`` over
    arrays with signature ``sig`` (see :func:`array_signature`).  Pure
    Python: importable and testable without triton."""
    em = _Emitter(program, sig)
    return em.source(), em


# ---------------------------------------------------------------------------
# tile plan

SMS = 132               # H100 SXM streaming multiprocessors
MIN_PROGRAMS = 2 * SMS  # a launch keeps two programs on every SM
ROW_POINTS = 1024       # lattice points of a [1, BR, E] prologue block
BODY_POINTS = 2048      # lattice points of a [BC, BR, E] body block
MIN_BR = 16             # a row run of the mask is one 16-byte store
NUM_WARPS = 4
DELTA_ROWS = 1024       # the row count every delta plan is made for


def _pow2_floor(x: int) -> int:
    return 1 << (max(int(x), 1).bit_length() - 1)


def tile_plan(c_pad: int, n_rows: int, e_max: int, n_b: int = 1,
              delta: bool = False) -> tuple[int, int, int, int]:
    """(BC, BR, SPLIT, num_warps) for a launch over ``n_b`` clusters of
    ``c_pad`` constraints and ``n_rows`` rows (R_pad in full mode, D in
    delta mode) with element blocks up to ``e_max`` wide.  Powers of
    two; in full mode BR divides R_pad, and BC * SPLIT divides C_pad
    in both.  Rows first: BR = ROW_POINTS / E (at most the rows), BC =
    BODY_POINTS / (BR * E); then, while the grid holds fewer than
    MIN_PROGRAMS programs, BR halves down to MIN_BR, the constraint
    loop splits across the grid, and BC halves."""
    e_max = max(int(e_max), 1)
    rows = _pow2_floor(n_rows) if not delta else \
        1 << max(int(n_rows) - 1, 0).bit_length()
    br = min(rows, _pow2_floor(max(ROW_POINTS // e_max, MIN_BR)))
    split = 1

    def programs():
        return n_b * -(-n_rows // br) * split

    while programs() < MIN_PROGRAMS and br > min(MIN_BR, rows):
        br //= 2
    bc = min(c_pad, _pow2_floor(max(BODY_POINTS // (br * e_max), 1)))
    while programs() < MIN_PROGRAMS:
        if bc * split < c_pad:
            split *= 2
        elif bc > 1:
            bc //= 2
        else:
            break
    return bc, br, split, NUM_WARPS


# ---------------------------------------------------------------------------
# launching

# _LOCK guards _KERNELS and _PLANS (re-entrant: a plan is made under it
# and makes its kernel under it); _COMPILE_LOCK serialises every launch
# through Triton's JIT launcher, which compiles a variant the first time
# and is not safe to run from two threads at once (the driver's
# delta-warmup thread compiles beside the sweep thread)
_LOCK = threading.RLock()
_COMPILE_LOCK = threading.Lock()
_KERNELS: dict[tuple, tuple] = {}
_PLANS: dict[tuple, "_Plan"] = {}


def _load_kernel(src: str):
    """Import the generated source from a file under the build directory
    (Triton's JIT reads a kernel's source through inspect, which needs a
    real file).  Triton's own compile cache stays wherever the process
    points it (``TRITON_CACHE_DIR``)."""
    digest = hashlib.sha256(src.encode()).hexdigest()[:20]
    gen_dir = os.path.join(build.build_dir(), "ir_eval")
    os.makedirs(gen_dir, exist_ok=True)
    path = os.path.join(gen_dir, f"k_{digest}.py")
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(src)
        os.replace(tmp, path)
    spec = importlib.util.spec_from_file_location(
        f"gatekeeper_tpu_torch_ir_k_{digest}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ir_kernel


def _variants(kern) -> int | None:
    """Variants Triton's JIT holds in memory for one kernel (None where
    this Triton keeps them elsewhere)."""
    caches = getattr(kern, "device_caches", None)
    if caches is not None:
        return sum(len(c[0]) for c in caches.values())
    if isinstance(getattr(kern, "cache", None), dict):
        return sum(len(c) for c in kern.cache.values())
    return None


def _kernel_for(program: Program, sig: dict[str, tuple[str, tuple]]):
    # the source unrolls over the key count of every cset ``.B``
    key = (program.cache_key(),
           tuple(sorted((nm, dt, sh[1] if nm.endswith(".B") else len(sh))
                        for nm, (dt, sh) in sig.items())))
    hit = _KERNELS.get(key)
    if hit is None:
        with _LOCK:
            hit = _KERNELS.get(key)
            if hit is None:
                src, em = emit_source(program, sig)
                hit = _KERNELS[key] = (_load_kernel(src), em.ptrs, em.ints,
                                       em.consts)
    return hit


class _Plan:
    """One launch's fixed part: the kernel, the arrays in argument
    order, the integer arguments after ``D``, the grid, the constexprs
    (``kw`` for the JIT launch; ``cvals`` their values in parameter
    order) and the compiled kernels it launched, by the 16-byte
    alignment of each pointer argument (``compiled``)."""

    __slots__ = ("program", "kern", "names", "r_pad", "tail", "grid", "kw",
                 "cvals", "compiled")

    def __init__(self, program, kern, names, r_pad, tail, grid, kw):
        self.program = program
        self.kern = kern
        self.names = names
        self.r_pad = r_pad
        self.tail = tail
        self.grid = grid
        self.kw = kw
        self.cvals = [v for k, v in kw.items() if k != "num_warps"]
        self.compiled: dict[tuple, object] = {}


def _make_plan(program: Program, arrays: dict, n_rows: int | None,
               what: str, batched: bool) -> _Plan:
    lead = 1 if batched else 0
    kern, ptrs, ints, consts = _kernel_for(program,
                                           array_signature(arrays, lead))
    c_pad = arrays["__cvalid__"].shape[lead]
    r_pad = arrays["__alive__"].shape[lead]
    n_b = arrays["__alive__"].shape[0] if batched else 1
    strides = []
    for nm in ptrs:
        t = arrays[nm]
        if batched and t.shape[0] != n_b:
            raise ValueError(f"{what}: {nm} has {t.shape[0]} clusters, "
                             f"__alive__ {n_b}")
        axes = binding_axes(nm)
        if "r" in axes and t.shape[lead + axes.index("r")] != r_pad:
            raise ValueError(f"{what}: {nm} has {tuple(t.shape)} but r_pad "
                             f"is {r_pad}")
        strides.append(t[0].numel() if batched else t.numel())
    sizes = [int(arrays[nm].shape[lead + d]) for _, nm, d in ints]
    cexpr = {a: int(arrays[nm].shape[lead + d]) for a, nm, d in consts}
    delta = n_rows is not None
    rows = n_rows if delta else r_pad
    # one delta plan for every row count, so a churn of another size
    # compiles nothing new; DELTA_ROWS is a 1% churn of 100,000 rows
    bc, br, split, warps = tile_plan(c_pad, DELTA_ROWS if delta else rows,
                                     max(cexpr.values(), default=1), n_b,
                                     delta)
    if c_pad % (bc * split) or (not delta and r_pad % br):
        raise ValueError(f"{what}: padded shape [{c_pad}, {r_pad}] is not a "
                         f"multiple of the tile [{bc * split}, {br}] (the "
                         f"prep pads every axis to a power of two)")
    grid = (-(-rows // br) * split, 1, n_b)
    kw = dict(BC=bc, BR=br, CPS=c_pad // split, SPLIT=split, DELTA=delta,
              num_warps=warps, **cexpr)
    return _Plan(program, kern, ptrs, r_pad,
                 [c_pad * r_pad] + strides + sizes, grid, kw)


_NO_ROWS: dict[torch.device, torch.Tensor] = {}


def _no_rows(dev: torch.device) -> torch.Tensor:
    """The int32 row vector a full launch passes (never read)."""
    t = _NO_ROWS.get(dev)
    if t is None:
        t = _NO_ROWS.setdefault(dev, torch.zeros((1,), dtype=torch.int32,
                                                 device=dev))
    return t


def _launch(program: Program, arrays: dict, out: torch.Tensor,
            rows: torch.Tensor | None, what: str, batched: bool = False):
    """One launch of the program's kernel into ``out`` [C_pad, R_pad]:
    every row (``rows`` None, full mode) or the rows ``rows`` (int32
    [d], delta mode).  With ``batched`` every array and ``out`` carry a
    leading cluster axis [N, ...] and the grid's third axis runs over
    it.  Each array's per-cluster element count is passed as its
    cluster stride in both modes, so an unbatched and a batched launch
    over equal per-cluster shapes pass equal arguments.

    The launch plan is cached on the device, program, mode, batching,
    row count and the arrays' names, dtypes and shapes, which fix every
    integer argument Triton specialises on; every call checks each
    array's device and contiguity.  A plan's first launch goes through
    Triton's JIT launcher, which compiles and specialises; a later one
    whose pointers have the same 16-byte alignment launches the
    compiled kernel that returned directly.  Returns the plan."""
    dev = out.device
    n_rows = None if rows is None else rows.shape[0]
    key = (dev, id(program), batched, n_rows,
           tuple([(nm, a.dtype, a.shape) for nm, a in arrays.items()]))
    plan = _PLANS.get(key)
    if plan is None or plan.program is not program:
        with _LOCK:
            plan = _PLANS.get(key)
            if plan is None or plan.program is not program:
                plan = _PLANS[key] = _make_plan(program, arrays, n_rows,
                                                what, batched)
    args = [out]
    on = -1 if dev.index is None else dev.index
    for nm in plan.names:
        t = arrays[nm]
        if t.get_device() != on or not t.is_contiguous():
            raise ValueError(f"{what}: {nm} must be a contiguous tensor on "
                             f"{dev}")
        args.append(t)
    if rows is None:
        rows, n_rows = _no_rows(dev), 0
    args.append(rows)
    aligned = tuple([t.data_ptr() % 16 == 0 for t in args])
    ck = plan.compiled.get(aligned)
    with build.on_device(dev):
        if ck is None:
            # the JIT launch compiles (or finds) the variant and launches
            # it; a thread that finds another compiling this plan's
            # variant waits for it and then launches what it compiled
            with _COMPILE_LOCK:
                ck = plan.compiled.get(aligned)
                if ck is None:
                    entries = compile_cache.triton_cache_entries()
                    v0 = _variants(plan.kern)
                    ck = plan.kern[plan.grid](*args, plan.r_pad, n_rows,
                                              *plan.tail, **plan.kw)
                    v1 = _variants(plan.kern)
                    if v0 is None or v1 is None or v1 > v0:
                        # a variant made ready: from Triton's disk cache
                        # when the compile left no new cache entry
                        compile_cache.persistent_cache_stats().note_triton(
                            compile_cache.triton_cache_entries() > entries)
                    if hasattr(ck, "__getitem__"):
                        plan.compiled[aligned] = ck
                    return plan
        ck[plan.grid](*args, plan.r_pad, n_rows, *plan.tail, *plan.cvals)
    return plan


def eval_mask(program: Program, arrays: dict) -> torch.Tensor:
    """bool [C_pad, R_pad] violation mask: K1 on CUDA tensors, the plain
    evaluator on CPU tensors.  ``arrays`` must already hold every
    ``<dfa>.devtab`` the program reads (the executor computes them with
    K3 first)."""
    dev = arrays["__alive__"].device
    if dev.type == "cpu":
        eval_mask.plain_calls += 1
        from gatekeeper_tpu_torch.engine.executor import _eval_mask
        return _eval_mask(program, arrays)
    if dev.type != "cuda":
        raise ValueError(f"eval_mask: unsupported device {dev}")
    c_pad = arrays["__cvalid__"].shape[0]
    r_pad = arrays["__alive__"].shape[0]
    out = torch.empty((c_pad, r_pad), dtype=torch.bool, device=dev)
    _launch(program, arrays, out, None, "eval_mask")
    eval_mask.launches += 1
    return out


eval_mask.launches = 0
eval_mask.plain_calls = 0


def delta_mask(program: Program, arrays: dict, viol_old: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
    """K5 (item B5, the reference's ``ProgramExecutor._delta_fn``): a
    copy of the stored mask ``viol_old`` [C_pad, R_pad] with the columns
    ``rows`` (int32 [d], each in [0, R_pad); duplicates allowed)
    re-evaluated over the current ``arrays``.  On CUDA tensors this is
    K1's kernel in row-index mode (``DELTA``, its own compiled variant
    of the program's kernel): its lanes address the full R_PAD-strided
    arrays at the dirty rows, so nothing is gathered into temporaries.
    Every delta launch of a program over arrays of one shape and
    alignment takes one variant, whatever its row count
    (:func:`warm_delta` compiles it ahead of the first churned sweep).
    On CPU tensors it is the plain gather / evaluate / ``index_copy_``
    (``engine/executor._delta_mask``)."""
    dev = arrays["__alive__"].device
    if dev.type == "cpu":
        delta_mask.plain_calls += 1
        from gatekeeper_tpu_torch.engine.executor import _delta_mask
        return _delta_mask(program, arrays, viol_old, rows)
    out = _delta_launch(program, arrays, viol_old, rows, "delta_mask")
    delta_mask.launches += 1
    return out


def _delta_launch(program: Program, arrays: dict, viol_old: torch.Tensor,
                  rows: torch.Tensor, what: str) -> torch.Tensor:
    dev = arrays["__alive__"].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    c_pad = arrays["__cvalid__"].shape[0]
    r_pad = arrays["__alive__"].shape[0]
    if viol_old.dtype != torch.bool or \
            tuple(viol_old.shape) != (c_pad, r_pad) or \
            viol_old.device != dev or not viol_old.is_contiguous():
        raise TypeError(f"{what}: viol_old must be a contiguous bool "
                        f"[{c_pad}, {r_pad}] tensor on {dev}")
    if rows.dtype != torch.int32 or rows.dim() != 1 or rows.shape[0] == 0 \
            or rows.device != dev or not rows.is_contiguous():
        raise TypeError(f"{what}: rows must be a non-empty contiguous "
                        f"1-d int32 tensor on {dev}")
    out = viol_old.clone()
    _launch(program, arrays, out, rows, what)
    return out


def warm_delta(program: Program, arrays: dict, viol_old: torch.Tensor,
               rows: torch.Tensor) -> None:
    """Compile the delta variant :func:`delta_mask` will take for
    ``program`` over ``arrays``: one real K5 launch, as the sweep makes
    it (into a copy of ``viol_old``, at the rows ``rows``), on the
    arrays' own tensors, since Triton specialises on each pointer's
    16-byte alignment as well as on shapes.  Waits for the launch, so
    the caller's references outlive it.  Counts in no launch counter:
    the executor's background warm-up calls it
    (``ProgramExecutor.prewarm_deltas``)."""
    out = _delta_launch(program, arrays, viol_old, rows, "warm_delta")
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(out.device))
    done.synchronize()
    del out


delta_mask.launches = 0
delta_mask.plain_calls = 0


def warm_mask(program: Program, arrays: dict) -> None:
    """Compile the full variant :func:`eval_mask` will take for
    ``program`` over ``arrays``: one real K1 launch into a scratch mask,
    on the arrays' own tensors, so the plan (keyed on the arrays' names,
    dtypes and shapes, in order) and the compiled kernel (keyed on each
    pointer's 16-byte alignment) are the ones the first sweep then
    finds.  Waits for the launch on CUDA, so the caller's references
    outlive it.  Counts in no launch counter: the driver's ingest warm
    calls it (``ProgramExecutor.prewarm_audit_exec``)."""
    dev = arrays["__alive__"].device
    c_pad = arrays["__cvalid__"].shape[0]
    r_pad = arrays["__alive__"].shape[0]
    out = torch.empty((c_pad, r_pad), dtype=torch.bool, device=dev)
    _launch(program, arrays, out, None, "warm_mask")
    if dev.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        done.synchronize()
    del out


def eval_mask_batched(program: Program, stacked: dict) -> torch.Tensor:
    """bool [N, C_pad, R_pad]: the violation masks of N clusters whose
    bindings are stacked along a leading cluster axis (item B9, the
    reference's ``whatif/fleet._mask_fn``, a ``jax.vmap`` of the
    evaluator).  On CUDA tensors one K1 launch covers every cluster
    (grid axis 2); on CPU tensors the plain evaluator runs per cluster
    on ``stacked[nm][i]`` (``engine/executor._eval_mask_batched``).
    ``stacked`` must already hold every ``<dfa>.devtab`` [N, T]."""
    dev = stacked["__alive__"].device
    if dev.type == "cpu":
        eval_mask_batched.plain_calls += 1
        from gatekeeper_tpu_torch.engine.executor import _eval_mask_batched
        return _eval_mask_batched(program, stacked)
    if dev.type != "cuda":
        raise ValueError(f"eval_mask_batched: unsupported device {dev}")
    n_b, r_pad = stacked["__alive__"].shape
    c_pad = stacked["__cvalid__"].shape[1]
    out = torch.empty((n_b, c_pad, r_pad), dtype=torch.bool, device=dev)
    _launch(program, stacked, out, None, "eval_mask_batched", batched=True)
    eval_mask_batched.launches += 1
    return out


eval_mask_batched.launches = 0
eval_mask_batched.plain_calls = 0
