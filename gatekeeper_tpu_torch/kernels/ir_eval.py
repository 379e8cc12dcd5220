"""K1: the IR evaluator as one generated Triton kernel per Program.

Replaces the JAX package's ``engine/veval.py`` ``_Evaluator._eval``,
``_eval_program`` and ``_eval_mask`` (item B1): XLA fused the jitted
evaluator on the TPU; on the H100 the port writes the fused pass itself.
:func:`emit_source` walks ``program.nodes`` and ``program.rules`` and
writes the source of one ``@triton.jit`` kernel; :func:`eval_mask`
launches it for CUDA tensors and runs the plain evaluator
(``engine/executor._eval_mask``) only for tensors on the CPU.

Kernel shape.  The grid is ``(C_pad / BC, R_pad / BR)``; a node's value
is a block of shape ``[BC|1, BR|1, E|1]`` (the reference's ``_to3``
lattice), with the element axis a ``tl.constexpr`` block equal to the
binding's padded width.  Gathers (``table``, ``ptable_*``, ``in_cset``,
``keyed_val``, ``dfa_match``) are loads at computed offsets, clamped as
XLA clamps them; the 0/1 products of ``cset_*_memb`` and
``elem_keys_missing`` are in-kernel integer counts over the small L/K
axis; float arithmetic uses round-to-nearest PTX (``add.rn`` ... and
``div.rn``) so neither FMA contraction nor Triton's approximate fp32
division can change a bit.  The epilogue applies ``__alive__`` and
``__cvalid__``, the ANY over E, the OR across rules and ``__match__``,
and stores one bool per (c, r): R is a grid axis, so there is no
``R_CHUNK`` scan.

K5, the churn delta (item B5, the reference's ``_delta_fn``), is the
same kernel in row-index mode: a runtime row vector ``rows`` of length
``D > 0`` replaces the tile's own rows, the grid's R axis runs over
``ceil(D / BR)`` tiles, and every r-axis load and the mask store address
the full ``R_PAD``-strided arrays at ``rows[j]``.  :func:`delta_mask`
launches it into a copy of the stored mask.  ``D`` is not specialised,
so one compiled kernel per program serves full and delta sweeps.

The fleet audit's batched evaluator (item B9, the reference's
``whatif/fleet.py`` ``_mask_fn`` and the evaluator inside ``_topk_fn``:
``jax.vmap`` over a leading cluster axis) is the same kernel again: grid
axis 2 runs over the N clusters, and every array pointer and the output
advance by ``pid_b`` times their per-cluster element count, a runtime
argument (``sb<i>``, ``SB_OUT``).  :func:`eval_mask_batched` launches it
once for all N clusters.  Unbatched launches pass the same per-cluster
counts with ``pid_b`` 0, so over equal per-cluster shapes the two modes
take one compiled kernel (Triton specialises an integer argument only on
being 1 or a multiple of 16, and equal counts agree on both).

Bound on the H100: bytes.  The pass must read each bound column once
and write the [C_pad, R_pad] mask once (one byte per pair); arithmetic
is a few integer compares per pair.  The design keeps every
intermediate in registers (nothing but the mask is written) and re-reads
the r-axis columns once per constraint tile, from L2.

Kernels are cached by ``program.cache_key()`` plus the bound arrays'
names, dtypes and ranks; Triton specialises each on the element widths.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import threading

import numpy as np
import torch

from gatekeeper_tpu_torch.ir.prep import binding_axes
from gatekeeper_tpu_torch.ir.program import Program
from gatekeeper_tpu_torch.kernels import build

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
    """Writes the kernel source for one (program, array signature)."""

    def __init__(self, program: Program, sig: dict[str, tuple[str, tuple]]):
        self.p = program
        self.sig = sig                       # name -> (dtype, shape)
        self.lines: list[str] = []
        self.ptrs: list[str] = []            # array names, in arg order
        self.ints: list[tuple[str, str, int]] = []   # (arg, array, dim)
        self.consts: list[tuple[str, str, int]] = []  # constexpr dims
        self.loaded: dict[tuple, str] = {}
        self.vals: dict[int, tuple[str, str, str, bool]] = {}
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

    def fresh(self) -> str:
        self.tmp += 1
        return f"t{self.tmp}"

    def emit(self, line: str) -> None:
        self.lines.append("    " + line)

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
        """A bound array as a block: 'c' -> [BC,1,1], 'r' -> [1,BR,1],
        'e' -> [1,BR,E]."""
        key = (name, axes)
        hit = self.loaded.get(key)
        if hit is not None:
            return hit
        if axes == "c":
            off = "c3"
        elif axes == "r":
            off = "r3"
        elif axes == "e":
            E = self.edim(name, 1)
            off = f"r3 * {E} + tl.arange(0, {E})[None, None, :]"
        else:
            raise ValueError(axes)
        var = self.fresh()
        self.emit(f"{var} = {self._load_expr(name, off)}")
        self.loaded[key] = var
        return var

    def gather(self, name: str, idx: str) -> str:
        """name[clamp(idx, 0, len - 1)] for a 1-d array."""
        n = self.dim(name, 0)
        var = self.fresh()
        self.emit(f"{var} = {self._load_expr(name, f'_clamp({idx}, {n} - 1)')}")
        return var

    # -- values: (d, v, kind, has_c); d may be _ALWAYS
    def node(self, i: int):
        hit = self.vals.get(i)
        if hit is None:
            hit = self.vals[i] = self._node(i)
        return hit

    def fires(self, i: int) -> str:
        d, v, k, _ = self.node(i)
        if k == "b":
            return v if d == _ALWAYS else self.band(d, v)
        return d

    def band(self, a: str, b: str) -> str:
        if a == _ALWAYS:
            return b
        if b == _ALWAYS:
            return a
        var = self.fresh()
        self.emit(f"{var} = {a} & {b}")
        return var

    def _node(self, i: int):
        n = self.p.nodes[i]
        op = n.op
        if op == "const":
            value, dtype = n.meta
            dt = np.dtype(dtype).name
            var = self.fresh()
            if dt == "bool":
                lit = "1" if bool(value) else "0"
            elif dt.startswith("float"):
                f = float(np.float32(value))
                if not np.isfinite(f):
                    raise ValueError(f"non-finite IR constant {value!r}")
                lit = repr(f)
            else:
                lit = repr(int(value))
            self.emit(f"{var} = tl.full([1, 1, 1], {lit}, {_TL_DT[dt]})")
            return _ALWAYS, var, _kind_of(dt), False
        if op == "input":
            name, kind = n.meta
            axes = kind[0]
            has_c = axes == "c"
            if kind.endswith("_num"):
                v = self.load(name + ".v", axes)
                d = self.load(name + ".p", axes)
                return d, v, self.kind(name + ".v"), has_c
            v = self.load(name, axes)
            if kind.endswith("_id"):
                d = self.fresh()
                self.emit(f"{d} = {v} >= 0")
                return d, v, "i", has_c
            return _ALWAYS, v, "b", has_c
        if op == "table":
            (tname,) = n.meta
            d_i, idx, _, has_c = self.node(n.args[0])
            ci = self.fresh()
            self.emit(f"{ci} = tl.maximum({idx}, 0)")
            ok = self.gather(tname + ".ok", ci)
            val = self.gather(tname + ".v", ci)
            return self.band(d_i, ok), val, self.kind(tname + ".v"), has_c
        if op == "dfa_match":
            (dname,) = n.meta
            d_i, idx, _, has_c = self.node(n.args[0])
            ci = self.fresh()
            self.emit(f"{ci} = tl.maximum({idx}, 0)")
            v = self.gather(dname + ".devtab", ci)
            return self.band(d_i, v), v, "b", has_c
        if op in ("ptable_any", "ptable_all", "in_cset"):
            if op == "in_cset":
                (cname,) = n.meta
                vmap, tbl = cname + ".vmap", cname + ".bitmap"
            else:
                tname, _ = n.meta
                vmap = tname + ".vmap"
                tbl = tname + (".any" if op == "ptable_any" else ".all")
            d_i, idx, _, has_c = self.node(n.args[0])
            if has_c and op != "in_cset":
                # the reference reads tbl[:, u[0]] — constraint 0's ids
                raise ValueError(f"{op}: per-constraint index operand is "
                                 f"not supported by the K1 emitter")
            T = self.dim(vmap, 0)
            U = self.dim(tbl, 1)
            u = self.fresh()
            self.emit(f"{u} = tl.where(({idx} >= 0) & ({idx} < {T}), "
                      f"{self._load_expr(vmap, f'_clamp({idx}, {T} - 1)')}, "
                      f"{U} - 1)")
            v = self.fresh()
            self.emit(f"{v} = {self._load_expr(tbl, f'c3 * {U} + _clamp({u}, {U} - 1)')}")
            return d_i, v, "b", True
        if op == "keyed_val":
            (name,) = n.meta
            sel = self.load(name + ".sel", "c")
            K = self.dim(name + ".kv", 0)
            v = self.fresh()
            off = f"_clamp({sel}, {K} - 1).to(tl.int64) * R_PAD + r3"
            self.emit(f"{v} = {self._load_expr(name + '.kv', off)}")
            d = self.fresh()
            self.emit(f"{d} = ({sel} >= 0) & ({v} >= 0)")
            return d, v, "i", True
        if op == "cmp":
            (cop,) = n.meta
            da, va, ka, ca = self.node(n.args[0])
            db, vb, kb, cb = self.node(n.args[1])
            if cop not in ("==", "!=") and "b" in (ka, kb):
                # i1 compares are signed in LLVM (True < False); compare
                # bools as 0/1 integers like the reference does
                if ka == "b":
                    va = f"{va}.to(tl.int32)"
                if kb == "b":
                    vb = f"{vb}.to(tl.int32)"
            v = self.fresh()
            self.emit(f"{v} = {va} {cop} {vb}")
            return self.band(da, db), v, "b", ca or cb
        if op in ("and", "or"):
            a = self.fires(n.args[0])
            b = self.fires(n.args[1])
            ca = self.node(n.args[0])[3] or self.node(n.args[1])[3]
            v = self.fresh()
            self.emit(f"{v} = {a} {'&' if op == 'and' else '|'} {b}")
            return _ALWAYS, v, "b", ca
        if op == "not":
            a = self.fires(n.args[0])
            v = self.fresh()
            self.emit(f"{v} = {a} == 0")
            return _ALWAYS, v, "b", self.node(n.args[0])[3]
        if op in ("cset_not_subset_memb", "cset_subset_memb"):
            cname, mname = n.meta
            B, memb = cname + ".B", mname
            L = self.dim(B, 1)
            miss = self.fresh()
            self.emit(f"{miss} = tl.zeros([BC, BR, 1], tl.int32)")
            self.emit(f"for l in range(0, {L}):")
            self.emit(f"    {miss} += ({self._load_expr(B, f'c3 * {L} + l')}"
                      f" & ({self._load_expr(memb, 'l.to(tl.int64) * R_PAD + r3')}"
                      f" == 0)).to(tl.int32)")
            v = self.fresh()
            cmp = ">" if op == "cset_not_subset_memb" else "=="
            self.emit(f"{v} = {miss} {cmp} 0")
            return _ALWAYS, v, "b", True
        if op == "elem_keys_missing":
            cname, ekname = n.meta
            B = cname + ".B"
            K = self.dim(B, 1)
            E = self.edim(ekname, 2)
            miss = self.fresh()
            self.emit(f"{miss} = tl.zeros([BC, BR, {E}], tl.int32)")
            self.emit(f"for k in range(0, {K}):")
            off = (f"k.to(tl.int64) * R_PAD * {E} + r3 * {E} "
                   f"+ tl.arange(0, {E})[None, None, :]")
            self.emit(f"    {miss} += ({self._load_expr(B, f'c3 * {K} + k')}"
                      f" & ({self._load_expr(ekname, off)} == 0))"
                      f".to(tl.int32)")
            v = self.fresh()
            self.emit(f"{v} = {miss} > 0")
            return _ALWAYS, v, "b", True
        if op in ("any_e", "all_e", "count_e"):
            (axis,) = n.meta
            pres = self.load(f"__elem__:{axis}", "e")
            a = self.fires(n.args[0])
            has_c = self.node(n.args[0])[3]
            v = self.fresh()
            if op == "any_e":
                x = pres if a == _ALWAYS else f"({a} & {pres})"
                self.emit(f"{v} = tl.max({x}.to(tl.int32), axis=2)"
                          f"[:, :, None] != 0")
                return _ALWAYS, v, "b", has_c
            if op == "all_e":
                self.emit(f"{v} = tl.min(({a} | ({pres} == 0)).to(tl.int32),"
                          f" axis=2)[:, :, None] != 0")
                return _ALWAYS, v, "b", has_c
            x = pres if a == _ALWAYS else f"({a} & {pres})"
            self.emit(f"{v} = tl.sum({x}.to(tl.float32), axis=2)[:, :, None]")
            return _ALWAYS, v, "f", has_c
        if op == "arith":
            (aop,) = n.meta
            da, va, ka, ca = self.node(n.args[0])
            db, vb, kb, cb = self.node(n.args[1])
            d = self.band(da, db)
            v = self.fresh()
            flt = "f" in (ka, kb) or aop == "/"
            if flt:
                if ka != "f":
                    va = f"{va}.to(tl.float32)"
                if kb != "f":
                    vb = f"{vb}.to(tl.float32)"
            if aop == "/":
                nz = self.fresh()
                self.emit(f"{nz} = {vb} != 0")
                d = self.band(d, nz)
                self.emit(f"{v} = _div_rn({va}, tl.where({nz}, {vb}, 1.0))")
            elif flt:
                fn = {"+": "_add_rn", "-": "_sub_rn", "*": "_mul_rn"}[aop]
                self.emit(f"{v} = {fn}({va}, {vb})")
            else:
                self.emit(f"{v} = {va} {aop} {vb}")
            return d, v, "f" if flt else "i", ca or cb
        raise ValueError(f"unknown IR op {op!r}")

    def source(self) -> str:
        self.emit("pid_c = tl.program_id(0)")
        self.emit("pid_r = tl.program_id(1)")
        self.emit("oc = pid_c * BC + tl.arange(0, BC)")
        self.emit("j = pid_r * BR + tl.arange(0, BR)")
        # row-index mode (K5): with D > 0 the tile's lanes evaluate the
        # rows rows[j] (lanes past D repeat the last one), else row j
        self.emit("dj = tl.load(rows + tl.minimum(j, D - 1), "
                  "mask=(j >= 0) & (D > 0), other=0)")
        self.emit("orr = tl.where(D > 0, _clamp(dj, R_PAD - 1), j)")
        self.emit("c3 = oc[:, None, None]")
        self.emit("r3 = orr[None, :, None]")
        self.emit(f"{_ALWAYS} = tl.full([1, 1, 1], 1, tl.int1)")
        alive = self.load("__alive__", "r")
        cvalid = self.load("__cvalid__", "c")
        self.emit("viol = tl.zeros([BC, BR], tl.int1)")
        for rule in self.p.rules:
            total = _ALWAYS
            for ci in rule.conjuncts:
                total = self.band(total, self.fires(ci))
            total = self.band(self.band(total, alive), cvalid)
            if rule.elem_axis is not None:
                pres = self.load(f"__elem__:{rule.elem_axis}", "e")
                total = self.band(total, pres)
            self.emit(f"viol = viol | (tl.max({total}.to(tl.int32), axis=2)"
                      f" != 0)")
        off2 = "oc.to(tl.int64)[:, None] * R_PAD + orr[None, :]"
        if "__match__" in self.sig:
            self.emit(f"viol = viol & {self._load_expr('__match__', off2)}")
        self.emit(f"tl.store(out + {off2}, viol.to(tl.uint8))")
        n = len(self.ptrs)
        params = ["out"] + [f"p{i}" for i in range(n)] \
            + ["rows", "R_PAD", "D", "SB_OUT"] + [f"sb{i}" for i in range(n)] \
            + [a for a, _, _ in self.ints] \
            + ["BC: tl.constexpr", "BR: tl.constexpr"] \
            + [f"{a}: tl.constexpr" for a, _, _ in self.consts]
        # D is a runtime value that Triton must not specialise on, so
        # full and delta launches share one compiled kernel
        head = ["", "", '@triton.jit(do_not_specialize=["D"])',
                f"def ir_kernel({', '.join(params)}):"]
        # batched mode (B9): grid axis 2 is the cluster; every array and
        # the output advance by their per-cluster element count
        rebase = ["    pid_b = tl.program_id(2).to(tl.int64)",
                  "    out = out + pid_b * SB_OUT"] \
            + [f"    p{i} = p{i} + pid_b * sb{i}" for i in range(n)]
        return _HELPERS + "\n".join(head + rebase + self.lines) + "\n"


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
# launching

_LOCK = threading.Lock()
_KERNELS: dict[tuple, tuple] = {}


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


def _kernel_for(program: Program, sig: dict[str, tuple[str, tuple]]):
    key = (program.cache_key(),
           tuple(sorted((nm, dt, len(sh)) for nm, (dt, sh) in sig.items())))
    hit = _KERNELS.get(key)
    if hit is None:
        with _LOCK:
            hit = _KERNELS.get(key)
            if hit is None:
                src, em = emit_source(program, sig)
                hit = _KERNELS[key] = (_load_kernel(src), em.ptrs, em.ints,
                                       em.consts)
    return hit


def tile_shape(c_pad: int, r_pad: int, e_max: int) -> tuple[int, int]:
    """(BC, BR): powers of two dividing the padded axes, about 2048
    lattice points per program."""
    bc = min(c_pad, 16 if e_max <= 4 else 8)
    br = min(r_pad, max(16, 2048 // (bc * e_max)))
    return bc, br


_NO_ROWS: dict[torch.device, torch.Tensor] = {}


def _no_rows(dev: torch.device) -> torch.Tensor:
    """The int32 row vector a full launch passes (D = 0 never reads it)."""
    t = _NO_ROWS.get(dev)
    if t is None:
        t = _NO_ROWS[dev] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return t


def _launch(program: Program, arrays: dict, out: torch.Tensor,
            rows: torch.Tensor | None, what: str,
            batched: bool = False) -> None:
    """One launch of the program's kernel into ``out`` [C_pad, R_pad]:
    every row (``rows`` None) or the rows ``rows`` (int32 [d]).  With
    ``batched`` every array and ``out`` carry a leading cluster axis
    [N, ...] and the grid's third axis runs over it.  Each array's
    per-cluster element count is passed as its cluster stride in both
    modes, so an unbatched and a batched launch over equal per-cluster
    shapes pass equal arguments and share one compiled kernel."""
    dev = out.device
    lead = 1 if batched else 0
    kern, ptrs, ints, consts = _kernel_for(program,
                                           array_signature(arrays, lead))
    c_pad = arrays["__cvalid__"].shape[lead]
    r_pad = arrays["__alive__"].shape[lead]
    n_b = arrays["__alive__"].shape[0] if batched else 1
    args, strides = [], []
    for nm in ptrs:
        t = arrays[nm]
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: {nm} must be a contiguous tensor on "
                             f"{dev}")
        if batched and t.shape[0] != n_b:
            raise ValueError(f"{what}: {nm} has {t.shape[0]} clusters, "
                             f"__alive__ {n_b}")
        axes = binding_axes(nm)
        if "r" in axes and t.shape[lead + axes.index("r")] != r_pad:
            raise ValueError(f"{what}: {nm} has {t.shape} but r_pad is "
                             f"{r_pad}")
        args.append(t.view(torch.uint8) if t.dtype == torch.bool else t)
        strides.append(t[0].numel() if batched else t.numel())
    sizes = [int(arrays[nm].shape[lead + d]) for _, nm, d in ints]
    cexpr = {a: int(arrays[nm].shape[lead + d]) for a, nm, d in consts}
    e_max = max(cexpr.values(), default=1)
    bc, br = tile_shape(c_pad, r_pad, e_max)
    if c_pad % bc or r_pad % br:
        raise ValueError(f"{what}: padded shape [{c_pad}, {r_pad}] is not a "
                         f"multiple of the tile [{bc}, {br}] (the prep pads "
                         f"every axis to a power of two)")
    if rows is None:
        n_rows, rows = 0, _no_rows(dev)
        grid = (c_pad // bc, r_pad // br, n_b)
    else:
        n_rows = rows.shape[0]
        grid = (c_pad // bc, -(-n_rows // br), n_b)
    with torch.cuda.device(dev):
        kern[grid](out.view(torch.uint8), *args, rows, r_pad, n_rows,
                   c_pad * r_pad, *strides, *sizes, BC=bc, BR=br,
                   num_warps=4, **cexpr)


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
    K1's kernel in row-index mode: its lanes address the full
    R_PAD-strided arrays at the dirty rows, so nothing is gathered into
    temporaries, and full and delta sweeps share one compiled kernel.
    On CPU tensors it is the plain gather / evaluate / ``index_copy_``
    (``engine/executor._delta_mask``)."""
    dev = arrays["__alive__"].device
    if dev.type == "cpu":
        delta_mask.plain_calls += 1
        from gatekeeper_tpu_torch.engine.executor import _delta_mask
        return _delta_mask(program, arrays, viol_old, rows)
    if dev.type != "cuda":
        raise ValueError(f"delta_mask: unsupported device {dev}")
    c_pad = arrays["__cvalid__"].shape[0]
    r_pad = arrays["__alive__"].shape[0]
    if viol_old.dtype != torch.bool or \
            tuple(viol_old.shape) != (c_pad, r_pad) or \
            viol_old.device != dev or not viol_old.is_contiguous():
        raise TypeError(f"delta_mask: viol_old must be a contiguous bool "
                        f"[{c_pad}, {r_pad}] tensor on {dev}")
    if rows.dtype != torch.int32 or rows.dim() != 1 or rows.shape[0] == 0 \
            or rows.device != dev or not rows.is_contiguous():
        raise TypeError(f"delta_mask: rows must be a non-empty contiguous "
                        f"1-d int32 tensor on {dev}")
    out = viol_old.clone()
    _launch(program, arrays, out, rows, "delta_mask")
    delta_mask.launches += 1
    return out


delta_mask.launches = 0
delta_mask.plain_calls = 0


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
