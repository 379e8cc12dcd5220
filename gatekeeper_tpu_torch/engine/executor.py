"""PyTorch evaluation of vectorized programs (port of the JAX package's
engine/veval.py audit path).

The plain IR evaluator here (:class:`_Evaluator`, :func:`_eval_program`,
:func:`_eval_mask`) is the torch-ops version of the reference's jitted
evaluator, op for op: every node yields ``(defined, value)`` over the
broadcast ``[C, R, E]`` lattice, a rule fires where every conjunct is
defined and truthy, the element axis is reduced existentially under its
presence mask, rules are ORed and the match mask ANDed.

:class:`ProgramExecutor` keeps the reference's public surface (``run``,
``run_async``, ``run_topk``, ``run_topk_async``, ``stage_uploads``) and
its identity-keyed device cache.  On CUDA tensors it calls the port's
hand-written kernels — K1 (``kernels/ir_eval.py``, the IR evaluator),
K2 (``kernels/topk.py``, count + top-k) and K3 (``kernels/dfa.py``, the
regex byte scan); on CPU tensors the same wrappers run the plain
versions.  A steady sweep over unchanged bindings only reduces: the
stored violation mask is reused (``_viol_plan`` "reduce").  Churned
bindings are re-uploaded and re-evaluated whole ("full"); the
reference's dirty-row delta plan is not part of this port yet.
"""

from __future__ import annotations

import numpy as np
import torch

from gatekeeper_tpu_torch.ir.prep import _STR_PREFIX, Bindings, binding_axes
from gatekeeper_tpu_torch.ir.program import Node, Program
from gatekeeper_tpu_torch.kernels import dfa as _dfa
from gatekeeper_tpu_torch.kernels import ir_eval as _ir_eval
from gatekeeper_tpu_torch.kernels import topk as _topk
from gatekeeper_tpu_torch.kernels.topk import topk_reduce  # noqa: F401
from gatekeeper_tpu_torch.utils.device import resolve_device

_3D = (1, 1, 1)

# dtypes of IR constants (ir/lower.py emits these names)
DTYPES = {"float32": torch.float32, "int32": torch.int32,
          "bool": torch.bool}


def _widen(a: torch.Tensor) -> torch.Tensor:
    """Narrow-transferred id columns (_put ships int8/int16) back to
    int32, as the reference's _widen_args does at executable entry."""
    if a.dtype in (torch.int8, torch.int16):
        return a.to(torch.int32)
    return a


def _fires(dv: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """defined & truthy; only False and undefined fail in Rego."""
    d, v = dv
    if v.dtype == torch.bool:
        return d & v
    return d


def _to3(a: torch.Tensor, axes: str) -> torch.Tensor:
    """Reshape a bound array into the canonical [C, R, E] lattice."""
    if axes == "c":
        return a.reshape(a.shape[0], 1, 1)
    if axes == "r":
        return a.reshape(1, a.shape[0], 1)
    if axes == "e":
        return a.reshape(1, a.shape[0], a.shape[1])
    raise ValueError(axes)


def _ones(like: torch.Tensor) -> torch.Tensor:
    return torch.ones(like.shape, dtype=torch.bool, device=like.device)


def _gather1(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[idx] with indices clamped into range — XLA's gather clamps
    out-of-bounds indices, torch indexing raises on them."""
    return arr[idx.to(torch.int64).clamp(0, arr.shape[0] - 1)]


def _dfa_device_table(arrays: dict, dname: str) -> torch.Tensor:
    """Per-interned-id regex verdicts [t_pad] bool (plain version; the
    executor's CUDA path runs K3 through kernels/dfa.dfa_table)."""
    return _dfa.dfa_table_plain(
        arrays[dname + ".trans"], arrays[dname + ".accept"],
        arrays["__strbytes__"], arrays["__strdfaok__"],
        arrays[dname + ".xv"], len(_STR_PREFIX))


def dfa_names(program: Program) -> list[str]:
    return sorted({n.meta[0] for n in program.nodes if n.op == "dfa_match"})


def _with_dfa_tables(program: Program, d: dict, table_fn) -> dict:
    """Every ``dfa_match`` verdict table computed once per evaluation,
    into a copy of the arrays dict keyed ``<name>.devtab``."""
    names = dfa_names(program)
    if not names:
        return d
    d = dict(d)
    for nm in names:
        if nm + ".devtab" not in d:
            d[nm + ".devtab"] = table_fn(
                d[nm + ".trans"], d[nm + ".accept"], d["__strbytes__"],
                d["__strdfaok__"], d[nm + ".xv"], len(_STR_PREFIX))
    return d


class _Evaluator:
    def __init__(self, program: Program, arrays: dict[str, torch.Tensor]):
        self.p = program
        self.arrays = {k: _widen(v) for k, v in arrays.items()}
        self.device = next(iter(arrays.values())).device
        self.cache: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self.dfa_memo: dict[str, torch.Tensor] = {}

    def _dfa_devtab(self, dname: str) -> torch.Tensor:
        tab = self.arrays.get(dname + ".devtab")
        if tab is None:
            tab = self.dfa_memo.get(dname)
            if tab is None:
                tab = self.dfa_memo[dname] = _dfa_device_table(self.arrays,
                                                               dname)
        return tab

    def node(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        hit = self.cache.get(i)
        if hit is None:
            hit = self.cache[i] = self._eval(self.p.nodes[i])
        return hit

    def _eval(self, n: Node) -> tuple[torch.Tensor, torch.Tensor]:
        op = n.op
        A = self.arrays
        if op == "const":
            value, dtype = n.meta
            v = torch.tensor(value, dtype=DTYPES[str(dtype)],
                             device=self.device)
            return (torch.ones(_3D, dtype=torch.bool, device=self.device),
                    v.reshape(_3D))
        if op == "input":
            name, kind = n.meta
            axes = kind[0]
            if kind.endswith("_num"):
                return _to3(A[name + ".p"], axes), _to3(A[name + ".v"], axes)
            if kind.endswith("_id"):
                v = _to3(A[name], axes)
                return v >= 0, v
            v = _to3(A[name], axes)  # bool
            return _ones(v), v
        if op == "table":
            (tname,) = n.meta
            d_i, idx = self.node(n.args[0])
            ci = idx.clamp(min=0)
            ok = _gather1(A[tname + ".ok"], ci)
            val = _gather1(A[tname + ".v"], ci)
            return d_i & ok, val
        if op == "dfa_match":
            (dname,) = n.meta
            d_i, idx = self.node(n.args[0])
            v = _gather1(self._dfa_devtab(dname), idx.clamp(min=0))
            return d_i & v, v
        if op in ("ptable_any", "ptable_all"):
            tname, _ = n.meta
            d_i, idx = self.node(n.args[0])
            vmap = A[tname + ".vmap"]
            tbl = A[tname + (".any" if op == "ptable_any" else ".all")]
            sentinel = tbl.shape[1] - 1
            in_rng = (idx >= 0) & (idx < vmap.shape[0])
            u = torch.where(in_rng, _gather1(vmap, idx),
                            torch.tensor(sentinel, dtype=vmap.dtype,
                                         device=self.device))
            u0 = u[0].to(torch.int64).clamp(0, tbl.shape[1] - 1)
            v = tbl[:, u0]                                 # [C, R, E]
            return d_i & _ones(v), v
        if op == "keyed_val":
            (name,) = n.meta
            kv = A[name + ".kv"]                           # [K, R]
            sel = A[name + ".sel"]                         # [C]
            picked = _gather1(kv, sel.clamp(min=0))        # [C, R]
            v = picked[:, :, None]
            d = (sel >= 0)[:, None, None] & (v >= 0)
            return d, v
        if op == "cmp":
            (cop,) = n.meta
            da, va = self.node(n.args[0])
            db, vb = self.node(n.args[1])
            d = da & db
            if cop == "==":
                v = va == vb
            elif cop == "!=":
                v = va != vb
            elif cop == "<":
                v = va < vb
            elif cop == "<=":
                v = va <= vb
            elif cop == ">":
                v = va > vb
            else:
                v = va >= vb
            return d, v
        if op == "and":
            a = _fires(self.node(n.args[0]))
            b = _fires(self.node(n.args[1]))
            return _ones(a & b), a & b
        if op == "or":
            a = _fires(self.node(n.args[0]))
            b = _fires(self.node(n.args[1]))
            return _ones(a | b), a | b
        if op == "not":
            a = _fires(self.node(n.args[0]))
            return _ones(a), ~a
        if op == "in_cset":
            (cname,) = n.meta
            d_i, idx = self.node(n.args[0])
            vmap = A[cname + ".vmap"]                      # [T] -> dense u
            bitmap = A[cname + ".bitmap"]                  # [C, U]
            sentinel = bitmap.shape[1] - 1
            in_rng = (idx >= 0) & (idx < vmap.shape[0])
            u = torch.where(in_rng, _gather1(vmap, idx),
                            torch.tensor(sentinel, dtype=vmap.dtype,
                                         device=self.device))
            u = u.to(torch.int64).clamp(0, sentinel)
            if u.shape[0] == 1:
                v = bitmap[:, u[0]]                        # [C, R, E]
            else:
                c, r, e = u.shape
                v = torch.gather(bitmap, 1, u.reshape(c, r * e)) \
                    .reshape(c, r, e)
            return d_i & _ones(v), v
        if op in ("cset_not_subset_memb", "cset_subset_memb"):
            # miss[c, r] = |{l : B[c, l] & ~memb[l, r]}|, a float32
            # product of 0/1 operands (exact while L < 2^24; TF32 is
            # off by default for float32 matmul and exact on 0/1 too)
            cname, mname = n.meta
            memb = A[mname]                                # [L, R]
            B = A[cname + ".B"]                            # [C, L]
            miss = B.to(torch.float32) @ (~memb).to(torch.float32)
            if op == "cset_not_subset_memb":
                v = (miss > 0.5)[:, :, None]
            else:
                v = (miss < 0.5)[:, :, None]
            return _ones(v), v
        if op == "elem_keys_missing":
            cname, ekname = n.meta
            ekm = A[ekname]                                # [K, R, E]
            B = A[cname + ".B"]                            # [C, K]
            k, r, e = ekm.shape
            miss = B.to(torch.float32) @ \
                (~ekm).reshape(k, r * e).to(torch.float32)
            v = (miss > 0.5).reshape(B.shape[0], r, e)
            return _ones(v), v
        if op in ("any_e", "all_e", "count_e"):
            (axis,) = n.meta
            pres = A[f"__elem__:{axis}"][None]             # [1, R, E]
            a = _fires(self.node(n.args[0]))
            if op == "any_e":
                v = (a & pres).any(dim=2, keepdim=True)
                return _ones(v), v
            if op == "all_e":
                v = (a | ~pres).all(dim=2, keepdim=True)
                return _ones(v), v
            v = (a & pres).to(torch.float32).sum(dim=2, keepdim=True)
            return _ones(v), v
        if op == "arith":
            (aop,) = n.meta
            da, va = self.node(n.args[0])
            db, vb = self.node(n.args[1])
            d = da & db
            if aop == "+":
                v = va + vb
            elif aop == "-":
                v = va - vb
            elif aop == "*":
                v = va * vb
            else:
                d = d & (vb != 0)
                v = va / torch.where(vb == 0, torch.ones_like(vb), vb)
            return d, v
        raise ValueError(f"unknown IR op {op!r}")


def _eval_program(program: Program, arrays: dict[str, torch.Tensor]) \
        -> torch.Tensor:
    """-> violation mask [C, R] bool (padded), gated by "__match__"
    when that input is bound."""
    ev = _Evaluator(program, arrays)
    alive = arrays["__alive__"][None, :, None]
    cvalid = arrays["__cvalid__"][:, None, None]
    viol = None
    for rule in program.rules:
        total = None
        for ci in rule.conjuncts:
            f = _fires(ev.node(ci))
            total = f if total is None else total & f
        if total is None:
            total = torch.ones(_3D, dtype=torch.bool, device=ev.device)
        total = total & alive & cvalid
        if rule.elem_axis is not None:
            pres = arrays[f"__elem__:{rule.elem_axis}"][None]
            fired = (total & pres).any(dim=2)
        else:
            fired = total.any(dim=2)
        viol = fired if viol is None else viol | fired
    c_pad = arrays["__cvalid__"].shape[0]
    r_pad = arrays["__alive__"].shape[0]
    if viol is None:
        viol = torch.zeros((c_pad, r_pad), dtype=torch.bool,
                           device=ev.device)
    else:
        viol = viol.expand(c_pad, r_pad)
    match = arrays.get("__match__")
    if match is not None:
        viol = viol & match
    return viol.contiguous()


R_CHUNK = 1 << 15
"""Rows per plain-evaluation chunk: above this the plain evaluator runs
slice by slice so its [C, R(, E)] intermediates stay bounded in host
memory.  The result does not depend on it (K1 has R as a grid axis)."""


def _slice_r(name: str, arr: torch.Tensor, off: int, rc: int):
    axes = binding_axes(name)
    if "r" not in axes:
        return arr
    return arr.narrow(axes.index("r"), off, rc)


def _eval_mask(program: Program, d: dict[str, torch.Tensor]) -> torch.Tensor:
    """Plain full violation mask [C, R], chunked over R when large."""
    d = _with_dfa_tables(program, d, _dfa.dfa_table_plain)
    r_pad = d["__alive__"].shape[0]
    if r_pad <= R_CHUNK or r_pad % R_CHUNK:
        return _eval_program(program, d)
    parts = [_eval_program(program, {nm: _slice_r(nm, a, off, R_CHUNK)
                                     for nm, a in d.items()})
             for off in range(0, r_pad, R_CHUNK)]
    return torch.cat(parts, dim=1)


def pad_rank(rank: np.ndarray, r_pad: int) -> np.ndarray:
    """Pad a [n_rows] rank array to [r_pad] with r_pad - 1, so padded
    rows can never outscore live ones in the r_pad - rank score."""
    pr = np.full((r_pad,), r_pad - 1, dtype=np.int32)
    pr[: rank.shape[0]] = rank
    return pr


class _Pending:
    """In-flight device result; ``.block()`` waits for the device,
    ``.get()`` copies to the host."""

    def __init__(self, value: torch.Tensor):
        self._value = value
        self._event = None
        if value.device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(value.device))

    def block(self):
        if self._event is not None:
            self._event.synchronize()
        return self


class PendingMask(_Pending):
    """In-flight full violation mask (see run_async)."""

    def __init__(self, mask, n_constraints: int, n_resources: int):
        super().__init__(mask)
        self._nc = n_constraints
        self._nr = n_resources

    def get(self) -> np.ndarray:
        return self._value[: self._nc, : self._nr].cpu().numpy()


class PendingTopK(_Pending):
    """In-flight packed top-k result (see run_topk_async)."""

    def __init__(self, packed, n_constraints: int, k: int):
        super().__init__(packed)
        self._nc = n_constraints
        self._k = k

    def get(self):
        p = self._value[: self._nc].cpu().numpy()
        counts = p[:, 0]
        rows = p[:, 1: 1 + self._k]
        valid = p[:, 1 + self._k:].astype(bool)
        return counts, rows, valid


class ProgramExecutor:
    """Device executor: per-Bindings device arrays, stored violation
    masks, and the K1/K2/K3 dispatch.  ``device`` defaults to CUDA."""

    def __init__(self, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        # H2D accounting: bytes staged through _put (read per sweep as
        # deltas by the driver)
        self.h2d_bytes = 0
        self.mask_evals = 0      # full-mask evaluations (K1 or plain)
        self.reduces = 0         # count + top-k reductions (K2 or plain)

    # ------------------------------------------------------------------
    # uploads

    def _put(self, name: str, host: np.ndarray) -> torch.Tensor:
        """Upload one array.  int32 arrays of 2^16+ elements whose values
        fit ship as int8/int16 (the evaluator widens at use), like the
        reference's narrow transfer."""
        self.h2d_bytes += int(host.nbytes)
        if host.dtype == np.int32 and host.size >= (1 << 16):
            lo = int(host.min())
            hi = int(host.max())
            for dt in (np.int8, np.int16):
                info = np.iinfo(dt)
                if info.min <= lo and hi <= info.max:
                    host = host.astype(dt)
                    self.h2d_bytes += int(host.nbytes) - \
                        int(host.size * 4)
                    break
        t = torch.from_numpy(np.ascontiguousarray(host))
        # always a copy: host buffers are recycled in place by the
        # driver's bindings ping-pong, device arrays must not alias them
        return t.to(self.device, copy=True)

    def _arrays(self, bindings: Bindings, match: np.ndarray | None,
                rank: np.ndarray | None = None) -> dict[str, torch.Tensor]:
        """Device-resident view of the bindings, memoized per array name
        on the Bindings instance (identity-keyed): steady-state audits
        re-run without re-uploading columns."""
        caches = bindings.__dict__.setdefault("_device_caches", {})
        cache = caches.setdefault(id(self), {})
        arrays: dict[str, torch.Tensor] = {}
        for name, host in bindings.arrays.items():
            hit = cache.get(name)
            if hit is None or hit[0] is not host:
                cache[name] = hit = (host, self._put(name, host))
            arrays[name] = hit[1]
        if match is not None and "__match__" not in bindings.arrays:
            hit = cache.get("__match__")
            if hit is None or hit[0] is not match:
                padded = np.zeros((bindings.c_pad, bindings.r_pad),
                                  dtype=bool)
                padded[: match.shape[0], : match.shape[1]] = match
                cache["__match__"] = hit = (match,
                                            self._put("__match__", padded))
            arrays["__match__"] = hit[1]
        if rank is not None and "__rank__" not in bindings.arrays:
            hit = cache.get("__rank__")
            if hit is None or hit[0] is not rank:
                cache["__rank__"] = hit = (
                    rank, self._put("__rank__",
                                    pad_rank(rank, bindings.r_pad)))
            arrays["__rank__"] = hit[1]
        return arrays

    def stage_uploads(self, bindings: Bindings) -> None:
        """Enqueue every binding array upload now, so the later dispatch
        finds them in the per-bindings device cache."""
        self._arrays(bindings, None, None)

    # ------------------------------------------------------------------
    # evaluation

    def _full_mask(self, program: Program, arrays: dict) -> torch.Tensor:
        """[C, R] bool mask: K3 for every regex table, then K1 (CUDA) —
        or their plain versions on the CPU."""
        self.mask_evals += 1
        d = _with_dfa_tables(program, arrays, _dfa.dfa_table)
        return _ir_eval.eval_mask(program, d)

    def _viol_key(self, program: Program) -> tuple:
        return (id(self), program.cache_key())

    def _viol_plan(self, program: Program, bindings: Bindings,
                   arrays: dict) -> tuple:
        """('reduce', viol) when a mask stored for exactly these device
        arrays exists, else ('full',)."""
        hit = bindings.__dict__.get("_viol_masks", {}).get(
            self._viol_key(program))
        if hit is not None:
            sig, viol = hit
            if len(sig) == len(arrays) and \
                    all(arrays.get(nm) is dev for nm, dev in sig.items()):
                return ("reduce", viol)
        return ("full",)

    def _store_viol(self, program: Program, bindings: Bindings,
                    arrays: dict, viol) -> None:
        bindings.__dict__.setdefault("_viol_masks", {})[
            self._viol_key(program)] = (dict(arrays), viol)

    def _viol_mask_dev(self, program: Program, bindings: Bindings,
                       arrays: dict) -> torch.Tensor:
        plan = self._viol_plan(program, bindings, arrays)
        if plan[0] == "reduce":
            return plan[1]
        viol = self._full_mask(program, arrays)
        self._store_viol(program, bindings, arrays, viol)
        return viol

    def run_async(self, program: Program, bindings: Bindings,
                  match: np.ndarray | None = None,
                  rank: np.ndarray | None = None) -> PendingMask:
        """Dispatch a full-mask evaluation without blocking; .get()
        yields the mask trimmed to [n_constraints, n_resources]."""
        arrays = self._arrays(bindings, match, rank)
        mask = self._viol_mask_dev(program, bindings, arrays)
        return PendingMask(mask, bindings.n_constraints,
                           bindings.n_resources)

    def run(self, program: Program, bindings: Bindings,
            match: np.ndarray | None = None,
            rank: np.ndarray | None = None) -> np.ndarray:
        return self.run_async(program, bindings, match, rank).get()

    def run_topk_async(self, program: Program, bindings: Bindings, k: int,
                       match: np.ndarray | None = None,
                       rank: np.ndarray | None = None) -> PendingTopK:
        """Dispatch evaluate + count/top-k without blocking; .get()
        yields (counts [C], rows [C, k], valid [C, k]) trimmed to the
        live constraint count."""
        arrays = self._arrays(bindings, match, rank)
        viol = self._viol_mask_dev(program, bindings, arrays)
        self.reduces += 1
        rnk = arrays.get("__rank__")
        if rnk is not None:
            rnk = _widen(rnk)
        packed = _topk.topk_packed(viol, rnk, k)
        return PendingTopK(packed, bindings.n_constraints, k)

    def run_topk(self, program: Program, bindings: Bindings, k: int,
                 match: np.ndarray | None = None,
                 rank: np.ndarray | None = None):
        return self.run_topk_async(program, bindings, k, match, rank).get()
