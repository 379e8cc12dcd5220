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
its identity-keyed device cache.  ``run_topk_batched`` and
``run_mask_batched`` evaluate N clusters' stacked bindings in one
launch per kernel, for the fleet audit (whatif/fleet.py, item B9).
On CUDA tensors it calls the port's
hand-written kernels — K1 (``kernels/ir_eval.py``, the IR evaluator),
K2 (``kernels/topk.py``, count + top-k), K3 (``kernels/dfa.py``, the
regex byte scan), K4 (``kernels/scatter.py``, the dirty-row scatter),
K5 (``kernels/ir_eval.delta_mask``, the dirty-row evaluation), K6
(``kernels/devdelta.py``, the devpages delta of ``eval_mask_delta``) and
K7 (``kernels/invjoin.py``, the inventory join that ``eval_mask_delta``
runs first); on CPU tensors the same wrappers run the plain versions.

The violation mask stays on the device across sweeps (``_viol_plan``):
a sweep over unchanged bindings only reduces ("reduce"); bindings that
``update_bindings`` derived from a base under churn migrate the base's
device arrays by row scatter (``_migrate``, K4) and re-evaluate only
the dirty rows into a copy of the base's stored mask ("delta", K5);
anything else evaluates whole ("full", K1).
"""

from __future__ import annotations

import atexit
import threading
import time

import numpy as np
import torch

from gatekeeper_tpu_torch.ir.prep import (_STR_PREFIX, Bindings,
                                          binding_axes, bucket,
                                          inv_join_binding_names)
from gatekeeper_tpu_torch.ir.program import Node, Program
from gatekeeper_tpu_torch.kernels import devdelta as _devdelta
from gatekeeper_tpu_torch.kernels import dfa as _dfa
from gatekeeper_tpu_torch.kernels import invjoin as _invjoin
from gatekeeper_tpu_torch.kernels import ir_eval as _ir_eval
from gatekeeper_tpu_torch.kernels import scatter as _scatter
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


def _r_axis(name: str) -> int | None:
    """Which dim of a bound array is the resource axis (None if none)."""
    axes = binding_axes(name)
    return axes.index("r") if "r" in axes else None


def _slice_r(name: str, arr: torch.Tensor, off: int, rc: int):
    ax = _r_axis(name)
    if ax is None:
        return arr
    return arr.narrow(ax, off, rc)


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


def _eval_mask_batched(program: Program,
                       stacked: dict[str, torch.Tensor]) -> torch.Tensor:
    """Plain [N, C, R]: :func:`_eval_mask` per cluster, on each stacked
    array's slice ``[i]`` (the padded stacked form, not the cluster's own
    arrays: padding moves gather clamps and edge columns, and only the
    stacked form is what the reference's vmap evaluates)."""
    n = stacked["__alive__"].shape[0]
    return torch.stack([_eval_mask(program, {nm: a[i] for nm, a
                                             in stacked.items()})
                        for i in range(n)])


def _delta_mask(program: Program, d: dict[str, torch.Tensor],
                viol_old: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain churn delta (the reference's ``_delta_fn``): gather the rows
    ``rows`` of every r-axis array, evaluate them as [C, d], and write
    them into a copy of the stored mask ``viol_old``.  Duplicate rows
    carry equal values."""
    d = _with_dfa_tables(program, d, _dfa.dfa_table_plain)
    idx = rows.to(torch.int64)
    sliced = {}
    for nm, a in d.items():
        ax = _r_axis(nm)
        sliced[nm] = a if ax is None else a.index_select(ax, idx)
    sub = _eval_program(program, sliced)
    return viol_old.clone().index_copy_(1, idx, sub)


def explain(program: Program, bindings: Bindings, ci: int, row: int,
            match: np.ndarray | None = None) -> str:
    """Mask dump for one (constraint, resource) pair: every IR node's
    (defined, value) on the [1, 1(, E)] slice, plus each rule's conjunct
    verdicts and the match-mask gate: the vectorized engine's analogue
    of the scalar tracer.  The reference runs its device evaluator on
    the sliced bindings; K1 is one fused kernel that exposes no node's
    value, so this runs the plain evaluator, whose mask K1 equals."""
    matched = True if match is None else bool(match[ci, row])
    sliced: dict[str, torch.Tensor] = {}
    for nm, arr in bindings.arrays.items():
        a = np.asarray(arr)
        for d, ax in enumerate(binding_axes(nm)):
            if ax == "r":
                a = np.take(a, [row], axis=d)
            elif ax == "c":
                a = np.take(a, [ci], axis=d)
        sliced[nm] = torch.from_numpy(np.ascontiguousarray(a))
    ev = _Evaluator(program, sliced)
    lines = [f"explain constraint={ci} row={row}"]
    for i, n in enumerate(program.nodes):
        try:
            d, v = ev.node(i)
        except KeyError as e:
            lines.append(f"  n{i:<3} {n.op:<22} <missing binding {e}>")
            continue
        dv = d.numpy().ravel()
        vv = v.numpy().ravel()
        show = vv if vv.size <= 8 else vv[:8]
        lines.append(f"  n{i:<3} {n.op:<22} meta={n.meta!r} "
                     f"defined={bool(dv.all())} value={show.tolist()}")
    for ri, rule in enumerate(program.rules):
        # elementwise AND of conjuncts, reduced exactly like
        # _eval_program (existential over the presence-masked E axis)
        total = None
        verdicts = []
        for cix in rule.conjuncts:
            f = _fires(ev.node(cix))
            verdicts.append(
                f"n{cix}={f.numpy().ravel().astype(int).tolist()}")
            total = f if total is None else total & f
        if total is None:
            fired = True
        else:
            total = total & sliced["__alive__"][None, :, None] \
                & sliced["__cvalid__"][:, None, None]
            if rule.elem_axis is not None:
                pres = sliced[f"__elem__:{rule.elem_axis}"][None]
                fired = bool((total & pres).any())
            else:
                fired = bool(total.any())
        fired = fired and matched
        lines.append(f"  rule{ri} axis={rule.elem_axis or '-'} "
                     f"conjuncts[{' '.join(verdicts)}] -> "
                     f"{'FIRES' if fired else 'no'}")
    lines.insert(1, "  match gate: " + (
        "matched" if matched else "NOT matched (constraint match criteria "
        "exclude this resource)"))
    return "\n".join(lines)


def pad_rows(rows: np.ndarray) -> np.ndarray:
    """``rows`` padded to a power-of-two bucket of at least 8 by
    repeating its first row, so each kernel shape recurs across sweeps
    (a duplicate write stores the same value)."""
    b = bucket(max(len(rows), 1), minimum=8)
    return np.concatenate([rows, np.full((b - len(rows),),
                                         rows[0] if len(rows) else 0,
                                         dtype=rows.dtype)])


# -- background compile threads (the reference's ``spawn_bg`` and its
# process-exit drain, ``engine/veval.py``): a Triton compile must not be
# in flight while the interpreter tears down, so every thread that can
# compile is joined at exit; BG_SHUTDOWN tells it to stop between items
BG_SHUTDOWN = threading.Event()
BG_DRAIN_SECONDS = 120.0
_BG_LOCK = threading.Lock()
_BG_THREADS: list[threading.Thread] = []
_bg_drain_registered = False


def _drain_bg() -> None:
    BG_SHUTDOWN.set()
    deadline = time.monotonic() + BG_DRAIN_SECONDS
    with _BG_LOCK:
        threads = list(_BG_THREADS)
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))


def spawn_bg(target, name: str) -> threading.Thread:
    """Start ``target`` on a daemon thread named ``name`` that the
    process-exit drain joins (registered at the first spawn)."""
    global _bg_drain_registered
    t = threading.Thread(target=target, name=name, daemon=True)
    with _BG_LOCK:
        _BG_THREADS[:] = [x for x in _BG_THREADS if x.is_alive()]
        _BG_THREADS.append(t)
        if not _bg_drain_registered:
            _bg_drain_registered = True
            atexit.register(_drain_bg)
    t.start()
    return t


def _zero_devtab(trans, accept, strbytes, ok, xv, prefix) -> torch.Tensor:
    """A regex verdict table of K3's shape and type (bool [U]), all
    False: what a warm-up launch reads in place of K3's output."""
    return torch.zeros((strbytes.shape[0],), dtype=torch.bool,
                       device=strbytes.device)


MIGRATE_DEPTH = 8
"""Longest bindings lineage ``_migrate`` walks back for device copies;
past it the generation uploads whole."""


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
    masks, and the K1-K5 dispatch.  ``device`` defaults to CUDA."""

    def __init__(self, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        # H2D accounting, read per sweep as deltas by the driver: bytes
        # staged whole through _put, and the row-sized records (values
        # plus int32 row ids) and padded row counts that _scatter_rows
        # ships instead of whole columns
        self.h2d_bytes = 0
        self.h2d_scatter_bytes = 0
        self.h2d_scatter_rows = 0
        self.mask_evals = 0      # full-mask evaluations (K1 or plain)
        self.delta_evals = 0     # dirty-row evaluations (K5 or plain)
        self.reduces = 0         # count + top-k reductions (K2 or plain)
        # full masks of N stacked clusters an under-filled fleet cap
        # widens to (run_mask_batched)
        self.batched_mask_evals = 0
        # the reference's executable-cache accounting, kept for the
        # devpages delta's ("devdelta", ...) key only: the first call at
        # a key counts a compile, later ones a hit (K6 takes k at run
        # time and compiles nothing itself)
        self.compiles = 0
        self.cache_hits = 0
        self._devdelta_keys: set = set()
        # Stage-7 retrace sentinel (analysis/compilesurface.py): the
        # driver's ``_surface_guard``, asked at the first launch of each
        # signature (program, mode, the arrays' names, dtypes and
        # shapes, devpages delta width) before anything compiles;
        # ``retrace_uncertified`` counts the signatures it found outside
        # the certificate
        self.surface_guard = None
        self.retrace_uncertified = 0
        self._launched: set = set()
        self._sig_lock = threading.Lock()

    def reset_for_recovery(self, bindings_list) -> None:
        """Forget the device arrays and stored violation masks this
        executor left on each of ``bindings_list``, after a backend
        recovery (resilience/supervisor.py): a later dispatch over them
        uploads and evaluates afresh.  The kernel modules stay loaded:
        the CUDA context is the same one."""
        for b in bindings_list:
            caches = b.__dict__.get("_device_caches")
            if caches is not None:
                caches.pop(id(self), None)
            masks = b.__dict__.get("_viol_masks")
            if masks is not None:
                for key in [k for k in masks if k[0] == id(self)]:
                    del masks[key]
        self._devdelta_keys = set()

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
        return self._upload(host)

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(host))
        # always a copy: host buffers are recycled in place by the
        # driver's bindings ping-pong, device arrays must not alias them
        return t.to(self.device, copy=True)

    def _scatter_rows(self, name: str, dev: torch.Tensor, host: np.ndarray,
                      rows: np.ndarray, axis: int | None = None) \
            -> torch.Tensor:
        """New device array: ``dev`` with ``rows`` along the resource
        axis (or ``axis``: the id axis of append-only interner tables)
        replaced by the host's values.  Ships O(|dirty|) bytes instead of
        the whole column; the write is K4 (``scatter_rows``)."""
        (out,) = self._scatter_many([(name, dev, host, rows, axis)],
                                    batched=False)
        return out

    def _scatter_many(self, specs: list, batched: bool = True) \
            -> list[torch.Tensor]:
        """:meth:`_scatter_rows` of each ``(name, dev, host, rows, axis)``
        in ``specs``, in one K4 call (``scatter_rows_many``, or
        ``scatter_rows`` for one spec when not ``batched``).  Every
        array's padded int32 row ids and values go up in one packed
        host-to-device copy, each at a 16-byte aligned offset.  A
        narrow-transferred column (``_put``) scatters narrow while the
        new values fit, else re-uploads whole (the interner outgrowing
        the narrow range), as the reference's does."""
        out: list = [None] * len(specs)
        staged = []          # (index in out, dev, rows32, vals, axis)
        for i, (name, dev, host, rows, axis) in enumerate(specs):
            ax = _r_axis(name) if axis is None else axis
            rows = pad_rows(rows)
            idx = [slice(None)] * host.ndim
            idx[ax] = rows
            vals = np.ascontiguousarray(host[tuple(idx)])
            if torch.from_numpy(vals).dtype != dev.dtype:
                if dev.dtype in (torch.int8, torch.int16) and vals.size and \
                        torch.iinfo(dev.dtype).min <= int(vals.min()) and \
                        int(vals.max()) <= torch.iinfo(dev.dtype).max:
                    vals = vals.astype(np.int8 if dev.dtype == torch.int8
                                       else np.int16)
                else:
                    out[i] = self._put(name, host)
                    continue
            rows32 = rows.astype(np.int32)
            self.h2d_scatter_bytes += int(vals.nbytes) + int(rows32.nbytes)
            self.h2d_scatter_rows += int(len(rows))
            staged.append((i, dev, rows32, vals, ax))
        if not staged:
            return out
        offsets, end = [], 0
        for _i, _dev, rows32, vals, _ax in staged:
            at_rows = end
            at_vals = -(-(at_rows + rows32.nbytes) // 16) * 16
            end = -(-(at_vals + vals.nbytes) // 16) * 16
            offsets.append((at_rows, at_vals))
        packed = np.empty((end,), dtype=np.uint8)
        for (at_rows, at_vals), (_i, _dev, rows32, vals, _ax) in zip(
                offsets, staged):
            packed[at_rows: at_rows + rows32.nbytes] = rows32.view(np.uint8)
            packed[at_vals: at_vals + vals.nbytes] = \
                vals.reshape(-1).view(np.uint8)
        up = self._upload(packed)
        jobs = [(dev, up[at_rows: at_rows + rows32.nbytes].view(torch.int32),
                 up[at_vals: at_vals + vals.nbytes].view(dev.dtype)
                 .view(vals.shape), ax)
                for (at_rows, at_vals), (_i, dev, rows32, vals, ax)
                in zip(offsets, staged)]
        if batched:
            news = _scatter.scatter_rows_many(jobs)
        else:
            news = [_scatter.scatter_rows(*job) for job in jobs]
        for (i, *_rest), new in zip(staged, news):
            out[i] = new
        return out

    def _migrate(self, bindings: Bindings, depth: int = 0) -> dict:
        """Per-name device cache for ``bindings``, seeded from its delta
        base when present: unchanged arrays keep their device copies,
        dirty arrays are row-scattered on the device (all of them in one
        K4 call), and only new arrays are uploaded whole (by
        ``_arrays``).  Then the lineage is cut, so a bindings generation
        and its device arrays and stored masks live only as long as the
        driver holds it."""
        caches = bindings.__dict__.setdefault("_device_caches", {})
        cache = caches.get(id(self))
        if cache is not None:
            return cache
        base = bindings.base
        base_dirty = bindings.base_dirty
        append_rows = bindings.base_append_rows or {}
        arrays = bindings.arrays
        cache = {}
        if base is not None and depth < MIGRATE_DEPTH:
            base_cache = self._migrate(base, depth + 1)
            specs = []
            for name, (href, dev) in base_cache.items():
                cur = arrays.get(name)
                if cur is None:
                    continue
                if cur is href:
                    cache[name] = (href, dev)
                elif cur.shape != dev.shape \
                        or href is not base.arrays.get(name):
                    continue
                elif name in base_dirty:
                    cache[name] = None
                    specs.append((name, dev, cur, base_dirty[name], None))
                elif name in append_rows and len(append_rows[name]):
                    # append-only interner-indexed array: only the newly
                    # interned id rows differ from the device copy
                    cache[name] = None
                    specs.append((name, dev, cur, append_rows[name], 0))
            for spec, new in zip(specs, self._scatter_many(specs)):
                cache[spec[0]] = (spec[2], new)
        cache = caches.setdefault(id(self), cache)
        bindings.base = None
        bindings.base_dirty = {}
        bindings.base_append_rows = {}
        return cache

    def _arrays(self, bindings: Bindings, match: np.ndarray | None,
                rank: np.ndarray | None = None) -> dict[str, torch.Tensor]:
        """Device-resident view of the bindings, memoized per array name
        on the Bindings instance (identity-keyed): steady-state audits
        re-run without re-uploading columns, and bindings derived by
        update_bindings migrate their base's device arrays by row
        scatter."""
        cache = self._migrate(bindings)
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
        finds them in the per-bindings device cache.  It migrates (and
        so cuts the lineage), so a dispatch after it takes the full
        plan, as the reference's forced full sweeps do."""
        self._arrays(bindings, None, None)

    # ------------------------------------------------------------------
    # the Stage-7 sentinel

    def _guard_miss(self, mode: str, program: Program, arrays: dict,
                    delta_k: int | None = None) -> None:
        """Stage-7 sentinel, called before every launch of ``program``
        over ``arrays`` (``<dfa>.devtab`` verdict tables, derived from
        the bindings, are left out of the signature).  The first launch
        of a signature asks ``surface_guard``: warn mode counts and
        records (the driver's guard does both) and lets the launch go
        on and compile its variant; strict mode refuses it with
        ``UncertifiedRetrace`` before K3 or K1 runs or anything
        compiles, and the signature stays unlaunched, so every later
        attempt is refused too.  A later launch of a launched signature
        asks nothing."""
        arrays = {nm: a for nm, a in arrays.items()
                  if not nm.endswith(".devtab")}
        key = (mode, program.cache_key(), delta_k,
               tuple((nm, str(arrays[nm].dtype), tuple(arrays[nm].shape))
                     for nm in sorted(arrays)))
        with self._sig_lock:
            if key in self._launched:
                return
        guard = self.surface_guard
        ok = True
        if guard is not None:
            try:
                ok = guard(program, arrays, delta_k)
            except Exception:   # noqa: BLE001 — the sentinel must never
                ok = True       # take a legitimate launch down
        if not ok:
            with self._sig_lock:
                self.retrace_uncertified += 1
            from gatekeeper_tpu_torch.analysis import compilesurface as _cs
            if _cs.mode() == "strict":
                shapes = {nm: tuple(int(d) for d in arrays[nm].shape)
                          for nm in sorted(arrays)}
                raise _cs.UncertifiedRetrace(
                    f"launch signature outside the certified compile "
                    f"surface (strict mode refuses the retrace): "
                    f"shapes={shapes}, delta_k={delta_k}")
        with self._sig_lock:
            self._launched.add(key)

    # ------------------------------------------------------------------
    # evaluation

    def _full_mask(self, program: Program, arrays: dict) -> torch.Tensor:
        """[C, R] bool mask: K3 for every regex table, then K1 (CUDA) —
        or their plain versions on the CPU."""
        self._guard_miss("mask", program, arrays)
        self.mask_evals += 1
        d = _with_dfa_tables(program, arrays, _dfa.dfa_table)
        return _ir_eval.eval_mask(program, d)

    def _delta_eval(self, program: Program, arrays: dict,
                    viol_old: torch.Tensor, rows: torch.Tensor) \
            -> torch.Tensor:
        """The stored mask with ``rows`` re-evaluated: K3 over the whole
        string table (as the reference's delta program does), then K5 —
        or their plain versions on the CPU."""
        self._guard_miss("delta", program, arrays)
        self.delta_evals += 1
        d = _with_dfa_tables(program, arrays, _dfa.dfa_table)
        return _ir_eval.delta_mask(program, d, viol_old, rows)

    def prewarm_deltas(self, program: Program, bindings: Bindings) -> bool:
        """Compile K5, the delta variant of ``program``'s kernel, ahead of
        the first churned sweep (the reference's ``prewarm_deltas``):
        one real delta launch into a scratch copy of the mask a sweep
        stored on ``bindings``, over the very device arrays that sweep
        read, with regex verdict tables of K3's shape (zeros: the
        scratch mask is thrown away) and 8 dirty rows.  One launch
        covers every churn size: the row count is a runtime argument
        and every delta plan has one tile plan.  Counts nothing
        (``delta_evals``, ``delta_mask.launches``) and runs no K3.
        Returns False, having launched nothing, on the CPU or when no
        sweep stored a mask on ``bindings``."""
        if self.device.type != "cuda":
            return False
        hit = bindings.__dict__.get("_viol_masks", {}).get(
            self._viol_key(program))
        if hit is None:
            return False
        sig, viol = hit
        d = _with_dfa_tables(program, dict(sig), _zero_devtab)
        rows = torch.zeros((8,), dtype=torch.int32, device=viol.device)
        _ir_eval.warm_delta(program, d, viol, rows)
        return True

    def audit_warm_arrays(self, program: Program, bindings: Bindings,
                          k: int | None = None,
                          with_match: bool = False,
                          extra: dict | None = None) -> dict:
        """The arrays the first sweep's K1 launch over ``bindings`` will
        pass, in its order: the bindings' own device arrays (``_arrays``,
        which stages their uploads into the per-bindings cache the sweep
        then reuses), then a zero ``__match__`` bool [C_pad, R_pad] when
        ``with_match`` and a zero ``__rank__`` int32 [R_pad] when ``k``
        is given, as the driver's ``_install_gates`` appends them, then a
        zero bool array of each shape in ``extra`` (name -> shape: the
        shared columns a dedup rewrite reads), then a zero
        ``<dfa>.devtab`` of K3's shape per regex table.  The plan of
        ``ir_eval._launch`` keys on these names, dtypes and shapes, and
        its compiled kernel on their 16-byte alignment."""
        arrays = self._arrays(bindings, None, None)
        dev = arrays["__alive__"].device
        if with_match and "__match__" not in arrays:
            arrays["__match__"] = torch.zeros(
                (bindings.c_pad, bindings.r_pad), dtype=torch.bool,
                device=dev)
        if k is not None and "__rank__" not in arrays:
            arrays["__rank__"] = torch.zeros((bindings.r_pad,),
                                             dtype=torch.int32, device=dev)
        for nm, shape in (extra or {}).items():
            if nm not in arrays:
                arrays[nm] = torch.zeros(shape, dtype=torch.bool, device=dev)
        return _with_dfa_tables(program, arrays, _zero_devtab)

    def prewarm_audit_exec(self, program: Program, bindings: Bindings,
                           k: int | None = None,
                           with_match: bool = False,
                           extra: dict | None = None) -> bool:
        """Compile K1's full variant for ``bindings`` ahead of the first
        sweep (the reference's ``prewarm_audit_exec``): one uncounted
        launch into a scratch mask over :meth:`audit_warm_arrays`, from a
        background thread at ingest.  Then load K2 (when ``k`` is given)
        and, for a program with regex tables, K3, so no ``nvcc`` build or
        library load lands inside the first sweep either (the
        counterpart of the reference's ``prewarm_reduce``).  Counts
        nothing (``mask_evals``, ``eval_mask.launches``) and stores no
        mask on ``bindings``.  Returns False, having launched nothing, on
        the CPU.  The signature goes through the Stage-7 sentinel first,
        as a sweep's launch would."""
        if self.device.type != "cuda":
            return False
        arrays = self.audit_warm_arrays(program, bindings, k, with_match,
                                        extra)
        self._guard_miss("mask", program, arrays)
        _ir_eval.warm_mask(program, arrays)
        if k is not None:
            _topk.load()
        if dfa_names(program):
            _dfa.load()
        return True

    def _viol_key(self, program: Program) -> tuple:
        return (id(self), program.cache_key())

    def _viol_plan(self, program: Program, bindings: Bindings,
                   arrays: dict, base, base_dirty,
                   append_only=frozenset()) -> tuple:
        """('reduce', viol) | ('delta', viol_old, rows) | ('full',).
        ``base``/``base_dirty``/``append_only`` must be captured BEFORE
        _arrays (migration cuts the lineage)."""
        key = self._viol_key(program)
        hit = bindings.__dict__.get("_viol_masks", {}).get(key)
        if hit is not None:
            sig, viol = hit
            if len(sig) == len(arrays) and \
                    all(arrays.get(nm) is dev for nm, dev in sig.items()):
                return ("reduce", viol)
        if base is not None and base_dirty:
            bhit = base.__dict__.get("_viol_masks", {}).get(key)
            if bhit is not None:
                bsig, bviol = bhit
                ok = len(bsig) == len(arrays)
                for nm, dev in arrays.items():
                    if not ok:
                        break
                    if bsig.get(nm) is dev:
                        continue
                    if nm not in base_dirty and nm not in append_only:
                        ok = False      # changed outside the dirty rows
                for nm in base_dirty:
                    if nm not in arrays:
                        ok = False
                if ok:
                    rows = np.unique(np.concatenate(
                        [np.asarray(r) for r in base_dirty.values()]))
                    return ("delta", bviol, rows)
        return ("full",)

    def alias_stored_mask(self, program: Program, base: Program,
                          bindings: Bindings, drop) -> None:
        """Store the violation mask a launch of ``program`` left on
        ``bindings`` under ``base`` as well, with the arrays named in
        ``drop`` taken out of its signature.  ``program`` is a rewrite of
        ``base`` that reads those extra arrays and computes the same
        mask (a dedup rewrite), so the next sweep of ``base`` over these
        bindings reuses or delta-updates the mask instead of launching
        the full kernel."""
        masks = bindings.__dict__.get("_viol_masks", {})
        hit = masks.get(self._viol_key(program))
        if hit is not None:
            sig, viol = hit
            masks[self._viol_key(base)] = (
                {nm: a for nm, a in sig.items() if nm not in drop}, viol)

    def _store_viol(self, program: Program, bindings: Bindings,
                    arrays: dict, viol) -> None:
        bindings.__dict__.setdefault("_viol_masks", {})[
            self._viol_key(program)] = (dict(arrays), viol)

    def _viol_mask_dev(self, program: Program, bindings: Bindings,
                       arrays: dict, base, base_dirty,
                       append_only=frozenset()) -> torch.Tensor:
        """Device [C, R] violation mask, maintained incrementally."""
        plan = self._viol_plan(program, bindings, arrays, base, base_dirty,
                               append_only)
        if plan[0] == "reduce":
            return plan[1]
        if plan[0] == "delta":
            _, viol_old, rows = plan
            rows = pad_rows(rows).astype(np.int32)
            viol = self._delta_eval(program, arrays, viol_old,
                                    self._upload(rows))
        else:
            viol = self._full_mask(program, arrays)
        self._store_viol(program, bindings, arrays, viol)
        return viol

    def run_async(self, program: Program, bindings: Bindings,
                  match: np.ndarray | None = None,
                  rank: np.ndarray | None = None) -> PendingMask:
        """Dispatch a full-mask evaluation without blocking; .get()
        yields the mask trimmed to [n_constraints, n_resources]."""
        base, base_dirty = bindings.base, bindings.base_dirty
        append_only = bindings.base_append_only
        arrays = self._arrays(bindings, match, rank)
        mask = self._viol_mask_dev(program, bindings, arrays, base,
                                   base_dirty, append_only)
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
        base, base_dirty = bindings.base, bindings.base_dirty
        append_only = bindings.base_append_only
        arrays = self._arrays(bindings, match, rank)
        viol = self._viol_mask_dev(program, bindings, arrays, base,
                                   base_dirty, append_only)
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

    def eval_mask_delta(self, program: Program, bindings: Bindings,
                        match: np.ndarray | None, old_mask: torch.Tensor,
                        page_table: torch.Tensor, k: int,
                        ij_specs: tuple = (), ij_arrays: dict | None = None,
                        n_ids: int = 0):
        """Violation mask AND its delta against the previous resident
        mask — the devpages sweep (the reference's ``eval_mask_delta``).

        First each inventory join of ``ij_specs`` ((join name,
        exclude_same_name) pairs) runs over the whole ``r_pad`` from its
        ``r:ij.<join>.*`` input records in ``ij_arrays`` (K7, with
        per-value tables of ``n_ids`` entries, the interner's size), and
        its column replaces the host-built one of the same binding name.
        Then the program is evaluated over the bindings' device arrays
        into a fresh mask (K3 for regex tables, then K1; never through
        the stored-mask plans, whose mask it leaves alone), and K6
        gathers it through ``page_table`` (row -> slot), XORs it with
        ``old_mask`` and compacts the changed bits.  The resident mask
        excludes ``__match__``: with ``match`` None a ``__match__`` that
        an earlier legacy sweep installed into these bindings (and that
        ``update_bindings`` carried into this generation) is left out.

        Returns ``(new_mask, idx, signs, count, row_any)``: ``new_mask``
        stays on the device; ``idx`` [k] int32 flat indices into
        [c_pad * r_pad] (-1 = fill), ``signs`` [k] bool (True =
        appeared), ``count`` the true changed-bit count (> k means the
        stream overflowed) and ``row_any`` [r_pad] bool come back as
        numpy and int, in one copy of K6's packed buffer (with K7's error
        flag) and one synchronisation.  A join input id at or past
        ``n_ids`` raises IndexError once that copy has synchronised."""
        arrays = self._arrays(bindings, match)
        if match is None:
            arrays = {nm: a for nm, a in arrays.items() if nm != "__match__"}
        if ij_arrays:
            arrays = {**arrays, **ij_arrays}
        names = tuple(sorted(arrays))
        ij_sig = tuple((nm, bool(ex)) for nm, ex in ij_specs)
        key = ("devdelta", program.cache_key(), k, ij_sig, R_CHUNK,
               tuple((nm,) + tuple(arrays[nm].shape)
                     + (str(arrays[nm].dtype),) for nm in names))
        if key in self._devdelta_keys:
            self.cache_hits += 1
        else:
            self._guard_miss("devdelta", program, arrays, delta_k=k)
            self._devdelta_keys.add(key)
            self.compiles += 1
        err = None
        if ij_sig:
            # every join over the whole row space before the evaluator
            # reads (or the plain one chunks) any r-axis array; the input
            # records themselves are no binding of the program
            err = _invjoin.error_flag(old_mask.device)
            inputs = set()
            for nm, ex in ij_sig:
                rec = inv_join_binding_names(nm)
                inputs.update(rec)
                src, inv, sel, nms = (arrays[r] for r in rec)
                arrays[nm] = _invjoin.inv_join_mask(
                    _widen(src), _widen(inv), sel, _widen(nms), ex, n_ids,
                    err)
            arrays = {nm: a for nm, a in arrays.items() if nm not in inputs}
        new = self._full_mask(program, arrays)
        outs = _devdelta.mask_delta(new, page_table, old_mask, k)
        # one copy of K6's packed outputs (and K7's error flag) to the
        # host, one synchronisation
        idx, signs, count, row_any, flag = _devdelta.to_host(outs, err)
        if flag is not None:
            _invjoin.check_error(flag, n_ids)
        return outs[0], idx, signs, count, row_any

    # ------------------------------------------------------------------
    # the fleet audit: N clusters' bindings stacked along a leading axis

    def _put_stacked(self, host: np.ndarray) -> torch.Tensor:
        """One stacked array, uploaded as the reference hands it to
        ``jax.jit``: 64-bit values narrowed to 32 bits (JAX with x64
        off), no int8/int16 narrowing, no identity-keyed cache."""
        narrow = {np.dtype(np.int64): np.int32,
                  np.dtype(np.uint64): np.uint32,
                  np.dtype(np.float64): np.float32}.get(host.dtype)
        if narrow is not None:
            host = host.astype(narrow)
        self.h2d_bytes += int(host.nbytes)
        return self._upload(host)

    def _stacked_arrays(self, program: Program,
                        stacked: dict[str, np.ndarray]) -> dict:
        """Device copies of the stacked arrays plus every regex table's
        verdicts ``<dfa>.devtab`` [N, T] (batched K3, or its plain
        version on the CPU)."""
        arrays = {nm: self._put_stacked(a) for nm, a in stacked.items()}
        return _with_dfa_tables(program, arrays, _dfa.dfa_table_batched)

    def run_mask_batched(self, program: Program,
                         stacked: dict[str, np.ndarray]) -> np.ndarray:
        """bool [N, C_pad, R_pad] violation masks of the stacked clusters
        (the reference's ``whatif/fleet._mask_fn``): batched K3, then
        batched K1 — or their plain versions on the CPU."""
        self.batched_mask_evals += 1
        d = self._stacked_arrays(program, stacked)
        return _ir_eval.eval_mask_batched(program, d).cpu().numpy()

    def run_topk_batched(self, program: Program,
                         stacked: dict[str, np.ndarray], k: int):
        """(counts [N, C_pad], rows [N, C_pad, k], valid [N, C_pad, k])
        of the stacked clusters (the reference's
        ``whatif/fleet._topk_fn``): batched K3, batched K1, then batched
        K2 scored by each cluster's ``__rank__`` row against the stacked
        R_pad — or their plain versions on the CPU."""
        self.reduces += 1
        d = self._stacked_arrays(program, stacked)
        viol = _ir_eval.eval_mask_batched(program, d)
        packed = _topk.topk_packed_batched(viol, d["__rank__"],
                                           k).cpu().numpy()
        return (packed[:, :, 0], packed[:, :, 1:1 + k],
                packed[:, :, 1 + k:].astype(bool))

