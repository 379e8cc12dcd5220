"""K7: the inventory join (wrapper + plain version).

Replaces the JAX package's ``engine/veval.py`` ``_inv_join_mask`` (item
B7): the duplicate-value join of K8sUniqueIngressHost, which the
devpages sweep (``engine/executor.py`` ``eval_mask_delta``) evaluates
over the whole table before the IR evaluator reads it as an ``r_bool``
column.  Row ``r`` violates iff some selected inventory row holds the
value ``src[r]`` and, with ``exclude_same_name``, a name other than
``names[r]``.  The CUDA kernel is ``csrc/invjoin.cu``; its note gives
why the per-value form (count, least and greatest name per value id)
equals the reference's sort-based ``total - own > 0``, the bound and the
design.  :func:`inv_join_mask` launches it for CUDA tensors and uses
:func:`inv_join_mask_plain` only for tensors on the CPU.  The kernel's
per-value table (one 64-bit word a value id, tagged with the epoch of
the call that wrote it) persists per device in a :class:`_JoinTable`,
so no call fills or allocates one.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from gatekeeper_tpu_torch.kernels import build

_I32_MAX = torch.iinfo(torch.int32).max
_I32_MIN = torch.iinfo(torch.int32).min


def _out_of_range(n_ids: int) -> IndexError:
    return IndexError(f"inv_join_mask: a value id outside [0, {n_ids})")


def inv_join_mask_plain(src: torch.Tensor, inv: torch.Tensor,
                        sel: torch.Tensor, names: torch.Tensor,
                        exclude_same_name: bool,
                        n_ids: int) -> torch.Tensor:
    """bool [R]: the per-value form of the join in torch ops —
    ``index_add_`` counts each selected value, ``scatter_reduce_``
    ("amin" / "amax") keeps its least and greatest name.  ``n_ids``
    sizes the per-value tables; a value id at or past it raises
    IndexError, as the kernel's :func:`check_error` does."""
    invsel = sel & (inv >= 0)
    vals = inv[invsel].to(torch.int64)
    if bool((src >= n_ids).any()) or bool((vals >= n_ids).any()):
        raise _out_of_range(n_ids)
    size = max(n_ids, 1)
    dev = src.device
    cnt = torch.zeros((size,), dtype=torch.int32, device=dev).index_add_(
        0, vals, torch.ones_like(vals, dtype=torch.int32))
    inv_names = names[invsel].to(torch.int32)
    mn = torch.full((size,), _I32_MAX, dtype=torch.int32,
                    device=dev).scatter_reduce_(0, vals, inv_names, "amin",
                                                include_self=True)
    mx = torch.full((size,), _I32_MIN, dtype=torch.int32,
                    device=dev).scatter_reduce_(0, vals, inv_names, "amax",
                                                include_self=True)
    s = src.to(torch.int64).clamp(min=0)
    hit = (src >= 0) & (cnt[s] > 0)
    if not exclude_same_name:
        return hit
    nm = names.to(torch.int32)
    return hit & ((nm < 0) | (mn[s] != nm) | (mx[s] != nm))


EPOCH_LIMIT = 1 << 31
"""Epochs run 1 .. EPOCH_LIMIT - 1 (31 bits of the table word); the
table is zeroed before the epoch would wrap."""

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p] \
    + [ctypes.c_int] * 3 + [ctypes.c_uint, ctypes.c_void_p]


class _JoinTable:
    """One device's per-value table: ``words`` int64 [size] and the last
    epoch handed out (0: the words are all zero)."""

    __slots__ = ("words", "epoch")

    def __init__(self, words: torch.Tensor):
        self.words = words
        self.epoch = 0


_TABLES: dict[torch.device, _JoinTable] = {}
_TABLES_LOCK = threading.Lock()


def _table_for(dev: torch.device, n_ids: int) -> tuple[torch.Tensor, int]:
    """The device's table, at least ``n_ids`` words (a new one, zeroed,
    when it is smaller: the interner grew), and the epoch of this call.
    Calls on one device must share a stream: the table is one per
    device."""
    with _TABLES_LOCK:
        tab = _TABLES.get(dev)
        if tab is None or tab.words.numel() < n_ids:
            # drop the outgrown table first: old and new never coexist
            # (the allocator orders the reuse after its queued launches)
            _TABLES.pop(dev, None)
            tab = None
            tab = _TABLES[dev] = _JoinTable(
                torch.zeros((n_ids,), dtype=torch.int64, device=dev))
        tab.epoch += 1
        if tab.epoch >= EPOCH_LIMIT:
            tab.words.zero_()
            tab.epoch = 1
        return tab.words, tab.epoch


def error_flag(device) -> torch.Tensor:
    """A zeroed int32 [1] flag for :func:`inv_join_mask`'s ``err``."""
    return torch.zeros((1,), dtype=torch.int32, device=device)


def check_error(err: torch.Tensor, n_ids: int) -> None:
    """Raise IndexError if a launch that was given ``err`` found a value
    id outside [0, n_ids).  ``err`` is the flag or its host copy; reading
    the flag on the card waits for the launch: call it where the caller
    synchronises anyway."""
    if int(err[0]):
        raise _out_of_range(n_ids)


def inv_join_mask(src: torch.Tensor, inv: torch.Tensor, sel: torch.Tensor,
                  names: torch.Tensor, exclude_same_name: bool, n_ids: int,
                  err: torch.Tensor) -> torch.Tensor:
    """The join of ``src``, ``inv``, ``names`` (int32 [R], MISSING = -1)
    and ``sel`` (bool [R]) with per-value tables of ``n_ids`` entries
    (the interner's size): bool [R] on their device.  K7 on CUDA
    tensors, the plain version on CPU tensors.

    A value id at or past ``n_ids`` raises IndexError: at once on the
    CPU; on the card the kernel sets the caller's zeroed ``err``
    (:func:`error_flag`) instead of reading past its tables, the wrapper
    returns without waiting, and the caller calls :func:`check_error`
    after its next synchronisation."""
    if src.device.type == "cpu":
        inv_join_mask.plain_calls += 1
        return inv_join_mask_plain(src, inv, sel, names, exclude_same_name,
                                   n_ids)
    dev = src.device
    if dev.type != "cuda" or inv.device != dev or sel.device != dev \
            or names.device != dev:
        raise ValueError(f"inv_join_mask: src, inv, sel and names must be "
                         f"on one CUDA device, got {src.device}, "
                         f"{inv.device}, {sel.device}, {names.device}")
    n_rows = src.shape[0]
    if src.dtype != torch.int32 or inv.dtype != torch.int32 \
            or names.dtype != torch.int32 or sel.dtype != torch.bool \
            or src.shape != (n_rows,) or inv.shape != (n_rows,) \
            or sel.shape != (n_rows,) or names.shape != (n_rows,):
        got = [(t.dtype, tuple(t.shape)) for t in (src, inv, sel, names)]
        raise TypeError(f"inv_join_mask: src, inv and names must be 1-d "
                        f"int32 and sel 1-d bool, all of {n_rows} rows, got "
                        f"{got}")
    if not (src.is_contiguous() and inv.is_contiguous()
            and sel.is_contiguous() and names.is_contiguous()):
        raise ValueError("inv_join_mask: src, inv, sel and names must be "
                         "contiguous")
    if not 0 < n_rows < (1 << 31) or not 0 < n_ids < (1 << 31):
        raise ValueError(f"inv_join_mask: {n_rows} rows and {n_ids} ids are "
                         "outside the kernel's range")
    if err.dtype != torch.int32 or err.device != dev or err.numel() != 1:
        raise TypeError(f"inv_join_mask: err must be int32 [1] on {dev}")
    out = torch.empty((n_rows,), dtype=torch.bool, device=dev)
    words, epoch = _table_for(dev, n_ids)
    fn = build.entry("invjoin", "gk_invjoin", _ARGTYPES)
    with build.on_device(dev):
        rc = fn(src.data_ptr(), inv.data_ptr(), sel.data_ptr(),
                names.data_ptr(), out.data_ptr(), words.data_ptr(),
                words.numel(), err.data_ptr(), n_rows, n_ids,
                int(bool(exclude_same_name)), epoch, build.stream(dev))
    build.check(rc, "invjoin launch")
    inv_join_mask.launches += 1
    return out


inv_join_mask.launches = 0
inv_join_mask.plain_calls = 0
