"""K6: the devpages delta (wrapper + plain version).

Replaces the JAX package's ``engine/veval.py``
``ProgramExecutor.eval_mask_delta`` (item B6): after the full violation
mask is evaluated (K1), gather it through the page table, XOR it with
the resident mask, and compact the changed bits into an ascending,
fixed-width stream — ``jnp.nonzero(size=k, fill_value=-1)`` — with
their signs, their count and ``row_any``.  The CUDA kernel is
``csrc/devdelta.cu``, one single-pass launch; its note gives the bound
and the design.  :func:`mask_delta` launches it for CUDA tensors and
uses :func:`mask_delta_plain` only for tensors on the CPU; on the card
``idx``, ``count``, ``signs`` and ``row_any`` are views of one packed
buffer (:func:`layout`), which :func:`to_host` brings to the host in one
copy.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gatekeeper_tpu_torch.kernels import build

TILE = 4096
"""Flat elements per block of the kernel (``kTile`` in devdelta.cu)."""

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def layout(c_rows: int, n_rows: int, k: int) -> dict[str, int]:
    """Byte offsets in K6's packed buffer (``gk_devdelta``'s layout):
    ``idx`` int32 [k] at 0, ``count`` int32 at ``4k``, ``signs`` bool
    [k] after it, ``row_any`` bool [R] at the next 16 bytes; then the
    kernel's tile status words and ticket.  The host copies the first
    ``host`` bytes; ``size`` is the whole buffer."""
    n_tiles = -(-(c_rows * n_rows) // TILE)
    row_any = _align16(5 * k + 4)
    status = _align16(row_any + n_rows)
    return {"idx": 0, "count": 4 * k, "signs": 4 * k + 4,
            "row_any": row_any, "host": row_any + n_rows, "status": status,
            "size": _align16(status + 8 * n_tiles + 4)}


def _views(words: torch.Tensor, lay: dict, k: int):
    """(idx, signs, count, row_any) as views of the packed buffer
    ``words`` (int32 [size / 4])."""
    flags = words.view(torch.bool)
    return (words[:k], flags[lay["signs"]: lay["signs"] + k], words[k],
            flags[lay["row_any"]: lay["host"]])


def _unpack(arr: np.ndarray, lay: dict, k: int):
    """(idx, signs, count, row_any) of the packed buffer's host bytes
    ``arr`` (uint8), as numpy views and an int."""
    return (arr[: 4 * k].view(np.int32),
            arr[lay["signs"]: lay["signs"] + k].view(np.bool_),
            int(arr[lay["count"]: lay["count"] + 4].view(np.int32)[0]),
            arr[lay["row_any"]: lay["host"]].view(np.bool_))


def _gathered(new: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    """``new[:, pt]`` as ``jnp.take(new, pt, axis=1)`` reads it: a
    negative entry counts from the end, one still out of range reads
    True (take's fill value for bool)."""
    n_rows = new.shape[1]
    p = pt.to(torch.int64)
    p = torch.where(p < 0, p + n_rows, p)
    inb = (p >= 0) & (p < n_rows)
    return new.index_select(1, p.clamp(0, n_rows - 1)) | ~inb


def mask_delta_plain(new: torch.Tensor, pt: torch.Tensor, old: torch.Tensor,
                     k: int):
    """(new_g, idx, signs, count, row_any): the gather, ``^``, a
    ``nonzero`` over the flat array (first k, padded with -1), the
    signs, ``sum(dtype=int32)`` and ``any(0)``."""
    g = _gathered(new, pt)
    flat = (g ^ old).reshape(-1)
    nz = torch.nonzero(flat).reshape(-1)[:k]
    idx = torch.full((k,), -1, dtype=torch.int32, device=new.device)
    idx[: nz.numel()] = nz.to(torch.int32)
    signs = g.reshape(-1)[idx.clamp(min=0).to(torch.int64)]
    return g, idx, signs, flat.sum(dtype=torch.int32), g.any(0)


def mask_delta(new: torch.Tensor, pt: torch.Tensor, old: torch.Tensor,
               k: int):
    """The devpages delta of ``new`` (bool [C, R]) through the page table
    ``pt`` (int32 [R]) against ``old`` (bool [C, R]), ``k`` slots wide:
    ``(new_g bool [C, R], idx int32 [k], signs bool [k], count int32
    0-d, row_any bool [R])``, all on ``new``'s device.  K6 on CUDA
    tensors, the plain version on CPU tensors.  On the card ``idx``,
    ``signs``, ``count`` and ``row_any`` are views of one packed buffer
    (:func:`layout`), which :func:`to_host` copies to the host at
    once."""
    dev = new.device
    if dev.type == "cpu":
        mask_delta.plain_calls += 1
        return mask_delta_plain(new, pt, old, k)
    if dev.type != "cuda" or old.device != dev or pt.device != dev:
        raise ValueError(f"mask_delta: new, old and pt must be on one CUDA "
                         f"device, got {dev}, {old.device}, {pt.device}")
    if new.dtype != torch.bool or old.dtype != torch.bool \
            or pt.dtype != torch.int32 or new.dim() != 2 or pt.dim() != 1:
        raise TypeError(f"mask_delta: new and old must be 2-d bool, pt 1-d "
                        f"int32, got {new.dtype} {old.dtype} {pt.dtype}")
    if not (new.is_contiguous() and old.is_contiguous()
            and pt.is_contiguous()):
        raise ValueError("mask_delta: new, old and pt must be contiguous")
    c_rows, n_rows = new.shape
    if tuple(old.shape) != (c_rows, n_rows) or pt.shape[0] != n_rows:
        raise ValueError(f"mask_delta: new {tuple(new.shape)}, old "
                         f"{tuple(old.shape)}, pt {tuple(pt.shape)}")
    total = c_rows * n_rows
    if not 0 < total < (1 << 31) - TILE or not 0 < k < (1 << 31):
        raise ValueError(f"mask_delta: [{c_rows}, {n_rows}] with k {k} is "
                         "outside the int32 flat-index range")
    lay = layout(c_rows, n_rows, k)
    out = torch.empty_like(new)
    words = torch.empty((lay["size"] // 4,), dtype=torch.int32, device=dev)
    fn = build.entry("devdelta", "gk_devdelta", _ARGTYPES)
    with build.on_device(dev):
        err = fn(new.data_ptr(), pt.data_ptr(), old.data_ptr(),
                 out.data_ptr(), words.data_ptr(), lay["size"], c_rows,
                 n_rows, k, build.stream(dev))
    build.check(err, "devdelta launch")
    mask_delta.launches += 1
    idx, signs, count, row_any = _views(words, lay, k)
    return out, idx, signs, count, row_any


mask_delta.launches = 0
mask_delta.plain_calls = 0


def to_host(outputs, flag: torch.Tensor | None = None):
    """``(idx, signs, count, row_any, flag)`` of :func:`mask_delta`'s
    ``outputs`` on the host: numpy arrays, ``count`` an int, ``flag``
    (a small extra tensor, such as K7's error flag) a numpy array or
    None.  For the card's outputs: one copy of the packed buffer's host
    part (and one of ``flag``) into pinned host memory, then one
    synchronisation; CPU outputs are read as they are."""
    new_g, idx, signs, count, row_any = outputs
    if idx.device.type == "cpu":
        return (idx.numpy(), signs.numpy(), int(count), row_any.numpy(),
                None if flag is None else flag.numpy())
    k, n_rows = idx.shape[0], row_any.shape[0]
    lay = layout(new_g.shape[0], n_rows, k)
    if idx.storage_offset() or row_any.storage_offset() != lay["row_any"] \
            or idx.untyped_storage().nbytes() != lay["size"]:
        raise ValueError("to_host: outputs are not mask_delta's packed "
                         "views")
    dev = idx.device
    packed = torch.empty((0,), dtype=torch.uint8, device=dev).set_(
        idx.untyped_storage(), 0, (lay["host"],))
    at = _align16(lay["host"])
    extra = 0 if flag is None else flag.numel() * flag.element_size()
    host = torch.empty((at + extra,), dtype=torch.uint8, pin_memory=True)
    host[: lay["host"]].copy_(packed, non_blocking=True)
    if flag is not None:
        host[at:].view(flag.dtype).copy_(flag.reshape(-1), non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    done.synchronize()
    return _unpack(host.numpy(), lay, k) + (
        None if flag is None else host[at:].view(flag.dtype).numpy(),)
