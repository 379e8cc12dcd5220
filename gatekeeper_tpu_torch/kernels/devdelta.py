"""K6: the devpages delta (wrapper + plain version).

Replaces the JAX package's ``engine/veval.py``
``ProgramExecutor.eval_mask_delta`` (item B6): after the full violation
mask is evaluated (K1), gather it through the page table, XOR it with
the resident mask, and compact the changed bits into an ascending,
fixed-width stream — ``jnp.nonzero(size=k, fill_value=-1)`` — with
their signs, their count and ``row_any``.  The CUDA kernel is
``csrc/devdelta.cu``; its note gives the bound and the design.
:func:`mask_delta` launches it for CUDA tensors and uses
:func:`mask_delta_plain` only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from gatekeeper_tpu_torch.kernels import build

TILE = 4096
"""Flat elements per block of the kernel (``kTile`` in devdelta.cu,
which refuses a tile count made with another size)."""


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
    tensors, the plain version on CPU tensors."""
    if new.device.type == "cpu":
        mask_delta.plain_calls += 1
        return mask_delta_plain(new, pt, old, k)
    for name, t, dt, nd in (("new", new, torch.bool, 2),
                            ("old", old, torch.bool, 2),
                            ("pt", pt, torch.int32, 1)):
        if t.device != new.device or t.device.type != "cuda":
            raise ValueError(f"mask_delta: {name} must be on {new.device} "
                             f"(CUDA), got {t.device}")
        if t.dtype != dt or t.dim() != nd:
            raise TypeError(f"mask_delta: {name} must be {nd}-d {dt}, got "
                            f"{t.dim()}-d {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"mask_delta: {name} must be contiguous")
    c_rows, n_rows = new.shape
    if tuple(old.shape) != (c_rows, n_rows) or pt.shape[0] != n_rows:
        raise ValueError(f"mask_delta: new {tuple(new.shape)}, old "
                         f"{tuple(old.shape)}, pt {tuple(pt.shape)}")
    total = c_rows * n_rows
    if not 0 < total < (1 << 31) - TILE or not 0 < k < (1 << 31):
        raise ValueError(f"mask_delta: [{c_rows}, {n_rows}] with k {k} is "
                         "outside the int32 flat-index range")
    n_tiles = -(-total // TILE)
    dev = new.device
    out = torch.empty_like(new)
    idx = torch.empty((k,), dtype=torch.int32, device=dev)
    signs = torch.empty((k,), dtype=torch.bool, device=dev)
    row_any = torch.empty((n_rows,), dtype=torch.bool, device=dev)
    scratch = torch.empty((2 * n_tiles + 1,), dtype=torch.int32, device=dev)
    fn = build.load("devdelta").gk_devdelta
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(new.data_ptr(), pt.data_ptr(), old.data_ptr(),
                 out.data_ptr(), idx.data_ptr(), signs.data_ptr(),
                 row_any.data_ptr(), scratch.data_ptr(), c_rows, n_rows, k,
                 n_tiles, stream)
    build.check(err, "devdelta launch")
    mask_delta.launches += 1
    return out, idx, signs, scratch[2 * n_tiles], row_any


mask_delta.launches = 0
mask_delta.plain_calls = 0
