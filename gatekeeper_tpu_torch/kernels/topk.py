"""K2: per-constraint violation count + capped top-k (wrapper + plain).

Replaces the JAX package's ``engine/veval.py`` ``topk_reduce`` and
``ProgramExecutor._reduce_fn`` (item B3).  The CUDA kernel is
``csrc/topk.cu``; its note gives the bound and the design.
:func:`topk_packed` launches it for CUDA tensors and uses
:func:`topk_packed_plain` only for tensors on the CPU.

Packed layout (the reference's ``[C, 1+2k]`` int32): column 0 the
violation count, columns ``1..k`` the rows, ``k+1..2k`` the valid flags.
"""

from __future__ import annotations

import ctypes

import torch

from gatekeeper_tpu_torch.kernels import build

def topk_reduce(viol: torch.Tensor, k: int,
                rank: torch.Tensor | None = None,
                score_base: int | None = None,
                return_scores: bool = False):
    """Plain port of veval.topk_reduce: (counts [C] int32, rows [C, k]
    int32, valid [C, k] bool) — or the scores instead of ``valid``.

    score = where(viol, base - rank, 0); the k highest scores per row
    are taken by a stable descending sort, so invalid (score 0) slots
    hold the lowest zero-score row ids.  Only valid slots are part of
    the contract (their scores are unique)."""
    c_pad, r_pad = viol.shape
    base = score_base if score_base is not None else r_pad
    k_eff = min(k, r_pad)
    counts = viol.sum(dim=1, dtype=torch.int32)
    if rank is None:
        rank = torch.arange(r_pad, dtype=torch.int32, device=viol.device)
    score = torch.where(viol, base - rank.to(torch.int32)[None, :],
                        torch.zeros((), dtype=torch.int32,
                                    device=viol.device)).to(torch.int32)
    vals, rows = torch.sort(score, dim=1, descending=True, stable=True)
    vals = vals[:, :k_eff]
    rows = rows[:, :k_eff].to(torch.int32)
    if k_eff < k:
        pad = torch.zeros((c_pad, k - k_eff), dtype=torch.int32,
                          device=viol.device)
        vals = torch.cat([vals, pad], dim=1)
        rows = torch.cat([rows, pad], dim=1)
    if return_scores:
        return counts, rows, vals
    return counts, rows, vals > 0


def topk_packed_plain(viol: torch.Tensor, rank: torch.Tensor | None,
                      k: int) -> torch.Tensor:
    """[C, 1+2k] int32, the reference ``_reduce_fn`` output."""
    counts, rows, scores = topk_reduce(viol, k, rank, return_scores=True)
    return torch.cat([counts[:, None], rows,
                      (scores > 0).to(torch.int32)], dim=1)


def topk_packed(viol: torch.Tensor, rank: torch.Tensor | None,
                k: int) -> torch.Tensor:
    """Packed count + top-k: K2 on CUDA tensors, the plain version on
    CPU tensors."""
    if viol.device.type == "cpu":
        topk_packed.plain_calls += 1
        return topk_packed_plain(viol, rank, k)
    if viol.device.type != "cuda":
        raise ValueError(f"topk_packed: unsupported device {viol.device}")
    if viol.dtype != torch.bool or viol.dim() != 2 \
            or not viol.is_contiguous():
        raise TypeError("topk_packed: viol must be a contiguous 2-d bool "
                        f"tensor, got {viol.dim()}-d {viol.dtype}")
    c_pad, r_pad = viol.shape
    if k <= 0:
        raise ValueError(f"topk_packed: k={k} must be positive")
    if rank is not None:
        if rank.device != viol.device or rank.dtype != torch.int32 \
                or tuple(rank.shape) != (r_pad,) or not rank.is_contiguous():
            raise TypeError("topk_packed: rank must be a contiguous int32 "
                            f"[{r_pad}] tensor on {viol.device}")
    out = torch.empty((c_pad, 1 + 2 * k), dtype=torch.int32,
                      device=viol.device)
    fn = build.load("topk").gk_topk_packed
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    with torch.cuda.device(viol.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(viol.data_ptr(),
                 rank.data_ptr() if rank is not None else None,
                 c_pad, r_pad, k, out.data_ptr(), stream)
    build.check(err, "topk_packed launch")
    topk_packed.launches += 1
    return out


topk_packed.launches = 0
topk_packed.plain_calls = 0
