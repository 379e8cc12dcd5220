"""K2: per-constraint violation count + capped top-k (wrapper + plain).

Replaces the JAX package's ``engine/veval.py`` ``topk_reduce`` and
``ProgramExecutor._reduce_fn`` (item B3).  The CUDA kernels are
``csrc/topk.cu``, an exact split-row threshold select; its note gives
the bound and the design, and :func:`_plan` its geometry.
:func:`topk_packed` launches it for CUDA tensors and uses
:func:`topk_packed_plain` only for tensors on the CPU.

Packed layout (the reference's ``[C, 1+2k]`` int32): column 0 the
violation count, columns ``1..k`` the rows, ``k+1..2k`` the valid flags.
:func:`topk_packed_batched` is the same kernels over N clusters' stacked
masks (item B9, the fleet audit).  One wrapper call is one C call that
launches four kernels for the first select (prep, count, hist, collect)
and three for each further one (a cap above about 16,000);
``launches`` counts wrapper calls.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from gatekeeper_tpu_torch.kernels import build

WAVE_BLOCKS = 2048        # hist/collect blocks a select aims at: about
                          # two waves of the H100's 132 SMs at 8 blocks
SEG_MIN = 8192            # mask bytes a hist/collect block streams, at least
COUNT_BLOCKS = 512        # count blocks: all resident in one wave
COUNT_SEG_MIN = 16384     # mask bytes a count block streams, at least
MAX_BINS = 2048           # histogram bins (csrc/topk.cu kMaxBins)
SORT_MAX = 16384          # keys the finishing block holds (kSortMax)
TIE_MIN = 128             # tie region, at least
HDR_INTS = 16             # per-row header ints (kHdr)
FAST_CAP = 2048           # top-region keys a mask row holds

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 26 \
    + [ctypes.c_void_p]


class Plan(NamedTuple):
    """Geometry of one K2 call (see ``csrc/topk.cu``).  Segment ``i`` of
    a mask row is bytes ``[i * seg_bytes, (i + 1) * seg_bytes)`` for the
    hist and collect passes (``count_seg_bytes`` for the count pass), the
    last one running to ``r_pad``.  A selectable row of score ``s`` sits
    in bin ``(min(s, r_pad) - 1) >> shift``; bins from ``d_top`` up are
    the top region, taken in the count pass when ``fast_on`` (a cap one
    select covers).  A select takes ``chunk`` slots.  Scratch:
    ``n_rows`` 8-byte ceilings; from ``off_a`` ``a_stride`` ints a row
    (header, histogram); from ``off_c`` ``c_stride`` 8-byte keys a row
    (``chunk`` candidates, ``tie_cap`` ties); from ``off_fast``
    ``fast_cap`` keys a row (top region); from ``off_top`` a bitmap of
    ``top_words`` words a rank row; from ``off_todo`` the count and the
    list of the rows left to the general passes (ints)."""
    segments: int
    seg_bytes: int
    count_segments: int
    count_seg_bytes: int
    shift: int
    nbins: int
    row_bits: int
    chunk: int
    tie_cap: int
    sort_keys: int
    fast_on: int
    d_top: int
    fast_cap: int
    top_words: int
    a_stride: int
    c_stride: int
    off_a: int
    off_c: int
    off_fast: int
    off_top: int
    off_todo: int
    scratch_bytes: int


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def _split(n_rows: int, r: int, blocks: int, seg_min: int) -> tuple:
    """(segments, bytes a segment): enough segments for ``blocks`` over
    ``n_rows`` rows, each at least ``seg_min`` bytes, 16-byte multiples;
    the last segment takes the rest of the row."""
    n = max(1, min(-(-blocks // max(n_rows, 1)), r // seg_min))
    return n, (r // n // 16 * 16 if n > 1 else r)


@functools.lru_cache(maxsize=256)
def _plan(n_rows: int, r_pad: int, k: int, rank_rows: int = 1) -> Plan:
    """The grid and scratch of K2 over ``n_rows`` mask rows of ``r_pad``
    bytes at cap ``k``, scoring by ``rank_rows`` rank rows (0: no rank):
    both wrappers and the C call take their sizes from it."""
    r = max(r_pad, 1)
    k_eff = min(k, r_pad)
    shift = 0
    while (r - 1) >> shift >= MAX_BINS:
        shift += 1
    nbins = ((r - 1) >> shift) + 1
    tie_cap = max(TIE_MIN, 2 << shift)
    chunk = max(1, min(k_eff, SORT_MAX - tie_cap))
    fast_on = int(chunk >= k_eff)
    segments, seg_bytes = _split(n_rows, r, WAVE_BLOCKS, SEG_MIN)
    count_segments, count_seg_bytes = _split(n_rows, r, COUNT_BLOCKS,
                                             COUNT_SEG_MIN)
    a_stride = _up(HDR_INTS + nbins, 4)
    c_stride = chunk + tie_cap
    top_words = -(-r // 32)
    off_a = _up(8 * n_rows, 16)
    off_c = _up(off_a + 4 * a_stride * n_rows, 16)
    off_fast = _up(off_c + 8 * c_stride * n_rows, 16)
    off_top = _up(off_fast + 8 * FAST_CAP * n_rows * fast_on, 16)
    off_todo = _up(off_top + 4 * top_words * max(rank_rows, 1) * fast_on, 16)
    sort_keys = 1 << (chunk + tie_cap - 2).bit_length()
    return Plan(segments=segments, seg_bytes=seg_bytes,
                count_segments=count_segments,
                count_seg_bytes=count_seg_bytes, shift=shift, nbins=nbins,
                row_bits=(r - 1).bit_length(), chunk=chunk,
                tie_cap=tie_cap, sort_keys=sort_keys, fast_on=fast_on,
                d_top=max(0, nbins - max(1, FAST_CAP >> shift)),
                fast_cap=FAST_CAP, top_words=top_words, a_stride=a_stride,
                c_stride=c_stride, off_a=off_a, off_c=off_c,
                off_fast=off_fast, off_top=off_top, off_todo=off_todo,
                scratch_bytes=off_todo + 4 * (1 + n_rows))


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
    _launch(viol, rank, c_pad, k, out, "topk_packed launch")
    topk_packed.launches += 1
    return out


topk_packed.launches = 0
topk_packed.plain_calls = 0


def load() -> None:
    """Build K2's library if it is missing, load it and bind its entry,
    ahead of the first launch (the driver's ingest warm calls it, so no
    ``nvcc`` build or ``dlopen`` lands inside the first sweep)."""
    build.entry("topk", "gk_topk_packed", _ARGTYPES)


def _launch(viol: torch.Tensor, rank: torch.Tensor | None,
            rows_per_rank: int, k: int, out: torch.Tensor, what: str) -> None:
    """K2 over ``viol`` read as [rows, R_pad]: mask row b scores by
    rank row b // rows_per_rank."""
    r_pad = viol.shape[-1]
    n_rows = math.prod(viol.shape[:-1])
    rank_rows = 0 if rank is None else -(-n_rows // rows_per_rank)
    plan = _plan(n_rows, r_pad, k, rank_rows)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=viol.device)
    fn = build.entry("topk", "gk_topk_packed", _ARGTYPES)
    with build.on_device(viol.device), build.LAUNCH_LOCK:
        err = fn(viol.data_ptr(),
                 rank.data_ptr() if rank is not None else None,
                 out.data_ptr(), scratch.data_ptr(), n_rows, rows_per_rank,
                 r_pad, k, plan.segments, plan.seg_bytes,
                 plan.count_segments, plan.count_seg_bytes, plan.shift,
                 plan.nbins, plan.row_bits, plan.chunk, plan.tie_cap,
                 plan.sort_keys, plan.fast_on, plan.d_top, plan.fast_cap,
                 plan.top_words, plan.a_stride, plan.c_stride, plan.off_a,
                 plan.off_c, plan.off_fast, plan.off_top, plan.off_todo,
                 plan.scratch_bytes, build.stream(viol.device))
    build.check(err, what)


def topk_packed_batched_plain(viol: torch.Tensor, rank: torch.Tensor,
                              k: int) -> torch.Tensor:
    """[N, C, 1+2k] int32: :func:`topk_packed_plain` per cluster, on
    ``viol[i]`` and ``rank[i]`` (the score base is the stacked R_pad)."""
    return torch.stack([topk_packed_plain(viol[i], rank[i], k)
                        for i in range(viol.shape[0])])


def topk_packed_batched(viol: torch.Tensor, rank: torch.Tensor,
                        k: int) -> torch.Tensor:
    """Packed count + top-k of N clusters' stacked masks (item B9, the
    reduction inside the reference's ``whatif/fleet._topk_fn``): ``viol``
    bool [N, C_pad, R_pad], ``rank`` int32 [N, R_pad] -> int32
    [N, C_pad, 1+2k].  On CUDA tensors one K2 launch covers every
    cluster (block b reads rank row b // C_pad); on CPU tensors the plain
    version runs per cluster."""
    if viol.device.type == "cpu":
        topk_packed_batched.plain_calls += 1
        return topk_packed_batched_plain(viol, rank, k)
    if viol.device.type != "cuda":
        raise ValueError(f"topk_packed_batched: unsupported device "
                         f"{viol.device}")
    if viol.dtype != torch.bool or viol.dim() != 3 \
            or not viol.is_contiguous():
        raise TypeError("topk_packed_batched: viol must be a contiguous "
                        f"3-d bool tensor, got {viol.dim()}-d {viol.dtype}")
    n_b, c_pad, r_pad = viol.shape
    if k <= 0:
        raise ValueError(f"topk_packed_batched: k={k} must be positive")
    if rank.device != viol.device or rank.dtype != torch.int32 \
            or tuple(rank.shape) != (n_b, r_pad) or not rank.is_contiguous():
        raise TypeError("topk_packed_batched: rank must be a contiguous "
                        f"int32 [{n_b}, {r_pad}] tensor on {viol.device}")
    out = torch.empty((n_b, c_pad, 1 + 2 * k), dtype=torch.int32,
                      device=viol.device)
    _launch(viol, rank, c_pad, k, out, "topk_packed_batched launch")
    topk_packed_batched.launches += 1
    return out


topk_packed_batched.launches = 0
topk_packed_batched.plain_calls = 0
