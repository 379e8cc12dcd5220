"""K2's plan: the grid and scratch geometry of the split-row threshold
select (``kernels/topk._plan``), which both wrappers and the C call
take their sizes from.  Pure Python: no card, no jax.  The kernel
itself is held against its plain version on the card by
tests/test_torch_kernels.py."""

import numpy as np
import pytest

from gatekeeper_tpu_torch.kernels import topk as ttopk
from gatekeeper_tpu_torch.kernels.topk import _plan

SHAPES = [
    # n_rows, r_pad, k, rank rows (0: no rank)
    (128, 131072, 20, 1),        # K2 on the north-star kinds
    (512, 131072, 20, 4),        # K2b on the fleet's four clusters
    (128, 131072, 300, 1),
    (4, 131072, 65536, 1),       # several selects
    (4, 131072, 1, 0),
    (128, 1 << 20, 20, 1),       # the full north star
    (16, 20001, 20, 1),          # ragged: not a multiple of 16 or a segment
    (3, 16389, 300, 3),
    (4, 8, 20, 1),               # k > r_pad
    (1, 1, 1, 0),
    (70000, 64, 5, 1),           # more rows than one grid dimension
]


def _segments(n, seg_bytes, r_pad):
    return [(i * seg_bytes, r_pad if i == n - 1 else (i + 1) * seg_bytes)
            for i in range(n)]


@pytest.mark.parametrize("n_rows,r_pad,k,rank_rows", SHAPES)
@pytest.mark.parametrize("split", ["select", "count"])
def test_plan_segments_cover_the_row(n_rows, r_pad, k, rank_rows, split):
    """The segments of each pass are contiguous, cover [0, r_pad)
    exactly (the last one takes the ragged tail), each at least the
    pass's minimum when the row has that many bytes, the inner
    boundaries on 16-byte words."""
    p = _plan(n_rows, r_pad, k, rank_rows)
    n, seg, least = ((p.segments, p.seg_bytes, ttopk.SEG_MIN)
                     if split == "select" else
                     (p.count_segments, p.count_seg_bytes,
                      ttopk.COUNT_SEG_MIN))
    segs = _segments(n, seg, r_pad)
    assert segs[0][0] == 0 and segs[-1][1] == r_pad
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    if r_pad >= least:
        assert min(hi - lo for lo, hi in segs) >= least
    else:
        assert n == 1
    if n > 1:
        assert seg % 16 == 0


@pytest.mark.parametrize("n_rows,r_pad,k,rank_rows", SHAPES)
def test_plan_bins_and_keys(n_rows, r_pad, k, rank_rows):
    """Every score 1..r_pad (and any clamped above) has a bin below
    nbins <= MAX_BINS, a bin of distinct scores fits the tie region, the
    top region holds at most fast_cap distinct scores and is the top
    bins, and the row part of a key holds every row."""
    p = _plan(n_rows, r_pad, k, rank_rows)
    assert 1 <= p.nbins <= ttopk.MAX_BINS
    scores = np.arange(1, r_pad + 1, dtype=np.int64)
    bins = (np.minimum(scores, r_pad) - 1) >> p.shift
    assert bins.min() == 0 and bins.max() == p.nbins - 1
    assert np.bincount(bins).max() <= p.tie_cap
    assert 0 <= p.d_top < p.nbins
    assert (bins >= p.d_top).sum() <= p.fast_cap
    assert r_pad - 1 < (1 << p.row_bits)
    assert p.row_bits + 31 < 64


@pytest.mark.parametrize("n_rows,r_pad,k,rank_rows", SHAPES)
def test_plan_scratch_fits_candidates_and_ties(n_rows, r_pad, k, rank_rows):
    """The selects cover min(k, r_pad) slots, the top region only for a
    single select; the finishing block's sort holds the largest
    candidate set (chunk - 1 above the threshold bin plus a full tie
    region); the scratch regions follow one another, 16-byte aligned,
    and hold the ceilings, every row's header and histogram, candidate
    and tie regions, top-region keys, the rank rows' bitmaps and the list
    of rows left to the general passes."""
    p = _plan(n_rows, r_pad, k, rank_rows)
    k_eff = min(k, r_pad)
    rounds = -(-k_eff // p.chunk)
    assert rounds * p.chunk >= k_eff > (rounds - 1) * p.chunk
    assert p.fast_on == (rounds <= 1)
    assert p.chunk + p.tie_cap - 1 <= p.sort_keys <= ttopk.SORT_MAX
    assert p.sort_keys & (p.sort_keys - 1) == 0
    assert 8 * p.sort_keys <= 232448    # the collect pass's shared memory
    assert 8 * (p.fast_cap + p.sort_keys) <= 232448    # the count pass's
    assert p.a_stride >= ttopk.HDR_INTS + p.nbins
    assert p.c_stride >= p.chunk + p.tie_cap
    assert 32 * p.top_words >= r_pad
    ends = [(p.off_a, 8 * n_rows),
            (p.off_c, p.off_a + 4 * p.a_stride * n_rows),
            (p.off_fast, p.off_c + 8 * p.c_stride * n_rows),
            (p.off_top, p.off_fast + 8 * p.fast_cap * n_rows * p.fast_on),
            (p.off_todo, p.off_top
             + 4 * p.top_words * max(rank_rows, 1) * p.fast_on),
            (p.scratch_bytes, p.off_todo + 4 * (1 + n_rows))]
    for start, prev_end in ends:
        assert start >= prev_end
    for start, _ in ends[:-1]:
        assert start % 16 == 0


@pytest.mark.parametrize("n_rows,segments,count_segments", [
    (128, 16, 4), (512, 4, 1)])
def test_plan_grid_reaches_the_wave_target(n_rows, segments, count_segments):
    """The general passes cover about two waves of the 132 SMs; the
    count pass fits one wave, 4 blocks an SM at most."""
    p = _plan(n_rows, 131072, 20, 1)
    assert (p.segments, p.count_segments) == (segments, count_segments)
    assert p.segments * n_rows >= ttopk.WAVE_BLOCKS
    assert p.count_segments * n_rows <= 4 * 132


@pytest.mark.parametrize("n_rows,k,rank_rows,scratch", [
    (128, 20, 1, 3_323_396),     # about 3.3 MB for K2 on a north-star kind
    (512, 20, 4, 13_293_572),    # about 13.3 MB for K2b on the fleet
    (128, 300, 1, 3_610_116),
])
def test_plan_scratch_bytes(n_rows, k, rank_rows, scratch):
    assert _plan(n_rows, 131072, k, rank_rows).scratch_bytes == scratch


def test_plan_without_rows_selects_nothing():
    """r_pad 0: no select (the C call zero-fills the output); the plan
    still describes a valid scratch for one row of one byte."""
    p = _plan(3, 0, 5)
    assert (p.segments, p.nbins, p.chunk) == (1, 1, 1)
    assert p.scratch_bytes > 0
