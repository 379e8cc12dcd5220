// K2: per-constraint violation count + capped top-k, packed.
//
// Replaces the JAX package's engine/veval.py `topk_reduce` (:660),
// `_eval_topk` (:602) and `ProgramExecutor._reduce_fn` (:1516), the
// chunked lax.top_k reduction, item B3 of the port's kernel table; and,
// batched, whatif/fleet.py `_topk_fn` (:47), item B9.
//
// For each mask row c of the bool mask [n_rows, R]: the violation count,
// and the k violating rows with the highest score = R - rank[r] (rank =
// the scalar driver's sorted-key order, so the capped subset is the same
// one the scalar oracle emits first; no rank = raw row order).  Rows with
// a score <= 0 are counted, never selected.  Output is the packed
// [n_rows, 1 + 2k] int32 layout of the reference: count, k rows, k valid
// flags; invalid slots hold row 0 and flag 0.  Mask row c scores by rank
// row c / rows_per_rank: one rank row for K2, [N, R] for the fleet's N
// stacked [C_pad, R] masks (K2b, rows_per_rank = C_pad).
//
// Order: key = score << row_bits | (R - 1 - r), unique, larger is better,
// so equal scores go to the lower row as in the reference's stable
// descending sort.  A key's digit is (min(score, R) - 1) >> shift: about
// 2,048 bins over the top bits, scores above R clamped into the top bin.
//
// Bound on the H100: bytes -- the mask once (n_rows R bytes), the rank of
// each violating row once and the packed output; about 5 us at
// [128, 131072] and 21 us at the fleet's [512, 131072].
//
// Design: an exact split-row threshold select; every pass over a mask row
// is split into segments, a block each, the grid (segments, n_rows) sized
// by the wrapper's plan to fill the 132 SMs.
//   prep: zero the per-row headers and histograms; mark, one bit a row,
//     the rows of each rank row whose digit is in the top region (the top
//     bins, about 2,048 rows).
//   count: stream the mask with 16-byte loads and count its set bytes by
//     popcount, branch-free; a set byte whose top-region bit is set (a
//     1.5% sample at 131,072 rows) appends its key to the row's
//     top-region keys.  The last block of a row (a done counter) finishes
//     it there when it can: when the top region holds at least `need`
//     violating rows (or all of them), the row's top `need` are in it,
//     since every key outside has a lower score.  It bins those keys by
//     digit, takes the bins from the top down to the need-th key's,
//     orders them by counting larger keys and writes the row.  A dense
//     mask, the audit's, is done here: one pass at nearly the memory's
//     rate.  Other rows (sparse, or a threshold bin past the tie region)
//     go on:
//   hist: bin each selectable row by digit in a shared-memory histogram;
//     flush only the bins with fewer than `need` of the block's keys above
//     them (the row's need-th key is at least the block's own, so every
//     bin at or above the row's threshold bin is complete); the last block
//     finds the threshold bin t and the count above it.
//   collect: append keys of bins above t to the row's candidates and keys
//     of bin t to its tie region (warp-aggregated atomic cursors); the
//     last block loads them into shared memory, orders them (a count of
//     larger keys up to 512, a bitonic sort above), writes the row.
// A threshold bin with more keys than the tie region (repeated or clamped
// scores) is refined exactly by that last block: 8-bit digits of the key,
// one pass over its row each, until the need-th key is known; equal
// scores fall through to the row part of the key.  A cap above what one
// shared-memory sort holds (16,384 keys less the tie region) takes
// further selects, each over the keys below the last one taken.
// Everything runs on the caller's stream from one C call: prep, count,
// hist and collect for the first select (hist and collect exit at once
// for rows already done), prep, hist and collect for each further one.
// The wrapper allocates the output and the scratch; the kernels allocate
// nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 2048;       // histogram bins of a select
constexpr int kSortMax = 16384;      // keys the finishing block holds
constexpr int kCountSortMax = 512;   // ordered by counting larger keys
constexpr int kRefineBits = 8;       // digit width of a refinement
constexpr int kUnroll = 4;           // 16-byte loads in flight a thread
constexpr int kMaxGridY = 65535;
constexpr int kItemBlocks = 132 * 8;  // blocks of the general passes
constexpr int kMaxDevices = 64;

// per-row header, ints, before the row's histogram
enum {
  kCount,     // violating rows (first select)
  kSel,       // selectable rows below the ceiling
  kDone0,     // count blocks done
  kDone1,     // hist blocks done
  kDone2,     // collect blocks done
  kThresh,    // threshold bin, -1 = take every selectable row
  kAbove,     // rows in bins above the threshold
  kOverflow,  // the threshold bin holds more than the tie region
  kCandCur,   // candidates appended
  kTieCur,    // tie rows appended
  kFastN,     // top-region keys appended
  kHdr = 16
};

struct Select {
  const uint8_t* mask;
  const int32_t* rank;
  int32_t* out;
  u64* ceil;       // [n_rows] last key taken by the previous select, 0 = none
  int* hdr;        // [n_rows, a_stride]: header then histogram
  u64* keys;       // [n_rows, c_stride]: chunk candidates then the ties
  u64* fast;       // [n_rows, fast_cap]: keys of the top region
  uint32_t* top;   // [top rows, top_words]: bit r = row r in the top region
  int* todo;       // [1 + n_rows]: rows left to the general passes
  int n_rows, rows_per_rank, n_top_rows, r_pad, k, segments, seg_bytes,
      count_segments, count_seg_bytes, shift, nbins, row_bits, tie_cap,
      a_stride, c_stride, chunk, fast_on, d_top, fast_cap, top_words;
  int need, round_off, first, last;
};

__device__ __forceinline__ int score_of(const Select& p, const int32_t* rk,
                                        int r) {
  // int32 wrap-around, as the plain version's r_pad - rank
  const unsigned v = rk ? static_cast<unsigned>(__ldg(rk + r))
                        : static_cast<unsigned>(r);
  return static_cast<int>(static_cast<unsigned>(p.r_pad) - v);
}

__device__ __forceinline__ int digit_of(const Select& p, int s) {
  return (min(s, p.r_pad) - 1) >> p.shift;
}

__device__ __forceinline__ u64 key_of(const Select& p, int s, int r) {
  return (static_cast<u64>(s) << p.row_bits) |
         static_cast<unsigned>(p.r_pad - 1 - r);
}

__device__ __forceinline__ int key_digit(const Select& p, u64 kk) {
  return digit_of(p, static_cast<int>(kk >> p.row_bits));
}

// the first byte of row[lo, hi) at a 16-byte address, at most hi
__device__ __forceinline__ int aligned_from(const uint8_t* row, int lo,
                                            int hi) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(row + lo) & 15);
  return min(hi, mis ? lo + 16 - mis : lo);
}

// bit i = byte i of x is set
__device__ __forceinline__ uint32_t set_bits4(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// f(base, bits) over row[lo, hi): bit j of `bits` = byte base + j is set;
// 16 bytes a call in the body (kUnroll 16-byte loads in flight), one byte
// a call at the unaligned ends
template <class F>
__device__ __forceinline__ void for_each_word(const uint8_t* row, int lo,
                                              int hi, F&& f) {
  const int a = aligned_from(row, lo, hi);
  for (int r = lo + threadIdx.x; r < a; r += kThreads)
    if (row[r]) f(r, 1u);
  const int nvec = (hi - a) >> 4;
  const uint4* v4 = reinterpret_cast<const uint4*>(row + a);
  for (int w0 = threadIdx.x; w0 < nvec; w0 += kUnroll * kThreads) {
    uint4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = w0 + u * kThreads;
      x[u] = w < nvec ? __ldg(v4 + w) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t bits = set_bits4(x[u].x) | set_bits4(x[u].y) << 4 |
                            set_bits4(x[u].z) << 8 | set_bits4(x[u].w) << 12;
      if (bits) f(a + (w0 + u * kThreads) * 16, bits);
    }
  }
  for (int r = a + (nvec << 4) + threadIdx.x; r < hi; r += kThreads)
    if (row[r]) f(r, 1u);
}

// f(r) for every set byte r of row[lo, hi)
template <class F>
__device__ __forceinline__ void for_each_set(const uint8_t* row, int lo,
                                             int hi, F&& f) {
  for_each_word(row, lo, hi, [&](int base, uint32_t bits) {
    for (; bits; bits &= bits - 1) f(base + __ffs(bits) - 1);
  });
}

// the sum of v over the block, to every thread
__device__ __forceinline__ int block_sum(int v, int* s_tmp) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) s_tmp[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += s_tmp[w];
  __syncthreads();
  return t;
}

// f(b, above) for every bin b of h[0, n), above = the sum of the bins
// past b; each thread walks a contiguous run of bins.  Every thread calls
// it.
template <class F>
__device__ __forceinline__ void for_each_bin_above(const int* h, int n,
                                                   int* s_tmp, F&& f) {
  const int per = (n + kThreads - 1) / kThreads;
  const int b0 = threadIdx.x * per;
  const int b1 = min(n, b0 + per);
  int mine = 0;
  for (int b = b0; b < b1; ++b) mine += h[b];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = mine;  // inclusive suffix sum over the warp's lanes
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_down_sync(0xffffffffu, x, off);
    if (lane + off < 32) x += y;
  }
  if (lane == 0) s_tmp[warp] = x;
  __syncthreads();
  int above = x - mine;
  for (int w = warp + 1; w < kWarps; ++w) above += s_tmp[w];
  __syncthreads();
  for (int b = b1 - 1; b >= b0; --b) {
    f(b, above);
    above += h[b];
  }
}

// the bin b of h[0, n) holding the need-th largest key: s_res[0] = b,
// s_res[1] = the keys above it (the caller knows the sum reaches need)
__device__ __forceinline__ void find_bin(const int* h, int n, int need,
                                         int* s_tmp, int* s_res) {
  for_each_bin_above(h, n, s_tmp, [&](int b, int above) {
    if (above < need && above + h[b] >= need) {
      s_res[0] = b;
      s_res[1] = above;
    }
  });
  __syncthreads();
}

__device__ __forceinline__ void append(u64* buf, int* cur, u64 v) {
  cg::coalesced_group g = cg::coalesced_threads();
  int base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(cur, static_cast<int>(g.size()));
  base = g.shfl(base, 0);
  buf[base + g.thread_rank()] = v;
}

__device__ __forceinline__ void bitonic_desc(u64* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const u64 x = a[lo];
        const u64 y = a[hi];
        if ((x < y) == desc) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

struct RowView {
  const uint8_t* m;
  const int32_t* rk;
  const uint32_t* top;
  int* hdr;
  u64* keys;
  u64 ceil;
};

__device__ __forceinline__ RowView row_view(const Select& p, int row) {
  RowView v;
  const int b = row / p.rows_per_rank;
  v.m = p.mask + static_cast<int64_t>(row) * p.r_pad;
  v.rk = p.rank ? p.rank + static_cast<int64_t>(b) * p.r_pad : nullptr;
  v.top = p.top + static_cast<int64_t>(p.rank ? b : 0) * p.top_words;
  v.hdr = p.hdr + static_cast<int64_t>(row) * p.a_stride;
  v.keys = p.keys + static_cast<int64_t>(row) * p.c_stride;
  v.ceil = p.first ? 0ull : p.ceil[row];
  return v;
}

// The row's slots of this select from its `n` candidate keys in s_keys
// (they hold the select's top p.need, or every selectable key when fewer):
// order them, write rows and flags, zero-fill the slots left invalid,
// write the count on the first select, keep the last key taken.
__device__ void emit_row(const Select& p, int row, const RowView& v,
                         u64* s_keys, int n) {
  const int tid = threadIdx.x;
  const int taken = min(p.need, n);
  const int64_t k = p.k;
  int32_t* o = p.out + static_cast<int64_t>(row) * (1 + 2 * k);
  const u64 row_mask = (1ull << p.row_bits) - 1;
  auto emit = [&](int pos, u64 kk) {
    const int64_t j = p.round_off + pos;
    o[1 + j] = p.r_pad - 1 - static_cast<int>(kk & row_mask);
    o[1 + k + j] = 1;
    if (pos == taken - 1) p.ceil[row] = kk;
  };
  if (n <= kCountSortMax) {
    for (int i = tid; i < n; i += kThreads) {
      const u64 kk = s_keys[i];
      int pos = 0;
      for (int j = 0; j < n; ++j) pos += s_keys[j] > kk;
      if (pos < taken) emit(pos, kk);
    }
  } else {
    int n2 = 1;
    while (n2 < n) n2 <<= 1;
    for (int i = n + tid; i < n2; i += kThreads) s_keys[i] = 0;
    __syncthreads();
    bitonic_desc(s_keys, n2);
    for (int i = tid; i < taken; i += kThreads) emit(i, s_keys[i]);
  }
  const int64_t end = p.last ? k : p.round_off + p.need;
  for (int64_t j = p.round_off + taken + tid; j < end; j += kThreads) {
    o[1 + j] = 0;
    o[1 + k + j] = 0;
  }
  if (p.first && tid == 0) o[0] = __ldcg(v.hdr + kCount);
}

__global__ void __launch_bounds__(kThreads) prep_kernel(Select p) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (!p.first) {  // a further select: every row's header and histogram
    const int64_t n = static_cast<int64_t>(p.n_rows) * p.a_stride;
    for (int64_t i = i0; i < n; i += stride) p.hdr[i] = 0;
    return;
  }
  // the headers only: count zeroes the histogram of a row it passes on
  const int64_t n_hdr = static_cast<int64_t>(p.n_rows) * kHdr;
  for (int64_t i = i0; i < n_hdr; i += stride)
    p.hdr[i / kHdr * p.a_stride + i % kHdr] = 0;
  for (int64_t i = i0; i < p.n_rows; i += stride) p.ceil[i] = 0;
  if (i0 == 0) p.todo[0] = 0;
  if (!p.fast_on) return;
  // one warp a 32-row word (the loop is warp-uniform: stride and n are
  // multiples of 32)
  const int64_t n = static_cast<int64_t>(p.n_top_rows) * p.top_words * 32;
  for (int64_t i = i0; i < n; i += stride) {
    const int64_t b = i / (static_cast<int64_t>(p.top_words) * 32);
    const int r = static_cast<int>(i - b * p.top_words * 32);
    bool in_top = false;
    if (r < p.r_pad) {
      const int s =
          score_of(p, p.rank ? p.rank + b * p.r_pad : nullptr, r);
      in_top = s > 0 && digit_of(p, s) >= p.d_top;
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, in_top);
    if ((threadIdx.x & 31) == 0) p.top[b * p.top_words + (r >> 5)] = bits;
  }
}

// the top-region bits of row[base, base + 16)
__device__ __forceinline__ uint32_t top_bits(const Select& p,
                                             const RowView& v, int base) {
  const int w = base >> 5;
  const uint32_t lo = __ldg(v.top + w);
  const uint32_t hi = w + 1 < p.top_words ? __ldg(v.top + w + 1) : 0u;
  return __funnelshift_r(lo, hi, base & 31) & 0xffffu;
}

// The last count block of a row: finish it from its top-region keys when
// they hold its top `need`; returns whether it did.  s_pool holds
// fast_cap keys, s_cand sort_keys.
__device__ bool finish_fast(const Select& p, int row, const RowView& v,
                            u64* s_pool, u64* s_cand, int* s_hist,
                            int* s_tmp, int* s_res, int* s_cur) {
  const int tid = threadIdx.x;
  const int n_fast = __ldcg(v.hdr + kFastN);
  const int count = __ldcg(v.hdr + kCount);
  if (n_fast > p.fast_cap || (n_fast < p.need && n_fast != count))
    return false;
  const u64* pool = p.fast + static_cast<int64_t>(row) * p.fast_cap;
  const int n_top = p.nbins - p.d_top;  // bins of the top region
  for (int i = tid; i < n_fast; i += kThreads) s_pool[i] = __ldcg(pool + i);
  for (int b = tid; b < n_top; b += kThreads) s_hist[b] = 0;
  if (tid == 0) *s_cur = 0;
  __syncthreads();
  int t = -1;
  if (n_fast > p.need) {
    for (int i = tid; i < n_fast; i += kThreads)
      atomicAdd(&s_hist[key_digit(p, s_pool[i]) - p.d_top], 1);
    __syncthreads();
    find_bin(s_hist, n_top, p.need, s_tmp, s_res);
    if (s_hist[s_res[0]] > p.tie_cap) return false;
    t = p.d_top + s_res[0];
  }
  for (int i = tid; i < n_fast; i += kThreads) {
    const u64 kk = s_pool[i];
    if (key_digit(p, kk) >= t) s_cand[atomicAdd(s_cur, 1)] = kk;
  }
  __syncthreads();
  emit_row(p, row, v, s_cand, *s_cur);
  return true;
}

__global__ void __launch_bounds__(kThreads) count_kernel(Select p) {
  extern __shared__ u64 s_dyn[];  // [fast_cap] staged keys, [sort_keys] sort
  __shared__ int s_hist[kMaxBins];
  __shared__ int s_tmp[kWarps];
  __shared__ int s_res[2];
  __shared__ int s_cur;
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int lo = blockIdx.x * p.count_seg_bytes;
  const int hi = blockIdx.x == p.count_segments - 1 ? p.r_pad
                                                    : lo + p.count_seg_bytes;
  for (int row = blockIdx.y; row < p.n_rows; row += gridDim.y) {
    const RowView v = row_view(p, row);
    if (tid == 0) s_cur = 0;
    __syncthreads();
    int cnt = 0;
    for_each_word(v.m, lo, hi, [&](int base, uint32_t bits) {
      cnt += __popc(bits);
      if (!p.fast_on) return;
      uint32_t hit = bits & top_bits(p, v, base);
      while (hit) {  // the row now, its key (a rank load) after the stream
        const int r = base + __ffs(hit) - 1;
        hit &= hit - 1;
        const int i = atomicAdd(&s_cur, 1);
        if (i < p.fast_cap) s_dyn[i] = static_cast<u64>(r);
      }
    });
    cnt = block_sum(cnt, s_tmp);
    if (p.fast_on) {
      // past fast_cap (the stage held the first fast_cap): the row goes on
      const int n_loc = s_cur;
      for (int i = tid; i < min(n_loc, p.fast_cap); i += kThreads) {
        const int r = static_cast<int>(s_dyn[i]);
        s_dyn[i] = key_of(p, score_of(p, v.rk, r), r);
      }
      if (tid == 0) s_res[0] = atomicAdd(v.hdr + kFastN, n_loc);
      __syncthreads();
      const int at = s_res[0];
      if (at + n_loc <= p.fast_cap) {
        u64* dst = p.fast + static_cast<int64_t>(row) * p.fast_cap + at;
        for (int i = tid; i < n_loc; i += kThreads) dst[i] = s_dyn[i];
      }
    }
    if (tid == 0) atomicAdd(v.hdr + kCount, cnt);
    __threadfence();
    __syncthreads();
    if (tid == 0)
      s_last = atomicAdd(v.hdr + kDone0, 1) == p.count_segments - 1;
    __syncthreads();
    if (s_last) {
      __threadfence();
      const bool done =
          p.fast_on && finish_fast(p, row, v, s_dyn, s_dyn + p.fast_cap,
                                   s_hist, s_tmp, s_res, &s_cur);
      if (!done) {  // to the general passes, with a zeroed histogram
        for (int b = tid; b < p.nbins; b += kThreads) v.hdr[kHdr + b] = 0;
        if (tid == 0) p.todo[1 + atomicAdd(p.todo, 1)] = row;
      }
    }
    __syncthreads();
  }
}

// The (segment, row) work items of the general passes, a grid-stride loop
// over them: the rows the count pass left (the first select), or every
// row (a further one).
template <class F>
__device__ __forceinline__ void for_each_item(const Select& p, F&& f) {
  const int rows = p.first ? *p.todo : p.n_rows;
  const int64_t n = static_cast<int64_t>(rows) * p.segments;
  for (int64_t i = blockIdx.x; i < n; i += gridDim.x) {
    const int j = static_cast<int>(i / p.segments);
    f(static_cast<int>(i - static_cast<int64_t>(j) * p.segments),
      p.first ? p.todo[1 + j] : j);
  }
}

__global__ void __launch_bounds__(kThreads) hist_kernel(Select p) {
  __shared__ int s_hist[kMaxBins];
  __shared__ int s_tmp[kWarps];
  __shared__ int s_res[2];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  for_each_item(p, [&](int seg, int row) {
    const int lo = seg * p.seg_bytes;
    const int hi = seg == p.segments - 1 ? p.r_pad : lo + p.seg_bytes;
    const RowView v = row_view(p, row);
    int* hist = v.hdr + kHdr;
    for (int b = tid; b < p.nbins; b += kThreads) s_hist[b] = 0;
    __syncthreads();
    int sel = 0;
    for_each_set(v.m, lo, hi, [&](int r) {
      const int s = score_of(p, v.rk, r);
      if (s <= 0 || (v.ceil && key_of(p, s, r) >= v.ceil)) return;
      ++sel;
      atomicAdd(&s_hist[digit_of(p, s)], 1);
    });
    sel = block_sum(sel, s_tmp);
    for_each_bin_above(s_hist, p.nbins, s_tmp, [&](int b, int above) {
      if (s_hist[b] && above < p.need) atomicAdd(hist + b, s_hist[b]);
    });
    if (tid == 0) atomicAdd(v.hdr + kSel, sel);
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(v.hdr + kDone1, 1) == p.segments - 1;
    __syncthreads();
    if (s_last) {
      __threadfence();
      const int total = __ldcg(v.hdr + kSel);
      if (total <= p.need) {
        if (tid == 0) {
          v.hdr[kThresh] = -1;
          v.hdr[kAbove] = total;
          v.hdr[kOverflow] = 0;
        }
      } else {
        for (int b = tid; b < p.nbins; b += kThreads)
          s_hist[b] = __ldcg(hist + b);
        __syncthreads();
        find_bin(s_hist, p.nbins, p.need, s_tmp, s_res);
        if (tid == 0) {
          v.hdr[kThresh] = s_res[0];
          v.hdr[kAbove] = s_res[1];
          v.hdr[kOverflow] = s_hist[s_res[0]] > p.tie_cap;
        }
      }
    }
    __syncthreads();
  });
}

// The rows of threshold bin t that belong to the select, exactly, when
// the bin overflows the tie region: a radix select over the keys of bin t
// by one block, one pass over the row per digit, then the keys at or
// above the found prefix are appended to dst.  Returns their number
// (need_t).
__device__ int refine(const Select& p, const RowView& v, int t, int need_t,
                      u64* dst, int* s_tmp) {
  __shared__ int s_h[1 << kRefineBits];
  __shared__ int s_res[2];
  __shared__ int s_n;
  const int tid = threadIdx.x;
  // the largest score bin t can hold (clamped scores: any int)
  const int64_t top = static_cast<int64_t>(t + 1) << p.shift;
  const int s_max = t == p.nbins - 1 || top > INT_MAX
                        ? INT_MAX : static_cast<int>(top);
  int hi = p.row_bits + (32 - __clz(s_max)) - 1;
  u64 prefix = 0;
  for (;;) {
    const int w = min(kRefineBits, hi + 1);
    const int lo = hi + 1 - w;
    for (int b = tid; b < (1 << kRefineBits); b += kThreads) s_h[b] = 0;
    __syncthreads();
    for_each_set(v.m, 0, p.r_pad, [&](int r) {
      const int s = score_of(p, v.rk, r);
      if (s <= 0 || digit_of(p, s) != t) return;
      const u64 kk = key_of(p, s, r);
      if ((v.ceil && kk >= v.ceil) || (kk >> (hi + 1)) != (prefix >> (hi + 1)))
        return;
      atomicAdd(&s_h[(kk >> lo) & ((1u << w) - 1)], 1);
    });
    __syncthreads();
    find_bin(s_h, 1 << w, need_t, s_tmp, s_res);
    const int b = s_res[0];
    need_t -= s_res[1];
    prefix |= static_cast<u64>(b) << lo;
    const bool done = s_h[b] == need_t || lo == 0;
    __syncthreads();
    if (done) break;
    hi = lo - 1;
  }
  if (tid == 0) s_n = 0;
  __syncthreads();
  for_each_set(v.m, 0, p.r_pad, [&](int r) {
    const int s = score_of(p, v.rk, r);
    if (s <= 0 || digit_of(p, s) != t) return;
    const u64 kk = key_of(p, s, r);
    if ((v.ceil && kk >= v.ceil) || kk < prefix) return;
    dst[atomicAdd(&s_n, 1)] = kk;
  });
  __syncthreads();
  return s_n;
}

// The last collect block of a row: gather the candidates, write the row's
// slots of this select.
__device__ void finish(const Select& p, int row, const RowView& v,
                       u64* s_keys, int* s_tmp) {
  const int tid = threadIdx.x;
  const int t = v.hdr[kThresh];
  const int n_above = __ldcg(v.hdr + kCandCur);
  for (int i = tid; i < n_above; i += kThreads)
    s_keys[i] = __ldcg(v.keys + i);
  int n = n_above;
  if (v.hdr[kOverflow]) {
    n += refine(p, v, t, p.need - n_above, s_keys + n_above, s_tmp);
  } else if (t >= 0) {
    const int n_tie = __ldcg(v.hdr + kTieCur);
    const u64* tie = v.keys + p.chunk;
    for (int i = tid; i < n_tie; i += kThreads)
      s_keys[n_above + i] = __ldcg(tie + i);
    n += n_tie;
  }
  __syncthreads();
  emit_row(p, row, v, s_keys, n);
}

__global__ void __launch_bounds__(kThreads) collect_kernel(Select p) {
  extern __shared__ u64 s_keys[];
  __shared__ int s_tmp[kWarps];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  for_each_item(p, [&](int seg, int row) {
    const int lo = seg * p.seg_bytes;
    const int hi = seg == p.segments - 1 ? p.r_pad : lo + p.seg_bytes;
    const RowView v = row_view(p, row);
    const int t = v.hdr[kThresh];
    const bool tie_ok = !v.hdr[kOverflow];
    u64* tie = v.keys + p.chunk;
    for_each_set(v.m, lo, hi, [&](int r) {
      const int s = score_of(p, v.rk, r);
      if (s <= 0) return;
      const u64 kk = key_of(p, s, r);
      if (v.ceil && kk >= v.ceil) return;
      const int d = digit_of(p, s);
      if (d > t)
        append(v.keys, v.hdr + kCandCur, kk);
      else if (d == t && tie_ok)
        append(tie, v.hdr + kTieCur, kk);
    });
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(v.hdr + kDone2, 1) == p.segments - 1;
    __syncthreads();
    if (s_last) {
      __threadfence();
      finish(p, row, v, s_keys, s_tmp);
    }
    __syncthreads();
  });
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  // once per device, kernel and size, so a call captured in a CUDA graph
  // after a first call makes no attribute call
  static int set_bytes[2][kMaxDevices] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& set = set_bytes[kernel == reinterpret_cast<const void*>(count_kernel)]
                      [dev];
  if (set < static_cast<int>(bytes)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e) return e;
    set = static_cast<int>(bytes);
  }
  return cudaSuccess;
}

}  // namespace

// Count + capped top-k of n_rows mask rows of r_pad bytes; mask row b
// scores by rank row b / rows_per_rank (rank may be null: raw row order).
// The select's geometry comes from the wrapper's plan (kernels/topk.py
// `_plan`); `scratch` holds its scratch_bytes.  Returns cudaGetLastError()
// (or cudaErrorInvalidValue for a plan the kernels cannot run).
extern "C" int gk_topk_packed(
    const void* mask, const void* rank, void* out, void* scratch,
    int64_t n_rows, int64_t rows_per_rank, int64_t r_pad, int64_t k,
    int64_t segments, int64_t seg_bytes, int64_t count_segments,
    int64_t count_seg_bytes, int64_t shift, int64_t nbins, int64_t row_bits,
    int64_t chunk, int64_t tie_cap, int64_t sort_keys, int64_t fast_on,
    int64_t d_top, int64_t fast_cap, int64_t top_words, int64_t a_stride,
    int64_t c_stride, int64_t off_a, int64_t off_c, int64_t off_fast,
    int64_t off_top, int64_t off_todo, int64_t scratch_bytes, void* stream) {
  if (n_rows <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 0 || rows_per_rank <= 0 || r_pad < 0 || r_pad >= INT_MAX ||
      k >= INT_MAX / 2 || n_rows >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t k_eff = std::min(k, r_pad);
  if (k_eff == 0) {
    const cudaError_t e = cudaMemsetAsync(
        out, 0, static_cast<size_t>(n_rows) * (1 + 2 * k) * 4, st);
    return static_cast<int>(e ? e : cudaGetLastError());
  }
  const int64_t top_rows =
      rank ? (n_rows + rows_per_rank - 1) / rows_per_rank : 1;
  const int64_t rounds = (k_eff + chunk - 1) / chunk;
  if (segments < 1 || segments > r_pad || seg_bytes < 1 ||
      seg_bytes * (segments - 1) >= r_pad || count_segments < 1 ||
      count_segments > r_pad || count_seg_bytes < 1 ||
      count_seg_bytes * (count_segments - 1) >= r_pad || nbins < 1 ||
      nbins > kMaxBins || shift < 0 || shift > 30 ||
      ((r_pad - 1) >> shift) >= nbins || row_bits < 0 || row_bits > 31 ||
      ((r_pad - 1) >> row_bits) != 0 || chunk < 1 || tie_cap < 1 ||
      chunk + tie_cap - 1 > sort_keys || sort_keys > kSortMax ||
      (sort_keys & (sort_keys - 1)) || a_stride < kHdr + nbins ||
      c_stride < chunk + tie_cap || off_a < 8 * n_rows ||
      off_c < off_a + 4 * a_stride * n_rows || off_c % 16 ||
      (fast_on && (rounds != 1 || fast_cap < 1 || d_top < 0 ||
                   d_top >= nbins || top_words * 32 < r_pad)) ||
      off_fast < off_c + 8 * c_stride * n_rows || off_fast % 16 ||
      off_top < off_fast + (fast_on ? 8 * fast_cap * n_rows : 0) ||
      off_top % 16 ||
      off_todo < off_top + (fast_on ? 4 * top_words * top_rows : 0) ||
      off_todo % 16 || scratch_bytes < off_todo + 4 * (1 + n_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(sort_keys) * sizeof(u64);
  const size_t count_smem =
      fast_on ? static_cast<size_t>(fast_cap + sort_keys) * 8 : 0;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(collect_kernel),
                             smem);
  if (!e)
    e = allow_smem(reinterpret_cast<const void*>(count_kernel), count_smem);
  if (e) return static_cast<int>(e);
  char* base = static_cast<char*>(scratch);
  Select p;
  p.mask = static_cast<const uint8_t*>(mask);
  p.rank = static_cast<const int32_t*>(rank);
  p.out = static_cast<int32_t*>(out);
  p.ceil = reinterpret_cast<u64*>(base);
  p.hdr = reinterpret_cast<int*>(base + off_a);
  p.keys = reinterpret_cast<u64*>(base + off_c);
  p.fast = reinterpret_cast<u64*>(base + off_fast);
  p.top = reinterpret_cast<uint32_t*>(base + off_top);
  p.todo = reinterpret_cast<int*>(base + off_todo);
  p.n_rows = static_cast<int>(n_rows);
  p.rows_per_rank = static_cast<int>(rows_per_rank);
  p.n_top_rows = static_cast<int>(top_rows);
  p.r_pad = static_cast<int>(r_pad);
  p.k = static_cast<int>(k);
  p.segments = static_cast<int>(segments);
  p.seg_bytes = static_cast<int>(seg_bytes);
  p.count_segments = static_cast<int>(count_segments);
  p.count_seg_bytes = static_cast<int>(count_seg_bytes);
  p.shift = static_cast<int>(shift);
  p.nbins = static_cast<int>(nbins);
  p.row_bits = static_cast<int>(row_bits);
  p.tie_cap = static_cast<int>(tie_cap);
  p.a_stride = static_cast<int>(a_stride);
  p.c_stride = static_cast<int>(c_stride);
  p.chunk = static_cast<int>(chunk);
  p.fast_on = static_cast<int>(fast_on);
  p.d_top = static_cast<int>(d_top);
  p.fast_cap = static_cast<int>(fast_cap);
  p.top_words = static_cast<int>(top_words);
  const dim3 count_grid(
      static_cast<unsigned>(count_segments),
      static_cast<unsigned>(std::min<int64_t>(n_rows, kMaxGridY)));
  const unsigned item_blocks = static_cast<unsigned>(
      std::min<int64_t>(segments * n_rows, kItemBlocks));
  const int64_t prep_items = std::max<int64_t>(
      n_rows * a_stride, fast_on ? top_rows * top_words * 32 : 0);
  const unsigned prep_blocks = static_cast<unsigned>(
      std::min<int64_t>((prep_items + kThreads - 1) / kThreads, 1024));
  for (int64_t r = 0; r < rounds; ++r) {
    p.round_off = static_cast<int>(r * chunk);
    p.need = static_cast<int>(std::min(chunk, k_eff - r * chunk));
    p.first = r == 0;
    p.last = r == rounds - 1;
    prep_kernel<<<prep_blocks, kThreads, 0, st>>>(p);
    if (r == 0)
      count_kernel<<<count_grid, kThreads, count_smem, st>>>(p);
    hist_kernel<<<item_blocks, kThreads, 0, st>>>(p);
    collect_kernel<<<item_blocks, kThreads, smem, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
