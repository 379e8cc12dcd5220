// K6: the devpages delta -- page-table gather, XOR with the resident mask,
// ordered compaction of the changed bits, their count and row_any.
//
// Replaces the JAX package's engine/veval.py `ProgramExecutor.
// eval_mask_delta` (its jitted `raw`, after `_eval_mask`), item B6 of the
// port's kernel table.  Inputs: the fresh violation mask `nw` bool [C, R]
// (K1's output), the page table `pt` int32 [R] (row -> slot), the resident
// mask `old` bool [C, R] and a run-time width k.  Outputs:
//   out     bool [C, R]  out[c, r] = nw[c, pt[r]]  (the new resident mask)
// and, in one packed buffer (layout below):
//   idx     int32 [k]    ascending flat indices of out ^ old, -1 past count
//   count   int32        the number of changed bits (may exceed k)
//   signs   bool [k]     out.ravel()[max(idx, 0)] (a -1 slot reads out[0, 0])
//   row_any bool [R]     out.any(0)
// A page-table entry outside [0, R) reads as jnp.take reads it: a negative
// one counts from the end, one still outside reads True (take's fill).
//
// Bound on the H100: bytes.  The function must read nw, old and pt and
// write out, row_any, idx and signs once: about 3 C R bytes.
//
// Design: one pass, one launch (Merrill & Garland's single-pass prefix
// scan with decoupled look-back).  jnp.nonzero(size=k) keeps ascending
// order, so the compaction is a prefix sum over tiles of kTile flat
// elements:
//   - each block takes its tile from an atomic ticket, so tiles start in
//     order and a block only ever waits on tiles already running;
//   - each thread owns kItems (16) consecutive elements: it gathers
//     them, writes them to `out` and keeps them and their changed bits in
//     registers;
//     a block scan of the threads' counts gives each thread its place in
//     the tile;
//   - warp 0 publishes the tile's aggregate, then looks back over its
//     predecessors' status words 32 at a time (an aggregate, or an
//     inclusive prefix that ends the look-back) and publishes the tile's
//     inclusive prefix;
//   - each thread writes its changed bits' idx and signs from registers:
//     neither `out` nor `old` is read again;
//   - row_any is set in the same pass: a thread reads its rows' row_any
//     words from L2 (one 16-byte load) and ORs in, with a 32-bit
//     atomicOr, each word that sets a byte the read does not show; on a
//     dense mask the first constraint rows set most bytes and later ones
//     skip their atomics; row_any starts at 0 from the memset below;
//   - the block with the last ticket knows the total: it writes `count`
//     and, for k up to kFillInKernel, fills [count, k) with -1 and
//     out[0, 0].  A wider k (the overflow ladder can reach C * R) takes a
//     second, grid-wide fill launch.
// One cudaMemsetAsync beside the launch zeroes row_any, the tile status
// words and the ticket (one contiguous region), so the call replays
// correctly from a CUDA graph.
// Fast path (R a multiple of kTile, every pointer 16-byte aligned, as the
// path's power-of-two R_pad >= 4096 gives): a tile never crosses a
// constraint row, `old` is read and `out` written as 16-byte vectors, `pt`
// as four int4 per thread, the row index comes from the tile (no element
// divides), and a run of consecutive page-table entries from a 16-aligned
// slot gathers `nw` as 16-byte vectors; an identity run takes the vector
// at the rows themselves, loaded beside `old` and `pt` before the check,
// so the identity table costs no dependent load; other runs gather byte
// by byte.  Ragged shapes take an element-wise branch that divides
// per element and stores row_any bytes directly.  Flat indices are int32
// (the reference's idx type), so C * R must stay below 2^31 - kTile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                  // consecutive elements a thread
constexpr int kVecs = kItems / 16;          // their 16-byte vectors
constexpr int kWords = kItems / 4;          // their 32-bit words
constexpr int kTile = kThreads * kItems;    // flat elements a block
constexpr int kFillInKernel = 1 << 14;      // widest k the last block fills
constexpr int kFillThreads = 256;
constexpr int kFillBlocks = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

struct Packed {
  int32_t* idx;
  int32_t* count;
  uint8_t* signs;
  uint8_t* row_any;
  unsigned long long* status;
  unsigned int* ticket;
};

__device__ __forceinline__ uint32_t gather1(const uint8_t* __restrict__ nw,
                                            const int32_t* __restrict__ pt,
                                            long long c_off, int r,
                                            int n_rows) {
  int s = pt[r];
  if (s < 0) s += n_rows;
  if (s < 0 || s >= n_rows) return 1;
  return nw[c_off + s] != 0;
}

// each byte of x to 0 or 1 (bit 0 of each byte ORs that byte's 8 bits)
__device__ __forceinline__ uint32_t norm_bytes(uint32_t x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  return x & 0x01010101u;
}

// bit 0 of each of the 4 bytes of a normalised word, as 4 bits
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  return (x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) | ((x >> 21) & 8u);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

__device__ __forceinline__ int lane_of(const int4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

template <bool kFast>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const uint8_t* __restrict__ nw,
                 const int32_t* __restrict__ pt,
                 const uint8_t* __restrict__ old, uint8_t* __restrict__ out,
                 Packed o, int n_rows, int total, int k, int n_tiles,
                 int fill_here) {
  __shared__ int s_tile;
  __shared__ int32_t s_warp[kWarps];
  __shared__ int32_t s_excl;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(o.ticket, 1u));
  __syncthreads();
  const int tile = s_tile;
  const int f0 = tile * kTile + tid * kItems;

  uint32_t gw[kWords];    // the gathered bytes (0/1), 4 a word
  uint32_t diff = 0;      // bit j: element f0 + j changed
  if (kFast) {
    const int tiles_per_row = n_rows / kTile;
    const int c = tile / tiles_per_row;
    const int r0 = (tile - c * tiles_per_row) * kTile + tid * kItems;
    const long long c_off = static_cast<long long>(c) * n_rows;
    // every load at once: old, the page table, and nw at the rows
    // themselves, which an identity run of the page table reads
    uint4 ov[kVecs], sv[kVecs];
    int4 p[kWords];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      ov[v] = reinterpret_cast<const uint4*>(old + f0)[v];
      sv[v] = reinterpret_cast<const uint4*>(nw + c_off + r0)[v];
    }
#pragma unroll
    for (int q = 0; q < kWords; ++q)
      p[q] = reinterpret_cast<const int4*>(pt + r0)[q];
    // a run of consecutive in-range slots from a 16-aligned s0 gathers
    // as vectors (from the rows themselves for an identity run)
    const int s0 = p[0].x;
    bool vec = s0 >= 0 && s0 <= n_rows - kItems && (s0 & 15) == 0;
#pragma unroll
    for (int q = 0; q < kWords; ++q)
      vec = vec && p[q].x == s0 + 4 * q && p[q].y == s0 + 4 * q + 1 &&
            p[q].z == s0 + 4 * q + 2 && p[q].w == s0 + 4 * q + 3;
    if (vec && s0 != r0) {
#pragma unroll
      for (int v = 0; v < kVecs; ++v)
        sv[v] = reinterpret_cast<const uint4*>(nw + c_off + s0)[v];
    }
    if (vec) {
#pragma unroll
      for (int q = 0; q < kWords; ++q)
        gw[q] = norm_bytes(word_of(sv[q >> 2], q & 3));
    } else {
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        uint32_t w = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          int s = lane_of(p[q], b);
          if (s < 0) s += n_rows;
          const uint32_t g =
              (s < 0 || s >= n_rows) ? 1u : (nw[c_off + s] != 0);
          w |= g << (8 * b);
        }
        gw[q] = w;
      }
    }
#pragma unroll
    for (int v = 0; v < kVecs; ++v)
      reinterpret_cast<uint4*>(out + f0)[v] =
          make_uint4(gw[4 * v], gw[4 * v + 1], gw[4 * v + 2], gw[4 * v + 3]);
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      const uint32_t was = norm_bytes(word_of(ov[q >> 2], q & 3));
      diff |= pack4(gw[q] ^ was) << (4 * q);
    }
    // row_any: an atomicOr for each word that sets a byte an L2 read of
    // row_any does not already show (a stale read only costs an atomic,
    // never loses a bit); on a dense mask the first rows set most bytes
    uint32_t* ra = reinterpret_cast<uint32_t*>(o.row_any + r0);
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const uint4 have = __ldcg(reinterpret_cast<const uint4*>(ra) + v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t w = gw[4 * v + i];
        if (w & ~word_of(have, i)) atomicOr(ra + 4 * v + i, w);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < kWords; ++q) gw[q] = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int f = f0 + j;
      if (f < total) {
        const int c = f / n_rows;
        const int r = f - c * n_rows;
        const uint32_t g =
            gather1(nw, pt, static_cast<long long>(c) * n_rows, r, n_rows);
        out[f] = static_cast<uint8_t>(g);
        gw[j >> 2] |= g << (8 * (j & 3));
        diff |= (g ^ static_cast<uint32_t>(old[f] != 0)) << j;
        if (g) o.row_any[r] = 1;
      }
    }
  }
  uint32_t gbits = 0;
#pragma unroll
  for (int q = 0; q < kWords; ++q) gbits |= pack4(gw[q]) << (4 * q);

  // block scan of the threads' counts, in thread (= flat) order
  const int32_t n = __popc(diff);
  int32_t incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int32_t v = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int32_t t = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += t;
    }
    if (lane < kWarps) s_warp[lane] = v;
  }
  __syncthreads();
  const int32_t agg = s_warp[kWarps - 1];
  const int32_t thread_excl = (warp ? s_warp[warp - 1] : 0) + incl - n;

  // decoupled look-back: warp 0 publishes the aggregate, sums its
  // predecessors' until an inclusive prefix, publishes its own
  if (warp == 0) {
    volatile unsigned long long* st = o.status;
    int32_t excl = 0;
    if (tile == 0) {
      if (lane == 0)
        st[0] = kInclusive | static_cast<uint32_t>(agg);
    } else {
      if (lane == 0)
        st[tile] = kAggregate | static_cast<uint32_t>(agg);
      int j = tile - 1 - lane;
      while (true) {
        unsigned long long s = kInclusive;   // before tile 0: prefix 0
        if (j >= 0) {
          do {
            s = st[j];
          } while ((s >> 32) == 0);
        }
        const unsigned inc = __ballot_sync(kFull, (s >> 32) == 2);
        const int stop = inc ? __ffs(inc) - 1 : 31;
        int32_t v = lane <= stop ? static_cast<int32_t>(s & 0xffffffffu) : 0;
#pragma unroll
        for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
        excl += v;
        if (inc) break;
        j -= 32;
      }
      if (lane == 0)
        st[tile] = kInclusive | static_cast<uint32_t>(excl + agg);
    }
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  const int32_t excl = s_excl;

  // idx and signs from registers, in element order
  int32_t pos = excl + thread_excl;
  uint32_t m = diff;
  while (m && pos < k) {
    const int j = __ffs(m) - 1;
    m &= m - 1;
    o.idx[pos] = f0 + j;
    o.signs[pos] = static_cast<uint8_t>((gbits >> j) & 1u);
    ++pos;
  }

  if (tile == n_tiles - 1) {
    const int32_t count = excl + agg;
    if (tid == 0) *o.count = count;
    if (fill_here) {
      const uint8_t first =
          static_cast<uint8_t>(gather1(nw, pt, 0, 0, n_rows));
      for (long long p = static_cast<long long>(count) + tid; p < k;
           p += kThreads) {
        o.idx[p] = -1;
        o.signs[p] = first;
      }
    }
  }
}

// [count, k) for a k past kFillInKernel, after the delta kernel
__global__ void fill_kernel(const uint8_t* __restrict__ out,
                            const int32_t* __restrict__ count,
                            int32_t* __restrict__ idx,
                            uint8_t* __restrict__ signs, int k) {
  const uint8_t first = out[0] != 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(*count) +
                     static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       p < k; p += stride) {
    idx[p] = -1;
    signs[p] = first;
  }
}

long long align16(long long x) { return (x + 15) / 16 * 16; }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The packed buffer, in bytes (kernels/devdelta.py `layout` computes the
// same and passes its size, which must match):
//   [0, 4k)                  idx
//   [4k, 4k + 4)             count
//   [4k + 4, 4k + 4 + k)     signs
//   [ra, ra + R)             row_any, ra = align16(5k + 4)
//   [st, st + 8 n_tiles)     tile status words, st = align16(ra + R)
//   [st + 8 n_tiles, +4)     the ticket; the buffer ends 16-aligned
// The host copies [0, ra + R); the memset zeroes [ra, end).  Returns the
// first nonzero cudaError_t of the memset and the launches, or
// cudaErrorInvalidValue for shapes the kernel does not take or a buffer
// of another size.
extern "C" int gk_devdelta(const void* nw, const void* pt, const void* old,
                           void* out, void* packed, long long packed_bytes,
                           int c_rows, int n_rows, int k, void* stream) {
  const long long total = static_cast<long long>(c_rows) * n_rows;
  if (c_rows <= 0 || n_rows <= 0 || k <= 0 ||
      total > 0x7fffffffLL - kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = static_cast<int>((total + kTile - 1) / kTile);
  const long long ra = align16(5LL * k + 4);
  const long long st = align16(ra + n_rows);
  const long long end = align16(st + 8LL * n_tiles + 4);
  if (packed_bytes != end || !aligned16(packed))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* base = static_cast<uint8_t*>(packed);
  Packed o{reinterpret_cast<int32_t*>(base),
           reinterpret_cast<int32_t*>(base + 4LL * k), base + 4LL * k + 4,
           base + ra, reinterpret_cast<unsigned long long*>(base + st),
           reinterpret_cast<unsigned int*>(base + st + 8LL * n_tiles)};
  cudaError_t err = cudaMemsetAsync(base + ra, 0, end - ra, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint8_t* nw8 = static_cast<const uint8_t*>(nw);
  const int32_t* pt32 = static_cast<const int32_t*>(pt);
  const uint8_t* old8 = static_cast<const uint8_t*>(old);
  uint8_t* out8 = static_cast<uint8_t*>(out);
  const int fill_here = k <= kFillInKernel;
  if (n_rows % kTile == 0 && aligned16(nw) && aligned16(pt) &&
      aligned16(old) && aligned16(out))
    delta_kernel<true><<<n_tiles, kThreads, 0, s>>>(
        nw8, pt32, old8, out8, o, n_rows, static_cast<int>(total), k,
        n_tiles, fill_here);
  else
    delta_kernel<false><<<n_tiles, kThreads, 0, s>>>(
        nw8, pt32, old8, out8, o, n_rows, static_cast<int>(total), k,
        n_tiles, fill_here);
  err = cudaGetLastError();
  if (err != cudaSuccess || fill_here) return static_cast<int>(err);
  const long long want = (static_cast<long long>(k) + kFillThreads - 1) /
                         kFillThreads;
  fill_kernel<<<static_cast<int>(want < kFillBlocks ? want : kFillBlocks),
                kFillThreads, 0, s>>>(out8, o.count, o.idx, o.signs, k);
  return static_cast<int>(cudaGetLastError());
}
