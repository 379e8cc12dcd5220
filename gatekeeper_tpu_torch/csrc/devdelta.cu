// K6: the devpages delta -- page-table gather, XOR with the resident mask,
// ordered compaction of the changed bits, their count and row_any.
//
// Replaces the JAX package's engine/veval.py `ProgramExecutor.
// eval_mask_delta` (its jitted `raw`, after `_eval_mask`), item B6 of the
// port's kernel table.  Inputs: the fresh violation mask `nw` bool [C, R]
// (K1's output), the page table `pt` int32 [R] (row -> slot), the resident
// mask `old` bool [C, R] and a run-time width k.  Outputs:
//   out     bool [C, R]  out[c, r] = nw[c, pt[r]]  (the new resident mask)
//   idx     int32 [k]    ascending flat indices of out ^ old, -1 past count
//   signs   bool [k]     out.ravel()[max(idx, 0)] (a -1 slot reads out[0, 0])
//   total   int32        the number of changed bits (may exceed k)
//   row_any bool [R]     out.any(0)
// A page-table entry outside [0, R) reads as jnp.take reads it: a negative
// one counts from the end, one still outside reads True (take's fill).
//
// jnp.nonzero(size=k) keeps ascending order, so the compaction is a
// prefix sum, not atomics.  Three launches:
//   1. gather_count: each block takes a tile of kTile flat elements,
//      gathers through pt, writes out, and counts its changed bits with
//      __ballot_sync/__popc;
//   2. scan: one block scans the per-tile counts into exclusive offsets
//      (warp-shuffle scan) and writes the total;
//   3. compact: each block with changed bits whose offset is below k
//      re-reads its tile of out and old and places each changed bit at
//      offset + block prefix (ballot + per-warp popc, in element order);
//      then every thread helps fill [total, k) with -1 / out[0, 0] and
//      compute row_any, one thread per column looping over C (coalesced
//      across R).
// Single-pass decoupled look-back would fold 2 and 3 into 1.
//
// Bound on the H100: bytes.  The function must read nw, old and pt and
// write out, row_any, idx and signs once (about 3 C R bytes); this design
// moves about 5-6 C R bytes: launch 3 reads out and old again for tiles
// with changes and out once more for row_any.  Flat indices are int32
// (the reference's idx type), so C * R must stay below 2^31 - kTile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                  // elements per thread per tile
constexpr int kTile = kThreads * kItems;    // 4096 flat elements
constexpr int kScanThreads = 1024;

__device__ __forceinline__ uint8_t gather(const uint8_t* __restrict__ nw,
                                          const int32_t* __restrict__ pt,
                                          int c, int r, int n_rows) {
  int s = pt[r];
  if (s < 0) s += n_rows;
  if (s < 0 || s >= n_rows) return 1;
  return nw[c * n_rows + s] != 0;
}

__global__ void gather_count_kernel(const uint8_t* __restrict__ nw,
                                    const int32_t* __restrict__ pt,
                                    const uint8_t* __restrict__ old,
                                    uint8_t* __restrict__ out,
                                    int32_t* __restrict__ tile_counts,
                                    int n_rows, int total) {
  __shared__ int32_t warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kTile;
  int32_t mine = 0;
  for (int j = 0; j < kItems; ++j) {
    const int f = base + j * kThreads + threadIdx.x;
    bool d = false;
    if (f < total) {
      const int c = f / n_rows;
      const uint8_t g = gather(nw, pt, c, f - c * n_rows, n_rows);
      out[f] = g;
      d = g != (old[f] != 0);
    }
    mine += __popc(__ballot_sync(0xffffffffu, d));
  }
  if (lane == 0) warp_sums[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
    tile_counts[blockIdx.x] = s;
  }
}

__global__ void scan_kernel(const int32_t* __restrict__ counts,
                            int32_t* __restrict__ offsets,
                            int32_t* __restrict__ total_out, int n_tiles) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, n_tiles);
  int32_t s = 0;
  for (int i = lo; i < hi; ++i) s += counts[i];
  int32_t incl = s;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int32_t w = warp_sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t v = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += v;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int32_t run = incl - s + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    offsets[i] = run;
    run += counts[i];
  }
  if (threadIdx.x == kScanThreads - 1) *total_out = run;
}

__global__ void compact_kernel(const uint8_t* __restrict__ out,
                               const uint8_t* __restrict__ old,
                               const int32_t* __restrict__ tile_counts,
                               const int32_t* __restrict__ offsets,
                               const int32_t* __restrict__ total_ptr,
                               int32_t* __restrict__ idx,
                               uint8_t* __restrict__ signs,
                               uint8_t* __restrict__ row_any, int c_rows,
                               int n_rows, int total, int k) {
  __shared__ int32_t warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  // block-uniform: every thread of the block sees the same count and run
  if (tile_counts[b] > 0 && offsets[b] < k) {
    const unsigned below = (1u << lane) - 1u;
    int32_t run = offsets[b];
    const int base = b * kTile;
    for (int j = 0; j < kItems && run < k; ++j) {
      const int f = base + j * kThreads + threadIdx.x;
      const bool d = f < total && ((out[f] != 0) != (old[f] != 0));
      const unsigned bits = __ballot_sync(0xffffffffu, d);
      if (lane == 0) warp_sums[warp] = __popc(bits);
      __syncthreads();
      int32_t before = 0, all = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int32_t v = warp_sums[w];
        before += w < warp ? v : 0;
        all += v;
      }
      const int32_t pos = run + before + __popc(bits & below);
      if (d && pos < k) {
        idx[pos] = f;
        signs[pos] = out[f];
      }
      run += all;
      __syncthreads();
    }
  }
  // 64-bit strides: count + tid and r + stride may pass 2^31
  const int64_t tid = static_cast<int64_t>(b) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int32_t count = *total_ptr;
  const uint8_t first = out[0];
  for (int64_t p = count + tid; p < k; p += stride) {
    idx[p] = -1;
    signs[p] = first;
  }
  for (int64_t r = tid; r < n_rows; r += stride) {
    uint8_t any = 0;
    for (int c = 0; c < c_rows; ++c) any |= out[c * n_rows + r];
    row_any[r] = any != 0;
  }
}

}  // namespace

// scratch: int32 [2 * n_tiles + 1] -- per-tile counts, their exclusive
// offsets, and the total (the caller reads it as the count).  Returns the
// first launch's nonzero cudaGetLastError(), or cudaErrorInvalidValue for
// shapes the kernels do not take (n_tiles must be ceil(C * R / kTile), so
// a caller with another tile size is refused).
extern "C" int gk_devdelta(const void* nw, const void* pt, const void* old,
                           void* out, void* idx, void* signs, void* row_any,
                           void* scratch, int c_rows, int n_rows, int k,
                           int n_tiles, void* stream) {
  const long long total = static_cast<long long>(c_rows) * n_rows;
  if (c_rows <= 0 || n_rows <= 0 || k <= 0 ||
      total > 0x7fffffffLL - kTile ||
      n_tiles != static_cast<int>((total + kTile - 1) / kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* counts = static_cast<int32_t*>(scratch);
  int32_t* offsets = counts + n_tiles;
  int32_t* total_out = offsets + n_tiles;
  const uint8_t* nw8 = static_cast<const uint8_t*>(nw);
  const uint8_t* old8 = static_cast<const uint8_t*>(old);
  uint8_t* out8 = static_cast<uint8_t*>(out);
  gather_count_kernel<<<n_tiles, kThreads, 0, s>>>(
      nw8, static_cast<const int32_t*>(pt), old8, out8, counts, n_rows,
      static_cast<int>(total));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<1, kScanThreads, 0, s>>>(counts, offsets, total_out,
                                         n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_kernel<<<n_tiles, kThreads, 0, s>>>(
      out8, old8, counts, offsets, total_out, static_cast<int32_t*>(idx),
      static_cast<uint8_t*>(signs), static_cast<uint8_t*>(row_any), c_rows,
      n_rows, static_cast<int>(total), k);
  return static_cast<int>(cudaGetLastError());
}
