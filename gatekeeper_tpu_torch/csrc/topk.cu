// K2: per-constraint violation count + capped top-k, packed.
//
// Replaces the JAX package's engine/veval.py `topk_reduce` / `_eval_topk`
// and `ProgramExecutor._reduce_fn` (the chunked lax.top_k reduction),
// item B3 of the port's kernel table.
//
// For each constraint row c of the bool mask [C, R]: the violation count,
// and the k violating rows with the highest score = r_pad - rank[r]
// (rank = the scalar driver's sorted-key order, so the capped subset is
// the same one the scalar oracle emits first).  Output is the packed
// [C, 1 + 2k] int32 layout of the reference: count, k rows, k valid
// flags; invalid slots hold row 0.
//
// Design: one block per constraint row strides over R with 16-byte
// loads (16 rows per thread per step).  Each thread counts its rows and
// keeps a sorted local list of keys = score << 32 | (r_pad - 1 - r):
// larger is better, equal scores go to the lower row as in the
// reference's stable descending sort, and no two keys are equal.  The
// block then merges the threads' lists by rounds of block argmax over
// the list heads.  A pass fills at most kListMax slots; a larger cap
// takes further passes over the row, each keeping only keys below the
// last one taken, so any cap gives the reference's rows.
// Bound on the H100: bytes -- the mask is read once per pass (C*R
// bytes) and the rank of each violating row once; the merge is
// k*log(threads) steps.  With C_pad = 128 blocks the grid is about one
// block per SM, so the scan is latency-bound rather than at the
// 3.35 TB/s roofline; splitting R across blocks with a second merge
// pass is the known next step.
//
// Batched (item B9, the fleet audit's vmapped top-k, whatif/fleet.py
// `_topk_fn`): the mask is N clusters' [C_pad, R_pad] masks stacked,
// read as [N * C_pad, R_pad], and the rank is [N, R_pad]; block b reads
// rank row b / rows_per_rank (rows_per_rank = C_pad).  The unbatched call
// passes rows_per_rank = C_pad with one rank row, so one kernel serves
// both.  The score base is the (stacked) R_pad, as in the reference.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kListMax = 128;  // slots one pass fills

__device__ __forceinline__ void insert(long long* keys, int& n, int cap,
                                       long long key) {
  int pos;
  if (n < cap) {
    pos = n++;
  } else if (key > keys[cap - 1]) {
    pos = cap - 1;
  } else {
    return;
  }
  while (pos > 0 && keys[pos - 1] < key) {
    keys[pos] = keys[pos - 1];
    --pos;
  }
  keys[pos] = key;
}

__device__ __forceinline__ long long warp_max(long long v) {
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
topk_kernel(const uint8_t* __restrict__ mask, const int32_t* __restrict__ rank,
            int rows_per_rank, int r_pad, int k, int vec,
            int32_t* __restrict__ out) {
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint8_t* row = mask + static_cast<int64_t>(c) * r_pad;
  const int32_t* rk =
      rank ? rank + static_cast<int64_t>(c / rows_per_rank) * r_pad : nullptr;
  int32_t* o = out + static_cast<int64_t>(c) * (1 + 2 * k);

  __shared__ int s_count[kWarps];
  __shared__ long long s_key[kWarps];
  __shared__ long long s_win;

  long long keys[kListMax];
  long long ceiling = LLONG_MAX;  // a pass keeps only keys below this
  int count = 0;
  int done = 0;
  while (done < k) {
    const int cap = min(kListMax, k - done);
    const bool first = done == 0;
    int n = 0;
    auto visit = [&](int r) {
      if (first) ++count;
      const int s = r_pad - (rk ? __ldg(rk + r) : r);
      if (s <= 0) return;
      const long long key = (static_cast<long long>(s) << 32) |
                            static_cast<unsigned>(r_pad - 1 - r);
      if (key < ceiling) insert(keys, n, cap, key);
    };
    if (vec) {
      const uint4* row4 = reinterpret_cast<const uint4*>(row);
      const int nw = r_pad / 16;
      for (int w = tid; w < nw; w += kThreads) {
        const uint4 v = __ldg(row4 + w);
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t x = words[q];
          if (!x) continue;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if ((x >> (8 * b)) & 0xffu) visit(w * 16 + q * 4 + b);
        }
      }
    } else {
      for (int r = tid; r < r_pad; r += kThreads)
        if (row[r]) visit(r);
    }

    int head = 0;
    int j = 0;
    long long win = 0;
    for (; j < cap; ++j) {
      long long best = warp_max(head < n ? keys[head] : 0);
      if (lane == 0) s_key[warp] = best;
      __syncthreads();
      if (warp == 0) {
        best = warp_max(lane < kWarps ? s_key[lane] : 0);
        if (lane == 0) s_win = best;
      }
      __syncthreads();
      win = s_win;
      if (win <= 0) break;  // no valid candidate left
      if (head < n && keys[head] == win) {
        o[1 + done + j] = r_pad - 1 - static_cast<int>(win & 0xffffffffll);
        o[1 + k + done + j] = 1;
        ++head;
      }
    }
    if (j < cap) {
      for (int jj = done + j + tid; jj < k; jj += kThreads) {
        o[1 + jj] = 0;
        o[1 + k + jj] = 0;
      }
      break;
    }
    done += cap;
    ceiling = win;
  }

  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if (lane == 0) s_count[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_count[w];
    o[0] = total;
  }
}

}  // namespace

// n_rows mask rows of r_pad; mask row b scores by rank row
// b / rows_per_rank.  rank may be null (score by raw row order).  Returns
// cudaGetLastError().
extern "C" int gk_topk_packed(const void* mask, const void* rank, int n_rows,
                              int rows_per_rank, int r_pad, int k, void* out,
                              void* stream) {
  if (n_rows <= 0) return 0;
  if (k <= 0 || rows_per_rank <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (r_pad % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(mask) % 16 == 0);
  topk_kernel<<<n_rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(rank),
      rows_per_rank, r_pad, k, vec, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
