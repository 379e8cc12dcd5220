// K7: the inventory join -- row r violates iff some selected inventory row
// holds the value src[r] and, with exclude_same_name, a name other than
// names[r].
//
// Replaces the JAX package's engine/veval.py `_inv_join_mask`, item B7 of
// the port's kernel table: the duplicate-value join of K8sUniqueIngressHost
// that the devpages sweep evaluates over the whole table before the IR
// evaluator reads it as an r_bool column.  Inputs, all [R]: `src`, `inv`
// and `names` int32 interner ids (MISSING = -1), `sel` bool (the inventory
// side's row filter).  Output: bool [R].
//
// The reference sorts the selected inventory and runs two searchsorted
// calls and two merged lexsorts, because jax runs 32-bit (no composite
// pair key) and XLA has no integer atomics.  The card has atomics, so K7
// computes the same function per value instead of per sorted position:
// over the selected rows with inv >= 0, cnt[v] counts them and mn[v] / mx[v]
// hold their least and greatest name id (MISSING names included, as in the
// reference's pair count).  The reference returns total - own > 0, where
// own counts the inventory rows whose (value, name) equals (src[r],
// names[r]) when both are present; so row r violates iff src[r] >= 0,
// cnt[src[r]] > 0, and, with exclude_same_name, names[r] < 0 or some name
// of that value differs from names[r], i.e. mn != names[r] or mx !=
// names[r].  Integer atomics commute, so the output is exact and does not
// depend on the order the threads run in.
//
// Three launches:
//   1. fill: cnt = 0, mn = INT32_MAX, mx = INT32_MIN over n_ids entries;
//   2. accumulate: one thread per row, atomicAdd / atomicMin / atomicMax on
//      the selected rows' values;
//   3. verdict: one thread per row writes the bool.
// A value id outside [0, n_ids) (src on any row, inv on a selected row) is
// never used as an index: it sets `err` to 1 and the row reads False.  The
// caller reads `err` after its next synchronisation and raises.
//
// Bound on the H100: bytes.  The function must read 13 bytes a row (three
// int32 columns and one bool) and write one, 14 in all; the per-value
// scratch is the kernel's own, not the function's traffic.  At R 131,072
// that is about 1.8 MB, about half a microsecond at 3.35 TB/s, so the
// three launches set the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

__global__ void fill_kernel(int32_t* __restrict__ cnt,
                            int32_t* __restrict__ mn,
                            int32_t* __restrict__ mx, int n_ids) {
  const int stride = gridDim.x * blockDim.x;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < n_ids;
       v += stride) {
    cnt[v] = 0;
    mn[v] = INT32_MAX;
    mx[v] = INT32_MIN;
  }
}

__global__ void accumulate_kernel(const int32_t* __restrict__ inv,
                                  const uint8_t* __restrict__ sel,
                                  const int32_t* __restrict__ names,
                                  int32_t* __restrict__ cnt,
                                  int32_t* __restrict__ mn,
                                  int32_t* __restrict__ mx,
                                  int32_t* __restrict__ err, int n_rows,
                                  int n_ids) {
  const int stride = gridDim.x * blockDim.x;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n_rows;
       r += stride) {
    if (!sel[r]) continue;
    const int32_t v = inv[r];
    if (v < 0) continue;
    if (v >= n_ids) {
      *err = 1;
      continue;
    }
    const int32_t nm = names[r];
    atomicAdd(&cnt[v], 1);
    atomicMin(&mn[v], nm);
    atomicMax(&mx[v], nm);
  }
}

__global__ void verdict_kernel(const int32_t* __restrict__ src,
                               const int32_t* __restrict__ names,
                               const int32_t* __restrict__ cnt,
                               const int32_t* __restrict__ mn,
                               const int32_t* __restrict__ mx,
                               uint8_t* __restrict__ out,
                               int32_t* __restrict__ err, int n_rows,
                               int n_ids, int exclude_same_name) {
  const int stride = gridDim.x * blockDim.x;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n_rows;
       r += stride) {
    const int32_t s = src[r];
    uint8_t hit = 0;
    if (s >= n_ids) {
      *err = 1;
    } else if (s >= 0 && cnt[s] > 0) {
      const int32_t nm = names[r];
      hit = !exclude_same_name || nm < 0 || mn[s] != nm || mx[s] != nm;
    }
    out[r] = hit;
  }
}

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

}  // namespace

// scratch: int32 [3 * n_ids] -- cnt, mn and mx.  err: int32 [1], which the
// kernels only ever set to 1 (the caller zeroes it).  Returns the first
// launch's nonzero cudaGetLastError(), or cudaErrorInvalidValue for sizes
// the kernels do not take.
extern "C" int gk_invjoin(const void* src, const void* inv, const void* sel,
                          const void* names, void* out, void* scratch,
                          void* err, int n_rows, int n_ids,
                          int exclude_same_name, void* stream) {
  if (n_rows <= 0 || n_ids <= 0 || n_ids > 0x7fffffff / 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* cnt = static_cast<int32_t*>(scratch);
  int32_t* mn = cnt + n_ids;
  int32_t* mx = mn + n_ids;
  int32_t* e = static_cast<int32_t*>(err);
  fill_kernel<<<blocks_for(n_ids), kThreads, 0, s>>>(cnt, mn, mx, n_ids);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  accumulate_kernel<<<blocks_for(n_rows), kThreads, 0, s>>>(
      static_cast<const int32_t*>(inv), static_cast<const uint8_t*>(sel),
      static_cast<const int32_t*>(names), cnt, mn, mx, e, n_rows, n_ids);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  verdict_kernel<<<blocks_for(n_rows), kThreads, 0, s>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(names),
      cnt, mn, mx, static_cast<uint8_t*>(out), e, n_rows, n_ids,
      exclude_same_name);
  return static_cast<int>(cudaGetLastError());
}
