// K4: dirty-row scatter into a device column.
//
// Replaces the JAX package's engine/veval.py `ProgramExecutor._scatter_rows`
// (the jitted `dev.at[rows].set(vals)` of a churned sweep), item B4 of the
// port's kernel table.
//
// The column is viewed as [outer, n_axis, inner]: the scatter axis in the
// middle, everything before it folded into `outer`, everything after it
// into `inner`.  vals is [outer, b, inner] and rows is [b] int32; the
// kernel writes out[o, rows[i], j] = vals[o, i, j].  The wrapper has
// already copied the old column into `out` (the reference's update is
// functional: the old array stays as it was), so this kernel writes only
// the dirty rows.  Rows outside [0, n_axis) are dropped, as XLA's scatter
// drops out-of-bounds updates.  Padding rows repeat the first row with the
// same values, so duplicate writes store identical bytes.
//
// One thread per element of vals, in vals' order: reads are coalesced,
// writes land at the dirty rows (a [C, R] mask scattered along R writes
// one byte per (constraint, row)).  The kernel copies elements as 1-, 2-,
// 4- or 8-byte words, so it takes every dtype of those sizes (bool,
// uint8, int8, int16, int32, float32 ...).
//
// Bound on the H100: bytes.  The scatter moves |vals| + 4b bytes in and
// |vals| out; the copy in front of it moves the whole column twice and
// dominates at every churn size the delta path takes (<= 1/8 of the rows).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void scatter_rows_kernel(T* __restrict__ out,
                                    const T* __restrict__ vals,
                                    const int32_t* __restrict__ rows,
                                    int64_t outer, int64_t n_axis, int64_t b,
                                    int64_t inner) {
  const int64_t total = outer * b * inner;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < total; t += stride) {
    const int64_t j = t % inner;
    const int64_t q = t / inner;
    const int64_t i = q % b;
    const int64_t o = q / b;
    const int64_t r = rows[i];
    if (r < 0 || r >= n_axis) continue;
    out[(o * n_axis + r) * inner + j] = vals[t];
  }
}

template <typename T>
cudaError_t launch(void* out, const void* vals, const int32_t* rows,
                   int64_t outer, int64_t n_axis, int64_t b, int64_t inner,
                   cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t total = outer * b * inner;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  scatter_rows_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(static_cast<T*>(out),
                                     static_cast<const T*>(vals), rows, outer,
                                     n_axis, b, inner);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// element size other than 1, 2, 4 or 8).
extern "C" int gk_scatter_rows(void* out, const void* vals, const void* rows,
                               int64_t outer, int64_t n_axis, int64_t b,
                               int64_t inner, int elem_size, void* stream) {
  if (outer <= 0 || b <= 0 || inner <= 0) return 0;
  const int32_t* r = static_cast<const int32_t*>(rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 1:
      return static_cast<int>(
          launch<uint8_t>(out, vals, r, outer, n_axis, b, inner, s));
    case 2:
      return static_cast<int>(
          launch<uint16_t>(out, vals, r, outer, n_axis, b, inner, s));
    case 4:
      return static_cast<int>(
          launch<uint32_t>(out, vals, r, outer, n_axis, b, inner, s));
    case 8:
      return static_cast<int>(
          launch<uint64_t>(out, vals, r, outer, n_axis, b, inner, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
