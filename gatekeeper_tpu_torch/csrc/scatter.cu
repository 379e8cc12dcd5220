// K4: dirty-row scatter into device columns, many columns a launch.
//
// Replaces the JAX package's engine/veval.py `ProgramExecutor._scatter_rows`
// (the jitted functional `dev.at[rows].set(vals)` of a churned sweep), item
// B4 of the port's kernel table.
//
// Each job is one column viewed as [outer, n_axis, inner]: the scatter axis
// in the middle, everything before it folded into `outer`, everything after
// it into `inner`.  vals is [outer, b, inner] and rows is [b] int32; the job
// writes out[o, rows[i], j] = vals[o, i, j] into a new column `out` that
// starts as a copy of the old one (the reference's update is functional:
// the old array stays as it was).  Rows outside [0, n_axis) are dropped, as
// XLA's scatter drops out-of-bounds updates.  Padding rows repeat the first
// row with the same values, so duplicate writes store identical bytes.
//
// Bound on the H100: bytes.  A job must read the old column and write the
// new one (the copy, which dominates at every churn size the delta path
// takes: <= 1/8 of the rows), and read the values and the rows once.  At a
// churned sweep's sizes that is well under a microsecond, below the launch
// latency, so what counts is how many launches and host calls a migration
// takes.
//
// What held the first design back: one launch, one clone and two uploads
// per column (19 launches for the 3 kinds of a north-star churned sweep),
// with the wrapper's Python in front of each; one thread per element with
// four 64-bit divisions.
//
// This design: gk_scatter_rows takes every job of a migration at once and
// launches one kernel for up to kMaxJobs jobs, multi-tensor-apply style:
// the jobs' descriptors travel by value in the kernel's parameters (nothing
// is uploaded), grid y indexes the job, and the index math is 32-bit but
// for the final offsets.  No copy call of the runtime: a cudaMemcpyAsync
// per column costs more host time than the launch.
//   - Every job with at most kScan rows (a churned sweep's migration: 1,024
//     at 1% of 100k pods) takes one fused launch.  Grid x cuts the scatter
//     axis into chunks of about kChunkBytes; a block copies its chunk from
//     the old column (for every `outer` index), waits for its own threads
//     (__syncthreads), scans `rows` into a shared list of the dirty rows in
//     its chunk and writes them.  No block writes a row another block
//     copies, so one launch is ordered enough.
//   - A batch with a longer job (a budgeted restore: some 200k rows) takes
//     two launches, the copy of every chunk and then the writes, one thread
//     a word of vals: scanning that many rows in every block would cost
//     more than the second launch.
// The copy moves the widest word (16, 8, 4, 2 or 1 bytes) that divides a
// chunk's bytes, the axis's bytes and both columns' addresses, four words
// in flight a thread; the writes the widest that divides a row segment's
// bytes and the output's and values' addresses.  A [C, R] bool mask
// scattered along R (a 1-byte segment) copies 16 bytes a word and writes
// one byte per (constraint, dirty row): there is nothing to widen.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxJobs = 64;          // jobs a launch: 3.5 KB of parameters
constexpr int kDescWords = 8;         // int64 words a job's descriptor
constexpr int kScan = 1024;           // most rows a fused launch scans
constexpr int kUnroll = 4;            // words in flight per copying thread
constexpr int64_t kChunkBytes = 32768;  // column bytes a block copies
constexpr int64_t kMaxBlocksX = 1024;   // blocks a job's writes take

enum Mode { kFused = 0, kCopy = 1, kWrite = 2 };

struct Job {
  void* out;
  const void* src;      // the old column
  const void* vals;
  const int32_t* rows;
  uint32_t outer;       // indices before the scatter axis
  uint32_t n_axis;      // rows of the scatter axis
  uint32_t b;           // rows scattered
  uint32_t seg;         // bytes of one row segment (inner * element size)
  uint32_t chunk;       // rows of the axis a copying block owns
  uint8_t copy_width;   // bytes of a copied word
  uint8_t width;        // bytes of a written word
};

struct Batch {
  Job job[kMaxJobs];
};

static_assert(sizeof(Batch) <= 4000, "kernel parameters are limited to 4 KB");

// Rows [r_lo, r_lo + r_n) of every outer index: runs of r_n * seg bytes, a
// whole number of words W (W divides chunk * seg and n_axis * seg).
template <typename W>
__device__ __forceinline__ void copy_rows(const Job& jb, uint32_t r_lo,
                                          uint32_t r_n) {
  W* __restrict__ out = static_cast<W*>(jb.out);
  const W* __restrict__ src = static_cast<const W*>(jb.src);
  const uint32_t run = r_n * jb.seg / sizeof(W);
  const size_t stride = static_cast<size_t>(jb.n_axis) * jb.seg / sizeof(W);
  const size_t first = static_cast<size_t>(r_lo) * jb.seg / sizeof(W);
  const uint32_t total = jb.outer * run;
  for (uint32_t t0 = threadIdx.x; t0 < total; t0 += kUnroll * blockDim.x) {
    W v[kUnroll];
    size_t at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t t = t0 + u * blockDim.x;
      if (t < total) {
        const uint32_t o = t / run;
        at[u] = o * stride + first + (t - o * run);
        v[u] = src[at[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u * blockDim.x < total) out[at[u]] = v[u];
    }
  }
}

// Word j of out[o, rows[i], :] = vals[o, i, :].
template <typename W>
__device__ __forceinline__ void write_word(const Job& jb, uint32_t i,
                                           uint32_t o, uint32_t j) {
  const uint32_t seg = jb.seg / sizeof(W);
  const uint32_t r = static_cast<uint32_t>(__ldg(jb.rows + i));
  static_cast<W*>(jb.out)[(static_cast<size_t>(o) * jb.n_axis + r) * seg +
                          j] =
      static_cast<const W*>(jb.vals)[(static_cast<size_t>(o) * jb.b + i) *
                                         seg + j];
}

// The hit rows' segments, every outer index: hit[k] is an index into rows.
template <typename W>
__device__ __forceinline__ void write_hits(const Job& jb,
                                           const uint32_t* hit,
                                           uint32_t n_hit) {
  const uint32_t seg = jb.seg / sizeof(W);
  const uint32_t total = n_hit * jb.outer * seg;
  for (uint32_t t = threadIdx.x; t < total; t += blockDim.x) {
    const uint32_t q = t / seg;
    const uint32_t k = q / jb.outer;
    write_word<W>(jb, hit[k], q - k * jb.outer, t - q * seg);
  }
}

// Every word of vals, grid-stride over the job's blocks; rows outside
// [0, n_axis) are dropped.
template <typename W>
__device__ __forceinline__ void write_all(const Job& jb) {
  const uint32_t seg = jb.seg / sizeof(W);
  const uint32_t total = jb.outer * jb.b * seg;
  for (uint32_t t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += gridDim.x * blockDim.x) {
    const uint32_t q = t / seg;
    const uint32_t o = q / jb.b;
    const uint32_t i = q - o * jb.b;
    if (static_cast<uint32_t>(__ldg(jb.rows + i)) < jb.n_axis) {
      write_word<W>(jb, i, o, t - q * seg);
    }
  }
}

#define GK_BY_WIDTH(width, call)          \
  switch (width) {                        \
    case 16: call(uint4); break;          \
    case 8: call(uint2); break;           \
    case 4: call(uint32_t); break;        \
    case 2: call(uint16_t); break;        \
    default: call(uint8_t); break;        \
  }

__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(const __grid_constant__ Batch batch, int mode) {
  __shared__ uint32_t hit[kScan];
  __shared__ uint32_t n_hit;
  const Job& jb = batch.job[blockIdx.y];
  if (mode == kWrite) {
#define GK_WRITE_ALL(W) write_all<W>(jb)
    GK_BY_WIDTH(jb.width, GK_WRITE_ALL)
#undef GK_WRITE_ALL
    return;
  }
  const uint32_t r_lo = blockIdx.x * jb.chunk;
  if (r_lo >= jb.n_axis) return;     // uniform: the job has fewer chunks
  const uint32_t r_n =
      jb.n_axis - r_lo < jb.chunk ? jb.n_axis - r_lo : jb.chunk;
#define GK_COPY(W) copy_rows<W>(jb, r_lo, r_n)
  GK_BY_WIDTH(jb.copy_width, GK_COPY)
#undef GK_COPY
  if (mode == kCopy) return;
  // fused: b <= kScan
  if (threadIdx.x == 0) n_hit = 0;
  __syncthreads();                   // also orders the copy before the writes
  for (uint32_t i = threadIdx.x; i < jb.b; i += blockDim.x) {
    // rows outside [0, n_axis) are in no chunk: dropped
    const uint32_t r = static_cast<uint32_t>(__ldg(jb.rows + i));
    if (r - r_lo < r_n) hit[atomicAdd(&n_hit, 1u)] = i;
  }
  __syncthreads();
  const uint32_t n = n_hit;
  if (n == 0) return;
#define GK_WRITE_HITS(W) write_hits<W>(jb, hit, n)
  GK_BY_WIDTH(jb.width, GK_WRITE_HITS)
#undef GK_WRITE_HITS
}

// The widest word that divides every size and address given.
int word_bytes(int64_t bits) {
  int v = 16;
  while (v > 1 && (bits & (v - 1))) v >>= 1;
  return v;
}

}  // namespace

// `desc` holds n_jobs descriptors of kDescWords int64 each: out, src (the
// old column), vals, rows (device addresses), outer, n_axis, b and the
// bytes of one row segment (inner * element size).  For every kMaxJobs
// jobs, one fused launch, or two (copy, then writes) where a job has more
// than kScan rows, all on `stream`.  Returns the number of launches, or
// minus the first nonzero cudaError_t (cudaErrorInvalidValue for a job
// whose values, or one chunk of whose column, hold 2^31 bytes or more).
extern "C" int gk_scatter_rows(const int64_t* desc, int n_jobs,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t lim = int64_t{1} << 31;
  int launches = 0;
  for (int k0 = 0; k0 < n_jobs; k0 += kMaxJobs) {
    const int n = n_jobs - k0 < kMaxJobs ? n_jobs - k0 : kMaxJobs;
    Batch batch;
    int64_t chunks = 1, write_blocks = 1, most_rows = 0;
    for (int k = 0; k < n; ++k) {
      const int64_t* d = desc + kDescWords * (k0 + k);
      const int64_t outer = d[4], n_axis = d[5], b = d[6], seg = d[7];
      // a chunk of whole 16-row groups of about kChunkBytes
      const int64_t row_bytes = outer * seg > 0 ? outer * seg : 1;
      int64_t chunk = kChunkBytes / row_bytes / 16 * 16;
      if (chunk < 16) chunk = 16;
      if (outer < 0 || n_axis < 0 || b < 0 || seg < 0 || n_axis >= lim ||
          outer * b * seg >= lim || row_bytes * chunk >= lim) {
        return -static_cast<int>(cudaErrorInvalidValue);
      }
      Job& jb = batch.job[k];
      jb.out = reinterpret_cast<void*>(d[0]);
      jb.src = reinterpret_cast<const void*>(d[1]);
      jb.vals = reinterpret_cast<const void*>(d[2]);
      jb.rows = reinterpret_cast<const int32_t*>(d[3]);
      jb.outer = static_cast<uint32_t>(outer);
      jb.n_axis = static_cast<uint32_t>(n_axis);
      jb.b = static_cast<uint32_t>(b);
      jb.seg = static_cast<uint32_t>(seg);
      jb.chunk = static_cast<uint32_t>(chunk);
      jb.copy_width = static_cast<uint8_t>(
          word_bytes(chunk * seg | n_axis * seg | d[0] | d[1]));
      jb.width = static_cast<uint8_t>(word_bytes(seg | d[0] | d[2]));
      const int64_t need = (n_axis + chunk - 1) / chunk;
      if (need > chunks) chunks = need;
      int64_t words = (outer * b * seg / jb.width + kThreads - 1) / kThreads;
      if (words > kMaxBlocksX) words = kMaxBlocksX;
      if (words > write_blocks) write_blocks = words;
      if (b > most_rows) most_rows = b;
    }
    const dim3 copy_grid(static_cast<unsigned>(chunks),
                         static_cast<unsigned>(n));
    if (most_rows <= kScan) {
      scatter_rows_kernel<<<copy_grid, kThreads, 0, s>>>(batch, kFused);
      launches += 1;
    } else {
      scatter_rows_kernel<<<copy_grid, kThreads, 0, s>>>(batch, kCopy);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return -static_cast<int>(err);
      scatter_rows_kernel<<<dim3(static_cast<unsigned>(write_blocks),
                                 static_cast<unsigned>(n)),
                            kThreads, 0, s>>>(batch, kWrite);
      launches += 2;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return -static_cast<int>(err);
  }
  return launches;
}
