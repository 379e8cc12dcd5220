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
// over the selected rows with inv >= 0, whether value v occurs and which
// names it occurs with (MISSING names included, as in the reference's pair
// count).  The reference returns total - own > 0, where own counts the
// inventory rows whose (value, name) equals (src[r], names[r]) when both
// are present; so row r violates iff src[r] >= 0, v = src[r] occurs, and,
// with exclude_same_name, names[r] < 0 or some name of v differs from
// names[r] (the plain version's least / greatest name: mn != names[r] or
// mx != names[r]).
//
// The per-value state is one 64-bit word a value id, in a table that
// persists across calls (kernels/invjoin.py keeps one a device, grown and
// zeroed when n_ids outgrows it): bits 63-33 the epoch of the call that
// last wrote it, bit 32 "several names", bits 31-0 the first name seen.
// A word of an older epoch reads as empty, so no call clears the table.
// In terms of the reference's count, least and greatest name: the value
// is present iff its word carries this call's epoch, and "some name of
// the value differs from names[r]" iff the several-names bit is set or
// the first name differs.  Which name comes first depends on the order
// the threads run in; the verdict does not.  Two launches:
//   1. accumulate: one thread a selected row with inv >= 0, an atomicCAS
//      loop on its value's word: an old epoch takes (epoch, 0, name); a
//      current word with another first name gains the several-names bit;
//   2. verdict: one thread a row reads src[r]'s word and writes the bool.
// A value id outside [0, n_ids) (src on any row, inv on a selected row) is
// never used as an index: it sets `err` to 1 and the row reads False.  The
// caller reads `err` after its next synchronisation and raises.  The
// epoch is an argument, so a CUDA graph replayed on the same inputs gives
// the same words and the same verdicts.
//
// Bound on the H100: bytes.  The function must read 13 bytes a row (three
// int32 columns and one bool) and write one, 14 in all; the per-value
// table is the kernel's own state, not the function's traffic.  At R
// 131,072 that is about 1.8 MB, about half a microsecond at 3.35 TB/s, so
// the two launches set the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;
constexpr unsigned long long kSeveral = 1ull << 32;
constexpr int kEpochShift = 33;

__device__ __forceinline__ unsigned long long fresh(unsigned epoch,
                                                    int32_t name) {
  return (static_cast<unsigned long long>(epoch) << kEpochShift) |
         static_cast<uint32_t>(name);
}

__global__ void accumulate_kernel(const int32_t* __restrict__ inv,
                                  const uint8_t* __restrict__ sel,
                                  const int32_t* __restrict__ names,
                                  unsigned long long* __restrict__ table,
                                  int32_t* __restrict__ err, int n_rows,
                                  int n_ids, unsigned epoch) {
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
    unsigned long long* w = table + v;
    unsigned long long cur = *w;
    while (true) {
      unsigned long long want;
      if ((cur >> kEpochShift) != epoch)
        want = fresh(epoch, nm);
      else if ((cur & kSeveral) ||
               static_cast<int32_t>(static_cast<uint32_t>(cur)) == nm)
        break;
      else
        want = cur | kSeveral;
      const unsigned long long prev = atomicCAS(w, cur, want);
      if (prev == cur) break;
      cur = prev;
    }
  }
}

__global__ void verdict_kernel(const int32_t* __restrict__ src,
                               const int32_t* __restrict__ names,
                               const unsigned long long* __restrict__ table,
                               uint8_t* __restrict__ out,
                               int32_t* __restrict__ err, int n_rows,
                               int n_ids, int exclude_same_name,
                               unsigned epoch) {
  const int stride = gridDim.x * blockDim.x;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n_rows;
       r += stride) {
    const int32_t s = src[r];
    uint8_t hit = 0;
    if (s >= n_ids) {
      *err = 1;
    } else if (s >= 0) {
      const unsigned long long w = table[s];
      if ((w >> kEpochShift) == epoch) {
        const int32_t nm = names[r];
        hit = !exclude_same_name || nm < 0 || (w & kSeveral) ||
              static_cast<int32_t>(static_cast<uint32_t>(w)) != nm;
      }
    }
    out[r] = hit;
  }
}

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

}  // namespace

// table: uint64 [table_size] per-value words (table_size >= n_ids), all of
// an epoch other than `epoch` (in [1, 2^31)).  err: int32 [1], which the
// kernels only ever set to 1 (the caller zeroes it).  Returns the first
// launch's nonzero cudaGetLastError(), or cudaErrorInvalidValue for sizes
// the kernels do not take.
extern "C" int gk_invjoin(const void* src, const void* inv, const void* sel,
                          const void* names, void* out, void* table,
                          long long table_size, void* err, int n_rows,
                          int n_ids, int exclude_same_name, unsigned epoch,
                          void* stream) {
  if (n_rows <= 0 || n_ids <= 0 || table_size < n_ids || epoch == 0 ||
      epoch >= (1u << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* words = static_cast<unsigned long long*>(table);
  int32_t* e = static_cast<int32_t*>(err);
  accumulate_kernel<<<blocks_for(n_rows), kThreads, 0, s>>>(
      static_cast<const int32_t*>(inv), static_cast<const uint8_t*>(sel),
      static_cast<const int32_t*>(names), words, e, n_rows, n_ids, epoch);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  verdict_kernel<<<blocks_for(n_rows), kThreads, 0, s>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(names),
      words, static_cast<uint8_t*>(out), e, n_rows, n_ids, exclude_same_name,
      epoch);
  return static_cast<int>(cudaGetLastError());
}
