// K8: the devpages residency planner's page gather and page scatter.
//
// Replaces the JAX package's enforce/devpages.py `ResidencyPlanner.store`
// (its `jnp.take` of the hot pages' rows and of the cold pages' rows) and
// `ResidencyPlanner.expand` (its `zeros(...).at[:, rows].set(take(dev_buf,
// idx))`), item B8 of the port's kernel table.
//
// Under a devpages budget a kind's [C, R] bool verdict mask does not stay
// on the device between sweeps: n_slots page-sized slots of it do (the
// slot buffer, [C, n_slots * P] with P rows a page), the other pages go to
// a host mirror.  Both entry points take the slot -> page table
// `slot_pages` (int32 [n_slots], -1 = an empty slot).  Page p's row j is
// row min(p * P + j, R - 1): the ragged tail page repeats the last real
// row, so a gather reads that bit more than once.
//
//   gk_page_gather (store): slot_buf[c, s * P + j] = mask[c, row(slot s, j)]
//     for every slot, an empty slot gathering row 0 (as the reference's
//     index table does); and, in the same launch, staging[c, i * P + j] =
//     mask[c, row(cold_pages[i], j)] for the n_cold cold pages, one
//     contiguous buffer the wrapper copies to the host once.
//   gk_page_scatter (expand): the whole [C, R] mask, written once: row r of
//     a page p that slot s holds is slot_buf[c, s * P + (r - p * P)], every
//     other row is 0.  On the tail page that takes each real row's own
//     gathered bit; the repeats of row R - 1 past it are not written.
//
// A negative or oversized page entry cannot read or write out of bounds: a
// gather reads row 0 for a negative entry and row R - 1 past the end; a
// scatter ignores both (no page of the mask is held by them).  A page held
// by two slots (the planner never does that) takes either slot's bits.
//
// Bound on the H100: bytes.  The gather must read the mask (C R bytes) and
// the page tables, and write C (n_slots + n_cold) P bytes, about C R; the
// scatter must read the slot buffer and the table and write the whole
// [C, R] mask, zeros included.  At the devpages budget cell ([4, 131072],
// 1,024 slots of 32 rows) that is about 0.3 us, below a launch's latency.
//
// What held the first design back: one thread per byte with 64-bit
// divisions, and a scatter that needed the wrapper's torch.zeros of the
// whole mask before it (two launches, every held byte written twice).
//
// This design: each thread moves one word of V bytes along a page, V the
// widest of 16, 8, 4, 2, 1 that divides P, R and every buffer's address (16
// at the cell: P 32, R 131,072), with 32-bit index math inside a row and
// grid y over the constraint rows.  Since V divides P and R, a word never
// straddles a page or the end of the mask: a word of an empty slot or past
// the last row is one byte broadcast, every other word one aligned load.
// The scatter's blocks each own a range of pages: a block first builds the
// page -> slot map of its range in shared memory from `slot_pages` (the
// table is 4 bytes a slot and stays in L2), then writes every word of its
// range, a held page's from the slot buffer and the rest as zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksX = 1024;
constexpr int64_t kMaxBlocksY = 65535;
constexpr int64_t kScatterRows = 4096;   // rows a scatter block owns
constexpr int64_t kScatterRowsY = 16;    // grid y of the scatter

template <typename W>
__device__ __forceinline__ W splat(uint8_t b);
template <>
__device__ __forceinline__ uint8_t splat<uint8_t>(uint8_t b) {
  return b;
}
template <>
__device__ __forceinline__ uint16_t splat<uint16_t>(uint8_t b) {
  return static_cast<uint16_t>(b * 0x0101u);
}
template <>
__device__ __forceinline__ uint32_t splat<uint32_t>(uint8_t b) {
  return b * 0x01010101u;
}
template <>
__device__ __forceinline__ uint2 splat<uint2>(uint8_t b) {
  const uint32_t x = b * 0x01010101u;
  return make_uint2(x, x);
}
template <>
__device__ __forceinline__ uint4 splat<uint4>(uint8_t b) {
  const uint32_t x = b * 0x01010101u;
  return make_uint4(x, x, x, x);
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
    page_gather_kernel(const uint8_t* __restrict__ mask,
                       const int32_t* __restrict__ slot_pages,
                       const int32_t* __restrict__ cold_pages,
                       uint8_t* __restrict__ slot_buf,
                       uint8_t* __restrict__ staging, uint32_t c_rows,
                       uint32_t n_rows, uint32_t page_rows, uint32_t n_slots,
                       uint32_t n_cold) {
  constexpr uint32_t V = sizeof(W);
  const uint32_t page_w = page_rows / V;        // words a page
  const uint32_t slot_w = n_slots * page_w;     // words a slot-buffer row
  const uint32_t width = slot_w + n_cold * page_w;
  const uint32_t n_pages = (n_rows + page_rows - 1) / page_rows;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t c = blockIdx.y; c < c_rows; c += gridDim.y) {
    const uint8_t* src = mask + static_cast<size_t>(c) * n_rows;
    W* hot = reinterpret_cast<W*>(slot_buf) + static_cast<size_t>(c) * slot_w;
    W* cold = reinterpret_cast<W*>(staging) +
              static_cast<size_t>(c) * (width - slot_w);
    for (uint32_t q = blockIdx.x * blockDim.x + threadIdx.x; q < width;
         q += stride) {
      const bool in_slot = q < slot_w;
      const uint32_t k = in_slot ? q : q - slot_w;
      const uint32_t i = k / page_w;
      const int32_t page = in_slot ? __ldg(slot_pages + i)
                                   : __ldg(cold_pages + i);
      const uint32_t r = static_cast<uint32_t>(page) * page_rows +
                         (k - i * page_w) * V;
      W v;
      if (page < 0) {
        v = splat<W>(src[0]);
      } else if (static_cast<uint32_t>(page) >= n_pages || r >= n_rows) {
        v = splat<W>(src[n_rows - 1]);
      } else {
        v = *reinterpret_cast<const W*>(src + r);
      }
      (in_slot ? hot : cold)[k] = v;
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
    page_scatter_kernel(const uint8_t* __restrict__ slot_buf,
                        const int32_t* __restrict__ slot_pages,
                        uint8_t* __restrict__ out, uint32_t c_rows,
                        uint32_t n_rows, uint32_t page_rows, uint32_t n_slots,
                        uint32_t block_pages) {
  extern __shared__ int32_t slot_of[];          // [block_pages]
  constexpr uint32_t V = sizeof(W);
  const uint32_t n_pages = (n_rows + page_rows - 1) / page_rows;
  const uint32_t p_lo = blockIdx.x * block_pages;
  const uint32_t p_n =
      n_pages - p_lo < block_pages ? n_pages - p_lo : block_pages;
  for (uint32_t i = threadIdx.x; i < p_n; i += blockDim.x) slot_of[i] = -1;
  __syncthreads();
  for (uint32_t s = threadIdx.x; s < n_slots; s += blockDim.x) {
    const int32_t p = __ldg(slot_pages + s);
    if (p >= 0 && static_cast<uint32_t>(p) - p_lo < p_n) {
      slot_of[static_cast<uint32_t>(p) - p_lo] = static_cast<int32_t>(s);
    }
  }
  __syncthreads();
  const uint32_t r_lo = p_lo * page_rows;
  const uint32_t r_hi =
      n_rows - r_lo < p_n * page_rows ? n_rows : r_lo + p_n * page_rows;
  const uint32_t words = (r_hi - r_lo) / V;
  const size_t slot_row = static_cast<size_t>(n_slots) * page_rows;
  for (uint32_t c = blockIdx.y; c < c_rows; c += gridDim.y) {
    const uint8_t* src = slot_buf + static_cast<size_t>(c) * slot_row;
    W* dst =
        reinterpret_cast<W*>(out + static_cast<size_t>(c) * n_rows + r_lo);
    for (uint32_t k = threadIdx.x; k < words; k += blockDim.x) {
      const uint32_t r = r_lo + k * V;
      const uint32_t p = r / page_rows;
      const int32_t s = slot_of[p - p_lo];
      dst[k] = s < 0 ? splat<W>(0)
                     : *reinterpret_cast<const W*>(
                           src + static_cast<size_t>(s) * page_rows +
                           (r - p * page_rows));
    }
  }
}

// The widest word that divides every size and address given.
int word_bytes(int64_t bits) {
  int v = 16;
  while (v > 1 && (bits & (v - 1))) v >>= 1;
  return v;
}

unsigned clamp_blocks(int64_t n, int64_t most) {
  if (n < 1) n = 1;
  return static_cast<unsigned>(n < most ? n : most);
}

template <typename W>
cudaError_t gather(const void* mask, const void* slot_pages,
                   const void* cold_pages, void* slot_buf, void* staging,
                   int64_t c_rows, int64_t n_rows, int64_t page_rows,
                   int64_t n_slots, int64_t n_cold, cudaStream_t s) {
  const int64_t words = (n_slots + n_cold) * page_rows / sizeof(W);
  const dim3 grid(clamp_blocks((words + kThreads - 1) / kThreads, kMaxBlocksX),
                  clamp_blocks(c_rows, kMaxBlocksY));
  page_gather_kernel<W><<<grid, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(slot_pages),
      static_cast<const int32_t*>(cold_pages),
      static_cast<uint8_t*>(slot_buf), static_cast<uint8_t*>(staging),
      static_cast<uint32_t>(c_rows), static_cast<uint32_t>(n_rows),
      static_cast<uint32_t>(page_rows), static_cast<uint32_t>(n_slots),
      static_cast<uint32_t>(n_cold));
  return cudaGetLastError();
}

template <typename W>
cudaError_t scatter(const void* slot_buf, const void* slot_pages, void* out,
                    int64_t c_rows, int64_t n_rows, int64_t page_rows,
                    int64_t n_slots, cudaStream_t s) {
  const int64_t n_pages = (n_rows + page_rows - 1) / page_rows;
  int64_t block_pages = kScatterRows / page_rows;
  if (block_pages < 1) block_pages = 1;
  const dim3 grid(
      static_cast<unsigned>((n_pages + block_pages - 1) / block_pages),
      clamp_blocks(c_rows, kScatterRowsY));
  page_scatter_kernel<W><<<grid, kThreads, block_pages * sizeof(int32_t),
                           s>>>(
      static_cast<const uint8_t*>(slot_buf),
      static_cast<const int32_t*>(slot_pages), static_cast<uint8_t*>(out),
      static_cast<uint32_t>(c_rows), static_cast<uint32_t>(n_rows),
      static_cast<uint32_t>(page_rows), static_cast<uint32_t>(n_slots),
      static_cast<uint32_t>(block_pages));
  return cudaGetLastError();
}

bool fits_32_bits(int64_t c_rows, int64_t n_rows, int64_t page_rows,
                  int64_t n_pages_given) {
  const int64_t lim = int64_t{1} << 31;
  return c_rows < lim && n_rows + page_rows < lim &&
         n_pages_given * page_rows < lim;
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 when there is nothing
// to write; cudaErrorInvalidValue for a row of 2^31 bytes or more).
extern "C" int gk_page_gather(const void* mask, const void* slot_pages,
                              const void* cold_pages, void* slot_buf,
                              void* staging, int64_t c_rows, int64_t n_rows,
                              int64_t page_rows, int64_t n_slots,
                              int64_t n_cold, void* stream) {
  if (c_rows <= 0 || n_rows <= 0 || page_rows <= 0 || n_slots + n_cold <= 0) {
    return 0;
  }
  if (!fits_32_bits(c_rows, n_rows, page_rows, n_slots + n_cold)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t bits = page_rows | n_rows |
                       reinterpret_cast<intptr_t>(mask) |
                       reinterpret_cast<intptr_t>(slot_buf) |
                       reinterpret_cast<intptr_t>(staging);
  switch (word_bytes(bits)) {
    case 16:
      return static_cast<int>(gather<uint4>(mask, slot_pages, cold_pages,
                                            slot_buf, staging, c_rows, n_rows,
                                            page_rows, n_slots, n_cold, s));
    case 8:
      return static_cast<int>(gather<uint2>(mask, slot_pages, cold_pages,
                                            slot_buf, staging, c_rows, n_rows,
                                            page_rows, n_slots, n_cold, s));
    case 4:
      return static_cast<int>(gather<uint32_t>(
          mask, slot_pages, cold_pages, slot_buf, staging, c_rows, n_rows,
          page_rows, n_slots, n_cold, s));
    case 2:
      return static_cast<int>(gather<uint16_t>(
          mask, slot_pages, cold_pages, slot_buf, staging, c_rows, n_rows,
          page_rows, n_slots, n_cold, s));
    default:
      return static_cast<int>(gather<uint8_t>(
          mask, slot_pages, cold_pages, slot_buf, staging, c_rows, n_rows,
          page_rows, n_slots, n_cold, s));
  }
}

extern "C" int gk_page_scatter(const void* slot_buf, const void* slot_pages,
                               void* out, int64_t c_rows, int64_t n_rows,
                               int64_t page_rows, int64_t n_slots,
                               void* stream) {
  if (c_rows <= 0 || n_rows <= 0 || page_rows <= 0) return 0;
  if (!fits_32_bits(c_rows, n_rows, page_rows, n_slots)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t bits = page_rows | n_rows |
                       reinterpret_cast<intptr_t>(slot_buf) |
                       reinterpret_cast<intptr_t>(out);
  switch (word_bytes(bits)) {
    case 16:
      return static_cast<int>(scatter<uint4>(slot_buf, slot_pages, out,
                                             c_rows, n_rows, page_rows,
                                             n_slots, s));
    case 8:
      return static_cast<int>(scatter<uint2>(slot_buf, slot_pages, out,
                                             c_rows, n_rows, page_rows,
                                             n_slots, s));
    case 4:
      return static_cast<int>(scatter<uint32_t>(slot_buf, slot_pages, out,
                                                c_rows, n_rows, page_rows,
                                                n_slots, s));
    case 2:
      return static_cast<int>(scatter<uint16_t>(slot_buf, slot_pages, out,
                                                c_rows, n_rows, page_rows,
                                                n_slots, s));
    default:
      return static_cast<int>(scatter<uint8_t>(slot_buf, slot_pages, out,
                                               c_rows, n_rows, page_rows,
                                               n_slots, s));
  }
}
