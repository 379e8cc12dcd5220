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
// row, so a gather reads that bit twice and a scatter writes the same bit
// twice.
//
//   gk_page_gather (store): slot_buf[c, s * P + j] = mask[c, row(slot s, j)]
//     for every slot, an empty slot gathering row 0 (as the reference's
//     index table does); and, in the same launch, staging[c, i * P + j] =
//     mask[c, row(cold_pages[i], j)] for the n_cold cold pages, one
//     contiguous buffer the wrapper copies to the host once.
//   gk_page_scatter (expand): out[c, row(slot s, j)] = slot_buf[c, s * P + j]
//     for every slot that holds a page; `out` arrives zeroed.
//
// A negative or oversized page entry cannot read or write out of bounds:
// a negative one reads row 0 (gather) or is skipped (scatter), every row
// is clamped to R - 1.
//
// One thread per byte of the slot buffer (and of the staging buffer), in
// their order: consecutive threads take consecutive rows of one page, so
// reads and writes are coalesced along a page.
//
// Bound on the H100: bytes.  The gather must read the mask (C R bytes)
// and the page tables, and write C (n_slots + n_cold) P bytes, about C R;
// the scatter must read the slot buffer and write the whole [C, R] mask
// (the zeros included).  Byte-wide accesses leave this kernel well above
// that bound; 16-byte vectors along a page would close most of the gap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

__device__ __forceinline__ int64_t page_row(int32_t page, int64_t j,
                                            int64_t page_rows,
                                            int64_t n_rows) {
  if (page < 0) return 0;
  const int64_t r = static_cast<int64_t>(page) * page_rows + j;
  return r < n_rows ? r : n_rows - 1;
}

__global__ void page_gather_kernel(const uint8_t* __restrict__ mask,
                                   const int32_t* __restrict__ slot_pages,
                                   const int32_t* __restrict__ cold_pages,
                                   uint8_t* __restrict__ slot_buf,
                                   uint8_t* __restrict__ staging,
                                   int64_t c_rows, int64_t n_rows,
                                   int64_t page_rows, int64_t n_slots,
                                   int64_t n_cold) {
  const int64_t slot_w = n_slots * page_rows;
  const int64_t cold_w = n_cold * page_rows;
  const int64_t width = slot_w + cold_w;
  const int64_t total = c_rows * width;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < total; t += stride) {
    const int64_t c = t / width;
    const int64_t q = t - c * width;
    if (q < slot_w) {
      const int64_t s = q / page_rows;
      const int64_t j = q - s * page_rows;
      const int64_t r = page_row(slot_pages[s], j, page_rows, n_rows);
      slot_buf[c * slot_w + q] = mask[c * n_rows + r];
    } else {
      const int64_t qc = q - slot_w;
      const int64_t i = qc / page_rows;
      const int64_t j = qc - i * page_rows;
      const int64_t r = page_row(cold_pages[i], j, page_rows, n_rows);
      staging[c * cold_w + qc] = mask[c * n_rows + r];
    }
  }
}

__global__ void page_scatter_kernel(const uint8_t* __restrict__ slot_buf,
                                    const int32_t* __restrict__ slot_pages,
                                    uint8_t* __restrict__ out,
                                    int64_t c_rows, int64_t n_rows,
                                    int64_t page_rows, int64_t n_slots) {
  const int64_t slot_w = n_slots * page_rows;
  const int64_t total = c_rows * slot_w;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < total; t += stride) {
    const int64_t c = t / slot_w;
    const int64_t q = t - c * slot_w;
    const int64_t s = q / page_rows;
    const int32_t page = slot_pages[s];
    if (page < 0) continue;
    const int64_t r = page_row(page, q - s * page_rows, page_rows, n_rows);
    out[c * n_rows + r] = slot_buf[t];
  }
}

unsigned blocks_for(int64_t total) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 when there is
// nothing to write).
extern "C" int gk_page_gather(const void* mask, const void* slot_pages,
                              const void* cold_pages, void* slot_buf,
                              void* staging, int64_t c_rows, int64_t n_rows,
                              int64_t page_rows, int64_t n_slots,
                              int64_t n_cold, void* stream) {
  const int64_t total = c_rows * (n_slots + n_cold) * page_rows;
  if (total <= 0 || n_rows <= 0) return 0;
  page_gather_kernel<<<blocks_for(total), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(slot_pages),
      static_cast<const int32_t*>(cold_pages),
      static_cast<uint8_t*>(slot_buf), static_cast<uint8_t*>(staging),
      c_rows, n_rows, page_rows, n_slots, n_cold);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gk_page_scatter(const void* slot_buf, const void* slot_pages,
                               void* out, int64_t c_rows, int64_t n_rows,
                               int64_t page_rows, int64_t n_slots,
                               void* stream) {
  const int64_t total = c_rows * n_slots * page_rows;
  if (total <= 0 || n_rows <= 0) return 0;
  page_scatter_kernel<<<blocks_for(total), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(slot_buf),
      static_cast<const int32_t*>(slot_pages), static_cast<uint8_t*>(out),
      c_rows, n_rows, page_rows, n_slots);
  return static_cast<int>(cudaGetLastError());
}
