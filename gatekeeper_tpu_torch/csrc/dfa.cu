// K3: the regex byte-DFA scan over the interner's packed strings.
//
// Replaces the JAX package's engine/veval.py `_dfa_device_table` (a
// lax.scan of gathers; ops/regex_dfa.py `match_packed_device` is its
// standalone twin), item B2 of the port's kernel table.  Batched (item
// B9, the fleet audit: the reference's `_with_dfa_tables` inside a
// jax.vmap over clusters), N clusters' byte rows, flags and [S, 256]
// tables arrive stacked; the unbatched call is the case N = 1.
//
// The reference, per id u: start in state 0, step s = trans[s, byte]
// over every byte column after the encoded string prefix (zero padding
// included), take one TERM step trans[s, 0], and let ids the byte rows
// cannot represent take the host verdict: out[u] = ok[u] ? accept[s] :
// xv[u].  Its documented `$`/`\Z` end-of-text behaviour comes from
// those padding steps and is reproduced exactly, not fixed.
//
// Bound on the H100: the ok ids' rows read once, the flags, the tables;
// but the work is a chain of dependent table lookups, one per byte, so
// what sets the time at the path's sizes is latency: the chain's, and
// that of getting the table and the rows to the SM.  The design:
//  1. An id that is not ok is not scanned: it takes xv[u] (the
//     reference's `where`).
//  2. Only the live bytes are stepped.  j* is the last column at or
//     after `prefix` that holds a nonzero byte; columns prefix..j* are
//     stepped (interior zeros like any byte), then z(s) = trans[s, 0] is
//     applied W - j* times (the zero tail plus TERM), stopping at a fixed
//     point z(s) == s, after which every further step is the identity.
//     An orbit that cycles runs all its steps.  A row of zeros costs
//     only the z steps from state 0.
//  3. The table lives in shared memory, staged by each block from the
//     table as shipped (int8, int16 or int32; 16-byte loads, a batch in
//     flight a thread, the accept flags with the first) at the narrowest
//     unsigned width that holds S - 1: uint8 to 256 states, uint16
//     above.  Moving the table into each SM is the largest cost after
//     the launch at the path's sizes (tools/k3_variants.py), so only its
//     columns 0-127 are staged, [S][128]: the interner marks a row ok
//     only when its payload is ASCII, and a row that holds a byte of 128
//     or more anyway steps through the global table instead, so the
//     result stays exact for any input.  A step is s = t[(s << 7) | byte]:
//     a shift-add and a shared-memory load on the chain.  (A transposed
//     layout, s + byte * S, measured slower on the path's tables.)  A
//     table larger than the card's shared memory for a block (uint16 past
//     904 states on an H100) is read from global memory through __ldg, by
//     the same kernel; the wrapper's plan picks the branch from S alone.
//  4. The rows come to shared memory too.  A tile's rows are contiguous:
//     the block copies them with cp.async, 16 bytes a thread on
//     neighbouring addresses (one thread a row reading its own 16-byte
//     chunks costs a cache wavefront a lane instead), all of them (waiting
//     for the ok flags first to copy only the ok rows measured slower).
//     The row stride in shared memory is an odd number of 16-byte chunks,
//     so the lanes of a warp each reading chunk c of their own row hit
//     distinct banks.  The copies, the flags and the table's loads are in
//     flight together.
//     Rows that are not a multiple of 16 bytes or not 16-byte aligned
//     are read from global memory a byte at a time instead.
//     The chunks strictly inside a row's live span are stepped without a
//     per-byte test; only the first and the last chunk carry one.
//  5. The grid: grid.y is the cluster, so a block stages one table;
//     grid.x blocks of `threads` threads (all of them stage) take tiles
//     of P <= threads ids (one a thread), looping over further tiles when
//     the plan caps the grid at the blocks the card holds at once (the
//     next tile's flags load while a tile is scanned).  The plan
//     (kernels/dfa.py `plan`) sets P, the threads and the blocks.
//
// Preconditions (as in the reference): every entry of `trans` is a
// state in [0, S).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kStageBatch = 8;    // 16-byte table loads in flight a thread
constexpr int kMaxThreads = 1024;

// Index (0-15) of the highest nonzero byte of a 16-byte chunk, -1 if
// none (selects, no branches).
__device__ __forceinline__ int top_byte(const uint4 v) {
  int t = -1;
  t = v.x ? 3 - (__clz(v.x) >> 3) : t;
  t = v.y ? 7 - (__clz(v.y) >> 3) : t;
  t = v.z ? 11 - (__clz(v.z) >> 3) : t;
  t = v.w ? 15 - (__clz(v.w) >> 3) : t;
  return t;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The table's columns 0-127 staged in shared memory, [S][128]: what a row
// of bytes below 128 reads.
template <typename TS>
struct SharedTable {
  const TS* t;
  const uint8_t* a;
  __device__ __forceinline__ int step(int s, unsigned b) const {
    return t[(s << 7) | static_cast<int>(b)];
  }
  __device__ __forceinline__ int z(int s) const { return t[s << 7]; }
  __device__ __forceinline__ uint8_t accept(int s) const { return a[s]; }
};

// The table as shipped, [S, 256], read through the read-only cache.
template <typename TG>
struct GlobalTable {
  const TG* t;
  const uint8_t* a;
  __device__ __forceinline__ int step(int s, unsigned b) const {
    return static_cast<int>(__ldg(t + (static_cast<int64_t>(s) << 8) + b));
  }
  __device__ __forceinline__ int z(int s) const {
    return static_cast<int>(__ldg(t + (static_cast<int64_t>(s) << 8)));
  }
  __device__ __forceinline__ uint8_t accept(int s) const { return __ldg(a + s); }
};

// Steps over the bytes j0 + k of a chunk with lo <= j0 + k <= hi.
template <class Table>
__device__ __forceinline__ int step_part(const Table& tab, int s, const uint4 v,
                                         int j0, int lo, int hi) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int j = j0 + k;
    if (j >= lo && j <= hi)
      s = tab.step(s, (words[k >> 2] >> (8 * (k & 3))) & 0xffu);
  }
  return s;
}

// Steps over all 16 bytes of a chunk.
template <class Table>
__device__ __forceinline__ int step_full(const Table& tab, int s, const uint4 v) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    s = tab.step(s, (words[k >> 2] >> (8 * (k & 3))) & 0xffu);
  return s;
}

// z applied n times from s, stopping at a fixed point.
template <class Table>
__device__ __forceinline__ int collapse_tail(const Table& tab, int s, int n) {
  for (; n > 0; --n) {
    const int nz = tab.z(s);
    if (nz == s) break;
    s = nz;
  }
  return s;
}

// A row's live span: j*, the last column at or after `prefix` holding a
// nonzero byte (prefix - 1 if none), and whether any byte of the row is
// 128 or more (such a row cannot step through the staged half table).
struct Span {
  int jstar;
  bool high;
};

__device__ __forceinline__ Span span_chunks(const uint4* row, int nvec,
                                            int prefix) {
  int jstar = prefix - 1;
  uint32_t high = 0;
#pragma unroll 4
  for (int w = 0; w < nvec; ++w) {
    const uint4 v = row[w];
    const int t = top_byte(v);
    if (t >= 0 && w * 16 + t >= prefix) jstar = w * 16 + t;
    high |= v.x | v.y | v.z | v.w;
  }
  return {jstar, (high & 0x80808080u) != 0};
}

__device__ __forceinline__ Span span_bytes(const uint8_t* row, int width,
                                           int prefix) {
  int jstar = prefix - 1;
  unsigned high = 0;
  for (int j = 0; j < width; ++j) {
    const unsigned b = __ldg(row + j);
    if (b && j >= prefix) jstar = j;
    high |= b;
  }
  return {jstar, (high & 0x80u) != 0};
}

// The final state of one row held in shared memory as 16-byte chunks:
// columns prefix..jstar stepped, then the tail collapsed.
template <class Table>
__device__ __forceinline__ int scan_chunks(const Table& tab, const uint4* row,
                                           int width, int prefix, int jstar) {
  int s = 0;
  if (jstar >= prefix) {
    const int w0 = prefix >> 4, w1 = jstar >> 4;
    s = step_part(tab, s, row[w0], w0 * 16, prefix, jstar);
    for (int w = w0 + 1; w < w1; ++w) s = step_full(tab, s, row[w]);
    if (w1 > w0) s = step_part(tab, s, row[w1], w1 * 16, 0, jstar);
  }
  return collapse_tail(tab, s, width - jstar);
}

// The same for a row of any width and alignment, from global memory a
// byte at a time.
template <class Table>
__device__ __forceinline__ int scan_bytes(const Table& tab, const uint8_t* row,
                                          int width, int prefix, int jstar) {
  int s = 0;
  for (int j = prefix; j <= jstar; ++j) s = tab.step(s, __ldg(row + j));
  return collapse_tail(tab, s, width - jstar);
}

// K elements of TG (entries are states, never negative) narrowed to TS
// and stored at dst, K * sizeof(TS) bytes (4, 8, 16 or 32).
template <typename TG, typename TS>
__device__ __forceinline__ void narrow_store(TS* dst, const uint4 v) {
  constexpr int K = 16 / sizeof(TG);
  constexpr int kWordIn = 4 / sizeof(TG);   // elements a word in
  constexpr int kWordOut = 4 / sizeof(TS);  // elements a word out
  constexpr int kOut = K / kWordOut;        // words out
  const uint32_t in[4] = {v.x, v.y, v.z, v.w};
  uint32_t out[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) out[o] = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    uint32_t e = in[k / kWordIn];
    if constexpr (kWordIn > 1) e = (e >> (32 / kWordIn * (k % kWordIn))) & (0xffffffffu >> (32 - 32 / kWordIn));
    out[k / kWordOut] |= kWordOut > 1 ? e << (32 / kWordOut * (k % kWordOut)) : e;
  }
  if constexpr (kOut == 1) {
    *reinterpret_cast<uint32_t*>(dst) = out[0];
  } else if constexpr (kOut == 2) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(out[0], out[1]);
  } else {
#pragma unroll
    for (int o = 0; o < kOut; o += 4)
      reinterpret_cast<uint4*>(dst)[o / 4] =
          make_uint4(out[o], out[o + 1], out[o + 2], out[o + 3]);
  }
}

// Copy columns 0-127 of one [S, 256] table of TG into shared memory as
// [S][128] of TS, kStageBatch 16-byte loads in flight a thread (16-byte
// aligned tables) or an element at a time, and the accept flags.
template <typename TG, typename TS>
__device__ __forceinline__ void stage_table(const TG* __restrict__ g,
                                            const uint8_t* __restrict__ accept,
                                            TS* t, uint8_t* acc, int states,
                                            bool aligned) {
  const int n = states * 128;
  const int ai = threadIdx.x < states ? __ldg(accept + threadIdx.x) : 0;
  if (!aligned) {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      t[i] = static_cast<TS>(__ldg(g + ((i >> 7) << 8) + (i & 127)));
  } else {
    constexpr int K = 16 / sizeof(TG);      // elements a 16-byte load
    constexpr int kRow = 128 / K;           // loads a half row
    const uint4* g4 = reinterpret_cast<const uint4*>(g);
    const int n4 = n / K;
    for (int i0 = threadIdx.x; i0 < n4; i0 += kStageBatch * blockDim.x) {
      uint4 v[kStageBatch];
#pragma unroll
      for (int q = 0; q < kStageBatch; ++q) {
        const int i = i0 + q * blockDim.x;
        if (i < n4) v[q] = __ldg(g4 + i + (i / kRow) * kRow);
      }
#pragma unroll
      for (int q = 0; q < kStageBatch; ++q) {
        const int i = i0 + q * blockDim.x;
        if (i >= n4) break;
        narrow_store<TG, TS>(t + i * K, v[q]);
      }
    }
  }
  if (threadIdx.x < states) acc[threadIdx.x] = static_cast<uint8_t>(ai);
  for (int i = threadIdx.x + blockDim.x; i < states; i += blockDim.x)
    acc[i] = __ldg(accept + i);
}

struct Args {
  const uint8_t* bytes;
  int64_t n_ids;        // ids a table
  int width;
  int prefix;
  const void* trans;
  int states;
  const uint8_t* accept;
  const uint8_t* ok;
  const uint8_t* xv;
  uint8_t* out;
  int ids_per_block;    // P, a tile
  int row_chunks;       // row stride in shared memory (16-byte chunks), 0:
                        // rows read from global memory a byte at a time
  int trans_aligned;    // every table 16-byte aligned
};

// Issue the cp.async copies of the rows of tile `tile` into `rows`,
// 16 bytes a thread on neighbouring addresses.
__device__ __forceinline__ void copy_rows(const Args& a, uint4* rows,
                                          int64_t tile) {
  const int nvec = a.width >> 4;
  const int64_t first = tile * a.ids_per_block;
  const int64_t left = a.n_ids - first;
  const int n_rows = left < a.ids_per_block ? static_cast<int>(left)
                                            : a.ids_per_block;
  const uint4* src = reinterpret_cast<const uint4*>(a.bytes + first * a.width);
  for (int k = threadIdx.x; k < n_rows * nvec; k += blockDim.x) {
    const int r = k / nvec;
    cp_async16(rows + r * a.row_chunks + (k - r * nvec), src + k);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// This thread's id of tile `tile`: xv when not ok, else the scan, through
// `tab`, or through the global table `gtab` when the row holds a byte of
// 128 or more and `tab` is the staged half.
template <class Table, class GTable>
__device__ __forceinline__ void finish_tile(const Args& a, const Table& tab,
                                            const GTable& gtab,
                                            const uint4* rows, int64_t tile,
                                            bool okv) {
  if (threadIdx.x >= a.ids_per_block) return;
  const int64_t u = tile * a.ids_per_block + threadIdx.x;
  if (u >= a.n_ids) return;
  if (!okv) {
    a.out[u] = a.xv[u];
    return;
  }
  constexpr bool kHalf = !std::is_same<Table, GTable>::value;
  int s;
  if (a.row_chunks) {
    const uint4* row = rows + threadIdx.x * a.row_chunks;
    const Span sp = span_chunks(row, a.width >> 4, a.prefix);
    s = kHalf && sp.high ? scan_chunks(gtab, row, a.width, a.prefix, sp.jstar)
                         : scan_chunks(tab, row, a.width, a.prefix, sp.jstar);
  } else {
    const uint8_t* row = a.bytes + u * a.width;
    const Span sp = span_bytes(row, a.width, a.prefix);
    s = kHalf && sp.high ? scan_bytes(gtab, row, a.width, a.prefix, sp.jstar)
                         : scan_bytes(tab, row, a.width, a.prefix, sp.jstar);
  }
  a.out[u] = tab.accept(s);
}

__device__ __forceinline__ bool ok_of(const Args& a, int64_t tile) {
  const int64_t u = tile * a.ids_per_block + threadIdx.x;
  return threadIdx.x < a.ids_per_block && u < a.n_ids && a.ok[u];
}

// TS: the stored width in shared memory (uint8_t, uint16_t), or void for
// the branch that reads the global table.
template <typename TG, typename TS>
__global__ void __launch_bounds__(kMaxThreads)
dfa_scan_kernel(Args a) {
  const int64_t table = blockIdx.y;
  a.bytes += table * a.n_ids * a.width;
  a.ok += table * a.n_ids;
  a.xv += table * a.n_ids;
  a.out += table * a.n_ids;
  const TG* g = static_cast<const TG*>(a.trans) + table * a.states * 256;
  a.accept += table * a.states;
  const int64_t n_tiles = (a.n_ids + a.ids_per_block - 1) / a.ids_per_block;
  int64_t tile = blockIdx.x;
  if (tile >= n_tiles) return;

  extern __shared__ uint4 smem[];
  uint4* rows = smem;
  // the tile's rows, its flags and the table are in flight together
  if (a.row_chunks) copy_rows(a, rows, tile);
  bool okv = ok_of(a, tile);
  const GlobalTable<TG> gtab{g, a.accept};
  const auto run = [&](const auto& tab) {
    for (;;) {
      cp_async_wait_all();
      __syncthreads();
      const int64_t next = tile + gridDim.x;
      const bool ok_next = next < n_tiles && ok_of(a, next);
      finish_tile(a, tab, gtab, rows, tile, okv);
      if (next >= n_tiles) break;
      __syncthreads();           // every row of this tile read
      tile = next;
      okv = ok_next;
      if (a.row_chunks) copy_rows(a, rows, tile);
    }
  };
  if constexpr (!std::is_void<TS>::value) {
    TS* t = reinterpret_cast<TS*>(rows + a.ids_per_block * a.row_chunks);
    uint8_t* acc = reinterpret_cast<uint8_t*>(t + 128 * a.states);
    stage_table<TG, TS>(g, a.accept, t, acc, a.states, a.trans_aligned);
    run(SharedTable<TS>{t, acc});
  } else {
    run(gtab);
  }
}

int set_max_smem(const void* kernel, int smem, int* done) {
  // cudaFuncSetAttribute once per kernel and device, before the first
  // launch that needs more than the default 48 KB (not inside a capture)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (done[dev] >= smem) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  done[dev] = smem;
  return 0;
}

template <typename TG, typename TS>
int launch(const Args& a, int n_batch, int threads, int blocks_x, int smem,
           cudaStream_t stream) {
  static int done[64];
  auto kernel = dfa_scan_kernel<TG, TS>;
  if (smem > 48 * 1024) {
    const int err = set_max_smem(reinterpret_cast<const void*>(kernel), smem, done);
    if (err) return err;
  }
  kernel<<<dim3(static_cast<unsigned>(blocks_x), static_cast<unsigned>(n_batch)),
           threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TG>
int launch_for(const Args& a, int n_batch, int stored_width, int threads,
               int blocks_x, cudaStream_t stream) {
  const int rows = 16 * a.ids_per_block * a.row_chunks;
  const int table = stored_width == 0
      ? 0 : ((128 * a.states * stored_width + a.states + 15) / 16) * 16;
  switch (stored_width) {
    case 0: return launch<TG, void>(a, n_batch, threads, blocks_x, rows, stream);
    case 1: return launch<TG, uint8_t>(a, n_batch, threads, blocks_x, rows + table, stream);
    case 2: return launch<TG, uint16_t>(a, n_batch, threads, blocks_x, rows + table, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The call's shapes and geometry, as the wrapper's int64 array: n_batch
// tables of `states` states; bytes/ok/xv/out hold n_batch * n_ids ids,
// cluster-major, rows of `width` bytes after a `prefix`; the table
// shipped at trans_itemsize bytes an entry (int8, int16 or int32); then
// the wrapper's plan: the width it is staged at in shared memory (1 or
// 2 bytes, 0 to read it from global memory), threads a block, ids a
// block (a tile), blocks a table, and the row stride in shared memory in
// 16-byte chunks (0: rows read from global memory; also when the rows
// are not 16-byte aligned or width % 16 != 0).
enum { kBatch, kIds, kWidth, kPrefix, kStates, kItemsize, kStored, kThreads,
       kIdsPerBlock, kBlocks, kRowChunks };

extern "C" int gk_dfa_scan(const int64_t* geometry, const void* bytes,
                           const void* trans, const void* accept,
                           const void* ok, const void* xv, void* out,
                           void* stream) {
  const int64_t n_batch = geometry[kBatch], n_ids = geometry[kIds];
  const int width = static_cast<int>(geometry[kWidth]);
  const int states = static_cast<int>(geometry[kStates]);
  const int stored_width = static_cast<int>(geometry[kStored]);
  const int threads = static_cast<int>(geometry[kThreads]);
  const int ids_per_block = static_cast<int>(geometry[kIdsPerBlock]);
  const int blocks_x = static_cast<int>(geometry[kBlocks]);
  const int row_chunks = static_cast<int>(geometry[kRowChunks]);
  if (n_batch <= 0 || n_ids <= 0) return 0;
  if (states <= 0 || n_batch > 65535 || threads < 32 || threads > kMaxThreads ||
      threads % 32 || ids_per_block < 32 || ids_per_block % 32 ||
      ids_per_block > threads || blocks_x <= 0 || row_chunks < 0 ||
      (stored_width == 1 && states > 256) || (stored_width == 2 && states > 65536))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.bytes = static_cast<const uint8_t*>(bytes);
  a.n_ids = n_ids;
  a.width = width;
  a.prefix = static_cast<int>(geometry[kPrefix]);
  a.trans = trans;
  a.states = states;
  a.accept = static_cast<const uint8_t*>(accept);
  a.ok = static_cast<const uint8_t*>(ok);
  a.xv = static_cast<const uint8_t*>(xv);
  a.out = static_cast<uint8_t*>(out);
  a.ids_per_block = ids_per_block;
  const bool vec = width > 0 && width % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(bytes) % 16 == 0;
  a.row_chunks = vec && row_chunks >= width / 16 ? row_chunks : 0;
  a.trans_aligned = reinterpret_cast<uintptr_t>(trans) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (geometry[kItemsize]) {
    case 4: return launch_for<int32_t>(a, n_batch, stored_width, threads, blocks_x, s);
    case 2: return launch_for<int16_t>(a, n_batch, stored_width, threads, blocks_x, s);
    case 1: return launch_for<int8_t>(a, n_batch, stored_width, threads, blocks_x, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
