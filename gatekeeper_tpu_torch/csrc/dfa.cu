// K3: the regex byte-DFA scan over the interner's packed strings.
//
// Replaces the JAX package's engine/veval.py `_dfa_device_table` (a
// lax.scan of gathers; ops/regex_dfa.py `match_packed_device` is its
// standalone twin), item B2 of the port's kernel table.
//
// One thread per interned id u: start in state 0, step
// state = trans[state, byte] over every byte column after the encoded
// string prefix (padding included, exactly like the reference scan),
// take one TERM step trans[state, 0], read accept[state], and let ids
// the byte rows cannot represent take the host verdict:
// out[u] = ok[u] ? accept[...] : xv[u].  The documented `$`/`\Z`
// end-of-text deviation of the reference is reproduced, not fixed.
//
// Bound on the H100: bytes.  Each id reads its W-byte row once (U*W
// bytes) plus 4 bytes of flags; the [S, 256] table (at most 1 MiB as
// int32) is read through L2, where it stays resident.  The design reads
// each row with 16-byte vector loads so one thread issues W/16 loads
// instead of W; the dependent chain of table lookups (one per byte) is
// latency-bound per thread, which many ids in flight hide.
//
// Batched (item B9, the fleet audit: the reference's `_with_dfa_tables`
// inside a jax.vmap over clusters): N clusters' byte rows, flags and
// [S, 256] tables arrive stacked, and one launch covers N * T ids.  Id u
// belongs to cluster u / T and reads that cluster's `trans` and `accept`
// (S states each).  The unbatched entry point is the case N = 1.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
__device__ __forceinline__ int step(const T* __restrict__ trans, int state,
                                    unsigned byte) {
  return static_cast<int>(__ldg(trans + (static_cast<int64_t>(state) << 8) + byte));
}

template <typename T>
__global__ void dfa_scan_kernel(const uint8_t* __restrict__ bytes,
                                int64_t n_ids, int width, int prefix,
                                const T* __restrict__ trans_all,
                                const uint8_t* __restrict__ accept_all,
                                int64_t ids_per_table, int states,
                                const uint8_t* __restrict__ ok,
                                const uint8_t* __restrict__ xv,
                                uint8_t* __restrict__ out, int vec) {
  const int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (u >= n_ids) return;
  const int64_t table = u / ids_per_table;
  const T* __restrict__ trans = trans_all + table * states * 256;
  const uint8_t* __restrict__ accept = accept_all + table * states;
  const uint8_t* row = bytes + u * width;
  int state = 0;
  if (vec) {
    // width % 16 == 0 and 16-byte aligned rows (checked by the wrapper)
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    for (int w = 0; w < width / 16; ++w) {
      const uint4 v = __ldg(row4 + w);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = w * 16 + q * 4 + b;
          if (j >= prefix) state = step(trans, state, (words[q] >> (8 * b)) & 0xffu);
        }
      }
    }
  } else {
    for (int j = prefix; j < width; ++j) state = step(trans, state, row[j]);
  }
  state = step(trans, state, 0u);  // the TERM step
  out[u] = ok[u] ? accept[state] : xv[u];
}

template <typename T>
static int launch(const void* bytes, int64_t n_ids, int width, int prefix,
                  const void* trans, const void* accept,
                  int64_t ids_per_table, int states, const void* ok,
                  const void* xv, void* out, void* stream) {
  if (n_ids <= 0) return 0;
  if (ids_per_table <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int64_t blocks = (n_ids + threads - 1) / threads;
  const int vec = (width % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(bytes) % 16 == 0);
  dfa_scan_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bytes), n_ids, width, prefix,
      static_cast<const T*>(trans), static_cast<const uint8_t*>(accept),
      ids_per_table, states, static_cast<const uint8_t*>(ok), static_cast<const uint8_t*>(xv),
      static_cast<uint8_t*>(out), vec);
  return static_cast<int>(cudaGetLastError());
}

// n_batch tables of `states` states; bytes/ok/xv/out hold n_batch * n_ids
// ids, cluster-major.  trans_itemsize selects the stored width of the
// transition table (the executor may ship it narrowed to int16 or int8;
// widening happens at the gather).
extern "C" int gk_dfa_scan_batched(const void* bytes, int64_t n_batch,
                                   int64_t n_ids, int width, int prefix,
                                   const void* trans, int states,
                                   int trans_itemsize, const void* accept,
                                   const void* ok, const void* xv, void* out,
                                   void* stream) {
  const int64_t total = n_batch * n_ids;
  switch (trans_itemsize) {
    case 4: return launch<int32_t>(bytes, total, width, prefix, trans, accept, n_ids, states, ok, xv, out, stream);
    case 2: return launch<int16_t>(bytes, total, width, prefix, trans, accept, n_ids, states, ok, xv, out, stream);
    case 1: return launch<int8_t>(bytes, total, width, prefix, trans, accept, n_ids, states, ok, xv, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int gk_dfa_scan(const void* bytes, int64_t n_ids, int width,
                           int prefix, const void* trans, int trans_itemsize,
                           const void* accept, const void* ok, const void* xv,
                           void* out, void* stream) {
  return gk_dfa_scan_batched(bytes, 1, n_ids, width, prefix, trans, 0,
                             trans_itemsize, accept, ok, xv, out, stream);
}
