"""Time variants of K3 (``gatekeeper_tpu_torch/csrc/dfa.cu``) on one CUDA
card, to find what its time goes to.

    python3 tools/k3_variants.py

Inputs: the path's tables, built as ``chip_smoke.py --k3-only`` builds
them (the store's, the library's, the library fleet's stacked one, and
the synthetic ``[262144, 128]`` table), all K8sImageDigests' 75-state DFA
shipped as int32.  Variants of three sorts, each timed device-only (20
calls in a CUDA graph, replayed 5 times), in turns (every variant, then
every variant again in reverse order), and each held against the plain
scan bit for bit:

- the kernel's source with one text substitution, built with nvcc beside
  the others: no fixed-point stop in the tail, every column stepped (no
  live-byte cut), only the ok rows of a tile copied (their flags read
  first), the table staged as uint16 whatever its states (not uint8 to
  256 states), 4 table loads in flight a thread instead of 8, the whole
  [S][256] table staged instead of its columns 0-127, the half table
  kept [128][S] (transposed: a step is s + byte * S) instead of
  [S][128]; and, timing only
  (wrong outputs, not checked), an empty kernel, no staging, no table
  steps;
- the kernel as built, launched with another geometry than the plan's:
  32-512 ids a block, 256 or 1,024 threads, the global table (no shared
  memory), rows read from global memory;
- the warp-segment form (timing only, not in ``dfa.cu``): one warp an
  id, lane s runs each of G segments of the live bytes from state s,
  ``__shfl_sync`` composes the G maps from state 0.  It needs S <= 32,
  so it runs the path's rows under the library's 27-state
  ``(?i)(password|secret|token|apikey)`` DFA, beside the kernel on the
  same inputs.

Prints the card's name and power limit first.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from gatekeeper_tpu_torch.kernels import build, dfa  # noqa: E402
from gatekeeper_tpu_torch.ops import regex_dfa  # noqa: E402

SOURCE_VARIANTS = {
    "kernel": (),
    "no fixed-point stop": ((
        "    if (nz == s) break;\n", ""),),
    "every column stepped": ((
        "  int s = 0;\n  if (jstar >= prefix) {",
        "  jstar = width - 1;\n  int s = 0;\n  if (jstar >= prefix) {"),),
    "copy only the ok rows": ((
        "    cp_async16(rows + r * a.row_chunks + (k - r * nvec), src + k);",
        "    if (a.ok[first + r])\n"
        "      cp_async16(rows + r * a.row_chunks + (k - r * nvec), src + k);"),),
    "uint16 table only": ((
        "  const int stored_width = static_cast<int>(geometry[kStored]);",
        "  const int stored_width = geometry[kStored] ? 2 : 0;"),),
    "stage batch 4": ((
        "constexpr int kStageBatch = 8;", "constexpr int kStageBatch = 4;"),),
    "full [S][256] table": (
        ("  const int n = states * 128;", "  const int n = states * 256;"),
        ("      t[i] = static_cast<TS>(__ldg(g + ((i >> 7) << 8) + (i & 127)));",
         "      t[i] = static_cast<TS>(__ldg(g + i));"),
        ("        if (i < n4) v[q] = __ldg(g4 + i + (i / kRow) * kRow);",
         "        if (i < n4) v[q] = __ldg(g4 + i);"),
        ("    return t[(s << 7) | static_cast<int>(b)];",
         "    return t[(s << 8) | static_cast<int>(b)];"),
        ("int z(int s) const { return t[s << 7]; }",
         "int z(int s) const { return t[s << 8]; }"),
        ("reinterpret_cast<uint8_t*>(t + 128 * a.states)",
         "reinterpret_cast<uint8_t*>(t + 256 * a.states)"),
        ("((128 * a.states * stored_width", "((256 * a.states * stored_width")),
    "transposed [128][S] table": (
        ("  const uint8_t* a;\n  __device__ __forceinline__ int step(int s, unsigned b) const {\n"
         "    return t[(s << 7) | static_cast<int>(b)];\n  }\n"
         "  __device__ __forceinline__ int z(int s) const { return t[s << 7]; }",
         "  const uint8_t* a;\n  int states;\n"
         "  __device__ __forceinline__ int step(int s, unsigned b) const {\n"
         "    return t[static_cast<int>(b) * states + s];\n  }\n"
         "  __device__ __forceinline__ int z(int s) const { return t[s]; }"),
        ("run(SharedTable<TS>{t, acc});", "run(SharedTable<TS>{t, acc, a.states});"),
        ("      t[i] = static_cast<TS>(__ldg(g + ((i >> 7) << 8) + (i & 127)));",
         "      t[(i & 127) * states + (i >> 7)] =\n"
         "          static_cast<TS>(__ldg(g + ((i >> 7) << 8) + (i & 127)));"),
        ("        narrow_store<TG, TS>(t + i * K, v[q]);",
         "        const uint32_t w4[4] = {v[q].x, v[q].y, v[q].z, v[q].w};\n"
         "        for (int k = 0; k < K; ++k) {\n"
         "          uint32_t e = w4[k * sizeof(TG) / 4];\n"
         "          if constexpr (sizeof(TG) < 4)\n"
         "            e = (e >> (8 * sizeof(TG) * (k % (4 / sizeof(TG))))) &\n"
         "                ((1u << (8 * sizeof(TG))) - 1u);\n"
         "          t[((i % kRow) * K + k) * states + i / kRow] =\n"
         "              static_cast<TS>(e);\n"
         "        }")),
    "empty kernel (timing only)": ((
        "  const int64_t table = blockIdx.y;\n",
        "  if (a.n_ids >= 0) return;\n  const int64_t table = blockIdx.y;\n"),),
    "no staging (timing only)": ((
        "stage_table<TG, TS>(g, a.accept, t, acc, a.states, a.trans_aligned);",
        "for (int i = threadIdx.x; i < 8 * a.states * int(sizeof(TS)); "
        "i += blockDim.x)\n      reinterpret_cast<uint4*>(t)[i] = "
        "make_uint4(0, 0, 0, 0);"),),
    "no steps (timing only)": ((
        "  return collapse_tail(tab, s, width - jstar);\n}\n\n// The same",
        "  return jstar & 1;\n}\n\n// The same"),),
}

SEG_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// One warp an id, tables of at most 32 states, rows of at most 128 bytes
// (4-byte aligned): lane l holds bytes 4l..4l+3 of the row and runs each
// of G segments of the live bytes from start state l; the G chains are
// independent; __shfl_sync composes the G maps from state 0, then the
// tail collapses as in dfa.cu.
template <int G>
__global__ void seg_kernel(const uint8_t* __restrict__ bytes, int64_t n_ids,
                           int width, int prefix,
                           const int32_t* __restrict__ trans, int states,
                           const uint8_t* __restrict__ accept,
                           const uint8_t* __restrict__ ok,
                           const uint8_t* __restrict__ xv,
                           uint8_t* __restrict__ out) {
  __shared__ uint8_t t[256 * 32];
  __shared__ uint8_t acc[32];
  for (int i = threadIdx.x; i < states * 256; i += blockDim.x)
    t[(i & 255) * states + (i >> 8)] = static_cast<uint8_t>(__ldg(trans + i));
  for (int i = threadIdx.x; i < states; i += blockDim.x) acc[i] = accept[i];
  __syncthreads();
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                   (threadIdx.x >> 5);
       u < n_ids; u += warps) {
    if (!ok[u]) {
      if (lane == 0) out[u] = xv[u];
      continue;
    }
    const uint32_t* row = reinterpret_cast<const uint32_t*>(bytes + u * width);
    const uint32_t word = 4 * lane < width ? __ldg(row + lane) : 0u;
    uint32_t w = word;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * lane + b < prefix) w &= ~(0xffu << (8 * b));
    const int top = w ? 4 * lane + 3 - (__clz(w) >> 3) : -1;
    const int jend = max(__reduce_max_sync(full, top), prefix - 1);
    const int seg = (jend - prefix + 1 + G - 1) / G;
    int s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = lane < states ? lane : 0;
    for (int k = 0; k < seg; ++k) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int j = prefix + g * seg + k;
        const uint32_t src = __shfl_sync(full, word, (j >> 2) & 31);
        if (j <= jend) s[g] = t[((src >> (8 * (j & 3))) & 0xffu) * states + s[g]];
      }
    }
    int st = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) st = __shfl_sync(full, s[g], st);
    for (int n = width - jend; n > 0; --n) {
      const int nz = t[st];
      if (nz == st) break;
      st = nz;
    }
    if (lane == 0) out[u] = acc[st];
  }
}

extern "C" int gk_dfa_seg(const void* bytes, int64_t n_ids, int width,
                          int prefix, const void* trans, int states,
                          const void* accept, const void* ok, const void* xv,
                          void* out, int g, int blocks, void* stream) {
  if (states > 32 || width > 128 || width % 4) return 1;
  const auto b = static_cast<const uint8_t*>(bytes);
  const auto tr = static_cast<const int32_t*>(trans);
  const auto a = static_cast<const uint8_t*>(accept);
  const auto o = static_cast<const uint8_t*>(ok);
  const auto x = static_cast<const uint8_t*>(xv);
  const auto r = static_cast<uint8_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (g) {
    case 1: seg_kernel<1><<<blocks, 256, 0, st>>>(b, n_ids, width, prefix, tr, states, a, o, x, r); break;
    case 2: seg_kernel<2><<<blocks, 256, 0, st>>>(b, n_ids, width, prefix, tr, states, a, o, x, r); break;
    case 4: seg_kernel<4><<<blocks, 256, 0, st>>>(b, n_ids, width, prefix, tr, states, a, o, x, r); break;
    case 8: seg_kernel<8><<<blocks, 256, 0, st>>>(b, n_ids, width, prefix, tr, states, a, o, x, r); break;
    default: return 1;
  }
  return static_cast<int>(cudaGetLastError());
}
"""
SEG_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def nvcc(cu: str, so: str) -> subprocess.Popen:
    return subprocess.Popen(
        [build._nvcc(), "-gencode", build.GENCODE, "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-o", so, cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def build_all(workdir: str) -> tuple[dict, object]:
    src = open(os.path.join(build.CSRC_DIR, "dfa.cu")).read()
    procs = {}
    for i, (name, subs) in enumerate(SOURCE_VARIANTS.items()):
        code = src
        for old, new in subs:
            if old not in code:
                raise SystemExit(f"{name}: {old!r} is not in dfa.cu")
            code = code.replace(old, new)
        cu = os.path.join(workdir, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(code)
        so = os.path.join(workdir, f"libv{i}.so")
        procs[name] = (so, nvcc(cu, so))
    seg_cu = os.path.join(workdir, "seg.cu")
    with open(seg_cu, "w") as f:
        f.write(SEG_SOURCE)
    seg_so = os.path.join(workdir, "libseg.so")
    procs["seg"] = (seg_so, nvcc(seg_cu, seg_so))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    fns = {}
    for name in SOURCE_VARIANTS:
        fn = libs[name].gk_dfa_scan
        fn.argtypes, fn.restype = dfa._SCAN_ARGTYPES, ctypes.c_int
        fns[name] = fn
    seg = libs["seg"].gk_dfa_seg
    seg.argtypes, seg.restype = SEG_ARGTYPES, ctypes.c_int
    return fns, seg


def scan_call(fn, ins, geo):
    """One launch of a gk_dfa_scan build on ``ins`` with ``geo`` (stored
    width, threads, ids a block, blocks, row chunks)."""
    trans, accept, sb, ok, xv, prefix = ins
    n_b = sb.shape[0] if sb.dim() == 3 else 1
    arr = (ctypes.c_int64 * 11)(n_b, sb.shape[-2], sb.shape[-1], prefix,
                                trans.shape[-2], trans.element_size(), *geo)
    out = torch.empty(ok.shape, dtype=torch.bool, device=sb.device)
    err = fn(ctypes.addressof(arr), sb.data_ptr(), trans.data_ptr(),
             accept.data_ptr(), ok.data_ptr(), xv.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gk_dfa_scan: CUDA error {err}")
    return out


def seg_call(seg, ins, g):
    trans, accept, sb, ok, xv, prefix = ins
    out = torch.empty(ok.shape, dtype=torch.bool, device=sb.device)
    blocks = max(1, min(-(-sb.shape[0] // 8), 132 * 8))
    err = seg(sb.data_ptr(), sb.shape[0], sb.shape[1], prefix,
              trans.data_ptr(), trans.shape[0], accept.data_ptr(),
              ok.data_ptr(), xv.data_ptr(), out.data_ptr(), g, blocks,
              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gk_dfa_seg: error {err}")
    return out


def geometries(ins) -> dict:
    """Launch geometries beside the plan's, for the kernel as built."""
    sb = ins[2]
    n_b = sb.shape[0] if sb.dim() == 3 else 1
    n_ids = sb.shape[-2]
    lim = dfa.limits(sb.device)
    p = dfa.plan_for(ins[0], sb)

    def geo(stored, threads, ids, chunks):
        tiles = -(-n_ids // ids)
        per_sm = max(1, min(lim.sm_threads // threads, lim.sm_smem // (
            p.smem - 16 * p.ids * p.row_chunks + 16 * ids * chunks + 1024)))
        return (stored, threads, ids,
                max(1, min(tiles, lim.sms * per_sm // n_b)), chunks)

    out = {"plan": (p.stored_width, p.threads, p.ids, p.blocks,
                    p.row_chunks)}
    for ids in (32, 64, 128, 256, 512):
        if ids != p.ids:
            out[f"{ids} ids a block"] = geo(p.stored_width, p.threads, ids,
                                            p.row_chunks)
    for t in (256, 1024):
        if t != p.threads and t >= p.ids:
            out[f"{t} threads"] = geo(p.stored_width, t, p.ids, p.row_chunks)
    out["global table"] = geo(0, p.ids, p.ids, p.row_chunks)
    out["rows from global memory"] = geo(p.stored_width, p.threads, p.ids, 0)
    return out


def turns(cands: dict, want) -> dict:
    """Device ms of every candidate, in turns (forward, then reverse),
    each first held against ``want`` (but the timing-only ones)."""
    for name, fn in cands.items():
        if "timing only" not in name and not torch.equal(fn(), want):
            raise SystemExit(f"{name}: differs from the plain scan")
    times = {name: [] for name in cands}
    for order in (list(cands), list(cands)[::-1]):
        for name in order:
            times[name].append(chip_smoke.graph_ms(cands[name]))
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_variants: CUDA is not available", file=sys.stderr)
        return 2
    os.environ["GATEKEEPER_PAGES"] = "off"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as workdir:
        fns, seg = build_all(workdir)
        path = chip_smoke.k3_path_inputs(dfa, 100_000)
        path["large"] = chip_smoke.k3_large(dev)
        d27 = regex_dfa.compile_dfa("(?i)(password|secret|token|apikey)")
        for key in ("store", "library", "fleet", "large"):
            ins = tuple(x.to(dev) if torch.is_tensor(x) else x
                        for x in path[key])
            batched = ins[2].dim() == 3
            plain = dfa.dfa_table_batched_plain if batched \
                else dfa.dfa_table_plain
            want = plain(*ins)
            geo = geometries(ins)
            cands = {}
            for name, fn in fns.items():
                cands[name] = (lambda f=fn: scan_call(f, ins, geo["plan"]))
            for name, g in geo.items():
                if name != "plan":
                    cands[name] = (lambda g=g: scan_call(fns["kernel"], ins,
                                                         g))
            times = turns(cands, want)
            print(f"{key}: {chip_smoke.k3_text(dfa, ins)}; plan "
                  f"{geo['plan']}", flush=True)
            for name, ts in times.items():
                print(f"  {name:28s} device ms {ts[0]:.4f} {ts[1]:.4f}",
                      flush=True)
            if batched:
                continue
            ins27 = (torch.from_numpy(d27.trans.astype(np.int32)).to(dev),
                     torch.from_numpy(d27.accept).to(dev)) + ins[2:]
            want27 = dfa.dfa_table_plain(*ins27)
            p27 = dfa.plan_for(ins27[0], ins27[2])
            cands = {"kernel (27 states)": lambda: scan_call(
                fns["kernel"], ins27, (p27.stored_width, p27.threads,
                                       p27.ids, p27.blocks, p27.row_chunks))}
            for g in (1, 2, 4, 8):
                cands[f"warp segments G={g}"] = \
                    (lambda g=g: seg_call(seg, ins27, g))
            times = turns(cands, want27)
            print(f"{key}, 27-state DFA: "
                  f"{chip_smoke.k3_text(dfa, ins27)}", flush=True)
            for name, ts in times.items():
                print(f"  {name:28s} device ms {ts[0]:.4f} {ts[1]:.4f}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
