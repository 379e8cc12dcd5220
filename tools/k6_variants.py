"""Time variants of K6 (``gatekeeper_tpu_torch/csrc/devdelta.cu``) on one
CUDA card, to find what its time goes to.

    python3 tools/k6_variants.py

Each variant is the kernel's source with one text substitution, built
with nvcc beside the others and called through its C entry with the
wrapper's packed layout (``kernels/devdelta.layout``, at the variant's
tile size).  Each is timed device-only (20 calls in a CUDA graph,
replayed 5 times) at the path's shapes, in turns (every variant, then
every variant again in reverse order).  The variants marked "timing
only" compute wrong outputs on purpose, to measure the part they drop:
the look-back (every tile takes prefix 0), the row_any atomics, the
page-table loads (an identity table assumed).  The others are held
against ``mask_delta_plain`` bit for bit.  Prints the card's name and
power limit first.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gatekeeper_tpu_torch.kernels import build, devdelta  # noqa: E402

THREADS = "constexpr int kThreads = 256;"
ITEMS = "constexpr int kItems = 16;"
TICKET = "if (tid == 0) s_tile = static_cast<int>(atomicAdd(o.ticket, 1u));"
# name: (substitutions, threads, items, exact)
VARIANTS = {
    "kernel": ((), 256, 16, True),
    "threads 128": (((THREADS, "constexpr int kThreads = 128;"),),
                    128, 16, True),
    "threads 512": (((THREADS, "constexpr int kThreads = 512;"),),
                    512, 16, True),
    "threads 1024": (((THREADS, "constexpr int kThreads = 1024;"),),
                     1024, 16, True),
    "items 32": (((ITEMS, "constexpr int kItems = 32;"),), 256, 32, True),
    "blockIdx for the ticket": (((TICKET, "if (tid == 0) s_tile = "
                                  "blockIdx.x;"),), 256, 16, True),
    "no look-back (timing only)": (
        (("int j = tile - 1 - lane;", "int j = -1;"),), 256, 16, False),
    "no row_any atomics (timing only)": (
        (("atomicOr(ra + 4 * v + i, w)", "(void)0"),), 256, 16, False),
    "no page-table loads (timing only)": (
        (("      p[q] = reinterpret_cast<const int4*>(pt + r0)[q];",
          "      p[q] = make_int4(r0 + 4 * q, r0 + 4 * q + 1, "
          "r0 + 4 * q + 2, r0 + 4 * q + 3);"),), 256, 16, False),
}
CASES = ((4, 131072, 1e-3, "identity", 256),
         (128, 131072, 1e-4, "identity", 4096),
         (128, 131072, 0.3, "identity", 4096),
         (128, 131072, 1e-4, "permuted", 4096),
         (128, 4096, 1e-3, "identity", 1024))
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def build_all(workdir: str) -> dict:
    src = open(os.path.join(build.CSRC_DIR, "devdelta.cu")).read()
    procs = {}
    for i, (name, (subs, _t, _n, _e)) in enumerate(VARIANTS.items()):
        code = src
        for old, new in subs:
            if old not in code:
                raise SystemExit(f"{name}: {old!r} is not in devdelta.cu")
            code = code.replace(old, new)
        cu = os.path.join(workdir, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(code)
        so = os.path.join(workdir, f"libv{i}.so")
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), "-gencode", build.GENCODE, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(so).gk_devdelta
        fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
        fns[name] = fn
    return fns


def call(fn, tile, new, pt, old, k):
    c, r = new.shape
    a16 = lambda x: -(-x // 16) * 16                   # noqa: E731
    ra = a16(5 * k + 4)
    st = a16(ra + r)
    lay = {"signs": 4 * k + 4, "row_any": ra, "host": ra + r,
           "size": a16(st + 8 * -(-(c * r) // tile) + 4)}
    out = torch.empty_like(new)
    words = torch.empty((lay["size"] // 4,), dtype=torch.int32,
                        device=new.device)
    err = fn(new.data_ptr(), pt.data_ptr(), old.data_ptr(), out.data_ptr(),
             words.data_ptr(), lay["size"], c, r, k,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gk_devdelta: CUDA error {err}")
    return (out,) + devdelta._views(words, lay, k)


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (iters * replays)


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_variants: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as workdir:
        fns = build_all(workdir)
        g = torch.Generator().manual_seed(1)
        for c, r, dens, ptk, k in CASES:
            new = torch.rand((c, r), generator=g) < 0.4
            pt = torch.arange(r, dtype=torch.int32) if ptk == "identity" \
                else torch.randperm(r, generator=g).to(torch.int32)
            old = new[:, pt.long()] ^ (torch.rand((c, r), generator=g) < dens)
            new, pt, old = new.to(dev), pt.to(dev), old.to(dev)
            want = devdelta.mask_delta_plain(new, pt, old, k)
            times = {name: [] for name in fns}
            for name in list(fns) + list(fns)[::-1]:
                _subs, threads, items, exact = VARIANTS[name]
                tile = threads * items
                got = call(fns[name], tile, new, pt, old, k)
                torch.cuda.synchronize()
                if exact and not all(torch.equal(a, b)
                                     for a, b in zip(got, want)):
                    raise SystemExit(f"{name} differs from plain at "
                                     f"[{c}, {r}] {ptk} {dens} k {k}")
                times[name].append(graph_ms(
                    lambda: call(fns[name], tile, new, pt, old, k)))
            print(f"[{c}, {r}] {ptk} flips {dens} k {k}: " + "; ".join(
                f"{name} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                for name, ts in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
