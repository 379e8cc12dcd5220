"""Drive gatekeeper_tpu_torch on one CUDA card and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py [--resources N]

Phases (each prints one line of its numbers):
  1. card   — nvidia-smi name/power limit, torch and CUDA versions, TF32 off
  2. build  — nvcc builds K2 (csrc/topk.cu) and K3 (csrc/dfa.cu)
  3. kernels against their plain versions, bit for bit:
       K2 on random [128, 131072] masks at cap 20 and at a cap of 300
       (several passes), and at a ragged r_pad < k;
       K1 and K3 on a synthetic program that uses every IR op;
       the library set (48 device-lowered templates) over 2,000
       make_mixed rows through TorchDriver on the card — K1 on every
       program, K3 on the regex template — with the sweep's launch counts
  4. main path — TorchDriver() with the north-star set (3 templates x 67
     constraints = 201) over --resources pods, cap 20: a cold sweep and
     the best of 3 steady sweeps; K1/K2 launch counts; K1 and K2 at the
     sweep's own shapes against their plain versions; the results
     against TorchDriver(device="cpu") on the same store and against
     LocalDriver on a 300-pod subsample; K3 at the store's size: the
     library's regex template (K8sImageDigests) swept over the same pods,
     its string table against the plain scan
  5. the kernels JSON line, the card line, and the final JSON line.
Any mismatch or exception exits nonzero before the final line.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # non-tensor-core fp32 peak (ALU proxy)
TARGET = "admission.k8s.gatekeeper.sh"
CAP = 20                        # Gatekeeper's default audit cap
LIBRARY_ROWS = 2000


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = ops / H100_F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def packed_err(got, want, k: int) -> int:
    """Largest difference between two packed [C, 1+2k] top-k results over
    counts, valid flags and the rows of valid slots (the rows of invalid
    slots depend on tie order and are not part of the contract)."""
    gv, wv = got[:, 1 + k:], want[:, 1 + k:]
    return max(int((got[:, 0] - want[:, 0]).abs().max()),
               int((gv - wv).abs().max()),
               int((got[:, 1:1 + k] * gv - want[:, 1:1 + k] * wv).abs().max()))


def reset_counts(ir_eval, topk, dfa) -> None:
    for fn in (ir_eval.eval_mask, topk.topk_packed, dfa.dfa_table):
        fn.launches = 0
        fn.plain_calls = 0


def norm(results) -> list:
    return [(r.constraint["kind"], r.constraint["metadata"]["name"], r.msg,
             repr(r.metadata), r.enforcement_action,
             repr((r.resource or {}).get("metadata")))
            for r in results]


def dfa_inputs(arrays, nm: str) -> tuple:
    return (arrays[nm + ".trans"], arrays[nm + ".accept"],
            arrays["__strbytes__"], arrays["__strdfaok__"],
            arrays[nm + ".xv"], 3)


def k3_numbers(dfa, ins) -> dict:
    """K3 and its plain scan timed on ``ins``, with the bound: each id's
    byte row, the transition table and the flags read once, one table
    step per byte after the prefix plus the TERM step."""
    u, w = ins[2].shape
    trans = ins[0]
    nbytes = u * w + trans.numel() * trans.element_size() \
        + trans.shape[0] + 3 * u
    b, by = bound(nbytes, u * (w - 3 + 1))
    return {"ms": cuda_ms(lambda: dfa.dfa_table(*ins)),
            "plain_ms": cuda_ms(lambda: dfa.dfa_table_plain(*ins), iters=5),
            "bound_ms": b, "bound_by": by, "library_ms": None}


def k1_element_ops(executor_mod, program, arrays) -> int:
    """Lattice element operations of one evaluation: the size of every
    node's value block plus the epilogue (products count L*2 per output
    element).  Node shapes come from the plain evaluator on the first
    row chunk, scaled to the full rows, so the count costs one chunk's
    memory."""
    c, r = arrays["__cvalid__"].shape[0], arrays["__alive__"].shape[0]
    rc = min(r, executor_mod.R_CHUNK)
    ev = executor_mod._Evaluator(program, {
        nm: executor_mod._slice_r(nm, a, 0, rc) for nm, a in arrays.items()})
    ops = 0
    for i, n in enumerate(program.nodes):
        shape = torch.broadcast_shapes(*(t.shape for t in ev.node(i)))
        size = shape.numel() * (r // rc if shape[1] > 1 else 1)
        if n.op in ("cset_not_subset_memb", "cset_subset_memb",
                    "elem_keys_missing"):
            size *= 2 * arrays[n.meta[0] + ".B"].shape[1]
        ops += size
    return ops + 4 * c * r * len(program.rules)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--resources", type=int, default=100_000)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    # imported after the CUDA check, so a bare copy of this script fails
    # here too (the package must be beside it)
    from gatekeeper_tpu_torch import convert
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.client.interface import QueryOpts
    from gatekeeper_tpu_torch.client.local_driver import LocalDriver
    from gatekeeper_tpu_torch.engine import executor as ex
    from gatekeeper_tpu_torch.engine import torch_driver
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.kernels import build, dfa, ir_eval, topk
    from gatekeeper_tpu_torch.kernels.op_cases import every_op_case
    from gatekeeper_tpu_torch.library import all_docs, make_mixed
    from gatekeeper_tpu_torch.library.north_star import (make_resources,
                                                         setup_north_star)
    from gatekeeper_tpu_torch.library.templates import (LIBRARY,
                                                        constraint_doc,
                                                        template_doc)
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget

    # ---- 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi: no output"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | device {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()} | matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)

    # ---- 2. build (Triton's compile cache too stays in the checkout)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "gatekeeper_tpu_torch",
        "_build", "triton_cache"))
    t0 = time.perf_counter()
    secs = build.build()
    import triton
    print(f"phase build: {time.perf_counter() - t0:.3f}s wall, per library "
          f"{ {k: round(v, 3) for k, v in secs.items()} }, triton "
          f"{triton.__version__}", flush=True)

    dev = torch.device("cuda", 0)
    rec: dict[str, dict] = {}

    # ---- 3a. K2 on random masks, full and ragged, at the default cap
    # and at one that takes several passes
    g = torch.Generator(device="cpu").manual_seed(7)
    for c_pad, r_pad, dens in ((128, 131072, 0.3), (128, 131072, 1e-4),
                               (4, 8, 0.5)):
        viol = (torch.rand((c_pad, r_pad), generator=g) < dens).to(dev)
        rank = torch.randperm(r_pad, generator=g).to(torch.int32).to(dev)
        for k in (CAP, 300):
            got = topk.topk_packed(viol, rank, k)
            want = topk.topk_packed_plain(viol, rank, k)
            if packed_err(got, want, k):
                fail(f"K2 mismatch at [{c_pad}, {r_pad}] density {dens} "
                     f"k {k}")
        if dens == 0.3:
            k2_caps = {k: round(cuda_ms(lambda: topk.topk_packed(
                viol, rank, k)), 4) for k in (CAP, 300)}
    print(f"phase K2 random: [128,131072] x2 densities and ragged [4,8], k "
          f"{CAP} and 300, equal to plain; ms per launch at density 0.3 by "
          f"cap {k2_caps}", flush=True)

    # ---- 3b. K1 and K3 on a program using every IR op (the library
    # lowers to a subset: no and/any_e/all_e/count_e/+ - *), random
    # bindings with out-of-range ids and zero divisors
    for seed, kw in ((0, {}), (1, {"c_pad": 128, "r_pad": 1 << 14,
                                   "e_pad": 8, "t_pad": 4096, "u": 64})):
        prog, host = every_op_case(seed, **kw)
        arrays = convert.arrays_to_device(host, dev)
        d_dev = ex._with_dfa_tables(prog, arrays, dfa.dfa_table)
        if not torch.equal(d_dev["dfa0.devtab"],
                           ex._dfa_device_table(arrays, "dfa0")):
            fail(f"K3 mismatch on the every-op case {seed}")
        if not torch.equal(ir_eval.eval_mask(prog, d_dev),
                           ex._eval_mask(prog, arrays)):
            fail(f"K1 mismatch on the every-op case {seed}")
    print("phase every-op: K1 and K3 equal their plain versions on 2 "
          "every-op programs", flush=True)

    # ---- 3c. library set through TorchDriver on the card
    torch_driver.SMALL_WORKLOAD_EVALS = 0
    lib_drv = TorchDriver()
    lib = Backend(lib_drv).new_client([K8sValidationTarget()])
    for t, con in all_docs():
        lib.add_template(t)
        lib.add_constraint(con)
    lib.add_data_batch(make_mixed(random.Random(0), LIBRARY_ROWS))
    reset_counts(ir_eval, topk, dfa)
    t0 = time.perf_counter()
    lib_res, _ = lib_drv.query_audit(TARGET, QueryOpts(limit_per_constraint=CAP))
    lib_s = time.perf_counter() - t0
    lib_counts = {"K1": ir_eval.eval_mask.launches,
                  "K2": topk.topk_packed.launches,
                  "K3": dfa.dfa_table.launches}
    if min(lib_counts.values()) <= 0:
        fail(f"library sweep did not launch every kernel: {lib_counts}")
    st = lib_drv._state(TARGET)
    n_k1 = 0
    k1_err = k3_err = 0
    k3 = None
    for kind in sorted(st.bindings_cache):
        b = st.bindings_cache[kind][1]
        prog = st.templates[kind].vectorized.program
        arrays = lib_drv.executor._arrays(b, None)
        d_dev = ex._with_dfa_tables(prog, arrays, dfa.dfa_table)
        got = ir_eval.eval_mask(prog, d_dev)
        want = ex._eval_mask(prog, arrays)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"K1 mismatch on library template {kind}")
        k1_err = max(k1_err, int((got.int() - want.int()).abs().max()))
        n_k1 += 1
        for nm in ex.dfa_names(prog):
            ins = dfa_inputs(arrays, nm)
            g3, w3 = dfa.dfa_table(*ins), dfa.dfa_table_plain(*ins)
            if not torch.equal(g3, w3):
                fail(f"K3 mismatch on {kind}/{nm}")
            k3_err = max(k3_err, int((g3.int() - w3.int()).abs().max()))
            k3 = (kind, ins)
    if n_k1 != 48 or k3 is None:
        fail(f"library phase checked {n_k1} programs, regex {k3 is not None}")
    u, w = k3[1][2].shape
    k3_lib = k3_numbers(dfa, k3[1])
    print(f"phase library: {len(st.templates)} templates x {LIBRARY_ROWS}"
          f" rows, capped sweep {lib_s:.3f}s, {len(lib_res)} results, "
          f"launches {lib_counts}; K1 == plain on {n_k1} programs; K3 == "
          f"plain on {k3[0]} ([{u}, {w}] bytes, {k3[1][0].shape[0]} "
          f"states, launch-scale): {k3_lib['ms']:.4f} ms vs plain "
          f"{k3_lib['plain_ms']:.4f} ms, bound {k3_lib['bound_ms']:.6f}",
          flush=True)
    del lib_drv, lib, st

    # ---- 4. main path: north star on the card
    torch_driver.SMALL_WORKLOAD_EVALS = 20_000
    resources = make_resources(args.resources, random.Random(1))
    t0 = time.perf_counter()
    drv = TorchDriver()
    setup_north_star(drv, resources, random.Random(2))
    ingest_s = time.perf_counter() - t0
    opts = QueryOpts(limit_per_constraint=CAP)
    reset_counts(ir_eval, topk, dfa)
    t0 = time.perf_counter()
    cold, _ = drv.query_audit(TARGET, opts)
    cold_s = time.perf_counter() - t0
    steady = []
    for _ in range(3):
        t0 = time.perf_counter()
        res, _ = drv.query_audit(TARGET, opts)
        steady.append(time.perf_counter() - t0)
        if norm(res) != norm(cold):
            fail("steady sweep results differ from the cold sweep")
    counts = {"K1": ir_eval.eval_mask.launches,
              "K2": topk.topk_packed.launches,
              "K3": dfa.dfa_table.launches}
    if counts["K1"] <= 0 or counts["K2"] <= 0:
        fail(f"main path did not launch K1 and K2: {counts}")
    evals = args.resources * 201
    print(f"phase main: north star {args.resources} pods x 201 constraints "
          f"cap {CAP}: ingest {ingest_s:.3f}s, cold {cold_s:.4f}s, "
          f"steady best {min(steady):.4f}s (all {[round(s, 4) for s in steady]}), "
          f"{evals / min(steady):.4g} constraint-evals/s steady, "
          f"{len(cold)} results, launches {counts}", flush=True)
    split = {n: round(drv.metrics.timer(n).total, 4) for n in
             ("audit_prep_submit", "device_wait", "audit_format")}
    # one more steady sweep under the profiler: the device's busy share
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drv.query_audit(TARGET, opts)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in prof.key_averages()
                 if str(getattr(e, "device_type", "")).endswith("CUDA"))
    busy = f"{dev_us / 1e6 / traced_s:.4%}" if dev_us else "not measured"
    print(f"phase main split: timer totals over cold + 3 steady sweeps "
          f"{split}; traced steady sweep {traced_s:.4f}s with device busy "
          f"{dev_us / 1e3:.3f} ms = {busy} of it", flush=True)

    # K1 and K2 at the main path's own shapes
    st = drv._state(TARGET)
    k1_ms = k1_plain = k1_bound = k2_ms = k2_plain = k2_lib = k2_bound = 0.0
    k1_by = k2_by = "bytes"
    k2_err = 0
    kinds = sorted(st.bindings_cache)
    for kind in kinds:
        b = st.bindings_cache[kind][1]
        prog = st.templates[kind].vectorized.program
        arrays = drv.executor._arrays(b, None)
        got = ir_eval.eval_mask(prog, arrays)
        want = ex._eval_mask(prog, arrays)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"K1 mismatch on north-star template {kind}")
        k1_err = max(k1_err, int((got.int() - want.int()).abs().max()))
        used = ir_eval.emit_source(
            prog, ir_eval.array_signature(arrays))[1].ptrs
        nbytes = sum(arrays[nm].numel() * arrays[nm].element_size()
                     for nm in used) + got.numel()
        bms, k1_by = bound(nbytes, k1_element_ops(ex, prog, arrays))
        k1_bound += bms / len(kinds)
        k1_ms += cuda_ms(lambda: ir_eval.eval_mask(prog, arrays)) / len(kinds)
        k1_plain += cuda_ms(lambda: ex._eval_mask(prog, arrays),
                            iters=5) / len(kinds)
        rank = arrays["__rank__"]
        g2 = topk.topk_packed(got, rank, CAP)
        w2 = topk.topk_packed_plain(got, rank, CAP)
        k = CAP
        k2_err = max(k2_err, packed_err(g2, w2, k))
        if k2_err:
            fail(f"K2 mismatch on north-star template {kind}")
        c_pad, r_pad = got.shape
        bms, k2_by = bound(c_pad * r_pad + r_pad * 4 + c_pad * (1 + 2 * k) * 4,
                           2 * c_pad * r_pad)
        k2_bound += bms / len(kinds)
        k2_ms += cuda_ms(lambda: topk.topk_packed(got, rank, k)) / len(kinds)
        k2_plain += cuda_ms(lambda: topk.topk_packed_plain(got, rank, k),
                            iters=5) / len(kinds)
        score = torch.where(got, r_pad - rank[None, :], 0)
        k2_lib += cuda_ms(lambda: torch.topk(score, k, dim=1)) / len(kinds)
    rec["K1"] = {"launches": counts["K1"], "max_abs_err": k1_err, "ms": k1_ms,
                 "plain_ms": k1_plain, "bound_ms": k1_bound,
                 "bound_by": k1_by, "library_ms": None}
    rec["K2"] = {"launches": counts["K2"], "max_abs_err": k2_err, "ms": k2_ms,
                 "plain_ms": k2_plain, "bound_ms": k2_bound,
                 "bound_by": k2_by, "library_ms": k2_lib}
    print(f"phase main kernels: per launch at the sweep's shapes (mean over "
          f"{len(kinds)} kinds): K1 {k1_ms:.4f} ms (plain {k1_plain:.4f}, "
          f"bound {k1_bound:.4f}); K2 {k2_ms:.4f} ms (plain {k2_plain:.4f}, "
          f"torch.topk {k2_lib:.4f}, bound {k2_bound:.4f}); both equal "
          f"their plain versions", flush=True)
    del drv, st

    # the same store on the CPU path, and the scalar oracle on a subsample
    t0 = time.perf_counter()
    cpu = TorchDriver(device="cpu")
    setup_north_star(cpu, resources, random.Random(2))
    cpu_res, _ = cpu.query_audit(TARGET, opts)
    if norm(cpu_res) != norm(cold):
        fail("card results differ from TorchDriver(device='cpu')")
    cpu_s = time.perf_counter() - t0
    del cpu
    sub = resources[:300]
    torch_driver.SMALL_WORKLOAD_EVALS = 0
    small = TorchDriver()
    setup_north_star(small, sub, random.Random(2))
    oracle = LocalDriver()
    setup_north_star(oracle, sub, random.Random(2))
    a = norm(small.query_audit(TARGET, QueryOpts())[0])
    b = norm(oracle.query_audit(TARGET, QueryOpts())[0])
    if a != b or not a:
        fail(f"300-pod subsample: card {len(a)} results, LocalDriver {len(b)}")
    print(f"phase check: {len(cold)} capped results equal TorchDriver(cpu) "
          f"on the same store ({cpu_s:.1f}s incl. ingest); 300-pod "
          f"subsample {len(a)} uncapped results equal LocalDriver", flush=True)

    # K3 at the store's size: the library's regex template over the same
    # pods (one string table entry per interned value its bindings read)
    torch_driver.SMALL_WORKLOAD_EVALS = 0
    dig = TorchDriver()
    dc = Backend(dig).new_client([K8sValidationTarget()])
    rego, params = LIBRARY["K8sImageDigests"]
    dc.add_template(template_doc("K8sImageDigests", rego))
    dc.add_constraint(constraint_doc("K8sImageDigests", "digests", params))
    dc.add_data_batch(resources)
    reset_counts(ir_eval, topk, dfa)
    dig_res, _ = dig.query_audit(TARGET, opts)
    dig_counts = {"K1": ir_eval.eval_mask.launches,
                  "K2": topk.topk_packed.launches,
                  "K3": dfa.dfa_table.launches}
    if min(dig_counts.values()) <= 0:
        fail(f"K8sImageDigests sweep did not launch every kernel: "
             f"{dig_counts}")
    st = dig._state(TARGET)
    prog = st.templates["K8sImageDigests"].vectorized.program
    arrays = dig.executor._arrays(st.bindings_cache["K8sImageDigests"][1],
                                  None)
    (nm,) = ex.dfa_names(prog)
    ins = dfa_inputs(arrays, nm)
    g3, w3 = dfa.dfa_table(*ins), dfa.dfa_table_plain(*ins)
    if not torch.equal(g3, w3):
        fail("K3 mismatch on the K8sImageDigests store table")
    k3_err = max(k3_err, int((g3.int() - w3.int()).abs().max()))
    n_ids = int(arrays["__strdfaok__"].sum())
    rec["K3"] = {"launches": dig_counts["K3"], "max_abs_err": k3_err,
                 **k3_numbers(dfa, ins)}
    print(f"phase K3 store: K8sImageDigests over {args.resources} pods, "
          f"{len(dig_res)} capped results, launches {dig_counts}; string "
          f"table {list(ins[2].shape)} bytes ({n_ids} scannable ids), "
          f"{ins[0].shape[0]} states: K3 {rec['K3']['ms']:.4f} ms vs plain "
          f"{rec['K3']['plain_ms']:.4f} ms, bound "
          f"{rec['K3']['bound_ms']:.6f} ms ({rec['K3']['bound_by']}); equal "
          f"to plain", flush=True)
    del dig, dc, st, arrays

    # ---- 5. kernels line, card line, final line
    meta = {
        "K1": ("ir_eval", "triton", "gatekeeper_tpu_torch/kernels/ir_eval.py",
               "gatekeeper_tpu/engine/veval.py:294"),
        "K2": ("topk", "cuda", "gatekeeper_tpu_torch/csrc/topk.cu",
               "gatekeeper_tpu/engine/veval.py:660"),
        "K3": ("dfa", "cuda", "gatekeeper_tpu_torch/csrc/dfa.cu",
               "gatekeeper_tpu/engine/veval.py:227"),
    }
    kernels = []
    for key in ("K1", "K2", "K3"):
        name, route, source, replaces = meta[key]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, **rec[key]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
