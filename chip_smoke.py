"""Drive gatekeeper_tpu_torch on one CUDA card and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py [--resources N] [--k2-only | --k1-only |
                           --k6k7-only | --k3-only | --admission-only |
                           --manager-only | --reactor-only | --worker-only |
                           --extdata-only | --probe-only | --reuse-only]

``--k2-only`` runs phases 1-2 for K2 alone and K2's random-mask phases,
then prints the card line; it uses only the K2 wrappers' public names,
so a copy of this script beside an earlier tree's package times that
tree's K2 on the same card.  ``--k1-only`` does the same for K1, K1b
and K5: it builds K3, holds the three against their plain versions on
every-op programs and on the north-star kinds at the path's shapes and
times each per call and device-only (``eval_mask``, ``delta_mask`` and
``eval_mask_batched`` are the only names of ``ir_eval`` it calls
besides ``emit_source`` for the bound).  ``--k6k7-only`` builds K6 and
K7 alone, holds K6 against its plain version on the devpages phase's
random cases and K7 on a join at the ingress phase's row count, and
times both per call and device-only at the path's shapes, through the
public ``mask_delta`` and ``inv_join_mask`` alone.  ``--k3-only`` builds
K3 alone, holds K3 and K3b against their plain versions on the design's
cases (phase K3 random) and times them per call and device-only at the
store's, the library's and the library fleet's tables (built on the host
by ``TorchDriver(device="cpu")``, no Triton compile) and at a synthetic
[262144, 128] table, through the public ``dfa_table`` and
``dfa_table_batched`` alone; each line gives S, the table's dtype, the
plan (branch, stored width, ids and threads a block, blocks) and the
live bytes.
``--admission-only`` builds K3 alone and runs only phase 10, the
admission micro-batch.  ``--manager-only`` builds K2, K3 and K4 and runs
only phase 11, the manager process.  ``--reactor-only`` builds K2, K3,
K4 and K6 and runs only phase 12, the event reactor.  ``--worker-only``
builds K2, K3 and K4 and runs only phase 13, the engine worker split.
``--extdata-only`` and ``--probe-only`` build K2 and K3 and run only
phase 14, external data, or phase 15, the probe.  ``--reuse-only``
builds K2, K3 and K4 and runs only phase 16, reuse and what-if.

Every TorchDriver starts a background warm-up of its kinds' churn-delta
variants (K5) after its first capped legacy sweep, and a batch ingest of
MIRROR_EAGER_MIN_ROWS (50,000) rows or more builds each kind's bindings
at once and compiles each kind's full K1 variant on background
ingest-prewarm threads; the script waits for both (``wait_delta_warm``,
``wait_ingest_warm``; ``graph_ms`` joins every warm thread first) before
it times anything or captures a CUDA graph.  The churn phase fails if
its first churned sweep still compiles a Triton variant, and the main
phase if its cold sweep does.

Phases (each prints one line of its numbers):
  1. card   — nvidia-smi name/power limit, torch and CUDA versions, TF32 off
  2. build  — nvcc builds K2 (csrc/topk.cu), K3 (csrc/dfa.cu), K4
     (csrc/scatter.cu), K6 (csrc/devdelta.cu), K7 (csrc/invjoin.cu) and
     K8 (csrc/residency.cu), all at once
  3. kernels against their plain versions, bit for bit:
       K2 on random [128, 131072] masks at caps 20 and 300, at a ragged
       r_pad < k and on [4, 131072] at cap 65,536 (several selects), and
       K2b on [4, 128, 131072], each timed per call and device-only (a
       CUDA graph) beside torch.topk timed the same ways;
       K1 and K3 on a synthetic program that uses every IR op, K1 on
       ordering compares of row against constraint values (NaN,
       infinities, signed zeros);
       K3 and K3b on one case a branch and stored width of the design's
       (phase K3 random): the digest DFA and synthetic ones of 257 and
       905 states at every table dtype that holds the states, rows 40
       and 128 wide, aligned and a byte off, K3b over 1 and 4 clusters
       (``--k3-only`` runs every case);
       K4 on random columns of every dtype and axis layout, with
       duplicate padding rows, one at a time and all in one batched
       launch; K5 on the every-op programs at random rows;
       the library set (48 device-lowered templates) over 2,000
       make_mixed rows through TorchDriver on the card — K1 on every
       program, K3 on the regex template — with the sweep's launch
       counts; its capped results equal TorchDriver(device="cpu")'s on
       the same store; then two forced full sweeps (``full_sweeps``):
       results equal the memoized sweep's, no Triton variant compiled,
       K1, K2 and K3 launched, device_s > 0, h2d_bytes the kinds'
       Bindings.nbytes() and the shared dedup columns the sweep bound
       into them, overlap_fraction under 0.05, the last sweep's
       recorded launches equal to their plain versions; the phase dicts
       printed
  4. main path — TorchDriver() with the north-star set (3 templates x 67
     constraints = 201) over --resources pods, cap 20: the ingest (its
     eager mirror's seconds), the wait for its ingest warm (its seconds,
     the Triton variants it compiled), a cold sweep that must compile no
     Triton variant, the wait for its delta warm-up (its seconds), and
     the best of 3 steady sweeps; K1/K2 launch counts; K1 and K2 at the
     sweep's own shapes against their plain versions; the results
     against TorchDriver(device="cpu") on the same store and against
     LocalDriver on a 300-pod subsample; K3 at the store's size: the
     library's regex template (K8sImageDigests) swept over the same pods,
     its string table against the plain scan, K3 timed per call and
     device-only
  5. churn — on the same driver and store, 3 rounds that each upsert 1%
     of the pods (new labels on existing names) and run a capped sweep:
     each sweep's results against TorchDriver(device="cpu") on the same
     churned store, no Triton variant compiled by the first churned sweep
     (the warm-up compiled K5's), 3 K5 launches, no full K1 launch and
     one batched K4
     launch per migrating kind (at most 3) per sweep, K4 and K5 against
     their plain versions on the churn's own inputs, their times at the
     churn's shapes (K4 per job and per batched call, each per call and
     device-only from a CUDA graph, beside torch.index_copy timed the
     same ways), and device memory that stops growing; then the
     full-sweep pair of 3d on the churned store (K1 and K2; results
     equal the last churned sweep's, itself equal to the CPU driver's),
     and K1, K2 (here) and K3 (the library's) timed at the full
     sweeps' recorded inputs
  6. fleet — the fleet audit (B9): batched K1, K2 and K3 against their
     plain versions on stacked every-op cases (N 1-5, ragged sizes) and
     random masks; (a) 4 north-star clusters (100k, 90k, 80k and 60k
     pods x 201 constraints, each TorchDriver() on its own seed) and (b)
     4 library clusters of 2,500 make_mixed rows, each audited by
     fleet_audit twice (warm, then timed) and by fleet_loop_oracle:
     digests equal (and equal TorchDriver(device="cpu") for (b) and the
     60k cluster), one batched K1 and one batched K2 launch per stacked
     kind (plus one batched K3 per regex table), the batched kernels on
     the phase's own inputs against their plain versions, timed at
     (a)'s shapes (batched K1 also at (b)'s, its own entry in the
     kernels line), the Triton variant count (the timed audit compiles
     none) and peak device memory
  7. devpages — the paged audit with device-resident deltas (B6): K6
     against its plain version on random masks (overflow, permuted and
     out-of-range page tables, ragged sizes) and at [128, 131072] on
     the main phase's steady mask against its first churned mask; the
     cold ledger build timed at 10,000 pods; then 66,000 pods x 3
     constraints (the north-star templates, one constraint each) on
     driver A (GATEKEEPER_PAGES=on, GATEKEEPER_DEVPAGES=on), driver B
     (GATEKEEPER_PAGES=off, the oracle) and driver C (GATEKEEPER_PAGES=on,
     GATEKEEPER_DEVPAGES=off: the default route, the host page loop), a
     cold sweep and 3 rounds of 1% relabels, each followed by a capped
     sweep on A and B, and on C in the first DEVPAGES_C_ROUNDS (its host
     page loop takes 20-30 s a sweep here; C is released after them):
     equal results, 3 K6 launches per churned sweep
     on A (plus one per overflow) and none on C, every kind on the
     device on A, row-sized transfers, flat device memory, ledger events
     that add up and equal ledger totals on A and C, K6 on the phase's
     own inputs and every K4 call of A's churned sweeps against its plain
     version, K6 timed per call and device-only there (beside
     torch.nonzero); each churned sweep's host time on A split into
     the scalar confirm, the direct clears and the ledger serve (the
     script wraps the driver's methods)
  8. devpages budget — the residency planner (B8): drivers A and B of 7
     (C released) go on for 3 more rounds of 1% relabels with
     GATEKEEPER_DEVPAGES_BUDGET_BYTES=131072, under each kind's certified
     resident claim (1,572,864 bytes): A keeps 1,024 of each mask's 4,096
     32-row pages on the device.  Results equal B's, ledger events add
     up, every kind on the device with 3 x 1,024 resident pages, spills
     and restores in rounds 2 and 3, one K8 gather per kind per sweep and
     one K8 scatter per kind from round 2, K8 equal to plain on every
     store and expand and K4 on every restore, K8 timed at [4, 131072]
     per call and device-only from a CUDA graph beside torch.index_select
     / torch.index_copy timed the same ways, device memory flat and lower
     than unbudgeted by
     the 3 masks less the 3 slot buffers, each kind's delta high-water
     and device bindings within its Stage-8 certificate, the card's
     total_memory (the default budget), and the planner's host time in
     the split
  9. devpages ingress — the inventory-join kind (B7): K8sUniqueIngressHost
     alone, one constraint on Ingress (extensions, networking.k8s.io),
     over 66,000 pods and 2,000 Ingresses in 200 namespaces (50 hosts
     shared by two, one same-name pair, the rest unique) on driver A
     (pages and devpages on), B (GATEKEEPER_PAGES=off) and
     TorchDriver(device="cpu"): a cold sweep and 3 rounds that delete 20
     Ingresses (10 breaking a shared host), add 20 (10 on a unique host)
     and relabel 1,000 pods.  Results equal on all three, ledger totals
     equal to the duplicates the script counts, appears minus clears
     equal to the change, one K7 launch per delta evaluation (plus one
     per overflow), K7 equal to plain on the sweeps' own inputs and
     timed there per call and device-only, K4 equal to plain on every
     call of A's churned sweeps,
     flat device memory, the host split as in 7, the join
     kind's delta high-water and device bindings within its certificate
 10. admission — the review micro-batch (query_review_batch): 200
     constraints (K8sRequiredLabels and K8sAllowedRepos, 100 each) over
     1,024 make_resources CREATE reviews; the scalar single-thread rate
     over 1,024 query_review calls (4 chunks); every review's per-review
     answer (and the library batch's) from an oracle process started with
     the run (spawned, TorchDriver(device="cpu"), joined or stopped before
     the script ends), equal to those 1,024; with both routing thresholds
     at 0, per batch size (64, 256, 1,024) one untimed batch (its
     seconds and the Triton variants it compiles) and 4 timed batches (2
     at 1,024: reviews/s, K1 and K3 launches, h2d bytes), each
     equal to per-review query_review, no variant compiled by a timed
     batch; the crossover (the smallest size whose slowest timed batch
     beats the fastest scalar chunk by more than the chunks' spread,
     times 200; with none, one above the
     largest size times 200: REVIEW_BATCH_MIN_EVALS) and the cost model's
     units per second at each size (the slowest, rounded down: the cost
     prior); one batch of 1,024 make_mixed reviews (CREATE/UPDATE/DELETE)
     under the whole library, equal to per-review query_review, with K1
     and K3 launched; K1 timed at the review batch's shape (B 1,024)
     per call and device-only against its plain version and bound,
     K3 at the library batch's; a MicroBatcher over client.review_batch
     serving 256 submits from 8 threads, every response equal to
     query_review, every batch on the device pass
 11. manager — the manager process (``gatekeeper_tpu_torch.cmd.manager``
     ``Manager`` from ``parse_args(["--port", "0", "--audit-interval",
     "3600"])``, its TorchDriver on the card, ``start()``): the sync
     Config, the 3 north-star templates and K8sImageDigests, 202
     constraints (the north-star draws and one K8sImageDigests), 50
     namespaces and MANAGER_PODS (5,000) make_resources pods created as cluster
     objects and synced by the controllers (objects/s); a cold and a
     steady ``audit.audit_once()`` whose written statuses equal a direct
     ``Client.audit(limit_per_constraint=20)`` on a second TorchDriver fed
     the cluster's stored objects (K1, K2, K3 launched); 200 pods
     relabelled through ``cluster.update`` and a churned ``audit_once``
     with K4 and K5 launched and no full K1, checked the same way; 256
     CREATE reviews POSTed to /v1/admit from 8 threads with batch_mode
     "always" (query_review_batch: K1r, K3r) and 64 with the shipped
     "auto" (no K1 launch), every answer equal to the oracle process's
     per-review ValidationHandler answer (reviews/s, p50/p99 latency);
     /metrics, /debug/trace (admission.request, audit.cycle) and
     /healthz; ``stop()`` joins every thread; then the 7 kernels at the
     phase's own recorded inputs against their plain versions (checked
     as they were recorded) and timed per call and device-only
 12. reactor — the event reactor (enforce/reactor.py) under the
     manager's defaults: ``Manager`` from ``parse_args(["--port", "0",
     "--audit-interval", "3600", ...])`` with GATEKEEPER_PAGES unset (on)
     and GATEKEEPER_DEVPAGES=on; the manager phase's 202 constraints and
     REACTOR_PODS (1,200; ``--reactor-pods``) make_resources pods (every
     20th with an initContainer) through the controllers, pumped on the
     script's thread; a cold ``audit_once`` (the ledger's cold build) whose
     statuses equal a direct capped audit (a second TorchDriver, forced
     full sweeps: the legacy route) of the stored objects; then
     ``start()``, and 200 ``cluster.update``s in bursts of 1, 10 and 50
     that add or remove an initContainer of an image no
     K8sAllowedRepos constraint allows: each must bring its 67 appear or
     clear ledger events (one a K8sAllowedRepos constraint) within
     REACTOR_EVENT_S, and no other event may come (event-to-verdict
     latency p50/p99/max per burst size, updates/s); over that window
     K4, K3, K1 and K6 launched, one K1 (the devpaged route's full mask)
     for each K6, no K5 and no Triton compile, every recorded launch
     equal to its plain version; the touched pods' ledger verdicts equal
     an uncapped audit of them (TorchDriver(device="cpu")), the served
     capped results and a following ``audit_once``'s statuses equal the
     direct audit; one annotation update with ``watch_gap`` armed: a
     rung-2 resync that emits no event, back to live;
     /debug/violations over HTTP with the reactor live; ``stop()``; K4,
     K3, K1 and K6 timed at the window's own inputs
 13. worker — the engine worker split (``worker_phase``): (a) an
     in-process EngineWorker over TorchDriver on the card behind the
     Manager of ``parse_args([... "--engine-worker-url", url])``: the
     manager phase's 202 constraints, 50 namespaces and WORKER_PODS
     (2,000) pods through the controllers and the HTTP seam (objects/s);
     a cold (K1, K2, K3 recorded and held against plain), steady,
     churned (WORKER_CHURN pods: K4, K5, no full K1) and full=True
     audit_once (a forced
     full sweep in the worker), each with statuses equal to a direct
     capped audit; WORKER_REVIEWS (128) reviews POSTed from 8 threads,
     answers equal to the oracle process's; (b)
     ReplicaPool.spawn_workers(2) on the card: the card's used memory
     grown by a context a worker, each replica's capped audit and the
     pool's equal to the direct client's, and WORKER_REVIEWS reviews
     through a ValidationHandler over the pool at 1 and 2 replicas
     (reviews/s), answers equal to the oracle's; K1, K2, K3 timed at
     (a)'s cold inputs
 14. extdata — external data (``extdata_phase``), bench.py's
     external-data row at its full size: 2,000 make_mixed(Random(11))
     resources under the 48 library templates, pods' images drawn from
     256 keys (1 in 10 ``invalid``); a baseline without the external
     template (forced full sweeps, best of 3); with K8sExtSig and a
     FakeProvider (20 ms, Ignore, retries 0, TTL 600 s) a cold sweep
     after re-registering the provider (one batched round) and 3 warm
     sweeps (no round, no Triton compile), the warm overhead against the
     baseline printed, the ``external`` stanza with the reference's keys,
     K8sExtSig's violations exactly the invalid-image pods (computed from
     the provider's data, capped and uncapped); a provider served by
     http.server on 127.0.0.1: a cold sweep through the HTTP transport
     equal to the warm one, then the server stopped: Ignore completes
     with the breaker open, Fail counts one external_data_kind_failures
     and every other kind's results stand; 64 pod reviews through a
     ValidationHandler over a MicroBatcher with the prefetch hook: one
     batch, one provider round, answers equal to the per-review scalar
     answers; then K8sExtSig alone over 20,000 pods drawing from 4,096
     images: a cold and a warm sweep (the prefetch's seconds and keys),
     the same exact check; K1 and K2 timed at that warm sweep's
     recorded inputs, K3 at the library sweep's, each launch held
     against its plain version
 15. probe — ``client.probe.main([])`` on the card: every scenario
     passes on ``local`` and ``torch`` (rc 0); ``main(["--cost"])`` with
     GATEKEEPER_COST_PROBE_N=2000: rc 0, K1, K2 and K3 launched and held
     against their plain versions, the measured device_s printed
 16. reuse — reuse and what-if (``reuse_phase``), each part a bench row
     at its own size: (a) the cross-template dedup of forced full
     sweeps over the library and REUSE_ROWS (2,000) rows, on and off,
     compiling nothing (the delta warm compiles each rewritten
     program's K1 variant), then a churned full sweep that splices the
     shared columns; (b) footprint-driven selective reuse on and off
     over a full, a steady, an annotation-only and a mixed churned
     sweep (a replayed kind launches no K1 and no K2); (c) a shadow
     sweep of ``constraints[1:]`` beside the library over WHATIF_ROWS
     (10,000) rows against the single-set sweep and the standalone
     candidate, a snapshot replay and a recorded stream of 64 reviews
     replayed scalar and batched; (d) a PromotionController to deny
     over (c)'s store and graduate_fleet over 4 clusters against the
     loop oracle; (e) explain_pair on a violating, a passing and an
     unmatched pair against K1's bit; (f) ``probe.main`` with
     ``--policyset``, ``--whatif`` and ``--rollout``, rc 0.  K1 on the
     rewritten programs, K1 and K2 on the shadow sweep and K1b, K2b and
     K3b under graduate_fleet are held against their plain versions and
     timed at their recorded inputs
 17. the kernels JSON line, the card line, and the final JSON line.
Every phase but devpages and reactor sweeps with GATEKEEPER_PAGES=off:
they measure the legacy sweep and assert its launch counts, and the
port, like the reference, defaults to the paged route.
Any mismatch or exception exits nonzero before the final line.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import hashlib
import json
import math
import os
import random
import subprocess
import sys
import threading
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # non-tensor-core fp32 peak (ALU proxy)
TARGET = "admission.k8s.gatekeeper.sh"
CAP = 20                        # Gatekeeper's default audit cap
K2_LARGE_CAP = 65536            # past one shared-memory sort of K2
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


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device-only ms per call of ``fn``: ``iters`` calls captured in one
    CUDA graph and the graph replayed ``replays`` times between two
    events, so neither the wrappers' Python nor the launch calls are in
    the time.  A call that cannot be captured fails the run.  Every
    background warm thread is joined first (a capture fails if another
    thread launches while it runs)."""
    join_warms()
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
    del g
    return t0.elapsed_time(t1) / (iters * replays)


def join_warms() -> None:
    """Join every background warm thread of the process: the ingest
    warm's (``ingest-prewarm``), the delta warm's (``delta-warmup``) and
    the audit manager's (``audit-warmup``).  A driver keeps a warm's
    error for its next ``query_audit``, an audit manager for its next
    ``audit_once``."""
    for t in threading.enumerate():
        if t.name in ("ingest-prewarm", "delta-warmup", "audit-warmup"):
            t.join()


def ingest_warm_text(drv) -> str:
    """Join ``drv``'s ingest warm (raising its error) and describe it with
    its eager mirror."""
    mirror = drv.metrics.timer("mirror_materialize").total
    t0 = time.perf_counter()
    secs = drv.wait_ingest_warm()
    waited = time.perf_counter() - t0
    if secs is None:
        return f"eager mirror {mirror:.4f}s, no ingest warm"
    return (f"eager mirror {mirror:.4f}s, ingest warm of "
            f"{drv.ingest_warm.kinds} kinds {secs:.4f}s on its threads "
            f"(waited {waited:.4f}s)")


def warm_text(drv) -> str:
    """Join ``drv``'s delta warm-up (raising its error) and describe it."""
    secs = drv.wait_delta_warm()
    if secs is None:
        return "no delta warm-up"
    return f"delta warm-up of {drv.delta_warm.kinds} kinds {secs:.4f}s"


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


def k2_numbers(topk, viol, rank, k: int, iters: int = 20) -> dict:
    """K2 on ``viol`` [C, R] (K2b on [N, C, R], ``rank`` [N, R]) at cap
    ``k``: the wrapper per call (CUDA events, ``ms``) and device-only (a
    CUDA graph, ``device_ms``), its plain version per call, and
    ``torch.topk`` on the same scores timed both ways.  Bound: the mask
    once, the rank of every row that violates in some mask row, the
    packed output; 2 element operations a mask byte."""
    batched = viol.dim() == 3
    r_pad = viol.shape[-1]
    rows = viol.numel() // r_pad
    if batched:
        def run():
            return topk.topk_packed_batched(viol, rank, k)

        def plain():
            return topk.topk_packed_batched_plain(viol, rank, k)
        score = torch.where(viol, r_pad - rank[:, None, :], 0) \
            .reshape(rows, r_pad)
        rank_rows = int(viol.any(dim=1).sum())
    else:
        def run():
            return topk.topk_packed(viol, rank, k)

        def plain():
            return topk.topk_packed_plain(viol, rank, k)
        score = torch.where(viol, r_pad - rank[None, :], 0)
        rank_rows = int(viol.any(dim=0).sum())
    b, by = bound(rows * r_pad + 4 * rank_rows + 4 * rows * (1 + 2 * k),
                  2 * rows * r_pad)
    def lib():
        return torch.topk(score, k, dim=1)
    reps = max(1, iters // 4)
    return {"ms": cuda_ms(run, iters, min(3, iters)),
            "device_ms": graph_ms(run, iters, reps),
            "plain_ms": cuda_ms(plain, iters=3), "bound_ms": b,
            "bound_by": by, "library_ms": cuda_ms(lib, iters, min(3, iters)),
            "library_device_ms": graph_ms(lib, iters, reps)}


def k2_text(n: dict) -> str:
    return (f"{n['ms']:.4f} ms, device {n['device_ms']:.4f} (plain "
            f"{n['plain_ms']:.4f}, torch.topk {n['library_ms']:.4f}, device "
            f"{n['library_device_ms']:.4f}, bound {n['bound_ms']:.4f} "
            f"{n['bound_by']})")


def k2_random(topk, dev) -> None:
    """K2 on random masks, full and ragged, at caps 20 and 300 and at a
    cap past one shared-memory sort, against the plain version; then K2b
    at the fleet's [4, 128, 131072]; each timed by :func:`k2_numbers`.
    Uses only the wrappers' public names, so it also times an earlier
    kernel (``--k2-only`` from that tree)."""
    g = torch.Generator(device="cpu").manual_seed(7)
    times = {}
    for c_pad, r_pad, dens, caps in (
            (128, 131072, 0.3, (CAP, 300)), (128, 131072, 1e-4, (CAP, 300)),
            (4, 8, 0.5, (CAP, 300)), (4, 131072, 0.5, (K2_LARGE_CAP,))):
        viol = (torch.rand((c_pad, r_pad), generator=g) < dens).to(dev)
        rank = torch.randperm(r_pad, generator=g).to(torch.int32).to(dev)
        for k in caps:
            got = topk.topk_packed(viol, rank, k)
            want = topk.topk_packed_plain(viol, rank, k)
            if packed_err(got, want, k):
                fail(f"K2 mismatch at [{c_pad}, {r_pad}] density {dens} "
                     f"k {k}")
            if r_pad == 131072 and dens >= 0.3:
                # an earlier kernel took a pass over the row per 128
                # slots: few calls at the large cap
                times[(c_pad, k)] = k2_numbers(
                    topk, viol, rank, k, 20 if k < K2_LARGE_CAP else 3)
    print("phase K2 random: [128,131072] x2 densities and ragged [4,8] at "
          f"k {CAP} and 300, [4,131072] at k {K2_LARGE_CAP}, equal to "
          "plain; " + "; ".join(
              f"[{c}, 131072] k {k}: {k2_text(n)}"
              for (c, k), n in times.items()), flush=True)
    viol = (torch.rand((4, 128, 131072), generator=g) < 0.3).to(dev)
    rank = torch.stack([torch.randperm(131072, generator=g)
                        for _ in range(4)]).to(torch.int32).to(dev)
    got = topk.topk_packed_batched(viol, rank, CAP)
    want = topk.topk_packed_batched_plain(viol, rank, CAP)
    if max(packed_err(got[i], want[i], CAP) for i in range(4)):
        fail("batched K2 mismatch on random [4, 128, 131072]")
    print(f"phase K2b random: [4, 128, 131072] density 0.3 k {CAP}, equal "
          f"to plain; {k2_text(k2_numbers(topk, viol, rank, CAP))}",
          flush=True)


def kernel_fns(ir_eval, topk, dfa, scatter, devdelta, invjoin,
               residency) -> dict:
    """Each kernel's wrapper as (module, name): a wrapper counts on the
    function its module's name refers to at the time of the call."""
    return {"K1": (ir_eval, "eval_mask"), "K2": (topk, "topk_packed"),
            "K3": (dfa, "dfa_table"), "K4": (scatter, "scatter_rows"),
            "K4m": (scatter, "scatter_rows_many"),
            "K5": (ir_eval, "delta_mask"),
            "K1b": (ir_eval, "eval_mask_batched"),
            "K2b": (topk, "topk_packed_batched"),
            "K3b": (dfa, "dfa_table_batched"),
            "K6": (devdelta, "mask_delta"),
            "K7": (invjoin, "inv_join_mask"),
            "K8g": (residency, "page_gather"),
            "K8s": (residency, "page_scatter")}


def reset_counts(fns: dict) -> None:
    for mod, name in fns.values():
        getattr(mod, name).launches = 0
        getattr(mod, name).plain_calls = 0


def launch_counts(fns: dict) -> dict:
    return {k: getattr(mod, name).launches for k, (mod, name) in fns.items()}


def norm(results) -> list:
    return [(r.constraint["kind"], r.constraint["metadata"]["name"], r.msg,
             repr(r.metadata), r.enforcement_action,
             repr((r.resource or {}).get("metadata")))
            for r in results]


def dfa_inputs(arrays, nm: str) -> tuple:
    return (arrays[nm + ".trans"], arrays[nm + ".accept"],
            arrays["__strbytes__"], arrays["__strdfaok__"],
            arrays[nm + ".xv"], 3)


def k3_live(ins) -> tuple[int, float, int]:
    """Live bytes of the ok ids (columns prefix..j*, j* the last nonzero
    column): the most, the mean and the sum."""
    sb, ok, prefix = ins[2], ins[3], ins[5]
    nz = sb[..., prefix:] != 0
    col = torch.arange(1, nz.shape[-1] + 1, device=sb.device,
                       dtype=torch.int32)
    live = (nz * col).amax(-1)[ok] if nz.shape[-1] else \
        torch.zeros((int(ok.sum()),), dtype=torch.int32, device=sb.device)
    if not live.numel():
        return 0, 0.0, 0
    return int(live.max()), float(live.float().mean()), int(live.sum())


def k3_bound(ins) -> tuple[float, str]:
    """What these inputs need: each ok id's row read once (its end is
    known only from the whole row), the flags (``xv`` of the ids that
    are not ok), the output, the accept flags once, and of each table
    the columns its ok rows can reach: 0-127 when they hold only ASCII
    bytes, all 256 when one holds a byte of 128 or more; one table step
    a live byte plus at least the TERM step a scanned id."""
    trans, accept, sb, ok, prefix = ins[0], ins[1], ins[2], ins[3], ins[5]
    n_ok, n = int(ok.sum()), ok.numel()
    high = ((sb[..., prefix:] >= 128).any(-1) & ok).reshape(
        -1, sb.shape[-2]).any(-1)
    cols = int((128 + 128 * high.to(torch.int64)).sum())
    nbytes = n_ok * sb.shape[-1] + 2 * n + (n - n_ok) \
        + cols * trans.shape[-2] * trans.element_size() + accept.numel()
    return bound(nbytes, k3_live(ins)[2] + n_ok)


def k3_numbers(dfa, ins, batched: bool = False) -> dict:
    """K3 (or K3b) and its plain scan timed on ``ins``, with the bound."""
    fn = dfa.dfa_table_batched if batched else dfa.dfa_table
    plain = dfa.dfa_table_batched_plain if batched else dfa.dfa_table_plain
    b, by = k3_bound(ins)
    return {"ms": cuda_ms(lambda: fn(*ins)),
            "device_ms": graph_ms(lambda: fn(*ins)),
            "plain_ms": cuda_ms(lambda: plain(*ins), iters=5),
            "bound_ms": b, "bound_by": by, "library_ms": None}


def k3_text(dfa, ins, n: dict | None = None) -> str:
    """The inputs (shape, ok ids, states, the table's dtype), where the
    plan keeps the table (an earlier tree's wrapper has no plan), the
    live bytes, and the times in ``n``."""
    trans, sb, ok = ins[0], ins[2], ins[3]
    plan_for = getattr(dfa, "plan_for", None)
    if plan_for is None:
        where = "no plan (earlier kernel)"
    else:
        p = plan_for(trans, sb)
        where = (f"{p.branch} branch, stored {p.stored_width} B an entry, "
                 f"{p.ids} ids a block of {p.threads} threads, {p.blocks} "
                 f"blocks a table, rows in "
                 f"{'shared' if p.row_chunks else 'global'} memory")
    mx, mean, _ = k3_live(ins)
    text = (f"{list(sb.shape)} bytes, {int(ok.sum())} ok, S "
            f"{trans.shape[-2]} ({str(trans.dtype).split('.')[-1]}), "
            f"{where}, live bytes max {mx} mean {mean:.1f}")
    if n is not None:
        text += (f": {n['ms']:.4f} ms, device {n['device_ms']:.4f} (plain "
                 f"{n['plain_ms']:.4f}, bound {n['bound_ms']:.6f} "
                 f"{n['bound_by']})")
    return text


K3_PATTERNS = ("@sha256:[a-f0-9]{64}$", "^[0-9]+(\\.[0-9]+)?$",
               "(?i)(password|secret|token|apikey)", "a$", "x\\Z",
               "^(ab)*$")
K3_IMAGE_BYTES = b"abcdefghijklmnopqrstuvwxyz0123456789/:.-_@"


def k3_rows(rng, n_ids: int, width: int, prefix: int, alphabet: bytes):
    """(strbytes, ok, xv) numpy over every kind of row K3's design names:
    empty, W - 1 and W long, random-length and interior-zero rows,
    all-zero bucket rows (the last quarter; a few ok), not-ok rows
    holding bytes; ``prefix`` bytes of the encoded-string image first."""
    sb = np.zeros((n_ids, width), dtype=np.uint8)
    ok = np.zeros((n_ids,), dtype=bool)
    room = width - prefix
    alpha = np.frombuffer(alphabet, dtype=np.uint8)
    for u in range(n_ids):
        kind = u % 8
        if kind == 7 or u >= n_ids * 3 // 4:
            ok[u] = kind == 3
            continue
        n = {0: 0, 1: room - 1, 2: room}.get(kind, int(rng.integers(
            0, room + 1)))
        n = max(0, min(n, room))
        sb[u, :prefix] = np.frombuffer(b"\x00s:"[:prefix], dtype=np.uint8)
        sb[u, prefix:prefix + n] = rng.choice(alpha, size=n)
        if kind == 4 and n > 2:
            sb[u, prefix + rng.integers(0, n - 1, size=2)] = 0
        ok[u] = kind != 5
    return sb, ok, rng.random(n_ids) < 0.5


def k3_synthetic_dfa(rng, states: int, cycles: bool):
    """(trans int32 [S, 256], accept bool [S]): random transitions with
    z = trans[:, 0] made to reach a fixed point, or (``cycles``) made of
    2-cycles and a 3-cycle only, so that stopping a tail early would be
    wrong."""
    trans = rng.integers(0, states, size=(states, 256)).astype(np.int32)
    z = np.minimum(np.arange(states), rng.integers(0, states, states))
    if cycles and states >= 2:
        z = np.arange(states)
        n3 = 3 if states % 2 else 0
        z[0:states - n3:2] += 1
        z[1:states - n3:2] -= 1
        if n3:
            z[-3:] = [states - 2, states - 1, states - 3]
    trans[:, 0] = z
    return trans, rng.random(states) < 0.5


def k3_dfas(rng) -> list:
    """(name, trans int32, accept): the library's DFAs and synthetic ones
    from 1 to 1,024 states, across the stored widths and the
    shared-memory edge."""
    from gatekeeper_tpu_torch.ops import regex_dfa
    out = []
    for pat in K3_PATTERNS:
        d = regex_dfa.compile_dfa(pat)
        out.append((pat, d.trans.astype(np.int32), d.accept.copy()))
    for states in (1, 3, 7, 128, 256, 257, 450, 904, 905, 1024):
        for cycles in (False, True):
            out.append((f"S{states}{' cycles' if cycles else ''}",
                        *k3_synthetic_dfa(rng, states, cycles)))
    return out


def k3_shifted(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` one element past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype,
                      device=t.device)[1:].view(t.shape)
    out.copy_(t)
    return out


def k3_dtypes(trans) -> list:
    """The table dtypes the executor ships that hold ``trans``' states."""
    top = int(trans.max()) if trans.size else 0
    return [dt for dt, hi in ((torch.int8, 127), (torch.int16, 32767),
                              (torch.int32, 1 << 31)) if top <= hi]


K3_FULL_RUN_DFAS = (K3_PATTERNS[0], "S257 cycles", "S905")


def k3_random(dfa, dev, every: bool = True) -> str:
    """K3 and K3b against their plain versions, bit for bit, on the
    design's cases: every DFA of :func:`k3_dfas` at every table dtype that
    holds its states, rows 128 wide (prefix 3), 40 and 144 wide (prefix
    0 and 3), rows and table 16-byte aligned or an element off; K3b over
    1-4 clusters of ragged id counts, each cluster its own DFA.  Unless
    ``every``, only the DFAs of ``K3_FULL_RUN_DFAS`` (one a branch and
    stored width), rows 128 and 40 wide, and K3b over 1 and 4 clusters
    of 513 ids: the full run's share, the sweep being ``--k3-only``'s."""
    rng = np.random.default_rng(31)
    every_dfa = k3_dfas(rng)
    names = [d[0] for d in every_dfa]
    batched_dfas = [names.index(n) for n in (K3_PATTERNS[0], "S1",
                                             "S1024 cycles")]
    dfas = [d for d in every_dfa if every or d[0] in K3_FULL_RUN_DFAS]
    seen, n_cases = set(), 0

    def check(ins, what, batched=False):
        nonlocal n_cases
        fn = dfa.dfa_table_batched if batched else dfa.dfa_table
        plain = dfa.dfa_table_batched_plain if batched \
            else dfa.dfa_table_plain
        got = fn(*ins)
        torch.cuda.synchronize()
        if not torch.equal(got, plain(*ins)):
            fail(f"K3{'b' if batched else ''} mismatch on {what}")
        plan_for = getattr(dfa, "plan_for", None)
        if plan_for is not None:
            p = plan_for(ins[0], ins[2])
            seen.add((p.branch, p.stored_width, ins[0].dtype))
        n_cases += 1

    for name, tr, ac in dfas:
        for width, prefix in ((128, 3), (40, 0), (144, 3))[:3 if every
                                                           else 2]:
            sb, ok, xv = k3_rows(rng, 96, width, prefix,
                                 K3_IMAGE_BYTES if name in K3_PATTERNS
                                 else bytes(range(1, 256)))
            a, s, o, x = (torch.from_numpy(v).to(dev)
                          for v in (ac, sb, ok, xv))
            for dt in k3_dtypes(tr):
                t = torch.from_numpy(tr).to(dt).to(dev)
                for rows, table in ((s, t), (k3_shifted(s), t),
                                    (s, k3_shifted(t))):
                    check((table, a, rows, o, x, prefix),
                          f"{name} {dt} [{width}] prefix {prefix}")
    for n_b in (1, 2, 3, 4) if every else (1, 4):
        for n_ids in (1, 513, 4097) if every else (513,):
            for k in batched_dfas:             # 75, 1 and 1,024 states
                sel = [every_dfa[(k + i) % len(every_dfa)]
                       for i in range(n_b)]
                top = max(d[1].shape[0] for d in sel)
                tr = np.zeros((n_b, top, 256), dtype=np.int32)
                ac = np.zeros((n_b, top), dtype=bool)
                for i, (_n, t1, a1) in enumerate(sel):
                    tr[i, : t1.shape[0]] = t1
                    ac[i, : t1.shape[0]] = a1
                rows = [k3_rows(rng, n_ids, 128, 3, K3_IMAGE_BYTES)
                        for _ in range(n_b)]
                ins = tuple(torch.from_numpy(np.stack([r[j] for r in rows]))
                            .to(dev) for j in range(3))
                for dt in k3_dtypes(tr):
                    t = torch.from_numpy(tr).to(dt).to(dev)
                    check((t, torch.from_numpy(ac).to(dev)) + ins + (3,),
                          f"{n_b} clusters of {n_ids} ids, {top} states "
                          f"{dt}", batched=True)
    kinds = sorted({(b, w, str(dt).split(".")[-1]) for b, w, dt in seen})
    return f"equal to plain on {n_cases} cases; (branch, stored width, " \
        f"shipped dtype) seen: {kinds}"


def k3_large(dev, n_rows: int = 262144, n_strings: int = 150000,
             seed: int = 8) -> tuple:
    """A synthetic large string table under the K8sImageDigests DFA:
    ``n_strings`` random image-like ASCII strings of 8-100 bytes (every
    sixteenth ends in a valid ``@sha256:`` digest) in a ``n_rows``
    bucket whose other rows are zero and not ok."""
    from gatekeeper_tpu_torch.ops import regex_dfa
    rng = np.random.default_rng(seed)
    d = regex_dfa.compile_dfa(K3_PATTERNS[0])
    width = 128
    alpha = np.frombuffer(K3_IMAGE_BYTES[:-1], dtype=np.uint8)
    lens = rng.integers(8, 101, size=n_strings)
    body = rng.choice(alpha, size=(n_strings, width - 3))
    body[np.arange(width - 3)[None, :] >= lens[:, None]] = 0
    hexd = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)
    dig = np.frombuffer(b"@sha256:", dtype=np.uint8)
    for u in range(0, n_strings, 16):
        n = int(lens[u])
        body[u, :n] = 0
        stem = max(0, n - 72)
        body[u, :stem] = rng.choice(alpha, size=stem)
        body[u, stem:stem + 8] = dig
        body[u, stem + 8:stem + 72] = rng.choice(hexd, size=64)
    sb = np.zeros((n_rows, width), dtype=np.uint8)
    sb[:n_strings, :3] = np.frombuffer(b"\x00s:", dtype=np.uint8)
    sb[:n_strings, 3:] = body
    ok = np.zeros((n_rows,), dtype=bool)
    ok[:n_strings] = True
    xv = rng.random(n_rows) < 0.5
    return tuple(torch.from_numpy(v).to(dev) for v in (
        d.trans.astype(np.int32), d.accept, sb, ok, xv)) + (3,)


def k3_path_inputs(dfa, resources: int) -> dict:
    """The path's K3 and K3b inputs, built on the host by
    ``TorchDriver(device="cpu")`` (the same host preparation as the
    card's drivers, no kernel compiles): the store's table
    (K8sImageDigests over ``resources`` north-star pods), the library's
    (49 templates over the library rows) and the library fleet's stacked
    table (4 clusters of 2,500 rows through ``fleet_audit``).  The
    wrappers are wrapped by name to record their CPU inputs."""
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.client.interface import QueryOpts
    from gatekeeper_tpu_torch.engine import torch_driver
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.library import all_docs, make_mixed
    from gatekeeper_tpu_torch.library.north_star import make_resources
    from gatekeeper_tpu_torch.library.templates import (LIBRARY,
                                                        constraint_doc,
                                                        template_doc)
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
    from gatekeeper_tpu_torch.whatif import fleet_audit, make_cluster
    saved = torch_driver.SMALL_WORKLOAD_EVALS, dfa.dfa_table, \
        dfa.dfa_table_batched
    torch_driver.SMALL_WORKLOAD_EVALS = 0
    got = {"store": [], "library": [], "fleet": []}
    opts = QueryOpts(limit_per_constraint=CAP)
    try:
        for key in got:
            dfa.dfa_table = recording(saved[1], got[key])
            dfa.dfa_table_batched = recording(saved[2], got[key])
            if key == "fleet":
                docs = all_docs()
                fleet_audit([make_cluster(
                    f"lib{i}", [t for t, _ in docs], [c for _, c in docs],
                    objs=make_mixed(random.Random(100 + i),
                                    FLEET_LIBRARY_ROWS),
                    driver_factory=lambda: TorchDriver(device="cpu"))
                    for i in range(4)], CAP)
                continue
            drv = TorchDriver(device="cpu")
            cl = Backend(drv).new_client([K8sValidationTarget()])
            if key == "store":
                rego, params = LIBRARY["K8sImageDigests"]
                cl.add_template(template_doc("K8sImageDigests", rego))
                cl.add_constraint(constraint_doc("K8sImageDigests",
                                                 "digests", params))
                cl.add_data_batch(make_resources(resources,
                                                 random.Random(1)))
            else:
                for t, con in all_docs():
                    cl.add_template(t)
                    cl.add_constraint(con)
                cl.add_data_batch(make_mixed(random.Random(0),
                                             LIBRARY_ROWS))
            drv.query_audit(TARGET, opts)
    finally:
        torch_driver.SMALL_WORKLOAD_EVALS, dfa.dfa_table, \
            dfa.dfa_table_batched = saved
    out = {}
    for key, calls in got.items():
        if not calls:
            fail(f"the {key} sweep ran no regex table")
        out[key] = calls[-1][0]
    return out


def k3_only(dfa, dev, resources: int) -> None:
    """``--k3-only``: K3 and K3b against their plain versions on the
    design's cases, then each checked and timed per call and device-only
    at the store's, the library's and the library fleet's tables and at
    a synthetic [262144, 128] table, through the public ``dfa_table``
    and ``dfa_table_batched`` alone (so a copy of this script beside an
    earlier tree times that tree's kernel)."""
    print(f"phase K3 random: {k3_random(dfa, dev)}", flush=True)
    path = k3_path_inputs(dfa, resources)
    path["large"] = k3_large(dev)
    for key in ("store", "library", "fleet", "large"):
        ins = tuple(x.to(dev) if torch.is_tensor(x) else x
                    for x in path[key])
        batched = ins[2].dim() == 3
        fn = dfa.dfa_table_batched if batched else dfa.dfa_table
        plain = dfa.dfa_table_batched_plain if batched \
            else dfa.dfa_table_plain
        if not torch.equal(fn(*ins), plain(*ins)):
            fail(f"K3{'b' if batched else ''} mismatch on the {key} table")
        print(f"phase K3 {key}: K3{'b' if batched else ''} equal to plain; "
              f"{k3_text(dfa, ins, k3_numbers(dfa, ins, batched))}",
              flush=True)


def recording(fn, store: list):
    """``fn`` that also keeps each call's arguments and result; while it
    stands in for ``fn`` under the module's name, ``fn`` counts on it."""
    def rec_fn(*args):
        out = fn(*args)
        store.append((args, out))
        return out
    rec_fn.launches = rec_fn.plain_calls = 0
    return rec_fn


def max_err(got, want) -> float:
    return float((got.to(torch.float64) - want.to(torch.float64))
                 .abs().max()) if got.numel() else 0.0


def k4_bytes(dev_t, rows, vals) -> int:
    """K4's bound bytes for one job: the column read and the new column
    written once (the copy), the values and the int32 rows read once."""
    return 2 * dev_t.numel() * dev_t.element_size() \
        + vals.numel() * vals.element_size() + 4 * rows.numel()


def k4_numbers(scatter, calls) -> dict:
    """The single K4 entry, its plain version (index_copy_ on a clone)
    and one ``torch.index_copy`` timed on each job (mean): per call with
    CUDA events (``ms``, ``plain_ms``, ``library_ms``) and device-only
    from a CUDA graph (``device_ms``, ``library_device_ms``), with the
    bound (:func:`k4_bytes`)."""
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms",
            "library_device_ms")
    out = dict.fromkeys(keys, 0.0)
    for dev_t, rows, vals, axis in calls:
        idx = rows.to(torch.int64)
        out["bound_ms"] += bound(k4_bytes(dev_t, rows, vals), 0)[0]
        out["ms"] += cuda_ms(lambda: scatter.scatter_rows(dev_t, rows, vals,
                                                          axis))
        out["plain_ms"] += cuda_ms(lambda: scatter.scatter_rows_plain(
            dev_t, rows, vals, axis))
        out["library_ms"] += cuda_ms(lambda: torch.index_copy(
            dev_t, axis, idx, vals))
        out["device_ms"] += graph_ms(lambda: scatter.scatter_rows(
            dev_t, rows, vals, axis))
        out["library_device_ms"] += graph_ms(lambda: torch.index_copy(
            dev_t, axis, idx, vals))
    out = {k: v / len(calls) for k, v in out.items()}
    out["bound_by"] = "bytes"
    return out


def k4m_numbers(scatter, batches) -> dict:
    """The batched K4 entry on each recorded batch of jobs (mean over the
    batches): the call, its plain version and the yardstick, one
    ``torch.index_copy`` per job, timed per call and device-only as in
    :func:`k4_numbers`; the bound sums the jobs'."""
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms",
            "library_device_ms")
    out = dict.fromkeys(keys, 0.0)
    for jobs in batches:
        idx = [rows.to(torch.int64) for _d, rows, _v, _a in jobs]

        def library():
            for (dev_t, _r, vals, axis), i in zip(jobs, idx):
                torch.index_copy(dev_t, axis, i, vals)

        out["bound_ms"] += bound(sum(k4_bytes(d, r, v)
                                     for d, r, v, _a in jobs), 0)[0]
        out["ms"] += cuda_ms(lambda: scatter.scatter_rows_many(jobs))
        out["plain_ms"] += cuda_ms(lambda: scatter.scatter_rows_many_plain(
            jobs))
        out["library_ms"] += cuda_ms(library)
        out["device_ms"] += graph_ms(lambda: scatter.scatter_rows_many(jobs))
        out["library_device_ms"] += graph_ms(library)
    out = {k: v / len(batches) for k, v in out.items()}
    out["bound_by"] = "bytes"
    return out


class K4Calls:
    """Keeps every K4 call made while installed, through either entry
    (each entry stands in as :func:`recording` under its module's name,
    so the launch counts go to the stand-ins): ``check`` holds every
    recorded job's result against the plain version, bit for bit, and
    forgets them; ``restore`` puts the entries back."""

    def __init__(self, scatter):
        self.scatter = scatter
        self.orig = (scatter.scatter_rows, scatter.scatter_rows_many)
        self.single: list = []
        self.many: list = []

    def install(self) -> None:
        self.scatter.scatter_rows = recording(self.orig[0], self.single)
        self.scatter.scatter_rows_many = recording(self.orig[1], self.many)

    def restore(self) -> None:
        self.scatter.scatter_rows, self.scatter.scatter_rows_many = self.orig

    def jobs(self) -> list:
        """(job args, result) of every recorded job, single or batched."""
        out = list(self.single)
        for (jobs,), outs in self.many:
            out += list(zip(jobs, outs))
        return out

    def finish(self, what: str, rec: dict) -> int:
        """Restore the entries, check the recorded jobs and fold their
        max_abs_err into ``rec["K4"]``; returns the jobs checked."""
        self.restore()
        n, err = self.check(what)
        rec["K4"]["max_abs_err"] = max(rec["K4"]["max_abs_err"], err)
        return n

    def check(self, what: str) -> tuple[int, float]:
        """(jobs checked, max_abs_err); forgets the calls after."""
        err = 0.0
        done = self.jobs()
        for (col, rows, vals, axis), got in done:
            want = self.scatter.scatter_rows_plain(col, rows, vals, axis)
            if got.dtype != want.dtype or not torch.equal(got, want):
                fail(f"K4 mismatch in {what}: {list(col.shape)} "
                     f"{col.dtype} axis {axis}, {rows.numel()} rows")
            err = max(err, max_err(got, want))
        self.single.clear()
        self.many.clear()
        return len(done), err


def k5_numbers(ex, ir_eval, calls) -> dict:
    """K5 and its plain version timed on each call (mean), K5 also
    device-only (a CUDA graph) beside the device time of its copy of
    the stored mask alone (``clone_device_ms``), with the bound: the
    stored mask read and the new mask written once, each array the
    program reads once (an r-axis array only at the distinct dirty
    rows), the rows once; K1's element operations for the distinct
    dirty rows."""
    out = dict.fromkeys(("ms", "device_ms", "clone_device_ms", "plain_ms",
                         "bound_ms"), 0.0)
    by = "bytes"
    for prog, d, viol_old, rows in calls:
        c_pad, r_pad = viol_old.shape
        n_dirty = int(torch.unique(rows).numel())
        used = ir_eval.emit_source(prog, ir_eval.array_signature(d))[1].ptrs
        nbytes = 2 * c_pad * r_pad + 4 * rows.numel()
        for nm in used:
            size = d[nm].numel() * d[nm].element_size()
            nbytes += size if ex._r_axis(nm) is None \
                else size * n_dirty // r_pad
        ops = k1_element_ops(ex, prog, d) * n_dirty / r_pad
        b, by = bound(nbytes, ops)
        out["bound_ms"] += b
        out["ms"] += cuda_ms(lambda: ir_eval.delta_mask(prog, d, viol_old,
                                                        rows))
        out["device_ms"] += graph_ms(lambda: ir_eval.delta_mask(
            prog, d, viol_old, rows))
        out["clone_device_ms"] += graph_ms(viol_old.clone)
        out["plain_ms"] += cuda_ms(lambda: ex._delta_mask(prog, d, viol_old,
                                                          rows), iters=5)
    out = {k: v / len(calls) for k, v in out.items()}
    out.update(bound_by=by, library_ms=None)
    return out


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


def k1_bound_of(ex, ir_eval, program, d,
                lead: int = 0) -> tuple[float, str]:
    """K1's (or with ``lead`` 1, batched K1's) bound over the arrays
    ``d``: each array the program reads once and the [C_pad, R_pad]
    mask of every cluster written once; K1's element operations summed
    over the clusters."""
    used = ir_eval.emit_source(program, ir_eval.array_signature(
        d, lead))[1].ptrs
    n_b = d["__alive__"].shape[0] if lead else 1
    c, r = d["__cvalid__"].shape[lead], d["__alive__"].shape[lead]
    nbytes = sum(d[nm].numel() * d[nm].element_size() for nm in used) \
        + n_b * c * r
    if lead:
        ops = sum(k1_element_ops(ex, program, {nm: a[i] for nm, a
                                               in d.items()})
                  for i in range(n_b))
    else:
        ops = k1_element_ops(ex, program, d)
    return bound(nbytes, ops)


def k1_times(run, plain, iters: int = 20) -> dict:
    """A K1-family wrapper per call (CUDA events) and device-only (a
    CUDA graph), and its plain version per call."""
    return {"ms": cuda_ms(run, iters), "device_ms": graph_ms(run, iters),
            "plain_ms": cuda_ms(plain, iters=3, warmup=1)}


def k1_family(ex, ir_eval, calls) -> dict:
    """K1 per call and device-only and its plain version, mean over the
    distinct programs of ``calls`` (recorded ``((program, d), out)``),
    with the bound."""
    t = collections.Counter()
    by, seen = "bytes", {}
    for (program, d), _out in calls:
        seen.setdefault(id(program), (program, d))
    for program, d in seen.values():
        bms, by = k1_bound_of(ex, ir_eval, program, d)
        t["bound_ms"] += bms / len(seen)
        for key, v in k1_times(lambda: ir_eval.eval_mask(program, d),
                               lambda: ex._eval_mask(program, d)).items():
            t[key] += v / len(seen)
    return {**t, "bound_by": by, "library_ms": None}


def k1_text(n: dict) -> str:
    return (f"{n['ms']:.4f} ms, device {n['device_ms']:.4f} (plain "
            f"{n['plain_ms']:.4f}, bound {n['bound_ms']:.4f} "
            f"{n['bound_by']})")


def k1_random(ir_eval, dfa, ex, dev, resources: int) -> None:
    """K1, K1b and K5 against their plain versions and timed (per call
    and device-only) on every-op programs at the path's shapes — K1 and
    K5 at the north star's [128, 131072] (K5 on the 1,024 rows of a 1%
    churn), K1b at fleet (a)'s [4, 128, 131072] and fleet (b)'s
    [4, 4, 4096] with ragged clusters — and on the north-star kinds over
    ``resources`` pods (K1b on 4 stacked copies).  Uses only the
    wrappers' public names and ``emit_source``, so it also times an
    earlier kernel (``--k1-only`` from that tree)."""
    from gatekeeper_tpu_torch import convert
    from gatekeeper_tpu_torch.client.interface import QueryOpts
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.kernels.op_cases import (every_op_case,
                                                       stacked_every_op_case)
    from gatekeeper_tpu_torch.library.north_star import (make_resources,
                                                         setup_north_star)

    rng = np.random.default_rng(21)

    def k1_case(what, prog, d, want):
        got = ir_eval.eval_mask(prog, d)
        if not torch.equal(got, want):
            fail(f"K1 mismatch on {what}")
        n = k1_times(lambda: ir_eval.eval_mask(prog, d),
                     lambda: ex._eval_mask(prog, d))
        n["bound_ms"], n["bound_by"] = k1_bound_of(ex, ir_eval, prog, d)
        return n

    def k5_case(what, prog, d, viol_old):
        dirty = np.sort(rng.choice(min(100_000, viol_old.shape[1]),
                                   size=1000, replace=False))
        rows = torch.from_numpy(ex.pad_rows(dirty).astype(np.int32)).to(dev)
        if not torch.equal(ir_eval.delta_mask(prog, d, viol_old, rows),
                           ex._delta_mask(prog, d, viol_old, rows)):
            fail(f"K5 mismatch on {what}")
        return k5_numbers(ex, ir_eval, [(prog, d, viol_old, rows)])

    def k1b_case(what, prog, d):
        got = ir_eval.eval_mask_batched(prog, d)
        if not torch.equal(got, ex._eval_mask_batched(prog, d)):
            fail(f"batched K1 mismatch on {what}")
        n = k1_times(lambda: ir_eval.eval_mask_batched(prog, d),
                     lambda: ex._eval_mask_batched(prog, d))
        n["bound_ms"], n["bound_by"] = k1_bound_of(ex, ir_eval, prog, d, 1)
        return n

    def stacked_case(n_b, **kw):
        prog, stacked = stacked_every_op_case(n_b, **kw)
        d = {nm: torch.from_numpy(a).to(dev) for nm, a in stacked.items()}
        d["dfa0.devtab"] = dfa.dfa_table_batched(
            d["dfa0.trans"], d["dfa0.accept"], d["__strbytes__"],
            d["__strdfaok__"], d["dfa0.xv"], 3)
        return prog, d

    prog, host = every_op_case(0, c_pad=128, r_pad=131072, e_pad=4,
                               t_pad=1024, u=32)
    d = ex._with_dfa_tables(prog, convert.arrays_to_device(host, dev),
                            dfa.dfa_table)
    want = ex._eval_mask(prog, d)
    k1 = k1_case("the every-op case at [128, 131072]", prog, d, want)
    k5 = k5_case("the every-op case at [128, 131072]", prog, d, want)
    k1a = k1b_case("every-op clusters at [4, 128, 131072]",
                   *stacked_case(4, c_pad=128, r_pad=32768, t_pad=1024,
                                 u=32))
    k1l = k1b_case("every-op clusters at [4, 4, 4096]",
                   *stacked_case(4, c_pad=4, r_pad=1024))
    del d, want
    print(f"phase K1 random: every-op programs, equal to plain; K1 at "
          f"[128, 131072] {k1_text(k1)}; K5 at 1,024 rows of [128, 131072] "
          f"{k1_text(k5)}, of it the mask copy device "
          f"{k5['clone_device_ms']:.4f}; K1b at [4, 128, 131072] "
          f"{k1_text(k1a)}; K1b at [4, 4, 4096] {k1_text(k1l)}", flush=True)

    t0 = time.perf_counter()
    drv = TorchDriver()
    setup_north_star(drv, make_resources(resources, random.Random(1)),
                     random.Random(2))
    drv.query_audit(TARGET, QueryOpts(limit_per_constraint=CAP))
    build_s = time.perf_counter() - t0
    st = drv._state(TARGET)
    acc = collections.defaultdict(collections.Counter)
    by_kind = collections.defaultdict(dict)
    kinds = sorted(st.bindings_cache)
    for kind in kinds:
        prog = st.templates[kind].vectorized.program
        d = drv.executor._arrays(st.bindings_cache[kind][1], None)
        want = ex._eval_mask(prog, d)
        stacked = {nm: torch.stack([a] * 4) for nm, a in d.items()}
        for key, n in (("K1", k1_case(kind, prog, d, want)),
                       ("K5", k5_case(kind, prog, d, want)),
                       ("K1b", k1b_case(kind + " x 4", prog, stacked))):
            n.pop("bound_by")
            n.pop("library_ms", None)
            acc[key].update({k: v / len(kinds) for k, v in n.items()})
            by_kind[key][kind] = round(n["device_ms"], 4)
        del stacked
    print(f"phase K1 north star: {resources} pods (store {build_s:.1f}s), "
          f"mean over {kinds}, equal to plain; " + "; ".join(
              f"{key} {n['ms']:.4f} ms, device {n['device_ms']:.4f} (plain "
              f"{n['plain_ms']:.4f}, bound {n['bound_ms']:.4f}"
              + (f", mask copy device {n['clone_device_ms']:.4f}"
                 if key == "K5" else "") + ")"
              for key, n in acc.items())
          + f"; device ms by kind {dict(by_kind)}", flush=True)


def triton_variants(ir_eval) -> int | None:
    """Compiled Triton variants over every K1 kernel of this process
    (one per program and specialisation; None where this Triton keeps
    its cache elsewhere).  A batched launch that recompiles a program
    already launched unbatched shows here."""
    n = 0
    for kern, *_ in list(ir_eval._KERNELS.values()):
        caches = getattr(kern, "device_caches", None)
        if caches is not None:
            n += sum(len(c[0]) for c in caches.values())
        elif isinstance(getattr(kern, "cache", None), dict):
            n += sum(len(c) for c in kern.cache.values())
        else:
            return None
    return n


def fleet_twice(clusters, fns, fleet_audit, ir_eval) -> dict:
    """fleet_audit warm (recording each stacked kind's inputs), then
    timed, with the launch counts set to 0 just before it and read just
    after; the timed run's seconds inside run_topk_batched (uploads, the
    batched kernels, the fetch of the top-k) are summed, and the Triton
    variant count is read before, between and after."""
    exe = clusters[0].driver.executor
    orig = exe.run_topk_batched
    inputs, spent = {}, []

    def warm_run(program, stacked, k):
        inputs[id(program)] = (program, stacked)
        return orig(program, stacked, k)

    def timed_run(program, stacked, k):
        t = time.perf_counter()
        out = orig(program, stacked, k)
        spent.append(time.perf_counter() - t)
        return out

    out = {"exe": exe, "inputs": inputs,
           "variants": [triton_variants(ir_eval)]}
    exe.run_topk_batched = warm_run
    t0 = time.perf_counter()
    out["warm"] = fleet_audit(clusters, CAP)
    out["warm_s"] = time.perf_counter() - t0
    out["variants"].append(triton_variants(ir_eval))
    exe.run_topk_batched = timed_run
    widen0 = exe.batched_mask_evals
    reset_counts(fns)
    t0 = time.perf_counter()
    out["rep"] = fleet_audit(clusters, CAP)
    out["stacked_s"] = time.perf_counter() - t0
    out["counts"] = launch_counts(fns)
    out["widen"] = exe.batched_mask_evals - widen0
    del exe.run_topk_batched
    out["variants"].append(triton_variants(ir_eval))
    out["batched_s"] = sum(spent)
    if None not in out["variants"] and \
            out["variants"][2] != out["variants"][1]:
        fail(f"the timed fleet audit compiled new K1 variants: Triton "
             f"variants {out['variants']} (before, after warm, after "
             f"timed)")
    return out


FLEET_SIZES = (100_000, 90_000, 80_000, 60_000)
FLEET_LIBRARY_ROWS = 2500


def fleet_phase(rec: dict, fns: dict, dev) -> None:
    """The fleet audit (item B9): (a) 4 north-star clusters of
    FLEET_SIZES pods, 201 constraints each, and (b) 4 library clusters
    of FLEET_LIBRARY_ROWS make_mixed rows under every library template;
    each audited by fleet_audit twice (warm, then timed) and by
    fleet_loop_oracle, digests held equal, the batched kernels held
    against their plain versions and timed at (a)'s shapes."""
    from gatekeeper_tpu_torch.client.interface import QueryOpts
    from gatekeeper_tpu_torch.engine import executor as ex
    from gatekeeper_tpu_torch.engine import torch_driver
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.kernels import dfa, ir_eval, topk
    from gatekeeper_tpu_torch.kernels.op_cases import stacked_every_op_case
    from gatekeeper_tpu_torch.library import all_docs, make_mixed
    from gatekeeper_tpu_torch.library.north_star import (make_resources,
                                                         setup_north_star)
    from gatekeeper_tpu_torch.whatif import (fleet_audit, fleet_loop_oracle,
                                             make_cluster, normalize_results)
    from gatekeeper_tpu_torch.whatif.fleet import FleetCluster

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()

    # -- batched kernels on random stacked inputs: N 1..5, ragged sizes,
    # every IR op
    for n, kw in ((1, {}), (2, {"c_pad": 16, "r_pad": 256}),
                  (3, {"c_pad": 128, "r_pad": 4096, "t_pad": 1024,
                       "u": 32}),
                  (4, {"c_pad": 8, "r_pad": 64, "n_states": 60}),
                  (5, {"c_pad": 32, "r_pad": 512, "t_pad": 64})):
        prog, stacked = stacked_every_op_case(n, **kw)
        d = {nm: torch.from_numpy(a).to(dev) for nm, a in stacked.items()}
        ins = (d["dfa0.trans"], d["dfa0.accept"], d["__strbytes__"],
               d["__strdfaok__"], d["dfa0.xv"], 3)
        tab = dfa.dfa_table_batched(*ins)
        if not torch.equal(tab, dfa.dfa_table_batched_plain(*ins)):
            fail(f"batched K3 mismatch on {n} every-op clusters {kw}")
        d["dfa0.devtab"] = tab
        mask = ir_eval.eval_mask_batched(prog, d)
        if not torch.equal(mask, ex._eval_mask_batched(prog, d)):
            fail(f"batched K1 mismatch on {n} every-op clusters {kw}")
        for k in (CAP, 2):
            got = topk.topk_packed_batched(mask, d["__rank__"], k)
            want = topk.topk_packed_batched_plain(mask, d["__rank__"], k)
            if max(packed_err(got[i], want[i], k) for i in range(n)):
                fail(f"batched K2 mismatch on {n} every-op clusters k {k}")
    g = torch.Generator(device="cpu").manual_seed(9)
    for n, dens in ((4, 0.3), (4, 1e-4), (5, 0.5)):
        viol = (torch.rand((n, 128, 16384), generator=g) < dens).to(dev)
        rank = torch.stack([torch.randperm(16384, generator=g)
                            for _ in range(n)]).to(torch.int32).to(dev)
        for k in (CAP, 300):
            got = topk.topk_packed_batched(viol, rank, k)
            want = topk.topk_packed_batched_plain(viol, rank, k)
            if max(packed_err(got[i], want[i], k) for i in range(n)):
                fail(f"batched K2 mismatch on random [{n}, 128, 16384] "
                     f"density {dens} k {k}")
    print("phase fleet kernels random: batched K1 and K3 equal their plain "
          "versions on 5 stacked every-op cases (N 1-5, ragged R_pad, T, U "
          "and DFA states); batched K2 at caps 20, 2 and 300 on those and on "
          "random [N, 128, 16384] masks", flush=True)
    del d, tab, mask, got, want, viol, rank

    # -- (a) the north-star fleet
    v_build = triton_variants(ir_eval)
    t0 = time.perf_counter()
    clusters, res60 = [], None
    for i, n in enumerate(FLEET_SIZES):
        res = make_resources(n, random.Random(100 + i))
        drv = TorchDriver()
        client = setup_north_star(drv, res, random.Random(2))
        clusters.append(FleetCluster(name=f"ns{i}", client=client,
                                     driver=drv, handler=drv.targets[TARGET]))
        if n == FLEET_SIZES[-1]:
            res60 = res
    build_s = time.perf_counter() - t0
    # each cluster's ingest (past MIRROR_EAGER_MIN_ROWS) built its kinds'
    # bindings and warmed their full K1 variants, which the stacked sweep
    # does not launch: their cost, waited for before the timed region
    t0 = time.perf_counter()
    warms = [c.driver.wait_ingest_warm() for c in clusters]
    warm_wait_s = time.perf_counter() - t0
    mirrors = [c.driver.metrics.timer("mirror_materialize").total
               for c in clusters]
    print(f"phase fleet north star ingest warm: eager mirrors "
          f"{[round(x, 4) for x in mirrors]}s (in the build's "
          f"{build_s:.3f}s), ingest warms "
          f"{[None if x is None else round(x, 4) for x in warms]}s on their "
          f"threads, waited {warm_wait_s:.4f}s after the build; Triton "
          f"variants {v_build} -> {triton_variants(ir_eval)} (full variants "
          f"the stacked sweep does not launch)", flush=True)
    fa = fleet_twice(clusters, fns, fleet_audit, ir_eval)
    warm, rep, counts_a, widen_a = fa["warm"], fa["rep"], fa["counts"], \
        fa["widen"]
    exe, inputs = fa["exe"], fa["inputs"]
    _v, loop_digests, loop_s = fleet_loop_oracle(clusters, CAP)
    for cl in clusters:
        cl.driver.wait_delta_warm()
    n_stacked = len(rep.kinds_stacked)
    if rep.digests != warm.digests or rep.digests != loop_digests:
        fail(f"north-star fleet digests {rep.digests}, warm {warm.digests}, "
             f"loop oracle {loop_digests}")
    if rep.kinds_stacked != ["K8sAllowedRepos", "K8sContainerLimits",
                             "K8sRequiredLabels"] or rep.kinds_replicated:
        fail(f"north-star fleet stacked {rep.kinds_stacked}, replicated "
             f"{rep.kinds_replicated}")
    if rep.device_dispatches != n_stacked or widen_a \
            or counts_a["K1b"] != n_stacked \
            or counts_a["K2b"] != n_stacked or counts_a["K3b"] != 0 \
            or counts_a["K1"] or counts_a["K2"]:
        fail(f"north-star fleet: {rep.device_dispatches} dispatches, "
             f"{widen_a} widening masks, launches {counts_a}")
    torch.cuda.synchronize()
    peak_a = torch.cuda.max_memory_allocated()
    print(f"phase fleet north star: {len(clusters)} clusters of "
          f"{list(FLEET_SIZES)} pods x 201 constraints, cap {CAP}: build "
          f"{build_s:.3f}s; stacked warm {fa['warm_s']:.4f}s, stacked "
          f"{fa['stacked_s']:.4f}s (of it {fa['batched_s']:.4f}s in "
          f"run_topk_batched: uploads, batched kernels, fetch) vs loop "
          f"oracle {loop_s:.4f}s; digests "
          f"{rep.digests} equal the loop oracle's; stacked "
          f"{rep.kinds_stacked}, replicated {rep.kinds_replicated}; "
          f"{rep.device_dispatches} dispatches; launches "
          f"{ {k: v for k, v in counts_a.items() if v} }; Triton variants "
          f"{' -> '.join(map(str, fa['variants']))} (before, after warm, "
          f"after timed); "
          f"max_memory_allocated {peak_a} (phase start {mem0})",
          flush=True)

    # the 60k cluster on the CPU path
    t0 = time.perf_counter()
    cpu = TorchDriver(device="cpu")
    setup_north_star(cpu, res60, random.Random(2))
    cpu_v = normalize_results(cpu.query_audit(
        TARGET, QueryOpts(limit_per_constraint=CAP))[0])
    if cpu_v != rep.verdicts[-1]:
        fail("north-star fleet: the 60k cluster differs from "
             "TorchDriver(device='cpu')")
    print(f"phase fleet north star check: the {FLEET_SIZES[-1]}-pod "
          f"cluster's {len(cpu_v)} verdicts equal TorchDriver(cpu) "
          f"({time.perf_counter() - t0:.1f}s incl. ingest)", flush=True)
    del cpu, res60

    # batched K1 and K2 on the phase's own stacked inputs, bit for bit,
    # and timed; torch.topk on the same [N * C_pad, R_pad] scores
    t = {k: 0.0 for k in ("k1", "k1d", "k1p", "k1b")}
    k2 = collections.Counter()
    k1_by = k2_by = "bytes"
    k1_err = k2_err = 0
    for program, stacked in inputs.values():
        d = exe._stacked_arrays(program, stacked)
        got = ir_eval.eval_mask_batched(program, d)
        want = ex._eval_mask_batched(program, d)
        k1_err = max(k1_err, max_err(got, want))
        if k1_err:
            fail("batched K1 mismatch on the north-star fleet's inputs")
        rank = d["__rank__"]
        g2 = topk.topk_packed_batched(got, rank, CAP)
        w2 = topk.topk_packed_batched_plain(got, rank, CAP)
        n_b, c_pad, r_pad = got.shape
        k2_err = max([k2_err] + [packed_err(g2[i], w2[i], CAP)
                                 for i in range(n_b)])
        if k2_err:
            fail("batched K2 mismatch on the north-star fleet's inputs")
        b1, k1_by = k1_bound_of(ex, ir_eval, program, d, 1)
        t["k1b"] += b1
        t["k1"] += cuda_ms(lambda: ir_eval.eval_mask_batched(program, d))
        t["k1d"] += graph_ms(lambda: ir_eval.eval_mask_batched(program, d))
        t["k1p"] += cuda_ms(lambda: ex._eval_mask_batched(program, d),
                            iters=3)
        n2 = k2_numbers(topk, got, rank, CAP)
        k2_by = n2.pop("bound_by")
        k2.update(n2)
    nk = len(inputs)
    t = {k: v / nk for k, v in t.items()}
    k2 = {k: v / nk for k, v in k2.items()}
    rec["K1b"] = {"launches": counts_a["K1b"], "max_abs_err": k1_err,
                  "ms": t["k1"], "device_ms": t["k1d"], "plain_ms": t["k1p"],
                  "bound_ms": t["k1b"], "bound_by": k1_by,
                  "library_ms": None}
    rec["K2b"] = {"launches": counts_a["K2b"], "max_abs_err": k2_err, **k2,
                  "bound_by": k2_by}
    print(f"phase fleet north star kernels: per launch at [{n_b}, {c_pad}, "
          f"{r_pad}] (mean over {nk} kinds): batched K1 "
          f"{k1_text(rec['K1b'])}; batched "
          f"K2 {k2_text(rec['K2b'])}, torch.topk on [{n_b * c_pad}, "
          f"{r_pad}]; both equal their plain versions", flush=True)
    del inputs, d, got, want, g2, w2, rank, clusters, warm, rep, exe
    torch.cuda.synchronize()

    # -- (b) the library fleet: bench.py's fleet_stack shape
    saved = torch_driver.SMALL_WORKLOAD_EVALS
    torch_driver.SMALL_WORKLOAD_EVALS = 0
    docs = all_docs()
    templates = [tdoc for tdoc, _ in docs]
    constraints = [c for _, c in docs]

    def library_fleet(factory):
        return [make_cluster(f"lib{i}", templates, constraints,
                             objs=make_mixed(random.Random(100 + i),
                                             FLEET_LIBRARY_ROWS),
                             driver_factory=factory) for i in range(4)]

    lib = library_fleet(None)
    fb = fleet_twice(lib, fns, fleet_audit, ir_eval)
    warm, rep, counts_b, widen_b = fb["warm"], fb["rep"], fb["counts"], \
        fb["widen"]
    exe, inputs = fb["exe"], fb["inputs"]
    _v, loop_digests, loop_s = fleet_loop_oracle(lib, CAP)
    for cl in lib:
        cl.driver.wait_delta_warm()
    cpu_lib = library_fleet(lambda: TorchDriver(device="cpu"))
    _cv, cpu_digests, cpu_s = fleet_loop_oracle(cpu_lib, CAP)
    torch_driver.SMALL_WORKLOAD_EVALS = saved
    n_stacked = len(rep.kinds_stacked)
    n_dfa = sum(len(ex.dfa_names(lib[0].driver._state(TARGET)
                                 .templates[k].vectorized.program))
                for k in rep.kinds_stacked)
    if rep.digests != warm.digests or rep.digests != loop_digests \
            or rep.digests != cpu_digests:
        fail(f"library fleet digests {rep.digests}, warm {warm.digests}, "
             f"loop oracle {loop_digests}, TorchDriver(cpu) {cpu_digests}")
    # an under-filled cap widens a kind to its full stacked mask: one
    # more batched K1 (and K3 per regex table) for that kind
    if rep.device_dispatches != n_stacked \
            or counts_b["K1b"] != n_stacked + widen_b \
            or counts_b["K2b"] != n_stacked \
            or not n_dfa <= counts_b["K3b"] <= n_dfa * (1 + widen_b) \
            or n_dfa == 0:
        fail(f"library fleet: {rep.device_dispatches} dispatches for "
             f"{n_stacked} stacked kinds ({n_dfa} regex tables, "
             f"{widen_b} widening masks), launches {counts_b}")
    print(f"phase fleet library: 4 clusters of {FLEET_LIBRARY_ROWS} rows x "
          f"{len(docs)} templates, cap {CAP}: stacked warm "
          f"{fb['warm_s']:.4f}s, stacked {fb['stacked_s']:.4f}s (of it "
          f"{fb['batched_s']:.4f}s in run_topk_batched) vs loop oracle "
          f"{loop_s:.4f}s; digests "
          f"{rep.digests} equal the loop oracle's and TorchDriver(cpu)'s "
          f"({cpu_s:.1f}s); {n_stacked} kinds stacked, replicated "
          f"{rep.kinds_replicated}; {rep.device_dispatches} dispatches, "
          f"{widen_b} widening masks; launches "
          f"{ {k: v for k, v in counts_b.items() if v} }; Triton "
          f"variants {' -> '.join(map(str, fb['variants']))}", flush=True)

    # batched K1, K2 and K3 on the library fleet's own inputs, bit for
    # bit; K3 timed at the regex kind's stacked table
    k3 = None
    k3_err = 0
    k1l = collections.Counter()
    shapes_b = collections.Counter()
    for program, stacked in inputs.values():
        d = exe._stacked_arrays(program, stacked)
        got = ir_eval.eval_mask_batched(program, d)
        if not torch.equal(got, ex._eval_mask_batched(program, d)):
            fail("batched K1 mismatch on the library fleet's inputs")
        n1 = k1_times(lambda: ir_eval.eval_mask_batched(program, d),
                      lambda: ex._eval_mask_batched(program, d), iters=10)
        n1["bound_ms"], k1l_by = k1_bound_of(ex, ir_eval, program, d, 1)
        k1l.update({k: v / len(inputs) for k, v in n1.items()})
        shapes_b[tuple(got.shape)] += 1
        g2 = topk.topk_packed_batched(got, d["__rank__"], CAP)
        w2 = topk.topk_packed_batched_plain(got, d["__rank__"], CAP)
        if max(packed_err(g2[i], w2[i], CAP) for i in range(got.shape[0])):
            fail("batched K2 mismatch on the library fleet's inputs")
        for nm in ex.dfa_names(program):
            ins = dfa_inputs(d, nm)
            k3_err = max(k3_err, max_err(dfa.dfa_table_batched(*ins),
                                         dfa.dfa_table_batched_plain(*ins)))
            if k3_err:
                fail(f"batched K3 mismatch on the library fleet's {nm}")
            k3 = ins
    rec["K3b"] = {"launches": counts_a["K3b"] + counts_b["K3b"],
                  "max_abs_err": k3_err, **k3_numbers(dfa, k3, True)}
    rec["K1bl"] = {"launches": counts_b["K1b"], "max_abs_err": 0, **k1l,
                   "bound_by": k1l_by, "library_ms": None}
    rec["K2b"]["launches"] += counts_b["K2b"]
    torch.cuda.synchronize()
    print(f"phase fleet library kernels: batched K1 and K2 equal their "
          f"plain versions on {len(inputs)} stacked kinds (shapes "
          f"{dict(shapes_b)}); batched K1 per launch, mean over the kinds: "
          f"{k1_text(rec['K1bl'])}; batched K3 on "
          f"the regex table: {k3_text(dfa, k3, rec['K3b'])}; phase "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()}",
          flush=True)


def stored_mask(st, kind: str):
    """The device violation mask the executor stores on ``kind``'s newest
    bindings (the legacy sweep's "reduce" and "delta" plans)."""
    ((_sig, viol),) = st.bindings_cache[kind][1].__dict__[
        "_viol_masks"].values()
    return viol


K6_OUTPUTS = ("new_g", "idx", "signs", "count", "row_any")


def k6_check(devdelta, ins, what: str, got=None) -> tuple[int, float]:
    """K6 (or its recorded output ``got``) against the plain version on
    ``ins`` = (new, pt, old, k), all five outputs bit for bit; returns
    (count, max_abs_err)."""
    if got is None:
        got = devdelta.mask_delta(*ins)
    want = devdelta.mask_delta_plain(*ins)
    err = 0.0
    for name, a, b in zip(K6_OUTPUTS, got, want):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"K6 mismatch ({name}) on {what}")
        err = max(err, max_err(a, b))
    return int(got[3]), err


def k6_numbers(devdelta, new, pt, old, k) -> dict:
    """K6 per call (``ms``) and device-only (``device_ms``, a CUDA
    graph), its plain version and one ``torch.nonzero`` of the gathered
    XOR (per call: nonzero synchronises, so no graph holds it) timed on
    one input, with the bound: new, old and pt read once, the gathered
    mask, row_any, idx and signs written once."""
    c, r = new.shape
    b, by = bound(3 * c * r + 4 * r + r + 5 * k, 2 * c * r)
    pt64 = pt.to(torch.int64)

    def run():
        return devdelta.mask_delta(new, pt, old, k)
    return {"ms": cuda_ms(run), "device_ms": graph_ms(run),
            "plain_ms": cuda_ms(lambda: devdelta.mask_delta_plain(
                new, pt, old, k), iters=5),
            "bound_ms": b, "bound_by": by,
            "library_ms": cuda_ms(lambda: torch.nonzero(
                torch.index_select(new, 1, pt64) ^ old))}


def k6_text(n: dict) -> str:
    return (f"{n['ms']:.4f} ms, device {n['device_ms']:.4f} (plain "
            f"{n['plain_ms']:.4f}, torch.nonzero {n['library_ms']:.4f}, "
            f"bound {n['bound_ms']:.6f} {n['bound_by']})")


K6_RANDOM = ((4, 131072, 1e-3, "identity", 256),
             (4, 131072, 1e-4, "permuted", 4096),
             (128, 131072, 1e-4, "permuted", 4096),
             (128, 131072, 0.0, "identity", 256),
             (5, 1000, 0.05, "out_of_range", 64),
             (3, 4097, 0.5, "permuted", 20000),
             (1, 1, 1.0, "identity", 1))


def k6_case(g, c, r, dens, ptk, dev) -> tuple:
    """(new, pt, old) on ``dev``: ``new`` at density 0.4, ``old`` the
    gathered ``new`` with ``dens`` of its bits flipped, the page table
    ``ptk`` (identity, permuted, or permuted with entries outside
    [0, r))."""
    new = (torch.rand((c, r), generator=g) < 0.4).to(dev)
    pt = torch.arange(r, dtype=torch.int32) if ptk == "identity" \
        else torch.randperm(r, generator=g).to(torch.int32)
    if ptk == "out_of_range":
        pt[:6] = torch.tensor([-1, r, -r - 1, 2 * r, -r, r + 3])
    pt = pt.to(dev)
    flips = (torch.rand((c, r), generator=g) < dens).to(dev)
    from gatekeeper_tpu_torch.kernels import devdelta
    old = devdelta.mask_delta_plain(new, pt, torch.zeros_like(new),
                                    1)[0] ^ flips
    return new, pt, old


def k6_random(devdelta, dev) -> int:
    """K6 against its plain version on K6_RANDOM: sparse and dense
    flips, a stream that overflows its width, permuted and out-of-range
    page tables, ragged sizes.  Returns the number of cases that
    overflowed."""
    g = torch.Generator(device="cpu").manual_seed(31)
    overflowed = 0
    for c, r, dens, ptk, k in K6_RANDOM:
        new, pt, old = k6_case(g, c, r, dens, ptk, dev)
        n, _ = k6_check(devdelta, (new, pt, old, k),
                        f"random [{c}, {r}] {ptk} density {dens} k {k}")
        overflowed += n > k
    if not overflowed:
        fail("K6 random cases never overflowed their width")
    return overflowed


K6_PATH = ((4, 131072, 1e-3, "identity", 256),
           (128, 131072, 1e-4, "identity", 4096),
           (128, 131072, 1e-4, "permuted", 4096))
"""K6 timed at the path's shapes: the devpages sweep's [4, 131072] at k
256 and the main phase's [128, 131072] at k 4096 with an identity page
table (the devpages page table is one until slots are remapped); and
[128, 131072] through a permuted table (a byte gather per element)."""


def k7_join(dev, n_rows: int = 131072, n_ingress: int = 2000,
            n_ids: int = 1 << 19, seed: int = 5) -> tuple:
    """K7's inputs at the ingress phase's shape: ``n_ingress`` selected
    rows holding host ids (50 shared by two, one same-name pair), the
    other rows MISSING; ``n_ids`` interned ids."""
    rng = np.random.default_rng(seed)
    src = np.full((n_rows,), -1, dtype=np.int32)
    names = rng.permutation(n_ids)[:n_rows].astype(np.int32)
    hosts = rng.permutation(n_ids)[: n_ingress - 50].astype(np.int32)
    src[:n_ingress] = np.concatenate([hosts, hosts[:50]])
    names[n_ingress - 1] = names[49]     # a same-name pair, one host
    sel = np.zeros((n_rows,), dtype=bool)
    sel[:n_ingress] = True
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (src, src.copy(), sel, names)) + (True, n_ids)


def k6k7_only(devdelta, invjoin, dev) -> None:
    """``--k6k7-only``: K6 on its random cases and K7 on a join at the
    ingress phase's row count, each against its plain version and timed
    per call and device-only, through the wrappers' public names only
    (so a copy of this script beside an earlier tree times that tree's
    kernels)."""
    overflowed = k6_random(devdelta, dev)
    g = torch.Generator(device="cpu").manual_seed(32)
    times = []
    for c, r, dens, ptk, k in K6_PATH:
        ins = k6_case(g, c, r, dens, ptk, dev) + (k,)
        k6_check(devdelta, ins, f"[{c}, {r}] {ptk} density {dens} k {k}")
        times.append(f"[{c}, {r}] {ptk} k {k}: "
                     f"{k6_text(k6_numbers(devdelta, *ins))}")
    print(f"phase K6 random: equal to plain on {len(K6_RANDOM)} random "
          f"cases ({overflowed} overflowing their width) and on the "
          f"timed ones; " + "; ".join(times), flush=True)
    ins = k7_join(dev)
    err = invjoin.error_flag(dev)
    for exclude in (True, False):
        got = invjoin.inv_join_mask(*ins[:4], exclude, ins[5], err)
        invjoin.check_error(err, ins[5])
        if not torch.equal(got, invjoin.inv_join_mask_plain(
                *ins[:4], exclude, ins[5])):
            fail(f"K7 mismatch on the synthetic join (exclude {exclude})")
    n = k7_numbers(invjoin, ins)
    print(f"phase K7 join: equal to plain on [{ins[0].shape[0]}] rows, "
          f"n_ids {ins[5]}, {int(ins[2].sum())} selected, both exclusion "
          f"modes: {n['ms']:.4f} ms, device {n['device_ms']:.4f} (plain "
          f"{n['plain_ms']:.4f}, bound {n['bound_ms']:.6f} "
          f"{n['bound_by']})", flush=True)


# past 65,536 pods, so the masks keep the main phase's R_pad (131,072)
DEVPAGES_PODS = 66_000
DEVPAGES_PROBE_PODS = 10_000
DEVPAGES_C_ROUNDS = 1           # churned rounds that also sweep driver C


def devpages_phase(rec: dict, fns: dict, dev, main_masks: list) -> None:
    """The paged audit with device-resident deltas (item B6): K6 against
    its plain version on random masks and at [C_pad, R_pad] on the main
    phase's masks, then driver A (pages and devpages on) beside driver B
    (GATEKEEPER_PAGES=off, the oracle) over DEVPAGES_PODS north-star
    pods with one constraint per template: a cold sweep and 3 churned
    capped sweeps on each, held equal, with A's routing, launches,
    transfers, memory and ledger events checked; driver C (the default
    route, the host page loop) is held to B on the cold sweep and the
    first DEVPAGES_C_ROUNDS churned ones, then released."""
    from gatekeeper_tpu_torch.client.interface import QueryOpts
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.enforce.devpages import delta_bucket
    from gatekeeper_tpu_torch.kernels import devdelta, scatter
    from gatekeeper_tpu_torch.library.north_star import (make_resources,
                                                         setup_north_star)

    opts = QueryOpts(limit_per_constraint=CAP)
    k4_calls = K4Calls(scatter)
    k4_jobs = 0

    def sweep(drv, paged: bool, devpages: bool | None = None):
        os.environ["GATEKEEPER_PAGES"] = "on" if paged else "off"
        os.environ["GATEKEEPER_DEVPAGES"] = \
            "on" if (paged if devpages is None else devpages) else "off"
        try:
            t0 = time.perf_counter()
            res, _ = drv.query_audit(TARGET, opts)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0
        finally:
            os.environ["GATEKEEPER_PAGES"] = "off"
            os.environ["GATEKEEPER_DEVPAGES"] = "off"

    # -- K6 on random masks: sparse and dense flips, a stream that
    # overflows its width, permuted and out-of-range page tables
    overflowed = k6_random(devdelta, dev)
    # -- K6 at the main phase's [C_pad, R_pad]: its steady stored mask
    # of one kind against the same kind's first churned mask
    steady, churned = main_masks
    c_pad, r_pad = steady.shape
    pt = torch.arange(r_pad, dtype=torch.int32, device=dev)
    n_main = int((churned ^ steady).sum())
    k_main = delta_bucket(n_main)
    k6_check(devdelta, (churned, pt, steady, k_main),
             f"the main phase's masks [{c_pad}, {r_pad}]")
    big = k6_numbers(devdelta, churned, pt, steady, k_main)
    print(f"phase devpages kernels random: K6 equal to plain on "
          f"{len(K6_RANDOM)} random cases ({overflowed} overflowing their "
          f"width), and at [{c_pad}, {r_pad}] on the main phase's steady "
          f"mask against its first churned mask ({n_main} changed bits, k "
          f"{k_main}): {k6_text(big)}", flush=True)
    del steady, churned, pt

    # -- the cold ledger build's size dependence: 10k pods first
    probe = TorchDriver()
    setup_north_star(probe, make_resources(DEVPAGES_PROBE_PODS,
                                           random.Random(21)),
                     random.Random(2), c_per_kind=1)
    _, probe_s = sweep(probe, True)
    del probe

    # -- driver A (paged + devpages), driver B (legacy oracle) and
    # driver C (paged, devpages off: the port's default route, the host
    # page loop)
    resources = make_resources(DEVPAGES_PODS, random.Random(1))
    t0 = time.perf_counter()
    a, b, c = TorchDriver(), TorchDriver(), TorchDriver()
    ca = setup_north_star(a, resources, random.Random(2), c_per_kind=1)
    cb = setup_north_star(b, resources, random.Random(2), c_per_kind=1)
    cc = setup_north_star(c, resources, random.Random(2), c_per_kind=1)
    ingest_s = time.perf_counter() - t0
    print(f"phase devpages ingest: 3 drivers x {DEVPAGES_PODS} pods "
          f"{ingest_s:.3f}s; A: {ingest_warm_text(a)}; B: "
          f"{ingest_warm_text(b)}; C: {ingest_warm_text(c)}", flush=True)
    reset_counts(fns)
    res_a, cold_s = sweep(a, True)
    cold_counts = launch_counts(fns)
    cold_pg = dict(a.last_sweep_phases["pages"])
    cold_dv = dict(a.last_sweep_phases["devpages"])
    res_b, cold_b_s = sweep(b, False)
    b_warm = warm_text(b)
    if norm(res_a) != norm(res_b):
        fail("devpages cold sweep: A's results differ from the oracle B's")
    reset_counts(fns)
    res_c, cold_c_s = sweep(c, True, devpages=False)
    cold_c_counts = launch_counts(fns)
    cold_c_pg = dict(c.last_sweep_phases["pages"])
    if norm(res_c) != norm(res_b):
        fail("devpages cold sweep: C's results differ from the oracle B's")
    if cold_c_pg["kinds_paged"] != 3 or cold_c_pg["ledger_full_builds"] != 3 \
            or c.last_sweep_phases["devpages"] != {"enabled": False} \
            or any(cold_c_counts.values()):
        fail(f"devpages cold sweep on C: pages {cold_c_pg}, devpages "
             f"{c.last_sweep_phases['devpages']}, launches {cold_c_counts}")
    if cold_pg["kinds_paged"] != 3 or cold_pg["ledger_full_builds"] != 3 \
            or cold_dv["kinds_device"] != 3 or cold_dv["mask_builds"] != 3 \
            or cold_counts["K6"] != 3 or cold_counts["K1"] != 3:
        fail(f"devpages cold sweep: pages {cold_pg}, devpages {cold_dv}, "
             f"launches {cold_counts}")
    led = a._state(TARGET).ledger
    ops = collections.Counter()
    led.subscribe(lambda ev: ops.update([ev["op"]]))
    led_c = c._state(TARGET).ledger
    ops_c = collections.Counter()
    led_c.subscribe(lambda ev: ops_c.update([ev["op"]]))
    split = HostSplit(a, led)
    if led_c.total_violations() != led.total_violations():
        fail(f"devpages cold sweep: C's ledger holds "
             f"{led_c.total_violations()} violations, A's "
             f"{led.total_violations()}")
    print(f"phase devpages cold: {DEVPAGES_PODS} pods x 3 constraints "
          f"(R_pad {r_pad}), cap {CAP}: ingest A and B {ingest_s:.3f}s; "
          f"cold ledger build {cold_s:.4f}s on A (at "
          f"{DEVPAGES_PROBE_PODS} pods {probe_s:.4f}s), oracle B's cold "
          f"sweep {cold_b_s:.4f}s ({b_warm}), "
          f"default route C's (host page loop) "
          f"cold ledger build {cold_c_s:.4f}s; {len(res_a)} results equal; "
          f"ledger "
          f"{led.total_violations()} violations; devpages h2d_bytes "
          f"{cold_dv['h2d_bytes']}; launches "
          f"{ {k: v for k, v in cold_counts.items() if v} }", flush=True)

    n_churn = max(DEVPAGES_PODS // 100, 1)
    churn_rng = random.Random(1234)
    label_pool = [f"l{j}" for j in range(10)]
    orig = devdelta.mask_delta
    calls: list = []
    k6_launches = cold_counts["K6"]
    mem = []
    for rep in range(3):
        on_c = rep < DEVPAGES_C_ROUNDS
        for i in churn_rng.sample(range(DEVPAGES_PODS), n_churn):
            o = copy.deepcopy(resources[i])
            o["metadata"]["labels"] = {k: "v" for k in label_pool
                                       if churn_rng.random() < 0.35}
            resources[i] = o
            ca.add_data(o)
            cb.add_data(o)
            if on_c:
                cc.add_data(o)
        ops.clear()
        ops_c.clear()
        total0 = led.total_violations()
        total0_c = led_c.total_violations() if on_c else None
        if rep == 0:
            devdelta.mask_delta = recording(orig, calls)
        k4_calls.install()
        split.take()
        reset_counts(fns)
        res_a, a_s = sweep(a, True)
        counts = launch_counts(fns)
        parts = split.take()
        devdelta.mask_delta = orig
        k4_jobs += k4_calls.finish(f"devpages churn {rep + 1} on A", rec)
        dv = dict(a.last_sweep_phases["devpages"])
        pg = dict(a.last_sweep_phases["pages"])
        res_b, b_s = sweep(b, False)
        if on_c:
            reset_counts(fns)
            res_c, c_s = sweep(c, True, devpages=False)
            c_counts = launch_counts(fns)
            pg_c = dict(c.last_sweep_phases["pages"])
            if norm(res_c) != norm(res_b):
                fail(f"devpages churn {rep + 1}: C's results differ from "
                     f"B's")
            if pg_c["kinds_paged"] != 3 or any(c_counts.values()) \
                    or ops_c["appear"] - ops_c["clear"] \
                    != led_c.total_violations() - total0_c \
                    or led_c.total_violations() != led.total_violations():
                fail(f"devpages churn {rep + 1} on C: pages {pg_c}, "
                     f"launches {c_counts}, {ops_c['appear']} appear - "
                     f"{ops_c['clear']} clear, ledger violations "
                     f"{total0_c} -> {led_c.total_violations()} (A "
                     f"{led.total_violations()})")
            if rep + 1 == DEVPAGES_C_ROUNDS:
                del c, cc, led_c
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
        k6_launches += counts["K6"]
        if norm(res_a) != norm(res_b):
            fail(f"devpages churn {rep + 1}: A's results differ from B's")
        over = dv["delta_overflows"]
        if dv["kinds_device"] != 3 or dv["kinds_fallback"] \
                or counts["K6"] != 3 + over or counts["K1"] != 3 + over \
                or counts["K5"] or counts["K2"]:
            fail(f"devpages churn {rep + 1}: devpages {dv}, launches "
                 f"{counts}")
        if dv["h2d_bytes"] * 5 >= cold_dv["h2d_bytes"]:
            fail(f"devpages churn {rep + 1}: h2d_bytes {dv['h2d_bytes']} is "
                 f"not under a fifth of the cold sweep's "
                 f"{cold_dv['h2d_bytes']}")
        if ops["appear"] - ops["clear"] != led.total_violations() - total0:
            fail(f"devpages churn {rep + 1}: {ops['appear']} appear - "
                 f"{ops['clear']} clear events, ledger violations "
                 f"{total0} -> {led.total_violations()}")
        print(f"phase devpages churn {rep + 1}: relabel {n_churn} pods; A "
              f"capped sweep {a_s:.4f}s ({split_text(parts, a_s)}), oracle "
              f"B {b_s:.4f}s, {len(res_a)} "
              f"results equal; rows_confirmed {dv['rows_confirmed']}, "
              f"direct_clears {dv['direct_clears']}, delta_events "
              f"{dv['delta_events']}, delta_overflows {over}, scatter_rows "
              f"{dv['scatter_rows']}, h2d_scatter_bytes "
              f"{dv['h2d_scatter_bytes']}, h2d_bytes {dv['h2d_bytes']}; "
              f"ledger {ops['appear']} appear / {ops['clear']} clear, "
              f"{led.total_violations()} violations, {pg['events']} events; "
              f"launches { {k: v for k, v in counts.items() if v} }; "
              f"memory_allocated {mem[-1]}", flush=True)
        if on_c:
            print(f"phase devpages churn {rep + 1} default route: C (host "
                  f"page loop) capped sweep {c_s:.4f}s, {len(res_c)} "
                  f"results equal B's; pages_evaluated "
                  f"{pg_c['pages_evaluated']}, pages_skipped "
                  f"{pg_c['pages_skipped']}, rows_reevaluated "
                  f"{pg_c['rows_reevaluated']}, {pg_c['events']} events, "
                  f"ledger {led.total_violations()} violations as A's",
                  flush=True)
        if rep:
            continue
        # K6 on the sweep's own inputs, bit for bit, and timed there
        k6_err = 0.0
        t = collections.Counter()
        for ins, got in calls:
            k6_err = max(k6_err, k6_check(devdelta, ins, "a churned sweep's "
                                          "input", got)[1])
            for key, v in k6_numbers(devdelta, *ins).items():
                if key != "bound_by":
                    t[key] += v / len(calls)
        shape = (list(calls[0][0][0].shape), calls[0][0][3])
        rec["K6"] = {"max_abs_err": k6_err, **t, "bound_by": "bytes"}
        print(f"phase devpages kernels: K6 equal to plain on the sweep's "
              f"{len(calls)} deltas ([C_pad, R_pad] and k {shape}), mean: "
              f"{k6_text(rec['K6'])}", flush=True)
        del calls, ins, got
    rec["K6"]["launches"] = k6_launches
    mask_bytes = 4 * r_pad
    if mem[2] - mem[1] >= mask_bytes:
        fail(f"devpages: device memory grew by {mem[2] - mem[1]} bytes from "
             f"the second churned sweep to the third (one [4, {r_pad}] "
             f"mask is {mask_bytes})")
    print(f"phase devpages memory: memory_allocated after each round "
          f"{mem}; third - second {mem[2] - mem[1]} bytes (< one mask, "
          f"{mask_bytes}); K6 launches over the phase {k6_launches}; K4 "
          f"equal to plain on A's {k4_jobs} scatters", flush=True)
    budget_phase(rec, fns, a, b, ca, cb, resources, churn_rng, label_pool,
                 led, ops, split)
    split.close()
    os.environ.pop("GATEKEEPER_DEVPAGES", None)
    del a, b, ca, cb, led, split


DEVPAGES_BUDGET = 131_072


class DeltaHighWater:
    """Wraps one driver's ``executor.eval_mask_delta`` to measure each
    delta evaluation's device high-water: ``max_memory_allocated`` over
    the call less ``memory_allocated`` before it, plus the resident mask
    and the page table it reads (the terms the certificate's devpages
    claim counts beside the new mask).  Keeps the largest per program,
    with the call's [C_pad, R_pad] and k."""

    def __init__(self, drv):
        self.ex = drv.executor
        orig = self.ex.eval_mask_delta
        self.peaks: dict[int, tuple] = {}

        def run(program, bindings, match, old_mask, page_table, k, *rest):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = orig(program, bindings, match, old_mask, page_table, k,
                       *rest)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base \
                + old_mask.nbytes + page_table.nbytes
            prev = self.peaks.get(id(program))
            if prev is None or peak > prev[0]:
                self.peaks[id(program)] = (peak, *old_mask.shape, k)
            return out

        self.ex.eval_mask_delta = run

    def close(self) -> None:
        del self.ex.eval_mask_delta


def check_certificates(drv, watch: DeltaHighWater, what: str) -> str:
    """Each kind's measured delta high-water against its Stage-8
    certificate's ``transient_bytes + devpages_bytes`` at the sweep's own
    pads and k, and its built device bindings (the executor's arrays and
    the inventory-join input records) against ``resident_bytes`` at the
    built shapes; fails past either."""
    st = drv._state(TARGET)
    out = []
    for kind, compiled in sorted(st.templates.items()):
        got = watch.peaks.get(id(compiled.vectorized.program)) \
            if compiled.vectorized is not None else None
        if got is None:
            continue
        peak, c_pad, r_pad, k = got
        cert = st.memsurfaces[kind]
        dims = {"c": c_pad, "r": r_pad}
        claim = cert.transient_bytes(dims) + cert.devpages_bytes(
            dims, delta_k=k)
        b = st.bindings_cache[kind][1]
        devs = [t for _h, t in
                b.__dict__["_device_caches"][id(drv.executor)].values()]
        shapes = {n: a.shape for n, a in b.arrays.items()}
        kp = st.devpages.get(kind)
        if kp is not None:
            devs += list(kp.ij_dev.values())
            shapes.update({n: tuple(t.shape) for n, t in kp.ij_dev.items()})
        built = sum(t.numel() * t.element_size() for t in devs)
        model = cert.resident_bytes(dims, shapes)
        if peak > claim or built > model:
            fail(f"{what}: {kind}'s delta evaluation held {peak} bytes "
                 f"(certificate transient + devpages {claim}), its device "
                 f"bindings {built} bytes (certificate resident {model})")
        out.append(f"{kind} high-water {peak} <= {claim}, bindings {built} "
                   f"<= {model}")
    return "; ".join(out)


def k8_check(residency, gathers, scatters, what: str) -> float:
    """K8's recorded gathers and scatters against their plain versions
    on the same inputs, bit for bit; returns max_abs_err."""
    err = 0.0
    for args, got in gathers:
        for x, y in zip(got, residency.page_gather_plain(*args)):
            if x.dtype != y.dtype or not torch.equal(x, y):
                fail(f"K8 gather mismatch in {what}")
            err = max(err, max_err(x, y))
    for args, got in scatters:
        want = residency.page_scatter_plain(*args)
        if got.dtype != want.dtype or not torch.equal(got, want):
            fail(f"K8 scatter mismatch in {what}")
        err = max(err, max_err(got, want))
    return err


def k8_numbers(residency, gather_ins, scatter_ins) -> tuple[dict, dict]:
    """K8's gather and scatter, their plain versions and one PyTorch
    call each (``torch.index_select`` of every gathered row;
    ``torch.index_copy`` into zeros), timed on one store's and one
    expand's inputs per call and (kernel and PyTorch call) device-only
    from a CUDA graph, with the bounds: the gather reads the mask and the
    page tables and writes the slot and staging buffers once; the
    scatter reads the slot buffer and the table and writes the whole
    mask once."""
    mask, slot, cold, page_rows = gather_ins
    buf, slot_s, r_pad, _p = scatter_ins
    c_pad = mask.shape[0]
    n_g = slot.numel() + cold.numel()
    rows_g = torch.cat([residency._page_rows(slot, page_rows, r_pad),
                        residency._page_rows(cold, page_rows, r_pad)])
    rows_s = residency._page_rows(slot_s, page_rows, r_pad)
    zeros = torch.zeros((c_pad, r_pad), dtype=torch.bool, device=buf.device)
    g = {"ms": cuda_ms(lambda: residency.page_gather(*gather_ins)),
         "plain_ms": cuda_ms(lambda: residency.page_gather_plain(
             *gather_ins)),
         "library_ms": cuda_ms(lambda: torch.index_select(mask, 1, rows_g)),
         "device_ms": graph_ms(lambda: residency.page_gather(*gather_ins)),
         "library_device_ms": graph_ms(lambda: torch.index_select(
             mask, 1, rows_g))}
    g["bound_ms"], g["bound_by"] = bound(
        mask.numel() + 4 * n_g + c_pad * n_g * page_rows, 0)
    sc = {"ms": cuda_ms(lambda: residency.page_scatter(*scatter_ins)),
          "plain_ms": cuda_ms(lambda: residency.page_scatter_plain(
              *scatter_ins)),
          "library_ms": cuda_ms(lambda: torch.index_copy(zeros, 1, rows_s,
                                                         buf)),
          "device_ms": graph_ms(lambda: residency.page_scatter(*scatter_ins)),
          "library_device_ms": graph_ms(lambda: torch.index_copy(
              zeros, 1, rows_s, buf))}
    sc["bound_ms"], sc["bound_by"] = bound(
        buf.numel() + 4 * slot_s.numel() + c_pad * r_pad, 0)
    return g, sc


def budget_phase(rec: dict, fns: dict, a, b, ca, cb, resources, churn_rng,
                 label_pool, led, ops, split) -> None:
    """The devpages budget (item B8): driver A and oracle B of the
    devpages phase, driver C released, go on for 3 rounds of 1% relabels
    with GATEKEEPER_DEVPAGES_BUDGET_BYTES=DEVPAGES_BUDGET, below each
    kind's certified resident claim: A's residency planners keep 1,024
    pages of each [4, 131072] mask on the device and spill the rest to
    the host.  Results equal B's, ledger events add up, K8 (page gather
    on every store, page scatter on every expand) equals its plain
    version on the rounds' own inputs and is timed there, the device
    memory held between sweeps drops by the masks less the slot buffers
    and stays flat, and each kind's delta high-water and device
    bindings stay inside its Stage-8 certificate."""
    import gc

    from gatekeeper_tpu_torch.analysis import memsurface
    from gatekeeper_tpu_torch.client.interface import QueryOpts
    from gatekeeper_tpu_torch.kernels import residency, scatter

    opts = QueryOpts(limit_per_constraint=CAP)
    k4_calls = K4Calls(scatter)
    k4_jobs = 0
    gc.collect()
    torch.cuda.synchronize()
    mem_unbudgeted = torch.cuda.memory_allocated()
    os.environ["GATEKEEPER_DEVPAGES_BUDGET_BYTES"] = str(DEVPAGES_BUDGET)
    watch = DeltaHighWater(a)
    n_churn = max(len(resources) // 100, 1)
    orig_g, orig_s = residency.page_gather, residency.page_scatter
    k8_launches = {"K8g": 0, "K8s": 0}
    k8_err = 0.0
    mem = []
    kp = a._state(TARGET).devpages
    mask_bytes = sum(p.c_pad * p.slots for p in kp.values())
    try:
        for rep in range(3):
            for i in churn_rng.sample(range(len(resources)), n_churn):
                o = copy.deepcopy(resources[i])
                o["metadata"]["labels"] = {k: "v" for k in label_pool
                                           if churn_rng.random() < 0.35}
                resources[i] = o
                ca.add_data(o)
                cb.add_data(o)
            ops.clear()
            total0 = led.total_violations()
            gathers, scatters = [], []
            residency.page_gather = recording(orig_g, gathers)
            residency.page_scatter = recording(orig_s, scatters)
            k4_calls.install()
            split.take()
            reset_counts(fns)
            os.environ["GATEKEEPER_PAGES"] = "on"
            os.environ["GATEKEEPER_DEVPAGES"] = "on"
            t0 = time.perf_counter()
            res_a, _ = a.query_audit(TARGET, opts)
            torch.cuda.synchronize()
            a_s = time.perf_counter() - t0
            counts = launch_counts(fns)
            parts = split.take()
            residency.page_gather, residency.page_scatter = orig_g, orig_s
            k4_jobs += k4_calls.finish(f"devpages budget round {rep + 1}",
                                       rec)
            os.environ["GATEKEEPER_PAGES"] = "off"
            os.environ["GATEKEEPER_DEVPAGES"] = "off"
            t0 = time.perf_counter()
            res_b, _ = b.query_audit(TARGET, opts)
            b_s = time.perf_counter() - t0
            dv = dict(a.last_sweep_phases["devpages"])
            if norm(res_a) != norm(res_b):
                fail(f"devpages budget {rep + 1}: A's results differ "
                     f"from B's")
            if ops["appear"] - ops["clear"] \
                    != led.total_violations() - total0:
                fail(f"devpages budget {rep + 1}: {ops['appear']} appear "
                     f"- {ops['clear']} clear, ledger violations {total0} "
                     f"-> {led.total_violations()}")
            planners = [(p.resident.active, p.resident.n_slots)
                        if p.resident is not None else None
                        for p in kp.values()]
            if planners != [(True, 1024)] * 3 \
                    or dv["kinds_device"] != 3 or dv["kinds_fallback"] \
                    or dv["resident_pages_device"] != 3 * 1024 \
                    or (rep and (dv["resident_spills"] <= 0
                                 or dv["resident_restores"] <= 0)) \
                    or counts["K8g"] != 3 \
                    or counts["K8s"] != (3 if rep else 0) \
                    or any(p.mask is not None for p in kp.values()):
                fail(f"devpages budget {rep + 1}: devpages {dv}, launches "
                     f"{counts}, planners (active, n_slots) {planners}")
            for key in k8_launches:
                k8_launches[key] += counts[key]
            k8_err = max(k8_err, k8_check(residency, gathers, scatters,
                                          f"budget round {rep + 1}"))
            if rep == 1:
                rec["K8g"], rec["K8s"] = k8_numbers(
                    residency, gathers[0][0], scatters[0][0])
                shape = tuple(gathers[0][0][0].shape)
                n_cold = gathers[0][0][2].numel()
            del gathers, scatters
            torch.cuda.synchronize()
            mem.append(torch.cuda.memory_allocated())
            print(f"phase devpages budget {rep + 1}: relabel {n_churn} "
                  f"pods, budget {DEVPAGES_BUDGET} bytes; A capped sweep "
                  f"{a_s:.4f}s ({split_text(parts, a_s)}), oracle B "
                  f"{b_s:.4f}s, {len(res_a)} results equal; "
                  f"resident_spills {dv['resident_spills']}, "
                  f"resident_restores {dv['resident_restores']}, "
                  f"resident_pages_device {dv['resident_pages_device']}, "
                  f"rows_confirmed {dv['rows_confirmed']}, scatter_rows "
                  f"{dv['scatter_rows']}, h2d_scatter_bytes "
                  f"{dv['h2d_scatter_bytes']}; ledger {ops['appear']} "
                  f"appear / {ops['clear']} clear; launches "
                  f"{ {k: v for k, v in counts.items() if v} }; "
                  f"memory_allocated {mem[-1]}", flush=True)
    finally:
        residency.page_gather, residency.page_scatter = orig_g, orig_s
        k4_calls.restore()
        watch.close()
        os.environ.pop("GATEKEEPER_DEVPAGES_BUDGET_BYTES", None)
    for key in k8_launches:
        rec[key].update(launches=k8_launches[key], max_abs_err=k8_err)
    slots = sum(p.resident.dev_buf.numel() for p in kp.values())
    drop = mask_bytes - slots
    if mem[2] - mem[1] >= mask_bytes // 3 \
            or mem_unbudgeted - mem[1] < drop \
            or mem_unbudgeted - mem[2] < drop:
        fail(f"devpages budget: memory_allocated {mem_unbudgeted} after the "
             f"last unbudgeted round, {mem} after the budgeted ones: not "
             f"flat, or not {drop} bytes lower (3 masks of "
             f"{mask_bytes // 3} less the slot buffers)")
    certs = check_certificates(a, watch, "devpages budget")
    dev = torch.device("cuda", 0)
    total = torch.cuda.get_device_properties(dev).total_memory
    print(f"phase devpages budget kernels: K8 equal to plain on every "
          f"store and expand of the 3 rounds; at [{shape[0]}, "
          f"{shape[1]}] ({1024} slots, {n_cold} cold pages of 32 rows) "
          f"gather {rec['K8g']['ms']:.4f} ms, device "
          f"{rec['K8g']['device_ms']:.4f} (plain "
          f"{rec['K8g']['plain_ms']:.4f}, torch.index_select "
          f"{rec['K8g']['library_ms']:.4f}, device "
          f"{rec['K8g']['library_device_ms']:.4f}, bound "
          f"{rec['K8g']['bound_ms']:.6f} bytes), scatter "
          f"{rec['K8s']['ms']:.4f} ms, device "
          f"{rec['K8s']['device_ms']:.4f} (plain "
          f"{rec['K8s']['plain_ms']:.4f}, torch.index_copy into zeros "
          f"{rec['K8s']['library_ms']:.4f}, device "
          f"{rec['K8s']['library_device_ms']:.4f}, bound "
          f"{rec['K8s']['bound_ms']:.6f} bytes); launches {k8_launches}; "
          f"K4 equal to plain on A's {k4_jobs} scatters (migrations and "
          f"restores)", flush=True)
    print(f"phase devpages budget memory: memory_allocated "
          f"{mem_unbudgeted} after the last unbudgeted round (driver C "
          f"released), {mem} after the budgeted ones: "
          f"{mem_unbudgeted - mem[1]} bytes lower (3 masks {mask_bytes} "
          f"less 3 slot buffers {slots} = {drop}), third - second "
          f"{mem[2] - mem[1]}; the card's total_memory {total} bytes = "
          f"the Stage-8 default budget {memsurface.default_budget_bytes(dev)}"
          f"; certificates: {certs}",
          flush=True)


class HostSplit:
    """The host time of one driver's paged sweeps split by wrapping its
    methods from outside: the scalar confirm (``_ledger_apply_row``),
    the ledger serve (``_ledger_serve``), the direct clears (the
    ledger's ``set_row`` calls made outside a confirm) and, inside the
    confirm, the rebuild of the frozen inventory document that
    inventory-reading templates evaluate against (the target state's
    ``inventory_doc``, rebuilt once per table generation).  ``take()``
    returns the seconds since the last call and starts again.  The
    residency planner's calls (``touch``, ``store``, ``expand`` of every
    ``ResidencyPlanner``, wrapped on the class until ``close()``) count
    as the part "planner": its host bookkeeping, the copy of the cold
    pages to the host and the restore uploads, with K8's launches."""

    PARTS = ("confirm", "clears", "serve", "inventory", "planner")
    PLANNER_CALLS = ("touch", "store", "expand")

    def __init__(self, drv, led):
        from gatekeeper_tpu_torch.enforce.devpages import ResidencyPlanner
        self.t = dict.fromkeys(self.PARTS, 0.0)
        self.n = dict.fromkeys(self.PARTS, 0)
        self.inside = 0
        st = drv._state(TARGET)
        apply_row, serve, set_row, inv_doc = (
            drv._ledger_apply_row, drv._ledger_serve, led.set_row,
            st.inventory_doc)
        self.planner_cls = ResidencyPlanner
        self.planner_fns = {name: getattr(ResidencyPlanner, name)
                            for name in self.PLANNER_CALLS}

        def timed(part, fn, mode: str):
            """mode "confirm" marks its extent, "outside" counts only
            outside a confirm, "always" counts every call."""
            def run(*a, **k):
                if self.inside and mode == "outside":
                    return fn(*a, **k)
                mark = mode == "confirm"
                self.inside += mark
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    self.t[part] += time.perf_counter() - t0
                    self.n[part] += 1
                    self.inside -= mark
            return run

        drv._ledger_apply_row = timed("confirm", apply_row, "confirm")
        drv._ledger_serve = timed("serve", serve, "always")
        led.set_row = timed("clears", set_row, "outside")
        st.inventory_doc = timed("inventory", inv_doc, "always")
        for name, fn in self.planner_fns.items():
            setattr(ResidencyPlanner, name, timed("planner", fn, "always"))

    def close(self) -> None:
        """Put the planner's methods back."""
        for name, fn in self.planner_fns.items():
            setattr(self.planner_cls, name, fn)

    def take(self) -> dict:
        out = {**{p: self.t[p] for p in self.PARTS},
               **{f"n_{p}": self.n[p] for p in self.PARTS}}
        self.t = dict.fromkeys(self.PARTS, 0.0)
        self.n = dict.fromkeys(self.PARTS, 0)
        return out


def split_text(split: dict, wall: float) -> str:
    rest = wall - split["confirm"] - split["clears"] - split["serve"] \
        - split["planner"]
    return (f"scalar confirm {split['confirm']:.4f}s ({split['n_confirm']} "
            f"rows; of it the inventory document {split['inventory']:.4f}s)"
            f", direct clears {split['clears']:.4f}s ({split['n_clears']}), "
            f"ledger serve {split['serve']:.4f}s, residency planner "
            f"{split['planner']:.4f}s ({split['n_planner']} calls), rest "
            f"(bindings, transfers, device, stream) {rest:.4f}s")


INGRESS_PODS = 66_000            # R_pad 131,072, as DEVPAGES_PODS
INGRESS_COUNT = 2_000
INGRESS_NAMESPACES = 200
INGRESS_SHARED_HOSTS = 50
INGRESS_KIND = "K8sUniqueIngressHost"
INGRESS_MATCH = {"kinds": [{"apiGroups": ["extensions", "networking.k8s.io"],
                            "kinds": ["Ingress"]}]}


def ingress(name: str, ns: str, host: str, i: int) -> dict:
    api = "networking.k8s.io/v1" if i % 2 else "extensions/v1beta1"
    return {"apiVersion": api, "kind": "Ingress",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"host": host, "rules": [{"host": host}]}}


def make_ingresses() -> list[dict]:
    """INGRESS_COUNT Ingresses in INGRESS_NAMESPACES namespaces: the
    first 2 x INGRESS_SHARED_HOSTS in pairs that share a host (in two
    namespaces), then one pair of the same name in two namespaces on one
    host (the same-name exclusion: neither violates), every other host
    unique."""
    out = []
    for i in range(INGRESS_COUNT):
        ns = f"ing-ns{i % INGRESS_NAMESPACES}"
        if i < 2 * INGRESS_SHARED_HOSTS:
            host = f"shared{i // 2}.example.com"
            name = f"ing{i:05d}"
        elif i < 2 * INGRESS_SHARED_HOSTS + 2:
            host, name = "same-name.example.com", "web"
        else:
            host, name = f"unique{i}.example.com", f"ing{i:05d}"
        out.append(ingress(name, ns, host, i))
    return out


def expected_duplicates(live: dict) -> int:
    """Ingresses that violate by the template's definition: another live
    Ingress has the host and a different name."""
    by_host = collections.defaultdict(list)
    for o in live.values():
        by_host[o["spec"]["host"]].append(o["metadata"]["name"])
    return sum(1 for names in by_host.values() for nm in names
               if any(other != nm for other in names))


def k7_numbers(invjoin, ins) -> dict:
    """K7 per call and device-only (a CUDA graph) and its plain version
    timed on one recorded input ``ins`` (src,
    inv, sel, names, exclude, n_ids), with the bound from the function's
    own traffic: the three int32 columns and sel read once, the bool
    column written once (14 bytes a row; the per-value tables are the
    kernel's scratch, not the function's).  K7 is timed as the sweep
    calls it, with a caller's error flag (read once, after the timing),
    so no launch waits for the device."""
    n_rows, n_ids = ins[0].shape[0], ins[5]
    b, by = bound(14 * n_rows, 8 * n_rows)
    err = invjoin.error_flag(ins[0].device)

    def run():
        return invjoin.inv_join_mask(*ins, err)
    ms, device_ms = cuda_ms(run), graph_ms(run)
    invjoin.check_error(err, n_ids)
    return {"ms": ms, "device_ms": device_ms,
            "plain_ms": cuda_ms(lambda: invjoin.inv_join_mask_plain(*ins),
                                iters=5),
            "bound_ms": b, "bound_by": by, "library_ms": None}


def ingress_phase(rec: dict, fns: dict, dev) -> None:
    """The inventory-join kind under devpages (B7): K8sUniqueIngressHost
    alone over INGRESS_PODS north-star pods and INGRESS_COUNT Ingresses,
    on driver A (GATEKEEPER_PAGES=on, GATEKEEPER_DEVPAGES=on) beside
    driver B (GATEKEEPER_PAGES=off) and TorchDriver(device="cpu") (legacy
    route, plain versions): a cold sweep and 3 rounds that each delete
    20 Ingresses (10 holding a shared host, so their partners clear
    without churning), add 20 (10 reusing a unique host, so the partner
    appears without churning) and relabel 1,000 pods.  Results equal on
    all three and equal to the duplicates the script counts itself, one
    K7 launch per delta evaluation, K7 equal to plain on the sweeps' own
    inputs, ledger events that add up, flat device memory."""
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.client.interface import QueryOpts
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.kernels import invjoin, scatter
    from gatekeeper_tpu_torch.library.north_star import make_resources
    from gatekeeper_tpu_torch.library.templates import (LIBRARY,
                                                        constraint_doc,
                                                        template_doc)
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget

    opts = QueryOpts(limit_per_constraint=CAP)
    pods = make_resources(INGRESS_PODS, random.Random(3))
    ings = make_ingresses()
    live = {(o["metadata"]["namespace"], o["metadata"]["name"]): o
            for o in ings}

    def sweep(drv, paged: bool):
        os.environ["GATEKEEPER_PAGES"] = "on" if paged else "off"
        os.environ["GATEKEEPER_DEVPAGES"] = "on" if paged else "off"
        try:
            t0 = time.perf_counter()
            res, _ = drv.query_audit(TARGET, opts)
            if drv.device.type == "cuda":
                torch.cuda.synchronize()
            return res, time.perf_counter() - t0
        finally:
            os.environ["GATEKEEPER_PAGES"] = "off"
            os.environ["GATEKEEPER_DEVPAGES"] = "off"

    t0 = time.perf_counter()
    drivers = (TorchDriver(device=dev), TorchDriver(device=dev),
               TorchDriver(device="cpu"))
    clients = []
    for d in drivers:
        c = Backend(d).new_client([K8sValidationTarget()])
        c.add_template(template_doc(INGRESS_KIND, LIBRARY[INGRESS_KIND][0]))
        c.add_constraint(constraint_doc(INGRESS_KIND, "unique-ingress-host",
                                        match=INGRESS_MATCH))
        c.add_data_batch(pods + ings)
        clients.append(c)
    a, b, cpu = drivers
    ingest_s = time.perf_counter() - t0
    print(f"phase devpages ingress ingest: {ingest_s:.3f}s for the 3 "
          f"drivers; A: {ingest_warm_text(a)}; B: {ingest_warm_text(b)}",
          flush=True)

    def check(what: str, res_a, res_b, res_c) -> None:
        if norm(res_a) != norm(res_b) or norm(res_a) != norm(res_c):
            fail(f"devpages ingress {what}: A's results differ from B's or "
                 "the CPU driver's")
        want = min(expected_duplicates(live), CAP)
        if len(res_a) != want:
            fail(f"devpages ingress {what}: {len(res_a)} results, the "
                 f"script counts {want} (cap {CAP})")

    reset_counts(fns)
    res_a, cold_s = sweep(a, True)
    cold_counts = launch_counts(fns)
    cold_dv = dict(a.last_sweep_phases["devpages"])
    cold_pg = dict(a.last_sweep_phases["pages"])
    res_b, cold_b_s = sweep(b, False)
    b.wait_delta_warm()
    res_c, cold_c_s = sweep(cpu, False)
    check("cold sweep", res_a, res_b, res_c)
    led = a._state(TARGET).ledger
    if cold_pg["kinds_paged"] != 1 or cold_dv["kinds_device"] != 1 \
            or cold_dv["inv_joins_device"] != 1 or cold_counts["K7"] != 1 \
            or led.total_violations() != expected_duplicates(live):
        fail(f"devpages ingress cold sweep: pages {cold_pg}, devpages "
             f"{cold_dv}, launches {cold_counts}, ledger "
             f"{led.total_violations()} violations, expected "
             f"{expected_duplicates(live)}")
    kp = a._state(TARGET).devpages[INGRESS_KIND]
    r_pad, mask_bytes = kp.slots, kp.c_pad * kp.slots
    print(f"phase devpages ingress cold: {INGRESS_PODS} pods + "
          f"{INGRESS_COUNT} Ingresses in {INGRESS_NAMESPACES} namespaces "
          f"({INGRESS_SHARED_HOSTS} shared hosts, one same-name pair), "
          f"{INGRESS_KIND} x 1 constraint (R_pad {r_pad}), cap {CAP}: "
          f"ingest A, B and CPU {ingest_s:.3f}s; cold ledger build "
          f"{cold_s:.4f}s on A, B's cold sweep {cold_b_s:.4f}s, the CPU "
          f"driver's {cold_c_s:.4f}s; {len(res_a)} results equal; ledger "
          f"{led.total_violations()} violations as counted; launches "
          f"{ {k: v for k, v in cold_counts.items() if v} }", flush=True)

    ops = collections.Counter()
    led.subscribe(lambda ev: ops.update([ev["op"]]))
    split = HostSplit(a, led)
    watch = DeltaHighWater(a)
    rng = random.Random(4321)
    label_pool = [f"l{j}" for j in range(10)]
    orig = invjoin.inv_join_mask
    calls: list = []
    k4_calls = K4Calls(scatter)
    k4_jobs = 0
    k7_launches = cold_counts["K7"]
    mem = []
    serial = INGRESS_COUNT
    for rep in range(3):
        by_host = collections.defaultdict(list)
        for key, o in live.items():
            by_host[o["spec"]["host"]].append(key)
        pairs = [ks for h, ks in sorted(by_host.items())
                 if len(ks) == 2 and h.startswith("shared")]
        singles = [ks[0] for h, ks in sorted(by_host.items())
                   if len(ks) == 1 and h.startswith("unique")]
        drop = [rng.choice(ks) for ks in rng.sample(pairs, 10)]
        picked = rng.sample(singles, 20)
        drop += picked[:10]
        batch = [("remove", live.pop(key)) for key in drop]
        for key in picked[10:20]:
            host = live[key]["spec"]["host"]
            o = ingress(f"ing{serial:05d}", f"ing-ns{serial % 200}", host,
                        serial)
            serial += 1
            live[(o["metadata"]["namespace"], o["metadata"]["name"])] = o
            batch.append(("add", o))
        for _ in range(10):
            o = ingress(f"ing{serial:05d}", f"ing-ns{serial % 200}",
                        f"unique{serial}.example.com", serial)
            serial += 1
            live[(o["metadata"]["namespace"], o["metadata"]["name"])] = o
            batch.append(("add", o))
        for i in rng.sample(range(INGRESS_PODS), 1000):
            o = copy.deepcopy(pods[i])
            o["metadata"]["labels"] = {k: "v" for k in label_pool
                                       if rng.random() < 0.35}
            pods[i] = o
            batch.append(("add", o))
        for c in clients:
            for op, o in batch:
                (c.add_data if op == "add" else c.remove_data)(o)
        ops.clear()
        total0 = led.total_violations()
        if rep == 0:
            invjoin.inv_join_mask = recording(orig, calls)
        k4_calls.install()
        split.take()
        reset_counts(fns)
        res_a, a_s = sweep(a, True)
        counts = launch_counts(fns)
        parts = split.take()
        invjoin.inv_join_mask = orig
        k4_jobs += k4_calls.finish(
            f"devpages ingress churn {rep + 1} on A", rec)
        dv = dict(a.last_sweep_phases["devpages"])
        res_b, b_s = sweep(b, False)
        res_c, c_s = sweep(cpu, False)
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
        check(f"churn {rep + 1}", res_a, res_b, res_c)
        k7_launches += counts["K7"]
        over = dv["delta_overflows"]
        if dv["kinds_device"] != 1 or dv["kinds_fallback"] \
                or dv["inv_joins_device"] != 1 or counts["K7"] != 1 + over \
                or counts["K6"] != 1 + over:
            fail(f"devpages ingress churn {rep + 1}: devpages {dv}, "
                 f"launches {counts}")
        if ops["appear"] - ops["clear"] != led.total_violations() - total0 \
                or led.total_violations() != expected_duplicates(live):
            fail(f"devpages ingress churn {rep + 1}: {ops['appear']} appear "
                 f"- {ops['clear']} clear, ledger violations {total0} -> "
                 f"{led.total_violations()}, expected "
                 f"{expected_duplicates(live)}")
        print(f"phase devpages ingress churn {rep + 1}: delete 20 Ingresses "
              f"(10 breaking a shared host), add 20 (10 on a unique host), "
              f"relabel 1000 pods; A capped sweep {a_s:.4f}s ("
              f"{split_text(parts, a_s)}), B {b_s:.4f}s, CPU {c_s:.4f}s; "
              f"{len(res_a)} results equal; rows_confirmed "
              f"{dv['rows_confirmed']}, direct_clears {dv['direct_clears']}, "
              f"delta_events {dv['delta_events']}, delta_overflows {over}, "
              f"scatter_rows {dv['scatter_rows']}, h2d_bytes "
              f"{dv['h2d_bytes']}; ledger {ops['appear']} appear / "
              f"{ops['clear']} clear, {led.total_violations()} violations "
              f"as counted; launches "
              f"{ {k: v for k, v in counts.items() if v} }; "
              f"memory_allocated {mem[-1]}", flush=True)
        if rep:
            continue
        # K7 on the sweep's own inputs, bit for bit, and timed there
        k7_err = 0.0
        for args, got in calls:
            want = invjoin.inv_join_mask_plain(*args[:6])
            if got.dtype != want.dtype or not torch.equal(got, want):
                fail("K7 mismatch on a churned ingress sweep's input")
            k7_err = max(k7_err, max_err(got, want))
        ins = calls[0][0][:6]
        rec["K7"] = {"max_abs_err": k7_err, **k7_numbers(invjoin, ins)}
        print(f"phase devpages ingress kernels: K7 equal to plain on the "
              f"sweep's {len(calls)} joins ([{ins[0].shape[0]}] rows, "
              f"n_ids {ins[5]}, {int(ins[2].sum())} selected): "
              f"{rec['K7']['ms']:.4f} ms, device "
              f"{rec['K7']['device_ms']:.4f} (plain {rec['K7']['plain_ms']:.4f}"
              f", bound {rec['K7']['bound_ms']:.6f} "
              f"{rec['K7']['bound_by']}; no single PyTorch call computes "
              f"it)", flush=True)
        del calls, args, got, want, ins
    rec["K7"]["launches"] = k7_launches
    if mem[2] - mem[1] >= mask_bytes:
        fail(f"devpages ingress: device memory grew by {mem[2] - mem[1]} "
             f"bytes from the second churned sweep to the third (one "
             f"[{kp.c_pad}, {r_pad}] mask is {mask_bytes})")
    split.close()
    watch.close()
    print(f"phase devpages ingress memory: memory_allocated after each "
          f"round {mem}; third - second {mem[2] - mem[1]} bytes; K7 "
          f"launches over the phase {k7_launches}; K4 equal to plain on "
          f"A's {k4_jobs} scatters; certificates: "
          f"{check_certificates(a, watch, 'devpages ingress')}", flush=True)
    del a, b, cpu, drivers, clients, led, kp



ADMISSION_SIZES = (64, 256, 1024)
ADMISSION_KINDS = ("K8sRequiredLabels", "K8sAllowedRepos")
ADMISSION_C_PER_KIND = 100
ADMISSION_SCALAR = 1024
ADMISSION_LIBRARY = 1024
ADMISSION_SUBMITS = 256
ADMISSION_THREADS = 8


def admission_reviews(objs, ops=("CREATE",)) -> list[dict]:
    """AdmissionRequest-shaped reviews of ``objs``, the operations
    cycled."""
    out = []
    for i, o in enumerate(objs):
        group, _, version = o.get("apiVersion", "v1").rpartition("/")
        out.append({"uid": f"u{i}", "kind": {"group": group,
                                             "version": version,
                                             "kind": o.get("kind", "")},
                    "name": o["metadata"]["name"],
                    "namespace": o["metadata"].get("namespace"),
                    "operation": ops[i % len(ops)], "object": o,
                    "userInfo": {"username": "chip-smoke"}})
    return out


def review_keys(results) -> list:
    return [(r.msg, r.constraint["metadata"]["name"], r.enforcement_action)
            for r in results]


def review_digest(results) -> str:
    """One review's results as a short digest of their keys."""
    return hashlib.sha256(repr(review_keys(results)).encode()) \
        .hexdigest()[:16]


def admission_store(driver):
    """The admission phase's client over ``driver`` (K8sRequiredLabels and
    K8sAllowedRepos, ADMISSION_C_PER_KIND constraints each, drawn from
    random.Random(11)) and its reviews (make_resources pods from the same
    generator, all CREATE)."""
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.library.north_star import make_resources
    from gatekeeper_tpu_torch.library.templates import (LIBRARY,
                                                        constraint_doc,
                                                        template_doc)
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
    rng = random.Random(11)
    client = Backend(driver).new_client([K8sValidationTarget()])
    for kind in ADMISSION_KINDS:
        client.add_template(template_doc(kind, LIBRARY[kind][0]))
    for j in range(ADMISSION_C_PER_KIND):
        client.add_constraint(constraint_doc(
            "K8sRequiredLabels", f"lab-{j:03d}",
            {"labels": rng.sample([f"l{x}" for x in range(10)], k=2)}))
        client.add_constraint(constraint_doc(
            "K8sAllowedRepos", f"rep-{j:03d}",
            {"repos": rng.sample(["gcr.io/", "docker.io/", "quay.io/",
                                  "ghcr.io/"], k=2)}))
    return client, admission_reviews(make_resources(max(ADMISSION_SIZES),
                                                    rng))


def admission_library(driver):
    """A client over ``driver`` with every library template and its
    constraint, and ADMISSION_LIBRARY make_mixed reviews
    (random.Random(12)), CREATE, UPDATE and DELETE in turn."""
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.library import all_docs, make_mixed
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
    client = Backend(driver).new_client([K8sValidationTarget()])
    for t, c in all_docs():
        client.add_template(t)
        client.add_constraint(c)
    return client, admission_reviews(
        make_mixed(random.Random(12), ADMISSION_LIBRARY),
        ops=("CREATE", "UPDATE", "DELETE"))


def admission_answers(conn, parts: tuple) -> None:
    """The admission oracle process: for ``"admission"`` in ``parts``,
    every admission review's and library review's per-review
    ``query_review`` answer on ``TorchDriver(device="cpu")`` (scalar host
    evaluation, as on the card), as digests, and the library's
    per-review seconds; for ``"manager"``, the manager phase's webhook
    answers (:func:`manager_answers`)."""
    torch.set_num_threads(1)
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    main = lib = mgr = None
    lib_s = 0.0
    if "admission" in parts:
        drv = TorchDriver(device="cpu")
        _client, reviews = admission_store(drv)
        main = [review_digest(drv.query_review(TARGET, r)[0])
                for r in reviews]
        lib_drv = TorchDriver(device="cpu")
        _lib, lib_reviews = admission_library(lib_drv)
        t0 = time.perf_counter()
        lib = [review_digest(lib_drv.query_review(TARGET, r)[0])
               for r in lib_reviews]
        lib_s = time.perf_counter() - t0
    if "manager" in parts:
        mgr = manager_answers()
    conn.send((main, lib, lib_s, mgr))
    conn.close()


class AdmissionOracle:
    """The admission phase's per-review answers, computed in a spawned
    process (``admission_answers``) while the card runs the earlier
    phases: the host oracle's per-review work would otherwise add about
    a minute to the script."""

    def __init__(self, parts: tuple = ("admission", "manager")):
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        self._out = None
        self._recv, send = ctx.Pipe(duplex=False)
        self._proc = ctx.Process(target=admission_answers,
                                 args=(send, parts),
                                 name="admission-oracle", daemon=True)
        self._proc.start()
        send.close()

    def result(self, timeout: float = 600.0):
        """(main digests, library digests, library per-review seconds,
        manager answer digests), each None for a part not asked for;
        fails the run if the process ended without them.  Later calls
        return the first call's answers."""
        if self._out is not None:
            return self._out
        t0 = time.perf_counter()
        if not self._recv.poll(timeout):
            fail(f"the admission oracle process gave no answers in "
                 f"{timeout:.0f}s")
        try:
            out = self._recv.recv()
        except EOFError:
            fail(f"the admission oracle process ended without answers "
                 f"(exit code {self._proc.exitcode})")
        self._proc.join(60)
        self.waited_s = time.perf_counter() - t0
        self._out = out
        return out

    def stop(self) -> None:
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join(10)


def floor2(x: float) -> float:
    """``x`` rounded down to two significant digits."""
    if x <= 0:
        return 0.0
    e = math.floor(math.log10(x)) - 1
    return math.floor(x / 10 ** e) * 10 ** e


def admission_phase(rec: dict, fns: dict, oracle: AdmissionOracle) -> None:
    """The admission micro-batch (``query_review_batch``) on the card:
    K8sRequiredLabels and K8sAllowedRepos with ADMISSION_C_PER_KIND
    constraints each (drawn from random.Random(11)) over
    max(ADMISSION_SIZES) CREATE reviews of make_resources pods.  The
    scalar single-thread rate over ADMISSION_SCALAR ``query_review``
    calls, timed in 4 chunks; then, with both routing thresholds at 0,
    per batch size one untimed batch (the Triton variants it compiles
    and its seconds) and 4 timed batches (2 from 1,024 on, 1 from 2,048):
    reviews per second, K1 and K3 launches and h2d bytes per batch.
    Every batch equals per-review ``query_review`` (the first
    ADMISSION_SCALAR answers from the timed calls, all of them from
    ``oracle``'s process, which must agree); a timed batch that compiles
    a variant fails the run.  The crossover (the smallest size whose
    slowest timed batch beats the fastest scalar chunk by more than the
    chunks' spread, times 200 constraints) and the cost model's units per
    second at each size give
    the defaults of ``REVIEW_BATCH_MIN_EVALS`` and the cost prior.  Then
    one batch of ADMISSION_LIBRARY make_mixed reviews (CREATE, UPDATE
    and DELETE) under the whole library (K3, the operation gate, the
    inventory-join gate), K1 timed at the review batch's shape (each B
    from 1,024 on) and K3 at the library batch's, and a MicroBatcher
    serving ADMISSION_SUBMITS concurrent submits from ADMISSION_THREADS
    threads through ``client.review_batch``."""
    from gatekeeper_tpu_torch.analysis import costmodel
    from gatekeeper_tpu_torch.engine import executor as ex
    from gatekeeper_tpu_torch.engine import torch_driver
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.kernels import dfa, ir_eval
    from gatekeeper_tpu_torch.webhook.batcher import MicroBatcher

    drv = TorchDriver()
    client, reviews = admission_store(drv)
    n_cons = len(ADMISSION_KINDS) * ADMISSION_C_PER_KIND
    st = drv._state(TARGET)

    # -- the scalar single-thread rate, and every review's answer
    n_scalar = ADMISSION_SCALAR
    for r in reviews[:8]:
        drv.query_review(TARGET, r)             # closure warm
    # timed in 4 chunks: the fastest chunk's rate is what a batch size
    # must beat to win
    want, chunk_s = [], []
    for lo in range(0, n_scalar, n_scalar // 4):
        t0 = time.perf_counter()
        want += [review_keys(drv.query_review(TARGET, r)[0])
                 for r in reviews[lo:lo + n_scalar // 4]]
        chunk_s.append(time.perf_counter() - t0)
    scalar_s = sum(chunk_s)
    scalar_rps = n_scalar / scalar_s
    scalar_best = n_scalar // 4 / min(chunk_s)
    scalar_spread = scalar_best - n_scalar // 4 / max(chunk_s)
    digests, lib_digests, lib_scalar_s, _ = oracle.result()
    mine = [hashlib.sha256(repr(k).encode()).hexdigest()[:16] for k in want]
    if len(digests) != len(reviews) or mine != digests[:n_scalar]:
        fail("the admission oracle process's per-review answers differ from "
             "this driver's")
    print(f"phase admission scalar: {n_cons} constraints "
          f"({', '.join(ADMISSION_KINDS)}), {n_scalar} query_review calls "
          f"in {scalar_s:.4f}s = {scalar_rps:.1f} reviews/s single-thread "
          f"(chunks of {n_scalar // 4}: "
          f"{[round(n_scalar // 4 / c, 1) for c in chunk_s]} reviews/s; "
          f"{sum(map(bool, want))} of {n_scalar} reviews denied); the "
          f"per-review answers of all {len(digests)} reviews from the oracle "
          f"process (TorchDriver(device='cpu')) (waited "
          f"{oracle.waited_s:.4f}s), equal to these {n_scalar}", flush=True)

    def check(got, lo: int, what: str) -> None:
        have = [review_digest(res) for res, _trace in got]
        if have != digests[lo: lo + len(have)]:
            bad = next(i for i, (a, b) in enumerate(
                zip(have, digests[lo:])) if a != b)
            fail(f"admission {what}: review {lo + bad} differs from "
                 f"query_review")

    # -- the device pass at each batch size
    saved = (torch_driver.SMALL_WORKLOAD_EVALS,
             torch_driver.REVIEW_BATCH_MIN_EVALS)
    torch_driver.SMALL_WORKLOAD_EVALS = 0
    torch_driver.REVIEW_BATCH_MIN_EVALS = 0
    lowered = [st.templates[k].vectorized for k in ADMISSION_KINDS]
    batches0 = drv.metrics.counter("review_batches_device").value
    rows, calls = {}, {}
    path_counts = collections.Counter()
    for B in ADMISSION_SIZES:
        batch = reviews[:B]
        # the first batch of 1,024 and more keeps K1's inputs, for its
        # times at the review batch's shape below
        store: list = []
        orig_k1 = ir_eval.eval_mask
        if B >= 1024:
            ir_eval.eval_mask = recording(orig_k1, store)
        v0 = triton_variants(ir_eval)
        try:
            t0 = time.perf_counter()
            got = drv.query_review_batch(TARGET, batch)
            first_s = time.perf_counter() - t0
        finally:
            ir_eval.eval_mask = orig_k1
        if store:
            calls[B] = [args for args, _res in store]
        v1 = triton_variants(ir_eval)
        check(got, 0, f"first batch of {B}")
        # 4 timed batches, 2 from 1,024 and 1 from 2,048 (about half a
        # minute of host confirmation each there): the script's time limit
        reps = 4 if B < 1024 else 2 if B < 2048 else 1
        times, h2d = [], []
        reset_counts(fns)
        for _ in range(reps):
            h0 = drv.executor.h2d_bytes
            t0 = time.perf_counter()
            got = drv.query_review_batch(TARGET, batch)
            times.append(time.perf_counter() - t0)
            h2d.append(drv.executor.h2d_bytes - h0)
            check(got, 0, f"timed batch of {B}")
        counts = launch_counts(fns)
        path_counts.update(counts)
        v2 = triton_variants(ir_eval)
        if v2 != v1:
            fail(f"a timed admission batch of {B} compiled Triton variants: "
                 f"{v1} -> {v2}")
        units = sum(costmodel.estimate(lw, B, ADMISSION_C_PER_KIND).units()
                    for lw in lowered)
        mean_s = sum(times) / reps
        rows[B] = {"first_s": first_s, "compiled": v1 - v0,
                   "mean_s": mean_s, "rps": B / mean_s,
                   "slowest_rps": B / max(times),
                   "ups": units / mean_s, "units": units,
                   "k1": counts["K1"] / reps, "k3": counts["K3"] / reps,
                   "h2d": h2d[-1]}
        print(f"phase admission batch {B}: first batch {first_s:.4f}s "
              f"compiling {v1 - v0} Triton variants; {reps} timed batches "
              f"{[round(t, 4) for t in times]}s = {B / mean_s:.1f} reviews/s"
              f" (slowest {B / max(times):.1f}; "
              f"{B * n_cons / mean_s:.4g} constraint-evals/s; scalar "
              f"{scalar_rps:.1f}), launches a batch K1 {counts['K1'] / reps}"
              f" K3 {counts['K3'] / reps}, h2d_bytes a batch {h2d[-1]}; "
              f"cost model {units:.4g} units = {units / mean_s:.4g} units/s",
              flush=True)
    if drv.metrics.counter("review_batches_device").value == batches0:
        fail("no admission batch took the device pass")
    # each size's timed batches, counted from 0 (reset_counts above)
    if path_counts["K1"] <= 0:
        fail("the admission batches launched no K1")
    # a size wins only when even its slowest timed batch beats the fastest
    # scalar chunk by more than the chunks' own spread: a difference
    # inside either side's spread is noise
    crossover = next((B for B in ADMISSION_SIZES
                      if rows[B]["slowest_rps"] > scalar_best + scalar_spread),
                     None)
    largest = max(ADMISSION_SIZES) * n_cons
    min_evals = crossover * n_cons if crossover is not None \
        else largest + 1
    slow = min(ADMISSION_SIZES, key=lambda B: rows[B]["ups"])
    prior = floor2(rows[slow]["ups"])
    print(f"phase admission crossover: "
          + (f"batch {crossover} is the smallest whose slowest timed batch "
             f"({rows[crossover]['slowest_rps']:.1f} reviews/s) beats the "
             f"fastest scalar chunk {scalar_best:.1f} by more than the "
             f"chunks' spread {scalar_spread:.1f}: "
             f"REVIEW_BATCH_MIN_EVALS = {crossover} x {n_cons} = {min_evals}"
             if crossover is not None else
             f"no batch size up to {max(ADMISSION_SIZES)} has its slowest "
             f"timed batch beat the fastest scalar chunk {scalar_best:.1f} "
             f"reviews/s by more than the chunks' spread "
             f"{scalar_spread:.1f}: "
             f"REVIEW_BATCH_MIN_EVALS stays above the largest measured, "
             f"{largest} + 1 = {min_evals}")
          + f"; cost prior: the slowest size ({slow}) retires "
          f"{rows[slow]['ups']:.6g} units/s, rounded down "
          f"{prior:.6g} (GATEKEEPER_COST_PRIOR_UPS); shipped "
          f"REVIEW_BATCH_MIN_EVALS {saved[1]}, _PRIOR_UNITS_PER_SECOND "
          f"{costmodel._PRIOR_UNITS_PER_SECOND:.6g}", flush=True)

    # -- the library batch: K3, the operation gate, the inventory-join
    # gate, CREATE/UPDATE/DELETE mixed
    lib_drv = TorchDriver()
    _lib, lib_reviews = admission_library(lib_drv)
    lst = lib_drv._state(TARGET)
    gates = collections.Counter()
    for kind, compiled in lst.templates.items():
        lw = compiled.vectorized
        if lw is None:
            gates["scalar (unlowered)"] += 1
        elif lw.spec.inv_joins:
            gates["inventory join (match gate)"] += 1
        elif any(rc.path[:1] == ("$meta",) and rc.path[1:] == ("operation",)
                 for rc in lw.spec.r_cols):
            gates["operation (match gate)"] += 1
        else:
            gates["device"] += 1
    v0 = triton_variants(ir_eval)
    k3_store: list = []
    orig_k3 = dfa.dfa_table
    dfa.dfa_table = recording(orig_k3, k3_store)
    reset_counts(fns)
    lb0 = lib_drv.metrics.counter("review_batches_device").value
    try:
        t0 = time.perf_counter()
        got = lib_drv.query_review_batch(TARGET, lib_reviews)
        lib_s = time.perf_counter() - t0
    finally:
        dfa.dfa_table = orig_k3
    lib_counts = launch_counts(fns)
    lib_counts["K3"] = len(k3_store)
    path_counts["K1"] += lib_counts["K1"]
    path_counts["K3"] += lib_counts["K3"]
    if [review_digest(res) for res, _ in got] != lib_digests:
        fail("the library admission batch differs from query_review")
    if lib_drv.metrics.counter("review_batches_device").value != lb0 + 1 \
            or lib_counts["K1"] <= 0 or not k3_store:
        fail(f"the library admission batch did not run K1 and K3 on the "
             f"device: launches {lib_counts}, K3 calls {len(k3_store)}")
    print(f"phase admission library: {len(lst.templates)} templates, "
          f"{ADMISSION_LIBRARY} make_mixed reviews (CREATE/UPDATE/DELETE): "
          f"one batch {lib_s:.4f}s compiling {triton_variants(ir_eval) - v0} "
          f"Triton variants (per-review query_review {lib_scalar_s:.4f}s in "
          f"the oracle process), equal to query_review; kinds by gate "
          f"{dict(gates)}; "
          f"launches K1 {lib_counts['K1']} K3 {lib_counts['K3']}; "
          f"{sum(bool(res) for res, _ in got)} reviews denied", flush=True)

    # -- K1 at the review batch's shapes, K3 at the library batch's
    k1r: dict = {}
    for B in sorted(calls):
        t = collections.Counter()
        err = 0
        for program, d in calls[B]:
            got_m = ir_eval.eval_mask(program, d)
            want_m = ex._eval_mask(program, d)
            if not torch.equal(got_m, want_m):
                fail(f"K1 mismatch at the review batch of {B}")
            err = max(err, max_err(got_m, want_m))
            bms, by = k1_bound_of(ex, ir_eval, program, d)
            t["bound_ms"] += bms / len(calls[B])
            for key, v in k1_times(
                    lambda: ir_eval.eval_mask(program, d),
                    lambda: ex._eval_mask(program, d)).items():
                t[key] += v / len(calls[B])
        shape = list(calls[B][0][1]["__cvalid__"].shape) \
            + list(calls[B][0][1]["__alive__"].shape)
        n = {"launches": path_counts["K1"], "max_abs_err": err, **t,
             "bound_by": by, "library_ms": None}
        print(f"phase admission K1 at B {B} ([C_pad, R_pad] {shape}, "
              f"mean over {len(calls[B])} kinds): {k1_text(n)}",
              flush=True)
        k1r[B] = n
    # the kernels line carries K1 at the largest batch's shape
    rec["K1r"] = k1r[max(calls)]
    (ins, _res) = k3_store[0]
    g3, w3 = dfa.dfa_table(*ins), dfa.dfa_table_plain(*ins)
    if not torch.equal(g3, w3):
        fail("K3 mismatch at the library review batch")
    rec["K3r"] = {"launches": path_counts["K3"],
                  "max_abs_err": max_err(g3, w3), **k3_numbers(dfa, ins)}
    print(f"phase admission K3 at the library batch: "
          f"{k3_text(dfa, ins, rec['K3r'])}", flush=True)

    # -- the micro-batcher over client.review_batch
    mb = MicroBatcher(client.review_batch,
                      predict_seconds=client.predict_review_seconds)
    reqs = reviews[:ADMISSION_SUBMITS]
    responses: list = [None] * len(reqs)
    errors: list = []
    v0 = triton_variants(ir_eval)
    b0 = drv.metrics.counter("review_batches_device").value
    mb.start()

    def worker(w):
        try:
            for i in range(w, len(reqs), ADMISSION_THREADS):
                resp = mb.submit(reqs[i])
                responses[i] = hashlib.sha256(repr(
                    [k for rs in resp.by_target.values()
                     for k in review_keys(rs.results)]).encode()) \
                    .hexdigest()[:16]
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(ADMISSION_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    mb_s = time.perf_counter() - t0
    mb.stop()
    torch_driver.SMALL_WORKLOAD_EVALS, torch_driver.REVIEW_BATCH_MIN_EVALS \
        = saved
    if errors or responses != digests[:len(reqs)]:
        fail(f"the micro-batcher's responses differ from query_review "
             f"({errors[:3]})")
    n_batches = mb.metrics.counter("admission_batches").value
    dev_batches = drv.metrics.counter("review_batches_device").value - b0
    if dev_batches != n_batches or not n_batches:
        fail(f"the micro-batcher's {n_batches} batches took the device pass "
             f"{dev_batches} times")
    print(f"phase admission micro-batcher: {len(reqs)} submits from "
          f"{ADMISSION_THREADS} threads in {mb_s:.4f}s, {n_batches} batches "
          f"(max_batch {mb.max_batch}), all on the device pass, compiling "
          f"{triton_variants(ir_eval) - v0} Triton variants; every response "
          f"equals query_review", flush=True)


MANAGER_PODS = 5_000
MANAGER_NAMESPACES = 50
MANAGER_SEED = 31
MANAGER_CHURN = 200
MANAGER_REVIEWS = 256
MANAGER_AUTO = 64
MANAGER_THREADS = 8
MANAGER_DIGESTS = "K8sImageDigests"
MANAGER_SETTLE_S = 300.0


def manager_docs() -> tuple[dict, list, list]:
    """The manager phase's policy objects: the sync Config (Namespace,
    Pod), the 3 north-star templates and K8sImageDigests, and 202
    constraints (the north-star draws of random.Random(2), 3 x 67, and
    one K8sImageDigests constraint)."""
    from gatekeeper_tpu_torch.api.config import empty_config_object
    from gatekeeper_tpu_torch.library.north_star import (
        north_star_constraints, north_star_templates)
    from gatekeeper_tpu_torch.library.templates import (LIBRARY,
                                                        constraint_doc,
                                                        template_doc)
    cfg = empty_config_object()
    cfg["spec"] = {"sync": {"syncOnly": [
        {"group": "", "version": "v1", "kind": "Namespace"},
        {"group": "", "version": "v1", "kind": "Pod"}]}}
    rego, params = LIBRARY[MANAGER_DIGESTS]
    templates = north_star_templates() + [template_doc(MANAGER_DIGESTS, rego)]
    constraints = north_star_constraints(random.Random(2)) + [
        constraint_doc(MANAGER_DIGESTS, "digests", params)]
    return cfg, templates, constraints


def manager_reviews() -> list[dict]:
    """MANAGER_REVIEWS + MANAGER_AUTO CREATE AdmissionRequests of fresh
    make_resources pods drawn from random.Random(MANAGER_SEED + 1)."""
    from gatekeeper_tpu_torch.library.north_star import make_resources
    objs = make_resources(MANAGER_REVIEWS + MANAGER_AUTO,
                          random.Random(MANAGER_SEED + 1))
    for i, o in enumerate(objs):
        o["metadata"]["name"] = f"admit{i:05d}"
    return admission_reviews(objs)


def response_digest(response: dict) -> str:
    """An AdmissionResponse (without its uid) as a short digest: allowed,
    the status code and message (the [denied by ...] lines) and the
    warnings, whatever keys it carries."""
    body = {k: v for k, v in response.items() if k != "uid"}
    return hashlib.sha256(json.dumps(body, sort_keys=True).encode()) \
        .hexdigest()[:16]


def manager_answers() -> list[str]:
    """Every manager-phase review's per-review answer from the port's
    ValidationHandler over a ``TorchDriver(device="cpu")`` client with the
    phase's templates and constraints (no batcher: one scalar query a
    review), as digests."""
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
    from gatekeeper_tpu_torch.webhook.policy import ValidationHandler
    client = Backend(TorchDriver(device="cpu")).new_client(
        [K8sValidationTarget()])
    _cfg, templates, constraints = manager_docs()
    for t in templates:
        client.add_template(t)
    for c in constraints:
        client.add_constraint(c)
    handler = ValidationHandler(client)
    return [response_digest(handler.handle(r)) for r in manager_reviews()]


def wait_until(cond, what: str, timeout: float = MANAGER_SETTLE_S) -> float:
    """Seconds until ``cond()`` held; fails the run after ``timeout``."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            fail(f"manager: {what} did not settle in {timeout:.0f}s")
        time.sleep(0.005)
    return time.perf_counter() - t0


def quiet(mgr, added: list, still_s: float = 0.2) -> None:
    """Wait until the manager's reconcile queue is empty and the sync
    controller's add_data count (``added[0]``) has not moved for
    ``still_s``."""
    def settled() -> bool:
        n = added[0]
        if mgr.plane.mgr._queue:
            return False
        time.sleep(still_s)
        return added[0] == n and not mgr.plane.mgr._queue
    wait_until(settled, "the reconcile queue")


def constraint_statuses(cluster, kinds) -> dict:
    """selfLink -> written status.violations (None when absent) of every
    constraint of ``kinds`` in the cluster."""
    from gatekeeper_tpu_torch.controllers.constrainttemplate import \
        make_constraint_gvk
    out = {}
    for kind in kinds:
        for c in cluster.list(make_constraint_gvk(kind)):
            out[c["metadata"]["selfLink"]] = \
                (c.get("status") or {}).get("violations")
    return out


STATUS_MSG_SIZE = 256    # Gatekeeper's status message cap (audit msgSize)


def direct_statuses(direct, links, full: bool = False,
                    results=None) -> dict:
    """What the audit manager must have written, built here and not by
    the manager's code: ``direct``'s capped audit (with ``full`` a forced
    full sweep: the legacy route, as under GATEKEEPER_PAGES=off; or its
    ``results`` when the caller already has them) grouped per constraint
    selfLink, at most CAP entries each in result order, each message cut
    to STATUS_MSG_SIZE characters ending in "..."; None for a constraint
    without violations."""
    lists: dict = {}
    if results is None:
        results = direct.audit(limit_per_constraint=CAP,
                               full=full).results()
    for r in results:
        bucket = lists.setdefault(r.constraint["metadata"]["selfLink"], [])
        if len(bucket) == CAP:
            continue
        meta = r.resource["metadata"]
        msg = r.msg if len(r.msg) <= STATUS_MSG_SIZE \
            else r.msg[:STATUS_MSG_SIZE - 3] + "..."
        entry = {"kind": r.resource["kind"], "name": meta["name"],
                 "message": msg,
                 "enforcementAction": r.enforcement_action or "deny"}
        if meta.get("namespace"):
            entry["namespace"] = meta["namespace"]
        bucket.append(entry)
    return {link: lists.get(link) for link in links}


def http_post(port: int, req: dict) -> tuple[dict, float]:
    import urllib.request
    body = json.dumps({"apiVersion": "admission.k8s.io/v1",
                       "kind": "AdmissionReview", "request": req}).encode()
    t0 = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/admit", data=body,
            headers={"Content-Type": "application/json"}), timeout=120) as r:
        out = json.loads(r.read())
    return out["response"], time.perf_counter() - t0


def post_all(port: int, reqs: list) -> tuple[list, list, float, list]:
    """POST every request from MANAGER_THREADS threads: (responses,
    latencies, wall seconds, errors)."""
    responses: list = [None] * len(reqs)
    lat: list = [0.0] * len(reqs)
    errors: list = []

    def worker(w):
        try:
            for i in range(w, len(reqs), MANAGER_THREADS):
                responses[i], lat[i] = http_post(port, reqs[i])
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(MANAGER_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    return responses, lat, time.perf_counter() - t0, errors


def quantile(xs: list, q: float) -> float:
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * len(s)))]


def manager_phase(rec: dict, fns: dict, oracle: AdmissionOracle) -> None:
    """The manager process on the card (``gatekeeper_tpu_torch.cmd.manager``
    ``Manager`` built from ``parse_args``, webhook on a free port): the
    sync Config, the 4 templates, 202 constraints, MANAGER_NAMESPACES
    namespaces and MANAGER_PODS make_resources pods created as cluster
    objects and reconciled by the controllers (the ingest rate); a cold
    and a steady ``audit_once`` whose written statuses must equal a
    direct capped audit on a second TorchDriver fed the cluster's stored
    objects; MANAGER_CHURN pods relabelled through ``cluster.update`` and
    a churned ``audit_once`` that must run K4 and K5 and no full K1,
    checked the same way; MANAGER_REVIEWS CREATE reviews POSTed to
    /v1/admit from MANAGER_THREADS threads with the handler's batch_mode
    "always" (query_review_batch: K1r, K3r), then MANAGER_AUTO more with
    the shipped "auto" (scalar, no K1 launch), every answer equal to the
    oracle process's per-review handler answer; /metrics, /debug/trace
    (admission.request and audit.cycle spans) and /healthz; ``stop()``.
    Then each kernel of the path at this phase's own recorded inputs
    against its plain version, timed per call and device-only."""
    import urllib.request

    from gatekeeper_tpu_torch.api.config import GVK
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.cmd.manager import Manager, parse_args
    from gatekeeper_tpu_torch.controllers.constrainttemplate import \
        TEMPLATE_GVK
    from gatekeeper_tpu_torch.engine import executor as ex
    from gatekeeper_tpu_torch.engine import torch_driver
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.kernels import dfa, ir_eval, scatter, topk
    from gatekeeper_tpu_torch.library.north_star import make_resources
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget

    ns_gvk, pod_gvk = GVK("", "v1", "Namespace"), GVK("", "v1", "Pod")
    cfg, templates, constraints = manager_docs()
    kinds = sorted({t["spec"]["crd"]["spec"]["names"]["kind"]
                    for t in templates})
    pods = make_resources(MANAGER_PODS, random.Random(MANAGER_SEED))
    earlier = set(threading.enumerate())    # earlier phases' threads
    mgr = Manager(parse_args(["--port", "0", "--audit-interval", "3600"]))
    if mgr.client.driver.device.type != "cuda":
        fail(f"manager: the default device is {mgr.client.driver.device}")
    mgr.start()
    stopped = False
    try:
        cluster, drv = mgr.cluster, mgr.client.driver
        # the sync controller's add_data calls, counted
        added = [0]
        add_data = mgr.client.add_data

        def counting(obj):
            out = add_data(obj)
            added[0] += 1
            return out

        mgr.client.add_data = counting

        # -- 1. policy and data as cluster objects, through the controllers
        t0 = time.perf_counter()
        cluster.create(copy.deepcopy(cfg))
        for t in templates:
            cluster.create(copy.deepcopy(t))
        for c in constraints:
            cluster.create(copy.deepcopy(c))
        wait_until(lambda: sum(len(v) for v in mgr.client.constraints
                               .values()) == len(constraints)
                   and mgr.plane.watch_manager.watched_gvks() >=
                   {ns_gvk, pod_gvk}, "the templates and constraints")
        policy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(MANAGER_NAMESPACES):
            cluster.create({"apiVersion": "v1", "kind": "Namespace",
                            "metadata": {"name": f"ns{i}"}})
        for p in pods:
            cluster.create(p)
        create_s = time.perf_counter() - t0
        n_objs = MANAGER_NAMESPACES + MANAGER_PODS
        st = drv._state(TARGET)
        wait_until(lambda: st.table.n_rows >= n_objs, "the ingest")
        ingest_s = time.perf_counter() - t0
        # each object's MODIFIED event (its finalizer write) re-adds it:
        # wait for the controllers to go quiet
        quiet(mgr, added)
        if st.table.n_rows != n_objs:
            fail(f"manager: the store holds {st.table.n_rows} objects, "
                 f"not {n_objs}")
        print(f"phase manager ingest: {len(templates)} templates and "
              f"{len(constraints)} constraints reconciled in {policy_s:.4f}s;"
              f" {MANAGER_NAMESPACES} namespaces and {MANAGER_PODS} pods "
              f"created in {create_s:.4f}s and synced by the controllers "
              f"(finalizer write, add_data) in {ingest_s:.4f}s = "
              f"{n_objs / ingest_s:.1f} objects/s into the store "
              f"({added[0]} add_data calls: each object again on its "
              f"finalizer write's event)", flush=True)

        # -- the direct client on a second card driver, fed the cluster's
        # own stored objects (finalizers included)
        direct = Backend(TorchDriver()).new_client([K8sValidationTarget()])
        for t in cluster.list(TEMPLATE_GVK):
            direct.add_template(t)
        for link_kind in kinds:
            for c in cluster.list(GVK("constraints.gatekeeper.sh",
                                      "v1alpha1", link_kind)):
                direct.add_constraint(c)
        direct.add_data_batch(cluster.list(ns_gvk) + cluster.list(pod_gvk))

        def check_statuses(what: str) -> int:
            got = constraint_statuses(cluster, kinds)
            if len(got) != len(constraints):
                fail(f"manager {what}: {len(got)} constraints in the "
                     f"cluster, not {len(constraints)}")
            want = direct_statuses(direct, got)
            bad = [k for k in got if got[k] != want[k]]
            if bad:
                fail(f"manager {what}: {len(bad)} constraints' written "
                     f"status.violations differ from the direct client's, "
                     f"first {bad[0]}")
            return sum(len(v or ()) for v in got.values())

        # -- 2. audit: cold (recording K1, K2 and K3), then steady
        k1_calls, k2_calls, k3_calls = [], [], []
        orig = (ir_eval.eval_mask, topk.topk_packed, dfa.dfa_table)
        ir_eval.eval_mask = recording(orig[0], k1_calls)
        topk.topk_packed = recording(orig[1], k2_calls)
        dfa.dfa_table = recording(orig[2], k3_calls)
        v0 = triton_variants(ir_eval)
        try:
            cold = mgr.audit.audit_once()
        finally:
            cold_counts = {"K1": ir_eval.eval_mask.launches,
                           "K2": topk.topk_packed.launches,
                           "K3": dfa.dfa_table.launches}
            ir_eval.eval_mask, topk.topk_packed, dfa.dfa_table = orig
        v1 = triton_variants(ir_eval)
        if cold.get("skipped") or min(cold_counts.values()) <= 0:
            fail(f"manager: the cold audit_once did not launch K1, K2 and "
                 f"K3: {cold_counts}, report {cold.get('skipped')}")
        # each recorded launch against its plain version now, before a
        # later sweep can reuse a buffer (times come after stop())
        errs = {"K1": 0.0, "K2": 0, "K3": 0.0}
        for (program, d), out in k1_calls:
            want = ex._eval_mask(program, d)
            if not torch.equal(out, want):
                fail("manager: K1 mismatch on a cold-sweep kind")
            errs["K1"] = max(errs["K1"], max_err(out, want))
        for (viol, rnk, k), out in k2_calls:
            errs["K2"] = max(errs["K2"], packed_err(
                out, topk.topk_packed_plain(viol, rnk, k), k))
        if errs["K2"]:
            fail("manager: K2 mismatch on a cold-sweep kind")
        for ins, out in k3_calls:
            want = dfa.dfa_table_plain(*ins)
            if not torch.equal(out, want):
                fail("manager: K3 mismatch on the K8sImageDigests table")
            errs["K3"] = max(errs["K3"], max_err(out, want))
        n_viol = check_statuses("cold audit")
        warm_s = drv.wait_delta_warm()
        steady = mgr.audit.audit_once()
        check_statuses("steady audit")
        print(f"phase manager audit: cold audit_once eval "
              f"{cold['eval_seconds']:.4f}s write {cold['write_seconds']:.4f}s"
              f" total {cold['total_seconds']:.4f}s (Triton variants {v0} -> "
              f"{v1}; launches {cold_counts}); steady eval "
              f"{steady['eval_seconds']:.4f}s write "
              f"{steady['write_seconds']:.4f}s total "
              f"{steady['total_seconds']:.4f}s; {cold['violations']} capped "
              f"results, {cold['constraints_updated']} statuses written "
              f"({n_viol} violations), equal to the direct client's; delta "
              f"warm-up {warm_s if warm_s is not None else 0.0:.4f}s",
              flush=True)

        # -- 3. churn: relabel pods through the cluster, then a sweep that
        # must take the delta plan (K4, K5) and run no full K1
        churn_rng = random.Random(MANAGER_SEED + 2)
        label_pool = [f"l{j}" for j in range(10)]
        before = added[0]
        changed = []
        t0 = time.perf_counter()
        for i in churn_rng.sample(range(MANAGER_PODS), MANAGER_CHURN):
            meta = pods[i]["metadata"]
            obj = cluster.get(pod_gvk, meta["name"], meta["namespace"])
            old = obj["metadata"].get("labels") or {}
            new = old
            while new == old:
                new = {k: "v" for k in label_pool
                       if churn_rng.random() < 0.35}
            obj["metadata"]["labels"] = new
            changed.append(cluster.update(obj))
        wait_until(lambda: added[0] >= before + MANAGER_CHURN, "the churn")
        churn_sync_s = time.perf_counter() - t0
        quiet(mgr, added)
        if added[0] != before + MANAGER_CHURN:
            fail(f"manager: {added[0] - before} add_data calls for "
                 f"{MANAGER_CHURN} relabelled pods")
        for o in changed:
            direct.add_data(cluster.get(pod_gvk, o["metadata"]["name"],
                                        o["metadata"]["namespace"]))
        k4 = K4Calls(scatter)
        k5_calls: list = []
        orig_k5 = ir_eval.delta_mask
        reset_counts(fns)
        k4.install()
        ir_eval.delta_mask = recording(orig_k5, k5_calls)
        x = drv.executor
        evals0 = (x.mask_evals, x.delta_evals)
        try:
            churned = mgr.audit.audit_once()
            churn_counts = launch_counts(fns)
        finally:
            k4.restore()
            ir_eval.delta_mask = orig_k5
        d_mask, d_delta = x.mask_evals - evals0[0], x.delta_evals - evals0[1]
        if churn_counts["K1"] or d_mask or churn_counts["K5"] <= 0 \
                or max(churn_counts["K4"], churn_counts["K4m"]) <= 0:
            fail(f"manager: the churned audit_once did not take the delta "
                 f"plan: launches {churn_counts}, mask_evals {d_mask}, "
                 f"delta_evals {d_delta}")
        k4_batches = [a[0] for a, _ in k4.many]
        n_k4, errs["K4"] = k4.check("the manager's churned sweep")
        errs["K5"] = 0.0
        for (program, d, viol_old, rows), out in k5_calls:
            want = ex._delta_mask(program, d, viol_old, rows)
            if not torch.equal(out, want):
                fail("manager: K5 mismatch on a churned kind")
            errs["K5"] = max(errs["K5"], max_err(out, want))
        check_statuses("churned audit")
        print(f"phase manager churn: {MANAGER_CHURN} pods relabelled through"
              f" cluster.update and synced in {churn_sync_s:.4f}s; churned "
              f"audit_once eval {churned['eval_seconds']:.4f}s write "
              f"{churned['write_seconds']:.4f}s total "
              f"{churned['total_seconds']:.4f}s, launches "
              f"{ {k: v for k, v in churn_counts.items() if v} }, "
              f"delta_evals {d_delta}, mask_evals {d_mask}; statuses equal "
              f"the direct client's", flush=True)

        # -- 4. admission over HTTP
        port = mgr.webhook.port
        reqs = manager_reviews()
        answers = oracle.result()[3]
        if answers is None or len(answers) != len(reqs):
            fail("manager: the oracle process gave no manager answers")

        def check_answers(got, lo: int, what: str) -> None:
            have = [response_digest(r) for r in got]
            if have != answers[lo:lo + len(have)]:
                bad = next(i for i, (a, b) in enumerate(
                    zip(have, answers[lo:])) if a != b)
                fail(f"manager {what}: review {lo + bad} answers "
                     f"{got[bad]['status']} unlike the per-review oracle")

        saved = torch_driver.REVIEW_BATCH_MIN_EVALS
        torch_driver.REVIEW_BATCH_MIN_EVALS = 0
        mgr.handler.batch_mode = "always"
        batches0 = drv.metrics.counter("review_batches_device").value
        # the review batch's K1 variants (a mini table of bucket(8) rows)
        # compile once, before the timed posts: a compile inside a
        # request could outlast the submit timeout
        t0 = time.perf_counter()
        mgr.client.review_batch(reqs[:MANAGER_THREADS])
        warm_rb_s = time.perf_counter() - t0
        k1r_calls, k3r_calls = [], []
        orig = (ir_eval.eval_mask, dfa.dfa_table)
        ir_eval.eval_mask = recording(orig[0], k1r_calls)
        dfa.dfa_table = recording(orig[1], k3r_calls)
        try:
            got, lat, wall, errors = post_all(port, reqs[:MANAGER_REVIEWS])
        finally:
            rb_counts = {"K1r": ir_eval.eval_mask.launches,
                         "K3r": dfa.dfa_table.launches}
            ir_eval.eval_mask, dfa.dfa_table = orig
        n_batches = drv.metrics.counter("review_batches_device").value \
            - batches0 - 1
        errs["K1r"] = errs["K3r"] = 0.0
        for (program, d), out in k1r_calls:
            want = ex._eval_mask(program, d)
            if not torch.equal(out, want):
                fail("manager: K1 mismatch on a review batch")
            errs["K1r"] = max(errs["K1r"], max_err(out, want))
        for ins, out in k3r_calls:
            want = dfa.dfa_table_plain(*ins)
            if not torch.equal(out, want):
                fail("manager: K3 mismatch on a review batch")
            errs["K3r"] = max(errs["K3r"], max_err(out, want))
        if errors:
            fail(f"manager: admission requests failed: {errors[:3]}")
        check_answers(got, 0, "batched admission")
        if min(rb_counts.values()) <= 0 or n_batches <= 0:
            fail(f"manager: the batched admissions did not run K1 and K3 on "
                 f"the card: launches {rb_counts}, batches {n_batches}")
        denied = sum(not r["allowed"] for r in got)
        print(f"phase manager admission: {MANAGER_REVIEWS} reviews POSTed "
              f"from {MANAGER_THREADS} threads (batch_mode always) in "
              f"{wall:.4f}s = {MANAGER_REVIEWS / wall:.1f} reviews/s, latency"
              f" p50 {quantile(lat, 0.5) * 1e3:.2f} ms p99 "
              f"{quantile(lat, 0.99) * 1e3:.2f} ms; {n_batches} device "
              f"batches (after one warm batch of {MANAGER_THREADS} "
              f"{warm_rb_s:.4f}s), launches {rb_counts}; {denied} denied; "
              f"every answer equals the per-review oracle", flush=True)
        torch_driver.REVIEW_BATCH_MIN_EVALS = saved
        mgr.handler.batch_mode = "auto"
        reset_counts(fns)
        batches0 = drv.metrics.counter("review_batches_device").value
        got, lat, wall, errors = post_all(port, reqs[MANAGER_REVIEWS:])
        auto_k1 = launch_counts(fns)["K1"]
        if errors:
            fail(f"manager: admission requests failed: {errors[:3]}")
        check_answers(got, MANAGER_REVIEWS, "auto admission")
        if auto_k1 or drv.metrics.counter("review_batches_device").value \
                != batches0:
            fail(f"manager: the shipped 'auto' mode launched K1 {auto_k1} "
                 f"times for {MANAGER_AUTO} reviews")
        print(f"phase manager admission auto: {MANAGER_AUTO} reviews with "
              f"the shipped batch_mode auto (REVIEW_BATCH_MIN_EVALS "
              f"{saved}: {len(constraints)} x {mgr.batcher.max_batch} pairs "
              f"stay scalar) in {wall:.4f}s = {MANAGER_AUTO / wall:.1f} "
              f"reviews/s, p50 {quantile(lat, 0.5) * 1e3:.2f} ms p99 "
              f"{quantile(lat, 0.99) * 1e3:.2f} ms; no K1 launch; every "
              f"answer equals the per-review oracle", flush=True)

        # -- 5. the other endpoints
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
            metrics = r.read().decode()
        with urllib.request.urlopen(f"{base}/debug/trace", timeout=60) as r:
            spans = {e["name"] for e in json.loads(r.read())["traceEvents"]}
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if "gatekeeper_admission_requests" not in metrics or \
                not {"admission.request", "audit.cycle"} <= spans or \
                health != {"state": "healthy", "backend": str(drv.device)}:
            fail(f"manager endpoints: metrics "
                 f"{'gatekeeper_admission_requests' in metrics}, spans "
                 f"{sorted(spans)[:8]}, healthz {health}")
        direct.driver.wait_delta_warm()     # the direct client's own warm
        t0 = time.perf_counter()
        mgr.stop()
        stopped = True
        stop_s = time.perf_counter() - t0
        left = [t.name for t in threading.enumerate()
                if t not in earlier and t.is_alive()
                and t.name in ("reconcile-worker", "admission-batcher",
                               "webhook-server", "audit-manager",
                               "watch-roster-poll", "audit-warmup",
                               "delta-warmup", "ingest-prewarm")]
        if left:
            fail(f"manager: threads still alive after stop(): {left}")
        print(f"phase manager endpoints: /metrics {len(metrics)} bytes, "
              f"/debug/trace spans include admission.request and "
              f"audit.cycle, /healthz {health}; stop() joined every thread "
              f"in {stop_s:.4f}s", flush=True)
    finally:
        if not stopped:
            mgr.stop()

    # -- 6. each kernel of the path timed at the phase's own inputs (the
    # manager is stopped: no other thread launches during a graph
    # capture); one entry a kernel in the kernels line
    join_warms()
    rec["K1mgr"] = {"launches": cold_counts["K1"], "max_abs_err": errs["K1"],
                    **k1_family(ex, ir_eval, k1_calls)}
    k2 = collections.Counter()
    for (viol, rnk, k), _out in k2_calls:
        nums = k2_numbers(topk, viol, rnk, k)
        k2_by = nums.pop("bound_by")
        k2.update({key: v / len(k2_calls) for key, v in nums.items()})
    rec["K2mgr"] = {"launches": cold_counts["K2"], "max_abs_err": errs["K2"],
                    **k2, "bound_by": k2_by}
    rec["K3mgr"] = {"launches": cold_counts["K3"], "max_abs_err": errs["K3"],
                    **k3_numbers(dfa, k3_calls[0][0])}
    rec["K4mgr"] = {"launches": churn_counts["K4"], "max_abs_err": errs["K4"],
                    **k4m_numbers(scatter, k4_batches)}
    rec["K5mgr"] = {"launches": churn_counts["K5"], "max_abs_err": errs["K5"],
                    **k5_numbers(ex, ir_eval, [a for a, _ in k5_calls])}
    rec["K1rmgr"] = {"launches": rb_counts["K1r"],
                     "max_abs_err": errs["K1r"],
                     **k1_family(ex, ir_eval, k1r_calls)}
    rec["K3rmgr"] = {"launches": rb_counts["K3r"],
                     "max_abs_err": errs["K3r"],
                     **k3_numbers(dfa, k3r_calls[0][0])}
    print(f"phase manager kernels: each equal to its plain version at the "
          f"path's own inputs: K1 {k1_text(rec['K1mgr'])} (mean over the "
          f"cold sweep's kinds); K2 {k2_text(rec['K2mgr'])}; K3 "
          f"{k3_text(dfa, k3_calls[0][0], rec['K3mgr'])}; K4 batched "
          f"{rec['K4mgr']['ms']:.4f} ms, device "
          f"{rec['K4mgr']['device_ms']:.4f} (bound "
          f"{rec['K4mgr']['bound_ms']:.6f}) over {n_k4} jobs in "
          f"{len(k4_batches)} calls; K5 {k1_text(rec['K5mgr'])}; K1r "
          f"{k1_text(rec['K1rmgr'])} (mean over the batch's kinds); K3r "
          f"{k3_text(dfa, k3r_calls[0][0], rec['K3rmgr'])}", flush=True)
    del direct, mgr, k1_calls, k2_calls, k3_calls, k5_calls, k1r_calls, \
        k3r_calls


REACTOR_PODS = 1_200
REACTOR_SEED = 41
REACTOR_INIT_EVERY = 20
REACTOR_INIT = {"name": "init0", "image": "evil.io/reactor:1"}
REACTOR_MSG = ("initContainer <init0> has an invalid image repo "
               "<evil.io/reactor:1>")
REACTOR_BURSTS = ((1, 25, 25), (10, 3, 2), (50, 1, 1))  # size, adds, removes
REACTOR_EVENT_S = 60.0
REACTOR_POLL_S = 0.5


def reactor_pods(n: int) -> list[dict]:
    """``n`` make_resources pods of random.Random(REACTOR_SEED); every
    REACTOR_INIT_EVERY-th carries REACTOR_INIT as an initContainer, so the
    cold store already holds the initContainers axis and its strings (an
    update that adds one lands in the element and string buckets the
    cold sweep compiled)."""
    from gatekeeper_tpu_torch.library.north_star import make_resources
    pods = make_resources(n, random.Random(REACTOR_SEED))
    for i, p in enumerate(pods):
        if i % REACTOR_INIT_EVERY == 0:
            p["spec"]["initContainers"] = [dict(REACTOR_INIT)]
    return pods


def reactor_plan(pods: list) -> tuple[list, int]:
    """The event window's bursts as [(size, op, [pod index, ...]), ...]
    and the index of one more pod (the watch_gap step's): for each size
    of REACTOR_BURSTS its add bursts (REACTOR_INIT added to pods without
    an initContainer: one appear event a K8sAllowedRepos constraint),
    then its remove bursts over the first of the same pods (one clear
    event a constraint), 200 updates in all."""
    pool = [i for i in range(len(pods)) if i % REACTOR_INIT_EVERY]
    plan, at = [], 0
    for size, adds, removes in REACTOR_BURSTS:
        mine = pool[at:at + size * adds]
        at += size * adds
        for b in range(adds):
            plan.append((size, "add", mine[b * size:(b + 1) * size]))
        for b in range(removes):
            plan.append((size, "remove", mine[b * size:(b + 1) * size]))
    return plan, pool[at]


def reactor_ingest(mgr, pods: list) -> dict:
    """The manager phase's policy set (manager_docs) and ``pods`` (with
    MANAGER_NAMESPACES namespaces) created as cluster objects and synced
    by the controllers, pumped to a fixed point on this thread
    (``plane.run_until_idle``, the manager not started); then the cold
    ``audit_once`` and the reconciles of its status writes.  Returns the
    seconds and the cold report."""
    cfg, templates, constraints = manager_docs()
    cluster = mgr.cluster
    t0 = time.perf_counter()
    cluster.create(copy.deepcopy(cfg))
    for t in templates:
        cluster.create(copy.deepcopy(t))
    mgr.plane.run_until_idle()
    for c in constraints:
        cluster.create(copy.deepcopy(c))
    mgr.plane.run_until_idle()
    policy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(MANAGER_NAMESPACES):
        cluster.create({"apiVersion": "v1", "kind": "Namespace",
                        "metadata": {"name": f"ns{i}"}})
    for p in pods:
        cluster.create(copy.deepcopy(p))
    mgr.plane.run_until_idle()
    ingest_s = time.perf_counter() - t0
    cold = mgr.audit.audit_once()
    mgr.plane.run_until_idle()
    return {"policy_s": policy_s, "ingest_s": ingest_s, "cold": cold,
            "constraints": len(constraints), "templates": templates}


def ledger_verdicts(led, idents=None) -> list:
    """The ledger's confirmed verdicts as sorted (kind, constraint,
    "ns/name", msg), for the resources ``idents`` ((ns, name) pairs) or
    all."""
    return sorted((kind, cname, f"{ident[0]}/{ident[1]}", r.msg)
                  for kind, ent in list(led.entries.items())
                  for _row, (ident, by_c) in list(ent.rows.items())
                  if idents is None or tuple(ident) in idents
                  for cname, rs in by_c.items() for r in rs)


def reactor_phase(rec: dict, fns: dict,
                  n_pods: int = REACTOR_PODS) -> None:
    """The event reactor on the card (``gatekeeper_tpu_torch.cmd.manager``
    ``Manager`` with GATEKEEPER_PAGES unset, the default, and
    GATEKEEPER_DEVPAGES=on, its TorchDriver on the card, webhook on a
    free port): the manager phase's 202 constraints and ``n_pods`` pods
    through the controllers; a cold ``audit_once`` whose statuses equal a
    direct capped audit of the stored objects; the manager started with
    no sweep due; 200 ``cluster.update``s in bursts of 1, 10 and 50, each
    adding or removing REACTOR_INIT, whose 67 appear or clear ledger
    events (one a K8sAllowedRepos constraint) must arrive within
    REACTOR_EVENT_S and no other event (event-to-verdict latency per
    burst size); over the window K4, K3, K1 and K6 launched (one K1, the
    devpaged route's full mask, for each K6), no K5, no Triton compile,
    every recorded launch equal to its plain version; the touched pods'
    ledger verdicts equal an uncapped direct audit of them, the served
    capped results and a following ``audit_once``'s statuses equal the
    direct capped audit; one annotation update with ``watch_gap`` armed
    (rung 2, a clean resync: no event), back to live; /debug/violations
    over HTTP with the reactor live; ``stop()``.  Then K4, K3, K1 and K6
    timed at the reactor's own inputs."""
    import urllib.request

    from gatekeeper_tpu_torch.api.config import GVK
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.cmd.manager import Manager, parse_args
    from gatekeeper_tpu_torch.controllers.constrainttemplate import \
        TEMPLATE_GVK
    from gatekeeper_tpu_torch.engine import executor as ex
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.kernels import (devdelta, dfa, ir_eval,
                                              scatter)
    from gatekeeper_tpu_torch.resilience import faults
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget

    t_phase = time.perf_counter()
    steps: dict = {}
    os.environ.pop("GATEKEEPER_PAGES", None)        # the default: on
    os.environ["GATEKEEPER_DEVPAGES"] = "on"
    ns_gvk, pod_gvk = GVK("", "v1", "Namespace"), GVK("", "v1", "Pod")
    pods = reactor_pods(n_pods)
    plan, gap_pod = reactor_plan(pods)
    earlier = set(threading.enumerate())
    mgr = Manager(parse_args(["--port", "0", "--audit-interval", "3600",
                              "--watch-poll-interval", str(REACTOR_POLL_S),
                              "--device", "cuda"]))
    stopped = False
    try:
        # -- 1. the reactor, built under the default pages mode
        if mgr.reactor is None:
            fail("reactor: the manager built no event reactor with "
                 "GATEKEEPER_PAGES unset")
        drv, cluster, rx = mgr.client.driver, mgr.cluster, mgr.reactor
        if drv.device.type != "cuda":
            fail(f"reactor: the manager's driver is on {drv.device}")

        # -- 2-3. ingest through the controllers, the cold audit
        v0 = triton_variants(ir_eval)
        t = reactor_ingest(mgr, pods)
        cold, kinds = t["cold"], sorted(
            d["spec"]["crd"]["spec"]["names"]["kind"]
            for d in t["templates"])
        n_objs = MANAGER_NAMESPACES + n_pods
        st = drv._state(TARGET)
        if st.table.n_rows != n_objs or cold.get("skipped"):
            fail(f"reactor: {st.table.n_rows} objects in the store, not "
                 f"{n_objs}; cold report {cold.get('skipped')}")
        pages = drv.last_sweep_phases["pages"]
        dvs = drv.last_sweep_phases["devpages"]
        if pages["kinds_paged"] != len(kinds) or \
                dvs.get("kinds_device") != len(kinds):
            fail(f"reactor: the cold sweep paged {pages['kinds_paged']} "
                 f"kinds, {dvs.get('kinds_device')} on the device")
        # the direct client on the CPU (the kernels' plain versions): no
        # compile and no warm thread of its own beside the window
        t0 = time.perf_counter()
        direct = Backend(TorchDriver(device="cpu")).new_client(
            [K8sValidationTarget()])
        for tdoc in cluster.list(TEMPLATE_GVK):
            direct.add_template(tdoc)
        con_gvks = [GVK("constraints.gatekeeper.sh", "v1alpha1", k)
                    for k in kinds]
        for g in con_gvks:
            for c in cluster.list(g):
                direct.add_constraint(c)
        direct.add_data_batch(cluster.list(ns_gvk) + cluster.list(pod_gvk))

        def check_statuses(what: str, results=None) -> int:
            got = constraint_statuses(cluster, kinds)
            if len(got) != t["constraints"]:
                fail(f"reactor {what}: {len(got)} constraints in the "
                     f"cluster, not {t['constraints']}")
            want = direct_statuses(direct, got, full=True, results=results)
            bad = [k for k in got if got[k] != want[k]]
            if bad:
                fail(f"reactor {what}: {len(bad)} constraints' written "
                     f"status.violations differ from the direct client's,"
                     f" first {bad[0]}")
            return sum(len(v or ()) for v in got.values())

        n_viol = check_statuses("cold audit")
        steps["direct_s"] = time.perf_counter() - t0
        led = st.ledger
        print(f"phase reactor ingest: {len(kinds)} templates and "
              f"{t['constraints']} constraints in {t['policy_s']:.4f}s; "
              f"{MANAGER_NAMESPACES} namespaces and {n_pods} pods "
              f"synced by the controllers in {t['ingest_s']:.4f}s; cold "
              f"audit_once (paged, devpages) eval "
              f"{cold['eval_seconds']:.4f}s write "
              f"{cold['write_seconds']:.4f}s total "
              f"{cold['total_seconds']:.4f}s, ledger "
              f"{led.total_violations()} violations ({n_viol} in the "
              f"capped statuses, equal to the direct client's); Triton "
              f"variants {v0} -> {triton_variants(ir_eval)}", flush=True)

        # -- 4. the warms joined, then the manager started (no sweep due)
        mgr.start()
        join_warms()
        drv.wait_delta_warm()
        wait_until(lambda: "Pod" in rx._subs, "the reactor's Pod stream")
        if rx.error is not None or rx.state != "live":
            fail(f"reactor: not live at start: {rx.state}, {rx.error!r}")

        # -- 5. the event window
        seen: list = []
        led.subscribe(lambda ev: seen.append((time.perf_counter(), ev)))
        names = [c["metadata"]["name"] for c in cluster.list(
            GVK("constraints.gatekeeper.sh", "v1alpha1", "K8sAllowedRepos"))]
        k4 = K4Calls(scatter)
        k1_calls, k3_calls, k5_calls, k6_calls = [], [], [], []
        orig = (ir_eval.eval_mask, dfa.dfa_table, ir_eval.delta_mask,
                devdelta.mask_delta)
        reset_counts(fns)
        k4.install()
        ir_eval.eval_mask = recording(orig[0], k1_calls)
        dfa.dfa_table = recording(orig[1], k3_calls)
        ir_eval.delta_mask = recording(orig[2], k5_calls)
        devdelta.mask_delta = recording(orig[3], k6_calls)
        v1 = triton_variants(ir_eval)
        counters0 = dict(rx.counters)
        lat: dict = collections.defaultdict(list)
        n_seen = 0
        t_window = time.perf_counter()
        try:
            for size, op, idx in plan:
                want = {}
                t_up = {}
                for i in idx:
                    meta = pods[i]["metadata"]
                    obj = cluster.get(pod_gvk, meta["name"],
                                      meta["namespace"])
                    if op == "add":
                        obj["spec"]["initContainers"] = [dict(REACTOR_INIT)]
                    else:
                        obj["spec"].pop("initContainers")
                    res = f"{meta['namespace']}/{meta['name']}"
                    for cname in names:
                        want[("appear" if op == "add" else "clear",
                              cname, res)] = res
                    t_up[res] = time.perf_counter()
                    cluster.update(obj)
                got_at: dict = {}
                t0 = time.perf_counter()
                while len(got_at) < len(want):
                    for ts, ev in seen[n_seen:]:
                        key = (ev["op"], ev["constraint"], ev["resource"])
                        if ev["kind"] != "K8sAllowedRepos" \
                                or ev["msg"] != REACTOR_MSG \
                                or key not in want or key in got_at:
                            fail(f"reactor: unexpected ledger event {ev}")
                        got_at[key] = ts
                        n_seen += 1
                    if time.perf_counter() - t0 > REACTOR_EVENT_S:
                        fail(f"reactor: {len(want) - len(got_at)} of "
                             f"{len(want)} expected ledger events did not "
                             f"arrive in {REACTOR_EVENT_S:.0f}s (burst "
                             f"{size} {op}); reactor {rx.counters}")
                    time.sleep(0.001)
                last = collections.defaultdict(float)
                for key, ts in got_at.items():
                    last[key[2]] = max(last[key[2]], ts)
                lat[size] += [last[r] - t_up[r] for r in t_up]
            window_s = time.perf_counter() - t_window
            time.sleep(REACTOR_POLL_S)      # a late stray event would show
            if len(seen) != n_seen:
                fail(f"reactor: unexpected ledger event {seen[n_seen][1]}")
            counts = launch_counts(fns)
        finally:
            k4.restore()
            (ir_eval.eval_mask, dfa.dfa_table, ir_eval.delta_mask,
             devdelta.mask_delta) = orig
        v2 = triton_variants(ir_eval)
        rungs = {k: rx.counters.get(k, 0) - counters0.get(k, 0)
                 for k in ("events", "rung1", "rereacts", "rung2", "rung3",
                           "coalesced_pages", "react_errors")}
        if counts["K6"] <= 0 or max(counts["K4"], counts["K4m"]) <= 0 \
                or counts["K1"] != counts["K6"] or counts["K5"] \
                or counts["K7"] or v2 != v1 or rungs["rung2"] \
                or rungs["react_errors"]:
            fail(f"reactor: the event window's launches {counts}, Triton "
                 f"variants {v1} -> {v2}, rungs {rungs}")
        errs = {"K6": 0.0, "K1": 0.0, "K3": 0.0}
        for ins, out in k6_calls:
            errs["K6"] = max(errs["K6"], k6_check(
                devdelta, ins, "the reactor's window", got=out)[1])
        for (program, d), out in k1_calls:
            want_m = ex._eval_mask(program, d)
            if not torch.equal(out, want_m):
                fail("reactor: K1 mismatch on a devpaged react")
            errs["K1"] = max(errs["K1"], max_err(out, want_m))
        for ins, out in k3_calls:
            want_t = dfa.dfa_table_plain(*ins)
            if not torch.equal(out, want_t):
                fail("reactor: K3 mismatch on a devpaged react")
            errs["K3"] = max(errs["K3"], max_err(out, want_t))
        k4_batches = [a[0] for a, _ in k4.many]
        n_k4, errs["K4"] = k4.check("the reactor's window")
        n_updates = sum(len(idx) for _s, _o, idx in plan)
        lat_txt = "; ".join(
            f"burst {size}: p50 {quantile(v, 0.5) * 1e3:.2f} ms p99 "
            f"{quantile(v, 0.99) * 1e3:.2f} ms max {max(v) * 1e3:.2f} ms "
            f"({len(v)} updates)" for size, v in sorted(lat.items()))
        print(f"phase reactor events: {n_updates} cluster.updates in "
              f"{len(plan)} bursts in {window_s:.4f}s = "
              f"{n_updates / window_s:.1f} updates/s, {n_seen} ledger "
              f"events ({n_seen / window_s:.1f}/s), every expected one and "
              f"no other; event-to-verdict {lat_txt}; reactor {rungs}; "
              f"launches { {k: v for k, v in counts.items() if v} } (one "
              f"K1, the devpaged full mask, a K6), {n_k4} K4 jobs, Triton "
              f"variants {v1} -> {v2}; K1, K3, K4, K6 equal their plain "
              f"versions", flush=True)

        # -- 7. the ledger against the direct client
        t0 = time.perf_counter()
        touched = sorted({i for _s, _o, idx in plan for i in idx})
        idents = set()
        for i in touched:
            meta = pods[i]["metadata"]
            direct.add_data(cluster.get(pod_gvk, meta["name"],
                                        meta["namespace"]))
            idents.add((meta["namespace"], meta["name"]))
        few = Backend(TorchDriver(device="cpu")).new_client(
            [K8sValidationTarget()])
        for tdoc in cluster.list(TEMPLATE_GVK):
            few.add_template(tdoc)
        for g in con_gvks:
            for c in cluster.list(g):
                few.add_constraint(c)
        few.add_data_batch([
            cluster.get(pod_gvk, pods[i]["metadata"]["name"],
                        pods[i]["metadata"]["namespace"]) for i in touched])
        want_v = sorted(
            (r.constraint["kind"], r.constraint["metadata"]["name"],
             f"{r.resource['metadata']['namespace']}/"
             f"{r.resource['metadata']['name']}", r.msg)
            for r in few.audit(full=True).results()
            if r.resource["kind"] == "Pod")
        got_v = ledger_verdicts(led, idents)
        if got_v != want_v:
            fail(f"reactor: the ledger's verdicts of the {len(touched)} "
                 f"touched pods differ from an uncapped audit of them "
                 f"({len(got_v)} against {len(want_v)})")
        served = norm(mgr.client.audit(limit_per_constraint=CAP).results())
        folded = drv.last_sweep_phases["pages"]
        oracle_res = direct.audit(limit_per_constraint=CAP,
                                  full=True).results()
        oracle = norm(oracle_res)
        if served != oracle or folded["events"] or \
                folded["rows_reevaluated"]:
            fail(f"reactor: the ledger's capped results differ from the "
                 f"direct client's, or the ledger was not current "
                 f"(events {folded['events']}, rows "
                 f"{folded['rows_reevaluated']})")
        after = mgr.audit.audit_once()
        n_viol = check_statuses("audit after the events", oracle_res)
        steps["checks_s"] = time.perf_counter() - t0

        # -- 8. watch_gap armed for one annotation update: rung 2
        counters0 = dict(rx.counters)
        faults.reset_for_tests()
        seq0 = led.seq
        meta = pods[gap_pod]["metadata"]
        obj = cluster.get(pod_gvk, meta["name"], meta["namespace"])
        obj["metadata"].setdefault("annotations", {})["reactor"] = "gap"
        os.environ["GATEKEEPER_FAULT"] = "watch_gap"
        try:
            t0 = time.perf_counter()
            cluster.update(obj)
        finally:
            os.environ.pop("GATEKEEPER_FAULT", None)
        wait_until(lambda: rx.counters.get("rung2", 0)
                   > counters0.get("rung2", 0) and rx.state == "live",
                   "the reactor's rung-2 resync")
        gap_s = time.perf_counter() - t0
        gap = {k: rx.counters.get(k, 0) - counters0.get(k, 0)
               for k in ("faults_watch_gap", "pathology_gap", "rung2",
                         "rung3", "resync_errors")}
        if gap["faults_watch_gap"] != 1 or gap["pathology_gap"] != 1 \
                or gap["rung2"] != 1 or gap["rung3"] or \
                gap["resync_errors"] or led.seq != seq0:
            fail(f"reactor: watch_gap took {gap}, ledger events "
                 f"{led.seq - seq0}")
        direct.add_data(cluster.get(pod_gvk, meta["name"],
                                    meta["namespace"]))
        served = norm(mgr.client.audit(limit_per_constraint=CAP).results())
        if served != norm(direct.audit(limit_per_constraint=CAP,
                                       full=True).results()):
            fail("reactor: the ledger differs from the direct client's "
                 "after the rung-2 resync")
        print(f"phase reactor resync: after the events, the touched pods' "
              f"{len(got_v)} ledger verdicts equal an uncapped audit of "
              f"them, the served capped results the direct client's (the "
              f"ledger current: no event, no row re-evaluated), and "
              f"audit_once eval {after['eval_seconds']:.4f}s write "
              f"{after['write_seconds']:.4f}s wrote statuses equal to it "
              f"({n_viol} violations); watch_gap on one annotation update:"
              f" {gap}, a clean rung-2 resync (no ledger event) back to "
              f"live in {gap_s:.4f}s, the ledger equal to the direct "
              f"client's", flush=True)

        # -- 9. /debug/violations, stop()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{mgr.webhook.port}/debug/violations",
                timeout=60) as r:
            doc = json.loads(r.read())
        mine = [x for x in doc.get("reactors", ())
                if x["name"] == rx.name and "Pod" in x["kinds"]]
        if len(mine) != 1 or mine[0]["state"] != "live" or \
                rx.error is not None:
            fail(f"reactor: /debug/violations reactors {mine}, error "
                 f"{rx.error!r}")
        t0 = time.perf_counter()
        mgr.stop()
        stopped = True
        stop_s = time.perf_counter() - t0
        left = [th.name for th in threading.enumerate()
                if th not in earlier and th.is_alive()
                and th.name in ("reconcile-worker", "admission-batcher",
                                "webhook-server", "audit-manager",
                                "watch-roster-poll", "audit-warmup",
                                "delta-warmup", "ingest-prewarm",
                                f"{rx.name}-pump")]
        if left:
            fail(f"reactor: threads still alive after stop(): {left}")
        print(f"phase reactor endpoints: /debug/violations has the reactor "
              f"live ({mine[0]['counters'].get('rung1', 0)} rung-1 "
              f"reacts); stop() joined every thread in {stop_s:.4f}s",
              flush=True)
    finally:
        if not stopped:
            try:
                mgr.stop()
            except Exception:       # noqa: BLE001 — the phase's own
                pass                # failure is the one reported
        os.environ["GATEKEEPER_PAGES"] = "off"
        os.environ.pop("GATEKEEPER_DEVPAGES", None)

    # -- each kernel of the window at its own inputs, timed
    t0 = time.perf_counter()
    join_warms()
    ins6 = max(k6_calls, key=lambda c: c[0][0].shape[1])[0]
    rec["K6rx"] = {"launches": counts["K6"], "max_abs_err": errs["K6"],
                   **k6_numbers(devdelta, *ins6)}
    (program, d), _ = k1_calls[-1]
    bms, by = k1_bound_of(ex, ir_eval, program, d)
    rec["K1rx"] = {"launches": counts["K1"], "max_abs_err": errs["K1"],
                   "bound_ms": bms, "bound_by": by, "library_ms": None,
                   **k1_times(lambda: ir_eval.eval_mask(program, d),
                              lambda: ex._eval_mask(program, d))}
    rec["K3rx"] = {"launches": counts["K3"], "max_abs_err": errs["K3"],
                   **k3_numbers(dfa, k3_calls[-1][0])}
    rec["K4rx"] = {"launches": counts["K4"],
                   "max_abs_err": errs["K4"],
                   **k4m_numbers(scatter, k4_batches[-8:])}
    print(f"phase reactor kernels: at the reactor's own inputs, each equal "
          f"to its plain version: K6 {list(ins6[0].shape)} k {ins6[3]} "
          f"{k6_text(rec['K6rx'])}; K1 {list(d['__cvalid__'].shape)} x "
          f"{list(d['__alive__'].shape)} {k1_text(rec['K1rx'])}; K3 "
          f"{k3_text(dfa, k3_calls[-1][0], rec['K3rx'])}; K4 batched "
          f"{rec['K4rx']['ms']:.4f} ms, device "
          f"{rec['K4rx']['device_ms']:.4f} (bound "
          f"{rec['K4rx']['bound_ms']:.6f}) over {n_k4} jobs in "
          f"{len(k4_batches)} calls", flush=True)
    steps["kernels_s"] = time.perf_counter() - t0
    print(f"phase reactor took {time.perf_counter() - t_phase:.1f}s: "
          f"cold build {t['cold']['total_seconds']:.1f}s, direct client "
          f"{steps['direct_s']:.1f}s, window {window_s:.1f}s, checks "
          f"{steps['checks_s']:.1f}s, rung-2 resync {gap_s:.1f}s, kernel "
          f"timing {steps['kernels_s']:.1f}s", flush=True)
    del direct, few, mgr, k1_calls, k3_calls, k5_calls, k6_calls


class RecordK123:
    """While entered, K1, K2 and K3 stand in under their modules' names
    by recording wrappers (``recording``): each call's arguments and
    result land in ``calls["K1"]``, ``["K2"]`` and ``["K3"]``, and each
    wrapper counts the launches."""

    def __init__(self):
        from gatekeeper_tpu_torch.kernels import dfa, ir_eval, topk
        self._slots = ((ir_eval, "eval_mask", "K1"),
                       (topk, "topk_packed", "K2"), (dfa, "dfa_table", "K3"))
        self.calls: dict[str, list] = {k: [] for *_, k in self._slots}
        self._orig: list = []

    def __enter__(self) -> "RecordK123":
        for mod, name, key in self._slots:
            fn = getattr(mod, name)
            self._orig.append((mod, name, fn))
            setattr(mod, name, recording(fn, self.calls[key]))
        return self

    def counts(self) -> dict:
        return {key: getattr(mod, name).launches
                for mod, name, key in self._slots}

    def __exit__(self, *exc) -> None:
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)
        self._orig.clear()


def check_k123(ex, calls: dict, what: str) -> dict:
    """Every recorded K1, K2 and K3 launch of ``calls`` (RecordK123)
    against its plain version on the same inputs: the largest error of
    each (0 or the run fails)."""
    from gatekeeper_tpu_torch.kernels import dfa, topk
    torch.cuda.synchronize()
    errs = {"K1": 0.0, "K2": 0, "K3": 0.0}
    for (program, d), out in calls["K1"]:
        want = ex._eval_mask(program, d)
        if not torch.equal(out, want):
            fail(f"{what}: K1 mismatch")
        errs["K1"] = max(errs["K1"], max_err(out, want))
    for (viol, rnk, k), out in calls["K2"]:
        errs["K2"] = max(errs["K2"], packed_err(
            out, topk.topk_packed_plain(viol, rnk, k), k))
    if errs["K2"]:
        fail(f"{what}: K2 mismatch")
    for ins, out in calls["K3"]:
        want = dfa.dfa_table_plain(*ins)
        if not torch.equal(out, want):
            fail(f"{what}: K3 mismatch")
        errs["K3"] = max(errs["K3"], max_err(out, want))
    return errs


def k123_entries(rec: dict, suffix: str, calls: dict, counts: dict,
                 errs: dict) -> None:
    """The kernels-line entries ``K1<suffix>``, ``K2<suffix>`` and
    ``K3<suffix>`` (those with recorded calls): each timed per call and
    device-only at the path's recorded inputs (K1 and K2 mean over its
    kinds), with its launches on the path and its error against plain.
    Every warm thread is joined first (a CUDA-graph capture fails while
    another thread launches)."""
    from gatekeeper_tpu_torch.engine import executor as ex
    from gatekeeper_tpu_torch.kernels import dfa, ir_eval, topk
    join_warms()
    if calls["K1"]:
        rec["K1" + suffix] = {"launches": counts["K1"],
                              "max_abs_err": errs["K1"],
                              **k1_family(ex, ir_eval, calls["K1"])}
    if calls["K2"]:
        k2 = collections.Counter()
        for (viol, rnk, k), _out in calls["K2"]:
            nums = k2_numbers(topk, viol, rnk, k)
            by = nums.pop("bound_by")
            k2.update({key: v / len(calls["K2"]) for key, v in nums.items()})
        rec["K2" + suffix] = {"launches": counts["K2"],
                              "max_abs_err": errs["K2"], **k2,
                              "bound_by": by}
    if calls["K3"]:
        rec["K3" + suffix] = {"launches": counts["K3"],
                              "max_abs_err": errs["K3"],
                              **k3_numbers(dfa, calls["K3"][0][0])}


FULL_SWEEP_OVERLAP_MAX = 0.05   # a full sweep's overlap_fraction, at most
FULL_SWEEPS = 2                 # forced full sweeps a store


def swept_bytes(drv) -> int:
    """The bytes a forced full sweep just uploaded: the sum of the kinds'
    ``Bindings.nbytes()``, and the shared dedup columns the sweep bound
    into each member kind it dispatched (they leave the bindings when
    the sweep ends)."""
    st = drv._state(TARGET)
    n = sum(b.nbytes() for _k, b in st.bindings_cache.values())
    memo = drv._dedup_plan_memo.get(TARGET)
    if memo is not None and drv.last_sweep_phases["dedup"].get("enabled"):
        plan = memo[1]
        n += sum(st.dedup_shared_cache[d][2].nbytes
                 for k in plan.rewritten if k in st.bindings_cache
                 and not st.bindings_cache[k][1].f32_unsafe
                 for d in plan.kind_digests[k])
    return n


def full_sweeps(drv, fns, want: list, what: str, need: tuple,
                record: dict | None = None) -> dict:
    """FULL_SWEEPS forced full sweeps (``QueryOpts(full=True)``, cap CAP)
    on ``drv``, each with the launch counts set to 0 just before it and
    read just after.  Each must return ``want`` (the memoized sweep's
    results, which the caller holds equal to
    ``TorchDriver(device="cpu")``'s), compile no Triton variant, launch
    each kernel of ``need``, report ``serial``, ``device_s`` > 0,
    ``h2d_bytes`` equal to ``swept_bytes`` and an ``overlap_fraction``
    under FULL_SWEEP_OVERLAP_MAX (the kinds
    run one at a time).  With ``record`` the last sweep's K1, K2 and K3
    calls are kept there (``calls``, ``counts``) and checked against
    their plain versions.  Returns the sweeps' wall seconds, launches and
    phases, in order."""
    from gatekeeper_tpu_torch.client.interface import QueryOpts
    from gatekeeper_tpu_torch.engine import executor as ex
    from gatekeeper_tpu_torch.kernels import ir_eval
    out: dict = {"sweeps": []}
    join_warms()
    for i in range(FULL_SWEEPS):
        last = i == FULL_SWEEPS - 1
        v0 = triton_variants(ir_eval)
        with RecordK123() if record is not None and last \
                else contextlib.nullcontext() as r:
            reset_counts(fns)
            t0 = time.perf_counter()
            res, _ = drv.query_audit(TARGET, QueryOpts(
                limit_per_constraint=CAP, full=True))
            wall = time.perf_counter() - t0
            counts = r.counts() if r is not None else {
                k: v for k, v in launch_counts(fns).items()
                if k in ("K1", "K2", "K3")}
        v1 = triton_variants(ir_eval)
        ph = drv.last_sweep_phases
        nbytes = swept_bytes(drv)
        if norm(res) != want:
            fail(f"{what}: full sweep {i}'s results differ from the "
                 f"memoized sweep's")
        if None in (v0, v1) or v1 != v0:
            fail(f"{what}: full sweep {i} compiled Triton variants ({v0} "
                 f"before, {v1} after)")
        if not ph.get("full") or ph["serial"] is not True \
                or ph["device_s"] <= 0 or ph["h2d_bytes"] != nbytes:
            fail(f"{what}: full sweep {i}'s phases {ph} (the kinds' "
                 f"bindings hold {nbytes} bytes)")
        if ph["overlap_fraction"] >= FULL_SWEEP_OVERLAP_MAX:
            fail(f"{what}: full sweep {i} overlapped "
                 f"{ph['overlap_fraction']}")
        if min(counts[k] for k in need) <= 0:
            fail(f"{what}: full sweep {i} launched {counts}, not each of "
                 f"{need}")
        att = ph.get("attribution") or {"templates": []}
        drift = [t["drift"] for t in att["templates"]
                 if t["drift"] is not None]
        out["sweeps"].append({
            "wall_s": round(wall, 4), "launches": counts,
            "phases": {k: v for k, v in ph.items()
                       if k not in ("pages", "devpages", "attribution")},
            "attribution": {
                "templates": len(att["templates"]),
                "device_s": att.get("device_s"),
                "drift": [min(drift), max(drift)] if drift else None}})
        if r is not None:
            record["calls"], record["counts"] = r.calls, counts
            record["errs"] = check_k123(ex, r.calls, what)
    return out


WORKER_PODS = 2_000
WORKER_CHURN = 40
WORKER_REVIEWS = 128
WORKER_REPLICAS = 2
WORKER_START_S = 300.0
WORKER_CONTEXT_MIN = 256 << 20   # card bytes a worker's context holds, at least


def worker_phase(rec: dict, fns: dict, oracle: AdmissionOracle) -> None:
    """The engine worker split on the card.  (a) An in-process
    ``EngineWorker`` (a fresh ``TorchDriver`` on the card at each
    ``init``, served on a thread) behind the manager built from
    ``parse_args([... "--engine-worker-url", <url>])``: the manager
    phase's policy, MANAGER_NAMESPACES namespaces and WORKER_PODS pods
    through the controllers and the HTTP seam (objects/s); a cold, a
    steady, a churned (WORKER_CHURN pods relabelled) and a ``full=True``
    ``audit_once``, each with the launch counts set to 0 just before it:
    K1, K2 and K3 launched cold (each recorded launch equal to its
    plain version), K4 and K5 and no full K1 churned, a forced full
    sweep in the worker (its phases); statuses equal to a direct capped
    audit on a second TorchDriver fed the cluster's stored objects;
    WORKER_REVIEWS CREATE reviews POSTed from MANAGER_THREADS threads
    (the shipped batch_mode auto: one scalar query a review through the
    worker), every answer equal to the oracle process's.  (b)
    ``ReplicaPool.spawn_workers(WORKER_REPLICAS)`` on the card: the
    card's used memory (``torch.cuda.mem_get_info``) grown by at least
    WORKER_CONTEXT_MIN a worker, both pids in ``nvidia-smi
    --query-compute-apps`` where it shows this pid namespace, a capped
    audit through the pool and through each replica equal to the direct
    client's, and
    WORKER_REVIEWS reviews through a ValidationHandler over the pool
    from MANAGER_THREADS threads at 1 replica and at 2 (reviews/s),
    every answer equal to the oracle's.  Then K1, K2 and K3 timed at
    (a)'s cold sweep's inputs."""
    from gatekeeper_tpu_torch.api.config import GVK
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.client.remote_driver import (EngineWorker,
                                                           RemoteDriver)
    from gatekeeper_tpu_torch.client.replica_pool import ReplicaPool
    from gatekeeper_tpu_torch.cmd.manager import Manager, parse_args
    from gatekeeper_tpu_torch.controllers.constrainttemplate import \
        TEMPLATE_GVK
    from gatekeeper_tpu_torch.engine import executor as ex
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.library.north_star import make_resources
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
    from gatekeeper_tpu_torch.webhook.policy import ValidationHandler

    from gatekeeper_tpu_torch.engine import torch_driver

    # every kind on the device in this process (K8sImageDigests' one
    # constraint included), as the phases before it leave it
    saved_small = torch_driver.SMALL_WORKLOAD_EVALS
    torch_driver.SMALL_WORKLOAD_EVALS = 0
    ns_gvk, pod_gvk = GVK("", "v1", "Namespace"), GVK("", "v1", "Pod")
    cfg, templates, constraints = manager_docs()
    kinds = sorted({t["spec"]["crd"]["spec"]["names"]["kind"]
                    for t in templates})
    pods = make_resources(WORKER_PODS, random.Random(MANAGER_SEED))
    reqs = manager_reviews()[:WORKER_REVIEWS]
    answers = oracle.result()[3]
    if answers is None:
        fail("worker: the oracle process gave no manager answers")
    answers = answers[:WORKER_REVIEWS]

    def check_answers(got, what: str) -> None:
        have = [response_digest(r) for r in got]
        if have != answers:
            bad = next(i for i, (a, b) in enumerate(zip(have, answers))
                       if a != b)
            fail(f"worker {what}: review {bad} answers {got[bad]['status']} "
                 f"unlike the per-review oracle")

    # -- (a) the manager over an in-process worker
    worker = EngineWorker(TorchDriver)
    worker.start()
    mgr = Manager(parse_args(["--port", "0", "--audit-interval", "3600",
                              "--engine-worker-url", worker.url]))
    if not isinstance(mgr.client.driver, RemoteDriver):
        fail(f"worker: the manager's driver is {mgr.client.driver}")
    mgr.start()
    try:
        cluster, drv = mgr.cluster, worker.driver
        if drv.device.type != "cuda":
            fail(f"worker: the worker's driver is on {drv.device}")
        added = [0]
        add_data = mgr.client.add_data

        def counting(obj):
            out = add_data(obj)
            added[0] += 1
            return out

        mgr.client.add_data = counting
        t0 = time.perf_counter()
        cluster.create(copy.deepcopy(cfg))
        for t in templates:
            cluster.create(copy.deepcopy(t))
        for c in constraints:
            cluster.create(copy.deepcopy(c))
        wait_until(lambda: sum(len(v) for v in mgr.client.constraints
                               .values()) == len(constraints)
                   and mgr.plane.watch_manager.watched_gvks() >=
                   {ns_gvk, pod_gvk}, "the templates and constraints")
        policy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(MANAGER_NAMESPACES):
            cluster.create({"apiVersion": "v1", "kind": "Namespace",
                            "metadata": {"name": f"ns{i}"}})
        for p in pods:
            cluster.create(copy.deepcopy(p))
        n_objs = MANAGER_NAMESPACES + WORKER_PODS
        st = drv._state(TARGET)
        wait_until(lambda: st.table.n_rows >= n_objs, "the ingest")
        ingest_s = time.perf_counter() - t0
        quiet(mgr, added)
        if st.table.n_rows != n_objs:
            fail(f"worker: the worker's store holds {st.table.n_rows} "
                 f"objects, not {n_objs}")
        print(f"phase worker ingest: {len(constraints)} constraints "
              f"reconciled into the worker in {policy_s:.4f}s; "
              f"{n_objs} objects synced through the controllers and the "
              f"worker's HTTP seam in {ingest_s:.4f}s = "
              f"{n_objs / ingest_s:.1f} objects/s ({added[0]} add_data "
              f"calls)", flush=True)

        direct = Backend(TorchDriver()).new_client([K8sValidationTarget()])
        for t in cluster.list(TEMPLATE_GVK):
            direct.add_template(t)
        for kind in kinds:
            for c in cluster.list(GVK("constraints.gatekeeper.sh",
                                      "v1alpha1", kind)):
                direct.add_constraint(c)
        direct.add_data_batch(cluster.list(ns_gvk) + cluster.list(pod_gvk))

        def check_statuses(what: str) -> int:
            got = constraint_statuses(cluster, kinds)
            want = direct_statuses(direct, got)
            bad = [k for k in got if got[k] != want[k]]
            if len(got) != len(constraints) or bad:
                fail(f"worker {what}: {len(bad)} of {len(got)} constraints' "
                     f"written status.violations differ from the direct "
                     f"client's")
            return sum(len(v or ()) for v in got.values())

        # cold, recording K1, K2 and K3 in the worker's driver
        with RecordK123() as r:
            reset_counts(fns)
            cold = mgr.audit.audit_once()
            cold_counts = r.counts()
        cold_calls = r.calls
        if min(cold_counts.values()) <= 0:
            fail(f"worker: the cold audit_once launched {cold_counts}")
        errs = check_k123(ex, cold_calls, "worker cold audit")
        n_viol = check_statuses("cold audit")
        drv.wait_delta_warm()
        steady = mgr.audit.audit_once()
        check_statuses("steady audit")

        churn_rng = random.Random(MANAGER_SEED + 2)
        label_pool = [f"l{j}" for j in range(10)]
        before = added[0]
        changed = []
        for i in churn_rng.sample(range(WORKER_PODS), WORKER_CHURN):
            meta = pods[i]["metadata"]
            obj = cluster.get(pod_gvk, meta["name"], meta["namespace"])
            old = obj["metadata"].get("labels") or {}
            new = old
            while new == old:
                new = {k: "v" for k in label_pool
                       if churn_rng.random() < 0.35}
            obj["metadata"]["labels"] = new
            changed.append(cluster.update(obj))
        wait_until(lambda: added[0] >= before + WORKER_CHURN, "the churn")
        quiet(mgr, added)
        for o in changed:
            direct.add_data(cluster.get(pod_gvk, o["metadata"]["name"],
                                        o["metadata"]["namespace"]))
        reset_counts(fns)
        churned = mgr.audit.audit_once()
        churn_counts = launch_counts(fns)
        if churn_counts["K1"] or churn_counts["K5"] <= 0 \
                or max(churn_counts["K4"], churn_counts["K4m"]) <= 0:
            fail(f"worker: the churned audit_once did not take the delta "
                 f"plan: launches {churn_counts}")
        check_statuses("churned audit")

        reset_counts(fns)
        full = mgr.audit.audit_once(full=True)
        full_counts = {k: v for k, v in launch_counts(fns).items()
                       if k in ("K1", "K2", "K3")}
        ph = drv.last_sweep_phases
        if min(full_counts.values()) <= 0 or not ph.get("full") \
                or ph["device_s"] <= 0:
            fail(f"worker: audit_once(full=True) ran no forced full sweep "
                 f"in the worker: launches {full_counts}, phases "
                 f"{ {k: v for k, v in ph.items() if k != 'pages'} }")
        check_statuses("full audit")
        print(f"phase worker audit: audit_once through the worker, eval + "
              f"write: cold {cold['eval_seconds']:.4f} + "
              f"{cold['write_seconds']:.4f}s (launches {cold_counts}), "
              f"steady {steady['eval_seconds']:.4f} + "
              f"{steady['write_seconds']:.4f}s, churned "
              f"{churned['eval_seconds']:.4f} + "
              f"{churned['write_seconds']:.4f}s (launches "
              f"{ {k: v for k, v in churn_counts.items() if v} }), "
              f"full=True {full['eval_seconds']:.4f} + "
              f"{full['write_seconds']:.4f}s (launches {full_counts}; the "
              f"worker's phases host_prep {ph['host_prep_s']} h2d "
              f"{ph['h2d_s']} device {ph['device_s']} format "
              f"{ph['format_s']} wall {ph['pipeline_wall_s']} overlap "
              f"{ph['overlap_fraction']}); {n_viol} status violations "
              f"equal to the direct client's after each", flush=True)

        got, lat, wall, errors = post_all(mgr.webhook.port, reqs)
        if errors:
            fail(f"worker: admission requests failed: {errors[:3]}")
        check_answers(got, "admission")
        print(f"phase worker admission: {len(reqs)} reviews POSTed from "
              f"{MANAGER_THREADS} threads (batch_mode auto, one query a "
              f"review through the worker) in {wall:.4f}s = "
              f"{len(reqs) / wall:.1f} reviews/s, p50 "
              f"{quantile(lat, 0.5) * 1e3:.2f} ms p99 "
              f"{quantile(lat, 0.99) * 1e3:.2f} ms; every answer equals "
              f"the per-review oracle", flush=True)
        direct_res = norm(direct.audit(limit_per_constraint=CAP).results())
        direct.driver.wait_delta_warm()
        objs = cluster.list(ns_gvk) + cluster.list(pod_gvk)
    finally:
        mgr.stop()
        worker.stop()
    join_warms()
    k123_entries(rec, "wk", cold_calls, cold_counts, errs)
    del mgr, worker, drv, st, direct, cold_calls, r

    # -- (b) a pool of worker processes on the card
    def compute_apps() -> list:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
        return [ln.strip() for ln in out.splitlines() if ln.strip()]

    apps0 = compute_apps()
    free0, _total = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    pool = ReplicaPool.spawn_workers(WORKER_REPLICAS, timeout=WORKER_START_S)
    try:
        start_s = time.perf_counter() - t0
        pids = [p.pid for p in pool._procs]
        client = Backend(pool).new_client([K8sValidationTarget()])
        for t in templates:
            client.add_template(t)
        for c in constraints:
            client.add_constraint(c)
        t0 = time.perf_counter()
        client.add_data_batch(objs)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pooled = client.audit(limit_per_constraint=CAP).results()
        audit_s = time.perf_counter() - t0
        if norm(pooled) != direct_res:
            fail("worker pool: the capped audit through the pool differs "
                 "from the direct client's on the same objects")
        # each replica audits on its own card context too (the pool's
        # audit ran on one of them)
        full_pool = pool.drivers
        for d in full_pool:
            pool.drivers = [d]
            if norm(client.audit(limit_per_constraint=CAP).results()) \
                    != direct_res:
                fail(f"worker pool: replica {d.url} audits unlike the "
                     f"direct client")
        pool.drivers = full_pool
        # each worker holds a CUDA context of its own: the card's used
        # memory grows by at least WORKER_CONTEXT_MIN a worker, and where
        # nvidia-smi shows this process's pid namespace (a container may
        # list every process under one pid) both pids are listed
        free1, _total = torch.cuda.mem_get_info()
        apps = compute_apps()
        listed = [ln.split(",")[0].strip() for ln in apps]
        if free0 - free1 < WORKER_REPLICAS * WORKER_CONTEXT_MIN or (
                len(set(listed)) == len(listed)
                and not {str(p) for p in pids} <= set(listed)):
            fail(f"worker pool: the card's used memory grew "
                 f"{free0 - free1} bytes with {WORKER_REPLICAS} workers "
                 f"{pids}; nvidia-smi compute apps {apps} (before the "
                 f"spawn {apps0})")
        rates = {}
        handler = ValidationHandler(client)
        for n in (1, WORKER_REPLICAS):
            pool.drivers = full_pool[:n]
            got = [None] * len(reqs)
            errors: list = []

            def serve(w):
                try:
                    for i in range(w, len(reqs), MANAGER_THREADS):
                        got[i] = handler.handle(reqs[i])
                except Exception as e:      # noqa: BLE001 — reported below
                    errors.append(repr(e))

            threads = [threading.Thread(target=serve, args=(w,))
                       for w in range(MANAGER_THREADS)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
            rates[n] = len(reqs) / (time.perf_counter() - t0)
            if errors:
                fail(f"worker pool: reviews failed: {errors[:3]}")
            check_answers(got, f"pool of {n}")
        pool.drivers = full_pool
        print(f"phase worker pool: {WORKER_REPLICAS} worker processes on "
              f"the card (pids {pids}; the card's used memory "
              f"{free0 - free1} bytes more than before the spawn; "
              f"nvidia-smi compute apps {apps0} before, {apps} after) up in "
              f"{start_s:.2f}s; each replica's capped audit equal to the "
              f"direct client's; the store "
              f"broadcast in {load_s:.4f}s; a capped audit through the pool "
              f"{audit_s:.4f}s, {len(pooled)} results as the direct "
              f"client's; {len(reqs)} reviews from {MANAGER_THREADS} "
              f"threads through a ValidationHandler over the pool: "
              + ", ".join(f"{n} replica{'s' if n > 1 else ''} "
                          f"{rates[n]:.1f} reviews/s" for n in rates)
              + "; every answer equals the per-review oracle", flush=True)
    finally:
        pool.close()
    torch_driver.SMALL_WORKLOAD_EVALS = saved_small


EXT_SIG_REGO = """package k8sextsig
violation[{"msg": msg}] {
  image := input.review.object.spec.image
  verdict := object.get(external_data({"provider": "bench-sig", "keys": [image]}), ["responses", image], "missing")
  verdict == "invalid"
  msg := sprintf("image %v rejected: %v", [image, verdict])
}
"""
EXT_ROWS = 2_000            # bench.py's external-data row (:1006-1110)
EXT_KEYS = 256
EXT_LATENCY_S = 0.02        # the fake provider's round trip
EXT_TTL_S = 600.0
EXT_WARM_SWEEPS = 3
EXT_LARGE_PODS = 20_000     # K8sExtSig alone, a large cluster's pods
EXT_LARGE_KEYS = 4_096      # the registry's images a large cluster pulls
EXT_REVIEWS = 64            # one admission batch
EXT_REVIEW_KEYS = 32
EXT_STATS_KEYS = ["breaker_state", "breaker_transitions", "cache_entries",
                  "cache_evictions", "cache_hit_ratio", "fetch_batches",
                  "fetch_errors", "fetch_keys", "fetch_seconds",
                  "short_circuits"]   # the reference runtime's stats()
EXT_BULK_KEYS = ["keys", "prefetch_s", "providers"]


def ext_verdicts(images: list) -> dict:
    """The provider's data: 1 image in 10 marked ``invalid``."""
    return {img: ("invalid" if i % 10 == 0 else "valid")
            for i, img in enumerate(images)}


def ext_expected(objs: list, data: dict) -> dict:
    """(namespace, name) -> message of every pod whose image the
    provider's data marks invalid: K8sExtSig's violations, computed from
    the data alone."""
    out = {}
    for o in objs:
        if o.get("kind") != "Pod":
            continue
        img = (o.get("spec") or {}).get("image")
        if data.get(img) == "invalid":
            md = o["metadata"]
            out[(md.get("namespace"), md["name"])] = \
                f"image {img} rejected: invalid"
    return out


def ext_hits(results) -> dict:
    """(namespace, name) -> message of K8sExtSig's results."""
    out = {}
    for r in results:
        if r.constraint["kind"] == "K8sExtSig":
            rv = r.review or {}
            out[(rv.get("namespace"), rv.get("name"))] = r.msg
    return out


def ext_check(results, want: dict, what: str, cap: int | None) -> int:
    """K8sExtSig's violations are exactly the invalid-image pods (capped:
    ``cap`` of them, each one of them); the count found."""
    got = ext_hits(results)
    if cap is None:
        if got != want:
            fail(f"{what}: {len(got)} K8sExtSig violations, "
                 f"{len(want)} pods with an invalid image "
                 f"({len(set(got) ^ set(want))} differ)")
    elif len(got) != min(cap, len(want)) or any(
            want.get(k) != m for k, m in got.items()):
        fail(f"{what}: {len(got)} capped K8sExtSig violations, not "
             f"{min(cap, len(want))} of the {len(want)} invalid-image pods")
    return len(got)


def ext_others(results) -> list:
    return [x for x in norm(results) if x[0] != "K8sExtSig"]


class ProviderServer:
    """An external-data provider on ``127.0.0.1`` (the batched JSON POST
    of the reference provider protocol), served by ``http.server`` on a
    thread of this process; ``posts`` counts its batched rounds."""

    def __init__(self, data: dict):
        import http.server
        self.data, self.posts = data, 0
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                keys = json.loads(self.rfile.read(n))["request"]["keys"]
                items = [{"key": k, "value": server.data[k]}
                         if k in server.data else
                         {"key": k, "error": "unknown key"} for k in keys]
                body = json.dumps({
                    "apiVersion": "externaldata.gatekeeper.sh/v1beta1",
                    "kind": "ProviderResponse",
                    "response": {"items": items}}).encode()
                server.posts += 1
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *_a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       name="provider-server", daemon=True)
        self.thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()


def gated_batcher(base, n: int):
    """A ``MicroBatcher`` subclass whose worker forms its batch only once
    ``n`` requests are queued (the class's own window engages only for a
    singleton queue, so concurrent submits would split): one admission
    batch of ``n`` reviews, deterministically.  The wait releases the
    batcher's lock, so submits keep landing."""
    class Gated(base):
        def _take_batch(self, now):
            while len(self._queue) < n and not self._stop:
                self._wake.wait(0.05)
            return super()._take_batch(time.monotonic())
    return Gated


def extdata_phase(rec: dict, fns: dict) -> None:
    """External data on the card: bench.py's external-data row at its
    full size, a large registry, the real wire and an admission batch.
    Every sweep is a forced full sweep (cap CAP) with the small-workload
    threshold at 0, as the bench runs it.

    (a) EXT_ROWS ``make_mixed(Random(11))`` resources under the 48
    library templates, pods' images drawn from EXT_KEYS keys (1 in 10
    ``invalid``): the baseline without the external template (best of
    3), then with ``K8sExtSig`` and a ``FakeProvider`` (EXT_LATENCY_S,
    Ignore, retries 0, TTL EXT_TTL_S): a cold sweep after re-registering
    the provider (exactly one batched round), EXT_WARM_SWEEPS warm ones
    (no round, no Triton compile, results equal the cold sweep's, every
    other kind's equal the baseline's), the ``external`` stanza with the
    reference's keys; K8sExtSig's violations exactly the invalid-image
    pods, capped here and uncapped on a driver of K8sExtSig alone.
    (b) K8sExtSig alone over EXT_LARGE_PODS pods drawing from
    EXT_LARGE_KEYS images: one cold (one round of every key) and one
    warm sweep, the same exact check.  (c) The real wire: a provider on
    ``127.0.0.1`` (``ProviderServer``); a cold sweep through the
    runtime's HTTP transport equal to the warm sweep; the server
    stopped: Ignore completes and opens the breaker, Fail counts one
    ``external_data_kind_failures`` and every other kind's results equal
    the warm sweep's.  (d) EXT_REVIEWS pod reviews through a
    ``ValidationHandler`` over a ``MicroBatcher`` with the client's
    prefetch hook: one provider round a formed batch, each key fetched
    once, answers equal to the per-review scalar answers.  K1 and K2
    are recorded on (b)'s warm sweep, K3 on (a)'s last warm sweep, each
    launch held against its plain version."""
    from gatekeeper_tpu_torch.api.externaldata import Provider
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.client.interface import QueryOpts
    from gatekeeper_tpu_torch.engine import executor as ex
    from gatekeeper_tpu_torch.engine import torch_driver
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.externaldata.fake import (FakeProvider,
                                                        clear_fakes,
                                                        register_fake)
    from gatekeeper_tpu_torch.externaldata.runtime import (
        ExternalDataRuntime, set_runtime)
    from gatekeeper_tpu_torch.kernels import ir_eval
    from gatekeeper_tpu_torch.library import all_docs, make_mixed
    from gatekeeper_tpu_torch.library.templates import (constraint_doc,
                                                        template_doc)
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
    from gatekeeper_tpu_torch.webhook.batcher import MicroBatcher
    from gatekeeper_tpu_torch.webhook.policy import ValidationHandler
    t_phase = time.perf_counter()
    rng = random.Random(11)
    resources = make_mixed(rng, EXT_ROWS)
    images = [f"registry.example/app{i}:v1" for i in range(EXT_KEYS)]
    n_pods = 0
    for r in resources:
        if r.get("kind") == "Pod":
            r["spec"]["image"] = rng.choice(images)
            n_pods += 1
    data = ext_verdicts(images)
    want = ext_expected(resources, data)
    full = QueryOpts(limit_per_constraint=CAP, full=True)
    uncapped = QueryOpts(limit_per_constraint=None, full=True)
    pod_match = {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}

    def client(library: bool, ext: bool, objs: list):
        drv = TorchDriver()
        c = Backend(drv).new_client([K8sValidationTarget()])
        if library:
            for tdoc, cdoc in all_docs():
                c.add_template(tdoc)
                c.add_constraint(cdoc)
        if ext:
            c.add_template(template_doc("K8sExtSig", EXT_SIG_REGO))
            c.add_constraint(constraint_doc("K8sExtSig", "bench-sig-check",
                                            match=pod_match))
        c.add_data_batch(objs)
        return drv, c

    def sweep(drv, opts=full):
        t0 = time.perf_counter()
        res, _ = drv.query_audit(TARGET, opts)
        return time.perf_counter() - t0, res

    def settle(drv):
        drv.wait_delta_warm()
        join_warms()

    saved = torch_driver.SMALL_WORKLOAD_EVALS
    torch_driver.SMALL_WORKLOAD_EVALS = 0
    prev_rt = set_runtime(None)
    server = None
    try:
        # -- (a) the bench row: baseline, cold, warm
        base, _bc = client(True, False, resources)
        sweep(base)                                  # compile warm
        settle(base)
        base_runs = [sweep(base) for _ in range(3)]
        base_s = min(s for s, _ in base_runs)
        base_others = ext_others(base_runs[-1][1])
        del base, _bc, base_runs

        rt = ExternalDataRuntime()
        set_runtime(rt)
        fake = register_fake("bench-sig", FakeProvider(
            data, latency_s=EXT_LATENCY_S))
        provider = Provider(name="bench-sig", url="fake://bench-sig",
                            failure_policy="Ignore", retries=0,
                            cache_ttl_s=EXT_TTL_S)
        rt.register(provider)
        drv, c = client(True, True, resources)
        sweep(drv)                                   # compile warm (+fetch)
        settle(drv)
        rt.register(provider)            # re-register: drops cache -> cold
        calls0 = fake.calls
        cold_s, cold_res = sweep(drv)
        cold_rounds = fake.calls - calls0
        ext = drv.last_sweep_phases.get("external") or {}
        if cold_rounds != 1:
            fail(f"extdata: the cold sweep fetched in {cold_rounds} rounds")
        if sorted(ext) != ["bulk_prefetch", "providers"] or \
                sorted(ext["providers"]["bench-sig"]) != EXT_STATS_KEYS or \
                sorted(ext["bulk_prefetch"]) != EXT_BULK_KEYS or \
                ext["bulk_prefetch"]["keys"] != len(
                    {(r.get("spec") or {}).get("image") for r in resources}
                    - {None}):
            fail(f"extdata: the external stanza {ext}")
        cold_stanza = ext
        n_capped = ext_check(cold_res, want, "extdata cold", CAP)
        if ext_others(cold_res) != base_others:
            fail("extdata: the other kinds' results differ from the "
                 "baseline's")
        settle(drv)
        warm_s, rec3 = [], {}
        v0 = triton_variants(ir_eval)
        for i in range(EXT_WARM_SWEEPS):
            last = i == EXT_WARM_SWEEPS - 1
            with RecordK123() if last else contextlib.nullcontext() as r:
                reset_counts(fns)
                s, res = sweep(drv)
                if r is not None:
                    counts3 = r.counts()
            warm_s.append(s)
            if norm(res) != norm(cold_res):
                fail(f"extdata: warm sweep {i}'s results differ from the "
                     "cold sweep's")
            if r is not None:
                rec3 = {"calls": r.calls, "counts": counts3,
                        "errs": check_k123(ex, r.calls, "extdata warm")}
        v1 = triton_variants(ir_eval)
        warm_res = res
        if None in (v0, v1) or v1 != v0:
            fail(f"extdata: the warm sweeps compiled Triton variants ({v0} "
                 f"before, {v1} after)")
        if fake.calls != calls0 + 1:
            fail(f"extdata: the warm sweeps fetched ({fake.calls - calls0 - 1}"
                 " rounds)")
        if min(rec3["counts"].values()) <= 0:
            fail(f"extdata: the warm sweep launched {rec3['counts']}")
        warm_best = min(warm_s)
        overhead = warm_best / base_s - 1.0
        # uncapped: exactly the invalid-image pods (K8sExtSig alone)
        alone, _ac = client(False, True, resources)
        _s, alone_res = sweep(alone, uncapped)
        n_exact = ext_check(alone_res, want, "extdata uncapped", None)
        del alone, _ac, alone_res
        print(f"phase extdata: {EXT_ROWS} resources ({n_pods} pods, "
              f"{EXT_KEYS} keys, {len(want)} with an invalid image), "
              f"provider latency {EXT_LATENCY_S * 1e3:.0f} ms; forced full "
              f"sweeps: baseline {base_s:.4f} s, cold {cold_s:.4f} s "
              f"({cold_rounds} batched round), warm best {warm_best:.4f} s "
              f"of {[round(x, 4) for x in warm_s]} (overhead "
              f"{overhead:+.2%} against the baseline; the reference's "
              f"claim is under 10%), no Triton compile ({v1} variants); "
              f"K8sExtSig {n_capped} capped and {n_exact} uncapped "
              f"violations, exactly the invalid-image pods; warm launches "
              f"{rec3['counts']}; cold external stanza "
              f"{json.dumps(cold_stanza)}", flush=True)

        # -- (c) the real wire, then the outage
        server = ProviderServer(data)
        wire = Provider(name="bench-sig", url=server.url,
                        failure_policy="Ignore", retries=0, timeout_s=5.0,
                        cache_ttl_s=EXT_TTL_S)
        rt.register(wire)
        http_s, http_res = sweep(drv)
        if norm(http_res) != norm(warm_res) or server.posts != 1:
            fail(f"extdata: the HTTP provider's sweep ({server.posts} "
                 f"posts) differs from the warm sweep")
        server.stop()
        posts, server = server.posts, None
        rt.register(Provider(name="bench-sig", url=wire.url,
                             failure_policy="Ignore", retries=0,
                             timeout_s=1.0, breaker_threshold=1))
        out_s, out_res = sweep(drv)
        breaker = rt.stats()["bench-sig"]["breaker_state"]
        if ext_hits(out_res) or ext_others(out_res) != ext_others(warm_res) \
                or breaker != "open":
            fail(f"extdata: outage under Ignore: {len(ext_hits(out_res))} "
                 f"K8sExtSig results, breaker {breaker}")
        failures = drv.metrics.counter("external_data_kind_failures")
        f0 = failures.value
        rt.register(Provider(name="bench-sig", url=wire.url,
                             failure_policy="Fail", retries=0,
                             timeout_s=1.0, breaker_threshold=1))
        fail_s, fail_res = sweep(drv)
        if failures.value - f0 != 1 or ext_hits(fail_res) or \
                ext_others(fail_res) != ext_others(warm_res):
            fail(f"extdata: outage under Fail: "
                 f"{failures.value - f0} kind failures, "
                 f"{len(ext_hits(fail_res))} K8sExtSig results")
        print(f"phase extdata wire: {wire.url} ({posts} batched POST) "
              f"{http_s:.4f} s, results equal the warm sweep's; server "
              f"stopped: Ignore {out_s:.4f} s, breaker {breaker}; Fail "
              f"{fail_s:.4f} s, external_data_kind_failures +1, every "
              f"other kind's results equal", flush=True)

        # -- (d) one admission batch through the handler and the batcher
        rev_images = [f"registry.example/adm{i}:v1"
                      for i in range(EXT_REVIEW_KEYS)]
        rev_data = {img: ("invalid" if i % 4 == 0 else "valid")
                    for i, img in enumerate(rev_images)}
        fake_adm = register_fake("bench-sig-adm", FakeProvider(
            rev_data, latency_s=EXT_LATENCY_S))
        rt.register(Provider(name="bench-sig", url="fake://bench-sig-adm",
                             failure_policy="Ignore", retries=0,
                             cache_ttl_s=EXT_TTL_S))
        pods = [r for r in resources if r.get("kind") == "Pod"]
        reviews = []
        for i in range(EXT_REVIEWS):
            obj = copy.deepcopy(pods[i % len(pods)])
            obj["metadata"]["name"] = f"adm-{i:03d}"
            obj["spec"]["image"] = rev_images[i % EXT_REVIEW_KEYS]
            reviews.append({
                "uid": f"u{i}", "kind": {"group": "", "version": "v1",
                                         "kind": "Pod"},
                "operation": "CREATE", "name": obj["metadata"]["name"],
                "namespace": obj["metadata"].get("namespace"),
                "userInfo": {"username": "alice", "groups": []},
                "object": obj})
        batcher = gated_batcher(MicroBatcher, EXT_REVIEWS)(
            c.review_batch, max_batch=EXT_REVIEWS,
            prefetch=c.prefetch_external)
        handler = ValidationHandler(c, batcher=batcher, batch_mode="always")
        answers: list = [None] * EXT_REVIEWS

        def post(i):
            answers[i] = handler.handle(reviews[i])
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(EXT_REVIEWS)]
        batcher.start()
        t0 = time.perf_counter()
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            adm_s = time.perf_counter() - t0
        finally:
            batcher.stop()
        batches = batcher.metrics.counter("admission_batches").value
        fetched = sorted(sum(fake_adm.batches, []))
        if batches != 1 or fake_adm.calls != 1 or \
                fetched != sorted(rev_images):
            fail(f"extdata admission: {fake_adm.calls} provider rounds for "
                 f"{batches} batches, keys {len(fetched)}")
        scalar = ValidationHandler(c)
        want_ans = [scalar.handle(rv) for rv in reviews]

        def ans(resp):
            st = resp.get("status") or {}
            return resp["allowed"], st.get("code"), st.get("message")
        if [ans(a) for a in answers] != [ans(a) for a in want_ans]:
            fail("extdata admission: the batch's answers differ from the "
                 "per-review scalar answers")
        denied = sum(1 for a in answers
                     if "rejected: invalid" in (ans(a)[2] or ""))
        if denied != sum(1 for rv in reviews
                         if rev_data[rv["object"]["spec"]["image"]]
                         == "invalid"):
            fail(f"extdata admission: {denied} reviews denied by K8sExtSig")
        print(f"phase extdata admission: {EXT_REVIEWS} pod reviews in "
              f"{batches} batch(es), {fake_adm.calls} provider round(s) of "
              f"{len(fetched)} keys, {adm_s:.4f} s; answers equal the "
              f"per-review scalar answers ({denied} denied by K8sExtSig)",
              flush=True)
        del drv, c, handler, batcher, scalar

        # -- (b) a large registry: K8sExtSig alone
        rngl = random.Random(12)
        images_l = [f"registry.example/large{i}:v1"
                    for i in range(EXT_LARGE_KEYS)]
        data_l = ext_verdicts(images_l)
        objs_l = [{"apiVersion": "v1", "kind": "Pod",
                   "metadata": {"name": f"pod-{i:05d}",
                                "namespace": f"ns-{i % 100:02d}"},
                   "spec": {"image": rngl.choice(images_l)}}
                  for i in range(EXT_LARGE_PODS)]
        want_l = ext_expected(objs_l, data_l)
        fake_l = register_fake("bench-sig-large", FakeProvider(
            data_l, latency_s=EXT_LATENCY_S))
        large = Provider(name="bench-sig", url="fake://bench-sig-large",
                         failure_policy="Ignore", retries=0,
                         cache_ttl_s=EXT_TTL_S)
        rt.register(large)
        dl, _cl = client(False, True, objs_l)
        v0 = triton_variants(ir_eval)
        cold_l, res_l = sweep(dl)
        v1 = triton_variants(ir_eval)
        bulk = dl.last_sweep_phases["external"]["bulk_prefetch"]
        n_keys = len({o["spec"]["image"] for o in objs_l})
        if fake_l.calls != 1 or bulk["keys"] != n_keys:
            fail(f"extdata large: {fake_l.calls} rounds, bulk {bulk}")
        ext_check(res_l, want_l, "extdata large cold", CAP)
        settle(dl)              # the delta warm compiles K5's variant
        v1 = triton_variants(ir_eval)
        with RecordK123() as r:
            reset_counts(fns)
            warm_l, res_wl = sweep(dl)
            counts_l = r.counts()
        v2 = triton_variants(ir_eval)
        errs_l = check_k123(ex, r.calls, "extdata large warm")
        if v2 != v1 or fake_l.calls != 1 or norm(res_wl) != norm(res_l) \
                or min(counts_l["K1"], counts_l["K2"]) <= 0:
            fail(f"extdata large: the warm sweep compiled {v2 - v1} "
                 f"variants, fetched {fake_l.calls - 1} rounds, launched "
                 f"{counts_l}")
        _s, all_l = sweep(dl, uncapped)
        n_exact_l = ext_check(all_l, want_l, "extdata large uncapped", None)
        print(f"phase extdata large: K8sExtSig over {EXT_LARGE_PODS} pods, "
              f"{n_keys} of {EXT_LARGE_KEYS} images; cold {cold_l:.4f} s "
              f"({v1 - v0} Triton variants with the delta warm's, 1 round; "
              f"bulk prefetch "
              f"{bulk['keys']} keys in {bulk['prefetch_s']:.4f} s), warm "
              f"{warm_l:.4f} s (no round, no compile), launches "
              f"{counts_l}; {n_exact_l} uncapped violations, exactly the "
              f"invalid-image pods", flush=True)
        calls1 = {"K1": r.calls["K1"], "K2": r.calls["K2"],
                  "K3": rec3["calls"]["K3"]}
        k123_entries(rec, "ext", calls1,
                     {"K1": counts_l["K1"], "K2": counts_l["K2"],
                      "K3": rec3["counts"]["K3"]},
                     {"K1": errs_l["K1"], "K2": errs_l["K2"],
                      "K3": rec3["errs"]["K3"]})
        print(f"phase extdata kernels: K1 {k1_text(rec['K1ext'])} and K2 "
              f"{k2_text(rec['K2ext'])} at the large sweep's mask "
              f"{list(calls1['K1'][0][1].shape)} (K2 bound "
              f"{rec['K2ext']['bound_ms']:.6f}), K3 at the library "
              f"sweep's table {list(calls1['K3'][0][1].shape)} "
              f"({rec['K3ext']['ms']:.4f} ms, device "
              f"{rec['K3ext']['device_ms']:.4f}, plain "
              f"{rec['K3ext']['plain_ms']:.4f}, bound "
              f"{rec['K3ext']['bound_ms']:.6f}); each recorded launch "
              f"equal to its plain version", flush=True)
        del dl, _cl, r, rec3, calls1
    finally:
        if server is not None:
            server.stop()
        torch_driver.SMALL_WORKLOAD_EVALS = saved
        set_runtime(prev_rt)
        clear_fakes()
    print(f"phase extdata took {time.perf_counter() - t_phase:.1f}s",
          flush=True)


PROBE_COST_N = "2000"


def probe_phase(fns: dict) -> None:
    """The probe on the card (``gatekeeper_tpu_torch.client.probe``):
    ``main([])`` builds a LocalDriver and a TorchDriver on the card and
    every scenario must pass on both (rc 0, the verdict naming the
    card); ``main(["--cost"])`` with GATEKEEPER_COST_PROBE_N=2000 builds
    the library over 2,000 rows and measures a forced full sweep: rc 0
    (no unit budget set), K1, K2 and K3 launched, each recorded launch
    equal to its plain version, its measured ``device_s`` printed."""
    import io
    import re
    from gatekeeper_tpu_torch.client import probe
    from gatekeeper_tpu_torch.engine import executor as ex
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = probe.main([])
    out = buf.getvalue().splitlines()
    ok = {label: sum(1 for line in out
                     if line.startswith(f"  ok   [{label}]"))
          for label in ("local", "torch")}
    verdict = out[-1] if out else ""
    if rc != 0 or ok != {"local": 12, "torch": 12} or \
            verdict != f"PROBE PASS (torch engine served by: cuda:0)":
        fail(f"probe: rc {rc}, scenarios passed {ok}, verdict {verdict!r}")
    t1 = time.perf_counter()
    saved = {k: os.environ.get(k) for k in ("GATEKEEPER_COST_PROBE_N",
                                            "GATEKEEPER_COST_BUDGET_UNITS")}
    os.environ["GATEKEEPER_COST_PROBE_N"] = PROBE_COST_N
    os.environ.pop("GATEKEEPER_COST_BUDGET_UNITS", None)
    buf = io.StringIO()
    try:
        with RecordK123() as r, contextlib.redirect_stdout(buf):
            reset_counts(fns)
            rc_cost = probe.main(["--cost"])
            counts = r.counts()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    join_warms()
    errs = check_k123(ex, r.calls, "probe --cost")
    text = buf.getvalue()
    m = re.search(r"measured device_s=([0-9.]+)", text)
    if rc_cost != 0 or m is None or min(counts.values()) <= 0:
        fail(f"probe --cost: rc {rc_cost} (predicted 0), launches {counts}, "
             f"tail {text.splitlines()[-1:]}")
    print(f"phase probe: main([]) rc 0 in {t1 - t0:.1f}s, {ok} scenarios "
          f"passed, {verdict!r}; --cost (N={PROBE_COST_N}) rc {rc_cost} "
          f"in {time.perf_counter() - t1:.1f}s, measured device_s "
          f"{m.group(1)}, launches {counts} (max error {errs}); "
          f"{text.splitlines()[-1]}", flush=True)


REUSE_ROWS = 2_000         # bench.py's analysis and churn_selective rows
REUSE_CHURN = REUSE_ROWS // 100
WHATIF_ROWS = 10_000       # bench.py's what-if row is 20,000 (PERF.md §4)
WHATIF_REVIEWS = 64        # the recorded admission stream
GRADUATE_ROWS = 1_000      # rows of each of graduate_fleet's 4 clusters
REUSE_TIMED = 8            # distinct programs timed a kernel family


class RecordBatched:
    """While entered, K1b, K2b and K3b stand in under their modules' names
    by recording wrappers, as RecordK123 does for K1, K2 and K3."""

    def __init__(self):
        from gatekeeper_tpu_torch.kernels import dfa, ir_eval, topk
        self._slots = ((ir_eval, "eval_mask_batched", "K1b"),
                       (topk, "topk_packed_batched", "K2b"),
                       (dfa, "dfa_table_batched", "K3b"))
        self.calls: dict[str, list] = {k: [] for *_, k in self._slots}
        self._orig: list = []

    def __enter__(self) -> "RecordBatched":
        for mod, name, key in self._slots:
            fn = getattr(mod, name)
            self._orig.append((mod, name, fn))
            setattr(mod, name, recording(fn, self.calls[key]))
        return self

    def counts(self) -> dict:
        return {key: getattr(mod, name).launches
                for mod, name, key in self._slots}

    def __exit__(self, *exc) -> None:
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)
        self._orig.clear()


def batched_entries(rec: dict, suffix: str, calls: dict,
                    counts: dict) -> None:
    """``K1b<suffix>``, ``K2b<suffix>`` and ``K3b<suffix>`` of the kernels
    line from recorded batched calls (RecordBatched): every call held
    against its plain version, then up to REUSE_TIMED distinct programs
    (K1b), calls (K2b) and the first table (K3b) timed per call and
    device-only, with the bound."""
    from gatekeeper_tpu_torch.engine import executor as ex
    from gatekeeper_tpu_torch.kernels import dfa, ir_eval, topk
    join_warms()
    torch.cuda.synchronize()
    errs = {"K1b": 0.0, "K2b": 0, "K3b": 0.0}
    for (program, d), out in calls["K1b"]:
        want = ex._eval_mask_batched(program, d)
        if not torch.equal(out, want):
            fail(f"{suffix}: batched K1 mismatch")
    for (viol, rank, k), out in calls["K2b"]:
        want = topk.topk_packed_batched_plain(viol, rank, k)
        errs["K2b"] = max([errs["K2b"]] + [packed_err(out[i], want[i], k)
                                           for i in range(out.shape[0])])
    if errs["K2b"]:
        fail(f"{suffix}: batched K2 mismatch")
    for ins, out in calls["K3b"]:
        if not torch.equal(out, dfa.dfa_table_batched_plain(*ins)):
            fail(f"{suffix}: batched K3 mismatch")
    progs = {}
    for (program, d), _out in calls["K1b"]:
        progs.setdefault(id(program), (program, d))
    t = collections.Counter()
    by = "bytes"
    timed = list(progs.values())[:REUSE_TIMED]
    for program, d in timed:
        b, by = k1_bound_of(ex, ir_eval, program, d, 1)
        t["bound_ms"] += b / len(timed)
        for key, v in k1_times(
                lambda: ir_eval.eval_mask_batched(program, d),
                lambda: ex._eval_mask_batched(program, d)).items():
            t[key] += v / len(timed)
    rec["K1b" + suffix] = {"launches": counts["K1b"], "max_abs_err": 0.0,
                           **t, "bound_by": by, "library_ms": None}
    k2 = collections.Counter()
    k2_calls = calls["K2b"][:REUSE_TIMED]
    for (viol, rank, k), _out in k2_calls:
        n2 = k2_numbers(topk, viol, rank, k)
        by = n2.pop("bound_by")
        k2.update({key: v / len(k2_calls) for key, v in n2.items()})
    rec["K2b" + suffix] = {"launches": counts["K2b"], "max_abs_err": 0,
                           **k2, "bound_by": by}
    rec["K3b" + suffix] = {"launches": counts["K3b"], "max_abs_err": 0.0,
                           **k3_numbers(dfa, calls["K3b"][0][0],
                                        batched=True)}


def record_stream(client, objs) -> list:
    """Admission reviews of ``objs`` through the webhook handler into a
    capture log in a throwaway directory (the flight recorder's
    admission corpus, as ``probe --whatif`` records it); the loaded
    events."""
    import tempfile
    from gatekeeper_tpu_torch.obs import flightrecorder as fr
    from gatekeeper_tpu_torch.webhook.policy import ValidationHandler
    keys = ("GATEKEEPER_FLIGHT_DIR", "GATEKEEPER_FLIGHT_ADMISSION")
    saved = {k: os.environ.get(k) for k in keys}
    saved_rec = fr._recorder
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["GATEKEEPER_FLIGHT_DIR"] = tmp
        os.environ["GATEKEEPER_FLIGHT_ADMISSION"] = "1"
        fr._recorder = None
        try:
            vh = ValidationHandler(client)
            for obj in objs:
                vh.handle({
                    "uid": "u", "operation": "CREATE",
                    "kind": {"group": "", "version": "v1",
                             "kind": obj.get("kind", "")},
                    "name": (obj.get("metadata") or {}).get("name", ""),
                    "userInfo": {"username": "smoke", "groups": []},
                    "object": obj})
            events = fr.load_admission_corpus(tmp)
        finally:
            tmp_rec, fr._recorder = fr._recorder, saved_rec
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            if tmp_rec is not None and tmp_rec._capture is not None:
                tmp_rec._capture.close()
    if len(events) != len(objs):
        fail(f"record_stream: {len(events)} events for {len(objs)} reviews")
    return events


def reuse_phase(rec: dict, fns: dict) -> None:
    """Reuse and what-if on the card (ROADMAP A6, A7), each part a bench
    row at its own size, every result held against
    ``TorchDriver(device="cpu")`` or the oracle mode:

    (a) dedup (bench.py's analysis row): the library over REUSE_ROWS
        ``make_mixed(Random(11))`` rows; a capped sweep (its delta warm
        compiles each rewritten program's K1 variant), FULL_SWEEPS forced
        full sweeps with GATEKEEPER_DEDUP on and FULL_SWEEPS off, each
        equal to the CPU driver's, compiling nothing, the last on-sweep's
        K1, K2 and K3 calls held against their plain versions; then a 1%
        churn and one more full sweep that splices the shared columns.
    (b) selective reuse (churn_selective): the same store with footprint
        reuse on and off, a full, a steady, an annotation-only and a
        mixed churned sweep; a replayed kind launches no K1 and no K2.
    (c) what-if: the library over WHATIF_ROWS ``make_mixed(Random(7))``
        rows, a shadow sweep of ``constraints[1:]`` beside the live set
        against the single-set sweep and the standalone candidate, a
        snapshot replay, a recorded admission stream replayed scalar
        and batched.
    (d) rollout: PromotionController to deny over (c)'s store with (c)'s
        stream; graduate_fleet over 4 clusters against the loop oracle.
    (e) explain_pair: a violating, a passing and an unmatched pair of
        (b)'s store, each verdict equal to K1's bit.
    (f) probe --policyset, --whatif and --rollout on the card, rc 0.
    """
    from gatekeeper_tpu_torch.client import probe
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.client.interface import QueryOpts
    from gatekeeper_tpu_torch.engine import executor as ex
    from gatekeeper_tpu_torch.engine import torch_driver
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.kernels import dfa, ir_eval
    from gatekeeper_tpu_torch.library import all_docs, make_mixed
    from gatekeeper_tpu_torch.rollout import PromotionController, \
        graduate_fleet
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
    from gatekeeper_tpu_torch.whatif import (ShadowSession, fleet_loop_oracle,
                                             make_cluster, normalize_results,
                                             replay_admissions,
                                             replay_admissions_batched,
                                             replay_snapshot,
                                             standalone_candidate_verdicts,
                                             verdict_digest)
    def counts_of(*keys) -> dict:
        return {k: v for k, v in launch_counts(fns).items() if k in keys}

    torch_driver.SMALL_WORKLOAD_EVALS = 0
    for var in ("GATEKEEPER_DEDUP", "GATEKEEPER_FOOTPRINT",
                "GATEKEEPER_WHATIF_SHARE"):
        os.environ.pop(var, None)
    templates = [t for t, _c in all_docs()]
    constraints = [c for _t, c in all_docs()]
    capped = QueryOpts(limit_per_constraint=CAP)
    full = QueryOpts(limit_per_constraint=CAP, full=True)

    def library(rows: int, seed: int, device=None):
        d = TorchDriver(device=device)
        c = Backend(d).new_client([K8sValidationTarget()])
        for t in templates:
            c.add_template(t)
        for con in constraints:
            c.add_constraint(con)
        objs = make_mixed(random.Random(seed), rows)
        c.add_data_batch(copy.deepcopy(objs))
        return d, c, objs

    def timed(drv, opts):
        t0 = time.perf_counter()
        res, _ = drv.query_audit(TARGET, opts)
        return norm(res), time.perf_counter() - t0

    # ---- (a) dedup
    t_a = time.perf_counter()
    drv, c_a, objs = library(REUSE_ROWS, 11)
    cpu, cpu_a, _ = library(REUSE_ROWS, 11, "cpu")
    memo, _ = timed(drv, capped)
    warm = warm_text(drv)
    if drv.delta_warm is None or drv.delta_warm.rewritten <= 0:
        fail(f"dedup: the delta warm compiled no rewritten program "
             f"({drv.delta_warm})")
    want = norm(cpu.query_audit(TARGET, full)[0])
    if memo != want:
        fail("dedup: the memoized sweep differs from TorchDriver(cpu)")
    fs_dd: dict = {}
    on = full_sweeps(drv, fns, want, "dedup on", ("K1", "K2", "K3"),
                     record=fs_dd)
    dd = drv.last_sweep_phases["dedup"]
    n_fallbacks = drv.metrics.snapshot().get("dedup_fallbacks", 0)
    if not dd.get("enabled") or dd["subprograms_shared"] < 1 \
            or dd["evaluations_saved"] <= 0 or n_fallbacks:
        fail(f"dedup: stanza {dd}, dedup_fallbacks {n_fallbacks}")
    os.environ["GATEKEEPER_DEDUP"] = "off"
    try:
        off = full_sweeps(drv, fns, want, "dedup off", ("K1", "K2", "K3"))
        if drv.last_sweep_phases["dedup"] != {"enabled": False}:
            fail(f"dedup off: stanza {drv.last_sweep_phases['dedup']}")
    finally:
        os.environ.pop("GATEKEEPER_DEDUP", None)
    rng = random.Random(4)
    for i in rng.sample(range(REUSE_ROWS), REUSE_CHURN):
        o = copy.deepcopy(objs[i])
        spec = o.setdefault("spec", {})
        spec["serviceAccountName"] = f"churned-{i}"
        spec["automountServiceAccountToken"] = rng.random() < 0.5
        objs[i] = o
        for c in (c_a, cpu_a):
            c.add_data(copy.deepcopy(o))
    delta0 = drv.metrics.snapshot().get("dedup_shared_delta_evals", 0)
    reset_counts(fns)
    churned, churn_s = timed(drv, full)
    churn_counts = counts_of("K1", "K2", "K3")
    delta1 = drv.metrics.snapshot().get("dedup_shared_delta_evals", 0)
    if churned != norm(cpu.query_audit(TARGET, full)[0]):
        fail("dedup: the churned full sweep differs from TorchDriver(cpu)")
    if delta1 <= delta0:
        fail(f"dedup: the churned full sweep spliced no shared column "
             f"({delta0} -> {delta1})")
    rw = [((p, d_), out) for (p, d_), out in fs_dd["calls"]["K1"]
          if any(nm.startswith("__shared") for nm in d_)]
    n_rw = len({id(p) for (p, _d), _o in rw})
    k123_entries(rec, "dd", {"K1": rw, "K2": [], "K3": []},
                 {"K1": len(rw)}, {"K1": fs_dd["errs"]["K1"]})
    print(f"phase reuse dedup: {len(templates)} templates x {REUSE_ROWS} "
          f"rows ({warm}, of it {drv.delta_warm.rewritten} rewritten "
          f"programs' K1 variants); forced full sweeps equal "
          f"TorchDriver(cpu)'s, no Triton variant compiled: on "
          f"{[s['wall_s'] for s in on['sweeps']]} s, off "
          f"{[s['wall_s'] for s in off['sweeps']]} s; stanza {dd}, "
          f"dedup_fallbacks {n_fallbacks}; launches on the last on-sweep "
          f"{fs_dd['counts']}, off {off['sweeps'][-1]['launches']}; "
          f"{n_rw} rewritten programs, K1 on them "
          f"{k1_text(rec['K1dd'])}; after {REUSE_CHURN} churned rows a "
          f"full sweep {churn_s:.4f} s, launches {churn_counts}, "
          f"dedup_shared_delta_evals {delta0} -> {delta1}, host_eval_s "
          f"{drv.last_sweep_phases['dedup']['host_eval_s']}; "
          f"{time.perf_counter() - t_a:.1f}s", flush=True)
    del drv, cpu, c_a, cpu_a, fs_dd, rw

    # ---- (b) selective reuse, and (e) explain_pair on its store
    t_b = time.perf_counter()
    sides = {}
    for fp in ("on", "off"):
        os.environ["GATEKEEPER_FOOTPRINT"] = fp
        try:
            sides[fp] = library(REUSE_ROWS, 11)
        finally:
            os.environ.pop("GATEKEEPER_FOOTPRINT", None)
    cpu, cpu_b, _ = library(REUSE_ROWS, 11, "cpu")
    rows_b = {fp: side[2] for fp, side in sides.items()}
    steps = []
    churn_rng = random.Random(77)
    for step in ("full", "steady", "annotate", "mixed"):
        if step in ("annotate", "mixed"):
            picks = churn_rng.sample(range(REUSE_ROWS), REUSE_CHURN)
            for j, i in enumerate(picks):
                o = copy.deepcopy(rows_b["on"][i])
                if step == "annotate" or j % 2 == 0:
                    o.setdefault("metadata", {}).setdefault(
                        "annotations", {})["smoke"] = f"{step}-{j}"
                elif (o.get("spec") or {}).get("containers"):
                    o["spec"]["containers"][0]["image"] = \
                        f"evil.io/smoke:{j}"
                else:
                    o.setdefault("metadata", {}).setdefault(
                        "annotations", {})["smoke"] = f"{step}-{j}"
                for fp in ("on", "off"):
                    rows_b[fp][i] = o
                    sides[fp][1].add_data(copy.deepcopy(o))
                cpu_b.add_data(copy.deepcopy(o))
        got = {}
        compiled = {}
        launched = {}
        # the first capped sweep's delta warm compiles on its own
        # thread: no timed sweep runs beside it
        join_warms()
        for fp in ("on", "off"):
            os.environ["GATEKEEPER_FOOTPRINT"] = fp
            try:
                reset_counts(fns)
                v0 = triton_variants(ir_eval)
                got[fp] = timed(sides[fp][0], full if step == "full"
                                else capped)
                v1 = triton_variants(ir_eval)
                compiled[fp] = None if None in (v0, v1) else v1 - v0
                launched[fp] = counts_of("K1", "K2", "K5")
            finally:
                os.environ.pop("GATEKEEPER_FOOTPRINT", None)
            if fp == "on":
                stanza = dict(sides["on"][0].last_sweep_phases["footprint"])
        on_counts = launched["on"]
        want_b = norm(cpu.query_audit(
            TARGET, full if step == "full" else capped)[0])
        if got["on"][0] != got["off"][0] or got["on"][0] != want_b:
            fail(f"reuse: the {step} sweep differs between footprint on, "
                 f"off and TorchDriver(cpu)")
        st = sides["on"][0]._state(TARGET)
        replayed = stanza["kinds_skipped"]
        device_kinds = len(st.bindings_cache)
        if step == "annotate":
            # every row-local kind whose read-set misses the annotation
            # the round wrote
            from gatekeeper_tpu_torch.analysis.footprint import (
                MATCH_PATHS, paths_intersect)
            wrote = ("metadata", "annotations", "smoke")
            expect = sum(1 for k in st.sweep_cache if not any(
                paths_intersect(wrote, r) for r in
                set(st.footprints[k].object_paths()) | set(MATCH_PATHS)))
            if replayed != expect or replayed == 0:
                fail(f"reuse: the annotation-only round replayed "
                     f"{replayed} kinds, {expect} row-local kinds do not "
                     f"read the annotation")
        if step in ("annotate", "mixed") and (
                on_counts["K2"] > device_kinds - replayed
                or on_counts["K1"] + on_counts["K5"]
                > device_kinds - replayed):
            fail(f"reuse: {step} round launched {on_counts} with "
                 f"{replayed} of {device_kinds} device kinds replayed")
        steps.append((step, round(got["on"][1], 4), round(got["off"][1], 4),
                      stanza, on_counts, launched["off"], compiled["on"],
                      compiled["off"]))
    print(f"phase reuse selective: {len(templates)} templates x "
          f"{REUSE_ROWS} rows, GATEKEEPER_PAGES=off, footprint on vs off "
          f"equal each other and TorchDriver(cpu) every step; (step, on s, "
          f"off s, stanza, launches on, off, Triton variants compiled on, "
          f"off; on runs first): {steps}; "
          f"{time.perf_counter() - t_b:.1f}s", flush=True)
    # (e) explain_pair on the selective store: of K8sAllowedRepos (a
    # template over pods), a violating pod, a passing pod and a row of
    # another kind (no library constraint carries match criteria: the
    # template's own kind test leaves it unmatched), each verdict against
    # K1's bit for the pair
    drv_b = sides["on"][0]
    st = drv_b._state(TARGET)
    t_e = time.perf_counter()
    kind = "K8sAllowedRepos"
    b = st.bindings_cache[kind][1]
    prog = st.templates[kind].vectorized.program
    mask = ir_eval.eval_mask(prog, ex._with_dfa_tables(
        prog, drv_b.executor._arrays(b, None), dfa.dfa_table))[0] \
        .cpu().numpy()
    key_of = {row: key for key, row in st.table.rows_items()}
    pods = [r for r in sorted(key_of) if st.table.meta_at(r).kind == "Pod"]
    picks = {"violating": next(r for r in pods if mask[r]),
             "passing": next(r for r in pods if not mask[r]),
             "unmatched": next(r for r in sorted(key_of)
                               if st.table.meta_at(r).kind != "Pod")}
    cname = drv_b._kind_constraints(st, kind)[0]["metadata"]["name"]
    explained = []
    for what, row in picks.items():
        out = drv_b.explain_pair(TARGET, kind, cname, key_of[row])
        fires = "FIRES" in out
        n_oracle = int(out.split("oracle: ")[1].split(" ")[0])
        if fires != bool(mask[row]) or fires != (n_oracle > 0) \
                or fires != (what == "violating"):
            fail(f"explain_pair {kind}/{cname} {what} row {row}: FIRES "
                 f"{fires}, K1 bit {mask[row]}, oracle {n_oracle}")
        explained.append((what, key_of[row], fires, n_oracle))
    print(f"phase reuse explain: {kind}/{cname} (what, key, FIRES, oracle "
          f"violations) {explained}, each verdict equal to K1's bit for the "
          f"pair and to the oracle line, {time.perf_counter() - t_e:.2f}s",
          flush=True)
    del sides, cpu, cpu_b, drv_b, st

    # ---- (c) what-if
    t_c = time.perf_counter()
    drv, client, objs = library(WHATIF_ROWS, 7)
    build_s = time.perf_counter() - t_c
    state = drv._state(TARGET).table.snapshot_state()
    client.audit(limit_per_constraint=CAP, full=True)        # compiles
    join_warms()
    single_s = math.inf
    for _ in range(2):
        t0 = time.perf_counter()
        resp = client.audit(limit_per_constraint=CAP, full=True)
        single_s = min(single_s, time.perf_counter() - t0)
    baseline = normalize_results(resp.results())
    cand = [dict(c) for c in constraints[1:]]
    sess = ShadowSession(client, tag="candidate")
    sess.stage(templates, cand)
    try:
        sess.sweep(limit_per_constraint=CAP)            # compiles
        join_warms()
        with RecordK123() as r:
            reset_counts(fns)
            t0 = time.perf_counter()
            rep = sess.sweep(limit_per_constraint=CAP)
            combined_s = time.perf_counter() - t0
            sh_counts = r.counts()
        wi = dict(drv.last_sweep_phases.get("whatif") or {})
        st = drv._state(TARGET)
        from gatekeeper_tpu_torch.analysis.policyset import \
            split_shadow_kind
        # every staged twin with constraints has the live kind's (the
        # candidate drops the first kind's only constraint); under the
        # Stage-8 weave, as in the reference, a twin shares only when its
        # live kind is dispatched before it
        twins = [k for k in st.bindings_cache
                 if split_shadow_kind(k)[1] == "candidate"]
        n_same = len(twins)
        order = drv.memsurface_sweep_order(st, sorted(st.templates))
        n_after = sum(1 for k in twins if order.index(
            split_shadow_kind(k)[0]) < order.index(k))
        # sorted order (Stage 8 off) puts every live kind before its twin
        os.environ["GATEKEEPER_HBM_BUDGET"] = "off"
        try:
            rep_sorted = sess.sweep(limit_per_constraint=CAP)
            wi_sorted = dict(drv.last_sweep_phases.get("whatif") or {})
        finally:
            os.environ.pop("GATEKEEPER_HBM_BUDGET", None)
    finally:
        sess.unstage()
    sh_errs = check_k123(ex, r.calls, "shadow sweep")
    k123_entries(rec, "sh", {"K1": r.calls["K1"], "K2": r.calls["K2"],
                             "K3": []}, sh_counts, sh_errs)
    oracle = standalone_candidate_verdicts(templates, cand, state, CAP)
    if rep.shadow != oracle or rep.live != baseline \
            or (rep_sorted.shadow, rep_sorted.live) != (oracle, baseline):
        fail(f"what-if: shadow {rep.shadow_digest} (sorted order "
             f"{rep_sorted.shadow_digest}) vs standalone "
             f"{verdict_digest(oracle)}, live {rep.live_digest} (sorted "
             f"{rep_sorted.live_digest}) vs single "
             f"{verdict_digest(baseline)}")
    if n_same == 0 or wi.get("twin_shared_kinds") != n_after \
            or wi_sorted.get("twin_shared_kinds", 0) < n_same:
        fail(f"what-if: whatif stanza {wi} ({n_after} twins after their "
             f"live kind in the Stage-8 order), sorted order {wi_sorted}, "
             f"{n_same} twins whose constraint set equals the live one")
    rrep = replay_snapshot(templates, constraints, state, CAP)
    if rrep.digest != verdict_digest(baseline):
        fail(f"what-if: replay digest {rrep.digest}, live "
             f"{verdict_digest(baseline)}")
    events = record_stream(client, make_mixed(random.Random(11),
                                              WHATIF_REVIEWS))
    srep = replay_admissions(events, client)
    dev0 = drv.metrics.snapshot().get("review_batches_device", 0)
    brep = replay_admissions_batched(events, client)
    dev_batches = drv.metrics.snapshot().get("review_batches_device",
                                             0) - dev0
    # the stream's (review, constraint) pairs against the admission
    # threshold: below it the driver keeps the batch on the scalar
    # engine, at or above it the batch is one device pass
    pairs = WHATIF_REVIEWS * len(constraints)
    on_card = pairs >= torch_driver.REVIEW_BATCH_MIN_EVALS
    if not (srep.exact and brep.exact) or srep.digest != brep.digest \
            or brep.replayed != WHATIF_REVIEWS or brep.isolated_chunks \
            or (dev_batches > 0) != on_card:
        fail(f"what-if: stream replay scalar {srep.digest} exact "
             f"{srep.exact}, batched {brep.digest} exact {brep.exact}, "
             f"{brep.replayed} replayed, {brep.isolated_chunks} isolated "
             f"chunks, {dev_batches} device batches for {pairs} pairs")
    batch_route = (f"{dev_batches} device pass(es)" if on_card else
                   f"on the scalar engine: {pairs} pairs, under "
                   f"REVIEW_BATCH_MIN_EVALS "
                   f"{torch_driver.REVIEW_BATCH_MIN_EVALS}")
    ratio = combined_s / single_s
    gate = 1.5 * single_s + 0.25
    print(f"phase reuse whatif: {len(templates)} templates x {WHATIF_ROWS} "
          f"rows (built in {build_s:.1f}s); single-set full sweep "
          f"{single_s:.4f}s, live + shadow {combined_s:.4f}s, ratio "
          f"{ratio:.3f} (the reference's bench gate 1.5x + 0.25 s = "
          f"{gate:.4f}s: {'within' if combined_s <= gate else 'over'}, "
          f"recorded only); shadow == standalone candidate "
          f"({rep.shadow_digest}), live == single ({rep.live_digest}); "
          f"whatif {wi} ({n_same} unchanged twins, {n_after} after "
          f"their live kind in the Stage-8 order; sorted order "
          f"{wi_sorted}); dedup "
          f"{rep.dedup}; launches {sh_counts}; K1 {k1_text(rec['K1sh'])}, "
          f"K2 {k2_text(rec['K2sh'])}; replay digest {rrep.digest} in "
          f"{rrep.wall_s:.2f}s; stream of {WHATIF_REVIEWS}: scalar "
          f"{srep.wall_s:.2f}s, batched {brep.wall_s:.2f}s ({batch_route}), "
          f"digest {srep.digest}; {time.perf_counter() - t_c:.1f}s",
          flush=True)

    # ---- (d) rollout over (c)'s store, and graduate_fleet
    t_d = time.perf_counter()
    ctrl = PromotionController(client, templates, cand, name="smoke",
                               events=events, verify_parity=True)
    final = ctrl.run(target_rung="deny")
    gate_ev = ctrl.evidence.get("replay_gate", {})
    if final != "deny" or gate_ev.get("parity") is not True \
            or ctrl.evidence.get("shadow", {}).get("oracle_parity") \
            is not True:
        fail(f"rollout: state {final}, history {ctrl.history[-2:]}, "
             f"evidence {ctrl.evidence}")
    promote_s = time.perf_counter() - t_d
    del drv, client, state, objs, sess
    fleet = [make_cluster(f"c{i}", templates, constraints,
                          objs=make_mixed(random.Random(200 + i),
                                          GRADUATE_ROWS))
             for i in range(4)]
    _v, loop_digests, _w = fleet_loop_oracle(fleet, CAP)
    # once untimed (each stacked kind's batched variants compile), then
    # timed and recorded
    t0 = time.perf_counter()
    graduate_fleet(fleet, templates, cand, limit_per_constraint=CAP)
    grad_cold_s = time.perf_counter() - t0
    join_warms()
    with RecordBatched() as rb:
        reset_counts(fns)
        t0 = time.perf_counter()
        grep = graduate_fleet(fleet, templates, cand,
                              limit_per_constraint=CAP)
        grad_s = time.perf_counter() - t0
        b_counts = rb.counts()
    base_digests = [e.baseline_digest for e in grep.per_cluster]
    if grep.graduated != 4 or base_digests != loop_digests \
            or grep.loop_blocks or min(b_counts.values()) <= 0:
        fail(f"graduate_fleet: {grep.headline()}, digests {base_digests} "
             f"vs loop oracle {loop_digests}, launches {b_counts}")
    batched_entries(rec, "g", rb.calls, b_counts)
    print(f"phase reuse rollout: PromotionController to deny over the "
          f"what-if store in {promote_s:.1f}s: "
          f"{[h['to'] for h in ctrl.history]}, replay gate {gate_ev}; "
          f"graduate_fleet {grep.headline()} in {grad_s:.3f}s (the first "
          f"run, compiling, {grad_cold_s:.3f}s), baseline "
          f"digests equal fleet_loop_oracle's, launches {b_counts}; K1b "
          f"{k1_text(rec['K1bg'])}, K2b {k2_text(rec['K2bg'])}, K3b "
          f"{rec['K3bg']['ms']:.4f} ms, device "
          f"{rec['K3bg']['device_ms']:.4f}", flush=True)
    del fleet, rb

    # ---- (f) the probe's what-if subcommands on the card
    import io
    t_f = time.perf_counter()
    lines = {}
    for flag in ("--policyset", "--whatif", "--rollout"):
        buf = io.StringIO()
        reset_counts(fns)
        with contextlib.redirect_stdout(buf):
            rc = probe.main([flag])
        out = buf.getvalue().splitlines()
        launched = counts_of("K1", "K1b")
        if rc != 0 or any(line.lstrip().startswith("FAIL") for line in out) \
                or (flag != "--policyset" and launched["K1"] <= 0):
            fail(f"probe {flag}: rc {rc}, launches {launched}, tail "
                 f"{out[-3:]}")
        lines[flag] = (rc, out[-1] if out else "", launched)
    print(f"phase reuse probe: {lines} in {time.perf_counter() - t_f:.1f}s",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--resources", type=int, default=100_000)
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--k2-only", action="store_true",
                      help="build K2 alone and run only its random-mask "
                      "phases (K2 random, K2b random)")
    only.add_argument("--k1-only", action="store_true",
                      help="build K3 alone and run only K1's phases (K1 "
                      "random, K1 north star)")
    only.add_argument("--k6k7-only", action="store_true",
                      help="build K6 and K7 alone and run only their "
                      "phases (K6 random, K7 join)")
    only.add_argument("--k3-only", action="store_true",
                      help="build K3 alone and run only its phases (K3 "
                      "random, K3 store, library, fleet and large)")
    only.add_argument("--admission-only", action="store_true",
                      help="build K3 alone and run only the admission "
                      "phase (review batches, the library batch, K1 and K3 "
                      "at the review shapes, the micro-batcher)")
    only.add_argument("--manager-only", action="store_true",
                      help="build K2, K3 and K4 and run only the manager "
                      "phase (the manager process: controllers, audit "
                      "manager, webhook over HTTP)")
    only.add_argument("--reactor-only", action="store_true",
                      help="build K2, K3, K4 and K6 and run only the "
                      "reactor phase (the manager with pages and devpages "
                      "on: watch events into the verdict ledger)")
    only.add_argument("--worker-only", action="store_true",
                      help="build K2, K3 and K4 and run only the worker "
                      "phase (the manager over an engine worker, a pool of "
                      "worker processes)")
    only.add_argument("--extdata-only", action="store_true",
                      help="build K2 and K3 and run only the external-data "
                      "phase (the bench row, a large registry, the HTTP "
                      "provider and its outage, an admission batch)")
    only.add_argument("--probe-only", action="store_true",
                      help="build K2 and K3 and run only the probe phase "
                      "(the scenarios on local and torch, --cost)")
    only.add_argument("--reuse-only", action="store_true",
                      help="build K2, K3 and K4 and run only the reuse "
                      "phase (dedup, selective reuse, what-if, rollout, "
                      "explain_pair, the probe's --policyset, --whatif and "
                      "--rollout)")
    ap.add_argument("--reactor-pods", type=int, default=REACTOR_PODS,
                    help="pods of the reactor phase (REACTOR_PODS by "
                    "default): its cold ledger build and rung-2 resync "
                    "confirm about 250 verdicts a pod on the host")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    # imported after the CUDA check, so a bare copy of this script fails
    # here too (the package must be beside it)
    from gatekeeper_tpu_torch.kernels import build

    # the port, like the reference, serves non-full sweeps from the
    # verdict ledger by default; every phase but devpages measures the
    # legacy sweep and its launch counts
    os.environ["GATEKEEPER_PAGES"] = "off"

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
    secs = build.build(("topk",) if args.k2_only else ("dfa",)
                       if args.k1_only or args.k3_only or args.admission_only
                       else ("devdelta", "invjoin")
                       if args.k6k7_only else ("topk", "dfa", "scatter")
                       if args.manager_only or args.worker_only else
                       ("topk", "dfa", "scatter", "devdelta")
                       if args.reactor_only else ("topk", "dfa")
                       if args.extdata_only or args.probe_only
                       else ("topk", "dfa", "scatter")
                       if args.reuse_only else build.KERNELS)
    import triton
    print(f"phase build: {time.perf_counter() - t0:.3f}s wall, per library "
          f"{ {k: round(v, 3) for k, v in secs.items()} }, triton "
          f"{triton.__version__}", flush=True)

    dev = torch.device("cuda", 0)
    rec: dict[str, dict] = {}
    # the admission phase's per-review answers, in a process of their own
    # while the card runs the phases before it
    answers = AdmissionOracle(("admission",)) if args.admission_only \
        else AdmissionOracle(("manager",)) \
        if args.manager_only or args.worker_only \
        else None if (args.k1_only or args.k2_only or args.k3_only
                      or args.k6k7_only or args.reactor_only
                      or args.extdata_only or args.probe_only
                      or args.reuse_only) \
        else AdmissionOracle()
    try:
        return run_phases(args, card, dev, rec, answers)
    finally:
        if answers is not None:
            answers.stop()


def run_phases(args, card: str, dev, rec: dict, answers) -> int:
    """The phases of :func:`main` after the build."""
    from gatekeeper_tpu_torch import convert
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.client.interface import QueryOpts
    from gatekeeper_tpu_torch.client.local_driver import LocalDriver
    from gatekeeper_tpu_torch.engine import executor as ex
    from gatekeeper_tpu_torch.engine import torch_driver
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.kernels import (devdelta, dfa, invjoin,
                                              ir_eval, residency, scatter,
                                              topk)
    from gatekeeper_tpu_torch.kernels.op_cases import every_op_case
    from gatekeeper_tpu_torch.library import all_docs, make_mixed
    from gatekeeper_tpu_torch.library.north_star import (make_resources,
                                                         setup_north_star)
    from gatekeeper_tpu_torch.library.templates import (LIBRARY,
                                                        constraint_doc,
                                                        template_doc)
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
    fns = kernel_fns(ir_eval, topk, dfa, scatter, devdelta, invjoin,
                     residency)
    # each phase's wall seconds, printed before the kernels line
    took: dict[str, float] = {}
    t_mark = [time.perf_counter()]

    def mark(name: str) -> None:
        now = time.perf_counter()
        took[name] = round(now - t_mark[0], 1)
        t_mark[0] = now

    def counts_of(*keys) -> dict:
        return {k: v for k, v in launch_counts(fns).items() if k in keys}

    if args.k1_only:
        k1_random(ir_eval, dfa, ex, dev, args.resources)
        print(card, flush=True)
        return 0
    if args.k6k7_only:
        k6k7_only(devdelta, invjoin, dev)
        print(card, flush=True)
        return 0
    if args.k3_only:
        k3_only(dfa, dev, args.resources)
        print(card, flush=True)
        return 0
    if args.admission_only:
        admission_phase(rec, fns, oracle=answers)
        print(card, flush=True)
        return 0
    if args.manager_only:
        manager_phase(rec, fns, oracle=answers)
        print(card, flush=True)
        return 0
    if args.reactor_only:
        reactor_phase(rec, fns, args.reactor_pods)
        print(card, flush=True)
        return 0
    if args.worker_only:
        worker_phase(rec, fns, oracle=answers)
        print(card, flush=True)
        return 0
    if args.extdata_only:
        extdata_phase(rec, fns)
        print(card, flush=True)
        return 0
    if args.probe_only:
        probe_phase(fns)
        print(card, flush=True)
        return 0
    if args.reuse_only:
        reuse_phase(rec, fns)
        print(card, flush=True)
        return 0

    # ---- 3a. K2 on random masks, full and ragged, at the default cap
    # and at caps that take a wider sort and several selects; K2b
    k2_random(topk, dev)
    if args.k2_only:
        print(card, flush=True)
        return 0

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
    # ordering compares of row values against constraint values, which
    # K1 takes through a max / min over the elements: NaN, infinities
    # and signed zeros among the floats (imported here: --k1-only runs
    # beside earlier trees, which lack the case)
    from gatekeeper_tpu_torch.kernels.op_cases import ordering_case
    for seed, kw in ((0, {}), (1, {"c_pad": 128, "r_pad": 1 << 14})):
        prog, host = ordering_case(seed, **kw)
        arrays = convert.arrays_to_device(host, dev)
        if not torch.equal(ir_eval.eval_mask(prog, arrays),
                           ex._eval_mask(prog, arrays)):
            fail(f"K1 mismatch on the ordering case {seed}")
    print("phase every-op: K1 and K3 equal their plain versions on 2 "
          "every-op programs, K1 on 2 ordering programs", flush=True)
    print(f"phase K3 random: {k3_random(dfa, dev, every=False)}",
          flush=True)

    # ---- 3c. K4 on random columns of every dtype and axis layout, and
    # K5 on the every-op programs at random rows; rows padded to their
    # bucket by repeating the first row (with its values)
    rng = np.random.default_rng(11)
    rand_jobs = []
    for shape, axis, dtype in (
            ((131072,), 0, torch.bool), ((131072,), 0, torch.int32),
            ((131072,), 0, torch.int8), ((131072,), 0, torch.int16),
            ((131072,), 0, torch.float32), ((131072, 4), 0, torch.int16),
            ((128, 131072), 1, torch.bool), ((5, 131072), 1, torch.bool),
            ((3, 131072), 1, torch.int32), ((3, 8192, 4), 1, torch.bool),
            ((4096, 128), 0, torch.uint8), ((4096,), 0, torch.bool)):
        for n_dirty in (1, 5, 1000):
            dirty = np.sort(rng.choice(shape[axis], size=n_dirty,
                                       replace=False))
            rows_np = ex.pad_rows(dirty).astype(np.int32)
            vshape = shape[:axis] + (len(rows_np),) + shape[axis + 1:]
            lo, hi = (0, 2) if dtype == torch.bool else (-3, 100)
            col = torch.from_numpy(rng.integers(lo, hi, size=shape)) \
                .to(dtype).to(dev)
            vals = torch.from_numpy(rng.integers(lo, hi, size=vshape)) \
                .to(dtype)
            pad = [slice(None)] * len(shape)
            pad[axis] = slice(n_dirty, None)
            first = [slice(None)] * len(shape)
            first[axis] = slice(0, 1)
            vals[tuple(pad)] = vals[tuple(first)]
            vals = vals.to(dev)
            rows = torch.from_numpy(rows_np).to(dev)
            keep = col.clone()
            got = scatter.scatter_rows(col, rows, vals, axis)
            torch.cuda.synchronize()
            if not torch.equal(got, scatter.scatter_rows_plain(
                    col, rows, vals, axis)) or not torch.equal(col, keep):
                fail(f"K4 mismatch on {dtype} {list(shape)} axis {axis}, "
                     f"{n_dirty} rows")
            rand_jobs.append((col, rows, vals, axis))
    # the same 36 jobs through the batched entry: one launch
    launched = scatter.scatter_rows_many.launches
    for (col, rows, vals, axis), got in zip(
            rand_jobs, scatter.scatter_rows_many(rand_jobs)):
        torch.cuda.synchronize()
        if not torch.equal(got, scatter.scatter_rows_plain(col, rows, vals,
                                                           axis)):
            fail(f"batched K4 mismatch on {col.dtype} {list(col.shape)} "
                 f"axis {axis}, {rows.numel()} rows")
    if scatter.scatter_rows_many.launches != launched + 1:
        fail("batched K4 took more than one launch for 36 jobs")
    del rand_jobs, col, vals, keep, got
    # the match-mask shape a churned kind scatters: [C_pad, R_pad] bool
    # along R, 1% of 100k rows (bucket 1024)
    dirty = np.sort(rng.choice(100_000, size=1000, replace=False))
    rows = torch.from_numpy(ex.pad_rows(dirty).astype(np.int32)).to(dev)
    mask_col = torch.from_numpy(rng.random((128, 131072)) < 0.5).to(dev)
    mask_vals = torch.from_numpy(rng.random((128, 1024)) < 0.5).to(dev)
    k4_mask = k4_numbers(scatter, [(mask_col, rows, mask_vals, 1)])
    del mask_col, mask_vals
    for seed, kw in ((0, {}), (1, {"c_pad": 128, "r_pad": 1 << 14,
                                   "e_pad": 8, "t_pad": 4096, "u": 64})):
        prog, host = every_op_case(seed, **kw)
        arrays = convert.arrays_to_device(host, dev)
        d_dev = ex._with_dfa_tables(prog, arrays, dfa.dfa_table)
        c_pad, r_pad = host["__match__"].shape
        viol_old = torch.from_numpy(rng.random((c_pad, r_pad)) < 0.5).to(dev)
        for n_dirty in (1, 7, r_pad // 8):
            dirty = np.sort(rng.choice(r_pad, size=n_dirty, replace=False))
            rows = torch.from_numpy(
                ex.pad_rows(dirty).astype(np.int32)).to(dev)
            got = ir_eval.delta_mask(prog, d_dev, viol_old, rows)
            if not torch.equal(got, ex._delta_mask(prog, arrays, viol_old,
                                                   rows)):
                fail(f"K5 mismatch on the every-op case {seed}, {n_dirty} "
                     "rows")
    print(f"phase K4/K5 random: K4 equal to plain on 12 dtype/axis layouts "
          f"x 3 row counts with duplicate padding rows, one at a time and "
          f"all 36 in one batched launch; [128, 131072] bool along R, 1024 "
          f"rows: {k4_mask['ms']:.4f} ms, device {k4_mask['device_ms']:.4f}"
          f" (plain {k4_mask['plain_ms']:.4f}, torch.index_copy "
          f"{k4_mask['library_ms']:.4f}, device "
          f"{k4_mask['library_device_ms']:.4f}, bound "
          f"{k4_mask['bound_ms']:.4f}); K5 equal to plain on 2 every-op "
          f"programs x 3 row counts", flush=True)

    # ---- 3d. library set through TorchDriver on the card
    torch_driver.SMALL_WORKLOAD_EVALS = 0
    lib_drv = TorchDriver()
    lib = Backend(lib_drv).new_client([K8sValidationTarget()])
    for t, con in all_docs():
        lib.add_template(t)
        lib.add_constraint(con)
    lib.add_data_batch(make_mixed(random.Random(0), LIBRARY_ROWS))
    reset_counts(fns)
    t0 = time.perf_counter()
    lib_res, _ = lib_drv.query_audit(TARGET, QueryOpts(limit_per_constraint=CAP))
    lib_s = time.perf_counter() - t0
    lib_counts = counts_of("K1", "K2", "K3")
    lib_warm = warm_text(lib_drv)
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
    k3_lib = k3_numbers(dfa, k3[1])
    print(f"phase library: {len(st.templates)} templates x {LIBRARY_ROWS}"
          f" rows, capped sweep {lib_s:.3f}s, {len(lib_res)} results, "
          f"launches {lib_counts}; {lib_warm}; K1 == "
          f"plain on {n_k1} programs; K3 == plain on {k3[0]}: "
          f"{k3_text(dfa, k3[1], k3_lib)}", flush=True)
    # forced full sweeps of the library store: many kinds, each with its
    # own phase seconds; held against the memoized sweep and the CPU
    # driver on the same store
    lib_cpu = TorchDriver(device="cpu")
    cpu_lib = Backend(lib_cpu).new_client([K8sValidationTarget()])
    for t, con in all_docs():
        cpu_lib.add_template(t)
        cpu_lib.add_constraint(con)
    cpu_lib.add_data_batch(make_mixed(random.Random(0), LIBRARY_ROWS))
    if norm(lib_cpu.query_audit(TARGET, QueryOpts(
            limit_per_constraint=CAP))[0]) != norm(lib_res):
        fail("library: the card's capped sweep differs from "
             "TorchDriver(device='cpu')")
    del lib_cpu, cpu_lib
    fs_lib: dict = {}
    lib_full = full_sweeps(lib_drv, fns, norm(lib_res), "library",
                           ("K1", "K2", "K3"), record=fs_lib)
    print(f"phase full sweep library: {len(st.templates)} templates x "
          f"{LIBRARY_ROWS} rows, cap {CAP}, results equal the memoized "
          f"sweep's and TorchDriver(cpu)'s, no Triton variant compiled, "
          f"h2d_bytes = the kinds' Bindings.nbytes() and shared dedup "
          f"columns: {json.dumps(lib_full)}",
          flush=True)
    del lib_drv, lib, st

    # ---- 4. main path: north star on the card
    torch_driver.SMALL_WORKLOAD_EVALS = 20_000
    resources = make_resources(args.resources, random.Random(1))
    v_ingest = triton_variants(ir_eval)
    t0 = time.perf_counter()
    drv = TorchDriver()
    client = setup_north_star(drv, resources, random.Random(2))
    ingest_s = time.perf_counter() - t0
    # the ingest (past MIRROR_EAGER_MIN_ROWS) built each kind's bindings
    # and started the compile of each kind's full K1 variant on the
    # ingest-prewarm threads; wait for it, then the cold sweep must
    # compile nothing
    mirror_s = drv.metrics.timer("mirror_materialize").total
    t0 = time.perf_counter()
    ingest_warm_s = drv.wait_ingest_warm()
    ingest_wait_s = time.perf_counter() - t0
    v_warmed = triton_variants(ir_eval)
    if args.resources >= torch_driver.MIRROR_EAGER_MIN_ROWS and (
            ingest_warm_s is None or drv.ingest_warm.kinds != 3):
        fail(f"the ingest of {args.resources} pods started no ingest warm "
             f"of the 3 kinds: {drv.ingest_warm}")
    opts = QueryOpts(limit_per_constraint=CAP)
    reset_counts(fns)
    t0 = time.perf_counter()
    cold, _ = drv.query_audit(TARGET, opts)
    cold_s = time.perf_counter() - t0
    v_cold = triton_variants(ir_eval)
    if args.resources >= torch_driver.MIRROR_EAGER_MIN_ROWS and (
            None in (v_warmed, v_cold) or v_cold != v_warmed):
        fail(f"the cold sweep after the ingest warm compiled Triton "
             f"variants: {v_warmed} before it, {v_cold} after")
    print(f"phase main ingest: {args.resources} pods in {ingest_s:.4f}s, of "
          f"it the eager mirror (axes, 3 kinds' bindings, row order, rank) "
          f"{mirror_s:.4f}s under the writer lock; ingest warm of "
          f"{drv.ingest_warm.kinds if drv.ingest_warm else 0} kinds "
          f"{ingest_warm_s if ingest_warm_s is not None else 0.0:.4f}s on "
          f"its threads (waited {ingest_wait_s:.4f}s after the ingest), "
          f"Triton variants {v_ingest} -> {v_warmed}; cold capped sweep "
          f"{cold_s:.4f}s (3.0283 s on an H100 80GB HBM3 at 700 W before "
          f"the ingest warm, when the cold sweep built the bindings and "
          f"compiled each kind's K1 variant itself), Triton variants "
          f"{v_warmed} -> {v_cold}", flush=True)
    # the churn-delta variants compile on the driver's warm-up thread;
    # wait for it, so no compile overlaps a timing or a graph capture
    t0 = time.perf_counter()
    warm_s = drv.wait_delta_warm()
    warm_wait_s = time.perf_counter() - t0
    if warm_s is None or drv.delta_warm.kinds != 3:
        fail(f"the cold sweep started no delta warm-up of the 3 kinds: "
             f"{drv.delta_warm}")
    steady = []
    for _ in range(3):
        t0 = time.perf_counter()
        res, _ = drv.query_audit(TARGET, opts)
        steady.append(time.perf_counter() - t0)
        if norm(res) != norm(cold):
            fail("steady sweep results differ from the cold sweep")
    counts = counts_of("K1", "K2", "K3")
    if counts["K1"] <= 0 or counts["K2"] <= 0:
        fail(f"main path did not launch K1 and K2: {counts}")
    evals = args.resources * 201
    print(f"phase main: north star {args.resources} pods x 201 constraints "
          f"cap {CAP}: ingest {ingest_s:.3f}s, cold {cold_s:.4f}s, "
          f"delta warm-up of 3 kinds {warm_s:.4f}s on its thread (waited "
          f"{warm_wait_s:.4f}s after the cold sweep), "
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
    by_name = sorted(((getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0)), e.key)
                      for e in prof.key_averages()
                      if str(getattr(e, "device_type", "")).endswith("CUDA")),
                     reverse=True)
    dev_us = sum(us for us, _ in by_name)
    busy = f"{dev_us / 1e6 / traced_s:.4%}" if dev_us else "not measured"
    top = "; ".join(f"{name[:60]} {us / 1e3:.4f} ms"
                    for us, name in by_name[:6] if us)
    print(f"phase main split: timer totals over cold + 3 steady sweeps "
          f"{split}; traced steady sweep {traced_s:.4f}s with device busy "
          f"{dev_us / 1e3:.3f} ms = {busy} of it; top device work by name: "
          f"{top or 'not measured'}", flush=True)

    # K1 and K2 at the main path's own shapes
    st = drv._state(TARGET)
    k1_ms = k1_dev = k1_plain = k1_bound = 0.0
    k1_by = "bytes"
    k2_err = 0
    k2 = collections.Counter()
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
        bms, k1_by = k1_bound_of(ex, ir_eval, prog, arrays)
        k1_bound += bms / len(kinds)
        k1_ms += cuda_ms(lambda: ir_eval.eval_mask(prog, arrays)) / len(kinds)
        k1_dev += graph_ms(lambda: ir_eval.eval_mask(prog, arrays)) \
            / len(kinds)
        k1_plain += cuda_ms(lambda: ex._eval_mask(prog, arrays),
                            iters=5) / len(kinds)
        rank = arrays["__rank__"]
        g2 = topk.topk_packed(got, rank, CAP)
        w2 = topk.topk_packed_plain(got, rank, CAP)
        k = CAP
        k2_err = max(k2_err, packed_err(g2, w2, k))
        if k2_err:
            fail(f"K2 mismatch on north-star template {kind}")
        n2 = k2_numbers(topk, got, rank, k)
        k2_by = n2.pop("bound_by")
        k2.update({key: v / len(kinds) for key, v in n2.items()})
    rec["K1"] = {"launches": counts["K1"], "max_abs_err": k1_err, "ms": k1_ms,
                 "device_ms": k1_dev, "plain_ms": k1_plain,
                 "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None}
    rec["K2"] = {"launches": counts["K2"], "max_abs_err": k2_err, **k2,
                 "bound_by": k2_by}
    print(f"phase main kernels: per launch at the sweep's shapes (mean over "
          f"{len(kinds)} kinds): K1 {k1_text(rec['K1'])}; K2 "
          f"{k2_text(rec['K2'])}; both equal "
          f"their plain versions", flush=True)
    c_pad, r_pad = got.shape
    # a copy of one kind's steady stored mask, for K6 at [C_pad, R_pad]
    # in the devpages phase (against the same kind's first churned mask;
    # copies, so the churn's memory readings see the generations freed)
    mask_kind = "K8sRequiredLabels"
    main_masks = [stored_mask(st, mask_kind).clone()]
    del st, arrays, got, want, g2, w2

    # the same store on the CPU path
    t0 = time.perf_counter()
    cpu = TorchDriver(device="cpu")
    cpu_client = setup_north_star(cpu, resources, random.Random(2))
    cpu_res, _ = cpu.query_audit(TARGET, opts)
    if norm(cpu_res) != norm(cold):
        fail("card results differ from TorchDriver(device='cpu')")
    cpu_s = time.perf_counter() - t0

    # ---- 5. churn on the same driver and store: 3 rounds, each upserting
    # 1% of the pods (new labels on existing names, as bench.py's churn
    # does) and then a capped sweep, against the CPU driver
    n_churn = max(args.resources // 100, 1)
    churn_rng = random.Random(1234)
    label_pool = [f"l{j}" for j in range(10)]
    orig = {"K5": ir_eval.delta_mask}
    calls = {"K5": []}
    k4_calls = K4Calls(scatter)
    churn_counts = dict.fromkeys(fns, 0)
    x = drv.executor
    mem = []
    for rep in range(3):
        batch = []
        for i in churn_rng.sample(range(args.resources), n_churn):
            o = copy.deepcopy(resources[i])
            o["metadata"]["labels"] = {k: "v" for k in label_pool
                                       if churn_rng.random() < 0.35}
            resources[i] = o
            batch.append(o)
        t0 = time.perf_counter()
        for o in batch:
            client.add_data(o)
        upsert_s = time.perf_counter() - t0
        for o in batch:
            cpu_client.add_data(o)
        if rep == 0:
            # keep the first sweep's K4/K5 inputs to check them after it
            k4_calls.install()
            ir_eval.delta_mask = recording(orig["K5"], calls["K5"])
        before = (x.mask_evals, x.delta_evals, x.h2d_bytes,
                  x.h2d_scatter_bytes, x.h2d_scatter_rows)
        variants = [triton_variants(ir_eval)]
        reset_counts(fns)
        t0 = time.perf_counter()
        res, _ = drv.query_audit(TARGET, opts)
        sweep_s = time.perf_counter() - t0
        swept = launch_counts(fns)
        variants.append(triton_variants(ir_eval))
        if rep == 0 and (None in variants or variants[1] != variants[0]):
            fail(f"the first churned sweep compiled Triton variants "
                 f"{variants} (before, after) after the delta warm-up")
        k4_calls.restore()
        ir_eval.delta_mask = orig["K5"]
        for k, v in swept.items():
            churn_counts[k] += v
        d_mask, d_delta, d_h2d, d_sb, d_sr = (
            a - b for a, b in zip((x.mask_evals, x.delta_evals, x.h2d_bytes,
                                   x.h2d_scatter_bytes, x.h2d_scatter_rows),
                                  before))
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
        want_res, _ = cpu.query_audit(TARGET, opts)
        if norm(res) != norm(want_res):
            fail(f"churn sweep {rep + 1} differs from TorchDriver(cpu)")
        if (swept["K5"], swept["K1"], d_delta, d_mask) != (3, 0, 3, 0) \
                or not 0 < swept["K4"] <= 3 or swept["K4m"] != swept["K4"]:
            fail(f"churn sweep {rep + 1} did not take the delta plan with "
                 f"one batched K4 launch per migrating kind: launches "
                 f"{swept}, delta_evals {d_delta}, mask_evals {d_mask}")
        print(f"phase churn {rep + 1}: upsert {n_churn} pods {upsert_s:.3f}s,"
              f" capped sweep {sweep_s:.4f}s"
              + (" (1.76-2.43 s on an H100 80GB HBM3 when the first "
                 "churned sweep still compiled K5's variant)" if rep == 0
                 else "")
              + f", Triton variants {variants[0]} -> {variants[1]}, "
              f"{len(res)} results equal "
              f"TorchDriver(cpu); delta_evals {d_delta}, mask_evals "
              f"{d_mask}, launches {swept}, h2d_bytes {d_h2d}, "
              f"h2d_scatter_bytes {d_sb} ({d_sr} rows), memory_allocated "
              f"{mem[-1]}", flush=True)
        if rep:
            continue
        main_masks.append(stored_mask(drv._state(TARGET), mask_kind).clone())
        # K4 and K5 on the churn's own inputs, bit for bit, and timed
        k4_args = [a for a, _ in k4_calls.jobs()]
        batches = [a[0] for a, _ in k4_calls.many]
        n_k4, k4_err = k4_calls.check("a churned sweep")
        k5_err = 0.0
        for (prog, d, viol_old, rows), got in calls["K5"]:
            want = ex._delta_mask(prog, d, viol_old, rows)
            if not torch.equal(got, want):
                fail("K5 mismatch on a churn delta")
            k5_err = max(k5_err, max_err(got, want))
        k5_args = [a for a, _ in calls["K5"]]
        shapes = sorted({(tuple(a[0].shape), str(a[0].dtype).replace(
            "torch.", ""), a[1].numel()) for a in k4_args})
        rec["K4"] = {"max_abs_err": k4_err, **k4_numbers(scatter, k4_args)}
        rec["K4m"] = {"max_abs_err": k4_err,
                      **k4m_numbers(scatter, batches)}
        rec["K5"] = {"max_abs_err": k5_err, **k5_numbers(ex, ir_eval,
                                                         k5_args)}
        k4, k4m = rec["K4"], rec["K4m"]
        print(f"phase churn kernels: K4 equal to plain on the sweep's "
              f"{n_k4} scatters in {len(batches)} batched calls ({shapes});"
              f" per job through scatter_rows {k4['ms']:.4f} ms mean, "
              f"device {k4['device_ms']:.4f} (plain {k4['plain_ms']:.4f}, "
              f"torch.index_copy {k4['library_ms']:.4f}, device "
              f"{k4['library_device_ms']:.4f}; bound {k4['bound_ms']:.6f});"
              f" per batched call {k4m['ms']:.4f} ms mean, device "
              f"{k4m['device_ms']:.4f} (plain {k4m['plain_ms']:.4f}, one "
              f"torch.index_copy a job {k4m['library_ms']:.4f}, device "
              f"{k4m['library_device_ms']:.4f}; bound "
              f"{k4m['bound_ms']:.6f}); K5 equal to plain on its "
              f"{len(k5_args)} deltas (rows {k5_args[0][3].numel()}, mask "
              f"{list(k5_args[0][2].shape)}): {k1_text(rec['K5'])} mean, "
              f"of it the mask copy device "
              f"{rec['K5']['clone_device_ms']:.4f}", flush=True)
        # drop every reference to the first sweep's tensors before the
        # next sweeps' memory readings
        del calls, k4_args, batches, k5_args, got, want, rows, prog, d, \
            viol_old
    rec["K4"]["launches"] = churn_counts["K4"]
    rec["K4m"]["launches"] = churn_counts["K4m"]
    rec["K5"]["launches"] = churn_counts["K5"]
    if mem[2] - mem[1] >= c_pad * r_pad:
        fail(f"device memory grew by {mem[2] - mem[1]} bytes from the "
             f"second churned sweep to the third (one [{c_pad}, {r_pad}] "
             f"mask is {c_pad * r_pad})")
    print(f"phase churn memory: memory_allocated after each sweep {mem}; "
          f"third - second {mem[2] - mem[1]} bytes (< one mask, "
          f"{c_pad * r_pad})", flush=True)
    # forced full sweeps of the churned north-star store, against the
    # last churned sweep (equal to TorchDriver(cpu)'s)
    fs_ns: dict = {}
    ns_full = full_sweeps(drv, fns, norm(res), "north star", ("K1", "K2"),
                          record=fs_ns)
    print(f"phase full sweep north star: {args.resources} pods x 201 "
          f"constraints, cap {CAP}, after the churn: results equal the "
          f"memoized sweep's and TorchDriver(cpu)'s, no Triton variant "
          f"compiled, h2d_bytes = the kinds' Bindings.nbytes() and shared "
          f"dedup columns: "
          f"{json.dumps(ns_full)}", flush=True)
    del drv, client, cpu, cpu_client, x

    # the scalar oracle on a subsample
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
    dig_warm = ingest_warm_text(dig)
    reset_counts(fns)
    dig_res, _ = dig.query_audit(TARGET, opts)
    dig_counts = counts_of("K1", "K2", "K3")
    dig.wait_delta_warm()
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
    rec["K3"] = {"launches": dig_counts["K3"], "max_abs_err": k3_err,
                 **k3_numbers(dfa, ins)}
    print(f"phase K3 store: K8sImageDigests over {args.resources} pods "
          f"({dig_warm}), "
          f"{len(dig_res)} capped results, launches {dig_counts}; K3 equal "
          f"to plain on the string table, {k3_text(dfa, ins, rec['K3'])}",
          flush=True)
    del dig, dc, st, arrays
    # K1 and K2 at the north-star full sweep's recorded inputs, K3 at the
    # library full sweep's (the north star has no regex template)
    k123_entries(rec, "fs", {"K1": fs_ns["calls"]["K1"],
                             "K2": fs_ns["calls"]["K2"],
                             "K3": fs_lib["calls"]["K3"]},
                 {"K1": fs_ns["counts"]["K1"], "K2": fs_ns["counts"]["K2"],
                  "K3": fs_lib["counts"]["K3"]},
                 {"K1": fs_ns["errs"]["K1"], "K2": fs_ns["errs"]["K2"],
                  "K3": fs_lib["errs"]["K3"]})
    print(f"phase full sweep kernels: each recorded launch of the "
          f"last full sweeps equal to its plain version; K1 "
          f"{k1_text(rec['K1fs'])} and K2 {k2_text(rec['K2fs'])} at the "
          f"north star's, K3 "
          f"{k3_text(dfa, fs_lib['calls']['K3'][0][0], rec['K3fs'])} at "
          f"the library's; launches on the last sweeps: north star "
          f"{fs_ns['counts']}, library {fs_lib['counts']}", flush=True)
    del fs_ns, fs_lib

    mark("random kernels, library, main, churn, check, K3 store")

    # ---- 6. fleet: N clusters' stores stacked into one batched sweep
    # per kind (B9)
    fleet_phase(rec, fns, dev)
    mark("fleet")

    # ---- 7. devpages: the paged audit with device-resident deltas (B6),
    # then 8. devpages budget: the residency planner (B8)
    devpages_phase(rec, fns, dev, main_masks)
    del main_masks
    mark("devpages, budget")

    # ---- 9. devpages ingress: the inventory-join kind on the device (B7)
    ingress_phase(rec, fns, dev)
    mark("ingress")

    # ---- 10. admission: the review micro-batch on the card
    admission_phase(rec, fns, oracle=answers)
    mark("admission")

    # ---- 11. manager: the process on the card, through its entry points
    manager_phase(rec, fns, oracle=answers)
    mark("manager")

    # ---- 12. reactor: the manager's default paged route, watch events
    # folded into the verdict ledger between sweeps
    reactor_phase(rec, fns, args.reactor_pods)
    mark("reactor")

    # ---- 13. worker: the engine in a worker process behind the manager,
    # and a pool of worker processes on the card
    worker_phase(rec, fns, oracle=answers)
    mark("worker")

    # ---- 14. extdata: external data on the card (the bench's row, a
    # large registry, the HTTP provider, an admission batch)
    extdata_phase(rec, fns)
    mark("extdata")

    # ---- 15. probe: the self-test scenarios and --cost on the card
    probe_phase(fns)
    mark("probe")

    # ---- 16. reuse and what-if: dedup, selective reuse, shadow sweeps,
    # replay, rollout, explain_pair and the probe's what-if subcommands
    reuse_phase(rec, fns)
    mark("reuse")
    print(f"phase timing: seconds a phase after the build {took}, "
          f"{sum(took.values()):.1f}s in all", flush=True)

    # ---- 17. kernels line, card line, final line
    meta = {
        "K1": ("ir_eval", "triton", "gatekeeper_tpu_torch/kernels/ir_eval.py",
               "gatekeeper_tpu/engine/veval.py:294"),
        "K2": ("topk", "cuda", "gatekeeper_tpu_torch/csrc/topk.cu",
               "gatekeeper_tpu/engine/veval.py:660"),
        "K3": ("dfa", "cuda", "gatekeeper_tpu_torch/csrc/dfa.cu",
               "gatekeeper_tpu/engine/veval.py:227"),
        "K4": ("scatter_rows", "cuda", "gatekeeper_tpu_torch/csrc/scatter.cu",
               "gatekeeper_tpu/engine/veval.py:1049"),
        "K4m": ("scatter_rows_many", "cuda",
                "gatekeeper_tpu_torch/csrc/scatter.cu",
                "gatekeeper_tpu/engine/veval.py:1049"),
        "K5": ("ir_eval_delta", "triton",
               "gatekeeper_tpu_torch/kernels/ir_eval.py",
               "gatekeeper_tpu/engine/veval.py:1579"),
        "K1b": ("ir_eval_batched", "triton",
                "gatekeeper_tpu_torch/kernels/ir_eval.py",
                "gatekeeper_tpu/whatif/fleet.py:60"),
        "K1bl": ("ir_eval_batched_library_fleet", "triton",
                 "gatekeeper_tpu_torch/kernels/ir_eval.py",
                 "gatekeeper_tpu/whatif/fleet.py:60"),
        "K2b": ("topk_batched", "cuda", "gatekeeper_tpu_torch/csrc/topk.cu",
                "gatekeeper_tpu/whatif/fleet.py:47"),
        "K3b": ("dfa_batched", "cuda", "gatekeeper_tpu_torch/csrc/dfa.cu",
                "gatekeeper_tpu/whatif/fleet.py:47"),
        "K6": ("devdelta", "cuda", "gatekeeper_tpu_torch/csrc/devdelta.cu",
               "gatekeeper_tpu/engine/veval.py:1185"),
        "K7": ("invjoin", "cuda", "gatekeeper_tpu_torch/csrc/invjoin.cu",
               "gatekeeper_tpu/engine/veval.py:545"),
        "K8g": ("residency_page_gather", "cuda",
                "gatekeeper_tpu_torch/csrc/residency.cu",
                "gatekeeper_tpu/enforce/devpages.py:233"),
        "K8s": ("residency_page_scatter", "cuda",
                "gatekeeper_tpu_torch/csrc/residency.cu",
                "gatekeeper_tpu/enforce/devpages.py:271"),
        "K1r": ("ir_eval_review_batch", "triton",
                "gatekeeper_tpu_torch/kernels/ir_eval.py",
                "gatekeeper_tpu/engine/veval.py:294"),
        "K3r": ("dfa_review_batch", "cuda", "gatekeeper_tpu_torch/csrc/dfa.cu",
                "gatekeeper_tpu/engine/veval.py:227"),
        "K1mgr": ("ir_eval_manager_audit", "triton",
                  "gatekeeper_tpu_torch/kernels/ir_eval.py",
                  "gatekeeper_tpu/engine/veval.py:294"),
        "K2mgr": ("topk_manager_audit", "cuda",
                  "gatekeeper_tpu_torch/csrc/topk.cu",
                  "gatekeeper_tpu/engine/veval.py:660"),
        "K3mgr": ("dfa_manager_audit", "cuda",
                  "gatekeeper_tpu_torch/csrc/dfa.cu",
                  "gatekeeper_tpu/engine/veval.py:227"),
        "K4mgr": ("scatter_rows_many_manager_churn", "cuda",
                  "gatekeeper_tpu_torch/csrc/scatter.cu",
                  "gatekeeper_tpu/engine/veval.py:1049"),
        "K5mgr": ("ir_eval_delta_manager_churn", "triton",
                  "gatekeeper_tpu_torch/kernels/ir_eval.py",
                  "gatekeeper_tpu/engine/veval.py:1579"),
        "K1rmgr": ("ir_eval_manager_admission", "triton",
                   "gatekeeper_tpu_torch/kernels/ir_eval.py",
                   "gatekeeper_tpu/engine/veval.py:294"),
        "K3rmgr": ("dfa_manager_admission", "cuda",
                   "gatekeeper_tpu_torch/csrc/dfa.cu",
                   "gatekeeper_tpu/engine/veval.py:227"),
        "K4rx": ("scatter_rows_many_reactor", "cuda",
                 "gatekeeper_tpu_torch/csrc/scatter.cu",
                 "gatekeeper_tpu/engine/veval.py:1049"),
        "K3rx": ("dfa_reactor", "cuda", "gatekeeper_tpu_torch/csrc/dfa.cu",
                 "gatekeeper_tpu/engine/veval.py:227"),
        "K1rx": ("ir_eval_reactor", "triton",
                 "gatekeeper_tpu_torch/kernels/ir_eval.py",
                 "gatekeeper_tpu/engine/veval.py:294"),
        "K6rx": ("devdelta_reactor", "cuda",
                 "gatekeeper_tpu_torch/csrc/devdelta.cu",
                 "gatekeeper_tpu/engine/veval.py:1185"),
        "K1fs": ("ir_eval_full_sweep", "triton",
                 "gatekeeper_tpu_torch/kernels/ir_eval.py",
                 "gatekeeper_tpu/engine/veval.py:294"),
        "K2fs": ("topk_full_sweep", "cuda",
                 "gatekeeper_tpu_torch/csrc/topk.cu",
                 "gatekeeper_tpu/engine/veval.py:660"),
        "K3fs": ("dfa_full_sweep", "cuda",
                 "gatekeeper_tpu_torch/csrc/dfa.cu",
                 "gatekeeper_tpu/engine/veval.py:227"),
        "K1wk": ("ir_eval_worker_audit", "triton",
                 "gatekeeper_tpu_torch/kernels/ir_eval.py",
                 "gatekeeper_tpu/engine/veval.py:294"),
        "K2wk": ("topk_worker_audit", "cuda",
                 "gatekeeper_tpu_torch/csrc/topk.cu",
                 "gatekeeper_tpu/engine/veval.py:660"),
        "K3wk": ("dfa_worker_audit", "cuda",
                 "gatekeeper_tpu_torch/csrc/dfa.cu",
                 "gatekeeper_tpu/engine/veval.py:227"),
        "K1ext": ("ir_eval_external_data", "triton",
                  "gatekeeper_tpu_torch/kernels/ir_eval.py",
                  "gatekeeper_tpu/engine/veval.py:294"),
        "K2ext": ("topk_external_data", "cuda",
                  "gatekeeper_tpu_torch/csrc/topk.cu",
                  "gatekeeper_tpu/engine/veval.py:660"),
        "K3ext": ("dfa_external_data", "cuda",
                  "gatekeeper_tpu_torch/csrc/dfa.cu",
                  "gatekeeper_tpu/engine/veval.py:227"),
        "K1dd": ("ir_eval_dedup_rewritten", "triton",
                 "gatekeeper_tpu_torch/kernels/ir_eval.py",
                 "gatekeeper_tpu/engine/veval.py:294"),
        "K1sh": ("ir_eval_shadow_sweep", "triton",
                 "gatekeeper_tpu_torch/kernels/ir_eval.py",
                 "gatekeeper_tpu/engine/veval.py:294"),
        "K2sh": ("topk_shadow_sweep", "cuda",
                 "gatekeeper_tpu_torch/csrc/topk.cu",
                 "gatekeeper_tpu/engine/veval.py:660"),
        "K1bg": ("ir_eval_batched_graduate_fleet", "triton",
                 "gatekeeper_tpu_torch/kernels/ir_eval.py",
                 "gatekeeper_tpu/whatif/fleet.py:60"),
        "K2bg": ("topk_batched_graduate_fleet", "cuda",
                 "gatekeeper_tpu_torch/csrc/topk.cu",
                 "gatekeeper_tpu/whatif/fleet.py:47"),
        "K3bg": ("dfa_batched_graduate_fleet", "cuda",
                 "gatekeeper_tpu_torch/csrc/dfa.cu",
                 "gatekeeper_tpu/whatif/fleet.py:47"),
    }
    kernels = []
    for key in ("K1", "K2", "K3", "K4", "K4m", "K5", "K1b", "K1bl", "K2b",
                "K3b", "K6", "K7", "K8g", "K8s", "K1r", "K3r", "K1mgr",
                "K2mgr", "K3mgr", "K4mgr", "K5mgr", "K1rmgr", "K3rmgr",
                "K4rx", "K3rx", "K1rx", "K6rx", "K1fs", "K2fs", "K3fs",
                "K1wk", "K2wk", "K3wk", "K1ext", "K2ext", "K3ext", "K1dd",
                "K1sh", "K2sh", "K1bg", "K2bg", "K3bg"):
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
