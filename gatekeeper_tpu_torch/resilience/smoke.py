# Copied from gatekeeper_tpu/resilience/smoke.py for the PyTorch port.
"""Restart smoke: one cold-or-warm startup measurement, JSON verdict.

``python -m gatekeeper_tpu_torch.resilience.smoke [--device DEV]``
builds the full policy library against a TorchDriver (on the card
unless ``--device cpu``), every kind on the device path, ingests a
deterministic mixed inventory (or restores it from the store snapshot),
runs one forced full audit sweep at the audit manager's default cap of
violations a constraint (the reference's smoke sweeps uncapped; a
deployed audit is capped, and the cap puts K2 on the path), persists
the store snapshot, and prints a single JSON line::

    {"serving_seconds": ..., "restart_persistent_cache_hits": ...,
     "lowerings": ..., "templates": ..., "store_restored": ...,
     "verdict_digest": ..., "n_results": ..., "builds": {...}, ...}

Run it twice against the same ``GATEKEEPER_SNAPSHOT_DIR`` (fresh
directory for the cold run) and the warm process must show
``restart_persistent_cache_hits > 0``, ``restart_persistent_cache_misses
== 0``, ``lowerings == 0`` (no Rego re-lowering, no re-verification),
``validations == 0``, ``footprints == 0``, ``shardplans == 0``,
``compile_surfaces == 0``, ``memsurfaces == 0`` and ``dfa_compiles ==
0`` (every certificate and automaton restored from its snapshot tier),
``aot_precompiles == 0`` (the precompile's geometry stamp is in the cs
tier), ``store_restored`` true, an identical ``verdict_digest``, and, on
the card, no ``nvcc`` build and no Triton variant compiled from scratch
(``builds``: the build caches' hits and misses,
utils/compile_cache.py; ``launches``: the sweep's K1, K2 and K3
launches on the card).  Translation validation runs in ``warn`` unless
``GATEKEEPER_TRANSVAL`` says otherwise, its worlds on the driver's
device.

Knob: ``GATEKEEPER_SMOKE_N`` (resources, default 300).  The snapshot
directory must not be shared across different ``GATEKEEPER_SMOKE_N``
values (the store snapshot is keyed by target, not by size).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import sys
import time


def _verdict_digest(results) -> str:
    items = sorted(
        ((r.constraint or {}).get("kind", ""),
         ((r.constraint or {}).get("metadata") or {}).get("name", ""),
         (r.resource or {}).get("kind", ""),
         str(((r.resource or {}).get("metadata") or {}).get("namespace")),
         ((r.resource or {}).get("metadata") or {}).get("name", ""),
         r.msg)
        for r in results)
    return hashlib.sha256(repr(items).encode()).hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gatekeeper_tpu_torch.resilience.smoke")
    ap.add_argument("--device", default=None,
                    help="the driver's torch device (the card by default)")
    args = ap.parse_args(argv)
    n = int(os.environ.get("GATEKEEPER_SMOKE_N", "300"))
    # translation validation on by default here: the warm process must
    # load every Certificate from the cert snapshot tier instead of
    # re-running the small-model check ("validations" == 0 warm)
    os.environ.setdefault("GATEKEEPER_TRANSVAL", "warn")
    # same contract for the Stage-6 partition plans ("shardplans" == 0)
    os.environ.setdefault("GATEKEEPER_SHARDPLAN", "warn")
    # and for the Stage-7 compile surfaces: the warm process must load
    # every certificate from the cs tier ("compile_surfaces" == 0) AND
    # skip the startup precompile via the cs-tier geometry stamp
    # ("aot_precompiles" == 0)
    os.environ.setdefault("GATEKEEPER_COMPILE_SURFACE", "warn")
    # the Stage-8 memory surfaces: the warm process must load every
    # certificate from the ms tier ("memsurfaces" == 0)
    os.environ.setdefault("GATEKEEPER_HBM_BUDGET", "warn")

    # imports before the clock starts: interpreter + torch import cost is
    # identical for cold and warm processes and would only dilute the
    # startup ratio
    from gatekeeper_tpu_torch.analysis import (compilesurface, footprint,
                                               memsurface, shardplan,
                                               transval)
    from gatekeeper_tpu_torch.audit.manager import DEFAULT_VIOLATIONS_LIMIT
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.client.interface import QueryOpts
    from gatekeeper_tpu_torch.engine import torch_driver as td_mod
    from gatekeeper_tpu_torch.kernels import dfa, ir_eval, topk
    from gatekeeper_tpu_torch.library import all_docs, make_mixed
    from gatekeeper_tpu_torch.ops import regex_dfa
    from gatekeeper_tpu_torch.resilience import snapshot as snap
    from gatekeeper_tpu_torch.target.k8s import (TARGET_NAME,
                                                 K8sValidationTarget)
    from gatekeeper_tpu_torch.utils.compile_cache import \
        persistent_cache_stats

    if not snap.enabled():
        print(json.dumps({"error": "GATEKEEPER_SNAPSHOT_DIR not set"}))
        return 2
    # every kind on the device path: the driver's small-workload
    # shortcut would keep a library store this size on the scalar oracle
    td_mod.SMALL_WORKLOAD_EVALS = 0

    # count actual Rego lowerings: the warm path must never reach
    # lower_template (the acceptance criterion "no re-lowering")
    calls = {"lowerings": 0}
    orig_lower = td_mod.lower_template

    def counting_lower(*a, **k):
        calls["lowerings"] += 1
        return orig_lower(*a, **k)
    td_mod.lower_template = counting_lower

    t0 = time.perf_counter()
    drv = td_mod.TorchDriver(device=args.device)
    client = Backend(drv).new_client([K8sValidationTarget()])
    for tdoc, cdoc in all_docs():
        client.add_template(tdoc)
        client.add_constraint(cdoc)
    restored = drv.restore_store_snapshot(TARGET_NAME)
    if not restored:
        client.add_data_batch(make_mixed(random.Random(5), n))
    drv.prepare_audit(TARGET_NAME)
    # startup = driver + template install + inventory + audit prep (the
    # whole-policy-set dedup plan): the window warm restart accelerates
    # (parse/vet/lower/verify/plan skipped, store restored instead of
    # replicated).  The sweep after this line is workload, identical
    # cold and warm by construction.
    startup_s = time.perf_counter() - t0
    wrappers = {"K1": ir_eval.eval_mask, "K2": topk.topk_packed,
                "K3": dfa.dfa_table}
    before = {k: fn.launches for k, fn in wrappers.items()}
    results, _trace = drv.query_audit(
        TARGET_NAME,
        QueryOpts(limit_per_constraint=DEFAULT_VIOLATIONS_LIMIT, full=True))
    serving_s = time.perf_counter() - t0
    launches = {k: fn.launches - before[k] for k, fn in wrappers.items()}
    # the delta warm a capped sweep starts on the card compiles (or loads)
    # its variants on its own thread: join it, so the build caches'
    # counts below are the process's whole
    drv.wait_delta_warm()

    drv.save_store_snapshot(TARGET_NAME)
    st = drv.state[TARGET_NAME]
    rep = snap.restart_report()
    out = {
        "startup_seconds": round(startup_s, 3),
        "serving_seconds": round(serving_s, 3),
        "restart_persistent_cache_hits":
            rep["restart_persistent_cache_hits"],
        "restart_persistent_cache_misses":
            rep["restart_persistent_cache_misses"],
        "lowerings": calls["lowerings"],
        "templates": len(st.templates),
        "store_restored": restored,
        "n_rows": len(st.table),
        "n_results": len(results),
        "verdict_digest": _verdict_digest(results),
        "validations": transval.validations_run,
        "footprints": footprint.analyses_run,
        "shardplans": shardplan.analyses_run,
        "dfa_compiles": regex_dfa.compiles_run,
        "compile_surfaces": compilesurface.analyses_run,
        "aot_precompiles": compilesurface.precompiles_run,
        "memsurfaces": memsurface.analyses_run,
        "device": str(drv.device),
        "launches": launches,
        "builds": persistent_cache_stats().snapshot(),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
