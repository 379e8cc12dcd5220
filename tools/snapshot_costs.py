"""Time the host work of a cold paged sweep and of a warm restart's
store snapshot: the pickler of the save, and the cyclic-GC pauses
(``utils/gcpause.BulkLoad``) of the ingest, the sweeps and the restore.

    python3 tools/snapshot_costs.py [--pods N] [--device DEV]
                                    [--no-gc-pause]

Ingests ``--pods`` north-star pods (66,000, as ``chip_smoke.py``'s
devpages phase) under one constraint a template on a ``TorchDriver``
(the card unless ``--device cpu``) and takes the cold capped sweep with
GATEKEEPER_PAGES and GATEKEEPER_DEVPAGES on.  Then, under a fresh
GATEKEEPER_SNAPSHOT_DIR:

- pickles the store and the pagemap payloads three times each with the
  snapshot's closure-aware pickler (``snapshot.dumps``) and with the
  stdlib's C pickler (``pickle.dumps``), and keeps each one's best;
- saves the snapshot, restores it into a fresh driver and takes that
  driver's first capped sweep (the one that adopts the ledger).

``--no-gc-pause`` makes ``BulkLoad`` a no-op for the process (the
collector runs through every burst and nothing is frozen): run the
tool once with it and once without, each in its own process, to
compare.  Prints the card's name and power limit when on the card,
then one JSON line of bytes and seconds.
"""

import argparse
import io
import json
import os
import pickle
import random
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = "admission.k8s.gatekeeper.sh"


def best_of(fn, n: int = 3) -> float:
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pods", type=int, default=66_000)
    ap.add_argument("--device", default=None)
    ap.add_argument("--no-gc-pause", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch
    from gatekeeper_tpu_torch.client.interface import QueryOpts
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.library.north_star import (make_resources,
                                                         setup_north_star)
    from gatekeeper_tpu_torch.resilience import snapshot as snap
    from gatekeeper_tpu_torch.utils import gcpause
    if args.no_gc_pause:
        gcpause.BulkLoad.__enter__ = lambda self: self
        gcpause.BulkLoad.__exit__ = lambda self, *exc: None

    opts = QueryOpts(limit_per_constraint=20)
    os.environ["GATEKEEPER_PAGES"] = "on"
    os.environ["GATEKEEPER_DEVPAGES"] = "on"
    out = {"pods": args.pods, "gc_pause": not args.no_gc_pause}
    a = TorchDriver(device=args.device)
    t0 = time.perf_counter()
    setup_north_star(a, make_resources(args.pods, random.Random(1)),
                     random.Random(2), c_per_kind=1)
    out["ingest_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    want, _ = a.query_audit(TARGET, opts)
    out["cold_sweep_s"] = time.perf_counter() - t0
    st = a._state(TARGET)
    payloads = {"store": st.table.snapshot_state(),
                "pagemap": st.ledger.snapshot_payload()}
    for name, obj in payloads.items():
        out[f"{name}_bytes"] = len(snap.dumps(obj))
        out[f"{name}_closure_pickler_s"] = best_of(lambda: snap.dumps(obj))
        out[f"{name}_c_pickler_s"] = best_of(
            lambda: pickle.dump(obj, io.BytesIO(), protocol=4))
    del payloads

    snapdir = tempfile.mkdtemp(prefix="gatekeeper-snapshot-costs-")
    os.environ["GATEKEEPER_SNAPSHOT_DIR"] = snapdir
    t0 = time.perf_counter()
    assert a.save_store_snapshot(TARGET)
    out["save_s"] = time.perf_counter() - t0
    d = TorchDriver(device=args.device)
    setup_north_star(d, [], random.Random(2), c_per_kind=1)
    t0 = time.perf_counter()
    assert d.restore_store_snapshot(TARGET)
    out["restore_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, _ = d.query_audit(TARGET, opts)
    out["first_sweep_s"] = time.perf_counter() - t0
    assert sorted(repr(r) for r in got) == sorted(repr(r) for r in want)
    assert d.metrics.counter("ledger_snapshot_adoptions").value == 3
    shutil.rmtree(snapdir, ignore_errors=True)
    if torch.cuda.is_available() and args.device in (None, "cuda"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
