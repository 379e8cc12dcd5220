"""Time the audit sweeps of one tree's ``gatekeeper_tpu_torch`` on one
CUDA card, so that two trees can be compared in one call.

    python3 tools/sweep_ab.py [--tree DIR] [--store north-star|library]
                              [--resources N]

Imports the package from DIR (default: this checkout) and, with
``GATEKEEPER_PAGES=off`` (the legacy route, as ``chip_smoke.py``'s main
phase), ingests one of two stores: ``north-star`` (the default),
``--resources`` make_resources pods (100,000) under the 201 north-star
constraints; or ``library``, every library template and its constraint
over ``--resources`` make_mixed rows (2,000 when not given), as
``chip_smoke.py``'s library phase.  It joins the ingest warm, and times
with the host clock: a cold capped sweep, 10 steady capped sweeps, 3
churned capped sweeps (1% of the objects relabelled before each, as the
churn phase does) and 3 forced full sweeps (``QueryOpts(full=True)``).
Prints the card's name and power limit, then one JSON line of the times
(and their medians).  Run it once a tree in turns (parent, change,
change, parent) from one command, each in its own process.
"""

import argparse
import copy
import json
import os
import random
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--store", choices=("north-star", "library"),
                    default="north-star")
    ap.add_argument("--resources", type=int, default=None)
    args = ap.parse_args()
    n = args.resources or (100_000 if args.store == "north-star"
                           else 2_000)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.environ["GATEKEEPER_PAGES"] = "off"
    import torch
    if not torch.cuda.is_available():
        print("sweep_ab: CUDA is not available", file=sys.stderr)
        return 2
    from gatekeeper_tpu_torch.client.interface import QueryOpts
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.kernels import build
    from gatekeeper_tpu_torch.library import all_docs, make_mixed
    from gatekeeper_tpu_torch.library.north_star import (make_resources,
                                                         setup_north_star)
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
    import gatekeeper_tpu_torch
    if not gatekeeper_tpu_torch.__file__.startswith(tree):
        print(f"sweep_ab: imported {gatekeeper_tpu_torch.__file__}, not "
              f"{tree}", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    build.build(("topk", "dfa", "scatter"))
    target = "admission.k8s.gatekeeper.sh"
    drv = TorchDriver()
    if args.store == "north-star":
        resources = make_resources(n, random.Random(1))
        client = setup_north_star(drv, resources, random.Random(2))
    else:
        resources = make_mixed(random.Random(0), n)
        client = Backend(drv).new_client([K8sValidationTarget()])
        for t, con in all_docs():
            client.add_template(t)
            client.add_constraint(con)
        client.add_data_batch(resources)
    drv.wait_ingest_warm()
    opts = QueryOpts(limit_per_constraint=20)

    def sweep(o) -> float:
        t0 = time.perf_counter()
        drv.query_audit(target, o)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = {"tree": tree, "store": args.store, "objects": n,
           "cold": sweep(opts)}
    drv.wait_delta_warm()
    out["steady"] = [sweep(opts) for _ in range(10)]
    rng = random.Random(1234)
    labels = [f"l{j}" for j in range(10)]
    out["churned"] = []
    for _ in range(3):
        for i in rng.sample(range(n), n // 100):
            o = copy.deepcopy(resources[i])
            o["metadata"]["labels"] = {k: "v" for k in labels
                                       if rng.random() < 0.35}
            resources[i] = o
            client.add_data(o)
        out["churned"].append(sweep(opts))
    out["full"] = [sweep(QueryOpts(limit_per_constraint=20, full=True))
                   for _ in range(3)]
    out["median"] = {k: statistics.median(out[k])
                     for k in ("steady", "churned", "full")}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
