# Copied from gatekeeper_tpu/library/buckets.py for the PyTorch port.
"""Lowering-bucket inventory for the shipped template corpus.

Every template the build ships (the 49-template library plus the demo
templates) is classified into exactly one evaluation bucket:

- ``device-lowered``   — compiles to the tensor IR; audits run on the
  device engine (scalar oracle still formats violating pairs).
- ``scalar-fallback``  — outside the lowerable subset (reason given);
  runs on the scalar oracle restricted to match-mask candidates.
  Same results, different engine (engine/torch_driver.py module doc).
- ``rejected``         — does not compile at all (parse/compile error).

The committed table (``lowering_buckets.json``) is the contract:
tests/test_torch_lowering_buckets.py recomputes this classification and
fails if any template silently changes bucket — a lowering regression
(device template falling back to scalar) or an unsound widening
(scalar template suddenly "lowering") must be a deliberate, reviewed
change to the JSON.  The port's table is computed from the port's own
lowering (``python -m gatekeeper_tpu_torch.library.buckets`` rewrites
it) and equals the JAX package's entry for entry.
"""

from __future__ import annotations

import glob
import json
import os

from gatekeeper_tpu_torch.ir.lower import CannotLower, lower_template
from gatekeeper_tpu_torch.library.templates import LIBRARY
from gatekeeper_tpu_torch.rego import parse_module
from gatekeeper_tpu_torch.rego.interp import Interpreter

_REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "lowering_buckets.json")


def classify_rego(rego: str) -> str:
    try:
        interp = Interpreter(parse_module(rego))
    except Exception as e:      # noqa: BLE001 — classification, not serving
        return f"rejected: {type(e).__name__}: {e}"
    try:
        lowered = lower_template(interp.module, interp)
    except CannotLower as e:
        return f"scalar-fallback: {e}"
    if lowered is None:
        return "scalar-fallback"
    return "device-lowered"


def _demo_templates() -> dict[str, str]:
    """kind -> rego for every demo ConstraintTemplate yaml."""
    out = {}
    try:
        import yaml
    except ImportError:         # pragma: no cover
        return out
    for path in sorted(glob.glob(
            os.path.join(_REPO, "demo", "*", "templates", "*.yaml"))):
        with open(path) as f:
            doc = yaml.safe_load(f)
        if not isinstance(doc, dict) or doc.get("kind") != "ConstraintTemplate":
            continue
        kind = doc["spec"]["crd"]["spec"]["names"]["kind"]
        rego = doc["spec"]["targets"][0]["rego"]
        rel = os.path.relpath(path, _REPO)
        out[f"{kind} ({rel})"] = rego
    return out


def compute_buckets() -> dict[str, str]:
    buckets = {kind: classify_rego(LIBRARY[kind][0])
               for kind in sorted(LIBRARY)}
    for name, rego in _demo_templates().items():
        buckets[name] = classify_rego(rego)
    return buckets


def load_committed() -> dict[str, str]:
    with open(TABLE_PATH) as f:
        return json.load(f)


def render_markdown(buckets: dict[str, str]) -> str:
    lines = ["| template | bucket |", "|---|---|"]
    for k in sorted(buckets):
        lines.append(f"| {k} | {buckets[k]} |")
    counts: dict[str, int] = {}
    for v in buckets.values():
        counts[v.split(":")[0]] = counts.get(v.split(":")[0], 0) + 1
    summary = ", ".join(f"{n} {b}" for b, n in sorted(counts.items()))
    return "\n".join(lines) + f"\n\n({summary} of {len(buckets)} total)\n"


if __name__ == "__main__":
    b = compute_buckets()
    with open(TABLE_PATH, "w") as f:
        json.dump(b, f, indent=1, sort_keys=True)
        f.write("\n")
    print(render_markdown(b))
