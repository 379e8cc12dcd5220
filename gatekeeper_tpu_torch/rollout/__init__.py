# Copied from gatekeeper_tpu/rollout/__init__.py for the PyTorch port.
"""Policy promotion pipeline.

Composes the what-if engine (whatif/) and the graduated-enforcement
machinery (webhook/overload.py) into an evidence-gated rollout
subsystem:

- ``controller`` — the promotion state machine (candidate → shadow →
  replayed → dryrun → warn → deny, plus ``rejected``/``rolled_back``),
  gated on shadow-sweep + batched-corpus-replay evidence, installed by
  rewriting ``enforcementAction`` on live constraints, aborted by the
  brownout ladder.
- ``capture`` — the durable admission capture log: segmented,
  CRC-framed, bounded-queue background writer; the flight recorder's
  corpus store and the replay gate's evidence source.
- ``fleet`` — map-reduce graduation across device-sized cluster blocks
  with per-cluster evidence and straggler isolation.

Attribute access is lazy so the flight recorder can import
``rollout.capture`` (pure stdlib) from the admission path without
dragging the numpy/torch halves in.
"""

_EXPORTS = {
    "CaptureLog": "gatekeeper_tpu_torch.rollout.capture",
    "PromotionController": "gatekeeper_tpu_torch.rollout.controller",
    "ReplayGate": "gatekeeper_tpu_torch.rollout.controller",
    "live_enforcement_fingerprint": "gatekeeper_tpu_torch.rollout.controller",
    "PROMOTION_RUNGS": "gatekeeper_tpu_torch.rollout.controller",
    "ENFORCE_RUNGS": "gatekeeper_tpu_torch.rollout.controller",
    "REJECTED": "gatekeeper_tpu_torch.rollout.controller",
    "ROLLED_BACK": "gatekeeper_tpu_torch.rollout.controller",
    "graduate_fleet": "gatekeeper_tpu_torch.rollout.fleet",
    "fleet_block_size": "gatekeeper_tpu_torch.rollout.fleet",
    "FleetGraduationReport": "gatekeeper_tpu_torch.rollout.fleet",
    "ClusterEvidence": "gatekeeper_tpu_torch.rollout.fleet",
    "GRADUATED": "gatekeeper_tpu_torch.rollout.fleet",
    "BLOCKED": "gatekeeper_tpu_torch.rollout.fleet",
    "HELD": "gatekeeper_tpu_torch.rollout.fleet",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(mod), name)
