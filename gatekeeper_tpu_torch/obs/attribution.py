# Copied from gatekeeper_tpu/obs/attribution.py for the PyTorch port.
"""Per-template device-time attribution via the static cost model.

A full sweep measures ``device_s`` as one number (and, per kind, the
individual dispatch block times).  This module apportions the sweep's
total device time across member templates using their PR-5
:class:`CostVector` units as weights — the attributed shares sum to
the measured total by construction — and reports predicted-vs-measured
drift per template against the running calibration, feeding each
template's measured seconds back into the cost model's audit window
(``costmodel.record_sample(..., window="audit")``) so its
seconds-per-unit scale tracks reality.  Unlike the reference, the
samples stay out of the review window that prices admission batches
(``costmodel.effective_scale``): an audit's device seconds are not a
review batch's wall.

Exposed surfaces: ``last_sweep_phases["attribution"]`` on full sweeps
(``TorchDriver.query_audit``) and the labelled gauges
``template_device_seconds{template=...}`` /
``template_cost_drift{template=...}`` in the Prometheus exposition.  In
the port a kind's measured seconds run from its first launch until its
end event completed, with no other kind's work on the card
(engine/torch_driver.py).
"""

from __future__ import annotations

from typing import Optional

from gatekeeper_tpu_torch.analysis import costmodel
from gatekeeper_tpu_torch.utils.log import logger

log = logger("obs.attribution")


def attribute_sweep(entries: list, device_s: float, n_rows: int,
                    measured: Optional[dict] = None,
                    metrics=None) -> dict:
    """Apportion one sweep's measured device seconds across templates.

    ``entries`` is ``[(kind, lowered, n_constraints), ...]`` for every
    device-dispatched kind in the sweep; ``measured`` optionally maps
    kind -> that kind's individually measured device block seconds
    (full sweeps time each dispatch).  Returns the attribution stanza
    stored in ``last_sweep_phases``.  Never raises — a template whose
    estimate fails gets unit weight.
    """
    units: dict[str, float] = {}
    for kind, lowered, n_cons in entries:
        try:
            units[kind] = max(
                1.0, costmodel.estimate(lowered, n_rows, n_cons).units())
        except Exception as exc:
            log.warning("cost estimate failed", template=kind, error=exc)
            units[kind] = 1.0
    total_units = sum(units.values())
    scale = costmodel.current_scale("audit")

    rows = []
    for kind in sorted(units):
        u = units[kind]
        share = u / total_units if total_units else 0.0
        attributed = share * device_s
        meas = (measured or {}).get(kind)
        predicted = u * scale if scale > 0 else None
        drift = None
        ref = meas if meas else attributed
        if predicted is not None and ref > 0:
            drift = (predicted - ref) / ref
        rows.append({
            "template": kind,
            "units": round(u, 1),
            "share": round(share, 6),
            "device_seconds": round(attributed, 9),
            "measured_seconds": round(meas, 9) if meas is not None else None,
            "predicted_seconds": (round(predicted, 9)
                                  if predicted is not None else None),
            "drift": round(drift, 4) if drift is not None else None,
        })
        # feed the calibration loop with the best per-kind truth we
        # have: the individually timed dispatch block when available,
        # else the apportioned share
        costmodel.record_sample(u, meas if meas else attributed, "audit")
        if metrics is not None:
            try:
                metrics.gauge("template_device_seconds",
                              template=kind).set(round(attributed, 9))
                if drift is not None:
                    metrics.gauge("template_cost_drift",
                                  template=kind).set(round(drift, 4))
            except Exception:
                pass

    return {
        "device_s": round(device_s, 9),
        "scale_seconds_per_unit": scale,
        "templates": rows,
    }
