# Copied from gatekeeper_tpu/enforce/devpages.py for the PyTorch port.
"""Device-resident paged store (GATEKEEPER_DEVPAGES).

The paged sweep (engine/torch_driver.py ``_paged_kind``) keeps the
VerdictLedger current by re-evaluating dirty pages through the scalar
oracle on the host.  This module is its device half: each eligible
kind's columns stay resident on the device (churn arrives as row-sized
update records, the executor's row scatter K4), and one evaluation
computes the violation mask AND its delta against the previous resident
mask (engine/executor.py ``eval_mask_delta``: K1 for the mask, then K6,
kernels/devdelta.py, for the page-table gather, the XOR and the ordered
compaction) — a compact (constraint, row, ±) stream the ledger consumes
directly.

Soundness rests on the over-approximation contract: a mask bit 0 means
*definitely no violation* (so 1→0 transitions are direct ledger clears
with no host eval), a mask bit 1 is a candidate the host scalar oracle
confirms (exact messages).  The device mask deliberately excludes the
``__match__`` gate: every match input is row-local (own
labels/name/ns/kind; namespaceSelector churn forces a rebuild
upstream), so a match flip always dirties its own row and the dirty-row
confirm covers it — and the [C, R] match matrix never rides H2D.

``GATEKEEPER_DEVPAGES=off`` (the default) keeps the host-paged oracle.

A kind whose only cross-row dependency is a lowered inventory join
(K8sUniqueIngressHost) is paged here too: the join's input records
(:func:`build_inv_join_inputs`) stay resident beside the columns, and
``eval_mask_delta`` recomputes the join over the whole table on every
delta sweep (K7, kernels/invjoin.py), so a verdict that flips on a row
that did not churn still arrives as a delta.

Ported in part.  Not ported yet: the Stage-8 residency planner
(``ResidencyPlanner``, kernel B8), which needs the Stage-8 memory
certificate — setting ``GATEKEEPER_DEVPAGES_BUDGET_BYTES`` raises
instead of being ignored.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np

from gatekeeper_tpu_torch.errors import ClientError
from gatekeeper_tpu_torch.ir.prep import inv_join_binding_names

BUDGET_NOT_PORTED = (
    "GATEKEEPER_DEVPAGES_BUDGET_BYTES: the devpages residency budget (B8) "
    "is not yet ported (it needs the Stage-8 memory certificate); unset it "
    "to keep every kind's resident mask on the device")


def residency_budget_bytes() -> int | None:
    """GATEKEEPER_DEVPAGES_BUDGET_BYTES: device memory the resident
    verdict masks may claim per kind.  None (unset) = unbounded — every
    page stays device-resident.  A budget needs the residency planner,
    which is not ported: setting one raises ClientError."""
    raw = os.environ.get("GATEKEEPER_DEVPAGES_BUDGET_BYTES")
    if not raw:
        return None
    raise ClientError(BUDGET_NOT_PORTED)


DELTA_K_MIN = 256
"""Smallest width of the compact delta stream."""

DELTA_K_LADDER = 4
"""Overflow growth factor: a sweep whose changed-bit count exceeds the
width k re-runs at bucket(count)*LADDER (the JAX package recompiles
once per bucket; K6 takes k at run time)."""


def devpages_mode() -> bool:
    """GATEKEEPER_DEVPAGES: device-resident page table + device verdict
    deltas.  Default OFF — ``=off`` is the host-paged oracle every
    parity gate diffs against."""
    return os.environ.get("GATEKEEPER_DEVPAGES", "off").lower() in (
        "on", "1", "true")


def delta_bucket(n: int) -> int:
    """Power-of-two width for the compact delta stream."""
    k = DELTA_K_MIN
    while k < n:
        k <<= 1
    return k


@dataclasses.dataclass
class KindPages:
    """One kind's device-resident paged state.

    ``mask`` is the resident [c_pad, r_pad] violation mask the next
    sweep deltas against; ``page_table`` the on-device row->slot
    indirection ([slots] int32, identity while remap_generation is
    stable — rebuilt, not mutated, on remap); ``free`` mirrors the
    table's free slot list at last build (reused slots keep their
    device storage; the delta stream reports the clear+appear pair when
    a different identity lands in a freed slot).  Device tensors here
    are rebound on update, never written in place."""

    kind: str
    mask: Any = None              # device [c_pad, r_pad] bool
    page_table: Any = None        # device [slots] int32
    c_pad: int = 0
    slots: int = 0                # r_pad: fixed page-array capacity
    page_rows: int = 0
    n_pages: int = 0
    free: tuple = ()              # free-slot mirror at last build
    gen: int = -1                 # table generation the mask reflects
    remap: int = -1
    conver: int = -1
    k: int = DELTA_K_MIN          # delta-stream width
    ij_dev: dict = dataclasses.field(default_factory=dict)
    #   inv-join input records: name -> device array (r:ij.<join>.*)
    ij_host: dict = dataclasses.field(default_factory=dict)
    #   the numpy twins the scatter staged from (value-compared)
    geometry_adopted: bool = False

    def geometry(self) -> dict:
        """Plain-data device-pagemap geometry for a snapshot tier: slot
        capacity, page shape, free list.  The mask itself is not
        persisted (the first delta sweep re-derives it)."""
        return {"slots": int(self.slots), "c_pad": int(self.c_pad),
                "page_rows": int(self.page_rows),
                "n_pages": int(self.n_pages),
                "free": [int(f) for f in self.free]}

    def adopt_geometry(self, geom: dict) -> bool:
        """Seed the paged layout from a snapshot geometry payload; the
        first device sweep then builds its mask into the adopted shape
        instead of deriving geometry cold."""
        try:
            self.slots = int(geom["slots"])
            self.c_pad = int(geom["c_pad"])
            self.page_rows = int(geom["page_rows"])
            self.n_pages = int(geom["n_pages"])
            self.free = tuple(int(f) for f in geom.get("free", ()))
            self.geometry_adopted = True
            return True
        except (KeyError, TypeError, ValueError):
            return False


def build_inv_join_inputs(req, table, r_pad: int) -> dict[str, np.ndarray]:
    """Host twins of one join's device input records, padded to the
    slot capacity.  Column extraction is table-cached (O(dirty) after
    the first build); padding fills MISSING / False so padded slots can
    never join."""
    from gatekeeper_tpu_torch.store.columns import ColSpec
    from gatekeeper_tpu_torch.store.interner import MISSING
    n = table.n_rows
    ident = table.identity()
    kid = table.interner.lookup(req.kind)

    def _pad(a: np.ndarray, fill) -> np.ndarray:
        out = np.full((r_pad,), fill, dtype=a.dtype)
        out[:n] = a[:n]
        return out

    src = table.column(ColSpec(req.src_path, "val")).ids
    inv = table.column(ColSpec(req.inv_path, "val")).ids
    sel = ident.alive & (ident.kind_ids == kid)
    if req.namespaced_only:
        sel = sel & (ident.ns_ids != MISSING)
    if kid == MISSING:
        sel = np.zeros_like(sel)
    names = ident.name_ids
    s, i, f, m = inv_join_binding_names(req.name)
    return {s: _pad(src.astype(np.int32), MISSING),
            i: _pad(inv.astype(np.int32), MISSING),
            f: _pad(sel.astype(bool), False),
            m: _pad(names.astype(np.int32), MISSING)}


def fresh_stats() -> dict:
    """Per-sweep devpages accounting (the ``devpages`` stanza).  The
    keys are the JAX package's; the ``resident_*`` counters stay 0
    until B8 is ported."""
    return {"kinds_device": 0, "kinds_fallback": 0,
            "fallback_reasons": {}, "scatter_rows": 0,
            "h2d_bytes": 0, "h2d_scatter_bytes": 0,
            "delta_events": 0, "delta_overflows": 0,
            "rows_confirmed": 0, "direct_clears": 0,
            "inv_joins_device": 0, "geometry_adopted": 0,
            "mask_builds": 0,
            "resident_spills": 0, "resident_restores": 0,
            "resident_pages_device": 0}
