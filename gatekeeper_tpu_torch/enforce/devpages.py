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

Under ``GATEKEEPER_DEVPAGES_BUDGET_BYTES`` a kind whose certified
resident claim (Stage 8, analysis/memsurface.py) exceeds the budget keeps
only an LRU-hot subset of its mask's pages on the device between sweeps
(:class:`ResidencyPlanner`: K8, kernels/residency.py, splits and rebuilds
the mask; cold pages live in a host mirror and come back through K4).
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Any

import numpy as np
import torch

from gatekeeper_tpu_torch.ir.prep import inv_join_binding_names
from gatekeeper_tpu_torch.kernels import residency as _residency


def residency_budget_bytes() -> int | None:
    """GATEKEEPER_DEVPAGES_BUDGET_BYTES: device memory the resident
    verdict masks may claim per kind.  None (unset or not an integer) =
    unbounded — every page stays device-resident."""
    raw = os.environ.get("GATEKEEPER_DEVPAGES_BUDGET_BYTES")
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


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
    resident: Any = None          # ResidencyPlanner under a budget

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
    """Per-sweep devpages accounting (the ``devpages`` stanza), with the
    JAX package's keys."""
    return {"kinds_device": 0, "kinds_fallback": 0,
            "fallback_reasons": {}, "scatter_rows": 0,
            "h2d_bytes": 0, "h2d_scatter_bytes": 0,
            "delta_events": 0, "delta_overflows": 0,
            "rows_confirmed": 0, "direct_clears": 0,
            "inv_joins_device": 0, "geometry_adopted": 0,
            "mask_builds": 0,
            "resident_spills": 0, "resident_restores": 0,
            "resident_pages_device": 0}


class ResidencyPlanner:
    """Certificate-driven resident-set planner for one kind's verdict
    mask (the JAX package's spill ladder).

    When the Stage-8 certificate's devpages claim at the ACTUAL sweep
    geometry exceeds ``GATEKEEPER_DEVPAGES_BUDGET_BYTES``, the full
    [c_pad, r_pad] resident mask no longer lives on the device between
    sweeps.  Instead the planner keeps an LRU-chosen *hot* subset of
    pages in a compact device buffer of ``n_slots`` page-sized slots
    (the largest power-of-two slot count whose bytes fit the budget —
    the slot ladder), spills cold pages' bits to a host mirror, and
    reconstructs the exact full mask on demand before the next delta
    sweep: hot pages scatter back from the slot buffer (K8's
    ``page_scatter``), spilled pages restore through the executor's row
    scatter (``ProgramExecutor._scatter_rows``, K4), and pages that never
    violate are zeros by the over-approximation contract.  Freed slots
    are reused in place when the working set shifts.  ``expand`` after
    ``store`` is bit-identical to the always-resident mask.

    The bookkeeping (``slot_of``, ``free``, the ``lru`` order,
    ``spilled``, ``spilled_any``, ``host_mask``, ``spills``,
    ``restores``) follows the JAX package's planner step for step; the
    LRU is an ordered dict (``list(lru)`` is the reference's list).

    Inactive (``active`` False) whenever the claim fits the budget:
    ``kp.mask`` then holds the full mask exactly as without a budget.
    """

    def __init__(self, budget: int, c_pad: int, r_pad: int,
                 page_rows: int, cert=None):
        self.budget = int(budget)
        self.c_pad = int(c_pad)
        self.r_pad = int(r_pad)
        self.page_rows = max(int(page_rows), 1)
        self.n_pages = -(-self.r_pad // self.page_rows)
        dims = {"c": self.c_pad, "r": self.r_pad}
        if cert is not None and getattr(cert, "has_r", False):
            claim = cert.devpages_bytes(dims, delta_k=0)
        else:
            claim = 2 * self.c_pad * self.r_pad + 4 * self.r_pad
        self.active = claim > self.budget
        page_bytes = self.c_pad * self.page_rows
        n_slots = 1
        while (n_slots * 2 * page_bytes <= self.budget
               and n_slots * 2 < self.n_pages):
            n_slots *= 2
        self.n_slots = n_slots
        self.slot_of: dict[int, int] = {}     # page -> slot
        self.free: list[int] = list(range(n_slots - 1, -1, -1))
        self.lru: collections.OrderedDict[int, None] = \
            collections.OrderedDict()         # pages, most-recent last
        self.dev_buf = None                   # [c_pad, n_slots*page_rows]
        self.host_mask = np.zeros((self.c_pad, self.r_pad), dtype=bool)
        self.spilled: set[int] = set()        # pages living host-side
        self.spilled_any: set[int] = set()    # spilled pages with a bit
        self.has_mask = False
        self.spills = 0                       # pages spilled to host
        self.restores = 0                     # pages restored to device

    def compatible(self, c_pad: int, r_pad: int, page_rows: int) -> bool:
        return (self.c_pad == c_pad and self.r_pad == r_pad
                and self.page_rows == max(int(page_rows), 1))

    def holds(self, c_pad: int, r_pad: int) -> bool:
        """True when expand() can reproduce a stored full mask at this
        geometry."""
        return (self.active and self.has_mask
                and self.c_pad == c_pad and self.r_pad == r_pad)

    def _page_rows_abs(self, pages) -> np.ndarray:
        """int64 rows of ``pages`` in order, each page's rows ascending;
        the tail page pads by repeating the last real row (a gather reads
        one bit twice, a scatter writes the same bit twice)."""
        lo = np.asarray(pages, dtype=np.int64)[:, None] * self.page_rows
        rows = lo + np.arange(self.page_rows, dtype=np.int64)
        return np.minimum(rows, self.r_pad - 1).reshape(-1)

    def touch(self, pages) -> None:
        """LRU bump: these pages were involved in the current sweep."""
        for p in sorted(pages):
            if 0 <= p < self.n_pages:
                self.lru[p] = None
                self.lru.move_to_end(p)

    def _slot_pages(self, device, cold=()) -> torch.Tensor:
        """int32 [n_slots] slot -> page table (-1 = empty slot), followed
        by the pages ``cold``: one host-to-device copy."""
        table = np.full((self.n_slots + len(cold),), -1, dtype=np.int32)
        for p, s in self.slot_of.items():
            table[s] = p
        table[self.n_slots:] = cold
        return torch.from_numpy(table).to(device)

    def store(self, new_mask: torch.Tensor) -> None:
        """Adopt a freshly computed full mask: keep the ``n_slots``
        most-recently-touched pages in the device slot buffer, spill
        the rest to the host mirror, release the full-size device
        array (K8's ``page_gather``, one copy of the cold pages to the
        host)."""
        hot = self._hot_pages()
        # free slots of pages leaving the hot set (reused below)
        for p in [p for p in self.slot_of if p not in hot]:
            self.free.append(self.slot_of.pop(p))
        for p in hot:
            if p not in self.slot_of:
                self.slot_of[p] = self.free.pop()
        cold = [p for p in range(self.n_pages) if p not in hot]
        tables = self._slot_pages(new_mask.device, cold)
        self.dev_buf, staging = _residency.page_gather(
            new_mask, tables[: self.n_slots], tables[self.n_slots:],
            self.page_rows)
        newly_spilled = [p for p in cold if p not in self.spilled]
        self.spills += len(newly_spilled)
        if cold:
            bits = staging.cpu().numpy()
            self.host_mask[:, self._page_rows_abs(cold)] = bits
            seg_any = bits.reshape(self.c_pad, len(cold),
                                   self.page_rows).any(axis=(0, 2))
            for p, any_bit in zip(cold, seg_any.tolist()):
                if any_bit:
                    self.spilled_any.add(p)
                else:
                    self.spilled_any.discard(p)
        self.spilled = set(cold)
        self.has_mask = True

    def expand(self, ex) -> torch.Tensor:
        """Reconstruct the exact full [c_pad, r_pad] mask: hot pages
        scatter back from the slot buffer (K8's ``page_scatter``),
        spilled non-zero pages restore host->device through the
        executor's row scatter, all-zero pages stay zeros."""
        if self.slot_of:
            full = _residency.page_scatter(
                self.dev_buf, self._slot_pages(self.dev_buf.device),
                self.r_pad, self.page_rows)
        else:
            full = torch.zeros((self.c_pad, self.r_pad), dtype=torch.bool,
                               device=ex.device)
        restore = sorted(self.spilled & self.spilled_any)
        if restore:
            full = ex._scatter_rows("__resident__", full, self.host_mask,
                                    self._page_rows_abs(restore), axis=1)
            self.restores += len(restore)
        return full

    def _hot_pages(self) -> set[int]:
        """The ``n_slots`` most-recently-touched pages (LRU order,
        seeded with the lowest page indices before any touch)."""
        hot: list[int] = []
        for p in reversed(self.lru):
            if len(hot) >= self.n_slots:
                break
            hot.append(p)
        recent = set(hot)
        for p in range(self.n_pages):
            if len(hot) >= self.n_slots:
                break
            if p not in recent:
                hot.append(p)
        # built from the list in the reference's order, so iterating it
        # assigns the free slots to pages in the reference's order
        return set(hot)
