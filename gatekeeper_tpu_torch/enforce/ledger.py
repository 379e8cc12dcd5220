# Copied from gatekeeper_tpu/enforce/ledger.py for the PyTorch port.
"""VerdictLedger: the current violation set, maintained by deltas.

The reference's audit rebuilds every constraint's violation list from
scratch each ``--audit-interval`` (pkg/audit/manager.go) — the cluster
state between sweeps is a mystery and the work is O(cluster) per tick.
Here the paged sweep applies per-page deltas in place, so the ledger is
*continuously true*: for every eligible kind it holds exactly the
confirmed violating rows, and every change to that set is emitted as an
ordered event (flight-recorded, kept in a ring that :meth:`export` and
:func:`export_all` serve, and handed to subscribers).  In the port the
paged sweep of engine/torch_driver.py is the only writer; the reactor,
the webhook's ``/debug/violations`` and the audit manager's delta
consumer are not ported yet, and ``snapshot_payload``/``adopt`` are
plain data that no snapshot tier calls yet.

Correctness contract (oracle-driven, like every engine change): with
``GATEKEEPER_PAGES=off`` the legacy full path runs, and the ledger's
event stream under pages=on must equal the diff of consecutive full
sweeps for the same churn sequence — ordered, no duplicates, no silent
drops.  Events are canonically ordered per sweep: kinds sorted, then
constraints sorted, then rows in audit rank order, clears before
appears within a row (msgs sorted).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import threading
import weakref
from typing import Callable

from gatekeeper_tpu_torch.obs.flightrecorder import record_event

EVENT_RING = 4096
"""Delta events retained for /debug/violations; older ones age out
(the flight recorder keeps its own ring, subscribers see every event
at emit time — the ring is a debugging window, not the stream)."""


def pages_mode() -> bool:
    """GATEKEEPER_PAGES: the paged O(dirty) sweep + VerdictLedger.
    Default ON, as in the JAX package.  ``off`` selects the legacy
    full-kind path — the oracle every parity gate diffs against."""
    import os
    return os.environ.get("GATEKEEPER_PAGES", "on").lower() in (
        "on", "1", "true")


def constraints_digest(constraints: list[dict]) -> str:
    """Content digest of a kind's constraint set — revalidation key for
    ledger entries adopted from a snapshot (the in-process
    ``con_version`` counter restarts with the process)."""
    blob = json.dumps(sorted(
        json.dumps(c, sort_keys=True, default=str) for c in constraints))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclasses.dataclass
class LedgerEntry:
    """One kind's confirmed violation set + the guards under which it
    was computed.  ``rows`` maps row -> (identity, {constraint name ->
    [Result, ...]}) and is UNCAPPED: the sweep's per-constraint result
    cap is applied at serve time by walking rows in rank order, which
    reproduces the full path's top-k + refill emission exactly."""
    gen: int = -1                 # table generation the entry reflects
    kgen: int = -1                # key_generation at last apply
    remap: int = -1               # remap_generation (row-id validity)
    n_rows: int = -1
    conver: int = -1              # driver constraint-set version
    condigest: str = ""           # content digest (snapshot adoption)
    rows: dict[int, tuple[tuple, dict[str, list]]] = \
        dataclasses.field(default_factory=dict)
    full_builds: int = 0          # cold/fallback rebuilds of this entry
    rv: int = 0                   # watch resourceVersion watermark the
    #                               entry was built/adopted at (stamped
    #                               at snapshot save; guards the pg
    #                               tier against stale watch state)

    def size(self) -> int:
        return sum(len(rs) for _ident, by_c in self.rows.values()
                   for rs in by_c.values())


_registry: "weakref.WeakSet[VerdictLedger]" = weakref.WeakSet()
_registry_lock = threading.Lock()


class VerdictLedger:
    """Per-target ledger of confirmed violations, delta-maintained."""

    def __init__(self, target: str):
        self.target = target
        self.entries: dict[str, LedgerEntry] = {}
        self.events: collections.deque = collections.deque(
            maxlen=EVENT_RING)
        self.seq = 0
        self._subscribers: list[Callable[[dict], None]] = []
        self._lock = threading.Lock()
        with _registry_lock:
            _registry.add(self)

    # -- maintenance -----------------------------------------------------

    def entry(self, kind: str) -> LedgerEntry:
        ent = self.entries.get(kind)
        if ent is None:
            ent = self.entries[kind] = LedgerEntry()
        return ent

    def drop(self, kind: str) -> None:
        self.entries.pop(kind, None)

    def set_row(self, kind: str, row: int, ident: tuple,
                by_constraint: dict[str, list]) -> list[dict]:
        """Replace one row's verdicts, emitting the delta events.
        ``by_constraint`` maps constraint name -> confirmed Results; an
        empty mapping (or a dead row) clears the row.  Events follow
        the canonical within-row order: per constraint (caller iterates
        constraints sorted), clears before appears, msgs sorted."""
        ent = self.entry(kind)
        old = ent.rows.get(row)
        old_by_c = old[1] if old is not None else {}
        old_ident = old[0] if old is not None else None
        # a freed row reused by a DIFFERENT resource between sweeps is
        # a clear+appear pair even when the msgs coincide (the full
        # sweep diff keys on the resource ref, so nothing cancels);
        # only a same-identity replace gets the multiset cancellation
        same = (old is None or not by_constraint
                or old_ident == ident)
        old_ref = self._resource_ref(
            old_ident if old_ident is not None else ident)
        new_ref = self._resource_ref(ident) if by_constraint else old_ref
        out: list[dict] = []
        for cname in sorted(set(old_by_c) | set(by_constraint)):
            old_msgs = collections.Counter(
                r.msg for r in old_by_c.get(cname, ()))
            new_msgs = collections.Counter(
                r.msg for r in by_constraint.get(cname, ()))
            if same:
                if old_msgs == new_msgs:
                    continue
                to_clear = old_msgs - new_msgs
                to_appear = new_msgs - old_msgs
            else:
                to_clear, to_appear = old_msgs, new_msgs
            for msg in sorted(to_clear.elements()):
                out.append(self._emit(kind, cname, old_ref, msg, "clear"))
            for msg in sorted(to_appear.elements()):
                out.append(self._emit(kind, cname, new_ref, msg, "appear"))
        if by_constraint:
            ent.rows[row] = (ident, by_constraint)
        else:
            ent.rows.pop(row, None)
        return out

    def _resource_ref(self, ident: tuple) -> str:
        ns, name = (ident + (None, None))[:2] if ident else (None, None)
        return f"{ns}/{name}" if ns else str(name)

    def _emit(self, kind: str, cname: str, resource: str, msg: str,
              op: str) -> dict:
        with self._lock:
            self.seq += 1
            ev = {"seq": self.seq, "target": self.target, "kind": kind,
                  "constraint": cname, "resource": resource, "msg": msg,
                  "op": op}
            self.events.append(ev)
        record_event("verdict_delta", **ev)
        for cb in list(self._subscribers):
            try:
                cb(ev)
            except Exception:   # noqa: BLE001 — a bad subscriber must
                pass            # not poison the sweep
        return ev

    def subscribe(self, cb: Callable[[dict], None]) -> None:
        """Register a delta consumer (e.g. the audit manager's
        status.byPod[] updater).  Called synchronously at emit time,
        exceptions swallowed."""
        self._subscribers.append(cb)

    # -- introspection ---------------------------------------------------

    def total_violations(self) -> int:
        return sum(e.size() for e in self.entries.values())

    def export(self, events: int = 256) -> dict:
        """JSON-safe view for /debug/violations and probe --pages."""
        kinds = {}
        for kind in sorted(self.entries):
            ent = self.entries[kind]
            kinds[kind] = {
                "rows": len(ent.rows), "violations": ent.size(),
                "gen": ent.gen, "n_rows": ent.n_rows,
                "full_builds": ent.full_builds,
            }
        with self._lock:
            tail = list(self.events)[-events:]
        return {"target": self.target, "seq": self.seq, "kinds": kinds,
                "violations_total": self.total_violations(),
                "events": tail}

    # -- snapshot (the "pg" warm-restart tier) ---------------------------

    def snapshot_payload(self) -> dict:
        """Plain-data payload for resilience/snapshot.save_pagemap —
        per kind the confirmed rows plus the constraint-set digest and
        row-space shape that gate adoption.  Row ids are valid against
        a table restored from the companion store snapshot (restore
        bulk-upserts in saved row order).  Each kind's ``rows`` is the
        live entry's own mapping, not a copy: the caller pickles the
        payload at once, under the driver's write lock (copying a
        cluster's worth of rows first only fed the garbage collector)."""
        return {kind: {"condigest": ent.condigest, "n_rows": ent.n_rows,
                       "rv": ent.rv, "rows": ent.rows}
                for kind, ent in self.entries.items()}

    def adopt(self, kind: str, payload: dict, condigest: str,
              table, conver: int) -> bool:
        """Adopt one kind's snapshot payload as the live entry — only
        when the constraint set (by content) and row space still match
        the restored table.  Guards are stamped from the restored
        table's counters: the snapshot pair (store + pagemap) was taken
        atomically, so the just-restored rows ARE the state the
        verdicts were computed over.  The entry takes the payload's rows
        as they are (``snapshot_payload``'s shape, unpickled): the
        caller hands over a payload it owns, and copying a cluster's
        worth of rows only feeds the garbage collector."""
        if payload.get("condigest") != condigest:
            return False
        if payload.get("n_rows") != table.n_rows:
            return False
        ent = LedgerEntry(
            gen=table.generation, kgen=table.key_generation,
            remap=table.remap_generation, n_rows=table.n_rows,
            conver=conver, condigest=condigest,
            rv=int(payload.get("rv", 0) or 0), rows=payload["rows"])
        self.entries[kind] = ent
        return True


def export_all(events: int = 256) -> dict:
    """All live ledgers, for GET /debug/violations."""
    with _registry_lock:
        ledgers = list(_registry)
    return {"ledgers": [led.export(events)
                        for led in sorted(ledgers,
                                          key=lambda x: x.target)]}
