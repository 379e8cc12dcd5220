# Copied from gatekeeper_tpu/store/table.py for the PyTorch port.
"""The resource table: host objects + columnar mirror.

This is the TPU-first replacement for iterating
``data.external[target].{cluster,namespace}[...]`` one document at a time
(the reference's audit hot loop, regolib/src.go:38-52 +
target.go:69-81): resources occupy stable rows; identity columns
(group/version/kind/name/namespace ids) and template-demanded field
columns are materialized as numpy arrays and shipped to device.  Rows are
tombstoned on delete and compacted when garbage accumulates.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from gatekeeper_tpu_torch.store.columns import (ColSpec, build_column,
                                          delta_column)
from gatekeeper_tpu_torch.store.interner import Interner, MISSING

DELTA_MAX_FRAC = 0.125
"""Above this dirty fraction a full rebuild beats the delta path."""

PATH_LOG_CAP = 4096
"""Dirty-path log entries kept; older windows degrade to "unknown"."""

DEFAULT_PAGE_ROWS = 32
"""Rows per fixed-size page (GATEKEEPER_PAGE_ROWS overrides).  Pages
are the dirty-tracking granule for the paged sweep: a watch event
dirties exactly one page, so at 0.1% churn the paged sweep touches
~page_rows/1000 of the table."""


def page_rows_env() -> int:
    """Page geometry from GATEKEEPER_PAGE_ROWS (min 1)."""
    import os
    try:
        return max(1, int(os.environ.get("GATEKEEPER_PAGE_ROWS",
                                         DEFAULT_PAGE_ROWS)))
    except ValueError:
        return DEFAULT_PAGE_ROWS

PATH_DIFF_DEPTH = 6
"""Replace-diff recursion depth; deeper changes report the subtree."""


def _diff_paths(old, new, prefix: tuple = (),
                depth: int = PATH_DIFF_DEPTH) -> set:
    """Column paths that differ between two versions of one object.
    Dicts recurse (key union); lists and scalars compare wholesale —
    a changed list reports the list's own path, which prefix semantics
    (analysis/footprint.paths_intersect) match against ``base.*.rel``
    element reads."""
    if old is new:
        return set()
    if isinstance(old, dict) and isinstance(new, dict) and depth > 0:
        out: set = set()
        for k in old.keys() | new.keys():
            if not isinstance(k, str):
                continue
            ov, nv = old.get(k), new.get(k)
            if ov is nv:
                continue
            if isinstance(ov, dict) and isinstance(nv, dict):
                out |= _diff_paths(ov, nv, prefix + (k,), depth - 1)
            elif ov != nv:
                out.add(prefix + (k,))
        return out
    try:
        same = old == new
    except Exception:   # noqa: BLE001 — exotic values: assume changed
        same = False
    return set() if same else {prefix or ("",)}


def delta_worthwhile(n_dirty: int, n: int) -> bool:
    return n_dirty <= max(64, int(n * DELTA_MAX_FRAC))


@dataclasses.dataclass(frozen=True)
class ResourceMeta:
    api_version: str          # "v1" or "group/version"
    kind: str
    name: str
    namespace: str | None     # None => cluster-scoped

    @property
    def group(self) -> str:
        return self.api_version.split("/")[0] if "/" in self.api_version else ""

    @property
    def version(self) -> str:
        return self.api_version.split("/")[1] if "/" in self.api_version else self.api_version


@dataclasses.dataclass
class IdentityColumns:
    group_ids: np.ndarray      # int32 [n]
    version_ids: np.ndarray
    kind_ids: np.ndarray
    name_ids: np.ndarray
    ns_ids: np.ndarray         # MISSING for cluster-scoped
    alive: np.ndarray          # bool [n]


class ResourceTable:
    def __init__(self, interner: Interner | None = None):
        self.interner = interner or Interner()
        self._objs: list[Any] = []
        self._metas: list[ResourceMeta | None] = []
        # generation at last modify, per row (numpy so dirty-row scans
        # vectorize); _ver has capacity >= n_rows, amortized doubling
        self._ver = np.zeros((16,), dtype=np.int64)
        self._rows: dict[str, int] = {}      # path key -> row
        self._free: list[int] = []
        self.generation = 0
        # bumped when row ids are remapped (wipe/compact): per-row delta
        # updates keyed on an older remap are invalid, not just stale
        self.remap_generation = 0
        # bumped only when the key set changes (insert of a new key,
        # remove, wipe, compact) — pure updates keep sorted-key order
        # caches (audit row order/rank) valid
        self.key_generation = 0
        self._ns_rows: set[int] = set()      # rows holding v1/Namespace
        self.ns_generation = 0               # last change to any ns row
        self._ns_touched = False
        self._col_cache: dict[ColSpec, tuple[int, int, Any]] = {}
        self._elem_cache: dict[tuple, tuple] = {}   # base -> (gen, counts, cols)
        self._identity_cache: tuple[int, int, IdentityColumns] | None = None
        self._ns_items_cache: tuple[int, dict] | None = None
        # dirty COLUMN paths + dirty PAGES + touched resource KINDS per
        # write generation.  Replace-upserts log the changed column
        # paths; inserts/removes log an empty path set (they bump
        # key_generation, which every path consumer guards on) but DO
        # log their page — the paged sweep needs delete/insert locality
        # too.  Entries are (generation, frozenset(paths) | None,
        # frozenset(pages), frozenset(kinds)); a ``paths=None`` entry
        # is a generation-stamped "widen" marker left behind when the
        # cap trips.  The marker carries the UNION of the dropped
        # half's pages and resource kinds, so consumers degrade to
        # "all paths of those pages" scoped to templates that can match
        # one of those kinds — not to a whole-table re-sweep.
        self._path_log: list[
            tuple[int, frozenset | None, frozenset, frozenset]] = []
        self._path_floor = 0          # windows starting below: unknown
        self._pending_paths: set[tuple] = set()
        self._pending_pages: set[int] = set()
        self._pending_kinds: set[str] = set()
        self.page_rows = page_rows_env()
        self.dirtylog_overflows = 0   # widen markers recorded (ever)

    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._rows)

    @property
    def n_rows(self) -> int:
        return len(self._objs)

    @property
    def n_pages(self) -> int:
        """Fixed-size page count covering the row space; the tail page
        is padded (its trailing slots map past n_rows)."""
        return -(-len(self._objs) // self.page_rows)

    def page_of(self, row: int) -> int:
        return row // self.page_rows

    def free_slots(self) -> tuple[int, ...]:
        """Currently-free row slots (tombstoned, awaiting reuse) — the
        device pagemap mirrors this so a warm restart adopts the paged
        layout without a rebuild."""
        return tuple(self._free)

    def _ensure_ver(self, n: int) -> None:
        if len(self._ver) < n:
            cap = max(len(self._ver) * 2, n)
            grown = np.zeros((cap,), dtype=np.int64)
            grown[: len(self._ver)] = self._ver
            self._ver = grown

    def _place(self, key: str, obj: dict, meta: ResourceMeta) -> int:
        row = self._rows.get(key)
        if row is None:
            if self._free:
                row = self._free.pop()
                self._objs[row] = obj
                self._metas[row] = meta
            else:
                row = len(self._objs)
                self._objs.append(obj)
                self._metas.append(meta)
                self._ensure_ver(row + 1)
            self._rows[key] = row
            self.key_generation += 1
        else:
            old_obj, old_meta = self._objs[row], self._metas[row]
            if old_meta != meta:
                self._pending_paths.add(("$meta",))
            if old_obj is obj:
                # the caller mutated the STORED object in place and
                # re-upserted the same reference: the pre-image is
                # gone, so no diff is computable — record the wildcard
                # root, which intersects every read-set (selective
                # consumers re-evaluate everything, never go stale)
                self._pending_paths.add(("*",))
            else:
                self._pending_paths |= _diff_paths(old_obj, obj)
            self._objs[row] = obj
            self._metas[row] = meta
        self._pending_pages.add(row // self.page_rows)
        self._pending_kinds.add(meta.kind)
        if meta.kind == "Namespace" and meta.api_version == "v1":
            self._ns_rows.add(row)
            self._ns_touched = True
        elif row in self._ns_rows:
            self._ns_rows.discard(row)
            self._ns_touched = True
        return row

    def _flush_paths(self) -> None:
        if self._pending_paths or self._pending_pages:
            self._path_log.append((self.generation,
                                   frozenset(self._pending_paths),
                                   frozenset(self._pending_pages),
                                   frozenset(self._pending_kinds)))
            self._pending_paths = set()
            self._pending_pages = set()
            self._pending_kinds = set()
            if len(self._path_log) > PATH_LOG_CAP:
                # Cap trip: drop the older half, but leave a widen
                # marker (paths=None) stamped with the last dropped
                # generation and carrying the union of the dropped
                # half's pages and resource kinds.  Windows spanning
                # the marker degrade to "all paths of those pages" —
                # and only for templates matching one of those kinds
                # (store_dirtylog_overflow_total counts the trips) —
                # instead of a whole-table unknown.
                drop = len(self._path_log) // 2
                widen_gen = self._path_log[drop - 1][0]
                w_pages: set[int] = set()
                w_kinds: set[str] = set()
                for _g, _paths, pgs, kinds in self._path_log[:drop]:
                    w_pages |= pgs
                    w_kinds |= kinds
                del self._path_log[:drop]
                self._path_log.insert(0, (widen_gen, None,
                                          frozenset(w_pages),
                                          frozenset(w_kinds)))
                self.dirtylog_overflows += 1

    def upsert(self, key: str, obj: dict, meta: ResourceMeta) -> int:
        row = self._place(key, obj, meta)
        self.generation += 1
        self._ver[row] = self.generation
        self._flush_paths()
        if self._ns_touched:
            self.ns_generation = self.generation
            self._ns_touched = False
        return row

    def bulk_upsert(self, entries: list[tuple[str, dict, ResourceMeta]]) -> None:
        dirty: list[int] = []
        for key, obj, meta in entries:
            dirty.append(self._place(key, obj, meta))
        self.generation += 1
        self._ver[dirty] = self.generation
        self._flush_paths()
        if self._ns_touched:
            self.ns_generation = self.generation
            self._ns_touched = False

    def remove(self, key: str) -> bool:
        row = self._rows.pop(key, None)
        if row is None:
            return False
        old_meta = self._metas[row]
        if old_meta is not None:
            self._pending_kinds.add(old_meta.kind)
        self._objs[row] = None
        self._metas[row] = None
        self._free.append(row)
        self._pending_pages.add(row // self.page_rows)
        if row in self._ns_rows:
            self._ns_rows.discard(row)
            self.ns_generation = self.generation + 1
        self.generation += 1
        self.key_generation += 1
        self._ver[row] = self.generation
        self._flush_paths()
        if len(self._free) > 64 and len(self._free) > len(self._rows):
            self.compact()
        return True

    def wipe(self) -> None:
        self._objs.clear()
        self._metas.clear()
        self._ver = np.zeros((16,), dtype=np.int64)
        self._rows.clear()
        self._free.clear()
        self._ns_rows.clear()
        self._col_cache.clear()
        self._elem_cache.clear()
        self._identity_cache = None
        self._ns_items_cache = None
        self._path_log.clear()
        self._pending_paths.clear()
        self._pending_pages.clear()
        self._pending_kinds.clear()
        self.generation += 1
        self.remap_generation += 1
        self.key_generation += 1
        self._path_floor = self.generation
        self.ns_generation = self.generation

    def compact(self) -> None:
        """Drop tombstoned rows; row ids are reassigned."""
        new_objs, new_metas, new_rows = [], [], {}
        for key, row in self._rows.items():
            new_rows[key] = len(new_objs)
            new_objs.append(self._objs[row])
            new_metas.append(self._metas[row])
        self._objs, self._metas, self._rows = new_objs, new_metas, new_rows
        self._free = []
        self._path_log.clear()
        self._pending_paths.clear()
        self._pending_pages.clear()
        self._pending_kinds.clear()
        self.generation += 1
        self.remap_generation += 1
        self.key_generation += 1
        self._path_floor = self.generation
        self.ns_generation = self.generation
        self._ns_rows = {row for row, m in enumerate(new_metas)
                         if m is not None and m.kind == "Namespace"
                         and m.api_version == "v1"}
        # row ids were reassigned: stamp everything with the new
        # generation so (row, version) pairs can't alias across compaction
        self._ver = np.full((max(len(new_objs), 16),), self.generation,
                            dtype=np.int64)

    def snapshot_state(self) -> dict:
        """Plain-data snapshot for warm-restart persistence
        (resilience/snapshot.py): live rows in row order plus the
        interned string table, so a restored table reproduces both the
        row layout and the string ids (device column caches rebuilt
        from it are bit-identical).  No numpy arrays, no locks — the
        payload pickles with the stdlib."""
        entries = []
        for key, row in sorted(self._rows.items(), key=lambda kv: kv[1]):
            m = self._metas[row]
            entries.append((key, self._objs[row],
                            None if m is None else
                            (m.api_version, m.kind, m.name, m.namespace)))
        return {
            "entries": entries,
            "strings": list(self.interner._strings),
            "max_str_len": self.interner.max_str_len,
        }

    def restore_state(self, state: dict) -> None:
        """Load a ``snapshot_state()`` payload into this (fresh) table.
        The interner is seeded first, in saved order, so string ids —
        and therefore every encoded column — match the snapshotting
        process exactly."""
        for s in state.get("strings", ()):
            self.interner.intern(s)
        entries = [(key, obj,
                    ResourceMeta(*meta) if meta is not None else None)
                   for key, obj, meta in state.get("entries", ())]
        if entries:
            self.bulk_upsert(entries)

    @classmethod
    def from_state(cls, state: dict) -> "ResourceTable":
        """A fresh secondary table built from a ``snapshot_state()``
        payload — the load-snapshot-as-secondary-store path
        (whatif/replay.py).  The live table is untouched; the copy gets
        its own interner seeded in saved order, so its encoded columns
        are bit-identical to the snapshotting process."""
        t = cls()
        t.restore_state(state)
        return t

    def dirty_rows_since(self, gen: int) -> np.ndarray:
        """Row indices modified (upserted/tombstoned) after generation
        `gen` — the delta set for every incremental consumer.  Only valid
        while remap_generation is unchanged (row ids stable)."""
        n = len(self._objs)
        return np.nonzero(self._ver[:n] > gen)[0]

    def dirty_paths_since(self, gen: int) -> frozenset | None:
        """Union of column paths changed by replace-upserts after
        generation ``gen``, or None when the window predates the log or
        spans a cap-overflow widen marker (caller must assume
        everything changed — for a widen, exactly the overflowed
        interval).  Inserts and removes log empty path sets — they bump
        ``key_generation``, which selective consumers must guard on
        separately."""
        if gen < self._path_floor:
            return None
        out: set = set()
        for g, paths, _pages, _kinds in reversed(self._path_log):
            if g <= gen:
                break
            if paths is None:       # widen marker inside the window
                return None
            out |= paths
        return frozenset(out)

    def dirty_page_entries_since(self, gen: int) \
            -> list[tuple[int, frozenset | None,
                          frozenset, frozenset]] | None:
        """Log entries newer than generation ``gen`` in write order —
        each ``(generation, paths, pages, kinds)`` — or None when the
        window predates the log.  Watch events are one-row-per-entry,
        so a consumer can intersect each entry's paths with a kind's
        read-set and collect only the pages whose changes that kind can
        observe.  A cap-overflow widen marker inside the window comes
        back as a ``paths=None`` entry whose pages/kinds are the
        dropped half's unions: its paths are unattributable (treat as
        "every path"), but a consumer whose matched resource kinds are
        disjoint from the entry's kinds can skip it outright."""
        if gen < self._path_floor:
            return None
        newer: list = []
        for g, paths, pages, kinds in reversed(self._path_log):
            if g <= gen:
                break
            newer.append((g, paths, pages, kinds))
        newer.reverse()
        return newer

    def dirty_pages_since(self, gen: int) -> frozenset | None:
        """Union of pages touched after generation ``gen`` (upserts,
        inserts AND removes), or None when the window predates the log
        — see ``dirty_page_entries_since``.  Widen markers contribute
        their dropped-half page unions (exact, just unattributed)."""
        entries = self.dirty_page_entries_since(gen)
        if entries is None:
            return None
        out: set = set()
        for _g, _paths, pages, _kinds in entries:
            out |= pages
        return frozenset(out)

    def rv_watermark(self) -> dict[str, int]:
        """Max ``metadata.resourceVersion`` per kind over resident rows
        — the watch watermark the pg snapshot tier is built at.  A warm
        restart adopting the ledger compares the reactor's first
        observed RV against this: an event that does not extend it
        means the adopted verdicts describe state the new stream never
        saw, and the kind takes one forced resync."""
        out: dict[str, int] = {}
        for _key, row in self._rows.items():
            meta = self._metas[row]
            obj = self._objs[row]
            if meta is None or not isinstance(obj, dict):
                continue
            rv = (obj.get("metadata") or {}).get("resourceVersion")
            if isinstance(rv, str) and rv.isdigit():
                rv = int(rv)
            if not isinstance(rv, int):
                continue
            if rv > out.get(meta.kind, 0):
                out[meta.kind] = rv
        return out

    # ------------------------------------------------------------------

    def object_at(self, row: int) -> Any:
        return self._objs[row]

    def meta_at(self, row: int) -> ResourceMeta | None:
        return self._metas[row]

    def version_at(self, row: int) -> int:
        """Generation at the row's last modify — cache-invalidation key
        for per-row derived results (e.g. formatted violations)."""
        return int(self._ver[row])

    def rows_items(self):
        """(key, row) pairs for live rows."""
        return self._rows.items()

    def lookup(self, key: str) -> int | None:
        """Row index for a cache path key, or None."""
        return self._rows.get(key)

    # ------------------------------------------------------------------
    # columns

    def elem_arrays(self, base: tuple, rels: list):
        """Element-axis CSR columns for `rels` under `base`, served
        from a per-(base, generation) superset cache.  Every template
        kind sharing an axis (spec.containers for most of the library)
        otherwise pays its own full-table extraction walk per audit —
        the single biggest host cost of a cold/restart prep at 1M rows.
        `prefetch_elem_arrays` extracts the union once; per-kind calls
        then slice the cached superset."""
        hit = self._elem_cache.get(base)
        if hit is not None and hit[0] == self.generation:
            cols = hit[2]
            if all(rm in cols for rm in rels):
                return hit[1], {rm: cols[rm] for rm in rels}
        return self.prefetch_elem_arrays(base, rels)

    def prefetch_elem_arrays(self, base: tuple, rels) -> tuple:
        """Extract (and cache) `rels` — plus anything already cached
        for this base — in ONE pass over the table."""
        from gatekeeper_tpu_torch.ir.prep import build_elem_arrays
        want = set(rels)
        hit = self._elem_cache.get(base)
        if hit is not None:
            if hit[0] == self.generation and want <= set(hit[2]):
                return hit[1], {rm: hit[2][rm] for rm in rels}
            # carry coverage even across generations: after churn, the
            # FIRST rebuild call must re-walk the whole union once so
            # sibling kinds hit the refreshed superset instead of each
            # paying their own full-table walk
            want |= set(hit[2])
        counts, cols = build_elem_arrays(self._objs, base, sorted(want),
                                         self.interner)
        self._elem_cache[base] = (self.generation, counts, cols)
        return counts, {rm: cols[rm] for rm in rels}

    def column(self, spec: ColSpec):
        hit = self._col_cache.get(spec)
        if hit is not None and hit[0] == self.generation:
            return hit[2]
        if hit is not None and hit[1] == self.remap_generation:
            dirty = self.dirty_rows_since(hit[0])
            if delta_worthwhile(len(dirty), len(self._objs)):
                col = delta_column(spec, hit[2], self._objs, dirty,
                                   self.interner)
                self._col_cache[spec] = (self.generation,
                                         self.remap_generation, col)
                return col
        col = build_column(spec, self._objs, self.interner)
        self._col_cache[spec] = (self.generation, self.remap_generation, col)
        return col

    def identity(self) -> IdentityColumns:
        hit = self._identity_cache
        if hit is not None and hit[0] == self.generation:
            return hit[2]
        n = len(self._objs)
        it = self.interner
        dirty = None
        if hit is not None and hit[1] == self.remap_generation:
            d = self.dirty_rows_since(hit[0])
            if delta_worthwhile(len(d), n):
                dirty = d
        if dirty is not None:
            old = hit[2]
            from gatekeeper_tpu_torch.store.columns import _grow
            gi = _grow(old.group_ids, n, MISSING)
            vi = _grow(old.version_ids, n, MISSING)
            ki = _grow(old.kind_ids, n, MISSING)
            ni = _grow(old.name_ids, n, MISSING)
            si = _grow(old.ns_ids, n, MISSING)
            alive = _grow(old.alive, n, False)
            rows = dirty.tolist()
        else:
            gi = np.full((n,), MISSING, dtype=np.int32)
            vi = np.full((n,), MISSING, dtype=np.int32)
            ki = np.full((n,), MISSING, dtype=np.int32)
            ni = np.full((n,), MISSING, dtype=np.int32)
            si = np.full((n,), MISSING, dtype=np.int32)
            alive = np.zeros((n,), dtype=bool)
            rows = range(n)
        for i in rows:
            m = self._metas[i]
            if m is None:
                gi[i] = vi[i] = ki[i] = ni[i] = si[i] = MISSING
                alive[i] = False
                continue
            alive[i] = True
            gi[i] = it.intern(m.group)
            vi[i] = it.intern(m.version)
            ki[i] = it.intern(m.kind)
            ni[i] = it.intern(m.name)
            si[i] = it.intern(m.namespace) if m.namespace is not None \
                else MISSING
        ident = IdentityColumns(
            group_ids=gi, version_ids=vi, kind_ids=ki, name_ids=ni, ns_ids=si,
            alive=alive)
        self._identity_cache = (self.generation, self.remap_generation, ident)
        return ident

    def labels_csr(self):
        """The full metadata.labels CSR (keys, values, offsets) —
        delta-maintained like any column, but deliberately NOT part of
        identity(): subset consumers (the churn-delta match path) build
        their own slice from the dirty objects instead of forcing a
        full-CSR splice every generation."""
        col = self.column(ColSpec(("metadata", "labels"), "items"))
        vals2 = col.values2 if col.values2 is not None else col.values
        return col.values, vals2, col.offsets

    def namespace_label_items(self) -> dict[int, list[tuple[int, int]]]:
        """ns name id -> [(label key id, label value id)] for every cached
        v1/Namespace resource — feeds namespaceSelector matching
        (target.go:236-255) and the autoreject uncached-namespace check.
        O(#namespaces) per generation (the Namespace row set is tracked
        at ingest), cached across unchanged generations."""
        if self._ns_items_cache is not None and \
                self._ns_items_cache[0] == self.generation:
            return self._ns_items_cache[1]
        out: dict[int, list[tuple[int, int]]] = {}
        it = self.interner
        for i in self._ns_rows:
            m = self._metas[i]
            if m is None:
                continue
            obj = self._objs[i]
            labels = obj.get("metadata", {}).get("labels", {}) if isinstance(obj, dict) else {}
            items = []
            if isinstance(labels, dict):
                for k in sorted(labels):
                    v = labels[k]
                    if isinstance(k, str):
                        items.append((it.intern(k), it.intern(v) if isinstance(v, str) else MISSING))
            out[it.intern(m.name)] = items
        self._ns_items_cache = (self.generation, out)
        return out

    def namespaces_dirty_since(self, gen: int) -> bool:
        """True if any v1/Namespace row changed (upsert OR remove) after
        `gen` — namespace label edits change namespaceSelector matching
        of OTHER rows in that namespace, so per-row delta updates of the
        match mask are only sound when this is False."""
        return self.ns_generation > gen
