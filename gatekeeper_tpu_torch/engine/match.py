# Copied from gatekeeper_tpu/engine/match.py for the PyTorch port.
"""Vectorized constraint matching: the [n_constraints, n_resources]
candidate mask.

Native equivalent of the target's Rego matching library
(reference pkg/target/target.go:49-255 — matching_constraints with
kinds/apiGroups, namespaces, labelSelector, namespaceSelector), whose
scalar transcription lives in target/k8s.py.  The audit cross-product
runs matching once per (constraint, resource) pair inside the topdown
interpreter (target.go:69-81); here each selector primitive is computed
once as a column over all resources (numpy vectorized over the ragged
label CSR), and each constraint combines primitive columns.

The mask gates template evaluation: device violation masks are ANDed
with it, and the scalar fallback only visits candidate pairs.

``mask_rows`` evaluates the same semantics over a row *subset* — the
delta path for steady-state churn (only dirty rows re-match; sound
unless a Namespace object changed, which shifts namespaceSelector
results of other rows — the caller checks ``namespaces_dirty_since``).

Semantics notes mirrored from the scalar matcher:
- absent `kinds` field -> wildcard; explicit empty list matches nothing;
- `namespaces`: review.namespace must be listed (cluster-scoped
  resources have no namespace and never match);
- labelSelector matchExpressions use *violation* semantics per operator
  (missing key violates In/Exists, NotIn never violates on missing,
  empty values disarm In/NotIn) — target.go:178-219;
- namespaceSelector resolves against the cached v1/Namespace object;
  an uncached namespace never matches (autoreject is review-path only,
  target.go:36-47).
"""

from __future__ import annotations

import numpy as np

from gatekeeper_tpu_torch.store.interner import MISSING
from gatekeeper_tpu_torch.store.table import ResourceTable


class _LabelIndex:
    """Vectorized label lookups over a (possibly row-subset) CSR."""

    def __init__(self, keys: np.ndarray, vals: np.ndarray,
                 offsets: np.ndarray, n: int):
        counts = np.diff(offsets.astype(np.int64))
        self.row_ids = np.repeat(np.arange(n, dtype=np.int64), counts)
        self.keys = keys
        self.vals = vals
        self.n = n
        self._value_cache: dict[int, np.ndarray] = {}
        self._present_cache: dict[int, np.ndarray] = {}

    def value_of(self, key_id: int) -> np.ndarray:
        """int32 [n]: label value id for key, MISSING where absent OR
        where the value is not a string (unrepresentable as an id)."""
        hit = self._value_cache.get(key_id)
        if hit is not None:
            return hit
        out = np.full((self.n,), MISSING, dtype=np.int32)
        if key_id != MISSING and len(self.keys):
            sel = self.keys == key_id
            out[self.row_ids[sel]] = self.vals[sel]
        self._value_cache[key_id] = out
        return out

    def has_key(self, key_id: int) -> np.ndarray:
        """Key PRESENCE, independent of value representability: a label
        whose value is non-string has no value id but still exists —
        `Exists` must see it (the scalar matcher's `key in labels`),
        else the mask under-approximates and violations are dropped."""
        hit = self._present_cache.get(key_id)
        if hit is None:
            out = np.zeros((self.n,), dtype=bool)
            if key_id != MISSING and len(self.keys):
                out[self.row_ids[self.keys == key_id]] = True
            self._present_cache[key_id] = hit = out
        return hit


def _selector_ok(it, lab: _LabelIndex, selector: dict) -> np.ndarray:
    """matches_label_selector vectorized over whatever axis `lab`
    indexes (resources for labelSelector, cached namespaces for
    namespaceSelector — same semantics, target.go:178-255)."""
    ok = np.ones((lab.n,), dtype=bool)
    for k, v in (selector.get("matchLabels") or {}).items():
        vid = it.lookup(v) if isinstance(v, str) else MISSING
        ok &= lab.value_of(it.lookup(k) if isinstance(k, str) else MISSING) == vid \
            if vid != MISSING else np.zeros((lab.n,), dtype=bool)
    for expr in selector.get("matchExpressions") or []:
        ok &= ~_expr_violated(it, lab, expr)
    return ok


def _expr_violated(it, lab: _LabelIndex, expr: dict) -> np.ndarray:
    """Per-operator violation semantics (missing key violates
    In/Exists, NotIn never violates on missing, empty values disarm
    In/NotIn) — target.go:178-219."""
    op = expr.get("operator", "")
    key = expr.get("key", "")
    kid = it.lookup(key) if isinstance(key, str) else MISSING
    values = expr.get("values") or []
    has = lab.has_key(kid)
    if op == "Exists":
        return ~has
    if op == "DoesNotExist":
        return has
    # an unseen selector value has no id: drop it, or lookup's MISSING
    # would alias the absent-value sentinel and In/NotIn would treat
    # every unrepresentable label value as a match
    vids = [x for x in (it.lookup(v) for v in values if isinstance(v, str))
            if x != MISSING]
    val = lab.value_of(kid)
    in_vals = np.isin(val, np.asarray(vids, dtype=np.int32)) if vids \
        else np.zeros((lab.n,), dtype=bool)
    if op == "In":
        if not values:
            return ~has
        return ~has | (has & ~in_vals)
    if op == "NotIn":
        return has & in_vals if values else np.zeros((lab.n,), dtype=bool)
    return np.zeros((lab.n,), dtype=bool)  # unknown operator: no clause


class _View:
    """Identity/label/namespace columns for one row set (all rows or a
    dirty subset), with the selector primitives evaluated over it."""

    def __init__(self, table: ResourceTable, rows: np.ndarray | None):
        ident = table.identity()
        self.table = table
        self.rows = rows
        if rows is None:
            self.n = len(ident.alive)
            self.alive = ident.alive
            self.group_ids = ident.group_ids
            self.kind_ids = ident.kind_ids
            self.ns_ids = ident.ns_ids
        else:
            self.n = len(rows)
            self.alive = ident.alive[rows]
            self.group_ids = ident.group_ids[rows]
            self.kind_ids = ident.kind_ids[rows]
            self.ns_ids = ident.ns_ids[rows]
        self._labels: _LabelIndex | None = None
        self._ns_index: tuple | None = None

    @property
    def labels(self) -> _LabelIndex:
        """Label lookups, built on first selector use — constraints
        without label/expression selectors (common) never pay the
        extraction."""
        if self._labels is None:
            if self.rows is None:
                keys, vals, offs = self.table.labels_csr()
                self._labels = _LabelIndex(keys, vals, offs, self.n)
            else:
                # labels for the subset come straight from the objects —
                # O(|rows|), never forcing the full-CSR delta splice
                from gatekeeper_tpu_torch.store.columns import ColSpec, build_column
                col = build_column(ColSpec(("metadata", "labels"), "items"),
                                   [self.table._objs[int(r)] for r in self.rows],
                                   self.table.interner)
                vals2 = col.values2 if col.values2 is not None else col.values
                self._labels = _LabelIndex(col.values, vals2, col.offsets,
                                           self.n)
        return self._labels

    # -- selector primitives -------------------------------------------

    def selector_ok_obj(self, selector: dict) -> np.ndarray:
        """matches_label_selector over object labels, vectorized [n]."""
        return _selector_ok(self.table.interner, self.labels, selector)

    def selector_ok_ns(self, selector: dict) -> np.ndarray:
        """namespaceSelector, vectorized over the NAMESPACE axis: the
        selector is evaluated once per cached namespace with the same
        primitives as the object path (not a Python loop calling the
        scalar matcher — 100k namespaces made that the matching
        bottleneck), then gathered per resource; uncached namespace
        (slot -1) -> False."""
        ns_ids, slots, lab = self._namespace_label_index()
        ok_ns = _selector_ok(self.table.interner, lab, selector)   # [K]
        padded = np.append(ok_ns, False)                # last = uncached
        return padded[np.where(slots >= 0, slots, len(ns_ids))] \
            & (slots >= 0)

    def _namespace_label_index(self):
        """(ns name ids [K] sorted, per-resource slot [n], _LabelIndex
        over the K namespaces), built once per view."""
        if self._ns_index is not None:
            return self._ns_index
        items = self.table.namespace_label_items()
        ns_ids = np.asarray(sorted(items), dtype=np.int32)
        col = self.ns_ids
        if len(ns_ids):
            pos = np.searchsorted(ns_ids, col)
            pos = np.clip(pos, 0, len(ns_ids) - 1)
            slots = np.where(ns_ids[pos] == col, pos, -1).astype(np.int32)
        else:
            slots = np.full(col.shape, -1, dtype=np.int32)
        keys: list[int] = []
        vals: list[int] = []
        offsets = np.zeros((len(ns_ids) + 1,), dtype=np.int64)
        for s, nid in enumerate(ns_ids):
            for k, v in items[int(nid)]:
                keys.append(k)
                vals.append(v)
            offsets[s + 1] = len(keys)
        lab = _LabelIndex(np.asarray(keys, dtype=np.int32),
                          np.asarray(vals, dtype=np.int32),
                          offsets, len(ns_ids))
        self._ns_index = (ns_ids, slots, lab)
        return self._ns_index

    # -- the mask over this view --------------------------------------

    def mask(self, constraints: list[dict],
             overapprox_ns: bool = False) -> np.ndarray:
        """bool [len(constraints), self.n]; tombstoned rows are False.

        ``overapprox_ns`` treats namespaceSelector clauses as matching
        everything — for masks over rows that are NOT the inventory this
        table's namespaces describe (the admission batch path evaluates
        candidate pairs exactly on the host afterwards; the mask must
        only never under-approximate)."""
        it = self.table.interner
        n = self.n
        out = np.zeros((len(constraints), n), dtype=bool)
        for ci, c in enumerate(constraints):
            match = (c.get("spec") or {}).get("match") or {}
            m = self.alive.copy()

            if "kinds" in match:
                kinds = match["kinds"] if isinstance(match["kinds"], list) else []
                km = np.zeros((n,), dtype=bool)
                for ks in kinds:
                    groups = ks.get("apiGroups") or []
                    knames = ks.get("kinds") or []
                    # unseen names have no id; drop them so lookup's
                    # MISSING can't alias rows whose identity column
                    # holds the absent sentinel
                    gids = [x for x in (it.lookup(g) for g in groups
                                        if isinstance(g, str))
                            if x != MISSING]
                    kids = [x for x in (it.lookup(k) for k in knames
                                        if isinstance(k, str))
                            if x != MISSING]
                    gm = np.ones((n,), dtype=bool) if "*" in groups else \
                        np.isin(self.group_ids,
                                np.asarray(gids, dtype=np.int32))
                    nm = np.ones((n,), dtype=bool) if "*" in knames else \
                        np.isin(self.kind_ids,
                                np.asarray(kids, dtype=np.int32))
                    km |= gm & nm
                m &= km

            if "namespaces" in match and match["namespaces"] is not None:
                nss = [it.lookup(s) for s in match["namespaces"]
                       if isinstance(s, str)]
                m &= np.isin(self.ns_ids, np.asarray(nss, dtype=np.int32)) \
                    & (self.ns_ids != MISSING)

            if "namespaceSelector" in match and match["namespaceSelector"] is not None \
                    and not overapprox_ns:
                m &= self.selector_ok_ns(match["namespaceSelector"])

            selector = match.get("labelSelector") or {}
            if selector:
                m &= self.selector_ok_obj(selector)

            out[ci] = m
        return out


class MatchEngine:
    def __init__(self, table: ResourceTable):
        self.table = table
        self._gen = -1
        self._view: _View | None = None
        self._sub_view: tuple | None = None   # ((since, gen), view, rows)

    def _full_view(self) -> _View:
        gen = self.table.generation
        if self._view is None or gen != self._gen:
            self._gen = gen
            self._view = _View(self.table, None)
        return self._view

    def mask(self, constraints: list[dict],
             overapprox_ns: bool = False) -> np.ndarray:
        """bool [len(constraints), n_rows]; tombstoned rows are False.
        See _View.mask for ``overapprox_ns``."""
        return self._full_view().mask(constraints, overapprox_ns)

    def mask_rows(self, constraints: list[dict],
                  rows: np.ndarray) -> np.ndarray:
        """bool [len(constraints), len(rows)] over a row subset — the
        churn delta path.  NOT sound across Namespace-object changes
        (namespaceSelector results of unchanged rows shift); callers
        gate on table.namespaces_dirty_since."""
        return _View(self.table, rows).mask(constraints)

    def mask_rows_since(self, constraints: list[dict], since_gen: int):
        """(mask [C, |rows|], rows) for the rows dirty after since_gen.
        The subset view (identity slices + labels pulled from the dirty
        objects) is cached per (since_gen, generation) — every template
        kind of a sweep shares one view build.  Same namespace-churn
        caveat as mask_rows."""
        gen = self.table.generation
        key = (since_gen, gen)
        hit = self._sub_view
        if hit is None or hit[0] != key:
            rows = self.table.dirty_rows_since(since_gen)
            hit = (key, _View(self.table, rows), rows)
            self._sub_view = hit
        return hit[1].mask(constraints), hit[2]
