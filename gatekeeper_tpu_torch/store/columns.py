# Copied from gatekeeper_tpu/store/columns.py for the PyTorch port.
"""Columnar field-path extraction.

Flattens JSON resources into fixed-dtype numpy columns for device
evaluation: scalar paths become dense id/float arrays, list/dict paths
become CSR ragged arrays.  Column *specs* are derived from template
lowering (which field paths a template touches) plus the always-on match
columns (gvk/name/namespace/labels, cf. pkg/target's match semantics).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np

from gatekeeper_tpu_torch.store.interner import Interner, MISSING

STAR = "*"


@dataclasses.dataclass(frozen=True)
class ColSpec:
    """A field-path column request.

    path: tuple of keys; "*" iterates a list (any number of stars).
    mode:
      'str'     scalar string -> int32 ids (MISSING if absent/non-string)
      'num'     scalar number -> float64 + bool presence
      'val'     variant scalar -> int32 encoded-value ids (ir/encode.py)
      'present' presence of any value at path -> bool
      'truthy'  present and not literal false -> bool (Rego statement truth)
      'len'     count() of list/dict/string at path -> float64 + presence
      'keys'    dict keys at path -> CSR int32 ids
      'items'   dict (key,value-str) at path -> CSR pairs
      'strs'    string leaves (wildcard paths) -> CSR int32 ids
      'nums'    number leaves -> CSR float64
    """

    path: tuple[str, ...]
    mode: str


@dataclasses.dataclass
class ScalarColumn:
    ids: np.ndarray            # int32 [n] (str mode)


@dataclasses.dataclass
class NumColumn:
    values: np.ndarray         # float64 [n]
    present: np.ndarray        # bool [n]


@dataclasses.dataclass
class PresenceColumn:
    present: np.ndarray        # bool [n]


@dataclasses.dataclass
class CSRColumn:
    values: np.ndarray         # int32 or float64 [total]
    offsets: np.ndarray        # int32 [n+1]
    # for 'items': parallel value ids
    values2: np.ndarray | None = None

    def row(self, i: int) -> np.ndarray:
        return self.values[self.offsets[i]: self.offsets[i + 1]]


def iter_path(obj: Any, path: tuple[str, ...]) -> Iterator[Any]:
    """Yield every leaf value reachable via path ("*" fans out over lists)."""
    if not path:
        yield obj
        return
    head, rest = path[0], path[1:]
    if head == STAR:
        if isinstance(obj, list):
            for x in obj:
                yield from iter_path(x, rest)
    elif isinstance(obj, dict):
        if head in obj:
            yield from iter_path(obj[head], rest)


def get_path(obj: Any, path: tuple[str, ...]) -> Any:
    """Single value at a star-free path, or None."""
    for p in path:
        if not isinstance(obj, dict) or p not in obj:
            return None
        obj = obj[p]
    return obj


def _has_path(obj: Any, path: tuple[str, ...]) -> bool:
    """Distinguishes an explicit null value from an absent key."""
    for p in path:
        if not isinstance(obj, dict) or p not in obj:
            return False
        obj = obj[p]
    return True


def build_column(spec: ColSpec, objs: list, interner: Interner):
    """objs: list of resource dicts (None rows are tombstones -> absent).
    Scalar star-free modes ride the native extractor when available;
    the Python bodies below are the semantics contract."""
    from gatekeeper_tpu_torch import native
    n = len(objs)
    if native.available and STAR not in spec.path and \
            spec.mode in ("str", "val", "num", "len", "present", "truthy"):
        from gatekeeper_tpu_torch.ir.encode import encode_value
        cells = native.scalar_col(objs, spec.path,
                                  native.MODE_CODES[spec.mode],
                                  interner._ids, interner._strings,
                                  encode_value)
        # `cells` is a read-only numpy view over the extension's raw
        # cell buffer (native/__init__.py) — always used as a gather/
        # copy source, never written in place
        if spec.mode in ("str", "val"):
            return ScalarColumn(ids=cells)
        if spec.mode in ("num", "len"):
            pres = ~np.isnan(cells)
            return NumColumn(values=np.nan_to_num(cells), present=pres)
        return PresenceColumn(present=cells)
    if spec.mode == "str":
        ids = np.full((n,), MISSING, dtype=np.int32)
        for i, o in enumerate(objs):
            if o is None:
                continue
            v = get_path(o, spec.path)
            if isinstance(v, str):
                ids[i] = interner.intern(v)
        return ScalarColumn(ids=ids)
    if spec.mode == "num":
        vals = np.zeros((n,), dtype=np.float64)
        pres = np.zeros((n,), dtype=bool)
        for i, o in enumerate(objs):
            if o is None:
                continue
            v = get_path(o, spec.path)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                try:
                    vals[i] = float(v)
                    pres[i] = True
                except OverflowError:
                    pass   # beyond float64: absent (device columns are f64)
        return NumColumn(values=vals, present=pres)
    if spec.mode == "val":
        from gatekeeper_tpu_torch.ir.encode import encode_value
        ids = np.full((n,), MISSING, dtype=np.int32)
        for i, o in enumerate(objs):
            if o is None:
                continue
            v = get_path(o, spec.path)
            if v is None and not _has_path(o, spec.path):
                continue
            key = encode_value(v)
            if key is not None:
                ids[i] = interner.intern(key)
        return ScalarColumn(ids=ids)
    if spec.mode == "present":
        pres = np.zeros((n,), dtype=bool)
        for i, o in enumerate(objs):
            if o is None:
                continue
            pres[i] = any(True for _ in iter_path(o, spec.path))
        return PresenceColumn(present=pres)
    if spec.mode == "truthy":
        pres = np.zeros((n,), dtype=bool)
        for i, o in enumerate(objs):
            if o is None:
                continue
            if _has_path(o, spec.path):
                pres[i] = get_path(o, spec.path) is not False
        return PresenceColumn(present=pres)
    if spec.mode == "len":
        vals = np.zeros((n,), dtype=np.float64)
        pres = np.zeros((n,), dtype=bool)
        for i, o in enumerate(objs):
            if o is None:
                continue
            v = get_path(o, spec.path)
            if isinstance(v, (list, dict, str)):
                vals[i] = float(len(v))
                pres[i] = True
        return NumColumn(values=vals, present=pres)
    if spec.mode in ("keys", "items"):
        koffs = np.zeros((n + 1,), dtype=np.int32)
        kids: list[int] = []
        vids: list[int] = []
        for i, o in enumerate(objs):
            if o is not None:
                d = get_path(o, spec.path)
                if isinstance(d, dict):
                    for k in sorted(d.keys()):
                        if isinstance(k, str):
                            kids.append(interner.intern(k))
                            if spec.mode == "items":
                                v = d[k]
                                vids.append(interner.intern(v) if isinstance(v, str) else MISSING)
            koffs[i + 1] = len(kids)
        values2 = np.asarray(vids, dtype=np.int32) if spec.mode == "items" else None
        return CSRColumn(values=np.asarray(kids, dtype=np.int32), offsets=koffs,
                         values2=values2)
    if spec.mode == "strs":
        offs = np.zeros((n + 1,), dtype=np.int32)
        out: list[int] = []
        for i, o in enumerate(objs):
            if o is not None:
                for v in iter_path(o, spec.path):
                    if isinstance(v, str):
                        out.append(interner.intern(v))
                    else:
                        out.append(MISSING)
            offs[i + 1] = len(out)
        return CSRColumn(values=np.asarray(out, dtype=np.int32), offsets=offs)
    if spec.mode == "nums":
        offs = np.zeros((n + 1,), dtype=np.int32)
        fout: list[float] = []
        for i, o in enumerate(objs):
            if o is not None:
                for v in iter_path(o, spec.path):
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        fout.append(float(v))
                    else:
                        fout.append(np.nan)
            offs[i + 1] = len(fout)
        return CSRColumn(values=np.asarray(fout, dtype=np.float64), offsets=offs)
    raise ValueError(f"unknown column mode {spec.mode!r}")


# ---------------------------------------------------------------------------
# delta maintenance
#
# Incremental column updates: re-extract only the rows touched since the
# cached build and splice them into the cached arrays.  This is what lets
# steady-state audit sweeps survive data churn without re-paying the full
# O(n) extraction (the reference's inmem store likewise writes paths in
# place inside a txn rather than rebuilding documents,
# vendor opa/storage/inmem/txn.go).  Copy-on-write: the cached arrays are
# never mutated — derived consumers (device-array caches) key on array
# identity.


def _grow(arr: np.ndarray, n: int, fill) -> np.ndarray:
    """Copy of `arr` grown to length n (new tail = fill)."""
    out = np.empty((n,) + arr.shape[1:], dtype=arr.dtype)
    out[: len(arr)] = arr
    if n > len(arr):
        out[len(arr):] = fill
    return out


def _splice_csr(old: CSRColumn, n: int, dirty: np.ndarray,
                sub: CSRColumn) -> CSRColumn:
    """New CSR with the dirty rows' segments replaced by `sub`'s rows
    (sub is a CSR over the dirty rows only, in `dirty` order).  One
    vectorized gather over the combined value pool — O(total) numpy,
    O(|dirty|) python."""
    n_old = len(old.offsets) - 1
    lengths = np.zeros((n,), dtype=np.int64)
    lengths[:n_old] = np.diff(old.offsets.astype(np.int64))
    sub_lens = np.diff(sub.offsets.astype(np.int64))
    lengths[dirty] = sub_lens
    offsets = np.zeros((n + 1,), dtype=np.int32)
    np.cumsum(lengths, out=offsets[1:])
    total = int(offsets[-1])
    # per-row base index into the combined [old.values | sub.values] pool
    base = np.zeros((n,), dtype=np.int64)
    base[:n_old] = old.offsets[:-1]
    base[dirty] = len(old.values) + sub.offsets[:-1]
    src = np.repeat(base, lengths) + \
        (np.arange(total, dtype=np.int64) - np.repeat(offsets[:-1].astype(np.int64), lengths))
    values = np.concatenate([old.values, sub.values])[src] if total else \
        old.values[:0]
    values2 = None
    if old.values2 is not None:
        values2 = np.concatenate([old.values2, sub.values2])[src] if total \
            else old.values2[:0]
    return CSRColumn(values=values, offsets=offsets, values2=values2)


def delta_column(spec: ColSpec, old, objs: list, dirty: np.ndarray,
                 interner: Interner):
    """Updated column: `old` built over a prefix of `objs`, `dirty` =
    row indices changed since (including appended rows).  Runs the same
    extractor (native when available) over just the dirty rows."""
    n = len(objs)
    sub = build_column(spec, [objs[int(i)] for i in dirty], interner)
    if spec.mode in ("str", "val"):
        ids = _grow(old.ids, n, MISSING)
        ids[dirty] = sub.ids
        return ScalarColumn(ids=ids)
    if spec.mode in ("num", "len"):
        vals = _grow(old.values, n, 0.0)
        pres = _grow(old.present, n, False)
        vals[dirty] = sub.values
        pres[dirty] = sub.present
        return NumColumn(values=vals, present=pres)
    if spec.mode in ("present", "truthy"):
        pres = _grow(old.present, n, False)
        pres[dirty] = sub.present
        return PresenceColumn(present=pres)
    # CSR modes
    return _splice_csr(old, n, dirty, sub)


@dataclasses.dataclass(frozen=True)
class RowRecord:
    """One column's host-staged row-sized update record: the dirty row
    indices plus exactly those rows' values, contiguous and ready for a
    device scatter.  This is the H2D unit of the device-resident paged
    store (GATEKEEPER_DEVPAGES): churn ships records, never whole
    columns or whole pages, so transfer bytes scale with churned rows ×
    read-set columns — the same append-only discipline the interner's
    byte matrix established, extended to numeric/bitmap columns."""

    name: str
    rows: np.ndarray           # int [k] dirty row indices
    values: np.ndarray         # [k, ...] the rows' new values

    @property
    def nbytes(self) -> int:
        return int(self.rows.nbytes) + int(self.values.nbytes)


def build_row_records(arrays: dict[str, Any], rows: np.ndarray,
                      axes: dict[str, int | None]) -> \
        tuple[list[RowRecord], int]:
    """Stage row-sized update records for every row-axis array.

    ``arrays`` are the bound host arrays (name -> ndarray), ``rows``
    the dirty row indices, ``axes`` maps each name to the index of its
    resource axis (None = replicated/table array, not row-addressed —
    skipped; a change to one invalidates the whole binding set
    upstream, so records would be meaningless).  Returns the records
    plus the total staged byte count — the number the
    ``store_h2d_bytes_total`` metric and the devpages_churn bench row
    account against whole-page re-upload."""
    records: list[RowRecord] = []
    total = 0
    for name, arr in arrays.items():
        ax = axes.get(name)
        if ax is None:
            continue
        a = np.asarray(arr)
        if ax >= a.ndim or a.shape[ax] <= (int(rows.max()) if len(rows)
                                           else 0):
            continue
        idx = [slice(None)] * a.ndim
        idx[ax] = rows
        vals = np.ascontiguousarray(a[tuple(idx)])
        rec = RowRecord(name=name, rows=rows, values=vals)
        records.append(rec)
        total += rec.nbytes
    return records, total
