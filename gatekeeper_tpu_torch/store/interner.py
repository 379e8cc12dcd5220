# Copied from gatekeeper_tpu/store/interner.py for the PyTorch port.
"""Global string interner with a device-side byte table.

Every string that enters the inventory (field values, label keys, names,
kinds) is mapped to a stable int32 id.  Identity comparisons on device are
then integer compares; prefix/suffix/regex ops use the padded byte table
(``bytes_matrix``), which stores each interned string as a fixed-width
uint8 row — the device-side analogue of the reference keeping raw JSON
strings in its inmem store (vendor opa/storage/inmem/inmem.go:31).

Id 0 is reserved for the empty string; MISSING (-1) marks absent values in
columns.
"""

from __future__ import annotations

import threading

import numpy as np

MISSING = -1


class Interner:
    def __init__(self, max_str_len: int = 128):
        self._ids: dict[str, int] = {"": 0}
        self._strings: list[str] = [""]
        self.max_str_len = max_str_len
        # device-table cache: rebuilt lazily when new strings arrive
        self._bytes_cache: np.ndarray | None = None
        self._len_cache: np.ndarray | None = None
        self._cache_size = 0
        # guards the append path only: concurrent readers doing delta
        # cache fills may intern DIFFERENT new strings (the
        # identical-computation argument holds per kind, not across
        # kinds), and an unguarded read-len-then-append interleaving
        # would assign one id to two strings.  The hit path stays
        # lock-free (dict reads are atomic); the native extractor holds
        # the GIL across its whole per-string intern, and bulk callers
        # additionally serialize under the driver prep lock.
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._strings)

    def intern(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            with self._lock:
                i = self._ids.get(s)
                if i is None:
                    i = len(self._strings)
                    self._strings.append(s)
                    self._ids[s] = i
        return i

    def lookup(self, s: str) -> int:
        """Id of an already-interned string, or MISSING (no insertion).

        Used when compiling constraint parameters: a parameter string that
        was never seen in any resource cannot match any column value.
        """
        return self._ids.get(s, MISSING)

    def string(self, i: int) -> str:
        return self._strings[i]

    def bytes_table(self) -> tuple[np.ndarray, np.ndarray]:
        """(bytes[n, max_str_len] uint8, lengths[n] int32), padded with 0.

        Strings longer than max_str_len are truncated on device; exact ops
        over them must bail to the host oracle (the lowerer checks
        ``is_exact_on_device``).
        """
        n = len(self._strings)
        if self._bytes_cache is None or self._cache_size != n:
            mat = np.zeros((n, self.max_str_len), dtype=np.uint8)
            lens = np.zeros((n,), dtype=np.int32)
            for i, s in enumerate(self._strings):
                b = s.encode("utf-8")[: self.max_str_len]
                mat[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
                lens[i] = len(b)
            self._bytes_cache = mat
            self._len_cache = lens
            self._cache_size = n
        return self._bytes_cache, self._len_cache

    def is_exact_on_device(self, i: int) -> bool:
        return len(self._strings[i].encode("utf-8")) <= self.max_str_len
