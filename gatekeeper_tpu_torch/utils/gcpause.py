"""Cyclic-GC pauses for bulk loads of the resource cache.

A cluster's worth of resources is a million-object graph of parsed
JSON.  Loading it in one burst (the initial list-sync through
``Client.add_data_batch``, or a warm restart's store snapshot through
``TorchDriver.restore_store_snapshot``) makes every cyclic-GC pass on
the way traverse the whole graph again.  :class:`BulkLoad` pauses the
collector for the burst; past ``FREEZE_MIN_OBJECTS`` resources it then
moves the heap to GC's permanent generation (``gc.freeze``), so the
passes after the load skip it too.  Refcounting still reclaims frozen
objects; only cycle detection skips them.  ``GATEKEEPER_NO_GC_FREEZE=1``
keeps the pause and drops the freeze.
"""

from __future__ import annotations

import gc
import os

FREEZE_MIN_OBJECTS = 65536


class BulkLoad:
    """``with BulkLoad(n) as load:`` pauses cyclic GC for the block.
    ``load.n_objects`` may be set inside the block, when the load only
    learns its size there (a snapshot read)."""

    def __init__(self, n_objects: int = 0):
        self.n_objects = n_objects
        self._was_enabled = False

    def __enter__(self) -> "BulkLoad":
        self._was_enabled = gc.isenabled()
        gc.disable()
        return self

    def __exit__(self, *exc) -> None:
        try:
            if self.n_objects >= FREEZE_MIN_OBJECTS and \
                    os.environ.get("GATEKEEPER_NO_GC_FREEZE") != "1":
                # young generations only: a full pass would itself
                # traverse the graph about to be frozen
                gc.collect(1)
                gc.freeze()
        finally:
            if self._was_enabled:
                gc.enable()
