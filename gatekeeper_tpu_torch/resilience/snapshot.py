# Copied from gatekeeper_tpu/resilience/snapshot.py for the PyTorch port.
"""Warm-restart persistence: lowered IR, dedup plans, store snapshots.

The build caches (utils/compile_cache.py) keep the compiled kernels; the
artifacts that dominate a cold start — Rego parsing and lowering, IR
verification, the install-time certificates, dedup planning, store
replication and the verdict ledger's cold build — are persisted here,
on every device:

- **template IR** (``ir``): the full ``LoweredProgram`` per template,
  keyed by a digest of (kind, target, Rego source).  A ``None`` payload
  is a negative certificate — the template is known scalar-only
  (CannotLower), so the restarted process skips the lowering *attempt*
  too.
- **parsed module** (``mod``): the template's parsed + vetted Rego AST,
  keyed like the IR — a warm client skips parse, hygiene checks, and
  the stage-1 vet.
- **dedup plan** (``plan``): the whole-policy-set predicate dedup plan,
  keyed by the digest of the installed set.
- the install-time certificates: Stage-4 translation-validation
  certificates (``cert``), Stage-5 footprints (``fp``), Stage-6
  partition plans (``sp``), Stage-7 compile surfaces and AOT-precompile
  geometry stamps (``cs``), Stage-8 memory surfaces (``ms``), and the
  compiled regex DFAs (``dfa``);
- **store snapshot** (``store``): the columnar store's rows + interned
  string table as plain data (``ResourceTable.snapshot_state()``), and
  its companion **pagemap** (``pg``): the verdict ledger's confirmed
  violations per kind with the watch RV watermark and each kind's
  devpages geometry, so a restarted process adopts the verdicts
  instead of confirming every pair on the host;
- **rollout** (``ro``): an in-flight promotion's state machine.

Activation is explicit: snapshots read/write only when
``GATEKEEPER_SNAPSHOT_DIR`` is set (the manager's ``main`` sets a
default; tests stay hermetic).

Two rules are the port's own:

- its entries live in their own subdirectory of the snapshot root
  (``torch-<fingerprint>-<python>-v<version>``) under their own magic,
  so an entry the JAX package wrote is never read here, nor the
  reverse, even under one ``GATEKEEPER_SNAPSHOT_DIR``: a foreign entry
  is a miss, never an error;
- no entry holds a tensor on a CUDA device (the pickler refuses one): a
  pickled CUDA tensor would load onto a card at unpickle time, outside
  the driver's device and its Stage-8 byte accounting.  Entries hold
  host data (numpy, Python), and the driver uploads what it needs.

**Why a custom pickler.**  A ``LoweredProgram``'s PrepSpec carries
*local* functions (TableReq.fn / PTableReq.fn / CSetReq.fn close over
the Lowerer and AST terms), which stdlib pickle rejects.  The pickler
below serializes such functions as (marshalled code object, defining
module, closure cell contents) and rebuilds them with
``types.FunctionType`` against the live module globals.  Marshalled
code is CPython-bytecode-version specific, so entries are keyed by
``host_fingerprint()`` + the exact Python version + a format version,
every file is length- and sha256-checked, and *any* load failure —
truncation, version skew, unpickle error — deletes the entry and falls
back to a cold rebuild.  Corruption can cost a re-lower; it can never
crash startup or poison a verdict.
"""

from __future__ import annotations

import hashlib
import importlib
import io
import json
import marshal
import os
import pickle
import sys
import threading
import types

import torch

from gatekeeper_tpu_torch.utils.log import logger

_log = logger("snapshot")

MAGIC = "gatekeeper-tpu-torch-snapshot"
VERSION = 1


# ----------------------------------------------------------------------
# stats (feeds restart_report and the smoke's restart counters)

class SnapshotStats:
    _FIELDS = ("ir_hits", "ir_misses", "mod_hits", "mod_misses",
               "plan_hits", "plan_misses",
               "cert_hits", "cert_misses",
               "store_hits", "store_misses",
               "fp_hits", "fp_misses",
               "sp_hits", "sp_misses",
               "pg_hits", "pg_misses",
               "dfa_hits", "dfa_misses",
               "ro_hits", "ro_misses",
               "cs_hits", "cs_misses",
               "ms_hits", "ms_misses", "corrupt_discarded",
               "saves", "save_errors")

    def __init__(self):
        self._lock = threading.Lock()
        for f in self._FIELDS:
            setattr(self, f, 0)

    def bump(self, field: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + by)

    def snapshot(self) -> dict:
        with self._lock:
            return {f: getattr(self, f) for f in self._FIELDS}

    def delta_since(self, snap: dict) -> dict:
        cur = self.snapshot()
        return {f: cur[f] - snap.get(f, 0) for f in self._FIELDS}


stats = SnapshotStats()


# ----------------------------------------------------------------------
# closure-aware pickling

def _rebuild_fn(code_b: bytes, module: str, name: str, defaults,
                kwdefaults, cells):
    code = marshal.loads(code_b)
    g = importlib.import_module(module).__dict__
    closure = None
    if cells is not None:
        closure = tuple(types.CellType(v) for v in cells)
    fn = types.FunctionType(code, g, name, defaults, closure)
    if kwdefaults:
        fn.__kwdefaults__ = dict(kwdefaults)
    return fn


def _rebuild_lock(kind: str):
    if kind == "rlock":
        return threading.RLock()
    if kind == "event":
        return threading.Event()
    if kind == "condition":
        return threading.Condition()
    return threading.Lock()


_LOCK_T = type(threading.Lock())
_RLOCK_T = type(threading.RLock())


def _host_tensor(t: torch.Tensor):
    """A CPU tensor pickles as torch pickles it; one on any other device
    is refused: it would load onto that device at unpickle time."""
    if t.device.type != "cpu":
        raise pickle.PicklingError(
            f"snapshot entries hold host data only: a tensor on "
            f"{t.device} cannot be persisted")
    return t.__reduce_ex__(4)


class _Pickler(pickle.Pickler):
    """stdlib pickle + reducers for the artifacts a LoweredProgram
    actually carries: local functions/lambdas (by marshalled code),
    synchronization primitives (rebuilt fresh), and modules (by name).
    A tensor on a device other than the CPU is refused."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            _host_tensor(obj)
            return NotImplemented
        if isinstance(obj, types.FunctionType):
            qual = getattr(obj, "__qualname__", "")
            if "<locals>" in qual or obj.__name__ == "<lambda>":
                cells = None
                if obj.__closure__:
                    # cell_contents raises ValueError on an empty cell
                    # (never observed in lowered IR; a PicklingError
                    # here just skips the save)
                    cells = tuple(c.cell_contents for c in obj.__closure__)
                return (_rebuild_fn,
                        (marshal.dumps(obj.__code__),
                         obj.__module__ or "builtins", obj.__name__,
                         obj.__defaults__, obj.__kwdefaults__, cells))
            return NotImplemented
        if isinstance(obj, _LOCK_T):
            return (_rebuild_lock, ("lock",))
        if isinstance(obj, _RLOCK_T):
            return (_rebuild_lock, ("rlock",))
        if isinstance(obj, threading.Event):
            return (_rebuild_lock, ("event",))
        if isinstance(obj, threading.Condition):
            return (_rebuild_lock, ("condition",))
        if isinstance(obj, types.ModuleType):
            return (importlib.import_module, (obj.__name__,))
        return NotImplemented


def dumps(obj) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, protocol=4).dump(obj)
    return buf.getvalue()


# ----------------------------------------------------------------------
# the on-disk store

def enabled() -> bool:
    return bool(os.environ.get("GATEKEEPER_SNAPSHOT_DIR"))


def _python_tag() -> str:
    return f"cpython-{sys.version_info[0]}.{sys.version_info[1]}"


def snapshot_dir(create: bool = False, root: str | None = None) -> str | None:
    """The port's per-(host, python, format-version) subdirectory of the
    snapshot root — marshalled code never crosses an interpreter or
    format boundary, and the ``torch-`` prefix keeps the JAX package's
    entries and the port's apart.  ``root`` overrides the env var
    (historical-snapshot reads, whatif/replay.py)."""
    root = root or os.environ.get("GATEKEEPER_SNAPSHOT_DIR")
    if not root:
        return None
    from gatekeeper_tpu_torch.utils.compile_cache import host_fingerprint
    d = os.path.join(
        root, f"torch-{host_fingerprint()}-{_python_tag()}-v{VERSION}")
    if create:
        os.makedirs(d, exist_ok=True)
    return d


def _entry_path(category: str, key: str,
                root: str | None = None) -> str | None:
    d = snapshot_dir(root=root)
    if d is None:
        return None
    h = hashlib.sha256(key.encode()).hexdigest()[:24]
    return os.path.join(d, f"{category}-{h}.snap")


def _discard(path: str, why: str) -> None:
    stats.bump("corrupt_discarded")
    _log.warning("discarding snapshot entry; will rebuild",
                 path=os.path.basename(path), why=why)
    try:
        os.remove(path)
    except OSError:
        pass


def _write_entry(category: str, key: str, payload: bytes) -> bool:
    path = _entry_path(category, key)
    if path is None:
        return False
    try:
        snapshot_dir(create=True)
        header = json.dumps({
            "magic": MAGIC, "version": VERSION, "python": _python_tag(),
            "key": key, "sha256": hashlib.sha256(payload).hexdigest(),
            "len": len(payload),
        }).encode()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(header + b"\n" + payload)
        os.replace(tmp, path)   # atomic: readers see old-or-new, never torn
        stats.bump("saves")
        return True
    except Exception as e:   # noqa: BLE001 — persistence is best-effort
        stats.bump("save_errors")
        _log.warning("snapshot save failed", category=category, error=e)
        return False


def _read_entry(category: str, key: str, root: str | None = None):
    """Returns the unpickled payload in a 1-tuple, or None on miss.
    Any validation or unpickle failure deletes the entry (rebuild on
    the cold path) — corruption must never crash startup."""
    path = _entry_path(category, key, root=root)
    if path is None or not os.path.exists(path):
        return None
    from gatekeeper_tpu_torch.resilience import faults
    if faults.take("snapshot_corrupt"):
        _discard(path, "fault injection: snapshot_corrupt")
        return None
    try:
        with open(path, "rb") as f:
            raw = f.read()
        nl = raw.index(b"\n")
        hdr = json.loads(raw[:nl])
        payload = raw[nl + 1:]
        if hdr.get("magic") != MAGIC:
            _discard(path, "bad magic")
            return None
        if hdr.get("version") != VERSION or hdr.get("python") != _python_tag():
            _discard(path, "version mismatch")
            return None
        if hdr.get("key") != key:
            _discard(path, "key mismatch")
            return None
        if hdr.get("len") != len(payload):
            _discard(path, "truncated")
            return None
        if hdr.get("sha256") != hashlib.sha256(payload).hexdigest():
            _discard(path, "checksum mismatch")
            return None
        return (pickle.loads(payload),)
    except Exception as e:   # noqa: BLE001 — any failure => cold rebuild
        _discard(path, f"load error: {e}")
        return None


def _load(category: str, key: str, root: str | None = None):
    """One tier's read: the 1-tuple hit or None, counted as the tier's
    hit or miss."""
    got = _read_entry(category, key, root=root)
    stats.bump(f"{category}_hits" if got is not None
               else f"{category}_misses")
    return got


def _save(category: str, key: str, obj, what: str) -> bool:
    """One tier's write: False (counted in ``save_errors``) when the
    object does not pickle, e.g. a device tensor."""
    try:
        payload = dumps(obj)
    except Exception as e:   # noqa: BLE001 — an unpicklable artifact
        stats.bump("save_errors")   # just stays cold-start-only
        _log.warning(f"{what} not snapshottable", error=e)
        return False
    return _write_entry(category, key, payload)


# ----------------------------------------------------------------------
# typed entry points

def template_digest(kind: str, target: str, source: str) -> str:
    # GATEKEEPER_DFA changes what lower() emits (dfa_match nodes vs host
    # lookup tables), so IR entries must never cross flag modes — fold
    # the mode into the digest rather than the VERSION so flipping the
    # flag back and forth reuses both snapshot populations.
    from gatekeeper_tpu_torch.ops.regex_dfa import dfa_enabled
    mode = "dfa" if dfa_enabled() else "nodfa"
    h = hashlib.sha256(
        f"{kind}\x00{target}\x00{source}\x00v{VERSION}\x00{mode}".encode())
    return h.hexdigest()[:24]


def load_template_ir(kind: str, target: str, source: str):
    """None = miss.  A 1-tuple hit carries the LoweredProgram, or None
    when the saved outcome was CannotLower (skip the attempt too)."""
    if not enabled():
        return None
    return _load("ir", f"ir:{template_digest(kind, target, source)}")


def save_template_ir(kind: str, target: str, source: str, lowered) -> bool:
    if not enabled():
        return False
    return _save("ir", f"ir:{template_digest(kind, target, source)}",
                 lowered, f"lowered IR of {kind}")


def load_template_module(kind: str, target: str, source: str):
    """None = miss.  A 1-tuple hit carries ``(Module, uses_inventory)``
    — the parsed + hygiene-checked + vetted AST.  Entries are written
    only after the stage-1 vet passes, so a hit certifies the source as
    vetted; the Interpreter is rebuilt fresh from the Module (its side
    tables are id()-keyed and must never cross a process boundary)."""
    if not enabled():
        return None
    return _load("mod", f"mod:{template_digest(kind, target, source)}")


def save_template_module(kind: str, target: str, source: str,
                         module_and_flags) -> bool:
    if not enabled():
        return False
    return _save("mod", f"mod:{template_digest(kind, target, source)}",
                 module_and_flags, f"parsed module of {kind}")


def policyset_digest(parts: list[str]) -> str:
    h = hashlib.sha256()
    for p in sorted(parts):
        h.update(p.encode())
        h.update(b"\x00")
    return h.hexdigest()[:24]


def load_dedup_plan(digest: str):
    if not enabled():
        return None
    return _load("plan", f"plan:{digest}")


def save_dedup_plan(digest: str, plan) -> bool:
    if not enabled():
        return False
    return _save("plan", f"plan:{digest}", plan, "dedup plan")


def load_cert(digest: str):
    """Stage-4 translation-validation certificates
    (analysis/transval.py), keyed by the certificate digest (program
    cache_key + constraint docs + budget + validator version): a warm
    restart re-runs zero validations."""
    if not enabled():
        return None
    return _load("cert", f"cert:{digest}")


def save_cert(digest: str, cert) -> bool:
    if not enabled():
        return False
    return _save("cert", f"cert:{digest}", cert, "certificate")


def load_footprint(digest: str):
    """Stage-5 dependency footprints, keyed by the footprint digest
    (program cache_key + prep-spec signature + analyzer version): a warm
    restart re-runs zero dependency analyses."""
    if not enabled():
        return None
    return _load("fp", f"fp:{digest}")


def save_footprint(digest: str, fp) -> bool:
    if not enabled():
        return False
    return _save("fp", f"fp:{digest}", fp, "footprint")


def load_shardplan(digest: str):
    """Stage-6 partition plans, keyed by the shardplan digest: a warm
    restart re-runs zero sharding analyses."""
    if not enabled():
        return None
    return _load("sp", f"sp:{digest}")


def save_shardplan(digest: str, plan) -> bool:
    if not enabled():
        return False
    return _save("sp", f"sp:{digest}", plan, "shardplan")


def load_compilesurface(digest: str):
    """Stage-7 compile-surface certificates (analysis/compilesurface.py),
    keyed by program cache_key + pad-geometry version + ladder caps, and
    the AOT-precompile geometry stamps ``TorchDriver.precompile`` writes
    under ``aot:`` keys: a warm restart re-runs zero surface analyses and
    issues zero precompile launches."""
    if not enabled():
        return None
    return _load("cs", f"cs:{digest}")


def save_compilesurface(digest: str, cert) -> bool:
    if not enabled():
        return False
    return _save("cs", f"cs:{digest}", cert, "compile surface")


def load_memsurface(digest: str):
    """Stage-8 memory-surface certificates, keyed by program cache_key +
    pad-geometry version + deployment caps: a warm restart re-runs zero
    peak-memory analyses; a caps or geometry change invalidates by key
    mismatch."""
    if not enabled():
        return None
    return _load("ms", f"ms:{digest}")


def save_memsurface(digest: str, cert) -> bool:
    if not enabled():
        return False
    return _save("ms", f"ms:{digest}", cert, "memory surface")


def load_dfa(digest: str):
    """Compiled regex byte-DFA tables (ops/regex_dfa), keyed by the
    pattern + DFA_VERSION digest: a warm restart compiles zero automata.
    A hit may carry None — a negative certificate for a pattern known to
    fall outside the supported subset (skip the compile attempt)."""
    if not enabled():
        return None
    return _load("dfa", f"dfa:{digest}")


def save_dfa(digest: str, dfa) -> bool:
    if not enabled():
        return False
    return _save("dfa", f"dfa:{digest}", dfa, "dfa table")


def load_store(target: str, root: str | None = None):
    """Load the store tier.  With ``root``, read from that snapshot
    root explicitly (a *historical* snapshot directory, independent of
    GATEKEEPER_SNAPSHOT_DIR) — the replay path's time machine."""
    if root is None and not enabled():
        return None
    return _load("store", f"store:{target}", root=root)


def save_store(target: str, state) -> bool:
    if not enabled():
        return False
    return _save("store", f"store:{target}", state, "store snapshot")


def load_pagemap(target: str, root: str | None = None):
    """Load the pagemap tier: the VerdictLedger's per-kind confirmed
    violation sets, saved alongside the store tier so a warm restart
    adopts its verdicts (revalidated per kind by constraint digest +
    row count) instead of paying a cold full build."""
    if root is None and not enabled():
        return None
    return _load("pg", f"pg:{target}", root=root)


def save_pagemap(target: str, payload_obj) -> bool:
    if not enabled():
        return False
    return _save("pg", f"pg:{target}", payload_obj, "pagemap snapshot")


def load_rollout(name: str, root: str | None = None):
    """Promotion-rollout state (rollout/controller.py), keyed by rollout
    name: a warm restart resumes an in-flight promotion at the same
    rung."""
    if root is None and not enabled():
        return None
    return _load("ro", f"ro:{name}", root=root)


def save_rollout(name: str, payload_obj) -> bool:
    if not enabled():
        return False
    return _save("ro", f"ro:{name}", payload_obj, "rollout state")


# ----------------------------------------------------------------------
# the combined restart counter

_TIERS = ("ir", "mod", "plan", "cert", "store", "fp", "sp", "pg", "dfa",
          "ro", "cs", "ms")


def tier_counts(s: dict) -> tuple[int, int]:
    """(hits, misses) summed across every snapshot tier of a stats dict
    (works on both ``stats.snapshot()`` absolutes and ``delta_since``
    deltas)."""
    hits = sum(s.get(f"{t}_hits", 0) for t in _TIERS)
    misses = sum(s.get(f"{t}_misses", 0) for t in _TIERS)
    return hits, misses


def restart_report() -> dict:
    """One number that reflects warm-restart reuse: the build caches'
    hits (libraries found, Triton variants loaded from disk) plus every
    snapshot tier's hits, and the same for misses.  The reference's
    ``xla`` entry (its executable cache) is ``builds`` here."""
    from gatekeeper_tpu_torch.utils.compile_cache import \
        persistent_cache_stats
    x = persistent_cache_stats().snapshot()
    s = stats.snapshot()
    t_hits, t_misses = tier_counts(s)
    return {
        "restart_persistent_cache_hits": x["hits"] + t_hits,
        "restart_persistent_cache_misses": x["misses"] + t_misses,
        "builds": x,
        "snapshot": s,
    }
