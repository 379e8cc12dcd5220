# Copied from gatekeeper_tpu/rollout/capture.py for the PyTorch port.
"""Durable admission capture log.

Replaces the per-process byte-capped JSONL admission corpus with a
segmented, rotating, checksummed capture log that survives production
rates and process restarts:

- **Segments**: fixed-size files ``capture-<seq:08d>.seg`` under a
  capture directory, each starting with an 8-byte magic.  A writer
  seals a segment once it crosses ``GATEKEEPER_CAPTURE_SEGMENT_BYTES``
  and rotates to the next sequence number; old segments are pruned
  down to ``GATEKEEPER_CAPTURE_KEEP``.
- **Framing**: every record is ``>II`` (payload length, CRC-32) + the
  UTF-8 JSON payload.  The CRC makes torn and corrupted records
  detectable without trusting file length.
- **Decoupled writer** (Podracer-style actor/learner split): the
  admission path only enqueues onto a bounded queue and never blocks —
  a full queue counts a drop and returns.  A daemon writer thread
  drains the queue, frames records, and rotates segments.
- **Crash safety**: opening a log for append scans the newest segment
  and truncates a torn tail frame, so a crash mid-write loses at most
  the record that was being written, never committed ones.
- **Ordered replay**: the reader walks segments by sequence number and
  frames in file order, across however many process restarts produced
  them.  A CRC mismatch rejects the remainder of that segment (the
  framing downstream of corruption cannot be trusted) and the scan
  continues with the next segment.

Pure stdlib on purpose: subprocess durability tests and the webhook
hot path pay no torch import for corpus persistence.
"""

from __future__ import annotations

import json
import os
import queue
import struct
import threading
import weakref
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

SEGMENT_MAGIC = b"GKCAPSEG"
_FRAME = struct.Struct(">II")            # payload length, crc32(payload)
_SEG_PREFIX = "capture-"
_SEG_SUFFIX = ".seg"

_OPEN_LOGS: "weakref.WeakSet[CaptureLog]" = weakref.WeakSet()


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def segment_bytes() -> int:
    return max(4096, _env_int("GATEKEEPER_CAPTURE_SEGMENT_BYTES", 1 << 20))


def queue_max() -> int:
    return max(1, _env_int("GATEKEEPER_CAPTURE_QUEUE", 4096))


def keep_segments() -> int:
    return max(1, _env_int("GATEKEEPER_CAPTURE_KEEP", 64))


def _seg_name(seq: int) -> str:
    return f"{_SEG_PREFIX}{seq:08d}{_SEG_SUFFIX}"


def _seg_seq(name: str) -> Optional[int]:
    if not (name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX)):
        return None
    try:
        return int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
    except ValueError:
        return None


def list_segments(directory: str) -> List[Tuple[int, str]]:
    """(seq, path) pairs for every segment in *directory*, ordered."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        seq = _seg_seq(name)
        if seq is not None:
            out.append((seq, os.path.join(directory, name)))
    out.sort()
    return out


def _scan_segment(path: str) -> Tuple[List[bytes], int, bool, bool]:
    """Scan one segment file.

    Returns ``(payloads, valid_bytes, torn, corrupt)`` where
    *valid_bytes* is the offset up to which frames are intact (the
    truncation point for append recovery), *torn* flags an incomplete
    trailing frame and *corrupt* a CRC/magic failure.
    """
    payloads: List[bytes] = []
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return [], 0, False, True
    if data[:len(SEGMENT_MAGIC)] != SEGMENT_MAGIC:
        return [], 0, False, True
    off = len(SEGMENT_MAGIC)
    while off < len(data):
        if off + _FRAME.size > len(data):
            return payloads, off, True, False
        length, crc = _FRAME.unpack_from(data, off)
        start = off + _FRAME.size
        end = start + length
        if end > len(data):
            return payloads, off, True, False
        payload = data[start:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return payloads, off, False, True
        payloads.append(payload)
        off = end
    return payloads, off, False, False


class CaptureLog:
    """Append-only segmented record log with a non-blocking front end.

    ``append`` never blocks the caller: records go onto a bounded
    queue and a lazily-started daemon thread writes them out.  Use
    ``flush`` to wait for everything enqueued so far to be committed
    (tests and readers in the same process need that barrier; the
    admission path never calls it).
    """

    def __init__(self, directory: str, *,
                 segment_max: Optional[int] = None,
                 queue_size: Optional[int] = None,
                 keep: Optional[int] = None):
        self.directory = directory
        self._segment_max = segment_max or segment_bytes()
        self._keep = keep or keep_segments()
        self._queue: "queue.Queue[Optional[bytes]]" = queue.Queue(
            maxsize=queue_size or queue_max())
        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        self._writer: Optional[threading.Thread] = None
        self._file = None
        self._file_bytes = 0
        self._seq = 0
        self._closed = False
        # -- stats (all monotonic; read via .stats()) -------------------
        self._enqueued = 0
        self._written = 0
        self._dropped = 0
        self._rotations = 0
        self._torn_truncated = 0
        self._write_errors = 0
        _OPEN_LOGS.add(self)

    # -- admission-path front end --------------------------------------

    def append(self, record: Dict[str, Any]) -> bool:
        """Enqueue *record*; False (and a counted drop) when full."""
        if self._closed:
            return False
        try:
            payload = json.dumps(record, sort_keys=True,
                                 default=str).encode("utf-8")
        except (TypeError, ValueError):
            with self._lock:
                self._dropped += 1
            return False
        try:
            self._queue.put_nowait(payload)
        except queue.Full:
            with self._lock:
                self._dropped += 1
            return False
        with self._lock:
            self._enqueued += 1
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._drain, name="gk-capture-writer",
                    daemon=True)
                self._writer.start()
        return True

    # -- writer thread --------------------------------------------------

    def _open_for_append(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        segs = list_segments(self.directory)
        if segs:
            seq, path = segs[-1]
            _p, valid, torn, corrupt = _scan_segment(path)
            if corrupt:
                self._seq = seq + 1
            else:
                if torn:
                    with open(path, "r+b") as f:
                        f.truncate(valid)
                    self._torn_truncated += 1
                size = os.path.getsize(path)
                if size < self._segment_max:
                    self._file = open(path, "ab")
                    self._file_bytes = size
                    self._seq = seq
                    return
                self._seq = seq + 1
        self._start_segment()

    def _start_segment(self) -> None:
        path = os.path.join(self.directory, _seg_name(self._seq))
        self._file = open(path, "wb")
        self._file.write(SEGMENT_MAGIC)
        self._file_bytes = len(SEGMENT_MAGIC)

    def _rotate(self) -> None:
        self._file.flush()
        self._file.close()
        self._seq += 1
        self._rotations += 1
        self._start_segment()
        self._prune()

    def _prune(self) -> None:
        segs = list_segments(self.directory)
        for _seq, path in segs[:-self._keep]:
            try:
                os.remove(path)
            except OSError:
                pass

    def _drain(self) -> None:
        while True:
            try:
                payload = self._queue.get(timeout=0.2)
            except queue.Empty:
                if self._closed:
                    return
                with self._lock:
                    if self._file is not None:
                        try:
                            self._file.flush()
                        except OSError:
                            pass
                continue
            if payload is None:                      # close() sentinel
                return
            with self._lock:
                try:
                    if self._file is None:
                        self._open_for_append()
                    frame = _FRAME.pack(
                        len(payload),
                        zlib.crc32(payload) & 0xFFFFFFFF)
                    self._file.write(frame + payload)
                    self._file_bytes += len(frame) + len(payload)
                    if self._queue.empty():
                        self._file.flush()
                    if self._file_bytes >= self._segment_max:
                        self._rotate()
                except OSError:
                    self._write_errors += 1
                self._written += 1
                self._done.notify_all()

    # -- barriers --------------------------------------------------------

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until everything enqueued before the call is on disk."""
        with self._lock:
            target = self._enqueued
            deadline = None
            while self._written + self._dropped_since(target) < target:
                if not self._done.wait(timeout=0.2):
                    if deadline is None:
                        deadline = timeout
                    deadline -= 0.2
                    if deadline <= 0:
                        return False
            if self._file is not None:
                try:
                    self._file.flush()
                    os.fsync(self._file.fileno())
                except (OSError, ValueError):
                    pass
        return True

    def _dropped_since(self, _target: int) -> int:
        # Drops never enter _enqueued, so the flush ledger only needs
        # written-vs-enqueued; kept as a hook for future accounting.
        return 0

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        self._closed = True
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        with self._lock:
            if self._file is not None:
                try:
                    self._file.flush()
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    # -- introspection ----------------------------------------------------

    def stats(self) -> Dict[str, int]:
        with self._lock:
            segs = len(list_segments(self.directory))
            return {
                "enqueued": self._enqueued,
                "written": self._written,
                "dropped": self._dropped,
                "segments": segs,
                "rotations": self._rotations,
                "torn_truncated": self._torn_truncated,
                "write_errors": self._write_errors,
                "queue_depth": self._queue.qsize(),
            }


# -- readers ---------------------------------------------------------------


def scan(directory: str) -> Tuple[List[Dict[str, Any]], Dict[str, int]]:
    """Replay every committed record under *directory*, in order.

    Returns ``(records, report)`` where report counts segments read,
    records decoded, corrupt segments rejected by CRC/magic, and torn
    tail frames skipped.
    """
    records: List[Dict[str, Any]] = []
    report = {"segments": 0, "records": 0, "corrupt_segments": 0,
              "torn_tails": 0, "undecodable": 0}
    for _seq, path in list_segments(directory):
        report["segments"] += 1
        payloads, _valid, torn, corrupt = _scan_segment(path)
        if corrupt:
            report["corrupt_segments"] += 1
        if torn:
            report["torn_tails"] += 1
        for payload in payloads:
            try:
                records.append(json.loads(payload.decode("utf-8")))
                report["records"] += 1
            except (ValueError, UnicodeDecodeError):
                report["undecodable"] += 1
    return records, report


def read_records(directory: str) -> Iterator[Dict[str, Any]]:
    """Iterator form of :func:`scan` (drops the report)."""
    recs, _report = scan(directory)
    return iter(recs)


def flush_all(directory: Optional[str] = None) -> None:
    """Best-effort flush of every open log (optionally dir-filtered).

    Same-process write-then-read flows (tests, probe fixtures, bench
    corpus seeding) call this before scanning segments.
    """
    for log in list(_OPEN_LOGS):
        if directory is not None and log.directory != directory:
            continue
        try:
            log.flush(timeout=5.0)
        except Exception:
            pass
