"""The flight recorder's disk half in the port: the durable capture log
(tests/test_rollout.py::TestCaptureLog's seven flows on
``gatekeeper_tpu_torch.rollout.capture``), the ring's dump and its size
(tests/test_obs.py::TestFlightRecorder's four flows), the admission
corpus (the corpus flows of tests/test_whatif.py, whose records must
equal the reference recorder's for the same requests, timestamps
aside), and a fired fault dumping the ring.
"""

import json
import os
import subprocess
import sys
import threading

import pytest

from gatekeeper_tpu.client.types import Result as JResult
from gatekeeper_tpu.obs import flightrecorder as ref_fr

from gatekeeper_tpu_torch.client.types import Result
from gatekeeper_tpu_torch.obs import flightrecorder as fr
from gatekeeper_tpu_torch.obs.flightrecorder import FlightRecorder
from gatekeeper_tpu_torch.obs.trace import get_tracer
from gatekeeper_tpu_torch.resilience import faults
from gatekeeper_tpu_torch.rollout import capture as cap

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestCaptureLog:
    def test_round_trip_preserves_order(self, tmp_path):
        d = str(tmp_path)
        log = cap.CaptureLog(d)
        for i in range(25):
            assert log.append({"i": i})
        assert log.flush()
        recs, rep = cap.scan(d)
        assert [r["i"] for r in recs] == list(range(25))
        assert rep["records"] == 25
        assert rep["corrupt_segments"] == rep["torn_tails"] == 0
        log.close()

    def test_rotation_seals_and_prunes(self, tmp_path):
        d = str(tmp_path)
        log = cap.CaptureLog(d, segment_max=512, keep=3)
        for i in range(60):
            log.append({"i": i, "pad": "x" * 40})
        assert log.flush()
        st = log.stats()
        assert st["rotations"] >= 3
        assert 0 < st["segments"] <= 3
        recs, _rep = cap.scan(d)
        idx = [r["i"] for r in recs]
        assert idx == list(range(idx[0], 60))
        log.close()

    def test_torn_tail_truncated_on_reopen(self, tmp_path):
        d = str(tmp_path)
        log = cap.CaptureLog(d)
        for i in range(10):
            log.append({"i": i})
        log.close()
        path = cap.list_segments(d)[-1][1]
        with open(path, "ab") as f:
            f.write(cap._FRAME.pack(9999, 0)[:6])     # torn frame header
        recs, rep = cap.scan(d)
        assert rep["torn_tails"] == 1
        assert [r["i"] for r in recs] == list(range(10))
        log2 = cap.CaptureLog(d)
        assert log2.append({"i": 10})
        assert log2.flush()
        assert log2.stats()["torn_truncated"] == 1
        recs, rep = cap.scan(d)
        assert [r["i"] for r in recs] == list(range(11))
        assert rep["torn_tails"] == 0
        log2.close()

    def test_crc_corruption_rejects_segment_remainder(self, tmp_path):
        d = str(tmp_path)
        log = cap.CaptureLog(d, segment_max=512)
        for i in range(40):
            log.append({"i": i, "pad": "x" * 40})
        log.close()
        segs = cap.list_segments(d)
        assert len(segs) >= 3
        path0 = segs[0][1]
        data = bytearray(open(path0, "rb").read())
        data[len(cap.SEGMENT_MAGIC) + cap._FRAME.size] ^= 0xFF
        with open(path0, "wb") as f:
            f.write(bytes(data))
        recs, rep = cap.scan(d)
        assert rep["corrupt_segments"] == 1
        idx = [r["i"] for r in recs]
        assert idx and idx[0] > 0
        assert idx == list(range(idx[0], 40))

    def test_bounded_queue_drops_counted_never_blocks(self, tmp_path):
        d = str(tmp_path)
        log = cap.CaptureLog(d, queue_size=4)
        log._writer = threading.current_thread()   # stall: no drain yet
        results = [log.append({"i": i}) for i in range(10)]
        assert results == [True] * 4 + [False] * 6
        st = log.stats()
        assert st["enqueued"] == 4 and st["dropped"] == 6
        log._writer = threading.Thread(target=log._drain, daemon=True)
        log._writer.start()
        assert log.flush()
        recs, _rep = cap.scan(d)
        assert [r["i"] for r in recs] == [0, 1, 2, 3]
        log.close()

    def test_cross_process_reader_continuity(self, tmp_path):
        """Two writer processes in sequence, the second the reference's
        writer: the segments are one format, so the second resumes the
        first's sequence and one reader sees every record in order."""
        d = str(tmp_path)
        child = (
            "import sys\n"
            "sys.path.insert(0, sys.argv[3])\n"
            "from {mod} import CaptureLog\n"
            "log = CaptureLog(sys.argv[1], segment_max=4096)\n"
            "start = int(sys.argv[2])\n"
            "for i in range(start, start + 25):\n"
            "    assert log.append({{'i': i}})\n"
            "log.close()\n")
        for start, mod in ((0, "gatekeeper_tpu_torch.rollout.capture"),
                           (25, "gatekeeper_tpu.rollout.capture")):
            subprocess.run([sys.executable, "-c", child.format(mod=mod), d,
                            str(start), _REPO], check=True, timeout=60)
        recs, rep = cap.scan(d)
        assert [r["i"] for r in recs] == list(range(50))
        assert rep["corrupt_segments"] == rep["torn_tails"] == 0

    def test_append_after_close_is_refused(self, tmp_path):
        log = cap.CaptureLog(str(tmp_path))
        log.append({"i": 0})
        log.close()
        assert log.append({"i": 1}) is False


class TestFlightRecorder:
    def test_ring_is_bounded(self, monkeypatch):
        rec = FlightRecorder(ring=8)
        for i in range(40):
            rec.record("tick", i=i)
        assert len(rec) == 8
        assert [e["i"] for e in rec.snapshot()] == list(range(32, 40))
        # the default size comes from GATEKEEPER_FLIGHT_RING
        monkeypatch.setenv("GATEKEEPER_FLIGHT_RING", "3")
        rec = FlightRecorder()
        for i in range(5):
            rec.record("tick", i=i)
        assert [e["i"] for e in rec.snapshot()] == [2, 3, 4]

    def test_record_attaches_active_trace(self):
        rec = FlightRecorder(ring=8)
        with get_tracer().span("flightspan") as sp:
            rec.record("probe_result", ok=True)
        assert rec.snapshot()[-1]["trace"] == sp.trace_id

    def test_dump_structure_and_prune(self, monkeypatch, tmp_path):
        monkeypatch.setenv("GATEKEEPER_FLIGHT_DIR", str(tmp_path))
        monkeypatch.setenv("GATEKEEPER_FLIGHT_KEEP", "3")
        rec = FlightRecorder(ring=16)
        rec.record("breaker_flip", frm="closed", to="open")
        with get_tracer().span("dumpspan"):
            paths = [rec.dump(f"test:{i}", extra={"i": i})
                     for i in range(5)]
        assert all(paths)
        files = sorted(os.listdir(tmp_path))
        assert len(files) == 3
        with open(tmp_path / files[-1]) as f:
            doc = json.load(f)
        assert doc["reason"] == "test:4" and doc["extra"] == {"i": 4}
        assert doc["pid"] == os.getpid()
        assert doc["events"][-1]["type"] == "breaker_flip"
        assert "dumpspan" in {e["name"] for e in doc["trace"]["traceEvents"]}

    def test_dump_failure_returns_none(self, monkeypatch, tmp_path):
        bad = tmp_path / "file-not-dir"
        bad.write_text("x")
        monkeypatch.setenv("GATEKEEPER_FLIGHT_DIR", str(bad))
        assert FlightRecorder(ring=4).dump("nope") is None


def test_a_fired_fault_dumps_the_ring(monkeypatch, tmp_path):
    monkeypatch.setenv("GATEKEEPER_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("GATEKEEPER_FAULT", "watch_gap")
    faults.reset_for_tests()
    try:
        assert faults.take("watch_gap") is True
        assert faults.take("watch_gap") is False
    finally:
        faults.reset_for_tests()
    (dump,) = list(tmp_path.glob("flight-*.json"))
    doc = json.loads(dump.read_text())
    assert doc["reason"] == "fault:watch_gap"
    assert doc["events"][-1]["type"] == "fault_trip"
    assert doc["events"][-1]["fault"] == "watch_gap"


# ----------------------------------------------------------------------
# the admission corpus: equal to the reference recorder's records


def _both(monkeypatch, tmp_path):
    monkeypatch.setenv("GATEKEEPER_FLIGHT_ADMISSION", "1")
    return {"port": (fr, tmp_path / "port"), "ref": (ref_fr, tmp_path / "ref")}


def _requests():
    out = []
    for i in range(12):
        out.append({"uid": f"u{i}", "operation": "CREATE",
                    "kind": {"kind": "Pod"}, "name": f"p{i}",
                    "object": {"metadata": {"name": f"p{i}",
                                            "managedFields": [{"x": 1}],
                                            "labels": {"pad": "x" * 64}},
                               "spec": {"token": "t", "image": "nginx"}}})
    out.append({"uid": "big", "operation": "UPDATE",
                "kind": {"kind": "ConfigMap"}, "name": "big",
                "object": {"kind": "ConfigMap",
                           "metadata": {"name": "big", "namespace": "ns"},
                           "data": {"blob": "x" * 10000}},
                "oldObject": {"kind": "Secret", "metadata": {"name": "s"},
                              "data": {"k": "dmFsdWU="}}})
    return out


def test_corpus_records_equal_the_reference(monkeypatch, tmp_path):
    """The same admissions through the port's and the reference's
    record_admission read back as equal records, timestamps aside:
    redaction, the byte cap, verdicts and warnings."""
    read = {}
    for name, (mod, d) in _both(monkeypatch, tmp_path).items():
        monkeypatch.setenv("GATEKEEPER_FLIGHT_DIR", str(d))
        result = Result if name == "port" else JResult
        rec = mod.FlightRecorder(ring=8)
        for i, req in enumerate(_requests()):
            v = result(msg=f"no {i}", constraint={
                "kind": "K8sFoo", "metadata": {"name": f"c{i % 3}"}},
                enforcement_action=["deny", "warn", "dryrun"][i % 3])
            rec.record_admission(req, bool(i % 2), verdicts=[v],
                                 warnings=[f"[warn by c{i % 3}] no"])
        read[name] = mod.load_admission_corpus(str(d))
        rec._capture_log().close()
    for events in read.values():
        for ev in events:
            ev.pop("ts")
    assert read["port"] == read["ref"]
    assert len(read["port"]) == 13
    first = read["port"][0]["request"]["object"]
    assert first["spec"]["token"] == fr.REDACTED
    assert "managedFields" not in first["metadata"]
    assert read["port"][-1]["request"]["object"]["__truncated__"] is True
    assert read["port"][-1]["request"]["oldObject"]["data"]["k"] \
        == fr.REDACTED


def test_corpus_segments_pruned_by_keep(monkeypatch, tmp_path):
    monkeypatch.setenv("GATEKEEPER_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("GATEKEEPER_FLIGHT_ADMISSION", "1")
    monkeypatch.setenv("GATEKEEPER_CAPTURE_SEGMENT_BYTES", "4096")
    monkeypatch.setenv("GATEKEEPER_CAPTURE_KEEP", "2")
    rec = FlightRecorder(ring=8)
    for i in range(200):
        rec.record_admission(
            {"operation": "CREATE", "kind": {"kind": "Pod"},
             "object": {"metadata": {"name": f"p{i}",
                                     "labels": {"pad": "x" * 64}}}},
            True)
    log = rec._capture_log()
    assert log.flush()
    st = rec.capture_stats()
    assert st["dropped"] == 0 and st["written"] == 200
    assert st["rotations"] >= 2
    files = [f for f in os.listdir(tmp_path / "capture")
             if f.endswith(".seg")]
    assert 0 < len(files) <= 2
    log.close()


def test_corpus_off_records_the_ring_only(monkeypatch, tmp_path):
    monkeypatch.setenv("GATEKEEPER_FLIGHT_DIR", str(tmp_path))
    monkeypatch.delenv("GATEKEEPER_FLIGHT_ADMISSION", raising=False)
    rec = FlightRecorder(ring=8)
    rec.record_admission({"operation": "CREATE", "kind": {"kind": "Pod"},
                          "object": {"metadata": {"name": "p"}}}, False)
    assert rec.capture_stats() is None
    assert fr.load_admission_corpus(str(tmp_path)) == []
    (ev,) = rec.snapshot()
    assert (ev["type"], ev["name"], ev["allowed"]) == ("admission", "p",
                                                       False)


@pytest.mark.parametrize("obj", [
    {"apiVersion": "v1", "kind": "Pod",
     "metadata": {"name": "p", "managedFields": [{"x": 1}],
                  "labels": {"a": "b"}},
     "spec": {"password": "hunter2", "automountServiceAccountToken": True,
              "env": [{"name": "API_KEY", "apiKey": "k"}],
              "image": "nginx"}},
    {"kind": "Secret", "metadata": {"name": "s"},
     "data": {"anything": "dmFsdWU="}, "stringData": {"note": "plain"}},
])
def test_redact_and_cap_equal_the_reference(obj, monkeypatch):
    monkeypatch.setenv("GATEKEEPER_FLIGHT_PAYLOAD_BYTES", "120")
    assert fr.redact_payload(obj) == ref_fr.redact_payload(obj)
    assert fr.cap_payload(obj) == ref_fr.cap_payload(obj)
    assert fr.payload_byte_cap() == 120
