# Copied from gatekeeper_tpu/whatif/replay.py for the PyTorch port.
"""Historical replay: audit a past store, re-review a recorded stream.

Two time machines over the same engine path:

- `replay_snapshot` loads a columnar-store snapshot payload
  (``ResourceTable.snapshot_state()``) as a *secondary* store under a
  fresh ``TorchDriver`` and audits it with whatever policy set you hand
  it: the live set for "what was violating last week", a candidate set
  for "what would this change have rejected last week";
  `load_historical_store` reads such a payload back from the store
  snapshot tier of a live or historical snapshot root.
- `replay_admissions` feeds a recorded AdmissionReview corpus
  (obs/flightrecorder, GATEKEEPER_FLIGHT_ADMISSION=1) back through a
  client's review path and compares verdicts against what was
  recorded.  Under the same policy set the reproduction must be exact;
  under a candidate set the mismatch list IS the what-if answer.
"""

from __future__ import annotations

import dataclasses
import time


def load_historical_store(target: str, root: str | None = None) -> dict | None:
    """The store-tier snapshot payload for ``target``, from the live
    snapshot dir or an explicit historical ``root``; None on miss."""
    from gatekeeper_tpu_torch.resilience import snapshot as _snap
    hit = _snap.load_store(target, root=root)
    return hit[0] if hit is not None else None


@dataclasses.dataclass
class ReplayReport:
    verdicts: list[tuple]        # normalized (whatif.normalize_results)
    digest: str
    n_resources: int
    wall_s: float


def replay_snapshot(templates: list[dict], constraints: list[dict],
                    store_state: dict, limit_per_constraint: int = 20,
                    device=None) -> ReplayReport:
    """Audit a historical store state under the given policy docs, in
    a fresh ``TorchDriver`` on ``device`` (the card unless the caller
    asks otherwise; the live client and its caches are untouched)."""
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
    from gatekeeper_tpu_torch.whatif import normalize_results, verdict_digest
    t0 = time.perf_counter()
    driver = TorchDriver(device=device)
    handler = K8sValidationTarget()
    client = Backend(driver).new_client([handler])
    for doc in templates:
        client.add_template(doc)
    for doc in constraints:
        client.add_constraint(doc)
    driver.adopt_store(handler.name, store_state)
    resp = client.audit(limit_per_constraint=limit_per_constraint, full=True)
    verdicts = normalize_results(resp.results())
    return ReplayReport(
        verdicts=verdicts, digest=verdict_digest(verdicts),
        n_resources=len(store_state.get("entries", ())),
        wall_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# recorded admission streams


@dataclasses.dataclass
class StreamReplayReport:
    replayed: int
    skipped: int                 # unreplayable corpus events (errors)
    matched: int
    mismatches: list[dict]       # per-event recorded-vs-replayed delta
    wall_s: float
    skipped_oversize: int = 0    # byte-capped to the identifying envelope
    digest: str = ""             # sha256[:16] over per-event verdict rows
    batched: bool = False        # went through the device micro-batcher
    isolated_chunks: int = 0     # batched chunks re-run without bad events

    @property
    def exact(self) -> bool:
        return self.replayed > 0 and not self.mismatches


def _verdict_rows(results) -> list[tuple]:
    from gatekeeper_tpu_torch.analysis.policyset import split_shadow_kind
    rows = []
    for r in results:
        con = r.constraint or {}
        rows.append((split_shadow_kind(con.get("kind", ""))[0],
                     (con.get("metadata") or {}).get("name", ""),
                     r.enforcement_action, r.msg))
    return sorted(rows)


def _recorded_rows(event: dict) -> list[tuple]:
    from gatekeeper_tpu_torch.analysis.policyset import split_shadow_kind
    rows = []
    for v in event.get("verdicts", ()):
        rows.append((split_shadow_kind(v.get("kind") or "")[0],
                     v.get("name") or "", v.get("action") or "deny",
                     v.get("msg") or ""))
    return sorted(rows)


def _truncated(request: dict) -> bool:
    for f in ("object", "oldObject"):
        o = request.get(f)
        if isinstance(o, dict) and o.get("__truncated__"):
            return True
    return False


def _stream_digest(rows_per_event: list[list[tuple]]) -> str:
    """The replay parity currency: one digest over the ordered
    per-event verdict rows.  The scalar and batched paths must agree
    bit-for-bit, so this is computed from the same normalized rows on
    both."""
    import hashlib
    import json
    blob = json.dumps(rows_per_event, sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def _compare_event(event: dict, request: dict, results, allowed: bool,
                   mismatches: list[dict]) -> bool:
    got = _verdict_rows(results)
    want = _recorded_rows(event)
    if allowed == bool(event.get("allowed")) and got == want:
        return True
    obj = (request.get("object") or {})
    mismatches.append({
        "name": (obj.get("metadata") or {}).get("name"),
        "recorded_allowed": bool(event.get("allowed")),
        "replayed_allowed": allowed,
        "recorded": want, "replayed": got})
    return False


def replay_admissions(events: list[dict], client,
                      compare: bool = True) -> StreamReplayReport:
    """Re-review each corpus event through ``client`` and (optionally)
    compare against the recorded outcome.  Allowed/denied is recomputed
    with the webhook's enforcementAction partition (deny blocks, warn/
    dryrun admit), so a corpus recorded by the webhook reproduces
    exactly under the same policy set.  Events whose payload was
    byte-capped to the identifying envelope at record time are counted
    in ``skipped_oversize``, not guessed at."""
    t0 = time.perf_counter()
    replayed = skipped = oversize = matched = 0
    mismatches: list[dict] = []
    rows_per_event: list[list[tuple]] = []
    for event in events:
        request = event.get("request") or {}
        if _truncated(request):
            oversize += 1
            continue
        try:
            resp = client.review(request)
        except Exception as e:  # noqa: BLE001 — count, keep replaying
            skipped += 1
            mismatches.append({"request": request.get("name"),
                               "error": str(e)})
            continue
        results = resp.results()
        allowed = not any(r.enforcement_action not in ("warn", "dryrun")
                          for r in results)
        replayed += 1
        rows_per_event.append(_verdict_rows(results))
        if compare and _compare_event(event, request, results, allowed,
                                      mismatches):
            matched += 1
    return StreamReplayReport(
        replayed=replayed, skipped=skipped, matched=matched,
        mismatches=mismatches, wall_s=time.perf_counter() - t0,
        skipped_oversize=oversize,
        digest=_stream_digest(rows_per_event))


def replay_admissions_batched(events: list[dict], client,
                              compare: bool = True,
                              batch_size: int = 256
                              ) -> StreamReplayReport:
    """Batched twin of :func:`replay_admissions`: replayable events go
    through ``client.review_batch`` — the webhook's device micro-batch
    seam, one [C, B] device pass per kind when the driver is eligible
    (see torch_driver REVIEW_BATCH_MIN_EVALS) — instead of one scalar
    ``review`` per event.  Verdict comparison, accounting, and the
    stream ``digest`` are computed from the same normalized rows, so
    the report must be bit-identical to the scalar oracle's.  A chunk
    that fails wholesale is screened one event at a time through the
    scalar ``review``: the events that fail there are skipped (one
    poisoned request cannot sink its neighbours' accounting), the rest
    go through ``review_batch`` again, and the chunk counts in
    ``isolated_chunks``.  When no event of the chunk fails on its own,
    the batch's exception is raised: unlike the reference, which
    replays the whole chunk on the scalar engine, a fault of the device
    pass is never hidden behind host work."""
    t0 = time.perf_counter()
    replayed = skipped = oversize = matched = 0
    mismatches: list[dict] = []
    rows_per_event: list[list[tuple]] = []
    pending: list[dict] = []                 # events with replayable payloads
    for event in events:
        request = event.get("request") or {}
        if _truncated(request):
            oversize += 1
            continue
        pending.append(event)
    isolated = 0
    for lo in range(0, len(pending), max(1, batch_size)):
        chunk = pending[lo:lo + max(1, batch_size)]
        requests = [ev.get("request") or {} for ev in chunk]
        bad: dict[int, Exception] = {}
        try:
            resps = client.review_batch(requests)
        except Exception:
            for i, request in enumerate(requests):
                try:
                    client.review(request)
                except Exception as e:  # noqa: BLE001 — a poisoned event
                    bad[i] = e
            if not bad:
                raise
            isolated += 1
            good = [i for i in range(len(requests)) if i not in bad]
            again = client.review_batch([requests[i] for i in good]) \
                if good else []
            resps = [None] * len(requests)
            for i, resp in zip(good, again):
                resps[i] = resp
        for i, event in enumerate(chunk):
            request = requests[i]
            if i in bad:
                skipped += 1
                mismatches.append({"request": request.get("name"),
                                   "error": str(bad[i])})
                continue
            results = resps[i].results()
            allowed = not any(
                r.enforcement_action not in ("warn", "dryrun")
                for r in results)
            replayed += 1
            rows_per_event.append(_verdict_rows(results))
            if compare and _compare_event(event, request, results,
                                          allowed, mismatches):
                matched += 1
    return StreamReplayReport(
        replayed=replayed, skipped=skipped, matched=matched,
        mismatches=mismatches, wall_s=time.perf_counter() - t0,
        skipped_oversize=oversize,
        digest=_stream_digest(rows_per_event), batched=True,
        isolated_chunks=isolated)
