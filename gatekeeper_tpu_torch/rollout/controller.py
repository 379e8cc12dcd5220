# Copied from gatekeeper_tpu/rollout/controller.py for the PyTorch port.
"""Evidence-gated policy promotion.

The promotion state machine drives one candidate policy set through
the existing evidence machinery and only graduates on recorded proof:

    candidate ── shadow sweep (whatif.ShadowSession, live ∪ candidate
       │         in one audit; the what-if diff is the evidence)
       ▼
    shadow ──── corpus replay through the device micro-batcher
       │        (whatif.replay_admissions_batched), bit-identical to
       │        the scalar replay oracle; ANY unexpected denial — an
       │        event recorded allowed that the candidate would deny —
       │        rejects the rollout with the offending events attached
       ▼
    replayed ── enforcementAction rewritten on the live constraints,
       │        one rung per soak window:
       ▼
    dryrun → warn → deny                    (graduated enforcement)

plus two off-ramps: ``rejected`` (an evidence gate failed; nothing was
ever installed) and ``rolled_back`` (a brownout escalation ≥ SHED_WARN
landed during the rollout window — the OverloadController listener
restores the pre-rollout policy set atomically and flight-records the
evidence).  The reference persists every transition as its ninth
snapshot tier ("ro") so a warm restart resumes mid-rollout; the port has
no snapshot tier yet (ROADMAP A8): ``_persist`` keeps nothing, and
``resume`` refuses to run under ``GATEKEEPER_SNAPSHOT_DIR``.

The candidate client of the replay gate and the standalone parity
oracle run on a ``TorchDriver`` on the live driver's device.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import threading
import time
from typing import Any, Dict, List, Optional

PROMOTION_RUNGS = ("candidate", "shadow", "replayed",
                   "dryrun", "warn", "deny")
ENFORCE_RUNGS = ("dryrun", "warn", "deny")
REJECTED = "rejected"
ROLLED_BACK = "rolled_back"

# gauge encoding: rung index, or a negative terminal code
_GAUGE = {**{r: i for i, r in enumerate(PROMOTION_RUNGS)},
          REJECTED: -1, ROLLED_BACK: -2}

# brownout rung at/above which an in-flight rollout must abort
ROLLBACK_BROWNOUT_RUNG = 2           # webhook.overload.SHED_WARN


def live_enforcement_fingerprint(client) -> str:
    """sha256[:16] over the client's full installed policy set (every
    template kind + every constraint doc).  Recorded before the first
    rung install; equality after a rollback is the machine-checkable
    "live enforcement identical to the pre-rollout state" proof."""
    rows: List[Any] = [sorted(client.templates)]
    for kind in sorted(client.constraints):
        for name in sorted(client.constraints[kind]):
            rows.append((kind, name,
                         json.dumps(client.constraints[kind][name],
                                    sort_keys=True, default=str)))
    return hashlib.sha256(
        json.dumps(rows, default=str).encode("utf-8")).hexdigest()[:16]


@dataclasses.dataclass
class ReplayGate:
    """The shadow→replayed evidence bundle."""
    replayed: int
    skipped: int
    skipped_oversize: int
    unexpected_denials: List[dict]
    scalar_digest: str
    batched_digest: str
    scalar_wall_s: float
    batched_wall_s: float

    @property
    def parity(self) -> bool:
        return self.scalar_digest == self.batched_digest

    @property
    def passed(self) -> bool:
        return (self.replayed > 0 and self.parity
                and not self.unexpected_denials)


class PromotionController:
    """Drives one candidate policy set through the promotion rungs.

    ``client`` is the LIVE client whose enforcement the rollout
    rewrites; ``templates``/``constraints`` are the candidate docs.
    ``events`` (or ``corpus_dir`` via the flight recorder's capture
    log) is the recorded admission evidence the replay gate consumes.
    ``baseline_templates`` should carry the live doc for any candidate
    template kind whose SOURCE the candidate changes; without it an
    already-live kind is assumed unchanged (the constraint-only
    promotion case) and rollback restores the candidate's doc for it.
    """

    def __init__(self, client, templates: List[dict],
                 constraints: List[dict], *, name: str = "candidate",
                 events: Optional[List[dict]] = None,
                 corpus_dir: Optional[str] = None,
                 overload=None, baseline_templates: Optional[List[dict]] = None,
                 soak_s: float = 0.0, limit_per_constraint: int = 20,
                 batch_size: int = 256, verify_parity: bool = False,
                 metrics=None):
        from gatekeeper_tpu_torch.utils.metrics import Metrics
        self.client = client
        self.templates = templates
        self.constraints = constraints
        self.name = name
        self.events = events
        self.corpus_dir = corpus_dir
        self.soak_s = soak_s
        self.limit = limit_per_constraint
        self.batch_size = batch_size
        self.verify_parity = verify_parity
        self.metrics = metrics if metrics is not None else Metrics()
        self._lock = threading.RLock()
        self.state = "candidate"
        self.installed: Optional[str] = None
        self.evidence: Dict[str, dict] = {}
        self.history: List[dict] = []
        self.pre_fingerprint: Optional[str] = None
        self._prior_constraints: Dict[tuple, Optional[dict]] = {}
        self._prior_templates: Dict[str, tuple] = {}  # kind -> (prior, cand)
        self._baseline_templates = {
            self._tmpl_kind(d): d for d in (baseline_templates or [])}
        self._gauge()
        if overload is not None:
            self.attach_overload(overload)

    @staticmethod
    def _tmpl_kind(doc: dict) -> str:
        return doc["spec"]["crd"]["spec"]["names"]["kind"]

    # -- observability ----------------------------------------------------

    def _gauge(self) -> None:
        self.metrics.gauge(
            "rollout_rung",
            "promotion rung (0 candidate .. 5 deny; -1 rejected, "
            "-2 rolled_back)").set(_GAUGE.get(self.state, -3))

    def _to(self, new_state: str, reason: str = "", **ev) -> str:
        with self._lock:
            frm = self.state
            self.state = new_state
            self.history.append({"frm": frm, "to": new_state,
                                 "reason": reason, "ts": time.time()})
            if ev:
                self.evidence.setdefault(new_state, {}).update(ev)
            self._gauge()
            self.metrics.counter(
                "rollout_transitions", "promotion state changes",
                to=new_state).inc()
            from gatekeeper_tpu_torch.obs.flightrecorder import record_event
            record_event("rollout_state", name=self.name, frm=frm,
                         to=new_state, reason=reason)
            self._persist()
            return new_state

    # -- persistence (the reference's ninth snapshot tier)

    def _persist(self) -> None:
        """Keeps nothing: the snapshot tier the reference writes each
        transition to is not ported (ROADMAP A8)."""

    def resume(self) -> bool:
        """Warm-restart entry.  Without a snapshot directory there is
        nothing to resume from: False, as the reference returns on a
        snapshot miss.  With ``GATEKEEPER_SNAPSHOT_DIR`` set it raises
        ``ClientError``: resuming from the snapshot tier waits for
        ROADMAP A8."""
        import os
        if os.environ.get("GATEKEEPER_SNAPSHOT_DIR"):
            from gatekeeper_tpu_torch.errors import ClientError
            raise ClientError(
                "PromotionController.resume: GATEKEEPER_SNAPSHOT_DIR is "
                "set, but the rollout's snapshot tier is not yet ported to "
                "gatekeeper_tpu_torch (ROADMAP A8, the snapshot tier)")
        return False

    # -- the state machine -------------------------------------------------

    def step(self) -> str:
        """Advance one rung (or land on a terminal state)."""
        from gatekeeper_tpu_torch.obs.trace import get_tracer
        with self._lock:
            s = self.state
            if s in (REJECTED, ROLLED_BACK, "deny"):
                return s
            nxt = {"candidate": self._do_shadow,
                   "shadow": self._do_replay,
                   "replayed": lambda: self._do_install("dryrun"),
                   "dryrun": lambda: self._do_install("warn"),
                   "warn": lambda: self._do_install("deny")}[s]
            with get_tracer().span(f"rollout:{s}", cat="rollout",
                                   rollout=self.name):
                return nxt()

    def run(self, target_rung: str = "deny") -> str:
        """Step to ``target_rung``, soaking ``soak_s`` per enforcement
        rung (the window the brownout listener can abort in)."""
        from gatekeeper_tpu_torch.obs.trace import get_tracer
        with get_tracer().span("rollout", cat="rollout",
                               rollout=self.name, target=target_rung):
            while True:
                before = self.state
                if before in (REJECTED, ROLLED_BACK) or \
                        before == target_rung:
                    return self.state
                self.step()
                if self.state in ENFORCE_RUNGS and \
                        self.state != target_rung and self.soak_s > 0:
                    deadline = time.monotonic() + self.soak_s
                    while time.monotonic() < deadline:
                        if self.state in (REJECTED, ROLLED_BACK):
                            break
                        time.sleep(min(0.005, self.soak_s))
                if self.state == before:        # no progress: stop
                    return self.state

    # -- rung 1: shadow sweep ----------------------------------------------

    def _shadow_tag(self) -> str:
        tag = "".join(ch for ch in self.name if ch.isalnum()) or "promo"
        return f"promo{tag}"[:32]

    def _do_shadow(self) -> str:
        from gatekeeper_tpu_torch.whatif import ShadowSession
        sess = ShadowSession(self.client, tag=self._shadow_tag())
        try:
            sess.stage(self.templates, self.constraints)
        except Exception as e:      # noqa: BLE001 — evidence, not a crash
            return self._to(REJECTED, reason="shadow_stage_failed",
                            error=str(e))
        # unlike the reference, an error of the sweep itself (a kernel's
        # among them) is raised, not recorded as a rejection
        try:
            rep = sess.sweep(limit_per_constraint=self.limit)
        finally:
            sess.unstage()
        ev = {"added": len(rep.added), "cleared": len(rep.cleared),
              "shadow_digest": rep.shadow_digest,
              "live_digest": rep.live_digest,
              "by_constraint": rep.by_constraint,
              "dedup": rep.dedup}
        if self.verify_parity:
            ev["oracle_parity"] = self._shadow_oracle_parity(rep)
            if not ev["oracle_parity"]:
                return self._to(REJECTED, reason="shadow_parity", **ev)
        return self._to("shadow", reason="shadow_swept", **ev)

    def _shadow_oracle_parity(self, rep) -> bool:
        from gatekeeper_tpu_torch.whatif import (
            standalone_candidate_verdicts, verdict_digest)
        state = self._store_state()
        if state is None:
            return True
        oracle = standalone_candidate_verdicts(
            self.templates, self.constraints, state, self.limit,
            device=self._device())
        return rep.shadow_digest == verdict_digest(oracle)

    def _store_state(self):
        """The live store's ``snapshot_state()`` payload, or None for a
        driver without a columnar table (a remote driver)."""
        state_of = getattr(self.client.driver, "_state", None)
        if state_of is None:
            return None
        target = next(iter(self.client.targets))
        return state_of(target).table.snapshot_state()

    def _device(self):
        """The live driver's device, where the candidate client and the
        parity oracle run (None, the card, for a driver without one)."""
        return getattr(self.client.driver, "device", None)

    # -- rung 2: batched corpus replay ---------------------------------------

    def _load_events(self) -> List[dict]:
        if self.events is not None:
            return self.events
        if self.corpus_dir:
            from gatekeeper_tpu_torch.obs.flightrecorder import \
                load_admission_corpus
            return load_admission_corpus(self.corpus_dir)
        return []

    def _candidate_client(self):
        """A fresh standalone client with ONLY the candidate set over
        the live store contents — the replay subject.  Mixing staged
        shadow kinds into the live client would conflate live and
        candidate verdicts in the webhook partition."""
        from gatekeeper_tpu_torch.client.client import Backend
        from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
        from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
        driver = TorchDriver(device=self._device())
        handler = K8sValidationTarget()
        client = Backend(driver).new_client([handler])
        for doc in self.templates:
            client.add_template(doc)
        for doc in self.constraints:
            client.add_constraint(doc)
        state = self._store_state()
        if state is not None:
            driver.adopt_store(handler.name, state)
        return client

    def _do_replay(self) -> str:
        from gatekeeper_tpu_torch.whatif.replay import (
            replay_admissions, replay_admissions_batched)
        events = self._load_events()
        cand = self._candidate_client()
        scalar = replay_admissions(events, cand)
        batched = replay_admissions_batched(events, cand,
                                            batch_size=self.batch_size)
        unexpected = [m for m in batched.mismatches
                      if m.get("recorded_allowed") is True
                      and m.get("replayed_allowed") is False]
        gate = ReplayGate(
            replayed=batched.replayed, skipped=batched.skipped,
            skipped_oversize=batched.skipped_oversize,
            unexpected_denials=unexpected,
            scalar_digest=scalar.digest, batched_digest=batched.digest,
            scalar_wall_s=scalar.wall_s, batched_wall_s=batched.wall_s)
        ev = {"replayed": gate.replayed, "skipped": gate.skipped,
              "skipped_oversize": gate.skipped_oversize,
              "unexpected_denials": len(unexpected),
              "scalar_digest": gate.scalar_digest,
              "batched_digest": gate.batched_digest,
              "parity": gate.parity,
              "scalar_wall_s": round(gate.scalar_wall_s, 4),
              "batched_wall_s": round(gate.batched_wall_s, 4)}
        self.evidence.setdefault("replay_gate", {}).update(ev)
        if gate.replayed == 0:
            return self._to(REJECTED, reason="no_evidence", **ev)
        if not gate.parity:
            return self._to(REJECTED, reason="replay_parity", **ev)
        if unexpected:
            return self._to(REJECTED, reason="unexpected_denials",
                            offending=unexpected[:16], **ev)
        return self._to("replayed", reason="0 unexpected denials", **ev)

    # -- rungs 3..5: graduated enforcement installs ---------------------------

    def _apply_rung(self, rung: str, snapshot_prior: bool = True) -> None:
        """Rewrite enforcementAction on the candidate constraints in
        the LIVE client (add_constraint/add_template replace by key).
        Called under self._lock."""
        if snapshot_prior and self.installed is None:
            self.pre_fingerprint = live_enforcement_fingerprint(
                self.client)
            for doc in self.templates:
                kind = self._tmpl_kind(doc)
                if kind in self._baseline_templates:
                    prior = self._baseline_templates[kind]
                elif kind in self.client.templates:
                    # live kind with no explicit baseline doc: treat the
                    # candidate doc as unchanged (the constraint-only
                    # promotion case); a real template change must pass
                    # baseline_templates to restore the prior source
                    prior = doc
                else:
                    prior = None
                self._prior_templates[kind] = (prior, doc)
            for doc in self.constraints:
                kind = doc["kind"]
                name = doc["metadata"]["name"]
                prior = (self.client.constraints.get(kind) or {}).get(name)
                self._prior_constraints[(kind, name)] = \
                    copy.deepcopy(prior) if prior is not None else None
        for doc in self.templates:
            self.client.add_template(doc)
        for doc in self.constraints:
            d = copy.deepcopy(doc)
            d.setdefault("spec", {})["enforcementAction"] = rung
            self.client.add_constraint(d)

    def _do_install(self, rung: str) -> str:
        try:
            self._apply_rung(rung)
        except Exception as e:      # noqa: BLE001
            self.rollback(reason=f"install_failed:{e}")
            return self.state
        self.installed = rung
        return self._to(rung, reason="evidence_gated_install",
                        enforcement=rung)

    # -- rollback ---------------------------------------------------------

    def attach_overload(self, controller) -> None:
        """Wire the brownout ladder (webhook/overload.py): any
        escalation to rung ≥ SHED_WARN while a rung is installed aborts
        the rollout and restores the pre-rollout policy set."""
        controller.add_listener(self._on_brownout)

    def _on_brownout(self, frm: int, to: int, pressure: float) -> None:
        if to < ROLLBACK_BROWNOUT_RUNG:
            return
        self.rollback(reason=f"brownout_rung_{to}",
                      brownout={"frm": frm, "to": to,
                                "pressure": round(pressure, 3)})

    def rollback(self, reason: str = "", **ev) -> bool:
        """Atomically restore the pre-rollout policy set.  No-op unless
        an enforcement rung is installed (nothing to undo before
        ``dryrun``).  Returns True when a rollback happened."""
        with self._lock:
            if self.installed is None or self.state == ROLLED_BACK:
                return False
            from_rung = self.installed
            # 1. templates that existed pre-rollout: restore their docs
            for kind, (prior, _cand) in self._prior_templates.items():
                if prior is not None:
                    self.client.add_template(prior)
            # 2. constraints: restore prior docs, remove net-new ones
            for (kind, name), prior in self._prior_constraints.items():
                try:
                    if prior is not None:
                        self.client.add_constraint(copy.deepcopy(prior))
                    else:
                        self.client.remove_constraint(
                            {"kind": kind, "metadata": {"name": name}})
                except Exception:   # noqa: BLE001 — keep restoring
                    pass
            # 3. templates that were net-new: remove them last (their
            #    constraints are already gone)
            for kind, (prior, cand) in self._prior_templates.items():
                if prior is None:
                    try:
                        self.client.remove_template(cand)
                    except Exception:   # noqa: BLE001
                        pass
            self.installed = None
            restored = (live_enforcement_fingerprint(self.client)
                        == self.pre_fingerprint)
            from gatekeeper_tpu_torch.obs.flightrecorder import \
                get_flight_recorder
            get_flight_recorder().dump(reason="rollout_rollback")
            self._to(ROLLED_BACK, reason=reason or "rollback",
                     from_rung=from_rung, restored=restored, **ev)
            return True
