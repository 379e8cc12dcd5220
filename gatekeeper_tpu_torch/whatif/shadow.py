# Copied from gatekeeper_tpu/whatif/shadow.py for the PyTorch port.
"""Shadow policy-set installs: candidate and live in ONE device sweep.

A candidate set's template/constraint docs are staged into the live
client under version-tagged kinds (analysis/policyset.shadow_kind) —
the constraint kind is only the registry key, never a match criterion,
so the shadow constraints select exactly the resources their live
twins do.  One forced full audit then covers live ∪ shadow kinds: the
driver's dedup plan is built over the union, and because canonical
conjunct digests hash program structure + folded params (not kind
names), every conjunct the candidate shares with the live version is
evaluated once and fanned out to both; a shadow kind whose program and
bindings equal its live twin's takes the twin's K1 and K2 result
(``TorchDriver._twin_handle``) instead of launching its own.

The report carries the would-be-denied diff (``added`` violations the
candidate would newly reject, ``cleared`` ones it would stop
rejecting) and a parity digest over the candidate's normalized
verdicts, bit-identical to installing the candidate standalone
(`standalone_candidate_verdicts` is that oracle).
"""

from __future__ import annotations

import copy
import dataclasses

from gatekeeper_tpu_torch.analysis.policyset import (cross_version_groups,
                                                     is_shadow_kind,
                                                     shadow_kind,
                                                     split_shadow_kind)


def shadow_template_doc(doc: dict, tag: str) -> dict:
    """Deep-copied template doc re-keyed under the shadow version tag
    (crd names.kind + metadata.name; the rego body is untouched, so
    its lowering — and its conjunct digests — match the live twin)."""
    d = copy.deepcopy(doc)
    names = d["spec"]["crd"]["spec"]["names"]
    sk = shadow_kind(names["kind"], tag)
    names["kind"] = sk
    d.setdefault("metadata", {})["name"] = sk.lower()
    return d


def shadow_constraint_doc(doc: dict, tag: str) -> dict:
    """Deep-copied constraint doc re-pointed at the shadow template
    kind.  metadata.name is unchanged — constraint names are already
    namespaced per kind, and keeping them stable is what makes the
    live-vs-shadow diff line up per constraint."""
    d = copy.deepcopy(doc)
    d["kind"] = shadow_kind(d["kind"], tag)
    return d


@dataclasses.dataclass
class ShadowReport:
    tag: str
    live: list[tuple]            # normalized verdicts, live set
    shadow: list[tuple]          # normalized verdicts, candidate set
    added: list[tuple]           # would-be-denied: candidate only
    cleared: list[tuple]         # would-be-cleared: live only
    live_digest: str
    shadow_digest: str
    dedup: dict                  # cross-version sharing accounting
    by_constraint: dict          # cname -> {"added": n, "cleared": n}


def _diff_key(v: tuple) -> tuple:
    # drop the msg (v[-1]): a param tweak that only rewords the message
    # is not a verdict change
    return v[:-1]


class ShadowSession:
    """Stage -> sweep -> diff -> unstage, usable as a context manager
    (the candidate set never outlives the session unless promoted)."""

    def __init__(self, client, tag: str = "candidate"):
        if not tag:
            raise ValueError("shadow tag must be non-empty")
        self.client = client
        self.tag = tag
        self._templates: list[dict] = []
        self._constraints: list[dict] = []

    # -- staging --------------------------------------------------------

    def stage(self, templates: list[dict], constraints: list[dict]) -> None:
        """Install the candidate docs under the version tag.  Any
        install failure unwinds the partial stage before re-raising —
        a half-staged candidate must never linger beside the live set."""
        try:
            for doc in templates:
                sd = shadow_template_doc(doc, self.tag)
                self.client.add_template(sd)
                self._templates.append(sd)
            for doc in constraints:
                sd = shadow_constraint_doc(doc, self.tag)
                self.client.add_constraint(sd)
                self._constraints.append(sd)
        except Exception:
            self.unstage()
            raise

    def unstage(self) -> None:
        """Remove every staged doc, constraints first (removing a doc
        that is already gone is a no-op).  Unlike the reference, which
        swallows removal errors, the first one is raised once every doc
        has been tried."""
        first = None
        for remove, docs in ((self.client.remove_constraint,
                              self._constraints),
                             (self.client.remove_template, self._templates)):
            for doc in docs:
                try:
                    remove(doc)
                except Exception as e:      # keep unstaging, then raise
                    first = first or e
        self._templates = []
        self._constraints = []
        if first is not None:
            raise first

    def __enter__(self) -> "ShadowSession":
        return self

    def __exit__(self, *exc) -> None:
        self.unstage()

    # -- the combined sweep --------------------------------------------

    def sweep(self, limit_per_constraint: int = 20,
              full: bool = True) -> ShadowReport:
        """One audit over live ∪ shadow kinds, partitioned back into
        the two policy-set versions.  With a per-constraint cap the
        diff is over the capped verdict sets (same cap both sides)."""
        from gatekeeper_tpu_torch.whatif import (normalize_result,
                                                 verdict_digest)
        resp = self.client.audit(limit_per_constraint=limit_per_constraint,
                                 full=full)
        live: list[tuple] = []
        shadow: list[tuple] = []
        for r in resp.results():
            con_kind = (r.constraint or {}).get("kind", "")
            _base, tag = split_shadow_kind(con_kind)
            v = normalize_result(r)
            if tag == self.tag:
                shadow.append(v)
            elif tag is None:
                live.append(v)
        live.sort()
        shadow.sort()
        live_keys = {_diff_key(v) for v in live}
        shadow_keys = {_diff_key(v) for v in shadow}
        added = sorted(v for v in shadow if _diff_key(v) not in live_keys)
        cleared = sorted(v for v in live if _diff_key(v) not in shadow_keys)
        by_con: dict = {}
        for v in added:
            by_con.setdefault(v[1], {"added": 0, "cleared": 0})["added"] += 1
        for v in cleared:
            by_con.setdefault(v[1], {"added": 0, "cleared": 0})["cleared"] += 1
        return ShadowReport(
            tag=self.tag, live=live, shadow=shadow,
            added=added, cleared=cleared,
            live_digest=verdict_digest(live),
            shadow_digest=verdict_digest(shadow),
            dedup=self._dedup_stats(),
            by_constraint=by_con)

    def _dedup_stats(self) -> dict:
        """Cross-version sharing accounting from the sweep's dedup plan
        (memoized per policy-set digest on the driver).  A driver
        without a plan (the scalar driver, GATEKEEPER_DEDUP=off)
        reports zeros."""
        memo = getattr(self.client.driver, "_dedup_plan_memo", None) or {}
        for _target, (_digest, plan) in memo.items():
            if plan is not None and any(
                    is_shadow_kind(k) for k in plan.kind_digests):
                return cross_version_groups(plan)
        return {"groups_cross_version": 0, "groups_within_version": 0,
                "sites_cross_version": 0}


def standalone_candidate_verdicts(templates: list[dict],
                                  constraints: list[dict],
                                  store_state: dict,
                                  limit_per_constraint: int = 20,
                                  device=None) -> list[tuple]:
    """The shadow parity oracle: a fresh ``TorchDriver`` on ``device``
    (the card unless the caller asks otherwise) and client with ONLY the
    candidate set (unmangled kinds) over the same store contents; the
    normalized verdicts must be bit-identical to a ShadowSession
    sweep's candidate half."""
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
    from gatekeeper_tpu_torch.whatif import normalize_results
    driver = TorchDriver(device=device)
    handler = K8sValidationTarget()
    client = Backend(driver).new_client([handler])
    for doc in templates:
        client.add_template(doc)
    for doc in constraints:
        client.add_constraint(doc)
    driver.adopt_store(handler.name, store_state)
    resp = client.audit(limit_per_constraint=limit_per_constraint, full=True)
    return normalize_results(resp.results())
