# Copied from gatekeeper_tpu/analysis/shardplan.py for the PyTorch port.
"""Stage-6 sharding certifier: static partition plans for the sweep.

Stage 5 (:mod:`.footprint`) proves *which* templates are row-local.
This stage proves *how* each lowered program partitions under a
resource-axis split: an abstract interpreter propagates a sharding
state (``row-sharded`` | ``replicated``) through every SSA value of the
lowered IR and emits a per-template :class:`PartitionPlan` certificate
naming

  * the per-node sharding states (elementwise/compare ops stay
    sharded; gathers into replicated param/provider tables stay
    sharded because only the *index* is row-partitioned; element-axis
    reductions stay per-row);
  * the named collectives the serving reduction needs (one
    ``all_reduce`` of the per-shard counts, an ``all_gather`` each of
    the capped top-k rows and scores);
  * the pad-to-multiple-of-shard-count constraints and the per-shard
    H2D layout: each binding's partition axes per
    ``ir.prep.binding_axes``.

Anything consuming a CROSS-ROW footprint (the inventory join) is
certified *ineligible* with the footprint's reason.  The port's fleet
audit (whatif/fleet.py) stacks a kind only when its plan, where
present, is eligible.

Not ported yet: ``GATEKEEPER_SHARDPLAN=strict`` executes every plan on a
simulated 2-shard mesh (multi-GPU is not part of the port); here it
raises instead of quietly running as ``warn``.  Plans persist in the
snapshot ``sp`` tier (resilience/snapshot.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

from gatekeeper_tpu_torch.errors import ClientError

SHARDPLAN_VERSION = "sp-1"

# fresh analyses this process (a memo hit re-analyzes nothing)
analyses_run = 0

_memo: dict[str, "PartitionPlan"] = {}

# kind -> most recently published plan (memoized or not)
plans: dict[str, "PartitionPlan"] = {}

# kind -> human reason, for templates whose plans are shard-ineligible
ineligible: dict[str, str] = {}

# kind -> violations from the most recent strict-mode validation (strict
# is not ported, so this stays empty; kept for the reference's surface)
violations: dict[str, list] = {}

SHARDED = "row-sharded"
REPLICATED = "replicated"

# the serving reduction over a row-sharded verdict matrix: per-shard
# counts are a partial-reduce closed by one all_reduce; the capped
# top-k needs its rows and scores gathered
_SERVING_COLLECTIVES: tuple[tuple[str, str, str], ...] = (
    ("all_reduce", "r", "violation_counts"),
    ("all_gather", "r", "topk_rows"),
    ("all_gather", "r", "topk_scores"),
)

# the mesh padding contract, stated as certificate constraints
_PAD_CONSTRAINTS: tuple[str, ...] = (
    "r_pad % r_shards == 0",
    "c_pad % c_shards == 0",
    "fill:int32=-1",
    "fill:other=0",
)

# framework bindings the prepped arrays always carry alongside the
# spec-derived ones (evaluator gating + rank order)
_FRAMEWORK_BINDINGS: tuple[str, ...] = (
    "__match__", "__alive__", "__rank__", "__cvalid__",
)

STRICT_NOT_PORTED = ("GATEKEEPER_SHARDPLAN=strict: partition-plan "
                     "validation is not yet ported (it runs the plan on a "
                     "simulated multi-device mesh)")


def mode() -> str:
    """off | warn.  ``warn`` (default) runs the static analysis at
    install; ``off`` disables analysis and plan gating.  ``strict``
    (every plan executed on a simulated mesh) is not ported: asking for
    it raises ClientError."""
    m = os.environ.get("GATEKEEPER_SHARDPLAN", "warn").strip().lower()
    if m == "strict":
        raise ClientError(STRICT_NOT_PORTED)
    return m


def reset() -> None:
    """Drop the process-global memo and published state (tests)."""
    global analyses_run
    analyses_run = 0
    _memo.clear()
    plans.clear()
    ineligible.clear()
    violations.clear()


# ---------------------------------------------------------------------------
# results


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Per-template sharding certificate under a resource-axis split.

    ``node_shardings`` records the abstract state of every reachable
    IR node; ``collectives`` the (op, axis, operand) reductions the
    serving step needs; ``padding`` the divisibility/fill constraints
    each shard's H2D layout must satisfy; ``layout`` the per-binding
    partition axes (None = replicated dim)."""

    kind: str
    digest: str
    eligible: bool
    reason: str = ""
    node_shardings: tuple[tuple[int, str], ...] = ()
    collectives: tuple[tuple[str, str, str], ...] = ()
    padding: tuple[str, ...] = ()
    layout: tuple[tuple[str, tuple], ...] = ()
    validated: bool = False
    shards_validated: int = 0
    version: str = SHARDPLAN_VERSION


# ---------------------------------------------------------------------------
# digest


def shardplan_digest(lowered) -> str:
    from gatekeeper_tpu_torch.analysis.footprint import _spec_sig
    parts = (SHARDPLAN_VERSION, repr(lowered.program.cache_key()),
             repr(_spec_sig(lowered.spec)))
    return hashlib.sha256("\x1f".join(parts).encode()).hexdigest()


# ---------------------------------------------------------------------------
# the abstract interpreter


def _cross_row_reason(kind: str, name: str, ij) -> str:
    """Prefer the footprint's published reason (put_template runs
    Stage 5 first); self-derive the identical text otherwise."""
    from gatekeeper_tpu_torch.analysis import footprint
    got = footprint.locality_for(kind)
    if got:
        return got
    return (f"inventory join {name}: ∃ other {ij.kind} with "
            f"{'.'.join(ij.inv_path)} == this {'.'.join(ij.src_path)}")


def analyze(kind: str, lowered) -> PartitionPlan:
    """Propagate the sharding lattice through the nodes reachable from
    the rule conjuncts and derive the partition plan.  Inputs take
    their binding's partition axes (``r`` present → row-sharded);
    table/ptable gathers follow their index operand (the table itself
    is replicated); element-axis reductions stay per-row; everything
    else joins its args.  No IR op reduces over ``r`` — the only
    cross-shard dependency inside a program is the inventory join,
    which makes the whole template ineligible."""
    from gatekeeper_tpu_torch.analysis.costmodel import reachable_nodes
    from gatekeeper_tpu_torch.ir.prep import binding_axes

    spec = lowered.spec
    prog = lowered.program
    by_ij = {j.name: j for j in spec.inv_joins}
    digest = shardplan_digest(lowered)

    def ineligible_plan(reason: str) -> PartitionPlan:
        return PartitionPlan(kind=kind, digest=digest, eligible=False,
                             reason=reason, padding=_PAD_CONSTRAINTS)

    # every H2D binding must resolve to partition axes, or the shard
    # layout is undefined for it
    binding_names = set(_FRAMEWORK_BINDINGS)
    for group in (spec.r_cols, spec.e_cols, spec.tables, spec.ptables,
                  spec.membs, spec.keyed_vals, spec.elem_keys,
                  spec.inv_joins, getattr(spec, "dfas", ())):
        binding_names.update(x.name for x in group)
    if getattr(spec, "dfas", ()):
        # in-program DFA framework arrays: the packed interner bytes and
        # the device-eligibility mask ride along with every dfa table
        binding_names.update(("__strbytes__", "__strdfaok__"))
    layout: list[tuple[str, tuple]] = []
    for name in sorted(binding_names):
        try:
            layout.append((name, tuple(binding_axes(name))))
        except ValueError:
            return ineligible_plan(f"unpartitionable binding {name}: "
                                   f"no known shard layout")

    sharded_by_name = {nm: "r" in axes for nm, axes in layout}
    states: dict[int, str] = {}
    shardings: list[tuple[int, str]] = []
    for i in sorted(reachable_nodes(prog)):
        n = prog.nodes[i]
        op = n.op
        if op == "const":
            st = REPLICATED
        elif op == "input":
            name, _ikind = n.meta
            ij = by_ij.get(name)
            if ij is not None:
                # the inv-join column is computed from OTHER rows: a
                # row split would hide matches living on other shards
                return ineligible_plan(_cross_row_reason(kind, name, ij))
            st = SHARDED if sharded_by_name.get(name, True) else REPLICATED
        elif op in ("keyed_val", "elem_keys_missing",
                    "cset_not_subset_memb", "cset_subset_memb"):
            # per-(constraint, row) lookups/matrices: row-partitioned
            st = SHARDED
        else:
            # table/ptable gathers follow their (row-sharded) index;
            # any_e/all_e/count_e reduce the ELEMENT axis, not r;
            # cmp/in_cset/and/or/not/arith are elementwise — all join
            st = REPLICATED
            for a in n.args:
                if states.get(a) == SHARDED:
                    st = SHARDED
                    break
        states[i] = st
        shardings.append((i, st))

    return PartitionPlan(kind=kind, digest=digest, eligible=True,
                         node_shardings=tuple(shardings),
                         collectives=_SERVING_COLLECTIVES,
                         padding=_PAD_CONSTRAINTS,
                         layout=tuple(layout))


# ---------------------------------------------------------------------------
# memoized entry point


def certify(kind: str, lowered) -> PartitionPlan:
    """Memoized entry point the engine uses: the static analysis, keyed
    by :func:`shardplan_digest` and persisted in the snapshot ``sp``
    tier, so a warm restart re-runs zero analyses."""
    global analyses_run
    digest = shardplan_digest(lowered)
    cached = _memo.get(digest)
    if cached is not None:
        _publish(kind, cached)
        return cached
    from gatekeeper_tpu_torch.resilience import snapshot as _snap
    hit = _snap.load_shardplan(digest)     # 1-tuple or None (miss)
    if hit is not None and isinstance(hit[0], PartitionPlan) \
            and hit[0].version == SHARDPLAN_VERSION:
        _memo[digest] = hit[0]
        _publish(kind, hit[0])
        return hit[0]
    plan = analyze(kind, lowered)
    analyses_run += 1
    violations.pop(kind, None)
    _memo[digest] = plan
    _snap.save_shardplan(digest, plan)
    _publish(kind, plan)
    return plan


def _publish(kind: str, plan: PartitionPlan) -> None:
    plans[kind] = plan
    if plan.eligible:
        ineligible.pop(kind, None)
    else:
        ineligible[kind] = plan.reason or "shard-ineligible"


def plan_for(kind: str) -> PartitionPlan | None:
    """The most recently published plan for a kind, or None when not
    yet analyzed."""
    return plans.get(kind)


def ineligible_for(kind: str) -> str | None:
    """The shard-ineligibility reason for a kind, or None when
    eligible (or not yet analyzed)."""
    return ineligible.get(kind)


def violations_for(kind: str) -> list:
    return violations.get(kind, [])
