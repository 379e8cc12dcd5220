# Copied from gatekeeper_tpu/analysis/costmodel.py for the PyTorch port.
"""The static IR cost model: the axis walks, the cost vector, the
review-batch predictor and the devpages scatter price.

An abstract interpreter over the lowered device IR (ir/program.py) that
prices a program before it is ever launched: each node is classified by
the axes it varies over (constraints / resources / elements), the padded
cell count it materializes follows from the same shape buckets the
device uses (ir/prep.audit_pads), and op classes accumulate into a
:class:`CostVector` — gathers, compares, logical ops, arithmetic,
masked reductions, matmul flops, gather volume, host-table and
provider-table bytes, H2D footprint, and bucket/padding waste.
``units()`` collapses the vector through fixed op-class weights into a
scalar abstract cost; :func:`calibrate` fits the single seconds-per-unit
scale against measured samples (least squares through the origin), and
:func:`effective_scale` falls back to a static prior measured on the
card while no sample exists.  The driver's
``predict_review_batch_seconds`` prices an admission batch with it, and
the micro-batcher (webhook/batcher.py) shrinks a batch until the
prediction fits the tightest member deadline.

The footprint (:mod:`.footprint`) and the partition plan
(:mod:`.shardplan`) walk the nodes reachable from a program's rule
conjuncts (:func:`node_axes`, :func:`reachable_nodes`); the devpages
sweep prices the inventory join's input records with
:func:`scatter_worthwhile`.  The install-time cost budget
(:func:`budget_mode`, :func:`budget_units`) gates templates in the
policy-set vet (analysis/policyset.py ``vet_template_cost``).

Static unknowns are priced as documented upper bounds: element-axis
width and per-constraint set length default to the minimum shape
bucket (8), host-table cardinality to the padded row count (every row
distinct).  The model prices *work*, not constants: ``const``/``input``
nodes are free compute-wise and contribute only H2D bytes.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading

from gatekeeper_tpu_torch.ir.prep import audit_pads

DEFAULT_E_PAD = 8
"""Assumed element-axis bucket when the real element width is unknown
at install time (the minimum bucket ir/prep.bucket hands out)."""

DEFAULT_SET_LEN = 8
"""Assumed per-constraint id-set / key-set padded length."""

REF_ROWS = 100_000
"""Reference inventory scale for install-time pricing: templates are
budgeted at the cost they would add to a 100k-resource sweep."""

# op-class weights for the scalar abstract cost (the reference's, kept
# so the units equal its own): a gather costs several lanes' worth of
# work, fused elementwise logic is nearly free, matmul flops run at high
# throughput.
WEIGHTS = {
    "gathers": 4.0,
    "compares": 1.0,
    "logicals": 0.25,
    "arith": 1.0,
    "reductions": 1.0,
    "matmul_flops": 0.05,
}


@dataclasses.dataclass
class CostVector:
    """Per-program static cost, in padded-cell op counts by class."""

    gathers: int = 0            # table/ptable/in_cset/keyed_val cells
    compares: int = 0           # cmp cells
    logicals: int = 0           # and/or/not + rule-conjunct AND cells
    arith: int = 0              # arith cells
    reductions: int = 0         # cells consumed by any_e/all_e/count_e
    matmul_flops: int = 0       # cset_*_memb / elem_keys_missing matmul flops
    gather_volume_bytes: int = 0  # bytes moved by gathers (4B lanes)
    table_bytes: int = 0        # host lookup-table bytes shipped
    provider_tables: int = 0    # tables backed by external-data providers
    provider_table_bytes: int = 0
    h2d_bytes: int = 0          # estimated cold upload footprint
    live_cells: int = 0         # n_constraints * n_rows
    padded_cells: int = 0       # c_pad * r_pad

    def units(self) -> float:
        """Weighted scalar abstract cost (calibrate() maps it to
        seconds)."""
        return (WEIGHTS["gathers"] * self.gathers
                + WEIGHTS["compares"] * self.compares
                + WEIGHTS["logicals"] * self.logicals
                + WEIGHTS["arith"] * self.arith
                + WEIGHTS["reductions"] * self.reductions
                + WEIGHTS["matmul_flops"] * self.matmul_flops)

    def padding_waste(self) -> float:
        """Fraction of the padded [C, R] matrix that is bucket slack."""
        if not self.padded_cells:
            return 0.0
        return (self.padded_cells - self.live_cells) / self.padded_cells

    def __add__(self, other: "CostVector") -> "CostVector":
        return CostVector(**{
            f.name: getattr(self, f.name) + getattr(other, f.name)
            for f in dataclasses.fields(CostVector)})

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["units"] = round(self.units(), 1)
        d["padding_waste"] = round(self.padding_waste(), 4)
        return d


def node_axes(program) -> list[tuple[bool, bool, bool]]:
    """Per-node (c, r, e) axis dependence — which axes the node's value
    varies over.  Mirrors the broadcast semantics of the evaluator's
    ``_to3`` lattice: a node's lattice cell count is the product of the
    padded axes it depends on."""
    out: list[tuple[bool, bool, bool]] = []
    for n in program.nodes:
        arg = [out[a] for a in n.args]
        c = any(a[0] for a in arg)
        r = any(a[1] for a in arg)
        e = any(a[2] for a in arg)
        op = n.op
        if op == "const":
            ax = (False, False, False)
        elif op == "input":
            kind = n.meta[1]
            ax = {"c": (True, False, False),
                  "r": (False, True, False),
                  "e": (False, True, True)}[kind[0]]
        elif op in ("ptable_any", "ptable_all", "in_cset"):
            ax = (True, r, e)
        elif op == "keyed_val":
            ax = (True, True, False)
        elif op in ("cset_not_subset_memb", "cset_subset_memb"):
            ax = (True, True, False)
        elif op == "elem_keys_missing":
            ax = (True, True, True)
        elif op in ("any_e", "all_e", "count_e"):
            ax = (c, r, False)          # the element axis is reduced
        else:   # table / dfa_match / cmp / and / or / not / arith:
            ax = (c, r, e)          # broadcast of args
        out.append(ax)
    return out


def reachable_nodes(program) -> set[int]:
    """Node indices actually evaluated: the evaluator caches lazily, so
    only nodes reachable from rule conjuncts ever run (dead subtrees —
    e.g. those orphaned by a dedup rewrite — are free)."""
    seen: set[int] = set()
    stack = [ci for rule in program.rules for ci in rule.conjuncts]
    while stack:
        i = stack.pop()
        if i in seen or not (0 <= i < len(program.nodes)):
            continue
        seen.add(i)
        stack.extend(program.nodes[i].args)
    return seen


def _spec_h2d_bytes(spec, r_pad: int, c_pad: int, e_pad: int,
                    set_len: int) -> tuple[int, int, int, int]:
    """(h2d, table_bytes, provider_tables, provider_bytes) estimated
    from the PrepSpec request families.  Upper bounds: unary tables
    priced at one row per distinct value = r_pad."""
    h2d = r_pad * 1 + c_pad * 1            # __alive__ + __cvalid__
    h2d += c_pad * r_pad                   # __match__ gate (worst case)
    for ax, _base in spec.axes:
        h2d += r_pad * e_pad               # __elem__ presence
    for rc in spec.r_cols:
        h2d += r_pad * (5 if rc.mode in ("num", "len") else
                        4 if rc.mode in ("str", "val") else 1)
    for ec in spec.e_cols:
        h2d += r_pad * e_pad * (5 if ec.mode in ("num", "len") else
                                4 if ec.mode in ("str", "val") else 1)
    table_bytes = 0
    provider_tables = 0
    provider_bytes = 0
    for t in spec.tables:
        tb = r_pad * 5                     # .ok [T] + .v [T] at T <= r_pad
        table_bytes += tb
        if t.ext_providers:
            provider_tables += 1
            provider_bytes += tb
    dfas = getattr(spec, "dfas", ())
    if dfas:
        from gatekeeper_tpu_torch.ops.regex_dfa import MAX_DFA_STATES, cached_dfa
        h2d += r_pad * (128 + 1)      # __strbytes__ [T, W] + __strdfaok__ [T]
        for d in dfas:
            dfa = cached_dfa(d.pattern)
            n_states = len(dfa.accept) if dfa is not None else MAX_DFA_STATES
            # .trans [S, 256] int32 + .accept [S] + .xv [T <= r_pad]:
            # priced as table bytes so the install-time budget sees a
            # state-count blowup the same way it sees a huge host table
            tb = n_states * 256 * 4 + n_states + r_pad
            table_bytes += tb
    h2d += table_bytes
    for _pt in spec.ptables:
        h2d += r_pad * 4 + c_pad * (set_len + 1)
    for _cs in spec.csets:
        h2d += r_pad * 4 + c_pad * set_len
    for _cv in spec.cvals:
        h2d += c_pad * 5
    for _mb in spec.membs:
        h2d += set_len * r_pad + c_pad * set_len
    for _ek in spec.elem_keys:
        h2d += set_len * r_pad * e_pad + c_pad * set_len
    for _kv in spec.keyed_vals:
        h2d += set_len * r_pad * 4 + c_pad * 4
    for _ij in spec.inv_joins:
        h2d += r_pad
    return h2d, table_bytes, provider_tables, provider_bytes


def estimate(lowered, n_rows: int, n_constraints: int,
             e_pad: int = DEFAULT_E_PAD,
             set_len: int = DEFAULT_SET_LEN) -> CostVector:
    """Abstractly interpret one LoweredProgram at the given workload
    scale.  Shapes follow the device's own padding (audit_pads), so the
    vector prices the padded work the kernels actually do."""
    program = lowered.program
    r_pad, c_pad = audit_pads(n_rows, n_constraints)
    axes = node_axes(program)
    live = reachable_nodes(program)

    def cells(ax: tuple[bool, bool, bool]) -> int:
        c, r, e = ax
        return ((c_pad if c else 1) * (r_pad if r else 1)
                * (e_pad if e else 1))

    cv = CostVector(live_cells=n_rows * n_constraints,
                    padded_cells=r_pad * c_pad)
    for i in sorted(live):
        n = program.nodes[i]
        op = n.op
        sz = cells(axes[i])
        if op in ("table", "dfa_match", "ptable_any", "ptable_all",
                  "in_cset", "keyed_val"):
            cv.gathers += sz
            cv.gather_volume_bytes += 4 * sz
        elif op == "cmp":
            cv.compares += sz
        elif op in ("and", "or", "not"):
            cv.logicals += sz
        elif op == "arith":
            cv.arith += sz
        elif op in ("any_e", "all_e", "count_e"):
            cv.reductions += cells(axes[n.args[0]]) if n.args else sz
        elif op in ("cset_not_subset_memb", "cset_subset_memb"):
            cv.matmul_flops += 2 * c_pad * set_len * r_pad
        elif op == "elem_keys_missing":
            cv.matmul_flops += 2 * c_pad * set_len * r_pad * e_pad
    # the in-program DFA scan: each distinct dfa_match table is computed
    # once per evaluation as max_str_len transition gathers over the
    # whole interner (t_pad priced at r_pad, the same one-distinct-value
    # -per-row upper bound unary tables use)
    for _d in getattr(lowered.spec, "dfas", ()):
        cv.gathers += r_pad * 128
        cv.gather_volume_bytes += 4 * r_pad * 128
    for rule in program.rules:
        row = c_pad * r_pad * (e_pad if rule.elem_axis is not None else 1)
        cv.logicals += len(rule.conjuncts) * row   # conjunct AND chain
        cv.reductions += row                       # rule any-reduce
    (cv.h2d_bytes, cv.table_bytes, cv.provider_tables,
     cv.provider_table_bytes) = _spec_h2d_bytes(
        lowered.spec, r_pad, c_pad, e_pad, set_len)
    return cv


def calibrate(samples) -> float:
    """Least-squares-through-origin seconds-per-unit scale from
    (units, measured_seconds) samples — the one free parameter the
    learned-cost-model idea needs per deployment/transport."""
    num = 0.0
    den = 0.0
    for units, seconds in samples:
        num += units * seconds
        den += units * units
    return num / den if den else 0.0


def predict_seconds(units: float, scale: float) -> float:
    return units * scale


def scatter_worthwhile(n_changed: int, n_total: int,
                       row_bytes: int = 4,
                       dispatch_rows: int = 64) -> bool:
    """Price a row-sized scatter against a full re-upload for one
    device-resident column (the devpages churn seam).

    A scatter moves ``n_changed * row_bytes`` over H2D plus a fixed
    per-dispatch cost (index staging + scatter kernel launch, priced in
    row-equivalents); a re-upload moves ``n_total * row_bytes`` in one
    transfer.  The scatter wins while the churned fraction stays under
    ~50% after the dispatch overhead — at higher churn the dense copy's
    bandwidth beats the gather/scatter addressing."""
    if n_changed <= 0:
        return True
    if n_total <= 0:
        return False
    return (n_changed + dispatch_rows) * 2 <= n_total


# ---------------------------------------------------------------------------
# running calibration store
#
# (units, measured_device_seconds) samples fed back here close the
# predict -> measure -> recalibrate loop the Learned-Performance-Model
# paper describes.  Two windows: "review", the one effective_scale (and
# so the micro-batcher's deadline fit) reads, and "audit", which every
# forced full sweep's per-template attribution feeds
# (obs/attribution.py).  The reference feeds one window from both; the
# port keeps an audit's device seconds out of the admission price, as a
# sweep's kernels are not a review batch's wall (ROADMAP Queue C).
# Bounded windows so a scale tracks the current backend rather than
# averaging over a demotion.

_CAL_WINDOW = 256
_cal_lock = threading.Lock()
_cal_samples: dict[str, collections.deque] = {
    w: collections.deque(maxlen=_CAL_WINDOW) for w in ("review", "audit")}


def record_sample(units: float, seconds: float,
                  window: str = "review") -> None:
    """Feed one measured (units, device_seconds) calibration sample."""
    if units > 0 and seconds > 0:
        with _cal_lock:
            _cal_samples[window].append((units, seconds))


def current_scale(window: str = "review") -> float:
    """Seconds-per-unit fitted over the recent sample window (0.0
    while uncalibrated)."""
    with _cal_lock:
        samples = list(_cal_samples[window])
    return calibrate(samples)


def calibration_info(window: str = "review") -> dict:
    with _cal_lock:
        n = len(_cal_samples[window])
    return {"samples": n, "scale": current_scale(window)}


def reset_calibration() -> None:
    """Drop both sample windows (tests)."""
    with _cal_lock:
        for samples in _cal_samples.values():
            samples.clear()


# Static prior for the uncalibrated window: weighted units a review
# batch retires per second of its wall.  Measured by chip_smoke.py's
# admission phase on an NVIDIA H100 80GB HBM3 at 700 W (2026-10-18, the
# whole script from a clean checkout, 1,042 s): the review batch over
# 200 constraints (K8sRequiredLabels and K8sAllowedRepos) retired
# 8.98e5, 8.63e5, 7.74e5 and 8.69e5 units/s at 64, 256, 1,024 and 4,096
# reviews (the host's confirmation of the candidate pairs owns the
# wall; an earlier run that day: 8.9e5-1.23e6); the slowest size's rate,
# rounded down.  Deliberately conservative (slow-side): an
# over-predicting prior shrinks a deadline-pressed first batch, which
# is the safe direction; the first calibration sample replaces it
# entirely.
_PRIOR_UNITS_PER_SECOND = 7.7e5


def prior_scale() -> float:
    """Seconds-per-unit assumed before calibration
    (GATEKEEPER_COST_PRIOR_UPS overrides the units-per-second
    anchor; <=0 disables the prior)."""
    try:
        ups = float(os.environ.get("GATEKEEPER_COST_PRIOR_UPS",
                                   _PRIOR_UNITS_PER_SECOND))
    except ValueError:
        ups = _PRIOR_UNITS_PER_SECOND
    return 1.0 / ups if ups > 0 else 0.0


def effective_scale() -> float:
    """The scale predictions should actually use: the fitted
    seconds-per-unit once calibration samples exist, the static prior
    until then, so the micro-batcher's deadline shrinking has an
    opinion on the batches most likely to blow a deadline: the very
    first ones, compiling cold."""
    s = current_scale()
    return s if s > 0.0 else prior_scale()


# ---------------------------------------------------------------------------
# install-time budget gate


def budget_mode() -> str:
    """GATEKEEPER_COST_BUDGET: 'warn' (default) records a warning,
    'strict' rejects the template, 'off' disables the gate."""
    mode = os.environ.get("GATEKEEPER_COST_BUDGET", "warn")
    return mode if mode in ("warn", "strict", "off") else "warn"


def budget_units() -> float:
    """Per-template abstract-cost budget at REF_ROWS scale
    (GATEKEEPER_COST_BUDGET_UNITS).  The default admits every library
    template with ample headroom while still catching pathological
    blowups (quadratic element-axis products, runaway table fan-out)."""
    try:
        return float(os.environ.get("GATEKEEPER_COST_BUDGET_UNITS",
                                    "2e9"))
    except ValueError:
        return 2e9
