# Copied from gatekeeper_tpu/analysis/compilesurface.py for the PyTorch port.
"""Stage-7 compile-surface certifier: the finite set of launch signatures.

Stages 4-6 certify that a lowered program computes the right verdicts,
which columns it reads, and how it shards.  None of them bounds the
*compile surface*: the set of padded shape signatures the device
programs can ever be launched with.  On the card every new signature of
a program is a new K1 launch plan and, the first time, a Triton compile
of a new variant — and a signature arriving mid-traffic (shape drift
past a pad bucket, an oversized review batch) is a compile storm that
blows the p99 budget.

This stage closes that hole statically.  An abstract interpreter over
the lowered spec's binding requests maps every bound array dim to a
pad-geometry *generator* via :func:`ir.prep.binding_dim_classes`:

  * ``r`` / ``c`` — the ``bucket()`` power-of-two ladders of
    ``audit_pads`` (resource and constraint axes);
  * ``t`` — the ``interner_bucket()`` headroom ladder (distinct
    strings);
  * ``e`` — the element-axis ``bucket(·, minimum=2)`` ladder;
  * ``static`` — install-time constants (constraint key counts, DFA
    ``[n_states, 256]`` transition tables, the interner byte width):
    exactly one value per installed policy set.

Each input-driven axis is a finite ladder only because deployment caps
bound it (``GATEKEEPER_CS_MAX_*``); the composition of the ladders is
the :class:`CompileSurface` certificate — the complete signature set,
with ``n_signatures`` = the product of the ladder lengths (times the
devpages delta-width rungs for kinds with a resource axis).  A binding
whose dims cannot be mapped to a generator makes the surface
*unbounded*: the certificate is rejected with a
``compile_surface_unbounded`` diagnostic and the kind is excluded from
AOT precompilation and retrace gating.

Certificates are consumed in three places:

  * ``TorchDriver.precompile()`` launches K1 once over every certified
    kind's bindings at the current geometry at install / warm restart
    (``executor.prewarm_audit_exec``, the ingest warm's launch), so the
    first sweep compiles nothing; the ``cs`` snapshot tier records both
    the certificates and the precompiled geometry stamp, so a warm
    restart issues zero precompile launches;
  * the webhook micro-batcher shrinks deadline-pressed batches along
    the certified r-ladder rungs instead of halving blindly (halving
    50 -> 25 keeps the same padded signature; stepping 50 -> 32 -> 16
    actually changes the launch the cost model priced);
  * a retrace sentinel at the executor's first launch of a signature
    (``ProgramExecutor._guard_miss``, before any compile) counts any
    launch whose signature falls outside the certificate
    (``retrace_uncertified_total``), flight-records it, and under
    ``GATEKEEPER_COMPILE_SURFACE=strict`` refuses the launch with
    :class:`UncertifiedRetrace` before Triton compiles anything.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

from gatekeeper_tpu_torch.errors import EvalError
from gatekeeper_tpu_torch.utils.log import logger

log = logger("compilesurface")

CS_VERSION = "cs-1"

# fresh analyses this process (mirrors shardplan.analyses_run): the
# restart smoke asserts a warm process re-analyzes nothing
analyses_run = 0

# precompile launches issued by TorchDriver.precompile() this process
# (one per certified kind at the current geometry): a warm restart whose
# geometry stamp is in the cs tier must issue zero (its variants come
# back from Triton's disk cache on first launch instead of a startup
# compile storm)
precompiles_run = 0

# dispatches whose signature fell outside the installed certificates
# (module-wide twin of the driver's retrace_uncertified_total metric)
uncertified_total = 0

_memo: dict[str, "CompileSurface"] = {}

# kind -> most recently published certificate
surfaces: dict[str, "CompileSurface"] = {}

# kind -> human reason, for templates whose surface is unbounded.
unbounded: dict[str, str] = {}

# program cache_key -> bounded certificate, for the dispatch-time
# sentinel (only bounded surfaces are guardable: an unbounded one
# makes no membership claim)
_registry: dict = {}


def mode() -> str:
    """off | warn | strict.  ``warn`` (default) certifies at install,
    drives the precompile, and *counts* uncertified launches but serves
    them (the launch compiles its variant); ``strict``
    additionally refuses any dispatch outside the certificate
    (:class:`UncertifiedRetrace`); ``off`` disables the stage."""
    return os.environ.get("GATEKEEPER_COMPILE_SURFACE",
                          "warn").strip().lower()


class UncertifiedRetrace(EvalError):
    """strict-mode refusal: a launch demanded a signature outside the
    installed CompileSurface certificate.  Serving it would compile a
    fresh kernel variant mid-traffic — the exact compile storm the
    certificate exists to rule out."""


# deployment caps that make the input-driven ladders finite.  A store,
# constraint set, interner, or element list past its cap would demand a
# signature outside every certificate — which is the point: the
# operator states the geometry the fleet is sized for, and anything
# beyond it is a certifiable capacity event, not a silent retrace.
_CAP_DEFAULTS = {
    "r": ("GATEKEEPER_CS_MAX_ROWS", 1 << 22),
    "c": ("GATEKEEPER_CS_MAX_CONSTRAINTS", 1 << 12),
    "t": ("GATEKEEPER_CS_MAX_TABLE", 1 << 22),
    "e": ("GATEKEEPER_CS_MAX_ELEMS", 1 << 16),
}

# canonical ladder minimums (ir/prep.py padding formulas: audit_pads
# bucket minimums, interner_bucket floor, element bucket minimum=2)
_LADDER_MIN = {"r": 8, "c": 4, "t": 8, "e": 2}


def _cap(cls: str) -> int:
    name, dflt = _CAP_DEFAULTS[cls]
    try:
        return int(os.environ.get(name, dflt))
    except ValueError:
        return dflt


def _caps_sig() -> tuple:
    return tuple((cls, _cap(cls)) for cls in sorted(_CAP_DEFAULTS))


@dataclasses.dataclass(frozen=True)
class CompileSurface:
    """One template's certified compile surface.

    ``bindings`` maps every statically enumerable bound-array name to
    its per-dim generator classes; ``axes`` lists the input-driven axis
    classes actually present with their (minimum, cap, rung-count)
    ladders; ``n_signatures`` is the full composed surface size
    (product of ladder lengths x the devpages delta-width rungs when a
    resource axis is present).  ``bounded=False`` certificates carry
    the ``compile_surface_unbounded`` reason and are never registered
    with the dispatch sentinel."""

    kind: str
    digest: str
    bounded: bool
    reason: str | None
    bindings: tuple          # ((name, (cls, ...)), ...)
    axes: tuple              # ((cls, minimum, cap, n_rungs), ...)
    n_signatures: int
    delta_rungs: int         # devpages delta-width pow2 rungs (>= 256)
    scalar_pin: bool = False
    version: str = CS_VERSION


def surface_digest(lowered) -> str:
    """Certificate key: program cache_key + pad-geometry version +
    ladder caps.  A geometry change (PAD_GEOMETRY_VERSION bump, a cap
    re-size) invalidates by key mismatch — persisted certificates are
    never consulted across a geometry change."""
    from gatekeeper_tpu_torch.analysis import footprint
    from gatekeeper_tpu_torch.ir import prep as _prep
    return hashlib.sha256(repr((
        CS_VERSION, _prep.PAD_GEOMETRY_VERSION, _caps_sig(),
        repr(lowered.program.cache_key()),
        repr(footprint._spec_sig(lowered.spec)),
    )).encode()).hexdigest()


def _spec_binding_names(spec) -> list[str]:
    """Every bound-array name the prepped bindings for this spec can
    carry, including the per-request derived variants and the framework
    gates — the static enumeration the per-dim generators compose
    over."""
    names: list[str] = ["__alive__"]
    if getattr(spec, "cvalid_fns", ()):
        names.append("__cvalid__")
    # match/rank gates are installed per constraint set at dispatch;
    # the certificate always accounts for them (their axes are the
    # same c/r ladders either way)
    names += ["__match__", "__rank__", "__pagetable__"]
    names += [r.name for r in getattr(spec, "r_cols", ())]
    names += [r.name for r in getattr(spec, "e_cols", ())]
    names += [r.name for r in getattr(spec, "tables", ())]
    for r in getattr(spec, "ptables", ()):
        names += [f"{r.name}.any", f"{r.name}.all", f"{r.name}.vmap"]
    for r in getattr(spec, "csets", ()):
        names += [r.name, f"{r.name}.vmap"]
    names += [r.name for r in getattr(spec, "cvals", ())]
    names += [r.name for r in getattr(spec, "membs", ())]
    names += [r.name for r in getattr(spec, "elem_keys", ())]
    for r in getattr(spec, "keyed_vals", ()):
        names += [f"{r.name}.kv", f"{r.name}.sel"]
    names += [r.name for r in getattr(spec, "inv_joins", ())]
    for r in getattr(spec, "dfas", ()):
        names += [f"{r.name}.trans", f"{r.name}.accept", f"{r.name}.xv"]
    if getattr(spec, "dfas", ()):
        names += ["__strbytes__", "__strdfaok__"]
    return names


def _delta_rung_count() -> int:
    """Power-of-two rungs of the devpages delta-width ladder
    (``delta_bucket(n) * DELTA_K_LADDER`` in enforce/devpages.py),
    bounded by the full mask size under the r/c caps."""
    from gatekeeper_tpu_torch.enforce import devpages as _dvp
    k_cap = _cap("r") * _cap("c") * _dvp.DELTA_K_LADDER
    n = 0
    k = _dvp.DELTA_K_MIN
    while k <= k_cap:
        n += 1
        k <<= 1
    return n


def analyze(kind: str, lowered) -> CompileSurface:
    """The Stage-7 abstract interpretation: enumerate the spec's bound
    arrays, map every dim to a pad-geometry generator, and compose the
    finite signature ladder — or reject as unbounded."""
    from gatekeeper_tpu_torch.ir import prep as _prep
    digest = surface_digest(lowered)
    if kind in _test_unbounded_kinds():
        return CompileSurface(
            kind=kind, digest=digest, bounded=False,
            reason="deliberately unbounded (test seam)",
            bindings=(), axes=(), n_signatures=0, delta_rungs=0)
    bindings: list[tuple] = []
    present: set[str] = set()
    for name in _spec_binding_names(lowered.spec):
        try:
            classes = _prep.binding_dim_classes(name)
        except ValueError as e:
            return CompileSurface(
                kind=kind, digest=digest, bounded=False,
                reason=f"compile_surface_unbounded: binding {name!r} "
                       f"has no pad-geometry generator ({e})",
                bindings=tuple(bindings), axes=(), n_signatures=0,
                delta_rungs=0)
        bindings.append((name, classes))
        present.update(c for c in classes if c != "static")
    axes = []
    n_signatures = 1
    for cls in sorted(present):
        ladder = _prep.bucket_ladder(_LADDER_MIN[cls], _cap(cls))
        if not ladder:
            return CompileSurface(
                kind=kind, digest=digest, bounded=False,
                reason=f"compile_surface_unbounded: axis {cls!r} cap "
                       f"{_cap(cls)} below its pad minimum",
                bindings=tuple(bindings), axes=(), n_signatures=0,
                delta_rungs=0)
        axes.append((cls, _LADDER_MIN[cls], _cap(cls), len(ladder)))
        n_signatures *= len(ladder)
    delta_rungs = _delta_rung_count() if "r" in present else 0
    # each certified geometry can be entered as a full-mask signature
    # or through one of the devpages delta-width variants
    n_signatures *= 1 + delta_rungs
    return CompileSurface(
        kind=kind, digest=digest, bounded=True, reason=None,
        bindings=tuple(bindings), axes=tuple(axes),
        n_signatures=n_signatures, delta_rungs=delta_rungs)


def scalar_surface(kind: str) -> CompileSurface:
    """The trivial certificate of a scalar-pinned template: no device
    program, an empty compile surface — vacuously finite."""
    return CompileSurface(
        kind=kind, digest=f"scalar:{kind}", bounded=True,
        reason=None, bindings=(), axes=(), n_signatures=0,
        delta_rungs=0, scalar_pin=True)


def _test_unbounded_kinds() -> frozenset:
    raw = os.environ.get("GATEKEEPER_CS_TEST_UNBOUNDED", "")
    return frozenset(k for k in raw.split(",") if k)


# ---------------------------------------------------------------------------
# memoized entry point


def certify(kind: str, compiled, lowered) -> CompileSurface:
    """Memoized/snapshot-backed entry point the engine and probe use.
    Certificates persist in the snapshot "cs" tier, so a warm restart
    re-runs zero analyses.  The TEST_UNBOUNDED seam bypasses memo and
    snapshot — a deliberately unbounded surface must reach the caller,
    not a cached honest one."""
    global analyses_run
    digest = surface_digest(lowered)
    seam = kind in _test_unbounded_kinds()
    if not seam:
        cached = _memo.get(digest)
        if cached is not None:
            _publish(kind, cached, lowered)
            return cached
        from gatekeeper_tpu_torch.resilience import snapshot as _snap
        hit = _snap.load_compilesurface(digest)   # 1-tuple or None
        if hit is not None and isinstance(hit[0], CompileSurface) \
                and hit[0].version == CS_VERSION:
            _memo[digest] = hit[0]
            _publish(kind, hit[0], lowered)
            return hit[0]

    cert = analyze(kind, lowered)
    analyses_run += 1
    if not seam and cert.bounded:
        _memo[digest] = cert
        from gatekeeper_tpu_torch.resilience import snapshot as _snap
        _snap.save_compilesurface(digest, cert)
    _publish(kind, cert, lowered)
    return cert


def _publish(kind: str, cert: CompileSurface, lowered) -> None:
    surfaces[kind] = cert
    if cert.bounded:
        unbounded.pop(kind, None)
        if lowered is not None and not cert.scalar_pin:
            _registry[lowered.program.cache_key()] = cert
    else:
        unbounded[kind] = cert.reason or "compile_surface_unbounded"


def surface_for(kind: str) -> CompileSurface | None:
    """The most recently published certificate for a kind, or None
    when not yet analyzed."""
    return surfaces.get(kind)


def unbounded_for(kind: str) -> str | None:
    """The unbounded-surface reason for a kind, or None when the
    surface is certified finite (or not yet analyzed)."""
    return unbounded.get(kind)


# ---------------------------------------------------------------------------
# dispatch-time sentinel


def _pow2_member(v: int, cap: int) -> bool:
    return 1 <= v <= cap and (v & (v - 1)) == 0


def dispatch_certified(program, arrays, delta_k: int | None = None) -> bool:
    """Membership of one launch's signature in the installed
    certificate.  Called by the executor ONLY on the first launch of a
    signature (before any compile), never on the steady path.  Programs without a bounded
    certificate (dedup-rewritten subprograms, shared-column twins, the
    reduce kernels) are not guarded — True.  Membership is checked
    against the *live* caps, permissively at the ladder floor: any
    power of two under the cap is a certified rung (smaller-than-
    minimum pads cannot demand more signatures than the ladder)."""
    cert = _registry.get(program.cache_key())
    if cert is None or not cert.bounded:
        return True
    from gatekeeper_tpu_torch.ir import prep as _prep
    for name in sorted(arrays):
        try:
            classes = _prep.binding_dim_classes(name)
        except ValueError:
            return False
        shape = tuple(arrays[name].shape)
        if len(shape) != len(classes):
            return False
        for v, cls in zip(shape, classes):
            if cls == "static":
                continue
            if not _pow2_member(int(v), _cap(cls)):
                return False
    if delta_k is not None:
        from gatekeeper_tpu_torch.enforce import devpages as _dvp
        if not _pow2_member(int(delta_k),
                            _cap("r") * _cap("c") * _dvp.DELTA_K_LADDER) \
                or delta_k < _dvp.DELTA_K_MIN:
            return False
    return True
