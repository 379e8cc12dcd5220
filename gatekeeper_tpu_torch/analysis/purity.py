# Copied from gatekeeper_tpu/analysis/purity.py for the PyTorch port.
"""The single impure-builtin gate.

Both the shareable-review escape analysis (rego/closures.py) and the
Stage-1 vetter need the same judgment: "does this call name reach a
builtin whose result can vary between evaluations or leak information
out of the evaluation?".  The membership set lives in
rego/builtins.py (IMPURE_BUILTINS); this helper is the one place that
interprets it, so the two call sites can't drift.
"""

from __future__ import annotations


def is_impure_builtin(name: tuple[str, ...]) -> bool:
    """True iff ``name`` is a registered impure builtin (trace,
    time.now_ns, io.jwt.decode_verify, external_data)."""
    from gatekeeper_tpu_torch.rego import builtins as bi
    return name in bi.IMPURE_BUILTINS


def is_impure_call(name: tuple[str, ...], rule_names) -> bool:
    """The closures.py judgment: a call is impurity-tainted when it
    names an impure builtin OR a user-defined rule/function (whose own
    body may be impure — the escape analysis doesn't chase the call
    graph, it over-approximates)."""
    return (is_impure_builtin(name)
            or (len(name) == 1 and name[0] in rule_names))
