# Copied from gatekeeper_tpu/analysis/__init__.py for the PyTorch port.
"""Install-time static analysis: the Stage-1 template vetter.

Only the stages the audit slice runs are ported: :mod:`.vetter` walks
the parsed Rego AST and emits :class:`.diagnostics.Diagnostic` records;
:mod:`.purity` is the impure-builtin gate shared with the closure
compiler.  The policy-set, translation-validation and cost-model
stages of the JAX package are not part of the port yet.
"""

from gatekeeper_tpu_torch.analysis.diagnostics import (   # noqa: F401
    ERROR, WARNING, Diagnostic, errors, format_all, has_errors,
)
from gatekeeper_tpu_torch.analysis.purity import (        # noqa: F401
    is_impure_builtin, is_impure_call,
)
from gatekeeper_tpu_torch.analysis.vetter import vet_module        # noqa: F401
