# Copied from gatekeeper_tpu/analysis/__init__.py for the PyTorch port.
"""Install-time static analysis: the template vetter's two stages.

Stage 1 (:mod:`.vetter`) walks the parsed Rego AST; Stage 2
(:mod:`.ir_verifier`) validates lowered device programs against their
PrepSpec before a kernel runs them.  Both emit
:class:`.diagnostics.Diagnostic` records; :mod:`.purity` is the
impure-builtin gate shared with the closure compiler.  The later stages
live in their own modules: translation validation (Stage 4,
:mod:`.transval` over :mod:`.smallmodel`'s worlds, evaluated on the
driver's device), dependency footprints (Stage 5, :mod:`.footprint`),
partition plans (Stage 6, :mod:`.shardplan`), compile surfaces (Stage
7, :mod:`.compilesurface`) and memory surfaces (Stage 8,
:mod:`.memsurface`), with :mod:`.policyset` and :mod:`.costmodel` for
the installed set.
"""

from gatekeeper_tpu_torch.analysis.diagnostics import (   # noqa: F401
    ERROR, WARNING, Diagnostic, errors, format_all, has_errors,
)
from gatekeeper_tpu_torch.analysis.purity import (        # noqa: F401
    is_impure_builtin, is_impure_call,
)
from gatekeeper_tpu_torch.analysis.vetter import vet_module        # noqa: F401
from gatekeeper_tpu_torch.analysis.ir_verifier import (   # noqa: F401
    verify_program,
)
