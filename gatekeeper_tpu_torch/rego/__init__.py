# Copied from gatekeeper_tpu/rego/__init__.py for the PyTorch port.
"""Rego-subset front-end and scalar interpreter.

This package replaces the reference's vendored OPA front half
(``vendor/github.com/open-policy-agent/opa/{ast,topdown,rego}``) for the
subset of Rego that ConstraintTemplates use.  The scalar interpreter in
``interp.py`` is the semantics oracle: the vectorized device engine is
validated against it, and any template the lowerer cannot vectorize is
evaluated here on the host (the split is invisible to callers).
"""

from gatekeeper_tpu_torch.rego.parser import parse_module
from gatekeeper_tpu_torch.rego.interp import Interpreter

__all__ = ["parse_module", "Interpreter"]
