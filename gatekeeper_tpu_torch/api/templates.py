# Copied from gatekeeper_tpu/api/templates.py for the PyTorch port.
"""ConstraintTemplate API types + compilation.

The typed shape follows the reference CRD
(vendor/.../constraint/pkg/apis/templates/v1alpha1/constrainttemplate_types.go:27-98):
``spec.crd.spec.names.kind``, ``spec.crd.spec.validation.openAPIV3Schema``
(the parameters schema), ``spec.targets[]{target, rego}``.

`compile_target_rego` performs the hygiene checks the framework enforces
(vendor rego_helpers.go): a `violation` partial-set rule must exist
(requireRules, :125-157), imports are banned (:23), and `data` access is
restricted to `data.inventory` (:84-119).  It returns a CompiledTemplate
carrying the parsed module + oracle interpreter; the jax driver attaches
its lowered IR to the same artifact.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from gatekeeper_tpu_torch.errors import CompileError, ClientError
from gatekeeper_tpu_torch.rego.ast_nodes import Module, Ref, Scalar, Var, walk_terms
from gatekeeper_tpu_torch.rego.interp import Interpreter
from gatekeeper_tpu_torch.rego.parser import parse_module


@dataclasses.dataclass
class TemplateTarget:
    target: str
    rego: str


@dataclasses.dataclass
class ConstraintTemplate:
    name: str                       # metadata.name; must equal lower(kind)
    kind: str                       # spec.crd.spec.names.kind
    parameters_schema: dict | None  # spec.crd.spec.validation.openAPIV3Schema
    targets: list[TemplateTarget]

    @staticmethod
    def from_dict(doc: dict) -> "ConstraintTemplate":
        try:
            spec = doc["spec"]
            names = spec["crd"]["spec"]["names"]
            kind = names["kind"]
        except (KeyError, TypeError) as e:
            raise ClientError(f"malformed ConstraintTemplate: missing {e}")
        validation = (spec["crd"]["spec"].get("validation") or {})
        schema = validation.get("openAPIV3Schema")
        targets = [TemplateTarget(target=t["target"], rego=t["rego"])
                   for t in spec.get("targets", [])]
        name = (doc.get("metadata") or {}).get("name", "")
        return ConstraintTemplate(name=name, kind=kind,
                                  parameters_schema=schema, targets=targets)


@dataclasses.dataclass
class CompiledTemplate:
    kind: str
    target: str
    source: str
    module: Module
    # vectorized program attached by the jax driver's lowerer; None = the
    # scalar fallback handles this template entirely
    vectorized: Any = None
    # does any rule read data.inventory?  If not, drivers skip building
    # the frozen inventory document for message evaluation
    uses_inventory: bool = False
    # lazily-built scalar interpreter (see the `interp` property)
    _interp: "Interpreter | None" = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def interp(self) -> Interpreter:
        """The scalar oracle over this module, built on first use: a
        warm-restarted process that serves from snapshotted lowered IR
        never pays interpreter construction at startup, and a cold one
        pays it where it is first needed (lowering or scalar eval).  A
        racing double-build is benign — construction is a pure function
        of the module and the last assignment wins."""
        if self._interp is None:
            self._interp = Interpreter(self.module)
        return self._interp

    def violations(self, input_doc, data_doc, tracer=None) -> list:
        return self.interp.query_set("violation", input_doc, data_doc, tracer=tracer)


def check_rego_conformance(module: Module) -> None:
    """The framework's template hygiene rules (rego_helpers.go:14-157)."""
    if module.imports:
        raise CompileError("template Rego must not contain imports "
                           "(rego_helpers.go:23 bans them)")
    violation_rules = [r for r in module.rules_named("violation")]
    if not violation_rules:
        raise CompileError("template must define a `violation` rule "
                           "(requireRules, rego_helpers.go:125)")
    for r in violation_rules:
        if r.kind != "partial_set":
            raise CompileError("`violation` must be a partial-set rule "
                               "violation[result] { ... }")

    errs: list[str] = []

    def check_data_ref(t):
        if isinstance(t, Ref) and isinstance(t.base, Var) and t.base.name == "data":
            if not t.path:
                errs.append("bare `data` reference is not allowed")
                return
            head = t.path[0]
            if not (isinstance(head, Scalar) and head.value == "inventory"):
                shown = head.value if isinstance(head, Scalar) else "<dynamic>"
                errs.append(f"invalid data reference data.{shown}: templates may "
                            "only access data.inventory (rego_helpers.go:84)")

    for rule in module.rules:
        walk_terms(rule, check_data_ref)
    if errs:
        raise CompileError("; ".join(sorted(set(errs))))


def rebuild_from_module(kind: str, target: str, rego_src: str,
                        module: Module,
                        uses_inventory: bool) -> CompiledTemplate:
    """Rebuild a CompiledTemplate from a snapshotted parsed Module
    (resilience/snapshot.py warm-restart path).  The Interpreter is
    never snapshotted — its side tables are id()-keyed over the live
    AST objects and must not cross a process boundary; the lazy
    `interp` property reconstructs it on first use."""
    return CompiledTemplate(kind=kind, target=target, source=rego_src,
                            module=module, uses_inventory=uses_inventory)


def compile_target_rego(kind: str, target: str, rego_src: str) -> CompiledTemplate:
    module = parse_module(rego_src)  # ParseError propagates with its location
    check_rego_conformance(module)
    uses_inv = [False]

    def spot_data(t):
        if isinstance(t, Ref) and isinstance(t.base, Var) and t.base.name == "data":
            uses_inv[0] = True

    for rule in module.rules:
        walk_terms(rule, spot_data)
    return CompiledTemplate(kind=kind, target=target, source=rego_src,
                            module=module, uses_inventory=uses_inv[0])
