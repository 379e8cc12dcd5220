# Copied from gatekeeper_tpu/client/crd_helpers.py for the PyTorch port.
"""Constraint-kind CRD construction and validation.

Reference: vendor/.../constraint/pkg/client/crd_helpers.go — each template
generates a cluster-scoped CRD in group ``constraints.gatekeeper.sh``
whose spec schema combines the target's MatchSchema with the template's
parameters schema (:32-47); constraints are validated against it plus
name/kind/group/version checks (:100-125).
"""

from __future__ import annotations

import re
from typing import Any

from gatekeeper_tpu_torch.api.templates import ConstraintTemplate
from gatekeeper_tpu_torch.errors import ClientError

CONSTRAINT_GROUP = "constraints.gatekeeper.sh"
CONSTRAINT_VERSION = "v1alpha1"

_DNS1123 = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")


def crd_to_v1(doc: dict) -> dict:
    """Convert a v1beta1 CustomResourceDefinition document to the
    apiextensions v1 shape (spec.versions[] + per-version schema) —
    v1beta1 was removed in Kubernetes 1.22, so real-cluster writes go
    v1-first with this conversion."""
    spec = doc.get("spec") or {}
    schema = ((spec.get("validation") or {}).get("openAPIV3Schema")
              or {"type": "object"})
    schema = {**schema, "x-kubernetes-preserve-unknown-fields": True}
    out_spec = {k: v for k, v in spec.items()
                if k not in ("version", "validation")}
    out_spec["versions"] = [{"name": spec.get("version", "v1"),
                             "served": True, "storage": True,
                             "schema": {"openAPIV3Schema": schema}}]
    return {**doc, "apiVersion": "apiextensions.k8s.io/v1",
            "spec": out_spec}


def build_crd(template: ConstraintTemplate, match_schema: dict) -> dict:
    if not template.kind:
        raise ClientError("template has no CRD kind")
    if template.name != template.kind.lower():
        raise ClientError(
            f"template name {template.name!r} must equal lowercase of CRD kind "
            f"{template.kind!r} (crd_helpers.go name validation)")
    plural = template.kind.lower()
    spec_schema: dict = {
        "type": "object",
        "properties": {
            "match": match_schema,
        },
    }
    if isinstance(template.parameters_schema, dict):
        spec_schema["properties"]["parameters"] = template.parameters_schema
    return {
        "apiVersion": "apiextensions.k8s.io/v1beta1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{plural}.{CONSTRAINT_GROUP}"},
        "spec": {
            "group": CONSTRAINT_GROUP,
            "version": CONSTRAINT_VERSION,
            "names": {"kind": template.kind, "plural": plural,
                      "listKind": template.kind + "List",
                      "singular": template.kind.lower()},
            "scope": "Cluster",
            "validation": {"openAPIV3Schema": {
                "type": "object",
                "properties": {"spec": spec_schema},
            }},
        },
    }


def validate_cr(constraint: dict, crd: dict) -> None:
    """crd_helpers.go:100-125 validateCR."""
    api_version = constraint.get("apiVersion", "")
    expected_av = f"{CONSTRAINT_GROUP}/{CONSTRAINT_VERSION}"
    if api_version != expected_av:
        raise ClientError(f"constraint apiVersion must be {expected_av}, "
                          f"got {api_version!r}")
    kind = constraint.get("kind", "")
    crd_kind = crd["spec"]["names"]["kind"]
    if kind != crd_kind:
        raise ClientError(f"constraint kind {kind!r} does not match CRD kind {crd_kind!r}")
    name = (constraint.get("metadata") or {}).get("name", "")
    if not name:
        raise ClientError("constraint has no metadata.name")
    if len(name) > 63 or not _DNS1123.match(name):
        raise ClientError(f"invalid constraint name {name!r}: must be a DNS-1123 label")
    schema = (crd["spec"].get("validation") or {}).get("openAPIV3Schema")
    if schema:
        errs: list[str] = []
        _validate_schema(constraint, schema, "", errs)
        if errs:
            raise ClientError("constraint schema violations: " + "; ".join(errs))


def _validate_schema(value: Any, schema: Any, path: str, errs: list[str]) -> None:
    """Minimal OpenAPI v3 subset validator: type / properties / items /
    additionalProperties / enum.  Malformed schema nodes (e.g. the demos'
    `items: string`) are ignored the way apiextensions treats unknown shapes."""
    if not isinstance(schema, dict):
        return
    t = schema.get("type")
    if t and not _type_ok(value, t):
        errs.append(f"{path or '.'}: expected {t}, got {type(value).__name__}")
        return
    if "enum" in schema and isinstance(schema["enum"], list):
        if value not in schema["enum"]:
            errs.append(f"{path or '.'}: {value!r} not in enum {schema['enum']!r}")
    props = schema.get("properties")
    if isinstance(props, dict) and isinstance(value, dict):
        for k, sub in props.items():
            if k in value:
                _validate_schema(value[k], sub, f"{path}.{k}", errs)
    addl = schema.get("additionalProperties")
    if isinstance(addl, dict) and isinstance(value, dict):
        props = props if isinstance(props, dict) else {}
        for k, v in value.items():
            if k not in props:
                _validate_schema(v, addl, f"{path}.{k}", errs)
    items = schema.get("items")
    if isinstance(items, dict) and isinstance(value, list):
        for i, v in enumerate(value):
            _validate_schema(v, items, f"{path}[{i}]", errs)


def _type_ok(value: Any, t: str) -> bool:
    if t == "object":
        return isinstance(value, dict)
    if t == "array":
        return isinstance(value, list)
    if t == "string":
        return isinstance(value, str)
    if t == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if t == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if t == "boolean":
        return isinstance(value, bool)
    if t == "null":
        return value is None
    return True
