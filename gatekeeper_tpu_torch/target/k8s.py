# Copied from gatekeeper_tpu/target/k8s.py for the PyTorch port.
"""The Kubernetes validation target.

Native implementation of ``K8sValidationTarget``
(reference: pkg/target/target.go).  The match semantics below are a
line-faithful transcription of the target's Rego library
(target.go:49-255) into host code:

- kind selectors: default ``[{apiGroups: ["*"], kinds: ["*"]}]``; a
  selector matches when group and kind each equal a listed entry or "*"
  (target.go:147-173);
- namespaces: when present, review.namespace must be listed
  (target.go:222-230);
- labelSelector: matchLabels equality plus matchExpressions with
  In/NotIn/Exists/DoesNotExist *violation* semantics — notably a missing
  key violates In/Exists regardless of values, NotIn never violates on a
  missing key, and empty values lists disarm In/NotIn (target.go:178-219);
- namespaceSelector: resolved against the cached v1/Namespace object;
  an uncached namespace autorejects the review (target.go:36-47,236-255).

Path layout matches ProcessData (target.go:271-298): apiVersion is
URL-escaped into a single segment ("apps%2Fv1").  Deviation from the
reference: audit reviews for grouped resources get a properly split
kind {group, version} (the reference passes the escaped string through
make_review and derives group="", an apparent bug with no test coverage).
"""

from __future__ import annotations

import urllib.parse
from typing import Any, Iterable

from gatekeeper_tpu_torch.client.targets import TargetHandler, UnhandledData, WipeData
from gatekeeper_tpu_torch.client.types import Result
from gatekeeper_tpu_torch.errors import ClientError
from gatekeeper_tpu_torch.store.table import ResourceMeta, ResourceTable

TARGET_NAME = "admission.k8s.gatekeeper.sh"

_QUOTE_CACHE: dict[str, str] = {}


def _labels_of(review: dict) -> dict:
    obj = review.get("object") or {}
    meta = obj.get("metadata") or {}
    labels = meta.get("labels") or {}
    return labels if isinstance(labels, dict) else {}


def match_expression_violated(op: str, labels: dict, key: str, values: list) -> bool:
    """target.go:178-205, violation semantics per operator."""
    if op == "In":
        if key not in labels:
            return True
        return len(values) > 0 and labels[key] not in values
    if op == "NotIn":
        return key in labels and len(values) > 0 and labels[key] in values
    if op == "Exists":
        return key not in labels
    if op == "DoesNotExist":
        return key in labels
    return False  # unknown operator: no violation clause fires (target.go:207-216)


def matches_label_selector(selector: dict, labels: dict) -> bool:
    """target.go:209-219 matches_label_selector."""
    match_labels = selector.get("matchLabels") or {}
    for k, v in match_labels.items():
        if labels.get(k) != v:
            return False
    for expr in selector.get("matchExpressions") or []:
        if match_expression_violated(
                expr.get("operator", ""), labels,
                expr.get("key", ""), expr.get("values") or []):
            return False
    return True


class K8sValidationTarget(TargetHandler):
    name = TARGET_NAME

    # ------------------------------------------------------------------
    # data plumbing

    def process_data(self, obj: Any) -> tuple[str, ResourceMeta, dict]:
        if isinstance(obj, WipeData) or obj is WipeData:
            raise UnhandledData("WipeData handled by caller")
        if not isinstance(obj, dict):
            raise UnhandledData(f"not an unstructured object: {type(obj)}")
        api_version = obj.get("apiVersion", "")
        kind = obj.get("kind", "")
        meta = obj.get("metadata") or {}
        name = meta.get("name", "")
        namespace = meta.get("namespace") or None
        if not api_version:
            raise ClientError(f"resource {name!r} has no version")
        if not kind:
            raise ClientError(f"resource {name!r} has no kind")
        escaped = _QUOTE_CACHE.get(api_version)
        if escaped is None:
            # clusters hold a handful of distinct groupVersions; quoting
            # each once (not per object) matters at 1M-object ingest
            escaped = urllib.parse.quote(api_version, safe="")
            if len(_QUOTE_CACHE) < 4096:
                _QUOTE_CACHE[api_version] = escaped
        if namespace is None:
            key = f"cluster/{escaped}/{kind}/{name}"
        else:
            key = f"namespace/{namespace}/{escaped}/{kind}/{name}"
        return key, ResourceMeta(api_version=api_version, kind=kind,
                                 name=name, namespace=namespace), obj

    def process_data_batch(self, objs: list) -> list:
        """``[process_data(o) or None]`` for a whole list — None marks
        an UnhandledData skip; ClientError still raises.  The native
        extractor handles the common shape (string apiVersion/kind/
        name, absent-or-string namespace) in one C pass; anything else
        routes through the exact scalar path."""
        from gatekeeper_tpu_torch import native
        if not (native.available and native.process_meta is not None):
            return [self._process_or_none(o) for o in objs]
        # the C pass only reads the quote cache; prime it for every
        # distinct apiVersion up front (a handful per cluster)
        for o in objs:
            if isinstance(o, dict):
                api = o.get("apiVersion")
                if isinstance(api, str) and api \
                        and api not in _QUOTE_CACHE \
                        and len(_QUOTE_CACHE) < 4096:
                    _QUOTE_CACHE[api] = urllib.parse.quote(api, safe="")
        fallback: list = []
        keys, apis, kinds, names, nss = native.process_meta(
            objs, _QUOTE_CACHE, fallback)
        out: list = [None] * len(objs)
        for i, o in enumerate(objs):
            if keys[i] is not None:
                out[i] = (keys[i], ResourceMeta(apis[i], kinds[i],
                                                names[i], nss[i]), o)
        for i in fallback:
            out[i] = self._process_or_none(objs[i])
        return out

    def _process_or_none(self, obj: Any):
        try:
            return self.process_data(obj)
        except UnhandledData:
            return None

    def handle_review(self, obj: Any) -> dict:
        # accepts an AdmissionRequest-shaped dict ({"kind": {...}, "object": ...})
        if isinstance(obj, dict) and "kind" in obj and "object" in obj:
            return obj
        raise UnhandledData("not an AdmissionRequest")

    def handle_violation(self, result: Result) -> None:
        """Reconstruct the violating object (target.go:325-369)."""
        review = result.review
        if not isinstance(review, dict):
            raise ClientError(f"could not cast review as dict: {review!r}")
        kind = review.get("kind") or {}
        group = kind.get("group")
        version = kind.get("version")
        k = kind.get("kind")
        for fname, v in (("group", group), ("version", version), ("kind", k)):
            if not isinstance(v, str):
                raise ClientError(f"review[kind][{fname}] is not a string: {v!r}")
        api_version = version if group == "" else f"{group}/{version}"
        obj = review.get("object")
        if obj is None:
            raise ClientError("no object returned in review")
        out = dict(obj)
        out["apiVersion"] = api_version
        out["kind"] = k
        result.resource = out

    def make_review(self, meta: ResourceMeta, obj: dict) -> dict:
        """make_review + add_field namespace (target.go:69-107)."""
        review = {
            "kind": {"group": meta.group, "version": meta.version, "kind": meta.kind},
            "name": meta.name,
            "operation": "CREATE",
            "object": obj,
        }
        if meta.namespace is not None:
            review["namespace"] = meta.namespace
        return review

    # ------------------------------------------------------------------
    # match library

    def _matches(self, constraint: dict, review: dict, table: ResourceTable) -> bool:
        spec = constraint.get("spec") or {}
        match = spec.get("match") or {}

        # kind selectors (target.go:147-173).  The wildcard default applies
        # only when the field is ABSENT; an explicit empty/null kinds list
        # iterates zero selectors and matches nothing.
        if "kinds" in match:
            kinds = match["kinds"] if isinstance(match["kinds"], list) else []
        else:
            kinds = [{"apiGroups": ["*"], "kinds": ["*"]}]
        review_kind = review.get("kind") or {}
        rg = review_kind.get("group", "")
        rk = review_kind.get("kind", "")
        ok = False
        for ks in kinds:
            groups = ks.get("apiGroups") or []
            knames = ks.get("kinds") or []
            if ("*" in groups or rg in groups) and ("*" in knames or rk in knames):
                ok = True
                break
        if not ok:
            return False

        # namespaces (target.go:222-230)
        if "namespaces" in match and match["namespaces"] is not None:
            if review.get("namespace") not in match["namespaces"]:
                return False

        # namespaceSelector (target.go:236-255)
        if "namespaceSelector" in match and match["namespaceSelector"] is not None:
            ns_obj = self._cached_namespace(review.get("namespace"), table)
            if ns_obj is None:
                return False
            ns_labels = (ns_obj.get("metadata") or {}).get("labels") or {}
            if not matches_label_selector(match["namespaceSelector"], ns_labels):
                return False

        # labelSelector (target.go:58-66)
        selector = match.get("labelSelector") or {}
        return matches_label_selector(selector, _labels_of(review))

    def _cached_namespace(self, namespace, table: ResourceTable):
        if not isinstance(namespace, str) or namespace == "":
            return None
        row = table.lookup(f"cluster/v1/Namespace/{namespace}")
        return None if row is None else table.object_at(row)

    def matching_constraints(self, review: dict, constraints: Iterable[dict],
                             table: ResourceTable) -> Iterable[dict]:
        for c in constraints:
            if self._matches(c, review, table):
                yield c

    def autoreject_review(self, review: dict, constraints: Iterable[dict],
                          table: ResourceTable) -> list[tuple[dict, str, dict]]:
        """target.go:36-47: any constraint with a namespaceSelector rejects
        when the review's namespace is not in the cache."""
        out = []
        for c in constraints:
            match = (c.get("spec") or {}).get("match") or {}
            if "namespaceSelector" not in match or match["namespaceSelector"] is None:
                continue
            if self._cached_namespace(review.get("namespace"), table) is None:
                out.append((c, "Namespace is not cached in OPA.", {}))
        return out

    def make_match_engine(self, table: ResourceTable):
        from gatekeeper_tpu_torch.engine.match import MatchEngine
        return MatchEngine(table)

    # ------------------------------------------------------------------
    # schema / validation

    def match_schema(self) -> dict:
        """spec.match JSONSchema (target.go:371-463)."""
        label_selector = {
            "type": "object",
            "properties": {
                "matchLabels": {"type": "object",
                                "additionalProperties": {"type": "string"}},
                "matchExpressions": {"type": "array", "items": {
                    "type": "object",
                    "properties": {
                        "key": {"type": "string"},
                        "operator": {"type": "string",
                                     "enum": ["In", "NotIn", "Exists", "DoesNotExist"]},
                        "values": {"type": "array", "items": {"type": "string"}},
                    }}},
            },
        }
        return {
            "type": "object",
            "properties": {
                "kinds": {"type": "array", "items": {
                    "type": "object",
                    "properties": {
                        "apiGroups": {"type": "array", "items": {"type": "string"}},
                        "kinds": {"type": "array", "items": {"type": "string"}},
                    }}},
                "namespaces": {"type": "array", "items": {"type": "string"}},
                "labelSelector": label_selector,
                "namespaceSelector": label_selector,
            },
        }

    def validate_constraint(self, constraint: dict) -> None:
        """Label-selector validation (target.go:465-498)."""
        match = (constraint.get("spec") or {}).get("match") or {}
        for field in ("labelSelector", "namespaceSelector"):
            sel = match.get(field)
            if sel is None:
                continue
            for expr in sel.get("matchExpressions") or []:
                op = expr.get("operator")
                if op not in ("In", "NotIn", "Exists", "DoesNotExist"):
                    raise ClientError(
                        f"spec.match.{field}.matchExpressions: invalid operator {op!r}")
                if op in ("In", "NotIn") and not expr.get("values"):
                    raise ClientError(
                        f"spec.match.{field}.matchExpressions: operator {op} "
                        "requires non-empty values")
                if op in ("Exists", "DoesNotExist") and expr.get("values"):
                    raise ClientError(
                        f"spec.match.{field}.matchExpressions: operator {op} "
                        "forbids values")
