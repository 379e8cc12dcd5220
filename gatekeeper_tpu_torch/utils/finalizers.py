# Copied from gatekeeper_tpu/utils/finalizers.py for the PyTorch port.
"""Finalizer list helpers shared by every reconciler.

The reference repeats containsString/removeString in each controller
package (constrainttemplate_controller.go:314-331 and twins); one
implementation here, parameterized by finalizer name.
"""

from __future__ import annotations


def has_finalizer(obj: dict, name: str) -> bool:
    return name in ((obj.get("metadata") or {}).get("finalizers") or [])


def add_finalizer(obj: dict, name: str) -> bool:
    """Returns True if the finalizer was added (object changed)."""
    meta = obj.setdefault("metadata", {})
    fins = meta.setdefault("finalizers", [])
    if name in fins:
        return False
    fins.append(name)
    return True


def strip_finalizer(obj: dict, name: str) -> bool:
    meta = obj.setdefault("metadata", {})
    fins = meta.get("finalizers") or []
    if name not in fins:
        return False
    meta["finalizers"] = [f for f in fins if f != name]
    return True
