# Copied from gatekeeper_tpu/utils/ha_status.py for the PyTorch port.
"""Per-pod HA status slots — the reference's multi-replica story.

Reference: pkg/util/ha_status.go:12-142.  Every replica writes only its
own entry in ``status.byPod`` (keyed by pod name from the POD_NAME env);
last-writer-wins per slot, so replicas never clobber each other's
status.  Works on unstructured dicts (constraints, templates, Config).
"""

from __future__ import annotations

import os


def pod_id() -> str:
    """ha_status.go:12-14 getID."""
    return os.environ.get("POD_NAME", "")


def get_ha_status(obj: dict, pod: str | None = None) -> dict:
    """Return this pod's ``status.byPod`` entry, or a blank ``{"id": id}``
    (ha_status.go:67-98 GetHAStatus)."""
    pod = pod_id() if pod is None else pod
    statuses = (obj.get("status") or {}).get("byPod")
    if isinstance(statuses, list):
        for s in statuses:
            if isinstance(s, dict) and s.get("id") == pod:
                return s
    return {"id": pod}


def set_ha_status(obj: dict, status: dict, pod: str | None = None) -> None:
    """Install ``status`` as this pod's ``status.byPod`` entry, replacing
    an existing slot or appending (ha_status.go:100-142 SetHAStatus)."""
    pod = pod_id() if pod is None else pod
    status = dict(status)
    status["id"] = pod
    st = obj.setdefault("status", {})
    by_pod = st.get("byPod")
    if not isinstance(by_pod, list):
        by_pod = []
        st["byPod"] = by_pod
    for i, s in enumerate(by_pod):
        if isinstance(s, dict) and s.get("id") == pod:
            by_pod[i] = status
            return
    by_pod.append(status)


def get_all_pod_statuses(obj: dict) -> list[dict]:
    statuses = (obj.get("status") or {}).get("byPod")
    return [s for s in statuses if isinstance(s, dict)] if isinstance(statuses, list) else []
