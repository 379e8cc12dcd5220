# Copied from gatekeeper_tpu/library/workload.py for the PyTorch port.
"""Synthetic mixed K8s workloads exercising the whole template
library (pods incl. security contexts/probes/env/ports, services,
ingresses, deployments, roles, rolebindings, PVCs, PDBs) — shared by
the library tests and the full-library bench config (BASELINE.md).
"""

from __future__ import annotations


def make_mixed(rng, n):
    """Mixed workload touching every library template."""
    out = []
    for i in range(n):
        kind = rng.choice(["Pod", "Pod", "Pod", "Service", "Ingress",
                           "Deployment", "RoleBinding", "Role",
                           "PersistentVolumeClaim", "PodDisruptionBudget"])
        ns = rng.choice(["default", "prod", "dev"])
        meta = {"name": f"{kind.lower()}{i}", "namespace": ns}
        if rng.random() < 0.7:
            meta["labels"] = {k: rng.choice(["prod", "dev", "x", "y"])
                              for k in ("env", "owner", "app") if rng.random() < 0.6}
        if rng.random() < 0.3:
            meta["annotations"] = {"owner": "team"}
        if kind == "Pod":
            containers = []
            for j in range(rng.randint(1, 3)):
                c = {"name": f"c{j}",
                     "image": rng.choice([
                         "gcr.io/org/app:1.2", "docker.io/thing:latest",
                         "quay.io/x/y", "gcr.io/org/app@sha256:" + "a" * 64,
                         "ghcr.io/z/w:2"])}
                if rng.random() < 0.8:
                    c["resources"] = {
                        "limits": {"cpu": rng.choice(["100m", "1", "4", 2]),
                                   "memory": rng.choice(["256Mi", "1Gi", "4Gi"])},
                        "requests": {"cpu": rng.choice(["50m", "1"]),
                                     "memory": rng.choice(
                                         ["128Mi", "1Gi", "1024Mi"])}}
                    if rng.random() < 0.2:
                        del c["resources"]["requests"]
                if rng.random() < 0.4:
                    c["securityContext"] = {
                        "privileged": rng.random() < 0.3,
                        "readOnlyRootFilesystem": rng.random() < 0.5,
                        "allowPrivilegeEscalation": rng.random() < 0.3,
                        "capabilities": {"add": rng.sample(
                            ["SYS_ADMIN", "NET_ADMIN", "CHOWN"], k=rng.randint(0, 2))}}
                if rng.random() < 0.3:
                    c["livenessProbe"] = {"httpGet": {"path": "/", "port": 80}}
                if rng.random() < 0.3:
                    c["readinessProbe"] = {"httpGet": {"path": "/", "port": 80}}
                if rng.random() < 0.3:
                    c["env"] = [{"name": nm, "value": "x"} for nm in
                                rng.sample(["API_TOKEN", "HOME",
                                            "DB_PASSWORD", "MODE", "REGION"],
                                           k=rng.randint(1, 4))]
                if rng.random() < 0.2:
                    c["ports"] = [{"containerPort": 80,
                                   "hostPort": rng.choice([80, 8080, 30000])}]
                if rng.random() < 0.5:
                    c["imagePullPolicy"] = rng.choice(["Always", "IfNotPresent"])
                if rng.random() < 0.15:
                    c["tty"] = True
                if rng.random() < 0.15:
                    c["stdin"] = True
                containers.append(c)
            spec = {"containers": containers}
            if rng.random() < 0.4:
                spec["priorityClassName"] = rng.choice(
                    ["default", "high", "low", "batch"])
            if rng.random() < 0.5:
                spec["imagePullSecrets"] = rng.choice(
                    [[], [{"name": "regcred"}]])
            if rng.random() < 0.2:
                spec["hostPID"] = True
            if rng.random() < 0.2:
                spec["hostNetwork"] = True
            if rng.random() < 0.3:
                sc = {"runAsUser": rng.choice([0, 500, 2000]),
                      "runAsNonRoot": rng.random() < 0.5}
                if rng.random() < 0.4:
                    sc["sysctls"] = [{"name": rng.choice(
                        ["kernel.msgmax", "net.ipv4.ip_local_port_range",
                         "net.core.somaxconn"]), "value": "1024"}]
                if rng.random() < 0.5:
                    sc["seccompProfile"] = {"type": rng.choice(
                        ["RuntimeDefault", "Unconfined", "Localhost"])}
                spec["securityContext"] = sc
            if rng.random() < 0.3:
                spec["automountServiceAccountToken"] = rng.random() < 0.5
            if rng.random() < 0.3:
                spec["volumes"] = [{"name": "v",
                                    "hostPath": {"path": rng.choice(
                                        ["/var/log/app", "/etc", "/root"])}}]
            if rng.random() < 0.5:
                spec["serviceAccountName"] = rng.choice(["default", "app-sa"])
            out.append({"apiVersion": "v1", "kind": "Pod",
                        "metadata": meta, "spec": spec})
        elif kind == "Service":
            out.append({"apiVersion": "v1", "kind": "Service", "metadata": meta,
                        "spec": {"type": rng.choice(
                            ["ClusterIP", "NodePort", "LoadBalancer"]),
                            "externalIPs": rng.choice(
                                [[], ["203.0.113.0"], ["198.51.100.7"]]),
                            "selector": {"app": f"a{i % 5}"}}})
        elif kind == "Ingress":
            spec = {"host": f"h{i % 4}.example.com",
                    "rules": [{"host": rng.choice(
                        ["a.example.com", "*.example.com", f"h{i % 4}.example.com"])}]}
            if rng.random() < 0.5:
                spec["tls"] = [{"secretName": "tls"}]
            out.append({"apiVersion": "extensions/v1beta1", "kind": "Ingress",
                        "metadata": meta, "spec": spec})
        elif kind == "Deployment":
            out.append({"apiVersion": "apps/v1", "kind": "Deployment",
                        "metadata": meta,
                        "spec": {"replicas": rng.choice([0, 1, 3, 80])}})
        elif kind == "Role":
            out.append({"apiVersion": "rbac.authorization.k8s.io/v1",
                        "kind": "Role", "metadata": meta,
                        "rules": [{"apiGroups": rng.choice([[""], ["*"],
                                                            ["apps"]]),
                                   "resources": rng.choice(
                                       [["pods"], ["*"], ["pods", "services"]]),
                                   "verbs": rng.choice(
                                       [["get", "list"], ["*"], ["watch"]])}]})
        elif kind == "PersistentVolumeClaim":
            out.append({"apiVersion": "v1", "kind": "PersistentVolumeClaim",
                        "metadata": meta,
                        "spec": {"storageClassName": rng.choice(
                            ["standard", "ssd", "scratch", "legacy-nfs"]),
                            "resources": {"requests": {"storage": "10Gi"}}}})
        elif kind == "PodDisruptionBudget":
            spec = ({"maxUnavailable": rng.choice([0, 1, 2])}
                    if rng.random() < 0.6 else
                    {"minAvailable": rng.choice([1, "50%"])})
            out.append({"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
                        "metadata": meta, "spec": spec})
        else:
            out.append({"apiVersion": "rbac.authorization.k8s.io/v1",
                        "kind": "RoleBinding", "metadata": meta,
                        "subjects": [{"kind": "User", "name": rng.choice(
                            ["alice", "system:anonymous", "system:unauthenticated"])}]})
    return out

