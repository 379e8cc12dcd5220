# Copied from gatekeeper_tpu/library/templates.py for the PyTorch port.
"""Policy template library: ~30 ConstraintTemplates in the supported
Rego subset.

This plays the role of the public gatekeeper-library's `general/`
template suite for this framework: a ready-to-use policy set, the
example corpus for docs/demos, and the workload for the full-library
benchmark config (BASELINE.md "~30 templates x 100k mixed resources").
Template structure mirrors the reference's examples
(upstream example/templates/k8srequiredlabels_template.yaml,
demo/agilebank/templates/*.yaml): one `violation[{"msg": ...}]` entry
point per template, parameters under input.constraint.spec.parameters.

Each entry: kind -> (rego source, sample parameters used by demos/bench).
`template_doc` / `constraint_doc` build the CRD-shaped documents.
"""

from __future__ import annotations

TARGET = "admission.k8s.gatekeeper.sh"


def template_doc(kind: str, rego: str) -> dict:
    return {"apiVersion": "templates.gatekeeper.sh/v1alpha1",
            "kind": "ConstraintTemplate",
            "metadata": {"name": kind.lower()},
            "spec": {"crd": {"spec": {"names": {"kind": kind}}},
                     "targets": [{"target": TARGET, "rego": rego}]}}


def constraint_doc(kind: str, name: str, params: dict | None = None,
                   match: dict | None = None) -> dict:
    spec: dict = {}
    if params is not None:
        spec["parameters"] = params
    if match is not None:
        spec["match"] = match
    return {"apiVersion": "constraints.gatekeeper.sh/v1alpha1", "kind": kind,
            "metadata": {"name": name}, "spec": spec}


LIBRARY: dict[str, tuple[str, dict]] = {}


def _t(kind: str, params: dict):
    def reg(rego: str):
        LIBRARY[kind] = (rego, params)
        return rego
    return reg


# ---------------------------------------------------------------- labels / metadata

_t("K8sRequiredLabels", {"labels": ["owner"]})("""package k8srequiredlabels
violation[{"msg": msg, "details": {"missing_labels": missing}}] {
  provided := {label | input.review.object.metadata.labels[label]}
  required := {label | label := input.constraint.spec.parameters.labels[_]}
  missing := required - provided
  count(missing) > 0
  msg := sprintf("you must provide labels: %v", [missing])
}
""")

_t("K8sRequiredAnnotations", {"annotations": ["owner"]})("""package k8srequiredannotations
violation[{"msg": msg}] {
  provided := {a | input.review.object.metadata.annotations[a]}
  required := {a | a := input.constraint.spec.parameters.annotations[_]}
  missing := required - provided
  count(missing) > 0
  msg := sprintf("missing required annotations: %v", [missing])
}
""")

_t("K8sValidLabelValue", {"key": "env", "allowed": ["prod", "dev", "staging"]})("""package k8svalidlabelvalue
violation[{"msg": msg}] {
  key := input.constraint.spec.parameters.key
  value := input.review.object.metadata.labels[key]
  allowed := {v | v := input.constraint.spec.parameters.allowed[_]}
  not allowed[value]
  msg := sprintf("label <%v> value <%v> is not allowed", [key, value])
}
""")

_t("K8sDenyAll", {})("""package k8sdenyall
violation[{"msg": msg}] {
  msg := sprintf("denied by policy: %v", [input.review.object.metadata.name])
}
""")

# ---------------------------------------------------------------- images

_t("K8sAllowedRepos", {"repos": ["gcr.io/"]})("""package k8sallowedrepos
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  satisfied := [good | repo = input.constraint.spec.parameters.repos[_] ; good = startswith(container.image, repo)]
  not any(satisfied)
  msg := sprintf("container <%v> has an invalid image repo <%v>", [container.name, container.image])
}
violation[{"msg": msg}] {
  container := input.review.object.spec.initContainers[_]
  satisfied := [good | repo = input.constraint.spec.parameters.repos[_] ; good = startswith(container.image, repo)]
  not any(satisfied)
  msg := sprintf("initContainer <%v> has an invalid image repo <%v>", [container.name, container.image])
}
""")

_t("K8sDisallowedTags", {"tags": ["latest"]})("""package k8sdisallowedtags
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  tag := input.constraint.spec.parameters.tags[_]
  endswith(container.image, concat(":", ["", tag]))
  msg := sprintf("container <%v> uses a disallowed tag <%v>", [container.name, tag])
}
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  not contains(container.image, ":")
  msg := sprintf("container <%v> has no image tag", [container.name])
}
""")

_t("K8sImageDigests", {})("""package k8simagedigests
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  not re_match("@sha256:[a-f0-9]{64}$", container.image)
  msg := sprintf("container <%v> image <%v> is not pinned by digest", [container.name, container.image])
}
""")

# ---------------------------------------------------------------- resources

_t("K8sContainerLimits", {"cpu": "2", "memory": "2Gi"})("""package k8scontainerlimits
canonify_cpu(orig) = new { is_number(orig); new := orig * 1000 }
else = new {
  endswith(orig, "m")
  new := to_number(replace(orig, "m", ""))
}
else = new {
  re_match("^[0-9]+(\\\\.[0-9]+)?$", orig)
  new := to_number(orig) * 1000
}
canonify_mem(orig) = new { is_number(orig); new := orig }
else = new { new := units.parse_bytes(orig) }
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  cpu_orig := container.resources.limits.cpu
  cpu := canonify_cpu(cpu_orig)
  max_cpu := canonify_cpu(input.constraint.spec.parameters.cpu)
  cpu > max_cpu
  msg := sprintf("container <%v> cpu limit <%v> is higher than the maximum allowed of <%v>", [container.name, cpu_orig, input.constraint.spec.parameters.cpu])
}
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  mem_orig := container.resources.limits.memory
  mem := canonify_mem(mem_orig)
  max_mem := canonify_mem(input.constraint.spec.parameters.memory)
  mem > max_mem
  msg := sprintf("container <%v> memory limit <%v> is higher than the maximum allowed of <%v>", [container.name, mem_orig, input.constraint.spec.parameters.memory])
}
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  not container.resources.limits
  msg := sprintf("container <%v> has no resource limits", [container.name])
}
""")

_t("K8sContainerRequests", {"cpu": "500m", "memory": "100Mi"})("""package k8scontainerrequests
canonify_cpu(orig) = new { is_number(orig); new := orig * 1000 }
else = new {
  endswith(orig, "m")
  new := to_number(replace(orig, "m", ""))
}
else = new {
  re_match("^[0-9]+(\\\\.[0-9]+)?$", orig)
  new := to_number(orig) * 1000
}
canonify_mem(orig) = new { is_number(orig); new := orig }
else = new { new := units.parse_bytes(orig) }
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  cpu := canonify_cpu(container.resources.requests.cpu)
  max_cpu := canonify_cpu(input.constraint.spec.parameters.cpu)
  cpu > max_cpu
  msg := sprintf("container <%v> cpu request is too high", [container.name])
}
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  mem := canonify_mem(container.resources.requests.memory)
  max_mem := canonify_mem(input.constraint.spec.parameters.memory)
  mem > max_mem
  msg := sprintf("container <%v> memory request is too high", [container.name])
}
""")

_t("K8sContainerRatios", {"ratio": 4})("""package k8scontainerratios
canonify_cpu(orig) = new { is_number(orig); new := orig * 1000 }
else = new {
  endswith(orig, "m")
  new := to_number(replace(orig, "m", ""))
}
else = new {
  re_match("^[0-9]+(\\\\.[0-9]+)?$", orig)
  new := to_number(orig) * 1000
}
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  limit := canonify_cpu(container.resources.limits.cpu)
  request := canonify_cpu(container.resources.requests.cpu)
  request > 0
  limit / request > input.constraint.spec.parameters.ratio
  msg := sprintf("container <%v> cpu limit/request ratio is too high", [container.name])
}
""")

_t("K8sMaxContainers", {"max": 2})("""package k8smaxcontainers
violation[{"msg": msg}] {
  n := count(input.review.object.spec.containers)
  n > input.constraint.spec.parameters.max
  msg := sprintf("too many containers: %v", [n])
}
""")

_t("K8sReplicaLimits", {"min": 1, "max": 50})("""package k8sreplicalimits
violation[{"msg": msg}] {
  r := input.review.object.spec.replicas
  r > input.constraint.spec.parameters.max
  msg := sprintf("replica count %v is above the maximum %v", [r, input.constraint.spec.parameters.max])
}
violation[{"msg": msg}] {
  r := input.review.object.spec.replicas
  r < input.constraint.spec.parameters.min
  msg := sprintf("replica count %v is below the minimum %v", [r, input.constraint.spec.parameters.min])
}
""")

# ---------------------------------------------------------------- probes / security context

_t("K8sRequiredProbes", {"probes": ["livenessProbe", "readinessProbe"]})("""package k8srequiredprobes
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  probe := input.constraint.spec.parameters.probes[_]
  not container[probe]
  msg := sprintf("container <%v> has no <%v>", [container.name, probe])
}
""")

_t("K8sPrivileged", {})("""package k8sprivileged
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  container.securityContext.privileged
  msg := sprintf("privileged container is not allowed: %v", [container.name])
}
""")

_t("K8sReadOnlyRootFS", {})("""package k8sreadonlyrootfs
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  not container.securityContext.readOnlyRootFilesystem
  msg := sprintf("container <%v> must set readOnlyRootFilesystem", [container.name])
}
""")

_t("K8sAllowPrivilegeEscalation", {})("""package k8sallowprivilegeescalation
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  container.securityContext.allowPrivilegeEscalation
  msg := sprintf("container <%v> must not allow privilege escalation", [container.name])
}
""")

_t("K8sCapabilities", {"disallowed": ["SYS_ADMIN", "NET_ADMIN"]})("""package k8scapabilities
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  cap := container.securityContext.capabilities.add[_]
  bad := input.constraint.spec.parameters.disallowed[_]
  cap == bad
  msg := sprintf("container <%v> adds disallowed capability <%v>", [container.name, cap])
}
""")

_t("K8sAllowedUsers", {"min": 1000, "max": 65535})("""package k8sallowedusers
violation[{"msg": msg}] {
  uid := input.review.object.spec.securityContext.runAsUser
  uid < input.constraint.spec.parameters.min
  msg := sprintf("runAsUser %v is below the minimum", [uid])
}
violation[{"msg": msg}] {
  uid := input.review.object.spec.securityContext.runAsUser
  uid > input.constraint.spec.parameters.max
  msg := sprintf("runAsUser %v is above the maximum", [uid])
}
""")

_t("K8sRequireRunAsNonRoot", {})("""package k8srequirerunasnonroot
violation[{"msg": msg}] {
  not input.review.object.spec.securityContext.runAsNonRoot
  msg := sprintf("pod <%v> must set runAsNonRoot", [input.review.object.metadata.name])
}
""")

# ---------------------------------------------------------------- host namespaces / filesystem / network

_t("K8sHostNamespaces", {})("""package k8shostnamespaces
violation[{"msg": msg}] {
  input.review.object.spec.hostPID
  msg := "sharing the host PID namespace is not allowed"
}
violation[{"msg": msg}] {
  input.review.object.spec.hostIPC
  msg := "sharing the host IPC namespace is not allowed"
}
""")

_t("K8sHostNetwork", {})("""package k8shostnetwork
violation[{"msg": msg}] {
  input.review.object.spec.hostNetwork
  msg := "host network is not allowed"
}
""")

_t("K8sHostFilesystem", {"allowedPaths": ["/var/log"]})("""package k8shostfilesystem
violation[{"msg": msg}] {
  vol := input.review.object.spec.volumes[_]
  path := vol.hostPath.path
  allowed := [ok | p = input.constraint.spec.parameters.allowedPaths[_] ; ok = startswith(path, p)]
  not any(allowed)
  msg := sprintf("hostPath volume <%v> at <%v> is not allowed", [vol.name, path])
}
""")

_t("K8sHostPorts", {"min": 1024, "max": 65535})("""package k8shostports
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  port := container.ports[_]
  hp := port.hostPort
  hp < input.constraint.spec.parameters.min
  msg := sprintf("container <%v> hostPort %v is below the allowed range", [container.name, hp])
}
""")

# ---------------------------------------------------------------- services / ingress

_t("K8sBlockNodePort", {})("""package k8sblocknodeport
violation[{"msg": msg}] {
  input.review.object.spec.type == "NodePort"
  msg := "NodePort services are not allowed"
}
""")

_t("K8sBlockLoadBalancer", {})("""package k8sblockloadbalancer
violation[{"msg": msg}] {
  input.review.object.spec.type == "LoadBalancer"
  msg := "LoadBalancer services are not allowed"
}
""")

_t("K8sExternalIPs", {"allowedIPs": ["203.0.113.0"]})("""package k8sexternalips
violation[{"msg": msg}] {
  ip := input.review.object.spec.externalIPs[_]
  allowed := {a | a := input.constraint.spec.parameters.allowedIPs[_]}
  not allowed[ip]
  msg := sprintf("externalIP <%v> is not allowed", [ip])
}
""")

_t("K8sHttpsOnly", {})("""package k8shttpsonly
violation[{"msg": msg}] {
  input.review.object.kind == "Ingress"
  not input.review.object.spec.tls
  msg := sprintf("ingress <%v> must be https-only (spec.tls required)", [input.review.object.metadata.name])
}
""")

_t("K8sBlockWildcardIngress", {})("""package k8sblockwildcardingress
violation[{"msg": msg}] {
  rule := input.review.object.spec.rules[_]
  host := rule.host
  contains(host, "*")
  msg := sprintf("wildcard ingress host <%v> is not allowed", [host])
}
violation[{"msg": msg}] {
  rule := input.review.object.spec.rules[_]
  not rule.host
  msg := "ingress rule without a host is not allowed"
}
""")

_t("K8sUniqueIngressHost", {})("""package k8suniqueingresshost
violation[{"msg": msg}] {
  host := input.review.object.spec.host
  other := data.inventory.namespace[ns][_]["Ingress"][name]
  other.spec.host == host
  not input.review.object.metadata.name == name
  msg := sprintf("duplicate ingress host %v", [host])
}
""")

# ---------------------------------------------------------------- misc

_t("K8sNoEnvVarSecrets", {"pattern": "(?i)(password|secret|token|apikey)"})("""package k8snoenvvarsecrets
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  env := container.env[_]
  re_match(input.constraint.spec.parameters.pattern, env.name)
  env.value
  msg := sprintf("container <%v> passes secret-like env var <%v> by value", [container.name, env.name])
}
""")

_t("K8sDisallowedAnonymous", {})("""package k8sdisallowedanonymous
violation[{"msg": msg}] {
  subject := input.review.object.subjects[_]
  subject.name == "system:anonymous"
  msg := "binding to system:anonymous is not allowed"
}
violation[{"msg": msg}] {
  subject := input.review.object.subjects[_]
  subject.name == "system:unauthenticated"
  msg := "binding to system:unauthenticated is not allowed"
}
""")

_t("K8sImagePullPolicy", {"policy": "Always"})("""package k8simagepullpolicy
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  container.imagePullPolicy != input.constraint.spec.parameters.policy
  msg := sprintf("container <%v> imagePullPolicy must be %v", [container.name, input.constraint.spec.parameters.policy])
}
""")

_t("K8sRequiredServiceAccount", {"disallowed": ["default"]})("""package k8srequiredserviceaccount
violation[{"msg": msg}] {
  sa := input.review.object.spec.serviceAccountName
  bad := input.constraint.spec.parameters.disallowed[_]
  sa == bad
  msg := sprintf("service account <%v> is not allowed", [sa])
}
violation[{"msg": msg}] {
  not input.review.object.spec.serviceAccountName
  input.review.object.kind == "Pod"
  msg := "an explicit serviceAccountName is required"
}
""")


# ---------------------------------------------------------------- round-3 additions
# (more of the public gatekeeper-library general/pod-security suite)

_t("K8sDisallowedRepos", {"repos": ["docker.io/"]})("""package k8sdisallowedrepos
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  repo := input.constraint.spec.parameters.repos[_]
  startswith(container.image, repo)
  msg := sprintf("container <%v> image <%v> comes from a disallowed repository <%v>", [container.name, container.image, repo])
}
""")

_t("K8sAllowedHostPorts", {"min": 1024, "max": 32767})("""package k8sallowedhostports
out_of_range(port, min, max) { port.hostPort < min }
else { port.hostPort > max }

violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  port := container.ports[_]
  out_of_range(port, input.constraint.spec.parameters.min, input.constraint.spec.parameters.max)
  msg := sprintf("container <%v> hostPort <%v> is outside the allowed range", [container.name, port.hostPort])
}
""")

_t("K8sForbiddenSysctls", {"sysctls": ["kernel.msgmax", "net.core.somaxconn"]})("""package k8sforbiddensysctls
violation[{"msg": msg}] {
  entry := input.review.object.spec.securityContext.sysctls[_]
  forbidden := {s | s := input.constraint.spec.parameters.sysctls[_]}
  forbidden[entry.name]
  msg := sprintf("sysctl <%v> is forbidden", [entry.name])
}
""")

_t("K8sEphemeralStorageLimit", {"max_gi": 2})("""package k8sephemeralstoragelimit
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  not container.resources.limits["ephemeral-storage"]
  msg := sprintf("container <%v> has no ephemeral-storage limit", [container.name])
}
""")

_t("K8sAutomountServiceAccountToken", {})("""package k8sautomountserviceaccounttoken
violation[{"msg": msg}] {
  input.review.object.kind == "Pod"
  not input.review.object.spec.automountServiceAccountToken == false
  msg := "automountServiceAccountToken must be set to false"
}
""")

_t("K8sAllowedSeccompProfiles", {"profiles": ["RuntimeDefault", "Localhost"]})("""package k8sallowedseccompprofiles
violation[{"msg": msg}] {
  ptype := input.review.object.spec.securityContext.seccompProfile.type
  allowed := {p | p := input.constraint.spec.parameters.profiles[_]}
  not allowed[ptype]
  msg := sprintf("seccomp profile <%v> is not allowed", [ptype])
}
violation[{"msg": msg}] {
  input.review.object.kind == "Pod"
  not input.review.object.spec.securityContext.seccompProfile
  msg := "a pod-level seccompProfile is required"
}
""")

_t("K8sDisallowLatestTag", {})("""package k8sdisallowlatesttag
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  endswith(container.image, ":latest")
  msg := sprintf("container <%v> uses the mutable :latest tag", [container.name])
}
""")


_t("K8sDisallowInteractiveTTY", {})("""package k8sdisallowinteractivetty
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  container.tty == true
  msg := sprintf("container <%v> must not allocate a TTY", [container.name])
}
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  container.stdin == true
  msg := sprintf("container <%v> must not keep stdin open", [container.name])
}
""")

_t("K8sPodDisruptionBudget", {})("""package k8spoddisruptionbudget
violation[{"msg": msg}] {
  input.review.object.kind == "PodDisruptionBudget"
  input.review.object.spec.maxUnavailable == 0
  msg := "PodDisruptionBudget with maxUnavailable 0 blocks all evictions"
}
""")

_t("K8sStorageClass", {"allowedStorageClasses": ["standard", "ssd"]})("""package k8sstorageclass
violation[{"msg": msg}] {
  input.review.object.kind == "PersistentVolumeClaim"
  sc := input.review.object.spec.storageClassName
  allowed := {s | s := input.constraint.spec.parameters.allowedStorageClasses[_]}
  not allowed[sc]
  msg := sprintf("storageClassName <%v> is not allowed", [sc])
}
""")

_t("K8sRequiredResources", {"limits": ["cpu", "memory"],
                            "requests": ["cpu"]})("""package k8srequiredresources
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  field := input.constraint.spec.parameters.limits[_]
  not container.resources.limits[field]
  msg := sprintf("container <%v> has no resources.limits.%v", [container.name, field])
}
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  field := input.constraint.spec.parameters.requests[_]
  not container.resources.requests[field]
  msg := sprintf("container <%v> has no resources.requests.%v", [container.name, field])
}
""")

_t("K8sPriorityClass", {"allowed": ["system-cluster-critical",
                                    "high", "default"]})("""package k8spriorityclass
violation[{"msg": msg}] {
  input.review.object.kind == "Pod"
  pc := input.review.object.spec.priorityClassName
  allowed := {p | p := input.constraint.spec.parameters.allowed[_]}
  not allowed[pc]
  msg := sprintf("priorityClassName <%v> is not allowed", [pc])
}
""")

_t("K8sImagePullSecrets", {})("""package k8simagepullsecrets
violation[{"msg": msg}] {
  input.review.object.kind == "Pod"
  not input.review.object.spec.imagePullSecrets
  msg := "pod must specify imagePullSecrets"
}
violation[{"msg": msg}] {
  input.review.object.kind == "Pod"
  count(input.review.object.spec.imagePullSecrets) == 0
  msg := "pod must specify at least one imagePullSecret"
}
""")


_t("K8sProhibitRoleWildcardAccess", {})("""package k8sprohibitrolewildcardaccess
violation[{"msg": msg}] {
  rule := input.review.object.rules[_]
  verb := rule.verbs[_]
  verb == "*"
  msg := sprintf("role <%v> grants wildcard verbs", [input.review.object.metadata.name])
}
violation[{"msg": msg}] {
  rule := input.review.object.rules[_]
  resource := rule.resources[_]
  resource == "*"
  msg := sprintf("role <%v> grants wildcard resources", [input.review.object.metadata.name])
}
violation[{"msg": msg}] {
  rule := input.review.object.rules[_]
  group := rule.apiGroups[_]
  group == "*"
  msg := sprintf("role <%v> grants wildcard apiGroups", [input.review.object.metadata.name])
}
""")

_t("K8sMemoryRequestEqualsLimit", {})("""package k8smemoryrequestequalslimit
canonify_mem(orig) = new { is_number(orig); new := orig }
else = new { new := units.parse_bytes(orig) }
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  req := canonify_mem(container.resources.requests.memory)
  lim := canonify_mem(container.resources.limits.memory)
  req != lim
  msg := sprintf("container <%v> memory request must equal its limit", [container.name])
}
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  container.resources.limits.memory
  not container.resources.requests.memory
  msg := sprintf("container <%v> sets a memory limit but no memory request", [container.name])
}
""")

_t("K8sContainerEnvMaxVars", {"max": 2})("""package k8scontainerenvmaxvars
violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  count(container.env) > input.constraint.spec.parameters.max
  msg := sprintf("container <%v> has more than %v env vars", [container.name, input.constraint.spec.parameters.max])
}
""")


def all_docs() -> list[tuple[dict, dict]]:
    """(template_doc, sample constraint_doc) for every library entry."""
    out = []
    for kind, (rego, params) in sorted(LIBRARY.items()):
        out.append((template_doc(kind, rego),
                    constraint_doc(kind, kind.lower() + "-sample", params)))
    return out
