"""The north-star audit workload: 3 templates x 67 constraints = 201
constraints over synthetic pods (copy of the JAX package's bench.py
``make_resources`` and ``setup_north_star``).

Resources carry a random subset of ten labels and one to three
containers with an image from four registries and cpu/memory limits; the
constraints are K8sRequiredLabels (two required labels each),
K8sAllowedRepos (two allowed registries each) and K8sContainerLimits
(a cpu and a memory ceiling each).
"""

from __future__ import annotations

from gatekeeper_tpu_torch.client.client import Backend
from gatekeeper_tpu_torch.library.templates import (LIBRARY, constraint_doc,
                                                    template_doc)
from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget

C_PER_KIND = 67
KINDS = ("K8sRequiredLabels", "K8sAllowedRepos", "K8sContainerLimits")


def make_resources(n, rng):
    label_pool = [f"l{j}" for j in range(10)]
    repos = ["gcr.io/org/", "docker.io/", "quay.io/team/", "ghcr.io/x/"]
    out = []
    for i in range(n):
        labels = {k: "v" for k in label_pool if rng.random() < 0.35}
        containers = [{
            "name": f"c{j}",
            "image": rng.choice(repos) + f"app{rng.randrange(50)}:{rng.randrange(9)}",
            "resources": {"limits": {
                "cpu": rng.choice(["100m", "250m", "1", "2", "4000m"]),
                "memory": rng.choice(["256Mi", "1Gi", "4Gi"])}},
        } for j in range(rng.randint(1, 3))]
        out.append({"apiVersion": "v1", "kind": "Pod",
                    "metadata": {"name": f"pod{i:07d}",
                                 "namespace": f"ns{i % 50}", "labels": labels},
                    "spec": {"containers": containers}})
    return out


def north_star_templates() -> list[dict]:
    """The north-star ConstraintTemplate documents, one a kind."""
    return [template_doc(kind, LIBRARY[kind][0]) for kind in KINDS]


def north_star_constraints(rng, c_per_kind: int = C_PER_KIND) -> list[dict]:
    """3 x ``c_per_kind`` constraint documents with parameters drawn from
    ``rng``, in the order ``setup_north_star`` installs them."""
    out = []
    for j in range(c_per_kind):
        out.append(constraint_doc(
            "K8sRequiredLabels", f"labels-{j:03d}",
            {"labels": rng.sample([f"l{x}" for x in range(10)], k=2)}))
        out.append(constraint_doc(
            "K8sAllowedRepos", f"repos-{j:03d}",
            {"repos": rng.sample(["gcr.io/", "docker.io/", "quay.io/",
                                  "ghcr.io/"], k=2)}))
        out.append(constraint_doc(
            "K8sContainerLimits", f"cpu-{j:03d}",
            {"cpu": rng.choice(["500m", "1", "2"]),
             "memory": rng.choice(["512Mi", "2Gi"])}))
    return out


def setup_north_star(driver, resources, rng, c_per_kind: int = C_PER_KIND):
    """A client over ``driver`` with the north-star templates, 3 x
    ``c_per_kind`` constraints drawn from ``rng``, and ``resources``."""
    client = Backend(driver).new_client([K8sValidationTarget()])
    for doc in north_star_templates():
        client.add_template(doc)
    for doc in north_star_constraints(rng, c_per_kind):
        client.add_constraint(doc)
    client.add_data_batch(resources)
    return client
