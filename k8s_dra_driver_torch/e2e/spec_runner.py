"""The port of ``k8s_dra_driver_tpu/e2e/spec_runner.py`` (lines 1-220; copied: the port
imports nothing of the JAX package).

Apply quickstart YAML specs to the closed-loop cluster.

``kubectl apply -f tpu-test*.yaml`` simulator: walks the documents, creates
claims/templates, expands Deployments into pods, schedules each pod (first
node where the claim allocates, honoring one-per-host anti-affinity), runs
NodePrepareResources, and records the env each container would receive.  This
is what turns demo/specs/quickstart/ into executable integration tests — the
reference can only check these by reading pod logs on a real cluster
(SURVEY.md §4.3)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import yaml

from k8s_dra_driver_torch.e2e.harness import Cluster
from k8s_dra_driver_torch.kube import objects, serde
from k8s_dra_driver_torch.kube.objects import (
    ObjectMeta,
    ResourceClaim,
    ResourceClaimSpec,
)
from k8s_dra_driver_torch.scheduler.allocator import AllocationError


@dataclass
class RunningPod:
    name: str
    namespace: str
    node: str
    claim_names: list[str]
    devices: list[dict]
    env: dict[str, str] = field(default_factory=dict)


class SpecError(RuntimeError):
    pass


def apply_spec(cluster: Cluster, path: str | Path) -> list[RunningPod]:
    docs = [d for d in yaml.safe_load_all(Path(path).read_text()) if d]
    templates: dict[tuple[str, str], dict] = {}
    pods: list[dict] = []

    for doc in docs:
        kind = doc.get("kind")
        ns = doc.get("metadata", {}).get("namespace", "default")
        name = doc.get("metadata", {}).get("name", "")
        if kind == "Namespace":
            continue
        if kind == "ResourceClaimTemplate":
            templates[(ns, name)] = doc["spec"]["spec"]
        elif kind == "ResourceClaim":
            cluster.server.create(
                ResourceClaim(
                    metadata=ObjectMeta(name=name, namespace=ns),
                    spec=serde.from_json(ResourceClaimSpec, doc["spec"]),
                )
            )
        elif kind == "Pod":
            pods.append(doc)
        elif kind == "Deployment":
            pods.extend(_expand_workload(doc, doc["spec"].get("replicas", 1)))
        elif kind == "Job":
            # batch Jobs run `parallelism` pods of the same template (the
            # sharing-demo walkthrough uses one, reference
            # demo/specs/mig+mps/sharing-demo-job.yaml).
            pods.extend(_expand_workload(doc, doc["spec"].get("parallelism", 1)))
        else:
            raise SpecError(f"unhandled kind {kind!r} in {path}")

    return [_run_pod(cluster, pod, templates) for pod in pods]


def _expand_workload(doc: dict, replicas: int) -> list[dict]:
    ns = doc["metadata"]["namespace"]
    name = doc["metadata"]["name"]
    template = doc["spec"]["template"]
    out = []
    for i in range(replicas):
        pod = {
            "kind": "Pod",
            # template metadata first: the generated per-replica name (and
            # the workload's namespace) must win over any name the template
            # carries, or every replica collides on one pod name.
            "metadata": {**template.get("metadata", {}), "namespace": ns, "name": f"{name}-{i}"},
            "spec": template["spec"],
        }
        out.append(pod)
    return out


def _run_pod(cluster: Cluster, doc: dict, templates) -> RunningPod:
    ns = doc["metadata"].get("namespace", "default")
    pod_name = doc["metadata"]["name"]
    spec = doc["spec"]

    # Resolve the pod's resourceClaims (template instantiation mirrors the
    # resource-claim controller's `<pod>-<claimref>` naming — one shared
    # rule, harness.claim_name_for_ref).
    from k8s_dra_driver_torch.e2e.harness import claim_name_for_ref

    claim_names = []
    for ref in spec.get("resourceClaims", []):
        try:
            name = claim_name_for_ref(pod_name, ref)
        except ValueError as exc:
            raise SpecError(f"pod {pod_name}: {exc}") from exc
        if "resourceClaimTemplateName" in ref:
            tmpl = templates.get((ns, ref["resourceClaimTemplateName"]))
            if tmpl is None:
                raise SpecError(f"unknown template {ref['resourceClaimTemplateName']!r}")
            cluster.server.create(
                ResourceClaim(
                    metadata=ObjectMeta(name=name, namespace=ns),
                    spec=serde.from_json(ResourceClaimSpec, tmpl),
                )
            )
        claim_names.append(name)

    anti_affinity = "podAntiAffinity" in (spec.get("affinity") or {})
    node = _schedule(cluster, ns, pod_name, claim_names, anti_affinity)

    labels = {**doc["metadata"].get("labels", {}), "_scheduled_node": node}
    pod = objects.Pod(
        metadata=ObjectMeta(name=pod_name, namespace=ns, labels=labels),
        spec=spec,
    )
    pod = cluster.server.create(pod)

    devices: list[dict] = []
    env: dict[str, str] = {}
    reserved: list[str] = []
    try:
        for claim_name in claim_names:
            claim = cluster.server.get(ResourceClaim.KIND, claim_name, ns)
            # the scheduler reserves the claim for the consuming pod before
            # the kubelet prepares it (resource-claim controller semantics)
            claim = cluster.allocator.reserve(claim, pod.metadata.name, pod.metadata.uid)
            reserved.append(claim_name)
            devices.extend(cluster.nodes[node].state.prepare(claim))
            env.update(_claim_env(cluster, node, claim))
    except BaseException:
        # Unwind: a pod that never ran must not pin reservations (which the
        # deallocate guard would otherwise keep unfreeable) nor occupy an
        # anti-affinity slot.
        for claim_name in reserved:
            claim = cluster.server.get(ResourceClaim.KIND, claim_name, ns)
            claim = cluster.allocator.unreserve(claim, pod.metadata.uid)
            if not claim.status.reserved_for:
                cluster.nodes[node].state.unprepare(claim.metadata.uid)
        cluster.server.delete("Pod", pod_name, ns)
        raise

    pod.status.phase = "Running"
    cluster.server.update(pod)
    return RunningPod(
        name=pod_name, namespace=ns, node=node, claim_names=claim_names,
        devices=devices, env=env,
    )


def _schedule(cluster, ns, pod_name, claim_names, anti_affinity: bool) -> str:
    """Minimal scheduler: pick the first node where every claim allocates.
    Already-allocated claims pin the pod to their node."""
    # Pinned by a pre-allocated shared claim?
    for claim_name in claim_names:
        claim = cluster.server.get(ResourceClaim.KIND, claim_name, ns)
        if claim.status.allocation and claim.status.allocation.node_selector:
            for term in claim.status.allocation.node_selector.node_selector_terms:
                for req in term.match_expressions:
                    if req.key == "kubernetes.io/hostname" and req.values:
                        return req.values[0]

    used_nodes = {
        p.metadata.labels.get("_scheduled_node")
        for p in cluster.server.list("Pod", namespace=ns)
    } if anti_affinity else set()

    last_error = None
    for node_name in cluster.nodes:
        if anti_affinity and node_name in used_nodes:
            continue
        allocated_here: list[str] = []
        try:
            for claim_name in claim_names:
                claim = cluster.server.get(ResourceClaim.KIND, claim_name, ns)
                already = claim.status.allocation is not None
                cluster.allocator.allocate(
                    claim, node_name=node_name, node_labels=cluster.node_labels(node_name)
                )
                if not already:
                    allocated_here.append(claim_name)
            return node_name
        except AllocationError as exc:
            last_error = exc
            # all-or-nothing per pod: roll back this attempt's allocations
            for claim_name in allocated_here:
                claim = cluster.server.get(ResourceClaim.KIND, claim_name, ns)
                cluster.allocator.deallocate(claim)
            continue
    reason = last_error or "no eligible node (anti-affinity excluded all nodes)"
    raise SpecError(f"pod {ns}/{pod_name} is unschedulable: {reason}")


def _claim_env(cluster, node, claim) -> dict[str, str]:
    state = cluster.nodes[node].state
    spec_path = state.cdi.claim_spec_path(claim.metadata.uid)
    if not spec_path.exists():
        return {}
    spec = json.loads(spec_path.read_text())
    env: dict[str, str] = {}
    for dev in spec.get("devices", []):
        for kv in dev.get("containerEdits", {}).get("env", []):
            k, v = kv.split("=", 1)
            env[k] = v
    return env
