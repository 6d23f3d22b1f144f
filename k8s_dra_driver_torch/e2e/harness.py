"""The port of ``k8s_dra_driver_tpu/e2e/harness.py`` (lines 1-246; copied: the port
imports nothing of the JAX package).

In-process cluster harness used by tests, the demo and bench.py."""

from __future__ import annotations

import tempfile
from dataclasses import dataclass, field

from k8s_dra_driver_torch import DRIVER_NAME
from k8s_dra_driver_torch.kube.fakeserver import InMemoryAPIServer
from k8s_dra_driver_torch.kube.objects import (
    CELDeviceSelector,
    Deployment,
    DeviceClaim,
    DeviceClass,
    DeviceClassSpec,
    DeviceRequest,
    DeviceSelector,
    Node,
    ObjectMeta,
    ResourceClaim,
    ResourceClaimSpec,
)
from k8s_dra_driver_torch.plugin.device_state import DeviceState
from k8s_dra_driver_torch.scheduler.allocator import Allocator
from k8s_dra_driver_torch.utils.journal import JOURNAL

TPU_CLASS = "tpu.google.com"
SUBSLICE_CLASS = "subslice.tpu.google.com"
MEMBERSHIP_CLASS = "membership.tpu.google.com"
SLICEGROUP_CLASS = "slicegroup.tpu.google.com"

_CLASS_SELECTORS = {
    TPU_CLASS: "tpu",
    SUBSLICE_CLASS: "subslice",
    MEMBERSHIP_CLASS: "membership",
    SLICEGROUP_CLASS: "slicegroup",
}

# Hardware classes additionally require the device to be healthy; membership
# seats are logical and carry no health attribute.
_HEALTH_GATED = {TPU_CLASS, SUBSLICE_CLASS}


def cel_selector(expr: str) -> DeviceSelector:
    return DeviceSelector(cel=CELDeviceSelector(expression=expr))


def install_device_classes(server: InMemoryAPIServer) -> None:
    """The DeviceClasses the helm chart ships (templates/deviceclasses.yaml,
    SURVEY.md §2.6), selecting on driver + type attribute."""
    for name, devtype in _CLASS_SELECTORS.items():
        expr = (
            f"device.driver == '{DRIVER_NAME}' && "
            f"device.attributes['{DRIVER_NAME}'].type == '{devtype}'"
        )
        if name in _HEALTH_GATED:
            expr += f" && device.attributes['{DRIVER_NAME}'].healthy == true"
        server.create(
            DeviceClass(
                metadata=ObjectMeta(name=name),
                spec=DeviceClassSpec(selectors=[cel_selector(expr)]),
            )
        )


@dataclass
class FakeNode:
    name: str
    state: DeviceState


@dataclass
class Cluster:
    """A fake cluster with N TPU hosts running the real plugin stack."""

    server: InMemoryAPIServer
    nodes: dict[str, FakeNode] = field(default_factory=dict)
    allocator: Allocator = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.allocator is None:
            self.allocator = Allocator(self.server)

    def node_labels(self, name: str) -> dict[str, str]:
        node = self.server.get(Node.KIND, name)
        return dict(node.metadata.labels)

    def schedule_and_prepare(self, claim: ResourceClaim, node_name: str) -> list[dict]:
        """The §3.2 hot path: allocate (scheduler) then Prepare (kubelet)."""
        JOURNAL.record(
            "e2e", "schedule_and_prepare", correlation=claim.metadata.uid,
            claim=claim.metadata.name, node=node_name,
        )
        allocated = self.allocator.allocate(
            claim, node_name=node_name, node_labels=self.node_labels(node_name)
        )
        return self.nodes[node_name].state.prepare(allocated)

    def unprepare_and_deallocate(self, claim: ResourceClaim, node_name: str) -> None:
        """Direct teardown for unreserved claims; a claim with live consumers
        must go through delete_pod (fail fast BEFORE any side effect so no
        half-torn state is left behind)."""
        current = self.server.get(
            ResourceClaim.KIND, claim.metadata.name, claim.metadata.namespace
        )
        if current.status.reserved_for:
            raise RuntimeError(
                f"claim {claim.metadata.name!r} has consumers "
                f"{[r.name for r in current.status.reserved_for]}; delete the pods"
            )
        JOURNAL.record(
            "e2e", "unprepare_and_deallocate", correlation=claim.metadata.uid,
            claim=claim.metadata.name, node=node_name,
        )
        self.nodes[node_name].state.unprepare(claim.metadata.uid)
        self.allocator.deallocate(current)

    def delete_pod(self, name: str, namespace: str = "default") -> None:
        """Pod teardown with resource-claim-controller semantics: unreserve,
        and only when the LAST consumer goes do unprepare + deallocate run
        (shared-claim lifecycle, gpu-test3 pattern)."""
        pod = self.server.get("Pod", name, namespace)
        node = pod.metadata.labels.get("_scheduled_node", "")
        JOURNAL.record(
            "e2e", "delete_pod", correlation=pod.metadata.uid,
            pod=name, node=node,
        )
        for ref in (pod.spec or {}).get("resourceClaims", []):
            claim = self.server.get(
                ResourceClaim.KIND, claim_name_for_ref(name, ref), namespace
            )
            claim = self.allocator.unreserve(claim, pod.metadata.uid)
            if not claim.status.reserved_for:
                if node in self.nodes:
                    self.nodes[node].state.unprepare(claim.metadata.uid)
                self.allocator.deallocate(claim)
        self.server.delete("Pod", name, namespace)


def claim_name_for_ref(pod_name: str, ref: dict) -> str:
    """THE naming rule for a pod's claim reference: a direct claim keeps its
    name; a template instantiation is ``<pod>-<claimref>`` (the upstream
    resource-claim controller's generated-name convention).  Single source of
    truth shared by the spec runner (creation) and pod teardown."""
    if ref.get("resourceClaimName"):
        return ref["resourceClaimName"]
    if "name" not in ref:
        raise ValueError(f"malformed resourceClaims entry {ref}")
    return f"{pod_name}-{ref['name']}"


def make_cluster(
    hosts: int = 1,
    topology: str = "v5e-16",
    work_dir: str | None = None,
    slice_domain: str = "",
    daemon_controller: bool = True,
    slices: int = 1,
    slice_group: str = "",
) -> Cluster:
    """Build a cluster of ``hosts`` TPU hosts sharing one fake slice topology.

    Each host gets a Node object (labeled with the slice domain for the
    multi-host controller), a DeviceState whose plugin publishes its
    inventory, and its own cdi/checkpoint dirs under ``work_dir``.

    ``slices > 1`` splits the hosts evenly across that many slice DOMAINS
    (``{slice_domain}-{s}``, per-domain host ids), and ``slice_group``
    additionally labels every node with the multislice group — the GKE
    multislice provisioning shape the slice-GROUP controller watches.
    """
    from k8s_dra_driver_torch.plugin.driver import Driver, DriverConfig

    server = InMemoryAPIServer()
    install_device_classes(server)
    if daemon_controller:
        _install_daemon_controller(server)
    work_dir = work_dir or tempfile.mkdtemp(prefix="tpu-dra-e2e-")
    cluster = Cluster(server=server)
    if slices > 1 and hosts % slices:
        raise ValueError(f"{hosts} hosts do not split into {slices} slices")
    per_slice = hosts // slices
    for host_id in range(hosts):
        name = f"tpu-host-{host_id}"
        labels = {"kubernetes.io/hostname": name}
        if slice_domain:
            if slices > 1:
                labels["tpu.google.com/slice-domain"] = (
                    f"{slice_domain}-{host_id // per_slice}"
                )
                labels["tpu.google.com/slice-host-id"] = str(host_id % per_slice)
            else:
                labels["tpu.google.com/slice-domain"] = slice_domain
                labels["tpu.google.com/slice-host-id"] = str(host_id)
            if slice_group:
                labels["tpu.google.com/slice-group"] = slice_group
        server.create(Node(metadata=ObjectMeta(name=name, labels=labels)))
        driver = Driver(
            server,
            DriverConfig(
                node_name=name,
                cdi_root=f"{work_dir}/{name}/cdi",
                checkpoint_path=f"{work_dir}/{name}/checkpoint.json",
                topology_env={
                    "TPUINFO_FAKE_TOPOLOGY": topology,
                    "TPUINFO_FAKE_HOST_ID": str(host_id),
                },
                daemon_backoff_initial=0.001,
            ),
        )
        cluster.nodes[name] = FakeNode(name=name, state=driver.state)
    return cluster


def _install_daemon_controller(server: InMemoryAPIServer) -> None:
    def on_event(event):
        dep = event.object
        if event.type == "ADDED" and not (dep.status or {}).get("readyReplicas"):
            dep.status = {"readyReplicas": 1}
            server.update(dep)

    server.watch(Deployment.KIND, on_event)


def simple_claim(
    name: str,
    namespace: str = "default",
    device_class: str = TPU_CLASS,
    count: int = 1,
    selectors: list[str] = (),
) -> ResourceClaim:
    return ResourceClaim(
        metadata=ObjectMeta(name=name, namespace=namespace),
        spec=ResourceClaimSpec(
            devices=DeviceClaim(
                requests=[
                    DeviceRequest(
                        name="req",
                        device_class_name=device_class,
                        count=count,
                        selectors=[cel_selector(e) for e in selectors],
                    )
                ]
            )
        ),
    )
