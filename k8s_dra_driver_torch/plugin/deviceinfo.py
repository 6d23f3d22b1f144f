"""The port of ``k8s_dra_driver_tpu/plugin/deviceinfo.py`` (copied: the port imports
nothing of the JAX package).

Device info structs and conversion to ``resourceapi.Device``.

Mirror of cmd/nvidia-dra-plugin/deviceinfo.go:30-223: typed per-kind info with
canonical names and a ``GetDevice``-style conversion that attaches the
attributes the DeviceClass/request CEL selectors match on, plus capacity
markers (the chip-overlap encoding, geometry.py).

Attribute names are published under the driver's domain, e.g.
``type``, ``uuid``, ``index``, ``productName``, ``tpuTopology``, ``coordX``…
— the TPU-native analog of productName/brand/architecture/
cudaComputeCapability (deviceinfo.go:98-223).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from k8s_dra_driver_torch.kube.objects import BasicDevice, Device, DeviceAttribute
from k8s_dra_driver_torch.kube.quantity import format_bytes
from k8s_dra_driver_torch.plugin.geometry import Subslice, chip_marker
from k8s_dra_driver_torch.tpuinfo.binding import ChipInfo, TopologyInfo

DEVICE_TYPE_CHIP = "tpu"
DEVICE_TYPE_SUBSLICE = "subslice"
DEVICE_TYPE_MEMBERSHIP = "membership"
DEVICE_TYPE_GROUP_SEAT = "slicegroup"
DEVICE_TYPE_CHANNEL = "interconnect"

_PRODUCT_NAMES = {
    "v4": "tpu-v4",
    "v5e": "tpu-v5e",
    "v5p": "tpu-v5p",
    "v6e": "tpu-v6e",
}


def chip_device_name(index: int) -> str:
    """Canonical chip device name (``gpu-%d`` analog, deviceinfo.go:74-78)."""
    return f"tpu-{index}"


@dataclass
class TpuChipInfo:
    chip: ChipInfo
    topology: TopologyInfo
    # Position of this chip in topology.chips (the host-block row-major order
    # geometry.Subslice.chip_indices refers to).  Distinct from chip.index,
    # which is the /dev/accelN number and may be gapped/non-zero-based on real
    # hosts — overlap markers must use the positional index.
    local_pos: int = 0

    @property
    def name(self) -> str:
        return chip_device_name(self.chip.index)

    @property
    def uuid(self) -> str:
        return self.chip.uuid

    def common_attributes(self) -> dict[str, DeviceAttribute]:
        t = self.topology
        return {
            "productName": DeviceAttribute.of(_PRODUCT_NAMES.get(t.generation, t.generation)),
            "generation": DeviceAttribute.of(t.generation),
            "tpuTopology": DeviceAttribute.of(t.topology),
            "hostId": DeviceAttribute.of(t.host_id),
            "hostCount": DeviceAttribute.of(t.host_count),
            "driverVersion": DeviceAttribute(version=_semverish(t.driver_version)),
            "libtpuVersion": DeviceAttribute.of(t.libtpu_version),
        }

    def get_device(self) -> Device:
        c = self.chip
        attrs = {
            "type": DeviceAttribute.of(DEVICE_TYPE_CHIP),
            "uuid": DeviceAttribute.of(c.uuid),
            "index": DeviceAttribute.of(c.index),
            # Health surfaces as an attribute so DeviceClass CEL gates on it
            # (the k8s-idiomatic mechanism: publish truth, select in class).
            "healthy": DeviceAttribute.of(bool(c.healthy)),
            # Why, when unhealthy: pci-disabled | aer-fatal |
            # node-unopenable | fault-injected — operators/CEL can
            # distinguish a fenced chip from a dead link.
            **(
                {"healthReason": DeviceAttribute.of(c.health_reason)}
                if c.health_reason
                else {}
            ),
            "coordX": DeviceAttribute.of(c.coords[0]),
            "coordY": DeviceAttribute.of(c.coords[1]),
            "coordZ": DeviceAttribute.of(c.coords[2]),
            "cores": DeviceAttribute.of(c.cores),
            "pcieAddress": DeviceAttribute.of(c.pci_address),
            **self.common_attributes(),
        }
        capacity = {
            "hbm": format_bytes(c.hbm_bytes),
            # Overlap marker shared with every subslice covering this chip.
            chip_marker(self.local_pos): "1",
        }
        return Device(name=self.name, basic=BasicDevice(attributes=attrs, capacity=capacity))


@dataclass
class TpuSubsliceInfo:
    subslice: Subslice
    topology: TopologyInfo

    @property
    def name(self) -> str:
        return self.subslice.name(self.topology.ndims)

    @property
    def uuid(self) -> str:
        # A subslice is identified by its member chips.
        return "+".join(self.chip_uuids())

    def chip_uuids(self) -> list[str]:
        # chip_indices are positions into topology.chips (geometry.py).
        return [self.topology.chips[i].uuid for i in self.subslice.chip_indices]

    def get_device(self) -> Device:
        s = self.subslice
        t = self.topology
        chips = [t.chips[i] for i in s.chip_indices]
        unhealthy = [c for c in chips if not c.healthy]
        attrs = {
            "type": DeviceAttribute.of(DEVICE_TYPE_SUBSLICE),
            "uuid": DeviceAttribute.of(self.uuid),
            "healthy": DeviceAttribute.of(not unhealthy),
            # Same reason surface as per-chip devices (first bad chip wins);
            # claims bind at this granularity, so the reason must exist here.
            **(
                {"healthReason": DeviceAttribute.of(unhealthy[0].health_reason)}
                if unhealthy and unhealthy[0].health_reason
                else {}
            ),
            "shape": DeviceAttribute.of(s.shape_name(t.ndims)),
            "chipCount": DeviceAttribute.of(s.chip_count),
            "originX": DeviceAttribute.of(s.origin[0]),
            "originY": DeviceAttribute.of(s.origin[1]),
            "originZ": DeviceAttribute.of(s.origin[2]),
            **TpuChipInfo(chips[0], t).common_attributes(),
        }
        capacity = {"hbm": format_bytes(sum(c.hbm_bytes for c in chips))}
        for i in s.chip_indices:
            capacity[chip_marker(i)] = "1"
        return Device(name=self.name, basic=BasicDevice(attributes=attrs, capacity=capacity))


@dataclass
class SliceMembershipInfo:
    """One multi-host slice-membership seat (IMEX-channel analog).

    Published by the cluster controller per slice domain
    (cmd/nvidia-dra-controller/imex.go:371-416's channel pool), claimed by
    pods that need a worker id + coordinator wiring on that slice.
    """

    domain: str
    worker_id: int
    host_count: int = 0
    coordinator_address: str = ""

    @property
    def name(self) -> str:
        return f"membership-{self.worker_id}"

    @property
    def uuid(self) -> str:
        return f"{self.domain}/worker-{self.worker_id}"

    def get_device(self) -> Device:
        attrs = {
            "type": DeviceAttribute.of(DEVICE_TYPE_MEMBERSHIP),
            "uuid": DeviceAttribute.of(self.uuid),
            "sliceDomain": DeviceAttribute.of(self.domain),
            "workerId": DeviceAttribute.of(self.worker_id),
            "hostCount": DeviceAttribute.of(self.host_count),
            "coordinatorAddress": DeviceAttribute.of(self.coordinator_address),
        }
        return Device(name=self.name, basic=BasicDevice(attributes=attrs))


@dataclass
class SliceGroupSeatInfo:
    """One multi-SLICE group seat — the next scale up from
    :class:`SliceMembershipInfo` (GKE multislice over DCN, where the
    reference's IMEX domain pattern tops out at one NVLink domain,
    cmd/nvidia-dra-controller/imex.go:371-416).

    Published by the cluster controller per slice GROUP: a group joins
    several slice domains into one job, and each member domain gets one
    seat PER HOST (allocation granularity — every pod binds its own),
    all carrying the domain's ordinal (``slice_id``), the group fan-out
    (``num_slices``), and the cross-slice (DCN) coordinator — the
    MEGASCALE wiring a multislice JAX process needs.  A pod claims its
    slice's membership seat (intra-slice ICI wiring) AND a group seat of
    its slice (cross-slice DCN wiring); the two compose.  The pool is
    per-(group, domain) and node-selected on BOTH labels, so allocation
    can only hand a pod its own slice's identity.
    """

    group: str
    domain: str
    slice_id: int
    num_slices: int
    worker_id: int = 0
    host_count: int = 0
    coordinator_address: str = ""

    @property
    def name(self) -> str:
        return f"groupseat-{self.slice_id}-{self.worker_id}"

    @property
    def uuid(self) -> str:
        return f"{self.group}/slice-{self.slice_id}/worker-{self.worker_id}"

    def get_device(self) -> Device:
        attrs = {
            "type": DeviceAttribute.of(DEVICE_TYPE_GROUP_SEAT),
            "uuid": DeviceAttribute.of(self.uuid),
            "sliceGroup": DeviceAttribute.of(self.group),
            "sliceDomain": DeviceAttribute.of(self.domain),
            "sliceId": DeviceAttribute.of(self.slice_id),
            "numSlices": DeviceAttribute.of(self.num_slices),
            "workerId": DeviceAttribute.of(self.worker_id),
            "hostCount": DeviceAttribute.of(self.host_count),
            "coordinatorAddress": DeviceAttribute.of(self.coordinator_address),
        }
        return Device(name=self.name, basic=BasicDevice(attributes=attrs))


@dataclass
class InterconnectChannelInfo:
    """One KV-handoff interconnect channel — the transfer path between a
    prefill pool and a decode pool published as a first-class claimable
    device (the Kubernetes Network Driver Model pattern: network/transfer
    capacity modeled like any other DRA resource).  The serving layer
    binds a ``models.disagg.HandoffChannel`` to the claim
    (``ChannelClaim.from_daemon_info``), so the scheduler sizes transfer
    capacity exactly like chips and subslices."""

    channel_name: str = "ici-0"
    bandwidth_gbps: float = 100.0
    max_in_flight_bytes: int = 64 * 1024 * 1024
    transfer_deadline_ms: int = 250

    @property
    def name(self) -> str:
        return f"channel-{self.channel_name}"

    @property
    def uuid(self) -> str:
        return f"interconnect/{self.channel_name}"

    def get_device(self) -> Device:
        attrs = {
            "type": DeviceAttribute.of(DEVICE_TYPE_CHANNEL),
            "uuid": DeviceAttribute.of(self.uuid),
            "channelName": DeviceAttribute.of(self.channel_name),
            "bandwidthGbps": DeviceAttribute.of(int(self.bandwidth_gbps)),
            "transferDeadlineMs": DeviceAttribute.of(self.transfer_deadline_ms),
        }
        capacity = {"inFlightBytes": format_bytes(self.max_in_flight_bytes)}
        return Device(name=self.name, basic=BasicDevice(attributes=attrs, capacity=capacity))

    def to_info(self) -> dict:
        """The topology daemon's info-doc form — the dict
        ``models.disagg.ChannelClaim.from_daemon_info`` consumes."""
        return {
            "name": self.channel_name,
            "bandwidth_gbps": self.bandwidth_gbps,
            "max_in_flight_bytes": self.max_in_flight_bytes,
            "transfer_deadline_s": self.transfer_deadline_ms / 1000.0,
        }


def _semverish(version: str) -> str:
    """Coerce free-form driver versions into the semver the `version`
    attribute type requires (deviceinfo.go stamps driverVersion similarly)."""
    digits = [p for p in version.replace("-", ".").split(".") if p.isdigit()]
    while len(digits) < 3:
        digits.append("0")
    return ".".join(digits[:3])


@dataclass
class AllocatableDevice:
    """Tagged union over publishable device kinds
    (cmd/nvidia-dra-plugin/allocatable.go:25-108)."""

    chip: TpuChipInfo | None = None
    subslice: TpuSubsliceInfo | None = None
    membership: SliceMembershipInfo | None = None
    group_seat: SliceGroupSeatInfo | None = None
    channel: InterconnectChannelInfo | None = None

    @property
    def kind(self) -> str:
        if self.chip is not None:
            return DEVICE_TYPE_CHIP
        if self.subslice is not None:
            return DEVICE_TYPE_SUBSLICE
        if self.membership is not None:
            return DEVICE_TYPE_MEMBERSHIP
        if self.group_seat is not None:
            return DEVICE_TYPE_GROUP_SEAT
        if self.channel is not None:
            return DEVICE_TYPE_CHANNEL
        raise ValueError("empty AllocatableDevice")

    @property
    def impl(self):
        return (
            self.chip or self.subslice or self.membership
            or self.group_seat or self.channel
        )

    @property
    def name(self) -> str:
        return self.impl.name

    def uuids(self) -> list[str]:
        if self.subslice is not None:
            return self.subslice.chip_uuids()
        return [self.impl.uuid]

    def get_device(self) -> Device:
        return self.impl.get_device()


@dataclass
class AllocatableDevices:
    """Name-indexed collection of everything this node publishes."""

    devices: dict[str, AllocatableDevice] = field(default_factory=dict)

    @staticmethod
    def from_topology(
        topology: TopologyInfo, layout=None, visible=None
    ) -> "AllocatableDevices":
        """``layout`` (plugin.parted.SubsliceLayout) restricts which subslice
        shapes publish — the out-of-band tpu-parted partitioning; chips
        always publish.

        ``visible`` (set of LOCAL chip positions, or None = all) masks the
        published inventory to a subset of the host's chips — the nvkind
        params-masking analog (reference values.yaml:41-48 /
        kubeletplugin.yaml:58-67), so several kind workers on one host can
        each own a disjoint share.  Positions keep their true local index
        (chip markers and CDI paths must stay aligned with the hardware),
        and a subslice publishes only when EVERY member chip is visible.
        """
        from k8s_dra_driver_torch.plugin.geometry import enumerate_subslices

        out: dict[str, AllocatableDevice] = {}
        for pos, chip in enumerate(topology.chips):
            if visible is not None and pos not in visible:
                continue
            info = TpuChipInfo(chip, topology, local_pos=pos)
            out[info.name] = AllocatableDevice(chip=info)
        for sub in enumerate_subslices(topology):
            if layout is not None and not layout.allows(sub.shape_name(topology.ndims)):
                continue
            if visible is not None and not set(sub.chip_indices) <= visible:
                continue
            info = TpuSubsliceInfo(sub, topology)
            out[info.name] = AllocatableDevice(subslice=info)
        return AllocatableDevices(out)

    def __iter__(self):
        return iter(self.devices.values())

    def __len__(self):
        return len(self.devices)

    def get_devices(self) -> list[Device]:
        return [d.get_device() for d in self]
