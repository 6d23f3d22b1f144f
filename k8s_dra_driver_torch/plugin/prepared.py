"""The port of ``k8s_dra_driver_tpu/plugin/prepared.py`` (copied: the port imports
nothing of the JAX package).

Checkpointed prepared-claim model.

Mirror of cmd/nvidia-dra-plugin/prepared.go (205 LoC): JSON-serializable
groups of prepared devices, each group carrying the config state that was
applied to it, flattening to the kubelet-facing device list
(pool/device/CDI-ids triples).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from k8s_dra_driver_torch.kube import serde


@dataclass
class PreparedDevice:
    kind: str = ""  # tpu | subslice | membership
    name: str = ""
    pool: str = ""
    request: str = ""
    uuids: list[str] = field(default_factory=list)
    device_paths: list[str] = field(default_factory=list)
    cdi_device_ids: list[str] = field(default_factory=list)


@dataclass
class DeviceConfigState:
    """What was applied at Prepare time — enough to undo it at Unprepare
    (device_state.go's DeviceConfigState + sharing.go daemon bookkeeping)."""

    strategy: str = "Exclusive"
    env: dict[str, str] = field(default_factory=dict)
    # Disjoint per-consumer env slots (SpatialPartition): device name → env
    # overriding the group env in that device's CDI entry, so a 2-container
    # claim over 4 chips yields disjoint TPU_VISIBLE_DEVICES per container
    # (the MPS per-client division, sharing.go:346-366).
    per_device_env: dict[str, dict[str, str]] = field(default_factory=dict)
    # (host, container) bind mounts the sharing strategy needs in consumer
    # containers — the topology-daemon socket dir; the reference's MPS
    # equivalent bind-mounts pipe/shm dirs (sharing.go:346-366).  Stored as
    # 2-lists, not tuples: this struct round-trips through the JSON
    # checkpoint.
    mounts: list[list[str]] = field(default_factory=list)
    daemon_name: str = ""  # SpatialPartition topology-daemon Deployment name
    daemon_namespace: str = ""


@dataclass
class PreparedDeviceGroup:
    devices: list[PreparedDevice] = field(default_factory=list)
    config_state: DeviceConfigState = field(default_factory=DeviceConfigState)


@dataclass
class PreparedClaim:
    uid: str = ""
    namespace: str = ""
    name: str = ""
    groups: list[PreparedDeviceGroup] = field(default_factory=list)

    def flatten(self) -> list[dict]:
        """The gRPC NodePrepareResources per-claim response payload
        (device_state.go:316-321)."""
        return [
            {
                "pool_name": d.pool,
                "device_name": d.name,
                "request_names": [d.request] if d.request else [],
                "cdi_device_ids": d.cdi_device_ids,
            }
            for g in self.groups
            for d in g.devices
        ]

    def to_json(self) -> dict:
        return serde.to_json(self)

    @staticmethod
    def from_json(data: dict) -> "PreparedClaim":
        return serde.from_json(PreparedClaim, data)
