"""The port of ``k8s_dra_driver_tpu/api/tpuconfig.py`` (copied: the port imports
nothing of the JAX package).

The three opaque config kinds (mirror of GpuConfig/MigDeviceConfig/
ImexChannelConfig — gpuconfig.go:30-75, migconfig.go:29-64,
imexchannelconfig.go:27-49)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from k8s_dra_driver_torch.api.sharing import SharingStrategy, TpuSharing


@dataclass
class TpuConfig:
    """Per-chip opaque config (GpuConfig analog)."""

    KIND = "TpuConfig"

    sharing: Optional[TpuSharing] = None

    def normalize(self) -> None:
        if self.sharing is None:
            self.sharing = TpuSharing()
        self.sharing.normalize()

    def validate(self) -> None:
        if self.sharing is None:
            raise ValueError("no sharing strategy set")
        self.sharing.validate()


@dataclass
class SubsliceConfig:
    """Per-ICI-subslice opaque config (MigDeviceConfig analog).

    Subslices are hardware-partitioned by geometry, so like MIG devices they
    allow sharing *within* the partition only; SpatialPartition of a subslice
    is rejected (a subslice is already a spatial partition), matching
    MigDeviceSharing's rejection of further partitioning semantics
    (sharing.go:103-122).
    """

    KIND = "SubsliceConfig"

    sharing: Optional[TpuSharing] = None

    def normalize(self) -> None:
        if self.sharing is None:
            self.sharing = TpuSharing()
        self.sharing.normalize()

    def validate(self) -> None:
        if self.sharing is None:
            raise ValueError("no sharing strategy set")
        if self.sharing.strategy == SharingStrategy.SPATIAL_PARTITION:
            raise ValueError("a subslice is already a spatial partition; "
                             "SpatialPartition sharing is not allowed on subslice devices")
        self.sharing.validate()


@dataclass
class SliceMembershipConfig:
    """Opaque config for multi-host slice-membership devices (ImexChannelConfig
    analog, imexchannelconfig.go:27-49).  Optional overrides for the JAX
    distributed-runtime wiring injected at Prepare time."""

    KIND = "SliceMembershipConfig"

    coordinator_port: Optional[int] = None
    megascale: Optional[bool] = None
    extra_env: dict[str, str] = field(default_factory=dict)

    def normalize(self) -> None:
        if self.coordinator_port is None:
            self.coordinator_port = 8476  # JAX distributed default

    def validate(self) -> None:
        if self.coordinator_port is not None and not 0 < self.coordinator_port < 65536:
            raise ValueError(f"coordinatorPort out of range: {self.coordinator_port}")
        for key in self.extra_env:
            if not key or key != key.upper() or not key.replace("_", "").isalnum():
                raise ValueError(f"extraEnv key {key!r} is not an UPPER_SNAKE env name")


@dataclass
class SliceGroupConfig:
    """Opaque config for multi-slice GROUP seats (the DCN scale above
    SliceMembershipConfig): optional overrides for the megascale wiring
    injected at Prepare time.  ``megascale_port`` is the DCN transport
    port each slice's coordinator listens on."""

    KIND = "SliceGroupConfig"

    megascale_port: Optional[int] = None
    extra_env: dict[str, str] = field(default_factory=dict)

    def normalize(self) -> None:
        if self.megascale_port is None:
            self.megascale_port = 8081  # megascale DCN transport default

    def validate(self) -> None:
        if self.megascale_port is not None and not 0 < self.megascale_port < 65536:
            raise ValueError(f"megascalePort out of range: {self.megascale_port}")
        for key in self.extra_env:
            if not key or key != key.upper() or not key.replace("_", "").isalnum():
                raise ValueError(f"extraEnv key {key!r} is not an UPPER_SNAKE env name")


def default_tpu_config() -> TpuConfig:
    """Lowest-precedence config applied when a claim carries none
    (device_state.go:210-221's defaults-insertion)."""
    cfg = TpuConfig(sharing=TpuSharing(strategy=SharingStrategy.EXCLUSIVE))
    cfg.normalize()
    return cfg


def default_subslice_config() -> SubsliceConfig:
    cfg = SubsliceConfig(sharing=TpuSharing(strategy=SharingStrategy.EXCLUSIVE))
    cfg.normalize()
    return cfg
