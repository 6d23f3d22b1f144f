"""The port of ``k8s_dra_driver_tpu/api/sharing.py`` (copied: the port imports
nothing of the JAX package).

Sharing model for TPU devices.

Behavioral mirror of api/nvidia.com/resource/gpu/v1alpha1/sharing.go (273 LoC,
SURVEY.md §2.1): strategies, timeslice intervals, the MPS-analog spatial
partition config, and per-device HBM-limit normalization with the same
uuid-or-index key resolution and typed errors
(sharing.go:182-273's ``MpsPerDevicePinnedMemoryLimit.Normalize``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

from k8s_dra_driver_torch.kube import quantity


class ErrInvalidDeviceSelector(ValueError):
    """A per-device key is neither a valid index nor a known device UUID."""


class ErrInvalidLimit(ValueError):
    """A per-device HBM limit is malformed or below the 1Mi minimum."""


class SharingStrategy(str, enum.Enum):
    EXCLUSIVE = "Exclusive"
    TIME_SLICING = "TimeSlicing"
    SPATIAL_PARTITION = "SpatialPartition"


class TimeSliceInterval(str, enum.Enum):
    """Named queue-multiplexing intervals (sharing.go:34-39,167-180).

    On GPUs these map to nvidia-smi compute-policy timeslice levels 0..3; on
    TPU they parameterize the cooperative scheduler quantum of the per-host
    topology daemon (libtpu has no preemptive timeslicing — documented gap,
    SURVEY.md §2.10).
    """

    DEFAULT = "Default"
    SHORT = "Short"
    MEDIUM = "Medium"
    LONG = "Long"

    def level(self) -> int:
        return {"Default": 0, "Short": 1, "Medium": 2, "Long": 3}[self.value]


@dataclass
class TimeSlicingConfig:
    interval: Optional[TimeSliceInterval] = None

    def normalize(self) -> None:
        if self.interval is None:
            self.interval = TimeSliceInterval.DEFAULT

    def validate(self) -> None:
        if not isinstance(self.interval, TimeSliceInterval):
            raise ValueError(f"unknown timeslice interval: {self.interval!r}")


_MIN_HBM_LIMIT = 1024 * 1024  # 1Mi, mirrors the reference's 1M floor


class HbmLimits(dict):
    """Per-device HBM limits keyed by device index ("0"), UUID, or "*".

    ``normalize(uuids)`` resolves every key to a UUID and every value to a
    canonical MiB string (e.g. "4096Mi"), exactly the shape the reference
    produces for CUDA_MPS pinned-memory limits (sharing.go:182-273).
    """

    def normalize(self, uuids: list[str]) -> dict[str, str]:
        out: dict[str, str] = {}
        uuid_set = set(uuids)
        for key, raw in self.items():
            try:
                limit = quantity.parse(raw)
            except quantity.InvalidQuantity as exc:
                raise ErrInvalidLimit(f"device {key!r}: {exc}") from exc
            if limit < _MIN_HBM_LIMIT:
                raise ErrInvalidLimit(f"device {key!r}: limit {raw!r} is below 1Mi")
            mib = f"{limit // (1024 * 1024)}Mi"
            targets: list[str]
            if key == "*":
                targets = uuids
            elif key in uuid_set:
                targets = [key]
            elif key.isdigit():
                index = int(key)
                if index >= len(uuids):
                    raise ErrInvalidDeviceSelector(
                        f"index {index} out of range for {len(uuids)} device(s)"
                    )
                targets = [uuids[index]]
            else:
                raise ErrInvalidDeviceSelector(f"unknown device selector {key!r}")
            for uuid in targets:
                # Explicit keys win over the "*" wildcard regardless of order.
                if key == "*" and uuid in out:
                    continue
                out[uuid] = mib
        return out


@dataclass
class SpatialPartitionConfig:
    """MPS-analog: subdivide a host's chips among containers.

    ``default_core_fraction`` mirrors DefaultActiveThreadPercentage,
    ``default_hbm_limit``/``per_device_hbm_limit`` mirror the pinned-memory
    limits (sharing.go:63-89).  Realized at Prepare time as
    ``TPU_PROCESS_BOUNDS``/``TPU_VISIBLE_CHIPS`` env plus
    ``XLA_PYTHON_CLIENT_MEM_FRACTION``-style HBM caps.
    """

    default_core_fraction: Optional[int] = None  # percent of TensorCores
    default_hbm_limit: Optional[str] = None
    per_device_hbm_limit: HbmLimits = field(default_factory=HbmLimits)

    def normalize(self) -> None:
        if self.default_core_fraction is None:
            self.default_core_fraction = 100
        if self.default_hbm_limit is not None and self.per_device_hbm_limit.get("*") is None:
            self.per_device_hbm_limit["*"] = self.default_hbm_limit

    def validate(self) -> None:
        if self.default_core_fraction is None:
            return  # not yet normalized; the default (100) is always valid
        if not 0 < self.default_core_fraction <= 100:
            raise ValueError(
                f"defaultCoreFraction must be in (0, 100], got {self.default_core_fraction}"
            )

    def normalized_limits(self, uuids: list[str]) -> dict[str, str]:
        return self.per_device_hbm_limit.normalize(uuids)


@dataclass
class TpuSharing:
    """Dispatch union over strategies (sharing.go:43-48's Sharing interface).

    Exactly one strategy-specific config may be present and it must match the
    strategy — the reference enforces the same mutual exclusion in
    GetTimeSlicingConfig/GetMpsConfig (sharing.go:124-165).
    """

    strategy: SharingStrategy = SharingStrategy.EXCLUSIVE
    time_slicing_config: Optional[TimeSlicingConfig] = None
    spatial_partition_config: Optional[SpatialPartitionConfig] = None

    def normalize(self) -> None:
        if self.strategy == SharingStrategy.TIME_SLICING:
            if self.time_slicing_config is None:
                self.time_slicing_config = TimeSlicingConfig()
            self.time_slicing_config.normalize()
        if self.strategy == SharingStrategy.SPATIAL_PARTITION:
            if self.spatial_partition_config is None:
                self.spatial_partition_config = SpatialPartitionConfig()
            self.spatial_partition_config.normalize()

    def validate(self) -> None:
        if not isinstance(self.strategy, SharingStrategy):
            raise ValueError(f"unknown sharing strategy: {self.strategy!r}")
        if self.strategy != SharingStrategy.TIME_SLICING and self.time_slicing_config:
            raise ValueError(f"timeSlicingConfig set but strategy is {self.strategy.value}")
        if self.strategy != SharingStrategy.SPATIAL_PARTITION and self.spatial_partition_config:
            raise ValueError(f"spatialPartitionConfig set but strategy is {self.strategy.value}")
        if self.time_slicing_config:
            self.time_slicing_config.validate()
        if self.spatial_partition_config:
            self.spatial_partition_config.validate()

    def get_time_slicing_config(self) -> Optional[TimeSlicingConfig]:
        if self.strategy != SharingStrategy.TIME_SLICING:
            return None
        return self.time_slicing_config

    def get_spatial_partition_config(self) -> Optional[SpatialPartitionConfig]:
        if self.strategy != SharingStrategy.SPATIAL_PARTITION:
            return None
        return self.spatial_partition_config
