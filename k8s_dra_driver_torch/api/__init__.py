"""The port of ``k8s_dra_driver_tpu/api/__init__.py`` (copied: the port imports
nothing of the JAX package).

Opaque device-config API — ``resource.tpu.google.com/v1alpha1``.

TPU-native mirror of ``api/nvidia.com/resource/gpu/v1alpha1`` (SURVEY.md §2.1):
the config kinds users embed in ResourceClaim opaque parameters, a strict
decoder, and Normalize/Validate.  GPU sharing strategies map to TPU semantics:

* ``Exclusive`` — whole device, the TPU default (a chip cannot be preemptively
  time-sliced by libtpu, so unlike the reference's TimeSlicing default —
  gpuconfig.go:40-75 — exclusivity is the sane zero-config behavior).
* ``TimeSlicing`` — cooperative queued multiplexing of one chip between
  containers (documented gap vs CUDA's preemptive compute-policy timeslice,
  SURVEY.md §2.10).
* ``SpatialPartition`` — the MPS analog: a host's chips subdivided among
  containers via ``TPU_PROCESS_BOUNDS``/``TPU_VISIBLE_CHIPS`` env plus
  per-partition HBM limits (sharing.go:63-89's MpsConfig re-imagined).
"""

from k8s_dra_driver_torch.api.sharing import (
    ErrInvalidDeviceSelector,
    ErrInvalidLimit,
    HbmLimits,
    SharingStrategy,
    SpatialPartitionConfig,
    TimeSlicingConfig,
    TimeSliceInterval,
    TpuSharing,
)
from k8s_dra_driver_torch.api.tpuconfig import (
    SliceGroupConfig,
    SliceMembershipConfig,
    SubsliceConfig,
    TpuConfig,
    default_subslice_config,
    default_tpu_config,
)
from k8s_dra_driver_torch.api.decoder import API_GROUP, API_VERSION, Decoder, DecodeError

__all__ = [
    "API_GROUP",
    "API_VERSION",
    "Decoder",
    "DecodeError",
    "ErrInvalidDeviceSelector",
    "ErrInvalidLimit",
    "HbmLimits",
    "SharingStrategy",
    "SliceGroupConfig",
    "SliceMembershipConfig",
    "SpatialPartitionConfig",
    "SubsliceConfig",
    "TimeSliceInterval",
    "TimeSlicingConfig",
    "TpuConfig",
    "TpuSharing",
    "default_subslice_config",
    "default_tpu_config",
]
