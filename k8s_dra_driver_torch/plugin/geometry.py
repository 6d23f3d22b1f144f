"""The port of ``k8s_dra_driver_tpu/plugin/geometry.py`` (copied: the port imports
nothing of the JAX package).

ICI subslice geometry — the TPU-native reimagining of MIG profiles.

The reference publishes every placeable MIG profile as its own device and
encodes placement overlap in ``memorySlice%d`` capacity markers so the
scheduler cannot double-book a GPU memory slice
(cmd/nvidia-dra-plugin/deviceinfo.go:199-204, SURVEY.md §2.10).  Here the
partitionable resource is the host-local ICI mesh block: every valid subslice
shape × aligned placement becomes a device, and every covered chip contributes
a ``chip%d`` capacity marker.  Two devices that share a chip therefore share a
marker and can never be allocated together (enforced by the structured
allocator's counter semantics, scheduler/allocator.py).

Shape tables are per-generation: v5e/v6e have a 2D ICI mesh, v4/v5p a 3D
torus (host-local blocks are 2x2 resp. 2x2x1 — see tpuinfo/cpp/tpuinfo.cc).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

from k8s_dra_driver_torch.tpuinfo.binding import TopologyInfo

# Candidate per-dimension extents for subslice shapes (powers of two, the only
# granularities the ICI switch fabric supports for partitioned meshes).
_EXTENTS = (1, 2, 4, 8)


@dataclass(frozen=True)
class Subslice:
    """A placed subslice of the host-local mesh block.

    ``origin``/``shape`` are in global mesh coordinates; ``chip_indices`` are
    local chip indices (the order add_local_chips uses: x fastest, then y,
    then z).
    """

    shape: tuple[int, int, int]
    origin: tuple[int, int, int]
    chip_indices: tuple[int, ...]

    @property
    def chip_count(self) -> int:
        return len(self.chip_indices)

    def shape_name(self, ndims: int) -> str:
        return "x".join(str(d) for d in self.shape[:ndims])

    def name(self, ndims: int) -> str:
        loc = "-".join(str(c) for c in self.origin[:ndims])
        return f"tpu-slice-{self.shape_name(ndims)}-{loc}"


def _local_index(x: int, y: int, z: int, host_bounds: tuple[int, int, int]) -> int:
    return x + y * host_bounds[0] + z * host_bounds[0] * host_bounds[1]


def host_origin(topology: TopologyInfo) -> tuple[int, int, int]:
    """Global coords of the local host block's (0,0,0) corner."""
    first = min(topology.chips, key=lambda c: (c.coords[2], c.coords[1], c.coords[0]))
    return first.coords


def enumerate_subslices(topology: TopologyInfo, include_single_chip: bool = False) -> list[Subslice]:
    """All valid subslice placements within the local host block.

    Placements are shape-aligned (origin is a multiple of the shape extent in
    every dimension), mirroring how MIG placements sit at fixed memory-slice
    offsets.  Single-chip (1x1[x1]) subslices duplicate the per-chip devices
    and are excluded by default.
    """
    hb = topology.host_bounds
    ndims = topology.ndims
    origin0 = host_origin(topology)

    shapes = []
    for extents in itertools.product(*(
        [e for e in _EXTENTS if e <= hb[d]] if d < ndims else [1] for d in range(3)
    )):
        if not include_single_chip and extents[0] * extents[1] * extents[2] <= 1:
            continue
        shapes.append(extents)

    out = []
    for shape in shapes:
        for oz in range(0, hb[2] - shape[2] + 1, shape[2]):
            for oy in range(0, hb[1] - shape[1] + 1, shape[1]):
                for ox in range(0, hb[0] - shape[0] + 1, shape[0]):
                    chips = tuple(
                        _local_index(x, y, z, hb)
                        for z in range(oz, oz + shape[2])
                        for y in range(oy, oy + shape[1])
                        for x in range(ox, ox + shape[0])
                    )
                    out.append(
                        Subslice(
                            shape=shape,
                            origin=(origin0[0] + ox, origin0[1] + oy, origin0[2] + oz),
                            chip_indices=chips,
                        )
                    )
    return out


def chip_marker(local_index: int) -> str:
    """Capacity-marker name for one chip (the memorySlice%d analog)."""
    return f"chip{local_index}"
