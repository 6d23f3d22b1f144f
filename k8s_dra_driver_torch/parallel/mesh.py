"""Device meshes over ``torch.distributed`` ranks
(``k8s_dra_driver_tpu/parallel/mesh.py``).

The reference builds a ``jax.sharding.Mesh`` over devices that one process
drives.  The port is multi-controller: one process per rank, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks with the
reference's axis names as its ``mesh_dim_names``.  Ranks are laid out in the
reference's reshape order, so rank r sits where device r sits in the JAX
mesh; each axis's process group is ``mesh.get_group(name)``.  Every rank of
the world builds the same mesh (each axis's groups are made collectively).

:func:`shard` is the counterpart of a ``PartitionSpec``: it cuts a full
tensor into this rank's block by a spec written like the reference's
(``("data", "seq", None, None)``; an entry may be a tuple of axes, the
first outermost).  :func:`gather` is its inverse through all-gathers, and
:func:`unshard` reassembles the blocks of every rank on one host (tests).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

AXES = ("pipe", "data", "seq", "model")
MULTISLICE_AXES = ("slice",) + AXES


class PartitionSpec(tuple):
    """A spec like the reference's ``PartitionSpec``: one entry per leading
    dim, each None, an axis name or a tuple of axis names.  A tuple of its
    own type, so a tree walk tells a spec from a list of leaves."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


P = PartitionSpec


@dataclass(frozen=True)
class MeshShape:
    data: int = 1
    seq: int = 1
    model: int = 1
    pipe: int = 1

    @property
    def total(self) -> int:
        return self.data * self.seq * self.model * self.pipe


def claimed_device_env() -> dict[str, str]:
    """The env the driver injects at Prepare: which chips are visible and
    the process-local bounds."""
    return {
        k: v
        for k, v in os.environ.items()
        if k.startswith("TPU_") or k.startswith("JAX_COORDINATOR")
    }


def auto_mesh_shape(n_devices: int, want_seq: bool = False) -> MeshShape:
    """Factor a rank count into (data, seq, model) as the reference does:
    model the largest of 4 and 2 that divides it, seq 2 when asked for and
    possible, data the rest."""
    model = 1
    for cand in (4, 2):
        if n_devices % cand == 0:
            model = cand
            break
    rest = n_devices // model
    seq = 2 if (want_seq and rest % 2 == 0) else 1
    data = rest // seq
    return MeshShape(data=data, seq=seq, model=model)


def check_backend(backend: str, world_size: int, device_type: str) -> None:
    """The port's backend rule: ``"gloo"`` or ``"nccl"``, chosen by the
    caller; NCCL refuses CPU tensors and two ranks on one card, so
    ``"nccl"`` needs CUDA and at least as many cards as ranks on a host."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if backend != "nccl":
        return
    if device_type != "cuda":
        raise ValueError("backend 'nccl' takes CUDA tensors only; use 'gloo' on the CPU")
    cards = torch.cuda.device_count()
    if world_size > cards:
        raise ValueError(
            f"backend 'nccl' needs one card per rank: {world_size} ranks on {cards} "
            f"card(s); use backend='gloo' to run several ranks on one card"
        )


# the card this process took by set_rank_card; None: it took none
_rank_card: int | None = None


def set_rank_card(card: int) -> None:
    """Take ``card`` as this process's current device and record it for
    :func:`rank_device`."""
    global _rank_card
    torch.cuda.set_device(card)
    _rank_card = card


def rank_device(device_type: str) -> torch.device:
    """This rank's device: the CPU, or the card this process took
    (:func:`set_rank_card`, which ``ranks.init_ranks`` and
    ``consumer.attach`` call); where it took none, ``cuda:{rank %
    cards}``."""
    if device_type == "cpu":
        return torch.device("cpu")
    if _rank_card is not None:
        return torch.device("cuda", _rank_card)
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def _device_mesh(device_type: str, ranks, dims: tuple, names: tuple):
    from torch.distributed.device_mesh import DeviceMesh

    arr = torch.as_tensor(np.asarray(ranks, dtype=np.int64)).reshape(dims)
    return DeviceMesh(device_type, arr, mesh_dim_names=names)


def build_mesh(ranks, shape: MeshShape, device_type: str = "cuda"):
    """A ``DeviceMesh`` over ``ranks`` (the world's, in order) with axes
    ``AXES``, laid out ``ranks.reshape(pipe, data, seq, model)``."""
    ranks = list(ranks)
    if shape.total != len(ranks):
        raise ValueError(f"mesh shape {shape} needs {shape.total} devices, got {len(ranks)}")
    dims = (shape.pipe, shape.data, shape.seq, shape.model)
    return _device_mesh(device_type, ranks, dims, AXES)


def mesh_for(ranks, want_seq: bool = False, device_type: str = "cuda"):
    ranks = list(ranks)
    return build_mesh(ranks, auto_mesh_shape(len(ranks), want_seq=want_seq), device_type)


def multislice_env_shape(env: dict[str, str] | None = None) -> tuple[int, int]:
    """(num_slices, slice_id) from the megascale env; (1, 0) when
    single-slice."""
    env = os.environ if env is None else env
    return (
        int(env.get("MEGASCALE_NUM_SLICES", "1")),
        int(env.get("MEGASCALE_SLICE_ID", "0")),
    )


def build_multislice_mesh(ranks, n_slices: int, shape: MeshShape, device_type: str = "cuda"):
    """A mesh over ``n_slices`` slices, axes ``MULTISLICE_AXES`` with the
    slice axis outermost; ``ranks`` slice-major, ``shape`` the per-slice
    mesh."""
    ranks = list(ranks)
    if len(ranks) % n_slices:
        raise ValueError(f"{len(ranks)} devices do not split into {n_slices} slices")
    per = len(ranks) // n_slices
    if shape.total != per:
        raise ValueError(
            f"per-slice shape {shape} needs {shape.total} devices, got {per} per slice"
        )
    dims = (n_slices, shape.pipe, shape.data, shape.seq, shape.model)
    return _device_mesh(device_type, ranks, dims, MULTISLICE_AXES)


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}``, the reference's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def slot_axis_size(mesh, slot_axis) -> int:
    """Validate a ``slot_axis`` (one axis name or a tuple of them) against
    ``mesh`` and return the total shard count."""
    names = (slot_axis,) if isinstance(slot_axis, str) else tuple(slot_axis)
    if not names:
        raise ValueError("slot_axis must name at least one mesh axis")
    if len(set(names)) != len(names):
        raise ValueError(f"slot_axis {names} repeats a mesh axis")
    shape = mesh_shape(mesh)
    missing = [n for n in names if n not in shape]
    if missing:
        raise ValueError(
            f"slot_axis {missing} not a mesh axis (mesh has {list(shape)})"
        )
    return math.prod(shape[n] for n in names)


@dataclass(frozen=True)
class SlotGroup:
    """A serving engine's slot shards on this rank: the process group over
    the slot axes (None on a one-shard axis), this rank's shard index and
    the shard count, and ``shards[j]``, the shard that group rank ``j``
    holds (the gathers put the blocks in shard order by it)."""

    group: object | None
    index: int
    count: int
    shards: tuple

    def src(self, shard: int) -> int:
        """The global rank in this group that holds ``shard``."""
        import torch.distributed as dist

        return dist.get_global_rank(self.group, self.shards.index(shard))


_FLAT_GROUPS: dict = {}


def _flat_group(mesh, names: tuple):
    """The process group over the flattened axes ``names``: every rank of
    the world makes every such group (one per coordinate of the other axes,
    in order), and keeps the one it is in."""
    import torch.distributed as dist

    key = (id(mesh), names)
    if key not in _FLAT_GROUPS:
        dims = list(mesh.mesh_dim_names)
        arr = mesh.mesh.numpy()
        moved = np.moveaxis(arr, [dims.index(n) for n in names],
                            range(arr.ndim - len(names), arr.ndim))
        mine = None
        for ranks in moved.reshape(-1, math.prod(arr.shape[dims.index(n)] for n in names)):
            group = dist.new_group([int(r) for r in ranks])
            if dist.get_rank() in ranks:
                mine = group
        _FLAT_GROUPS[key] = (mesh, mine)  # the mesh kept alive with its id
    return _FLAT_GROUPS[key][1]


def slot_group(mesh, slot_axis) -> SlotGroup:
    """The slot shards of a serving engine on ``mesh`` over ``slot_axis``
    (one axis name or a tuple, flattened slice-major as :func:`axis_index`
    numbers it), validated as :func:`slot_axis_size` validates it.  A
    tuple's group is made collectively: every rank of the world calls this
    with the same arguments."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh must be a torch.distributed DeviceMesh (parallel/mesh.build_mesh), "
            f"got {type(mesh).__name__}"
        )
    count = slot_axis_size(mesh, slot_axis)
    names = (slot_axis,) if isinstance(slot_axis, str) else tuple(slot_axis)
    index, _ = axis_index(mesh, names)
    if count == 1:
        return SlotGroup(None, 0, 1, (0,))
    import torch.distributed as dist

    group = mesh.get_group(names[0]) if len(names) == 1 else _flat_group(mesh, names)
    shape = mesh_shape(mesh)
    arr = mesh.mesh.numpy()
    shards = []
    for r in dist.get_process_group_ranks(group):
        coord = dict(zip(mesh.mesh_dim_names, (int(c[0]) for c in np.nonzero(arr == r))))
        shard = 0
        for n in names:
            shard = shard * shape[n] + coord[n]
        shards.append(shard)
    return SlotGroup(group, index, count, tuple(shards))


def validate_claimed_mesh(mesh, env: dict[str, str]) -> None:
    """Cross-check a mesh against the driver-injected bounds env."""
    bounds = env.get("TPU_CHIPS_PER_PROCESS_BOUNDS")
    if not bounds:
        return
    expected = math.prod(int(b) for b in bounds.split(","))
    size = mesh.mesh.numel()
    if size != expected:
        raise ValueError(
            f"mesh has {size} devices but claim bounds {bounds} imply {expected}"
        )


def _spec_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_index(mesh, axes) -> tuple[int, int]:
    """(this rank's block index, block count) over ``axes`` (a name or a
    tuple, the first outermost), as a ``PartitionSpec`` entry numbers the
    blocks of a dimension."""
    shape = mesh_shape(mesh)
    index, count = 0, 1
    for name in _spec_axes(axes):
        index = index * shape[name] + mesh.get_local_rank(name)
        count *= shape[name]
    return index, count


def shard(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec`` (one entry
    per leading dim; missing entries are None), contiguous."""
    for dim, entry in enumerate(spec):
        if not _spec_axes(entry):
            continue
        index, count = axis_index(mesh, entry)
        if x.shape[dim] % count:
            raise ValueError(
                f"dim {dim} of size {x.shape[dim]} does not split into {count} blocks "
                f"over {entry}"
            )
        x = x.chunk(count, dim)[index]
    return x.contiguous()


def gather(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The inverse of :func:`shard`: the full tensor on every rank, by
    all-gathers over each sharded dim's axes, innermost first."""
    from k8s_dra_driver_torch.ops import collectives

    for dim, entry in enumerate(spec):
        for name in reversed(_spec_axes(entry)):
            x = collectives.all_gather_raw(x, mesh.get_group(name), dim)
    return x


def unshard(blocks: list, mesh_ranks, names: tuple, spec) -> torch.Tensor:
    """The full tensor from every rank's block (``blocks[r]`` rank r's), the
    mesh given as its rank array ``mesh_ranks`` with axis ``names``: the
    host-side inverse of :func:`shard`, for tests."""
    arr = np.asarray(mesh_ranks)
    shape = dict(zip(names, arr.shape))

    def coords(r):
        return dict(zip(names, (int(c[0]) for c in np.nonzero(arr == r))))

    def place(r):
        c = coords(r)
        out = []
        for entry in spec:
            index = 0
            for name in _spec_axes(entry):
                index = index * shape[name] + c[name]
            out.append(index)
        return tuple(out)

    grid = {}
    for r, block in enumerate(blocks):
        grid.setdefault(place(r), block)

    def join(prefix, dim):
        if dim == len(spec):
            return grid[prefix]
        count = math.prod(shape[n] for n in _spec_axes(spec[dim]))
        return torch.cat([join(prefix + (i,), dim + 1) for i in range(count)], dim)

    return join((), 0)
