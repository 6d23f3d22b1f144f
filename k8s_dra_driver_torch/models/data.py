"""Host-sharded input pipeline for training on a mesh
(``k8s_dra_driver_tpu/models/data.py``).

The reference yields each global batch as a ``jax.Array`` sharded
``P(data_axis, None, ...)``, assembled from the rows each process loaded.
The port is one process per rank, so a batch is a :class:`RowBlock`: this
rank's rows of the global batch and the global row count, the port's
stand-in for that sharded array.  A rank loads only its rows: the global
batch of a step is ``data[order[step*B:(step+1)*B]]`` whatever the rank
count, and the rank at coordinate ``d`` of ``data_axis`` (of ``n`` blocks)
takes rows ``[d*B/n, (d+1)*B/n)`` of it, so ranks that differ only on the
other axes (``model``, ``seq``, ``pipe``) hold the same rows.  The mesh
steps take a block where they take a whole batch
(``models/mesh_train``'s, whose rows are the same contiguous block, and
``models/pp_burnin``'s, which gathers the block over ``data`` once).

Batches are static-shape (remainders dropped), and the shuffle is a
seeded permutation per epoch, ``np.random.default_rng((seed, epoch))``,
the reference's, so a resumed epoch replays the same stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from k8s_dra_driver_torch.device import resolve_device
from k8s_dra_driver_torch.parallel.mesh import PartitionSpec, axis_index, gather, mesh_shape


@dataclass(frozen=True)
class RowBlock:
    """Rows ``[index*b, (index+1)*b)`` of a global batch of
    ``global_rows`` rows (``b = global_rows / count``), the block ``index``
    of ``count`` over the mesh axes ``axes`` of ``mesh``."""

    rows: torch.Tensor
    global_rows: int
    index: int
    count: int
    axes: tuple
    mesh: object

    @property
    def shape(self) -> tuple:
        """The global batch's shape."""
        return (self.global_rows, *self.rows.shape[1:])

    @property
    def layout(self) -> tuple:
        """Everything but the rows: which block of which batch over which
        mesh (a graphed step keys its program on it)."""
        return self.global_rows, self.index, self.count, self.axes, id(self.mesh)

    def to(self, device) -> "RowBlock":
        return RowBlock(self.rows.to(device), self.global_rows, self.index, self.count,
                        self.axes, self.mesh)

    def whole(self) -> torch.Tensor:
        """The global batch on every rank: the blocks all-gathered over
        ``axes`` (counted in ``ops/collectives``)."""
        return gather(self.rows, self.mesh, PartitionSpec(self.axes))


def local_rows(tokens, n_blocks: int, index: int) -> tuple:
    """(block ``index`` of ``n_blocks`` of the batch's rows, the global row
    count): cut from a whole batch, or a :class:`RowBlock`'s own rows,
    which must be that block."""
    if isinstance(tokens, RowBlock):
        if (tokens.count, tokens.index) != (n_blocks, index):
            raise ValueError(
                f"a batch sharded {tokens.count} ways over {tokens.axes} (block "
                f"{tokens.index}) does not feed a step that takes block {index} of {n_blocks}"
            )
        return tokens.rows, tokens.global_rows
    if tokens.shape[0] % n_blocks:
        raise ValueError(f"batch {tokens.shape[0]} does not split into {n_blocks} blocks")
    return tokens.chunk(n_blocks, 0)[index], tokens.shape[0]


def as_batch(tokens, device):
    """A step's batch on ``device``: a :class:`RowBlock` moved, anything
    else as a tensor."""
    if isinstance(tokens, RowBlock):
        return tokens.to(device)
    return torch.as_tensor(tokens, device=device)


class TokenBatches:
    """Deterministic epoch iterator over a token array.

    ``data``: ``[N, ...]`` numpy array (the host's copy of the dataset, or
    a memory-mapped view); every rank holds the same data and seed, so the
    per-epoch permutation agrees, and each loads only its rows.
    ``data_axis``: the batch axis of ``mesh``.  Blocks land on
    ``device`` (default the card; raises without one unless
    ``device="cpu"``).  The reference's
    process-count check has no counterpart: here every process is one
    rank, and only the data axis splits the batch."""

    def __init__(self, data: np.ndarray, batch_size: int, mesh, data_axis="data",
                 seed: int = 0, device="cuda"):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        shape = mesh_shape(mesh)
        if data_axis not in shape:
            raise ValueError(f"data_axis {data_axis!r} not in mesh axes {tuple(shape)}")
        index, axis_size = axis_index(mesh, data_axis)
        if batch_size % axis_size:
            raise ValueError(
                f"batch_size {batch_size} not divisible by {data_axis} axis size {axis_size}"
            )
        if len(data) < batch_size:
            raise ValueError(f"dataset has {len(data)} rows < one batch ({batch_size})")
        self.data = data
        self.batch_size = batch_size
        self.mesh = mesh
        self.data_axis = data_axis
        self.seed = seed
        self.device = resolve_device(device)
        self._index, self._count = index, axis_size

    @property
    def steps_per_epoch(self) -> int:
        return len(self.data) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[RowBlock]:
        """Yield this epoch's batches as this rank's blocks (deterministic
        given seed and epoch: restore a checkpoint, replay the same epoch,
        get the same stream)."""
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(len(self.data))
        per_rank = self.batch_size // self._count
        lo = self._index * per_rank
        for step in range(self.steps_per_epoch):
            batch_idx = order[step * self.batch_size: (step + 1) * self.batch_size]
            local = torch.from_numpy(np.ascontiguousarray(self.data[batch_idx[lo: lo + per_rank]]))
            yield RowBlock(local.to(self.device), self.batch_size, self._index, self._count,
                           (self.data_axis,), self.mesh)
