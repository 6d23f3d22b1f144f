"""Pipeline parallelism over the ``pipe`` axis, GPipe style
(``k8s_dra_driver_tpu/ops/pipeline.py``).

Each stage holds ``L / n_stages`` consecutive blocks, stacked on a leading
dim (:func:`stack_blocks`).  Microbatches stream through the stage ring
with one :func:`~k8s_dra_driver_torch.ops.collectives.ppermute` hand-off
per tick: over ``n_micro + n_stages - 1`` ticks stage ``s`` does useful
work on ticks ``s .. s + n_micro - 1``, and only the last stage's outputs
in that window are read.

The reference is one SPMD program that XLA differentiates whole; here
every rank runs its own graph and autograd runs each rank's backward on
its own, so every rank must hold every hop in its graph.  The stage-0
injection and the last stage's collection are therefore tensor
arithmetic on a 0-d condition (``torch.where``), the reference's
``jnp.where``, never a Python branch on the rank: a branch would drop
stage 0's received buffer from its graph, its hop's backward would never
run there, and the stage after it would wait in its backward receive.
The last tick's hop is unused on every rank alike, so none is sent.
"""

from __future__ import annotations

import torch

from k8s_dra_driver_torch.ops import collectives


def pipeline_apply(stage_fn, stage_params, x_microbatches, group):
    """Run microbatches through the stage ring of ``group`` (the ``pipe``
    axis's process group).

    ``stage_fn(stage_params, x) -> x`` applies THIS stage's blocks.
    ``x_microbatches`` ``[n_micro, mb, ...]``: the whole input on every
    stage; stage 0 injects microbatch ``t`` at tick ``t`` (clipped).
    Returns ``[n_micro, mb, ...]``, the last stage's outputs on every
    stage (a ``psum`` over the ring of the last stage's outputs and the
    others' zeros; its gradient reaches the last stage alone)."""
    n_stages, idx = collectives.group_index(group)
    n_micro = x_microbatches.shape[0]
    ticks = n_micro + n_stages - 1
    perm = collectives.ring_perm(n_stages)
    dev = x_microbatches.device
    # filled on the device: a CUDA graph of the step holds no host copy
    is_first = torch.full((), idx == 0, dtype=torch.bool, device=dev)
    is_last = torch.full((), idx == n_stages - 1, dtype=torch.bool, device=dev)
    buf = torch.zeros_like(x_microbatches[0])
    outs = []
    for t in range(ticks):
        inject = x_microbatches[min(t, n_micro - 1)]
        y = stage_fn(stage_params, torch.where(is_first, inject, buf))
        if t >= n_stages - 1:  # the valid window of the last stage's outputs
            outs.append(torch.where(is_last, y, torch.zeros_like(y)))
        if t < ticks - 1:
            buf = collectives.ppermute(y, group, perm)
    return collectives.psum(torch.stack(outs), group)


def stack_blocks(blocks: list[dict]) -> dict:
    """``[{leaf: t}] * L -> {leaf: [L, ...]}``, the layout whose leading
    dim the ``pipe`` axis shards."""
    return {k: torch.stack([blk[k] for blk in blocks]) for k in blocks[0]}


def stage_scan(block_fn, stage_params, x):
    """This stage's stacked blocks applied in order: ``block_fn(x,
    params_i)`` for each ``i`` of the leading dim."""
    for i in range(next(iter(stage_params.values())).shape[0]):
        x = block_fn(x, {k: v[i] for k, v in stage_params.items()})
    return x
