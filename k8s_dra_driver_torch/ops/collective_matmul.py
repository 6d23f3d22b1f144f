"""Collective matmul: the tensor-parallel products with their collectives
cut into ring hops (``k8s_dra_driver_tpu/ops/collective_matmul.py``).

:func:`all_gather_matmul` is ``all_gather(x) @ w`` and
:func:`matmul_reduce_scatter` is ``reduce_scatter(x @ w)`` over the rows,
each as a ring of :func:`~k8s_dra_driver_torch.ops.collectives.ppermute`
hops with one chunk product per step, unidirectional or, with
``bidirectional``, two counter-rotating rings over the halves (two
``ppermute`` calls a step, one per direction).  The reference builds the
ring so that each hop rides under the next chunk's product on the TPU's
interconnect.  Here a hop is a blocking ``torch.distributed`` send and
receive, and on a gloo group of CUDA tensors it goes through the host
(``collectives.host_bytes``), so these functions give the reference's
numbers and bytes, not its overlap.

Each function is the per-shard body the reference writes inside
``shard_map``, run by every rank of ``group`` (a process group; None is
one device) on its own blocks.  Leading dims of ``x`` are batch dims
(the reference's ``vmap``); the rows are dim -2.  Every step is an
autograd op, so the gradients travel the rings back.  The scatter's
rotating accumulators are f32, cast to x's dtype once at the end.
:func:`sharded_tp_mlp` takes a mesh and this rank's blocks, as
``ops/ring_attention.ring_attention`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from k8s_dra_driver_torch.ops import collectives


def _ring_perms(n: int) -> tuple[list, list]:
    fwd = collectives.ring_perm(n)
    return fwd, collectives.inverse_perm(fwd)


def all_gather_matmul(x, w, group, bidirectional: bool | None = None):
    """``all_gather(x, rows) @ w`` over ``group``.  x ``[..., s_loc, k]``
    (this rank's rows), w ``[k, n_loc]`` (any shard) -> ``[..., n·s_loc,
    n_loc]``, the rows in rank order: at step t a rank multiplies the chunk
    it received t hops ago (block ``idx - t``), then passes it on; n
    products, n - 1 hops (the reference's last hop is unused on every
    rank, so none is sent).  ``bidirectional`` (default: n even and > 2
    and ``s_loc`` even) sends the top half of each chunk forward and the
    bottom half backward (block ``idx + t``)."""
    n, idx = collectives.group_index(group)
    if n == 1:
        return x @ w
    s_loc = x.shape[-2]
    fwd, bwd = _ring_perms(n)
    if bidirectional is None:
        bidirectional = n % 2 == 0 and n > 2 and s_loc % 2 == 0
    if not bidirectional:
        blocks = [None] * n
        chunk = x
        for t in range(n):
            blocks[(idx - t) % n] = chunk @ w
            if t < n - 1:
                chunk = collectives.ppermute(chunk, group, fwd)
        return torch.cat(blocks, dim=-2)
    half = s_loc // 2
    if half * 2 != s_loc:
        raise ValueError(f"bidirectional ring needs even s_loc, got {s_loc}")
    tops, bots = [None] * n, [None] * n
    top, bot = x[..., :half, :], x[..., half:, :]
    for t in range(n):
        tops[(idx - t) % n] = top @ w   # rows of block idx - t
        bots[(idx + t) % n] = bot @ w   # rows of block idx + t
        if t < n - 1:
            top = collectives.ppermute(top, group, fwd)
            bot = collectives.ppermute(bot, group, bwd)
    return torch.cat([torch.cat([a, b], dim=-2) for a, b in zip(tops, bots)], dim=-2)


def matmul_reduce_scatter(x, w, group, bidirectional: bool | None = None):
    """``reduce_scatter(x @ w, rows)`` over ``group``.  x ``[..., s,
    k_loc]`` (the contraction dim sharded), w ``[k_loc, n_out]`` ->
    ``[..., s/n, n_out]``, this rank's rows of the sum.  The accumulator
    for block j starts at rank j; at step t a rank adds its partial for
    block ``idx - t`` and passes the accumulator on, so after n hops it is
    home with all n partials.  The partials are f32 products of the
    operands (the reference's ``preferred_element_type=f32``) summed in
    f32; the result is cast to x's dtype once.  ``bidirectional``
    (default: n even and > 2 and ``n_out`` even) rotates the left half of
    the columns forward and the right half backward."""
    n, idx = collectives.group_index(group)
    if n == 1:
        return x @ w
    s = x.shape[-2]
    n_out = w.shape[1]
    s_loc = s // n
    if s_loc * n != s:
        raise ValueError(f"rows ({s}) must divide by ring size ({n})")
    fwd, bwd = _ring_perms(n)
    if bidirectional is None:
        bidirectional = n % 2 == 0 and n > 2 and n_out % 2 == 0
    x32, w32 = x.float(), w.float()

    def row_block(b):
        return x32[..., b * s_loc:(b + 1) * s_loc, :]

    if not bidirectional:
        acc = x32.new_zeros((*x.shape[:-2], s_loc, n_out))
        for t in range(n):
            acc = acc + row_block((idx - t) % n) @ w32
            acc = collectives.ppermute(acc, group, fwd)
        return acc.to(x.dtype)
    half = n_out // 2
    if half * 2 != n_out:
        raise ValueError(f"bidirectional ring needs even output cols, got {n_out}")
    acc_l = x32.new_zeros((*x.shape[:-2], s_loc, half))
    acc_r = x32.new_zeros((*x.shape[:-2], s_loc, n_out - half))
    for t in range(n):
        acc_l = acc_l + row_block((idx - t) % n) @ w32[:, :half]
        acc_r = acc_r + row_block((idx + t) % n) @ w32[:, half:]
        acc_l = collectives.ppermute(acc_l, group, fwd)
        acc_r = collectives.ppermute(acc_r, group, bwd)
    return torch.cat([acc_l, acc_r], dim=-1).to(x.dtype)


def tp_mlp(x, w_in, w_out, group, bidirectional: bool | None = None):
    """One sequence-parallel Megatron MLP: x ``[..., s_loc, d]`` (this
    rank's rows), w_in ``[d, ff_loc]`` (its columns), w_out ``[ff_loc, d]``
    (its rows) -> ``[..., s_loc, d]``: gather-matmul, tanh GELU,
    matmul-scatter."""
    h = all_gather_matmul(x, w_in, group, bidirectional=bidirectional)
    h = F.gelu(h, approximate="tanh")
    return matmul_reduce_scatter(h, w_out, group, bidirectional=bidirectional)


def sharded_tp_mlp(x, w_in, w_out, mesh, model_axis: str = "model",
                   bidirectional: bool | None = None):
    """:func:`tp_mlp` over ``model_axis`` of ``mesh`` on this rank's blocks
    under the reference's specs: x ``[B, S, D]`` as ``P(None, model_axis,
    None)``, w_in as ``P(None, model_axis)``, w_out as ``P(model_axis,
    None)``; returns this rank's block of the output, ``P(None,
    model_axis, None)``."""
    return tp_mlp(x, w_in, w_out, mesh.get_group(model_axis), bidirectional=bidirectional)
