"""Expert parallelism: capacity-based top-k mixture of experts with
all-to-all dispatch (``k8s_dra_driver_tpu/ops/moe.py``).

The GShard/Switch pattern over an ``expert`` axis (the ``data`` axis:
tokens and experts are cut over the same ranks):

1. each rank routes its tokens (f32 router scores, softmax, the top k in
   ``jax.lax.top_k``'s order: ``burnin.top_k_experts``);
2. the token copies fill per-(expert, rank) capacity queues, all first
   choices before any second choice (int32 cumulative counts); a copy past
   its expert's capacity is dropped and contributes exactly 0;
3. ``collectives.all_to_all`` (split 0, concat 1) gives each rank its
   experts' slots from every rank; the experts' tanh-GELU MLPs run as
   plain einsums;
4. the reverse all-to-all returns the outputs to the tokens' ranks, which
   combine them by the gates.

Everything is an autograd op; the all-to-alls' gradients take the reverse
exchange.  :func:`topk_moe_local` is the reference's per-shard body (a
process group, None for one device); :func:`topk_moe` takes a mesh and
this rank's blocks under the reference's specs (its tokens, its experts,
the router whole), as ``collective_matmul.sharded_tp_mlp`` does, checks
them as the reference does, and returns this rank's block of the output,
so a rank holds 1/n of the experts and of their gradients.
:func:`reference_topk_moe` is the dropless dense oracle.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from k8s_dra_driver_torch.models.burnin import top_k_experts
from k8s_dra_driver_torch.ops import collectives


def _topk_gates(probs, k: int):
    """``(gates, indices)`` of the top-k routing, shared by the sharded
    body and the oracle: k 1 keeps the raw top-1 probability (Switch), k >
    1 normalizes the selected gates to sum to 1 (GShard)."""
    top_probs, top_idx = top_k_experts(probs, k)
    if k == 1:
        return top_probs, top_idx
    return top_probs / top_probs.sum(-1, keepdim=True).clamp_min(1e-9), top_idx


def _router_probs(x, w_router):
    return torch.softmax(x.float() @ w_router.float(), dim=-1)


def route(x, w_router, n_experts: int, capacity: int, k: int = 1):
    """The routing of one rank's tokens ``x [T, D]``: ``(gates [T, k] f32,
    experts [T, k], slots [T, k] int32, keep [T, k] bool)``.  Copy r of a
    token takes slot ``slot`` in its expert's queue; the queues fill choice
    by choice (every first choice before any second), in token order, and
    a copy with ``keep`` False found its queue full (``capacity`` slots)."""
    gates, top_idx = _topk_gates(_router_probs(x, w_router), k)
    counts = torch.zeros((n_experts,), dtype=torch.int32, device=x.device)
    slots, keeps = [], []
    for r in range(k):  # k is small: unrolled, as the reference's
        oh = F.one_hot(top_idx[:, r], n_experts).to(torch.int32)           # [T, E]
        position = (torch.cumsum(oh, 0, dtype=torch.int32) - 1) * oh + counts[None, :] * oh
        pos_in_expert = position.sum(-1, dtype=torch.int32)
        slots.append(pos_in_expert)
        keeps.append(pos_in_expert < capacity)
        counts = counts + oh.sum(0, dtype=torch.int32)
    return gates, top_idx, torch.stack(slots, 1), torch.stack(keeps, 1)


def topk_moe_local(x, w_router, w_up, w_down, group, capacity: int, k: int = 1):
    """Per-rank top-k MoE over ``group`` (None: one device).  x ``[T_loc,
    D]`` this rank's tokens, w_router ``[D, E]`` whole, w_up ``[E_loc, D,
    F]`` and w_down ``[E_loc, F, D]`` this rank's experts -> ``[T_loc,
    D]``."""
    n, _ = collectives.group_index(group)
    n_experts = w_up.shape[0] * n
    gates, top_idx, slots, keep = route(x, w_router, n_experts, capacity, k)
    dispatch = x.new_zeros((x.shape[0], n_experts, capacity))
    combine = x.new_zeros((x.shape[0], n_experts, capacity))
    for r in range(k):
        slot = torch.where(keep[:, r], slots[:, r], torch.zeros_like(slots[:, r]))
        d_r = (F.one_hot(top_idx[:, r], n_experts).to(x.dtype)[:, :, None]
               * F.one_hot(slot.long(), capacity).to(x.dtype)[:, None, :]
               * keep[:, r, None, None].to(x.dtype))                          # [T, E, C]
        dispatch = dispatch + d_r
        combine = combine + d_r * gates[:, r, None, None].to(x.dtype)
    expert_in = torch.einsum("td,tec->ecd", x, dispatch)                     # [E, C, D]
    if n > 1:  # [E, C, D] -> [E_loc, n·C, D]: this rank's experts' slots from all
        expert_in = collectives.all_to_all(expert_in, group, 0, 1)
    h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, w_up), approximate="tanh")
    expert_out = torch.einsum("ecf,efd->ecd", h, w_down)
    if n > 1:  # back to the tokens' ranks: [E_loc, n·C, D] -> [E, C, D]
        expert_out = collectives.all_to_all(expert_out, group, 1, 0)
    return torch.einsum("ecd,tec->td", expert_out, combine)


def switch_moe_local(x, w_router, w_up, w_down, group, capacity: int):
    """Per-rank Switch MoE: top-1 routing."""
    return topk_moe_local(x, w_router, w_up, w_down, group, capacity, k=1)


def moe_capacity(capacity_factor: float, t_loc: int, k: int, n_experts: int) -> int:
    """Slots per (expert, source rank), the reference's arithmetic: the
    capacity-factor-padded even spread of a rank's ``t_loc · k`` copies,
    the product truncated to an int, then divided up."""
    return max(1, -(-int(capacity_factor * t_loc * k) // n_experts))


def topk_moe(x, w_router, w_up, w_down, mesh, axis_name: str = "data",
             capacity_factor: float = 2.0, k: int = 1):
    """Top-k MoE with the tokens and experts cut over ``axis_name``, on this
    rank's blocks under the reference's specs: x ``[T/n, D]`` its tokens
    (``P(axis_name, None)``), w_router ``[D, E]`` whole, w_up ``[E/n, D,
    F]`` and w_down ``[E/n, F, D]`` its experts (``P(axis_name, None,
    None)``) -> its block of the output, ``[T/n, D]``.  E is the router's
    width; the reference's checks of the whole tensors are made on it."""
    from k8s_dra_driver_torch.parallel.mesh import mesh_shape

    n = mesh_shape(mesh)[axis_name]
    n_experts = w_router.shape[-1]
    if n_experts % n:
        raise ValueError(f"{n_experts} experts not divisible by axis {axis_name}={n}")
    if w_up.shape[0] * n != n_experts:
        raise ValueError(
            f"router emits {n_experts} experts but weights hold {w_up.shape[0] * n}"
        )
    if not 1 <= k <= n_experts:
        raise ValueError(f"k={k} must be in [1, {n_experts}]")
    capacity = moe_capacity(capacity_factor, x.shape[0], k, n_experts)
    return topk_moe_local(x, w_router, w_up, w_down, mesh.get_group(axis_name), capacity, k)


def switch_moe(x, w_router, w_up, w_down, mesh, axis_name: str = "data",
               capacity_factor: float = 2.0):
    """Switch = top-1."""
    return topk_moe(x, w_router, w_up, w_down, mesh, axis_name=axis_name,
                    capacity_factor=capacity_factor, k=1)


def reference_topk_moe(x, w_router, w_up, w_down, k: int = 1):
    """Dropless dense oracle: every token runs its top-k experts."""
    gates, top_idx = _topk_gates(_router_probs(x, w_router), k)
    h = F.gelu(torch.einsum("td,edf->tef", x, w_up), approximate="tanh")
    outs = torch.einsum("tef,efd->ted", h, w_down)                            # [T, E, D]
    picked = torch.take_along_dim(outs, top_idx[:, :, None], dim=1)          # [T, k, D]
    return torch.einsum("tkd,tk->td", picked, gates.to(x.dtype))


def reference_switch_moe(x, w_router, w_up, w_down):
    """Dropless dense oracle, top-1."""
    return reference_topk_moe(x, w_router, w_up, w_down, k=1)
