"""Sequence parallelism: ring attention and Ulysses
(``k8s_dra_driver_tpu/ops/ring_attention.py``).

Each function here is the per-shard body the reference writes inside
``jax.shard_map``, run by every rank of a ``seq`` group on its own block:
q/k/v ``[B, S_local, H, D]``.  The ``*_local`` functions take the group
itself; the sharded entry points (:func:`ring_attention`,
:func:`ring_flash_attention`, :func:`ulysses_attention`) take the mesh and
an axis name, as the reference's do, and this rank's blocks of q/k/v under
the reference's spec ``(batch_axis, axis_name, head_axis, None)``: only
the sequence axis takes a collective, so batch and heads need no name.

* **Ring**: K/V blocks travel the ring by :func:`~ops.collectives.ppermute`
  (n - 1 hops) under an online softmax in f32; autograd runs back through
  the hops.  Causal masking is block-exact.
* **Flash ring**: the flash kernels on every (q, k-block) pair, partials in
  f32 merged by their lse (:func:`_merge_blocks`); blocks from later ranks
  are skipped under the causal mask, but every hop still runs on every rank
  (a skipped hop would leave a neighbour waiting).  Its backward
  (:class:`RingFlashCore`) rotates K/V again with their dK/dV accumulators,
  runs the dQ and dK/dV kernels per block with the GLOBAL lse and a
  ``delta`` computed once, and sends the accumulators one last hop home.
* **Ulysses**: two all-to-alls reshard ``[B, S/n, H, D]`` to
  ``[B, S, H/n, D]``, full-sequence attention per head group (plain or the
  flash kernels), and back.
"""

from __future__ import annotations

import math

import torch

from k8s_dra_driver_torch.ops import collectives
from k8s_dra_driver_torch.ops.flash_attention import (
    _backward_bhsd,
    _delta,
    _forward_bhsd,
    flash_attention,
    from_bh,
    to_bh,
)


def reference_attention(q, k, v, causal: bool = True):
    """Plain full attention ``[B, S, H, D]``: scores in the input dtype cast
    to f32, ``-1e30`` causal mask, probabilities cast back."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
    if causal:
        mask = torch.tril(torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool, device=q.device))
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


# ---------------------------------------------------------------------------
# Ring attention
# ---------------------------------------------------------------------------


def ring_attention_local(q, k, v, group, causal: bool = True):
    """Ring attention on this rank's blocks over ``group``; accumulators in
    f32, output in q's dtype."""
    n, idx = collectives.group_index(group)
    b, s_loc, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q32 = q.float()
    q_pos = idx * s_loc + torch.arange(s_loc, device=q.device)

    def accumulate(k_cur, v_cur, origin, m, l, acc):
        scores = torch.einsum("bqhd,bkhd->bhqk", q32, k_cur.float()) * scale
        if causal:
            k_pos = origin * s_loc + torch.arange(s_loc, device=q.device)
            allowed = k_pos[None, :] <= q_pos[:, None]
            scores = torch.where(allowed, scores, torch.full_like(scores, -1e30))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        correction = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l_new = l * correction + p.sum(dim=-1)
        acc_new = acc * correction.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, v_cur.float()
        )
        return m_new, l_new, acc_new

    zero_bhs = q32.new_zeros((b, h, s_loc))
    m, l, acc = accumulate(k, v, idx, zero_bhs - 1e30, zero_bhs, torch.zeros_like(q32))
    perm = collectives.ring_perm(n)
    k_cur, v_cur = k, v
    for i in range(1, n):
        k_cur = collectives.ppermute(k_cur, group, perm)
        v_cur = collectives.ppermute(v_cur, group, perm)
        # after i hops the block here came from rank (idx - i) mod n
        m, l, acc = accumulate(k_cur, v_cur, (idx - i) % n, m, l, acc)
    out = acc / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ring_attention(q, k, v, mesh, axis_name: str = "seq", causal: bool = True):
    """This rank's blocks of q/k/v ``[B, S, H, D]`` (S on ``axis_name``) ->
    this rank's output block."""
    return ring_attention_local(q, k, v, mesh.get_group(axis_name), causal)


# ---------------------------------------------------------------------------
# Ring attention through the flash kernels
# ---------------------------------------------------------------------------


def _merge_blocks(out_a, lse_a, out_b, lse_b):
    """Merge two normalized attention partials by their lse (f32)."""
    lse = torch.logaddexp(lse_a, lse_b)
    w_a = torch.exp(lse_a - lse)[..., None]
    w_b = torch.exp(lse_b - lse)[..., None]
    return w_a * out_a + w_b * out_b, lse


def _ring_flash_fwd(q, k, v, group, causal):
    n, idx = collectives.group_index(group)
    b, s_loc, h, d = q.shape
    q_bh, k_bh, v_bh = to_bh(q), to_bh(k), to_bh(v)
    # f32 partials: rounding each to q's dtype before the merge would
    # accumulate n roundings
    out, lse = _forward_bhsd(q_bh, k_bh, v_bh, causal, out_dtype=torch.float32)
    perm = collectives.ring_perm(n)
    for i in range(1, n):
        k_bh, v_bh = collectives.ppermute_raw([k_bh, v_bh], group, perm)
        if causal and (idx - i) % n > idx:
            continue  # a later rank's block: nothing to attend
        o_i, l_i = _forward_bhsd(q_bh, k_bh, v_bh, False, out_dtype=torch.float32)
        out, lse = _merge_blocks(out, lse, o_i, l_i)
    return from_bh(out, b, h).to(q.dtype), lse


def _ring_flash_bwd(q, k, v, out, lse, dout, group, causal):
    n, idx = collectives.group_index(group)
    b, s_loc, h, d = q.shape
    q_bh, out_bh = to_bh(q), to_bh(out)
    dout_bh = to_bh(dout.to(q.dtype))
    delta = _delta(dout_bh, out_bh)  # rowsum(dout * out), once for every block

    def block_grads(k_bh, v_bh, blk_causal):
        dq, dk, dv = _backward_bhsd(q_bh, k_bh, v_bh, out_bh, lse, dout_bh, blk_causal,
                                    delta=delta)
        return dq.float(), dk.float(), dv.float()

    k_bh, v_bh = to_bh(k), to_bh(v)
    dq, dk_cur, dv_cur = block_grads(k_bh, v_bh, causal)
    perm = collectives.ring_perm(n)
    for i in range(1, n):
        # the block and its gradient accumulators travel together
        k_bh, v_bh, dk_cur, dv_cur = collectives.ppermute_raw(
            [k_bh, v_bh, dk_cur, dv_cur], group, perm)
        if causal and (idx - i) % n > idx:
            continue
        dq_i, dk_i, dv_i = block_grads(k_bh, v_bh, False)
        dq, dk_cur, dv_cur = dq + dq_i, dk_cur + dk_i, dv_cur + dv_i
    # after n - 1 hops the accumulators sit one hop short of home
    dk, dv = collectives.ppermute_raw([dk_cur, dv_cur], group, perm)
    return (from_bh(dq, b, h).to(q.dtype), from_bh(dk, b, h).to(k.dtype),
            from_bh(dv, b, h).to(v.dtype))


class RingFlashCore(torch.autograd.Function):
    """The flash ring on ``[B, S_local, H, D]`` blocks with its own
    backward; saves ``q, k, v, out`` and the global lse."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        out, lse = _ring_flash_fwd(q, k, v, group, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_flash_bwd(q, k, v, out, lse, dout, ctx.group, ctx.causal)
        return dq, dk, dv, None, None


def ring_flash_attention_local(q, k, v, group, causal: bool = True):
    """The flash ring on this rank's blocks over ``group``."""
    return RingFlashCore.apply(q, k, v, group, causal)


def ring_flash_attention(q, k, v, mesh, axis_name: str = "seq", causal: bool = True):
    """This rank's blocks of q/k/v with S on ``axis_name`` -> its output
    block, through the flash kernels."""
    return ring_flash_attention_local(q, k, v, mesh.get_group(axis_name), causal)


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------


def ulysses_attention_local(q, k, v, group, causal: bool = True, attn_fn=None):
    """Ulysses on this rank's blocks ``[B, S_local, H, D]`` (full heads;
    H % n == 0).  ``attn_fn(q, k, v, causal=...)`` is the full-sequence
    inner attention, :func:`reference_attention` by default."""
    n, _ = collectives.group_index(group)
    h = q.shape[2]
    if h % n != 0:
        raise ValueError(f"Ulysses needs heads ({h}) divisible by axis size ({n})")

    def to_seq(x):  # [b, s/n, h, d] -> [b, s, h/n, d]
        return collectives.all_to_all(x, group, split_axis=2, concat_axis=1)

    def to_heads(x):  # [b, s, h/n, d] -> [b, s/n, h, d]
        return collectives.all_to_all(x, group, split_axis=1, concat_axis=2)

    inner = attn_fn if attn_fn is not None else reference_attention
    return to_heads(inner(to_seq(q), to_seq(k), to_seq(v), causal=causal))


def ulysses_attention(q, k, v, mesh, axis_name: str = "seq", causal: bool = True,
                      use_flash: bool = False):
    """This rank's blocks with S on ``axis_name`` -> its output block;
    ``use_flash`` runs the inner attention through the flash kernels."""
    return ulysses_attention_local(q, k, v, mesh.get_group(axis_name), causal,
                                   flash_attention if use_flash else None)
