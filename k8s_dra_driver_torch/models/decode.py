"""Autoregressive decoding with a dense KV cache
(``k8s_dra_driver_tpu/models/decode.py``).

The cache is ``[L, B, max_seq, Hkv, hd]`` per k/v, written IN PLACE (the
reference threads it functionally; here ``decode_chunk`` returns the same
tensors it was given).  Attention masks by position instead of slicing,
operands stay in the cache dtype with f32 accumulation.  Teacher-forced
decode reproduces ``burnin.forward``'s logits: the contract the tests pin.
Sampling (temperature > 0) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from k8s_dra_driver_torch.device import params_device
from k8s_dra_driver_torch.models.burnin import (
    ModelConfig,
    mlp_residual,
    qkv_proj,
    tied_logits,
)
from k8s_dra_driver_torch.models.quant import matmul_last as _mm


class KVCache(NamedTuple):
    """Per-layer stacked K/V: ``[L, B, max_seq, Hkv, head_dim]``."""

    k: torch.Tensor
    v: torch.Tensor


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.float32, device="cpu") -> KVCache:
    shape = (cfg.n_layers, batch, max_seq, cfg.kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def _masked_attention(q, k, v, mask):
    """Attention core shared by prefill and decode: operands rounded to the
    k/v dtype, products and sums in f32, masked scores ``-1e30``.  With GQA
    (fewer k/v heads than q heads) each KV head contracts against its G
    query heads directly.  ``mask`` broadcasts to ``[B, H, Q, K]``."""
    d = q.shape[-1]
    hq, hkv = q.shape[2], k.shape[2]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    k32, v32 = k.float(), v.float()
    if hq == hkv:
        scores = torch.einsum("bqhd,bkhd->bhqk", q.to(k.dtype).float(), k32) * scale
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v32)
        return out.to(q.dtype)
    groups = hq // hkv
    b, s_q = q.shape[0], q.shape[1]
    qg = q.reshape(b, s_q, hkv, groups, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(k.dtype).float(), k32) * scale
    if mask.dim() == 4:
        if mask.shape[1] == 1:
            gmask = mask[:, :, None]
        elif mask.shape[1] == hq:
            gmask = mask.reshape(mask.shape[0], hkv, groups, *mask.shape[2:])
        else:
            raise ValueError(
                f"GQA mask head axis must be 1 or n_heads ({hq}), got {mask.shape[1]}"
            )
    elif mask.dim() == 3 and mask.shape[0] != 1:
        raise ValueError(
            f"ambiguous 3-d GQA mask with leading axis {mask.shape[0]}: "
            "pass [B, H, Q, K] (H = 1 or n_heads) or [Q, K]/[K]"
        )
    else:
        gmask = mask
    scores = torch.where(gmask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v32)
    return out.reshape(b, s_q, hq, d).to(q.dtype)


def decode_chunk(params, cache: KVCache, tokens, pos0, *, cfg: ModelConfig,
                 active=None, k_window: int | None = None):
    """Score ``S`` known tokens per row in one pass: ``tokens [B, S]`` at
    positions ``pos0 .. pos0+S-1`` (``pos0`` an int or a ``[B]`` tensor).
    Writes every chunk position's k/v into the cache (rows with ``active``
    false keep theirs), then each query attends cache positions ``<=`` its
    own; ``k_window`` bounds the attended key positions.  Returns
    ``(logits [B, S, V] f32, cache)`` with the cache updated in place."""
    b, s = tokens.shape
    dev = tokens.device
    pos0 = torch.as_tensor(pos0, dtype=torch.long, device=dev).expand(b)
    positions = pos0[:, None] + torch.arange(s, device=dev)[None, :]    # [B, S]
    rows = torch.arange(b, device=dev)
    if active is not None:
        rows_w, pos_w = rows[active], positions[active]
    else:
        rows_w, pos_w = rows, positions
    x = params["embed"][tokens]
    if not cfg.rope:
        x = x + params["pos_embed"][positions]
    k_limit = cache.k.shape[2] if k_window is None else k_window
    k_pos = torch.arange(k_limit, device=dev)
    mask = (k_pos[None, None, :] <= positions[:, :, None])[:, None]     # [B,1,S,K]
    for li, p in enumerate(params["blocks"]):
        q, k, v = qkv_proj(x, p, cfg, positions=positions)
        sel = slice(None) if active is None else active
        cache.k[li][rows_w[:, None], pos_w] = k[sel].to(cache.k.dtype)
        cache.v[li][rows_w[:, None], pos_w] = v[sel].to(cache.v.dtype)
        attn = _masked_attention(
            q, cache.k[li][:, :k_limit], cache.v[li][:, :k_limit], mask
        ).reshape(b, s, cfg.d_model)
        x = x + _mm(attn, p["attn_out"])
        x = mlp_residual(x, p)
    return tied_logits(x, params), cache


def decode_step(params, cache: KVCache, token, pos, *, cfg: ModelConfig, active=None):
    """The S=1 view of :func:`decode_chunk`: ``token [B]`` at ``pos``.
    Returns ``(logits [B, V] f32, cache)``."""
    logits, cache = decode_chunk(
        params, cache, token[:, None], pos, cfg=cfg, active=active
    )
    return logits[:, 0], cache


def advance_decode_state(next_tok, last, pos, active, stop_pos, eos_id: int):
    """On-device serving-state advance: a row that sampled ``next_tok`` at
    ``pos`` moves to ``pos + 1`` and stays active unless it hit ``eos_id``
    (-1 = none) or its ``stop_pos``.  Inactive rows are frozen.  Returns
    ``(new_last, new_pos, new_active)``."""
    new_last = torch.where(active, next_tok, last)
    new_pos = torch.where(active, pos + 1, pos)
    done = active & ((next_tok == eos_id) | (new_pos >= stop_pos))
    return new_last, new_pos, active & ~done


def poison_rows(logits, poison):
    """Rows flagged in ``poison [B]`` get all-NaN logits (None = no-op)."""
    if poison is None:
        return logits
    return torch.where(poison[:, None], torch.full_like(logits, float("nan")), logits)


def finite_rows(logits):
    """``[B]`` bool: every logit in the row is finite."""
    return torch.isfinite(logits).all(dim=-1)


def prefill(params, prompt, cfg: ModelConfig, max_seq: int, cache_dtype=torch.float32):
    """Fill a fresh cache for the whole prompt ``[B, P]`` in one forward.
    Returns ``(cache, logits [B, V] of the last prompt position)``."""
    b, p_len = prompt.shape
    if p_len > max_seq:
        raise ValueError(f"prompt {p_len} exceeds max_seq {max_seq}")
    cache = init_cache(cfg, b, max_seq, dtype=cache_dtype, device=prompt.device)
    logits, cache = decode_chunk(params, cache, prompt, 0, cfg=cfg, k_window=p_len)
    return cache, logits[:, -1]


def greedy_decode(params, prompt, steps: int, cfg: ModelConfig,
                  cache_dtype=torch.float32, batch_prefill: bool = False,
                  device="cuda"):
    """Greedy continuation: ``prompt [B, P]`` -> ``[B, P+steps]`` on
    ``device`` (default the card; raises without one unless
    ``device="cpu"``).  The prompt is consumed token by token (teacher
    forcing) or, with ``batch_prefill``, by one parallel forward."""
    dev = params_device(params, device)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, p_len = prompt.shape
    total = p_len + steps
    if total > cfg.max_seq:
        raise ValueError(
            f"prompt {p_len} + steps {steps} = {total} exceeds max_seq {cfg.max_seq}"
        )
    tokens = torch.cat(
        [prompt, torch.zeros((b, steps), dtype=prompt.dtype, device=dev)], dim=1
    )
    cache = init_cache(cfg, b, total, dtype=cache_dtype, device=dev)
    start = 0
    if batch_prefill:
        if steps == 0:
            return prompt
        # prefill's own shape: prompt queries never see keys past the prompt
        logits, cache = decode_chunk(params, cache, prompt, 0, cfg=cfg, k_window=p_len)
        tokens[:, p_len] = logits[:, -1].argmax(dim=-1)
        start = p_len
    for pos in range(start, total - 1):
        logits, cache = decode_step(params, cache, tokens[:, pos], pos, cfg=cfg)
        if pos + 1 >= p_len:
            tokens[:, pos + 1] = logits.argmax(dim=-1)
    return tokens
