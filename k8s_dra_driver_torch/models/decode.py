"""Autoregressive decoding with a dense KV cache
(``k8s_dra_driver_tpu/models/decode.py``).

The cache is ``[L, B, max_seq, Hkv, hd]`` per k/v, written IN PLACE (the
reference threads it functionally; here ``decode_chunk`` returns the same
tensors it was given).  Attention masks by position instead of slicing,
operands stay in the cache dtype with f32 accumulation.  Teacher-forced
decode reproduces ``burnin.forward``'s logits: the contract the tests pin.
``sample_decode`` samples with ``jax.random``'s bits (``models/prng``);
``greedy_decode`` is its temperature-0 case.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from k8s_dra_driver_torch.device import params_device, resolve_device
from k8s_dra_driver_torch.models import lora, prng
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
               dtype=torch.float32, device="cuda") -> KVCache:
    """Zeroed K/V on ``device`` (the card by default; raises without one
    unless the caller passes ``device="cpu"``)."""
    device = resolve_device(device)
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
                 active=None, k_window: int | None = None, logits: bool = True,
                 adapters=None):
    """Score ``S`` known tokens per row in one pass: ``tokens [B, S]`` at
    positions ``pos0 .. pos0+S-1`` (``pos0`` an int or a ``[B]`` tensor).
    Writes every chunk position's k/v into the cache (rows with ``active``
    false write back the bytes they held, so no shape depends on the data
    and the call can be captured as a CUDA graph), then each query attends
    cache positions ``<=`` its own; ``k_window`` bounds the attended key
    positions.  With ``active`` given, a position past the cache (a
    speculative verify window near ``max_seq``) drops its write, as the
    reference's scatter does: its index wraps (modulo ``max_seq``) to a
    position the window does not cover, which writes back its own bytes.
    ``adapters``: ``(bank, ids [B])``, per-row LoRA from a serving bank
    (``lora.stack_adapters``) through the projections' delta hooks.
    Returns ``(logits [B, S, V] f32, cache)`` with the cache updated in
    place; ``logits=False`` returns ``None`` in their place and skips what
    only they need (the last layer's attention and MLP, the head): for a
    caller that wants only the cache, as the reference's chunked prefill,
    whose unused logits XLA removes as dead code."""
    b, s = tokens.shape
    dev = tokens.device
    max_seq = cache.k.shape[2]
    if isinstance(pos0, torch.Tensor):
        pos0 = pos0.to(device=dev, dtype=torch.long).expand(b)
    else:  # filled on the device: no host-to-device copy (capturable)
        pos0 = torch.full((b,), pos0, dtype=torch.long, device=dev)
    positions = pos0[:, None] + torch.arange(s, device=dev)[None, :]    # [B, S]
    rows = torch.arange(b, device=dev)[:, None]
    if active is None:
        at, keep = (rows, positions), None
    else:
        past = positions >= max_seq
        at = (rows, positions % max_seq)
        keep = (~active[:, None] | past)[:, :, None, None]
    x = params["embed"][tokens]
    if not cfg.rope:  # the reference's gather clamps a position past the table
        x = x + params["pos_embed"][positions.clamp(max=params["pos_embed"].shape[0] - 1)]
    k_limit = max_seq if k_window is None else k_window
    k_pos = torch.arange(k_limit, device=dev)
    mask = (k_pos[None, None, :] <= positions[:, :, None])[:, None]     # [B,1,S,K]
    for li, p in enumerate(params["blocks"]):
        delta = None if adapters is None else lora.layer_delta(adapters, li)
        q, k, v = qkv_proj(x, p, cfg, positions=positions, delta=delta)
        for new, layer in ((k, cache.k[li]), (v, cache.v[li])):
            new = new.to(layer.dtype)
            layer[at] = new if keep is None else torch.where(keep, layer[at], new)
        if not logits and li == len(params["blocks"]) - 1:
            return None, cache  # the last layer's attention and MLP feed only the head
        attn = _masked_attention(
            q, cache.k[li][:, :k_limit], cache.v[li][:, :k_limit], mask
        ).reshape(b, s, cfg.d_model)
        x = x + _mm(attn, p["attn_out"])
        if delta is not None:
            x = x + delta("attn_out", attn)
        x = mlp_residual(x, p, delta=delta, top_k=cfg.moe_top_k)
    return tied_logits(x, params), cache


def decode_step(params, cache: KVCache, token, pos, *, cfg: ModelConfig, active=None,
                adapters=None):
    """The S=1 view of :func:`decode_chunk`: ``token [B]`` at ``pos``.
    Returns ``(logits [B, V] f32, cache)``."""
    logits, cache = decode_chunk(
        params, cache, token[:, None], pos, cfg=cfg, active=active, adapters=adapters
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


def prefill(params, prompt, cfg: ModelConfig, max_seq: int, cache_dtype=torch.float32,
            adapters=None):
    """Fill a fresh cache for the whole prompt ``[B, P]`` in one forward
    (``adapters`` as :func:`decode_chunk` takes them).  Returns ``(cache,
    logits [B, V] of the last prompt position)``."""
    b, p_len = prompt.shape
    if p_len > max_seq:
        raise ValueError(f"prompt {p_len} exceeds max_seq {max_seq}")
    cache = init_cache(cfg, b, max_seq, dtype=cache_dtype, device=prompt.device)
    logits, cache = decode_chunk(params, cache, prompt, 0, cfg=cfg, k_window=p_len,
                                 adapters=adapters)
    return cache, logits[:, -1]


def greedy_decode(params, prompt, steps: int, cfg: ModelConfig,
                  cache_dtype=torch.float32, batch_prefill: bool = False,
                  device="cuda"):
    """Greedy continuation: ``prompt [B, P]`` -> ``[B, P+steps]``, the
    temperature-0 case of :func:`sample_decode`."""
    return sample_decode(params, prompt, steps, cfg, key=prng.prng_key(0), temperature=0.0,
                         cache_dtype=cache_dtype, batch_prefill=batch_prefill, device=device)


def sample_decode(params, prompt, steps: int, cfg: ModelConfig, key, temperature: float = 1.0,
                  top_k: int = 0, cache_dtype=torch.float32, batch_prefill: bool = False,
                  device="cuda"):
    """Continuation with temperature and optional top-k: ``prompt [B, P]``
    -> ``[B, P+steps]`` on ``device`` (default the card; raises without
    one unless ``device="cpu"``).  ``temperature <= 0`` is the argmax;
    above it each step draws a categorical over the logits over the
    temperature (masked below the ``top_k``-th value when ``top_k > 0``)
    under the key ``split(key, P+steps-1)[pos]`` of its position, one key
    for the whole batch, as the reference does.  The prompt is consumed
    token by token (teacher forcing) or, with ``batch_prefill``, by one
    parallel forward; both sample alike."""
    dev = params_device(params, device)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, p_len = prompt.shape
    total = p_len + steps
    if total > cfg.max_seq:
        raise ValueError(
            f"prompt {p_len} + steps {steps} = {total} exceeds max_seq {cfg.max_seq}"
        )
    keys = prng.split(torch.as_tensor(key, device=dev), max(total - 1, 1))

    def pick(logits, pos):
        if temperature <= 0.0:
            return logits.argmax(dim=-1)
        scaled = logits / float(np.float32(temperature))
        if top_k > 0:
            kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
            scaled = torch.where(scaled < kth, float("-inf"), scaled)
        return (prng.gumbel(keys[pos], scaled.shape) + scaled).argmax(dim=-1)

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
        tokens[:, p_len] = pick(logits[:, -1], p_len - 1)
        start = p_len
    for pos in range(start, total - 1):
        logits, cache = decode_step(params, cache, tokens[:, pos], pos, cfg=cfg)
        if pos + 1 >= p_len:
            tokens[:, pos + 1] = pick(logits, pos)
    return tokens
