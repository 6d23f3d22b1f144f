"""Greedy speculative decoding (``k8s_dra_driver_tpu/models/speculative.py``).

A draft model proposes ``gamma`` tokens with sequential cheap steps, then
the target scores the window ``[last committed, g_1..g_gamma]`` in one
``decode.decode_chunk``; each row advances by its leading agreements plus
one (the target's correction, or on full acceptance the bonus token).
Under greedy verification the output is the target's greedy stream token
for token, whatever the draft: acceptance moves the speed, never the
content.  The serving engines' rounds (``serve._spec_round``,
``paged._paged_spec_round``) share :func:`accept_advance` with
:func:`speculative_decode`.

The reference runs its rounds in a ``lax.while_loop``; here each round is
one fixed-shape function of state tensors that keep their addresses (on
the card a CUDA graph, ``models/graphs.GraphedProgram``), and a Python
loop drives it, reading back one flag a round: whether any row is still
short of its length.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from k8s_dra_driver_torch.device import params_device
from k8s_dra_driver_torch.models import decode
from k8s_dra_driver_torch.models.burnin import ModelConfig
from k8s_dra_driver_torch.models.graphs import GraphedProgram, graphs_enabled


def accept_advance(proposed, target, active):
    """The acceptance rule: ``proposed [B, gamma]`` draft tokens,
    ``target [B, >= gamma]`` verifier argmaxes, ``active [B]`` bool.
    Returns int32 ``(n_acc, advance)``: the leading agreements, and
    ``n_acc + 1`` on active rows (0 elsewhere), so full acceptance commits
    the bonus token."""
    gamma = proposed.shape[1]
    matches = (proposed == target[:, :gamma]).to(torch.int32)
    n_acc = torch.cumprod(matches, dim=1).sum(dim=1).to(torch.int32)
    return n_acc, torch.where(active, n_acc + 1, torch.zeros_like(n_acc))


class SpecStats(NamedTuple):
    """Speculation counts as 0-d int64 tensors: ``drafted``, ``accepted``
    and ``emitted`` summed over the batch, ``rounds`` the loop's
    iterations (shared by every row), so ``tokens_per_round`` is a
    batch-wide rate."""

    rounds: torch.Tensor
    drafted: torch.Tensor
    accepted: torch.Tensor
    emitted: torch.Tensor

    @property
    def acceptance(self):
        return self.accepted / self.drafted.clamp_min(1)

    @property
    def tokens_per_round(self):
        return self.emitted / self.rounds.clamp_min(1)


def _decode_round(params, draft_params, t_cache, d_cache, tokens, pos, stats, *,
                  cfg: ModelConfig, gamma: int, total: int):
    """One round for every row short of ``total``, in place: ``tokens [B,
    cap + 1]`` (column ``cap = total + gamma`` is the sink of writes the
    reference's scatter drops), ``pos [B]`` the committed frontier (the
    token there not yet fed to either model), ``stats [4]`` (rounds,
    drafted, accepted, emitted).  The draft runs ``gamma + 1`` steps, the
    last priming the cache at the last proposal's position so that full
    acceptance can commit the bonus token.  Returns a 0-d bool: whether
    any row is still short."""
    b = pos.shape[0]
    cap = total + gamma
    dev = pos.device
    rows = torch.arange(b, device=dev)
    steps = torch.arange(gamma + 1, device=dev)
    active = pos < total
    proposed = []
    for i in range(gamma + 1):
        p = (pos + i).clamp(max=cap - 1)
        logits, _ = decode.decode_step(draft_params, d_cache, tokens[rows, p], p, cfg=cfg,
                                       active=active)
        nxt = logits.argmax(dim=-1)
        q = (pos + i + 1).clamp(max=cap - 1)
        tokens[rows, q] = torch.where(active, nxt, tokens[rows, q])
        proposed.append(nxt)
    proposed = torch.stack(proposed[:gamma], dim=1)
    window = tokens[rows[:, None], (pos[:, None] + steps[None, :]).clamp(max=cap - 1)]
    logits, _ = decode.decode_chunk(params, t_cache, window, pos.clamp(max=cap - 1 - gamma),
                                    cfg=cfg, active=active)
    target = logits.argmax(dim=-1)                                     # [B, gamma + 1]
    n_acc, advance = accept_advance(proposed, target, active)
    # positions pos+1 .. pos+gamma+1 take the target's argmaxes: the
    # accepted drafts, then the correction (the rest is scratch a later
    # round rewrites before reading it)
    write = torch.where(active[:, None], pos[:, None] + 1 + steps[None, :], cap)
    tokens[rows[:, None], write] = target
    new_pos = torch.minimum(pos + advance, torch.full_like(pos, total))
    stats[0] += 1
    stats[1] += active.long().sum() * gamma
    stats[2] += torch.where(active, n_acc, torch.zeros_like(n_acc)).sum()
    stats[3] += (new_pos - pos).sum()
    pos.copy_(new_pos)
    return (new_pos < total).any()


def speculative_decode(params, draft_params, prompt, steps: int, cfg: ModelConfig, *,
                       gamma: int = 4, cache_dtype=torch.float32, return_stats: bool = False,
                       device="cuda"):
    """Greedy continuation by draft-then-verify: ``prompt [B, P]`` ->
    ``[B, P + steps]`` on ``device`` (default the card; raises without one
    unless ``device="cpu"``), token for token ``decode.greedy_decode(params,
    prompt, steps, batch_prefill=True)``.  ``draft_params`` may be any
    weights with the target's vocab and layer layout (the int8
    ``quant.quantize_blocks(params)`` self-draft, or fewer blocks: the
    draft's cache has the draft's depth).  Both caches hold ``P + steps +
    gamma`` positions, the verify window's slack.  With ``return_stats``
    returns ``(tokens, SpecStats)``."""
    dev = params_device(params, device)
    params_device(draft_params, device)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, p_len = prompt.shape
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    total = p_len + steps
    cap = total + gamma
    if cap > cfg.max_seq:
        raise ValueError(
            f"prompt {p_len} + steps {steps} + gamma {gamma} = {cap} exceeds "
            f"max_seq {cfg.max_seq} (speculation needs gamma slack)"
        )
    # both models prefill the prompt; the target commits its first token
    t_cache, t_logits = decode.prefill(params, prompt, cfg, max_seq=cap, cache_dtype=cache_dtype)
    shape = (len(draft_params["blocks"]), b, cap, cfg.kv_heads, cfg.head_dim)
    d_cache = decode.KVCache(*(torch.zeros(shape, dtype=cache_dtype, device=dev)
                               for _ in range(2)))
    decode.decode_chunk(draft_params, d_cache, prompt, 0, cfg=cfg, k_window=p_len, logits=False)
    tokens = torch.zeros((b, cap + 1), dtype=torch.long, device=dev)
    tokens[:, :p_len] = prompt
    tokens[:, p_len] = t_logits.argmax(dim=-1)
    pos = torch.full((b,), p_len, dtype=torch.long, device=dev)
    stats = torch.zeros((4,), dtype=torch.long, device=dev)

    def one_round():
        return _decode_round(params, draft_params, t_cache, d_cache, tokens, pos, stats,
                             cfg=cfg, gamma=gamma, total=total)

    run = (GraphedProgram("speculative round", one_round, dev)
           if dev.type == "cuda" and graphs_enabled() else one_round)
    while bool(run()):  # the round's one readback; every row starts short
        pass
    out = tokens[:, :total]
    if not return_stats:
        return out
    return out, SpecStats(*(stats[i].clone() for i in range(4)))
