"""Serving helpers shared by the engines (``k8s_dra_driver_tpu/models/serve.py``):
slot state, completions, admission checks, retirement, greedy sampling,
the continuous-batching ``_pump``; and, re-exported from ``models/graphs``,
:class:`GraphedProgram`, the counterpart of the reference's ``shared_jit``
(an engine program captured once as a CUDA graph and replayed), with
:func:`disable_graphs`.  The dense ``ServeEngine`` is not ported yet;
``models/paged.PagedServeEngine`` uses these."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from k8s_dra_driver_torch.models.graphs import (  # noqa: F401  (re-exported)
    GraphCaptureError,
    GraphedProgram,
    add_launch_counts,
    disable_graphs,
    graphs_enabled,
    launch_counts,
)


class NoCapacity(RuntimeError):
    """No free slot or not enough free pool blocks for a request right now
    (a RuntimeError, as the reference raises)."""


@dataclass
class _Slot:
    request_id: int
    tokens: list[int]  # prompt + generated so far
    prompt_len: int
    max_tokens: int
    # hard cap on GENERATED tokens, min'd with max_tokens (_slot_budget)
    deadline: int | None = None


@dataclass
class Completion:
    request_id: int
    tokens: list[int]  # prompt + generated
    generated: list[int]
    error: str = ""
    # "ok" (eos / max_tokens) or "deadline_exceeded"
    status: str = "ok"


def check_submit(
    prompt: list[int], max_tokens: int, prompt_bucket: int, max_seq: int,
    temperature: float = 0.0, deadline: int | None = None,
) -> None:
    """Admission validation shared by the engines."""
    if not prompt:
        raise ValueError("empty prompt")
    if max_tokens < 1:
        raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
    if deadline is not None and deadline < 1:
        raise ValueError(f"deadline must be >= 1 generated token, got {deadline}")
    if len(prompt) > prompt_bucket:
        raise ValueError(f"prompt {len(prompt)} exceeds bucket {prompt_bucket}")
    if len(prompt) + max_tokens > max_seq:
        raise ValueError("prompt + max_tokens exceeds max_seq")
    if temperature != 0.0:
        raise NotImplementedError(
            "sampled requests (temperature > 0) are not ported yet: the "
            "port serves greedy requests only"
        )


def _slot_budget(st: _Slot) -> int:
    """Generated-token budget: ``max_tokens`` capped by the deadline."""
    return st.max_tokens if st.deadline is None else min(st.max_tokens, st.deadline)


def completion_if_done(st: _Slot, eos_id: int | None, max_seq: int):
    """The Completion when the slot hit eos or its budget, else None."""
    n_gen = len(st.tokens) - st.prompt_len
    if len(st.tokens) > max_seq:
        raise RuntimeError("cache overrun: submit() invariant broken")
    budget = _slot_budget(st)
    hit_eos = eos_id is not None and st.tokens[-1] == eos_id
    if n_gen < budget and not hit_eos:
        return None
    status = "ok"
    if not hit_eos and budget < st.max_tokens:
        status = "deadline_exceeded"
    return Completion(
        request_id=st.request_id,
        tokens=list(st.tokens),
        generated=list(st.tokens[st.prompt_len:]),
        status=status,
    )


def sample_next(logits) -> torch.Tensor:
    """Greedy next token per row (``argmax``, first maximum on ties, as
    ``jnp.argmax``), int32."""
    return logits.argmax(dim=-1).to(torch.int32)


def _pump(engine, requests, max_steps: int) -> list:
    """Continuous-batching drive: admit queued ``(prompt, max_tokens)``
    pairs (or dicts of ``submit`` kwargs) FIFO as slots and blocks free,
    burst-step in between, return every completion."""
    queue = list(requests)
    out: list = []
    for _ in range(max_steps):
        admitted = False
        while queue and engine.free_slots() > 0:
            req = queue[0]
            try:
                if isinstance(req, dict):
                    engine.submit(**req)
                else:
                    prompt, max_tokens = req
                    engine.submit(prompt, max_tokens=max_tokens)
            except NoCapacity:
                break  # step until capacity frees
            queue.pop(0)
            admitted = True
        stepped = engine.step_burst()
        out.extend(engine.completions())
        if not queue and engine.free_slots() == engine.n_slots:
            return out
        if stepped == 0 and not admitted:
            raise RuntimeError(
                "pump wedged: queued or resident requests, no progress "
                f"({len(queue)} queued, {engine.free_blocks} free blocks)"
            )
    raise RuntimeError(f"pump did not drain in {max_steps} steps")
