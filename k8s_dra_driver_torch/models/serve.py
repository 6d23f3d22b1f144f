"""Serving helpers shared by the engines (``k8s_dra_driver_tpu/models/serve.py``):
slot state, completions, admission checks, retirement and its early funnel
(cancel, quarantine, a parked request's death), the sampling tail, the
fault window, the wedge error, the continuous-batching ``_pump``; and,
re-exported from ``models/graphs``,
:class:`GraphedProgram`, the counterpart of the reference's ``shared_jit``
(an engine program captured once as a CUDA graph and replayed), with
:func:`disable_graphs`.  The dense ``ServeEngine`` is not ported yet;
``models/paged.PagedServeEngine`` uses these."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from k8s_dra_driver_torch.models import prng
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
    # "ok" (eos / max_tokens), "deadline_exceeded", "cancelled",
    # "quarantined" or "error" (a re-admission that failed); all but "ok"
    # still deliver every token generated before the retirement
    status: str = "ok"


def check_submit(
    prompt: list[int], max_tokens: int, prompt_bucket: int, max_seq: int,
    temperature: float = 0.0, deadline: int | None = None,
) -> None:
    """Admission validation shared by the engines.  Any temperature is
    admitted: above 0 samples, 0 or below is greedy."""
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


def sample_next(logits, pos, temps, keys, *, top_k: int) -> torch.Tensor:
    """The per-slot sampling tail (``logits [B, V]`` f32 at positions ``pos
    [B]``): rows with ``temps > 0`` draw a categorical from the logits over
    the temperature, masked below the ``top_k``-th value when ``top_k >
    0``, under the step key ``fold_in(keys [B, 2], pos)``; the other rows
    take the argmax (the first maximum on ties, as ``jnp.argmax``).  Every
    row computes both, as the reference does.  Returns int32 ``[B]``."""
    greedy = logits.argmax(dim=-1)
    scaled = logits / temps.clamp_min(1e-6)[:, None]
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    sampled = prng.categorical(prng.fold_in(keys, pos), scaled)
    return torch.where(temps > 0.0, sampled, greedy).to(torch.int32)


def _early_retire(engine, slot: int, status: str, error: str) -> Completion:
    """Early retirement for cancellation and quarantine: free the slot,
    refund its pool blocks (the table row points at the null block
    again), deliver a typed Completion with every token so far."""
    st = engine._slots[slot]
    engine._slots[slot] = None
    engine._release_blocks(slot)
    return _retire_parked(engine, st, status, error)


def _retire_parked(engine, st: _Slot, status: str, error: str) -> Completion:
    """The slot-less twin of :func:`_early_retire`, for a request that ends
    while parked (cancelled, or its re-admission failed): the caller has
    unwound its blocks; this delivers the typed Completion (for both)."""
    done = Completion(
        request_id=st.request_id,
        tokens=list(st.tokens),
        generated=list(st.tokens[st.prompt_len:]),
        status=status,
        error=error,
    )
    engine._completions.append(done)
    return done


def _quarantine_slot(engine, slot: int, kind: str, detail: str = "") -> None:
    """Retire ONE poisoned slot as "quarantined" and count it; rows are
    independent, so the survivors' streams are those of a batch that never
    held it.  At ``quarantine_limit`` distinct requests the engine raises
    "engine poisoned"."""
    done = _early_retire(engine, slot, "quarantined", detail or kind)
    engine.quarantined.append(done.request_id)
    if len(engine.quarantined) >= engine.quarantine_limit:
        raise _wedge_error(
            engine,
            f"engine poisoned: {len(engine.quarantined)} requests "
            f"quarantined (limit {engine.quarantine_limit})",
        )


def _inject_step_faults(engine) -> tuple[np.ndarray, int]:
    """The fault window before a step dispatches (``utils/faults``): the
    step's added latency, then for each resident slot an injected
    ``StepFault`` (the slot quarantines here, before any state moves) or
    NaN logits (its row of the returned poison mask).  Returns ``(poison
    [n_slots] bool, slots quarantined)``."""
    poison = np.zeros((engine.n_slots,), bool)
    inj = engine.fault_injector
    if inj is None:
        return poison, 0
    from k8s_dra_driver_torch.utils.faults import StepFault

    inj.take_step_latency()
    hit = 0
    for slot, st in enumerate(engine._slots):
        if st is None:
            continue
        try:
            inj.maybe_raise_step(slot, engine._step_no)
        except StepFault as exc:
            _quarantine_slot(engine, slot, "step_raise", str(exc))
            hit += 1
            continue
        if inj.take_nan_logits(slot, engine._step_no):
            poison[slot] = True
    return poison, hit


def _first_bad_steps(trace_act, trace_bad) -> dict:
    """slot -> the first burst step whose logits went non-finite while the
    slot was active.  Tokens before it are sound; the slot quarantines
    there."""
    out: dict = {}
    bad = np.asarray(trace_act) & np.asarray(trace_bad)
    for j in range(bad.shape[0]):
        for slot in np.flatnonzero(bad[j]):
            out.setdefault(int(slot), j)
    return out


def _wedge_error(engine, reason: str, queue=None) -> RuntimeError:
    """The RuntimeError an engine that cannot go on raises ("engine
    wedged", "engine poisoned", "pump wedged"), with the state that says
    why: resident slots, parked requests, free blocks, stalls, the
    quarantined requests and the pump's queue depth."""
    resident = [st.request_id for st in engine._slots if st is not None]
    state = [
        f"resident {resident}",
        f"parked {[r['st'].request_id for r in getattr(engine, '_preempted', ())]}",
        f"free blocks {getattr(engine, 'free_blocks', None)}",
        f"stalled steps {getattr(engine, 'stalled_steps', None)}",
        f"quarantined {list(getattr(engine, 'quarantined', ()))}",
    ]
    if queue is not None:
        state.append(f"queued {len(queue)}")
    return RuntimeError(f"{reason} ({', '.join(state)})")


def _pump(engine, requests, max_steps: int) -> list:
    """Continuous-batching drive: admit queued ``(prompt, max_tokens)``
    pairs (or dicts of ``submit`` kwargs) FIFO as slots and blocks free,
    burst-step in between, return every completion once nothing is
    queued, resident or parked."""
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
                break  # out of slots or blocks, or requests parked: step
            queue.pop(0)
            admitted = True
        stepped = engine.step_burst()
        out.extend(engine.completions())
        if (not queue and engine.free_slots() == engine.n_slots
                and not getattr(engine, "_preempted", ())):
            return out
        if stepped == 0 and not admitted:
            raise _wedge_error(
                engine, "pump wedged: queued or resident requests, no progress",
                queue=queue,
            )
    raise _wedge_error(engine, f"pump did not drain in {max_steps} steps", queue=queue)
