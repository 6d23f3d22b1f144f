"""Continuous-batching serving (``k8s_dra_driver_tpu/models/serve.py``).

What the engines share: slot state and completions, admission checks,
retirement and its early funnel (cancel, quarantine, a parked request's
death), the sampling tail, the fault window, the wedge error, snapshot
entries and their restore checks, load shedding and the
continuous-batching ``_pump``; and, re-exported from ``models/graphs``,
:class:`GraphedProgram`, the counterpart of the reference's ``shared_jit``
(an engine program captured once as a CUDA graph and replayed), with
:func:`disable_graphs`.  ``models/paged.PagedServeEngine`` uses these.

The dense :class:`ServeEngine`: a fixed pool of slots over one dense KV
cache ``[L, n_slots, max_seq, Hkv, hd]``, its programs (admission, prefix-hit
admission, K-step bursts) written as plain functions on tensors that
update the cache in place, with a prefix cache, cancel, quarantine, and
snapshot and restore.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from k8s_dra_driver_torch.device import params_device
from k8s_dra_driver_torch.models import decode, prng
from k8s_dra_driver_torch.models.burnin import ModelConfig
from k8s_dra_driver_torch.models.graphs import (  # noqa: F401  (re-exported)
    GraphCaptureError,
    GraphedProgram,
    add_launch_counts,
    disable_graphs,
    graphs_enabled,
    launch_counts,
)
from k8s_dra_driver_torch.models.quant import quantize_blocks
from k8s_dra_driver_torch.models.speculative import accept_advance

# every Completion.status; a snapshot entry carrying one has already ended
TERMINAL_STATUSES = frozenset(
    {"ok", "deadline_exceeded", "cancelled", "quarantined", "shed", "error"}
)


class NoCapacity(RuntimeError):
    """No free slot or not enough free pool blocks for a request right now
    (a RuntimeError, as the reference raises)."""


class ShedError(RuntimeError):
    """A request rejected because the pump's admission queue is full (the
    serving 429); ``retry_after_s`` estimates when the queue will have
    drained: its depth times the engine's last step time."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class SnapshotRestoreError(ValueError):
    """A snapshot that cannot be restored as a whole: an entry carries a
    terminal status, so its completion was already delivered.  Raised
    before any engine state changes."""

    def __init__(self, request_id: int, status: str):
        super().__init__(
            f"snapshot entry req-{request_id} carries terminal status "
            f"{status!r}: the stream already ended and its completion was "
            f"delivered — restoring it would duplicate the request"
        )
        self.request_id = request_id
        self.status = status


def check_restorable(snapshot: dict) -> None:
    """Raise :class:`SnapshotRestoreError` for a snapshot holding an entry
    with a terminal status, before ``restore`` touches anything."""
    for req in snapshot.get("requests", ()):
        status = str(req.get("status", "") or "")
        if status in TERMINAL_STATUSES:
            raise SnapshotRestoreError(int(req.get("request_id", -1)), status)


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
    # one of TERMINAL_STATUSES: "ok" (eos / max_tokens),
    # "deadline_exceeded", "cancelled", "quarantined", "shed" (rejected by
    # the pump's queue limit, request id -1) or "error" (a re-admission or
    # restore that failed); all but "ok" and "shed" still deliver every
    # token generated before the retirement
    status: str = "ok"


def check_submit(
    prompt: list[int], max_tokens: int, prompt_bucket: int, max_seq: int,
    spec_gamma: int = 0, temperature: float = 0.0, deadline: int | None = None,
) -> None:
    """Admission validation shared by the engines.  Any temperature is
    admitted (above 0 samples, 0 or below is greedy) unless ``spec_gamma >
    0``: speculative serving verifies the argmax, so it takes temperature
    0 only, and needs the verify window's slack under ``max_seq``."""
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
    if spec_gamma > 0:
        if temperature != 0.0:
            raise ValueError("speculative serving verifies argmax — temperature must be 0")
        if _spec_slack_short(len(prompt), max_tokens, spec_gamma, max_seq):
            raise ValueError(
                "prompt + max_tokens needs spec_gamma verify-window slack under max_seq"
            )


def _spec_slack_short(prompt_len: int, max_tokens: int, gamma: int, max_seq: int) -> bool:
    """The exact bound: a slot's last round starts at ``pos = prompt_len +
    max_tokens - 2`` (one more committed token retires it) and writes its
    verify window at ``pos .. pos + gamma``, so the deepest write is
    ``prompt_len + max_tokens + gamma - 2``, which must be below
    ``max_seq``."""
    return prompt_len + max_tokens + gamma - 1 > max_seq


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
    """Early retirement for cancellation and quarantine: free the slot and
    release what it holds on the device (``engine._release_slot``: the
    paged engine refunds its pool blocks, the dense one clears its active
    row), deliver a typed Completion with every token so far."""
    st = engine._slots[slot]
    engine._slots[slot] = None
    engine._release_slot(slot)
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
    # a slot mid-admission is not decoding yet, and quarantining it would
    # orphan its admission-queue entry: the window skips it until it activates
    admitting = {a["slot"] for a in getattr(engine, "_admitting", ())}
    for slot, st in enumerate(engine._slots):
        if st is None or slot in admitting:
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
    why: resident slots, prompts still admitting, parked requests, free
    blocks, stalls, the quarantined requests and the pump's queue depth."""
    resident = [st.request_id for st in engine._slots if st is not None]
    admitting = [(engine._slots[a["slot"]].request_id, a["done"])
                 for a in getattr(engine, "_admitting", ())]
    state = [
        f"resident {resident}",
        f"admitting (request, blocks done) {admitting}",
        f"parked {[r['st'].request_id for r in getattr(engine, '_preempted', ())]}",
        f"free blocks {getattr(engine, 'free_blocks', None)}",
        f"stalled steps {getattr(engine, 'stalled_steps', None)}",
        f"quarantined {list(getattr(engine, 'quarantined', ()))}",
    ]
    if queue is not None:
        state.append(f"queued {len(queue)}")
    return RuntimeError(f"{reason} ({', '.join(state)})")


def _snapshot_request(st: _Slot, temp: float, key, adapter: int = 0,
                      priority: int = 0) -> dict:
    """One in-flight request as a JSON-serialisable snapshot entry: its
    token history (prompt + generated), the sampler state that reproduces
    its continuation (temperature and BASE key as plain ints: step keys
    are ``fold_in(base, pos)``), its adapter id and priority.  The same
    document as the reference's, less the telemetry trace."""
    return {
        "request_id": st.request_id,
        "tokens": [int(t) for t in st.tokens],
        "prompt_len": st.prompt_len,
        "max_tokens": st.max_tokens,
        "deadline": st.deadline,
        "temperature": float(temp),
        "key": [int(x) for x in np.asarray(key).tolist()],
        "adapter": int(adapter),
        "priority": int(priority),
    }


def _unrestorable(engine, req: dict, why: str) -> None:
    """A snapshot entry this engine cannot rebuild (history past the prompt
    bucket, or no free slot) is delivered as an "error" completion rather
    than dropped."""
    tokens = [int(t) for t in req["tokens"]]
    engine._completions.append(Completion(
        request_id=int(req["request_id"]),
        tokens=tokens,
        generated=tokens[int(req["prompt_len"]):],
        status="error",
        error=f"unrestorable: {why}",
    ))


def _shed(engine, req, depth: int, queue_limit: int) -> Completion:
    """Reject the newest queued request: count it, keep its
    :class:`ShedError` (retry after ``depth`` times the engine's last step
    time, at least 0.05 s) and return its "shed" Completion.  Host-only:
    the request never reaches ``submit``, so it costs no device work."""
    prompt = req.get("prompt") if isinstance(req, dict) else req[0]
    retry_after = round(max(0.05, depth * max(engine._last_step_s, 1e-3)), 3)
    err = ShedError(
        f"admission queue full ({depth} waiting > limit {queue_limit}); "
        f"retry after {retry_after}s",
        retry_after,
    )
    engine.shed_count += 1
    engine.last_shed = err
    return Completion(
        request_id=-1, tokens=list(prompt), generated=[], status="shed", error=str(err),
    )


def _pump(engine, requests, max_steps: int, queue_limit: int | None = None) -> list:
    """Continuous-batching drive: admit queued ``(prompt, max_tokens)``
    pairs (or dicts of ``submit`` kwargs) FIFO as capacity frees,
    burst-step in between, return every completion once nothing is
    queued, resident (a prompt still admitting holds its slot) or parked.
    ``queue_limit`` bounds the requests left waiting after each admission
    round: the overflow is shed newest-first (:func:`_shed`), so the oldest
    keep their place."""
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
        if queue_limit is not None:
            while len(queue) > queue_limit:
                out.append(_shed(engine, queue.pop(), len(queue) + 1, queue_limit))
        admitting = bool(getattr(engine, "_admitting", ()))  # a chunk advancing is progress
        stepped = engine.step_burst()
        out.extend(engine.completions())
        if (not queue and engine.free_slots() == engine.n_slots
                and not getattr(engine, "_preempted", ())):
            return out
        if stepped == 0 and not admitted and not admitting:
            raise _wedge_error(
                engine, "pump wedged: queued or resident requests, no progress",
                queue=queue,
            )
    raise _wedge_error(engine, f"pump did not drain in {max_steps} steps", queue=queue)


def run_program(engine, name: str, fn):
    """Run an engine's program ``fn`` (no arguments: it reads the engine's
    fixed buffers): eagerly on the CPU and under :func:`disable_graphs`,
    else as the engine's CUDA graph ``name`` (in ``engine._programs``),
    captured on its second call."""
    if engine.device.type != "cuda" or not graphs_enabled():
        return fn()
    prog = engine._programs.get(name)
    if prog is None:
        prog = engine._programs[name] = GraphedProgram(name, fn, engine.device)
    return prog()


def _burst_trace(step, k: int, last, pos, active, stop_pos, eos_id: int):
    """K steps with no host read inside, both engines' burst: ``step(last,
    pos, active) -> (next_token, bad)`` samples every row, then the
    on-device stop mask (``decode.advance_decode_state``) retires rows
    that hit eos or their stop depth.  Returns ``(trace [3, K, B] int32 —
    token / pre-step active / bad planes stacked for ONE readback, last,
    pos, active)``."""
    planes = []
    for _ in range(k):
        next_tok, bad = step(last, pos, active)
        new_last, new_pos, new_active = decode.advance_decode_state(
            next_tok, last, pos, active, stop_pos, eos_id
        )
        planes.append(torch.stack([next_tok, active.to(torch.int32), bad.to(torch.int32)]))
        last, pos, active = new_last, new_pos, new_active
    return torch.stack(planes, dim=1), last, pos, active


# -- the dense engine's programs (the reference's compiled ones) -------------

def _step_all_slots(params, cache, tokens, pos, active, temps, keys, poison=None,
                    *, cfg: ModelConfig, top_k: int):
    """One dense decode step for every slot at its own position
    (``decode.decode_step`` with the active gate), then the sampling tail.
    ``poison [B]`` turns rows' logits to NaN first; ``bad`` flags rows whose
    logits are not finite.  Rows stay independent.  Returns ``(next_token
    [B] int32, bad [B] bool, cache)``."""
    logits, cache = decode.decode_step(params, cache, tokens.long(), pos, cfg=cfg, active=active)
    logits = decode.poison_rows(logits, poison)
    bad = ~decode.finite_rows(logits)
    return sample_next(logits, pos, temps, keys, top_k=top_k), bad, cache


def _pipelined_burst(params, cache, tokens, pos, active, temps, keys, stop_pos, poison=None,
                     *, cfg: ModelConfig, top_k: int, eos_id: int, k: int):
    """K fused dense steps (:func:`_burst_trace`); ``temps``, ``keys`` and
    ``poison`` hold for the whole burst.  Returns ``(trace [3, K, B] int32,
    cache, last, pos, active)``."""

    def step(last, pos_, act):
        next_tok, bad, _ = _step_all_slots(
            params, cache, last, pos_, act, temps, keys, poison, cfg=cfg, top_k=top_k,
        )
        return next_tok, bad

    trace, last, pos, active = _burst_trace(step, k, tokens, pos, active, stop_pos, eos_id)
    return trace, cache, last, pos, active


def _commit_row_and_first_token(params, cache, row_k, row_v, prompt, plen, slot, temp, key,
                                *, cfg: ModelConfig, top_k: int):
    """The admission tail of both prefill paths: zero the row ``[L,
    max_seq, Hkv, hd]`` at positions ``>= plen`` and copy it into the slot,
    then compute the first token by re-running the step for all slots at
    ``plen - 1`` with only the slot active (the rewrite of that position is
    idempotent; the other rows keep their bytes), at the admission's
    temperature and key.  ``plen``, ``slot`` and ``temp`` are 0-d tensors
    and ``key`` a ``[2]`` one, so one captured program serves every
    admission.  Returns ``(token [1], cache)``."""
    n_slots, max_seq = cache.k.shape[1], cache.k.shape[2]
    dev = prompt.device
    keep = (torch.arange(max_seq, device=dev) < plen)[None, :, None, None]
    at = slot.view(1).long()
    for row, whole in ((row_k, cache.k), (row_v, cache.v)):
        whole.index_copy_(1, at, torch.where(keep, row, 0).to(whole.dtype)[:, None])
    last = (plen - 1).view(1)
    tokens = prompt[0].index_select(0, last).expand(n_slots)
    active = torch.arange(n_slots, device=dev) == slot
    tok, _, cache = _step_all_slots(
        params, cache, tokens, last.expand(n_slots), active, temp.expand(n_slots),
        key.expand(n_slots, 2), cfg=cfg, top_k=top_k,
    )
    return tok.index_select(0, at), cache


def _prefill_into_slot(params, cache, prompt, plen, slot, temp, key, *, cfg: ModelConfig,
                       top_k: int):
    """Fill one slot from the padded prompt ``[1, bucket]`` in one parallel
    forward (whose own last logits, at the bucket's end, are discarded),
    then the admission tail.  Returns ``(first token [1], cache)``."""
    row, _ = decode.prefill(params, prompt, cfg, max_seq=cache.k.shape[2],
                            cache_dtype=cache.k.dtype)
    return _commit_row_and_first_token(
        params, cache, row.k[:, 0], row.v[:, 0], prompt, plen, slot, temp, key,
        cfg=cfg, top_k=top_k,
    )


def _prefill_suffix_into_slot(params, cache, prefix_k, prefix_v, prompt, plen, slot, temp,
                              key, *, cfg: ModelConfig, top_k: int, prefix_bucket: int):
    """The prefix-cache hit: the stored prefix K/V (positions ``<
    prefix_bucket``, ``[L, prefix_bucket, Hkv, hd]``) in a fresh row, the
    suffix's K/V from one ``decode_chunk`` at ``pos0 = prefix_bucket`` over
    the prompt bucket's key window (the full prefill's), then the
    admission tail.  Returns ``(first token [1], cache)``."""
    row = decode.init_cache(cfg, 1, cache.k.shape[2], dtype=cache.k.dtype, device=prompt.device)
    row.k[:, 0, :prefix_bucket] = prefix_k
    row.v[:, 0, :prefix_bucket] = prefix_v
    _, row = decode.decode_chunk(params, row, prompt[:, prefix_bucket:], prefix_bucket,
                                 cfg=cfg, k_window=prompt.shape[1])
    return _commit_row_and_first_token(
        params, cache, row.k[:, 0], row.v[:, 0], prompt, plen, slot, temp, key,
        cfg=cfg, top_k=top_k,
    )


def _extract_prefix(cache, slot: int, *, prefix_bucket: int):
    """A copy of the slot's K/V at positions ``< prefix_bucket`` (a store
    entry): a view would change when the slot's next request overwrites
    the row."""
    return (cache.k[:, slot, :prefix_bucket].clone(),
            cache.v[:, slot, :prefix_bucket].clone())


# -- speculative rounds, shared by the dense and paged engines ----------------

def make_draft_state(params, draft_params, cfg: ModelConfig, n_slots: int, cache_dtype,
                     device):
    """The draft of speculative serving and its dense cache ``[n_draft,
    n_slots, max_seq, Hkv, hd]``, built at the draft's depth (never at full
    depth first).  With no draft given, the draft is the int8
    self-quantization of ``params``.  Returns ``(draft_params, d_cache)``."""
    if draft_params is None:
        draft_params = quantize_blocks(params)
    params_device(draft_params, device)
    shape = (len(draft_params["blocks"]), n_slots, cfg.max_seq, cfg.kv_heads, cfg.head_dim)
    return draft_params, decode.KVCache(
        *(torch.zeros(shape, dtype=cache_dtype, device=device) for _ in range(2))
    )


def _prefill_draft_row(draft_params, d_cache, prompt, plen, slot, *, cfg: ModelConfig):
    """Fill one slot's draft cache from the padded prompt ``[1, bucket]``
    (k/v only: the draft's logits are never read), positions ``>= plen``
    zeroed, so nothing of the slot's last request stays behind.  ``plen``
    and ``slot`` are 0-d tensors: one captured program serves every
    admission.  Returns ``d_cache``, updated in place."""
    n_draft, _, max_seq = d_cache.k.shape[:3]
    dev = prompt.device
    row = decode.KVCache(*(
        torch.zeros((n_draft, 1, max_seq, cfg.kv_heads, cfg.head_dim), dtype=d_cache.k.dtype,
                    device=dev)
        for _ in range(2)
    ))
    decode.decode_chunk(draft_params, row, prompt, 0, cfg=cfg, k_window=prompt.shape[1],
                        logits=False)
    keep = (torch.arange(max_seq, device=dev) < plen)[None, :, None, None]
    at = slot.view(1).long()
    for part, whole in ((row.k, d_cache.k), (row.v, d_cache.v)):
        whole.index_copy_(1, at, torch.where(keep, part[:, 0], 0)[:, None])
    return d_cache


def draft_propose(draft_params, d_cache, last, pos, active, *, cfg: ModelConfig, gamma: int):
    """Sequential draft proposals from each row's frontier (``last [B]`` at
    ``pos [B]``): ``gamma`` steps, then one more that feeds ``g_gamma`` so
    its draft key exists when full acceptance commits the bonus token (its
    logits are never read, so it stops after the last k/v write).  Returns
    ``(d_cache, proposed [B, gamma] int32)``."""
    tok, proposed = last, []
    for i in range(gamma):
        logits, _ = decode.decode_step(draft_params, d_cache, tok.long(), pos + i, cfg=cfg,
                                       active=active)
        tok = logits.argmax(dim=-1).to(torch.int32)
        proposed.append(tok)
    decode.decode_chunk(draft_params, d_cache, tok.long()[:, None], pos + gamma, cfg=cfg,
                        active=active, logits=False)
    return d_cache, torch.stack(proposed, dim=1)


def _spec_round(params, draft_params, cache, d_cache, last, pos, active, *,
                cfg: ModelConfig, gamma: int):
    """One speculative round for every active slot at its own position:
    the draft's proposals, then the target scores ``[last, g_1..g_gamma]``
    in one ``decode.decode_chunk`` (rejected positions go stale in place
    and are rewritten from the committed frontier before any query attends
    them).  An inactive row may sit past the slack after its last round
    (the host clipped its commit); its writes are masked, and its position
    is clamped to keep the indices in the cache (the reference's scatter
    drops them): an active row is never clamped (``check_submit``).
    Returns ``(target [B, gamma + 1] int32, advance [B] int32, cache,
    d_cache)``: a row commits its first ``advance`` targets."""
    pos = pos.clamp(max=cfg.max_seq - 1 - gamma)
    d_cache, proposed = draft_propose(draft_params, d_cache, last, pos, active, cfg=cfg,
                                      gamma=gamma)
    window = torch.cat([last[:, None], proposed], dim=1)
    logits, cache = decode.decode_chunk(params, cache, window.long(), pos, cfg=cfg, active=active)
    target = logits.argmax(dim=-1).to(torch.int32)
    _, advance = accept_advance(proposed, target, active)
    return target, advance, cache, d_cache


def _spec_advance(target, advance, last, pos, active):
    """A round's tail in both engines' programs: each active row's last
    token becomes its last committed target and its position moves by
    ``advance`` (0 on inactive rows), in place.  Returns ``[B, gamma + 2]``
    int32, the targets and the advance side by side for ONE readback."""
    rows = torch.arange(target.shape[0], device=target.device)
    new_last = target[rows, (advance - 1).clamp_min(0)]
    last.copy_(torch.where(active, new_last, last))
    pos.add_(advance)
    return torch.cat([target, advance[:, None]], dim=1)


def _commit_spec_round(engine, readback, active) -> None:
    """Append each active resident slot's accepted tokens from a round's
    readback ``[n_slots, gamma + 2]``, clipped at eos and at the budget
    (the device state past the clip goes stale with the slot), count the
    proposals and acceptances, and retire the finished slots."""
    gamma = engine.spec_gamma
    for slot, st in enumerate(engine._slots):
        if st is None or not active[slot]:
            continue
        advance = int(readback[slot, gamma + 1])
        engine.spec_drafted += gamma
        engine.spec_accepted += advance - 1
        for j in range(advance):
            st.tokens.append(int(readback[slot, j]))
            hit_eos = engine.eos_id is not None and st.tokens[-1] == engine.eos_id
            if len(st.tokens) - st.prompt_len >= _slot_budget(st) or hit_eos:
                break
        engine._retire(slot)


def _spec_unrestorable(engine, req: dict) -> str:
    """Why a snapshot entry cannot continue under this engine's speculative
    rounds ("" when it can): rounds verify the argmax, and the entry's
    budget must leave the verify window's slack (``check_submit``'s
    rules)."""
    if engine.spec_gamma <= 0:
        return ""
    if float(req["temperature"]) != 0.0:
        return "speculative serving verifies argmax — temperature must be 0"
    if _spec_slack_short(int(req["prompt_len"]), int(req["max_tokens"]), engine.spec_gamma,
                         engine.cfg.max_seq):
        return "prompt + max_tokens needs spec_gamma verify-window slack under max_seq"
    return ""


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch engine yet (ROADMAP.md queue 1 item {item})"
    )


@dataclass
class ServeEngine:
    """Continuous batching over a dense KV cache.

    * ``submit`` prefills the whole prompt (padded to ``prompt_bucket``)
      into the first free slot in one forward and samples its first token;
      each request has its temperature (0 or below: greedy) and a seed for
      its base key (default its request id); ``top_k`` is the engine's;
    * with ``prefix_bucket`` set, the K/V of each distinct
      ``prompt[:prefix_bucket]`` is stored once (LRU over
      ``prefix_cache_entries``), and a later prompt that shares it and is
      longer computes only its suffix; the streams are those of the full
      prefill;
    * ``step_burst`` runs ``sync_interval`` device steps with ONE
      device-to-host readback (``host_syncs`` counts them; admissions'
      first-token reads are not counted); ``step`` is a burst of one,
      committing, retiring and quarantining in the order of the
      reference's ``step``;
    * ``cancel`` retires a request "cancelled"; a slot whose logits go
      non-finite retires "quarantined" (``fault_injector`` can poison one),
      and at ``quarantine_limit`` distinct requests the engine raises
      "engine poisoned";
    * ``snapshot_active`` captures every in-flight request as JSON, and
      ``restore`` rebuilds them in an idle engine (or, with ``merge``, in
      free slots of a live one) by re-prefilling each history, so every
      stream continues as it would have;
    * ``pump(queue_limit=...)`` sheds what overflows its queue;
    * with ``spec_gamma > 0`` every ``step`` (and ``step_burst``, which
      hands over to it) is one speculative round: the draft
      (``draft_params``, by default the int8 self-quantization of
      ``params``) proposes ``spec_gamma`` tokens for each slot over its own
      dense cache, the target verifies them in one pass, and each slot
      commits up to ``spec_gamma + 1`` tokens with one readback; the
      streams are the greedy ones (submits take temperature 0 only, with
      the verify window's slack under ``max_seq``).

    Runs on ``device`` (default the card; raises without one unless
    ``device="cpu"``); ``params`` must live there.  On the card each of the
    reference's compiled programs (admission, prefix-hit admission, the
    burst at ``sync_interval`` and at 1; with ``spec_gamma`` the "spec
    round" and the "draft prefill" in the bursts' place) runs as a CUDA
    graph (``GraphedProgram``; at most four an engine, in ``graphs``),
    eagerly inside ``disable_graphs()``; on the CPU it runs eagerly.  The
    device state those programs read and write (the cache and the draft
    cache; per slot the active mask, last token, position, stop depth,
    temperature, base key and poison mask; the admission's padded prompt,
    length and slot, temperature and key, and the prefix-hit staging K/V)
    keeps one address for the engine's life and is written in place.  A
    mesh, LoRA adapters, handoff with KV payloads and ``stats()`` raise
    ``NotImplementedError``.  Not thread-safe; drive it from one loop.
    """

    params: dict
    cfg: ModelConfig
    n_slots: int = 8
    prompt_bucket: int = 64
    cache_dtype: torch.dtype = torch.float32
    eos_id: int | None = None
    top_k: int = 0           # 0 = no top-k mask; static, one program set
    sync_interval: int = 1
    prefix_bucket: int | None = None
    prefix_cache_entries: int = 8
    fault_injector: object | None = None  # utils/faults.FaultInjector
    quarantine_limit: int = 3  # distinct quarantined requests before "poisoned"
    mesh: object | None = None
    spec_gamma: int = 0      # > 0: speculative rounds of this many draft tokens
    draft_params: object = None  # the draft; None: the int8 self-draft
    adapter_bank: dict | None = None
    device: object = "cuda"

    def __post_init__(self):
        cfg = self.cfg
        if self.mesh is not None:
            raise _unported("a mesh (slot sharding)", 15)
        if self.adapter_bank is not None:
            raise _unported("per-request LoRA (adapter_bank)", 8)
        if self.prompt_bucket > cfg.max_seq:
            raise ValueError(
                f"prompt_bucket ({self.prompt_bucket}) exceeds max_seq ({cfg.max_seq})"
            )
        if not 0 <= self.top_k <= cfg.vocab_size:
            raise ValueError(
                f"top_k ({self.top_k}) must be in [0, vocab_size={cfg.vocab_size}]"
            )
        if self.sync_interval < 1:
            raise ValueError(f"sync_interval must be >= 1, got {self.sync_interval}")
        if self.quarantine_limit < 1:
            raise ValueError(f"quarantine_limit must be >= 1, got {self.quarantine_limit}")
        if self.prefix_bucket is not None:
            if not 0 < self.prefix_bucket < self.prompt_bucket:
                raise ValueError(
                    f"prefix_bucket ({self.prefix_bucket}) must be in "
                    f"(0, prompt_bucket={self.prompt_bucket})"
                )
            if self.prefix_cache_entries < 1:
                raise ValueError("prefix_cache_entries must be >= 1")
        self.device = dev = params_device(self.params, self.device)
        self._slots: list = [None] * self.n_slots
        self._next_id = 0
        self._step_no = 0        # the fault window's step number
        self._last_step_s = 0.0  # wall time of the last step or burst
        self._completions: list = []
        self.host_syncs = 0      # decode-loop readbacks (admissions excluded)
        self.quarantined: list[int] = []  # quarantined request ids
        self.shed_count = 0
        self.last_shed: ShedError | None = None
        self._prefix_store: OrderedDict = OrderedDict()
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.spec_drafted = 0    # draft tokens proposed to active slots
        self.spec_accepted = 0   # of those, the ones the target agreed with
        self._cache = decode.init_cache(
            cfg, self.n_slots, cfg.max_seq, dtype=self.cache_dtype, device=dev
        )
        self._d_cache = None
        if self.spec_gamma > 0:
            self.draft_params, self._d_cache = make_draft_state(
                self.params, self.draft_params, cfg, self.n_slots, self.cache_dtype, dev
            )
        # the programs' device state: one address each for the engine's life
        i32 = dict(dtype=torch.int32, device=dev)
        self._active = torch.zeros((self.n_slots,), dtype=torch.bool, device=dev)
        self._last, self._pos, self._stop_pos = (
            torch.zeros((self.n_slots,), **i32) for _ in range(3)
        )
        self._temps = torch.zeros((self.n_slots,), dtype=torch.float32, device=dev)
        self._keys = torch.zeros((self.n_slots, 2), dtype=torch.int64, device=dev)
        self._poison = torch.zeros((self.n_slots,), dtype=torch.bool, device=dev)
        self._poison_np = np.zeros((self.n_slots,), bool)  # what _poison holds
        self._prompt = torch.zeros((1, self.prompt_bucket), **i32)   # padded
        self._admit = torch.zeros((2,), **i32)                       # (plen, slot)
        self._admit_temp = torch.zeros((), dtype=torch.float32, device=dev)
        self._admit_key = torch.zeros((2,), dtype=torch.int64, device=dev)
        if self.prefix_bucket is not None:  # a hit's stored prefix, staged
            shape = (cfg.n_layers, self.prefix_bucket, cfg.kv_heads, cfg.head_dim)
            self._prefix_k, self._prefix_v = (
                torch.zeros(shape, dtype=self.cache_dtype, device=dev) for _ in range(2)
            )
        self._eos = -1 if self.eos_id is None else self.eos_id
        self._programs: dict[str, GraphedProgram] = {}

    # -- public API --------------------------------------------------------
    def free_slots(self) -> int:
        return sum(1 for s in self._slots if s is None)

    def submit(self, prompt: list[int], max_tokens: int, temperature: float = 0.0,
               seed: int | None = None, adapter: int = 0, deadline: int | None = None,
               queued_at: float | None = None, handoff: bool = False) -> int:
        """Prefill ``prompt`` into a free slot and sample its first token;
        raises ``NoCapacity`` (a RuntimeError) when no slot is free.
        ``temperature`` above 0 samples under the base key
        ``PRNGKey(seed)`` (default the request id); ``deadline`` caps the
        generated tokens and types the completion "deadline_exceeded" when
        it binds first.  ``queued_at`` is accepted for the telemetry the
        reference stamps with it (not ported).  Returns the request id."""
        del queued_at
        check_submit(prompt, max_tokens, self.prompt_bucket, self.cfg.max_seq,
                     spec_gamma=self.spec_gamma, temperature=temperature, deadline=deadline)
        if adapter:
            raise _unported("per-request LoRA (adapter != 0)", 8)
        if handoff:
            raise _unported("handoff with a KV payload", 11)
        try:
            slot = self._slots.index(None)
        except ValueError:
            raise NoCapacity("no free slot") from None
        request_id = self._next_id
        base_key = prng.prng_key(request_id if seed is None else seed)
        self._stage_admission(prompt, slot, temperature, base_key)
        prefix_key = (
            tuple(prompt[: self.prefix_bucket])
            if self.prefix_bucket is not None and len(prompt) > self.prefix_bucket
            else None
        )
        if prefix_key is not None and prefix_key in self._prefix_store:
            self._prefix_store.move_to_end(prefix_key)  # LRU touch
            pk, pv = self._prefix_store[prefix_key]
            self._prefix_k.copy_(pk)
            self._prefix_v.copy_(pv)
            self.prefix_hits += 1
            first_tok = self._run("prefix admission", self._prefix_admission)
        else:
            first_tok = self._run("admission", self._admission)
            if prefix_key is not None:
                self.prefix_misses += 1
                self._prefix_store[prefix_key] = _extract_prefix(
                    self._cache, slot, prefix_bucket=self.prefix_bucket
                )
                while len(self._prefix_store) > self.prefix_cache_entries:
                    self._prefix_store.popitem(last=False)
        self._prefill_draft()
        self._next_id += 1
        st = _Slot(request_id, list(prompt) + [int(first_tok)], len(prompt), max_tokens,
                   deadline)
        self._slots[slot] = st
        self._set_row(slot, st, temperature, base_key)
        self._retire(slot)  # max_tokens=1 or eos on the first token
        return request_id

    def cancel(self, request_id: int) -> bool:
        """Retire a resident request "cancelled" with its tokens so far
        (between steps).  Returns whether the id was resident."""
        for slot, st in enumerate(self._slots):
            if st is not None and st.request_id == request_id:
                _early_retire(self, slot, "cancelled", "cancelled by caller")
                return True
        return False

    def step(self) -> int:
        """Advance every resident slot one token (a burst of one step);
        returns the number of resident slots stepped (or quarantined by
        the fault window)."""
        return self._step(1)

    def step_burst(self) -> int:
        """Advance every resident slot up to ``sync_interval`` tokens with
        ONE device-to-host readback; the host then replays the burst in
        step order, committing a token exactly where the one-step loop
        would.  Returns the number of resident slots at the burst's start
        (or quarantined by the fault window)."""
        return self._step(self.sync_interval)

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self.step_burst() == 0:
                return
        raise _wedge_error(self, "serving loop did not drain")

    def pump(self, requests, max_steps: int = 100_000, queue_limit: int | None = None) -> list:
        """Admit ``requests`` (``(prompt, max_tokens)`` pairs or dicts of
        ``submit`` kwargs) FIFO as slots free, burst-stepping in between;
        ``queue_limit`` sheds what overflows the waiting queue.  Returns
        the completions (see :func:`_pump`)."""
        return _pump(self, requests, max_steps, queue_limit)

    def completions(self) -> list:
        out, self._completions = self._completions, []
        return out

    def stats(self):
        raise _unported("stats() (request telemetry)", 12)

    def snapshot_active(self, include_kv: bool = False) -> dict:
        """Every in-flight request as a JSON-serialisable document (token
        history, temperature and base key, deadline); one readback of the
        per-slot sampler state, no decode step.  A fresh engine continues
        every stream from it with :meth:`restore`."""
        if include_kv:
            raise _unported("snapshot_active(include_kv=True)", 11)
        temps = self._temps.to("cpu", copy=True).numpy()
        keys = self._keys.to("cpu", copy=True).numpy()
        reqs = [_snapshot_request(st, float(temps[i]), keys[i])
                for i, st in enumerate(self._slots) if st is not None]
        return {"engine": type(self).__name__, "next_id": self._next_id, "requests": reqs}

    def restore(self, snapshot: dict, merge: bool = False) -> list[int]:
        """Rebuild a snapshot's requests in this engine: each history
        re-prefills through the admission program under the entry's
        temperature and key (bypassing the prefix store), its sampled
        token is discarded, and the frontier re-arms at ``_last =
        tokens[-1]``, ``_pos = len(tokens) - 1``, so the next step samples
        what the old engine would have.  Needs an idle engine unless
        ``merge``, which fills free slots of a live one.  An entry longer
        than the prompt bucket, or one that finds no free slot, comes back
        as an "error" completion.  Returns the restored ids."""
        check_restorable(snapshot)
        for req in snapshot["requests"]:
            if "kv" in req:
                raise _unported("restoring a KV payload", 11)
            if int(req.get("adapter", 0)):
                raise _unported("per-request LoRA (adapter != 0)", 8)
        if not merge and self.n_slots - self.free_slots():
            raise RuntimeError("restore() needs an idle engine")
        restored: list[int] = []
        for req in sorted(snapshot["requests"], key=lambda r: r["request_id"]):
            tokens = [int(t) for t in req["tokens"]]
            if len(tokens) > self.prompt_bucket:
                _unrestorable(self, req, f"history {len(tokens)} exceeds prompt_bucket "
                                         f"{self.prompt_bucket}")
                continue
            why = _spec_unrestorable(self, req)
            if why:
                _unrestorable(self, req, why)
                continue
            try:
                slot = self._slots.index(None)
            except ValueError:
                _unrestorable(self, req, f"no free slot in {self.n_slots}")
                continue
            temp = float(req["temperature"])
            # keys arrive as plain ints up to 2^32 - 1: int64 holds them
            key = torch.tensor([int(x) for x in req["key"]], dtype=torch.int64)
            self._stage_admission(tokens, slot, temp, key)
            self._run("admission", self._admission)  # its token is not read
            self._prefill_draft()
            st = _Slot(int(req["request_id"]), tokens, int(req["prompt_len"]),
                       int(req["max_tokens"]), req.get("deadline"))
            self._slots[slot] = st
            self._set_row(slot, st, temp, key)
            restored.append(st.request_id)
            self._retire(slot)  # the history may already sit at its budget
        self._next_id = max(
            self._next_id,
            int(snapshot.get("next_id", 0)),
            max((int(r["request_id"]) for r in snapshot["requests"]), default=-1) + 1,
        )
        return restored

    def release_active(self) -> int:
        """Free every resident slot WITHOUT delivering completions (its
        streams were captured by ``snapshot_active`` and live elsewhere
        now).  Returns how many were released."""
        released = 0
        for slot, st in enumerate(self._slots):
            if st is not None:
                self._slots[slot] = None
                self._release_slot(slot)
                released += 1
        return released

    # -- internals ---------------------------------------------------------
    def _step(self, k: int) -> int:
        """Open the fault window and run a K-step burst over the resident
        slots (``step`` asks for K = 1)."""
        if self.free_slots() == self.n_slots:
            return 0
        if self.spec_gamma > 0:
            return self._spec_step()
        self._step_no += 1
        poison, quarantined = _inject_step_faults(self)
        n_active = self.n_slots - self.free_slots()
        if n_active == 0:
            return quarantined  # quarantining is progress
        t0 = time.perf_counter()
        if (poison != self._poison_np).any():
            self._poison.copy_(torch.from_numpy(poison))
            self._poison_np = poison
        trace = self._run(f"burst k={k}", self._burst_program(k))
        trace_t, trace_a, trace_b = trace.cpu().numpy()  # the burst's one readback
        self.host_syncs += 1
        trace_a = trace_a.astype(bool)
        first_bad = _first_bad_steps(trace_a, trace_b.astype(bool))
        for j in range(k):
            for slot, st in enumerate(self._slots):
                if st is None or not trace_a[j][slot]:
                    continue
                if k == 1 and slot in first_bad:  # the reference's step(): in slot order
                    _quarantine_slot(self, slot, "nan_logits",
                                     "non-finite logits in decode step")
                elif j < first_bad.get(slot, k):
                    st.tokens.append(int(trace_t[j][slot]))
                    self._retire(slot)
        for slot in sorted(first_bad):
            if self._slots[slot] is not None:
                _quarantine_slot(self, slot, "nan_logits",
                                 f"non-finite logits at burst step {first_bad[slot]}")
        self._last_step_s = time.perf_counter() - t0
        return n_active

    def _spec_step(self) -> int:
        """One speculative round for every resident slot (the reference's
        round runs no fault window): up to ``spec_gamma + 1`` tokens commit
        per slot, with one readback."""
        t0 = time.perf_counter()
        n_active = self.n_slots - self.free_slots()
        readback = self._run("spec round", self._spec_program).cpu().numpy()
        self.host_syncs += 1
        _commit_spec_round(self, readback, [st is not None for st in self._slots])
        self._last_step_s = time.perf_counter() - t0
        return n_active

    def _prefill_draft(self) -> None:
        """With speculation on, fill the staged admission's draft row (its
        whole padded prompt, a prefix hit's too)."""
        if self.spec_gamma > 0:
            self._run("draft prefill", self._draft_prefill)

    def _stage_admission(self, tokens: list[int], slot: int, temperature: float, key) -> None:
        """Write an admission's inputs into the admission buffers."""
        padded = np.zeros((1, self.prompt_bucket), np.int32)
        padded[0, : len(tokens)] = tokens
        self._prompt.copy_(torch.from_numpy(padded))
        self._admit.copy_(torch.tensor([len(tokens), slot], dtype=torch.int32))
        self._admit_temp.fill_(temperature)
        self._admit_key.copy_(key)

    def _set_row(self, slot: int, st, temperature: float, key) -> None:
        """A resident slot's device row: active, last token, position
        (``len(tokens) - 1``), stop depth (from the original prompt length
        and budget), temperature and base key."""
        self._active[slot] = True
        self._last[slot] = st.tokens[-1]
        self._pos[slot] = len(st.tokens) - 1
        self._stop_pos[slot] = st.prompt_len + _slot_budget(st) - 1
        self._temps[slot] = temperature
        self._keys[slot] = key

    def _release_slot(self, slot: int) -> None:
        """A freed slot's row stops stepping; its stale K/V are masked out
        until an admission rewrites them."""
        self._active[slot] = False

    def _retire(self, slot: int) -> None:
        done = completion_if_done(self._slots[slot], self.eos_id, self.cfg.max_seq)
        if done is not None:
            self._completions.append(done)
            self._slots[slot] = None
            self._release_slot(slot)

    # -- the programs (the reference's compiled ones) ------------------------
    @property
    def graphs(self) -> dict:
        """The engine's CUDA graphs by program name (none on the CPU or
        under ``disable_graphs()``)."""
        return dict(self._programs)

    def _run(self, name: str, fn):
        return run_program(self, name, fn)

    def _admission(self):
        tok, _ = _prefill_into_slot(
            self.params, self._cache, self._prompt, self._admit[0], self._admit[1],
            self._admit_temp, self._admit_key, cfg=self.cfg, top_k=self.top_k,
        )
        return tok

    def _prefix_admission(self):
        tok, _ = _prefill_suffix_into_slot(
            self.params, self._cache, self._prefix_k, self._prefix_v, self._prompt,
            self._admit[0], self._admit[1], self._admit_temp, self._admit_key, cfg=self.cfg,
            top_k=self.top_k, prefix_bucket=self.prefix_bucket,
        )
        return tok

    def _draft_prefill(self) -> None:
        _prefill_draft_row(self.draft_params, self._d_cache, self._prompt, self._admit[0],
                           self._admit[1], cfg=self.cfg)

    def _spec_program(self):
        target, advance, _, _ = _spec_round(
            self.params, self.draft_params, self._cache, self._d_cache, self._last, self._pos,
            self._active, cfg=self.cfg, gamma=self.spec_gamma,
        )
        return _spec_advance(target, advance, self._last, self._pos, self._active)

    def _burst_program(self, k: int):
        def burst():
            trace, _, last, pos, _ = _pipelined_burst(
                self.params, self._cache, self._last, self._pos, self._active, self._temps,
                self._keys, self._stop_pos, self._poison, cfg=self.cfg, top_k=self.top_k,
                eos_id=self._eos, k=k,
            )
            self._last.copy_(last)
            self._pos.copy_(pos)
            return trace
        return burst
