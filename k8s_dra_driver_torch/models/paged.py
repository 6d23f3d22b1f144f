"""Paged KV cache and the paged serving engine
(``k8s_dra_driver_tpu/models/paged.py``).

KV lives in a pool of fixed-size blocks, ``[L, n_blocks, Hkv, hd, bs]``
per k/v (positions contiguous on the last axis, the JAX package's layout),
shared by all slots; each slot's block table lists its blocks in order.
Pool block 0 is the NULL block: never allocated, the table entry of every
unused position.  The allocator is host-side; everything per token runs on
the device.

Unlike the reference, which threads pools functionally, the port updates
them IN PLACE: ``paged_decode_chunk`` and ``paged_prefill`` write into the
tensors they are given and return the same tensors.  A failed admission
therefore leaves bytes behind only in the blocks it had allocated (freed
again on the failure) and in the null block, which nothing reads as
history.

Every decode step goes through ``ops/paged_attention.paged_append_attention``
(the CUDA kernel on the card, its plain version on the CPU), with
``write_mask=active``: inactive rows, whose tables may be stale, never
write.  The reference's plain path instead diverts their writes to the
null block, so pool bytes of the two packages agree outside block 0.

Streams equal the reference's, greedy and sampled (tested on the CPU):
the sampling tail is ``serve.sample_next``, keyed per slot by
``fold_in(base key, position)``, so a request preempted, parked and
re-admitted continues exactly where it stopped.  Not ported yet, absent
from the engine's fields: chunked prefill, prefix sharing, speculative
rounds, LoRA, quantized KV pools, meshes, handoff and telemetry.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from k8s_dra_driver_torch.device import params_device, resolve_device
from k8s_dra_driver_torch.models import decode, prng, serve
from k8s_dra_driver_torch.models.burnin import (
    ModelConfig,
    mlp_residual,
    qkv_proj,
    tied_logits,
)
from k8s_dra_driver_torch.models.quant import matmul_last as _mm
from k8s_dra_driver_torch.ops import paged_attention

NULL_BLOCK = 0  # reserved: never allocated, the table's filler


class PagedKVCache(NamedTuple):
    """Per-layer stacked block pools ``[L, n_blocks, Hkv, hd, block_size]``."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def block_size(self) -> int:
        return self.k.shape[4]


def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                     dtype=torch.float32, device="cuda") -> PagedKVCache:
    """A zeroed pool on ``device`` (the card by default; raises without
    one unless the caller passes ``device="cpu"``)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, n_blocks, cfg.kv_heads, cfg.head_dim, block_size)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def kv_block_bytes(cfg: ModelConfig, block_size: int, dtype=torch.float32) -> int:
    """Bytes ONE pool block costs across all layers, k + v."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2 * cfg.n_layers * cfg.kv_heads * cfg.head_dim * block_size * itemsize


class OutOfBlocks(RuntimeError):
    """Pool exhausted."""


class BlockAllocator:
    """Host-side free list over pool blocks 1..n_blocks-1 (0 is the null
    block), with the reference's reference counts (one per block until
    prefix sharing is ported) so a double free raises.  LIFO reuse: the
    lowest free id first, so tables are deterministic (the reference's
    order, block for block)."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is the null block), got {n_blocks}")
        self._free = list(range(n_blocks - 1, 0, -1))  # pop() -> lowest id first
        self._refs: dict[int, int] = {}
        self.n_blocks = n_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> list[int]:
        if n > len(self._free):
            raise OutOfBlocks(
                f"requested {n} blocks, {len(self._free)} free of {self.n_blocks - 1}"
            )
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._refs[i] = 1
        return ids

    def free(self, ids) -> None:
        """Drop one reference per id, atomically: the whole list is
        validated before any block is released."""
        ids = [int(i) for i in ids]
        drops: dict[int, int] = {}
        for i in ids:
            if not 0 < i < self.n_blocks:
                raise ValueError(f"block id {i} out of range (null block is 0)")
            drops[i] = drops.get(i, 0) + 1
        for i, n in drops.items():
            if self._refs.get(i, 0) < n:
                raise ValueError(f"double free of block {i}")
        for i in ids:
            refs = self._refs[i]
            if refs == 1:
                del self._refs[i]
                self._free.append(i)
            else:
                self._refs[i] = refs - 1


def blocks_needed(tokens: int, block_size: int) -> int:
    return -(-tokens // block_size)


def paged_decode_chunk(params, cache: PagedKVCache, block_table, window, pos,
                       *, cfg: ModelConfig, active=None):
    """Score ``window [B, S]`` (token j at ``pos + j``, ``pos [B]``) in one
    pass over the paged cache: per layer, append the window's k/v to the
    pool (rows with ``active`` false do not write) and attend positions
    ``<= pos + j``.  Returns ``(logits [B, S, V] f32, cache)``, the pools
    updated in place."""
    b, s = window.shape
    dev = window.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(b)
    positions = pos.long()[:, None] + torch.arange(s, device=dev)[None, :]
    x = params["embed"][window.long()]
    if not cfg.rope:
        x = x + params["pos_embed"][positions]
    write_mask = None if active is None else active.to(torch.int32)  # once, not per layer
    for li, p in enumerate(params["blocks"]):
        q, k, v = qkv_proj(x, p, cfg, positions=positions)
        attn, _, _ = paged_attention.paged_append_attention(
            q, k, v, cache.k, cache.v, block_table, pos, li, write_mask=write_mask,
        )
        x = x + _mm(attn.reshape(b, s, cfg.d_model), p["attn_out"])
        x = mlp_residual(x, p)
    return tied_logits(x, params), cache


def paged_decode_step(params, cache: PagedKVCache, block_table, token, pos,
                      *, cfg: ModelConfig, active=None):
    """The S=1 view of :func:`paged_decode_chunk`: ``token [B]`` at
    ``pos [B]``.  Returns ``(logits [B, V] f32, cache)``."""
    logits, cache = paged_decode_chunk(
        params, cache, block_table, token[:, None], pos, cfg=cfg, active=active
    )
    return logits[:, 0], cache


def paged_prefill(params, prompt, cache: PagedKVCache, block_table, *, cfg: ModelConfig):
    """Fill pool blocks for the whole prompt ``[B, P]`` in one forward: the
    dense ``decode.prefill`` over a block-padded scratch cache, then each
    block stripe transposed to the pool layout ``[Hkv, hd, bs]`` and
    written into the rows' blocks (``block_table [B, >= ceil(P/bs)]``) in
    place.  Returns ``(cache, logits [B, V] of the last prompt position)``."""
    b, p_len = prompt.shape
    bs = cache.block_size
    nb = blocks_needed(p_len, bs)
    dense, last_logits = decode.prefill(
        params, prompt, cfg, max_seq=nb * bs, cache_dtype=cache.k.dtype
    )
    l, hkv, hd = cfg.n_layers, cfg.kv_heads, cfg.head_dim
    # [L, B, nb*bs, Hkv, hd] -> [L, B, nb, Hkv, hd, bs]
    kb = dense.k.reshape(l, b, nb, bs, hkv, hd).permute(0, 1, 2, 4, 5, 3)
    vb = dense.v.reshape(l, b, nb, bs, hkv, hd).permute(0, 1, 2, 4, 5, 3)
    ids = block_table[:, :nb].long()
    cache.k[:, ids] = kb
    cache.v[:, ids] = vb
    return cache, last_logits


def _paged_step_all(params, cache, table, tokens, pos, active, temps, keys, poison,
                    *, cfg: ModelConfig, top_k: int):
    """One paged decode step for every slot at its own position, then the
    sampling tail (``serve.sample_next``).  ``poison [B]`` (the fault
    window's NaN mask) turns rows' logits to NaN first; ``bad`` flags rows
    whose logits are not finite.  Rows stay independent: a NaN row never
    reaches another.  Returns ``(next_token [B] int32, bad [B] bool,
    cache)``."""
    logits, cache = paged_decode_step(
        params, cache, table, tokens, pos, cfg=cfg, active=active
    )
    logits = decode.poison_rows(logits, poison)
    bad = ~decode.finite_rows(logits)
    return serve.sample_next(logits, pos, temps, keys, top_k=top_k), bad, cache


def _paged_pipelined_burst(params, cache, table, tokens, pos, active, temps, keys,
                           stop_pos, poison, *, cfg: ModelConfig, top_k: int,
                           eos_id: int, k: int):
    """K paged steps with no host read inside: each step samples, then the
    on-device stop mask (``decode.advance_decode_state``) retires rows that
    hit eos or their stop depth; retired rows stop writing.  ``temps``,
    ``keys`` and ``poison`` hold for the whole burst.  Returns ``(trace
    [3, K, B] int32 — token/active/bad planes stacked for ONE readback,
    cache, last, pos, active)``."""
    planes = []
    last = tokens
    for _ in range(k):
        next_tok, bad, cache = _paged_step_all(
            params, cache, table, last, pos, active, temps, keys, poison,
            cfg=cfg, top_k=top_k,
        )
        new_last, new_pos, new_active = decode.advance_decode_state(
            next_tok, last, pos, active, stop_pos, eos_id
        )
        planes.append(torch.stack([next_tok, active.to(torch.int32), bad.to(torch.int32)]))
        last, pos, active = new_last, new_pos, new_active
    return torch.stack(planes, dim=1), cache, last, pos, active


def _paged_first_token(params, cache, table, prompt, plen, slot, temp, key,
                       *, cfg: ModelConfig, top_k: int):
    """Admission tail: re-run the step for every slot at ``plen - 1`` with
    only ``slot`` active (an idempotent rewrite of the last prompt
    position) and sample its first token, every row at the admission's
    temperature and base key as the reference does.  ``plen``, ``slot``
    and ``temp`` are 0-d tensors and ``key`` a ``[2]`` one, as the
    reference traces them, so one captured program serves every
    admission.  Returns ``(token [1], cache)``."""
    n_slots = table.shape[0]
    last = (plen - 1).view(1)
    tokens = prompt[0].index_select(0, last).to(torch.int32).expand(n_slots)
    pos = last.expand(n_slots)
    active = torch.arange(n_slots, device=table.device) == slot
    tok, _, cache = _paged_step_all(
        params, cache, table, tokens, pos, active, temp.expand(n_slots),
        key.expand(n_slots, 2), None, cfg=cfg, top_k=top_k,
    )
    return tok.index_select(0, slot.view(1)), cache


def paged_greedy_decode(params, prompt, steps: int, cfg: ModelConfig, *,
                        block_size: int, n_blocks: int | None = None,
                        cache_dtype=torch.float32, device="cuda"):
    """Greedy continuation over a paged cache: ``[B, P]`` -> ``[B, P+steps]``
    on ``device`` (default the card; raises without one unless
    ``device="cpu"``).  Each row's blocks are allocated up front; prefill,
    then :func:`paged_decode_step` per position."""
    dev = params_device(params, device)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, p_len = prompt.shape
    if steps == 0:
        return prompt
    total = p_len + steps
    mb = blocks_needed(total, block_size)
    if n_blocks is None:
        n_blocks = b * mb + 1  # + the null block
    alloc = BlockAllocator(n_blocks)
    table_np = np.zeros((b, mb), np.int32)
    for r in range(b):
        table_np[r] = alloc.alloc(mb)
    table = torch.from_numpy(table_np).to(dev)
    cache = init_paged_cache(cfg, n_blocks, block_size, dtype=cache_dtype, device=dev)
    cache, last_logits = paged_prefill(params, prompt, cache, table, cfg=cfg)
    tokens = torch.cat(
        [prompt, torch.zeros((b, steps), dtype=prompt.dtype, device=dev)], dim=1
    )
    tokens[:, p_len] = last_logits.argmax(dim=-1)
    for pos in range(p_len, total - 1):
        pos_t = torch.full((b,), pos, dtype=torch.int32, device=dev)
        logits, cache = paged_decode_step(
            params, cache, table, tokens[:, pos], pos_t, cfg=cfg
        )
        tokens[:, pos + 1] = logits.argmax(dim=-1)
    return tokens


@dataclasses.dataclass
class PagedServeEngine:
    """Continuous batching over the paged pool.

    * ``submit`` admits when a slot AND the prompt's blocks (prompt + the
      first generated position) are free, prefilling the whole prompt;
      each request has its temperature (0 or below: greedy), a seed for
      its base key (default its request id) and a priority; ``top_k`` is
      the engine's;
    * blocks grow on demand as a slot's next write crosses a block
      boundary, high priority first (older first within a tier); when the
      pool is empty the slot STALLS (stays resident, generates nothing)
      until a retirement frees blocks;
    * with ``preempt_on_stall``, when every resident slot stalls, the
      lowest-priority request short enough to re-prefill in one pass
      (youngest within a tier) is evicted: its blocks free, its tokens,
      temperature and key park, and it is re-admitted (high priority
      first, FIFO within a tier) when a slot and its blocks are free,
      before any new submit;
    * ``step_burst`` runs up to ``sync_interval`` device steps with ONE
      device-to-host readback (``host_syncs`` counts them; admissions'
      first-token reads are not counted); ``step`` is a burst of one;
    * ``cancel`` retires a request "cancelled" (or unparks it); a slot
      whose logits go non-finite retires "quarantined" (the fault window,
      ``fault_injector``, can poison one), and at ``quarantine_limit``
      distinct requests the engine raises "engine poisoned";
    * retirement frees the slot's blocks at once.

    Runs on ``device`` (default the card; raises without one unless
    ``device="cpu"``); ``params`` must live there.  On the card each of
    the reference's compiled programs (prefill at the prompt bucket, the
    first token, the burst at ``sync_interval`` and at 1) runs as a CUDA
    graph (``serve.GraphedProgram``; at most four an engine, in
    ``graphs``), eagerly inside ``serve.disable_graphs()``; on the CPU it
    runs eagerly.  The device state those programs read and write
    (block table, active mask, last token, position, stop depth,
    temperature, base key and poison mask per slot; the admission's
    prompt, prefill table row, length, slot, temperature and key) keeps
    one address for the engine's life and is written in place;
    everything else (allocation, growth, stalls, preemption, retirement)
    stays on the host.  Not thread-safe; drive it from one loop.
    """

    params: dict
    cfg: ModelConfig
    n_slots: int = 8
    n_blocks: int = 65       # pool size incl. the null block
    block_size: int = 16
    prompt_bucket: int = 64
    cache_dtype: torch.dtype = torch.float32
    eos_id: int | None = None
    top_k: int = 0           # 0 = no top-k mask; static, one program set
    sync_interval: int = 1
    # size the pool by bytes instead: n_blocks = pool_hbm_bytes // kv_block_bytes
    pool_hbm_bytes: int | None = None
    preempt_on_stall: bool = True
    fault_injector: object | None = None  # utils/faults.FaultInjector
    quarantine_limit: int = 3  # distinct quarantined requests before "poisoned"
    device: object = "cuda"

    def __post_init__(self):
        cfg = self.cfg
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
        self.device = params_device(self.params, self.device)
        bs = self.block_size
        if self.pool_hbm_bytes is not None:
            per_block = kv_block_bytes(cfg, bs, self.cache_dtype)
            derived = self.pool_hbm_bytes // per_block
            if derived < 2:
                raise ValueError(
                    f"pool_hbm_bytes={self.pool_hbm_bytes} holds {derived} "
                    f"blocks of {per_block} bytes — need >= 2 (one is the null block)"
                )
            self.n_blocks = int(derived)
        self._mb = blocks_needed(cfg.max_seq, bs)          # table width
        self._mbp = blocks_needed(self.prompt_bucket, bs)  # prefill width
        self._alloc = BlockAllocator(self.n_blocks)
        self._table_np = np.full((self.n_slots, self._mb), NULL_BLOCK, np.int32)
        self._owned: list[list[int]] = [[] for _ in range(self.n_slots)]
        self._slots: list = [None] * self.n_slots
        self._prio: list[int] = [0] * self.n_slots
        self._preempted: list[dict] = []  # parked requests, re-admission order
        self._next_id = 0
        self._step_no = 0       # the fault window's step number
        self._completions: list = []
        self.stalled_steps = 0  # slot-steps skipped waiting for a block
        self.host_syncs = 0     # decode-loop readbacks (admissions excluded)
        self.decode_steps = 0   # device decode steps run by step/step_burst
        self.preempted_count = 0  # evictions
        self.quarantined: list[int] = []  # quarantined request ids
        dev = self.device
        self._cache = init_paged_cache(
            cfg, self.n_blocks, bs, dtype=self.cache_dtype, device=dev
        )
        # the programs' device state: one address each for the engine's life
        i32 = dict(dtype=torch.int32, device=dev)
        self._table = torch.full((self.n_slots, self._mb), NULL_BLOCK, **i32)
        self._table_dirty = False  # _table_np changed since the last upload
        self._active = torch.zeros((self.n_slots,), dtype=torch.bool, device=dev)
        self._last, self._pos, self._stop_pos = (
            torch.zeros((self.n_slots,), **i32) for _ in range(3)
        )
        self._temps = torch.zeros((self.n_slots,), dtype=torch.float32, device=dev)
        self._keys = torch.zeros((self.n_slots, 2), dtype=torch.int64, device=dev)
        self._poison = torch.zeros((self.n_slots,), dtype=torch.bool, device=dev)
        self._poison_np = np.zeros((self.n_slots,), bool)  # what _poison holds
        self._prompt = torch.zeros((1, self.prompt_bucket), **i32)   # padded
        self._prefill_row = torch.zeros((1, self._mbp), **i32)
        self._admit = torch.zeros((2,), **i32)                       # (plen, slot)
        self._admit_temp = torch.zeros((), dtype=torch.float32, device=dev)
        self._admit_key = torch.zeros((2,), dtype=torch.int64, device=dev)
        self._eos = -1 if self.eos_id is None else self.eos_id
        self._programs: dict[str, serve.GraphedProgram] = {}

    # -- public API --------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return self._alloc.free_blocks

    @property
    def reservable_blocks(self) -> int:
        """Usable KV blocks (the null block excluded)."""
        return self._alloc.n_blocks - 1

    def free_slots(self) -> int:
        return sum(1 for s in self._slots if s is None)

    def submit(self, prompt: list[int], max_tokens: int, temperature: float = 0.0,
               seed: int | None = None, priority: int = 0,
               deadline: int | None = None) -> int:
        """Admit a request; raises ``serve.NoCapacity`` (a RuntimeError)
        when no slot or not enough blocks are free, or while preempted
        requests wait for re-admission (they go first).  ``temperature``
        above 0 samples under the base key ``PRNGKey(seed)`` (default the
        request id); ``priority`` (higher first) orders stalls, evictions
        and re-admissions, never what is generated.  Returns the request
        id."""
        serve.check_submit(
            prompt, max_tokens, self.prompt_bucket, self.cfg.max_seq,
            temperature=temperature, deadline=deadline,
        )
        if self._preempted:
            # parked requests hold no reservation: re-admit what fits,
            # and refuse new work while any remain parked
            self._readmit()
            if self._preempted:
                raise serve.NoCapacity(
                    "no free slot (preempted requests pending re-admission)"
                )
        if self.free_slots() == 0:
            raise serve.NoCapacity("no free slot")
        need = blocks_needed(len(prompt) + 1, self.block_size)
        picked = self._pick_slot(need)
        if picked is None:
            raise serve.NoCapacity(
                f"no free blocks ({need} needed, {self.free_blocks} free)"
            )
        slot, ids = picked
        request_id = self._next_id
        base_key = prng.prng_key(request_id if seed is None else seed)
        self._prio[slot] = priority
        try:
            self._prefill_slot(slot, ids, prompt)
            self._admit.copy_(torch.tensor([len(prompt), slot], dtype=torch.int32))
            self._admit_temp.fill_(temperature)
            self._admit_key.copy_(base_key)
            first_tok = int(self._run("first token", self._first_token))
        except BaseException:
            # the slot was never occupied: return its blocks
            self._release_blocks(slot)
            raise
        self._next_id += 1
        st = serve._Slot(
            request_id, list(prompt) + [first_tok], len(prompt), max_tokens, deadline
        )
        self._slots[slot] = st
        self._set_row(slot, st, temperature, base_key)
        self._retire(slot)  # max_tokens=1 or eos on the first token
        return request_id

    def cancel(self, request_id: int) -> bool:
        """Cancel a request between steps: a resident one retires
        "cancelled" with its tokens so far and its blocks refund; a parked
        one unparks (it holds no blocks).  Returns whether the id was
        found."""
        for slot, st in enumerate(self._slots):
            if st is not None and st.request_id == request_id:
                serve._early_retire(self, slot, "cancelled", "cancelled by caller")
                return True
        for i, r in enumerate(self._preempted):
            if r["st"].request_id == request_id:
                self._preempted.pop(i)
                serve._retire_parked(self, r["st"], "cancelled", "cancelled by caller")
                return True
        return False

    def step(self) -> int:
        """Advance every active, non-stalled slot one token (a burst of
        one step); returns the number of slots stepped."""
        return self._step(1)

    def step_burst(self) -> int:
        """Advance every participating slot up to ``sync_interval`` tokens
        with ONE device-to-host readback; returns the number of slots
        stepped (or quarantined by the fault window).  Parked requests the
        pool can hold re-admit first.  Blocks for the whole burst are
        grown up front; a slot the pool cannot cover stalls for the burst,
        and if none can the burst falls back to one step (the synchronous
        loop's growth, preemption included)."""
        return self._step(self.sync_interval)

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        """Step until nothing is resident or parked; raises "engine
        wedged" when no slot can progress."""
        for _ in range(max_steps):
            if self.step_burst() == 0:
                if self.free_slots() == self.n_slots and not self._preempted:
                    return
                raise serve._wedge_error(self, "engine wedged: resident slots, no progress")
        raise serve._wedge_error(self, "serving loop did not drain")

    def pump(self, requests, max_steps: int = 100_000) -> list:
        """Admit ``requests`` (``(prompt, max_tokens)`` pairs or dicts of
        ``submit`` kwargs) FIFO as slots and blocks free, burst-stepping in
        between; returns the completions."""
        return serve._pump(self, requests, max_steps)

    def completions(self) -> list:
        out, self._completions = self._completions, []
        return out

    # -- internals ---------------------------------------------------------
    def _step(self, k: int) -> int:
        """Re-admit, open the fault window, grow (or preempt), run a
        K-step burst (``step`` asks for K = 1)."""
        single = k == 1
        self._readmit()
        self._step_no += 1
        poison, quarantined = serve._inject_step_faults(self)
        if all(st is None for st in self._slots):
            return quarantined
        active = self._grow_or_preempt(lookahead=k - 1)
        if not active.any() and k > 1:
            k = 1
            active = self._grow_or_preempt(lookahead=0)
        self._sync_table()
        if not active.any():
            return quarantined  # quarantining is progress, stalling is not
        if (poison != self._poison_np).any():
            self._poison.copy_(torch.from_numpy(poison))
            self._poison_np = poison
        return self._burst(k, active, single)

    def _burst(self, k: int, active, single: bool) -> int:
        """Run the K-step burst program for the slots in ``active`` (host
        bool ``[n_slots]``, blocks already grown) with ONE readback, then
        append each slot's tokens up to its first non-finite step, retire
        the finished slots and quarantine the poisoned ones."""
        self._active.copy_(torch.from_numpy(active))
        trace = self._run(f"burst k={k}", self._burst_program(k))
        trace_t, trace_a, trace_b = trace.cpu().numpy()  # the burst's one readback
        self.host_syncs += 1
        self.decode_steps += k
        trace_a = trace_a.astype(bool)
        first_bad = serve._first_bad_steps(trace_a, trace_b.astype(bool))
        for j in range(k):
            for slot, st in enumerate(self._slots):
                if st is None or not trace_a[j][slot] or j >= first_bad.get(slot, k):
                    continue
                st.tokens.append(int(trace_t[j][slot]))
                self._retire(slot)
        for slot in sorted(first_bad):
            if self._slots[slot] is not None:
                serve._quarantine_slot(
                    self, slot, "nan_logits",
                    "non-finite logits in decode step" if single
                    else f"non-finite logits at burst step {first_bad[slot]}",
                )
        return int(active.sum())

    def _grow_active_slots(self, lookahead: int):
        """Ensure every resident slot owns blocks covering positions
        ``pos .. pos + lookahead`` (clamped to its remaining stream), high
        priority first and older first within a tier; slots the pool
        cannot serve stall.  The depth comes from the host-side invariant
        ``pos == len(tokens) - 1``, never from a device read.  Returns the
        host active mask."""
        active = np.zeros((self.n_slots,), bool)
        order = sorted(
            range(self.n_slots),
            key=lambda s: (-self._prio[s], self._slots[s].request_id if self._slots[s] else 0),
        )
        for slot in order:
            st = self._slots[slot]
            if st is None:
                continue
            remaining = st.prompt_len + serve._slot_budget(st) - len(st.tokens)
            ahead = min(lookahead, max(remaining - 1, 0))
            needed = (len(st.tokens) - 1 + ahead) // self.block_size + 1
            grew = True
            while len(self._owned[slot]) < needed:
                try:
                    (new_id,) = self._alloc.alloc(1)
                except OutOfBlocks:
                    self.stalled_steps += 1  # resumes after a retirement
                    grew = False
                    break
                self._owned[slot].append(new_id)
                self._table_np[slot, len(self._owned[slot]) - 1] = new_id
                self._table_dirty = True
            if grew:
                active[slot] = True
        return active

    def _grow_or_preempt(self, lookahead: int):
        """Block growth; with ``preempt_on_stall``, while every resident
        slot stalls, evict one request and grow again.  Returns the host
        active mask."""
        active = self._grow_active_slots(lookahead)
        if self.preempt_on_stall:
            while True:
                resident = [s for s in range(self.n_slots) if self._slots[s] is not None]
                if not resident or active[resident].any() or not self._preempt_one():
                    break
                active = self._grow_active_slots(lookahead)
        return active

    def _preempt_one(self) -> bool:
        """Evict the lowest-priority resident request still short enough to
        re-prefill in one pass (the youngest within a tier): park its
        tokens, temperature and base key (read back from the device) and
        free its blocks.  Returns whether a request was evicted."""
        victim, vslot = None, -1
        for slot, st in enumerate(self._slots):
            if st is None or len(st.tokens) + 1 > self.prompt_bucket:
                continue  # grown past one-pass re-prefill: not resumable
            if victim is None or (
                (self._prio[slot], -st.request_id) < (self._prio[vslot], -victim.request_id)
            ):
                victim, vslot = st, slot
        if victim is None:
            return False
        # a copy: on the CPU ``.cpu()`` would alias the row the slot's next
        # request overwrites
        self._preempted.append(dict(
            st=victim, temp=float(self._temps[vslot].cpu()),
            key=self._keys[vslot].to("cpu", copy=True), priority=self._prio[vslot],
        ))
        # re-admission: high priority first, FIFO within a tier (stable)
        self._preempted.sort(key=lambda r: -r["priority"])
        self._slots[vslot] = None
        self._release_blocks(vslot)
        self.preempted_count += 1
        return True

    def _readmit(self) -> None:
        """Re-prefill parked requests, in queue order, while a slot and
        their blocks are free: the parked tokens are the prompt, and the
        next step samples the next token at the same position under the
        same key, so the stream continues exactly.  A re-admission that
        fails frees its blocks, delivers an "error" completion and
        raises."""
        while self._preempted:
            r = self._preempted[0]
            st = r["st"]
            picked = self._pick_slot(blocks_needed(len(st.tokens) + 1, self.block_size))
            if picked is None:
                return  # stays parked; the head blocks the queue
            slot, ids = picked
            self._prio[slot] = r["priority"]
            try:
                self._prefill_slot(slot, ids, st.tokens)
            except BaseException as exc:
                self._release_blocks(slot)
                self._preempted.pop(0)
                serve._retire_parked(self, st, "error", f"{type(exc).__name__}: {exc}")
                raise
            self._preempted.pop(0)
            self._slots[slot] = st
            self._set_row(slot, st, r["temp"], r["key"])

    def _pick_slot(self, need: int):
        """The first free slot, with ``need`` blocks allocated to it, as
        ``(slot, ids)``; None when no slot is free or the pool cannot
        cover ``need`` (one pool: a second slot could not do better)."""
        for slot in range(self.n_slots):
            if self._slots[slot] is None:
                try:
                    return slot, self._alloc.alloc(need)
                except OutOfBlocks:
                    return None
        return None

    def _prefill_slot(self, slot: int, ids: list[int], tokens: list[int]) -> None:
        """Point ``slot``'s table row at ``ids`` and prefill ``tokens`` into
        them (the prefill program)."""
        self._owned[slot] = ids
        self._table_np[slot, :] = NULL_BLOCK
        self._table_np[slot, : len(ids)] = ids
        self._table_dirty = True
        self._sync_table()
        padded = np.zeros((1, self.prompt_bucket), np.int32)
        padded[0, : len(tokens)] = tokens
        self._prompt.copy_(torch.from_numpy(padded))
        # prefill writes ceil(bucket/bs) stripes; entries past the owned
        # blocks are the null block, a scratch sink never attended
        self._prefill_row.copy_(torch.from_numpy(self._table_np[slot : slot + 1, : self._mbp]))
        self._run("prefill", self._prefill)

    def _set_row(self, slot: int, st, temperature: float, key) -> None:
        """A resident slot's device row: last token, position (``len(tokens)
        - 1``), stop depth (from the original prompt length and budget),
        temperature and base key."""
        self._last[slot] = st.tokens[-1]
        self._pos[slot] = len(st.tokens) - 1
        self._stop_pos[slot] = st.prompt_len + serve._slot_budget(st) - 1
        self._temps[slot] = temperature
        self._keys[slot] = key

    def _release_blocks(self, slot: int) -> None:
        """Refund ``slot``'s blocks and point its table row at the null
        block (uploaded before the next program)."""
        self._alloc.free(self._owned[slot])
        self._owned[slot] = []
        self._table_np[slot, :] = NULL_BLOCK
        self._table_dirty = True

    def _sync_table(self) -> None:
        """Upload the host block table into ``_table`` in place, once for
        however many changes since the last upload."""
        if self._table_dirty:
            self._table.copy_(torch.from_numpy(self._table_np))
            self._table_dirty = False

    # -- the programs (the reference's compiled ones) ------------------------
    @property
    def graphs(self) -> dict:
        """The engine's CUDA graphs by program name (none on the CPU or
        under ``serve.disable_graphs()``)."""
        return dict(self._programs)

    def _run(self, name: str, fn):
        """Run program ``fn`` (no arguments: it reads the static buffers):
        eagerly on the CPU and under ``serve.disable_graphs()``, else as the
        engine's CUDA graph ``name``, captured on its second call."""
        if self.device.type != "cuda" or not serve.graphs_enabled():
            return fn()
        prog = self._programs.get(name)
        if prog is None:
            prog = self._programs[name] = serve.GraphedProgram(name, fn, self.device)
        return prog()

    def _prefill(self) -> None:
        paged_prefill(self.params, self._prompt, self._cache, self._prefill_row, cfg=self.cfg)

    def _first_token(self):
        tok, _ = _paged_first_token(
            self.params, self._cache, self._table, self._prompt, self._admit[0],
            self._admit[1], self._admit_temp, self._admit_key, cfg=self.cfg,
            top_k=self.top_k,
        )
        return tok

    def _burst_program(self, k: int):
        def burst():
            trace, _, last, pos, _ = _paged_pipelined_burst(
                self.params, self._cache, self._table, self._last, self._pos,
                self._active, self._temps, self._keys, self._stop_pos, self._poison,
                cfg=self.cfg, top_k=self.top_k, eos_id=self._eos, k=k,
            )
            self._last.copy_(last)
            self._pos.copy_(pos)
            return trace
        return burst

    def _retire(self, slot: int) -> None:
        done = serve.completion_if_done(self._slots[slot], self.eos_id, self.cfg.max_seq)
        if done is not None:
            self._completions.append(done)
            self._slots[slot] = None
            self._release_blocks(slot)
