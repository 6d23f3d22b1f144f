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

Greedy streams equal the reference's (tested on the CPU).  Not ported yet
(the engine raises ``NotImplementedError`` where the reference would act):
sampled requests, preemption, quarantine of non-finite rows; and, absent
from the engine's fields, chunked prefill, prefix sharing, speculative
rounds, LoRA, quantized KV pools, meshes, handoff and telemetry.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from k8s_dra_driver_torch.device import params_device
from k8s_dra_driver_torch.models import decode, serve
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
                     dtype=torch.float32, device="cpu") -> PagedKVCache:
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


def _paged_step_all(params, cache, table, tokens, pos, active, *, cfg: ModelConfig):
    """One greedy paged decode step for every slot at its own position.
    Returns ``(next_token [B] int32, bad [B] bool — non-finite logits, cache)``."""
    logits, cache = paged_decode_step(
        params, cache, table, tokens, pos, cfg=cfg, active=active
    )
    bad = ~decode.finite_rows(logits)
    return serve.sample_next(logits), bad, cache


def _paged_pipelined_burst(params, cache, table, tokens, pos, active, stop_pos,
                           *, cfg: ModelConfig, eos_id: int, k: int):
    """K paged steps with no host read inside: each step samples, then the
    on-device stop mask (``decode.advance_decode_state``) retires rows that
    hit eos or their stop depth; retired rows stop writing.  Returns
    ``(trace [3, K, B] int32 — token/active/bad planes stacked for ONE
    readback, cache, last, pos, active)``."""
    planes = []
    last = tokens
    for _ in range(k):
        next_tok, bad, cache = _paged_step_all(
            params, cache, table, last, pos, active, cfg=cfg
        )
        new_last, new_pos, new_active = decode.advance_decode_state(
            next_tok, last, pos, active, stop_pos, eos_id
        )
        planes.append(torch.stack([next_tok, active.to(torch.int32), bad.to(torch.int32)]))
        last, pos, active = new_last, new_pos, new_active
    return torch.stack(planes, dim=1), cache, last, pos, active


def _paged_first_token(params, cache, table, prompt, plen: int, slot: int,
                       *, cfg: ModelConfig):
    """Admission tail: re-run the step for every slot at ``plen - 1`` with
    only ``slot`` active (an idempotent rewrite of the last prompt
    position) and take its greedy token.  Returns ``(token 0-d, cache)``."""
    n_slots = table.shape[0]
    dev = table.device
    tokens = prompt[0, plen - 1].to(torch.int32).expand(n_slots)
    pos = torch.full((n_slots,), plen - 1, dtype=torch.int32, device=dev)
    active = torch.arange(n_slots, device=dev) == slot
    tok, _, cache = _paged_step_all(params, cache, table, tokens, pos, active, cfg=cfg)
    return tok[slot], cache


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
    """Continuous batching over the paged pool (greedy requests).

    * ``submit`` admits when a slot AND the prompt's blocks (prompt + the
      first generated position) are free, prefilling the whole prompt;
    * blocks grow on demand as a slot's next write crosses a block
      boundary; when the pool is empty the slot STALLS (stays resident,
      generates nothing) until a retirement frees blocks;
    * ``step_burst`` runs up to ``sync_interval`` device steps with ONE
      device-to-host readback (``host_syncs`` counts them; admissions'
      first-token reads are not counted);
    * retirement frees the slot's blocks at once.

    Runs on ``device`` (default the card; raises without one unless
    ``device="cpu"``); ``params`` must live there.  With
    ``preempt_on_stall`` the reference would evict a request when every
    resident slot stalls: the port raises ``NotImplementedError`` there
    instead.  Not thread-safe; drive it from one loop.
    """

    params: dict
    cfg: ModelConfig
    n_slots: int = 8
    n_blocks: int = 65       # pool size incl. the null block
    block_size: int = 16
    prompt_bucket: int = 64
    cache_dtype: torch.dtype = torch.float32
    eos_id: int | None = None
    sync_interval: int = 1
    # size the pool by bytes instead: n_blocks = pool_hbm_bytes // kv_block_bytes
    pool_hbm_bytes: int | None = None
    preempt_on_stall: bool = True
    device: object = "cuda"

    def __post_init__(self):
        cfg = self.cfg
        if self.prompt_bucket > cfg.max_seq:
            raise ValueError(
                f"prompt_bucket ({self.prompt_bucket}) exceeds max_seq ({cfg.max_seq})"
            )
        if self.sync_interval < 1:
            raise ValueError(f"sync_interval must be >= 1, got {self.sync_interval}")
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
        self._next_id = 0
        self._completions: list = []
        self.stalled_steps = 0  # slot-steps skipped waiting for a block
        self.host_syncs = 0     # decode-loop readbacks (admissions excluded)
        self.decode_steps = 0   # device decode steps run by step/step_burst
        dev = self.device
        self._cache = init_paged_cache(
            cfg, self.n_blocks, bs, dtype=self.cache_dtype, device=dev
        )
        self._upload_table()
        zeros = lambda: torch.zeros((self.n_slots,), dtype=torch.int32, device=dev)  # noqa: E731
        self._last, self._pos, self._stop_pos = zeros(), zeros(), zeros()
        self._eos = -1 if self.eos_id is None else self.eos_id

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
               deadline: int | None = None) -> int:
        """Admit a greedy request; raises ``serve.NoCapacity`` (a
        RuntimeError) when no slot or not enough blocks are free.  Returns
        the request id."""
        serve.check_submit(
            prompt, max_tokens, self.prompt_bucket, self.cfg.max_seq,
            temperature=temperature, deadline=deadline,
        )
        free = [s for s in range(self.n_slots) if self._slots[s] is None]
        if not free:
            raise serve.NoCapacity("no free slot")
        slot = free[0]
        bs = self.block_size
        need = blocks_needed(len(prompt) + 1, bs)
        try:
            ids = self._alloc.alloc(need)
        except OutOfBlocks:
            raise serve.NoCapacity(
                f"no free blocks ({need} needed, {self.free_blocks} free)"
            ) from None
        dev = self.device
        try:
            self._owned[slot] = ids
            self._table_np[slot, :] = NULL_BLOCK
            self._table_np[slot, :need] = ids
            self._upload_table()
            padded_np = np.zeros((1, self.prompt_bucket), np.int32)
            padded_np[0, : len(prompt)] = prompt
            padded = torch.from_numpy(padded_np).to(dev)
            # prefill writes ceil(bucket/bs) stripes; entries past the owned
            # blocks are the null block, a scratch sink never attended
            prefill_row = torch.from_numpy(self._table_np[slot : slot + 1, : self._mbp].copy()).to(dev)
            self._cache, _ = paged_prefill(
                self.params, padded, self._cache, prefill_row, cfg=self.cfg
            )
            tok, self._cache = _paged_first_token(
                self.params, self._cache, self._table, padded, len(prompt), slot,
                cfg=self.cfg,
            )
            first_tok = int(tok)
        except BaseException:
            # the slot was never occupied: return its blocks
            self._alloc.free(self._owned[slot])
            self._owned[slot] = []
            self._table_np[slot, :] = NULL_BLOCK
            self._upload_table()
            raise
        request_id = self._next_id
        self._next_id += 1
        st = serve._Slot(
            request_id, list(prompt) + [first_tok], len(prompt), max_tokens, deadline
        )
        self._slots[slot] = st
        self._last[slot] = first_tok
        self._pos[slot] = len(prompt)
        self._stop_pos[slot] = len(prompt) + serve._slot_budget(st) - 1
        self._retire(slot)  # max_tokens=1 or eos on the first token
        return request_id

    def step(self) -> int:
        """Advance every active, non-stalled slot one token; returns the
        number of slots stepped."""
        active, table_dirty = self._grow_or_preempt(lookahead=0)
        if table_dirty:
            self._upload_table()
        if not active.any():
            return 0
        active_t = torch.from_numpy(active).to(self.device)
        next_tok, bad, self._cache = _paged_step_all(
            self.params, self._cache, self._table, self._last, self._pos,
            active_t, cfg=self.cfg,
        )
        self._last = torch.where(active_t, next_tok, self._last)
        self._pos = torch.where(active_t, self._pos + 1, self._pos)
        toks, bads = torch.stack([next_tok, bad.to(torch.int32)]).cpu().numpy()
        self.host_syncs += 1
        self.decode_steps += 1
        self._check_finite(active & bads.astype(bool))
        for slot, st in enumerate(self._slots):
            if st is None or not active[slot]:
                continue
            st.tokens.append(int(toks[slot]))
            self._retire(slot)
        return int(active.sum())

    def step_burst(self) -> int:
        """Advance every participating slot up to ``sync_interval`` tokens
        with ONE device-to-host readback; returns the number of slots
        stepped.  Blocks for the whole burst are grown up front; a slot the
        pool cannot cover stalls for the burst, and if none can the burst
        falls back to one step (the synchronous loop's growth)."""
        if self.sync_interval <= 1:
            return self.step()
        if all(st is None for st in self._slots):
            return 0
        k = self.sync_interval
        active, table_dirty = self._grow_or_preempt(lookahead=k - 1)
        if not active.any():
            k = 1
            active, dirty2 = self._grow_or_preempt(lookahead=0)
            table_dirty = table_dirty or dirty2
        if table_dirty:
            self._upload_table()
        if not active.any():
            return 0
        active_t = torch.from_numpy(active).to(self.device)
        trace, self._cache, self._last, self._pos, _ = _paged_pipelined_burst(
            self.params, self._cache, self._table, self._last, self._pos,
            active_t, self._stop_pos, cfg=self.cfg, eos_id=self._eos, k=k,
        )
        trace_t, trace_a, trace_b = trace.cpu().numpy()  # the burst's one readback
        self.host_syncs += 1
        self.decode_steps += k
        trace_a = trace_a.astype(bool)
        self._check_finite((trace_a & trace_b.astype(bool)).any(axis=0))
        for j in range(k):
            for slot, st in enumerate(self._slots):
                if st is None or not trace_a[j][slot]:
                    continue
                st.tokens.append(int(trace_t[j][slot]))
                self._retire(slot)
        return int(active.sum())

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self.step_burst() == 0:
                if self.free_slots() == self.n_slots:
                    return
                raise RuntimeError(
                    "engine wedged: resident slots, no progress "
                    f"({self.free_blocks} free blocks)"
                )
        raise RuntimeError("serving loop did not drain")

    def pump(self, requests, max_steps: int = 100_000) -> list:
        """Admit ``requests`` (``(prompt, max_tokens)`` pairs or dicts of
        ``submit`` kwargs) FIFO as slots and blocks free, burst-stepping in
        between; returns the completions."""
        return serve._pump(self, requests, max_steps)

    def completions(self) -> list:
        out, self._completions = self._completions, []
        return out

    # -- internals ---------------------------------------------------------
    def _check_finite(self, bad_rows) -> None:
        if bad_rows.any():
            raise NotImplementedError(
                "non-finite logits in slots "
                f"{np.flatnonzero(bad_rows).tolist()}: quarantine is not ported yet"
            )

    def _grow_active_slots(self, lookahead: int):
        """Ensure every resident slot owns blocks covering positions
        ``pos .. pos + lookahead`` (clamped to its remaining stream); slots
        the pool cannot serve stall.  The depth comes from the host-side
        invariant ``pos == len(tokens) - 1``, never from a device read.
        Returns ``(active mask, table_dirty)``."""
        active = np.zeros((self.n_slots,), bool)
        table_dirty = False
        order = sorted(
            range(self.n_slots),
            key=lambda s: self._slots[s].request_id if self._slots[s] else 0,
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
                table_dirty = True
            if grew:
                active[slot] = True
        return active, table_dirty

    def _grow_or_preempt(self, lookahead: int):
        """Block growth; where the reference would evict (every resident
        slot stalled and one is short enough to re-prefill) the port
        raises, since preemption is not ported yet."""
        active, table_dirty = self._grow_active_slots(lookahead)
        if self.preempt_on_stall:
            resident = [s for s in range(self.n_slots) if self._slots[s] is not None]
            victims = [
                s for s in resident
                if len(self._slots[s].tokens) + 1 <= self.prompt_bucket
            ]
            if resident and not active[resident].any() and victims:
                raise NotImplementedError(
                    "every resident slot stalled on a full pool: preemption is "
                    "not ported yet (use a larger pool or preempt_on_stall=False)"
                )
        return active, table_dirty

    def _upload_table(self) -> None:
        self._table = torch.from_numpy(self._table_np.copy()).to(self.device)

    def _retire(self, slot: int) -> None:
        done = serve.completion_if_done(self._slots[slot], self.eos_id, self.cfg.max_seq)
        if done is not None:
            self._completions.append(done)
            self._slots[slot] = None
            self._alloc.free(self._owned[slot])
            self._owned[slot] = []
            self._table_np[slot, :] = NULL_BLOCK
            self._upload_table()
