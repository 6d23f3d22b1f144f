"""Paged KV cache and the paged serving engine
(``k8s_dra_driver_tpu/models/paged.py``).

KV lives in a pool of fixed-size blocks, ``[L, n_blocks, Hkv, hd, bs]``
per k/v (positions contiguous on the last axis, the JAX package's layout),
shared by all slots; each slot's block table lists its blocks in order.
Pool block 0 is the NULL block: never allocated, the table entry of every
unused position.  The allocator is host-side; everything per token runs on
the device.

Unlike the reference, which threads pools functionally, the port updates
them IN PLACE: ``paged_decode_chunk``, ``paged_prefill`` and
``paged_prefill_chunk`` write into the tensors they are given and return
the same tensors.  A failed admission therefore leaves bytes behind only
in the blocks it had allocated (freed again on the failure) and in the
null block, which nothing reads as history.

Every decode step goes through ``ops/paged_attention.paged_append_attention``
(the CUDA kernel on the card, its plain version on the CPU), with
``write_mask=active``: inactive rows, whose tables may be stale, never
write.  The reference's plain path instead diverts their writes to the
null block, so pool bytes of the two packages agree outside block 0.

Streams equal the reference's, greedy and sampled (tested on the CPU):
the sampling tail is ``serve.sample_next``, keyed per slot by
``fold_in(base key, position)``, so a request preempted, parked and
re-admitted continues exactly where it stopped; chunked admission and
prefix sharing change when prefill runs and what it computes, never the
tokens; so do speculative rounds, whose verify window goes through the same
append kernel at ``nq = spec_gamma + 1``.  The engine's telemetry, metrics
and journal records are the reference's, at the reference's host points.
Per-request LoRA (an adapter bank, ``submit(adapter=k)``) runs inside the
same programs.  A quantized pool (``kv_dtype`` "int8" or "int4") stores
blocks as integers with per-block scales and takes the reference's XLA
route in plain PyTorch on every device (:func:`paged_decode_chunk`); the
append kernel stays float-only, as the reference's Pallas kernel does.
KV payloads (``serve.KVSlice``) leave a pool in the canonical layout
(handoff, ``snapshot_active(include_kv=True)``, the fleet prefix tier's
export) and are written back into pool blocks in place (restore, the
tier's inject), a quantized pool's as its raw bytes and scales.  On a
mesh (``mesh``, ``slot_axis``) the slots and the pool's blocks split into
contiguous shards, one a rank of the slot group, each with its own null
block, allocator and prefix store: the reference's data-parallel serving,
one process a rank in lockstep (``serve.slot_shards``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from k8s_dra_driver_torch.device import params_device, resolve_device
from k8s_dra_driver_torch.models import decode, lora, prng, quant, serve
from k8s_dra_driver_torch.models.burnin import (
    ModelConfig,
    mlp_residual,
    qkv_proj,
    tied_logits,
    torch_dtype,
)
from k8s_dra_driver_torch.models.quant import matmul_last as _mm
from k8s_dra_driver_torch.models.speculative import accept_advance
from k8s_dra_driver_torch.models.telemetry import EngineTelemetry
from k8s_dra_driver_torch.ops import paged_attention
from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.metrics import REGISTRY

NULL_BLOCK = 0  # reserved: never allocated, the table's filler

# The pool's metrics, the reference's families (the serving ones live in
# models/serve.py and are shared by both engines):
_M_POOL_FREE = REGISTRY.gauge(
    "tpu_serve_kv_pool_free_blocks", "free KV pool blocks right now"
)
_M_PREEMPTIONS = REGISTRY.counter(
    "tpu_serve_preemptions_total",
    "requests evicted under pool pressure for later recompute-resume",
)
_M_KV_BYTES = REGISTRY.gauge(
    "tpu_serve_kv_bytes", "resident KV pool bytes (values + scales), by pool dtype"
)


class PagedKVCache(NamedTuple):
    """Per-layer stacked block pools ``[L, n_blocks, Hkv, hd, block_size]``.

    A quantized pool stores int8, or packed int4 as uint8 with two
    positions per lane byte (the lane axis then holds ``block_size // 2``
    bytes), with one f32 scale per (layer, block, KV head) in
    ``k_scale``/``v_scale`` ``[L, n_blocks, Hkv]`` (None for a float
    pool).  Whether it is quantized follows from the array dtype."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k.dtype in (torch.int8, torch.uint8)

    @property
    def kv_dtype(self) -> str | None:
        """"int8"/"int4" for a quantized pool, None for a float one."""
        return {torch.int8: "int8", torch.uint8: "int4"}.get(self.k.dtype)

    @property
    def block_size(self) -> int:
        bs = self.k.shape[4]
        return bs * 2 if self.k.dtype == torch.uint8 else bs

    @property
    def n_blocks(self) -> int:
        return self.k.shape[1]


def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                     dtype=torch.float32, device="cuda", kv_dtype: str | None = None
                     ) -> PagedKVCache:
    """A zeroed pool on ``device`` (the card by default; raises without
    one unless the caller passes ``device="cpu"``).  ``kv_dtype`` "int8" or
    "int4" makes a quantized pool (``dtype`` then unused): int4 zeros are
    ``0x88`` (both nibbles a biased 0) and every scale starts at 1.0, the
    all-zero block's."""
    device = resolve_device(device)
    if kv_dtype is None:
        shape = (cfg.n_layers, n_blocks, cfg.kv_heads, cfg.head_dim, block_size)
        return PagedKVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
        )
    quant.kv_dtype_bits(kv_dtype)  # validates the name
    if kv_dtype == "int4" and block_size % 2:
        raise ValueError(f"int4 pools need an even block_size, got {block_size}")
    lanes = block_size if kv_dtype == "int8" else block_size // 2
    shape = (cfg.n_layers, n_blocks, cfg.kv_heads, cfg.head_dim, lanes)
    fill, qdtype = (0, torch.int8) if kv_dtype == "int8" else (0x88, torch.uint8)
    return PagedKVCache(
        *(torch.full(shape, fill, dtype=qdtype, device=device) for _ in range(2)),
        *(torch.ones(shape[:3], dtype=torch.float32, device=device) for _ in range(2)),
    )


def kv_block_bytes(cfg: ModelConfig, block_size: int, kv_dtype=torch.float32) -> int:
    """Bytes ONE pool block costs across all layers, k + v, with a
    quantized pool's scales (one f32 per layer and KV head): the unit a
    ``pool_hbm_bytes`` budget divides by.  ``kv_dtype`` is "int8"/"int4"
    or a torch dtype."""
    hd = cfg.head_dim
    if isinstance(kv_dtype, str):
        per_head = hd * block_size * quant.kv_dtype_bits(kv_dtype) // 8 + 4
    else:
        per_head = hd * block_size * torch.empty((), dtype=kv_dtype).element_size()
    return 2 * cfg.n_layers * cfg.kv_heads * per_head


def _quantized_block_write(pool, scale, li: int, bids, offs, vals, kv_dtype: str) -> None:
    """Insert one new ``[Hkv, hd]`` vector per row (``vals [B, Hkv, hd]``)
    at lane ``offs [B]`` of block ``bids [B]`` of a quantized pool's layer
    ``li``, in place: gather the blocks and scales, dequantize, put the
    value in, zero every lane past it, requantize, scatter back (the
    reference's ``_quantized_block_write``).  The zero tail keeps a
    recycled block's stale lanes out of the fresh block's scale, so a
    block's bytes follow from its history alone.  Duplicate ``bids`` occur
    only at the null block (inactive rows), which is never attended."""
    deq = quant.dequant_kv_blocks(pool[li].index_select(0, bids),
                                  scale[li].index_select(0, bids))   # [B, Hkv, hd, bs] f32
    lane = torch.arange(deq.shape[-1], device=deq.device)
    off = offs[:, None, None, None]
    deq = torch.where(lane == off, vals.float()[..., None], deq)
    deq = torch.where(lane <= off, deq, 0.0)
    qb, qs = quant.quantize_kv_blocks(deq, kv_dtype)
    pool[li].index_copy_(0, bids, qb)
    scale[li].index_copy_(0, bids, qs)


def quantized_window_attention(q, k_pool, v_pool, k_scale, v_scale, block_table, pos):
    """Window attention over one layer of a quantized pool (the
    reference's ``paged_window_attention_xla_gqa`` with scales): ``q [B,
    nq, Hq, d]``, query j of a row at ``pos + j`` attends the row's table
    positions ``<= pos + j``.  The int-sized blocks are gathered, then
    dequantized to f32; the grouped einsums contract on the block layout
    in f32 with ``-1e30`` masking.  Plain PyTorch on every device: the
    reference serves quantized pools only on its XLA route, and the append
    kernel (``ops/paged_attention``) takes float pools only.  Returns
    ``[B, nq, Hq, d]`` in q's dtype."""
    b, nq, hq, d = q.shape
    hkv = k_pool.shape[1]
    groups = hq // hkv
    ids = block_table.long()
    kb = quant.dequant_kv_blocks(k_pool[ids], k_scale[ids])  # [B, mb, Hkv, d, bs] f32
    vb = quant.dequant_kv_blocks(v_pool[ids], v_scale[ids])
    qg = q.reshape(b, nq, hkv, groups, d).float()
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    scores = torch.einsum("bqhgd,bmhds->bhgqms", qg, kb) * scale
    mb, bs = scores.shape[-2:]
    scores = scores.reshape(b, hkv, groups, nq, mb * bs)
    k_pos = torch.arange(mb * bs, device=q.device)
    qpos = pos.long()[:, None] + torch.arange(nq, device=q.device)[None, :]
    mask = (k_pos[None, None, :] <= qpos[:, :, None])[:, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).reshape(b, hkv, groups, nq, mb, bs)
    out = torch.einsum("bhgqms,bmhds->bqhgd", probs, vb)
    return out.to(q.dtype).reshape(b, nq, hq, d)


class OutOfBlocks(RuntimeError):
    """Pool exhausted."""


class BlockAllocator:
    """Host-side refcounted free list over pool blocks 1..n_blocks-1 (0 is
    the null block).  LIFO reuse: the lowest free id first, so tables are
    deterministic (the reference's order, block for block).

    Reference counts make prefix sharing safe: a block holding a common
    prompt prefix is referenced by every slot that uses it and by the
    prefix store (:meth:`share`); :meth:`free` drops one reference, and the
    block returns to the pool when the last holder lets go, so a double
    free raises."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is the null block), got {n_blocks}")
        self._free = list(range(n_blocks - 1, 0, -1))  # pop() -> lowest id first
        self._refs: dict[int, int] = {}
        self.n_blocks = n_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def refcount(self, block_id: int) -> int:
        return self._refs.get(block_id, 0)

    def alloc(self, n: int = 1) -> list[int]:
        if n > len(self._free):
            raise OutOfBlocks(
                f"requested {n} blocks, {len(self._free)} free of {self.n_blocks - 1}"
            )
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._refs[i] = 1
        return ids

    def share(self, block_id: int) -> int:
        """Add a reference to a live block (prefix sharing); sharing a free
        block raises."""
        if self._refs.get(block_id, 0) < 1:
            raise ValueError(f"cannot share free block {block_id}")
        self._refs[block_id] += 1
        return block_id

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


def check_verify_window(spec_gamma: int, block_size: int, device, kv_dtype=None) -> None:
    """The append kernel takes a window of at most one block
    (``ops/paged_attention.check_kernel_shape``), so on the card a
    speculating engine over a float pool needs ``spec_gamma + 1 <=
    block_size``.  The CPU's plain path takes any window, as the
    reference's XLA path does, and so does a quantized pool's route
    (:func:`quantized_window_attention`) on any device."""
    if (kv_dtype is None and torch.device(device).type == "cuda"
            and spec_gamma + 1 > block_size):
        raise ValueError(
            f"the verify window spec_gamma + 1 = {spec_gamma + 1} exceeds block_size "
            f"{block_size} (the paged kernel's append rule)"
        )


def paged_decode_chunk(params, cache: PagedKVCache, block_table, window, pos,
                       *, cfg: ModelConfig, active=None, adapters=None):
    """Score ``window [B, S]`` (token j at ``pos + j``, ``pos [B]``) in one
    pass over the paged cache: per layer, append the window's k/v to the
    pool (rows with ``active`` false do not write) and attend positions
    ``<= pos + j``; ``adapters`` ``(bank, ids [B])`` apply each row's LoRA
    adapter through the projections' delta hooks.  Returns ``(logits [B, S,
    V] f32, cache)``, the pools updated in place.

    A float pool goes through the append kernel (its plain version on the
    CPU).  A quantized pool takes the reference's XLA route in plain
    PyTorch on every device, chosen here by the pool's dtype: per layer a
    sequential :func:`_quantized_block_write` over the window's positions
    (inactive rows write to the null block, as the reference's do; a
    position past the table's last column writes where the column clamps,
    as the reference's gather does), then
    :func:`quantized_window_attention`.  The scales are updated in place
    like the pools, so a captured program's addresses stay valid."""
    b, s = window.shape
    dev = window.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(b)
    positions = pos.long()[:, None] + torch.arange(s, device=dev)[None, :]
    x = params["embed"][window.long()]
    if not cfg.rope:  # the reference's gather clamps a position past the table
        x = x + params["pos_embed"][positions.clamp(max=params["pos_embed"].shape[0] - 1)]
    if cache.quantized:
        bs = cache.block_size
        col = (positions // bs).clamp(max=block_table.shape[1] - 1)
        block_ids = block_table.long().gather(1, col)                  # [B, S]
        if active is not None:
            block_ids = torch.where(active[:, None], block_ids, NULL_BLOCK)
        offs = positions % bs
    else:
        write_mask = None if active is None else active.to(torch.int32)  # once, not per layer
    for li, p in enumerate(params["blocks"]):
        delta = None if adapters is None else lora.layer_delta(adapters, li)
        q, k, v = qkv_proj(x, p, cfg, positions=positions, delta=delta)
        if cache.quantized:
            for si in range(s):
                for pool, sc, new in ((cache.k, cache.k_scale, k), (cache.v, cache.v_scale, v)):
                    _quantized_block_write(pool, sc, li, block_ids[:, si], offs[:, si],
                                           new[:, si], cache.kv_dtype)
            attn = quantized_window_attention(q, cache.k[li], cache.v[li], cache.k_scale[li],
                                              cache.v_scale[li], block_table, pos)
        else:
            attn, _, _ = paged_attention.paged_append_attention(
                q, k, v, cache.k, cache.v, block_table, pos, li, write_mask=write_mask,
            )
        attn = attn.reshape(b, s, cfg.d_model)
        x = x + _mm(attn, p["attn_out"])
        if delta is not None:
            x = x + delta("attn_out", attn)
        x = mlp_residual(x, p, delta=delta, top_k=cfg.moe_top_k)
    return tied_logits(x, params), cache


def paged_decode_step(params, cache: PagedKVCache, block_table, token, pos,
                      *, cfg: ModelConfig, active=None, adapters=None):
    """The S=1 view of :func:`paged_decode_chunk`: ``token [B]`` at
    ``pos [B]``.  Returns ``(logits [B, V] f32, cache)``."""
    logits, cache = paged_decode_chunk(
        params, cache, block_table, token[:, None], pos, cfg=cfg, active=active,
        adapters=adapters,
    )
    return logits[:, 0], cache


def paged_prefill(params, prompt, cache: PagedKVCache, block_table, *, cfg: ModelConfig,
                  adapters=None):
    """Fill pool blocks for the whole prompt ``[B, P]`` in one forward
    (under ``adapters``, as :func:`paged_decode_chunk` takes them): the
    dense ``decode.prefill`` over a block-padded scratch cache, then each
    block stripe transposed to the pool layout ``[Hkv, hd, bs]`` and
    written into the rows' blocks (``block_table [B, >= ceil(P/bs)]``) in
    place.  A quantized pool takes an f32 scratch and whole blocks
    quantized (per-block scales over ``(hd, bs)``).  Returns ``(cache,
    logits [B, V] of the last prompt position)``."""
    b, p_len = prompt.shape
    bs = cache.block_size
    nb = blocks_needed(p_len, bs)
    dense, last_logits = decode.prefill(
        params, prompt, cfg, max_seq=nb * bs,
        cache_dtype=torch.float32 if cache.quantized else cache.k.dtype, adapters=adapters,
    )
    l, hkv, hd = cfg.n_layers, cfg.kv_heads, cfg.head_dim
    # [L, B, nb*bs, Hkv, hd] -> [L, B, nb, Hkv, hd, bs]
    kb = dense.k.reshape(l, b, nb, bs, hkv, hd).permute(0, 1, 2, 4, 5, 3)
    vb = dense.v.reshape(l, b, nb, bs, hkv, hd).permute(0, 1, 2, 4, 5, 3)
    ids = block_table[:, :nb].long()
    _write_blocks(cache, ids, kb, vb)
    return cache, last_logits


def _write_blocks(cache: PagedKVCache, ids, kb, vb) -> None:
    """Write float block stripes ``[L, ..., Hkv, hd, bs]`` into the pool
    blocks ``ids`` (indexing the block axis), in place: cast to a float
    pool's dtype, or quantized whole with their scales."""
    if not cache.quantized:
        cache.k[:, ids] = kb
        cache.v[:, ids] = vb
        return
    for pool, sc, blocks in ((cache.k, cache.k_scale, kb), (cache.v, cache.v_scale, vb)):
        q, scale = quant.quantize_kv_blocks(blocks, cache.kv_dtype)
        pool[:, ids] = q
        sc[:, ids] = scale


def paged_prefill_chunk(params, prompt, cache: PagedKVCache, block_table_row, done_blocks,
                        *, cfg: ModelConfig, chunk_len: int, adapters=None):
    """Incremental admission: gather the row's whole prefill width (``mbp``
    blocks of ``block_table_row [1, mbp]``) into a dense scratch row, run
    one ``decode.decode_chunk`` over the padded prompt's ``[1, bucket]``
    tokens at positions ``done * bs .. done * bs + chunk_len - 1``, and
    write back only the chunk's blocks, in place (a quantized pool's
    gathered row dequantized to f32, the chunk's blocks quantized whole).  The done blocks are
    never rewritten, whether this request's earlier chunks or shared
    prefix-store blocks wrote them; positions past the frontier (the null
    block included) are masked to ``-1e30`` and add an exact 0.

    ``done_blocks`` is a 0-d int tensor, as the reference traces it: only
    ``chunk_len`` shapes the program, so one captured graph serves every
    ``done``.  The tokens and the chunk's block ids are picked on the
    device (``done + arange``), with no host read.  The caller keeps
    ``done * bs + chunk_len <= bucket`` (the reference's ``dynamic_slice``
    would clamp past it; its callers never go there).  ``adapters``: the
    row's ``(bank, ids [1])``, or None.  Returns the cache."""
    l, hkv, hd = cfg.n_layers, cfg.kv_heads, cfg.head_dim
    bucket = prompt.shape[1]
    bs = cache.block_size
    mbp = block_table_row.shape[1]
    if chunk_len > bucket:
        raise ValueError(f"chunk_len {chunk_len} exceeds bucket {bucket}")
    dev = prompt.device
    ids = block_table_row[0].long()
    gathered = [cache.k[:, ids], cache.v[:, ids]]   # [L, mbp, Hkv, hd, lanes]
    if cache.quantized:  # the attended history is the dequantized one, as in decode
        gathered = [quant.dequant_kv_blocks(g, sc[:, ids])
                    for g, sc in zip(gathered, (cache.k_scale, cache.v_scale))]
    # [L, mbp, Hkv, hd, bs] -> seq-major [L, 1, mbp*bs, Hkv, hd]
    row = decode.KVCache(*(
        g.permute(0, 1, 4, 2, 3).reshape(l, 1, mbp * bs, hkv, hd) for g in gathered
    ))
    done = done_blocks.to(device=dev, dtype=torch.long)
    start = done * bs
    chunk = prompt[0].index_select(0, start + torch.arange(chunk_len, device=dev))[None]
    decode.decode_chunk(params, row, chunk, start, cfg=cfg, logits=False, adapters=adapters)
    chunk_ids = done + torch.arange(blocks_needed(chunk_len, bs), device=dev)
    dest = ids.index_select(0, chunk_ids)
    # [L, 1, mbp*bs, Hkv, hd] -> [L, mbp, Hkv, hd, bs], the chunk's blocks
    kb, vb = (dense.reshape(l, mbp, bs, hkv, hd).permute(0, 1, 3, 4, 2).index_select(1, chunk_ids)
              for dense in (row.k, row.v))
    _write_blocks(cache, dest, kb, vb)
    return cache


def paged_prefill_suffix(params, prompt, cache: PagedKVCache, block_table_row, *,
                         cfg: ModelConfig, cached_blocks: int, adapters=None):
    """Prefix-hit admission: one chunk from the ``cached_blocks`` shared
    blocks to the bucket's end (the engine runs it as the "chunk w" program
    of that width).  Returns the cache."""
    done = torch.full((), cached_blocks, dtype=torch.int32, device=prompt.device)
    return paged_prefill_chunk(
        params, prompt, cache, block_table_row, done, cfg=cfg,
        chunk_len=prompt.shape[1] - cached_blocks * cache.block_size, adapters=adapters,
    )


def spec_table_width(max_seq: int, block_size: int, gamma: int) -> int:
    """Block-table columns a speculating engine keeps: an active row's
    verify window reaches position ``max_seq - 2 + gamma`` at most, and the
    append kernel's rule is ``pos + nq <= columns * block_size``; the
    columns past ``ceil(max_seq / block_size)`` hold the null block, so the
    writes a short restored entry's window makes past ``max_seq`` land
    there (dropped, as the reference's scatter drops them)."""
    return max(blocks_needed(max_seq, block_size),
               blocks_needed(max_seq - 1 + gamma, block_size))


def _paged_spec_round(params, draft_params, cache, d_cache, table, last, pos, active,
                      *, cfg: ModelConfig, gamma: int, adapters=None):
    """One speculative round over the paged pool: the draft's proposals
    over its dense cache (``serve.draft_propose``; the base model, whatever
    the rows' adapters), then the verify window ``[last, g_1..g_gamma]``
    through :func:`paged_decode_chunk` under ``adapters``, so the append
    kernel at ``nq = gamma + 1`` on the card.  A window past a slot's owned
    blocks writes through the null block (growth covers only what the slot
    can still commit; past ``max_seq`` the table's extra columns,
    :func:`spec_table_width`).  Positions are clamped as in
    ``serve._spec_round`` (inactive rows only).  Returns ``(target [B,
    gamma + 1] int32, advance [B] int32, cache, d_cache)``."""
    pos = torch.where(active, pos, pos.clamp(max=cfg.max_seq - 1 - gamma))
    d_cache, proposed = serve.draft_propose(draft_params, d_cache, last, pos, active, cfg=cfg,
                                            gamma=gamma)
    window = torch.cat([last[:, None], proposed], dim=1)
    logits, cache = paged_decode_chunk(params, cache, table, window, pos, cfg=cfg, active=active,
                                       adapters=adapters)
    target = logits.argmax(dim=-1).to(torch.int32)
    _, advance = accept_advance(proposed, target, active)
    return target, advance, cache, d_cache


def _paged_step_all(params, cache, table, tokens, pos, active, temps, keys, poison,
                    *, cfg: ModelConfig, top_k: int, adapters=None):
    """One paged decode step for every slot at its own position, then the
    sampling tail (``serve.sample_next``).  ``poison [B]`` (the fault
    window's NaN mask) turns rows' logits to NaN first; ``bad`` flags rows
    whose logits are not finite.  Rows stay independent: a NaN row never
    reaches another.  Returns ``(next_token [B] int32, bad [B] bool,
    cache)``."""
    logits, cache = paged_decode_step(
        params, cache, table, tokens, pos, cfg=cfg, active=active, adapters=adapters
    )
    logits = decode.poison_rows(logits, poison)
    bad = ~decode.finite_rows(logits)
    return serve.sample_next(logits, pos, temps, keys, top_k=top_k), bad, cache


def _paged_pipelined_burst(params, cache, table, tokens, pos, active, temps, keys,
                           stop_pos, poison, *, cfg: ModelConfig, top_k: int,
                           eos_id: int, k: int, adapters=None):
    """K paged steps with no host read inside (``serve._burst_trace``):
    retired rows stop writing; ``temps``, ``keys``, ``poison`` and
    ``adapters`` hold for the whole burst.  Returns ``(trace [3, K, B]
    int32 — token/active/bad planes stacked for ONE readback, cache, last,
    pos, active)``."""

    def step(last, pos_, act):
        next_tok, bad, _ = _paged_step_all(
            params, cache, table, last, pos_, act, temps, keys, poison, cfg=cfg, top_k=top_k,
            adapters=adapters,
        )
        return next_tok, bad

    trace, last, pos, active = serve._burst_trace(step, k, tokens, pos, active, stop_pos, eos_id)
    return trace, cache, last, pos, active


def _paged_first_token(params, cache, table, prompt, plen, slot, temp, key,
                       *, cfg: ModelConfig, top_k: int, adapters=None):
    """Admission tail: re-run the step for every slot at ``plen - 1`` with
    only ``slot`` active (an idempotent rewrite of the last prompt
    position) and sample its first token, every row at the admission's
    temperature and base key as the reference does, under the slots'
    ``adapters``.  ``plen``, ``slot``
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
        key.expand(n_slots, 2), None, cfg=cfg, top_k=top_k, adapters=adapters,
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
      first generated position) are free; each request has its
      temperature (0 or below: greedy), a seed for its base key (default
      its request id) and a priority; ``top_k`` is the engine's;
    * with ``prefix_cache_blocks > 0``, an admission puts the full prompt
      blocks it computed into an LRU store (the prompt's tokens up to the
      block's end -> the block, one reference each; at most
      ``prefix_cache_blocks`` entries), and a later prompt that starts with
      the same tokens SHARES those blocks instead of computing and holding
      its own: its admission runs only the suffix.  The block holding
      position ``plen - 1`` is never stored: the first-token step rewrites
      that position, and a shared block is never written.  Hits and
      misses count blocks (``prefix_hits``, ``prefix_misses``);
    * with ``prefill_chunk_blocks > 0``, ``submit`` only reserves the slot
      and its blocks and queues the prompt; every ``step``/``step_burst``
      then prefills at most that many blocks for the queue's head before
      its burst, and the final chunk activates the slot (its first
      token), so residents keep decoding while a long prompt admits.
      Shared prefix blocks count as chunks already done;
    * blocks grow on demand as a slot's next write crosses a block
      boundary, high priority first (older first within a tier); when the
      pool is empty the slot STALLS (stays resident, generates nothing)
      until a retirement frees blocks;
    * with ``preempt_on_stall``, when every resident slot stalls and no
      prompt is admitting (the admitting head will activate and retire),
      the lowest-priority request short enough to re-prefill in one pass
      (youngest within a tier) is evicted: its references drop, its
      tokens, temperature and key park, and it is re-admitted (high
      priority first, FIFO within a tier) when a slot and its blocks are
      free, before any new submit; re-admission looks up the prefix store
      like any admission and stores nothing back;
    * ``step_burst`` runs up to ``sync_interval`` device steps with ONE
      device-to-host readback (``host_syncs`` counts them; admissions'
      first-token reads are not counted); ``step`` is a burst of one;
    * ``cancel`` retires a request "cancelled" (dropping a prompt still
      admitting, or unparking one); a slot whose logits go non-finite
      retires "quarantined" (the fault window, ``fault_injector``, can
      poison one; it skips admitting slots), and at ``quarantine_limit``
      distinct requests the engine raises "engine poisoned";
    * ``snapshot_active`` captures every in-flight request (resident,
      mid-admission with its prompt as the history, parked) as the dense
      engine's JSON document, and ``restore`` parks each entry and
      re-admits what fits (an idle engine unless ``merge``), so a paged
      snapshot restores into either engine of either package;
      ``release_active`` frees everything without delivering it;
    * with ``spec_gamma > 0`` every ``step`` (and ``step_burst``, which
      hands over to it) is one speculative round: each active slot's
      blocks grow to cover the verify window, the draft (``draft_params``,
      by default the int8 self-quantization of ``params``, over its own
      dense cache) proposes ``spec_gamma`` tokens, the target verifies
      them in one paged pass, and each slot commits up to ``spec_gamma +
      1`` tokens with one readback; every admission path (whole, prefix
      hit, the last chunk, a re-admission, a restore) also fills the
      slot's draft row.  Greedy only (temperature 0, the verify window's
      slack under ``max_seq``), and on the card over a float pool
      ``spec_gamma + 1 <= block_size`` (the kernel's window rule,
      :func:`check_verify_window`);
    * with ``kv_dtype`` "int8" or "int4" the pool stores quantized blocks
      with one f32 scale per (layer, block, KV head), so a
      ``pool_hbm_bytes`` budget holds about 2x or 4x the blocks; every
      program takes the reference's XLA route for such a pool in plain
      PyTorch (:func:`paged_decode_chunk`), and prefix sharing, chunked
      admission, preemption, speculation and snapshots work unchanged (the
      scales follow the block ids).  int4 needs an even ``block_size``;
      a float dtype's name sets ``cache_dtype`` instead;
    * with ``adapter_bank`` (``lora.stack_adapters``), ``submit(adapter=k)``
      serves the request with the bank's adapter k inside the shared
      programs (0, the identity row, adds exact zeros): the store keys
      each block by ``(adapter, tokens)``, so adapted K/V never cross
      adapters; chunked admission, preemption (the parked request keeps
      its id), snapshots and restore carry the id; speculation applies it
      on the verify pass (the draft stays the base model);
    * retirement drops the slot's references at once;
    * ``submit(handoff=True)`` retires the request at its first token into
      :meth:`take_handoffs` with its prompt's K/V as a ``serve.KVSlice``
      (the disaggregated prefill side), ``snapshot_active(include_kv=True)``
      attaches each activated slot's, and ``restore`` writes a fitting
      payload into fresh blocks in place instead of re-prefilling (the
      decode side; :meth:`_restore_inject`);
    * the fleet prefix tier's surface: ``on_prefix_store`` /
      ``on_prefix_evict`` hooks, ``prefix_geometry``,
      ``local_prefix_depth``, ``export_prefix_kv`` and ``inject_prefix_kv``
      (pulled blocks land in the store, so the next admission shares them);
    * ``telemetry`` (``models/telemetry.EngineTelemetry``, off with
      ``telemetry_enabled=False``) records each request's timeline at the
      host points above (admission chunks, activation, preemption and
      re-admission, bursts, retirement), outside the programs, with no
      added readback; ``stats()`` returns its ``EngineStats``.

    Runs on ``device`` (default the card; raises without one unless
    ``device="cpu"``); ``params`` must live there.  On the card each of
    the reference's compiled programs runs as a CUDA graph
    (``serve.GraphedProgram``, in ``graphs``), eagerly inside
    ``serve.disable_graphs()``; on the CPU it runs eagerly.  The programs
    are prefill at the prompt bucket, the first token, the burst at
    ``sync_interval`` and at 1, and one "chunk w" per width ``w`` a chunk
    or a prefix hit's suffix (the bucket after ``c`` cached blocks, one
    chunk from ``done = c``) takes, and with ``spec_gamma`` the "spec
    round" and the "draft prefill": at most :attr:`graph_bound` (``4 +
    ceil(bucket/bs) - 1`` with the store on, a bucket that is a multiple
    of the block size and chunks narrower than the bucket).  The device
    state those programs read and write (block table, active mask, last
    token, position, stop depth, temperature, base key, poison mask and
    adapter id per slot; the admission's prompt, prefill table row, length,
    slot, temperature, key, adapter id and done blocks) keeps one address
    for the engine's life and is written in place; everything else
    (allocation, the prefix store, the admission queue, growth, stalls,
    preemption, retirement) stays on the host.  Not thread-safe; drive it
    from one loop.

    On a mesh (``mesh`` a ``parallel/mesh`` ``DeviceMesh``, ``slot_axis``
    one of its axes or a tuple of them, flattened slice-major) the engine
    is the reference's data-parallel paged server, one process a rank:
    the ``slot_axis`` shards each own ``n_slots / shards`` slots and
    ``n_blocks / shards`` pool blocks (their own null block 0 included),
    table entries are shard-local block ids, and the host keeps one
    allocator and one prefix store per shard (``_allocs``,
    ``_prefix_stores``; ``_alloc`` and ``_prefix_store`` are shard 0's).
    Every rank runs the same scheduler on the same requests in the same
    order and makes the same decisions; a rank runs device work for its
    shard's slots only, on its rows of the per-slot state, its pool shard
    and its draft rows, with the weights whole on every rank.  The decode
    burst and the speculative round hold no collective, so they capture as
    graphs on every rank; the one collective of a burst is its readback,
    the ``[3, K, n_slots / shards]`` trace gathered over the slot group with
    one host copy (``host_syncs`` one a burst).  An admission prefills on
    the shard that holds the slot, whose first token reaches every
    controller by one broadcast; KV payloads (handoff, snapshots, the
    prefix tier's export) go from the shard holding the blocks to every
    controller the same way.  Temperatures and keys are mirrored on the
    host, so preemption and snapshots read no device row.  A request's
    blocks must fit one shard, a stored prefix block serves admissions to
    its own shard, and preemption is per shard: a shard whose whole
    resident set stalls evicts from itself.  Ranks that differ only on
    other mesh axes hold the same slots and compute them alike.  Quantized
    pools are single-shard only, as the reference's are.
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
    prefix_cache_blocks: int = 0   # > 0: an LRU store of shared prompt blocks
    prefill_chunk_blocks: int = 0  # > 0: admit at most this many blocks a step
    preempt_on_stall: bool = True
    fault_injector: object | None = None  # utils/faults.FaultInjector
    quarantine_limit: int = 3  # distinct quarantined requests before "poisoned"
    spec_gamma: int = 0      # > 0: speculative rounds of this many draft tokens
    draft_params: object = None  # the draft; None: the int8 self-draft
    adapter_bank: dict | None = None  # lora.stack_adapters: per-request LoRA
    # "int8"/"int4": a quantized pool (the reference's XLA route, plain
    # PyTorch on every device); a float dtype's name sets cache_dtype
    kv_dtype: str | None = None
    # data-parallel serving: slots and pool blocks sharded over slot_axis of
    # this parallel/mesh DeviceMesh (see the class docstring)
    mesh: object | None = None
    slot_axis: object = "data"
    telemetry_enabled: bool = True
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
        if self.kv_dtype is not None and self.kv_dtype not in quant.KV_DTYPES:
            self.cache_dtype = torch_dtype(self.kv_dtype)  # raises on junk
            self.kv_dtype = None
        if self.kv_dtype is not None and self.mesh is not None:
            raise ValueError(
                f"kv_dtype={self.kv_dtype!r} is single-shard only: quantized pools carry "
                "scale arrays the sharded specs do not cover"
            )
        if self.kv_dtype == "int4" and bs % 2:
            raise ValueError(f"int4 pools need an even block_size, got {bs}")
        check_verify_window(self.spec_gamma, bs, self.device, self.kv_dtype)
        if self.pool_hbm_bytes is not None:
            per_block = kv_block_bytes(cfg, bs, self.kv_dtype or self.cache_dtype)
            derived = self.pool_hbm_bytes // per_block
            if derived < 2:
                raise ValueError(
                    f"pool_hbm_bytes={self.pool_hbm_bytes} holds {derived} "
                    f"blocks of {per_block} bytes — need >= 2 (one is the null block)"
                )
            self.n_blocks = int(derived)
        self._mb = blocks_needed(cfg.max_seq, bs)          # table width
        self._mbp = blocks_needed(self.prompt_bucket, bs)  # prefill width
        self._shards = serve.slot_shards(self)
        ax = self._axis_size = self._shards.count
        if self.n_blocks % ax:
            raise ValueError(
                f"n_blocks ({self.n_blocks}) must divide over {self.slot_axis!r} axis size {ax}"
            )
        if self.n_blocks // ax < 2:
            raise ValueError(
                f"n_blocks ({self.n_blocks}) leaves < 2 blocks per shard (each shard "
                "reserves its own null block)"
            )
        # slots and blocks split contiguously: shard g holds slots
        # [g * spg, (g + 1) * spg) and its own npd blocks, table entries local
        self._spg = self.n_slots // ax   # slots per shard
        self._npd = self.n_blocks // ax  # blocks per shard
        self._allocs = [BlockAllocator(self._npd) for _ in range(ax)]
        self._alloc = self._allocs[0]   # shard 0's (the one pool unsharded)
        self._table_np = np.full((self.n_slots, self._mb), NULL_BLOCK, np.int32)
        self._owned: list[list[int]] = [[] for _ in range(self.n_slots)]
        self._slots: list = [None] * self.n_slots
        self._prio: list[int] = [0] * self.n_slots
        self._preempted: list[dict] = []  # parked requests, re-admission order
        self._admitting: list[dict] = []  # chunked admissions, FIFO; the head advances
        # one store a shard: prompt tokens up to the end of block i -> that
        # shard's pool block (one reference)
        self._prefix_stores = [OrderedDict() for _ in range(ax)]
        self._prefix_store = self._prefix_stores[0]
        self.prefix_hits = 0    # blocks an admission shared from the store
        self.prefix_misses = 0  # storable blocks an admission computed
        # the fleet prefix tier's hooks (the reference's fleet_prefix binds
        # them): on_prefix_store(tokens, n_tokens, adapter) after a block
        # lands in the store, on_prefix_evict(tokens, adapter) after an LRU drop
        self.on_prefix_store = None
        self.on_prefix_evict = None
        self._handoffs: list[dict] = []  # first-token retirements with their payloads
        self._next_id = 0
        self._step_no = 0       # the fault window's step number
        self._completions: list = []
        self.stalled_steps = 0  # slot-steps skipped waiting for a block
        self.host_syncs = 0     # decode-loop readbacks (admissions excluded)
        self.decode_steps = 0   # device decode steps run by step/step_burst
        self.preempted_count = 0  # evictions
        self.quarantined: list[int] = []  # quarantined request ids
        self.shed_count = 0
        self.last_shed: serve.ShedError | None = None
        self.pump_stats: dict = {}
        self._last_step_s = 0.0  # wall time of the last burst
        # port-only, outside EngineStats (whose fields are the reference's)
        self.spec_drafted = 0    # draft tokens proposed to active slots
        self.spec_accepted = 0   # of those, the ones the target agreed with
        self.telemetry = EngineTelemetry(self, enabled=self.telemetry_enabled)
        dev = self.device
        # this rank's shard of the pool and of every per-slot buffer
        self._cache = init_paged_cache(
            cfg, self._npd, bs, dtype=self.cache_dtype, device=dev, kv_dtype=self.kv_dtype
        )
        self._d_cache = None
        if self.spec_gamma > 0:
            self.draft_params, self._d_cache = serve.make_draft_state(
                self.params, self.draft_params, cfg, self._spg, self.cache_dtype, dev
            )
        # the programs' device state: one address each for the engine's life
        i32 = dict(dtype=torch.int32, device=dev)
        width = self._mb
        if self.spec_gamma > 0:
            width = spec_table_width(cfg.max_seq, bs, self.spec_gamma)
        spg = self._spg
        self._table = torch.full((spg, width), NULL_BLOCK, **i32)
        self._table_dirty = False  # _table_np changed since the last upload
        self._active = torch.zeros((spg,), dtype=torch.bool, device=dev)
        self._last, self._pos, self._stop_pos = (torch.zeros((spg,), **i32) for _ in range(3))
        self._temps = torch.zeros((spg,), dtype=torch.float32, device=dev)
        self._keys = torch.zeros((spg, 2), dtype=torch.int64, device=dev)
        # every slot's temperature and base key, as the device rows hold them
        self._temps_np = np.zeros((self.n_slots,), np.float32)
        self._keys_np = np.zeros((self.n_slots, 2), np.int64)
        self._poison = torch.zeros((spg,), dtype=torch.bool, device=dev)
        self._poison_np = np.zeros((self.n_slots,), bool)  # every slot's; _poison holds ours
        self._prompt = torch.zeros((1, self.prompt_bucket), **i32)   # padded
        self._prefill_row = torch.zeros((1, self._mbp), **i32)
        self._admit = torch.zeros((2,), **i32)                       # (plen, slot)
        self._admit_temp = torch.zeros((), dtype=torch.float32, device=dev)
        self._admit_key = torch.zeros((2,), dtype=torch.int64, device=dev)
        self._admit_done = torch.zeros((), **i32)  # a chunk's leading blocks already pooled
        serve.init_adapter_state(self)
        self._eos = -1 if self.eos_id is None else self.eos_id
        self._programs: dict[str, serve.GraphedProgram] = {}

    # -- public API --------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return sum(a.free_blocks for a in self._allocs)

    @property
    def reservable_blocks(self) -> int:
        """Usable KV blocks (each shard's null block excluded)."""
        return sum(a.n_blocks - 1 for a in self._allocs)

    @property
    def graph_bound(self) -> int:
        """The most programs (CUDA graphs on the card) this engine runs:
        prefill, the first token, the bursts at ``sync_interval`` and at 1,
        and a "chunk w" for each width a chunk can take (whole blocks up to
        ``prefill_chunk_blocks``, and a bucket's end inside a block) or a
        prefix hit's suffix can take (``bucket - c * bs`` for each cached
        count ``c`` in ``1 .. (bucket - 1) // bs``), and with speculation
        the "spec round" and the "draft prefill"."""
        bs, bucket = self.block_size, self.prompt_bucket
        widths = set()
        if self.prefill_chunk_blocks > 0:
            top = min(self.prefill_chunk_blocks * bs, bucket)
            widths = {w for w in range(1, top + 1) if w % bs == 0 or (bucket - w) % bs == 0}
        if self.prefix_cache_blocks > 0:
            widths |= {bucket - c * bs for c in range(1, (bucket - 1) // bs + 1)}
        return 4 + len(widths) + (2 if self.spec_gamma > 0 else 0)

    def free_slots(self) -> int:
        return sum(1 for s in self._slots if s is None)

    def submit(self, prompt: list[int], max_tokens: int, temperature: float = 0.0,
               seed: int | None = None, adapter: int = 0, priority: int = 0,
               deadline: int | None = None, queued_at: float | None = None,
               handoff: bool = False) -> int:
        """Admit a request; raises ``serve.NoCapacity`` (a RuntimeError)
        when no slot or not enough blocks are free, or while preempted
        requests wait for re-admission (they go first).  Stored prefix
        blocks the prompt starts with are shared, not computed.  Without
        chunking the prompt prefills here and its first token is sampled;
        with it the slot and blocks are reserved and the prompt queues for
        the steps to prefill.  ``temperature`` above 0 samples under the
        base key ``PRNGKey(seed)`` (default the request id); ``priority``
        (higher first) orders stalls, evictions and re-admissions, never
        what is generated; ``adapter`` is the bank row to serve it with (0:
        the base).  ``queued_at`` (the telemetry clock) is when the request
        entered an upstream queue; default now.  With ``handoff`` the
        request retires at its first token (after its last chunk, when
        chunked) without a completion: its snapshot entry and KV payload go
        to :meth:`take_handoffs` and its blocks are refunded.  Returns the
        request id."""
        t_sub = self.telemetry.now()
        serve.check_submit(
            prompt, max_tokens, self.prompt_bucket, self.cfg.max_seq,
            spec_gamma=self.spec_gamma, temperature=temperature, deadline=deadline,
        )
        serve.check_adapter(self, adapter)
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
        storable = self._storable(len(prompt))
        need = blocks_needed(len(prompt) + 1, self.block_size)
        picked = self._pick_slot(prompt, need, storable, adapter)
        if picked is None:
            raise serve.NoCapacity(
                f"no free blocks ({need} needed, {self.free_blocks} free "
                f"across {self._axis_size} shard(s))"
            )
        slot, ids, cached = picked
        request_id = self._next_id
        base_key = prng.prng_key(request_id if seed is None else seed)
        self.prefix_hits += cached
        if self.prefix_cache_blocks > 0 and storable > 0:
            serve._M_PREFIX.inc(outcome="hit" if cached else "miss")
        self._prio[slot] = priority
        self._reserve(slot, ids)
        if self.prefill_chunk_blocks > 0:
            self._next_id += 1
            self._slots[slot] = serve._Slot(
                request_id, list(prompt), len(prompt), max_tokens, deadline, adapter
            )
            self._admitting.append(dict(
                slot=slot, prompt=list(prompt), plen=len(prompt), done=cached,
                storable=storable, cached=cached, temp=temperature, key=base_key,
                handoff=handoff,
            ))
            # admitted and first token stamp when the final chunk activates
            self.telemetry.on_admit(
                request_id, prompt_len=len(prompt), max_tokens=max_tokens, deadline=deadline,
                adapter=adapter, submitted_at=t_sub, queued_at=queued_at, activated=False,
            )
            self._update_gauges()
            return request_id
        try:
            self._prefill_slot(slot, prompt, cached, adapter)
            self._store_prefix_blocks(prompt, slot, storable, cached, adapter)
            self._prefill_draft(slot, len(prompt))
            first_tok = self._first_token_of(slot, len(prompt), temperature, base_key)
        except BaseException:
            # the slot was never occupied: drop its references
            self._release_slot(slot)
            raise
        self._next_id += 1
        st = serve._Slot(
            request_id, list(prompt) + [first_tok], len(prompt), max_tokens, deadline, adapter
        )
        self._slots[slot] = st
        self._set_row(slot, st, temperature, base_key)
        serve._M_REQUESTS.inc()
        serve._M_TOKENS.inc()  # the admission's first generated token
        # activation is the first token here (read back above)
        self.telemetry.on_admit(
            request_id, prompt_len=len(prompt), max_tokens=max_tokens, deadline=deadline,
            adapter=adapter, submitted_at=t_sub, queued_at=queued_at,
        )
        if handoff:
            self._handoff_retire(slot, temperature, base_key, adapter)
            return request_id
        self._retire(slot)  # max_tokens=1 or eos on the first token
        self._update_gauges()
        return request_id

    def take_handoffs(self) -> list[dict]:
        """Drain the handoff queue: the snapshot entries, each with its KV
        payload under ``"kv"``, of the requests submitted with
        ``handoff=True`` that retired here at their first token."""
        out, self._handoffs = self._handoffs, []
        return out

    def cancel(self, request_id: int) -> bool:
        """Cancel a request between steps: a resident one retires
        "cancelled" with its tokens so far and its references drop (a
        prompt still admitting leaves the admission queue too); a parked
        one unparks (it holds no blocks).  Returns whether the id was
        found."""
        for slot, st in enumerate(self._slots):
            if st is not None and st.request_id == request_id:
                self._admitting = [a for a in self._admitting if a["slot"] != slot]
                serve._early_retire(self, slot, "cancelled", "cancelled by caller")
                return True
        for i, r in enumerate(self._preempted):
            if r["st"].request_id == request_id:
                self._preempted.pop(i)
                serve._retire_parked(self, r["st"], "cancelled", "cancelled by caller")
                return True
        return False

    def step(self) -> int:
        """Re-admit what fits, advance the admission queue's head by one
        chunk, and advance every active, non-stalled slot one token (a
        burst of one step); returns the number of slots stepped."""
        return self._step(1)

    def step_burst(self) -> int:
        """Advance every participating slot up to ``sync_interval`` tokens
        with ONE device-to-host readback; returns the number of slots
        stepped (or quarantined by the fault window).  Parked requests the
        pool can hold re-admit first, then the admission queue's head
        prefills one chunk.  Blocks for the whole burst are grown up front;
        a slot the pool cannot cover stalls for the burst, and if none can
        the burst falls back to one step (the synchronous loop's growth,
        preemption included)."""
        return self._step(self.sync_interval)

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        """Step until nothing is resident, admitting or parked; raises
        "engine wedged" when no slot can progress (a chunk advancing is
        progress)."""
        for _ in range(max_steps):
            admitting = bool(self._admitting)
            if self.step_burst() == 0 and not admitting:
                if self.free_slots() == self.n_slots and not self._preempted:
                    return
                raise serve._wedge_error(self, "engine wedged: resident slots, no progress")
        raise serve._wedge_error(self, "serving loop did not drain")

    def pump(self, requests, max_steps: int = 100_000, queue_limit: int | None = None) -> list:
        """Admit ``requests`` (``(prompt, max_tokens)`` pairs or dicts of
        ``submit`` kwargs) FIFO as slots and blocks free, burst-stepping in
        between; ``queue_limit`` sheds what overflows the waiting queue
        (no device work for a shed request).  Returns the completions."""
        return serve._pump(self, requests, max_steps, queue_limit)

    def completions(self) -> list:
        out, self._completions = self._completions, []
        return out

    def stats(self):
        """The engine's ``telemetry.EngineStats``: queue depth, resident and
        free slots, free pool blocks, prompts admitting, parked requests,
        rolling TTFT/TPOT quantiles, statuses, bursts, host syncs; host
        values only."""
        return self.telemetry.stats()

    def snapshot_active(self, include_kv: bool = False) -> dict:
        """Every in-flight request as the dense engine's JSON-serialisable
        document: resident slots (temperature and base key from the host's
        mirror of the device rows),
        slots still mid-admission (the queue entry holds their sampler
        state; their history is the prompt) and parked requests.  No
        decode step, no block traffic.  ``include_kv`` adds each activated
        resident slot's blocks as a ``serve.KVSlice`` under ``"kv"`` (one
        counted host sync each; entries still admitting or parked carry
        none and re-prefill), so ``restore`` injects them; such a snapshot
        is not JSON."""
        temps, keys = self._temps_np, self._keys_np
        admitting = {a["slot"]: a for a in self._admitting}
        reqs = []
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            adm = admitting.get(slot)
            # the device row is set at activation: mid-admission, the queue
            # entry holds the sampler state
            temp, key = (temps[slot], keys[slot]) if adm is None else (adm["temp"], adm["key"])
            req = serve._snapshot_request(
                st, float(temp), key, st.adapter, priority=self._prio[slot],
                trace=self.telemetry.export_trace(st.request_id),
            )
            if include_kv and adm is None and len(st.tokens) > 1:
                req["kv"] = self._capture_kv(slot, len(st.tokens) - 1)
            reqs.append(req)
        for r in self._preempted:
            reqs.append(serve._snapshot_request(
                r["st"], r["temp"], r["key"], r["st"].adapter, priority=r["priority"],
                trace=self.telemetry.export_trace(r["st"].request_id),
            ))
        return {"engine": type(self).__name__, "next_id": self._next_id, "requests": reqs}

    def restore(self, snapshot: dict, merge: bool = False) -> list[int]:
        """Rebuild a snapshot's requests in this engine: every entry parks
        (in request-id order, then by priority) and drains through the
        re-admission path, whose re-prefill of the history continues each
        stream exactly; what the pool cannot hold yet stays parked and
        admits as capacity frees.  Needs an idle engine unless ``merge``,
        which joins a live engine's parked queue.  A history longer than
        the prompt bucket comes back as an "error" completion.  An adapter
        id outside the engine's bank serves with the row the reference's
        gather reads (``serve.bank_row``), and a bank-less engine serves
        any adapter with the base; either way the entry keeps its id.
        An entry whose ``"kv"`` payload fits this pool
        (``serve._kv_geometry_ok``) injects instead when a slot and its
        blocks are free now (:meth:`_restore_inject`); otherwise it parks
        and re-prefills, counting ``tpu_disagg_fallback_total`` by reason
        ("no_capacity", "incompatible"; ``"kv": None`` counts nothing).
        Each entry's trace is rebuilt first, so its request keeps one
        timeline.  Returns the request ids accepted
        (resident or parked)."""
        serve.check_restorable(snapshot)
        if not merge and (self.n_slots - self.free_slots() or self._admitting
                          or self._preempted):
            raise RuntimeError("restore() needs an idle engine")
        restored: list[int] = []
        for req in sorted(snapshot["requests"], key=lambda r: r["request_id"]):
            self.telemetry.import_trace(int(req["request_id"]), req.get("trace"))
            tokens = [int(t) for t in req["tokens"]]
            if len(tokens) > self.prompt_bucket:
                serve._unrestorable(self, req, f"history {len(tokens)} exceeds prompt_bucket "
                                               f"{self.prompt_bucket}")
                continue
            st = serve._Slot(int(req["request_id"]), tokens, int(req["prompt_len"]),
                             int(req["max_tokens"]), req.get("deadline"),
                             int(req.get("adapter", 0)))
            kv = req.get("kv")
            if kv is not None and serve._kv_geometry_ok(self, kv, len(tokens)):
                if self._restore_inject(req, st, kv):
                    restored.append(st.request_id)
                    JOURNAL.record("serve", "request.restore",
                                   correlation=f"req-{st.request_id}", resumed_at=len(tokens),
                                   kv_inject=True)
                    self.telemetry.on_restore(st.request_id, resumed_at=len(tokens))
                    continue
                # no slot or blocks now: park without the payload, which
                # the re-prefill reproduces whenever capacity frees
                serve._M_DISAGG_FALLBACK.inc(reason="no_capacity")
            elif kv is not None:
                serve._M_DISAGG_FALLBACK.inc(reason="incompatible")
            # keys arrive as plain ints up to 2^32 - 1: int64 holds them
            self._preempted.append(dict(
                st=st, temp=float(req["temperature"]),
                key=torch.tensor([int(x) for x in req["key"]], dtype=torch.int64),
                priority=int(req.get("priority", 0)),
            ))
            restored.append(st.request_id)
            JOURNAL.record("serve", "request.restore", correlation=f"req-{st.request_id}",
                           resumed_at=len(tokens))
            self.telemetry.on_restore(st.request_id, resumed_at=len(tokens))
        self._preempted.sort(key=lambda r: -r["priority"])
        self._next_id = max(
            self._next_id,
            int(snapshot.get("next_id", 0)),
            max((int(r["request_id"]) for r in snapshot["requests"]), default=-1) + 1,
        )
        self._readmit()  # admit what fits now; the rest drains through the steps
        self._update_gauges()
        return restored

    def release_active(self) -> int:
        """Free every slot and its references, and drop the admission
        queue and the parked requests, WITHOUT delivering completions (the
        streams were captured by ``snapshot_active`` and live elsewhere
        now; their traces are dropped, not retired).  Returns how many
        requests were released."""
        released = 0
        self._admitting = []
        for slot, st in enumerate(self._slots):
            if st is not None:
                self._slots[slot] = None
                self._release_slot(slot)
                self._release_trace(st, slot)
                released += 1
        for r in self._preempted:  # parked entries hold no blocks
            self._release_trace(r["st"], -1)
            released += 1
        self._preempted = []
        self._update_gauges()
        return released

    def _release_trace(self, st, slot: int) -> None:
        self.telemetry.drop_trace(st.request_id)
        JOURNAL.record("serve", "request.released", correlation=f"req-{st.request_id}",
                       slot=slot, generated=len(st.tokens) - st.prompt_len)

    # -- KV payloads: handoff, inject and the fleet prefix tier ---------------
    def _label(self) -> str:
        """The pool's payload label: "int8"/"int4", or the float dtype's."""
        return self.kv_dtype or serve.dtype_label(self.cache_dtype)

    def _blocks_payload(self, ids: list[int], valid_len: int, shard: int = 0) -> serve.KVSlice:
        """Pool blocks ``ids`` of ``shard`` as a payload in the canonical
        layout ``[L, positions, Hkv, hd]`` (positions moved off the lane
        axis): a float pool's clipped to ``valid_len``; a quantized pool's
        raw values over the blocks' whole extent, int4 repacked from the
        lanes onto ``head_dim``, with the blocks' scales.  Gathered and laid
        out on the device of the shard's rank, broadcast to the other
        controllers on a mesh, then one copy to the host per tensor: one
        counted host sync."""
        cfg, bs, quant_name = self.cfg, self.block_size, self._cache.kv_dtype
        l, hkv, hd = cfg.n_layers, cfg.kv_heads, cfg.head_dim
        at = torch.tensor(ids, dtype=torch.long).to(self.device)
        planes = []
        for pool in (self._cache.k, self._cache.v):
            if shard != self._shards.index:  # a float pool's (meshes take no other)
                planes.append(torch.empty((l, valid_len, hkv, hd), dtype=pool.dtype,
                                          device=self.device))
                continue
            blocks = pool.index_select(1, at)                        # [L, nb, Hkv, hd, lanes]
            if quant_name == "int4":
                blocks = quant.unpack_int4(blocks)
            x = blocks.permute(0, 1, 4, 2, 3).reshape(l, len(ids) * bs, hkv, hd)
            if quant_name is None:
                x = x[:, :valid_len]
            elif quant_name == "int4":
                x = quant.pack_int4(x)
            planes.append(x.contiguous())
        planes = [serve.host_array(x) for x in serve.from_owner(self, shard, planes)]
        extra = {}
        if quant_name is not None:
            extra = dict(k_scale=serve.host_array(self._cache.k_scale.index_select(1, at)),
                         v_scale=serve.host_array(self._cache.v_scale.index_select(1, at)),
                         block_size=bs)
        self.host_syncs += 1
        serve._M_HOST_SYNCS.inc()
        return serve.KVSlice(k=planes[0], v=planes[1], valid_len=valid_len, n_layers=l,
                             kv_heads=hkv, head_dim=hd, dtype=self._label(), **extra)

    def _payload_stripes(self, kv, nb: int) -> list:
        """The inverse layout: a payload's first ``nb`` blocks as pool
        stripes ``[L, nb, Hkv, hd, lanes]`` on the device (one copy per
        tensor; a float payload clipped or zero-padded to ``nb`` blocks of
        this pool's size), then the scales' first ``nb`` blocks for a
        quantized one: ``[k, v]`` or ``[k, v, k_scale, v_scale]``."""
        cfg, bs = self.cfg, self.block_size
        l, hkv, hd = cfg.n_layers, cfg.kv_heads, cfg.head_dim
        out = []
        for part in (kv.k, kv.v):
            x = serve.device_tensor(part, kv.dtype, self.device)[:, : nb * bs]
            if x.shape[1] < nb * bs:
                x = torch.cat([x, x.new_zeros((l, nb * bs - x.shape[1], *x.shape[2:]))], dim=1)
            if kv.dtype == "int4":
                x = quant.unpack_int4(x)
            x = x.reshape(l, nb, bs, hkv, hd).permute(0, 1, 3, 4, 2)
            out.append(quant.pack_int4(x) if kv.dtype == "int4" else x)
        if kv.block_size > 0:
            out += [serve.device_tensor(np.asarray(sc)[:, :nb], "float32", self.device)
                    for sc in (kv.k_scale, kv.v_scale)]
        return out

    def _write_stripes(self, ids: list[int], stripes) -> None:
        """Write stripes (:meth:`_payload_stripes`) into this rank's pool
        blocks ``ids`` in place (the captured programs keep reading the
        same pool)."""
        at = torch.tensor(ids, dtype=torch.long).to(self.device)
        for whole, part in zip(self._cache, stripes):
            whole.index_copy_(1, at, part)

    def _capture_kv(self, slot: int, valid_len: int) -> serve.KVSlice:
        """The slot's K/V at positions ``< valid_len`` as a payload (its
        first ``ceil(valid_len / block_size)`` blocks)."""
        return self._blocks_payload(self._owned[slot][: blocks_needed(valid_len, self.block_size)],
                                    valid_len, self._group(slot))

    def _handoff_retire(self, slot: int, temperature: float, key, adapter: int) -> None:
        """The first-token retirement of a handoff: the request's snapshot
        entry with its prompt's K/V, the slot's references dropped (a
        shared prefix block stays pooled: the payload holds a copy) with
        no completion, its trace exported into the entry and dropped here
        (the decode engine imports it), the entry queued for
        :meth:`take_handoffs`."""
        st = self._slots[slot]
        entry = serve._snapshot_request(st, temperature, key, adapter, self._prio[slot],
                                        trace=self.telemetry.export_trace(st.request_id))
        entry["kv"] = self._capture_kv(slot, st.prompt_len)
        self._slots[slot] = None
        self._release_slot(slot)
        self.telemetry.drop_trace(st.request_id)
        self._handoffs.append(entry)
        JOURNAL.record("serve", "request.handoff", correlation=f"req-{st.request_id}",
                       slot=slot, kv_bytes=entry["kv"].nbytes)
        self._update_gauges()

    def _restore_inject(self, req: dict, st, kv) -> bool:
        """Install a restored entry from its payload: a free slot and
        blocks of its own (none shared from the store: a shared block is
        never written), the payload's blocks written in place, the draft
        row re-prefilled (the draft cache never travels), the slot's row
        set as a re-admission would.  Returns False when no slot or blocks
        are free; a failure in between refunds the blocks and raises."""
        tokens = st.tokens
        need = blocks_needed(len(tokens) + 1, self.block_size)
        picked = self._pick_slot(tokens, need, 0, st.adapter)
        if picked is None:
            return False
        slot, ids, _ = picked
        self._reserve(slot, ids)
        try:
            nb = blocks_needed(kv.valid_len, self.block_size)
            if serve.owned_row(self, slot) is not None:
                self._write_stripes(ids[:nb], self._payload_stripes(kv, nb))
            self._prio[slot] = int(req.get("priority", 0))
            self._stage(slot, tokens, st.adapter)
            self._prefill_draft(slot, len(tokens))
        except BaseException:
            self._release_slot(slot)  # never resident: no retirement would free them
            raise
        self._slots[slot] = st
        # keys arrive as plain ints up to 2^32 - 1: int64 holds them
        self._set_row(slot, st, float(req["temperature"]),
                      torch.tensor([int(x) for x in req["key"]], dtype=torch.int64))
        self._retire(slot)  # the history may already sit at its budget
        self._update_gauges()
        return True

    def prefix_geometry(self) -> dict:
        """The payload geometry a pulled prefix must have to inject here;
        ``kv_dtype`` is the pool's storage label."""
        return {
            "block_size": self.block_size,
            "kv_dtype": self._label(),
            "n_layers": self.cfg.n_layers,
            "kv_heads": self.cfg.kv_heads,
            "head_dim": self.cfg.head_dim,
        }

    def _prefix_limit(self, prompt) -> int:
        bs = self.block_size
        return min((len(prompt) - 1) // bs, (self.prompt_bucket - 1) // bs)

    def _deepest_store(self, prompt, adapter: int) -> tuple:
        """(the shard whose store holds the longest run of ``prompt``'s
        blocks, the first such shard, and that run's block ids)."""
        limit, best = self._prefix_limit(prompt), (0, [])
        for g, store in enumerate(self._prefix_stores):
            ids = []
            while len(ids) < limit and self._prefix_key(prompt, len(ids), adapter) in store:
                ids.append(int(store[self._prefix_key(prompt, len(ids), adapter)]))
            if len(ids) > len(best[1]):
                best = (g, ids)
        return best

    def local_prefix_depth(self, prompt, adapter: int = 0) -> int:
        """Tokens of the longest run of ``prompt``'s blocks any shard's
        store holds; read only (no LRU touch, no references, no device
        work)."""
        if self.prefix_cache_blocks <= 0:
            return 0
        return len(self._deepest_store([int(t) for t in prompt], adapter)[1]) * self.block_size

    def export_prefix_kv(self, prompt, max_tokens=None, adapter: int = 0):
        """The longest run of ``prompt``'s stored blocks in any shard's
        store as a payload (``valid_len`` its tokens; one counted host
        sync), or None."""
        del max_tokens  # advisory; the stored depth caps it
        if self.prefix_cache_blocks <= 0:
            return None
        shard, ids = self._deepest_store([int(t) for t in prompt], adapter)
        if not ids:
            return None
        return self._blocks_payload(ids, len(ids) * self.block_size, shard)

    def inject_prefix_kv(self, prompt, kv, adapter: int = 0) -> int:
        """Write a pulled prefix payload into fresh pool blocks and put them
        in the store, so the next ``submit`` of ``prompt`` takes the
        prefix-hit admission.  A quantized pool takes its own format and
        block size only (the scales are per block); a float payload of the
        pool's dtype may come in another block size (the whole blocks of
        this pool it covers install).  Returns the tokens installed; 0 (a
        cold prefill) for a payload of another geometry, nothing missing,
        or no free blocks.  A failed write refunds its blocks and raises."""
        if self.prefix_cache_blocks <= 0 or not serve.is_kv_payload(kv):
            return 0
        cfg, bs = self.cfg, self.block_size
        if (kv.n_layers, kv.kv_heads, kv.head_dim) != (cfg.n_layers, cfg.kv_heads, cfg.head_dim):
            return 0
        quantized = self._cache.quantized
        if kv.dtype != self._label() or kv.block_size != (bs if quantized else 0):
            return 0
        if quantized and (kv.valid_len % bs or kv.k_scale is None):
            return 0
        prompt = [int(t) for t in prompt]
        depth = min(kv.valid_len // bs, self._prefix_limit(prompt))
        # one shard takes it, the one with the most free blocks: a stored
        # block serves only admissions to its own shard
        g = max(range(self._axis_size), key=lambda i: self._allocs[i].free_blocks)
        store = self._prefix_stores[g]
        missing = []
        for i in range(depth):
            key = self._prefix_key(prompt, i, adapter)
            if key in store:
                store.move_to_end(key)
            else:
                missing.append(i)
        if not missing:
            return 0
        try:
            ids = self._allocs[g].alloc(len(missing))
        except OutOfBlocks:
            return 0
        try:
            if g == self._shards.index:
                sel = torch.tensor(missing, dtype=torch.long).to(self.device)
                self._write_stripes(ids, [x.index_select(1, sel)
                                          for x in self._payload_stripes(kv, depth)])
            for i, bid in zip(missing, ids):
                store[self._prefix_key(prompt, i, adapter)] = int(bid)
                if self.on_prefix_store is not None:
                    n = (i + 1) * bs
                    self.on_prefix_store(tuple(prompt[:n]), n, adapter)
        except BaseException:
            self._allocs[g].free(ids)  # the reference's refund: nothing else would free them
            raise
        self._trim_prefix_store(g)
        self._update_gauges()
        return len(missing) * bs

    # -- internals ---------------------------------------------------------
    def _step(self, k: int) -> int:
        """Re-admit, advance the admission queue by one chunk, open the
        fault window, grow (or preempt), run a K-step burst (``step`` asks
        for K = 1)."""
        single = k == 1
        self._readmit()
        self._advance_admission()
        if self.spec_gamma > 0:
            return self._spec_step()
        self._step_no += 1
        poison, quarantined = serve._inject_step_faults(self)
        admitting = {a["slot"] for a in self._admitting}
        if all(st is None or s in admitting for s, st in enumerate(self._slots)):
            return quarantined
        active = self._grow_or_preempt(lookahead=k - 1)
        if not active.any() and k > 1:
            k = 1
            active = self._grow_or_preempt(lookahead=0)
        self._sync_table()
        if not active.any():
            return quarantined  # quarantining is progress, stalling is not
        if (poison != self._poison_np).any():
            self._poison.copy_(torch.from_numpy(poison[serve.local_slots(self)]))
            self._poison_np = poison
        return self._burst(k, active, single)

    def _burst(self, k: int, active, single: bool) -> int:
        """Run the K-step burst program for the slots in ``active`` (host
        bool ``[n_slots]``, blocks already grown) with ONE readback, then
        append each slot's tokens up to its first non-finite step, retire
        the finished slots and quarantine the poisoned ones (``single``,
        the reference's ``step()``: in slot order among the commits)."""
        t0 = time.perf_counter()
        self.telemetry.burst_begin(k, self._step_no)  # on the host, before the replay
        self._active.copy_(torch.from_numpy(active[serve.local_slots(self)]))
        trace = self._run(f"burst k={k}", self._burst_program(k))
        # the burst's one readback: [3, K, slots], gathered over the shards
        trace_t, trace_a, trace_b = serve.gather_slots(self, trace, 2)
        self.host_syncs += 1
        serve._M_HOST_SYNCS.inc()
        self.decode_steps += k
        trace_a = trace_a.astype(bool)
        first_bad = serve._first_bad_steps(trace_a, trace_b.astype(bool))
        committed = 0
        for j in range(k):
            for slot, st in enumerate(self._slots):
                if st is None or not trace_a[j][slot]:
                    continue
                if single and slot in first_bad:
                    serve._quarantine_slot(self, slot, "nan_logits",
                                           "non-finite logits in decode step")
                elif j < first_bad.get(slot, k):
                    st.tokens.append(int(trace_t[j][slot]))
                    self.telemetry.on_commit(st.request_id)
                    committed += 1
                    self._retire(slot)
        stepped = int(active.sum())
        self.telemetry.burst_end(stepped)
        for slot in sorted(first_bad):
            if self._slots[slot] is not None:
                serve._quarantine_slot(self, slot, "nan_logits",
                                       f"non-finite logits at burst step {first_bad[slot]}")
        serve._M_TOKENS.inc(committed)
        self._update_gauges()
        self._last_step_s = time.perf_counter() - t0
        serve._M_STEP_LATENCY.observe(self._last_step_s)
        return stepped

    def _spec_step(self) -> int:
        """One speculative round (the reference's round runs no fault
        window): grow each resident slot's blocks over the verify window
        ``pos .. pos + spec_gamma`` (clamped to its remaining stream),
        preempting as a step does; slots the pool cannot cover stall.  Then
        the round with one readback, and each active slot's commit.
        Returns the number of slots stepped."""
        active = self._grow_or_preempt(lookahead=self.spec_gamma)
        self._sync_table()
        if not active.any():
            return 0
        t0 = time.perf_counter()
        self.telemetry.burst_begin(self.spec_gamma + 1, self._step_no)
        self._active.copy_(torch.from_numpy(active[serve.local_slots(self)]))
        readback = serve.gather_slots(self, self._run("spec round", self._spec_program), 0)
        self.host_syncs += 1
        serve._M_HOST_SYNCS.inc()
        committed = serve._commit_spec_round(self, readback, active)
        self.telemetry.burst_end(int(active.sum()))
        serve._M_TOKENS.inc(committed)
        self._update_gauges()
        self._last_step_s = time.perf_counter() - t0
        return int(active.sum())

    def _advance_admission(self) -> None:
        """Prefill at most one chunk for the admission queue's head (only
        the prompt's blocks: the bucket's padding is never attended); after
        the final chunk, activate the slot: its first token, its device
        row, its fresh prompt blocks into the store (after the first
        token, the reference's order), retirement if already done.  A
        failed chunk frees the reservation, delivers an "error" completion
        and raises."""
        if not self._admitting:
            return
        adm = self._admitting[0]
        slot, bs = adm["slot"], self.block_size
        real_end = min(blocks_needed(adm["plen"], bs) * bs, self.prompt_bucket)
        width = self.prefill_chunk_blocks * bs
        try:
            self._stage(slot, adm["prompt"], self._slots[slot].adapter)
            if real_end - adm["done"] * bs > width:
                self._run_chunk(slot, adm["done"], width)
                adm["done"] += self.prefill_chunk_blocks
                self.telemetry.on_admission_chunk(self._slots[slot].request_id)
                return
            if real_end > adm["done"] * bs:
                self._run_chunk(slot, adm["done"], real_end - adm["done"] * bs)
                self.telemetry.on_admission_chunk(self._slots[slot].request_id)
            self._prefill_draft(slot, adm["plen"])
            first_tok = self._first_token_of(slot, adm["plen"], adm["temp"], adm["key"])
        except BaseException as exc:
            self._admitting.pop(0)
            st = self._slots[slot]
            self._slots[slot] = None
            self._release_slot(slot)
            serve._retire_parked(self, st, "error", f"{type(exc).__name__}: {exc}")
            raise
        self._admitting.pop(0)
        serve._M_REQUESTS.inc()  # counted at activation, as a whole admission
        st = self._slots[slot]
        self._store_prefix_blocks(adm["prompt"], slot, adm["storable"], adm["cached"],
                                  st.adapter)
        st.tokens.append(first_tok)
        self._set_row(slot, st, adm["temp"], adm["key"])
        serve._M_TOKENS.inc()
        self.telemetry.on_activate(st.request_id)  # the slot is live, its first token in
        if adm["handoff"]:
            self._handoff_retire(slot, adm["temp"], adm["key"], st.adapter)
            return
        self._retire(slot)
        self._update_gauges()

    def _grow_active_slots(self, lookahead: int):
        """Ensure every resident slot that is not admitting owns blocks
        covering positions ``pos .. pos + lookahead`` (clamped to its
        remaining stream), high priority first and older first within a
        tier; slots the pool cannot serve stall.  The depth comes from the
        host-side invariant ``pos == len(tokens) - 1``, never from a device
        read.  Returns the host active mask."""
        admitting = {a["slot"] for a in self._admitting}
        active = np.zeros((self.n_slots,), bool)
        order = sorted(
            range(self.n_slots),
            key=lambda s: (-self._prio[s], self._slots[s].request_id if self._slots[s] else 0),
        )
        for slot in order:
            st = self._slots[slot]
            if st is None or slot in admitting:
                continue
            remaining = st.prompt_len + serve._slot_budget(st) - len(st.tokens)
            ahead = min(lookahead, max(remaining - 1, 0))
            needed = (len(st.tokens) - 1 + ahead) // self.block_size + 1
            grew = True
            while len(self._owned[slot]) < needed:
                try:
                    (new_id,) = self._alloc_for(slot).alloc(1)
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
        """Block growth; with ``preempt_on_stall``, per shard, while every
        resident slot of a shard stalls and nothing admits there, evict one
        of its requests and grow again (a wedged shard's pool breathes only
        through its own retirements; with one shard, the whole engine).
        Returns the host active mask."""
        active = self._grow_active_slots(lookahead)
        if self.preempt_on_stall:
            busy = {self._group(a["slot"]) for a in self._admitting}
            evicted = False
            for g in range(self._axis_size):
                if g in busy:
                    continue  # the admitting head will activate and retire
                shard = range(g * self._spg, (g + 1) * self._spg)
                while True:
                    resident = [s for s in shard if self._slots[s] is not None]
                    if not resident or active[resident].any() or not self._preempt_one(g):
                        break
                    evicted = True
                    active = self._grow_active_slots(lookahead)
            if evicted:
                self._update_gauges()
        return active

    def _preempt_one(self, group: int) -> bool:
        """Evict the lowest-priority resident request of shard ``group``
        still short enough to re-prefill in one pass (the youngest within a
        tier), never one admitting: park its tokens, temperature and base
        key (the host's mirror of its device row) and drop its references.
        Returns whether a request was evicted."""
        admitting = {a["slot"] for a in self._admitting}
        victim, vslot = None, -1
        for slot, st in enumerate(self._slots):
            if st is None or slot in admitting or self._group(slot) != group:
                continue
            if len(st.tokens) + 1 > self.prompt_bucket:
                continue  # grown past one-pass re-prefill: not resumable
            if victim is None or (
                (self._prio[slot], -st.request_id) < (self._prio[vslot], -victim.request_id)
            ):
                victim, vslot = st, slot
        if victim is None:
            return False
        # a copy: the mirror's row is the slot's next request's
        self._preempted.append(dict(
            st=victim, temp=float(self._temps_np[vslot]),
            key=torch.from_numpy(self._keys_np[vslot].copy()), priority=self._prio[vslot],
        ))
        # re-admission: high priority first, FIFO within a tier (stable)
        self._preempted.sort(key=lambda r: -r["priority"])
        self._slots[vslot] = None
        self._release_slot(vslot)
        self.preempted_count += 1
        _M_PREEMPTIONS.inc()
        self.telemetry.on_event(victim.request_id, "preempt")
        return True

    def _readmit(self) -> None:
        """Re-prefill parked requests, in queue order, while a slot and
        their blocks are free: the parked tokens are the prompt (stored
        prefix blocks they start with are shared, and nothing is stored
        back), and the next step samples the next token at the same
        position under the same key, so the stream continues exactly.  A
        re-admission that fails drops its references, delivers an "error"
        completion and raises."""
        while self._preempted:
            r = self._preempted[0]
            st = r["st"]
            need = blocks_needed(len(st.tokens) + 1, self.block_size)
            picked = self._pick_slot(st.tokens, need, self._storable(len(st.tokens)),
                                     st.adapter)
            if picked is None:
                return  # stays parked; the head blocks the queue
            slot, ids, cached = picked
            self._prio[slot] = r["priority"]
            self._reserve(slot, ids)
            try:
                self._prefill_slot(slot, st.tokens, cached, st.adapter)
                self._prefill_draft(slot, len(st.tokens))
            except BaseException as exc:
                self._release_slot(slot)
                self._preempted.pop(0)
                serve._retire_parked(self, st, "error", f"{type(exc).__name__}: {exc}")
                raise
            self._preempted.pop(0)
            self._slots[slot] = st
            self._set_row(slot, st, r["temp"], r["key"])
            self.telemetry.on_event(st.request_id, "readmit")
            self._update_gauges()

    def _storable(self, n_tokens: int) -> int:
        """Leading full blocks of an ``n_tokens`` history the store may
        hold: never the block of position ``n_tokens - 1`` (the first-token
        step rewrites it), and a suffix is never empty."""
        bs = self.block_size
        return min((n_tokens - 1) // bs, (self.prompt_bucket - 1) // bs)

    def _group(self, slot: int) -> int:
        """The shard holding ``slot`` (0 unsharded)."""
        return slot // self._spg

    def _alloc_for(self, slot: int) -> BlockAllocator:
        return self._allocs[self._group(slot)]

    def _pick_slot(self, tokens, need: int, storable: int, adapter: int = 0):
        """The reference's shard walk: the first free slot whose shard has
        ``need`` blocks for it, the stored prefix blocks ``tokens`` starts
        with under ``adapter`` (up to ``storable``, in that shard's store)
        shared among them: ``(slot, ids, cached)`` with the blocks
        referenced.  One candidate a shard (a second slot there could not do
        better); None when no slot is free or no shard can cover the rest
        (the hits' references drop again).  The same order on every
        controller, so every rank picks the same slot."""
        tried: set[int] = set()
        for slot in range(self.n_slots):
            g = self._group(slot)
            if self._slots[slot] is not None or g in tried:
                continue
            tried.add(g)
            alloc, store = self._allocs[g], self._prefix_stores[g]
            hits: list[int] = []
            if self.prefix_cache_blocks > 0:
                for i in range(storable):
                    key = self._prefix_key(tokens, i, adapter)
                    if key not in store:
                        break
                    store.move_to_end(key)  # LRU touch
                    hits.append(alloc.share(store[key]))
            try:
                return slot, hits + alloc.alloc(need - len(hits)), len(hits)
            except OutOfBlocks:
                alloc.free(hits)
        return None

    def _prefix_key(self, tokens, i: int, adapter: int = 0) -> tuple:
        """The store's key of block ``i``: the tokens up to its end, with a
        bank ``(adapter, tokens)``, since adapted K/V belong to their
        adapter."""
        key = tuple(tokens[: (i + 1) * self.block_size])
        return key if self.adapter_bank is None else (adapter, key)

    def _store_prefix_blocks(self, prompt, slot: int, storable: int, cached: int,
                             adapter: int = 0) -> None:
        """Put the admission's freshly computed storable blocks into the
        LRU store (one reference each, so they outlive the request), then
        evict the least recently used entries past ``prefix_cache_blocks``."""
        if self.prefix_cache_blocks <= 0:
            return
        self.prefix_misses += max(storable - cached, 0)
        g = self._group(slot)
        store = self._prefix_stores[g]
        for i in range(cached, storable):
            key = self._prefix_key(prompt, i, adapter)
            if key in store:  # stored meanwhile by another admission
                store.move_to_end(key)
                continue
            store[key] = self._allocs[g].share(int(self._table_np[slot, i]))
            if self.on_prefix_store is not None:
                n = (i + 1) * self.block_size
                self.on_prefix_store(tuple(prompt[:n]), n, adapter)
        self._trim_prefix_store(g)

    def _trim_prefix_store(self, g: int) -> None:
        """Evict shard ``g``'s least recently used entries past
        ``prefix_cache_blocks`` (a bound per store, as the reference's)."""
        store = self._prefix_stores[g]
        while len(store) > self.prefix_cache_blocks:
            old_key, old = store.popitem(last=False)
            self._allocs[g].free([old])
            if self.on_prefix_evict is not None:
                adapter, tokens = serve.split_prefix_key(self, old_key)
                self.on_prefix_evict(tokens, adapter)

    def _reserve(self, slot: int, ids: list[int]) -> None:
        """Point ``slot``'s table row at ``ids`` (uploaded before the next
        program)."""
        self._owned[slot] = ids
        self._table_np[slot, :] = NULL_BLOCK
        self._table_np[slot, : len(ids)] = ids
        self._table_dirty = True

    def _stage(self, slot: int, tokens: list[int], adapter: int = 0) -> None:
        """Write an admission's inputs into the programs' buffers on the
        rank holding ``slot`` (the others run none of its programs): the
        table, the padded prompt and ``slot``'s prefill row (entries past
        its blocks are the null block, a scratch sink never attended), and
        with a bank the slot's adapter id and its row (``_admit[1]``, whose
        id the prefill programs gather; the first-token step runs under the
        slot's id too)."""
        self._sync_table()
        row = serve.owned_row(self, slot)
        if row is None:
            return
        padded = np.zeros((1, self.prompt_bucket), np.int32)
        padded[0, : len(tokens)] = tokens
        self._prompt.copy_(torch.from_numpy(padded))
        self._prefill_row.copy_(torch.from_numpy(self._table_np[slot : slot + 1, : self._mbp]))
        if self.adapter_bank is not None:
            self._admit[1].fill_(row)
            self._adapter_ids[row] = serve.bank_row(self, adapter)

    def _prefill_slot(self, slot: int, tokens: list[int], cached: int, adapter: int = 0) -> None:
        """Prefill ``tokens`` into ``slot``'s blocks under ``adapter`` on
        the rank holding it: the whole bucket, or with ``cached`` shared
        blocks only the suffix after them, as one chunk
        (``paged_prefill_suffix``'s computation)."""
        self._stage(slot, tokens, adapter)
        if cached:
            self._run_chunk(slot, cached, self.prompt_bucket - cached * self.block_size)
        elif serve.owned_row(self, slot) is not None:
            self._run("prefill", self._prefill)

    def _run_chunk(self, slot: int, done: int, width: int) -> None:
        """One chunk of ``width`` tokens after ``done`` pooled blocks, for
        the staged admission of ``slot`` (on the rank holding it)."""
        assert done * self.block_size + width <= self.prompt_bucket
        if serve.owned_row(self, slot) is not None:
            self._admit_done.fill_(done)
            self._run(f"chunk {width}", self._chunk_program(width))

    def _prefill_draft(self, slot: int, plen: int) -> None:
        """With speculation on, fill ``slot``'s draft row from the staged
        padded prompt (the whole prompt, whatever the target shared or
        chunked), on the rank holding it."""
        row = serve.owned_row(self, slot)
        if self.spec_gamma > 0 and row is not None:
            self._admit.copy_(torch.tensor([plen, row], dtype=torch.int32))
            self._run("draft prefill", self._draft_prefill)

    def _first_token_of(self, slot: int, plen: int, temperature: float, key) -> int:
        """The staged admission's first token, sampled on the rank holding
        ``slot`` and sent to every controller (its readback is not counted
        in ``host_syncs``)."""

        def run():
            self._admit.copy_(torch.tensor([plen, serve.owned_row(self, slot)],
                                           dtype=torch.int32))
            self._admit_temp.fill_(temperature)
            self._admit_key.copy_(key)
            return self._run("first token", self._first_token)

        return serve.owner_token(self, slot, run)

    def _set_row(self, slot: int, st, temperature: float, key) -> None:
        """A resident slot's device row (on the rank holding it): last
        token, position (``len(tokens) - 1``), stop depth (from the original
        prompt length and budget), temperature and base key; the last two
        mirrored on the host on every rank."""
        self._temps_np[slot] = temperature
        self._keys_np[slot] = torch.as_tensor(key).cpu().numpy()
        row = serve.owned_row(self, slot)
        if row is None:
            return
        self._last[row] = st.tokens[-1]
        self._pos[row] = len(st.tokens) - 1
        self._stop_pos[row] = st.prompt_len + serve._slot_budget(st) - 1
        self._temps[row] = temperature
        self._keys[row] = key

    def _release_slot(self, slot: int) -> None:
        """Drop ``slot``'s references (a shared block stays with its other
        holders) and point its table row at the null block (uploaded
        before the next program)."""
        self._alloc_for(slot).free(self._owned[slot])
        self._owned[slot] = []
        self._table_np[slot, :] = NULL_BLOCK
        self._table_dirty = True

    def _sync_table(self) -> None:
        """Upload the host block table into ``_table`` in place (its first
        columns: a speculating engine's extra ones stay null), once for
        however many changes since the last upload."""
        if self._table_dirty:
            self._table[:, : self._mb].copy_(
                torch.from_numpy(self._table_np[serve.local_slots(self)]))
            self._table_dirty = False

    # -- the programs (the reference's compiled ones) ------------------------
    @property
    def graphs(self) -> dict:
        """The engine's CUDA graphs by program name (none on the CPU or
        under ``serve.disable_graphs()``)."""
        return dict(self._programs)

    def _run(self, name: str, fn):
        return serve.run_program(self, name, fn)

    def _adapters(self):
        """The programs' adapter context ``(bank, per-slot ids)``, or None
        without a bank (the programs of an engine with no LoRA at all)."""
        return None if self.adapter_bank is None else (self.adapter_bank, self._adapter_ids)

    def _prefill(self) -> None:
        paged_prefill(self.params, self._prompt, self._cache, self._prefill_row, cfg=self.cfg,
                      adapters=serve._row_adapters(self._adapters(), self._admit[1]))

    def _chunk_program(self, width: int):
        def chunk():
            paged_prefill_chunk(self.params, self._prompt, self._cache, self._prefill_row,
                                self._admit_done, cfg=self.cfg, chunk_len=width,
                                adapters=serve._row_adapters(self._adapters(), self._admit[1]))
        return chunk

    def _first_token(self):
        tok, _ = _paged_first_token(
            self.params, self._cache, self._table, self._prompt, self._admit[0],
            self._admit[1], self._admit_temp, self._admit_key, cfg=self.cfg,
            top_k=self.top_k, adapters=self._adapters(),
        )
        return tok

    def _draft_prefill(self) -> None:
        serve._prefill_draft_row(self.draft_params, self._d_cache, self._prompt,
                                 self._admit[0], self._admit[1], cfg=self.cfg)

    def _spec_program(self):
        target, advance, _, _ = _paged_spec_round(
            self.params, self.draft_params, self._cache, self._d_cache, self._table, self._last,
            self._pos, self._active, cfg=self.cfg, gamma=self.spec_gamma,
            adapters=self._adapters(),
        )
        return serve._spec_advance(target, advance, self._last, self._pos, self._active)

    def _burst_program(self, k: int):
        def burst():
            trace, _, last, pos, _ = _paged_pipelined_burst(
                self.params, self._cache, self._table, self._last, self._pos,
                self._active, self._temps, self._keys, self._stop_pos, self._poison,
                cfg=self.cfg, top_k=self.top_k, eos_id=self._eos, k=k,
                adapters=self._adapters(),
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
            self._release_slot(slot)
            self.telemetry.on_retire(done.request_id, done.status, len(done.generated))

    def _update_gauges(self) -> None:
        """Slot occupancy, free pool blocks and the pool's bytes by dtype."""
        serve._M_OCCUPANCY.set(self.n_slots - self.free_slots())
        _M_POOL_FREE.set(self.free_blocks)
        _M_KV_BYTES.set(
            self.n_blocks * kv_block_bytes(self.cfg, self.block_size,
                                           self.kv_dtype or self.cache_dtype),
            dtype=self.kv_dtype or str(self.cache_dtype).removeprefix("torch."),
        )
