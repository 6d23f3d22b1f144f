"""Ragged paged attention over a block-pooled KV cache
(``k8s_dra_driver_tpu/ops/paged_attention.py``).

The pool keeps the JAX package's layout: ``[n_blocks, Hkv, d, bs]`` per
layer (``[L, n_blocks, Hkv, d, bs]`` stacked), positions contiguous on the
last axis, block 0 the engine's null block; a row's ``block_table`` lists
its pool blocks in order.  Window query ``j`` (of ``nq``) sits at position
``pos + j`` and attends positions ``<= pos + j``.

Three entry points share one CUDA source (``csrc/paged_attention.cu``,
whose header says what bounds it and how), compiled with and without its
``APPEND`` flag.  Each call is a split-K decode: one launch attends each
range of ``pages_per_split`` pages of a row into a float32 workspace, a
second merges a row's ranges in a fixed order:

* :func:`paged_append_attention` — the serving step: store each row's
  ``nq`` new k/v into layer ``layer`` of the stacked pools IN PLACE (rows
  whose ``write_mask`` is false do not write), then attend;
* :func:`paged_window_attention` — the same attention with no write;
* :func:`paged_decode_attention` — its single-query view.

For CUDA tensors each launches the kernel (or raises); for CPU tensors it
runs the plain version beside it: :func:`paged_window_attention_plain`
(the reference's ``paged_window_attention_xla_gqa``) and its append twin
:func:`paged_append_attention_plain`.  The TPU kernel's ``block_size % 128``
rule and its pages-per-step tuning belong to the TPU and are not carried
over; the kernel's own rule is :func:`check_kernel_shape`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from k8s_dra_driver_torch.ops import _build

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
SPLIT_KEYS = 64  # keys per split; 64 won a sweep of 32/64/128 on an H100 (chip_smoke)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# paged_attention(dtype, append, d, q, new_k, new_v, k_pool, v_pool, table,
# pos, write_mask, workspace, out, out_f32, B, hkv, groups, nq, bs,
# max_blocks, pages_per_split, n_splits, scale, stream)
_ARGTYPES = (
    [ctypes.c_int] * 3 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_void_p]
)

# Kernel calls by instantiation since the counts were last set to 0, one
# per wrapper call (its two CUDA launches count once; the plain versions do
# not count): "append" for paged_append_attention, "window" for
# paged_window_attention / paged_decode_attention.
launches = {"append": 0, "window": 0}


def launch_counts() -> dict:
    """A copy of the counters (read by the CUDA-graph holder,
    ``models/graphs.GraphedProgram``)."""
    return dict(launches)


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` (keys as :func:`launch_counts` gives them) to the
    counters: a graph replay counts the launches its capture recorded."""
    for key in launches:
        launches[key] += delta.get(key, 0)


def _scale(d: int) -> float:
    """1/sqrt(d) computed in f32, as the reference does."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _attend_gathered(q, kb, vb, pos):
    """Grouped attention of ``q [B, nq, Hq, d]`` over gathered blocks
    ``kb``/``vb [B, mb, Hkv, d, bs]``: operands rounded to the pool dtype,
    products and sums in f32, ``-1e30`` mask, f32 softmax, probabilities
    rounded to the pool dtype for the P.V product."""
    b, nq, hq, d = q.shape
    hkv = kb.shape[2]
    groups = hq // hkv
    qg = q.reshape(b, nq, hkv, groups, d)
    scores = torch.einsum(
        "bqhgd,bmhds->bhgqms", qg.to(kb.dtype).float(), kb.float()
    ) * _scale(d)
    mb, bs = scores.shape[-2:]
    scores = scores.reshape(b, hkv, groups, nq, mb * bs)
    k_pos = torch.arange(mb * bs, device=q.device)
    qpos = pos.long()[:, None] + torch.arange(nq, device=q.device)[None, :]
    mask = (k_pos[None, None, :] <= qpos[:, :, None])[:, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhgqms,bmhds->bqhgd",
        probs.reshape(b, hkv, groups, nq, mb, bs).to(vb.dtype).float(),
        vb.float(),
    )
    return out.to(q.dtype).reshape(b, nq, hq, d)


def paged_window_attention_plain(q, k_pool, v_pool, block_table, pos):
    """Gather-based window attention in plain PyTorch (the reference's
    ``paged_window_attention_xla_gqa``); the window's keys must already be
    in the pool.  Returns ``[B, nq, Hq, d]`` in q's dtype."""
    if q.shape[2] % k_pool.shape[1]:
        raise ValueError(
            f"query heads {q.shape[2]} must be a multiple of kv heads {k_pool.shape[1]}"
        )
    ids = block_table.long()
    return _attend_gathered(q, k_pool[ids], v_pool[ids], pos)


def paged_append_attention_plain(
    q, new_k, new_v, k_pools, v_pools, block_table, pos, layer: int,
    write_mask=None,
):
    """The append twin of :func:`paged_window_attention_plain`: store the
    new k/v of rows with ``write_mask`` set into layer ``layer`` in place,
    then attend with every row's window keys taken from ``new_k``/``new_v``
    (what the kernel does, written or not).  Returns ``[B, nq, Hq, d]``."""
    b, nq = q.shape[:2]
    bs = k_pools.shape[4]
    dev = q.device
    rows = torch.arange(b, device=dev)[:, None]
    positions = pos.long()[:, None] + torch.arange(nq, device=dev)[None, :]
    pages, offs = positions // bs, positions % bs
    ids = block_table.long()
    nk = new_k.to(k_pools.dtype)
    nv = new_v.to(v_pools.dtype)
    sel = (
        torch.ones((b,), dtype=torch.bool, device=dev)
        if write_mask is None else write_mask.to(torch.bool)
    )
    blocks = ids[rows, pages]                                  # [B, nq]
    k_pools[layer][blocks[sel], :, :, offs[sel]] = nk[sel]
    v_pools[layer][blocks[sel], :, :, offs[sel]] = nv[sel]
    kb = k_pools[layer][ids]                                   # [B, mb, Hkv, d, bs]
    vb = v_pools[layer][ids]
    kb[rows, pages, :, :, offs] = nk
    vb[rows, pages, :, :, offs] = nv
    return _attend_gathered(q, kb, vb, pos)


def split_schedule(block_size: int, max_blocks: int) -> tuple[int, int]:
    """(pages per split, splits per row) for a table of ``max_blocks``
    blocks: from shapes only, so no call reads ``pos`` on the host."""
    pages = max(1, SPLIT_KEYS // block_size)
    return pages, -(-max_blocks // pages)


def check_kernel_shape(d: int, nq: int, block_size: int, append: bool) -> None:
    """The CUDA kernel's rule: head dim in ``KERNEL_HEAD_DIMS`` and, when
    appending, a window of at most one block."""
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged attention kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    if append and nq > block_size:
        raise ValueError(
            f"append window {nq} exceeds block_size {block_size} "
            "(new positions must span at most two blocks)"
        )


def _i32(t, dev):
    return t.to(device=dev, dtype=torch.int32).contiguous()


def _launch(q, new_k, new_v, k_pool, v_pool, block_table, pos, write_mask, append):
    """One kernel call (partial, then merge) over ONE layer's pools
    ``[N, Hkv, d, bs]`` (views into the stacked pools are fine: they are
    contiguous)."""
    b, nq, hq, d = q.shape
    n_pool, hkv, d_pool, bs = k_pool.shape
    dev = k_pool.device
    if hq % hkv:
        raise ValueError(f"query heads {hq} must be a multiple of kv heads {hkv}")
    if d_pool != d or tuple(v_pool.shape) != tuple(k_pool.shape):
        raise ValueError(f"pool shape {tuple(k_pool.shape)} does not fit q {tuple(q.shape)}")
    check_kernel_shape(d, nq, bs, append)
    if k_pool.dtype not in _DTYPE_CODES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"paged attention kernel takes float32 or bfloat16 pools, got {k_pool.dtype}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged attention kernel needs contiguous pools")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged attention kernel needs 16-byte aligned pools (cp.async)")
    if q.device != dev or block_table.device != dev or pos.device != dev:
        raise ValueError("paged attention operands must share the pools' device")
    # the kernel reads table row b and pos[b] for every b < B: a short table
    # or pos would be read past its end
    if block_table.dim() != 2 or block_table.shape[0] != b or tuple(pos.shape) != (b,):
        raise ValueError(
            f"block_table must be [{b}, max_blocks] and pos [{b}], got "
            f"{tuple(block_table.shape)} and {tuple(pos.shape)}"
        )
    if write_mask is not None and tuple(write_mask.shape) != (b,):
        raise ValueError(f"write_mask must be [{b}], got {tuple(write_mask.shape)}")
    qk = q.to(k_pool.dtype).contiguous()
    # the result is rounded once, to q's dtype: float32 queries keep a
    # float32 result even over a bf16 pool
    out_f32 = q.dtype == torch.float32
    out = torch.empty(
        (b, nq, hq, d), dtype=torch.float32 if out_f32 else k_pool.dtype, device=dev
    )
    table = _i32(block_table, dev)
    pos32 = _i32(pos, dev)
    pages, n_splits = split_schedule(bs, table.shape[1])
    # each split's (acc [d], m, l) per query row, written and read only for
    # a row's live splits
    workspace = torch.empty(
        (b, hkv, n_splits, (hq // hkv) * nq, d + 2), dtype=torch.float32, device=dev
    )
    if append:
        nk = new_k.to(k_pool.dtype).contiguous()
        nv = new_v.to(k_pool.dtype).contiguous()
        if tuple(nk.shape) != (b, nq, hkv, d) or tuple(nv.shape) != (b, nq, hkv, d):
            raise ValueError(f"new k/v must be {(b, nq, hkv, d)}, got {tuple(nk.shape)}")
        wm = None if write_mask is None else _i32(write_mask, dev)  # None: every row writes
        extra = (nk.data_ptr(), nv.data_ptr(), None if wm is None else wm.data_ptr())
    else:
        extra = (None, None, None)
    rc = _build.load("paged_attention", {"paged_attention": _ARGTYPES}).paged_attention(
        _DTYPE_CODES[k_pool.dtype], int(append), d,
        qk.data_ptr(), extra[0], extra[1], k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), pos32.data_ptr(), extra[2], workspace.data_ptr(), out.data_ptr(),
        int(out_f32), b, hkv, hq // hkv, nq, bs, table.shape[1], pages, n_splits,
        _scale(d), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("paged_attention", rc)
    launches["append" if append else "window"] += 1
    return out.to(q.dtype)


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"paged attention runs on cuda or cpu tensors, got {t.device}")
    return False


def paged_window_attention(q, k_pool, v_pool, block_table, pos):
    """``q [B, nq, Hq, d]`` over pool ``[N, Hkv, d, bs]`` through
    ``block_table [B, mb]``; window query j attends positions ``<= pos + j``
    (the window's keys must already be in the pool).  Returns
    ``[B, nq, Hq, d]`` in q's dtype."""
    if _on_cpu(k_pool):
        return paged_window_attention_plain(q, k_pool, v_pool, block_table, pos)
    return _launch(q, None, None, k_pool, v_pool, block_table, pos, None, append=False)


def paged_append_attention(
    q, new_k, new_v, k_pools, v_pools, block_table, pos, layer: int,
    write_mask=None,
):
    """Fused append + attend over the stacked pools ``[L, N, Hkv, d, bs]``:
    rows with ``write_mask`` set (default all) store their ``nq`` new k/v
    ``[B, nq, Hkv, d]`` at positions ``pos .. pos+nq-1`` of layer ``layer``
    IN PLACE; every row then attends with its window keys taken from the
    new k/v.  Returns ``(out [B, nq, Hq, d], k_pools, v_pools)``, the pools
    being the same tensors that came in."""
    if not 0 <= layer < k_pools.shape[0]:
        raise ValueError(f"layer {layer} out of range for {k_pools.shape[0]} pools")
    if _on_cpu(k_pools):
        out = paged_append_attention_plain(
            q, new_k, new_v, k_pools, v_pools, block_table, pos, layer, write_mask
        )
    else:
        out = _launch(
            q, new_k, new_v, k_pools[layer], v_pools[layer], block_table, pos,
            write_mask, append=True,
        )
    return out, k_pools, v_pools


def paged_decode_attention(q, k_pool, v_pool, block_table, lengths):
    """Single-query view of :func:`paged_window_attention`: ``q [B, Hq, d]``
    attends each row's first ``lengths`` keys.  Returns ``[B, Hq, d]``."""
    return paged_window_attention(
        q[:, None], k_pool, v_pool, block_table, lengths.to(torch.int32) - 1
    )[:, 0]
