"""Flash attention with its backward (``k8s_dra_driver_tpu/ops/flash_attention.py``).

q/k/v are ``[B, S, H, D]`` at :func:`flash_attention` and ``[B·H, S, D]``
(:func:`to_bh`) below it.  Three passes, one CUDA source
(``csrc/flash_attention.cu``, whose header says what bounds them and how),
each with two kernels chosen by a static rule on the dtype: bf16 runs the
``*_wgmma`` kernel (TMA and ``wgmma`` on the tensor cores), f32 the
``*_fma`` kernel (f32 FMAs on the CUDA cores; the tensor cores would run
f32 as TF32, far outside its 2^-16 limit):

* ``flash_fwd`` behind :func:`_forward_bhsd` (:func:`forward_kernel_for`):
  the attention and its ``lse = m + log l`` residual, ``[B·H, S]`` f32;
* ``flash_bwd_dq`` and ``flash_bwd_dkv`` behind :func:`_backward_bhsd`
  (:func:`backward_kernel_for`): dQ, then dK/dV, each recomputing P from
  lse.  ``delta = rowsum(dout · out)`` is computed here, outside the
  kernels, as in the JAX package.

:class:`FlashCore` is the ``torch.autograd.Function`` that ties them
together (the JAX package's ``_flash_core`` custom VJP).  For CUDA tensors
each wrapper launches its kernel or raises; for CPU tensors it runs the plain
version beside it (:func:`flash_forward_plain`, :func:`flash_backward_plain`),
written out formula by formula with the casts where the Pallas kernels put
them: scores as an f32 dot scaled after the dot, ``-1e30`` masks, P rounded
to v's dtype before P·V, dS rounded to k's dtype for dQ and to q's for dK,
P rounded to dout's dtype for dV.  The CUDA tile is the kernel's own choice;
``block_q``/``block_k`` keep only the JAX package's divisibility check.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from k8s_dra_driver_torch.ops import _build

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_NEG_INF = -1e30
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_VOIDS = [ctypes.c_void_p]
# (d, q, k, v, out, lse, out_f32, BH, S, causal, scale, stream)
_FWD_ARGS = [ctypes.c_int] + _VOIDS * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] + _VOIDS
# (d, q, k, v, dout, lse, delta, dq, BH, S, causal, scale, stream)
_DQ_ARGS = [ctypes.c_int] + _VOIDS * 7 + [ctypes.c_int] * 3 + [ctypes.c_float] + _VOIDS
# (d, q, k, v, dout, lse, delta, dk, dv, BH, S, causal, scale, stream)
_DKV_ARGS = [ctypes.c_int] + _VOIDS * 8 + [ctypes.c_int] * 3 + [ctypes.c_float] + _VOIDS
_LAUNCHERS = {
    **{f"flash_fwd_{r}": _FWD_ARGS for r in ("fma", "wgmma")},
    **{f"flash_bwd_dq_{r}": _DQ_ARGS for r in ("fma", "wgmma")},
    **{f"flash_bwd_dkv_{r}": _DKV_ARGS for r in ("fma", "wgmma")},
}

# Kernel launches since the counts were last set to 0 (the plain versions
# do not count).  ``launches`` counts each pass over both its kernels,
# ``fwd_launches`` and ``bwd_launches`` each kernel; set them to 0 together.
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
fwd_launches = {"flash_fwd_wgmma": 0, "flash_fwd_fma": 0}
bwd_launches = {"flash_bwd_dq_wgmma": 0, "flash_bwd_dq_fma": 0,
                "flash_bwd_dkv_wgmma": 0, "flash_bwd_dkv_fma": 0}


def _route(dtype) -> str:
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def forward_kernel_for(dtype) -> str:
    """The forward kernel that takes ``dtype``: ``flash_fwd_wgmma`` for
    bfloat16, ``flash_fwd_fma`` for float32."""
    return f"flash_fwd_{_route(dtype)}"


def backward_kernel_for(dtype) -> tuple[str, str]:
    """The (dQ, dK/dV) kernels that take ``dtype``: ``flash_bwd_dq_wgmma``
    and ``flash_bwd_dkv_wgmma`` for bfloat16, ``flash_bwd_dq_fma`` and
    ``flash_bwd_dkv_fma`` for float32."""
    return f"flash_bwd_dq_{_route(dtype)}", f"flash_bwd_dkv_{_route(dtype)}"


def to_bh(x):
    """``[B, S, H, D]`` -> ``[B·H, S, D]``, contiguous: heads become rows
    of the kernels' grid."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def from_bh(x, b, h):
    """``[B·H, S, D]`` -> ``[B, S, H, D]`` (a view)."""
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).permute(0, 2, 1, 3)


def _scale(d: int) -> float:
    """``1/sqrt(d)`` as the f32 the JAX kernels multiply by."""
    return float(np.float32(1.0 / math.sqrt(d)))


def _scores(q, k, causal):
    """f32 ``[BH, S, S]`` scores, scaled after the dot, masked at -1e30."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * _scale(q.shape[-1])
    if causal:
        n = q.shape[1]
        keep = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    return s


def _delta(dout, out):
    """``rowsum(dout · out)`` in f32, ``[BH, S]``."""
    return (dout.float() * out.float()).sum(-1)


def flash_forward_plain(q, k, v, causal, out_dtype=None):
    """The forward in plain PyTorch, ``[BH, S, D]`` -> ``(out, lse)``:
    the Pallas kernel's arithmetic with the whole key range as one tile."""
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    out = (acc / l).to(out_dtype or q.dtype)
    return out, (m + torch.log(l))[..., 0]


def _dq_plain(q, k, v, lse, dout, delta, causal):
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", dout.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(), k.float())
    return (_scale(q.shape[-1]) * dq).to(q.dtype)


def _dkv_plain(q, k, v, lse, dout, delta, causal):
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dv = torch.einsum("bqk,bqd->bkd", p.to(dout.dtype).float(), dout.float())
    dp = torch.einsum("bqd,bkd->bqk", dout.float(), v.float())
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), q.float())
    return (_scale(q.shape[-1]) * dk).to(k.dtype), dv.to(v.dtype)


def flash_backward_plain(q, k, v, out, lse, dout, causal, delta=None):
    """The backward in plain PyTorch (formulas, not autograd) ->
    ``(dq, dk, dv)`` in the inputs' dtypes."""
    if delta is None:
        delta = _delta(dout, out)
    dk, dv = _dkv_plain(q, k, v, lse, dout, delta, causal)
    return _dq_plain(q, k, v, lse, dout, delta, causal), dk, dv


def check_kernel_shape(q, *others) -> None:
    """The CUDA kernels' rule: ``[BH, S, D]`` operands of one shape (f32
    or bf16, one dtype) on one device, D in ``KERNEL_HEAD_DIMS``."""
    if q.dim() != 3:
        raise ValueError(f"flash kernels take [BH, S, D] operands, got {tuple(q.shape)}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash kernels take head_dim in {KERNEL_HEAD_DIMS}, got {q.shape[-1]}"
        )
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernels take float32 or bfloat16, got {q.dtype}")
    for t in others:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"flash operands must share shape, dtype and device: {tuple(q.shape)} "
                f"{q.dtype} {q.device} vs {tuple(t.shape)} {t.dtype} {t.device}"
            )


def _rows(t, q):
    """An f32 ``[BH, S]`` row vector (lse or delta) checked against q."""
    if tuple(t.shape) != tuple(q.shape[:2]) or t.dtype != torch.float32 or t.device != q.device:
        raise ValueError(
            f"lse/delta must be float32 {tuple(q.shape[:2])} on {q.device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    return t.contiguous()


def _aligned(t):
    """``t``, copied when its data does not start on a 16-byte boundary
    (TMA, and the f32 backward's 16-byte cp.async, read from one)."""
    return t.clone() if t.data_ptr() % 16 else t


def _launch(name, *args, q, causal):
    """Launch kernel ``name`` on ``args`` (its operands' data pointers and flags)
    for ``[BH, S, D]`` operands shaped like ``q``; raises when it is refused."""
    bh, s, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = getattr(_build.load("flash_attention", _LAUNCHERS), name)(
        d, *args, bh, s, int(causal), _scale(d), stream)
    _build.check("flash_attention", rc, name)


def _launch_fwd(q, k, v, causal, out_dtype):
    check_kernel_shape(q, k, v)
    if out_dtype not in (None, q.dtype, torch.float32):
        raise ValueError(f"flash forward writes q's dtype or float32, not {out_dtype}")
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    out = torch.empty(q.shape, dtype=out_dtype or q.dtype, device=q.device)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    name = forward_kernel_for(q.dtype)
    _launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            int(out.dtype == torch.float32), q=q, causal=causal)
    launches["flash_fwd"] += 1
    fwd_launches[name] += 1
    return out, lse


def _bwd_operands(q, k, v, lse, dout, delta):
    """(q, k, v, dout, lse, delta) as the backward kernels take them:
    contiguous, 16-byte aligned, lse and delta checked."""
    check_kernel_shape(q, k, v, dout)
    q, k, v, dout = (_aligned(t.contiguous()) for t in (q, k, v, dout))
    return q, k, v, dout, _rows(lse, q), _rows(delta, q)


def _launch_dq(q, k, v, lse, dout, delta, causal):
    ops = _bwd_operands(q, k, v, lse, dout, delta)  # alive until the launch is queued
    dq = torch.empty_like(ops[0])
    name = backward_kernel_for(dq.dtype)[0]
    _launch(name, *(t.data_ptr() for t in (*ops, dq)), q=dq, causal=causal)
    launches["flash_bwd_dq"] += 1
    bwd_launches[name] += 1
    return dq


def _launch_dkv(q, k, v, lse, dout, delta, causal):
    ops = _bwd_operands(q, k, v, lse, dout, delta)
    dk, dv = torch.empty_like(ops[0]), torch.empty_like(ops[0])
    name = backward_kernel_for(dk.dtype)[1]
    _launch(name, *(t.data_ptr() for t in (*ops, dk, dv)), q=dk, causal=causal)
    launches["flash_bwd_dkv"] += 1
    bwd_launches[name] += 1
    return dk, dv


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got {t.device}")
    return False


def _forward_bhsd(q, k, v, causal, out_dtype=None):
    """``[BH, S, D]`` forward -> ``(out, lse [BH, S] f32)``.  ``out_dtype``
    overrides the output dtype (f32 partials for a ring merge)."""
    if _on_cpu(q):
        return flash_forward_plain(q, k, v, causal, out_dtype)
    return _launch_fwd(q, k, v, causal, out_dtype)


def _dq_bhsd(q, k, v, lse, dout, delta, causal):
    if _on_cpu(q):
        return _dq_plain(q, k, v, lse, dout, delta, causal)
    return _launch_dq(q, k, v, lse, dout, delta, causal)


def _dkv_bhsd(q, k, v, lse, dout, delta, causal):
    if _on_cpu(q):
        return _dkv_plain(q, k, v, lse, dout, delta, causal)
    return _launch_dkv(q, k, v, lse, dout, delta, causal)


def _backward_bhsd(q, k, v, out, lse, dout, causal, delta=None):
    """``[BH, S, D]`` backward -> ``(dq, dk, dv)``.  Callers that run it per
    k/v block (a ring backward) pass ``delta`` computed once."""
    if delta is None:
        delta = _delta(dout, out)
    dk, dv = _dkv_bhsd(q, k, v, lse, dout, delta, causal)
    return _dq_bhsd(q, k, v, lse, dout, delta, causal), dk, dv


class FlashCore(torch.autograd.Function):
    """Flash attention on ``[BH, S, D]`` with the kernels' backward; saves
    ``q, k, v, out, lse`` for it."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward_bhsd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        want_q, want_k, want_v = ctx.needs_input_grad[:3]
        dout = dout.contiguous()
        delta = _delta(dout, out)
        dq = _dq_bhsd(q, k, v, lse, dout, delta, ctx.causal) if want_q else None
        dk = dv = None
        if want_k or want_v:
            dk, dv = _dkv_bhsd(q, k, v, lse, dout, delta, ctx.causal)
        return dq, (dk if want_k else None), (dv if want_v else None), None


def flash_attention(q, k, v, causal: bool = True, block_q: int | None = None,
                    block_k: int | None = None):
    """q/k/v ``[B, S, H, D]`` -> ``[B, S, H, D]``, differentiable through
    :class:`FlashCore`.  ``block_q``/``block_k``, when given, must divide S
    (the JAX package's rule, kept so both raise alike); the CUDA kernels
    choose their own tiles and take any S."""
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share [B, S, H, D]: {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if block_q is not None or block_k is not None:
        bq = min(block_q or s, s)
        bk = min(block_k or s, s)
        if s % bq or s % bk:
            raise ValueError(f"sequence {s} not divisible by blocks ({bq},{bk})")
    out = FlashCore.apply(to_bh(q), to_bh(k), to_bh(v), causal)
    return from_bh(out, b, h)
