"""int4 dequant-dot: ``x [..., K] @ W`` for a packed int4 weight
(``k8s_dra_driver_tpu/ops/int4_matmul.py``).

``int4_matmul`` launches the hand-written Hopper kernel
(``csrc/int4_matmul.cu``, whose header says what bounds it and how) for
CUDA tensors and runs :func:`int4_matmul_plain` for CPU tensors.  On CUDA
a shape the kernel does not take raises; there is no quiet fallback.
"""

from __future__ import annotations

import ctypes

import torch

from k8s_dra_driver_torch.ops import _build

KERNEL_GROUP_SIZE = 64
KERNEL_TILE_N = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# int4_matmul(dtype, x, packed, scale, out, M, K, N, group_size, stream)
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

# Kernel launches since the count was last set to 0 (the plain version
# does not count).
launches = 0


def dequant_int4(packed, scale, group_size: int, dtype) -> torch.Tensor:
    """``packed [K/2, N]`` uint8 + ``scale [K/gs, N]`` f32 -> ``[K, N]`` in
    ``dtype``: unpack the half-split nibbles, scale in f32, round once."""
    n_in, n_out = packed.shape[0] * 2, packed.shape[1]
    half = group_size // 2
    p = packed.reshape(n_in // group_size, half, n_out)
    low = (p & 0xF).to(torch.int8) - 8
    high = (p >> 4).to(torch.int8) - 8
    q = torch.cat([low, high], dim=1)                   # [groups, gs, out]
    w = q.float() * scale[:, None]
    return w.reshape(n_in, n_out).to(dtype)


def int4_matmul_plain(x, packed, scale, group_size: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: weights rounded to x's
    dtype, products and sums in f32, result in x's dtype."""
    w = dequant_int4(packed, scale, group_size, x.dtype)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def check_kernel_shape(k: int, n: int, group_size: int) -> None:
    """The CUDA kernel's shape rule."""
    if group_size != KERNEL_GROUP_SIZE or k % KERNEL_GROUP_SIZE or n % KERNEL_TILE_N:
        raise ValueError(
            f"int4 kernel takes group_size {KERNEL_GROUP_SIZE}, K % "
            f"{KERNEL_GROUP_SIZE} == 0 and N % {KERNEL_TILE_N} == 0; got "
            f"K={k} N={n} group_size={group_size}"
        )


def _launch(x2, packed, scale, group_size: int) -> torch.Tensor:
    global launches
    m, k = x2.shape
    n = packed.shape[1]
    check_kernel_shape(k, n, group_size)
    if x2.dtype not in _DTYPE_CODES:
        raise ValueError(f"int4 kernel takes float32 or bfloat16 x, got {x2.dtype}")
    if packed.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise ValueError("int4 kernel takes uint8 packed weights and float32 scales")
    if packed.shape[0] * 2 != k or tuple(scale.shape) != (k // group_size, n):
        raise ValueError(
            f"int4 operand shapes disagree: x K={k}, packed {tuple(packed.shape)}, "
            f"scale {tuple(scale.shape)}"
        )
    for t in (packed, scale):
        if t.device != x2.device or not t.is_contiguous():
            raise ValueError("int4 kernel operands must be contiguous on x's device")
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    rc = _build.load("int4_matmul", _ARGTYPES).int4_matmul(
        _DTYPE_CODES[x2.dtype], x2.data_ptr(), packed.data_ptr(), scale.data_ptr(),
        out.data_ptr(), m, k, n, group_size,
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    _build.check("int4_matmul", rc)
    launches += 1
    return out


def int4_matmul(x, packed, scale, group_size: int) -> torch.Tensor:
    """``x [..., K] @ dequant(packed, scale)`` -> ``[..., N]`` in x's dtype:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scale, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul runs on cuda or cpu tensors, got {x.device}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    return _launch(x2, packed, scale, group_size).reshape(*lead, packed.shape[1])
