"""int4 dequant-dot: ``x [..., K] @ W`` for a packed int4 weight
(``k8s_dra_driver_tpu/ops/int4_matmul.py``).

``int4_matmul`` launches one of two hand-written Hopper kernels
(``csrc/int4_matmul.cu``, whose header says what bounds each and how) for
CUDA tensors and runs :func:`int4_matmul_plain` for CPU tensors.  Which
kernel runs is a static rule on the rows M and x's dtype
(:func:`kernel_for`): the split-K GEMV ``int4_splitk`` for float32 at every M
and for bfloat16 at M <= ``DECODE_MAX_M`` (decode), the tensor-core GEMM
``int4_wgmma`` for bfloat16 at larger M (prefill).  float32 never goes
through the tensor cores: they would run it as TF32.  On CUDA a shape the
kernels do not take raises; there is no quiet fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from k8s_dra_driver_torch.ops import _build

KERNEL_GROUP_SIZE = 64
KERNEL_TILE_N = 64
DECODE_MAX_M = 16      # bf16 rows up to which the split-K kernel runs
SPLITK_ROWS = 8         # x rows per split-K block
SPLITK_TILE_N = 128     # columns per split-K block
WGMMA_MAX_TILES = 4     # m64 tiles per wgmma block
MAX_SPLITS = 8          # blocks of one output tile: one portable cluster
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VOID, _INT = ctypes.c_void_p, ctypes.c_int
_LAUNCHERS = {
    # (dtype, x, packed, scale, out, M, K, N, group_size, G, splits, stream)
    "int4_splitk": [_INT] + [_VOID] * 4 + [_INT] * 6 + [_VOID],
    # (x, packed, scale, out, M, K, N, group_size, G, splits, mt, stream)
    "int4_wgmma": [_VOID] * 4 + [_INT] * 7 + [_VOID],
}

# Kernel launches since the counts were last set to 0 (the plain version
# does not count): ``launches`` counts both kernels, ``kernel_launches``
# each one.  Set both to 0 together.
launches = 0
kernel_launches = {"int4_splitk": 0, "int4_wgmma": 0}


def launch_counts() -> dict:
    """Every counter of this module, ``{"launches": n, kernel name: n}``
    (read by the CUDA-graph holder, ``models/graphs.GraphedProgram``)."""
    return {"launches": launches, **kernel_launches}


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` (keys as :func:`launch_counts` gives them) to the
    counters: a graph replay counts the launches its capture recorded."""
    global launches
    launches += delta.get("launches", 0)
    for name in kernel_launches:
        kernel_launches[name] += delta.get(name, 0)


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


def kernel_for(m: int, dtype) -> str:
    """The kernel that takes ``m`` rows of ``dtype``: ``int4_splitk`` for
    float32 at every M and bfloat16 at M <= ``DECODE_MAX_M``, else
    ``int4_wgmma``."""
    if dtype == torch.float32 or m <= DECODE_MAX_M:
        return "int4_splitk"
    return "int4_wgmma"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def splitk_plan(m: int, k: int, n: int, sms: int) -> tuple[int, int]:
    """(groups per block, splits) of the split-K kernel: the most splits,
    up to ``MAX_SPLITS`` (the blocks of one output tile form a thread-block
    cluster), whose grid fits in three quarters of two blocks per SM, so
    that every cluster finds room in one GPC in the first wave (a grid that
    fills every SM starts its last clusters a wave later)."""
    groups = k // KERNEL_GROUP_SIZE
    tiles = _cdiv(n, SPLITK_TILE_N) * _cdiv(m, SPLITK_ROWS)
    g = _cdiv(groups, max(1, min(MAX_SPLITS, groups, 3 * sms // 2 // tiles)))
    return g, _cdiv(groups, g)


def wgmma_plan(m: int, k: int, n: int, sms: int) -> tuple[int, int, int]:
    """(groups per block, splits, m64 tiles per block) of the wgmma
    kernel: up to 256 rows a block, K split while the grid stays within a
    block per SM, at most ``MAX_SPLITS`` splits (the blocks of one output
    tile form a thread-block cluster)."""
    groups = k // KERNEL_GROUP_SIZE
    mt = min(WGMMA_MAX_TILES, _cdiv(m, 64))
    fit = sms // ((n // KERNEL_TILE_N) * _cdiv(m, 64 * mt))
    g = _cdiv(groups, max(1, min(MAX_SPLITS, fit, groups)))
    return g, _cdiv(groups, g), mt


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    if x2.data_ptr() % 16:  # TMA and vector loads read x from 16-byte boundaries
        x2 = x2.clone()
    name = kernel_for(m, x2.dtype)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    lib = _build.load("int4_matmul", _LAUNCHERS)
    if name == "int4_splitk":
        g, splits = splitk_plan(m, k, n, _sm_count(x2.device.index))
        rc = lib.int4_splitk(_DTYPE_CODES[x2.dtype], x2.data_ptr(), packed.data_ptr(),
                             scale.data_ptr(), out.data_ptr(), m, k, n, group_size, g, splits,
                             stream)
    else:
        g, splits, mt = wgmma_plan(m, k, n, _sm_count(x2.device.index))
        rc = lib.int4_wgmma(x2.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
                            m, k, n, group_size, g, splits, mt, stream)
    _build.check("int4_matmul", rc, name)
    launches += 1
    kernel_launches[name] += 1
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
