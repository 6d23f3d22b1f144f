"""Weight-only quantization for serving (``k8s_dra_driver_tpu/models/quant.py``).

int8: symmetric per-output-column scale.  int4: symmetric per-(group,
column) scale, two nibbles per byte along the INPUT axis, half-split per
group (byte ``i`` of a group holds row ``i`` in its low nibble and row
``i + gs/2`` in its high nibble, both biased by +8).  Bytes and dequantized
values are identical to the reference's.

``matmul_last`` is the one weight-consuming product.  On a CUDA tensor an
int4 matrix goes through the hand-written dequant-dot kernel
(``ops/int4_matmul.py``); on a CPU tensor through its plain version.

KV-block quantization (:func:`quantize_kv_blocks`) stores a paged pool's
blocks as int8 or packed int4 with one f32 scale per ``[hd, bs]`` block
stripe (per layer, block and KV head); int4 packs two positions per byte
along the lane axis, half-split like the weights.  Plain PyTorch: the
reference quantizes and dequantizes pools in XLA, outside any kernel.
"""

from __future__ import annotations

import torch

from k8s_dra_driver_torch.ops import int4_matmul as _i4


class QuantizedMatrix:
    """int8 weight ``q [in, out]`` + per-column f32 ``scale [out]``."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16):
        self.q = q
        self.scale = scale
        self.dtype = dtype

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def ndim(self):
        return self.q.ndim

    @classmethod
    def quantize(cls, w: torch.Tensor, dtype=None) -> "QuantizedMatrix":
        dtype = dtype or w.dtype
        w32 = w.float()
        scale = w32.abs().amax(dim=0) / 127.0
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
        return cls(q, scale, dtype)

    def dequant(self) -> torch.Tensor:
        return (self.q.float() * self.scale).to(self.dtype)


class Quantized4Matrix:
    """Packed int4 weight ``packed [in/2, out]`` uint8 (per-group
    half-split) + group-wise f32 ``scale [in/group_size, out]``."""

    def __init__(self, packed: torch.Tensor, scale: torch.Tensor,
                 group_size: int, dtype=torch.bfloat16):
        self.packed = packed
        self.scale = scale
        self.group_size = group_size
        self.dtype = dtype

    @property
    def shape(self):
        return (self.packed.shape[0] * 2, self.packed.shape[1])

    @property
    def ndim(self):
        return 2

    @classmethod
    def quantize(cls, w: torch.Tensor, group_size: int = 64, dtype=None):
        dtype = dtype or w.dtype
        n_in, n_out = w.shape
        group_size = min(group_size, n_in)
        if n_in % group_size or group_size % 2:
            raise ValueError(
                f"in dim {n_in} must be divisible by an even group "
                f"{group_size} (per-group half-split packing)"
            )
        w32 = w.float().reshape(n_in // group_size, group_size, n_out)
        scale = w32.abs().amax(dim=1) / 7.0                     # [groups, out]
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        q = torch.clamp(torch.round(w32 / scale[:, None]), -8, 7).to(torch.int8)
        biased = (q + 8).to(torch.uint8)                        # [groups, gs, out]
        half = group_size // 2
        packed = (biased[:, :half] | (biased[:, half:] << 4)).reshape(n_in // 2, n_out)
        return cls(packed.contiguous(), scale.contiguous(), group_size, dtype)

    def dequant(self) -> torch.Tensor:
        return _i4.dequant_int4(self.packed, self.scale, self.group_size, self.dtype)


_QUANTIZED = (QuantizedMatrix, Quantized4Matrix)


def pack_int4(q: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Pack int8 values in [-8, 7] two per byte along ``dim`` (even size),
    half-split: byte ``i`` holds element ``i`` (low nibble) and element
    ``i + n/2`` (high), both biased by +8."""
    n = q.shape[dim]
    if n % 2:
        raise ValueError(f"int4 pack axis must be even, got {n}")
    biased = (q + 8).to(torch.uint8)
    lo, hi = torch.split(biased, n // 2, dim=dim)
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int8 values in [-8, 7], ``dim`` doubled."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=dim)


KV_DTYPES = ("int8", "int4")


def kv_dtype_bits(kv_dtype: str) -> int:
    """Stored bits per pooled k/v element of a quantized pool mode."""
    if kv_dtype == "int8":
        return 8
    if kv_dtype == "int4":
        return 4
    raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")


def quantize_kv_blocks(x: torch.Tensor, kv_dtype: str):
    """Symmetric per-block quantization of pool stripes ``x [..., hd, bs]``
    (any float dtype): ``(q, scale)`` with ``scale`` f32 ``x.shape[:-2]``,
    ``amax / 127`` (int8) or ``amax / 7`` (int4), 1.0 for an all-zero
    block; ``q`` int8 ``[..., hd, bs]`` in [-127, 127], or for int4 values
    in [-7, 7] packed to uint8 ``[..., hd, bs // 2]``.  Rounding is half to
    even, as ``jnp.round``'s."""
    kv_dtype_bits(kv_dtype)  # validates the name
    x32 = x.float()
    amax = x32.abs().amax(dim=(-2, -1))
    top = 127.0 if kv_dtype == "int8" else 7.0
    # a tensor divisor: CUDA divides by a scalar as a multiply by its
    # reciprocal, one ulp off the CPU's (and XLA's) true division
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / torch.full_like(amax, top))
    q = torch.clamp(torch.round(x32 / scale[..., None, None]), -top, top).to(torch.int8)
    return (q if kv_dtype == "int8" else pack_int4(q)), scale


def dequant_kv_blocks(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    """The inverse of :func:`quantize_kv_blocks`: int8 ``[..., hd, bs]`` or
    packed uint8 ``[..., hd, bs // 2]`` (whose nibbles become int8 in
    :func:`unpack_int4`, before any float) with ``scale [...]`` back to
    float blocks ``[..., hd, bs]`` in ``dtype``."""
    if q.dtype == torch.uint8:
        q = unpack_int4(q)
    return (q.float() * scale[..., None, None]).to(dtype)


def mat(w):
    """Matmul operand: dequantized for quantized weights, else ``w``."""
    return w.dequant() if isinstance(w, _QUANTIZED) else w


def matmul_last(x, w):
    """``x @ w`` contracting x's last axis.  An int4 matrix takes the
    dequant-dot kernel on CUDA tensors (its plain version on CPU ones);
    everything else is one ``matmul`` on the dequantized operand."""
    if isinstance(w, Quantized4Matrix):
        return _i4.int4_matmul(x, w.packed, w.scale, w.group_size)
    return torch.matmul(x, mat(w))


_BLOCK_WEIGHT_KEYS = ("qkv", "attn_out", "mlp_up", "mlp_down")


def quantize_blocks(params: dict, bits: int = 8, group_size: int = 64) -> dict:
    """Quantize the block weight matrices (embeddings and norms stay in
    the compute dtype): ``bits`` 8 (per-column int8) or 4 (group-wise
    packed int4)."""
    if bits == 8:
        quantizer = QuantizedMatrix.quantize
    elif bits == 4:
        def quantizer(w):
            return Quantized4Matrix.quantize(w, group_size=group_size)
    else:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    out = dict(params)
    out["blocks"] = [
        {k: (quantizer(v) if k in _BLOCK_WEIGHT_KEYS else v) for k, v in blk.items()}
        for blk in params["blocks"]
    ]
    return out


def quantized_bytes(params: dict) -> tuple[int, int]:
    """(bytes as stored, bytes if every weight were bf16)."""
    stored = bf16 = 0

    def visit(leaf):
        nonlocal stored, bf16
        if isinstance(leaf, QuantizedMatrix):
            stored += leaf.q.numel() + leaf.scale.numel() * 4
            bf16 += leaf.shape[0] * leaf.shape[1] * 2
        elif isinstance(leaf, Quantized4Matrix):
            stored += leaf.packed.numel() + leaf.scale.numel() * 4
            bf16 += leaf.shape[0] * leaf.shape[1] * 2
        else:
            stored += leaf.numel() * leaf.element_size()
            bf16 += leaf.numel() * 2

    for k, v in params.items():
        if k == "blocks":
            for blk in v:
                for leaf in blk.values():
                    visit(leaf)
        else:
            visit(v)
    return stored, bf16
