"""The burn-in transformer (``k8s_dra_driver_tpu/models/burnin.py``) in
PyTorch: config, parameter init and the forward pass.

Parameters are a plain dict of tensors with the JAX package's keys and
shapes (``embed``, ``ln_f``, ``blocks[i]`` with ``ln1``/``qkv``/
``attn_out``/``ln2``/``mlp_up``/``mlp_down``; ``pos_embed`` without RoPE),
so a checkpoint moves between the two packages key for key
(``models/weights.params_from_jax``).  Weight matrices are ``[in, out]``
and every weight-consuming product goes through ``quant.matmul_last``.

Numerics follow the reference's cast order: RMS-norm variance in f32 with
``rsqrt`` cast back to the activation dtype before the multiply; RoPE
angles in f32, half-split (NeoX) pairs; tanh-approximated GELU (JAX's
default); tied logits contracted in the parameter dtype and cast to f32
afterwards; masked attention scores are ``-1e30``.  Mixture-of-experts
blocks are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import numpy as np
import torch
import torch.nn.functional as F

from k8s_dra_driver_torch.models.quant import matmul_last as _mm

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a dtype-like
    object with a numpy name (the JAX package's ``jnp.bfloat16`` and
    ``jnp.float32`` are such objects)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None)
    if name is None:
        name = np.dtype(dtype).name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}") from None


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 512
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 512
    max_seq: int = 256
    dtype: torch.dtype = torch.bfloat16
    n_kv_heads: int | None = None
    rope: bool = False
    rope_base: float = 10000.0
    n_experts: int = 0
    moe_top_k: int = 2

    def __post_init__(self):
        if self.n_kv_heads is not None and (
            self.n_kv_heads < 1 or self.n_heads % self.n_kv_heads
        ):
            raise ValueError(
                f"n_kv_heads ({self.n_kv_heads}) must divide n_heads ({self.n_heads})"
            )
        if self.rope and self.head_dim % 2:
            raise ValueError(
                f"rope needs an even head_dim, got {self.head_dim} "
                f"(d_model {self.d_model} / n_heads {self.n_heads})"
            )
        if self.n_experts:
            raise NotImplementedError(
                "mixture-of-experts blocks are not ported yet (n_experts must be 0)"
            )

    @classmethod
    def from_reference(cls, ref) -> "ModelConfig":
        """The port's config from the JAX package's ``ModelConfig`` (or any
        object with the same fields), read by attribute; its jnp ``dtype``
        maps to the torch dtype of the same name."""
        kw = {f.name: getattr(ref, f.name) for f in fields(cls)}
        kw["dtype"] = torch_dtype(kw["dtype"])
        return cls(**kw)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def kv_groups(self) -> int:
        return self.n_heads // self.kv_heads


FLAGSHIP_MODERN = ModelConfig(
    vocab_size=32768, d_model=1024, n_heads=16, n_kv_heads=4, n_layers=8,
    d_ff=4096, max_seq=1024, rope=True,
)
TINY = ModelConfig()


def block_matrix_shapes(cfg: ModelConfig) -> dict:
    """The ``[in, out]`` shapes of a block's weight matrices (the
    reference's single source of truth, ``burnin.block_matrix_shapes``)."""
    return {
        "qkv": (cfg.d_model, (cfg.n_heads + 2 * cfg.kv_heads) * cfg.head_dim),
        "attn_out": (cfg.d_model, cfg.d_model),
        "mlp_up": (cfg.d_model, cfg.d_ff),
        "mlp_down": (cfg.d_ff, cfg.d_model),
    }


def init_params(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters (normal, scaled by ``d_model**-0.5``; norm gains
    one) on ``generator``'s device, drawn in the reference's order.  The
    numbers differ from ``jax.random``'s: parity tests build their weights
    with numpy and load them through ``params_from_jax`` instead."""
    device = generator.device
    scale = cfg.d_model**-0.5
    shapes = block_matrix_shapes(cfg)

    def dense(shape):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * scale).to(cfg.dtype)

    def ones(n):
        return torch.ones((n,), dtype=cfg.dtype, device=device)

    params = {"embed": dense((cfg.vocab_size, cfg.d_model))}
    if not cfg.rope:
        params["pos_embed"] = dense((cfg.max_seq, cfg.d_model))
    params["ln_f"] = ones(cfg.d_model)
    params["blocks"] = []
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "ln1": ones(cfg.d_model),
            "qkv": dense(shapes["qkv"]),
            "attn_out": dense(shapes["attn_out"]),
            "ln2": ones(cfg.d_model),
            "mlp_up": dense(shapes["mlp_up"]),
            "mlp_down": dense(shapes["mlp_down"]),
        })
    return params


def _rms_norm(x, gamma):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * gamma


def rope_rotate(x, positions, cfg: ModelConfig):
    """Rotate ``[..., S, H, hd]`` by ``positions`` (``[S]`` or ``[B, S]``)
    in half-split pairs: feature i rotates with feature i + hd/2.  Angles
    in f32, output in x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) * 2.0 / hd
    freqs = torch.pow(torch.tensor(cfg.rope_base, dtype=torch.float32, device=x.device), exponent)
    angles = positions.float()[..., None] * freqs       # [..., S, half]
    cos = torch.cos(angles)[..., None, :]               # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def qkv_proj(x, p, cfg: ModelConfig, positions=None):
    """ln1 + fused QKV projection -> q ``[B, S, H, hd]``, k/v
    ``[B, S, Hkv, hd]``; with RoPE, q and k rotate by absolute position
    (default ``arange(S)``) before any cache write."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    y = _rms_norm(x, p["ln1"])
    qkv = _mm(y, p["qkv"])
    q, k, v = torch.split(qkv, [h * hd, hkv * hd, hkv * hd], dim=-1)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.rope:
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=x.device)
        q = rope_rotate(q, positions, cfg)
        k = rope_rotate(k, positions, cfg)
    return q, k, v


def repeat_kv(kv, cfg: ModelConfig):
    """Widen ``[B, S, Hkv, hd]`` to ``[B, S, H, hd]`` (one KV head per
    query head) for the plain training-style attention."""
    if cfg.kv_groups == 1:
        return kv
    return torch.repeat_interleave(kv, cfg.kv_groups, dim=2)


def mlp_residual(x, p):
    """ln2 + dense tanh-GELU MLP with residual."""
    y = _rms_norm(x, p["ln2"])
    h = F.gelu(_mm(y, p["mlp_up"]), approximate="tanh")
    return x + _mm(h, p["mlp_down"])


def tied_logits(x, params):
    """Final norm + tied-embedding head: contracted in the parameter
    dtype, cast to f32 afterwards."""
    x = _rms_norm(x, params["ln_f"])
    return torch.matmul(x, params["embed"].t()).float()


def reference_attention(q, k, v, causal: bool = True):
    """Plain full attention ``[B, S, H, D]`` (the reference's
    ``ops/ring_attention.reference_attention``): scores in the input dtype
    cast to f32, ``-1e30`` causal mask, probabilities cast back."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
    if causal:
        mask = torch.tril(torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool, device=q.device))
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """tokens ``[B, S]`` int -> logits ``[B, S, V]`` f32."""
    b, s = tokens.shape
    x = params["embed"][tokens]
    if not cfg.rope:
        x = x + params["pos_embed"][:s]
    for p in params["blocks"]:
        q, k, v = qkv_proj(x, p, cfg)
        attn = reference_attention(q, repeat_kv(k, cfg), repeat_kv(v, cfg))
        x = x + _mm(attn.reshape(b, s, cfg.d_model), p["attn_out"])
        x = mlp_residual(x, p)
    return tied_logits(x, params)
