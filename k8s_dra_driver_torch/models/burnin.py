"""The burn-in transformer (``k8s_dra_driver_tpu/models/burnin.py``) in
PyTorch: config, parameter init and the forward pass.

Parameters are a plain dict of tensors with the JAX package's keys and
shapes (``embed``, ``ln_f``, ``blocks[i]`` with ``ln1``/``qkv``/
``attn_out``/``ln2``/``mlp_up``/``mlp_down``, or under mixture-of-experts
``router``/``expert_up``/``expert_down`` in place of the MLP pair;
``pos_embed`` without RoPE), so a checkpoint moves between the two
packages key for key
(``models/weights.params_from_jax``).  Weight matrices are ``[in, out]``
and every weight-consuming product goes through ``quant.matmul_last``.

Numerics follow the reference's cast order: RMS-norm variance in f32 with
``rsqrt`` cast back to the activation dtype before the multiply; RoPE
angles in f32, half-split (NeoX) pairs; tanh-approximated GELU (JAX's
default); tied logits contracted in the parameter dtype and cast to f32
afterwards; masked attention scores are ``-1e30``.  A mixture-of-experts
block (``n_experts > 0``, the Mixtral shape) routes each token to its
``moe_top_k`` best experts from f32 router scores and runs every expert on
every token (:func:`_moe_mlp`, the reference's shape-static choice), so no
shape depends on the data.

The training half is the single-device branch of the reference's
``build_train_step``: ``forward`` with the reference's rematerialization
policies (``torch.utils.checkpoint``; ``"dots"`` through a selective
checkpoint policy), ``loss_fn``, ``make_optimizer`` (optax's ``adamw`` and
``clip_by_global_norm``, written out, its count, schedule and bias
corrections on the device) and ``make_sgd_step`` (gradient accumulation
with the interleaved microbatch split).  The step updates params and
optimizer state IN PLACE (the reference's step is pure and donates its
buffers instead) and, on the card, replays as one CUDA graph
(:class:`GraphedTrainStep`, the reference's ``jax.jit``).  Adapter-only
training is ``models/lora.build_lora_train_step`` over the same step,
with optax's ``adam`` (:class:`Adam`).  MoE models train like dense ones.
On a mesh (``build_train_step(mesh=...)``) each rank runs its shard of the
step, one CUDA graph on NCCL and eagerly on gloo (``models/mesh_train``);
:func:`param_pspecs` is the
reference's Megatron layout, and :func:`mlp_residual` takes the ``model``
axis's group for it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass, fields

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from k8s_dra_driver_torch.device import params_device, resolve_device
from k8s_dra_driver_torch.models.data import RowBlock
from k8s_dra_driver_torch.models.graphs import GraphedProgram, cuda_capture, graphs_enabled
from k8s_dra_driver_torch.models.quant import matmul_last as _mm
from k8s_dra_driver_torch.ops import collectives
from k8s_dra_driver_torch.ops.ring_attention import reference_attention

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, its name, a numpy dtype or a
    dtype-like object with a numpy name (the JAX package's ``jnp.bfloat16`` and
    ``jnp.float32`` are such objects)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype
    else:
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
            if self.n_experts < 2:
                raise ValueError(f"n_experts ({self.n_experts}) must be >= 2 (0 = dense)")
            if not 1 <= self.moe_top_k <= self.n_experts:
                raise ValueError(
                    f"moe_top_k ({self.moe_top_k}) must be in [1, n_experts={self.n_experts}]"
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


# the reference's classic flagship: MHA with learned positions
FLAGSHIP = ModelConfig(
    vocab_size=32768, d_model=1024, n_heads=16, n_layers=8, d_ff=4096, max_seq=1024
)
# the serving-era variant: 4 KV heads (GQA) and rotary positions
FLAGSHIP_MODERN = ModelConfig(
    vocab_size=32768, d_model=1024, n_heads=16, n_kv_heads=4, n_layers=8,
    d_ff=4096, max_seq=1024, rope=True,
)
TINY = ModelConfig()


def block_matrix_shapes(cfg: ModelConfig) -> dict:
    """The ``[in, out]`` shapes of a block's 2-D weight matrices (the
    reference's single source of truth, ``burnin.block_matrix_shapes``).
    Under MoE the dense MLP pair gives way to the 3-D expert stacks, so
    adapters and quantization target the attention matrices only."""
    shapes = {
        "qkv": (cfg.d_model, (cfg.n_heads + 2 * cfg.kv_heads) * cfg.head_dim),
        "attn_out": (cfg.d_model, cfg.d_model),
    }
    if not cfg.n_experts:
        shapes["mlp_up"] = (cfg.d_model, cfg.d_ff)
        shapes["mlp_down"] = (cfg.d_ff, cfg.d_model)
    return shapes


def init_params(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters (normal, scaled by ``d_model**-0.5``; norm gains
    one) on ``generator``'s device, drawn in the reference's order; an MoE
    block's router ``[d, E]`` stays f32 (routing compares scores), its
    expert stacks ``[E, d, F]`` and ``[E, F, d]`` take the model dtype.
    The numbers differ from ``jax.random``'s: parity tests build their
    weights with numpy and load them through ``params_from_jax`` instead."""
    device = generator.device
    scale = cfg.d_model**-0.5
    shapes = block_matrix_shapes(cfg)

    def dense(shape, dtype=cfg.dtype):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * scale).to(dtype)

    def ones(n):
        return torch.ones((n,), dtype=cfg.dtype, device=device)

    params = {"embed": dense((cfg.vocab_size, cfg.d_model))}
    if not cfg.rope:
        params["pos_embed"] = dense((cfg.max_seq, cfg.d_model))
    params["ln_f"] = ones(cfg.d_model)
    params["blocks"] = []
    for _ in range(cfg.n_layers):
        block = {
            "ln1": ones(cfg.d_model),
            "qkv": dense(shapes["qkv"]),
            "attn_out": dense(shapes["attn_out"]),
            "ln2": ones(cfg.d_model),
        }
        if cfg.n_experts:
            e = cfg.n_experts
            block["router"] = dense((cfg.d_model, e), torch.float32)
            block["expert_up"] = dense((e, cfg.d_model, cfg.d_ff))
            block["expert_down"] = dense((e, cfg.d_ff, cfg.d_model))
        else:
            block["mlp_up"] = dense(shapes["mlp_up"])
            block["mlp_down"] = dense(shapes["mlp_down"])
        params["blocks"].append(block)
    return params


def param_pspecs(cfg: ModelConfig) -> dict:
    """The reference's Megatron layout over the ``model`` axis, a tree like
    the params of :class:`~k8s_dra_driver_torch.parallel.mesh.PartitionSpec`:
    ``qkv``, ``mlp_up`` and ``expert_up`` column-parallel, ``attn_out``,
    ``mlp_down`` and ``expert_down`` row-parallel (a psum after), the
    embedding vocab-sharded, norms and the MoE router replicated.  A column
    shard of ``qkv`` holds whole KV groups where the groups divide over
    ``model`` (``weights.shard_params`` reorders its columns group-major
    first)."""
    from k8s_dra_driver_torch.parallel.mesh import P

    block = {"ln1": P(), "qkv": P(None, "model"), "attn_out": P("model", None), "ln2": P()}
    if cfg.n_experts:
        block["router"] = P()
        block["expert_up"] = P(None, None, "model")
        block["expert_down"] = P(None, "model", None)
    else:
        block["mlp_up"] = P(None, "model")
        block["mlp_down"] = P("model", None)
    out = {
        "embed": P("model", None),
        "ln_f": P(),
        "blocks": [dict(block) for _ in range(cfg.n_layers)],
    }
    if not cfg.rope:
        out["pos_embed"] = P()
    return out


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
    # the base filled on the device, not copied from the host (capturable)
    base = torch.full((), cfg.rope_base, dtype=torch.float32, device=x.device)
    freqs = torch.pow(base, exponent)
    angles = positions.float()[..., None] * freqs       # [..., S, half]
    cos = torch.cos(angles)[..., None, :]               # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def qkv_proj(x, p, cfg: ModelConfig, positions=None, delta=None):
    """ln1 + fused QKV projection -> q ``[B, S, H, hd]``, k/v
    ``[B, S, Hkv, hd]``; with RoPE, q and k rotate by absolute position
    (default ``arange(S)``) before any cache write.  ``delta(name, y)``:
    an additive update of the projection from the same normalized input,
    how per-request LoRA applies in serving (``lora.adapter_delta``)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    y = _rms_norm(x, p["ln1"])
    qkv = _mm(y, p["qkv"])
    if delta is not None:
        qkv = qkv + delta("qkv", y)
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


def top_k_experts(scores, k: int):
    """The ``k`` best experts of each row of f32 ``scores [T, E]``, as
    ``jax.lax.top_k`` picks them: highest first, the lower index first on
    equal scores, and -0.0 below +0.0 (XLA's total order).  ``torch.topk``
    promises no order on ties, so this is a stable descending sort of the
    scores' order-preserving int32 keys, cut to ``k``.  Returns ``(values,
    indices)``, each ``[T, k]``."""
    bits = scores.contiguous().view(torch.int32)
    keys = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # IEEE total order as signed ints
    idx = torch.sort(keys, dim=-1, descending=True, stable=True).indices[:, :k]
    return scores.gather(-1, idx), idx


def _moe_mlp(y, p, top_k: int, group=None):
    """Top-k expert MLP over normalized tokens ``y [..., d]`` (the
    reference's ``_moe_mlp``): f32 router scores, the top ``top_k``
    (:func:`top_k_experts`), a softmax over the selected scores, and the
    experts' tanh-GELU MLPs combined by those gates.  Every expert runs on
    every token and the gates zero out the rest: no shape depends on the
    routing, so the serving programs still capture as CUDA graphs.  The
    combine weights are f32 cast to the experts' dtype before the last
    product, the expert products in the parameter dtype.  The up product
    broadcasts the tokens over the expert stack (a ``bmm`` whose first
    operand has batch stride 0: no batch dim in the reference's sense, so
    the ``"dots"`` policy saves it), the down product is batched over the
    experts.  ``group``: the ``model`` axis's group when the stacks hold
    this rank's FF columns (``param_pspecs``); the output is then this
    rank's partial sum, and the tokens and the combine weights enter
    through ``collectives.pvary`` so their gradients sum over the group."""
    *lead, d = y.shape
    t = y.reshape(-1, d)
    n_experts = p["router"].shape[1]
    scores = t.float() @ p["router"]                                   # [T, E] f32
    top_vals, top_idx = top_k_experts(scores, top_k)                   # [T, k]
    gates = torch.softmax(top_vals, dim=-1)
    onehot = F.one_hot(top_idx, n_experts).float()                     # [T, k, E]
    combine = torch.einsum("tk,tke->te", gates, onehot)                # [T, E] f32
    # the tokens broadcast over the stack: ``matmul`` would fold the
    # product into one ``mm`` over a transposed copy of the expert weights
    t = collectives.pvary(t, group)
    up = torch.bmm(t.expand(n_experts, *t.shape), p["expert_up"])      # [E, T, F]
    h = F.gelu(up, approximate="tanh")
    outs = torch.bmm(h, p["expert_down"])                              # [E, T, d]
    combine = collectives.pvary(combine, group)
    out = torch.einsum("te,etd->td", combine.to(outs.dtype), outs)
    return out.reshape(*lead, d)


def mlp_residual(x, p, delta=None, top_k: int | None = None, group=None):
    """ln2 + MLP with residual: the dense tanh-GELU MLP, or the top-k
    expert mixture when the block carries a ``router`` (:func:`_moe_mlp`;
    ``top_k``, ``cfg.moe_top_k``, is then required, as the reference
    requires it, so a call site that forgot it raises instead of routing
    the wrong number of experts).  ``delta`` as in :func:`qkv_proj`, the
    down projection's from the post-GELU ``h``; adapters target the 2-D
    matrices only, so an MoE block takes no MLP delta.  ``group``: the
    ``model`` axis's group under tensor parallelism (column-parallel up,
    row-parallel down, a psum after; None on one device)."""
    y = _rms_norm(x, p["ln2"])
    if "router" in p:
        if top_k is None:
            raise ValueError("MoE block needs top_k (pass cfg.moe_top_k through mlp_residual)")
        return x + collectives.psum(_moe_mlp(y, p, top_k, group), group)
    h = _mm(collectives.pvary(y, group), p["mlp_up"])
    if delta is not None:
        h = h + delta("mlp_up", y)
    h = F.gelu(h, approximate="tanh")
    out = _mm(h, p["mlp_down"])
    if delta is not None:
        out = out + delta("mlp_down", h)
    return x + collectives.psum(out, group)


def tied_logits(x, params):
    """Final norm + tied-embedding head: contracted in the parameter
    dtype, cast to f32 afterwards."""
    x = _rms_norm(x, params["ln_f"])
    return torch.matmul(x, params["embed"].t()).float()


def _full_attention(q, k, v):
    return reference_attention(q, k, v, causal=True)


def _block(x, p, cfg: ModelConfig, attn_fn=_full_attention):
    b, s, d = x.shape
    q, k, v = qkv_proj(x, p, cfg)
    # GQA k/v are widened to one head per query head: every attention
    # backend sees the MHA shape
    attn = attn_fn(q, repeat_kv(k, cfg), repeat_kv(v, cfg)).reshape(b, s, d)
    x = x + _mm(attn, p["attn_out"])
    return mlp_residual(x, p, top_k=cfg.moe_top_k)


# the products without batch dims (the reference's
# ``dots_with_no_batch_dims_saveable``): ``_mm(x, W)`` and the MoE router
# reach ``aten.mm`` through ``matmul``'s fold of x's leading dims; the MoE
# up product is a ``bmm`` whose token operand broadcasts over the experts
# (batch stride 0), while its down product and the routing combines are
# batched over a real dim and recompute
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    saved = op in _SAVED_DOTS or (
        op is torch.ops.aten.bmm.default and 0 in (args[0].stride(0), args[1].stride(0))
    )
    return CheckpointPolicy.MUST_SAVE if saved else CheckpointPolicy.PREFER_RECOMPUTE


def _wrap_remat(block, remat: str):
    """The reference's remat policies, through ``torch.utils.checkpoint``
    (non-reentrant; the block draws no random numbers, so no RNG state is
    kept):

    * ``"blocks"``: recompute every block intermediate in the backward;
    * ``"dots"``: save the outputs of the products without batch dims
      (``aten.mm``/``addmm``: the four weight products, or under MoE the
      two attention ones and the router; the MoE up product, a ``bmm``
      over broadcast tokens) and recompute the rest, norms, RoPE, GELU,
      attention, the MoE down product and combines; the flash forward, launched
      from ctypes where no dispatch mode sees it, reruns as the reference's
      ``pallas_call`` does under its policy;
    * ``"none"``: save everything."""
    if remat == "blocks":
        return functools.partial(
            checkpoint, block, use_reentrant=False, preserve_rng_state=False
        )
    if remat == "dots":
        return functools.partial(
            checkpoint, block, use_reentrant=False, preserve_rng_state=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots),
        )
    if remat == "none":
        return block
    raise ValueError(f"remat must be blocks|dots|none, got {remat!r}")


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, attn_fn=None,
            remat: str = "blocks") -> torch.Tensor:
    """tokens ``[B, S]`` int -> logits ``[B, S, V]`` f32.  ``attn_fn``
    defaults to the plain causal attention; ``remat`` changes memory and
    time, never the numbers."""
    s = tokens.shape[1]
    x = params["embed"][tokens]
    if not cfg.rope:
        x = x + params["pos_embed"][:s]
    block = _wrap_remat(
        functools.partial(_block, cfg=cfg, attn_fn=attn_fn or _full_attention), remat
    )
    for p in params["blocks"]:
        x = block(x, p)
    return tied_logits(x, params)


def shift_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL, the shift taken in the loss."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    targets = tokens[:, 1:].long()
    return torch.mean(-torch.gather(logp, -1, targets[..., None]))


def loss_fn(params, tokens, cfg: ModelConfig, attn_fn=None, remat: str = "blocks"):
    return shift_nll(forward(params, tokens, cfg, attn_fn, remat=remat), tokens)


def param_leaves(tree) -> list:
    """The leaves of a params tree in the reference's tree order (dict keys
    sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in param_leaves(v)]
    if not (isinstance(tree, torch.Tensor) and tree.is_floating_point()):
        raise ValueError(f"training takes float tensor params, got {type(tree).__name__}")
    return [tree]


def _unflatten(tree, leaves):
    """``tree``'s structure with the next leaves of the iterator ``leaves``."""
    if isinstance(tree, dict):
        built = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: built[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_unflatten(v, leaves) for v in tree]
    return next(leaves)


def value_and_grad(loss_fn_, params, tokens):
    """``(loss, grads)`` of ``loss_fn_(params, tokens)``: the loss detached,
    the gradients a tree like ``params`` in the params' dtypes (zeros for a
    leaf the loss does not reach).  ``params`` are not changed."""
    leaves = param_leaves(params)
    live = [t.detach().requires_grad_() for t in leaves]
    with torch.enable_grad():
        loss = loss_fn_(_unflatten(params, iter(live)), tokens)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]
    return loss.detach(), _unflatten(params, iter(grads))


def make_sgd_step(loss_fn_, opt, accum_steps: int = 1, reduce=None):
    """``step(params, opt_state, tokens) -> (params, opt_state, loss)``:
    gradients of ``loss_fn_``, then ``opt``'s update, IN PLACE on params
    and state (the same objects come back).  ``accum_steps > 1`` splits the
    batch into that many microbatches, interleaved (microbatch i takes rows
    i, i + accum_steps, ...), sums their gradients in f32, averages and
    casts them to the params' dtypes, and updates once.  No host read: the
    loss comes back as a device tensor.  ``reduce([loss, *grads])``, when
    given, combines the ranks' losses and gradients before the update (the
    mesh step's all-reduces, ``models/mesh_train.reduce_fn``); under
    accumulation it takes the averaged f32 sums, before the cast."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def step(params, opt_state, tokens):
        if accum_steps == 1:
            loss, grads = value_and_grad(loss_fn_, params, tokens)
            grads = param_leaves(grads)
            if reduce is not None:
                loss, *grads = reduce([loss, *grads])
        else:
            if tokens.shape[0] % accum_steps:
                raise ValueError(
                    f"batch {tokens.shape[0]} not divisible by accum_steps {accum_steps}"
                )
            micro = tokens.reshape(-1, accum_steps, *tokens.shape[1:]).transpose(0, 1)
            leaves = param_leaves(params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
            grad_sum = [torch.zeros_like(t, dtype=torch.float32) for t in leaves]
            for mb in micro:
                loss, grads = value_and_grad(loss_fn_, params, mb)
                loss_sum = loss_sum + loss
                for acc, g in zip(grad_sum, param_leaves(grads)):
                    acc.add_(g)
            inv = 1.0 / accum_steps
            loss = loss_sum * inv
            grads = [g * inv for g in grad_sum]
            if reduce is not None:
                loss, *grads = reduce([loss, *grads])
            grads = [g.to(t.dtype) for g, t in zip(grads, leaves)]
        opt.update_(params, grads, opt_state)
        return params, opt_state, loss

    return step


class AdamW:
    """The reference's ``make_optimizer``: optax's ``adamw(schedule,
    b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)`` (weight decay on every
    leaf, norms and embedding included), after ``clip_by_global_norm``
    when ``grad_clip > 0``: moments in the params' dtype, the schedule
    counted from 0 (the first update uses ``schedule(0)``, 0 under warmup),
    clipping by the bare global norm.  The update is in place and reads
    nothing back to the host: the count is an int32 0-d tensor on the
    params' device, as optax's is, and the schedule and bias corrections
    are computed from it there, so a CUDA graph of the step replays each
    step's own values.  ``torch.optim.AdamW`` with a ``LambdaLR`` and
    ``clip_grad_norm_`` matches optax as closely on the CPU, but its foreach
    update reads its step count with ``.item()`` every step, and
    ``capturable=True``, which keeps the count on the device, refuses CPU
    tensors, so no CPU test could show that step free of host reads."""

    b1, b2, eps, weight_decay = 0.9, 0.95, 1e-8, 0.01

    def __init__(self, lr: float = 3e-4, warmup_steps: int = 0, decay_steps: int = 0,
                 grad_clip: float = 0.0):
        self.lr, self.warmup_steps, self.decay_steps = lr, warmup_steps, decay_steps
        self.grad_clip = grad_clip

    def schedule(self, count: torch.Tensor) -> torch.Tensor:
        """The learning rate at ``count`` (an int32 0-d tensor) as an f32
        0-d tensor on its device, computed in f32 as optax computes
        ``warmup_cosine_decay_schedule``: the linear warmup
        (``polynomial_schedule``) and the cosine decay joined with
        ``where(count < warmup, ...)``."""
        if not self.warmup_steps:
            return torch.full((), self.lr, dtype=torch.float32, device=count.device)
        w, d = self.warmup_steps, self.decay_steps
        frac = 1 - count.clamp(0, w) / w
        warmup = (0.0 - self.lr) * frac + self.lr
        t = torch.clamp(count - w, max=d - w)
        cosine = 0.5 * (1 + torch.cos(math.pi * t / (d - w)))
        alpha = (self.lr * 0.1) / self.lr
        decay = self.lr * ((1 - alpha) * cosine + alpha)
        return torch.where(count < w, warmup, decay)

    def init(self, params) -> dict:
        """``{"count", "mu", "nu"}``: the count an int32 0-d tensor (0) on
        the params' device, the moments lists of zeros in each leaf's
        dtype, in the order of the params' leaves."""
        leaves = param_leaves(params)
        return {
            "count": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
            "mu": [torch.zeros_like(t) for t in leaves],
            "nu": [torch.zeros_like(t) for t in leaves],
        }

    @torch.no_grad()
    def update_(self, params, grads, state) -> None:
        """One update of ``params`` and ``state`` in place from ``grads``
        (a list in leaf order, or a tree like ``params``).  Every tensor of
        ``params`` and ``state`` keeps its object and its address."""
        leaves = param_leaves(params)
        grads = param_leaves(grads) if isinstance(grads, dict) else list(grads)
        if self.grad_clip > 0:
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            keep = norm < self.grad_clip
            grads = [
                torch.where(keep, g, (g / norm.to(g.dtype)) * self.grad_clip) for g in grads
            ]
        count = state["count"]
        neg_lr = -self.schedule(count)
        # the bias corrections in f32 at count + 1, as optax computes them
        step = (count + 1).float()
        bc1, bc2 = 1 - torch.pow(self.b1, step), 1 - torch.pow(self.b2, step)
        by_dtype: dict = {}
        for i, t in enumerate(leaves):
            by_dtype.setdefault(t.dtype, []).append(i)
        for dtype, idx in by_dtype.items():
            def pick(xs):
                return [xs[i] for i in idx]

            # optax casts the step size and the bias corrections to the
            # dtype of the leaves they scale
            self._adam(pick(leaves), pick(grads), pick(state["mu"]), pick(state["nu"]),
                       neg_lr.to(dtype), bc1.to(dtype), bc2.to(dtype))
        count.add_(1)

    def _adam(self, leaves, grads, mu, nu, neg_lr, bc1, bc2) -> None:
        """optax's formulas, each rounded as optax rounds it, over leaves of
        one dtype at once (multi-tensor ops: a few launches per step, not
        ~18 per leaf); the scalars are 0-d tensors of that dtype."""
        torch._foreach_mul_(mu, self.b1)                      # mu = (1-b1) g + b1 mu
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - self.b1))
        g2 = torch._foreach_mul(grads, grads)                 # nu = (1-b2) g^2 + b2 nu
        torch._foreach_mul_(g2, 1 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, g2)
        den = torch._foreach_div(nu, bc2)                     # sqrt(nu_hat) + eps
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(mu, bc1)                       # mu_hat / den
        torch._foreach_div_(u, den)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(leaves, self.weight_decay))
        torch._foreach_mul_(u, neg_lr)
        torch._foreach_add_(leaves, u)


class Adam(AdamW):
    """optax's ``adam(lr)``, the LoRA step's optimizer: b1 0.9, b2 0.999,
    eps 1e-8, a constant learning rate, no weight decay and no clipping;
    the count, bias corrections and in-place update of :class:`AdamW`."""

    b2, weight_decay = 0.999, 0.0

    def __init__(self, lr: float = 1e-3):
        super().__init__(lr)


def make_optimizer(lr: float = 3e-4, warmup_steps: int = 0, decay_steps: int = 0,
                   grad_clip: float = 0.0) -> AdamW:
    """AdamW with linear warmup into cosine decay (both 0: constant lr; a
    partial spec is an error, as in the reference) and global-norm clipping
    before the update (``grad_clip > 0``)."""
    if warmup_steps or decay_steps:
        if not (warmup_steps > 0 and decay_steps > warmup_steps):
            raise ValueError(
                "schedule needs warmup_steps > 0 and decay_steps > "
                f"warmup_steps (got {warmup_steps}, {decay_steps}); "
                "leave both 0 for constant lr"
            )
    return AdamW(lr, warmup_steps, decay_steps, grad_clip)


def _state_tensors(params, opt_state) -> list:
    """Every tensor a train step reads and updates in place."""
    return [*param_leaves(params), opt_state["count"], *opt_state["mu"], *opt_state["nu"]]


def _addresses(tensors) -> tuple:
    return tuple(t.data_ptr() for t in tensors)


class GraphedTrainStep:
    """The train step on the card as one CUDA graph, the counterpart of the
    reference's ``jax.jit(step, donate_argnums=(0, 1))``:
    ``step(params, opt_state, tokens) -> (params, opt_state, loss)`` through
    a :class:`~k8s_dra_driver_torch.models.graphs.GraphedProgram` named
    "train step" (the first call runs eagerly, the second captures and
    replays, later calls replay).

    A graph replays the addresses it captured.  The step updates params and
    optimizer state in place, so they keep theirs: that is what the
    reference's donation gives, with no second copy of the model.  Each
    batch (a tensor, or a mesh rank's ``data.RowBlock``: its rows, the
    step then reading a block of the same layout over the buffer) is
    copied into one token buffer (outside the graph) before the replay,
    and the loss comes back as a copy, since the next replay overwrites
    the graph's own.  Another params or state tensor, or another token
    shape, dtype or block layout, starts a new program (eager, then
    captured) and releases the old graph first; ``captures`` counts the
    captures made.  A restore that writes into the same tensors
    (``TrainCheckpointer.restore(like=...)``) needs none.  ``sgd`` is
    :func:`make_sgd_step`'s step (or the mesh steps' shell around one,
    ``models/mesh_train.train_step_fns``), or with ``base`` (a frozen
    params tree the step reads and never updates, the LoRA step's base
    model) a step ``sgd(params, opt_state, base, tokens)``: the base's
    tensor addresses join the key, so another base starts a new program
    too.  ``capture`` the capturing function (a stand-in in the CPU
    tests); ``name`` the program's, which a failed capture names."""

    def __init__(self, sgd, device, capture=cuda_capture, name: str = "train step"):
        self._sgd, self._device, self._capture = sgd, device, capture
        self.name = name
        self._key = None
        self._tokens = None
        self.program: GraphedProgram | None = None
        self.captures = 0

    def __call__(self, params, opt_state, tokens, base=None):
        block = tokens if isinstance(tokens, RowBlock) else None
        rows = torch.as_tensor(tokens if block is None else block.rows)
        key = (tuple(rows.shape), rows.dtype, None if block is None else block.layout,
               _addresses(_state_tensors(params, opt_state)),
               None if base is None else _addresses(param_leaves(base)))
        if key != self._key:
            self.program = self._tokens = None  # the old graph's pool goes first
            buf = torch.empty_like(rows, device=self._device)
            batch = buf if block is None else dataclasses.replace(block, rows=buf)
            sgd = self._sgd  # the program must not refer back to the holder
            args = (params, opt_state) if base is None else (params, opt_state, base)
            self.program = GraphedProgram(
                self.name, lambda: sgd(*args, batch)[2], self._device,
                capture=self._capture,
            )
            self._key, self._tokens = key, buf
        self._tokens.copy_(rows)
        captured = self.program.graph is not None
        loss = self.program()
        self.captures += int(self.program.graph is not None and not captured)
        return params, opt_state, loss.clone()


@dataclass
class TrainStepFns:
    init: callable
    step: callable
    graphed: GraphedTrainStep | None  # the step's graph holder (None on a gloo mesh)

    @property
    def captures(self) -> int:
        """CUDA graphs the step has captured (0 on the CPU, under
        ``disable_graphs()`` and on a gloo mesh)."""
        return 0 if self.graphed is None else self.graphed.captures


def build_train_step(
    cfg: ModelConfig,
    mesh=None,
    lr: float = 3e-4,
    sequence_parallel: str = "auto",
    attention: str = "dense",
    accum_steps: int = 1,
    remat: str = "blocks",
    device="cuda",
) -> TrainStepFns:
    """``(init, step)`` for single-device training on ``device`` (default
    the card; raises without one unless ``device="cpu"``).

    ``init(generator) -> (params, opt_state)`` draws the params on the
    generator's device.  ``step(params, opt_state, tokens) -> (params,
    opt_state, loss)`` updates params and optimizer state IN PLACE and
    returns the same objects with the loss as a device tensor (no host
    read).  On the card the step replays as one CUDA graph
    (:class:`GraphedTrainStep`) from its third call; it runs eagerly on the
    CPU and inside ``graphs.disable_graphs()``.  ``attention``: ``"dense"``
    (plain PyTorch) or ``"flash"`` (the CUDA flash kernels, forward and
    backward; their plain versions on the CPU).  ``remat``: ``"blocks"``,
    ``"dots"`` or ``"none"`` (:func:`_wrap_remat`; the same numbers under
    each).

    ``mesh``: a ``DeviceMesh`` (``parallel/mesh.build_mesh``): this rank's
    step of the reference's mesh branch (``models/mesh_train``; data,
    tensor and sequence parallelism, ``sequence_parallel`` "auto" taking
    the ring when the ``seq`` axis is > 1, "ring", "ulysses" or "none"),
    on ``device`` (the mesh's device type): one CUDA graph on an NCCL mesh,
    eager on gloo (``mesh_train.train_step_fns``)."""
    valid = ("auto", "ring", "ulysses", "none")
    if sequence_parallel not in valid:
        raise ValueError(f"sequence_parallel must be one of {valid}, got {sequence_parallel!r}")
    if mesh is None and sequence_parallel in ("ring", "ulysses"):
        raise ValueError(
            f"sequence_parallel={sequence_parallel!r} requires a mesh; "
            "single-device training has no seq axis"
        )
    if attention not in ("dense", "flash"):
        raise ValueError(f"attention must be 'dense' or 'flash', got {attention!r}")
    _wrap_remat(_block, remat)  # an unknown policy raises here
    dev = resolve_device(device)
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh

        from k8s_dra_driver_torch.models.mesh_train import build_mesh_train_step

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(
                f"mesh must be a torch.distributed DeviceMesh (parallel/mesh.build_mesh), "
                f"got {type(mesh).__name__}"
            )
        if mesh.device_type != dev.type:
            raise ValueError(f"a {mesh.device_type} mesh trains on {mesh.device_type}, not {dev}")
        return build_mesh_train_step(cfg, mesh, lr, sequence_parallel, attention,
                                     accum_steps, remat, dev)
    opt = make_optimizer(lr)
    attn_fn = None
    if attention == "flash":
        from k8s_dra_driver_torch.ops.flash_attention import flash_attention

        attn_fn = flash_attention

    def init(generator: torch.Generator):
        params = init_params(generator, cfg)
        params_device(params, dev)
        return params, opt.init(params)

    sgd = make_sgd_step(
        lambda params, tokens: loss_fn(params, tokens, cfg, attn_fn, remat=remat),
        opt, accum_steps=accum_steps,
    )
    graphed = GraphedTrainStep(sgd, dev)

    def step(params, opt_state, tokens):
        params_device(params, dev)
        if dev.type == "cuda" and graphs_enabled():
            return graphed(params, opt_state, tokens)
        return sgd(params, opt_state, torch.as_tensor(tokens, device=dev))

    return TrainStepFns(init=init, step=step, graphed=graphed)


def sample_tokens(generator: torch.Generator, cfg: ModelConfig, batch: int,
                  seq: int) -> torch.Tensor:
    """Uniform random tokens ``[batch, seq]`` int32 on the generator's
    device."""
    return torch.randint(
        0, cfg.vocab_size, (batch, seq), generator=generator,
        device=generator.device, dtype=torch.int32,
    )
