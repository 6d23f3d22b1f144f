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

The training half is the single-device branch of the reference's
``build_train_step``: ``forward`` with the reference's rematerialization
policies (``torch.utils.checkpoint``; ``"dots"`` through a selective
checkpoint policy), ``loss_fn``, ``make_optimizer`` (optax's ``adamw`` and
``clip_by_global_norm``, written out, its count, schedule and bias
corrections on the device) and ``make_sgd_step`` (gradient accumulation
with the interleaved microbatch split).  The step updates params and
optimizer state IN PLACE (the reference's step is pure and donates its
buffers instead) and, on the card, replays as one CUDA graph
(:class:`GraphedTrainStep`, the reference's ``jax.jit``).  Meshes, LoRA and
MoE training raise ``NotImplementedError``.
"""

from __future__ import annotations

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
from k8s_dra_driver_torch.models.graphs import GraphedProgram, cuda_capture, graphs_enabled
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
    # the base filled on the device, not copied from the host (capturable)
    base = torch.full((), cfg.rope_base, dtype=torch.float32, device=x.device)
    freqs = torch.pow(base, exponent)
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


def _full_attention(q, k, v):
    return reference_attention(q, k, v, causal=True)


def _block(x, p, cfg: ModelConfig, attn_fn=_full_attention):
    b, s, d = x.shape
    q, k, v = qkv_proj(x, p, cfg)
    # GQA k/v are widened to one head per query head: every attention
    # backend sees the MHA shape
    attn = attn_fn(q, repeat_kv(k, cfg), repeat_kv(v, cfg)).reshape(b, s, d)
    x = x + _mm(attn, p["attn_out"])
    return mlp_residual(x, p)


# the products without batch dims: ``_mm(x, W)`` reaches ``aten.mm`` through
# ``matmul``'s fold of x's leading dims (the reference's
# ``dots_with_no_batch_dims_saveable``)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _wrap_remat(block, remat: str):
    """The reference's remat policies, through ``torch.utils.checkpoint``
    (non-reentrant; the block draws no random numbers, so no RNG state is
    kept):

    * ``"blocks"``: recompute every block intermediate in the backward;
    * ``"dots"``: save the outputs of the products without batch dims
      (``aten.mm``/``addmm``: the four weight products) and recompute the
      rest, norms, RoPE, GELU and attention; the flash forward, launched
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


def make_sgd_step(loss_fn_, opt, accum_steps: int = 1):
    """``step(params, opt_state, tokens) -> (params, opt_state, loss)``:
    gradients of ``loss_fn_``, then ``opt``'s update, IN PLACE on params
    and state (the same objects come back).  ``accum_steps > 1`` splits the
    batch into that many microbatches, interleaved (microbatch i takes rows
    i, i + accum_steps, ...), sums their gradients in f32, averages and
    casts them to the params' dtypes, and updates once.  No host read: the
    loss comes back as a device tensor."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def step(params, opt_state, tokens):
        if accum_steps == 1:
            loss, grads = value_and_grad(loss_fn_, params, tokens)
            grads = param_leaves(grads)
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
            grads = [(g * inv).to(t.dtype) for g, t in zip(grad_sum, leaves)]
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
        torch._foreach_add_(u, torch._foreach_mul(leaves, self.weight_decay))
        torch._foreach_mul_(u, neg_lr)
        torch._foreach_add_(leaves, u)


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
    batch is copied into one token buffer (outside the graph) before the
    replay, and the loss comes back as a copy, since the next replay
    overwrites the graph's own.  Another params or state tensor, or another
    token shape or dtype, starts a new program (eager, then captured) and
    releases the old graph first; ``captures`` counts the captures made.  A
    restore that writes into the same tensors
    (``TrainCheckpointer.restore(like=...)``) needs none.  ``sgd`` is
    :func:`make_sgd_step`'s step; ``capture`` the capturing function (a
    stand-in in the CPU tests)."""

    def __init__(self, sgd, device, capture=cuda_capture):
        self._sgd, self._device, self._capture = sgd, device, capture
        self._key = None
        self._tokens = None
        self.program: GraphedProgram | None = None
        self.captures = 0

    def __call__(self, params, opt_state, tokens):
        tokens = torch.as_tensor(tokens)
        key = (tuple(tokens.shape), tokens.dtype,
               tuple(t.data_ptr() for t in _state_tensors(params, opt_state)))
        if key != self._key:
            self.program = self._tokens = None  # the old graph's pool goes first
            buf = torch.empty_like(tokens, device=self._device)
            sgd = self._sgd  # the program must not refer back to the holder
            self.program = GraphedProgram(
                "train step", lambda: sgd(params, opt_state, buf)[2], self._device,
                capture=self._capture,
            )
            self._key, self._tokens = key, buf
        self._tokens.copy_(tokens)
        captured = self.program.graph is not None
        loss = self.program()
        self.captures += int(self.program.graph is not None and not captured)
        return params, opt_state, loss.clone()


@dataclass
class TrainStepFns:
    init: callable
    step: callable
    graphed: GraphedTrainStep  # the step's graph holder on the card

    @property
    def captures(self) -> int:
        """CUDA graphs the step has captured (0 on the CPU and under
        ``disable_graphs()``)."""
        return self.graphed.captures


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
    each).  A mesh (the reference's sharded, ring and Ulysses branches) is
    not ported yet."""
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
    if mesh is not None:
        raise NotImplementedError(
            "mesh training (sharded, ring and Ulysses attention) is not ported yet; "
            "pass mesh=None for one device"
        )
    _wrap_remat(_block, remat)  # an unknown policy raises here
    dev = resolve_device(device)
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
