"""LoRA: low-rank adapters for the burn-in transformer
(``k8s_dra_driver_tpu/models/lora.py``).

An adapter freezes the base and learns a rank-``r`` update per targeted
block matrix, ``W' = W + (alpha / r) * A @ B`` with ``A [in, r]`` and
``B [r, out]``, in float32.  Two ways to use one:

* :func:`merge` folds one adapter into plain weights that every path
  (decode, both serving engines, quantization, drafting) takes unchanged;
  fresh adapters (``B = 0``) merge to the base's values;
* a serving bank (:func:`stack_adapters`, row 0 the identity) serves many
  adapters over one base at once: each row of a batch applies its own
  request's adapter through the projections' delta hook
  (:func:`adapter_delta`, ``burnin.qkv_proj``/``mlp_residual``), in both
  engines (``submit(adapter=k)``).

The adapter's products are plain PyTorch (an index gather and two batched
products in float32, cast back to the activation dtype last), as the
reference's are einsums XLA compiles outside any Pallas kernel.

:func:`build_lora_train_step` trains the adapters only: the base is an
argument of the step, gradients reach A and B through the merge, and
optax's ``adam`` (``burnin.Adam``) keeps moments for the adapters alone.
On the card the step replays as one CUDA graph, as the full step does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from k8s_dra_driver_torch.device import params_device, resolve_device
from k8s_dra_driver_torch.models import burnin
from k8s_dra_driver_torch.models.burnin import ModelConfig, TrainStepFns
from k8s_dra_driver_torch.models.graphs import graphs_enabled

# the block matmuls, the set weight-only quantization targets too
DEFAULT_TARGETS = ("qkv", "attn_out", "mlp_up", "mlp_down")


@dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: tuple = DEFAULT_TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    def validate(self, cfg: ModelConfig) -> None:
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        bad = [t for t in self.targets if t not in DEFAULT_TARGETS]
        if bad:
            raise ValueError(f"unknown LoRA targets {bad}; valid: {DEFAULT_TARGETS}")
        if not self.targets:
            raise ValueError("LoRA needs at least one target matrix")
        if self.rank >= cfg.d_model:
            raise ValueError(
                f"rank {self.rank} >= d_model {cfg.d_model}: low-rank in name only"
            )
        # MoE blocks replace the dense MLP pair with per-expert stacks;
        # adapters target the 2-D matrices only (burnin.block_matrix_shapes)
        missing = [t for t in self.targets if t not in burnin.block_matrix_shapes(cfg)]
        if missing:
            raise ValueError(
                f"LoRA targets {missing} do not exist under this config "
                f"(MoE replaces the dense MLP; use "
                f"targets=('qkv', 'attn_out'))"
            )


def init_adapters(generator: torch.Generator, cfg: ModelConfig, lora: LoraConfig) -> dict:
    """``{"blocks": [{target: {"a", "b"}}]}`` on the generator's device, in
    float32: A normal with std ``1 / r``, B zeros, so the merged model
    starts at the base.  Drawn per layer and target in the reference's
    order; the numbers differ from ``jax.random``'s (parity tests carry
    the JAX package's adapters over with ``weights.adapters_from_jax``)."""
    lora.validate(cfg)
    dims = burnin.block_matrix_shapes(cfg)
    dev = generator.device
    blocks = []
    for _ in range(cfg.n_layers):
        blk = {}
        for name in lora.targets:
            d_in, d_out = dims[name]
            a = torch.randn((d_in, lora.rank), generator=generator, device=dev,
                            dtype=torch.float32)
            blk[name] = {
                "a": a * (1.0 / lora.rank),
                "b": torch.zeros((lora.rank, d_out), dtype=torch.float32, device=dev),
            }
        blocks.append(blk)
    return {"blocks": blocks}


def merge(params: dict, adapters: dict, lora: LoraConfig) -> dict:
    """``params`` with ``W + scale * A @ B`` folded into each targeted
    matrix, computed in float32 and cast back to the weight's dtype (B = 0
    gives the base's values: the float32 round trip of a bf16 weight is
    exact)."""
    out = dict(params)
    out["blocks"] = [
        {
            name: (w.float() + lora.scale * (ad[name]["a"] @ ad[name]["b"])).to(w.dtype)
            if name in ad else w
            for name, w in blk.items()
        }
        for blk, ad in zip(params["blocks"], adapters["blocks"])
    ]
    return out


def adapter_param_count(adapters: dict) -> int:
    return sum(t.numel() for t in burnin.param_leaves(adapters))


def stack_adapters(cfg: ModelConfig, lora: LoraConfig, adapter_list, device=None) -> dict:
    """A serving bank for per-request LoRA: the adapters stacked on a
    leading axis with row 0 the identity (zeros: a request with no adapter
    adds exact zeros, so one program serves every mix).  Per layer
    ``{target: {"a": [n+1, d_in, r], "b": [n+1, r, d_out]}}``, and
    ``"scale"`` a Python float.  On the adapters' device (``device`` for an
    empty list, default the card)."""
    lora.validate(cfg)
    targets = set(lora.targets)
    for j, ad in enumerate(adapter_list):
        if len(ad["blocks"]) != cfg.n_layers:
            raise ValueError(
                f"adapter {j} has {len(ad['blocks'])} layers, model has {cfg.n_layers}"
            )
        got = set(ad["blocks"][0])
        if got != targets:
            # a subset of targets would serve a partial fine-tune quietly
            raise ValueError(
                f"adapter {j} targets {sorted(got)} != bank targets {sorted(targets)}"
            )
    if adapter_list:
        dev = adapter_list[0]["blocks"][0][lora.targets[0]]["a"].device
    else:
        dev = resolve_device("cuda" if device is None else device)
    dims = burnin.block_matrix_shapes(cfg)
    blocks = []
    for li in range(cfg.n_layers):
        blk = {}
        for name in lora.targets:
            d_in, d_out = dims[name]
            zeros = {"a": (d_in, lora.rank), "b": (lora.rank, d_out)}
            blk[name] = {
                part: torch.stack(
                    [torch.zeros(shape, dtype=torch.float32, device=dev)]
                    + [ad["blocks"][li][name][part].to(dev) for ad in adapter_list]
                )
                for part, shape in zeros.items()
            }
        blocks.append(blk)
    return {"blocks": blocks, "scale": lora.scale}


def bank_size(bank: dict) -> int:
    """Entries in a serving bank, the identity row included."""
    first = next(iter(bank["blocks"][0].values()))
    return int(first["a"].shape[0])


def adapter_delta(bank_layer: dict, ids, scale: float):
    """The per-row update hook of ONE bank layer:
    ``delta(name, y) = scale * (y @ A[ids]) @ B[ids]`` in float32, cast to
    y's dtype last; each row of ``y [B, S, d]`` applies its own adapter.  A
    target the bank does not carry adds an exact zero."""

    def delta(name, y):
        ab = bank_layer.get(name)
        if ab is None:
            return torch.zeros((), dtype=y.dtype, device=y.device)
        a = ab["a"].index_select(0, ids)                     # [B, d_in, r]
        b = ab["b"].index_select(0, ids)                     # [B, r, d_out]
        xa = torch.bmm(y.float(), a)
        return (torch.bmm(xa, b) * scale).to(y.dtype)

    return delta


def layer_delta(adapters, li: int):
    """Layer ``li``'s hook of an adapter context ``(bank, ids)``."""
    bank, ids = adapters
    return adapter_delta(bank["blocks"][li], ids, bank["scale"])


def build_lora_train_step(cfg: ModelConfig, lora: LoraConfig = LoraConfig(), lr: float = 1e-3,
                          attention: str = "dense", device="cuda") -> TrainStepFns:
    """``(init, step)`` for adapter-only fine-tuning on ``device`` (default
    the card; raises without one unless ``device="cpu"``).

    ``init(generator) -> (adapters, opt_state)``; ``step(adapters,
    opt_state, base_params, tokens) -> (adapters, opt_state, loss)``
    updates the adapters and the Adam state IN PLACE and returns the loss
    as a device tensor.  The base is an argument, never updated: gradients
    reach A and B through :func:`merge` only.  ``attention``: ``"dense"``
    or ``"flash"`` (the CUDA flash kernels, forward and backward; their
    plain versions on the CPU).  On the card the step replays as one CUDA
    graph from its third call (``burnin.GraphedTrainStep``, keyed on the
    base's tensors too); eagerly on the CPU and inside
    ``graphs.disable_graphs()``."""
    lora.validate(cfg)
    if attention not in ("dense", "flash"):
        raise ValueError(f"attention must be 'dense' or 'flash', got {attention!r}")
    dev = resolve_device(device)
    opt = burnin.Adam(lr)
    attn_fn = None
    if attention == "flash":
        from k8s_dra_driver_torch.ops.flash_attention import flash_attention

        attn_fn = flash_attention

    def init(generator: torch.Generator):
        if generator.device.type != dev.type:
            raise ValueError(f"the generator lives on {generator.device}, not {dev}")
        adapters = init_adapters(generator, cfg, lora)
        return adapters, opt.init(adapters)

    def sgd(adapters, opt_state, base_params, tokens):
        step = burnin.make_sgd_step(
            lambda ad, toks: burnin.loss_fn(merge(base_params, ad, lora), toks, cfg, attn_fn),
            opt,
        )
        return step(adapters, opt_state, tokens)

    graphed = burnin.GraphedTrainStep(sgd, dev)

    def step(adapters, opt_state, base_params, tokens):
        params_device(base_params, dev)
        if dev.type == "cuda" and graphs_enabled():
            return graphed(adapters, opt_state, tokens, base=base_params)
        return sgd(adapters, opt_state, base_params, torch.as_tensor(tokens, device=dev))

    return TrainStepFns(init=init, step=step, graphed=graphed)
