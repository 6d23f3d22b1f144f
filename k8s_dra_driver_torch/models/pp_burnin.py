"""Pipeline-parallel training over ``pipe`` x ``data`` x ``model``
(``k8s_dra_driver_tpu/models/pp_burnin.py``).

The burn-in transformer is cut by depth over ``pipe``
(``ops/pipeline.pipeline_apply``, the GPipe ring), its blocks carry
Megatron tensor parallelism over ``model`` (``qkv`` group-major, so a
column shard holds whole KV groups; ``mlp_up`` column-parallel,
``attn_out``/``mlp_down`` row-parallel), and the batch splits over
``data``.  The embedding, ``ln_f`` and the tied logits sit outside the
pipeline.  As in ``models/mesh_train``, each rank runs its shard of the
step (one CUDA graph on NCCL, eagerly on gloo) and takes the whole batch;
the collectives the reference's
``shard_map`` and GSPMD insert are written out.

* **Rows.** The batch ``[B, S]`` is reshaped to ``[n_micro, B/n_micro,
  S]`` and dim 1 is cut over ``data`` (the reference's ``mb_spec``), so a
  rank's rows are the reference's and the sums run over the same rows.
* **Blocks.** ``"megatron"``: the activations are whole on every model
  rank; ``pvary`` before each column-parallel product, ``psum`` after each
  row-parallel one.  ``"megatron-sp"``: the residual stream is cut by
  sequence over ``model``; the column-parallel products are
  ``collective_matmul.all_gather_matmul`` and the row-parallel ones
  ``matmul_reduce_scatter``.  Attention (:func:`_tp_attention_core`) is
  plain PyTorch in both, as the reference's is plain XLA: grouped
  einsums, the mask and softmax in f32, the weights cast back.  Every
  block is rematerialised (``burnin._wrap_remat(..., "blocks")``, the
  reference's ``jax.checkpoint``).
* **Outside the pipeline.** The vocab-sharded embedding is gathered over
  ``model`` once a forward.  The embedded input goes through
  ``collectives.pvary`` over ``pipe``: it feeds stage 0's injection only,
  so its gradient exists on stage 0 alone and the all-reduce gives it to
  every stage.  ``ln_f`` and the tied logits run the same on every
  ``pipe`` rank after the pipeline's ``psum``: their gradients are whole
  on each and are not summed over ``pipe``.
* **The loss** is the global mean: a rank's NLL sum over its rows and its
  positions' targets (taken from the whole sequence), over ``B (S - 1)``,
  summed over the ranks that hold other rows or positions.

The reduction of every leaf's gradient, per ``tp_mode`` (all of them are
then summed over ``data``):

========================  ==================================  ==============================
leaf                      ``"megatron"``                      ``"megatron-sp"``
========================  ==================================  ==============================
stage blocks' matrices    whole on the rank (its own shard)   whole on the rank
``ln1``, ``ln2``          whole (``pvary`` sums the inputs'   partial (the rank's positions):
                          gradients over ``model``)           summed over ``model``
``ln_f``                  whole                               partial: summed over ``model``
``pos_embed``             whole                               partial: summed over ``model``
``embed``                 whole after the gather, each        partial: the gather's backward
                          model rank keeps its rows           reduce-scatters it over ``model``
                          (``mesh_train._GatherVocab``)       (``collectives.all_gather``)
the loss                  whole over ``model``                partial: summed over ``model``
========================  ==================================  ==============================
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from k8s_dra_driver_torch.device import resolve_device
from k8s_dra_driver_torch.models import weights
from k8s_dra_driver_torch.models.data import RowBlock
from k8s_dra_driver_torch.models.burnin import (
    ModelConfig,
    TrainStepFns,
    _rms_norm,
    _wrap_remat,
    rope_rotate,
    tied_logits,
)
from k8s_dra_driver_torch.models.mesh_train import _GatherVocab, reduced_grads, train_step_fns
from k8s_dra_driver_torch.ops import collectives
from k8s_dra_driver_torch.ops.collective_matmul import all_gather_matmul, matmul_reduce_scatter
from k8s_dra_driver_torch.ops.pipeline import pipeline_apply, stage_scan
from k8s_dra_driver_torch.parallel.mesh import P, axis_index, mesh_shape

TP_MODES = ("megatron", "megatron-sp")

# Stacked-block layout: leading dim the layer, over ``pipe``; Megatron
# columns or rows over ``model`` on the trailing dims
_STACKED_SPECS = {
    "ln1": P("pipe"),
    "qkv": P("pipe", None, "model"),
    "attn_out": P("pipe", "model", None),
    "ln2": P("pipe"),
    "mlp_up": P("pipe", None, "model"),
    "mlp_down": P("pipe", "model", None),
}
# leaves used on the rank's sequence block alone under "megatron-sp"
_SEQ_PARTIAL = ("ln1", "ln2", "ln_f", "pos_embed")


def pp_param_pspecs(cfg: ModelConfig) -> dict:
    """The pipeline layout's specs: ``_STACKED_SPECS`` for the blocks, the
    embedding vocab-sharded over ``model``, ``ln_f`` (and ``pos_embed``)
    replicated (the reference's ``outer_specs``)."""
    out = {"embed": P("model", None), "ln_f": P(), "blocks": dict(_STACKED_SPECS)}
    if not cfg.rope:
        out["pos_embed"] = P()
    return out


def pp_params_from_dense(dense: dict, cfg: ModelConfig) -> dict:
    """The dense params as the pipeline layout (``weights.pipeline_params``:
    stacked blocks, group-major ``qkv``).  RoPE configs carry no
    ``pos_embed``."""
    if cfg.n_experts:
        raise ValueError(
            "pipeline training does not support MoE blocks; use "
            "build_train_step (TP/DP/SP) or ops/moe.topk_moe (EP)"
        )
    return weights.pipeline_params(cfg, dense)


def _tp_attention_core(qkv, b: int, s: int, tp: int, cfg: ModelConfig, dtype):
    """Group-major ``qkv [b, s, (Hkv/tp)·(G+2)·hd]`` -> the attention
    output ``[b, s, d/tp]``: each local KV head against its G query heads
    (k/v never widened), RoPE by absolute position, scores in the input
    dtype divided by sqrt(hd) in that dtype, the causal mask and softmax in
    f32, the weights cast back."""
    hkv_loc = cfg.kv_heads // tp
    g, hd = cfg.kv_groups, cfg.head_dim
    qkv = qkv.reshape(b, s, hkv_loc, (g + 2) * hd)
    q = qkv[..., : g * hd].reshape(b, s, hkv_loc * g, hd)
    k = qkv[..., g * hd: (g + 1) * hd]
    v = qkv[..., (g + 1) * hd:]
    if cfg.rope:
        pos = torch.arange(s, dtype=torch.int32, device=qkv.device)
        q = rope_rotate(q, pos, cfg)
        k = rope_rotate(k, pos, cfg)
    qg = q.reshape(b, s, hkv_loc, g, hd)
    scale = torch.full((), math.sqrt(hd), dtype=dtype, device=qkv.device)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / scale
    mask = torch.ones((s, s), dtype=torch.bool, device=qkv.device).tril()
    scores = torch.where(mask, scores.float(), torch.full((), -1e30, device=qkv.device))
    w = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(b, s, cfg.d_model // tp)


def _manual_tp_block_sp(x, p, cfg: ModelConfig, tp: int, group):
    """Megatron-SP: x ``[b, s/tp, D]``, this rank's sequence block; the
    column-parallel products gather the sequence through the ring, the
    row-parallel ones reduce-scatter it back."""
    b, s_loc, _ = x.shape
    y = _rms_norm(x, p["ln1"])
    qkv = all_gather_matmul(y, p["qkv"], group)
    attn = _tp_attention_core(qkv, b, s_loc * tp, tp, cfg, x.dtype)
    x = x + matmul_reduce_scatter(attn, p["attn_out"], group)
    y = _rms_norm(x, p["ln2"])
    h = F.gelu(all_gather_matmul(y, p["mlp_up"], group), approximate="tanh")
    return x + matmul_reduce_scatter(h, p["mlp_down"], group)


def _manual_tp_block(x, p, cfg: ModelConfig, tp: int, group):
    """Classic Megatron: x ``[b, s, D]`` whole on every model rank."""
    b, s, _ = x.shape
    y = _rms_norm(x, p["ln1"])
    qkv = collectives.pvary(y, group) @ p["qkv"]
    attn = _tp_attention_core(qkv, b, s, tp, cfg, x.dtype)
    x = x + collectives.psum(attn @ p["attn_out"], group)
    y = _rms_norm(x, p["ln2"])
    h = F.gelu(collectives.pvary(y, group) @ p["mlp_up"], approximate="tanh")
    return x + collectives.psum(h @ p["mlp_down"], group)


@dataclass
class PipePlan:
    """What one rank runs: its groups, its data block and the mode."""

    pipe_group: object
    model_group: object | None  # None without tensor parallelism
    data_group: object | None   # None without data parallelism
    tp: int
    model_index: int
    n_data: int
    data_index: int
    n_micro: int
    sp: bool


def _check(cfg: ModelConfig, shape: dict, tp_mode: str) -> None:
    """The reference's refusals, in its order and with its messages."""
    if tp_mode not in TP_MODES:
        raise ValueError(f"tp_mode must be 'megatron' or 'megatron-sp', got {tp_mode!r}")
    pp, tp = shape.get("pipe", 1), shape.get("model", 1)
    if pp < 2:
        raise ValueError("build_pp_train_step needs a mesh with pipe >= 2")
    if shape.get("seq", 1) != 1:
        raise ValueError("the pipeline path composes with data/model axes only")
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers ({cfg.n_layers}) must divide into {pp} stages")
    if cfg.kv_heads % tp:
        raise ValueError(f"n_kv_heads ({cfg.kv_heads}) not divisible by model axis {tp}")
    if cfg.d_ff % tp or cfg.d_model % tp:
        raise ValueError(
            f"d_ff ({cfg.d_ff}) and d_model ({cfg.d_model}) must be divisible "
            f"by model axis {tp}"
        )


def pp_plan(cfg: ModelConfig, mesh, n_micro: int | None = None,
            tp_mode: str = "megatron") -> PipePlan:
    """This rank's plan on ``mesh``, after the reference's refusals."""
    shape = mesh_shape(mesh)
    _check(cfg, shape, tp_mode)
    tp, n_data = shape["model"], shape["data"]
    return PipePlan(
        pipe_group=mesh.get_group("pipe"),
        model_group=mesh.get_group("model") if tp > 1 else None,
        data_group=mesh.get_group("data") if n_data > 1 else None,
        tp=tp, model_index=axis_index(mesh, "model")[0], n_data=n_data,
        data_index=axis_index(mesh, "data")[0], n_micro=n_micro or shape["pipe"],
        sp=tp_mode == "megatron-sp",
    )


def pp_loss(params, tokens, cfg: ModelConfig, plan: PipePlan):
    """This rank's part of the global mean NLL of ``tokens`` (the whole
    batch), summed over ``data`` (and under "megatron-sp" over ``model``)
    it is the reference's loss.  A ``data.RowBlock`` is gathered whole over
    ``data`` first, as the reference's reshard does: the microbatches
    interleave the whole batch's rows."""
    if isinstance(tokens, RowBlock):
        tokens = tokens.whole()
    b, s = tokens.shape
    if b % plan.n_micro or (b // plan.n_micro) % plan.n_data:
        raise ValueError(
            f"batch {b} must split into {plan.n_micro} microbatches each "
            f"divisible by the data axis ({plan.n_data})"
        )
    if plan.sp and s % plan.tp:
        raise ValueError(
            f"megatron-sp shards the sequence over the model axis: "
            f"seq {s} must be divisible by {plan.tp}"
        )
    rows = tokens.reshape(plan.n_micro, b // plan.n_micro, s).chunk(plan.n_data, 1)[
        plan.data_index]
    table = params["embed"]
    if plan.model_group is not None:
        table = (collectives.all_gather(table, plan.model_group, 0) if plan.sp
                 else _GatherVocab.apply(table, plan.model_group))
    x = table[rows]
    if not cfg.rope:
        x = x + params["pos_embed"][:s]
    s_blk, lo = s, 0
    if plan.sp:
        s_blk = s // plan.tp
        lo = plan.model_index * s_blk
        x = x[:, :, lo: lo + s_blk]
    x = collectives.pvary(x, plan.pipe_group)  # the lookup feeds stage 0 alone
    block = _manual_tp_block_sp if plan.sp else _manual_tp_block
    block_fn = _wrap_remat(
        functools.partial(block, cfg=cfg, tp=plan.tp, group=plan.model_group), "blocks")
    x = pipeline_apply(functools.partial(stage_scan, block_fn), params["blocks"], x,
                       plan.pipe_group)
    x = x.reshape(-1, s_blk, cfg.d_model)
    targets = rows.reshape(-1, s)[:, lo + 1: lo + s_blk + 1]
    logits = tied_logits(x, {"ln_f": params["ln_f"], "embed": table})
    logp = torch.log_softmax(logits[:, : targets.shape[1]], dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long()).sum()
    return nll / (b * (s - 1))


def _leaf_names(tree, key=None) -> list:
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], k)]
    return [key]


def reduce_fn(cfg: ModelConfig, plan: PipePlan):
    """``reduce([loss, *grads]) -> [loss, *grads]`` (the grads in
    ``param_leaves`` order): the table in the module docstring, one
    all-reduce per dtype and group (``collectives.all_reduce_buckets``)."""
    names = [None] + _leaf_names(pp_param_pspecs(cfg))
    seq_partial = [plan.sp and (name is None or name in _SEQ_PARTIAL) for name in names]

    def reduce(tensors):
        if len(tensors) != len(names):
            raise ValueError(f"{len(tensors)} tensors for {len(names)} leaves and the loss")
        return collectives.all_reduce_buckets(
            tensors, lambda i: (plan.data_group, plan.model_group if seq_partial[i] else None))

    return reduce


def loss_and_grads(params, tokens, cfg: ModelConfig, plan: PipePlan):
    """The global loss and this rank's reduced gradient shards (a tree like
    ``params``), as one step computes them, with no update."""
    return reduced_grads(functools.partial(pp_loss, cfg=cfg, plan=plan),
                         reduce_fn(cfg, plan), params, tokens)


def build_pp_train_step(cfg: ModelConfig, mesh, lr: float = 3e-4, n_micro: int | None = None,
                        tp_mode: str = "megatron", device="cuda", capture=None) -> TrainStepFns:
    """``(init, step)`` of pipeline-parallel training for this rank of
    ``mesh`` (a ``DeviceMesh`` with ``pipe >= 2``, ``seq`` 1) on ``device``
    (default the card; raises without one unless ``device="cpu"``), on
    ``mesh_train.train_step_fns``' shell: ``init`` converts the whole dense
    model to the pipeline layout and keeps this rank's shards; ``step``
    takes the whole batch and returns the global mean loss.  ``n_micro``
    defaults to the ``pipe`` size.  ``tp_mode``: "megatron" or
    "megatron-sp" (the module docstring).  On an NCCL mesh the step is one
    CUDA graph (``graphed``, "pipeline train step"); on gloo it runs
    eagerly (``graphed`` is None); ``capture`` as the shell takes it."""
    plan = pp_plan(cfg, mesh, n_micro, tp_mode)
    dev = resolve_device(device)
    if mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh trains on {mesh.device_type}, not {dev}")
    return train_step_fns(
        cfg, functools.partial(pp_loss, cfg=cfg, plan=plan), reduce_fn(cfg, plan),
        lambda full: weights.shard_pipeline_params(cfg, mesh, pp_params_from_dense(full, cfg))[0],
        lr, dev, mesh, capture=capture, name="pipeline train step")
