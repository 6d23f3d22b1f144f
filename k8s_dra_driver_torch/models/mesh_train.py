"""Training on a mesh: the mesh branch of the reference's
``burnin.build_train_step`` (``k8s_dra_driver_tpu/models/burnin.py:590-672``),
reached through :func:`~k8s_dra_driver_torch.models.burnin.build_train_step`
with ``mesh=`` a ``DeviceMesh`` (``parallel/mesh.build_mesh``).

The reference jits one program and GSPMD partitions it.  Here every rank
runs its shard of the step and the collectives GSPMD would insert are
written out:

* **batch** over ``data`` (and ``slice`` on a multislice mesh: hybrid data
  parallelism): the caller passes the whole batch ``[B, S]`` to every rank,
  as the reference's tokens are sharded over the batch axes only, and each
  rank takes its block of rows; or only that block, a ``data.RowBlock``
  (``data.TokenBatches`` yields them);
* **sequence** over ``seq``: a rank runs positions
  ``[i·S/n, (i+1)·S/n)`` (RoPE rotates by them), attention by ring, flash
  ring or Ulysses (``ops/ring_attention``), and takes the targets of its
  positions from the whole sequence, so no target is lost at a shard edge;
* **tensors** over ``model`` (Megatron): ``qkv`` group-major by KV group
  (``weights.shard_params``; with fewer KV groups than model ranks the
  projection is all-gathered and each rank attends with its own query
  heads), ``mlp_up``/``expert_up`` column-parallel
  behind ``collectives.pvary``, ``attn_out``/``mlp_down``/``expert_down``
  row-parallel with a ``psum`` after, the router replicated; the
  vocab-sharded embedding is all-gathered once per forward for the lookup
  and the tied logits (:class:`_GatherVocab`), and since everything after
  the gather is replicated over ``model``, its gradient is the same on
  every model rank and each keeps its own rows, with no collective;
* **the loss** is the global mean: each rank's NLL sum over its targets,
  divided by its rows x (S - 1); those are summed over ``seq`` and
  averaged over the batch axes, and so is every gradient (one all-reduce
  per dtype and axis over the flattened gradients) before AdamW updates
  the rank's shards in place.

On an NCCL mesh the step is one CUDA graph (:func:`train_step_fns`), the
reference's ``jax.jit`` with donation; on gloo it runs eagerly.  ``remat``
recomputes a block's collectives with it, on every rank alike.

Capturing NCCL (``chip_smoke.collective_capture_probe`` on an H100 with
torch 2.11 and NCCL 2.28, a world-1 NCCL group, each collective called
directly):

* ``graphs.cuda_capture`` (``capture_begin`` in its default "global"
  error mode, on a side stream) captures ``all_reduce``, the list
  ``all_gather`` the port issues, ``all_gather_into_tensor``,
  ``reduce_scatter_tensor``, ``all_to_all_single``, ``broadcast`` and
  ``batch_isend_irecv``; ProcessGroupNCCL's own stream joins the capture
  through its events.  So does an ``all_reduce`` issued from autograd's
  backward thread, as the backward functions of ``collectives`` issue
  theirs (``_Pvary``, ``_AllGather``, ``_PPermute``): autograd runs a
  backward function on its forward's stream, the capturing one.  Every replay equals an eager
  call.  No collective the steps use failed, so no NCCL step stays eager.
* The communicator exists before the capture: ``ranks.init_ranks`` and
  ``consumer`` pass NCCL its ``device_id``, which opens the default
  group's communicator at init and a later group's at its creation (an
  all-reduce whose first call on a new group is inside the capture
  captures too).  Call 1 of a step runs eagerly anyway.
* The watchdog (``TORCH_NCCL_ASYNC_ERROR_HANDLING`` unset, torch's
  default): the captures and replays raised nothing and the runs ended
  cleanly.
* One card holds a world of 1 under NCCL (it refuses two ranks of one
  communicator on a card), where the shell issues no collective at all.
  A graph over several ranks is checked on the CPU only, through a
  stand-in capture on gloo (``tests/test_torch_mesh_graph.py``); its check
  on several cards waits for such a machine.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from k8s_dra_driver_torch.models.burnin import (
    GraphedTrainStep,
    TrainStepFns,
    _mm,
    _rms_norm,
    _unflatten,
    _wrap_remat,
    init_params,
    make_optimizer,
    make_sgd_step,
    mlp_residual,
    param_leaves,
    repeat_kv,
    rope_rotate,
    tied_logits,
    value_and_grad,
)
from k8s_dra_driver_torch.models.data import RowBlock, as_batch, local_rows
from k8s_dra_driver_torch.models.graphs import cuda_capture, graphs_enabled
from k8s_dra_driver_torch.ops import collectives
from k8s_dra_driver_torch.parallel.mesh import axis_index, mesh_shape


class _GatherVocab(torch.autograd.Function):
    """The whole embedding table from this rank's vocab rows; the gradient,
    the same on every model rank, keeps this rank's rows."""

    @staticmethod
    def forward(ctx, shard, group):
        ctx.group = group
        return collectives.all_gather_raw(shard, group, 0)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, 0)[r].contiguous(), None


def _gathered_attention(q, k, v, group):
    """Scheme ``"none"`` on a sequence-sharded mesh with plain attention:
    K/V all-gathered over ``seq`` (what GSPMD does there), causal attention
    of this rank's queries, the reference's casts."""
    import torch.distributed as dist

    idx = dist.get_rank(group)
    k_all, v_all = (collectives.all_gather(t, group, 1) for t in (k, v))
    s_loc, s_all, d = q.shape[1], k_all.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_all).float() / d ** 0.5
    q_pos = idx * s_loc + torch.arange(s_loc, device=q.device)
    keep = torch.arange(s_all, device=q.device)[None, :] <= q_pos[:, None]
    s = torch.where(keep, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v_all)


@dataclass
class MeshPlan:
    """What one rank runs on ``mesh``: its groups, blocks and attention."""

    attn_fn: callable
    model_group: object | None  # None without tensor parallelism
    reduce_groups: list  # seq, then the batch axes, each of size > 1
    tp: int
    n_seq: int
    seq_index: int
    n_batch: int
    batch_index: int
    model_index: int


def mesh_plan(cfg, mesh, sequence_parallel: str = "auto", attention: str = "dense") -> MeshPlan:
    """This rank's plan, with the reference's scheme choice and refusals."""
    from k8s_dra_driver_torch.ops.flash_attention import flash_attention
    from k8s_dra_driver_torch.ops.ring_attention import (
        reference_attention,
        ring_attention_local,
        ring_flash_attention_local,
        ulysses_attention_local,
    )

    shape = mesh_shape(mesh)
    batch_axes = ("slice", "data") if "slice" in shape else ("data",)
    n_seq, tp = shape["seq"], shape["model"]
    seq_group = mesh.get_group("seq")
    scheme = sequence_parallel
    if scheme == "auto":
        scheme = "ring" if n_seq > 1 else "none"
    attn_fn = None
    if scheme == "ring":
        ring = ring_flash_attention_local if attention == "flash" else ring_attention_local
        attn_fn = functools.partial(ring, group=seq_group, causal=True)
    elif scheme == "ulysses":
        if tp > 1:
            raise ValueError(
                "ulysses sequence parallelism needs the full head dim per "
                "shard; use model axis 1 or sequence_parallel='ring'"
            )
        attn_fn = functools.partial(
            ulysses_attention_local, group=seq_group, causal=True,
            attn_fn=flash_attention if attention == "flash" else None,
        )
    if attention == "flash" and attn_fn is None:
        if n_seq > 1:
            raise ValueError(
                "attention='flash' with sequence_parallel='none' needs an "
                "unsharded sequence; use sequence_parallel='ring'/'ulysses' "
                "(flash composes with both)"
            )
        attn_fn = functools.partial(flash_attention, causal=True)  # local heads and rows
    if attn_fn is None:
        attn_fn = (functools.partial(_gathered_attention, group=seq_group) if n_seq > 1
                   else functools.partial(reference_attention, causal=True))
    if cfg.n_heads % tp:
        raise ValueError(
            f"tensor parallelism needs n_heads ({cfg.n_heads}) divisible by the model "
            f"axis ({tp}): a shard holds whole query heads"
        )
    seq_index, _ = axis_index(mesh, "seq")
    batch_index, n_batch = axis_index(mesh, batch_axes)
    model_index, _ = axis_index(mesh, "model")
    reduce_groups = [mesh.get_group(a) for a in ("seq", *batch_axes) if shape[a] > 1]
    return MeshPlan(attn_fn, mesh.get_group("model") if tp > 1 else None, reduce_groups, tp,
                    n_seq, seq_index, n_batch, batch_index, model_index)


def _mesh_block(x, p, cfg, plan: MeshPlan, positions):
    """One block on this rank's rows and positions, its heads and FF
    columns those of its ``model`` shard."""
    b, s, _ = x.shape
    g, hd = cfg.kv_groups, cfg.head_dim
    y = _rms_norm(x, p["ln1"])
    qkv = _mm(collectives.pvary(y, plan.model_group), p["qkv"])
    if cfg.kv_heads % plan.tp:
        # fewer KV groups than model ranks: a column shard cuts a group, so
        # the projection is gathered whole (its gradient reduce-scattered
        # back) and this rank attends with its query heads and their groups'
        # K/V, as GSPMD partitions the reference's packed columns
        qkv = collectives.all_gather(qkv, plan.model_group, -1)
    hkv = qkv.shape[-1] // ((g + 2) * hd)
    # group-major columns: per KV group its G query heads, k, v
    qkv = qkv.reshape(b, s, hkv, (g + 2) * hd)
    q = qkv[..., : g * hd].reshape(b, s, hkv * g, hd)
    k, v = qkv[..., g * hd: (g + 1) * hd], qkv[..., (g + 1) * hd:]
    if cfg.rope:
        q, k = rope_rotate(q, positions, cfg), rope_rotate(k, positions, cfg)
    k, v = repeat_kv(k, cfg), repeat_kv(v, cfg)
    if hkv * g != cfg.n_heads // plan.tp:
        heads = slice(plan.model_index * cfg.n_heads // plan.tp,
                      (plan.model_index + 1) * cfg.n_heads // plan.tp)
        q, k, v = q[:, :, heads], k[:, :, heads], v[:, :, heads]
    attn = plan.attn_fn(q, k, v).reshape(b, s, -1)
    x = x + collectives.psum(_mm(attn, p["attn_out"]), plan.model_group)
    return mlp_residual(x, p, top_k=cfg.moe_top_k, group=plan.model_group)


def _local_tokens(rows, plan: MeshPlan):
    """(this rank's input block ``[b, s]``, its targets, its first
    position) from its batch ``rows``: its positions, and the next token of
    each position from the whole sequence (the last position has none)."""
    s_loc = rows.shape[1] // plan.n_seq
    lo = plan.seq_index * s_loc
    return rows[:, lo: lo + s_loc], rows[:, lo + 1: lo + s_loc + 1], lo


def mesh_loss(params, tokens, cfg, plan: MeshPlan, remat: str = "blocks"):
    """This rank's part of the global mean NLL of ``tokens`` (the whole
    batch, or this rank's ``data.RowBlock`` of it): its targets' NLL sum
    over its rows x (S - 1).  Summed over ``seq`` and averaged over the
    batch axes it is the reference's ``loss_fn``."""
    b_all, s_all = tokens.shape
    if b_all % plan.n_batch or s_all % plan.n_seq:
        raise ValueError(
            f"tokens {tuple(tokens.shape)} do not split into {plan.n_batch} batch and "
            f"{plan.n_seq} sequence blocks"
        )
    rows, _ = local_rows(tokens, plan.n_batch, plan.batch_index)
    inputs, targets, lo = _local_tokens(rows, plan)
    b, s = inputs.shape
    positions = lo + torch.arange(s, dtype=torch.int32, device=rows.device)
    table = params["embed"]
    if plan.model_group is not None:
        table = _GatherVocab.apply(table, plan.model_group)
    x = table[inputs]
    if not cfg.rope:
        x = x + params["pos_embed"][lo: lo + s]
    block = _wrap_remat(functools.partial(_mesh_block, cfg=cfg, plan=plan,
                                          positions=positions), remat)
    for p in params["blocks"]:
        x = block(x, p)
    logits = tied_logits(x, {"ln_f": params["ln_f"], "embed": table})
    logp = torch.log_softmax(logits[:, : targets.shape[1]], dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long()).sum()
    return nll / (b * (s_all - 1))


def reduce_fn(plan: MeshPlan):
    """``reduce(tensors) -> tensors``: each summed over ``seq`` and averaged
    over the batch axes, flattened into one buffer per dtype, one
    all-reduce per axis."""

    def reduce(tensors):
        out = collectives.all_reduce_buckets(tensors, lambda i: plan.reduce_groups)
        return [t / plan.n_batch for t in out] if plan.n_batch > 1 else out

    return reduce


def reduced_grads(loss_fn, reduce, params, tokens):
    """``loss_fn(params, tokens)`` and its gradient (a tree like ``params``),
    both passed through ``reduce`` (``[loss, *param_leaves]``), with no
    update: the part of a step the mesh steps share."""
    loss, grads = value_and_grad(loss_fn, params, tokens)
    loss, *leaves = reduce([loss, *param_leaves(grads)])
    return loss, _unflatten(params, iter(leaves))


def loss_and_grads(params, tokens, cfg, plan: MeshPlan, remat: str = "blocks"):
    """The global loss and this rank's gradient shards (a tree like
    ``params``), as one step of the mesh branch computes them, with no
    update."""
    return reduced_grads(functools.partial(mesh_loss, cfg=cfg, plan=plan, remat=remat),
                         reduce_fn(plan), params, tokens)


def nccl_mesh(mesh) -> bool:
    """True where every axis group of ``mesh`` is NCCL, whose collectives
    a CUDA graph captures; a gloo group stages CUDA tensors through pinned
    host memory and waits on the host, which no graph holds."""
    import torch.distributed as dist

    return all(dist.get_backend(mesh.get_group(name)) == "nccl"
               for name in mesh.mesh_dim_names)


def train_step_fns(cfg, loss_fn, reduce, shard, lr: float, device, mesh,
                   accum_steps: int = 1, capture=None,
                   name: str = "mesh train step") -> TrainStepFns:
    """The ``(init, step)`` shell of the mesh steps.  ``init(generator)``
    draws the whole model on the generator's device (the same seed on every
    rank), moves it to ``device`` and keeps ``shard(full)``, this rank's
    shards, with AdamW's state; ``step(params, opt_state, tokens)`` takes
    the whole batch or this rank's ``data.RowBlock`` of it (gathered whole
    first under accumulation, whose microbatches interleave the whole
    batch's rows), runs ``loss_fn`` and ``reduce`` (``make_sgd_step``),
    updates the shards IN PLACE and returns the global mean loss (the same
    on every rank) as a device tensor.

    On an NCCL ``mesh`` (:func:`nccl_mesh`) the step is one CUDA graph, the
    reference's jitted step with its donation: ``graphed`` holds a
    ``burnin.GraphedTrainStep`` named ``name`` (call 1 eager, call 2
    captures and replays, later calls replay; ``captures`` counts), which
    copies the batch or the block's rows into one token buffer; the
    accumulation's gather, the collectives and the update run inside the
    graph.  On gloo the step stays eager (``graphed`` None), decided here
    from the backend, never by a capture that failed.  ``capture``, where
    given, graphs the step through that capturing function on any backend
    (a stand-in in the CPU tests); ``graphs.disable_graphs()`` runs a
    graphed step eagerly."""
    from k8s_dra_driver_torch.device import params_device

    opt = make_optimizer(lr)

    def init(generator: torch.Generator):
        full = init_params(generator, cfg)
        params_device(full, device)
        params = shard(full)
        return params, opt.init(params)

    sgd = make_sgd_step(loss_fn, opt, accum_steps=accum_steps, reduce=reduce)

    def run(params, opt_state, tokens):
        if accum_steps > 1 and isinstance(tokens, RowBlock):
            tokens = tokens.whole()
        return sgd(params, opt_state, tokens)

    if capture is None and nccl_mesh(mesh):
        capture = cuda_capture
    graphed = None if capture is None else GraphedTrainStep(run, device, capture, name)

    def step(params, opt_state, tokens):
        params_device(params, device)
        tokens = as_batch(tokens, device)
        if graphed is not None and graphs_enabled():
            return graphed(params, opt_state, tokens)
        return run(params, opt_state, tokens)

    return TrainStepFns(init=init, step=step, graphed=graphed)


def build_mesh_train_step(cfg, mesh, lr: float = 3e-4, sequence_parallel: str = "auto",
                          attention: str = "dense", accum_steps: int = 1,
                          remat: str = "blocks", device=None, capture=None) -> TrainStepFns:
    """``(init, step)`` of the mesh branch for this rank
    (:func:`train_step_fns`: one CUDA graph on NCCL, eager on gloo): the
    shards are ``weights.shard_params``'."""
    from k8s_dra_driver_torch.models.weights import shard_params

    plan = mesh_plan(cfg, mesh, sequence_parallel, attention)
    return train_step_fns(
        cfg, functools.partial(mesh_loss, cfg=cfg, plan=plan, remat=remat), reduce_fn(plan),
        lambda full: shard_params(cfg, mesh, full)[0], lr, device, mesh, accum_steps,
        capture)
