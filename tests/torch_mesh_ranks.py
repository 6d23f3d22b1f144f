"""Functions the mesh tests run on every rank of a ``RankPool``.

Spawned ranks import this module by name, so it imports torch, numpy and
the port only (never JAX).  Each function builds its mesh on the CPU ranks
(cached per layout), runs its case on this rank's blocks, and returns numpy
arrays that the test reassembles with ``parallel.mesh.unshard``.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from k8s_dra_driver_torch.parallel import mesh as pm

_MESHES: dict = {}


def make_mesh(layout):
    """``layout``: ``(n_slices, {MeshShape fields})``; n_slices 0 builds the
    plain 4-axis mesh."""
    key = (layout[0], tuple(sorted(layout[1].items())))
    if key not in _MESHES:
        import torch.distributed as dist

        ranks = list(range(dist.get_world_size()))
        shape = pm.MeshShape(**layout[1])
        _MESHES[key] = (pm.build_multislice_mesh(ranks, layout[0], shape, "cpu") if layout[0]
                        else pm.build_mesh(ranks, shape, "cpu"))
    return _MESHES[key]


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    return tree.detach().cpu().float().numpy()


def mesh_layout(layout):
    """The mesh's rank array, axis names, this rank's coordinate and the
    group ranks of each axis."""
    import torch.distributed as dist

    mesh = make_mesh(layout)
    groups = {name: dist.get_process_group_ranks(mesh.get_group(name))
              for name in mesh.mesh_dim_names}
    return mesh.mesh.tolist(), mesh.mesh_dim_names, mesh.get_coordinate(), groups


def shard_roundtrip(layout, spec, x):
    """(this rank's block of ``x`` under ``spec``, the all-gathered whole)."""
    mesh = make_mesh(layout)
    block = pm.shard(torch.from_numpy(x), mesh, pm.P(*spec))
    return block.numpy(), pm.gather(block, mesh, pm.P(*spec)).numpy()


def attention_case(layout, kind, spec, q, k, v, causal, dtype="float32", grads=True):
    """One attention scheme on this rank's blocks of q/k/v: (out block,
    and with ``grads`` the blocks of the gradients of sum(out²))."""
    from k8s_dra_driver_torch.ops import flash_attention as fa
    from k8s_dra_driver_torch.ops import ring_attention as ra

    mesh = make_mesh(layout)
    fns = {
        "ring": ra.ring_attention,
        "ring_flash": ra.ring_flash_attention,
        "ulysses": ra.ulysses_attention,
        "ulysses_flash": functools.partial(ra.ulysses_attention, use_flash=True),
        # the per-rank body of the reference's sharded flash takes no mesh
        "sharded_flash": lambda q, k, v, mesh, causal: fa.sharded_flash_attention(q, k, v, causal),
    }
    blocks = [pm.shard(torch.from_numpy(x), mesh, pm.P(*spec)).to(getattr(torch, dtype))
              .requires_grad_(grads) for x in (q, k, v)]
    out = fns[kind](*blocks, mesh=mesh, causal=causal)
    result = [out.detach().float().numpy()]
    if grads:
        out.float().square().sum().backward()
        result += [b.grad.float().numpy() for b in blocks]
    return result


def _train_setup(cfg_kw, layout, params):
    from k8s_dra_driver_torch.models import burnin, weights

    cfg = burnin.ModelConfig(**{**cfg_kw, "dtype": torch.float32})
    mesh = make_mesh(layout)
    full = weights.params_from_jax(params, "cpu")
    return cfg, mesh, full


def train_case(cfg_kw, layout, params, tokens, steps, **kw):
    """``steps`` mesh steps from ``params`` (numpy, the whole model) on
    ``tokens`` (the whole batch): (the losses, rank 0's unsharded params
    after them, rank 0's unsharded step-1 gradients, before any update;
    the others return None for both)."""
    import torch.distributed as dist

    from k8s_dra_driver_torch.models import burnin, mesh_train, weights

    cfg, mesh, full = _train_setup(cfg_kw, layout, params)
    tokens = torch.from_numpy(tokens)
    fns = burnin.build_train_step(cfg, mesh=mesh, device="cpu", **kw)
    local, _ = weights.shard_params(cfg, mesh, full)
    plan = mesh_train.mesh_plan(cfg, mesh, kw.get("sequence_parallel", "auto"),
                                kw.get("attention", "dense"))
    _, grads = mesh_train.loss_and_grads(local, tokens, cfg, plan, kw.get("remat", "blocks"))
    grads, _ = weights.unshard_params(cfg, mesh, grads)
    state = burnin.make_optimizer(kw.get("lr", 3e-4)).init(local)
    losses = [float(fns.step(local, state, tokens)[2]) for _ in range(steps)]
    after, _ = weights.unshard_params(cfg, mesh, local)
    if dist.get_rank():
        return losses, None, None
    return losses, numpy_tree(after), numpy_tree(grads)


def train_refusal(cfg_kw, layout, **kw):
    """The message ``build_train_step`` raises on this mesh, or None."""
    from k8s_dra_driver_torch.models import burnin

    cfg = burnin.ModelConfig(**{**cfg_kw, "dtype": torch.float32})
    try:
        burnin.build_train_step(cfg, mesh=make_mesh(layout), device="cpu", **kw)
    except ValueError as exc:
        return str(exc)
    return None


def params_roundtrip(cfg_kw, layout, params, state):
    """shard_params then unshard_params of the whole ``params`` and an
    AdamW state (numpy): (this rank's qkv block, the whole tree back, the
    state back)."""
    from k8s_dra_driver_torch.models import weights

    cfg, mesh, full = _train_setup(cfg_kw, layout, params)
    opt = {"count": torch.tensor(3, dtype=torch.int32),
           "mu": [torch.from_numpy(x) for x in state["mu"]],
           "nu": [torch.from_numpy(x) for x in state["nu"]]}
    local, local_opt = weights.shard_params(cfg, mesh, full, opt)
    back, back_opt = weights.unshard_params(cfg, mesh, local, local_opt)
    return (local["blocks"][0]["qkv"].numpy(), numpy_tree(back),
            {"count": int(back_opt["count"]), "mu": numpy_tree(back_opt["mu"]),
             "nu": numpy_tree(back_opt["nu"])})


def probe_results(layout):
    """The bandwidth probes over each axis of size > 1, tiny payloads."""
    from k8s_dra_driver_torch.ops import collectives as co

    mesh = make_mesh(layout)
    out = [co.psum_bandwidth(mesh, "model", mib=1, dtype=torch.float32, iters=2),
           co.all_gather_bandwidth(mesh, "model", mib=1, dtype=torch.float32, iters=2),
           co.all_to_all_bandwidth(mesh, "data", mib=1, dtype=torch.float32, iters=2)]
    return out, co.ring_latency_us(mesh, "model", iters=3), co.summarize(out)


def _outcome(fn, *args):
    import re

    try:
        return fn(*args)
    except ValueError as exc:
        return type(exc).__name__, re.sub(r"\(mesh has .*\)", "", str(exc))


def mesh_checks(layout, slot_axes, bounds):
    """``slot_axis_size`` for each of ``slot_axes`` and
    ``validate_claimed_mesh`` for each env of ``bounds``: results or
    (exception name, message)."""
    mesh = make_mesh(layout)
    return ([_outcome(pm.slot_axis_size, mesh, a) for a in slot_axes],
            [_outcome(pm.validate_claimed_mesh, mesh, b) for b in bounds])


def consumer_mesh(env):
    """The mesh ``consumer.attach(environ=env).build_mesh()`` builds on the
    CPU: its rank array and axis names."""
    from k8s_dra_driver_torch import consumer

    mesh = consumer.attach(environ=env, init_distributed=False).build_mesh(device_type="cpu")
    return mesh.mesh.tolist(), mesh.mesh_dim_names


def build_stand_in(tmpdir, compiler):
    """Every rank builds ``csrc/stand_in.cu`` under ``tmpdir`` through the
    stand-in ``compiler`` at once; the size of the library each then finds."""
    from pathlib import Path

    import torch.distributed as dist

    from k8s_dra_driver_torch.ops import _build

    old = (_build.CSRC, _build.BUILD_DIR, _build.nvcc_path)
    _build.CSRC, _build.BUILD_DIR = Path(tmpdir) / "csrc", Path(tmpdir) / "build"
    _build.nvcc_path = lambda: compiler
    try:
        dist.barrier()
        _build.build(["stand_in"])
        return _build.library_path("stand_in").stat().st_size
    finally:
        _build.CSRC, _build.BUILD_DIR, _build.nvcc_path = old


def _collective_fns():
    from k8s_dra_driver_torch.ops import collective_matmul as cm

    def ring(fn):
        # the leading dim is the data axis's block (one slice a rank), the
        # ring runs over ``model``
        return lambda *xs, mesh, **kw: fn(*(x[0] for x in xs), mesh.get_group("model"),
                                          **kw)[None]

    return {
        "all_gather_matmul": ring(cm.all_gather_matmul),
        "matmul_reduce_scatter": ring(cm.matmul_reduce_scatter),
        "tp_mlp": ring(cm.tp_mlp),
        "sharded_tp_mlp": cm.sharded_tp_mlp,
    }


def spec_case(layout, name, arrays, specs, out_spec, ct, dtype="float32", **kw):
    """``name`` (a function of ``ops/collective_matmul``) on this rank's
    blocks of ``arrays`` under ``specs``: (its output block, the blocks of
    the gradients of ``sum(out · ct)`` for each input), ``ct`` the whole
    cotangent, cut here by ``out_spec``; or the message of the ValueError
    it raises."""
    mesh = make_mesh(layout)
    blocks = [pm.shard(torch.from_numpy(a), mesh, pm.P(*s)).to(getattr(torch, dtype))
              .requires_grad_() for a, s in zip(arrays, specs)]
    try:
        out = _collective_fns()[name](*blocks, mesh=mesh, **kw)
    except ValueError as exc:
        return str(exc)
    (out.float() * pm.shard(torch.from_numpy(ct), mesh, pm.P(*out_spec))).sum().backward()
    return [out.detach().float().numpy()] + [b.grad.float().numpy() for b in blocks]


def pipeline_case(layout, ws, xs, ct):
    """``pipeline_apply`` of a tanh stage (``tanh(x @ w)``, one matrix a
    stage: this rank's block of ``ws`` over ``pipe``) on the whole ``xs``:
    (the output, this rank's gradient of its stage matrix, the gradient of
    ``xs`` summed over ``pipe``), for ``sum(out · ct)``."""
    from k8s_dra_driver_torch.ops import collectives
    from k8s_dra_driver_torch.ops.pipeline import pipeline_apply

    mesh = make_mesh(layout)
    w = pm.shard(torch.from_numpy(ws), mesh, pm.P("pipe")).requires_grad_()
    x = torch.from_numpy(xs).requires_grad_()
    group = mesh.get_group("pipe")
    out = pipeline_apply(lambda p, y: torch.tanh(y @ p[0]), w, x, group)
    (out * torch.from_numpy(ct)).sum().backward()
    return (out.detach().numpy(), w.grad.numpy(),
            collectives.all_reduce_raw(x.grad.clone(), group).numpy())


def pp_train_case(cfg_kw, layout, params, tokens, steps, **kw):
    """``steps`` pipeline steps (``build_pp_train_step(**kw)``) from the
    dense ``params`` (numpy) on ``tokens`` (the whole batch): (the losses,
    rank 0's dense params after them, rank 0's dense step-1 gradients;
    the others return None for both)."""
    import torch.distributed as dist

    from k8s_dra_driver_torch.models import burnin, pp_burnin, weights

    cfg, mesh, full = _train_setup(cfg_kw, layout, params)
    tokens = torch.from_numpy(tokens)
    fns = pp_burnin.build_pp_train_step(cfg, mesh, device="cpu", **kw)
    local, _ = weights.shard_pipeline_params(cfg, mesh, pp_burnin.pp_params_from_dense(full, cfg))
    plan = pp_burnin.pp_plan(cfg, mesh, kw.get("n_micro"), kw.get("tp_mode", "megatron"))
    _, grads = pp_burnin.loss_and_grads(local, tokens, cfg, plan)
    grads = weights.dense_params(cfg, weights.unshard_pipeline_params(cfg, mesh, grads)[0])
    state = burnin.make_optimizer(kw.get("lr", 3e-4)).init(local)
    losses = [float(fns.step(local, state, tokens)[2]) for _ in range(steps)]
    after = weights.dense_params(cfg, weights.unshard_pipeline_params(cfg, mesh, local)[0])
    if dist.get_rank():
        return losses, None, None
    return losses, numpy_tree(after), numpy_tree(grads)


def pp_refusal(cfg_kw, layout, tokens=None, init=False, **kw):
    """The message ``build_pp_train_step`` raises on this mesh (at build,
    at ``init`` with ``init``, or at the first step on ``tokens``), or
    None."""
    from k8s_dra_driver_torch.models import burnin, pp_burnin

    cfg = burnin.ModelConfig(**{**cfg_kw, "dtype": torch.float32})
    try:
        fns = pp_burnin.build_pp_train_step(cfg, make_mesh(layout), device="cpu", **kw)
        if init or tokens is not None:
            params, state = fns.init(torch.Generator().manual_seed(0))
        if tokens is not None:
            fns.step(params, state, torch.from_numpy(tokens))
    except ValueError as exc:
        return str(exc)
    return None


def _moe_blocks(mesh, x, wr, wu, wd):
    """This rank's blocks of the whole MoE tensors: its rows of ``x``, the
    router whole, its experts of ``wu`` and ``wd``."""
    n = pm.mesh_shape(mesh)["data"]
    idx, _ = pm.axis_index(mesh, "data")
    t_loc, e_loc = x.shape[0] // n, wu.shape[0] // n
    return (x[idx * t_loc:(idx + 1) * t_loc], wr, wu[idx * e_loc:(idx + 1) * e_loc],
            wd[idx * e_loc:(idx + 1) * e_loc])


def moe_case(layout, x, wr, wu, wd, ct, capacity_factor, k):
    """``topk_moe`` over ``data`` on this rank's blocks of the whole
    tensors: (its output block, its gradients of its blocks of x, w_router
    (whole: its tokens' part), w_up and w_down for ``sum(out · ct)``, ``ct``
    its rows of the whole cotangent, its tokens' expert choices and kept
    copies)."""
    from k8s_dra_driver_torch.ops import moe

    mesh = make_mesh(layout)
    ins = [torch.from_numpy(a).requires_grad_()
           for a in _moe_blocks(mesh, x, wr, wu, wd)]
    out = moe.topk_moe(*ins, mesh=mesh, capacity_factor=capacity_factor, k=k)
    n = pm.mesh_shape(mesh)["data"]
    idx, _ = pm.axis_index(mesh, "data")
    t_loc = x.shape[0] // n
    (out * torch.from_numpy(ct[idx * t_loc:(idx + 1) * t_loc])).sum().backward()
    capacity = moe.moe_capacity(capacity_factor, t_loc, k, wu.shape[0])
    _, experts, _, keep = moe.route(ins[0].detach(), ins[1].detach(), wu.shape[0], capacity, k)
    return ([out.detach().numpy()] + [t.grad.numpy() for t in ins]
            + [experts.numpy(), keep.numpy()])


def moe_refusal(layout, shapes, k):
    """The message ``topk_moe`` raises on this rank's blocks of tensors of
    ``shapes`` (x, w_router, w_up, w_down), or None."""
    from k8s_dra_driver_torch.ops import moe

    try:
        mesh = make_mesh(layout)
        moe.topk_moe(*_moe_blocks(mesh, *(torch.zeros(s) for s in shapes)), mesh=mesh, k=k)
    except ValueError as exc:
        return str(exc)
    return None


# -- slot-sharded serving ------------------------------------------------------

def fifo_streams(engine, reqs, max_steps: int = 10_000, step=None) -> dict:
    """``reqs`` (``(prompt, max_tokens, submit kwargs)``) through a FIFO
    queue in front of ``engine``, one ``step()`` between admission rounds
    (the reference's sharded tests' harness): ``{request_id: (generated,
    status)}``."""
    pending, out = list(reqs), {}
    step = step or engine.step
    for _ in range(max_steps):
        while pending:
            prompt, max_tokens, kw = pending[0]
            try:
                engine.submit(prompt, max_tokens, **kw)
            except RuntimeError:
                break
            pending.pop(0)
        stepped = step()
        for c in engine.completions():
            out[c.request_id] = (c.generated, c.status)
        if (not pending and stepped == 0 and engine.free_slots() == engine.n_slots
                and not getattr(engine, "_preempted", None)
                and not getattr(engine, "_admitting", None)):
            return out
    raise RuntimeError("queue did not drain")


# EngineStats fields that count (the rest are clocks, or the engine's
# process-wide sequence number)
STATS_COUNTERS = ("n_slots", "resident_slots", "free_slots", "queue_depth", "admitting",
                  "preempted", "free_blocks", "quarantined", "shed_count", "in_flight",
                  "completed", "statuses", "tokens_generated", "bursts", "host_syncs",
                  "sync_interval")
ENGINE_COUNTERS = ("host_syncs", "prefix_hits", "prefix_misses", "free_blocks",
                   "reservable_blocks", "preempted_count", "stalled_steps", "spec_drafted",
                   "spec_accepted")


def engine_counters(engine) -> dict:
    """The engine's host counters and its ``stats()`` counters."""
    stats = engine.stats().to_json()
    out = {k: getattr(engine, k) for k in ENGINE_COUNTERS if hasattr(engine, k)}
    out.update({f"stats.{k}": stats[k] for k in STATS_COUNTERS})
    return out


def serving_engine(kind, cfg, params, mesh=None, slot_axis="data", bank=None, **kw):
    """A port engine (``kind`` "paged" or "dense") on the CPU from numpy
    ``params`` (and a numpy LoRA ``bank``), on ``mesh`` when given."""
    from k8s_dra_driver_torch.models import paged, serve, weights

    if bank is not None:
        kw["adapter_bank"] = weights.bank_from_jax(bank, "cpu")
    cls = paged.PagedServeEngine if kind == "paged" else serve.ServeEngine
    return cls(params=weights.params_from_jax(params, "cpu"), cfg=cfg, mesh=mesh,
               slot_axis=slot_axis, device="cpu", **kw)


def sharded_streams(kind, cfg, layout, slot_axis, params, engine_kw, reqs, bank=None,
                    burst=False):
    """``reqs`` through a sharded engine on this rank (``step`` between
    admission rounds, ``step_burst`` with ``burst``): (its streams, its
    counters, the bytes its collectives sent by kind)."""
    from k8s_dra_driver_torch.ops import collectives

    collectives.reset_counts()
    eng = serving_engine(kind, cfg, params, make_mesh(layout), slot_axis, bank, **engine_kw)
    streams = fifo_streams(eng, reqs, step=eng.step_burst if burst else None)
    return streams, engine_counters(eng), dict(collectives.comm_bytes)


def engine_refusal(kind, cfg, layout, slot_axis, params, engine_kw):
    """(the exception's type name, its message) a sharded engine raises at
    construction, or None."""
    try:
        serving_engine(kind, cfg, params, make_mesh(layout), slot_axis, **engine_kw)
    except (TypeError, ValueError) as exc:
        return type(exc).__name__, str(exc)
    return None


def capacity_case(cfg, layout, params, engine_kw, big, prompts):
    """A paged engine sharded over ``data``: the refusal of the prompt
    ``big`` (None: none) that fits no shard (its message, the free blocks
    after it), then each of ``prompts`` submitted: the shards their slots
    fall in, the free and reservable blocks."""
    eng = serving_engine("paged", cfg, params, make_mesh(layout), **engine_kw)
    refused = None
    if big is not None:
        try:
            eng.submit(big, 4)
        except RuntimeError as exc:
            refused = str(exc)
    free_after = eng.free_blocks
    for p in prompts:
        eng.submit(p, 4)
    groups = sorted({eng._group(s) for s, st in enumerate(eng._slots) if st is not None})
    return refused, free_after, groups, eng.free_blocks, eng.reservable_blocks


def payload_case(kind, cfg, layout, params, engine_kw, reqs, handoff_prompt, steps: int):
    """The payload paths of a sharded engine (or, ``layout`` None, the
    unsharded one): ``reqs`` submitted, ``steps`` steps, a
    ``snapshot_active(include_kv=True)`` (each entry's K/V as numpy), then
    ``handoff_prompt`` handed off (the slot it took, its payload), then the
    snapshot restored, payloads and all, into a fresh engine of the same
    kind and drained:
    (snapshot entries without their payloads, their payloads, the handoff's
    slot and payload, the restored streams, the counters of both engines)."""
    mesh = None if layout is None else make_mesh(layout)
    eng = serving_engine(kind, cfg, params, mesh, **engine_kw)
    for prompt, max_tokens, kw in reqs:
        eng.submit(prompt, max_tokens, **kw)
    for _ in range(steps):
        eng.step()
    snap = eng.snapshot_active(include_kv=True)
    kvs = {r["request_id"]: (r["kv"].k, r["kv"].v) for r in snap["requests"] if "kv" in r}
    entries = [{k: v for k, v in r.items() if k not in ("kv", "trace")} for r in snap["requests"]]
    slots, retire = [], eng._handoff_retire
    eng._handoff_retire = lambda slot, *a: (slots.append(slot), retire(slot, *a))[1]
    rid = eng.submit(handoff_prompt, 4, handoff=True)
    (entry,) = eng.take_handoffs()
    handoff = (rid, slots[0], entry["kv"].k, entry["kv"].v)
    counters = engine_counters(eng)
    eng.release_active()
    fresh = serving_engine(kind, cfg, params, mesh, **engine_kw)
    fresh.restore(snap)  # the payloads inject where they fit
    fresh.run_until_drained()
    streams = {c.request_id: (c.generated, c.status) for c in fresh.completions()}
    return entries, kvs, handoff, streams, counters, engine_counters(fresh)


# -- the host-sharded token pipeline -------------------------------------------

def token_batches_case(layout, data, batch_size, seed, epochs, data_axis="data"):
    """This rank's ``TokenBatches`` blocks: (steps a epoch, and per epoch
    in ``epochs`` the blocks' (rows, global shape, index, count))."""
    from k8s_dra_driver_torch.models.data import TokenBatches

    tb = TokenBatches(data, batch_size, make_mesh(layout), data_axis, seed=seed, device="cpu")
    return tb.steps_per_epoch, [
        [(b.rows.numpy(), b.shape, b.index, b.count) for b in tb.epoch(e)] for e in epochs]


def token_batches_refusal(layout, data, batch_size, data_axis="data"):
    """The message ``TokenBatches`` raises, or None."""
    from k8s_dra_driver_torch.models.data import TokenBatches

    try:
        TokenBatches(data, batch_size, make_mesh(layout), data_axis, device="cpu")
    except ValueError as exc:
        return str(exc)
    return None


def fed_train_case(kind, cfg_kw, layout, data, batch_size, steps, **kw):
    """``steps`` steps of the mesh step (``kind`` "mesh") or the pipeline
    step ("pp") fed this rank's ``TokenBatches`` blocks of epoch 0, then the
    same steps from the same init fed the whole batches (computed here from
    the reference's permutation): (the losses of both, the bytes each run
    all-gathered)."""
    import numpy as np

    from k8s_dra_driver_torch.models import burnin, pp_burnin
    from k8s_dra_driver_torch.models.data import TokenBatches
    from k8s_dra_driver_torch.ops import collectives

    cfg = burnin.ModelConfig(**{**cfg_kw, "dtype": torch.float32})
    mesh = make_mesh(layout)
    if kind == "pp":
        fns = pp_burnin.build_pp_train_step(cfg, mesh, device="cpu", **kw)
    else:
        fns = burnin.build_train_step(cfg, mesh=mesh, device="cpu", **kw)
    order = np.random.default_rng((0, 0)).permutation(len(data))
    wholes = [torch.from_numpy(data[order[s * batch_size:(s + 1) * batch_size]])
              for s in range(steps)]
    blocks = list(TokenBatches(data, batch_size, mesh, seed=0, device="cpu").epoch(0))[:steps]
    out = []
    for feed in (blocks, wholes):
        collectives.reset_counts()
        params, state = fns.init(torch.Generator().manual_seed(0))
        out.append([float(fns.step(params, state, b)[2]) for b in feed])
        out.append(collectives.comm_bytes["all_gather"])
    return out[0], out[2], out[1], out[3]


class HostTraffic(TorchDispatchMode):
    """A dispatch mode that refuses what a CUDA graph cannot hold: a read
    of the device from the host (``.item()``), data copied from the host
    (``torch.tensor(x, device=...)``) and a data-dependent shape
    (``nonzero``, a boolean-mask index)."""

    REFUSED = ("aten._local_scalar_dense.default", "aten.lift_fresh.default",
               "aten.nonzero.default")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        masked = func is torch.ops.aten.index.Tensor and any(
            t is not None and t.dtype == torch.bool for t in args[1])
        if str(func) in self.REFUSED or masked:
            raise RuntimeError(f"{func} moves data between the host and the device: "
                               f"a CUDA graph cannot hold it")
        return func(*args, **(kwargs or {}))


def _counters() -> dict:
    from k8s_dra_driver_torch.models import graphs
    from k8s_dra_driver_torch.ops import collectives

    return {**graphs.launch_counts(), **collectives.byte_counts()}


def _add_counters(delta: dict) -> None:
    from k8s_dra_driver_torch.models import graphs
    from k8s_dra_driver_torch.ops import collectives

    graphs.add_launch_counts(delta)
    collectives.add_byte_counts(delta)


class _Replay:
    """A captured graph's stand-in: a replay reruns the program with every
    counter held (a replay runs no Python) and leaves its result in the
    captured output."""

    def __init__(self, fn, out):
        self.fn, self.out, self.replays = fn, out, 0

    def replay(self):
        before = _counters()
        result = self.fn()
        _add_counters({k: before[k] - n for k, n in _counters().items()})
        with torch.no_grad():
            self.out.copy_(result)
        self.replays += 1


class StandInCapture:
    """A capture that behaves on the CPU as a CUDA capture does: ``fn``'s
    Python runs once under :class:`HostTraffic` (the counters move, which
    the graph holder takes back), and the tensors of ``keep`` (the step's
    params and optimizer state, set after ``init``) are left as they were,
    since a capture runs no kernel.  ``fail``: raise after the Python ran,
    as a ``capture_end`` that fails."""

    def __init__(self, fail: bool = False):
        self.keep: list = []
        self.fail = fail
        self.graphs: list = []

    def __call__(self, fn, device):
        saved = [t.clone() for t in self.keep]
        with HostTraffic():
            out = fn()
        with torch.no_grad():
            for t, s in zip(self.keep, saved):
                t.copy_(s)
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        self.graphs.append(_Replay(fn, out))
        return self.graphs[-1], out


def _graph_twins(kind, cfg_kw, layout, params, **kw):
    """(cfg, mesh, a graphed step on a :class:`StandInCapture`, its
    capture, its eager twin, the sharded params of each, their optimizer
    states), ``kind`` "mesh" or "pp", both from the whole ``params``."""
    from k8s_dra_driver_torch.models import burnin, mesh_train, pp_burnin, weights

    cfg, mesh, full = _train_setup(cfg_kw, layout, params)
    cap = StandInCapture(kw.pop("fail", False))
    if kind == "pp":
        def build(**extra):
            return pp_burnin.build_pp_train_step(cfg, mesh, device="cpu", **kw, **extra)

        def shard():
            return weights.shard_pipeline_params(cfg, mesh,
                                                 pp_burnin.pp_params_from_dense(full, cfg))[0]
    else:
        def build(**extra):
            return mesh_train.build_mesh_train_step(cfg, mesh, device="cpu", **kw, **extra)

        def shard():
            return weights.shard_params(cfg, mesh, full)[0]
    graphed, eager = build(capture=cap), build()
    states = []
    for _ in range(2):
        local = shard()
        states.append((local, burnin.make_optimizer().init(local)))
    cap.keep = burnin._state_tensors(*states[0])
    return cfg, mesh, graphed, cap, eager, states


def _feed(tokens, mesh, feed: str):
    """The batch as the step takes it: ``"whole"``, or ``"blocks"``, this
    rank's ``data.RowBlock`` over ``data``."""
    from k8s_dra_driver_torch.models.data import RowBlock

    tokens = torch.from_numpy(tokens)
    if feed == "whole":
        return tokens
    index, count = pm.axis_index(mesh, "data")
    return RowBlock(tokens.chunk(count, 0)[index], tokens.shape[0], index, count, ("data",), mesh)


def graph_case(kind, cfg_kw, layout, params, tokens, steps, feed="whole", **kw):
    """``steps`` steps of the graphed step and of its eager twin on
    ``tokens`` (fed as :func:`_feed` gives them), the byte counters zeroed
    before each run: (the graphed losses, the eager ones, whether every
    shard and optimizer tensor is bit for bit its twin's, captures, the
    program's calls, the stand-in graph's replays, the bytes each run sent
    and copied through the host by kind, rank 0's unsharded params after
    the graphed run, dense for the pipeline; the others None)."""
    import torch.distributed as dist

    from k8s_dra_driver_torch.models import burnin, weights
    from k8s_dra_driver_torch.ops import collectives

    cfg, mesh, graphed, cap, eager, states = _graph_twins(kind, cfg_kw, layout, params, **kw)
    batch = _feed(tokens, mesh, feed)
    out = []
    for fns, (local, state) in zip((graphed, eager), states):
        collectives.reset_counts()
        out.append([float(fns.step(local, state, batch)[2]) for _ in range(steps)])
        out.append((dict(collectives.comm_bytes), dict(collectives.host_bytes)))
    (g_local, g_state), (e_local, e_state) = states
    same = all(torch.equal(a, b) for a, b in zip(burnin._state_tensors(g_local, g_state),
                                                   burnin._state_tensors(e_local, e_state)))
    if kind == "pp":
        after = weights.dense_params(cfg, weights.unshard_pipeline_params(cfg, mesh, g_local)[0])
    else:
        after = weights.unshard_params(cfg, mesh, g_local)[0]
    return dict(graphed=out[0], eager=out[2], same=same, captures=graphed.captures,
                calls=graphed.graphed.program.calls, replays=cap.graphs[0].replays,
                bytes_graphed=out[1], bytes_eager=out[3], eager_holder=eager.graphed,
                after=numpy_tree(after) if dist.get_rank() == 0 else None)


def recapture_case(cfg_kw, layout, params, tokens):
    """The graphed mesh step's captures after 3 calls, then 2 calls on a
    longer batch, then 2 on another params tree, with the stand-in graphs
    made and the program's calls."""
    from k8s_dra_driver_torch.models import burnin

    cfg, mesh, graphed, cap, _, states = _graph_twins("mesh", cfg_kw, layout, params)
    (local, state), (other, other_state) = states
    short = torch.from_numpy(tokens[:, :16])
    whole = torch.from_numpy(tokens)
    seen = []
    for args, calls in (((local, state, short), 3), ((local, state, whole), 2)):
        for _ in range(calls):
            graphed.step(*args)
        seen.append(graphed.captures)
    cap.keep = burnin._state_tensors(other, other_state)
    for _ in range(2):
        graphed.step(other, other_state, whole)
    seen.append(graphed.captures)
    return seen, len(cap.graphs), graphed.graphed.program.calls


def failed_capture_case(kind, cfg_kw, layout, params, tokens, **kw):
    """A capture that raises: (the error's type and message, whether the
    shards and state after it are those after the eager call 1, whether
    the counters are, the program's graph)."""
    from k8s_dra_driver_torch.models import burnin, graphs

    _, _, graphed, _, _, states = _graph_twins(kind, cfg_kw, layout, params, fail=True, **kw)
    local, state = states[0]
    batch = torch.from_numpy(tokens)
    graphed.step(local, state, batch)
    before = [t.clone() for t in burnin._state_tensors(local, state)]
    counts = _counters()
    try:
        graphed.step(local, state, batch)
        err = None
    except graphs.GraphCaptureError as exc:
        err = (type(exc).__name__, str(exc))
    kept = all(torch.equal(a, b) for a, b in zip(before, burnin._state_tensors(local, state)))
    return err, kept, _counters() == counts, graphed.graphed.program.graph


def gloo_holders(cfg_kw, layout, pp_layout):
    """On real gloo groups: the mesh step's and the pipeline step's
    ``graphed`` and ``captures`` after two steps, and ``nccl_mesh``."""
    from k8s_dra_driver_torch.models import burnin, mesh_train, pp_burnin

    cfg = burnin.ModelConfig(**{**cfg_kw, "dtype": torch.float32})
    out = []
    tokens = torch.zeros((4, 16), dtype=torch.int32)
    for fns in (burnin.build_train_step(cfg, mesh=make_mesh(layout), device="cpu"),
                pp_burnin.build_pp_train_step(cfg, make_mesh(pp_layout), device="cpu")):
        params, state = fns.init(torch.Generator().manual_seed(0))
        for _ in range(2):
            fns.step(params, state, tokens)
        out.append((fns.graphed, fns.captures))
    return out, mesh_train.nccl_mesh(make_mesh(layout))
