"""Functions the pod entry-point tests run on every rank of a ``RankPool``:
the mesh checkpoint, the consumer's serving demo and a dry run leg made to
fail.

Spawned ranks import this module by name, so it imports torch, numpy and
the port only (never JAX).  Meshes are built on the CPU ranks over the
whole world and cached by shape.
"""

from __future__ import annotations

import numpy as np
import torch

from k8s_dra_driver_torch.models import burnin, pp_burnin, weights
from k8s_dra_driver_torch.models.train_checkpoint import MeshLayout, TrainCheckpointer
from k8s_dra_driver_torch.parallel import mesh as pm

LR = 3e-4
_MESHES: dict = {}


def make_mesh(shape: dict):
    key = tuple(sorted(shape.items()))
    if key not in _MESHES:
        import torch.distributed as dist

        _MESHES[key] = pm.build_mesh(range(dist.get_world_size()), pm.MeshShape(**shape), "cpu")
    return _MESHES[key]


def config(cfg_kw) -> burnin.ModelConfig:
    return burnin.ModelConfig(**{**cfg_kw, "dtype": torch.float32})


def bits(t) -> np.ndarray:
    """A tensor's bytes as integers (f32 as int32), for equality byte for
    byte."""
    t = t.detach().cpu().contiguous()
    return (t.view(torch.int32) if t.dtype == torch.float32 else t).numpy().copy()


def state_bits(params, state) -> list:
    leaves = burnin.param_leaves(params)
    return [bits(t) for t in (*leaves, state["count"], *state["mu"], *state["nu"])]


def _fns(cfg, mesh, pipeline: bool):
    if pipeline:
        return pp_burnin.build_pp_train_step(cfg, mesh, lr=LR, device="cpu")
    return burnin.build_train_step(cfg, mesh=mesh, lr=LR, device="cpu")


def whole_state(cfg, mesh, pipeline, params, state) -> list:
    """The whole single-card state's bits from this rank's shards, by
    all-gathers: the params in ``burnin.init_params``' layout, the count,
    the moments."""
    if pipeline:
        def dense(tree):
            return weights.dense_params(cfg, weights.unshard_pipeline_params(cfg, mesh, tree)[0])

        full = dense(params)
        mu = dense(burnin._unflatten(params, iter(state["mu"])))
        nu = dense(burnin._unflatten(params, iter(state["nu"])))
        return state_bits(full, {"count": state["count"], "mu": burnin.param_leaves(mu),
                                 "nu": burnin.param_leaves(nu)})
    full, opt = weights.unshard_params(cfg, mesh, params, state)
    return state_bits(full, opt)


def _trained(cfg, mesh, pipeline, tokens, steps: int, seed: int = 0):
    fns = _fns(cfg, mesh, pipeline)
    params, state = fns.init(torch.Generator().manual_seed(seed))
    losses = [float(fns.step(params, state, tokens)[2]) for _ in range(steps)]
    return fns, params, state, losses


def repair_case(cfg_kw, directory, tokens):
    """Two ranks over ``MeshShape(model=2)``: one step, a save, another
    step, a restore into the same tensors.  Returns, per leaf, whether it
    came back with this rank's own saved shard, and whether that shard
    differs from the other rank's."""
    import torch.distributed as dist

    cfg, mesh = config(cfg_kw), make_mesh({"model": 2})
    tokens = torch.from_numpy(tokens)
    fns, params, state, _ = _trained(cfg, mesh, False, tokens, 1)
    ckpt = TrainCheckpointer(directory, layout=MeshLayout(cfg, mesh))
    ckpt.save(1, (params, state))
    mine = state_bits(params, state)
    fns.step(params, state, tokens)
    ckpt.restore(1, like=(params, state))
    ckpt.close()
    got = state_bits(params, state)
    others = [None] * dist.get_world_size()
    dist.all_gather_object(others, mine)
    other = others[1 - dist.get_rank()]
    return ([bool(np.array_equal(a, b)) for a, b in zip(got, mine)],
            [not np.array_equal(a, b) for a, b in zip(mine, other)])


def layoutless_refusal(directory):
    """The message a checkpointer without a layout raises in a world of
    several ranks."""
    try:
        TrainCheckpointer(directory)
    except ValueError as exc:
        return str(exc)
    return None


def resume_case(cfg_kw, shape, pipeline, directory, tokens, steps: int = 2):
    """``steps`` steps, a save, ``steps`` more (the uninterrupted run), a
    restore of the save into the same tensors and the same ``steps`` again:
    both runs' losses, whether the final states are equal byte for byte,
    and the whole saved state's bits."""
    cfg, mesh = config(cfg_kw), make_mesh(shape)
    tokens = torch.from_numpy(tokens)
    fns, params, state, _ = _trained(cfg, mesh, pipeline, tokens, steps)
    ckpt = TrainCheckpointer(directory, layout=MeshLayout(cfg, mesh, pipeline))
    ckpt.save(steps, (params, state))
    saved = whole_state(cfg, mesh, pipeline, params, state)
    first = [float(fns.step(params, state, tokens)[2]) for _ in range(steps)]
    after = state_bits(params, state)
    ckpt.restore(steps, like=(params, state))
    again = [float(fns.step(params, state, tokens)[2]) for _ in range(steps)]
    ckpt.close()
    same = all(np.array_equal(a, b) for a, b in zip(after, state_bits(params, state)))
    return first, again, same, saved


def restore_whole(cfg_kw, shape, pipeline, directory, step, seed: int = 99):
    """A fresh state on ``shape`` (other values than the saved ones), the
    checkpoint of ``step`` restored into it in place: the whole state's
    bits, gathered from the shards, and whether every tensor kept its
    address."""
    cfg, mesh = config(cfg_kw), make_mesh(shape)
    fns = _fns(cfg, mesh, pipeline)
    params, state = fns.init(torch.Generator().manual_seed(seed))
    ptrs = [t.data_ptr() for t in (*burnin.param_leaves(params), *state["mu"])]
    ckpt = TrainCheckpointer(directory, layout=MeshLayout(cfg, mesh, pipeline))
    ckpt.restore(step, like=(params, state))
    ckpt.close()
    kept = ptrs == [t.data_ptr() for t in (*burnin.param_leaves(params), *state["mu"])]
    return whole_state(cfg, mesh, pipeline, params, state), kept


def save_whole(cfg_kw, shape, pipeline, directory, step, seed: int = 5, steps: int = 1,
               tokens=None):
    """``steps`` steps from ``seed`` (on ``tokens``), saved as ``step``:
    the whole saved state's bits."""
    cfg, mesh = config(cfg_kw), make_mesh(shape)
    fns = _fns(cfg, mesh, pipeline)
    params, state = fns.init(torch.Generator().manual_seed(seed))
    if tokens is not None:
        for _ in range(steps):
            fns.step(params, state, torch.from_numpy(tokens))
    ckpt = TrainCheckpointer(directory, layout=MeshLayout(cfg, mesh, pipeline))
    ckpt.save(step, (params, state))
    ckpt.close()
    return whole_state(cfg, mesh, pipeline, params, state)


def onto_mesh_and_save(cfg_kw, shape, directory, step, new_step):
    """A single-card checkpoint restored onto ``shape``'s shards, then
    saved again from the mesh as ``new_step``: the restored whole state's
    bits."""
    cfg, mesh = config(cfg_kw), make_mesh(shape)
    fns = _fns(cfg, mesh, False)
    params, state = fns.init(torch.Generator().manual_seed(123))
    ckpt = TrainCheckpointer(directory, layout=MeshLayout(cfg, mesh))
    ckpt.restore(step, like=(params, state))
    ckpt.save(new_step, (params, state))
    ckpt.close()
    return whole_state(cfg, mesh, False, params, state)


def keep_case(cfg_kw, shape, directory):
    """Three saves with ``keep=2``: each rank's deletions and the steps it
    sees after each save."""
    from k8s_dra_driver_torch.models import train_checkpoint as tc

    cfg, mesh = config(cfg_kw), make_mesh(shape)
    fns = _fns(cfg, mesh, False)
    params, state = fns.init(torch.Generator().manual_seed(0))
    deleted = []
    real = tc.shutil.rmtree

    def recording(path, *a, **kw):
        deleted.append(str(path))
        return real(path, *a, **kw)

    tc.shutil.rmtree = recording
    try:
        ckpt = TrainCheckpointer(directory, keep=2, layout=MeshLayout(cfg, mesh))
        seen = []
        for step in (1, 2, 3):
            ckpt.save(step, (params, state), wait=step != 2)
            seen.append(ckpt.all_steps())
        ckpt.close()
        seen.append(ckpt.all_steps())
    finally:
        tc.shutil.rmtree = real
    return deleted, seen


def refused_restore(cfg_kw, shape, pipeline, directory, step, like_cfg_kw=None,
                    like_shape=None):
    """The message a restore raises: into a state built on ``like_shape``
    (or ``shape``) for ``like_cfg_kw`` (or ``cfg_kw``) with the layout of
    ``shape``."""
    cfg, mesh = config(cfg_kw), make_mesh(shape)
    like_cfg = config(like_cfg_kw or cfg_kw)
    fns = _fns(like_cfg, make_mesh(like_shape or shape), pipeline)
    params, state = fns.init(torch.Generator().manual_seed(1))
    ckpt = TrainCheckpointer(directory, layout=MeshLayout(cfg, mesh, pipeline))
    try:
        ckpt.restore(step, like=(params, state))
    except (ValueError, FileNotFoundError) as exc:
        return f"{type(exc).__name__}: {exc}"
    finally:
        ckpt.close()
    return None


def failed_write_case(cfg_kw, shape, directory, failing: int):
    """A save in which rank ``failing``'s write raises: the message each
    rank raises, whether the step's temporary directory is left, the steps
    every rank sees; then the same step saved again with every write
    whole, and the steps seen after it."""
    import os

    import torch.distributed as dist

    cfg, mesh = config(cfg_kw), make_mesh(shape)
    params, state = _fns(cfg, mesh, False).init(torch.Generator().manual_seed(2))
    ckpt = TrainCheckpointer(directory, layout=MeshLayout(cfg, mesh))
    if dist.get_rank() == failing:
        def full_disk(final, host):
            raise OSError(28, "No space left on device")

        ckpt._write_rank = full_disk
    try:
        ckpt.save(1, (params, state))
        msg = None
    except OSError as exc:
        msg = str(exc)
    left = os.path.exists(os.path.join(directory, ".tmp-1"))
    seen = ckpt.all_steps()
    dist.barrier()  # every rank has looked before any saves again
    ckpt.__dict__.pop("_write_rank", None)
    ckpt.save(1, (params, state))
    ckpt.close()
    return msg, left, seen, ckpt.all_steps()


def carried_loss(cfg_kw, shape, params_np, tokens, directory, restore_shape, steps: int = 2):
    """The JAX package's weights (numpy) sharded on ``shape``, ``steps``
    steps, a save, a restore into fresh shards on ``restore_shape``, and
    the next step's loss there."""
    cfg = config(cfg_kw)
    tokens = torch.from_numpy(tokens)
    mesh = make_mesh(shape)
    full = weights.params_from_jax(params_np, "cpu")
    fns = _fns(cfg, mesh, False)
    local, _ = weights.shard_params(cfg, mesh, full)
    state = burnin.make_optimizer(LR).init(local)
    for _ in range(steps):
        fns.step(local, state, tokens)
    TrainCheckpointer(directory, layout=MeshLayout(cfg, mesh)).save(steps, (local, state))
    mesh2 = make_mesh(restore_shape)
    fns2 = _fns(cfg, mesh2, False)
    params, state2 = fns2.init(torch.Generator().manual_seed(7))
    ckpt = TrainCheckpointer(directory, layout=MeshLayout(cfg, mesh2))
    ckpt.restore(steps, like=(params, state2))
    ckpt.close()
    return float(fns2.step(params, state2, tokens)[2])


# -- the consumer's serving demo ---------------------------------------------------


def demo_on_mesh(params_np=None, bank_np=None, scale=None):
    """``consumer.serve_demo`` over ``MeshShape(data=2)`` of the world's
    first two ranks (every rank builds the mesh; the others take no part):
    ``(summary, streams)`` on ranks 0 and 1, None on the others."""
    import torch.distributed as dist

    from k8s_dra_driver_torch import consumer

    mesh = pm.build_mesh([0, 1], pm.MeshShape(data=2), "cpu")
    if dist.get_rank() >= 2:
        return None
    params = None if params_np is None else weights.params_from_jax(params_np, "cpu")
    bank = None if bank_np is None else {
        "blocks": weights.params_from_jax(bank_np, "cpu"), "scale": scale}
    return consumer.serve_demo("cpu", mesh=mesh, params=params, bank=bank)


def claim_demo(visible: str):
    """``consumer.claim_serve_demo`` for a claim of the cards ``visible``,
    this rank the card ``LOCAL_RANK`` = its rank: the summary, or None where
    the rank takes no part."""
    import torch.distributed as dist

    from k8s_dra_driver_torch import consumer

    ctx = consumer.attach(environ={"TPU_VISIBLE_DEVICES": visible,
                                   "LOCAL_RANK": str(dist.get_rank())}, init_distributed=False)
    return consumer.claim_serve_demo(ctx, "cpu")


# -- the dry run --------------------------------------------------------------------


def drop_a_token():
    """Make this rank's sharded paged engine return one token fewer in each
    completion (the dry run's sharded paged serving leg then fails)."""
    from k8s_dra_driver_torch.models.paged import PagedServeEngine

    real = PagedServeEngine.completions

    def fewer(self):
        out = real(self)
        if self.mesh is not None:
            for c in out:
                c.generated = c.generated[:-1]
        return out

    PagedServeEngine.completions = fewer
    return True
