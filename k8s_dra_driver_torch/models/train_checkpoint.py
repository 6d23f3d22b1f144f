"""Training-state checkpoint and resume (``k8s_dra_driver_tpu/models/train_checkpoint.py``),
with ``torch.save`` in place of orbax: a preempted job saves ``(params,
opt_state)`` and resumes where it left off, bit for bit.

Usage:

    ckpt = TrainCheckpointer(dir, keep=3)
    step = ckpt.latest_step()             # None on a fresh run
    if step is not None:
        ckpt.restore(step, like=(params, opt_state))  # in place
    ...
    ckpt.save(step, (params, opt_state))  # atomic per step

``restore(like=...)`` is the port's counterpart of the reference's restore
under shardings: it copies each saved leaf into ``like``'s tensor, so the
restored state keeps the addresses a CUDA graph of the train step
(``burnin.GraphedTrainStep``) replays, and the step resumes without a new
capture.  A restore into new tensors would leave the graph training the
old ones.

On a mesh the caller says how the state is laid out, as the reference's
arrays carry their shardings: ``TrainCheckpointer(dir, layout=MeshLayout(cfg,
mesh))`` for ``weights.shard_params``' shards (the mesh steps of
``burnin.build_train_step(mesh=...)``), ``MeshLayout(cfg, mesh,
pipeline=True)`` for ``weights.shard_pipeline_params``' (the pipeline
step).  Every rank of the world calls ``save`` and ``restore`` alike, on a
directory they share.  A save writes every rank's file
``<dir>/<step>/rank-<r>.pt``, with the mesh and every leaf's spec; each
shard is written once, as orbax writes it, by its primary replica: the
rank at coordinate 0 on every mesh axis the leaf's spec does not name
(the others hold None for that leaf).  No collective moves data, and the
step becomes visible only when every rank's write succeeded (the ranks
agree on it, then rank 0 renames the step's directory and deletes steps
past ``keep``; a failed write on any rank raises on every rank, naming
it, and rank 0 removes the step's temporary directory).  A restore on the
same mesh and layout copies each of this rank's leaves from its primary
replica's file into ``like``, bit for bit.  Under another mesh shape or
layout, from a single-card checkpoint, or into a single-card state, it
rebuilds each whole leaf on the host from one file per distinct shard
(``qkv``'s group-major order undone), lays the state out as the
restoring side's layout does (``weights.shard_params`` /
``pipeline_params`` and ``shard_pipeline_params``) and takes this rank's
shards, so a resumed job may change its mesh.  Files are read memory-mapped,
so a rank reads only the shards it takes.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

_FILE = "state.pt"
_RANK_FILE = "rank-{}.pt"


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _to_host(x):
    """A tensor leaf as a CPU copy the next in-place update cannot touch."""
    return x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x


def _copy_into(like, saved, where: str = "state") -> None:
    """Copy ``saved`` into ``like`` leaf by leaf, in place; a structure,
    shape or dtype that does not match raises ValueError."""
    if isinstance(like, dict):
        if not isinstance(saved, dict) or set(saved) != set(like):
            raise ValueError(f"{where}: saved keys {_keys(saved)} do not match {sorted(like)}")
        for k in like:
            _copy_into(like[k], saved[k], f"{where}[{k!r}]")
    elif isinstance(like, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(like):
            raise ValueError(f"{where}: saved {type(saved).__name__} does not match a "
                             f"{type(like).__name__} of {len(like)}")
        for i, (a, b) in enumerate(zip(like, saved)):
            _copy_into(a, b, f"{where}[{i}]")
    elif isinstance(like, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"{where}: saved {type(saved).__name__}, not a tensor")
        if saved.shape != like.shape or saved.dtype != like.dtype:
            raise ValueError(f"{where}: saved {saved.dtype} {tuple(saved.shape)} does not "
                             f"match {like.dtype} {tuple(like.shape)}")
        like.copy_(saved)
    else:
        raise ValueError(f"{where}: like's leaves must be tensors, got {type(like).__name__}")


def _keys(tree):
    return sorted(tree) if isinstance(tree, dict) else type(tree).__name__


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """How a mesh state ``(params, opt_state)`` is laid out: ``cfg``'s
    params cut over ``mesh`` (a ``parallel/mesh`` ``DeviceMesh`` over the
    whole world) by ``weights.shard_params`` (``burnin.param_pspecs``,
    ``qkv`` group-major), or with ``pipeline`` by
    ``weights.shard_pipeline_params`` (``pp_burnin.pp_param_pspecs``);
    ``opt_state`` an AdamW state over those shards (``count``, ``mu``,
    ``nu``), or None."""

    cfg: Any
    mesh: Any
    pipeline: bool = False

    @property
    def kind(self) -> str:
        return "pipeline" if self.pipeline else "params"

    def specs(self) -> list:
        """``[(path, spec)]`` of the params' leaves in
        ``burnin.param_leaves`` order."""
        from k8s_dra_driver_torch.models.burnin import param_pspecs
        from k8s_dra_driver_torch.models.pp_burnin import pp_param_pspecs

        return _spec_paths(pp_param_pspecs(self.cfg) if self.pipeline
                           else param_pspecs(self.cfg))


def _spec_paths(tree, path="") -> list:
    from k8s_dra_driver_torch.parallel.mesh import PartitionSpec

    if isinstance(tree, PartitionSpec):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_paths(tree[k], f"{path}.{k}")]
    return [x for i, t in enumerate(tree) for x in _spec_paths(t, f"{path}[{i}]")]


def _build(tree, leaves):
    """The spec ``tree``'s structure with the next ``leaves``, in
    ``burnin.param_leaves`` order."""
    from k8s_dra_driver_torch.parallel.mesh import PartitionSpec

    if isinstance(tree, PartitionSpec):
        return next(leaves)
    if isinstance(tree, dict):
        built = {k: _build(tree[k], leaves) for k in sorted(tree)}
        return {k: built[k] for k in tree}
    return [_build(t, leaves) for t in tree]


def _writer(mesh_ranks, names, spec, rank: int) -> int:
    """The rank whose file holds ``rank``'s shard of a leaf laid out by
    ``spec`` (a PartitionSpec or its saved list): the replica with
    ``rank``'s coordinates on the axes ``spec`` names and 0 on every
    other."""
    from k8s_dra_driver_torch.parallel.mesh import _spec_axes

    arr = np.asarray(mesh_ranks)
    coords = [int(c[0]) for c in np.nonzero(arr == rank)]
    named = {name for entry in spec for name in _spec_axes(entry)}
    return int(arr[tuple(c if n in named else 0 for n, c in zip(names, coords))])


def _leaf_specs(specs: list, opt: bool) -> list:
    """Each leaf's spec in :func:`_mesh_leaves` order, ``count`` replicated."""
    return specs + ([()] + specs + specs if opt else [])


def _flat(saved: dict) -> list:
    """A rank file's leaves in :func:`_mesh_leaves` order."""
    if not saved["meta"]["opt"]:
        return [*saved["params"]]
    return [*saved["params"], saved["count"], *saved["mu"], *saved["nu"]]


def _cfg_fields(cfg) -> dict:
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["dtype"] = str(out["dtype"]).split(".")[-1]
    return out


def _config(fields: dict):
    from k8s_dra_driver_torch.models.burnin import ModelConfig, torch_dtype

    return ModelConfig(**{**fields, "dtype": torch_dtype(fields["dtype"])})


def _mesh_leaves(state, where: str, paths: list) -> list:
    """``[(name, tensor)]`` of a mesh state ``(params, opt_state)``: the
    params' leaves, then ``count``, ``mu`` and ``nu``, each named by its
    params path (``paths``, the layout's)."""
    from k8s_dra_driver_torch.models.burnin import param_leaves

    if not (isinstance(state, (tuple, list)) and len(state) == 2):
        raise ValueError(f"{where}: a mesh state is (params, opt_state)")
    params, opt = state
    leaves = param_leaves(params)
    if len(paths) != len(leaves):
        raise ValueError(f"{where}: the params have {len(leaves)} leaves, the layout "
                         f"{len(paths)}")
    out = [(f"params{p}", t) for p, t in zip(paths, leaves)]
    if opt is not None:
        if not (isinstance(opt, dict) and set(opt) == {"count", "mu", "nu"}
                and len(opt["mu"]) == len(opt["nu"]) == len(paths)):
            raise ValueError(f"{where}: opt_state must be an AdamW state over the params "
                             f"(count, mu, nu) or None")
        out.append(("opt_state count", opt["count"]))
        for part in ("mu", "nu"):
            out += [(f"opt_state {part}{p}", t) for p, t in zip(paths, opt[part])]
    return out


def _whole_dense(files: list, meta: dict):
    """The whole state in the single-card layout, ``(params tree,
    opt_state or None)`` on the CPU, from every rank's saved file
    (``files[r]`` rank r's): each leaf reassembled by its saved spec over
    the saved mesh, each shard from its primary replica's file."""
    from k8s_dra_driver_torch.models import weights
    from k8s_dra_driver_torch.models.burnin import param_leaves, param_pspecs
    from k8s_dra_driver_torch.models.pp_burnin import pp_param_pspecs
    from k8s_dra_driver_torch.parallel.mesh import P, unshard

    cfg = _config(meta["cfg"])
    ranks, names = meta["mesh_ranks"], tuple(meta["mesh_names"])
    pipeline = meta["layout"] == "pipeline"
    spec_tree = pp_param_pspecs(cfg) if pipeline else param_pspecs(cfg)
    specs = [P(*(tuple(e) if isinstance(e, list) else e for e in spec))
             for spec in meta["specs"]]
    keys = [path.rsplit(".", 1)[-1] for path in meta["paths"]]

    def whole(part):
        leaves = []
        for i, (key, spec) in enumerate(zip(keys, specs)):
            blocks = [files[_writer(ranks, names, spec, r)][part][i] for r in range(len(files))]
            t = unshard(blocks, ranks, names, spec)
            leaves.append(weights.packed_qkv(t, cfg) if key == "qkv" and not pipeline else t)
        tree = _build(spec_tree, iter(leaves))
        return weights.dense_params(cfg, tree) if pipeline else tree

    params = whole("params")
    if not meta["opt"]:
        return params, None
    return params, {"count": files[_writer(ranks, names, (), 0)]["count"],
                    "mu": param_leaves(whole("mu")), "nu": param_leaves(whole("nu"))}


def _laid_out(dense, layout: MeshLayout) -> list:
    """The whole single-card state ``dense`` (``(params, opt_state)``) as
    this rank's leaves under ``layout``, in :func:`_mesh_leaves` order."""
    from k8s_dra_driver_torch.models import weights
    from k8s_dra_driver_torch.models.burnin import _unflatten, param_leaves

    cfg, mesh = layout.cfg, layout.mesh
    params, opt = dense
    if layout.pipeline:
        pp = weights.pipeline_params(cfg, params)
        pp_opt = None if opt is None else {
            "count": opt["count"],
            **{k: param_leaves(weights.pipeline_params(cfg, _unflatten(params, iter(opt[k]))))
               for k in ("mu", "nu")}}
        params, opt = weights.shard_pipeline_params(cfg, mesh, pp, pp_opt)
    else:
        params, opt = weights.shard_params(cfg, mesh, params, opt)
    return [t for _, t in _mesh_leaves((params, opt), "restore",
                                       [p for p, _ in layout.specs()])]


class TrainCheckpointer:
    """Saves and restores a state tree (dicts, lists and tuples of tensors)
    by step under ``directory``, one subdirectory per step, keeping the
    newest ``keep``.  With ``layout`` (a :class:`MeshLayout`) the state is a
    mesh state ``(params, opt_state)`` of this rank's shards, saved and
    restored by every rank of the world alike (the module docstring)."""

    def __init__(self, directory: str | Path, keep: int = 3,
                 layout: Optional[MeshLayout] = None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._keep = keep
        self._layout = layout
        self._rank, self._world = 0, 1
        if layout is None:
            import torch.distributed as dist

            if dist.is_initialized() and dist.get_world_size() > 1:
                raise ValueError(
                    "every rank of a process group would save to the same files: on a mesh "
                    "pass layout=MeshLayout(cfg, mesh) (or pipeline=True) so each rank "
                    "saves its own shards"
                )
        else:
            import torch.distributed as dist

            if not dist.is_initialized():
                raise ValueError("a mesh checkpoint needs the process group of its mesh")
            self._rank, self._world = dist.get_rank(), dist.get_world_size()
            if layout.mesh.mesh.numel() != self._world:
                raise ValueError(
                    f"the layout's mesh holds {layout.mesh.mesh.numel()} ranks, the world "
                    f"{self._world}: a mesh checkpoint is saved by every rank of the world"
                )
        self._writer = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._uncommitted: Optional[Path] = None

    def save(self, step: int, state: Any, wait: bool = True) -> None:
        """Persist ``state`` for ``step``: its tensors are copied to the host
        before this returns, then written to a temporary directory that
        ``os.replace`` renames to the step's (in the background when
        ``wait`` is false; the next call waits for it).  Older steps past
        ``keep`` are deleted.  On a mesh each rank writes its own file (the
        shards it is the primary replica of) and the step is committed by
        every rank's :meth:`wait_until_finished` (which the next call
        makes)."""
        if step < 0:
            raise ValueError(f"step must be >= 0, got {step}")
        self.wait_until_finished()
        final = self._dir / str(int(step))
        if final.exists():
            raise ValueError(f"step {step} is already saved under {self._dir}")
        if self._layout is None:
            host = _tree_map(_to_host, state)
            self._pending = self._writer.submit(self._write, final, host)
        else:
            host = self._rank_payload(state)
            self._pending = self._writer.submit(self._write_rank, final, host)
            self._uncommitted = final
        if wait:
            self.wait_until_finished()

    def _write(self, final: Path, host) -> None:
        tmp = self._dir / f".tmp-{final.name}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(host, tmp / _FILE)
        os.replace(tmp, final)
        self._prune()

    def _prune(self) -> None:
        for old in self.all_steps()[:-self._keep]:
            shutil.rmtree(self._dir / str(old))

    def _rank_payload(self, state) -> dict:
        """This rank's file: the leaves whose primary replica it is, on the
        host (None for the others), with the mesh, the layout and every
        leaf's spec."""
        layout = self._layout
        specs = layout.specs()
        leaves = _mesh_leaves(state, "save", [p for p, _ in specs])
        opt = state[1]
        n = len(specs)
        mesh = layout.mesh
        ranks, names = mesh.mesh.tolist(), list(mesh.mesh_dim_names)
        host = [_to_host(t) if _writer(ranks, names, spec, self._rank) == self._rank else None
                for (_, t), spec in zip(leaves, _leaf_specs([s for _, s in specs],
                                                            opt is not None))]
        return {
            "meta": {"layout": layout.kind, "cfg": _cfg_fields(layout.cfg),
                     "mesh_names": names, "mesh_ranks": ranks,
                     "specs": [[list(e) if isinstance(e, tuple) else e for e in spec]
                               for _, spec in specs],
                     "paths": [p for p, _ in specs], "rank": self._rank,
                     "world": self._world, "opt": opt is not None},
            "params": host[:n],
            "count": None if opt is None else host[n],
            "mu": None if opt is None else host[n + 1: 2 * n + 1],
            "nu": None if opt is None else host[2 * n + 1:],
        }

    def _write_rank(self, final: Path, host: dict) -> None:
        tmp = self._dir / f".tmp-{final.name}"
        tmp.mkdir(exist_ok=True)
        name = _RANK_FILE.format(self._rank)
        torch.save(host, tmp / f"{name}.part")
        os.replace(tmp / f"{name}.part", tmp / name)

    def _commit(self, final: Path, error: Optional[BaseException]) -> None:
        """The ranks agree on whether every rank's write succeeded
        (``error`` this rank's failure).  If so, rank 0 renames the step's
        directory and prunes, and every rank then sees the same steps; if
        not, rank 0 removes the temporary directory and every rank raises,
        naming the ranks that failed."""
        import torch.distributed as dist

        errors = [None] * self._world
        dist.all_gather_object(errors, None if error is None
                               else f"{type(error).__name__}: {error}")
        tmp = self._dir / f".tmp-{final.name}"
        failed = [f"rank {r}: {e}" for r, e in enumerate(errors) if e is not None]
        if failed:
            if self._rank == 0:
                shutil.rmtree(tmp, ignore_errors=True)
            dist.barrier()
            raise OSError(f"step {final.name} was not saved: {'; '.join(failed)}") from error
        if self._rank == 0:
            mine = {_RANK_FILE.format(r) for r in range(self._world)}
            for stale in tmp.iterdir():
                if stale.name not in mine:  # left by an earlier, larger world
                    stale.unlink()
            os.replace(tmp, final)
            self._prune()
        dist.barrier()

    def wait_until_finished(self) -> None:
        """Wait for a background save; raises what it raised.  On a mesh
        every rank calls it (save, restore and close do): it commits the
        step, or raises on every rank if any rank's write failed."""
        pending, self._pending = self._pending, None
        final, self._uncommitted = self._uncommitted, None
        if final is None:
            if pending is not None:
                pending.result()
            return
        error = None
        try:
            pending.result()
        except Exception as e:  # every rank learns of it before any raises
            error = e
        self._commit(final, error)

    def restore(self, step: Optional[int] = None, like: Any = None) -> Any:
        """The state saved for ``step`` (default: the latest).  Without
        ``like`` its tensors come back on the CPU (a mesh checkpoint as the
        whole single-card state).  With ``like`` (a tree of the same
        structure, shapes and dtypes, on any device; on a mesh this rank's
        shards under the checkpointer's layout), each saved leaf is copied
        into ``like``'s tensor and ``like`` is returned."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self._dir}")
        where = self._dir / str(int(step))
        single = (where / _FILE).exists()
        if self._layout is None or like is None:
            saved = (torch.load(where / _FILE, map_location="cpu", weights_only=True) if single
                     else self._whole(step, where, self._load(step, where, 0)))
            if like is None:
                return saved
            with torch.no_grad():
                _copy_into(like, saved)
            return like
        targets = _mesh_leaves(like, f"restore of step {step}",
                               [p for p, _ in self._layout.specs()])
        if single:
            saved = torch.load(where / _FILE, map_location="cpu", weights_only=True)
            leaves = _laid_out(self._dense(step, saved), self._layout)
        else:
            mine = self._load(step, where, self._rank)
            meta = mine["meta"]
            for r in range(meta["world"]):  # the step is whole only with every file
                self._rank_file(step, where, r)
            if self._same_layout(meta):
                files = {self._rank: _flat(mine)}
                leaves = []
                for i, spec in enumerate(_leaf_specs(meta["specs"], meta["opt"])):
                    w = _writer(meta["mesh_ranks"], meta["mesh_names"], spec, self._rank)
                    if w not in files:
                        files[w] = _flat(self._load(step, where, w))
                    leaves.append(files[w][i])
            else:
                self._check_config(step, "the saved mesh", meta["cfg"])
                leaves = _laid_out(self._whole(step, where, mine), self._layout)
        if len(leaves) != len(targets):
            raise ValueError(f"step {step}, rank {self._rank}: saved {len(leaves)} leaves, "
                             f"like has {len(targets)}")
        with torch.no_grad():
            for (name, dst), src in zip(targets, leaves):
                if src.shape != dst.shape or src.dtype != dst.dtype:
                    raise ValueError(
                        f"step {step}, rank {self._rank}, {name}: saved {src.dtype} "
                        f"{tuple(src.shape)} does not fit like's {dst.dtype} "
                        f"{tuple(dst.shape)}")
                dst.copy_(src)
        return like

    def _rank_file(self, step: int, where: Path, rank: int) -> Path:
        path = where / _RANK_FILE.format(rank)
        if not path.exists():
            raise FileNotFoundError(f"step {step}: rank {rank}'s file {path.name} is missing "
                                    f"under {where}")
        return path

    def _load(self, step: int, where: Path, rank: int) -> dict:
        """Rank ``rank``'s file, memory-mapped: a restore reads only the
        shards it takes."""
        return torch.load(self._rank_file(step, where, rank), map_location="cpu",
                          weights_only=True, mmap=True)

    def _whole(self, step: int, where: Path, first: dict):
        """The whole single-card state from every rank's file of a mesh
        checkpoint (``first`` one of them, already read)."""
        meta = first["meta"]
        files = [first if r == meta["rank"] else self._load(step, where, r)
                 for r in range(meta["world"])]
        return _whole_dense(files, meta)

    def _dense(self, step: int, saved):
        """A single-card checkpoint's ``(params, opt_state)``."""
        if not (isinstance(saved, (tuple, list)) and len(saved) == 2):
            raise ValueError(f"step {step}: the single-card checkpoint is not "
                             f"(params, opt_state)")
        return saved[0], saved[1]

    def _same_layout(self, meta: dict) -> bool:
        mesh = self._layout.mesh
        return (meta["layout"] == self._layout.kind and meta["world"] == self._world
                and tuple(meta["mesh_names"]) == tuple(mesh.mesh_dim_names)
                and meta["mesh_ranks"] == mesh.mesh.tolist()
                and meta["cfg"] == _cfg_fields(self._layout.cfg))

    def _check_config(self, step: int, what: str, fields: dict) -> None:
        mine = _cfg_fields(self._layout.cfg)
        differ = sorted(k for k in mine if k != "dtype" and fields.get(k) != mine[k])
        if differ:
            raise ValueError(f"step {step}: {what} has another model config ({differ}) than "
                             f"the layout's")

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(p.name) for p in self._dir.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def close(self) -> None:
        self.wait_until_finished()
        self._writer.shutdown()
