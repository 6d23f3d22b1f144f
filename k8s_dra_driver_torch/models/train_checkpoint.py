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
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import torch

_FILE = "state.pt"


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


class TrainCheckpointer:
    """Saves and restores a state tree (dicts, lists and tuples of tensors)
    by step under ``directory``, one subdirectory per step, keeping the
    newest ``keep``."""

    def __init__(self, directory: str | Path, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._keep = keep
        self._writer = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None

    def save(self, step: int, state: Any, wait: bool = True) -> None:
        """Persist ``state`` for ``step``: its tensors are copied to the host
        before this returns, then written to a temporary directory that
        ``os.replace`` renames to the step's (in the background when
        ``wait`` is false; the next call waits for it).  Older steps past
        ``keep`` are deleted."""
        if step < 0:
            raise ValueError(f"step must be >= 0, got {step}")
        self.wait_until_finished()
        final = self._dir / str(int(step))
        if final.exists():
            raise ValueError(f"step {step} is already saved under {self._dir}")
        host = _tree_map(_to_host, state)
        self._pending = self._writer.submit(self._write, final, host)
        if wait:
            self.wait_until_finished()

    def _write(self, final: Path, host) -> None:
        tmp = self._dir / f".tmp-{final.name}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(host, tmp / _FILE)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self._keep]:
            shutil.rmtree(self._dir / str(old))

    def wait_until_finished(self) -> None:
        """Wait for a background save; raises what it raised."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def restore(self, step: Optional[int] = None, like: Any = None) -> Any:
        """The state saved for ``step`` (default: the latest).  Without
        ``like`` its tensors come back on the CPU.  With ``like`` (a tree
        of the same structure, shapes and dtypes, on any device), each
        saved leaf is copied into ``like``'s tensor and ``like`` is
        returned."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self._dir}")
        saved = torch.load(self._dir / str(int(step)) / _FILE, map_location="cpu",
                           weights_only=True)
        if like is None:
            return saved
        with torch.no_grad():
            _copy_into(like, saved)
        return like

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(p.name) for p in self._dir.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def close(self) -> None:
        self.wait_until_finished()
        self._writer.shutdown()
