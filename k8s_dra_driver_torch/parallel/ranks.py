"""Start the ranks of a world on one host and run functions on all of them.

The reference's single controller drives every device of a mesh from one
process; the port runs one process per rank.  :class:`RankPool` starts
``world_size`` processes (``spawn``), each joining one process group
(:func:`init_ranks`), and runs a module-level function on every rank at
once: ``pool.run(fn, *args, **kwargs)`` returns each rank's result, rank 0's first.
A function is sent by its import path, so it lives in a module that the
ranks can import (never one that imports JAX).  The caller picks the
backend: ``"gloo"`` (CPU tensors, and CUDA tensors with the host copies of
``ops/collectives``) or ``"nccl"`` (one card per rank).  The CUDA kernels
are built by the caller before the ranks start: each rank then loads the
built libraries.
"""

from __future__ import annotations

import socket
import traceback
from datetime import timedelta

import torch


def free_port() -> int:
    """A free TCP port on localhost for a group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_ranks(rank: int, world_size: int, backend: str, port: int, device_type: str,
               timeout_s: float = 300.0) -> None:
    """Join the default process group at ``tcp://localhost:port`` as
    ``rank`` of ``world_size`` on ``backend`` (checked by
    ``parallel.mesh.check_backend``); a CUDA rank first takes card
    ``rank % device_count``."""
    import torch.distributed as dist

    from k8s_dra_driver_torch.parallel.mesh import check_backend, set_rank_card

    check_backend(backend, world_size, device_type)
    kwargs = {}
    if device_type == "cuda":
        card = rank % torch.cuda.device_count()
        set_rank_card(card)
        if backend == "nccl":
            kwargs["device_id"] = torch.device("cuda", card)  # NCCL binds its card now
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", rank=rank, world_size=world_size,
        timeout=timedelta(seconds=timeout_s), **kwargs,
    )


def _serve(rank, world_size, backend, port, device_type, timeout_s, tasks, results):
    import torch.distributed as dist

    # one intra-op thread a rank: the ranks share the host's cores
    torch.set_num_threads(1)
    try:
        init_ranks(rank, world_size, backend, port, device_type, timeout_s)
        results.put((rank, True, "ready"))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                results.put((rank, True, fn(*args, **kwargs)))
            except Exception:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world_size`` rank processes on this host, started once and kept
    for many calls.  A call that fails on any rank raises here with every
    failing rank's traceback, and the pool restarts on its next call (a
    rank left waiting in a collective is stopped)."""

    def __init__(self, world_size: int, backend: str = "gloo", device_type: str = "cuda",
                 timeout_s: float = 300.0):
        from k8s_dra_driver_torch.parallel.mesh import check_backend

        check_backend(backend, world_size, device_type)
        self.world_size, self.backend, self.device_type = world_size, backend, device_type
        self.timeout_s = timeout_s
        self._procs = None

    def _start(self) -> None:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        port = free_port()
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.world_size)]
        self._procs = [
            ctx.Process(
                target=_serve, daemon=True,
                args=(r, self.world_size, self.backend, port, self.device_type,
                      self.timeout_s, self._tasks[r], self._results),
            )
            for r in range(self.world_size)
        ]
        for p in self._procs:
            p.start()
        self._collect("start")

    def _collect(self, what: str) -> list:
        import queue

        got, errors = {}, {}
        while len(got) + len(errors) < self.world_size:
            # after a failure the others may wait in a collective the failed
            # rank never joins: they get a short grace, then the pool stops
            wait = 10 if errors else self.timeout_s
            try:
                rank, ok, value = self._results.get(timeout=wait)
            except queue.Empty:
                errors.setdefault(-1, f"no answer within {wait} s")
                break
            (got if ok else errors)[rank] = value
        if errors:
            self.close()
            raise RuntimeError(
                f"{what} failed on rank(s) {sorted(errors)}:\n"
                + "\n".join(f"--- rank {r}:\n{tb}" for r, tb in sorted(errors.items()))
            )
        return [got[r] for r in range(self.world_size)]

    def run(self, fn, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank; the results by rank."""
        if self._procs is None:
            self._start()
        for q in self._tasks:
            q.put((fn, args, kwargs))
        return self._collect(getattr(fn, "__name__", str(fn)))

    def close(self) -> None:
        if self._procs is None:
            return
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self._procs = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
