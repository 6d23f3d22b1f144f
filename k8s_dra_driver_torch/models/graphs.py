"""CUDA graphs for the port's compiled programs, the counterpart of the
reference's ``jax.jit`` (the serving engines' ``shared_jit`` programs and the
train step): :class:`GraphedProgram` captures a program once and replays it,
:func:`disable_graphs` runs the programs eagerly instead, as
``jax.disable_jit()`` does.  ``models/serve`` re-exports these names;
``models/paged.PagedServeEngine`` and ``models/burnin.build_train_step`` use
them."""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from k8s_dra_driver_torch.ops import flash_attention, int4_matmul, paged_attention

# the kernel wrappers whose launch counters a replay must keep counting
LAUNCH_COUNTERS = (paged_attention, int4_matmul, flash_attention)
_graphs_enabled = True


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter, ``{(module, key): n}``."""
    return {
        (mod.__name__, key): n
        for mod in LAUNCH_COUNTERS for key, n in mod.launch_counts().items()
    }


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` (keys as :func:`launch_counts` gives them)."""
    for mod in LAUNCH_COUNTERS:
        mod.add_launch_counts({key: n for (m, key), n in delta.items() if m == mod.__name__})


def _change(after: dict, before: dict) -> dict:
    return {key: after[key] - before[key] for key in after}


@contextlib.contextmanager
def disable_graphs():
    """Run the programs (the engines' and the train step) eagerly on the
    card inside the block, the counterpart of ``jax.disable_jit()``: for A/B
    checks and debugging, not a fallback.  Process-wide; nests, and
    restores the setting on exit."""
    global _graphs_enabled
    before, _graphs_enabled = _graphs_enabled, False
    try:
        yield
    finally:
        _graphs_enabled = before


def graphs_enabled() -> bool:
    """False inside :func:`disable_graphs`."""
    return _graphs_enabled


class GraphCaptureError(RuntimeError):
    """A program could not be captured as a CUDA graph: something in it
    reads the device from the host, synchronises, or copies from the host
    (``.item()``, boolean-mask indexing, ``torch.tensor(x, device=...)``)."""


def cuda_capture(fn, device):
    """Capture ``fn()`` into a new ``torch.cuda.CUDAGraph`` (its own memory
    pool) on a side stream of ``device``; no kernel runs.  Returns
    ``(graph, output)``."""
    # garbage the collector would free mid-capture may hold another graph
    # (an engine's programs refer back to the engine), and destroying a
    # graph during a capture invalidates the capture
    gc.collect()
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize(device)  # the side stream must not overtake queued work
    with torch.cuda.device(device), torch.cuda.stream(torch.cuda.Stream(device)):
        graph.capture_begin()
        try:
            out = fn()
        except BaseException:
            # end the capture, which that failure has already invalidated,
            # and raise the failure itself rather than capture_end's report
            with contextlib.suppress(RuntimeError):
                graph.capture_end()
            raise
        graph.capture_end()
    return graph, out


class GraphedProgram:
    """One program (the reference's ``shared_jit`` programs: prefill, first
    token, a K-step burst; the jitted train step) as a CUDA graph:

    1. the first call runs ``fn`` eagerly.  That is real work, and it
       builds and loads the kernels and sets up cuBLAS outside capture;
    2. the second call captures ``fn`` (its Python runs, no kernel does),
       then replays the graph once to do the call's work;
    3. later calls only replay.

    ``fn`` takes no arguments: it reads its inputs from, and leaves its
    state in, tensors whose addresses stay fixed (an engine's static
    buffers, the train step's params, optimizer state and token buffer),
    since a graph replays the addresses it captured.  Its output lives in
    the graph's own memory pool and is overwritten by the next replay, so
    read or copy it first.  Graphs are therefore per engine or train step,
    where the reference's ``shared_jit`` programs are shared across the
    process.

    The kernel wrappers count a launch when their Python runs, which a
    replay skips: the holder takes back the change in the counters across
    the capture and adds it at every replay, so the counts are those of
    eager calls.  A capture that raises leaves the counters as they were
    and raises :class:`GraphCaptureError` naming the program; nothing runs
    eagerly in its place.  ``capture(fn, device)`` is the capturing
    function (a stand-in in the CPU tests)."""

    def __init__(self, name: str, fn, device, capture=cuda_capture):
        self.name = name
        self._fn = fn
        self._device = device
        self._capture = capture
        self.calls = 0
        self.graph = None
        self.capture_s: float | None = None  # host seconds the capture took
        self._out = None
        self._delta: dict = {}

    def __call__(self):
        self.calls += 1
        if self.graph is None:
            if self.calls == 1:
                return self._fn()
            self._capture_now()
        self.graph.replay()
        add_launch_counts(self._delta)
        return self._out

    def _capture_now(self) -> None:
        before = launch_counts()
        t0 = time.perf_counter()
        try:
            graph, out = self._capture(self._fn, self._device)
        except Exception as exc:
            raise GraphCaptureError(
                f"capturing {self.name} as a CUDA graph failed: {type(exc).__name__}: {exc}"
            ) from exc
        finally:
            after = launch_counts()
            add_launch_counts(_change(before, after))  # the capture launched nothing
        self.capture_s = time.perf_counter() - t0
        self.graph, self._out, self._delta = graph, out, _change(after, before)
