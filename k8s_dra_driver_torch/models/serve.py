"""Serving helpers shared by the engines (``k8s_dra_driver_tpu/models/serve.py``):
slot state, completions, admission checks, retirement, greedy sampling,
the continuous-batching ``_pump``, and :class:`GraphedProgram`, the
counterpart of the reference's ``shared_jit``: an engine program captured
once as a CUDA graph and replayed.  The dense ``ServeEngine`` is not ported
yet; ``models/paged.PagedServeEngine`` uses these."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import torch

from k8s_dra_driver_torch.ops import int4_matmul, paged_attention


class NoCapacity(RuntimeError):
    """No free slot or not enough free pool blocks for a request right now
    (a RuntimeError, as the reference raises)."""


@dataclass
class _Slot:
    request_id: int
    tokens: list[int]  # prompt + generated so far
    prompt_len: int
    max_tokens: int
    # hard cap on GENERATED tokens, min'd with max_tokens (_slot_budget)
    deadline: int | None = None


@dataclass
class Completion:
    request_id: int
    tokens: list[int]  # prompt + generated
    generated: list[int]
    error: str = ""
    # "ok" (eos / max_tokens) or "deadline_exceeded"
    status: str = "ok"


def check_submit(
    prompt: list[int], max_tokens: int, prompt_bucket: int, max_seq: int,
    temperature: float = 0.0, deadline: int | None = None,
) -> None:
    """Admission validation shared by the engines."""
    if not prompt:
        raise ValueError("empty prompt")
    if max_tokens < 1:
        raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
    if deadline is not None and deadline < 1:
        raise ValueError(f"deadline must be >= 1 generated token, got {deadline}")
    if len(prompt) > prompt_bucket:
        raise ValueError(f"prompt {len(prompt)} exceeds bucket {prompt_bucket}")
    if len(prompt) + max_tokens > max_seq:
        raise ValueError("prompt + max_tokens exceeds max_seq")
    if temperature != 0.0:
        raise NotImplementedError(
            "sampled requests (temperature > 0) are not ported yet: the "
            "port serves greedy requests only"
        )


def _slot_budget(st: _Slot) -> int:
    """Generated-token budget: ``max_tokens`` capped by the deadline."""
    return st.max_tokens if st.deadline is None else min(st.max_tokens, st.deadline)


def completion_if_done(st: _Slot, eos_id: int | None, max_seq: int):
    """The Completion when the slot hit eos or its budget, else None."""
    n_gen = len(st.tokens) - st.prompt_len
    if len(st.tokens) > max_seq:
        raise RuntimeError("cache overrun: submit() invariant broken")
    budget = _slot_budget(st)
    hit_eos = eos_id is not None and st.tokens[-1] == eos_id
    if n_gen < budget and not hit_eos:
        return None
    status = "ok"
    if not hit_eos and budget < st.max_tokens:
        status = "deadline_exceeded"
    return Completion(
        request_id=st.request_id,
        tokens=list(st.tokens),
        generated=list(st.tokens[st.prompt_len:]),
        status=status,
    )


def sample_next(logits) -> torch.Tensor:
    """Greedy next token per row (``argmax``, first maximum on ties, as
    ``jnp.argmax``), int32."""
    return logits.argmax(dim=-1).to(torch.int32)


def _pump(engine, requests, max_steps: int) -> list:
    """Continuous-batching drive: admit queued ``(prompt, max_tokens)``
    pairs (or dicts of ``submit`` kwargs) FIFO as slots and blocks free,
    burst-step in between, return every completion."""
    queue = list(requests)
    out: list = []
    for _ in range(max_steps):
        admitted = False
        while queue and engine.free_slots() > 0:
            req = queue[0]
            try:
                if isinstance(req, dict):
                    engine.submit(**req)
                else:
                    prompt, max_tokens = req
                    engine.submit(prompt, max_tokens=max_tokens)
            except NoCapacity:
                break  # step until capacity frees
            queue.pop(0)
            admitted = True
        stepped = engine.step_burst()
        out.extend(engine.completions())
        if not queue and engine.free_slots() == engine.n_slots:
            return out
        if stepped == 0 and not admitted:
            raise RuntimeError(
                "pump wedged: queued or resident requests, no progress "
                f"({len(queue)} queued, {engine.free_blocks} free blocks)"
            )
    raise RuntimeError(f"pump did not drain in {max_steps} steps")


# -- CUDA graphs: the counterpart of the reference's shared_jit ------------

# the kernel wrappers whose launch counters a replay must keep counting
LAUNCH_COUNTERS = (paged_attention, int4_matmul)
_graphs_enabled = True


def launch_counts() -> dict:
    """Every serving kernel's launch counter, ``{(module, key): n}``."""
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
    """Run the engines' programs eagerly on the card inside the block, the
    counterpart of ``jax.disable_jit()``: for A/B checks and debugging, not
    a fallback.  Process-wide; nests, and restores the setting on exit."""
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
    """One engine program (the reference's ``shared_jit`` programs: prefill,
    first token, a K-step burst) as a CUDA graph:

    1. the first call runs ``fn`` eagerly.  That is real work, and it
       builds and loads the kernels and sets up cuBLAS outside capture;
    2. the second call captures ``fn`` (its Python runs, no kernel does),
       then replays the graph once to do the call's work;
    3. later calls only replay.

    ``fn`` takes no arguments: it reads its inputs from, and leaves its
    state in, tensors whose addresses stay fixed (the engine's static
    buffers), since a graph replays the addresses it captured.  Its output
    lives in the graph's own memory pool and is overwritten by the next
    replay, so read it first.  Graphs are therefore per engine, where the
    reference's ``shared_jit`` programs are shared across the process.

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
