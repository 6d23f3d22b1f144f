"""Collectives over mesh axes, and the collective micro-benchmarks
(``k8s_dra_driver_tpu/ops/collectives.py``).

Inside ``shard_map`` the reference calls ``jax.lax.ppermute``, ``psum``,
``all_gather`` and ``all_to_all``, and GSPMD inserts the rest.  The port is
one process per rank, so each becomes an explicit ``torch.distributed``
call on an axis's process group (``mesh.get_group(name)``):

* the ``*_raw`` functions move data and take no part in autograd;
* :func:`ppermute`, :func:`psum`, :func:`pvary`, :func:`all_gather` and
  :func:`all_to_all` are ``torch.autograd.Function``\\ s with the
  transposes JAX gives them: the inverse permutation, the identity (psum's
  output is the same on every rank), an all-reduce (``pvary`` is Megatron's
  conjugate of ``psum``: identity forward, for the input of a
  column-parallel product), a reduce-scatter, and the reverse all-to-all.

Backends: NCCL takes every collective on CUDA tensors.  Gloo takes CUDA
tensors for ``all_reduce`` and ``broadcast`` only (PyTorch's backend
table), so every other collective on a gloo group copies its CUDA operands
through pinned host memory here, explicitly.  ``comm_bytes`` counts the
bytes this rank sends under a direct or ring algorithm (all-reduce
2(n-1)/n of the payload, all-gather (n-1) blocks, all-to-all (n-1)/n of the
input, a permutation the tensor, a broadcast the tensor from its source),
``host_bytes`` the bytes copied to the host and back for a gloo group; set
them to 0 with :func:`reset_counts`.

The probes (:func:`psum_bandwidth` and the rest) keep the reference's
algbw formulas and timing discipline; each rank runs them on its own
device and gets its own result.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

_KINDS = ("all_reduce", "reduce_scatter", "ppermute", "all_gather", "all_to_all", "broadcast")
comm_bytes = dict.fromkeys(_KINDS, 0)
host_bytes = dict.fromkeys(_KINDS, 0)
_COUNTERS = {"comm_bytes": comm_bytes, "host_bytes": host_bytes}


def reset_counts() -> None:
    for counter in (comm_bytes, host_bytes):
        for key in counter:
            counter[key] = 0


def byte_counts() -> dict:
    """Both byte counters, ``{("comm_bytes" or "host_bytes", kind): n}``
    (read by the CUDA-graph holder, ``models/graphs.GraphedProgram``)."""
    return {(name, kind): n for name, counter in _COUNTERS.items()
            for kind, n in counter.items()}


def add_byte_counts(delta: dict) -> None:
    """Add ``delta`` (keys as :func:`byte_counts` gives them; others are
    ignored): a graph replay counts the bytes its capture recorded."""
    for name, counter in _COUNTERS.items():
        for kind in counter:
            counter[kind] += delta.get((name, kind), 0)


def group_index(group) -> tuple[int, int]:
    """(ranks in ``group``, this rank's index there); None is one device."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _size(group) -> int:
    return group_index(group)[0]


def _via_host(t: torch.Tensor, group) -> bool:
    """True where gloo cannot take ``t`` itself: a CUDA tensor on a gloo
    group, for any collective but all-reduce and broadcast."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host_copy(t: torch.Tensor, kind: str) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    host_bytes[kind] += t.numel() * t.element_size()
    return buf


def _device_copy(host: torch.Tensor, like: torch.Tensor, kind: str) -> torch.Tensor:
    host_bytes[kind] += host.numel() * host.element_size()
    return host.to(like.device, non_blocking=True)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def all_reduce_raw(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (gloo takes CUDA tensors here)."""
    n = _size(group)
    if n > 1:
        comm_bytes["all_reduce"] += 2 * (n - 1) * _nbytes(t) // n
        dist.all_reduce(t, group=group)
    return t


def all_reduce_buckets(tensors: list, groups_for) -> list:
    """Each of ``tensors`` summed over the groups ``groups_for(i)`` lists
    (none: left as it is), in one flat buffer per dtype and list of groups,
    one all-reduce per group; returns the sums as new tensors."""
    out = list(tensors)
    buckets: dict = {}
    for i, t in enumerate(tensors):
        groups = [g for g in groups_for(i) if g is not None]
        if groups:
            key = (t.dtype, tuple(map(id, groups)))
            buckets.setdefault(key, (groups, []))[1].append(i)
    for groups, idx in buckets.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        for group in groups:
            all_reduce_raw(flat, group)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def ppermute_raw(tensors: list, group, perm) -> list:
    """Send each of ``tensors`` along ``perm`` (``[(src, dst)]`` in group
    ranks) in one batch of point-to-point operations; a rank that receives
    from no one gets zeros, as ``jax.lax.ppermute`` gives."""
    me = dist.get_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if dst == [me] and src == [me]:
        return list(tensors)
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.zeros_like(t) for t in tensors]
    staged = bool(tensors) and _via_host(tensors[0], group)
    sends = [_host_copy(t, "ppermute") for t in tensors] if staged else tensors
    recvs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors] \
        if staged else outs
    ops = []
    for d in dst:
        peer = dist.get_global_rank(group, d)
        ops += [dist.P2POp(dist.isend, t, peer, group) for t in sends]
        comm_bytes["ppermute"] += sum(_nbytes(t) for t in sends)
    for s in src:
        peer = dist.get_global_rank(group, s)
        ops += [dist.P2POp(dist.irecv, t, peer, group) for t in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if staged and src:
        outs = [_device_copy(h, t, "ppermute") for h, t in zip(recvs, tensors)]
    return outs


def ring_perm(n: int) -> list:
    """``[(j, (j + 1) % n)]``: every rank sends to its successor, the
    reference's ring."""
    return [(j, (j + 1) % n) for j in range(n)]


def inverse_perm(perm) -> list:
    """``perm`` run backward: each ``(src, dst)`` as ``(dst, src)``."""
    return [(d, s) for s, d in perm]


def all_gather_raw(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank order."""
    n = _size(group)
    if n == 1:
        return t
    t = t.contiguous()
    staged = _via_host(t, group)
    send = _host_copy(t, "all_gather") if staged else t
    parts = [torch.empty_like(send) for _ in range(n)]
    comm_bytes["all_gather"] += (n - 1) * _nbytes(t)
    dist.all_gather(parts, send, group=group)
    if staged:
        parts = [_device_copy(p, t, "all_gather") for p in parts]
    return torch.cat(parts, dim)


def all_gather_to_host(t: torch.Tensor, group, dim: int, order=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` as a CPU tensor, with one
    device-to-host copy a rank: on a gloo group (or a CPU ``t``) the block
    goes to the host first and the host blocks are gathered; on NCCL the
    device blocks are gathered and the whole comes back once.  ``order[j]``
    is where group rank ``j``'s block goes (default: group-rank order)."""
    n = _size(group)
    if n == 1:
        return t.to("cpu", copy=True)
    t = t.contiguous()
    host = t.is_cuda and dist.get_backend(group) == "gloo"
    if host:
        t = t.to("cpu", copy=True)
        host_bytes["all_gather"] += _nbytes(t)
    parts = [torch.empty_like(t) for _ in range(n)]
    comm_bytes["all_gather"] += (n - 1) * _nbytes(t)
    dist.all_gather(parts, t, group=group)
    if order is not None:
        placed = [None] * n
        for j, at in enumerate(order):
            placed[at] = parts[j]
        parts = placed
    return torch.cat(parts, dim).cpu()


def broadcast_raw(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` from global rank ``src`` to every rank of ``group``, in place
    (gloo takes CUDA tensors here); the bytes move as a byte view, so any
    dtype goes."""
    if _size(group) == 1:
        return t
    if dist.get_rank() == src:
        comm_bytes["broadcast"] += _nbytes(t)
    dist.broadcast(t.view(-1).view(torch.uint8), src, group=group)
    return t


def reduce_scatter_raw(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of ``t`` over ``group``, this rank's block along ``dim``.
    Gloo has no reduce-scatter, so this is an all-reduce and a cut."""
    n = _size(group)
    if n == 1:
        return t
    total = t.contiguous().clone()
    comm_bytes["reduce_scatter"] += 2 * (n - 1) * _nbytes(total) // n
    dist.all_reduce(total, group=group)
    return total.chunk(n, dim)[dist.get_rank(group)].contiguous()


def all_to_all_raw(t: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: ``t`` cut into n blocks
    along ``split_axis``, block j to rank j; the blocks received
    concatenated along ``concat_axis`` in source-rank order."""
    n = _size(group)
    if n == 1:
        return t
    if t.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(t.shape)} does not split "
                         f"into {n}")
    inp = torch.stack([c.contiguous() for c in t.chunk(n, split_axis)])
    staged = _via_host(inp, group)
    send = _host_copy(inp, "all_to_all") if staged else inp
    out = torch.empty_like(send)
    comm_bytes["all_to_all"] += (n - 1) * _nbytes(inp) // n
    dist.all_to_all_single(out, send, group=group)
    if staged:
        out = _device_copy(out, inp, "all_to_all")
    return torch.cat(list(out.unbind(0)), concat_axis)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return ppermute_raw([x], group, perm)[0]

    @staticmethod
    def backward(ctx, g):
        return ppermute_raw([g], ctx.group, inverse_perm(ctx.perm))[0], None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_raw(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_raw(g.clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_raw(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_raw(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return all_to_all_raw(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return all_to_all_raw(g, group, concat_axis, split_axis), None, None, None


def ppermute(x, group, perm):
    """``jax.lax.ppermute``; its gradient travels the inverse permutation."""
    return _PPermute.apply(x, group, perm)


def psum(x, group):
    """``jax.lax.psum``: the sum over ``group`` on every rank; the gradient
    passes unchanged (Megatron's all-reduce after a row-parallel product).
    ``group`` None (one device) returns ``x``."""
    if _size(group) == 1:
        return x
    return _Psum.apply(x, group)


def pvary(x, group):
    """Identity forward, all-reduce of the gradient: Megatron's conjugate of
    :func:`psum`, on the replicated input of a column-parallel product.
    ``group`` None returns ``x``."""
    if _size(group) == 1:
        return x
    return _Pvary.apply(x, group)


def all_gather(x, group, dim: int):
    """``jax.lax.all_gather(..., tiled=True)`` along ``dim``; the gradient
    is reduce-scattered back."""
    if _size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim)


def all_to_all(x, group, split_axis: int, concat_axis: int):
    """``jax.lax.all_to_all(..., tiled=True)``; the gradient takes the
    reverse all-to-all."""
    if _size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)


# ---------------------------------------------------------------------------
# Probes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BandwidthResult:
    collective: str
    axis: str
    n_devices: int
    payload_bytes: int
    seconds_per_call: float
    algbw_gbps: float  # algorithmic bandwidth, GB/s


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_fn(fn, device, warmup: int = 2, iters: int = 10) -> float:
    for _ in range(warmup):
        fn()
    _sync(device)
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - start) / iters


def _probe_setup(mesh, axis, mib, dtype):
    from k8s_dra_driver_torch.parallel.mesh import mesh_shape, rank_device

    n = mesh_shape(mesh)[axis]
    elems = mib * 1024 * 1024 // torch.empty((), dtype=dtype).element_size()
    return n, elems, rank_device(mesh.device_type), mesh.get_group(axis)


def _algbw(factor: float, payload: int, secs: float, n: int) -> float:
    return (factor * payload / secs / 1e9) if n > 1 else payload / secs / 1e9


def psum_bandwidth(mesh, axis: str = "model", mib: int = 64, dtype=torch.bfloat16,
                   iters: int = 10) -> BandwidthResult:
    """All-reduce ``mib`` MiB per rank over ``axis``."""
    n, elems, dev, group = _probe_setup(mesh, axis, mib, dtype)
    x = torch.ones((elems,), dtype=dtype, device=dev)
    secs = _time_fn(lambda: all_reduce_raw(x, group), dev, iters=iters)
    payload = elems * x.element_size()
    return BandwidthResult("psum", axis, n, payload, secs,
                           _algbw(2 * (n - 1) / max(n, 1), payload, secs, n))


def all_gather_bandwidth(mesh, axis: str = "model", mib: int = 64, dtype=torch.bfloat16,
                         iters: int = 10) -> BandwidthResult:
    n, elems, dev, group = _probe_setup(mesh, axis, mib, dtype)
    x = torch.ones((elems,), dtype=dtype, device=dev)
    secs = _time_fn(lambda: all_gather_raw(x, group, 0), dev, iters=iters)
    payload = elems * x.element_size()
    return BandwidthResult("all_gather", axis, n, payload, secs,
                           _algbw((n - 1) / max(n, 1), payload, secs, n))


def all_to_all_bandwidth(mesh, axis: str = "data", mib: int = 64, dtype=torch.bfloat16,
                         iters: int = 10) -> BandwidthResult:
    """Each rank exchanges 1/n of its block with every peer (MoE dispatch
    and return traffic)."""
    n, elems, dev, group = _probe_setup(mesh, axis, mib, dtype)
    per = max(n, (elems // n) * n)
    x = torch.ones((n, per // n), dtype=dtype, device=dev)
    secs = _time_fn(lambda: all_to_all_raw(x, group, 0, 0), dev, iters=iters)
    payload = n * (per // n) * x.element_size()
    return BandwidthResult("all_to_all", axis, n, payload, secs,
                           _algbw((n - 1) / max(n, 1), payload, secs, n))


def ring_latency_us(mesh, axis: str = "model", iters: int = 50) -> float:
    """One-hop ``ppermute`` latency around the ring."""
    from k8s_dra_driver_torch.parallel.mesh import mesh_shape, rank_device

    n = mesh_shape(mesh)[axis]
    if n < 2:
        return 0.0
    dev, group = rank_device(mesh.device_type), mesh.get_group(axis)
    x = torch.zeros((1, 8), dtype=torch.float32, device=dev)
    perm = ring_perm(n)
    return _time_fn(lambda: ppermute_raw([x], group, perm), dev, iters=iters) * 1e6


def dispatch_rtt_seconds(device="cuda", iters: int = 7) -> float:
    """Round trip of a trivial op and a host read, median of ``iters``."""
    v = torch.zeros((), dtype=torch.float32, device=device)
    float(v + 1.0)
    samples = []
    for _ in range(iters):
        start = time.perf_counter()
        float(v + 1.0)
        samples.append(time.perf_counter() - start)
    samples.sort()
    return samples[len(samples) // 2]


def _timed_probe_seconds(f, arg, device, what: str) -> float:
    """One warm call, then one timed call ending in a host read, less the
    median dispatch round trip; refuses (never clamps) when the round trip
    buries the work."""
    float(f(arg))
    start = time.perf_counter()
    float(f(arg))
    total = time.perf_counter() - start
    rtt = dispatch_rtt_seconds(device)
    if total <= 1.5 * rtt:
        raise RuntimeError(
            f"{what} measurement dominated by dispatch RTT "
            f"({total*1e3:.1f}ms total vs {rtt*1e3:.1f}ms RTT); raise `chain`"
        )
    return total - rtt


def matmul_tflops(device="cuda", size: int = 4096, dtype=torch.bfloat16,
                  chain: int = 128) -> float:
    """``chain`` chained products of one ``[size, size]`` matrix, TFLOP/s."""
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((size, size), generator=g, device=device).to(dtype)
    inv = 1.0 / math.sqrt(size)

    def f(x):
        y = x
        for _ in range(chain):
            y = (y @ x) * inv
        return y.float().sum()

    secs = _timed_probe_seconds(f, a, device, "matmul")
    return chain * 2 * size**3 / secs / 1e12


def matmul_int8_tops(device="cuda", size: int = 4096, chain: int = 128) -> float:
    """int8 x int8 -> int32 chained products, T-ops/s; the carry is shifted
    and cut back to int8 between links (the cut wraps, as the reference's
    does; only the work is timed)."""
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randint(-127, 128, (size, size), generator=g, device=device,
                      dtype=torch.int8)

    def f(x):
        y = x
        for _ in range(chain):
            y = (torch._int_mm(y, x) >> 14).to(torch.int8)
        return y.int().sum().float()

    secs = _timed_probe_seconds(f, a, device, "int8 matmul")
    return chain * 2 * size**3 / secs / 1e12


def attention_speedup(device="cuda", batch: int = 4, heads: int = 8, seq: int = 2048,
                      d: int = 128, dtype=torch.bfloat16, chain: int = 256) -> dict:
    """The port's flash kernels against plain dense attention, forward,
    ``chain`` calls per timing, the reference's discipline.  The CUDA
    kernels choose their own tiles, so the reference's block sweep has
    nothing to sweep here."""
    from k8s_dra_driver_torch.ops.flash_attention import flash_attention

    g = torch.Generator(device=device).manual_seed(0)
    shape = (batch, seq, heads, d)
    q, k, v = (
        (torch.randn(shape, generator=g, device=device) / math.sqrt(d)).to(dtype)
        for _ in range(3)
    )

    def dense(q, k, v):
        scale = 1.0 / math.sqrt(d)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        mask = torch.ones((seq, seq), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    rtt = dispatch_rtt_seconds(device)

    def timed_ms(attn) -> float:
        def f(q0):
            y = q0
            for _ in range(chain):
                y = attn(y, k, v)
            return y.float().sum()

        float(f(q))
        start = time.perf_counter()
        float(f(q))
        total = time.perf_counter() - start
        if total <= 1.5 * rtt:
            raise RuntimeError(
                f"attention timing dominated by dispatch RTT "
                f"({total*1e3:.1f}ms vs {rtt*1e3:.1f}ms); raise `chain`"
            )
        return (total - rtt) / chain * 1e3

    flash_ms = round(timed_ms(flash_attention), 3)
    dense_ms = round(timed_ms(dense), 3)
    return {
        "flash_ms": flash_ms,
        "dense_ms": dense_ms,
        "speedup": round(dense_ms / flash_ms, 2),
        "shape": f"b{batch} h{heads} s{seq} d{d}",
    }


def summarize(results: list[BandwidthResult]) -> dict:
    return {
        r.collective: {"n": r.n_devices, "algbw_gbps": round(r.algbw_gbps, 3)}
        for r in results
    }
