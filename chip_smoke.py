#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure fails the run, exit code 1; without a CUDA device it
exits 2 before any result):

1. environment: the card's name and power limit; both kernel sources built
   from ``k8s_dra_driver_torch/csrc`` with ``nvcc`` (ptxas report printed);
2. kernels against their plain PyTorch versions on the card, at the
   serving path's shapes (FLAGSHIP_MODERN: Hq 16 / Hkv 4 / d 64, L 8,
   block 16, B 8, ragged lengths up to 1024; int4 at M 8 and 256 over the
   four block matrices), with each tolerance and its reason, and each
   kernel's time beside the plain version's, a one-call PyTorch yardstick
   the port never calls, and the least time the card could take;
3. serving FLAGSHIP_MODERN (random weights from a seed, bf16 weights and
   pool) through ``PagedServeEngine.pump``: every stream checked
   teacher-forced against the plain dense decode path;
4. the same with int4 block weights;
5. the same in f32 at reduced depth.

The line before the last lists the kernels with their launch counts on the
serving path and their times; the last line is the JSON device record.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import traceback

import numpy as np

SEED = 0
DEV = "cuda"  # the card; a rehearsal on the CPU may set "cpu"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at 700 W
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # tensor-core bf16; f32 off the tensor cores
# why each serving phase's logit-gap tolerance is what it is, by "float32?"
TOL_WHY = {
    False: "bf16 weights, activations and pool rounded at other places by the "
           "paged kernel and batch-8 products than by the batch-1 dense path",
    True: "float32 throughout, sums in another order; TF32 off",
}
KERNELS = {
    # one CUDA source, two instantiations (APPEND on/off); the serving path
    # runs the append one, whose numbers this entry carries
    "paged_attention": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/paged_attention.cu",
        replaces="k8s_dra_driver_tpu/ops/paged_attention.py:64",
    ),
    "int4_matmul": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/int4_matmul.cu",
        replaces="k8s_dra_driver_tpu/ops/int4_matmul.py:41",
    ),
}


def log(*a):
    print(*a, flush=True)


def sync(torch):
    if DEV == "cuda":
        torch.cuda.synchronize()


def bound(bytes_moved: float, ops: float, dtype_name: str):
    """(least ms, what bounds it) from bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Mean device time of one call, L2 flushed before each call (the
    serving step finds each layer's operands cold: ~240 MB of weights pass
    between two visits).  A spin kernel of a few ms runs ahead of the
    start event, so the call is fully queued before the device reaches it:
    the events then time the device's work, not the host's launches."""

    SPIN_CYCLES = 8_000_000  # ~4 ms at the H100's SM clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device=DEV)

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        sync(torch)
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / iters


def phase_environment(torch):
    from k8s_dra_driver_torch.ops import _build

    log("device:", torch.cuda.get_device_name(0), "count:", torch.cuda.device_count())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "not read"
    log("nvidia-smi:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda)
    t0 = time.perf_counter()
    _build.build(["int4_matmul", "paged_attention"])
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name, report in _build.ptxas_reports.items():
        log(f"--- ptxas -v: {name}.cu")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("   ", line.strip())
    return card


def _paged_case(torch, dtype, nq, lengths, *, L=8, hq=16, hkv=4, d=64, bs=16, mb=64, seed=1):
    g = torch.Generator(device=DEV).manual_seed(seed)
    b = len(lengths)
    n_pool = 1 + b * mb
    def rnd(*shape):
        return torch.randn(shape, generator=g, device=DEV).to(dtype)
    k_pools, v_pools = rnd(L, n_pool, hkv, d, bs), rnd(L, n_pool, hkv, d, bs)
    perm = torch.randperm(b * mb, generator=g, device=DEV) + 1
    table = perm.reshape(b, mb).to(torch.int32)
    pos = torch.tensor([max(n - nq, 0) for n in lengths], dtype=torch.int32, device=DEV)
    q = rnd(b, nq, hq, d)
    new_k, new_v = rnd(b, nq, hkv, d), rnd(b, nq, hkv, d)
    return k_pools, v_pools, table, pos, q, new_k, new_v


def _paged_work(lengths, nq, hq, hkv, d, bs, itemsize, append):
    """(bytes, operations) the function needs for these rows: each input
    read once, each output written once.  With ``append`` the window's
    keys come from new_k/new_v (read once, stored once) and the pool
    supplies the keys before the window; without, the pool supplies all."""
    b = len(lengths)
    moved = 2 * b * nq * hq * d * itemsize + 8 * b      # q in, out; pos, write mask
    ops = 0
    for n in lengths:
        p0 = max(n - nq, 0)
        pool_keys = p0 if append else p0 + nq
        moved += 2 * pool_keys * hkv * d * itemsize       # K and V
        moved += 4 * (-(-(p0 + nq) // bs))                # live table entries
        ops += sum(4 * (p0 + j + 1) * hq * d for j in range(nq))  # QK and PV
    if append:
        moved += 2 * 2 * b * nq * hkv * d * itemsize      # new k/v read, stored
    return moved, ops


def phase_kernels(torch, timer: Timer):
    import torch.nn.functional as F

    from k8s_dra_driver_torch.models import quant
    from k8s_dra_driver_torch.ops import int4_matmul as i4
    from k8s_dra_driver_torch.ops import paged_attention as pa

    results = {}
    ragged = [1, 1024] + np.random.RandomState(SEED).randint(2, 1024, size=6).tolist()
    tol = {
        torch.float32: (1e-4, "f32 sums in another order (online softmax over 64-key tiles)"),
        torch.bfloat16: (3e-2, "bf16 output rounding plus P rounded to bf16 before "
                               "normalisation in the kernel, after it in the plain version"),
    }
    worst = {"append": 0.0, "window": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        atol, why = tol[dtype]
        log(f"paged tolerance {dtype}: atol {atol} ({why})")
        for nq in (1, 4):
            kp, vp, table, pos, q, nk, nv = _paged_case(torch, dtype, nq, ragged)
            wmask = (torch.arange(8, device=DEV) % 3 != 1).to(torch.int32)
            layer = 3
            k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
            out_k, _, _ = pa.paged_append_attention(q, nk, nv, k1, v1, table, pos, layer, write_mask=wmask)
            out_p = pa.paged_append_attention_plain(q, nk, nv, k2, v2, table, pos, layer, write_mask=wmask)
            sync(torch)
            err = (out_k.float() - out_p.float()).abs().max().item()
            pools_equal = bool(torch.equal(k1[:, 1:], k2[:, 1:]) and torch.equal(v1[:, 1:], v2[:, 1:]))
            log(f"  append {dtype} nq={nq} lengths={ragged}: max_abs_err {err:.3g}, "
                f"pools equal outside block 0: {pools_equal}")
            if err > atol or not pools_equal:
                raise AssertionError(f"paged append kernel disagrees ({dtype}, nq={nq})")
            # window / decode: the window keys are in the pool now (k2, v2)
            out_w = pa.paged_window_attention(q, k2[layer], v2[layer], table, pos)
            out_wp = pa.paged_window_attention_plain(q, k2[layer], v2[layer], table, pos)
            errw = (out_w.float() - out_wp.float()).abs().max().item()
            log(f"  window {dtype} nq={nq}: max_abs_err {errw:.3g}")
            if errw > atol:
                raise AssertionError(f"paged window kernel disagrees ({dtype}, nq={nq})")
            if nq == 1:
                lens = pos + 1
                out_d = pa.paged_decode_attention(q[:, 0], k2[layer], v2[layer], table, lens)
                errd = (out_d.float() - out_wp[:, 0].float()).abs().max().item()
                log(f"  decode {dtype}: max_abs_err {errd:.3g}")
                if errd > atol:
                    raise AssertionError(f"paged decode kernel disagrees ({dtype})")
            if dtype == torch.bfloat16:
                worst["append"] = max(worst["append"], err)
                worst["window"] = max(worst["window"], errw)

    # times at the serving shape: B=8, bf16, nq=1, context 512 (and ragged)
    for label, lengths in (("ctx512", [512] * 8), ("ragged", ragged)):
        dtype = torch.bfloat16
        kp, vp, table, pos, q, nk, nv = _paged_case(torch, dtype, 1, lengths)
        layer = 3
        w = _paged_work(lengths, 1, 16, 4, 64, 16, 2, append=True)
        ms_k = timer.ms(lambda: pa.paged_append_attention(q, nk, nv, kp, vp, table, pos, layer))
        ms_p = timer.ms(lambda: pa.paged_append_attention_plain(q, nk, nv, kp, vp, table, pos, layer))
        ms_wk = timer.ms(lambda: pa.paged_window_attention(q, kp[layer], vp[layer], table, pos))
        ms_wp = timer.ms(lambda: pa.paged_window_attention_plain(q, kp[layer], vp[layer], table, pos))
        # yardstick: one SDPA call over K/V gathered (and widened to the
        # query heads) beforehand
        ids = table.long()
        kg = kp[layer][ids].permute(0, 2, 1, 4, 3).reshape(8, 4, -1, 64)  # [B, Hkv, T, d]
        vg = vp[layer][ids].permute(0, 2, 1, 4, 3).reshape(8, 4, -1, 64)
        kg, vg = kg.repeat_interleave(4, dim=1), vg.repeat_interleave(4, dim=1)
        qs = q.permute(0, 2, 1, 3)                                      # [B, Hq, 1, d]
        kpos = torch.arange(kg.shape[2], device=DEV)
        mask = (kpos[None, :] <= pos[:, None])[:, None, None, :]
        ms_lib = timer.ms(lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask))
        ww = _paged_work(lengths, 1, 16, 4, 64, 16, 2, append=False)
        b_ms, b_by = bound(w[0], w[1], "bfloat16")
        bw_ms, bw_by = bound(ww[0], ww[1], "bfloat16")
        log(f"  paged append bf16 B=8 nq=1 {label}: kernel {ms_k * 1e3:.1f} us, plain "
            f"{ms_p * 1e3:.1f} us, sdpa {ms_lib * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us "
            f"({b_by}, {w[0] / 1e6:.2f} MB, {w[1] / 1e6:.1f} MFLOP)")
        log(f"  paged window bf16 B=8 nq=1 {label}: kernel {ms_wk * 1e3:.1f} us, plain "
            f"{ms_wp * 1e3:.1f} us, bound {bw_ms * 1e3:.2f} us ({bw_by})")
        if label == "ctx512":
            results["paged_attention"] = dict(
                ms=ms_k, plain_ms=ms_p, library_ms=ms_lib, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=worst["append"],
            )

    # int4: the four block matrices of FLAGSHIP_MODERN at M = 8 and 256
    g = torch.Generator(device=DEV).manual_seed(SEED + 2)
    shapes = {"qkv": (1024, 1536), "attn_out": (1024, 1024),
              "mlp_up": (1024, 4096), "mlp_down": (4096, 1024)}
    log("int4 tolerance bf16: max|err| <= 1e-2 * max(1, max|plain|) (one bf16 ulp of the "
        "output: f32 sums in another order before the final rounding); f32: 1e-4 relative")
    worst_i4 = 0.0
    for name, (k, n) in shapes.items():
        wq = quant.Quantized4Matrix.quantize(
            (torch.randn((k, n), generator=g, device=DEV) * k ** -0.5).to(torch.bfloat16)
        )
        w_deq = wq.dequant()
        if name == "qkv":
            # x = identity rows: the kernel's dequantized weights, read exactly
            eye = torch.eye(k, dtype=torch.bfloat16, device=DEV)
            got = i4.int4_matmul(eye, wq.packed, wq.scale, 64)
            exact = bool(torch.equal(got, w_deq))
            log(f"  int4 dequant through the kernel bit-identical to dequant(): {exact}")
            if not exact:
                raise AssertionError("int4 kernel's dequantized weights differ")
            x32 = torch.randn((8, k), generator=g, device=DEV)
            w32 = quant.Quantized4Matrix(wq.packed, wq.scale, 64, torch.float32)
            o = i4.int4_matmul(x32, w32.packed, w32.scale, 64)
            op = i4.int4_matmul_plain(x32, w32.packed, w32.scale, 64)
            e32 = ((o - op).abs().max() / op.abs().max().clamp(min=1)).item()
            log(f"  int4 f32 M=8 {name}: rel err {e32:.3g}")
            if e32 > 1e-4:
                raise AssertionError("int4 kernel disagrees in f32")
        for m in (8, 256):
            x = torch.randn((m, k), generator=g, device=DEV).to(torch.bfloat16)
            o = i4.int4_matmul(x, wq.packed, wq.scale, 64)
            op = i4.int4_matmul_plain(x, wq.packed, wq.scale, 64)
            sync(torch)
            scale = max(1.0, op.float().abs().max().item())
            err = (o.float() - op.float()).abs().max().item()
            if err > 1e-2 * scale:
                raise AssertionError(f"int4 kernel disagrees ({name}, M={m}): {err}")
            worst_i4 = max(worst_i4, err)
            ms_k = timer.ms(lambda: i4.int4_matmul(x, wq.packed, wq.scale, 64))
            ms_p = timer.ms(lambda: i4.int4_matmul_plain(x, wq.packed, wq.scale, 64))
            ms_lib = timer.ms(lambda: torch.matmul(x, w_deq))
            moved = m * k * 2 + k * n // 2 + (k // 64) * n * 4 + m * n * 2
            b_ms, b_by = bound(moved, 2 * m * k * n, "bfloat16")
            log(f"  int4 {name} M={m} K={k} N={n}: max_abs_err {err:.3g}, kernel "
                f"{ms_k * 1e3:.1f} us, plain {ms_p * 1e3:.1f} us, matmul(dequantized) "
                f"{ms_lib * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us ({b_by}, {moved / 1e6:.2f} MB)")
            if name == "mlp_up" and m == 8:
                results["int4_matmul"] = dict(
                    ms=ms_k, plain_ms=ms_p, library_ms=ms_lib, bound_ms=b_ms, bound_by=b_by,
                )
    results["int4_matmul"]["max_abs_err"] = worst_i4
    return results


def _traffic(vocab: int, n: int, max_prompt: int, max_new: int, seed: int):
    r = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        plen = int(r.randint(16, max_prompt + 1))
        reqs.append((r.randint(0, vocab, size=plen).tolist(), int(r.randint(32, max_new + 1))))
    return reqs


def _dense_reference(params):
    """The plain dense path's params: int4 matrices replaced by their exact
    dequantized weights, so the reference runs no kernel."""
    from k8s_dra_driver_torch.models import quant

    out = dict(params)
    out["blocks"] = [
        {k: (v.dequant() if isinstance(v, quant.Quantized4Matrix) else v) for k, v in blk.items()}
        for blk in params["blocks"]
    ]
    return out


def phase_serve(torch, label, cfg, params, reqs, *, cache_dtype, logit_tol):
    """Serve ``reqs`` through the engine; check every stream teacher-forced
    against the plain dense decode path.  Returns the paged and int4 launch
    counts of the serving run."""
    from k8s_dra_driver_torch.models import decode
    from k8s_dra_driver_torch.models.paged import PagedServeEngine
    from k8s_dra_driver_torch.ops import int4_matmul as i4
    from k8s_dra_driver_torch.ops import paged_attention as pa

    eng = PagedServeEngine(
        params=params, cfg=cfg, n_slots=8, n_blocks=8 * 24 + 1, block_size=16,
        prompt_bucket=256, cache_dtype=cache_dtype, sync_interval=8,
        preempt_on_stall=False, device=DEV,
    )
    sync(torch)
    pa.launches["append"] = pa.launches["window"] = 0
    i4.launches = 0
    t0 = time.perf_counter()
    comps = eng.pump(reqs)
    sync(torch)
    wall = time.perf_counter() - t0
    counts = {"paged_attention": pa.launches["append"],
              "paged_attention_window": pa.launches["window"],
              "int4_matmul": i4.launches}
    generated = sum(len(c.generated) for c in comps)
    if len(comps) != len(reqs):
        raise AssertionError(f"{label}: {len(comps)} completions for {len(reqs)} requests")

    ref = _dense_reference(params)
    by_id = {c.request_id: c for c in comps}
    exact = total = 0
    worst_gap = 0.0
    for rid, (prompt, max_tokens) in enumerate(reqs):
        c = by_id[rid]
        if len(c.generated) != max_tokens:
            raise AssertionError(f"{label}: request {rid} generated {len(c.generated)} of {max_tokens}")
        seq = torch.tensor([c.tokens], device=DEV)
        cache = decode.init_cache(cfg, 1, seq.shape[1], dtype=cache_dtype, device=DEV)
        logits, _ = decode.decode_chunk(ref, cache, seq, 0, cfg=cfg)
        logits = logits[0, len(prompt) - 1 : -1]               # predicts each generated token
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{label}: non-finite reference logits")
        gen = torch.tensor(c.generated, device=DEV)
        best = logits.max(dim=-1).values
        picked = logits.gather(1, gen[:, None])[:, 0]
        gap = (best - picked).max().item()
        worst_gap = max(worst_gap, gap)
        exact += int((logits.argmax(dim=-1) == gen).sum().item())
        total += len(c.generated)
        if gap > logit_tol:
            raise AssertionError(
                f"{label}: request {rid} picked a token {gap:.4g} below the reference argmax"
            )
    log(f"{label}: {len(comps)} requests, {generated} tokens in {wall:.2f} s = "
        f"{generated / wall:.1f} tokens/s; {eng.decode_steps} decode steps, "
        f"{wall / max(eng.decode_steps, 1) * 1e3:.2f} ms wall per step (admissions included); "
        f"host_syncs {eng.host_syncs}, stalled_steps {eng.stalled_steps}")
    log(f"{label}: teacher-forced vs plain dense decode: exact argmax {exact}/{total} "
        f"({exact / total:.4f}), worst logit gap {worst_gap:.4g} (tolerance {logit_tol}: "
        f"{TOL_WHY[cache_dtype == torch.float32]})")
    log(f"{label}: launches {counts}")
    if counts["paged_attention"] == 0:
        raise AssertionError(f"{label}: the paged kernel was never launched")
    steady_decode(torch, label, cfg, params, cache_dtype=cache_dtype)
    return counts


def steady_decode(torch, label, cfg, params, *, cache_dtype, bursts=4):
    """Decode-only step time at the serving batch: 8 resident requests
    (prompt 128; none retires inside the window), ``bursts`` bursts of 8
    steps on the host clock around a synchronised window, then one more
    burst under ``torch.profiler`` for the device's busy share and the
    kernels that take its time.  The least time the card could take for a
    step reads every stored parameter byte and each row's K/V once."""
    from k8s_dra_driver_torch.models.paged import PagedServeEngine
    from k8s_dra_driver_torch.models.quant import quantized_bytes

    eng = PagedServeEngine(
        params=params, cfg=cfg, n_slots=8, n_blocks=8 * 24 + 1, block_size=16,
        prompt_bucket=256, cache_dtype=cache_dtype, sync_interval=8,
        preempt_on_stall=False, device=DEV,
    )
    r = np.random.RandomState(SEED + 7)
    for _ in range(8):
        eng.submit(r.randint(0, cfg.vocab_size, size=128).tolist(), max_tokens=8 * (bursts + 3))
    eng.step_burst()  # warm-up burst
    sync(torch)
    t0 = time.perf_counter()
    for _ in range(bursts):
        eng.step_burst()
    sync(torch)
    ms = (time.perf_counter() - t0) / (8 * bursts) * 1e3
    itemsize = torch.empty((), dtype=cache_dtype).element_size()
    mean_ctx = 128 + 8 + 8 * bursts / 2
    kv = 8 * mean_ctx * 2 * cfg.n_layers * cfg.kv_heads * cfg.head_dim * itemsize
    weights = quantized_bytes(params)[0]
    b_ms, _ = bound(weights + kv, 0, "bfloat16")
    log(f"{label}: steady decode B=8 ctx~{mean_ctx:.0f}: {ms:.3f} ms per step "
        f"({8 / ms * 1e3:.0f} tokens/s); bound {b_ms * 1e3:.1f} us "
        f"({weights / 1e6:.1f} MB parameters + {kv / 1e6:.1f} MB K/V per step)")
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step_burst()
            sync(torch)
            window_us = (time.perf_counter() - t0) * 1e6
        rows = []
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0)
            if dev_us > 0:
                rows.append((dev_us, ev.count, ev.key))
        busy = sum(r_[0] for r_ in rows)
        log(f"{label}: profile of one 8-step burst: window {window_us:.0f} us, device busy "
            f"{busy:.0f} us ({busy / window_us:.3f} of the window)")
        for dev_us, count, key in sorted(rows, reverse=True)[:8]:
            log(f"    {dev_us:9.0f} us  {dev_us / busy:.3f}  x{count:<5d} {key[:90]}")
    except Exception as exc:  # the profiler is a reading aid, not a check
        log(f"{label}: profile not taken: {type(exc).__name__}: {exc}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only", file=sys.stderr)
        return 2
    try:
        from k8s_dra_driver_torch.models import burnin, quant
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 1

    # every float32 comparison below is against full-precision products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed = []
    launches: dict = {}
    kernel_numbers: dict = {}

    def run(name, fn):
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception:
            traceback.print_exc()
            log(f"== phase {name}: FAILED")
            failed.append(name)
            return None
        log(f"== phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
        return out

    card = run("environment", lambda: phase_environment(torch))
    if card is None:
        return 1
    timer = Timer(torch)
    kernel_numbers = run("kernels", lambda: phase_kernels(torch, timer)) or {}

    cfg = burnin.FLAGSHIP_MODERN
    reqs = _traffic(cfg.vocab_size, 16, 256, 128, SEED)
    params = burnin.init_params(torch.Generator(device=DEV).manual_seed(SEED), cfg)

    def serve_bf16():
        launches["bf16"] = phase_serve(
            torch, "serve bf16", cfg, params, reqs, cache_dtype=torch.bfloat16, logit_tol=0.25,
        )

    def serve_int4():
        p4 = quant.quantize_blocks(params, bits=4)
        launches["int4"] = phase_serve(
            torch, "serve int4", cfg, p4, reqs, cache_dtype=torch.bfloat16, logit_tol=0.25,
        )
        if launches["int4"]["int4_matmul"] == 0:
            raise AssertionError("the int4 kernel was never launched")

    def serve_f32():
        cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
        p32 = burnin.init_params(torch.Generator(device=DEV).manual_seed(SEED + 1), cfg32)
        reqs32 = _traffic(cfg32.vocab_size, 8, 256, 64, SEED + 1)
        launches["f32"] = phase_serve(
            torch, "serve f32", cfg32, p32, reqs32, cache_dtype=torch.float32, logit_tol=1e-3,
        )

    run("serve bf16", serve_bf16)
    run("serve int4", serve_int4)
    run("serve f32", serve_f32)

    if failed:
        log(f"chip_smoke: failed phases {failed}")
        return 1
    main_counts = {
        "paged_attention": launches["bf16"]["paged_attention"],
        "int4_matmul": launches["int4"]["int4_matmul"],
    }
    log(f"card: {card}")
    kernels = []
    for name, meta in KERNELS.items():
        nums = kernel_numbers[name]
        kernels.append({
            "name": name, **meta, "launches": main_counts[name],
            "max_abs_err": nums["max_abs_err"], "ms": nums["ms"], "plain_ms": nums["plain_ms"],
            "bound_ms": nums["bound_ms"], "bound_by": nums["bound_by"],
            "library_ms": nums["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
