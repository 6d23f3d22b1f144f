#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure fails the run, exit code 1; without a CUDA device it
exits 2 before any result):

1. environment: the card's name and power limit; the three kernel sources
   built from ``k8s_dra_driver_torch/csrc`` with ``nvcc``, all started
   together (ptxas report printed; the D 64 backward kernels, bf16 and
   f32, must not spill; the f32 backward's registers and shared memory
   printed);
2. serving kernels against their plain PyTorch versions on the card, at the
   serving path's shapes (FLAGSHIP_MODERN: Hq 16 / Hkv 4 / d 64, L 8,
   block 16, B 8, context 512, ragged lengths up to 1024 and rows at the
   paged kernel's split boundaries, elementwise; the paged append call
   timed for each split size of a sweep; int4 at M 8 (the split-K
   kernel) and 256 (the wgmma kernel in bf16) over the four block
   matrices, elementwise, repeated calls bit for bit), with each tolerance
   and its reason, and each kernel's time beside the plain version's, a
   one-call PyTorch yardstick the port never calls, and the least time the
   card could take;
3. the flash kernels (forward, dQ, dK/dV) the same way, at the training
   path's shapes (B·H 64, S 256 and 1024, D 64, causal and full, f32 and
   bf16), timed at B·H 64, S 1024, causal, bf16 beside SDPA's forward and
   its backward through autograd, and the f32 kernels beside SDPA in f32
   (one profiled f32 backward; the f32 backward also at D 128);
4. serving FLAGSHIP_MODERN (random weights from a seed, bf16 weights and
   pool) through ``PagedServeEngine.pump``: every stream checked
   teacher-forced against the plain dense decode path;
5. the same with int4 block weights (decode steps through the split-K int4
   kernel, admissions through the wgmma one; both must launch);
6. the same in f32 at reduced depth;
7. training FLAGSHIP_MODERN at full width in bf16 through
   ``build_train_step(attention="flash")`` (B 4, S 1024, remat "blocks"):
   step 0's loss and gradients against ``attention="dense"``, then 8 steps
   on one batch with the loss falling and the flash kernels' launches
   counted (bf16 through the wgmma kernels only), the step time, and the
   device time by kernel of one step;
8. training in f32 at 2 layers: flash against dense over 3 steps (through
   the fma kernels only).

The line before the last lists the kernels with their launch counts on the
path that runs them (serving or training) and their times; the last line is
the JSON device record.
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
    "paged_attention_window": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/paged_attention.cu",
        replaces="k8s_dra_driver_tpu/ops/paged_attention.py:396",
    ),
    # one CUDA source, two kernels chosen by M and dtype: the split-K GEMV
    # (bf16 decode, M <= 16; f32 at every M) and the wgmma GEMM (bf16 prefill)
    "int4_matmul": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/int4_matmul.cu",
        replaces="k8s_dra_driver_tpu/ops/int4_matmul.py:41",
    ),
    "int4_matmul_prefill": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/int4_matmul.cu",
        replaces="k8s_dra_driver_tpu/ops/int4_matmul.py:41",
    ),
    # each flash pass: TMA + wgmma for bf16 (the training path), f32 FMAs
    # on the CUDA cores for f32 (the f32 training phase)
    "flash_fwd": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/flash_attention.cu",
        replaces="k8s_dra_driver_tpu/ops/flash_attention.py:31",
    ),
    "flash_fwd_f32": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/flash_attention.cu",
        replaces="k8s_dra_driver_tpu/ops/flash_attention.py:31",
    ),
    "flash_bwd_dq": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/flash_attention.cu",
        replaces="k8s_dra_driver_tpu/ops/flash_attention.py:137",
    ),
    "flash_bwd_dkv": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/flash_attention.cu",
        replaces="k8s_dra_driver_tpu/ops/flash_attention.py:179",
    ),
    "flash_bwd_dq_f32": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/flash_attention.cu",
        replaces="k8s_dra_driver_tpu/ops/flash_attention.py:137",
    ),
    "flash_bwd_dkv_f32": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/flash_attention.cu",
        replaces="k8s_dra_driver_tpu/ops/flash_attention.py:179",
    ),
}
# kernels whose ptxas report must show 0 bytes of spill stores: the D 64
# backward kernels, bf16 and f32
NO_SPILL = ("flash_bwd_dq_wgmma_kernelILi64E", "flash_bwd_dkv_wgmma_kernelILi64E",
            "flash_bwd_dq_fma_kernelILi64E", "flash_bwd_dkv_fma_kernelILi64E")
KERNEL_SOURCES = ["int4_matmul", "paged_attention", "flash_attention"]


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
    # built from the sources every run: a library left by an earlier run
    # would be loaded without a ptxas report to check
    for name in KERNEL_SOURCES:
        _build.library_path(name).unlink(missing_ok=True)
    _build.build(KERNEL_SOURCES)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    spills, regs = {}, {}
    for name, report in _build.ptxas_reports.items():
        log(f"--- ptxas -v: {name}.cu")
        entry = ""
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("   ", line.strip())
            if "Compiling entry" in line:
                entry = line
            elif any(k in entry for k in NO_SPILL):
                key = entry.split("'")[1]
                if "spill stores" in line:
                    stores = int(line.split("bytes spill stores")[0].split(",")[-1])
                    spills[key] = max(spills.get(key, 0), stores)
                elif "registers" in line:
                    regs[key] = int(line.split("Used")[1].split("registers")[0])
    log(f"spill stores of the D 64 backward kernels (bf16, f32): {spills}")
    fma_smem = flash_fma_smem()
    for k in NO_SPILL[2:]:
        key = next((e for e in regs if k in e), None)
        kind = "dkv" if "dkv" in k else "dq"
        log(f"  {k}: {regs.get(key)} registers, {spills.get(key)} bytes of spill stores; "
            f"dynamic shared memory by head dim {fma_smem[kind]} bytes (a block may have "
            f"232448)")
    if len(spills) != len(NO_SPILL) or any(spills.values()):
        raise AssertionError(f"the D 64 backward kernels spill or were not reported: {spills}")
    if max(max(v.values()) for v in fma_smem.values()) > 232448:
        raise AssertionError(f"an f32 backward kernel asks for too much shared memory: {fma_smem}")
    return card


def flash_fma_smem():
    """{"dq"/"dkv": {head dim: bytes of dynamic shared memory}} of the f32
    backward kernels, as their launchers ask for it."""
    import ctypes

    from k8s_dra_driver_torch.ops import _build
    from k8s_dra_driver_torch.ops import flash_attention as fa

    fn = _build.load("flash_attention", fa._LAUNCHERS).flash_bwd_fma_smem
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return {kind: {d: fn(d, int(kind == "dkv")) for d in fa.KERNEL_HEAD_DIMS}
            for kind in ("dq", "dkv")}


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


PAGED_STEP = {
    # every paged output element is held to
    #   min(step * (|plain| + mag) + 2^-16 * mag, cap),
    # mag the plain version's softmax weights applied to |V| in f32, so an
    # element summed from large terms gets their rounding and a large one
    # its own; cap is the absolute limit this check held before, so no
    # element is held more loosely than it was
    "float32": (2 ** -16, 1e-4, "f32 sums in another order: splits merged by their (m, l) "
                                "against one softmax over the row"),
    "bfloat16": (2 ** -7 + 2 ** -16, 3e-2, "one bf16 step: P rounded to bf16 on each side, in "
                                           "the kernel against its split's max before "
                                           "normalisation, in the plain version after it, both "
                                           "within one step of mag; the output rounded once"),
}


def paged_check(got, want, mag, step, cap):
    """(max |err|, the limit at that element, max |plain|, elements over
    their limit)."""
    if mag.shape != want.shape:
        raise AssertionError(f"mag {tuple(mag.shape)} does not match {tuple(want.shape)}")
    limit = (step * (want.float().abs() + mag) + 2 ** -16 * mag).clamp(max=cap)
    err = (got.float() - want.float()).abs()
    worst = int(err.argmax())
    return (err.max().item(), limit.flatten()[worst].item(), want.float().abs().max().item(),
            int((err > limit).sum().item()))


def _workspace_bytes(lengths, nq, hq, hkv, d, bs, mb):
    """(bytes of the live splits' partials, each written once and read
    once; bytes allocated) of one paged call."""
    from k8s_dra_driver_torch.ops import paged_attention as pa

    pages, n_splits = pa.split_schedule(bs, mb)
    row = hkv * (hq // hkv) * nq * (d + 2) * 4
    live = sum(-(-min(-(-(max(n - nq, 0) + nq) // bs), mb) // pages) for n in lengths)
    return live * row, len(lengths) * n_splits * row


def phase_kernels(torch, timer: Timer):
    import torch.nn.functional as F

    from k8s_dra_driver_torch.ops import paged_attention as pa

    results = {}
    ragged = [1, 1024] + np.random.RandomState(SEED).randint(2, 1024, size=6).tolist()
    split = pa.split_schedule(16, 64)[0] * 16
    # rows at the split boundaries: with nq 4, pos = split - 1 leaves the
    # second split masked for query 0, and pos = split - 2 puts the window
    # across a page and a split boundary
    edges = [1, split - 1, split, split + 1, split + 2, split + 3, 1024, 2 * split + 3]
    worst = {"append": 0.0, "window": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        step, cap, why = PAGED_STEP[dname]
        log(f"paged tolerance {dname}: |err| <= min({step:.4g} * (|plain| + mag) + 2^-16 * mag, "
            f"{cap:g}) per element, mag = the plain softmax weights applied to |V| in f32 "
            f"({why}; {cap:g} is the earlier absolute limit)")
        for nq in (1, 4):
            for label, lengths in (("ctx512", [512] * 8), ("ragged", ragged), ("edges", edges)):
                kp, vp, table, pos, q, nk, nv = _paged_case(torch, dtype, nq, lengths)
                wmask = (torch.arange(8, device=DEV) % 3 != 1).to(torch.int32)
                layer = 3
                mag = pa.paged_append_attention_plain(
                    q.float(), nk.float(), nv.float().abs(), kp.float(), vp.float().abs(),
                    table, pos, layer, write_mask=wmask,
                )
                k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
                del kp, vp
                out_k, _, _ = pa.paged_append_attention(q, nk, nv, k1, v1, table, pos, layer,
                                                        write_mask=wmask)
                out_p = pa.paged_append_attention_plain(q, nk, nv, k2, v2, table, pos, layer,
                                                        write_mask=wmask)
                again, _, _ = pa.paged_append_attention(q, nk, nv, k1, v1, table, pos, layer,
                                                        write_mask=wmask)
                sync(torch)
                err, limit, top, over = paged_check(out_k, out_p, mag, step, cap)
                same = bool(torch.equal(again, out_k))
                pools_equal = bool(torch.equal(k1[:, 1:], k2[:, 1:])
                                   and torch.equal(v1[:, 1:], v2[:, 1:]))
                case = f"{dname} nq={nq} {label} lengths={lengths}"
                log(f"  append {case}: max_abs_err {err:.3g}, limit there {limit:.3g}, "
                    f"max|plain| {top:.3g}; elements over the limit {over}; a second call "
                    f"bit-identical: {same}; pools equal outside block 0: {pools_equal}")
                if over or not same or not pools_equal:
                    raise AssertionError(f"paged append kernel disagrees ({case})")
                del k1, v1
                # window / decode: the window keys are in the pool now (k2, v2)
                mag_w = pa.paged_window_attention_plain(
                    q.float(), k2[layer].float(), v2[layer].float().abs(), table, pos
                )
                out_w = pa.paged_window_attention(q, k2[layer], v2[layer], table, pos)
                out_wp = pa.paged_window_attention_plain(q, k2[layer], v2[layer], table, pos)
                same_w = bool(torch.equal(
                    pa.paged_window_attention(q, k2[layer], v2[layer], table, pos), out_w))
                errw, limitw, topw, overw = paged_check(out_w, out_wp, mag_w, step, cap)
                log(f"  window {case}: max_abs_err {errw:.3g}, limit there {limitw:.3g}, "
                    f"max|plain| {topw:.3g}; elements over the limit {overw}; a second call "
                    f"bit-identical: {same_w}")
                if overw or not same_w:
                    raise AssertionError(f"paged window kernel disagrees ({case})")
                if nq == 1:
                    lens = pos + 1
                    out_d = pa.paged_decode_attention(q[:, 0], k2[layer], v2[layer], table, lens)
                    errd, limitd, _, overd = paged_check(out_d, out_wp[:, 0], mag_w[:, 0], step,
                                                          cap)
                    log(f"  decode {case}: max_abs_err {errd:.3g}, limit there {limitd:.3g}; "
                        f"elements over the limit {overd}")
                    if overd:
                        raise AssertionError(f"paged decode kernel disagrees ({case})")
                if dtype == torch.bfloat16:
                    worst["append"] = max(worst["append"], err)
                    worst["window"] = max(worst["window"], errw)
                del k2, v2

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
        def sdpa():
            return F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask)

        ms_lib = timer.ms(sdpa)  # the yardstick of both the append and the read-only kernel
        ww = _paged_work(lengths, 1, 16, 4, 64, 16, 2, append=False)
        b_ms, b_by = bound(w[0], w[1], "bfloat16")
        bw_ms, bw_by = bound(ww[0], ww[1], "bfloat16")
        ws_live, ws_alloc = _workspace_bytes(lengths, 1, 16, 4, 64, 16, 64)
        log(f"  paged append bf16 B=8 nq=1 {label}: kernel {ms_k * 1e3:.1f} us, plain "
            f"{ms_p * 1e3:.1f} us, sdpa {ms_lib * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us "
            f"({b_by}, {w[0] / 1e6:.2f} MB, {w[1] / 1e6:.1f} MFLOP); workspace "
            f"{ws_live / 1e3:.1f} KB of live partials, each written once and read once "
            f"({ws_alloc / 1e3:.1f} KB allocated)")
        log(f"  paged window bf16 B=8 nq=1 {label}: kernel {ms_wk * 1e3:.1f} us, plain "
            f"{ms_wp * 1e3:.1f} us, sdpa {ms_lib * 1e3:.1f} us, bound {bw_ms * 1e3:.2f} us "
            f"({bw_by})")
        if label == "ctx512":
            # what the events see besides the kernels, and each launch's
            # own device time on a cold L2
            floor = timer.ms(lambda: None)
            log(f"  timer floor (nothing between the events): {floor * 1e3:.1f} us")

            def append():
                pa.paged_append_attention(q, nk, nv, kp, vp, table, pos, layer)

            def cold_call():
                timer.flush.zero_()
                append()

            for what, fn in (("after an L2 flush", cold_call), ("warm, run again", append)):
                profile_window(torch, f"  paged append bf16 B=8 nq=1 ctx512 {what}", fn, top=0,
                               watch=("paged_attention_partial", "paged_attention_merge"))
            results["paged_attention"] = dict(
                ms=ms_k, plain_ms=ms_p, library_ms=ms_lib, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=worst["append"],
            )
            results["paged_attention_window"] = dict(
                ms=ms_wk, plain_ms=ms_wp, library_ms=ms_lib, bound_ms=bw_ms,
                bound_by=bw_by, max_abs_err=worst["window"],
            )
    paged_split_sweep(torch, timer)

    results.update(phase_int4(torch, timer))
    return results


def paged_split_sweep(torch, timer: Timer, keys=(32, 64, 128)):
    """The append call's time at B=8, bf16, nq=1 for each split size, at
    context 512 and at the steady-decode context ~152, the module's split
    size restored after."""
    from k8s_dra_driver_torch.ops import paged_attention as pa

    kept = pa.SPLIT_KEYS
    cases = {n: _paged_case(torch, torch.bfloat16, 1, [n] * 8) for n in (512, 152)}
    try:
        for split_keys in keys:
            pa.SPLIT_KEYS = split_keys
            times = []
            for n, (kp, vp, table, pos, q, nk, nv) in cases.items():
                ms = timer.ms(lambda: pa.paged_append_attention(q, nk, nv, kp, vp, table, pos, 3))
                times.append(f"ctx {n} {ms * 1e3:.1f} us")
            log(f"  paged split sweep: {split_keys} keys per split "
                f"({pa.split_schedule(16, 64)[0]} pages): {', '.join(times)}"
                f"{' (the module constant)' if split_keys == kept else ''}")
    finally:
        pa.SPLIT_KEYS = kept


INT4_STEP = {
    # every int4 output element is held to step * |plain| + 2^-16 * mag,
    # mag = |x| @ |dequant(W)| in f32: both sides sum the same f32 products
    # in another order, then round the output once
    "float32": (0.0, "f32 sums in another order (split-K slices, shuffle trees); TF32 off"),
    "bfloat16": (2 ** -7 + 2 ** -16, "one bf16 step: the f32 sums, in another order, may "
                                     "round the output to the neighbouring bf16 value"),
}


def int4_check(x, packed, scale, got, want, step):
    """(max |err|, the limit at that element, max |plain|, RMS of plain,
    elements over their limit)."""
    import torch

    from k8s_dra_driver_torch.ops import int4_matmul as i4

    w = i4.dequant_int4(packed, scale, 64, x.dtype).float()
    mag = x.float().abs() @ w.abs()
    limit = step * want.float().abs() + 2 ** -16 * mag
    err = (got.float() - want.float()).abs()
    worst = int(err.argmax())
    w32 = want.float()
    return (err.max().item(), limit.flatten()[worst].item(), w32.abs().max().item(),
            w32.square().mean().sqrt().item(), int((err > limit).sum().item()))


def phase_int4(torch, timer: Timer, ms=(8, 256)):
    """Both int4 kernels at the serving path's shapes (the four block
    matrices of FLAGSHIP_MODERN; M 8 at decode, 256 at the prompt bucket)
    against the plain version, elementwise, in bf16 and f32; identity rows
    through both; repeated calls bit for bit; then timed in bf16 beside
    the plain version and ``torch.matmul`` on the dequantized weight."""
    from k8s_dra_driver_torch.models import quant
    from k8s_dra_driver_torch.ops import int4_matmul as i4

    g = torch.Generator(device=DEV).manual_seed(SEED + 2)
    shapes = {"qkv": (1024, 1536), "attn_out": (1024, 1024),
              "mlp_up": (1024, 4096), "mlp_down": (4096, 1024)}
    for dname, (step, why) in INT4_STEP.items():
        log(f"int4 tolerance {dname}: |err| <= {step:.4g} * |plain| + 2^-16 * mag per element, "
            f"mag = |x| @ |dequant(W)| ({why})")
    worst = {"int4_splitk": 0.0, "int4_wgmma": 0.0}
    results = {}
    for name, (k, n) in shapes.items():
        wq = quant.Quantized4Matrix.quantize(
            (torch.randn((k, n), generator=g, device=DEV) * k ** -0.5).to(torch.bfloat16)
        )
        w_deq = wq.dequant()
        if name == "qkv":
            # x = identity rows: the kernels' dequantized weights, read exactly
            eye = torch.eye(k, dtype=torch.bfloat16, device=DEV)
            for rows in (8, k):
                got = i4.int4_matmul(eye[:rows], wq.packed, wq.scale, 64)
                exact = bool(torch.equal(got, w_deq[:rows]))
                log(f"  int4 dequant through {i4.kernel_for(rows, torch.bfloat16)} ({rows} "
                    f"identity rows) bit-identical to dequant(): {exact}")
                if not exact:
                    raise AssertionError("int4 kernel's dequantized weights differ")
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            for m in ms:
                x = torch.randn((m, k), generator=g, device=DEV).to(dtype)
                kern = i4.kernel_for(m, dtype)
                o = i4.int4_matmul(x, wq.packed, wq.scale, 64)
                op = i4.int4_matmul_plain(x, wq.packed, wq.scale, 64)
                again = i4.int4_matmul(x, wq.packed, wq.scale, 64)
                sync(torch)
                err, limit, top, rms, over = int4_check(x, wq.packed, wq.scale, o, op,
                                                        INT4_STEP[dname][0])
                same = bool(torch.equal(o, again))
                log(f"  int4 {name} {dname} M={m} ({kern}): max_abs_err {err:.3g}, limit there "
                    f"{limit:.3g}, max|plain| {top:.3g}, rms {rms:.3g}; elements over the limit "
                    f"{over}; a second call bit-identical: {same}")
                if over or not same:
                    raise AssertionError(f"int4 {kern} disagrees ({name}, {dname}, M={m})")
                if dtype == torch.bfloat16:
                    worst[kern] = max(worst[kern], err)
        for m in ms:
            x = torch.randn((m, k), generator=g, device=DEV).to(torch.bfloat16)
            kern = i4.kernel_for(m, torch.bfloat16)
            ms_k = timer.ms(lambda: i4.int4_matmul(x, wq.packed, wq.scale, 64))
            ms_p = timer.ms(lambda: i4.int4_matmul_plain(x, wq.packed, wq.scale, 64))
            ms_lib = timer.ms(lambda: torch.matmul(x, w_deq))
            moved = m * k * 2 + k * n // 2 + (k // 64) * n * 4 + m * n * 2
            b_ms, b_by = bound(moved, 2 * m * k * n, "bfloat16")
            log(f"  int4 {name} M={m} K={k} N={n} ({kern}): kernel {ms_k * 1e3:.1f} us, plain "
                f"{ms_p * 1e3:.1f} us, matmul(dequantized) {ms_lib * 1e3:.1f} us, bound "
                f"{b_ms * 1e3:.2f} us ({b_by}, {moved / 1e6:.2f} MB, {2 * m * k * n / 1e9:.3f} "
                f"GFLOP)")
            if name == "mlp_up":
                results[kern] = dict(ms=ms_k, plain_ms=ms_p, library_ms=ms_lib, bound_ms=b_ms,
                                     bound_by=b_by)
    for kern in worst:
        results[kern]["max_abs_err"] = worst[kern]
    return {"int4_matmul": results["int4_splitk"], "int4_matmul_prefill": results["int4_wgmma"]}


FLASH_STEP = {
    # every flash output is held elementwise to
    #   step * (|plain| + mag) + 2^-16 * mag_f32,
    # mag the same sum over absolute terms (out: sum_k p|v| / l; dq:
    # scale sum_k |ds||k|; dk: scale sum_q |ds||q|; dv: sum_q p|dout|), so
    # a near-zero element summed from large terms gets their rounding and a
    # large one its own; mag_f32 is mag for out and dv, and for dq and dk
    # it takes p (|dout||v| + |dout||out|), the absolute size of the two
    # f32 dots whose difference dS is, in place of |dS|: the order of f32
    # sums decides dS near 0 (the first causal row's dS cancels to 0)
    "float32": (2 ** -16, "f32 sums in another order: 64-key tiles with an online rescale "
                          "against one pass in the forward, the kernels' FMA order against "
                          "cuBLAS's in the backward; TF32 off"),
    "bfloat16": (2 ** -7 + 2 ** -16, "one bf16 step: the forward rounds every P to bf16 on "
                                     "each side (against the running max in the kernel, the "
                                     "row's max in the plain version); in the backward, f32 "
                                     "sums in another order move a rounding of P or dS to "
                                     "the next bf16 value; each output is rounded once"),
}


def flash_limits(q, k, v, dout, causal, want, step):
    """Elementwise limits for ``want``, the plain versions' (out, lse, dq,
    dk, dv), the backward run on that out and lse: as ``FLASH_STEP`` says;
    lse within 2^-16 (1 + |lse|)."""
    import torch

    from k8s_dra_driver_torch.ops import flash_attention as fa

    out_p, lse_p = want[:2]
    mag = fa.flash_forward_plain(q, k, v.abs(), causal, out_dtype=torch.float32)[0]
    limits = [step * (out_p.float().abs() + mag) + 2 ** -16 * mag,
              2 ** -16 * (1 + lse_p.abs())]
    d32, v32, q32, k32 = (x.float() for x in (dout, v, q, k))
    p = torch.exp(fa._scores(q, k, causal) - lse_p[..., None])
    dp = torch.einsum("bqd,bkd->bqk", d32, v32)
    ds = (p * (dp - fa._delta(dout, out_p)[..., None])).to(q.dtype).float().abs()
    dots = p * (torch.einsum("bqd,bkd->bqk", d32.abs(), v32.abs())
                + (d32 * out_p.float()).abs().sum(-1)[..., None])
    sc = fa._scale(q.shape[-1])
    dq_p, dk_p, dv_p = (x.float().abs() for x in want[2:])
    return limits + [
        step * dq_p + sc * torch.einsum("bqk,bkd->bqd", step * ds + 2 ** -16 * dots, k32.abs()),
        step * dk_p + sc * torch.einsum("bqk,bqd->bkd", step * ds + 2 ** -16 * dots, q32.abs()),
        step * dv_p + (step + 2 ** -16) * torch.einsum(
            "bqk,bqd->bkd", p.to(dout.dtype).float(), d32.abs()),
    ]


def flash_check(got, want, limits):
    """Per output of (out, lse, dq, dk, dv): (max |err|, the limit at that
    element, max |plain|, RMS of plain, elements over their limit,
    elements that differ at all)."""
    rows = {}
    for name, g_, w_, limit in zip(("out", "lse", "dq", "dk", "dv"), got, want, limits):
        w32 = w_.float()
        err = (g_.float() - w32).abs()
        worst = int(err.argmax())
        rows[name] = (err.max().item(), limit.flatten()[worst].item(), w32.abs().max().item(),
                      w32.square().mean().sqrt().item(), int((err > limit).sum().item()),
                      int((g_ != w_).sum().item()))
    return rows


def _flash_work(bh, s, d, itemsize, causal):
    """(bytes, operations) of the forward, dQ and dK/dV at these shapes:
    each input read once, each output written once (lse and delta f32);
    2 operations per multiply-add over the (query, key) pairs attended."""
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    slab = bh * s * d * itemsize
    rows = bh * s * 4
    return {
        "flash_fwd": (3 * slab + slab + rows, 4 * pairs * d),         # QK, PV
        "flash_bwd_dq": (4 * slab + 2 * rows + slab, 6 * pairs * d),  # QK, dO.V, dS.K
        "flash_bwd_dkv": (4 * slab + 2 * rows + 2 * slab, 8 * pairs * d),  # + P.dO, dS.Q
    }


def phase_flash_kernels(torch, timer: Timer, bh: int = 64, seqs=(256, 1024), d: int = 64):
    """The flash kernels against their plain versions at the training
    path's shapes (B·H = 4 x 16 heads, D 64), then timed at the main path's
    (S 1024, causal) in bf16 and f32 beside the plain versions and SDPA."""
    import torch.nn.functional as F

    from k8s_dra_driver_torch.ops import flash_attention as fa

    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    worst = dict.fromkeys(names + tuple(n + "_f32" for n in names), 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        step, why = FLASH_STEP[dname]
        log(f"flash tolerance {dname}: out, dq, dk, dv each |err| <= {step:.4g} * (|plain| + "
            f"mag) + 2^-16 * mag_f32 per element, mag = the same sum over absolute terms, "
            f"mag_f32 = mag (out, dv) or the sum over dS's two f32 dots taken absolutely (dq, "
            f"dk) ({why}); "
            f"lse |err| <= 2^-16 * (1 + |lse|)")
        for s in seqs:
            for causal in (True, False):
                g = torch.Generator(device=DEV).manual_seed(SEED + s + causal)
                q, k, v, dout = (torch.randn((bh, s, d), generator=g, device=DEV).to(dtype)
                                 for _ in range(4))
                out, lse = fa._forward_bhsd(q, k, v, causal)
                out_p, lse_p = fa.flash_forward_plain(q, k, v, causal)
                # the backward kernels and their plain versions see the same
                # inputs: the plain forward's out and lse
                grads = fa._backward_bhsd(q, k, v, out_p, lse_p, dout, causal)
                grads_p = fa.flash_backward_plain(q, k, v, out_p, lse_p, dout, causal)
                sync(torch)
                want = (out_p, lse_p, *grads_p)
                rows = flash_check((out, lse, *grads), want,
                                   flash_limits(q, k, v, dout, causal, want, step))
                errs = {n: r[0] for n, r in rows.items()}
                case = f"{dname} BH={bh} S={s} D={d} causal={causal}"
                for name, (err, limit, top, rms, over, differ) in rows.items():
                    log(f"  flash {case} {name}: max_abs_err {err:.3g}, limit there "
                        f"{limit:.3g}, max|plain| {top:.3g}, rms {rms:.3g}; elements over "
                        f"the limit {over}, differing at all {differ}")
                    if over:
                        raise AssertionError(f"flash {name} disagrees ({case}): {over} elements "
                                             f"over their limit")
                tag = "_f32" if dtype == torch.float32 else ""
                for name, err in (("flash_fwd", errs["out"]), ("flash_bwd_dq", errs["dq"]),
                                  ("flash_bwd_dkv", max(errs["dk"], errs["dv"]))):
                    worst[name + tag] = max(worst[name + tag], err)

    # times at the main path's shape, in bf16 (the training path) and f32,
    # beside yardsticks the port never calls: SDPA's forward, and its
    # backward through autograd (dQ, dK and dV together) on [B, H, S, D] =
    # [4, 16, S, 64]
    s = seqs[-1]
    g = torch.Generator(device=DEV).manual_seed(SEED + 11)
    inputs = [torch.randn((bh, s, d), generator=g, device=DEV).to(torch.bfloat16)
              for _ in range(4)]
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        tag = "_f32" if dtype == torch.float32 else ""
        q, k, v, dout = (x.to(dtype) for x in inputs)
        out, lse = fa._forward_bhsd(q, k, v, True)
        delta = fa._delta(dout, out)
        ms = {
            "flash_fwd": (timer.ms(lambda: fa._forward_bhsd(q, k, v, True)),
                          timer.ms(lambda: fa.flash_forward_plain(q, k, v, True))),
            "flash_bwd_dq": (timer.ms(lambda: fa._dq_bhsd(q, k, v, lse, dout, delta, True)),
                             timer.ms(lambda: fa._dq_plain(q, k, v, lse, dout, delta, True))),
            "flash_bwd_dkv": (timer.ms(lambda: fa._dkv_bhsd(q, k, v, lse, dout, delta, True)),
                              timer.ms(lambda: fa._dkv_plain(q, k, v, lse, dout, delta, True))),
        }
        qs, ks, vs = (x.reshape(-1, 16, s, d).detach().requires_grad_() for x in (q, k, v))
        ms_sdpa = timer.ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True))
        o_sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        do_sdpa = dout.reshape(-1, 16, s, d)
        ms_sdpa_bwd = timer.ms(
            lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), do_sdpa, retain_graph=True)
        )
        work = _flash_work(bh, s, d, q.element_size(), True)
        kern = dict(zip(names, kern_names(fa, dtype)))
        for name in names:
            b_ms, b_by = bound(*work[name], dname)
            lib = ms_sdpa if name == "flash_fwd" else ms_sdpa_bwd
            results[name + tag] = dict(ms=ms[name][0], plain_ms=ms[name][1], library_ms=lib,
                                       bound_ms=b_ms, bound_by=b_by,
                                       max_abs_err=worst[name + tag])
            log(f"  {name} {dname} ({kern[name]}) BH={bh} S={s} D={d} causal: kernel "
                f"{ms[name][0] * 1e3:.1f} us, plain {ms[name][1] * 1e3:.1f} us, sdpa "
                f"{'fwd' if name == 'flash_fwd' else 'bwd'} {lib * 1e3:.1f} us, bound "
                f"{b_ms * 1e3:.2f} us ({b_by}, {work[name][0] / 1e6:.1f} MB, "
                f"{work[name][1] / 1e9:.2f} GFLOP; the kernel at {b_ms / ms[name][0]:.3f} "
                f"of the bound's rate)")
        log(f"  sdpa {dname} backward covers dQ and dK/dV together: kernels "
            f"{(ms['flash_bwd_dq'][0] + ms['flash_bwd_dkv'][0]) * 1e3:.1f} us against "
            f"{ms_sdpa_bwd * 1e3:.1f} us")
        if dtype == torch.float32:
            profile_window(
                torch, f"  flash f32 backward (dQ, dK/dV) BH={bh} S={s} D={d} causal",
                lambda: (fa._dq_bhsd(q, k, v, lse, dout, delta, True),
                         fa._dkv_bhsd(q, k, v, lse, dout, delta, True)),
                top=2, watch=kern_names(fa, dtype)[1:])
    flash_f32_backward_d128(torch, timer, bh, s)
    return results


def kern_names(fa, dtype):
    return (fa.forward_kernel_for(dtype), *fa.backward_kernel_for(dtype))


def flash_f32_backward_d128(torch, timer: Timer, bh: int, s: int, d: int = 128):
    """The f32 backward pair at D 128 (S ``s``, causal), where its shared
    memory is tightest, timed beside SDPA's f32 backward on the same
    inputs."""
    import torch.nn.functional as F

    from k8s_dra_driver_torch.ops import flash_attention as fa

    g = torch.Generator(device=DEV).manual_seed(SEED + 12)
    q, k, v, dout = (torch.randn((bh, s, d), generator=g, device=DEV) for _ in range(4))
    out, lse = fa._forward_bhsd(q, k, v, True)
    delta = fa._delta(dout, out)
    ms = {"flash_bwd_dq": timer.ms(lambda: fa._dq_bhsd(q, k, v, lse, dout, delta, True)),
          "flash_bwd_dkv": timer.ms(lambda: fa._dkv_bhsd(q, k, v, lse, dout, delta, True))}
    qs, ks, vs = (x.reshape(-1, 16, s, d).detach().requires_grad_() for x in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    ms_sdpa = timer.ms(lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), dout.reshape(-1, 16, s, d),
                                                   retain_graph=True))
    work = _flash_work(bh, s, d, 4, True)
    for name, kern in zip(ms, fa.backward_kernel_for(torch.float32)):
        b_ms, b_by = bound(*work[name], "float32")
        log(f"  {name} float32 ({kern}) BH={bh} S={s} D={d} causal: kernel "
            f"{ms[name] * 1e3:.1f} us, sdpa bwd {ms_sdpa * 1e3:.1f} us, bound {b_ms * 1e3:.2f} "
            f"us ({b_by}, {work[name][0] / 1e6:.1f} MB, {work[name][1] / 1e9:.2f} GFLOP; the "
            f"kernel at {b_ms / ms[name]:.3f} of the bound's rate)")
    log(f"  sdpa float32 backward at D {d} covers dQ and dK/dV together: kernels "
        f"{sum(ms.values()) * 1e3:.1f} us against {ms_sdpa * 1e3:.1f} us")


def train_flops(cfg, batch: int, seq: int) -> int:
    """Model FLOPs of one train step as ``bench.py``'s ``_train_mfu``
    counts them: 6 per weight per token (no credit for the remat
    re-forward) plus 12·B·S²·d per layer for attention."""
    from k8s_dra_driver_torch.models.burnin import block_matrix_shapes

    block = sum(a * b for a, b in block_matrix_shapes(cfg).values())
    weights = cfg.n_layers * block + cfg.vocab_size * cfg.d_model
    return 6 * weights * batch * seq + 12 * batch * seq * seq * cfg.d_model * cfg.n_layers


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30)).item()


TRAIN_TOL = {
    # (loss relative, gradient leaf relative L2, why)
    "bfloat16": (1e-3, 5e-2, "both paths in bf16, rounded at other points (dense: bf16 "
                 "scores before the f32 softmax; flash: f32 scores, P rounded per tile); a "
                 "CPU rehearsal at 2 layers put each within ~1.3% (rel L2) of f32"),
    "float32": (1e-5, 1e-4, "f32 throughout, TF32 off; the two attentions sum in another "
                "order"),
}


def phase_train_bf16(torch, cfg, steps: int = 8, b: int = 4):
    """bf16 training of ``cfg`` at S = max_seq through the flash kernels;
    returns the kernels' launch counts over the ``steps`` main-path steps."""
    from k8s_dra_driver_torch.models import burnin
    from k8s_dra_driver_torch.ops import flash_attention as fa

    s = cfg.max_seq
    tokens = torch.from_numpy(
        np.random.RandomState(SEED + 3).randint(0, cfg.vocab_size, size=(b, s))
    ).to(DEV)
    loss_tol, grad_tol, why = TRAIN_TOL["bfloat16"]

    # step 0: flash against dense on the same params and batch
    params = burnin.init_params(torch.Generator(device=DEV).manual_seed(SEED + 5), cfg)
    lf, gf = burnin.value_and_grad(
        lambda p, t: burnin.loss_fn(p, t, cfg, fa.flash_attention), params, tokens)
    ld, gd = burnin.value_and_grad(lambda p, t: burnin.loss_fn(p, t, cfg), params, tokens)
    rel_loss = abs(lf.item() - ld.item()) / abs(ld.item())
    rels = [_rel_l2(x, y) for x, y in zip(burnin.param_leaves(gf), burnin.param_leaves(gd))]
    log(f"train bf16 step 0: loss flash {lf.item():.6f} dense {ld.item():.6f} (rel "
        f"{rel_loss:.3g}, tolerance {loss_tol}); gradient leaves rel L2 worst "
        f"{max(rels):.4g}, median {sorted(rels)[len(rels) // 2]:.4g} (tolerance {grad_tol}: "
        f"{why})")
    if not (rel_loss <= loss_tol and max(rels) <= grad_tol):
        raise AssertionError("bf16 flash training step 0 disagrees with dense")
    del params, gf, gd

    fns = burnin.build_train_step(cfg, attention="flash", remat="blocks", lr=3e-4, device=DEV)
    params, state = fns.init(torch.Generator(device=DEV).manual_seed(SEED + 5))
    sync(torch)
    for c in (fa.launches, fa.fwd_launches, fa.bwd_launches):
        c.update(dict.fromkeys(c, 0))
    losses = [fns.step(params, state, tokens)[2] for _ in range(steps)]
    sync(torch)
    counts = dict(fa.launches)
    fwd, bwd = dict(fa.fwd_launches), dict(fa.bwd_launches)
    losses = [x.item() for x in losses]
    log(f"train bf16 B={b} S={s} L={cfg.n_layers}: losses over {steps} steps on one batch "
        + " ".join(f"{x:.4f}" for x in losses))
    log(f"train bf16: launches {counts}, by kernel {fwd} {bwd} (expected forward 2*L*steps = "
        f"{2 * cfg.n_layers * steps}, all flash_fwd_wgmma; dQ and dK/dV L*steps = "
        f"{cfg.n_layers * steps}, all flash_bwd_dq_wgmma and flash_bwd_dkv_wgmma)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("bf16 training loss did not fall")
    n = cfg.n_layers * steps
    if counts != {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n} or fwd != {
            "flash_fwd_wgmma": 2 * n, "flash_fwd_fma": 0} or bwd != {
            "flash_bwd_dq_wgmma": n, "flash_bwd_dq_fma": 0,
            "flash_bwd_dkv_wgmma": n, "flash_bwd_dkv_fma": 0}:
        raise AssertionError(f"flash launch counts {counts} {fwd} {bwd} are not the main path's")
    counts = {"flash_fwd": fwd["flash_fwd_wgmma"], "flash_bwd_dq": bwd["flash_bwd_dq_wgmma"],
              "flash_bwd_dkv": bwd["flash_bwd_dkv_wgmma"]}

    # step time on the device's clock, warmed up by the steps above
    n = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.reset_peak_memory_stats()
    start.record()
    for _ in range(n):
        fns.step(params, state, tokens)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / n
    flops = train_flops(cfg, b, s)
    bound_ms = flops / PEAK_OPS["bfloat16"] * 1e3
    log(f"train bf16: {ms:.2f} ms per step ({b * s / ms * 1e3:.0f} tokens/s), "
        f"{flops / 1e12:.3f} TFLOP per step as _train_mfu counts it -> "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {flops / ms / 1e9 / 989:.4f} of 989 TFLOP/s "
        f"(bound {bound_ms:.2f} ms); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_window(torch, "train bf16: profile of one step",
                   lambda: fns.step(params, state, tokens), top=12, host_top=8,
                   watch=("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma",
                          "flash_bwd"))
    return counts


def phase_train_f32(torch, cfg, steps: int = 3, b: int = 4):
    """``cfg`` in f32 at 2 layers: flash against dense, step by step, from
    the same params on the same batch."""
    from k8s_dra_driver_torch.models import burnin
    from k8s_dra_driver_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    s = cfg.max_seq
    tokens = torch.from_numpy(
        np.random.RandomState(SEED + 4).randint(0, cfg.vocab_size, size=(b, s))
    ).to(DEV)
    loss_tol, param_tol, why = TRAIN_TOL["float32"]
    runs = {}
    for attention in ("flash", "dense"):
        fns = burnin.build_train_step(cfg, attention=attention, device=DEV)
        params, state = fns.init(torch.Generator(device=DEV).manual_seed(SEED + 6))
        sync(torch)
        for c in (fa.fwd_launches, fa.bwd_launches):
            c.update(dict.fromkeys(c, 0))
        losses = [fns.step(params, state, tokens)[2].item() for _ in range(steps)]
        runs[attention] = (losses, params)
        if attention == "flash":
            fwd, bwd = dict(fa.fwd_launches), dict(fa.bwd_launches)
    (lf, pf), (ld, pd) = runs["flash"], runs["dense"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(lf, ld))
    prel = max(_rel_l2(x, y) for x, y in zip(burnin.param_leaves(pf), burnin.param_leaves(pd)))
    log(f"train f32 L=2: losses flash {' '.join(f'{x:.6f}' for x in lf)}; dense "
        f"{' '.join(f'{x:.6f}' for x in ld)}; worst rel {rel:.3g} (tolerance {loss_tol}); "
        f"params after {steps} steps rel L2 worst {prel:.3g} (tolerance {param_tol}: {why})")
    n = cfg.n_layers * steps
    log(f"train f32 L=2: launches by kernel {fwd} {bwd} (expected forward 2*L*steps = "
        f"{2 * n}, all flash_fwd_fma; dQ and dK/dV L*steps = {n}, all flash_bwd_dq_fma and "
        f"flash_bwd_dkv_fma)")
    if not (rel <= loss_tol and prel <= param_tol and lf[-1] < lf[0]):
        raise AssertionError("f32 flash training disagrees with dense")
    if fwd != {"flash_fwd_wgmma": 0, "flash_fwd_fma": 2 * n} or bwd != {
            "flash_bwd_dq_wgmma": 0, "flash_bwd_dq_fma": n,
            "flash_bwd_dkv_wgmma": 0, "flash_bwd_dkv_fma": n}:
        raise AssertionError(f"f32 flash launches {fwd} {bwd} are not the f32 path's")
    return {"flash_fwd_f32": fwd["flash_fwd_fma"], "flash_bwd_dq_f32": bwd["flash_bwd_dq_fma"],
            "flash_bwd_dkv_f32": bwd["flash_bwd_dkv_fma"]}


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
    i4.kernel_launches.update(dict.fromkeys(i4.kernel_launches, 0))
    t0 = time.perf_counter()
    comps = eng.pump(reqs)
    sync(torch)
    wall = time.perf_counter() - t0
    counts = {"paged_attention": pa.launches["append"],
              "paged_attention_window": pa.launches["window"],
              "int4_matmul": i4.kernel_launches["int4_splitk"],
              "int4_matmul_prefill": i4.kernel_launches["int4_wgmma"]}
    if i4.launches != sum(i4.kernel_launches.values()):
        raise AssertionError(f"{label}: int4 launches {i4.launches} are not the kernels' sum")
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
    profile_window(torch, f"{label}: profile of one 8-step burst", eng.step_burst,
                   watch=("paged_", "int4_"))


def profile_window(torch, label: str, fn, top: int = 8, host_top: int = 0, watch=()):
    """Run ``fn`` once under ``torch.profiler`` and print the device's busy
    time over the window and the kernels that take it (and, with
    ``host_top``, the host ops with the most self CPU time; with ``watch``,
    the device time of the kernels whose names hold each string).  Only events
    that ran on the device are summed: a CPU op's own device time repeats
    the time of the kernels it launched, so the sum over all events counts
    those kernels twice (printed beside, for comparison with earlier runs
    that summed it)."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync(torch)
            window_us = (time.perf_counter() - t0) * 1e6
        rows, host, all_events = [], [], 0.0
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", 0)
            all_events += dev_us
            if ev.device_type == DeviceType.CUDA and dev_us > 0:
                rows.append((dev_us, ev.count, ev.key))
            elif ev.device_type == DeviceType.CPU:
                host.append((ev.self_cpu_time_total, ev.count, ev.key))
        busy = sum(r_[0] for r_ in rows)
        if busy <= 0:
            log(f"{label}: the profile holds no device events")
            return
        log(f"{label}: window {window_us:.0f} us, device busy {busy:.0f} us "
            f"({busy / window_us:.3f} of the window; the sum over all events, CPU ops "
            f"included, is {all_events:.0f} us)")
        for dev_us, count, key in sorted(rows, reverse=True)[:top]:
            log(f"    {dev_us:9.0f} us  {dev_us / busy:.3f}  x{count:<5d} {key[:90]}")
        for name in watch:
            hits = [r_ for r_ in rows if name in r_[2]]
            log(f"{label}: kernels named {name}: {sum(r_[0] for r_ in hits):.0f} us over "
                f"{sum(r_[1] for r_ in hits)} launches "
                f"({sum(r_[0] for r_ in hits) / busy:.3f} of the device time)")
        if host_top:
            log(f"{label}: host ops by self CPU time ({sum(r_[1] for r_ in host)} ops, "
                f"{sum(r_[0] for r_ in host):.0f} us under the profiler)")
            for cpu_us, count, key in sorted(host, reverse=True)[:host_top]:
                log(f"    {cpu_us:9.0f} us  x{count:<5d} {key[:90]}")
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
    kernel_numbers.update(run("flash kernels", lambda: phase_flash_kernels(torch, timer)) or {})

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
        # decode steps (M = 8) go through the split-K kernel, admissions
        # (M = prompt bucket 256) through the wgmma kernel
        if launches["int4"]["int4_matmul"] == 0 or launches["int4"]["int4_matmul_prefill"] == 0:
            raise AssertionError(f"an int4 kernel was never launched: {launches['int4']}")

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
    del params

    def train_bf16():
        launches["train"] = phase_train_bf16(torch, cfg)

    def train_f32():
        launches["train_f32"] = phase_train_f32(torch, cfg)

    run("train bf16", train_bf16)
    run("train f32", train_f32)

    if failed:
        log(f"chip_smoke: failed phases {failed}")
        return 1
    # each kernel's launches on the path that runs it: paged append on the
    # bf16 serving run, both int4 kernels on the int4 serving run, flash on
    # the bf16 training run and the f32 forward on the f32 training run; the
    # read-only paged kernel is on no path (0)
    main_counts = {
        "paged_attention": launches["bf16"]["paged_attention"],
        "paged_attention_window": launches["bf16"]["paged_attention_window"],
        "int4_matmul": launches["int4"]["int4_matmul"],
        "int4_matmul_prefill": launches["int4"]["int4_matmul_prefill"],
        **launches["train"],
        **launches["train_f32"],
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
