#!/usr/bin/env python3
"""Where the f32 flash kernels' time goes, measured on the card.

    python3 k8s_dra_driver_torch/bench/fma_bench.py [name prefix ...]

Builds with ``nvcc`` for ``sm_90a`` into ``build/fma_bench/`` at the
repository root, every build started together, then runs:

1. ``smem_fma.cu``: the rate of a loop of f32 FMAs fed from shared memory,
   by the block of products a thread owns (4x4 of two products, 4x4, 8x4,
   8x8 of one) and by read width (one float4 or one float);
2. the f32 forward kernel of ``csrc/flash_attention.cu``, whole and with
   parts taken out, each variant a copy of the source with some edits to
   the forward's section, timed by ``flash_fwd_timing.cu``: ``fwd-noqk``
   (no QK^T product), ``fwd-nopv`` (no P.V product), ``fwd-noexp`` (p is
   its exponent, no exp2), ``fwd-nocopy`` (no K/V loads inside the loop:
   the first stage is used again), ``fwd-noxsync`` (no __syncwarp before
   the P exchange is read).  Two more unroll the product loops otherwise
   and compute the same values: ``fwd-unroll1`` (one step of each loop an
   iteration), ``fwd-unroll4`` (four);
3. the f32 backward kernels, the same way, timed by
   ``flash_bwd_timing.cu``: ``noexp``, ``nofirst`` (no score products),
   ``nosecond`` (no dS.K, P^T.dO, dS^T.Q), ``nocopy`` (no tile refills
   inside the loops), ``noxbar`` (no barriers around the P/dS exchange);
   and ``exp2f`` (exp2f in place of ex2.approx.ftz), ``allmask`` (the masks
   evaluated on every tile), ``reread`` (dK/dV reading lse and delta from
   shared memory per element).

Arguments, when given, keep the builds whose names start with one of them
(``fwd-``: the forward's variants).  A variant without a part computes wrong
values; only its time is read.  An edit that no longer matches the source
stops the script.  Each time printed is a mean over 10 launches between
CUDA events; compare variants within one run.  Exits 2 without ``nvcc`` or
a card.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "csrc"
OUT = HERE.parents[1] / "build" / "fma_bench"
NVCC = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
# the source's sections the edits apply to, by the comments that open them
SECTIONS = {"fwd": ("// ---- the f32 forward", "// ---- the f32 backward"),
            "bwd": ("// ---- the f32 backward", "// ---- bf16 on the tensor cores")}

# name: (section, [(pattern, replacement, matches expected)])
EDITS = {
    "fwd-noqk": ("fwd", [(r"\n    score_product<D", "\n    if (0) score_product<D", 1)]),
    "fwd-nopv": ("fwd", [(r"\n    tile_product<D", "\n    if (0) tile_product<D", 1)]),
    "fwd-noexp": ("fwd", [(r"exp2_ftz\(fmaf", "(fmaf", 2)]),
    "fwd-nocopy": ("fwd", [(r"if \(threadIdx.x == 0 && kt \+ 1 < n_kt\)", "if (0)", 1),
                           (r"hopper::mbar_wait\(&bar\[s\], \(kt >> 1\) & 1\);",
                            "if (kt == 0) hopper::mbar_wait(&bar[0], 0);", 1)]),
    "fwd-noxsync": ("fwd", [(r"__syncwarp\(\);  // the warp's rows of p are in", "", 1)]),
    "fwd-unroll1": ("fwd", [(r"constexpr int FU = 2;", "constexpr int FU = 1;", 1)]),
    "fwd-unroll4": ("fwd", [(r"constexpr int FU = 2;", "constexpr int FU = 4;", 1)]),
    "noexp": ("bwd", [(r"exp2_ftz\(fmaf", "(fmaf", 2)]),
    "nofirst": ("bwd", [(r"\n    score_product<D>\(", "\n    if (0) score_product<D>(", 2)]),
    "nosecond": ("bwd", [(r"\n    tile_product<D", "\n    if (0) tile_product<D", 2)]),
    "nocopy": ("bwd", [(r"\n      copy_tile<D>\(k_s \+ \(\(kt \+ 1\)", "\n      if (0) copy_tile<D>(k_s + ((kt + 1)", 1),
                       (r"\n      copy_tile<D>\(v_s, v \+ base, k0 \+ BK", "\n      if (0) copy_tile<D>(v_s, v + base, k0 + BK", 1),
                       (r"\n      copy_q_tile\(qt \+ 1\);", "\n      if (0) copy_q_tile(qt + 1);", 1)]),
    "noxbar": ("bwd", [(r"__syncthreads\(\);  // ((p|ds|p\^T|ds\^T) is in[^\n]*)", "/* \\1 */", 4)]),
    "exp2f": ("bwd", [(r"exp2_ftz\(fmaf", "exp2f(fmaf", 2)]),
    "allmask": ("bwd", [(r"edge && \(", "(", 2)]),
    "reread": ("bwd", [(r"-col_r\[c\]", "-lse_s[tx + GX * c] * LOG2E", 1),
                       (r"- col_r\[c\]\)", "- delta_s[tx + GX * c])", 1)]),
}
# name: (timing harness, edits)
VARIANTS = {
    "fwd-whole": ("flash_fwd_timing.cu", []),
    **{n: ("flash_fwd_timing.cu", [n]) for n in ("fwd-noqk", "fwd-nopv", "fwd-noexp",
                                                "fwd-nocopy", "fwd-noxsync", "fwd-unroll1",
                                                "fwd-unroll4")},
    "fwd-noqk+nopv": ("flash_fwd_timing.cu", ["fwd-noqk", "fwd-nopv"]),
    "fwd-nocopy+noxsync": ("flash_fwd_timing.cu", ["fwd-nocopy", "fwd-noxsync"]),
    "whole": ("flash_bwd_timing.cu", []),
    **{n: ("flash_bwd_timing.cu", [n]) for n in ("noexp", "nofirst", "nosecond", "nocopy",
                                                "noxbar", "exp2f", "allmask", "reread")},
    "nocopy+noxbar": ("flash_bwd_timing.cu", ["nocopy", "noxbar"]),
    "nofirst+nosecond": ("flash_bwd_timing.cu", ["nofirst", "nosecond"]),
}


def variant_source(edits) -> str:
    src = (CSRC / "flash_attention.cu").read_text()
    for name in edits:
        section, subs = EDITS[name]
        first, last = SECTIONS[section]
        start, end = src.index(first), src.index(last)
        text = src[start:end]
        for pattern, repl, want in subs:
            text, n = re.subn(pattern, repl, text)
            if n != want:
                raise SystemExit(f"fma_bench: edit {name} matched {n} times, not {want}: the "
                                 f"kernels changed; update EDITS")
        src = src[:start] + text + src[end:]
    return src


def main() -> int:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        print("fma_bench: nvcc not found", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    chosen = lambda name: not sys.argv[1:] or name.startswith(tuple(sys.argv[1:]))
    builds = {"smem_fma": [nvcc, *NVCC, "-o", str(OUT / "smem_fma"), str(HERE / "smem_fma.cu")]}
    builds = {n: c for n, c in builds.items() if chosen(n)}
    for name, (timing, edits) in VARIANTS.items():
        if not chosen(name):
            continue
        src = OUT / f"flash_attention_{name}.cu"
        src.write_text(variant_source(edits))
        builds[name] = [nvcc, *NVCC, f"-I{CSRC}", "-o", str(OUT / name), str(HERE / timing),
                        str(src), "-lcuda"]
    procs = {n: subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n, c in builds.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"fma_bench: nvcc failed for {name}:\n{log}", file=sys.stderr)
            return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print("card:", smi.stdout.strip() or "not read", flush=True)
    for name in builds:
        run = subprocess.run([str(OUT / name), name], capture_output=True, text=True)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            print(f"fma_bench: {name} failed: {run.stderr}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
