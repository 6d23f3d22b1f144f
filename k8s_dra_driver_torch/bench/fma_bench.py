#!/usr/bin/env python3
"""Where the f32 flash backward's time goes, measured on the card.

    python3 k8s_dra_driver_torch/bench/fma_bench.py

Builds with ``nvcc`` for ``sm_90a`` into ``build/fma_bench/`` at the
repository root, every build started together, then runs:

1. ``smem_fma.cu``: the rate of a loop of f32 FMAs fed from shared memory,
   by the block of products a thread owns (4x4 of two products, 4x4, 8x4,
   8x8 of one) and by read width (one float4 or one float);
2. the f32 backward kernels of ``csrc/flash_attention.cu``, whole and with
   parts taken out, each variant a copy of the source with some edits, timed
   by ``flash_bwd_timing.cu``: ``noexp`` (p is its exponent, no exp2),
   ``nofirst`` (no score products), ``nosecond`` (no dS.K, P^T.dO, dS^T.Q),
   ``nocopy`` (no tile refills inside the loops: the first tiles are used
   again), ``noxbar`` (no barriers around the P/dS exchange).  A variant
   without a part computes wrong values; only its time is read.  Three
   more put back what the kernels replaced, and compute the same values:
   ``exp2f`` (exp2f in place of ex2.approx.ftz), ``allmask`` (the masks
   evaluated on every tile), ``reread`` (dK/dV reading lse and delta from
   shared memory per element).  An edit that no longer matches the source
   stops the script.

Each time printed is a mean over 10 launches between CUDA events; compare
variants within one run.  Exits 2 without ``nvcc`` or a card.
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

# (pattern, replacement, matches expected) in the f32 backward section
EDITS = {
    "noexp": [(r"exp2_ftz\(fmaf", "(fmaf", 2)],
    "nofirst": [(r"\n    score_product<D>\(", "\n    if (0) score_product<D>(", 2)],
    "nosecond": [(r"\n    tile_product<D", "\n    if (0) tile_product<D", 2)],
    "nocopy": [(r"\n      copy_tile<D>\(k_s \+ \(\(kt \+ 1\)", "\n      if (0) copy_tile<D>(k_s + ((kt + 1)", 1),
               (r"\n      copy_tile<D>\(v_s, v \+ base, k0 \+ BK", "\n      if (0) copy_tile<D>(v_s, v + base, k0 + BK", 1),
               (r"\n      copy_q_tile\(qt \+ 1\);", "\n      if (0) copy_q_tile(qt + 1);", 1)],
    "noxbar": [(r"__syncthreads\(\);  // ((p|ds|p\^T|ds\^T) is in[^\n]*)", "/* \\1 */", 4)],
    "exp2f": [(r"exp2_ftz\(fmaf", "exp2f(fmaf", 2)],
    "allmask": [(r"edge && \(", "(", 2)],
    "reread": [(r"-col_r\[c\]", "-lse_s[tx + GX * c] * LOG2E", 1),
               (r"- col_r\[c\]\)", "- delta_s[tx + GX * c])", 1)],
}
VARIANTS = {
    "whole": [], "noexp": ["noexp"], "nofirst": ["nofirst"], "nosecond": ["nosecond"],
    "nocopy": ["nocopy"], "noxbar": ["noxbar"], "nocopy+noxbar": ["nocopy", "noxbar"],
    "nofirst+nosecond": ["nofirst", "nosecond"],
    "exp2f": ["exp2f"], "allmask": ["allmask"], "reread": ["reread"],
}


def variant_source(edits) -> str:
    src = (CSRC / "flash_attention.cu").read_text()
    start = src.index("// ---- the f32 backward")
    end = src.index("// ---- bf16 on the tensor cores")
    section = src[start:end]
    for name in edits:
        for pattern, repl, want in EDITS[name]:
            section, n = re.subn(pattern, repl, section)
            if n != want:
                raise SystemExit(f"fma_bench: edit {name} matched {n} times, not {want}: the "
                                 f"kernels changed; update EDITS")
    return src[:start] + section + src[end:]


def main() -> int:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        print("fma_bench: nvcc not found", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    builds = {"smem_fma": [nvcc, *NVCC, "-o", str(OUT / "smem_fma"), str(HERE / "smem_fma.cu")]}
    for name, edits in VARIANTS.items():
        src = OUT / f"flash_attention_{name}.cu"
        src.write_text(variant_source(edits))
        builds[name] = [nvcc, *NVCC, f"-I{CSRC}", "-o", str(OUT / name),
                        str(HERE / "flash_bwd_timing.cu"), str(src), "-lcuda"]
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
