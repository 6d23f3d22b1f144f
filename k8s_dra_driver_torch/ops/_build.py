"""Build and load the port's CUDA kernels.

Each ``k8s_dra_driver_torch/csrc/<name>.cu`` is compiled on first use by
``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface under ``build/torch_kernels/`` at the repository root, and loaded
with ``ctypes``.  The library's file name carries a hash of its source, so
an edited kernel is rebuilt and a stale one is never loaded; the hash covers
the shared headers (``csrc/*.cuh``) too.  Nothing here
runs at import time: the CPU tests import every module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each library built by
# this process, by kernel source name
ptxas_reports: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one source into a temporary file; returns
    (process, temporary path, final path), or None when already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    proc, tmp, out = started
    report, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{report}")
    os.replace(tmp, out)
    ptxas_reports[name] = report


def build(names) -> None:
    """Compile the named sources that are not built yet, all ``nvcc``
    processes started together."""
    with _lock:
        started = {n: _start_build(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish_build(n, s)


def load(name: str, launchers: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.  Each
    source exports its launches, ``int <launcher>(...)`` returning the CUDA
    error code, and ``const char* <name>_error_string(int)``; all are
    declared here once, each launch with its ``launchers[launcher]``
    argtypes."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                for fn, argtypes in launchers.items():
                    launch = getattr(lib, fn)
                    launch.argtypes, launch.restype = list(argtypes), ctypes.c_int
                err = getattr(lib, f"{name}_error_string")
                err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
                _libs[name] = lib
    return lib


def check(name: str, rc: int, launcher: str | None = None) -> None:
    """Raise when a launch of ``csrc/<name>.cu`` returned a CUDA error."""
    if rc != 0:
        what = getattr(_libs[name], f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{launcher or name} launch failed: CUDA error {rc} ({what})")
