"""ctypes binding for the port's native enumerator (``tpuinfo/cpp``), the
counterpart of ``k8s_dra_driver_tpu/tpuinfo/binding.py`` with its Python
surface kept: :class:`ChipInfo`, :class:`TopologyInfo`,
:func:`enumerate_topology`, :func:`library_version`, :class:`TpuInfoError`.

The shim answers in the reference's JSON contract.  With
``TPUINFO_FAKE_TOPOLOGY`` set it gives exactly what the reference's fake
mode gives (the CPU tests' topologies).  Otherwise it enumerates the host's
NVIDIA cards: ``n`` cards form one ``n x 1`` slice on one host, each card
a "chip" whose ``index`` is its ``/dev/nvidia<minor>`` minor (from
``/proc/driver/nvidia``, else NVML), in PCI bus order; with no card or no
``libcuda.so.1`` it fails, and never falls back to a fake topology.  It
holds no CUDA context (``cuInit`` and device queries only), so the plugin
takes no card memory from any claim.

The shared object is built on first use with ``g++`` (no CUDA headers
needed) into ``build/torch_tpuinfo/`` at the repository root, its file
name carrying a hash of the sources, under an exclusive ``flock`` as
``ops/_build.py`` builds the kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import os
import subprocess
import threading
from dataclasses import dataclass, field
from pathlib import Path

CPP_DIR = Path(__file__).resolve().parent / "cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_tpuinfo"
SOURCES = ("tpuinfo.cc", "tpuinfo.h")
# hidden visibility and -Bsymbolic: the shim's own template instances bind
# inside it, never to another C++ runtime's in the host process (a PyTorch
# process on the card crashed in the shim's first stream insert otherwise)
CXX_FLAGS = ["-std=c++17", "-O2", "-Wall", "-Wextra", "-fPIC", "-shared",
             "-fvisibility=hidden", "-fvisibility-inlines-hidden", "-Wl,-Bsymbolic"]
_LOCK = threading.Lock()


class TpuInfoError(RuntimeError):
    pass


@dataclass(frozen=True)
class ChipInfo:
    index: int
    device_path: str
    uuid: str
    coords: tuple[int, int, int]
    hbm_bytes: int
    cores: int
    pci_address: str
    healthy: bool = True
    health_reason: str = ""  # why unhealthy: pci-disabled|aer-fatal|node-unopenable|fault-injected


@dataclass(frozen=True)
class TopologyInfo:
    mode: str
    generation: str
    topology: str
    ndims: int
    dims: tuple[int, int, int]
    wrap: tuple[bool, bool, bool]
    host_bounds: tuple[int, int, int]
    chips_per_host: int
    host_count: int
    host_id: int
    worker_hostnames: tuple[str, ...]
    driver_version: str
    libtpu_version: str
    chips: tuple[ChipInfo, ...] = field(default_factory=tuple)

    @property
    def total_chips(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((CPP_DIR / name).read_bytes())
    return BUILD_DIR / f"libtpuinfo_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the shim if this source hash is not built yet (``g++``, under
    the build directory's lock; a temporary name moved into place)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(CPP_DIR / "tpuinfo.cc"),
               "-o", str(tmp), "-ldl"]
        result = subprocess.run(cmd, capture_output=True, text=True)
        if result.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise TpuInfoError(f"building {out.name} failed:\n{result.stderr}")
        os.replace(tmp, out)
    return out


_lib: ctypes.CDLL | None = None


def load() -> ctypes.CDLL:
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.tpuinfo_enumerate.argtypes = [ctypes.POINTER(ctypes.c_char_p)]
            lib.tpuinfo_enumerate.restype = ctypes.c_int
            lib.tpuinfo_free.argtypes = [ctypes.c_char_p]
            lib.tpuinfo_version.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def library_version() -> str:
    return load().tpuinfo_version().decode()


def enumerate_topology(env: dict[str, str] | None = None) -> TopologyInfo:
    """Enumerate the local host's cards (or a fake topology) and slice
    topology.

    ``env`` overrides (TPUINFO_FAKE_TOPOLOGY etc.) are applied to the process
    environment for the duration of the native call — the shim reads getenv.
    """
    lib = load()
    out = ctypes.c_char_p()
    with _LOCK:
        saved: dict[str, str | None] = {}
        if env:
            for k, v in env.items():
                saved[k] = os.environ.get(k)
                os.environ[k] = v
        try:
            rc = lib.tpuinfo_enumerate(ctypes.byref(out))
            raw = ctypes.string_at(out).decode()
        finally:
            # ctypes copied the bytes; release the native buffer.
            lib.tpuinfo_free(out)
            if env:
                for k, old in saved.items():
                    if old is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = old
    if rc != 0:
        raise TpuInfoError(raw)
    data = json.loads(raw)
    chips = tuple(
        ChipInfo(
            index=c["index"],
            device_path=c["device_path"],
            uuid=c["uuid"],
            coords=tuple(c["coords"]),
            hbm_bytes=c["hbm_bytes"],
            cores=c["cores"],
            pci_address=c["pci_address"],
            healthy=c.get("healthy", True),
            health_reason=c.get("health_reason", ""),
        )
        for c in data["chips"]
    )
    return TopologyInfo(
        mode=data["mode"],
        generation=data["generation"],
        topology=data["topology"],
        ndims=data["ndims"],
        dims=tuple(data["dims"]),
        wrap=tuple(data["wrap"]),
        host_bounds=tuple(data["host_bounds"]),
        chips_per_host=data["chips_per_host"],
        host_count=data["host_count"],
        host_id=data["host_id"],
        worker_hostnames=tuple(data["worker_hostnames"]),
        driver_version=data["driver_version"],
        libtpu_version=data["libtpu_version"],
        chips=chips,
    )


def main(argv: list[str] | None = None) -> int:
    """``python -m k8s_dra_driver_torch.tpuinfo.binding``: print the
    enumeration as one JSON line (exit 1 with the error on stderr)."""
    import dataclasses
    import sys

    del argv
    try:
        topo = enumerate_topology()
    except TpuInfoError as exc:
        print(f"tpuinfo: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(dataclasses.asdict(topo)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
