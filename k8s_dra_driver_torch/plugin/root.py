"""The port of ``k8s_dra_driver_tpu/plugin/root.py`` (copied: the port imports
nothing of the JAX package).

Driver-root discovery (cmd/nvidia-dra-plugin/root.go:25-109 analog).

The reference locates ``libnvidia-ml.so.1``/``nvidia-smi`` under a
configurable chroot-like driver root (the host driver install mounted at
``/driver-root`` in the DaemonSet).  The TPU counterpart locates
``libtpu.so`` and the accel device nodes under the same kind of root, so a
containerized plugin can generate CDI specs with correct host paths.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

# Where libtpu.so usually lives, in probe order.
_LIBTPU_CANDIDATES = (
    "lib/libtpu.so",
    "usr/lib/libtpu.so",
    "usr/local/lib/libtpu.so",
    "home/kubernetes/bin/libtpu.so",  # GKE node image location
)


class DriverRootError(RuntimeError):
    pass


@dataclass(frozen=True)
class DriverRoot:
    """``root`` is where the host's driver install is visible in OUR mount
    namespace (e.g. /driver-root); ``host_root`` is where the same files live
    on the host ("/" unless the host itself chroots its driver)."""

    root: str = "/"
    host_root: str = "/"

    def find_libtpu(self) -> str:
        """Container-visible path of libtpu.so under the driver root."""
        base = Path(self.root)
        for candidate in _LIBTPU_CANDIDATES:
            path = base / candidate
            if path.exists():
                return str(path)
        raise DriverRootError(
            f"libtpu.so not found under driver root {self.root!r} "
            f"(probed {[str(Path(self.root) / c) for c in _LIBTPU_CANDIDATES]})"
        )

    def to_host_path(self, container_path: str) -> str:
        """Translate a path under ``root`` to the host path CDI specs need
        (root.go's container->host transform used at cdi.go:207-215)."""
        root = self.root.rstrip("/") or "/"
        if root != "/" and container_path.startswith(root):
            suffix = container_path[len(root):]
            host = self.host_root.rstrip("/")
            return f"{host}{suffix}" if host else suffix
        return container_path

    def device_nodes(self) -> list[str]:
        base = Path(self.root) / "dev"
        return sorted(
            str(p) for p in base.glob("accel[0-9]*") if p.name[5:].isdigit()
        )
