"""The port of ``k8s_dra_driver_tpu/plugin/cdi.py`` (copied: the port imports
nothing of the JAX package).

CDI (Container Device Interface) spec generation for TPU devices.

Mirror of cmd/nvidia-dra-plugin/cdi.go (298 LoC): a base spec describing every
allocatable device plus per-claim transient specs carrying the sharing/
wiring container-edits.  Differences are deliberate and TPU-native
(SURVEY.md §2.9): there is no nvidia-ctk hook machinery — TPU containers need
only static device nodes (``/dev/accel*``), the libtpu library mount, and
``TPU_*`` environment — so specs are fully static JSON and the "hooks"
section is always empty.

Spec layout on disk (cdi_root, default /var/run/cdi):
  ``tpu.google.com-base.json``          — base spec, one device per chip/subslice
  ``tpu.google.com-claim-<uid>.json``   — transient per-claim spec
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from k8s_dra_driver_torch.utils.fileio import write_json_atomic

from k8s_dra_driver_torch import DRIVER_NAME
from k8s_dra_driver_torch.plugin.deviceinfo import AllocatableDevices

CDI_VERSION = "0.6.0"
CDI_VENDOR = "k8s." + DRIVER_NAME  # mirrors vendor `k8s.gpu.nvidia.com` (cdi.go:37-48)
CDI_CLASS = "tpu"
CDI_KIND = f"{CDI_VENDOR}/{CDI_CLASS}"


@dataclass
class ContainerEdits:
    """Subset of the CDI containerEdits model the TPU driver emits."""

    env: dict[str, str] = field(default_factory=dict)
    device_nodes: list[str] = field(default_factory=list)
    mounts: list[tuple[str, str]] = field(default_factory=list)  # (host, container)

    def merge(self, other: "ContainerEdits") -> "ContainerEdits":
        merged = ContainerEdits(
            env={**self.env, **other.env},
            device_nodes=[*self.device_nodes],
            mounts=[*self.mounts],
        )
        for node in other.device_nodes:
            if node not in merged.device_nodes:
                merged.device_nodes.append(node)
        for m in other.mounts:
            if m not in merged.mounts:
                merged.mounts.append(m)
        return merged

    def to_cdi(self) -> dict:
        out: dict = {}
        if self.env:
            out["env"] = [f"{k}={v}" for k, v in sorted(self.env.items())]
        if self.device_nodes:
            out["deviceNodes"] = [{"path": p} for p in self.device_nodes]
        if self.mounts:
            out["mounts"] = [
                {
                    "hostPath": host,
                    "containerPath": container,
                    "options": ["ro", "nosuid", "nodev", "bind"],
                }
                for host, container in self.mounts
            ]
        return out


class CDIHandler:
    def __init__(
        self,
        cdi_root: str,
        driver_root: str = "/",
        libtpu_path: str = "/lib/libtpu.so",
        control_nodes: tuple[str, ...] = (),
    ):
        """``driver_root`` mirrors the chroot-like driver root the reference
        resolves binaries under (root.go:25-109): host paths in generated
        specs are prefixed with it when the runtime root differs.

        On NVIDIA cards (a real-mode topology) ``libtpu_path`` is "" (no
        library mount) and ``control_nodes`` names the driver's control
        nodes a CUDA container needs beside its card's node
        (``/dev/nvidiactl``, ``/dev/nvidia-uvm``, ``/dev/nvidia-uvm-tools``,
        those that exist): every card and subslice device carries them."""
        self.cdi_root = Path(cdi_root)
        self.driver_root = driver_root.rstrip("/")
        self.libtpu_path = libtpu_path
        self.control_nodes = tuple(control_nodes)
        self.cdi_root.mkdir(parents=True, exist_ok=True)

    # -- naming (cdi.go:286-298) ------------------------------------------

    def base_spec_path(self) -> Path:
        return self.cdi_root / f"{CDI_VENDOR}-base.json"

    def claim_spec_path(self, claim_uid: str) -> Path:
        return self.cdi_root / f"{CDI_VENDOR}-claim-{claim_uid}.json"

    def qualified_name(self, device: str) -> str:
        return f"{CDI_KIND}={device}"

    def claim_device_name(self, claim_uid: str, device: str) -> str:
        return f"{claim_uid}-{device}"

    # -- base spec (cdi.go:158-227) ---------------------------------------

    def create_base_spec(self, allocatable: AllocatableDevices) -> Path:
        """One CDI device per allocatable device, carrying its device nodes
        and the common libtpu mount.  The common edits also set
        ``TPU_DRIVER_MODE=dra`` — the analog of forcing
        ``NVIDIA_VISIBLE_DEVICES=void`` (cdi.go:176-180): it tells any
        device-plugin-style injector to stand down because DRA owns binding.
        """
        devices = []
        for dev in allocatable:
            edits = self._device_edits(dev)
            devices.append(
                {"name": dev.name, "containerEdits": edits.to_cdi()}
            )
        common = ContainerEdits(
            env={"TPU_DRIVER_MODE": "dra", "TPU_SKIP_MDS_QUERY": "true"},
            mounts=(
                [(self._host_path(self.libtpu_path), "/lib/libtpu.so")]
                if self.libtpu_path
                else []
            ),
        )
        spec = {
            "cdiVersion": CDI_VERSION,
            "kind": CDI_KIND,
            "devices": devices,
            "containerEdits": common.to_cdi(),
        }
        return self._write(self.base_spec_path(), spec)

    # -- per-claim spec (cdi.go:229-279) ----------------------------------

    def create_claim_spec_file(
        self, claim_uid: str, group_edits: list[tuple[list[str], ContainerEdits]]
    ) -> Path:
        """``group_edits``: per prepared-device-group, the device names and
        the group's container edits (sharing env, worker wiring...).  Devices
        are named ``<claimUID>-<device>`` so several claims can prepare the
        same underlying chip under sharing strategies."""
        devices = []
        for names, edits in group_edits:
            for name in names:
                devices.append(
                    {
                        "name": self.claim_device_name(claim_uid, name),
                        "containerEdits": edits.to_cdi(),
                    }
                )
        spec = {
            "cdiVersion": CDI_VERSION,
            "kind": CDI_KIND,
            "devices": devices,
        }
        return self._write(self.claim_spec_path(claim_uid), spec)

    def delete_claim_spec_file(self, claim_uid: str) -> None:
        self.claim_spec_path(claim_uid).unlink(missing_ok=True)

    def list_claim_spec_uids(self) -> list[str]:
        """UIDs with transient specs on disk — used by the orphan-cleanup
        loop (the reference left this as a TODO, driver.go:156-168)."""
        prefix = f"{CDI_VENDOR}-claim-"
        return [
            p.name[len(prefix) : -len(".json")]
            for p in self.cdi_root.glob(f"{prefix}*.json")
        ]

    # -- internals ---------------------------------------------------------

    def _host_path(self, path: str) -> str:
        return f"{self.driver_root}{path}" if self.driver_root else path

    def _device_edits(self, dev) -> ContainerEdits:
        if dev.chip is not None:
            return ContainerEdits(
                device_nodes=[dev.chip.chip.device_path, *self.control_nodes]
            )
        if dev.subslice is not None:
            topo = dev.subslice.topology
            chips = [topo.chips[i] for i in dev.subslice.subslice.chip_indices]
            return ContainerEdits(
                device_nodes=[*(c.device_path for c in chips), *self.control_nodes]
            )
        return ContainerEdits()

    def _write(self, path: Path, spec: dict) -> Path:
        return write_json_atomic(path, spec)
