"""The port of ``k8s_dra_driver_tpu/plugin/sharing.py`` (copied: the port imports
nothing of the JAX package).  The per-claim daemon's Deployment is the
reference's template built as a dict (:func:`daemon_deployment`), its
command this package's daemon module.

Sharing managers — realize a claim's sharing config on the node.

Mirror of cmd/nvidia-dra-plugin/sharing.go (442 LoC), re-imagined for TPU:

* ``TimeSlicingManager`` — the reference shells out to nvidia-smi to set a
  preemptive compute-policy timeslice (nvlib.go:521-539).  libtpu has no
  preemptive timeslicing (SURVEY.md §2.10), so the TPU realization is
  cooperative: the claim's containers get a queue quantum plus the socket of
  the per-host ``tpu-topology-daemon`` (host mode, a kubelet-plugin sidecar),
  which arbitrates the run lease between consumers
  (plugin/topology_daemon.py).
* ``SpatialPartitionManager`` — the MPS analog.  Spawns a per-claim topology
  daemon Deployment (render + API create + readiness poll with the
  same 1s→10s×4 exponential backoff, sharing.go:185-344) and computes a real
  geometric division of the claimed chips: each consumer container gets a
  DISJOINT ``TPU_VISIBLE_DEVICES`` / ``TPU_PROCESS_COORD`` slot in a process
  grid derived from actual chip coordinates — the TPU counterpart of MPS
  dividing SMs/pinned memory among clients (sharing.go:346-366).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

from k8s_dra_driver_torch.api.sharing import SpatialPartitionConfig, TimeSlicingConfig
from k8s_dra_driver_torch.kube import objects
from k8s_dra_driver_torch.kube.fakeserver import NotFound
from k8s_dra_driver_torch.plugin.cdi import ContainerEdits
from k8s_dra_driver_torch.plugin.deviceinfo import AllocatableDevice
from k8s_dra_driver_torch.plugin.topology_daemon import (
    claim_socket_path,
    host_socket_path,
)
from k8s_dra_driver_torch.utils.retry import Backoff, RetryPolicy

# The per-claim daemon's program: this package's own module
# (``plugin/topology_daemon.py``); the reference runs ``tpu-topology-daemon``.
DAEMON_COMMAND = ("python3", "-m", "k8s_dra_driver_torch.plugin.topology_daemon")


def daemon_deployment(
    name: str,
    namespace: str,
    claim_uid: str,
    node_name: str,
    image: str,
    socket_dir: str,
    partition_spec: str,
    partitions: str,
    hbm_limits: str,
) -> dict:
    """The per-claim daemon's Deployment document: the reference's
    ``templates/topology-daemon.tmpl.yaml`` rendered, built here as a dict
    (no YAML parser on the node), with :data:`DAEMON_COMMAND` as the
    container's command."""
    labels = {
        "app.kubernetes.io/name": "tpu-topology-daemon",
        "resourceclaim.tpu.google.com/uid": claim_uid,
    }
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": {**labels, "tpu.google.com/node": node_name},
        },
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": dict(labels)},
            "template": {
                "metadata": {"labels": dict(labels)},
                "spec": {
                    "nodeName": node_name,
                    "tolerations": [{"operator": "Exists"}],
                    "containers": [
                        {
                            "name": "daemon",
                            "image": image,
                            "command": list(DAEMON_COMMAND),
                            "args": [f"--claim-uid={claim_uid}", f"--socket-dir={socket_dir}"],
                            "env": [
                                {"name": "TPU_PARTITION_SPEC", "value": partition_spec},
                                {"name": "TPU_PARTITIONS", "value": partitions},
                                {"name": "TPU_HBM_LIMITS", "value": hbm_limits},
                            ],
                            "volumeMounts": [{"name": "socket-dir", "mountPath": socket_dir}],
                        }
                    ],
                    "volumes": [
                        {
                            "name": "socket-dir",
                            "hostPath": {"path": socket_dir, "type": "DirectoryOrCreate"},
                        }
                    ],
                },
            },
        },
    }

# Cooperative scheduler quantum per named interval, milliseconds.  The four
# named intervals (Default/Short/Medium/Long → levels 0..3) map to four
# DISTINCT quanta, mirroring the reference's four distinct timeslice values
# (sharing.go:34-39); round 1 shipped Default==Medium by typo.
_QUANTUM_MS = {0: 5, 1: 1, 2: 10, 3: 20}


class SharingError(RuntimeError):
    pass


def _require_chips(devices: list[AllocatableDevice], strategy: str) -> None:
    """Spatial partitioning applies to whole chips only — a subslice is
    already a spatial partition (and SubsliceConfig likewise rejects nested
    SpatialPartition at validation, api/tpuconfig.py)."""
    bad = [d.name for d in devices if d.chip is None]
    if bad:
        raise SharingError(f"{strategy} sharing requires whole-chip devices, got {bad}")


def _require_compute(devices: list[AllocatableDevice], strategy: str) -> None:
    """TimeSlicing needs compute devices (chips OR subslices) — membership
    seats are wiring, not compute.  The reference restricts time-slicing to
    full GPUs because nvidia-smi's compute-policy is per-GPU
    (sharing.go:103-107); our cooperative run-lease is scoped per chip SET
    (topology_daemon.py), so subslice claims time-slice naturally — their
    consumers' lease scope is the subslice's TPU_VISIBLE_DEVICES."""
    bad = [d.name for d in devices if d.chip is None and d.subslice is None]
    if bad:
        raise SharingError(f"{strategy} sharing requires compute devices, got {bad}")


class TimeSlicingManager:
    def __init__(self, socket_dir: str = "/run/tpu-topology"):
        self.socket_dir = socket_dir

    def apply(
        self, devices: list[AllocatableDevice], config: TimeSlicingConfig
    ) -> ContainerEdits:
        _require_compute(devices, "TimeSlicing")
        interval = config.interval
        level = interval.level() if interval is not None else 0
        return ContainerEdits(
            env={
                "TPU_SHARING_STRATEGY": "time-slicing",
                "TPU_QUEUE_QUANTUM_MS": str(_QUANTUM_MS[level]),
                # The motor: consumers acquire/release their run lease from
                # the host-mode daemon (kubelet-plugin sidecar) on this socket.
                "TPU_TOPOLOGY_DAEMON_SOCKET": host_socket_path(self.socket_dir),
            },
            mounts=[(self.socket_dir, self.socket_dir)],
        )


@dataclass
class TopologyDaemon:
    """Handle to one running per-claim daemon (MpsControlDaemon analog)."""

    name: str
    namespace: str


@dataclass
class PartitionPlan:
    """Geometric division of a claim's chips among its consumer containers.

    One partition per allocated chip device: the allocation result is the
    per-container binding unit in DRA (a pod container references a request,
    kubelet hands it that request's CDI ids), so per-result division IS
    per-container division.
    """

    # "dx,dy,dz" bounds of the claimed region (the daemon's TPU_PARTITION_SPEC).
    region_bounds: str
    # Process grid over the region — common to every consumer.
    process_bounds: str
    # device name -> its disjoint env slot.
    per_device_env: dict[str, dict[str, str]] = field(default_factory=dict)
    # Partition table handed to the daemon (TPU_PARTITIONS, JSON).
    partitions: list[dict] = field(default_factory=list)


def plan_partitions(
    devices: list[AllocatableDevice], limits: dict[str, str]
) -> PartitionPlan:
    """Derive the division from actual chip coordinates.

    When the claimed chips exactly tile their bounding box the process grid
    is that box and each consumer's ``TPU_PROCESS_COORD`` is its chip's
    offset within it; a gappy allocation falls back to a linear 1D grid.
    Either way every consumer sees exactly ONE chip
    (``TPU_CHIPS_PER_PROCESS_BOUNDS=1,1,1``) — consistent with the subslice
    wiring convention (device_state._wiring_env: PROCESS_BOUNDS = process
    grid, CHIPS_PER_PROCESS_BOUNDS = chips each process sees)."""
    chips = [(d, d.chip.chip) for d in devices]
    coords = [c.coords for _, c in chips]
    origin = tuple(min(c[i] for c in coords) for i in range(3))
    box = tuple(max(c[i] for c in coords) - origin[i] + 1 for i in range(3))
    exact = (
        box[0] * box[1] * box[2] == len(chips)
        and len(set(coords)) == len(coords)
    )
    # Deterministic partition order: by coordinate, z-major (matches the
    # row-major chip order geometry._local_index uses).
    chips.sort(key=lambda dc: (dc[1].coords[2], dc[1].coords[1], dc[1].coords[0]))
    if not exact:
        box = (len(chips), 1, 1)

    plan = PartitionPlan(
        region_bounds=",".join(str(b) for b in box),
        process_bounds=",".join(str(b) for b in box),
    )
    for k, (device, chip) in enumerate(chips):
        if exact:
            coord = tuple(chip.coords[i] - origin[i] for i in range(3))
        else:
            coord = (k, 0, 0)
        env = {
            "TPU_VISIBLE_DEVICES": str(chip.index),
            "TPU_CHIPS_PER_PROCESS_BOUNDS": "1,1,1",
            "TPU_PROCESS_COORD": ",".join(str(c) for c in coord),
            "TPU_PARTITION_INDEX": str(k),
        }
        limit = limits.get(chip.uuid)
        if limit:
            env["TPU_HBM_LIMIT_MIB"] = str(_mib(limit))
        plan.per_device_env[device.name] = env
        plan.partitions.append(
            {
                "index": k,
                "device": device.name,
                "uuid": chip.uuid,
                "visible_devices": str(chip.index),
                "process_coord": env["TPU_PROCESS_COORD"],
                "hbm_limit_mib": _mib(limit) if limit else None,
            }
        )
    return plan


def _mib(limit: str) -> int:
    """'4096Mi' (HbmLimits.normalize output) → 4096."""
    return int(limit[:-2]) if limit.endswith("Mi") else int(limit)


class SpatialPartitionManager:
    def __init__(
        self,
        server,
        namespace: str = "tpu-dra-driver",
        node_name: str = "",
        daemon_image: str = "tpu-dra-driver:latest",
        socket_dir: str = "/run/tpu-topology",
        backoff_initial: float = 1.0,
        backoff_cap: float = 10.0,
        backoff_steps: int = 4,
    ):
        self._server = server
        self.namespace = namespace
        self.node_name = node_name
        self.daemon_image = daemon_image
        self.socket_dir = socket_dir
        self._backoff = (backoff_initial, backoff_cap, backoff_steps)

    # -- daemon naming (sharing.go:151-155) --------------------------------

    def daemon_name(self, claim_uid: str, uuids: list[str]) -> str:
        digest = hashlib.sha256(",".join(sorted(uuids)).encode()).hexdigest()[:5]
        return f"tpu-topology-daemon-{claim_uid[:13]}-{digest}"

    # -- lifecycle ---------------------------------------------------------

    def start(
        self,
        claim_uid: str,
        devices: list[AllocatableDevice],
        config: SpatialPartitionConfig,
    ) -> tuple[ContainerEdits, TopologyDaemon, dict[str, dict[str, str]]]:
        _require_chips(devices, "SpatialPartition")
        uuids = [u for d in devices for u in d.uuids()]
        limits = config.normalized_limits(uuids)
        plan = plan_partitions(devices, limits)

        name = self.daemon_name(claim_uid, uuids)
        deployment = objects.from_json(daemon_deployment(
            name=name,
            namespace=self.namespace,
            claim_uid=claim_uid,
            node_name=self.node_name,
            image=self.daemon_image,
            socket_dir=self.socket_dir,
            partition_spec=plan.region_bounds,
            partitions=json.dumps(plan.partitions),
            hbm_limits=",".join(f"{k}={v}" for k, v in sorted(limits.items())),
        ))
        created = False
        try:
            self._server.get(objects.Deployment.KIND, name, self.namespace)
        except NotFound:
            self._server.create(deployment)
            created = True
        try:
            self.assert_ready(name)
        except BaseException:
            # Compensate our own side effect — the reference leaks the
            # daemon/tmpfs when readiness fails mid-Start (sharing.go:260-287).
            if created:
                self.stop(TopologyDaemon(name=name, namespace=self.namespace))
            raise

        edits = ContainerEdits(
            env={
                "TPU_SHARING_STRATEGY": "spatial-partition",
                "TPU_PROCESS_BOUNDS": plan.process_bounds,
                "TPU_TOPOLOGY_DAEMON_SOCKET": claim_socket_path(self.socket_dir, claim_uid),
                "TPU_CORE_FRACTION": str(config.default_core_fraction or 100),
                **(
                    {"TPU_HBM_LIMITS": ",".join(f"{k}={v}" for k, v in sorted(limits.items()))}
                    if limits
                    else {}
                ),
            },
            mounts=[(self.socket_dir, self.socket_dir)],
        )
        return edits, TopologyDaemon(name=name, namespace=self.namespace), plan.per_device_env

    def assert_ready(self, name: str) -> None:
        """Poll the daemon Deployment's availability on the shared backoff
        policy (sharing.go:289-344; schedule unchanged: initial*2^n capped)."""
        initial, cap, steps = self._backoff
        backoff = Backoff(
            RetryPolicy(
                max_attempts=steps,
                base_delay_s=initial,
                max_delay_s=cap,
                multiplier=2.0,
                jitter=0.0,
            )
        )
        for step in range(steps + 1):
            try:
                dep = self._server.get(objects.Deployment.KIND, name, self.namespace)
            except NotFound:
                dep = None
            if dep is not None and _deployment_ready(dep):
                return
            if step == steps:
                break  # final check failed: raise without a useless sleep
            backoff.sleep()
        raise SharingError(f"topology daemon {name!r} did not become ready")

    def stop(self, daemon: TopologyDaemon) -> None:
        """Teardown (sharing.go:368-403).  Idempotent: a daemon already gone
        is success, matching the reference's tolerance of repeat Unprepare."""
        try:
            self._server.delete(objects.Deployment.KIND, daemon.name, daemon.namespace)
        except NotFound:
            pass


def _deployment_ready(dep) -> bool:
    status = dep.status or {}
    if isinstance(status, dict):
        return (status.get("readyReplicas") or 0) >= 1
    return False
