"""The port of ``k8s_dra_driver_tpu/plugin/device_state.py`` (copied: the port imports
nothing of the JAX package).  On a real-mode topology (the host's NVIDIA
cards, ``tpuinfo/binding.py``) the base CDI spec carries the CUDA control
nodes beside each card's node and mounts no libtpu; the environment a
claim gets is the reference's.

Node-side device state machine: Prepare / Unprepare with checkpointing.

Mirror of cmd/nvidia-dra-plugin/device_state.go (558 LoC):

* enumerate → base CDI spec → checkpoint restore on construction (:57-126)
* ``prepare`` idempotent via checkpoint (:128-159)
* opaque-config extraction with class < claim precedence (:446-510) and
  reverse-precedence request matching (:225-259)
* ``apply_sharing_config`` dispatch (:380-428)
* ``unprepare`` teardown (:161-190, 350-365)

One deliberate improvement over the reference (SURVEY.md §7 "hard parts" #2):
Prepare is structured as **compensable steps** — every side effect pushes an
undo closure, and a mid-way failure unwinds them instead of leaking daemons,
spec files or mounts (the reference leaks, e.g. sharing.go:260-287).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from k8s_dra_driver_torch import DRIVER_NAME
from k8s_dra_driver_torch.api import (
    Decoder,
    SliceGroupConfig,
    SliceMembershipConfig,
    SubsliceConfig,
    TpuConfig,
    default_subslice_config,
    default_tpu_config,
)
from k8s_dra_driver_torch.api.sharing import SharingStrategy
from k8s_dra_driver_torch.kube.objects import ResourceClaim, ResourceSlice
from k8s_dra_driver_torch.plugin.cdi import CDIHandler, ContainerEdits
from k8s_dra_driver_torch.plugin.checkpoint import CheckpointFile
from k8s_dra_driver_torch.plugin.deviceinfo import (
    DEVICE_TYPE_CHIP,
    DEVICE_TYPE_GROUP_SEAT,
    DEVICE_TYPE_MEMBERSHIP,
    DEVICE_TYPE_SUBSLICE,
    AllocatableDevice,
    AllocatableDevices,
    SliceGroupSeatInfo,
    SliceMembershipInfo,
)
from k8s_dra_driver_torch.plugin.prepared import (
    DeviceConfigState,
    PreparedClaim,
    PreparedDevice,
    PreparedDeviceGroup,
)
from k8s_dra_driver_torch.plugin.sharing import (
    SharingError,
    SpatialPartitionManager,
    TimeSlicingManager,
    TopologyDaemon,
)
from k8s_dra_driver_torch.tpuinfo.binding import TopologyInfo, enumerate_topology
from k8s_dra_driver_torch.utils.tracing import TRACER


# The NVIDIA driver's control nodes a CUDA container opens beside its
# card's /dev/nvidia<minor>.
CUDA_CONTROL_NODES = ("/dev/nvidiactl", "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools")


class PrepareError(RuntimeError):
    pass


def _parse_visible_chips(spec: str, n_chips: int):
    """"0,2" -> {0, 2}; "" -> None (all).  '.' also separates ("0.2") —
    node-label values cannot carry commas.  Loud on malformed/out-of-range
    input — a typo'd mask silently publishing the wrong chips is exactly
    the double-booking the masking exists to prevent."""
    if not spec:
        return None
    try:
        positions = {
            int(p) for p in spec.replace(".", ",").split(",") if p.strip() != ""
        }
    except ValueError as exc:
        raise ValueError(f"invalid visible-chips spec {spec!r}: {exc}") from None
    if not positions:
        # a non-empty spec that names NO chips (e.g. "." or ",") is a
        # templating bug — treating it as "all" would double-book the very
        # chips the mask was supposed to fence off
        raise ValueError(f"visible-chips spec {spec!r} names no chip positions")
    bad = sorted(p for p in positions if not 0 <= p < n_chips)
    if bad:
        raise ValueError(
            f"visible-chips positions {bad} out of range (host has {n_chips} chips)"
        )
    return frozenset(positions)


@dataclass
class DeviceStateConfig:
    node_name: str = ""
    namespace: str = "tpu-dra-driver"
    cdi_root: str = "/var/run/cdi"
    checkpoint_path: str = "/var/lib/kubelet/plugins/tpu.google.com/checkpoint.json"
    driver_root: str = ""
    libtpu_path: str = "/lib/libtpu.so"
    topology_env: dict[str, str] = field(default_factory=dict)
    socket_dir: str = "/run/tpu-topology"
    # tpu-parted applied-state file (out-of-band subslice-layout
    # partitioning, plugin/parted.py); empty = publish all shapes.
    parted_state_path: str = ""
    # Comma-separated LOCAL chip positions this plugin may publish; "" =
    # all.  The nvkind params-masking analog: several kind workers on one
    # host each own a disjoint share (label tpu.google.com/visible-chips).
    visible_chips: str = ""
    # Readiness backoff overrides for tests.
    daemon_backoff_initial: float = 1.0
    daemon_backoff_steps: int = 4
    # Runtime self-test sweep period (tpuinfo/selftest.py); 0 disables.
    selftest_interval_s: float = 0.0


@dataclass
class _CheckpointBatch:
    """Deferred durability for one NodePrepare/NodeUnprepareResources call.

    While a batch is active, prepare/unprepare mutate in-memory state and
    record enough here to make ONE checkpoint write at commit cover the
    whole batch — and to unwind/restore everything if that write fails:

    * ``prepared``: (claim uid, undo stack) per claim prepared in the batch
      (the same compensable steps an immediate-write failure would run);
    * ``unprepared``: (claim uid, PreparedClaim) per entry removed, so a
      failed commit can put them back and a kubelet retry re-runs the
      (idempotent) teardown.

    A prepare and an unprepare of the SAME claim cannot share a batch:
    batches are scoped to a single gRPC call, and prepare/unprepare arrive
    in different calls.
    """

    prepared: list = field(default_factory=list)
    unprepared: list = field(default_factory=list)


class DeviceState:
    def __init__(self, server, config: DeviceStateConfig):
        self._lock = threading.Lock()
        self._batch: Optional[_CheckpointBatch] = None
        self._server = server
        self.config = config
        # position -> reason; folded into every refresh() enumeration.
        self._health_overlay: dict[int, str] = {}
        self.topology: TopologyInfo = enumerate_topology(env=config.topology_env or None)
        self._layout = self._load_layout(int(self.topology.host_id))
        self._visible = _parse_visible_chips(
            config.visible_chips, len(self.topology.chips)
        )
        self.allocatable = AllocatableDevices.from_topology(
            self.topology, self._layout, self._visible
        )
        # Resolve libtpu under the chroot-like driver root when one is
        # mounted (root.go:25-109 pattern); fall back to the configured path.
        libtpu_path = config.libtpu_path
        control_nodes: tuple[str, ...] = ()
        if self.topology.mode == "real":
            # NVIDIA cards: no libtpu to mount; the CUDA control nodes that
            # exist go beside each card's node (cdi.CDIHandler)
            libtpu_path = ""
            control_nodes = tuple(p for p in CUDA_CONTROL_NODES if os.path.exists(p))
        elif config.driver_root and config.driver_root != "/":
            from k8s_dra_driver_torch.plugin.root import DriverRoot, DriverRootError

            try:
                resolved = DriverRoot(root=config.driver_root).find_libtpu()
                # find_libtpu returns the container-visible (root-prefixed)
                # path; CDIHandler prefixes driver_root itself, so hand it
                # the root-relative path to avoid a doubled prefix.
                libtpu_path = "/" + resolved[len(config.driver_root):].lstrip("/")
            except DriverRootError:
                pass  # fake topologies / dev hosts have no real libtpu
        self.cdi = CDIHandler(
            cdi_root=config.cdi_root,
            driver_root=config.driver_root,
            libtpu_path=libtpu_path,
            control_nodes=control_nodes,
        )
        self.cdi.create_base_spec(self.allocatable)
        self.ts_manager = TimeSlicingManager(socket_dir=config.socket_dir)
        self.sp_manager = SpatialPartitionManager(
            server,
            namespace=config.namespace,
            node_name=config.node_name,
            socket_dir=config.socket_dir,
            backoff_initial=config.daemon_backoff_initial,
            backoff_steps=config.daemon_backoff_steps,
        )
        self._decoder = Decoder()
        self._checkpoint = CheckpointFile(config.checkpoint_path)
        raw = self._checkpoint.read()
        self.prepared: dict[str, PreparedClaim] = {
            uid: PreparedClaim.from_json(doc) for uid, doc in raw.items()
        }

    # ------------------------------------------------------------------
    # Prepare
    # ------------------------------------------------------------------

    def prepare(self, claim: ResourceClaim) -> list[dict]:
        with self._lock:
            uid = claim.metadata.uid
            if uid in self.prepared:  # idempotent (device_state.go:140-142)
                return self.prepared[uid].flatten()
            if claim.status.allocation is None:
                raise PrepareError(f"claim {claim.metadata.name!r} has no allocation")

            undo: list[Callable[[], None]] = []
            try:
                with TRACER.span("Prepare.resolveAndApplyConfigs"):
                    prepared = self._prepare_devices(claim, undo)
                with TRACER.span("Prepare.writeClaimCDISpec"):
                    # Per-device entries: group env, overridden by the
                    # device's disjoint partition slot when the config
                    # produced one (SpatialPartition per-container division).
                    self.cdi.create_claim_spec_file(
                        uid,
                        [
                            (
                                [d.name],
                                ContainerEdits(
                                    env={
                                        **g.config_state.env,
                                        **g.config_state.per_device_env.get(d.name, {}),
                                    },
                                    mounts=[
                                        (m[0], m[1]) for m in g.config_state.mounts
                                    ],
                                ),
                            )
                            for g in prepared.groups
                            for d in g.devices
                        ],
                    )
                undo.append(lambda: self.cdi.delete_claim_spec_file(uid))
                self.prepared[uid] = prepared
                # The in-memory entry must unwind too: if the checkpoint write
                # below fails, a kubelet retry would otherwise hit the
                # idempotence fast-path and report stale success.
                undo.append(lambda: self.prepared.pop(uid, None))
                if self._batch is not None:
                    # Group commit: durability deferred to the batch commit,
                    # which runs before the gRPC response is returned.  The
                    # undo stack moves to the batch so a failed COMMIT can
                    # still unwind this claim's side effects.
                    self._batch.prepared.append((uid, list(undo)))
                else:
                    with TRACER.span("Prepare.writeCheckpoint"):
                        self._write_checkpoint()
            except BaseException:
                for fn in reversed(undo):
                    try:
                        fn()
                    except Exception:
                        pass  # best-effort unwind; original error wins
                raise
            return prepared.flatten()

    def unprepare(self, claim_uid: str) -> None:
        with self._lock:
            prepared = self.prepared.get(claim_uid)
            if prepared is None:
                return  # idempotent
            for group in prepared.groups:
                if group.config_state.daemon_name:
                    self.sp_manager.stop(
                        TopologyDaemon(
                            name=group.config_state.daemon_name,
                            namespace=group.config_state.daemon_namespace,
                        )
                    )
            self.cdi.delete_claim_spec_file(claim_uid)
            del self.prepared[claim_uid]
            if self._batch is not None:
                self._batch.unprepared.append((claim_uid, prepared))
                return
            try:
                self._write_checkpoint()
            except BaseException:
                # Keep the entry so a kubelet retry re-runs teardown (all
                # steps are idempotent) and re-attempts the write; dropping
                # it would leave a phantom claim in the on-disk checkpoint
                # that resurrects on restart.
                self.prepared[claim_uid] = prepared
                raise

    # ------------------------------------------------------------------
    # Checkpoint group commit
    # ------------------------------------------------------------------

    def begin_checkpoint_batch(self) -> None:
        """Defer checkpoint durability for the prepare/unprepare calls that
        follow, until commit_checkpoint_batch().  One batch per gRPC call;
        the driver commits before building the response, preserving the
        'checkpoint durable before kubelet sees success' invariant while
        paying ONE fsync per call instead of one per claim."""
        with self._lock:
            if self._batch is not None:
                raise RuntimeError("checkpoint batch already active")
            self._batch = _CheckpointBatch()

    def commit_checkpoint_batch(self) -> None:
        """Flush the active batch with a single durable checkpoint write.

        On write failure the batch is rolled back — every claim prepared in
        it is unwound (CDI spec deleted, daemons stopped, in-memory entry
        popped) and every entry unprepared in it is restored — so memory,
        disk artifacts and the (old, still-intact) on-disk checkpoint agree
        and a kubelet retry converges.  Re-raises the write error."""
        with self._lock:
            batch = self._batch
            self._batch = None
            if batch is None or (not batch.prepared and not batch.unprepared):
                return  # nothing deferred; the old checkpoint is still true
            try:
                with TRACER.span("Prepare.commitCheckpointBatch"):
                    self._write_checkpoint()
            except BaseException:
                for _uid, undo in reversed(batch.prepared):
                    for fn in reversed(undo):
                        try:
                            fn()
                        except Exception:
                            pass  # best-effort unwind; original error wins
                for uid, prepared in batch.unprepared:
                    self.prepared[uid] = prepared
                raise

    def prepared_claim_uids(self) -> list[str]:
        with self._lock:
            return list(self.prepared)

    def refresh(self) -> bool:
        """Re-enumerate the hardware AND re-read the tpu-parted layout; True
        when the inventory changed (chip died/recovered, topology env
        changed, layout re-applied).  On change the base CDI spec is
        rewritten so future claims see current truth — this is the LIVE
        repartitioning path the reference never shipped (its dynamic MIG
        create/delete is commented out, nvlib.go:560-669).

        Enumeration runs OUTSIDE the state lock: sysfs reads on dying
        hardware can block for seconds, and holding the lock would freeze
        NodePrepareResources for the duration (the sweep exists precisely
        for sick nodes)."""
        new_topology = enumerate_topology(env=self.config.topology_env or None)
        # the NEW enumeration's host id, not self.topology's: reading the
        # lock-guarded field outside the lock was both racy and stale
        new_layout = self._load_layout(int(new_topology.host_id))
        with self._lock:
            # Runtime-health overlay (selftest failures): applied after
            # enumeration so a chip that ENUMERATES fine but fails compute
            # publishes healthy=false like any statically-dead chip — and
            # participates in the change comparison, so overlay transitions
            # republish.
            if self._health_overlay:
                import dataclasses

                chips = list(new_topology.chips)
                touched = False
                for pos, reason in self._health_overlay.items():
                    if 0 <= pos < len(chips) and chips[pos].healthy:
                        chips[pos] = dataclasses.replace(
                            chips[pos], healthy=False, health_reason=reason
                        )
                        touched = True
                if touched:
                    # keep the container type: list-vs-tuple chips would fail
                    # the equality below and republish identical inventory
                    new_topology = dataclasses.replace(
                        new_topology, chips=type(new_topology.chips)(chips)
                    )
            if new_topology == self.topology and new_layout == self._layout:
                return False
            # The visible-chips mask was validated against the STARTUP chip
            # count; a hot-reloaded topology with fewer chips would make
            # from_topology silently drop the now-out-of-range positions —
            # the quiet mis-publication the strict parse exists to prevent.
            # Keep the previous (still-consistent) inventory and tell the
            # operator: the mask label and the hardware must be reconciled.
            if self._visible is not None:
                bad = sorted(
                    p for p in self._visible if p >= len(new_topology.chips)
                )
                if bad:
                    import logging

                    logging.getLogger(__name__).error(
                        "visible-chips positions %s out of range for reloaded "
                        "topology (%d chips); keeping previous inventory until "
                        "the mask is fixed",
                        bad,
                        len(new_topology.chips),
                    )
                    return False
            self.topology = new_topology
            self._layout = new_layout
            self.allocatable = AllocatableDevices.from_topology(
                new_topology, new_layout, self._visible
            )
            self.cdi.create_base_spec(self.allocatable)
            return True

    def set_health_overlay(self, overlay: dict[int, str]) -> bool:
        """Replace the runtime-health overlay (chip position -> reason);
        returns True when it changed.  Takes effect at the next refresh()
        — the caller (the driver's health sweep) runs one right after."""
        with self._lock:
            changed = overlay != self._health_overlay
            self._health_overlay = dict(overlay)
        return changed

    def _load_layout(self, host_id: int):
        """This host's applied subslice layout; a corrupt state file keeps
        everything published (never brick enumeration on a bad push).
        ``host_id`` is passed in so the caller decides WHICH enumeration's
        host it means — this runs outside the state lock."""
        from k8s_dra_driver_torch.plugin import parted

        if not self.config.parted_state_path:
            return parted.ALL_SHAPES
        try:
            return parted.load_applied_layout(
                self.config.parted_state_path, host_id
            )
        except parted.PartedError:
            import logging

            logging.getLogger(__name__).exception(
                "ignoring corrupt tpu-parted state at %s", self.config.parted_state_path
            )
            return parted.ALL_SHAPES

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _write_checkpoint(self) -> None:
        self._checkpoint.write({uid: p.to_json() for uid, p in self.prepared.items()})

    def _prepare_devices(self, claim: ResourceClaim, undo) -> PreparedClaim:
        alloc = claim.status.allocation

        # 1. Decode opaque configs, class configs first (lowest precedence
        #    among explicit ones), then claim configs (device_state.go:446-510).
        configs: list[tuple[Optional[set], object]] = []  # (requests|None=all, config)
        for c in sorted(
            alloc.devices.config, key=lambda c: 0 if c.source == "FromClass" else 1
        ):
            if c.opaque is None or c.opaque.driver != DRIVER_NAME:
                continue
            decoded = self._decoder.decode(c.opaque.parameters)
            configs.append((set(c.requests) if c.requests else None, decoded))

        # 2. Resolve per allocation result by reverse-precedence scan
        #    (device_state.go:225-259); fall back to per-type defaults
        #    (:210-221).
        groups: dict[int, tuple[object, list[tuple[object, AllocatableDevice]]]] = {}
        # members carry (DeviceRequestAllocationResult, AllocatableDevice)
        defaults: dict[str, object] = {}
        for result in alloc.devices.results:
            if result.driver != DRIVER_NAME:
                continue
            device = self.allocatable.devices.get(result.device)
            if device is None:
                # Membership seats are published by the cluster controller,
                # not this node's pool — resolve them from the API server
                # (the reference's plugin likewise prepares IMEX channels the
                # controller published, nvlib.go:182-200 + device_state.go:430-444).
                device = self._resolve_remote_device(result)
            if device is None:
                raise PrepareError(f"allocated device {result.device!r} is not on this node")
            self._check_health(device)
            chosen = None
            for requests, cfg in reversed(configs):
                if requests is None or result.request in requests:
                    chosen = cfg
                    break
            if chosen is None:
                kind = device.kind
                if kind not in defaults:
                    defaults[kind] = self._default_config(kind)
                chosen = defaults[kind]
            self._check_config_applies(chosen, device)
            key = id(chosen)
            groups.setdefault(key, (chosen, []))[1].append((result, device))

        # 3. Normalize+validate each chosen config once, then realize it
        #    (device_state.go:279-287, 367-428).
        prepared = PreparedClaim(
            uid=claim.metadata.uid,
            namespace=claim.metadata.namespace,
            name=claim.metadata.name,
        )
        for cfg, members in groups.values():
            cfg.normalize()
            cfg.validate()
            devices = [d for _, d in members]
            edits, state = self._apply_config(claim, cfg, devices, undo)
            group = PreparedDeviceGroup(config_state=state)
            for result, device in members:
                group.devices.append(
                    self._prepared_device(claim, result.request, result.pool, device)
                )
            group.config_state.env = {**self._wiring_env(devices), **edits.env}
            group.config_state.mounts = [[host, cont] for host, cont in edits.mounts]
            prepared.groups.append(group)
        return prepared

    def _resolve_remote_device(self, result) -> Optional[AllocatableDevice]:
        slices = [
            s
            for s in self._server.list(ResourceSlice.KIND)
            if s.spec.driver == result.driver and s.spec.pool.name == result.pool
        ]
        if not slices:
            return None
        # Only the pool's highest generation is authoritative — same rule the
        # allocator applies (scheduler/allocator.py), so a Prepare racing a
        # pool rewrite never wires stale coordinator/host-count data.
        max_gen = max(s.spec.pool.generation for s in slices)
        for s in slices:
            if s.spec.pool.generation != max_gen:
                continue
            for d in s.spec.devices:
                if d.name != result.device:
                    continue
                attrs = d.basic.attributes
                if attrs.get("type") and attrs["type"].value == DEVICE_TYPE_MEMBERSHIP:
                    return AllocatableDevice(
                        membership=SliceMembershipInfo(
                            domain=attrs["sliceDomain"].value,
                            worker_id=attrs["workerId"].value,
                            host_count=attrs["hostCount"].value,
                            coordinator_address=attrs["coordinatorAddress"].value,
                        )
                    )
                if attrs.get("type") and attrs["type"].value == DEVICE_TYPE_GROUP_SEAT:
                    return AllocatableDevice(
                        group_seat=SliceGroupSeatInfo(
                            group=attrs["sliceGroup"].value,
                            domain=attrs["sliceDomain"].value,
                            slice_id=attrs["sliceId"].value,
                            num_slices=attrs["numSlices"].value,
                            worker_id=attrs["workerId"].value,
                            host_count=attrs["hostCount"].value,
                            coordinator_address=attrs["coordinatorAddress"].value,
                        )
                    )
        return None

    def _check_health(self, device: AllocatableDevice) -> None:
        """A claim allocated before a chip died must fail Prepare loudly, not
        hand the pod a dead device node."""
        chips = []
        if device.chip is not None:
            chips = [device.chip.chip]
        elif device.subslice is not None:
            topo = device.subslice.topology
            chips = [topo.chips[i] for i in device.subslice.subslice.chip_indices]
        dead = [c.device_path for c in chips if not c.healthy]
        if dead:
            raise PrepareError(
                f"device {device.name!r} includes unhealthy chip(s): {dead}"
            )

    def _default_config(self, kind: str):
        if kind == DEVICE_TYPE_CHIP:
            return default_tpu_config()
        if kind == DEVICE_TYPE_SUBSLICE:
            return default_subslice_config()
        if kind == DEVICE_TYPE_GROUP_SEAT:
            cfg = SliceGroupConfig()
            cfg.normalize()
            return cfg
        cfg = SliceMembershipConfig()
        cfg.normalize()
        return cfg

    def _check_config_applies(self, cfg, device: AllocatableDevice) -> None:
        """Config kind ↔ device kind compatibility (the reference's typed
        dispatch in applyConfig, device_state.go:367-378)."""
        ok = (
            (isinstance(cfg, TpuConfig) and device.kind == DEVICE_TYPE_CHIP)
            or (isinstance(cfg, SubsliceConfig) and device.kind == DEVICE_TYPE_SUBSLICE)
            or (
                isinstance(cfg, SliceMembershipConfig)
                and device.kind == DEVICE_TYPE_MEMBERSHIP
            )
            or (
                isinstance(cfg, SliceGroupConfig)
                and device.kind == DEVICE_TYPE_GROUP_SEAT
            )
        )
        if not ok:
            raise PrepareError(
                f"config {type(cfg).__name__} cannot apply to {device.kind} "
                f"device {device.name!r}"
            )

    def _apply_config(
        self, claim, cfg, devices: list[AllocatableDevice], undo
    ) -> tuple[ContainerEdits, DeviceConfigState]:
        if isinstance(cfg, SliceMembershipConfig):
            env = {"JAX_COORDINATOR_PORT": str(cfg.coordinator_port), **cfg.extra_env}
            if cfg.megascale:
                # single-slice default: let libtpu self-discover.  A claim
                # that ALSO binds a slice-GROUP seat gets the explicit
                # cross-slice coordinator from that seat instead.
                env["MEGASCALE_COORDINATOR_ADDRESS"] = "auto"
            return ContainerEdits(env=env), DeviceConfigState(strategy="Membership", env={})
        if isinstance(cfg, SliceGroupConfig):
            # Cross-slice (DCN) megascale wiring: the group seat's
            # coordinator host + the config's DCN transport port.  The
            # identity env (NUM_SLICES / SLICE_ID) is seat-derived and
            # injected by _wiring_env; this layer carries the tunables.
            env = {"MEGASCALE_PORT": str(cfg.megascale_port), **cfg.extra_env}
            seat = next(
                (d.group_seat for d in devices if d.group_seat is not None), None
            )
            if seat is not None and seat.coordinator_address:
                host = seat.coordinator_address.rsplit(":", 1)[0]
                env["MEGASCALE_COORDINATOR_ADDRESS"] = (
                    f"{host}:{cfg.megascale_port}"
                )
            return ContainerEdits(env=env), DeviceConfigState(strategy="SliceGroup", env={})

        sharing = cfg.sharing
        strategy = sharing.strategy
        if strategy == SharingStrategy.EXCLUSIVE:
            return ContainerEdits(), DeviceConfigState(strategy="Exclusive")
        if strategy == SharingStrategy.TIME_SLICING:
            edits = self.ts_manager.apply(devices, sharing.get_time_slicing_config())
            return edits, DeviceConfigState(strategy="TimeSlicing")
        if strategy == SharingStrategy.SPATIAL_PARTITION:
            edits, daemon, per_device_env = self.sp_manager.start(
                claim.metadata.uid, devices, sharing.get_spatial_partition_config()
            )
            undo.append(lambda: self.sp_manager.stop(daemon))
            return edits, DeviceConfigState(
                strategy="SpatialPartition",
                per_device_env=per_device_env,
                daemon_name=daemon.name,
                daemon_namespace=daemon.namespace,
            )
        raise SharingError(f"unhandled strategy {strategy!r}")

    def _wiring_env(self, devices: list[AllocatableDevice]) -> dict[str, str]:
        """libtpu/JAX wiring for the claimed devices: which chips are visible
        and, for subslices, the process-local mesh bounds (the TPU
        counterpart of CUDA_VISIBLE_DEVICES injection via CDI)."""
        env: dict[str, str] = {}
        chip_indices: list[int] = []
        for d in devices:
            if d.chip is not None:
                chip_indices.append(d.chip.chip.index)
            elif d.subslice is not None:
                topo = d.subslice.topology
                chip_indices.extend(
                    topo.chips[i].index for i in d.subslice.subslice.chip_indices
                )
        if chip_indices:
            env["TPU_VISIBLE_DEVICES"] = ",".join(str(i) for i in sorted(chip_indices))
        subslices = [d for d in devices if d.subslice is not None]
        if len(subslices) == 1:
            shape = subslices[0].subslice.subslice.shape
            env["TPU_CHIPS_PER_PROCESS_BOUNDS"] = ",".join(str(s) for s in shape)
            env["TPU_PROCESS_BOUNDS"] = "1,1,1"
        memberships = [d for d in devices if d.membership is not None]
        if len(memberships) > 1:
            # Env is group-scoped; two seats in one group would silently
            # last-wins the worker identity.
            raise PrepareError(
                "a claim may bind at most one slice-membership seat per "
                f"config group, got {[d.name for d in memberships]}"
            )
        for d in memberships:
            m = d.membership
            env["TPU_WORKER_ID"] = str(m.worker_id)
            env["TPU_HOST_COUNT"] = str(m.host_count)
            if m.coordinator_address:
                env["JAX_COORDINATOR_ADDRESS"] = m.coordinator_address
        group_seats = [d for d in devices if d.group_seat is not None]
        if len(group_seats) > 1:
            raise PrepareError(
                "a claim may bind at most one slice-group seat per config "
                f"group, got {[d.name for d in group_seats]}"
            )
        for d in group_seats:
            g = d.group_seat
            # The multislice identity: which slice of how many this pod's
            # host belongs to (MEGASCALE_COORDINATOR_ADDRESS/PORT come from
            # the SliceGroupConfig layer, _apply_config).
            env["MEGASCALE_NUM_SLICES"] = str(g.num_slices)
            env["MEGASCALE_SLICE_ID"] = str(g.slice_id)
        return env

    def _prepared_device(
        self, claim, request: str, pool: str, device: AllocatableDevice
    ) -> PreparedDevice:
        paths: list[str] = []
        if device.chip is not None:
            paths = [device.chip.chip.device_path]
        elif device.subslice is not None:
            topo = device.subslice.topology
            paths = [topo.chips[i].device_path for i in device.subslice.subslice.chip_indices]
        # Membership/group seats exist only in the per-claim transient spec
        # (the base spec covers local hardware); emitting a base-qualified
        # id for them would hand kubelet a CDI name no spec defines.
        cdi_ids = [
            self.cdi.qualified_name(
                self.cdi.claim_device_name(claim.metadata.uid, device.name)
            )
        ]
        if device.membership is None and device.group_seat is None:
            cdi_ids.insert(0, self.cdi.qualified_name(device.name))
        return PreparedDevice(
            kind=device.kind,
            name=device.name,
            pool=pool,
            request=request,
            uuids=device.uuids(),
            device_paths=paths,
            cdi_device_ids=cdi_ids,
        )
