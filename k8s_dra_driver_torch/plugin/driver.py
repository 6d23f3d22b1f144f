"""The port of ``k8s_dra_driver_tpu/plugin/driver.py`` (copied: the port imports
nothing of the JAX package).

Kubelet-plugin driver: inventory publishing + claim prepare/unprepare.

Mirror of cmd/nvidia-dra-plugin/driver.go (168 LoC): construct DeviceState,
publish every allocatable device as one node-local ResourceSlice pool
(driver.go:71-83), serialize Prepare/Unprepare per claim with per-claim error
fan-out (driver.go:96-154).  The gRPC transport lives in grpc_service.py;
this class is the transport-independent core so the in-process harness and
the unix-socket server share one implementation.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from k8s_dra_driver_torch import DRIVER_NAME
from k8s_dra_driver_torch.kube.fakeserver import APIError, NotFound
from k8s_dra_driver_torch.kube.objects import ResourceClaim
from k8s_dra_driver_torch.kube.resourceslice_controller import (
    DriverResources,
    Pool,
    ResourceSliceController,
    Slice,
)
from k8s_dra_driver_torch.plugin.device_state import DeviceState, DeviceStateConfig
from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.metrics import REGISTRY
from k8s_dra_driver_torch.utils.tracing import TRACER

# The self-test's platform name for the cards this driver publishes
# (``tpuinfo/selftest.py`` reports "gpu" on the card; the reference's
# probe reports "tpu").
PROBE_PLATFORM = "gpu"

# ResourceSlice device limit per object (upstream k8s constant): split pools
# into slices of at most this many devices.
DEVICES_PER_SLICE = 128


@dataclass
class DriverConfig(DeviceStateConfig):
    publish: bool = True


@dataclass
class ClaimRef:
    uid: str
    name: str
    namespace: str


@dataclass
class ClaimResult:
    """Per-claim result of a batched NodePrepare/NodeUnprepare call."""

    devices: list[dict] = field(default_factory=list)
    error: str = ""


class Driver:
    def __init__(self, server, config: DriverConfig):
        self._server = server
        self.config = config
        self._lock = threading.Lock()
        # The BASELINE claim-latency instrumentation the reference lacks
        # (SURVEY.md §5 "no claim-latency histograms").
        self._prepare_seconds = REGISTRY.histogram(
            "dra_node_prepare_seconds", "NodePrepareResources per-claim latency"
        )
        self._unprepare_seconds = REGISTRY.histogram(
            "dra_node_unprepare_seconds", "NodeUnprepareResources per-claim latency"
        )
        self._claim_errors = REGISTRY.counter(
            "dra_claim_errors_total", "Per-claim prepare/unprepare failures"
        )
        self.state = DeviceState(server, config)
        # 1 while the last publish attempt failed: the cluster may be
        # scheduling against stale slices (we keep serving the last-published
        # inventory rather than crashing; see publish_resources).
        self._stale_gauge = REGISTRY.gauge(
            "dra_inventory_stale",
            "1 when the last ResourceSlice publish failed and the advertised "
            "inventory may be stale",
        )
        self._stale_gauge.set(0, node=config.node_name)
        self._needs_publish = False
        self._last_selftest = 0.0
        self._selftest_thread: threading.Thread | None = None
        self._selftest_report: dict | None = None
        self._selftest_run = None  # in-flight SelftestRun, cancellable
        self._selftest_join_grace_s = 1.0
        REGISTRY.gauge(
            "dra_allocatable_devices", "Devices this node publishes"
        ).set(len(self.state.allocatable), node=config.node_name)
        self._slice_controller = ResourceSliceController(
            server, DRIVER_NAME, config.node_name
        )
        if config.publish:
            self.publish_resources()

    # -- inventory (driver.go:71-83) ---------------------------------------

    def publish_resources(self) -> bool:
        """Reconcile the node pool; returns True on success.

        Degrades instead of crashing on API trouble: the cluster keeps
        serving the LAST successfully published inventory, staleness is
        marked (``dra_inventory_stale``) and ``_needs_publish`` stays set
        so the next health sweep retries (transient errors heal without
        operator action; persistent ones are visible on the gauge)."""
        devices = self.state.allocatable.get_devices()
        JOURNAL.record(
            "driver", "inventory.publish", correlation=self.config.node_name,
            devices=len(devices),
        )
        slices = [
            Slice(devices=devices[i : i + DEVICES_PER_SLICE])
            for i in range(0, len(devices), DEVICES_PER_SLICE)
        ] or [Slice()]
        try:
            self._slice_controller.update(
                DriverResources(
                    pools={
                        self.config.node_name: Pool(
                            slices=slices, node_name=self.config.node_name
                        )
                    }
                )
            )
        except (APIError, OSError) as exc:
            self._needs_publish = True
            self._stale_gauge.set(1, node=self.config.node_name)
            JOURNAL.record(
                "driver", "inventory.publish_fail",
                correlation=self.config.node_name,
                error=f"{type(exc).__name__}: {exc}",
            )
            return False
        self._needs_publish = False
        self._stale_gauge.set(0, node=self.config.node_name)
        return True

    def shutdown(self, delete_slices: bool = False) -> None:
        """The node plugin normally leaves its slices published across
        restarts; tests can force cleanup."""
        self._slice_controller.stop(delete_owned=delete_slices)

    # -- claim fan-out (driver.go:96-154) ----------------------------------

    def node_prepare_resources(self, claims: list[ClaimRef]) -> dict[str, ClaimResult]:
        out: dict[str, ClaimResult] = {}
        with self._lock:
            # A workload is arriving: kill any in-flight self-test probe NOW
            # (the card belongs to the claim; the probe would disturb the pod's
            # runtime init).  Its report comes back cancelled and is
            # discarded by the sweep.
            if self._selftest_run is not None:
                self._selftest_run.cancel()
            # Group commit: ONE durable checkpoint write for the whole batch,
            # flushed below before this method returns — i.e. before the gRPC
            # response is built — so kubelet never sees success for a claim
            # the checkpoint doesn't cover.
            self.state.begin_checkpoint_batch()
            commit_error: Exception | None = None
            try:
                for ref in claims:
                    ok = False
                    JOURNAL.record_lazy(
                        "driver", "prepare.start", correlation=ref.uid,
                        attrs=lambda: dict(
                            claim=f"{ref.namespace}/{ref.name}",
                            node=self.config.node_name,
                        ),
                    )
                    with TRACER.span(
                        "NodePrepareResources", claim=f"{ref.namespace}/{ref.name}"
                    ) as span:
                        try:
                            out[ref.uid] = ClaimResult(devices=self._prepare_one(ref))
                            ok = True
                        except Exception as exc:  # per-claim, not process-fatal
                            self._claim_errors.inc(op="prepare")
                            JOURNAL.record(
                                "driver", "prepare.fail", correlation=ref.uid,
                                error=f"{type(exc).__name__}: {exc}",
                            )
                            out[ref.uid] = ClaimResult(
                                error=f"error preparing claim {ref.namespace}/{ref.name}: {exc}"
                            )
                    if ok:
                        # single timing source: the span's measurement
                        self._prepare_seconds.observe(span.duration_ms / 1000)
                        JOURNAL.record_lazy(
                            "driver", "prepare.ok", correlation=ref.uid,
                            attrs=lambda: dict(
                                devices=[
                                    d.get("device_name", "")
                                    for d in out[ref.uid].devices
                                ],
                                duration_ms=round(span.duration_ms, 3),
                            ),
                        )
            finally:
                try:
                    self.state.commit_checkpoint_batch()
                except Exception as exc:
                    commit_error = exc
            if commit_error is not None:
                # The batch rolled itself back: every claim prepared in it
                # was unwound.  Tell kubelet so it retries them all — a
                # success here would be success without durability.
                JOURNAL.record(
                    "driver", "prepare.commit_fail",
                    correlation=self.config.node_name,
                    error=f"{type(commit_error).__name__}: {commit_error}",
                )
                for ref in claims:
                    res = out.get(ref.uid)
                    if res is not None and not res.error:
                        self._claim_errors.inc(op="prepare")
                        out[ref.uid] = ClaimResult(
                            error=f"error preparing claim {ref.namespace}/{ref.name}: "
                            f"checkpoint commit failed: {commit_error}"
                        )
        return out

    def node_unprepare_resources(self, claims: list[ClaimRef]) -> dict[str, ClaimResult]:
        out: dict[str, ClaimResult] = {}
        with self._lock:
            self.state.begin_checkpoint_batch()
            commit_error: Exception | None = None
            try:
                for ref in claims:
                    start = time.perf_counter()
                    JOURNAL.record_lazy(
                        "driver", "unprepare.start", correlation=ref.uid,
                        attrs=lambda: dict(
                            claim=f"{ref.namespace}/{ref.name}",
                            node=self.config.node_name,
                        ),
                    )
                    try:
                        self.state.unprepare(ref.uid)
                        self._unprepare_seconds.observe(time.perf_counter() - start)
                        out[ref.uid] = ClaimResult()
                        JOURNAL.record_lazy("driver", "unprepare.ok", correlation=ref.uid)
                    except Exception as exc:
                        self._claim_errors.inc(op="unprepare")
                        JOURNAL.record(
                            "driver", "unprepare.fail", correlation=ref.uid,
                            error=f"{type(exc).__name__}: {exc}",
                        )
                        out[ref.uid] = ClaimResult(
                            error=f"error unpreparing claim {ref.namespace}/{ref.name}: {exc}"
                        )
            finally:
                try:
                    self.state.commit_checkpoint_batch()
                except Exception as exc:
                    commit_error = exc
            if commit_error is not None:
                # Batch rolled back: entries restored, so a kubelet retry
                # re-runs the (idempotent) teardown and re-attempts the write.
                JOURNAL.record(
                    "driver", "unprepare.commit_fail",
                    correlation=self.config.node_name,
                    error=f"{type(commit_error).__name__}: {commit_error}",
                )
                for ref in claims:
                    res = out.get(ref.uid)
                    if res is not None and not res.error:
                        self._claim_errors.inc(op="unprepare")
                        out[ref.uid] = ClaimResult(
                            error=f"error unpreparing claim {ref.namespace}/{ref.name}: "
                            f"checkpoint commit failed: {commit_error}"
                        )
        return out

    # -- health monitoring (neither reference binary has this) ---------------

    def refresh_inventory(self) -> bool:
        """Periodic health sweep: re-enumerate, republish on change, export
        the unhealthy-chip gauge.  Returns True when inventory changed.

        Publish failures keep ``_needs_publish`` set so the NEXT sweep
        retries even though refresh() already committed the new topology —
        otherwise a transient API error would leave stale slices advertised
        forever.  The sweep itself never crashes on publish trouble: static
        health, orphan cleanup and the selftest share this thread."""
        self._maybe_selftest()
        changed = self.state.refresh()
        unhealthy = sum(1 for c in self.state.topology.chips if not c.healthy)
        REGISTRY.gauge(
            "dra_unhealthy_chips", "Local chips currently failing enumeration/health"
        ).set(unhealthy, node=self.config.node_name)
        if changed:
            REGISTRY.gauge("dra_allocatable_devices", "Devices this node publishes").set(
                len(self.state.allocatable), node=self.config.node_name
            )
            self._needs_publish = True
        if self._needs_publish and self.config.publish:
            try:
                self.publish_resources()  # manages _needs_publish + staleness
            except Exception as exc:  # unexpected (transport errors are
                # handled inside publish_resources): degrade, don't kill
                # the sweep — retry next pass.
                self._needs_publish = True
                self._stale_gauge.set(1, node=self.config.node_name)
                JOURNAL.record(
                    "driver", "inventory.publish_fail",
                    correlation=self.config.node_name,
                    error=f"{type(exc).__name__}: {exc}",
                )
        return changed

    def _maybe_selftest(self) -> None:
        """Runtime self-test (tpuinfo/selftest.py) folded into the sweep.

        Static enumeration can't see a chip that mounts fine but corrupts
        matmuls or hangs the runtime; when ``selftest_interval_s`` is set,
        the watchdogged on-chip probe runs at that cadence and failures
        become a ``selftest-failed`` health overlay on the published
        inventory.

        Three constraints shape the flow:
        * the card belongs to its claims — probing a node whose cards serve
          prepared claims would both fail spuriously and disturb the
          workload, so the probe only launches (and init-failure reports
          only apply) while NO claims are prepared: this is pre-flight
          health for idle nodes, like any between-jobs hardware checker.
        * a hung backend must not stall the sweep (static health and orphan
          cleanup share the thread): the probe runs in a daemon thread,
          joined briefly; slow results fold into a later sweep.
        * mapping: the probe's CUDA device order == local card enumeration
          order, both PCI bus order (the shim sorts by bus id,
          ``start_selftest`` sets ``CUDA_DEVICE_ORDER=PCI_BUS_ID``).  On
          ANY device/card count mismatch the whole node is fenced — all-pass
          over fewer devices than published cards means some card is
          invisible to the runtime, the strongest failure signal there is.
          A probe on another platform than :data:`PROBE_PLATFORM` (the CPU
          under fake topologies) fences nothing: the probe didn't test the
          published cards (the gauge still reports its honest ok/failed
          result)."""
        interval = self.config.selftest_interval_s
        if interval <= 0:
            return
        self._fold_selftest_report()
        now = time.monotonic()
        due = not self._last_selftest or now - self._last_selftest >= interval
        thread = self._selftest_thread
        with self._lock:
            busy = bool(self.state.prepared)
        if not due or busy or (thread is not None and thread.is_alive()):
            return
        self._last_selftest = now
        from k8s_dra_driver_torch.tpuinfo.selftest import start_selftest

        timeout_s = max(min(interval, 180.0), 30.0)

        def worker():
            run = start_selftest(timeout_s=timeout_s)
            with self._lock:
                self._selftest_run = run  # visible to prepare for cancel
            result = run.result()
            with self._lock:
                self._selftest_report = result
                self._selftest_run = None

        thread = threading.Thread(target=worker, daemon=True, name="tpu-selftest")
        self._selftest_thread = thread
        thread.start()
        # Brief join: a fast probe (healthy chip, stubbed test) folds into
        # THIS sweep; a hung one keeps running and folds later.
        thread.join(timeout=self._selftest_join_grace_s)
        self._fold_selftest_report()

    def _fold_selftest_report(self) -> None:
        """Apply the newest completed probe report, if any.  ``busy`` is
        recomputed HERE (not at launch): a claim prepared while the probe
        ran means its failure may just be exclusive-access contention —
        never fence a node that is healthily serving workloads.  Cancelled
        probes (killed by prepare, see node_prepare_resources) say
        nothing."""
        with self._lock:
            report = self._selftest_report
            self._selftest_report = None
            busy = bool(self.state.prepared)
        if report is not None and not report.get("cancelled"):
            self._apply_selftest_report(report, busy)

    def _apply_selftest_report(self, report: dict, busy: bool) -> None:
        n_chips = len(self.state.topology.chips)
        if report.get("error") and busy:
            # Exclusive access explains init failures on a working node;
            # discard rather than fence chips that are serving claims.
            return
        overlay: dict[int, str] = {}
        if report.get("error"):
            overlay = {pos: "selftest-failed" for pos in range(n_chips)}
        elif report.get("platform") == PROBE_PLATFORM:
            devices = report.get("devices", [])
            if len(devices) == n_chips:
                overlay = {
                    pos: "selftest-failed"
                    for pos, dev in enumerate(devices)
                    if not dev.get("ok")
                }
            else:
                overlay = {pos: "selftest-failed" for pos in range(n_chips)}
        else:
            REGISTRY.gauge(
                "dra_selftest_ok", "Last runtime self-test result (1 ok / 0 failed)"
            ).set(1 if report.get("ok") else 0, node=self.config.node_name)
            return  # a CPU probe says nothing about published cards
        REGISTRY.gauge(
            "dra_selftest_ok", "Last runtime self-test result (1 ok / 0 failed)"
        ).set(0 if overlay else 1, node=self.config.node_name)
        self.state.set_health_overlay(overlay)

    # -- orphan cleanup (the reference left this as a TODO, driver.go:156-168)

    def cleanup_orphans(self) -> dict[str, list[str]]:
        """Reconcile node-local residue against the API server + checkpoint.

        Three sweeps, in dependency order:
        1. checkpointed claims whose ResourceClaim is gone (deleted while the
           plugin was down) → full unprepare (stops daemons, removes specs);
        2. CDI claim-spec files on disk with no checkpoint entry (crash
           between spec write and checkpoint write) → delete;
        3. topology-daemon Deployments whose claim uid is no longer prepared
           (crash between daemon create and checkpoint write) → delete.
        Returns what was cleaned, for logging/metrics.
        """
        from k8s_dra_driver_torch.kube.objects import Deployment

        cleaned: dict[str, list[str]] = {"claims": [], "cdi_specs": [], "daemons": []}
        with self._lock:
            for uid in self.state.prepared_claim_uids():
                prepared = self.state.prepared[uid]
                gone = False
                try:
                    claim = self._server.get(
                        ResourceClaim.KIND, prepared.name, prepared.namespace
                    )
                    gone = claim.metadata.uid != uid
                except NotFound:
                    gone = True
                if gone:
                    self.state.unprepare(uid)
                    cleaned["claims"].append(uid)

            live = set(self.state.prepared_claim_uids())
            for uid in self.state.cdi.list_claim_spec_uids():
                if uid not in live:
                    self.state.cdi.delete_claim_spec_file(uid)
                    cleaned["cdi_specs"].append(uid)

            # Scope to THIS node's daemons: other plugins' claims are not in
            # our checkpoint and must never look like orphans to us.
            for dep in self._server.list(
                Deployment.KIND,
                namespace=self.config.namespace,
                label_selector={
                    "app.kubernetes.io/name": "tpu-topology-daemon",
                    "tpu.google.com/node": self.config.node_name,
                },
            ):
                uid = dep.metadata.labels.get("resourceclaim.tpu.google.com/uid", "")
                if uid and uid not in live:
                    self._server.delete(
                        Deployment.KIND, dep.metadata.name, dep.metadata.namespace
                    )
                    cleaned["daemons"].append(dep.metadata.name)
        if any(cleaned.values()):
            JOURNAL.record(
                "driver", "orphans.cleaned", correlation=self.config.node_name,
                **{k: v for k, v in cleaned.items() if v},
            )
        return cleaned

    def _prepare_one(self, ref: ClaimRef) -> list[dict]:
        # Re-fetch the claim from the API server — the kubelet request only
        # carries the reference (driver.go:122-125).
        try:
            claim = self._server.get(ResourceClaim.KIND, ref.name, ref.namespace)
        except NotFound as exc:
            raise RuntimeError(f"failed to fetch ResourceClaim {ref.name!r}: {exc}") from exc
        if claim.metadata.uid != ref.uid:
            raise RuntimeError(
                f"claim {ref.name!r} uid mismatch: have {claim.metadata.uid}, want {ref.uid}"
            )
        return self.state.prepare(claim)
