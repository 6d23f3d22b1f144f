"""The port of ``k8s_dra_driver_tpu/controller/slice_manager.py`` (copied:
the port imports nothing of the JAX package).  It publishes the port's
``plugin/deviceinfo`` seats through the port's
``kube/resourceslice_controller``; the same Node events give the same
ResourceSlices as the reference's manager, but for one repair: ``start``
publishes once after the Node informer's initial replay, where the
reference publishes once a replayed Node.  A new leader taking over N
published seats otherwise rewrites the pool with 1, 2, ... N seats in
turn (each write a pool generation), so a watcher sees the seats vanish
and come back; at client-go's 5 QPS that window is about 2N/5 s long.
The final slices are the reference's but for their pool generation.

Cluster-scoped multi-host slice controller.

Mirror of the reference's ImexManager (cmd/nvidia-dra-controller/imex.go,
416 LoC), re-imagined for multi-host slices: where the IMEX manager watches
``nvidia.com/gpu.imex-domain`` node labels and publishes per-domain pools of
fungible channel devices, this manager watches slice-domain labels (GKE
provisions multi-host slices atomically and labels every node) and
publishes per-domain pools of **membership seats** — one per worker host —
each carrying the worker id, host count and coordinator address a process
needs to join the slice (the claim's process group, or megascale wiring).

Kept behaviors (imex.go citations):
* first/last-node edge detection per domain via Node informer (:207-295)
* offset-window assignment out of a global seat budget (:319-351)
* NodeSelector-gated ResourceSlice pools via the declarative reconciler (:371-416)
* transient-error retry after a timeout (:131-151)
* deletion of all owned slices on shutdown (:298-316)
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from k8s_dra_driver_torch import DRIVER_NAME
from k8s_dra_driver_torch.kube.fakeserver import APIError
from k8s_dra_driver_torch.kube.objects import (
    Node,
    NodeSelector,
    NodeSelectorRequirement,
    NodeSelectorTerm,
)
from k8s_dra_driver_torch.kube.resourceslice_controller import (
    DriverResources,
    Pool,
    ResourceSliceController,
    Slice,
)
from k8s_dra_driver_torch.plugin.deviceinfo import SliceMembershipInfo
from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.logging import get_logger
from k8s_dra_driver_torch.utils.retry import Backoff, RetryPolicy

log = get_logger("tpu-dra-controller.slice-manager")

SLICE_DOMAIN_LABEL = "tpu.google.com/slice-domain"
SLICE_HOST_ID_LABEL = "tpu.google.com/slice-host-id"
# Multi-slice jobs: the provisioner labels every node of every member slice
# with the GROUP the slices were joined into (GKE multislice over DCN) —
# the next scale up from the per-domain seats (the reference's IMEX pattern
# tops out at one NVLink domain; imex.go:371-416).
SLICE_GROUP_LABEL = "tpu.google.com/slice-group"

# Global seat budget and per-slice cap (imex.go:43-46's 2048/128 analogs).
DRIVER_MEMBERSHIP_LIMIT = 2048
MEMBERSHIP_PER_SLICE_LIMIT = 128
RETRY_TIMEOUT_S = 60.0
DEFAULT_COORDINATOR_PORT = 8476


class TransientError(RuntimeError):
    """Retryable condition (seat budget exhaustion), imex.go:49."""


def _parse_host_id(raw: str | None) -> int | None:
    if raw is None:
        return None
    try:
        value = int(raw)
    except ValueError:
        return None
    return value if value >= 0 else None


@dataclass
class _Domain:
    nodes: dict[str, int] = field(default_factory=dict)  # node name -> host id
    offset: int = -1
    # slice-group membership: group label seen per node (a domain's group is
    # decided by its worker-0 node; conflicting labels log loudly)
    groups: dict[str, str] = field(default_factory=dict)  # node name -> group

    def group(self) -> str | None:
        """The domain's group: what its LOWEST-host-id labeled node says
        (deterministic under conflicting labels, which _publish warns on)."""
        labeled = [(self.nodes.get(n, 1 << 30), g) for n, g in self.groups.items()]
        return min(labeled)[1] if labeled else None


class SliceManager:
    def __init__(
        self,
        server,
        owner: str = "controller",
        retry_timeout_s: float = RETRY_TIMEOUT_S,
        clock=time.monotonic,
    ):
        self._server = server
        self._lock = threading.Lock()
        self._domains: dict[str, _Domain] = {}
        self._offsets: dict[str, list[int]] = {}  # domain -> reserved window starts
        self._retry: dict[str, float] = {}  # domain -> earliest retry time
        # Shared parking policy (utils/retry.py) instead of the reference's
        # flat RetryTimeout (imex.go:131-151): repeated transient failures
        # back off exponentially up to the old flat timeout as cap.  jitter=0
        # keeps the externally driven retry_pending() loop deterministic.
        self._retry_policy = RetryPolicy(
            max_attempts=0,
            base_delay_s=min(1.0, retry_timeout_s),
            max_delay_s=retry_timeout_s,
            multiplier=2.0,
            jitter=0.0,
        )
        self._domain_backoff: dict[str, Backoff] = {}
        # Global republish parking: _controller.update() failures (API
        # trouble, partial reconciles) park the WHOLE publish, retried by
        # retry_pending(); the last good slices keep serving meanwhile.
        self._publish_backoff = Backoff(self._retry_policy)
        self._publish_retry_at: float | None = None
        self._clock = clock
        self._controller = ResourceSliceController(server, DRIVER_NAME, owner)
        self._watch = None
        # The informer's initial replay (every existing Node as ADDED, before
        # ``watch`` returns) publishes once at its end, not once an event.
        self._replaying = False
        self._replay_changed = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        # Reset domain state: across a stop/start leadership cycle the watch
        # replay re-derives it from current Nodes, and stale entries would
        # republish seats for nodes deleted while we were not leading.
        with self._lock:
            self._domains.clear()
            self._offsets.clear()
            self._retry.clear()
            self._domain_backoff.clear()
            self._publish_backoff.reset()
            self._publish_retry_at = None
            self._replaying, self._replay_changed = True, False
        try:
            self._watch = self._server.watch(Node.KIND, self._on_node_event)
        finally:
            with self._lock:
                self._replaying = False
                if self._replay_changed:
                    self._publish()

    def stop(self, delete_owned: bool = True) -> None:
        """``delete_owned=False`` for leadership hand-off: the new leader
        owns the same slices (shared owner label) and deleting them would
        wipe its freshly published state.  Full deletion (imex.go:298-316)
        is for process shutdown only."""
        if self._watch is not None:
            self._watch.stop()
        self._controller.stop(delete_owned=delete_owned)

    def retry_pending(self) -> None:
        """Re-attempt domains parked on transient errors whose backoff has
        elapsed (imex.go:131-151's RetryTimeout loop, driven externally for
        determinism), plus any whole-publish parked on API failure."""
        with self._lock:
            now = self._clock()
            due = [d for d, t in self._retry.items() if t <= now]
            for domain in due:
                del self._retry[domain]
            republish = (
                self._publish_retry_at is not None and self._publish_retry_at <= now
            )
            if due or republish:
                self._publish()

    # -- node informer (imex.go:207-295) -----------------------------------

    def _on_node_event(self, event) -> None:
        node = event.object
        domain = node.metadata.labels.get(SLICE_DOMAIN_LABEL)
        host_id = _parse_host_id(node.metadata.labels.get(SLICE_HOST_ID_LABEL))
        group = node.metadata.labels.get(SLICE_GROUP_LABEL)
        with self._lock:
            if event.type == "DELETED" or domain is None or host_id is None:
                # Malformed/missing host-id: the node cannot take a seat —
                # treat it as not part of any domain (and log) rather than
                # defaulting to 0, which would mint duplicate worker-0 seats.
                if domain is not None and host_id is None:
                    log.warning(
                        "node %s has domain %r but invalid %s label %r; ignoring",
                        node.metadata.name,
                        domain,
                        SLICE_HOST_ID_LABEL,
                        node.metadata.labels.get(SLICE_HOST_ID_LABEL),
                    )
                changed = self._forget_node(node.metadata.name)
            else:
                changed = self._remember_node(
                    domain, node.metadata.name, host_id, group
                )
            if changed and self._replaying:
                self._replay_changed = True
            elif changed:
                self._publish()

    def _remember_node(
        self, domain: str, node_name: str, host_id: int, group: str | None = None
    ) -> bool:
        # A node can move between domains (slice re-provisioned): drop any
        # old membership first.
        changed = self._forget_node(node_name, except_domain=domain)
        d = self._domains.setdefault(domain, _Domain())
        if d.nodes.get(node_name) != host_id:
            d.nodes[node_name] = host_id
            changed = True
        if d.groups.get(node_name) != group:
            if group is None:
                d.groups.pop(node_name, None)
            else:
                d.groups[node_name] = group
            changed = True
        return changed

    def _forget_node(self, node_name: str, except_domain: str | None = None) -> bool:
        changed = False
        for domain, d in list(self._domains.items()):
            if domain == except_domain:
                continue
            if node_name in d.nodes:
                del d.nodes[node_name]
                d.groups.pop(node_name, None)
                changed = True
                if not d.nodes:  # last node: domain gone (imex.go:233-277)
                    del self._domains[domain]
                    self._offsets.pop(domain, None)
                    self._retry.pop(domain, None)
                    self._domain_backoff.pop(domain, None)
        return changed

    # -- seat-window assignment (imex.go:319-351) ---------------------------

    def _assign_offset(self, domain: str, seats: int = 1) -> int:
        """Reserve enough 128-seat windows of the 2048-seat global budget to
        cover ``seats``.  The reference reserves exactly one channel window
        per IMEX domain (imex.go:319-351); TPU slice domains can exceed one
        window (>128 hosts), so the reservation scales with
        ceil(seats/128) — otherwise chunked publication would quietly bust
        the DRIVER_MEMBERSHIP_LIMIT the window accounting enforces."""
        needed = max(1, -(-seats // MEMBERSHIP_PER_SLICE_LIMIT))
        windows = self._offsets.get(domain, [])
        if len(windows) >= needed:
            if len(windows) > needed:
                # Shrink with the domain: a scaled-down domain must return
                # budget, or stranded reservations starve other domains.
                self._offsets[domain] = windows[:needed]
            return windows[0]
        used = {w for ws in self._offsets.values() for w in ws}
        free = [
            o
            for o in range(0, DRIVER_MEMBERSHIP_LIMIT, MEMBERSHIP_PER_SLICE_LIMIT)
            if o not in used
        ]
        grab = needed - len(windows)
        if len(free) < grab:
            raise TransientError(
                f"need {grab} more of {DRIVER_MEMBERSHIP_LIMIT // MEMBERSHIP_PER_SLICE_LIMIT} "
                f"membership windows ({len(free)} free); cannot admit domain "
                f"{domain!r} with {seats} seats"
            )
        self._offsets[domain] = windows + free[:grab]
        return self._offsets[domain][0]

    # -- pool publication (imex.go:371-416) ---------------------------------

    def _publish(self) -> None:
        pools: dict[str, Pool] = {}
        for domain, d in sorted(self._domains.items()):
            if domain in self._retry:
                continue
            host_count = len(d.nodes)
            coordinator = self._coordinator_address(d)
            worker_ids = sorted(set(d.nodes.values()))
            try:
                self._assign_offset(domain, seats=len(worker_ids))
            except TransientError:
                bo = self._domain_backoff.setdefault(
                    domain, Backoff(self._retry_policy)
                )
                self._retry[domain] = self._clock() + bo.next_delay()
                continue
            self._domain_backoff.pop(domain, None)  # admitted: reset its parking
            if len(worker_ids) != len(d.nodes):
                log.warning(
                    "domain %s: duplicate slice-host-id labels across nodes %s; "
                    "publishing one seat per distinct id",
                    domain,
                    sorted(d.nodes),
                )
            devices = [
                SliceMembershipInfo(
                    domain=domain,
                    worker_id=worker_id,
                    host_count=host_count,
                    coordinator_address=coordinator,
                ).get_device()
                for worker_id in worker_ids
            ]
            # ≤128 devices per Slice: the upstream API server rejects
            # larger ResourceSlices, which would park the whole pool (the
            # node driver applies the same split; reference
            # ResourceSliceImexChannelLimit=128, imex.go:43).
            chunks = [
                Slice(devices=devices[i : i + MEMBERSHIP_PER_SLICE_LIMIT])
                for i in range(0, len(devices), MEMBERSHIP_PER_SLICE_LIMIT)
            ] or [Slice(devices=[])]
            pools[f"slice-{domain}"] = Pool(
                slices=chunks,
                node_selector=NodeSelector(
                    node_selector_terms=[
                        NodeSelectorTerm(
                            match_expressions=[
                                NodeSelectorRequirement(
                                    key=SLICE_DOMAIN_LABEL, values=[domain]
                                )
                            ]
                        )
                    ]
                ),
            )
        self._publish_groups(pools)
        try:
            self._controller.update(DriverResources(pools=pools))
        except (APIError, OSError) as exc:
            # Partial/failed reconcile: the reconciler already applied what
            # it could; park a full republish (declarative spec replays
            # cleanly) instead of crashing the informer callback.
            self._publish_retry_at = self._clock() + self._publish_backoff.next_delay()
            JOURNAL.record(
                "slice-manager", "publish.fail",
                error=f"{type(exc).__name__}: {exc}",
                retry_at=self._publish_retry_at,
            )
            log.warning("slice publish failed, parked for retry: %s", exc)
        else:
            self._publish_backoff.reset()
            self._publish_retry_at = None

    def _publish_groups(self, pools: dict[str, Pool]) -> None:
        """Slice-GROUP seat pools: one pool per group of slice domains, one
        seat per member domain (ordinal = sorted-domain rank).  The seat
        carries the megascale fan-out and the cross-slice (DCN)
        coordinator — slice 0's intra-slice coordinator host.  The imex
        domain-pool pattern applied one level up (imex.go:371-416 →
        SURVEY.md §2.11.3's multislice frontier)."""
        from k8s_dra_driver_torch.plugin.deviceinfo import SliceGroupSeatInfo

        groups: dict[str, list[tuple[str, _Domain]]] = {}
        for domain, d in sorted(self._domains.items()):
            g = d.group()
            if g is None:
                continue
            conflicting = {x for x in d.groups.values() if x != g}
            if conflicting:
                log.warning(
                    "domain %s: conflicting %s labels %s; using worker-0's %r",
                    domain, SLICE_GROUP_LABEL,
                    sorted(conflicting | {g}), g,
                )
            groups.setdefault(g, []).append((domain, d))
        for g, members in sorted(groups.items()):
            num_slices = len(members)
            coordinator = self._group_coordinator(members)
            for slice_id, (domain, d) in enumerate(members):
                # Per-(group, domain) pool with one seat PER HOST and a
                # selector on BOTH labels: allocation can only hand a pod
                # a seat carrying its OWN slice's identity, and every pod
                # of the slice binds its own seat (the membership-seat
                # granularity, one level up).
                devices = [
                    SliceGroupSeatInfo(
                        group=g,
                        domain=domain,
                        slice_id=slice_id,
                        num_slices=num_slices,
                        worker_id=worker_id,
                        host_count=len(d.nodes),
                        coordinator_address=coordinator,
                    ).get_device()
                    for worker_id in sorted(set(d.nodes.values()))
                ]
                chunks = [
                    Slice(devices=devices[i : i + MEMBERSHIP_PER_SLICE_LIMIT])
                    for i in range(0, len(devices), MEMBERSHIP_PER_SLICE_LIMIT)
                ] or [Slice(devices=[])]
                pools[f"slicegroup-{g}-{domain}"] = Pool(
                    slices=chunks,
                    node_selector=NodeSelector(
                        node_selector_terms=[
                            NodeSelectorTerm(
                                match_expressions=[
                                    NodeSelectorRequirement(
                                        key=SLICE_GROUP_LABEL, values=[g]
                                    ),
                                    NodeSelectorRequirement(
                                        key=SLICE_DOMAIN_LABEL, values=[domain]
                                    ),
                                ]
                            )
                        ]
                    ),
                )

    def _group_coordinator(self, members: list[tuple[str, "_Domain"]]) -> str:
        """Slice 0's worker-0 node hosts the cross-slice coordinator."""
        _, d0 = members[0]
        return self._coordinator_address(d0)

    def _coordinator_address(self, d: _Domain) -> str:
        """Worker 0's node is the jax.distributed coordinator."""
        for node_name, host_id in sorted(d.nodes.items(), key=lambda kv: kv[1]):
            return f"{node_name}:{DEFAULT_COORDINATOR_PORT}"
        return ""

    # -- introspection ------------------------------------------------------

    def domains(self) -> dict[str, int]:
        with self._lock:
            return {domain: len(d.nodes) for domain, d in self._domains.items()}
