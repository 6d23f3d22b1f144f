"""The port of ``k8s_dra_driver_tpu/kube/resourceslice_controller.py`` (copied: the port imports
nothing of the JAX package).

Declarative ResourceSlice reconciler.

Behavioral re-provision of the vendored
``k8s.io/dynamic-resource-allocation/resourceslice`` controller
(resourceslicecontroller.go:102-227, SURVEY.md §2.5): the owner declares
``DriverResources{pools{slices{devices}}}`` and the controller makes the API
server match — creating, updating (with pool-generation bumps) and deleting
ResourceSlice objects it owns.  Used by both the kubelet plugin (one node-local
pool, driver.go:71-83) and the cluster controller (per-slice-domain pools,
imex.go:112-158).

Reconciliation is synchronous on :meth:`update` — simpler than the upstream
queue-based version and sufficient because our callers already debounce.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

from k8s_dra_driver_torch.kube import objects
from k8s_dra_driver_torch.kube.fakeserver import (
    AlreadyExists,
    APIError,
    Conflict,
    NotFound,
)
from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.metrics import REGISTRY
from k8s_dra_driver_torch.kube.objects import (
    Device,
    NodeSelector,
    ObjectMeta,
    ResourcePool,
    ResourceSlice,
    ResourceSliceSpec,
)

_SYNC_RETRIES = REGISTRY.counter(
    "dra_slice_sync_retries_total",
    "ResourceSlice writes retried after a 409 (re-get and reapply)",
)
_SYNC_ERRORS = REGISTRY.counter(
    "dra_slice_sync_errors_total",
    "ResourceSlice operations that failed a reconcile pass",
)

# Bounded re-get-and-retry per slice write: a 409 means a concurrent writer
# (or an injected fault) bumped the resourceVersion under us; replaying the
# PUT against a fresh read converges because our spec is declarative.
CONFLICT_RETRIES = 4


class SliceSyncError(APIError):
    """Partial reconcile summary: some slice operations failed, the rest of
    the pass completed.  Code 503 → retryable; the caller's next debounce
    (or parked retry) heals the remainder."""

    def __init__(self, failures: list[tuple[str, Exception]]):
        self.failures = failures
        name, exc = failures[0]
        super().__init__(
            503,
            f"{len(failures)} resourceslice op(s) failed; "
            f"first: {name}: {type(exc).__name__}: {exc}",
        )


@dataclass
class Slice:
    devices: list[Device] = field(default_factory=list)


@dataclass
class Pool:
    slices: list[Slice] = field(default_factory=list)
    node_name: str = ""
    node_selector: Optional[NodeSelector] = None
    all_nodes: Optional[bool] = None
    generation: int = 0


@dataclass
class DriverResources:
    pools: dict[str, Pool] = field(default_factory=dict)


class ResourceSliceController:
    def __init__(self, server, driver_name: str, owner_name: str):
        """owner_name disambiguates publishers (node name or controller id)."""
        self._server = server
        self._driver = driver_name
        self._owner = owner_name
        self._lock = threading.Lock()
        self._resources = DriverResources()

    def update(self, resources: DriverResources) -> None:
        with self._lock:
            self._resources = resources
            self._sync()

    def stop(self, delete_owned: bool = True) -> None:
        """On shutdown the IMEX manager deletes owned slices (imex.go:298-316)."""
        if delete_owned:
            with self._lock:
                self._resources = DriverResources()
                self._sync()

    # -- internals ---------------------------------------------------------

    def _slice_name(self, pool_name: str, index: int) -> str:
        return f"{self._driver}-{self._owner}-{pool_name}-{index}".replace("/", "-")

    def _owned(self) -> list[ResourceSlice]:
        return [
            s
            for s in self._server.list(ResourceSlice.KIND)
            if s.spec.driver == self._driver
            and s.metadata.labels.get("dra.tpu.google.com/owner") == self._owner
        ]

    def _sync(self) -> None:
        """One reconcile pass.  Per-slice failures are recorded and the pass
        CONTINUES (a single sick object must not park every other pool);
        at the end they surface as one retryable :class:`SliceSyncError`."""
        try:
            existing = {s.metadata.name: s for s in self._owned()}
        except (APIError, OSError) as exc:
            _SYNC_ERRORS.inc(op="list")
            raise SliceSyncError([("list", exc)]) from exc
        failures: list[tuple[str, Exception]] = []
        desired_names: set[str] = set()

        for pool_name, pool in self._resources.pools.items():
            # Generation is pool-scoped (DRA treats slices below the pool's
            # max observed generation as stale): compute the desired specs at
            # the pool's current generation, and if ANY slice of the pool
            # changed, bump and rewrite the WHOLE pool at generation+1.
            pool_existing = [
                s for s in existing.values() if s.spec.pool.name == pool_name
            ]
            current_gen = max(
                (s.spec.pool.generation for s in pool_existing), default=pool.generation
            )

            def build(i: int, sl: Slice, generation: int) -> ResourceSlice:
                name = self._slice_name(pool_name, i)
                return ResourceSlice(
                    metadata=ObjectMeta(
                        name=name,
                        labels={"dra.tpu.google.com/owner": self._owner},
                    ),
                    spec=ResourceSliceSpec(
                        driver=self._driver,
                        pool=ResourcePool(
                            name=pool_name,
                            generation=generation,
                            resource_slice_count=len(pool.slices),
                        ),
                        node_name=pool.node_name,
                        node_selector=pool.node_selector,
                        all_nodes=pool.all_nodes,
                        devices=sl.devices,
                    ),
                )

            want_now = [build(i, sl, current_gen) for i, sl in enumerate(pool.slices)]
            desired_names.update(w.metadata.name for w in want_now)
            changed = len(pool_existing) != len(want_now) or any(
                w.metadata.name not in existing
                or objects.to_json(existing[w.metadata.name].spec) != objects.to_json(w.spec)
                for w in want_now
            )
            if not changed:
                continue
            new_gen = current_gen + 1 if pool_existing else current_gen
            JOURNAL.record(
                "resourceslices", "pool.sync", correlation=pool_name,
                owner=self._owner, generation=new_gen, slices=len(pool.slices),
                devices=sum(len(sl.devices) for sl in pool.slices),
            )
            for i, sl in enumerate(pool.slices):
                want = build(i, sl, new_gen)
                try:
                    self._apply_slice(want, existing.get(want.metadata.name))
                except (APIError, OSError) as exc:
                    self._record_failure(failures, want.metadata.name, exc)

        for name in existing:
            if name not in desired_names:
                JOURNAL.record(
                    "resourceslices", "slice.delete", correlation=name,
                    owner=self._owner,
                )
                try:
                    self._server.delete(ResourceSlice.KIND, name)
                except NotFound:
                    pass  # already gone: the desired state
                except (APIError, OSError) as exc:
                    self._record_failure(failures, name, exc)
        if failures:
            JOURNAL.record(
                "resourceslices", "pool.sync_partial", correlation=self._owner,
                failed=len(failures),
                slices=[name for name, _ in failures],
            )
            raise SliceSyncError(failures)

    def _record_failure(
        self, failures: list, name: str, exc: Exception
    ) -> None:
        _SYNC_ERRORS.inc(op="apply")
        JOURNAL.record(
            "resourceslices", "slice.sync_fail", correlation=name,
            owner=self._owner, error=f"{type(exc).__name__}: {exc}",
        )
        failures.append((name, exc))

    def _apply_slice(self, want: ResourceSlice, current) -> None:
        """Write one desired slice, healing optimistic-concurrency races:
        on 409 re-get the live object and replay the spec onto its current
        resourceVersion (pool-generation bumps by a concurrent writer land
        in the re-read), bounded by CONFLICT_RETRIES."""
        name = want.metadata.name
        for attempt in range(CONFLICT_RETRIES + 1):
            try:
                if current is None:
                    self._server.create(want)
                else:
                    current.spec = want.spec
                    self._server.update(current)
                return
            except (Conflict, AlreadyExists) as exc:
                if attempt == CONFLICT_RETRIES:
                    raise
                _SYNC_RETRIES.inc()
                JOURNAL.record(
                    "resourceslices", "slice.conflict_retry", correlation=name,
                    attempt=attempt + 1, error=f"{type(exc).__name__}: {exc}",
                )
                try:
                    current = self._server.get(ResourceSlice.KIND, name)
                except NotFound:
                    current = None  # deleted under us: recreate
