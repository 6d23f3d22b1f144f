"""The port of ``k8s_dra_driver_tpu/scheduler/index.py`` (lines 1-427; copied: the port
imports nothing of the JAX package).

Versioned allocation index: the scheduler hot path's amortization layer.

``Allocator.plan()`` used to redo all of its work per allocation: re-list
every ResourceSlice, rebuild every ``_Candidate`` (discarding the
cached-property CEL env and marker frozensets), re-parse every capacity
quantity, and re-scan every ResourceClaim for the consumed set.  At N nodes
x M devices x K claims that is O(N*M + K) per decision — the exact
per-decision cost partition-aware placement work (ParvaGPU, Flex-MIG) shows
must be amortized across an indexed view of device state.

This module is that index.  Three caches, three invalidation keys:

* **pool snapshots** — per (driver, pool): the ``_Candidate`` list of the
  pool's highest generation, grouped per backing slice.  Invalidation key:
  the slice set's (name, resourceVersion) pairs; only pools whose slices
  changed are rebuilt, and unchanged slices inside a rebuilt pool keep
  their candidate objects (and therefore their parsed CEL envs, marker
  frozensets and selector-verdict memos) alive.
* **consumed set** — device keys + (pool, capacity) markers held by
  existing allocations, maintained from per-claim allocation deltas
  instead of a full claim scan.  Invalidation key: a claim's extracted
  result tuple (and any slice change, for marker resolution).
* **DeviceClass map** — by name, maintained from watch events.

Against the in-memory API server the index subscribes informer-style
watches (delivery is synchronous under the server lock, so the index is
never stale within the process).  Against any other client it falls back
to list-and-diff per snapshot: same correctness, still reusing candidates
whose slice resourceVersion is unchanged.

Cache effectiveness is exported through the metrics registry
(``dra_alloc_index_hits_total`` / ``dra_alloc_index_misses_total``) so
tools/perf_smoke.py can prove selector evaluations stay O(changed pools).
"""

from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass, field

from k8s_dra_driver_torch.kube.fakeserver import InMemoryAPIServer
from k8s_dra_driver_torch.kube.objects import DeviceClass, ResourceClaim, ResourceSlice
from k8s_dra_driver_torch.utils.metrics import REGISTRY

_INDEX_HITS = REGISTRY.counter(
    "dra_alloc_index_hits_total",
    "Pool snapshots served from the allocation index without a rebuild",
)
_INDEX_MISSES = REGISTRY.counter(
    "dra_alloc_index_misses_total",
    "Pool snapshots (re)built by the allocation index",
)


@dataclass(eq=False)  # identity semantics: groups live in per-node index lists
class _SliceGroup:
    """Candidates of ONE backing ResourceSlice, plus its node scoping."""

    name: str
    resource_version: str
    node_name: str
    node_selector: object
    candidates: list
    marker_union: frozenset


@dataclass
class _PoolSnapshot:
    generation: int
    groups: list[_SliceGroup] = field(default_factory=list)


@dataclass
class PlanView:
    """Everything one ``plan()`` call needs, read under a single lock."""

    candidates: list
    node_markers: frozenset  # union of visible candidates' chip markers
    in_use: set
    used_markers: set
    classes: dict


class AllocationIndex:
    def __init__(self, server, live: bool | None = None):
        self._server = server
        self._lock = threading.RLock()
        self._slices: dict[str, object] = {}  # slice name -> ResourceSlice
        self._slice_pool: dict[str, tuple[str, str]] = {}  # name -> (driver, pool)
        self._pools: dict[tuple[str, str], _PoolSnapshot] = {}
        self._dirty_pools: set[tuple[str, str]] = set()
        self._classes: dict[str, object] = {}
        # Node-scoped group indexes: snapshot(node) walks only the groups
        # that can possibly be visible to that node, not every pool in the
        # cluster — at 10k pools the all-pools walk IS the plan() cost.
        self._node_groups: dict[str, list] = {}  # node_name -> [_SliceGroup]
        self._global_groups: list = []  # all-nodes / node-selector groups
        # claim uid -> tuple of consuming (driver, pool, device) result keys
        self._claim_alloc: dict[str, tuple] = {}
        self._consumed_dirty = True
        self._in_use: set = set()
        self._used_markers: set = set()
        # Refcounts behind the consumed sets: several claims may pin the
        # same device key or chip marker transiently (unwind races), so
        # set-removal on delta must only fire when the LAST holder leaves.
        self._in_use_refs: dict = {}
        self._marker_refs: dict = {}
        self._device_index: dict | None = None
        self._watches: list = []
        # Live (event-driven) mode requires synchronous in-process watch
        # delivery; any other client gets list-and-diff refresh per plan.
        # ``live=True`` opts a watch-capable client (e.g. RESTClient, whose
        # reflector relists through 410s/ERROR frames) into event-driven
        # mode — the chaos suite uses this to prove index convergence
        # across watch outages.
        self._live = isinstance(server, InMemoryAPIServer) if live is None else live
        if self._live:
            self._watches = [
                server.watch(ResourceSlice.KIND, self._on_slice),
                server.watch(ResourceClaim.KIND, self._on_claim),
                server.watch(DeviceClass.KIND, self._on_class),
            ]

    def close(self) -> None:
        for w in self._watches:
            w.stop()
        self._watches = []

    # -- plan-time read ------------------------------------------------------

    def snapshot(self, node_name: str, node_labels: dict[str, str]) -> PlanView:
        with self._lock:
            if not self._live:
                self._refresh_from_lists()
            for key in self._dirty_pools:
                self._rebuild_pool(key)
            self._dirty_pools.clear()
            candidates: list = []
            markers: set = set()
            # Only this node's own groups plus the cluster-global ones are
            # consulted — pools pinned to OTHER nodes never enter the walk.
            for g in self._node_groups.get(node_name, ()):
                if g.node_selector is not None and not g.node_selector.matches(
                    node_labels
                ):
                    continue
                _INDEX_HITS.inc()
                candidates.extend(g.candidates)
                markers |= g.marker_union
            for g in self._global_groups:
                if g.node_selector is not None and not g.node_selector.matches(
                    node_labels
                ):
                    continue
                _INDEX_HITS.inc()
                candidates.extend(g.candidates)
                markers |= g.marker_union
            if self._consumed_dirty:
                self._rebuild_consumed()
            return PlanView(
                candidates=candidates,
                node_markers=frozenset(markers),
                in_use=set(self._in_use),
                used_markers=set(self._used_markers),
                classes=dict(self._classes),
            )

    # -- watch-event maintenance (live mode) ---------------------------------

    def _on_slice(self, event) -> None:
        s = event.object
        name = s.metadata.name
        pool_key = (s.spec.driver, s.spec.pool.name)
        with self._lock:
            old_key = self._slice_pool.get(name)
            if event.type == "DELETED":
                self._slices.pop(name, None)
                self._slice_pool.pop(name, None)
            else:
                self._slices[name] = s
                self._slice_pool[name] = pool_key
            if old_key is not None and old_key != pool_key:
                self._dirty_pools.add(old_key)
            self._dirty_pools.add(pool_key)
            self._consumed_dirty = True  # marker resolution may change
            self._device_index = None

    def _on_claim(self, event) -> None:
        c = event.object
        uid = c.metadata.uid
        with self._lock:
            if event.type == "DELETED":
                old = self._claim_alloc.pop(uid, None)
                if old:
                    self._consumed_delta(old, ())
                return
            self._apply_claim(uid, c)

    def _on_class(self, event) -> None:
        dc = event.object
        with self._lock:
            if event.type == "DELETED":
                self._classes.pop(dc.metadata.name, None)
            else:
                self._classes[dc.metadata.name] = dc

    def _apply_claim(self, uid: str, claim) -> None:
        alloc = claim.status.allocation
        results: tuple = ()
        if alloc is not None:
            results = tuple(
                (r.driver, r.pool, r.device)
                for r in alloc.devices.results
                if not r.admin_access  # admin access observes, never consumes
            )
        old = self._claim_alloc.get(uid)
        if results:
            if old != results:
                self._claim_alloc[uid] = results
                self._consumed_delta(old or (), results)
        elif old is not None:
            del self._claim_alloc[uid]
            self._consumed_delta(old, ())

    def _consumed_delta(self, old: tuple, new: tuple) -> None:
        """Apply one claim's allocation change to the consumed sets
        incrementally.  Falls back to marking dirty (full rebuild at next
        snapshot) when a rebuild is already pending or the device index is
        invalidated — deltas against stale refcounts would corrupt them."""
        if self._consumed_dirty or self._device_index is None:
            self._consumed_dirty = True
            return
        for key in old:
            if key not in new:
                self._consumed_ref(key, -1)
        for key in new:
            if key not in old:
                self._consumed_ref(key, +1)

    def _consumed_ref(self, key: tuple, step: int) -> None:
        n = self._in_use_refs.get(key, 0) + step
        if n <= 0:
            self._in_use_refs.pop(key, None)
            self._in_use.discard(key)
        else:
            self._in_use_refs[key] = n
            self._in_use.add(key)
        dev = self._device_index.get(key)
        if dev is None:
            # Allocation names a device we can't resolve (slice churn racing
            # the claim event) — punt to the full rebuild.
            self._consumed_dirty = True
            return
        pool = key[1]
        for cap in dev.basic.capacity:
            if not cap.startswith("chip"):
                continue  # hbm etc. is shared capacity, not an exclusion marker
            m = (pool, cap)
            c = self._marker_refs.get(m, 0) + step
            if c <= 0:
                self._marker_refs.pop(m, None)
                self._used_markers.discard(m)
            else:
                self._marker_refs[m] = c
                self._used_markers.add(m)

    # -- list-and-diff refresh (fallback mode) -------------------------------

    def _refresh_from_lists(self) -> None:
        seen: set[str] = set()
        for s in self._server.list(ResourceSlice.KIND):
            name = s.metadata.name
            seen.add(name)
            prev = self._slices.get(name)
            if (
                prev is not None
                and prev.metadata.resource_version == s.metadata.resource_version
            ):
                continue
            self._on_slice_sync(name, s)
        for name in list(self._slices):
            if name not in seen:
                self._on_slice_sync(name, None)
        claim_uids: set[str] = set()
        for c in self._server.list(ResourceClaim.KIND):
            claim_uids.add(c.metadata.uid)
            self._apply_claim(c.metadata.uid, c)
        for uid in list(self._claim_alloc):
            if uid not in claim_uids:
                old = self._claim_alloc.pop(uid)
                self._consumed_delta(old, ())
        self._classes = {
            dc.metadata.name: dc for dc in self._server.list(DeviceClass.KIND)
        }

    def _on_slice_sync(self, name: str, s) -> None:
        old_key = self._slice_pool.get(name)
        if s is None:
            self._slices.pop(name, None)
            self._slice_pool.pop(name, None)
        else:
            pool_key = (s.spec.driver, s.spec.pool.name)
            self._slices[name] = s
            self._slice_pool[name] = pool_key
            self._dirty_pools.add(pool_key)
        if old_key is not None:
            self._dirty_pools.add(old_key)
        self._consumed_dirty = True
        self._device_index = None

    # -- internals -----------------------------------------------------------

    def _rebuild_pool(self, key: tuple[str, str]) -> None:
        # Import here, not at module top: allocator.py owns _Candidate and
        # imports this module — the one-way dependency keeps both importable.
        from k8s_dra_driver_torch.scheduler.allocator import _Candidate

        _INDEX_MISSES.inc()
        old = self._pools.get(key)
        old_groups = {g.name: g for g in old.groups} if old else {}
        if old:
            for g in old.groups:
                self._index_remove(g)
        slices = [
            self._slices[n] for n, pk in self._slice_pool.items() if pk == key
        ]
        if not slices:
            self._pools.pop(key, None)
            return
        # Per (driver, pool) only the highest generation is visible.
        gen = max(s.spec.pool.generation for s in slices)
        groups: list[_SliceGroup] = []
        for s in sorted(slices, key=lambda s: s.metadata.name):
            if s.spec.pool.generation != gen:
                continue
            prev = old_groups.get(s.metadata.name)
            if (
                prev is not None
                and prev.resource_version == s.metadata.resource_version
            ):
                groups.append(prev)  # candidates + CEL memos survive
                continue
            cands = [
                _Candidate(driver=s.spec.driver, pool=s.spec.pool.name, device=d)
                for d in s.spec.devices
            ]
            union: frozenset = frozenset()
            for c in cands:
                union |= c.markers
            groups.append(
                _SliceGroup(
                    name=s.metadata.name,
                    resource_version=s.metadata.resource_version,
                    node_name=s.spec.node_name,
                    node_selector=s.spec.node_selector,
                    candidates=cands,
                    marker_union=union,
                )
            )
        for g in groups:
            self._index_add(g)
        self._pools[key] = _PoolSnapshot(generation=gen, groups=groups)

    def _index_add(self, g: _SliceGroup) -> None:
        if g.node_name:
            self._node_groups.setdefault(g.node_name, []).append(g)
        else:
            self._global_groups.append(g)

    def _index_remove(self, g: _SliceGroup) -> None:
        if g.node_name:
            bucket = self._node_groups.get(g.node_name)
            if bucket is None:
                return
            try:
                bucket.remove(g)  # identity match: _SliceGroup is eq=False
            except ValueError:
                pass
            if not bucket:
                del self._node_groups[g.node_name]
        else:
            try:
                self._global_groups.remove(g)
            except ValueError:
                pass

    def _rebuild_consumed(self) -> None:
        if self._device_index is None:
            self._device_index = {
                (s.spec.driver, s.spec.pool.name, d.name): d
                for s in self._slices.values()
                for d in s.spec.devices
            }
        in_use_refs: dict = {}
        marker_refs: dict = {}
        for results in self._claim_alloc.values():
            for driver, pool, device in results:
                key = (driver, pool, device)
                in_use_refs[key] = in_use_refs.get(key, 0) + 1
                dev = self._device_index.get(key)
                if dev is not None:
                    for cap in dev.basic.capacity:
                        # Only chip markers are exclusion state; shared caps
                        # like hbm would mark EVERY device in the pool used.
                        if cap.startswith("chip"):
                            m = (pool, cap)
                            marker_refs[m] = marker_refs.get(m, 0) + 1
        self._in_use_refs = in_use_refs
        self._marker_refs = marker_refs
        self._in_use = set(in_use_refs)
        self._used_markers = set(marker_refs)
        self._consumed_dirty = False


def stable_shard(name: str, n_shards: int) -> int:
    """Deterministic shard id for per-scheduler pool sharding.

    The contention harness partitions both pools (nodes) and work items
    across N racing schedulers: scheduler ``i`` prefers names where
    ``stable_shard(name, N) == i`` and spills over to the rest only when
    its shard can't satisfy.  CRC32 rather than ``hash()`` because Python
    string hashing is salted per process — shards must agree across
    schedulers, runs and (future) subprocess workers."""
    if n_shards <= 1:
        return 0
    return zlib.crc32(name.encode("utf-8")) % n_shards
