"""The port of ``k8s_dra_driver_tpu/scheduler/allocator.py`` (lines 1-749; copied: the port
imports nothing of the JAX package).

Structured-parameter allocator — the kube-scheduler's DRA half.

Allocation happens OUTSIDE the reference repo (SURVEY.md §3.5): the upstream
scheduler reads published ResourceSlices, evaluates DeviceClass + per-request
CEL selectors, honors ``matchAttribute`` constraints and capacity non-overlap,
and writes ``claim.Status.Allocation``.  This module re-implements those
semantics so the repo is a *closed loop* — unit/integration tests, the demo
harness and the bench can schedule claims with no cluster.  It also documents
exactly what geometry encoding the driver relies on:

* device filtering: ``device.driver`` must match the DeviceClass driver
  implied by its selectors; every CEL selector must evaluate true (an
  erroring expression is a non-match, CEL-in-k8s semantics);
* per-pool only the highest observed generation is visible;
* a device may be allocated to at most one claim;
* **counter non-overlap**: within one pool, two allocated devices may never
  both carry the same capacity-marker name (``chip%d`` — geometry.py).  This
  is the scheduler-side contract that makes overlapping ICI subslices
  mutually exclusive, the TPU analog of MIG ``memorySlice%d`` capacities;
* ``matchAttribute`` constraints across requests (gpu-test4.yaml:43-45's
  ``parentUUID`` pattern → our ``hostId``/``sliceDomain``);
* allocation is all-or-nothing per claim, via backtracking search.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional

from k8s_dra_driver_torch.kube.fakeserver import InMemoryAPIServer
from k8s_dra_driver_torch.kube.objects import (
    AllocationResult,
    Device,
    DeviceAllocationConfiguration,
    DeviceAllocationResult,
    DeviceRequestAllocationResult,
    NodeSelector,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    ResourceClaim,
    ResourceClaimConsumerReference,
)
from k8s_dra_driver_torch.scheduler import cel
from k8s_dra_driver_torch.scheduler.index import AllocationIndex
from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.metrics import REGISTRY

_CEL_MEMO_HITS = REGISTRY.counter(
    "dra_cel_memo_hits_total",
    "Selector verdicts served from the per-candidate memo",
)
_CEL_MEMO_MISSES = REGISTRY.counter(
    "dra_cel_memo_misses_total",
    "Selector verdicts computed and stored in the per-candidate memo",
)
_CEL_EVALS = REGISTRY.counter(
    "dra_cel_evals_total",
    "CEL selector expressions actually evaluated against a device",
)
_GANG_PLANS = REGISTRY.counter(
    "dra_gang_plans_total",
    "Gang allocation attempts, by outcome "
    "(planned | infeasible | committed | unwound)",
)


class AllocationError(Exception):
    pass


class GangConflictError(AllocationError):
    """A gang commit lost an optimistic-concurrency race mid-flight: some
    member's status write failed (stale resourceVersion, injected 409, an
    admission validator rejecting a double-booked device) after zero or
    more siblings had already committed.  The already-committed siblings
    were unwound in reverse order before this was raised, so the store is
    balanced and the whole gang is safe to retry from a fresh refetch.

    ``unwound`` carries the claim names rolled back (commit order), so
    callers can account for the wasted work without string-matching the
    message."""

    def __init__(self, message: str, unwound: tuple[str, ...] = ()):
        super().__init__(message)
        self.unwound = tuple(unwound)


@dataclass(frozen=True)
class _Candidate:
    driver: str
    pool: str
    device: Device
    # Selector-verdict memo, keyed by CEL expression source.  The candidate
    # object itself is the other half of the memo key: the allocation index
    # rebuilds candidates whenever their slice's resourceVersion (and hence
    # pool generation) changes, so an entry is implicitly scoped to
    # (expression, device, inventory version) and never goes stale.
    verdicts: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def key(self) -> tuple[str, str, str]:
        return (self.driver, self.pool, self.device.name)

    @functools.cached_property
    def env(self) -> dict:
        """CEL env cached per candidate: capacities parse once, not per
        (request, selector) evaluation on the allocation hot path."""
        return _device_env(self)

    @functools.cached_property
    def markers(self) -> frozenset:
        """This device's (pool, chip-marker) overlap set (geometry.py)."""
        return frozenset(
            (self.pool, cap)
            for cap in self.device.basic.capacity
            if cap.startswith("chip")
        )


def _device_env(c: _Candidate) -> dict:
    """CEL environment for one device, mirroring k8s DRA's `device` variable:
    attributes/capacity are maps keyed by qualified name then attribute.
    Capacities are parsed to integer base units so they compare against
    ``quantity('16Gi')`` (k8s CEL's quantity semantics)."""
    from k8s_dra_driver_torch.kube import quantity as q

    attrs = cel.AttrBag()
    caps = cel.AttrBag()
    for name, attr in c.device.basic.attributes.items():
        attrs[name] = attr.value
    for name, qty in c.device.basic.capacity.items():
        try:
            caps[name] = q.parse(qty)
        except q.InvalidQuantity:
            caps[name] = qty
    return {
        "device": cel.AttrBag(
            driver=c.driver,
            attributes=cel.AttrBag({c.driver: attrs}),
            capacity=cel.AttrBag({c.driver: caps}),
        )
    }


def _matches_selectors(c: _Candidate, selectors) -> bool:
    for sel in selectors or []:
        if sel.cel is None:
            continue
        expr = sel.cel.expression
        verdict = c.verdicts.get(expr)
        if verdict is None:
            _CEL_MEMO_MISSES.inc()
            _CEL_EVALS.inc()
            try:
                verdict = cel.evaluate(expr, c.env) is True
            except cel.CELError:
                verdict = False  # erroring selector == non-match
            c.verdicts[expr] = verdict
        else:
            _CEL_MEMO_HITS.inc()
        if not verdict:
            return False
    return True


def _qualified_attr(c: _Candidate, qualified_name: str):
    """Resolve a matchAttribute name like 'tpu.google.com/hostId'."""
    if "/" in qualified_name:
        domain, name = qualified_name.rsplit("/", 1)
        if domain != c.driver:
            return None
    else:
        name = qualified_name
    attr = c.device.basic.attributes.get(name)
    return None if attr is None else attr.value


@dataclass(frozen=True)
class Plan:
    """A committed-to-nothing allocation: what `Allocator.plan` chose.

    chosen: ``[(request_name, candidate)]`` for consuming requests;
    admin_results: observer (adminAccess) results placed outside the search;
    free: the node's unallocated candidates at plan time (for scoring);
    classes: DeviceClass index (reused by `allocate` for config gathering).
    """

    chosen: list
    admin_results: list
    free: list
    classes: dict
    used_markers: frozenset
    # Union of the node's visible candidates' markers, precomputed by the
    # allocation index from per-slice marker unions.  Equivalent to the
    # union over ``free``: an allocated device's markers are all in
    # ``used_markers`` (the consumed set records every chip marker of every
    # allocated device), so the difference washes out in tightness().
    node_markers: frozenset = frozenset()

    def tightness(self) -> float:
        """Bin-packing score in [0, 1]: fraction of the node's AVAILABLE
        chip markers this plan consumes (available = markers of free
        devices minus markers other allocations already hold — an
        overlapping subslice device keeps its blocked chips out of the
        denominator).  Higher = tighter fit — a MostAllocated-style signal
        that steers small claims onto already-fragmented nodes so intact
        geometry survives for whole-subslice claims (the same policy
        `_search` applies WITHIN a node, lifted to cross-node choice for
        the extender's prioritize)."""
        if self.node_markers:
            available = set(self.node_markers)
        else:
            # Hand-built Plans (tests, older callers) may not carry the
            # precomputed union; fall back to scanning free candidates.
            available = set()
            for c in self.free:
                available.update(c.markers)  # (pool, marker) pairs
        available -= self.used_markers
        used: set = set()
        for _, c in self.chosen:
            used.update(c.markers)
        if not available:
            return 0.0
        return len(used & available) / len(available)


@dataclass(frozen=True)
class GangMember:
    """One node-claim of a multi-host gang: this claim must land on this
    node, together with every sibling, or not at all."""

    claim: ResourceClaim
    node_name: str
    node_labels: Optional[dict] = None


class Allocator:
    """Allocates pending ResourceClaims against published ResourceSlices.

    Device visibility, the consumed set and the DeviceClass map are read
    through an :class:`AllocationIndex` (scheduler/index.py): plan() cost
    scales with the number of *changed* pools since the last plan, not with
    the total inventory or the number of existing claims.
    """

    # Bound on unwind retries per claim when a gang rolls back under an
    # API fault storm: enough attempts that any limited/sub-certain fault
    # budget converges, small enough that a permanently broken server
    # fails loudly instead of spinning.
    GANG_UNWIND_ATTEMPTS = 100

    def __init__(
        self,
        server: InMemoryAPIServer,
        index: Optional[AllocationIndex] = None,
    ):
        self._server = server
        # N racing schedulers against one in-process store may share one
        # watch-maintained index (each keeps its own Allocator for journal
        # correlation and gang sequencing): in-process watches are delivered
        # synchronously under the store lock, so a private index would be
        # exactly as fresh — the real staleness window is plan()-to-commit
        # in both designs — while costing an extra full inventory replay
        # per scheduler.  The contention harness passes a shared index; a
        # caller-owned index is never closed by this allocator.
        self._index = index if index is not None else AllocationIndex(server)
        self._owns_index = index is None
        self._gang_seq = 0

    def close(self) -> None:
        """Detach the allocation index's watches (long-lived processes that
        create throwaway Allocators against one server should call this).
        A shared index passed into ``__init__`` stays attached — whoever
        built it closes it."""
        if self._owns_index:
            self._index.close()

    def view(self, node_name: str = "", node_labels: Optional[dict] = None):
        """One node's indexed :class:`~k8s_dra_driver_torch.scheduler.index.PlanView`
        without running a search — the cluster simulator's fragmentation
        probe and debug surfaces read occupancy through this instead of
        groping the private index."""
        labels = dict(node_labels or {})
        labels.setdefault("kubernetes.io/hostname", node_name)
        return self._index.snapshot(node_name, labels)

    # -- public ------------------------------------------------------------

    def allocate(
        self,
        claim: ResourceClaim,
        node_name: str = "",
        node_labels: Optional[dict[str, str]] = None,
    ) -> ResourceClaim:
        """Allocate ``claim`` for a pod placed on ``node_name``.

        Writes ``status.allocation`` back through the API server and returns
        the updated claim.  Raises AllocationError when the claim cannot be
        satisfied on this node.
        """
        if claim.status.allocation is not None:
            return claim  # already allocated (idempotent)
        try:
            p = self.plan(claim, node_name, node_labels)
        except AllocationError as exc:
            JOURNAL.record_lazy(
                "allocator", "allocate.fail", correlation=claim.metadata.uid,
                attrs=lambda: dict(
                    claim=claim.metadata.name, node=node_name, error=str(exc),
                ),
            )
            raise
        return self._commit_plan(claim, node_name, p)

    def _commit_plan(self, claim: ResourceClaim, node_name: str, p: "Plan") -> ResourceClaim:
        """Write one planned allocation through the API server.  On update
        failure the in-memory claim's allocation is reset to None before
        re-raising: faults fire BEFORE the store mutates (utils/faults.py),
        so the store still has no allocation — a retry path that kept the
        local copy's allocation would trip allocate()'s idempotent
        early-return and silently never persist."""
        results = [
            DeviceRequestAllocationResult(
                request=req_name, driver=c.driver, pool=c.pool, device=c.device.name
            )
            for req_name, c in p.chosen
        ] + p.admin_results
        config = self._gather_config(claim, claim.spec.devices.requests, p.classes)
        claim.status.allocation = AllocationResult(
            devices=DeviceAllocationResult(results=results, config=config),
            node_selector=NodeSelector(
                node_selector_terms=[
                    NodeSelectorTerm(
                        match_expressions=[
                            NodeSelectorRequirement(
                                key="kubernetes.io/hostname", values=[node_name]
                            )
                        ]
                    )
                ]
            )
            if node_name
            else None,
        )
        JOURNAL.record_lazy(
            "allocator", "allocate.ok", correlation=claim.metadata.uid,
            attrs=lambda: dict(
                claim=claim.metadata.name, node=node_name,
                devices=[r.device for r in results],
            ),
        )
        try:
            return self._server.update(claim)
        except Exception:
            claim.status.allocation = None
            raise

    def plan(
        self,
        claim: ResourceClaim,
        node_name: str = "",
        node_labels: Optional[dict[str, str]] = None,
        exclude_devices: frozenset = frozenset(),
        extra_markers: frozenset = frozenset(),
    ) -> "Plan":
        """Dry-run feasibility: the FULL allocation search for ``claim`` on
        ``node_name`` — selectors, markers, constraints, backtracking —
        with no write-back.  Raises AllocationError when unsatisfiable.

        ``exclude_devices``/``extra_markers`` thread the chosen devices and
        markers of EARLIER plans into this search, so a multi-claim pod is
        planned jointly (claims planned in isolation would each grab the
        same last chip and pass a node the pod can never bind to).

        This is the scheduler-extender primitive (SURVEY.md §3.5: geometry
        must be CEL/capacity-expressible *unless we also ship a scheduler
        extender*): `filter` calls it per node, `prioritize` scores its
        result, `allocate` commits it.
        """
        node_labels = dict(node_labels or {})
        node_labels.setdefault("kubernetes.io/hostname", node_name)

        # One locked read against the allocation index: visible candidates
        # (cached per pool generation / slice resourceVersion), the
        # incrementally-maintained consumed set, and the DeviceClass map.
        view = self._index.snapshot(node_name, node_labels)
        candidates = view.candidates
        in_use = view.in_use
        used_markers = view.used_markers
        in_use |= set(exclude_devices)
        used_markers |= set(extra_markers)

        free = [c for c in candidates if c.key not in in_use]

        requests = claim.spec.devices.requests
        if not requests:
            raise AllocationError("claim has no device requests")

        classes = view.classes

        per_request: list[tuple[str, int, list[_Candidate]]] = []
        admin_results: list[DeviceRequestAllocationResult] = []
        for req in requests:
            dc = classes.get(req.device_class_name)
            if dc is None:
                raise AllocationError(f"unknown DeviceClass {req.device_class_name!r}")
            # adminAccess requests (monitoring/diagnostics) see devices
            # REGARDLESS of allocation and consume nothing — upstream DRA
            # semantics for the admin-access feature gate.
            pool = candidates if req.admin_access else free
            matching = [
                c
                for c in pool
                if _matches_selectors(c, dc.spec.selectors)
                and _matches_selectors(c, req.selectors)
            ]
            if req.admin_access:
                count = len(matching) if req.allocation_mode == "All" else (req.count or 1)
                if len(matching) < count or count == 0:
                    # zero-match 'All' is a misconfiguration, same as the
                    # normal path — silence would mask it exactly where
                    # diagnostics claims need loudness.
                    raise AllocationError(
                        f"admin request {req.name!r}: {len(matching)} device(s) match, "
                        f"need {max(count, 1)}"
                    )
                admin_results.extend(
                    DeviceRequestAllocationResult(
                        request=req.name, driver=c.driver, pool=c.pool,
                        device=c.device.name, admin_access=True,
                    )
                    for c in matching[:count]
                )
                continue
            if req.allocation_mode == "All":
                count = len(matching)
                if count == 0:
                    raise AllocationError(f"request {req.name!r}: no devices match")
            else:
                count = req.count or 1
            per_request.append((req.name, count, matching))

        # Constraint scoping vs adminAccess: observers are placed outside the
        # backtracking search, so explicitly constraining one is unsupported
        # (loudly); a default-all constraint scopes to the consuming requests.
        admin_names = {r.name for r in requests if r.admin_access}
        constraints = []
        for con in claim.spec.devices.constraints:
            if not con.match_attribute:
                continue
            if con.requests and set(con.requests) & admin_names:
                raise AllocationError(
                    f"matchAttribute constraint over adminAccess request(s) "
                    f"{sorted(set(con.requests) & admin_names)} is not supported"
                )
            scope = set(con.requests or [r.name for r in requests]) - admin_names
            constraints.append((scope, con.match_attribute))

        chosen = self._search(per_request, constraints, used_markers, free)
        if chosen is None:
            raise AllocationError(
                f"claim {claim.metadata.name!r}: cannot satisfy "
                f"{[(name, count) for name, count, _ in per_request]} on node {node_name!r}"
            )
        return Plan(
            chosen=chosen,
            admin_results=admin_results,
            free=free,
            classes=classes,
            used_markers=frozenset(used_markers),
            node_markers=view.node_markers,
        )

    # -- gang allocation (multi-host slices, all-or-nothing) ----------------

    def plan_gang(self, members: list) -> list:
        """Plan a multi-host gang JOINTLY: each :class:`GangMember`'s claim
        is planned on its node with every EARLIER member's chosen devices
        and markers excluded (the `_joint_plans` discipline lifted across
        nodes — device keys and markers are pool-scoped, so the union is
        safe cross-node).  Returns ``[(member, Plan)]`` in member order, or
        raises AllocationError if ANY member is infeasible — nothing was
        committed, so there is nothing to undo (Flex-MIG's gang-execution
        framing: the slice runs whole or not at all)."""
        if not members:
            raise AllocationError("empty gang")
        plans: list = []
        taken_keys: set = set()
        taken_markers: set = set()
        for m in members:
            try:
                p = self.plan(
                    m.claim,
                    node_name=m.node_name,
                    node_labels=m.node_labels,
                    exclude_devices=frozenset(taken_keys),
                    extra_markers=frozenset(taken_markers),
                )
            except AllocationError:
                _GANG_PLANS.inc(outcome="infeasible")
                raise
            for _, c in p.chosen:
                taken_keys.add(c.key)
                taken_markers.update(c.markers)
            plans.append((m, p))
        _GANG_PLANS.inc(outcome="planned")
        return plans

    def allocate_gang(self, members: list) -> list:
        """Commit a gang atomically: plan every member first (a single
        infeasible member aborts before ANY write), then commit member by
        member; a failed commit unwinds every already-committed sibling in
        reverse before raising.  Returns the updated claims in member
        order.  One journal correlation (``gang-<n>``) spans the whole
        attempt — begin, every commit, any unwind."""
        self._gang_seq += 1
        corr = f"gang-{self._gang_seq}"
        plans = self.plan_gang(members)  # raises (and counts) if infeasible
        JOURNAL.record_lazy(
            "allocator", "gang.begin", correlation=corr,
            attrs=lambda: dict(
                members=[
                    (m.claim.metadata.name, m.node_name) for m, _ in plans
                ],
            ),
        )
        committed: list = []
        out: list = []
        for m, p in plans:
            try:
                updated = self._commit_plan(m.claim, m.node_name, p)
            except Exception as exc:  # noqa: BLE001 - any failed write unwinds
                JOURNAL.record(
                    "allocator", "gang.commit_failed", correlation=corr,
                    claim=m.claim.metadata.name, node=m.node_name,
                    error=f"{type(exc).__name__}: {exc}",
                )
                unwound_names = tuple(c.metadata.name for c in committed)
                self._unwind_gang(corr, committed)
                _GANG_PLANS.inc(outcome="unwound")
                raise GangConflictError(
                    f"gang commit failed at {m.claim.metadata.name!r} on "
                    f"{m.node_name!r} ({type(exc).__name__}: {exc}); "
                    f"{len(committed)} sibling(s) unwound",
                    unwound=unwound_names,
                ) from exc
            committed.append(updated)
            out.append(updated)
        _GANG_PLANS.inc(outcome="committed")
        JOURNAL.record(
            "allocator", "gang.committed", correlation=corr,
            members=len(out),
        )
        return out

    def _unwind_gang(self, corr: str, committed: list) -> None:
        """Roll back committed gang members in reverse, retrying each
        deallocation under whatever fault storm broke the commit.  Every
        attempt REFETCHES the claim: the store deep-copies on update, so
        retrying with the stale in-memory object after an injected
        conflict would fight resourceVersions forever."""
        for claim in reversed(committed):
            name = claim.metadata.name
            namespace = claim.metadata.namespace
            last: Exception | None = None
            for _ in range(self.GANG_UNWIND_ATTEMPTS):
                try:
                    current = self._server.get(ResourceClaim.KIND, name, namespace)
                    if current.status.allocation is None:
                        last = None
                        break
                    self.deallocate(current)
                    last = None
                    break
                except Exception as exc:  # noqa: BLE001 - retry under storm
                    last = exc
            if last is not None:
                # Leaked reservation: loud, journaled, never silent.
                JOURNAL.record(
                    "allocator", "gang.unwind_leak", correlation=corr,
                    claim=name,
                    error=f"{type(last).__name__}: {last}",
                )
                raise AllocationError(
                    f"gang unwind could not deallocate {name!r} after "
                    f"{self.GANG_UNWIND_ATTEMPTS} attempts: {last}"
                ) from last
            JOURNAL.record(
                "allocator", "gang.unwound", correlation=corr, claim=name,
            )

    def deallocate(self, claim: ResourceClaim) -> ResourceClaim:
        if claim.status.reserved_for:
            raise AllocationError(
                f"claim {claim.metadata.name!r} still reserved by "
                f"{[r.name for r in claim.status.reserved_for]}"
            )
        claim.status.allocation = None
        JOURNAL.record(
            "allocator", "deallocate", correlation=claim.metadata.uid,
            claim=claim.metadata.name,
        )
        return self._server.update(claim)

    # -- consumer reservation (resource-claim controller semantics) --------

    RESERVED_FOR_LIMIT = 32  # upstream ResourceClaimReservedForMaxSize

    def reserve(self, claim: ResourceClaim, pod_name: str, pod_uid: str) -> ResourceClaim:
        """Record a pod as consumer (claim.status.reservedFor); shared claims
        (gpu-test3 pattern) carry every consuming pod, capped at 32."""
        if any(r.uid == pod_uid for r in claim.status.reserved_for):
            return claim
        if len(claim.status.reserved_for) >= self.RESERVED_FOR_LIMIT:
            raise AllocationError(
                f"claim {claim.metadata.name!r} already reserved by "
                f"{self.RESERVED_FOR_LIMIT} consumers"
            )
        claim.status.reserved_for.append(
            ResourceClaimConsumerReference(resource="pods", name=pod_name, uid=pod_uid)
        )
        JOURNAL.record(
            "allocator", "reserve", correlation=claim.metadata.uid,
            claim=claim.metadata.name, pod=pod_name,
        )
        return self._server.update(claim)

    def unreserve(self, claim: ResourceClaim, pod_uid: str) -> ResourceClaim:
        claim.status.reserved_for = [
            r for r in claim.status.reserved_for if r.uid != pod_uid
        ]
        return self._server.update(claim)

    # -- internals ---------------------------------------------------------

    def _search(self, per_request, constraints, used_markers, free):
        """Backtracking all-or-nothing assignment honoring markers +
        matchAttribute constraints, with BEST-FIT candidate ordering.

        The upstream scheduler allocates first-feasible; we additionally
        score candidates so placements fragment the geometry as little as
        possible (the bin-packing concern MIG operators handle by hand):

        1. fewer chips first — a selector matching several subslice shapes
           takes the smallest that satisfies it;
        2. lower overlap degree first — prefer devices whose allocation
           invalidates the fewest still-allocatable devices, so single-chip
           claims land in already-broken regions and intact blocks survive
           for whole-subslice claims;
        3. device name last, for determinism.
        """
        flat: list[tuple[str, list[_Candidate]]] = []
        for name, count, matching in per_request:
            if len(matching) < count:
                return None
            for _ in range(count):
                flat.append((name, matching))

        chosen: list[tuple[str, _Candidate]] = []
        taken: set = set()
        markers: set = set(used_markers)
        # Constraints are independent of one another even when they name the
        # same attribute: agreement is tracked per constraint *instance*.
        attr_value: dict[int, object] = {}

        def order(matching: list[_Candidate]) -> list[_Candidate]:
            def degree(c: _Candidate) -> int:
                if not c.markers:
                    return 0
                return sum(
                    1
                    for o in free
                    if o.key != c.key
                    and o.key not in taken
                    and o.markers
                    and not (o.markers & markers)  # already infeasible: no loss
                    and (o.markers & c.markers)
                )

            return sorted(
                matching, key=lambda c: (len(c.markers), degree(c), c.device.name)
            )

        def constraint_ok(req_name: str, c: _Candidate) -> bool:
            for ci, (req_set, attr) in enumerate(constraints):
                if req_name not in req_set:
                    continue
                value = _qualified_attr(c, attr)
                if value is None:
                    return False
                if ci in attr_value and attr_value[ci] != value:
                    return False
            return True

        def assign(i: int) -> bool:
            if i == len(flat):
                return True
            req_name, matching = flat[i]
            for c in order(matching):
                if c.key in taken:
                    continue
                # hbm is a real quantity, not an exclusion marker; only the
                # synthetic markers participate in overlap exclusion.
                dev_markers = c.markers
                if dev_markers & markers:
                    continue
                if not constraint_ok(req_name, c):
                    continue
                saved_attrs = dict(attr_value)
                for ci, (req_set, attr) in enumerate(constraints):
                    if req_name in req_set and ci not in attr_value:
                        attr_value[ci] = _qualified_attr(c, attr)
                taken.add(c.key)
                markers.update(dev_markers)
                chosen.append((req_name, c))
                if assign(i + 1):
                    return True
                chosen.pop()
                markers.difference_update(dev_markers)
                taken.discard(c.key)
                attr_value.clear()
                attr_value.update(saved_attrs)
            return False

        return chosen if assign(0) else None

    def _gather_config(self, claim, requests, classes) -> list[DeviceAllocationConfiguration]:
        """Copy class + claim opaque configs into the allocation result with
        their source recorded — the plugin's precedence resolution depends on
        it (device_state.go:225-259: class < claim)."""
        out = []
        for req in requests:
            dc = classes.get(req.device_class_name)
            for cc in dc.spec.config or []:
                if cc.opaque is not None:
                    out.append(
                        DeviceAllocationConfiguration(
                            source="FromClass", requests=[req.name], opaque=cc.opaque
                        )
                    )
        for cc in claim.spec.devices.config or []:
            if cc.opaque is not None:
                out.append(
                    DeviceAllocationConfiguration(
                        source="FromClaim", requests=list(cc.requests), opaque=cc.opaque
                    )
                )
        return out
