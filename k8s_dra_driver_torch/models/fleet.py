"""The fleet router (``k8s_dra_driver_tpu/models/fleet.py``, copied: the
port imports nothing of the JAX package): N interchangeable engine
replicas behind one front door.

* :class:`Engine`: the replica contract of ``ServeEngine`` (dense) and
  ``PagedServeEngine`` (paged); both port engines satisfy it and the
  reference's.
* :class:`FleetRouter`: health-gated, least-loaded placement with prefix
  and adapter affinity; per-replica health from ``EngineStats`` (stalls,
  a frozen stats feed, quarantines, heartbeat age) driving a per-replica
  ``CircuitBreaker`` (``fleet/<name>``); live-migration evacuation by
  ``snapshot_active`` → ``release_active`` → ``restore(merge=True)`` onto
  survivors, entries beyond capacity parked; a fleet front-door queue
  with admission deadlines and newest-first shedding whose
  ``retry_after_s`` is fleet-wide; ``tick``/``place``, the surface a
  transport worker (``models/transport.PoolWorker``) drives.  Replica
  states run ``healthy → suspect → evacuating → drained``.
* ``live_routers``/``debug_fleet_doc``: the ``/debug/fleet`` document.

The router is host-only and registers the reference's ``tpu_fleet_*``
metrics in the port's registry.  Each replica's engine is seeded a
disjoint ``request_id`` range (``i * ID_STRIDE``) through an empty
merge-restore.  A fleet prefix tier or index (the reference's
``fleet_prefix.FleetPrefixTier``, which holds no JAX) may be attached;
none is by default.
"""

from __future__ import annotations

import inspect
import os
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Protocol, runtime_checkable

from k8s_dra_driver_torch.models.telemetry import EngineStats, terminal_retirer
from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.metrics import REGISTRY
from k8s_dra_driver_torch.utils.retry import CircuitBreaker
from k8s_dra_driver_torch.utils.watchdog import WATCHDOG

_M_REPLICAS = REGISTRY.gauge(
    "tpu_fleet_replicas",
    "fleet replicas by health state (healthy/suspect/evacuating/drained)",
)
_M_EVAC = REGISTRY.counter(
    "tpu_fleet_evacuations_total",
    "replica evacuations, by triggering reason",
)
_M_FLEET_SHED = REGISTRY.counter(
    "tpu_fleet_shed_total",
    "requests shed at the fleet front door (queue overflow or admission deadline)",
)
_M_FLEET_QUEUE = REGISTRY.gauge(
    "tpu_fleet_queue_depth",
    "requests waiting in the fleet front-door queue",
)

# replica health states: the router's failure-domain lifecycle
HEALTHY = "healthy"
SUSPECT = "suspect"
EVACUATING = "evacuating"
DRAINED = "drained"
STATES = (HEALTHY, SUSPECT, EVACUATING, DRAINED)

# the request-id range seeded per replica: an evacuated stream keeps its id
# in the target engine, so ids are fleet-unique by construction
ID_STRIDE = 1_000_000

_SEQ_LOCK = threading.Lock()
_SEQ = 0


def _next_seq() -> int:
    global _SEQ
    with _SEQ_LOCK:
        _SEQ += 1
        return _SEQ


@runtime_checkable
class Engine(Protocol):
    """The replica contract of ``ServeEngine`` (dense) and
    ``PagedServeEngine`` (paged): the same admission surface, the same
    typed Completion vocabulary (``serve.TERMINAL_STATUSES``), the same
    ``EngineStats`` load signal, and the snapshot/restore/release triple a
    live migration runs on.  A runtime check proves only that the members
    exist; ``tests/test_torch_fleet.py`` pins their signatures."""

    n_slots: int
    sync_interval: int

    def free_slots(self) -> int: ...

    def submit(self, prompt, max_tokens, **kwargs) -> int: ...

    def step_burst(self) -> int: ...

    def pump(self, requests, max_steps=100_000, queue_limit=None) -> list: ...

    def completions(self) -> list: ...

    def cancel(self, request_id: int) -> bool: ...

    def snapshot_active(self) -> dict: ...

    def restore(self, snapshot: dict, merge: bool = False) -> list: ...

    def release_active(self) -> int: ...

    def stats(self) -> EngineStats: ...


@dataclass(frozen=True)
class FleetPolicy:
    """Health/placement thresholds — all host-side, all deterministic.

    The suspect detectors are TICK-counted (router pump iterations), not
    wall-clocked, so chaos tests converge in milliseconds and production
    behavior scales with actual serving cadence.  ``heartbeat_suspect_s``
    is the wall-clock backstop for routers driven slower than their
    engines (an engine whose ``EngineStats.heartbeat_age_s`` grows past
    it while holding residents is wedged regardless of tick counts)."""

    stall_suspect_ticks: int = 3      # resident slots but no burst progress
    stale_stats_ticks: int = 3        # identical stats snapshots in a row
    quarantine_suspect: int = 2       # quarantine tally that marks a replica
    heartbeat_suspect_s: float = 30.0
    breaker_failures: int = 3         # unhealthy verdicts to open the breaker
    breaker_reset_s: float = 30.0
    auto_evacuate: bool = True        # evacuate when a replica's breaker opens
    affinity_prefix: int = 8          # leading tokens forming the prefix key
    # Affinity must beat a one-slot load imbalance (a warm prefix cache
    # saves a whole prefill) but lose to two — least-loaded still wins
    # when the spread is real.
    affinity_bonus: float = 1.25
    max_affinity_entries: int = 1024  # bound on the routing-history maps
    # Fleet prefix-cache tier (the reference's models/fleet_prefix.py): when
    # a prefix index is attached, depth-aware affinity replaces the flat bonus —
    # every whole cached block the candidate owns earns
    # ``prefix_depth_bonus_per_block``, capped.  0.6/block keeps the same
    # shape as the flat bonus but proportional: one cached block still
    # loses to a one-slot load imbalance, two blocks beat one slot, four
    # beat two — a deeper cached prefix wins a proportionally larger
    # imbalance, never an unbounded one.
    prefix_depth_bonus_per_block: float = 0.6
    prefix_depth_bonus_max: float = 4.0


class Replica:
    """One engine behind the router: its health state, breaker, cached
    load signal and the counters the suspect detectors run on."""

    def __init__(self, name: str, engine: Engine, policy: FleetPolicy, clock):
        self.name = name
        self.engine = engine
        self.state = HEALTHY
        self.breaker = CircuitBreaker(
            endpoint=f"fleet/{name}",
            failure_threshold=policy.breaker_failures,
            reset_timeout_s=policy.breaker_reset_s,
            clock=clock,
        )
        self.last_stats: EngineStats | None = None
        self.stalled_ticks = 0
        self.stale_ticks = 0
        self.evacuations = 0
        self.last_verdict = HEALTHY  # why-string for /debug/fleet
        self.evac_corr = ""          # journal correlation spanning one evacuation
        # submit() kwarg surface, computed once: the router passes through
        # only what this replica kind accepts (e.g. ``priority`` exists on
        # the paged engine, not the dense one).
        self.submit_params = frozenset(
            inspect.signature(engine.submit).parameters
        )

    def resident(self) -> int:
        eng = self.engine
        return (
            (eng.n_slots - eng.free_slots())
            + len(getattr(eng, "_preempted", ()) or ())
        )

    def idle(self) -> bool:
        eng = self.engine
        return (
            eng.free_slots() == eng.n_slots
            and not getattr(eng, "_admitting", ())
            and not getattr(eng, "_preempted", ())
        )

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "state": self.state,
            "breaker": self.breaker.state,
            "verdict": self.last_verdict,
            "evacuations": self.evacuations,
            "stats": self.last_stats.to_json() if self.last_stats else None,
        }


class FleetRouter:
    """The fleet front door.  Single-loop like the engines it drives:
    admission, health verdicts, evacuation and burst-stepping all run on
    the caller's thread inside :meth:`pump` ticks (or explicit
    :meth:`submit`/:meth:`drain` calls between pumps)."""

    def __init__(
        self,
        engines=(),
        policy: FleetPolicy | None = None,
        fault_injector=None,
        clock=time.monotonic,
    ):
        self.policy = policy or FleetPolicy()
        self.clock = clock
        self.seq = _next_seq()
        self.replicas: list[Replica] = []
        self.fault_injector = fault_injector
        if self.fault_injector is None:
            from k8s_dra_driver_torch.utils import faults

            raw = os.environ.get(faults.ENV_VAR, "")
            if raw:
                self.fault_injector = faults.FaultInjector.from_env(raw)
        self._owner: dict[int, Replica] = {}  # request_id -> serving replica
        self._parked: list[dict] = []  # evacuated entries awaiting capacity
        self._completions: list = []
        self._prefix_home: dict[tuple, str] = {}
        self._adapter_home: dict[int, str] = {}
        self._next_stride = 0
        self._evac_seq = 0
        self._tick = 0
        self._queue_depth = 0
        self.shed_count = 0
        self.last_shed = None
        # Host-side observers invoked once per router tick (pump iteration
        # or explicit tick()) after health verdicts and admission settle —
        # the drive surface an autoscaler attaches to.  Hooks must be cheap
        # and must not dispatch device work.
        self.tick_hooks: list = []
        # Fleet prefix-cache tier (the reference's models/fleet_prefix.py): both default
        # None — routing/scoring behavior is byte-identical until a tier
        # or index is attached.
        self.prefix_tier = None
        self.prefix_index = None
        for item in engines:
            if isinstance(item, tuple):
                name, engine = item
                self.add_replica(engine, name=name)
            else:
                self.add_replica(item)
        _LIVE_ROUTERS.add(self)

    # -- fleet membership ----------------------------------------------------

    def add_replica(self, engine, name: str | None = None) -> Replica:
        """Register an engine as a replica: protocol-check it, seed it a
        disjoint request-id range (through the public restore() surface —
        an empty merge-restore only bumps ``next_id``), and open it for
        admissions."""
        if not isinstance(engine, Engine):
            missing = [
                m for m in (
                    "free_slots", "submit", "step_burst", "pump", "completions",
                    "cancel", "snapshot_active", "restore", "release_active",
                    "stats",
                )
                if not callable(getattr(engine, m, None))
            ]
            raise TypeError(
                f"{type(engine).__name__} does not satisfy the Engine "
                f"protocol (missing: {missing or 'attributes'})"
            )
        name = name or f"r{len(self.replicas)}"
        if any(r.name == name for r in self.replicas):
            raise ValueError(f"duplicate replica name {name!r}")
        rep = Replica(name, engine, self.policy, self.clock)
        base = self._next_stride * ID_STRIDE
        self._next_stride += 1
        engine.restore(
            {"engine": type(engine).__name__, "next_id": base, "requests": []},
            merge=True,
        )
        self.replicas.append(rep)
        if self.prefix_tier is not None:
            self.prefix_tier.bind_engine(rep.name, rep.engine)
        JOURNAL.record(
            "fleet", "replica.add", correlation=name,
            engine=type(engine).__name__, n_slots=engine.n_slots,
            id_base=base,
        )
        self._publish_states()
        return rep

    def attach_prefix_index(self, index) -> None:
        """Depth-aware prefix scoring only (no pull machinery) — what the
        reference's workload simulator uses: engines consult/publish the index
        themselves and the router just routes-to-home by cached depth."""
        self.prefix_index = index

    def attach_prefix_tier(self, tier) -> None:
        """Full fleet prefix-cache tier: depth-aware scoring, engine
        publish hooks, and admission-time remote pulls (tier.prepare runs
        inside ``_submit_to``).  The tier's TTL sweep rides the tick hooks
        (host-only dict work — no device dispatch, per the tick_hooks
        contract)."""
        self.prefix_tier = tier
        self.prefix_index = tier.index
        for rep in self.replicas:
            tier.bind_engine(rep.name, rep.engine)
        self.tick_hooks.append(tier.tick)

    def replica(self, name: str) -> Replica:
        for rep in self.replicas:
            if rep.name == name:
                return rep
        raise KeyError(f"no replica named {name!r}")

    def admittable_replicas(self) -> list[Replica]:
        """Replicas that can take NEW work right now: healthy state and a
        breaker that is not open.  This is the live denominator for every
        fleet-wide admission hint (shed retry-after, autoscaler
        utilization): draining/evacuating/drained replicas are out, and a
        freshly added replica counts immediately — even before its first
        health tick populates ``last_stats``."""
        return [
            r for r in self.replicas
            if r.state == HEALTHY and r.breaker.state != CircuitBreaker.OPEN
        ]

    # -- admission -----------------------------------------------------------

    def submit(self, prompt, max_tokens: int, **kwargs) -> int:
        """Route one request immediately: health-gated, least-loaded,
        affinity-scored.  Raises RuntimeError when no admittable replica
        has capacity (callers queue upstream via :meth:`pump`, same
        contract as a bare engine's submit)."""
        req = {"prompt": list(prompt), "max_tokens": max_tokens, **kwargs}
        last_err: Exception | None = None
        for rep in self._candidates(
            req["prompt"], int(req.get("adapter", 0)), req
        ):
            try:
                return self._submit_to(rep, req)
            except RuntimeError as exc:  # capacity race (e.g. out of blocks)
                last_err = exc
                continue
        raise last_err or RuntimeError("no admittable replica with capacity")

    def _candidates(self, prompt, adapter: int, req: dict | None = None) -> list[Replica]:
        """Admittable replicas, best placement first.  Gate: state
        ``healthy`` AND the breaker admits (suspect/evacuating/drained
        replicas take no new work).  Score: free slots dominate (least
        loaded), free blocks break slot ties on paged replicas, and the
        prefix/adapter home earns ``affinity_bonus``.  With a fleet
        prefix index attached, the flat prefix bonus gives way to
        depth-aware scoring: each whole cached block the candidate owns
        earns ``prefix_depth_bonus_per_block`` (capped), so a deeper
        cached prefix beats a proportionally larger load imbalance."""
        pkey = self._prefix_key(prompt)
        survey = None
        if self.prefix_index is not None:
            chain = req.get("prefix_chain") if req else None
            if chain is None:
                chain = self.prefix_index.chain_for_tokens(prompt, adapter)
            survey = self.prefix_index.survey(chain, adapter)
        scored = []
        for idx, rep in enumerate(self.replicas):
            if rep.state != HEALTHY or not rep.breaker.allow():
                continue
            free = rep.engine.free_slots()
            if free <= 0:
                continue
            score = float(free)
            st = rep.last_stats
            if st is not None and st.free_blocks is not None:
                score += min(0.99, st.free_blocks / (100.0 * max(1, st.n_slots)))
            if survey is not None:
                owned = survey.get(rep.name)
                if owned is not None and (
                    self.prefix_tier is None
                    or self.prefix_tier.owner_available(rep.name)
                ):
                    # Breaker-open/dead owners earn no depth bonus:
                    # placement degrades to plain load balance (local-only)
                    # instead of chasing an unreachable cache.
                    score += min(
                        self.policy.prefix_depth_bonus_max,
                        self.policy.prefix_depth_bonus_per_block * owned[1],
                    )
            elif pkey is not None and self._prefix_home.get(pkey) == rep.name:
                score += self.policy.affinity_bonus
            if adapter and self._adapter_home.get(adapter) == rep.name:
                score += self.policy.affinity_bonus
            scored.append((-score, idx, rep))
        scored.sort(key=lambda t: t[:2])
        return [rep for _, _, rep in scored]

    def _prefix_key(self, prompt) -> tuple | None:
        n = self.policy.affinity_prefix
        return tuple(prompt[:n]) if len(prompt) >= n else None

    def _submit_to(self, rep: Replica, req: dict) -> int:
        kw = {
            k: v for k, v in req.items()
            if k in rep.submit_params and not k.startswith("_")
        }
        if "queued_at" in rep.submit_params:
            kw.setdefault("queued_at", req.get("_enqueued_at"))
        if self.prefix_tier is not None:
            # Warm the chosen replica before admission: local hit, remote
            # pull-and-inject, or nothing (cold).  prepare() contains its
            # own failures — the tier can cost an admission, never fail it.
            self.prefix_tier.prepare(
                rep.name, rep.engine, req["prompt"],
                max_tokens=req.get("max_tokens"),
                adapter=int(req.get("adapter", 0)),
                chain=req.get("prefix_chain"),
            )
        rid = rep.engine.submit(**kw)
        self._owner[rid] = rep
        pkey = self._prefix_key(req["prompt"])
        if pkey is not None:
            self._remember(self._prefix_home, pkey, rep.name)
        adapter = int(req.get("adapter", 0))
        if adapter:
            self._remember(self._adapter_home, adapter, rep.name)
        JOURNAL.record_lazy(
            "fleet", "request.route", correlation=f"req-{rid}",
            attrs=lambda: dict(replica=rep.name, prompt_len=len(req["prompt"])),
        )
        return rid

    def _remember(self, home: dict, key, name: str) -> None:
        home.pop(key, None)
        home[key] = name  # re-insert: dict order is the LRU order
        while len(home) > self.policy.max_affinity_entries:
            home.pop(next(iter(home)))

    # -- the fleet pump --------------------------------------------------------

    def pump(self, requests, max_steps: int = 100_000,
             queue_limit: int | None = None) -> list:
        """Fleet-level continuous batching: one front-door FIFO queue
        admitted across every healthy replica, burst-stepping all of them
        between admissions; returns every completion (typed, fleet-wide)
        that finished during the pump.

        ``queue_limit`` bounds the WAITING queue — overflow sheds
        newest-first with a fleet-wide retry-after.  Requests may carry
        ``admission_deadline_s`` (the fleet deadline budget): a request
        still queued when its budget lapses is shed instead of waiting
        forever.  Health verdicts, breaker updates and evacuations run
        every tick, so a replica that dies MID-PUMP is evacuated and its
        streams finish on survivors inside the same call."""
        queue = [self._normalize(r) for r in requests]
        t_enq = self.clock()
        for q in queue:
            q.setdefault("_enqueued_at", t_enq)
        out: list = []
        with WATCHDOG.guard("fleet.pump") as hb:
            for _ in range(max_steps):
                self._tick += 1
                progressed = self._health_tick()
                progressed |= self._replay_parked() > 0
                self._expire_queue(queue)
                admitted = self._admit(queue)
                if queue_limit is not None:
                    while len(queue) > queue_limit:
                        self._fleet_shed(
                            queue.pop(), len(queue) + 1,
                            f"admission queue full (limit {queue_limit})",
                        )
                self._queue_depth = len(queue)
                _M_FLEET_QUEUE.set(len(queue))
                hb.correlation = (
                    f"queue_depth={len(queue)} parked={len(self._parked)} "
                    f"sheds={self.shed_count}"
                )
                hb.beat()
                for hook in self.tick_hooks:
                    hook()
                stepped = self._step_replicas()
                out.extend(self.completions())
                live = [r for r in self.replicas if r.state != DRAINED]
                if (
                    not queue
                    and not self._parked
                    and all(r.idle() for r in live)
                ):
                    self._queue_depth = 0
                    _M_FLEET_QUEUE.set(0)
                    return out
                if not live:
                    raise self._wedge(
                        "fleet exhausted: every replica drained with work "
                        "still pending", queue,
                    )
                if (
                    stepped == 0 and admitted == 0 and not progressed
                    and all(r.resident() == 0 for r in live)
                    and not any(getattr(r.engine, "_admitting", ()) for r in live)
                ):
                    raise self._wedge(
                        "fleet pump wedged: waiting requests, no admittable "
                        "capacity, no progress", queue,
                    )
            raise self._wedge(
                f"fleet pump did not drain in {max_steps} ticks", queue
            )

    def _normalize(self, req) -> dict:
        if isinstance(req, dict):
            out = dict(req)
            out["prompt"] = list(out["prompt"])
            return out
        prompt, max_tokens = req
        return {"prompt": list(prompt), "max_tokens": max_tokens}

    def _admit(self, queue: list) -> int:
        admitted = 0
        while queue:
            req = queue[0]
            placed = False
            for rep in self._candidates(
                req["prompt"], int(req.get("adapter", 0)), req
            ):
                try:
                    self._submit_to(rep, req)
                except RuntimeError:
                    continue  # capacity race on this replica; try the next
                placed = True
                break
            if not placed:
                break  # FIFO: the head waits, nothing jumps it
            queue.pop(0)
            admitted += 1
        return admitted

    def _expire_queue(self, queue: list) -> None:
        """The fleet deadline budget: shed queued requests whose
        ``admission_deadline_s`` lapsed before a replica could take them."""
        now = self.clock()
        for idx in range(len(queue) - 1, -1, -1):
            budget = queue[idx].get("admission_deadline_s")
            if budget is None:
                continue
            if now - queue[idx]["_enqueued_at"] >= budget:
                self._fleet_shed(
                    queue.pop(idx), len(queue) + 1,
                    f"admission deadline {budget}s exceeded",
                )

    @terminal_retirer
    def _fleet_shed(self, req: dict, depth: int, why: str) -> None:
        """Typed fleet-level shed: the Completion carries a FLEET-wide
        retry-after — queue depth times the mean live-replica step
        latency, divided by the live replica count (the fleet drains in
        parallel, so the estimate must not be N times too pessimistic)."""
        from k8s_dra_driver_torch.models.serve import Completion, ShedError

        # Denominator = replicas that can actually absorb the backlog.
        # Draining/evacuating replicas and open breakers are excluded (an
        # in-flight scale-down must not promise drain parallelism it no
        # longer has), while a just-added replica with no stats yet counts
        # — its step estimate simply falls back to the fleet mean.
        admittable = self.admittable_replicas()
        n_live = max(1, len(admittable))
        steps = [
            r.last_stats.last_step_s
            for r in admittable
            if r.last_stats is not None
        ]
        step_s = max(sum(steps) / len(steps) if steps else 0.0, 1e-3)
        retry_after = round(max(0.05, depth * step_s / n_live), 3)
        err = ShedError(
            f"fleet shed: {why} ({depth} waiting across {n_live} live "
            f"replica(s)); retry after {retry_after}s",
            retry_after,
        )
        self.shed_count += 1
        self.last_shed = err
        _M_FLEET_SHED.inc()
        JOURNAL.record(
            "fleet", "request.shed", depth=depth, reason=why,
            retry_after_s=retry_after,
        )
        self._completions.append(Completion(
            request_id=-1, tokens=list(req["prompt"]), generated=[],
            status="shed", error=str(err),
        ))

    def _step_replicas(self) -> int:
        """One burst per live replica, fault hooks consulted pre-dispatch
        (a crash fires BEFORE the burst, so the dead replica's host state
        is still snapshot-consistent — the same pre-mutation discipline as
        the engines' StepFaults)."""
        from k8s_dra_driver_torch.utils.faults import ReplicaCrash

        stepped = 0
        for idx, rep in enumerate(self.replicas):
            if rep.state in (DRAINED, EVACUATING):
                continue
            inj = self.fault_injector
            if inj is not None:
                try:
                    inj.maybe_crash_replica(idx, self._tick)
                except ReplicaCrash as exc:
                    self._on_replica_death(rep, "replica_crash", str(exc))
                    continue
                if inj.take_replica_wedge(idx, self._tick):
                    continue  # a hung device: no burst, no progress
            try:
                stepped += rep.engine.step_burst()
            except RuntimeError as exc:
                # The engine failed its own wedge/poison limit mid-burst:
                # its quarantined slot already retired and the remaining
                # host state is consistent, so evacuate the survivors.
                self._on_replica_death(rep, "engine_error", str(exc))
                continue
            self._collect(rep)
        return stepped

    def _collect(self, rep: Replica) -> None:
        for c in rep.engine.completions():
            self._owner.pop(c.request_id, None)
            self._completions.append(c)

    def completions(self) -> list:
        out, self._completions = self._completions, []
        return out

    def cancel(self, request_id: int) -> bool:
        """Fleet-wide cancel: routed to whichever replica serves the id
        (ownership tracks migrations).  Only ADMITTED ids are cancellable —
        a request still in the front-door queue has no id yet."""
        rep = self._owner.get(request_id)
        if rep is None:
            return False
        ok = rep.engine.cancel(request_id)
        self._collect(rep)
        if ok:
            self._owner.pop(request_id, None)
        return ok

    # -- health --------------------------------------------------------------

    def _read_stats(self, idx: int, rep: Replica) -> EngineStats:
        inj = self.fault_injector
        if (
            inj is not None
            and rep.last_stats is not None
            and inj.take_stats_stale(idx, self._tick)
        ):
            return rep.last_stats  # the frozen feed the detector must catch
        return rep.engine.stats()

    def _health_tick(self) -> bool:
        """One verdict per live replica per tick; verdicts drive the
        breaker, the breaker drives state, an open breaker triggers
        evacuation.  Returns whether any state machinery advanced (the
        pump's no-progress detector must not fire while detection or
        recovery is still converging)."""
        changed = False
        for idx, rep in enumerate(self.replicas):
            if rep.state in (DRAINED, EVACUATING):
                continue
            st = self._read_stats(idx, rep)
            prev = rep.last_stats
            # Stale-feed detector: uptime_s strictly advances in any fresh
            # read, so an unchanged uptime means the feed is frozen and
            # the router cannot confirm this replica's health.
            if prev is not None and st.uptime_s <= prev.uptime_s:
                rep.stale_ticks += 1
            else:
                rep.stale_ticks = 0
            # Stall detector: resident streams but no burst progress.
            resident = st.resident_slots + st.admitting + st.preempted
            if prev is not None and resident > 0 and st.bursts <= prev.bursts:
                rep.stalled_ticks += 1
            else:
                rep.stalled_ticks = 0
            rep.last_stats = st
            verdict = self._verdict(rep, st, resident)
            if verdict != rep.last_verdict:
                rep.last_verdict = verdict
                changed = True
            if verdict == HEALTHY:
                rep.breaker.on_success()
                if rep.state == SUSPECT:
                    self._set_state(rep, HEALTHY, "recovered")
                    JOURNAL.record(
                        "fleet", "replica.recovered",
                        correlation=rep.evac_corr or rep.name,
                        replica=rep.name,
                    )
                    rep.evac_corr = ""
                    changed = True
                continue
            rep.breaker.on_failure()
            if rep.state == HEALTHY:
                rep.evac_corr = self._mint_corr()
                self._set_state(rep, SUSPECT, verdict)
                changed = True
            if (
                rep.state == SUSPECT
                and rep.breaker.state == CircuitBreaker.OPEN
                and self.policy.auto_evacuate
            ):
                self._evacuate(rep, verdict)
                changed = True
        return changed

    def _verdict(self, rep: Replica, st: EngineStats, resident: int) -> str:
        p = self.policy
        if rep.stale_ticks >= p.stale_stats_ticks:
            return "stats_stale"
        if resident > 0 and rep.stalled_ticks >= p.stall_suspect_ticks:
            return "wedged"
        if resident > 0 and st.heartbeat_age_s > p.heartbeat_suspect_s:
            return "wedged"
        if st.quarantined >= p.quarantine_suspect:
            return "quarantine_storm"
        return HEALTHY

    # -- evacuation ----------------------------------------------------------

    def _mint_corr(self) -> str:
        self._evac_seq += 1
        return f"evac-{self.seq}-{self._evac_seq}"

    def _on_replica_death(self, rep: Replica, reason: str, detail: str) -> None:
        """Immediate-evidence path (crash fault, engine wedge error): trip
        the breaker — counting to the threshold would route more traffic
        into the corpse — and evacuate now."""
        rep.evac_corr = rep.evac_corr or self._mint_corr()
        rep.last_verdict = reason
        rep.breaker.trip()
        self._set_state(rep, SUSPECT, reason, detail=detail)
        self._evacuate(rep, reason)

    def drain(self, name: str, reason: str = "scale_down") -> list[int]:
        """Planned evacuation (scale-down / rebalance): walk the same
        suspect → evacuating → drained lifecycle as a failure, under the
        same journal correlation, so operators read one vocabulary."""
        rep = self.replica(name)
        if rep.state == DRAINED:
            return []
        rep.evac_corr = rep.evac_corr or self._mint_corr()
        self._set_state(rep, SUSPECT, reason)
        return self._evacuate(rep, reason)

    def remove_replica(self, name: str):
        """Detach a DRAINED replica from the fleet and return its engine
        (the zero-loss pool-move building block: drain here, add_replica
        there).  Refuses any replica still in the lifecycle — removal
        must never strand resident streams."""
        rep = self.replica(name)
        if rep.state != DRAINED:
            raise ValueError(
                f"replica {name!r} is {rep.state}, not drained — "
                "drain() before remove_replica()"
            )
        self.replicas.remove(rep)
        for rid in [r for r, own in self._owner.items() if own is rep]:
            self._owner.pop(rid, None)
        if self.prefix_tier is not None:
            self.prefix_tier.on_replica_gone(rep.name, rep.engine)
        elif self.prefix_index is not None:
            self.prefix_index.invalidate_owner(rep.name)
        JOURNAL.record(
            "fleet", "replica.remove", correlation=name,
            engine=type(rep.engine).__name__,
        )
        self._publish_states()
        return rep.engine

    def _evacuate(self, rep: Replica, reason: str) -> list[int]:
        """snapshot → release → restore-onto-survivors.  Returns the ids
        moved (parked leftovers restore as capacity frees).  The whole
        operation journals under ONE correlation id."""
        corr = rep.evac_corr or self._mint_corr()
        rep.evac_corr = corr
        self._set_state(rep, EVACUATING, reason)
        try:
            snap = rep.engine.snapshot_active()
        except Exception as exc:
            # A replica too broken to snapshot loses its streams — record
            # loudly; the router still quarantines it out of the fleet.
            JOURNAL.record(
                "fleet", "evac.snapshot_failed", correlation=corr,
                replica=rep.name, error=f"{type(exc).__name__}: {exc}",
            )
            _M_EVAC.inc(reason="snapshot_failed")
            if self.prefix_tier is not None:
                self.prefix_tier.on_replica_gone(rep.name, rep.engine)
            elif self.prefix_index is not None:
                self.prefix_index.invalidate_owner(rep.name)
            self._set_state(rep, DRAINED, f"snapshot failed ({reason})")
            rep.evac_corr = ""
            return []
        entries = list(snap["requests"])
        JOURNAL.record(
            "fleet", "evac.snapshot", correlation=corr, replica=rep.name,
            requests=len(entries), engine=snap.get("engine", ""),
        )
        for req in entries:
            self._owner.pop(int(req["request_id"]), None)
        try:
            rep.engine.release_active()
        except Exception as exc:  # release is cleanup, never blocks the move
            JOURNAL.record(
                "fleet", "evac.release_failed", correlation=corr,
                replica=rep.name, error=f"{type(exc).__name__}: {exc}",
            )
        moved = self._place_entries(entries, corr, skip=rep)
        rep.evacuations += 1
        _M_EVAC.inc(reason=reason)
        # A drained replica's prefix blocks are unreachable: purge its
        # fleet-index entries (pinned ones die at unpin — an in-flight
        # pull is never raced) and stop publishing for it.
        if self.prefix_tier is not None:
            self.prefix_tier.on_replica_gone(rep.name, rep.engine)
        elif self.prefix_index is not None:
            self.prefix_index.invalidate_owner(rep.name)
        self._set_state(rep, DRAINED, reason)
        JOURNAL.record(
            "fleet", "evac.resumed", correlation=corr, replica=rep.name,
            moved=len(moved), parked=len(self._parked), reason=reason,
        )
        rep.evac_corr = ""
        return moved

    def _place_entries(self, entries: list, corr: str,
                       skip: Replica | None = None) -> list[int]:
        """Split evacuated entries across healthy replicas by free
        capacity and merge-restore each batch (bit-equal continuation —
        restore is the preemption-resume path).  Entries beyond fleet
        capacity park at the router and retry every tick."""
        moved: list[int] = []
        remaining = list(entries)
        for rep in self.replicas:
            if not remaining:
                break
            if rep is skip or rep.state != HEALTHY:
                continue
            if rep.breaker.state != CircuitBreaker.CLOSED:
                continue
            cap = rep.engine.free_slots()
            if cap <= 0:
                continue
            batch, remaining = remaining[:cap], remaining[cap:]
            try:
                restored = rep.engine.restore(
                    {"engine": "", "next_id": 0, "requests": batch}, merge=True
                )
            except RuntimeError as exc:
                # The replica refused the merge (e.g. it is itself draining
                # and its engine raised "needs an idle engine" under a
                # race): the entries are NOT lost — they go back to the
                # router's parking lot and retry on another replica next
                # tick.  Raising here would drop a whole evacuation batch.
                JOURNAL.record(
                    "fleet", "evac.restore_refused", correlation=corr,
                    replica=rep.name, requests=len(batch),
                    error=f"{type(exc).__name__}: {exc}",
                )
                rep.breaker.on_failure()
                remaining = batch + remaining
                continue
            JOURNAL.record(
                "fleet", "evac.restore", correlation=corr, replica=rep.name,
                requests=restored,
            )
            for rid in restored:
                self._owner[rid] = rep
            self._collect(rep)  # unrestorable entries deliver typed errors
            moved.extend(restored)
        for req in remaining:
            self._parked.append({"entry": req, "corr": corr})
        if remaining:
            JOURNAL.record(
                "fleet", "evac.parked", correlation=corr,
                requests=len(remaining),
            )
        return moved

    def _replay_parked(self) -> int:
        if not self._parked:
            return 0
        pending, self._parked = self._parked, []
        placed = 0
        for item in pending:
            moved = self._place_entries([item["entry"]], item["corr"])
            placed += len(moved)
        return placed

    # -- externally driven ticks (the disaggregated router's drive) -----------

    def tick(self) -> int:
        """ONE pump iteration without the front-door queue: health
        verdicts, parked-entry replay, one burst per live replica.
        Returns the number of slots stepped.  This is the drive surface
        the reference's ``disagg.DisaggRouter`` composes —
        it owns the cross-pool queue, this router owns its pool's health,
        placement and stepping."""
        self._tick += 1
        self._health_tick()
        self._replay_parked()
        for hook in self.tick_hooks:
            hook()
        return self._step_replicas()

    def place(self, entries: list, correlation: str = "") -> list[int]:
        """Public entry placement: merge-restore snapshot entries (e.g. a
        KV handoff batch) onto healthy replicas, parking what no replica
        can hold yet — exactly the evacuation placement path, so zero-loss
        parking and typed unrestorable errors come with it.  Returns the
        request ids placed now (parked entries place on later ticks)."""
        return self._place_entries(entries, correlation or f"place-{self.seq}")

    def idle(self) -> bool:
        """No queued, parked, resident or mid-admission work anywhere in
        this router's live replicas."""
        live = [r for r in self.replicas if r.state != DRAINED]
        return not self._parked and all(r.idle() for r in live)

    # -- state/observability ---------------------------------------------------

    def _set_state(self, rep: Replica, state: str, reason: str,
                   detail: str = "") -> None:
        prev, rep.state = rep.state, state
        JOURNAL.record(
            "fleet", f"replica.{state}",
            correlation=rep.evac_corr or rep.name,
            replica=rep.name, prev=prev, reason=reason,
            **({"detail": detail} if detail else {}),
        )
        self._publish_states()

    def _publish_states(self) -> None:
        counts = {s: 0 for s in STATES}
        for rep in self.replicas:
            counts[rep.state] += 1
        for state, n in counts.items():
            _M_REPLICAS.set(n, state=state)

    def _wedge(self, reason: str, queue: list) -> RuntimeError:
        from k8s_dra_driver_torch.utils.watchdog import dump_diag_bundle

        state = self.stats()
        state["queue_depth"] = len(queue)
        JOURNAL.record(
            "fleet", "fleet.wedged", reason=reason, queue_depth=len(queue),
            parked=len(self._parked),
        )
        try:
            bundle = dump_diag_bundle(
                WATCHDOG.bundle_dir, reason=reason, state=state
            )
            detail = f" (diag bundle: {bundle})"
        except Exception as exc:
            detail = f" (diag bundle failed: {type(exc).__name__}: {exc})"
        return RuntimeError(reason + detail)

    def stats(self) -> dict:
        """The /debug/fleet contract: per-replica state (health lifecycle
        + breaker + the replica's last EngineStats) and the fleet queue."""
        return {
            "router_seq": self.seq,
            "tick": self._tick,
            "queue_depth": self._queue_depth,
            "parked": len(self._parked),
            "shed_count": self.shed_count,
            "replicas": [rep.to_json() for rep in self.replicas],
        }


_LIVE_ROUTERS: "weakref.WeakSet[FleetRouter]" = weakref.WeakSet()


def live_routers() -> list[FleetRouter]:
    return sorted(list(_LIVE_ROUTERS), key=lambda r: r.seq)


def debug_fleet_doc() -> dict:
    """The /debug/fleet payload: every live router's per-replica state and
    front-door queue depth (the fleet counterpart of /debug/serve)."""
    return {"fleets": [router.stats() for router in live_routers()]}
