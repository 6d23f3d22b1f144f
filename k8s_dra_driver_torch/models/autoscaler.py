"""Closed-loop fleet autoscaler: ``k8s_dra_driver_tpu/models/autoscaler.py``
whole (lines 1-643), copied with the port's imports (the port imports
nothing of the JAX package).  Names, metric families, journal events and
the order of the fault draws are the reference's.

Control law, evaluated once per :meth:`FleetAutoscaler.tick`:

* **Sense.**  Utilization = busy slots / total slots across the
  ADMITTABLE replicas (``FleetRouter.admittable_replicas()``), plus the
  fleet front-door queue depth (or the driver's backlog, passed in).
* **Vote.**  Pressure above ``target_util_high`` or a queue deeper than
  ``queue_high`` per live replica votes up; utilization below
  ``target_util_low`` with an empty queue votes down; anything else
  resets both streaks.
* **Hysteresis + cooldown.**  An action fires only after ``up_ticks``
  (resp. ``down_ticks``) CONSECUTIVE votes, and never within
  ``cooldown_s`` of the previous action.
* **Act, bounded.**  Targets clamp to ``[min_replicas, max_replicas]``.
  Scale-up runs the caller's engine factory (the ``spawn_fail`` /
  ``spawn_latency_ms`` fault hooks fire BEFORE it: a failed spawn
  journals, backs off ``spawn_backoff_s`` and never half-registers),
  registers via ``add_replica`` and replays parked overflow.  Scale-down
  drains the least-loaded admittable replica through the evacuation path
  (zero dropped streams).  Every action journals under ONE correlation id
  (``scale-<router_seq>-<n>``).

:class:`PoolRebalancer` moves replicas between a ``DisaggRouter``'s pools
toward the TTFT stage that dominates (``scale_move``).  The controller is
host-only dict/clock arithmetic over ``stats()`` snapshots and imports no
torch.  Drive it explicitly (``autoscaler.tick()``) or attach it to the
router's tick hooks (:meth:`FleetAutoscaler.attach`), never both.
"""

from __future__ import annotations

import os
import time
import weakref
from dataclasses import dataclass

from k8s_dra_driver_torch.models.fleet import DRAINED, FleetRouter
from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.metrics import REGISTRY

_M_REPLICAS = REGISTRY.gauge(
    "tpu_autoscale_replicas",
    "autoscaler replica counts, by kind (target vs actual)",
)
_M_EVENTS = REGISTRY.counter(
    "tpu_autoscale_events_total",
    "autoscaler scaling actions, by direction and reason",
)
_M_DECISION = REGISTRY.histogram(
    "tpu_autoscale_decision_seconds",
    "wall-clock seconds spent per autoscaler tick decision",
    buckets=(1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 1e-1),
)
_M_ATTAIN = REGISTRY.gauge(
    "tpu_autoscale_slo_attainment",
    "fraction of offered requests meeting their TTFT and TPOT targets",
)

UP = "up"
DOWN = "down"
MOVE = "move"

# Flag for the remote-spawn path: when truthy, scale-ups run the
# transport-backed factory (a worker process / PoolWorker rig behind a
# PeerLink) instead of constructing an engine in the supervisor.
ENV_REMOTE_WORKERS = "DRA_REMOTE_WORKERS"


def select_engine_factory(local_factory, remote_factory=None,
                          environ=os.environ):
    """Flagged engine-factory selection for the spawn path.

    ``local_factory`` builds in-supervisor engines (the default);
    ``remote_factory`` builds transport-worker-backed replicas — usually
    :func:`k8s_dra_driver_torch.models.transport.make_remote_engine_factory`
    over the ``worker_main`` rig.  :data:`ENV_REMOTE_WORKERS` picks:
    truthy ("1"/"true"/"yes"/"on") selects the remote factory and raises
    loudly when none was wired (a production flag must never silently
    degrade to local spawning); anything else selects local."""
    raw = environ.get(ENV_REMOTE_WORKERS, "").strip().lower()
    if raw in ("1", "true", "yes", "on"):
        if remote_factory is None:
            raise ValueError(
                f"{ENV_REMOTE_WORKERS} is set but no remote engine factory "
                "was provided"
            )
        return remote_factory
    return local_factory


@dataclass(frozen=True)
class AutoscalerPolicy:
    """Control-law thresholds.  All deterministic, all host-side."""

    min_replicas: int = 1
    max_replicas: int = 8
    target_util_high: float = 0.85  # busy-slot fraction that votes up
    target_util_low: float = 0.30   # busy-slot fraction that votes down
    queue_high: int = 4             # queue depth per live replica voting up
    up_ticks: int = 2               # consecutive up-votes before acting
    down_ticks: int = 8             # consecutive down-votes before acting
    cooldown_s: float = 20.0        # min seconds between scaling actions
    max_step: int = 1               # replicas added/removed per action
    spawn_backoff_s: float = 10.0   # pause after a failed spawn

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas ({self.min_replicas}) <= "
                f"max_replicas ({self.max_replicas})"
            )


class FleetAutoscaler:
    """The controller between the stats feed and the scaling actuators.

    ``engine_factory`` is a zero-argument callable returning a fresh
    Engine-protocol replica (the caller owns device placement, params,
    clocks).  ``clock`` defaults to the router's — one clock rules the
    whole loop, so simulated-time replays compress cooldowns too.
    """

    def __init__(
        self,
        router: FleetRouter,
        engine_factory,
        policy: AutoscalerPolicy | None = None,
        clock=None,
        fault_injector=None,
        name_prefix: str = "as",
        burn_monitor=None,
    ):
        self.router = router
        self.engine_factory = engine_factory
        self.policy = policy or AutoscalerPolicy()
        # Optional obs_plane.SloBurnRateMonitor: while it alerts, the
        # error budget is burning on every window — treated as scale-up
        # pressure even when utilization alone wouldn't vote.
        self.burn_monitor = burn_monitor
        self.clock = clock or router.clock
        self.fault_injector = (
            fault_injector if fault_injector is not None
            else router.fault_injector
        )
        self.name_prefix = name_prefix
        self.seq = router.seq
        self.ticks = 0
        self.actions = 0
        self.spawn_failures = 0
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_t: float | None = None
        self._backoff_until: float | None = None
        self._spawn_seq = 0
        self._scale_seq = 0
        self._pending_spawns: list[dict] = []
        self._attained = 0
        self._offered = 0
        self.last_decision: dict = {}
        self._attached = False
        _LIVE_AUTOSCALERS.add(self)

    # -- wiring ------------------------------------------------------------

    def attach(self) -> "FleetAutoscaler":
        """Register on the router's tick hooks so ``FleetRouter.pump``
        (or ``tick()``) drives the control loop.  Don't also call
        :meth:`tick` from a driver loop — one drive path per loop."""
        if not self._attached:
            self.router.tick_hooks.append(self._on_router_tick)
            self._attached = True
        return self

    def _on_router_tick(self) -> None:
        self.tick()

    # -- SLO feedback ------------------------------------------------------

    def record_slo(self, attained: int, offered: int) -> None:
        """Fold one measurement window into the attainment gauge (the
        replay driver owns the per-request scoring)."""
        self._attained += int(attained)
        self._offered += int(offered)
        if self._offered:
            _M_ATTAIN.set(self._attained / self._offered)

    # -- the control loop --------------------------------------------------

    def tick(self, queue_depth: int | None = None) -> dict:
        """One sense → vote → act evaluation.  Returns the decision doc
        (also kept as ``last_decision`` for /debug/autoscale)."""
        t0 = time.perf_counter()
        now = self.clock()
        self.ticks += 1
        self._realize_spawns(now)
        depth = (
            int(queue_depth) if queue_depth is not None
            else self.router._queue_depth
        )
        admittable = self.router.admittable_replicas()
        actual = sum(1 for r in self.router.replicas if r.state != DRAINED)
        total_slots = sum(r.engine.n_slots for r in admittable)
        busy = sum(r.resident() for r in admittable)
        util = busy / total_slots if total_slots else 1.0
        vote = self._vote(util, depth, len(admittable))
        burn_forced = False
        if (
            vote != UP
            and self.burn_monitor is not None
            and self.burn_monitor.alerting
        ):
            # The SLO burn monitor says the error budget is being spent
            # past threshold on every window: that is demand pressure the
            # utilization signal can miss (e.g. slow-but-full replicas).
            vote, burn_forced = UP, True
        if vote == UP:
            self._up_streak += 1
            self._down_streak = 0
        elif vote == DOWN:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
        target = actual + len(self._pending_spawns)
        action = ""
        reason = ""
        p = self.policy
        cooling = (
            self._last_action_t is not None
            and now - self._last_action_t < p.cooldown_s
        )
        backing_off = (
            self._backoff_until is not None and now < self._backoff_until
        )
        if (
            actual < p.min_replicas
            and not self._pending_spawns
            and not backing_off
        ):
            # Below the floor (e.g. a replica died and was drained):
            # hysteresis and cooldown never block restoring the minimum.
            target = p.min_replicas
            action, reason = UP, "min_replicas"
        elif (
            vote == UP and self._up_streak >= p.up_ticks
            and not cooling and not backing_off
            and actual + len(self._pending_spawns) < p.max_replicas
        ):
            target = min(
                p.max_replicas,
                actual + len(self._pending_spawns) + p.max_step,
            )
            action = UP
            if burn_forced:
                reason = "slo_burn"
            elif depth >= p.queue_high * max(1, len(admittable)):
                reason = "queue_pressure"
            else:
                reason = "overload"
        elif (
            vote == DOWN and self._down_streak >= p.down_ticks
            and not cooling
            and actual > p.min_replicas
            and not self._pending_spawns
        ):
            target = max(p.min_replicas, actual - p.max_step)
            action, reason = DOWN, "underload"
        if action == UP:
            self._scale_up(target - actual - len(self._pending_spawns),
                           reason, now)
        elif action == DOWN:
            self._scale_down(actual - target, reason, now)
        _M_REPLICAS.set(target, kind="target")
        _M_REPLICAS.set(
            sum(1 for r in self.router.replicas if r.state != DRAINED),
            kind="actual",
        )
        self.last_decision = {
            "tick": self.ticks,
            "now": round(now, 3),
            "utilization": round(util, 4),
            "queue_depth": depth,
            "admittable": len(admittable),
            "actual": actual,
            "target": target,
            "vote": vote or "hold",
            "up_streak": self._up_streak,
            "down_streak": self._down_streak,
            "cooling": cooling,
            "backing_off": backing_off,
            "pending_spawns": len(self._pending_spawns),
            "action": action or "none",
            "reason": reason,
            "burn_alert": burn_forced or (
                self.burn_monitor is not None and self.burn_monitor.alerting
            ),
        }
        _M_DECISION.observe(time.perf_counter() - t0)
        return self.last_decision

    def _vote(self, util: float, depth: int, n_admittable: int) -> str:
        p = self.policy
        if n_admittable == 0:
            return UP  # no admittable capacity at all is maximal pressure
        if util >= p.target_util_high or depth >= p.queue_high * n_admittable:
            return UP
        if util <= p.target_util_low and depth == 0:
            return DOWN
        return ""

    # -- actuators ---------------------------------------------------------

    def _mint_corr(self) -> str:
        self._scale_seq += 1
        return f"scale-{self.seq}-{self._scale_seq}"

    def _scale_up(self, n: int, reason: str, now: float) -> None:
        for _ in range(max(1, n)):
            corr = self._mint_corr()
            attempt = self._spawn_seq
            self._spawn_seq += 1
            inj = self.fault_injector
            if inj is not None:
                from k8s_dra_driver_torch.utils.faults import SpawnFault

                try:
                    inj.maybe_fail_spawn(attempt)
                except SpawnFault as exc:
                    self.spawn_failures += 1
                    self._backoff_until = now + self.policy.spawn_backoff_s
                    self._last_action_t = now
                    self._up_streak = 0
                    _M_EVENTS.inc(direction=UP, reason="spawn_fail")
                    JOURNAL.record(
                        "autoscale", "scale_up.spawn_failed",
                        correlation=corr, attempt=attempt, error=str(exc),
                        backoff_s=self.policy.spawn_backoff_s,
                    )
                    return
            ready_at = now
            if inj is not None:
                ready_at += inj.take_spawn_latency(attempt)
            JOURNAL.record(
                "autoscale", "scale_up.begin", correlation=corr,
                attempt=attempt, reason=reason,
                ready_in_s=round(ready_at - now, 3),
            )
            self._last_action_t = now
            self._up_streak = 0
            self.actions += 1
            _M_EVENTS.inc(direction=UP, reason=reason)
            self._pending_spawns.append(
                {"corr": corr, "ready_at": ready_at, "attempt": attempt}
            )
        self._realize_spawns(now)

    def _realize_spawns(self, now: float) -> None:
        """Register every pending spawn whose (accounted) factory latency
        has elapsed, then replay parked overflow onto the new capacity."""
        if not self._pending_spawns:
            return
        still: list[dict] = []
        for item in self._pending_spawns:
            if item["ready_at"] > now:
                still.append(item)
                continue
            name = f"{self.name_prefix}{item['attempt']}"
            try:
                engine = self.engine_factory()
                rep = self.router.add_replica(engine, name=name)
            except Exception as exc:
                self.spawn_failures += 1
                self._backoff_until = now + self.policy.spawn_backoff_s
                _M_EVENTS.inc(direction=UP, reason="spawn_fail")
                JOURNAL.record(
                    "autoscale", "scale_up.spawn_failed",
                    correlation=item["corr"], attempt=item["attempt"],
                    error=f"{type(exc).__name__}: {exc}",
                    backoff_s=self.policy.spawn_backoff_s,
                )
                continue
            placed = self.router._replay_parked()
            JOURNAL.record(
                "autoscale", "scale_up.resumed", correlation=item["corr"],
                replica=rep.name, parked_placed=placed,
            )
        self._pending_spawns = still

    def _scale_down(self, n: int, reason: str, now: float) -> None:
        for _ in range(max(1, n)):
            victim = self._pick_victim()
            if victim is None:
                return
            corr = self._mint_corr()
            JOURNAL.record(
                "autoscale", "scale_down.begin", correlation=corr,
                replica=victim.name, reason=reason,
                resident=victim.resident(),
            )
            # Pre-seeding evac_corr threads the whole drain (suspect →
            # evacuating → drained → restored-on-survivors) under THIS
            # action's correlation id — one id spans the scaling action.
            victim.evac_corr = corr
            moved = self.router.drain(victim.name, reason="scale_down")
            self._last_action_t = now
            self._down_streak = 0
            self.actions += 1
            _M_EVENTS.inc(direction=DOWN, reason=reason)
            JOURNAL.record(
                "autoscale", "scale_down.resumed", correlation=corr,
                replica=victim.name, moved=len(moved),
            )

    def scale_move(self, dst: FleetRouter, reason: str = "rebalance"):
        """Zero-loss pool rebalancing: drain the least-loaded replica out
        of THIS autoscaler's pool (live migration — resident streams
        restore onto its siblings or park), detach it, and merge-restore
        its engine into ``dst`` under one ``scale-<seq>-<n>`` correlation
        spanning begin → drain → resumed.  ``add_replica``'s fresh id
        stride plus the restore-side ``max(next_id, ...)`` clamp keep
        request ids monotonic across the move, so a replica can bounce
        between pools without ever reissuing an id.  Returns the
        correlation id, or None when no replica can leave (pool at
        ``min_replicas`` or nothing admittable)."""
        victim = self._pick_victim()
        if victim is None:
            return None
        corr = self._mint_corr()
        now = self.clock()
        JOURNAL.record(
            "autoscale", "scale_move.begin", correlation=corr,
            replica=victim.name, reason=reason, resident=victim.resident(),
        )
        victim.evac_corr = corr
        self.router.drain(victim.name, reason="scale_move")
        engine = self.router.remove_replica(victim.name)
        name = victim.name
        if any(r.name == name for r in dst.replicas):
            name = f"{name}-m{self._scale_seq}"
        rep = dst.add_replica(engine, name=name)
        placed = dst._replay_parked()
        self._last_action_t = now
        self.actions += 1
        _M_EVENTS.inc(direction=MOVE, reason=reason)
        JOURNAL.record(
            "autoscale", "scale_move.resumed", correlation=corr,
            replica=rep.name, parked_placed=placed,
        )
        return corr

    def _pick_victim(self):
        """Least-loaded ADMITTABLE replica.  SUSPECT/EVACUATING/DRAINED
        replicas are never picked — they are already leaving or being
        healed, and draining them again would double-journal the exit."""
        candidates = self.router.admittable_replicas()
        if len(candidates) <= self.policy.min_replicas:
            return None
        return min(
            candidates,
            key=lambda r: (r.resident(), -r.engine.free_slots(), r.name),
        )

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """The /debug/autoscale contract: policy, streaks, pending
        spawns and the latest decision doc."""
        return {
            "router_seq": self.router.seq,
            "ticks": self.ticks,
            "actions": self.actions,
            "spawn_failures": self.spawn_failures,
            "pending_spawns": [
                {"corr": i["corr"], "ready_at": round(i["ready_at"], 3)}
                for i in self._pending_spawns
            ],
            "policy": {
                "min_replicas": self.policy.min_replicas,
                "max_replicas": self.policy.max_replicas,
                "target_util_high": self.policy.target_util_high,
                "target_util_low": self.policy.target_util_low,
                "queue_high": self.policy.queue_high,
                "up_ticks": self.policy.up_ticks,
                "down_ticks": self.policy.down_ticks,
                "cooldown_s": self.policy.cooldown_s,
            },
            "slo": {
                "offered": self._offered,
                "attained": self._attained,
                "attainment": (
                    round(self._attained / self._offered, 6)
                    if self._offered else None
                ),
            },
            "last_decision": dict(self.last_decision),
        }


@dataclass(frozen=True)
class RebalancePolicy:
    """Thresholds for TTFT-stage-driven pool rebalancing."""

    dominance: float = 2.0   # losing-stage mean must exceed the other's by this
    min_samples: int = 8     # per-stage observations before a window can vote
    vote_ticks: int = 3      # consecutive same-direction votes before acting
    cooldown_s: float = 60.0  # min seconds between moves


class PoolRebalancer:
    """Moves replicas between a disaggregated router's pools toward the
    TTFT stage that dominates the breakdown.

    Sense: drain :meth:`DisaggRouter.take_stage_attribution` each tick
    (the per-stage accumulator behind
    ``tpu_disagg_ttft_breakdown_seconds``).  Vote: when the decode-stage
    mean dominates the prefill-stage mean by ``policy.dominance`` (with
    ``min_samples`` observations on each side), the decode pool is
    starved — vote to move a prefill replica over; the mirror-image vote
    moves one back.  Hysteresis (``vote_ticks`` consecutive
    same-direction votes) and ``cooldown_s`` keep a single slow request
    from sloshing replicas.  Act: the donor pool's
    :meth:`FleetAutoscaler.scale_move` — live-drained, zero-loss, one
    correlation id.
    """

    def __init__(
        self,
        disagg,
        prefill_scaler: FleetAutoscaler,
        decode_scaler: FleetAutoscaler,
        policy: RebalancePolicy | None = None,
        clock=None,
        burn_monitor=None,
    ):
        self.disagg = disagg
        self.prefill_scaler = prefill_scaler
        self.decode_scaler = decode_scaler
        self.policy = policy or RebalancePolicy()
        # Optional obs_plane.SloBurnRateMonitor: a live burn alert drops
        # the hysteresis to a single vote — when the budget is burning,
        # the stage imbalance is costing real SLO, so act now.
        self.burn_monitor = burn_monitor
        self.clock = clock or disagg.clock
        self.ticks = 0
        self.moves = 0
        self._streak_dir = ""
        self._streak = 0
        self._last_move_t: float | None = None
        self.last_decision: dict = {}

    def _vote(self, attr: dict) -> str:
        p = self.policy
        pre = attr.get("prefill") or {}
        dec = attr.get("decode") or {}
        if pre.get("n", 0) < p.min_samples or dec.get("n", 0) < p.min_samples:
            return ""
        if dec["mean_s"] > pre["mean_s"] * p.dominance:
            return "to_decode"   # decode starved: donate a prefill replica
        if pre["mean_s"] > dec["mean_s"] * p.dominance:
            return "to_prefill"
        return ""

    def tick(self) -> dict:
        """One control-law evaluation.  Returns the decision doc (also
        kept as ``last_decision`` for /debug surfaces)."""
        self.ticks += 1
        now = self.clock()
        attr = self.disagg.take_stage_attribution()
        vote = self._vote(attr)
        if vote and vote == self._streak_dir:
            self._streak += 1
        elif vote:
            self._streak_dir, self._streak = vote, 1
        else:
            self._streak_dir, self._streak = "", 0
        corr = None
        in_cooldown = (
            self._last_move_t is not None
            and now - self._last_move_t < self.policy.cooldown_s
        )
        burn_alert = (
            self.burn_monitor is not None and self.burn_monitor.alerting
        )
        need_ticks = 1 if burn_alert else self.policy.vote_ticks
        if (
            self._streak >= need_ticks
            and not in_cooldown
        ):
            donor, taker = (
                (self.prefill_scaler, self.decode_scaler)
                if vote == "to_decode"
                else (self.decode_scaler, self.prefill_scaler)
            )
            corr = donor.scale_move(taker.router, reason=f"ttft_{vote}")
            if corr is not None:
                self.moves += 1
                self._last_move_t = now
            self._streak_dir, self._streak = "", 0
        self.last_decision = {
            "vote": vote, "streak": self._streak, "corr": corr,
            "cooldown": in_cooldown, "attribution": attr,
            "burn_alert": burn_alert,
        }
        return self.last_decision

    def stats(self) -> dict:
        return {
            "ticks": self.ticks,
            "moves": self.moves,
            "streak": self._streak,
            "streak_dir": self._streak_dir,
            "last_decision": dict(self.last_decision),
        }


_LIVE_AUTOSCALERS: "weakref.WeakSet[FleetAutoscaler]" = weakref.WeakSet()


def live_autoscalers() -> list[FleetAutoscaler]:
    return sorted(list(_LIVE_AUTOSCALERS), key=lambda a: a.seq)


def debug_autoscale_doc() -> dict:
    """The /debug/autoscale payload: every live autoscaler's control-law
    state and latest decision (the controller counterpart of
    /debug/fleet)."""
    return {"autoscalers": [a.stats() for a in live_autoscalers()]}
