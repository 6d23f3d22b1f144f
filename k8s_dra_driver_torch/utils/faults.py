"""Fault injection (``k8s_dra_driver_tpu/utils/faults.py``, copied: the
port imports nothing of the JAX package): every kind of the reference but
its scheduler kinds (``before_sched_commit``), which stay with the
scheduler extender and the contention harness, not ported yet.

A :class:`FaultInjector` armed with :class:`FaultProfile` s is consulted

* by ``kube.fakeserver.InMemoryAPIServer`` ahead of every verb
  (:meth:`FaultInjector.before`): injected 5xx/429 errors, 409 conflicts
  and added latency, before the store mutates, so an injected failure never
  half-applies; and by ``e2e.mock_api.MockKubeAPI`` at its HTTP-only seams:
  a response cut mid-body, 410 on a watch connect, an ``ERROR`` frame mid
  stream, a silent watch hang;
* by the engine once per step before it dispatches: added step latency,
  an injected :class:`StepFault` attributable to one slot, or NaN logits
  for one slot;
* by the fleet router once per (replica, tick) before that replica's
  burst: a :class:`ReplicaCrash`, a wedge (no burst this tick) or a stale
  ``stats()`` read;
* by the handoff channel once per transfer, before the payload reaches
  the decode pool (``models/disagg.py``): a dropped transfer, accounted
  latency, a corrupted payload; and by a ``ChannelSet`` per link consult:
  a link that dies, or a bandwidth brownout;
* by the autoscaler once per scale-up attempt, before the replica
  factory runs (``models/autoscaler.py``): a :class:`SpawnFault`, or
  accounted spawn latency;
* at the transport's send and receive seams (``models/transport.py``):
  a frame cut mid-body, a reset, accounted latency, a one-way partition,
  or a receiver poll that stalls.

Decisions come from ``random.Random(seed)``, drawn in the reference's
order, so an injector of each package armed alike makes the same
decisions.  Every injection counts on ``dra_faults_injected_total`` (by
profile and fault) in the port's registry and journals ``inject.<fault>``
under component ``faults``, as the reference's do.
``FaultInjector.from_env`` reads the reference's ``DRA_FAULTS`` grammar
and refuses any other key by name, the scheduler kinds' among them.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.metrics import REGISTRY

_INJECTED = REGISTRY.counter(
    "dra_faults_injected_total", "Faults injected, by profile and fault type"
)

ENV_VAR = "DRA_FAULTS"


class StepFault(RuntimeError):
    """An injected engine-step exception attributable to ONE slot, raised
    by :meth:`FaultInjector.maybe_raise_step` before the step dispatches,
    so no engine state has moved when it fires."""

    def __init__(self, slot: int, message: str):
        super().__init__(message)
        self.slot = slot


class SpawnFault(RuntimeError):
    """An injected replica-factory failure, raised by
    :meth:`FaultInjector.maybe_fail_spawn` before the factory runs, so a
    failed spawn never leaves a half-registered replica."""

    def __init__(self, attempt: int, message: str):
        super().__init__(message)
        self.attempt = attempt


class ReplicaCrash(RuntimeError):
    """An injected whole-replica death attributable to ONE fleet replica,
    raised by :meth:`FaultInjector.maybe_crash_replica` before the
    replica's burst dispatches, so its host state is still consistent
    when the router snapshots it."""

    def __init__(self, replica: int, message: str):
        super().__init__(message)
        self.replica = replica


@dataclass
class FaultProfile:
    """One armed fault source.  Rates are probabilities per matching
    decision; ``watch_*`` counts are storm budgets spent one per injection;
    ``verbs``/``kinds`` scope the API-server kinds and
    ``slots``/``steps``/``replicas``/``peers`` the others (empty = all;
    ``steps`` are engine steps, router ticks or a connection's sent
    frames, by the hook); ``limit`` caps its injections (0 = unlimited)."""

    name: str = "fault"
    # API-server kinds, per verb ahead of the store, and at the HTTP seams
    error_rate: float = 0.0  # probability of an injected APIError
    error_code: int = 500
    conflict_rate: float = 0.0  # probability of an injected 409 Conflict
    latency_s: float = 0.0  # slept before every matching operation
    drop_rate: float = 0.0  # probability of a truncated HTTP response
    watch_gone: int = 0  # next N watch connects answer 410 Gone
    watch_error_frames: int = 0  # next N streams get an ERROR frame
    watch_hangs: int = 0  # next N streams stall silently...
    watch_hang_s: float = 0.0  # ...for this long before resuming
    verbs: tuple = ()  # e.g. ("PUT",); empty = all verbs
    kinds: tuple = ()  # e.g. ("ResourceSlice",); empty = all kinds
    # engine kinds, per (slot, step)
    nan_logits_rate: float = 0.0  # probability a slot's logits go NaN
    step_raise_rate: float = 0.0  # probability of a StepFault pre-dispatch
    step_latency_s: float = 0.0  # added to every matching engine step
    slots: tuple = ()  # e.g. (1, 3); empty = all slots
    steps: tuple = ()  # e.g. (5,); empty = all engine steps
    # fleet router kinds, per (replica, tick)
    replica_crash_rate: float = 0.0  # probability a replica dies (ReplicaCrash)
    replica_wedge_rate: float = 0.0  # probability a replica hangs this tick
    stats_stale_rate: float = 0.0  # probability stats() serves a frozen copy
    replicas: tuple = ()  # e.g. (1,); empty = all replicas
    # autoscaler kinds, per scale-up attempt (``steps`` = attempt numbers;
    # latency accounted, never slept)
    spawn_fail_rate: float = 0.0  # probability a replica spawn errors
    spawn_latency_s: float = 0.0  # simulated seconds before a spawn is ready
    # handoff-channel kinds, per transfer (latency accounted, never slept)
    handoff_drop_rate: float = 0.0  # probability a transfer is dropped in flight
    handoff_latency_s: float = 0.0  # simulated seconds added per transfer
    handoff_corrupt_rate: float = 0.0  # probability payload bytes arrive corrupted
    # link kinds, per ChannelSet consult of a link
    channel_down_rate: float = 0.0  # probability a scoped link dies this consult
    channel_degrade: float = 0.0  # bandwidth multiplier (0 < f <= 1) when armed
    channels: tuple = ()  # e.g. ("ici-1",); empty = all links
    # transport kinds, per frame (latency accounted, never slept)
    sock_truncate_rate: float = 0.0  # probability a sent frame is cut mid-body
    sock_reset_rate: float = 0.0  # probability the peer resets mid-transfer
    sock_latency_s: float = 0.0  # simulated seconds added per frame
    sock_partition_rate: float = 0.0  # probability a sent frame vanishes
    peer_hang: int = 0  # next N receiver polls stall silently
    peers: tuple = ()  # e.g. ("decode-w",); empty = all peers
    limit: int = 0  # total-injection cap, 0 = unlimited
    injected: int = field(default=0, compare=False)


class FaultInjector:
    """Deterministic, thread-safe source of faults, shared by the
    in-memory store and the HTTP facade."""

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._profiles: list[FaultProfile] = []
        self._counts: dict[str, int] = {}

    def arm(self, profile: FaultProfile) -> FaultProfile:
        with self._lock:
            self._profiles.append(profile)
        JOURNAL.record(
            "faults", "profile.arm", correlation=profile.name,
            error_rate=profile.error_rate, conflict_rate=profile.conflict_rate,
            drop_rate=profile.drop_rate, watch_gone=profile.watch_gone,
        )
        return profile

    def disarm(self, name: str | None = None) -> None:
        with self._lock:
            if name is None:
                self._profiles.clear()
            else:
                self._profiles = [p for p in self._profiles if p.name != name]
        JOURNAL.record("faults", "profile.disarm", correlation=name or "*")

    # -- API-server decision points (reference ``:213-273``) ---------------------

    def before(self, verb: str, kind: str) -> None:
        """Store hook, ahead of every operation: may sleep (latency) and
        may raise an injected ``Conflict`` or ``APIError``."""
        from k8s_dra_driver_torch.kube.fakeserver import APIError, Conflict

        for p in self._matching(verb, kind):
            if p.latency_s > 0:
                time.sleep(p.latency_s)
            if p.conflict_rate and self._roll(p, p.conflict_rate, "conflict", verb, kind):
                raise Conflict(f"fault injected by profile {p.name!r}")
            if p.error_rate and self._roll(p, p.error_rate, "error", verb, kind):
                raise APIError(p.error_code, f"fault injected by profile {p.name!r}")

    def take_drop(self, verb: str, kind: str) -> bool:
        """HTTP only: should this response be cut mid-body?"""
        for p in self._matching(verb, kind):
            if p.drop_rate and self._roll(p, p.drop_rate, "drop", verb, kind):
                return True
        return False

    def take_watch_gone(self, kind: str) -> bool:
        """HTTP only: should this watch connect be answered 410 Gone?"""
        return self._take_counted(kind, "watch_gone")

    def take_watch_error_frame(self, kind: str) -> bool:
        """HTTP only: should this stream get an ERROR frame and close?"""
        return self._take_counted(kind, "watch_error_frames")

    def take_watch_hang(self, kind: str) -> float:
        """HTTP only: seconds this stream should stall silently (0: none)."""
        for p in self._matching("GET", kind):
            with self._lock:
                if p.watch_hangs > 0 and self._budget_ok(p):
                    p.watch_hangs -= 1
                    self._record(p, "watch_hang", "GET", kind)
                    return p.watch_hang_s
        return 0.0

    def take_step_latency(self) -> float:
        """Sleep each matching profile's step latency; return the seconds
        slept."""
        total = 0.0
        for p in self._matching_engine(None, None):
            if p.step_latency_s > 0:
                with self._lock:
                    if not self._budget_ok(p):
                        continue
                    self._record(p, "step_latency", "STEP", "engine")
                time.sleep(p.step_latency_s)
                total += p.step_latency_s
        return total

    def take_nan_logits(self, slot: int, step: int) -> bool:
        """Should this (slot, step)'s logits be poisoned to NaN?"""
        for p in self._matching_engine(slot, step):
            if p.nan_logits_rate and self._roll(
                    p, p.nan_logits_rate, "nan_logits", f"slot-{slot}", f"step-{step}"):
                return True
        return False

    def maybe_raise_step(self, slot: int, step: int) -> None:
        """Raise a :class:`StepFault` attributable to ``slot`` for this
        step, or return."""
        for p in self._matching_engine(slot, step):
            if p.step_raise_rate and self._roll(
                    p, p.step_raise_rate, "step_raise", f"slot-{slot}", f"step-{step}"):
                raise StepFault(
                    slot,
                    f"fault injected by profile {p.name!r} (slot {slot}, step {step})",
                )

    # -- fleet router decision points ------------------------------------------

    def maybe_crash_replica(self, replica: int, tick: int) -> None:
        """Raise a :class:`ReplicaCrash` for ``replica`` at this router
        tick, or return."""
        for p in self._matching_replica(replica, tick):
            if p.replica_crash_rate and self._roll(
                    p, p.replica_crash_rate, "replica_crash", f"replica-{replica}",
                    f"tick-{tick}"):
                raise ReplicaCrash(
                    replica,
                    f"fault injected by profile {p.name!r} (replica {replica}, tick {tick})",
                )

    def take_replica_wedge(self, replica: int, tick: int) -> bool:
        """Should this replica hang (skip its burst) this tick?"""
        for p in self._matching_replica(replica, tick):
            if p.replica_wedge_rate and self._roll(
                    p, p.replica_wedge_rate, "replica_wedge", f"replica-{replica}",
                    f"tick-{tick}"):
                return True
        return False

    def take_stats_stale(self, replica: int, tick: int) -> bool:
        """Should this replica's ``stats()`` read be served from the
        router's stale copy?"""
        for p in self._matching_replica(replica, tick):
            if p.stats_stale_rate and self._roll(
                    p, p.stats_stale_rate, "stats_stale", f"replica-{replica}",
                    f"tick-{tick}"):
                return True
        return False

    # -- autoscaler decision points (reference ``:364-398``) -----------------------

    def maybe_fail_spawn(self, attempt: int) -> None:
        """Raise a :class:`SpawnFault` for this scale-up attempt, or
        return.  Scoped by ``steps`` (= spawn attempt numbers)."""
        for p in self._matching_engine(None, attempt):
            if p.spawn_fail_rate and self._roll(
                    p, p.spawn_fail_rate, "spawn_fail", f"spawn-{attempt}", "autoscaler"):
                raise SpawnFault(
                    attempt,
                    f"fault injected by profile {p.name!r} (spawn attempt {attempt})",
                )

    def take_spawn_latency(self, attempt: int) -> float:
        """Simulated seconds before this spawn is ready (accounted by the
        autoscaler, never slept)."""
        total = 0.0
        for p in self._matching_engine(None, attempt):
            if p.spawn_latency_s > 0:
                with self._lock:
                    if not self._budget_ok(p):
                        continue
                    self._record(p, "spawn_latency", "SPAWN", "autoscaler")
                total += p.spawn_latency_s
        return total

    # -- handoff-channel decision points (reference ``:398-471``) -----------------

    def take_handoff_drop(self, request_id: int) -> bool:
        """Channel hook: should this KV transfer be dropped in flight?"""
        for p in self._matching_engine(None, None):
            if p.handoff_drop_rate and self._roll(
                    p, p.handoff_drop_rate, "handoff_drop", f"request-{request_id}", "channel"):
                return True
        return False

    def take_handoff_latency(self) -> float:
        """Channel hook: simulated seconds added to this transfer
        (accounted into its deadline, never slept)."""
        total = 0.0
        for p in self._matching_engine(None, None):
            if p.handoff_latency_s > 0:
                with self._lock:
                    if not self._budget_ok(p):
                        continue
                    self._record(p, "handoff_latency", "TRANSFER", "channel")
                total += p.handoff_latency_s
        return total

    def take_handoff_corrupt(self, request_id: int) -> bool:
        """Channel hook: should this transfer's payload arrive corrupted?"""
        for p in self._matching_engine(None, None):
            if p.handoff_corrupt_rate and self._roll(
                p, p.handoff_corrupt_rate, "handoff_corrupt", f"request-{request_id}", "channel"
            ):
                return True
        return False

    def take_channel_down(self, channel: str) -> bool:
        """Link hook: should this interconnect link die now?"""
        for p in self._matching_channel(channel):
            if p.channel_down_rate and self._roll(
                    p, p.channel_down_rate, "channel_down", f"channel-{channel}", "channel"):
                return True
        return False

    def channel_bandwidth_factor(self, channel: str) -> float:
        """Link hook: this link's bandwidth multiplier (1.0: no brownout),
        accounted into the transfer's latency, never slept."""
        factor = 1.0
        for p in self._matching_channel(channel):
            if 0.0 < p.channel_degrade < 1.0:
                with self._lock:
                    if not self._budget_ok(p):
                        continue
                    self._record(p, "channel_degrade", "TRANSFER", f"channel-{channel}")
                factor *= p.channel_degrade
        return factor

    # -- transport decision points ------------------------------------------------

    def take_sock_truncate(self, peer: str) -> bool:
        """Send seam: should this frame be cut mid-body (then the
        connection dies)?"""
        for p in self._matching_engine(None, None):
            if p.sock_truncate_rate and self._roll(
                    p, p.sock_truncate_rate, "sock_truncate", f"peer-{peer}", "transport"):
                return True
        return False

    def take_sock_reset(self, peer: str) -> bool:
        """Send seam: should the connection reset before this frame lands?"""
        for p in self._matching_engine(None, None):
            if p.sock_reset_rate and self._roll(
                    p, p.sock_reset_rate, "sock_reset", f"peer-{peer}", "transport"):
                return True
        return False

    def take_sock_latency(self) -> float:
        """Send seam: simulated seconds this frame spends on the wire
        (accounted, never slept)."""
        total = 0.0
        for p in self._matching_engine(None, None):
            if p.sock_latency_s > 0:
                with self._lock:
                    if not self._budget_ok(p):
                        continue
                    self._record(p, "sock_latency", "FRAME", "transport")
                total += p.sock_latency_s
        return total

    def take_sock_partition(self, peer: str, step: int | None = None) -> bool:
        """Send seam: should this frame silently vanish, the connection
        left open (a one-way partition)?"""
        for p in self._matching_peer(peer, step):
            if p.sock_partition_rate and self._roll(
                    p, p.sock_partition_rate, "sock_partition", f"peer-{peer}", "transport"):
                return True
        return False

    def take_peer_hang(self) -> bool:
        """Receive seam: should the receiver process nothing this poll?"""
        for p in self._matching_engine(None, None):
            with self._lock:
                if p.peer_hang > 0 and self._budget_ok(p):
                    p.peer_hang -= 1
                    self._record(p, "peer_hang", "POLL", "transport")
                    return True
        return False

    def stats(self) -> dict[str, int]:
        """Injections so far by fault kind."""
        with self._lock:
            return dict(self._counts)

    def total_injected(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    def _matching(self, verb: str, kind: str) -> list[FaultProfile]:
        with self._lock:
            return [
                p
                for p in self._profiles
                if (not p.verbs or verb in p.verbs) and (not p.kinds or kind in p.kinds)
            ]

    def _take_counted(self, kind: str, attr: str) -> bool:
        for p in self._matching("GET", kind):
            with self._lock:
                if getattr(p, attr) > 0 and self._budget_ok(p):
                    setattr(p, attr, getattr(p, attr) - 1)
                    self._record(p, attr, "GET", kind)
                    return True
        return False

    def _matching_engine(self, slot: int | None, step: int | None) -> list[FaultProfile]:
        with self._lock:
            return [
                p
                for p in self._profiles
                if (slot is None or not p.slots or slot in p.slots)
                and (step is None or not p.steps or step in p.steps)
            ]

    def _matching_channel(self, channel: str) -> list[FaultProfile]:
        with self._lock:
            return [p for p in self._profiles if not p.channels or channel in p.channels]

    def _matching_replica(self, replica: int, tick: int) -> list[FaultProfile]:
        with self._lock:
            return [
                p
                for p in self._profiles
                if (not p.replicas or replica in p.replicas)
                and (not p.steps or tick in p.steps)
            ]

    def _matching_peer(self, peer: str, step: int | None) -> list[FaultProfile]:
        with self._lock:
            return [
                p
                for p in self._profiles
                if (not p.peers or peer in p.peers)
                and (step is None or not p.steps or step in p.steps)
            ]

    def _roll(self, p: FaultProfile, rate: float, fault: str, verb: str, kind: str) -> bool:
        with self._lock:
            if not self._budget_ok(p):
                return False
            if self._rng.random() >= rate:
                return False
            self._record(p, fault, verb, kind)
            return True

    def _budget_ok(self, p: FaultProfile) -> bool:
        # called with the lock held
        return p.limit <= 0 or p.injected < p.limit

    def _record(self, p: FaultProfile, fault: str, verb: str, kind: str) -> None:
        # called with the lock held
        p.injected += 1
        self._counts[fault] = self._counts.get(fault, 0) + 1
        _INJECTED.inc(profile=p.name, fault=fault)
        JOURNAL.record_lazy(
            "faults", f"inject.{fault}", correlation=p.name,
            attrs=lambda: dict(verb=verb, kind=kind),
        )

    @staticmethod
    def from_env(raw: str) -> "FaultInjector":
        """Parse a ``DRA_FAULTS`` spec (``error_rate=0.3,latency_ms=5,
        verbs=PUT+POST,seed=7``) into an injector armed with one profile
        named "env".  Any other key (a typo, or a scheduler kind, which only
        the reference injects) raises ValueError naming it: a chaos run
        that silently injects nothing proves the wrong thing."""
        fields = {}
        seed = 0
        for part in raw.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, value = part.partition("=")
            if key == "seed":
                seed = int(value)
            elif key in _MS_KEYS:
                fields[_MS_KEYS[key]] = float(value) / 1000.0
            elif key in _RATE_ALIASES:
                fields[_RATE_ALIASES[key]] = float(value)
            elif key in _FLOAT_KEYS:
                fields[key] = float(value)
            elif key in ("error_code", "watch_gone", "watch_error_frames", "watch_hangs",
                         "peer_hang", "limit"):
                fields[key] = int(value)
            elif key in ("verbs", "kinds", "peers", "channels"):
                fields[key] = tuple(value.split("+"))
            elif key in ("slots", "steps", "replicas"):
                fields[key] = tuple(int(v) for v in value.split("+"))
            else:
                raise ValueError(f"{ENV_VAR}: fault key {key!r} is not one the port injects")
        injector = FaultInjector(seed=seed)
        injector.arm(FaultProfile(name="env", **fields))
        return injector


_MS_KEYS = {"latency_ms": "latency_s", "step_latency_ms": "step_latency_s", "sock_latency_ms": "sock_latency_s",
            "handoff_latency_ms": "handoff_latency_s", "spawn_latency_ms": "spawn_latency_s"}
_RATE_ALIASES = {"sock_truncate": "sock_truncate_rate", "sock_reset": "sock_reset_rate",
                 "sock_partition": "sock_partition_rate", "handoff_drop": "handoff_drop_rate",
                 "handoff_corrupt": "handoff_corrupt_rate", "channel_down": "channel_down_rate",
                 "channel_degrade": "channel_degrade", "spawn_fail": "spawn_fail_rate"}
_FLOAT_KEYS = ("error_rate", "conflict_rate", "drop_rate", "latency_s", "watch_hang_s",
               "nan_logits_rate", "step_raise_rate", "step_latency_s", "replica_crash_rate",
               "replica_wedge_rate", "stats_stale_rate", "handoff_drop_rate",
               "handoff_latency_s", "handoff_corrupt_rate", "channel_down_rate",
               "sock_truncate_rate", "sock_reset_rate", "sock_latency_s",
               "sock_partition_rate", "spawn_fail_rate", "spawn_latency_s")
