"""Disaggregated prefill/decode pools with KV handoff over a claimed channel
(``k8s_dra_driver_tpu/models/disagg.py``, copied: the port imports nothing
of the JAX package; the names, metrics, journal events and fault draws
are the reference's, so the same inputs and fault seed give the same
decisions).

Inside a unified replica, long prompts steal decode bursts: every chunked
prefill admission preempts token cadence for the latency-sensitive streams
already resident.  This module splits the fleet into two
pools of Engine-protocol replicas behind one :class:`DisaggRouter`:

* **Prefill pool** — runs chunked prefill ONLY.  Requests are submitted
  with ``handoff=True``, so each retires at its first token and rides out
  through ``take_handoffs()`` as a snapshot entry carrying its KV payload
  (``serve.KVSlice`` — dense slice or gathered paged stripes, bit-identical
  either way).  Slots/blocks free immediately; the pool never decodes.
* **Decode pool** — admits exclusively via merge-restore
  (``FleetRouter.place``), injecting the KV payload when geometry matches
  and burst-decoding each stream to completion.  The pool never pays a
  prompt-length prefill on the happy path.

Between them sits the :class:`HandoffChannel`: the transfer path modeled
as a first-class resource (the Kubernetes Network Driver Model, arxiv
2506.23628) rather than an invisible side effect.  The channel is bound to
a :class:`ChannelClaim` — the DRA-claimed interconnect device the topology
daemon publishes in its ResourceSlice (``deviceinfo.InterconnectChannelInfo``)
— so the scheduler sees transfer capacity like any other device.  The
channel enforces **bounded in-flight bytes** (transfers beyond the claim's
budget wait at the router, backpressure instead of oversubscription) and
**per-transfer deadlines** (simulated latency = bytes/bandwidth + injected
latency; a transfer whose latency exceeds the deadline is stale and is NOT
delivered).  Latency is accounted, never slept — chaos suites stay fast.

The fallback ladder, in order, each rung ending in a correct stream:

1. **ok** — payload delivered, decode replica injects KV, zero re-compute.
2. **engine fallback** — payload delivered but the decode replica cannot
   inject (geometry mismatch, no block capacity): the engine re-prefills
   from the entry's tokens (``tpu_disagg_fallback_total{reason=}``).
3. **channel fallback** — the transfer drops, corrupts (checksum mismatch)
   or goes stale (deadline): the payload is discarded and the entry is
   delivered WITHOUT KV, so the decode replica re-prefills — through its
   prefix cache when it has one, so a warm prefix still skips most of the
   recompute.  Never a lost or duplicated stream: the entry either
   delivers exactly once or parks at the decode router.

Failure semantics compose with the fleet layer untouched: each pool is a
full :class:`~k8s_dra_driver_torch.models.fleet.FleetRouter` (health
verdicts, breakers, evacuation, parking), driven via its externally-driven
``tick()``/``place()`` surface while THIS router owns the cross-pool
queue and the channel.

The router touches no tensor: the pools' engines keep the port's device
rule (the card unless the caller passes ``device="cpu"``).  The pools are
the port's own ``FleetRouter`` (``models/fleet.py``), a
``transport.RemotePool`` or anything with their drive surface.
"""

from __future__ import annotations

import os
import time
import weakref
from dataclasses import dataclass, replace

from k8s_dra_driver_torch.models.fleet import FleetPolicy, FleetRouter
from k8s_dra_driver_torch.models.obs_plane import FLEET
from k8s_dra_driver_torch.models.telemetry import EngineTelemetry
from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.metrics import REGISTRY
from k8s_dra_driver_torch.utils.retry import CircuitBreaker
from k8s_dra_driver_torch.utils.tracing import TRACES

_M_TRANSFERS = REGISTRY.counter(
    "tpu_disagg_transfers_total",
    "KV handoff transfers, by outcome (ok/dropped/deadline/corrupt/no_capacity)",
)
_M_XFER_BYTES = REGISTRY.histogram(
    "tpu_disagg_transfer_bytes",
    "KV payload size per handoff transfer",
    buckets=(
        1024.0, 4096.0, 16384.0, 65536.0, 262144.0,
        1048576.0, 4194304.0, 16777216.0, 67108864.0,
    ),
)
_M_TTFT_BREAKDOWN = REGISTRY.histogram(
    "tpu_disagg_ttft_breakdown_seconds",
    "Time-to-first-token attribution, by stage (prefill/transfer/decode)",
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0),
)
_M_INFLIGHT = REGISTRY.gauge(
    "tpu_disagg_inflight_bytes",
    "KV handoff bytes currently in flight on the channel",
)
_M_CHANNEL_UP = REGISTRY.gauge(
    "tpu_disagg_channel_up",
    "interconnect link usability in the bound channel set (1 = scoreable), by channel",
)
_M_FAILOVER = REGISTRY.counter(
    "tpu_disagg_channel_failover_total",
    "mid-transfer hops to a sibling interconnect channel, by reason",
)
_M_ADMISSION_PARKED = REGISTRY.gauge(
    "tpu_disagg_admission_parked",
    "handoffs parked at the prefill side by KV-demand admission control",
)
# Declared (with help) in models/serve.py, where the engine-level fallback
# arms live; looked up by name here so both layers share one counter.
_M_FALLBACK = REGISTRY.counter("tpu_disagg_fallback_total")

# Transfer outcomes — the channel's vocabulary.  Everything except ``ok``
# ends in rung 3 of the fallback ladder.
OK = "ok"
DROPPED = "dropped"
DEADLINE = "deadline"
CORRUPT = "corrupt"
NO_CAPACITY = "no_capacity"
CHANNEL_DOWN = "channel_down"  # the carrying link died between begin and complete


@dataclass(frozen=True)
class ChannelClaim:
    """The DRA-claimed interconnect resource a :class:`HandoffChannel` is
    bound to — the channel's capacity parameters as the topology daemon
    publishes them (``deviceinfo.InterconnectChannelInfo`` →
    ResourceSlice device attributes), so pool-to-pool transfer capacity is
    scheduled like any other device."""

    name: str = "ici-0"
    bandwidth_gbps: float = 100.0        # payload bandwidth, gigabits/s
    max_in_flight_bytes: int = 64 * 1024 * 1024
    transfer_deadline_s: float = 0.25    # per-transfer staleness bound
    source: str = "static"               # "daemon" when claimed via topology

    @staticmethod
    def _parse(ch: dict) -> "ChannelClaim":
        return ChannelClaim(
            name=str(ch.get("name", "ici-0")),
            bandwidth_gbps=float(ch.get("bandwidth_gbps", 100.0)),
            max_in_flight_bytes=int(ch.get("max_in_flight_bytes", 64 * 1024 * 1024)),
            transfer_deadline_s=float(ch.get("transfer_deadline_s", 0.25)),
            source="daemon",
        )

    @staticmethod
    def all_from_daemon_info(doc: dict) -> "tuple[ChannelClaim, ...]":
        """Every scoreable link the daemon published.  The multi-link
        ``channels`` list wins when present; an old info doc carrying only
        the single ``channel`` key yields a one-claim tuple, and a doc
        with neither yields an empty tuple (static fallback).  Duplicate
        link names raise — two claims would alias one breaker endpoint
        and merge distinct failure domains — and zero-bandwidth links are
        excluded from scoring outright (a link that can never move a byte
        must not absorb transfers)."""
        raw = list((doc or {}).get("channels") or ())
        if not raw:
            one = (doc or {}).get("channel")
            if not one:
                return ()
            raw = [one]
        claims = [ChannelClaim._parse(ch) for ch in raw]
        names = [c.name for c in claims]
        dupes = sorted({n for n in names if names.count(n) > 1})
        if dupes:
            raise ValueError(f"duplicate channel names in daemon info: {dupes}")
        return tuple(c for c in claims if c.bandwidth_gbps > 0.0)

    @staticmethod
    def from_daemon_info(doc: dict) -> "ChannelClaim | None":
        """Bind to the (best single) channel the topology daemon published
        in its info doc.  Returns None when the daemon publishes no
        scoreable channel — the caller falls back to a static claim.
        Multi-channel callers use :meth:`all_from_daemon_info`."""
        claims = ChannelClaim.all_from_daemon_info(doc)
        if not claims:
            return None
        return max(claims, key=lambda c: c.bandwidth_gbps)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "bandwidth_gbps": self.bandwidth_gbps,
            "max_in_flight_bytes": self.max_in_flight_bytes,
            "transfer_deadline_s": self.transfer_deadline_s,
            "source": self.source,
        }


@dataclass
class Transfer:
    """One in-flight KV payload on the channel."""

    request_id: int
    nbytes: int
    crc: int
    started_at: float
    latency_s: float = 0.0
    outcome: str = ""
    channel: str = ""  # the link carrying this hop (set-level failover retags)


class HandoffChannel:
    """The pool-to-pool KV transfer path, bound to a :class:`ChannelClaim`.

    Deliberately host-only and clock-free on the data path: transfer
    latency is ACCOUNTED (``nbytes / bandwidth + injected latency``) into
    the deadline check and the TTFT breakdown, never slept, so a chaos
    suite exercising thousands of transfers still finishes in seconds.
    Fault hooks (``handoff_drop`` / ``handoff_latency_ms`` /
    ``handoff_corrupt``, armable via ``DRA_FAULTS``) fire between
    :meth:`begin` and :meth:`complete` — before the payload reaches the
    decode pool, so a faulted transfer never half-installs KV bytes."""

    def __init__(
        self,
        claim: ChannelClaim | None = None,
        *,
        max_in_flight_bytes: int | None = None,
        transfer_deadline_s: float | None = None,
        bandwidth_gbps: float | None = None,
        fault_injector=None,
        clock=time.monotonic,
    ):
        self.claim = claim or ChannelClaim()
        self.max_in_flight_bytes = int(
            max_in_flight_bytes
            if max_in_flight_bytes is not None
            else self.claim.max_in_flight_bytes
        )
        self.transfer_deadline_s = float(
            transfer_deadline_s
            if transfer_deadline_s is not None
            else self.claim.transfer_deadline_s
        )
        self.bandwidth_gbps = float(
            bandwidth_gbps
            if bandwidth_gbps is not None
            else self.claim.bandwidth_gbps
        )
        self.fault_injector = fault_injector
        self.clock = clock
        self.in_flight_bytes = 0
        self._in_flight: dict[int, Transfer] = {}
        self.counts: dict[str, int] = {}
        self.bytes_moved = 0

    def fits(self, nbytes: int) -> bool:
        """Can a payload of this size EVER transfer on this channel?  A
        payload larger than the whole in-flight budget can't — the caller
        must fall back immediately instead of retrying forever."""
        return nbytes <= self.max_in_flight_bytes

    def begin(self, request_id: int, nbytes: int, crc: int) -> Transfer | None:
        """Reserve in-flight budget for one payload.  Returns None when
        the budget is exhausted (transient backpressure — retry next tick
        after other transfers complete)."""
        if self.in_flight_bytes + nbytes > self.max_in_flight_bytes:
            return None
        t = Transfer(
            request_id=request_id, nbytes=nbytes, crc=crc,
            started_at=self.clock(), channel=self.claim.name,
        )
        self.in_flight_bytes += nbytes
        self._in_flight[request_id] = t
        _M_INFLIGHT.set(self.in_flight_bytes)
        return t

    def refuse(self, request_id: int, nbytes: int, why: str) -> None:
        """Permanent refusal (payload exceeds the claim outright): counted
        as a ``no_capacity`` transfer so the A/B dashboards see it."""
        self._count(NO_CAPACITY)
        JOURNAL.record(
            "disagg", "transfer.refused", correlation=f"req-{request_id}",
            nbytes=nbytes, reason=why, budget=self.max_in_flight_bytes,
        )

    # The in-process channel is never "down" and has nothing to pump; the
    # transport.TransportChannel subclass overrides both — the router
    # consults them without caring which channel kind it holds.
    down = False

    def tick(self) -> int:
        return 0

    def complete(self, transfer: Transfer, kv, entry=None) -> str:
        """Resolve one transfer: account latency, consult the fault hooks,
        verify the checksum, release the in-flight budget.  Returns the
        outcome string; the payload object itself is never mutated — on a
        non-``ok`` outcome the ROUTER discards it, so corrupted/stale KV
        bytes can never reach a decode replica.  ``entry`` (the snapshot
        entry the payload belongs to) is unused here; the transport
        channel ships it alongside the KV bytes so the receiver can
        install the stream atomically."""
        inj = self.fault_injector
        bw = self.bandwidth_gbps
        if inj is not None:
            # Link brownout (channel_degrade fault): bandwidth shrinks, so
            # the same payload slides toward the deadline bound.
            bw *= inj.channel_bandwidth_factor(self.claim.name)
        latency = transfer.nbytes / max(bw * 1e9 / 8.0, 1.0)
        if inj is not None:
            latency += inj.take_handoff_latency()
        transfer.latency_s = latency
        if inj is not None and inj.take_handoff_drop(transfer.request_id):
            outcome = DROPPED
        elif latency > self.transfer_deadline_s:
            outcome = DEADLINE  # stale: the deadline bound says don't install
        elif (
            inj is not None and inj.take_handoff_corrupt(transfer.request_id)
        ) or kv.checksum() != transfer.crc:
            outcome = CORRUPT
        else:
            outcome = OK
        transfer.outcome = outcome
        self._in_flight.pop(transfer.request_id, None)
        self.in_flight_bytes -= transfer.nbytes
        _M_INFLIGHT.set(self.in_flight_bytes)
        _M_XFER_BYTES.observe(float(transfer.nbytes))
        self._count(outcome)
        if outcome == OK:
            self.bytes_moved += transfer.nbytes
        JOURNAL.record_lazy(
            "disagg", f"transfer.{outcome}",
            correlation=f"req-{transfer.request_id}",
            attrs=lambda: dict(
                nbytes=transfer.nbytes,
                latency_s=round(transfer.latency_s, 6),
                channel=self.claim.name,
            ),
        )
        return outcome

    def abort(self, transfer: Transfer, reason: str) -> None:
        """Release one in-flight reservation WITHOUT resolving the payload
        — the set-level failover path, for a transfer whose carrying link
        died between :meth:`begin` and :meth:`complete`.  Counted and
        journaled like any other non-``ok`` outcome so the dashboards see
        the failed half of the hop."""
        transfer.outcome = reason
        self._in_flight.pop(transfer.request_id, None)
        self.in_flight_bytes -= transfer.nbytes
        _M_INFLIGHT.set(self.in_flight_bytes)
        self._count(reason)
        JOURNAL.record(
            "disagg", f"transfer.{reason}",
            correlation=f"req-{transfer.request_id}",
            nbytes=transfer.nbytes, channel=self.claim.name,
        )

    def _count(self, outcome: str) -> None:
        _M_TRANSFERS.inc(outcome=outcome)
        self.counts[outcome] = self.counts.get(outcome, 0) + 1

    def stats(self) -> dict:
        """The /debug/disagg channel view: the bound claim, the live
        budget, and the per-outcome tally."""
        return {
            "claim": self.claim.to_json(),
            "max_in_flight_bytes": self.max_in_flight_bytes,
            "in_flight_bytes": self.in_flight_bytes,
            "in_flight_transfers": len(self._in_flight),
            "transfer_deadline_s": self.transfer_deadline_s,
            "bandwidth_gbps": self.bandwidth_gbps,
            "outcomes": dict(self.counts),
            "bytes_moved": self.bytes_moved,
        }


class ChannelSet:
    """N interconnect links to one peer, scored like replicas.

    Members are plain :class:`HandoffChannel`\\ s (or transport-backed
    subclasses); the router drives the SAME surface (``fits``/``begin``/
    ``refuse``/``complete``/``tick``/``down``/``stats``) without caring
    whether it holds one link or a set.  Selection prefers the usable
    link with the most headroom per unit bandwidth; a per-link
    :class:`CircuitBreaker` at ``transport/<peer>/<channel>`` takes a
    flapping link out of scoring, and a link death between ``begin`` and
    ``complete`` fails the transfer over to the best sibling — a
    journaled hop under the transfer's ``req-<rid>`` correlation plus
    ``tpu_disagg_channel_failover_total`` — instead of burning a
    re-prefill.  Only when EVERY link is unusable does the set report
    ``down``; the router's existing fallback ladder owns it from there."""

    def __init__(
        self,
        channels,
        *,
        peer: str = "",
        fault_injector=None,
        clock=time.monotonic,
    ):
        members: list[HandoffChannel] = []
        for ch in channels:
            if isinstance(ch, ChannelClaim):
                ch = HandoffChannel(
                    ch, fault_injector=fault_injector, clock=clock
                )
            members.append(ch)
        if not members:
            raise ValueError("ChannelSet needs at least one channel")
        names = [m.claim.name for m in members]
        dupes = sorted({n for n in names if names.count(n) > 1})
        if dupes:
            raise ValueError(f"duplicate channel names in set: {dupes}")
        if not peer:
            peer = getattr(
                getattr(members[0], "link", None), "peer", "local"
            ) or "local"
        self.members = members
        self.peer = peer
        self.clock = clock
        self.breakers = {
            m.claim.name: CircuitBreaker(
                endpoint=f"transport/{peer}/{m.claim.name}", clock=clock
            )
            for m in members
        }
        self._carrier: dict[int, HandoffChannel] = {}
        self._forced_down: dict[str, str] = {}  # name -> reason
        self.failovers = 0
        self.fault_injector = fault_injector
        for m in members:
            _M_CHANNEL_UP.set(1.0 if self._link_up(m) else 0.0,
                              channel=m.claim.name)

    # The router arms a shared injector post-construction; propagate it to
    # members that came in bare so one DRA_FAULTS spec drives every link.
    @property
    def fault_injector(self):
        return self._fault_injector

    @fault_injector.setter
    def fault_injector(self, inj) -> None:
        self._fault_injector = inj
        for m in self.members:
            if m.fault_injector is None:
                m.fault_injector = inj

    # -- link health ---------------------------------------------------------

    def _link_up(self, m: HandoffChannel) -> bool:
        name = m.claim.name
        if name in self._forced_down or m.down:
            return False
        br = self.breakers[name]
        return br.state != CircuitBreaker.OPEN or br.cooldown_remaining() <= 0.0

    def _maybe_kill(self, m: HandoffChannel) -> bool:
        """Consult the ``channel_down`` fault for this link (and remember a
        prior death): a killed link leaves scoring NOW and its breaker
        trips — counting failures toward the threshold would just route
        more transfers into the corpse."""
        name = m.claim.name
        if name in self._forced_down:
            return True
        inj = self._fault_injector
        if inj is not None and inj.take_channel_down(name):
            self._forced_down[name] = "fault"
            self.breakers[name].trip()
            _M_CHANNEL_UP.set(0.0, channel=name)
            JOURNAL.record(
                "disagg", "channel.down",
                correlation=f"{self.peer}/{name}", reason="channel_down",
            )
            return True
        return False

    @property
    def down(self) -> bool:
        """The SET is down only when no link is usable — the precondition
        for the router's transport-down fallback rung."""
        return not any(self._link_up(m) for m in self.members)

    # -- the channel surface the router drives -------------------------------

    def tick(self) -> int:
        n = 0
        for m in self.members:
            n += m.tick()
            _M_CHANNEL_UP.set(1.0 if self._link_up(m) else 0.0,
                              channel=m.claim.name)
        return n

    def fits(self, nbytes: int) -> bool:
        return any(m.fits(nbytes) for m in self.members)

    def _pick(self, nbytes: int, exclude=()) -> HandoffChannel | None:
        """Best usable link with budget room for this payload: lowest
        resulting in-flight bytes per unit bandwidth — the same
        load-per-capacity shape the fleet router scores replicas with."""
        best, best_score = None, None
        for m in self.members:
            name = m.claim.name
            if name in exclude or not self._link_up(m):
                continue
            if m.in_flight_bytes + nbytes > m.max_in_flight_bytes:
                continue
            if not self.breakers[name].allow():
                continue
            score = (m.in_flight_bytes + nbytes) / max(m.bandwidth_gbps, 1e-9)
            if best_score is None or score < best_score:
                best, best_score = m, score
        return best

    def begin(self, request_id: int, nbytes: int, crc: int) -> Transfer | None:
        m = self._pick(nbytes)
        if m is None:
            return None  # every usable link's budget is spent: backpressure
        t = m.begin(request_id, nbytes, crc)
        if t is None:
            return None
        self._carrier[request_id] = m
        return t

    def refuse(self, request_id: int, nbytes: int, why: str) -> None:
        # Charge the largest link: its refusal is what proves NO link can
        # ever carry the payload.
        m = max(self.members, key=lambda m: m.max_in_flight_bytes)
        m.refuse(request_id, nbytes, why)

    def complete(self, transfer: Transfer, kv, entry=None) -> str:
        """Resolve one transfer with mid-flight failover: a channel-fault
        outcome (drop, stale, corrupt-on-the-wire, link death) re-begins
        the SAME payload on the best untried sibling and journals the hop
        under the transfer's correlation.  Only when no sibling can take
        the payload does the failing outcome surface — and only then does
        the router's re-prefill ladder run."""
        m = self._carrier.pop(transfer.request_id, None)
        if m is None:
            m = self.members[0]
        first = transfer
        tried = {m.claim.name}
        while True:
            name = m.claim.name
            br = self.breakers[name]
            if self._maybe_kill(m):
                m.abort(transfer, CHANNEL_DOWN)
                outcome = CHANNEL_DOWN
            else:
                outcome = m.complete(transfer, kv, entry=entry)
                if outcome == OK:
                    br.on_success()
                    if transfer is not first:
                        # The caller holds the FIRST hop's Transfer: fold
                        # the winning hop's accounting back into it.
                        first.latency_s = transfer.latency_s
                        first.outcome = transfer.outcome
                        first.channel = transfer.channel
                    return OK
                br.on_failure()
            sib = self._pick(transfer.nbytes, exclude=tried)
            if sib is None:
                return outcome
            t2 = sib.begin(transfer.request_id, transfer.nbytes, transfer.crc)
            if t2 is None:
                return outcome
            self.failovers += 1
            _M_FAILOVER.inc(reason=outcome)
            JOURNAL.record(
                "disagg", "transfer.failover",
                correlation=f"req-{transfer.request_id}",
                from_channel=name, to_channel=sib.claim.name, reason=outcome,
            )
            tried.add(sib.claim.name)
            transfer, m = t2, sib

    # -- observability -------------------------------------------------------

    @property
    def counts(self) -> dict:
        agg: dict[str, int] = {}
        for m in self.members:
            for k, v in m.counts.items():
                agg[k] = agg.get(k, 0) + v
        return agg

    @property
    def bytes_moved(self) -> int:
        return sum(m.bytes_moved for m in self.members)

    def stats(self) -> dict:
        """The /debug/disagg channel view, per-link: each member's claim,
        budget and outcome tally plus set-level health and hop count."""
        return {
            "peer": self.peer,
            "failovers": self.failovers,
            "in_flight_bytes": sum(m.in_flight_bytes for m in self.members),
            "outcomes": self.counts,
            "bytes_moved": self.bytes_moved,
            "channels": [
                {
                    **m.stats(),
                    "up": self._link_up(m),
                    "breaker": self.breakers[m.claim.name].state,
                    "forced_down": self._forced_down.get(m.claim.name, ""),
                }
                for m in self.members
            ],
        }


class DisaggRouter:
    """The disaggregated front door: one queue, two pools, one channel.

    Driven like the engines and the fleet router — everything happens on
    the caller's thread inside :meth:`pump` ticks.  Each tick: admit the
    queue into the prefill pool (``handoff=True``), tick the prefill pool,
    collect first-token handoffs, drive the channel (begin every staged
    transfer that fits the budget, then complete them — so bounded
    in-flight bytes gate how much KV moves per tick), deliver/fallback
    into the decode pool via ``place()``, tick the decode pool, collect
    completions from both."""

    def __init__(
        self,
        prefill=(),
        decode=(),
        channel=None,
        policy: FleetPolicy | None = None,
        fault_injector=None,
        clock=time.monotonic,
        admission_control: bool = True,
        deadlock_ticks: int = 50,
    ):
        self.clock = clock
        if fault_injector is None:
            from k8s_dra_driver_torch.utils import faults

            raw = os.environ.get(faults.ENV_VAR, "")
            if raw:
                fault_injector = faults.FaultInjector.from_env(raw)
        self.fault_injector = fault_injector
        # One injector shared by both pools and the channel: one DRA_FAULTS
        # spec (and one budget) drives chaos across every layer.  Pools are
        # duck-typed on the FleetRouter drive surface (submit/place/tick/
        # completions/idle) so a transport.RemotePool — the same pool
        # hosted in a worker process — slots in unchanged.
        self.prefill = (
            FleetRouter(prefill, policy=policy,
                        fault_injector=fault_injector, clock=clock)
            if isinstance(prefill, (list, tuple))
            else prefill
        )
        self.decode = (
            FleetRouter(decode, policy=policy,
                        fault_injector=fault_injector, clock=clock)
            if isinstance(decode, (list, tuple))
            else decode
        )
        if isinstance(channel, (list, tuple)):
            # A claim/channel LIST binds a multi-link ChannelSet: channels
            # scored like replicas, mid-transfer failover between them.
            channel = ChannelSet(
                channel, fault_injector=fault_injector, clock=clock
            )
        self.channel = channel or HandoffChannel(
            fault_injector=fault_injector, clock=clock
        )
        if self.channel.fault_injector is None:
            self.channel.fault_injector = fault_injector
        self.seq = self.prefill.seq
        self._tick = 0
        self._staged: list[dict] = []      # handoffs awaiting channel budget
        self._t0: dict[int, float] = {}    # rid -> enqueue time (TTFT base)
        self._awaiting: dict[int, float] = {}  # rid -> delivery time (decode stage)
        self._completions: list = []       # collected by the external drive
        # locally re-run rid -> the rid the caller holds (crash resubmit)
        self._rid_alias: dict[int, int] = {}
        # KV-demand admission: rid -> committed full-stream block
        # reservation on the decode pool, spanning resident + parked +
        # in-flight-PLACE streams.  Handoffs whose demand cannot fit park
        # in _admission_parked (typed backpressure at the prefill side)
        # instead of deadlocking an undersized decode pool.
        self.admission_control = admission_control
        self.deadlock_ticks = max(1, int(deadlock_ticks))
        self._ledger: dict[int, int] = {}
        self._admission_parked: list[dict] = []
        self._starved_ticks = 0
        self._last_unparked = 0
        self.deadlock_fired = 0
        # per-stage TTFT attribution window (the rebalance policy's vote
        # signal): stage -> [sum_seconds, observations]
        self._stage_acc: dict[str, list] = {}
        self.handoffs = 0
        self.fallbacks = 0
        _LIVE_DISAGG.add(self)

    # -- the disaggregated pump ---------------------------------------------

    def pump(self, requests, max_steps: int = 100_000) -> list:
        """Serve every request through prefill → handoff → decode; returns
        every typed Completion.  Zero-loss invariant: each admitted stream
        is at all times in exactly one of {prefill slot, staged transfer,
        decode placement (resident or parked)} until its one Completion
        delivers."""
        queue = [self.prefill._normalize(r) for r in requests]
        t_enq = self.clock()
        for q in queue:
            q.setdefault("_enqueued_at", t_enq)
        out: list = []
        stall = 0
        for _ in range(max_steps):
            self._tick += 1
            admitted = self._admit(queue)
            stepped = self.prefill.tick()
            out.extend(self._remap(self.prefill.completions()))
            collected = self._collect_handoffs()
            moved = self._drive_channel()
            stepped += self.decode.tick()
            out.extend(self._remap(self._collect_decode()))
            moved += self._reclaim_failed()
            moved += self._deadlock_tick()
            if (
                not queue
                and not self._staged
                and not self._admission_parked
                and self.prefill.idle()
                and self.decode.idle()
            ):
                return out
            if admitted or stepped or collected or moved:
                stall = 0
            elif self._remote_waiting():
                # Streams are in flight on a LIVE transport link: waiting
                # is legitimate and wall-bounded — either the peer answers
                # or its heartbeat liveness window expires and the link's
                # death reclaims every stream.  Pace the spin so the
                # window passes in real time instead of burning the
                # tick-based stall bound in microseconds; max_steps still
                # bounds a peer that answers heartbeats but withholds
                # progress forever.
                time.sleep(0.002)
            else:
                stall += 1
                if stall >= 200:
                    raise RuntimeError(
                        f"disagg pump wedged: {len(queue)} queued, "
                        f"{len(self._staged)} staged, no progress in "
                        f"{stall} ticks"
                    )
        raise RuntimeError(f"disagg pump did not drain in {max_steps} ticks")

    def _admit(self, queue: list) -> int:
        """FIFO admission into the prefill pool, every request in handoff
        mode (retire at first token, KV payload out through the channel)."""
        admitted = 0
        while queue:
            req = dict(queue[0])
            prompt = req.pop("prompt")
            max_tokens = req.pop("max_tokens")
            req.pop("handoff", None)  # admission mode is the router's call
            try:
                rid = self.prefill.submit(
                    prompt, max_tokens, handoff=True, **req
                )
            except RuntimeError:
                break  # prefill pool full: the head waits, FIFO holds
            self._t0[rid] = req.get("_enqueued_at", self.clock())
            queue.pop(0)
            admitted += 1
        return admitted

    def _collect_handoffs(self) -> int:
        """Drain every prefill replica's handoff queue into the staging
        area.  The prefill router's ownership entry is released here —
        the stream has left that pool and will complete from the decode
        side."""
        n = 0
        pool_take = getattr(self.prefill, "take_handoffs", None)
        if callable(pool_take):
            # Pool-level drain: a RemotePool aggregates its worker's
            # replica handoffs into one queue (the replicas themselves
            # live in another process).
            for entry in pool_take():
                self._stage_handoff(
                    entry, getattr(self.prefill, "name", "remote")
                )
                n += 1
        for rep in getattr(self.prefill, "replicas", ()):
            take = getattr(rep.engine, "take_handoffs", None)
            if not callable(take):
                continue
            for entry in take():
                self._stage_handoff(entry, rep.name)
                n += 1
        return n

    def _stage_handoff(self, entry: dict, source: str) -> None:
        rid = int(entry["request_id"])
        self.prefill._owner.pop(rid, None)
        now = self.clock()
        t0 = self._t0.pop(rid, now)
        self._observe_stage("prefill", max(0.0, now - t0))
        EngineTelemetry.annotate_trace_doc(
            entry.get("trace"), "handoff_begin", now, source=source,
        )
        # Fleet span tree: a LOCAL prefill pool has no worker process to
        # record its hop, so the router records it here (duration mapped
        # into the monotonic domain) and notes the hop so the wire span
        # parents to it.  A remote prefill already noted its own span via
        # the HANDOFF frame's trace context — keep that one.
        ctx = FLEET.hop_ctx(rid)
        if not ctx or not ctx.get("parent_id"):
            mono = time.monotonic()
            span = TRACES.record(
                f"req-{rid}", "hop.prefill",
                mono - max(0.0, now - t0), mono,
                request_id=rid, source=source,
            )
            FLEET.note_hop(rid, f"req-{rid}", span.span_id, instance=source)
        self._staged.append({"entry": entry, "staged_at": now})
        self.handoffs += 1

    def _drive_channel(self) -> int:
        """Move staged KV payloads through the channel.  Two passes: begin
        every transfer the in-flight budget admits this tick (the bound
        gates bytes-per-tick), then complete each and deliver or fall
        back.  Entries whose payload exceeds the whole budget fall back
        immediately; entries squeezed out transiently retry next tick."""
        begun: list[tuple[dict, Transfer]] = []
        waiting: list[dict] = []
        moved = 0
        self.channel.tick()  # heartbeats / liveness / paced reconnect
        # KV-demand admission runs BEFORE any bytes move: freed decode
        # capacity re-admits parked handoffs oldest-first, then each newly
        # staged handoff must fit the full-stream ledger or park.
        self._last_unparked = self._unpark_admissions()
        moved += self._last_unparked
        if self.admission_control and self._staged:
            fitting: list[dict] = []
            for item in self._staged:
                if self._admit_handoff(item):
                    fitting.append(item)
                else:
                    self._park_admission(item)
                    moved += 1
            self._staged = fitting
        if self.channel.down and self._staged:
            # Whole transport down: every staged payload lands on the
            # fallback rung NOW (KV-less delivery, decode re-prefills) —
            # staged KV must not ripen past its deadline waiting for a
            # reconnect that may never come.
            for item in self._staged:
                entry = item["entry"]
                if entry.get("kv") is not None:
                    self._fallback(entry, "transport_down")
                else:
                    self._deliver(entry, transfer_s=0.0)
                moved += 1
            self._staged = []
            return moved
        for item in self._staged:
            entry = item["entry"]
            kv = entry.get("kv")
            if kv is None:
                # Nothing to transfer (handoff of a KV-less entry) —
                # deliver straight through; the decode pool re-prefills.
                self._deliver(entry, transfer_s=0.0)
                moved += 1
                continue
            rid = int(entry["request_id"])
            nbytes = int(kv.nbytes)
            if not self.channel.fits(nbytes):
                self.channel.refuse(rid, nbytes, "exceeds channel budget")
                self._fallback(entry, "too_large")
                moved += 1
                continue
            t = self.channel.begin(rid, nbytes, kv.checksum())
            if t is None:
                waiting.append(item)  # backpressure: budget spent this tick
                continue
            begun.append((item, t))
        for item, t in begun:
            entry = item["entry"]
            outcome = self.channel.complete(t, entry["kv"], entry=entry)
            if outcome == OK:
                self._observe_stage("transfer", t.latency_s)
                EngineTelemetry.annotate_trace_doc(
                    entry.get("trace"), "handoff_transfer", self.clock(),
                    nbytes=t.nbytes, latency_s=round(t.latency_s, 6),
                )
                self._deliver(entry, transfer_s=t.latency_s)
            else:
                self._fallback(entry, outcome)
            moved += 1
        self._staged = waiting
        return moved

    def _fallback(self, entry: dict, reason: str) -> None:
        """Rung 3 of the ladder: discard the payload, deliver the entry
        KV-less so the decode pool re-prefills (through its prefix cache
        when warm).  The stream itself survives every channel fault."""
        entry.pop("kv", None)
        self.fallbacks += 1
        _M_FALLBACK.inc(reason=reason)
        EngineTelemetry.annotate_trace_doc(
            entry.get("trace"), "handoff_fallback", self.clock(),
            reason=reason,
        )
        JOURNAL.record(
            "disagg", "handoff.fallback",
            correlation=f"req-{entry['request_id']}", reason=reason,
        )
        self._deliver(entry, transfer_s=0.0)

    def _deliver(self, entry: dict, transfer_s: float) -> None:
        """Hand one entry to the decode pool.  ``place()`` merge-restores
        onto a healthy replica or parks at that router — either way the
        stream is owned downstream from here.  A decode pool whose
        transport is down collapses the stream to unified serving
        instead (the last rung — never a lost request)."""
        rid = int(entry["request_id"])
        now = self.clock()
        self._awaiting[rid] = now
        try:
            placed = self.decode.place(
                [entry], correlation=f"handoff-req-{rid}"
            )
        except OSError as exc:  # transport.TransportDownError
            if type(exc).__name__ != "TransportDownError":
                raise
            self._awaiting.pop(rid, None)
            self._unified_collapse(entry, "transport_down")
            return
        if rid in placed:
            self._observe_decode_stage(rid, now)

    def _remote_waiting(self) -> bool:
        """True when some pool has streams outstanding behind a transport
        link that is still ALIVE — remote work the pump must wait out in
        wall time (bounded by the link's liveness window), not a logical
        wedge."""
        for pool in (self.prefill, self.decode):
            link = getattr(pool, "link", None)
            if link is not None and not link.dead and not pool.idle():
                return True
        return False

    def _local_pool(self):
        """The first pool whose engines live in THIS process (no transport
        link) — where unified collapse serves streams when a worker pool
        is unreachable."""
        for pool in (self.decode, self.prefill):
            if not hasattr(pool, "link"):
                return pool
        return None

    def _unified_collapse(self, entry: dict, reason: str) -> None:
        """The last rung of the degradation ladder: the stream's target
        pool is unreachable, so it serves on whatever pool is local —
        disaggregation collapses to unified serving for this stream,
        loudly journaled.  With NO local pool the entry re-parks in the
        staging area and retries after reconnect (the pump stall bound
        keeps a permanently-dead transport from spinning silently)."""
        entry.pop("kv", None)
        entry.pop("_placed_remote", None)
        rid = int(entry["request_id"])
        self._ledger_release(rid)  # the stream leaves the admission path
        self.fallbacks += 1
        _M_FALLBACK.inc(reason="unified_collapse")
        JOURNAL.record(
            "disagg", "handoff.unified_collapse",
            correlation=f"req-{rid}", reason=reason,
        )
        pool = self._local_pool()
        if pool is None:
            self._staged.append({"entry": entry, "staged_at": self.clock()})
            return
        if entry.get("_resubmit"):
            # Submit-time retention (the sampler key died with the worker):
            # re-run the original request locally and alias the new rid
            # back to the one the caller holds.
            try:
                new_rid = pool.submit(
                    entry["prompt"], entry["max_tokens"],
                    **entry.get("kwargs", {}),
                )
            except RuntimeError:  # local pool momentarily full: retry
                self._staged.append({"entry": entry, "staged_at": self.clock()})
                return
            self._rid_alias[new_rid] = rid
            return
        if pool is self.decode:
            self._awaiting[rid] = self.clock()
            demand = self._full_demand_blocks(entry)
            if demand is not None:
                self._ledger_commit(rid, demand)  # back under the ledger
        pool.place([entry], correlation=f"handoff-req-{rid}")

    def _reclaim_failed(self) -> int:
        """Drain streams whose worker pool died (transport.RemotePool
        retains every shipped entry KV-less until its completion lands)
        and re-serve each locally — the zero-loss half of crash
        tolerance; the dead peer's rids are already marked reclaimed so
        its late completions cannot double-deliver."""
        n = 0
        for pool in (self.prefill, self.decode):
            take = getattr(pool, "take_failed", None)
            if not callable(take):
                continue
            for entry in take():
                self._unified_collapse(entry, "peer_died")
                n += 1
        return n

    # -- KV-demand admission --------------------------------------------------
    #
    # The decode pool admits a handoff only if the FULL stream fits: KV
    # blocks for prompt + max_tokens, committed in a reservation ledger
    # covering resident, parked and in-flight streams.  A handoff whose
    # full demand exceeds the uncommitted headroom parks at the prefill
    # side (typed backpressure) instead of landing on a decode replica
    # that will wedge mid-stream when its allocator runs dry.  The
    # ledger mutates ONLY through _ledger_commit/_ledger_release, and
    # _admission_parked ONLY through _park_admission/_unpark_admissions/
    # _deadlock_tick.

    def _decode_block_size(self) -> "int | None":
        """Smallest KV block size across decode replicas, or None when the
        pool is remote/dense/empty — blocks-needed rounds UP, so the
        smallest block size is the conservative (largest) demand."""
        replicas = getattr(self.decode, "replicas", None)
        if not replicas:
            return None
        sizes = []
        for r in replicas:
            eng = r.engine
            if not hasattr(eng, "block_size") or not hasattr(eng, "free_blocks"):
                return None
            sizes.append(int(eng.block_size))
        return min(sizes) if sizes else None

    def _decode_headroom_blocks(self) -> "int | None":
        """Reservable decode blocks minus every committed reservation, or
        None when capacity is not accountable (remote pool, dense
        engines) — admission stands aside rather than guessing."""
        admittable = getattr(self.decode, "admittable_replicas", None)
        if not callable(admittable):
            return None
        total = 0
        for r in admittable():
            # RemotePool replicas carry no local engine: unaccountable.
            cap = getattr(getattr(r, "engine", None), "reservable_blocks", None)
            if cap is None:
                return None
            total += int(cap)
        return total - sum(self._ledger.values())

    def _full_demand_blocks(self, entry: dict) -> "int | None":
        """KV blocks the stream needs at FULL growth (prompt + max_tokens
        — the bound that makes admission deadlock-proof: an admitted
        stream can always finish without waiting on another's blocks)."""
        from k8s_dra_driver_torch.models.serve import full_stream_tokens

        bs = self._decode_block_size()
        if bs is None or bs <= 0:
            return None
        return -(-full_stream_tokens(entry) // bs)

    def _ledger_commit(self, rid: int, blocks: int) -> None:
        self._ledger[int(rid)] = int(blocks)

    def _ledger_release(self, rid) -> None:
        self._ledger.pop(int(rid), None)

    def reserve_pull(self, nonce: int, blocks: int) -> "bool | None":
        """Ledger-gate one remote prefix pull (FleetPrefixTier.pull_gate):
        a pull is KV demand like any stream, so it reserves its receiver
        blocks for the transfer window under NEGATIVE ledger keys (pull
        nonces can never collide with request ids, and the reservation
        automatically weighs on `_decode_headroom_blocks`, so stream
        admission and pull admission contend over one number).  Returns
        True (reserved), False (over-demand: caller falls back to cold
        prefill), or None (capacity unaccountable — bypass, the same
        stand-aside stream admission takes)."""
        headroom = self._decode_headroom_blocks()
        if headroom is None:
            return None
        if int(blocks) > headroom:
            return False
        self._ledger_commit(-int(nonce), int(blocks))
        return True

    def release_pull(self, nonce: int) -> None:
        """Release a pull-window reservation made by `reserve_pull`."""
        self._ledger_release(-int(nonce))

    def _admit_handoff(self, item: dict) -> bool:
        """True iff the decode pool can commit the entry's full-stream KV
        demand (or capacity is not accountable, in which case admission
        stands aside).  Commits the reservation on admit; releases it on
        refusal so a parked stream holds no blocks hostage."""
        if not self.admission_control:
            return True
        entry = item["entry"]
        rid = int(entry["request_id"])
        demand = self._full_demand_blocks(entry)
        headroom = self._decode_headroom_blocks()
        if demand is None or headroom is None:
            return True
        headroom += self._ledger.get(rid, 0)  # re-admitting own reservation
        if demand > headroom:
            self._ledger_release(rid)
            item["demand"] = demand
            return False
        self._ledger_commit(rid, demand)
        return True

    def _park_admission(self, item: dict) -> None:
        rid = int(item["entry"]["request_id"])
        self._admission_parked.append(item)
        _M_ADMISSION_PARKED.set(float(len(self._admission_parked)))
        JOURNAL.record(
            "disagg", "admission.parked",
            correlation=f"req-{rid}",
            demand_blocks=item.get("demand"),
            parked=len(self._admission_parked),
        )

    def _unpark_admissions(self) -> int:
        """Re-admit parked handoffs oldest-first as decode capacity frees.
        FIFO keeps backpressure fair; a large stream at the head does NOT
        let smaller later streams starve it forever (no overtaking)."""
        if not self._admission_parked:
            return 0
        moved = 0
        still: list[dict] = []
        blocked = False
        for item in self._admission_parked:
            if not blocked and self._admit_handoff(item):
                rid = int(item["entry"]["request_id"])
                JOURNAL.record(
                    "disagg", "admission.unparked",
                    correlation=f"req-{rid}",
                    demand_blocks=item.get("demand"),
                )
                self._staged.append(item)
                moved += 1
            else:
                blocked = True  # strict FIFO: later streams never overtake
                still.append(item)
        self._admission_parked = still
        _M_ADMISSION_PARKED.set(float(len(self._admission_parked)))
        return moved

    def _deadlock_tick(self) -> int:
        """Watchdog-integrated deadlock detector: handoffs parked with NO
        admission progress while the decode pool sits idle (nothing
        draining toward freeing blocks) for ``deadlock_ticks``
        consecutive ticks means nothing will EVER free the capacity the
        head-of-line stream needs.  Fire once: dump a diag bundle, then
        force every parked stream down the unified-collapse rung —
        degraded service beats a silent wedge."""
        if not self._admission_parked or self._last_unparked > 0:
            self._starved_ticks = 0
            return 0
        idle = getattr(self.decode, "idle", None)
        if callable(idle) and not idle():
            # Decode still drains resident streams; their completions
            # will release reservations — starvation, not deadlock.
            self._starved_ticks = 0
            return 0
        self._starved_ticks += 1
        if self._starved_ticks < self.deadlock_ticks:
            return 0
        self.deadlock_fired += 1
        self._starved_ticks = 0
        state = {
            "parked": len(self._admission_parked),
            "ledger_streams": len(self._ledger),
            "ledger_blocks": sum(self._ledger.values()),
            "deadlock_ticks": self.deadlock_ticks,
            "router_seq": self.seq,
        }
        try:
            from k8s_dra_driver_torch.utils.watchdog import (
                WATCHDOG, dump_diag_bundle,
            )

            dump_diag_bundle(
                WATCHDOG.bundle_dir,
                reason="disagg_admission_deadlock", state=state,
            )
        except Exception:  # diagnostics never block the forced drain
            pass
        JOURNAL.record("disagg", "admission.deadlock", **state)
        drained, self._admission_parked = self._admission_parked, []
        _M_ADMISSION_PARKED.set(0.0)
        for item in drained:
            self._force_collapse(item["entry"])
        return len(drained)

    def _force_collapse(self, entry: dict) -> None:
        """Deadlock fallback: the decode pool provably cannot hold this
        stream at full growth, so serve it unified on the PREFILL pool
        (KV-less — it re-prefills there).  Remote prefill degrades to the
        ordinary unified-collapse ladder."""
        entry.pop("kv", None)
        rid = int(entry["request_id"])
        self._ledger_release(rid)
        self.fallbacks += 1
        _M_FALLBACK.inc(reason="deadlock_collapse")
        JOURNAL.record(
            "disagg", "handoff.deadlock_collapse", correlation=f"req-{rid}",
        )
        if hasattr(self.prefill, "link"):
            self._unified_collapse(entry, "admission_deadlock")
            return
        self.prefill.place([entry], correlation=f"handoff-req-{rid}")

    # -- TTFT stage attribution ----------------------------------------------

    def _observe_stage(self, stage: str, seconds: float) -> None:
        """Histogram observation PLUS a per-stage accumulator the pool
        rebalancer reads through :meth:`take_stage_attribution`."""
        _M_TTFT_BREAKDOWN.observe(seconds, stage=stage)
        acc = self._stage_acc.setdefault(stage, [0.0, 0])
        acc[0] += float(seconds)
        acc[1] += 1

    def take_stage_attribution(self) -> dict:
        """Drain the per-stage TTFT accumulators since the last call —
        the signal ``autoscaler.PoolRebalancer`` votes on (a move toward
        whichever stage dominates the breakdown)."""
        out = {}
        for stage, (total, n) in self._stage_acc.items():
            out[stage] = {
                "sum_s": total, "n": n,
                "mean_s": (total / n) if n else 0.0,
            }
        self._stage_acc = {}
        return out

    def _observe_decode_stage(self, rid: int, now: float) -> None:
        t = self._awaiting.pop(rid, None)
        if t is not None:
            self._observe_stage("decode", max(0.0, now - t))

    def _remap(self, comps: list) -> list:
        """Restore caller-visible rids on completions of crash-resubmitted
        streams (``_unified_collapse`` re-ran them under fresh local rids)."""
        if not self._rid_alias:
            return comps
        out = []
        for c in comps:
            alias = self._rid_alias.pop(c.request_id, None)
            if alias is not None:
                c = replace(c, request_id=alias)
            out.append(c)
        return out

    def _collect_decode(self) -> list:
        """Decode-pool completions, plus decode-stage latency for entries
        that parked before a replica could take them."""
        out = self.decode.completions()
        now = self.clock()
        for c in out:
            self._ledger_release(c.request_id)  # blocks freed with the stream
        if self._awaiting:
            for rid in [r for r in self._awaiting if r in self.decode._owner]:
                self._observe_decode_stage(rid, now)
            for c in out:
                self._observe_decode_stage(c.request_id, now)
        return out

    # -- externally driven surface (replay drivers, autoscale benches) -------

    def submit(self, prompt, max_tokens: int, **kwargs) -> int:
        """Route one request immediately into the prefill pool (handoff
        mode — the router owns the admission mode, same as :meth:`_admit`).
        Raises RuntimeError when the prefill pool has no admittable
        capacity, the same contract as ``FleetRouter.submit``."""
        kwargs.pop("handoff", None)
        queued_at = kwargs.get("queued_at")
        rid = self.prefill.submit(prompt, max_tokens, handoff=True, **kwargs)
        self._t0[rid] = queued_at if queued_at is not None else self.clock()
        return rid

    def tick(self) -> int:
        """ONE pump iteration without the cross-pool queue: tick the
        prefill pool, move staged KV through the channel, tick the decode
        pool.  Returns the slots stepped.  This mirrors
        ``FleetRouter.tick()`` so :func:`~k8s_dra_driver_torch.models.
        workload.replay` drives unified and disaggregated fleets through
        one surface; completions buffer for :meth:`completions`."""
        self._tick += 1
        stepped = self.prefill.tick()
        self._completions.extend(self._remap(self.prefill.completions()))
        self._collect_handoffs()
        self._drive_channel()
        stepped += self.decode.tick()
        self._completions.extend(self._remap(self._collect_decode()))
        self._reclaim_failed()
        self._deadlock_tick()
        return stepped

    def completions(self) -> list:
        out, self._completions = self._completions, []
        return out

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        """The /debug/disagg contract: pool membership (each pool is a
        full fleet stats doc), the staging area, and the channel budget."""
        return {
            "router_seq": self.seq,
            "tick": self._tick,
            "handoffs": self.handoffs,
            "fallbacks": self.fallbacks,
            "staged": len(self._staged),
            "admission": {
                "parked": len(self._admission_parked),
                "ledger_streams": len(self._ledger),
                "ledger_blocks": sum(self._ledger.values()),
                "starved_ticks": self._starved_ticks,
                "deadlock_fired": self.deadlock_fired,
            },
            "prefill": self.prefill.stats(),
            "decode": self.decode.stats(),
            "channel": self.channel.stats(),
        }


_LIVE_DISAGG: "weakref.WeakSet[DisaggRouter]" = weakref.WeakSet()


def live_disagg_routers() -> list[DisaggRouter]:
    return sorted(list(_LIVE_DISAGG), key=lambda r: r.seq)


def debug_disagg_doc() -> dict:
    """The /debug/disagg payload: every live disagg router's pool
    membership, in-flight transfers and channel budget."""
    return {"disagg": [router.stats() for router in live_disagg_routers()]}
