"""Trace-driven workload generation and compressed-time serving
simulation: ``k8s_dra_driver_tpu/models/workload.py`` whole (lines
1-1147), copied with the port's imports (the port imports nothing of the
JAX package).

* :func:`generate` — the seeded trace: a non-homogeneous Poisson process
  (Lewis–Shedler thinning over the diurnal × flash-crowd rate curve),
  lognormal prompt lengths, Pareto stream lengths and tiered TTFT/TPOT
  SLO targets; :func:`generate_shared_prefix` — the Zipf shared-prefix
  family the fleet prefix tier exists for.  Same seed, same trace as the
  reference's, field for field.
* :class:`SimEngine` — an Engine-protocol replica whose "device" is an
  analytic service model over an injected :class:`SimClock`; generated
  tokens are a pure function of the prompt.  It honours the replica
  contract (snapshot/restore/release, ``handoff=True`` with a
  checksummed :class:`SimKV`, block accounting, an ``EngineStats`` feed).
* :func:`replay` — the compressed-time drive loop over a ``FleetRouter``
  or a ``DisaggRouter``, scoring each completion against its SLO.

Like ``fleet.py`` and ``disagg.py`` this module imports no torch: the
whole sensor→controller→actuator loop runs on the host.
"""

from __future__ import annotations

import math
import random
import time
from collections import deque
from dataclasses import dataclass
from typing import Iterable, Iterator, NamedTuple

from k8s_dra_driver_torch.models.telemetry import EngineStats, terminal_retirer

_COMPLETION = None


def _completion_cls():
    """serve.Completion, imported lazily (serve brings torch; this module
    must stay importable without it) and cached off the hot path."""
    global _COMPLETION
    if _COMPLETION is None:
        from k8s_dra_driver_torch.models.serve import Completion

        _COMPLETION = Completion
    return _COMPLETION

# -- simulated time ----------------------------------------------------------


class SimClock:
    """Manually advanced monotonic clock.  Injectable anywhere the code
    takes ``clock=time.monotonic`` (engines, routers, breakers,
    autoscaler), so one object defines "now" for the whole simulated
    fleet and :func:`replay` compresses hours into ticks."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"SimClock cannot run backwards (dt={dt})")
        self.t += dt
        return self.t


# -- the trace ---------------------------------------------------------------


@dataclass(frozen=True)
class FlashCrowd:
    """A rate spike: the offered load multiplies by ``multiplier`` for
    ``duration_s`` starting at ``start_s``."""

    start_s: float
    duration_s: float
    multiplier: float = 5.0


@dataclass(frozen=True)
class SloTier:
    """One request class: ``weight`` of traffic carrying these targets."""

    weight: float
    ttft_slo_s: float
    tpot_slo_s: float


@dataclass(frozen=True)
class WorkloadSpec:
    """Everything that defines a trace.  Deterministic given ``seed``.

    Documented distribution moments (pinned by tests):

    * prompt length ~ lognormal(mu, sigma): mean ``exp(mu + sigma^2/2)``
      (clipped to ``[1, prompt_len_max]``)
    * stream length ~ ``stream_len_min`` x Pareto(alpha): mean
      ``stream_len_min * alpha / (alpha - 1)`` for alpha > 1 (clipped to
      ``[1, stream_len_max]``)
    * arrival rate at time t:
      ``base_rate_rps * (1 + diurnal_amplitude * sin(2*pi*t/diurnal_period_s))``
      times the multiplier of any active flash crowd
    """

    seed: int = 0
    duration_s: float = 3600.0
    base_rate_rps: float = 8.0
    diurnal_amplitude: float = 0.5
    diurnal_period_s: float = 3600.0
    flash_crowds: tuple = ()
    prompt_len_mu: float = math.log(48.0)
    prompt_len_sigma: float = 0.7
    prompt_len_max: int = 1024
    stream_len_min: int = 8
    stream_len_alpha: float = 2.5
    stream_len_max: int = 512
    slo_tiers: tuple = (
        SloTier(0.5, 1.0, 0.10),    # interactive
        SloTier(0.35, 3.0, 0.25),   # standard
        SloTier(0.15, 10.0, 1.00),  # batch
    )
    vocab: int = 64


class Arrival(NamedTuple):
    """One timestamped submission in a trace.  A NamedTuple rather than a
    frozen dataclass: million-request traces construct one per arrival,
    and tuple construction is ~3x cheaper than ``object.__setattr__``."""

    t: float
    rid: int          # trace sequence number (NOT an engine request id)
    prompt_len: int
    max_tokens: int
    ttft_slo_s: float
    tpot_slo_s: float


def rate_at(spec: WorkloadSpec, t: float) -> float:
    """Offered load (requests/s) at trace time ``t``."""
    r = spec.base_rate_rps * (
        1.0 + spec.diurnal_amplitude
        * math.sin(2.0 * math.pi * t / spec.diurnal_period_s)
    )
    for fc in spec.flash_crowds:
        if fc.start_s <= t < fc.start_s + fc.duration_s:
            r *= fc.multiplier
    return max(r, 0.0)


def peak_rate(spec: WorkloadSpec) -> float:
    base = spec.base_rate_rps * (1.0 + abs(spec.diurnal_amplitude))
    mult = max((fc.multiplier for fc in spec.flash_crowds), default=1.0)
    return max(base * max(mult, 1.0), 1e-9)


def _majorant_segments(spec: WorkloadSpec) -> list[tuple[float, float, float]]:
    """``(start, end, majorant_rate)`` segments covering ``[0, duration)``,
    split at flash-crowd boundaries.  Each segment's majorant bounds
    ``rate_at`` over the segment (diurnal max times the multipliers of
    every crowd overlapping it), so thinning against the SEGMENT majorant
    instead of the global peak avoids rejecting ~(1 - 1/multiplier) of
    all candidates whenever a large flash crowd is configured."""
    edges = {0.0, spec.duration_s}
    for fc in spec.flash_crowds:
        edges.add(min(max(fc.start_s, 0.0), spec.duration_s))
        edges.add(min(max(fc.start_s + fc.duration_s, 0.0), spec.duration_s))
    cuts = sorted(edges)
    diurnal_max = spec.base_rate_rps * (1.0 + abs(spec.diurnal_amplitude))
    segs = []
    for a, b in zip(cuts, cuts[1:]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        m = diurnal_max
        for fc in spec.flash_crowds:
            if fc.start_s <= mid < fc.start_s + fc.duration_s:
                m *= max(fc.multiplier, 1.0)
        segs.append((a, b, max(m, 1e-9)))
    return segs


def generate(spec: WorkloadSpec) -> Iterator[Arrival]:
    """Yield the trace's arrivals in time order.  Non-homogeneous Poisson
    via Lewis–Shedler thinning with a piecewise-constant majorant: within
    each flash-crowd segment, draw candidate gaps at that segment's
    majorant rate and accept each candidate with probability
    ``rate_at(t)/majorant``; candidates that overshoot a segment boundary
    restart at the boundary (the standard interval-by-interval thinning
    construction).  One ``random.Random(seed)`` drives everything, so the
    whole trace — times, lengths, SLO tiers — replays identically from
    its seed."""
    rng = random.Random(spec.seed)
    cum = []
    total_w = sum(t.weight for t in spec.slo_tiers) or 1.0
    acc = 0.0
    for tier in spec.slo_tiers:
        acc += tier.weight / total_w
        cum.append((acc, tier))
    rid = 0
    for seg_start, seg_end, major in _majorant_segments(spec):
        t = seg_start
        while True:
            t += rng.expovariate(major)
            if t >= seg_end:
                break
            if rng.random() * major > rate_at(spec, t):
                continue  # thinned candidate
            plen = int(
                rng.lognormvariate(spec.prompt_len_mu, spec.prompt_len_sigma)
            )
            plen = min(spec.prompt_len_max, max(1, plen))
            slen = int(
                spec.stream_len_min * rng.paretovariate(spec.stream_len_alpha)
            )
            slen = min(spec.stream_len_max, max(1, slen))
            u = rng.random()
            tier = cum[-1][1]
            for edge, cand in cum:
                if u <= edge:
                    tier = cand
                    break
            yield Arrival(
                t=t, rid=rid, prompt_len=plen, max_tokens=slen,
                ttft_slo_s=tier.ttft_slo_s, tpot_slo_s=tier.tpot_slo_s,
            )
            rid += 1


def prompt_tokens(arrival: Arrival, vocab: int = 64, limit: int | None = 24) -> list[int]:
    """The materialized prompt for an arrival: a FIXED-WIDTH base-``vocab``
    encoding of the trace rid followed by a deterministic hash fill.
    The fixed width is what makes every arrival's prompt unique (chaos
    suites match reference and chaos completions by prompt): a variable-
    width prefix can collide with another arrival's fill, because the
    fill is linear mod ``vocab``.  ``limit`` caps materialization for
    million-request runs; the modeled prefill cost still uses the full
    ``prompt_len`` (passed to the engine as ``sim_prompt_len``)."""
    n = arrival.prompt_len if limit is None else min(arrival.prompt_len, limit)
    out: list[int] = []
    r = arrival.rid + 1
    for _ in range(6):  # vocab**6 >= 6.8e10 rids even at vocab=64
        out.append(r % vocab)
        r //= vocab
    base = arrival.rid * 1_000_003 + 12_345
    for i in range(len(out), max(n, len(out) + 1)):
        out.append((base + (i + 1) * 2_654_435_761) % vocab)
    return out


def _token_fn(prompt: list[int], vocab: int):
    """Generated token ``i`` as a pure function of the prompt — the sim's
    "model weights".  Bit-equal across engines, migrations and re-runs
    because nothing but the prompt seeds it."""
    seed = 0
    for tok in prompt:
        seed = (seed * 131 + tok + 7) & 0x7FFFFFFF
    seed = seed * 1_000_003 + len(prompt)

    def tok_at(i: int) -> int:
        return (seed + (i + 1) * 2_654_435_761) % vocab

    return tok_at


# -- the shared-prefix trace family ------------------------------------------


@dataclass(frozen=True)
class SharedPrefixSpec:
    """A trace family where prompts share prefixes the way production
    chat fleets do: a small Zipf-distributed pool of system prompts
    (everyone hits the head of the distribution), and per-user
    conversations whose prompt at turn *t* is a strict prefix-extension
    of turn *t-1* (append-only history).  This is the workload the fleet
    prefix-cache tier (``models/fleet_prefix.py``) exists for — a
    uniform-random trace has no cross-request prefix reuse to exploit.

    Arrival times, stream lengths and SLO tiers come from ``base``
    unchanged; only prompt structure is rewritten.  Deterministic given
    ``base.seed``.
    """

    base: WorkloadSpec = WorkloadSpec()
    n_system_prompts: int = 8
    system_zipf_alpha: float = 1.2
    system_len_tokens: int = 48
    n_users: int = 64
    turn_tokens: int = 16
    max_turns: int = 8


class PrefixArrival(NamedTuple):
    """An :class:`Arrival` superset carrying prefix-structure identity.
    Field order keeps the Arrival fields first, so anything that reads
    arrivals positionally or by the shared attribute names (``replay``
    does the latter) works on both."""

    t: float
    rid: int
    prompt_len: int
    max_tokens: int
    ttft_slo_s: float
    tpot_slo_s: float
    system_id: int
    user_id: int
    turn: int
    system_len: int   # tokens of system prompt at the head
    shared_len: int   # system + conversation history shared with turn-1


def generate_shared_prefix(spec: SharedPrefixSpec) -> Iterator[PrefixArrival]:
    """Yield the shared-prefix trace.  Each base arrival is assigned a
    system prompt (Zipf over the pool: rank ``i`` has weight
    ``1/(i+1)^alpha``) and a user; the (system, user) pair's turn
    counter advances, so the prompt is ``system_len + turn*turn_tokens``
    tokens of which all but the last ``turn_tokens`` are shared with
    the conversation's previous turn.  A second RNG seeded from the base
    seed drives the assignment, so the arrival process itself replays
    byte-identically with or without the prefix structure."""
    rng = random.Random(spec.base.seed ^ 0x5F1EE7)
    weights = [
        1.0 / (i + 1) ** spec.system_zipf_alpha
        for i in range(max(1, spec.n_system_prompts))
    ]
    total = sum(weights)
    cum = []
    acc = 0.0
    for i, w in enumerate(weights):
        acc += w / total
        cum.append((acc, i))
    turns: dict[tuple[int, int], int] = {}
    for a in generate(spec.base):
        u = rng.random()
        sid = cum[-1][1]
        for edge, i in cum:
            if u <= edge:
                sid = i
                break
        uid = rng.randrange(max(1, spec.n_users))
        turn = min(turns.get((sid, uid), 0) + 1, spec.max_turns)
        turns[(sid, uid)] = turn
        shared = spec.system_len_tokens + (turn - 1) * spec.turn_tokens
        yield PrefixArrival(
            t=a.t, rid=a.rid,
            prompt_len=shared + spec.turn_tokens,
            max_tokens=a.max_tokens,
            ttft_slo_s=a.ttft_slo_s, tpot_slo_s=a.tpot_slo_s,
            system_id=sid, user_id=uid, turn=turn,
            system_len=spec.system_len_tokens, shared_len=shared,
        )


def shared_prefix_tokens(
    arrival: PrefixArrival, vocab: int = 64, limit: int | None = None,
) -> list[int]:
    """Materialize a shared-prefix prompt.  Token at position ``i`` is a
    pure function of ``(system_id, i)`` inside the system prompt and of
    ``(system_id, user_id, i)`` in the conversation body — so two
    arrivals with the same system prompt share those tokens byte-for-
    byte, and turn *t*'s prompt is a literal prefix-extension of turn
    *t-1*'s.  That is what lets the REAL engines' prefix stores (keyed
    by token content) hit across requests in this trace, not just the
    identity-keyed simulator."""
    n = arrival.prompt_len if limit is None else min(arrival.prompt_len, limit)
    sys_n = min(arrival.system_len, n)
    sys_base = (arrival.system_id + 1) * 2_654_435_761
    conv_base = (
        (arrival.system_id + 1) * 1_000_003 + (arrival.user_id + 1)
    ) * 2_246_822_519
    out = [(sys_base + (i + 1) * 40_503) % vocab for i in range(sys_n)]
    out.extend(
        (conv_base + (i + 1) * 2_654_435_761) % vocab
        for i in range(sys_n, n)
    )
    return out


def sim_prefix_chain(arrival: PrefixArrival, block_tokens: int):
    """The simulator's candidate chain ``[(n_tokens, material)]`` for an
    arrival: one rung per whole block, shallow->deep, leaving >= 1 token
    to prefill.  Materials are tuples of BLOCK IDENTITIES rather than
    token content — ``("sys", system_id, i)`` for blocks inside the
    system prompt, ``("conv", system_id, user_id, i)`` after it — which
    is safe because :func:`shared_prefix_tokens` makes content a pure
    function of exactly that identity.  A million-request sim never
    materializes token tuples just to hash them."""
    bs = int(block_tokens)
    if bs <= 0:
        return []
    blocks: list[tuple] = []
    chain = []
    d = bs
    while d < arrival.prompt_len:
        i = len(blocks)
        if d <= arrival.system_len:
            blocks.append(("sys", arrival.system_id, i))
        else:
            blocks.append(("conv", arrival.system_id, arrival.user_id, i))
        chain.append((d, tuple(blocks)))
        d += bs
    return chain


# -- the simulated engine ----------------------------------------------------


class SimKV:
    """A prefill KV payload stub with exactly the surface the disagg
    :class:`~k8s_dra_driver_torch.models.disagg.HandoffChannel` meters:
    ``nbytes`` and ``checksum()``."""

    __slots__ = ("nbytes", "_crc")

    def __init__(self, rid: int, prompt_len: int, bytes_per_token: int):
        self.nbytes = int(prompt_len) * int(bytes_per_token)
        self._crc = (rid * 2_654_435_761 + prompt_len) & 0xFFFFFFFF

    def checksum(self) -> int:
        return self._crc


class SimSink:
    """Shared first-token registry: engines report the sim time each
    stream produced its first token; the replay driver pops it to score
    TTFT.  Keyed by request id, which migrations preserve — a restored
    stream with tokens already generated never re-fires."""

    def __init__(self):
        self.first_token_t: dict[int, float] = {}

    def first_token(self, rid: int, t: float) -> None:
        self.first_token_t.setdefault(rid, t)

    def pop(self, rid: int):
        return self.first_token_t.pop(rid, None)


class SimEngine:
    """Engine-protocol replica over an analytic service model.

    Service model (all times in :class:`SimClock` seconds):

    * prefill: ``prompt_len / prefill_tps`` seconds before the first
      token (skipped when a restored entry arrives with a KV payload —
      the disagg happy path — and re-paid when it arrives KV-less).
    * decode: ``decode_tps`` tokens/s per slot, degraded by a
      co-residency interference factor ``1 + interference*(resident-1)``
      — an overloaded replica visibly slows, which is the signal the
      autoscaler's utilization/latency verdicts key on.
    * blocks: ``ceil((prompt_len + max_tokens)/block_tokens)`` reserved
      at admission, released at retirement — the same conservative
      accounting as the paged engine, so chaos suites can assert balance.

    The stats feed satisfies the fleet router's health detectors by
    construction: ``uptime_s`` strictly advances on every read (a
    nanosecond epsilon per read on top of sim time), ``bursts``
    advances on every ``step_burst``, and ``heartbeat_age_s`` tracks the
    last admission/progress.  Driving it requires advancing the shared
    SimClock between ticks — :func:`replay` owns that; ``pump`` does it
    for standalone use.
    """

    def __init__(
        self,
        *,
        clock,
        n_slots: int = 8,
        n_blocks: int = 512,
        block_tokens: int = 16,
        prefill_tps: float = 2000.0,
        decode_tps: float = 40.0,
        interference: float = 0.15,
        kv_bytes_per_token: int = 2048,
        sync_interval: int = 8,
        vocab: int = 64,
        sink: SimSink | None = None,
        step_dt: float = 0.05,
        name: str = "sim",
        prefix_block_tokens: int = 0,
        prefix_cache_blocks: int = 64,
        prefix_index=None,
        pull_gbps: float = 8.0,
    ):
        self.clock = clock
        self.n_slots = int(n_slots)
        self.n_blocks = int(n_blocks)
        self.block_tokens = int(block_tokens)
        self.prefill_tps = float(prefill_tps)
        self.decode_tps = float(decode_tps)
        self.interference = float(interference)
        self.kv_bytes_per_token = int(kv_bytes_per_token)
        self.sync_interval = int(sync_interval)
        self.vocab = int(vocab)
        self.sink = sink
        self.step_dt = float(step_dt)
        # -- fleet prefix-cache model (ROADMAP item 3 / fleet_prefix.py).
        # prefix_block_tokens > 0 turns it on: submit() then accepts a
        # `prefix_chain` of (n_tokens, material) rungs (sim_prefix_chain),
        # keeps an identity-keyed LRU standing in for the engine's prefix
        # store, and — when a FleetPrefixIndex is attached — publishes
        # rungs as kv_dtype="sim" entries and models cross-replica pulls
        # as wire time added to prefill_s.
        self.name = str(name)
        self.prefix_block_tokens = int(prefix_block_tokens)
        self.prefix_cache_blocks = int(prefix_cache_blocks)
        self.prefix_index = prefix_index
        self.pull_gbps = float(pull_gbps)
        self._prefix_store: dict = {}  # material -> n_tokens, dict order = LRU
        self.prefix_hits = {"local": 0, "remote": 0, "cold": 0}
        self._next_id = 0
        self._active: dict[int, dict] = {}
        self._completions: list = []
        self._handoffs: list[dict] = []
        self._free_blocks = self.n_blocks
        self.bursts = 0
        self.host_syncs = 0
        self.tokens_generated = 0
        self._completed = 0
        self._statuses: dict[str, int] = {}
        self._created_at = clock()
        self._last_burst_t = self._created_at
        self._last_progress_t = self._created_at
        self._last_step_s = 0.0
        self._stat_reads = 0
        self._ttft: deque = deque(maxlen=128)
        self._tpot: deque = deque(maxlen=128)
        self._pct_cache: tuple | None = None
        self._pct_burst = -1

    # -- admission ---------------------------------------------------------

    def free_slots(self) -> int:
        return self.n_slots - len(self._active)

    def _blocks_for(self, prompt_len: int, max_tokens: int) -> int:
        return -(-(prompt_len + max_tokens) // self.block_tokens)

    def submit(
        self,
        prompt,
        max_tokens: int,
        ttft_slo_s: float | None = None,
        tpot_slo_s: float | None = None,
        queued_at: float | None = None,
        handoff: bool = False,
        sim_prompt_len: int | None = None,
        prefix_chain=None,
    ) -> int:
        if self.free_slots() <= 0:
            raise RuntimeError("no free slot")
        prompt = list(prompt)
        plen = int(sim_prompt_len) if sim_prompt_len else len(prompt)
        need = self._blocks_for(plen, max_tokens)
        if need > self._free_blocks:
            raise RuntimeError(
                f"out of blocks ({need} needed, {self._free_blocks} free)"
            )
        cached, pull_s = 0, 0.0
        if self.prefix_block_tokens > 0 and prefix_chain:
            cached, pull_s = self._prefix_lookup(prefix_chain)
            cached = min(cached, plen - 1)  # >= 1 token always prefills
            self._prefix_publish(prefix_chain)
        rid = self._next_id
        self._next_id += 1
        now = self.clock()
        self._free_blocks -= need
        self._active[rid] = {
            "request_id": rid,
            "tokens": prompt,
            "generated": [],
            "max_tokens": int(max_tokens),
            "prompt_len": plen,
            "prefill_s": (plen - cached) / self.prefill_tps + pull_s,
            "credit": 0.0,
            "blocks": need,
            "handoff": bool(handoff),
            "ttft_slo_s": ttft_slo_s,
            "tpot_slo_s": tpot_slo_s,
            "queued_at": queued_at if queued_at is not None else now,
            "t_first": None,
            "tok_at": _token_fn(prompt, self.vocab),
        }
        self._last_progress_t = now
        return rid

    # -- the prefix-cache model --------------------------------------------

    def _prefix_lookup(self, chain) -> tuple[int, float]:
        """(cached_tokens, pull_seconds) for a chain: deepest local rung
        first (free), else the deepest compatible remote owner in the
        attached index, costing the prefix bytes over a ``pull_gbps``
        wire.  Mirrors FleetPrefixTier.prepare's ladder in analytic
        form — every miss lands on cold prefill."""
        for d, material in reversed(list(chain)):
            if material in self._prefix_store:
                # LRU touch: re-insert at the back.
                self._prefix_store[material] = self._prefix_store.pop(material)
                self.prefix_hits["local"] += 1
                if self.prefix_index is not None:
                    self.prefix_index.note_hit("local")
                return d, 0.0
        index = self.prefix_index
        if index is None:
            self.prefix_hits["cold"] += 1
            return 0, 0.0
        ent = index.deepest(
            chain, 0,
            compatible=lambda e: e.kv_dtype == "sim" and e.owner != self.name,
        )
        if ent is None:
            self.prefix_hits["cold"] += 1
            return 0, 0.0
        pull_s = ent.n_tokens * self.kv_bytes_per_token * 8.0 / (
            self.pull_gbps * 1e9
        )
        self.prefix_hits["remote"] += 1
        index.note_hit("remote")
        return ent.n_tokens, pull_s

    def _prefix_publish(self, chain) -> None:
        """After admission every rung is (or will be, once this prompt
        prefills) resident here — the sim collapses that to publish-at-
        admission, the same simplification as its analytic prefill.
        Each rung is one store block; LRU overflow withdraws from the
        index exactly like the real engines' on_prefix_evict hook."""
        store = self._prefix_store
        for d, material in chain:
            if material in store:
                store[material] = store.pop(material)
            else:
                store[material] = d
            if self.prefix_index is not None:
                self.prefix_index.publish(
                    material, self.name, n_tokens=d,
                    block_size=self.prefix_block_tokens, kv_dtype="sim",
                )
        while len(store) > self.prefix_cache_blocks:
            material = next(iter(store))
            del store[material]
            if self.prefix_index is not None:
                self.prefix_index.withdraw(material, owner=self.name)

    # -- stepping ----------------------------------------------------------

    def step_burst(self) -> int:
        now = self.clock()
        dt = now - self._last_burst_t
        self._last_burst_t = now
        self.bursts += 1
        self.host_syncs += 1
        self._last_step_s = max(dt, 0.0)
        n_res = len(self._active)
        if n_res == 0 or dt <= 0:
            return n_res
        slow = 1.0 + self.interference * (n_res - 1)
        tps = self.decode_tps / slow
        progressed = False
        sink = self.sink
        for rid, st in list(self._active.items()):
            budget = dt
            if st["prefill_s"] > 0.0:
                used = min(st["prefill_s"], budget)
                st["prefill_s"] -= used
                budget -= used
                progressed = True
                if budget <= 0.0:
                    continue
            st["credit"] += budget * tps
            # Handoff mode retires at the FIRST token (the prefill pool
            # never decodes past it — models/disagg.py owns the rest).
            limit = 1 if st["handoff"] else st["max_tokens"]
            gen = st["generated"]
            base = len(gen)
            n_new = min(int(st["credit"]), limit - base)
            if n_new <= 0:
                continue
            st["credit"] -= n_new
            tok_at = st["tok_at"]
            gen.extend([tok_at(base + i) for i in range(n_new)])
            self.tokens_generated += n_new
            progressed = True
            if base == 0:
                st["t_first"] = now
                if sink is not None:
                    sink.first_token(rid, now)
                self._ttft.append(max(0.0, now - st["queued_at"]))
            if st["handoff"]:
                self._stage_handoff(rid, st)
                continue
            if len(st["generated"]) >= st["max_tokens"]:
                self._finish(rid, st, now)
        if progressed:
            self._last_progress_t = now
        return n_res

    def _finish(self, rid: int, st: dict, now: float) -> None:
        Completion = _completion_cls()

        del self._active[rid]
        self._free_blocks += st["blocks"]
        if st["t_first"] is not None and len(st["generated"]) > 1:
            self._tpot.append(
                (now - st["t_first"]) / (len(st["generated"]) - 1)
            )
        self._completed += 1
        self._statuses["ok"] = self._statuses.get("ok", 0) + 1
        self._completions.append(Completion(
            request_id=rid,
            tokens=st["tokens"] + st["generated"],
            generated=st["generated"],
            status="ok",
        ))

    def _stage_handoff(self, rid: int, st: dict) -> None:
        """First-token retirement in handoff mode: the slot and blocks
        free NOW, the stream rides out through :meth:`take_handoffs` as a
        snapshot entry carrying its KV payload."""
        del self._active[rid]
        self._free_blocks += st["blocks"]
        self._handoffs.append(self._entry(st, kv=SimKV(
            rid, st["prompt_len"], self.kv_bytes_per_token,
        )))

    def take_handoffs(self) -> list[dict]:
        out, self._handoffs = self._handoffs, []
        return out

    def completions(self) -> list:
        out, self._completions = self._completions, []
        return out

    @terminal_retirer
    def cancel(self, request_id: int) -> bool:
        from k8s_dra_driver_torch.models.serve import Completion

        st = self._active.pop(request_id, None)
        if st is None:
            return False
        self._free_blocks += st["blocks"]
        self._completed += 1
        self._statuses["cancelled"] = self._statuses.get("cancelled", 0) + 1
        self._completions.append(Completion(
            request_id=request_id,
            tokens=st["tokens"] + st["generated"],
            generated=st["generated"],
            error="cancelled",
            status="cancelled",
        ))
        return True

    # -- snapshot / restore / release (live migration) ---------------------

    def _entry(self, st: dict, kv=None) -> dict:
        entry = {
            "request_id": st["request_id"],
            "tokens": list(st["tokens"]),
            "generated": list(st["generated"]),
            "max_tokens": st["max_tokens"],
            "prompt_len": st["prompt_len"],
            "prefill_s": st["prefill_s"],
            "ttft_slo_s": st["ttft_slo_s"],
            "tpot_slo_s": st["tpot_slo_s"],
            "queued_at": st["queued_at"],
            "t_first": st["t_first"],
        }
        if kv is not None:
            entry["kv"] = kv
        return entry

    def snapshot_active(self) -> dict:
        return {
            "engine": type(self).__name__,
            "next_id": self._next_id,
            "requests": [self._entry(st) for st in self._active.values()],
        }

    def restore(self, snapshot: dict, merge: bool = False) -> list[int]:
        entries = list(snapshot.get("requests", ()))
        if not merge and self._active:
            raise RuntimeError("restore needs an idle engine (use merge=True)")
        # Atomic capacity check BEFORE any mutation: the fleet's placement
        # path assumes a raising restore() restored nothing.
        if len(entries) > self.free_slots():
            raise RuntimeError(
                f"restore needs {len(entries)} slots, {self.free_slots()} free"
            )
        need = sum(
            self._blocks_for(int(e["prompt_len"]), int(e["max_tokens"]))
            for e in entries
        )
        if need > self._free_blocks:
            raise RuntimeError(
                f"restore needs {need} blocks, {self._free_blocks} free"
            )
        self._next_id = max(self._next_id, int(snapshot.get("next_id", 0)))
        restored: list[int] = []
        now = self.clock()
        for e in entries:
            rid = int(e["request_id"])
            prompt = list(e["tokens"])
            kv = e.get("kv")
            generated = list(e.get("generated", ()))
            # No KV payload means this engine must rebuild the KV cache
            # by re-prefilling prompt + resumed tokens — the real
            # engines' restore path does exactly that.  A delivered
            # handoff payload (disagg happy path) skips it entirely.
            if kv is None:
                prefill_s = (
                    int(e["prompt_len"]) + len(generated)
                ) / self.prefill_tps
            else:
                prefill_s = 0.0
            blocks = self._blocks_for(int(e["prompt_len"]), int(e["max_tokens"]))
            self._free_blocks -= blocks
            self._active[rid] = {
                "request_id": rid,
                "tokens": prompt,
                "generated": generated,
                "max_tokens": int(e["max_tokens"]),
                "prompt_len": int(e["prompt_len"]),
                "prefill_s": prefill_s,
                "credit": 0.0,
                "blocks": blocks,
                "handoff": False,  # a restored stream decodes to completion
                "ttft_slo_s": e.get("ttft_slo_s"),
                "tpot_slo_s": e.get("tpot_slo_s"),
                "queued_at": float(e.get("queued_at", now)),
                "t_first": e.get("t_first"),
                "tok_at": _token_fn(prompt, self.vocab),
            }
            restored.append(rid)
        if restored:
            self._last_progress_t = now
        return restored

    def release_active(self) -> int:
        n = len(self._active)
        for st in self._active.values():
            self._free_blocks += st["blocks"]
        self._active.clear()
        return n

    # -- standalone pump (protocol conformance) ----------------------------

    def pump(self, requests, max_steps: int = 100_000,
             queue_limit: int | None = None) -> list:
        queue = []
        for r in requests:
            if isinstance(r, dict):
                queue.append(dict(r))
            else:
                prompt, max_tokens = r
                queue.append({"prompt": list(prompt), "max_tokens": max_tokens})
        out: list = []
        allowed = {
            "prompt", "max_tokens", "ttft_slo_s", "tpot_slo_s",
            "queued_at", "handoff", "sim_prompt_len", "prefix_chain",
        }
        for _ in range(max_steps):
            while queue:
                kw = {k: v for k, v in queue[0].items() if k in allowed}
                try:
                    self.submit(**kw)
                except RuntimeError:
                    break
                queue.pop(0)
            if isinstance(self.clock, SimClock):
                self.clock.advance(self.step_dt)
            self.step_burst()
            out.extend(self.completions())
            if not queue and not self._active:
                return out
        raise RuntimeError(f"sim pump did not drain in {max_steps} steps")

    # -- the load-signal contract ------------------------------------------

    def _percentiles(self) -> tuple:
        if self._pct_cache is not None and self.bursts - self._pct_burst < 4:
            return self._pct_cache
        self._pct_burst = self.bursts

        def q(samples, frac):
            if not samples:
                return 0.0
            ordered = sorted(samples)
            return ordered[min(len(ordered) - 1, int(frac * len(ordered)))]

        ttft = list(self._ttft)
        tpot = list(self._tpot)
        self._pct_cache = (
            q(ttft, 0.5), q(ttft, 0.9), q(ttft, 0.99),
            q(tpot, 0.5), q(tpot, 0.9), q(tpot, 0.99),
        )
        return self._pct_cache

    def stats(self) -> EngineStats:
        now = self.clock()
        # uptime must STRICTLY advance between reads (the router's
        # stale-feed detector contract) even if the caller forgot to
        # advance the SimClock between ticks.
        self._stat_reads += 1
        p = self._percentiles()
        return EngineStats(
            engine=type(self).__name__,
            engine_seq=id(self) & 0xFFFF,
            n_slots=self.n_slots,
            resident_slots=len(self._active),
            free_slots=self.free_slots(),
            queue_depth=0,
            admitting=0,
            preempted=0,
            free_blocks=self._free_blocks,
            quarantined=0,
            shed_count=0,
            in_flight=len(self._active),
            completed=self._completed,
            statuses=dict(self._statuses),
            tokens_generated=self.tokens_generated,
            bursts=self.bursts,
            host_syncs=self.host_syncs,
            last_step_s=self._last_step_s,
            sync_interval=self.sync_interval,
            uptime_s=(now - self._created_at) + self._stat_reads * 1e-9,
            heartbeat_age_s=max(0.0, now - self._last_progress_t),
            ttft_p50_s=p[0], ttft_p90_s=p[1], ttft_p99_s=p[2],
            tpot_p50_s=p[3], tpot_p90_s=p[4], tpot_p99_s=p[5],
            queue_wait_p50_s=0.0, queue_wait_p90_s=0.0,
        )


# -- the compressed-time replay driver ---------------------------------------


@dataclass
class ReplayReport:
    """What one trace replay measured.  ``slo_attainment`` is the
    fraction of OFFERED requests that completed within both their TTFT
    and TPOT targets — sheds and losses count against it, so the metric
    cannot be gamed by dropping load."""

    offered: int = 0
    completed: int = 0
    shed: int = 0
    lost: int = 0
    attained: int = 0
    slo_attainment: float = 0.0
    ttft_miss: int = 0
    tpot_miss: int = 0
    ticks: int = 0
    sim_s: float = 0.0
    wall_s: float = 0.0
    tokens: int = 0
    mean_replicas: float = 0.0
    max_replicas: int = 0
    ttft_p50_s: float = 0.0
    ttft_p99_s: float = 0.0
    peak_backlog: int = 0

    def to_json(self) -> dict:
        return {
            k: (round(v, 6) if isinstance(v, float) else v)
            for k, v in self.__dict__.items()
        }


def _live_replica_count(router) -> int:
    reps = getattr(router, "replicas", None)
    if reps is not None:
        return sum(1 for r in reps if r.state != "drained")
    # DisaggRouter: both pools count toward the replica budget.
    return _live_replica_count(router.prefill) + _live_replica_count(router.decode)


def replay(
    trace: Iterable[Arrival],
    router,
    *,
    clock: SimClock,
    sink: SimSink,
    autoscaler=None,
    dt: float = 0.1,
    queue_limit: int = 1024,
    settle_s: float = 1200.0,
    vocab: int = 64,
    prompt_limit: int | None = 24,
    on_completion=None,
    burn_monitor=None,
    tokens_fn=None,
    submit_extra=None,
) -> ReplayReport:
    """Drive ``router`` (FleetRouter or DisaggRouter) through a trace in
    simulated time.  Per tick: advance the clock, move due arrivals into
    a bounded driver backlog (overflow sheds newest-first — an SLO miss
    by definition), admit head-first through ``router.submit``, tick the
    router (and the autoscaler, handing it the backlog depth as the
    fleet queue signal), then score completions against their SLO
    targets.  Returns when every offered request is accounted for —
    completed, shed, or (after ``settle_s`` of simulated drain time)
    counted lost.  ``on_completion(completion)`` fires once per scored
    completion — the chaos suite uses it to prove bit-equality against
    an unfaulted reference without the driver retaining millions of
    completion objects.  ``burn_monitor`` (an
    ``obs_plane.SloBurnRateMonitor``) is fed every scored verdict in
    simulated time and ticked per replay tick, so the burn-rate windows
    evaluate against the same clock the SLOs are scored on.
    ``tokens_fn(arrival, vocab, limit)`` overrides prompt
    materialization (shared-prefix traces use
    :func:`shared_prefix_tokens`); ``submit_extra(arrival)`` returns
    extra ``router.submit`` kwargs per arrival — the fleet prefix bench
    threads ``prefix_chain`` through it."""
    if tokens_fn is None:
        tokens_fn = prompt_tokens
    rep = ReplayReport()
    wall0 = time.perf_counter()
    arrivals = iter(trace)
    backlog: deque[Arrival] = deque()
    in_flight: dict[int, Arrival] = {}
    ttft_samples: list[float] = []
    sample_rng = random.Random(0xA5CA1E)
    nxt = next(arrivals, None)
    replica_ticks = 0.0
    drained_since = None
    last_progress_t = clock()
    while True:
        now = clock.advance(dt)
        rep.ticks += 1
        while nxt is not None and nxt.t <= now:
            rep.offered += 1
            backlog.append(nxt)
            nxt = next(arrivals, None)
        while len(backlog) > queue_limit:
            a_shed = backlog.pop()  # newest-first, same policy as the fleet queue
            rep.shed += 1
            if burn_monitor is not None:
                # A shed is an SLO miss by definition — it burns budget.
                burn_monitor.observe(
                    now, burn_monitor.classify_tier(a_shed.ttft_slo_s), False,
                )
        while backlog:
            a = backlog[0]
            try:
                rid = router.submit(
                    tokens_fn(a, vocab, prompt_limit), a.max_tokens,
                    ttft_slo_s=a.ttft_slo_s, tpot_slo_s=a.tpot_slo_s,
                    queued_at=a.t, sim_prompt_len=a.prompt_len,
                    **(submit_extra(a) if submit_extra is not None else {}),
                )
            except RuntimeError:
                break  # no admittable capacity: the head waits
            in_flight[rid] = a
            backlog.popleft()
            last_progress_t = now
        rep.peak_backlog = max(rep.peak_backlog, len(backlog))
        router.tick()
        if burn_monitor is not None:
            # Evaluate BEFORE the autoscaler tick so a freshly-fired
            # alert is visible to this tick's scale vote.
            burn_monitor.tick(now)
        if autoscaler is not None:
            autoscaler.tick(queue_depth=len(backlog))
        live = _live_replica_count(router)
        replica_ticks += live
        rep.max_replicas = max(rep.max_replicas, live)
        for c in router.completions():
            last_progress_t = now
            if on_completion is not None:
                on_completion(c)  # sees EVERY emission, even unscored ones
            a = in_flight.pop(c.request_id, None)
            if a is None:
                continue  # a shed/typed reject without a scored arrival
            rep.completed += 1
            rep.tokens += len(c.generated)
            t_first = sink.pop(c.request_id)
            if c.status != "ok" or t_first is None:
                continue  # terminal non-ok: an SLO miss by definition
            ttft = t_first - a.t
            tpot = (
                (now - t_first) / (len(c.generated) - 1)
                if len(c.generated) > 1 else 0.0
            )
            ok_ttft = ttft <= a.ttft_slo_s
            ok_tpot = tpot <= a.tpot_slo_s
            if burn_monitor is not None:
                burn_monitor.observe(
                    now,
                    burn_monitor.classify_tier(a.ttft_slo_s),
                    ok_ttft and ok_tpot,
                )
            if ok_ttft and ok_tpot:
                rep.attained += 1
            if not ok_ttft:
                rep.ttft_miss += 1
            if not ok_tpot:
                rep.tpot_miss += 1
            if len(ttft_samples) < 4096:
                ttft_samples.append(ttft)
            else:
                j = sample_rng.randrange(rep.completed)
                if j < 4096:
                    ttft_samples[j] = ttft
        if nxt is None and not backlog and not in_flight:
            break
        if nxt is None and not backlog:
            drained_since = drained_since if drained_since is not None else now
            if now - drained_since > settle_s:
                rep.lost = len(in_flight)  # wedged streams: loud, not silent
                break
        else:
            drained_since = None
            if now - last_progress_t > settle_s:
                # Nothing admitted or completed for a whole settle window
                # while work waits: the fleet is gone or wedged.  Stop
                # loudly instead of ticking forever.
                rep.lost = len(in_flight) + len(backlog)
                break
    rep.sim_s = now
    rep.wall_s = time.perf_counter() - wall0
    rep.mean_replicas = replica_ticks / max(1, rep.ticks)
    rep.slo_attainment = rep.attained / max(1, rep.offered)
    if ttft_samples:
        ordered = sorted(ttft_samples)
        rep.ttft_p50_s = ordered[int(0.5 * (len(ordered) - 1))]
        rep.ttft_p99_s = ordered[int(0.99 * (len(ordered) - 1))]
    return rep
