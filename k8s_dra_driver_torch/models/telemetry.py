"""Request-lifecycle telemetry for the port's serving engines
(``k8s_dra_driver_tpu/models/telemetry.py``, copied with the port's own
``utils/metrics``, ``utils/journal`` and ``utils/tracing``: the port
imports nothing of the JAX package).

One :class:`EngineTelemetry` rides on each engine (``models/serve.ServeEngine``
and ``models/paged.PagedServeEngine``) and turns the host-side sync points
the engine already has into a per-request timeline and SLO histograms,
without a single added device-to-host read:

* ``submit()`` and activation already read the first generated token back:
  that boundary stamps ``submitted_at``, ``admitted_at`` and
  ``first_token_at``;
* ``step()``, ``step_burst()`` and the speculative round already read the
  burst back once per K tokens: ``burst_begin``/``burst_end`` bracket that
  window on the host, outside the CUDA graph the burst replays, and every
  token committed inside it shares the burst's two clock reads;
* retirement is host bookkeeping: ``on_retire`` stamps the terminal status
  and observes the SLO histograms with a ``status=`` label.

Telemetry on and off give the same ``host_syncs`` (held by the CPU tests
and by ``chip_smoke.py``'s twin check on the card).

Timeline (host monotonic clock, injectable for tests): ``queued_at``
(entered the pump's queue; ``submitted_at`` for a direct ``submit()``),
``submitted_at`` (``submit()`` entry), ``admitted_at`` (the slot went live;
with chunked prefill, the final chunk, each earlier chunk an event),
``first_token_at`` (== ``admitted_at``), ``retired_at``.  Derived:
``queue_wait = submitted_at - queued_at``, ``ttft = first_token_at -
queued_at``, ``tpot = (retired_at - first_token_at) / (generated - 1)``,
``e2e = retired_at - queued_at``.

A snapshot entry carries its trace (``export_trace``) and the restoring
engine rebuilds it (``import_trace``), so a request that moves between
engines, of either package, keeps one contiguous timeline with a
``migrations`` count.  :class:`EngineStats` is the per-engine load signal
a fleet router reads (``Engine.stats()``, ``models/fleet``); its fields are
the reference's, in the reference's order.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field

from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.metrics import REGISTRY
from k8s_dra_driver_torch.utils.tracing import TRACER, TRACES, Span

# SLO histograms (the request-latency counterpart of the control plane's
# dra_node_prepare_seconds).  Every observation carries the request's
# TERMINAL status label — "ok", "deadline_exceeded", "cancelled",
# "quarantined", "error" — so a dashboard can split healthy latency from
# failure latency without a second metric family.
_M_TTFT = REGISTRY.histogram(
    "tpu_serve_ttft_seconds",
    "request arrival to first generated token, by terminal status",
)
_M_TPOT = REGISTRY.histogram(
    "tpu_serve_tpot_seconds",
    "mean seconds per generated token after the first, by terminal status",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0),
)
_M_QUEUE_WAIT = REGISTRY.histogram(
    "tpu_serve_queue_wait_seconds",
    "time spent in the pump admission queue, by terminal status",
)
_M_E2E = REGISTRY.histogram(
    "tpu_serve_e2e_seconds",
    "request arrival to retirement, by terminal status",
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
             60.0),
)
# Per-burst batch shape: how full the batch ran and how many tokens one
# sync amortized — the two numbers that say whether an engine is worth
# routing more load to.
_M_BURST_TOKENS = REGISTRY.histogram(
    "tpu_serve_burst_committed_tokens",
    "tokens committed per decode burst (one host sync each)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
)
_M_BATCH_OCC = REGISTRY.gauge(
    "tpu_serve_batch_occupancy",
    "slots that participated in the last decode burst",
)

# Bounds on per-engine retained state: telemetry must never become the
# memory leak it exists to debug.
MAX_DONE_TRACES = 256     # retired traces kept queryable per engine
MAX_BURSTS_PER_TRACE = 128
MAX_EVENTS_PER_TRACE = 64

# Live engines (via their telemetry objects — engine dataclasses define
# __eq__ and so are unhashable) for the process-wide view of
# ``debug_serve_doc``.
_LIVE: "weakref.WeakSet[EngineTelemetry]" = weakref.WeakSet()
_SEQ_LOCK = threading.Lock()
_SEQ = 0


def _next_seq() -> int:
    global _SEQ
    with _SEQ_LOCK:
        _SEQ += 1
        return _SEQ


def terminal_retirer(fn):
    """Marks ``fn`` as a constructor of terminal Completions (status
    deadline_exceeded/cancelled/quarantined/shed/error): every terminal
    path speaks through these functions, so none drops its journal record
    or its telemetry.  Runtime cost is one attribute."""
    fn.__terminal_retirer__ = True
    return fn


def _quantile(samples: list[float], q: float) -> float:
    if not samples:
        return 0.0
    ordered = sorted(samples)
    idx = min(len(ordered) - 1, int(q * len(ordered)))
    return ordered[idx]


@dataclass
class RequestTrace:
    """One request's lifecycle, stamped only at burst boundaries."""

    request_id: int
    prompt_len: int = 0
    max_tokens: int = 0
    deadline: int | None = None
    adapter: int = 0
    queued_at: float | None = None
    submitted_at: float | None = None
    admitted_at: float | None = None
    first_token_at: float | None = None
    retired_at: float | None = None
    status: str = ""          # empty while in flight
    generated: int = 0
    admission_chunks: int = 0
    migrations: int = 0       # snapshot/restore hops; 0 = born here
    engines: list[str] = field(default_factory=list)
    bursts: list[dict] = field(default_factory=list)
    bursts_dropped: int = 0
    events: list[dict] = field(default_factory=list)

    # -- derived SLO values (None until the anchors exist) ------------------
    def queue_wait_s(self) -> float | None:
        if self.queued_at is None or self.submitted_at is None:
            return None
        return self.submitted_at - self.queued_at

    def ttft_s(self) -> float | None:
        if self.queued_at is None or self.first_token_at is None:
            return None
        return self.first_token_at - self.queued_at

    def tpot_s(self) -> float | None:
        if (
            self.first_token_at is None
            or self.retired_at is None
            or self.generated < 2
        ):
            return None
        return (self.retired_at - self.first_token_at) / (self.generated - 1)

    def e2e_s(self) -> float | None:
        if self.queued_at is None or self.retired_at is None:
            return None
        return self.retired_at - self.queued_at

    def add_burst(self, rec: dict) -> None:
        if len(self.bursts) >= MAX_BURSTS_PER_TRACE:
            self.bursts_dropped += 1
            return
        self.bursts.append(rec)

    def add_event(self, name: str, t: float, **attrs) -> None:
        if len(self.events) < MAX_EVENTS_PER_TRACE:
            self.events.append({"event": name, "t": t, **attrs})

    def to_json(self) -> dict:
        doc = dataclasses.asdict(self)
        doc["queue_wait_s"] = self.queue_wait_s()
        doc["ttft_s"] = self.ttft_s()
        doc["tpot_s"] = self.tpot_s()
        doc["e2e_s"] = self.e2e_s()
        return doc

    def summary(self) -> dict:
        """The last-N view diag bundles embed: derived SLO values and
        counts, no per-burst list."""
        return {
            "request_id": self.request_id,
            "status": self.status or "in-flight",
            "generated": self.generated,
            "queue_wait_s": self.queue_wait_s(),
            "ttft_s": self.ttft_s(),
            "tpot_s": self.tpot_s(),
            "e2e_s": self.e2e_s(),
            "bursts": len(self.bursts),
            "migrations": self.migrations,
            "admission_chunks": self.admission_chunks,
        }

    @classmethod
    def from_json(cls, doc: dict) -> "RequestTrace":
        known = {f.name for f in dataclasses.fields(cls)}
        kept = {k: v for k, v in doc.items() if k in known}
        kept["request_id"] = int(kept.get("request_id", -1))
        return cls(**kept)


@dataclass
class EngineStats:
    """The routing-telemetry contract: one engine's load and latency in a
    single JSON-serializable snapshot: the fields of the reference's
    ``EngineStats``, in its order.  A fleet router's health verdicts
    (stalls, heartbeat age, quarantines) and placement read it."""

    engine: str
    engine_seq: int
    n_slots: int
    resident_slots: int
    free_slots: int
    queue_depth: int
    admitting: int
    preempted: int
    free_blocks: int | None
    quarantined: int
    shed_count: int
    in_flight: int
    completed: int
    statuses: dict
    tokens_generated: int
    bursts: int
    host_syncs: int
    last_step_s: float
    sync_interval: int
    uptime_s: float
    # seconds since this engine last made observable progress (admission
    # or a burst replay) — the watchdog-heartbeat half of the fleet
    # router's health verdict: a large age with resident slots means the
    # engine is wedged, not idle.
    heartbeat_age_s: float
    ttft_p50_s: float
    ttft_p90_s: float
    ttft_p99_s: float
    tpot_p50_s: float
    tpot_p90_s: float
    tpot_p99_s: float
    queue_wait_p50_s: float
    queue_wait_p90_s: float

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class EngineTelemetry:
    """Per-engine request-lifecycle recorder.

    Every method is host-only (dict/deque/clock work — no tensor, no
    device traffic) and early-outs when ``enabled`` is False, so the twin-engine
    overhead guard measures exactly the bookkeeping cost.  ``clock`` is
    injectable (tests drive a fake monotonic clock); it is read ONLY at
    boundaries the engine already synchronizes at.
    """

    def __init__(self, engine, enabled: bool = True, clock=time.monotonic):
        self.enabled = enabled
        self.clock = clock
        self.engine_seq = _next_seq()
        self._engine_ref = weakref.ref(engine)
        self._engine_kind = type(engine).__name__
        self._created_at = clock()
        self._last_beat = self._created_at
        self._traces: dict[int, RequestTrace] = {}
        self._done: deque[int] = deque()
        self._statuses: dict[str, int] = {}
        self._tokens = 0
        self._bursts = 0
        self._completed = 0
        # rolling SLO samples for the stats() quantiles (bounded — the
        # histograms keep the unbounded aggregate)
        self._ttft = deque(maxlen=512)
        self._tpot = deque(maxlen=512)
        self._qwait = deque(maxlen=512)
        # per-burst scratch, cleared by burst_begin
        self._burst_t0 = 0.0
        self._burst_steps = 0
        self._burst_step_no = 0
        self._burst_commits: dict[int, int] = {}
        _LIVE.add(self)

    # -- clock --------------------------------------------------------------
    def now(self) -> float | None:
        """Clock read for the caller to pass back into on_admit — None
        when disabled so the disabled path never pays the read."""
        return self.clock() if self.enabled else None

    # -- admission ----------------------------------------------------------
    def on_admit(
        self, request_id: int, *, prompt_len: int, max_tokens: int,
        deadline: int | None = None, adapter: int = 0,
        submitted_at: float | None = None, queued_at: float | None = None,
        activated: bool = True,
    ) -> None:
        """Mint the trace at ``submit()``.  ``activated=False`` is the
        chunked-prefill path: the slot is reserved but the prompt is still
        streaming in — ``on_activate`` stamps admission when the final
        chunk lands."""
        if not self.enabled:
            return
        now = self.clock()
        self._last_beat = now
        tr = self._traces.get(request_id)
        if tr is None:
            tr = RequestTrace(request_id)
            self._traces[request_id] = tr
        tr.prompt_len = prompt_len
        tr.max_tokens = max_tokens
        tr.deadline = deadline
        tr.adapter = adapter
        tr.submitted_at = submitted_at if submitted_at is not None else now
        tr.queued_at = queued_at if queued_at is not None else tr.submitted_at
        if not tr.engines or tr.engines[-1] != self._engine_kind:
            tr.engines.append(self._engine_kind)
        if activated:
            tr.admitted_at = now
            tr.first_token_at = now
            tr.generated += 1  # activation commits the first token
        else:
            tr.add_event("admission_start", now)

    def on_admission_chunk(self, request_id: int) -> None:
        if not self.enabled:
            return
        # A prefill chunk is a device dispatch: it beats the heart and
        # counts toward ``bursts`` so the fleet stall detector reads
        # chunked admission as progress, not a wedge (an engine whose only
        # residents are mid-admission dispatches no decode bursts at all).
        self._last_beat = self.clock()
        self._bursts += 1
        tr = self._traces.get(request_id)
        if tr is None:
            return
        tr.admission_chunks += 1
        tr.add_event("admission_chunk", self.clock(), chunk=tr.admission_chunks)

    def on_activate(self, request_id: int) -> None:
        """Chunked admission's final chunk: the slot went live and its
        first generated token committed."""
        if not self.enabled:
            return
        tr = self._traces.get(request_id)
        if tr is None:
            return
        now = self.clock()
        tr.admitted_at = now
        if tr.first_token_at is None:
            tr.first_token_at = now
        tr.generated += 1

    # -- decode bursts ------------------------------------------------------
    def burst_begin(self, steps: int, step_no: int = 0) -> None:
        """Bracket open, called right before the decode dispatch the
        engine was already going to make.  One clock read."""
        if not self.enabled:
            return
        self._burst_t0 = self.clock()
        self._burst_steps = steps
        self._burst_step_no = step_no
        self._burst_commits = {}

    def on_commit(self, request_id: int, n: int = 1) -> None:
        """A token (or n of them) committed for this request inside the
        open burst.  Dict arithmetic only — the timestamps come from the
        bracket, K tokens amortized per clock read."""
        if not self.enabled or n <= 0:
            return
        self._burst_commits[request_id] = self._burst_commits.get(request_id, 0) + n

    def burst_end(self, occupancy: int) -> None:
        """Bracket close at the burst's host replay: attribute the burst's
        commits to their traces and observe the per-burst metrics."""
        if not self.enabled:
            return
        t1 = self.clock()
        self._last_beat = t1
        total = 0
        for rid, n in self._burst_commits.items():
            total += n
            tr = self._traces.get(rid)
            if tr is not None:
                tr.generated += n
                tr.add_burst({
                    "step": self._burst_step_no,
                    "t0": self._burst_t0, "t1": t1,
                    "steps": self._burst_steps, "tokens": n,
                })
        self._burst_commits = {}
        self._bursts += 1
        self._tokens += total
        _M_BURST_TOKENS.observe(total)
        _M_BATCH_OCC.set(occupancy)

    def _flush_pending(self, request_id: int) -> None:
        """Attribute a mid-burst retiree's commits before stamping its
        terminal status, so the retired trace is complete at retire time
        (burst_end later skips what was flushed here)."""
        n = self._burst_commits.pop(request_id, 0)
        if n == 0:
            return
        tr = self._traces.get(request_id)
        if tr is not None:
            tr.generated += n
            tr.add_burst({
                "step": self._burst_step_no,
                "t0": self._burst_t0, "t1": self.clock(),
                "steps": self._burst_steps, "tokens": n,
            })
        self._tokens += n

    # -- terminal -----------------------------------------------------------
    def on_retire(self, request_id: int, status: str, generated: int) -> None:
        """Typed retirement: stamp the terminal status, observe the SLO
        histograms with the ``status=`` label, journal the timeline
        summary (queryable by ``req-<id>`` correlation) and record a
        tracer span."""
        if not self.enabled:
            return
        self._flush_pending(request_id)
        now = self.clock()
        self._last_beat = now
        tr = self._traces.get(request_id)
        if tr is None:
            # e.g. an unrestorable snapshot entry from an engine that ran
            # with telemetry off: still tally the status.
            tr = RequestTrace(request_id)
            self._traces[request_id] = tr
        tr.retired_at = now
        tr.status = status
        tr.generated = generated if generated else tr.generated
        self._statuses[status] = self._statuses.get(status, 0) + 1
        self._completed += 1
        qw, ttft, tpot, e2e = (
            tr.queue_wait_s(), tr.ttft_s(), tr.tpot_s(), tr.e2e_s()
        )
        if qw is not None:
            _M_QUEUE_WAIT.observe(qw, status=status)
            self._qwait.append(qw)
        if ttft is not None:
            _M_TTFT.observe(ttft, status=status)
            self._ttft.append(ttft)
        if tpot is not None:
            _M_TPOT.observe(tpot, status=status)
            self._tpot.append(tpot)
        if e2e is not None:
            _M_E2E.observe(e2e, status=status)
        JOURNAL.record(
            "serve", "request.timeline", correlation=f"req-{request_id}",
            status=status, generated=tr.generated,
            queue_wait_s=qw, ttft_s=ttft, tpot_s=tpot, e2e_s=e2e,
            bursts=len(tr.bursts), migrations=tr.migrations,
        )
        span = Span(
            name="serve.request",
            start=time.time() - (e2e or 0.0),
            duration_ms=(e2e or 0.0) * 1000,
            attributes={
                "request_id": request_id, "status": status,
                "engine": self._engine_kind, "generated": tr.generated,
                "queue_wait_s": qw, "ttft_s": ttft, "tpot_s": tpot,
                "bursts": len(tr.bursts), "migrations": tr.migrations,
            },
        )
        TRACER.add(span)
        # Federable flat span for the fleet plane: monotonic-domain
        # timestamps so the control plane can skew-normalize across
        # processes (the presentation Span above keeps wall time).
        mono = time.monotonic()
        TRACES.record(
            f"req-{request_id}", "serve.request",
            mono - (e2e or 0.0), mono,
            request_id=request_id, status=status,
            engine=self._engine_kind, generated=tr.generated,
            queue_wait_s=qw, ttft_s=ttft, tpot_s=tpot,
            bursts=len(tr.bursts), migrations=tr.migrations,
        )
        self._done.append(request_id)
        while len(self._done) > MAX_DONE_TRACES:
            old = self._done.popleft()
            done_tr = self._traces.get(old)
            if done_tr is not None and done_tr.retired_at is not None:
                del self._traces[old]

    def on_shed(self, queued_at: float | None) -> None:
        """A request rejected by bounded admission: it never admitted, so
        the only SLO signal is the time it spent queued before the shed."""
        if not self.enabled:
            return
        wait = 0.0 if queued_at is None else max(0.0, self.clock() - queued_at)
        _M_QUEUE_WAIT.observe(wait, status="shed")
        self._statuses["shed"] = self._statuses.get("shed", 0) + 1

    # -- scheduling events (preempt/readmit — the paged engine's parking) ---
    def on_event(self, request_id: int, name: str) -> None:
        if not self.enabled:
            return
        tr = self._traces.get(request_id)
        if tr is not None:
            tr.add_event(name, self.clock())

    # -- migration (snapshot_active / restore) ------------------------------
    def export_trace(self, request_id: int) -> dict | None:
        """The trace as it rides inside a drain snapshot entry."""
        if not self.enabled:
            return None
        tr = self._traces.get(request_id)
        return tr.to_json() if tr is not None else None

    def import_trace(self, request_id: int, doc: dict | None) -> None:
        """Rebuild a migrated request's timeline in THIS engine.  The
        imported anchors (queued/submitted/first-token) are preserved, so
        the request's TTFT and e2e span BOTH engines — one contiguous
        timeline across the migration."""
        if not self.enabled:
            return
        if doc is None:
            tr = self._traces.get(request_id)
            if tr is None:
                self._traces[request_id] = RequestTrace(request_id)
            return
        tr = RequestTrace.from_json(doc)
        tr.request_id = request_id
        tr.migrations += 1
        tr.add_event("migrate_in", self.clock(), engine=self._engine_kind)
        if not tr.engines or tr.engines[-1] != self._engine_kind:
            tr.engines.append(self._engine_kind)
        self._traces[request_id] = tr

    @staticmethod
    def annotate_trace_doc(doc: dict | None, name: str, t: float, **attrs) -> None:
        """Append an event to an exported trace doc (the dict riding in a
        snapshot entry) while the request is between engines: the
        disaggregated router stamps the handoff's begin, transfer and
        fallback on it (reference ``telemetry.py:571``).  No-op on None
        (telemetry off at the source engine)."""
        if doc is None:
            return
        events = doc.setdefault("events", [])
        if len(events) < MAX_EVENTS_PER_TRACE:
            events.append({"event": name, "t": t, **attrs})

    def drop_trace(self, request_id: int) -> None:
        """Forget a request that migrated AWAY from this engine (the
        router's release-after-evacuation path): no terminal status, no
        SLO observation — the trace lives on in the target engine, and a
        retirement here would double-count the request fleet-wide."""
        if not self.enabled:
            return
        self._traces.pop(request_id, None)
        self._burst_commits.pop(request_id, None)

    def on_restore(self, request_id: int, resumed_at: int) -> None:
        if not self.enabled:
            return
        self.on_event(request_id, "restore")
        tr = self._traces.get(request_id)
        if tr is not None and tr.events:
            tr.events[-1]["resumed_at"] = resumed_at

    # -- queries ------------------------------------------------------------
    def trace(self, request_id: int) -> dict | None:
        tr = self._traces.get(request_id)
        return tr.to_json() if tr is not None else None

    def recent_traces(self, limit: int = 8) -> list[dict]:
        """Last-N retired trace summaries, newest first, then in-flight."""
        out = [
            self._traces[rid].summary()
            for rid in list(self._done)[-limit:][::-1]
            if rid in self._traces
        ]
        live = [
            tr.summary() for tr in self._traces.values() if tr.retired_at is None
        ]
        return (out + live)[:limit]

    # -- the contract snapshot ----------------------------------------------
    def stats(self) -> EngineStats:
        eng = self._engine_ref()

        def attr(name, default=0):
            return getattr(eng, name, default) if eng is not None else default

        free = attr("free_slots", lambda: 0)
        free_n = free() if callable(free) else int(free)
        n_slots = int(attr("n_slots", 0))
        pump_stats = attr("pump_stats", {}) or {}
        in_flight = sum(
            1 for tr in self._traces.values() if tr.retired_at is None
        )
        return EngineStats(
            engine=self._engine_kind,
            engine_seq=self.engine_seq,
            n_slots=n_slots,
            resident_slots=n_slots - free_n,
            free_slots=free_n,
            queue_depth=int(pump_stats.get("queue_depth", 0)),
            admitting=len(attr("_admitting", ()) or ()),
            preempted=len(attr("_preempted", ()) or ()),
            free_blocks=attr("free_blocks", None),
            quarantined=len(attr("quarantined", ()) or ()),
            shed_count=int(attr("shed_count", 0)),
            in_flight=in_flight,
            completed=self._completed,
            statuses=dict(self._statuses),
            tokens_generated=self._tokens,
            bursts=self._bursts,
            host_syncs=int(attr("host_syncs", 0)),
            last_step_s=float(attr("_last_step_s", 0.0)),
            sync_interval=int(attr("sync_interval", 1)),
            uptime_s=self.clock() - self._created_at,
            heartbeat_age_s=self.clock() - self._last_beat,
            ttft_p50_s=_quantile(list(self._ttft), 0.5),
            ttft_p90_s=_quantile(list(self._ttft), 0.9),
            ttft_p99_s=_quantile(list(self._ttft), 0.99),
            tpot_p50_s=_quantile(list(self._tpot), 0.5),
            tpot_p90_s=_quantile(list(self._tpot), 0.9),
            tpot_p99_s=_quantile(list(self._tpot), 0.99),
            queue_wait_p50_s=_quantile(list(self._qwait), 0.5),
            queue_wait_p90_s=_quantile(list(self._qwait), 0.9),
        )


def live_telemetries() -> list[EngineTelemetry]:
    """Every live engine's telemetry, oldest first (a stable order for
    :func:`debug_serve_doc`)."""
    return sorted(list(_LIVE), key=lambda t: t.engine_seq)


def debug_serve_doc(
    request_id: int | None = None, trace_limit: int = 8,
) -> dict:
    """The reference's ``/debug/serve`` payload: per-engine EngineStats plus last-N trace
    summaries; with ``request_id`` the full per-request timeline from
    whichever live engine holds it (newest engine wins — a migrated
    request's latest home has the merged timeline)."""
    tels = live_telemetries()
    if request_id is not None:
        for tel in reversed(tels):
            doc = tel.trace(request_id)
            if doc is not None:
                return {
                    "request_id": request_id,
                    "engine": tel._engine_kind,
                    "engine_seq": tel.engine_seq,
                    "trace": doc,
                }
        return {"request_id": request_id, "trace": None}
    return {
        "engines": [t.stats().to_json() for t in tels],
        "recent_traces": [
            {"engine_seq": t.engine_seq, **s}
            for t in tels
            for s in t.recent_traces(limit=trace_limit)
        ],
    }
