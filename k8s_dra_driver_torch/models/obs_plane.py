"""The fleet observability plane (``k8s_dra_driver_tpu/models/obs_plane.py``,
copied: the port imports nothing of the JAX package).

The worker half (reference ``:116-242``): a worker process ships its journal tail, its span records and its
metrics registry to the supervisor in ``TELEM`` frames (transport frame
type 13) on a bounded cadence.  The body is ``u32 crc32 + json payload``
(telemetry rides the socket that carries KV payloads: a corrupt frame is
dropped, never parsed) and at most ``TELEM_BUDGET_BYTES``: an oversized
snapshot sheds stacks first, then the oldest journal events, then the
oldest spans, then the metrics text, and marks itself truncated.

The supervisor half (reference ``:245-759``): ``FleetObservability``
(the module's ``FLEET``) merges ingested frames into instance-labeled
fleet views (the fleet journal, skew-normalized span trees keyed by trace
id, a federated metrics render under ``instance=`` labels, diag bundles),
remembers each in-flight hop so a dead worker's hop is attributed with a
synthetic ``hop.dead`` span; ``SloBurnRateMonitor`` evaluates
miss-fraction burn rates over the ``DEFAULT_BURN_WINDOWS`` per tier
(``INTERACTIVE``/``STANDARD``/``BATCH``/``FLEET_TIER``), publishes
``tpu_slo_burn_rate``/``tpu_slo_burn_alert`` and journals the alert
transitions; ``debug_obs_doc`` is the plane's own health.  The module
imports only the port's ``utils``, so the transport imports it at module
scope.
"""

from __future__ import annotations

import json
import struct
import sys
import threading
import time
import traceback
import zlib
from collections import OrderedDict, deque

from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.metrics import REGISTRY, escape_label_value
from k8s_dra_driver_torch.utils.tracing import TRACES

TELEM_BUDGET_BYTES = 48 * 1024  # the reference's per-frame ceiling

_CRC = struct.Struct("!I")

_M_TELEM_FRAMES = REGISTRY.counter(
    "tpu_obs_telem_frames_total",
    "TELEM telemetry frames by outcome (shipped/ingested/crc_drop/decode_drop)",
)
_M_TELEM_BYTES = REGISTRY.counter(
    "tpu_obs_telem_bytes_total",
    "TELEM telemetry frame bytes by direction (tx=shipped, rx=ingested)",
)
_M_TELEM_TRUNCATED = REGISTRY.counter(
    "tpu_obs_telem_truncated_total",
    "TELEM snapshots that shed sections to fit the frame byte budget",
)
_M_INSTANCES = REGISTRY.gauge(
    "tpu_obs_instances",
    "Worker instances currently federated into the fleet observability plane",
)
_M_BURN = REGISTRY.gauge(
    "tpu_slo_burn_rate",
    "SLO error-budget burn rate per evaluation window and request tier",
)
_M_BURN_ALERT = REGISTRY.gauge(
    "tpu_slo_burn_alert",
    "1 while a tier's burn rate exceeds the alert threshold on every window",
)

# the closed outcome vocabulary of _M_TELEM_FRAMES
SHIPPED = "shipped"
INGESTED = "ingested"
CRC_DROP = "crc_drop"
DECODE_DROP = "decode_drop"
_TX = "tx"
_RX = "rx"


def encode_telem(doc: dict) -> bytes:
    """TELEM frame body: ``u32 crc32(payload) + payload``, the payload the
    UTF-8 JSON snapshot."""
    payload = json.dumps(doc, default=str).encode()
    return _CRC.pack(zlib.crc32(payload)) + payload


def decode_telem(body: bytes) -> dict | None:
    """Inverse of :func:`encode_telem`; None (the drop counted) on a CRC
    mismatch or malformed JSON."""
    if len(body) < _CRC.size:
        _M_TELEM_FRAMES.inc(outcome=DECODE_DROP)
        return None
    (crc,) = _CRC.unpack_from(body)
    payload = body[_CRC.size:]
    if zlib.crc32(payload) != crc:
        _M_TELEM_FRAMES.inc(outcome=CRC_DROP)
        return None
    try:
        doc = json.loads(payload.decode())
    except (UnicodeDecodeError, ValueError):
        _M_TELEM_FRAMES.inc(outcome=DECODE_DROP)
        return None
    if not isinstance(doc, dict):
        _M_TELEM_FRAMES.inc(outcome=DECODE_DROP)
        return None
    return doc


def _thread_stacks() -> dict[str, str]:
    names = {t.ident: t.name for t in threading.enumerate()}
    return {
        f"{names.get(tid, 'unknown')}-{tid}": "".join(traceback.format_stack(frame))
        for tid, frame in sys._current_frames().items()
    }


class TelemetryShipper:
    """On a bounded cadence, export everything new since the last ship
    (journal and spans by sequence cursor, the metrics as a full render)
    and hand the encoded TELEM body to ``send``.  Pumped from the worker's
    frame loop: no thread of its own."""

    def __init__(self, send, instance: str, *, clock=time.monotonic,
                 interval_s: float = 0.25,
                 budget_bytes: int = TELEM_BUDGET_BYTES,
                 journal=None, traces=None, registry=None):
        self._send = send
        self.instance = str(instance)
        self.clock = clock
        self.interval_s = float(interval_s)
        self.budget_bytes = int(budget_bytes)
        self._journal = journal if journal is not None else JOURNAL
        self._traces = traces if traces is not None else TRACES
        self._registry = registry if registry is not None else REGISTRY
        self._journal_cursor = 0
        self._span_cursor = 0
        self._last_ship = -float("inf")
        self.shipped_frames = 0
        self.shipped_bytes = 0
        self.last_frame_bytes = 0

    def _fit(self, doc: dict) -> bytes:
        """Shed sections until the encoded body fits the budget: stacks,
        then the oldest halves of the journal and the spans, then the
        metrics text."""
        body = encode_telem(doc)
        if len(body) <= self.budget_bytes:
            return body
        doc = dict(doc)
        doc["truncated"] = True
        doc.pop("stacks", None)
        for key in ("journal", "spans"):
            body = encode_telem(doc)
            if len(body) <= self.budget_bytes:
                return body
            items = list(doc.get(key) or [])
            while items and len(body) > self.budget_bytes:
                items = items[max(1, len(items) // 2):]  # drop the oldest half
                doc[key] = items
                body = encode_telem(doc)
        if len(body) > self.budget_bytes:
            doc["metrics"] = ""
            body = encode_telem(doc)
        return body

    def maybe_ship(self, force: bool = False, include_stacks: bool = False) -> int:
        """Ship one snapshot if the cadence (or ``force``) says so; returns
        the body's size in bytes, 0 when the cadence held fire."""
        now = self.clock()
        if not force and now - self._last_ship < self.interval_s:
            return 0
        self._last_ship = now
        self._journal_cursor, events = self._journal.export_since(self._journal_cursor)
        self._span_cursor, spans = self._traces.export_since(self._span_cursor)
        doc = {
            "instance": self.instance,
            "mono": now,
            "journal": events,
            "spans": spans,
            "metrics": self._registry.render(),
        }
        if include_stacks:
            doc["stacks"] = _thread_stacks()
        body = self._fit(doc)
        self._send(body)
        self.shipped_frames += 1
        self.shipped_bytes += len(body)
        self.last_frame_bytes = len(body)
        _M_TELEM_FRAMES.inc(outcome=SHIPPED)
        _M_TELEM_BYTES.inc(len(body), direction=_TX)
        return len(body)


_FLEET_JOURNAL_CAP = 4096
_SPANS_PER_INSTANCE = 1024
_HOP_CTX_CAP = 512

SUPERVISOR = "supervisor"  # the control plane's own instance label


def _inject_instance_label(line: str, instance: str) -> str:
    """Rewrite one exposition sample line to carry ``instance="..."``.
    Handles both labeled (``name{k="v"} 1``) and bare (``name 1``) forms;
    the value is escaped so a hostile worker name cannot inject samples."""
    esc = escape_label_value(instance)
    if "{" in line:
        name, rest = line.split("{", 1)
        return name + '{instance="' + esc + '",' + rest
    name, _, value = line.partition(" ")
    return name + '{instance="' + esc + '"} ' + value


class FleetObservability:
    """Control-plane half of the federation: ingest TELEM snapshots from
    every worker, keep bounded per-instance state, and serve the merged
    fleet views.  Thread-safe — the DiagnosticsServer scrapes concurrently
    with the transport drain loops that ingest."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instances: dict[str, dict] = {}
        self._journal: deque[dict] = deque(maxlen=_FLEET_JOURNAL_CAP)
        self._hops: OrderedDict[int, dict] = OrderedDict()

    # -- ingestion -----------------------------------------------------

    def ingest_wire(self, instance: str, body: bytes,
                    clock_offset_s: float | None = None) -> bool:
        doc = decode_telem(body)
        if doc is None:
            JOURNAL.record("obs", "telem.drop", correlation=str(instance),
                           nbytes=len(body))
            return False
        _M_TELEM_BYTES.inc(len(body), direction=_RX)
        self.ingest(str(doc.get("instance") or instance), doc,
                    clock_offset_s=clock_offset_s)
        return True

    def ingest(self, instance: str, doc: dict,
               clock_offset_s: float | None = None) -> None:
        instance = str(instance)
        with self._lock:
            st = self._instances.setdefault(instance, {
                "spans": deque(maxlen=_SPANS_PER_INSTANCE),
                "metrics": "",
                "stacks": None,
                "offset_s": 0.0,
                "mono": 0.0,
                "frames": 0,
                "truncated": 0,
            })
            st["frames"] += 1
            st["mono"] = float(doc.get("mono", st["mono"]) or 0.0)
            if doc.get("truncated"):
                st["truncated"] += 1
            if clock_offset_s is not None:
                st["offset_s"] = float(clock_offset_s)
            metrics_text = doc.get("metrics")
            if metrics_text:
                st["metrics"] = str(metrics_text)
            if doc.get("stacks"):
                st["stacks"] = doc["stacks"]
            for span in doc.get("spans") or []:
                if isinstance(span, dict):
                    st["spans"].append(span)
            for event in doc.get("journal") or []:
                if isinstance(event, dict):
                    self._journal.append({**event, "instance": instance})
            n = len(self._instances)
        if doc.get("truncated"):
            _M_TELEM_TRUNCATED.inc()
        _M_TELEM_FRAMES.inc(outcome=INGESTED)
        _M_INSTANCES.set(n)

    # -- hop context / dead-hop attribution ----------------------------

    def note_hop(self, rid: int, trace_id: str, parent_id: str = "",
                 instance: str = "") -> None:
        """Remember which trace a request's in-flight hop belongs to, so a
        worker that dies mid-hop can still be attributed into the right
        span tree (the worker's own span for that hop died with it)."""
        with self._lock:
            self._hops[int(rid)] = {
                "trace_id": str(trace_id),
                "parent_id": str(parent_id),
                "instance": str(instance),
            }
            self._hops.move_to_end(int(rid))
            while len(self._hops) > _HOP_CTX_CAP:
                self._hops.popitem(last=False)

    def hop_ctx(self, rid: int) -> dict | None:
        with self._lock:
            ctx = self._hops.get(int(rid))
            return dict(ctx) if ctx else None

    def forget_hop(self, rid: int) -> None:
        with self._lock:
            self._hops.pop(int(rid), None)

    def attribute_dead_hop(self, rid: int, instance: str, reason: str = "",
                           traces=None) -> None:
        """Record a synthetic zero-width ``hop.dead`` span in the control
        plane's OWN trace buffer: the worker that owned the hop is gone,
        so whatever it flushed before death is all that federated — this
        span marks the gap and names the culprit instance."""
        ctx = self.hop_ctx(rid) or {}
        now = time.monotonic()
        (traces if traces is not None else TRACES).record(
            trace_id=ctx.get("trace_id") or f"req-{rid}",
            name="hop.dead",
            t0=now, t1=now,
            parent_id=ctx.get("parent_id", ""),
            instance=str(instance),
            reason=str(reason),
            request_id=int(rid),
        )
        JOURNAL.record(
            "obs", "hop.dead", correlation=f"req-{rid}",
            instance=str(instance), reason=str(reason),
        )
        self.forget_hop(rid)

    # -- fleet views ---------------------------------------------------

    def fleet_journal_doc(self, limit: int = 200, correlation: str | None = None,
                          component: str | None = None,
                          instance: str | None = None) -> dict:
        """Instance-tagged merge of every federated journal tail, ordered
        by each event's RAW epoch timestamp (``ts_s``) — wall clocks are
        close enough for journal ordering; spans get the real skew
        model."""
        with self._lock:
            events = list(self._journal)
            instances = sorted(self._instances)
        if correlation is not None:
            events = [e for e in events if e.get("correlation") == str(correlation)]
        if component is not None:
            events = [e for e in events if e.get("component") == component]
        if instance is not None:
            events = [e for e in events if e.get("instance") == instance]
        events.sort(key=lambda e: e.get("ts_s", 0.0))
        return {
            "instances": instances,
            "merged": len(events),
            "events": events[-int(limit):],
        }

    def _all_span_nodes(self, traces=None) -> list[dict]:
        nodes = []
        for doc in (traces if traces is not None else TRACES).snapshot(
                limit=_SPANS_PER_INSTANCE):
            nodes.append((SUPERVISOR, 0.0, doc))
        with self._lock:
            for name, st in self._instances.items():
                off = float(st.get("offset_s") or 0.0)
                for doc in st["spans"]:
                    nodes.append((name, off, doc))
        out = []
        for inst, off, doc in nodes:
            out.append({
                "trace_id": str(doc.get("trace_id", "")),
                "span_id": str(doc.get("span_id", "")),
                "parent_id": str(doc.get("parent_id", "")),
                "name": str(doc.get("name", "")),
                "instance": inst,
                # Skew normalization: offset is (instance_clock -
                # control_plane_clock), so subtracting maps the span into
                # the control plane's monotonic domain.
                "t0": float(doc.get("t0", 0.0)) - off,
                "t1": float(doc.get("t1", 0.0)) - off,
                "attrs": dict(doc.get("attrs", {}) or {}),
                "children": [],
            })
        return out

    def fleet_traces_doc(self, trace_id: str | None = None,
                         limit: int = 50, traces=None) -> dict:
        """Merged, skew-normalized span trees across every instance.  Tree
        structure comes from span_id/parent_id; spans whose parent never
        federated (dropped frame, dead worker) surface as extra roots of
        the same trace rather than vanishing."""
        nodes = self._all_span_nodes(traces=traces)
        by_trace: dict[str, list[dict]] = {}
        for n in nodes:
            tid = n["trace_id"]
            if trace_id is not None and tid != str(trace_id):
                continue
            by_trace.setdefault(tid, []).append(n)
        trees = []
        for tid, members in by_trace.items():
            by_id = {n["span_id"]: n for n in members if n["span_id"]}
            roots = []
            for n in members:
                parent = by_id.get(n["parent_id"]) if n["parent_id"] else None
                if parent is not None and parent is not n:
                    parent["children"].append(n)
                else:
                    roots.append(n)
            for n in members:
                n["children"].sort(key=lambda c: c["t0"])
            roots.sort(key=lambda c: c["t0"])
            trees.append({
                "trace_id": tid,
                "spans": len(members),
                "instances": sorted({n["instance"] for n in members}),
                "t0": min(n["t0"] for n in members),
                "t1": max(n["t1"] for n in members),
                "roots": roots,
            })
        trees.sort(key=lambda t: t["t0"], reverse=True)
        with self._lock:
            instances = sorted(self._instances)
        return {"instances": instances, "traces": trees[:int(limit)]}

    def render_federated(self, registry=None) -> str:
        """The control plane's own registry render, followed by every
        worker's latest snapshot rewritten under its ``instance=`` label.
        HELP/TYPE comments are kept only from the local render — the
        worker copies would duplicate them — and sample lines merge
        cleanly because the instance label disambiguates series."""
        local = (registry if registry is not None else REGISTRY).render()
        out = [local.rstrip("\n")]
        with self._lock:
            snapshots = sorted(
                (name, st["metrics"]) for name, st in self._instances.items()
            )
        for name, text in snapshots:
            for line in (text or "").splitlines():
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                out.append(_inject_instance_label(line, name))
        return "\n".join(out) + "\n"

    def bundle_doc(self, journal_limit: int = 100) -> dict:
        """Per-instance snapshot for diag bundles (mp_harness death
        reports, tools/diag_bundle.py --fleet): journals, metrics, stacks
        and federation freshness for every worker the plane has seen —
        including workers that are ALREADY DEAD, which is the whole
        point of a death report."""
        with self._lock:
            names = sorted(self._instances)
            states = {n: self._instances[n] for n in names}
            journal = list(self._journal)
        doc: dict = {"instances": {}}
        for name in names:
            st = states[name]
            doc["instances"][name] = {
                "frames": st["frames"],
                "truncated_frames": st["truncated"],
                "clock_offset_s": st["offset_s"],
                "spans_buffered": len(st["spans"]),
                "metrics": st["metrics"],
                "stacks": st["stacks"],
                "journal_tail": [
                    e for e in journal if e.get("instance") == name
                ][-int(journal_limit):],
            }
        return doc

    def stats(self) -> dict:
        with self._lock:
            return {
                "instances": sorted(self._instances),
                "journal_buffered": len(self._journal),
                "hops_tracked": len(self._hops),
            }

    def clear(self) -> None:
        with self._lock:
            self._instances.clear()
            self._journal.clear()
            self._hops.clear()
        _M_INSTANCES.set(0)


FLEET = FleetObservability()


# ---------------------------------------------------------------------------
# SLO burn-rate monitor.
# ---------------------------------------------------------------------------

DEFAULT_BURN_WINDOWS = (("5m", 300.0), ("1h", 3600.0))

# Closed tier vocabulary (workload.SloTier thresholds map onto it via
# classify_tier; "fleet" is the tier for histogram-derived fleet-wide
# observations where per-request tier identity is gone).
INTERACTIVE = "interactive"
STANDARD = "standard"
BATCH = "batch"
FLEET_TIER = "fleet"


class SloBurnRateMonitor:
    """Multi-window error-budget burn evaluator.

    ``observe(now, tier, ok)`` feeds per-request SLO verdicts (the same
    ok-vs-miss scoring ``workload.replay`` already computes from TTFT and
    TPOT); ``ingest_federated`` feeds fleet-wide verdicts derived by
    bucket-diffing each instance's federated ``tpu_serve_ttft_seconds``
    histogram.  ``tick(now)`` evaluates ``burn = miss_fraction /
    error_budget`` over every window × tier, publishes the gauges,
    journals fired/cleared transitions, and appends to a bounded timeline
    that ``bench.py serving_autoscale`` embeds as an artifact.

    Burn semantics: 1.0 means missing exactly the budgeted fraction (on
    pace to spend the whole budget over the window); the alert fires only
    when EVERY window agrees (the classic multi-window guard: the short
    window gives speed, the long window suppresses blips).  All clocks are
    the caller's — simulated time in bench/replay, monotonic in live
    processes."""

    def __init__(self, *, error_budget: float = 0.05,
                 windows=DEFAULT_BURN_WINDOWS,
                 alert_threshold: float = 2.0,
                 slice_s: float = 5.0,
                 timeline_every_s: float = 30.0,
                 timeline_cap: int = 512,
                 journal=None):
        self.error_budget = max(1e-6, float(error_budget))
        self.windows = tuple((str(n), float(s)) for n, s in windows)
        self.alert_threshold = float(alert_threshold)
        self.slice_s = max(1e-3, float(slice_s))
        self.timeline_every_s = float(timeline_every_s)
        self._journal = journal if journal is not None else JOURNAL
        self._lock = threading.Lock()
        self._slices: dict[int, dict[str, list[int]]] = {}  # idx -> tier -> [ok, miss]
        self._hist_cursors: dict[tuple, float] = {}
        self._alerting: set[str] = set()
        self._last_burn: dict[str, dict[str, float]] = {}
        self._timeline: deque[dict] = deque(maxlen=int(timeline_cap))
        self._last_sample = -float("inf")
        self._transitions = 0

    @staticmethod
    def classify_tier(ttft_slo_s: float) -> str:
        """Map a request's TTFT SLO bound onto the closed tier vocabulary
        (workload's default tiers: interactive 1.0s / standard 3.0s /
        batch 10.0s)."""
        if ttft_slo_s <= 1.0:
            return INTERACTIVE
        if ttft_slo_s <= 3.0:
            return STANDARD
        return BATCH

    def observe(self, now: float, tier: str, ok: bool, count: int = 1) -> None:
        idx = int(now // self.slice_s)
        with self._lock:
            counts = self._slices.setdefault(idx, {}).setdefault(str(tier), [0, 0])
            counts[0 if ok else 1] += int(count)

    def ingest_federated(self, now: float, fleet: FleetObservability | None = None,
                         slo_s: float = 1.0, tier: str = FLEET_TIER) -> int:
        """Derive fleet-wide verdicts from the federated TTFT histograms:
        per instance, the delta of ``tpu_serve_ttft_seconds`` cumulative
        counts since the last ingest, with the largest bucket bound ≤
        ``slo_s`` as the ok/miss split.  Bucket-diffing cumulative
        counters makes re-ingest idempotent across federation cadences."""
        from k8s_dra_driver_torch.utils.metrics import parse_prom_text
        fleet = fleet if fleet is not None else FLEET
        with fleet._lock:
            snapshots = [
                (name, st["metrics"]) for name, st in fleet._instances.items()
            ]
        observed = 0
        for name, text in snapshots:
            if not text:
                continue
            try:
                parsed = parse_prom_text(text)
            except (ValueError, IndexError):
                continue
            buckets = parsed.get("tpu_serve_ttft_seconds_bucket", {})
            totals: dict[tuple, float] = {}
            ok_counts: dict[tuple, float] = {}
            for labels, value in buckets.items():
                le = dict(labels).get("le", "")
                rest = tuple(kv for kv in labels if kv[0] != "le")
                if le == "+Inf":
                    totals[rest] = value
                else:
                    try:
                        bound = float(le)
                    except ValueError:
                        continue
                    if bound <= slo_s:
                        ok_counts[rest] = max(ok_counts.get(rest, 0.0), value)
            for rest, total in totals.items():
                ok = ok_counts.get(rest, 0.0)
                key = (name, rest, "total")
                ok_key = (name, rest, "ok")
                d_total = total - self._hist_cursors.get(key, 0.0)
                d_ok = ok - self._hist_cursors.get(ok_key, 0.0)
                self._hist_cursors[key] = total
                self._hist_cursors[ok_key] = ok
                d_total, d_ok = max(0.0, d_total), max(0.0, min(d_ok, d_total))
                miss = d_total - d_ok
                if d_ok:
                    self.observe(now, tier, True, count=int(round(d_ok)))
                if miss:
                    self.observe(now, tier, False, count=int(round(miss)))
                observed += int(round(d_total))
        return observed

    def _window_counts(self, now: float, span_s: float) -> dict[str, list[int]]:
        lo = now - span_s
        out: dict[str, list[int]] = {}
        for idx, tiers in self._slices.items():
            t = idx * self.slice_s
            if t <= now and t > lo - self.slice_s:
                for tier, (ok, miss) in tiers.items():
                    agg = out.setdefault(tier, [0, 0])
                    agg[0] += ok
                    agg[1] += miss
        return out

    def tick(self, now: float) -> dict:
        """Evaluate every window, publish gauges, journal transitions,
        sample the timeline.  Returns the burn map for callers that want
        the numbers without re-reading gauges."""
        with self._lock:
            horizon = now - max(s for _, s in self.windows) - self.slice_s
            for idx in [i for i in self._slices if i * self.slice_s < horizon]:
                del self._slices[idx]
            per_window = {
                name: self._window_counts(now, span)
                for name, span in self.windows
            }
        burn: dict[str, dict[str, float]] = {}
        tiers = set()
        for counts in per_window.values():
            tiers.update(counts)
        for tier in sorted(tiers):
            burn[tier] = {}
            for window, _span in self.windows:
                ok, miss = per_window[window].get(tier, (0, 0))
                total = ok + miss
                rate = (miss / total / self.error_budget) if total else 0.0
                burn[tier][window] = rate
                _M_BURN.set(rate, window=window, tier=tier)
        now_alerting = {
            tier for tier, by_window in burn.items()
            if by_window and all(
                r > self.alert_threshold for r in by_window.values()
            )
        }
        for tier in sorted(now_alerting - self._alerting):
            self._transitions += 1
            _M_BURN_ALERT.set(1.0, tier=tier)
            self._journal.record(
                "obs", "slo.burn.fired", correlation=f"slo-{tier}",
                burn={w: round(r, 4) for w, r in burn[tier].items()},
                threshold=self.alert_threshold,
            )
        for tier in sorted(self._alerting - now_alerting):
            self._transitions += 1
            _M_BURN_ALERT.set(0.0, tier=tier)
            self._journal.record(
                "obs", "slo.burn.cleared", correlation=f"slo-{tier}",
                burn={w: round(r, 4) for w, r in burn.get(tier, {}).items()},
            )
        self._alerting = now_alerting
        self._last_burn = burn
        if now - self._last_sample >= self.timeline_every_s:
            self._last_sample = now
            self._timeline.append({
                "t": round(now, 3),
                "burn": {
                    tier: {w: round(r, 4) for w, r in by_window.items()}
                    for tier, by_window in burn.items()
                },
                "alerting": sorted(now_alerting),
            })
        return burn

    @property
    def alerting(self) -> bool:
        return bool(self._alerting)

    @property
    def alerting_tiers(self) -> list[str]:
        return sorted(self._alerting)

    def timeline(self) -> list[dict]:
        return list(self._timeline)

    def stats(self) -> dict:
        return {
            "alerting": sorted(self._alerting),
            "burn": self._last_burn,
            "windows": [name for name, _ in self.windows],
            "error_budget": self.error_budget,
            "alert_threshold": self.alert_threshold,
            "timeline_samples": len(self._timeline),
            "transitions": self._transitions,
        }


def debug_obs_doc() -> dict:
    """Shape behind ``/debug/fleet-traces``' sibling summary and diag
    bundles: the plane's own health, not the federated payloads."""
    return {
        "fleet": FLEET.stats(),
        "traces": TRACES.stats(),
        "budget_bytes": TELEM_BUDGET_BYTES,
    }
