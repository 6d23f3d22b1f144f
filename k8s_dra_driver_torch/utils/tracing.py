"""The port's span tracing (``k8s_dra_driver_tpu/utils/tracing.py``,
copied: the port imports nothing of the JAX package).

:data:`TRACER` keeps finished presentation spans (``Span``, wall time) in
a bounded ring; :data:`TRACES` keeps flat :class:`SpanRecord` s in the
recording process's monotonic clock.  ``models/telemetry`` adds one of
each when a request retires; a worker's telemetry shipper reads the
records it has not shipped yet through ``TraceBuffer.export_since``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class Span:
    name: str
    start: float
    duration_ms: float = 0.0
    attributes: dict = field(default_factory=dict)
    children: list = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "start": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(self.start)),
            "durationMs": round(self.duration_ms, 3),
            **({"attributes": self.attributes} if self.attributes else {}),
            **(
                {"children": [c.to_json() for c in self.children]}
                if self.children
                else {}
            ),
        }


class Tracer:
    """Per-process tracer; completed root spans land in a ring buffer."""

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._finished: deque[Span] = deque(maxlen=capacity)

    def add(self, span: Span) -> None:
        """Record an externally-constructed root span: a request's
        lifecycle assembled at retirement from burst-boundary timestamps,
        with no clock read of its own on the hot path."""
        with self._lock:
            self._finished.append(span)

    def recent(self, limit: int = 50) -> list[dict]:
        with self._lock:
            spans = list(self._finished)[-limit:]
        return [s.to_json() for s in reversed(spans)]


TRACER = Tracer()


@dataclass(frozen=True)
class SpanRecord:
    """One federable span: flat (no object children), identified by
    ``span_id`` and stitched into a tree via ``parent_id`` AFTER transport.

    ``Span`` above is the in-process presentation shape; SpanRecord is the
    wire shape.  Timestamps ``t0``/``t1`` are in the RECORDING process's
    ``time.monotonic()`` domain — meaningless across processes until the
    fleet merger subtracts that process's clock offset (estimated from
    PING/PONG rtt) — which is exactly why they are shipped raw: the
    control plane owns the skew model, not the worker."""

    trace_id: str  # correlates every hop of one request, e.g. "req-17"
    span_id: str
    name: str  # "serve.request", "hop.prefill", "hop.wire", ...
    t0: float  # time.monotonic() at span start (recorder's clock)
    t1: float  # time.monotonic() at span end
    parent_id: str = ""
    attrs: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "name": self.name,
            "t0": self.t0,
            "t1": self.t1,
            **({"parent_id": self.parent_id} if self.parent_id else {}),
            **({"attrs": self.attrs} if self.attrs else {}),
        }


class TraceBuffer:
    """Bounded ring of SpanRecords (drop-oldest: telemetry must never
    block serving)."""

    def __init__(self, capacity: int = 1024):
        self._lock = threading.Lock()
        self._records: deque[SpanRecord] = deque(maxlen=capacity)
        self._seq = 0  # total records ever appended

    def mint_id(self, name: str) -> str:
        """Span ids unique across processes: pid-qualified sequence."""
        with self._lock:
            n = self._seq
        return f"s{os.getpid():x}.{name}.{n}"

    def record(self, trace_id: str, name: str, t0: float, t1: float, *,
               parent_id: str = "", span_id: str = "", **attrs) -> SpanRecord:
        rec = SpanRecord(
            trace_id=str(trace_id),
            span_id=span_id or self.mint_id(name),
            name=name,
            t0=float(t0),
            t1=float(t1),
            parent_id=str(parent_id),
            attrs=attrs,
        )
        with self._lock:
            self._records.append(rec)
            self._seq += 1
        return rec

    def export_since(self, cursor: int) -> tuple[int, list[dict]]:
        """Records appended after ``cursor`` (a value this method returned
        before; start from 0) and the new cursor.  Records the ring evicted
        before export show as a larger skip."""
        with self._lock:
            total = self._seq
            records = list(self._records)
        start = total - len(records)  # sequence number of records[0]
        skip = max(0, int(cursor) - start)
        return total, [r.to_json() for r in records[skip:]]

    def snapshot(self, limit: int = 256) -> list[dict]:
        with self._lock:
            records = list(self._records)[-limit:]
        return [r.to_json() for r in records]

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self._records.maxlen,
                "buffered": len(self._records),
                "recorded": self._seq,
            }

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._seq = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


TRACES = TraceBuffer()
