"""The port's lifecycle journal (``k8s_dra_driver_tpu/utils/journal.py``,
copied: the port imports nothing of the JAX package).

A bounded, thread-safe ring of timestamped events, each carrying a
correlation id (``req-<id>`` for a served request).  The serving engines
journal admissions, restores, releases and every terminal status, never
individual decode steps; ``tail`` reads the ring back, and
``export_since`` hands a telemetry shipper what it has not shipped yet.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

DEFAULT_CAPACITY = 2048


@dataclass(frozen=True)
class Event:
    ts: float  # time.time() at record()
    component: str  # "serve", ...
    event: str  # "request.submit", "request.complete", ...
    correlation: str = ""  # "req-<id>" for a served request
    attrs: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(self.ts))
            + f".{int(self.ts % 1 * 1000):03d}Z",
            "component": self.component,
            "event": self.event,
            **({"correlation": self.correlation} if self.correlation else {}),
            **({"attrs": self.attrs} if self.attrs else {}),
        }


class Journal:
    """Bounded ring of lifecycle events; drop-oldest under pressure so a
    chatty component can never block or OOM the process it observes."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._events: deque[Event] = deque(maxlen=capacity)
        self._dropped = 0
        self._recorded = 0

    def record(self, component: str, event: str, correlation: str = "", **attrs) -> None:
        e = Event(
            ts=time.time(),
            component=component,
            event=event,
            correlation=str(correlation),
            attrs=attrs,
        )
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._recorded += 1
            self._events.append(e)

    def record_lazy(self, component: str, event: str, correlation: str = "",
                    attrs=None) -> None:
        """``record`` with ``attrs`` a zero-argument callable returning the
        attrs dict (the reference's hot-path form)."""
        self.record(component, event, correlation, **(attrs() if attrs is not None else {}))

    def tail(self, limit: int = 200, correlation: str | None = None,
             component: str | None = None) -> list[dict]:
        """Newest-last slice of the ring, optionally filtered."""
        with self._lock:
            events = list(self._events)
        if correlation is not None:
            events = [e for e in events if e.correlation == str(correlation)]
        if component is not None:
            events = [e for e in events if e.component == component]
        return [e.to_json() for e in events[-limit:]]

    def export_since(self, cursor: int) -> tuple[int, list[dict]]:
        """Events recorded after ``cursor`` (a value this method returned
        before; start from 0) and the new cursor, each with its raw epoch
        time under ``ts_s``.  Events the ring dropped before export show as
        a larger skip, never an error."""
        with self._lock:
            total = self._recorded
            events = list(self._events)
        start = total - len(events)  # sequence number of events[0]
        skip = max(0, int(cursor) - start)
        return total, [{**e.to_json(), "ts_s": e.ts} for e in events[skip:]]

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self._events.maxlen,
                "buffered": len(self._events),
                "recorded": self._recorded,
                "dropped": self._dropped,
            }

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0
            self._recorded = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


JOURNAL = Journal()
