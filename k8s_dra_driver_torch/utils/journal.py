"""The port's lifecycle journal (``k8s_dra_driver_tpu/utils/journal.py``,
copied: the port imports nothing of the JAX package).

A bounded, thread-safe ring of timestamped events, each carrying a
correlation id (``req-<id>`` for a served request).  The serving engines
journal admissions, restores, releases and every terminal status, never
individual decode steps; ``tail`` reads the ring back.
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

    def record(self, component: str, event: str, correlation: str = "", **attrs) -> None:
        e = Event(
            ts=time.time(),
            component=component,
            event=event,
            correlation=str(correlation),
            attrs=attrs,
        )
        with self._lock:
            self._events.append(e)

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

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


JOURNAL = Journal()
