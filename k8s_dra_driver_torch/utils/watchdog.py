"""Stall watchdog and one-shot diag bundles
(``k8s_dra_driver_tpu/utils/watchdog.py``, copied: the port imports
nothing of the JAX package).

* :class:`Watchdog`: heartbeat-armed guards around data-plane sections
  (the fleet router's ``pump`` runs under ``WATCHDOG.guard("fleet.pump")``).
  A guard arms when entered; code inside calls :meth:`Guard.beat` on
  progress; a monitor thread (or :meth:`Watchdog.check_now`, for tests)
  declares a stall when a guard goes ``timeout_s`` without a heartbeat
  and writes a diag bundle.
* :func:`dump_diag_bundle`: every Python thread's stack, the journal tail
  and its counters, the tracer ring, a caller's state and the rendered
  metrics, as one JSON file (the fleet router writes one when it wedges).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

from k8s_dra_driver_torch.utils.journal import JOURNAL, Journal
from k8s_dra_driver_torch.utils.metrics import REGISTRY
from k8s_dra_driver_torch.utils.tracing import TRACER

log = logging.getLogger("tpu-dra-watchdog")

# a guarded section's stall budget unless the guard or
# TPU_DRA_WATCHDOG_TIMEOUT_S says otherwise
DEFAULT_TIMEOUT_S = 300.0


def thread_stacks() -> dict[str, list[str]]:
    """Every live Python thread's stack, keyed ``"name (tid)"``."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: dict[str, list[str]] = {}
    for tid, frame in sys._current_frames().items():
        label = f"{names.get(tid, 'unknown')} ({tid})"
        out[label] = [ln.rstrip("\n") for ln in traceback.format_stack(frame)]
    return out


def dump_diag_bundle(
    bundle_dir: str,
    reason: str,
    correlation: str = "",
    state: dict | None = None,
    journal: Journal = JOURNAL,
    extra: dict | None = None,
) -> str:
    """Write one self-contained JSON diag bundle and return its path.  A
    section that itself raises becomes an ``"error: ..."`` string in the
    bundle: the bundle still lands."""

    def guarded(fn):
        try:
            return fn()
        except Exception as exc:  # noqa: BLE001 - the bundle must still land
            return f"error: {type(exc).__name__}: {exc}"

    bundle = {
        "kind": "tpu-dra-diag-bundle",
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "reason": reason,
        **({"correlation": correlation} if correlation else {}),
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "thread_stacks": guarded(thread_stacks),
        "journal_tail": guarded(lambda: journal.tail(limit=500)),
        "journal_stats": guarded(journal.stats),
        "traces": guarded(TRACER.recent),
        "state": guarded(lambda: state if state is not None else {}),
        "metrics": guarded(REGISTRY.render),
        **(extra or {}),
    }
    path = Path(bundle_dir)
    path.mkdir(parents=True, exist_ok=True)
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    out = path / f"diag-bundle-{stamp}-{os.getpid()}.json"
    out.write_text(json.dumps(bundle, indent=1, default=str))
    journal.record("watchdog", "bundle.written", correlation=correlation,
                   path=str(out), reason=reason)
    return str(out)


@dataclass
class Guard:
    """One armed section; healthy while ``now - last_beat < timeout_s``."""

    name: str
    timeout_s: float
    correlation: str = ""
    armed_at: float = field(default_factory=time.monotonic)
    last_beat: float = field(init=False)
    stalled: bool = field(init=False, default=False)

    def __post_init__(self):
        self.last_beat = self.armed_at

    def beat(self) -> None:
        self.last_beat = time.monotonic()
        # a late heartbeat after a stall verdict: slow, not dead
        self.stalled = False

    def age_s(self, now: float | None = None) -> float:
        return (now if now is not None else time.monotonic()) - self.last_beat

    def to_json(self, now: float | None = None) -> dict:
        now = now if now is not None else time.monotonic()
        return {
            "name": self.name,
            "correlation": self.correlation,
            "timeout_s": self.timeout_s,
            "armed_for_s": round(now - self.armed_at, 3),
            "since_last_beat_s": round(self.age_s(now), 3),
            "stalled": self.stalled,
        }


class Watchdog:
    """Armed guards and the monitor that turns a missed heartbeat into a
    diag bundle: one bundle per stall verdict (a guard stays ``stalled``
    until it beats again).  The monitor thread starts with the first
    armed guard."""

    def __init__(
        self,
        bundle_dir: str | None = None,
        poll_interval_s: float = 1.0,
        state_provider=None,
        journal: Journal = JOURNAL,
    ):
        self._lock = threading.Lock()
        self._guards: dict[int, Guard] = {}
        self._next_id = 0
        self._journal = journal
        self._state_provider = state_provider
        self._poll_interval_s = poll_interval_s
        self._bundle_dir = bundle_dir
        self._monitor: threading.Thread | None = None
        self._stop = threading.Event()
        self._stalls = REGISTRY.counter(
            "dra_watchdog_stalls_total", "Guarded sections that missed heartbeats"
        )
        self.bundles: list[str] = []  # paths written, newest last

    @property
    def bundle_dir(self) -> str:
        return (
            self._bundle_dir
            or os.environ.get("TPU_DRA_DIAG_DIR", "")
            or str(Path(os.environ.get("TMPDIR", "/tmp")) / "tpu-dra-diag")
        )

    def guard(self, name: str, timeout_s: float | None = None, correlation: str = ""):
        """Context manager arming one section; the body calls ``beat()``
        on the guard it yields."""
        if timeout_s is None:
            timeout_s = float(os.environ.get("TPU_DRA_WATCHDOG_TIMEOUT_S", DEFAULT_TIMEOUT_S))
        return _GuardContext(self, name, timeout_s, correlation)

    def _register(self, g: Guard) -> int:
        with self._lock:
            gid = self._next_id
            self._next_id += 1
            self._guards[gid] = g
        self._ensure_monitor()
        return gid

    def _unregister(self, gid: int) -> None:
        with self._lock:
            self._guards.pop(gid, None)

    def active(self) -> list[dict]:
        now = time.monotonic()
        with self._lock:
            return [g.to_json(now) for g in self._guards.values()]

    def check_now(self) -> list[str]:
        """One monitor pass; returns the bundle paths written."""
        now = time.monotonic()
        with self._lock:
            newly_stalled = []
            for g in self._guards.values():
                if not g.stalled and g.age_s(now) >= g.timeout_s:
                    g.stalled = True
                    newly_stalled.append(g)
        written = []
        for g in newly_stalled:
            self._stalls.inc(section=g.name)
            self._journal.record(
                "watchdog", "stall.detected", correlation=g.correlation,
                section=g.name, since_last_beat_s=round(g.age_s(now), 3),
                timeout_s=g.timeout_s,
            )
            log.error("watchdog: section %r stalled (%.1fs without a heartbeat, budget "
                      "%.1fs, correlation %r); dumping diag bundle",
                      g.name, g.age_s(now), g.timeout_s, g.correlation)
            try:
                state = self._state_provider() if self._state_provider else {}
            except Exception as exc:  # noqa: BLE001
                state = {"state_provider_error": f"{type(exc).__name__}: {exc}"}
            try:
                state = {"watchdog_guards": self.active(), **(state or {})}
                path = dump_diag_bundle(
                    self.bundle_dir,
                    reason=f"stall in {g.name}: {g.age_s(now):.1f}s without a heartbeat "
                    f"(budget {g.timeout_s:.1f}s)",
                    correlation=g.correlation,
                    state=state,
                    journal=self._journal,
                )
                self.bundles.append(path)
                written.append(path)
            except Exception as exc:  # noqa: BLE001 - detection must outlive the dump
                log.error("watchdog: bundle write failed: %s", exc)
        return written

    def _ensure_monitor(self) -> None:
        with self._lock:
            if self._monitor is not None and self._monitor.is_alive():
                return
            self._stop.clear()
            self._monitor = threading.Thread(target=self._run, daemon=True,
                                             name="tpu-dra-watchdog")
            self._monitor.start()

    def _run(self) -> None:
        while not self._stop.wait(self._poll_interval_s):
            with self._lock:
                idle = not self._guards
            if idle:
                continue
            self.check_now()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            monitor = self._monitor
        if monitor is not None:
            monitor.join(timeout=5)


class _GuardContext:
    def __init__(self, wd: Watchdog, name: str, timeout_s: float, correlation: str):
        self._wd = wd
        self._g = Guard(name=name, timeout_s=timeout_s, correlation=correlation)
        self._gid: int | None = None

    def __enter__(self) -> Guard:
        self._gid = self._wd._register(self._g)
        return self._g

    def __exit__(self, *exc) -> None:
        if self._gid is not None:
            self._wd._unregister(self._gid)


WATCHDOG = Watchdog()
