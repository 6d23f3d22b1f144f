"""Fault injection for the serving engines: the engine half of
``k8s_dra_driver_tpu/utils/faults.py`` (the API-server and transport kinds
stay in the reference).

A :class:`FaultInjector` armed with :class:`FaultProfile` s is consulted by
the engine once per step before it dispatches: added step latency, an
injected :class:`StepFault` attributable to one slot, or NaN logits for
one slot.  Decisions come from ``random.Random(seed)``, drawn in the
reference's order, so an injector of each package armed alike makes the
same decisions.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field


class StepFault(RuntimeError):
    """An injected engine-step exception attributable to ONE slot, raised
    by :meth:`FaultInjector.maybe_raise_step` before the step dispatches,
    so no engine state has moved when it fires."""

    def __init__(self, slot: int, message: str):
        super().__init__(message)
        self.slot = slot


@dataclass
class FaultProfile:
    """One armed fault source.  Rates are probabilities per (slot, step);
    ``slots``/``steps`` scope it (empty = all); ``limit`` caps its
    injections (0 = unlimited)."""

    name: str = "fault"
    nan_logits_rate: float = 0.0  # probability a slot's logits go NaN
    step_raise_rate: float = 0.0  # probability of a StepFault pre-dispatch
    step_latency_s: float = 0.0  # added to every matching engine step
    slots: tuple = ()  # e.g. (1, 3); empty = all slots
    steps: tuple = ()  # e.g. (5,); empty = all engine steps
    limit: int = 0  # total-injection cap, 0 = unlimited
    injected: int = field(default=0, compare=False)


class FaultInjector:
    """Deterministic, thread-safe source of engine faults."""

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._profiles: list[FaultProfile] = []
        self._counts: dict[str, int] = {}

    def arm(self, profile: FaultProfile) -> FaultProfile:
        with self._lock:
            self._profiles.append(profile)
        return profile

    def disarm(self, name: str | None = None) -> None:
        with self._lock:
            if name is None:
                self._profiles.clear()
            else:
                self._profiles = [p for p in self._profiles if p.name != name]

    def take_step_latency(self) -> float:
        """Sleep each matching profile's step latency; return the seconds
        slept."""
        total = 0.0
        for p in self._matching_engine(None, None):
            if p.step_latency_s > 0:
                with self._lock:
                    if not self._budget_ok(p):
                        continue
                    self._record(p, "step_latency")
                time.sleep(p.step_latency_s)
                total += p.step_latency_s
        return total

    def take_nan_logits(self, slot: int, step: int) -> bool:
        """Should this (slot, step)'s logits be poisoned to NaN?"""
        for p in self._matching_engine(slot, step):
            if p.nan_logits_rate and self._roll(p, p.nan_logits_rate, "nan_logits"):
                return True
        return False

    def maybe_raise_step(self, slot: int, step: int) -> None:
        """Raise a :class:`StepFault` attributable to ``slot`` for this
        step, or return."""
        for p in self._matching_engine(slot, step):
            if p.step_raise_rate and self._roll(p, p.step_raise_rate, "step_raise"):
                raise StepFault(
                    slot,
                    f"fault injected by profile {p.name!r} (slot {slot}, step {step})",
                )

    def stats(self) -> dict[str, int]:
        """Injections so far by fault kind."""
        with self._lock:
            return dict(self._counts)

    def _matching_engine(self, slot: int | None, step: int | None) -> list[FaultProfile]:
        with self._lock:
            return [
                p
                for p in self._profiles
                if (slot is None or not p.slots or slot in p.slots)
                and (step is None or not p.steps or step in p.steps)
            ]

    def _roll(self, p: FaultProfile, rate: float, fault: str) -> bool:
        with self._lock:
            if not self._budget_ok(p):
                return False
            if self._rng.random() >= rate:
                return False
            self._record(p, fault)
            return True

    def _budget_ok(self, p: FaultProfile) -> bool:
        # called with the lock held
        return p.limit <= 0 or p.injected < p.limit

    def _record(self, p: FaultProfile, fault: str) -> None:
        # called with the lock held
        p.injected += 1
        self._counts[fault] = self._counts.get(fault, 0) + 1
