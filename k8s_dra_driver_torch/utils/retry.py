"""The port's retry, backoff and circuit-breaker policy
(``k8s_dra_driver_tpu/utils/retry.py`` but its ``ContentionBackoff``,
which only the multi-scheduler contention harness uses; copied: the port
imports nothing of the JAX package).

* :class:`RetryPolicy`: jittered exponential backoff parameters and the
  retryable-error classification (:func:`is_retryable`: 429/5xx and
  transport errors retry, other 4xx never do).
* :class:`Backoff`: the schedule of one retry or reconnect loop.
* :class:`RetryBudget`: a token bucket shared across calls, so a broad
  outage cannot amplify into a retry storm.
* :class:`CircuitBreaker`: closed, then open after N consecutive failures
  (fail fast), then half-open after a cooldown (one probe), then closed
  on success.  Its state is the ``dra_circuit_state`` gauge (0 closed, 1
  half-open, 2 open) of the port's registry and ``breaker.*`` journal
  events, as in the reference.
* :func:`call_with_retry`: the one retry loop of the REST client,
  counted on ``dra_api_retries_total`` and journalled as ``call.retry``.

Thread-safe; clocks and sleeps are injectable.
"""

from __future__ import annotations

import http.client
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.metrics import REGISTRY

_RETRIES = REGISTRY.counter(
    "dra_api_retries_total",
    "Retried API operations, by op and failure reason",
)
_CIRCUIT_STATE = REGISTRY.gauge(
    "dra_circuit_state",
    "Circuit breaker state per endpoint class (0 closed, 1 half-open, 2 open)",
)
_CIRCUIT_TRANSITIONS = REGISTRY.counter(
    "dra_circuit_transitions_total",
    "Circuit breaker state transitions, by endpoint class and target state",
)


class CircuitOpenError(OSError):
    """Fail-fast rejection while a breaker is open: an ``OSError`` with
    ``code=503``, so callers that treat transport errors as transient
    treat it as retryable later."""

    def __init__(self, message: str):
        super().__init__(message)
        self.code = 503


def is_retryable(exc: BaseException) -> bool:
    """429 and 5xx retry, other HTTP codes do not, transport-level
    failures always do (duck-typed on ``.code``)."""
    code = getattr(exc, "code", None)
    if isinstance(code, int):
        return code == 429 or code >= 500
    return isinstance(exc, (OSError, http.client.HTTPException))


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff: each delay is drawn from
    ``[delay * (1 - jitter), delay]``."""

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    retry_on: Callable[[BaseException], bool] = is_retryable


DEFAULT_POLICY = RetryPolicy()
# Watch reconnects have no attempt cap (the loop runs for the process
# lifetime); only the schedule matters.
DEFAULT_WATCH_POLICY = RetryPolicy(max_attempts=0, base_delay_s=0.2, max_delay_s=30.0)


class Backoff:
    """The schedule of one retry or reconnect loop; ``reset()`` on
    success."""

    def __init__(
        self,
        policy: RetryPolicy = DEFAULT_POLICY,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self._policy = policy
        self._rng = rng or random
        self._sleep = sleep
        self._attempt = 0

    @property
    def attempts(self) -> int:
        return self._attempt

    def next_delay(self) -> float:
        p = self._policy
        delay = min(p.max_delay_s, p.base_delay_s * (p.multiplier ** self._attempt))
        self._attempt += 1
        if p.jitter:
            delay *= 1.0 - p.jitter * self._rng.random()
        return delay

    def reset(self) -> None:
        self._attempt = 0

    def sleep(self) -> None:
        self._sleep(self.next_delay())


class RetryBudget:
    """Process-wide retry throttle: every retry spends a token, every
    success refills ``refill_per_success`` up to ``cap``; under a broad
    outage the budget drains and callers fail fast."""

    def __init__(self, cap: float = 32.0, refill_per_success: float = 0.5):
        self._cap = cap
        self._refill = refill_per_success
        self._tokens = cap
        self._lock = threading.Lock()

    def take(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def on_success(self) -> None:
        with self._lock:
            self._tokens = min(self._cap, self._tokens + self._refill)

    def remaining(self) -> float:
        with self._lock:
            return self._tokens


class CircuitBreaker:
    """Per-endpoint breaker: ``closed`` → (N consecutive failures) →
    ``open`` (fail fast) → (cooldown) → ``half_open`` (one probe) →
    ``closed`` on success, back to ``open`` on failure."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"
    _GAUGE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(
        self,
        endpoint: str = "",
        failure_threshold: int = 5,
        reset_timeout_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.endpoint = endpoint
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        _CIRCUIT_STATE.set(0, endpoint=endpoint)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a request proceed now?  While half-open exactly one probe
        is admitted; its outcome decides the next state."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at < self.reset_timeout_s:
                    return False
                self._transition(self.HALF_OPEN)
                self._probing = True
                return True
            if not self._probing:
                self._probing = True
                return True
            return False

    def on_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != self.CLOSED:
                self._transition(self.CLOSED)

    def on_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._state == self.HALF_OPEN or (
                self._state == self.CLOSED and self._failures >= self.failure_threshold
            ):
                self._opened_at = self._clock()
                self._transition(self.OPEN)

    def cooldown_remaining(self) -> float:
        """Seconds until an open breaker admits its half-open probe (0.0
        when closed or already eligible); looks without transitioning."""
        with self._lock:
            if self._state != self.OPEN:
                return 0.0
            return max(0.0, self.reset_timeout_s - (self._clock() - self._opened_at))

    def trip(self) -> None:
        """Open now, bypassing the failure count: for a caller with direct
        evidence that the endpoint is dead (a replica crash)."""
        with self._lock:
            self._failures = max(self._failures, self.failure_threshold)
            self._probing = False
            if self._state != self.OPEN:
                self._opened_at = self._clock()
                self._transition(self.OPEN)

    def _transition(self, to: str) -> None:
        # called with the lock held
        self._state = to
        _CIRCUIT_STATE.set(self._GAUGE_VALUE[to], endpoint=self.endpoint)
        _CIRCUIT_TRANSITIONS.inc(endpoint=self.endpoint, to=to)
        JOURNAL.record("retry", f"breaker.{to}", correlation=self.endpoint,
                       failures=self._failures)


def _reason(exc: BaseException) -> str:
    code = getattr(exc, "code", None)
    return str(code) if isinstance(code, int) else type(exc).__name__


def call_with_retry(
    fn: Callable[[], object],
    *,
    policy: RetryPolicy = DEFAULT_POLICY,
    breaker: Optional[CircuitBreaker] = None,
    budget: Optional[RetryBudget] = None,
    op: str = "",
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
):
    """Run ``fn`` under the policy.  Raises the last error when attempts,
    budget or classification say stop; raises :class:`CircuitOpenError`
    without calling ``fn`` while the breaker is open."""
    backoff = Backoff(policy, rng=rng, sleep=sleep)
    attempt = 1
    while True:
        if breaker is not None and not breaker.allow():
            raise CircuitOpenError(f"circuit open for {breaker.endpoint or op or 'endpoint'}")
        try:
            result = fn()
        except Exception as exc:
            retryable = policy.retry_on(exc)
            if breaker is not None and retryable:
                breaker.on_failure()
            if (
                not retryable
                or attempt >= policy.max_attempts
                or (budget is not None and not budget.take())
            ):
                raise
            _RETRIES.inc(op=op, reason=_reason(exc))
            JOURNAL.record(
                "retry", "call.retry", correlation=op,
                attempt=attempt, error=f"{type(exc).__name__}: {exc}",
            )
            backoff.sleep()
            attempt += 1
        else:
            if breaker is not None:
                breaker.on_success()
            if budget is not None:
                budget.on_success()
            return result
