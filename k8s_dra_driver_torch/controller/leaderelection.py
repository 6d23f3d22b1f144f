"""The port of ``k8s_dra_driver_tpu/controller/leaderelection.py``
(copied: the port imports nothing of the JAX package).  Its lease stamps
are the reference's to the second (``%Y-%m-%dT%H:%M:%SZ``, UTC), so an
elector of each package on one server agrees on holder and expiry.

Lease-based leader election (client-go leaderelection analog).

The reference runs its controller as a single-replica Deployment and ships
no leader election; multi-replica HA then risks duplicate ResourceSlice
writers.  This implements the standard coordination.k8s.io/v1 Lease
protocol: acquire when free or expired, renew while leading, step down when
the lease is lost.  Timing is injectable for deterministic tests.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from k8s_dra_driver_torch.kube.fakeserver import Conflict, NotFound
from k8s_dra_driver_torch.kube.objects import Lease, LeaseSpec, ObjectMeta


@dataclass
class LeaderElectionConfig:
    lease_name: str = "tpu-dra-controller"
    namespace: str = "tpu-dra-driver"
    identity: str = ""
    lease_duration_s: float = 15.0
    renew_period_s: float = 5.0


class LeaderElector:
    def __init__(self, server, config: LeaderElectionConfig, clock=time.time):
        self._server = server
        self.config = config
        self._clock = clock
        self.is_leader = False

    # -- one protocol step (deterministic; the run loop just repeats it) ----

    def tick(self) -> bool:
        """Try to acquire or renew; returns whether we are leader now."""
        cfg = self.config
        now = self._clock()
        try:
            lease = self._server.get(Lease.KIND, cfg.lease_name, cfg.namespace)
        except NotFound:
            lease = Lease(
                metadata=ObjectMeta(name=cfg.lease_name, namespace=cfg.namespace),
                spec=LeaseSpec(
                    holder_identity=cfg.identity,
                    lease_duration_seconds=int(cfg.lease_duration_s),
                    acquire_time=_stamp(now),
                    renew_time=_stamp(now),
                ),
            )
            try:
                self._server.create(lease)
                self.is_leader = True
                return True
            except Exception:
                self.is_leader = False
                return False

        held_by_us = lease.spec.holder_identity == cfg.identity
        expired = _parse(lease.spec.renew_time) + lease.spec.lease_duration_seconds <= now
        if not held_by_us and not expired:
            self.is_leader = False
            return False

        if not held_by_us:
            lease.spec.holder_identity = cfg.identity
            lease.spec.acquire_time = _stamp(now)
            lease.spec.lease_transitions += 1
        lease.spec.lease_duration_seconds = int(cfg.lease_duration_s)
        lease.spec.renew_time = _stamp(now)
        try:
            self._server.update(lease)  # optimistic concurrency: loser gets 409
            self.is_leader = True
            return True
        except Conflict:
            self.is_leader = False
            return False

    # -- background runner --------------------------------------------------

    def run(
        self,
        on_started_leading: Callable[[], None],
        on_stopped_leading: Callable[[], None],
        stop: threading.Event,
        sleeper: Optional[Callable[[float], None]] = None,
    ) -> None:
        """Blocking election loop (call in a thread).  Leadership changes
        invoke the callbacks exactly on the transitions."""
        sleeper = sleeper or (lambda s: stop.wait(s))
        was_leader = False
        try:
            while not stop.is_set():
                try:
                    leading = self.tick()
                except Exception:
                    # Transient API errors must not kill the election thread
                    # (client-go retries too); treat as not-leading and retry.
                    leading = False
                    self.is_leader = False
                if leading and not was_leader:
                    on_started_leading()
                elif was_leader and not leading:
                    on_stopped_leading()
                was_leader = leading
                sleeper(
                    self.config.renew_period_s
                    if leading
                    else self.config.renew_period_s / 2
                )
        finally:
            if was_leader:
                self.release()
                on_stopped_leading()

    def release(self) -> None:
        """Give up the lease on clean shutdown so a standby takes over
        immediately instead of waiting out the duration."""
        cfg = self.config
        try:
            lease = self._server.get(Lease.KIND, cfg.lease_name, cfg.namespace)
            if lease.spec.holder_identity == cfg.identity:
                lease.spec.holder_identity = ""
                lease.spec.renew_time = _stamp(0)
                self._server.update(lease)
        except Exception:
            pass
        self.is_leader = False


def _stamp(t: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t)) if t else ""


def _parse(stamp: str) -> float:
    if not stamp:
        return 0.0
    import calendar

    return calendar.timegm(time.strptime(stamp, "%Y-%m-%dT%H:%M:%SZ"))
