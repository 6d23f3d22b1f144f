"""The port of ``k8s_dra_driver_tpu/plugin/topology_daemon.py`` (copied: the port imports
nothing of the JAX package; its client is ``daemon_client.py``'s, re-exported).

    python -m k8s_dra_driver_torch.plugin.topology_daemon (--claim-uid UID | --host-mode)
        [--socket-dir DIR]

``tpu-topology-daemon`` — the per-host TPU topology daemon program.

First-party replacement for the reference's external
``nvidia-cuda-mps-control`` dependency (SURVEY.md §2.9): the reference
renders a Deployment whose container runs NVIDIA's closed daemon
(templates/mps-control-daemon.tmpl.yaml:26-42, started from
cmd/nvidia-dra-plugin/sharing.go:185-287); this module is the program our
``templates/topology-daemon.tmpl.yaml`` actually runs.

Two modes, one protocol:

* **per-claim mode** (``--claim-uid``) — spawned by ``SpatialPartitionManager``
  for one SpatialPartition claim.  Serves the claim's partition table (parsed
  from ``TPU_PARTITION_SPEC`` / ``TPU_PARTITIONS`` / ``TPU_HBM_LIMITS``) so
  each consumer container can register and observe exactly its partition —
  the MPS-daemon role of brokering per-client SM/memory division
  (sharing.go:346-366).
* **host mode** (``--host-mode``) — one per node, run as a sidecar of the
  kubelet-plugin DaemonSet.  Arbitrates cooperative run-leases between
  TimeSlicing consumers (libtpu has no preemptive timeslicing, SURVEY.md
  §2.10): a consumer ``acquire``s the chip lease for its
  ``TPU_QUEUE_QUANTUM_MS``, others block until ``release`` or lease expiry
  (a crashed holder cannot wedge the host).

Wire protocol: newline-delimited JSON over a unix stream socket
(``{socket_dir}/{claim_uid}.sock`` resp. ``{socket_dir}/host.sock``).
Requests carry ``op`` = ``info`` | ``register`` | ``acquire`` | ``release``;
every response carries ``ok``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import socketserver
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from k8s_dra_driver_torch.daemon_client import TopologyDaemonClient  # noqa: F401
from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.watchdog import WATCHDOG

# A holder that never releases is reclaimed after this many quanta — the
# cooperative analog of the reference's MPS readiness/backoff tolerances
# (sharing.go:289-344): generous to jitter, fatal to the crashed.
LEASE_GRACE_QUANTA = 4

DEFAULT_QUANTUM_MS = 5

HOST_SOCKET_NAME = "host.sock"


def host_socket_path(socket_dir: str) -> str:
    return str(Path(socket_dir) / HOST_SOCKET_NAME)


def claim_socket_path(socket_dir: str, claim_uid: str) -> str:
    return str(Path(socket_dir) / f"{claim_uid}.sock")


@dataclass
class Lease:
    consumer: str
    quantum_ms: int
    granted_at: float

    def expired(self, now: float) -> bool:
        return now >= self.granted_at + self.quantum_ms * LEASE_GRACE_QUANTA / 1000.0


@dataclass
class DaemonState:
    """Shared state behind one condition variable."""

    claim_uid: str = ""
    partition_spec: str = ""
    partitions: list[dict] = field(default_factory=list)  # by partition index
    hbm_limits: dict[str, str] = field(default_factory=dict)
    quantum_ms: int = DEFAULT_QUANTUM_MS
    consumers: dict[str, dict] = field(default_factory=dict)
    # Run leases are scoped per chip set ("scope" = the consumer's
    # TPU_VISIBLE_DEVICES): TimeSlicing consumers of DIFFERENT chips on one
    # node must not serialize against each other — only same-chip sharers
    # contend (the reference's timeslice is likewise per-GPU,
    # nvlib.go:521-539).
    leases: dict[str, Lease] = field(default_factory=dict)
    # The KV-handoff interconnect channel this host publishes (the DRA
    # claim models/disagg.py binds its HandoffChannel to) — the
    # ``deviceinfo.InterconnectChannelInfo.to_info()`` dict, or empty when
    # the host publishes no channel.
    channel: dict = field(default_factory=dict)
    # Multi-link publication: EVERY interconnect channel this host offers
    # for KV handoff (same to_info() dicts), so routers can bind a channel
    # SET per peer and fail over between links.  ``channel`` stays as the
    # legacy single-link key for old consumers.
    channels: list = field(default_factory=list)
    # Per-shape watt table (``{"1": 310, "8": 2240}`` — chip count, as a
    # JSON-string key, to whole-device watts).  Published so the scheduler
    # extender's power objective (scheduler/objectives.py) scores against
    # fleet-measured numbers instead of its built-in defaults.
    power: dict = field(default_factory=dict)


class TopologyDaemonServer:
    """The daemon core, embeddable in-process (tests) or via ``main()``.

    ``serve()`` binds the unix socket and blocks; ``start()`` runs it on a
    daemon thread and waits until the socket is accepting.
    """

    def __init__(
        self,
        socket_path: str,
        *,
        claim_uid: str = "",
        partition_spec: str = "",
        partitions: Optional[list[dict]] = None,
        hbm_limits: Optional[dict[str, str]] = None,
        quantum_ms: int = DEFAULT_QUANTUM_MS,
        channel: Optional[dict] = None,
        channels: Optional[list] = None,
        power: Optional[dict] = None,
    ):
        self.socket_path = socket_path
        chans = list(channels or [])
        if channel and not chans:
            chans = [channel]
        self.state = DaemonState(
            claim_uid=claim_uid,
            partition_spec=partition_spec,
            partitions=partitions or [],
            hbm_limits=hbm_limits or {},
            quantum_ms=quantum_ms,
            channel=channel or (chans[0] if chans else {}),
            channels=chans,
            power=power or {},
        )
        self._cond = threading.Condition()
        self._server: Optional[socketserver.ThreadingUnixStreamServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- environment parsing (the template's env contract) -----------------

    @classmethod
    def from_env(cls, socket_path: str, claim_uid: str, environ=os.environ) -> "TopologyDaemonServer":
        partitions: list[dict] = []
        raw = environ.get("TPU_PARTITIONS", "")
        if raw:
            partitions = json.loads(raw)
        hbm_limits: dict[str, str] = {}
        raw = environ.get("TPU_HBM_LIMITS", "")
        if raw:
            hbm_limits = dict(kv.split("=", 1) for kv in raw.split(",") if "=" in kv)
        channel: dict = {}
        raw = environ.get("TPU_HANDOFF_CHANNEL", "")
        if raw:
            # The interconnect-channel claim this host publishes, JSON
            # (deviceinfo.InterconnectChannelInfo.to_info() shape) —
            # injected by the template alongside TPU_PARTITIONS.
            channel = json.loads(raw)
        channels: list = []
        raw = environ.get("TPU_HANDOFF_CHANNELS", "")
        if raw:
            # Multi-link form: a JSON LIST of to_info() dicts.  Takes
            # precedence over the legacy single-channel variable.
            channels = json.loads(raw)
        power: dict = {}
        raw = environ.get("TPU_POWER_TABLE", "")
        if raw:
            # Per-shape watt table, JSON object (chip count -> watts) —
            # consumed by the extender's power objective via the info doc.
            power = json.loads(raw)
        return cls(
            socket_path,
            claim_uid=claim_uid,
            partition_spec=environ.get("TPU_PARTITION_SPEC", ""),
            partitions=partitions,
            hbm_limits=hbm_limits,
            quantum_ms=int(environ.get("TPU_QUEUE_QUANTUM_MS", DEFAULT_QUANTUM_MS)),
            channel=channel,
            channels=channels,
            power=power,
        )

    # -- request handling ---------------------------------------------------

    def handle_request(self, req: dict) -> dict:
        op = req.get("op")
        if op == "info":
            return self._info()
        if op == "register":
            return self._register(req)
        if op == "acquire":
            return self._acquire(req)
        if op == "release":
            return self._release(req)
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _info(self) -> dict:
        with self._cond:
            return {
                "ok": True,
                "claim_uid": self.state.claim_uid,
                "partition_spec": self.state.partition_spec,
                "partitions": self.state.partitions,
                "hbm_limits": self.state.hbm_limits,
                "quantum_ms": self.state.quantum_ms,
                "channel": self.state.channel,
                "channels": self.state.channels,
                "power": self.state.power,
                "consumers": sorted(self.state.consumers),
                "lease_holders": {
                    scope: lease.consumer
                    for scope, lease in self.state.leases.items()
                },
            }

    def _register(self, req: dict) -> dict:
        consumer = req.get("consumer")
        if not consumer:
            return {"ok": False, "error": "register requires 'consumer'"}
        index = req.get("partition")
        with self._cond:
            record: dict = {"registered_at": time.time()}
            partition = None
            if index is not None:
                matches = [p for p in self.state.partitions if p.get("index") == index]
                if not matches:
                    return {
                        "ok": False,
                        "error": f"no partition {index!r} "
                        f"(have {[p.get('index') for p in self.state.partitions]})",
                    }
                partition = matches[0]
                record["partition"] = index
            self.state.consumers[consumer] = record
            JOURNAL.record(
                "topology-daemon", "consumer.register",
                correlation=self.state.claim_uid, consumer=consumer,
                partition=index,
            )
            return {
                "ok": True,
                "partition": partition,
                "quantum_ms": self.state.quantum_ms,
                "hbm_limits": self.state.hbm_limits,
            }

    def _acquire(self, req: dict) -> dict:
        consumer = req.get("consumer")
        if not consumer:
            return {"ok": False, "error": "acquire requires 'consumer'"}
        scope = str(req.get("scope", "")) or "*"
        quantum_ms = int(req.get("quantum_ms") or self.state.quantum_ms)
        deadline = time.time() + float(req.get("timeout_ms", 5000)) / 1000.0
        with self._cond:
            while True:
                now = time.time()
                lease = self.state.leases.get(scope)
                if lease is not None and lease.expired(now):
                    lease = None  # reclaim from the dead
                    self.state.leases.pop(scope, None)
                if lease is None or lease.consumer == consumer:
                    self.state.leases[scope] = Lease(consumer, quantum_ms, now)
                    self._cond.notify_all()
                    return {"ok": True, "lease_ms": quantum_ms, "scope": scope}
                remaining = deadline - now
                if remaining <= 0:
                    JOURNAL.record(
                        "topology-daemon", "acquire.timeout",
                        correlation=self.state.claim_uid, consumer=consumer,
                        scope=scope, holder=lease.consumer,
                    )
                    return {"ok": False, "error": "timeout", "holder": lease.consumer}
                # Wake on release OR when the current lease would expire.
                expiry = lease.granted_at + lease.quantum_ms * LEASE_GRACE_QUANTA / 1000.0
                self._cond.wait(timeout=min(remaining, max(expiry - now, 0.001)))

    def _release(self, req: dict) -> dict:
        consumer = req.get("consumer")
        scope = str(req.get("scope", "")) or "*"
        with self._cond:
            lease = self.state.leases.get(scope)
            if lease is not None and lease.consumer == consumer:
                del self.state.leases[scope]
                self._cond.notify_all()
                return {"ok": True}
            return {"ok": True, "noop": True}

    # -- socket plumbing ----------------------------------------------------

    def serve(self) -> None:
        daemon = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        req = json.loads(line)
                        resp = daemon.handle_request(req)
                    except Exception as exc:  # malformed input must not kill the daemon
                        resp = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
                    try:
                        self.wfile.write((json.dumps(resp) + "\n").encode())
                        self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        return

        path = Path(self.socket_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.unlink(missing_ok=True)

        class Server(socketserver.ThreadingMixIn, socketserver.UnixStreamServer):
            daemon_threads = True
            allow_reuse_address = True
            guard = None  # armed by serve(); beaten from the poll loop

            def service_actions(self):
                # serve_forever calls this every poll_interval: the loop's
                # natural heartbeat — a wedged selector stops beating and
                # the watchdog dumps the daemon's stacks.
                if self.guard is not None:
                    self.guard.beat()

        self._server = Server(self.socket_path, Handler)
        JOURNAL.record(
            "topology-daemon", "serving", correlation=self.state.claim_uid,
            socket=self.socket_path,
        )
        try:
            with WATCHDOG.guard(
                "topology-daemon.poll", correlation=self.state.claim_uid
            ) as g:
                self._server.guard = g
                self._server.serve_forever(poll_interval=0.1)
        finally:
            path.unlink(missing_ok=True)

    def start(self, ready_timeout: float = 5.0) -> None:
        from k8s_dra_driver_torch.utils.retry import Backoff, RetryPolicy

        self._thread = threading.Thread(target=self.serve, daemon=True)
        self._thread.start()
        backoff = Backoff(
            RetryPolicy(
                max_attempts=0, base_delay_s=0.01, max_delay_s=0.05,
                multiplier=1.5, jitter=0.0,
            )
        )
        deadline = time.time() + ready_timeout
        while time.time() < deadline:
            if Path(self.socket_path).exists():
                try:
                    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as probe:
                        probe.connect(self.socket_path)
                    return
                except OSError:
                    pass
            backoff.sleep()
        raise RuntimeError(f"daemon socket {self.socket_path} not accepting")

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="tpu-topology-daemon", description=__doc__)
    parser.add_argument("--claim-uid", default="", help="per-claim mode: the ResourceClaim UID")
    parser.add_argument("--host-mode", action="store_true", help="per-host lease arbiter mode")
    parser.add_argument("--socket-dir", default="/run/tpu-topology")
    args = parser.parse_args(argv)
    if bool(args.claim_uid) == bool(args.host_mode):
        parser.error("exactly one of --claim-uid or --host-mode is required")
    if args.host_mode:
        path = host_socket_path(args.socket_dir)
        server = TopologyDaemonServer.from_env(path, claim_uid="")
    else:
        path = claim_socket_path(args.socket_dir, args.claim_uid)
        server = TopologyDaemonServer.from_env(path, claim_uid=args.claim_uid)
    mode = "host" if args.host_mode else f"claim {args.claim_uid}"
    print(f"tpu-topology-daemon: serving {mode} on {path}", flush=True)
    try:
        server.serve()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
