"""The client half of the topology daemon's protocol
(``k8s_dra_driver_tpu/plugin/topology_daemon.py`` ``TopologyDaemonClient``).

A shared claim's containers talk to the claim's daemon over a unix socket,
one JSON object a line each way: a request ``{"op": ..., "consumer": ...,
**fields}`` and its reply.  The ops are ``info``, ``register`` (a spatial
consumer gets its partition record back), ``acquire`` and ``release`` (the
time-slicing run lease, scoped to a set of chips).  The daemon is
``plugin/topology_daemon.py``, which re-exports this client.
"""

from __future__ import annotations

import json
import os
import socket
from typing import Optional


class TopologyDaemonClient:
    """One consumer's connection to the daemon at ``socket_path``."""

    def __init__(self, socket_path: str, consumer: str):
        self.consumer = consumer
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            self._sock.connect(socket_path)
        except OSError:
            self._sock.close()
            raise
        self._rfile = self._sock.makefile("rb")

    @classmethod
    def from_env(cls, consumer: str, environ=os.environ) -> "TopologyDaemonClient":
        """Dial the socket ``TPU_TOPOLOGY_DAEMON_SOCKET`` names."""
        path = environ.get("TPU_TOPOLOGY_DAEMON_SOCKET")
        if not path:
            raise RuntimeError("TPU_TOPOLOGY_DAEMON_SOCKET is not set")
        return cls(path, consumer)

    def call(self, op: str, **kwargs) -> dict:
        req = {"op": op, "consumer": self.consumer, **kwargs}
        self._sock.sendall((json.dumps(req) + "\n").encode())
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("daemon closed the connection")
        return json.loads(line)

    def info(self) -> dict:
        return self.call("info")

    def register(self, partition: Optional[int] = None) -> dict:
        kwargs = {} if partition is None else {"partition": partition}
        return self.call("register", **kwargs)

    def acquire(self, quantum_ms: Optional[int] = None, timeout_ms: int = 5000,
                scope: str = "") -> dict:
        """``scope`` is the chip set contended for: a consumer passes its
        ``TPU_VISIBLE_DEVICES`` so only sharers of the same chips wait on
        each other."""
        kwargs: dict = {"timeout_ms": timeout_ms}
        if quantum_ms is not None:
            kwargs["quantum_ms"] = quantum_ms
        if scope:
            kwargs["scope"] = scope
        return self.call("acquire", **kwargs)

    def release(self, scope: str = "") -> dict:
        return self.call("release", **({"scope": scope} if scope else {}))

    def close(self) -> None:
        try:
            self._rfile.close()
        finally:
            self._sock.close()
