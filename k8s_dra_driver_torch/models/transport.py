"""The real multi-process KV transport for disaggregated serving
(``k8s_dra_driver_tpu/models/transport.py``, copied: the port imports
nothing of the JAX package).  Every frame is the reference's byte for
byte, and the metric names, journal events and fault draws are its own.

    python -m k8s_dra_driver_torch.models.transport cfg.json [--device cpu]

runs one worker process.  ``cfg.json`` is the reference's worker document
unchanged: ``cfg`` (the ``ModelConfig`` fields), ``engines`` (a list of
``{"kind": "dense" | "paged", ...engine keyword arguments}``), ``seed``,
and the supervisor's ``host``/``port``, the worker's ``name`` and
``role`` ("prefill" submits every request with ``handoff=True``),
``hold_ticks``, ``telem_interval_s``, ``prefix_gossip`` and
``redial_attempts``.  The worker runs on the card unless ``--device cpu``
is given; without a card it exits 2 before it dials.  It prints
``{"ready": true, "pid": ...}`` once it has dialed, and on exit one line
to stderr, ``worker kernel launches: {...}``, the kernel launches it made
by ``module:kernel`` since it started or since the last
``CONTROL {"op": "zero_launches"}``, the port's own op (a reference worker
ignores it), which sets the counts to 0 so that a supervisor's warm-up
stays out of them.

Layers, bottom up:

* framing: every message is ``u32 length + u8 type + body``; KV, PLACE and
  HANDOFF bodies are ``u32 meta_len + meta JSON + serve.KVSlice wire
  bytes``.  :class:`FrameBuffer` takes bytes in any split and yields whole
  frames;
* connections: :class:`SocketConn` (a non-blocking socket) and
  :class:`LoopbackConn` (in-memory pipes) share one seam where the
  socket-level fault hooks fire (``utils/faults``: ``sock_truncate``,
  ``sock_reset``, ``sock_latency_ms``, ``sock_partition``, ``peer_hang``);
  a dead peer is a typed :class:`PeerDiedError`;
* the supervisor half (reference ``:347-1575``, ``:1886-1983``):
  :class:`PeerLink` (one supervised peer: PING/PONG heartbeats with RTT
  and an NTP half-RTT clock offset, liveness, a per-peer
  ``CircuitBreaker`` at ``transport/<peer>``, backoff-paced reconnect);
  :class:`TransportChannel`, a ``disagg.HandoffChannel`` whose
  ``complete()`` sends the payload through the link and waits for the
  receiver's ACK (the receiver's ``KVSlice.from_wire`` is the integrity
  check; the wire adds ``reset``/``truncated``/``hang``/
  ``transport_down`` to the channel's outcomes);
  :class:`WireReceiver`, the minimal far end; :class:`RemotePool`, the
  ``FleetRouter`` drive surface over a worker's pool, which keeps every
  shipped entry KV-less (``_pending`` until PLACED, ``_resident`` until
  its completion) so a dead worker's streams drain through
  ``take_failed`` and re-serve locally, their ids in ``link.reclaimed``;
  :class:`RemoteWorkerEngine` and :func:`make_remote_engine_factory`, one
  engine replica behind a link; :class:`TransportHub`, the listening
  side that routes each worker's HELLO to its link; and
  :func:`debug_transport_doc`;
* the worker half: :class:`PoolWorker`, the protocol loop around one
  ``FleetRouter``: it answers PING, SUBMIT, PLACE, KV (its verdict is the
  ACK), CONTROL (hold, resume, reset, cancel, release, reseed,
  telem_flush, prefix_resync, and the port's zero_launches) and
  PREFIXREQ, and ships COMPLETION, HANDOFF, TELEM and the prefix gossip; :func:`build_worker_router` and
  :func:`worker_main`.

Degradation ladder: live socket, then channel fallback (KV-less delivery,
the decode side re-prefills), then unified collapse (the whole transport
down: streams serve on the local pool) -- never a lost or duplicated
stream.  The module imports no engine at module scope.
"""

from __future__ import annotations

import copy
import json
import os
import socket
import struct
import sys
import time
import weakref
from collections import deque

from k8s_dra_driver_torch.models import disagg
from k8s_dra_driver_torch.models.disagg import (
    CORRUPT,
    DEADLINE,
    DROPPED,
    OK,
    HandoffChannel,
)
from k8s_dra_driver_torch.models.obs_plane import (
    FLEET,
    TELEM_BUDGET_BYTES,
    TelemetryShipper,
)
from k8s_dra_driver_torch.models.telemetry import terminal_retirer
from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.metrics import REGISTRY
from k8s_dra_driver_torch.utils.retry import Backoff, CircuitBreaker, RetryPolicy
from k8s_dra_driver_torch.utils.tracing import TRACES

_M_FRAMES = REGISTRY.counter(
    "tpu_transport_frames_total",
    "Transport frames processed, by outcome "
    "(ok/truncated/reset/hang/decode_error)",
)
_M_RECONNECTS = REGISTRY.counter(
    "tpu_transport_reconnects_total",
    "Successful peer reconnects after a transport failure",
)
_M_PEER_UP = REGISTRY.gauge(
    "tpu_transport_peer_up",
    "1 while the peer's link is connected, 0 while it is down, by endpoint",
)
_M_RTT = REGISTRY.histogram(
    "tpu_transport_rtt_seconds",
    "Heartbeat round-trip time per transport peer",
    buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0),
)
_M_CLOCK_OFFSET = REGISTRY.gauge(
    "tpu_transport_clock_offset_seconds",
    "Estimated peer monotonic-clock offset (NTP half-rtt model over "
    "PING/PONG), by endpoint — what skew-normalizes federated spans",
)

# Additional transfer outcomes the REAL wire introduces on top of the
# HandoffChannel vocabulary (ok/dropped/deadline/corrupt/no_capacity) —
# every one lands on rung 3 of the fallback ladder.
RESET = "reset"            # peer connection died mid-transfer
TRUNCATED = "truncated"    # frame cut mid-body (EOF inside a frame)
HANG = "hang"              # peer alive but silent past the ack deadline
TRANSPORT_DOWN = "transport_down"  # breaker open: not even attempted

# Frame types.
HELLO = 1
PING = 2
PONG = 3
KV = 4          # meta + KVSlice wire bytes: the transfer AND the placement
PLACE = 5       # meta only: KV-less delivery (fallback rung)
ACK = 6         # receiver's verdict on one KV frame
PLACED = 7      # receiver's verdict on one PLACE frame
SUBMIT = 8
SUBMITTED = 9
HANDOFF = 10    # worker→supervisor: a prefill handoff entry (meta + wire)
COMPLETION = 11
CONTROL = 12
TELEM = 13      # worker→supervisor: CRC'd telemetry snapshot (obs_plane)
PREFIXREQ = 14  # puller→owner: request prefix KV for a token prefix
PREFIXKV = 15   # owner→puller: meta {nonce, n_tokens} + KVSlice wire bytes
PREFIXMISS = 16  # owner→puller: meta {nonce, reason} — nothing exportable
PREFIXPUB = 17  # owner→supervisor: CRC'd gossip batch of prefix publishes
PREFIXWDL = 18  # owner→supervisor: CRC'd gossip batch of prefix withdraws

_FRAME_HEADER = struct.Struct("!IB")
MAX_FRAME_BYTES = 1 << 30  # sanity bound: a length beyond this is garbage


class PeerDiedError(OSError):
    """Typed peer death: EOF or ECONNRESET mid-frame, or a truncated send.
    Carries the peer name, the reason and, when it struck mid-transfer,
    the request id."""

    def __init__(self, peer: str, reason: str, request_id: int = -1):
        super().__init__(f"transport peer {peer!r} died: {reason}")
        self.peer = peer
        self.reason = reason
        self.request_id = int(request_id)


class TransportDownError(OSError):
    """The peer's link is down and its breaker refuses traffic — the
    caller must degrade (fallback ladder / unified collapse), not retry
    inline."""

    def __init__(self, peer: str):
        super().__init__(f"transport to peer {peer!r} is down")
        self.peer = peer


class FrameBuffer:
    """Incremental frame decoder: feed bytes in any split, drain whole
    ``(type, body)`` frames; a partial frame stays buffered."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> None:
        self._buf.extend(data)

    @property
    def partial_bytes(self) -> int:
        return len(self._buf)

    def frames(self):
        while len(self._buf) >= _FRAME_HEADER.size:
            length, ftype = _FRAME_HEADER.unpack_from(self._buf)
            if length > MAX_FRAME_BYTES:
                raise ValueError(
                    f"transport frame length {length} exceeds {MAX_FRAME_BYTES} — stream corrupt"
                )
            end = _FRAME_HEADER.size + length
            if len(self._buf) < end:
                return
            body = bytes(self._buf[_FRAME_HEADER.size:end])
            del self._buf[:end]
            yield ftype, body


def encode_frame(ftype: int, body: bytes) -> bytes:
    return _FRAME_HEADER.pack(len(body), ftype) + body


def encode_meta_frame(ftype: int, meta: dict, wire: bytes = b"") -> bytes:
    """KV/PLACE/HANDOFF body: ``u32 meta_len + meta_json + kv_wire``."""
    mj = json.dumps(meta).encode()
    return encode_frame(ftype, struct.pack("!I", len(mj)) + mj + wire)


def decode_meta_frame(body: bytes) -> "tuple[dict, bytes]":
    (mlen,) = struct.unpack_from("!I", body)
    meta = json.loads(body[4:4 + mlen].decode())
    return meta, body[4 + mlen:]


class LoopbackConn:
    """In-memory byte pipe behind the :class:`SocketConn` seam.  Bytes
    sent before ``close()`` stay readable (data in flight lands before
    the FIN)."""

    def __init__(self, peer: str = "loopback", fault_injector=None):
        self.peer = peer
        self.fault_injector = fault_injector
        self._out: deque | None = None  # the peer's inbox
        self._in: deque = deque()
        self.closed = False
        self._sent_frames = 0  # steps= scope of sock_partition
        self._peer_conn: "LoopbackConn | None" = None

    @staticmethod
    def pair(peer_a: str = "supervisor", peer_b: str = "worker",
             fault_injector=None) -> "tuple[LoopbackConn, LoopbackConn]":
        a, b = LoopbackConn(peer_b, fault_injector), LoopbackConn(peer_a)
        a._out, b._out = b._in, a._in
        a._peer_conn, b._peer_conn = b, a
        return a, b

    def send(self, data: bytes, request_id: int = -1) -> float:
        """Returns the accounted wire latency (seconds).  A truncated or
        reset send kills the pipe as a socket's would: the receiver sees
        the partial bytes, then EOF."""
        if self.closed:
            raise PeerDiedError(self.peer, "send on closed conn", request_id)
        inj = self.fault_injector
        latency = 0.0
        if inj is not None:
            latency = inj.take_sock_latency()
            if inj.take_sock_reset(self.peer):
                self.close()
                raise PeerDiedError(self.peer, RESET, request_id)
            if inj.take_sock_truncate(self.peer):
                self._out.append(bytes(data[: max(1, len(data) // 2)]))
                self.close()
                raise PeerDiedError(self.peer, TRUNCATED, request_id)
            self._sent_frames += 1
            if inj.take_sock_partition(self.peer, self._sent_frames):
                return latency  # the frame vanishes; the pipe stays open
        self._out.append(bytes(data))
        return latency

    def recv_available(self) -> bytes:
        """Every buffered byte; ``b""`` when none.  Raises
        :class:`PeerDiedError` on EOF (peer closed, buffer empty)."""
        if self._in:
            return b"".join([self._in.popleft() for _ in range(len(self._in))])
        if self.closed or (self._peer_conn is not None and self._peer_conn.closed):
            raise PeerDiedError(self.peer, "eof")
        return b""

    def close(self) -> None:
        self.closed = True


class SocketConn:
    """One non-blocking stream socket behind the same seam as
    :class:`LoopbackConn`: the same fault hooks, the same typed death."""

    def __init__(self, sock: socket.socket, peer: str, fault_injector=None,
                 send_timeout_s: float = 10.0):
        self.sock = sock
        self.peer = peer
        self.fault_injector = fault_injector
        self.send_timeout_s = send_timeout_s
        self.closed = False
        self._sent_frames = 0  # steps= scope of sock_partition
        sock.setblocking(False)

    def send(self, data: bytes, request_id: int = -1) -> float:
        if self.closed:
            raise PeerDiedError(self.peer, "send on closed conn", request_id)
        inj = self.fault_injector
        latency = 0.0
        if inj is not None:
            latency = inj.take_sock_latency()
            if inj.take_sock_reset(self.peer):
                self.close()
                raise PeerDiedError(self.peer, RESET, request_id)
            if inj.take_sock_truncate(self.peer):
                try:
                    self.sock.settimeout(self.send_timeout_s)
                    self.sock.sendall(data[: max(1, len(data) // 2)])
                except OSError:
                    pass
                self.close()
                raise PeerDiedError(self.peer, TRUNCATED, request_id)
            self._sent_frames += 1
            if inj.take_sock_partition(self.peer, self._sent_frames):
                return latency  # the frame vanishes; the socket stays open
        try:
            self.sock.settimeout(self.send_timeout_s)
            self.sock.sendall(data)
            self.sock.setblocking(False)
        except socket.timeout:
            self.close()
            raise PeerDiedError(self.peer, HANG, request_id)
        except OSError as exc:
            self.close()
            raise PeerDiedError(self.peer, f"{RESET}: {exc}", request_id)
        return latency

    def recv_available(self) -> bytes:
        if self.closed:
            raise PeerDiedError(self.peer, "recv on closed conn")
        chunks = []
        while True:
            try:
                data = self.sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                break
            except OSError as exc:
                self.close()
                raise PeerDiedError(self.peer, f"{RESET}: {exc}")
            if data == b"":
                if chunks:
                    break  # deliver what arrived; EOF surfaces next poll
                self.close()
                raise PeerDiedError(self.peer, "eof")
            chunks.append(data)
        return b"".join(chunks)

    def close(self) -> None:
        self.closed = True
        try:
            self.sock.close()
        except OSError:
            pass


class PeerLink:
    """One supervised transport peer: framing, heartbeats, liveness,
    per-peer breaker, paced reconnect, and per-type frame inboxes.

    Everything is pumped on the caller's thread (:meth:`pump`), the same
    externally-driven discipline as the engines and routers — no I/O
    threads, so chaos tests replay deterministically."""

    def __init__(
        self,
        peer: str,
        conn=None,
        *,
        connect_fn=None,
        clock=time.monotonic,
        heartbeat_interval_s: float = 0.5,
        liveness_timeout_s: float = 5.0,
        ack_timeout_s: float = 5.0,
        breaker: CircuitBreaker | None = None,
        reconnect_policy: RetryPolicy | None = None,
    ):
        self.peer = peer
        self.endpoint = f"transport/{peer}"
        self.conn = conn
        self.connect_fn = connect_fn
        self.clock = clock
        self.heartbeat_interval_s = heartbeat_interval_s
        self.liveness_timeout_s = liveness_timeout_s
        self.ack_timeout_s = ack_timeout_s
        self.breaker = breaker or CircuitBreaker(
            endpoint=self.endpoint, clock=clock
        )
        self.backoff = Backoff(reconnect_policy or RetryPolicy())
        self.frames_in = FrameBuffer()
        self.inbox: dict[int, deque] = {}
        self.dead = conn is None
        self.death_reason = "" if conn is not None else "never connected"
        self.reconnects = 0
        self.in_flight_rid = -1  # attributed to mid-frame deaths
        # rids whose streams the supervisor reclaimed (re-served locally)
        # after a death/hang: late frames for them are dropped, never
        # double-delivered.
        self.reclaimed: set[int] = set()
        self.on_reconnect: list = []  # callbacks, called after adopt()
        now = clock()
        self._last_pong_at = now
        self._last_ping_at = 0.0
        self._retry_at = 0.0
        self.last_rtt_s = None
        # NTP half-rtt skew estimate: (peer_clock - local_clock), EWMA'd
        # across heartbeats.  None until the first timestamped PONG lands.
        self.clock_offset_s: float | None = None
        _M_PEER_UP.set(0.0 if self.dead else 1.0, endpoint=self.endpoint)

    # -- liveness ------------------------------------------------------------

    def alive(self) -> bool:
        return not self.dead

    def _die(self, reason: str, request_id: int = -1) -> None:
        if self.dead:
            return
        self.dead = True
        self.death_reason = reason
        rid = request_id if request_id >= 0 else self.in_flight_rid
        if self.conn is not None:
            self.conn.close()
        self.breaker.trip()  # direct evidence: the endpoint is a corpse
        _M_PEER_UP.set(0.0, endpoint=self.endpoint)
        if TRUNCATED in reason:
            outcome = TRUNCATED
        elif "heartbeat" in reason or HANG in reason:
            outcome = HANG
        else:  # eof / econnreset / closed conn: connection-level death
            outcome = RESET
        _M_FRAMES.inc(outcome=outcome)
        JOURNAL.record(
            "transport", "peer.dead", correlation=self.endpoint,
            reason=reason, request_id=rid,
        )

    def adopt(self, conn) -> None:
        """Install a fresh connection for this peer (a worker redialed the
        hub, or ``connect_fn`` produced a new pipe).  A live inbound
        connection IS the successful probe — the breaker closes and the
        backoff resets."""
        self.conn = conn
        self.frames_in = FrameBuffer()
        was_dead = self.dead
        self.dead = False
        self.death_reason = ""
        now = self.clock()
        self._last_pong_at = now
        self._last_ping_at = 0.0
        self.breaker.on_success()
        self.backoff.reset()
        _M_PEER_UP.set(1.0, endpoint=self.endpoint)
        if was_dead:
            self.reconnects += 1
            _M_RECONNECTS.inc()
            JOURNAL.record(
                "transport", "peer.reconnected", correlation=self.endpoint,
                reconnects=self.reconnects,
            )
            for cb in list(self.on_reconnect):
                cb(self)

    def try_reconnect(self) -> bool:
        """Paced by BOTH the breaker cooldown (half-open probe admission)
        and the jittered backoff — a flapping worker can't be hammered."""
        if not self.dead or self.connect_fn is None:
            return False
        if self.clock() < self._retry_at:
            return False
        if not self.breaker.allow():
            return False
        try:
            conn = self.connect_fn()
        except OSError:
            conn = None
        if conn is None:
            self.breaker.on_failure()
            self._retry_at = self.clock() + self.backoff.next_delay()
            return False
        self.adopt(conn)
        return True

    # -- I/O -----------------------------------------------------------------

    def send_frame(self, ftype: int, body: bytes, request_id: int = -1) -> float:
        if self.dead:
            raise TransportDownError(self.peer)
        self.in_flight_rid = request_id
        try:
            return self.conn.send(encode_frame(ftype, body), request_id)
        except PeerDiedError as exc:
            self._die(exc.reason, exc.request_id)
            raise
        finally:
            self.in_flight_rid = -1

    def send_json(self, ftype: int, doc: dict) -> float:
        return self.send_frame(ftype, json.dumps(doc).encode())

    def pump(self) -> int:
        """One poll: reconnect if due, read every available frame into the
        per-type inboxes, answer pings, track pong liveness.  Returns the
        number of frames processed (progress signal for the routers)."""
        if self.dead:
            self.try_reconnect()
            if self.dead:
                return 0
        n = 0
        try:
            data = self.conn.recv_available()
        except PeerDiedError as exc:
            truncated = self.frames_in.partial_bytes > 0
            self._die(TRUNCATED if truncated else exc.reason)
            return 0
        if data:
            self.frames_in.feed(data)
            try:
                for ftype, body in self.frames_in.frames():
                    n += 1
                    self._dispatch(ftype, body)
            except ValueError as exc:  # insane frame length: stream corrupt
                _M_FRAMES.inc(outcome="decode_error")
                self._die(f"corrupt stream: {exc}")
                return n
        now = self.clock()
        if now - self._last_ping_at >= self.heartbeat_interval_s:
            self._last_ping_at = now
            try:
                self.send_json(PING, {"t": now})
            except (PeerDiedError, TransportDownError):
                return n
        if now - self._last_pong_at > self.liveness_timeout_s:
            self._die("heartbeat: pong overdue")
        return n

    def _dispatch(self, ftype: int, body: bytes) -> None:
        if ftype == PING:
            doc = json.loads(body.decode())
            # Stamp OUR clock into the echo so the pinger can estimate
            # the skew between the two monotonic domains.
            doc["pt"] = self.clock()
            try:
                self.send_json(PONG, doc)
            except (PeerDiedError, TransportDownError):
                pass
            return
        if ftype == PONG:
            doc = json.loads(body.decode())
            now = self.clock()
            self._last_pong_at = now
            rtt = max(0.0, now - float(doc.get("t", now)))
            self.last_rtt_s = rtt
            _M_RTT.observe(rtt)
            if "pt" in doc:
                # Classic NTP single-exchange estimate: the peer stamped
                # pt halfway through a round trip that took rtt, so
                # offset = pt - (t + rtt/2) maps the peer's monotonic
                # domain onto ours.  EWMA smooths jittered exchanges.
                offset = float(doc["pt"]) - (float(doc.get("t", now)) + rtt / 2.0)
                if self.clock_offset_s is None:
                    self.clock_offset_s = offset
                else:
                    self.clock_offset_s = (
                        0.8 * self.clock_offset_s + 0.2 * offset
                    )
                _M_CLOCK_OFFSET.set(self.clock_offset_s, endpoint=self.endpoint)
            return
        self.inbox.setdefault(ftype, deque()).append(body)

    def take(self, ftype: int):
        q = self.inbox.get(ftype)
        if q:
            return q.popleft()
        return None

    def stats(self) -> dict:
        return {
            "peer": self.peer,
            "endpoint": self.endpoint,
            "alive": not self.dead,
            "death_reason": self.death_reason,
            "breaker": self.breaker.state,
            "breaker_cooldown_s": round(self.breaker.cooldown_remaining(), 3),
            "reconnects": self.reconnects,
            "last_rtt_s": self.last_rtt_s,
            "clock_offset_s": self.clock_offset_s,
            "pong_age_s": round(self.clock() - self._last_pong_at, 3),
            "reclaimed": len(self.reclaimed),
        }


class TransportChannel(HandoffChannel):
    """A :class:`HandoffChannel` whose transfers physically cross a
    :class:`PeerLink`: ``complete()`` wire-encodes the payload
    (``KVSlice.to_wire``), sends it, and pumps for the receiver's decode
    ACK — so the checksum verdict comes from the bytes that actually
    crossed, not from the sender's own copy.  Budget/deadline arithmetic,
    in-flight accounting and the outcome vocabulary are inherited; the
    real wire adds ``reset`` / ``truncated`` / ``hang`` /
    ``transport_down``, all landing on the same fallback rung.

    ``peer_pump`` is the in-process far end's poll (a
    :class:`WireReceiver` or :class:`PoolWorker`) for single-process
    rigs; with a real worker process it is None and the link's socket is
    polled directly.

    A TransportChannel is a valid :class:`~k8s_dra_driver_torch.models.
    disagg.ChannelSet` member: pass prebuilt instances (one per physical
    link to the peer) and the set scores them like replicas, failing a
    mid-transfer link over to a sibling before the router's re-prefill
    ladder runs."""

    def __init__(self, link: PeerLink, *, peer_pump=None, remote_place=False,
                 **kwargs):
        super().__init__(**kwargs)
        self.link = link
        self.peer_pump = peer_pump
        self.remote_place = remote_place
        # rid -> (trace_id, span_id, parent_id, t_send): the in-flight
        # wire hop, recorded as a SpanRecord when the transfer resolves.
        self._wire_spans: dict[int, tuple] = {}
        _LIVE_TRANSPORTS.add(self)

    @property
    def down(self) -> bool:
        return self.link.dead

    def tick(self) -> int:
        """Pump the link once (heartbeats, liveness, reconnect) — called
        by the router ahead of driving staged transfers."""
        n = self.link.pump()
        if self.peer_pump is not None and not self.link.dead:
            n += self.peer_pump()
            n += self.link.pump()
        return n

    def complete(self, transfer, kv, entry=None) -> str:
        """Resolve one transfer over the real wire.  Outcome order mirrors
        the in-process channel: injected drop, then the deadline ladder on
        ACCOUNTED latency (bytes/bandwidth + injected handoff/sock
        latency — checked BEFORE the send so a stale payload is never
        delivered remotely), then the physical send/ACK exchange."""
        rid = transfer.request_id
        latency = transfer.nbytes / max(self.bandwidth_gbps * 1e9 / 8.0, 1.0)
        inj = self.fault_injector
        if inj is not None:
            latency += inj.take_handoff_latency()
            latency += inj.take_sock_latency()
        transfer.latency_s = latency
        if inj is not None and inj.take_handoff_drop(rid):
            return self._finish(transfer, DROPPED)
        if latency > self.transfer_deadline_s:
            return self._finish(transfer, DEADLINE)
        if self.link.dead and not self.link.try_reconnect():
            return self._finish(transfer, TRANSPORT_DOWN)
        wire = kv.to_wire(rid)
        if inj is not None and inj.take_handoff_corrupt(rid):
            # Flip a payload bit ON THE WIRE — the receiver's from_wire
            # checksum must catch it; the sender's copy stays pristine.
            wire = bytearray(wire)
            wire[-9] ^= 0x20
            wire = bytes(wire)
        meta = _sanitize_entry(entry) if entry is not None else {
            "request_id": rid
        }
        meta["_correlation"] = f"handoff-req-{rid}"
        # Distributed-tracing context: the wire hop gets its own span
        # (parented to the prefill hop when the HANDOFF frame named one),
        # and the receiver parents its decode hop to the wire span.  The
        # hop note survives the worker: if the peer dies mid-transfer the
        # supervisor attributes the dead hop into the same tree.
        ctx = FLEET.hop_ctx(rid) or {}
        trace_id = ctx.get("trace_id") or f"req-{rid}"
        wire_span_id = TRACES.mint_id("hop.wire")
        meta["_trace"] = {"tid": trace_id, "parent": wire_span_id}
        FLEET.note_hop(rid, trace_id, wire_span_id, instance=self.link.peer)
        self._wire_spans[rid] = (
            trace_id, wire_span_id, ctx.get("parent_id", ""), time.monotonic()
        )
        try:
            latency += self.link.send_frame(
                KV, encode_meta_frame(KV, meta, wire)[_FRAME_HEADER.size:],
                request_id=rid,
            )
            transfer.latency_s = latency
        except (PeerDiedError, TransportDownError) as exc:
            reason = getattr(exc, "reason", RESET)
            outcome = TRUNCATED if TRUNCATED in reason else RESET
            return self._finish(transfer, outcome)
        ack = self._await_ack(rid)
        if ack is None:
            # Peer died or went silent mid-transfer: typed, rid-attributed.
            self.link.reclaimed.add(rid)
            if self.link.dead:
                outcome = (
                    TRUNCATED
                    if TRUNCATED in self.link.death_reason else RESET
                )
            else:
                outcome = HANG
                self.link.breaker.on_failure()
                JOURNAL.record(
                    "transport", "transfer.hang",
                    correlation=f"req-{rid}", peer=self.link.peer,
                )
            return self._finish(transfer, outcome)
        outcome = str(ack.get("outcome", CORRUPT))
        if outcome == OK:
            _M_FRAMES.inc(outcome=OK)
            if entry is not None and ack.get("placed"):
                entry["_placed_remote"] = True
        else:
            _M_FRAMES.inc(outcome="decode_error")
        return self._finish(transfer, outcome)

    def _await_ack(self, rid: int) -> dict | None:
        """Pump until the receiver's ACK for ``rid`` arrives, the peer
        dies, or ``ack_timeout_s`` of wall clock elapses (the mid-transfer
        hang bound — liveness pings continue underneath).  Stale ACKs for
        reclaimed rids are dropped."""
        deadline = time.monotonic() + self.link.ack_timeout_s
        while True:
            self.link.pump()
            if self.peer_pump is not None and not self.link.dead:
                self.peer_pump()
            while True:
                body = self.link.take(ACK)
                if body is None:
                    break
                doc = json.loads(body.decode())
                arid = int(doc.get("rid", -1))
                if arid == rid:
                    return doc
                if arid not in self.link.reclaimed:
                    # An ack we weren't waiting for — protocol skew.
                    JOURNAL.record(
                        "transport", "ack.unexpected",
                        correlation=f"req-{arid}", peer=self.link.peer,
                    )
            if self.link.dead:
                return None
            if time.monotonic() >= deadline:
                return None
            if self.peer_pump is None:
                time.sleep(0.002)

    def _finish(self, transfer, outcome: str) -> str:
        transfer.outcome = outcome
        span = self._wire_spans.pop(transfer.request_id, None)
        if span is not None:
            trace_id, span_id, parent_id, t_send = span
            TRACES.record(
                trace_id, "hop.wire", t_send, time.monotonic(),
                span_id=span_id, parent_id=parent_id,
                peer=self.link.peer, outcome=outcome,
                nbytes=transfer.nbytes, request_id=transfer.request_id,
            )
        self._in_flight.pop(transfer.request_id, None)
        self.in_flight_bytes -= transfer.nbytes
        # Metric + counts + journal via the parent's bookkeeping path.
        disagg._M_INFLIGHT.set(self.in_flight_bytes)
        disagg._M_XFER_BYTES.observe(float(transfer.nbytes))
        self._count(outcome)
        if outcome == OK:
            self.bytes_moved += transfer.nbytes
        JOURNAL.record_lazy(
            "transport", f"transfer.{outcome}",
            correlation=f"req-{transfer.request_id}",
            attrs=lambda: dict(
                nbytes=transfer.nbytes,
                latency_s=round(transfer.latency_s, 6),
                peer=self.link.peer,
                channel=self.claim.name,
            ),
        )
        return outcome

    def stats(self) -> dict:
        doc = super().stats()
        doc["link"] = self.link.stats()
        return doc


def _sanitize_entry(entry: dict) -> dict:
    """The JSON-safe half of a snapshot entry (everything but the KVSlice
    and transport-internal keys) — what rides in a frame's meta document
    and what the supervisor retains for zero-loss recovery."""
    return {
        k: v for k, v in entry.items()
        if k != "kv" and not k.startswith("_")
    }


class WireReceiver:
    """The minimal far end: decodes KV frames off a conn, ACKs with the
    integrity verdict, answers pings.  Used by the in-process storms and
    by ``check_transport_overhead`` so the full encode→wire→decode path
    runs without a worker process.  Decoded payloads are handed back via
    ``delivered`` — the supervisor installs the bytes that CROSSED, not
    its own copy."""

    def __init__(self, conn, fault_injector=None, clock=time.monotonic):
        self.conn = conn
        self.fault_injector = fault_injector
        self.clock = clock
        self.frames = FrameBuffer()
        self.delivered: dict[int, object] = {}
        self.dead = False

    def pump(self) -> int:
        from k8s_dra_driver_torch.models.serve import KVSlice, WireFormatError

        if self.dead:
            return 0
        inj = self.fault_injector
        if inj is not None and inj.take_peer_hang():
            return 0  # silent stall: frames buffered, heartbeats unanswered
        try:
            data = self.conn.recv_available()
        except PeerDiedError:
            self.dead = True
            return 0
        n = 0
        if not data:
            return 0
        self.frames.feed(data)
        for ftype, body in self.frames.frames():
            n += 1
            if ftype == PING:
                try:
                    doc = json.loads(body.decode())
                except ValueError:
                    doc = {}
                doc["pt"] = self.clock()
                self._send_json(PONG, doc)
            elif ftype == KV:
                meta, wire = decode_meta_frame(body)
                rid = int(meta.get("request_id", -1))
                try:
                    wrid, kv = KVSlice.from_wire(wire)
                    if wrid != rid:
                        raise WireFormatError(
                            f"frame rid {wrid} != meta rid {rid}", wrid
                        )
                    self.delivered[rid] = kv
                    self._send_json(ACK, {
                        "rid": rid, "outcome": OK, "placed": False,
                    })
                except WireFormatError as exc:
                    self._send_json(ACK, {
                        "rid": rid if rid >= 0 else exc.request_id,
                        "outcome": CORRUPT, "error": str(exc),
                    })
        return n

    def _send(self, ftype: int, body: bytes) -> None:
        try:
            self.conn.send(encode_frame(ftype, body))
        except PeerDiedError:
            self.dead = True

    def _send_json(self, ftype: int, doc: dict) -> None:
        self._send(ftype, json.dumps(doc).encode())


class RemotePool:
    """Supervisor-side proxy for a pool hosted in a worker process,
    presenting the FleetRouter drive surface DisaggRouter consumes:
    ``submit`` / ``place`` / ``tick`` / ``completions`` / ``idle`` /
    ``take_handoffs`` / ``_owner`` / ``stats``.

    Zero-loss contract: every entry shipped to the worker is retained
    KV-less (``_pending`` until the worker acknowledges placement,
    ``_resident`` until its completion lands).  When the peer dies, all
    retained entries drain through :meth:`take_failed` and the router
    re-serves them locally — and their rids join ``link.reclaimed`` so a
    half-dead worker's late completions are dropped, never duplicated."""

    _seq = 0

    def __init__(self, link: PeerLink, name: str = "", clock=time.monotonic,
                 peer_pump=None):
        RemotePool._seq += 1
        self.seq = RemotePool._seq
        self.link = link
        self.name = name or f"remote-{link.peer}"
        self.clock = clock
        self.peer_pump = peer_pump  # in-process far end's poll (tests)
        self._owner: dict[int, str] = {}
        self._pending: dict[int, dict] = {}
        self._resident: dict[int, dict] = {}
        # rids whose handoff/completion frame arrived BEFORE the submit
        # response registered them (the worker can finish a short prompt
        # inside the submit RPC window) — their registration is skipped.
        self._departed: set[int] = set()
        self._failed: list[dict] = []
        self._completions: list = []
        self._handoffs: list[dict] = []
        self._submit_seq = 0
        self.replicas = ()  # the real replicas live in the worker
        link.on_reconnect.append(self._on_reconnect)
        _LIVE_REMOTE_POOLS.add(self)

    # -- FleetRouter surface -------------------------------------------------

    def _normalize(self, req) -> dict:
        if isinstance(req, dict):
            out = dict(req)
            out["prompt"] = list(out["prompt"])
            return out
        prompt, max_tokens = req
        return {"prompt": list(prompt), "max_tokens": max_tokens}

    def submit(self, prompt, max_tokens: int, **kwargs) -> int:
        """Synchronous submit RPC.  Raises RuntimeError when the worker
        refuses (pool full) or the link is down — the same contract as
        ``FleetRouter.submit``, so admission FIFO semantics hold (the
        queue head waits, nothing is lost)."""
        if self.link.dead and not self.link.try_reconnect():
            raise RuntimeError(f"remote pool {self.name}: transport down")
        self._submit_seq += 1
        seq = self._submit_seq
        doc = {
            "seq": seq, "prompt": [int(t) for t in prompt],
            "max_tokens": int(max_tokens),
            "kwargs": {
                k: v for k, v in kwargs.items() if not k.startswith("_")
            },
        }
        try:
            self.link.send_json(SUBMIT, doc)
        except (PeerDiedError, TransportDownError):
            self._collect_failures()
            raise RuntimeError(f"remote pool {self.name}: peer died on submit")
        deadline = time.monotonic() + self.link.ack_timeout_s
        while True:
            self.link.pump()
            if self.peer_pump is not None and not self.link.dead:
                self.peer_pump()
            self._drain_frames()
            body = self.link.take(SUBMITTED)
            if body is not None:
                resp = json.loads(body.decode())
                if int(resp.get("seq", -1)) != seq:
                    continue
                if not resp.get("ok"):
                    raise RuntimeError(
                        f"remote pool {self.name} refused submit: "
                        f"{resp.get('error', 'full')}"
                    )
                rid = int(resp["rid"])
                if rid in self._departed:
                    self._departed.discard(rid)
                    return rid
                self._owner[rid] = self.link.peer
                FLEET.note_hop(rid, f"req-{rid}", instance=self.link.peer)
                # Submit-time retention is a RESUBMIT doc, not a snapshot
                # entry: the sampler key lives in the worker's engine, so
                # on crash the router re-submits the original request
                # (same prompt, same seed kwargs) instead of place()-ing.
                self._resident[rid] = {
                    "request_id": rid,
                    "prompt": doc["prompt"],
                    "max_tokens": doc["max_tokens"],
                    "kwargs": {
                        k: v for k, v in doc["kwargs"].items()
                        if k != "handoff"
                    },
                    "_resubmit": True,
                }
                return rid
            if self.link.dead:
                self._collect_failures()
                raise RuntimeError(
                    f"remote pool {self.name}: peer died awaiting submit ack"
                )
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"remote pool {self.name}: submit ack timed out"
                )
            time.sleep(0.002)

    def place(self, entries, correlation: str = "") -> list[int]:
        """Deliver entries to the worker pool.  Entries the channel
        already landed (``_placed_remote``) just transfer ownership; the
        rest ship KV-less as PLACE frames (the fallback rung — the worker
        re-prefills).  Raises :class:`TransportDownError` when the link is
        down so the router can collapse to unified serving."""
        placed = []
        for entry in entries:
            rid = int(entry["request_id"])
            keep = copy.deepcopy(_sanitize_entry(entry))
            if entry.pop("_placed_remote", False):
                self._owner[rid] = self.link.peer
                self._resident[rid] = keep
                placed.append(rid)
                continue
            if self.link.dead and not self.link.try_reconnect():
                raise TransportDownError(self.link.peer)
            meta = dict(keep)
            meta["_correlation"] = correlation or f"req-{rid}"
            ctx = FLEET.hop_ctx(rid) or {}
            trace_id = ctx.get("trace_id") or f"req-{rid}"
            meta["_trace"] = {
                "tid": trace_id, "parent": ctx.get("parent_id", ""),
            }
            FLEET.note_hop(rid, trace_id, ctx.get("parent_id", ""),
                           instance=self.link.peer)
            try:
                self.link.send_frame(
                    PLACE,
                    encode_meta_frame(PLACE, meta)[_FRAME_HEADER.size:],
                    request_id=rid,
                )
            except (PeerDiedError, TransportDownError):
                self._collect_failures()
                raise TransportDownError(self.link.peer)
            self._pending[rid] = keep
        return placed

    def tick(self) -> int:
        n = self.link.pump()
        if self.peer_pump is not None and not self.link.dead:
            n += self.peer_pump()
            n += self.link.pump()
        self._drain_frames()
        if self.link.dead:
            self._collect_failures()
            self.link.try_reconnect()
        return n

    def completions(self) -> list:
        out, self._completions = self._completions, []
        return out

    def take_handoffs(self) -> list[dict]:
        out, self._handoffs = self._handoffs, []
        return out

    def take_failed(self) -> list[dict]:
        """Entries whose worker died while they were pending or resident —
        the router re-serves them (unified collapse).  Their rids are
        already in ``link.reclaimed``."""
        out, self._failed = self._failed, []
        return out

    def idle(self) -> bool:
        return not (self._pending or self._resident or self._failed)

    def admittable_replicas(self):
        return () if self.link.dead else (self,)

    def stats(self) -> dict:
        return {
            "name": self.name,
            "kind": "remote_pool",
            "link": self.link.stats(),
            "pending": len(self._pending),
            "resident": len(self._resident),
            "failed": len(self._failed),
        }

    # -- internals -----------------------------------------------------------

    @terminal_retirer
    def _drain_frames(self) -> None:
        # Legal Completion re-materialization point: the worker's engine
        # already retired the stream through its own funnel (journal +
        # telemetry ran in the worker process); this side only decodes
        # the COMPLETION frame back into the typed object.
        from k8s_dra_driver_torch.models.serve import (
            Completion,
            KVSlice,
            WireFormatError,
        )

        while True:
            body = self.link.take(PLACED)
            if body is None:
                break
            doc = json.loads(body.decode())
            rid = int(doc.get("rid", -1))
            entry = self._pending.pop(rid, None)
            if entry is not None:
                self._resident[rid] = entry
                self._owner[rid] = self.link.peer
        while True:
            body = self.link.take(COMPLETION)
            if body is None:
                break
            doc = json.loads(body.decode())
            rid = int(doc.get("request_id", -1))
            if rid in self.link.reclaimed:
                JOURNAL.record(
                    "transport", "completion.stale_dropped",
                    correlation=f"req-{rid}", peer=self.link.peer,
                )
                continue
            was_pending = self._pending.pop(rid, None) is not None
            was_resident = self._resident.pop(rid, None) is not None
            if not (was_pending or was_resident):
                self._departed.add(rid)
            self._owner.pop(rid, None)
            FLEET.forget_hop(rid)
            self._completions.append(Completion(
                request_id=rid,
                tokens=[int(t) for t in doc.get("tokens", [])],
                generated=[int(t) for t in doc.get("generated", [])],
                error=str(doc.get("error", "")),
                status=str(doc.get("status", "ok")),
            ))
        while True:
            body = self.link.take(HANDOFF)
            if body is None:
                break
            meta, wire = decode_meta_frame(body)
            rid = int(meta.get("request_id", -1))
            trace = meta.get("_trace") or {}
            if trace:
                # The prefill worker named its hop span; note it so the
                # wire span (TransportChannel.complete) parents to it.
                FLEET.note_hop(
                    rid, str(trace.get("tid") or f"req-{rid}"),
                    str(trace.get("parent", "")), instance=self.link.peer,
                )
            # The stream has left the worker pool — from here the router
            # supervises it (staging area → channel → decode pool), so
            # the crash-recovery retention ends.
            was_pending = self._pending.pop(rid, None) is not None
            was_resident = self._resident.pop(rid, None) is not None
            if not (was_pending or was_resident):
                self._departed.add(rid)
            entry = {k: v for k, v in meta.items() if not k.startswith("_")}
            if wire:
                try:
                    wrid, kv = KVSlice.from_wire(wire)
                    if wrid == rid:
                        entry["kv"] = kv
                    else:
                        _M_FRAMES.inc(outcome="decode_error")
                except WireFormatError:
                    _M_FRAMES.inc(outcome="decode_error")
                    # KV-less handoff: the decode side re-prefills.
            self._owner.pop(rid, None)
            self._handoffs.append(entry)
        while True:
            body = self.link.take(TELEM)
            if body is None:
                break
            FLEET.ingest_wire(
                self.link.peer, body,
                clock_offset_s=self.link.clock_offset_s,
            )

    def _collect_failures(self) -> None:
        """Peer death: every retained stream drains to ``take_failed`` and
        joins the reclaimed set (a late completion from a half-dead worker
        must not double-deliver)."""
        if not (self._pending or self._resident):
            return
        moved = list(self._pending.items()) + list(self._resident.items())
        self._pending.clear()
        self._resident.clear()
        for rid, entry in moved:
            self.link.reclaimed.add(rid)
            self._owner.pop(rid, None)
            self._failed.append(entry)
            # The worker that owned these hops is a corpse: whatever spans
            # it flushed before death already federated; mark the gap.
            FLEET.attribute_dead_hop(
                rid, self.link.peer, reason=self.link.death_reason
            )
        JOURNAL.record(
            "transport", "pool.reclaim", correlation=self.link.endpoint,
            streams=len(moved), reason=self.link.death_reason,
        )

    def _on_reconnect(self, link: PeerLink) -> None:
        """A peer adopted a fresh connection: tell it to drop residual
        state (a no-op for a fresh process).  The reclaimed set is kept —
        a worker that survived a connection-only blip may still finish
        streams the supervisor already re-served locally, and those late
        completions must keep being dropped, never double-delivered."""
        try:
            link.send_json(CONTROL, {"op": "reset"})
        except (PeerDiedError, TransportDownError):
            return


class RemoteWorkerEngine:
    """Engine-protocol replica whose real engine lives behind a
    :class:`PeerLink` in a worker process (or an in-process
    :class:`PoolWorker` over a loopback pair — same protocol loop
    ``worker_main`` drives).  This is what lets ``FleetAutoscaler`` scale
    up by SPAWNING A PROCESS instead of constructing an engine in the
    supervisor: ``add_replica`` protocol-checks it, seeds its id stride
    (forwarded to the worker as a ``reseed`` CONTROL frame, partitioned
    across the worker's own replicas), and routes to it like any local
    engine.

    Zero-loss contract, inherited from :class:`RemotePool`: every
    submitted stream is retained as a KV-less snapshot entry until its
    COMPLETION frame lands.  When the worker dies the fleet router's
    stall/heartbeat detectors fire (tokens stop advancing while slots
    stay resident), the replica is evacuated through the ordinary
    ``snapshot_active`` → ``release_active`` path, and the retained
    entries re-prefill on surviving replicas — the ids join
    ``link.reclaimed`` so a half-dead worker's late completions are
    dropped, never double-delivered."""

    def __init__(self, link: PeerLink, *, n_slots: int = 8,
                 sync_interval: int = 8, name: str = "",
                 clock=time.monotonic, peer_pump=None):
        from k8s_dra_driver_torch.models.telemetry import _next_seq

        self.link = link
        self.n_slots = int(n_slots)
        self.sync_interval = int(sync_interval)
        self.name = name or f"remote-engine-{link.peer}"
        self.clock = clock
        self.peer_pump = peer_pump  # in-process far end's poll (tests)
        self.engine_seq = _next_seq()
        self._resident: dict[int, dict] = {}
        self._completions: list = []
        self._departed: set[int] = set()
        self._submit_seq = 0
        self._next_id = 0
        self.bursts = 0
        self.tokens_generated = 0
        self._completed = 0
        self._statuses: dict[str, int] = {}
        self._created_at = clock()
        self._last_progress_t = self._created_at
        self._last_burst_t = self._created_at
        self._last_step_s = 0.0
        self._stat_reads = 0

    # -- admission -----------------------------------------------------------

    def free_slots(self) -> int:
        return self.n_slots - len(self._resident)

    def submit(self, prompt, max_tokens: int, **kwargs) -> int:
        """Synchronous submit RPC (the :meth:`RemotePool.submit` shape):
        SUBMIT out, pump until the seq-matched SUBMITTED lands.  Raises
        RuntimeError on a full pool, a refused submit, a dead link or an
        ack timeout — the same surface local engines present, so the
        router's admission/breaker paths need no special casing."""
        if self.free_slots() <= 0:
            raise RuntimeError("no free slot")
        if self.link.dead and not self.link.try_reconnect():
            raise RuntimeError(f"{self.name}: transport down")
        self._submit_seq += 1
        seq = self._submit_seq
        prompt = [int(t) for t in prompt]
        doc = {
            "seq": seq, "prompt": prompt, "max_tokens": int(max_tokens),
            "kwargs": {
                k: v for k, v in kwargs.items() if not k.startswith("_")
            },
        }
        try:
            self.link.send_json(SUBMIT, doc)
        except (PeerDiedError, TransportDownError):
            raise RuntimeError(f"{self.name}: peer died on submit")
        deadline = time.monotonic() + self.link.ack_timeout_s
        while True:
            self.link.pump()
            if self.peer_pump is not None and not self.link.dead:
                self.peer_pump()
            self._drain_completions()
            body = self.link.take(SUBMITTED)
            if body is not None:
                resp = json.loads(body.decode())
                if int(resp.get("seq", -1)) != seq:
                    continue
                if not resp.get("ok"):
                    raise RuntimeError(
                        f"{self.name} refused submit: "
                        f"{resp.get('error', 'full')}"
                    )
                rid = int(resp["rid"])
                self._next_id = max(self._next_id, rid + 1)
                now = self.clock()
                self._last_progress_t = now
                if rid in self._departed:
                    # Completed inside the RPC window (short prompt).
                    self._departed.discard(rid)
                    return rid
                FLEET.note_hop(rid, f"req-{rid}", instance=self.link.peer)
                # KV-less snapshot retention: enough for a surviving
                # replica's restore() to re-prefill the stream verbatim.
                self._resident[rid] = {
                    "request_id": rid,
                    "tokens": prompt,
                    "generated": [],
                    "max_tokens": int(max_tokens),
                    "prompt_len": len(prompt),
                    "ttft_slo_s": kwargs.get("ttft_slo_s"),
                    "tpot_slo_s": kwargs.get("tpot_slo_s"),
                    "queued_at": kwargs.get("queued_at", now),
                    "t_first": None,
                }
                return rid
            if self.link.dead:
                raise RuntimeError(
                    f"{self.name}: peer died awaiting submit ack"
                )
            if time.monotonic() >= deadline:
                raise RuntimeError(f"{self.name}: submit ack timed out")
            time.sleep(0.002)

    # -- stepping ------------------------------------------------------------

    def step_burst(self) -> int:
        now = self.clock()
        self._last_step_s = max(now - self._last_burst_t, 0.0)
        self._last_burst_t = now
        self.bursts += 1
        self.link.pump()
        if self.peer_pump is not None and not self.link.dead:
            self.peer_pump()
            self.link.pump()
        self._drain_completions()
        if self.link.dead:
            self.link.try_reconnect()
        return len(self._resident)

    @terminal_retirer
    def _drain_completions(self) -> None:
        # Legal re-materialization point: the worker's engine retired the
        # stream through its own funnel; this side only decodes frames.
        from k8s_dra_driver_torch.models.serve import Completion

        while True:
            body = self.link.take(COMPLETION)
            if body is None:
                break
            doc = json.loads(body.decode())
            rid = int(doc.get("request_id", -1))
            if rid in self.link.reclaimed:
                JOURNAL.record(
                    "transport", "completion.stale_dropped",
                    correlation=f"req-{rid}", peer=self.link.peer,
                )
                continue
            if self._resident.pop(rid, None) is None:
                self._departed.add(rid)
            status = str(doc.get("status", "ok"))
            generated = [int(t) for t in doc.get("generated", [])]
            self._completed += 1
            self._statuses[status] = self._statuses.get(status, 0) + 1
            self.tokens_generated += len(generated)
            self._last_progress_t = self.clock()
            FLEET.forget_hop(rid)
            self._completions.append(Completion(
                request_id=rid,
                tokens=[int(t) for t in doc.get("tokens", [])],
                generated=generated,
                error=str(doc.get("error", "")),
                status=status,
            ))
        while True:
            body = self.link.take(TELEM)
            if body is None:
                break
            FLEET.ingest_wire(
                self.link.peer, body,
                clock_offset_s=self.link.clock_offset_s,
            )

    def completions(self) -> list:
        self._drain_completions()
        out, self._completions = self._completions, []
        return out

    def cancel(self, request_id: int) -> bool:
        if request_id not in self._resident:
            return False
        try:
            self.link.send_json(CONTROL, {"op": "cancel", "rid": request_id})
        except (PeerDiedError, TransportDownError):
            return False
        # The cancelled Completion rides back on the next pump.
        return True

    # -- snapshot / restore / release (live migration) -----------------------

    def snapshot_active(self) -> dict:
        return {
            "engine": type(self).__name__,
            "next_id": self._next_id,
            "requests": [dict(e) for e in self._resident.values()],
        }

    def restore(self, snapshot: dict, merge: bool = False) -> list:
        """The add_replica id-seed doc forwards to the worker as a
        ``reseed`` CONTROL frame (stride partitioned across its
        replicas); non-empty snapshots ship entry-by-entry as KV-less
        PLACE frames and block for the PLACED acks."""
        from k8s_dra_driver_torch.models.fleet import ID_STRIDE

        entries = list(snapshot.get("requests", ()))
        if not merge and self._resident:
            raise RuntimeError("restore needs an idle engine (use merge=True)")
        if len(entries) > self.free_slots():
            raise RuntimeError(
                f"restore needs {len(entries)} slots, {self.free_slots()} free"
            )
        if self.link.dead and not self.link.try_reconnect():
            raise RuntimeError(f"{self.name}: transport down")
        base = int(snapshot.get("next_id", 0))
        self._next_id = max(self._next_id, base)
        try:
            self.link.send_json(CONTROL, {
                "op": "reseed", "next_id": base, "stride": ID_STRIDE,
            })
        except (PeerDiedError, TransportDownError):
            raise RuntimeError(f"{self.name}: peer died on reseed")
        restored: list = []
        pending: set = set()
        for e in entries:
            keep = copy.deepcopy(_sanitize_entry(e))
            rid = int(keep["request_id"])
            try:
                self.link.send_frame(
                    PLACE,
                    encode_meta_frame(
                        PLACE, dict(keep, _correlation=f"req-{rid}"),
                    )[_FRAME_HEADER.size:],
                    request_id=rid,
                )
            except (PeerDiedError, TransportDownError):
                raise RuntimeError(f"{self.name}: peer died on restore")
            pending.add(rid)
            self._resident[rid] = keep
            restored.append(rid)
        deadline = time.monotonic() + self.link.ack_timeout_s
        while pending:
            self.link.pump()
            if self.peer_pump is not None and not self.link.dead:
                self.peer_pump()
            body = self.link.take(PLACED)
            if body is not None:
                pending.discard(int(json.loads(body.decode()).get("rid", -1)))
                continue
            if self.link.dead or time.monotonic() >= deadline:
                for rid in restored:
                    self._resident.pop(rid, None)
                raise RuntimeError(f"{self.name}: restore acks lost")
            time.sleep(0.002)
        if restored:
            self._last_progress_t = self.clock()
        return restored

    def release_active(self) -> int:
        n = len(self._resident)
        for rid in self._resident:
            self.link.reclaimed.add(rid)
        self._resident.clear()
        try:
            self.link.send_json(CONTROL, {"op": "release"})
        except (PeerDiedError, TransportDownError):
            pass  # dead worker holds nothing worth releasing
        return n

    # -- protocol conformance pump -------------------------------------------

    def pump(self, requests, max_steps: int = 100_000,
             queue_limit: int | None = None) -> list:
        queue = []
        for r in requests:
            if isinstance(r, dict):
                queue.append(dict(r))
            else:
                prompt, max_tokens = r
                queue.append({"prompt": list(prompt), "max_tokens": max_tokens})
        out: list = []
        for _ in range(max_steps):
            while queue:
                kw = dict(queue[0])
                try:
                    self.submit(kw.pop("prompt"), kw.pop("max_tokens"), **kw)
                except RuntimeError:
                    break
                queue.pop(0)
            advance = getattr(self.clock, "advance", None)
            if callable(advance):
                advance(0.05)
            self.step_burst()
            out.extend(self.completions())
            if not queue and not self._resident:
                return out
        raise RuntimeError(f"remote pump did not drain in {max_steps} steps")

    # -- the load-signal contract --------------------------------------------

    def stats(self):
        """Local-knowledge EngineStats — no stats RPC per tick.  The
        detector-relevant fields behave like a real engine's: ``bursts``
        advances per step, ``uptime_s`` strictly advances per read, and
        ``heartbeat_age_s``/``tokens_generated`` freeze when the worker
        stops delivering completions — which is exactly how a dead worker
        trips the stall/heartbeat verdicts and gets evacuated."""
        from k8s_dra_driver_torch.models.telemetry import EngineStats

        now = self.clock()
        self._stat_reads += 1
        return EngineStats(
            engine=type(self).__name__,
            engine_seq=self.engine_seq,
            n_slots=self.n_slots,
            resident_slots=len(self._resident),
            free_slots=self.free_slots(),
            queue_depth=0,
            admitting=0,
            preempted=0,
            free_blocks=None,
            quarantined=0,
            shed_count=0,
            in_flight=len(self._resident),
            completed=self._completed,
            statuses=dict(self._statuses),
            tokens_generated=self.tokens_generated,
            bursts=self.bursts,
            host_syncs=self.bursts,
            last_step_s=self._last_step_s,
            sync_interval=self.sync_interval,
            uptime_s=(now - self._created_at) + self._stat_reads * 1e-9,
            heartbeat_age_s=max(0.0, now - self._last_progress_t),
            ttft_p50_s=0.0, ttft_p90_s=0.0, ttft_p99_s=0.0,
            tpot_p50_s=0.0, tpot_p90_s=0.0, tpot_p99_s=0.0,
            queue_wait_p50_s=0.0, queue_wait_p90_s=0.0,
        )


def make_remote_engine_factory(worker_factory=None, *, link_factory=None,
                               n_slots: int = 8, sync_interval: int = 8,
                               name_prefix: str = "rworker",
                               clock=time.monotonic, link_kwargs=None):
    """Zero-arg engine factory for :class:`FleetAutoscaler`'s flagged
    remote-spawn path (``autoscaler.select_engine_factory``).

    Two rigs, one protocol:

    * ``worker_factory`` — in-process: each call builds a fresh
      ``LoopbackConn`` pair and a :class:`PoolWorker` around the router
      ``worker_factory()`` returns (the same protocol loop
      ``worker_main`` drives, minus the process), pumped via
      ``peer_pump``.  This is what the chaos tests use.
    * ``link_factory`` — process-backed: each call returns a live
      :class:`PeerLink` (e.g. ``hub.link_for(name)`` after spawning
      ``python -m k8s_dra_driver_torch.models.transport config.json``);
      the worker pumps itself.

    Exactly one of the two must be provided."""
    if (worker_factory is None) == (link_factory is None):
        raise ValueError(
            "make_remote_engine_factory needs exactly one of "
            "worker_factory (in-process rig) or link_factory (PeerLink)"
        )
    counter = [0]

    def factory() -> RemoteWorkerEngine:
        counter[0] += 1
        name = f"{name_prefix}-{counter[0]}"
        if link_factory is not None:
            return RemoteWorkerEngine(
                link_factory(), n_slots=n_slots,
                sync_interval=sync_interval, name=name, clock=clock,
            )
        near, far = LoopbackConn.pair()
        worker = PoolWorker(far, worker_factory())
        link = PeerLink(name, near, clock=clock, **(link_kwargs or {}))
        return RemoteWorkerEngine(
            link, n_slots=n_slots, sync_interval=sync_interval,
            name=name, clock=clock, peer_pump=worker.pump_once,
        )

    return factory




class PoolWorker:
    """The protocol loop around one ``FleetRouter`` pool, pumped on the
    caller's thread (:meth:`pump_once`); also usable in-process over a
    :class:`LoopbackConn` or one end of a socket pair.

    ``hold_ticks`` parks the router (frames are still answered, nothing
    decodes) until a ``CONTROL {"op": "resume"}`` arrives."""

    def __init__(self, conn, router, *, role: str = "decode",
                 fault_injector=None, hold_ticks: bool = False,
                 name: str = "", clock=time.monotonic,
                 telem_interval_s: float | None = None,
                 telem_budget_bytes: int = TELEM_BUDGET_BYTES,
                 traces=None, prefix_gossip: bool = False):
        self.conn = conn
        self.router = router
        self.role = role
        self.fault_injector = fault_injector
        self.hold_ticks = hold_ticks
        self.frames = FrameBuffer()
        self.dead = False
        self.clock = clock
        self.instance = name or f"worker-{os.getpid()}"
        # an in-process rig hands in a private TraceBuffer so "worker" spans
        # stay out of the supervisor's ring
        self.traces = traces if traces is not None else TRACES
        # rid -> {"tid", "parent", "t0"}: the trace context that came in
        # with the stream, closed as a hop span when the stream leaves
        self._trace_ctx: dict[int, dict] = {}
        # telemetry federation is opt-in (worker_main turns it on)
        self.shipper: TelemetryShipper | None = None
        if telem_interval_s is not None:
            self.shipper = TelemetryShipper(
                lambda body: self._send(TELEM, body),
                self.instance, clock=clock,
                interval_s=telem_interval_s,
                budget_bytes=telem_budget_bytes,
                traces=self.traces,
            )
        # prefix gossip on the pump's cadence; epoch 0 until the
        # supervisor's CONTROL {"op": "prefix_resync"} assigns one
        self.gossip = None
        self.prefix_epoch = 0
        if prefix_gossip:
            from k8s_dra_driver_torch.models.fleet_prefix import PrefixGossip

            self.gossip = PrefixGossip(
                lambda kind, body: self._send(PREFIXPUB if kind == "pub" else PREFIXWDL, body),
                clock=clock,
            )
            for rep in getattr(self.router, "replicas", ()):
                self.gossip.bind_engine(rep.engine)

    def pump_once(self) -> int:
        """One poll: every frame that arrived, then (unless held) one router
        tick, its completions and handoffs out, and the cadence-paced
        telemetry and gossip.  Returns the frames and slots processed."""
        from k8s_dra_driver_torch.models.serve import KVSlice, WireFormatError

        if self.dead:
            return 0
        inj = self.fault_injector
        if inj is not None and inj.take_peer_hang():
            return 0
        try:
            data = self.conn.recv_available()
        except PeerDiedError:
            self.dead = True
            return 0
        n = 0
        if data:
            self.frames.feed(data)
            for ftype, body in self.frames.frames():
                n += 1
                self._handle(ftype, body, KVSlice, WireFormatError)
        if not self.hold_ticks:
            n += self.router.tick()
            for c in self.router.completions():
                ctx = self._trace_ctx.pop(c.request_id, None)
                if ctx is not None:
                    self.traces.record(
                        ctx["tid"], f"hop.{self.role}", ctx["t0"], self.clock(),
                        parent_id=ctx["parent"], request_id=c.request_id,
                        status=c.status, instance=self.instance,
                    )
                self._send_json(COMPLETION, {
                    "request_id": c.request_id, "tokens": c.tokens,
                    "generated": c.generated, "status": c.status, "error": c.error,
                })
            for rep in getattr(self.router, "replicas", ()):
                take = getattr(rep.engine, "take_handoffs", None)
                if not callable(take):
                    continue
                for entry in take():
                    rid = int(entry["request_id"])
                    self.router._owner.pop(rid, None)
                    kv = entry.pop("kv", None)
                    wire = kv.to_wire(rid) if kv is not None else b""
                    meta = _sanitize_entry(entry)
                    ctx = self._trace_ctx.pop(rid, None)
                    if ctx is not None:
                        span = self.traces.record(
                            ctx["tid"], "hop.prefill", ctx["t0"], self.clock(),
                            parent_id=ctx["parent"], request_id=rid, instance=self.instance,
                        )
                        # the wire and decode hops chain under the prefill hop
                        meta["_trace"] = {"tid": ctx["tid"], "parent": span.span_id}
                    self._send(HANDOFF, encode_meta_frame(HANDOFF, meta, wire)
                               [_FRAME_HEADER.size:])
        if self.shipper is not None and not self.dead:
            # cadence-paced, even while held
            self.shipper.maybe_ship()
        if self.gossip is not None and not self.dead:
            self.gossip.maybe_ship()
        return n

    def _handle(self, ftype, body, KVSlice, WireFormatError) -> None:
        if ftype == PING:
            try:
                doc = json.loads(body.decode())
            except ValueError:
                doc = {}
            doc["pt"] = self.clock()
            self._send_json(PONG, doc)
        elif ftype == HELLO:
            pass
        elif ftype == CONTROL:
            self._control(json.loads(body.decode()))
        elif ftype == SUBMIT:
            doc = json.loads(body.decode())
            kwargs = doc.get("kwargs", {})
            if self.role == "prefill":
                kwargs["handoff"] = True
            try:
                rid = self.router.submit(doc["prompt"], doc["max_tokens"], **kwargs)
                # trace ids are rid-keyed: the hop starts here
                self._trace_ctx[rid] = {"tid": f"req-{rid}", "parent": "", "t0": self.clock()}
                self._send_json(SUBMITTED, {"seq": doc.get("seq"), "ok": True, "rid": rid})
            except RuntimeError as exc:
                self._send_json(SUBMITTED, {"seq": doc.get("seq"), "ok": False,
                                            "error": str(exc)})
        elif ftype == PLACE:
            meta, _ = decode_meta_frame(body)
            entry = {k: v for k, v in meta.items() if not k.startswith("_")}
            corr = meta.get("_correlation", "")
            self._note_trace(int(entry["request_id"]), meta)
            self.router.place([entry], correlation=corr)
            self._send_json(PLACED, {"rid": int(entry["request_id"])})
        elif ftype == KV:
            meta, wire = decode_meta_frame(body)
            rid = int(meta.get("request_id", -1))
            corr = meta.get("_correlation", f"req-{rid}")
            entry = {k: v for k, v in meta.items() if not k.startswith("_")}
            self._note_trace(rid, meta)
            try:
                wrid, kv = KVSlice.from_wire(wire)
                if wrid != rid:
                    raise WireFormatError(f"frame rid {wrid} != meta rid {rid}", wrid)
                entry["kv"] = kv
                self.router.place([entry], correlation=corr)
                JOURNAL.record("transport", "kv.installed", correlation=corr, nbytes=kv.nbytes)
                self._send_json(ACK, {"rid": rid, "outcome": OK, "placed": True})
            except WireFormatError as exc:
                JOURNAL.record("transport", "kv.decode_failed", correlation=corr,
                               error=str(exc))
                self._send_json(ACK, {"rid": rid if rid >= 0 else exc.request_id,
                                      "outcome": CORRUPT, "error": str(exc)})
        elif ftype == PREFIXREQ:
            self._prefix_request(json.loads(body.decode()), WireFormatError)

    def _control(self, doc: dict) -> None:
        op = doc.get("op")
        if op == "resume":
            self.hold_ticks = False
        elif op == "hold":
            self.hold_ticks = True
        elif op == "telem_flush":
            # everything new plus thread stacks, cadence ignored
            if self.shipper is not None:
                self.shipper.maybe_ship(force=True, include_stacks=True)
        elif op == "reset":
            self.hold_ticks = False
            self.router.completions()  # discard residuals
        elif op == "cancel":
            self.router.cancel(int(doc.get("rid", -1)))
        elif op == "release":
            for rep in getattr(self.router, "replicas", ()):
                rep.engine.release_active()
        elif op == "prefix_resync":
            # adopt the owner epoch and arm a full anti-entropy digest
            self.prefix_epoch = int(doc.get("epoch", 0))
            if self.gossip is not None:
                self.gossip.resync(self.prefix_epoch)
        elif op == "zero_launches":
            # the port's own op: the exit line counts from here on
            from k8s_dra_driver_torch.models import graphs

            graphs.add_launch_counts({key: -n for key, n in graphs.launch_counts().items()})
        elif op == "reseed":
            # the supervisor reserved ONE id stride for this worker: its
            # engines partition that stride
            base = int(doc.get("next_id", 0))
            reps = list(getattr(self.router, "replicas", ()))
            slot = int(doc.get("stride", 0)) // max(1, len(reps))
            for i, rep in enumerate(reps):
                rep.engine.restore(
                    {"engine": type(rep.engine).__name__, "next_id": base + i * slot,
                     "requests": []},
                    merge=True,
                )

    def _prefix_request(self, doc: dict, WireFormatError) -> None:
        """A fleet prefix-cache pull: export the deepest cached prefix any
        local engine holds for these tokens, or answer a typed miss (an
        index entry that named a previous owner epoch is one too)."""
        nonce = int(doc.get("nonce", 0))
        tokens = [int(t) for t in doc.get("tokens", ())]
        max_tokens = doc.get("max_tokens")
        adapter = int(doc.get("adapter", 0))
        req_epoch = int(doc.get("epoch", 0))
        if req_epoch and self.prefix_epoch and req_epoch != self.prefix_epoch:
            self._send(PREFIXMISS, encode_meta_frame(
                PREFIXMISS, {"nonce": nonce, "reason": "epoch", "epoch": self.prefix_epoch},
            )[_FRAME_HEADER.size:])
            return
        kv = None
        for rep in getattr(self.router, "replicas", ()):
            export = getattr(rep.engine, "export_prefix_kv", None)
            if export is None:
                continue
            try:
                kv = export(tokens, max_tokens=max_tokens, adapter=adapter)
            except WireFormatError:
                kv = None
            if kv is not None:
                break
        if kv is None:
            self._send(PREFIXMISS, encode_meta_frame(
                PREFIXMISS, {"nonce": nonce, "reason": "miss", "epoch": self.prefix_epoch},
            )[_FRAME_HEADER.size:])
        else:
            self._send(PREFIXKV, encode_meta_frame(
                PREFIXKV, {"nonce": nonce, "n_tokens": int(kv.valid_len),
                           "epoch": self.prefix_epoch},
                kv.to_wire(nonce),
            )[_FRAME_HEADER.size:])

    def _note_trace(self, rid: int, meta: dict) -> None:
        """The trace context a PLACE/KV frame carried: this worker's hop
        clock for the stream starts."""
        trace = meta.get("_trace") or {}
        self._trace_ctx[rid] = {
            "tid": str(trace.get("tid") or f"req-{rid}"),
            "parent": str(trace.get("parent", "")),
            "t0": self.clock(),
        }

    def _send(self, ftype: int, body: bytes) -> None:
        try:
            self.conn.send(encode_frame(ftype, body))
        except PeerDiedError:
            self.dead = True

    def _send_json(self, ftype: int, doc: dict) -> None:
        self._send(ftype, json.dumps(doc).encode())


class TransportHub:
    """The supervisor's listening side: workers dial in and identify with
    a HELLO frame; the hub routes each connection to (or creates) the
    named :class:`PeerLink`.  A redial for a known-dead peer becomes that
    link's reconnect."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 clock=time.monotonic, fault_injector=None, **link_kwargs):
        self.clock = clock
        self.fault_injector = fault_injector
        self.link_kwargs = link_kwargs
        self.links: dict[str, PeerLink] = {}
        self._half: list[tuple[socket.socket, FrameBuffer, float]] = []
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(16)
        self._listener.setblocking(False)
        self.host, self.port = self._listener.getsockname()[:2]

    def poll(self) -> None:
        """Accept pending dials and route HELLOs.  Non-blocking; called
        from the drive loop alongside the links' own pumps."""
        while True:
            try:
                sock, _ = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                break
            sock.setblocking(False)
            self._half.append((sock, FrameBuffer(), self.clock() + 10.0))
        still = []
        for sock, buf, deadline in self._half:
            routed = False
            try:
                while True:
                    try:
                        data = sock.recv(1 << 16)
                    except (BlockingIOError, InterruptedError):
                        break
                    if not data:
                        raise OSError("closed before hello")
                    buf.feed(data)
                for ftype, body in buf.frames():
                    if ftype != HELLO:
                        continue
                    doc = json.loads(body.decode())
                    self._route(str(doc.get("name", "worker")), sock, doc)
                    routed = True
                    break
            except (OSError, ValueError):
                sock.close()
                continue
            if not routed:
                if self.clock() > deadline:
                    sock.close()
                else:
                    still.append((sock, buf, deadline))
        self._half = still

    def _route(self, name: str, sock: socket.socket, hello: dict) -> None:
        conn = SocketConn(sock, peer=name, fault_injector=self.fault_injector)
        link = self.links.get(name)
        JOURNAL.record(
            "transport", "hello", correlation=f"transport/{name}",
            pid=hello.get("pid"), role=hello.get("role"),
        )
        if link is None:
            link = PeerLink(name, conn, clock=self.clock, **self.link_kwargs)
            self.links[name] = link
        else:
            link.adopt(conn)

    def link_for(self, name: str, timeout_s: float = 30.0) -> PeerLink:
        """Wait for the named worker to dial in (startup barrier)."""
        deadline = time.monotonic() + timeout_s
        while True:
            self.poll()
            link = self.links.get(name)
            if link is not None and not link.dead:
                return link
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"worker {name!r} did not dial the transport hub in "
                    f"{timeout_s}s"
                )
            time.sleep(0.01)

    def close(self) -> None:
        for sock, _, _ in self._half:
            sock.close()
        self._half = []
        try:
            self._listener.close()
        except OSError:
            pass



def dial(host: str, port: int, name: str, role: str = "decode",
         fault_injector=None, attempts: int = 60) -> SocketConn:
    """The worker's connect loop: jittered-backoff dial, then HELLO."""
    backoff = Backoff(RetryPolicy(base_delay_s=0.05, max_delay_s=1.0))
    last: Exception | None = None
    for _ in range(attempts):
        try:
            sock = socket.create_connection((host, port), timeout=5.0)
            conn = SocketConn(sock, peer="supervisor", fault_injector=fault_injector)
            conn.send(encode_frame(HELLO, json.dumps({
                "name": name, "pid": os.getpid(), "role": role,
            }).encode()))
            return conn
        except OSError as exc:
            last = exc
            backoff.sleep()
    raise ConnectionError(f"worker {name!r} could not reach supervisor at {host}:{port}: {last}")


# engine keyword arguments the worker sets itself
_WORKER_SET = ("params", "cfg", "device")


def build_worker_router(config: dict, device="cuda"):
    """The worker's pool from the reference's JSON config document:
    ``config["cfg"]`` are ``ModelConfig`` fields (``dtype`` by name),
    ``config["engines"]`` a list of ``{"kind": "dense"|"paged", ...engine
    keyword arguments}`` (``cache_dtype`` by name).  The weights are
    ``burnin.init_params`` from a generator on ``device`` seeded with
    ``config["seed"]``: the weights any process of the port draws from that
    seed on that device, so payloads and logits agree across processes.  A
    key the port's engine does not take raises ValueError naming it."""
    import dataclasses

    import torch

    from k8s_dra_driver_torch.device import resolve_device
    from k8s_dra_driver_torch.models import burnin
    from k8s_dra_driver_torch.models.fleet import FleetRouter
    from k8s_dra_driver_torch.models.paged import PagedServeEngine
    from k8s_dra_driver_torch.models.serve import ServeEngine

    dev = resolve_device(device)
    kinds = {"dense": ServeEngine, "paged": PagedServeEngine}
    docs = []
    for i, doc in enumerate(config["engines"]):
        doc = dict(doc)
        kind = doc.pop("kind", "dense")
        if kind not in kinds:
            raise ValueError(f"engines[{i}]: kind {kind!r} is not one of {sorted(kinds)}")
        taken = {f.name for f in dataclasses.fields(kinds[kind])} - set(_WORKER_SET)
        bad = sorted(set(doc) - taken)
        if bad:
            raise ValueError(f"engines[{i}]: the port's {kinds[kind].__name__} takes no "
                             f"{', '.join(repr(k) for k in bad)}")
        if "cache_dtype" in doc:
            doc["cache_dtype"] = burnin.torch_dtype(doc["cache_dtype"])
        docs.append((kinds[kind], doc))
    fields = dict(config["cfg"])
    if "dtype" in fields:
        fields["dtype"] = burnin.torch_dtype(fields["dtype"])
    cfg = burnin.ModelConfig(**fields)
    gen = torch.Generator(device=dev).manual_seed(int(config.get("seed", 0)))
    params = burnin.init_params(gen, cfg)
    return FleetRouter([cls(params=params, cfg=cfg, device=dev, **doc) for cls, doc in docs])


def _launch_line() -> str:
    from k8s_dra_driver_torch.models import graphs

    counts = {f"{mod.rsplit('.', 1)[-1]}:{key}": n
              for (mod, key), n in graphs.launch_counts().items() if n}
    return f"worker kernel launches: {json.dumps(counts, sort_keys=True)}"


def worker_main(argv) -> int:
    """``argv``: the config path, then optionally ``--device cpu``.  Hosts
    one pool behind the protocol until the supervisor hangs up; without a
    card (and without ``--device cpu``) it exits 2 before dialing."""
    args = list(argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1] if i + 1 < len(args) else ""
        del args[i:i + 2]
    with open(args[0]) as fh:
        config = json.load(fh)
    from k8s_dra_driver_torch.device import resolve_device

    try:
        dev = resolve_device(device)
    except (RuntimeError, ValueError) as exc:
        print(f"worker: {exc}", file=sys.stderr, flush=True)
        return 2
    fault_injector = None
    raw = os.environ.get("DRA_FAULTS", "")
    if raw:
        from k8s_dra_driver_torch.utils.faults import FaultInjector

        fault_injector = FaultInjector.from_env(raw)
    router = build_worker_router(config, dev)
    conn = dial(
        config.get("host", "127.0.0.1"), int(config["port"]),
        name=config.get("name", "worker"), role=config.get("role", "decode"),
        fault_injector=fault_injector,
    )
    worker = PoolWorker(
        conn, router, role=config.get("role", "decode"),
        fault_injector=fault_injector,
        hold_ticks=bool(config.get("hold_ticks", False)),
        name=config.get("name", ""),
        # federation and gossip default on in a worker process: they are
        # its only channels out
        telem_interval_s=float(config.get("telem_interval_s", 0.25)),
        telem_budget_bytes=int(config.get("telem_budget_bytes", TELEM_BUDGET_BYTES)),
        prefix_gossip=bool(config.get("prefix_gossip", True)),
    )
    print(json.dumps({"ready": True, "pid": os.getpid()}), flush=True)
    # a reset or partitioned link kills the connection, not the process:
    # with redial_attempts > 0 the worker dials the hub again
    redials_left = int(config.get("redial_attempts", 0))
    try:
        while True:
            if worker.pump_once() == 0:
                time.sleep(0.002)
            if not worker.dead:
                continue
            if redials_left <= 0:
                break
            redials_left -= 1
            conn = _worker_redial(config, fault_injector)
            if conn is None:
                break
            worker.conn = conn
            worker.frames = FrameBuffer()
            worker.dead = False
    finally:
        print(_launch_line(), file=sys.stderr, flush=True)
    return 0


def _worker_redial(config, fault_injector, deadline_s: float = 10.0):
    """Backoff-paced redial for a worker whose connection (not process)
    died."""
    backoff = Backoff(RetryPolicy(base_delay_s=0.05, max_delay_s=1.0))
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        try:
            return dial(
                config.get("host", "127.0.0.1"), int(config["port"]),
                name=config.get("name", "worker"), role=config.get("role", "decode"),
                fault_injector=fault_injector,
            )
        except OSError:
            backoff.sleep()
    return None


# -- observability ------------------------------------------------------------

_LIVE_TRANSPORTS: "weakref.WeakSet[TransportChannel]" = weakref.WeakSet()
_LIVE_REMOTE_POOLS: "weakref.WeakSet[RemotePool]" = weakref.WeakSet()


def debug_transport_doc() -> dict:
    """The /debug/transport payload: every live transport channel's claim/
    budget/outcome view (including its link: breaker state, cooldown, RTT,
    reconnects) and every live remote pool's retained-stream counts."""
    pools = sorted(_LIVE_REMOTE_POOLS, key=lambda p: p.seq)
    return {
        "channels": [ch.stats() for ch in _LIVE_TRANSPORTS],
        "remote_pools": [p.stats() for p in pools],
    }


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1:]))
