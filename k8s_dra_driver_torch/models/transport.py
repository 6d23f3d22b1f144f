"""The KV transport's worker half (``k8s_dra_driver_tpu/models/transport.py``,
copied: the port imports nothing of the JAX package): one worker process
hosts a pool of port engines behind the reference's framed socket protocol.

    python -m k8s_dra_driver_torch.models.transport cfg.json [--device cpu]

``cfg.json`` is the reference's worker document unchanged: ``cfg`` (the
``ModelConfig`` fields), ``engines`` (a list of ``{"kind": "dense" |
"paged", ...engine keyword arguments}``), ``seed``, and the supervisor's
``host``/``port``, the worker's ``name`` and ``role`` ("prefill" submits
every request with ``handoff=True``), ``hold_ticks``, ``telem_interval_s``,
``prefix_gossip`` and ``redial_attempts``.  The worker runs on the card
unless ``--device cpu`` is given; without a card it exits 2 before it
dials.  It prints ``{"ready": true, "pid": ...}`` once it has dialed, and
on exit one line to stderr, ``worker kernel launches: {...}``, the kernel
launches it made by ``module:kernel``.

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
* :class:`PoolWorker`: the protocol loop around one ``FleetRouter``: it
  answers PING, SUBMIT, PLACE, KV (the receiver's ``KVSlice.from_wire`` is
  the integrity check; its verdict is the ACK), CONTROL (hold, resume,
  reset, cancel, release, reseed, telem_flush, prefix_resync) and
  PREFIXREQ, and ships COMPLETION, HANDOFF, TELEM and the prefix gossip.

The supervisor half (``PeerLink``, ``TransportChannel``, ``RemotePool``,
``RemoteWorkerEngine``, ``TransportHub``, ``WireReceiver``) holds no JAX
and is not needed to run a worker: it stays in the reference, which
drives a port worker as it drives its own.  Every frame here is the
reference's byte for byte.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import sys
import time
from collections import deque

from k8s_dra_driver_torch.models.obs_plane import TELEM_BUDGET_BYTES, TelemetryShipper
from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.retry import Backoff, RetryPolicy
from k8s_dra_driver_torch.utils.tracing import TRACES

# the receiver's verdicts on a KV frame (the reference's disagg vocabulary)
OK = "ok"
CORRUPT = "corrupt"
# what the real wire adds to it
RESET = "reset"            # peer connection died mid-transfer
TRUNCATED = "truncated"    # frame cut mid-body (EOF inside a frame)
HANG = "hang"              # peer alive but silent past the ack deadline

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


def _sanitize_entry(entry: dict) -> dict:
    """The JSON half of a snapshot entry (everything but the KVSlice and
    the transport's own ``_`` keys): what rides in a frame's meta."""
    return {k: v for k, v in entry.items() if k != "kv" and not k.startswith("_")}


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


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1:]))
