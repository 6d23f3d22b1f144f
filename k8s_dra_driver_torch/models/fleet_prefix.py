"""The fleet prefix tier's worker half
(``k8s_dra_driver_tpu/models/fleet_prefix.py``, copied: the port imports
nothing of the JAX package).

A worker's engines publish the prefix blocks they store and withdraw the
ones they evict (their ``on_prefix_store``/``on_prefix_evict`` hooks);
:class:`PrefixGossip` batches those events and ships them to the
supervisor's fleet prefix index as CRC'd ``PREFIXPUB``/``PREFIXWDL``
frame bodies on the worker pump's cadence:

    u32 crc32(epoch .. payload) | u32 epoch | u32 seq | json payload

The index, the pull legs and the admission-time tier
(``FleetPrefixIndex``, ``FleetPrefixTier``) are the supervisor's; they
stay in the reference.
"""

from __future__ import annotations

import hashlib
import json
import struct
import time
import zlib

from k8s_dra_driver_torch.utils.metrics import REGISTRY

_M_PREFIX_PUB = REGISTRY.counter(
    "tpu_fleet_prefix_pub_total",
    "Prefix gossip events by outcome: shipped (owner worker put a "
    "PREFIXPUB/PREFIXWDL batch on the wire), shed (publish deferred to "
    "the next cadence tick by the byte budget), ingested (supervisor "
    "applied a publish), withdrawn (supervisor applied a withdraw), "
    "fenced (event carried a superseded owner epoch and was dropped), "
    "decode_drop (CRC/JSON-corrupt gossip frame dropped whole).",
)


def prefix_digest(material, adapter: int = 0) -> str:
    """Stable digest of prefix key material (a token tuple, or any
    deterministic hashable stand-in — the reference's workload simulator uses
    block identity tuples).  The index stores digests, not token content, so a
    4096-entry index over 1k-token prefixes stays tens of KiB."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((int(adapter), tuple(material))).encode("utf-8"))
    return h.hexdigest()


# -- gossip wire codec (PREFIXPUB / PREFIXWDL frame bodies) ------------------
#
# Owner workers batch publish/withdraw events and ship them to the
# supervisor's index as CRC'd frames on the worker pump cadence — the
# TELEM pattern, but with the owner epoch and a per-worker batch seq in
# a fixed header so a corrupt frame is attributable before it is trusted.
#
#   u32 crc32(epoch .. payload) | u32 epoch | u32 seq | json payload

GOSSIP_BUDGET_BYTES = 48 * 1024  # same per-frame ceiling as TELEM
_GOSSIP_CRC = struct.Struct("!I")
_GOSSIP_META = struct.Struct("!II")  # epoch, seq
_GOSSIP_HEADER_BYTES = _GOSSIP_CRC.size + _GOSSIP_META.size


class PrefixGossipError(ValueError):
    """Typed decode failure for a PREFIXPUB/PREFIXWDL body.  Carries the
    claimed owner ``epoch`` and batch ``seq`` (the gossip rid) once the
    fixed header is readable; -1 before — same attribution contract as
    ``WireFormatError.request_id``."""

    def __init__(self, message: str, *, epoch: int = -1, seq: int = -1):
        super().__init__(message)
        self.epoch = int(epoch)
        self.seq = int(seq)


def encode_prefix_gossip(doc: dict, *, epoch: int, seq: int) -> bytes:
    meta = _GOSSIP_META.pack(int(epoch) & 0xFFFFFFFF, int(seq) & 0xFFFFFFFF)
    payload = json.dumps(doc, separators=(",", ":"), sort_keys=True).encode("utf-8")
    crc = zlib.crc32(meta + payload) & 0xFFFFFFFF
    return _GOSSIP_CRC.pack(crc) + meta + payload


def decode_prefix_gossip(body: bytes) -> tuple[dict, int, int]:
    """Decode one gossip frame body -> (doc, epoch, seq).  EVERY
    truncation and EVERY bit flip is a ``PrefixGossipError`` — a corrupt
    batch is dropped whole, never partially applied to the index."""
    if len(body) < _GOSSIP_HEADER_BYTES:
        raise PrefixGossipError(
            f"gossip frame truncated at {len(body)} bytes "
            f"(< {_GOSSIP_HEADER_BYTES}-byte header)"
        )
    (crc,) = _GOSSIP_CRC.unpack_from(body)
    epoch, seq = _GOSSIP_META.unpack_from(body, _GOSSIP_CRC.size)
    if zlib.crc32(body[_GOSSIP_CRC.size:]) & 0xFFFFFFFF != crc:
        raise PrefixGossipError("gossip crc mismatch", epoch=epoch, seq=seq)
    try:
        doc = json.loads(body[_GOSSIP_HEADER_BYTES:].decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as exc:
        raise PrefixGossipError(
            f"gossip payload undecodable: {exc}", epoch=epoch, seq=seq
        ) from exc
    if not isinstance(doc, dict):
        raise PrefixGossipError(
            "gossip payload is not an object", epoch=epoch, seq=seq
        )
    return doc, int(epoch), int(seq)


class PrefixGossip:
    """Worker-side gossip publisher: buffers ``on_prefix_store`` /
    ``on_prefix_evict`` events from the worker's engines and ships them
    as CRC'd PREFIXPUB / PREFIXWDL batches piggybacked on the worker pump
    cadence (the ``TelemetryShipper`` discipline: cadence-paced, byte-
    budgeted, no thread of its own, pure host-side dict work).

    Withdrawals always ship (a missed withdraw is a stale hint that costs
    a PREFIXMISS round-trip); publishes are priority-shed deepest-first
    under the byte budget, with shed events requeued for the next tick —
    delayed, never lost.  ``resync(epoch)`` arms a full-digest ship (the
    anti-entropy summary the supervisor reconciles against after a
    reconnect) and adopts the supervisor-assigned owner epoch."""

    def __init__(self, send, *, clock=time.monotonic, interval_s: float = 0.25,
                 budget_bytes: int = GOSSIP_BUDGET_BYTES) -> None:
        self.send = send  # callable(kind: "pub"|"wdl", body: bytes)
        self._clock = clock
        self.interval_s = float(interval_s)
        self.budget_bytes = int(budget_bytes)
        self.epoch = 0
        self.seq = 0
        self._held: dict[str, dict] = {}  # key -> event, everything we hold
        self._pub_q: dict[str, dict] = {}  # pending publishes (key-deduped)
        self._wdl_q: dict[str, dict] = {}  # pending withdraws
        self._full_pending = False
        self._last_ship = float("-inf")
        self.shipped_frames = 0
        self.shed_total = 0
        self.max_frame_bytes = 0

    def bind_engine(self, engine) -> None:
        geom_fn = getattr(engine, "prefix_geometry", None)
        if geom_fn is None:
            return
        geom = dict(geom_fn())

        def _on_store(material, n_tokens, adapter=0):
            self.note_store(material, n_tokens, adapter, geom)

        def _on_evict(material, adapter=0):
            self.note_evict(material, adapter)

        engine.on_prefix_store = _on_store
        engine.on_prefix_evict = _on_evict

    def note_store(self, material, n_tokens, adapter, geom: dict) -> None:
        key = prefix_digest(material, adapter)
        ev = {
            "key": key,
            "n_tokens": int(n_tokens),
            "block_size": int(geom.get("block_size", 0)),
            "kv_dtype": str(geom.get("kv_dtype", "")),
            "n_layers": int(geom.get("n_layers", 0)),
            "kv_heads": int(geom.get("kv_heads", 0)),
            "head_dim": int(geom.get("head_dim", 0)),
            "adapter": int(adapter),
            "blocks": 1,
        }
        self._held[key] = ev
        self._pub_q[key] = ev
        self._wdl_q.pop(key, None)

    def note_evict(self, material, adapter=0) -> None:
        key = prefix_digest(material, adapter)
        self._held.pop(key, None)
        self._pub_q.pop(key, None)
        self._wdl_q[key] = {"key": key, "adapter": int(adapter)}

    def resync(self, epoch: int) -> None:
        self.epoch = int(epoch)
        self._full_pending = True
        self._pub_q.clear()
        self._wdl_q.clear()

    def pending(self) -> bool:
        return bool(self._full_pending or self._pub_q or self._wdl_q)

    def maybe_ship(self, force: bool = False) -> int:
        """Ship pending batches if the cadence (or ``force``) says so.
        Returns frames shipped.  Never raises past itself — gossip is a
        hint plane; a send failure surfaces on the link, not here."""
        now = self._clock()
        if not force and now - self._last_ship < self.interval_s:
            return 0
        if not self.pending():
            return 0
        self._last_ship = now
        frames = 0
        if self._wdl_q:
            doc = {"events": list(self._wdl_q.values())}
            self._wdl_q.clear()
            frames += self._ship("wdl", doc)
        full = self._full_pending
        if full:
            events = sorted(
                self._held.values(), key=lambda e: -int(e.get("n_tokens", 0))
            )
            self._full_pending = False
            self._pub_q.clear()
        else:
            events = sorted(
                self._pub_q.values(), key=lambda e: -int(e.get("n_tokens", 0))
            )
            self._pub_q.clear()
        if events or full:
            kept = self._fit(events, full)
            doc = {"events": kept}
            if full:
                doc["full"] = True
            frames += self._ship("pub", doc)
        return frames

    def _fit(self, events: list, full: bool) -> list:
        """Priority shedding under the byte budget: deepest rungs ship
        first, the shallow tail is requeued for the next cadence tick."""
        used = _GOSSIP_HEADER_BYTES + len(
            json.dumps({"events": [], "full": full},
                       separators=(",", ":"), sort_keys=True)
        )
        kept: list = []
        for ev in events:
            ev_len = 1 + len(json.dumps(ev, separators=(",", ":"),
                                        sort_keys=True))
            if used + ev_len > self.budget_bytes:
                self._pub_q.setdefault(ev["key"], ev)
                self.shed_total += 1
                _M_PREFIX_PUB.inc(outcome="shed")
                continue
            kept.append(ev)
            used += ev_len
        return kept

    def _ship(self, kind: str, doc: dict) -> int:
        self.seq += 1
        body = encode_prefix_gossip(doc, epoch=self.epoch, seq=self.seq)
        try:
            self.send(kind, body)
        except Exception:  # noqa: BLE001 - link failures surface on the link
            return 0
        self.shipped_frames += 1
        self.max_frame_bytes = max(self.max_frame_bytes, len(body))
        _M_PREFIX_PUB.inc(outcome="shipped")
        return 1
