"""Fleet-wide KV prefix cache: ``k8s_dra_driver_tpu/models/fleet_prefix.py``
whole (lines 1-1215), copied with the port's imports (the port imports
nothing of the JAX package).  Names, metric families, journal events and
wire frames are the reference's.

The per-engine prefix stores (``models/paged.py``'s ``_prefix_stores``,
``models/serve.py``'s dense ``_prefix_store``) help only the replica that
holds them; this module is the fleet tier over them:

- :class:`PrefixGossip` (the worker half) batches an owner's
  ``on_prefix_store``/``on_prefix_evict`` events into CRC'd
  ``PREFIXPUB``/``PREFIXWDL`` frame bodies on the worker pump's cadence:
  ``u32 crc32(epoch .. payload) | u32 epoch | u32 seq | json payload``.
- :class:`FleetPrefixIndex` — digest of a token prefix -> owning replica
  and ``KVSlice`` geometry, with TTL and capacity eviction, block-ledger
  accounting, pins that hold an entry while a pull is in flight,
  ``invalidate_owner()`` and owner epochs that fence a replaced owner's
  stale entries.
- :class:`LocalPrefixSource` / :class:`RemotePrefixSource` — the pull
  legs.  A local pull still round-trips ``KVSlice.to_wire()``/
  ``from_wire()`` so the wire checks guard both legs; a remote pull rides
  ``models/transport.py``'s link (``PREFIXREQ`` out, ``PREFIXKV`` or
  ``PREFIXMISS`` back).
- :class:`FleetPrefixTier` — bound to a ``FleetRouter``
  (``attach_prefix_tier``); ``prepare()`` runs before ``engine.submit()``
  and pulls the owner's prefix KV into the engine's cached-blocks path,
  so the submit takes the engine's own prefix-hit ladder.

Every failure (geometry mismatch, open breaker, ``PREFIXMISS``, an owner
dying mid-pull, an inject that fails) falls back to a cold prefill; a dead
owner is invalidated on the way down.  The module imports no torch;
``KVSlice`` and the transport are imported lazily at pull time.
"""

from __future__ import annotations

import hashlib
import json
import struct
import time
import zlib
from dataclasses import dataclass, field

from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.metrics import REGISTRY

_M_PREFIX_HITS = REGISTRY.counter(
    "tpu_fleet_prefix_hits_total",
    "Admissions served from the fleet prefix-cache tier by source: "
    "local = the admitting replica already held the prefix blocks, "
    "remote = prefix KV was pulled from the owning replica over the "
    "transport wire and injected before prefill.",
)
_M_PREFIX_PULL = REGISTRY.histogram(
    "tpu_fleet_prefix_pull_seconds",
    "Wall seconds per cross-replica prefix-KV pull attempt, measured from "
    "the PREFIXREQ send to injected blocks (misses and failed pulls that "
    "fell back to cold prefill included).",
)
_M_PREFIX_EVICT = REGISTRY.counter(
    "tpu_fleet_prefix_evictions_total",
    "Fleet prefix-index entries dropped by reason: ttl (expired sweep), "
    "capacity (index LRU), owner_evicted (the owning engine LRU-dropped "
    "the blocks), invalidated (owner drained/removed/rebalanced away), "
    "anti_entropy (reconnect digest showed the owner no longer holds it), "
    "epoch_fence (published under a superseded owner epoch).",
)
_M_PREFIX_PUB = REGISTRY.counter(
    "tpu_fleet_prefix_pub_total",
    "Prefix gossip events by outcome: shipped (owner worker put a "
    "PREFIXPUB/PREFIXWDL batch on the wire), shed (publish deferred to "
    "the next cadence tick by the byte budget), ingested (supervisor "
    "applied a publish), withdrawn (supervisor applied a withdraw), "
    "fenced (event carried a superseded owner epoch and was dropped), "
    "decode_drop (CRC/JSON-corrupt gossip frame dropped whole).",
)
_M_EPOCH_FENCES = REGISTRY.counter(
    "tpu_fleet_prefix_epoch_fences_total",
    "Stale-epoch fences on the fleet prefix tier: index entries dropped "
    "or gossip/pull answers rejected because they carried an owner epoch "
    "older than the current one (a restarted or replaced owner's stale "
    "state is a typed miss, never wrong KV).",
)
_M_PULL_ADMISSION = REGISTRY.counter(
    "tpu_fleet_prefix_pull_admission_total",
    "Ledger-gated remote prefix-pull admissions by outcome: admitted "
    "(blocks reserved against the KV-demand ledger for the transfer "
    "window), refused (over-demand — the pull falls back to cold "
    "prefill instead of competing with stream admission), bypass (no "
    "pull gate attached or decode headroom unaccountable).",
)


def prefix_digest(material, adapter: int = 0) -> str:
    """Stable digest of prefix key material (a token tuple, or any
    deterministic hashable stand-in — the workload simulator uses block
    identity tuples).  The index stores digests, not token content, so a
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


@dataclass
class PrefixEntry:
    """One published prefix: deepest token depth `n_tokens` at `owner`,
    plus the KVSlice geometry a puller must match (or fall back)."""

    key: str
    owner: str
    n_tokens: int
    block_size: int
    kv_dtype: str
    n_layers: int = 0
    kv_heads: int = 0
    head_dim: int = 0
    adapter: int = 0
    blocks: int = 1  # ledger blocks this entry accounts for on the owner
    expires_at: float = 0.0
    pins: int = 0
    dead: bool = False  # owner invalidated while pinned; drop at unpin
    epoch: int = 0  # owner epoch that published it; 0 = in-process (unfenced)


@dataclass(frozen=True)
class PrefixLedger:
    """Balanced-accounting snapshot: published blocks per owner."""

    blocks: dict = field(default_factory=dict)
    entries: int = 0
    pinned: int = 0


class FleetPrefixIndex:
    """Fleet-scoped map: digest(adapter, token-prefix) -> PrefixEntry.

    Not thread-safe by design — it lives on the admission path of one
    router (same single-threaded discipline as `FleetRouter` itself).
    Entries are hints: the owner re-validates on PREFIXREQ, so a stale
    entry costs one miss round-trip, never correctness.
    """

    def __init__(
        self,
        *,
        ttl_s: float = 300.0,
        max_entries: int = 4096,
        clock=time.monotonic,
    ) -> None:
        self.ttl_s = float(ttl_s)
        self.max_entries = int(max_entries)
        self._clock = clock
        self._entries: dict[str, PrefixEntry] = {}  # insertion order = LRU
        self._block_sizes: set[int] = set()
        self.published_total = 0
        self.evicted_total = 0
        # Current owner epoch per gossiping owner; entries stamped with an
        # older epoch are fenced (the owner restarted or was replaced —
        # its old publishes describe a cache that no longer exists).
        self.owner_epoch: dict[str, int] = {}
        self.fenced_total = 0

    # -- publish / withdraw -------------------------------------------------

    def publish(
        self,
        material,
        owner: str,
        *,
        n_tokens: int,
        block_size: int,
        kv_dtype: str,
        n_layers: int = 0,
        kv_heads: int = 0,
        head_dim: int = 0,
        adapter: int = 0,
        blocks: int = 1,
    ) -> PrefixEntry:
        key = prefix_digest(material, adapter)
        now = self._clock()
        ent = self._entries.get(key)
        if ent is not None and not ent.dead:
            # Refresh: newest publisher wins the owner slot (rebalance moves
            # blocks around); bump expiry and LRU position.
            ent.owner = owner
            ent.expires_at = now + self.ttl_s
            ent.kv_dtype = str(kv_dtype)
            ent.block_size = int(block_size)
            ent.blocks = int(blocks)
            self._entries[key] = self._entries.pop(key)
            return ent
        ent = PrefixEntry(
            key=key,
            owner=str(owner),
            n_tokens=int(n_tokens),
            block_size=int(block_size),
            kv_dtype=str(kv_dtype),
            n_layers=int(n_layers),
            kv_heads=int(kv_heads),
            head_dim=int(head_dim),
            adapter=int(adapter),
            blocks=int(blocks),
            expires_at=now + self.ttl_s,
        )
        self._entries[key] = ent
        self._block_sizes.add(int(block_size))
        self.published_total += 1
        self._evict_over_capacity()
        return ent

    def withdraw(self, material, adapter: int = 0, *, owner: str | None = None,
                 reason: str = "owner_evicted") -> bool:
        """The owning engine LRU-dropped these blocks (on_prefix_evict)."""
        key = prefix_digest(material, adapter)
        ent = self._entries.get(key)
        if ent is None or (owner is not None and ent.owner != owner):
            return False
        self._drop(ent, reason)
        return True

    # -- gossip ingest (wire path: digests, not token material) -------------

    def set_owner_epoch(self, owner: str, epoch: int) -> int:
        """Adopt a new owner epoch and fence every entry the owner
        published under an older one.  Returns entries dropped (pinned
        entries go dead and drop at unpin — never under a live pull)."""
        epoch = int(epoch)
        cur = self.owner_epoch.get(owner, 0)
        self.owner_epoch[owner] = max(cur, epoch)
        victims = [
            e for e in self._entries.values()
            if e.owner == owner and e.epoch < epoch
        ]
        dropped = 0
        for ent in victims:
            before = len(self._entries)
            self._drop(ent, "epoch_fence")
            dropped += before - len(self._entries)
            self.fenced_total += 1
            _M_EPOCH_FENCES.inc()
        if victims:
            JOURNAL.record(
                "fleet", "prefix.epoch_fence",
                owner=owner, epoch=epoch, fenced=len(victims), dropped=dropped,
            )
        return dropped

    def _epoch_admits(self, owner: str, epoch: int) -> bool:
        cur = self.owner_epoch.get(owner, 0)
        if int(epoch) < cur:
            self.fenced_total += 1
            _M_EPOCH_FENCES.inc()
            return False
        if int(epoch) > cur:
            self.set_owner_epoch(owner, epoch)
        return True

    def epoch_ok(self, ent: PrefixEntry) -> bool:
        """Pull-time fence: reject (and drop) an entry stamped with a
        superseded owner epoch — the owner behind it is not the process
        that published it, so its answer could be wrong KV."""
        if ent.epoch >= self.owner_epoch.get(ent.owner, 0):
            return True
        self.fenced_total += 1
        _M_EPOCH_FENCES.inc()
        self._drop(ent, "epoch_fence")
        return False

    def ingest_publish(self, owner: str, epoch: int, ev: dict) -> bool:
        """Apply one wire publish event (keyed by digest — the token
        material never crosses; the owner re-walks its own store on
        PREFIXREQ, so a bogus digest costs one miss, never wrong KV)."""
        if not self._epoch_admits(owner, epoch):
            _M_PREFIX_PUB.inc(outcome="fenced")
            return False
        key = str(ev.get("key", ""))
        if not key or int(ev.get("n_tokens", 0)) <= 0:
            return False
        now = self._clock()
        ent = self._entries.get(key)
        if ent is not None and not ent.dead:
            ent.owner = str(owner)
            ent.epoch = int(epoch)
            ent.n_tokens = int(ev.get("n_tokens", ent.n_tokens))
            ent.kv_dtype = str(ev.get("kv_dtype", ent.kv_dtype))
            ent.block_size = int(ev.get("block_size", ent.block_size))
            ent.blocks = int(ev.get("blocks", ent.blocks))
            ent.expires_at = now + self.ttl_s
            self._entries[key] = self._entries.pop(key)
        else:
            ent = PrefixEntry(
                key=key,
                owner=str(owner),
                n_tokens=int(ev.get("n_tokens", 0)),
                block_size=int(ev.get("block_size", 0)),
                kv_dtype=str(ev.get("kv_dtype", "")),
                n_layers=int(ev.get("n_layers", 0)),
                kv_heads=int(ev.get("kv_heads", 0)),
                head_dim=int(ev.get("head_dim", 0)),
                adapter=int(ev.get("adapter", 0)),
                blocks=int(ev.get("blocks", 1)),
                expires_at=now + self.ttl_s,
                epoch=int(epoch),
            )
            self._entries[key] = ent
            if ent.block_size > 0:
                self._block_sizes.add(ent.block_size)
            self.published_total += 1
            self._evict_over_capacity()
        _M_PREFIX_PUB.inc(outcome="ingested")
        return True

    def ingest_withdraw(self, owner: str, epoch: int, ev: dict) -> bool:
        """Apply one wire withdraw event (owner-guarded, epoch-fenced)."""
        if not self._epoch_admits(owner, epoch):
            _M_PREFIX_PUB.inc(outcome="fenced")
            return False
        ent = self._entries.get(str(ev.get("key", "")))
        if ent is None or ent.owner != owner:
            return False
        self._drop(ent, "owner_evicted")
        _M_PREFIX_PUB.inc(outcome="withdrawn")
        return True

    def ingest_digest(self, owner: str, epoch: int, events: list) -> dict:
        """Anti-entropy: the owner shipped its FULL holdings.  Drop every
        entry of that owner the digest no longer names (divergence from a
        partition heals here), then upsert the digest's events."""
        if not self._epoch_admits(owner, epoch):
            _M_PREFIX_PUB.inc(outcome="fenced")
            return {"ingested": 0, "dropped": 0}
        held = {str(ev.get("key", "")) for ev in events}
        victims = [
            e for e in self._entries.values()
            if e.owner == owner and e.key not in held
        ]
        dropped = 0
        for ent in victims:
            before = len(self._entries)
            self._drop(ent, "anti_entropy")
            dropped += before - len(self._entries)
        ingested = 0
        for ev in events:
            ingested += bool(self.ingest_publish(owner, epoch, ev))
        JOURNAL.record(
            "fleet", "prefix.anti_entropy",
            owner=owner, epoch=int(epoch),
            held=len(held), ingested=ingested, dropped=dropped,
        )
        return {"ingested": ingested, "dropped": dropped}

    def _drop(self, ent: PrefixEntry, reason: str) -> None:
        if ent.pins > 0:
            # Never race an in-flight pull: keep the entry until unpin.
            ent.dead = True
            return
        self._entries.pop(ent.key, None)
        self.evicted_total += 1
        _M_PREFIX_EVICT.inc(reason=reason)

    def _evict_over_capacity(self) -> None:
        while len(self._entries) > self.max_entries:
            victim = None
            for ent in self._entries.values():  # oldest first
                if ent.pins == 0:
                    victim = ent
                    break
            if victim is None:
                return  # everything pinned; capacity is advisory then
            self._drop(victim, "capacity")

    # -- lookup -------------------------------------------------------------

    def block_sizes(self):
        return sorted(self._block_sizes)

    def chain_for_tokens(self, tokens, adapter: int = 0):
        """Candidate chain [(n_tokens, material)] shallow->deep for a real
        token prompt, one rung per whole block at every granularity the
        fleet has published (paged block sizes and dense buckets alike)."""
        n = len(tokens)
        depths: set[int] = set()
        for bs in self._block_sizes:
            if bs <= 0:
                continue
            # A usable prefix must leave >= 1 token to prefill from.
            d = bs
            while d < n:
                depths.add(d)
                d += bs
        return [(d, tuple(tokens[:d])) for d in sorted(depths)]

    def _live(self, ent: PrefixEntry | None, now: float) -> PrefixEntry | None:
        if ent is None or ent.dead:
            return None
        if ent.expires_at <= now:
            self._drop(ent, "ttl")
            return None
        return ent

    def deepest(self, chain, adapter: int = 0, *, compatible=None):
        """Deepest live entry along the chain that passes `compatible(ent)`.
        Chain rungs are independent candidates (contiguity is the owner's
        problem — it re-walks its own store on PREFIXREQ)."""
        now = self._clock()
        for n_tokens, material in reversed(list(chain)):
            ent = self._live(self._entries.get(prefix_digest(material, adapter)), now)
            if ent is None or ent.n_tokens != n_tokens:
                continue
            if compatible is not None and not compatible(ent):
                continue
            return ent
        return None

    def survey(self, chain, adapter: int = 0) -> dict:
        """Per-owner deepest published depth along the chain, as
        {owner: (n_tokens, blocks)} — the router's depth-aware affinity
        signal."""
        now = self._clock()
        out: dict[str, tuple[int, int]] = {}
        for n_tokens, material in chain:
            ent = self._live(self._entries.get(prefix_digest(material, adapter)), now)
            if ent is None:
                continue
            best = out.get(ent.owner)
            if best is None or n_tokens > best[0]:
                depth_blocks = (
                    n_tokens // ent.block_size if ent.block_size > 0 else 1
                )
                out[ent.owner] = (n_tokens, max(1, depth_blocks))
        return out

    # -- pin / sweep / invalidate ------------------------------------------

    def pin(self, key: str) -> bool:
        ent = self._entries.get(key)
        if ent is None or ent.dead:
            return False
        ent.pins += 1
        return True

    def unpin(self, key: str) -> None:
        ent = self._entries.get(key)
        if ent is None:
            return
        ent.pins = max(0, ent.pins - 1)
        if ent.dead and ent.pins == 0:
            self._entries.pop(ent.key, None)
            self.evicted_total += 1
            _M_PREFIX_EVICT.inc(reason="invalidated")

    def sweep(self, now: float | None = None) -> int:
        """TTL sweep; returns entries dropped.  Pinned entries survive."""
        now = self._clock() if now is None else now
        expired = [e for e in self._entries.values() if e.expires_at <= now]
        dropped = 0
        for ent in expired:
            before = len(self._entries)
            self._drop(ent, "ttl")
            dropped += before - len(self._entries)
        return dropped

    def invalidate_owner(self, owner: str, *, reason: str = "invalidated") -> int:
        """Owner drained / removed / rebalanced: its entries are garbage.
        Unpinned entries drop now; pinned ones are marked dead and drop at
        unpin (never under an in-flight pull)."""
        victims = [e for e in self._entries.values() if e.owner == owner]
        dropped = 0
        for ent in victims:
            before = len(self._entries)
            self._drop(ent, reason)
            dropped += before - len(self._entries)
        if victims:
            JOURNAL.record(
                "fleet", "prefix.invalidate",
                owner=owner,
                entries=len(victims),
                dropped=dropped,
                reason=reason,
            )
        return dropped

    # -- accounting ---------------------------------------------------------

    def ledger(self) -> PrefixLedger:
        blocks: dict[str, int] = {}
        pinned = 0
        for ent in self._entries.values():
            blocks[ent.owner] = blocks.get(ent.owner, 0) + max(1, ent.blocks)
            if ent.pins > 0:
                pinned += 1
        return PrefixLedger(blocks=blocks, entries=len(self._entries), pinned=pinned)

    def __len__(self) -> int:
        return len(self._entries)

    def note_hit(self, source: str) -> None:
        _M_PREFIX_HITS.inc(source=source)


class LocalPrefixSource:
    """Pull leg for an owner replica in the same process.  Still round-trips
    the wire encoding so CRC + quantized-geometry validation is identical to
    the socket path (a corrupt export surfaces as WireFormatError -> cold
    prefill, exactly like a corrupt frame would)."""

    def __init__(self, name: str, engine) -> None:
        self.name = name
        self.engine = engine

    def pull(self, tokens, *, max_tokens=None, adapter: int = 0,
             nonce: int = 0, epoch: int = 0):
        export = getattr(self.engine, "export_prefix_kv", None)
        if export is None:
            return None
        kv = export(tokens, max_tokens=max_tokens, adapter=adapter)
        if kv is None:
            return None
        from k8s_dra_driver_torch.models.serve import KVSlice, WireFormatError

        try:
            _, out = KVSlice.from_wire(kv.to_wire(nonce))
        except WireFormatError:
            return None
        return out


class RemotePrefixSource:
    """Pull leg over a transport `PeerLink`: PREFIXREQ out, PREFIXKV or
    PREFIXMISS back, bounded by the link's breaker, heartbeat liveness, and
    a pull deadline.  Every failure mode returns None (cold prefill)."""

    def __init__(self, name: str, link, *, peer_pump=None,
                 pull_timeout_s: float = 5.0, clock=time.monotonic) -> None:
        self.name = name
        self.link = link
        self.peer_pump = peer_pump
        self.pull_timeout_s = float(pull_timeout_s)
        self._clock = clock
        self.last_miss_reason: str | None = None

    def pull(self, tokens, *, max_tokens=None, adapter: int = 0,
             nonce: int = 0, epoch: int = 0):
        import struct

        from k8s_dra_driver_torch.models import transport as T
        from k8s_dra_driver_torch.models.serve import KVSlice, WireFormatError

        decode_errors = (WireFormatError, struct.error, ValueError,
                         KeyError, UnicodeDecodeError)

        self.last_miss_reason = None
        link = self.link
        if link.dead or not link.breaker.allow():
            self.last_miss_reason = "breaker"
            return None
        try:
            link.send_json(
                T.PREFIXREQ,
                {
                    "nonce": int(nonce),
                    "tokens": [int(t) for t in tokens],
                    "max_tokens": None if max_tokens is None else int(max_tokens),
                    "adapter": int(adapter),
                    "epoch": int(epoch),
                },
            )
        except (T.TransportDownError, T.PeerDiedError, OSError):
            return None
        deadline = self._clock() + self.pull_timeout_s
        while True:
            try:
                link.pump()
                if self.peer_pump is not None and not link.dead:
                    self.peer_pump()
            except (T.TransportDownError, T.PeerDiedError, OSError):
                return None
            body = link.take(T.PREFIXKV)
            if body is not None:
                try:
                    meta, wire = T.decode_meta_frame(body)
                    if int(meta.get("nonce", -1)) != int(nonce):
                        continue  # stale reply from a timed-out earlier pull
                    # Epoch fence: an answer stamped by a different owner
                    # process than the one that published the entry is a
                    # typed miss — never installable KV.
                    got_epoch = int(meta.get("epoch", 0))
                    if epoch and got_epoch and got_epoch != int(epoch):
                        self.last_miss_reason = "epoch"
                        return None
                    rid, kv = KVSlice.from_wire(wire)
                except decode_errors:
                    return None
                if rid != int(nonce):
                    continue
                return kv
            body = link.take(T.PREFIXMISS)
            if body is not None:
                try:
                    meta, _ = T.decode_meta_frame(body)
                except decode_errors:
                    return None
                if int(meta.get("nonce", -1)) == int(nonce):
                    self.last_miss_reason = str(meta.get("reason", "miss"))
                    return None
                continue
            if link.dead or self._clock() >= deadline:
                return None
            if self.peer_pump is None:
                # Not a retry loop: the except arm above RETURNS (cold-
                # prefill fallback) — this is the deadline-bounded socket
                # poll, same cadence as transport.py's recv waits.
                time.sleep(0.002)  # lint: ignore[sleep-retry]

    @property
    def dead(self) -> bool:
        return bool(self.link.dead)

    @property
    def available(self) -> bool:
        """Reachability WITHOUT consuming a breaker probe: a dead link or
        an open breaker degrades placement to local-only — the tier never
        dials into a peer the transport already knows is unreachable."""
        return not self.link.dead and self.link.breaker.state != "open"


class FleetPrefixTier:
    """Admission-time consumer bound to one `FleetRouter` (via
    `router.attach_prefix_tier`).  `prepare()` runs just before
    `engine.submit()`: it classifies the admission as a local hit, pulls
    remote prefix KV into the engine's cached-blocks path, or leaves the
    request to cold prefill.  Any exception inside prepare is contained —
    the tier can only ever cost, never fail, an admission."""

    def __init__(
        self,
        index: FleetPrefixIndex | None = None,
        *,
        clock=time.monotonic,
        pull_timeout_s: float = 5.0,
        min_remote_tokens: int = 1,
    ) -> None:
        self.index = index if index is not None else FleetPrefixIndex(clock=clock)
        self._clock = clock
        self.pull_timeout_s = float(pull_timeout_s)
        self.min_remote_tokens = int(min_remote_tokens)
        self._sources: dict[str, object] = {}
        self._nonce = 0
        self.counts = {"local": 0, "remote": 0, "cold": 0}
        self.fallbacks: dict[str, int] = {}
        # Ledger-gated pull admission (models/disagg.py): a remote pull
        # reserves its blocks against the KV-demand ledger for the
        # transfer window.  ``reserve_pull(nonce, blocks)`` -> True
        # (reserved), False (over-demand: fall back cold), None (bypass —
        # headroom unaccountable, stand aside like stream admission does).
        self.pull_gate = None
        self._gossip_links: dict[str, object] = {}
        self._owner_cfg: dict[str, dict] = {}
        self.gossip_decode_drops = 0

    # -- wiring -------------------------------------------------------------

    def add_source(self, name: str, source) -> None:
        self._sources[name] = source

    def remove_source(self, name: str) -> None:
        self._sources.pop(name, None)

    def attach_remote_owner(self, name: str, link, *, peer_pump=None,
                            pull_timeout_s: float | None = None) -> None:
        """Wire a remote owner worker into the tier: a pull source over
        its transport link, gossip ingestion from its PREFIXPUB/PREFIXWDL
        inbox, and epoch-fenced ownership — the owner epoch bumps on
        every (re)connect and an anti-entropy resync is requested so the
        index converges to what the (possibly replacement) process holds."""
        cfg = {
            "peer_pump": peer_pump,
            "pull_timeout_s": (self.pull_timeout_s if pull_timeout_s is None
                               else float(pull_timeout_s)),
        }
        self._owner_cfg[name] = cfg
        self.add_source(name, RemotePrefixSource(
            name, link, peer_pump=cfg["peer_pump"],
            pull_timeout_s=cfg["pull_timeout_s"], clock=self._clock,
        ))
        self._gossip_links[name] = link
        self.index.set_owner_epoch(name, self.index.owner_epoch.get(name, 0) + 1)
        on_reconnect = getattr(link, "on_reconnect", None)
        if on_reconnect is not None:
            on_reconnect.append(
                lambda lk, n=name: self._on_owner_reconnect(n, lk)
            )
        self._send_resync(name, link)

    def detach_remote_owner(self, name: str) -> None:
        self._gossip_links.pop(name, None)
        self._owner_cfg.pop(name, None)
        self.remove_source(name)

    def _on_owner_reconnect(self, name: str, link) -> None:
        """Reconnect = spawn or replacement: bump the owner epoch (fences
        every stale entry), restore the pull source if a mid-pull death
        removed it, and ask the worker for its full anti-entropy digest."""
        self.index.set_owner_epoch(name, self.index.owner_epoch.get(name, 0) + 1)
        cfg = self._owner_cfg.get(name)
        if cfg is not None and name not in self._sources:
            self.add_source(name, RemotePrefixSource(
                name, link, peer_pump=cfg["peer_pump"],
                pull_timeout_s=cfg["pull_timeout_s"], clock=self._clock,
            ))
        self._send_resync(name, link)

    def _send_resync(self, name: str, link) -> None:
        from k8s_dra_driver_torch.models import transport as T

        try:
            link.send_json(T.CONTROL, {
                "op": "prefix_resync",
                "epoch": int(self.index.owner_epoch.get(name, 0)),
            })
        except (T.TransportDownError, T.PeerDiedError, OSError):
            pass  # the next reconnect retries; entries stay fenced until then

    def owner_available(self, name: str) -> bool:
        """Placement signal: False when the owner sits behind a dead link
        or an open breaker (degrade to local-only instead of routing at
        an unreachable owner)."""
        source = self._sources.get(name)
        if source is not None:
            return bool(getattr(source, "available", True))
        link = self._gossip_links.get(name)
        if link is not None:
            return not link.dead and link.breaker.state != "open"
        return True

    def drain_gossip(self) -> int:
        """Ingest buffered PREFIXPUB/PREFIXWDL frames from every attached
        owner link.  Pure host-side dict work on the router tick; corrupt
        frames are dropped whole (typed, counted), never partially applied."""
        from k8s_dra_driver_torch.models import transport as T

        applied = 0
        for name, link in list(self._gossip_links.items()):
            while True:
                body = link.take(T.PREFIXPUB)
                if body is None:
                    break
                applied += self._ingest_pub(name, body)
            while True:
                body = link.take(T.PREFIXWDL)
                if body is None:
                    break
                applied += self._ingest_wdl(name, body)
        return applied

    def _ingest_pub(self, name: str, body: bytes) -> int:
        try:
            doc, epoch, seq = decode_prefix_gossip(body)
        except PrefixGossipError as exc:
            self._gossip_drop(name, exc)
            return 0
        events = doc.get("events", [])
        if doc.get("full"):
            res = self.index.ingest_digest(name, epoch, list(events))
            return int(res.get("ingested", 0))
        n = 0
        for ev in events:
            if isinstance(ev, dict):
                n += bool(self.index.ingest_publish(name, epoch, ev))
        return n

    def _ingest_wdl(self, name: str, body: bytes) -> int:
        try:
            doc, epoch, _seq = decode_prefix_gossip(body)
        except PrefixGossipError as exc:
            self._gossip_drop(name, exc)
            return 0
        n = 0
        for ev in doc.get("events", []):
            if isinstance(ev, dict):
                n += bool(self.index.ingest_withdraw(name, epoch, ev))
        return n

    def _gossip_drop(self, name: str, exc: PrefixGossipError) -> None:
        self.gossip_decode_drops += 1
        _M_PREFIX_PUB.inc(outcome="decode_drop")
        JOURNAL.record_lazy(
            "fleet", "prefix.gossip_drop", correlation=f"prefix-owner-{name}",
            attrs=lambda: dict(error=str(exc), epoch=exc.epoch, seq=exc.seq),
        )

    def bind_engine(self, name: str, engine) -> None:
        """Attach publish/evict hooks so the engine feeds the index as it
        stores prefix blocks, and register a local pull source for it."""
        geom_fn = getattr(engine, "prefix_geometry", None)
        if geom_fn is None:
            return
        geom = dict(geom_fn())
        index = self.index

        def _on_store(material, n_tokens, adapter=0):
            index.publish(
                material,
                name,
                n_tokens=int(n_tokens),
                block_size=int(geom.get("block_size", 0)),
                kv_dtype=str(geom.get("kv_dtype", "")),
                n_layers=int(geom.get("n_layers", 0)),
                kv_heads=int(geom.get("kv_heads", 0)),
                head_dim=int(geom.get("head_dim", 0)),
                adapter=int(adapter),
                blocks=1,  # one store block per published depth rung
            )

        def _on_evict(material, adapter=0):
            index.withdraw(material, adapter, owner=name)

        engine.on_prefix_store = _on_store
        engine.on_prefix_evict = _on_evict
        if getattr(engine, "export_prefix_kv", None) is not None:
            self.add_source(name, LocalPrefixSource(name, engine))

    def unbind_engine(self, name: str, engine=None) -> None:
        if engine is not None:
            if getattr(engine, "on_prefix_store", None) is not None:
                engine.on_prefix_store = None
            if getattr(engine, "on_prefix_evict", None) is not None:
                engine.on_prefix_evict = None
        self.remove_source(name)

    def on_replica_gone(self, name: str, engine=None) -> None:
        """Scale-down / rebalance / death: invalidate everything it owned."""
        self.unbind_engine(name, engine)
        self.index.invalidate_owner(name)

    def tick(self) -> None:
        """Router tick hook: gossip ingest + TTL sweep (pure dict work,
        no device syncs)."""
        self.drain_gossip()
        self.index.sweep()

    # -- admission ----------------------------------------------------------

    def _note_fallback(self, reason: str) -> None:
        self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1

    def _compatible(self, geom: dict, rep_name: str, local_depth: int,
                    unreachable: list | None = None):
        quantized_dtypes = ("int8", "int4")

        def check(ent: PrefixEntry) -> bool:
            if ent.owner == rep_name:
                return False
            if not self.owner_available(ent.owner):
                # Breaker-open / dead link: degrade to local-only placement
                # rather than dialing a pull into an unreachable owner.
                if unreachable is not None:
                    unreachable.append(ent.owner)
                return False
            if ent.n_tokens <= max(local_depth, self.min_remote_tokens - 1):
                return False
            if geom.get("n_layers") and ent.n_layers and ent.n_layers != geom["n_layers"]:
                return False
            if geom.get("kv_heads") and ent.kv_heads and ent.kv_heads != geom["kv_heads"]:
                return False
            if geom.get("head_dim") and ent.head_dim and ent.head_dim != geom["head_dim"]:
                return False
            # Bit-equality rule: pool dtypes must match exactly (cross-dtype
            # conversion is not bit-stable); quantized pools additionally
            # require the same block granularity because scales are
            # per-block.  Float payloads may re-block: the receiver installs
            # whole receiver-blocks, so it needs at least one.
            if ent.kv_dtype != geom.get("kv_dtype"):
                return False
            if ent.kv_dtype in quantized_dtypes:
                if ent.block_size != geom.get("block_size"):
                    return False
            else:
                bs = int(geom.get("block_size", 0) or 0)
                if bs > 0 and ent.n_tokens // bs < 1:
                    return False
            return True

        return check

    def prepare(self, rep_name: str, engine, prompt, *, max_tokens=None,
                adapter: int = 0, chain=None) -> str:
        """Classify + warm one admission.  Returns 'local' | 'remote' |
        'cold'.  Never raises past itself."""
        try:
            return self._prepare(rep_name, engine, prompt,
                                 max_tokens=max_tokens, adapter=adapter,
                                 chain=chain)
        except Exception as exc:  # containment: tier failures cost, not fail
            JOURNAL.record("fleet", "prefix.prepare_error", replica=rep_name,
                           error=f"{type(exc).__name__}: {exc}")
            self._note_fallback("error")
            self.counts["cold"] += 1
            return "cold"

    def _prepare(self, rep_name, engine, prompt, *, max_tokens, adapter, chain):
        depth_fn = getattr(engine, "local_prefix_depth", None)
        geom_fn = getattr(engine, "prefix_geometry", None)
        inject = getattr(engine, "inject_prefix_kv", None)
        local_depth = int(depth_fn(prompt, adapter)) if depth_fn is not None else 0
        if geom_fn is None or inject is None:
            if local_depth > 0:
                self.index.note_hit("local")
                self.counts["local"] += 1
                return "local"
            self.counts["cold"] += 1
            return "cold"
        geom = dict(geom_fn())
        if chain is None:
            chain = self.index.chain_for_tokens(prompt, adapter)
        unreachable: list = []
        ent = self.index.deepest(
            chain, adapter,
            compatible=self._compatible(geom, rep_name, local_depth,
                                        unreachable=unreachable))
        if ent is None:
            if unreachable:
                self._note_fallback("breaker_open")
            if local_depth > 0:
                self.index.note_hit("local")
                self.counts["local"] += 1
                return "local"
            self.counts["cold"] += 1
            return "cold"
        if not self.index.epoch_ok(ent):
            # Stale-epoch entry survived ingest fencing (e.g. a pinned
            # hint): typed miss, never a pull at the wrong process.
            self._note_fallback("epoch_fence")
            return self._after_failed_pull(local_depth)
        source = self._sources.get(ent.owner)
        if source is None:
            self._note_fallback("no_source")
            return self._after_failed_pull(local_depth)
        self._nonce += 1
        nonce = self._nonce
        # A pull is demand too: reserve its receiver blocks against the
        # KV-demand ledger for the transfer window, or fall back cold.
        bs = int(geom.get("block_size", 0) or 0)
        need = -(-ent.n_tokens // bs) if bs > 0 else max(1, int(ent.blocks))
        reserved = False
        if self.pull_gate is not None:
            verdict = self.pull_gate.reserve_pull(nonce, need)
            if verdict is False:
                _M_PULL_ADMISSION.inc(outcome="refused")
                self._note_fallback("pull_admission")
                JOURNAL.record(
                    "fleet", "prefix.pull", correlation=f"prefix-pull-{nonce}",
                    owner=ent.owner, blocks=need, outcome="refused",
                )
                return self._after_failed_pull(local_depth)
            reserved = verdict is True
            _M_PULL_ADMISSION.inc(
                outcome="admitted" if reserved else "bypass")
        pinned = self.index.pin(ent.key)
        t0 = self._clock()
        injected = 0
        outcome = "miss"
        try:
            kv = source.pull(prompt, max_tokens=max_tokens, adapter=adapter,
                             nonce=nonce, epoch=ent.epoch)
            if kv is None:
                miss_reason = getattr(source, "last_miss_reason", None)
                if getattr(source, "dead", False):
                    # Owner died mid-pull: its whole index footprint is
                    # garbage now, not just this entry.
                    self.on_replica_gone(ent.owner)
                    outcome = "owner_dead"
                elif miss_reason == "epoch":
                    # Answered by the wrong owner epoch: typed miss.
                    _M_EPOCH_FENCES.inc()
                    self.index._drop(ent, "epoch_fence")
                    outcome = "epoch_fence"
                else:
                    outcome = "miss"
                self._note_fallback(outcome)
                return self._after_failed_pull(local_depth)
            injected = int(inject(prompt, kv, adapter=adapter) or 0)
            outcome = "injected" if injected > 0 else "inject"
        finally:
            if reserved:
                self.pull_gate.release_pull(nonce)
            if pinned:
                self.index.unpin(ent.key)
            _M_PREFIX_PULL.observe(max(0.0, self._clock() - t0))
            JOURNAL.record(
                "fleet", "prefix.pull", correlation=f"prefix-pull-{nonce}",
                owner=ent.owner, n_tokens=int(ent.n_tokens), blocks=need,
                outcome=outcome,
            )
        if injected <= 0:
            self._note_fallback("inject")
            return self._after_failed_pull(local_depth)
        self.index.note_hit("remote")
        self.counts["remote"] += 1
        return "remote"

    def _after_failed_pull(self, local_depth: int) -> str:
        if local_depth > 0:
            self.index.note_hit("local")
            self.counts["local"] += 1
            return "local"
        self.counts["cold"] += 1
        return "cold"
