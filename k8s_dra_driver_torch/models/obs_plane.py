"""Telemetry federation, the worker half
(``k8s_dra_driver_tpu/models/obs_plane.py``, copied: the port imports
nothing of the JAX package).

A worker process ships its journal tail, its span records and its
metrics registry to the supervisor in ``TELEM`` frames (transport frame
type 13) on a bounded cadence.  The body is ``u32 crc32 + json payload``
(telemetry rides the socket that carries KV payloads: a corrupt frame is
dropped, never parsed) and at most ``TELEM_BUDGET_BYTES``: an oversized
snapshot sheds stacks first, then the oldest journal events, then the
oldest spans, then the metrics text, and marks itself truncated.

The supervisor half (the reference's ``FleetObservability`` and
``SloBurnRateMonitor``) merges these frames; it stays in the reference.
"""

from __future__ import annotations

import json
import struct
import sys
import threading
import time
import traceback
import zlib

from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.metrics import REGISTRY
from k8s_dra_driver_torch.utils.tracing import TRACES

TELEM_BUDGET_BYTES = 48 * 1024  # the reference's per-frame ceiling

_CRC = struct.Struct("!I")

_M_TELEM_FRAMES = REGISTRY.counter(
    "tpu_obs_telem_frames_total",
    "TELEM telemetry frames by outcome (shipped/ingested/crc_drop/decode_drop)",
)
_M_TELEM_BYTES = REGISTRY.counter(
    "tpu_obs_telem_bytes_total",
    "TELEM telemetry frame bytes by direction (tx=shipped, rx=ingested)",
)

# the closed outcome vocabulary of _M_TELEM_FRAMES
SHIPPED = "shipped"
CRC_DROP = "crc_drop"
DECODE_DROP = "decode_drop"
_TX = "tx"


def encode_telem(doc: dict) -> bytes:
    """TELEM frame body: ``u32 crc32(payload) + payload``, the payload the
    UTF-8 JSON snapshot."""
    payload = json.dumps(doc, default=str).encode()
    return _CRC.pack(zlib.crc32(payload)) + payload


def decode_telem(body: bytes) -> dict | None:
    """Inverse of :func:`encode_telem`; None (the drop counted) on a CRC
    mismatch or malformed JSON."""
    if len(body) < _CRC.size:
        _M_TELEM_FRAMES.inc(outcome=DECODE_DROP)
        return None
    (crc,) = _CRC.unpack_from(body)
    payload = body[_CRC.size:]
    if zlib.crc32(payload) != crc:
        _M_TELEM_FRAMES.inc(outcome=CRC_DROP)
        return None
    try:
        doc = json.loads(payload.decode())
    except (UnicodeDecodeError, ValueError):
        _M_TELEM_FRAMES.inc(outcome=DECODE_DROP)
        return None
    if not isinstance(doc, dict):
        _M_TELEM_FRAMES.inc(outcome=DECODE_DROP)
        return None
    return doc


def _thread_stacks() -> dict[str, str]:
    names = {t.ident: t.name for t in threading.enumerate()}
    return {
        f"{names.get(tid, 'unknown')}-{tid}": "".join(traceback.format_stack(frame))
        for tid, frame in sys._current_frames().items()
    }


class TelemetryShipper:
    """On a bounded cadence, export everything new since the last ship
    (journal and spans by sequence cursor, the metrics as a full render)
    and hand the encoded TELEM body to ``send``.  Pumped from the worker's
    frame loop: no thread of its own."""

    def __init__(self, send, instance: str, *, clock=time.monotonic,
                 interval_s: float = 0.25,
                 budget_bytes: int = TELEM_BUDGET_BYTES,
                 journal=None, traces=None, registry=None):
        self._send = send
        self.instance = str(instance)
        self.clock = clock
        self.interval_s = float(interval_s)
        self.budget_bytes = int(budget_bytes)
        self._journal = journal if journal is not None else JOURNAL
        self._traces = traces if traces is not None else TRACES
        self._registry = registry if registry is not None else REGISTRY
        self._journal_cursor = 0
        self._span_cursor = 0
        self._last_ship = -float("inf")
        self.shipped_frames = 0
        self.shipped_bytes = 0
        self.last_frame_bytes = 0

    def _fit(self, doc: dict) -> bytes:
        """Shed sections until the encoded body fits the budget: stacks,
        then the oldest halves of the journal and the spans, then the
        metrics text."""
        body = encode_telem(doc)
        if len(body) <= self.budget_bytes:
            return body
        doc = dict(doc)
        doc["truncated"] = True
        doc.pop("stacks", None)
        for key in ("journal", "spans"):
            body = encode_telem(doc)
            if len(body) <= self.budget_bytes:
                return body
            items = list(doc.get(key) or [])
            while items and len(body) > self.budget_bytes:
                items = items[max(1, len(items) // 2):]  # drop the oldest half
                doc[key] = items
                body = encode_telem(doc)
        if len(body) > self.budget_bytes:
            doc["metrics"] = ""
            body = encode_telem(doc)
        return body

    def maybe_ship(self, force: bool = False, include_stacks: bool = False) -> int:
        """Ship one snapshot if the cadence (or ``force``) says so; returns
        the body's size in bytes, 0 when the cadence held fire."""
        now = self.clock()
        if not force and now - self._last_ship < self.interval_s:
            return 0
        self._last_ship = now
        self._journal_cursor, events = self._journal.export_since(self._journal_cursor)
        self._span_cursor, spans = self._traces.export_since(self._span_cursor)
        doc = {
            "instance": self.instance,
            "mono": now,
            "journal": events,
            "spans": spans,
            "metrics": self._registry.render(),
        }
        if include_stacks:
            doc["stacks"] = _thread_stacks()
        body = self._fit(doc)
        self._send(body)
        self.shipped_frames += 1
        self.shipped_bytes += len(body)
        self.last_frame_bytes = len(body)
        _M_TELEM_FRAMES.inc(outcome=SHIPPED)
        _M_TELEM_BYTES.inc(len(body), direction=_TX)
        return len(body)
