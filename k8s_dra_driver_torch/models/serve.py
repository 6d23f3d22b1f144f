"""Continuous-batching serving (``k8s_dra_driver_tpu/models/serve.py``).

What the engines share: slot state and completions, admission checks,
retirement and its early funnel (cancel, quarantine, a parked request's
death), the sampling tail, the fault window, the wedge error, snapshot
entries and their restore checks, load shedding and the
continuous-batching ``_pump``; KV payloads (:class:`KVSlice`, with the
reference's wire frame byte for byte, ``to_wire``/``from_wire``) and the
check of whether one fits an engine (``_kv_geometry_ok``); the serving metrics (the reference's
``tpu_serve_*`` families in the port's ``utils/metrics.REGISTRY``), the
journal records and the request telemetry (``models/telemetry``) along
every one of those paths; and, re-exported from ``models/graphs``,
:class:`GraphedProgram`, the counterpart of the reference's ``shared_jit``
(an engine program captured once as a CUDA graph and replayed), with
:func:`disable_graphs`.  ``models/paged.PagedServeEngine`` uses these.

The dense :class:`ServeEngine`: a fixed pool of slots over one dense KV
cache ``[L, n_slots, max_seq, Hkv, hd]``, its programs (admission, prefix-hit
admission, K-step bursts) written as plain functions on tensors that
update the cache in place, with a prefix cache, cancel, quarantine,
snapshot and restore (with KV payloads: handoff and inject), the fleet
prefix tier's surface, and ``stats()``.
"""

from __future__ import annotations

import struct
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from k8s_dra_driver_torch.device import params_device
from k8s_dra_driver_torch.models import decode, lora, prng
from k8s_dra_driver_torch.models.burnin import ModelConfig
from k8s_dra_driver_torch.models.graphs import (  # noqa: F401  (re-exported)
    GraphCaptureError,
    GraphedProgram,
    add_launch_counts,
    disable_graphs,
    graphs_enabled,
    launch_counts,
)
from k8s_dra_driver_torch.models.quant import quantize_blocks
from k8s_dra_driver_torch.models.speculative import accept_advance
from k8s_dra_driver_torch.models.telemetry import EngineTelemetry, terminal_retirer
from k8s_dra_driver_torch.ops import collectives
from k8s_dra_driver_torch.parallel.mesh import SlotGroup, slot_group
from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.metrics import REGISTRY

# The serving metrics, the reference's families letter for letter (both
# engines record into them; ``models/paged`` adds its pool's):
_M_TOKENS = REGISTRY.counter(
    "tpu_serve_tokens_total", "tokens generated by the serving engine"
)
_M_REQUESTS = REGISTRY.counter(
    "tpu_serve_requests_total", "requests admitted",
)
_M_COMPLETED = REGISTRY.counter(
    "tpu_serve_completions_total", "requests completed (eos or max_tokens)"
)
_M_PREFIX = REGISTRY.counter(
    "tpu_serve_prefix_cache_total", "prefix-cache lookups by outcome"
)
_M_OCCUPANCY = REGISTRY.gauge(
    "tpu_serve_slot_occupancy", "active slots right after the last step"
)
_M_REQ_TOKENS = REGISTRY.histogram(
    "tpu_serve_request_generated_tokens",
    "generated tokens per completed request",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
)
# one per decode-loop readback (admissions excluded): the reference's meaning
_M_HOST_SYNCS = REGISTRY.counter(
    "tpu_serve_host_syncs_total",
    "device->host sync points in the decode loop (one per step or burst)",
)
_M_STEP_LATENCY = REGISTRY.histogram(
    "tpu_serve_step_seconds",
    "wall time of one decode step or burst (dispatch through bookkeeping)",
)
_M_TOK_RATE = REGISTRY.gauge(
    "tpu_serve_tokens_per_second",
    "generation rate over the last pump() window",
)
_M_SHED = REGISTRY.counter(
    "tpu_serve_shed_total",
    "requests rejected by bounded admission (the serving 429)",
)
_M_DEADLINE = REGISTRY.counter(
    "tpu_serve_deadline_exceeded_total",
    "requests retired at their step-budget deadline before max_tokens",
)
_M_QUAR = REGISTRY.counter(
    "tpu_serve_quarantine_total",
    "slots quarantined (non-finite logits or attributable step faults)",
)
_M_QUEUE_DEPTH = REGISTRY.gauge(
    "tpu_serve_queue_depth",
    "requests waiting for admission in the current pump() window",
)

# every Completion.status; a snapshot entry carrying one has already ended
TERMINAL_STATUSES = frozenset(
    {"ok", "deadline_exceeded", "cancelled", "quarantined", "shed", "error"}
)

# The KVSlice wire frame, the reference's byte for byte: a header (rid,
# geometry, payload CRC), its own CRC, then the payload in length-prefixed
# chunks closed by a zero-length sentinel, so a truncation always shows.
# Version 2 adds quantized payloads (a block_size field, scale planes).
WIRE_MAGIC = b"TKV1"
WIRE_VERSION = 2
WIRE_CHUNK = 256 * 1024
_WIRE_HEADER = "!BQIIIIII"

# counted by the engines when a payload arrives but cannot inject (the
# reference's family; its router counts the channel's losses in its own)
_M_DISAGG_FALLBACK = REGISTRY.counter(
    "tpu_disagg_fallback_total",
    "KV handoffs that fell back to re-prefill instead of injecting, by reason",
)


class WireFormatError(ValueError):
    """A :class:`KVSlice` wire frame that does not decode: a truncation, a
    flipped bit, an impossible geometry or a checksum mismatch, raised
    before any payload exists.  ``request_id`` is the frame's once its
    header could be read, else -1."""

    def __init__(self, message: str, request_id: int = -1):
        super().__init__(message)
        self.request_id = int(request_id)


def dtype_label(dtype: torch.dtype) -> str:
    """A float cache dtype's payload label: "float32", "bfloat16", "float16"."""
    return str(dtype).removeprefix("torch.")


def _storage(label: str) -> np.dtype:
    """The numpy storage of a float payload: bf16 travels as its raw 16-bit
    words (numpy has no bf16 of its own)."""
    return np.dtype(np.uint16) if label == "bfloat16" else np.dtype(label)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as a contiguous numpy array that owns its bytes
    (one device-to-host copy; on the CPU a copy too, never a view of the
    cache), bf16 as uint16 words."""
    t = t.contiguous().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def device_tensor(a, label: str, device) -> torch.Tensor:
    """A payload array on ``device`` (one host-to-device copy): a bf16
    payload's 16-bit words, whether uint16 or the reference's
    ``ml_dtypes`` bfloat16, reinterpreted as bf16."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # a frame's buffer: torch wants memory it may write
        a = a.copy()
    if label == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).to(device).view(torch.bfloat16)
    return torch.from_numpy(a).to(device)


def _chained_crc(planes) -> int:
    crc = 0
    for plane in planes:
        crc = zlib.crc32(plane, crc)
    return crc


@dataclass
class KVSlice:
    """One request's KV payload (the reference's ``KVSlice``): the ``"kv"``
    of a handoff entry or of ``snapshot_active(include_kv=True)``, and the
    fleet prefix tier's pull unit.  Layout ``[n_layers, valid_len,
    kv_heads, head_dim]`` for both engines, ``valid_len = len(tokens) - 1``
    (the frontier's K/V are rewritten by the next step).  Arrays are numpy
    on the host; bf16 as uint16 words under the label "bfloat16", so no
    ``ml_dtypes`` is needed and the bytes are the reference's.

    A quantized pool's payload (``block_size > 0``, dtype "int8" or
    "int4") carries the pool's raw values over the padded ``ceil(valid_len
    / block_size) * block_size`` positions, int4 as packed uint8 along
    ``head_dim`` (``head_dim // 2``), and the per-block f32 scales
    ``[n_layers, n_blocks, kv_heads]``, so the receiving pool gets the
    source's bytes.  Not JSON: a snapshot carrying payloads is a transfer
    artifact."""

    k: np.ndarray
    v: np.ndarray
    valid_len: int
    n_layers: int
    kv_heads: int
    head_dim: int
    dtype: str
    k_scale: np.ndarray | None = None
    v_scale: np.ndarray | None = None
    block_size: int = 0

    @property
    def quantized(self) -> bool:
        return self.block_size > 0

    @property
    def nbytes(self) -> int:
        n = int(self.k.nbytes) + int(self.v.nbytes)
        if self.k_scale is not None:
            n += int(self.k_scale.nbytes) + int(self.v_scale.nbytes)
        return n

    def _planes(self) -> list[bytes]:
        planes = [self.k, self.v]
        if self.k_scale is not None:
            planes += [self.k_scale, self.v_scale]
        return [np.ascontiguousarray(p).tobytes() for p in planes]

    def checksum(self) -> int:
        """CRC32 chained over k, v and, when quantized, the two scale planes."""
        return _chained_crc(self._planes())

    def to_wire(self, request_id: int) -> bytes:
        """The wire frame of this payload for ``request_id``."""
        planes = self._planes()
        kb, vb, ksb, vsb = (planes + [b"", b""])[:4]
        dt = self.dtype.encode("ascii")
        parts = [
            WIRE_MAGIC,
            struct.pack(_WIRE_HEADER, WIRE_VERSION, int(request_id), self.n_layers,
                        self.valid_len, self.kv_heads, self.head_dim, self.block_size,
                        _chained_crc(planes)),
            struct.pack("!B", len(dt)),
            dt,
            struct.pack("!QQQQ", len(kb), len(vb), len(ksb), len(vsb)),
        ]
        # the header's own CRC: a flipped rid or geometry shows even when
        # the payload bytes arrive intact
        parts.append(struct.pack("!I", zlib.crc32(b"".join(parts))))
        payload = kb + vb + ksb + vsb
        for off in range(0, len(payload), WIRE_CHUNK):
            chunk = payload[off:off + WIRE_CHUNK]
            parts += [struct.pack("!I", len(chunk)), chunk]
        parts.append(struct.pack("!I", 0))
        return b"".join(parts)

    @staticmethod
    def from_wire(buf: bytes) -> "tuple[int, KVSlice]":
        """Decode one frame into ``(request_id, KVSlice)``, raising
        :class:`WireFormatError` on every malformation, in the reference's
        order of checks and with its messages."""
        off = 0

        def need(n: int, what: str, rid: int = -1) -> int:
            if off + n > len(buf):
                raise WireFormatError(
                    f"kv wire frame truncated in {what}: need {n} bytes at offset {off}, "
                    f"have {len(buf) - off}", rid,
                )
            return off + n

        off = need(len(WIRE_MAGIC), "magic")
        if buf[:off] != WIRE_MAGIC:
            raise WireFormatError(f"bad kv wire magic {buf[:off]!r}")
        end = need(struct.calcsize(_WIRE_HEADER), "header")
        ver, rid, n_layers, valid_len, kv_heads, head_dim, block_size, crc = struct.unpack(
            _WIRE_HEADER, buf[off:end])
        off = end
        if ver != WIRE_VERSION:
            raise WireFormatError(f"kv wire version {ver} != {WIRE_VERSION}")
        end = need(1, "dtype length", rid)
        (dt_len,) = struct.unpack("!B", buf[off:end])
        off = end
        end = need(dt_len, "dtype", rid)
        try:
            dtype = buf[off:end].decode("ascii")
        except UnicodeDecodeError as exc:
            raise WireFormatError(f"kv wire dtype unreadable: {exc}", rid) from None
        if block_size > 0:  # a quant format's name: int4 has no numpy dtype
            if dtype not in ("int8", "int4"):
                raise WireFormatError(
                    f"kv wire block_size={block_size} with non-quantized dtype {dtype!r} for "
                    f"req-{rid}", rid,
                )
            storage = np.dtype(np.uint8 if dtype == "int4" else np.int8)
        else:
            try:
                storage = _storage(dtype)
            except TypeError as exc:
                raise WireFormatError(f"kv wire dtype unreadable: {exc}", rid) from None
        off = end
        end = need(32, "payload sizes", rid)
        k_nbytes, v_nbytes, ks_nbytes, vs_nbytes = struct.unpack("!QQQQ", buf[off:end])
        off = end
        end = need(4, "header checksum", rid)
        (hcrc,) = struct.unpack("!I", buf[off:end])
        if zlib.crc32(buf[:off]) != hcrc:
            raise WireFormatError(f"kv wire header checksum mismatch (claimed req-{rid})", rid)
        off = end
        n_blocks = -(-valid_len // block_size) if block_size > 0 else 0
        if block_size > 0:  # the padded block extent, and one f32 scale per (layer, block, head)
            if head_dim % 2 and dtype == "int4":
                raise WireFormatError(
                    f"kv wire int4 payload with odd head_dim {head_dim} for req-{rid}", rid)
            padded = n_blocks * block_size
            last_dim = head_dim // 2 if dtype == "int4" else head_dim
            want = n_layers * padded * kv_heads * last_dim
            want_scale = n_layers * n_blocks * kv_heads * 4
            if (k_nbytes != want or v_nbytes != want
                    or ks_nbytes != want_scale or vs_nbytes != want_scale):
                raise WireFormatError(
                    f"kv wire geometry mismatch for req-{rid}: header says "
                    f"[{n_layers},{padded},{kv_heads},{last_dim}]/{dtype}"
                    f"+scales[{n_layers},{n_blocks},{kv_heads}] = {want}B/{want_scale}B but "
                    f"carries k={k_nbytes}B v={v_nbytes}B ks={ks_nbytes}B vs={vs_nbytes}B", rid,
                )
            shape = (n_layers, padded, kv_heads, last_dim)
        else:
            want = n_layers * valid_len * kv_heads * head_dim * storage.itemsize
            if k_nbytes != want or v_nbytes != want or ks_nbytes or vs_nbytes:
                raise WireFormatError(
                    f"kv wire geometry mismatch for req-{rid}: header says "
                    f"[{n_layers},{valid_len},{kv_heads},{head_dim}]/{dtype} = {want}B per "
                    f"tensor but carries k={k_nbytes}B v={v_nbytes}B ks={ks_nbytes}B "
                    f"vs={vs_nbytes}B", rid,
                )
            shape = (n_layers, valid_len, kv_heads, head_dim)
        total = k_nbytes + v_nbytes + ks_nbytes + vs_nbytes
        chunks, got = [], 0
        while True:
            end = need(4, "chunk length", rid)
            (n,) = struct.unpack("!I", buf[off:end])
            off = end
            if n == 0:
                break
            if got + n > total:
                raise WireFormatError(
                    f"kv wire chunk overrun for req-{rid}: {got + n}B exceeds declared payload "
                    f"{total}B", rid,
                )
            end = need(n, "chunk body", rid)
            chunks.append(buf[off:end])
            off = end
        if off != len(buf):
            raise WireFormatError(
                f"kv wire frame for req-{rid} carries {len(buf) - off} trailing bytes after the "
                f"sentinel", rid,
            )
        payload = bytearray().join(chunks)  # writable: the arrays below own it
        if len(payload) != total:
            raise WireFormatError(
                f"kv wire frame truncated for req-{rid}: sentinel after {len(payload)}B of a "
                f"declared {total}B payload", rid,
            )
        cuts = np.cumsum([0, k_nbytes, v_nbytes, ks_nbytes, vs_nbytes]).tolist()
        view = memoryview(payload)
        got_crc = _chained_crc(view[lo:hi] for lo, hi in zip(cuts, cuts[1:]))
        if got_crc != crc:
            raise WireFormatError(
                f"kv wire checksum mismatch for req-{rid}: header {crc:#010x} != payload "
                f"{got_crc:#010x}", rid,
            )

        def plane(i, dt, shp):
            return np.frombuffer(payload, dt, count=(cuts[i + 1] - cuts[i]) // dt.itemsize,
                                 offset=cuts[i]).reshape(shp)

        scales = {}
        if block_size > 0:
            sshape = (n_layers, n_blocks, kv_heads)
            scales = dict(k_scale=plane(2, np.dtype(np.float32), sshape),
                          v_scale=plane(3, np.dtype(np.float32), sshape), block_size=block_size)
        return rid, KVSlice(
            k=plane(0, storage, shape), v=plane(1, storage, shape), valid_len=valid_len,
            n_layers=n_layers, kv_heads=kv_heads, head_dim=head_dim, dtype=dtype, **scales,
        )


_KV_FIELDS = ("k", "v", "valid_len", "n_layers", "kv_heads", "head_dim", "dtype", "k_scale",
              "v_scale", "block_size")


def is_kv_payload(kv) -> bool:
    """Whether ``kv`` carries a KVSlice's fields: the port's class or the
    reference's (a fleet prefix pull decodes through the reference's
    ``from_wire``), told apart by nothing but their fields."""
    return all(hasattr(kv, f) for f in _KV_FIELDS)


def _kv_geometry_ok(engine, kv, n_tokens: int) -> bool:
    """Whether payload ``kv`` can inject into ``engine`` for a history of
    ``n_tokens``: the ``valid_len == n_tokens - 1`` invariant, the model's
    geometry, and the pool's format; anything else re-prefills (the same
    tokens, at the cost of compute).  A quantized payload injects only
    into a pool of the same quant format and block size (its scales are
    per source block); a float one only into a float cache of its dtype."""
    cfg = engine.cfg
    if not (is_kv_payload(kv)
            and kv.valid_len == n_tokens - 1
            and 0 < kv.valid_len <= cfg.max_seq
            and kv.n_layers == cfg.n_layers
            and kv.kv_heads == cfg.kv_heads
            and kv.head_dim == cfg.head_dim):
        return False
    if kv.block_size > 0:
        if (getattr(engine, "kv_dtype", None) != kv.dtype
                or getattr(engine, "block_size", 0) != kv.block_size
                or kv.k_scale is None or kv.v_scale is None):
            return False
        n_blocks = -(-kv.valid_len // kv.block_size)
        last = cfg.head_dim // 2 if kv.dtype == "int4" else cfg.head_dim
        return (tuple(kv.k.shape) == (cfg.n_layers, n_blocks * kv.block_size, cfg.kv_heads, last)
                and tuple(kv.v.shape) == tuple(kv.k.shape)
                and tuple(kv.k_scale.shape) == (cfg.n_layers, n_blocks, cfg.kv_heads)
                and tuple(kv.v_scale.shape) == tuple(kv.k_scale.shape))
    if getattr(engine, "kv_dtype", None) is not None:
        return False
    return (kv.dtype == dtype_label(engine.cache_dtype)
            and tuple(kv.k.shape) == (cfg.n_layers, kv.valid_len, cfg.kv_heads, cfg.head_dim)
            and tuple(kv.v.shape) == tuple(kv.k.shape))


def split_prefix_key(engine, key) -> tuple:
    """A prefix store key back to ``(adapter, tokens)`` (both engines key
    by ``(adapter, tokens)`` with a bank, by the tokens without)."""
    if engine.adapter_bank is not None:
        return int(key[0]), key[1]
    return 0, key


class NoCapacity(RuntimeError):
    """No free slot or not enough free pool blocks for a request right now
    (a RuntimeError, as the reference raises)."""


class ShedError(RuntimeError):
    """A request rejected because the pump's admission queue is full (the
    serving 429); ``retry_after_s`` estimates when the queue will have
    drained: its depth times the engine's last step time."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class SnapshotRestoreError(ValueError):
    """A snapshot that cannot be restored as a whole: an entry carries a
    terminal status, so its completion was already delivered.  Raised
    before any engine state changes."""

    def __init__(self, request_id: int, status: str):
        super().__init__(
            f"snapshot entry req-{request_id} carries terminal status "
            f"{status!r}: the stream already ended and its completion was "
            f"delivered — restoring it would duplicate the request"
        )
        self.request_id = request_id
        self.status = status


def check_restorable(snapshot: dict) -> None:
    """Raise :class:`SnapshotRestoreError` for a snapshot holding an entry
    with a terminal status, before ``restore`` touches anything."""
    for req in snapshot.get("requests", ()):
        status = str(req.get("status", "") or "")
        if status in TERMINAL_STATUSES:
            raise SnapshotRestoreError(int(req.get("request_id", -1)), status)


@dataclass
class _Slot:
    request_id: int
    tokens: list[int]  # prompt + generated so far
    prompt_len: int
    max_tokens: int
    # hard cap on GENERATED tokens, min'd with max_tokens (_slot_budget)
    deadline: int | None = None
    adapter: int = 0  # the serving bank's row for this request (0: the base)


@dataclass
class Completion:
    request_id: int
    tokens: list[int]  # prompt + generated
    generated: list[int]
    error: str = ""
    # one of TERMINAL_STATUSES: "ok" (eos / max_tokens),
    # "deadline_exceeded", "cancelled", "quarantined", "shed" (rejected by
    # the pump's queue limit, request id -1) or "error" (a re-admission or
    # restore that failed); all but "ok" and "shed" still deliver every
    # token generated before the retirement
    status: str = "ok"


def check_submit(
    prompt: list[int], max_tokens: int, prompt_bucket: int, max_seq: int,
    spec_gamma: int = 0, temperature: float = 0.0, deadline: int | None = None,
) -> None:
    """Admission validation shared by the engines.  Any temperature is
    admitted (above 0 samples, 0 or below is greedy) unless ``spec_gamma >
    0``: speculative serving verifies the argmax, so it takes temperature
    0 only, and needs the verify window's slack under ``max_seq``."""
    if not prompt:
        raise ValueError("empty prompt")
    if max_tokens < 1:
        raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
    if deadline is not None and deadline < 1:
        raise ValueError(f"deadline must be >= 1 generated token, got {deadline}")
    if len(prompt) > prompt_bucket:
        raise ValueError(f"prompt {len(prompt)} exceeds bucket {prompt_bucket}")
    if len(prompt) + max_tokens > max_seq:
        raise ValueError("prompt + max_tokens exceeds max_seq")
    if spec_gamma > 0:
        if temperature != 0.0:
            raise ValueError("speculative serving verifies argmax — temperature must be 0")
        if _spec_slack_short(len(prompt), max_tokens, spec_gamma, max_seq):
            raise ValueError(
                "prompt + max_tokens needs spec_gamma verify-window slack under max_seq"
            )


def _spec_slack_short(prompt_len: int, max_tokens: int, gamma: int, max_seq: int) -> bool:
    """The exact bound: a slot's last round starts at ``pos = prompt_len +
    max_tokens - 2`` (one more committed token retires it) and writes its
    verify window at ``pos .. pos + gamma``, so the deepest write is
    ``prompt_len + max_tokens + gamma - 2``, which must be below
    ``max_seq``."""
    return prompt_len + max_tokens + gamma - 1 > max_seq


def _slot_budget(st: _Slot) -> int:
    """Generated-token budget: ``max_tokens`` capped by the deadline."""
    return st.max_tokens if st.deadline is None else min(st.max_tokens, st.deadline)


def completion_if_done(st: _Slot, eos_id: int | None, max_seq: int):
    """The Completion when the slot hit eos or its budget, else None."""
    n_gen = len(st.tokens) - st.prompt_len
    if len(st.tokens) > max_seq:
        raise RuntimeError("cache overrun: submit() invariant broken")
    budget = _slot_budget(st)
    hit_eos = eos_id is not None and st.tokens[-1] == eos_id
    if n_gen < budget and not hit_eos:
        return None
    status = "ok"
    if not hit_eos and budget < st.max_tokens:
        status = "deadline_exceeded"
        _M_DEADLINE.inc()
    _M_COMPLETED.inc()
    _M_REQ_TOKENS.observe(n_gen)
    return Completion(
        request_id=st.request_id,
        tokens=list(st.tokens),
        generated=list(st.tokens[st.prompt_len:]),
        status=status,
    )


def sample_next(logits, pos, temps, keys, *, top_k: int) -> torch.Tensor:
    """The per-slot sampling tail (``logits [B, V]`` f32 at positions ``pos
    [B]``): rows with ``temps > 0`` draw a categorical from the logits over
    the temperature, masked below the ``top_k``-th value when ``top_k >
    0``, under the step key ``fold_in(keys [B, 2], pos)``; the other rows
    take the argmax (the first maximum on ties, as ``jnp.argmax``).  Every
    row computes both, as the reference does.  Returns int32 ``[B]``."""
    greedy = logits.argmax(dim=-1)
    scaled = logits / temps.clamp_min(1e-6)[:, None]
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    sampled = prng.categorical(prng.fold_in(keys, pos), scaled)
    return torch.where(temps > 0.0, sampled, greedy).to(torch.int32)


@terminal_retirer
def _early_retire(engine, slot: int, status: str, error: str) -> Completion:
    """Early retirement for cancellation and quarantine: free the slot and
    release what it holds on the device (``engine._release_slot``: the
    paged engine refunds its pool blocks, the dense one clears its active
    row), deliver a typed Completion with every token so far, journal it
    and retire its trace."""
    st = engine._slots[slot]
    engine._slots[slot] = None
    engine._release_slot(slot)
    done = _completion_of(engine, st, status, error)
    JOURNAL.record(
        "serve", f"request.{status}", correlation=f"req-{st.request_id}",
        slot=slot, generated=len(done.generated),
    )
    engine.telemetry.on_retire(done.request_id, status, len(done.generated))
    engine._update_gauges()
    return done


@terminal_retirer
def _retire_parked(engine, st: _Slot, status: str, error: str) -> Completion:
    """The slot-less twin of :func:`_early_retire`, for a request that ends
    while parked (cancelled, or its admission or re-admission failed): the
    caller has unwound its blocks; the Completion, journal record and
    telemetry are the same."""
    done = _completion_of(engine, st, status, error)
    JOURNAL.record(
        "serve", f"request.{status}", correlation=f"req-{st.request_id}",
        generated=len(done.generated), parked=True,
    )
    engine.telemetry.on_retire(done.request_id, status, len(done.generated))
    return done


def _completion_of(engine, st: _Slot, status: str, error: str) -> Completion:
    """Deliver ``st``'s typed Completion with every token so far."""
    done = Completion(
        request_id=st.request_id,
        tokens=list(st.tokens),
        generated=list(st.tokens[st.prompt_len:]),
        status=status,
        error=error,
    )
    engine._completions.append(done)
    return done


def _quarantine_slot(engine, slot: int, kind: str, detail: str = "") -> None:
    """Retire ONE poisoned slot as "quarantined" and count it; rows are
    independent, so the survivors' streams are those of a batch that never
    held it.  At ``quarantine_limit`` distinct requests the engine raises
    "engine poisoned"."""
    done = _early_retire(engine, slot, "quarantined", detail or kind)
    engine.quarantined.append(done.request_id)
    _M_QUAR.inc(kind=kind)
    if len(engine.quarantined) >= engine.quarantine_limit:
        raise _wedge_error(
            engine,
            f"engine poisoned: {len(engine.quarantined)} requests "
            f"quarantined (limit {engine.quarantine_limit})",
        )


def _inject_step_faults(engine) -> tuple[np.ndarray, int]:
    """The fault window before a step dispatches (``utils/faults``): the
    step's added latency, then for each resident slot an injected
    ``StepFault`` (the slot quarantines here, before any state moves) or
    NaN logits (its row of the returned poison mask).  Returns ``(poison
    [n_slots] bool, slots quarantined)``."""
    poison = np.zeros((engine.n_slots,), bool)
    inj = engine.fault_injector
    if inj is None:
        return poison, 0
    from k8s_dra_driver_torch.utils.faults import StepFault

    inj.take_step_latency()
    hit = 0
    # a slot mid-admission is not decoding yet, and quarantining it would
    # orphan its admission-queue entry: the window skips it until it activates
    admitting = {a["slot"] for a in getattr(engine, "_admitting", ())}
    for slot, st in enumerate(engine._slots):
        if st is None or slot in admitting:
            continue
        try:
            inj.maybe_raise_step(slot, engine._step_no)
        except StepFault as exc:
            _quarantine_slot(engine, slot, "step_raise", str(exc))
            hit += 1
            continue
        if inj.take_nan_logits(slot, engine._step_no):
            poison[slot] = True
    return poison, hit


def _first_bad_steps(trace_act, trace_bad) -> dict:
    """slot -> the first burst step whose logits went non-finite while the
    slot was active.  Tokens before it are sound; the slot quarantines
    there."""
    out: dict = {}
    bad = np.asarray(trace_act) & np.asarray(trace_bad)
    for j in range(bad.shape[0]):
        for slot in np.flatnonzero(bad[j]):
            out.setdefault(int(slot), j)
    return out


def _wedge_error(engine, reason: str, queue=None) -> RuntimeError:
    """The RuntimeError an engine that cannot go on raises ("engine
    wedged", "engine poisoned", "pump wedged"), with the state that says
    why: resident slots, prompts still admitting, parked requests, free
    blocks, stalls, the quarantined requests and the pump's queue depth."""
    resident = [st.request_id for st in engine._slots if st is not None]
    admitting = [(engine._slots[a["slot"]].request_id, a["done"])
                 for a in getattr(engine, "_admitting", ())]
    state = [
        f"resident {resident}",
        f"admitting (request, blocks done) {admitting}",
        f"parked {[r['st'].request_id for r in getattr(engine, '_preempted', ())]}",
        f"free blocks {getattr(engine, 'free_blocks', None)}",
        f"stalled steps {getattr(engine, 'stalled_steps', None)}",
        f"quarantined {list(getattr(engine, 'quarantined', ()))}",
    ]
    if queue is not None:
        state.append(f"queued {len(queue)}")
    return RuntimeError(f"{reason} ({', '.join(state)})")


def _snapshot_request(st: _Slot, temp: float, key, adapter: int = 0,
                      priority: int = 0, trace: dict | None = None) -> dict:
    """One in-flight request as a JSON-serialisable snapshot entry: its
    token history (prompt + generated), the sampler state that reproduces
    its continuation (temperature and BASE key as plain ints: step keys
    are ``fold_in(base, pos)``), its adapter id and priority, and its
    telemetry ``trace`` (absent when telemetry is off), which the
    restoring engine rebuilds.  The reference's document."""
    doc = {
        "request_id": st.request_id,
        "tokens": [int(t) for t in st.tokens],
        "prompt_len": st.prompt_len,
        "max_tokens": st.max_tokens,
        "deadline": st.deadline,
        "temperature": float(temp),
        "key": [int(x) for x in np.asarray(key).tolist()],
        "adapter": int(adapter),
        "priority": int(priority),
    }
    if trace is not None:
        doc["trace"] = trace
    return doc


@terminal_retirer
def full_stream_tokens(entry: dict) -> int:
    """A snapshot entry's token footprint at full growth: the prompt plus
    the request's whole generation budget (reference ``serve.py:773``).
    The disaggregated router's KV-demand ledger (``models/disagg.py``)
    reserves decode blocks against this bound."""
    tokens = entry.get("tokens") or ()
    return max(
        int(entry.get("prompt_len", len(tokens))) + int(entry.get("max_tokens", 0)),
        len(tokens),
    )


def _unrestorable(engine, req: dict, why: str) -> None:
    """A snapshot entry this engine cannot rebuild (history past the prompt
    bucket, or no free slot) is delivered as an "error" completion rather
    than dropped."""
    tokens = [int(t) for t in req["tokens"]]
    engine._completions.append(Completion(
        request_id=int(req["request_id"]),
        tokens=tokens,
        generated=tokens[int(req["prompt_len"]):],
        status="error",
        error=f"unrestorable: {why}",
    ))
    JOURNAL.record(
        "serve", "request.unrestorable", correlation=f"req-{req['request_id']}", reason=why,
    )
    engine.telemetry.on_retire(int(req["request_id"]), "error",
                               len(tokens) - int(req["prompt_len"]))


@terminal_retirer
def _shed(engine, req, depth: int, queue_limit: int,
          queued_at: float | None = None) -> Completion:
    """Reject the newest queued request: count it, keep its
    :class:`ShedError` (retry after ``depth`` times the engine's last step
    time, at least 0.05 s), observe its queue wait (from ``queued_at``, the
    only SLO signal a shed request leaves) and return its "shed"
    Completion.  Host-only: the request never reaches ``submit``, so it
    costs no device work."""
    prompt = req.get("prompt") if isinstance(req, dict) else req[0]
    retry_after = round(max(0.05, depth * max(engine._last_step_s, 1e-3)), 3)
    err = ShedError(
        f"admission queue full ({depth} waiting > limit {queue_limit}); "
        f"retry after {retry_after}s",
        retry_after,
    )
    engine.shed_count += 1
    engine.last_shed = err
    _M_SHED.inc()
    engine.telemetry.on_shed(queued_at)
    JOURNAL.record(
        "serve", "request.shed", depth=depth, limit=queue_limit, retry_after_s=retry_after,
    )
    return Completion(
        request_id=-1, tokens=list(prompt), generated=[], status="shed", error=str(err),
    )


def _pump(engine, requests, max_steps: int, queue_limit: int | None = None) -> list:
    """Continuous-batching drive: admit queued ``(prompt, max_tokens)``
    pairs (or dicts of ``submit`` kwargs) FIFO as capacity frees,
    burst-step in between, return every completion once nothing is
    queued, resident (a prompt still admitting holds its slot) or parked.
    ``queue_limit`` bounds the requests left waiting after each admission
    round: the overflow is shed newest-first (:func:`_shed`), so the oldest
    keep their place.  The whole starting queue shares one enqueue stamp
    (``queued_at`` of every submit it makes, one clock read, None with
    telemetry off); ``engine.pump_stats`` holds the queue depth
    ``stats()`` reports."""
    queue = list(requests)
    out: list = []
    generated = 0
    start = time.perf_counter()
    t_enq = engine.telemetry.now()
    enq_at = [t_enq] * len(queue)
    stats = {"queue_depth": len(queue), "sheds": 0}
    engine.pump_stats = stats
    for _ in range(max_steps):
        admitted = False
        while queue and engine.free_slots() > 0:
            req = queue[0]
            try:
                if isinstance(req, dict):
                    engine.submit(**dict(dict(queued_at=enq_at[0]), **req))
                else:
                    prompt, max_tokens = req
                    engine.submit(prompt, max_tokens=max_tokens, queued_at=enq_at[0])
            except NoCapacity:
                break  # out of slots or blocks, or requests parked: step
            queue.pop(0)
            enq_at.pop(0)
            admitted = True
        if queue_limit is not None:
            while len(queue) > queue_limit:
                out.append(_shed(engine, queue.pop(), len(queue) + 1, queue_limit,
                                 queued_at=enq_at.pop()))
                stats["sheds"] += 1
        stats["queue_depth"] = len(queue)
        _M_QUEUE_DEPTH.set(len(queue))
        admitting = bool(getattr(engine, "_admitting", ()))  # a chunk advancing is progress
        stepped = engine.step_burst()
        for c in engine.completions():
            generated += len(c.generated)
            out.append(c)
        if (not queue and engine.free_slots() == engine.n_slots
                and not getattr(engine, "_preempted", ())):
            wall = time.perf_counter() - start
            if generated and wall > 0:
                _M_TOK_RATE.set(round(generated / wall, 1))
            _M_QUEUE_DEPTH.set(0)
            return out
        if stepped == 0 and not admitted and not admitting:
            raise _wedge_error(
                engine, "pump wedged: queued or resident requests, no progress",
                queue=queue,
            )
    raise _wedge_error(engine, f"pump did not drain in {max_steps} steps", queue=queue)


def run_program(engine, name: str, fn):
    """Run an engine's program ``fn`` (no arguments: it reads the engine's
    fixed buffers): eagerly on the CPU and under :func:`disable_graphs`,
    else as the engine's CUDA graph ``name`` (in ``engine._programs``),
    captured on its second call."""
    if engine.device.type != "cuda" or not graphs_enabled():
        return fn()
    prog = engine._programs.get(name)
    if prog is None:
        prog = engine._programs[name] = GraphedProgram(name, fn, engine.device)
    return prog()


def _burst_trace(step, k: int, last, pos, active, stop_pos, eos_id: int):
    """K steps with no host read inside, both engines' burst: ``step(last,
    pos, active) -> (next_token, bad)`` samples every row, then the
    on-device stop mask (``decode.advance_decode_state``) retires rows
    that hit eos or their stop depth.  Returns ``(trace [3, K, B] int32 —
    token / pre-step active / bad planes stacked for ONE readback, last,
    pos, active)``."""
    planes = []
    for _ in range(k):
        next_tok, bad = step(last, pos, active)
        new_last, new_pos, new_active = decode.advance_decode_state(
            next_tok, last, pos, active, stop_pos, eos_id
        )
        planes.append(torch.stack([next_tok, active.to(torch.int32), bad.to(torch.int32)]))
        last, pos, active = new_last, new_pos, new_active
    return torch.stack(planes, dim=1), last, pos, active


# -- the dense engine's programs (the reference's compiled ones) -------------

def _step_all_slots(params, cache, tokens, pos, active, temps, keys, poison=None,
                    *, cfg: ModelConfig, top_k: int, adapters=None):
    """One dense decode step for every slot at its own position
    (``decode.decode_step`` with the active gate and the slots' adapters,
    ``(bank, ids [B])`` or None), then the sampling tail.  ``poison [B]``
    turns rows' logits to NaN first; ``bad`` flags rows whose logits are
    not finite.  Rows stay independent.  Returns ``(next_token [B] int32,
    bad [B] bool, cache)``."""
    logits, cache = decode.decode_step(params, cache, tokens.long(), pos, cfg=cfg, active=active,
                                       adapters=adapters)
    logits = decode.poison_rows(logits, poison)
    bad = ~decode.finite_rows(logits)
    return sample_next(logits, pos, temps, keys, top_k=top_k), bad, cache


def _pipelined_burst(params, cache, tokens, pos, active, temps, keys, stop_pos, poison=None,
                     *, cfg: ModelConfig, top_k: int, eos_id: int, k: int, adapters=None):
    """K fused dense steps (:func:`_burst_trace`); ``temps``, ``keys``,
    ``poison`` and ``adapters`` hold for the whole burst.  Returns
    ``(trace [3, K, B] int32, cache, last, pos, active)``."""

    def step(last, pos_, act):
        next_tok, bad, _ = _step_all_slots(
            params, cache, last, pos_, act, temps, keys, poison, cfg=cfg, top_k=top_k,
            adapters=adapters,
        )
        return next_tok, bad

    trace, last, pos, active = _burst_trace(step, k, tokens, pos, active, stop_pos, eos_id)
    return trace, cache, last, pos, active


def _commit_row_and_first_token(params, cache, row_k, row_v, prompt, plen, slot, temp, key,
                                *, cfg: ModelConfig, top_k: int, adapters=None):
    """The admission tail of both prefill paths: zero the row ``[L,
    max_seq, Hkv, hd]`` at positions ``>= plen`` and copy it into the slot,
    then compute the first token by re-running the step for all slots at
    ``plen - 1`` with only the slot active (the rewrite of that position is
    idempotent; the other rows keep their bytes), at the admission's
    temperature and key, under the slots' ``adapters``.  ``plen``, ``slot``
    and ``temp`` are 0-d tensors and ``key`` a ``[2]`` one, so one captured
    program serves every admission.  Returns ``(token [1], cache)``."""
    n_slots, max_seq = cache.k.shape[1], cache.k.shape[2]
    dev = prompt.device
    keep = (torch.arange(max_seq, device=dev) < plen)[None, :, None, None]
    at = slot.view(1).long()
    for row, whole in ((row_k, cache.k), (row_v, cache.v)):
        whole.index_copy_(1, at, torch.where(keep, row, 0).to(whole.dtype)[:, None])
    last = (plen - 1).view(1)
    tokens = prompt[0].index_select(0, last).expand(n_slots)
    active = torch.arange(n_slots, device=dev) == slot
    tok, _, cache = _step_all_slots(
        params, cache, tokens, last.expand(n_slots), active, temp.expand(n_slots),
        key.expand(n_slots, 2), cfg=cfg, top_k=top_k, adapters=adapters,
    )
    return tok.index_select(0, at), cache


def _row_adapters(adapters, slot):
    """The one-row view ``(bank, ids[slot] [1])`` of an engine's adapter
    context (None stays None): what the ``[1, bucket]`` admission prefill
    applies, picked on the device from the 0-d ``slot``."""
    if adapters is None:
        return None
    bank, ids = adapters
    return bank, ids.index_select(0, slot.view(1))


def _prefill_into_slot(params, cache, prompt, plen, slot, temp, key, *, cfg: ModelConfig,
                       top_k: int, adapters=None):
    """Fill one slot from the padded prompt ``[1, bucket]`` in one parallel
    forward (whose own last logits, at the bucket's end, are discarded),
    then the admission tail.  Returns ``(first token [1], cache)``."""
    row, _ = decode.prefill(params, prompt, cfg, max_seq=cache.k.shape[2],
                            cache_dtype=cache.k.dtype, adapters=_row_adapters(adapters, slot))
    return _commit_row_and_first_token(
        params, cache, row.k[:, 0], row.v[:, 0], prompt, plen, slot, temp, key,
        cfg=cfg, top_k=top_k, adapters=adapters,
    )


def _prefill_suffix_into_slot(params, cache, prefix_k, prefix_v, prompt, plen, slot, temp,
                              key, *, cfg: ModelConfig, top_k: int, prefix_bucket: int,
                              adapters=None):
    """The prefix-cache hit: the stored prefix K/V (positions ``<
    prefix_bucket``, ``[L, prefix_bucket, Hkv, hd]``) in a fresh row, the
    suffix's K/V from one ``decode_chunk`` at ``pos0 = prefix_bucket`` over
    the prompt bucket's key window (the full prefill's), then the
    admission tail.  Returns ``(first token [1], cache)``."""
    row = decode.init_cache(cfg, 1, cache.k.shape[2], dtype=cache.k.dtype, device=prompt.device)
    row.k[:, 0, :prefix_bucket] = prefix_k
    row.v[:, 0, :prefix_bucket] = prefix_v
    _, row = decode.decode_chunk(params, row, prompt[:, prefix_bucket:], prefix_bucket,
                                 cfg=cfg, k_window=prompt.shape[1],
                                 adapters=_row_adapters(adapters, slot))
    return _commit_row_and_first_token(
        params, cache, row.k[:, 0], row.v[:, 0], prompt, plen, slot, temp, key,
        cfg=cfg, top_k=top_k, adapters=adapters,
    )


# -- speculative rounds, shared by the dense and paged engines ----------------

def make_draft_state(params, draft_params, cfg: ModelConfig, n_slots: int, cache_dtype,
                     device):
    """The draft of speculative serving and its dense cache ``[n_draft,
    n_slots, max_seq, Hkv, hd]``, built at the draft's depth (never at full
    depth first).  With no draft given, the draft is the int8
    self-quantization of ``params``.  Returns ``(draft_params, d_cache)``."""
    if draft_params is None:
        draft_params = quantize_blocks(params)
    params_device(draft_params, device)
    shape = (len(draft_params["blocks"]), n_slots, cfg.max_seq, cfg.kv_heads, cfg.head_dim)
    return draft_params, decode.KVCache(
        *(torch.zeros(shape, dtype=cache_dtype, device=device) for _ in range(2))
    )


def _prefill_draft_row(draft_params, d_cache, prompt, plen, slot, *, cfg: ModelConfig):
    """Fill one slot's draft cache from the padded prompt ``[1, bucket]``
    (k/v only: the draft's logits are never read), positions ``>= plen``
    zeroed, so nothing of the slot's last request stays behind.  ``plen``
    and ``slot`` are 0-d tensors: one captured program serves every
    admission.  Returns ``d_cache``, updated in place."""
    n_draft, _, max_seq = d_cache.k.shape[:3]
    dev = prompt.device
    row = decode.KVCache(*(
        torch.zeros((n_draft, 1, max_seq, cfg.kv_heads, cfg.head_dim), dtype=d_cache.k.dtype,
                    device=dev)
        for _ in range(2)
    ))
    decode.decode_chunk(draft_params, row, prompt, 0, cfg=cfg, k_window=prompt.shape[1],
                        logits=False)
    keep = (torch.arange(max_seq, device=dev) < plen)[None, :, None, None]
    at = slot.view(1).long()
    for part, whole in ((row.k, d_cache.k), (row.v, d_cache.v)):
        whole.index_copy_(1, at, torch.where(keep, part[:, 0], 0)[:, None])
    return d_cache


def draft_propose(draft_params, d_cache, last, pos, active, *, cfg: ModelConfig, gamma: int):
    """Sequential draft proposals from each row's frontier (``last [B]`` at
    ``pos [B]``): ``gamma`` steps, then one more that feeds ``g_gamma`` so
    its draft key exists when full acceptance commits the bonus token (its
    logits are never read, so it stops after the last k/v write).  Returns
    ``(d_cache, proposed [B, gamma] int32)``."""
    tok, proposed = last, []
    for i in range(gamma):
        logits, _ = decode.decode_step(draft_params, d_cache, tok.long(), pos + i, cfg=cfg,
                                       active=active)
        tok = logits.argmax(dim=-1).to(torch.int32)
        proposed.append(tok)
    decode.decode_chunk(draft_params, d_cache, tok.long()[:, None], pos + gamma, cfg=cfg,
                        active=active, logits=False)
    return d_cache, torch.stack(proposed, dim=1)


def _spec_round(params, draft_params, cache, d_cache, last, pos, active, *,
                cfg: ModelConfig, gamma: int, adapters=None):
    """One speculative round for every active slot at its own position:
    the draft's proposals, then the target scores ``[last, g_1..g_gamma]``
    in one ``decode.decode_chunk`` (rejected positions go stale in place
    and are rewritten from the committed frontier before any query attends
    them).  ``adapters`` apply to the verify pass only: the draft stays the
    base model, whose proposals the target's argmax decides, so the streams
    are the adapted model's whatever the draft proposes.  An active row
    whose window reaches past ``max_seq`` (a short restored entry) drops
    the writes there, in both caches, as the reference's scatter does; its
    queries there give logits the budget clip never commits.  An inactive
    row may sit past the slack after its last round (the host clipped its
    commit): its writes are masked, and its position is clamped to
    ``max_seq - 1 - gamma``, so its window stays in the cache (an active
    row is never clamped).  Returns ``(target [B, gamma + 1] int32, advance
    [B] int32, cache, d_cache)``: a row commits its first ``advance``
    targets."""
    pos = torch.where(active, pos, pos.clamp(max=cfg.max_seq - 1 - gamma))
    d_cache, proposed = draft_propose(draft_params, d_cache, last, pos, active, cfg=cfg,
                                      gamma=gamma)
    window = torch.cat([last[:, None], proposed], dim=1)
    logits, cache = decode.decode_chunk(params, cache, window.long(), pos, cfg=cfg, active=active,
                                        adapters=adapters)
    target = logits.argmax(dim=-1).to(torch.int32)
    _, advance = accept_advance(proposed, target, active)
    return target, advance, cache, d_cache


def _spec_advance(target, advance, last, pos, active):
    """A round's tail in both engines' programs: each active row's last
    token becomes its last committed target and its position moves by
    ``advance`` (0 on inactive rows), in place.  Returns ``[B, gamma + 2]``
    int32, the targets and the advance side by side for ONE readback."""
    rows = torch.arange(target.shape[0], device=target.device)
    new_last = target[rows, (advance - 1).clamp_min(0)]
    last.copy_(torch.where(active, new_last, last))
    pos.add_(advance)
    return torch.cat([target, advance[:, None]], dim=1)


def _commit_spec_round(engine, readback, active) -> int:
    """Append each active resident slot's accepted tokens from a round's
    readback ``[n_slots, gamma + 2]``, clipped at eos and at the budget
    (the device state past the clip goes stale with the slot), count the
    proposals and acceptances, hand each slot's commit to the open burst
    of its telemetry and retire the finished slots.  Returns the tokens
    committed."""
    gamma = engine.spec_gamma
    committed = 0
    for slot, st in enumerate(engine._slots):
        if st is None or not active[slot]:
            continue
        advance = int(readback[slot, gamma + 1])
        engine.spec_drafted += gamma
        engine.spec_accepted += advance - 1
        before = len(st.tokens)
        for j in range(advance):
            st.tokens.append(int(readback[slot, j]))
            hit_eos = engine.eos_id is not None and st.tokens[-1] == engine.eos_id
            if len(st.tokens) - st.prompt_len >= _slot_budget(st) or hit_eos:
                break
        committed += len(st.tokens) - before
        engine.telemetry.on_commit(st.request_id, len(st.tokens) - before)
        engine._retire(slot)
    return committed


def check_adapter(engine, adapter: int) -> None:
    """The reference's submit checks of an adapter id against the engine's
    bank (both engines)."""
    if adapter and engine.adapter_bank is None:
        raise ValueError("adapter requested but the engine has no adapter_bank")
    if engine.adapter_bank is not None and not 0 <= adapter < engine._n_adapters:
        raise ValueError(f"adapter {adapter} out of range [0, {engine._n_adapters})")


def bank_row(engine, adapter: int) -> int:
    """The bank row a slot's adapter id reads on the device: the
    reference's gather normalizes a negative id (``id + rows``) and clamps
    into ``[0, rows - 1]``.  ``submit`` never passes such an id; a
    restored entry may, and serves with the clamped row while its
    request's state keeps the id as given, so snapshots carry it on.  On
    the card an out-of-range index is a device assert, not a clamp, so the
    clamp is written out here, where the id reaches the device."""
    rows = engine._n_adapters
    if adapter < 0:
        adapter += rows
    return min(max(adapter, 0), rows - 1)


def init_adapter_state(engine) -> None:
    """The engine's bank size and per-slot adapter ids (a device buffer,
    written in place; none without a bank, whose programs are those of an
    engine with no LoRA at all)."""
    bank = engine.adapter_bank
    engine._n_adapters = 0 if bank is None else lora.bank_size(bank)
    engine._adapter_ids = None
    if bank is not None:
        where = next(iter(bank["blocks"][0].values()))["a"].device
        if where.type != engine.device.type:
            raise ValueError(f"the adapter bank lives on {where}, not {engine.device}")
        engine._adapter_ids = torch.zeros((engine._spg,), dtype=torch.int32,
                                          device=engine.device)


# -- slot sharding over a mesh (both engines) ----------------------------------
#
# On a mesh every rank runs the same host scheduler on the same requests in
# lockstep (the reference's multi-controller serving) and holds the device
# state of its slot shard only: rows ``[index * spg, (index + 1) * spg)`` of
# every per-slot buffer and cache, ``spg = n_slots / shards``.  Programs run
# on those rows with no collective inside; what crosses ranks goes through
# the helpers below, called by every rank of the slot group in the same
# order (a collective that only some ranks reach would hang the others).

def slot_shards(engine) -> SlotGroup:
    """The engine's slot shards: one without a mesh; on a mesh
    ``parallel.mesh.slot_group`` over ``slot_axis`` (a TypeError for a mesh
    that is no ``DeviceMesh``, the reference's ValueError for an axis the
    mesh lacks), then the reference's ``n_slots`` check."""
    if engine.mesh is None:
        return SlotGroup(None, 0, 1, (0,))
    shards = slot_group(engine.mesh, engine.slot_axis)
    if engine.mesh.device_type != engine.device.type:
        raise ValueError(f"a {engine.mesh.device_type} mesh serves on "
                         f"{engine.mesh.device_type}, not on {engine.device}")
    if engine.n_slots % shards.count:
        raise ValueError(f"n_slots ({engine.n_slots}) must divide over "
                         f"{engine.slot_axis!r} axis size {shards.count}")
    return shards


def owned_row(engine, slot: int) -> int | None:
    """``slot``'s row in this rank's device state, or None where another
    shard holds it."""
    shard, row = divmod(slot, engine._spg)
    return row if shard == engine._shards.index else None


def local_slots(engine) -> slice:
    """The engine's global slots whose rows this rank holds."""
    lo = engine._shards.index * engine._spg
    return slice(lo, lo + engine._spg)


def gather_slots(engine, t: torch.Tensor, dim: int) -> np.ndarray:
    """A program's per-slot output (this rank's rows along ``dim``) as the
    whole engine's host array, gathered over the slot group with one
    device-to-host copy a rank: a burst's or a round's one readback."""
    shards = engine._shards
    return collectives.all_gather_to_host(t, shards.group, dim, shards.shards).numpy()


def from_owner(engine, shard: int, tensors: list) -> list:
    """``tensors`` from the ranks holding ``shard`` to every rank of the
    slot group, in place (elsewhere the caller passes empty tensors of the
    same shapes and dtypes)."""
    shards = engine._shards
    if shards.group is not None:
        for t in tensors:
            collectives.broadcast_raw(t, shards.src(shard), shards.group)
    return tensors


def owner_token(engine, slot: int, run) -> int:
    """An admission's first token: ``run()`` (the program, ``[1]`` int32)
    on the rank holding ``slot``, then one small broadcast to every
    controller, outside any graph (the reference's ``psum`` of it)."""
    if engine._shards.group is None:
        return int(run())
    if owned_row(engine, slot) is not None:
        tok = run().reshape(1).to(torch.int32)
    else:
        tok = torch.zeros((1,), dtype=torch.int32, device=engine.device)
    (tok,) = from_owner(engine, slot // engine._spg, [tok])
    return int(tok.item())


@dataclass
class ServeEngine:
    """Continuous batching over a dense KV cache.

    * ``submit`` prefills the whole prompt (padded to ``prompt_bucket``)
      into the first free slot in one forward and samples its first token;
      each request has its temperature (0 or below: greedy) and a seed for
      its base key (default its request id); ``top_k`` is the engine's;
    * with ``prefix_bucket`` set, the K/V of each distinct
      ``prompt[:prefix_bucket]`` is stored once (LRU over
      ``prefix_cache_entries``), and a later prompt that shares it and is
      longer computes only its suffix; the streams are those of the full
      prefill;
    * ``step_burst`` runs ``sync_interval`` device steps with ONE
      device-to-host readback (``host_syncs`` counts them; admissions'
      first-token reads are not counted); ``step`` is a burst of one,
      committing, retiring and quarantining in the order of the
      reference's ``step``;
    * ``cancel`` retires a request "cancelled"; a slot whose logits go
      non-finite retires "quarantined" (``fault_injector`` can poison one),
      and at ``quarantine_limit`` distinct requests the engine raises
      "engine poisoned";
    * ``snapshot_active`` captures every in-flight request as JSON, and
      ``restore`` rebuilds them in an idle engine (or, with ``merge``, in
      free slots of a live one) by re-prefilling each history, so every
      stream continues as it would have;
    * ``pump(queue_limit=...)`` sheds what overflows its queue;
    * with ``spec_gamma > 0`` every ``step`` (and ``step_burst``, which
      hands over to it) is one speculative round: the draft
      (``draft_params``, by default the int8 self-quantization of
      ``params``) proposes ``spec_gamma`` tokens for each slot over its own
      dense cache, the target verifies them in one pass, and each slot
      commits up to ``spec_gamma + 1`` tokens with one readback; the
      streams are the greedy ones (submits take temperature 0 only, with
      the verify window's slack under ``max_seq``);
    * with ``adapter_bank`` (``lora.stack_adapters``), ``submit(adapter=k)``
      serves the request with the bank's adapter k inside the shared
      programs (0, the identity row, adds exact zeros): the slots' ids live
      in a device buffer, the prefix store keys by ``(adapter, prefix)``,
      snapshots and restore carry the id, and speculation applies it on
      the verify pass (the draft stays the base model);
    * ``telemetry`` (``models/telemetry.EngineTelemetry``, off with
      ``telemetry_enabled=False``) records each request's timeline at the
      host points above, outside the programs, with no added readback;
      ``stats()`` returns its ``EngineStats``;
    * ``submit(handoff=True)`` retires the request at its first token into
      :meth:`take_handoffs` with its prompt's K/V as a :class:`KVSlice`
      (the disaggregated prefill side), ``snapshot_active(include_kv=True)``
      attaches every entry's, and ``restore`` writes a fitting payload into
      the slot's rows instead of re-prefilling (the decode side);
    * the fleet prefix tier's surface: ``on_prefix_store`` /
      ``on_prefix_evict`` hooks, ``prefix_geometry``,
      ``local_prefix_depth``, ``export_prefix_kv`` and ``inject_prefix_kv``.

    Runs on ``device`` (default the card; raises without one unless
    ``device="cpu"``); ``params`` must live there.  On the card each of the
    reference's compiled programs (admission, prefix-hit admission, the
    burst at ``sync_interval`` and at 1; with ``spec_gamma`` the "spec
    round" and the "draft prefill" in the bursts' place) runs as a CUDA
    graph (``GraphedProgram``; at most four an engine, in ``graphs``),
    eagerly inside ``disable_graphs()``; on the CPU it runs eagerly.  The
    device state those programs read and write (the cache and the draft
    cache; per slot the active mask, last token, position, stop depth,
    temperature, base key, poison mask and adapter id; the admission's
    padded prompt, length and slot, temperature and key, and the prefix-hit
    staging K/V) keeps one address for the engine's life and is written in
    place, an injected payload too.  Not thread-safe; drive it from one
    loop.

    On a mesh (``mesh`` a ``parallel/mesh`` ``DeviceMesh``, ``slot_axis``
    one of its axes or a tuple of them, flattened slice-major) the engine
    is the reference's data-parallel server, one process a rank: each of
    the ``slot_axis`` shards holds ``n_slots / shards`` rows of the cache,
    of every per-slot buffer and of the draft cache, the weights whole.
    Every rank runs the same scheduler on the same requests in the same
    order; a rank runs the programs of its own slots only.  The burst and
    the speculative round hold no collective, so they capture as graphs on
    every rank; the one collective of a burst is its readback, the trace
    gathered over the slot group with one host copy (``host_syncs`` one a
    burst).  An admission runs on the rank holding its slot and its first
    token reaches every controller by one broadcast; a stored prefix is
    broadcast from there too, so the prefix store stays whole on every
    rank and a hit admits on any shard; handoff and snapshot payloads come
    from the slot's rank the same way.  Temperatures and keys are mirrored
    on the host.  Ranks that differ only on other mesh axes hold the same
    slots and compute them alike.
    """

    params: dict
    cfg: ModelConfig
    n_slots: int = 8
    prompt_bucket: int = 64
    cache_dtype: torch.dtype = torch.float32
    eos_id: int | None = None
    top_k: int = 0           # 0 = no top-k mask; static, one program set
    sync_interval: int = 1
    prefix_bucket: int | None = None
    prefix_cache_entries: int = 8
    fault_injector: object | None = None  # utils/faults.FaultInjector
    quarantine_limit: int = 3  # distinct quarantined requests before "poisoned"
    # data-parallel serving: slots sharded over slot_axis of this
    # parallel/mesh DeviceMesh (see the class docstring)
    mesh: object | None = None
    slot_axis: object = "data"
    spec_gamma: int = 0      # > 0: speculative rounds of this many draft tokens
    draft_params: object = None  # the draft; None: the int8 self-draft
    adapter_bank: dict | None = None
    telemetry_enabled: bool = True
    device: object = "cuda"

    def __post_init__(self):
        cfg = self.cfg
        if self.prompt_bucket > cfg.max_seq:
            raise ValueError(
                f"prompt_bucket ({self.prompt_bucket}) exceeds max_seq ({cfg.max_seq})"
            )
        if not 0 <= self.top_k <= cfg.vocab_size:
            raise ValueError(
                f"top_k ({self.top_k}) must be in [0, vocab_size={cfg.vocab_size}]"
            )
        if self.sync_interval < 1:
            raise ValueError(f"sync_interval must be >= 1, got {self.sync_interval}")
        if self.quarantine_limit < 1:
            raise ValueError(f"quarantine_limit must be >= 1, got {self.quarantine_limit}")
        if self.prefix_bucket is not None:
            if not 0 < self.prefix_bucket < self.prompt_bucket:
                raise ValueError(
                    f"prefix_bucket ({self.prefix_bucket}) must be in "
                    f"(0, prompt_bucket={self.prompt_bucket})"
                )
            if self.prefix_cache_entries < 1:
                raise ValueError("prefix_cache_entries must be >= 1")
        self.device = dev = params_device(self.params, self.device)
        self._shards = slot_shards(self)
        self._spg = spg = self.n_slots // self._shards.count  # this rank's rows
        self._slots: list = [None] * self.n_slots
        self._next_id = 0
        self._step_no = 0        # the fault window's step number
        self._last_step_s = 0.0  # wall time of the last step or burst
        self._completions: list = []
        self.host_syncs = 0      # decode-loop readbacks (admissions excluded)
        self.quarantined: list[int] = []  # quarantined request ids
        self.shed_count = 0
        self.last_shed: ShedError | None = None
        self.pump_stats: dict = {}
        self._prefix_store: OrderedDict = OrderedDict()
        self.prefix_hits = 0
        self.prefix_misses = 0
        # the fleet prefix tier's hooks (the reference's fleet_prefix binds
        # them): on_prefix_store(tokens, n_tokens, adapter) after an entry
        # lands in the store, on_prefix_evict(tokens, adapter) after an LRU drop
        self.on_prefix_store = None
        self.on_prefix_evict = None
        self._handoffs: list[dict] = []  # first-token retirements with their payloads
        # port-only, outside EngineStats (whose fields are the reference's)
        self.spec_drafted = 0    # draft tokens proposed to active slots
        self.spec_accepted = 0   # of those, the ones the target agreed with
        self.telemetry = EngineTelemetry(self, enabled=self.telemetry_enabled)
        self._cache = decode.init_cache(cfg, spg, cfg.max_seq, dtype=self.cache_dtype, device=dev)
        self._d_cache = None
        if self.spec_gamma > 0:
            self.draft_params, self._d_cache = make_draft_state(
                self.params, self.draft_params, cfg, spg, self.cache_dtype, dev
            )
        # the programs' device state: one address each for the engine's life
        i32 = dict(dtype=torch.int32, device=dev)
        self._active = torch.zeros((spg,), dtype=torch.bool, device=dev)
        self._last, self._pos, self._stop_pos = (torch.zeros((spg,), **i32) for _ in range(3))
        self._temps = torch.zeros((spg,), dtype=torch.float32, device=dev)
        self._keys = torch.zeros((spg, 2), dtype=torch.int64, device=dev)
        # every slot's temperature and base key, as the device rows hold them
        self._temps_np = np.zeros((self.n_slots,), np.float32)
        self._keys_np = np.zeros((self.n_slots, 2), np.int64)
        self._poison = torch.zeros((spg,), dtype=torch.bool, device=dev)
        self._poison_np = np.zeros((self.n_slots,), bool)  # every slot's; _poison holds ours
        self._prompt = torch.zeros((1, self.prompt_bucket), **i32)   # padded
        self._admit = torch.zeros((2,), **i32)                       # (plen, slot)
        self._admit_temp = torch.zeros((), dtype=torch.float32, device=dev)
        self._admit_key = torch.zeros((2,), dtype=torch.int64, device=dev)
        if self.prefix_bucket is not None:  # a hit's stored prefix, staged
            shape = (cfg.n_layers, self.prefix_bucket, cfg.kv_heads, cfg.head_dim)
            self._prefix_k, self._prefix_v = (
                torch.zeros(shape, dtype=self.cache_dtype, device=dev) for _ in range(2)
            )
        init_adapter_state(self)
        self._eos = -1 if self.eos_id is None else self.eos_id
        self._programs: dict[str, GraphedProgram] = {}

    # -- public API --------------------------------------------------------
    def free_slots(self) -> int:
        return sum(1 for s in self._slots if s is None)

    def submit(self, prompt: list[int], max_tokens: int, temperature: float = 0.0,
               seed: int | None = None, adapter: int = 0, deadline: int | None = None,
               queued_at: float | None = None, handoff: bool = False) -> int:
        """Prefill ``prompt`` into a free slot and sample its first token;
        raises ``NoCapacity`` (a RuntimeError) when no slot is free.
        ``temperature`` above 0 samples under the base key
        ``PRNGKey(seed)`` (default the request id); ``deadline`` caps the
        generated tokens and types the completion "deadline_exceeded" when
        it binds first.  ``adapter`` is the bank row to serve it with (0: the
        base).  ``queued_at`` (the telemetry clock) is when the request
        entered an upstream queue; default now.  With ``handoff`` the
        request retires at its first token without a completion: its
        snapshot entry and KV payload go to :meth:`take_handoffs`, for a
        decode engine to ``restore``.  Returns the request id."""
        t_sub = self.telemetry.now()
        check_submit(prompt, max_tokens, self.prompt_bucket, self.cfg.max_seq,
                     spec_gamma=self.spec_gamma, temperature=temperature, deadline=deadline)
        check_adapter(self, adapter)
        try:
            slot = self._slots.index(None)
        except ValueError:
            raise NoCapacity("no free slot") from None
        request_id = self._next_id
        base_key = prng.prng_key(request_id if seed is None else seed)
        row = owned_row(self, slot)  # None: another rank runs the admission
        self._stage_admission(prompt, slot, temperature, base_key, adapter)
        prefix_key = self._dense_prefix_key(prompt, adapter)
        if prefix_key is not None and prefix_key in self._prefix_store:
            self._prefix_store.move_to_end(prefix_key)  # LRU touch
            self.prefix_hits += 1
            _M_PREFIX.inc(outcome="hit")

            def admit():
                pk, pv = self._prefix_store[prefix_key]
                self._prefix_k.copy_(pk)
                self._prefix_v.copy_(pv)
                return self._run("prefix admission", self._prefix_admission)

            first_tok = owner_token(self, slot, admit)
        else:
            first_tok = owner_token(self, slot, lambda: self._run("admission", self._admission))
            if prefix_key is not None:
                self.prefix_misses += 1
                _M_PREFIX.inc(outcome="miss")
                # a copy: a view would change when the slot's next request
                # overwrites the row; on every rank, so each holds the store
                self._prefix_store[prefix_key] = tuple(self._rows_of(slot, row,
                                                                     self.prefix_bucket))
                if self.on_prefix_store is not None:
                    self.on_prefix_store(tuple(prompt[: self.prefix_bucket]), self.prefix_bucket,
                                         adapter)
                self._trim_prefix_store()
        self._prefill_draft(slot)
        self._next_id += 1
        st = _Slot(request_id, list(prompt) + [int(first_tok)], len(prompt), max_tokens,
                   deadline, adapter)
        self._slots[slot] = st
        self._set_row(slot, st, temperature, base_key)
        _M_REQUESTS.inc()
        _M_TOKENS.inc()  # the admission's first generated token
        JOURNAL.record(
            "serve", "request.submit", correlation=f"req-{request_id}",
            slot=slot, prompt_len=len(prompt), max_tokens=max_tokens,
        )
        # activation is the first token here (read back above)
        self.telemetry.on_admit(
            request_id, prompt_len=len(prompt), max_tokens=max_tokens, deadline=deadline,
            adapter=adapter, submitted_at=t_sub, queued_at=queued_at,
        )
        if handoff:
            self._handoff_retire(slot, temperature, base_key, adapter)
            return request_id
        self._retire(slot)  # max_tokens=1 or eos on the first token
        self._update_gauges()
        return request_id

    def take_handoffs(self) -> list[dict]:
        """Drain the handoff queue: the snapshot entries, each with its KV
        payload under ``"kv"``, of the requests submitted with
        ``handoff=True`` that retired here at their first token."""
        out, self._handoffs = self._handoffs, []
        return out

    def cancel(self, request_id: int) -> bool:
        """Retire a resident request "cancelled" with its tokens so far
        (between steps).  Returns whether the id was resident."""
        for slot, st in enumerate(self._slots):
            if st is not None and st.request_id == request_id:
                _early_retire(self, slot, "cancelled", "cancelled by caller")
                return True
        return False

    def step(self) -> int:
        """Advance every resident slot one token (a burst of one step);
        returns the number of resident slots stepped (or quarantined by
        the fault window)."""
        return self._step(1)

    def step_burst(self) -> int:
        """Advance every resident slot up to ``sync_interval`` tokens with
        ONE device-to-host readback; the host then replays the burst in
        step order, committing a token exactly where the one-step loop
        would.  Returns the number of resident slots at the burst's start
        (or quarantined by the fault window)."""
        return self._step(self.sync_interval)

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self.step_burst() == 0:
                return
        raise _wedge_error(self, "serving loop did not drain")

    def pump(self, requests, max_steps: int = 100_000, queue_limit: int | None = None) -> list:
        """Admit ``requests`` (``(prompt, max_tokens)`` pairs or dicts of
        ``submit`` kwargs) FIFO as slots free, burst-stepping in between;
        ``queue_limit`` sheds what overflows the waiting queue.  Returns
        the completions (see :func:`_pump`)."""
        return _pump(self, requests, max_steps, queue_limit)

    def completions(self) -> list:
        out, self._completions = self._completions, []
        return out

    def stats(self):
        """The engine's ``telemetry.EngineStats``: queue depth, resident and
        free slots, rolling TTFT/TPOT quantiles, statuses, bursts, host
        syncs; host values only."""
        return self.telemetry.stats()

    def snapshot_active(self, include_kv: bool = False) -> dict:
        """Every in-flight request as a JSON-serialisable document (token
        history, temperature and base key, adapter id, deadline, telemetry
        trace); the sampler state from the host's mirror, no decode step.
        A fresh engine continues every stream from it with :meth:`restore`.
        ``include_kv`` adds each entry's cache rows as a :class:`KVSlice`
        under ``"kv"`` (one counted host sync each), so ``restore`` injects
        them instead of re-prefilling; such a snapshot is not JSON."""
        temps, keys = self._temps_np, self._keys_np
        reqs = []
        for i, st in enumerate(self._slots):
            if st is None:
                continue
            req = _snapshot_request(st, float(temps[i]), keys[i], st.adapter,
                                    trace=self.telemetry.export_trace(st.request_id))
            if include_kv and len(st.tokens) > 1:
                req["kv"] = self._capture_kv(i, len(st.tokens) - 1)
            reqs.append(req)
        return {"engine": type(self).__name__, "next_id": self._next_id, "requests": reqs}

    def restore(self, snapshot: dict, merge: bool = False) -> list[int]:
        """Rebuild a snapshot's requests in this engine: each history
        re-prefills through the admission program under the entry's
        temperature and key (bypassing the prefix store), its sampled
        token is discarded, or, when the entry's ``"kv"`` payload fits this
        cache (``_kv_geometry_ok``), the payload is written into the slot's
        rows in place instead (a payload that does not fit counts
        ``tpu_disagg_fallback_total{reason="incompatible"}`` and
        re-prefills; ``"kv": None`` re-prefills); the frontier re-arms at ``_last =
        tokens[-1]``, ``_pos = len(tokens) - 1``, so the next step samples
        what the old engine would have.  Needs an idle engine unless
        ``merge``, which fills free slots of a live one.  An entry longer
        than the prompt bucket, or one that finds no free slot, comes back
        as an "error" completion.  An adapter id outside the engine's bank
        serves with the row the reference's gather reads (:func:`bank_row`),
        and a bank-less engine serves any adapter with the base; either way
        the entry keeps its id.
        Each entry's trace is rebuilt first, so its request keeps one
        timeline.  Returns the restored ids."""
        check_restorable(snapshot)
        if not merge and self.n_slots - self.free_slots():
            raise RuntimeError("restore() needs an idle engine")
        restored: list[int] = []
        for req in sorted(snapshot["requests"], key=lambda r: r["request_id"]):
            self.telemetry.import_trace(int(req["request_id"]), req.get("trace"))
            tokens = [int(t) for t in req["tokens"]]
            if len(tokens) > self.prompt_bucket:
                _unrestorable(self, req, f"history {len(tokens)} exceeds prompt_bucket "
                                         f"{self.prompt_bucket}")
                continue
            try:
                slot = self._slots.index(None)
            except ValueError:
                _unrestorable(self, req, f"no free slot in {self.n_slots}")
                continue
            temp = float(req["temperature"])
            # keys arrive as plain ints up to 2^32 - 1: int64 holds them
            key = torch.tensor([int(x) for x in req["key"]], dtype=torch.int64)
            adapter = int(req.get("adapter", 0))
            self._stage_admission(tokens, slot, temp, key, adapter)
            kv = req.get("kv")
            row = owned_row(self, slot)
            if kv is not None and _kv_geometry_ok(self, kv, len(tokens)):
                # the payload's rows in place; the frontier's stay stale, as
                # after a re-prefill: the next step rewrites them first
                for whole, part in ((self._cache.k, kv.k), (self._cache.v, kv.v)):
                    if row is not None:
                        whole[:, row, : kv.valid_len].copy_(device_tensor(part, kv.dtype,
                                                                          self.device))
            else:
                if kv is not None:
                    _M_DISAGG_FALLBACK.inc(reason="incompatible")
                if row is not None:
                    self._run("admission", self._admission)  # its token is not read
            self._prefill_draft(slot)  # the draft cache never travels
            st = _Slot(int(req["request_id"]), tokens, int(req["prompt_len"]),
                       int(req["max_tokens"]), req.get("deadline"), adapter)
            self._slots[slot] = st
            self._set_row(slot, st, temp, key)
            restored.append(st.request_id)
            JOURNAL.record("serve", "request.restore", correlation=f"req-{st.request_id}",
                           slot=slot, resumed_at=len(tokens))
            self.telemetry.on_restore(st.request_id, resumed_at=len(tokens))
            self._retire(slot)  # the history may already sit at its budget
        self._next_id = max(
            self._next_id,
            int(snapshot.get("next_id", 0)),
            max((int(r["request_id"]) for r in snapshot["requests"]), default=-1) + 1,
        )
        self._update_gauges()
        return restored

    def release_active(self) -> int:
        """Free every resident slot WITHOUT delivering completions (its
        streams were captured by ``snapshot_active`` and live elsewhere
        now; their traces are dropped, not retired).  Returns how many were
        released."""
        released = 0
        for slot, st in enumerate(self._slots):
            if st is not None:
                self._slots[slot] = None
                self._release_slot(slot)
                self.telemetry.drop_trace(st.request_id)
                JOURNAL.record("serve", "request.released", correlation=f"req-{st.request_id}",
                               slot=slot, generated=len(st.tokens) - st.prompt_len)
                released += 1
        self._update_gauges()
        return released

    # -- the fleet prefix tier's surface (the reference's fleet_prefix) -----
    def _trim_prefix_store(self) -> None:
        while len(self._prefix_store) > self.prefix_cache_entries:
            old_key, _ = self._prefix_store.popitem(last=False)
            if self.on_prefix_evict is not None:
                adapter, tokens = split_prefix_key(self, old_key)
                self.on_prefix_evict(tokens, adapter)

    def prefix_geometry(self) -> dict:
        """The payload geometry a pulled prefix must have to inject here:
        one "block" of ``prefix_bucket`` tokens per store entry."""
        return {
            "block_size": 0 if self.prefix_bucket is None else self.prefix_bucket,
            "kv_dtype": dtype_label(self.cache_dtype),
            "n_layers": self.cfg.n_layers,
            "kv_heads": self.cfg.kv_heads,
            "head_dim": self.cfg.head_dim,
        }

    def _dense_prefix_key(self, prompt, adapter: int):
        """The store's key of ``prompt``: its first ``prefix_bucket``
        tokens, with a bank ``(adapter, tokens)`` (adapted K/V belong to
        their adapter); None for a prompt no longer than the bucket."""
        if self.prefix_bucket is None or len(prompt) <= self.prefix_bucket:
            return None
        key = tuple(int(t) for t in prompt[: self.prefix_bucket])
        return (adapter, key) if self.adapter_bank is not None else key

    def local_prefix_depth(self, prompt, adapter: int = 0) -> int:
        """Tokens of ``prompt`` the store holds (``prefix_bucket`` or 0)."""
        key = self._dense_prefix_key(prompt, adapter)
        return 0 if key is None or key not in self._prefix_store else self.prefix_bucket

    def export_prefix_kv(self, prompt, max_tokens=None, adapter: int = 0):
        """The stored prefix of ``prompt`` as a :class:`KVSlice` (an LRU
        touch and one counted host sync), or None."""
        del max_tokens  # advisory; the bucket sets the depth
        key = self._dense_prefix_key(prompt, adapter)
        if key is None or key not in self._prefix_store:
            return None
        self._prefix_store.move_to_end(key)
        pk, pv = self._prefix_store[key]
        k, v = host_array(pk), host_array(pv)
        self.host_syncs += 1
        _M_HOST_SYNCS.inc()
        cfg = self.cfg
        return KVSlice(k=k, v=v, valid_len=self.prefix_bucket, n_layers=cfg.n_layers,
                       kv_heads=cfg.kv_heads, head_dim=cfg.head_dim,
                       dtype=dtype_label(self.cache_dtype))

    def inject_prefix_kv(self, prompt, kv, adapter: int = 0) -> int:
        """Store a pulled float prefix payload (its first ``prefix_bucket``
        positions) as this prompt's entry, so the next ``submit`` of it
        takes the prefix-hit admission.  Returns the tokens installed; 0
        (a cold prefill) for a payload of another geometry or dtype, a
        short one, or a prefix already stored."""
        key = self._dense_prefix_key(prompt, adapter)
        if key is None or not is_kv_payload(kv) or kv.block_size > 0:
            return 0
        cfg = self.cfg
        if (kv.n_layers, kv.kv_heads, kv.head_dim) != (cfg.n_layers, cfg.kv_heads, cfg.head_dim):
            return 0
        if kv.dtype != dtype_label(self.cache_dtype) or kv.valid_len < self.prefix_bucket:
            return 0
        if key in self._prefix_store:
            self._prefix_store.move_to_end(key)
            return 0
        self._prefix_store[key] = tuple(
            device_tensor(np.asarray(part)[:, : self.prefix_bucket], kv.dtype, self.device)
            for part in (kv.k, kv.v))
        if self.on_prefix_store is not None:
            self.on_prefix_store(tuple(int(t) for t in prompt[: self.prefix_bucket]),
                                 self.prefix_bucket, adapter)
        self._trim_prefix_store()
        return self.prefix_bucket

    # -- internals ---------------------------------------------------------
    def _rows_of(self, slot: int, row, length: int) -> list:
        """The slot's cache rows at positions ``< length``, ``[L, length,
        Hkv, hd]`` each (copies), from the rank holding ``slot`` (``row``
        there, None elsewhere) on every controller: a prefix store entry,
        or a payload's planes."""
        cfg = self.cfg
        if row is None:
            parts = [torch.empty((cfg.n_layers, length, cfg.kv_heads, cfg.head_dim),
                                 dtype=self._cache.k.dtype, device=self.device)
                     for _ in range(2)]
        else:
            parts = [x[:, row, :length].clone(memory_format=torch.contiguous_format)
                     for x in (self._cache.k, self._cache.v)]
        return from_owner(self, slot // self._spg, parts)

    def _capture_kv(self, slot: int, valid_len: int) -> KVSlice:
        """A host copy of the slot's cache rows ``[L, valid_len, Hkv, hd]``,
        one copy per tensor and one counted host sync (the transfer's cost
        shows in ``host_syncs``)."""
        k, v = (host_array(x) for x in self._rows_of(slot, owned_row(self, slot), valid_len))
        self.host_syncs += 1
        _M_HOST_SYNCS.inc()
        cfg = self.cfg
        return KVSlice(k=k, v=v, valid_len=valid_len, n_layers=cfg.n_layers,
                       kv_heads=cfg.kv_heads, head_dim=cfg.head_dim,
                       dtype=dtype_label(self.cache_dtype))

    def _handoff_retire(self, slot: int, temperature: float, key, adapter: int) -> None:
        """The first-token retirement of a handoff: the request's snapshot
        entry with its prompt's K/V, the slot freed without a completion,
        its trace exported into the entry and dropped here (the decode
        engine imports it), the entry queued for :meth:`take_handoffs`."""
        st = self._slots[slot]
        entry = _snapshot_request(st, temperature, key, adapter,
                                  trace=self.telemetry.export_trace(st.request_id))
        entry["kv"] = self._capture_kv(slot, st.prompt_len)
        self._slots[slot] = None
        self._release_slot(slot)
        self.telemetry.drop_trace(st.request_id)
        self._handoffs.append(entry)
        JOURNAL.record("serve", "request.handoff", correlation=f"req-{st.request_id}",
                       slot=slot, kv_bytes=entry["kv"].nbytes)
        self._update_gauges()

    def _step(self, k: int) -> int:
        """Open the fault window and run a K-step burst over the resident
        slots (``step`` asks for K = 1)."""
        if self.free_slots() == self.n_slots:
            return 0
        if self.spec_gamma > 0:
            return self._spec_step()
        self._step_no += 1
        poison, quarantined = _inject_step_faults(self)
        n_active = self.n_slots - self.free_slots()
        if n_active == 0:
            return quarantined  # quarantining is progress
        t0 = time.perf_counter()
        self.telemetry.burst_begin(k, self._step_no)  # on the host, before the replay
        if (poison != self._poison_np).any():
            self._poison.copy_(torch.from_numpy(poison[local_slots(self)]))
            self._poison_np = poison
        trace = self._run(f"burst k={k}", self._burst_program(k))
        # the burst's one readback: [3, K, slots], gathered over the shards
        trace_t, trace_a, trace_b = gather_slots(self, trace, 2)
        self.host_syncs += 1
        _M_HOST_SYNCS.inc()
        trace_a = trace_a.astype(bool)
        first_bad = _first_bad_steps(trace_a, trace_b.astype(bool))
        committed = 0
        for j in range(k):
            for slot, st in enumerate(self._slots):
                if st is None or not trace_a[j][slot]:
                    continue
                if k == 1 and slot in first_bad:  # the reference's step(): in slot order
                    _quarantine_slot(self, slot, "nan_logits",
                                     "non-finite logits in decode step")
                elif j < first_bad.get(slot, k):
                    st.tokens.append(int(trace_t[j][slot]))
                    self.telemetry.on_commit(st.request_id)
                    committed += 1
                    self._retire(slot)
        self.telemetry.burst_end(n_active)
        for slot in sorted(first_bad):
            if self._slots[slot] is not None:
                _quarantine_slot(self, slot, "nan_logits",
                                 f"non-finite logits at burst step {first_bad[slot]}")
        _M_TOKENS.inc(committed)
        self._update_gauges()
        self._last_step_s = time.perf_counter() - t0
        _M_STEP_LATENCY.observe(self._last_step_s)
        return n_active

    def _spec_step(self) -> int:
        """One speculative round for every resident slot (the reference's
        round runs no fault window): up to ``spec_gamma + 1`` tokens commit
        per slot, with one readback."""
        t0 = time.perf_counter()
        n_active = self.n_slots - self.free_slots()
        self.telemetry.burst_begin(self.spec_gamma + 1, self._step_no)
        readback = gather_slots(self, self._run("spec round", self._spec_program), 0)
        self.host_syncs += 1
        _M_HOST_SYNCS.inc()
        committed = _commit_spec_round(self, readback, [st is not None for st in self._slots])
        self.telemetry.burst_end(n_active)
        _M_TOKENS.inc(committed)
        self._update_gauges()
        self._last_step_s = time.perf_counter() - t0
        return n_active

    def _prefill_draft(self, slot: int) -> None:
        """With speculation on, fill the staged admission's draft row (its
        whole padded prompt, a prefix hit's too), on the rank holding
        ``slot``."""
        if self.spec_gamma > 0 and owned_row(self, slot) is not None:
            self._run("draft prefill", self._draft_prefill)

    def _stage_admission(self, tokens: list[int], slot: int, temperature: float, key,
                         adapter: int = 0) -> None:
        """Write an admission's inputs into the admission buffers, and with
        a bank the slot's adapter id (before the prefill: the first-token
        step runs under it), on the rank holding ``slot`` (the others run
        none of its programs)."""
        row = owned_row(self, slot)
        if row is None:
            return
        padded = np.zeros((1, self.prompt_bucket), np.int32)
        padded[0, : len(tokens)] = tokens
        self._prompt.copy_(torch.from_numpy(padded))
        self._admit.copy_(torch.tensor([len(tokens), row], dtype=torch.int32))
        self._admit_temp.fill_(temperature)
        self._admit_key.copy_(key)
        if self._adapter_ids is not None:
            self._adapter_ids[row] = bank_row(self, adapter)

    def _set_row(self, slot: int, st, temperature: float, key) -> None:
        """A resident slot's device row (on the rank holding it): active,
        last token, position (``len(tokens) - 1``), stop depth (from the
        original prompt length and budget), temperature and base key; the
        last two mirrored on the host on every rank."""
        self._temps_np[slot] = temperature
        self._keys_np[slot] = torch.as_tensor(key).cpu().numpy()
        row = owned_row(self, slot)
        if row is None:
            return
        self._active[row] = True
        self._last[row] = st.tokens[-1]
        self._pos[row] = len(st.tokens) - 1
        self._stop_pos[row] = st.prompt_len + _slot_budget(st) - 1
        self._temps[row] = temperature
        self._keys[row] = key

    def _release_slot(self, slot: int) -> None:
        """A freed slot's row stops stepping; its stale K/V are masked out
        until an admission rewrites them."""
        row = owned_row(self, slot)
        if row is not None:
            self._active[row] = False

    def _update_gauges(self) -> None:
        """The slot occupancy gauge."""
        _M_OCCUPANCY.set(self.n_slots - self.free_slots())

    def _retire(self, slot: int) -> None:
        done = completion_if_done(self._slots[slot], self.eos_id, self.cfg.max_seq)
        if done is not None:
            self._completions.append(done)
            self._slots[slot] = None
            self._release_slot(slot)
            JOURNAL.record("serve", "request.complete", correlation=f"req-{done.request_id}",
                           slot=slot, generated=len(done.generated))
            self.telemetry.on_retire(done.request_id, done.status, len(done.generated))
            self._update_gauges()

    # -- the programs (the reference's compiled ones) ------------------------
    @property
    def graphs(self) -> dict:
        """The engine's CUDA graphs by program name (none on the CPU or
        under ``disable_graphs()``)."""
        return dict(self._programs)

    def _run(self, name: str, fn):
        return run_program(self, name, fn)

    def _adapters(self):
        """The programs' adapter context ``(bank, per-slot ids)``, or None
        without a bank (the programs of an engine with no LoRA at all)."""
        return None if self.adapter_bank is None else (self.adapter_bank, self._adapter_ids)

    def _admission(self):
        tok, _ = _prefill_into_slot(
            self.params, self._cache, self._prompt, self._admit[0], self._admit[1],
            self._admit_temp, self._admit_key, cfg=self.cfg, top_k=self.top_k,
            adapters=self._adapters(),
        )
        return tok

    def _prefix_admission(self):
        tok, _ = _prefill_suffix_into_slot(
            self.params, self._cache, self._prefix_k, self._prefix_v, self._prompt,
            self._admit[0], self._admit[1], self._admit_temp, self._admit_key, cfg=self.cfg,
            top_k=self.top_k, prefix_bucket=self.prefix_bucket, adapters=self._adapters(),
        )
        return tok

    def _draft_prefill(self) -> None:
        _prefill_draft_row(self.draft_params, self._d_cache, self._prompt, self._admit[0],
                           self._admit[1], cfg=self.cfg)

    def _spec_program(self):
        target, advance, _, _ = _spec_round(
            self.params, self.draft_params, self._cache, self._d_cache, self._last, self._pos,
            self._active, cfg=self.cfg, gamma=self.spec_gamma, adapters=self._adapters(),
        )
        return _spec_advance(target, advance, self._last, self._pos, self._active)

    def _burst_program(self, k: int):
        def burst():
            trace, _, last, pos, _ = _pipelined_burst(
                self.params, self._cache, self._last, self._pos, self._active, self._temps,
                self._keys, self._stop_pos, self._poison, cfg=self.cfg, top_k=self.top_k,
                eos_id=self._eos, k=k, adapters=self._adapters(),
            )
            self._last.copy_(last)
            self._pos.copy_(pos)
            return trace
        return burst
