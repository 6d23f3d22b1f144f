"""The KVSlice wire frame in the PyTorch port (``models/serve.KVSlice``,
``WireFormatError``) against the JAX package's, on the CPU.

* The port's ``to_wire`` gives the reference's bytes for the same payload
  (float32, bfloat16, float16, int8, int4, and a float32 payload past one
  chunk), with the same ``checksum`` and ``nbytes``; the port carries bf16
  as uint16 words, the reference as ``ml_dtypes`` bfloat16.
* Each package's ``from_wire`` decodes the other's frames to the same
  bytes and fields.
* Every malformation of ``tests/test_disagg.py``'s wire suite (a cut at
  every offset and a flipped bit at every offset, by frame region, for a
  float and an int4 frame; a bad magic, a bad version, trailing bytes, a
  quantized geometry that does not add up, an odd int4 ``head_dim``, and
  the other checks) raises the port's ``WireFormatError`` with the
  reference's message and request id."""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from k8s_dra_driver_torch.models import serve as ts
from k8s_dra_driver_tpu.models import serve as js

RID = 42
HEADER = "!BQIIIIII"  # version, rid, layers, valid_len, kv heads, head_dim, block size, crc
HEADER_SIZE = struct.calcsize(HEADER)


def _float_pair(label: str, shape=(2, 5, 2, 8), seed=1):
    """A float payload as each package holds it: the reference's arrays in
    their numpy dtype (bf16 through ``ml_dtypes``), the port's bf16 as its
    raw uint16 words."""
    r = np.random.RandomState(seed)
    planes = [r.standard_normal(shape).astype(np.float32) for _ in range(2)]
    want = [p.astype(jnp.bfloat16 if label == "bfloat16" else label) for p in planes]
    got = [p.view(np.uint16) if label == "bfloat16" else p for p in want]
    geom = dict(valid_len=shape[1], n_layers=shape[0], kv_heads=shape[2], head_dim=shape[3],
                dtype=label)
    return (js.KVSlice(k=want[0], v=want[1], **geom), ts.KVSlice(k=got[0], v=got[1], **geom))


def _quant_pair(label: str, seed=5, head_dim=16):
    """A quantized payload with the engines' padded geometry: 2 blocks of
    4, 6 valid positions (the reference suite's ``_quant_kv``)."""
    n_layers, hkv, bs, nb = 1, 2, 4, 2
    r = np.random.RandomState(seed)
    if label == "int8":
        k, v = (r.randint(-127, 128, (n_layers, nb * bs, hkv, head_dim)).astype(np.int8)
                for _ in range(2))
    else:
        k, v = (r.randint(0, 256, (n_layers, nb * bs, hkv, head_dim // 2)).astype(np.uint8)
                for _ in range(2))
    ks, vs = (r.rand(n_layers, nb, hkv).astype(np.float32) for _ in range(2))
    geom = dict(k=k, v=v, valid_len=6, n_layers=n_layers, kv_heads=hkv, head_dim=head_dim,
                dtype=label, k_scale=ks, v_scale=vs, block_size=bs)
    return js.KVSlice(**geom), ts.KVSlice(**geom)


PAYLOADS = {
    "float32": lambda: _float_pair("float32"),
    "bfloat16": lambda: _float_pair("bfloat16"),
    "float16": lambda: _float_pair("float16"),
    "int8": lambda: _quant_pair("int8"),
    "int4": lambda: _quant_pair("int4"),
    # 2 x 40 x 8 x 128 f32 = 320 KiB a plane: the payload spans three chunks
    "float32 chunked": lambda: _float_pair("float32", shape=(2, 40, 8, 128)),
}


def _bits(a) -> bytes:
    return np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("kind", sorted(PAYLOADS))
def test_to_wire_equals_the_reference(kind):
    want, got = PAYLOADS[kind]()
    frame = got.to_wire(RID)
    assert frame == want.to_wire(RID)
    assert got.checksum() == want.checksum() and got.nbytes == want.nbytes
    assert got.quantized == want.quantized
    if kind == "float32 chunked":
        assert want.nbytes > 2 * ts.WIRE_CHUNK
    assert (ts.WIRE_MAGIC, ts.WIRE_VERSION, ts.WIRE_CHUNK) == (
        js.WIRE_MAGIC, js.WIRE_VERSION, js.WIRE_CHUNK)


@pytest.mark.parametrize("kind", sorted(PAYLOADS))
def test_each_package_decodes_the_others_frames(kind):
    want, got = PAYLOADS[kind]()
    for decode, frame, src in ((ts.KVSlice.from_wire, want.to_wire(RID), want),
                               (js.KVSlice.from_wire, got.to_wire(RID + 1), got)):
        rid, out = decode(frame)
        assert rid in (RID, RID + 1)
        for name in ("valid_len", "n_layers", "kv_heads", "head_dim", "dtype", "block_size"):
            assert getattr(out, name) == getattr(src, name), name
        for name in ("k", "v", "k_scale", "v_scale"):
            a, b = getattr(out, name), getattr(src, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.shape == b.shape and _bits(a) == _bits(b), name
        assert out.checksum() == src.checksum()
    _, port = ts.KVSlice.from_wire(want.to_wire(RID))
    if kind == "bfloat16":
        assert port.k.dtype == np.uint16  # no ml_dtypes on the port's side
    assert port.k.flags.writeable  # the arrays own the decoded bytes


def _frame_regions(frame: bytes) -> dict:
    """Offsets of each field of a frame, by name: ``{region: range}``."""
    bounds = {"magic": 4, "header": HEADER_SIZE, "dtype length": 1,
              "dtype": frame[4 + HEADER_SIZE],
              "payload sizes": 32, "header checksum": 4}
    out, off = {}, 0
    for name, n in bounds.items():
        out[name] = range(off, off + n)
        off += n
    out["chunks"] = range(off, len(frame) - 4)
    out["sentinel"] = range(len(frame) - 4, len(frame))
    return out


def _cuts(frame, region):
    return [frame[:cut] for cut in _frame_regions(frame)[region]]


def _flips(frame, region):
    out = []
    for off in _frame_regions(frame)[region]:
        for flip in (0x01, 0x80):
            out.append(frame[:off] + bytes([frame[off] ^ flip]) + frame[off + 1:])
    return out


def _rehead(frame: bytes, **fields) -> bytes:
    """``frame`` with header fields replaced and the header CRC rewritten
    over them (so the decoder reaches the check after it)."""
    names = ("ver", "rid", "n_layers", "valid_len", "kv_heads", "head_dim", "block_size", "crc")
    vals = dict(zip(names, struct.unpack(HEADER, frame[4:4 + HEADER_SIZE])))
    vals.update(fields)
    out = frame[:4] + struct.pack(HEADER, *(vals[n] for n in names)) + frame[4 + HEADER_SIZE:]
    end = 4 + HEADER_SIZE + 1 + out[4 + HEADER_SIZE] + 32
    return out[:end] + struct.pack("!I", zlib.crc32(out[:end])) + out[end + 4:]


def _relabel(frame: bytes, label: bytes) -> bytes:
    """``frame`` with its dtype label replaced, the header CRC rewritten."""
    size = HEADER_SIZE
    dt_len = frame[4 + size]
    head = frame[:4 + size] + bytes([len(label)]) + label + frame[4 + size + 1 + dt_len:][:32]
    rest = frame[4 + size + 1 + dt_len + 32 + 4:]
    return head + struct.pack("!I", zlib.crc32(head)) + rest


def _payload_offset(frame: bytes) -> int:
    return 4 + HEADER_SIZE + 1 + frame[4 + HEADER_SIZE] + 32 + 4


def _short_chunk(frame: bytes) -> bytes:
    """The last chunk one byte short, its length field to match: the
    sentinel arrives before the declared payload is complete."""
    off = _payload_offset(frame)
    (n,) = struct.unpack("!I", frame[off:off + 4])
    return frame[:off] + struct.pack("!I", n - 1) + frame[off + 4:off + 4 + n - 1] + frame[
        off + 4 + n:]


def _overrun(frame: bytes) -> bytes:
    off = _payload_offset(frame)
    (n,) = struct.unpack("!I", frame[off:off + 4])
    return frame[:off] + struct.pack("!I", n + 1) + frame[off + 4:]


def _crafted(kind):
    """Named malformations built from a clean frame of ``kind``."""
    jkv, _ = PAYLOADS[kind]()
    frame = jkv.to_wire(RID)
    bad_version = frame[:4] + bytes([3]) + frame[5:]
    return {
        "bad magic": [b"TKV0" + frame[4:], b"XXXX" + frame[4:]],
        "bad version": [bad_version, _rehead(frame, ver=1)],
        "trailing bytes": [frame + b"\x00", frame + frame[:8]],
        "header checksum": [frame[:5] + bytes([frame[5] ^ 0x10]) + frame[6:]],
        "payload checksum": [frame[:-5] + bytes([frame[-5] ^ 0x10]) + frame[-4:]],
        "geometry": [_rehead(frame, valid_len=jkv.valid_len + max(jkv.block_size, 1)),
                     _rehead(frame, n_layers=jkv.n_layers + 1)],
        "unreadable dtype": [_relabel(frame, b"float33"), _relabel(frame, b"\xff\xfe")],
        "short chunk": [_short_chunk(frame)],
        "chunk overrun": [_overrun(frame)],
        "truncated after header": [frame[:4 + HEADER_SIZE + 1]],
    }


def _quant_crafted():
    """Quantized-only malformations: the scales' block count, the values'
    extent, a float label under a block size, an odd int4 head_dim."""
    jkv, _ = _quant_pair("int4")
    frame = jkv.to_wire(RID)
    short_scales = js.KVSlice(
        k=jkv.k, v=jkv.v, valid_len=6, n_layers=1, kv_heads=2, head_dim=16, dtype="int4",
        k_scale=jkv.k_scale[:, :1], v_scale=jkv.v_scale[:, :1], block_size=4)
    odd, _ = _quant_pair("int4", head_dim=15)
    return {
        "quantized geometry": [short_scales.to_wire(RID), _rehead(frame, valid_len=9),
                               _rehead(frame, block_size=2)],
        "float label with a block size": [_relabel(frame, b"float32")],
        "odd int4 head_dim": [odd.to_wire(RID)],
    }


CASES = {}
for _kind in ("float32", "int4"):
    for _region in ("magic", "header", "dtype length", "dtype", "payload sizes",
                    "header checksum", "chunks", "sentinel"):
        CASES[f"{_kind} cut in {_region}"] = (lambda k=_kind, r=_region:
                                             _cuts(PAYLOADS[k]()[0].to_wire(RID), r))
        CASES[f"{_kind} flip in {_region}"] = (lambda k=_kind, r=_region:
                                              _flips(PAYLOADS[k]()[0].to_wire(RID), r))
    for _name in _crafted(_kind):
        CASES[f"{_kind} {_name}"] = lambda k=_kind, n=_name: _crafted(k)[n]
for _name in _quant_crafted():
    CASES[_name] = lambda n=_name: _quant_crafted()[n]


@pytest.mark.parametrize("case", sorted(CASES))
def test_malformed_frames_raise_as_the_reference(case):
    """Each malformed buffer of the case raises ``WireFormatError`` in both
    packages, with the same message and request id (-1 until the header
    could be read)."""
    bufs = CASES[case]()
    assert bufs
    for buf in bufs:
        with pytest.raises(js.WireFormatError) as want:
            js.KVSlice.from_wire(buf)
        with pytest.raises(ts.WireFormatError) as got:
            ts.KVSlice.from_wire(buf)
        assert (got.value.request_id, str(got.value)) == (want.value.request_id,
                                                          str(want.value)), case
        assert isinstance(got.value, ValueError)
