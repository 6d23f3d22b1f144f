"""The transport's worker half in the PyTorch port
(``k8s_dra_driver_torch/models/transport.py``) against the JAX package's,
on the CPU, in float32, with the JAX package's weights
(``weights.params_from_jax``) unless a worker draws its own.

* Frames: ``encode_frame``, ``encode_meta_frame``, the prefix gossip and
  telemetry codecs, and ``FrameBuffer`` under random byte splits give the
  reference's bytes and frames on seeded documents.
* The neighbours a worker runs on, each checked between the packages: a
  ``KVSlice`` inside a KV frame both ways; handoff entries after
  ``_sanitize_entry``; the worker's ``reseed``, an empty merge-restore with
  a new ``next_id``.
* A port ``PoolWorker`` serving a port ``FleetRouter`` over one end of a
  socket pair, driven from the other end by the reference's supervisor
  (``PeerLink``, ``TransportChannel``, ``RemotePool`` and a
  ``DisaggRouter`` whose prefill is a JAX engine): greedy streams equal a
  bare JAX engine's and the same rig around the reference's own
  ``PoolWorker``; SUBMIT, cancel, reseed, PREFIXREQ (hit, miss, stale
  epoch) and the prefix gossip answer as the reference's worker does.
* ``python -m k8s_dra_driver_torch.models.transport cfg.json --device
  cpu`` as a process behind the reference's ``TransportHub``: its streams
  are a local port engine's from the same seed, and the process imports
  neither ``jax`` nor ``k8s_dra_driver_tpu``.  Without a card and without
  ``--device cpu`` the worker exits 2 before it dials; an engine key the
  port lacks is refused by name."""

import json
import os
import random
import socket
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import fleet as tfleet
from k8s_dra_driver_torch.models import fleet_prefix as tfp
from k8s_dra_driver_torch.models import obs_plane as tobs
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models import serve as ts
from k8s_dra_driver_torch.models import transport as T
from k8s_dra_driver_torch.models.weights import params_from_jax
from k8s_dra_driver_torch.utils import tracing as ttr
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import fleet as jfleet
from k8s_dra_driver_tpu.models import fleet_prefix as jfp
from k8s_dra_driver_tpu.models import obs_plane as jobs
from k8s_dra_driver_tpu.models import paged as jp
from k8s_dra_driver_tpu.models import serve as js
from k8s_dra_driver_tpu.models import transport as JT
from k8s_dra_driver_tpu.models.disagg import ChannelClaim, DisaggRouter
from k8s_dra_driver_tpu.utils import tracing as jtr

REPO_ROOT = Path(__file__).resolve().parent.parent
CFG_DOC = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq=64,
               dtype="float32")
JCFG = jb.ModelConfig(**dict(CFG_DOC, dtype=jnp.float32))
TCFG = tb.ModelConfig.from_reference(JCFG)
DENSE = dict(n_slots=3, prompt_bucket=16)
PAGED = dict(n_slots=3, n_blocks=41, block_size=4, prompt_bucket=16)
# greedy requests with explicit seeds (router-minted ids differ from a bare
# engine's, so nothing may hang on the id)
REQS = [
    {"prompt": [7, 8, 9], "max_tokens": 6, "seed": 5},
    {"prompt": [3, 4], "max_tokens": 6, "seed": 9},
    {"prompt": [11, 12, 13, 14], "max_tokens": 6, "seed": 21},
    {"prompt": [1, 2], "max_tokens": 6, "seed": 33},
    {"prompt": [21, 22, 23], "max_tokens": 6, "seed": 44},
]
PREFIX_PROMPT = list(range(1, 15))  # 14 tokens: 3 storable blocks of 4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def weights():
    params = jb.init_params(jax.random.PRNGKey(0), JCFG)
    return params, params_from_jax(params, device="cpu")


def _engine(weights, pkg, kind, **kw):
    kw = dict(PAGED if kind == "paged" else DENSE, **kw)
    if pkg == "port":
        cls = tp.PagedServeEngine if kind == "paged" else ts.ServeEngine
        return cls(params=weights[1], cfg=TCFG, device="cpu", **kw)
    if kind == "paged":
        return jp.PagedServeEngine(params=weights[0], cfg=JCFG, attn_impl="xla", **kw)
    return js.ServeEngine(params=weights[0], cfg=JCFG, **kw)


def _by_prompt(completions):
    return {tuple(c.tokens[: len(c.tokens) - len(c.generated)]): tuple(c.generated)
            for c in completions}


# -- frames ------------------------------------------------------------------------------

def _seeded_docs(seed: int, n: int = 12) -> list:
    r = random.Random(seed)
    docs = []
    for i in range(n):
        docs.append({
            "request_id": r.randrange(1 << 31), "tokens": [r.randrange(1 << 15) for _ in
                                                           range(r.randrange(1, 40))],
            "temperature": r.choice([0.0, 0.7, 1.25]), "key": [r.randrange(1 << 32), i],
            "deadline": r.choice([None, 12.5]), "note": "ünïcode" * (i % 3),
            "_correlation": f"handoff-req-{i}", "nested": {"a": [i, {"b": None}]},
        })
    return docs


def test_frames_equal_the_reference_byte_for_byte():
    """Plain and meta frames of seeded documents and payloads are the
    reference's bytes, and each package's ``decode_meta_frame`` reads the
    other's."""
    r = random.Random(3)
    for doc in _seeded_docs(1):
        wire = bytes(r.randrange(256) for _ in range(r.randrange(0, 300)))
        ftype = r.randrange(1, 19)
        body = json.dumps(doc).encode()
        assert T.encode_frame(ftype, body) == JT.encode_frame(ftype, body)
        frame = T.encode_meta_frame(ftype, doc, wire)
        assert frame == JT.encode_meta_frame(ftype, doc, wire)
        assert T.decode_meta_frame(frame[5:]) == JT.decode_meta_frame(frame[5:]) == (doc, wire)
    assert [getattr(T, n) for n in ("HELLO", "KV", "HANDOFF", "TELEM", "PREFIXWDL")] == [
        getattr(JT, n) for n in ("HELLO", "KV", "HANDOFF", "TELEM", "PREFIXWDL")]
    assert T.MAX_FRAME_BYTES == JT.MAX_FRAME_BYTES and T._FRAME_HEADER.format == "!IB"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frame_buffer_under_random_splits(seed):
    """A stream of frames fed in random splits yields the reference's frames
    in order, a partial tail stays buffered, and an insane length raises."""
    r = random.Random(seed)
    frames = [JT.encode_meta_frame(r.randrange(1, 19), d, bytes(r.randrange(256) for _ in
                                   range(r.randrange(50)))) for d in _seeded_docs(seed)]
    stream = b"".join(frames) + frames[0][:7]
    got = {}
    for pkg, cls in (("port", T.FrameBuffer), ("reference", JT.FrameBuffer)):
        buf, out, i = cls(), [], 0
        while i < len(stream):
            step = r.randrange(1, 97)
            buf.feed(stream[i:i + step])
            out.extend(buf.frames())
            i += step
        got[pkg] = (out, buf.partial_bytes)
    assert got["port"] == got["reference"]
    assert len(got["port"][0]) == len(frames) and got["port"][1] == 7
    bad = T.FrameBuffer()
    bad.feed(T._FRAME_HEADER.pack(T.MAX_FRAME_BYTES + 1, 4))
    with pytest.raises(ValueError, match="stream corrupt"):
        list(bad.frames())


def test_gossip_and_telemetry_codecs_equal_the_reference():
    """The gossip body of seeded events, epochs and sequence numbers is the
    reference's, each package decodes the other's, a flipped bit is a
    ``PrefixGossipError`` carrying epoch and seq; the digest and the TELEM
    body are the reference's too."""
    r = random.Random(5)
    for i in range(8):
        doc = {"events": [{"key": tfp.prefix_digest(tuple(range(i, i + 4 + j)), j % 2),
                           "n_tokens": 4 * (j + 1), "block_size": 4, "kv_dtype": "float32",
                           "adapter": j % 2, "blocks": 1} for j in range(r.randrange(1, 6))]}
        if i % 3 == 0:
            doc["full"] = True
        epoch, seq = r.randrange(1 << 32), r.randrange(1 << 32)
        body = tfp.encode_prefix_gossip(doc, epoch=epoch, seq=seq)
        assert body == jfp.encode_prefix_gossip(doc, epoch=epoch, seq=seq)
        assert tfp.decode_prefix_gossip(body) == jfp.decode_prefix_gossip(body) == (doc, epoch,
                                                                                    seq)
        flipped = bytearray(body)
        flipped[-3] ^= 0x10
        with pytest.raises(tfp.PrefixGossipError) as exc:
            tfp.decode_prefix_gossip(bytes(flipped))
        assert (exc.value.epoch, exc.value.seq) == (epoch, seq)
        with pytest.raises(tfp.PrefixGossipError, match="truncated"):
            tfp.decode_prefix_gossip(body[:11])
    for material, adapter in (((1, 2, 3), 0), (tuple(range(40)), 3)):
        assert tfp.prefix_digest(material, adapter) == jfp.prefix_digest(material, adapter)
    doc = {"instance": "w", "mono": 1.5, "journal": [{"event": "x"}], "spans": [], "metrics": ""}
    assert tobs.encode_telem(doc) == jobs.encode_telem(doc)
    assert tobs.decode_telem(jobs.encode_telem(doc)) == doc
    assert tobs.decode_telem(b"\x00\x00\x00\x00{}") is None


@pytest.mark.parametrize("spec", ["sock_truncate=0.3,seed=3", "sock_reset=0.25,seed=5",
                                  "sock_partition=0.5,peers=worker,steps=2+3+5,seed=7",
                                  "sock_latency_ms=40,limit=3,seed=1"])
@pytest.mark.parametrize("conn", ["loopback", "socket"])
def test_conn_seams_fail_as_the_reference(spec, conn):
    """Twelve frames through each package's ``LoopbackConn`` or
    ``SocketConn`` (a socket pair) under one ``DRA_FAULTS`` spec: the same
    accounted latencies, typed deaths (reason, request id) and bytes on the
    far side, then EOF; sending on a dead connection is a typed death too."""
    from k8s_dra_driver_torch.utils.faults import FaultInjector as TInj
    from k8s_dra_driver_tpu.utils.faults import FaultInjector as JInj

    frames = [T.encode_meta_frame(T.KV, d, bytes(range(i % 7, 40))) for i, d in
              enumerate(_seeded_docs(9))]
    runs = {}
    for mod, inj in ((T, TInj.from_env(spec)), (JT, JInj.from_env(spec))):
        if conn == "loopback":
            a, b = mod.LoopbackConn.pair(fault_injector=inj)
        else:
            pa, pb = socket.socketpair()
            a, b = (mod.SocketConn(pa, peer="worker", fault_injector=inj),
                    mod.SocketConn(pb, peer="supervisor"))
        seen, got = [], b""
        for rid, frame in enumerate(frames):
            try:
                seen.append(("sent", round(a.send(frame, request_id=rid), 6)))
            except mod.PeerDiedError as exc:
                seen.append(("died", exc.reason.split(":")[0], exc.request_id))
        a.close()
        while True:
            try:
                chunk = b.recv_available()
            except mod.PeerDiedError as exc:
                seen.append(("eof", exc.reason))
                break
            got += chunk
        b.close()
        runs[mod.__name__] = (seen, got)
    assert runs[T.__name__] == runs[JT.__name__]
    seen, got = runs[T.__name__]
    assert ("eof", "eof") in seen
    if "latency" in spec:  # accounted, never slept: every byte arrives
        assert got == b"".join(frames) and ("sent", 0.04) in seen
    else:  # the spec fired: frames cut, reset or dropped
        assert got != b"".join(frames)


# -- the neighbours a worker runs on -------------------------------------------------------

def test_kv_frame_both_ways_between_the_packages(weights):
    """A handoff payload inside a KV frame, each package's frame read by the
    other's ``decode_meta_frame`` and ``KVSlice.from_wire``: the same
    request id, geometry and values (the port's payload within 1e-5 of the
    JAX engine's), and a payload re-encoded by the other package is the
    same bytes."""
    entries = {}
    for pkg in ("port", "jax"):
        eng = _engine(weights, pkg, "paged")
        eng.submit([5, 6, 7, 8, 9, 10], 6, seed=4, handoff=True)
        (entries[pkg],) = eng.take_handoffs()
    frames = {pkg: (T if pkg == "port" else JT).encode_meta_frame(
        T.KV, T._sanitize_entry(e), e["kv"].to_wire(e["request_id"])) for pkg, e in entries.items()}
    for src, (decode_meta, from_wire) in (("port", (JT.decode_meta_frame, js.KVSlice.from_wire)),
                                          ("jax", (T.decode_meta_frame, ts.KVSlice.from_wire))):
        meta, wire = decode_meta(frames[src][5:])
        rid, kv = from_wire(wire)
        e = entries[src]
        assert rid == meta["request_id"] == e["request_id"]
        for name in ("valid_len", "n_layers", "kv_heads", "head_dim", "dtype", "block_size"):
            assert getattr(kv, name) == getattr(e["kv"], name), name
        other = entries["jax" if src == "port" else "port"]["kv"]
        for name in ("k", "v"):
            np.testing.assert_allclose(np.asarray(getattr(kv, name)),
                                       np.asarray(getattr(other, name)), atol=1e-5, rtol=1e-5)
        assert kv.to_wire(rid) == wire


def _masked_trace(entry: dict) -> dict:
    trace = {k: (None if k.endswith(("_at", "_s")) else v) for k, v in entry["trace"].items()}
    return dict(entry, trace=trace)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_sanitized_handoff_entries_equal_the_reference(weights, kind):
    """``take_handoffs`` of each package after its ``_sanitize_entry``: the
    same JSON document but for the trace's clock readings."""
    docs = {}
    for pkg, sanitize in (("port", T._sanitize_entry), ("jax", JT._sanitize_entry)):
        eng = _engine(weights, pkg, kind)
        for r in REQS[:3]:
            eng.submit(handoff=True, **r)
        docs[pkg] = [json.dumps(_masked_trace(sanitize(dict(e, _trace={"tid": "t"}))),
                                sort_keys=True) for e in eng.take_handoffs()]
    assert docs["port"] == docs["jax"] and len(docs["port"]) == 3
    assert '"_trace"' not in docs["port"][0] and '"kv"' not in docs["port"][0]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_empty_merge_restore_reseeds_like_the_reference(weights, kind):
    """The worker's ``reseed``: an empty merge-restore with a new
    ``next_id`` on a live engine moves the next id there and keeps the
    resident stream, in both packages alike."""
    got = {}
    for pkg in ("port", "jax"):
        eng = _engine(weights, pkg, kind)
        first = eng.submit([1, 2, 3], 4, seed=1)
        restored = eng.restore({"engine": type(eng).__name__, "next_id": 7_000_000,
                                "requests": []}, merge=True)
        second = eng.submit([4, 5, 6], 4, seed=2)
        eng.run_until_drained()
        got[pkg] = (first, list(restored), second,
                    sorted((c.request_id, tuple(c.generated)) for c in eng.completions()))
    assert got["port"] == got["jax"]
    assert got["port"][2] == 7_000_000 and len(got["port"][3]) == 2


# -- a port worker behind the reference's supervisor, in process -------------------------

def _rig(weights, pkg, kind="paged", hold=False, gossip=False, **engine_kw):
    """A ``PoolWorker`` of ``pkg`` around a ``FleetRouter`` of ``pkg``
    engines on one end of a socket pair; the reference's supervisor on the
    other, its channel and pool pumping the worker in this thread."""
    near, far = socket.socketpair()
    mod, fleet, tr = (T, tfleet, ttr) if pkg == "port" else (JT, jfleet, jtr)
    router = fleet.FleetRouter([_engine(weights, pkg, kind, **engine_kw)])
    worker = mod.PoolWorker(mod.SocketConn(far, peer="supervisor"), router, role="decode",
                            hold_ticks=hold, name=f"{pkg}-w", traces=tr.TraceBuffer(),
                            prefix_gossip=gossip)
    link = JT.PeerLink("decode-w", JT.SocketConn(near, peer="decode-w"),
                       heartbeat_interval_s=0.05, liveness_timeout_s=60.0, ack_timeout_s=30.0)
    channel = JT.TransportChannel(link, peer_pump=worker.pump_once,
                                  claim=ChannelClaim(bandwidth_gbps=1000.0,
                                                     transfer_deadline_s=10.0))
    pool = JT.RemotePool(link, name=f"{pkg}-pool", peer_pump=worker.pump_once)
    return SimpleNamespace(worker=worker, router=router, link=link, channel=channel, pool=pool,
                           engine=router.replicas[0].engine, socks=(near, far))


def _close(rig):
    for s in rig.socks:
        s.close()


def _drain(rig, n: int, limit_s: float = 60.0) -> list:
    done, deadline = [], time.monotonic() + limit_s
    while len(done) < n and time.monotonic() < deadline:
        rig.pool.tick()
        done += rig.pool.completions()
    assert len(done) == n, f"{len(done)} of {n} completions in {limit_s} s"
    return done


def _control(rig, doc: dict) -> None:
    rig.link.send_json(JT.CONTROL, doc)
    rig.worker.pump_once()


def test_port_worker_serves_the_reference_disagg_router(weights):
    """A JAX prefill engine hands every request over the socket to the port
    worker: every KV frame ACKs ok and places, the streams equal a bare JAX
    engine's and the same rig's around the reference's ``PoolWorker``, one
    completion each; the port pool ends where it started."""
    want = _by_prompt(_engine(weights, "jax", "dense").pump([dict(r) for r in REQS]))
    got, counts = {}, {}
    for pkg in ("port", "jax"):
        rig = _rig(weights, pkg)
        dis = DisaggRouter(prefill=[_engine(weights, "jax", "dense")], decode=rig.pool,
                           channel=rig.channel)
        done = dis.pump([dict(r) for r in REQS])
        assert len(done) == len(REQS) and {c.status for c in done} == {"ok"}
        assert len({c.request_id for c in done}) == len(REQS)
        got[pkg], counts[pkg] = _by_prompt(done), dict(rig.channel.counts)
        assert rig.engine.free_blocks == rig.engine.n_blocks - 1
        _close(rig)
    assert got["port"] == want == got["jax"]
    assert counts["port"] == counts["jax"] == {"ok": len(REQS)}


def test_submit_cancel_and_reseed_as_the_reference_worker(weights):
    """SUBMIT through ``RemotePool.submit`` after a ``reseed`` (the ids
    start at the reseeded base), two requests admitted while the worker
    holds its ticks, a ``cancel`` of the second, then ``resume``: the same
    ids, statuses and tokens from the port's worker as from the
    reference's, the first stream a bare JAX engine's."""
    want = _by_prompt(_engine(weights, "jax", "dense").pump([dict(REQS[0])]))
    got = {}
    for pkg in ("port", "jax"):
        rig = _rig(weights, pkg, hold=True)
        _control(rig, {"op": "reseed", "next_id": 3 * jfleet.ID_STRIDE,
                       "stride": jfleet.ID_STRIDE})
        rids = [rig.pool.submit(r["prompt"], r["max_tokens"], seed=r["seed"]) for r in REQS[:2]]
        _control(rig, {"op": "cancel", "rid": rids[1]})
        _control(rig, {"op": "resume"})
        done = _drain(rig, 2)
        got[pkg] = (rids, sorted((c.request_id, c.status, tuple(c.generated)) for c in done))
        _close(rig)
    assert got["port"] == got["jax"]
    (ok_id, ok, stream), (_, cancelled, partial) = got["port"][1]
    assert got["port"][0] == [3 * jfleet.ID_STRIDE, 3 * jfleet.ID_STRIDE + 1]
    assert (ok, cancelled, len(partial)) == ("ok", "cancelled", 1)
    assert stream == want[tuple(REQS[0]["prompt"])]


def test_zero_launches_restarts_the_workers_counts(weights):
    """``CONTROL {"op": "zero_launches"}``, the port worker's own op, sets
    the launch counters to 0, so the exit line counts only what follows
    (a supervisor's warm-up left out); the reference's worker ignores it.
    Both then serve a bare JAX engine's stream."""
    from k8s_dra_driver_torch.models import graphs
    from k8s_dra_driver_torch.ops import paged_attention as tpa

    want = _by_prompt(_engine(weights, "jax", "dense").pump([dict(REQS[0])]))
    before = graphs.launch_counts()
    try:
        for pkg in ("port", "jax"):
            graphs.add_launch_counts({(tpa.__name__, "append"): 3})
            counted = graphs.launch_counts()
            rig = _rig(weights, pkg)
            _control(rig, {"op": "zero_launches"})
            after = graphs.launch_counts()
            assert set(after.values()) == {0} if pkg == "port" else after == counted
            r = REQS[0]
            rig.pool.submit(r["prompt"], r["max_tokens"], seed=r["seed"])
            assert _by_prompt(_drain(rig, 1)) == want
            _close(rig)
    finally:
        now = graphs.launch_counts()
        graphs.add_launch_counts({key: before.get(key, 0) - n for key, n in now.items()})


def _frames(rig, ftype) -> list:
    out = []
    while (body := rig.link.take(ftype)) is not None:
        out.append(body)
    return out


def test_prefix_pull_and_gossip_as_the_reference_worker(weights):
    """A paged worker with a prefix store serves a prompt, gossips its
    blocks and answers PREFIXREQ: the prefix's payload (PREFIXKV, the
    reference's ``from_wire`` reads it, its values the JAX worker's within
    1e-5), a miss for tokens it lacks, and after a ``prefix_resync`` a
    fenced miss for a stale epoch; the gossip events equal the reference
    worker's."""
    got = {}
    for pkg in ("port", "jax"):
        rig = _rig(weights, pkg, gossip=True, prefix_cache_blocks=8)
        rig.pool.submit(PREFIX_PROMPT, 6, seed=3)
        (done,) = _drain(rig, 1)
        rig.worker.gossip.maybe_ship(force=True)
        answers = []
        for doc in ({"nonce": 7, "tokens": PREFIX_PROMPT, "max_tokens": 6},
                    {"nonce": 8, "tokens": [60, 61, 62, 63, 59, 58]},
                    None,
                    {"nonce": 9, "tokens": PREFIX_PROMPT, "epoch": 3}):
            if doc is None:
                _control(rig, {"op": "prefix_resync", "epoch": 4})
                continue
            rig.link.send_json(JT.PREFIXREQ, doc)
            rig.worker.pump_once()
        rig.worker.gossip.maybe_ship(force=True)  # the resync's full digest
        rig.link.pump()
        for ftype in (JT.PREFIXKV, JT.PREFIXMISS):
            for body in _frames(rig, ftype):
                meta, wire = JT.decode_meta_frame(body)
                answers.append((ftype, meta, js.KVSlice.from_wire(wire) if wire else None))
        events = []
        for body in _frames(rig, JT.PREFIXPUB):
            doc, epoch, _ = jfp.decode_prefix_gossip(body)
            events += [(epoch, json.dumps(e, sort_keys=True)) for e in doc["events"]]
        got[pkg] = (done.generated, answers, sorted(events))
        _close(rig)
    (stream, answers, events), (jstream, janswers, jevents) = got["port"], got["jax"]
    # the three blocks published at epoch 0, then the full digest at epoch 4
    assert stream == jstream and events == jevents and len(events) == 6
    assert [(f, m) for f, m, _ in answers] == [(f, m) for f, m, _ in janswers] == [
        (JT.PREFIXKV, {"nonce": 7, "n_tokens": 12, "epoch": 0}),
        (JT.PREFIXMISS, {"nonce": 8, "reason": "miss", "epoch": 0}),
        (JT.PREFIXMISS, {"nonce": 9, "reason": "epoch", "epoch": 4})]
    (nonce, kv), (jnonce, jkv) = answers[0][2], janswers[0][2]
    assert nonce == jnonce == 7 and kv.valid_len == jkv.valid_len == 12
    for name in ("k", "v"):
        np.testing.assert_allclose(np.asarray(getattr(kv, name)), np.asarray(getattr(jkv, name)),
                                   atol=1e-5, rtol=1e-5)


# -- the worker process ------------------------------------------------------------------

WORKER_ENGINE = dict(PAGED, kind="paged")


def _worker_config(path: Path, port: int, **extra) -> Path:
    path.write_text(json.dumps(dict({
        "cfg": CFG_DOC, "engines": [WORKER_ENGINE], "seed": 0, "host": "127.0.0.1",
        "port": port, "name": "port-w", "role": "decode", "telem_interval_s": 0.1,
    }, **extra)))
    return path


def _port_engine_from_seed(seed: int = 0):
    params = tb.init_params(torch.Generator().manual_seed(seed), TCFG)
    return params, tp.PagedServeEngine(params=params, cfg=TCFG, device="cpu", **PAGED)


def test_worker_process_behind_the_reference_hub(tmp_path):
    """``python -X importtime -m k8s_dra_driver_torch.models.transport
    cfg.json --device cpu``: it dials the reference's ``TransportHub`` and
    prints its ready line; a port prefill engine of the same seed's weights
    hands every request to it through the reference's channel; its streams
    equal a local port engine's, every KV frame ACKs ok, it exits 0 when
    the hub hangs up with its launch line, and no module of ``jax`` or
    ``k8s_dra_driver_tpu`` was imported in it."""
    params, local = _port_engine_from_seed()
    want = _by_prompt(local.pump([dict(r) for r in REQS]))
    hub = JT.TransportHub(heartbeat_interval_s=0.1, liveness_timeout_s=60.0, ack_timeout_s=30.0)
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), OMP_NUM_THREADS="2")
    env.pop("DRA_FAULTS", None)
    err_path = tmp_path / "stderr.txt"  # a file: the import report outgrows a pipe
    with open(err_path, "w") as err_file:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m", "k8s_dra_driver_torch.models.transport",
             str(_worker_config(tmp_path / "w.json", hub.port)), "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=err_file, text=True, env=env, cwd=REPO_ROOT)
    try:
        link = hub.link_for("port-w", timeout_s=90.0)
        ready = json.loads(proc.stdout.readline())
        assert ready == {"ready": True, "pid": proc.pid}
        channel = JT.TransportChannel(link, claim=ChannelClaim(bandwidth_gbps=1000.0,
                                                               transfer_deadline_s=10.0))
        pool = JT.RemotePool(link, name="port-pool")
        prefill = tp.PagedServeEngine(params=params, cfg=TCFG, device="cpu", **PAGED)
        dis = DisaggRouter(prefill=[prefill], decode=pool, channel=channel)
        for r in REQS:
            dis.submit(r["prompt"], r["max_tokens"], seed=r["seed"])
        done, deadline = [], time.monotonic() + 90.0
        while len(done) < len(REQS) and time.monotonic() < deadline:
            hub.poll()
            dis.tick()
            done += dis.completions()
            time.sleep(0.002)
        assert _by_prompt(done) == want and len(done) == len(REQS)
        assert channel.counts == {"ok": len(REQS)}
    finally:
        hub.close()
        for link_ in hub.links.values():
            link_.conn.close()
        try:
            proc.communicate(timeout=60)
        finally:
            proc.kill()
    err = err_path.read_text()
    assert proc.returncode == 0, err[-3000:]
    assert "worker kernel launches: {}" in err  # the CPU takes the plain versions
    imported = {line.split("|")[-1].strip() for line in err.splitlines()
                if line.startswith("import time:")}
    assert "k8s_dra_driver_torch.models.transport" in imported or "torch" in imported
    assert not {m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "k8s_dra_driver_tpu")}


def test_worker_without_a_card_exits_before_dialing(tmp_path, monkeypatch, capsys):
    """No card and no ``--device cpu``: exit 2 naming the missing card,
    before any dial (nothing listens on the configured port)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.monotonic()
    assert T.worker_main([str(_worker_config(tmp_path / "w.json", port))]) == 2
    assert time.monotonic() - t0 < 5.0
    assert "no CUDA device" in capsys.readouterr().err


def test_build_worker_router_refuses_what_the_port_lacks():
    """The reference's paged document carries ``attn_impl``: refused by
    name, as are an unknown kind and a key the worker sets itself; a
    document without them builds one port replica per engine with the
    seed's weights."""
    doc = {"cfg": CFG_DOC, "seed": 0}
    with pytest.raises(ValueError, match="engines\\[0\\].*'attn_impl'"):
        T.build_worker_router(dict(doc, engines=[dict(WORKER_ENGINE, attn_impl="xla")]), "cpu")
    with pytest.raises(ValueError, match="kind 'mixed'"):
        T.build_worker_router(dict(doc, engines=[{"kind": "mixed"}]), "cpu")
    with pytest.raises(ValueError, match="engines\\[1\\].*'device'"):
        T.build_worker_router(dict(doc, engines=[dict(DENSE), dict(DENSE, device="cpu")]), "cpu")
    router = T.build_worker_router(dict(doc, engines=[dict(DENSE, kind="dense",
                                                           cache_dtype="float32"),
                                                      WORKER_ENGINE]), "cpu")
    assert isinstance(router, tfleet.FleetRouter)
    engines = [rep.engine for rep in router.replicas]
    assert [type(e).__name__ for e in engines] == ["ServeEngine", "PagedServeEngine"]
    assert engines[0].cache_dtype == torch.float32 and engines[0].cfg == TCFG
    want = tb.init_params(torch.Generator().manual_seed(0), TCFG)
    assert torch.equal(engines[1].params["embed"], want["embed"])
