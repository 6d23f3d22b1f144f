"""The transport's supervisor half and the fleet observability plane in the
PyTorch port (``k8s_dra_driver_torch/models/{transport,obs_plane}.py``)
against the JAX package's, on the CPU.

* ``PeerLink``, ``RemotePool`` and ``TransportChannel`` over a
  ``LoopbackConn`` whose far end is scripted: one sequence of calls
  (submit, place without a payload, a KV transfer, place of a landed
  entry, control, heartbeat) sends the reference's frames byte for byte,
  and the link's, pool's and channel's state after it is the reference's.
* ``RemotePool``'s zero-loss contract: a ``sock_reset`` kills the link,
  every retained entry drains through ``take_failed`` with its id in
  ``link.reclaimed``, a late completion for it is dropped after the
  reconnect, which sends ``CONTROL reset``; all as the reference's.
* ``FleetObservability`` merging the same ``TELEM`` frames gives the
  reference's fleet journal, span trees, federated metrics, bundle and
  ``debug_obs_doc``; ``SloBurnRateMonitor`` gives its burn rates, alerts,
  timeline and journal on a simulated clock.
* A port ``TransportHub`` with two port worker processes (``--device
  cpu``, prefill and decode) behind a port ``DisaggRouter``: the streams
  of the in-process router over port engines of the same seed.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import disagg as td
from k8s_dra_driver_torch.models import obs_plane as tobs
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models import serve as ts
from k8s_dra_driver_torch.models import transport as T
from k8s_dra_driver_torch.utils import faults as tf
from k8s_dra_driver_torch.utils import journal as tj
from k8s_dra_driver_torch.utils import metrics as tm
from k8s_dra_driver_torch.utils import tracing as ttr
from k8s_dra_driver_tpu.models import disagg as jd
from k8s_dra_driver_tpu.models import obs_plane as jobs
from k8s_dra_driver_tpu.models import serve as js
from k8s_dra_driver_tpu.models import transport as JT
from k8s_dra_driver_tpu.utils import faults as jf
from k8s_dra_driver_tpu.utils import journal as jj
from k8s_dra_driver_tpu.utils import metrics as jm
from k8s_dra_driver_tpu.utils import tracing as jtr

REPO_ROOT = Path(__file__).resolve().parent.parent
PKG = {
    "jax": dict(T=JT, disagg=jd, obs=jobs, serve=js, faults=jf, journal=jj, metrics=jm,
                tracing=jtr),
    "port": dict(T=T, disagg=td, obs=tobs, serve=ts, faults=tf, journal=tj, metrics=tm,
                 tracing=ttr),
}


@pytest.fixture(autouse=True)
def _fresh_state():
    for pkg in PKG.values():
        pkg["metrics"].REGISTRY.reset()
        pkg["journal"].JOURNAL.clear()
        pkg["tracing"].TRACES.clear()
        pkg["obs"].FLEET.clear()
    yield


class _Clock:
    """A clock that moves 10 ms a read: both packages read it the same
    number of times, or the frames that carry it differ."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 0.01
        return self.t


class _Far:
    """The far end of a ``LoopbackConn`` pair, scripted: it keeps every
    frame it gets, answers SUBMIT (rid ``100 + seq``), PLACE, KV (ok,
    placed) and PING (``pt`` fixed), and sends what a test queues."""

    def __init__(self, mod, conn):
        self.mod, self.conn = mod, conn
        self.buf = mod.FrameBuffer()
        self.seen: list[bytes] = []
        self.queued: list[bytes] = []

    def reply(self, ftype, doc):
        self.conn.send(self.mod.encode_frame(ftype, json.dumps(doc).encode()))

    def pump(self) -> int:
        for frame in self.queued:
            self.conn.send(frame)
        self.queued = []
        try:
            data = self.conn.recv_available()
        except self.mod.PeerDiedError:
            return 0
        self.buf.feed(data)
        n = 0
        for ftype, body in self.buf.frames():
            n += 1
            self.seen.append(self.mod.encode_frame(ftype, body))
            mod = self.mod
            if ftype == mod.SUBMIT:
                seq = json.loads(body)["seq"]
                self.reply(mod.SUBMITTED, {"seq": seq, "ok": True, "rid": 100 + seq})
            elif ftype == mod.PLACE:
                meta, _ = mod.decode_meta_frame(body)
                self.reply(mod.PLACED, {"rid": meta["request_id"]})
            elif ftype == mod.KV:
                meta, _ = mod.decode_meta_frame(body)
                self.reply(mod.ACK, {"rid": meta["request_id"], "outcome": "ok", "placed": True})
            elif ftype == mod.PING:
                self.reply(mod.PONG, dict(json.loads(body), pt=5.0))
        return n


def _payload(pkg, valid_len=6):
    r = np.random.RandomState(4)
    k, v = (r.standard_normal((2, valid_len, 2, 8)).astype(np.float32) for _ in range(2))
    return PKG[pkg]["serve"].KVSlice(k=k, v=v, valid_len=valid_len, n_layers=2, kv_heads=2,
                                     head_dim=8, dtype="float32")


def _entry(rid, n=7):
    return {"request_id": rid, "tokens": list(range(1, n + 1)), "generated": [n],
            "prompt_len": n - 1, "max_tokens": 5, "temperature": 0.0, "key": [0, rid],
            "trace": {"events": []}}


def _link_rig(pkg, fault_injector=None):
    mod, d = PKG[pkg]["T"], PKG[pkg]["disagg"]
    clock = _Clock()
    near, far_conn = mod.LoopbackConn.pair(peer_a="supervisor", peer_b="decode-w",
                                           fault_injector=fault_injector)
    far = _Far(mod, far_conn)
    link = mod.PeerLink("decode-w", near, clock=clock, heartbeat_interval_s=0.05,
                        liveness_timeout_s=60.0, ack_timeout_s=5.0)
    pool = mod.RemotePool(link, name="decode-pool", clock=clock, peer_pump=far.pump)
    channel = mod.TransportChannel(link, peer_pump=far.pump, clock=clock,
                                   claim=d.ChannelClaim(bandwidth_gbps=1000.0,
                                                        transfer_deadline_s=10.0))
    return mod, clock, far, link, pool, channel


def _link_stats(link) -> dict:
    return {k: v for k, v in link.stats().items() if k not in ("pong_age_s", "last_rtt_s")}


def _supervisor_sequence(pkg):
    mod, clock, far, link, pool, channel = _link_rig(pkg)
    rid = pool.submit([1, 2, 3], 5, seed=3, temperature=0.5, handoff=True, _private=1)
    pool.place([_entry(7)], correlation="handoff-req-7")
    pool.tick()
    kv = _payload(pkg)
    entry = dict(_entry(8), kv=kv, _trace={"tid": "x"})
    t = channel.begin(8, kv.nbytes, kv.checksum())
    outcome = channel.complete(t, kv, entry=entry)
    placed = pool.place([entry])
    link.send_json(mod.CONTROL, {"op": "hold"})
    clock.t += 1.0
    link.pump()
    far.pump()
    link.pump()
    return dict(seen=far.seen, rid=rid, outcome=outcome, placed=placed,
                link=_link_stats(link), pool=pool.stats(), channel=channel.stats(),
                resident=sorted(pool._resident), owner=sorted(pool._owner),
                counts=dict(channel.counts))


def test_supervisor_frames_equal_the_reference_byte_for_byte():
    """Submit, place without a payload, a KV transfer, place of the landed
    entry, control and a heartbeat: the same frames, byte for byte, and
    the same state after."""
    got = {pkg: _supervisor_sequence(pkg) for pkg in PKG}
    assert got["port"] == got["jax"]
    seen = got["port"]["seen"]
    assert [f[4] for f in seen if f[4] != T.PING] == [T.SUBMIT, T.PLACE, T.KV, T.CONTROL]
    assert seen[-1][4] == T.PING
    assert got["port"]["outcome"] == "ok" and got["port"]["placed"] == [8]
    assert got["port"]["resident"] == [7, 8, 101]


def _reset_sequence(pkg):
    """Two streams retained (a submit and a place), then a reset on the
    next send: the pool's failed entries, the reclaimed ids; a reconnect
    (its CONTROL reset) and a late completion of a reclaimed stream."""
    faults = PKG[pkg]["faults"]
    inj = faults.FaultInjector(seed=2)
    mod, clock, far, link, pool, channel = _link_rig(pkg, fault_injector=inj)
    rid = pool.submit([4, 5, 6], 5, seed=1)
    pool.place([_entry(9)])
    pool.tick()
    inj.arm(faults.FaultProfile(name="reset", sock_reset_rate=1.0, limit=1))
    clock.t += 1.0
    link.pump()  # the heartbeat's send resets the connection
    dead = (link.dead, link.death_reason, link.breaker.state)
    pool.tick()
    failed = pool.take_failed()
    reclaimed = sorted(link.reclaimed)
    near, far_conn = mod.LoopbackConn.pair(peer_a="supervisor", peer_b="decode-w")
    far2 = _Far(mod, far_conn)
    link.adopt(near)  # the worker dialed again
    far2.queued.append(mod.encode_frame(mod.COMPLETION, json.dumps(
        {"request_id": rid, "tokens": [4, 5, 6, 1], "generated": [1], "status": "ok",
         "error": ""}).encode()))
    far2.pump()
    pool.tick()
    far2.pump()
    events = [(e["event"], e.get("correlation"), e.get("attrs", {}).get("reason"))
              for e in PKG[pkg]["journal"].JOURNAL.tail(1000, component="transport")]
    return dict(rid=rid, dead=dead, failed=failed, reclaimed=reclaimed, idle=pool.idle(),
                completions=pool.completions(), after=far2.seen, events=events,
                link=_link_stats(link), reconnects=link.reconnects,
                dead_hops=[(s["name"], s["attrs"].get("instance"))
                           for s in PKG[pkg]["tracing"].TRACES.snapshot()])


def test_remote_pool_drains_without_loss_after_a_reset():
    got = {pkg: _reset_sequence(pkg) for pkg in PKG}
    assert got["port"] == got["jax"]
    run = got["port"]
    assert run["dead"][0] and run["dead"][1] == "reset" and run["dead"][2] == "open"
    assert sorted(e["request_id"] for e in run["failed"]) == [9, run["rid"]] == run["reclaimed"]
    assert run["idle"] and run["completions"] == [] and run["reconnects"] == 1
    assert ("completion.stale_dropped", f"req-{run['rid']}", None) in run["events"]
    assert [json.loads(f[5:]) for f in run["after"] if f[4] == T.CONTROL] == [{"op": "reset"}]
    assert sorted(run["dead_hops"]) == [("hop.dead", "decode-w")] * 2


def _telem_docs():
    hist = "\n".join(
        [f'tpu_serve_ttft_seconds_bucket{{engine="paged",le="{le}"}} {n}'
         for le, n in (("0.5", 3), ("1.0", 5), ("2.5", 9), ("+Inf", 10))]
        + ['tpu_serve_ttft_seconds_count{engine="paged"} 10', "tpu_x_total 4",
           '# HELP tpu_y y', 'tpu_y{a="b"} 2.5'])
    docs = []
    for i, inst in enumerate(("prefill-w", "decode-w", 'evil"w')):
        docs.append({
            "instance": inst, "mono": 50.0 + i,
            "journal": [{"ts": "t", "ts_s": 1700000000.0 + j * 0.5 + i, "component": "serve",
                         "event": f"e{j}", "correlation": f"req-{j % 3}"} for j in range(4)],
            "spans": [{"trace_id": f"req-{j}", "span_id": f"s{i}.{j}",
                       "parent_id": "" if i == 0 else f"s0.{j}", "name": f"hop.{inst}",
                       "t0": 10.0 + i, "t1": 10.5 + i, "attrs": {"request_id": j}}
                      for j in range(3)],
            "metrics": hist if i < 2 else "tpu_x_total 1",
            **({"truncated": True} if i == 1 else {}),
        })
    return docs


def _fleet_views(pkg):
    obs, metrics = PKG[pkg]["obs"], PKG[pkg]["metrics"]
    fleet = obs.FLEET
    for i, doc in enumerate(_telem_docs()):
        assert fleet.ingest_wire(doc["instance"], obs.encode_telem(doc), clock_offset_s=0.25 * i)
    assert not fleet.ingest_wire("bad", b"\x00\x00\x00\x01{}")
    fleet.note_hop(3, "req-3", "s0.1", instance="decode-w")
    private = PKG[pkg]["tracing"].TraceBuffer()
    fleet.attribute_dead_hop(3, "decode-w", reason="eof", traces=private)
    dead = [{k: v for k, v in s.items() if k not in ("t0", "t1", "span_id")}
            for s in private.snapshot()]
    parsed = metrics.parse_prom_text(metrics.REGISTRY.render())
    return dict(
        journal=fleet.fleet_journal_doc(limit=50),
        by_corr=fleet.fleet_journal_doc(correlation="req-1", instance="decode-w"),
        traces=fleet.fleet_traces_doc(traces=PKG[pkg]["tracing"].TraceBuffer()),
        one=fleet.fleet_traces_doc(trace_id="req-1", traces=PKG[pkg]["tracing"].TraceBuffer()),
        federated=fleet.render_federated(registry=metrics.Registry()),
        bundle=fleet.bundle_doc(journal_limit=3), debug=obs.debug_obs_doc(), dead=dead,
        telem={k: v for k, v in parsed.items() if k.startswith("tpu_obs_")},
    )


def test_fleet_observability_merges_as_the_reference():
    got = {pkg: _fleet_views(pkg) for pkg in PKG}
    assert got["port"] == got["jax"]
    run = got["port"]
    assert run["debug"]["fleet"]["instances"] == ["decode-w", 'evil"w', "prefill-w"]
    assert 'instance="evil\\"w"' in run["federated"]
    assert {tuple(sorted(t["instances"])) for t in run["traces"]["traces"]} == {
        ("decode-w", 'evil"w', "prefill-w")}


def _burn_sequence(pkg):
    obs, journal = PKG[pkg]["obs"], PKG[pkg]["journal"].Journal()
    mon = obs.SloBurnRateMonitor(error_budget=0.05, alert_threshold=2.0, journal=journal)
    r = np.random.RandomState(7)
    out = [obs.SloBurnRateMonitor.classify_tier(s) for s in (0.5, 1.0, 2.0, 3.0, 9.0)]
    for step in range(160):
        now = step * 30.0
        miss = 0.4 if 40 <= step < 80 else 0.02
        for tier in (obs.INTERACTIVE, obs.STANDARD, obs.BATCH):
            for _ in range(4):
                mon.observe(now, tier, bool(r.random_sample() >= miss))
        if step % 20 == 0:
            fleet = obs.FleetObservability()
            for doc in _telem_docs()[:2]:
                fleet.ingest(doc["instance"], dict(doc, metrics=doc["metrics"].replace(
                    " 10", f" {10 + step}").replace(" 9", f" {9 + step // 2}")))
            out.append(mon.ingest_federated(now, fleet=fleet, slo_s=1.0))
        out.append((mon.tick(now), mon.alerting, mon.alerting_tiers))
    events = [(e["event"], e.get("correlation"), e.get("attrs")) for e in journal.tail(1000)]
    return dict(out=out, timeline=mon.timeline(), stats=mon.stats(), events=events)


def test_slo_burn_rate_monitor_as_the_reference():
    """Burn rates per window and tier, the alerts' firing and clearing, the
    timeline and the journal on a simulated clock, fed per request and from
    federated TTFT histograms."""
    got = {pkg: _burn_sequence(pkg) for pkg in PKG}
    assert got["port"] == got["jax"]
    kinds = [e[0] for e in got["port"]["events"]]
    assert "slo.burn.fired" in kinds and "slo.burn.cleared" in kinds
    assert tobs.DEFAULT_BURN_WINDOWS == jobs.DEFAULT_BURN_WINDOWS
    assert (tobs.SUPERVISOR, tobs.INGESTED, tobs.FLEET_TIER) == (
        jobs.SUPERVISOR, jobs.INGESTED, jobs.FLEET_TIER)


def test_remote_engine_factory_rigs():
    """``make_remote_engine_factory`` takes exactly one rig; the in-process
    one builds a ``RemoteWorkerEngine`` over a ``PoolWorker`` around a port
    ``FleetRouter``: reseeded by an empty restore, it serves a bare port
    engine's streams under the reseeded ids, and its ``stats()`` are the
    reference's ``EngineStats`` fields."""
    from k8s_dra_driver_torch.models import fleet as tfleet
    from k8s_dra_driver_tpu.models import telemetry as jtel

    for bad in ((), (lambda: None,)):
        with pytest.raises(ValueError, match="exactly one"):
            T.make_remote_engine_factory(*bad, **({"link_factory": (lambda: None)} if bad else {}))
    params = tb.init_params(torch.Generator().manual_seed(0), TCFG)

    def engine():
        return tp.PagedServeEngine(params=params, cfg=TCFG, device="cpu", **PAGED)

    want = _by_prompt(engine().pump([dict(r) for r in REQS]))
    factory = T.make_remote_engine_factory(lambda: tfleet.FleetRouter([engine()]), n_slots=3,
                                           link_kwargs=dict(liveness_timeout_s=60.0))
    remote = factory()
    assert remote.name == "rworker-1" and isinstance(remote, T.RemoteWorkerEngine)
    assert remote.restore({"next_id": 2 * tfleet.ID_STRIDE, "requests": []}) == []
    done = remote.pump([dict(r) for r in REQS])
    assert _by_prompt(done) == want
    assert sorted(c.request_id for c in done) == [2 * tfleet.ID_STRIDE + i for i in range(5)]
    stats = remote.stats()
    assert list(vars(stats)) == [f.name for f in dataclasses.fields(jtel.EngineStats)]
    assert (stats.completed, stats.resident_slots, stats.free_slots) == (5, 0, 3)


# -- worker processes under the port's own supervisor -------------------------------------

CFG_DOC = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq=64,
               dtype="float32")
TCFG = tb.ModelConfig(**dict(CFG_DOC, dtype=torch.float32))
PAGED = dict(n_slots=3, n_blocks=41, block_size=4, prompt_bucket=16)
REQS = [
    {"prompt": [7, 8, 9], "max_tokens": 6, "seed": 5},
    {"prompt": [3, 4], "max_tokens": 6, "seed": 9},
    {"prompt": [11, 12, 13, 14], "max_tokens": 6, "seed": 21},
    {"prompt": [1, 2], "max_tokens": 6, "seed": 33},
    {"prompt": [21, 22, 23], "max_tokens": 6, "seed": 44},
]


def _by_prompt(completions):
    return {tuple(c.tokens[: len(c.tokens) - len(c.generated)]): tuple(c.generated)
            for c in completions}


def test_port_hub_drives_two_port_workers_behind_the_port_router(tmp_path):
    """A port ``TransportHub``, a prefill and a decode worker process
    (``--device cpu``), a ``RemotePool`` per link and a port
    ``DisaggRouter`` with a ``TransportChannel``: every request completes
    once, every KV frame ACKs ok, and the streams are those of the port
    router over in-process port engines of the same seed's weights."""
    params = tb.init_params(torch.Generator().manual_seed(0), TCFG)
    local = td.DisaggRouter(
        prefill=[tp.PagedServeEngine(params=params, cfg=TCFG, device="cpu", **PAGED)],
        decode=[tp.PagedServeEngine(params=params, cfg=TCFG, device="cpu", **PAGED)])
    want = _by_prompt(local.pump([dict(r) for r in REQS]))
    hub = T.TransportHub(heartbeat_interval_s=0.1, liveness_timeout_s=60.0, ack_timeout_s=30.0)
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), OMP_NUM_THREADS="2")
    env.pop("DRA_FAULTS", None)
    procs = {}
    try:
        for role in ("prefill", "decode"):
            path = tmp_path / f"{role}.json"
            path.write_text(json.dumps({
                "cfg": CFG_DOC, "engines": [dict(PAGED, kind="paged")], "seed": 0,
                "host": "127.0.0.1", "port": hub.port, "name": f"{role}-w", "role": role,
                "telem_interval_s": 0.1}))
            procs[role] = subprocess.Popen(
                [sys.executable, "-m", "k8s_dra_driver_torch.models.transport", str(path),
                 "--device", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True, env=env, cwd=REPO_ROOT)
        links = {role: hub.link_for(f"{role}-w", timeout_s=90.0) for role in procs}
        for role, proc in procs.items():
            assert json.loads(proc.stdout.readline()) == {"ready": True, "pid": proc.pid}
        channel = T.TransportChannel(links["decode"], claim=td.ChannelClaim(
            bandwidth_gbps=1000.0, transfer_deadline_s=10.0))
        router = td.DisaggRouter(prefill=T.RemotePool(links["prefill"], name="prefill-pool"),
                                 decode=T.RemotePool(links["decode"], name="decode-pool"),
                                 channel=channel)
        for r in REQS:
            router.submit(r["prompt"], r["max_tokens"], seed=r["seed"])
        done, deadline = [], time.monotonic() + 90.0
        while len(done) < len(REQS) and time.monotonic() < deadline:
            hub.poll()
            router.tick()
            done += router.completions()
            time.sleep(0.002)
        assert len(done) == len(REQS) and len({c.request_id for c in done}) == len(REQS)
        assert _by_prompt(done) == want
        assert channel.counts == {"ok": len(REQS)} and router.fallbacks == 0
        assert router.handoffs == len(REQS)
        doc = T.debug_transport_doc()
        assert {p["name"] for p in doc["remote_pools"]} >= {"prefill-pool", "decode-pool"}
        assert set(tobs.FLEET.stats()["instances"]) <= {"prefill-w", "decode-w"}
    finally:
        hub.close()
        for link in hub.links.values():
            link.conn.close()
        for proc in procs.values():
            try:
                proc.communicate(timeout=60)
            finally:
                proc.kill()
    assert [p.returncode for p in procs.values()] == [0, 0]
