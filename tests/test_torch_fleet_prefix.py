"""The port's fleet prefix tier (``k8s_dra_driver_torch/models/fleet_prefix.py``:
``FleetPrefixIndex``, ``LocalPrefixSource``, ``RemotePrefixSource``,
``FleetPrefixTier``) against the reference's, on the CPU in float32 with the
JAX weights carried across (``weights.params_from_jax``).

* Index semantics, op for op on a shared ``SimClock``: publish and
  ``survey``/``deepest`` depths, TTL on read and by sweep, LRU eviction that
  skips pins, ``invalidate_owner`` while pinned, epoch fences, anti-entropy
  digests, ``ledger()``.
* Gossip: the port worker's ``PrefixGossip`` frames ingest into both tiers
  alike; a corrupt frame drops whole in both.
* ``LocalPrefixSource``: each package's tier and ``FleetRouter`` over its own
  engines (port paged or dense, JAX paged or dense): the same local hit,
  remote pull, drain invalidation and cold admission, with the same tier
  counts, fallbacks, ledger and streams; a corrupt export falls back cold in
  both.  The router's placement order and ``survey`` depths are compared on
  the way.
* ``RemotePrefixSource`` of each package against a port ``PoolWorker`` over a
  socket pair: the ``PREFIXKV`` body's wire bytes are the local export's
  frame byte for byte; a ``PREFIXMISS`` reason and an epoch-fenced miss as
  the reference's.
* ``pull_gate`` = each package's ``DisaggRouter.reserve_pull``, answering
  True (a paged decode pool with room), False (over demand) and None (a
  dense pool: unaccountable), with the same outcomes, fallbacks and ledger.
"""

import socket

import jax
import jax.numpy as jnp
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import disagg as td
from k8s_dra_driver_torch.models import fleet as tfleet
from k8s_dra_driver_torch.models import fleet_prefix as tfp
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models import serve as ts
from k8s_dra_driver_torch.models import transport as tt
from k8s_dra_driver_torch.models import workload as tw
from k8s_dra_driver_torch.models.weights import params_from_jax
from k8s_dra_driver_torch.utils import journal as tj
from k8s_dra_driver_torch.utils import metrics as tm
from k8s_dra_driver_torch.utils import tracing as ttr
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import disagg as jd
from k8s_dra_driver_tpu.models import fleet as jfleet
from k8s_dra_driver_tpu.models import fleet_prefix as jfp
from k8s_dra_driver_tpu.models import paged as jp
from k8s_dra_driver_tpu.models import serve as js
from k8s_dra_driver_tpu.models import transport as jt
from k8s_dra_driver_tpu.models import workload as jw
from k8s_dra_driver_tpu.utils import journal as jj
from k8s_dra_driver_tpu.utils import metrics as jm

PKG = {
    "reference": dict(fp=jfp, fleet=jfleet, disagg=jd, transport=jt, w=jw, serve=js,
                      journal=jj.JOURNAL, registry=jm.REGISTRY, parse=jm.parse_prom_text),
    "port": dict(fp=tfp, fleet=tfleet, disagg=td, transport=tt, w=tw, serve=ts,
                 journal=tj.JOURNAL, registry=tm.REGISTRY, parse=tm.parse_prom_text),
}
JCFG = jb.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq=64,
                      dtype=jnp.float32)
TCFG = tb.ModelConfig.from_reference(JCFG)
BS = 4
PAGED = dict(n_slots=3, n_blocks=64, block_size=BS, prompt_bucket=16, prefix_cache_blocks=24)
DENSE = dict(n_slots=2, prompt_bucket=32, prefix_bucket=16, prefix_cache_entries=4)
PROMPTS = {"paged": list(range(1, 15)), "dense": list(range(1, 21))}


@pytest.fixture(autouse=True)
def _fresh_state():
    for pkg in PKG.values():
        pkg["registry"].reset()
        pkg["journal"].clear()
    yield


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def weights():
    jparams = jb.init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, params_from_jax(jparams, device="cpu")


def _engine(weights, pkg, kind, **kw):
    jparams, tparams = weights
    kw = dict(PAGED if kind == "paged" else DENSE, **kw)
    if pkg == "reference":
        kw["cache_dtype"] = jnp.float32
        if kind == "paged":
            return jp.PagedServeEngine(params=jparams, cfg=JCFG, attn_impl="xla", **kw)
        return js.ServeEngine(params=jparams, cfg=JCFG, **kw)
    kw["cache_dtype"] = torch.float32
    cls = tp.PagedServeEngine if kind == "paged" else ts.ServeEngine
    return cls(params=tparams, cfg=TCFG, device="cpu", **kw)


def _run(eng, prompt, max_tokens=6, seed=3):
    (c,) = eng.pump([{"prompt": list(prompt), "max_tokens": max_tokens, "seed": seed}])
    assert c.status == "ok"
    return tuple(c.generated)


# -- the index -----------------------------------------------------------------------------

def _ev(key="k1", n_tokens=8, **kw):
    ev = {"key": key, "n_tokens": n_tokens, "block_size": BS, "kv_dtype": "float32",
          "n_layers": 1, "kv_heads": 2, "head_dim": 16, "adapter": 0, "blocks": 2}
    ev.update(kw)
    return ev


def _geom(**kw):
    return dict(dict(block_size=BS, kv_dtype="float32", n_layers=1, kv_heads=2, head_dim=16), **kw)


def _entry(e):
    return None if e is None else (e.key, e.owner, e.n_tokens, e.blocks, e.pins, e.dead, e.epoch,
                                   e.expires_at)


def _ledger(idx):
    led = idx.ledger()
    return (dict(led.blocks), led.entries, led.pinned)


def _index_script(fp, w, scenario):
    """One scenario of index operations; returns everything observed."""
    clock = w.SimClock()
    idx = fp.FleetPrefixIndex(clock=clock, ttl_s=10.0, max_entries=4)
    toks = list(range(1, 30))
    out = []
    if scenario == "publish_survey":
        for d in (4, 8, 12):
            out.append(_entry(idx.publish(tuple(toks[:d]), "A", n_tokens=d, **_geom())))
        out.append(_entry(idx.publish(tuple(toks[:8]), "B", n_tokens=8, **_geom(blocks=2))))
        chain = idx.chain_for_tokens(toks[:14])
        out += [chain, idx.survey(chain), _entry(idx.deepest(chain)),
                _entry(idx.deepest(chain, compatible=lambda e: e.owner == "B")),
                idx.block_sizes(), idx.withdraw(tuple(toks[:12]), owner="B"),
                idx.withdraw(tuple(toks[:12]), owner="A"), idx.survey(chain)]
    elif scenario == "ttl":
        idx.publish(tuple(toks[:4]), "A", n_tokens=4, **_geom())
        clock.advance(6.0)
        idx.publish(tuple(toks[:8]), "A", n_tokens=8, **_geom())
        idx.publish(tuple(toks[:4]), "B", n_tokens=4, **_geom())  # refresh: owner moves
        clock.advance(6.0)
        chain = idx.chain_for_tokens(toks[:14])
        out += [idx.survey(chain), _ledger(idx), idx.sweep()]
        clock.advance(5.0)
        out += [idx.sweep(), len(idx), idx.evicted_total]
    elif scenario == "lru_pins":
        for i in range(4):
            idx.publish(("m", i), "A", n_tokens=4, **_geom())
        out.append(idx.pin(fp.prefix_digest(("m", 0))))
        for i in range(4, 7):
            idx.publish(("m", i), "B", n_tokens=4, **_geom())
        out += [sorted(e.key for e in idx._entries.values()), _ledger(idx)]
        idx.unpin(fp.prefix_digest(("m", 0)))
        out += [_ledger(idx), idx.published_total, idx.evicted_total]
    elif scenario == "invalidate_pinned":
        for i in range(3):
            idx.publish(("m", i), "A", n_tokens=4, **_geom())
        idx.publish(("m", 9), "B", n_tokens=4, **_geom())
        key = fp.prefix_digest(("m", 1))
        out += [idx.pin(key), idx.pin(key), idx.invalidate_owner("A"), _ledger(idx),
                idx.pin(key)]
        idx.unpin(key)
        out.append(_ledger(idx))
        idx.unpin(key)
        out += [_ledger(idx), idx.evicted_total]
    elif scenario == "epochs":
        out += [idx.ingest_publish("W", 2, _ev(key="a")),
                idx.ingest_publish("W", 1, _ev(key="b")),
                idx.ingest_publish("W", 2, _ev(key="c", n_tokens=12)),
                idx.ingest_publish("X", 1, _ev(key="d")),
                idx.ingest_withdraw("X", 1, {"key": "a"}),
                idx.ingest_withdraw("W", 1, {"key": "a"}),
                idx.set_owner_epoch("W", 3), sorted(idx._entries), dict(idx.owner_epoch),
                idx.ingest_publish("W", 3, _ev(key="e")),
                idx.ingest_digest("X", 1, [_ev(key="f"), _ev(key="g")]),
                idx.ingest_digest("W", 2, [_ev(key="h")]),
                sorted(idx._entries), idx.fenced_total]
        ent = idx._entries["e"]
        idx.owner_epoch["W"] = 4
        out += [idx.epoch_ok(ent), _ledger(idx)]
    return out


@pytest.mark.parametrize("scenario", ["publish_survey", "ttl", "lru_pins", "invalidate_pinned",
                                      "epochs"])
def test_index_semantics_equal(scenario):
    ref = _index_script(jfp, jw, scenario)
    port = _index_script(tfp, tw, scenario)
    assert port == ref
    reg = {n: p["parse"](p["registry"].render()) for n, p in PKG.items()}
    fams = [k for k in reg["reference"] if k.startswith("tpu_fleet_prefix")]
    assert fams and {k: reg["port"].get(k) for k in fams} == {k: reg["reference"][k] for k in fams}


# -- gossip --------------------------------------------------------------------------------

def test_port_gossip_frames_ingest_alike(weights):
    """A port paged engine's store and evict hooks feed the port worker's
    ``PrefixGossip``; its frames (publishes, withdraws, a full digest after a
    resync, one corrupted) ingest into both tiers to the same index."""
    frames = []
    gossip = tfp.PrefixGossip(lambda kind, body: frames.append((kind, body)))
    eng = _engine(weights, "port", "paged", prefix_cache_blocks=3)
    gossip.bind_engine(eng)
    _run(eng, list(range(1, 15)))
    gossip.maybe_ship(force=True)
    _run(eng, list(range(30, 44)))  # evicts the first prompt's blocks
    gossip.maybe_ship(force=True)
    gossip.resync(2)
    gossip.maybe_ship(force=True)
    good = frames[0][1]
    frames.insert(1, ("pub", good[:-1] + bytes([good[-1] ^ 1])))
    seen = {}
    for name, pkg in PKG.items():
        clock = pkg["w"].SimClock()
        tier = pkg["fp"].FleetPrefixTier(pkg["fp"].FleetPrefixIndex(clock=clock), clock=clock)
        applied = [tier._ingest_pub("W", b) if k == "pub" else tier._ingest_wdl("W", b)
                   for k, b in frames]
        seen[name] = (applied, sorted(_entry(e) for e in tier.index._entries.values()),
                      _ledger(tier.index), dict(tier.index.owner_epoch), tier.gossip_decode_drops)
    assert seen["port"] == seen["reference"]
    applied, entries, _, epochs, drops = seen["port"]
    assert drops == 1 and epochs == {"W": 2} and len(entries) == 3 and sum(applied) > 3


# -- the tier over engines: LocalPrefixSource ----------------------------------------------

def _drain_engines(*engines, steps=400):
    out = []
    for _ in range(steps):
        for eng in engines:
            eng.step()
            out.extend(eng.completions())
        if all(e.free_slots() == e.n_slots for e in engines):
            return out
    raise AssertionError("engines did not drain")


def _tier_scenario(weights, pkg, kind, corrupt=False):
    """A and B behind a FleetRouter with the tier: A warms the prompt, the
    router sends it home (local hit), A's slots fill and B pulls it (remote,
    or a cold fallback when A's export is corrupted), A drains and the
    prompt goes cold."""
    m = PKG[pkg]
    clock = m["w"].SimClock()
    a, b = _engine(weights, pkg, kind), _engine(weights, pkg, kind)
    router = m["fleet"].FleetRouter([("A", a), ("B", b)], clock=clock)
    tier = m["fp"].FleetPrefixTier(m["fp"].FleetPrefixIndex(clock=clock), clock=clock)
    router.attach_prefix_tier(tier)
    if corrupt:
        export = a.export_prefix_kv

        class _Corrupt:
            def __init__(self, kv):
                self.kv = kv

            def to_wire(self, nonce):
                wire = bytearray(self.kv.to_wire(nonce))
                wire[-3] ^= 0x40
                return bytes(wire)

        a.export_prefix_kv = lambda *x, **kw: _Corrupt(export(*x, **kw))
    prompt = PROMPTS[kind]
    out = {"warm": _run(a, prompt)}
    chain = tier.index.chain_for_tokens(prompt)
    out["survey"] = tier.index.survey(chain)
    out["order"] = [r.name for r in router._candidates(prompt, 0, {})]
    out["ledger0"] = _ledger(tier.index)
    router.submit(prompt, 6, seed=3)
    out["home"] = sorted(tuple(c.generated) for c in _drain_engines(a, b))
    for i in range(a.n_slots):
        a.submit([40 + i, 41 + i, 42 + i], max_tokens=4, seed=3)
    out["order_full"] = [r.name for r in router._candidates(prompt, 0, {})]
    router.submit(prompt, 6, seed=3)
    out["pulled"] = sorted((tuple(c.tokens), tuple(c.generated))
                           for c in _drain_engines(a, b))
    out["b_depth"] = b.local_prefix_depth(prompt)
    out["counts1"] = dict(tier.counts)
    out["ledger1"] = _ledger(tier.index)
    router.drain("A")
    router.tick()
    out["ledger2"] = _ledger(tier.index)
    router.submit(list(range(30, 30 + len(prompt))), 6, seed=3)
    out["cold"] = [tuple(c.generated) for c in _drain_engines(a, b)]
    out["counts"], out["fallbacks"] = dict(tier.counts), dict(tier.fallbacks)
    out["ledger"] = _ledger(tier.index)
    if kind == "paged":  # no block leaked: free + stored = the pool less the null block
        out["balanced"] = [e.free_blocks + sum(len(s) for s in e._prefix_stores) == e.n_blocks - 1
                           for e in (a, b)]
    reg = m["parse"](m["registry"].render())
    out["metrics"] = {k: v for k, v in reg.items()
                      if k.startswith("tpu_fleet_prefix") and "seconds" not in k}
    return out


@pytest.mark.parametrize("kind,corrupt", [("paged", False), ("dense", False), ("paged", True)],
                         ids=["paged", "dense", "paged_corrupt_export"])
def test_tier_over_engines_as_the_reference(weights, kind, corrupt):
    ref = _tier_scenario(weights, "reference", kind, corrupt)
    port = _tier_scenario(weights, "port", kind, corrupt)
    assert port == ref
    assert ref.get("balanced", [True]) == [True] * len(ref.get("balanced", [True]))
    assert ref["counts1"]["local"] == 1 and ref["order"][0] == "A"
    assert ref["ledger2"][0].get("A") is None
    warm = ref["warm"]
    assert [g for _, g in ref["pulled"] if len(g) == 6] == [warm]
    # B holds the prefix either way: pulled, or stored by its own cold prefill
    assert ref["b_depth"] == (12 if kind == "paged" else 16)
    if corrupt:
        assert ref["counts1"]["remote"] == 0 and ref["fallbacks"] == {"miss": 1}
    else:
        assert ref["counts1"]["remote"] == 1


# -- RemotePrefixSource against a port worker ------------------------------------------------

def _remote_pulls(weights, pkg):
    """A port PoolWorker (one paged engine with a store, gossiping) on one
    end of a socket pair; ``pkg``'s link and RemotePrefixSource on the
    other.  Pulls: the stored prompt, a prompt it lacks, and after a
    ``prefix_resync`` to epoch 4, the stored prompt at a stale epoch."""
    m = PKG[pkg]
    T = m["transport"]
    near, far = socket.socketpair()
    router = tfleet.FleetRouter([_engine(weights, "port", "paged")])
    worker = tt.PoolWorker(tt.SocketConn(far, peer="supervisor"), router, role="decode",
                           name="w", traces=ttr.TraceBuffer(), prefix_gossip=True)
    link = T.PeerLink("w", T.SocketConn(near, peer="w"), heartbeat_interval_s=0.05,
                      liveness_timeout_s=60.0, ack_timeout_s=30.0)
    bodies = []
    take = link.take

    def spy(ftype):
        body = take(ftype)
        if body is not None and ftype == T.PREFIXKV:
            bodies.append(body)
        return body

    link.take = spy
    src = m["fp"].RemotePrefixSource("w", link, peer_pump=worker.pump_once, pull_timeout_s=30.0)
    eng = router.replicas[0].engine
    prompt = PROMPTS["paged"]
    warm = _run(eng, prompt)
    out = []
    try:
        kv = src.pull(prompt, max_tokens=6, nonce=7, epoch=0)
        local = eng.export_prefix_kv(prompt, max_tokens=6).to_wire(7)
        (body,) = bodies
        meta, wire = T.decode_meta_frame(body)
        out.append((meta, wire == local, kv.valid_len, src.last_miss_reason))
        out.append((src.pull([60, 61, 62, 63, 59, 58], nonce=8), src.last_miss_reason))
        link.send_json(T.CONTROL, {"op": "prefix_resync", "epoch": 4})
        worker.pump_once()
        out.append((src.pull(prompt, nonce=9, epoch=3), src.last_miss_reason))
        out.append((src.dead, src.available))
    finally:
        near.close()
        far.close()
    return out, warm


def test_remote_source_against_a_port_worker(weights):
    (ref, _), (port, _) = _remote_pulls(weights, "reference"), _remote_pulls(weights, "port")
    assert port == ref
    assert ref == [({"nonce": 7, "n_tokens": 12, "epoch": 0}, True, 12, None),
                   (None, "miss"), (None, "epoch"), (False, True)]


# -- the pull gate -------------------------------------------------------------------------

def _gated_pulls(weights, pkg, verdict):
    """B pulls A's prefix under a pull gate that is ``pkg``'s DisaggRouter:
    a paged decode pool with room (True), the same pool with its headroom
    reserved away first (False), a dense decode pool (None)."""
    m = PKG[pkg]
    clock = m["w"].SimClock()
    a, b = _engine(weights, pkg, "paged"), _engine(weights, pkg, "paged")
    tier = m["fp"].FleetPrefixTier(m["fp"].FleetPrefixIndex(clock=clock), clock=clock)
    tier.bind_engine("A", a)
    tier.bind_engine("B", b)
    prompt = PROMPTS["paged"]
    _run(a, prompt)
    dec = _engine(weights, pkg, "dense" if verdict is None else "paged")
    gate = m["disagg"].DisaggRouter(prefill=[_engine(weights, pkg, "paged")], decode=[dec],
                                    admission_control=True)
    if verdict is False:
        assert gate.reserve_pull(99, gate._decode_headroom_blocks()) is True
    tier.pull_gate = gate
    out = [tier.prepare("B", b, prompt, max_tokens=6), dict(tier.counts), dict(tier.fallbacks),
           b.local_prefix_depth(prompt), _ledger(tier.index), dict(gate._ledger)]
    if verdict is not None:
        out.append(gate._decode_headroom_blocks())
    reg = m["parse"](m["registry"].render())
    out.append(reg.get("tpu_fleet_prefix_pull_admission_total"))
    return out


@pytest.mark.parametrize("verdict", [True, False, None], ids=["admitted", "refused", "bypass"])
def test_pull_gate_over_reserve_pull(weights, verdict):
    ref, port = _gated_pulls(weights, "reference", verdict), _gated_pulls(weights, "port", verdict)
    assert port == ref
    want = {True: ("remote", "admitted"), False: ("cold", "refused"), None: ("remote", "bypass")}
    assert ref[0] == want[verdict][0]
    assert ref[-1] == {(("outcome", want[verdict][1]),): 1.0}
