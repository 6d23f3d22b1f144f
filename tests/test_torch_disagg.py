"""The port's disaggregated router (``k8s_dra_driver_torch/models/disagg.py``)
against the reference's (``k8s_dra_driver_tpu/models/disagg.py``), on the
CPU.

* ``DisaggRouter`` over port paged engines and the reference's over JAX
  paged engines, on ``bench.py``'s disaggregated mix (``_disagg_benchmark_cpu``:
  long prompts queued ahead of short ones, 2 prefill and 2 decode engines)
  at ``TINY`` in float32 with the JAX weights carried across: clean, under
  one fault seed arming drop, corrupt, latency over the deadline and
  ``channel_down`` on a two-link ``ChannelSet``, and on a decode pool too
  small for the mix (the KV-demand ledger parks handoffs).  Streams,
  handoffs, fallbacks by reason, channel outcomes, the fallen-back request
  ids and the router's stats are equal; every paged pool ends where it
  started.
* ``ChannelClaim``/``ChannelSet`` from the same daemon-info documents: the
  same claims, ``to_json``, picks and fail-over.
* The channel's in-flight budget and deadline, and the admission ledger
  (``_full_demand_blocks``, ``reserve_pull``), on the same inputs.
* Every public top-level name of the reference's ``disagg.py``,
  ``transport.py`` and ``obs_plane.py`` has a port counterpart.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import disagg as td
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models import serve as ts
from k8s_dra_driver_torch.models.weights import params_from_jax
from k8s_dra_driver_torch.utils import faults as tf
from k8s_dra_driver_torch.utils import journal as tj
from k8s_dra_driver_torch.utils import metrics as tm
from k8s_dra_driver_torch.utils import watchdog as tw
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import disagg as jd
from k8s_dra_driver_tpu.models import paged as jp
from k8s_dra_driver_tpu.models import serve as js
from k8s_dra_driver_tpu.utils import faults as jf
from k8s_dra_driver_tpu.utils import journal as jj
from k8s_dra_driver_tpu.utils import metrics as jm
from k8s_dra_driver_tpu.utils import watchdog as jw

REPO = Path(__file__).resolve().parent.parent
JCFG = jb.ModelConfig(dtype=jnp.float32)  # TINY, in float32
TCFG = tb.ModelConfig.from_reference(JCFG)
# bench.py's _disagg_benchmark_cpu: its mix, its engines, its pool sizes
MIX = dict(n_long=6, long_prompt=48, long_tokens=200, n_short=8, short_prompt=8, short_tokens=4)
ENGINE = dict(block_size=4, prompt_bucket=64, sync_interval=4, prefill_chunk_blocks=2)
POOLS = {"prefill": (2, 33), "decode": (2, 129)}
# (prefill, decode, decode engines) where a scenario changes them:
# "tight", two long streams at full growth fill a decode engine, so
# handoffs park; "deadlock", the one decode engine cannot hold one (60
# blocks against 62), so the parked handoffs collapse onto a prefill pool
# that holds them (the scenario's traffic is DEADLOCK_MIX:
# two longs, four shorts)
DEADLOCK_MIX = slice(4, 10)
SCENARIO_POOLS = {"tight": ((2, 33), (2, 125), 2), "deadlock": ((2, 129), (2, 61), 1)}
PKG = {
    "jax": dict(disagg=jd, faults=jf, journal=jj.JOURNAL, registry=jm.REGISTRY, parse=jm.parse_prom_text),
    "port": dict(disagg=td, faults=tf, journal=tj.JOURNAL, registry=tm.REGISTRY, parse=tm.parse_prom_text),
}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module, restored afterwards: the
    suite's other workers keep their cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _fresh_state():
    for pkg in PKG.values():
        pkg["registry"].reset()
        pkg["journal"].clear()
    yield


@pytest.fixture(scope="module")
def weights():
    jparams = jb.init_params(jax.random.PRNGKey(11), JCFG)
    return jparams, params_from_jax(jparams, device="cpu")


@pytest.fixture(scope="module")
def mix():
    def tokens_for(seed, n):
        return [int(t) for t in jb.sample_tokens(jax.random.PRNGKey(seed), JCFG, batch=1, seq=n)[0]]

    longs = [tokens_for(100 + i, MIX["long_prompt"]) for i in range(MIX["n_long"])]
    shorts = [tokens_for(200 + i, MIX["short_prompt"]) for i in range(MIX["n_short"])]
    return ([{"prompt": p, "max_tokens": MIX["long_tokens"]} for p in longs]
            + [{"prompt": p, "max_tokens": MIX["short_tokens"]} for p in shorts])


def _engine(weights, pkg, n_slots, n_blocks):
    jparams, tparams = weights
    if pkg == "jax":
        return jp.PagedServeEngine(params=jparams, cfg=JCFG, n_slots=n_slots, n_blocks=n_blocks,
                                   attn_impl="xla", cache_dtype=jnp.float32, **ENGINE)
    return tp.PagedServeEngine(params=tparams, cfg=TCFG, n_slots=n_slots, n_blocks=n_blocks,
                               device="cpu", cache_dtype=torch.float32, **ENGINE)


def _fault_injector(pkg):
    """One seed, four profiles: drops at 0.2 and corruptions at 0.3 (two
    each at most), one transfer 1 s over its 0.25 s deadline, and the
    faster link killed once.  Seed 24 makes every kind act."""
    faults = PKG[pkg]["faults"]
    inj = faults.FaultInjector(seed=24)
    for kw in (dict(name="drop", handoff_drop_rate=0.2, limit=2),
               dict(name="corrupt", handoff_corrupt_rate=0.3, limit=2),
               dict(name="late", handoff_latency_s=1.0, limit=1),
               dict(name="down", channel_down_rate=1.0, channels=("ici-1",), limit=1)):
        inj.arm(faults.FaultProfile(**kw))
    return inj


def _run(weights, mix, pkg, scenario):
    d = PKG[pkg]["disagg"]
    pools = SCENARIO_POOLS.get(scenario, (POOLS["prefill"], POOLS["decode"], 2))
    pre = [_engine(weights, pkg, *pools[0]) for _ in range(2)]
    dec = [_engine(weights, pkg, *pools[1]) for _ in range(pools[2])]
    kw = {}
    if scenario == "faulted":
        kw = dict(channel=[d.ChannelClaim(name="ici-0"),
                           d.ChannelClaim(name="ici-1", bandwidth_gbps=200.0)],
                  fault_injector=_fault_injector(pkg))
    router = d.DisaggRouter(prefill=pre, decode=dec, **kw)
    if scenario == "deadlock":
        mix = mix[DEADLOCK_MIX]
    done = router.pump([dict(r) for r in mix])
    events = PKG[pkg]["journal"].tail(10_000, component="disagg")
    fell_back = sorted(int(e["correlation"].split("-")[1]) for e in events
                       if e["event"] == "handoff.fallback")
    parked = [int(e["correlation"].split("-")[1]) for e in events
              if e["event"] == "admission.parked"]
    metrics = PKG[pkg]["parse"](PKG[pkg]["registry"].render())
    by_reason = {dict(k)["reason"]: int(v)
                 for k, v in metrics.get("tpu_disagg_fallback_total", {}).items()}
    outcomes = {dict(k)["outcome"]: int(v)
                for k, v in metrics.get("tpu_disagg_transfers_total", {}).items()}
    stats = router.stats()
    leak = [e.n_blocks - 1 - e.free_blocks for e in pre + dec]
    return dict(
        streams=sorted((c.request_id, tuple(c.tokens), tuple(c.generated), c.status)
                       for c in done),
        handoffs=router.handoffs, fallbacks=router.fallbacks, by_reason=by_reason,
        outcomes=outcomes, counts=dict(router.channel.counts), fell_back=fell_back, parked=parked,
        staged=stats["staged"], admission=stats["admission"], leak=leak,
        deadlock_fired=router.deadlock_fired,
        channel={k: v for k, v in router.channel.stats().items() if k != "channels"},
    )


@pytest.mark.parametrize("scenario", ["clean", "faulted", "tight", "deadlock"])
def test_router_over_port_engines_equals_the_reference(weights, mix, scenario, tmp_path,
                                                       monkeypatch):
    """The same mix through both routers: every field equal, every
    request completed once, every pool back where it started."""
    for pkg, watchdog in (("jax", jw.WATCHDOG), ("port", tw.WATCHDOG)):  # the deadlock's bundles
        monkeypatch.setattr(watchdog, "_bundle_dir", str(tmp_path / pkg))
    got = {pkg: _run(weights, mix, pkg, scenario) for pkg in PKG}
    assert got["port"] == got["jax"]
    if scenario == "deadlock":
        mix = mix[DEADLOCK_MIX]
    run = got["port"]
    assert len(run["streams"]) == len(mix) and {s[3] for s in run["streams"]} == {"ok"}
    assert run["handoffs"] == len(mix) and set(run["leak"]) == {0}
    if scenario == "faulted":
        # each fault kind acted, and the dead link's transfer failed over
        assert run["by_reason"] == {"dropped": 2, "corrupt": 2, "deadline": 1}
        assert run["fallbacks"] == len(run["fell_back"]) == 5
        assert run["channel"]["failovers"] == 1 and run["counts"]["channel_down"] == 1
    elif scenario == "tight":
        assert run["parked"] and run["fallbacks"] == 0
    elif scenario == "deadlock":
        assert run["deadlock_fired"] >= 1 and run["by_reason"] == {"deadlock_collapse": 2}
        for pkg in PKG:
            assert list((tmp_path / pkg).glob("diag-bundle-*.json"))
    elif scenario == "clean":
        assert run["fallbacks"] == 0 and run["counts"] == {"ok": len(mix)}


def test_handoff_fault_grammar_decides_as_the_reference():
    """One ``DRA_FAULTS`` spec of the handoff and link kinds armed in each
    package: the same decisions hook by hook over 40 transfers and link
    consults, the same counts."""
    spec = ("handoff_drop=0.2,handoff_corrupt=0.3,handoff_latency_ms=40,channel_down=0.25,"
            "channel_degrade=0.5,channels=ici-1,limit=30,seed=13")
    runs = {}
    for pkg in PKG:
        inj, seen = PKG[pkg]["faults"].FaultInjector.from_env(spec), []
        for rid in range(40):
            seen.append((round(inj.take_handoff_latency(), 9), inj.take_handoff_drop(rid),
                         inj.take_handoff_corrupt(rid), inj.take_channel_down("ici-0"),
                         inj.take_channel_down("ici-1"), inj.channel_bandwidth_factor("ici-1"),
                         inj.channel_bandwidth_factor("ici-0")))
        runs[pkg] = (seen, inj.stats())
    assert runs["port"] == runs["jax"]
    assert sum(runs["port"][1].values()) == 30


DAEMON_DOCS = {
    "multi": {"channels": [
        {"name": "ici-0", "bandwidth_gbps": 100.0, "max_in_flight_bytes": 4096},
        {"name": "ici-1", "bandwidth_gbps": 400.0, "transfer_deadline_s": 0.5},
        {"name": "dead", "bandwidth_gbps": 0.0},
    ]},
    "single": {"channel": {"name": "ici-9", "bandwidth_gbps": 25.0}},
    "none": {},
    "empty_list_falls_back": {"channels": [], "channel": {"name": "solo"}},
}


@pytest.mark.parametrize("doc", sorted(DAEMON_DOCS))
def test_channel_claims_from_daemon_info(doc):
    """The same claims (``to_json``) and the same best pick from each
    daemon-info document; duplicate names raise in both."""
    claims = {pkg: PKG[pkg]["disagg"].ChannelClaim.all_from_daemon_info(DAEMON_DOCS[doc])
              for pkg in PKG}
    assert [c.to_json() for c in claims["port"]] == [c.to_json() for c in claims["jax"]]
    best = {pkg: PKG[pkg]["disagg"].ChannelClaim.from_daemon_info(DAEMON_DOCS[doc]) for pkg in PKG}
    assert (best["port"] and best["port"].to_json()) == (best["jax"] and best["jax"].to_json())
    dupes = {"channels": [{"name": "a"}, {"name": "a"}]}
    for pkg in PKG:
        with pytest.raises(ValueError, match="duplicate channel names"):
            PKG[pkg]["disagg"].ChannelClaim.all_from_daemon_info(dupes)


class _Payload:
    """What a channel reads of a KV payload: its checksum."""

    def __init__(self, crc):
        self.crc = crc

    def checksum(self):
        return self.crc


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.01
        return self.t


def _set_trace(pkg, down_rate):
    """A three-link set: begin transfers of several sizes (the picks), kill
    the busiest link mid-transfer once (the fail-over), resolve each."""
    d, faults = PKG[pkg]["disagg"], PKG[pkg]["faults"]
    inj = faults.FaultInjector(seed=3)
    inj.arm(faults.FaultProfile(name="down", channel_down_rate=down_rate, limit=2))
    claims = d.ChannelClaim.all_from_daemon_info(DAEMON_DOCS["multi"]) + (
        d.ChannelClaim(name="ici-2", bandwidth_gbps=50.0, max_in_flight_bytes=1 << 20),)
    cset = d.ChannelSet(claims, peer="decode", fault_injector=inj, clock=_Clock())
    trace = []
    begun = []
    for rid, nbytes in enumerate((1024, 3000, 50_000, 2_000_000, 900, 70 * 2**20)):
        trace.append(("fits", nbytes, cset.fits(nbytes)))
        t = cset.begin(rid, nbytes, crc=rid)
        trace.append(("begin", rid, None if t is None else t.channel))
        if t is not None:
            begun.append(t)
    for t in begun:
        crc = t.crc if t.request_id != 1 else 99  # one payload arrives corrupt
        trace.append(("complete", t.request_id, cset.complete(t, _Payload(crc)), t.channel))
    cset.refuse(7, 70 * 2**20, "exceeds channel budget")
    trace.append(("down", cset.down, cset.counts, cset.failovers))
    trace.append(("stats", cset.stats()))
    return trace


@pytest.mark.parametrize("down_rate", [0.0, 0.5, 1.0])
def test_channel_set_picks_and_fails_over(down_rate):
    """The same picks, outcomes, fail-overs, breaker states and stats."""
    assert _set_trace("port", down_rate) == _set_trace("jax", down_rate)


def _channel_trace(pkg, latency_s):
    """One link at a 10 kB budget: the budget refuses, a fitting transfer
    waits for room, the accounted latency decides the deadline."""
    d, faults = PKG[pkg]["disagg"], PKG[pkg]["faults"]
    inj = faults.FaultInjector(seed=1)
    inj.arm(faults.FaultProfile(name="late", handoff_latency_s=latency_s, limit=1))
    ch = d.HandoffChannel(d.ChannelClaim(bandwidth_gbps=0.001), max_in_flight_bytes=10_000,
                          transfer_deadline_s=0.05, fault_injector=inj, clock=_Clock())
    trace = [ch.fits(10_001), ch.fits(10_000)]
    a = ch.begin(1, 6000, 1)
    trace += [a is not None, ch.begin(2, 5000, 2), ch.in_flight_bytes]
    trace += [ch.complete(a, _Payload(1)), a.latency_s, ch.in_flight_bytes]
    b = ch.begin(2, 5000, 2)
    trace += [ch.complete(b, _Payload(2)), b.latency_s]
    c = ch.begin(3, 1, 3)
    trace += [ch.complete(c, _Payload(3)), ch.counts, ch.bytes_moved]
    ch.refuse(4, 20_000, "too big")
    trace.append(ch.stats())
    return trace


@pytest.mark.parametrize("latency_s", [0.0, 1.0])
def test_channel_budget_and_deadline(latency_s):
    assert _channel_trace("port", latency_s) == _channel_trace("jax", latency_s)


ENTRIES = [
    {"request_id": 0, "tokens": list(range(9)), "prompt_len": 8, "max_tokens": 20},
    {"request_id": 1, "tokens": list(range(30)), "prompt_len": 30, "max_tokens": 0},
    {"request_id": 2, "tokens": list(range(5)), "max_tokens": 3},
    {"request_id": 3, "tokens": list(range(40)), "prompt_len": 4, "max_tokens": 2},
]


def _ledger_trace(weights, pkg):
    d = PKG[pkg]["disagg"]
    dec = [_engine(weights, pkg, 2, 17), _engine(weights, pkg, 2, 9)]
    router = d.DisaggRouter(prefill=[_engine(weights, pkg, 2, 9)], decode=dec)
    trace = [router._decode_block_size(), router._decode_headroom_blocks()]
    trace += [router._full_demand_blocks(e) for e in ENTRIES]
    for e in ENTRIES:
        trace.append(router._admit_handoff({"entry": dict(e)}))
    trace += [router.reserve_pull(5, 3), router.reserve_pull(6, 40), router._decode_headroom_blocks()]
    router.release_pull(5)
    trace += [dict(router._ledger), router._decode_headroom_blocks(), router.stats()["admission"]]
    return trace


def test_admission_ledger(weights):
    """``_full_demand_blocks`` and ``full_stream_tokens``, the headroom,
    ``_admit_handoff`` and ``reserve_pull``/``release_pull`` on the same
    entries and engines."""
    assert _ledger_trace(weights, "port") == _ledger_trace(weights, "jax")
    assert [ts.full_stream_tokens(e) for e in ENTRIES] == [js.full_stream_tokens(e) for e in ENTRIES]


def _public_names(path: Path) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("module", ["disagg", "transport", "obs_plane"])
def test_every_public_name_has_a_port_counterpart(module):
    ref = _public_names(REPO / "k8s_dra_driver_tpu" / "models" / f"{module}.py")
    port = _public_names(REPO / "k8s_dra_driver_torch" / "models" / f"{module}.py")
    assert sorted(ref - port) == []
