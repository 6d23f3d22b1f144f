"""The engine protocol in the PyTorch port (``models/fleet.Engine``) and
port engines behind the JAX package's ``FleetRouter`` (which holds no
JAX), on the CPU, with the weights of the JAX engines
(``weights.params_from_jax``).

* Conformance: both port engines against the port's ``Engine`` and the
  reference's, by members, by signature (submit, restore, pump), by the
  terminal-status vocabulary and by ``stats()``, whose fields are the
  reference's ``EngineStats`` fields in order (``tests/test_fleet.py``'s
  matrix).
* A mixed fleet: a JAX replica and a torch replica behind one router
  serve every stream, greedy and sampled, token for token as a single
  JAX engine does (sampled tokens exactly, as in
  ``tests/test_torch_sampling.py``: a near tie that each library's ``log``
  would flip is reported with its request).
* Drain: ``FleetRouter.drain`` of either replica moves its streams into
  the other through ``snapshot_active``/``release_active``/``restore``,
  and every greedy stream continues bit for bit.
* The port's own ``FleetRouter`` against the reference's, each over its
  own pair of port engines (a paged and a dense replica): submit, drain,
  remove, shed, evacuate (an injected replica crash) and a ``DRA_FAULTS``
  replica wedge give the same completions, shed counts and ``stats()``
  but for clock readings and process-wide sequence numbers."""

import dataclasses
import inspect

import jax
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import fleet as tfleet
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models import serve as ts
from k8s_dra_driver_torch.models import telemetry as tt
from k8s_dra_driver_torch.models.weights import params_from_jax
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import fleet as jfleet
from k8s_dra_driver_tpu.models import paged as jp
from k8s_dra_driver_tpu.models import serve as js
from k8s_dra_driver_tpu.models import telemetry as jt
from k8s_dra_driver_tpu.models.fleet import DRAINED, FleetRouter
from k8s_dra_driver_tpu.utils import faults as jfaults
from k8s_dra_driver_torch.utils import faults as tfaults

JCFG = jb.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq=64)
TCFG = tb.ModelConfig.from_reference(JCFG)
PROTOCOLS = {"port": tfleet.Engine, "reference": jfleet.Engine}


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


def _dense(weights, pkg="port", **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("prompt_bucket", 16)
    if pkg == "port":
        return ts.ServeEngine(params=weights[1], cfg=TCFG, device="cpu", **kw)
    return js.ServeEngine(params=weights[0], cfg=JCFG, **kw)


def _paged(weights, pkg="port", **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("n_blocks", 33)
    kw.setdefault("block_size", 4)
    kw.setdefault("prompt_bucket", 16)
    if pkg == "port":
        return tp.PagedServeEngine(params=weights[1], cfg=TCFG, device="cpu", **kw)
    return jp.PagedServeEngine(params=weights[0], cfg=JCFG, attn_impl="xla", **kw)


MAKERS = {"dense": _dense, "paged": _paged}
REQS = [
    {"prompt": [7, 8, 9], "max_tokens": 6, "seed": 5},
    {"prompt": [3, 4], "max_tokens": 6, "temperature": 0.7, "seed": 9},
    {"prompt": [11, 12, 13, 14], "max_tokens": 6, "seed": 21},
    {"prompt": [1, 2], "max_tokens": 5, "seed": 33},
    {"prompt": [21, 22, 23], "max_tokens": 5, "seed": 44},
]


def _by_prompt(completions):
    """prompt -> generated: replica-minted ids differ between a fleet run
    and a single engine, prompts do not."""
    return {
        tuple(c.tokens[: len(c.tokens) - len(c.generated)]): tuple(c.generated)
        for c in completions
        if c.status == "ok"
    }


# -- conformance ----------------------------------------------------------------------

@pytest.mark.parametrize("proto", sorted(PROTOCOLS))
@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_both_engine_kinds_satisfy_protocol(weights, kind, proto):
    assert isinstance(MAKERS[kind](weights), PROTOCOLS[proto])


@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_protocol_members_match_the_reference(weights, kind):
    """The port's ``Engine`` declares the reference's members, and each
    engine's methods take the protocol's parameters."""
    members = {n for n in dir(jfleet.Engine) if not n.startswith("_")}
    assert {n for n in dir(tfleet.Engine) if not n.startswith("_")} == members
    eng = MAKERS[kind](weights)
    for name in members - {"n_slots", "sync_interval"}:
        want = [p for p in inspect.signature(getattr(jfleet.Engine, name)).parameters
                if p not in ("self", "kwargs")]
        have = inspect.signature(getattr(eng, name)).parameters
        assert set(want) <= set(have), (name, want, list(have))


@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_submit_signature_surface(weights, kind):
    sig = inspect.signature(MAKERS[kind](weights).submit)
    assert {"prompt", "max_tokens", "temperature", "seed", "adapter", "deadline",
            "queued_at"} <= set(sig.parameters)
    for name, p in sig.parameters.items():
        if name in ("prompt", "max_tokens"):
            continue
        assert p.default is not inspect.Parameter.empty, f"submit({name}=...) has no default"


def test_paged_extends_dense_submit_surface(weights):
    dense_names = set(inspect.signature(_dense(weights).submit).parameters)
    paged_names = set(inspect.signature(_paged(weights).submit).parameters)
    assert dense_names <= paged_names
    assert "priority" in paged_names - dense_names
    for make in (_dense, _paged):  # the reference's surface, name for name
        assert (list(inspect.signature(make(weights).submit).parameters)
                == list(inspect.signature(make(weights, "jax").submit).parameters))


@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_restore_and_pump_signatures(weights, kind):
    eng = MAKERS[kind](weights)
    assert inspect.signature(eng.restore).parameters["merge"].default is False
    pump = inspect.signature(eng.pump)
    assert pump.parameters["queue_limit"].default is None
    assert pump.parameters["max_steps"].default == 100_000


def test_completion_status_vocabulary():
    assert ts.TERMINAL_STATUSES == js.TERMINAL_STATUSES == {
        "ok", "deadline_exceeded", "cancelled", "quarantined", "shed", "error",
    }
    assert ts.Completion(request_id=0, tokens=[1], generated=[]).status == "ok"


@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_stats_returns_engine_stats_contract(weights, kind):
    st = MAKERS[kind](weights).stats()
    assert isinstance(st, tt.EngineStats)
    assert ([f.name for f in dataclasses.fields(tt.EngineStats)]
            == [f.name for f in dataclasses.fields(jt.EngineStats)])
    assert st.heartbeat_age_s >= 0.0 and st.resident_slots == 0 and st.free_slots == 3
    assert st.free_blocks == (32 if kind == "paged" else None)


def test_router_accepts_port_engines_and_rejects_a_plain_object(weights):
    router = FleetRouter([_dense(weights), _paged(weights)])
    assert [r.engine._next_id for r in router.replicas] == [0, jfleet.ID_STRIDE]
    with pytest.raises(TypeError, match="Engine"):
        FleetRouter([object()])


# -- a mixed fleet ----------------------------------------------------------------------

def test_mixed_fleet_serves_every_stream_as_one_jax_engine(weights):
    """A JAX replica and a torch replica behind the reference's router:
    both take requests, and every stream is the single JAX engine's; the
    router read both replicas' ``stats()`` every tick."""
    reqs = REQS + [{"prompt": [5 + i, 9, 4 + i], "max_tokens": 7, "seed": 60 + i}
                   for i in range(4)]
    want = _by_prompt(_paged(weights, "jax").pump([dict(r) for r in reqs]))
    router = FleetRouter([("jax", _paged(weights, "jax")), ("torch", _paged(weights))])
    out = router.pump([dict(r) for r in reqs])
    got = _by_prompt(out)
    assert len(got) == len(reqs)
    bad = {p: (got[p], want[p]) for p in want if got.get(p) != want[p]}
    assert not bad, f"(prompt: port fleet stream, JAX stream): {bad}"
    served = {name: rep.engine.stats() for name, rep in
              ((r.name, r) for r in router.replicas)}
    assert all(s.completed > 0 for s in served.values()), served
    assert sum(s.completed for s in served.values()) == len(reqs)
    assert all(r.last_stats is not None and r.state != DRAINED for r in router.replicas)


@pytest.mark.parametrize("source", ["jax", "torch"])
def test_drain_moves_streams_between_packages(weights, source):
    """Two greedy streams decode three steps on the source replica; the
    router drains it into the other package's replica, and both streams
    finish bit for bit as a single JAX engine's, with their traces moved
    (one migration) and nothing left on the source."""
    reqs = [{"prompt": [5, 6, 7], "max_tokens": 10, "seed": 3},
            {"prompt": [9, 1], "max_tokens": 10, "seed": 11}]
    want = _by_prompt(_dense(weights, "jax").pump([dict(r) for r in reqs]))
    make = {"jax": lambda: _paged(weights, "jax"), "torch": lambda: _paged(weights)}
    target = "torch" if source == "jax" else "jax"
    router = FleetRouter([(source, make[source]())])
    rids = [router.submit(**r) for r in reqs]
    src = router.replica(source).engine
    for _ in range(3):
        src.step()
    router.add_replica(make[target](), name=target)
    moved = router.drain(source, reason="scale_down")
    assert sorted(moved) == sorted(rids)
    assert router.replica(source).state == DRAINED and src.free_slots() == src.n_slots
    dst = router.replica(target).engine
    out = router.pump([])
    assert _by_prompt(out) == want
    for rid in rids:
        tr = dst.telemetry.trace(rid)
        assert tr["status"] == "ok" and tr["migrations"] == 1
        assert src.telemetry.trace(rid) is None  # dropped, not retired, at the source
    assert src.stats().completed == 0 and dst.stats().completed == len(reqs)


# -- the port's router against the reference's ---------------------------------------------

ROUTERS = {"port": (tfleet.FleetRouter, tfaults.FaultInjector),
           "reference": (FleetRouter, jfaults.FaultInjector)}
SCENARIO_REQS = [{"prompt": [3 + i, 9, 2 * i + 1], "max_tokens": 5 + i % 3, "seed": 40 + i}
                 for i in range(8)]


def _until_idle(router, limit: int = 200) -> None:
    for _ in range(limit):
        if router.idle():
            return
        router.tick()
    raise AssertionError("the router did not go idle")


def _scenario(weights, pkg, name, monkeypatch):
    """One scenario on a router of ``pkg`` over a paged replica "a" and a
    dense one "b": (completions, shed count, ``stats()``)."""
    cls, injector = ROUTERS[pkg]
    faults = None
    if name == "evacuate":  # replica a dies before its burst at tick 3
        faults = injector.from_env("replica_crash_rate=1.0,replicas=0,steps=3,seed=2")
    if name == "wedge":  # replica a hangs from tick 2 on: stalls, then evacuation
        monkeypatch.setenv("DRA_FAULTS", "replica_wedge_rate=1.0,replicas=0,steps=2+3+4+5+6+7+8")
    router = cls([("a", _paged(weights)), ("b", _dense(weights))], fault_injector=faults)
    monkeypatch.delenv("DRA_FAULTS", raising=False)
    reqs = [dict(r) for r in SCENARIO_REQS]
    comps = []
    if name == "submit":
        rids = [router.submit(**r) for r in reqs[:6]]
        assert len(set(rids)) == 6
        _until_idle(router)
    elif name == "drain":
        for r in reqs[:4]:
            router.submit(**r)
        router.tick()
        router.tick()
        moved = router.drain("a")
        assert moved and router.replica("a").state == DRAINED
        _until_idle(router)
    elif name == "remove":
        router.submit(**reqs[0])
        _until_idle(router)
        router.drain("a")
        assert isinstance(router.remove_replica("a"), tp.PagedServeEngine)
        with pytest.raises(KeyError):
            router.replica("a")
        comps += router.pump(reqs[1:5])
    elif name == "shed":
        comps += router.pump(reqs, queue_limit=1)
    else:  # evacuate, wedge
        comps += router.pump(reqs[:6])
        assert router.replica("a").state == DRAINED
    comps += router.completions()
    view = sorted((c.request_id, c.status, tuple(c.tokens), tuple(c.generated),
                   c.error.split("; retry after")[0]) for c in comps)
    stats = router.stats()
    stats.pop("router_seq")
    for rep in stats["replicas"]:
        if rep["stats"] is not None:
            rep["stats"] = {k: v for k, v in rep["stats"].items()
                            if not k.endswith("_s") and k != "engine_seq"}
    return view, router.shed_count, stats


@pytest.mark.parametrize("name", ["submit", "drain", "remove", "shed", "evacuate", "wedge"])
def test_port_router_equals_the_reference_router(weights, name, monkeypatch):
    """The same scenario on the port's router and on the reference's, each
    over fresh port engines: the same completions (ids, statuses, tokens,
    errors but for a shed's fleet-wide retry-after), shed counts and
    ``stats()`` (tick, queue, parked, replica states, breakers, verdicts,
    evacuations and the replicas' ``EngineStats`` but for clock readings
    and engine sequence numbers)."""
    got = {pkg: _scenario(weights, pkg, name, monkeypatch) for pkg in ROUTERS}
    assert got["port"] == got["reference"]
    view, shed, stats = got["port"]
    served = [v for v in view if v[1] == "ok"]
    assert served, view
    if name == "shed":
        assert shed > 0 and sum(v[1] == "shed" for v in view) == shed
    if name in ("evacuate", "wedge"):
        rep = stats["replicas"][0]
        assert rep["state"] == DRAINED and rep["evacuations"] == 1
        assert rep["verdict"] == ("replica_crash" if name == "evacuate" else "wedged")


def test_fault_grammar_decides_as_the_reference():
    """One ``DRA_FAULTS`` spec of the router and socket kinds armed in each
    package: the same decisions hook by hook over 40 ticks and frames, the
    same counts; a key of a kind only the reference injects, or a typo, is
    refused by name."""
    spec = ("replica_crash_rate=0.1,replica_wedge_rate=0.3,stats_stale_rate=0.2,replicas=0+2,"
            "sock_truncate=0.1,sock_reset=0.05,sock_latency_ms=7,sock_partition=0.2,"
            "peers=w,peer_hang=3,limit=25,seed=11")
    runs = {}
    for pkg, (_, injector) in ROUTERS.items():
        inj, seen = injector.from_env(spec), []
        for t in range(40):
            for rep in range(3):
                try:
                    inj.maybe_crash_replica(rep, t)
                    crash = False
                except (tfaults.ReplicaCrash, jfaults.ReplicaCrash):
                    crash = True
                seen.append((crash, inj.take_replica_wedge(rep, t), inj.take_stats_stale(rep, t)))
            seen.append((inj.take_sock_latency(), inj.take_sock_reset("w"),
                         inj.take_sock_truncate("w"), inj.take_sock_partition("w", t),
                         inj.take_sock_partition("v", t), inj.take_peer_hang()))
        runs[pkg] = (seen, inj.stats())
    assert runs["port"] == runs["reference"]
    assert sum(runs["port"][1].values()) == 25
    for key in ("schedulers=0+1", "sched_conflict_rate=0.5", "replica_wedge=1.0"):
        with pytest.raises(ValueError, match=repr(key.split("=")[0])):
            tfaults.FaultInjector.from_env(key)


def test_port_router_tick_place_and_debug_doc(weights):
    """``place`` of a handed-off entry (the worker's KV path) onto the port
    router's replica continues it as the unsplit engine does; the router
    appears in ``debug_fleet_doc`` and registers the reference's metric
    names in the port's registry."""
    from k8s_dra_driver_torch.utils.metrics import REGISTRY, parse_prom_text

    want = _paged(weights).pump([dict(SCENARIO_REQS[0])])[0].generated
    pre = _paged(weights)
    pre.submit(handoff=True, **SCENARIO_REQS[0])
    (entry,) = pre.take_handoffs()
    router = tfleet.FleetRouter([_paged(weights)])
    assert router.place([entry], correlation="t") == [entry["request_id"]]
    _until_idle(router)
    (c,) = router.completions()
    assert c.generated == want
    assert router.stats() in tfleet.debug_fleet_doc()["fleets"]
    assert router in tfleet.live_routers()
    names = parse_prom_text(REGISTRY.render())
    assert {"tpu_fleet_replicas", "dra_circuit_state"} <= set(names)


# -- adapters behind the router ---------------------------------------------------------

def _fleet_bank():
    """float32 weights and a bank of two numpy-seeded adapters (nonzero B)
    for this module's model, each as ``(JAX, port)``: in bf16 a near tie
    flips between the packages' products (seen: one token in 54)."""
    import jax.numpy as jnp
    import numpy as np

    from k8s_dra_driver_torch.models.weights import bank_from_jax
    from k8s_dra_driver_tpu.models import lora as jl

    jcfg = dataclasses.replace(JCFG, dtype=jnp.float32)
    jparams = jb.init_params(jax.random.PRNGKey(0), jcfg)
    lora_cfg = jl.LoraConfig(rank=4, alpha=8.0)
    dims = jb.block_matrix_shapes(jcfg)
    r = np.random.RandomState(5)
    ads = [{"blocks": [
        {n: {"a": jnp.asarray((r.standard_normal((dims[n][0], 4)) / 4).astype(np.float32)),
             "b": jnp.asarray((0.3 * r.standard_normal((4, dims[n][1]))).astype(np.float32))}
         for n in lora_cfg.targets}
        for _ in range(jcfg.n_layers)]} for _ in range(2)]
    jbank = jl.stack_adapters(jcfg, lora_cfg, ads)
    return (jcfg, jparams, jbank), (tb.ModelConfig.from_reference(jcfg),
                                    params_from_jax(jparams, device="cpu"),
                                    bank_from_jax(jbank, device="cpu"))


def test_adapter_requests_through_a_mixed_fleet():
    """A JAX replica and a torch replica, each with the same adapter bank,
    behind the reference's router (which scores adapter affinity): every
    stream, adapters 0, 1 and 2 mixed, is a single JAX engine's, and both
    replicas serve adapted requests."""
    (jcfg, jparams, jbank), (tcfg, tparams, tbank) = _fleet_bank()
    kw = dict(n_slots=3, n_blocks=33, block_size=4, prompt_bucket=16)

    def jax_engine():
        return jp.PagedServeEngine(params=jparams, cfg=jcfg, attn_impl="xla",
                                   adapter_bank=jbank, **kw)

    reqs = [{"prompt": [7 + i, 8, 9 + i], "max_tokens": 6, "seed": i, "adapter": i % 3}
            for i in range(9)]
    want = _by_prompt(jax_engine().pump([dict(r) for r in reqs]))
    router = FleetRouter([
        ("jax", jax_engine()),
        ("torch", tp.PagedServeEngine(params=tparams, cfg=tcfg, adapter_bank=tbank,
                                      device="cpu", **kw)),
    ])
    out = router.pump([dict(r) for r in reqs])
    got = _by_prompt(out)
    assert len(got) == len(reqs)
    bad = {p: (got[p], want[p]) for p in want if got.get(p) != want[p]}
    assert not bad, f"(prompt: port fleet stream, JAX stream): {bad}"
    adapted = {}
    for rep in router.replicas:
        traces = [rep.engine.telemetry.trace(c.request_id) for c in out]
        adapted[rep.name] = sorted({tr["adapter"] for tr in traces if tr is not None})
    assert all(any(a > 0 for a in ads) for ads in adapted.values()), adapted
