"""The port's autoscaler (``k8s_dra_driver_torch/models/autoscaler.py``) and
its fault seam (``utils/faults.py``'s spawn kinds) against the reference's,
on the CPU.

* Both injectors make the same spawn draws (``maybe_fail_spawn``,
  ``take_spawn_latency``, scoped by ``steps`` = spawn attempts, under one
  ``limit``) and parse ``DRA_FAULTS``'s ``spawn_fail``/``spawn_latency_ms``
  alike.
* ``FleetAutoscaler`` over each package's ``FleetRouter`` of its own
  ``SimEngine``s, driven by each package's ``replay`` through a flash crowd,
  takes the same decisions at the same ticks (every ``last_decision``,
  ``actions``, replicas over time, the journal's ``autoscale`` events with
  their correlations) and scores the same report, clean and under
  ``spawn_fail``/``spawn_latency_ms`` faults.
* ``select_engine_factory`` picks and raises as the reference's.
* ``scale_move`` over each package's ``DisaggRouter`` of its own paged
  engines (``TINY`` in float32, the JAX weights carried across) mid-load
  with the moved replica crashed (``test_rebalance_chaos.py``'s pool move):
  the same streams, once each, blocks balanced, the same events; and a
  ``PoolRebalancer`` fed the same stage observations moves as the
  reference's.
* ``debug_autoscale_doc`` has the reference's keys.
"""

import re

import jax
import jax.numpy as jnp
import pytest
import torch

from k8s_dra_driver_torch.models import autoscaler as tas
from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import disagg as td
from k8s_dra_driver_torch.models import fleet as tfleet
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models import workload as tw
from k8s_dra_driver_torch.models.weights import params_from_jax
from k8s_dra_driver_torch.utils import faults as tf
from k8s_dra_driver_torch.utils import journal as tj
from k8s_dra_driver_torch.utils import metrics as tm
from k8s_dra_driver_tpu.models import autoscaler as jas
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import disagg as jd
from k8s_dra_driver_tpu.models import fleet as jfleet
from k8s_dra_driver_tpu.models import paged as jp
from k8s_dra_driver_tpu.models import workload as jw
from k8s_dra_driver_tpu.utils import faults as jf
from k8s_dra_driver_tpu.utils import journal as jj
from k8s_dra_driver_tpu.utils import metrics as jm

PKG = {
    "reference": dict(asc=jas, w=jw, fleet=jfleet, disagg=jd, faults=jf, journal=jj.JOURNAL,
                      registry=jm.REGISTRY),
    "port": dict(asc=tas, w=tw, fleet=tfleet, disagg=td, faults=tf, journal=tj.JOURNAL,
                 registry=tm.REGISTRY),
}
JCFG = jb.ModelConfig(dtype=jnp.float32)  # TINY, in float32
TCFG = tb.ModelConfig.from_reference(JCFG)


@pytest.fixture(autouse=True)
def _fresh_state():
    for pkg in PKG.values():
        pkg["registry"].reset()
        pkg["journal"].clear()
    yield


@pytest.fixture
def autoscale_events(monkeypatch):
    """Every ``autoscale`` journal record of each package as it happens
    (the journal is a bounded ring)."""
    events = {}
    for name, pkg in PKG.items():
        seen = events[name] = []
        journal = pkg["journal"]

        def spy(component, event, correlation="", _orig=journal.record, _seen=seen, **attrs):
            if component == "autoscale":
                _seen.append((event, correlation, dict(attrs)))
            return _orig(component, event, correlation=correlation, **attrs)

        monkeypatch.setattr(journal, "record", spy)
    return events


def _canon(obj, seqs=None):
    """``obj`` with each router sequence number in a ``scale-<seq>-<n>``
    correlation replaced by its order of first appearance, and
    ``router_seq`` keys dropped: the numbers count every router the process
    has built, so they differ with what ran before."""
    seqs = {} if seqs is None else seqs
    if isinstance(obj, str):
        return re.sub(r"scale-(\d+)-", lambda m: f"scale-r{seqs.setdefault(m[1], len(seqs))}-",
                      obj)
    if isinstance(obj, dict):
        return {k: _canon(v, seqs) for k, v in obj.items() if k != "router_seq"}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_canon(v, seqs) for v in obj)
    return obj


SPAWN_SPEC = "spawn_fail=0.5,spawn_latency_ms=250,steps=0+1+2+3+5+8,limit=5,seed=3"


def test_spawn_fault_seam_draws_and_parses_as_the_reference():
    runs = {}
    for name, pkg in PKG.items():
        faults = pkg["faults"]
        inj = faults.FaultInjector.from_env(SPAWN_SPEC)
        (p,) = inj._profiles
        seen = [(p.spawn_fail_rate, p.spawn_latency_s, p.steps, p.limit)]
        for attempt in range(12):
            try:
                inj.maybe_fail_spawn(attempt)
                failed = None
            except faults.SpawnFault as exc:
                failed = (exc.attempt, str(exc))
            seen.append((failed, inj.take_spawn_latency(attempt)))
        # programmatic arming with another profile on the same stream
        inj.arm(faults.FaultProfile(name="more", spawn_fail_rate=0.3))
        for attempt in range(12, 30):
            try:
                inj.maybe_fail_spawn(attempt)
                seen.append(False)
            except faults.SpawnFault:
                seen.append(True)
        runs[name] = (seen, inj.stats())
    assert runs["port"] == runs["reference"]
    seen, stats = runs["port"]
    assert stats["spawn_fail"] >= 1 and stats["spawn_latency"] >= 1


# the reference's autoscale chaos trace, cut to 60 s: a 4x flash crowd at 20 s
SPEC = dict(seed=42, duration_s=60.0, base_rate_rps=10.0, diurnal_amplitude=0.3,
            diurnal_period_s=60.0)
CROWD = (20.0, 15.0, 4.0)
FAULTS = {"clean": None, "spawn_fail": "spawn_fail=0.6,seed=11",
          "spawn_latency": "spawn_latency_ms=1500,steps=0+2,seed=4"}


class _Recorder:
    """Stands in for the autoscaler in ``replay``: ticks it and keeps every
    decision with the replicas alive after it."""

    def __init__(self, asc, router):
        self.asc, self.router, self.trail = asc, router, []

    def tick(self, queue_depth=None):
        d = self.asc.tick(queue_depth=queue_depth)
        live = sum(1 for r in self.router.replicas if r.state != "drained")
        self.trail.append((dict(d), live))
        return d


def _autoscaled_replay(pkg, fault):
    m = PKG[pkg]
    w = m["w"]
    clock, sink = w.SimClock(), w.SimSink()

    def factory():
        return w.SimEngine(clock=clock, n_slots=8, n_blocks=512, decode_tps=30.0, sink=sink)

    inj = m["faults"].FaultInjector.from_env(FAULTS[fault]) if FAULTS[fault] else None
    router = m["fleet"].FleetRouter([factory()], clock=clock, fault_injector=inj)
    asc = m["asc"].FleetAutoscaler(
        router, engine_factory=factory, clock=clock,
        policy=m["asc"].AutoscalerPolicy(min_replicas=1, max_replicas=4, up_ticks=3,
                                         down_ticks=30, cooldown_s=5.0, spawn_backoff_s=4.0))
    rec = _Recorder(asc, router)
    streams = []
    spec = w.WorkloadSpec(flash_crowds=(w.FlashCrowd(*CROWD),), **SPEC)
    rep = w.replay(w.generate(spec), router, clock=clock, sink=sink, autoscaler=rec, dt=0.1,
                   queue_limit=512,
                   on_completion=lambda c: streams.append((tuple(c.tokens), c.status)))
    doc = rep.to_json()
    doc.pop("wall_s")
    return _canon(dict(report=doc, trail=rec.trail, streams=streams, actions=asc.actions,
                       spawn_failures=asc.spawn_failures, stats=asc.stats(),
                       injected=inj.stats() if inj else {},
                       names=[r.name for r in router.replicas]))


@pytest.mark.parametrize("fault", list(FAULTS))
def test_autoscaler_acts_as_the_reference(fault, autoscale_events):
    ref, port = _autoscaled_replay("reference", fault), _autoscaled_replay("port", fault)
    assert port["trail"] == ref["trail"]
    assert port == ref
    assert _canon(autoscale_events["port"]) == _canon(autoscale_events["reference"])
    rep = ref["report"]
    assert rep["lost"] == 0 and rep["completed"] + rep["shed"] == rep["offered"]
    events = [e for e, _, _ in autoscale_events["port"]]
    if fault == "spawn_fail":
        assert ref["spawn_failures"] >= 1 and "scale_up.spawn_failed" in events
    else:
        assert "scale_up.resumed" in events and "scale_down.resumed" in events
        assert max(live for _, live in ref["trail"]) > 1
    # one correlation spans each action's begin and its resumed
    begins = {c for e, c, _ in autoscale_events["port"] if e.endswith(".begin")}
    resumed = {c for e, c, _ in autoscale_events["port"] if e.endswith(".resumed")}
    assert resumed <= begins and all(c.startswith("scale-") for c in begins)


@pytest.mark.parametrize("env", [{}, {"DRA_REMOTE_WORKERS": "1"}, {"DRA_REMOTE_WORKERS": "no"},
                                 {"DRA_REMOTE_WORKERS": " ON "}])
def test_select_engine_factory_as_the_reference(env):
    local, remote = object(), object()
    for remote_factory in (remote, None):
        picks = []
        for mod in (jas, tas):
            try:
                picks.append(mod.select_engine_factory(local, remote_factory, environ=env))
            except ValueError as exc:
                picks.append(("raises", str(exc)))
        assert picks[0] == picks[1]
    assert tas.ENV_REMOTE_WORKERS == jas.ENV_REMOTE_WORKERS


@pytest.fixture(scope="module")
def weights():
    jparams = jb.init_params(jax.random.PRNGKey(5), JCFG)
    return jparams, params_from_jax(jparams, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _paged(weights, pkg):
    jparams, tparams = weights
    kw = dict(n_slots=3, n_blocks=41, block_size=4, prompt_bucket=16)
    if pkg == "reference":
        return jp.PagedServeEngine(params=jparams, cfg=JCFG, attn_impl="xla",
                                   cache_dtype=jnp.float32, **kw)
    return tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu",
                               cache_dtype=torch.float32, **kw)


# the pool move's traffic (test_rebalance_chaos.py's REQS)
REQS = [
    {"prompt": [7, 8, 9], "max_tokens": 6, "seed": 5},
    {"prompt": [3, 4], "max_tokens": 6, "temperature": 0.7, "seed": 9},
    {"prompt": [11, 12, 13, 14], "max_tokens": 6, "seed": 21},
    {"prompt": [1, 2], "max_tokens": 6, "seed": 33},
    {"prompt": [21, 22, 23], "max_tokens": 6, "seed": 44},
]


def _pool_move(weights, pkg):
    """Move a prefill replica into the decode pool at tick 2 of a loaded
    run, the moved replica crashed at its router's tick 8 (the reference's
    scenario); then, a third decode replica added, a PoolRebalancer fed
    prefill-starved stage means moves one back after its vote ticks."""
    m = PKG[pkg]
    d = m["disagg"]
    inj = m["faults"].FaultInjector.from_env(
        "replica_crash_rate=1.0,replicas=1,steps=8,limit=1,seed=2")
    e1, e2, d1 = (_paged(weights, pkg) for _ in range(3))
    free0 = [e.free_blocks for e in (e1, e2, d1)]
    router = d.DisaggRouter(prefill=[e1, e2], decode=[d1],
                            channel=[d.ChannelClaim(name="ici-0", bandwidth_gbps=100.0),
                                     d.ChannelClaim(name="ici-1", bandwidth_gbps=50.0)],
                            fault_injector=inj)
    pre_s = m["asc"].FleetAutoscaler(router.prefill, lambda: _paged(weights, pkg))
    dec_s = m["asc"].FleetAutoscaler(router.decode, lambda: _paged(weights, pkg))
    for r in REQS:
        req = dict(r)
        router.submit(req.pop("prompt"), req.pop("max_tokens"), **req)
    done, corr = [], None
    for i in range(400):
        router.tick()
        done.extend(router.completions())
        if i == 2:
            corr = pre_s.scale_move(router.decode)
        if len(done) == len(REQS) and router.prefill.idle() and router.decode.idle():
            break
    out = dict(corr=corr, streams=sorted((tuple(c.tokens), tuple(c.generated), c.status)
                                         for c in done),
               ids=len({c.request_id for c in done}), injected=inj.stats(),
               pools=([r.name for r in router.prefill.replicas],
                      [(r.name, r.state) for r in router.decode.replicas]),
               balanced=[e.free_blocks for e in (e1, e2, d1)] == free0,
               admission=router.stats()["admission"])
    router.take_stage_attribution()  # the run's own samples are wall times
    router.decode.add_replica(_paged(weights, pkg))  # a donor beyond min_replicas
    now = [0.0]
    rb = m["asc"].PoolRebalancer(router, pre_s, dec_s,
                                 m["asc"].RebalancePolicy(min_samples=4, vote_ticks=2),
                                 clock=lambda: now[0])
    decisions = []
    for _ in range(3):
        for _ in range(4):
            router._observe_stage("prefill", 0.1)
            router._observe_stage("decode", 0.01)
        decisions.append(rb.tick())
    out["rebalance"] = (decisions, rb.stats(), [r.name for r in router.prefill.replicas])
    return _canon(out)


def test_scale_move_and_rebalancer_over_paged_disagg(weights, autoscale_events):
    ref, port = _pool_move(weights, "reference"), _pool_move(weights, "port")
    assert port == ref
    assert ref["corr"].startswith("scale-") and ref["balanced"]
    assert len(ref["streams"]) == len(REQS) == ref["ids"]
    assert {s for _, _, s in ref["streams"]} == {"ok"}
    assert ref["injected"] == {"replica_crash": 1}
    assert ref["admission"]["ledger_streams"] == 0 and ref["admission"]["parked"] == 0
    assert ref["rebalance"][1]["moves"] == 1
    events = _canon(autoscale_events["port"])
    assert events == _canon(autoscale_events["reference"])
    moves = [(e, c) for e, c, _ in events if e.startswith("scale_move")]
    assert moves[:2] == [("scale_move.begin", ref["corr"]), ("scale_move.resumed", ref["corr"])]


def test_debug_autoscale_doc_has_the_reference_keys():
    docs = {}
    for name, pkg in PKG.items():
        w = pkg["w"]
        clock = w.SimClock()
        router = pkg["fleet"].FleetRouter([w.SimEngine(clock=clock) for _ in range(2)],
                                          clock=clock)
        asc = pkg["asc"].FleetAutoscaler(router, lambda: w.SimEngine(clock=clock), clock=clock)
        asc.tick(queue_depth=0)
        asc.record_slo(3, 4)
        doc = pkg["asc"].debug_autoscale_doc()
        mine = [a for a in doc["autoscalers"] if a["router_seq"] == router.seq]
        docs[name] = (sorted(doc), mine[0], pkg["asc"].live_autoscalers()[-1] is asc)

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None for k, v in d.items()}

    (rk, rdoc, rlive), (pk, pdoc, plive) = docs["reference"], docs["port"]
    assert pk == rk and keys(pdoc) == keys(rdoc) and rlive and plive
    for doc in (rdoc, pdoc):
        doc.pop("router_seq")
    assert pdoc == rdoc
