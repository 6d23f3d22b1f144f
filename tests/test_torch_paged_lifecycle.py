"""The paged engine's request lifecycle in the PyTorch port
(``models/paged.py``): sampled requests, priority preemption with
re-admission, cancel and quarantine, against the JAX package's
``PagedServeEngine(attn_impl="xla")`` on the CPU with the same weights,
traffic and fault injections.

Tolerance: none.  Token streams, completion statuses, ``preempted_count``,
quarantined request ids, host syncs, stalls and free blocks equal the JAX
engine's exactly (float32 throughout; sampled tokens come from the same
bits, see tests/test_torch_sampling.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models import serve as ts
from k8s_dra_driver_torch.models.weights import params_from_jax
from k8s_dra_driver_torch.utils import faults as tf
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import paged as jp
from k8s_dra_driver_tpu.utils import faults as jf

JCFG = jb.ModelConfig(
    vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
    d_ff=128, max_seq=64, rope=True, dtype=jnp.float32,
)
TCFG = tb.ModelConfig.from_reference(JCFG)
ENGINE = dict(n_slots=3, block_size=8, prompt_bucket=24)
# the reference's preemption scenario (tests/test_paged_serve.py
# TestPreemption): two 6-token prompts outgrow a 7-block pool of 4-token
# blocks; one alone needs 7 blocks to finish
STARVED = dict(n_slots=2, n_blocks=8, block_size=4, prompt_bucket=32)
REQS = [([1, 2, 3, 4, 5, 6], 20), ([7, 8, 9, 10, 11, 12], 20)]


@pytest.fixture
def bundles(tmp_path, monkeypatch):
    """The JAX engine's wedge path writes a diagnostics bundle: keep it in
    the test's temporary directory."""
    from k8s_dra_driver_tpu.utils.watchdog import WATCHDOG

    monkeypatch.setattr(WATCHDOG, "_bundle_dir", str(tmp_path))


@pytest.fixture(scope="module")
def weights():
    params = jb.init_params(jax.random.PRNGKey(0), JCFG)
    return params, params_from_jax(params, device="cpu")


def _pair(weights, **kw):
    """A JAX engine and a port engine with the same settings."""
    jparams, tparams = weights
    je = jp.PagedServeEngine(params=jparams, cfg=JCFG, attn_impl="xla", **kw)
    te = tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu", **kw)
    return je, te


def _streams(comps):
    return {c.request_id: (c.generated, c.status) for c in comps}


def _counters(eng):
    return dict(
        preempted=eng.preempted_count, quarantined=list(eng.quarantined),
        host_syncs=eng.host_syncs, stalls=eng.stalled_steps, free=eng.free_blocks,
    )


def _guard_programs(monkeypatch):
    """Make every tensor-to-host read raise inside the programs the card
    captures as graphs (prefill, first token, burst)."""

    def refuse(*_a, **_k):
        raise AssertionError("host read inside a program")

    def guard(fn):
        def guarded(*a, **k):
            with monkeypatch.context() as m:
                for name in ("item", "tolist", "__bool__", "cpu", "numpy"):
                    m.setattr(torch.Tensor, name, refuse)
                return fn(*a, **k)
        return guarded

    for name in ("_paged_pipelined_burst", "_paged_first_token", "paged_prefill"):
        monkeypatch.setattr(tp, name, guard(getattr(tp, name)))


def _mixed_traffic(n=7, seed=3):
    """Greedy, sampled and negative-temperature requests, some with a seed,
    priorities 0 and 1."""
    r = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        req = dict(prompt=r.randint(0, 128, size=r.randint(3, 20)).tolist(),
                   max_tokens=int(r.randint(4, 20)),
                   temperature=[0.0, 0.8, 1.3, -1.0][i % 4], priority=i % 2)
        if i % 3:
            req["seed"] = 100 + i
        reqs.append(req)
    return reqs


@pytest.mark.parametrize("top_k", [0, 5])
@pytest.mark.parametrize("sync_interval", [1, 4])
@pytest.mark.parametrize("n_blocks", [40, 7], ids=["roomy", "tight"])
def test_mixed_traffic_identical_to_jax(weights, monkeypatch, top_k, sync_interval, n_blocks):
    """Greedy and sampled requests with and without seeds through ``pump``;
    the tight pool stalls and preempts."""
    reqs = _mixed_traffic()
    je, te = _pair(weights, n_blocks=n_blocks, sync_interval=sync_interval, top_k=top_k,
                   **ENGINE)
    want = _streams(je.pump(reqs))
    _guard_programs(monkeypatch)
    got = _streams(te.pump(reqs))
    assert got == want
    assert _counters(te) == _counters(je)
    assert te.free_blocks == n_blocks - 1
    if n_blocks == 7:
        assert te.preempted_count > 0 and te.stalled_steps > 0
    sampled = [rid for rid, r in enumerate(reqs) if r["temperature"] > 0]
    greedy = _streams(tp.PagedServeEngine(
        params=weights[1], cfg=TCFG, device="cpu", n_blocks=40, **ENGINE,
    ).pump([dict(r, temperature=0.0) for r in reqs]))
    assert any(got[rid] != greedy[rid] for rid in sampled)  # sampling did sample


def _starved_run(weights, *, n_blocks, preempt, temperature, sync_interval=1):
    """Both engines through the reference's preemption scenario."""
    out = []
    for eng in _pair(weights, n_blocks=n_blocks, preempt_on_stall=preempt,
                     sync_interval=sync_interval,
                     **{k: v for k, v in STARVED.items() if k != "n_blocks"}):
        for prompt, mt in REQS:
            eng.submit(prompt, mt, temperature=temperature, seed=11)
        eng.run_until_drained()
        out.append((eng, _streams(eng.completions())))
    return out


@pytest.mark.parametrize("sync_interval", [1, 4])
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
def test_streams_survive_preemption(weights, temperature, sync_interval):
    """A starved pool preempts and re-admits; every stream equals the roomy
    run's and the JAX engine's, and the counters equal the JAX engine's."""
    (_, roomy_j), (_, roomy_t) = _starved_run(
        weights, n_blocks=40, preempt=False, temperature=temperature,
        sync_interval=sync_interval)
    (je, want), (te, got) = _starved_run(
        weights, n_blocks=8, preempt=True, temperature=temperature,
        sync_interval=sync_interval)
    assert te.preempted_count == je.preempted_count > 0
    assert got == want == roomy_t == roomy_j
    assert _counters(te) == _counters(je)


def _step_until_preempted(eng, n=1, limit=400):
    for _ in range(limit):
        eng.step()
        if len(eng._preempted) >= n:
            return
    raise AssertionError("no preemption")


def test_submit_refused_while_requests_are_parked(weights):
    """A parked request holds no reservation: new submits are refused
    while it waits, and both originals complete in full."""
    for eng in _pair(weights, preempt_on_stall=True, **STARVED):
        for prompt, mt in REQS:
            eng.submit(prompt, mt)
        _step_until_preempted(eng)
        assert eng.preempted_count == 1
        with pytest.raises(RuntimeError, match="preempted requests pending"):
            eng.submit([40, 41, 42], 2)
        eng.run_until_drained()
        assert {c.request_id: len(c.generated) for c in eng.completions()} == {0: 20, 1: 20}
    _, te = _pair(weights, preempt_on_stall=True, **STARVED)
    for prompt, mt in REQS:
        te.submit(prompt, mt)
    _step_until_preempted(te)
    with pytest.raises(ts.NoCapacity):
        te.submit([40, 41, 42], 2)


def test_priority_picks_the_victim(weights):
    """The lowest-priority request parks even though it is the older one."""
    parked = []
    for eng in _pair(weights, preempt_on_stall=True, **STARVED):
        eng.submit(REQS[0][0], 20, priority=0)
        eng.submit(REQS[1][0], 20, priority=5, temperature=0.8, seed=4)
        _step_until_preempted(eng)
        assert eng.preempted_count == 1
        parked.append(eng._preempted[0]["st"].request_id)
        eng.run_until_drained()
        parked.append(_streams(eng.completions()))
    assert parked[0] == parked[2] == 0
    assert parked[1] == parked[3]


def test_priority_orders_stalls_not_tokens(weights):
    """Under a tight pool growth serves high priority first, but the
    streams equal an unpressured run's (and the JAX engine's)."""
    prios = [0, 5, 1, 3]
    reqs = [dict(prompt=[10 + i, 20 + i, 30 + i], max_tokens=12, priority=p,
                 temperature=0.7 * (i % 2), seed=i) for i, p in enumerate(prios)]
    runs = []
    for n_blocks in (64, 9):
        je, te = _pair(weights, n_blocks=n_blocks, preempt_on_stall=True,
                       **{k: v for k, v in STARVED.items() if k != "n_blocks"})
        runs.append((_streams(je.pump(reqs)), _streams(te.pump(reqs))))
        assert _counters(te) == _counters(je)
    assert runs[0][1] == runs[1][1] == runs[0][0] == runs[1][0]


def test_readmission_drains_high_priority_first(weights):
    queues = []
    for eng in _pair(weights, n_slots=3, n_blocks=10, block_size=4, prompt_bucket=32):
        eng.submit([1, 2, 3, 4, 5, 6], 20, priority=2)
        eng.submit([7, 8, 9, 10, 11, 12], 20, priority=0)
        eng.submit([13, 14, 15, 16, 17, 18], 20, priority=1)
        _step_until_preempted(eng, n=2)
        queues.append([(r["st"].request_id, r["priority"]) for r in eng._preempted])
        eng.run_until_drained()
        queues.append(_streams(eng.completions()))
    assert queues[0] == queues[2]
    prios = [p for _, p in queues[0]]
    assert prios == sorted(prios, reverse=True)
    assert queues[1] == queues[3] and set(queues[1]) == {0, 1, 2}


@pytest.mark.parametrize("case", ["disabled", "grown_past_bucket"])
def test_unpreemptable_requests_wedge(weights, bundles, case):
    """With preemption off, or every resident request grown past the
    prompt bucket, a starved pool wedges in both engines."""
    kw = dict(STARVED, preempt_on_stall=case == "grown_past_bucket")
    if case == "grown_past_bucket":
        kw["prompt_bucket"] = 8
    for eng in _pair(weights, **kw):
        for prompt, mt in REQS:
            eng.submit(prompt, mt)
        with pytest.raises(RuntimeError, match="engine wedged"):
            eng.run_until_drained()
        assert eng.preempted_count == 0


def test_cancel_resident_request(weights):
    out = []
    for eng in _pair(weights, n_blocks=40, sync_interval=2, **ENGINE):
        rid = eng.submit([5, 6, 7], max_tokens=10, temperature=0.7, seed=3)
        other = eng.submit([9, 1], max_tokens=6)
        eng.step_burst()
        assert eng.cancel(rid) is True and eng.cancel(rid) is False
        assert eng.cancel(999) is False
        eng.run_until_drained()
        comps = _streams(eng.completions())
        assert comps[rid][1] == "cancelled" and comps[other][1] == "ok"
        assert eng.free_slots() == eng.n_slots and eng.free_blocks == 39
        out.append((comps, _counters(eng)))
    assert out[0] == out[1]


def test_cancel_parked_request(weights):
    out = []
    for eng in _pair(weights, preempt_on_stall=True, **STARVED):
        eng.submit([7, 8, 9], 20, temperature=0.9, seed=2)
        eng.submit([3, 4], 20)
        _step_until_preempted(eng)
        rid = eng._preempted[0]["st"].request_id
        assert eng.cancel(rid) is True and not eng._preempted
        eng.run_until_drained()
        comps = _streams(eng.completions())
        assert comps[rid][1] == "cancelled" and len(comps[rid][0]) >= 1
        assert all(s == "ok" for k, (_, s) in comps.items() if k != rid)
        assert eng.free_blocks == STARVED["n_blocks"] - 1
        out.append((comps, _counters(eng)))
    assert out[0] == out[1]


CHAOS_REQS = [
    {"prompt": [7, 8, 9], "max_tokens": 6, "seed": 5},
    {"prompt": [3, 4], "max_tokens": 6, "temperature": 0.7, "seed": 9},
    {"prompt": [11, 12, 13, 14], "max_tokens": 6, "seed": 21},
]


def _armed(pkg, seed=0, **profile):
    inj = pkg.FaultInjector(seed)
    inj.arm(pkg.FaultProfile(name="chaos", **profile))
    return inj


@pytest.mark.parametrize("fault,sync_interval", [
    (dict(nan_logits_rate=1.0, slots=(1,), steps=(2,)), 3),
    (dict(nan_logits_rate=1.0, slots=(1,), steps=(2,)), 1),
    (dict(step_raise_rate=1.0, slots=(0,), steps=(3,)), 1),
    (dict(nan_logits_rate=0.3, steps=(2, 3, 4)), 2),
], ids=["burst-nan", "step-nan", "step-raise", "random-nan"])
def test_quarantine_matches_jax(weights, monkeypatch, fault, sync_interval):
    """A poisoned slot quarantines in both engines (injectors of each
    package armed alike make the same decisions); survivors equal a
    fault-free run bit for bit; quarantined streams are prefixes of
    theirs; blocks refund."""
    jparams, tparams = weights
    kw = dict(n_slots=3, n_blocks=33, block_size=4, prompt_bucket=16,
              sync_interval=sync_interval)
    clean = _streams(tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu", **kw)
                     .pump(list(CHAOS_REQS)))
    je = jp.PagedServeEngine(params=jparams, cfg=JCFG, attn_impl="xla",
                             fault_injector=_armed(jf, seed=7, **fault), **kw)
    te = tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu",
                             fault_injector=_armed(tf, seed=7, **fault), **kw)
    jcomps = je.pump(list(CHAOS_REQS))
    _guard_programs(monkeypatch)
    tcomps = te.pump(list(CHAOS_REQS))
    got = _streams(tcomps)
    assert got == _streams(jcomps)
    assert {c.request_id: c.error for c in tcomps} == {c.request_id: c.error for c in jcomps}
    assert _counters(te) == _counters(je)
    assert te.quarantined and te.free_blocks == 32
    assert te.fault_injector.stats() == je.fault_injector.stats()
    for rid, (gen, status) in got.items():
        if status == "quarantined":
            assert gen == clean[rid][0][: len(gen)]
        else:
            assert (gen, status) == clean[rid]


def test_engine_poisoned_at_the_limit(weights, bundles):
    kw = dict(n_slots=3, n_blocks=33, block_size=4, prompt_bucket=16, quarantine_limit=2)
    for pkg, eng in zip((jf, tf), _pair(weights, **kw)):
        eng.fault_injector = _armed(pkg, nan_logits_rate=1.0, slots=(1,), steps=(1,))
        out = _streams(eng.pump(list(CHAOS_REQS)))
        assert out[1][1] == "quarantined" and len(eng.quarantined) == 1
    for pkg, eng in zip((jf, tf), _pair(weights, **kw)):
        eng.fault_injector = _armed(pkg, nan_logits_rate=1.0, steps=(1,))
        with pytest.raises(RuntimeError, match="engine poisoned: 2 requests quarantined"):
            eng.pump(list(CHAOS_REQS))
        assert eng.quarantined == [0, 1]


def test_failed_readmission_is_a_typed_error(weights, monkeypatch):
    """A re-admission that fails frees its blocks, delivers an "error"
    completion with the tokens so far, and raises."""
    _, te = _pair(weights, preempt_on_stall=True, **STARVED)
    te.submit([7, 8, 9], 20)
    te.submit([3, 4], 20)
    _step_until_preempted(te)
    rid = te._preempted[0]["st"].request_id
    parked_len = len(te._preempted[0]["st"].tokens)

    def boom(*_a, **_k):
        raise RuntimeError("injected admission fault")

    monkeypatch.setattr(tp, "paged_prefill", boom)
    with pytest.raises(RuntimeError, match="injected admission fault"):
        for _ in range(400):
            te.step()
    done = {c.request_id: c for c in te.completions()}
    assert done[rid].status == "error" and "injected admission fault" in done[rid].error
    assert len(done[rid].tokens) == parked_len and not te._preempted
    assert te.free_blocks + sum(len(o) for o in te._owned) == STARVED["n_blocks"] - 1


STATIC_BUFFERS = ("_table", "_active", "_last", "_pos", "_stop_pos", "_temps", "_keys",
                  "_poison", "_prompt", "_prefill_row", "_admit", "_admit_temp", "_admit_key")


def test_device_state_keeps_its_addresses_through_the_lifecycle(weights, monkeypatch):
    """Every tensor the programs read or write keeps one address through
    sampled admissions, preemptions, re-admissions, a cancel and a
    quarantine, and the programs read nothing to the host."""
    _, tparams = weights
    eng = tp.PagedServeEngine(
        params=tparams, cfg=TCFG, device="cpu", preempt_on_stall=True, sync_interval=4,
        top_k=5, fault_injector=_armed(tf, nan_logits_rate=1.0, slots=(2,), steps=(6,)),
        **dict(STARVED, n_slots=3, n_blocks=12),
    )
    ptrs = {name: getattr(eng, name).data_ptr() for name in STATIC_BUFFERS}
    ran = []
    run = eng._run

    def checked(name, fn):
        assert {n: getattr(eng, n).data_ptr() for n in STATIC_BUFFERS} == ptrs
        ran.append(name)
        return run(name, fn)

    eng._run = checked
    _guard_programs(monkeypatch)
    reqs = [dict(prompt=[1 + i, 2 + i, 3 + i, 4 + i], max_tokens=20, temperature=0.8 * (i % 2),
                 seed=i, priority=i % 2) for i in range(5)]
    eng.submit(**reqs[0])
    eng.cancel(eng.submit(**reqs[1]))
    comps = eng.completions() + eng.pump(reqs[2:])
    statuses = sorted(c.status for c in comps)
    assert statuses == ["cancelled", "ok", "ok", "ok", "quarantined"]
    assert eng.preempted_count > 0 and eng.free_blocks == 11
    assert ran.count("prefill") == ran.count("first token") + eng.preempted_count
    assert set(ran) <= {"burst k=1", "burst k=4", "first token", "prefill"}
    assert "burst k=4" in ran and eng.graphs == {}


def test_engine_validates_its_new_fields(weights):
    _, tparams = weights
    for bad in (dict(top_k=-1), dict(top_k=129), dict(quarantine_limit=0)):
        with pytest.raises(ValueError):
            tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu", **bad)
    eng = tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu", top_k=128, **ENGINE)
    rid = eng.submit([1, 2, 3], max_tokens=3, temperature=-0.5)  # negative: greedy
    eng.run_until_drained()
    (c,) = eng.completions()
    assert c.request_id == rid and c.status == "ok" and len(c.generated) == 3


def test_many_parked_requests_resume_in_each_others_slots(weights):
    """Eight slots of 4-token blocks on a pool that parks several requests
    at once, greedy and sampled ones in both priority tiers: a parked
    request often re-admits into a slot another parked request left, and
    every stream still equals the roomy run's and the JAX engine's."""
    r = np.random.RandomState(5)
    reqs = [dict(prompt=r.randint(0, 128, size=int(r.randint(4, 13))).tolist(),
                 max_tokens=int(r.randint(16, 33)), priority=(i // 2) % 2,
                 temperature=0.8 * (i % 2), seed=1000 + i) for i in range(16)]
    kw = dict(n_slots=8, block_size=4, prompt_bucket=48, sync_interval=4, top_k=5)
    runs = {}
    for n_blocks in (97, 25):
        je, te = _pair(weights, n_blocks=n_blocks, **kw)
        runs[n_blocks] = (_streams(je.pump(reqs)), _streams(te.pump(reqs)))
        assert _counters(te) == _counters(je)
    assert te.preempted_count > 1 and je.preempted_count > 1
    assert runs[25][1] == runs[25][0] == runs[97][1] == runs[97][0]
