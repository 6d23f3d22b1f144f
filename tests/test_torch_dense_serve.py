"""The dense serving engine of the PyTorch port (``models/serve.ServeEngine``)
against the JAX package's ``ServeEngine`` on the CPU, with the same weights
(``weights.params_from_jax``), seeded traffic and fault injections; and the
pump's queue-limit shedding on both port engines against the JAX engines.

Tolerances (those of tests/test_torch_paged_serve.py, which explains
them): greedy and sampled token streams, completion statuses, host syncs
and the prefix, quarantine and shed counters identical; a float32 cache
within atol = rtol = 1e-5; a bfloat16 cache within one bf16 step of the
JAX entry, (2^-7 + 2^-16) * |JAX| + 2^-16.  Sampled tokens come from the
same bits (tests/test_torch_sampling.py holds the tail alone and reports
a mismatch with its Gumbel margin)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models import quant as tq
from k8s_dra_driver_torch.models import serve as ts
from k8s_dra_driver_torch.models.weights import params_from_jax
from k8s_dra_driver_torch.utils import faults as tf
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import paged as jp
from k8s_dra_driver_tpu.models import quant as jq
from k8s_dra_driver_tpu.models import serve as js
from k8s_dra_driver_tpu.utils import faults as jf

JCFG = jb.ModelConfig(
    vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
    d_ff=128, max_seq=64, rope=True, dtype=jnp.float32,
)
TCFG = tb.ModelConfig.from_reference(JCFG)
ENGINE = dict(n_slots=3, prompt_bucket=24)
EOS = 24  # a token the seeded traffic emits mid-stream
BF16_STEP = 2 ** -7 + 2 ** -16


@pytest.fixture(scope="module")
def weights():
    params = jb.init_params(jax.random.PRNGKey(0), JCFG)
    return params, params_from_jax(params, device="cpu")


@pytest.fixture
def bundles(tmp_path, monkeypatch):
    """The JAX engine's wedge path writes a diagnostics bundle: keep it in
    the test's temporary directory."""
    from k8s_dra_driver_tpu.utils.watchdog import WATCHDOG

    monkeypatch.setattr(WATCHDOG, "_bundle_dir", str(tmp_path))


def _pair(weights, **kw):
    """A JAX engine and a port engine with the same settings."""
    jparams, tparams = weights
    je = js.ServeEngine(params=jparams, cfg=JCFG, **kw)
    dtypes = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    kw = {k: dtypes.get(v, v) if k == "cache_dtype" else v for k, v in kw.items()}
    te = ts.ServeEngine(params=tparams, cfg=TCFG, device="cpu", **kw)
    return je, te


def _streams(comps):
    return {c.request_id: (c.generated, c.status) for c in comps}


def _counters(eng):
    return dict(host_syncs=eng.host_syncs, quarantined=list(eng.quarantined),
                hits=eng.prefix_hits, misses=eng.prefix_misses, free=eng.free_slots())


def _traffic(n=7, seed=3):
    r = np.random.RandomState(seed)
    return [
        (r.randint(0, 128, size=r.randint(3, 20)).tolist(), int(r.randint(4, 20)))
        for _ in range(n)
    ]


def _guard_programs(monkeypatch):
    """Make every tensor-to-host read raise inside the programs the card
    captures as graphs (admission, prefix-hit admission, burst)."""

    def refuse(*_a, **_k):
        raise AssertionError("host read inside a program")

    def guard(fn):
        def guarded(*a, **k):
            with monkeypatch.context() as m:
                for name in ("item", "tolist", "__bool__", "cpu", "numpy"):
                    m.setattr(torch.Tensor, name, refuse)
                return fn(*a, **k)
        return guarded

    for name in ("_pipelined_burst", "_prefill_into_slot", "_prefill_suffix_into_slot"):
        monkeypatch.setattr(ts, name, guard(getattr(ts, name)))


def _drive(eng, case, reqs):
    """``single``: one request alone; ``concurrent``: every request
    submitted at once (they fit the slots), then drained; ``midflight``:
    two submitted, two steps, the rest pumped in behind them."""
    if case == "single":
        eng.submit(*reqs[0])
        eng.run_until_drained()
        return eng.completions()
    if case == "concurrent":
        for prompt, mt in reqs[: eng.n_slots]:
            eng.submit(prompt, mt)
        eng.run_until_drained()
        return eng.completions()
    for prompt, mt in reqs[:2]:
        eng.submit(prompt, mt)
    eng.step()
    eng.step_burst()
    return eng.completions() + eng.pump(reqs[2:])


@pytest.mark.parametrize("sync_interval", [1, 3])
@pytest.mark.parametrize("case", ["single", "concurrent", "midflight"])
def test_streams_identical_to_jax(weights, monkeypatch, case, sync_interval):
    """Greedy streams through one, three and seven requests (slots reused
    as they free), at a sync interval that does not divide the budgets."""
    reqs = _traffic()
    je, te = _pair(weights, sync_interval=sync_interval, **ENGINE)
    want = _streams(_drive(je, case, reqs))
    _guard_programs(monkeypatch)
    got = _streams(_drive(te, case, reqs))
    assert got == want and len(got) == {"single": 1, "concurrent": 3, "midflight": 7}[case]
    assert _counters(te) == _counters(je)
    np.testing.assert_allclose(te._cache.k.numpy(), np.asarray(je._cache.k),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("sync_interval", [1, 3])
def test_eos_deadlines_and_bf16_cache_identical_to_jax(weights, monkeypatch, cache,
                                                       sync_interval):
    """eos inside a burst (the on-device stop mask), ``deadline_exceeded``
    retirements, and a bf16 cache: completions with their statuses and
    host syncs identical, the cache within the module docstring's limit."""
    reqs = [dict(prompt=p, max_tokens=m, deadline=(m // 2 + 1) if i % 2 else None)
            for i, (p, m) in enumerate(_traffic())]
    dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16}[cache]
    je, te = _pair(weights, sync_interval=sync_interval, eos_id=EOS, cache_dtype=dtype,
                   **ENGINE)
    want = _streams(je.pump(reqs))
    _guard_programs(monkeypatch)
    got = _streams(te.pump(reqs))
    assert got == want
    assert {status for _, status in got.values()} == {"ok", "deadline_exceeded"}
    assert any(gen[-1] == EOS and len(gen) < reqs[rid]["max_tokens"]
               for rid, (gen, _) in got.items())
    assert _counters(te) == _counters(je)
    for name in ("k", "v"):
        t_c = getattr(te._cache, name).float().numpy()
        j_c = np.asarray(getattr(je._cache, name), dtype=np.float32)
        if cache == "f32":
            np.testing.assert_allclose(t_c, j_c, atol=1e-5, rtol=1e-5)
        else:
            over = np.abs(t_c - j_c) > BF16_STEP * np.abs(j_c) + 2 ** -16
            assert not over.any(), f"{int(over.sum())} {name} entries over one bf16 step"


def _sampled_traffic(n=7, seed=5):
    """Greedy, sampled and negative-temperature requests, some seeded."""
    r = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        req = dict(prompt=r.randint(0, 128, size=r.randint(3, 20)).tolist(),
                   max_tokens=int(r.randint(4, 20)), temperature=[0.0, 0.8, 1.3, -1.0][i % 4])
        if i % 3:
            req["seed"] = 100 + i
        reqs.append(req)
    return reqs


@pytest.mark.parametrize("top_k", [0, 5])
@pytest.mark.parametrize("sync_interval", [1, 3])
def test_sampled_streams_identical_to_jax(weights, monkeypatch, top_k, sync_interval):
    reqs = _sampled_traffic()
    je, te = _pair(weights, sync_interval=sync_interval, top_k=top_k, **ENGINE)
    want = _streams(je.pump(reqs))
    _guard_programs(monkeypatch)
    got = _streams(te.pump(reqs))
    differ = {rid: (got[rid], want[rid]) for rid in want if got.get(rid) != want[rid]}
    assert not differ, f"(port, jax) streams that differ: {differ}"
    assert _counters(te) == _counters(je)
    greedy = _streams(ts.ServeEngine(params=weights[1], cfg=TCFG, device="cpu", **ENGINE)
                      .pump([dict(r, temperature=0.0) for r in reqs]))
    assert any(got[rid] != greedy[rid] for rid, r in enumerate(reqs) if r["temperature"] > 0)


# -- the prefix cache --------------------------------------------------------

PREFIX = dict(ENGINE, prefix_bucket=6)


def _system_prompts(n, seed=40):
    r = np.random.RandomState(seed)
    return [r.randint(0, 128, size=6).tolist() for _ in range(n)]


def _prefix_traffic():
    """Prompts over three system prompts A, B, C in the order A B A C B A,
    each with its own suffix: with two store entries the second A hits,
    C evicts B (the least recently used), the second B misses and evicts
    A, so the third A misses too."""
    a, b, c = _system_prompts(3)
    r = np.random.RandomState(41)
    return [(sys + r.randint(0, 128, size=r.randint(1, 10)).tolist(), int(r.randint(4, 12)))
            for sys in (a, b, a, c, b, a)]


@pytest.mark.parametrize("sync_interval", [1, 3])
def test_prefix_cache_hits_misses_and_eviction_identical_to_jax(weights, monkeypatch,
                                                                sync_interval):
    reqs = _prefix_traffic()
    je, te = _pair(weights, sync_interval=sync_interval, prefix_cache_entries=2, **PREFIX)
    want = _streams(je.pump(reqs))
    _guard_programs(monkeypatch)
    got = _streams(te.pump(reqs))
    assert got == want
    assert _counters(te) == _counters(je)
    assert (te.prefix_hits, te.prefix_misses) == (1, 5)
    a, b, _ = _system_prompts(3)
    assert list(te._prefix_store) == list(je._prefix_store) == [tuple(b), tuple(a)]
    off = _streams(ts.ServeEngine(params=weights[1], cfg=TCFG, device="cpu",
                                  sync_interval=sync_interval, **ENGINE).pump(reqs))
    assert got == off  # the prefix cache changes what is computed, not the streams


def test_prefix_hit_streams_equal_the_full_prefill_and_jax(weights):
    """Every request after the first shares the system prompt: hits and
    the cache-off run give the same streams, as the JAX engine's."""
    (sys,) = _system_prompts(1, seed=42)
    r = np.random.RandomState(43)
    reqs = [(sys + r.randint(0, 128, size=4).tolist(), 8) for _ in range(4)]
    je, te = _pair(weights, **PREFIX)
    on = _streams(te.pump(reqs))
    off = _streams(ts.ServeEngine(params=weights[1], cfg=TCFG, device="cpu", **ENGINE)
                   .pump(reqs))
    assert on == off == _streams(je.pump(reqs))
    assert (te.prefix_hits, te.prefix_misses) == (je.prefix_hits, je.prefix_misses) == (3, 1)


def test_short_prompt_bypasses_the_store(weights):
    for eng in _pair(weights, **PREFIX):
        eng.submit(_system_prompts(1)[0][:5], max_tokens=4)
        eng.submit(_system_prompts(1)[0], max_tokens=4)  # exactly the bucket: no suffix
        eng.run_until_drained()
        assert (eng.prefix_hits, eng.prefix_misses, len(eng._prefix_store)) == (0, 0, 0)


def test_stored_prefix_survives_the_reuse_of_its_slot(weights):
    """A store entry is a copy: the next request admitted into the slot it
    was taken from overwrites the row, not the entry; the hit after that
    still equals the full prefill."""
    a, b = _system_prompts(2, seed=44)
    te = ts.ServeEngine(params=weights[1], cfg=TCFG, device="cpu",
                        **dict(PREFIX, n_slots=1))
    te.submit(a + [1, 2, 3], max_tokens=5)
    te.run_until_drained()
    kept = [t.clone() for t in te._prefix_store[tuple(a)]]
    te.submit(b + [4, 5], max_tokens=5)   # same slot, another prefix
    te.run_until_drained()
    assert all(torch.equal(t, k) for t, k in zip(te._prefix_store[tuple(a)], kept, strict=True))
    rid = te.submit(a + [7, 8], max_tokens=6)
    te.run_until_drained()
    assert te.prefix_hits == 1
    (got,) = [c.generated for c in te.completions() if c.request_id == rid]
    off = ts.ServeEngine(params=weights[1], cfg=TCFG, device="cpu", **ENGINE)
    off.submit(a + [7, 8], max_tokens=6)
    off.run_until_drained()
    assert got == off.completions()[0].generated


# -- cancel and quarantine ----------------------------------------------------

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
    fault-free run; quarantined streams are prefixes of theirs."""
    jparams, tparams = weights
    kw = dict(n_slots=3, prompt_bucket=16, sync_interval=sync_interval)
    clean = _streams(ts.ServeEngine(params=tparams, cfg=TCFG, device="cpu", **kw)
                     .pump(list(CHAOS_REQS)))
    je = js.ServeEngine(params=jparams, cfg=JCFG, fault_injector=_armed(jf, seed=7, **fault),
                        **kw)
    te = ts.ServeEngine(params=tparams, cfg=TCFG, device="cpu",
                        fault_injector=_armed(tf, seed=7, **fault), **kw)
    jcomps = je.pump(list(CHAOS_REQS))
    _guard_programs(monkeypatch)
    tcomps = te.pump(list(CHAOS_REQS))
    got = _streams(tcomps)
    assert got == _streams(jcomps)
    assert [(c.request_id, c.error) for c in tcomps] == [(c.request_id, c.error) for c in jcomps]
    assert _counters(te) == _counters(je) and te.quarantined
    assert te.fault_injector.stats() == je.fault_injector.stats()
    for rid, (gen, status) in got.items():
        if status == "quarantined":
            assert gen == clean[rid][0][: len(gen)]
        else:
            assert (gen, status) == clean[rid]


def test_engine_poisoned_at_the_limit(weights, bundles):
    kw = dict(n_slots=3, prompt_bucket=16, quarantine_limit=2)
    for pkg, eng in zip((jf, tf), _pair(weights, **kw), strict=True):
        eng.fault_injector = _armed(pkg, nan_logits_rate=1.0, slots=(1,), steps=(1,))
        out = _streams(eng.pump(list(CHAOS_REQS)))
        assert out[1][1] == "quarantined" and len(eng.quarantined) == 1
    for pkg, eng in zip((jf, tf), _pair(weights, **kw), strict=True):
        eng.fault_injector = _armed(pkg, nan_logits_rate=1.0, steps=(1,))
        with pytest.raises(RuntimeError, match="engine poisoned: 2 requests quarantined"):
            eng.pump(list(CHAOS_REQS))
        assert eng.quarantined == [0, 1]


@pytest.mark.parametrize("sync_interval", [1, 2])
def test_cancel_matches_jax(weights, sync_interval):
    out = []
    for eng in _pair(weights, sync_interval=sync_interval, **ENGINE):
        rid = eng.submit([5, 6, 7], max_tokens=10, temperature=0.7, seed=3)
        other = eng.submit([9, 1], max_tokens=6)
        eng.step_burst()
        assert eng.cancel(rid) is True and eng.cancel(rid) is False
        assert eng.cancel(999) is False
        eng.run_until_drained()
        comps = eng.completions()
        streams = _streams(comps)
        assert streams[rid][1] == "cancelled" and streams[other][1] == "ok"
        assert eng.free_slots() == eng.n_slots
        out.append(([(c.request_id, c.error) for c in comps], streams, _counters(eng)))
    assert out[0] == out[1]


# -- snapshot and restore -----------------------------------------------------

def _snapshot_run(eng, reqs, steps):
    """Submit ``reqs``, run ``steps`` single steps, snapshot (through
    JSON), release the engine's slots.  Returns ``(snapshot, completions
    before it)``."""
    for r in reqs:
        eng.submit(**r)
    for _ in range(steps):
        eng.step()
    snap = json.loads(json.dumps(eng.snapshot_active()))
    before = eng.completions()
    assert eng.release_active() == len(snap["requests"]) > 0
    assert eng.completions() == [] and eng.free_slots() == eng.n_slots
    return snap, before


SNAP_REQS = [dict(prompt=[3, 1, 4, 1, 5], max_tokens=12),
             dict(prompt=[9, 2, 6], max_tokens=3, temperature=0.8, seed=7),
             dict(prompt=[5, 3, 5, 8, 9, 7], max_tokens=14, temperature=1.1, seed=2, deadline=9)]


@pytest.mark.parametrize("sync_interval", [1, 3])
def test_restore_continues_every_stream(weights, sync_interval):
    """A port snapshot, through JSON, restored into a fresh port engine:
    every stream ends as the uninterrupted run's, and the snapshot's
    document is the JAX engine's at the same point."""
    jparams, tparams = weights

    def port():
        return ts.ServeEngine(params=tparams, cfg=TCFG, device="cpu",
                              sync_interval=sync_interval, **ENGINE)

    want = _streams(port().pump(SNAP_REQS))
    snap, before = _snapshot_run(port(), SNAP_REQS, steps=4)
    fresh = port()
    assert sorted(fresh.restore(snap)) == [r["request_id"] for r in snap["requests"]]
    fresh.run_until_drained()
    got = _streams(before + fresh.completions())
    assert got == want
    assert fresh._next_id == 3
    jsnap, _ = _snapshot_run(js.ServeEngine(params=jparams, cfg=JCFG, **ENGINE), SNAP_REQS, 4)
    # each entry carries its telemetry trace, in host-clock times here (held
    # key for key under a fake clock in tests/test_torch_telemetry.py)
    for doc in (snap, jsnap):
        traces = [entry.pop("trace") for entry in doc["requests"]]
        assert [t["request_id"] for t in traces] == [e["request_id"] for e in doc["requests"]]
    assert snap == jsnap


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_snapshot_restores_across_packages(weights, direction):
    """A snapshot one package's engine writes, after ``json.dumps``,
    restores into the other's and continues as the writer's own restore
    does (keys cross as plain ints: uint32 in JAX, int64 here)."""
    je, te = _pair(weights, sync_interval=2, top_k=5, **ENGINE)
    writer = je if direction == "jax-to-port" else te
    snap, _ = _snapshot_run(writer, SNAP_REQS, steps=3)
    outs = []
    for eng in _pair(weights, sync_interval=2, top_k=5, **ENGINE):
        eng.restore(json.loads(json.dumps(snap)))
        eng.run_until_drained()
        outs.append(_streams(eng.completions()))
    assert outs[0] == outs[1] and len(outs[0]) == len(snap["requests"])


def test_merge_and_unrestorable_entries_match_jax(weights):
    """``merge`` fills free slots of a live engine (its own streams keep
    going); an entry longer than the bucket and one that finds no slot come
    back as "error" completions; a non-idle engine refuses a plain
    restore."""
    outs = []
    for eng in _pair(weights, **ENGINE):
        eng.submit([1, 2, 3], max_tokens=8)
        snap = {"engine": "x", "next_id": 9, "requests": [
            dict(request_id=5, tokens=[4, 5, 6, 7], prompt_len=3, max_tokens=6, deadline=None,
                 temperature=0.0, key=[0, 5], adapter=0, priority=0),
            dict(request_id=6, tokens=list(range(30)), prompt_len=20, max_tokens=20,
                 deadline=None, temperature=0.0, key=[0, 6], adapter=0, priority=0),
            dict(request_id=7, tokens=[8, 9], prompt_len=1, max_tokens=5, deadline=None,
                 temperature=0.9, key=[4294967295, 7], adapter=0, priority=0),
            dict(request_id=8, tokens=[3, 3], prompt_len=1, max_tokens=5, deadline=None,
                 temperature=0.0, key=[0, 8], adapter=0, priority=0),
        ]}
        with pytest.raises(RuntimeError, match="idle engine"):
            eng.restore(snap)
        assert eng.restore(snap, merge=True) == [5, 7]
        eng.run_until_drained()
        comps = eng.completions()
        errors = {c.request_id: c.error for c in comps if c.status == "error"}
        assert set(errors) == {6, 8} and "prompt_bucket" in errors[6] and "slot" in errors[8]
        assert eng._next_id == 9
        outs.append(([(c.request_id, c.generated, c.status, c.error) for c in comps],
                     _counters(eng)))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("status", sorted(ts.TERMINAL_STATUSES))
def test_terminal_entry_rejected_before_any_change(weights, status):
    snap = {"engine": "x", "next_id": 8, "requests": [
        dict(request_id=3, tokens=[5, 6, 7, 8], prompt_len=2, max_tokens=4, deadline=None,
             temperature=0.0, key=[0, 0], adapter=0, priority=0),
        dict(request_id=7, tokens=[1, 2, 3], prompt_len=2, status=status),
    ]}
    assert ts.TERMINAL_STATUSES == js.TERMINAL_STATUSES
    for eng, err in zip(_pair(weights, **ENGINE), (js.SnapshotRestoreError,
                                                   ts.SnapshotRestoreError), strict=True):
        for merge in (False, True):
            with pytest.raises(err, match="duplicate") as exc:
                eng.restore(dict(snap), merge=merge)
            assert (exc.value.request_id, exc.value.status) == (7, status)
        assert eng.free_slots() == eng.n_slots and eng.completions() == []
        assert eng._next_id == 0


# -- shedding -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("queue_limit", [0, 2])
def test_pump_sheds_like_jax(weights, kind, queue_limit):
    """Overflow past ``queue_limit`` sheds newest-first: the same "shed"
    completions (request id -1, the prompt, no tokens) in the same order,
    the same streams for the rest, with a retry-after; a shed request
    never reaches ``submit``."""
    jparams, tparams = weights
    reqs = _traffic(n=9, seed=6)
    if kind == "dense":
        je, te = _pair(weights, sync_interval=2, **ENGINE)
    else:
        kw = dict(ENGINE, n_blocks=40, block_size=8, sync_interval=2)
        je = jp.PagedServeEngine(params=jparams, cfg=JCFG, attn_impl="xla", **kw)
        te = tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu", **kw)
    submits = []
    submit = te.submit
    te.submit = lambda *a, **k: submits.append(a[0]) or submit(*a, **k)
    jcomps, tcomps = je.pump(reqs, queue_limit=queue_limit), te.pump(reqs, queue_limit=queue_limit)

    def shed(comps):
        return [(c.request_id, c.tokens, c.generated) for c in comps if c.status == "shed"]

    assert shed(tcomps) == shed(jcomps)
    n_shed = len(reqs) - ENGINE["n_slots"] - queue_limit
    assert te.shed_count == je.shed_count == len(shed(tcomps)) == n_shed
    assert [t for _, t, _ in shed(tcomps)] == [p for p, _ in reversed(reqs[-n_shed:])]
    assert _streams(c for c in tcomps if c.status != "shed") == \
        _streams(c for c in jcomps if c.status != "shed")
    assert len(submits) == len(reqs) - n_shed
    assert isinstance(te.last_shed, ts.ShedError) and te.last_shed.retry_after_s >= 0.05
    assert "admission queue full" in str(te.last_shed)


# -- the engines agree, the engine's rules ------------------------------------

@pytest.mark.parametrize("sync_interval", [1, 4])
def test_dense_and_paged_engines_give_the_same_streams(weights, sync_interval):
    reqs = _traffic(n=6, seed=23)
    _, tparams = weights
    dense = ts.ServeEngine(params=tparams, cfg=TCFG, device="cpu", **ENGINE)
    paged = tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu", n_blocks=40,
                                block_size=8, sync_interval=sync_interval, **ENGINE)
    assert _streams(paged.pump(reqs)) == _streams(dense.pump(reqs))


def test_int4_engine_streams_identical_to_jax(weights, monkeypatch):
    jparams, _ = weights
    j4 = jq.quantize_blocks(jparams, bits=4, kernel=False)
    t4 = params_from_jax(j4, device="cpu")
    assert isinstance(t4["blocks"][0]["qkv"], tq.Quantized4Matrix)
    reqs = _traffic(n=5, seed=4)
    want = _streams(js.ServeEngine(params=j4, cfg=JCFG, sync_interval=3, **ENGINE).pump(reqs))
    _guard_programs(monkeypatch)
    eng = ts.ServeEngine(params=t4, cfg=TCFG, device="cpu", sync_interval=3, **ENGINE)
    assert _streams(eng.pump(reqs)) == want


def test_submit_and_engine_validation_match_jax(weights):
    for eng in _pair(weights, **ENGINE):
        for bad in (dict(prompt=[], max_tokens=3), dict(prompt=[1], max_tokens=0),
                    dict(prompt=[1], max_tokens=3, deadline=0),
                    dict(prompt=[1] * 25, max_tokens=3), dict(prompt=[1] * 20, max_tokens=45)):
            with pytest.raises(ValueError):
                eng.submit(**bad)
        for _ in range(3):
            eng.submit([1, 2], max_tokens=4)
        with pytest.raises(RuntimeError, match="no free slot"):
            eng.submit([1, 2], max_tokens=4)
    for bad in (dict(prompt_bucket=65), dict(top_k=-1), dict(top_k=129), dict(sync_interval=0),
                dict(quarantine_limit=0), dict(prefix_bucket=24), dict(prefix_bucket=0),
                dict(prefix_bucket=4, prefix_cache_entries=0)):
        with pytest.raises(ValueError):
            _pair(weights, **dict(ENGINE, **bad))


def test_unported_paths_raise(weights):
    """A mesh that is no ``DeviceMesh`` raises a TypeError at construction
    (a real mesh is served: ``tests/test_torch_sharded_serve.py``); nothing
    falls back quietly.  The item-11 paths behave as the reference's:
    ``submit(handoff=True)``
    retires into ``take_handoffs`` with a payload, ``snapshot_active(
    include_kv=True)`` attaches one, and an entry with ``"kv": None``
    re-prefills, its stream the JAX engine's."""
    _, tparams = weights

    def engine(**kw):
        return ts.ServeEngine(params=tparams, cfg=TCFG, device="cpu", **dict(ENGINE, **kw))

    with pytest.raises(TypeError, match="DeviceMesh"):
        engine(mesh=object())
    je, te = _pair(weights, **ENGINE)
    for eng in (je, te):
        eng.submit([1, 2], 3, handoff=True)
        (entry,) = eng.take_handoffs()
        assert entry["kv"].valid_len == 2 and eng.free_slots() == eng.n_slots
        eng.submit([1, 2, 3], 3)
        (entry,) = eng.snapshot_active(include_kv=True)["requests"]
        assert entry["kv"].valid_len == 3
        eng.release_active()
    entry = dict(request_id=0, tokens=[1, 2], prompt_len=1, max_tokens=3, deadline=None,
                 temperature=0.0, key=[0, 0], adapter=0, priority=0)
    streams = []
    for eng in _pair(weights, **ENGINE):
        assert eng.restore({"next_id": 1, "requests": [dict(entry, kv=None)]}) == [0]
        eng.run_until_drained()
        streams.append([(c.request_id, c.generated, c.status) for c in eng.completions()])
    assert streams[0] == streams[1] and len(streams[0][0][1]) == 3


def test_engine_defaults_to_the_card(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.ServeEngine(params=weights[1], cfg=TCFG)
    assert ts.ServeEngine(params=weights[1], cfg=TCFG, device="cpu").device.type == "cpu"


STATIC_BUFFERS = ("_active", "_last", "_pos", "_stop_pos", "_temps", "_keys", "_poison",
                  "_prompt", "_admit", "_admit_temp", "_admit_key", "_prefix_k", "_prefix_v")


def test_device_state_keeps_its_addresses(weights, monkeypatch):
    """Every tensor the programs read or write keeps one address through
    admissions, prefix hits, a cancel, a quarantine and a restore; the
    programs read nothing to the host; at most four programs."""
    _, tparams = weights
    eng = ts.ServeEngine(
        params=tparams, cfg=TCFG, device="cpu", sync_interval=4, top_k=5,
        fault_injector=_armed(tf, nan_logits_rate=1.0, slots=(2,), steps=(3,)), **PREFIX,
    )
    buffers = (*STATIC_BUFFERS, "_cache")

    def ptrs():
        out = {n: getattr(eng, n).data_ptr() for n in STATIC_BUFFERS}
        out["_cache"] = (eng._cache.k.data_ptr(), eng._cache.v.data_ptr())
        return out

    before = ptrs()
    ran = []
    run = eng._run

    def checked(name, fn):
        assert ptrs() == before, buffers
        ran.append(name)
        return run(name, fn)

    eng._run = checked
    _guard_programs(monkeypatch)
    (sys,) = _system_prompts(1, seed=45)
    reqs = [dict(prompt=sys + [i, i + 1], max_tokens=12, temperature=0.8 * (i % 2), seed=i)
            for i in range(5)]
    eng.submit(**reqs[0])
    eng.cancel(eng.submit(**reqs[1]))
    comps = eng.completions() + eng.pump(reqs[2:])
    assert sorted(c.status for c in comps) == ["cancelled", "ok", "ok", "ok", "quarantined"]
    eng.submit(**reqs[0])
    eng.step_burst()
    snap = eng.snapshot_active()
    eng.release_active()
    eng.restore(snap)
    eng.run_until_drained()
    assert ptrs() == before
    assert eng.prefix_hits >= 3
    assert set(ran) == {"admission", "prefix admission", "burst k=4"}
    assert eng.graphs == {}
