"""Per-request LoRA in the PyTorch port's serving engines
(``serve.ServeEngine`` and ``paged.PagedServeEngine`` with
``adapter_bank``) against the JAX package's engines on the CPU, at the JAX
tests' sizes (``tests/test_lora_serve.py``) in float32: the same base
(``weights.params_from_jax``) and the same bank of two numpy-seeded
adapters with nonzero B (``weights.bank_from_jax``), the same traffic.

Held exactly: greedy token streams and statuses, host syncs, prefix hits
and misses, stalls and preemptions, ``stats()`` field for field (the
host's own clock aside) and every request's trace under a step-per-read
fake clock.  Identity-adapter streams also equal a bank-less port
engine's, and permuting the bank with the ids gives the same streams (no
row reads another's adapter).  A bank-less engine restores an adapted
snapshot entry with the base model, as the JAX engine does, and an entry
whose adapter lies outside the engine's bank serves with the row the JAX
engine's gather reads (the id normalized and clamped into the bank)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models import serve as ts
from k8s_dra_driver_torch.models.weights import bank_from_jax, params_from_jax
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import lora as jl
from k8s_dra_driver_tpu.models import paged as jp
from k8s_dra_driver_tpu.models import serve as js

JCFG = jb.ModelConfig(
    vocab_size=89, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq=128, dtype=jnp.float32,
)
TCFG = tb.ModelConfig.from_reference(JCFG)
JLORA = jl.LoraConfig(rank=4, alpha=8.0)
ENGINES = {
    "dense": dict(n_slots=3, prompt_bucket=16),
    "paged": dict(n_slots=3, n_blocks=40, block_size=8, prompt_bucket=16),
}
PROMPTS = [[3, 14, 15, 9, 2], [6, 53, 58, 9], [7, 1, 8, 2, 8, 1]]
TIMES = {"engine_seq", "last_step_s", "uptime_s", "heartbeat_age_s"}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def numpy_adapter(seed: int) -> dict:
    """A trained-looking adapter: A normal with std 1/r, B 0.3 times a
    normal, so the adapted streams leave the base's."""
    r = np.random.RandomState(seed)
    dims = jb.block_matrix_shapes(JCFG)
    return {"blocks": [
        {name: {"a": (r.standard_normal((dims[name][0], JLORA.rank)) / JLORA.rank
                      ).astype(np.float32),
                "b": (0.3 * r.standard_normal((JLORA.rank, dims[name][1]))).astype(np.float32)}
         for name in JLORA.targets}
        for _ in range(JCFG.n_layers)
    ]}


def _bank(order=(1, 2)):
    jbank = jl.stack_adapters(
        JCFG, JLORA, [jax.tree.map(jnp.asarray, numpy_adapter(s)) for s in order])
    return jbank, bank_from_jax(jbank, device="cpu")


@pytest.fixture(scope="module")
def weights():
    params = jb.init_params(jax.random.PRNGKey(0), JCFG)
    return params, params_from_jax(params, device="cpu")


@pytest.fixture(scope="module")
def banks():
    return {"straight": _bank((1, 2)), "swapped": _bank((2, 1))}


def _engine(weights, kind, pkg="port", bank=None, **kw):
    jparams, tparams = weights
    kw = dict(ENGINES[kind], **kw)
    if kind == "dense":
        if pkg == "jax":
            return js.ServeEngine(params=jparams, cfg=JCFG, adapter_bank=bank, **kw)
        return ts.ServeEngine(params=tparams, cfg=TCFG, adapter_bank=bank, device="cpu", **kw)
    if pkg == "jax":
        return jp.PagedServeEngine(params=jparams, cfg=JCFG, attn_impl="xla", adapter_bank=bank,
                                   **kw)
    return tp.PagedServeEngine(params=tparams, cfg=TCFG, adapter_bank=bank, device="cpu", **kw)


def _pair(weights, banks, kind, which="straight", **kw):
    jbank, tbank = banks[which]
    return (_engine(weights, kind, "jax", jbank, **kw),
            _engine(weights, kind, "port", tbank, **kw))


def _reqs(pairs):
    return [dict(prompt=p, max_tokens=m, adapter=a) for p, m, a in pairs]


def _streams(comps):
    return {c.request_id: (c.generated, c.status) for c in comps}


def _counters(eng):
    out = dict(host_syncs=eng.host_syncs, hits=eng.prefix_hits, misses=eng.prefix_misses)
    if hasattr(eng, "stalled_steps"):
        out.update(stalls=eng.stalled_steps, preempted=eng.preempted_count,
                   blocks=eng.free_blocks)
    return out


class StepClock:
    """A fake monotonic clock that advances one second per read."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


def _guard_programs(monkeypatch):
    """Every tensor-to-host read raises inside the programs the card
    captures as graphs."""

    def refuse(*_a, **_k):
        raise AssertionError("host read inside a program")

    def guard(mod, name):
        fn = getattr(mod, name)

        def guarded(*a, **k):
            with monkeypatch.context() as m:
                for attr in ("item", "tolist", "__bool__", "cpu", "numpy"):
                    m.setattr(torch.Tensor, attr, refuse)
                return fn(*a, **k)
        monkeypatch.setattr(mod, name, guarded)

    for name in ("_pipelined_burst", "_prefill_into_slot", "_prefill_suffix_into_slot",
                 "_spec_round"):
        guard(ts, name)
    for name in ("_paged_pipelined_burst", "_paged_first_token", "paged_prefill",
                 "paged_prefill_chunk", "_paged_spec_round"):
        guard(tp, name)


MIXED = [(PROMPTS[0], 9, 1), (PROMPTS[1], 9, 2), (PROMPTS[2], 9, 0),
         ([5, 5, 6, 70, 71, 2, 3], 12, 2), ([40, 41], 7, 1)]


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_identity_adapter_streams_equal_a_bankless_engine(weights, banks, kind):
    reqs = _reqs([(p, 10, 0) for p in PROMPTS])
    je, te = _pair(weights, banks, kind)
    got = _streams(te.pump(reqs))
    assert got == _streams(je.pump(reqs))
    assert got == _streams(_engine(weights, kind).pump(reqs))


@pytest.mark.parametrize("sync_interval", [1, 3])
@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_mixed_adapters_equal_the_jax_engine(weights, banks, monkeypatch, kind, sync_interval):
    """Five requests over three slots, adapters 1, 2 and 0 mixed in each
    burst: the JAX engine's streams and host syncs; the bank and the ids
    permuted together give the same streams; the adapters bite."""
    reqs = _reqs(MIXED)
    je, te = _pair(weights, banks, kind, sync_interval=sync_interval)
    want = _streams(je.pump(reqs))
    _guard_programs(monkeypatch)
    got = _streams(te.pump(reqs))
    assert got == want and len(got) == 5
    assert _counters(te) == _counters(je)
    swap = {1: 2, 2: 1, 0: 0}
    swapped = _engine(weights, kind, bank=banks["swapped"][1], sync_interval=sync_interval)
    assert _streams(swapped.pump(_reqs([(p, m, swap[a]) for p, m, a in MIXED]))) == got
    same_prompt = [_engine(weights, kind, bank=banks["straight"][1]).pump(
        _reqs([(PROMPTS[0], 9, a)]))[0].generated for a in (0, 1, 2)]
    assert len({tuple(s) for s in same_prompt}) == 3


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_prefix_store_keys_by_adapter(weights, banks, kind):
    """The same prompt under adapters 1, 2, then 1 again: no hit across
    adapters, a hit for the same one with its stream unchanged, hits and
    misses as the JAX engine counts them."""
    if kind == "dense":
        shared, kw = [11, 12, 13, 14, 15, 16, 17, 18, 20], dict(n_slots=1, prefix_bucket=4)
    else:
        shared, kw = list(range(20, 32)) + [40], dict(prefix_cache_blocks=6)
    je, te = _pair(weights, banks, kind, **kw)
    runs = []
    for adapter in (1, 2, 1):
        reqs = _reqs([(shared, 8, adapter)])
        want = _streams(je.pump(reqs))
        got = _streams(te.pump(reqs))
        assert list(got.values()) == list(want.values())
        runs.append((list(got.values())[0][0], te.prefix_hits))
        assert _counters(te) == _counters(je)
    assert runs[1][1] == runs[0][1] and runs[2][1] > runs[1][1]
    assert runs[0][0] == runs[2][0] != runs[1][0]


def test_paged_preemption_readmits_each_row_with_its_adapter(weights, banks):
    """On a 7-block pool the requests stall, are preempted and re-admitted:
    the JAX engine's streams, stalls and preemptions, and the streams of a
    roomy pool."""
    reqs = _reqs([([1, 2, 3, 4, 5, 6], 14, 1), ([7, 8, 9, 10, 11, 12], 14, 2),
                  ([13, 14, 15], 12, 0)])
    kw = dict(n_slots=2, block_size=4, prompt_bucket=32)
    je, te = _pair(weights, banks, "paged", n_blocks=7, **kw)
    want = _streams(je.pump(reqs))
    got = _streams(te.pump(reqs))
    assert got == want and te.preempted_count > 0
    assert _counters(te) == _counters(je)
    roomy = _engine(weights, "paged", bank=banks["straight"][1], n_blocks=40, **kw)
    assert _streams(roomy.pump(reqs)) == got


def test_paged_chunked_admission_and_the_store_with_adapters(weights, banks, monkeypatch):
    """1-block chunks, a 4-block store and two adapters over one system
    prompt: the JAX engine's streams, syncs, hits and misses."""
    system = list(range(30, 46))
    reqs = _reqs([(system + [i, i + 1], 6 + i % 4, i % 3) for i in range(6)])
    kw = dict(prefill_chunk_blocks=1, prefix_cache_blocks=4, sync_interval=2,
              prompt_bucket=24)
    je, te = _pair(weights, banks, "paged", **kw)
    want = _streams(je.pump(reqs))
    _guard_programs(monkeypatch)
    got = _streams(te.pump(reqs))
    assert got == want and te.prefix_hits > 0
    assert _counters(te) == _counters(je)


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_speculation_applies_the_adapter_on_the_verify_pass(weights, banks, monkeypatch, kind):
    """``spec_gamma=3`` with the int8 self-draft of the base: the JAX
    engine's streams and host syncs, and the non-speculative banked
    engine's streams (the draft proposes, the adapted target decides)."""
    reqs = _reqs([(PROMPTS[0], 10, 1), (PROMPTS[1], 10, 2), (PROMPTS[2], 10, 0),
                  ([9, 9, 4], 8, 1)])
    je, te = _pair(weights, banks, kind, spec_gamma=3)
    want = _streams(je.pump(reqs))
    _guard_programs(monkeypatch)
    got = _streams(te.pump(reqs))
    assert got == want
    assert _counters(te) == _counters(je)
    assert got == _streams(_engine(weights, kind, bank=banks["straight"][1]).pump(reqs))
    assert 0 < te.spec_accepted < te.spec_drafted


@pytest.mark.parametrize("src", ["port", "jax"])
@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_snapshot_and_restore_carry_the_adapter(weights, banks, kind, src):
    """Three adapted requests decode 3 steps; the snapshot (through JSON)
    carries each adapter id and restores into a fresh engine of either
    package; every stream finishes as the uninterrupted run's."""
    reqs = _reqs([(PROMPTS[0], 12, 1), (PROMPTS[1], 12, 2), (PROMPTS[2], 12, 0)])
    want = _streams(_engine(weights, kind, "jax", banks["straight"][0]).pump(reqs))
    jbank, tbank = banks["straight"]
    first = _engine(weights, kind, src, jbank if src == "jax" else tbank)
    for r in reqs:
        first.submit(**r)
    for _ in range(3):
        first.step()
    snap = json.loads(json.dumps(first.snapshot_active()))
    assert sorted(r["adapter"] for r in snap["requests"]) == [0, 1, 2]
    early = _streams(first.completions())
    for pkg in ("port", "jax"):
        eng = _engine(weights, kind, pkg, jbank if pkg == "jax" else tbank)
        assert eng.restore(json.loads(json.dumps(snap))) == sorted(want)
        eng.run_until_drained()
        assert {**early, **_streams(eng.completions())} == want, pkg


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_stats_and_traces_equal_the_jax_engine(weights, banks, kind):
    """Under a step-per-read fake clock on both engines: ``stats()`` field
    for field (the host's clock aside) and each trace, adapter id
    included."""
    reqs = _reqs(MIXED)
    je, te = _pair(weights, banks, kind, sync_interval=2)
    je.telemetry.clock, te.telemetry.clock = StepClock(), StepClock()
    comps = te.pump(reqs)
    assert _streams(comps) == _streams(je.pump(reqs))
    doc_t, doc_j = te.stats().to_json(), je.stats().to_json()
    assert {k: v for k, v in doc_t.items() if k not in TIMES} == {
        k: v for k, v in doc_j.items() if k not in TIMES}
    for c in comps:
        tr = te.telemetry.trace(c.request_id)
        assert tr == je.telemetry.trace(c.request_id)
    assert sorted(te.telemetry.trace(c.request_id)["adapter"] for c in comps) == [0, 1, 1, 2, 2]


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_adapter_checks_and_an_unservable_restored_adapter(weights, banks, kind):
    """``submit`` raises the reference's ValueErrors.  A restored entry
    whose adapter lies outside the bank (5 and -1 in a 3-row bank) serves
    as in the JAX engine, whose gather normalizes a negative id and clamps
    into the bank: streams and statuses equal, and the engine's own
    snapshot carries the ids on as given.  A bank-less engine restores
    every entry and serves them with the base model, as the JAX one does."""
    for pkg in ("port", "jax"):
        plain = _engine(weights, kind, pkg)
        with pytest.raises(ValueError, match="no adapter_bank"):
            plain.submit([1, 2], 2, adapter=1)
        jbank, tbank = banks["straight"]
        eng = _engine(weights, kind, pkg, jbank if pkg == "jax" else tbank)
        with pytest.raises(ValueError, match=r"adapter 3 out of range \[0, 3\)"):
            eng.submit([1, 2], 2, adapter=3)
    entry = dict(deadline=None, key=[0, 0], priority=0, temperature=0.0, prompt_len=2,
                 max_tokens=4)
    snap = {"next_id": 3, "requests": [dict(entry, request_id=0, tokens=[1, 2, 3], adapter=5),
                                       dict(entry, request_id=1, tokens=[4, 5, 6], adapter=2),
                                       dict(entry, request_id=2, tokens=[7, 8, 9], adapter=-1)]}
    ids = lambda eng: {r["request_id"]: r["adapter"] for r in eng.snapshot_active()["requests"]}
    je, te = _pair(weights, banks, kind)
    assert je.restore(json.loads(json.dumps(snap))) == [0, 1, 2]
    assert te.restore(json.loads(json.dumps(snap))) == [0, 1, 2]
    te.step_burst()
    je.step_burst()
    assert ids(te) == ids(je) == {0: 5, 1: 2, 2: -1}
    te.run_until_drained()
    je.run_until_drained()
    got, want = _streams(te.completions()), _streams(je.completions())
    assert got == want and {st for _, st in got.values()} == {"ok"}
    jplain, tplain = _engine(weights, kind, "jax"), _engine(weights, kind)
    assert jplain.restore(json.loads(json.dumps(snap))) == [0, 1, 2]
    assert tplain.restore(json.loads(json.dumps(snap))) == [0, 1, 2]
    tplain.step_burst()
    jplain.step_burst()
    assert ids(tplain) == ids(jplain) == {0: 5, 1: 2, 2: -1}
    tplain.run_until_drained()
    jplain.run_until_drained()
    got, want = _streams(tplain.completions()), _streams(jplain.completions())
    assert got == want and {st for _, st in got.values()} == {"ok"}


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_adapter_ids_keep_their_buffer(weights, banks, kind):
    """The per-slot ids are one device buffer written in place (a graph
    replays its address); a bank-less engine keeps none."""
    te = _engine(weights, kind, bank=banks["straight"][1])
    ptr = te._adapter_ids.data_ptr()
    te.pump(_reqs(MIXED))
    assert te._adapter_ids.data_ptr() == ptr and te._adapter_ids.dtype == torch.int32
    assert _engine(weights, kind)._adapter_ids is None
