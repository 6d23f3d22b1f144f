"""Paged serving of the PyTorch port (``models/paged.py``) against the JAX
package's ``PagedServeEngine(attn_impl="xla")``, on the CPU, with the same
weights and seeded traffic.

Tolerances: greedy token streams, completion statuses, stall counts and
host syncs identical; float32 logits within atol = rtol = 1e-4; pool
entries outside the null block 0 (the JAX plain path diverts inactive
rows' writes there, the port does not write them at all) within atol =
rtol = 1e-5 in a float32 pool, and in a bfloat16 pool within one bf16
step of the JAX entry, (2^-7 + 2^-16) * |JAX| + 2^-16: the elementwise
bf16 limit the card tests hold kernels to (tests/test_torch_gpu.py),
step * |plain| plus 2^-16 of the entry's size (K/V entries are O(1)).
Each entry is one rounding to bf16 of a float32 projection that the two
packages sum in another order, so the roundings may land one bf16 step
apart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import decode as td
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models import quant as tq
from k8s_dra_driver_torch.models import serve as ts
from k8s_dra_driver_torch.models.weights import params_from_jax
from k8s_dra_driver_torch.ops import int4_matmul as ti4
from k8s_dra_driver_torch.ops import paged_attention as tpa
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import paged as jp
from k8s_dra_driver_tpu.models import quant as jq

# head_dim 16 != block_size 8: a transposed pool write cannot pass unseen
JCFG = jb.ModelConfig(
    vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
    d_ff=128, max_seq=64, rope=True, dtype=jnp.float32,
)
TCFG = tb.ModelConfig.from_reference(JCFG)
ENGINE = dict(n_slots=3, block_size=8, prompt_bucket=24)


@pytest.fixture(scope="module")
def weights():
    params = jb.init_params(jax.random.PRNGKey(0), JCFG)
    return params, params_from_jax(params, device="cpu")


def _traffic(n=7, seed=3):
    r = np.random.RandomState(seed)
    return [
        (r.randint(0, 128, size=r.randint(3, 20)).tolist(), int(r.randint(4, 20)))
        for _ in range(n)
    ]


def _forbid_host_reads(monkeypatch):
    """Make every tensor-to-host read raise while a burst runs."""

    def refuse(*_a, **_k):
        raise AssertionError("host read inside the burst loop")

    for name in ("item", "tolist", "__bool__", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


def _streams(comps):
    return {c.request_id: (c.generated, c.status) for c in comps}


def _serve_port(tparams, reqs, monkeypatch, **kw):
    """Serve through the port, counting bursts that reached the device and
    refusing host reads inside each program the card captures as a graph
    (prefill, first token, burst).  Returns the engine, its completions as
    ``{request_id: (generated, status)}`` and the burst count."""
    eng = tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu", **ENGINE, **kw)

    def guard(fn):
        def guarded(*a, **k):
            with monkeypatch.context() as m:
                _forbid_host_reads(m)
                return fn(*a, **k)
        return guarded

    for name in ("_paged_pipelined_burst", "_paged_first_token", "paged_prefill"):
        monkeypatch.setattr(tp, name, guard(getattr(tp, name)))
    bursts = 0
    step_burst = eng.step_burst

    def counted():
        nonlocal bursts
        stepped = step_burst()
        bursts += stepped > 0
        return stepped

    eng.step_burst = counted
    return eng, _streams(eng.pump(reqs)), bursts


@pytest.mark.parametrize(
    "sync_interval,n_blocks", [(1, 40), (4, 40), (1, 9), (4, 9)],
    ids=["sync1", "sync4", "sync1-tight", "sync4-tight"],
)
def test_engine_streams_identical_to_jax(weights, monkeypatch, sync_interval, n_blocks):
    jparams, tparams = weights
    reqs = _traffic()
    je = jp.PagedServeEngine(
        params=jparams, cfg=JCFG, n_blocks=n_blocks, attn_impl="xla",
        sync_interval=sync_interval, preempt_on_stall=False, **ENGINE,
    )
    want = _streams(je.pump(reqs))
    te, got, bursts = _serve_port(
        tparams, reqs, monkeypatch, n_blocks=n_blocks, sync_interval=sync_interval,
        preempt_on_stall=False,
    )
    assert got == want
    assert te.stalled_steps == je.stalled_steps
    if n_blocks == 9:
        assert te.stalled_steps > 0  # the pool is tight enough to stall
    assert te.host_syncs == je.host_syncs == bursts
    assert te.free_blocks == te.reservable_blocks == n_blocks - 1
    np.testing.assert_allclose(
        te._cache.k.numpy()[:, 1:], np.asarray(je._cache.k)[:, 1:], atol=1e-5, rtol=1e-5
    )


EOS = 24  # a token the seeded traffic emits mid-stream (requests 4-6 of _traffic())
BF16_STEP = 2 ** -7 + 2 ** -16


def _eos_deadline_traffic():
    """``_traffic()`` with every odd request under a deadline of about
    half its ``max_tokens``."""
    return [
        dict(prompt=p, max_tokens=m, deadline=(m // 2 + 1) if i % 2 else None)
        for i, (p, m) in enumerate(_traffic())
    ]


@pytest.mark.parametrize("pool", ["f32", "bf16"])
@pytest.mark.parametrize(
    "sync_interval,n_blocks", [(1, 40), (4, 40), (1, 9), (4, 9)],
    ids=["sync1", "sync4", "sync1-tight", "sync4-tight"],
)
def test_engine_eos_deadlines_and_bf16_pool_identical_to_jax(
    weights, monkeypatch, pool, sync_interval, n_blocks
):
    """eos inside a burst (the on-device stop mask), ``deadline_exceeded``
    retirements and a bf16 pool, against the JAX engine: completions with
    their statuses, host syncs and stalls identical; pool entries within
    the module docstring's limit."""
    jparams, tparams = weights
    reqs = _eos_deadline_traffic()
    jdtype, tdtype = {"f32": (jnp.float32, torch.float32),
                      "bf16": (jnp.bfloat16, torch.bfloat16)}[pool]
    je = jp.PagedServeEngine(
        params=jparams, cfg=JCFG, n_blocks=n_blocks, attn_impl="xla", eos_id=EOS,
        cache_dtype=jdtype, sync_interval=sync_interval, preempt_on_stall=False, **ENGINE,
    )
    want = _streams(je.pump(reqs))
    te, got, bursts = _serve_port(
        tparams, reqs, monkeypatch, n_blocks=n_blocks, sync_interval=sync_interval,
        eos_id=EOS, cache_dtype=tdtype, preempt_on_stall=False,
    )
    assert got == want
    statuses = {status for _, status in got.values()}
    assert statuses == {"ok", "deadline_exceeded"}
    # some request stopped on eos before its budget
    assert any(gen[-1] == EOS and len(gen) < reqs[rid]["max_tokens"]
               for rid, (gen, _) in got.items())
    assert te.stalled_steps == je.stalled_steps
    if n_blocks == 9:
        assert te.stalled_steps > 0  # the pool is tight enough to stall
    assert te.host_syncs == je.host_syncs == bursts
    assert te.free_blocks == te.reservable_blocks == n_blocks - 1
    for name in ("k", "v"):
        t_pool = getattr(te._cache, name).float().numpy()[:, 1:]
        j_pool = np.asarray(getattr(je._cache, name), dtype=np.float32)[:, 1:]
        if pool == "f32":
            np.testing.assert_allclose(t_pool, j_pool, atol=1e-5, rtol=1e-5)
        else:
            over = np.abs(t_pool - j_pool) > BF16_STEP * np.abs(j_pool) + 2 ** -16
            assert not over.any(), f"{int(over.sum())} {name} entries over one bf16 step"


def test_int4_engine_streams_identical_to_jax(weights, monkeypatch):
    jparams, _ = weights
    j4 = jq.quantize_blocks(jparams, bits=4, kernel=False)
    reqs = _traffic(n=5, seed=4)
    je = jp.PagedServeEngine(params=j4, cfg=JCFG, n_blocks=40, attn_impl="xla",
                             sync_interval=4, **ENGINE)
    want = _streams(je.pump(reqs))
    t4 = params_from_jax(j4, device="cpu")
    assert isinstance(t4["blocks"][0]["qkv"], tq.Quantized4Matrix)
    _, got, _ = _serve_port(t4, reqs, monkeypatch, n_blocks=40, sync_interval=4)
    assert got == want


def test_paged_prefill_and_step_match_jax(weights):
    """Prefill scatter (block stripes transposed into the pool layout) and
    one ragged decode step with an inactive row."""
    jparams, tparams = weights
    prompt = np.random.RandomState(5).randint(0, 128, size=(2, 13)).astype(np.int32)
    table = np.array([[3, 1, 6, 0], [2, 5, 4, 7]], np.int32)
    jcache = jp.init_paged_cache(JCFG, 8, 8)
    tcache = tp.init_paged_cache(TCFG, 8, 8, device="cpu")
    jcache, jlast = jp.paged_prefill(jparams, jnp.asarray(prompt), jcache, jnp.asarray(table),
                                     cfg=JCFG)
    tcache, tlast = tp.paged_prefill(tparams, torch.from_numpy(prompt).long(), tcache,
                                     torch.from_numpy(table), cfg=TCFG)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), atol=1e-5, rtol=1e-5)

    tok = np.array([9, 17], np.int32)
    pos = np.array([13, 15], np.int32)
    active = np.array([True, False])
    jlog, jcache = jp.paged_decode_step(
        jparams, jcache, jnp.asarray(table), jnp.asarray(tok), jnp.asarray(pos), cfg=JCFG,
        active=jnp.asarray(active), attn_impl="xla",
    )
    tlog, tcache = tp.paged_decode_step(
        tparams, tcache, torch.from_numpy(table), torch.from_numpy(tok).long(),
        torch.from_numpy(pos), cfg=TCFG, active=torch.from_numpy(active),
    )
    np.testing.assert_allclose(tlog.numpy()[0], np.asarray(jlog)[0], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tcache.k.numpy()[:, 1:], np.asarray(jcache.k)[:, 1:],
                               atol=1e-5, rtol=1e-5)


def test_paged_greedy_decode_matches_jax_and_the_dense_path(weights):
    jparams, tparams = weights
    prompt = np.random.RandomState(6).randint(0, 128, size=(2, 9)).astype(np.int32)
    want = np.asarray(jp.paged_greedy_decode(jparams, jnp.asarray(prompt), 11, JCFG,
                                             block_size=8))
    got = tp.paged_greedy_decode(tparams, prompt, 11, TCFG, block_size=8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    dense = td.greedy_decode(tparams, prompt, 11, TCFG, batch_prefill=True, device="cpu")
    np.testing.assert_array_equal(got.numpy(), dense.numpy())


def test_failed_admission_leaves_only_freed_blocks_dirty(weights, monkeypatch):
    _, tparams = weights
    eng = tp.PagedServeEngine(params=tparams, cfg=TCFG, n_blocks=12, device="cpu", **ENGINE)
    eng.submit(list(range(1, 10)), max_tokens=3)
    k_before = eng._cache.k.clone()
    free_before = eng.free_blocks

    def boom(*_a, **_k):
        raise RuntimeError("injected admission failure")

    monkeypatch.setattr(tp, "_paged_first_token", boom)
    with pytest.raises(RuntimeError, match="injected"):
        eng.submit(list(range(20, 40)), max_tokens=3)
    assert eng.free_blocks == free_before
    assert eng.free_slots() == ENGINE["n_slots"] - 1
    per_block = (eng._cache.k != k_before).transpose(0, 1).flatten(1).any(1)
    changed = set(torch.nonzero(per_block).flatten().tolist())
    freed = set(eng._alloc._free)
    assert changed and changed <= freed | {tp.NULL_BLOCK}
    assert not eng._table_np[1].any()


def test_block_allocator_and_sizes_match_jax():
    ja, ta = jp.BlockAllocator(6), tp.BlockAllocator(6)
    for n in (2, 1, 2):
        assert ta.alloc(n) == ja.alloc(n)
    ja.free([2, 4])
    ta.free([2, 4])
    assert ta.alloc(2) == ja.alloc(2)
    assert ta.free_blocks == ja.free_blocks
    with pytest.raises(ValueError, match="double free"):
        ta.free([1, 1])
    with pytest.raises(tp.OutOfBlocks):
        ta.alloc(9)
    for dtype in (jnp.float32, jnp.bfloat16):
        assert tp.kv_block_bytes(TCFG, 16, tb.torch_dtype(dtype)) == jp.kv_block_bytes(
            JCFG, 16, dtype
        )
    assert tp.blocks_needed(17, 8) == jp.blocks_needed(17, 8) == 3


def test_unported_paths_raise(weights):
    """The two calls that raised ``NotImplementedError`` before sampling
    and preemption were ported now serve: a sampled submit, and a pump on a
    pool so tight that every resident slot stalls (the engine preempts,
    re-admits and drains, with the JAX engine's streams and counts).
    Greedy sampling keeps the first maximum on ties."""
    jparams, tparams = weights
    eng = tp.PagedServeEngine(params=tparams, cfg=TCFG, n_blocks=5, device="cpu", **ENGINE)
    je = jp.PagedServeEngine(params=jparams, cfg=JCFG, n_blocks=5, attn_impl="xla", **ENGINE)
    reqs = [(list(range(1, 8)), 20)] * 3
    streams = []
    for e in (je, eng):
        rid = e.submit([1, 2, 3], max_tokens=2, temperature=0.7)
        e.run_until_drained()
        (c,) = e.completions()
        assert (c.request_id, len(c.generated), c.status) == (rid, 2, "ok")
        streams.append((c.generated, _streams(e.pump(reqs))))
    assert streams[0] == streams[1]
    assert eng.preempted_count == je.preempted_count > 0
    assert eng.free_blocks == 4
    greedy = ts.sample_next(torch.tensor([[1.0, 3.0, 3.0]]), torch.zeros(1, dtype=torch.int32),
                            torch.zeros(1), torch.zeros((1, 2), dtype=torch.int64), top_k=0)
    assert greedy.tolist() == [1]


@pytest.mark.parametrize("make", [
    lambda **kw: td.init_cache(TCFG, 2, 8, **kw),
    lambda **kw: tp.init_paged_cache(TCFG, 4, 8, **kw),
], ids=["init_cache", "init_paged_cache"])
def test_cache_constructors_default_to_the_card(make, monkeypatch):
    """Both cache constructors follow the device rule: with no device
    argument they build on the card, and without one they raise; the CPU
    only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    cache = make(device="cpu")
    assert cache.k.device.type == cache.v.device.type == "cpu"
    assert not cache.k.any() and not cache.v.any()


# -- what capture needs: static device state, eager CPU, counted replays --

STATIC_BUFFERS = ("_table", "_active", "_last", "_pos", "_stop_pos", "_temps", "_keys",
                  "_poison", "_prompt", "_prefill_row", "_admit", "_admit_temp", "_admit_key")


def tight_drive(eng, seed=8):
    """Three slots, block 4, sync interval 4, 19 blocks: four admissions
    (prompt 9, so every 4-step burst crosses a block), one short request
    retiring in the first burst, 4-step bursts until the pool runs dry,
    then 1-step bursts until every resident slot stalls.  Returns the
    completions."""
    r = np.random.RandomState(seed)
    queue = [(r.randint(0, 128, size=9).tolist(), m) for m in (30, 2, 30, 30)]
    while True:
        while queue and eng.free_slots():
            eng.submit(*queue.pop(0))
        if eng.step_burst() == 0:
            return eng.completions()


TIGHT = dict(n_slots=3, block_size=4, prompt_bucket=24, n_blocks=19, sync_interval=4,
             preempt_on_stall=False)


def test_engine_device_state_keeps_its_addresses(weights):
    """Every tensor the engine's programs read or write keeps one address
    through admissions, a retirement, stalls and both burst lengths: a
    captured graph replays the addresses it saw.  On the CPU the programs
    run eagerly and no graph exists."""
    _, tparams = weights
    eng = tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu", **TIGHT)
    ptrs = {name: getattr(eng, name).data_ptr() for name in STATIC_BUFFERS}
    ran = []
    run = eng._run

    def checked(name, fn):
        assert {n: getattr(eng, n).data_ptr() for n in STATIC_BUFFERS} == ptrs
        ran.append(name)
        return run(name, fn)

    eng._run = checked
    comps = tight_drive(eng)
    assert {n: getattr(eng, n).data_ptr() for n in STATIC_BUFFERS} == ptrs
    assert sorted(set(ran)) == ["burst k=1", "burst k=4", "first token", "prefill"]
    assert ran.count("burst k=1") >= 3 and ran.count("burst k=4") >= 3
    assert ran.count("prefill") == ran.count("first token") == 4
    assert [c.request_id for c in comps] == [1] and eng.stalled_steps > 0
    assert eng.graphs == {}


def test_disable_graphs_nests_restores_and_changes_nothing_on_the_cpu(weights):
    _, tparams = weights
    assert ts.graphs_enabled()
    with ts.disable_graphs():
        assert not ts.graphs_enabled()
        with ts.disable_graphs():
            assert not ts.graphs_enabled()
        assert not ts.graphs_enabled()
    assert ts.graphs_enabled()
    with pytest.raises(KeyError), ts.disable_graphs():
        raise KeyError("leaves through an exception")
    assert ts.graphs_enabled()

    def serve():
        eng = tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu", **TIGHT)
        comps = tight_drive(eng)
        return eng, [(c.request_id, c.generated, c.status) for c in comps]

    eng, want = serve()
    with ts.disable_graphs():
        eager, got = serve()
    assert got == want
    assert (eager.host_syncs, eager.stalled_steps) == (eng.host_syncs, eng.stalled_steps)
    assert torch.equal(eager._cache.k, eng._cache.k) and torch.equal(eager._cache.v, eng._cache.v)
    assert eng.graphs == eager.graphs == {}


@pytest.fixture
def zeroed_counters():
    """The kernel launch counters at 0 for the test, restored after it."""
    saved = ts.launch_counts()
    ts.add_launch_counts({key: -n for key, n in saved.items()})
    yield
    now = ts.launch_counts()
    ts.add_launch_counts({key: saved[key] - now[key] for key in saved})


class _StandInGraph:
    """What a captured CUDA graph does to the counters: a replay runs the
    kernels and none of the wrappers' Python."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _program(runs):
    """A stand-in program that launches (counts) like one burst: two paged
    calls and three int4 split-K calls."""

    def fn():
        runs.append(1)
        tpa.add_launch_counts({"append": 2})
        ti4.add_launch_counts({"launches": 3, "int4_splitk": 3})
        return "output"

    return fn


def _counts():
    return (tpa.launches["append"], ti4.launches, ti4.kernel_launches["int4_splitk"])


def test_graphed_program_counts_each_call_once(zeroed_counters):
    """The warm-up call runs eagerly and counts once; the capture's change
    is taken back and added at every replay."""
    runs, graphs = [], []

    def capture(fn, device):
        graphs.append(_StandInGraph())
        return graphs[0], fn()  # capture runs the Python, launches nothing

    prog = ts.GraphedProgram("stand-in", _program(runs), "cuda", capture=capture)
    assert prog() == "output" and prog.graph is None and _counts() == (2, 3, 3)
    for n in (2, 3, 4):
        assert prog() == "output"
        assert _counts() == (2 * n, 3 * n, 3 * n)
    assert len(runs) == 2 and len(graphs) == 1     # warm-up + capture
    assert graphs[0].replays == 3 and prog.calls == 4 and prog.capture_s >= 0


def test_graphed_program_capture_failure_raises_and_leaves_counters(zeroed_counters):
    """A capture that raises names the program, leaves the counters as they
    were, runs nothing eagerly in its place, and is tried again next call."""
    runs = []

    def capture(fn, device):
        fn()
        raise RuntimeError("operation not permitted when stream is capturing")

    prog = ts.GraphedProgram("burst k=4", _program(runs), "cuda", capture=capture)
    prog()  # warm-up: eager, counted
    assert _counts() == (2, 3, 3)
    for _ in range(2):
        with pytest.raises(ts.GraphCaptureError, match="burst k=4.*not permitted"):
            prog()
        assert _counts() == (2, 3, 3) and prog.graph is None
    assert len(runs) == 3
