"""Quantized KV pools in the PyTorch port (``paged.PagedServeEngine(
kv_dtype="int8"|"int4")``) against the JAX package's XLA route
(``PagedServeEngine(kv_dtype=..., attn_impl="xla")``), on the CPU, in
float32: the same weights (made by the JAX package, loaded through
``params_from_jax``), the same seeded traffic.

Tolerances: block quantization of the same float input is byte-exact
(bytes and scales), and so is one block write.  Where the two packages'
own float K/V meet the quantizer (their f32 sums differ in order), pooled
values agree within one quantization step (the block's scale) and scales
within 1e-5 relative; logits within 1e-4 (the burn-in tests' bound).
Token streams, statuses and pool counters exact."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models import quant as tq
from k8s_dra_driver_torch.ops import paged_attention as tpa
from k8s_dra_driver_torch.utils import metrics as tm
from k8s_dra_driver_torch.models.weights import params_from_jax
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import paged as jp
from k8s_dra_driver_tpu.models import quant as jq
from k8s_dra_driver_tpu.utils import metrics as jm

JCFG = jb.ModelConfig(
    vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
    d_ff=128, max_seq=64, rope=True, dtype=jnp.float32,
)
TCFG = tb.ModelConfig.from_reference(JCFG)
ENGINE = dict(n_slots=3, n_blocks=40, block_size=8, prompt_bucket=32)
KV = ["int8", "int4"]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module, restored afterwards: the
    suite's other workers keep their cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


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
    jparams, tparams = weights
    kw = dict(ENGINE, **kw)
    return (jp.PagedServeEngine(params=jparams, cfg=JCFG, attn_impl="xla", **kw),
            tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu", **kw))


def _streams(comps):
    return {c.request_id: (c.generated, c.status) for c in comps}


def _counters(eng):
    return dict(host_syncs=eng.host_syncs, stalls=eng.stalled_steps,
                preempted=eng.preempted_count, hits=eng.prefix_hits,
                misses=eng.prefix_misses, blocks=eng.free_blocks)


def _traffic(n=6, seed=3, budget=(4, 16), plen=(3, 18), sampled=True):
    r = np.random.RandomState(seed)
    return [dict(prompt=r.randint(0, 128, size=int(r.randint(*plen))).tolist(),
                 max_tokens=int(r.randint(*budget)),
                 temperature=0.7 if sampled and i % 2 else 0.0, seed=50 + i)
            for i in range(n)]


def _assert_pools_close(tcache, jcache, start=1):
    """Dequantized values within one quantization step of the JAX pool's
    (the larger of the two blocks' scales), scales within 1e-5 relative,
    from block ``start`` on (block 0 is the null block)."""
    for name in ("k", "v"):
        tq_, jq_ = getattr(tcache, name)[:, start:], np.asarray(getattr(jcache, name))[:, start:]
        ts_ = getattr(tcache, f"{name}_scale")[:, start:]
        js_ = np.asarray(getattr(jcache, f"{name}_scale"))[:, start:]
        np.testing.assert_allclose(ts_.numpy(), js_, rtol=1e-5, atol=0)
        got = tq.dequant_kv_blocks(tq_, ts_).numpy()
        want = np.asarray(jq.dequant_kv_blocks(jnp.asarray(jq_), jnp.asarray(js_)))
        step = np.maximum(ts_.numpy(), js_)[..., None, None]
        assert (np.abs(got - want) <= step * (1 + 1e-6)).all()


# -- the block codec ------------------------------------------------------------------

def _stripes(seed=0):
    """Float block stripes ``[L, n, Hkv, hd, bs]``: random blocks, an
    all-zero block, and blocks whose values sit on rounding ties (amax 127
    and 7: scale 1, so x.5 rounds half to even)."""
    r = np.random.RandomState(seed)
    x = (r.standard_normal((2, 5, 2, 16, 8)) * 3).astype(np.float32)
    x[0, 1] = 0.0
    ties = np.resize(np.array([0.5, 1.5, 2.5, -2.5, -0.5, 3.5], np.float32), (2, 16, 8))
    x[1, 2] = ties
    x[1, 2, 0, 0, 0] = 127.0
    x[1, 3] = ties
    x[1, 3, 0, 0, 0] = 7.0
    return x


@pytest.mark.parametrize("kv_dtype", KV)
def test_block_codec_bytes_equal_jax(kv_dtype):
    """``quantize_kv_blocks`` and ``dequant_kv_blocks`` against the JAX
    package's on the same input: bytes, dtypes and scales exact, an
    all-zero block at scale 1.0, ties rounded half to even."""
    x = _stripes()
    jqv, jsc = jq.quantize_kv_blocks(jnp.asarray(x), kv_dtype)
    tqv, tsc = tq.quantize_kv_blocks(torch.from_numpy(x), kv_dtype)
    assert str(tqv.dtype).removeprefix("torch.") == str(jqv.dtype)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    assert tsc[0, 1].eq(1.0).all()
    np.testing.assert_array_equal(
        tq.dequant_kv_blocks(tqv, tsc).numpy(), np.asarray(jq.dequant_kv_blocks(jqv, jsc)))
    ints = tq.unpack_int4(tqv) if kv_dtype == "int4" else tqv
    assert ints.dtype == torch.int8 and ints[0, 1].eq(0).all()
    assert ints[1, 2 if kv_dtype == "int8" else 3, 0, 0, 1:6].tolist() == [2, 2, -2, 0, 4]


@pytest.mark.parametrize("kv_dtype", KV)
def test_init_pool_zeros_and_scales(kv_dtype):
    """A fresh pool equals the JAX package's: int8 zeros or int4 ``0x88``
    (both nibbles a biased 0) on ``block_size // 2`` lanes, every scale
    1.0; the cache derives its mode and block size from the dtype."""
    jc = jp.init_paged_cache(JCFG, 6, 8, kv_dtype=kv_dtype)
    tc = tp.init_paged_cache(TCFG, 6, 8, device="cpu", kv_dtype=kv_dtype)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)))
    assert (tc.quantized, tc.kv_dtype, tc.block_size) == (True, kv_dtype, 8)
    if kv_dtype == "int4":
        assert tc.k.shape[-1] == 4 and tc.k.eq(0x88).all()
        with pytest.raises(ValueError, match="even block_size"):
            tp.init_paged_cache(TCFG, 6, 7, device="cpu", kv_dtype="int4")
    plain = tp.init_paged_cache(TCFG, 6, 8, device="cpu")
    assert (plain.quantized, plain.kv_dtype, plain.k_scale) == (False, None, None)


def test_block_bytes_equal_jax():
    """``kv_block_bytes`` (values plus one f32 scale per layer and KV head)
    equals the JAX package's for f32, bf16, int8 and int4, and at the
    flagship's geometry, block 16: 131072 B (bf16), 65792 B (int8),
    33024 B (int4)."""
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
                     ("int8", "int8"), ("int4", "int4")):
        for bs in (8, 16):
            assert tp.kv_block_bytes(TCFG, bs, tdt) == jp.kv_block_bytes(JCFG, bs, jdt)
    flagship = [tp.kv_block_bytes(tb.FLAGSHIP_MODERN, 16, d)
                for d in (torch.bfloat16, "int8", "int4")]
    assert flagship == [131072, 65792, 33024]


@pytest.mark.parametrize("kv_dtype", KV)
def test_block_write_equals_jax_on_a_recycled_block(kv_dtype):
    """``_quantized_block_write`` into blocks holding a previous owner's
    stale lanes, against the JAX function on the same pool: bytes and
    scales exact, the lanes past each offset zero (so the stale lanes
    never reach the new scale)."""
    r = np.random.RandomState(5)
    stale = (r.standard_normal((2, 6, 2, 16, 8)) * 2).astype(np.float32)
    jpool, jsc = jq.quantize_kv_blocks(jnp.asarray(stale), kv_dtype)
    tpool, tsc = (t.clone() for t in tq.quantize_kv_blocks(torch.from_numpy(stale), kv_dtype))
    bids, offs = np.array([3, 1, 5], np.int32), np.array([0, 4, 7], np.int32)
    vals = r.standard_normal((3, 2, 16)).astype(np.float32)
    jpool, jsc = jp._quantized_block_write(jpool, jsc, 1, jnp.asarray(bids), jnp.asarray(offs),
                                           jnp.asarray(vals), kv_dtype)
    tp._quantized_block_write(tpool, tsc, 1, torch.from_numpy(bids).long(),
                              torch.from_numpy(offs).long(), torch.from_numpy(vals), kv_dtype)
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    deq = tq.dequant_kv_blocks(tpool[1], tsc[1]).numpy()
    for b, off in zip(bids, offs):
        assert (deq[b, ..., off + 1:] == 0).all() and (deq[b, ..., off] != 0).any()
    untouched = [i for i in range(6) if i not in bids]
    np.testing.assert_array_equal(tpool[1, untouched].numpy(), np.asarray(jpool)[1, untouched])


@pytest.mark.parametrize("kv_dtype", KV)
def test_decode_chunk_matches_the_jax_xla_route(weights, kv_dtype, monkeypatch):
    """Prefill two rows into a quantized pool, then score a 3-token window
    with the second row inactive (its writes go to the null block), in
    both packages: logits within 1e-4 and pools within one quantization
    step of the JAX route's.  The append kernel is never called: the
    quantized route is chosen by the pool's dtype."""
    jparams, tparams = weights

    def refuse(*a, **k):
        raise AssertionError("the quantized route called the append kernel")

    monkeypatch.setattr(tpa, "paged_append_attention", refuse)
    r = np.random.RandomState(9)
    prompt = r.randint(0, 128, size=(2, 12)).astype(np.int32)
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 0]], np.int32)
    jc = jp.init_paged_cache(JCFG, 8, 8, kv_dtype=kv_dtype)
    tc = tp.init_paged_cache(TCFG, 8, 8, device="cpu", kv_dtype=kv_dtype)
    jc, jlast = jp.paged_prefill(jparams, jnp.asarray(prompt), jc, jnp.asarray(table), cfg=JCFG)
    tc, tlast = tp.paged_prefill(tparams, torch.from_numpy(prompt), tc,
                                 torch.from_numpy(table), cfg=TCFG)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=1e-4, rtol=1e-4)
    _assert_pools_close(tc, jc)
    window = r.randint(0, 128, size=(2, 3)).astype(np.int32)
    pos = np.array([12, 12], np.int32)
    active = np.array([True, False])
    jlogits, jc = jp.paged_decode_chunk(jparams, jc, jnp.asarray(table), jnp.asarray(window),
                                        jnp.asarray(pos), cfg=JCFG, active=jnp.asarray(active),
                                        attn_impl="xla")
    tlogits, tc2 = tp.paged_decode_chunk(tparams, tc, torch.from_numpy(table),
                                         torch.from_numpy(window), torch.from_numpy(pos),
                                         cfg=TCFG, active=torch.from_numpy(active))
    assert tc2 is tc
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
    _assert_pools_close(tc, jc)


@pytest.mark.parametrize("kv_dtype", KV)
def test_chunk_prefill_dequantizes_the_row_and_quantizes_its_blocks(weights, kv_dtype):
    """``paged_prefill_chunk`` over a quantized pool, two chunks of one
    block then the rest, against the JAX package's: pools within one
    step."""
    jparams, tparams = weights
    prompt = np.zeros((1, 32), np.int32)
    prompt[0, :21] = np.random.RandomState(2).randint(0, 128, size=21)
    row = np.array([[2, 3, 4, 5]], np.int32)
    jc = jp.init_paged_cache(JCFG, 8, 8, kv_dtype=kv_dtype)
    tc = tp.init_paged_cache(TCFG, 8, 8, device="cpu", kv_dtype=kv_dtype)
    for done, width in ((0, 8), (1, 8), (2, 8)):
        jc = jp.paged_prefill_chunk(jparams, jnp.asarray(prompt), jc, jnp.asarray(row),
                                    jnp.int32(done), cfg=JCFG, chunk_len=width)
        tp.paged_prefill_chunk(tparams, torch.from_numpy(prompt), tc, torch.from_numpy(row),
                               torch.tensor(done, dtype=torch.int32), cfg=TCFG, chunk_len=width)
    _assert_pools_close(tc, jc)


# -- the engine -------------------------------------------------------------------------

SCENARIOS = {
    "plain": dict(engine={}, traffic={}),
    "chunked_prefix": dict(engine=dict(prefix_cache_blocks=8, prefill_chunk_blocks=1),
                           traffic=dict(system=16)),
    "preemption": dict(engine=dict(n_blocks=8, sync_interval=2),
                       traffic=dict(n=7, budget=(12, 24))),
    "spec_gamma4": dict(engine=dict(spec_gamma=4), traffic=dict(sampled=False)),
    "spec_gamma4_block4": dict(engine=dict(spec_gamma=4, block_size=4, n_blocks=60),
                               traffic=dict(sampled=False)),
}


def _scenario_traffic(n=6, system=0, sampled=True, budget=(4, 16)):
    reqs = _traffic(n, sampled=sampled, budget=budget)
    if system:
        head = np.random.RandomState(4).randint(0, 128, size=system).tolist()
        for r in reqs:
            r["prompt"] = head + r["prompt"][:10]
    return reqs


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("kv_dtype", KV)
def test_engine_streams_equal_jax(weights, bundles, kv_dtype, scenario):
    """Greedy and sampled traffic through a quantized pool: the JAX
    engine's streams, statuses and pool counters, under chunked admission
    with prefix sharing, preemption on a tight pool, and gamma-4
    speculation (over blocks of 8, and of 4, where the window ``gamma + 1``
    is wider than a block: the quantized route takes any window on any
    device)."""
    spec = SCENARIOS[scenario]
    reqs = _scenario_traffic(**spec["traffic"])
    je, te = _pair(weights, kv_dtype=kv_dtype, **spec["engine"])
    want = _streams(je.pump(reqs))
    got = _streams(te.pump(reqs))
    assert got == want and len(got) == len(reqs)
    assert _counters(te) == _counters(je)
    assert te._cache.kv_dtype == kv_dtype and te.n_blocks == je.n_blocks
    if scenario == "preemption":
        assert te.preempted_count > 0
    if scenario == "chunked_prefix":
        assert te.prefix_hits > 0
    _assert_pools_close(te._cache, je._cache)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("kv_dtype", KV)
def test_snapshot_restores_across_packages(weights, kv_dtype, direction):
    """A quantized engine's snapshot after three steps restores into the
    other package's quantized engine; both continue alike, and as the
    uninterrupted run."""
    reqs = _traffic(3, seed=11, budget=(8, 16), plen=(3, 12))
    want = _streams(_pair(weights, kv_dtype=kv_dtype)[1].pump(reqs))
    je, te = _pair(weights, kv_dtype=kv_dtype)
    writer = je if direction == "jax-to-port" else te
    for r in reqs:
        writer.submit(**r)
    for _ in range(3):
        writer.step()
    done = _streams(writer.completions())
    snap = json.loads(json.dumps(writer.snapshot_active()))
    assert snap["requests"]
    outs = []
    for eng in _pair(weights, kv_dtype=kv_dtype):
        eng.restore(json.loads(json.dumps(snap)))
        eng.run_until_drained()
        outs.append(_streams(eng.completions()))
    assert outs[0] == outs[1]
    assert {**done, **outs[1]} == want


@pytest.mark.parametrize("kv_dtype", ["int8", "int4", "bfloat16"])
def test_pool_budget_and_kv_bytes_gauge_equal_jax(weights, kv_dtype):
    """``pool_hbm_bytes`` buys the JAX engine's block count (a float name
    sets ``cache_dtype``), and ``tpu_serve_kv_bytes`` reports the JAX
    engine's value under its label."""
    budget = 40 * tp.kv_block_bytes(TCFG, 8, torch.bfloat16)
    tm.REGISTRY.reset()
    jm.REGISTRY.reset()
    je, te = _pair(weights, kv_dtype=kv_dtype, pool_hbm_bytes=budget)
    assert te.n_blocks == je.n_blocks
    if kv_dtype == "bfloat16":
        assert te.kv_dtype is None and te.cache_dtype == torch.bfloat16
    else:
        assert te.n_blocks == budget // tp.kv_block_bytes(TCFG, 8, kv_dtype) > 40 * 1.9
    for eng in (je, te):
        eng.submit([1, 2, 3], 2)
        eng.run_until_drained()
    got = tm.parse_prom_text(tm.REGISTRY.render())["tpu_serve_kv_bytes"]
    want = jm.parse_prom_text(jm.REGISTRY.render())["tpu_serve_kv_bytes"]
    assert got == want and len(got) == 1


def test_engine_checks(weights):
    """int4 needs an even block size; junk names raise; the verify-window
    rule of the append kernel does not apply to a quantized pool on any
    device (called directly: no card needed)."""
    with pytest.raises(ValueError, match="even block_size"):
        _pair(weights, kv_dtype="int4", block_size=7)
    with pytest.raises(ValueError):
        tp.PagedServeEngine(params=weights[1], cfg=TCFG, device="cpu", kv_dtype="int3",
                            **ENGINE)
    with pytest.raises(ValueError, match="exceeds block_size"):
        tp.check_verify_window(4, 4, "cuda")
    for kv_dtype in KV:
        tp.check_verify_window(4, 4, "cuda", kv_dtype)


@pytest.mark.parametrize("kv_dtype", [None, *KV])
@pytest.mark.parametrize("n_blocks", [6, 9])
def test_pool_n_blocks_is_the_references(kv_dtype, n_blocks):
    """``PagedKVCache.n_blocks`` (reference ``models/paged.py:122``) of a
    float, int8 and int4 pool equals the JAX pool's."""
    jc = jp.init_paged_cache(JCFG, n_blocks, 8, kv_dtype=kv_dtype)
    tc = tp.init_paged_cache(TCFG, n_blocks, 8, device="cpu", kv_dtype=kv_dtype)
    assert tc.n_blocks == jc.n_blocks == n_blocks
