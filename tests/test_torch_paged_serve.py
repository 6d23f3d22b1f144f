"""Paged serving of the PyTorch port (``models/paged.py``) against the JAX
package's ``PagedServeEngine(attn_impl="xla")``, on the CPU, with the same
weights and seeded traffic.

Tolerances: greedy token streams, stall counts and host syncs identical;
float32 logits within atol = rtol = 1e-4; pool entries within 1e-5
outside the null block 0 (the JAX plain path diverts inactive rows'
writes there, the port does not write them at all)."""

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


def _serve_port(tparams, reqs, monkeypatch, **kw):
    """Serve through the port, counting bursts that reached the device and
    refusing host reads inside each burst."""
    eng = tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu", **ENGINE, **kw)
    burst = tp._paged_pipelined_burst

    def guarded(*a, **k):
        with monkeypatch.context() as m:
            _forbid_host_reads(m)
            return burst(*a, **k)

    monkeypatch.setattr(tp, "_paged_pipelined_burst", guarded)
    bursts = 0
    step_burst = eng.step_burst

    def counted():
        nonlocal bursts
        stepped = step_burst()
        bursts += stepped > 0
        return stepped

    eng.step_burst = counted
    comps = eng.pump(reqs)
    return eng, {c.request_id: c.generated for c in comps}, bursts


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
    want = {c.request_id: c.generated for c in je.pump(reqs)}
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


def test_int4_engine_streams_identical_to_jax(weights, monkeypatch):
    jparams, _ = weights
    j4 = jq.quantize_blocks(jparams, bits=4, kernel=False)
    reqs = _traffic(n=5, seed=4)
    je = jp.PagedServeEngine(params=j4, cfg=JCFG, n_blocks=40, attn_impl="xla",
                             sync_interval=4, **ENGINE)
    want = {c.request_id: c.generated for c in je.pump(reqs)}
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
    tcache = tp.init_paged_cache(TCFG, 8, 8)
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
    _, tparams = weights
    eng = tp.PagedServeEngine(params=tparams, cfg=TCFG, n_blocks=5, device="cpu", **ENGINE)
    with pytest.raises(NotImplementedError, match="temperature"):
        eng.submit([1, 2, 3], max_tokens=2, temperature=0.7)
    # a pool this tight stalls every resident slot: the JAX engine would
    # preempt one there, the port says it cannot yet
    with pytest.raises(NotImplementedError, match="preemption"):
        eng.pump([(list(range(1, 8)), 20)] * 3)
    assert ts.sample_next(torch.tensor([[1.0, 3.0, 3.0]])).tolist() == [1]
