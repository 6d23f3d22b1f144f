"""Chunked prefill, refcounted prefix sharing and the paged engine's own
snapshot and restore in the PyTorch port (``models/paged.py``), against
the JAX package's ``PagedServeEngine(attn_impl="xla")`` on the CPU with the
same weights (``weights.params_from_jax``), seeded traffic and fault
injections.

Tolerances (those of tests/test_torch_paged_serve.py, which explains
them): greedy and sampled token streams, completion statuses, host syncs,
stalls, preemptions, quarantines, prefix hits and misses, the prefix
store's keys, LRU order, block ids and reference counts identical;
float32 logits within atol = rtol = 1e-4; a float32 pool within atol =
rtol = 1e-5 from block 1 on; a bfloat16 pool within one bf16 step of the
JAX entry, (2^-7 + 2^-16) * |JAX| + 2^-16 (past the first layer, in the
chunk and suffix programs' own test, one step at the size of the layer's
largest entry: that test says why)."""

import json

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
ENGINE = dict(n_slots=3, block_size=8, prompt_bucket=32)
BF16_STEP = 2 ** -7 + 2 ** -16
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


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
    """A JAX engine and a port engine with the same settings."""
    jparams, tparams = weights
    je = jp.PagedServeEngine(params=jparams, cfg=JCFG, attn_impl="xla", **kw)
    kw = {k: {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}.get(v, v)
          if k == "cache_dtype" else v for k, v in kw.items()}
    te = tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu", **kw)
    return je, te


def _streams(comps):
    return {c.request_id: (c.generated, c.status) for c in comps}


def _counters(eng):
    return dict(host_syncs=eng.host_syncs, stalls=eng.stalled_steps,
                preempted=eng.preempted_count, quarantined=list(eng.quarantined),
                hits=eng.prefix_hits, misses=eng.prefix_misses, free=eng.free_blocks)


def _store(eng):
    """The prefix store in LRU order: key, block id, the block's references."""
    return [(key, b, eng._alloc.refcount(b)) for key, b in eng._prefix_store.items()]


def _assert_pools_close(te, je):
    """float32 pools from block 1 on within atol = rtol = 1e-5."""
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(te._cache, name).numpy()[:, 1:],
                                   np.asarray(getattr(je._cache, name))[:, 1:],
                                   atol=1e-5, rtol=1e-5)


def _assert_balanced(eng):
    """Nothing resident: every live reference is the store's own."""
    assert eng.free_blocks == eng.n_blocks - 1 - len(eng._prefix_store)
    assert eng._alloc._refs == {b: 1 for b in eng._prefix_store.values()}


def _guard_programs(monkeypatch):
    """Make every tensor-to-host read raise inside the programs the card
    captures as graphs (prefill, chunk, first token, burst)."""

    def refuse(*_a, **_k):
        raise AssertionError("host read inside a program")

    def guard(fn):
        def guarded(*a, **k):
            with monkeypatch.context() as m:
                for name in ("item", "tolist", "__bool__", "cpu", "numpy"):
                    m.setattr(torch.Tensor, name, refuse)
                return fn(*a, **k)
        return guarded

    for name in ("_paged_pipelined_burst", "_paged_first_token", "paged_prefill",
                 "paged_prefill_chunk"):
        monkeypatch.setattr(tp, name, guard(getattr(tp, name)))


def _system_traffic(n=7, seed=3, sys_blocks=2, block=8, temps=(0.0, 0.8), vocab=128,
                    n_systems=2):
    """``n`` requests, each one of ``n_systems`` seeded system prompts
    (taken in turn) of ``sys_blocks`` full blocks followed by 1-12 tokens
    of its own, 4-16 new tokens; temperatures cycle through ``temps``, odd
    requests have seeds."""
    r = np.random.RandomState(seed)
    systems = [r.randint(0, vocab, size=sys_blocks * block).tolist() for _ in range(n_systems)]
    reqs = []
    for i in range(n):
        req = dict(prompt=systems[i % n_systems]
                   + r.randint(0, vocab, size=int(r.randint(1, 13))).tolist(),
                   max_tokens=int(r.randint(4, 17)), temperature=temps[i % len(temps)])
        if i % 2:
            req["seed"] = 50 + i
        reqs.append(req)
    return reqs


# -- 1. the refcounted allocator ----------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_allocator_refcounts_match_jax(seed):
    """A seeded sequence of alloc, share and free leaves the JAX
    allocator's free list and reference counts after every operation."""
    r = np.random.RandomState(seed)
    ja, ta = jp.BlockAllocator(12), tp.BlockAllocator(12)
    held: list[int] = []
    for _ in range(200):
        op = r.choice(["alloc", "share", "free"])
        if op == "alloc" and ja.free_blocks:
            n = int(r.randint(1, ja.free_blocks + 1))
            ids = ja.alloc(n)
            assert ta.alloc(n) == ids
            held += ids
        elif op == "share" and held:
            b = held[r.randint(len(held))]
            assert ta.share(b) == ja.share(b) == b
            held.append(b)
        elif op == "free" and held:
            drop = [held.pop(r.randint(len(held))) for _ in range(r.randint(1, len(held) + 1))]
            ja.free(drop)
            ta.free(drop)
        assert ta._free == ja._free
        assert {b: ta.refcount(b) for b in range(12)} == {b: ja.refcount(b) for b in range(12)}
    for alloc in (ja, ta):
        alloc.free(held)  # every reference dropped: the whole pool is free again
        assert alloc.free_blocks == 11 and not alloc._refs
        (b,) = alloc.alloc(1)
        alloc.free([b])
        with pytest.raises(ValueError, match="double free"):
            alloc.free([b])
        with pytest.raises(ValueError, match="cannot share free block"):
            alloc.share(b)
        for bad in (0, 12, -1):
            with pytest.raises(ValueError, match="out of range"):
                alloc.free([bad])
        before = (list(alloc._free), dict(alloc._refs))
        (b,) = alloc.alloc(1)
        with pytest.raises(ValueError, match="double free"):
            alloc.free([b, b])  # atomic: nothing released
        assert alloc.refcount(b) == 1
        alloc.free([b])
        assert (list(alloc._free), dict(alloc._refs)) == before


# -- 2. the chunk and suffix programs ------------------------------------------

# (bucket, block, done blocks, chunk width or None for the suffix program)
CHUNK_CASES = {
    "first-intermediate": (32, 8, 0, 16),
    "later-final": (32, 8, 2, 16),
    "narrow-final": (32, 8, 1, 8),
    "suffix-1": (32, 8, 1, None),
    "suffix-3": (32, 8, 3, None),
    "bucket40-first": (40, 16, 0, 32),
    "bucket40-final": (40, 16, 2, 8),
    "bucket40-suffix": (40, 16, 1, None),
}


@pytest.mark.parametrize("pool", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_prefill_chunk_and_suffix_write_the_jax_pool_bytes(weights, case, pool):
    """Both programs over a seeded pool (the done blocks hold the prompt's
    history, the rest noise) write the JAX functions' bytes into the
    chunk's blocks and leave every other block as it was.  In a bf16 pool
    a first-layer entry is held to one bf16 step at its own size.  An
    entry past the first layer is projected from activations that attended
    over K/V each package rounded to bf16 on its own, so one step of an
    input moves it by up to one step of the terms summed into it, however
    small the entry itself: it is held to one bf16 step at the size of the
    layer's largest entry (the whole-prompt prefill, ``paged_prefill``,
    reaches 0.33 of that on these prompts and over 17 steps at an entry's
    own size), and to no more than the whole prefill's largest difference."""
    jparams, tparams = weights
    bucket, bs, done, width = CHUNK_CASES[case]
    jdtype, tdtype = DTYPES[pool]
    r = np.random.RandomState(len(case))
    n_blocks = 12
    mbp = -(-bucket // bs)
    shape = (JCFG.n_layers, n_blocks, JCFG.kv_heads, JCFG.head_dim, bs)
    row = np.array([r.permutation(np.arange(1, n_blocks))[:mbp]], np.int32)
    prompt = np.array([r.randint(0, 128, size=bucket)], np.int32)
    # the done blocks hold the prompt's own history (the JAX prefill's
    # bytes), every other block seeded noise the chunk must overwrite
    history = jp.paged_prefill(jparams, jnp.asarray(prompt),
                               jp.init_paged_cache(JCFG, n_blocks, bs, dtype=jdtype),
                               jnp.asarray(row), cfg=JCFG)[0]
    k0, v0 = (r.standard_normal(shape).astype(np.float32) for _ in range(2))
    for noise, hist in ((k0, history.k), (v0, history.v)):
        for b in row[0, :done]:
            noise[:, b] = np.asarray(hist[:, b], dtype=np.float32)
    jcache = jp.PagedKVCache(k=jnp.asarray(k0, jdtype), v=jnp.asarray(v0, jdtype))
    tcache = tp.PagedKVCache(k=torch.from_numpy(k0).to(tdtype), v=torch.from_numpy(v0).to(tdtype))
    before = tcache.k.clone()
    if width is None:
        jcache = jp.paged_prefill_suffix(jparams, jnp.asarray(prompt), jcache, jnp.asarray(row),
                                         cfg=JCFG, cached_blocks=done)
        tcache = tp.paged_prefill_suffix(tparams, torch.from_numpy(prompt), tcache,
                                         torch.from_numpy(row), cfg=TCFG, cached_blocks=done)
        width = bucket - done * bs
    else:
        jcache = jp.paged_prefill_chunk(jparams, jnp.asarray(prompt), jcache, jnp.asarray(row),
                                        jnp.int32(done), cfg=JCFG, chunk_len=width)
        tcache = tp.paged_prefill_chunk(tparams, torch.from_numpy(prompt), tcache,
                                        torch.from_numpy(row), torch.tensor(done, dtype=torch.int32),
                                        cfg=TCFG, chunk_len=width)
    chunk = set(row[0, done: done + -(-width // bs)].tolist())
    changed = set(torch.nonzero((tcache.k != before).transpose(0, 1).flatten(1).any(1))
                  .flatten().tolist())
    assert changed == chunk
    whole = (
        jp.paged_prefill(jparams, jnp.asarray(prompt),
                         jp.init_paged_cache(JCFG, n_blocks, bs, dtype=jdtype),
                         jnp.asarray(row), cfg=JCFG)[0],
        tp.paged_prefill(tparams, torch.from_numpy(prompt),
                         tp.init_paged_cache(TCFG, n_blocks, bs, dtype=tdtype, device="cpu"),
                         torch.from_numpy(row), cfg=TCFG)[0],
    )
    for name in ("k", "v"):
        got = getattr(tcache, name).float().numpy()
        want = np.asarray(getattr(jcache, name), dtype=np.float32)
        if pool == "f32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
            continue
        diff = np.abs(got - want)
        over = diff[0] > BF16_STEP * np.abs(want[0]) + 2 ** -16
        assert not over.any(), f"{int(over.sum())} layer-0 {name} entries over one step"
        for layer in range(1, JCFG.n_layers):
            limit = BF16_STEP * np.abs(want[layer]).max()
            assert diff[layer].max() <= limit, (layer, name, diff[layer].max(), limit)
        w_want = np.asarray(getattr(whole[0], name), dtype=np.float32)
        w_diff = np.abs(getattr(whole[1], name).float().numpy() - w_want)
        assert diff[1:].max() <= w_diff[1:].max(), (name, diff[1:].max(), w_diff[1:].max())


def test_chunks_rebuild_the_whole_prefill(weights):
    """Chunks of one and two blocks after a shared prefix give the pool
    the whole-prompt prefill gives (float32, within 1e-5), and
    ``decode_chunk(logits=False)`` writes the cache ``logits=True`` does."""
    _, tparams = weights
    r = np.random.RandomState(9)
    prompt = torch.from_numpy(np.array([r.randint(0, 128, size=32)], np.int32))
    row = torch.tensor([[3, 1, 6, 2]], dtype=torch.int32)
    whole = tp.paged_prefill(tparams, prompt, tp.init_paged_cache(TCFG, 8, 8, device="cpu"),
                             row, cfg=TCFG)[0]
    chunked = tp.init_paged_cache(TCFG, 8, 8, device="cpu")
    for done, width in ((0, 8), (1, 16), (3, 8)):
        tp.paged_prefill_chunk(tparams, prompt, chunked, row, torch.tensor(done), cfg=TCFG,
                               chunk_len=width)
    for a, b in ((chunked.k, whole.k), (chunked.v, whole.v)):
        torch.testing.assert_close(a[:, 1:], b[:, 1:], atol=1e-5, rtol=1e-5)
    caches = [td.init_cache(TCFG, 1, 32, device="cpu") for _ in range(2)]
    logits, _ = td.decode_chunk(tparams, caches[0], prompt[:, :20], 0, cfg=TCFG)
    none, _ = td.decode_chunk(tparams, caches[1], prompt[:, :20], 0, cfg=TCFG, logits=False)
    assert none is None and logits.shape == (1, 20, 128)
    assert torch.equal(caches[0].k, caches[1].k) and torch.equal(caches[0].v, caches[1].v)


# -- 3. the prefix store -------------------------------------------------------

@pytest.mark.parametrize("sync_interval", [1, 3])
def test_prefix_cache_streams_identical_and_equal_to_jax(weights, monkeypatch, sync_interval):
    """Sharing changes residency and admission compute, never tokens:
    streams with the store on equal those with it off and the JAX
    engine's, with its hits, misses, store and pool bytes."""
    reqs = _system_traffic()
    kw = dict(ENGINE, n_blocks=40, sync_interval=sync_interval, prefix_cache_blocks=4)
    je, te = _pair(weights, **kw)
    want = _streams(je.pump(reqs))
    off = tp.PagedServeEngine(params=weights[1], cfg=TCFG, device="cpu",
                              **dict(kw, prefix_cache_blocks=0))
    plain = _streams(off.pump(reqs))
    _guard_programs(monkeypatch)
    got = _streams(te.pump(reqs))
    assert got == want == plain
    assert _counters(te) == _counters(je)
    assert te.prefix_hits > 0 and te.prefix_misses > 0
    assert _store(te) == _store(je)
    _assert_pools_close(te, je)
    _assert_balanced(te)


def test_prefix_blocks_shared_not_recomputed(weights):
    """Two live requests with a common two-block prefix draw the prefix
    blocks once (refcount 3: the store and both slots); the store keeps
    one reference after both retire."""
    sys_prefix = list(np.arange(16) % 128)
    for eng in _pair(weights, n_slots=2, n_blocks=30, block_size=8, prompt_bucket=48,
                     prefix_cache_blocks=4):
        before = eng.free_blocks
        eng.submit(sys_prefix + [1, 2, 3], 20)
        used_first = before - eng.free_blocks
        eng.submit(sys_prefix + [4, 5], 20)
        used_second = (before - eng.free_blocks) - used_first
        assert used_second == used_first - 2
        shared = eng._prefix_store[tuple(sys_prefix[:8])]
        assert eng._alloc.refcount(shared) == 3
        eng.run_until_drained()
        assert eng._alloc.refcount(shared) == 1
        assert eng.free_blocks == before - len(eng._prefix_store)


@pytest.mark.parametrize("chunk", [0, 2])
def test_store_keys_lru_order_and_refcounts_follow_jax(weights, chunk):
    """After every submit and every burst the store's keys, LRU order,
    block ids and reference counts equal the JAX engine's; a store of 3
    entries evicts, and an eviction frees its block."""
    reqs = _system_traffic(n=8, seed=11, sys_blocks=2)
    je, te = _pair(weights, **dict(ENGINE, n_blocks=40, sync_interval=2,
                                   prefix_cache_blocks=3, prefill_chunk_blocks=chunk))
    for req in reqs:
        for eng in (je, te):
            while True:
                try:
                    eng.submit(**req)
                    break
                except RuntimeError:
                    eng.step_burst()
        assert _store(te) == _store(je)
        for eng in (je, te):
            eng.step_burst()
        assert _store(te) == _store(je)
        assert te._table_np.tolist() == je._table_np.tolist()
    for eng in (je, te):
        eng.run_until_drained()
    assert _streams(te.completions()) == _streams(je.completions())
    assert _counters(te) == _counters(je)
    assert len(te._prefix_store) == 3
    _assert_balanced(te)


def test_prefix_store_lru_eviction_frees_blocks(weights):
    for eng in _pair(weights, n_slots=1, n_blocks=30, block_size=8, prompt_bucket=48,
                     prefix_cache_blocks=2):
        baseline = eng.free_blocks
        for seed in range(4):  # distinct prompts of 20 tokens: two storable blocks each
            eng.submit(list((np.arange(20) + 7 * seed) % 128), 2)
            eng.run_until_drained()
        assert len(eng._prefix_store) == 2
        assert eng.free_blocks == baseline - 2


# -- 4. chunked admission -------------------------------------------------------

@pytest.mark.parametrize("temps", [(0.0,), (0.0, 0.8, 1.1)], ids=["greedy", "sampled"])
@pytest.mark.parametrize("sync_interval", [1, 3])
def test_chunked_streams_identical_and_equal_to_jax(weights, monkeypatch, sync_interval, temps):
    """Chunked admission changes when prefill runs, never the tokens: the
    same streams with chunking on and off and in the JAX engine, the same
    host syncs and stalls, the same pool bytes; at most ``graph_bound``
    programs."""
    reqs = _system_traffic(n=6, seed=13, temps=temps)
    kw = dict(ENGINE, n_blocks=40, sync_interval=sync_interval, prefill_chunk_blocks=1)
    je, te = _pair(weights, **kw)
    want = _streams(je.pump(reqs))
    plain = _streams(tp.PagedServeEngine(params=weights[1], cfg=TCFG, device="cpu",
                                         **dict(kw, prefill_chunk_blocks=0)).pump(reqs))
    ran = set()
    run = te._run
    te._run = lambda name, fn: ran.add(name) or run(name, fn)
    _guard_programs(monkeypatch)
    got = _streams(te.pump(reqs))
    assert got == want == plain
    assert _counters(te) == _counters(je)
    _assert_pools_close(te, je)
    assert {n for n in ran if n.startswith("chunk")} == {"chunk 8"}
    assert "prefill" not in ran and len(ran) <= te.graph_bound == 5
    assert not te._admitting and te.free_blocks == 39


def test_decode_interleaves_with_admission(weights):
    """Residents keep generating while a prompt admits chunk by chunk: one
    token a step for the resident, one chunk a step for the newcomer."""
    for eng in _pair(weights, n_slots=2, n_blocks=40, block_size=8, prompt_bucket=48,
                     prefill_chunk_blocks=1):
        eng.submit(list(range(1, 12)), 30)
        while eng._admitting:
            eng.step()
        a_slot = next(i for i, s in enumerate(eng._slots) if s is not None)
        eng.submit(list(np.arange(40) % 128), 5)  # five chunks
        for done in (1, 2, 3):
            before = len(eng._slots[a_slot].tokens)
            eng.step()
            assert eng._admitting and eng._admitting[0]["done"] == done
            assert len(eng._slots[a_slot].tokens) == before + 1


@pytest.mark.parametrize("sync_interval", [1, 3])
def test_chunked_composes_with_the_prefix_cache(weights, sync_interval):
    """Shared blocks count as chunks done: the second admission of a
    prompt takes fewer steps and gives the same tokens, in both packages
    alike."""
    sys_prefix = list(np.arange(16) % 128)
    out = []
    for eng in _pair(weights, n_slots=1, n_blocks=40, block_size=8, prompt_bucket=48,
                     sync_interval=sync_interval, prefill_chunk_blocks=1,
                     prefix_cache_blocks=4):
        runs = []
        for _ in range(2):
            eng.submit(sys_prefix + [5, 7], 6, temperature=0.9, seed=4)
            n = 0
            while eng._admitting:
                eng.step_burst()
                n += 1
            eng.run_until_drained()
            runs.append((n, eng.completions()[0].generated))
        assert runs[1][0] < runs[0][0] and runs[0][1] == runs[1][1]
        out.append((runs, _counters(eng)))
    assert out[0] == out[1]


# -- 5. the lifecycle with admissions -------------------------------------------

@pytest.mark.parametrize("chunk", [0, 2])
@pytest.mark.parametrize("sync_interval", [1, 3])
def test_preemption_of_shared_blocks_and_readmission_through_the_store(weights, monkeypatch,
                                                                     chunk, sync_interval):
    """A pool about half the working set: requests holding shared prefix
    blocks are evicted (their references drop, the store's stay) and
    re-admit through the store; streams, statuses, preemptions, stalls,
    hits and misses equal the JAX engine's and a roomy run's."""
    reqs = _system_traffic(n=8, seed=17, n_systems=1)
    kw = dict(ENGINE, sync_interval=sync_interval, prefix_cache_blocks=4,
              prefill_chunk_blocks=chunk, top_k=5)
    je, te = _pair(weights, n_blocks=10, **kw)
    want = _streams(je.pump(reqs))
    _guard_programs(monkeypatch)
    got = _streams(te.pump(reqs))
    roomy = _streams(tp.PagedServeEngine(params=weights[1], cfg=TCFG, device="cpu",
                                         n_blocks=60, **kw).pump(reqs))
    assert got == want == roomy
    assert _counters(te) == _counters(je)
    assert te.preempted_count > 0 and te.prefix_hits > 0
    assert _store(te) == _store(je)
    _assert_balanced(te)


def test_cancel_while_admitting(weights):
    """Cancelling the admitting head and a queued admission drops their
    queue entries and references; the rest stream as the JAX engine's."""
    reqs = _system_traffic(n=3, seed=19)
    out = []
    for eng in _pair(weights, **dict(ENGINE, n_blocks=40, prefill_chunk_blocks=1,
                                     prefix_cache_blocks=4)):
        ids = [eng.submit(**r_) for r_ in reqs]
        eng.step()
        assert [a["slot"] for a in eng._admitting] == [0, 1, 2]
        assert eng.cancel(ids[1]) and eng.cancel(ids[0])
        assert [a["slot"] for a in eng._admitting] == [2]
        eng.run_until_drained()
        comps = eng.completions()
        out.append(([(c.request_id, c.generated, c.status) for c in comps], _store(eng)))
    assert out[0] == out[1]
    assert [s for _, _, s in out[1][0]] == ["cancelled", "cancelled", "ok"]
    _assert_balanced(eng)


def _armed(pkg, seed=0, **profile):
    inj = pkg.FaultInjector(seed)
    inj.arm(pkg.FaultProfile(name="chaos", **profile))
    return inj


@pytest.mark.parametrize("fault", [
    dict(step_raise_rate=1.0, steps=(4,)),
    dict(nan_logits_rate=1.0, steps=(6,)),
], ids=["step-raise", "nan"])
def test_fault_window_skips_admitting_slots(weights, monkeypatch, fault):
    """A fault aimed at every slot at one step quarantines the residents
    and skips the slots still admitting, as the JAX engine does."""
    reqs = _system_traffic(n=5, seed=23)
    kw = dict(ENGINE, n_blocks=40, sync_interval=2, prefill_chunk_blocks=1,
              prefix_cache_blocks=4, quarantine_limit=5)
    je, te = _pair(weights, **kw)
    je.fault_injector, te.fault_injector = _armed(jf, **fault), _armed(tf, **fault)
    jcomps = je.pump(reqs)
    _guard_programs(monkeypatch)
    tcomps = te.pump(reqs)
    assert _streams(tcomps) == _streams(jcomps)
    assert {c.request_id: c.error for c in tcomps} == {c.request_id: c.error for c in jcomps}
    assert _counters(te) == _counters(je)
    assert 0 < len(te.quarantined) < len(reqs)
    _assert_balanced(te)


@pytest.mark.parametrize("queue_limit", [0, 2])
def test_pump_sheds_and_drains_with_chunk_only_steps(weights, bundles, queue_limit):
    """``pump(queue_limit=...)`` sheds the same requests while prompts
    admit, and a step that only advances a chunk (nothing resident yet)
    is progress, not a wedge, for ``pump`` and ``run_until_drained``."""
    reqs = _system_traffic(n=8, seed=29)
    kw = dict(ENGINE, n_blocks=40, sync_interval=2, prefill_chunk_blocks=1)
    je, te = _pair(weights, **kw)
    assert _streams(te.pump(reqs, queue_limit=queue_limit)) == \
        _streams(je.pump(reqs, queue_limit=queue_limit))
    assert te.shed_count == je.shed_count == len(reqs) - 3 - queue_limit
    for eng in _pair(weights, **kw):
        eng.submit(list(range(30)), 3)
        assert eng.step_burst() == 0 and eng._admitting  # a chunk, nothing decoding
        eng.run_until_drained()
        assert [len(c.generated) for c in eng.completions()] == [3]
    with pytest.raises(RuntimeError, match=r"engine wedged.*admitting \(request, blocks done\) \[\]"):
        eng = tp.PagedServeEngine(params=weights[1], cfg=TCFG, device="cpu", n_slots=1,
                                  n_blocks=3, block_size=8, prompt_bucket=16,
                                  preempt_on_stall=False)
        eng.submit(list(range(10)), 40)
        eng.run_until_drained()


# -- 6. snapshot and restore ------------------------------------------------------

FEATURES = {
    "greedy": (dict(), [dict(prompt=[5, 6, 7], max_tokens=8), dict(prompt=[9, 1], max_tokens=8)]),
    "sampled": (dict(top_k=5), [
        dict(prompt=[5, 6, 7], max_tokens=8, temperature=0.7, seed=3),
        dict(prompt=[9, 1], max_tokens=8, temperature=1.1, seed=11)]),
    "prefix": (dict(prefix_cache_blocks=4), [
        dict(prompt=[5, 6, 7, 8, 1], max_tokens=8), dict(prompt=[5, 6, 7, 8, 2], max_tokens=8)]),
    # after two steps the first request is resident, the others admitting
    "chunked": (dict(prefill_chunk_blocks=1, prefix_cache_blocks=4), [
        dict(prompt=list(range(3, 10)), max_tokens=8, temperature=0.8, seed=2),
        dict(prompt=list(range(3, 12)) + [40], max_tokens=8),
        dict(prompt=list(range(20, 33)), max_tokens=6, priority=1, deadline=4)]),
}
SNAP_ENGINE = dict(n_slots=3, n_blocks=33, block_size=4, prompt_bucket=16)


def _snap_pair(weights, feature, **extra):
    return _pair(weights, **dict(SNAP_ENGINE, **FEATURES[feature][0], **extra))


def _snapshot_after(eng, reqs, steps=2):
    for r_ in reqs:
        eng.submit(**r_)
    for _ in range(steps):
        eng.step()
    return json.loads(json.dumps(eng.snapshot_active()))


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_mid_flight_restore_continues_every_stream(weights, feature):
    """The robustness matrix for the port's paged engine: a snapshot after
    two steps, through JSON, restored into a fresh engine, finishes every
    stream as the uninterrupted run does; the document equals the JAX
    engine's at the same point (mid-admission entries included)."""
    reqs = FEATURES[feature][1]
    je, te = _snap_pair(weights, feature)
    want = _streams(_snap_pair(weights, feature)[1].pump(reqs))
    snap = _snapshot_after(te, reqs)
    jsnap = _snapshot_after(je, reqs)
    # each entry carries its telemetry trace, in host-clock times here (held
    # key for key under a fake clock in tests/test_torch_telemetry.py)
    for doc in (snap, jsnap):
        traces = [entry.pop("trace") for entry in doc["requests"]]
        assert [t["request_id"] for t in traces] == [e["request_id"] for e in doc["requests"]]
    assert snap == jsnap
    assert snap["requests"]
    if feature == "chunked":
        assert len(te._admitting) == 2  # two entries are still admitting
    assert te.release_active() == len(snap["requests"])
    assert te.completions() == [] and not te._admitting and not te._preempted
    _assert_balanced(te)
    fresh = _snap_pair(weights, feature)[1]
    assert sorted(fresh.restore(snap)) == sorted(r_["request_id"] for r_ in snap["requests"])
    fresh.run_until_drained()
    got = _streams(fresh.completions())
    assert set(got) == {r_["request_id"] for r_ in snap["requests"]}
    assert all(got[rid] == want[rid] for rid in got)
    assert fresh._next_id == len(reqs)
    _assert_balanced(fresh)


@pytest.mark.parametrize("feature", ["chunked", "sampled"])
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_paged_snapshot_restores_across_packages(weights, direction, feature):
    """A snapshot one package's paged engine writes restores into the
    other's, and both continue alike (keys cross as plain ints)."""
    reqs = FEATURES[feature][1]
    je, te = _snap_pair(weights, feature)
    snap = _snapshot_after(je if direction == "jax-to-port" else te, reqs)
    outs = []
    for eng in _snap_pair(weights, feature, sync_interval=2):
        eng.restore(json.loads(json.dumps(snap)))
        eng.run_until_drained()
        outs.append((_streams(eng.completions()), eng._next_id))
    assert outs[0] == outs[1] and len(outs[0][0]) == len(snap["requests"])


@pytest.mark.parametrize("direction", ["paged-to-dense", "dense-to-paged"])
def test_snapshot_restores_across_the_ports_engines(weights, direction):
    """A paged snapshot (mid-admission entries included) restores into the
    port's dense ``ServeEngine`` and a dense one into the paged engine;
    each stream ends as the uninterrupted run's."""
    _, tparams = weights
    reqs = FEATURES["chunked"][1]

    def paged():
        return tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu",
                                   **dict(SNAP_ENGINE, **FEATURES["chunked"][0]))

    def dense():
        return ts.ServeEngine(params=tparams, cfg=TCFG, device="cpu", n_slots=3,
                              prompt_bucket=16)

    want = _streams(paged().pump(reqs))
    writer, reader = (paged(), dense()) if direction == "paged-to-dense" else (dense(), paged())
    for r_ in reqs:
        writer.submit(**{k: v for k, v in r_.items() if k != "priority"})
    writer.step()
    snap = json.loads(json.dumps(writer.snapshot_active()))
    assert len(snap["requests"]) == 3
    assert sorted(reader.restore(snap)) == [0, 1, 2]
    reader.run_until_drained()
    got = _streams(writer.completions() + reader.completions())
    assert got == want


def test_merge_and_unrestorable_entries_match_jax(weights):
    """``merge`` joins a live engine's parked queue (its streams keep
    going, what finds no room stays parked); an entry longer than the
    bucket comes back as an "error" completion; a live engine refuses a
    plain restore."""
    outs = []
    for eng in _pair(weights, **dict(SNAP_ENGINE, n_slots=2, prefill_chunk_blocks=1)):
        eng.submit([1, 2, 3, 4, 5, 6], max_tokens=8)
        snap = {"engine": "x", "next_id": 9, "requests": [
            dict(request_id=5, tokens=[4, 5, 6, 7], prompt_len=3, max_tokens=6, deadline=None,
                 temperature=0.0, key=[0, 5], adapter=0, priority=0),
            dict(request_id=6, tokens=list(range(20)), prompt_len=12, max_tokens=20,
                 deadline=None, temperature=0.0, key=[0, 6], adapter=0, priority=0),
            dict(request_id=7, tokens=[8, 9], prompt_len=1, max_tokens=5, deadline=None,
                 temperature=0.9, key=[4294967295, 7], adapter=0, priority=2),
            dict(request_id=8, tokens=[3, 3], prompt_len=1, max_tokens=5, deadline=None,
                 temperature=0.0, key=[0, 8], adapter=0, priority=0),
        ]}
        with pytest.raises(RuntimeError, match="idle engine"):
            eng.restore(snap)
        assert eng.restore(snap, merge=True) == [5, 7, 8]
        parked = [r_["st"].request_id for r_ in eng._preempted]
        eng.run_until_drained()
        comps = eng.completions()
        errors = {c.request_id: c.error for c in comps if c.status == "error"}
        assert set(errors) == {6} and "prompt_bucket" in errors[6]
        assert eng._next_id == 9
        outs.append((parked, [(c.request_id, c.generated, c.status, c.error) for c in comps],
                     _counters(eng)))
    assert outs[0] == outs[1]
    assert outs[1][0]  # something waited parked behind the live request


@pytest.mark.parametrize("status", sorted(ts.TERMINAL_STATUSES))
def test_terminal_entry_rejected_before_any_change(weights, status):
    snap = {"engine": "x", "next_id": 8, "requests": [
        dict(request_id=3, tokens=[5, 6, 7, 8], prompt_len=2, max_tokens=4, deadline=None,
             temperature=0.0, key=[0, 0], adapter=0, priority=0),
        dict(request_id=7, tokens=[1, 2, 3], prompt_len=2, status=status),
    ]}
    for eng, err in zip(_pair(weights, **SNAP_ENGINE), (js.SnapshotRestoreError,
                                                        ts.SnapshotRestoreError), strict=True):
        for merge in (False, True):
            with pytest.raises(err, match="duplicate") as exc:
                eng.restore(dict(snap), merge=merge)
            assert (exc.value.request_id, exc.value.status) == (7, status)
        assert eng.free_slots() == eng.n_slots and eng.completions() == []
        assert eng._next_id == 0 and not eng._preempted and not eng._admitting


def test_release_active_leaves_the_allocator_balanced(weights):
    """Resident, admitting and parked requests released: nothing is
    delivered, every reference but the store's drops, in both packages
    alike."""
    reqs = _system_traffic(n=6, seed=31)
    for r_ in reqs:
        r_["max_tokens"] += 12
    out = []
    for eng in _pair(weights, **dict(ENGINE, n_blocks=12, prefix_cache_blocks=4,
                                     prefill_chunk_blocks=1)):
        queue = list(reqs)
        parked = admitting = False
        for _ in range(200):
            while queue and eng.free_slots():
                try:
                    eng.submit(**queue[0])
                except RuntimeError:
                    break
                queue.pop(0)
            eng.step()
            parked |= bool(eng._preempted)
            admitting |= bool(eng._admitting)
            if eng._preempted:
                break
        assert parked and admitting
        n = sum(st is not None for st in eng._slots) + len(eng._preempted)
        comps = eng.completions()
        assert eng.release_active() == n
        assert eng.completions() == [] and not eng._preempted and not eng._admitting
        out.append(([c.request_id for c in comps], _store(eng), eng.free_blocks))
        if isinstance(eng, tp.PagedServeEngine):
            _assert_balanced(eng)
    assert out[0] == out[1]


# -- 7. the constructor refusals and the item-11 paths ----------------------------

def test_unported_fields_raise_naming_their_item(weights):
    _, tparams = weights

    def engine(**kw):
        return tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu", **dict(ENGINE, **kw))

    # a mesh is served (tests/test_torch_sharded_serve.py); what is no
    # DeviceMesh, or a quantized pool on a mesh, is refused at construction,
    # and slot_axis without a mesh is unused, as the reference's
    with pytest.raises(TypeError, match="DeviceMesh"):
        engine(mesh=object())
    with pytest.raises(ValueError, match="single-shard only"):
        engine(mesh=object(), kv_dtype="int8")
    assert engine(slot_axis=("slice", "data"))._axis_size == 1
    # the item-11 paths behave as the reference's: a chunked handoff
    # retires at activation with its payload, the hooks are plain
    # attributes, and a "kv": None entry re-prefills
    seen = []
    for eng in _pair(weights, **ENGINE, prefix_cache_blocks=2, prefill_chunk_blocks=1):
        eng.on_prefix_store = lambda toks, n, adapter: seen.append(n)
        eng.submit(list(range(1, 12)), 3, handoff=True)
        eng.run_until_drained()
        (handed,) = eng.take_handoffs()
        assert handed["kv"].valid_len == 11 and eng.free_slots() == eng.n_slots
        assert eng.completions() == []
    assert seen == [8, 8]
    entry = dict(request_id=0, tokens=[1, 2], prompt_len=1, max_tokens=3, deadline=None,
                 temperature=0.0, key=[0, 0], adapter=0, priority=0)
    streams = []
    for eng in _pair(weights, **ENGINE):
        assert eng.restore({"next_id": 1, "requests": [dict(entry, kv=None)]}) == [0]
        eng.run_until_drained()
        streams.append([(c.request_id, c.generated, c.status) for c in eng.completions()])
        eng.on_prefix_store = eng.on_prefix_evict = None  # the default is served
        eng.submit([1, 2, 3], 2, queued_at=0.5)
        eng.run_until_drained()
        assert [c.status for c in eng.completions()] == ["ok"]
    assert streams[0] == streams[1] and len(streams[0][0][1]) == 3


def test_engine_defaults_to_the_card(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.PagedServeEngine(params=weights[1], cfg=TCFG, prefix_cache_blocks=4,
                            prefill_chunk_blocks=2)
    eng = tp.PagedServeEngine(params=weights[1], cfg=TCFG, device="cpu", prefix_cache_blocks=4,
                              prefill_chunk_blocks=2)
    assert eng.device.type == "cpu"


STATIC_BUFFERS = ("_table", "_active", "_last", "_pos", "_stop_pos", "_temps", "_keys",
                  "_poison", "_prompt", "_prefill_row", "_admit", "_admit_temp", "_admit_key",
                  "_admit_done")


@pytest.mark.parametrize("chunk", [0, 3])
def test_admission_programs_keep_their_buffers_and_their_bound(weights, monkeypatch, chunk):
    """Through chunked and suffix admissions, a preemption, a cancel, a
    snapshot and a restore, every buffer the programs read keeps its
    address, no program reads the device from the host, and the programs
    stay within ``graph_bound`` (a bucket of 36 ends inside a block, so
    chunks of 4, 12 and 20 tokens may come too)."""
    _, tparams = weights
    eng = tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu", n_slots=3, n_blocks=10,
                              block_size=8, prompt_bucket=36, sync_interval=2,
                              prefix_cache_blocks=4, prefill_chunk_blocks=chunk)

    def ptrs():
        out = {n: getattr(eng, n).data_ptr() for n in STATIC_BUFFERS}
        out["_cache"] = (eng._cache.k.data_ptr(), eng._cache.v.data_ptr())
        return out

    before = ptrs()
    ran = set()
    run = eng._run

    def checked(name, fn):
        assert ptrs() == before
        ran.add(name)
        return run(name, fn)

    eng._run = checked
    _guard_programs(monkeypatch)
    reqs = _system_traffic(n=8, seed=3, temps=(0.0, 0.9), n_systems=1)
    eng.cancel(eng.submit(**reqs[0]))
    comps = eng.completions() + eng.pump(reqs)
    assert len(comps) == len(reqs) + 1 and eng.preempted_count > 0
    eng.submit(**reqs[2])
    eng.step_burst()
    snap = eng.snapshot_active()
    eng.release_active()
    eng.restore(snap)
    eng.run_until_drained()
    assert ptrs() == before
    assert eng.prefix_hits > 0
    assert any(n.startswith("chunk") for n in ran)  # with chunk 0, the suffixes
    assert len(ran) <= eng.graph_bound == 4 + (7 if chunk else 4)
    assert eng.graphs == {}
    _assert_balanced(eng)


def test_int4_chunked_engine_streams_identical_to_jax(weights, monkeypatch):
    """With int4 block weights every projection of a chunk goes through
    ``quant.matmul_last`` (on the card the split-K kernel at M = 16): the
    same streams as the JAX engine."""
    jparams, _ = weights
    j4 = jq.quantize_blocks(jparams, bits=4, kernel=False)
    t4 = params_from_jax(j4, device="cpu")
    assert isinstance(t4["blocks"][0]["qkv"], tq.Quantized4Matrix)
    reqs = _system_traffic(n=5, seed=41)
    kw = dict(ENGINE, n_blocks=40, sync_interval=3, prefill_chunk_blocks=2, prefix_cache_blocks=4)
    want = _streams(jp.PagedServeEngine(params=j4, cfg=JCFG, attn_impl="xla", **kw).pump(reqs))
    _guard_programs(monkeypatch)
    eng = tp.PagedServeEngine(params=t4, cfg=TCFG, device="cpu", **kw)
    assert _streams(eng.pump(reqs)) == want
