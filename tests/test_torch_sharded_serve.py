"""Slot-sharded serving in the port's two engines (``models/paged.py``,
``models/serve.py`` with ``mesh``/``slot_axis``) on four gloo ranks, f32 on
the CPU, TF32 off.

Each case builds the engine on every rank of one ``RankPool`` (one for the
module) from weights the JAX package made, drives seeded requests through
the reference's sharded tests' FIFO harness (``torch_mesh_ranks.
fifo_streams``) and holds every rank to the same completions, statuses,
counters and ``stats()`` counters.  The streams are held to the JAX
package's sharded engine (``mesh=`` over 4 virtual devices) for greedy
traffic, and to the port's own unsharded engine (which the other
``test_torch_*serve*`` files hold to the JAX package) for the rest:
sampled, the paged engine's full composition, preemption, a multislice
``slot_axis`` tuple and a mesh with a ``model`` axis.  The reference
promises sharded streams equal to the unsharded engine's, token for token
(``tests/test_paged_sharded.py``), and so do these.  Payloads from a shard
other than 0 (a handoff, a snapshot) equal the unsharded engine's byte for
byte, and a snapshot restores with them.  The refusals carry the
reference's messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.parallel.ranks import RankPool
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import lora as jl
from k8s_dra_driver_tpu.models import paged as jp
from k8s_dra_driver_tpu.models import serve as js
from tests import torch_mesh_ranks as R
from tests.conftest import cpu_devices

# tests/test_paged_sharded.py's model, with GQA and RoPE
JCFG = jb.ModelConfig(vocab_size=89, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
                      d_ff=128, max_seq=128, rope=True, dtype=jnp.float32)
TCFG = tb.ModelConfig.from_reference(JCFG)
BS = 16
DATA4 = (0, {"data": 4})
DATA2 = (0, {"data": 2, "model": 2})  # slots over data; model ranks hold the same slots
MULTISLICE = (2, {"data": 2})


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, backend="gloo", device_type="cpu", timeout_s=120)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jparams():
    return jb.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def bank():
    """Two adapters with nonzero B (``tests/test_lora_serve.py``'s recipe)."""
    lcfg = jl.LoraConfig(rank=4, alpha=8.0)
    adapters = []
    for seed in (1, 2):
        ad = jl.init_adapters(jax.random.PRNGKey(seed), JCFG, lcfg)
        for li, blk in enumerate(ad["blocks"]):
            for name, ab in blk.items():
                key = jax.random.fold_in(jax.random.PRNGKey(seed),
                                         li * 1000 + sum(ord(c) for c in name))
                ab["b"] = 0.3 * jax.random.normal(key, ab["b"].shape, jnp.float32)
        adapters.append(ad)
    return jax.tree.map(np.asarray, jl.stack_adapters(JCFG, lcfg, adapters))


def _jmesh(n):
    from jax.sharding import Mesh

    return Mesh(np.array(cpu_devices(n)), ("data",))


def _prompts(n, rng=7):
    r = np.random.RandomState(rng)
    return [r.randint(0, JCFG.vocab_size, size=r.randint(3, 12)).tolist() for _ in range(n)]


def _one(results):
    """The ranks' (streams, counters, ...) results: every rank's equal;
    rank 0's returned."""
    head = results[0]
    for r in results[1:]:
        assert r[0] == head[0] and r[1] == head[1]
    return head


def _unsharded(kind, params, engine_kw, reqs, bank=None, burst=False):
    eng = R.serving_engine(kind, TCFG, params, bank=bank, **engine_kw)
    return R.fifo_streams(eng, reqs, step=eng.step_burst if burst else None), eng


def _jax_streams(eng, reqs):
    return {rid: gen for rid, (gen, _) in R.fifo_streams(eng, reqs).items()}


def _generated(streams):
    return {rid: gen for rid, (gen, _) in streams.items()}


# -- the paged engine --------------------------------------------------------------

PAGED = dict(n_slots=4, n_blocks=64, block_size=BS, prompt_bucket=16)


def test_paged_greedy_streams_equal_the_jax_sharded_engine(pool, jparams, params):
    reqs = [(p, 12, {}) for p in _prompts(6)]
    jeng = jp.PagedServeEngine(params=jparams, cfg=JCFG, attn_impl="xla", mesh=_jmesh(4),
                               **PAGED)
    want = _jax_streams(jeng, reqs)
    streams, counters, comm = _one(pool.run(R.sharded_streams, "paged", TCFG, DATA4, "data",
                                            params, PAGED, reqs))
    assert _generated(streams) == want
    assert {s for _, s in streams.values()} == {"ok"}
    plain, eng = _unsharded("paged", params, PAGED, reqs)
    assert streams == plain
    # per-shard null blocks: 64 blocks over 4 shards leave 60 usable
    assert counters["reservable_blocks"] == 60 and counters["free_blocks"] == 60
    assert counters["host_syncs"] == eng.host_syncs == jeng.host_syncs
    # the steps' trace gathers, and the broadcasts of rank 0's first tokens
    assert comm["all_gather"] > 0 and comm["broadcast"] > 0


def test_paged_sampled_streams(pool, params):
    kw = dict(PAGED, n_slots=2, n_blocks=40)
    reqs = [(p, 8, dict(temperature=0.8, seed=100 + i)) for i, p in enumerate(_prompts(4, 11))]
    streams, _, _ = _one(pool.run(R.sharded_streams, "paged", TCFG, DATA2, "data", params, kw,
                                  reqs))
    assert streams == _unsharded("paged", params, kw, reqs)[0]


def test_paged_full_composition(pool, params, bank):
    """Sharded + speculative + per-request LoRA + block prefix store +
    chunked admission at once (the reference's production shape)."""
    sys_prefix = list(range(1, 1 + 2 * BS))  # two shareable full blocks
    reqs = [(sys_prefix + p, 10, dict(adapter=i % 3)) for i, p in enumerate(_prompts(6, 3))]
    kw = dict(n_slots=4, n_blocks=96, block_size=BS, prompt_bucket=64, spec_gamma=2,
              prefix_cache_blocks=4, prefill_chunk_blocks=1)
    streams, counters, _ = _one(pool.run(R.sharded_streams, "paged", TCFG, DATA2, "data",
                                         params, kw, reqs, bank))
    want, eng = _unsharded("paged", params, kw, reqs, bank)
    assert streams == want
    # a stored block serves admissions to its own shard only: the shards'
    # stores miss where the one store hit (2 blocks), and the streams agree
    assert eng.prefix_hits > counters["prefix_hits"] == 0 and counters["spec_accepted"] > 0
    base = {k: v for k, v in kw.items() if k != "spec_gamma"}
    plain = _unsharded("paged", params, base, [(p, m, {}) for p, m, _ in reqs])[0]
    assert any(plain[i] != want[i] for i in want)  # the adapters moved the streams


def test_paged_preemption(pool, jparams, params):
    """Each shard's 8-block pool is outgrown mid-flight: the shard evicts
    from itself, and the parked requests resume exactly (the roomy
    unsharded engine's streams); evictions and stalls are the JAX sharded
    engine's (an eviction from another shard frees nothing where the pool
    is short, and would show here)."""
    reqs = [([1, 2, 3, 4, 5, 6], 20, {}), ([7, 8, 9, 10, 11, 12], 20, {}),
            ([13, 14, 15, 16, 17, 18], 20, {}), ([19, 20, 21, 22, 23, 24], 20, {})]
    kw = dict(n_slots=4, block_size=4, prompt_bucket=32)
    streams, counters, _ = _one(pool.run(R.sharded_streams, "paged", TCFG, DATA2, "data",
                                         params, dict(kw, n_blocks=16), reqs, None, True))
    assert streams == _unsharded("paged", params, dict(kw, n_blocks=80), reqs)[0]
    jeng = jp.PagedServeEngine(params=jparams, cfg=JCFG, attn_impl="xla", mesh=_jmesh(2),
                               n_blocks=16, **kw)
    assert _jax_streams(jeng, reqs) == _generated(streams)
    assert counters["preempted_count"] == jeng.preempted_count >= 1
    assert counters["stalled_steps"] == jeng.stalled_steps


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_multislice_slot_axis_tuple(pool, params, kind):
    """``slot_axis=("slice", "data")`` on a 2-slice mesh: four shards,
    slice-major, with the unsharded engine's streams."""
    reqs = [(p, 10, {}) for p in _prompts(5, 17)]
    kw = PAGED if kind == "paged" else dict(n_slots=4, prompt_bucket=16)
    streams, counters, _ = _one(pool.run(R.sharded_streams, kind, TCFG, MULTISLICE,
                                         ("slice", "data"), params, kw, reqs))
    assert streams == _unsharded(kind, params, kw, reqs)[0]
    if kind == "paged":
        assert counters["reservable_blocks"] == 60  # four shards, a null block each


def test_paged_capacity_is_per_shard(pool, params):
    """A prompt whose blocks exceed one shard's pool is refused although
    the shards together have room; admissions spread over the shards."""
    kw = dict(n_slots=4, n_blocks=16, block_size=4, prompt_bucket=32)
    refused, free_after, groups, free, reservable = _one(
        pool.run(R.capacity_case, TCFG, DATA4, params, kw, list(range(1, 13)), []))
    assert "no free blocks (4 needed, 12 free across 4 shard(s))" in refused
    assert free_after == free == reservable == 12 and groups == []
    _, _, groups, free, reservable = _one(pool.run(
        R.capacity_case, TCFG, DATA2, params, dict(kw, n_blocks=32), None,
        [[1, 2, 3], [4, 5, 6], [7, 8, 9]]))
    assert groups == [0, 1] and reservable == 30 and free == 30 - 3


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_payloads_from_shard_1_and_restore(pool, params, kind):
    """A snapshot with payloads, a handoff that lands on shard 1 and the
    snapshot restored (its payloads injected) into a fresh sharded engine:
    entries, payload bytes, the handoff's slot and bytes and the restored
    streams equal the unsharded engine's."""
    kw = (dict(n_slots=4, n_blocks=32, block_size=8, prompt_bucket=32) if kind == "paged"
          else dict(n_slots=4, prompt_bucket=32))
    reqs = [(p, 12, dict(temperature=0.7 * (i % 2), seed=i)) for i, p in
            enumerate(_prompts(3, 5))]
    args = (kind, TCFG, DATA2, params, kw, reqs, list(range(2, 20)), 3)
    got = pool.run(R.payload_case, *args)
    want = R.payload_case(*args[:2], None, *args[3:])
    for r in got[1:]:
        assert r[0] == got[0][0] and r[3:] == got[0][3:]
    entries, kvs, handoff, streams, counters, fresh = got[0]
    assert entries == want[0] and streams == want[3]
    if kind == "paged":  # the second shard's null block
        for c in (counters, fresh):
            for key in ("free_blocks", "reservable_blocks", "stats.free_blocks"):
                c[key] += 1
    assert counters == want[4] and fresh == want[5]
    assert handoff[:2] == want[2][:2] and handoff[1] == 3  # slot 3: shard 1 of 2
    for a, b in zip(handoff[2:], want[2][2:]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert sorted(kvs) == sorted(want[1])
    for rid, planes in kvs.items():
        assert all(a.tobytes() == b.tobytes() for a, b in zip(planes, want[1][rid]))
    assert any(e["temperature"] > 0 for e in entries)


def test_paged_refusals(pool, params):
    cases = [
        (DATA4, "nope", PAGED, "not a mesh axis"),
        (MULTISLICE, ("slice", "nope"), PAGED, "slot_axis"),
        (DATA4, "data", dict(PAGED, n_slots=3), r"n_slots \(3\) must divide"),
        (DATA4, "data", dict(PAGED, n_blocks=66), r"n_blocks \(66\) must divide"),
        (DATA4, "data", dict(PAGED, n_blocks=4), "null block"),
        (DATA4, "data", dict(PAGED, kv_dtype="int8"), "single-shard only"),
    ]
    import re

    for layout, axis, kw, pattern in cases:
        got = pool.run(R.engine_refusal, "paged", TCFG, layout, axis, params, kw)
        assert got[0] is not None and re.search(pattern, got[0][1]), (kw, got[0])
        assert got[0][0] == "ValueError" and all(g == got[0] for g in got)


# -- the dense engine --------------------------------------------------------------

DENSE = dict(n_slots=4, prompt_bucket=32)


@pytest.mark.parametrize("prefix", [False, True])
def test_dense_greedy_streams_equal_the_jax_sharded_engine(pool, jparams, params, prefix):
    sys_prefix = list(range(1, 9))
    kw = dict(DENSE, prefix_bucket=8, prefix_cache_entries=4) if prefix else DENSE
    reqs = [((sys_prefix if prefix else []) + p, 10, {}) for p in _prompts(6, 13)]
    jeng = js.ServeEngine(params=jparams, cfg=JCFG, mesh=_jmesh(4), **kw)
    want = _jax_streams(jeng, reqs)
    streams, counters, _ = _one(pool.run(R.sharded_streams, "dense", TCFG, DATA4, "data",
                                         params, kw, reqs))
    assert _generated(streams) == want
    assert counters["host_syncs"] == jeng.host_syncs
    if prefix:
        assert (counters["prefix_hits"], counters["prefix_misses"]) == (
            jeng.prefix_hits, jeng.prefix_misses) and jeng.prefix_hits > 0


def test_dense_speculation_with_the_sharded_draft_cache(pool, params, bank):
    """``spec_gamma`` on a mesh: the draft cache shards with the slots
    (``tests/test_spec_serve.py``'s mesh cases), with the prefix store and
    an adapter at once; the unsharded engine's streams."""
    sys_prefix = list(range(1, 9))
    reqs = [(sys_prefix + p, 8, dict(adapter=i % 2)) for i, p in enumerate(_prompts(4, 11))]
    kw = dict(DENSE, spec_gamma=2, prefix_bucket=8)
    streams, counters, _ = _one(pool.run(R.sharded_streams, "dense", TCFG, DATA4, "data",
                                         params, kw, reqs, bank))
    assert streams == _unsharded("dense", params, kw, reqs, bank)[0]
    assert counters["spec_accepted"] > 0 and counters["prefix_hits"] > 0


def test_dense_refusals(pool, params):
    for layout, axis, kw, pattern in (
            (DATA4, "data", dict(DENSE, n_slots=3), "must divide over 'data' axis size 4"),
            (DATA4, "model", DENSE, None)):
        got = pool.run(R.engine_refusal, "dense", TCFG, layout, axis, params, kw)
        assert all(g == got[0] for g in got)
        if pattern is None:  # a one-shard axis: nothing to refuse
            assert got[0] is None
        else:
            assert got[0][0] == "ValueError" and pattern in got[0][1]


def test_the_reference_reads_shard_0_for_a_shard_1_payload(jparams, params):
    """A fault of the reference that the port does not copy: the JAX
    sharded paged engine gathers a payload's shard-local block ids from the
    global pool (``paged.py`` ``_capture_kv``), so a slot on shard 1 gets
    shard 0's blocks.  The port's payload from shard 1 is the unsharded
    engine's (``test_payloads_from_shard_1_and_restore``); here the
    reference's snapshot of slot 2 (shard 1 of 2) leaves its unsharded
    engine's while slots 0 and 1 (shard 0) do not."""
    kw = dict(n_slots=4, n_blocks=32, block_size=8, prompt_bucket=32, attn_impl="xla")
    planes = []
    for mesh in (None, _jmesh(2)):
        eng = jp.PagedServeEngine(params=jparams, cfg=JCFG, mesh=mesh, **kw)
        for p in _prompts(3, 5):
            eng.submit(p, 12)
        eng.step()
        planes.append([np.asarray(r["kv"].k)
                       for r in eng.snapshot_active(include_kv=True)["requests"]])
    assert [np.array_equal(a, b) for a, b in zip(*planes)] == [True, True, False]
