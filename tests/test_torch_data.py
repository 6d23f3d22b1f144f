"""The port's host-sharded token pipeline (``models/data.py``) on four gloo
ranks of a ``(data 2, model 2)`` mesh, against the JAX package's
``TokenBatches`` on 4 virtual devices.

The reference's five tests, ported (its mesh was ``(data 4, model 2)``):
batches cover the epoch, epochs replay and reshuffle, remainders drop, the
refusals carry its messages, and the blocks feed the sharded train step.
Then: each rank's block is its rows of the JAX global batch for the same
seed and epoch, ranks that differ only on ``model`` hold the same rows,
and the mesh step and the pipeline step fed the blocks give the same
losses, bit for bit, as the same steps fed the whole batches (f32, TF32
off).
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from k8s_dra_driver_torch.parallel.ranks import RankPool
from k8s_dra_driver_tpu.models.data import TokenBatches as JaxTokenBatches
from k8s_dra_driver_tpu.parallel.mesh import MeshShape, build_mesh
from tests import torch_mesh_ranks as R
from tests.conftest import cpu_devices

LAYOUT = (0, {"data": 2, "model": 2})
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64,
           max_seq=32, rope=True)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, backend="gloo", device_type="cpu", timeout_s=120)
    yield p
    p.close()


def dataset(n=64, s=16):
    return np.arange(n * s, dtype=np.int32).reshape(n, s) % 97


def _data_index(rank):
    """The data coordinate of a rank of LAYOUT (ranks reshape (data, model))."""
    return rank // 2


def _global_batches(results, epoch_i=0):
    """Each step's global batch, reassembled from the ranks' blocks (model
    coordinate 0), and a check that the model ranks' blocks agree."""
    epochs = [r[1][epoch_i] for r in results]
    out = []
    for step in range(len(epochs[0])):
        for rank in (1, 3):
            np.testing.assert_array_equal(epochs[rank][step][0], epochs[rank - 1][step][0])
        out.append(np.concatenate([epochs[rank][step][0] for rank in (0, 2)]))
    return out


def test_batches_are_sharded_and_cover_the_epoch(pool):
    data = dataset()
    results = pool.run(R.token_batches_case, LAYOUT, data, 8, 0, [0])
    assert all(r[0] == 8 for r in results)
    for rank, (_, (epoch,)) in enumerate(results):
        for rows, shape, index, count in epoch:
            assert shape == (8, 16) and rows.shape == (4, 16)
            assert (index, count) == (_data_index(rank), 2)
    got = np.concatenate(_global_batches(results))
    assert got.shape == data.shape  # every row exactly once
    np.testing.assert_array_equal(np.sort(got, axis=0), np.sort(data, axis=0))


def test_epochs_are_deterministic_and_distinct(pool):
    data = dataset()
    a, b = (pool.run(R.token_batches_case, LAYOUT, data, 8, 5, [1, 2]) for _ in range(2))
    one, two = _global_batches(a, 0), _global_batches(a, 1)
    for x, y in zip(one, _global_batches(b, 0)):
        np.testing.assert_array_equal(x, y)  # replayable (resume)
    assert any(not np.array_equal(x, y) for x, y in zip(one, two))  # reshuffled


def test_remainder_rows_dropped(pool):
    results = pool.run(R.token_batches_case, LAYOUT, dataset(n=20), 8, 0, [0])
    assert all(r[0] == 2 and len(r[1][0]) == 2 for r in results)  # 20 // 8


def test_validation(pool):
    for data, batch, axis, pattern in (
            (dataset(), 6, "data", "not divisible"),  # data axis = 2... and 6 = 2 x 3
            (dataset(n=4), 8, "data", "< one batch"),
            (dataset(), 0, "data", "positive"),
            (dataset(), 8, "dp", "not in mesh axes")):
        got = pool.run(R.token_batches_refusal, LAYOUT, data, batch, axis)
        if batch == 6:  # 6 splits over data 2: the reference's refusal needs data 4
            assert got == [None] * 4
            got = pool.run(R.token_batches_refusal, (0, {"data": 4}), data, batch, axis)
        assert all(g is not None and pattern in g for g in got), got


def test_blocks_are_the_jax_global_batch_rows(pool):
    """Each rank's block is rows ``[d*B/2, (d+1)*B/2)`` of the JAX
    ``TokenBatches`` global batch for the same seed and epoch."""
    data = np.random.RandomState(3).randint(0, 64, (40, 17)).astype(np.int32)
    mesh = build_mesh(cpu_devices(4), MeshShape(data=2, model=2))
    results = pool.run(R.token_batches_case, LAYOUT, data, 8, 11, [0, 3])
    for ei, epoch in enumerate((0, 3)):
        want = [np.asarray(b) for b in JaxTokenBatches(data, 8, mesh, seed=11).epoch(epoch)]
        for rank, r in enumerate(results):
            d = _data_index(rank)
            assert len(r[1][ei]) == len(want) == 5
            for (rows, *_), whole in zip(r[1][ei], want):
                np.testing.assert_array_equal(rows, whole[d * 4:(d + 1) * 4])
    assert isinstance(mesh, Mesh)


@pytest.mark.parametrize("kind, layout, kw", [
    ("mesh", LAYOUT, dict(attention="flash")),
    ("pp", (0, {"pipe": 2, "data": 2}), dict(n_micro=2)),
], ids=["mesh-flash-data2-model2", "pp-pipe2-data2"])
def test_steps_fed_blocks_equal_steps_fed_whole_batches(pool, kind, layout, kw):
    data = np.random.RandomState(1).randint(0, CFG["vocab_size"], (16, 32)).astype(np.int32)
    results = pool.run(R.fed_train_case, kind, CFG, layout, data, 4, 3, **kw)
    blocks, wholes, gathered, gathered_whole = results[0]
    assert blocks == wholes and np.isfinite(blocks).all()  # bit for bit
    assert all(r[:2] == results[0][:2] for r in results)
    # the pipeline gathers each block over data once a step (4 rows x 32
    # int32 a rank); the mesh step takes its block as it is
    extra = 3 * 2 * 32 * 4 if kind == "pp" else 0
    assert gathered == gathered_whole + extra


def test_feeds_the_sharded_train_step(pool):
    """The reference's: one step on the first batch, a finite loss (jax's
    own ``sample_tokens`` data, seed 1)."""
    from k8s_dra_driver_tpu.models import burnin

    cfg = burnin.TINY
    data = np.asarray(burnin.sample_tokens(jax.random.PRNGKey(1), cfg, batch=32, seq=32))
    kw = dict(vocab_size=cfg.vocab_size, d_model=cfg.d_model, n_heads=cfg.n_heads,
              n_layers=cfg.n_layers, d_ff=cfg.d_ff, max_seq=cfg.max_seq)
    results = pool.run(R.fed_train_case, "mesh", kw, LAYOUT, data, 8, 1)
    assert np.isfinite(results[0][0]).all() and results[0][0] == results[0][1]
