"""The port's checkpoint of mesh shards (``models/train_checkpoint.py`` with
``layout=MeshLayout(...)``) on four gloo ranks (and two for the repair),
f32 on the CPU, at ``TINY`` and at the GQA + RoPE config of
``tests/test_torch_mesh_train.py``.

* The repair: before the layout, every rank of a mesh saved its shards to
  the same ``<step>/state.pt`` (the second rank raised "already saved" or
  raced the first) and a restore gave every rank one rank's shards.  Over
  ``MeshShape(model=2)`` each rank now gets its own shards back, and a
  checkpointer without a layout refuses a world of several ranks.
* A save and restore on the same mesh resumes bit for bit; under
  ``MeshShape(seq=4)`` and ``MeshShape(model=4)``, from a single-card
  checkpoint and back to one, and in the pipeline layout, the whole params
  and AdamW moments come back byte for byte, in place.
* Each shard is written once, by its primary replica; a write that fails
  on one rank raises on every rank, naming it, and leaves no step.
* ``keep`` on a mesh: only rank 0 deletes, every rank sees the same steps.
* A missing rank file or a ``like`` the layout does not fit raises with
  the step, the rank (and the leaf).
* The JAX mesh step from the same weights, saved and restored by the
  reference's checkpointer, gives the next step's loss within
  ``tests/test_torch_mesh_train.py``'s 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models.train_checkpoint import TrainCheckpointer
from k8s_dra_driver_torch.parallel.ranks import RankPool
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.parallel import mesh as jm
from tests import torch_pod_ranks as R
from tests.conftest import cpu_devices
from tests.test_torch_mesh_train import CFG, LOSS_RTOL

TINY = dict(vocab_size=512, d_model=128, n_heads=8, n_layers=2, d_ff=512, max_seq=256)
CONFIGS = {"tiny": TINY, "gqa": CFG}
DATA2_MODEL2 = {"data": 2, "model": 2}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, backend="gloo", device_type="cpu", timeout_s=120)
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool2():
    p = RankPool(2, backend="gloo", device_type="cpu", timeout_s=120)
    yield p
    p.close()


def _tokens(cfg_kw, b=4, s=32, seed=1):
    return np.random.RandomState(seed).randint(0, cfg_kw["vocab_size"], (b, s)).astype(np.int32)


def _equal(a, b):
    return len(a) == len(b) and all(x.dtype == y.dtype and np.array_equal(x, y)
                                    for x, y in zip(a, b))


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_each_rank_restores_its_own_shards(pool2, tmp_path, cfg_name):
    """The repair's test: each rank gets its own ``model`` shard back (the
    shards have equal shapes, so a rank given the other's would see no
    error), and without a layout the checkpointer refuses the world."""
    cfg_kw = CONFIGS[cfg_name]
    results = pool2.run(R.repair_case, cfg_kw, str(tmp_path / "ckpt"), _tokens(cfg_kw))
    for own, differs in results:
        assert all(own)
        assert any(differs)  # the shards differ, so a swap would show
    msgs = pool2.run(R.layoutless_refusal, str(tmp_path / "other"))
    assert all(m is not None and "layout=MeshLayout" in m for m in msgs)


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_same_mesh_resumes_bit_for_bit(pool, tmp_path, cfg_name):
    cfg_kw = CONFIGS[cfg_name]
    results = pool.run(R.resume_case, cfg_kw, DATA2_MODEL2, False, str(tmp_path / "c"),
                       _tokens(cfg_kw))
    for first, again, same, _ in results:
        assert first == again and same
    assert all(r[0] == results[0][0] for r in results)
    steps = sorted(p.name for p in (tmp_path / "c").iterdir())
    assert steps == ["2"]
    assert sorted(p.name for p in (tmp_path / "c" / "2").iterdir()) == [
        f"rank-{r}.pt" for r in range(4)]


@pytest.mark.parametrize("target", [{"seq": 4}, {"model": 4}], ids=str)
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_another_mesh_restores_the_whole_state_byte_for_byte(pool, tmp_path, cfg_name,
                                                             target):
    cfg_kw = CONFIGS[cfg_name]
    where = str(tmp_path / "c")
    saved = pool.run(R.save_whole, cfg_kw, DATA2_MODEL2, False, where, 3,
                     tokens=_tokens(cfg_kw), steps=2)[0]
    for whole, kept in pool.run(R.restore_whole, cfg_kw, target, False, where, 3):
        assert kept and _equal(whole, saved)


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_single_card_checkpoint_onto_the_mesh_and_back(pool, tmp_path, cfg_name):
    cfg_kw = CONFIGS[cfg_name]
    cfg = R.config(cfg_kw)
    fns = tb.build_train_step(cfg, lr=R.LR, device="cpu")
    params, state = fns.init(torch.Generator().manual_seed(3))
    tokens = torch.from_numpy(_tokens(cfg_kw))
    for _ in range(2):
        fns.step(params, state, tokens)
    want = R.state_bits(params, state)
    where = tmp_path / "c"
    ckpt = TrainCheckpointer(where)
    ckpt.save(2, (params, state))
    ckpt.close()
    for whole in pool.run(R.onto_mesh_and_save, cfg_kw, DATA2_MODEL2, str(where), 2, 3):
        assert _equal(whole, want)
    # and back: the mesh's step 3 into a single-card state, in place
    back_params, back_state = fns.init(torch.Generator().manual_seed(4))
    ckpt = TrainCheckpointer(where)
    ckpt.restore(3, like=(back_params, back_state))
    assert _equal(R.state_bits(back_params, back_state), want)
    plain = ckpt.restore(3)  # without like: the whole state on the CPU
    assert _equal(R.state_bits(*plain), want)
    ckpt.close()


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_pipeline_layout(pool, tmp_path, cfg_name):
    """On ``(pipe 2, model 2)``: the same mesh resumes bit for bit, the
    pipeline's shards restore onto ``(data 2, model 2)`` and into a single
    card with the whole state byte for byte."""
    cfg_kw = CONFIGS[cfg_name]
    where = str(tmp_path / "c")
    shape = {"pipe": 2, "model": 2}
    results = pool.run(R.resume_case, cfg_kw, shape, True, where, _tokens(cfg_kw))
    for first, again, same, _ in results:
        assert first == again and same
    saved = results[0][3]
    for whole, kept in pool.run(R.restore_whole, cfg_kw, DATA2_MODEL2, False, where, 2):
        assert kept and _equal(whole, saved)
    cfg = R.config(cfg_kw)
    params, state = tb.build_train_step(cfg, device="cpu").init(torch.Generator().manual_seed(8))
    ckpt = TrainCheckpointer(where)
    ckpt.restore(2, like=(params, state))
    ckpt.close()
    assert _equal(R.state_bits(params, state), saved)


def test_each_shard_is_written_once(pool, tmp_path):
    """On ``(data 2, model 2)`` each shard is written by its primary
    replica (coordinate 0 on the axes its spec does not name): rank 0 every
    leaf, rank 1 the leaves cut over ``model``, ranks 2 and 3 none; every
    rank still writes its file."""
    where = tmp_path / "c"
    pool.run(R.save_whole, CFG, DATA2_MODEL2, False, str(where), 1)
    files = [torch.load(where / "1" / f"rank-{r}.pt", weights_only=True) for r in range(4)]
    specs = files[0]["meta"]["specs"]
    n = len(specs)
    cut = [any(e == "model" or (isinstance(e, list) and "model" in e) for e in spec)
           for spec in specs]
    assert any(cut) and not all(cut)
    for r, f in enumerate(files):
        held = [t is not None for t in (*f["params"], f["count"], *f["mu"], *f["nu"])]
        want = {0: [True] * (3 * n + 1), 1: cut + [False] + cut + cut}.get(r, [False] * (3 * n + 1))
        assert held == want, r


def test_a_failed_write_raises_on_every_rank(pool, tmp_path):
    """Rank 1's write fails (a full disk): every rank raises naming rank 1
    instead of waiting at a barrier, the step's temporary directory is
    gone and no rank sees the step; the checkpointer then saves it."""
    where = tmp_path / "c"
    for msg, left, seen, after in pool.run(R.failed_write_case, CFG, DATA2_MODEL2, str(where), 1):
        assert msg == ("step 1 was not saved: rank 1: OSError: [Errno 28] No space left on "
                       "device")
        assert not left and seen == [] and after == [1]
    assert sorted(p.name for p in (where / "1").iterdir()) == [f"rank-{r}.pt" for r in range(4)]


def test_keep_on_a_mesh(pool, tmp_path):
    results = pool.run(R.keep_case, CFG, DATA2_MODEL2, str(tmp_path / "c"))
    deleted, seen = results[0]
    assert [len(d) for d, _ in results] == [1, 0, 0, 0]
    assert deleted[0].endswith("/1")
    assert all(s == [[1], [1], [2, 3], [2, 3]] for _, s in results)


def test_a_missing_rank_file_or_a_misfit_like_raises(pool, tmp_path):
    where = tmp_path / "c"
    pool.run(R.save_whole, CFG, DATA2_MODEL2, False, str(where), 4)
    # a like laid out for another mesh than the checkpointer's layout
    msgs = pool.run(R.refused_restore, CFG, DATA2_MODEL2, False, str(where), 4,
                    like_shape={"model": 4})
    for rank, m in enumerate(msgs):
        assert m.startswith("ValueError: step 4, rank %d, params." % rank) and "fit" in m
    (where / "4" / "rank-3.pt").unlink()
    msgs = pool.run(R.refused_restore, CFG, {"seq": 4}, False, str(where), 4)
    assert all(m == f"FileNotFoundError: step 4: rank 3's file rank-3.pt is missing under "
                    f"{where / '4'}" for m in msgs)


def test_the_jax_mesh_step_resumes_to_the_same_loss(pool, tmp_path):
    """The reference saves and restores its mesh state (orbax) after 2
    steps on ``(data 2, model 2)`` and takes step 3; the port does the same
    from the same weights, restoring onto ``(model 4)``."""
    from k8s_dra_driver_tpu.models.train_checkpoint import TrainCheckpointer as JCheckpointer

    jcfg = jb.ModelConfig(**CFG, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jb.init_params(jax.random.PRNGKey(0), jcfg))
    tokens = _tokens(CFG)
    mesh = jm.build_mesh(cpu_devices(4), jm.MeshShape(**DATA2_MODEL2))
    fns = jb.build_train_step(jcfg, mesh=mesh, lr=R.LR)
    with mesh:
        jparams = jax.device_put(params, jax.tree.map(
            lambda spec: NamedSharding(mesh, spec), jb.param_pspecs(jcfg),
            is_leaf=lambda x: isinstance(x, JP)))
        opt = jb.make_optimizer(R.LR).init(jparams)
        toks = jax.device_put(tokens, NamedSharding(mesh, JP("data", None)))
        for _ in range(2):
            jparams, opt, _ = fns.step(jparams, opt, toks)
        ckpt = JCheckpointer(tmp_path / "jax")
        ckpt.save(2, (jparams, opt))
        jparams, opt = ckpt.restore(2, like=(jparams, opt))
        ckpt.close()
        want = float(fns.step(jparams, opt, toks)[2])
    got = pool.run(R.carried_loss, CFG, DATA2_MODEL2, params, tokens,
                   str(tmp_path / "port"), {"model": 4})
    assert all(g == got[0] for g in got)
    np.testing.assert_allclose(got[0], want, rtol=LOSS_RTOL, atol=0)
