"""The port's mesh training step against the JAX package's, f32, on the CPU.

Each case runs ``build_train_step(mesh=...)`` on four gloo ranks (one
``RankPool`` for the module; the world-1 mesh on a pool of its own) from
weights the JAX package made, on tokens from a seeded numpy generator, and
holds it to the JAX step on one device (one compile per config) and, for
the ring on a data x seq mesh, to the JAX mesh step itself:

* losses over 3 steps within 1e-5 relative (``tests/test_torch_train.py``'s
  bound: the same f32 arithmetic summed in another order, here also across
  ranks);
* step-1 gradients (before any update) within 1e-5 of each leaf's largest
  element, per element: the all-reduces sum the ranks' parts in another
  order;
* params after 3 steps within 1e-4 relative L2 of each leaf and every
  element within 3 x lr (Adam moves an element with a near-0 gradient by
  up to lr whatever its sign, as that file explains).

The refusals carry the reference's messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from k8s_dra_driver_torch.parallel.ranks import RankPool
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.parallel import mesh as jm
from tests import torch_mesh_ranks as R
from tests.conftest import cpu_devices

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
PARAM_RTOL_L2 = 1e-4
LR = 3e-4
STEPS = 3
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64,
           max_seq=32, rope=True)
# tests/test_moe_serve.py's sharded MoE config: GQA, RoPE, 4 experts, top 2
MOE = dict(vocab_size=96, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=128,
           max_seq=128, rope=True, n_experts=4, moe_top_k=2)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, backend="gloo", device_type="cpu", timeout_s=120)
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool1():
    p = RankPool(1, backend="gloo", device_type="cpu", timeout_s=120)
    yield p
    p.close()


_REFERENCE: dict = {}


def _tokens(cfg_kw, b=4, s=32, seed=1):
    return np.random.RandomState(seed).randint(0, cfg_kw["vocab_size"], (b, s)).astype(np.int32)


def _reference(cfg_kw, accum_steps=1):
    """(numpy params, tokens, JAX single-device losses over STEPS, step-1
    gradients, params after STEPS), made once per config."""
    key = (tuple(sorted(cfg_kw.items())), accum_steps)
    if key not in _REFERENCE:
        jcfg = jb.ModelConfig(**cfg_kw, dtype=jnp.float32)
        fns = jb.build_train_step(jcfg, accum_steps=accum_steps)
        params, opt = fns.init(jax.random.PRNGKey(0))
        np_params = jax.tree.map(np.asarray, params)
        tokens = _tokens(cfg_kw)
        grads = jax.jit(jax.grad(lambda p, t: jb.loss_fn(p, t, jcfg)))(params, tokens)
        losses = []
        for _ in range(STEPS):
            params, opt, loss = fns.step(params, opt, tokens)
            losses.append(float(loss))
        _REFERENCE[key] = (np_params, tokens, losses, jax.tree.map(np.asarray, grads),
                           jax.tree.map(np.asarray, params))
    return _REFERENCE[key]


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [np.asarray(tree)]


def _check(result, losses, grads, params_after):
    got_losses, got_after, got_grads = result[0]
    np.testing.assert_allclose(got_losses, losses, rtol=LOSS_RTOL, atol=0)
    for g, w in zip(_flat(got_grads), _flat(grads), strict=True):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL * np.abs(w).max(), rtol=0)
    for g, w in zip(_flat(got_after), _flat(params_after), strict=True):
        assert np.linalg.norm(g - w) <= PARAM_RTOL_L2 * np.linalg.norm(w)
        np.testing.assert_allclose(g, w, atol=STEPS * LR, rtol=0)
    # every rank reports the same global loss
    assert all(r[0] == got_losses for r in result)


CASES = {
    # the card's "train mesh" legs (a)-(d), then the other meshes
    "a-ring-flash-seq4": (CFG, (0, {"seq": 4}), dict(attention="flash")),
    "b-flash-data2-model2": (CFG, (0, {"data": 2, "model": 2}), dict(attention="flash")),
    "c-ulysses-flash-seq4": (CFG, (0, {"seq": 4}),
                             dict(attention="flash", sequence_parallel="ulysses")),
    "d-multislice-2x-data2": (CFG, (2, {"data": 2}), dict(attention="flash")),
    "ring-dense-data2-seq2": (CFG, (0, {"data": 2, "seq": 2}), dict()),
    "ring-tp-seq2-model2": (CFG, (0, {"seq": 2, "model": 2}), dict(sequence_parallel="ring")),
    "none-dense-data2-seq2": (CFG, (0, {"data": 2, "seq": 2}), dict(sequence_parallel="none")),
    "dots-ring-flash-seq2-model2": (CFG, (0, {"seq": 2, "model": 2}),
                                    dict(attention="flash", remat="dots")),
    "moe-data2-model2": (MOE, (0, {"data": 2, "model": 2}), dict()),
    "moe-flash-seq2-model2": (MOE, (0, {"seq": 2, "model": 2}), dict(attention="flash")),
    # fewer KV groups than model ranks (the dry run's GQA leg at model 4):
    # the projection gathered whole, each rank its query heads' groups
    "kv-split-model4": (CFG, (0, {"model": 4}), dict()),
    "kv-split-flash-data2-model2": (dict(CFG, n_kv_heads=1), (0, {"data": 2, "model": 2}),
                                    dict(attention="flash")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_step_matches_the_single_device_reference(pool, case):
    cfg_kw, layout, kw = CASES[case]
    params, tokens, losses, grads, after = _reference(cfg_kw)
    _check(pool.run(R.train_case, cfg_kw, layout, params, tokens, STEPS, **kw),
           losses, grads, after)


def test_accumulation_matches_the_reference(pool):
    params, tokens, losses, grads, after = _reference(CFG, accum_steps=2)
    result = pool.run(R.train_case, CFG, (0, {"data": 2, "seq": 2}), params, tokens, STEPS,
                      accum_steps=2)
    _check(result, losses, grads, after)


def test_world_of_one(pool1):
    """Leg (e)'s mesh, ``MeshShape()`` over one rank (gloo here; NCCL on the
    card)."""
    params, tokens, losses, grads, after = _reference(CFG)
    _check(pool1.run(R.train_case, CFG, (0, {}), params, tokens, STEPS, attention="flash"),
           losses, grads, after)


def test_ring_matches_the_jax_mesh_step(pool):
    """The reference's own mesh step (GSPMD, ring attention) on the same
    data x seq mesh, 3 steps."""
    params, tokens, _, _, _ = _reference(CFG)
    jcfg = jb.ModelConfig(**CFG, dtype=jnp.float32)
    mesh = jm.build_mesh(cpu_devices(4), jm.MeshShape(data=2, seq=2))
    fns = jb.build_train_step(jcfg, mesh=mesh, sequence_parallel="ring")
    with mesh:
        jparams = jax.device_put(jax.tree.map(jnp.asarray, params), jax.tree.map(
            lambda spec: NamedSharding(mesh, spec), jb.param_pspecs(jcfg),
            is_leaf=lambda x: isinstance(x, JP)))
        opt = jb.make_optimizer().init(jparams)
        toks = jax.device_put(tokens, NamedSharding(mesh, JP("data", None)))
        want = []
        for _ in range(STEPS):
            jparams, opt, loss = fns.step(jparams, opt, toks)
            want.append(float(loss))
    got = pool.run(R.train_case, CFG, (0, {"data": 2, "seq": 2}), params, tokens, STEPS,
                   sequence_parallel="ring")[0][0]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)


REFUSALS = [
    ((0, {"seq": 2, "model": 2}), dict(sequence_parallel="ulysses")),
    ((0, {"seq": 4}), dict(attention="flash", sequence_parallel="none")),
    ((0, {"seq": 2, "model": 2}), dict(sequence_parallel="rings")),
]


@pytest.mark.parametrize("layout,kw", REFUSALS, ids=str)
def test_refusals_carry_the_reference_messages(pool, layout, kw):
    jmesh = jm.build_mesh(cpu_devices(4), jm.MeshShape(**layout[1]))
    with pytest.raises(ValueError) as want:
        jb.build_train_step(jb.ModelConfig(**CFG), mesh=jmesh, **kw)
    assert pool.run(R.train_refusal, CFG, layout, **kw) == [str(want.value)] * 4


def test_ulysses_refuses_indivisible_heads_at_the_first_step(pool):
    cfg_kw = dict(CFG, n_heads=2, n_kv_heads=2)
    jcfg = jb.ModelConfig(**cfg_kw, dtype=jnp.float32)
    jmesh = jm.build_mesh(cpu_devices(4), jm.MeshShape(seq=4))
    fns = jb.build_train_step(jcfg, mesh=jmesh, sequence_parallel="ulysses")
    with jmesh, pytest.raises(ValueError) as want:
        params, opt = fns.init(jax.random.PRNGKey(0))
        fns.step(params, opt, jnp.asarray(_tokens(cfg_kw)))
    params = jax.tree.map(np.asarray, jb.init_params(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(RuntimeError, match=str(want.value).replace("(", r"\(").replace(")", r"\)")):
        pool.run(R.train_case, cfg_kw, (0, {"seq": 4}), params, _tokens(cfg_kw), 1,
                 sequence_parallel="ulysses")


def test_port_refusals(pool):
    """Port-only: a model shard must hold whole query heads (GSPMD splits
    the reference's packed columns freely; fewer KV groups than model ranks
    train, ``kv-split-*`` above), and a batch must split over the batch
    axes."""
    msgs = pool.run(R.train_refusal, dict(CFG, d_model=36, n_heads=6, n_kv_heads=None),
                    (0, {"model": 4}))
    assert all("whole query heads" in m for m in msgs)
    params, tokens, *_ = _reference(CFG)
    with pytest.raises(RuntimeError, match="do not split"):
        pool.run(R.train_case, CFG, (0, {"data": 2, "seq": 2}), params, tokens[:3], 1)
