"""The port's pipeline parallelism (``ops/pipeline.py``,
``models/pp_burnin.py``) against the JAX package's, f32, on the CPU.

Four gloo ranks (one ``RankPool`` for the module) run each case; the JAX
side runs on the conftest's virtual CPU devices.

* ``pipeline_apply`` with a tanh stage, at pipe 2 and 4 and 1, 2 and 8
  microbatches, against the sequential composition of the stages,
  forward and the gradients of ``sum(out · ct)`` for the stage matrices
  and the input, within 1e-5 of each one's largest element.
* ``build_pp_train_step`` with the GQA + RoPE config of
  ``tests/test_torch_mesh_train.py`` at 4 layers and an MHA config with
  learned positions, on ``(pipe 2, model 2)`` and ``(pipe 2, data 2)`` in
  both ``tp_mode``\\ s and ``(pipe 4)``, held to the JAX single-device
  ``build_train_step`` from the same weights and tokens by that file's
  bounds: losses over 3 steps within 1e-5 relative, step-1 gradients
  within 1e-5 of each leaf's largest (Adam's first step cannot see a
  gradient's scale, so the gradients are held before any update), params
  after 3 steps within 1e-4 relative L2 and 3 x lr per element.  The
  reference's own pipeline is exact against its single device at these
  bounds; one case is also held to the JAX ``build_pp_train_step``.
* The refusals carry the reference's messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from k8s_dra_driver_torch.parallel.ranks import RankPool
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import pp_burnin as jpp
from k8s_dra_driver_tpu.parallel import mesh as jm
from tests import torch_mesh_ranks as R
from tests.conftest import cpu_devices
from tests.test_torch_mesh_train import LR, STEPS, _check, _reference

TOL = 1e-5
GQA = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=4, d_ff=64,
           max_seq=32, rope=True)
MHA = dict(GQA, n_kv_heads=None, rope=False)
MESHES = {
    "megatron-pipe2-model2": ((0, {"pipe": 2, "model": 2}), dict(tp_mode="megatron")),
    "sp-pipe2-model2": ((0, {"pipe": 2, "model": 2}), dict(tp_mode="megatron-sp")),
    "pipe2-data2": ((0, {"pipe": 2, "data": 2}), dict()),
    # the dry run's pipeline legs at 4 ranks: megatron-sp over a model axis of 1
    "sp-pipe2-data2": ((0, {"pipe": 2, "data": 2}), dict(tp_mode="megatron-sp")),
    "pipe4": ((0, {"pipe": 4}), dict()),
}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, backend="gloo", device_type="cpu", timeout_s=120)
    yield p
    p.close()


@pytest.mark.parametrize("n_micro", [1, 2, 8])
@pytest.mark.parametrize("layout", [(0, {"pipe": 2, "data": 2}), (0, {"pipe": 4})], ids=str)
def test_pipeline_apply_matches_the_sequential_composition(pool, layout, n_micro):
    n_stages, mb, d = layout[1]["pipe"], 2, 8
    rng = np.random.RandomState(n_micro)
    ws = (rng.randn(n_stages, d, d) / np.sqrt(d)).astype(np.float32)
    xs = rng.randn(n_micro, mb, d).astype(np.float32)
    ct = rng.randn(n_micro, mb, d).astype(np.float32)

    def sequential(ws, xs):
        for i in range(n_stages):
            xs = jnp.tanh(xs @ ws[i])
        return xs

    want, vjp = jax.vjp(sequential, jnp.asarray(ws), jnp.asarray(xs))
    want_ws, want_xs = (np.asarray(g) for g in vjp(jnp.asarray(ct)))
    results = pool.run(R.pipeline_case, layout, ws, xs, ct)
    ranks = np.asarray(pool.run(R.mesh_layout, layout)[0][0])
    pipe_of = {int(r): int(np.argwhere(ranks == r)[0][0]) for r in ranks.ravel()}
    for r, (out, g_w, g_x) in enumerate(results):
        np.testing.assert_allclose(out, want, atol=TOL * np.abs(want).max(), rtol=0)
        np.testing.assert_allclose(g_w[0], want_ws[pipe_of[r]],
                                   atol=TOL * np.abs(want_ws).max(), rtol=0)
        np.testing.assert_allclose(g_x, want_xs, atol=TOL * np.abs(want_xs).max(), rtol=0)


@pytest.mark.parametrize("mesh_case", list(MESHES))
@pytest.mark.parametrize("cfg_name", ["gqa", "mha"])
def test_pp_step_matches_the_single_device_reference(pool, cfg_name, mesh_case):
    cfg_kw = {"gqa": GQA, "mha": MHA}[cfg_name]
    layout, kw = MESHES[mesh_case]
    params, tokens, losses, grads, after = _reference(cfg_kw)
    _check(pool.run(R.pp_train_case, cfg_kw, layout, params, tokens, STEPS, lr=LR, **kw),
           losses, grads, after)


def test_sp_step_matches_the_jax_pipeline_step(pool):
    """The reference's own ``build_pp_train_step`` on ``(pipe 2, model
    2)`` in megatron-sp, 3 steps from the same weights: losses within 1e-5
    relative."""
    params, tokens, _, _, _ = _reference(GQA)
    jcfg = jb.ModelConfig(**GQA, dtype=jnp.float32)
    mesh = jm.build_mesh(cpu_devices(4), jm.MeshShape(pipe=2, model=2))
    fns = jpp.build_pp_train_step(jcfg, mesh, lr=LR, tp_mode="megatron-sp")
    with mesh:
        jparams = jpp.pp_params_from_dense(jax.tree.map(jnp.asarray, params), jcfg)
        opt = jb.make_optimizer(LR).init(jparams)
        toks = jax.device_put(tokens, NamedSharding(mesh, JP("data", None)))
        want = []
        for _ in range(STEPS):
            jparams, opt, loss = fns.step(jparams, opt, toks)
            want.append(float(loss))
    got = pool.run(R.pp_train_case, GQA, (0, {"pipe": 2, "model": 2}), params, tokens, STEPS,
                   lr=LR, tp_mode="megatron-sp")[0][0]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)


REFUSALS = {
    # case: (config changes, mesh, build options, tokens (b, s) for a step, at init)
    "tp-mode": ({}, {"pipe": 2, "model": 2}, dict(tp_mode="colossal"), None, False),
    "pipe-1": ({}, {"data": 2, "model": 2}, {}, None, False),
    "seq": ({}, {"pipe": 2, "seq": 2}, {}, None, False),
    "layers": ({"n_layers": 3}, {"pipe": 2, "model": 2}, {}, None, False),
    "kv-heads": ({"n_kv_heads": 1}, {"pipe": 2, "model": 2}, {}, None, False),
    "d-ff": ({"d_ff": 63}, {"pipe": 2, "model": 2}, {}, None, False),
    "batch": ({}, {"pipe": 2, "data": 2}, {}, (6, 32), False),
    "sp-seq": ({}, {"pipe": 2, "model": 2}, dict(tp_mode="megatron-sp"), (4, 31), False),
    "moe": ({"n_experts": 4}, {"pipe": 2, "model": 2}, {}, None, True),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_carry_the_reference_messages(pool, case):
    changes, shape, kw, tok_shape, at_init = REFUSALS[case]
    cfg_kw = {**GQA, **changes}
    jmesh = jm.build_mesh(cpu_devices(4), jm.MeshShape(**shape))
    tokens = None if tok_shape is None else np.random.RandomState(0).randint(
        0, GQA["vocab_size"], tok_shape).astype(np.int32)
    with pytest.raises(ValueError) as want:
        fns = jpp.build_pp_train_step(jb.ModelConfig(**cfg_kw, dtype=jnp.float32), jmesh, **kw)
        with jmesh:
            params, opt = fns.init(jax.random.PRNGKey(0))
            if tokens is not None:
                fns.step(params, opt, jax.device_put(
                    tokens, NamedSharding(jmesh, JP("data", None))))
    got = pool.run(R.pp_refusal, cfg_kw, (0, shape), tokens, at_init, **kw)
    assert got == [str(want.value)] * 4
