"""The PyTorch port's single-device training step against the JAX
package's, on the CPU: the same weights (made by the JAX package, loaded
through ``params_from_jax``), the same tokens from a seeded numpy
generator, f32 throughout.  With ``attention="flash"`` the JAX step runs its
Pallas kernels in interpret mode and the port its kernels' plain versions.

Tolerances: losses within 1e-5 relative (the same f32 arithmetic summed in
another order).  Params after n steps: each leaf within 1e-4 relative L2
distance of the JAX package's, and every element within n * lr.  Adam
moves an element by about lr whatever its gradient's size, so an element
whose gradient is near 0 carries the two frameworks' rounding noise into a
step of up to lr (seen: 1 element in 8192 apart by 9e-5 after 3 steps); the
L2 bound holds the rest of the leaf close.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models.weights import params_from_jax, params_to_numpy
from k8s_dra_driver_tpu.models import burnin as jb

LOSS_RTOL = 1e-5
PARAM_RTOL_L2 = 1e-4
LR = 3e-4  # build_train_step's default

JCFG = jb.ModelConfig(
    vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
    d_ff=128, max_seq=32, rope=True, dtype=jnp.float32,
)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module's forward and backward passes,
    restored afterwards: the suite's other workers keep their cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _tokens(b=4, s=32, seed=0, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, s)).astype(np.int32)


def _assert_params_close(tparams, jparams, steps):
    got = params_to_numpy(tparams)
    want = jax.tree.map(np.asarray, jparams)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves(want)
    assert len(flat_got) == len(flat_want)
    for (path, g), w in zip(flat_got, flat_want):
        where = jax.tree_util.keystr(path)
        assert np.linalg.norm(g - w) <= PARAM_RTOL_L2 * np.linalg.norm(w), where
        np.testing.assert_allclose(g, w, atol=steps * LR, rtol=0, err_msg=where)


def _run_both(jcfg, steps, *, attention="flash", accum_steps=1, seed=0):
    jfns = jb.build_train_step(jcfg, attention=attention, accum_steps=accum_steps)
    jparams, jopt = jfns.init(jax.random.PRNGKey(seed))
    tparams = params_from_jax(jparams, device="cpu")
    tcfg = tb.ModelConfig.from_reference(jcfg)
    tfns = tb.build_train_step(tcfg, attention=attention, accum_steps=accum_steps, device="cpu")
    topt = tb.make_optimizer().init(tparams)
    jlosses, tlosses = [], []
    toks = _tokens(vocab=jcfg.vocab_size)  # one batch, repeated: the loss falls
    for _ in range(steps):
        jparams, jopt, jl = jfns.step(jparams, jopt, jnp.asarray(toks))
        tparams, topt, tl = tfns.step(tparams, topt, torch.from_numpy(toks))
        jlosses.append(float(jl))
        tlosses.append(float(tl))
    return jparams, tparams, jlosses, tlosses


def test_flash_train_steps_match_jax():
    """Three steps of JAX ``build_train_step(attention="flash")`` and the
    port's with ``device="cpu"`` at 2 layers: losses and the params after."""
    jparams, tparams, jl, tl = _run_both(JCFG, 3)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]
    _assert_params_close(tparams, jparams, 3)


def test_dense_accumulated_steps_match_jax():
    """``accum_steps=2``: the interleaved microbatch split, f32 gradient
    sums and one update, against the JAX package's scan."""
    jparams, tparams, jl, tl = _run_both(JCFG, 2, attention="dense", accum_steps=2)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_params_close(tparams, jparams, 2)


def test_accumulation_splits_the_batch_interleaved():
    """Microbatch i holds rows i, i + accum, ...: with accum 2 the averaged
    loss equals the mean of the two interleaved halves' losses, and a batch
    the split does not divide raises."""
    tcfg = tb.ModelConfig.from_reference(dataclasses.replace(JCFG, n_layers=1))
    params = tb.init_params(torch.Generator().manual_seed(3), tcfg)
    toks = torch.from_numpy(_tokens(b=4, s=16))
    halves = [tb.loss_fn(params, toks[i::2], tcfg) for i in range(2)]
    opt = tb.make_optimizer()
    state = opt.init(params)
    _, _, loss = tb.make_sgd_step(lambda p, t: tb.loss_fn(p, t, tcfg), opt, 2)(
        params, state, toks
    )
    torch.testing.assert_close(loss, (halves[0] + halves[1]) * 0.5, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="not divisible by accum_steps"):
        tb.make_sgd_step(lambda p, t: tb.loss_fn(p, t, tcfg), opt, 3)(params, state, toks)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_remat_blocks_equals_none(attention):
    """Rematerialization changes memory and time, not the numbers: loss and
    every gradient leaf bit-equal between ``"blocks"`` and ``"none"``."""
    tcfg = tb.ModelConfig.from_reference(JCFG)
    params = tb.init_params(torch.Generator().manual_seed(4), tcfg)
    toks = torch.from_numpy(_tokens(b=2, s=32))
    attn = None
    if attention == "flash":
        from k8s_dra_driver_torch.ops.flash_attention import flash_attention as attn
    out = {}
    for remat in ("blocks", "none"):
        out[remat] = tb.value_and_grad(
            lambda p, t: tb.loss_fn(p, t, tcfg, attn, remat=remat), params, toks
        )
    assert torch.equal(out["blocks"][0], out["none"][0])
    for g, h in zip(tb.param_leaves(out["blocks"][1]), tb.param_leaves(out["none"][1])):
        assert torch.equal(g, h)


@pytest.mark.parametrize(
    "warmup,decay,clip", [(0, 0, 0.0), (2, 6, 0.0), (0, 0, 0.05), (2, 5, 0.5)],
)
def test_optimizer_matches_optax(warmup, decay, clip):
    """The port's AdamW against the reference's ``make_optimizer`` on the
    same params and gradients for 6 updates: the warmup-cosine schedule
    (the first update at schedule(0) = 0), global-norm clipping (0.05
    clips every step here, 0.5 some), decay on every leaf.  f32, within
    2.5e-7 absolute: two f32 steps at the params' size (|p| < 2), from
    rounding the same formulas in another order."""
    r = np.random.RandomState(7)
    params = {"a": r.standard_normal((5, 3)).astype(np.float32),
              "blocks": [{"w": r.standard_normal(4).astype(np.float32)}]}
    jopt = jb.make_optimizer(1e-2, warmup, decay, clip)
    topt = tb.make_optimizer(1e-2, warmup, decay, clip)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = jax.tree.map(torch.from_numpy, params)
    tp = {"a": tp["a"].clone(), "blocks": [{"w": tp["blocks"][0]["w"].clone()}]}
    tstate = topt.init(tp)
    for i in range(6):
        g = jax.tree.map(lambda x: (r.standard_normal(x.shape) * 0.1).astype(np.float32), params)
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        topt.update_(tp, jax.tree.map(torch.from_numpy, g), tstate)
        for got, want in zip(tb.param_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2.5e-7, rtol=0)
        if i == 0 and warmup:
            np.testing.assert_array_equal(tp["a"].numpy(), params["a"])
    assert tstate["count"] == 6


def test_partial_schedule_and_unported_paths_raise():
    tcfg = tb.ModelConfig.from_reference(JCFG)
    with pytest.raises(ValueError, match="schedule needs"):
        tb.make_optimizer(1e-3, warmup_steps=5)
    with pytest.raises(NotImplementedError, match="remat='dots'"):
        tb.build_train_step(tcfg, remat="dots", device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        tb.build_train_step(tcfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="remat must be"):
        tb.build_train_step(tcfg, remat="all", device="cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        tb.build_train_step(tcfg, sequence_parallel="ring", device="cpu")
    with pytest.raises(ValueError, match="attention must be"):
        tb.build_train_step(tcfg, attention="ring", device="cpu")
    with pytest.raises(ValueError, match="sequence_parallel must be"):
        tb.build_train_step(tcfg, sequence_parallel="2d", device="cpu")


def test_train_step_raises_without_a_card_and_runs_on_the_cpu(monkeypatch):
    """The device rule: the default device is the card; on the CPU, init
    and step run, update in place and return the loss as a tensor."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = tb.ModelConfig.from_reference(dataclasses.replace(JCFG, n_layers=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.build_train_step(tcfg, attention="flash")
    fns = tb.build_train_step(tcfg, attention="flash", device="cpu")
    params, state = fns.init(torch.Generator().manual_seed(0))
    before = params["embed"].clone()
    toks = tb.sample_tokens(torch.Generator().manual_seed(1), tcfg, 2, 32)
    assert toks.dtype == torch.int32 and toks.shape == (2, 32)
    out_params, out_state, loss = fns.step(params, state, toks)
    assert out_params is params and out_state is state and state["count"] == 1
    assert isinstance(loss, torch.Tensor) and loss.shape == () and torch.isfinite(loss)
    assert not torch.equal(params["embed"], before)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_makes_no_host_read(monkeypatch, accum_steps):
    """The step never waits for the device: with every tensor-to-host read
    made to raise, a flash step (remat "blocks") and a clipped, scheduled
    update run through, and the loss comes back as a tensor."""
    tcfg = tb.ModelConfig.from_reference(dataclasses.replace(JCFG, n_layers=1))
    fns = tb.build_train_step(tcfg, attention="flash", accum_steps=accum_steps, device="cpu")
    params, state = fns.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(b=2, s=32))
    opt = tb.make_optimizer(1e-3, warmup_steps=1, decay_steps=4, grad_clip=0.01)
    ostate = opt.init(params)

    def refuse(*_a, **_k):
        raise AssertionError("host read inside the train step")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "__bool__", "cpu", "numpy"):
            m.setattr(torch.Tensor, name, refuse)
        _, _, loss = fns.step(params, state, toks)
        _, grads = tb.value_and_grad(lambda p, t: tb.loss_fn(p, t, tcfg), params, toks)
        opt.update_(params, grads, ostate)
    assert isinstance(loss, torch.Tensor) and torch.isfinite(loss)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_to_numpy_inverts_params_from_jax(dtype):
    r = np.random.RandomState(2)
    tree = {"embed": r.standard_normal((6, 4)), "ln_f": r.standard_normal(4),
            "blocks": [{"qkv": r.standard_normal((4, 12))}]}
    jp = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dtype)), tree)
    back = params_to_numpy(params_from_jax(jp, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
