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

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch.utils._python_dispatch import TorchDispatchMode

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import graphs as tg
from k8s_dra_driver_torch.ops import flash_attention as tfa
from k8s_dra_driver_torch.models.weights import (
    opt_state_from_jax,
    params_from_jax,
    params_to_numpy,
)
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


def _run_both(jcfg, steps, *, attention="flash", accum_steps=1, seed=0, remat="blocks"):
    jfns = jb.build_train_step(jcfg, attention=attention, accum_steps=accum_steps, remat=remat)
    jparams, jopt = jfns.init(jax.random.PRNGKey(seed))
    tparams = params_from_jax(jparams, device="cpu")
    tcfg = tb.ModelConfig.from_reference(jcfg)
    tfns = tb.build_train_step(tcfg, attention=attention, accum_steps=accum_steps, remat=remat,
                               device="cpu")
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


def test_dots_train_steps_match_jax():
    """``remat="dots"`` (the products without batch dims saved, the rest
    recomputed) against the reference's ``"dots"`` step
    (``dots_with_no_batch_dims_saveable``): two flash steps at 2 layers."""
    jparams, tparams, jl, tl = _run_both(JCFG, 2, remat="dots")
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_params_close(tparams, jparams, 2)


def _grads(params, toks, tcfg, attn, remat, mode=None):
    """(loss, gradient leaves) under ``remat``; ``mode`` is entered around
    the backward alone."""
    live = [t.detach().requires_grad_() for t in tb.param_leaves(params)]
    loss = tb.loss_fn(tb._unflatten(params, iter(live)), toks, tcfg, attn, remat=remat)
    with mode or contextlib.nullcontext():
        return loss, torch.autograd.grad(loss, live)


def _attention(name):
    return tfa.flash_attention if name == "flash" else None


@pytest.mark.parametrize("remat", ["dots", "blocks", "none"])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_remat_blocks_equals_none(attention, remat):
    """Rematerialization changes memory and time, not the numbers: loss and
    every gradient leaf under each policy bit-equal to a run that saves
    everything (``"none"`` against itself: the backward is deterministic)."""
    tcfg = tb.ModelConfig.from_reference(JCFG)
    params = tb.init_params(torch.Generator().manual_seed(4), tcfg)
    toks = torch.from_numpy(_tokens(b=2, s=32))
    loss, grads = _grads(params, toks, tcfg, _attention(attention), remat)
    want_loss, want = _grads(params, toks, tcfg, _attention(attention), "none")
    assert torch.equal(loss, want_loss)
    for g, h in zip(grads, want):
        assert torch.equal(g, h)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[func] = self.calls.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_dots_saves_the_products_without_batch_dims(attention):
    """``aten.mm`` calls in the backward: "dots" saves the weight products'
    outputs, so its backward runs as many as "none" (the gradients' own),
    fewer than "blocks", which reruns each block's products up to the
    last one whose input the backward needs (three of four: the recompute
    stops before ``mlp_down``); the batched attention products (``bmm``)
    are recomputed under both."""
    tcfg = tb.ModelConfig.from_reference(JCFG)
    params = tb.init_params(torch.Generator().manual_seed(4), tcfg)
    toks = torch.from_numpy(_tokens(b=2, s=32))
    mm, bmm = {}, {}
    for remat in ("dots", "blocks", "none"):
        mode = _CountOps()
        _grads(params, toks, tcfg, _attention(attention), remat, mode)
        mm[remat] = mode.calls.get(torch.ops.aten.mm.default, 0)
        bmm[remat] = mode.calls.get(torch.ops.aten.bmm.default, 0)
    assert mm["dots"] == mm["none"] < mm["blocks"]
    assert mm["blocks"] - mm["none"] == 3 * tcfg.n_layers
    assert bmm["dots"] == bmm["blocks"] > bmm["none"]


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


@pytest.mark.parametrize("clip", [0.0, 0.01])
def test_adamw_state_keeps_its_tensors_and_addresses(clip):
    """What a CUDA graph of the step needs of the optimizer: after several
    scheduled (and clipped) updates every params and state tensor is the
    same object at the same address with the same dtype, the count an int32
    0-d tensor on the params' device, and nothing else in the state."""
    tcfg = tb.ModelConfig.from_reference(dataclasses.replace(JCFG, n_layers=1))
    params = tb.init_params(torch.Generator().manual_seed(3), tcfg)
    opt = tb.make_optimizer(1e-2, warmup_steps=2, decay_steps=5, grad_clip=clip)
    state = opt.init(params)
    assert set(state) == {"count", "mu", "nu"}
    count = state["count"]
    assert count.dtype == torch.int32 and count.shape == () and count.device.type == "cpu"
    tensors = [*tb.param_leaves(params), count, *state["mu"], *state["nu"]]
    before = [(id(t), t.data_ptr(), t.dtype) for t in tensors]
    g = torch.Generator().manual_seed(5)
    for _ in range(4):
        grads = [torch.randn(t.shape, generator=g).to(t.dtype) for t in tb.param_leaves(params)]
        opt.update_(params, grads, state)
    after = [*tb.param_leaves(params), state["count"], *state["mu"], *state["nu"]]
    assert [(id(t), t.data_ptr(), t.dtype) for t in after] == before
    assert state["count"] is count and int(count) == 4


@pytest.mark.parametrize("count", [0, 1, 2, 3, 4, 6, 9])
def test_device_schedule_matches_optax(count):
    """The schedule the update reads, an f32 0-d tensor computed from the
    count tensor, against optax's ``warmup_cosine_decay_schedule`` at the
    same int32 count: in warmup, at the boundary, in the decay and past
    its end; within one f32 step of optax's value."""
    peak = 1e-2
    want = float(optax.warmup_cosine_decay_schedule(0.0, peak, 2, 6, peak * 0.1)(
        jnp.asarray(count, jnp.int32)))
    opt = tb.make_optimizer(peak, warmup_steps=2, decay_steps=6)
    got = opt.schedule(torch.tensor(count, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=2 ** -23, atol=0)


def test_optimizer_state_from_jax_continues_the_schedule():
    """The reference's optimizer state (warmup-cosine schedule, clipping:
    ``chain(clip_by_global_norm, adamw)``) after two JAX steps crosses over
    with the params through ``opt_state_from_jax``; both packages then run
    steps 3 and 4 on the same batch.  Losses and params agree within this
    module's tolerances: the device count carries the schedule and the
    bias corrections on from 2."""
    jopt = jb.make_optimizer(LR, warmup_steps=2, decay_steps=6, grad_clip=1.0)
    topt = tb.make_optimizer(LR, warmup_steps=2, decay_steps=6, grad_clip=1.0)
    jstep = jax.jit(jb.make_sgd_step(lambda p, t: jb.loss_fn(p, t, JCFG), jopt))
    tcfg = tb.ModelConfig.from_reference(JCFG)
    tstep = tb.make_sgd_step(lambda p, t: tb.loss_fn(p, t, tcfg), topt)
    jparams = jb.init_params(jax.random.PRNGKey(0), JCFG)
    jstate = jopt.init(jparams)
    toks = _tokens(vocab=JCFG.vocab_size)
    for _ in range(2):
        jparams, jstate, _ = jstep(jparams, jstate, jnp.asarray(toks))
    tparams = params_from_jax(jparams, device="cpu")
    tstate = opt_state_from_jax(jstate, device="cpu")
    assert tstate["count"].dtype == torch.int32 and int(tstate["count"]) == 2
    for got, want in zip(tstate["mu"], jax.tree.leaves(jstate[1][0].mu)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jl, tl = [], []
    for _ in range(2):
        jparams, jstate, loss = jstep(jparams, jstate, jnp.asarray(toks))
        jl.append(float(loss))
        tl.append(float(tstep(tparams, tstate, torch.from_numpy(toks))[2]))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert int(tstate["count"]) == 4
    _assert_params_close(tparams, jparams, 2)


def test_optimizer_state_from_jax_needs_adam_state():
    with pytest.raises(ValueError, match="no Adam state"):
        opt_state_from_jax((optax.EmptyState(),), device="cpu")


# -- the train step's graph holder, with a stand-in capture ---------------


class _StandInGraph:
    """What a captured CUDA graph does to the counters: a replay runs the
    kernels and none of the wrappers' Python."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def zeroed_flash_counters():
    saved = tfa.launch_counts()
    tfa.add_launch_counts({k: -n for k, n in saved.items()})
    yield
    now = tfa.launch_counts()
    tfa.add_launch_counts({k: saved[k] - now[k] for k in saved})


def _stand_in_sgd(runs, layers=2):
    """A stand-in step that launches (counts) like a flash step under
    remat "blocks" and records the batch it read."""

    def sgd(params, opt_state, tokens):
        runs.append(tokens.clone())
        tfa.add_launch_counts({"flash_fwd": 2 * layers, "flash_fwd_wgmma": 2 * layers,
                               "flash_bwd_dq": layers, "flash_bwd_dq_wgmma": layers,
                               "flash_bwd_dkv": layers, "flash_bwd_dkv_wgmma": layers})
        return params, opt_state, tokens.float().mean()

    return sgd


def _small_state(seed=0):
    tcfg = tb.ModelConfig.from_reference(dataclasses.replace(JCFG, n_layers=1))
    params = tb.init_params(torch.Generator().manual_seed(seed), tcfg)
    return params, tb.make_optimizer().init(params)


def test_graphed_train_step_counts_each_step_once(zeroed_flash_counters):
    """Call 1 runs eagerly, call 2 captures (Python, no kernels) and
    replays, later calls replay: the flash counts are those of one step per
    call; each batch is copied into the one token buffer the graph reads;
    the loss comes back as a copy, never the graph's own tensor."""
    runs, graphs = [], []

    def capture(fn, device):
        graphs.append(_StandInGraph())
        return graphs[-1], fn()

    holder = tb.GraphedTrainStep(_stand_in_sgd(runs), torch.device("cpu"), capture=capture)
    params, state = _small_state()
    batches = [torch.from_numpy(_tokens(b=2, s=8, seed=i)) for i in range(4)]
    for n, toks in enumerate(batches, 1):
        out_params, out_state, loss = holder(params, state, toks)
        assert out_params is params and out_state is state
        assert torch.equal(holder._tokens, toks)
        assert tfa.launch_counts()["flash_fwd_wgmma"] == 4 * n
        assert tfa.launches == {"flash_fwd": 4 * n, "flash_bwd_dq": 2 * n, "flash_bwd_dkv": 2 * n}
        assert loss is not holder.program._out
    assert len(runs) == 2 and len(graphs) == 1 and graphs[0].replays == 3
    assert holder.captures == 1 and holder.program.calls == 4


def test_graphed_train_step_captures_anew_for_new_tokens_or_params(zeroed_flash_counters):
    """Another token shape, or another params tree, is a new program (eager,
    then captured) and the old graph is released; the same tensors
    refilled in place (a restore) replay the graph already captured."""
    runs, graphs = [], []

    def capture(fn, device):
        graphs.append(_StandInGraph())
        return graphs[-1], fn()

    holder = tb.GraphedTrainStep(_stand_in_sgd(runs), torch.device("cpu"), capture=capture)
    params, state = _small_state()
    toks = torch.from_numpy(_tokens(b=2, s=8))
    for _ in range(3):
        holder(params, state, toks)
    first = holder.program
    with torch.no_grad():
        for t in tb.param_leaves(params):
            t.copy_(torch.ones_like(t))  # a restore in place: same tensors
    holder(params, state, toks)
    assert holder.program is first and holder.captures == 1
    longer = torch.from_numpy(_tokens(b=2, s=16))
    for _ in range(2):
        holder(params, state, longer)
    assert holder.program is not first and holder.captures == 2
    assert holder._tokens.shape == (2, 16) and len(graphs) == 2
    other_params, other_state = _small_state(seed=1)
    for _ in range(2):
        holder(other_params, other_state, longer)
    assert holder.captures == 3 and len(runs) == 6
    assert tfa.launches["flash_fwd"] == 4 * 8  # one step per call, 8 calls


def test_graphed_train_step_capture_failure_raises(zeroed_flash_counters):
    """A capture that raises names the train step, leaves the counters as
    the eager call left them, and runs nothing eagerly in its place."""
    runs = []

    def capture(fn, device):
        fn()
        raise RuntimeError("operation not permitted when stream is capturing")

    holder = tb.GraphedTrainStep(_stand_in_sgd(runs), torch.device("cpu"), capture=capture)
    params, state = _small_state()
    toks = torch.from_numpy(_tokens(b=2, s=8))
    holder(params, state, toks)  # eager, counted
    for _ in range(2):
        with pytest.raises(tg.GraphCaptureError, match="train step.*not permitted"):
            holder(params, state, toks)
        assert tfa.launches["flash_fwd"] == 4 and holder.program.graph is None
    assert holder.captures == 0 and len(runs) == 3


def test_train_step_runs_eagerly_on_the_cpu_and_with_graphs_disabled():
    """The CPU never goes through the graph holder, with graphs enabled or
    not: no capture, and the same losses as the plain ``make_sgd_step``."""
    tcfg = tb.ModelConfig.from_reference(dataclasses.replace(JCFG, n_layers=1))
    fns = tb.build_train_step(tcfg, attention="flash", device="cpu")
    params, state = fns.init(torch.Generator().manual_seed(0))
    twin = (tb.init_params(torch.Generator().manual_seed(0), tcfg), None)
    twin = (twin[0], tb.make_optimizer().init(twin[0]))
    sgd = tb.make_sgd_step(
        lambda p, t: tb.loss_fn(p, t, tcfg, tfa.flash_attention), tb.make_optimizer())
    toks = torch.from_numpy(_tokens(b=2, s=32))
    for disabled in (False, True):
        with tg.disable_graphs() if disabled else contextlib.nullcontext():
            loss = fns.step(params, state, toks)[2]
        assert torch.equal(loss, sgd(*twin, toks)[2])
    assert fns.captures == 0 and fns.graphed.program is None
