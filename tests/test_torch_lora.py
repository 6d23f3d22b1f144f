"""LoRA in the PyTorch port (``models/lora.py``, the delta hooks of
``models/burnin.py`` and ``models/decode.py``, ``burnin.Adam``) against the
JAX package's ``models/lora.py`` on the CPU, at the JAX tests' sizes
(``tests/test_lora.py``), float32.  Adapters and banks are drawn with a
seeded numpy generator and carried into both packages; the base comes from
the JAX package through ``params_from_jax``.

Tolerances: merged weights, adapter deltas and logits are the same float32
products summed in another order: within 1e-6 absolute at these sizes
(values below 4; deltas and logits 1e-5).  The train step as
``tests/test_torch_train.py`` holds the full one: losses within 1e-5
relative, each adapter leaf after n steps within 1e-4 relative L2 distance
of the JAX package's and every element within n * lr (Adam moves an element
by about lr whatever its gradient's size, so a near-zero gradient carries
each library's rounding into a step of up to lr).  The base stays bit for
bit what it was."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import decode as td
from k8s_dra_driver_torch.models import graphs as tg
from k8s_dra_driver_torch.models import lora as tl
from k8s_dra_driver_torch.models.weights import (
    adapters_from_jax,
    bank_from_jax,
    opt_state_from_jax,
    params_from_jax,
    params_to_numpy,
)
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import decode as jd
from k8s_dra_driver_tpu.models import lora as jl

JCFG = jb.ModelConfig(
    vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=32, dtype=jnp.float32,
)
TCFG = tb.ModelConfig.from_reference(JCFG)
JLORA = jl.LoraConfig(rank=4, alpha=8.0)
TLORA = tl.LoraConfig(rank=4, alpha=8.0)
LR = 5e-2
LOSS_RTOL = 1e-5
PARAM_RTOL_L2 = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def base():
    params = jb.init_params(jax.random.PRNGKey(0), JCFG)
    return params, params_from_jax(params, device="cpu")


def _tokens(b=4, s=16, seed=1):
    return np.random.RandomState(seed).randint(0, JCFG.vocab_size, size=(b, s)).astype(np.int32)


def numpy_adapter(seed: int, cfg=JCFG, lora=JLORA, b_scale: float = 0.3) -> dict:
    """An adapter tree of numpy arrays: A normal with std 1/r, B normal
    times ``b_scale`` (0 gives a fresh adapter)."""
    r = np.random.RandomState(seed)
    dims = jb.block_matrix_shapes(cfg)
    return {"blocks": [
        {name: {"a": (r.standard_normal((dims[name][0], lora.rank)) / lora.rank
                      ).astype(np.float32),
                "b": (b_scale * r.standard_normal((lora.rank, dims[name][1]))
                      ).astype(np.float32)}
         for name in lora.targets}
        for _ in range(cfg.n_layers)
    ]}


def _both(adapter):
    """``(JAX tree, port tree)`` of a numpy adapter."""
    return jax.tree.map(jnp.asarray, adapter), adapters_from_jax(adapter, device="cpu")


def _leaves_close(got_tree, want_tree, atol):
    got = jax.tree.leaves(params_to_numpy(got_tree))
    want = jax.tree.leaves(jax.tree.map(np.asarray, want_tree))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


# -- init, merge, banks --------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fresh_adapters_merge_to_the_base_bit_for_bit(dtype):
    cfg = dataclasses.replace(TCFG, dtype=dtype)
    params = tb.init_params(torch.Generator().manual_seed(0), cfg)
    ad = tl.init_adapters(torch.Generator().manual_seed(2), cfg, TLORA)
    merged = tl.merge(params, ad, TLORA)
    for got, want in zip(tb.param_leaves(merged), tb.param_leaves(params)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    blk = ad["blocks"][0]
    assert set(blk) == set(tl.DEFAULT_TARGETS)
    assert blk["qkv"]["a"].dtype == torch.float32 and not blk["qkv"]["b"].any()
    assert blk["mlp_down"]["a"].shape == (cfg.d_ff, TLORA.rank)
    std = torch.cat([b[n]["a"].flatten() for b in ad["blocks"] for n in b]).std()
    assert abs(float(std) - 1.0 / TLORA.rank) < 0.02


def test_merge_matches_jax(base):
    """A nonzero adapter folded in by each package: every block matrix
    within 1e-6, and the leaves it does not target identical."""
    jparams, tparams = base
    jad, tad = _both(numpy_adapter(3))
    _leaves_close(tl.merge(tparams, tad, TLORA), jl.merge(jparams, jad, JLORA), atol=1e-6)
    merged = tl.merge(tparams, tad, TLORA)
    assert merged["embed"] is tparams["embed"]
    assert merged["blocks"][0]["ln1"] is tparams["blocks"][0]["ln1"]


def test_nonzero_b_changes_targeted_weights_only(base):
    _, tparams = base
    ad = tl.init_adapters(torch.Generator().manual_seed(2), TCFG, TLORA)
    ad["blocks"][0]["qkv"]["b"] = torch.ones_like(ad["blocks"][0]["qkv"]["b"])
    merged = tl.merge(tparams, ad, TLORA)
    assert not torch.equal(merged["blocks"][0]["qkv"], tparams["blocks"][0]["qkv"])
    assert torch.equal(merged["blocks"][1]["qkv"], tparams["blocks"][1]["qkv"])
    assert torch.equal(merged["embed"], tparams["embed"])


def test_subset_targets_and_parameter_count(base):
    _, tparams = base
    sub = tl.LoraConfig(rank=4, targets=("qkv",))
    ad = tl.init_adapters(torch.Generator().manual_seed(2), TCFG, sub)
    assert set(ad["blocks"][0]) == {"qkv"}
    assert all(torch.equal(g, w) for g, w in zip(tb.param_leaves(tl.merge(tparams, ad, sub)),
                                                  tb.param_leaves(tparams)))
    jad, tad = _both(numpy_adapter(4))
    assert tl.adapter_param_count(tad) == jl.adapter_param_count(jad)
    n_base = sum(t.numel() for t in tb.param_leaves(tparams))
    assert tl.adapter_param_count(tad) < n_base / 4


@pytest.mark.parametrize("kw", [dict(rank=0), dict(targets=("embed",)),
                                dict(rank=JCFG.d_model), dict(targets=())])
def test_bad_configs_raise_the_reference_messages(kw):
    with pytest.raises(ValueError) as want:
        jl.LoraConfig(**kw).validate(JCFG)
    with pytest.raises(ValueError) as got:
        tl.LoraConfig(**kw).validate(TCFG)
    assert str(got.value) == str(want.value)


def test_bank_layout_and_validation_match_jax():
    """Row 0 the identity (zeros), rows 1.. the adapters in order, the
    scale a Python float, ``bank_size`` the identity included; an adapter
    with too few layers or other targets raises the reference's message."""
    ads = [numpy_adapter(5), numpy_adapter(6)]
    jbank = jl.stack_adapters(JCFG, JLORA, [jax.tree.map(jnp.asarray, a) for a in ads])
    tbank = tl.stack_adapters(TCFG, TLORA, [adapters_from_jax(a, device="cpu") for a in ads])
    assert tl.bank_size(tbank) == jl.bank_size(jbank) == 3
    assert type(tbank["scale"]) is float and tbank["scale"] == jbank["scale"] == 2.0
    _leaves_close(tbank["blocks"], jbank["blocks"], atol=0.0)
    loaded = bank_from_jax(jbank, device="cpu")
    assert type(loaded["scale"]) is float
    _leaves_close(loaded["blocks"], jbank["blocks"], atol=0.0)
    assert not tbank["blocks"][1]["mlp_up"]["a"][0].any()
    short = numpy_adapter(7)
    short["blocks"] = short["blocks"][:1]
    other = tl.LoraConfig(rank=4, alpha=8.0, targets=("qkv", "attn_out"))
    sub = {"blocks": [{k: v for k, v in b.items() if k in other.targets}
                      for b in numpy_adapter(8)["blocks"]]}
    for bad in (short, sub):
        with pytest.raises(ValueError) as want:
            jl.stack_adapters(JCFG, JLORA, [jax.tree.map(jnp.asarray, bad)])
        with pytest.raises(ValueError) as got:
            tl.stack_adapters(TCFG, TLORA, [adapters_from_jax(bad, device="cpu")])
        assert str(got.value) == str(want.value)
    empty = tl.stack_adapters(TCFG, TLORA, [], device="cpu")
    assert tl.bank_size(empty) == 1


def _banks(n=2):
    ads = [numpy_adapter(10 + i) for i in range(n)]
    jbank = jl.stack_adapters(JCFG, JLORA, [jax.tree.map(jnp.asarray, a) for a in ads])
    return ads, jbank, bank_from_jax(jbank, device="cpu")


@pytest.mark.parametrize("name", list(tl.DEFAULT_TARGETS) + ["absent"])
def test_adapter_delta_matches_jax(name):
    """Each row applies its own bank row (ids [2, 0, 1, 2]) within 1e-5;
    row 0 of the bank adds exact zeros; a target the bank lacks adds an
    exact 0."""
    _, jbank, tbank = _banks()
    d_in = JCFG.d_ff if name == "mlp_down" else JCFG.d_model
    y = np.random.RandomState(9).standard_normal((4, 5, d_in)).astype(np.float32)
    ids = np.array([2, 0, 1, 2], np.int32)
    layer = 1
    jbl, tbl = jbank["blocks"][layer], tbank["blocks"][layer]
    if name == "absent":
        jbl = {k: v for k, v in jbl.items() if k != "qkv"}
        tbl = {k: v for k, v in tbl.items() if k != "qkv"}
        name = "qkv"
    want = jl.adapter_delta(jbl, jnp.asarray(ids), jbank["scale"])(name, jnp.asarray(y))
    got = tl.adapter_delta(tbl, torch.from_numpy(ids), tbank["scale"])(name, torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(np.asarray(want), got.shape),
                               atol=1e-5, rtol=0)
    assert got.dtype == torch.float32
    if name in tbl:
        assert not got[1].any()  # the identity row


def test_prefill_with_a_mixed_bank_matches_jax_and_the_merged_models(base):
    """``decode.prefill(adapters=(bank, ids))`` over 3 rows with ids
    [0, 1, 2]: logits and cache within 1e-5 of the JAX package's, and each
    row within 1e-4 of its own merged model's prefill (the delta and the
    merge are the same product in another order)."""
    jparams, tparams = base
    ads, jbank, tbank = _banks()
    prompts = np.random.RandomState(3).randint(0, 128, size=(3, 6)).astype(np.int32)
    ids = np.array([0, 1, 2], np.int32)
    jcache, jlogits = jd.prefill(jparams, jnp.asarray(prompts), JCFG, max_seq=16,
                                 adapters=(jbank, jnp.asarray(ids)))
    tcache, tlogits = td.prefill(tparams, torch.from_numpy(prompts).long(), TCFG, max_seq=16,
                                 adapters=(tbank, torch.from_numpy(ids)))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=1e-5, rtol=0)
    models = [tparams] + [tl.merge(tparams, adapters_from_jax(a, device="cpu"), TLORA)
                          for a in ads]
    for i, model in enumerate(models):
        _, solo = td.prefill(model, torch.from_numpy(prompts[i:i + 1]).long(), TCFG, max_seq=16)
        np.testing.assert_allclose(tlogits[i].numpy(), solo[0].numpy(), atol=1e-4, rtol=0)
    assert float((tlogits[1] - tlogits[0]).abs().max()) > 0.1  # the adapters bite


# -- training ------------------------------------------------------------------------

def _run_both(steps, attention, seed=3):
    jparams = jb.init_params(jax.random.PRNGKey(0), JCFG)
    tparams = params_from_jax(jparams, device="cpu")
    jfns = jl.build_lora_train_step(JCFG, JLORA, lr=LR, attention=attention)
    jad, jst = jfns.init(jax.random.PRNGKey(seed))
    tad, tst = adapters_from_jax(jad, device="cpu"), opt_state_from_jax(jst, device="cpu")
    tfns = tl.build_lora_train_step(TCFG, TLORA, lr=LR, attention=attention, device="cpu")
    before = [t.clone() for t in tb.param_leaves(tparams)]
    toks = _tokens()
    jlosses, tlosses = [], []
    for _ in range(steps):
        jad, jst, jloss = jfns.step(jad, jst, jparams, jnp.asarray(toks))
        out_ad, out_st, tloss = tfns.step(tad, tst, tparams, torch.from_numpy(toks))
        assert out_ad is tad and out_st is tst
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    assert all(torch.equal(a, b) for a, b in zip(tb.param_leaves(tparams), before))
    return jad, tad, tst, jlosses, tlosses


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_lora_train_steps_match_jax(attention):
    """Three steps of JAX ``build_lora_train_step`` (flash: its Pallas
    kernels in interpret mode) and the port's with ``device="cpu"`` from
    the same adapters and Adam state: losses, the adapters after, the
    count; the base untouched."""
    jad, tad, tst, jlosses, tlosses = _run_both(3, attention)
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    assert tlosses[-1] < tlosses[0] and int(tst["count"]) == 3
    got = jax.tree.leaves(params_to_numpy(tad))
    for g, w in zip(got, jax.tree.leaves(jax.tree.map(np.asarray, jad))):
        assert np.linalg.norm(g - w) <= PARAM_RTOL_L2 * np.linalg.norm(w)
        np.testing.assert_allclose(g, w, atol=3 * LR, rtol=0)


def test_loss_falls_every_adapter_moves_and_the_merge_serves_it(base):
    """The reference's training contracts on the port: the loss falls over
    15 steps, two steps reach every A and B, and the merged model's loss is
    the next step's reported loss (the same adapters)."""
    _, tparams = base
    fns = tl.build_lora_train_step(TCFG, TLORA, lr=LR, device="cpu")
    ad, st = fns.init(torch.Generator().manual_seed(3))
    first = [t.clone() for t in tb.param_leaves(ad)]
    toks = torch.from_numpy(_tokens())
    losses = [float(fns.step(ad, st, tparams, toks)[2]) for _ in range(15)]
    assert losses[-1] < losses[0] * 0.9, losses
    assert all(not torch.equal(a, b) for a, b in zip(tb.param_leaves(ad), first))
    served = float(tb.loss_fn(tl.merge(tparams, ad, TLORA), toks, TCFG))
    assert served == pytest.approx(float(fns.step(ad, st, tparams, toks)[2]), rel=1e-6)


def test_adam_matches_optax():
    """``burnin.Adam`` against optax's ``adam(lr)`` on the same leaves and
    gradients for 6 updates, f32, within 2.5e-7 (two f32 steps at the
    leaves' size, the same formulas rounded in another order)."""
    r = np.random.RandomState(7)
    params = {"blocks": [{"qkv": {"a": r.standard_normal((5, 3)).astype(np.float32),
                                  "b": np.zeros((3, 4), np.float32)}}]}
    jopt, topt = optax.adam(1e-2), tb.Adam(1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    tstate = topt.init(tp)
    for _ in range(6):
        g = jax.tree.map(lambda x: (r.standard_normal(x.shape) * 0.1).astype(np.float32), params)
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        topt.update_(tp, jax.tree.map(torch.from_numpy, g), tstate)
        for got, want in zip(tb.param_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2.5e-7, rtol=0)
    assert int(tstate["count"]) == 6
    assert (tb.Adam.b1, tb.Adam.b2, tb.Adam.eps, tb.Adam.weight_decay) == (0.9, 0.999, 1e-8, 0.0)


def test_adam_state_from_jax_continues_lora_training(base):
    """Two JAX LoRA steps, then the adapters and optax's ``adam`` state
    cross into the port (``adapters_from_jax``, ``opt_state_from_jax``);
    steps 3 and 4 in both packages agree within this module's
    tolerances."""
    jparams, tparams = base
    jfns = jl.build_lora_train_step(JCFG, JLORA, lr=LR)
    jad, jst = jfns.init(jax.random.PRNGKey(3))
    toks = _tokens()
    for _ in range(2):
        jad, jst, _ = jfns.step(jad, jst, jparams, jnp.asarray(toks))
    tad, tst = adapters_from_jax(jad, device="cpu"), opt_state_from_jax(jst, device="cpu")
    assert int(tst["count"]) == 2 and len(tst["mu"]) == len(jax.tree.leaves(jad))
    tfns = tl.build_lora_train_step(TCFG, TLORA, lr=LR, device="cpu")
    jlosses, tlosses = [], []
    for _ in range(2):
        jad, jst, jloss = jfns.step(jad, jst, jparams, jnp.asarray(toks))
        tlosses.append(float(tfns.step(tad, tst, tparams, torch.from_numpy(toks))[2]))
        jlosses.append(float(jloss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    got = jax.tree.leaves(params_to_numpy(tad))
    for g, w in zip(got, jax.tree.leaves(jax.tree.map(np.asarray, jad))):
        np.testing.assert_allclose(g, w, atol=2 * LR, rtol=0)
        assert np.linalg.norm(g - w) <= PARAM_RTOL_L2 * np.linalg.norm(w)


def test_lora_step_raises_without_a_card_and_checks_its_arguments(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.build_lora_train_step(TCFG, TLORA)
    with pytest.raises(ValueError, match="attention must be"):
        tl.build_lora_train_step(TCFG, TLORA, attention="ring", device="cpu")
    with pytest.raises(ValueError, match="rank"):
        tl.build_lora_train_step(TCFG, tl.LoraConfig(rank=0), device="cpu")


def test_lora_step_makes_no_host_read(monkeypatch, base):
    """With every tensor-to-host read made to raise, a flash LoRA step runs
    through and the loss comes back as a tensor."""
    _, tparams = base
    fns = tl.build_lora_train_step(TCFG, TLORA, lr=LR, attention="flash", device="cpu")
    ad, st = fns.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(b=2, s=32))

    def refuse(*_a, **_k):
        raise AssertionError("host read inside the LoRA step")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "__bool__", "cpu", "numpy"):
            m.setattr(torch.Tensor, name, refuse)
        _, _, loss = fns.step(ad, st, tparams, toks)
    assert isinstance(loss, torch.Tensor) and torch.isfinite(loss)


class _StandInGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_graphed_step_keys_on_the_base():
    """``GraphedTrainStep(base=...)``: the same adapters, state and base
    replay one capture; the base refilled in place still replays; another
    base tree is a new program, eager then captured."""
    runs, graphs = [], []

    def sgd(params, opt_state, base_params, tokens):
        runs.append(base_params["embed"].sum().clone())
        return params, opt_state, tokens.float().mean()

    def capture(fn, device):
        graphs.append(_StandInGraph())
        return graphs[-1], fn()

    holder = tb.GraphedTrainStep(sgd, torch.device("cpu"), capture=capture)
    gen = torch.Generator().manual_seed(0)
    base_a = tb.init_params(gen, TCFG)
    base_b = tb.init_params(gen, TCFG)
    ad = tl.init_adapters(torch.Generator().manual_seed(1), TCFG, TLORA)
    st = tb.Adam().init(ad)
    toks = torch.from_numpy(_tokens(b=2, s=8))
    for _ in range(3):
        holder(ad, st, toks, base=base_a)
    first = holder.program
    assert holder.captures == 1 and len(runs) == 2 and graphs[0].replays == 2
    with torch.no_grad():
        base_a["embed"].mul_(2.0)  # in place: the same addresses
    holder(ad, st, toks, base=base_a)
    assert holder.program is first and holder.captures == 1
    for _ in range(2):
        holder(ad, st, toks, base=base_b)
    assert holder.program is not first and holder.captures == 2 and len(runs) == 4
    with pytest.raises(tg.GraphCaptureError):
        bad = tb.GraphedTrainStep(sgd, torch.device("cpu"), capture=lambda fn, dev: 1 / 0)
        for _ in range(2):
            bad(ad, st, toks, base=base_a)
