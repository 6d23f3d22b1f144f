"""Mixture-of-experts models in the PyTorch port (``burnin.ModelConfig(
n_experts=E, moe_top_k=k)``) against the JAX package's, on the CPU, at the
reference's MoE serving size (``tests/test_moe_serve.py``: vocab 89, d 64,
4 heads over 2 KV heads, 2 layers, d_ff 128, max_seq 128, RoPE, 4 experts,
top-2) in float32, so routing is decided by the same scores: the same
weights (made by the JAX package, loaded through ``params_from_jax``), the
same tokens from a seeded numpy generator.

Tolerances: the MoE MLP within 1e-5 (atol and rtol) with the same experts
chosen for every token; forward logits within 1e-4 (the burn-in tests'
bound); the loss within 1e-5 relative and every gradient element within
1e-5 (atol and rtol) of ``jax.grad``'s; token streams, statuses and pool
counters exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import decode as td
from k8s_dra_driver_torch.models import lora as tl
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models import quant as tq
from k8s_dra_driver_torch.models import serve as ts
from k8s_dra_driver_torch.models.weights import bank_from_jax, params_from_jax, params_to_numpy
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import lora as jl
from k8s_dra_driver_tpu.models import paged as jp
from k8s_dra_driver_tpu.models import quant as jq
from k8s_dra_driver_tpu.models import serve as js

JCFG = jb.ModelConfig(
    vocab_size=89, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=128, max_seq=128,
    rope=True, n_experts=4, moe_top_k=2, dtype=jnp.float32,
)
TCFG = tb.ModelConfig.from_reference(JCFG)
ENGINES = {
    "dense": dict(n_slots=3, prompt_bucket=16),
    "paged": dict(n_slots=3, n_blocks=40, block_size=8, prompt_bucket=16),
}
MLP_TOL = 1e-5


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


def _prompts(n, seed=7):
    r = np.random.RandomState(seed)
    return [r.randint(0, JCFG.vocab_size, size=r.randint(3, 12)).tolist() for _ in range(n)]


def _engine(weights, kind, pkg="port", params=None, **kw):
    jparams, tparams = weights if params is None else params
    kw = dict(ENGINES[kind], **kw)
    if kind == "dense":
        if pkg == "jax":
            return js.ServeEngine(params=jparams, cfg=JCFG, **kw)
        return ts.ServeEngine(params=tparams, cfg=TCFG, device="cpu", **kw)
    if pkg == "jax":
        return jp.PagedServeEngine(params=jparams, cfg=JCFG, attn_impl="xla", **kw)
    return tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu", **kw)


def _streams(comps):
    return {c.request_id: (c.generated, c.status) for c in comps}


def _counters(eng):
    out = dict(host_syncs=eng.host_syncs)
    if hasattr(eng, "stalled_steps"):
        out.update(stalls=eng.stalled_steps, preempted=eng.preempted_count,
                   hits=eng.prefix_hits, misses=eng.prefix_misses, blocks=eng.free_blocks)
    return out


# -- the model ----------------------------------------------------------------------

@pytest.mark.parametrize("bad,match", [
    (dict(n_experts=1), "must be >= 2"),
    (dict(n_experts=4, moe_top_k=0), "moe_top_k"),
    (dict(n_experts=4, moe_top_k=5), "moe_top_k"),
])
def test_config_checks_are_the_reference(bad, match):
    """``ModelConfig`` refuses what the reference refuses, with its words,
    and ``from_reference`` reads an MoE config field for field."""
    for cls in (jb.ModelConfig, tb.ModelConfig):
        with pytest.raises(ValueError, match=match):
            cls(**bad)
    assert (TCFG.n_experts, TCFG.moe_top_k, TCFG.dtype) == (4, 2, torch.float32)


def _moe_inputs(case):
    """Normalized tokens ``[32, d]`` and a block whose routing hits
    ``case``: "random" scores; "all_tie", a zero row (every score 0);
    "two_way_tie", a router with two equal columns (experts 1 and 2 tie
    on every row, so the second choice falls between them wherever they
    share second place)."""
    r = np.random.RandomState(3)
    y = r.standard_normal((32, JCFG.d_model)).astype(np.float32)
    block = jb.init_params(jax.random.PRNGKey(4), JCFG)["blocks"][0]
    block = {k: np.array(v) for k, v in block.items()}
    if case == "all_tie":
        y[[0, 5, 31]] = 0.0
    if case == "two_way_tie":
        block["router"][:, 2] = block["router"][:, 1]
    return y, block


@pytest.mark.parametrize("case", ["random", "all_tie", "two_way_tie"])
def test_moe_mlp_matches_jax_with_the_same_experts(case):
    """``_moe_mlp`` and the MoE ``mlp_residual`` against the JAX
    package's, with the experts ``jax.lax.top_k`` chooses for every token
    (on equal scores the lower index first)."""
    y, block = _moe_inputs(case)
    jblock = {k: jnp.asarray(v) for k, v in block.items()}
    tblock = {k: torch.from_numpy(v) for k, v in block.items()}
    scores = y @ block["router"]
    want_idx = np.asarray(jax.lax.top_k(jnp.asarray(scores), 2)[1])
    _, got_idx = tb.top_k_experts(torch.from_numpy(y).float() @ tblock["router"], 2)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    if case == "all_tie":
        assert (want_idx[[0, 5, 31]] == [0, 1]).all()
    if case == "two_way_tie":  # 2 only beside 1, and 1 alone where the tie is cut
        has1, has2 = (want_idx == 1).any(axis=1), (want_idx == 2).any(axis=1)
        assert not (has2 & ~has1).any() and (has1 & ~has2).any()
    want = np.asarray(jb._moe_mlp(jnp.asarray(y), jblock, 2))
    got = tb._moe_mlp(torch.from_numpy(y), tblock, 2).numpy()
    np.testing.assert_allclose(got, want, atol=MLP_TOL, rtol=MLP_TOL)
    x = y.reshape(4, 8, -1)
    want = np.asarray(jb.mlp_residual(jnp.asarray(x), jblock, top_k=2))
    got = tb.mlp_residual(torch.from_numpy(x), tblock, top_k=2).numpy()
    np.testing.assert_allclose(got, want, atol=MLP_TOL, rtol=MLP_TOL)


def test_top_k_orders_signed_zeros_as_xla_does():
    """XLA's top_k orders -0.0 below +0.0 (a total order); ties keep the
    lower index first.  ``top_k_experts`` gives the same indices."""
    rows = np.array([[0.0, -0.0, 0.0, 1.0], [2.0, 2.0, 2.0, 2.0], [-1.0, -0.0, -1.0, -2.0]],
                    np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(rows), 3)[1])
    vals, idx = tb.top_k_experts(torch.from_numpy(rows), 3)
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(vals.numpy(), np.take_along_axis(rows, want, axis=1))


def test_moe_block_needs_top_k():
    """A block with a router and no ``top_k`` raises, in both packages."""
    y, block = _moe_inputs("random")
    for mod, wrap in ((jb, jnp.asarray), (tb, torch.from_numpy)):
        with pytest.raises(ValueError, match="MoE block needs top_k"):
            mod.mlp_residual(wrap(y[None]), {k: wrap(v) for k, v in block.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_matches_jax_with_an_f32_router(dtype):
    """``init_params`` gives the JAX package's keys, shapes and dtypes (the
    router f32 whatever the model dtype, no dense MLP pair), and
    ``params_from_jax``/``params_to_numpy`` carry the expert leaves both
    ways with their dtypes."""
    jcfg = dataclasses.replace(JCFG, dtype=getattr(jnp, dtype))
    tcfg = tb.ModelConfig.from_reference(jcfg)
    jparams = jb.init_params(jax.random.PRNGKey(1), jcfg)
    mine = tb.init_params(torch.Generator().manual_seed(1), tcfg)
    assert tb.block_matrix_shapes(tcfg) == jb.block_matrix_shapes(jcfg)
    assert set(tb.block_matrix_shapes(tcfg)) == {"qkv", "attn_out"}
    carried = params_from_jax(jparams, device="cpu")
    for tree in (mine, carried):
        assert set(tree) == set(jparams)
        for tblk, jblk in zip(tree["blocks"], jparams["blocks"], strict=True):
            assert set(tblk) == set(jblk) and "mlp_up" not in tblk
            for k, v in tblk.items():
                assert tuple(v.shape) == jblk[k].shape, k
                assert str(v.dtype).removeprefix("torch.") == str(jblk[k].dtype), k
    assert carried["blocks"][0]["router"].dtype == torch.float32
    assert carried["blocks"][0]["expert_up"].dtype == tb.torch_dtype(dtype)
    back = params_to_numpy(carried)
    for k in ("router", "expert_up", "expert_down"):
        np.testing.assert_array_equal(back["blocks"][1][k], np.asarray(jparams["blocks"][1][k]))
        assert back["blocks"][1][k].dtype == jparams["blocks"][1][k].dtype


def test_forward_logits_match_jax(weights):
    jparams, tparams = weights
    toks = np.random.RandomState(0).randint(0, JCFG.vocab_size, size=(2, 12)).astype(np.int32)
    want = np.asarray(jb.forward(jparams, jnp.asarray(toks), JCFG, remat="none"))
    got = tb.forward(tparams, torch.from_numpy(toks).long(), TCFG).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# -- training -----------------------------------------------------------------------

def _grads(params, toks, remat, attn_fn=None):
    return tb.value_and_grad(
        lambda p, t: tb.loss_fn(p, t, TCFG, attn_fn, remat=remat), params, toks)


@pytest.mark.parametrize("remat", ["blocks", "dots", "none"])
def test_loss_and_gradients_match_jax(weights, remat):
    """The loss and every gradient leaf against ``jax.value_and_grad`` of
    the reference's ``loss_fn`` under the same remat policy; and each
    policy's gradients bit-equal to ``"none"``'s (remat moves memory and
    time, never numbers)."""
    jparams, tparams = weights
    toks = np.random.RandomState(2).randint(0, JCFG.vocab_size, size=(2, 24)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jb.loss_fn(p, jnp.asarray(toks), JCFG, remat=remat))(jparams)
    loss, grads = _grads(tparams, torch.from_numpy(toks), remat)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    flat_got = jax.tree_util.tree_leaves_with_path(params_to_numpy(grads))
    flat_want = jax.tree_util.tree_leaves(jgrads)
    assert len(flat_got) == len(flat_want)
    for (path, g), w in zip(flat_got, flat_want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    plain_loss, plain = _grads(tparams, torch.from_numpy(toks), "none")
    assert torch.equal(loss, plain_loss)
    for g, h in zip(tb.param_leaves(grads), tb.param_leaves(plain)):
        assert torch.equal(g, h)


def test_dots_saves_the_router_and_up_products(weights, monkeypatch):
    """Under ``"dots"`` the policy saves the products without batch dims,
    the reference's set: the two attention products and the router
    (``aten.mm``) and the up product over broadcast tokens (a ``bmm`` of
    batch stride 0); the expert-batched down product and the routing
    combines recompute."""
    _, tparams = weights
    decided = []

    def recording(ctx, op, *args, **kwargs):
        policy = save_dots(ctx, op, *args, **kwargs)
        if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            decided.append((op.__name__.split(".")[0],
                            tuple(args[0].shape[:-1]) + tuple(args[1].shape[-1:]),
                            policy == CheckpointPolicy.MUST_SAVE))
        return policy

    save_dots = tb._save_dots
    monkeypatch.setattr(tb, "_save_dots", recording)
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, 89, size=(2, 8)).astype(np.int32))
    _grads(tparams, toks, "dots")
    t, e, f, d = 16, 4, JCFG.d_ff, JCFG.d_model
    saved = {(op, shape) for op, shape, keep in decided if keep}
    dropped = {(op, shape) for op, shape, keep in decided if not keep}
    assert saved == {("mm", (t, 128)), ("mm", (t, d)), ("mm", (t, e)), ("bmm", (e, t, f))}
    assert ("bmm", (e, t, d)) in dropped  # the down product
    assert ("bmm", (t, 1, e)) in dropped  # the gates' combine


def test_flash_train_steps_match_jax():
    """Two steps of ``build_train_step(attention="flash")`` over the MoE
    model against the JAX package's (its Pallas kernels in interpret mode,
    the port's kernels' plain versions): the losses within 1e-5 and every
    param leaf within 1e-4 relative L2 distance (``test_torch_train``'s
    bounds), and the loss falls."""
    jcfg = dataclasses.replace(JCFG, max_seq=32)
    jfns = jb.build_train_step(jcfg, attention="flash")
    jparams, jopt = jfns.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jparams, device="cpu")
    tfns = tb.build_train_step(tb.ModelConfig.from_reference(jcfg), attention="flash",
                               device="cpu")
    topt = tb.make_optimizer().init(tparams)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, size=(4, 32)).astype(np.int32)
    losses = []
    for _ in range(2):
        jparams, jopt, jloss = jfns.step(jparams, jopt, jnp.asarray(toks))
        tparams, topt, tloss = tfns.step(tparams, topt, torch.from_numpy(toks))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        losses.append(float(tloss))
    assert losses[1] < losses[0]
    got = jax.tree_util.tree_leaves(params_to_numpy(tparams))
    for g, w in zip(got, jax.tree_util.tree_leaves(jparams), strict=True):
        w = np.asarray(w)
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)


# -- serving ------------------------------------------------------------------------

def _mixed(n=6, seed=7):
    """Greedy and sampled requests (temperature 0.8, top-k off, per-request
    seeds)."""
    return [dict(prompt=p, max_tokens=10, temperature=0.8 if i % 2 else 0.0, seed=100 + i)
            for i, p in enumerate(_prompts(n, seed))]


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_streams_match_jax_and_sequential_greedy(weights, kind):
    """Six greedy and sampled requests over three slots: the JAX engine's
    streams and counters, and each greedy stream equal to
    ``decode.greedy_decode``'s sequential one."""
    reqs = _mixed()
    je, te = _engine(weights, kind, "jax"), _engine(weights, kind)
    got, want = _streams(te.pump(reqs)), _streams(je.pump(reqs))
    assert got == want and len(got) == 6
    assert _counters(te) == _counters(je)
    _, tparams = weights
    for rid, req in enumerate(reqs):
        if req["temperature"] == 0.0:
            seq = td.greedy_decode(tparams, [req["prompt"]], 10, TCFG, device="cpu")
            assert got[rid][0] == seq[0, len(req["prompt"]):].tolist()


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_speculative_int8_self_draft_streams_match(weights, kind):
    """gamma 4 with the int8 self-draft (``quantize_blocks`` quantizes the
    attention matrices only; the expert stacks stay in the model dtype):
    the JAX engine's streams and counters, and the plain engine's
    streams."""
    draft = tq.quantize_blocks(weights[1])
    assert isinstance(draft["blocks"][0]["qkv"], tq.QuantizedMatrix)
    assert draft["blocks"][0]["expert_up"] is weights[1]["blocks"][0]["expert_up"]
    reqs = [(p, 10) for p in _prompts(5, seed=11)]
    je = _engine(weights, kind, "jax", spec_gamma=4)
    te = _engine(weights, kind, spec_gamma=4)
    got = _streams(te.pump(reqs))
    assert got == _streams(je.pump(reqs)) and len(got) == 5
    assert _counters(te) == _counters(je)
    assert got == _streams(_engine(weights, kind).pump(reqs))
    assert 0 < te.spec_accepted <= te.spec_drafted


def test_int4_base_serves_with_the_expert_stacks_unquantized(weights):
    """An int4 base (``quantize_blocks(bits=4)``: the int4 kernels' plain
    versions on the attention projections) in the paged engine: the JAX
    engine's streams over its own int4 base."""
    jparams, _ = weights
    j4 = jq.quantize_blocks(jparams, bits=4, group_size=32, kernel=False)
    t4 = params_from_jax(j4, device="cpu")
    blk = t4["blocks"][0]
    assert isinstance(blk["qkv"], tq.Quantized4Matrix) and isinstance(blk["attn_out"],
                                                                       tq.Quantized4Matrix)
    assert blk["expert_down"].dtype == torch.float32 and blk["router"].dtype == torch.float32
    reqs = [(p, 8) for p in _prompts(4, seed=5)]
    je = _engine(weights, "paged", "jax", params=(j4, t4))
    te = _engine(weights, "paged", params=(j4, t4))
    assert _streams(te.pump(reqs)) == _streams(je.pump(reqs))


def _attention_bank():
    """A bank of two attention-only adapters with nonzero B, made with
    numpy, in both packages."""
    lcfg = jl.LoraConfig(rank=2, alpha=8.0, targets=("qkv", "attn_out"))
    dims = jb.block_matrix_shapes(JCFG)
    ads = []
    for seed in (1, 2):
        r = np.random.RandomState(seed)
        ads.append({"blocks": [
            {n: {"a": jnp.asarray((r.standard_normal((dims[n][0], 2)) / 2).astype(np.float32)),
                 "b": jnp.asarray((0.3 * r.standard_normal((2, dims[n][1]))).astype(np.float32))}
             for n in lcfg.targets}
            for _ in range(JCFG.n_layers)]})
    jbank = jl.stack_adapters(JCFG, lcfg, ads)
    return jbank, bank_from_jax(jbank, device="cpu")


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_attention_lora_on_moe_matches_jax(weights, kind):
    """Attention-only adapters serve on an MoE model in both engines with
    the JAX engine's streams (the identity row's equal to a bank-less
    engine's, an adapted one's differing); MLP targets raise the
    reference's error."""
    for mod in (jl, tl):
        with pytest.raises(ValueError, match="MoE replaces the dense MLP"):
            mod.LoraConfig(rank=2).validate(JCFG if mod is jl else TCFG)
    jbank, tbank = _attention_bank()
    prompts = _prompts(4, seed=9)
    reqs = [dict(prompt=p, max_tokens=8, adapter=i % 3) for i, p in enumerate(prompts)]
    je = _engine(weights, kind, "jax", adapter_bank=jbank)
    te = _engine(weights, kind, adapter_bank=tbank)
    got = _streams(te.pump(reqs))
    assert got == _streams(je.pump(reqs))
    plain = _streams(_engine(weights, kind).pump([(p, 8) for p in prompts]))
    assert got[0] == plain[0] and got[3] == plain[3] and got[1] != plain[1]


@pytest.mark.parametrize("chunk", [0, 1])
def test_paged_chunked_admission_and_prefix_sharing(weights, chunk):
    """The paged engine's prefix store (shared system prompts) with and
    without chunked admission, on an MoE model: the JAX engine's streams,
    hits and misses and pool counts."""
    system = np.random.RandomState(4).randint(0, 89, size=16).tolist()
    reqs = [(system + p, 8) for p in _prompts(5, seed=13)]
    kw = dict(prompt_bucket=32, prefix_cache_blocks=8, prefill_chunk_blocks=chunk)
    je, te = _engine(weights, "paged", "jax", **kw), _engine(weights, "paged", **kw)
    got = _streams(te.pump(reqs))
    assert got == _streams(je.pump(reqs)) and len(got) == 5
    assert _counters(te) == _counters(je) and te.prefix_hits > 0
