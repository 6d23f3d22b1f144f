"""The PyTorch port's burn-in transformer against the JAX package's, on the
CPU: same weights (made by the JAX package, loaded through
``params_from_jax``), same tokens from a seeded numpy generator.

Tolerance: float32 logits agree within atol = rtol = 1e-4 (the two
frameworks sum the same products in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_torch import device as tdevice
from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import decode as td
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models.weights import params_from_jax
from k8s_dra_driver_tpu.models import burnin as jb

ATOL = RTOL = 1e-4

JCFG = jb.ModelConfig(
    vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
    d_ff=128, max_seq=64, rope=True, dtype=jnp.float32,
)
VARIANTS = {
    "gqa_rope": JCFG,
    "mha_learned_pos": dataclasses.replace(JCFG, n_kv_heads=None, rope=False),
}


def _tokens(cfg, b=2, s=12, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_logits_match_jax(name):
    jcfg = VARIANTS[name]
    jp = jb.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tb.ModelConfig.from_reference(jcfg)
    tparams = params_from_jax(jp, device="cpu")
    toks = _tokens(jcfg)
    want = np.asarray(jb.forward(jp, jnp.asarray(toks), jcfg, remat="none"))
    got = tb.forward(tparams, torch.from_numpy(toks).long(), tcfg).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_config_from_reference_reads_every_field():
    cfg = tb.ModelConfig.from_reference(jb.FLAGSHIP_MODERN)
    assert cfg == tb.FLAGSHIP_MODERN
    assert cfg.dtype == torch.bfloat16
    assert (cfg.head_dim, cfg.kv_heads, cfg.kv_groups) == (64, 4, 4)
    assert tb.ModelConfig.from_reference(jb.TINY) == tb.TINY
    moe = dataclasses.replace(jb.FLAGSHIP_MODERN, n_experts=8, moe_top_k=2)
    assert tb.ModelConfig.from_reference(moe) == dataclasses.replace(
        tb.FLAGSHIP_MODERN, n_experts=8, moe_top_k=2)


def test_param_tree_matches_jax_keys_shapes_dtypes():
    jp = jb.init_params(jax.random.PRNGKey(1), JCFG)
    tcfg = tb.ModelConfig.from_reference(JCFG)
    mine = tb.init_params(torch.Generator().manual_seed(1), tcfg)
    assert set(mine) == set(jp)
    for key in ("embed", "ln_f"):
        assert tuple(mine[key].shape) == jp[key].shape
    for tblk, jblk in zip(mine["blocks"], jp["blocks"], strict=True):
        assert set(tblk) == set(jblk)
        for k, v in tblk.items():
            assert tuple(v.shape) == jblk[k].shape and v.dtype == torch.float32
    assert tb.block_matrix_shapes(tcfg) == jb.block_matrix_shapes(JCFG)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_rope_and_mlp_keep_the_reference_cast_order(dtype):
    """RMS-norm (f32 variance, rsqrt cast back), half-split RoPE with f32
    angles and the tanh GELU MLP, each against its JAX twin: bit-equal in
    bf16 elementwise steps, within 1e-5 in f32."""
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.randint(0, 60, size=(2, 5)).astype(np.int32)
    gamma = rng.standard_normal(16).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = tb.torch_dtype(jdt)
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    want = np.asarray(jb._rms_norm(jx, jnp.asarray(gamma).astype(jdt)).astype(jnp.float32))
    got = tb._rms_norm(tx, torch.from_numpy(gamma).to(tdt)).float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 if dtype == "float32" else 1e-2)
    want = np.asarray(jb.rope_rotate(jx, jnp.asarray(pos), JCFG).astype(jnp.float32))
    got = tb.rope_rotate(tx, torch.from_numpy(pos), tb.ModelConfig.from_reference(JCFG))
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-5 if dtype == "float32" else 1e-2)

    h = rng.standard_normal((3, 32)).astype(np.float32)
    p = {"ln2": np.ones(32, np.float32),
         "mlp_up": rng.standard_normal((32, 48)).astype(np.float32) * 0.2,
         "mlp_down": rng.standard_normal((48, 32)).astype(np.float32) * 0.2}
    want = np.asarray(jb.mlp_residual(jnp.asarray(h), {k: jnp.asarray(v) for k, v in p.items()}))
    got = tb.mlp_residual(torch.from_numpy(h), {k: torch.from_numpy(v) for k, v in p.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_tied_logits_and_repeat_kv_match():
    rng = np.random.RandomState(4)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    params = {"ln_f": rng.standard_normal(64).astype(np.float32),
              "embed": rng.standard_normal((128, 64)).astype(np.float32)}
    want = np.asarray(jb.tied_logits(jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}))
    got = tb.tied_logits(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in params.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    kv = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    tcfg = tb.ModelConfig.from_reference(JCFG)
    np.testing.assert_array_equal(
        tb.repeat_kv(torch.from_numpy(kv), tcfg).numpy(),
        np.asarray(jb.repeat_kv(jnp.asarray(kv), JCFG)),
    )


def test_entry_points_raise_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = tb.ModelConfig.from_reference(JCFG)
    params = tb.init_params(torch.Generator().manual_seed(0), tcfg)
    prompt = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.PagedServeEngine(params=params, cfg=tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.greedy_decode(params, prompt, 2, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.paged_greedy_decode(params, prompt, 2, tcfg, block_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"w": np.zeros(2, np.float32)})
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    eng = tp.PagedServeEngine(params=params, cfg=tcfg, device="cpu")
    assert eng.device == torch.device("cpu")
