"""Dense-cache decoding of the PyTorch port (``models/decode.py``) against
the JAX package's, on the CPU, with the same weights and seeded prompts.

Tolerances: greedy token streams identical; float32 logits and cache
entries within atol = rtol = 1e-4; the attention core within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import decode as td
from k8s_dra_driver_torch.models.weights import params_from_jax
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import decode as jd

JCFG = jb.ModelConfig(
    vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
    d_ff=128, max_seq=64, rope=True, dtype=jnp.float32,
)
TCFG = tb.ModelConfig.from_reference(JCFG)


@pytest.fixture(scope="module")
def weights():
    jp = jb.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_jax(jp, device="cpu")


def _prompt(b=2, p=7, seed=1):
    return np.random.RandomState(seed).randint(0, 128, size=(b, p)).astype(np.int32)


@pytest.mark.parametrize("batch_prefill", [False, True])
def test_greedy_decode_streams_identical(weights, batch_prefill):
    jp, tparams = weights
    prompt = _prompt()
    want = np.asarray(jd.greedy_decode(jp, jnp.asarray(prompt), 9, JCFG,
                                       batch_prefill=batch_prefill))
    got = td.greedy_decode(tparams, prompt, 9, TCFG, batch_prefill=batch_prefill,
                           device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_cache_and_logits_match(weights):
    jp, tparams = weights
    prompt = _prompt(p=11, seed=2)
    jcache, jlog = jd.prefill(jp, jnp.asarray(prompt), JCFG, max_seq=16)
    tcache, tlog = td.prefill(tparams, torch.from_numpy(prompt).long(), TCFG, max_seq=16)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), atol=1e-4, rtol=1e-4)


def test_ragged_chunk_with_inactive_row_matches(weights):
    """decode_chunk at per-row depths with one row inactive: logits of the
    active rows and the whole cache agree; the inactive row's cache keeps
    its bytes."""
    jp, tparams = weights
    seq = _prompt(b=3, p=10, seed=3)
    jcache = jd.init_cache(JCFG, 3, 16)
    tcache = td.init_cache(TCFG, 3, 16)
    jl, jcache = jd.decode_chunk(jp, jcache, jnp.asarray(seq), 0, cfg=JCFG)
    tl, tcache = td.decode_chunk(tparams, tcache, torch.from_numpy(seq).long(), 0, cfg=TCFG)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    window = np.array([[5, 6], [7, 8], [9, 10]], np.int32)
    pos = np.array([10, 4, 7], np.int32)
    active = np.array([True, False, True])
    jl, jcache = jd.decode_chunk(jp, jcache, jnp.asarray(window), jnp.asarray(pos), cfg=JCFG,
                                 active=jnp.asarray(active))
    before = tcache.k[:, 1].clone()
    tl, tcache = td.decode_chunk(tparams, tcache, torch.from_numpy(window).long(),
                                 torch.from_numpy(pos), cfg=TCFG,
                                 active=torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tcache.k[:, 1].numpy(), before.numpy())


def test_teacher_forced_decode_reproduces_forward(weights):
    _, tparams = weights
    seq = torch.from_numpy(_prompt(p=12, seed=4)).long()
    cache = td.init_cache(TCFG, 2, 12)
    steps = []
    for pos in range(12):
        logits, cache = td.decode_step(tparams, cache, seq[:, pos], pos, cfg=TCFG)
        steps.append(logits)
    np.testing.assert_allclose(
        torch.stack(steps, dim=1).numpy(), tb.forward(tparams, seq, TCFG).numpy(),
        atol=1e-4, rtol=1e-4,
    )


@pytest.mark.parametrize(
    "hq,hkv,mask_heads", [(4, 4, 1), (4, 2, 1), (4, 2, 4), (4, 2, None)]
)
def test_masked_attention_both_branches_match(hq, hkv, mask_heads):
    rng = np.random.RandomState(5)
    q = rng.standard_normal((2, 3, hq, 8)).astype(np.float32)
    k = rng.standard_normal((2, 6, hkv, 8)).astype(np.float32)
    v = rng.standard_normal((2, 6, hkv, 8)).astype(np.float32)
    if mask_heads is None:
        mask = rng.rand(3, 6) > 0.3                      # [Q, K]
    else:
        mask = rng.rand(2, mask_heads, 3, 6) > 0.3       # [B, H, Q, K]
    mask[..., 0] = True
    want = np.asarray(jd._masked_attention(*map(jnp.asarray, (q, k, v, mask))))
    got = td._masked_attention(*map(torch.from_numpy, (q, k, v, mask))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_masked_attention_rejects_ambiguous_masks():
    q = torch.zeros((2, 1, 4, 8))
    kv = torch.zeros((2, 3, 2, 8))
    with pytest.raises(ValueError, match="head axis"):
        td._masked_attention(q, kv, kv, torch.ones((2, 2, 1, 3), dtype=torch.bool))
    with pytest.raises(ValueError, match="ambiguous"):
        td._masked_attention(q, kv, kv, torch.ones((2, 1, 3), dtype=torch.bool))


def test_serving_state_helpers_match():
    rng = np.random.RandomState(6)
    nxt = rng.randint(0, 5, size=8).astype(np.int32)
    last = rng.randint(0, 5, size=8).astype(np.int32)
    pos = rng.randint(0, 9, size=8).astype(np.int32)
    stop = rng.randint(0, 10, size=8).astype(np.int32)
    active = rng.rand(8) > 0.3
    want = jd.advance_decode_state(*map(jnp.asarray, (nxt, last, pos, active, stop)), 3)
    got = td.advance_decode_state(*map(torch.from_numpy, (nxt, last, pos, active, stop)), 3)
    for w, g in zip(want, got, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    logits = rng.standard_normal((4, 6)).astype(np.float32)
    poison = np.array([False, True, False, False])
    jl = jd.poison_rows(jnp.asarray(logits), jnp.asarray(poison))
    tl = td.poison_rows(torch.from_numpy(logits), torch.from_numpy(poison))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.finite_rows(tl).numpy(), np.asarray(jd.finite_rows(jl)))
    assert td.poison_rows(tl, None) is tl
