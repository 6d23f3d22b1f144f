"""Weight-only quantization of the PyTorch port against the JAX package's,
on the CPU.  Packing is integer work, so bytes, scales and dequantized
values must be IDENTICAL; products agree within float32 tolerance
(atol = rtol = 1e-5: the same products summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import quant as tq
from k8s_dra_driver_torch.models.weights import params_from_jax, tensor_from_array
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import quant as jq


def _weight(k=128, n=64, seed=0):
    return np.random.RandomState(seed).standard_normal((k, n)).astype(np.float32) * 0.1


def test_pack_int4_bytes_identical_and_round_trip():
    rng = np.random.RandomState(1)
    q = rng.randint(-8, 8, size=(6, 10)).astype(np.int8)
    for axis in (0, 1, -1):
        want = np.asarray(jq.pack_int4(jnp.asarray(q), axis=axis))
        got = tq.pack_int4(torch.from_numpy(q), dim=axis).numpy()
        np.testing.assert_array_equal(got, want)
        back = tq.unpack_int4(torch.from_numpy(got), dim=axis).numpy()
        np.testing.assert_array_equal(back, q)
    with pytest.raises(ValueError, match="even"):
        tq.pack_int4(torch.zeros((3, 2), dtype=torch.int8), dim=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group_size", [64, 32])
def test_int4_quantize_and_dequant_identical(dtype, group_size):
    w = _weight()
    jw = jnp.asarray(w).astype(jnp.dtype(dtype))
    tw = tensor_from_array(np.asarray(jw), "cpu")
    jm = jq.Quantized4Matrix.quantize(jw, group_size=group_size)
    tm = tq.Quantized4Matrix.quantize(tw, group_size=group_size)
    np.testing.assert_array_equal(tm.packed.numpy(), np.asarray(jm.packed))
    np.testing.assert_array_equal(tm.scale.numpy(), np.asarray(jm.scale))
    assert tm.shape == tuple(jm.shape) and tm.group_size == jm.group_size
    np.testing.assert_array_equal(
        tm.dequant().float().numpy(), np.asarray(jm.dequant().astype(jnp.float32))
    )


def test_int8_quantize_and_dequant_identical():
    w = _weight(seed=2)
    jm = jq.QuantizedMatrix.quantize(jnp.asarray(w))
    tm = tq.QuantizedMatrix.quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(tm.q.numpy(), np.asarray(jm.q))
    np.testing.assert_array_equal(tm.scale.numpy(), np.asarray(jm.scale))
    np.testing.assert_array_equal(tm.dequant().numpy(), np.asarray(jm.dequant()))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_blocks_and_bytes_match(bits):
    jcfg = jb.ModelConfig(
        vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=128, max_seq=64, rope=True, dtype=jnp.float32,
    )
    jp = jb.init_params(jax.random.PRNGKey(0), jcfg)
    jq_params = jq.quantize_blocks(jp, bits=bits, kernel=False)
    tq_params = tq.quantize_blocks(params_from_jax(jp, device="cpu"), bits=bits)
    assert tq.quantized_bytes(tq_params) == jq.quantized_bytes(jq_params)
    loaded = params_from_jax(jq_params, device="cpu")
    for tblk, lblk in zip(tq_params["blocks"], loaded["blocks"], strict=True):
        for key in ("qkv", "attn_out", "mlp_up", "mlp_down"):
            np.testing.assert_array_equal(
                tq.mat(tblk[key]).numpy(), tq.mat(lblk[key]).numpy()
            )
    with pytest.raises(ValueError, match="bits"):
        tq.quantize_blocks(tq_params, bits=3)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_matmul_last_matches(bits):
    rng = np.random.RandomState(3)
    w = _weight(seed=4)
    x = rng.standard_normal((2, 3, 128)).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    if bits == 8:
        jw, tw = jq.QuantizedMatrix.quantize(jw), tq.QuantizedMatrix.quantize(tw)
    elif bits == 4:
        jw, tw = jq.Quantized4Matrix.quantize(jw), tq.Quantized4Matrix.quantize(tw)
    want = np.asarray(jq.matmul_last(jnp.asarray(x), jw))
    got = tq.matmul_last(torch.from_numpy(x), tw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_int4_logits_through_the_port_match_jax():
    """A whole forward on int4 block weights: the port's plain int4
    product against the JAX package's dequantize-then-dot (atol 1e-4)."""
    jcfg = jb.ModelConfig(
        vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=128, max_seq=64, rope=True, dtype=jnp.float32,
    )
    jp = jq.quantize_blocks(jb.init_params(jax.random.PRNGKey(5), jcfg), bits=4, kernel=False)
    toks = np.random.RandomState(6).randint(0, 128, size=(2, 9)).astype(np.int32)
    want = np.asarray(jb.forward(jp, jnp.asarray(toks), jcfg, remat="none"))
    got = tb.forward(
        params_from_jax(jp, device="cpu"), torch.from_numpy(toks).long(),
        tb.ModelConfig.from_reference(jcfg),
    ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_matrix_ndim_is_the_references(bits):
    """``QuantizedMatrix.ndim`` and ``Quantized4Matrix.ndim`` (reference
    ``models/quant.py:50``, ``:115``) equal the JAX matrices'."""
    w = _weight(seed=3)
    if bits == 8:
        jm = jq.QuantizedMatrix.quantize(jnp.asarray(w))
        tm = tq.QuantizedMatrix.quantize(torch.from_numpy(w))
    else:
        jm = jq.Quantized4Matrix.quantize(jnp.asarray(w))
        tm = tq.Quantized4Matrix.quantize(torch.from_numpy(w))
    assert tm.ndim == jm.ndim == 2
