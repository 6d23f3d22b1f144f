"""The PyTorch port's flash attention against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_flash_attention.py`` does; the port's wrappers take their plain
versions for CPU tensors.  Inputs come from a seeded numpy generator.

Tolerance: f32 within atol 1e-5.  The plain versions compute the Pallas
kernels' formulas with the whole key range as one tile, so the two differ
only in f32 summation order (online softmax over 32-key blocks against one
pass) on values of size ~1: observed differences are ~1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.ops import flash_attention as tf
from k8s_dra_driver_tpu.ops import flash_attention as jf

ATOL = 1e-5
BLOCK_Q, BLOCK_K = 64, 32  # the JAX tests' uneven blocks


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module, restored afterwards: the
    suite's other workers keep their cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _arrays(*shape, n=4, seed=0):
    r = np.random.RandomState(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
def test_forward_bhsd_matches_pallas_kernel(causal):
    q, k, v, _ = _arrays(2, 128, 32)
    want_out, want_lse = jf._forward_bhsd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, BLOCK_Q, BLOCK_K, True
    )
    out, lse = tf._forward_bhsd(*_t(q, k, v), causal)
    assert out.dtype == torch.float32 and lse.shape == (2, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL)
    # the JAX kernel broadcasts lse over a 128-lane tail; the port keeps one
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], atol=ATOL)
    # out_dtype: float32 partials over bf16 inputs stay float32
    out16, _ = tf._forward_bhsd(*(x.bfloat16() for x in _t(q, k, v)), causal, torch.float32)
    assert out16.dtype == torch.float32


@pytest.mark.parametrize("causal", [True, False])
def test_backward_bhsd_matches_pallas_kernels(causal):
    q, k, v, dout = _arrays(2, 128, 32, seed=1)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, dout))
    jout, jlse = jf._forward_bhsd(jq, jk, jv, causal, BLOCK_Q, BLOCK_K, True)
    want = jf._backward_bhsd(jq, jk, jv, jout, jlse, jdo, causal, BLOCK_Q, BLOCK_K, True)
    tq, tk, tv, tdo = _t(q, k, v, dout)
    out, lse = tf._forward_bhsd(tq, tk, tv, causal)
    got = tf._backward_bhsd(tq, tk, tv, out, lse, tdo, causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=name)
    # a precomputed delta (the ring backward's) gives the same gradients
    delta = (tdo * out).sum(-1)
    again = tf._backward_bhsd(tq, tk, tv, out, lse, tdo, causal, delta=delta)
    for g, h in zip(got, again):
        assert torch.equal(g, h)


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax_grad(causal):
    """``jax.grad`` through the JAX package's ``flash_attention`` (custom
    VJP over the Pallas kernels) against ``torch.autograd.grad`` through
    the port's (``FlashCore``), for loss = sum(out * w)."""
    import jax

    q, k, v, w = _arrays(2, 64, 2, 16, seed=2)

    def jloss(a, b, c):
        o = jf.flash_attention(a, b, c, causal=causal, block_q=BLOCK_Q, block_k=BLOCK_K,
                               interpret=True)
        return jnp.sum(o * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = tf.flash_attention(tq, tk, tv, causal=causal, block_q=BLOCK_Q, block_k=BLOCK_K)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for g, wnt, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and g.shape == tq.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=ATOL, err_msg=name)


def test_forward_matches_jax_flash_attention_on_bshd():
    q, k, v, _ = _arrays(2, 64, 3, 16, seed=3)
    want = jf.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), block_q=BLOCK_Q,
                              block_k=BLOCK_K, interpret=True)
    got = tf.flash_attention(*_t(q, k, v), block_q=BLOCK_Q, block_k=BLOCK_K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the CUDA tile is the kernel's own: without blocks any S runs
    got_default = tf.flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(got_default.numpy(), got.numpy(), atol=ATOL)


def test_to_bh_and_from_bh_match_jax():
    (x,) = _arrays(2, 5, 3, 4, n=1, seed=4)
    bh = tf.to_bh(torch.from_numpy(x))
    assert bh.is_contiguous()
    np.testing.assert_array_equal(bh.numpy(), np.asarray(jf.to_bh(jnp.asarray(x))))
    np.testing.assert_array_equal(tf.from_bh(bh, 2, 3).numpy(), x)


def test_blocks_that_do_not_divide_s_raise_like_jax():
    q, k, v, _ = _arrays(1, 96, 2, 16, seed=5)
    with pytest.raises(ValueError, match="not divisible"):
        jf.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), block_q=64, block_k=64,
                           interpret=True)
    with pytest.raises(ValueError, match="not divisible"):
        tf.flash_attention(*_t(q, k, v), block_q=64, block_k=64)
    with pytest.raises(ValueError, match="share"):
        tf.flash_attention(*_t(q, k[:, :64], v))


def test_plain_path_counts_no_launch_and_needs_input_grad_is_honoured():
    """CPU tensors take the plain versions (no kernel launch is counted),
    and the backward computes only the gradients asked for."""
    before = dict(tf.launches)
    q, k, v, _ = _arrays(2, 32, 16, seed=6)
    tq, tk, tv = _t(q, k, v)
    tq.requires_grad_()
    out = tf.FlashCore.apply(tq, tk, tv, True)
    (dq,) = torch.autograd.grad(out.sum(), (tq,))
    assert dq.shape == tq.shape
    assert tf.launches == before


def test_kernel_rule_rejects_what_the_cuda_kernels_do_not_take():
    """The checks a CUDA tensor meets before its launch (here on CPU
    tensors, which never launch): head dims 16-128 in powers of two, one
    dtype of f32 or bf16, one shape."""
    ok = torch.zeros((2, 8, 64))
    tf.check_kernel_shape(ok, ok.clone())
    with pytest.raises(ValueError, match="head_dim"):
        tf.check_kernel_shape(torch.zeros((2, 8, 24)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tf.check_kernel_shape(ok.half())
    with pytest.raises(ValueError, match="share"):
        tf.check_kernel_shape(ok, ok.bfloat16())
    with pytest.raises(ValueError, match=r"\[BH, S, D\]"):
        tf.check_kernel_shape(torch.zeros((1, 2, 8, 64)))


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "flash_fwd_wgmma"),
                                        (torch.float32, "flash_fwd_fma")])
def test_forward_kernel_rule_is_static_on_dtype(dtype, name):
    """bf16 takes the tensor-core forward; f32 stays on the CUDA cores (the
    tensor cores would run it as TF32)."""
    assert tf.forward_kernel_for(dtype) == name


@pytest.mark.parametrize("dtype,names", [
    (torch.bfloat16, ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma")),
    (torch.float32, ("flash_bwd_dq_fma", "flash_bwd_dkv_fma")),
])
def test_backward_kernel_rule_is_static_on_dtype(dtype, names):
    """bf16 takes the tensor-core dQ and dK/dV kernels; f32 stays on the
    CUDA cores (the tensor cores would run it as TF32).  Each name has its
    own counter and launcher."""
    assert tf.backward_kernel_for(dtype) == names
    assert all(n in tf.bwd_launches and n in tf._LAUNCHERS for n in names)
