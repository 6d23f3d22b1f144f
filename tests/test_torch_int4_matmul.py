"""The int4 dequant-dot of the PyTorch port (``ops/int4_matmul.py``)
against the JAX package's Pallas kernel, run in interpret mode on the CPU
as the JAX package's own tests run it.  A CPU tensor takes the plain
version; the CUDA kernel itself is checked on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).

Tolerances: dequantized weights identical; float32 products within
atol = rtol = 2e-5 (the Pallas kernel sums K in tiles, the plain version
in one product); bf16 products within one bf16 step of the result
(atol = rtol = 2e-2), as the JAX package's own kernel tests state."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.models import quant as tq
from k8s_dra_driver_torch.models.weights import tensor_from_array
from k8s_dra_driver_torch.ops import int4_matmul as ti4
from k8s_dra_driver_tpu.models import quant as jq
from k8s_dra_driver_tpu.ops import int4_matmul as ji4


def _torch_dtype(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _pair(k=256, n=256, gs=64, dtype="float32", seed=0):
    w = np.random.RandomState(seed).standard_normal((k, n)).astype(np.float32)
    jm = jq.Quantized4Matrix.quantize(jnp.asarray(w), group_size=gs, dtype=jnp.dtype(dtype))
    tm = tq.Quantized4Matrix(
        tensor_from_array(jm.packed, "cpu"), tensor_from_array(jm.scale, "cpu"),
        gs, _torch_dtype(dtype),
    )
    return jm, tm


@pytest.mark.parametrize("m", [1, 16])
def test_plain_version_matches_pallas_kernel_f32(m):
    jm, tm = _pair()
    x = np.random.RandomState(1).standard_normal((m, 256)).astype(np.float32)
    want = np.asarray(ji4.int4_matmul(jnp.asarray(x), jm, block_n=128, block_k=128, interpret=True))
    got = ti4.int4_matmul_plain(torch.from_numpy(x), tm.packed, tm.scale, 64).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_plain_version_matches_pallas_kernel_bf16():
    jm, tm = _pair(dtype="bfloat16", seed=2)
    x = np.random.RandomState(3).standard_normal((16, 256)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(
        ji4.int4_matmul(jx, jm, block_n=128, block_k=128, interpret=True).astype(jnp.float32)
    )
    tx = tensor_from_array(np.asarray(jx), "cpu")
    got = ti4.int4_matmul_plain(tx, tm.packed, tm.scale, 64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_is_bit_identical(dtype):
    jm, tm = _pair(k=128, n=64, dtype=dtype, seed=4)
    got = ti4.dequant_int4(tm.packed, tm.scale, 64, _torch_dtype(dtype))
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(jm.dequant().astype(jnp.float32))
    )


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    jm, tm = _pair(k=128, n=128, seed=5)
    x = torch.from_numpy(np.random.RandomState(6).standard_normal((2, 3, 128)).astype(np.float32))
    before = ti4.launches
    got = ti4.int4_matmul(x, tm.packed, tm.scale, 64)
    assert ti4.launches == before
    assert tuple(got.shape) == (2, 3, 128)
    want = ti4.int4_matmul_plain(x.reshape(6, 128), tm.packed, tm.scale, 64).reshape(2, 3, 128)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize(
    "k,n,gs,ok",
    [
        (1024, 1536, 64, True), (1024, 1024, 64, True), (1024, 4096, 64, True),
        (4096, 1024, 64, True), (1024, 1536, 32, False), (1000, 1024, 64, False),
        (1024, 1000, 64, False),
    ],
)
def test_kernel_shape_rule_takes_every_flagship_matrix(k, n, gs, ok):
    if ok:
        ti4.check_kernel_shape(k, n, gs)
    else:
        with pytest.raises(ValueError, match="int4 kernel takes"):
            ti4.check_kernel_shape(k, n, gs)


@pytest.mark.parametrize("m,dtype,name", [
    (1, torch.bfloat16, "int4_splitk"), (8, torch.bfloat16, "int4_splitk"),
    (16, torch.bfloat16, "int4_splitk"), (17, torch.bfloat16, "int4_wgmma"),
    (256, torch.bfloat16, "int4_wgmma"), (1, torch.float32, "int4_splitk"),
    (256, torch.float32, "int4_splitk"),
])
def test_kernel_rule_is_static_on_m_and_dtype(m, dtype, name):
    """float32 never reaches the tensor-core kernel (it would run as TF32)."""
    assert ti4.kernel_for(m, dtype) == name


FLAGSHIP = [(1024, 1536), (1024, 1024), (1024, 4096), (4096, 1024)]


@pytest.mark.parametrize("k,n", FLAGSHIP + [(192, 256), (704, 4096)])
@pytest.mark.parametrize("m", [1, 8, 16, 40, 256])
def test_splitk_plan_covers_k_in_one_cluster(k, n, m):
    """Splits cover every group once, at most one cluster of them, and the
    grid stays within three quarters of two blocks on each of 132 SMs
    unless it has one split."""
    g, splits = ti4.splitk_plan(m, k, n, 132)
    groups = k // 64
    assert (splits - 1) * g < groups <= splits * g
    assert splits <= ti4.MAX_SPLITS
    blocks = -(-n // ti4.SPLITK_TILE_N) * -(-m // ti4.SPLITK_ROWS) * splits
    assert blocks <= 198 or splits == 1


@pytest.mark.parametrize("k,n", FLAGSHIP + [(192, 256), (704, 4096)])
@pytest.mark.parametrize("m", [17, 40, 256, 300])
def test_wgmma_plan_covers_k_and_m(k, n, m):
    g, splits, mt = ti4.wgmma_plan(m, k, n, 132)
    groups = k // 64
    assert 1 <= mt <= 4 and mt == min(4, -(-m // 64))
    assert (splits - 1) * g < groups <= splits * g
    assert splits <= ti4.MAX_SPLITS
