"""Paged attention of the PyTorch port (``ops/paged_attention.py``) against
the JAX package's Pallas kernel in interpret mode and its gather oracle
``paged_window_attention_xla_gqa``, on the CPU.  The CUDA kernel itself is
checked on the card (``tests/test_torch_gpu.py`` and ``chip_smoke.py``).

Shapes are chosen so a transposed layout cannot pass unnoticed (head dim
8 != block size 4) and so the append window crosses a page boundary.

Tolerances: float32 outputs within atol = rtol = 1e-5 (online softmax in
the Pallas kernel, one softmax in the plain version); bf16 pools within
atol = 2e-2 (one bf16 step of outputs of magnitude ~1); appended pool
bytes identical outside the null block 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.models.weights import tensor_from_array
from k8s_dra_driver_torch.ops import paged_attention as tpa
from k8s_dra_driver_tpu.ops import paged_attention as jpa

B, HQ, HKV, D, BS, MB = 3, 4, 2, 8, 4, 5
N_POOL = 1 + B * MB


def _case(nq, pos, dtype="float32", seed=0):
    rng = np.random.RandomState(seed)
    layers = 2
    pools = [rng.standard_normal((layers, N_POOL, HKV, D, BS)).astype(np.float32) for _ in range(2)]
    table = (1 + rng.permutation(B * MB)).reshape(B, MB).astype(np.int32)
    q = rng.standard_normal((B, nq, HQ, D)).astype(np.float32)
    nk = rng.standard_normal((B, nq, HKV, D)).astype(np.float32)
    nv = rng.standard_normal((B, nq, HKV, D)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    j = {name: jnp.asarray(a).astype(jdt) for name, a in
         dict(k=pools[0], v=pools[1], q=q, nk=nk, nv=nv).items()}
    t = {name: tensor_from_array(np.asarray(a), "cpu") for name, a in j.items()}
    return j, t, table, np.asarray(pos, np.int32)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("nq,pos", [(1, [0, 9, 19]), (3, [1, 7, 17])])
def test_window_matches_pallas_kernel_and_gather_oracle(nq, pos):
    j, t, table, pos = _case(nq, pos)
    layer = 1
    got = tpa.paged_window_attention(
        t["q"], t["k"][layer], t["v"][layer], torch.from_numpy(table), torch.from_numpy(pos)
    )
    oracle = jpa.paged_window_attention_xla_gqa(
        j["q"], j["k"][layer], j["v"][layer], jnp.asarray(table), jnp.asarray(pos)
    )
    kernel = jpa.paged_window_attention(
        j["q"], j["k"][layer], j["v"][layer], jnp.asarray(table), jnp.asarray(pos),
        pages_per_step=2, interpret=True,
    )
    np.testing.assert_allclose(_np(got), _np(oracle), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(got), _np(kernel), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("nq,pos", [(1, [0, 8, 19]), (3, [2, 7, 16])])
def test_append_matches_pallas_kernel_outputs_and_pool_bytes(dtype, atol, nq, pos):
    """Fused append + attend: rows with write_mask set store their window
    (crossing a page boundary at pos 2 and 7) in place, the masked row
    writes nothing, and every row attends its window keys."""
    j, t, table, pos = _case(nq, pos, dtype=dtype, seed=1)
    layer = 1
    wmask = np.array([1, 0, 1], np.int32)
    k_pools, v_pools = t["k"].clone(), t["v"].clone()
    out, k_ret, v_ret = tpa.paged_append_attention(
        t["q"], t["nk"], t["nv"], k_pools, v_pools, torch.from_numpy(table),
        torch.from_numpy(pos), layer, write_mask=torch.from_numpy(wmask),
    )
    assert k_ret is k_pools and v_ret is v_pools  # updated in place
    jout, jk, jv = jpa.paged_append_attention(
        j["q"], j["nk"], j["nv"], j["k"], j["v"], jnp.asarray(table), jnp.asarray(pos),
        layer, write_mask=jnp.asarray(wmask), pages_per_step=2, interpret=True,
    )
    np.testing.assert_allclose(_np(out), _np(jout), atol=atol, rtol=atol)
    np.testing.assert_array_equal(_np(k_pools)[:, 1:], _np(jk)[:, 1:])
    np.testing.assert_array_equal(_np(v_pools)[:, 1:], _np(jv)[:, 1:])
    # the masked row's pages were not touched; the other layer neither
    untouched = table[1]
    np.testing.assert_array_equal(_np(k_pools)[layer, untouched], _np(t["k"])[layer, untouched])
    np.testing.assert_array_equal(_np(k_pools)[0], _np(t["k"])[0])


def test_decode_view_matches_pallas_kernel():
    j, t, table, pos = _case(1, [3, 11, 19], seed=2)
    lengths = pos + 1
    got = tpa.paged_decode_attention(
        t["q"][:, 0], t["k"][0], t["v"][0], torch.from_numpy(table), torch.from_numpy(lengths)
    )
    want = jpa.paged_decode_attention(
        j["q"][:, 0], j["k"][0], j["v"][0], jnp.asarray(table), jnp.asarray(lengths),
        interpret=True,
    )
    assert tuple(got.shape) == (B, HQ, D)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    j, t, table, pos = _case(1, [0, 5, 10], seed=3)
    before = dict(tpa.launches)
    tpa.paged_append_attention(
        t["q"], t["nk"], t["nv"], t["k"], t["v"], torch.from_numpy(table),
        torch.from_numpy(pos), 0,
    )
    tpa.paged_window_attention(t["q"], t["k"][0], t["v"][0], torch.from_numpy(table),
                               torch.from_numpy(pos))
    assert tpa.launches == before


def test_kernel_states_its_own_rule():
    tpa.check_kernel_shape(64, 1, 16, append=True)   # the serving shape
    tpa.check_kernel_shape(64, 16, 16, append=True)
    tpa.check_kernel_shape(128, 32, 16, append=False)
    with pytest.raises(ValueError, match="head_dim"):
        tpa.check_kernel_shape(48, 1, 16, append=False)
    with pytest.raises(ValueError, match="exceeds block_size"):
        tpa.check_kernel_shape(64, 17, 16, append=True)
    j, t, table, pos = _case(1, [0, 5, 10], seed=4)
    with pytest.raises(ValueError, match="layer"):
        tpa.paged_append_attention(
            t["q"], t["nk"], t["nv"], t["k"], t["v"], torch.from_numpy(table),
            torch.from_numpy(pos), 2,
        )


@pytest.mark.parametrize("block_size", [1, 4, 16, 128])
def test_split_schedule_covers_the_table_from_shapes_alone(block_size):
    """The kernel's splits: each of at most SPLIT_KEYS keys (one block when
    a block is larger), enough of them to cover every table entry and no
    split past the table's end."""
    for max_blocks in (1, 5, 64, 65):
        pages, n_splits = tpa.split_schedule(block_size, max_blocks)
        assert 1 <= pages <= 128 and pages * block_size <= max(tpa.SPLIT_KEYS, block_size)
        assert (n_splits - 1) * pages < max_blocks <= n_splits * pages
