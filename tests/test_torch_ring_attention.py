"""The port's sequence-parallel attention against the JAX package's on the
same 4-device meshes: ring, flash ring, Ulysses (plain and flash inner) and
sharded flash, outputs and the gradients of sum(out²).

Four gloo ranks on the CPU (one ``RankPool`` for the module) run each
scheme on their blocks of the same seeded inputs (``tests/torch_mesh_ranks.py``);
the JAX side runs the reference's sharded functions under ``jax.jit`` on 4
of the conftest's virtual CPU devices, its Pallas kernels in interpret
mode; the port's flash wrappers take their plain versions on CPU tensors.
Tolerance: 2e-5 absolute in f32, the reference tests' own bound for these
functions against their oracle.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from k8s_dra_driver_torch.ops import ring_attention as tra
from k8s_dra_driver_torch.parallel import mesh as tm
from k8s_dra_driver_torch.parallel.ranks import RankPool
from k8s_dra_driver_tpu.ops import flash_attention as jfa
from k8s_dra_driver_tpu.ops import ring_attention as jra
from k8s_dra_driver_tpu.parallel import mesh as jm
from tests import torch_mesh_ranks as R
from tests.conftest import cpu_devices

ATOL = 2e-5
B, S, H, D = 2, 32, 4, 8
SEQ4 = (0, {"seq": 4})
SEQ_MODEL = (0, {"seq": 2, "model": 2})
DATA_SEQ = (0, {"data": 2, "seq": 2})
DATA_MODEL = (0, {"data": 2, "model": 2})
SEQ_SPEC = ("data", "seq", None, None)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, backend="gloo", device_type="cpu", timeout_s=120)
    yield p
    p.close()


def _inputs(seed=7, shape=(B, S, H, D)):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(*shape).astype(np.float32) for _ in range(3))


def _jax_mesh(layout):
    return jm.build_mesh(cpu_devices(4), jm.MeshShape(**layout[1]))


def _jax_case(fn, layout, spec, q, k, v, dtype=jnp.float32):
    """The reference's output and gradients of sum(out²) (in f32) on its
    mesh, one compile."""
    mesh = _jax_mesh(layout)
    sharding = NamedSharding(mesh, JP(*spec))
    args = [jax.device_put(jnp.asarray(x, dtype), sharding) for x in (q, k, v)]

    def loss(a, b, c):
        out = fn(a, b, c, mesh=mesh)
        return jnp.sum(jnp.square(out.astype(jnp.float32))), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(*args)
    return [np.asarray(out, np.float32)] + [np.asarray(g, np.float32) for g in grads]


def _port_case(pool, layout, kind, spec, q, k, v, causal, dtype="float32", grads=True):
    results = pool.run(R.attention_case, layout, kind, spec, q, k, v, causal, dtype, grads)
    ranks, names = pool.run(R.mesh_layout, layout)[0][:2]
    return [tm.unshard([torch.from_numpy(r[i]) for r in results], ranks, names, spec).numpy()
            for i in range(len(results[0]))]


def _close(got, want, atol=ATOL):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


CASES = [
    # (port kind, reference function, layout, spec)
    ("ring", functools.partial(jra.ring_attention, head_axis=None), SEQ4, SEQ_SPEC),
    ("ring", jra.ring_attention, SEQ_MODEL, ("data", "seq", "model", None)),
    ("ring_flash", functools.partial(jra.ring_flash_attention, head_axis=None, block_q=8,
                                     block_k=8, interpret=True), SEQ4, SEQ_SPEC),
    ("ring_flash", functools.partial(jra.ring_flash_attention, block_q=16, block_k=16,
                                     interpret=True), SEQ_MODEL, ("data", "seq", "model", None)),
    ("ulysses", jra.ulysses_attention, SEQ4, SEQ_SPEC),
    ("ulysses_flash", functools.partial(jra.ulysses_attention, use_flash=True, block_q=16,
                                        block_k=16, interpret=True), SEQ4, SEQ_SPEC),
    ("ulysses_flash", functools.partial(jra.ulysses_attention, use_flash=True, interpret=True),
     DATA_SEQ, SEQ_SPEC),
    ("sharded_flash", functools.partial(jfa.sharded_flash_attention, interpret=True),
     DATA_MODEL, ("data", None, "model", None)),
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind,ref,layout,spec", CASES,
                         ids=[f"{c[0]}-{'x'.join(f'{k}{v}' for k, v in c[2][1].items())}"
                              for c in CASES])
def test_outputs_and_gradients_match_the_reference(pool, kind, ref, layout, spec, causal):
    q, k, v = _inputs()
    want = _jax_case(functools.partial(ref, causal=causal), layout, spec, q, k, v)
    _close(_port_case(pool, layout, kind, spec, q, k, v, causal), want)


def test_flash_ring_bf16_inputs_merge_in_f32(pool):
    """bf16 inputs see one final rounding: within the reference test's
    2.5e-2 of the f32 oracle, and within one bf16 step of the reference's
    own bf16 flash ring."""
    q, k, v = _inputs(seed=3)
    oracle = np.asarray(jra.reference_attention(
        *(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32) for x in (q, k, v))))
    ref = _jax_case(functools.partial(jra.ring_flash_attention, head_axis=None, block_q=8,
                                      block_k=8, interpret=True),
                    SEQ4, SEQ_SPEC, q, k, v, dtype=jnp.bfloat16)[0]
    got = _port_case(pool, SEQ4, "ring_flash", SEQ_SPEC, q, k, v, True, "bfloat16",
                     grads=False)[0]
    np.testing.assert_allclose(got, oracle, atol=2.5e-2, rtol=0)
    np.testing.assert_allclose(got, ref, atol=2 ** -8 * np.abs(ref).max(), rtol=0)


def test_awkward_shard_length(pool):
    """s_loc 24 under the default 512 blocks: the reference degrades its
    blocks, the port's kernels take any length."""
    q, k, v = _inputs(seed=5, shape=(2, 96, 2, 8))
    want = _jax_case(functools.partial(jra.ring_flash_attention, head_axis=None, interpret=True),
                     SEQ4, SEQ_SPEC, q, k, v)
    _close(_port_case(pool, SEQ4, "ring_flash", SEQ_SPEC, q, k, v, True), want)


def test_ulysses_rejects_indivisible_heads(pool):
    q = np.ones((1, 16, 2, 8), np.float32)  # 2 heads over a 4-way seq axis
    with pytest.raises(RuntimeError, match="divisible"):
        pool.run(R.attention_case, SEQ4, "ulysses", SEQ_SPEC, q, q, q, True)


def test_merge_blocks_matches_the_reference():
    rs = np.random.RandomState(11)
    oa, ob = rs.randn(2, 3, 5, 4).astype(np.float32)
    la, lb = (rs.randn(3, 5) * 4).astype(np.float32), (rs.randn(3, 5) * 4).astype(np.float32)
    got = tra._merge_blocks(*(torch.from_numpy(x) for x in (oa, la, ob, lb)))
    want = jra._merge_blocks(oa, la, ob, lb)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)
