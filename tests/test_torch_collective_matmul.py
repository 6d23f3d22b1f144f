"""The port's collective matmul (``ops/collective_matmul.py``) against the
JAX package's on the CPU.

Four gloo ranks (one ``RankPool`` for the module) run each ring on their
blocks; the JAX side runs the same functions under ``shard_map`` on 4 of
the conftest's 8 virtual CPU devices, on the same seeded numpy inputs.
The ring runs over ``model``: n 2 on ``(data 2, model 2)``, whose data
axis carries a leading dim of independent slices, and n 4 on ``(model
4)``.  Outputs and the gradients of ``sum(out · ct)`` for both operands
are held within 1e-5 of each one's largest element (f32, the same
products summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from k8s_dra_driver_torch.parallel import mesh as tm
from k8s_dra_driver_torch.parallel.ranks import RankPool
from k8s_dra_driver_tpu.ops import collective_matmul as jcm
from k8s_dra_driver_tpu.parallel import mesh as jm
from tests import torch_mesh_ranks as R
from tests.conftest import cpu_devices

TOL = 1e-5
LAYOUTS = {2: (0, {"data": 2, "model": 2}), 4: (0, {"model": 4})}
# (inputs' specs, output's spec) over [data slice, rows, cols]
SPECS = {
    "all_gather_matmul": ([("data", "model", None), ("data", None, "model")],
                          ("data", None, "model")),
    "matmul_reduce_scatter": ([("data", None, "model"), ("data", "model", None)],
                              ("data", "model", None)),
    "tp_mlp": ([("data", "model", None), ("data", None, "model"), ("data", "model", None)],
               ("data", "model", None)),
}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, backend="gloo", device_type="cpu", timeout_s=120)
    yield p
    p.close()


def _jax_mesh(layout):
    return jm.build_mesh(cpu_devices(4), jm.MeshShape(**layout[1]))


def _jax_sharded(name, layout, **kw):
    fn = getattr(jcm, name)
    in_specs, out_spec = SPECS[name]
    return jax.jit(jax.shard_map(
        lambda *xs: fn(*(x[0] for x in xs), "model", **kw)[None], mesh=_jax_mesh(layout),
        in_specs=tuple(JP(*s) for s in in_specs), out_specs=JP(*out_spec), check_vma=False))


def _inputs(name, n, seed=0):
    """Seeded f32 inputs, [data slice, rows, cols]; rows 8 a rank (even:
    the bidirectional ring splits them)."""
    rng = np.random.RandomState(seed)
    d0, s = (2 if n == 2 else 1), 8 * n
    shapes = {
        "all_gather_matmul": [(d0, s, 16), (d0, 16, 12 * n)],
        "matmul_reduce_scatter": [(d0, s, 4 * n), (d0, 4 * n, 12)],
        "tp_mlp": [(d0, s, 16), (d0, 16, 8 * n), (d0, 8 * n, 16)],
    }[name]
    return [(rng.randn(*sh) / np.sqrt(sh[-2])).astype(np.float32) for sh in shapes]


def _jax_reference(fn, arrays, ct):
    """(output, gradients of sum(out · ct)) of ``fn``."""
    out, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(ct))]


def _assemble(pool, layout, results, specs):
    """Each output of the ranks' ``results`` reassembled by its spec."""
    ranks, names = pool.run(R.mesh_layout, layout)[0][:2]
    return [tm.unshard([torch.from_numpy(r[i]) for r in results], ranks, names, spec).numpy()
            for i, spec in enumerate(specs)]


def _close(got, want, tol=TOL):
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=tol * np.abs(w).max(), rtol=0)


def _port(pool, layout, name, arrays, in_specs, out_spec, ct, **kw):
    results = pool.run(R.spec_case, layout, name, arrays, in_specs, out_spec, ct, **kw)
    return _assemble(pool, layout, results, [out_spec, *in_specs])


@pytest.mark.parametrize("name", ["all_gather_matmul", "matmul_reduce_scatter"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_ring_matches_the_reference(pool, name, n, bidirectional):
    layout, arrays = LAYOUTS[n], _inputs(name, n)
    in_specs, out_spec = SPECS[name]
    fn = _jax_sharded(name, layout, bidirectional=bidirectional)
    ct = np.random.RandomState(1).randn(*jax.eval_shape(fn, *arrays).shape).astype(np.float32)
    want = _jax_reference(fn, arrays, ct)
    got = _port(pool, layout, name, arrays, in_specs, out_spec, ct, bidirectional=bidirectional)
    _close(got, want)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_mlp_matches_the_dense_mlp(pool, n):
    """``tp_mlp`` (the rings' default direction: bidirectional at n 4)
    against the dense tanh-GELU MLP of each slice, forward and gradients,
    and against the reference's ``tp_mlp``."""
    layout, arrays = LAYOUTS[n], _inputs("tp_mlp", n)
    in_specs, out_spec = SPECS["tp_mlp"]
    dense = jax.jit(lambda x, wi, wo: jax.nn.gelu(x @ wi) @ wo)
    ct = np.random.RandomState(1).randn(*arrays[0].shape).astype(np.float32)
    got = _port(pool, layout, "tp_mlp", arrays, in_specs, out_spec, ct)
    _close(got, _jax_reference(dense, arrays, ct))
    _close(got, _jax_reference(_jax_sharded("tp_mlp", layout), arrays, ct))


def test_sharded_tp_mlp_matches_the_reference(pool):
    """``sharded_tp_mlp`` on ``(model 4)``, bidirectional, ``[B, S, D]``
    with S over ``model``: against the reference's and the dense MLP."""
    layout = LAYOUTS[4]
    rng = np.random.RandomState(3)
    x = rng.randn(2, 32, 16).astype(np.float32)
    wi = (rng.randn(16, 64) / 4).astype(np.float32)
    wo = (rng.randn(64, 16) / 8).astype(np.float32)
    specs = [(None, "model", None), (None, "model"), ("model", None)]
    out_spec = (None, "model", None)
    ct = rng.randn(*x.shape).astype(np.float32)
    got = _port(pool, layout, "sharded_tp_mlp", [x, wi, wo], specs, out_spec, ct,
                bidirectional=True)
    jmesh = _jax_mesh(layout)
    ref = jax.jit(lambda *a: jcm.sharded_tp_mlp(*a, mesh=jmesh, bidirectional=True))
    _close(got, _jax_reference(ref, [x, wi, wo], ct))
    _close(got, _jax_reference(jax.jit(lambda x, wi, wo: jax.nn.gelu(x @ wi) @ wo),
                               [x, wi, wo], ct))


@pytest.mark.parametrize("name,shapes,in_specs,bidirectional", [
    # 3 rows a rank for the bidirectional gather
    ("all_gather_matmul", [(1, 12, 16), (1, 16, 8)], SPECS["all_gather_matmul"][0], True),
    # 5 output columns for the bidirectional scatter
    ("matmul_reduce_scatter", [(1, 16, 8), (1, 8, 5)], SPECS["matmul_reduce_scatter"][0], True),
    # 14 rows, whole on every rank, over a ring of 4
    ("matmul_reduce_scatter", [(1, 14, 8), (1, 8, 4)],
     [("data", None, None), ("data", None, None)], False),
], ids=["odd-rows", "odd-cols", "rows-indivisible"])
def test_refusals_carry_the_reference_messages(pool, name, shapes, in_specs, bidirectional):
    layout, out_spec = LAYOUTS[4], SPECS[name][1]
    arrays = [np.zeros(s, np.float32) for s in shapes]
    with pytest.raises(ValueError) as want:
        jax.shard_map(lambda *xs: getattr(jcm, name)(*(x[0] for x in xs), "model",
                                                     bidirectional=bidirectional)[None],
                      mesh=_jax_mesh(layout), in_specs=tuple(JP(*s) for s in in_specs),
                      out_specs=JP(*out_spec), check_vma=False)(*arrays)
    got = pool.run(R.spec_case, layout, name, arrays, in_specs, out_spec,
                   np.zeros(1, np.float32), bidirectional=bidirectional)
    assert got == [str(want.value)] * 4


def test_bf16_inputs_accumulate_in_f32(pool):
    """``matmul_reduce_scatter`` of bf16 operands over 4 ranks: each
    element within one bf16 rounding of the f32 sum of the exact products
    (an accumulator rounded to bf16 at each of the 4 steps leaves it), and
    the reference's output the same way."""
    layout = LAYOUTS[4]
    rng = np.random.RandomState(0)
    x = rng.randn(1, 64, 256).astype(np.float32)
    w = rng.randn(1, 256, 16).astype(np.float32)
    xb, wb = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (x, w))
    ref = xb[0].astype(np.float64) @ wb[0].astype(np.float64)
    in_specs, out_spec = SPECS["matmul_reduce_scatter"]
    got = _port(pool, layout, "matmul_reduce_scatter", [xb, wb], in_specs, out_spec,
                np.zeros((1, 64, 16), np.float32), dtype="bfloat16")[0][0]
    # one bf16 rounding of the result, and room for the f32 sum's order
    bound = 2.0 ** -8 * np.abs(ref) + 1e-4
    assert (np.abs(got - ref) <= bound).all()
    fn = jax.jit(jax.shard_map(
        lambda a, b: jcm.matmul_reduce_scatter(a[0], b[0], "model")[None],
        mesh=_jax_mesh(layout), in_specs=(JP(*in_specs[0]), JP(*in_specs[1])),
        out_specs=JP(*out_spec), check_vma=False))
    want = np.asarray(fn(jnp.asarray(xb, jnp.bfloat16), jnp.asarray(wb, jnp.bfloat16))
                      .astype(jnp.float32))[0]
    assert (np.abs(want - ref) <= bound).all()
