"""The port's expert parallelism (``ops/moe.py``) against the JAX
package's, f32, on the CPU.

``topk_moe`` runs on four gloo ranks over ``(data 4)`` (one ``RankPool``
for the module), 8 experts, top 1 and top 2, with ample capacity (no
copy dropped) and a tight one (many dropped), against the JAX
``topk_moe`` on 4 virtual CPU devices on the same seeded inputs: the
output within 2e-5 of its largest element, the gradients of ``sum(out ·
ct)`` for x, the router and both expert stacks within 2e-5 of each
one's largest, and the same expert choices and the same set of dropped
(token, choice) copies, the reference's recounted on the host from its
own top-k.  The dense oracle, the rank-priority case and the three
refusals are held the same way.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.ops import moe as tmoe
from k8s_dra_driver_torch.parallel.ranks import RankPool
from k8s_dra_driver_tpu.ops import moe as jmoe
from k8s_dra_driver_tpu.parallel import mesh as jm
from tests import torch_mesh_ranks as R
from tests.conftest import cpu_devices

TOL = 2e-5
LAYOUT = (0, {"data": 4})
N, T, D, F, E = 4, 64, 8, 16, 8


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, backend="gloo", device_type="cpu", timeout_s=120)
    yield p
    p.close()


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(T, D).astype(np.float32),
            (rng.randn(D, E) * 0.5).astype(np.float32),
            (rng.randn(E, D, F) / np.sqrt(D)).astype(np.float32),
            (rng.randn(E, F, D) / np.sqrt(F)).astype(np.float32)]


def _host_drops(experts, capacity):
    """The kept copies of one rank's routing ``experts [T_loc, k]``,
    recounted by a loop: every first choice in token order, then every
    second, each taking its expert's next slot while one is left."""
    used = {}
    keep = np.zeros(experts.shape, bool)
    for r in range(experts.shape[1]):
        for t in range(experts.shape[0]):
            e = int(experts[t, r])
            keep[t, r] = used.get(e, 0) < capacity
            used[e] = used.get(e, 0) + 1
    return keep


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5], ids=["ample", "tight"])
@pytest.mark.parametrize("k", [1, 2])
def test_topk_moe_matches_the_reference(pool, k, capacity_factor):
    x, wr, wu, wd = _inputs(k)
    ct = np.random.RandomState(7).randn(T, D).astype(np.float32)
    mesh = jm.build_mesh(cpu_devices(4), jm.MeshShape(data=N))
    fn = jax.jit(functools.partial(jmoe.topk_moe, mesh=mesh, capacity_factor=capacity_factor,
                                   k=k))
    want, vjp = jax.vjp(fn, *map(jnp.asarray, (x, wr, wu, wd)))
    want_grads = [np.asarray(g) for g in vjp(jnp.asarray(ct))]
    results = pool.run(R.moe_case, LAYOUT, x, wr, wu, wd, ct, capacity_factor, k)
    out = np.concatenate([r[0] for r in results])
    np.testing.assert_allclose(out, want, atol=TOL * np.abs(want).max(), rtol=0)
    # x and the experts: each rank's blocks in rank order; the router: each
    # rank's part of the whole, summed
    got_grads = [np.concatenate([r[1] for r in results]), sum(r[2] for r in results),
                 np.concatenate([r[3] for r in results]), np.concatenate([r[4] for r in results])]
    for g, w in zip(got_grads, want_grads, strict=True):
        np.testing.assert_allclose(g, w, atol=TOL * np.abs(w).max(), rtol=0)
    # the reference's own routing of each rank's tokens, its drops recounted
    t_loc = T // N
    capacity = tmoe.moe_capacity(capacity_factor, t_loc, k, E)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(wr), axis=-1)
    _, j_experts = jmoe._topk_gates(probs, k)
    j_experts = np.asarray(j_experts)
    dropped = 0
    for rank, r in enumerate(results):
        experts, keep = r[5], r[6]
        rows = slice(rank * t_loc, (rank + 1) * t_loc)
        np.testing.assert_array_equal(experts, j_experts[rows])
        np.testing.assert_array_equal(keep, _host_drops(j_experts[rows], capacity))
        dropped += int((~keep).sum())
    assert (dropped > 0) == (capacity_factor < 1)


@pytest.mark.parametrize("k", [1, 2])
def test_dense_oracle_matches_the_reference(k):
    x, wr, wu, wd = _inputs(3)
    want = np.asarray(jmoe.reference_topk_moe(*map(jnp.asarray, (x, wr, wu, wd)), k=k))
    got = tmoe.reference_topk_moe(*map(torch.from_numpy, (x, wr, wu, wd)), k=k).numpy()
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)
    if k == 1:
        np.testing.assert_array_equal(
            tmoe.reference_switch_moe(*map(torch.from_numpy, (x, wr, wu, wd))).numpy(), got)


def test_rank_priority_under_tight_capacity():
    """``tests/test_moe.py``'s case on one device: both tokens prefer
    expert 0; with one slot an expert, token 0's first choice takes it,
    token 1's first choice drops and its second (expert 2) survives, so
    both outputs are nonzero; the same numbers as the reference's."""
    x = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    wr = np.array([[4.0, 2.0, -4.0, -9.0], [4.0, -4.0, 2.0, -9.0]], np.float32)
    wu = np.ones((4, 2, 2), np.float32)
    wd = np.ones((4, 2, 2), np.float32)
    got = tmoe.topk_moe_local(*map(torch.from_numpy, (x, wr, wu, wd)), None, capacity=1,
                              k=2).numpy()
    assert np.abs(got[0]).sum() > 0 and np.abs(got[1]).sum() > 0
    _, _, _, keep = tmoe.route(torch.from_numpy(x), torch.from_numpy(wr), 4, 1, 2)
    np.testing.assert_array_equal(keep.numpy(), [[True, True], [False, True]])
    mesh = jm.build_mesh(cpu_devices(1), jm.MeshShape(data=1))
    want = jax.shard_map(
        functools.partial(jmoe.topk_moe_local, axis_name="data", capacity=1, k=2), mesh=mesh,
        in_specs=(jax.sharding.PartitionSpec("data", None), jax.sharding.PartitionSpec(),
                  jax.sharding.PartitionSpec("data", None, None),
                  jax.sharding.PartitionSpec("data", None, None)),
        out_specs=jax.sharding.PartitionSpec("data", None))(x, wr, wu, wd)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("shapes,k", [
    ([(T, D), (D, 6), (6, D, F), (6, F, D)], 1),      # 6 experts over 4 ranks
    ([(T, D), (D, 16), (E, D, F), (E, F, D)], 1),     # a router wider than the experts
    ([(T, D), (D, E), (E, D, F), (E, F, D)], 9),      # k past the experts
], ids=["indivisible", "router", "k"])
def test_refusals_carry_the_reference_messages(pool, shapes, k):
    mesh = jm.build_mesh(cpu_devices(4), jm.MeshShape(data=N))
    with pytest.raises(ValueError) as want:
        jmoe.topk_moe(*(jnp.zeros(s) for s in shapes), mesh=mesh, k=k)
    assert pool.run(R.moe_refusal, LAYOUT, shapes, k) == [str(want.value)] * 4
