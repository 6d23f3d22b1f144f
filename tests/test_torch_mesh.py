"""The port's mesh, its PartitionSpec counterpart, the claim attach, the
sharded parameter layout, the collective probes and process-safe kernel
builds, against the JAX package where it has a counterpart.

Four gloo ranks run on the CPU (``parallel/ranks.RankPool``, one pool for
the module); the functions they run live in ``tests/torch_mesh_ranks.py``,
which imports no JAX.  The JAX side runs on 4 of the conftest's 8 virtual
CPU devices.  Everything compared here is exact: rank layouts, shard
contents and round trips move bytes without arithmetic.
"""

import re
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from k8s_dra_driver_torch import consumer as tconsumer
from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import weights as tw
from k8s_dra_driver_torch.ops import _build
from k8s_dra_driver_torch.parallel import mesh as tm
from k8s_dra_driver_torch.parallel.ranks import RankPool
from k8s_dra_driver_tpu import consumer as jconsumer
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import pp_burnin
from k8s_dra_driver_tpu.ops import collectives as jco
from k8s_dra_driver_tpu.parallel import mesh as jm
from tests import torch_mesh_ranks as R
from tests.conftest import cpu_devices

LAYOUTS = [
    (0, {"seq": 4}),
    (0, {"data": 2, "model": 2}),
    (0, {"data": 2, "seq": 2}),
    (0, {"seq": 2, "model": 2}),
    (0, {"pipe": 2, "data": 2}),
    (2, {"data": 2}),
    (2, {"model": 2}),
]
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64,
           max_seq=32, rope=True)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, backend="gloo", device_type="cpu", timeout_s=120)
    yield p
    p.close()


def jax_mesh(layout):
    devs = cpu_devices(4)
    shape = jm.MeshShape(**layout[1])
    return jm.build_multislice_mesh(devs, layout[0], shape) if layout[0] else jm.build_mesh(
        devs, shape)


def device_ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_rank_layout_matches_the_jax_mesh(pool, layout):
    jmesh = jax_mesh(layout)
    results = pool.run(R.mesh_layout, layout)
    ranks, names = results[0][:2]
    np.testing.assert_array_equal(np.asarray(ranks), device_ids(jmesh))
    assert tuple(names) == tuple(jmesh.axis_names)
    ids = device_ids(jmesh)
    for r, (_, _, coord, groups) in enumerate(results):
        assert tuple(coord) == tuple(int(c[0]) for c in np.nonzero(ids == r))
        for axis, members in groups.items():
            # an axis's group: the ranks that differ from r in that axis only
            line = np.moveaxis(ids, names.index(axis), -1)[
                tuple(c for i, c in enumerate(coord) if i != names.index(axis))]
            assert members == line.tolist()


@pytest.mark.parametrize("layout,spec", [
    ((0, {"data": 2, "seq": 2}), ("data", "seq", None)),
    ((0, {"seq": 2, "model": 2}), (None, ("seq", "model"), None)),
    ((2, {"data": 2}), (("slice", "data"), None, None)),
    ((2, {"model": 2}), ("model", "slice", None)),
], ids=str)
def test_shard_matches_named_sharding_and_gathers_back(pool, layout, spec):
    x = np.arange(8 * 8 * 4, dtype=np.float32).reshape(8, 8, 4)
    arr = jax.device_put(jnp.asarray(x), NamedSharding(jax_mesh(layout), JP(*spec)))
    want = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
    results = pool.run(R.shard_roundtrip, layout, spec, x)
    for r, (block, whole) in enumerate(results):
        np.testing.assert_array_equal(block, want[r])
        np.testing.assert_array_equal(whole, x)
    ranks, names = pool.run(R.mesh_layout, layout)[0][:2]
    back = tm.unshard([torch.from_numpy(b) for b, _ in results], ranks, names, spec)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("n", range(1, 17))
def test_auto_mesh_shape_matches_the_reference(n):
    for want_seq in (False, True):
        got = tm.auto_mesh_shape(n, want_seq=want_seq)
        want = jm.auto_mesh_shape(n, want_seq=want_seq)
        assert (got.data, got.seq, got.model, got.pipe, got.total) == (
            want.data, want.seq, want.model, want.pipe, want.total)


def test_multislice_refusals_and_env_shape():
    for mod in (tm, jm):
        assert mod.multislice_env_shape({}) == (1, 0)
        assert mod.multislice_env_shape(
            {"MEGASCALE_NUM_SLICES": "4", "MEGASCALE_SLICE_ID": "2"}) == (4, 2)
    with pytest.raises(ValueError, match="split into"):
        tm.build_multislice_mesh(range(8), 3, tm.MeshShape(data=2), "cpu")
    with pytest.raises(ValueError, match="per-slice"):
        tm.build_multislice_mesh(range(8), 2, tm.MeshShape(data=2), "cpu")
    with pytest.raises(ValueError, match="needs 4 devices"):
        tm.build_mesh(range(2), tm.MeshShape(data=4), "cpu")


SLOT_AXES = ["data", ("slice", "data"), ("data", "model"), (), ("data", "data"), "expert"]
BOUNDS = [{}, {"TPU_CHIPS_PER_PROCESS_BOUNDS": "2,2,1"}, {"TPU_CHIPS_PER_PROCESS_BOUNDS": "2,1,1"}]


@pytest.mark.parametrize("layout", [(0, {"data": 2, "model": 2}), (2, {"data": 2})], ids=str)
def test_slot_axis_size_and_claimed_bounds_match_the_reference(pool, layout):
    jmesh = jax_mesh(layout)
    want = ([R._outcome(jm.slot_axis_size, jmesh, a) for a in SLOT_AXES],
            [R._outcome(jm.validate_claimed_mesh, jmesh, b) for b in BOUNDS])
    for got in pool.run(R.mesh_checks, layout, SLOT_AXES, BOUNDS):
        assert got == want


ENVS = [
    {},
    {
        "TPU_VISIBLE_DEVICES": "1,3", "TPU_CHIPS_PER_PROCESS_BOUNDS": "1,1,1",
        "TPU_PROCESS_BOUNDS": "2,2,1", "TPU_PROCESS_COORD": "1,0,0",
        "TPU_PARTITION_INDEX": "1", "TPU_SHARING_STRATEGY": "spatial-partition",
        "TPU_HBM_LIMIT_MIB": "4096", "TPU_TOPOLOGY_DAEMON_SOCKET": "/run/tpu-topology/u.sock",
        "TPU_WORKER_ID": "2", "TPU_HOST_COUNT": "4", "JAX_COORDINATOR_ADDRESS": "h0:8476",
    },
    {"TPU_SHARING_STRATEGY": "time-slicing", "TPU_VISIBLE_DEVICES": "0",
     "TPU_QUEUE_QUANTUM_MS": "1000", "TPU_TOPOLOGY_DAEMON_SOCKET": "/run/t.sock"},
    {"MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1"},
    {"MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1", "TPU_WORKER_ID": "1",
     "TPU_HOST_COUNT": "2", "MEGASCALE_COORDINATOR_ADDRESS": "m0:8080",
     "JAX_COORDINATOR_ADDRESS": "h0:8476"},
]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(sorted(e)) or "empty")
def test_attach_resolves_the_claim_as_the_reference(env):
    got = tconsumer.attach(environ=env, init_distributed=False)
    want = jconsumer.attach(environ=env, init_distributed=False)
    assert got.to_json() == want.to_json()
    for prop in ("multi_host", "multi_slice", "global_worker_id", "shared"):
        assert getattr(got, prop) == getattr(want, prop), prop


def _init_calls(monkeypatch):
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    return calls


def test_initialize_distributed_maps_the_claim_env(monkeypatch):
    """One rank a visible card: ENVS[1] shows 2 cards on each of 4 hosts,
    so worker 2's second process is rank 2 * 2 + 1 of 8."""
    calls = _init_calls(monkeypatch)
    env1 = {**ENVS[1], "LOCAL_RANK": "1"}
    tconsumer.attach(environ=ENVS[0], backend="gloo")  # one card, one host: no group
    tconsumer.attach(environ=env1, backend="gloo")
    tconsumer.attach(environ=ENVS[4], backend="gloo")
    assert calls == [
        (("gloo",), {"world_size": 8, "rank": 5, "init_method": "tcp://h0:8476"}),
        (("gloo",), {"world_size": 4, "rank": 3, "init_method": "tcp://m0:8080"}),
    ]
    with pytest.raises(ValueError, match="needs backend"):
        tconsumer.attach(environ=env1)
    with pytest.raises(ValueError, match="one process per card"):
        tconsumer.attach(environ=ENVS[1], backend="gloo")  # 2 cards, no LOCAL_RANK
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="nccl"):
            tconsumer.attach(environ=env1, backend="nccl")


@pytest.mark.parametrize("env,world,rank", [
    ({"TPU_VISIBLE_DEVICES": "0,1,2,3", "LOCAL_RANK": "2"}, 4, 2),
    ({"TPU_VISIBLE_DEVICES": "0,1,2,3", "LOCAL_RANK": "0"}, 4, 0),
    ({**ENVS[4], "TPU_VISIBLE_DEVICES": "0,1", "LOCAL_RANK": "1"}, 8, 7),
], ids=["one-host-4-cards-rank-2", "one-host-4-cards-rank-0", "multislice-2-cards"])
def test_a_claim_of_several_cards_gives_each_card_a_rank(monkeypatch, env, world, rank):
    calls = _init_calls(monkeypatch)
    ctx = tconsumer.attach(environ=env, backend="gloo")
    assert (ctx.world_size, ctx.rank) == (world, rank)
    ((args, kwargs),) = calls
    assert args == ("gloo",) and (kwargs["world_size"], kwargs["rank"]) == (world, rank)
    with pytest.raises(ValueError, match="outside"):
        tconsumer.attach(environ={**env, "LOCAL_RANK": "4"}, backend="gloo")


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
@pytest.mark.parametrize("seen,visible,local,card", [
    (8, "0,1", 0, 0),  # the queue's input: worker 1 is rank 2, yet takes card 0
    (8, "2,3", 0, 2),  # the container sees 8 cards, the claim holds 2 and 3
    (8, "2,3", 1, 3),
    (2, "2,3", 1, 1),  # the runtime showed the claim's 2 cards alone
], ids=["claim-0,1-of-8", "claim-2,3-of-8-local-0", "claim-2,3-of-8-local-1", "narrowed"])
def test_a_rank_takes_the_card_its_local_rank_names(monkeypatch, backend, seen, visible,
                                                    local, card):
    """2 cards a host on 4 hosts, worker 1: rank 2 + LOCAL_RANK of 8 takes
    the claim's card LOCAL_RANK names, never rank % cards or a card outside
    the claim, and ``rank_device`` then reports it."""
    import torch.distributed as dist

    calls = _init_calls(monkeypatch)
    cards = []
    monkeypatch.setattr(tm, "_rank_card", None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: seen)
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    env = {"TPU_VISIBLE_DEVICES": visible, "TPU_WORKER_ID": "1", "TPU_HOST_COUNT": "4",
           "LOCAL_RANK": str(local)}
    # a process whose CUDA is up but which took no card: rank % cards
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 2 + local)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tm.rank_device("cuda") == torch.device("cuda", (2 + local) % seen)
    ctx = tconsumer.attach(environ=env, backend=backend)
    assert (ctx.world_size, ctx.rank) == (8, 2 + local)
    assert cards == [card]
    ((args, kwargs),) = calls
    assert args == (backend,) and (kwargs["world_size"], kwargs["rank"]) == (8, 2 + local)
    assert kwargs.get("device_id") == (torch.device("cuda", card) if backend == "nccl" else None)
    assert tm.rank_device("cuda") == torch.device("cuda", card)


def test_a_claimed_card_the_container_does_not_see_is_refused(monkeypatch):
    monkeypatch.setattr(tm, "_rank_card", None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "set_device", lambda card: None)
    _init_calls(monkeypatch)
    env = {"TPU_VISIBLE_DEVICES": "2,3", "TPU_WORKER_ID": "1", "TPU_HOST_COUNT": "4",
           "LOCAL_RANK": "1"}
    with pytest.raises(ValueError, match="card 3 is not among the 3"):
        tconsumer.attach(environ=env, backend="gloo")


def test_consumer_builds_the_reference_mesh(pool, monkeypatch):
    devs = cpu_devices(4)
    monkeypatch.setattr(jax, "devices", lambda *a: devs)
    for env in ({"MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1"}, {}):
        want = jconsumer.attach(environ=env, init_distributed=False).build_mesh()
        for ranks, names in pool.run(R.consumer_mesh, env):
            assert tuple(names) == tuple(want.axis_names)
            np.testing.assert_array_equal(np.asarray(ranks), device_ids(want))
    with pytest.raises(RuntimeError, match="process group"):
        tconsumer.attach(environ={}).build_mesh(device_type="cpu")


def test_nccl_refuses_more_ranks_than_cards():
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="one card per rank"):
        tm.check_backend("nccl", cards + 1, "cuda")
    with pytest.raises(ValueError, match="one card per rank"):
        RankPool(cards + 1, backend="nccl", device_type="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        RankPool(1, backend="nccl", device_type="cpu")
    with pytest.raises(ValueError, match="'gloo' or 'nccl'"):
        RankPool(4, backend="mpi", device_type="cpu")


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_tree(v) for v in tree]
    return tuple(tree)


@pytest.mark.parametrize("moe", [False, True])
def test_param_pspecs_match_the_reference(moe):
    kw = dict(CFG, n_experts=4) if moe else dict(CFG)
    for rope in (True, False):
        got = tb.param_pspecs(tb.ModelConfig(**{**kw, "rope": rope}))
        want = jb.param_pspecs(jb.ModelConfig(**{**kw, "rope": rope}))
        assert _spec_tree(got) == _spec_tree(want)


@pytest.mark.parametrize("kv", [1, 2, 4])
def test_groupmajor_qkv_matches_the_reference_and_inverts(kv):
    jcfg = jb.ModelConfig(**{**CFG, "n_kv_heads": kv})
    w = np.random.RandomState(kv).randn(32, (4 + 2 * kv) * 8).astype(np.float32)
    got = tw.groupmajor_qkv(torch.from_numpy(w), tb.ModelConfig.from_reference(jcfg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pp_burnin._groupmajor_qkv(w, jcfg)))
    np.testing.assert_array_equal(
        tw.packed_qkv(got, tb.ModelConfig.from_reference(jcfg)).numpy(), w)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


@pytest.mark.parametrize("layout,moe", [
    ((0, {"data": 2, "model": 2}), False),
    ((0, {"seq": 2, "model": 2}), True),
    ((2, {"model": 2}), False),
    ((0, {"seq": 4}), False),
], ids=str)
def test_shard_params_round_trip_with_groupmajor_qkv(pool, layout, moe):
    kw = dict(CFG, n_experts=4) if moe else dict(CFG)
    cfg = tb.ModelConfig(**kw, dtype=torch.float32)
    params = R.numpy_tree(tb.init_params(torch.Generator().manual_seed(3), cfg))
    rs = np.random.RandomState(4)
    state = {"mu": [rs.randn(*x.shape).astype(np.float32) for x in _flat(params)],
             "nu": [rs.rand(*x.shape).astype(np.float32) for x in _flat(params)]}
    results = pool.run(R.params_roundtrip, kw, layout, params, state)
    tp = layout[1].get("model", 1)
    gm = pp_burnin._groupmajor_qkv(params["blocks"][0]["qkv"], jb.ModelConfig(**kw))
    ranks, names = pool.run(R.mesh_layout, layout)[0][:2]
    ids = np.asarray(ranks)
    for r, (qkv_block, back, back_state) in enumerate(results):
        model_rank = int(np.nonzero(ids == r)[names.index("model")][0])
        np.testing.assert_array_equal(qkv_block, np.split(np.asarray(gm), tp, axis=1)[model_rank])
        for got, want in zip(_flat(back), _flat(params)):
            np.testing.assert_array_equal(got, want)
        assert back_state["count"] == 3
        for key in ("mu", "nu"):
            for got, want in zip(back_state[key], state[key]):
                np.testing.assert_array_equal(got, want)


def test_probes_report_the_reference_fields(pool):
    jmesh = jax_mesh((0, {"data": 2, "model": 2}))
    want = [jco.psum_bandwidth(jmesh, "model", mib=1, dtype=jnp.float32, iters=2),
            jco.all_gather_bandwidth(jmesh, "model", mib=1, dtype=jnp.float32, iters=2),
            jco.all_to_all_bandwidth(jmesh, "data", mib=1, dtype=jnp.float32, iters=2)]
    factors = {"psum": 2 * (2 - 1) / 2, "all_gather": 1 / 2, "all_to_all": 1 / 2}
    for results, latency, summary in pool.run(R.probe_results, (0, {"data": 2, "model": 2})):
        for got, ref in zip(results, want):
            assert (got.collective, got.axis, got.n_devices, got.payload_bytes) == (
                ref.collective, ref.axis, ref.n_devices, ref.payload_bytes)
            assert got.seconds_per_call > 0
            assert got.algbw_gbps == pytest.approx(
                factors[got.collective] * got.payload_bytes / got.seconds_per_call / 1e9)
        assert latency > 0
        assert summary.keys() == jco.summarize(want).keys()


def test_port_imports_neither_jax_nor_the_reference():
    root = Path(__file__).resolve().parents[1]
    pattern = re.compile(r"^\s*(import|from)\s+(jax|k8s_dra_driver_tpu)\b", re.M)
    files = [*sorted((root / "k8s_dra_driver_torch").rglob("*.py")), root / "chip_smoke.py",
             root / "tests" / "torch_mesh_ranks.py", root / "tests" / "torch_pod_ranks.py"]
    offenders = [str(f.relative_to(root)) for f in files if pattern.search(f.read_text())]
    assert offenders == []


STAND_IN = textwrap.dedent("""\
    import os, sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    with open(os.environ.get("STAND_IN_LOG", os.path.dirname(out) + "/../runs.log"), "a") as f:
        f.write(f"{os.getpid()}\\n")
    with open(out, "wb") as f:
        for _ in range(8):
            f.write(b"x" * 4096)
            f.flush()
            time.sleep(0.05)
    print("ptxas info    : Used 1 registers")
""")


def test_concurrent_builds_compile_once_and_never_load_a_partial_library(pool, tmp_path):
    """Four ranks build one source at once through a stand-in compiler that
    writes its output slowly: one compile, and every rank finds the whole
    file when ``build`` returns."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "stand_in.cu").write_text("// a source\n")
    compiler = tmp_path / "nvcc"
    compiler.write_text(f"#!{sys.executable}\n" + STAND_IN)
    compiler.chmod(0o755)
    sizes = pool.run(R.build_stand_in, str(tmp_path), str(compiler))
    assert sizes == [8 * 4096] * 4
    assert len((tmp_path / "runs.log").read_text().split()) == 1
    assert not list((tmp_path / "build").glob("*.tmp"))
    # this process's own build finds the library and compiles nothing
    old = (_build.CSRC, _build.BUILD_DIR)
    try:
        _build.CSRC, _build.BUILD_DIR = tmp_path / "csrc", tmp_path / "build"
        _build.build(["stand_in"])
    finally:
        _build.CSRC, _build.BUILD_DIR = old
    assert len((tmp_path / "runs.log").read_text().split()) == 1
