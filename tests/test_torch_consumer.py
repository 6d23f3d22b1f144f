"""The port's consumer entry point (``consumer.py``, ``daemon_client.py``)
against the reference's, on the CPU.

* The daemon client and a shared claim's ``register`` and ``lease``,
  against the reference's ``TopologyDaemonServer`` (started in the test as
  ``tests/test_consumer.py`` starts it), the reference's cases; each reply
  equal to the reference client's reply to the same call on the same
  daemon; and every such case again against the port's own daemon
  (``TestPortDaemon``).
* ``main``: ``--check`` on a claim of 2 cards in a process that sees 1
  returns 1 with the reference's message and starts no process group; the
  claim-context line is the reference's ``to_json()`` (apart from the
  port's ``local_rank``).
* The serving demo from the JAX package's weights and adapter: its
  summary equals the JAX demo's in every key but ``backend``, unsharded
  (``jax.local_devices`` patched to one device) and sharded over 2 ranks
  (the JAX demo over 2 of the suite's 8 virtual devices), and the sharded
  streams equal the unsharded ones.  A rank with ``LOCAL_RANK`` 2 or more
  takes no part.  With the port's own seeded weights ``main`` completes 4
  requests with 36 tokens, a prefix hit and free blocks left.
"""

import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from k8s_dra_driver_torch import consumer as tc
from k8s_dra_driver_torch.models import weights
from k8s_dra_driver_torch.parallel.ranks import RankPool
from k8s_dra_driver_torch.plugin.topology_daemon import TopologyDaemonServer as PortDaemonServer
from k8s_dra_driver_tpu import consumer as jc
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import lora as jl
from k8s_dra_driver_tpu.plugin.topology_daemon import TopologyDaemonServer
from tests import torch_pod_ranks as R


def _both(env):
    """(the port's context, the reference's) from the same environment."""
    return (tc.attach(environ=env, init_distributed=False),
            jc.attach(environ=env, init_distributed=False))


def _daemon(server_class, tmp_path):
    server = server_class(
        str(tmp_path / "c.sock"),
        claim_uid="uid-c",
        partition_spec="2,1,1",
        partitions=[
            {"index": 0, "visible_devices": "0", "process_coord": "0,0,0"},
            {"index": 1, "visible_devices": "1", "process_coord": "1,0,0"},
        ],
        quantum_ms=10,
    )
    server.start()
    yield server
    server.stop()


@pytest.fixture
def daemon(tmp_path):
    yield from _daemon(TopologyDaemonServer, tmp_path)


def _env(daemon, strategy, **extra):
    return {"TPU_SHARING_STRATEGY": strategy, "TPU_TOPOLOGY_DAEMON_SOCKET": daemon.socket_path,
            **extra}


class TestDaemon:
    SERVER = TopologyDaemonServer

    def test_spatial_consumer_observes_its_partition(self, daemon):
        port, ref = _both(_env(daemon, "spatial-partition", TPU_PARTITION_INDEX="1"))
        reg = port.register(consumer_id="container-b")
        assert reg["ok"] and reg["partition"]["visible_devices"] == "1"
        assert reg == ref.register(consumer_id="container-b")

    def test_lease_round_trip_and_scoping(self, daemon):
        def run(attach):
            ctx0 = attach(_env(daemon, "time-slicing", TPU_VISIBLE_DEVICES="0",
                               TPU_QUEUE_QUANTUM_MS="1000"))
            ctx1 = attach(_env(daemon, "time-slicing", TPU_VISIBLE_DEVICES="1",
                               TPU_QUEUE_QUANTUM_MS="10"))
            grants = []
            with ctx0.lease(consumer_id="a") as grant:
                grants.append(grant)
                start = time.time()
                with ctx1.lease(consumer_id="b") as g2:  # another chip: no wait
                    grants.append(g2)
                assert time.time() - start < 1.0
            with ctx0.lease(consumer_id="c") as g3:  # released: re-acquired at once
                grants.append(g3)
            return grants

        got = run(lambda env: tc.attach(environ=env, init_distributed=False))
        assert all(g["ok"] for g in got)
        assert [g["scope"] for g in got] == ["0", "1", "0"]
        assert got == run(lambda env: jc.attach(environ=env, init_distributed=False))

    def test_same_scope_contention_waits_for_the_release(self, daemon):
        def run(attach):
            ctx = attach(_env(daemon, "time-slicing", TPU_VISIBLE_DEVICES="0",
                              TPU_QUEUE_QUANTUM_MS="2000"))

            def holder():
                with ctx.lease(consumer_id="holder"):
                    time.sleep(0.3)

            t = threading.Thread(target=holder)
            t.start()
            time.sleep(0.05)
            start = time.time()
            with ctx.lease(consumer_id="waiter", timeout_ms=5000) as g:
                waited = time.time() - start
            t.join()
            return g, waited

        got, waited = run(lambda env: tc.attach(environ=env, init_distributed=False))
        assert got["ok"] and waited > 0.1
        assert got == run(lambda env: jc.attach(environ=env, init_distributed=False))[0]

    def test_an_exclusive_lease_is_a_noop(self):
        port, ref = _both({})
        with port.lease() as grant, ref.lease() as ref_grant:
            assert grant is None and ref_grant is None

    def test_two_containers_of_a_pod_get_distinct_ids(self, tmp_path):
        server = self.SERVER(str(tmp_path / "c.sock"), quantum_ms=1000)
        server.start()
        try:
            env = {"TPU_SHARING_STRATEGY": "time-slicing",
                   "TPU_TOPOLOGY_DAEMON_SOCKET": server.socket_path,
                   "TPU_VISIBLE_DEVICES": "0", "TPU_QUEUE_QUANTUM_MS": "1000"}
            a = tc.attach(environ=env, init_distributed=False)
            b = tc.attach(environ=env, init_distributed=False)
            assert a._consumer_id != b._consumer_id
            with a.lease() as g1:
                assert g1["ok"]
                clients = [b.daemon_client(), jc.attach(environ=env, init_distributed=False)
                           .daemon_client(consumer_id=b._consumer_id)]
                try:
                    replies = [c.acquire(quantum_ms=1000, timeout_ms=50, scope="0")
                               for c in clients]
                finally:
                    for c in clients:
                        c.close()
            assert replies[0] == replies[1] == {"ok": False, "error": "timeout",
                                                "holder": a._consumer_id}
        finally:
            server.stop()

    def test_the_client_waits_for_a_late_daemon(self, tmp_path):
        sock = tmp_path / "late.sock"
        env = {"TPU_SHARING_STRATEGY": "spatial-partition",
               "TPU_TOPOLOGY_DAEMON_SOCKET": str(sock)}
        port, ref = _both(env)
        server = self.SERVER(str(sock), quantum_ms=5)
        t = threading.Timer(0.4, server.start)
        t.start()
        try:
            client = port.daemon_client(retries=20, retry_delay_s=0.1)
            info = client.info()
            client.close()
            ref_client = ref.daemon_client()
            assert info["ok"] and info == ref_client.info()
            ref_client.close()
        finally:
            t.join()
            server.stop()

    def test_an_absent_daemon_fails_with_not_reachable(self, tmp_path):
        env = {"TPU_SHARING_STRATEGY": "spatial-partition",
               "TPU_TOPOLOGY_DAEMON_SOCKET": str(tmp_path / "never.sock")}
        port, ref = _both(env)
        with pytest.raises(ConnectionError, match="not reachable after 2 attempts") as got:
            port.daemon_client(retries=2, retry_delay_s=0.05)
        with pytest.raises(ConnectionError) as want:
            ref.daemon_client(retries=2, retry_delay_s=0.05)
        assert str(got.value) == str(want.value)

    def test_to_json_keeps_the_consumer_id_out(self, daemon):
        """The reference's ``to_json`` after ``register`` carries the cached
        ``_consumer_id`` (ROADMAP queue 3); the port's stays the claim's."""
        env = _env(daemon, "spatial-partition", TPU_PARTITION_INDEX="0", LOCAL_RANK="0")
        port, ref = _both(env)
        before = ref.to_json()
        assert port.to_json() == {**before, "local_rank": 0}
        port.register()
        ref.register()
        assert port.to_json() == {**before, "local_rank": 0}
        assert ref.to_json() == {**before, "_consumer_id": ref._consumer_id}


class TestPortDaemon(TestDaemon):
    """Every case of :class:`TestDaemon` against the port's own daemon
    (``plugin/topology_daemon.py``)."""

    SERVER = PortDaemonServer

    @pytest.fixture
    def daemon(self, tmp_path):
        yield from _daemon(PortDaemonServer, tmp_path)


class TestMain:
    def test_check_refuses_a_claim_of_2_in_a_process_that_sees_1(self, monkeypatch, capsys):
        monkeypatch.setenv("TPU_VISIBLE_DEVICES", "0,1")
        monkeypatch.delenv("LOCAL_RANK", raising=False)

        def no_group(*a, **kw):
            raise AssertionError("--check started a process group")

        monkeypatch.setattr(torch.distributed, "init_process_group", no_group)
        assert tc.main(["--check", "--serve-demo", "--device", "cpu"]) == 1
        out, err = capsys.readouterr()
        assert "DEVICE MISMATCH: claim wired 2 chips, torch sees 1 locally" in err
        lines = [json.loads(line) for line in out.splitlines()]
        assert lines[0] == {"claim_context": jc.attach(init_distributed=False).to_json()}
        assert lines[1] == {"torch_local_devices": ["cpu"], "world_size": 2}
        assert not torch.distributed.is_initialized()

    def test_check_passes_on_a_matching_claim(self, monkeypatch, capsys):
        monkeypatch.setenv("TPU_VISIBLE_DEVICES", "3")
        monkeypatch.setenv("LOCAL_RANK", "0")
        assert tc.main(["--check", "--device", "cpu"]) == 0
        lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
        assert lines == [
            {"claim_context": {**jc.attach(init_distributed=False).to_json(), "local_rank": 0}},
            {"torch_local_devices": ["cpu"], "world_size": 1},
        ]

    def test_a_shared_claim_registers_as_the_reference_does(self, daemon, monkeypatch, capsys):
        for k, v in _env(daemon, "spatial-partition", TPU_PARTITION_INDEX="1").items():
            monkeypatch.setenv(k, v)
        assert tc.main(["--device", "cpu"]) == 0
        port = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
        monkeypatch.setattr(jax, "local_devices", lambda *a, **kw: jax.devices("cpu")[:1])
        assert jc.main([]) == 0
        ref = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
        assert port[:2] == ref[:2] and "daemon" in port[1]

    def test_the_default_device_is_the_card(self):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tc.main(["--check"])

    def test_the_demo_with_the_port_s_own_weights(self, monkeypatch, capsys):
        monkeypatch.delenv("TPU_VISIBLE_DEVICES", raising=False)
        assert tc.main(["--serve-demo", "--device", "cpu"]) == 0
        lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
        summary = next(d["serve_demo"] for d in lines if "serve_demo" in d)
        assert summary["completed"] == 4
        assert summary["generated_tokens"] == 12 + 10 + 8 + 6
        assert summary["prefix_block_hits"] > 0
        assert summary["pool_free_blocks"] > 0
        assert summary["sharded_over"] == 0 and summary["backend"] == "cpu"
        assert not torch.distributed.is_initialized()


# -- the demo against the JAX package's -------------------------------------------


@pytest.fixture(scope="module")
def carried():
    """The reference demo's weights and adapter bank, as numpy."""
    cfg = jb.ModelConfig(**tc.DEMO_CFG)
    params = jb.init_params(jax.random.PRNGKey(0), cfg)
    lcfg = jl.LoraConfig(rank=4)
    bank = jl.stack_adapters(cfg, lcfg, [jl.init_adapters(jax.random.PRNGKey(7), cfg, lcfg)])
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, bank["blocks"]),
            float(bank["scale"]))


def _jax_demo(capsys, monkeypatch=None, one_device=False):
    """The reference's ``--serve-demo`` summary, run as
    ``tests/test_consumer.py`` runs it (sharded over 2 of the suite's
    virtual devices), or on one device."""
    if one_device:
        real = jax.local_devices
        monkeypatch.setattr(jax, "local_devices", lambda *a, **kw: real(*a, **kw)[:1])
    capsys.readouterr()
    assert jc.main(["--serve-demo"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    return next(d["serve_demo"] for d in lines if "serve_demo" in d)


def _unbackended(summary):
    return {k: v for k, v in summary.items() if k != "backend"}


@pytest.fixture(scope="module")
def unsharded(carried):
    params, bank_blocks, scale = carried
    bank = {"blocks": weights.params_from_jax(bank_blocks, "cpu"), "scale": scale}
    return tc.serve_demo("cpu", params=weights.params_from_jax(params, "cpu"), bank=bank)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, backend="gloo", device_type="cpu", timeout_s=120)
    yield p
    p.close()


def test_the_demo_unsharded_equals_the_jax_demo(unsharded, capsys, monkeypatch):
    monkeypatch.delenv("TPU_VISIBLE_DEVICES", raising=False)
    summary, streams = unsharded
    want = _jax_demo(capsys, monkeypatch, one_device=True)
    assert want["sharded_over"] == 0
    assert _unbackended(summary) == _unbackended(want)
    assert sorted(streams) == [0, 1, 2, 3]


def test_the_demo_sharded_over_2_ranks(pool, carried, unsharded, capsys, monkeypatch):
    """Ranks 0 and 1 of a 4-rank world serve over ``MeshShape(data=2)``;
    ranks 2 and 3 build the mesh's groups with them and take no part."""
    monkeypatch.delenv("TPU_VISIBLE_DEVICES", raising=False)
    results = pool.run(R.demo_on_mesh, *carried)
    assert results[2] is None and results[3] is None
    (summary, streams), other = results[0], results[1]
    assert other == (summary, streams)
    want = _jax_demo(capsys)
    assert summary["sharded_over"] == want["sharded_over"] == 2
    assert _unbackended(summary) == _unbackended(want)
    assert streams == unsharded[1]


def test_a_rank_past_local_rank_1_takes_no_part(pool):
    results = pool.run(R.claim_demo, "0,1,2,3")
    assert results[0] == results[1] and results[0]["sharded_over"] == 2
    assert results[2] is None and results[3] is None
    assert results[0]["completed"] == 4 and results[0]["generated_tokens"] == 36
