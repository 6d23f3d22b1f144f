"""The port's topology daemon (``k8s_dra_driver_torch/plugin/topology_daemon.py``)
against the reference's, on the CPU: the same request sequences, sent as
raw lines over each daemon's unix socket, get the same replies, with leases
short enough (a 5 ms quantum, reclaimed after 4 quanta) to expire within
the test; ``from_env`` reads the same state; the program runs in host mode
and per claim from the Deployment the port's ``SpatialPartitionManager``
writes, as a process of its own, and refuses a command line naming neither
mode or both."""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from k8s_dra_driver_torch.daemon_client import TopologyDaemonClient
from k8s_dra_driver_torch.plugin import sharing as port_sharing
from k8s_dra_driver_torch.plugin import topology_daemon as port_daemon
from k8s_dra_driver_torch.utils.retry import Backoff, RetryPolicy
from k8s_dra_driver_tpu.plugin import topology_daemon as ref_daemon

REPO = Path(__file__).resolve().parent.parent
PARTITIONS = [{"index": 0, "device": "tpu-0", "visible_devices": "0", "process_coord": "0,0,0"},
              {"index": 1, "device": "tpu-1", "visible_devices": "1", "process_coord": "1,0,0"}]
DAEMON_ENV = {
    "TPU_PARTITION_SPEC": "2,1,1",
    "TPU_PARTITIONS": json.dumps(PARTITIONS),
    "TPU_HBM_LIMITS": "uuid-0=2048Mi,uuid-1=4096Mi",
    "TPU_QUEUE_QUANTUM_MS": "5",
    "TPU_HANDOFF_CHANNELS": json.dumps([{"name": "ici-0", "bandwidth_gbps": 100.0}]),
    "TPU_POWER_TABLE": json.dumps({"1": 310}),
}


class Wire:
    """One raw connection: a line out, a line back."""

    def __init__(self, path):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(path)
        self.rfile = self.sock.makefile("rb")

    def send(self, line: str) -> dict:
        self.sock.sendall(line.encode() + b"\n")
        return json.loads(self.rfile.readline())

    def __call__(self, **req) -> dict:
        return self.send(json.dumps(req))

    def close(self):
        self.rfile.close()
        self.sock.close()


def _serve(module, path, uid="uid-a"):
    server = module.TopologyDaemonServer.from_env(str(path), uid, environ=DAEMON_ENV)
    server.start()
    return server


def _claim_sequence(wire) -> list:
    out = [wire(op="info"), wire(op="register"), wire(op="register", consumer="c0", partition=0),
           wire(op="register", consumer="c1", partition=5),
           wire(op="register", consumer="c2"), wire(op="info"), wire(op="frobnicate"),
           wire.send("{not json"), wire.send("[1, 2]"), wire(op="acquire"),
           wire(op="release", consumer="nobody")]
    return out


def _lease_sequence(wire, other) -> list:
    out = [wire(op="acquire", consumer="a", scope="0"),
           other(op="acquire", consumer="b", scope="0", timeout_ms=1),
           other(op="acquire", consumer="b", scope="1", timeout_ms=1),
           wire(op="acquire", consumer="a", scope="0", quantum_ms=5),  # the holder renews
           wire(op="info"),
           other(op="release", consumer="b", scope="0")]
    time.sleep(0.05)  # past 4 quanta: a's lease on "0" is reclaimable
    out += [other(op="acquire", consumer="b", scope="0", timeout_ms=1, quantum_ms=1000),
            wire(op="release", consumer="a", scope="0")]
    # a waiter blocks until the holder releases
    got = {}

    def waiter():
        got["c"] = wire(op="acquire", consumer="c", scope="0", timeout_ms=3000)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    out.append(other(op="release", consumer="b", scope="0"))
    t.join()
    out += [got["c"], wire(op="release", consumer="c", scope="0"), wire(op="info")]
    out.append(wire(op="acquire", consumer="d", timeout_ms=1))  # no scope: "*"
    return out


@pytest.mark.parametrize("sequence", ["claim", "leases"])
def test_replies_equal_the_reference(sequence, tmp_path):
    got = {}
    for name, module in (("reference", ref_daemon), ("port", port_daemon)):
        server = _serve(module, tmp_path / f"{name}.sock")
        wire, other = Wire(server.socket_path), Wire(server.socket_path)
        try:
            got[name] = (_claim_sequence(wire) if sequence == "claim"
                         else _lease_sequence(wire, other))
        finally:
            wire.close()
            other.close()
            server.stop()
    assert got["port"] == got["reference"]
    if sequence == "leases":
        replies = got["port"]
        assert replies[1] == {"ok": False, "error": "timeout", "holder": "a"}
        assert replies[6]["ok"] and replies[9]["ok"]


def test_from_env_reads_the_reference_state(tmp_path):
    states = [dataclasses.asdict(module.TopologyDaemonServer.from_env(
        str(tmp_path / "x.sock"), "uid-a", environ=DAEMON_ENV).state)
        for module in (ref_daemon, port_daemon)]
    assert states[0] == states[1]
    assert states[1]["quantum_ms"] == 5 and states[1]["channel"]["name"] == "ici-0"
    assert port_daemon.host_socket_path("/d") == ref_daemon.host_socket_path("/d")
    assert port_daemon.claim_socket_path("/d", "u") == ref_daemon.claim_socket_path("/d", "u")


def test_the_client_speaks_to_both_daemons(tmp_path):
    for name, module in (("reference", ref_daemon), ("port", port_daemon)):
        server = _serve(module, tmp_path / f"{name}.sock")
        try:
            client = TopologyDaemonClient.from_env(
                "c0", environ={"TPU_TOPOLOGY_DAEMON_SOCKET": server.socket_path})
            reg = client.register(partition=1)
            assert reg["ok"] and reg["partition"]["device"] == "tpu-1"
            assert client.acquire(scope="0,1")["scope"] == "0,1"
            assert client.release(scope="0,1") == {"ok": True}
            client.close()
        finally:
            server.stop()
    with pytest.raises(RuntimeError, match="TPU_TOPOLOGY_DAEMON_SOCKET"):
        TopologyDaemonClient.from_env("c0", environ={})


def _spawn(args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env_extra or {}))
    return subprocess.Popen([sys.executable, "-m", "k8s_dra_driver_torch.plugin.topology_daemon",
                             *args], env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _dial(path, timeout=20.0) -> TopologyDaemonClient:
    backoff = Backoff(RetryPolicy(max_attempts=0, base_delay_s=0.02, max_delay_s=0.2,
                                  jitter=0.0))
    deadline = time.time() + timeout
    while True:
        try:
            return TopologyDaemonClient(str(path), "probe")
        except OSError:
            if time.time() > deadline:
                raise
            backoff.sleep()


def test_the_program_in_host_mode(tmp_path):
    proc = _spawn(["--host-mode", "--socket-dir", str(tmp_path)])
    try:
        assert proc.stdout.readline().startswith("tpu-topology-daemon: serving host on")
        client = _dial(tmp_path / "host.sock")
        assert client.acquire(scope="0")["lease_ms"] == 5
        assert client.info()["lease_holders"] == {"0": "probe"}
        client.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_the_program_runs_the_deployment_the_port_writes(tmp_path):
    doc = port_sharing.daemon_deployment(
        name="d", namespace="ns", claim_uid="uid-z", node_name="host-0", image="img",
        socket_dir=str(tmp_path), partition_spec="2,1,1", partitions=json.dumps(PARTITIONS),
        hbm_limits="uuid-0=2048Mi")
    (container,) = doc["spec"]["template"]["spec"]["containers"]
    assert container["command"][1:] == ["-m", "k8s_dra_driver_torch.plugin.topology_daemon"]
    env = {e["name"]: e["value"] for e in container["env"]}
    proc = _spawn(container["args"], env)
    try:
        client = _dial(tmp_path / "uid-z.sock")
        info = client.info()
        assert info["claim_uid"] == "uid-z" and info["partitions"] == PARTITIONS
        assert info["hbm_limits"] == {"uuid-0": "2048Mi"}
        client.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


@pytest.mark.parametrize("args", [[], ["--host-mode", "--claim-uid", "u"]])
def test_the_program_needs_exactly_one_mode(args, tmp_path):
    proc = _spawn([*args, "--socket-dir", str(tmp_path)])
    _, err = proc.communicate(timeout=30)
    assert proc.returncode == 2
    assert "exactly one of --claim-uid or --host-mode is required" in err
