"""The port's node driver (``k8s_dra_driver_torch/plugin/``, ``api/``)
against the reference's, on the CPU.

Each case builds both drivers on the same fake topology, each over its own
in-memory API server (``tests/torch_node_rig.py``), hands both the same
allocated claim and compares, after NodePrepareResources and again after
NodeUnprepareResources: the per-claim results and errors, the CDI spec
files byte for byte (the claim's environment is in them), the checkpoint
byte for byte, and the topology-daemon Deployments (the port's command is
its own module).  Also: the opaque-config decoder, orphan cleanup, the
self-test sweep's health overlay from stub reports (the reference's
platform "tpu", the port's "gpu"), a real-mode topology's CDI spec, and
the port's consumer on the environment and daemons the reference's
prepare produces (the neighbour check).
"""

import json
import threading
import time

import pytest

from k8s_dra_driver_torch import consumer as port_consumer
from k8s_dra_driver_torch.api import decoder as port_decoder
from k8s_dra_driver_torch.kube import serde as port_serde
from k8s_dra_driver_torch.plugin import device_state as port_device_state
from k8s_dra_driver_torch.tpuinfo import binding as port_binding
from k8s_dra_driver_torch.tpuinfo import selftest as port_selftest
from k8s_dra_driver_tpu import consumer as ref_consumer
from k8s_dra_driver_tpu.api import decoder as ref_decoder
from k8s_dra_driver_tpu.kube import serde as ref_serde
from k8s_dra_driver_tpu.plugin.topology_daemon import TopologyDaemonServer
from k8s_dra_driver_tpu.tpuinfo import selftest as ref_selftest
from tests.torch_node_rig import (
    CONFIG_API,
    DOMAIN_POOL,
    GROUP_POOL,
    NODE,
    claim_doc,
    claim_ref,
    make_pair,
    result_dicts,
    tpu_config,
)

V5E = {"TPUINFO_FAKE_TOPOLOGY": "v5e-16", "TPUINFO_FAKE_HOST_ID": "0"}


def _deployments(side) -> list[dict]:
    out = []
    for dep in side.server.list("Deployment"):
        doc = side.objects.to_json(dep)
        doc["metadata"].pop("uid", None)
        for c in doc["spec"]["template"]["spec"]["containers"]:
            c.pop("command")  # each package runs its own daemon program
        out.append(doc)
    return sorted(out, key=lambda d: d["metadata"]["name"])


def _state(side) -> dict:
    return {"cdi": side.cdi_files(), "checkpoint": side.checkpoint_bytes(),
            "daemons": _deployments(side)}


def _roundtrip(pair, docs):
    """Prepare ``docs`` in one call, then unprepare them in one call, on
    both sides; every observation equal between the two."""
    ref, port = pair
    for side in pair:
        for doc in docs:
            side.create(doc)
    got = {}
    for side in pair:
        refs = [claim_ref(side, d) for d in docs]
        prepared = result_dicts(side.driver.node_prepare_resources(refs))
        after_prepare = _state(side)
        again = result_dicts(side.driver.node_prepare_resources(refs))  # idempotent
        unprepared = result_dicts(side.driver.node_unprepare_resources(refs))
        got[side.name] = (prepared, after_prepare, again, unprepared, _state(side))
    for a, b in zip(got["reference"], got["port"]):
        assert a == b
    return got["port"]


def _params(kind, **body):
    return {"apiVersion": CONFIG_API, "kind": kind, **body}


# (name, topology env, [(request, pool, device)], [(requests, parameters)])
CASES = {
    "chip": (V5E, [("t", NODE, "tpu-1")], []),
    "two chips exclusive": (V5E, [("t", NODE, "tpu-0"), ("t", NODE, "tpu-3")],
                            [((), tpu_config("Exclusive"))]),
    "subslice": (V5E, [("s", NODE, "tpu-slice-2x2-0-0")], []),
    "subslice v4 host 1": ({"TPUINFO_FAKE_TOPOLOGY": "v4-16", "TPUINFO_FAKE_HOST_ID": "1"},
                           [("s", NODE, "tpu-slice-2x1x1-0-1-1")], []),
    "membership seat": (V5E, [("m", DOMAIN_POOL, "membership-2")],
                        [((), _params("SliceMembershipConfig", coordinatorPort=9000,
                                      megascale=True, extraEnv={"FOO_BAR": "1"}))]),
    "slice-group seat": (V5E, [("t", NODE, "tpu-0"), ("m", DOMAIN_POOL, "membership-1"),
                               ("g", GROUP_POOL, "groupseat-1-1")],
                         [(("g",), _params("SliceGroupConfig", megascalePort=9100))]),
    "time slicing": (V5E, [("t", NODE, "tpu-0"), ("t", NODE, "tpu-1")],
                     [((), tpu_config("TimeSlicing", timeSlicingConfig={"interval": "Long"}))]),
    "time slicing subslice": (V5E, [("s", NODE, "tpu-slice-2x1-0-1")],
                              [((), _params("SubsliceConfig",
                                            sharing={"strategy": "TimeSlicing"}))]),
    "spatial partition": (V5E, [("t", NODE, f"tpu-{i}") for i in range(4)],
                          [((), tpu_config("SpatialPartition", spatialPartitionConfig={
                              "defaultCoreFraction": 50, "defaultHbmLimit": "4Gi",
                              "perDeviceHbmLimit": {"0": "2Gi"}}))]),
    "spatial partition gappy": (V5E, [("t", NODE, "tpu-0"), ("t", NODE, "tpu-3")],
                                [((), tpu_config("SpatialPartition"))]),
    "per-request configs": (V5E, [("a", NODE, "tpu-0"), ("b", NODE, "tpu-1")],
                            [((), tpu_config("TimeSlicing")),
                             (("b",), tpu_config("Exclusive"))]),
    "unknown field": (V5E, [("t", NODE, "tpu-0")],
                      [((), _params("TpuConfig", sharing={"strategy": "Exclusive"}, bogus=1))]),
    "wrong api version": (V5E, [("t", NODE, "tpu-0")],
                          [((), {"apiVersion": "v9", "kind": "TpuConfig"})]),
    "spatial partition of a subslice": (V5E, [("s", NODE, "tpu-slice-2x2-0-0")],
                                        [((), _params("SubsliceConfig", sharing={
                                            "strategy": "SpatialPartition"}))]),
    "config kind mismatch": (V5E, [("s", NODE, "tpu-slice-2x2-0-0")],
                             [((), tpu_config("Exclusive"))]),
    "bad hbm limit": (V5E, [("t", NODE, "tpu-0")],
                      [((), tpu_config("SpatialPartition", spatialPartitionConfig={
                          "perDeviceHbmLimit": {"7": "1Gi"}}))]),
    "device not on this node": (V5E, [("t", NODE, "tpu-9")], []),
    "unhealthy chip": ({**V5E, "TPUINFO_FAKE_DEAD_CHIPS": "1"}, [("t", NODE, "tpu-1")], []),
    "unhealthy chip in a subslice": ({**V5E, "TPUINFO_FAKE_DEAD_CHIPS": "3"},
                                     [("s", NODE, "tpu-slice-2x2-0-0")], []),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prepare_and_unprepare_equal_the_reference(case, tmp_path):
    env, results, config = CASES[case]
    pair = make_pair(tmp_path, env, seats=True)
    doc = claim_doc("claim-a", "uid-a", results, config)
    prepared, after, _, unprepared, final = _roundtrip(pair, [doc])
    errors = [r["error"] for r in prepared.values() if r["error"]]
    if case in ("unknown field", "wrong api version", "spatial partition of a subslice",
                "config kind mismatch", "bad hbm limit", "device not on this node",
                "unhealthy chip", "unhealthy chip in a subslice"):
        assert errors and not any(n.startswith("k8s.tpu.google.com-claim") for n in after["cdi"])
    else:
        assert not errors and any(n.startswith("k8s.tpu.google.com-claim") for n in after["cdi"])
    assert not any(n.startswith("k8s.tpu.google.com-claim") for n in final["cdi"])
    assert final["daemons"] == []


def test_a_batch_of_claims_and_a_failure_among_them(tmp_path):
    pair = make_pair(tmp_path, V5E, seats=True)
    docs = [claim_doc(f"claim-{k}", f"uid-{k}", results, config)
            for k, (case, (_, results, config)) in enumerate(CASES.items())
            if case in ("chip", "subslice", "time slicing subslice", "unknown field",
                        "membership seat")]
    prepared = _roundtrip(pair, docs)[0]
    assert sum(1 for r in prepared.values() if r["error"]) == 1


def test_checkpoint_restores_into_a_new_driver(tmp_path):
    from tests.torch_node_rig import make_side

    pair = make_pair(tmp_path, V5E)
    doc = claim_doc("claim-a", "uid-a", [("t", NODE, "tpu-2")])
    for side in pair:
        side.create(doc)
        side.driver.node_prepare_resources([claim_ref(side, doc)])
    for side in pair:
        again = make_side(side.name, tmp_path, V5E)  # the same files
        assert list(again.driver.state.prepared) == ["uid-a"]
        assert again.driver.state.prepared["uid-a"].to_json() == \
            pair[1].driver.state.prepared["uid-a"].to_json()
    assert pair[0].checkpoint_bytes() == pair[1].checkpoint_bytes()


DECODER_DOCS = [
    tpu_config("Exclusive"),
    tpu_config("TimeSlicing", timeSlicingConfig={"interval": "Short"}),
    tpu_config("TimeSlicing", timeSlicingConfig={"interval": "Sometimes"}),
    tpu_config("SpatialPartition", spatialPartitionConfig={"perDeviceHbmLimit": {"*": "1Gi"}}),
    _params("SubsliceConfig", sharing={"strategy": "TimeSlicing"}),
    _params("SliceMembershipConfig", coordinatorPort="80"),
    _params("SliceMembershipConfig", coordinatorPort=True),
    _params("SliceGroupConfig", megascalePort=8081, extraEnv={"A_B": "1"}),
    _params("Nope"),
    {"kind": "TpuConfig"},
    [1, 2],
]


@pytest.mark.parametrize("i", range(len(DECODER_DOCS)))
def test_the_decoder_equals_the_reference(i):
    doc = DECODER_DOCS[i]

    def decode(decoder, serde):
        try:
            cfg = decoder.Decoder().decode(json.loads(json.dumps(doc)))
        except Exception as exc:  # noqa: BLE001 - the error is the result
            return ("error", type(exc).__name__, str(exc))
        out = [type(cfg).__name__, serde.to_json(cfg)]
        try:
            cfg.normalize()
            cfg.validate()
            out.append(serde.to_json(cfg))
        except Exception as exc:  # noqa: BLE001
            out.append(("invalid", type(exc).__name__, str(exc)))
        return out

    assert decode(port_decoder, port_serde) == decode(ref_decoder, ref_serde)


def test_orphan_cleanup_equals_the_reference(tmp_path):
    pair = make_pair(tmp_path, V5E)
    docs = [claim_doc("gone", "uid-gone", [("t", NODE, "tpu-0")],
                      [((), tpu_config("SpatialPartition"))]),
            claim_doc("kept", "uid-kept", [("t", NODE, "tpu-1")]),
            claim_doc("reused", "uid-old", [("t", NODE, "tpu-2")])]
    got = {}
    for side in pair:
        for doc in docs:
            side.create(doc)
        side.driver.node_prepare_resources([claim_ref(side, d) for d in docs])
        side.server.delete("ResourceClaim", "gone", "default")
        side.server.delete("ResourceClaim", "reused", "default")
        side.create(claim_doc("reused", "uid-new", [("t", NODE, "tpu-2")]))
        (side.root / "cdi" / "k8s.tpu.google.com-claim-uid-stray.json").write_text("{}")
        stray = side.objects.from_json({
            "apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": "tpu-topology-daemon-stray", "namespace": "tpu-dra-driver",
                         "labels": {"app.kubernetes.io/name": "tpu-topology-daemon",
                                    "tpu.google.com/node": NODE,
                                    "resourceclaim.tpu.google.com/uid": "uid-stray"}}})
        side.server.create(stray)
        cleaned = side.driver.cleanup_orphans()
        got[side.name] = (cleaned, _state(side))
    assert got["port"] == got["reference"]
    cleaned = got["port"][0]
    assert sorted(cleaned["claims"]) == ["uid-gone", "uid-old"]
    assert cleaned["cdi_specs"] == ["uid-stray"]
    assert len(cleaned["daemons"]) == 1


# -- the self-test sweep's health overlay ----------------------------------

class _FakeRun:
    def __init__(self, report):
        self._report = report

    def cancel(self):
        pass

    def result(self):
        return self._report


def _report(platform, oks, error=None):
    if error:
        return {"ok": False, "platform": None, "devices": [], "error": error}
    return {"ok": all(oks), "platform": platform,
            "devices": [{"id": i, "platform": platform, "ok": ok} for i, ok in enumerate(oks)]}


OVERLAY_CASES = {
    "all pass": (lambda p: _report(p, [True] * 4), False),
    "one failed": (lambda p: _report(p, [True, False, True, True]), False),
    "count mismatch": (lambda p: _report(p, [True] * 3), False),
    "error idle": (lambda p: _report(p, [], error="selftest timed out after 30s"), False),
    "error while busy": (lambda p: _report(p, [], error="backend init failed"), True),
    "a CPU probe": (lambda p: _report("cpu", [False]), False),
}


def _chip_health(side) -> dict:
    out = {}
    for doc in side.slices():
        for dev in doc["spec"]["devices"]:
            attrs = dev["basic"]["attributes"]
            if attrs["type"]["string"] == "tpu":
                out[dev["name"]] = (attrs["healthy"]["bool"],
                                    attrs.get("healthReason", {}).get("string", ""))
    return out


@pytest.mark.parametrize("case", list(OVERLAY_CASES))
def test_selftest_overlay_equals_the_reference(case, tmp_path, monkeypatch):
    make, busy = OVERLAY_CASES[case]
    pair = make_pair(tmp_path, V5E, selftest_interval_s=0.0001)
    calls = {}
    for side, module, platform in ((pair[0], ref_selftest, "tpu"),
                                   (pair[1], port_selftest, "gpu")):
        report = make(platform)

        def start(timeout_s, report=report, name=side.name):
            calls[name] = calls.get(name, 0) + 1
            return _FakeRun(report)

        monkeypatch.setattr(module, "start_selftest", start)
    got = {}
    for side in pair:
        if busy:
            # a claim prepared while the probe ran: its report is folded
            # with the node busy
            side.driver._last_selftest = time.monotonic()
            doc = claim_doc("busy", "uid-busy", [("t", NODE, "tpu-0")])
            side.create(doc)
            side.driver.node_prepare_resources([claim_ref(side, doc)])
            side.driver._selftest_report = make("tpu" if side.name == "reference" else "gpu")
        changed = side.driver.refresh_inventory()
        health = _chip_health(side)
        doc = claim_doc("after", "uid-after", [("t", NODE, "tpu-1")])
        side.create(doc)
        prepared = result_dicts(side.driver.node_prepare_resources([claim_ref(side, doc)]))
        got[side.name] = (changed, health, bool(prepared["uid-after"]["error"]))
    assert got["port"] == got["reference"]
    assert calls.get("port", 0) == calls.get("reference", 0)
    changed, health, refused = got["port"]
    fenced = {n for n, (ok, _) in health.items() if not ok}
    want = {"all pass": set(), "one failed": {"tpu-1"}, "count mismatch": set(health),
            "error idle": set(health), "error while busy": set(), "a CPU probe": set()}[case]
    assert fenced == want and refused == ("tpu-1" in fenced)
    assert all(reason == "selftest-failed" for n, (_, reason) in health.items() if n in fenced)


def test_a_cleared_overlay_restores_the_card(tmp_path, monkeypatch):
    pair = make_pair(tmp_path, V5E, selftest_interval_s=0.0001)
    got = {}
    for side, module, platform in ((pair[0], ref_selftest, "tpu"),
                                   (pair[1], port_selftest, "gpu")):
        reports = [_report(platform, [False, True, True, True]), _report(platform, [True] * 4)]
        monkeypatch.setattr(module, "start_selftest", lambda timeout_s, r=reports: _FakeRun(r.pop(0)))
        steps = []
        for _ in range(2):
            side.driver._last_selftest = 0.0
            steps.append((side.driver.refresh_inventory(), _chip_health(side)["tpu-0"]))
        got[side.name] = steps
    assert got["port"] == got["reference"] == [(True, (False, "selftest-failed")),
                                               (True, (True, ""))]


# -- a real-mode topology (the host's NVIDIA cards) ------------------------

def _cards(n: int) -> port_binding.TopologyInfo:
    chips = tuple(port_binding.ChipInfo(
        index=minor, device_path=f"/dev/nvidia{minor}", uuid=f"GPU-0000000{i}-aaaa-bbbb-cccc-dddd",
        coords=(i, 0, 0), hbm_bytes=85 << 30, cores=132, pci_address=f"0000:{0x18 + i:02x}:00.0")
        for i, minor in enumerate((0, 3)[:n]))
    return port_binding.TopologyInfo(
        mode="real", generation="nvidia-h100-80gb-hbm3", topology=f"{n}x1", ndims=2,
        dims=(n, 1, 1), wrap=(False, False, False), host_bounds=(n, 1, 1), chips_per_host=n,
        host_count=1, host_id=0, worker_hostnames=(), driver_version="cuda-12.4",
        libtpu_version="unknown", chips=chips)


def test_real_mode_spec_names_the_card_and_control_nodes(tmp_path, monkeypatch):
    present = tmp_path / "nvidiactl"
    present.write_text("")
    monkeypatch.setattr(port_device_state, "enumerate_topology", lambda env=None: _cards(2))
    monkeypatch.setattr(port_device_state, "CUDA_CONTROL_NODES",
                        (str(present), str(tmp_path / "nvidia-uvm")))
    from tests.torch_node_rig import make_side

    side = make_side("port", tmp_path, {})
    names = [d.name for d in side.driver.state.allocatable]
    assert names == ["tpu-0", "tpu-3", "tpu-slice-2x1-0-0"]  # 2 cards: a 2x1 subslice
    base = json.loads(side.cdi_files()["k8s.tpu.google.com-base.json"])
    nodes = {d["name"]: [n["path"] for n in d["containerEdits"]["deviceNodes"]]
             for d in base["devices"]}
    assert nodes == {"tpu-0": ["/dev/nvidia0", str(present)],
                     "tpu-3": ["/dev/nvidia3", str(present)],
                     "tpu-slice-2x1-0-0": ["/dev/nvidia0", "/dev/nvidia3", str(present)]}
    assert "mounts" not in base["containerEdits"]  # no libtpu on a GPU node
    attrs = side.slices()[0]["spec"]["devices"][1]["basic"]["attributes"]
    assert attrs["productName"]["string"] == "nvidia-h100-80gb-hbm3"
    assert attrs["driverVersion"]["version"] == "12.4.0"
    assert attrs["cores"]["int"] == 132 and attrs["index"]["int"] == 3
    doc = claim_doc("c", "uid-c", [("t", NODE, "tpu-3")])
    side.create(doc)
    side.driver.node_prepare_resources([claim_ref(side, doc)])
    spec = json.loads(side.cdi_files()["k8s.tpu.google.com-claim-uid-c.json"])
    assert spec["devices"][0]["containerEdits"]["env"] == ["TPU_VISIBLE_DEVICES=3"]


# -- the neighbour check: the port's consumer on the reference's prepare ----

def _claim_env(side, uid: str) -> list[dict]:
    """Each device's environment in the claim's CDI spec."""
    spec = json.loads(side.cdi_files()[f"k8s.tpu.google.com-claim-{uid}.json"])
    return [dict(e.split("=", 1) for e in d["containerEdits"].get("env", []))
            for d in spec["devices"]]


def _attach_both(env):
    return (port_consumer.attach(environ=env, init_distributed=False),
            ref_consumer.attach(environ=env, init_distributed=False))


@pytest.mark.parametrize("case", ["chip", "subslice", "membership seat", "slice-group seat",
                                  "spatial partition"])
def test_the_port_consumer_reads_the_reference_prepare(case, tmp_path):
    env, results, config = CASES[case]
    ref, _ = make_pair(tmp_path, env, seats=True)
    doc = claim_doc("claim-a", "uid-a", results, config)
    ref.create(doc)
    assert not ref.driver.node_prepare_resources([claim_ref(ref, doc)])["uid-a"].error
    for env in _claim_env(ref, "uid-a"):
        port, want = _attach_both(env)
        got = port.to_json()
        assert got == want.to_json()
        assert port.world_size == (port.host_count or 1) * (port.num_slices or 1) * \
            max(len(port.visible_devices), 1)


def test_the_port_consumer_against_the_reference_spatial_daemon(tmp_path):
    env, results, config = CASES["spatial partition"]
    ref, _ = make_pair(tmp_path, env, socket_dir=str(tmp_path / "s"))
    doc = claim_doc("claim-a", "uid-a", results, config)
    ref.create(doc)
    ref.driver.node_prepare_resources([claim_ref(ref, doc)])
    (dep,) = ref.server.list("Deployment")
    container = dep.spec["template"]["spec"]["containers"][0]
    daemon_env = {e["name"]: e["value"] for e in container["env"]}
    socket = str(tmp_path / "s" / "uid-a.sock")
    server = TopologyDaemonServer.from_env(socket, "uid-a", environ=daemon_env)
    server.start()
    try:
        for k, env in enumerate(_claim_env(ref, "uid-a")):
            port, want = _attach_both(env)
            assert port.daemon_socket == socket
            got = port.register(consumer_id=f"c{k}")
            assert got == want.register(consumer_id=f"c{k}")
            assert got["ok"] and got["partition"]["index"] == port.partition_index == k
    finally:
        server.stop()


def test_a_long_time_sliced_block_keeps_the_lease(tmp_path):
    """The reference's consumer holds the lease without renewing it, so a
    block longer than 4 quanta loses the card to a waiter (ROADMAP queue
    3); the port's renews it once a quantum: two consumers' 600 ms blocks
    at a 50 ms quantum (reclaimed after 200 ms) never overlap, on the
    reference's host daemon."""
    env, results, config = CASES["time slicing"]
    ref, _ = make_pair(tmp_path, env, socket_dir=str(tmp_path / "s"))
    doc = claim_doc("claim-a", "uid-a", results, config)
    ref.create(doc)
    ref.driver.node_prepare_resources([claim_ref(ref, doc)])
    claim_env = _claim_env(ref, "uid-a")[0]
    server = TopologyDaemonServer(claim_env["TPU_TOPOLOGY_DAEMON_SOCKET"], quantum_ms=50)
    server.start()
    spans = []
    try:
        ctx = port_consumer.attach(environ={**claim_env, "TPU_QUEUE_QUANTUM_MS": "50"},
                                   init_distributed=False)
        assert ctx.sharing_strategy == "time-slicing" and ctx.queue_quantum_ms == 50

        def hold(name):
            with ctx.lease(consumer_id=name, timeout_ms=5000) as grant:
                t0 = time.monotonic()
                time.sleep(0.6)
                spans.append((t0, time.monotonic(), grant["scope"]))

        threads = [threading.Thread(target=hold, args=(n,)) for n in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        server.stop()
    (a0, a1, scope), (b0, b1, _) = sorted(spans)
    assert scope == claim_env["TPU_VISIBLE_DEVICES"] and a1 <= b0
