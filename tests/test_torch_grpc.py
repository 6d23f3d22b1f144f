"""The port's kubelet face (``k8s_dra_driver_torch/plugin/grpc_service.py``
and its committed ``plugin/proto/gen`` stubs) against the reference's, on
the CPU, over real unix sockets.

Each package serves its own ``Driver`` (a fake v5e-16 host of its own
``make_cluster``; each claim's uid made from its name) through its own
``PluginServer``; the other package's ``RegistrationClient`` and
``DRAClient`` dial it, so each server is answered by the other package's
client.  The handshake's fields, and the prepare and unprepare responses
as serialized message bytes, must be equal whichever package serves;
per-claim errors fan out the same way, and parallel prepare/unprepare over
the wire leaves nothing behind.  The protos and the stubs are the
reference's byte for byte, and so are the serialized file descriptors
(both register the same files in the default descriptor pool, so one
process holds one set of message classes).  Sockets go under a short
``mkdtemp(dir="/tmp")``: a unix socket path holds at most 107 bytes.
"""

import filecmp
import inspect
import shutil
import tempfile
import threading
import uuid
from pathlib import Path

import pytest

from k8s_dra_driver_torch.e2e import harness as port_harness
from k8s_dra_driver_torch.plugin import driver as port_driver
from k8s_dra_driver_torch.plugin import grpc_service as port_grpc
from k8s_dra_driver_tpu.e2e import harness as ref_harness
from k8s_dra_driver_tpu.plugin import driver as ref_driver
from k8s_dra_driver_tpu.plugin import grpc_service as ref_grpc

PACKAGES = {"reference": (ref_harness, ref_driver, ref_grpc),
            "port": (port_harness, port_driver, port_grpc)}
OTHER = {"reference": "port", "port": "reference"}
DRIVER = "tpu.google.com"
TOPOLOGY = {"TPUINFO_FAKE_TOPOLOGY": "v5e-16", "TPUINFO_FAKE_HOST_ID": "0"}


class Rig:
    """One package's cluster, driver and server, answered by the other
    package's clients."""

    def __init__(self, name: str, root: Path):
        harness, driver, grpc_service = PACKAGES[name]
        self.name, self.root, self.harness = name, root, harness
        self.cluster = harness.make_cluster(hosts=1, work_dir=str(root / "work"))
        self.driver = driver.Driver(self.cluster.server, driver.DriverConfig(
            node_name="tpu-host-0", cdi_root=str(root / "cdi"),
            checkpoint_path=str(root / "checkpoint.json"), topology_env=dict(TOPOLOGY),
            publish=False))
        self.server = grpc_service.PluginServer(
            self.driver, plugin_dir=str(root / "plugins" / DRIVER),
            registry_dir=str(root / "plugins_registry"))
        for path in (self.server.plugin_socket, self.server.registry_socket):
            assert len(path.encode()) < 100, path
        self.server.start()
        client_pkg = PACKAGES[OTHER[name]]
        self.ClaimRef = client_pkg[1].ClaimRef
        self.client = client_pkg[2].DRAClient(self.server.plugin_socket)
        self.registration = client_pkg[2].RegistrationClient(self.server.registry_socket)

    def allocated(self, name: str, count: int = 1):
        claim = self.harness.simple_claim(name, count=count)
        claim.metadata.uid = str(uuid.uuid5(uuid.NAMESPACE_OID, name))
        claim = self.cluster.server.create(claim)
        claim = self.cluster.allocator.allocate(claim, node_name="tpu-host-0")
        return self.ClaimRef(uid=claim.metadata.uid, name=name, namespace="default")

    def close(self):
        self.client.close()
        self.registration.close()
        self.server.stop()


@pytest.fixture
def rigs():
    root = Path(tempfile.mkdtemp(prefix="dra-", dir="/tmp"))
    made = {}
    try:
        for name in PACKAGES:
            made[name] = Rig(name, root / name[:3])
        yield made
    finally:
        for rig in made.values():
            rig.close()
        shutil.rmtree(root, ignore_errors=True)


def _bytes(msg) -> bytes:
    return msg.SerializeToString(deterministic=True)


def test_the_protos_and_stubs_are_the_reference_s():
    ref = Path(inspect.getfile(ref_grpc)).parent / "proto"
    port = Path(inspect.getfile(port_grpc)).parent / "proto"
    for rel in ("dra.proto", "registration.proto", "gen/__init__.py", "gen/dra_pb2.py",
                "gen/registration_pb2.py"):
        assert filecmp.cmp(ref / rel, port / rel, shallow=False), rel
    for name in ("dra", "registration"):
        assert (port_grpc.pb2(name).DESCRIPTOR.serialized_pb
                == ref_grpc.pb2(name).DESCRIPTOR.serialized_pb)
    assert port_grpc.pb2("dra").DESCRIPTOR.package == "k8s.io.kubelet.pkg.apis.dra.v1beta1"
    assert port_grpc.pb2("registration").DESCRIPTOR.package == "pluginregistration"
    src = inspect.getsource(port_grpc)
    for path in ("/k8s.io.kubelet.pkg.apis.dra.v1beta1.DRAPlugin/NodePrepareResources",
                 "/k8s.io.kubelet.pkg.apis.dra.v1beta1.DRAPlugin/NodeUnprepareResources",
                 "/pluginregistration.Registration/GetInfo",
                 "/pluginregistration.Registration/NotifyRegistrationStatus"):
        assert path in src
    assert "protoc" not in src.split('"""', 2)[2]  # the port never generates stubs
    assert port_grpc.SUPPORTED_VERSIONS == ref_grpc.SUPPORTED_VERSIONS


def test_registration_handshake(rigs):
    got = {}
    for name, rig in rigs.items():
        info = rig.registration.handshake()
        assert rig.server.registered.wait(5)
        assert info.endpoint == rig.server.plugin_socket
        got[name] = (info.type, info.name, list(info.supported_versions))
    assert got["port"] == got["reference"] == ("DRAPlugin", DRIVER, ["v1beta1"])


def test_prepare_unprepare_roundtrip(rigs):
    got = {}
    for name, rig in rigs.items():
        refs = [rig.allocated("rpc-claim"), rig.allocated("rpc-pair", count=2)]
        prepared = rig.client.node_prepare_resources(refs)
        again = rig.client.node_prepare_resources(refs)  # idempotent
        in_process = rig.driver.node_prepare_resources(refs)
        unprepared = rig.client.node_unprepare_resources(refs)
        ids = {uid: [list(d.cdi_device_ids) for d in r.devices]
               for uid, r in prepared.claims.items()}
        assert ids == {uid: [d["cdi_device_ids"] for d in r.devices]
                       for uid, r in in_process.items()}
        got[name] = (_bytes(prepared), _bytes(again), _bytes(unprepared),
                     rig.driver.state.prepared_claim_uids(),
                     sorted(p.name for p in (rig.root / "cdi").glob("*.json")))
    assert got["port"] == got["reference"]
    prepared = rigs["port"].client.node_prepare_resources([rigs["port"].allocated("x")])
    (res,) = prepared.claims.values()
    assert res.error == "" and res.devices[0].pool_name == "tpu-host-0"
    assert len(res.devices[0].cdi_device_ids) == 2


def test_per_claim_error_fanout(rigs):
    got = {}
    for name, rig in rigs.items():
        refs = [rig.allocated("good"), rig.ClaimRef(uid="nope", name="missing",
                                                    namespace="default")]
        resp = rig.client.node_prepare_resources(refs)
        assert resp.claims[refs[0].uid].error == ""
        assert "missing" in resp.claims["nope"].error
        got[name] = (_bytes(resp), _bytes(rig.client.node_unprepare_resources(refs)))
    assert got["port"] == got["reference"]


@pytest.mark.parametrize("server", list(PACKAGES))
def test_parallel_prepare_unprepare_over_the_wire(rigs, server):
    """Three client threads of the other package, five claims each, against
    one package's server: every claim prepares once, idempotently, and
    unprepares; no claim and no CDI spec is left behind."""
    rig = rigs[server]
    errors: list[str] = []
    lock = threading.Lock()

    def worker(wid: int):
        client = PACKAGES[OTHER[server]][2].DRAClient(rig.server.plugin_socket)
        try:
            for i in range(5):
                name = f"load-{wid}-{i}"
                with lock:  # the allocator stands in for kube-scheduler
                    ref = rig.allocated(name)
                first = client.node_prepare_resources([ref]).claims[ref.uid]
                if first.error:
                    errors.append(f"{name}: {first.error}")
                    continue
                again = client.node_prepare_resources([ref]).claims[ref.uid]
                if [d.device_name for d in again.devices] != [d.device_name
                                                              for d in first.devices]:
                    errors.append(f"{name}: non-idempotent prepare")
                un = client.node_unprepare_resources([ref]).claims[ref.uid]
                if un.error:
                    errors.append(f"{name}: unprepare {un.error}")
                with lock:
                    rig.cluster.allocator.deallocate(
                        rig.cluster.server.get("ResourceClaim", name, "default"))
        finally:
            client.close()

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "a worker thread hung"
    assert not errors, errors[:5]
    assert rig.driver.state.prepared_claim_uids() == []
    assert rig.driver.state.cdi.list_claim_spec_uids() == []
