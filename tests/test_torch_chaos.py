"""The port's API-server fault kinds (``k8s_dra_driver_torch/utils/
faults.py``) against the reference's, and the port's driver stack under
them, on the CPU.

* The same seed and profile decide the same faults in both injectors: a
  scripted sequence of store verbs and HTTP seams (``before``,
  ``take_drop``, ``take_watch_gone`` / ``_error_frame`` / ``_hang``),
  interleaved with engine decisions that draw from the same RNG, gives the
  same outcomes (error type, message and code), the same ``stats()`` and
  ``total_injected()``, and the same ``dra_faults_injected_total`` counts.
* ``FaultInjector.from_env`` parses the reference's ``DRA_FAULTS``
  grammar to the same profile; the scheduler kinds and typos are refused
  by name; ``InMemoryAPIServer`` arms itself from ``DRA_FAULTS``.
* The reference's chaos suite (``tests/test_chaos.py``) on the port's
  ``RESTClient``, ``Driver``, ``Allocator``, ``AllocationIndex`` and
  ``ResourceSliceController``, over HTTP against each package's mock: the
  claim lifecycle converges at 30% errors, the breaker opens and heals, a
  409 storm and a partial reconcile heal, watches recover from 410s,
  ``ERROR`` frames and deletes during an outage, and CRUD heals through
  truncated responses.
"""

import dataclasses
import importlib
import time
import types

import pytest

MODULES = dict(faults="utils.faults", fakeserver="kube.fakeserver", mock_api="e2e.mock_api",
               metrics="utils.metrics", objects="kube.objects")
PKG = {name: types.SimpleNamespace(**{k: importlib.import_module(f"{root}.{m}")
                                      for k, m in MODULES.items()})
       for name, root in (("reference", "k8s_dra_driver_tpu"), ("port", "k8s_dra_driver_torch"))}

from k8s_dra_driver_torch import DRIVER_NAME  # noqa: E402
from k8s_dra_driver_torch.e2e.harness import install_device_classes, simple_claim  # noqa: E402
from k8s_dra_driver_torch.kube.fakeserver import APIError, InMemoryAPIServer  # noqa: E402
from k8s_dra_driver_torch.kube.objects import Device, Node, ObjectMeta  # noqa: E402
from k8s_dra_driver_torch.kube.resourceslice_controller import (  # noqa: E402
    DriverResources,
    Pool,
    ResourceSliceController,
    Slice,
    SliceSyncError,
)
from k8s_dra_driver_torch.kube.restclient import KubeClientConfig, RESTClient  # noqa: E402
from k8s_dra_driver_torch.plugin.driver import ClaimRef, Driver, DriverConfig  # noqa: E402
from k8s_dra_driver_torch.scheduler.allocator import Allocator  # noqa: E402
from k8s_dra_driver_torch.scheduler.index import AllocationIndex  # noqa: E402
from k8s_dra_driver_torch.utils.faults import FaultInjector, FaultProfile  # noqa: E402
from k8s_dra_driver_torch.utils.journal import JOURNAL  # noqa: E402
from k8s_dra_driver_torch.utils.metrics import REGISTRY  # noqa: E402
from k8s_dra_driver_torch.utils.retry import Backoff, CircuitOpenError, RetryPolicy  # noqa: E402

FAKE_TOPOLOGY = {"TPUINFO_FAKE_TOPOLOGY": "v5e-16", "TPUINFO_FAKE_HOST_ID": "0"}

PROFILES = {
    "error storm": dict(error_rate=0.3, error_code=503),
    "put conflicts": dict(conflict_rate=0.6, verbs=("PUT",), kinds=("ResourceSlice",), limit=4),
    "drops": dict(drop_rate=0.3, latency_s=0.0001, limit=12),
    "watch storms": dict(watch_gone=2, watch_error_frames=3, watch_hangs=2, watch_hang_s=0.5,
                         kinds=("Node", "ResourceSlice")),
    "mixed with engine kinds": dict(error_rate=0.2, conflict_rate=0.1, nan_logits_rate=0.3,
                                    drop_rate=0.2, watch_gone=1, limit=30),
}
VERBS = ("GET", "LIST", "POST", "PUT", "DELETE")
KINDS = ("Node", "ResourceSlice", "ResourceClaim")


def decide(pkg, profile, seed=7, n=60) -> tuple:
    """The scripted sequence on an injector of ``pkg``: every outcome, then
    ``stats()``, ``total_injected()`` and the counter's growth."""
    faults = PKG[pkg].faults
    counter = PKG[pkg].metrics.REGISTRY.counter("dra_faults_injected_total")
    name = f"decide-{seed}"
    before = dict(counter._values)
    inj = faults.FaultInjector(seed=seed)
    inj.arm(faults.FaultProfile(name=name, **profile))
    seen = []
    for i in range(n):
        verb, kind = VERBS[i % len(VERBS)], KINDS[(i // len(VERBS)) % len(KINDS)]
        try:
            inj.before(verb, kind)
            seen.append(None)
        except Exception as exc:
            seen.append((type(exc).__name__, str(exc), exc.code))
        seen.append((inj.take_drop(verb, kind), inj.take_watch_gone(kind),
                     inj.take_watch_error_frame(kind), inj.take_watch_hang(kind),
                     inj.take_nan_logits(i % 4, i)))
    grew = {dict(k).get("fault"): v - before.get(k, 0) for k, v in counter._values.items()
            if dict(k).get("profile") == name and v != before.get(k, 0)}
    return seen, inj.stats(), inj.total_injected(), grew


@pytest.mark.parametrize("profile", PROFILES)
def test_api_server_faults_decide_alike(profile):
    got = {pkg: decide(pkg, PROFILES[profile]) for pkg in PKG}
    assert got["port"] == got["reference"]
    seen, stats, total, grew = got["port"]
    assert total == sum(stats.values()) > 0 and grew == stats
    assert total <= PROFILES[profile].get("limit", total)


SPECS = [
    "error_rate=0.3,latency_ms=5,seed=7",
    "conflict_rate=1.0,verbs=PUT+POST,kinds=ResourceSlice,limit=3,error_code=429",
    "drop_rate=0.25,watch_gone=2,watch_error_frames=1,watch_hangs=3,watch_hang_s=0.5",
    "latency_s=0.01,error_rate=0.1,nan_logits_rate=0.2,slots=1+3,steps=4,seed=3",
]


@pytest.mark.parametrize("spec", SPECS)
def test_from_env_parses_alike(spec):
    got = {}
    for pkg, m in PKG.items():
        inj = m.faults.FaultInjector.from_env(spec)
        (profile,) = inj._profiles
        got[pkg] = (dataclasses.asdict(profile), [inj._rng.random() for _ in range(3)])
    port_fields, draws = got["port"]
    ref_fields, ref_draws = got["reference"]
    assert draws == ref_draws
    assert port_fields == {k: ref_fields[k] for k in port_fields}
    # the reference's scheduler fields stay at their defaults
    defaults = dataclasses.asdict(PKG["reference"].faults.FaultProfile(name="env"))
    assert {k: v for k, v in ref_fields.items() if k not in port_fields} == \
        {k: v for k, v in defaults.items() if k not in port_fields}


@pytest.mark.parametrize("key", ["sched_conflict_rate=0.5", "schedulers=0+1",
                                 "sched_commit_latency_ms=5", "error_rat=0.1"])
def test_from_env_refuses_what_the_port_does_not_inject(key, monkeypatch):
    with pytest.raises(ValueError, match=repr(key.split("=")[0])):
        FaultInjector.from_env(key)
    monkeypatch.setenv("DRA_FAULTS", "conflict_rate=1.0,kinds=Node,limit=1")
    server = InMemoryAPIServer()
    with pytest.raises(PKG["port"].fakeserver.Conflict, match="profile 'env'"):
        server.create(Node(metadata=ObjectMeta(name="n0")))
    server.create(Node(metadata=ObjectMeta(name="n0")))  # the limit is spent


@pytest.fixture(params=["port mock", "reference mock"])
def chaos(request):
    """A mock API (of either package, its own injector) whose store and
    HTTP facade share one armed, initially silent injector."""
    m = PKG[request.param.split()[0]]
    inj = m.faults.FaultInjector(seed=1234)
    api = m.mock_api.MockKubeAPI(server=m.fakeserver.InMemoryAPIServer(fault_injector=inj))
    api.start()
    yield api, inj, m
    inj.disarm()
    api._closing.set()
    api.stop()


def fast_client(api, **kw):
    """RESTClient tuned for test time: millisecond backoffs, short watch
    read timeout, quick breaker cooldown."""
    defaults = dict(
        retry_policy=RetryPolicy(max_attempts=6, base_delay_s=0.002, max_delay_s=0.02),
        watch_policy=RetryPolicy(max_attempts=0, base_delay_s=0.01, max_delay_s=0.05,
                                 jitter=0.0),
        watch_read_timeout_s=2.0, breaker_threshold=12, breaker_reset_s=0.05,
    )
    defaults.update(kw)
    return RESTClient(KubeClientConfig(server=api.url, qps=100000, burst=100000), **defaults)


def until_ok(fn, attempts=40):
    """Caller-level reconcile loop: the kubelet and the scheduler retry the
    whole operation; declarative state makes the replay safe."""
    bo = Backoff(RetryPolicy(max_attempts=0, base_delay_s=0.005, max_delay_s=0.05,
                             multiplier=1.5, jitter=0.0))
    last = None
    for _ in range(attempts):
        try:
            return fn()
        except Exception as exc:
            last = exc
            bo.sleep()
    raise AssertionError(f"did not converge after {attempts} attempts: {last!r}")


def wait_until(pred, timeout=5.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _install(api, m):
    if m is PKG["port"]:
        install_device_classes(api.server)
    else:
        from k8s_dra_driver_tpu.e2e.harness import install_device_classes as ref_install

        ref_install(api.server)


def test_full_lifecycle_converges_at_30_percent_errors(chaos, tmp_path):
    """Allocate, prepare and unprepare four claims with every verb failing
    30% of the time, then a forced watch outage and a republish mid storm:
    no claim lost, nothing prepared at the end, the checkpoint consistent,
    the watch-backed index reconverged, the retries on the metrics."""
    api, inj, m = chaos
    _install(api, m)
    client = fast_client(api)
    cp_path = str(tmp_path / "cp.json")
    driver = Driver(client, DriverConfig(node_name="chaos-host", cdi_root=str(tmp_path / "cdi"),
                                         checkpoint_path=cp_path, topology_env=FAKE_TOPOLOGY))
    assert api.server.list("ResourceSlice")
    index = AllocationIndex(client, live=True)

    def device_names():
        return {c.device.name for c in index.snapshot("chaos-host", {}).candidates}

    assert wait_until(device_names)
    baseline = device_names()
    retries = REGISTRY.counter("dra_api_retries_total")
    retries_before = sum(retries._values.values())
    inj.arm(m.faults.FaultProfile(name="storm", error_rate=0.3))
    uids = {}
    for i in range(4):
        name = f"claim-{i}"
        until_ok(lambda n=name: client.create(simple_claim(n)))
        allocated = until_ok(lambda n=name: Allocator(client).allocate(
            client.get("ResourceClaim", n, "default"), node_name="chaos-host"))
        uids[name] = allocated.metadata.uid

        def prepare(n=name, uid=allocated.metadata.uid):
            res = driver.node_prepare_resources([ClaimRef(uid=uid, name=n, namespace="default")])
            if res[uid].error:
                raise RuntimeError(res[uid].error)

        until_ok(prepare)
    assert set(driver.state.prepared) == set(uids.values())
    for name, uid in uids.items():

        def unprepare(n=name, uid=uid):
            res = driver.node_unprepare_resources([ClaimRef(uid=uid, name=n,
                                                            namespace="default")])
            if res[uid].error:
                raise RuntimeError(res[uid].error)

        until_ok(unprepare)
    for sw in list(api.server._watches):
        sw.stop()
    assert wait_until(driver.publish_resources)
    assert wait_until(lambda: device_names() == baseline)
    index.close()
    inj.disarm()
    for name in uids:
        assert api.server.get("ResourceClaim", name, "default").status.allocation is not None
    assert driver.state.prepared == {}
    restored = Driver(client, DriverConfig(
        node_name="chaos-host", cdi_root=str(tmp_path / "cdi"), checkpoint_path=cp_path,
        topology_env=FAKE_TOPOLOGY, publish=False))
    assert restored.state.prepared == {}
    assert inj.total_injected() > 0
    assert sum(retries._values.values()) > retries_before
    assert [e for e in JOURNAL.tail(limit=10000, component="retry") if e["event"] == "call.retry"]


def test_breaker_opens_fails_fast_and_recovers(chaos):
    api, inj, m = chaos
    api.server.create(m.objects.Node(metadata=m.objects.ObjectMeta(name="n1")))
    client = fast_client(api, retry_policy=RetryPolicy(max_attempts=1, base_delay_s=0.001,
                                                       max_delay_s=0.005),
                         breaker_threshold=3, breaker_reset_s=0.05)
    transitions = REGISTRY.counter("dra_circuit_transitions_total")
    opened = transitions.value(endpoint="nodes", to="open")
    closed = transitions.value(endpoint="nodes", to="closed")
    inj.arm(m.faults.FaultProfile(name="down", error_rate=1.0, kinds=("Node",)))
    for _ in range(3):
        with pytest.raises(APIError):
            client.get("Node", "n1")
    before = inj.total_injected()
    with pytest.raises(CircuitOpenError):
        client.get("Node", "n1")
    assert inj.total_injected() == before
    gauge = REGISTRY.gauge("dra_circuit_state")
    assert gauge.value(endpoint="nodes") == 2
    inj.disarm()
    time.sleep(0.06)
    assert client.get("Node", "n1").metadata.name == "n1"
    assert gauge.value(endpoint="nodes") == 0
    assert transitions.value(endpoint="nodes", to="open") == opened + 1
    assert transitions.value(endpoint="nodes", to="closed") == closed + 1


def _device(name):
    return Device(name=name)


def test_reconciler_heals_409_storm():
    inj = FaultInjector(seed=5)
    server = InMemoryAPIServer(fault_injector=inj)
    ctrl = ResourceSliceController(server, DRIVER_NAME, "host-a")
    ctrl.update(DriverResources(pools={"p": Pool(slices=[Slice(devices=[_device("d0")])],
                                                 node_name="n0")}))
    retried = REGISTRY.counter("dra_slice_sync_retries_total").value()
    inj.arm(FaultProfile(name="conflicts", conflict_rate=1.0, verbs=("PUT",),
                         kinds=("ResourceSlice",), limit=3))
    ctrl.update(DriverResources(pools={"p": Pool(
        slices=[Slice(devices=[_device("d0"), _device("d1")])], node_name="n0")}))
    (published,) = server.list("ResourceSlice")
    assert [d.name for d in published.spec.devices] == ["d0", "d1"]
    assert inj.stats() == {"conflict": 3}
    assert REGISTRY.counter("dra_slice_sync_retries_total").value() > retried
    assert [e for e in JOURNAL.tail(component="resourceslices")
            if e["event"] == "slice.conflict_retry"]


def test_partial_reconcile_continues_then_heals():
    inj = FaultInjector(seed=2)
    server = InMemoryAPIServer(fault_injector=inj)
    ctrl = ResourceSliceController(server, DRIVER_NAME, "host-b")
    inj.arm(FaultProfile(name="one-shot", error_rate=1.0, verbs=("POST",),
                         kinds=("ResourceSlice",), limit=1))
    resources = DriverResources(pools={
        "a": Pool(slices=[Slice(devices=[_device("a0")])], node_name="n1"),
        "b": Pool(slices=[Slice(devices=[_device("b0")])], node_name="n2")})
    with pytest.raises(SliceSyncError) as ei:
        ctrl.update(resources)
    assert len(ei.value.failures) == 1 and ei.value.code == 503
    assert len(server.list("ResourceSlice")) == 1
    ctrl.update(resources)
    assert len(server.list("ResourceSlice")) == 2


class TestWatchOutage:
    """The scheduler index converges across watch outages, over HTTP."""

    def _rig(self, api, m, tmp_path):
        _install(api, m)
        Driver(fast_client(api), DriverConfig(
            node_name="chaos-host", cdi_root=str(tmp_path / "cdi"),
            checkpoint_path=str(tmp_path / "cp.json"), topology_env=FAKE_TOPOLOGY))
        index = AllocationIndex(fast_client(api), live=True)
        assert wait_until(lambda: self._names(index))
        return index

    def _names(self, index):
        return {c.device.name for c in index.snapshot("chaos-host", {}).candidates}

    def _drop_streams(self, api):
        for sw in list(api.server._watches):
            sw.stop()

    def _extra_slice(self, api, m, name):
        s = m.objects.deepcopy(api.server.list("ResourceSlice")[0])
        s.metadata.name = name
        s.metadata.uid = ""
        s.metadata.resource_version = ""
        s.spec.pool.name = f"{name}-pool"
        s.spec.devices = [m.objects.Device(name=f"{name}-dev")]
        return s

    def test_410_on_connect_recovers_through_relist(self, chaos, tmp_path):
        api, inj, m = chaos
        index = self._rig(api, m, tmp_path)
        baseline = self._names(index)
        inj.arm(m.faults.FaultProfile(name="gone", watch_gone=3))
        self._drop_streams(api)
        api.server.create(self._extra_slice(api, m, "extra"))
        assert wait_until(lambda: "extra-dev" in self._names(index))
        assert baseline <= self._names(index)
        index.close()

    def test_error_frame_mid_stream_recovers(self, chaos, tmp_path):
        api, inj, m = chaos
        index = self._rig(api, m, tmp_path)
        reconnects = REGISTRY.counter("dra_watch_reconnects_total")
        before = reconnects.value(kind="ResourceSlice")
        inj.arm(m.faults.FaultProfile(name="frames", watch_error_frames=3,
                                      kinds=("ResourceSlice",)))
        assert wait_until(lambda: inj.stats().get("watch_error_frames", 0) >= 1)
        api.server.create(self._extra_slice(api, m, "after"))
        assert wait_until(lambda: "after-dev" in self._names(index))
        assert reconnects.value(kind="ResourceSlice") > before
        index.close()

    def test_relist_synthesizes_deleted_during_outage(self, chaos, tmp_path):
        api, inj, m = chaos
        index = self._rig(api, m, tmp_path)
        victim = api.server.list("ResourceSlice")[0].metadata.name
        inj.arm(m.faults.FaultProfile(name="gone", watch_gone=12, kinds=("ResourceSlice",)))
        self._drop_streams(api)
        api.server.delete("ResourceSlice", victim)
        assert wait_until(lambda: self._names(index) == set())
        index.close()


def test_crud_heals_through_truncated_responses(chaos):
    """30% of responses cut mid-body plus 1 ms of latency: the retry layer
    heals every verb with no failure the caller sees."""
    api, inj, m = chaos
    client = fast_client(api)
    inj.arm(m.faults.FaultProfile(name="flaky-net", drop_rate=0.3, latency_s=0.001, limit=40))
    for i in range(10):
        until_ok(lambda i=i: client.create(Node(metadata=ObjectMeta(name=f"n{i}",
                                                                    labels={"i": str(i)}))))
    assert len(client.list("Node")) == 10
    for i in range(10):
        def touch(i=i):
            n = client.get("Node", f"n{i}")
            n.metadata.labels["touched"] = "1"
            client.update(n)

        until_ok(touch)
    for i in range(10):
        until_ok(lambda i=i: client.delete("Node", f"n{i}"))
    assert client.list("Node") == []
    assert inj.stats().get("drop", 0) > 0
    assert m.metrics.REGISTRY.counter("dra_faults_injected_total").value(
        profile="flaky-net", fault="drop") > 0
