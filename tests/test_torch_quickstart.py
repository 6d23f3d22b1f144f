"""The port's closed loop (``k8s_dra_driver_torch/e2e/{harness,spec_runner}.py``
over its allocator and node driver) against the reference's, on the CPU.

Each spec family is applied in both packages, each over its own
``make_cluster`` (fake hosts, the reference's DeviceClasses, one ``Driver``
a host) and its own work directory, with uids from one deterministic
sequence: every quickstart spec that needs no cluster controller
(``tpu-test1`` to ``tpu-test6``, ``tpu-test-sharing``), the sharing demo
(its claims, then its Job) and the selectors demo (its claims, then its
pods).  The ``RunningPod``s must be equal (names, nodes, claims, devices,
environment), and so must every CDI spec file and the checkpoint byte for
byte once each work directory is written as ``<work>``; then every pod is
deleted, in order, and after each deletion the files and the claims'
allocations and reservations must be equal again.  ``slice-test1`` (4
hosts of one v5e-16 slice) and ``multislice-test1`` (2 slices of 2 hosts,
one group) run with each package's ``SliceManager`` publishing the seats:
the pods, their nodes, devices and environment, the files, the published
ResourceSlices and the identity each pod's ``consumer.attach`` resolves
must be equal, and every pod holds a distinct seat.
"""

import dataclasses
import importlib
import uuid
from pathlib import Path

import pytest

from k8s_dra_driver_torch.e2e import harness as port_harness
from k8s_dra_driver_torch.e2e import spec_runner as port_spec_runner
from k8s_dra_driver_torch.kube import serde as port_serde
from k8s_dra_driver_tpu.e2e import harness as ref_harness
from k8s_dra_driver_tpu.e2e import spec_runner as ref_spec_runner
from k8s_dra_driver_tpu.kube import serde as ref_serde

SPECS = Path(__file__).resolve().parent.parent / "demo" / "specs"
PACKAGES = {"reference": (ref_harness, ref_spec_runner, ref_serde),
            "port": (port_harness, port_spec_runner, port_serde)}

# (family, topology, spec files applied in order)
FAMILIES = {
    **{name: ("v5e-16", [f"quickstart/{name}.yaml"])
       for name in ("tpu-test1", "tpu-test2", "tpu-test3", "tpu-test4", "tpu-test5",
                    "tpu-test6", "tpu-test-sharing")},
    "sharing-demo": ("v5e-8", ["sharing/sharing-demo-claims.yaml",
                               "sharing/sharing-demo-job.yaml"]),
    "selectors": ("v5e-8", ["selectors/claims.yaml", "selectors/pods.yaml"]),
}


def _deterministic_uids(monkeypatch):
    counter = iter(range(1, 1 << 30))
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter)))


def _files(work: Path) -> dict[str, bytes]:
    """Every file under the work directory (CDI specs, checkpoints), by
    relative path, the directory's own path written as ``<work>``."""
    return {str(p.relative_to(work)): p.read_bytes().replace(str(work).encode(), b"<work>")
            for p in sorted(work.rglob("*")) if p.is_file()}


def _claims(cluster, serde) -> list:
    out = []
    for c in sorted(cluster.server.list("ResourceClaim"),
                    key=lambda c: (c.metadata.namespace, c.metadata.name)):
        out.append((c.metadata.namespace, c.metadata.name, c.metadata.uid,
                    serde.to_json(c.status)))
    return out


def _pods(pods, work: Path) -> list:
    return [{k: (v.replace(str(work), "<work>") if isinstance(v, str) else v)
             for k, v in dataclasses.asdict(p).items()} | {
                "env": {k: v.replace(str(work), "<work>") for k, v in p.env.items()}}
            for p in pods]


def run_family(name, family, tmp_path, monkeypatch) -> list:
    harness, spec_runner, serde = PACKAGES[name]
    topology, specs = FAMILIES[family]
    _deterministic_uids(monkeypatch)
    work = tmp_path / name
    cluster = harness.make_cluster(hosts=1, topology=topology, work_dir=str(work))
    pods = []
    for spec in specs:
        pods += spec_runner.apply_spec(cluster, SPECS / spec)
    log = [("applied", _pods(pods, work), _files(work), _claims(cluster, serde))]
    for p in pods:
        cluster.delete_pod(p.name, p.namespace)
        log.append((f"deleted {p.namespace}/{p.name}", _files(work), _claims(cluster, serde),
                    sorted(x.metadata.name for x in cluster.server.list("Pod"))))
    node = next(iter(cluster.nodes.values()))
    log.append(("prepared at the end", node.state.prepared_claim_uids()))
    return log


@pytest.mark.parametrize("family", list(FAMILIES))
def test_the_family_runs_as_the_reference_s(tmp_path, monkeypatch, family):
    logs = {name: run_family(name, family, tmp_path, monkeypatch) for name in PACKAGES}
    for want, got in zip(logs["reference"], logs["port"], strict=True):
        assert got == want, want[0]
    applied = logs["port"][0]
    pods, files = applied[1], applied[2]
    assert pods and all(p["devices"] for p in pods)
    assert any(k.endswith(".json") and "claim" in k for k in files)
    assert logs["port"][-1] == ("prepared at the end", [])


def test_tpu_test3_teardown_follows_the_last_consumer(tmp_path, monkeypatch):
    """The shared claim outlives ``pod0`` and goes with ``pod1``."""
    got = {}
    for name, (harness, spec_runner, _) in PACKAGES.items():
        _deterministic_uids(monkeypatch)
        cluster = harness.make_cluster(hosts=1, topology="v5e-16",
                                       work_dir=str(tmp_path / name))
        spec_runner.apply_spec(cluster, SPECS / "quickstart" / "tpu-test3.yaml")
        steps = []
        for pod in ("pod0", "pod1"):
            cluster.delete_pod(pod, "tpu-test3")
            c = cluster.server.get("ResourceClaim", "shared-tpu", "tpu-test3")
            steps.append((c.status.allocation is not None, len(c.status.reserved_for),
                          cluster.nodes["tpu-host-0"].state.prepared_claim_uids()))
        got[name] = steps
    assert got["port"] == got["reference"]
    assert [s[:2] for s in got["port"]] == [(True, 1), (False, 0)]


SLICE_SPECS = {
    "slice-test1": dict(slice_domain="v5e-16-demo"),
    "multislice-test1": dict(slice_domain="ms", slices=2, slice_group="g"),
}
IDENTITY = ("worker_id", "host_count", "coordinator_address", "visible_devices", "num_slices",
            "slice_id", "global_worker_id", "megascale_coordinator", "multi_host", "multi_slice")


def _slices(cluster, name) -> tuple[list, dict]:
    """The published slices without their resource versions and pool
    generations (the seat pools' without their uids too), and the seat
    pools' generations apart: the port's manager publishes the Node
    informer's replay once, the reference's once a Node, so they write in
    another order (``controller/slice_manager.py``'s docstring)."""
    root = "k8s_dra_driver_tpu" if name == "reference" else "k8s_dra_driver_torch"
    objects = importlib.import_module(f"{root}.kube.objects")
    docs, seat_generations = [], {}
    for s in sorted(cluster.server.list("ResourceSlice"), key=lambda s: s.metadata.name):
        doc = objects.to_json(s)
        del doc["metadata"]["resourceVersion"]
        generation = doc["spec"]["pool"].pop("generation", 0)
        if doc["metadata"]["labels"].get("dra.tpu.google.com/owner") == "controller":
            del doc["metadata"]["uid"]
            seat_generations[doc["spec"]["pool"]["name"]] = generation
        docs.append(doc)
    return docs, seat_generations


@pytest.mark.parametrize("spec", SLICE_SPECS)
def test_slice_specs_run_under_the_controller(tmp_path, monkeypatch, spec):
    got, generations = {}, {}
    for name, (harness, spec_runner, serde) in PACKAGES.items():
        root = "k8s_dra_driver_tpu" if name == "reference" else "k8s_dra_driver_torch"
        slice_manager = importlib.import_module(f"{root}.controller.slice_manager")
        consumer = importlib.import_module(f"{root}.consumer")
        _deterministic_uids(monkeypatch)
        work = tmp_path / name
        cluster = harness.make_cluster(hosts=4, topology="v5e-16", work_dir=str(work),
                                       **SLICE_SPECS[spec])
        manager = slice_manager.SliceManager(cluster.server)
        manager.start()
        try:
            pods = spec_runner.apply_spec(cluster, SPECS / "quickstart" / f"{spec}.yaml")
            ids = [{k: getattr(consumer.attach(environ=p.env, init_distributed=False), k)
                    for k in IDENTITY} for p in pods]
            docs, generations[name] = _slices(cluster, name)
            got[name] = (_pods(pods, work), _files(work), _claims(cluster, serde), docs, ids)
        finally:
            manager.stop()
    assert got["port"] == got["reference"]
    assert generations["port"].keys() == generations["reference"].keys()
    assert set(generations["port"].values()) == {0}
    assert min(generations["reference"].values()) >= 1
    pods, _, _, _, ids = got["port"]
    assert len(pods) == 4 and len({p["node"] for p in pods}) == 4
    seats = [d["device_name"] for p in pods for d in p["devices"]
             if d["device_name"].startswith("membership-")]
    assert len(seats) == 4 and all(any(d["device_name"].startswith("tpu-slice-2x2")
                                       for d in p["devices"]) for p in pods)
    if spec == "slice-test1":
        assert sorted(i["worker_id"] for i in ids) == [0, 1, 2, 3]
        assert len({i["coordinator_address"] for i in ids}) == 1
        assert {i["host_count"] for i in ids} == {4}
    else:
        assert sorted(i["global_worker_id"] for i in ids) == [0, 1, 2, 3]
        assert {i["num_slices"] for i in ids} == {2} and {i["host_count"] for i in ids} == {2}
        (megascale,) = {i["megascale_coordinator"] for i in ids}
        assert megascale.endswith(":8081")
        assert {p["env"]["MEGASCALE_NUM_SLICES"] for p in pods} == {"2"}


def test_a_pod_that_does_not_fit_leaves_nothing_behind(tmp_path, monkeypatch):
    """tpu-test1 fans one template out to two pods: on a 1-chip host the
    second is unschedulable, and the unwind leaves its claim unallocated."""
    got = {}
    for name, (harness, spec_runner, serde) in PACKAGES.items():
        _deterministic_uids(monkeypatch)
        work = tmp_path / name
        cluster = harness.make_cluster(hosts=1, topology="v5e-16", work_dir=str(work))
        cluster.allocator.allocate(
            cluster.server.create(harness.simple_claim("hog", count=3)), node_name="tpu-host-0")
        with pytest.raises(spec_runner.SpecError) as err:
            spec_runner.apply_spec(cluster, SPECS / "quickstart" / "tpu-test1.yaml")
        got[name] = (str(err.value), _claims(cluster, serde), _files(work),
                     sorted(p.metadata.name for p in cluster.server.list("Pod")))
    assert got["port"] == got["reference"]
    message, claims, _, pods = got["port"]
    assert "tpu-test1/pod1 is unschedulable" in message and pods == ["pod0"]
    by_name = {c[1]: c[3] for c in claims}
    assert by_name["pod0-tpu"].get("allocation") and not by_name["pod1-tpu"].get("allocation")
