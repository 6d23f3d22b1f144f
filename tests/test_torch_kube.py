"""The port's Kubernetes plumbing (``k8s_dra_driver_torch/kube/``) against
the reference's, on the CPU: quantities, the wire form of every kind (both
resource.k8s.io versions), the in-memory API server's verbs, watches and
errors, the ResourceSlice reconciler, and the ResourceSlices each package's
driver publishes (``kube/serde`` dicts) for a single-host v5e-8, a v5e-16
host, a multi-host v4 host, a ``parted`` layout, a masked share of the
chips and a dead chip."""

import json

import pytest

from k8s_dra_driver_torch.kube import fakeserver as port_fakeserver
from k8s_dra_driver_torch.kube import objects as port_objects
from k8s_dra_driver_torch.kube import quantity as port_quantity
from k8s_dra_driver_torch.kube import resourceslice_controller as port_rsc
from k8s_dra_driver_tpu.kube import fakeserver as ref_fakeserver
from k8s_dra_driver_tpu.kube import objects as ref_objects
from k8s_dra_driver_tpu.kube import quantity as ref_quantity
from k8s_dra_driver_tpu.kube import resourceslice_controller as ref_rsc
from tests.torch_node_rig import claim_doc, make_pair, tpu_config

SIDES = (
    ("reference", ref_objects, ref_fakeserver, ref_rsc),
    ("port", port_objects, port_fakeserver, port_rsc),
)


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # noqa: BLE001 - the error is the result
        return ("error", type(exc).__name__, str(exc))


QUANTITIES = ["16Gi", "1.5Gi", "1024", 4096, "2k", "3M", "0.5Ki", "1.1", "", "x",
              "9.9e999", "9.9e307M", " 64Mi ", "1Ei", "-2Mi"]


def test_quantities_equal_the_reference():
    for q in QUANTITIES:
        assert _outcome(port_quantity.parse, q) == _outcome(ref_quantity.parse, q), q
    for n in (0, 1, 1023, 1024, 3 << 20, 16 << 30, (16 << 30) + 1, 5 << 60):
        assert port_quantity.format_bytes(n) == ref_quantity.format_bytes(n)


WIRE_DOCS = [
    claim_doc("c", "uid-c", [("t", "host-0", "tpu-1"), ("s", "host-0", "tpu-slice-2x2-0-0")],
              [((), tpu_config("TimeSlicing"))]),
    {"apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
     "metadata": {"name": "v1", "namespace": "ns"},
     "spec": {"devices": {"requests": [{"name": "r", "exactly": {
         "deviceClassName": "tpu.google.com", "count": 2, "allocationMode": "ExactCount",
         "selectors": [{"cel": {"expression": "device.attributes['x'].healthy"}}]}}]}}},
    {"apiVersion": "resource.k8s.io/v1", "kind": "ResourceSlice",
     "metadata": {"name": "s", "labels": {"a": "b"}},
     "spec": {"driver": "tpu.google.com", "pool": {"name": "p", "generation": 3},
              "nodeName": "host-0", "devices": [
                  {"name": "tpu-0", "attributes": {"healthy": {"bool": True},
                                                   "index": {"int": 0}},
                   "capacity": {"hbm": {"value": "16Gi"}, "chip0": {"value": "1"}}}]}},
    {"apiVersion": "resource.k8s.io/v1beta1", "kind": "DeviceClass",
     "metadata": {"name": "tpu.google.com"},
     "spec": {"selectors": [{"cel": {"expression": "device.driver == 'tpu.google.com'"}}],
              "config": [{"opaque": {"driver": "tpu.google.com",
                                     "parameters": tpu_config("Exclusive")}}]}},
    {"apiVersion": "apps/v1", "kind": "Deployment", "metadata": {"name": "d", "namespace": "n"},
     "spec": {"replicas": 1}, "status": {"readyReplicas": 1}},
    {"apiVersion": "coordination.k8s.io/v1", "kind": "Lease", "metadata": {"name": "l"},
     "spec": {"holderIdentity": "me", "leaseDurationSeconds": 15}},
    {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "p", "namespace": "n"},
     "spec": {"containers": []}, "status": {"phase": "Running"}},
    {"apiVersion": "v1", "kind": "Gadget", "metadata": {"name": "g"}},
]


@pytest.mark.parametrize("i", range(len(WIRE_DOCS)))
def test_the_wire_form_equals_the_reference(i):
    doc = WIRE_DOCS[i]

    def wire(objects):
        obj = _outcome(objects.from_json, json.loads(json.dumps(doc)))
        if obj[0] == "error":
            return obj
        out = [objects.to_json(obj[1])]
        if getattr(type(obj[1]), "API_VERSION", "").startswith("resource.k8s.io/"):
            out.append(objects.to_json(obj[1], api_version="resource.k8s.io/v1"))
            out.append(_outcome(objects.to_json, obj[1], "resource.k8s.io/v2"))
        out.append(objects.to_json(objects.deepcopy(obj[1])))
        return out

    assert wire(port_objects) == wire(ref_objects)


def test_node_selectors_equal_the_reference():
    terms = [{"matchExpressions": [{"key": "zone", "operator": "In", "values": ["a"]},
                                   {"key": "gpu", "operator": "Exists"}]},
             {"matchExpressions": []}]
    for labels in ({"zone": "a", "gpu": "1"}, {"zone": "a"}, {}, {"zone": "b", "gpu": ""}):
        got = [objects.from_json({"apiVersion": "resource.k8s.io/v1beta1",
                                  "kind": "ResourceSlice", "metadata": {"name": "s"},
                                  "spec": {"nodeSelector": {"nodeSelectorTerms": terms}}}
                                 ).spec.node_selector.matches(labels)
               for _, objects, _, _ in SIDES]
        assert got[0] == got[1]


def _server_script(objects, fakeserver):
    """One sequence of verbs and watches; what the caller observes."""
    server = fakeserver.InMemoryAPIServer()
    seen = []
    log = []

    def watch(event):
        seen.append((event.type, event.object.metadata.name,
                     event.object.metadata.resource_version))

    def meta(obj):
        return (obj.metadata.name, obj.metadata.resource_version)

    pre = objects.Pod(metadata=objects.ObjectMeta(name="early", namespace="n"))
    log.append(meta(server.create(pre)))
    w = server.watch("Pod", watch)
    for name in ("a", "b"):
        log.append(meta(server.create(objects.Pod(
            metadata=objects.ObjectMeta(name=name, namespace="n", labels={"app": name})))))
    log.append(_outcome(server.create, objects.Pod(metadata=objects.ObjectMeta(
        name="a", namespace="n"))))
    got = server.get("Pod", "a", "n")
    got.status.phase = "Running"
    log.append(meta(server.update(got)))
    stale = server.get("Pod", "b", "n")
    server.update(server.get("Pod", "b", "n"))
    log.append(_outcome(server.update, stale))
    log.append(_outcome(server.get, "Pod", "zz", "n"))
    log.append(sorted(p.metadata.name for p in server.list("Pod", namespace="n",
                                                           label_selector={"app": "b"})))
    log.append(sorted(p.metadata.name for p in server.list(
        "Pod", field_selector=lambda p: p.status.phase == "Running")))
    server.delete("Pod", "a", "n")
    log.append(_outcome(server.delete, "Pod", "a", "n"))
    gen = server.create(objects.Pod(metadata=objects.ObjectMeta(generate_name="g-",
                                                                namespace="n")))
    log.append(gen.metadata.name.startswith("g-") and len(gen.metadata.name) == 7)
    since = []
    server.watch_since("Pod", "4", lambda e: since.append((e.type, e.object.metadata.name)))
    remove = server.add_update_validator("Pod", lambda cur, new: (_ for _ in ()).throw(
        fakeserver.Conflict("refused")))
    log.append(_outcome(server.update, server.get("Pod", "b", "n")))
    remove()
    log.append(meta(server.update(server.get("Pod", "b", "n"))))
    w.stop()
    server.create(objects.Pod(metadata=objects.ObjectMeta(name="late", namespace="n")))
    log.append(server.current_resource_version())

    def named(events):  # a generated name is random: keep its place only
        return [(e[0], "g-*" if e[1].startswith("g-") else e[1], *e[2:]) for e in events]

    return log, named(seen), sorted(named(since))


def test_the_api_server_equals_the_reference():
    got = [_server_script(objects, fakeserver) for _, objects, fakeserver, _ in SIDES]
    assert got[0] == got[1]


def test_an_injected_fault_never_half_applies():
    class Refuse:
        def before(self, verb, kind):
            if verb == "PUT":
                raise port_fakeserver.APIError(503, "injected")

    server = port_fakeserver.InMemoryAPIServer(fault_injector=Refuse())
    pod = server.create(port_objects.Pod(metadata=port_objects.ObjectMeta(name="p")))
    with pytest.raises(port_fakeserver.APIError):
        server.update(pod)
    assert server.get("Pod", "p").metadata.resource_version == pod.metadata.resource_version


def _controller_script(objects, fakeserver, rsc):
    server = fakeserver.InMemoryAPIServer()
    ctl = rsc.ResourceSliceController(server, "tpu.google.com", "host-0")

    def devices(n, tag=""):
        return [objects.Device(name=f"d{i}", basic=objects.BasicDevice(
            attributes={"tag": objects.DeviceAttribute.of(tag)})) for i in range(n)]

    def snapshot():
        out = []
        for s in server.list("ResourceSlice"):
            doc = objects.to_json(s)
            doc["metadata"].pop("uid")
            out.append(doc)
        return sorted(out, key=lambda d: d["metadata"]["name"])

    steps = []
    pool = lambda slices: rsc.DriverResources(pools={"host-0": rsc.Pool(  # noqa: E731
        slices=[rsc.Slice(devices=d) for d in slices], node_name="host-0")})
    for resources in (pool([devices(2)]), pool([devices(2)]), pool([devices(2, "x")]),
                      pool([devices(1), devices(3)]), pool([devices(1)])):
        ctl.update(resources)
        steps.append(snapshot())
    # a concurrent writer bumps a slice under the controller: a 409, healed
    (live,) = server.list("ResourceSlice")
    server.update(live)
    ctl.update(pool([devices(2, "y")]))
    steps.append(snapshot())
    ctl.stop(delete_owned=True)
    steps.append(snapshot())
    return steps


def test_the_slice_reconciler_equals_the_reference():
    got = [_controller_script(objects, fakeserver, rsc) for _, objects, fakeserver, rsc in SIDES]
    assert got[0] == got[1]
    gens = [[s["spec"]["pool"]["generation"] for s in step] for step in got[1]]
    assert gens == [[0], [0], [1], [2, 2], [3], [4], []]


PUBLISHED = {
    "single-host v5e-8": ({"TPUINFO_FAKE_TOPOLOGY": "v5e-8"}, {}),
    "v5e-16 host 2": ({"TPUINFO_FAKE_TOPOLOGY": "v5e-16", "TPUINFO_FAKE_HOST_ID": "2"}, {}),
    "multi-host v4 host 3": ({"TPUINFO_FAKE_TOPOLOGY": "v4-32", "TPUINFO_FAKE_HOST_ID": "3"},
                             {}),
    "parted layout": ({"TPUINFO_FAKE_TOPOLOGY": "v5e-8"}, {"parted": ["2x2", "1x4"]}),
    "masked share": ({"TPUINFO_FAKE_TOPOLOGY": "v5e-8"}, {"visible_chips": "0.1.4.5"}),
    "dead chip": ({"TPUINFO_FAKE_TOPOLOGY": "v5e-16", "TPUINFO_FAKE_DEAD_CHIPS": "2"}, {}),
}


@pytest.mark.parametrize("case", list(PUBLISHED))
def test_published_slices_equal_the_reference(case, tmp_path):
    env, extra = PUBLISHED[case]
    config = {}
    if "parted" in extra:
        state = tmp_path / "parted.json"
        state.write_text(json.dumps({"version": "v1", "layout": "l", "entries": [
            {"hosts": "all", "shapes": extra["parted"]}]}))
        config["parted_state_path"] = str(state)
    if "visible_chips" in extra:
        config["visible_chips"] = extra["visible_chips"]
    ref, port = make_pair(tmp_path, env, **config)
    assert port.slices() == ref.slices()
    (doc,) = port.slices()
    names = [d["name"] for d in doc["spec"]["devices"]]
    assert doc["spec"]["pool"]["name"] == doc["spec"]["nodeName"] == "tpu-host-0"
    if case == "parted layout":
        assert [n for n in names if "slice" in n] == [
            "tpu-slice-1x4-0-0", "tpu-slice-1x4-1-0", "tpu-slice-2x2-0-0", "tpu-slice-2x2-0-2"]
    if case == "dead chip":
        dead = doc["spec"]["devices"][2]["basic"]["attributes"]
        assert dead["healthy"] == {"bool": False}
        assert dead["healthReason"] == {"string": "fault-injected"}
    assert port.cdi_files() == ref.cdi_files()
