"""The port's allocator (``k8s_dra_driver_torch/scheduler/{allocator,index}.py``)
against the reference's, on the CPU.

Each package's ``make_cluster`` builds 1 or 4 fake v5e-16 hosts; both run
one sequence of claims, given as the same wire documents: a single chip,
counts 2 and 4, an overlapping 2x2 subslice refused while its chips are
held and allocated once they are free, CEL selectors, ``allocationMode:
All``, a TimeSlicing and a SpatialPartition config, a ``matchAttribute``
constraint, ``plan``, ``allocate_gang`` (feasible and infeasible),
``reserve``/``unreserve`` and ``deallocate`` (refused while reserved).
After every step the two packages must agree on: the claim's allocation
(``serde`` JSON) or the ``AllocationError`` message, each node's
``AllocationIndex`` snapshot (``Allocator.view``), and the deltas of the
``dra_*`` series of each package's own registry (deltas: each registry is
process-global; histogram sums and buckets are clocks and are left out).
Uids come from one deterministic sequence in both packages.
"""

import uuid

import pytest

from k8s_dra_driver_torch.e2e import harness as port_harness
from k8s_dra_driver_torch.kube import objects as port_objects
from k8s_dra_driver_torch.kube import serde as port_serde
from k8s_dra_driver_torch.scheduler import allocator as port_allocator
from k8s_dra_driver_torch.utils import metrics as port_metrics
from k8s_dra_driver_tpu.e2e import harness as ref_harness
from k8s_dra_driver_tpu.kube import objects as ref_objects
from k8s_dra_driver_tpu.kube import serde as ref_serde
from k8s_dra_driver_tpu.scheduler import allocator as ref_allocator
from k8s_dra_driver_tpu.utils import metrics as ref_metrics

PACKAGES = {
    "reference": (ref_harness, ref_objects, ref_serde, ref_allocator, ref_metrics),
    "port": (port_harness, port_objects, port_serde, port_allocator, port_metrics),
}
DRIVER = "tpu.google.com"
CONFIG_API = "resource.tpu.google.com/v1alpha1"


def request(name, device_class=DRIVER, count=None, selectors=(), mode=None) -> dict:
    doc = {"name": name, "deviceClassName": device_class,
           "selectors": [{"cel": {"expression": e}} for e in selectors]}
    if count is not None:
        doc["count"] = count
    if mode is not None:
        doc["allocationMode"] = mode
    return doc


def claim(name, requests, config=(), constraints=()) -> dict:
    return {"apiVersion": "resource.k8s.io/v1beta1", "kind": "ResourceClaim",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"devices": {"requests": list(requests), "config": list(config),
                                 "constraints": list(constraints)}}}


def sharing(strategy, **body) -> dict:
    return {"requests": [], "opaque": {"driver": DRIVER, "parameters": {
        "apiVersion": CONFIG_API, "kind": "TpuConfig", "sharing": {"strategy": strategy, **body}}}}


CLAIMS = {
    "one": claim("one", [request("t")]),
    "two": claim("two", [request("t", count=2)]),
    "four": claim("four", [request("t", count=4)]),
    "block": claim("block", [request("s", "subslice.tpu.google.com",
                                      selectors=["device.attributes['tpu.google.com'].shape"
                                                 " == '2x2'"])]),
    "low": claim("low", [request("t", selectors=[
        "device.attributes['tpu.google.com'].index < 2",
        "device.capacity['tpu.google.com'].hbm >= quantity('8Gi')"])]),
    "v6e": claim("v6e", [request("t", selectors=[
        "device.attributes['tpu.google.com'].generation == 'v6e'"])]),
    "all": claim("all", [request("t", mode="All")]),
    "ts": claim("ts", [request("t", count=2)],
                config=[sharing("TimeSlicing", timeSlicingConfig={"interval": "Long"})]),
    "sp": claim("sp", [request("t", count=2)],
                config=[sharing("SpatialPartition", spatialPartitionConfig={
                    "defaultCoreFraction": 50, "defaultHbmLimit": "4Gi"})]),
    "pair": claim("pair", [request("a"), request("b")],
                  constraints=[{"matchAttribute": f"{DRIVER}/hostId"}]),
    "planned": claim("planned", [request("t", count=3)]),
    "g0": claim("g0", [request("t", count=2)]),
    "g1": claim("g1", [request("t", count=2)]),
    "g2": claim("g2", [request("t", count=3)]),
}

# (op, args); "A" is the first node, "B" the last (the same one at 1 host)
SEQUENCE = [
    ("allocate", "one", "A"),
    ("allocate", "two", "A"),
    ("allocate", "four", "A"),  # 1 chip left on A
    ("allocate", "four", "B"),
    ("deallocate", "four"),
    ("allocate", "block", "A"),  # overlaps the held chips
    ("deallocate", "one"),
    ("deallocate", "two"),
    ("allocate", "block", "A"),
    ("deallocate", "block"),
    ("allocate", "low", "A"),
    ("allocate", "v6e", "A"),
    ("allocate", "all", "A"),
    ("deallocate", "all"),
    ("deallocate", "low"),
    ("plan", "planned", "A"),
    ("allocate", "ts", "A"),
    ("allocate", "sp", "A"),
    ("plan", "planned", "A"),  # A is full
    ("allocate", "pair", "B"),
    ("deallocate", "ts"),
    ("deallocate", "sp"),
    ("gang", [("g0", "A"), ("g1", "B")]),
    ("gang", [("g2", "A")]),  # infeasible: 2 chips left on A at most
    ("reserve", "g0", "pod-a"),
    ("reserve", "g0", "pod-b"),
    ("deallocate", "g0"),  # refused: still reserved
    ("unreserve", "g0", "pod-a"),
    ("unreserve", "g0", "pod-b"),
    ("deallocate", "g0"),
    ("deallocate", "g1"),
    ("deallocate", "pair"),
    ("allocate", "four", "A"),
]


def _series(metrics) -> dict:
    out = {}
    for name, samples in metrics.parse_prom_text(metrics.REGISTRY.render()).items():
        if name.startswith("dra_") and not name.endswith(("_sum", "_bucket")):
            for labels, value in samples.items():
                out[(name, labels)] = value
    return out


def _delta(before, after) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def _view(allocator, node) -> dict:
    v = allocator.view(node)
    return {"candidates": [c.key for c in v.candidates], "in_use": sorted(v.in_use),
            "used_markers": sorted(v.used_markers), "node_markers": sorted(v.node_markers),
            "classes": sorted(v.classes)}


def _plan_doc(p) -> dict:
    return {"chosen": [(r, c.key) for r, c in p.chosen], "free": [c.key for c in p.free],
            "admin": len(p.admin_results), "tightness": p.tightness(),
            "used_markers": sorted(p.used_markers), "node_markers": sorted(p.node_markers)}


def run_sequence(name: str, hosts: int, work_dir: str, monkeypatch) -> list:
    harness, objects, serde, allocator_mod, metrics = PACKAGES[name]
    counter = iter(range(1, 1 << 30))
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter)))
    cluster = harness.make_cluster(hosts=hosts, topology="v5e-16", work_dir=work_dir)
    nodes = list(cluster.nodes)
    node = {"A": nodes[0], "B": nodes[-1]}
    alloc = cluster.allocator
    for doc in CLAIMS.values():
        cluster.server.create(objects.from_json(doc))

    def get(claim_name):
        return cluster.server.get("ResourceClaim", claim_name, "default")

    def allocation(claim_name):
        a = get(claim_name).status.allocation
        return None if a is None else serde.to_json(a)

    log = []
    for op, *args in SEQUENCE:
        before = _series(metrics)
        try:
            if op == "allocate":
                alloc.allocate(get(args[0]), node_name=node[args[1]],
                               node_labels=cluster.node_labels(node[args[1]]))
                out = allocation(args[0])
            elif op == "deallocate":
                alloc.deallocate(get(args[0]))
                out = allocation(args[0])
            elif op == "plan":
                out = _plan_doc(alloc.plan(get(args[0]), node_name=node[args[1]]))
            elif op == "gang":
                members = [allocator_mod.GangMember(claim=get(c), node_name=node[n])
                           for c, n in args[0]]
                out = [serde.to_json(c.status.allocation) for c in alloc.allocate_gang(members)]
            elif op == "reserve":
                out = [serde.to_json(r) for r in alloc.reserve(
                    get(args[0]), args[1], f"uid-{args[1]}").status.reserved_for]
            else:
                out = [serde.to_json(r) for r in alloc.unreserve(
                    get(args[0]), f"uid-{args[1]}").status.reserved_for]
        except allocator_mod.AllocationError as exc:
            out = ("AllocationError", type(exc).__name__, str(exc))
        log.append({"step": (op, *args), "out": out,
                    "views": {n: _view(alloc, n) for n in nodes},
                    "metrics": _delta(before, _series(metrics))})
    return log


@pytest.mark.parametrize("hosts", [1, 4])
def test_the_sequence_is_the_reference_s(tmp_path, monkeypatch, hosts):
    logs = {name: run_sequence(name, hosts, str(tmp_path / name), monkeypatch)
            for name in PACKAGES}
    for want, got in zip(logs["reference"], logs["port"], strict=True):
        assert got == want, want["step"]
    outs = [entry["out"] for entry in logs["port"]]
    refused = [entry["step"] for entry in logs["port"] if isinstance(entry["out"], tuple)]
    # four on A, the 2x2 block over held chips, no v6e, A full for the plan,
    # the infeasible gang, deallocate while reserved; at one host B is A
    want = [("allocate", "four", "A"), ("allocate", "block", "A"), ("allocate", "v6e", "A"),
            ("plan", "planned", "A"), ("gang", [("g2", "A")]), ("deallocate", "g0")]
    if hosts == 1:
        want[1:1] = [("allocate", "four", "B")]
        want[5:5] = [("allocate", "pair", "B")]
    assert refused == want
    block = outs[[i for i, step in enumerate(SEQUENCE) if step == ("allocate", "block", "A")][1]]
    assert block["devices"]["results"][0]["device"] == "tpu-slice-2x2-0-0"
    assert any(k[0] == "dra_gang_plans_total" for e in logs["port"] for k in e["metrics"])


def test_the_index_reuses_unchanged_pools(tmp_path, monkeypatch):
    """Steady inventory: a second plan on the same node rebuilds no pool
    (misses 0) and evaluates no selector again (the verdict memo)."""
    got = {}
    for name, (harness, objects, _, _, metrics) in PACKAGES.items():
        cluster = harness.make_cluster(hosts=4, topology="v5e-16",
                                       work_dir=str(tmp_path / name))
        c = cluster.server.create(objects.from_json(CLAIMS["two"]))
        cluster.allocator.plan(c, node_name="tpu-host-2")
        before = _series(metrics)
        cluster.allocator.plan(c, node_name="tpu-host-2")
        got[name] = _delta(before, _series(metrics))
    assert got["port"] == got["reference"]
    assert ("dra_alloc_index_misses_total", ()) not in got["port"]
    assert ("dra_cel_evals_total", ()) not in got["port"]
    assert got["port"][("dra_alloc_index_hits_total", ())] == 1


def test_stable_shard_is_the_reference_s():
    from k8s_dra_driver_torch.scheduler.index import stable_shard as port_shard
    from k8s_dra_driver_tpu.scheduler.index import stable_shard as ref_shard

    names = [f"tpu-host-{i}" for i in range(64)] + ["", "node-0"]
    for n in (1, 2, 3, 7, 16):
        assert [port_shard(x, n) for x in names] == [ref_shard(x, n) for x in names]
