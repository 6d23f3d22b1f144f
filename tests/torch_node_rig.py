"""Shared inputs of the node driver's CPU tests (``tests/test_torch_kube.py``,
``test_torch_plugin.py``): one rig a package, the reference's driver and
the port's, each over its own in-memory API server and its own CDI root
and checkpoint, fed the same claims and slices as wire documents."""

from __future__ import annotations

import dataclasses
from pathlib import Path

from k8s_dra_driver_torch.kube import fakeserver as port_fakeserver
from k8s_dra_driver_torch.kube import objects as port_objects
from k8s_dra_driver_torch.plugin import deviceinfo as port_deviceinfo
from k8s_dra_driver_torch.plugin import driver as port_driver
from k8s_dra_driver_tpu.kube import fakeserver as ref_fakeserver
from k8s_dra_driver_tpu.kube import objects as ref_objects
from k8s_dra_driver_tpu.plugin import deviceinfo as ref_deviceinfo
from k8s_dra_driver_tpu.plugin import driver as ref_driver

DRIVER = "tpu.google.com"
CONFIG_API = "resource.tpu.google.com/v1alpha1"
NODE = "tpu-host-0"
DOMAIN_POOL = "slice-domain-a"
GROUP_POOL = "slice-group-g"

PACKAGES = {
    "reference": (ref_objects, ref_fakeserver, ref_driver, ref_deviceinfo),
    "port": (port_objects, port_fakeserver, port_driver, port_deviceinfo),
}


def mark_daemons_ready(server) -> None:
    """The deployment controller's part: a topology-daemon Deployment is
    ready as soon as it appears."""

    def on_event(event):
        dep = event.object
        if event.type == "ADDED" and not (dep.status or {}).get("readyReplicas"):
            dep.status = {"readyReplicas": 1}
            server.update(dep)

    server.watch("Deployment", on_event)


@dataclasses.dataclass
class Side:
    name: str
    objects: object
    server: object
    driver: object
    root: Path

    def create(self, doc: dict):
        return self.server.create(self.objects.from_json(doc))

    def cdi_files(self) -> dict[str, bytes]:
        cdi = self.root / "cdi"
        return {p.name: p.read_bytes() for p in sorted(cdi.glob("*.json"))}

    def checkpoint_bytes(self) -> bytes:
        path = self.root / "checkpoint.json"
        return path.read_bytes() if path.exists() else b""

    def slices(self) -> list[dict]:
        """The published ResourceSlices as wire documents, by name, each
        without its random uid."""
        out = []
        for s in self.server.list("ResourceSlice"):
            doc = self.objects.to_json(s)
            doc["metadata"].pop("uid", None)
            out.append(doc)
        return sorted(out, key=lambda d: d["metadata"]["name"])


def make_side(name: str, tmp_path: Path, topology_env: dict, *, seats: bool = False,
              **config) -> Side:
    objects, fakeserver, driver, deviceinfo = PACKAGES[name]
    server = fakeserver.InMemoryAPIServer()
    mark_daemons_ready(server)
    if seats:
        for doc in seat_slices(deviceinfo, objects):
            server.create(objects.from_json(doc))
    root = tmp_path / name
    drv = driver.Driver(server, driver.DriverConfig(
        node_name=NODE,
        cdi_root=str(root / "cdi"),
        checkpoint_path=str(root / "checkpoint.json"),
        topology_env=dict(topology_env),
        daemon_backoff_initial=0.001,
        daemon_backoff_steps=2,
        **config,
    ))
    return Side(name, objects, server, drv, root)


def make_pair(tmp_path: Path, topology_env: dict, **kw) -> tuple[Side, Side]:
    """(the reference's side, the port's side) on the same topology."""
    return (make_side("reference", tmp_path, topology_env, **kw),
            make_side("port", tmp_path, topology_env, **kw))


def seat_slices(deviceinfo, objects) -> list[dict]:
    """The cluster controller's seat pools: a slice domain's membership
    seats and a slice group's seats, as that package publishes them."""
    members = [deviceinfo.SliceMembershipInfo(domain="domain-a", worker_id=w, host_count=4,
                                              coordinator_address="10.0.0.1:8476")
               for w in range(4)]
    seats = [deviceinfo.SliceGroupSeatInfo(group="group-g", domain="domain-a", slice_id=1,
                                           num_slices=2, worker_id=w, host_count=4,
                                           coordinator_address="10.0.1.1:8476")
             for w in range(4)]
    out = []
    for pool, infos in ((DOMAIN_POOL, members), (GROUP_POOL, seats)):
        out.append(objects.to_json(objects.ResourceSlice(
            metadata=objects.ObjectMeta(name=f"{DRIVER}-{pool}-0"),
            spec=objects.ResourceSliceSpec(
                driver=DRIVER, pool=objects.ResourcePool(name=pool, generation=1),
                all_nodes=True, devices=[i.get_device() for i in infos]),
        )))
    return out


def claim_doc(name: str, uid: str, results, config=(), namespace: str = "default") -> dict:
    """A ResourceClaim as kube-scheduler leaves it: ``results`` (request,
    pool, device) triples, ``config`` (requests, opaque parameters) pairs
    from the claim."""
    requests = sorted({r for r, _, _ in results})
    return {
        "apiVersion": "resource.k8s.io/v1beta1",
        "kind": "ResourceClaim",
        "metadata": {"name": name, "namespace": namespace, "uid": uid},
        "spec": {"devices": {"requests": [{"name": r, "deviceClassName": DRIVER}
                                          for r in requests]}},
        "status": {"allocation": {"devices": {
            "results": [{"request": r, "driver": DRIVER, "pool": p, "device": d}
                        for r, p, d in results],
            "config": [{"source": "FromClaim", "requests": list(reqs),
                        "opaque": {"driver": DRIVER, "parameters": params}}
                       for reqs, params in config],
        }}},
    }


def tpu_config(strategy: str, **sharing) -> dict:
    body = {"strategy": strategy, **sharing}
    return {"apiVersion": CONFIG_API, "kind": "TpuConfig", "sharing": body}


def result_dicts(results: dict) -> dict:
    return {uid: dataclasses.asdict(r) for uid, r in results.items()}


def claim_ref(side: Side, doc: dict):
    meta = doc["metadata"]
    return PACKAGES[side.name][2].ClaimRef(uid=meta["uid"], name=meta["name"],
                                           namespace=meta["namespace"])
