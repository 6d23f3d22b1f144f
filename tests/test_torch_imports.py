"""Import hygiene of the PyTorch port: in a fresh interpreter whose
meta-path finder refuses ``jax`` (and ``jaxlib``) and the JAX package
``k8s_dra_driver_tpu``, every module of ``k8s_dra_driver_torch`` (found by
``pkgutil.walk_packages``; the driver's node half, the allocator, the
closed-loop harness, the kubelet's gRPC face, the REST client, the mock
API server and the cluster controller among them) and
``chip_smoke.py`` (imported as a module, its ``main`` not run) import."""

import json
import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent

PROBE = r'''
import importlib
import importlib.abc
import importlib.util
import json
import pkgutil
import sys

REFUSED = ("jax", "jaxlib", "k8s_dra_driver_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}")
        return None


# whatever the interpreter's start-up imported of them goes too
for name in [m for m in sys.modules if m.split(".")[0] in REFUSED]:
    del sys.modules[name]
sys.meta_path.insert(0, Refuse())
import k8s_dra_driver_torch

failed, names = {}, ["k8s_dra_driver_torch"]
for info in pkgutil.walk_packages(k8s_dra_driver_torch.__path__, "k8s_dra_driver_torch."):
    names.append(info.name)
for name in names:
    try:
        importlib.import_module(name)
    except Exception as exc:
        failed[name] = f"{type(exc).__name__}: {exc}"
spec = importlib.util.spec_from_file_location("chip_smoke_probe", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
try:
    spec.loader.exec_module(smoke)
    if not callable(getattr(smoke, "main", None)):
        failed["chip_smoke.py"] = "no main()"
except Exception as exc:
    failed["chip_smoke.py"] = f"{type(exc).__name__}: {exc}"
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
print(json.dumps({"modules": names, "failed": failed, "leaked": leaked}))
'''


def test_every_port_module_and_the_smoke_import_without_jax(tmp_path):
    proc = subprocess.run([sys.executable, "-c", PROBE, str(REPO_ROOT / "chip_smoke.py")],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO_ROOT),
                               "HOME": str(tmp_path), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc["failed"] == {} and doc["leaked"] == []
    names = set(doc["modules"])
    assert {"k8s_dra_driver_torch.models.disagg", "k8s_dra_driver_torch.models.transport",
            "k8s_dra_driver_torch.models.obs_plane", "k8s_dra_driver_torch.entry"} <= names
    node_half = {f"k8s_dra_driver_torch.{m}" for m in (
        "version", "utils.fileio", "kube", "kube.quantity", "kube.objects", "kube.serde",
        "kube.fakeserver", "kube.resourceslice_controller", "api", "api.sharing",
        "api.tpuconfig", "api.decoder", "tpuinfo.binding", "plugin", "plugin.geometry",
        "plugin.parted", "plugin.deviceinfo", "plugin.root", "plugin.cdi", "plugin.checkpoint",
        "plugin.prepared", "plugin.topology_daemon", "plugin.sharing", "plugin.device_state",
        "plugin.driver")}
    assert node_half <= names
    closed_loop = {f"k8s_dra_driver_torch.{m}" for m in (
        "utils.logging", "utils.diagnostics", "scheduler", "scheduler.cel", "scheduler.index",
        "scheduler.allocator", "e2e.harness", "e2e.spec_runner", "plugin.grpc_service",
        "plugin.main")}
    assert closed_loop <= names
    cluster_side = {f"k8s_dra_driver_torch.{m}" for m in (
        "kube.restclient", "e2e.mock_api", "controller", "controller.leaderelection",
        "controller.slice_manager", "controller.main")}
    assert cluster_side <= names
    assert len(names) >= 91
