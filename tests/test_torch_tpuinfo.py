"""The port's enumerator (``k8s_dra_driver_torch/tpuinfo/binding.py`` over
``tpuinfo/cpp/tpuinfo.cc``) against the reference's, on the CPU.

Fake mode: across fake topologies, host ids and dead chips, the same
``TopologyInfo`` or the same error.  Real mode: without a card (this
machine) it raises ``TpuInfoError`` and falls back to nothing; against a
stand-in ``libcuda.so.1`` (built here with ``g++``) it names the CUDA
driver's errors and refuses cards whose device nodes it cannot find.  The
shim builds once per source hash; ``python -m
k8s_dra_driver_torch.tpuinfo.binding`` enumerates without importing torch.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from k8s_dra_driver_torch.tpuinfo import binding as port_binding
from k8s_dra_driver_tpu.tpuinfo import binding as ref_binding

REPO = Path(__file__).resolve().parent.parent


def _enumerate(binding, env):
    try:
        return ("ok", dataclasses.asdict(binding.enumerate_topology(env)))
    except binding.TpuInfoError as exc:
        return ("error", str(exc))


SPECS = ["v5e-1", "v5e-4", "v5e-8", "v5e-16", "v5e-64", "v6e-8", "v6e-32", "v4-4", "v4-8",
         "v4-16", "v5p-16", "v5p-128", "v4-2x2x4", "v5e-4x8", "v5e-3", "v4-3x3", "v4-4x3x1",
         "v5e", "v9-4", "v5e-0", "v5e-x4", "v4-2x2x2x2", "v5e-2x", "tpu"]
HOSTS = ["", "0", "1", "3", "-1", "15"]
DEAD = ["", "1,3", "0,99,x", "2"]


@pytest.mark.parametrize("spec", SPECS)
def test_fake_mode_equals_the_reference(spec):
    for host in HOSTS:
        for dead in DEAD:
            env = {"TPUINFO_FAKE_TOPOLOGY": spec, "TPUINFO_FAKE_HOST_ID": host,
                   "TPUINFO_FAKE_DEAD_CHIPS": dead}
            assert _enumerate(port_binding, env) == _enumerate(ref_binding, env), env


def test_the_surface_equals_the_reference():
    assert port_binding.library_version() == ref_binding.library_version()
    topo = port_binding.enumerate_topology({"TPUINFO_FAKE_TOPOLOGY": "v4-16"})
    assert topo.total_chips == 16 and isinstance(topo.chips[0], port_binding.ChipInfo)
    assert [f.name for f in dataclasses.fields(port_binding.TopologyInfo)] == \
        [f.name for f in dataclasses.fields(ref_binding.TopologyInfo)]
    assert [f.name for f in dataclasses.fields(port_binding.ChipInfo)] == \
        [f.name for f in dataclasses.fields(ref_binding.ChipInfo)]


def test_the_shim_builds_once_per_source_hash():
    path = port_binding.build()
    assert path == port_binding.library_path() and path.exists()
    assert path.parent == REPO / "build" / "torch_tpuinfo"
    assert port_binding.build() == path


def test_real_mode_without_a_card_raises(monkeypatch):
    monkeypatch.delenv("TPUINFO_FAKE_TOPOLOGY", raising=False)
    with pytest.raises(port_binding.TpuInfoError, match="libcuda.so.1 not loadable"):
        port_binding.enumerate_topology()
    # an empty fake spec is real mode too, never a fake fallback
    with pytest.raises(port_binding.TpuInfoError):
        port_binding.enumerate_topology({"TPUINFO_FAKE_TOPOLOGY": ""})


# A stand-in for the CUDA driver: CARDS cards (0 makes cuInit fail with
# CUDA_ERROR_NO_DEVICE), each with fixed answers.
STUB = r"""
#include <cstdlib>
#include <cstring>
extern "C" {
static int cards() { const char* v = getenv("STUB_CARDS"); return v ? atoi(v) : 0; }
int cuInit(unsigned) { return cards() ? 0 : 100; }
int cuDriverGetVersion(int* v) { *v = 12040; return 0; }
int cuDeviceGetCount(int* n) { *n = cards(); return 0; }
int cuDeviceGet(int* d, int i) { *d = i; return i < cards() ? 0 : 101; }
int cuDeviceGetName(char* s, int n, int) { strncpy(s, "NVIDIA H100 80GB HBM3", n); return 0; }
int cuDeviceTotalMem_v2(size_t* b, int) { *b = 85899345920ull; return 0; }
int cuDeviceGetAttribute(int* v, int a, int d) {
  *v = a == 16 ? 132 : a == 33 ? 0x40 - 0x10 * d : 0; return 0; }
int cuDeviceGetUuid_v2(unsigned char* u, int d) { for (int i = 0; i < 16; i++) u[i] = i + d; return 0; }
int cuGetErrorName(int rc, const char** s) { *s = rc == 100 ? "CUDA_ERROR_NO_DEVICE" : "OTHER"; return 0; }
}
"""


@pytest.fixture(scope="module")
def stub_libcuda(tmp_path_factory):
    d = tmp_path_factory.mktemp("libcuda")
    (d / "stub.cc").write_text(STUB)
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(d / "libcuda.so.1"), str(d / "stub.cc")],
                   check=True)
    return d


def _real_mode_child(stub_dir, cards: int):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUINFO_")}
    env.update(LD_LIBRARY_PATH=str(stub_dir), STUB_CARDS=str(cards), PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", "k8s_dra_driver_torch.tpuinfo.binding"],
                          env=env, capture_output=True, text=True, timeout=60, cwd=REPO)


def test_real_mode_names_the_driver_error(stub_libcuda):
    proc = _real_mode_child(stub_libcuda, 0)
    assert proc.returncode == 1 and proc.stdout == ""
    assert "cuInit failed: CUDA error 100 (CUDA_ERROR_NO_DEVICE)" in proc.stderr


def test_real_mode_refuses_cards_without_device_nodes(stub_libcuda):
    if any(Path(p).exists() for p in ("/dev/nvidia0", "/dev/nvidiactl", "/proc/driver/nvidia")):
        pytest.skip("this machine has the NVIDIA driver: the stand-in's cards would meet "
                    "real device nodes")
    proc = _real_mode_child(stub_libcuda, 2)
    assert proc.returncode == 1 and proc.stdout == ""
    assert "found 2 NVIDIA card(s) but 0 /dev/nvidia<N> node(s)" in proc.stderr


def test_the_command_enumerates_without_torch():
    code = ("import json, sys, runpy; sys.argv = ['binding'];\n"
            "try:\n    runpy.run_module('k8s_dra_driver_torch.tpuinfo.binding', "
            "run_name='__main__')\nexcept SystemExit as e:\n    rc = e.code\n"
            "print(json.dumps({'rc': rc, 'torch': 'torch' in sys.modules}))")
    env = dict(os.environ, TPUINFO_FAKE_TOPOLOGY="v5e-8", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=60, cwd=REPO)
    topo_line, status_line = proc.stdout.strip().splitlines()
    assert json.loads(status_line) == {"rc": 0, "torch": False}
    want = dataclasses.asdict(ref_binding.enumerate_topology({"TPUINFO_FAKE_TOPOLOGY": "v5e-8"}))
    assert json.loads(topo_line) == json.loads(json.dumps(want))
