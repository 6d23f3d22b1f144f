"""The port's kubelet-plugin binary (``k8s_dra_driver_torch/plugin/main.py``)
against the reference's, on the CPU.

``build_parser()`` gives the same options in both packages: option
strings, destinations, types, defaults and help, and the same defaults
again under every environment mirror set; ``resolve_topology_env`` reads
flags and node labels the same way.  Then the binary runs as a process:
``--fake-cluster`` on a fake v5e-16 host publishes its slice, serves the
registration handshake and ``NodePrepareResources`` on its sockets (the
reference's clients dial them), answers ``/healthz`` on its diagnostics
port, and exits 0 on SIGTERM; without ``--fake-cluster`` it dials the
API server of a kubeconfig through the port's REST client: against either
package's mock API it publishes its fake host's slice over HTTP, serves
the handshake and exits 0 on SIGTERM (the slice stays published, as the
reference's binary leaves it), and with no node name or an unreachable
server it returns 2, as the reference's does.
"""

import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import pytest

from k8s_dra_driver_torch.kube import fakeserver as port_fakeserver
from k8s_dra_driver_torch.kube import objects as port_objects
from k8s_dra_driver_torch.plugin import main as port_main
from k8s_dra_driver_tpu.kube import fakeserver as ref_fakeserver
from k8s_dra_driver_tpu.kube import objects as ref_objects
from k8s_dra_driver_tpu.plugin import grpc_service as ref_grpc
from k8s_dra_driver_tpu.plugin import main as ref_main

REPO_ROOT = Path(__file__).resolve().parent.parent
MIRRORS = re.findall(r'env_default\("([A-Z_]+)"', Path(ref_main.__file__).read_text())
# a value each mirror accepts (numbers for the typed options)
VALUES = {"HTTP_PORT": "8080", "CLEANUP_INTERVAL_S": "2.5", "TPU_SELFTEST_INTERVAL_S": "30",
          "FAKE_CLUSTER": "true"}


def _options(parser) -> list:
    return [(a.option_strings, a.dest, a.default, getattr(a.type, "__name__", a.type),
             a.help, a.nargs, a.const, a.required) for a in parser._actions]


def test_the_parser_is_the_reference_s(monkeypatch):
    for name in MIRRORS:
        monkeypatch.delenv(name, raising=False)
    assert _options(port_main.build_parser()) == _options(ref_main.build_parser())
    assert port_main.build_parser().prog == ref_main.build_parser().prog == "tpu-dra-plugin"
    assert len(MIRRORS) == 16


@pytest.mark.parametrize("mirror", MIRRORS)
def test_each_environment_mirror(monkeypatch, mirror):
    monkeypatch.setenv(mirror, VALUES.get(mirror, f"/from-env/{mirror.lower()}"))
    port_ns = vars(port_main.build_parser().parse_args([]))
    assert port_ns == vars(ref_main.build_parser().parse_args([]))
    defaults = vars(port_main.build_parser().parse_args([]))
    monkeypatch.delenv(mirror)
    assert defaults != vars(port_main.build_parser().parse_args([]))  # the mirror took


@pytest.mark.parametrize("flags,labels", [
    (("", ""), {}),
    (("v5e-16", "2"), {}),
    (("v5e-16", ""), {}),
    (("", ""), {"tpu.google.com/fake-topology": "v4-16", "tpu.google.com/fake-host-id": "1"}),
    (("v5e-8", ""), {"tpu.google.com/fake-host-id": "3"}),
])
def test_resolve_topology_env(flags, labels):
    got = {}
    for name, (mod, objects, fakeserver) in {
            "reference": (ref_main, ref_objects, ref_fakeserver),
            "port": (port_main, port_objects, port_fakeserver)}.items():
        server = fakeserver.InMemoryAPIServer()
        server.create(objects.Node(metadata=objects.ObjectMeta(name="n0", labels=labels)))
        got[name] = (mod.resolve_topology_env(server, "n0", *flags),
                     mod.resolve_topology_env(server, "missing", *flags))
    assert got["port"] == got["reference"]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPUINFO_", "TPU_")) and k not in MIRRORS}
    env["PYTHONPATH"] = os.pathsep.join(x for x in (str(REPO_ROOT), env.get("PYTHONPATH", ""))
                                        if x)
    return env


def _kubeconfig(path: Path, url: str, token: str = "") -> Path:
    path.write_text(json.dumps({
        "current-context": "c", "contexts": [{"name": "c", "context": {"cluster": "k",
                                                                       "user": "u"}}],
        "clusters": [{"name": "k", "cluster": {"server": url}}],
        "users": [{"name": "u", "user": {"token": token}}]}))
    return path


def test_without_a_cluster_it_returns_2(tmp_path):
    kubeconfig = _kubeconfig(tmp_path / "kc", "http://127.0.0.1:9")
    proc = subprocess.run([sys.executable, "-m", "k8s_dra_driver_torch.plugin.main",
                           "--node-name", "n0", "--kubeconfig", str(kubeconfig)], env=_env(),
                          capture_output=True, text=True, timeout=60, cwd=REPO_ROOT)
    assert proc.returncode == 2, proc.stderr
    assert "cannot reach an API server" in proc.stderr and "Traceback" not in proc.stderr
    proc = subprocess.run([sys.executable, "-m", "k8s_dra_driver_torch.plugin.main",
                           "--fake-cluster"], env=_env(), capture_output=True, text=True,
                          timeout=60, cwd=REPO_ROOT)
    assert proc.returncode == 2 and "--node-name (or NODE_NAME) is required" in proc.stderr


def test_fake_cluster_serves_and_stops_on_sigterm():
    root = Path(tempfile.mkdtemp(prefix="dra-main-", dir="/tmp"))
    lines: list[str] = []
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_dra_driver_torch.plugin.main", "--fake-cluster",
         "--fake-topology", "v5e-16", "--fake-host-id", "0", "--node-name", "tpu-host-0",
         "--cdi-root", str(root / "cdi"), "--plugin-path", str(root / "p"),
         "--registry-path", str(root / "r"), "--parted-state-path", str(root / "parted.json"),
         "--http-port", "0", "--cleanup-interval-s", "0.2"],
        env=_env(), cwd=REPO_ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    reader = threading.Thread(target=lambda: lines.extend(proc.stderr), daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 60
        while not any("serving on" in ln for ln in lines):
            assert proc.poll() is None and time.monotonic() < deadline, "".join(lines)
            time.sleep(0.05)
        text = "".join(lines)
        assert re.search(r"serving on \S+/p/dra\.sock \(registration: \S+/r/"
                         r"tpu\.google\.com-reg\.sock\); 9 devices published", text), text
        port = int(re.search(r"diagnostics on http://127\.0\.0\.1:(\d+)/metrics", text)[1])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert r.read() == b"ok"
        client = ref_grpc.RegistrationClient(str(root / "r" / "tpu.google.com-reg.sock"))
        info = client.handshake()
        client.close()
        assert (info.type, info.name, info.endpoint) == ("DRAPlugin", "tpu.google.com",
                                                         str(root / "p" / "dra.sock"))
        dra = ref_grpc.DRAClient(info.endpoint)
        resp = dra.node_prepare_resources([])
        dra.close()
        assert len(resp.claims) == 0
        time.sleep(0.5)  # two cleanup sweeps
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        reader.join(timeout=10)
        assert "shutting down" in "".join(lines)
        assert "Traceback" not in "".join(lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("mock", ["port", "reference"])
def test_over_a_kubeconfig_it_publishes_and_stops_on_sigterm(tmp_path, mock):
    """The binary without ``--fake-cluster``: its Node's labels (read over
    HTTP) give the fake topology, its slice appears in the mock's store,
    the handshake answers, and SIGTERM ends it with 0."""
    from k8s_dra_driver_tpu.e2e import mock_api as ref_mock_api
    from k8s_dra_driver_torch.e2e import mock_api as port_mock_api

    mock_api, objects = ((port_mock_api, port_objects) if mock == "port"
                         else (ref_mock_api, ref_objects))
    api = mock_api.MockKubeAPI(token="t0k").start()
    api.server.create(objects.Node(metadata=objects.ObjectMeta(name="tpu-host-1", labels={
        "tpu.google.com/fake-topology": "v5e-16", "tpu.google.com/fake-host-id": "1"})))
    root = Path(tempfile.mkdtemp(prefix="dra-rest-", dir="/tmp"))
    lines: list[str] = []
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_dra_driver_torch.plugin.main", "--node-name", "tpu-host-1",
         "--kubeconfig", str(_kubeconfig(tmp_path / "kc", api.url, "t0k")),
         "--cdi-root", str(root / "cdi"), "--plugin-path", str(root / "p"),
         "--registry-path", str(root / "r"), "--parted-state-path", str(root / "parted.json")],
        env=_env(), cwd=REPO_ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    reader = threading.Thread(target=lambda: lines.extend(proc.stderr), daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 60
        while not any("serving on" in ln for ln in lines):
            assert proc.poll() is None and time.monotonic() < deadline, "".join(lines)
            time.sleep(0.05)
        (published,) = api.server.list("ResourceSlice")
        client = ref_grpc.RegistrationClient(str(root / "r" / "tpu.google.com-reg.sock"))
        info = client.handshake()
        client.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        reader.join(timeout=10)
        after = [s.metadata.name for s in api.server.list("ResourceSlice")]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        api._closing.set()
        api.stop()
        shutil.rmtree(root, ignore_errors=True)
    text = "".join(lines)
    assert "9 devices published" in text and "Traceback" not in text, text
    assert published.spec.pool.name == "tpu-host-1" and len(published.spec.devices) == 9
    assert info.endpoint == str(root / "p" / "dra.sock") and "shutting down" in text
    assert after == [published.metadata.name]
