"""The port of ``k8s_dra_driver_tpu/plugin/main.py`` (copied: the port
imports nothing of the JAX package).

Kubelet-plugin binary: ``python -m k8s_dra_driver_torch.plugin.main``.

Mirror of cmd/nvidia-dra-plugin/main.go (206 LoC): every flag has an env-var
mirror, socket dirs default to the kubelet plugin paths, lifecycle is
signal-driven.  Without a reachable cluster the binary runs against the
in-process API server (``--fake-cluster``), which is also how the kind-less
demo harness exercises it; a real client-go-equivalent transport is a
deployment concern this repo stubs deliberately (zero-egress environment).

Without ``--fake-cluster`` the port dials the API server through its REST
client (``kube/restclient.py``: ``--kubeconfig``, then ``$KUBECONFIG``,
then the in-cluster service account) and returns 2 when the probe fails,
as the reference's does.  A node without a fake topology enumerates its
NVIDIA cards through ``tpuinfo/binding.py`` (the driver's real mode).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from k8s_dra_driver_torch import DRIVER_NAME
from k8s_dra_driver_torch.e2e.harness import install_device_classes
from k8s_dra_driver_torch.kube.fakeserver import InMemoryAPIServer
from k8s_dra_driver_torch.plugin.driver import Driver, DriverConfig
from k8s_dra_driver_torch.plugin.grpc_service import PluginServer
from k8s_dra_driver_torch.utils.logging import get_logger

log = get_logger("tpu-dra-plugin")


def env_default(name: str, default: str) -> str:
    return os.environ.get(name, default)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("tpu-dra-plugin")
    p.add_argument("--node-name", default=env_default("NODE_NAME", ""), help="K8s node name")
    p.add_argument(
        "--namespace", default=env_default("NAMESPACE", "tpu-dra-driver"),
        help="namespace for topology-daemon Deployments",
    )
    p.add_argument("--cdi-root", default=env_default("CDI_ROOT", "/var/run/cdi"))
    p.add_argument(
        "--plugin-path",
        default=env_default("PLUGIN_PATH", f"/var/lib/kubelet/plugins/{DRIVER_NAME}"),
    )
    p.add_argument(
        "--registry-path",
        default=env_default("REGISTRY_PATH", "/var/lib/kubelet/plugins_registry"),
    )
    p.add_argument("--driver-root", default=env_default("DRIVER_ROOT", ""))
    p.add_argument("--libtpu-path", default=env_default("LIBTPU_PATH", "/lib/libtpu.so"))
    p.add_argument(
        "--fake-topology", default=env_default("TPUINFO_FAKE_TOPOLOGY", ""),
        help="run against a synthetic topology (e.g. v5e-16) instead of /dev/accel*; "
        "empty falls back to this node's tpu.google.com/fake-topology label",
    )
    p.add_argument(
        "--fake-host-id", default=env_default("TPUINFO_FAKE_HOST_ID", ""),
        help="host index within the fake topology; empty falls back to this "
        "node's tpu.google.com/fake-host-id label, then 0 (per-node labels "
        "let ONE DaemonSet drive a heterogeneous multi-node fake cluster)",
    )
    p.add_argument(
        "--fake-cluster", action="store_true",
        default=env_default("FAKE_CLUSTER", "") == "true",
        help="serve against an in-process API server (demo/e2e mode; env FAKE_CLUSTER=true)",
    )
    p.add_argument(
        "--kubeconfig", default=env_default("KUBECONFIG_PATH", ""),
        help="kubeconfig path; empty = $KUBECONFIG, then in-cluster service account",
    )
    p.add_argument(
        "--http-port", type=int, default=int(env_default("HTTP_PORT", "-1")),
        help="diagnostics endpoint port (/metrics,/healthz); -1 disables, 0 = ephemeral",
    )
    p.add_argument(
        "--cleanup-interval-s", type=float,
        default=float(env_default("CLEANUP_INTERVAL_S", "60")),
        help="orphan-cleanup sweep period",
    )
    p.add_argument(
        "--parted-state-path",
        default=env_default("PARTED_STATE_PATH", "/etc/tpu-dra-driver/tpu-parted-state.json"),
        help="tpu-parted applied-layout file; shapes republish live when it "
        "changes (mig-parted analog, plugin/parted.py)",
    )
    p.add_argument(
        "--selftest-interval-s", type=float,
        default=float(env_default("TPU_SELFTEST_INTERVAL_S", "0")),
        help="on-chip runtime self-test period folded into the health sweep "
        "(tpuinfo/selftest.py); 0 disables",
    )
    p.add_argument(
        "--visible-chips", default=env_default("VISIBLE_CHIPS", ""),
        help="comma-separated LOCAL chip positions this plugin publishes "
        "(nvkind params-masking analog); empty falls back to this node's "
        "tpu.google.com/visible-chips label, then all chips",
    )
    return p


def _node_labels(server, node_name: str) -> dict[str, str]:
    """This node's labels, or {} when the Node object is unreadable (the
    fake-knob fallback must never block startup on real hardware)."""
    try:
        node = server.get("Node", node_name)
        return dict(node.metadata.labels or {})
    except Exception:
        return {}


def resolve_topology_env(
    server, node_name, fake_topology, fake_host_id, labels=None
) -> dict[str, str]:
    """Fake-backend knobs: flag/env first, then this node's labels — so a
    single DaemonSet drives a multi-node fake cluster where every kind
    worker carries its own topology/host-id labels (the reference needs
    nvkind + params masking for per-node device subsets, values.yaml:41-48;
    our fake backend makes it declarative).  {} = real hardware mode.
    ``labels``: pre-fetched node labels (None = fetch here) so callers with
    several label-driven knobs pay ONE Node GET."""
    if not fake_topology or not fake_host_id:
        if labels is None:
            labels = _node_labels(server, node_name)
        fake_topology = fake_topology or labels.get("tpu.google.com/fake-topology", "")
        fake_host_id = fake_host_id or labels.get("tpu.google.com/fake-host-id", "0")
    if not fake_topology:
        return {}
    return {
        "TPUINFO_FAKE_TOPOLOGY": fake_topology,
        "TPUINFO_FAKE_HOST_ID": fake_host_id,
    }


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if not args.node_name:
        log.error("--node-name (or NODE_NAME) is required")
        return 2
    if args.fake_cluster:
        server = InMemoryAPIServer()
        install_device_classes(server)
    else:
        from k8s_dra_driver_torch.kube.restclient import KubeClientConfig, RESTClient

        try:
            server = RESTClient(KubeClientConfig.load(args.kubeconfig))
            server.probe()  # fail fast on unreachable server / bad auth
        except Exception as exc:
            log.error("cannot reach an API server (%s); use --fake-cluster for demos", exc)
            return 2
    labels = None
    if (
        not (args.fake_topology and args.fake_host_id)
        or not args.visible_chips
    ):
        labels = _node_labels(server, args.node_name)
    topology_env = resolve_topology_env(
        server, args.node_name, args.fake_topology, args.fake_host_id,
        labels=labels,
    )
    visible_chips = args.visible_chips or (labels or {}).get(
        "tpu.google.com/visible-chips", ""
    )
    driver = Driver(
        server,
        DriverConfig(
            node_name=args.node_name,
            namespace=args.namespace,
            cdi_root=args.cdi_root,
            checkpoint_path=os.path.join(args.plugin_path, "checkpoint.json"),
            driver_root=args.driver_root,
            libtpu_path=args.libtpu_path,
            topology_env=topology_env,
            parted_state_path=args.parted_state_path,
            selftest_interval_s=args.selftest_interval_s,
            visible_chips=visible_chips,
        ),
    )
    plugin = PluginServer(driver, plugin_dir=args.plugin_path, registry_dir=args.registry_path)
    plugin.start()
    diagnostics = None
    if args.http_port >= 0:
        from k8s_dra_driver_torch.utils.diagnostics import DiagnosticsServer

        diagnostics = DiagnosticsServer(
            port=args.http_port,
            state_provider=lambda: {
                "node": args.node_name,
                "allocatable": sorted(driver.state.allocatable.devices),
                "prepared_claims": driver.state.prepared_claim_uids(),
            },
        )
        diagnostics.start()
        log.info("diagnostics on http://127.0.0.1:%d/metrics", diagnostics.port)
    log.info(
        "driver %s serving on %s (registration: %s); %d devices published",
        DRIVER_NAME,
        plugin.plugin_socket,
        plugin.registry_socket,
        len(driver.state.allocatable),
    )

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    # Periodic orphan-cleanup sweep (driver.go:156-168's missing loop).  A
    # failing sweep must never take down the node's DRA driver — log and
    # retry next period (transient API errors are expected).
    while not stop.wait(timeout=args.cleanup_interval_s):
        # Health and cleanup fail independently: a wedged enumeration must
        # not starve orphan cleanup, and vice versa.
        try:
            if driver.refresh_inventory():
                log.warning("inventory changed; republished ResourceSlices")
        except Exception:
            log.exception("health sweep failed; will retry")
        try:
            cleaned = driver.cleanup_orphans()
            if any(cleaned.values()):
                log.info("orphan cleanup: %s", cleaned)
        except Exception:
            log.exception("orphan cleanup sweep failed; will retry")
    log.info("shutting down")
    if diagnostics is not None:
        diagnostics.stop()
    plugin.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
