"""The port of ``k8s_dra_driver_tpu/controller/main.py`` (copied: the port
imports nothing of the JAX package).  ``build_parser`` is the reference's,
extender flags included; the scheduler extender is not in the port
(ROADMAP item 23), so ``--extender-port >= 0`` logs an error naming it and
returns 2 before any component starts.

Controller binary: ``python -m k8s_dra_driver_torch.controller.main``.

Mirror of cmd/nvidia-dra-controller/main.go (241 LoC): flags with env
mirrors, optional HTTP diagnostics endpoint (/metrics, /healthz), the slice
manager started only when the membership device class is enabled; without
``--fake-cluster`` it dials the API server through the REST client
(``--kubeconfig``, then ``$KUBECONFIG``, then the in-cluster service
account) and returns 2 when the probe fails."""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from k8s_dra_driver_torch.controller.slice_manager import SliceManager
from k8s_dra_driver_torch.e2e.harness import install_device_classes
from k8s_dra_driver_torch.kube.fakeserver import InMemoryAPIServer
from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.logging import get_logger

log = get_logger("tpu-dra-controller")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("tpu-dra-controller")
    p.add_argument(
        "--device-classes",
        default=os.environ.get("DEVICE_CLASSES", "tpu,subslice,membership"),
        help="comma-separated enabled classes; membership enables the slice manager",
    )
    p.add_argument(
        "--retry-timeout-s",
        type=float,
        default=float(os.environ.get("RETRY_TIMEOUT_S", "60")),
    )
    p.add_argument(
        "--fake-cluster", action="store_true",
        default=os.environ.get("FAKE_CLUSTER", "") == "true",
    )
    p.add_argument(
        "--kubeconfig", default=os.environ.get("KUBECONFIG_PATH", ""),
        help="kubeconfig path; empty = $KUBECONFIG, then in-cluster service account",
    )
    p.add_argument(
        "--http-port", type=int, default=int(os.environ.get("HTTP_PORT", "-1")),
        help="diagnostics endpoint port (/metrics,/healthz); -1 disables, 0 = ephemeral",
    )
    p.add_argument(
        "--leader-elect", action="store_true",
        default=os.environ.get("LEADER_ELECT", "") == "true",
        help="coordinate multiple controller replicas via a coordination.k8s.io Lease",
    )
    p.add_argument(
        "--extender-port", type=int,
        default=int(os.environ.get("EXTENDER_PORT", "-1")),
        help="kube-scheduler extender webhook port (/filter,/prioritize,/bind); "
        "-1 disables, 0 = ephemeral",
    )
    p.add_argument(
        "--extender-tls-cert", default=os.environ.get("EXTENDER_TLS_CERT", ""),
        help="PEM certificate for the extender webhook; with --extender-tls-key, "
        "serves HTTPS (scheduler policy side: enableHTTPS: true)",
    )
    p.add_argument(
        "--extender-tls-key", default=os.environ.get("EXTENDER_TLS_KEY", ""),
        help="PEM private key for the extender webhook",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.extender_port >= 0:
        # The scheduler extender (the reference's scheduler/extender.py) is
        # not in the port: refuse before anything starts, never serve a
        # half-configured webhook.
        log.error(
            "--extender-port %d: the port has no scheduler extender "
            "(scheduler/extender.py is ROADMAP item 23); run without it",
            args.extender_port,
        )
        return 2
    JOURNAL.record(
        "controller", "start",
        device_classes=args.device_classes, fake_cluster=args.fake_cluster,
    )
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

    manager = None
    elector_thread = None
    elector_stop = threading.Event()
    if "membership" in args.device_classes.split(","):
        manager = SliceManager(server, retry_timeout_s=args.retry_timeout_s)
        if args.leader_elect:
            import socket

            from k8s_dra_driver_torch.controller.leaderelection import (
                LeaderElectionConfig,
                LeaderElector,
            )

            identity = os.environ.get("POD_NAME", socket.gethostname())
            elector = LeaderElector(server, LeaderElectionConfig(identity=identity))

            def started():
                log.info("acquired leadership (%s); starting slice manager", identity)
                JOURNAL.record("controller", "leadership.acquired", correlation=identity)
                manager.start()

            def stopped():
                log.info("lost leadership; stopping slice manager")
                JOURNAL.record("controller", "leadership.lost", correlation=identity)
                # Keep owned slices: the new leader publishes over them.
                manager.stop(delete_owned=False)

            elector_thread = threading.Thread(
                target=elector.run, args=(started, stopped, elector_stop), daemon=True
            )
            elector_thread.start()
        else:
            manager.start()
            log.info("slice manager watching node slice-domain labels")

    diagnostics = None
    if args.http_port >= 0:
        from k8s_dra_driver_torch.utils.diagnostics import DiagnosticsServer

        diagnostics = DiagnosticsServer(
            port=args.http_port,
            state_provider=lambda: {
                "domains": manager.domains() if manager else {},
            },
        )
        diagnostics.start()
        log.info("diagnostics on http://127.0.0.1:%d/metrics", diagnostics.port)

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    JOURNAL.record("controller", "running")
    # Retry loop for transiently-failed domains (imex.go:131-151).
    while not stop.wait(timeout=1.0):
        if manager is not None:
            manager.retry_pending()
    if diagnostics is not None:
        diagnostics.stop()
    if elector_thread is not None:
        elector_stop.set()
        elector_thread.join(timeout=5)
    elif manager is not None:
        manager.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
