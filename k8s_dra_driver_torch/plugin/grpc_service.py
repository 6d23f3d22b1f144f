"""The port of ``k8s_dra_driver_tpu/plugin/grpc_service.py`` (lines 1-262; copied: the port
imports nothing of the JAX package), but for the stubs' generation: the
port loads the committed ``plugin/proto/gen`` modules and never runs
``protoc`` (the reference's ``_generate``, lines 31-63, rewrites them in the
source tree when a ``.proto`` file looks newer by mtime).  The protos and
their stubs are the reference's byte for byte, so the proto packages and
the method paths a kubelet dials are the upstream ones.

gRPC transport: the kubelet-facing DRA service over unix sockets.

Behavioral mirror of the vendored kubeletplugin helper the reference uses
(draplugin.go:40-62 Start, nonblockinggrpcserver.go, registrationserver.go —
SURVEY.md §2.5): two unix sockets, one serving the DRAPlugin service, one the
kubelet registration service.  Service handlers are registered through
grpc's generic handler API so no protoc grpc plugin is needed.
"""

from __future__ import annotations

import threading
from concurrent import futures
from importlib import import_module
from pathlib import Path

import grpc

from k8s_dra_driver_torch import DRIVER_NAME
from k8s_dra_driver_torch.plugin.driver import ClaimRef, Driver

SUPPORTED_VERSIONS = ["v1beta1"]

_modules = {}


def pb2(name: str):
    """Import a generated module (``dra`` or ``registration``)."""
    if name not in _modules:
        _modules[name] = import_module(
            f"k8s_dra_driver_torch.plugin.proto.gen.{name}_pb2"
        )
    return _modules[name]


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


def _dra_handlers(driver: Driver):
    d = pb2("dra")

    def prepare(request, context):
        refs = [
            ClaimRef(uid=c.uid, name=c.name, namespace=c.namespace)
            for c in request.claims
        ]
        results = driver.node_prepare_resources(refs)
        resp = d.NodePrepareResourcesResponse()
        for uid, res in results.items():
            claim_resp = d.NodePrepareResourceResponse(error=res.error)
            for dev in res.devices:
                claim_resp.devices.append(
                    d.Device(
                        request_names=dev["request_names"],
                        pool_name=dev["pool_name"],
                        device_name=dev["device_name"],
                        cdi_device_ids=dev["cdi_device_ids"],
                    )
                )
            resp.claims[uid].CopyFrom(claim_resp)
        return resp

    def unprepare(request, context):
        refs = [
            ClaimRef(uid=c.uid, name=c.name, namespace=c.namespace)
            for c in request.claims
        ]
        results = driver.node_unprepare_resources(refs)
        resp = d.NodeUnprepareResourcesResponse()
        for uid, res in results.items():
            resp.claims[uid].CopyFrom(d.NodeUnprepareResourceResponse(error=res.error))
        return resp

    return {
        "NodePrepareResources": grpc.unary_unary_rpc_method_handler(
            prepare,
            request_deserializer=d.NodePrepareResourcesRequest.FromString,
            response_serializer=d.NodePrepareResourcesResponse.SerializeToString,
        ),
        "NodeUnprepareResources": grpc.unary_unary_rpc_method_handler(
            unprepare,
            request_deserializer=d.NodeUnprepareResourcesRequest.FromString,
            response_serializer=d.NodeUnprepareResourcesResponse.SerializeToString,
        ),
    }


def _registration_handlers(endpoint: str, registered_event: threading.Event):
    r = pb2("registration")

    def get_info(request, context):
        return r.PluginInfo(
            type="DRAPlugin",
            name=DRIVER_NAME,
            endpoint=endpoint,
            supported_versions=SUPPORTED_VERSIONS,
        )

    def notify(request, context):
        if request.plugin_registered:
            registered_event.set()
        return r.RegistrationStatusResponse()

    return {
        "GetInfo": grpc.unary_unary_rpc_method_handler(
            get_info,
            request_deserializer=r.InfoRequest.FromString,
            response_serializer=r.PluginInfo.SerializeToString,
        ),
        "NotifyRegistrationStatus": grpc.unary_unary_rpc_method_handler(
            notify,
            request_deserializer=r.RegistrationStatus.FromString,
            response_serializer=r.RegistrationStatusResponse.SerializeToString,
        ),
    }


class PluginServer:
    """Serves the DRA plugin + registration services over unix sockets.

    ``plugin_dir`` maps to /var/lib/kubelet/plugins/<driver>/ and
    ``registry_dir`` to /var/lib/kubelet/plugins_registry/ (main.go:38-40).
    """

    def __init__(self, driver: Driver, plugin_dir: str, registry_dir: str):
        self.driver = driver
        self.plugin_socket = str(Path(plugin_dir) / "dra.sock")
        self.registry_socket = str(Path(registry_dir) / f"{DRIVER_NAME}-reg.sock")
        Path(plugin_dir).mkdir(parents=True, exist_ok=True)
        Path(registry_dir).mkdir(parents=True, exist_ok=True)
        self.registered = threading.Event()
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        self._server.add_generic_rpc_handlers(
            (
                grpc.method_handlers_generic_handler(
                    "k8s.io.kubelet.pkg.apis.dra.v1beta1.DRAPlugin", _dra_handlers(self.driver)
                ),
                grpc.method_handlers_generic_handler(
                    "pluginregistration.Registration",
                    _registration_handlers(self.plugin_socket, self.registered),
                ),
            )
        )
        self._server.add_insecure_port(f"unix:{self.plugin_socket}")
        self._server.add_insecure_port(f"unix:{self.registry_socket}")

    def start(self) -> None:
        self._server.start()

    def stop(self, grace: float = 1.0) -> None:
        self._server.stop(grace).wait()


# ---------------------------------------------------------------------------
# Client (kubelet side; used by tests and the demo harness)
# ---------------------------------------------------------------------------


class DRAClient:
    def __init__(self, socket_path: str):
        self._channel = grpc.insecure_channel(f"unix:{socket_path}")
        d = pb2("dra")
        self._prepare = self._channel.unary_unary(
            "/k8s.io.kubelet.pkg.apis.dra.v1beta1.DRAPlugin/NodePrepareResources",
            request_serializer=d.NodePrepareResourcesRequest.SerializeToString,
            response_deserializer=d.NodePrepareResourcesResponse.FromString,
        )
        self._unprepare = self._channel.unary_unary(
            "/k8s.io.kubelet.pkg.apis.dra.v1beta1.DRAPlugin/NodeUnprepareResources",
            request_serializer=d.NodeUnprepareResourcesRequest.SerializeToString,
            response_deserializer=d.NodeUnprepareResourcesResponse.FromString,
        )

    def node_prepare_resources(self, claims: list[ClaimRef]):
        d = pb2("dra")
        req = d.NodePrepareResourcesRequest(
            claims=[d.Claim(uid=c.uid, name=c.name, namespace=c.namespace) for c in claims]
        )
        return self._prepare(req)

    def node_unprepare_resources(self, claims: list[ClaimRef]):
        d = pb2("dra")
        req = d.NodeUnprepareResourcesRequest(
            claims=[d.Claim(uid=c.uid, name=c.name, namespace=c.namespace) for c in claims]
        )
        return self._unprepare(req)

    def close(self):
        self._channel.close()


class RegistrationClient:
    """Kubelet-side registration handshake (used by tests to validate the
    registration service the way kubelet would)."""

    def __init__(self, socket_path: str):
        self._channel = grpc.insecure_channel(f"unix:{socket_path}")
        r = pb2("registration")
        self._get_info = self._channel.unary_unary(
            "/pluginregistration.Registration/GetInfo",
            request_serializer=r.InfoRequest.SerializeToString,
            response_deserializer=r.PluginInfo.FromString,
        )
        self._notify = self._channel.unary_unary(
            "/pluginregistration.Registration/NotifyRegistrationStatus",
            request_serializer=r.RegistrationStatus.SerializeToString,
            response_deserializer=r.RegistrationStatusResponse.FromString,
        )

    def handshake(self):
        r = pb2("registration")
        info = self._get_info(r.InfoRequest())
        self._notify(r.RegistrationStatus(plugin_registered=True))
        return info

    def close(self):
        self._channel.close()
