"""The port of ``k8s_dra_driver_tpu/utils/diagnostics.py`` (lines 1-243; copied: the port
imports nothing of the JAX package).

HTTP diagnostics endpoint: /metrics, /healthz, /debug/*.

Mirror of the controller's SetupHTTPEndpoint (cmd/nvidia-dra-controller/
main.go:194-241, promhttp + pprof), extended to both binaries — the
reference's plugin has no diagnostics at all (SURVEY.md §5).

Endpoints (ARCHITECTURE.md "Observability" documents the inventory):

* ``/metrics``        — Prometheus text exposition of the process registry
* ``/healthz``        — liveness: ``ok``
* ``/debug/state``    — the owner's ``state_provider()`` snapshot (JSON)
* ``/debug/traces``   — the tracer ring's recent spans (JSON)
* ``/debug/journal``  — the flight recorder's tail (JSON); filters:
  ``?limit=N&correlation=<id>&component=<name>``
* ``/debug/stacks``   — every Python thread's stack (JSON) — what
  tools/diag_bundle.py pulls to bundle a LIVE process without attaching
  a debugger
* ``/debug/serve``    — per-engine ``EngineStats`` snapshots plus recent
  request traces from every live serving engine in the process (JSON);
  filters: ``?request_id=N`` (full timeline for one correlation id) and
  ``?limit=N`` (recent-trace ring depth).  This is the fleet
  load-signal contract: a router scrapes it to weigh replicas.
* ``/debug/fleet``    — every live :class:`~k8s_dra_driver_torch.models.
  fleet.FleetRouter`'s view: per-replica health state (healthy/suspect/
  evacuating/drained), breaker state, last verdict and cached
  ``EngineStats``, plus the fleet front-door queue depth and parked
  evacuees (JSON).
* ``/debug/disagg``   — every live :class:`~k8s_dra_driver_torch.models.
  disagg.DisaggRouter`'s view: prefill/decode pool membership (full
  fleet stats per pool), staged handoffs, in-flight transfers and the
  channel's claim/budget/outcome tally (JSON).
* ``/debug/transport`` — every live :class:`~k8s_dra_driver_torch.models.
  transport.TransportChannel`'s view: the link's breaker state and
  cooldown, liveness (pong age, RTT), reconnect count, reclaimed-stream
  count and the channel's claim/budget/outcome tally — plus every live
  :class:`~k8s_dra_driver_torch.models.transport.RemotePool`'s pending/
  resident/failed stream counts (JSON).
* ``/debug/autoscale`` — every live :class:`~k8s_dra_driver_torch.models.
  autoscaler.FleetAutoscaler`'s view: policy thresholds, vote streaks,
  pending spawns, SLO attainment window and the latest decision doc
  (JSON).
* ``/debug/fleet-journal`` — the observability plane's merged,
  instance-tagged journal: every federated worker's flight-recorder
  tail interleaved with the local process's, ordered by event
  timestamp (JSON); filters: ``?limit=N&correlation=<id>&
  component=<name>&instance=<worker>``.
* ``/debug/fleet-traces`` — merged cross-process span trees: every
  federated worker's spans skew-normalized into the control plane's
  monotonic domain and joined with local spans by trace/span/parent
  ids (JSON); filters: ``?trace_id=<id>&limit=N``.

``/metrics`` federates automatically: when the observability plane
(models/obs_plane.py) is loaded and has ingested TELEM snapshots, the
local render is followed by every worker's registry rewritten under
its ``instance=`` label.  Without the plane loaded the endpoint is
byte-identical to the plain local render — control-plane binaries pay
nothing for the feature they don't use.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from k8s_dra_driver_torch.utils.journal import JOURNAL, Journal
from k8s_dra_driver_torch.utils.metrics import REGISTRY, Registry
from k8s_dra_driver_torch.utils.tracing import TRACER


class DiagnosticsServer:
    def __init__(
        self,
        port: int = 0,
        registry: Registry = REGISTRY,
        state_provider: Optional[Callable[[], dict]] = None,
        bind_host: str = "0.0.0.0",
        journal: Journal = JOURNAL,
    ):
        """``bind_host`` defaults to all interfaces so in-cluster scrapes and
        kubelet probes (which hit the pod IP) can reach the endpoint."""
        registry_ref = registry
        state_ref = state_provider or (lambda: {})
        journal_ref = journal

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                url = urllib.parse.urlsplit(self.path)
                query = urllib.parse.parse_qs(url.query)
                if url.path == "/metrics":
                    # Federate only when the obs plane is ALREADY loaded:
                    # importing it here would drag models/ into
                    # control-plane binaries that never use federation.
                    import sys

                    obs = sys.modules.get("k8s_dra_driver_torch.models.obs_plane")
                    if obs is not None and obs.FLEET.stats()["instances"]:
                        text = obs.FLEET.render_federated(registry_ref)
                    else:
                        text = registry_ref.render()
                    body = text.encode()
                    ctype = "text/plain; version=0.0.4"
                elif url.path == "/healthz":
                    body = b"ok"
                    ctype = "text/plain"
                elif url.path == "/debug/state":
                    body = json.dumps(state_ref(), indent=1, default=str).encode()
                    ctype = "application/json"
                elif url.path == "/debug/traces":
                    body = json.dumps(TRACER.recent(), indent=1, default=str).encode()
                    ctype = "application/json"
                elif url.path == "/debug/journal":
                    try:
                        limit = int(query.get("limit", ["200"])[0])
                    except ValueError:
                        limit = 200
                    doc = {
                        **journal_ref.stats(),
                        "events": journal_ref.tail(
                            limit=limit,
                            correlation=query.get("correlation", [None])[0],
                            component=query.get("component", [None])[0],
                        ),
                    }
                    body = json.dumps(doc, indent=1, default=str).encode()
                    ctype = "application/json"
                elif url.path == "/debug/stacks":
                    from k8s_dra_driver_torch.utils.watchdog import thread_stacks

                    body = json.dumps(thread_stacks(), indent=1).encode()
                    ctype = "application/json"
                elif url.path == "/debug/serve":
                    # Imported lazily: diagnostics serves control-plane
                    # binaries that never load the models package.
                    from k8s_dra_driver_torch.models.telemetry import debug_serve_doc

                    try:
                        rid = int(query.get("request_id", [""])[0])
                    except ValueError:
                        rid = None
                    try:
                        limit = int(query.get("limit", ["8"])[0])
                    except ValueError:
                        limit = 8
                    doc = debug_serve_doc(request_id=rid, trace_limit=limit)
                    body = json.dumps(doc, indent=1, default=str).encode()
                    ctype = "application/json"
                elif url.path == "/debug/fleet":
                    # Lazy for the same reason as /debug/serve; fleet.py
                    # itself never imports jax, so this stays cheap even
                    # in control-plane binaries.
                    from k8s_dra_driver_torch.models.fleet import debug_fleet_doc

                    body = json.dumps(
                        debug_fleet_doc(), indent=1, default=str
                    ).encode()
                    ctype = "application/json"
                elif url.path == "/debug/disagg":
                    # Lazy for the same reason as /debug/fleet; disagg.py
                    # is jax-free, so this stays control-plane safe.
                    from k8s_dra_driver_torch.models.disagg import debug_disagg_doc

                    body = json.dumps(
                        debug_disagg_doc(), indent=1, default=str
                    ).encode()
                    ctype = "application/json"
                elif url.path == "/debug/transport":
                    # Lazy for the same reason as /debug/disagg; the
                    # transport's engine imports live behind worker_main,
                    # so this stays control-plane safe.
                    from k8s_dra_driver_torch.models.transport import (
                        debug_transport_doc,
                    )

                    body = json.dumps(
                        debug_transport_doc(), indent=1, default=str
                    ).encode()
                    ctype = "application/json"
                elif url.path == "/debug/autoscale":
                    # Lazy for the same reason as /debug/fleet; the
                    # autoscaler is jax-free host-side control law.
                    from k8s_dra_driver_torch.models.autoscaler import (
                        debug_autoscale_doc,
                    )

                    body = json.dumps(
                        debug_autoscale_doc(), indent=1, default=str
                    ).encode()
                    ctype = "application/json"
                elif url.path == "/debug/fleet-journal":
                    # Lazy for the same reason as /debug/fleet; the obs
                    # plane imports only utils, never jax.
                    from k8s_dra_driver_torch.models.obs_plane import FLEET

                    try:
                        limit = int(query.get("limit", ["200"])[0])
                    except ValueError:
                        limit = 200
                    doc = FLEET.fleet_journal_doc(
                        limit=limit,
                        correlation=query.get("correlation", [None])[0],
                        component=query.get("component", [None])[0],
                        instance=query.get("instance", [None])[0],
                    )
                    body = json.dumps(doc, indent=1, default=str).encode()
                    ctype = "application/json"
                elif url.path == "/debug/fleet-traces":
                    from k8s_dra_driver_torch.models.obs_plane import FLEET

                    try:
                        limit = int(query.get("limit", ["50"])[0])
                    except ValueError:
                        limit = 50
                    doc = FLEET.fleet_traces_doc(
                        trace_id=query.get("trace_id", [None])[0],
                        limit=limit,
                    )
                    body = json.dumps(doc, indent=1, default=str).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request logging
                pass

        self._httpd = ThreadingHTTPServer((bind_host, port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
