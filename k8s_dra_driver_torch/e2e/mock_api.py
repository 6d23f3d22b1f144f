"""The port of ``k8s_dra_driver_tpu/e2e/mock_api.py`` (copied: the port
imports nothing of the JAX package), over the port's ``InMemoryAPIServer``;
the same REST dialect and fault seams, so either package's
``RESTClient`` talks to either package's mock.

HTTP facade over InMemoryAPIServer speaking the Kubernetes REST dialect.

Serves the subset of the k8s API the driver uses (CRUD + label-selected list
+ streaming ``?watch=true``, one chunk a frame, flushed per frame), so the
REST client — and therefore the real driver binaries — can be exercised over
actual HTTP without a cluster: an envtest-style harness.
"""

from __future__ import annotations

import json
import queue
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from k8s_dra_driver_torch.kube import objects
from k8s_dra_driver_torch.kube.fakeserver import APIError, InMemoryAPIServer

_PLURALS = {
    "resourceslices": "ResourceSlice",
    "deviceclasses": "DeviceClass",
    "resourceclaims": "ResourceClaim",
    "resourceclaimtemplates": "ResourceClaimTemplate",
    "nodes": "Node",
    "pods": "Pod",
    "deployments": "Deployment",
    "leases": "Lease",
}

_PATH_RE = re.compile(
    r"^/(?:api/v1|apis/[^/]+/[^/]+)"
    r"(?:/namespaces/(?P<ns>[^/]+))?"
    r"/(?P<plural>[^/?]+)"
    r"(?:/(?P<name>[^/?]+))?$"
)


class MockKubeAPI:
    """``server`` is the backing store; mutate it directly in tests to
    simulate cluster-side changes."""

    def __init__(self, server: InMemoryAPIServer | None = None, token: str = ""):
        self.server = server or InMemoryAPIServer()
        self.token = token
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _deny(self, code: int, message: str) -> None:
                body = json.dumps(
                    {"kind": "Status", "code": code, "message": message}
                ).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send(self, doc: dict, code: int = 200) -> None:
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _authorized(self) -> bool:
                if not outer.token:
                    return True
                return self.headers.get("Authorization") == f"Bearer {outer.token}"

            def _route(self):
                parsed = urlparse(self.path)
                m = _PATH_RE.match(parsed.path)
                if not m or m.group("plural") not in _PLURALS:
                    return None
                return (
                    _PLURALS[m.group("plural")],
                    m.group("ns") or "",
                    m.group("name") or "",
                    parse_qs(parsed.query),
                )

            def _body(self):
                length = int(self.headers.get("Content-Length", "0"))
                return json.loads(self.rfile.read(length)) if length else None

            def _maybe_drop(self, verb: str, kind: str) -> bool:
                """HTTP-layer fault: truncate the response mid-body.  The
                Content-Length overshoots what we write and the connection
                closes, so the client observes an ``IncompleteRead`` — a
                retryable transport error.  Injected BEFORE the store op:
                the request is lost in flight, never half-applied."""
                faults = outer.server.faults
                if faults is None or not faults.take_drop(verb, kind):
                    return False
                partial = b'{"kind":"Status"'
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(partial) + 64))
                self.end_headers()
                self.wfile.write(partial)
                self.close_connection = True
                return True

            def do_GET(self):  # noqa: N802
                if not self._authorized():
                    return self._deny(401, "bad token")
                if urlparse(self.path).path == "/version":
                    return self._send({"major": "1", "minor": "32"})
                route = self._route()
                if route is None:
                    return self._deny(404, f"unknown path {self.path}")
                kind, ns, name, query = route
                try:
                    if name:
                        if self._maybe_drop("GET", kind):
                            return
                        obj = outer.server.get(kind, name, ns)
                        return self._send(objects.to_json(obj))
                    if query.get("watch", ["false"])[0] == "true":
                        faults = outer.server.faults
                        if faults is not None and faults.take_watch_gone(kind):
                            # The apiserver's "resourceVersion too old": the
                            # client must relist and rewatch.
                            return self._deny(410, "watch gone (fault injected)")
                        rv = query.get("resourceVersion", ["0"])[0]
                        return self._stream_watch(kind, rv)
                    if self._maybe_drop("LIST", kind):
                        return
                    selector = _parse_selector(query)
                    items = outer.server.list(
                        kind, namespace=ns or None, label_selector=selector
                    )
                    return self._send(
                        {
                            "kind": f"{kind}List",
                            "metadata": {
                                "resourceVersion": outer.server.current_resource_version()
                            },
                            "items": [objects.to_json(o) for o in items],
                        }
                    )
                except APIError as exc:
                    return self._deny(exc.code, str(exc))

            def do_POST(self):  # noqa: N802
                if not self._authorized():
                    return self._deny(401, "bad token")
                route = self._route()
                if route is None:
                    return self._deny(404, f"unknown path {self.path}")
                kind, ns, _, _ = route
                doc = self._body()
                doc.setdefault("kind", kind)
                obj = objects.from_json(doc)
                if ns:
                    obj.metadata.namespace = ns
                if self._maybe_drop("POST", kind):
                    return
                try:
                    return self._send(objects.to_json(outer.server.create(obj)), 201)
                except APIError as exc:
                    return self._deny(exc.code, str(exc))

            def do_PUT(self):  # noqa: N802
                if not self._authorized():
                    return self._deny(401, "bad token")
                route = self._route()
                if route is None:
                    return self._deny(404, f"unknown path {self.path}")
                kind, ns, name, _ = route
                doc = self._body()
                doc.setdefault("kind", kind)
                obj = objects.from_json(doc)
                if self._maybe_drop("PUT", kind):
                    return
                try:
                    return self._send(objects.to_json(outer.server.update(obj)))
                except APIError as exc:
                    return self._deny(exc.code, str(exc))

            def do_DELETE(self):  # noqa: N802
                if not self._authorized():
                    return self._deny(401, "bad token")
                route = self._route()
                if route is None:
                    return self._deny(404, f"unknown path {self.path}")
                kind, ns, name, _ = route
                if self._maybe_drop("DELETE", kind):
                    return
                try:
                    outer.server.delete(kind, name, ns)
                    return self._send({"kind": "Status", "status": "Success"})
                except APIError as exc:
                    return self._deny(exc.code, str(exc))

            def _stream_watch(self, kind: str, resource_version: str) -> None:
                events: queue.Queue = queue.Queue()
                # watch_since replays anything modified after the client's
                # list atomically with subscription — no lost-event gap.
                watch = outer.server.watch_since(
                    kind, resource_version, lambda e: events.put(e)
                )
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                faults = outer.server.faults
                if faults is not None:
                    hang = faults.take_watch_hang(kind)
                    if hang > 0:
                        # Silent stall: headers sent, no frames.  The client's
                        # watch read-timeout is what must detect this.
                        outer._closing.wait(hang)
                try:
                    while not outer._closing.is_set():
                        if watch.stopped:
                            break  # subscription revoked: end the stream like
                            # an apiserver closing an expired watch
                        if faults is not None and faults.take_watch_error_frame(kind):
                            self._write_frame(
                                {
                                    "type": "ERROR",
                                    "object": {
                                        "kind": "Status",
                                        "code": 410,
                                        "message": "fault injected error frame",
                                    },
                                }
                            )
                            break  # apiserver closes the stream after ERROR
                        try:
                            event = events.get(timeout=0.2)
                        except queue.Empty:
                            continue
                        self._write_frame(
                            {"type": event.type, "object": objects.to_json(event.object)}
                        )
                except (BrokenPipeError, ConnectionResetError):
                    pass
                finally:
                    watch.stop()

            def _write_frame(self, doc: dict) -> None:
                frame = json.dumps(doc).encode() + b"\n"
                self.wfile.write(f"{len(frame):x}\r\n".encode())
                self.wfile.write(frame + b"\r\n")
                self.wfile.flush()

        self._closing = threading.Event()
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._httpd.server_port
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    def start(self) -> "MockKubeAPI":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._closing.set()
        self._httpd.shutdown()
        self._httpd.server_close()


def _parse_selector(query) -> dict | None:
    raw = query.get("labelSelector", [""])[0]
    if not raw:
        return None
    out = {}
    for part in raw.split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k] = v
    return out
