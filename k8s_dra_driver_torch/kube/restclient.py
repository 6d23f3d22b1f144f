"""The port of ``k8s_dra_driver_tpu/kube/restclient.py`` (copied: the port
imports nothing of the JAX package); the same client surface, wire form,
rate limits, reflector and metric families, over the port's own
``kube/objects`` and ``utils/retry``.

Kubernetes REST client — the client-go analog.

Implements the same client surface as :class:`InMemoryAPIServer`
(create/get/list/update/delete/watch) over the real Kubernetes REST API, so
the driver binaries run unmodified against either.  Covers what the
reference pulls from client-go via pkg/flags/kubeclient.go:30-106:

* kubeconfig loading (server, CA, bearer token / client certs) with
  in-cluster service-account fallback,
* QPS/burst client-side rate limiting (kubeclient.go defaults 5/10),
* informer-style watch: list + replay as ADDED, then a streaming
  ``?watch=true`` connection from the list's resourceVersion, decoded
  line-by-line (k8s watch frames are newline-delimited JSON; a frame split
  across chunks is joined by the response's line reader); expired
  resourceVersions (ERROR/410 frames) recover by re-listing, the client-go
  reflector contract.

Stdlib-only (urllib + ssl + threads) plus ``yaml`` for kubeconfigs.
"""

from __future__ import annotations

import base64
import json
import os
import re
import ssl
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Optional

import yaml

from k8s_dra_driver_torch.kube import objects
from k8s_dra_driver_torch.kube.fakeserver import (
    AlreadyExists,
    APIError,
    Conflict,
    NotFound,
    Watch,
    WatchEvent,
)
from k8s_dra_driver_torch.utils.journal import JOURNAL
from k8s_dra_driver_torch.utils.metrics import REGISTRY
from k8s_dra_driver_torch.utils.retry import (
    DEFAULT_WATCH_POLICY,
    Backoff,
    CircuitBreaker,
    RetryBudget,
    RetryPolicy,
    call_with_retry,
)

_RELIST_ERRORS = REGISTRY.counter(
    "dra_watch_relist_errors_total",
    "Reflector relist attempts that failed (watch stays up and retries)",
)
_RECONNECTS = REGISTRY.counter(
    "dra_watch_reconnects_total", "Watch stream reconnect attempts, by kind"
)

# One-shot requests: a handful of attempts with sub-second backoff covers
# API-server blips without masking real outages from the caller.
DEFAULT_REQUEST_POLICY = RetryPolicy(max_attempts=4, base_delay_s=0.05, max_delay_s=2.0)

# kind -> (api prefix, plural, namespaced)
_RESOURCES = {
    "ResourceSlice": ("/apis/resource.k8s.io/v1beta1", "resourceslices", False),
    "DeviceClass": ("/apis/resource.k8s.io/v1beta1", "deviceclasses", False),
    "ResourceClaim": ("/apis/resource.k8s.io/v1beta1", "resourceclaims", True),
    "ResourceClaimTemplate": ("/apis/resource.k8s.io/v1beta1", "resourceclaimtemplates", True),
    "Node": ("/api/v1", "nodes", False),
    "Pod": ("/api/v1", "pods", True),
    "Deployment": ("/apis/apps/v1", "deployments", True),
    "Lease": ("/apis/coordination.k8s.io/v1", "leases", True),
}

_IN_CLUSTER_SA = Path("/var/run/secrets/kubernetes.io/serviceaccount")


@dataclass
class KubeClientConfig:
    """Connection settings (pkg/flags/kubeclient.go:30-64 analog)."""

    server: str = ""
    token: str = ""
    ca_file: str = ""
    client_cert_file: str = ""
    client_key_file: str = ""
    insecure_skip_verify: bool = False
    qps: float = 5.0
    burst: int = 10

    @staticmethod
    def from_kubeconfig(path: str | Path, context: str = "") -> "KubeClientConfig":
        doc = yaml.safe_load(Path(path).read_text())
        ctx_name = context or doc.get("current-context", "")
        ctx = _named(doc.get("contexts", []), ctx_name).get("context", {})
        cluster = _named(doc.get("clusters", []), ctx.get("cluster", "")).get("cluster", {})
        user = _named(doc.get("users", []), ctx.get("user", "")).get("user", {})

        def materialize(direct_key: str, data_key: str, source: dict, suffix: str) -> str:
            if source.get(direct_key):
                return source[direct_key]
            if source.get(data_key):
                fd, path_ = tempfile.mkstemp(suffix=suffix)
                with os.fdopen(fd, "wb") as f:
                    f.write(base64.b64decode(source[data_key]))
                return path_
            return ""

        return KubeClientConfig(
            server=cluster.get("server", ""),
            token=user.get("token", ""),
            ca_file=materialize(
                "certificate-authority", "certificate-authority-data", cluster, ".crt"
            ),
            # kind/minikube admin kubeconfigs authenticate with client certs.
            client_cert_file=materialize(
                "client-certificate", "client-certificate-data", user, ".crt"
            ),
            client_key_file=materialize("client-key", "client-key-data", user, ".key"),
            insecure_skip_verify=bool(cluster.get("insecure-skip-tls-verify", False)),
        )

    @staticmethod
    def in_cluster() -> "KubeClientConfig":
        """Service-account config (client-go rest.InClusterConfig analog)."""
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        token_file = _IN_CLUSTER_SA / "token"
        if not host or not token_file.exists():
            raise APIError(500, "not running in a cluster (no service account/env)")
        return KubeClientConfig(
            server=f"https://{host}:{port}",
            token=token_file.read_text().strip(),
            ca_file=str(_IN_CLUSTER_SA / "ca.crt"),
        )

    @staticmethod
    def load(kubeconfig: str = "") -> "KubeClientConfig":
        """kubeconfig flag > $KUBECONFIG > in-cluster (kubeclient.go:70-90)."""
        path = kubeconfig or os.environ.get("KUBECONFIG", "")
        if path:
            return KubeClientConfig.from_kubeconfig(path)
        return KubeClientConfig.in_cluster()


def _named(items: list, name: str) -> dict:
    for item in items:
        if item.get("name") == name:
            return item
    return {}


_ENDPOINT_RE = re.compile(
    r"^/(?:api/v1|apis/[^/]+/[^/]+)(?:/namespaces/[^/]+)?/(?P<plural>[^/?]+)"
)


def _endpoint_class(url: str) -> str:
    """Circuit-breaker partitioning key: the resource plural.  One sick
    resource family (e.g. a webhook stalling resourceslices) must not trip
    the breaker for unrelated traffic."""
    m = _ENDPOINT_RE.match(urllib.parse.urlparse(url).path)
    return m.group("plural") if m else "misc"


class _RateLimiter:
    """Token bucket: qps refill, burst capacity (client-go flowcontrol)."""

    def __init__(self, qps: float, burst: int):
        self.qps = qps
        self.burst = burst
        self._tokens = float(burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def wait(self) -> None:
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(self.burst, self._tokens + (now - self._last) * self.qps)
                self._last = now
                if self._tokens >= 1:
                    self._tokens -= 1
                    return
                needed = (1 - self._tokens) / self.qps
            time.sleep(needed)


class RESTClient:
    """Drop-in for InMemoryAPIServer against a real API server.

    All traffic goes through the shared retry/backoff/circuit-breaker
    layer (utils/retry.py): ``_request`` retries retryable failures
    (429/5xx/transport) under ``retry_policy`` behind a per-endpoint-class
    breaker, and ``_watch_loop`` reconnects on a jittered exponential
    schedule (``watch_policy``) that resets on success."""

    def __init__(
        self,
        config: KubeClientConfig,
        retry_policy: RetryPolicy | None = None,
        watch_policy: RetryPolicy | None = None,
        watch_read_timeout_s: float = 300.0,
        request_timeout_s: float = 30.0,
        breaker_threshold: int = 5,
        breaker_reset_s: float = 15.0,
    ):
        self.config = config
        self._retry_policy = retry_policy or DEFAULT_REQUEST_POLICY
        self._watch_policy = watch_policy or DEFAULT_WATCH_POLICY
        # A quiet watch hitting the read timeout just reconnects — the same
        # contract as apiserver-side watch timeouts; it also bounds how long
        # a silently hung stream can stall an informer.
        self._watch_read_timeout_s = watch_read_timeout_s
        self._request_timeout_s = request_timeout_s
        self._breaker_threshold = breaker_threshold
        self._breaker_reset_s = breaker_reset_s
        self._breakers: dict[str, CircuitBreaker] = {}
        self._breaker_lock = threading.Lock()
        self._budget = RetryBudget()
        self._limiter = _RateLimiter(config.qps, config.burst)
        if config.server.startswith("https"):
            if config.insecure_skip_verify:
                self._ssl = ssl._create_unverified_context()
            else:
                self._ssl = ssl.create_default_context(
                    cafile=config.ca_file or None
                )
            if config.client_cert_file:
                self._ssl.load_cert_chain(
                    config.client_cert_file, config.client_key_file or None
                )
        else:
            self._ssl = None
        self._watches: list[Watch] = []

    def probe(self) -> dict:
        """Cheap connectivity+auth check (GET /version) for startup guards."""
        return self._request("GET", f"{self.config.server}/version")

    # -- client surface ----------------------------------------------------

    def create(self, obj: Any) -> Any:
        kind = type(obj).KIND
        url = self._collection_url(kind, obj.metadata.namespace)
        data = self._request("POST", url, objects.to_json(obj))
        return objects.from_json(data)

    def get(self, kind: str, name: str, namespace: str = "") -> Any:
        url = f"{self._collection_url(kind, namespace)}/{name}"
        return objects.from_json(self._request("GET", url))

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[dict[str, str]] = None,
        field_selector: Optional[Callable[[Any], bool]] = None,
    ) -> list[Any]:
        items, _ = self._list_raw(kind, namespace, label_selector)
        if field_selector:
            items = [o for o in items if field_selector(o)]
        return items

    def update(self, obj: Any) -> Any:
        kind = type(obj).KIND
        url = f"{self._collection_url(kind, obj.metadata.namespace)}/{obj.metadata.name}"
        data = self._request("PUT", url, objects.to_json(obj))
        return objects.from_json(data)

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        url = f"{self._collection_url(kind, namespace)}/{name}"
        self._request("DELETE", url)

    def watch(self, kind: str, callback: Callable[[WatchEvent], None]) -> Watch:
        """List + ADDED replay, then stream; reconnects on stream EOF."""
        items, rv = self._list_raw(kind, None, None)
        # w.known tracks the last-known object per key, for reflector
        # Replace semantics: after a watch gap we must synthesize DELETED
        # for objects that vanished during the outage (client-go
        # DeletedFinalStateUnknown), or consumers like SliceManager keep
        # publishing seats for dead nodes.
        w = Watch(self, kind, callback)
        self._watches.append(w)
        for obj in items:
            self._deliver(w, WatchEvent("ADDED", obj))
        thread = threading.Thread(
            target=self._watch_loop, args=(w, kind, rv), daemon=True
        )
        thread.start()
        return w

    @staticmethod
    def _deliver(w: Watch, event: WatchEvent) -> None:
        key = (event.object.metadata.namespace, event.object.metadata.name)
        if event.type == "DELETED":
            w.known.pop(key, None)
        else:
            w.known[key] = event.object
        w.callback(event)

    def _remove_watch(self, w: Watch) -> None:
        if w in self._watches:
            self._watches.remove(w)

    # -- internals ---------------------------------------------------------

    def _collection_url(self, kind: str, namespace: str) -> str:
        prefix, plural, namespaced = _RESOURCES[kind]
        if namespaced and namespace:
            return f"{self.config.server}{prefix}/namespaces/{namespace}/{plural}"
        return f"{self.config.server}{prefix}/{plural}"

    def _list_raw(self, kind, namespace, label_selector):
        url = self._collection_url(kind, namespace or "")
        if label_selector:
            sel = ",".join(f"{k}={v}" for k, v in sorted(label_selector.items()))
            url += "?" + urllib.parse.urlencode({"labelSelector": sel})
        doc = self._request("GET", url)
        items = []
        for item in doc.get("items", []):
            item.setdefault("kind", kind)
            item.setdefault("apiVersion", doc.get("apiVersion", ""))
            items.append(objects.from_json(item))
        return items, doc.get("metadata", {}).get("resourceVersion", "")

    def _watch_loop(self, w: Watch, kind: str, rv: str) -> None:
        backoff = Backoff(self._watch_policy)
        while not w.stopped:
            url = self._collection_url(kind, "") + "?" + urllib.parse.urlencode(
                {"watch": "true", "resourceVersion": rv}
            )
            streamed = False
            try:
                req = self._make_request("GET", url)
                with urllib.request.urlopen(
                    req, context=self._ssl, timeout=self._watch_read_timeout_s
                ) as resp:
                    for line in resp:
                        if w.stopped:
                            return
                        if not line.strip():
                            continue
                        frame = json.loads(line)
                        if frame.get("type") == "ERROR":
                            # Expired resourceVersion (410 Gone as a frame):
                            # re-establish the informer contract by re-listing.
                            rv, streamed = self._relist_guarded(w, kind, rv)
                            break
                        obj = objects.from_json(frame["object"])
                        rv = obj.metadata.resource_version or rv
                        self._deliver(w, WatchEvent(frame["type"], obj))
                        streamed = True
            except urllib.error.HTTPError as exc:
                if w.stopped:
                    return
                if exc.code == 410:  # expired rv on connect
                    rv, relisted = self._relist_guarded(w, kind, rv)
                    if relisted:
                        backoff.reset()
                        continue
            except (urllib.error.URLError, OSError, json.JSONDecodeError, ValueError):
                if w.stopped:
                    return
            # EOF, decode error, failed relist or connect failure: reconnect
            # on the shared jittered schedule; any streamed frame (or
            # successful relist) resets it so one blip doesn't leave the
            # watch permanently slow.
            if streamed:
                backoff.reset()
            _RECONNECTS.inc(kind=kind)
            self._watch_sleep(w, backoff.next_delay())

    @staticmethod
    def _watch_sleep(w: Watch, delay: float) -> None:
        """Backoff sleep that notices ``stop()`` instead of oversleeping."""
        deadline = time.monotonic() + delay
        while not w.stopped:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            time.sleep(min(0.1, remaining))

    def _relist_guarded(self, w: Watch, kind: str, rv: str) -> tuple[str, bool]:
        """Relist, surfacing failures instead of swallowing them: the old
        rv is kept (the next connect 410s again and re-enters here) and the
        failure is journaled + counted so a flapping relist is visible."""
        try:
            return self._relist(w, kind), True
        except Exception as exc:
            _RELIST_ERRORS.inc(kind=kind)
            JOURNAL.record(
                "restclient", "watch.relist_fail", correlation=kind,
                error=f"{type(exc).__name__}: {exc}",
            )
            return rv, False

    def _relist(self, w: Watch, kind: str) -> str:
        """Reflector recovery (client-go Replace semantics): list again,
        replay current objects as ADDED (consumers are level-triggered/
        idempotent), then synthesize DELETED — with the last-known object —
        for everything that vanished during the watch outage."""
        items, rv = self._list_raw(kind, None, None)
        fresh = {(o.metadata.namespace, o.metadata.name) for o in items}
        vanished = [obj for key, obj in list(w.known.items()) if key not in fresh]
        for obj in items:
            if w.stopped:
                return rv
            self._deliver(w, WatchEvent("ADDED", obj))
        for obj in vanished:
            if w.stopped:
                return rv
            self._deliver(w, WatchEvent("DELETED", obj))
        return rv

    def _make_request(self, method: str, url: str, body: Optional[dict] = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if body is not None:
            req.add_header("Content-Type", "application/json")
        if self.config.token:
            req.add_header("Authorization", f"Bearer {self.config.token}")
        return req

    def _breaker_for(self, url: str) -> CircuitBreaker:
        endpoint = _endpoint_class(url)
        with self._breaker_lock:
            breaker = self._breakers.get(endpoint)
            if breaker is None:
                breaker = self._breakers[endpoint] = CircuitBreaker(
                    endpoint=endpoint,
                    failure_threshold=self._breaker_threshold,
                    reset_timeout_s=self._breaker_reset_s,
                )
            return breaker

    def _request(self, method: str, url: str, body: Optional[dict] = None) -> dict:
        endpoint = _endpoint_class(url)
        return call_with_retry(
            lambda: self._request_once(method, url, body),
            policy=self._retry_policy,
            breaker=self._breaker_for(url),
            budget=self._budget,
            op=f"{method} {endpoint}",
        )

    def _request_once(self, method: str, url: str, body: Optional[dict]) -> dict:
        self._limiter.wait()
        req = self._make_request(method, url, body)
        try:
            with urllib.request.urlopen(
                req, context=self._ssl, timeout=self._request_timeout_s
            ) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as exc:
            message = exc.read().decode(errors="replace")[:500]
            if exc.code == 404:
                raise NotFound(message) from exc
            if exc.code == 409:
                # k8s uses 409 for both conflicts and already-exists
                if "already exists" in message.lower():
                    raise AlreadyExists(message) from exc
                raise Conflict(message) from exc
            raise APIError(exc.code, message) from exc
        return json.loads(payload) if payload else {}
