"""The port of ``k8s_dra_driver_tpu/kube/fakeserver.py`` (copied: the port imports
nothing of the JAX package).

In-memory Kubernetes API server with watch support.

The reference's controller and plugin talk to a real API server through
client-go (pkg/flags/kubeclient.go:70-106; informer at
cmd/nvidia-dra-controller/imex.go:222-295).  This module provides the same
behavioral surface in-process: CRUD with uid/resourceVersion management,
optimistic-concurrency conflicts, label-selected lists, and informer-style
watches (replay of existing objects followed by live ADDED/MODIFIED/DELETED
events).  It is the test/bench backbone the reference never built (SURVEY.md
§4.5) and also backs the closed-loop e2e harness.
"""

from __future__ import annotations

import os
import threading
import uuid as uuidlib
from dataclasses import dataclass
from typing import Any, Callable, Optional

from k8s_dra_driver_torch.kube import objects


class APIError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code


class NotFound(APIError):
    def __init__(self, message: str):
        super().__init__(404, message)


class Conflict(APIError):
    def __init__(self, message: str):
        super().__init__(409, message)


class AlreadyExists(APIError):
    def __init__(self, message: str):
        super().__init__(409, message)


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    object: Any


class Watch:
    def __init__(self, server: "InMemoryAPIServer", kind: str, callback: Callable[[WatchEvent], None]):
        self._server = server
        self.kind = kind
        self.callback = callback
        self.stopped = False
        # Last-known object per (namespace, name) — maintained by RESTClient
        # for reflector Replace semantics (synthesized DELETED after a watch
        # gap); unused by the in-memory server, which never loses events.
        self.known: dict = {}

    def stop(self) -> None:
        self.stopped = True
        self._server._remove_watch(self)


def _key(obj: Any) -> tuple[str, str, str]:
    return (type(obj).KIND, obj.metadata.namespace, obj.metadata.name)


class InMemoryAPIServer:
    """Thread-safe in-memory object store with the client surface we need."""

    def __init__(self, fault_injector=None):
        self._lock = threading.RLock()
        self._objects: dict[tuple[str, str, str], Any] = {}
        self._rv = 0
        self._watches: list[Watch] = []
        # Chaos hook (utils/faults.py): every verb consults it BEFORE
        # touching the store, so an injected failure never half-applies.
        # ``DRA_FAULTS`` arms it from the environment for manual chaos runs.
        if fault_injector is None and os.environ.get("DRA_FAULTS"):
            from k8s_dra_driver_torch.utils.faults import FaultInjector

            fault_injector = FaultInjector.from_env(os.environ["DRA_FAULTS"])
        self.faults = fault_injector
        # Admission-time invariant checks, the in-process analog of a
        # validating admission plugin: per kind, ``fn(current, updated)``
        # runs under the store lock BETWEEN the resourceVersion CAS check
        # and the mutation, and may raise (typically ``Conflict``) to
        # reject the write atomically.  The multi-scheduler contention
        # harness installs a device-marker non-overlap validator here so
        # two schedulers committing DIFFERENT claims onto the same chip
        # lose the race with a 409 instead of silently double-booking.
        self._update_validators: dict[str, list] = {}

    def add_update_validator(self, kind: str, fn) -> Callable[[], None]:
        """Register ``fn(current, updated)`` to vet every update() of
        ``kind`` under the store lock; returns a remover callable."""
        with self._lock:
            self._update_validators.setdefault(kind, []).append(fn)

        def _remove() -> None:
            with self._lock:
                fns = self._update_validators.get(kind, [])
                if fn in fns:
                    fns.remove(fn)

        return _remove

    def _maybe_fault(self, verb: str, kind: str) -> None:
        # Outside the lock: injected latency must not serialize the server.
        if self.faults is not None:
            self.faults.before(verb, kind)

    # -- client surface ----------------------------------------------------

    def create(self, obj: Any) -> Any:
        self._maybe_fault("POST", type(obj).KIND)
        with self._lock:
            meta = obj.metadata
            if not meta.name and meta.generate_name:
                meta.name = meta.generate_name + uuidlib.uuid4().hex[:5]
            key = _key(obj)
            if key in self._objects:
                raise AlreadyExists(f"{key[0]} {key[2]!r} already exists")
            if not meta.uid:
                meta.uid = str(uuidlib.uuid4())
            self._rv += 1
            meta.resource_version = str(self._rv)
            stored = objects.deepcopy(obj)
            self._objects[key] = stored
            self._notify(WatchEvent("ADDED", stored))
            return objects.deepcopy(stored)

    def get(self, kind: str, name: str, namespace: str = "") -> Any:
        self._maybe_fault("GET", kind)
        with self._lock:
            obj = self._objects.get((kind, namespace, name))
            if obj is None:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            return objects.deepcopy(obj)

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[dict[str, str]] = None,
        field_selector: Optional[Callable[[Any], bool]] = None,
    ) -> list[Any]:
        self._maybe_fault("LIST", kind)
        with self._lock:
            out = []
            for (k, ns, _), obj in self._objects.items():
                if k != kind:
                    continue
                if namespace is not None and ns != namespace:
                    continue
                if label_selector and any(
                    obj.metadata.labels.get(lk) != lv for lk, lv in label_selector.items()
                ):
                    continue
                if field_selector and not field_selector(obj):
                    continue
                out.append(objects.deepcopy(obj))
            return out

    def update(self, obj: Any) -> Any:
        self._maybe_fault("PUT", type(obj).KIND)
        with self._lock:
            key = _key(obj)
            current = self._objects.get(key)
            if current is None:
                raise NotFound(f"{key[0]} {key[1]}/{key[2]} not found")
            if (
                obj.metadata.resource_version
                and obj.metadata.resource_version != current.metadata.resource_version
            ):
                raise Conflict(
                    f"{key[0]} {key[2]!r}: resourceVersion {obj.metadata.resource_version} "
                    f"!= {current.metadata.resource_version}"
                )
            for validate in self._update_validators.get(key[0], ()):
                validate(current, obj)  # may raise: write rejected atomically
            self._rv += 1
            obj.metadata.uid = current.metadata.uid
            obj.metadata.resource_version = str(self._rv)
            stored = objects.deepcopy(obj)
            self._objects[key] = stored
            self._notify(WatchEvent("MODIFIED", stored))
            return objects.deepcopy(stored)

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        self._maybe_fault("DELETE", kind)
        with self._lock:
            obj = self._objects.pop((kind, namespace, name), None)
            if obj is None:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            self._notify(WatchEvent("DELETED", obj))

    def watch(
        self, kind: str, callback: Callable[[WatchEvent], None], replay: bool = True
    ) -> Watch:
        """Informer-style: replays existing objects as ADDED, then streams.

        Replay happens under the server lock so a concurrent mutation cannot
        interleave its event before the replay of older state.
        ``replay=False`` subscribes to new events only (the raw k8s
        ``?watch=true`` semantics, used by the REST facade)."""
        with self._lock:
            existing = (
                [objects.deepcopy(o) for (k, _, _), o in self._objects.items() if k == kind]
                if replay
                else []
            )
            w = Watch(self, kind, callback)
            self._watches.append(w)
            for obj in existing:
                callback(WatchEvent("ADDED", obj))
            return w

    # -- internals ---------------------------------------------------------

    def current_resource_version(self) -> str:
        with self._lock:
            return str(self._rv)

    def watch_since(
        self, kind: str, resource_version: str, callback: Callable[[WatchEvent], None]
    ) -> Watch:
        """Subscribe atomically, first replaying objects modified after
        ``resource_version`` — closes the list→watch gap for REST clients
        (deletions in the gap are not replayed, matching a real watch cache's
        behavior of requiring a re-list for full recovery)."""
        try:
            since = int(resource_version)
        except ValueError:
            since = 0
        with self._lock:
            missed = [
                objects.deepcopy(o)
                for (k, _, _), o in self._objects.items()
                if k == kind and int(o.metadata.resource_version) > since
            ]
            w = Watch(self, kind, callback)
            self._watches.append(w)
            for obj in missed:
                callback(WatchEvent("MODIFIED", obj))
            return w

    def _remove_watch(self, w: Watch) -> None:
        with self._lock:
            if w in self._watches:
                self._watches.remove(w)

    def _notify(self, event: WatchEvent) -> None:
        # Called with the lock held (it is reentrant): delivery order is the
        # mutation order, and watch() replay cannot race behind a live event.
        # The event carries the STORED object; every delivered watcher gets
        # its own copy here, so callers must not (and do not) pre-copy —
        # with no watchers subscribed a mutation costs zero copies, which
        # is what keeps 10k-pool simulator builds fast.
        kind = type(event.object).KIND
        targets = [w for w in self._watches if w.kind == kind and not w.stopped]
        for w in targets:
            w.callback(WatchEvent(event.type, objects.deepcopy(event.object)))
