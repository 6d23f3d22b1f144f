"""The engine protocol of the fleet router (``k8s_dra_driver_tpu/models/fleet.py``
``Engine``, copied: the port imports nothing of the JAX package).

Only the protocol is ported: the router, its policy and its replicas stay
in the reference, which holds no JAX, so a test can put port engines
behind the reference's ``FleetRouter``.  Both port engines satisfy this
``Engine`` and the reference's.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

from k8s_dra_driver_torch.models.telemetry import EngineStats


@runtime_checkable
class Engine(Protocol):
    """The replica contract of ``ServeEngine`` (dense) and
    ``PagedServeEngine`` (paged): the same admission surface, the same
    typed Completion vocabulary (``serve.TERMINAL_STATUSES``), the same
    ``EngineStats`` load signal, and the snapshot/restore/release triple a
    live migration runs on.  A runtime check proves only that the members
    exist; ``tests/test_torch_fleet.py`` pins their signatures."""

    n_slots: int
    sync_interval: int

    def free_slots(self) -> int: ...

    def submit(self, prompt, max_tokens, **kwargs) -> int: ...

    def step_burst(self) -> int: ...

    def pump(self, requests, max_steps=100_000, queue_limit=None) -> list: ...

    def completions(self) -> list: ...

    def cancel(self, request_id: int) -> bool: ...

    def snapshot_active(self) -> dict: ...

    def restore(self, snapshot: dict, merge: bool = False) -> list: ...

    def release_active(self) -> int: ...

    def stats(self) -> EngineStats: ...
