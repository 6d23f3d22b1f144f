"""Consumer-side runtime: what a pod does with a prepared claim
(``k8s_dra_driver_tpu/consumer.py``, its attach and mesh half).

Read the ``TPU_*`` / ``MEGASCALE_*`` wiring the CDI spec injected, bring
up ``torch.distributed`` for multi-host claims, and build the mesh:

    from k8s_dra_driver_torch import consumer
    ctx = consumer.attach(backend="nccl")   # env -> ClaimContext (+ process group)
    mesh = ctx.build_mesh()                  # the world's ranks as a DeviceMesh

The reference brings up ``jax.distributed`` with one process per host; the
port runs one process per card, so the same env drives
``torch.distributed.init_process_group`` with a rank for each visible card:
the world is hosts x slices x the host's visible cards, the rank the
claim's global worker id (slice-major under multislice) times the host's
cards plus the process's ``LOCAL_RANK`` (``torchrun --nproc-per-node``
sets it), the rendezvous the coordinator address (the cross-slice one under
multislice; without one, torch's ``env://``).  The backend is the caller's
choice, ``"gloo"`` or ``"nccl"``.  The daemon client (shared claims'
``register`` and ``lease``) and the serving demo are not ported yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ClaimContext:
    """Everything the driver wired into this container, resolved."""

    visible_devices: list[int] = field(default_factory=list)
    chips_per_process_bounds: str = ""
    process_bounds: str = ""
    process_coord: str = ""
    partition_index: Optional[int] = None
    sharing_strategy: str = "exclusive"
    queue_quantum_ms: Optional[int] = None
    hbm_limit_mib: Optional[int] = None
    daemon_socket: str = ""
    worker_id: Optional[int] = None
    host_count: Optional[int] = None
    coordinator_address: str = ""
    num_slices: Optional[int] = None
    slice_id: Optional[int] = None
    megascale_coordinator: str = ""
    # this process's card among the host's visible ones (the launcher's
    # LOCAL_RANK): the port runs one process per card
    local_rank: Optional[int] = None

    @property
    def multi_host(self) -> bool:
        return self.host_count is not None and self.host_count > 1

    @property
    def multi_slice(self) -> bool:
        return self.num_slices is not None and self.num_slices > 1

    @property
    def global_worker_id(self) -> Optional[int]:
        """Process id across the whole group (slice-major), or the
        intra-slice worker id when single-slice."""
        if not self.multi_slice:
            return self.worker_id
        if self.worker_id is None or self.host_count is None:
            return None
        return self.slice_id * self.host_count + self.worker_id

    @property
    def shared(self) -> bool:
        return self.sharing_strategy in ("time-slicing", "spatial-partition")

    @property
    def local_cards(self) -> int:
        """Cards this host's share of the claim shows, one rank each."""
        return max(len(self.visible_devices), 1)

    @property
    def world_size(self) -> int:
        return (self.host_count or 1) * (self.num_slices or 1) * self.local_cards

    @property
    def rank(self) -> int:
        """This process's rank: :attr:`global_worker_id` times
        :attr:`local_cards` plus :attr:`local_rank`."""
        if (self.multi_host or self.multi_slice) and self.global_worker_id is None:
            raise ValueError("a multi-host claim needs TPU_WORKER_ID (and MEGASCALE_SLICE_ID)")
        local = self.local_rank or 0
        if self.local_cards > 1 and self.local_rank is None:
            raise ValueError(
                f"this claim shows {self.local_cards} cards and the port runs one process "
                f"per card: start {self.local_cards} processes with LOCAL_RANK 0.."
                f"{self.local_cards - 1} (torchrun --nproc-per-node {self.local_cards})"
            )
        if not 0 <= local < self.local_cards:
            raise ValueError(
                f"LOCAL_RANK {local} outside the claim's {self.local_cards} visible card(s)"
            )
        return (self.global_worker_id or 0) * self.local_cards + local

    def claimed_card(self, cards: int) -> int:
        """This process's card among the ``cards`` the container sees:
        card :attr:`local_rank` where the runtime showed the claim's cards
        alone (``cards`` is :attr:`local_cards`), else the claim's host
        index ``visible_devices[local_rank]``, never a card outside the
        claim."""
        local = self.local_rank or 0
        card = local if cards == self.local_cards or not self.visible_devices \
            else self.visible_devices[local]
        if card >= cards:
            raise ValueError(
                f"the claim's card {card} is not among the {cards} card(s) this container sees"
            )
        return card

    def initialize_distributed(self, backend: str | None) -> None:
        """Join the claim's process group, rank :attr:`rank` of
        :attr:`world_size` (nothing for a claim of one card on one host), at
        ``tcp://`` the coordinator (under multislice the megascale one;
        without one, torch's ``env://`` rendezvous).  Where the host has
        cards, the process first takes its :meth:`claimed_card` as its
        current device (NCCL is bound to it)."""
        if self.world_size == 1:
            return
        import torch
        import torch.distributed as dist

        from k8s_dra_driver_torch.parallel.mesh import check_backend, set_rank_card

        if backend is None:
            raise ValueError("a claim of several cards needs backend='gloo' or 'nccl'")
        rank = self.rank
        check_backend(backend, self.local_cards, "cuda" if backend == "nccl" else "cpu")
        kwargs: dict = {"world_size": self.world_size, "rank": rank}
        if torch.cuda.device_count():
            # the claim's card LOCAL_RANK names, never rank % cards: a host's
            # ranks are numbered from its worker id, and the container may
            # see cards outside the claim
            card = self.claimed_card(torch.cuda.device_count())
            set_rank_card(card)
            if backend == "nccl":
                kwargs["device_id"] = torch.device("cuda", card)  # NCCL binds its card now
        address = self.megascale_coordinator if self.multi_slice else self.coordinator_address
        if address:
            kwargs["init_method"] = f"tcp://{address}"
        dist.init_process_group(backend, **kwargs)

    def build_mesh(self, want_seq: bool = False, device_type: str = "cuda"):
        """The world's ranks as a ``DeviceMesh``; under a slice-group claim
        (:attr:`multi_slice`) with a leading ``slice`` axis of
        ``MEGASCALE_NUM_SLICES``, each slice's ranks contiguous."""
        import torch.distributed as dist

        from k8s_dra_driver_torch.parallel.mesh import (
            auto_mesh_shape,
            build_mesh,
            build_multislice_mesh,
        )

        if not dist.is_initialized():
            raise RuntimeError(
                "build_mesh needs a process group: call initialize_distributed "
                "(or torch.distributed.init_process_group) first"
            )
        ranks = list(range(dist.get_world_size()))
        if self.multi_slice:
            shape = auto_mesh_shape(len(ranks) // self.num_slices, want_seq=want_seq)
            return build_multislice_mesh(ranks, self.num_slices, shape, device_type)
        return build_mesh(ranks, auto_mesh_shape(len(ranks), want_seq=want_seq), device_type)

    def to_json(self) -> dict:
        return {
            k: v
            for k, v in self.__dict__.items()
            if v not in (None, "", [])
        }


def attach(environ=None, init_distributed: bool = True,
           backend: str | None = None) -> ClaimContext:
    """Resolve the claim wiring from the container environment; with
    ``init_distributed``, join the claim's process group on ``backend``."""
    env = os.environ if environ is None else environ

    def _int(name):
        raw = env.get(name, "")
        return int(raw) if raw not in ("", None) else None

    ctx = ClaimContext(
        visible_devices=[
            int(x) for x in env.get("TPU_VISIBLE_DEVICES", "").split(",") if x != ""
        ],
        chips_per_process_bounds=env.get("TPU_CHIPS_PER_PROCESS_BOUNDS", ""),
        process_bounds=env.get("TPU_PROCESS_BOUNDS", ""),
        process_coord=env.get("TPU_PROCESS_COORD", ""),
        partition_index=_int("TPU_PARTITION_INDEX"),
        sharing_strategy=env.get("TPU_SHARING_STRATEGY", "exclusive"),
        queue_quantum_ms=_int("TPU_QUEUE_QUANTUM_MS"),
        hbm_limit_mib=_int("TPU_HBM_LIMIT_MIB"),
        daemon_socket=env.get("TPU_TOPOLOGY_DAEMON_SOCKET", ""),
        worker_id=_int("TPU_WORKER_ID"),
        host_count=_int("TPU_HOST_COUNT"),
        coordinator_address=env.get("JAX_COORDINATOR_ADDRESS", ""),
        num_slices=_int("MEGASCALE_NUM_SLICES"),
        slice_id=_int("MEGASCALE_SLICE_ID"),
        megascale_coordinator=env.get("MEGASCALE_COORDINATOR_ADDRESS", ""),
        local_rank=_int("LOCAL_RANK"),
    )
    if init_distributed:
        ctx.initialize_distributed(backend)
    return ctx
