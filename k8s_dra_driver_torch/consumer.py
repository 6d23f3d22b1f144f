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
choice, ``"gloo"`` or ``"nccl"``.

Shared claims cooperate through the claim's topology daemon
(``daemon_client.TopologyDaemonClient``): ``ctx.register()`` announces the
consumer (a spatial one gets its partition record back) and ``with
ctx.lease():`` holds the time-slicing run lease, a no-op context under any
other strategy.

``python -m k8s_dra_driver_torch.consumer [--check] [--serve-demo]
[--device cpu]`` is the pod-log check the demo specs run: it prints the
claim context, the daemon's registration for a shared claim and the cards
this process sees; ``--check`` fails when the container sees another
number of cards than the claim wired; ``--serve-demo`` serves a small
seeded model through the paged engine on the claimed cards and prints one
JSON summary line (:func:`serve_demo`).  The default device is the card;
``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import time
import uuid
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

    # -- daemon cooperation -------------------------------------------------

    def daemon_client(self, consumer_id: Optional[str] = None, retries: int = 10,
                      retry_delay_s: float = 0.5):
        """Connect to the claim's topology daemon (None when the claim has
        none), retrying ``retries`` times ``retry_delay_s`` apart: the
        daemon may still be starting when the consumer container does.  The
        delay is flat, with no jitter (the daemon is node-local: there is
        no herd to spread)."""
        if not self.daemon_socket:
            return None
        from k8s_dra_driver_torch.daemon_client import TopologyDaemonClient

        name = consumer_id or self._consumer_id
        retries = max(1, retries)
        last: Exception = RuntimeError("unreachable")
        for attempt in range(retries):
            try:
                return TopologyDaemonClient(self.daemon_socket, name)
            except OSError as exc:
                last = exc
                if attempt + 1 < retries:
                    time.sleep(retry_delay_s)
        raise ConnectionError(
            f"topology daemon at {self.daemon_socket} not reachable "
            f"after {retries} attempts: {last}"
        )

    @functools.cached_property
    def _consumer_id(self) -> str:
        # HOSTNAME is the pod's name, the same in every container of the
        # pod: a pid and a random suffix keep same-pod sharers apart (pids
        # repeat across containers' PID namespaces)
        return (
            f"{os.environ.get('HOSTNAME', 'consumer')}-{os.getpid()}-"
            f"{uuid.uuid4().hex[:6]}"
        )

    def register(self, consumer_id: Optional[str] = None) -> Optional[dict]:
        """Announce this consumer to the daemon; a spatial-partition
        consumer gets its partition record back.  None without a daemon."""
        client = self.daemon_client(consumer_id)
        if client is None:
            return None
        try:
            return client.register(partition=self.partition_index)
        finally:
            client.close()

    @contextlib.contextmanager
    def lease(self, consumer_id: Optional[str] = None, timeout_ms: int = 60_000):
        """The time-slicing run lease over this container's chips
        (``TPU_VISIBLE_DEVICES`` joined with commas, or ``*``), held for the
        ``with`` block; a no-op context (yielding None) for every other
        strategy or without a daemon, so training code need not know the
        strategy."""
        if self.sharing_strategy != "time-slicing" or not self.daemon_socket:
            yield None
            return
        client = self.daemon_client(consumer_id)
        scope = ",".join(str(i) for i in self.visible_devices) or "*"
        try:
            grant = client.acquire(quantum_ms=self.queue_quantum_ms, timeout_ms=timeout_ms,
                                   scope=scope)
            if not grant.get("ok"):
                raise TimeoutError(
                    f"run lease not granted: {grant.get('error')} "
                    f"(holder: {grant.get('holder')})"
                )
            yield grant
        finally:
            try:
                client.release(scope=scope)
            finally:
                client.close()

    def to_json(self) -> dict:
        return {
            k: v
            for k, v in self.__dict__.items()
            if v not in (None, "", []) and not k.startswith("_")
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


# -- the pod's entry point -------------------------------------------------------

DEMO_CFG = dict(vocab_size=128, d_model=128, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=256,
                max_seq=128, rope=True)
DEMO_ENGINE = dict(n_slots=2, n_blocks=40, block_size=16, prompt_bucket=32,
                   prefix_cache_blocks=4, prefill_chunk_blocks=1, spec_gamma=2,
                   preempt_on_stall=True)
DEMO_SHARED = list(range(16))  # one full shared block across the mix
# (prompt, max_tokens, adapter)
DEMO_REQUESTS = (
    (DEMO_SHARED + [20, 21], 12, 0), (DEMO_SHARED + [30], 10, 0),
    ([40, 41, 42], 8, 1), (DEMO_SHARED + [50, 51, 52], 6, 0),
)
DEMO_SHARDS = 2  # the demo's slot axis: n_slots over at most 2 of the host's ranks


def local_devices(device) -> list[str]:
    """The devices this process sees: each card's name, or ``["cpu"]``."""
    import torch

    if torch.device(device).type == "cpu":
        return ["cpu"]
    return [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]


def demo_mesh(ctx: ClaimContext, device_type: str):
    """``(mesh, takes_part)`` of the serving demo in a claim's process
    group: a ``MeshShape(data=2)`` mesh over ranks ``LOCAL_RANK`` 0 and 1 of
    this process's host (the reference shards over the pod's first two
    local devices), or None with one card a host.  Every rank of the world
    builds every host's mesh, in host order (each makes process groups
    collectively); a rank with ``LOCAL_RANK`` 2 or more takes no part."""
    import torch.distributed as dist

    from k8s_dra_driver_torch.parallel.mesh import MeshShape, build_mesh

    cards = ctx.local_cards
    local = ctx.local_rank or 0
    if not dist.is_initialized() or cards < DEMO_SHARDS:
        return None, local == 0
    mine = None
    for base in range(0, dist.get_world_size(), cards):
        mesh = build_mesh(range(base, base + DEMO_SHARDS), MeshShape(data=DEMO_SHARDS),
                          device_type)
        if base == ctx.rank - local:
            mine = mesh
    return mine, local < DEMO_SHARDS


def serve_demo(device="cuda", mesh=None, params=None, bank=None):
    """One-command serving proof on the claimed cards (the reference's
    ``consumer._serve_demo``): a small model (seeded weights, or
    ``params``) and a one-adapter LoRA bank (or ``bank``) through the paged
    engine with prefix sharing, chunked admission, speculative rounds,
    preemption and the bank all on; ``mesh`` (a ``DeviceMesh`` with a
    ``data`` axis; every rank of it calls this alike) shards the slots and
    the pool over it.  Four requests, three of them sharing one full block,
    on 2 slots, so the later ones admit after earlier ones retired and hit
    the store.  Returns ``(summary, streams)``: the reference's summary
    keys (``backend`` the device type) and each request's generated
    tokens."""
    import torch

    from k8s_dra_driver_torch.device import resolve_device
    from k8s_dra_driver_torch.models import burnin, lora
    from k8s_dra_driver_torch.models.paged import PagedServeEngine
    from k8s_dra_driver_torch.parallel.mesh import mesh_shape

    dev = resolve_device(device)
    cfg = burnin.ModelConfig(**DEMO_CFG)
    lcfg = lora.LoraConfig(rank=4)
    if params is None:
        params = burnin.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    if bank is None:
        gen = torch.Generator(device=dev).manual_seed(7)
        bank = lora.stack_adapters(cfg, lcfg, [lora.init_adapters(gen, cfg, lcfg)])
    eng = PagedServeEngine(params=params, cfg=cfg, **DEMO_ENGINE, adapter_bank=bank,
                           mesh=mesh, slot_axis="data", device=dev)
    pending = list(DEMO_REQUESTS)
    streams: dict = {}
    for _ in range(2000):
        while pending:
            prompt, max_tokens, adapter = pending[0]
            try:
                eng.submit(prompt, max_tokens, adapter=adapter)
                pending.pop(0)
            except RuntimeError:
                break  # engine full: step until a retirement frees room
        eng.step()
        for c in eng.completions():
            streams[c.request_id] = list(c.generated)
        if not pending:
            break
    else:
        raise RuntimeError("serve demo could not admit its queue")
    eng.run_until_drained()  # the engine's own drain and wedge detection
    for c in eng.completions():
        streams[c.request_id] = list(c.generated)
    summary = {
        "backend": dev.type,
        "sharded_over": 0 if mesh is None else mesh_shape(mesh)["data"],
        "completed": len(streams),
        "generated_tokens": sum(len(s) for s in streams.values()),
        "prefix_block_hits": eng.prefix_hits,
        "stalled_steps": eng.stalled_steps,
        "preemptions": eng.preempted_count,
        "adapters_in_bank": lora.bank_size(bank),
        "pool_free_blocks": eng.free_blocks,
    }
    return summary, streams


def main(argv: Optional[list[str]] = None) -> int:
    """``python -m k8s_dra_driver_torch.consumer [--check] [--serve-demo]
    [--device cpu]``: print the claim context, the daemon's registration
    (shared claims) and the cards this process sees with the claim's world
    size.  ``--check`` compares the cards the container sees with the
    claim's ``TPU_VISIBLE_DEVICES`` before any process group starts.
    ``--serve-demo`` then joins the claim's group (``"nccl"`` on cards,
    ``"gloo"`` on the CPU) when the claim shows several cards, and runs
    :func:`serve_demo` on ``LOCAL_RANK`` 0 and 1 of each host (the others
    take no part), printing its summary line.  The device is ``--device``'s
    value, the card by default."""
    argv = sys.argv[1:] if argv is None else list(argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            print("--device needs a value: cuda or cpu", file=sys.stderr)
            return 2
        device = argv[i + 1]
    from k8s_dra_driver_torch.device import resolve_device

    dev = resolve_device(device)
    check = "--check" in argv
    # one process per card: the group starts only for the demo, after the check
    ctx = attach(init_distributed=False)
    print(json.dumps({"claim_context": ctx.to_json()}, sort_keys=True))
    if ctx.shared:
        reg = ctx.register()
        if reg is not None:
            print(json.dumps({"daemon": reg}, sort_keys=True))
    local = local_devices(dev)
    print(json.dumps({"torch_local_devices": local, "world_size": ctx.world_size}))
    # TPU_VISIBLE_DEVICES wires this host's chips: the check counts the
    # cards this container sees, not the world
    if check and ctx.visible_devices and len(local) != len(ctx.visible_devices):
        print(
            f"DEVICE MISMATCH: claim wired {len(ctx.visible_devices)} chips, "
            f"torch sees {len(local)} locally",
            file=sys.stderr,
        )
        return 1
    if "--serve-demo" not in argv:
        return 0
    import torch.distributed as dist

    ctx.initialize_distributed("nccl" if dev.type == "cuda" else "gloo")
    try:
        summary = claim_serve_demo(ctx, dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if summary is not None:
        print(json.dumps({"serve_demo": summary}, sort_keys=True))
    return 0


def claim_serve_demo(ctx: ClaimContext, device) -> Optional[dict]:
    """:func:`serve_demo` in the claim's process group (if one was
    joined) over :func:`demo_mesh`: its summary, or None on a rank that
    takes no part."""
    mesh, takes_part = demo_mesh(ctx, str(device).split(":")[0])
    if not takes_part:
        return None
    return serve_demo(device, mesh=mesh)[0]


if __name__ == "__main__":
    raise SystemExit(main())
