"""Multi-card dry run (``k8s_dra_driver_tpu/e2e/dryrun.py``), runnable as
``python -m k8s_dra_driver_torch.e2e.dryrun N [--device cpu]``.

It shows that the port's distributed paths run end to end over ``N`` ranks,
one process each (``parallel/ranks.RankPool``): the mesh train step
(data x sequence x tensor parallelism, flash attention, then GQA + RoPE),
the GPipe pipeline in both tensor-parallel modes, hybrid multislice data
parallelism (N >= 8), top-2 expert parallelism and the collective-matmul
MLP under gradients, and serving sharded over the slots: the dense engine,
the paged engine with speculation, a LoRA bank and the prefix store, an
MoE model, and a multislice mesh reached through ``consumer.attach``, each
sharded engine's streams equal to the single-card engine's.  Every leg
runs on every rank; rank 0's lines are printed, the reference's lines in
its order and wording.  A leg that fails stops the run with its name and
a nonzero exit.

The reference guards JAX's accelerator plugins (``force_cpu``,
``_pick_devices``); here ``--device cpu`` runs N gloo ranks on the CPU.  On
cards the ranks take NCCL when the host has N cards, else N gloo ranks
share the cards (the kernels are built once before they start); the
pool's timeout is the watchdog.  The kernel launches each leg made,
summed over the ranks, go to standard error.
"""

from __future__ import annotations

import dataclasses
import json
import sys

_MESHES: dict = {}


def _mesh(device_type: str, shape, slices: int = 0):
    """A mesh over the world's ranks, built once per shape on every rank."""
    from k8s_dra_driver_torch.parallel import mesh as pm

    key = (device_type, slices, shape)
    if key not in _MESHES:
        import torch.distributed as dist

        ranks = range(dist.get_world_size())
        _MESHES[key] = (pm.build_multislice_mesh(ranks, slices, shape, device_type) if slices
                        else pm.build_mesh(ranks, shape, device_type))
    return _MESHES[key]


def _gen(device: str, seed: int):
    import torch

    return torch.Generator(device=device).manual_seed(seed)


def _train(n: int, device: str) -> list:
    """Classic ``TINY`` with flash attention, then GQA + RoPE, over
    ``auto_mesh_shape(n, want_seq=True)``: one step each."""
    from k8s_dra_driver_torch.models import burnin
    from k8s_dra_driver_torch.parallel.mesh import auto_mesh_shape

    shape = auto_mesh_shape(n, want_seq=True)
    mesh = _mesh(device, shape)
    cfg = burnin.TINY
    modern = dataclasses.replace(cfg, n_kv_heads=cfg.n_heads // 4, rope=True)
    lines = []
    for leg_cfg, kwargs, tag in (
        (cfg, {"attention": "flash"}, ""),
        (modern, {}, f"(gqa kv={modern.kv_heads} + rope) "),
    ):
        fns = burnin.build_train_step(leg_cfg, mesh=mesh, device=device, **kwargs)
        params, opt_state = fns.init(_gen(device, 0))
        tokens = burnin.sample_tokens(_gen(device, 1), leg_cfg, batch=4 * shape.data, seq=64)
        _, _, loss = fns.step(params, opt_state, tokens)
        lines.append(f"dryrun_multichip: mesh data={shape.data} seq={shape.seq} "
                     f"model={shape.model} {tag}loss={float(loss):.4f}")
    return lines


def _pipeline(n: int, device: str) -> list:
    """``pp_burnin.build_pp_train_step`` on ``(pipe 2, data 2, model n/4)``,
    megatron and megatron-sp, MHA with learned positions and GQA + RoPE."""
    from k8s_dra_driver_torch.models import burnin, pp_burnin
    from k8s_dra_driver_torch.parallel.mesh import MeshShape

    if n < 4 or n % 4:
        return []
    cfg = burnin.TINY
    modern = dataclasses.replace(cfg, n_kv_heads=cfg.n_heads // 4, rope=True)
    pp_shape = MeshShape(pipe=2, data=2, model=n // 4)
    if cfg.n_heads % pp_shape.model != 0:
        return [f"dryrun_multichip: pipeline path SKIPPED "
                f"({cfg.n_heads} heads not divisible by model={pp_shape.model})"]
    pp_mesh = _mesh(device, pp_shape)
    pp_legs = [(cfg, "")]
    if modern.kv_heads % pp_shape.model == 0:
        pp_legs.append((modern, f"gqa kv={modern.kv_heads} + rope, "))
    lines = []
    for leg_cfg, leg_tag in pp_legs:
        for tp_mode in ("megatron", "megatron-sp"):
            fns = pp_burnin.build_pp_train_step(leg_cfg, pp_mesh, tp_mode=tp_mode, device=device)
            params, opt_state = fns.init(_gen(device, 0))
            tokens = burnin.sample_tokens(_gen(device, 1), leg_cfg, batch=4, seq=64)
            _, _, loss = fns.step(params, opt_state, tokens)
            lines.append(f"dryrun_multichip: mesh pipe={pp_shape.pipe} data={pp_shape.data} "
                         f"model={pp_shape.model} (pipeline, {leg_tag}{tp_mode}) "
                         f"loss={float(loss):.4f}")
    return lines


def _multislice_train(n: int, device: str) -> list:
    """Hybrid data parallelism over 2 slices of ``(data 2, model n/4)``:
    the slice axis outermost, so only the gradient all-reduce crosses it."""
    from k8s_dra_driver_torch.models import burnin
    from k8s_dra_driver_torch.parallel.mesh import MeshShape

    if n < 8 or n % 2:
        return []
    cfg = burnin.TINY
    ms_shape = MeshShape(data=2, model=n // 4)
    fns = burnin.build_train_step(cfg, mesh=_mesh(device, ms_shape, slices=2), device=device)
    params, opt_state = fns.init(_gen(device, 0))
    tokens = burnin.sample_tokens(_gen(device, 1), cfg, batch=8, seq=64)
    _, _, loss = fns.step(params, opt_state, tokens)
    return [f"dryrun_multichip: mesh slice=2 data={ms_shape.data} model={ms_shape.model} "
            f"(multislice hybrid-dp over dcn) loss={float(loss):.4f}"]


def _expert_parallel(n: int, device: str) -> list:
    """A top-2 MoE gradient with all-to-all dispatch over ``(data n)``:
    this rank's tokens and experts, both expert stacks' gradients."""
    import torch

    from k8s_dra_driver_torch.ops.moe import topk_moe
    from k8s_dra_driver_torch.parallel.mesh import MeshShape, P, shard

    ep_mesh = _mesh(device, MeshShape(data=n))
    g = _gen(device, 2)
    t, d, f, e = 8 * n, 32, 64, 2 * n
    x = torch.randn((t, d), generator=g, device=device)
    wr = torch.randn((d, e), generator=g, device=device) * 0.5
    wu = torch.randn((e, d, f), generator=g, device=device) / d**0.5
    wd = torch.randn((e, f, d), generator=g, device=device) / f**0.5
    up = shard(wu, ep_mesh, P("data", None, None)).requires_grad_()
    down = shard(wd, ep_mesh, P("data", None, None)).requires_grad_()
    out = topk_moe(shard(x, ep_mesh, P("data", None)), wr, up, down, mesh=ep_mesh,
                   capacity_factor=2.0, k=2)
    (out**2).sum().backward()  # this rank's part of the sum; the all-to-alls carry the rest
    if not all(torch.isfinite(w.grad).all() for w in (up, down)):
        raise AssertionError("the expert gradients are not finite")
    return [f"dryrun_multichip: mesh expert={n} (top-2 moe grad) ok"]


def _tp_mlp(n: int, device: str) -> list:
    """The overlapped collective-matmul MLP over ``(model n)`` under
    gradients of both weights."""
    import torch

    from k8s_dra_driver_torch.ops.collective_matmul import sharded_tp_mlp
    from k8s_dra_driver_torch.parallel.mesh import MeshShape, P, shard

    cm_mesh = _mesh(device, MeshShape(model=n))
    g = _gen(device, 3)
    d_cm, ff_cm, s_cm = 32, 16 * n, 8 * n
    x = torch.randn((2, s_cm, d_cm), generator=g, device=device)
    wi = torch.randn((d_cm, ff_cm), generator=g, device=device) / d_cm**0.5
    wo = torch.randn((ff_cm, d_cm), generator=g, device=device) / ff_cm**0.5
    wi_l = shard(wi, cm_mesh, P(None, "model")).requires_grad_()
    wo_l = shard(wo, cm_mesh, P("model", None)).requires_grad_()
    out = sharded_tp_mlp(shard(x, cm_mesh, P(None, "model", None)), wi_l, wo_l, cm_mesh)
    (out**2).sum().backward()
    if not all(torch.isfinite(w.grad).all() for w in (wi_l, wo_l)):
        raise AssertionError("the tp-mlp gradients are not finite")
    return [f"dryrun_multichip: mesh model={n} (overlapped tp-mlp grad) ok"]


def _streams(eng, prompts, max_tokens: int = 4, adapters=None) -> dict:
    for i, prompt in enumerate(prompts):
        if adapters is None:
            eng.submit(prompt, max_tokens=max_tokens)
        else:
            eng.submit(prompt, max_tokens=max_tokens, adapter=adapters[i])
    eng.run_until_drained()
    return {c.request_id: c.generated for c in eng.completions()}


def _sharded_serving(n: int, device: str) -> list:
    """The dense engine with its slots sharded over ``(data n)``."""
    from k8s_dra_driver_torch.models import burnin
    from k8s_dra_driver_torch.models.serve import ServeEngine
    from k8s_dra_driver_torch.parallel.mesh import MeshShape

    cfg = burnin.TINY
    eng = ServeEngine(params=burnin.init_params(_gen(device, 0), cfg), cfg=cfg, n_slots=n,
                      prompt_bucket=16, mesh=_mesh(device, MeshShape(data=n)),
                      slot_axis="data", device=device)
    for i in range(n):
        eng.submit([1 + i, 2, 3], max_tokens=4)
    eng.run_until_drained()
    served = eng.completions()
    assert len(served) == n, f"served {len(served)}/{n}"
    return [f"dryrun_multichip: mesh data={n} (sharded serving, "
            f"{sum(len(c.generated) for c in served)} tokens) ok"]


def _sharded_paged_serving(n: int, device: str) -> list:
    """The paged engine, slots and pool sharded over ``(data n)``, with
    speculative rounds, per-request LoRA adapters and the prefix store: its
    streams equal to the single-card engine's."""
    from k8s_dra_driver_torch.models import burnin, lora
    from k8s_dra_driver_torch.models.paged import PagedServeEngine
    from k8s_dra_driver_torch.parallel.mesh import MeshShape

    cfg = burnin.TINY
    lcfg = lora.LoraConfig(rank=2, alpha=4.0)
    bank = lora.stack_adapters(
        cfg, lcfg, [lora.init_adapters(_gen(device, 7 + i), cfg, lcfg) for i in range(2)])
    paged_kw = dict(cfg=cfg, n_slots=n, n_blocks=8 * n, block_size=4, prompt_bucket=16,
                    spec_gamma=2, adapter_bank=bank, prefix_cache_blocks=2, device=device)
    p_params = burnin.init_params(_gen(device, 0), cfg)
    streams = {}
    for tag, mesh_arg in (("sharded", _mesh(device, MeshShape(data=n))), ("single", None)):
        eng = PagedServeEngine(params=p_params, mesh=mesh_arg, slot_axis="data", **paged_kw)
        streams[tag] = _streams(eng, [[1 + i, 2, 3, 4, 5] for i in range(n)],
                                adapters=[i % 3 for i in range(n)])
    assert streams["sharded"] == streams["single"], (
        f"sharded paged streams diverged: {streams}"
    )
    assert len(streams["sharded"]) == n
    return [f"dryrun_multichip: mesh data={n} (sharded PAGED serving "
            f"+ spec + lora, {sum(map(len, streams['sharded'].values()))} "
            f"tokens, bit-equal single-device) ok"]


def _moe_serving(n: int, device: str) -> list:
    """The dense engine serving a 4-expert top-2 model, sharded against
    single."""
    from k8s_dra_driver_torch.models import burnin
    from k8s_dra_driver_torch.models.serve import ServeEngine
    from k8s_dra_driver_torch.parallel.mesh import MeshShape

    moe_cfg = dataclasses.replace(burnin.TINY, n_experts=4, moe_top_k=2)
    moe_params = burnin.init_params(_gen(device, 2), moe_cfg)
    moe_streams = {}
    for tag, mesh_arg in (("sharded", _mesh(device, MeshShape(data=n))), ("single", None)):
        eng = ServeEngine(params=moe_params, cfg=moe_cfg, n_slots=n, prompt_bucket=16,
                          mesh=mesh_arg, slot_axis="data", device=device)
        moe_streams[tag] = _streams(eng, [[2 + i, 7, 1] for i in range(n)])
    assert moe_streams["sharded"] == moe_streams["single"], (
        f"moe streams diverged: {moe_streams}"
    )
    return [f"dryrun_multichip: mesh data={n} (MoE top-2 serving, "
            f"{sum(map(len, moe_streams['sharded'].values()))} tokens, "
            f"bit-equal single-device) ok"]


def _multislice_serving(n: int, device: str) -> list:
    """Data-parallel serving across two slices, driven by the env a
    slice-group claim injects (``MEGASCALE_*``) through ``consumer.attach``:
    slots over ``("slice", "data")``, streams equal to a single-slice
    engine's."""
    from k8s_dra_driver_torch import consumer
    from k8s_dra_driver_torch.models import burnin
    from k8s_dra_driver_torch.models.serve import ServeEngine
    from k8s_dra_driver_torch.parallel.mesh import auto_mesh_shape

    if n < 2 or n % 2:
        return []
    ctx = consumer.attach(
        environ={
            "MEGASCALE_NUM_SLICES": "2",
            "MEGASCALE_SLICE_ID": "0",
            "MEGASCALE_COORDINATOR_ADDRESS": "localhost:8081",
        },
        init_distributed=False,
    )
    assert ctx.multi_slice, "slice-group env contract not recognized"
    cfg = burnin.TINY
    p_params = burnin.init_params(_gen(device, 0), cfg)
    ms_mesh = _mesh(device, auto_mesh_shape(n // ctx.num_slices), slices=ctx.num_slices)
    ms_streams = {}
    for tag, mesh_arg, ax in (("multislice", ms_mesh, ("slice", "data")),
                              ("single", None, "data")):
        eng = ServeEngine(params=p_params, cfg=cfg, n_slots=4, prompt_bucket=16,
                          mesh=mesh_arg, slot_axis=ax, device=device)
        ms_streams[tag] = _streams(eng, [[3 + i, 1, 4] for i in range(4)])
    assert ms_streams["multislice"] == ms_streams["single"], (
        f"multislice streams diverged: {ms_streams}"
    )
    return [f"dryrun_multichip: mesh slice=2 (multislice DP serving over "
            f"('slice','data'), "
            f"{sum(map(len, ms_streams['multislice'].values()))} "
            f"tokens, bit-equal single-slice) ok"]


# the legs by name, in the reference's order
LEGS = {
    "train": _train,
    "pipeline": _pipeline,
    "multislice train": _multislice_train,
    "expert parallel": _expert_parallel,
    "tp mlp": _tp_mlp,
    "sharded serving": _sharded_serving,
    "sharded paged serving": _sharded_paged_serving,
    "moe serving": _moe_serving,
    "multislice serving": _multislice_serving,
}


def run_leg(name: str, n: int, device: str):
    """Leg ``name`` on this rank: ``(its lines, its kernel launches)``, the
    launch counters zeroed just before it."""
    from k8s_dra_driver_torch.models import graphs

    graphs.add_launch_counts({k: -v for k, v in graphs.launch_counts().items()})
    lines = LEGS[name](n, device)
    counts = {f"{mod.rsplit('.', 1)[-1]}:{key}": v
              for (mod, key), v in graphs.launch_counts().items() if v}
    return lines, counts


class DryRunFailed(RuntimeError):
    """A leg failed on some rank: its name and the ranks' tracebacks."""

    def __init__(self, leg: str, cause: Exception):
        super().__init__(f"dry run leg {leg!r} failed: {cause}")
        self.leg = leg


def run_dryrun(n_devices: int, device="cuda", pool=None) -> dict:
    """The dry run over ``n_devices`` ranks on ``device`` (default the
    card; raises without one unless ``device="cpu"``), in ``pool`` (a
    ``RankPool`` of that size) or a pool of its own, printing rank 0's
    lines as each leg ends.  Returns ``{"lines": [...], "launches": {leg:
    {kernel: launches summed over the ranks}}}``; raises
    :class:`DryRunFailed` naming the leg that failed."""
    from k8s_dra_driver_torch.device import resolve_device
    from k8s_dra_driver_torch.parallel.ranks import RankPool

    dev = resolve_device(device)
    own = pool is None
    if own:
        backend = "gloo"
        if dev.type == "cuda":
            import torch

            from k8s_dra_driver_torch.ops import _build

            # built here, so the ranks load the libraries and none waits on nvcc
            _build.build(["flash_attention", "paged_attention"])
            backend = "nccl" if torch.cuda.device_count() >= n_devices else "gloo"
        pool = RankPool(n_devices, backend=backend, device_type=dev.type, timeout_s=600)
    lines, launches = [], {}
    try:
        for name in LEGS:
            try:
                results = pool.run(run_leg, name, n_devices, dev.type)
            except Exception as exc:
                raise DryRunFailed(name, exc) from exc
            for line in results[0][0]:
                print(line, flush=True)
                lines.append(line)
            total: dict = {}
            for _, counts in results:
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
            launches[name] = total
    finally:
        if own:
            pool.close()
    return {"lines": lines, "launches": launches}


def main(argv: list[str], pool=None) -> int:
    """``argv``: the program name, then ``N`` (default 8) and optionally
    ``--device cpu``."""
    args = list(argv[1:])
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1] if i + 1 < len(args) else ""
        del args[i:i + 2]
    n_devices = int(args[0]) if args else 8
    try:
        report = run_dryrun(n_devices, device, pool=pool)
    except DryRunFailed as exc:
        print(f"dryrun_multichip: leg {exc.leg!r} FAILED\n{exc}", file=sys.stderr, flush=True)
        return 1
    print(f"dryrun launches summed over ranks: {json.dumps(report['launches'])}",
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
