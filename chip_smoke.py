#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure fails the run, exit code 1; without a CUDA device it
exits 2 before any result):

1. environment: the card's name and power limit; the three kernel sources
   built from ``k8s_dra_driver_torch/csrc`` with ``nvcc``, all started
   together (ptxas report printed; the D 64 backward kernels, bf16 and
   f32, and the D 64 f32 forward must not spill; the f32 kernels' registers
   and shared memory printed);
2. serving kernels against their plain PyTorch versions on the card, at the
   serving path's shapes (FLAGSHIP_MODERN: Hq 16 / Hkv 4 / d 64, L 8,
   block 16, B 8, context 512, ragged lengths up to 1024 and rows at the
   paged kernel's split boundaries, elementwise; the paged append call
   timed for each split size of a sweep; int4 at M 8 (the split-K
   kernel) and 256 (the wgmma kernel in bf16) over the four block
   matrices, elementwise, repeated calls bit for bit), with each tolerance
   and its reason, and each kernel's time beside the plain version's, a
   one-call PyTorch yardstick the port never calls, and the least time the
   card could take;
3. the flash kernels (forward, dQ, dK/dV) the same way, at the training
   path's shapes (B·H 64, S 256 and 1024, D 64, causal and full, f32 and
   bf16), timed at B·H 64, S 1024, causal, bf16 beside SDPA's forward and
   its backward through autograd, and the f32 kernels beside SDPA in f32
   (one profiled f32 backward; the f32 kernels also at D 128); and in the
   ring's mode at B·H 64, S 256, D 64, f32 and bf16: the forward writing
   f32 partials, causal and not, and the dQ and dK/dV kernels with the
   global lse of a two-block merge and a given ``delta``, each elementwise
   against its plain version on the same operands;
4. serving FLAGSHIP_MODERN (random weights from a seed, bf16 weights and
   pool) through ``PagedServeEngine.pump``, the engine's programs as CUDA
   graphs (at most 4, each captured once; capture time and pool bytes
   printed): every stream checked teacher-forced against the plain dense
   decode path, and the run held against an eager twin engine
   (``serve.disable_graphs()``): completions, statuses, host syncs, stalls,
   final pool bytes outside the null block and every kernel launch count
   identical; then steady
   decode timed eager and graphed in alternating rounds in one process
   (the graphed step must not be slower), with one profiled burst of each;
5. the same with int4 block weights (decode steps through the split-K int4
   kernel, admissions through the wgmma one; both must launch);
6. the same in f32 at reduced depth;
7. the request lifecycle ("serve bf16 lifecycle"): FLAGSHIP_MODERN in
   bf16, 8 slots, block 16, sync interval 8, top-k 50, on a 49-block pool:
   16 seeded requests (odd ones sampled at temperature 0.8 with seeds,
   priorities 0 and 1 by pairs), a cancel after the third burst and one
   slot poisoned at one step through ``utils/faults``; the graphed run (the
   main path) held against an eager twin in completions, statuses,
   preemptions, quarantines, host syncs, stalls, pool bytes outside the
   null block and launch counts; never-preempted streams equal a roomy
   fault-free run's bit for bit (cancelled and quarantined ones are
   prefixes); every token teacher-forced against the plain dense path
   (greedy within 0.25 of the argmax, sampled within 0.25 / 0.8 of the
   best perturbed score under the port's Gumbel noise); threefry's known
   answers, bits and uniforms on the card equal to the CPU's; steady
   decode all sampled against all greedy, and the sampling tail alone
   (graphed, profiled) beside the greedy step;
8. the dense ``ServeEngine`` ("serve dense"): FLAGSHIP_MODERN in bf16, 8
   slots, prompt bucket 256, sync interval 8, bf16 cache, in six legs, each
   timed: the serving run's 16 requests through ``pump`` graphed (the main
   path) against an eager twin (completions, statuses, host syncs, cache
   bytes, launch counts) and teacher-forced; the prefix cache (prefix
   bucket 64) over 16 requests sharing two system prompts, 14 hits and 2
   misses, against a prefix-off twin (equal streams counted, not
   required); the lifecycle (top-k 50, odd requests sampled, a cancel
   after burst 3, one slot poisoned) graphed against eager, with a
   snapshot after burst 4 restored through JSON into a fresh engine, its
   streams counted against the uninterrupted run's and teacher-forced;
   int4 block weights (both int4 kernels must launch, counts printed);
   steady decode of the dense engine eager and graphed beside the paged
   graphed step (alternating rounds, profiles, the dense step's bound);
   ``pump(queue_limit=4)`` shedding with no device work for a shed request;
9. chunked admission and the prefix store ("serve bf16 admission"):
   FLAGSHIP_MODERN in bf16, 8 slots, block 16, bucket 256, sync interval
   8, ``prefix_cache_blocks=16``, ``prefill_chunk_blocks=4``, in six legs,
   each timed: the dense phase's prefix traffic (16 requests over two
   64-token system prompts) graphed (the main path) against an eager twin
   (completions, statuses, host syncs, stalls, prefix hits and misses,
   pool bytes from block 1, launch counts), the graphs within the
   engine's ``graph_bound`` (capture time and pool MiB printed), a leak
   audit, every stream teacher-forced; the same traffic with chunking,
   the store or both off (streams equal to the both-off engine's
   counted, not required); the head-of-line case, 256-token arrivals
   among 7 decoding residents at 4-block chunks and whole, 4 an engine in
   alternating rounds (medians of the time to first token and of the
   stall the admission adds to the residents' longest gap); the
   admission time of a 256-token prompt with 0 and 15 cached blocks
   (medians of 5); the lifecycle on a 73-block pool (top-k 50, odd
   requests sampled, preemption of requests holding shared blocks, a
   cancel while admitting) graphed against eager, snapshots after burst 4
   (resident and admitting entries) and at the first parked request
   (resident and parked entries) restored through JSON into fresh
   engines (streams equal to the uninterrupted run's counted, all
   teacher-forced), leak audits; int4 block weights at 1-block chunks
   (``int4_splitk`` at M = 16 in the chunk programs) and unchunked
   (``int4_wgmma`` in suffixes and prefills), both teacher-forced, and
   each int4 product shape of the two runs held against the plain
   version on the first input the path gave it;
10. speculative serving ("serve bf16 spec"): FLAGSHIP_MODERN in bf16, 8
   slots, block 16, bucket 256, ``spec_gamma`` 4, in five legs, each
   timed: the serving run's 16 requests through the paged engine with
   the int8 self-draft, graphed (the main path) against an eager twin
   (completions, statuses, host syncs, stalls, pool bytes from block 1,
   the draft cache's bytes, launch counts), the graphs within
   ``graph_bound``, streams equal to the plain graphed engine's counted
   and every token teacher-forced, and the append kernel at nq 5 held
   against its plain version on each layer's first verify window (output
   and written pages); int4 target and self-draft, every product shape
   (``int4_splitk`` at M 8, ``int4_wgmma`` at M 40) held on its own x;
   the dense engine graphed against eager, and ``speculative_decode`` at
   batch 8 teacher-forced beside ``greedy_decode``; the prefix store and
   4-block chunks with speculation graphed against eager, and a lifecycle
   on a 73-block pool (preemptions, a snapshot restored through JSON);
   the plain graphed step, the int8 self-draft and a 2-layer draft in
   alternating windows (ms per round and per committed token, tokens a
   round, acceptance), one profiled graphed round each and one eager
   round split into draft steps, verify pass and the rest;
11. request telemetry ("serve bf16 telemetry"): FLAGSHIP_MODERN in bf16,
   8 slots, block 16, bucket 256, sync interval 8, each graphed engine with
   telemetry on (the main path) against its graphed
   ``telemetry_enabled=False`` twin, in six legs, each timed: the paged
   engine on the serving run's 16 requests, on the lifecycle traffic (a
   49-block pool that preempts, a cancel after burst 3, a poisoned slot,
   ``pump(queue_limit=6)`` shedding) and with int4 block weights (both int4
   kernels must launch), the dense engine, and a γ = 4 speculative paged
   engine; each twin equal in completions and statuses, host syncs, graph
   calls, kernel launches and the ``stats()`` fields an engine keeps
   itself, and the on engine's account consistent (completed, statuses,
   tokens generated, every timeline in order, bursts summing to each
   request's tokens); then steady decode of 8 residents with telemetry on
   and off in 4 alternating rounds of 4 graphed 8-step bursts (host
   clock medians, reported), and one profiled telemetry-on burst with one
   device-to-host copy;
12. per-request LoRA ("serve bf16 lora"): FLAGSHIP_MODERN in bf16, 8
   slots, block 16, bucket 256, sync interval 8, a bank of two seeded
   adapters beside the identity (rank 8, alpha 16, the four block
   matrices), in eight legs, each timed: the serving run's 16 requests
   with adapters 0, 1, 2 in turn through the paged engine graphed (the
   main path) against an eager twin, every token teacher-forced against
   its own adapter's merged model (``lora.merge``) within the 0.25 gap,
   the append kernel held against its plain version on the path's first
   window in every layer; adapter-0 streams equal to a bank-less graphed
   engine's and every adapted stream different from it, with the logit
   difference between the delta hooks and the bf16 merge and the argmaxes
   moved printed for B std 0.3 and 0.05; one prompt under adapters 1, 2 and 1 with the prefix store
   (no hit across adapters, a hit for the same one, the two adapters'
   streams different); preemption on a 73-block pool (never-preempted
   streams equal to the roomy run's, re-admitted ones teacher-forced
   under their adapters); γ 4 with the int8 self-draft of the base under
   the bank, graphed against eager, acceptance printed; the int4 base
   under the bank (``int4_splitk`` in the bursts, ``int4_wgmma`` in the
   prefills, each product shape held on the path's own x); the dense
   engine under the bank, graphed against eager; the adapted graphed step
   against the bank-less one in alternating rounds, one profiled burst
   each (device time and kernels per step), and the bytes the bank's
   gathers move;
13. mixture-of-experts ("serve moe"): FLAGSHIP_MODERN with 8 experts and
   top-2 routing (Mixtral-8x7B's, ``MOE``; 591.5 M parameters, every
   expert on every token) in bf16, the serving run's first 8 requests, in
   six legs, each timed: the paged engine graphed (the main path) against
   an eager twin, the append kernel held against its plain version on the
   path's first window in every layer, every token teacher-forced against
   the plain dense path and reported with the dense path's routing margins
   (in bf16 a near-tie flips an expert between two paths that round
   otherwise, which moves the logits by more than any rounding), the
   experts chosen per layer (one expert taking every choice fails); the
   dense engine the same way; both engines in f32 at 2 layers, graphed
   against eager and every token within 1e-3 of the dense argmax (the
   routing gate); the int4 base (``int4_splitk`` in the bursts,
   ``int4_wgmma`` in the prefills, on the attention projections; each
   product shape held on the path's own x); γ 4 with the int8 self-draft,
   graphed against eager, acceptance printed; the graphed MoE step beside
   the dense-MLP one in alternating rounds, a profiled burst each and the
   bytes bound;
14. quantized KV pools ("serve kv quant"): ``kv_dtype`` "int8" and "int4"
   at FLAGSHIP_MODERN under the bf16 serving engine's ``pool_hbm_bytes``
   (the blocks each holds printed), each graphed against an eager twin in
   completions, counters, pool bytes and scales from block 1 and launch
   counts (no paged kernel: the route is the reference's XLA one in plain
   PyTorch), each stream's first difference from the bf16 pool's printed;
   the block codec on the card byte for byte against the CPU; the graphed
   steps beside the bf16 kernel step in alternating rounds, a profiled
   burst each;
15. KV handoff ("serve bf16 handoff"): FLAGSHIP_MODERN in bf16, 8 slots,
   block 16, bucket 256, 8 requests (prompts of 16-256 tokens, 32-64 new
   ones), in six legs, each timed: a paged prefill engine's
   ``handoff=True`` payloads through the port's ``to_wire``/``from_wire``
   into a graphed paged decode engine (the main path) against an eager
   twin, the injected blocks equal to the source's byte for byte, the
   append kernel on each layer's first injected window against its plain
   version, every token teacher-forced within 0.25, streams equal to the
   unsplit engine's counted; the same with int8 pools (blocks and scales);
   the dense engine's payloads into the paged engine; bf16 payloads into
   an int8 pool, re-prefilled and counted "incompatible"; the fleet prefix
   tier (a 240-token prefix exported, sent and injected, the next admission
   hitting all 15 blocks with the owner's cold first token); capture, wire
   and inject of a 256-token request timed against its re-prefill;
16. slot-sharded serving ("serve mesh"): the append kernel at the sharded
   batch (B 2, bf16, nq 1, ctx 512) against its plain version, elementwise,
   and bit for bit against the same rows of a B 8 call; then four ranks on
   the one card on a gloo group (``parallel/ranks.RankPool``): the paged
   engine over ``MeshShape(data=4)`` (8 slots, 2 a rank; 196 blocks, 4
   shards of a null block and 48; block 16, bucket 256, sync interval 8)
   at FLAGSHIP_MODERN in bf16 on the serving run's 16 requests, graphed on
   every rank (the main path) and held on each rank against its eager twin
   (completions, statuses, counters, launch counts, cache bytes from its
   shard's block 1); every rank's completions and counters identical,
   every token teacher-forced within 0.25, one host sync a burst; the
   streams equal to the single-card engine's counted; host-clock ms a
   decode step, the gather's bytes a burst (and through the host), graphs,
   pool MiB and peak memory a rank, the append launches summed over
   ranks; then the dense engine the same way in f32 at 2 layers on 8
   requests, within 1e-3;
17. training FLAGSHIP_MODERN at full width in bf16 through
   ``build_train_step(attention="flash")`` (B 4, S 1024, remat "blocks"):
   step 0's loss and gradients against ``attention="dense"``; then 8 steps
   of the graphed step (one CUDA graph from the third call; the main path,
   launch counts zeroed just before) on one batch with the loss falling and
   the flash kernels' launches counted (bf16 through the wgmma kernels
   only), held bit for bit (losses, params, count, moments) and in launch
   counts against an eager twin (``serve.disable_graphs()``) from the same
   seed; capture time, graph pool and peak memory; eager and graphed step
   times in 4 alternating rounds of 5 steps in one process (tokens/s,
   share of 989 TFLOP/s), and a profile of one step of each (the card's
   busy share);
18. adapter-only training ("train lora"): ``lora.build_lora_train_step``
    (rank 8, alpha 16, the four block matrices, attention "flash", B 4, S
    1024, bf16) graphed (the main path) against an eager twin over 5
    steps, bit for bit, the loss falling and the base unchanged; the flash
    forward, dQ and dK/dV launches counted and each kernel held against
    its plain version on one layer's inputs from the step itself; ms per
    step and peak memory beside the full graphed step (alternating
    rounds), and a profile of one LoRA step;
19. MoE training ("train moe"): the MoE model of phase 13 through
    ``build_train_step(attention="flash")`` (B 4, S 1024, bf16, remat
    "blocks") graphed (the main path) against an eager twin over 4 steps,
    bit for bit, the loss falling, the flash launches counted; ms per
    step, tokens/s, peak memory and a profile of one step;
20. the graphed bf16 step under remat "dots", "blocks" and "none" from the
    same init: bit-equal over 3 steps, the flash forward 2·L a step under
    "dots" and "blocks" and L under "none", each policy's peak memory and
    step time (alternating rounds);
21. resume: the graphed bf16 step saved after 2 steps by
    ``TrainCheckpointer``, step 3 run, the state restored into the step's
    own tensors, step 3 run again: the same loss bit for bit, no new
    capture;
22. training in f32 at 2 layers: the graphed flash step against its eager
    twin bit for bit and against dense over 3 steps (through the fma
    kernels only);
23. mesh training ("train mesh"): four ranks started once on the one card
    (``parallel/ranks.RankPool``, a gloo group over CUDA tensors; what gloo
    cannot take crosses through pinned host memory, counted), running
    ``build_train_step(mesh=..., attention="flash")`` at FLAGSHIP_MODERN,
    B 4, S 1024, remat "blocks", lr 3e-4, 3 steps from seeded weights: (a)
    ``MeshShape(seq=4)`` ring, (b) ``MeshShape(data=2, model=2)`` (sharded
    flash, tensor parallel), (c) ``MeshShape(seq=4)`` Ulysses, (d) 2 slices
    x ``MeshShape(data=2)`` in bf16, then (a)-(d) in f32 at 2 layers, and
    (e) a world-1 NCCL group in this process at ``MeshShape()`` (its step
    one CUDA graph, as on any NCCL mesh): each
    leg's losses against the single-card step from the same weights and
    tokens (1e-3 relative in bf16, 1e-5 in f32), its step-1 gradients
    (within 5e-2 of each leaf's largest in bf16, 1e-4 in f32) and its
    parameters after 3 steps (within lr x steps / 2 plus 4 rounding units
    of each leaf's largest), its flash launches summed over ranks equal
    to the ring's schedule, and per leg ms per step, collective bytes by
    kind (and through the host) and peak memory by rank.  In the same
    pool: (f) ``pp_burnin.build_pp_train_step`` on ``MeshShape(pipe=2,
    model=2)``, megatron, 2 microbatches, and (g) the same in megatron-sp
    (the ``collective_matmul`` rings), bf16 at 8 layers and f32 at 2, held
    like (a)-(e) against the single card's ``attention="dense"`` step,
    with no flash launch (the pipeline's attention is plain, as the
    reference's); (h) ``moe.topk_moe`` over ``MeshShape(data=4)``,
    Mixtral-8x7B's 8 experts and top 2 at d 1024, d_ff 4096, 4096 tokens:
    in f32 at capacity factor 8 the output and the expert stacks'
    gradients within 1e-4 of each one's largest element of the dropless
    oracle on rank 0, the dropped copies at factors 2 and 1 equal to a
    host recount of the queues (some at 1), forward + backward timed in
    f32 and bf16 at factor 2; (i) ``sharded_tp_mlp`` on ``MeshShape(
    model=4)``, bidirectional, ``[4, 1024, 1024] x [1024, 4096]``: the
    output and the three gradients against the dense MLP within 1e-4 of
    the largest in f32 and 4 bf16 steps in bf16, each timed; (j)
    ``data.TokenBatches`` over a seeded ``[16, 1024]`` token array feeding
    leg (b)'s step each rank's rows only, B 4, 3 steps: every block its
    rows of the host's global batch, the losses within the bf16 loss
    tolerance of the same step fed the whole batches (bit for bit
    printed), the flash launches the schedule's.  The gloo
    hops go through the host, so the rings' numbers are correctness and
    bytes, not overlap.  (k) the mesh checkpoint (``TrainCheckpointer`` with
    ``MeshLayout``) of leg (b)'s step at FLAGSHIP_MODERN in bf16: 2 steps, a
    save, step 3, a restore on the same mesh and step 3 again, the loss and
    state bit for bit; then the save restored into a ``MeshShape(seq=4)``
    ring step, its gathered params and AdamW state equal to the saved ones
    byte for byte and its step 3 within the bf16 loss tolerance; the bytes
    each rank writes, the save and restore times, the flash launches the
    schedule's.  Leg (e) then probes capture: each collective the mesh
    steps issue (all-reduce, the list all-gather, all_to_all_single, batch
    isend/irecv, an all-reduce from autograd's backward thread; and
    all_gather_into_tensor, reduce_scatter_tensor and broadcast, reported)
    called directly on the world-1 NCCL group, past the port's one-rank
    short-circuits, captured by ``graphs.cuda_capture`` and replayed on new
    inputs == eager calls (a used one that fails fails the phase); and
    runs the world-1 mesh step graphed against an eager twin, 5 steps bit
    for bit (losses, params, count, moments), 1 capture (ms, pool MiB),
    the flash launches the schedule's, then host-clock ms a step of the
    graphed and eager mesh steps and the single card's graphed step in 4
    alternating rounds of 5;
24. the pod's entry points ("pod entry points"), each leg timed: (a)
    ``python -m k8s_dra_driver_torch.consumer --check --serve-demo`` with
    ``TPU_VISIBLE_DEVICES=0`` (exit 0; 4 requests, 36 tokens, a prefix hit,
    free blocks, unsharded); (b) ``--check`` on a claim of cards 0,1 on the
    one card (exit 1 with "DEVICE MISMATCH", before any process group);
    (c) ``consumer.serve_demo`` in this process (head dim 32), every token
    teacher-forced within 0.25, the append kernel at nq 1 and nq 3 on each
    layer's first window against its plain version; (d) the demo on 2 gloo
    ranks sharing the card over ``MeshShape(data=2)``, every token
    teacher-forced, its streams against (c)'s counted;
25. (run right after phase 15) serving across worker processes ("serve
    workers"): this script listens on 127.0.0.1 and spawns two ``python -m
    k8s_dra_driver_torch.models.transport`` workers on the card, a prefill
    and a decode one, each one paged engine of phase 15's leg (a)
    (FLAGSHIP_MODERN in bf16, 8 slots, block 16, bucket 256, seed 0), and
    sends them (a)'s 8 requests through the port's own framing, each
    HANDOFF on to the decode worker as a KV frame: every request completes
    once, every ACK ok, every token teacher-forced within 0.25, the
    streams (a)'s bit for bit, the decode worker's append launches (from
    its launch line) above 0; the same in f32 at 2 layers against an
    in-process run of (a)'s path; each worker's start-up, the KV frame's
    bytes, HANDOFF-to-ACK host-clock medians beside the in-process
    capture, wire and inject medians, and tokens/s;
26. (run last) the self-test ("selftest"): ``tpuinfo.selftest.run_selftest()``
    in its subprocess on the card, ``ok`` with platform "gpu", one device a
    card and its latency;
27. (run right after phase 24) the port's entry point ("entry point",
    ``k8s_dra_driver_torch/entry.py``), each leg timed: (a) ``entry()``'s FLAGSHIP_MODERN forward at B 8 x
    1024 as a ``GraphedProgram("forward")``, its logits ``[8, 1024,
    32768]`` f32 bit for bit an eager call's, capture ms, pool MiB, peak
    memory, graphed and eager ms in alternating rounds beside the bound;
    (b) the classic ``FLAGSHIP`` forward (seeds 2 and 3), finite, two calls
    bit for bit; (c) ``entry.dryrun_multichip(8)``, 8 gloo ranks sharing
    the card: the reference's 13 lines at 8 (losses masked, finite; the
    multislice training leg runs only from 8), the flash launches summed
    over ranks the first leg's schedule (the ring over ``seq`` 2 at
    ``model`` 4), the append kernel launched, and the flash forward, dQ
    and dK/dV at D 16 in bf16 on that leg's layer-0 inputs, causal and in
    the ring's mode, elementwise against their plain versions;
28. (run right after phase 25) the port's own serving supervisor ("serve
    disagg"): (a) the reference's disaggregated mix (4 long requests of
    255 prompt and 128 new tokens queued ahead of 8 short ones of 16 and
    8, greedy, seed ``SEED + 91``) through one graphed paged engine of 8
    slots and through the port's ``DisaggRouter`` over 2 prefill engines
    (4 slots, 4 x 16 + 1 blocks) and 2 decode engines (4 slots, 4 x 24 + 1
    blocks) of one set of weights, each after a warm-up through its own
    engines: every request once at its token count, 12 handoffs, no
    fallback, every transfer ``ok``, every token teacher-forced within
    0.25, append launches in the decode pools, the append kernel against
    its plain version on decode engine 0's first injected window, every
    pool's blocks back; the short requests' TTFT and end-to-end tails
    from the request traces, wall time and tokens/s of each run; (b) the
    router over the port's ``TransportHub`` and phase 25's two workers
    (``RemotePool`` s, a ``TransportChannel``) on phase 25's 8 requests
    after a warm-up: every request once, every ACK ok, no fallback,
    teacher-forced, the decode worker's append launches; HANDOFF to ACK
    medians split at the KV frame's send, ``FLEET``'s TELEM frames, tokens/s;
    (c) (a)'s router with its channel dropping one transfer, putting one
    over its deadline and corrupting one: those three fall back under
    their reasons and re-prefill (teacher-forced), the others ``ok``, no
    block leaked;
29. (run right after phase 28) the fleet prefix tier, the autoscaler and
    the workload generator ("serve fleet"), FLAGSHIP_MODERN in bf16,
    paged engines of 4 slots, block 16, bucket 256, each after a warm-up:
    (a) ``workload.generate_shared_prefix`` (seed 11: 32 arrivals over 4
    system prompts of 128 tokens) through a ``FleetRouter`` of 3 engines
    with 128-block prefix stores and the port's ``FleetPrefixTier``, then
    through 3 more without a tier: remote pulls > 0, each pull's injected
    blocks the owner's export byte for byte, the index the stores'
    prefixes, no block leaked, every stream the tier-less run's or within
    the 0.25 gap (both runs teacher-forced); pull ms (export, wire,
    inject), TTFT by admission kind, tokens/s; the append kernel against
    its plain version on engine A's first warm-up decode window; (b)
    ``workload.generate`` with a 6x flash crowd (70 arrivals) through a
    ``FleetAutoscaler`` over one engine on a simulated clock, new engines
    built on the card: a scale-up whose replica serves and launches the
    append kernel, a scale-down that moves live streams, every stream
    once and teacher-forced, blocks back, the events under their
    correlations; spawn ms, the spawned engine's graphs, drain ms,
    replicas over time; (c) the same traffic through a ``DisaggRouter``
    of 2 + 2 engines while a ``PoolRebalancer`` moves one replica between
    the pools with streams in flight: every stream once and
    teacher-forced, blocks back, one correlation for the move.
30. (run right after phase 24) the driver's node half ("driver node"):
    (a) the enumerator's shim built, then real-mode enumeration in a child
    that never imports torch, against nvidia-smi and torch (count, UUID,
    memory, SMs, PCI address, the node present and healthy), the child
    holding no context on the card, cold and warm ms; (b) ``Driver``
    publishing the card into the port's in-memory API server; (c) the
    self-test sweep on the idle card (overlay empty), a stub report
    failing card 0 (published ``selftest-failed``, its prepare refused),
    a passing one restoring it; (d) a one-card claim prepared, its CDI
    nodes present, the consumer child in the spec's environment through
    ``--check --serve-demo`` with phase 24 (a)'s gates, in turns with
    (a)'s command, two runs each, and not slower than it, its append
    launches counted, unprepare removing spec and checkpoint entry; (e) a
    TimeSlicing claim with the port's host-mode daemon: two consumer
    children's leased card work never overlaps.
31. (right after phase 30) the closed loop ("driver loop"): one node over
    the real card (the port's in-memory API server with the reference's
    DeviceClasses, a real-mode ``Driver``, the port's ``Allocator``) and a
    ``DiagnosticsServer``. (a) ``apply_spec(tpu-test2)``: the class's CEL
    picks the published card, the allocator gives it to the pod, the CDI
    nodes exist, the consumer child in the claim's environment passes
    ``--check --serve-demo`` with phase 24 (a)'s gates, its append launches
    counted; (b) ``tpu-test1``'s second pod is refused by the spec runner
    with nothing half-done; (c) ``tpu-test3``'s shared claim goes with its
    last pod; (d) a stub self-test report fences the card: the allocator
    refuses a claim, a passing report restores it; (g) ``/metrics``,
    ``/debug/journal`` and ``/debug/state`` show the loop; (e) the
    kubelet's gRPC face: the handshake, 100 claim-to-prepared cycles over
    the socket against 100 in process (p50/p99 ms, host clock), and the
    plugin binary with ``--fake-cluster`` as a child; (f) the reference
    bench's scheduler throughput over 4 fake v5e-16 hosts (allocations/s,
    CEL evaluations an allocation, index hits and misses).

The line before the last lists the kernels with their launch counts on the
paths that run them (serving, LoRA and MoE serving, the decode engines
after a handoff, in this process and in the decode workers, the
disaggregated router's engines and its decode worker, the fleet phase's
measured runs, the sharded
engine's ranks, training, LoRA, MoE and mesh training, the serving demo,
the prepared consumer's demos, the closed loop's demo and the dry run at 8)
and their times; the last line is the JSON device
record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import traceback

import numpy as np

SEED = 0
DEV = "cuda"  # the card; a rehearsal on the CPU may set "cpu"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at 700 W
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # tensor-core bf16; f32 off the tensor cores
# why each serving phase's logit-gap tolerance is what it is, by "float32?"
TOL_WHY = {
    False: "bf16 weights, activations and pool rounded at other places by the "
           "paged kernel and batch-8 products than by the batch-1 dense path",
    True: "float32 throughout, sums in another order; TF32 off",
}
KERNELS = {
    # one CUDA source, two instantiations (APPEND on/off); the serving path
    # runs the append one, whose numbers this entry carries
    "paged_attention": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/paged_attention.cu",
        replaces="k8s_dra_driver_tpu/ops/paged_attention.py:64",
    ),
    "paged_attention_window": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/paged_attention.cu",
        replaces="k8s_dra_driver_tpu/ops/paged_attention.py:396",
    ),
    # one CUDA source, two kernels chosen by M and dtype: the split-K GEMV
    # (bf16 decode, M <= 16; f32 at every M) and the wgmma GEMM (bf16 prefill)
    "int4_matmul": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/int4_matmul.cu",
        replaces="k8s_dra_driver_tpu/ops/int4_matmul.py:41",
    ),
    "int4_matmul_prefill": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/int4_matmul.cu",
        replaces="k8s_dra_driver_tpu/ops/int4_matmul.py:41",
    ),
    # each flash pass: TMA + wgmma for bf16 (the training path), f32 FMAs
    # on the CUDA cores for f32 (the f32 training phase)
    "flash_fwd": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/flash_attention.cu",
        replaces="k8s_dra_driver_tpu/ops/flash_attention.py:31",
    ),
    "flash_fwd_f32": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/flash_attention.cu",
        replaces="k8s_dra_driver_tpu/ops/flash_attention.py:31",
    ),
    "flash_bwd_dq": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/flash_attention.cu",
        replaces="k8s_dra_driver_tpu/ops/flash_attention.py:137",
    ),
    "flash_bwd_dkv": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/flash_attention.cu",
        replaces="k8s_dra_driver_tpu/ops/flash_attention.py:179",
    ),
    "flash_bwd_dq_f32": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/flash_attention.cu",
        replaces="k8s_dra_driver_tpu/ops/flash_attention.py:137",
    ),
    "flash_bwd_dkv_f32": dict(
        route="cuda", source="k8s_dra_driver_torch/csrc/flash_attention.cu",
        replaces="k8s_dra_driver_tpu/ops/flash_attention.py:179",
    ),
}
# kernels whose ptxas report must show 0 bytes of spill stores: the D 64
# backward kernels, bf16 and f32, and the D 64 f32 forward
NO_SPILL = ("flash_bwd_dq_wgmma_kernelILi64E", "flash_bwd_dkv_wgmma_kernelILi64E",
            "flash_fwd_fma_kernelILi64E", "flash_bwd_dq_fma_kernelILi64E",
            "flash_bwd_dkv_fma_kernelILi64E")
# the f32 kernels' passes, as flash_fma_smem numbers them
FMA_PASSES = {"fwd": 0, "dq": 1, "dkv": 2}
KERNEL_SOURCES = ["int4_matmul", "paged_attention", "flash_attention"]


def log(*a):
    print(*a, flush=True)


def sync(torch):
    if DEV == "cuda":
        torch.cuda.synchronize()


def bound(bytes_moved: float, ops: float, dtype_name: str):
    """(least ms, what bounds it) from bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Mean device time of one call, L2 flushed before each call (the
    serving step finds each layer's operands cold: ~240 MB of weights pass
    between two visits).  A spin kernel of a few ms runs ahead of the
    start event, so the call is fully queued before the device reaches it:
    the events then time the device's work, not the host's launches."""

    SPIN_CYCLES = 8_000_000  # ~4 ms at the H100's SM clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device=DEV)

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        sync(torch)
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / iters


def phase_environment(torch):
    from k8s_dra_driver_torch.ops import _build

    log("device:", torch.cuda.get_device_name(0), "count:", torch.cuda.device_count())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "not read"
    log("nvidia-smi:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda)
    t0 = time.perf_counter()
    # built from the sources every run: a library left by an earlier run
    # would be loaded without a ptxas report to check
    for name in KERNEL_SOURCES:
        _build.library_path(name).unlink(missing_ok=True)
    _build.build(KERNEL_SOURCES)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    spills, regs = {}, {}
    for name, report in _build.ptxas_reports.items():
        log(f"--- ptxas -v: {name}.cu")
        entry = ""
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("   ", line.strip())
            if "Compiling entry" in line:
                entry = line
            elif any(k in entry for k in NO_SPILL):
                key = entry.split("'")[1]
                if "spill stores" in line:
                    stores = int(line.split("bytes spill stores")[0].split(",")[-1])
                    spills[key] = max(spills.get(key, 0), stores)
                elif "registers" in line:
                    regs[key] = int(line.split("Used")[1].split("registers")[0])
    log(f"spill stores of the D 64 backward kernels (bf16, f32) and f32 forward: {spills}")
    fma_smem = flash_fma_smem()
    for k in NO_SPILL[2:]:
        key = next((e for e in regs if k in e), None)
        kind = next(n for n in FMA_PASSES if f"_{n}_fma" in k)
        log(f"  {k}: {regs.get(key)} registers, {spills.get(key)} bytes of spill stores; "
            f"dynamic shared memory by head dim {fma_smem[kind]} bytes (a block may have "
            f"232448)")
    if len(spills) != len(NO_SPILL) or any(spills.values()):
        raise AssertionError(f"the D 64 flash kernels spill or were not reported: {spills}")
    if max(max(v.values()) for v in fma_smem.values()) > 232448:
        raise AssertionError(f"an f32 flash kernel asks for too much shared memory: {fma_smem}")
    return card


def flash_fma_smem():
    """{"fwd"/"dq"/"dkv": {head dim: bytes of dynamic shared memory}} of the
    f32 kernels, as their launchers ask for it."""
    import ctypes

    from k8s_dra_driver_torch.ops import _build
    from k8s_dra_driver_torch.ops import flash_attention as fa

    fn = _build.load("flash_attention", fa._LAUNCHERS).flash_fma_smem
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return {kind: {d: fn(d, n) for d in fa.KERNEL_HEAD_DIMS} for kind, n in FMA_PASSES.items()}


def _paged_case(torch, dtype, nq, lengths, *, L=8, hq=16, hkv=4, d=64, bs=16, mb=64, seed=1):
    g = torch.Generator(device=DEV).manual_seed(seed)
    b = len(lengths)
    n_pool = 1 + b * mb
    def rnd(*shape):
        return torch.randn(shape, generator=g, device=DEV).to(dtype)
    k_pools, v_pools = rnd(L, n_pool, hkv, d, bs), rnd(L, n_pool, hkv, d, bs)
    perm = torch.randperm(b * mb, generator=g, device=DEV) + 1
    table = perm.reshape(b, mb).to(torch.int32)
    pos = torch.tensor([max(n - nq, 0) for n in lengths], dtype=torch.int32, device=DEV)
    q = rnd(b, nq, hq, d)
    new_k, new_v = rnd(b, nq, hkv, d), rnd(b, nq, hkv, d)
    return k_pools, v_pools, table, pos, q, new_k, new_v


def _paged_work(lengths, nq, hq, hkv, d, bs, itemsize, append):
    """(bytes, operations) the function needs for these rows: each input
    read once, each output written once.  With ``append`` the window's
    keys come from new_k/new_v (read once, stored once) and the pool
    supplies the keys before the window; without, the pool supplies all."""
    b = len(lengths)
    moved = 2 * b * nq * hq * d * itemsize + 8 * b      # q in, out; pos, write mask
    ops = 0
    for n in lengths:
        p0 = max(n - nq, 0)
        pool_keys = p0 if append else p0 + nq
        moved += 2 * pool_keys * hkv * d * itemsize       # K and V
        moved += 4 * (-(-(p0 + nq) // bs))                # live table entries
        ops += sum(4 * (p0 + j + 1) * hq * d for j in range(nq))  # QK and PV
    if append:
        moved += 2 * 2 * b * nq * hkv * d * itemsize      # new k/v read, stored
    return moved, ops


PAGED_STEP = {
    # every paged output element is held to
    #   min(step * (|plain| + mag) + 2^-16 * mag, cap),
    # mag the plain version's softmax weights applied to |V| in f32, so an
    # element summed from large terms gets their rounding and a large one
    # its own; cap is the absolute limit this check held before, so no
    # element is held more loosely than it was
    "float32": (2 ** -16, 1e-4, "f32 sums in another order: splits merged by their (m, l) "
                                "against one softmax over the row"),
    "bfloat16": (2 ** -7 + 2 ** -16, 3e-2, "one bf16 step: P rounded to bf16 on each side, in "
                                           "the kernel against its split's max before "
                                           "normalisation, in the plain version after it, both "
                                           "within one step of mag; the output rounded once"),
}


def paged_check(got, want, mag, step, cap):
    """(max |err|, the limit at that element, max |plain|, elements over
    their limit)."""
    if mag.shape != want.shape:
        raise AssertionError(f"mag {tuple(mag.shape)} does not match {tuple(want.shape)}")
    limit = (step * (want.float().abs() + mag) + 2 ** -16 * mag).clamp(max=cap)
    err = (got.float() - want.float()).abs()
    worst = int(err.argmax())
    return (err.max().item(), limit.flatten()[worst].item(), want.float().abs().max().item(),
            int((err > limit).sum().item()))


def _workspace_bytes(lengths, nq, hq, hkv, d, bs, mb):
    """(bytes of the live splits' partials, each written once and read
    once; bytes allocated) of one paged call."""
    from k8s_dra_driver_torch.ops import paged_attention as pa

    pages, n_splits = pa.split_schedule(bs, mb)
    row = hkv * (hq // hkv) * nq * (d + 2) * 4
    live = sum(-(-min(-(-(max(n - nq, 0) + nq) // bs), mb) // pages) for n in lengths)
    return live * row, len(lengths) * n_splits * row


def phase_kernels(torch, timer: Timer):
    import torch.nn.functional as F

    from k8s_dra_driver_torch.ops import paged_attention as pa

    results = {}
    ragged = [1, 1024] + np.random.RandomState(SEED).randint(2, 1024, size=6).tolist()
    split = pa.split_schedule(16, 64)[0] * 16
    # rows at the split boundaries: with nq 4, pos = split - 1 leaves the
    # second split masked for query 0, and pos = split - 2 puts the window
    # across a page and a split boundary
    edges = [1, split - 1, split, split + 1, split + 2, split + 3, 1024, 2 * split + 3]
    worst = {"append": 0.0, "window": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        step, cap, why = PAGED_STEP[dname]
        log(f"paged tolerance {dname}: |err| <= min({step:.4g} * (|plain| + mag) + 2^-16 * mag, "
            f"{cap:g}) per element, mag = the plain softmax weights applied to |V| in f32 "
            f"({why}; {cap:g} is the earlier absolute limit)")
        for nq in (1, 4):
            for label, lengths in (("ctx512", [512] * 8), ("ragged", ragged), ("edges", edges)):
                kp, vp, table, pos, q, nk, nv = _paged_case(torch, dtype, nq, lengths)
                wmask = (torch.arange(8, device=DEV) % 3 != 1).to(torch.int32)
                layer = 3
                mag = pa.paged_append_attention_plain(
                    q.float(), nk.float(), nv.float().abs(), kp.float(), vp.float().abs(),
                    table, pos, layer, write_mask=wmask,
                )
                k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
                del kp, vp
                out_k, _, _ = pa.paged_append_attention(q, nk, nv, k1, v1, table, pos, layer,
                                                        write_mask=wmask)
                out_p = pa.paged_append_attention_plain(q, nk, nv, k2, v2, table, pos, layer,
                                                        write_mask=wmask)
                again, _, _ = pa.paged_append_attention(q, nk, nv, k1, v1, table, pos, layer,
                                                        write_mask=wmask)
                sync(torch)
                err, limit, top, over = paged_check(out_k, out_p, mag, step, cap)
                same = bool(torch.equal(again, out_k))
                pools_equal = bool(torch.equal(k1[:, 1:], k2[:, 1:])
                                   and torch.equal(v1[:, 1:], v2[:, 1:]))
                case = f"{dname} nq={nq} {label} lengths={lengths}"
                log(f"  append {case}: max_abs_err {err:.3g}, limit there {limit:.3g}, "
                    f"max|plain| {top:.3g}; elements over the limit {over}; a second call "
                    f"bit-identical: {same}; pools equal outside block 0: {pools_equal}")
                if over or not same or not pools_equal:
                    raise AssertionError(f"paged append kernel disagrees ({case})")
                del k1, v1
                # window / decode: the window keys are in the pool now (k2, v2)
                mag_w = pa.paged_window_attention_plain(
                    q.float(), k2[layer].float(), v2[layer].float().abs(), table, pos
                )
                out_w = pa.paged_window_attention(q, k2[layer], v2[layer], table, pos)
                out_wp = pa.paged_window_attention_plain(q, k2[layer], v2[layer], table, pos)
                same_w = bool(torch.equal(
                    pa.paged_window_attention(q, k2[layer], v2[layer], table, pos), out_w))
                errw, limitw, topw, overw = paged_check(out_w, out_wp, mag_w, step, cap)
                log(f"  window {case}: max_abs_err {errw:.3g}, limit there {limitw:.3g}, "
                    f"max|plain| {topw:.3g}; elements over the limit {overw}; a second call "
                    f"bit-identical: {same_w}")
                if overw or not same_w:
                    raise AssertionError(f"paged window kernel disagrees ({case})")
                if nq == 1:
                    lens = pos + 1
                    out_d = pa.paged_decode_attention(q[:, 0], k2[layer], v2[layer], table, lens)
                    errd, limitd, _, overd = paged_check(out_d, out_wp[:, 0], mag_w[:, 0], step,
                                                          cap)
                    log(f"  decode {case}: max_abs_err {errd:.3g}, limit there {limitd:.3g}; "
                        f"elements over the limit {overd}")
                    if overd:
                        raise AssertionError(f"paged decode kernel disagrees ({case})")
                if dtype == torch.bfloat16:
                    worst["append"] = max(worst["append"], err)
                    worst["window"] = max(worst["window"], errw)
                del k2, v2

    # times at the serving shape: B=8, bf16, nq=1, context 512 (and ragged)
    for label, lengths in (("ctx512", [512] * 8), ("ragged", ragged)):
        dtype = torch.bfloat16
        kp, vp, table, pos, q, nk, nv = _paged_case(torch, dtype, 1, lengths)
        layer = 3
        w = _paged_work(lengths, 1, 16, 4, 64, 16, 2, append=True)
        ms_k = timer.ms(lambda: pa.paged_append_attention(q, nk, nv, kp, vp, table, pos, layer))
        ms_p = timer.ms(lambda: pa.paged_append_attention_plain(q, nk, nv, kp, vp, table, pos, layer))
        ms_wk = timer.ms(lambda: pa.paged_window_attention(q, kp[layer], vp[layer], table, pos))
        ms_wp = timer.ms(lambda: pa.paged_window_attention_plain(q, kp[layer], vp[layer], table, pos))
        # yardstick: one SDPA call over K/V gathered (and widened to the
        # query heads) beforehand
        ids = table.long()
        kg = kp[layer][ids].permute(0, 2, 1, 4, 3).reshape(8, 4, -1, 64)  # [B, Hkv, T, d]
        vg = vp[layer][ids].permute(0, 2, 1, 4, 3).reshape(8, 4, -1, 64)
        kg, vg = kg.repeat_interleave(4, dim=1), vg.repeat_interleave(4, dim=1)
        qs = q.permute(0, 2, 1, 3)                                      # [B, Hq, 1, d]
        kpos = torch.arange(kg.shape[2], device=DEV)
        mask = (kpos[None, :] <= pos[:, None])[:, None, None, :]
        def sdpa():
            return F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask)

        ms_lib = timer.ms(sdpa)  # the yardstick of both the append and the read-only kernel
        ww = _paged_work(lengths, 1, 16, 4, 64, 16, 2, append=False)
        b_ms, b_by = bound(w[0], w[1], "bfloat16")
        bw_ms, bw_by = bound(ww[0], ww[1], "bfloat16")
        ws_live, ws_alloc = _workspace_bytes(lengths, 1, 16, 4, 64, 16, 64)
        log(f"  paged append bf16 B=8 nq=1 {label}: kernel {ms_k * 1e3:.1f} us, plain "
            f"{ms_p * 1e3:.1f} us, sdpa {ms_lib * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us "
            f"({b_by}, {w[0] / 1e6:.2f} MB, {w[1] / 1e6:.1f} MFLOP); workspace "
            f"{ws_live / 1e3:.1f} KB of live partials, each written once and read once "
            f"({ws_alloc / 1e3:.1f} KB allocated)")
        log(f"  paged window bf16 B=8 nq=1 {label}: kernel {ms_wk * 1e3:.1f} us, plain "
            f"{ms_wp * 1e3:.1f} us, sdpa {ms_lib * 1e3:.1f} us, bound {bw_ms * 1e3:.2f} us "
            f"({bw_by})")
        if label == "ctx512":
            # what the events see besides the kernels, and each launch's
            # own device time on a cold L2
            floor = timer.ms(lambda: None)
            log(f"  timer floor (nothing between the events): {floor * 1e3:.1f} us")

            def append():
                pa.paged_append_attention(q, nk, nv, kp, vp, table, pos, layer)

            def cold_call():
                timer.flush.zero_()
                append()

            for what, fn in (("after an L2 flush", cold_call), ("warm, run again", append)):
                profile_window(torch, f"  paged append bf16 B=8 nq=1 ctx512 {what}", fn, top=0,
                               watch=("paged_attention_partial", "paged_attention_merge"))
            results["paged_attention"] = dict(
                ms=ms_k, plain_ms=ms_p, library_ms=ms_lib, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=worst["append"],
            )
            results["paged_attention_window"] = dict(
                ms=ms_wk, plain_ms=ms_wp, library_ms=ms_lib, bound_ms=bw_ms,
                bound_by=bw_by, max_abs_err=worst["window"],
            )
    paged_split_sweep(torch, timer)

    results.update(phase_int4(torch, timer))
    return results


def paged_split_sweep(torch, timer: Timer, keys=(32, 64, 128)):
    """The append call's time at B=8, bf16, nq=1 for each split size, at
    context 512 and at the steady-decode context ~152, the module's split
    size restored after."""
    from k8s_dra_driver_torch.ops import paged_attention as pa

    kept = pa.SPLIT_KEYS
    cases = {n: _paged_case(torch, torch.bfloat16, 1, [n] * 8) for n in (512, 152)}
    try:
        for split_keys in keys:
            pa.SPLIT_KEYS = split_keys
            times = []
            for n, (kp, vp, table, pos, q, nk, nv) in cases.items():
                ms = timer.ms(lambda: pa.paged_append_attention(q, nk, nv, kp, vp, table, pos, 3))
                times.append(f"ctx {n} {ms * 1e3:.1f} us")
            log(f"  paged split sweep: {split_keys} keys per split "
                f"({pa.split_schedule(16, 64)[0]} pages): {', '.join(times)}"
                f"{' (the module constant)' if split_keys == kept else ''}")
    finally:
        pa.SPLIT_KEYS = kept


INT4_STEP = {
    # every int4 output element is held to step * |plain| + 2^-16 * mag,
    # mag = |x| @ |dequant(W)| in f32: both sides sum the same f32 products
    # in another order, then round the output once
    "float32": (0.0, "f32 sums in another order (split-K slices, shuffle trees); TF32 off"),
    "bfloat16": (2 ** -7 + 2 ** -16, "one bf16 step: the f32 sums, in another order, may "
                                     "round the output to the neighbouring bf16 value"),
}


def int4_check(x, packed, scale, got, want, step):
    """(max |err|, the limit at that element, max |plain|, RMS of plain,
    elements over their limit)."""
    import torch

    from k8s_dra_driver_torch.ops import int4_matmul as i4

    w = i4.dequant_int4(packed, scale, 64, x.dtype).float()
    mag = x.float().abs() @ w.abs()
    limit = step * want.float().abs() + 2 ** -16 * mag
    err = (got.float() - want.float()).abs()
    worst = int(err.argmax())
    w32 = want.float()
    return (err.max().item(), limit.flatten()[worst].item(), w32.abs().max().item(),
            w32.square().mean().sqrt().item(), int((err > limit).sum().item()))


def phase_int4(torch, timer: Timer, ms=(8, 256)):
    """Both int4 kernels at the serving path's shapes (the four block
    matrices of FLAGSHIP_MODERN; M 8 at decode, 256 at the prompt bucket)
    against the plain version, elementwise, in bf16 and f32; identity rows
    through both; repeated calls bit for bit; then timed in bf16 beside
    the plain version and ``torch.matmul`` on the dequantized weight."""
    from k8s_dra_driver_torch.models import quant
    from k8s_dra_driver_torch.ops import int4_matmul as i4

    g = torch.Generator(device=DEV).manual_seed(SEED + 2)
    shapes = {"qkv": (1024, 1536), "attn_out": (1024, 1024),
              "mlp_up": (1024, 4096), "mlp_down": (4096, 1024)}
    for dname, (step, why) in INT4_STEP.items():
        log(f"int4 tolerance {dname}: |err| <= {step:.4g} * |plain| + 2^-16 * mag per element, "
            f"mag = |x| @ |dequant(W)| ({why})")
    worst = {"int4_splitk": 0.0, "int4_wgmma": 0.0}
    results = {}
    for name, (k, n) in shapes.items():
        wq = quant.Quantized4Matrix.quantize(
            (torch.randn((k, n), generator=g, device=DEV) * k ** -0.5).to(torch.bfloat16)
        )
        w_deq = wq.dequant()
        if name == "qkv":
            # x = identity rows: the kernels' dequantized weights, read exactly
            eye = torch.eye(k, dtype=torch.bfloat16, device=DEV)
            for rows in (8, k):
                got = i4.int4_matmul(eye[:rows], wq.packed, wq.scale, 64)
                exact = bool(torch.equal(got, w_deq[:rows]))
                log(f"  int4 dequant through {i4.kernel_for(rows, torch.bfloat16)} ({rows} "
                    f"identity rows) bit-identical to dequant(): {exact}")
                if not exact:
                    raise AssertionError("int4 kernel's dequantized weights differ")
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            for m in ms:
                x = torch.randn((m, k), generator=g, device=DEV).to(dtype)
                kern = i4.kernel_for(m, dtype)
                o = i4.int4_matmul(x, wq.packed, wq.scale, 64)
                op = i4.int4_matmul_plain(x, wq.packed, wq.scale, 64)
                again = i4.int4_matmul(x, wq.packed, wq.scale, 64)
                sync(torch)
                err, limit, top, rms, over = int4_check(x, wq.packed, wq.scale, o, op,
                                                        INT4_STEP[dname][0])
                same = bool(torch.equal(o, again))
                log(f"  int4 {name} {dname} M={m} ({kern}): max_abs_err {err:.3g}, limit there "
                    f"{limit:.3g}, max|plain| {top:.3g}, rms {rms:.3g}; elements over the limit "
                    f"{over}; a second call bit-identical: {same}")
                if over or not same:
                    raise AssertionError(f"int4 {kern} disagrees ({name}, {dname}, M={m})")
                if dtype == torch.bfloat16:
                    worst[kern] = max(worst[kern], err)
        for m in ms:
            x = torch.randn((m, k), generator=g, device=DEV).to(torch.bfloat16)
            kern = i4.kernel_for(m, torch.bfloat16)
            ms_k = timer.ms(lambda: i4.int4_matmul(x, wq.packed, wq.scale, 64))
            ms_p = timer.ms(lambda: i4.int4_matmul_plain(x, wq.packed, wq.scale, 64))
            ms_lib = timer.ms(lambda: torch.matmul(x, w_deq))
            moved = m * k * 2 + k * n // 2 + (k // 64) * n * 4 + m * n * 2
            b_ms, b_by = bound(moved, 2 * m * k * n, "bfloat16")
            log(f"  int4 {name} M={m} K={k} N={n} ({kern}): kernel {ms_k * 1e3:.1f} us, plain "
                f"{ms_p * 1e3:.1f} us, matmul(dequantized) {ms_lib * 1e3:.1f} us, bound "
                f"{b_ms * 1e3:.2f} us ({b_by}, {moved / 1e6:.2f} MB, {2 * m * k * n / 1e9:.3f} "
                f"GFLOP)")
            if name == "mlp_up":
                results[kern] = dict(ms=ms_k, plain_ms=ms_p, library_ms=ms_lib, bound_ms=b_ms,
                                     bound_by=b_by)
    for kern in worst:
        results[kern]["max_abs_err"] = worst[kern]
    return {"int4_matmul": results["int4_splitk"], "int4_matmul_prefill": results["int4_wgmma"]}


FLASH_STEP = {
    # every flash output is held elementwise to
    #   step * (|plain| + mag) + 2^-16 * mag_f32,
    # mag the same sum over absolute terms (out: sum_k p|v| / l; dq:
    # scale sum_k |ds||k|; dk: scale sum_q |ds||q|; dv: sum_q p|dout|), so
    # a near-zero element summed from large terms gets their rounding and a
    # large one its own; mag_f32 is mag for out and dv, and for dq and dk
    # it takes p (|dout||v| + |dout||out|), the absolute size of the two
    # f32 dots whose difference dS is, in place of |dS|: the order of f32
    # sums decides dS near 0 (the first causal row's dS cancels to 0)
    "float32": (2 ** -16, "f32 sums in another order: 64-key tiles with an online rescale "
                          "against one pass in the forward, the kernels' FMA order against "
                          "cuBLAS's in the backward; TF32 off"),
    "bfloat16": (2 ** -7 + 2 ** -16, "one bf16 step: the forward rounds every P to bf16 on "
                                     "each side (against the running max in the kernel, the "
                                     "row's max in the plain version); in the backward, f32 "
                                     "sums in another order move a rounding of P or dS to "
                                     "the next bf16 value; each output is rounded once"),
}


def flash_limits(q, k, v, dout, causal, want, step):
    """Elementwise limits for ``want``, the plain versions' (out, lse, dq,
    dk, dv), the backward run on that out and lse: as ``FLASH_STEP`` says;
    lse within 2^-16 (1 + |lse|)."""
    import torch

    from k8s_dra_driver_torch.ops import flash_attention as fa

    out_p, lse_p = want[:2]
    mag = fa.flash_forward_plain(q, k, v.abs(), causal, out_dtype=torch.float32)[0]
    limits = [step * (out_p.float().abs() + mag) + 2 ** -16 * mag,
              2 ** -16 * (1 + lse_p.abs())]
    d32, v32, q32, k32 = (x.float() for x in (dout, v, q, k))
    p = torch.exp(fa._scores(q, k, causal) - lse_p[..., None])
    dp = torch.einsum("bqd,bkd->bqk", d32, v32)
    ds = (p * (dp - fa._delta(dout, out_p)[..., None])).to(q.dtype).float().abs()
    dots = p * (torch.einsum("bqd,bkd->bqk", d32.abs(), v32.abs())
                + (d32 * out_p.float()).abs().sum(-1)[..., None])
    sc = fa._scale(q.shape[-1])
    dq_p, dk_p, dv_p = (x.float().abs() for x in want[2:])
    return limits + [
        step * dq_p + sc * torch.einsum("bqk,bkd->bqd", step * ds + 2 ** -16 * dots, k32.abs()),
        step * dk_p + sc * torch.einsum("bqk,bqd->bkd", step * ds + 2 ** -16 * dots, q32.abs()),
        step * dv_p + (step + 2 ** -16) * torch.einsum(
            "bqk,bqd->bkd", p.to(dout.dtype).float(), d32.abs()),
    ]


def flash_check(got, want, limits):
    """Per output of (out, lse, dq, dk, dv): (max |err|, the limit at that
    element, max |plain|, RMS of plain, elements over their limit,
    elements that differ at all)."""
    rows = {}
    for name, g_, w_, limit in zip(("out", "lse", "dq", "dk", "dv"), got, want, limits):
        w32 = w_.float()
        err = (g_.float() - w32).abs()
        worst = int(err.argmax())
        rows[name] = (err.max().item(), limit.flatten()[worst].item(), w32.abs().max().item(),
                      w32.square().mean().sqrt().item(), int((err > limit).sum().item()),
                      int((g_ != w_).sum().item()))
    return rows


def _flash_work(bh, s, d, itemsize, causal):
    """(bytes, operations) of the forward, dQ and dK/dV at these shapes:
    each input read once, each output written once (lse and delta f32);
    2 operations per multiply-add over the (query, key) pairs attended."""
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    slab = bh * s * d * itemsize
    rows = bh * s * 4
    return {
        "flash_fwd": (3 * slab + slab + rows, 4 * pairs * d),         # QK, PV
        "flash_bwd_dq": (4 * slab + 2 * rows + slab, 6 * pairs * d),  # QK, dO.V, dS.K
        "flash_bwd_dkv": (4 * slab + 2 * rows + 2 * slab, 8 * pairs * d),  # + P.dO, dS.Q
    }


def phase_flash_kernels(torch, timer: Timer, bh: int = 64, seqs=(256, 1024), d: int = 64):
    """The flash kernels against their plain versions at the training
    path's shapes (B·H = 4 x 16 heads, D 64), then timed at the main path's
    (S 1024, causal) in bf16 and f32 beside the plain versions and SDPA."""
    import torch.nn.functional as F

    from k8s_dra_driver_torch.ops import flash_attention as fa

    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    worst = dict.fromkeys(names + tuple(n + "_f32" for n in names), 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        step, why = FLASH_STEP[dname]
        log(f"flash tolerance {dname}: out, dq, dk, dv each |err| <= {step:.4g} * (|plain| + "
            f"mag) + 2^-16 * mag_f32 per element, mag = the same sum over absolute terms, "
            f"mag_f32 = mag (out, dv) or the sum over dS's two f32 dots taken absolutely (dq, "
            f"dk) ({why}); "
            f"lse |err| <= 2^-16 * (1 + |lse|)")
        for s in seqs:
            for causal in (True, False):
                g = torch.Generator(device=DEV).manual_seed(SEED + s + causal)
                q, k, v, dout = (torch.randn((bh, s, d), generator=g, device=DEV).to(dtype)
                                 for _ in range(4))
                out, lse = fa._forward_bhsd(q, k, v, causal)
                out_p, lse_p = fa.flash_forward_plain(q, k, v, causal)
                # the backward kernels and their plain versions see the same
                # inputs: the plain forward's out and lse
                grads = fa._backward_bhsd(q, k, v, out_p, lse_p, dout, causal)
                grads_p = fa.flash_backward_plain(q, k, v, out_p, lse_p, dout, causal)
                sync(torch)
                want = (out_p, lse_p, *grads_p)
                rows = flash_check((out, lse, *grads), want,
                                   flash_limits(q, k, v, dout, causal, want, step))
                errs = {n: r[0] for n, r in rows.items()}
                case = f"{dname} BH={bh} S={s} D={d} causal={causal}"
                for name, (err, limit, top, rms, over, differ) in rows.items():
                    log(f"  flash {case} {name}: max_abs_err {err:.3g}, limit there "
                        f"{limit:.3g}, max|plain| {top:.3g}, rms {rms:.3g}; elements over "
                        f"the limit {over}, differing at all {differ}")
                    if over:
                        raise AssertionError(f"flash {name} disagrees ({case}): {over} elements "
                                             f"over their limit")
                tag = "_f32" if dtype == torch.float32 else ""
                for name, err in (("flash_fwd", errs["out"]), ("flash_bwd_dq", errs["dq"]),
                                  ("flash_bwd_dkv", max(errs["dk"], errs["dv"]))):
                    worst[name + tag] = max(worst[name + tag], err)
    for name, err in flash_ring_mode(torch, bh, seqs[0], d).items():
        worst[name] = max(worst[name], err)

    # times at the main path's shape, in bf16 (the training path) and f32,
    # beside yardsticks the port never calls: SDPA's forward, and its
    # backward through autograd (dQ, dK and dV together) on [B, H, S, D] =
    # [4, 16, S, 64]
    s = seqs[-1]
    g = torch.Generator(device=DEV).manual_seed(SEED + 11)
    inputs = [torch.randn((bh, s, d), generator=g, device=DEV).to(torch.bfloat16)
              for _ in range(4)]
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        tag = "_f32" if dtype == torch.float32 else ""
        q, k, v, dout = (x.to(dtype) for x in inputs)
        out, lse = fa._forward_bhsd(q, k, v, True)
        delta = fa._delta(dout, out)
        ms = {
            "flash_fwd": (timer.ms(lambda: fa._forward_bhsd(q, k, v, True)),
                          timer.ms(lambda: fa.flash_forward_plain(q, k, v, True))),
            "flash_bwd_dq": (timer.ms(lambda: fa._dq_bhsd(q, k, v, lse, dout, delta, True)),
                             timer.ms(lambda: fa._dq_plain(q, k, v, lse, dout, delta, True))),
            "flash_bwd_dkv": (timer.ms(lambda: fa._dkv_bhsd(q, k, v, lse, dout, delta, True)),
                              timer.ms(lambda: fa._dkv_plain(q, k, v, lse, dout, delta, True))),
        }
        qs, ks, vs = (x.reshape(-1, 16, s, d).detach().requires_grad_() for x in (q, k, v))
        ms_sdpa = timer.ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True))
        o_sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        do_sdpa = dout.reshape(-1, 16, s, d)
        ms_sdpa_bwd = timer.ms(
            lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), do_sdpa, retain_graph=True)
        )
        work = _flash_work(bh, s, d, q.element_size(), True)
        kern = dict(zip(names, kern_names(fa, dtype)))
        for name in names:
            b_ms, b_by = bound(*work[name], dname)
            lib = ms_sdpa if name == "flash_fwd" else ms_sdpa_bwd
            results[name + tag] = dict(ms=ms[name][0], plain_ms=ms[name][1], library_ms=lib,
                                       bound_ms=b_ms, bound_by=b_by,
                                       max_abs_err=worst[name + tag])
            log(f"  {name} {dname} ({kern[name]}) BH={bh} S={s} D={d} causal: kernel "
                f"{ms[name][0] * 1e3:.1f} us, plain {ms[name][1] * 1e3:.1f} us, sdpa "
                f"{'fwd' if name == 'flash_fwd' else 'bwd'} {lib * 1e3:.1f} us, bound "
                f"{b_ms * 1e3:.2f} us ({b_by}, {work[name][0] / 1e6:.1f} MB, "
                f"{work[name][1] / 1e9:.2f} GFLOP; the kernel at {b_ms / ms[name][0]:.3f} "
                f"of the bound's rate)")
        log(f"  sdpa {dname} backward covers dQ and dK/dV together: kernels "
            f"{(ms['flash_bwd_dq'][0] + ms['flash_bwd_dkv'][0]) * 1e3:.1f} us against "
            f"{ms_sdpa_bwd * 1e3:.1f} us")
        if dtype == torch.float32:
            profile_window(
                torch, f"  flash f32 backward (dQ, dK/dV) BH={bh} S={s} D={d} causal",
                lambda: (fa._dq_bhsd(q, k, v, lse, dout, delta, True),
                         fa._dkv_bhsd(q, k, v, lse, dout, delta, True)),
                top=2, watch=kern_names(fa, dtype)[1:])
    flash_f32_d128(torch, timer, bh, s)
    return results


def _check_rows(label, rows):
    for name, (err, limit, top, rms, over, differ) in rows.items():
        log(f"  {label} {name}: max_abs_err {err:.3g}, limit there {limit:.3g}, max|plain| "
            f"{top:.3g}, rms {rms:.3g}; elements over the limit {over}, differing at all "
            f"{differ}")
        if over:
            raise AssertionError(f"{label} {name} disagrees: {over} elements over their limit")


def flash_ring_mode(torch, bh: int, s: int, d: int, operands=None) -> dict:
    """The flash kernels as the ring runs them (``ops/ring_attention``), at
    the ring's shapes, each against its plain version on the same operands:
    the forward writing f32 partials (``out_dtype=float32``), causal and
    not; and the dQ and dK/dV kernels on the causal own block and a
    non-causal earlier block with the GLOBAL lse of the two blocks' merge
    and ``delta`` from the merged output, where a block's probabilities do
    not sum to 1.  Limits as ``FLASH_STEP``.  Seeded operands in f32 and
    bf16, or ``operands`` (q, own k and v, earlier k and v, dout, each
    ``[bh, s, d]`` in one dtype).  Returns the worst error per kernels-line
    row."""
    from k8s_dra_driver_torch.ops import flash_attention as fa
    from k8s_dra_driver_torch.ops.ring_attention import _merge_blocks

    worst = {}
    for dtype in ((operands[0].dtype,) if operands else (torch.float32, torch.bfloat16)):
        dname = str(dtype).split(".")[-1]
        tag = "_f32" if dtype == torch.float32 else ""
        step = FLASH_STEP[dname][0]
        g = torch.Generator(device=DEV).manual_seed(SEED + 21)
        q, k_own, v_own, k_prev, v_prev, dout = operands or (
            torch.randn((bh, s, d), generator=g, device=DEV).to(dtype) for _ in range(6))
        parts = {}
        for causal, k, v in ((True, k_own, v_own), (False, k_prev, v_prev)):
            got = fa._forward_bhsd(q, k, v, causal, out_dtype=torch.float32)
            want = fa.flash_forward_plain(q, k, v, causal, out_dtype=torch.float32)
            sync(torch)
            limits = flash_limits(q, k, v, dout, causal, (*want, *[want[0]] * 3), step)[:2]
            rows = flash_check(got, want, limits)
            _check_rows(f"flash ring f32-out forward {dname} BH={bh} S={s} D={d} "
                        f"causal={causal}", rows)
            worst["flash_fwd" + tag] = max(worst.get("flash_fwd" + tag, 0.0), rows["out"][0])
            parts[causal] = want
        out32, lse = _merge_blocks(*parts[True], *parts[False])
        out = out32.to(dtype)  # the ring keeps its output in q's dtype
        delta = fa._delta(dout, out)
        for causal, k, v in ((True, k_own, v_own), (False, k_prev, v_prev)):
            got = fa._backward_bhsd(q, k, v, out, lse, dout, causal, delta=delta)
            want = fa.flash_backward_plain(q, k, v, out, lse, dout, causal, delta=delta)
            sync(torch)
            limits = flash_limits(q, k, v, dout, causal, (out, lse, *want), step)[2:]
            rows = flash_check(got, want, limits)
            _check_rows(f"flash ring backward (global lse, given delta) {dname} BH={bh} "
                        f"S={s} D={d} causal={causal}",
                        dict(zip(("dq", "dk", "dv"), rows.values())))
            errs = [r[0] for r in rows.values()]
            worst["flash_bwd_dq" + tag] = max(worst.get("flash_bwd_dq" + tag, 0.0), errs[0])
            worst["flash_bwd_dkv" + tag] = max(worst.get("flash_bwd_dkv" + tag, 0.0),
                                               *errs[1:])
    return worst


def kern_names(fa, dtype):
    return (fa.forward_kernel_for(dtype), *fa.backward_kernel_for(dtype))


def flash_f32_d128(torch, timer: Timer, bh: int, s: int, d: int = 128):
    """The f32 kernels at D 128 (S ``s``, causal), where their shared memory
    is tightest: the forward beside SDPA's f32 forward, the backward pair
    beside SDPA's f32 backward, on the same inputs."""
    import torch.nn.functional as F

    from k8s_dra_driver_torch.ops import flash_attention as fa

    g = torch.Generator(device=DEV).manual_seed(SEED + 12)
    q, k, v, dout = (torch.randn((bh, s, d), generator=g, device=DEV) for _ in range(4))
    out, lse = fa._forward_bhsd(q, k, v, True)
    delta = fa._delta(dout, out)
    ms = {"flash_fwd": timer.ms(lambda: fa._forward_bhsd(q, k, v, True)),
          "flash_bwd_dq": timer.ms(lambda: fa._dq_bhsd(q, k, v, lse, dout, delta, True)),
          "flash_bwd_dkv": timer.ms(lambda: fa._dkv_bhsd(q, k, v, lse, dout, delta, True))}
    qs, ks, vs = (x.reshape(-1, 16, s, d).detach().requires_grad_() for x in (q, k, v))
    ms_fwd = timer.ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True))
    o_sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    ms_bwd = timer.ms(lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), dout.reshape(-1, 16, s, d),
                                                  retain_graph=True))
    work = _flash_work(bh, s, d, 4, True)
    for name, kern in zip(ms, kern_names(fa, torch.float32)):
        b_ms, b_by = bound(*work[name], "float32")
        fwd = name == "flash_fwd"
        log(f"  {name} float32 ({kern}) BH={bh} S={s} D={d} causal: kernel "
            f"{ms[name] * 1e3:.1f} us, sdpa {'fwd' if fwd else 'bwd'} "
            f"{(ms_fwd if fwd else ms_bwd) * 1e3:.1f} us, bound {b_ms * 1e3:.2f} "
            f"us ({b_by}, {work[name][0] / 1e6:.1f} MB, {work[name][1] / 1e9:.2f} GFLOP; the "
            f"kernel at {b_ms / ms[name]:.3f} of the bound's rate)")
    log(f"  sdpa float32 backward at D {d} covers dQ and dK/dV together: kernels "
        f"{(ms['flash_bwd_dq'] + ms['flash_bwd_dkv']) * 1e3:.1f} us against {ms_bwd * 1e3:.1f} us")


def model_weights(cfg) -> int:
    """The weights a token's products meet: the blocks' matrices and the
    tied embedding table."""
    from k8s_dra_driver_torch.models.burnin import block_matrix_shapes

    block = sum(a * b for a, b in block_matrix_shapes(cfg).values())
    return cfg.n_layers * block + cfg.vocab_size * cfg.d_model


def train_flops(cfg, batch: int, seq: int) -> int:
    """Model FLOPs of one train step as ``bench.py``'s ``_train_mfu``
    counts them: 6 per weight per token (no credit for the remat
    re-forward) plus 12·B·S²·d per layer for attention."""
    return (6 * model_weights(cfg) * batch * seq
            + 12 * batch * seq * seq * cfg.d_model * cfg.n_layers)


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30)).item()


TRAIN_TOL = {
    # (loss relative, gradient leaf relative L2, why)
    "bfloat16": (1e-3, 5e-2, "both paths in bf16, rounded at other points (dense: bf16 "
                 "scores before the f32 softmax; flash: f32 scores, P rounded per tile); a "
                 "CPU rehearsal at 2 layers put each within ~1.3% (rel L2) of f32"),
    "float32": (1e-5, 1e-4, "f32 throughout, TF32 off; the two attentions sum in another "
                "order"),
}


def _train_tokens(torch, cfg, b: int, seed: int):
    return torch.from_numpy(
        np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(b, cfg.max_seq))
    ).to(DEV)


def _state_leaves(params, state) -> list:
    """Every tensor a train step updates: params, count, both moments."""
    from k8s_dra_driver_torch.models import burnin

    return [*burnin.param_leaves(params), state["count"], *state["mu"], *state["nu"]]


def _differing(a: list, b: list) -> list:
    """Positions where two lists of tensors are not bit-equal."""
    return [i for i, (x, y) in enumerate(zip(a, b)) if not x.equal(y)]


def _zero_flash_counts():
    from k8s_dra_driver_torch.ops import flash_attention as fa

    fa.add_launch_counts({k: -n for k, n in fa.launch_counts().items()})


def alternating_rounds(torch, runs: dict, rounds: int = 4, per_round: int = 5) -> dict:
    """ms per call of each of ``runs`` ({label: (fn, context)}) on the host
    clock around a synchronised window of ``per_round`` calls, the runs
    taking turns for ``rounds`` rounds in one process; {label: [ms by
    round]}."""
    times = {label: [] for label in runs}
    for _ in range(rounds):
        for label, (fn, context) in runs.items():
            with context():
                sync(torch)
                t0 = time.perf_counter()
                for _ in range(per_round):
                    fn()
                sync(torch)
            times[label].append((time.perf_counter() - t0) / per_round * 1e3)
    return times


def _step_line(label, times, tokens_per_step, flops) -> float:
    """Print one run's step times; returns the median ms."""
    med = float(np.median(times))
    log(f"{label}: {' / '.join(f'{t:.2f}' for t in times)} ms per step by round (median "
        f"{med:.2f}, range {min(times):.2f}-{max(times):.2f}; {tokens_per_step / med * 1e3:.0f} "
        f"tokens/s, {flops / med / 1e9:.1f} TFLOP/s = {flops / med / 1e9 / 989:.4f} of 989 "
        f"TFLOP/s)")
    return med


def _graph_line(torch, label, fns):
    prog = fns.graphed.program
    if prog is None or prog.graph is None:
        log(f"{label}: {fns.captures} capture(s); no graph held")
        return
    log(f"{label}: {fns.captures} capture(s); the step's graph captured in "
        f"{prog.capture_s * 1e3:.1f} ms, called {prog.calls} times, pool "
        f"{graph_pool_bytes(torch, prog.graph) / 2**20:.2f} MiB")


def phase_train_bf16(torch, cfg, steps: int = 8, b: int = 4):
    """bf16 training of ``cfg`` at S = max_seq through the flash kernels:
    step 0 flash against dense, then the graphed step (the main path;
    returns its flash launch counts) against an eager twin
    (``serve.disable_graphs()``) from the same seed, bit for bit over
    ``steps`` steps; both timed in alternating rounds; profiles of one
    step of each."""
    from k8s_dra_driver_torch.models import burnin, serve
    from k8s_dra_driver_torch.ops import flash_attention as fa

    s = cfg.max_seq
    tokens = _train_tokens(torch, cfg, b, SEED + 3)
    loss_tol, grad_tol, why = TRAIN_TOL["bfloat16"]

    # step 0: flash against dense on the same params and batch
    params = burnin.init_params(torch.Generator(device=DEV).manual_seed(SEED + 5), cfg)
    lf, gf = burnin.value_and_grad(
        lambda p, t: burnin.loss_fn(p, t, cfg, fa.flash_attention), params, tokens)
    ld, gd = burnin.value_and_grad(lambda p, t: burnin.loss_fn(p, t, cfg), params, tokens)
    rel_loss = abs(lf.item() - ld.item()) / abs(ld.item())
    rels = [_rel_l2(x, y) for x, y in zip(burnin.param_leaves(gf), burnin.param_leaves(gd))]
    log(f"train bf16 step 0: loss flash {lf.item():.6f} dense {ld.item():.6f} (rel "
        f"{rel_loss:.3g}, tolerance {loss_tol}); gradient leaves rel L2 worst "
        f"{max(rels):.4g}, median {sorted(rels)[len(rels) // 2]:.4g} (tolerance {grad_tol}: "
        f"{why})")
    if not (rel_loss <= loss_tol and max(rels) <= grad_tol):
        raise AssertionError("bf16 flash training step 0 disagrees with dense")
    del params, gf, gd

    runs = {}
    for mode in ("graphed", "eager"):
        fns = burnin.build_train_step(cfg, attention="flash", remat="blocks", lr=3e-4,
                                      device=DEV)
        sync(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        params, state = fns.init(torch.Generator(device=DEV).manual_seed(SEED + 5))
        sync(torch)
        _zero_flash_counts()
        with serve.disable_graphs() if mode == "eager" else contextlib.nullcontext():
            losses = [fns.step(params, state, tokens)[2] for _ in range(steps)]
        sync(torch)
        runs[mode] = dict(fns=fns, params=params, state=state, losses=torch.stack(losses),
                          counts=(dict(fa.launches), dict(fa.fwd_launches),
                                  dict(fa.bwd_launches)),
                          peak=torch.cuda.max_memory_allocated() - base)
    graphed, eager = runs["graphed"], runs["eager"]
    counts, fwd, bwd = graphed["counts"]
    losses = graphed["losses"].tolist()
    log(f"train bf16 B={b} S={s} L={cfg.n_layers}: losses over {steps} graphed steps on one "
        f"batch " + " ".join(f"{x:.4f}" for x in losses))
    log(f"train bf16: launches {counts}, by kernel {fwd} {bwd} (expected forward 2*L*steps = "
        f"{2 * cfg.n_layers * steps}, all flash_fwd_wgmma; dQ and dK/dV L*steps = "
        f"{cfg.n_layers * steps}, all flash_bwd_dq_wgmma and flash_bwd_dkv_wgmma)")
    _graph_line(torch, "train bf16", graphed["fns"])
    log(f"train bf16: peak memory allocated over the {steps} steps: graphed "
        f"{graphed['peak'] / 2**30:.2f} GiB, eager {eager['peak'] / 2**30:.2f} GiB (model, "
        f"optimizer state and the step's transients)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("bf16 training loss did not fall")
    n = cfg.n_layers * steps
    if counts != {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n} or fwd != {
            "flash_fwd_wgmma": 2 * n, "flash_fwd_fma": 0} or bwd != {
            "flash_bwd_dq_wgmma": n, "flash_bwd_dq_fma": 0,
            "flash_bwd_dkv_wgmma": n, "flash_bwd_dkv_fma": 0}:
        raise AssertionError(f"flash launch counts {counts} {fwd} {bwd} are not the main path's")
    if eager["counts"] != graphed["counts"]:
        raise AssertionError(f"graphed and eager launch counts differ: {graphed['counts']} "
                             f"{eager['counts']}")
    if graphed["fns"].captures != 1 or eager["fns"].captures != 0:
        raise AssertionError(f"captures: graphed {graphed['fns'].captures}, eager "
                             f"{eager['fns'].captures} (want 1 and 0)")

    def bit_equal(when, losses=True):
        loss_ok = not losses or graphed["losses"].equal(eager["losses"])
        differ = _differing(_state_leaves(graphed["params"], graphed["state"]),
                            _state_leaves(eager["params"], eager["state"]))
        log(f"train bf16: graphed == eager twin {when}: losses {loss_ok}; params, count, mu "
            f"and nu leaves that differ: {differ}")
        if not loss_ok or differ:
            raise AssertionError(f"the graphed and eager bf16 steps differ {when}")

    bit_equal(f"after {steps} steps")
    flops = train_flops(cfg, b, s)
    log(f"train bf16: {flops / 1e12:.3f} TFLOP per step as _train_mfu counts it (bound "
        f"{flops / PEAK_OPS['bfloat16'] * 1e3:.2f} ms)")

    def stepper(run):
        return lambda: run["fns"].step(run["params"], run["state"], tokens)

    rounds, per_round = 4, 5
    times = alternating_rounds(torch, {
        "eager": (stepper(eager), serve.disable_graphs),
        "graphed": (stepper(graphed), contextlib.nullcontext),
    }, rounds, per_round)
    med = {mode: _step_line(f"train bf16 {mode}", t, b * s, flops) for mode, t in times.items()}
    log(f"train bf16: graphed / eager {med['graphed'] / med['eager']:.3f} "
        f"({med['eager'] / med['graphed']:.2f}x), {rounds} alternating rounds of {per_round} "
        f"steps")
    bit_equal(f"after {rounds * per_round} more steps each (params and state)", losses=False)
    with serve.disable_graphs():
        prof_e = profile_window(torch, "train bf16: profile of one eager step",
                                stepper(eager), top=12, host_top=8,
                                watch=("flash_fwd_wgmma", "flash_bwd_dq_wgmma",
                                       "flash_bwd_dkv_wgmma"))
    prof_g = profile_window(torch, "train bf16: profile of one graphed step", stepper(graphed),
                            top=12, host_top=4,
                            watch=("flash_fwd_wgmma", "flash_bwd_dq_wgmma",
                                   "flash_bwd_dkv_wgmma"))
    if prof_g is not None:
        device_time_by_class("train bf16: graphed step", prof_g)
        busy = prof_g["busy_us"] / 1e3
        eager_busy = prof_e["busy_us"] / 1e3 if prof_e is not None else float("nan")
        log(f"train bf16: device busy {busy:.2f} ms per graphed step, "
            f"{busy / med['graphed']:.3f} of the unprofiled graphed step ({med['graphed']:.2f} "
            f"ms); eager step {eager_busy:.2f} ms busy, {eager_busy / med['eager']:.3f} of "
            f"{med['eager']:.2f} ms; graphed / eager device time {busy / eager_busy:.3f}")
    return {"flash_fwd": fwd["flash_fwd_wgmma"], "flash_bwd_dq": bwd["flash_bwd_dq_wgmma"],
            "flash_bwd_dkv": bwd["flash_bwd_dkv_wgmma"]}


# kernel classes by a string in the kernel's name, first match wins
KERNEL_CLASSES = (
    ("flash kernels", ("flash_",)),
    ("cuBLAS products", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("AdamW (multi-tensor)", ("multi_tensor_apply",)),
    ("softmax over the logits", ("SoftMax",)),
    ("copies and casts", ("copy",)),
    ("reductions", ("reduce",)),
    ("index and scatter", ("index", "scatter", "gather")),
    ("elementwise", ("elementwise",)),
)


def device_time_by_class(label, prof):
    """Print a profile's device time summed by kernel class: every kernel
    lands in one class (or "other")."""
    sums: dict = {}
    for dev_us, count, key in prof["rows"]:
        cls = next((c for c, names in KERNEL_CLASSES if any(n in key for n in names)), "other")
        us, n = sums.get(cls, (0.0, 0))
        sums[cls] = (us + dev_us, n + count)
    total = sum(us for us, _ in sums.values())
    log(f"{label}: device time by kernel class, {total / 1e3:.2f} ms over "
        f"{sum(n for _, n in sums.values())} launches: " + "; ".join(
            f"{cls} {us / 1e3:.2f} ms ({us / total:.3f}, x{n})"
            for cls, (us, n) in sorted(sums.items(), key=lambda kv: -kv[1][0])))


REMATS = ("dots", "blocks", "none")


def phase_remat(torch, cfg, steps: int = 3, b: int = 4):
    """The graphed bf16 step at full width under each remat policy from the
    same init: losses, params, count and moments bit-equal across the
    three after ``steps`` steps; the flash forward 2·L a step under "dots"
    and "blocks" (the recompute reruns it), L under "none"; each policy's
    peak memory and step time (alternating rounds)."""
    from k8s_dra_driver_torch.models import burnin
    from k8s_dra_driver_torch.ops import flash_attention as fa

    tokens = _train_tokens(torch, cfg, b, SEED + 3)
    runs = {}
    for remat in REMATS:
        fns = burnin.build_train_step(cfg, attention="flash", remat=remat, lr=3e-4, device=DEV)
        sync(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        params, state = fns.init(torch.Generator(device=DEV).manual_seed(SEED + 5))
        _zero_flash_counts()
        losses = torch.stack([fns.step(params, state, tokens)[2] for _ in range(steps)])
        sync(torch)
        runs[remat] = dict(fns=fns, params=params, state=state, losses=losses,
                           fwd=fa.fwd_launches["flash_fwd_wgmma"],
                           peak=torch.cuda.max_memory_allocated() - base)
        _graph_line(torch, f"remat {remat}", fns)
        log(f"remat {remat}: losses {' '.join(f'{x:.6f}' for x in losses.tolist())}; flash "
            f"forward launches {runs[remat]['fwd']} over {steps} steps; peak memory allocated "
            f"{runs[remat]['peak'] / 2**30:.2f} GiB (model, optimizer state and the step's "
            f"transients)")
    want_fwd = {"dots": 2, "blocks": 2, "none": 1}
    for remat, run in runs.items():
        if run["fwd"] != want_fwd[remat] * cfg.n_layers * steps or run["fns"].captures != 1:
            raise AssertionError(f"remat {remat}: {run['fwd']} flash forward launches, "
                                 f"{run['fns'].captures} captures")

    def agree(when, losses=True):
        ref = _state_leaves(runs["none"]["params"], runs["none"]["state"])
        for remat in ("dots", "blocks"):
            run = runs[remat]
            loss_ok = not losses or run["losses"].equal(runs["none"]["losses"])
            differ = _differing(_state_leaves(run["params"], run["state"]), ref)
            log(f"remat {remat} == none {when}: losses {loss_ok}; leaves that differ {differ}")
            if not loss_ok or differ:
                raise AssertionError(f"remat {remat} and none differ {when}")

    agree(f"after {steps} steps")
    flops = train_flops(cfg, b, cfg.max_seq)
    times = alternating_rounds(torch, {
        remat: ((lambda r=run: r["fns"].step(r["params"], r["state"], tokens)),
                contextlib.nullcontext)
        for remat, run in runs.items()
    })
    for remat, t in times.items():
        _step_line(f"remat {remat} graphed", t, b * cfg.max_seq, flops)
    agree("after the timed rounds (params and state)", losses=False)


def phase_resume(torch, cfg, b: int = 4):
    """The reference's resume check on the graphed bf16 step at full width:
    2 steps, save, step 3, restore into the same tensors, step 3 again:
    the loss bit-equal, with no new capture."""
    import shutil
    from pathlib import Path

    from k8s_dra_driver_torch.models import burnin
    from k8s_dra_driver_torch.models.train_checkpoint import TrainCheckpointer

    tokens = _train_tokens(torch, cfg, b, SEED + 3)
    fns = burnin.build_train_step(cfg, attention="flash", lr=3e-4, device=DEV)
    params, state = fns.init(torch.Generator(device=DEV).manual_seed(SEED + 5))
    for _ in range(2):
        fns.step(params, state, tokens)
    where = Path(__file__).resolve().parent / "build" / "chip_smoke_checkpoint"
    shutil.rmtree(where, ignore_errors=True)
    ckpt = TrainCheckpointer(where, keep=1)
    try:
        t0 = time.perf_counter()
        ckpt.save(2, (params, state))
        t_save = time.perf_counter() - t0
        l3 = fns.step(params, state, tokens)[2].item()
        captures = fns.captures
        t0 = time.perf_counter()
        ckpt.restore(like=(params, state))
        sync(torch)
        t_restore = time.perf_counter() - t0
        l3b = fns.step(params, state, tokens)[2].item()
    finally:
        ckpt.close()
        shutil.rmtree(where, ignore_errors=True)
    log(f"resume: step 3 loss {l3!r}, again after the restore {l3b!r}; captures {captures} -> "
        f"{fns.captures}; count {int(state['count'])}; save {t_save:.2f} s, restore into the "
        f"step's tensors {t_restore:.2f} s")
    if l3 != l3b or fns.captures != captures or captures != 1:
        raise AssertionError("the resumed graphed step is not bit-exact or captured anew")


def phase_train_f32(torch, cfg, steps: int = 3, b: int = 4):
    """``cfg`` in f32 at 2 layers: the graphed flash step (the f32 kernels'
    main path) against its eager twin bit for bit, and against dense step
    by step, from the same params on the same batch."""
    from k8s_dra_driver_torch.models import burnin, serve
    from k8s_dra_driver_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    tokens = _train_tokens(torch, cfg, b, SEED + 4)
    loss_tol, param_tol, why = TRAIN_TOL["float32"]
    runs = {}
    for label, attention in (("flash", "flash"), ("flash eager", "flash"), ("dense", "dense")):
        fns = burnin.build_train_step(cfg, attention=attention, device=DEV)
        params, state = fns.init(torch.Generator(device=DEV).manual_seed(SEED + 6))
        sync(torch)
        _zero_flash_counts()
        with serve.disable_graphs() if label == "flash eager" else contextlib.nullcontext():
            losses = [fns.step(params, state, tokens)[2] for _ in range(steps)]
        sync(torch)
        runs[label] = (torch.stack(losses), params, state, fns.captures)
        if label == "flash":
            fwd, bwd = dict(fa.fwd_launches), dict(fa.bwd_launches)
    (lf, pf, sf, cf), (le, pe, se, ce) = runs["flash"], runs["flash eager"]
    differ = _differing(_state_leaves(pf, sf), _state_leaves(pe, se))
    log(f"train f32 L=2: graphed == eager twin over {steps} steps: losses {lf.equal(le)}; leaves "
        f"that differ {differ}; captures {cf} and {ce}")
    if not lf.equal(le) or differ or (cf, ce) != (1, 0):
        raise AssertionError("the graphed and eager f32 steps differ")
    lf, ld, pd = lf.tolist(), runs["dense"][0].tolist(), runs["dense"][1]
    rel = max(abs(x - y) / abs(y) for x, y in zip(lf, ld))
    prel = max(_rel_l2(x, y) for x, y in zip(burnin.param_leaves(pf), burnin.param_leaves(pd)))
    log(f"train f32 L=2: losses flash {' '.join(f'{x:.6f}' for x in lf)}; dense "
        f"{' '.join(f'{x:.6f}' for x in ld)}; worst rel {rel:.3g} (tolerance {loss_tol}); "
        f"params after {steps} steps rel L2 worst {prel:.3g} (tolerance {param_tol}: {why})")
    n = cfg.n_layers * steps
    log(f"train f32 L=2: launches by kernel {fwd} {bwd} (expected forward 2*L*steps = "
        f"{2 * n}, all flash_fwd_fma; dQ and dK/dV L*steps = {n}, all flash_bwd_dq_fma and "
        f"flash_bwd_dkv_fma)")
    if not (rel <= loss_tol and prel <= param_tol and lf[-1] < lf[0]):
        raise AssertionError("f32 flash training disagrees with dense")
    if fwd != {"flash_fwd_wgmma": 0, "flash_fwd_fma": 2 * n} or bwd != {
            "flash_bwd_dq_wgmma": 0, "flash_bwd_dq_fma": n,
            "flash_bwd_dkv_wgmma": 0, "flash_bwd_dkv_fma": n}:
        raise AssertionError(f"f32 flash launches {fwd} {bwd} are not the f32 path's")
    return {"flash_fwd_f32": fwd["flash_fwd_fma"], "flash_bwd_dq_f32": bwd["flash_bwd_dq_fma"],
            "flash_bwd_dkv_f32": bwd["flash_bwd_dkv_fma"]}


MESH_TRAIN = dict(b=4, steps=3, lr=3e-4)
# leg: (what it runs, (slices, MeshShape fields), build_train_step options)
MESH_LEGS = {
    "a": ("ring, flash", (0, {"seq": 4}), {}),
    "b": ("sharded flash, tensor parallel", (0, {"data": 2, "model": 2}), {}),
    "c": ("Ulysses, flash", (0, {"seq": 4}), {"sequence_parallel": "ulysses"}),
    "d": ("multislice 2 x data 2, flash", (2, {"data": 2}), {}),
}
# leg (l): the config with fewer KV groups than model ranks (n_kv_heads 2
# on model 4): the mesh step gathers the qkv projection over model and each
# rank attends with its own query heads
KV_SPLIT_LEG = ("kv-split, flash", (0, {"model": 4}), {}, 2)
MESH_TOL = {
    # (loss relative, step-1 gradient per element over its leaf's largest, why)
    "bfloat16": (1e-3, 5e-2, "bf16: both paths round at other points (the ring merges f32 "
                 "partials, the single card runs one flash pass; the all-reduces sum bf16 "
                 "gradients in another order); a few bf16 steps (2^-7) of the leaf's largest "
                 "gradient, which a gradient left unreduced over an axis, off by about "
                 "itself, cannot meet"),
    "float32": (1e-5, 1e-4, "f32 throughout, TF32 off; the ranks' parts summed in another "
                "order (the CPU tests see 1e-6 of each leaf's largest gradient)"),
}
# parameters after the steps, per leaf: an AdamW step moves an element by
# about lr, so lr x steps / 2 (half the room of a sign flip in every step,
# which a rank updating from its own rows alone would show) plus this many
# rounding units of the leaf's largest value (2^-8 in bf16, 2^-24 in f32)
MESH_PARAM_UNITS = 4


def _rank_mesh(layout, dev):
    import torch.distributed as dist

    from k8s_dra_driver_torch.parallel import mesh as pm

    ranks = list(range(dist.get_world_size()))
    shape = pm.MeshShape(**layout[1])
    if layout[0]:
        return pm.build_multislice_mesh(ranks, layout[0], shape, dev)
    return pm.build_mesh(ranks, shape, dev)


def _leg_setup(dev):
    """A leg's rank-side start: ``DEV`` set (spawned ranks import this
    module afresh), TF32 off."""
    import torch

    global DEV
    DEV = dev
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


def _timed_steps(torch, fns, params, state, tokens, steps: int) -> dict:
    """``steps`` steps on one batch, each timed on the host clock, the
    flash and collective counts zeroed just before: the losses, ms, flash
    launches, bytes sent and through the host by kind, and peak memory."""
    import torch.distributed as dist

    from k8s_dra_driver_torch.ops import collectives
    from k8s_dra_driver_torch.ops import flash_attention as fa

    sync(torch)
    dist.barrier()
    _zero_flash_counts()
    collectives.reset_counts()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(fns.step(params, state, tokens)[2])
        sync(torch)
        ms.append((time.perf_counter() - t0) * 1e3)
    return dict(losses=[float(x) for x in losses], ms=ms, fwd=dict(fa.fwd_launches),
                bwd=dict(fa.bwd_launches), comm=dict(collectives.comm_bytes),
                host=dict(collectives.host_bytes),
                peak=torch.cuda.max_memory_allocated() if DEV == "cuda" else 0)


def _against_single_card(torch, cfg, tokens, grads, after, steps: int, attention: str) -> dict:
    """Rank 0's reference: the single-card step (``attention``) from the
    same seed and tokens; the worst step-1 gradient error over each leaf's
    largest, its losses over ``steps`` eager steps, and the params after
    them against ``after`` (``MESH_PARAM_UNITS``)."""
    from k8s_dra_driver_torch.models import burnin, serve
    from k8s_dra_driver_torch.ops import flash_attention as fa

    attn_fn = fa.flash_attention if attention == "flash" else None
    single = burnin.build_train_step(cfg, attention=attention, remat="blocks",
                                     lr=MESH_TRAIN["lr"], device=DEV)
    p1, s1 = single.init(torch.Generator(device=DEV).manual_seed(SEED + 66))
    _, g1 = burnin.value_and_grad(lambda p, t: burnin.loss_fn(p, t, cfg, attn_fn), p1, tokens)
    out = {"grad_err": max(((x.float() - y.float()).abs().max() / y.float().abs().max()).item()
                           for x, y in zip(grads, burnin.param_leaves(g1)))}
    del g1
    with serve.disable_graphs():
        out["single"] = [float(single.step(p1, s1, tokens)[2]) for _ in range(steps)]
    unit = torch.finfo(cfg.dtype).eps / 2
    diffs, room = [], []
    for x, y in zip(after, burnin.param_leaves(p1)):
        diffs.append((x.float() - y.float()).abs().max().item())
        room.append(MESH_TRAIN["lr"] * steps / 2
                    + MESH_PARAM_UNITS * unit * y.float().abs().max().item())
    out["param_diff"] = max(diffs)
    out["param_ratio"] = max(d / r for d, r in zip(diffs, room))
    return out


def mesh_leg(cfg, layout, kw, steps: int, b: int, dev: str) -> dict:
    """One "train mesh" leg on this rank (every rank of the pool runs it;
    the parent runs the world-1 leg itself): ``cfg`` through
    ``build_train_step(mesh=..., attention="flash")`` on ``dev`` (the
    parent's ``DEV``: spawned ranks import this module afresh), ``steps``
    steps on one batch, timed on the host clock, the flash and collective
    counts zeroed just before; then the params unsharded, and on rank 0 the
    single-card step from the same seed and tokens, and the step-1
    gradients of both."""
    import torch.distributed as dist

    from k8s_dra_driver_torch.models import burnin, mesh_train, weights

    torch = _leg_setup(dev)
    mesh = _rank_mesh(layout, dev)
    tokens = _train_tokens(torch, cfg, b, SEED + 7)
    fns = burnin.build_train_step(cfg, mesh=mesh, attention="flash", remat="blocks",
                                  lr=MESH_TRAIN["lr"], device=DEV, **kw)
    sync(torch)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params, state = fns.init(torch.Generator(device=DEV).manual_seed(SEED + 66))
    plan = mesh_train.mesh_plan(cfg, mesh, kw.get("sequence_parallel", "auto"), "flash")
    _, g = mesh_train.loss_and_grads(params, tokens, cfg, plan)
    grads = burnin.param_leaves(weights.unshard_params(cfg, mesh, g)[0])
    del g
    out = _timed_steps(torch, fns, params, state, tokens, steps)
    after = burnin.param_leaves(weights.unshard_params(cfg, mesh, params)[0])
    if dist.get_rank():
        return out
    out.update(_against_single_card(torch, cfg, tokens, grads, after, steps, "flash"))
    return out


# leg: (what it runs, (slices, MeshShape fields), build_pp_train_step options)
PP_LEGS = {
    "f": ("pipeline, megatron", (0, {"pipe": 2, "model": 2}),
          {"tp_mode": "megatron", "n_micro": 2}),
    "g": ("pipeline, megatron-sp", (0, {"pipe": 2, "model": 2}),
          {"tp_mode": "megatron-sp", "n_micro": 2}),
}


def pp_leg(cfg, layout, kw, steps: int, b: int, dev: str) -> dict:
    """One pipeline leg on this rank: ``models/pp_burnin.build_pp_train_step``
    as :func:`mesh_leg` runs the mesh step, held on rank 0 against the
    single card's ``attention="dense"`` step (the pipeline's attention is
    plain, as the reference's is)."""
    import torch.distributed as dist

    from k8s_dra_driver_torch.models import burnin, pp_burnin, weights

    torch = _leg_setup(dev)
    mesh = _rank_mesh(layout, dev)
    tokens = _train_tokens(torch, cfg, b, SEED + 7)
    fns = pp_burnin.build_pp_train_step(cfg, mesh, lr=MESH_TRAIN["lr"], device=DEV, **kw)
    sync(torch)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params, state = fns.init(torch.Generator(device=DEV).manual_seed(SEED + 66))
    plan = pp_burnin.pp_plan(cfg, mesh, kw.get("n_micro"), kw.get("tp_mode", "megatron"))
    _, g = pp_burnin.loss_and_grads(params, tokens, cfg, plan)

    def dense(tree):
        return burnin.param_leaves(
            weights.dense_params(cfg, weights.unshard_pipeline_params(cfg, mesh, tree)[0]))

    grads = dense(g)
    del g
    out = _timed_steps(torch, fns, params, state, tokens, steps)
    after = dense(params)
    if dist.get_rank():
        return out
    out.update(_against_single_card(torch, cfg, tokens, grads, after, steps, "dense"))
    return out


def _mesh_flash_expected(layout, kw, n_layers: int, steps: int) -> tuple[int, int]:
    """(forward, dQ = dK/dV) flash launches summed over the ranks: each
    rank's attention calls a layer, twice in the forward under remat
    "blocks"; on the causal ring a rank at seq index i runs its own block
    and the i earlier ones."""
    shape = layout[1]
    n_seq = shape.get("seq", 1)
    world = max(layout[0], 1) * int(np.prod(list(shape.values()) or [1]))
    ring = n_seq > 1 and kw.get("sequence_parallel", "auto") in ("auto", "ring")
    calls = (world // n_seq) * sum(1 + i for i in range(n_seq)) if ring else world
    return 2 * n_layers * steps * calls, n_layers * steps * calls


def _leg_numbers(label, results, steps, card, note=""):
    """A leg's host-clock ms a step (median over ranks), the bytes a rank
    sends a step and those it copies through the host, by kind, and its
    peak memory, from each rank's ``ms``, ``comm``, ``host`` and ``peak``."""
    ms = np.median(np.array([r["ms"] for r in results]), axis=0)
    log(f"{label}: {' / '.join(f'{x:.1f}' for x in ms)} ms per step (host clock, median over "
        f"ranks; 4 ranks sharing one card: not a scaling figure{note}; {card})"
        if len(results) > 1 else
        f"{label}: {' / '.join(f'{x:.1f}' for x in ms)} ms per step (host clock; {card})")
    for kind in results[0]["comm"]:
        sent = [r["comm"][kind] / steps for r in results]
        host = [r["host"][kind] / steps for r in results]
        if max(sent) or max(host):
            log(f"{label}: {kind} per rank per step: {' '.join(f'{x / 2**20:.2f}' for x in sent)}"
                f" MiB sent, {' '.join(f'{x / 2**20:.2f}' for x in host)} MiB through the host")
    log(f"{label}: peak memory by rank {' '.join(f'{r['peak'] / 2**30:.2f}' for r in results)} GiB")


def _mesh_report(torch, label, results, cfg, steps, card, flash: tuple[int, int] | None):
    """Print one leg's numbers and hold its gates, ``flash`` the (forward,
    dQ = dK/dV) launches its schedule makes summed over the ranks (None for
    the pipeline legs, whose attention is plain: no launch); returns its
    launches by kernel, summed over the ranks."""
    from k8s_dra_driver_torch.ops import flash_attention as fa

    dtype = cfg.dtype
    dtype_name = str(dtype).split(".")[-1]
    loss_tol, grad_tol, why = MESH_TOL[dtype_name]
    head = results[0]
    rel = max(abs(x - y) / abs(y) for x, y in zip(head["losses"], head["single"]))
    log(f"{label}: losses mesh {' '.join(f'{x:.5f}' for x in head['losses'])}, single card "
        f"{' '.join(f'{x:.5f}' for x in head['single'])}; worst rel {rel:.3g} (tolerance "
        f"{loss_tol}: {why})")
    log(f"{label}: step-1 gradients, worst |mesh - single| over the leaf's largest "
        f"{head['grad_err']:.3g} (bound {grad_tol}); params after {steps} steps, largest "
        f"difference {head['param_diff']:.3g}, worst leaf at {head['param_ratio']:.3g} of its "
        f"bound (lr x steps / 2 + {MESH_PARAM_UNITS} rounding units of the leaf's largest)")
    _leg_numbers(label, results, steps, card)
    fwd_name = fa.forward_kernel_for(dtype)
    dq_name, dkv_name = fa.backward_kernel_for(dtype)
    got = {name: sum(r["fwd"].get(name, 0) + r["bwd"].get(name, 0) for r in results)
           for name in (*fa.fwd_launches, *fa.bwd_launches)}
    fwd_n, bwd_n = flash or (0, 0)
    want = {name: 0 for name in got} | {fwd_name: fwd_n, dq_name: bwd_n, dkv_name: bwd_n}
    log(f"{label}: flash launches summed over ranks {got} (the schedule's: {fwd_name} "
        f"{fwd_n}, {dq_name} and {dkv_name} {bwd_n} each)")
    if got != want or (flash is not None and not fwd_n):
        raise AssertionError(f"{label}: flash launches {got} are not the schedule's {want}")
    if any(r["losses"] != head["losses"] for r in results):
        raise AssertionError(f"{label}: the ranks report different losses")
    if not (np.isfinite(head["losses"]).all() and rel <= loss_tol):
        raise AssertionError(f"{label}: the mesh losses leave the single card's")
    if not head["grad_err"] <= grad_tol:
        raise AssertionError(f"{label}: the step-1 gradients leave the single card's")
    if not head["param_ratio"] <= 1:
        raise AssertionError(f"{label}: the params after {steps} steps leave the single card's")
    tag = "_f32" if dtype == torch.float32 else ""
    return {"flash_fwd" + tag: got[fwd_name], "flash_bwd_dq" + tag: got[dq_name],
            "flash_bwd_dkv" + tag: got[dkv_name]}


# leg (e) graphed: steps held bit for bit, then alternating timing rounds
WORLD1_GRAPH = dict(steps=5, rounds=4, per_round=5)
# the collectives the mesh and pipeline steps issue (``ops/collectives``:
# psum, pvary, the bucketed all-reduce and reduce-scatter are all-reduces,
# the gathers list all-gathers, Ulysses and the experts all-to-alls, the
# rings and the pipeline batched point-to-point), and an all-reduce from
# autograd's backward thread (``_Pvary``/``psum``'s backward); a graphed
# step cannot run without them
CAPTURE_USED = ("all_reduce", "all_gather", "all_to_all_single", "batch_isend_irecv",
                "all_reduce in backward")


def _all_reduce_grad(torch, x, group):
    """An identity whose gradient is all-reduced on ``group`` by a direct
    ``dist.all_reduce`` (no short-circuit at one rank), from autograd's
    backward thread as ``collectives._Pvary``'s is."""
    import torch.distributed as dist

    class AllReduceGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            g = g.clone()
            dist.all_reduce(g, group=group)
            return g

    return AllReduceGrad.apply(x)


def _probe_collectives(torch, group, peer: int) -> dict:
    """``{name: fn(inp, out)}``: each collective on ``group``, called
    directly, writing its result into ``out``."""
    import torch.distributed as dist

    def all_reduce(inp, out):
        out.copy_(inp)
        dist.all_reduce(out, group=group)

    def all_gather(inp, out):
        parts = [torch.empty_like(inp)]
        dist.all_gather(parts, inp, group=group)
        out.copy_(torch.cat(parts))

    def broadcast(inp, out):
        out.copy_(inp)
        dist.broadcast(out, peer, group=group)

    def p2p(inp, out):
        ops = [dist.P2POp(dist.isend, inp, peer, group), dist.P2POp(dist.irecv, out, peer, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    def backward(inp, out):
        leaf = inp.detach().requires_grad_()
        with torch.enable_grad():
            y = _all_reduce_grad(torch, leaf, group)
            out.copy_(torch.autograd.grad((y * 3).sum(), leaf)[0])

    return {
        "all_reduce": all_reduce,
        "all_gather": all_gather,
        "all_gather_into_tensor": lambda i, o: dist.all_gather_into_tensor(o, i, group=group),
        "reduce_scatter_tensor": lambda i, o: dist.reduce_scatter_tensor(o, i, group=group),
        "all_to_all_single": lambda i, o: dist.all_to_all_single(o, i, group=group),
        "broadcast": broadcast,
        "batch_isend_irecv": p2p,
        "all_reduce in backward": backward,
    }


def collective_capture_probe(torch, label, capture=None) -> dict:
    """Each collective of :func:`_probe_collectives` on this process's
    world-1 group (NCCL on the card), past ``ops/collectives``'
    short-circuits at one rank: an eager call (which also makes the
    communicator's first use), then ``graphs.cuda_capture`` of the same
    call on fixed buffers and 3 replays on new inputs, each against an
    eager call on the same input, bit for bit.  Then an all-reduce on a
    new group whose first call is the capture.  Prints a line a
    collective; fails if one of ``CAPTURE_USED`` does not capture or its
    replay differs.  Returns ``{name: (captured, replay == eager)}``."""
    import os

    import torch.distributed as dist

    from k8s_dra_driver_torch.models import graphs

    capture = capture or graphs.cuda_capture
    dev = torch.device(DEV)
    group = dist.group.WORLD
    gen = torch.Generator(device=DEV).manual_seed(SEED + 31)
    inputs = [torch.randn((4, 256), generator=gen, device=DEV) for _ in range(4)]
    nccl = ".".join(map(str, torch.cuda.nccl.version())) if DEV == "cuda" else "-"
    log(f"{label}: torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL {nccl}; backend "
        f"{dist.get_backend(group)}, world {dist.get_world_size(group)}; "
        f"capture_begin in its default mode (global), on a side stream "
        f"(graphs.cuda_capture); TORCH_NCCL_ASYNC_ERROR_HANDLING="
        f"{os.environ.get('TORCH_NCCL_ASYNC_ERROR_HANDLING', '<unset>')}, "
        f"TORCH_NCCL_BLOCKING_WAIT={os.environ.get('TORCH_NCCL_BLOCKING_WAIT', '<unset>')}")

    def eager(fn, inp):
        out = torch.full_like(inp, float("nan"))
        fn(inp.clone(), out)
        sync(torch)
        return out

    results = {}
    for name, fn in _probe_collectives(torch, group, 0).items():
        inp, out = inputs[0].clone(), torch.full_like(inputs[0], float("nan"))
        stage = "the eager call"
        try:  # the probe reports each failure; the gate below decides
            want = [eager(fn, x) for x in inputs]
            stage = "the capture"
            graph, _ = capture(lambda: fn(inp, out), dev)
        except Exception as exc:
            results[name] = (False, False)
            log(f"{label}: {name}: NOT captured ({stage} raised): {type(exc).__name__}: "
                f"{str(exc)[:300]}")
            continue
        same = []
        for x, w in zip(inputs[1:], want[1:]):
            inp.copy_(x)
            out.fill_(float("nan"))
            graph.replay()
            sync(torch)
            same.append(bool(out.equal(w)))
        results[name] = (True, all(same))
        log(f"{label}: {name}: captured; 3 replays on new inputs == eager calls: {same}")
        del graph
    fresh = dist.new_group([0])
    inp, out = inputs[0].clone(), torch.empty_like(inputs[0])
    try:
        graph, _ = capture(lambda: _probe_collectives(torch, fresh, 0)["all_reduce"](inp, out),
                           dev)
        graph.replay()
        sync(torch)
        log(f"{label}: all_reduce on a new group, first call inside the capture: captured, "
            f"replay == input {bool(out.equal(inp))} (init_process_group took device_id, so "
            f"groups made after it open their communicator at creation)")
    except Exception as exc:
        log(f"{label}: all_reduce on a new group, first call inside the capture: NOT captured: "
            f"{type(exc).__name__}: {str(exc)[:300]}")
    dist.destroy_process_group(fresh)
    bad = [n for n in CAPTURE_USED if results.get(n) != (True, True)]
    if bad:
        raise AssertionError(f"{label}: collectives the graphed steps use do not capture or "
                             f"replay wrong: {bad}")
    return results


def world1_graph_leg(torch, cfg, b: int, card, label) -> dict:
    """Leg (e) as one CUDA graph: the world-1 mesh step (this process's
    group, ``MeshShape()``) graphed and an eager twin
    (``serve.disable_graphs()``) from the same seed, ``steps`` steps each
    on one batch: losses, params, count and moments bit for bit; one
    capture (its ms and pool MiB); the graphed run's flash launches (the
    capture's counts added per replay) the schedule's; then host-clock ms a
    step of the graphed and eager mesh steps and the single card's graphed
    step in alternating rounds.  Returns the graphed run's launches by
    kernels-line row."""
    from k8s_dra_driver_torch.models import burnin, serve
    from k8s_dra_driver_torch.ops import collectives
    from k8s_dra_driver_torch.ops import flash_attention as fa

    steps = WORLD1_GRAPH["steps"]
    mesh = _rank_mesh((0, {}), DEV)
    tokens = _train_tokens(torch, cfg, b, SEED + 7)
    runs = {}
    for mode in ("graphed", "eager"):
        fns = burnin.build_train_step(cfg, mesh=mesh, attention="flash", remat="blocks",
                                      lr=MESH_TRAIN["lr"], device=DEV)
        params, state = fns.init(torch.Generator(device=DEV).manual_seed(SEED + 66))
        sync(torch)
        _zero_flash_counts()
        collectives.reset_counts()
        with serve.disable_graphs() if mode == "eager" else contextlib.nullcontext():
            losses = [fns.step(params, state, tokens)[2] for _ in range(steps)]
        sync(torch)
        runs[mode] = dict(fns=fns, params=params, state=state, losses=torch.stack(losses),
                          fwd=dict(fa.fwd_launches), bwd=dict(fa.bwd_launches),
                          comm=sum(collectives.comm_bytes.values()))
    graphed, eager = runs["graphed"], runs["eager"]
    log(f"{label}: losses over {steps} graphed steps "
        + " ".join(f"{x:.5f}" for x in graphed["losses"].tolist()))
    _graph_line(torch, label, graphed["fns"])
    fwd_n, bwd_n = _mesh_flash_expected((0, {}), {}, cfg.n_layers, steps)
    fwd_name = fa.forward_kernel_for(cfg.dtype)
    dq_name, dkv_name = fa.backward_kernel_for(cfg.dtype)
    want = {fwd_name: fwd_n, dq_name: bwd_n, dkv_name: bwd_n}
    for mode, run in runs.items():
        got = {**run["fwd"], **run["bwd"]}
        log(f"{label}: {mode} flash launches {got} (the schedule's {want}); bytes sent "
            f"{run['comm']} (world 1: none)")
        if got != dict.fromkeys(got, 0) | want or run["comm"]:
            raise AssertionError(f"{label}: {mode} launches {got} or bytes {run['comm']} are "
                                 f"not the schedule's")
    if graphed["fns"].graphed is None or graphed["fns"].captures != 1 or eager["fns"].captures:
        raise AssertionError(f"{label}: captures graphed {graphed['fns'].captures}, eager "
                             f"{eager['fns'].captures} (want 1 and 0)")
    loss_ok = graphed["losses"].equal(eager["losses"])
    differ = _differing(_state_leaves(graphed["params"], graphed["state"]),
                        _state_leaves(eager["params"], eager["state"]))
    log(f"{label}: graphed == eager twin after {steps} steps: losses {loss_ok}; params, count, "
        f"mu and nu leaves that differ: {differ}")
    if not loss_ok or differ:
        raise AssertionError(f"{label}: the graphed and eager world-1 mesh steps differ")
    single = burnin.build_train_step(cfg, attention="flash", remat="blocks",
                                     lr=MESH_TRAIN["lr"], device=DEV)
    sp, ss = single.init(torch.Generator(device=DEV).manual_seed(SEED + 66))
    for _ in range(2):  # eager, then the capture
        single.step(sp, ss, tokens)

    def stepper(fns, params, state):
        return lambda: fns.step(params, state, tokens)

    times = alternating_rounds(torch, {
        "mesh graphed": (stepper(graphed["fns"], graphed["params"], graphed["state"]),
                         contextlib.nullcontext),
        "mesh eager": (stepper(eager["fns"], eager["params"], eager["state"]),
                       serve.disable_graphs),
        "single card graphed": (stepper(single, sp, ss), contextlib.nullcontext),
    }, WORLD1_GRAPH["rounds"], WORLD1_GRAPH["per_round"])
    flops = train_flops(cfg, b, cfg.max_seq)
    med = {k: _step_line(f"{label} {k}", t, b * cfg.max_seq, flops) for k, t in times.items()}
    log(f"{label}: mesh graphed / single card graphed {med['mesh graphed'] / med['single card graphed']:.3f}, "
        f"mesh graphed / mesh eager {med['mesh graphed'] / med['mesh eager']:.3f} "
        f"({WORLD1_GRAPH['rounds']} alternating rounds of {WORLD1_GRAPH['per_round']} steps; "
        f"{card})")
    return {"flash_fwd": graphed["fwd"][fwd_name], "flash_bwd_dq": graphed["bwd"][dq_name],
            "flash_bwd_dkv": graphed["bwd"][dkv_name]}


# leg (h): Mixtral-8x7B's routing (8 experts, top 2) at FLAGSHIP_MODERN's
# width over (data 4); the f32 gate at ample capacity (nothing drops), the
# drop counts at the reference's default factor 2 and at 1 (drops)
EP = dict(tokens=4096, d=1024, d_ff=4096, experts=8, k=2, ample=8.0, factors=(2.0, 1.0),
          timed_factor=2.0, steps=3)
# leg (i): sharded_tp_mlp on (model 4), bidirectional, x [B, S, D] x w_in [D, F]
TP_MLP = dict(b=4, s=1024, d=1024, d_ff=4096, steps=3)
# f32 gates of (h) and (i), over the largest element of each output and
# gradient: the same products summed in another order and GEMM tiling
EP_TP_F32_TOL = 1e-4
# bf16 gates of (i), each error taken against the f32 dense MLP on the
# same inputs: the ring's output and w_out gradient (the scatter's f32
# accumulators) within half a bf16 step (2^-9 of the largest element) of
# the bf16 dense MLP's own error, which an accumulator rounded to bf16 at
# each hop leaves; the x and w_in gradients (the gather's backward, whose
# n cotangents autograd sums in bf16) within TP_MLP_BF16_STEPS steps
TP_MLP_BF16_SLACK = 2.0 ** -9
TP_MLP_BF16_STEPS = 4


def _recount_queues(experts, capacity: int):
    """The kept copies of one rank's routing ``experts [T, k]`` (numpy),
    counted on the host: every first choice in token order, then every
    second, each taking its expert's next slot while one is left."""
    used: dict = {}
    keep = np.zeros(experts.shape, bool)
    for r in range(experts.shape[1]):
        for t in range(experts.shape[0]):
            e = int(experts[t, r])
            keep[t, r] = used.get(e, 0) < capacity
            used[e] = used.get(e, 0) + 1
    return keep


def _timed_reps(torch, fn, steps: int) -> dict:
    """``fn()`` (a forward and backward) once to warm, then ``steps`` times
    on the host clock with the collective counts zeroed just before."""
    import torch.distributed as dist

    from k8s_dra_driver_torch.ops import collectives

    fn()
    sync(torch)
    dist.barrier()
    collectives.reset_counts()
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        sync(torch)
        ms.append((time.perf_counter() - t0) * 1e3)
    return dict(ms=ms, comm=dict(collectives.comm_bytes), host=dict(collectives.host_bytes))


def _rel_err(torch, got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def ep_leg(dev: str, ep: dict) -> dict:
    """Leg (h) on this rank at the sizes of ``ep`` (``EP``):
    ``ops/moe.topk_moe`` over ``(data 4)`` on this rank's blocks (its
    tokens and experts) of whole tensors made from one seed on every rank.
    f32 at capacity factor ``ep["ample"]``: forward and backward of
    ``sum(out · ct)``, the output and the experts' gradients all-gathered; the drops of each factor of ``ep["factors"]``
    (``moe.route``, the queues ``topk_moe`` fills) against a host recount;
    f32 and bf16 forward + backward timed at ``ep["timed_factor"]``; on
    rank 0 the dropless oracle
    (``reference_topk_moe`` over each rank's rows, so the router's product
    has the ranks' shape) with its gradients."""
    import torch.distributed as dist

    from k8s_dra_driver_torch.ops import collectives, moe

    torch = _leg_setup(dev)
    mesh = _rank_mesh((0, {"data": 4}), dev)
    group = mesh.get_group("data")
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    t, d, f, e, k = ep["tokens"], ep["d"], ep["d_ff"], ep["experts"], ep["k"]
    gen = torch.Generator(device=DEV).manual_seed(SEED + 90)
    x = torch.randn((t, d), generator=gen, device=DEV)
    wr = torch.randn((d, e), generator=gen, device=DEV) * d ** -0.5
    wu = torch.randn((e, d, f), generator=gen, device=DEV) * d ** -0.5
    wd = torch.randn((e, f, d), generator=gen, device=DEV) * f ** -0.5
    ct = torch.randn((t, d), generator=gen, device=DEV)
    t_loc, e_loc = t // n, e // n
    rows, mine = slice(idx * t_loc, (idx + 1) * t_loc), slice(idx * e_loc, (idx + 1) * e_loc)

    def fwd_bwd(dtype, factor):
        ins = [a.detach().to(dtype).contiguous().requires_grad_()
               for a in (x[rows], wu[mine], wd[mine])]
        out = moe.topk_moe(ins[0], wr, ins[1], ins[2], mesh, capacity_factor=factor, k=k)
        (out.float() * ct[rows]).sum().backward()
        return out.detach(), ins

    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out, ins = fwd_bwd(torch.float32, ep["ample"])
    got = [collectives.all_gather_raw(out, group, 0),
           collectives.all_gather_raw(ins[1].grad, group, 0),
           collectives.all_gather_raw(ins[2].grad, group, 0)]
    del out, ins
    drops = {}
    for factor in ep["factors"]:
        cap = moe.moe_capacity(factor, t_loc, k, e)
        _, experts, _, keep = moe.route(x[rows], wr, e, cap, k)
        host = _recount_queues(experts.cpu().numpy(), cap)
        keep = keep.cpu().numpy()
        drops[factor] = (cap, int((~keep).sum()), int((~host).sum()), bool((keep == host).all()))
    res = {"drops": drops}
    for dtype in (torch.float32, torch.bfloat16):
        res[str(dtype)[6:]] = _timed_reps(torch, lambda: fwd_bwd(dtype, ep["timed_factor"]),
                                          ep["steps"])
    res["peak"] = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    if idx:
        return res
    ref_w = [a.clone().requires_grad_() for a in (wu, wd)]
    ref = torch.cat([moe.reference_topk_moe(x[r * t_loc:(r + 1) * t_loc], wr, *ref_w, k=k)
                     for r in range(n)])
    (ref * ct).sum().backward()
    res["err"] = {name: _rel_err(torch, a, b) for name, a, b in
                  zip(("output", "w_up grad", "w_down grad"), got, [ref, *(w.grad for w in ref_w)])}
    return res


def tp_mlp_leg(dev: str, tp: dict) -> dict:
    """Leg (i) on this rank at the sizes of ``tp`` (``TP_MLP``):
    ``sharded_tp_mlp`` on ``(model 4)``,
    bidirectional, on its blocks of x ``[B, S, D]`` (S over ``model``),
    w_in ``[D, F]`` (its columns), w_out ``[F, D]`` (its rows), made from
    one seed on every rank; forward and backward of ``sum(out · ct)`` in f32
    and bf16, the output and gradients all-gathered, each timed; on rank
    0 the dense tanh-GELU MLP with its gradients in f32, against which both
    the ring's and the bf16 dense MLP's bf16 errors are taken, and the
    output of a scatter accumulating in bf16, emulated."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from k8s_dra_driver_torch.ops import collective_matmul as cm
    from k8s_dra_driver_torch.ops import collectives

    torch = _leg_setup(dev)
    mesh = _rank_mesh((0, {"model": 4}), dev)
    group = mesh.get_group("model")
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    b, s, d, f = tp["b"], tp["s"], tp["d"], tp["d_ff"]
    gen = torch.Generator(device=DEV).manual_seed(SEED + 91)
    x = torch.randn((b, s, d), generator=gen, device=DEV)
    wi = torch.randn((d, f), generator=gen, device=DEV) * d ** -0.5
    wo = torch.randn((f, d), generator=gen, device=DEV) * f ** -0.5
    ct = torch.randn((b, s, d), generator=gen, device=DEV)
    seq, cols = slice(idx * s // n, (idx + 1) * s // n), slice(idx * f // n, (idx + 1) * f // n)

    def fwd_bwd(dtype):
        ins = [a.detach().to(dtype).contiguous().requires_grad_()
               for a in (x[:, seq], wi[:, cols], wo[cols])]
        out = cm.sharded_tp_mlp(*ins, mesh, bidirectional=True)
        (out.float() * ct[:, seq]).sum().backward()
        return out.detach(), ins

    def dense_mlp(dtype):
        dense = [a.detach().to(dtype).requires_grad_() for a in (x, wi, wo)]
        h = F.gelu(dense[0] @ dense[1], approximate="tanh")
        y = h @ dense[2]
        (y.float() * ct).sum().backward()
        return [y.detach(), *(t.grad for t in dense)], h.detach(), dense[2].detach()

    labels = ("output", "x grad", "w_in grad", "w_out grad")
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        out, ins = fwd_bwd(dtype)
        got = [collectives.all_gather_raw(out, group, 1),
               collectives.all_gather_raw(ins[0].grad, group, 1),
               collectives.all_gather_raw(ins[1].grad, group, 1),
               collectives.all_gather_raw(ins[2].grad, group, 0)]
        res[name] = _timed_reps(torch, lambda: fwd_bwd(dtype), tp["steps"])
        if idx:
            continue
        if dtype == torch.float32:
            want, _, _ = dense_mlp(dtype)
            res[name]["err"] = {k: _rel_err(torch, a, w) for k, a, w in zip(labels, got, want)}
            continue
        dense, h, wob = dense_mlp(dtype)
        res[name]["err"] = {k: _rel_err(torch, a, w) for k, a, w in zip(labels, got, want)}
        res[name]["dense_err"] = {k: _rel_err(torch, a, w)
                                  for k, a, w in zip(labels, dense, want)}
        # what a scatter whose accumulator is rounded to bf16 at each hop
        # would give: the n partial products summed in bf16
        acc = None
        for r in range(n):
            part = h[..., r * f // n:(r + 1) * f // n] @ wob[r * f // n:(r + 1) * f // n]
            acc = part if acc is None else acc + part
        res[name]["bf16_acc_err"] = _rel_err(torch, acc, want[0])
    res["peak"] = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    return res


def _ep_report(torch, label, results, card) -> None:
    """Print leg (h)'s numbers and hold its gates."""
    head = results[0]
    for name, err in head["err"].items():
        log(f"{label}: f32 {name} at capacity factor {EP['ample']} against the dropless oracle: "
            f"worst |EP - oracle| over the largest {err:.3g} (bound {EP_TP_F32_TOL})")
    for factor in EP["factors"]:
        caps = {r["drops"][factor][0] for r in results}
        got = [r["drops"][factor][1] for r in results]
        host = [r["drops"][factor][2] for r in results]
        log(f"{label}: capacity factor {factor} ({caps} slots an expert and rank): dropped "
            f"copies by rank {got}, host recount {host}, of {EP['tokens'] // 4 * EP['k']} a rank")
        if got != host or not all(r["drops"][factor][3] for r in results):
            raise AssertionError(f"{label}: the dropped copies at factor {factor} are not the "
                                 f"host recount's")
    if sum(r["drops"][min(EP["factors"])][1] for r in results) == 0:
        raise AssertionError(f"{label}: nothing dropped at factor {min(EP['factors'])}")
    if not max(head["err"].values()) <= EP_TP_F32_TOL:
        raise AssertionError(f"{label}: expert parallelism leaves the dropless oracle")
    note = ("; capacity factor " + str(EP["timed_factor"]) + ", forward + backward; the "
            "all-to-alls go through the host on gloo")
    for dtype in ("float32", "bfloat16"):
        _leg_numbers(f"{label} {dtype}", [r[dtype] | {"peak": r["peak"]} for r in results],
                     EP["steps"], card, note)


def _tp_mlp_report(torch, label, results, card) -> None:
    """Print leg (i)'s numbers and hold its gates."""
    head = results[0]
    note = ("; forward + backward; the rings' hops go through the host on gloo: correctness "
            "and bytes, not overlap")
    for name, err in head["float32"]["err"].items():
        log(f"{label} float32: {name} against the dense MLP: worst |ring - dense| over the "
            f"largest {err:.3g} (bound {EP_TP_F32_TOL})")
    if not max(head["float32"]["err"].values()) <= EP_TP_F32_TOL:
        raise AssertionError(f"{label}: the float32 rings leave the dense MLP")
    bf16 = head["bfloat16"]
    bounds = {}
    for name, err in bf16["err"].items():
        slack = (TP_MLP_BF16_SLACK if name in ("output", "w_out grad")
                 else TP_MLP_BF16_STEPS * 2.0 ** -8)
        bounds[name] = bf16["dense_err"][name] + slack
        log(f"{label} bfloat16: {name} against the f32 dense MLP: worst error over the "
            f"largest, ring {err:.3g}, bf16 dense MLP {bf16['dense_err'][name]:.3g} "
            f"(bound {bounds[name]:.3g})")
    log(f"{label} bfloat16: a scatter accumulating in bf16 (emulated on rank 0: the "
        f"{len(results)} partial products summed in bf16) would read {bf16['bf16_acc_err']:.3g} "
        f"on the output (bound {bounds['output']:.3g}: "
        f"{'caught' if bf16['bf16_acc_err'] > bounds['output'] else 'not caught'})")
    if any(err > bounds[name] for name, err in bf16["err"].items()):
        raise AssertionError(f"{label}: the bfloat16 rings leave the dense MLP")
    for dtype in ("float32", "bfloat16"):
        _leg_numbers(f"{label} {dtype}", [r[dtype] | {"peak": r["peak"]} for r in results],
                     TP_MLP["steps"], card, note)


# leg (j): data.TokenBatches feeding leg (b)'s step; a seeded dataset of
# 16 rows of max_seq tokens (the step's targets are its own rows shifted),
# B 4: 4 batches an epoch, the first 3 run
TOKENS_LEG = dict(rows=16, layout=(0, {"data": 2, "model": 2}))


def tokens_leg(cfg, steps: int, b: int, dev: str) -> dict:
    """Leg (j) on this rank: ``models/data.TokenBatches`` over a seeded
    ``[16, max_seq]`` token array on ``MeshShape(data=2, model=2)``, each of
    its first ``steps`` blocks (this rank's rows only) fed to leg (b)'s
    step (the main path: the flash and collective counts zeroed just
    before, each step timed), then the same steps from the same init fed
    the whole batches, computed here from the reference's permutation.
    Returns each block's agreement with its rows of the host's global
    batch, both runs' losses and the fed run's counts."""
    import torch.distributed as dist

    from k8s_dra_driver_torch.models import burnin
    from k8s_dra_driver_torch.models.data import TokenBatches
    from k8s_dra_driver_torch.ops import collectives
    from k8s_dra_driver_torch.ops import flash_attention as fa
    from k8s_dra_driver_torch.parallel.mesh import axis_index

    torch = _leg_setup(dev)
    mesh = _rank_mesh(TOKENS_LEG["layout"], dev)
    data = np.random.RandomState(SEED + 9).randint(
        0, cfg.vocab_size, size=(TOKENS_LEG["rows"], cfg.max_seq)).astype(np.int32)
    blocks = list(TokenBatches(data, b, mesh, seed=SEED, device=DEV).epoch(0))[:steps]
    order = np.random.default_rng((SEED, 0)).permutation(len(data))
    wholes = [data[order[s * b:(s + 1) * b]] for s in range(steps)]
    d, n = axis_index(mesh, "data")
    rows_ok = [bool(np.array_equal(blk.rows.cpu().numpy(), w[d * b // n:(d + 1) * b // n]))
               for blk, w in zip(blocks, wholes)]
    fns = burnin.build_train_step(cfg, mesh=mesh, attention="flash", remat="blocks",
                                  lr=MESH_TRAIN["lr"], device=DEV)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {"rows_ok": rows_ok, "rows": int(blocks[0].rows.shape[0])}
    for name, feed in (("fed", blocks), ("whole", [torch.from_numpy(w).to(DEV) for w in wholes])):
        params, state = fns.init(torch.Generator(device=DEV).manual_seed(SEED + 66))
        sync(torch)
        dist.barrier()
        _zero_flash_counts()
        collectives.reset_counts()
        losses, ms = [], []
        for batch in feed:
            t0 = time.perf_counter()
            losses.append(fns.step(params, state, batch)[2])
            sync(torch)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = [float(x) for x in losses]
        if name == "fed":
            out.update(ms=ms, fwd=dict(fa.fwd_launches), bwd=dict(fa.bwd_launches),
                       comm=dict(collectives.comm_bytes), host=dict(collectives.host_bytes))
        del params, state
    out["peak"] = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    return out


def _tokens_report(torch, label, results, cfg, steps, card) -> dict:
    """Print leg (j)'s numbers and hold its gates: every block its rows of
    the host's global batch, ranks that differ only on ``model`` holding
    the same rows, the fed losses within ``MESH_TOL`` of the whole-batch
    run's, the flash launches the schedule's.  Returns its launches by
    kernels-line row."""
    from k8s_dra_driver_torch.ops import flash_attention as fa

    head = results[0]
    loss_tol, _, why = MESH_TOL[str(cfg.dtype).split(".")[-1]]
    rel = max(abs(x - y) / abs(y) for x, y in zip(head["fed"], head["whole"]))
    log(f"{label}: {head['rows']} rows a rank a step; blocks equal to their rows of the host's "
        f"global batch on every rank: {all(all(r['rows_ok']) for r in results)}")
    log(f"{label}: losses fed blocks {' '.join(f'{x:.5f}' for x in head['fed'])}, fed whole "
        f"batches {' '.join(f'{x:.5f}' for x in head['whole'])}; worst rel {rel:.3g}, bit "
        f"for bit {head['fed'] == head['whole']} (tolerance {loss_tol}: {why})")
    _leg_numbers(label, results, steps, card)
    fwd_n, bwd_n = _mesh_flash_expected(TOKENS_LEG["layout"], {}, cfg.n_layers, steps)
    got = {name: sum(r["fwd"].get(name, 0) + r["bwd"].get(name, 0) for r in results)
           for name in (*fa.fwd_launches, *fa.bwd_launches)}
    fwd_name = fa.forward_kernel_for(cfg.dtype)
    dq_name, dkv_name = fa.backward_kernel_for(cfg.dtype)
    want = {name: 0 for name in got} | {fwd_name: fwd_n, dq_name: bwd_n, dkv_name: bwd_n}
    log(f"{label}: flash launches of the fed run summed over ranks {got}")
    if not all(all(r["rows_ok"]) for r in results):
        raise AssertionError(f"{label}: a block is not its rows of the global batch")
    if any(r["fed"] != head["fed"] for r in results):
        raise AssertionError(f"{label}: the ranks report different losses")
    if not (np.isfinite(head["fed"]).all() and rel <= loss_tol):
        raise AssertionError(f"{label}: the fed losses leave the whole-batch step's")
    if got != want:
        raise AssertionError(f"{label}: flash launches {got} are not the schedule's {want}")
    return {"flash_fwd": got[fwd_name], "flash_bwd_dq": got[dq_name],
            "flash_bwd_dkv": got[dkv_name]}


# leg (k): the mesh checkpoint of leg (b)'s step, resharded onto leg (a)'s ring
CKPT_LEG = dict(layout=(0, {"data": 2, "model": 2}), ring=(0, {"seq": 4}), before=2)


def checkpoint_leg(cfg, b: int, dev: str, directory: str) -> dict:
    """Leg (k) on this rank: leg (b)'s step (``CKPT_LEG["layout"]``) for 2
    steps, saved by the mesh checkpointer, step 3, the save restored into
    the same tensors, step 3 again; then the save restored into a fresh
    ``(seq 4)`` ring step's shards and its step 3.  The flash counts are
    zeroed before the first step.  Returns the losses, whether the two
    step-3 states are equal bit for bit, whether the ring's gathered state
    equals the saved one byte for byte, the file's bytes and the times."""
    import os

    import torch.distributed as dist

    from k8s_dra_driver_torch.models import burnin, weights
    from k8s_dra_driver_torch.models.train_checkpoint import MeshLayout, TrainCheckpointer
    from k8s_dra_driver_torch.ops import flash_attention as fa

    torch = _leg_setup(dev)
    rank = dist.get_rank()
    tokens = _train_tokens(torch, cfg, b, SEED + 7)

    def built(layout, seed):
        mesh = _rank_mesh(layout, dev)
        fns = burnin.build_train_step(cfg, mesh=mesh, attention="flash", remat="blocks",
                                      lr=MESH_TRAIN["lr"], device=DEV)
        return mesh, fns, *fns.init(torch.Generator(device=DEV).manual_seed(seed))

    def whole(mesh, params, state):
        full, opt = weights.unshard_params(cfg, mesh, params, state)
        # copies: a replicated leaf gathers to itself, and the steps update it
        return [t.to("cpu", copy=True) for t in (*burnin.param_leaves(full), opt["count"],
                                                 *opt["mu"], *opt["nu"])]

    def timed(fn):
        sync(torch)
        t0 = time.perf_counter()
        out = fn()
        sync(torch)
        return out, (time.perf_counter() - t0) * 1e3

    mesh, fns, params, state = built(CKPT_LEG["layout"], SEED + 66)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync(torch)
    dist.barrier()
    _zero_flash_counts()
    losses = [float(fns.step(params, state, tokens)[2]) for _ in range(CKPT_LEG["before"])]
    ckpt = TrainCheckpointer(directory, keep=1, layout=MeshLayout(cfg, mesh))
    step = CKPT_LEG["before"]
    _, save_ms = timed(lambda: ckpt.save(step, (params, state)))
    nbytes = os.path.getsize(os.path.join(directory, str(step), f"rank-{rank}.pt"))
    saved = whole(mesh, params, state)
    l3 = float(fns.step(params, state, tokens)[2])
    after = [t.clone() for t in _state_leaves(params, state)]
    _, restore_ms = timed(lambda: ckpt.restore(step, like=(params, state)))
    l3b = float(fns.step(params, state, tokens)[2])
    same = not _differing(after, _state_leaves(params, state))
    ckpt.close()
    del after, params, state, fns
    mesh2, fns2, p2, s2 = built(CKPT_LEG["ring"], SEED + 67)
    ckpt2 = TrainCheckpointer(directory, keep=1, layout=MeshLayout(cfg, mesh2))
    _, reshard_ms = timed(lambda: ckpt2.restore(step, like=(p2, s2)))
    ckpt2.close()
    resharded = whole(mesh2, p2, s2)
    whole_equal = len(saved) == len(resharded) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(saved, resharded))
    l3_ring = float(fns2.step(p2, s2, tokens)[2])
    sync(torch)
    return dict(losses=losses, l3=l3, l3b=l3b, same=same, whole_equal=whole_equal,
                l3_ring=l3_ring, bytes=nbytes, save_ms=save_ms, restore_ms=restore_ms,
                reshard_ms=reshard_ms, fwd=dict(fa.fwd_launches), bwd=dict(fa.bwd_launches),
                peak=torch.cuda.max_memory_allocated() if DEV == "cuda" else 0)


def _checkpoint_report(torch, label, results, cfg, card) -> dict:
    """Hold leg (k)'s gates and print its numbers; returns its flash
    launches by kernels-line row."""
    from k8s_dra_driver_torch.ops import flash_attention as fa

    head = results[0]
    loss_tol, _, why = MESH_TOL[str(cfg.dtype).split(".")[-1]]
    rel = abs(head["l3_ring"] - head["l3"]) / abs(head["l3"])
    log(f"{label}: losses {' '.join(f'{x:.5f}' for x in head['losses'])}, step 3 "
        f"{head['l3']!r}, again after the restore {head['l3b']!r}; the state after it bit for "
        f"bit on every rank: {all(r['same'] for r in results)}")
    log(f"{label}: restored onto {CKPT_LEG['ring'][1]}: the gathered params and AdamW state "
        f"equal the saved ones byte for byte on every rank: "
        f"{all(r['whole_equal'] for r in results)}; its step 3 {head['l3_ring']!r}, rel "
        f"{rel:.3g} of the {CKPT_LEG['layout'][1]} step 3 (tolerance {loss_tol}: {why})")
    log(f"{label}: bytes written by rank {' '.join(str(r['bytes']) for r in results)} "
        f"({sum(r['bytes'] for r in results) / 2**20:.2f} MiB in all); save "
        f"{' / '.join(f'{r['save_ms']:.0f}' for r in results)} ms, restore on the same mesh "
        f"{' / '.join(f'{r['restore_ms']:.0f}' for r in results)} ms, onto the ring "
        f"{' / '.join(f'{r['reshard_ms']:.0f}' for r in results)} ms by rank (host clock, 4 "
        f"ranks sharing one card and one disk; {card}); peak memory by rank "
        f"{' '.join(f'{r['peak'] / 2**30:.2f}' for r in results)} GiB")
    steps = CKPT_LEG["before"] + 2
    f1, b1 = _mesh_flash_expected(CKPT_LEG["layout"], {}, cfg.n_layers, steps)
    f2, b2 = _mesh_flash_expected(CKPT_LEG["ring"], {}, cfg.n_layers, 1)
    got = {name: sum(r["fwd"].get(name, 0) + r["bwd"].get(name, 0) for r in results)
           for name in (*fa.fwd_launches, *fa.bwd_launches)}
    fwd_name = fa.forward_kernel_for(cfg.dtype)
    dq_name, dkv_name = fa.backward_kernel_for(cfg.dtype)
    want = {name: 0 for name in got} | {fwd_name: f1 + f2, dq_name: b1 + b2,
                                         dkv_name: b1 + b2}
    log(f"{label}: flash launches summed over ranks {got} (the schedule's {want})")
    if any(r["losses"] != head["losses"] or r["l3"] != head["l3"] for r in results):
        raise AssertionError(f"{label}: the ranks report different losses")
    if not all(r["l3b"] == r["l3"] and r["same"] for r in results):
        raise AssertionError(f"{label}: the restored step 3 is not bit for bit the first one")
    if not all(r["whole_equal"] for r in results):
        raise AssertionError(f"{label}: the state restored onto the ring is not the saved one")
    if not (np.isfinite(head["l3_ring"]) and rel <= loss_tol):
        raise AssertionError(f"{label}: the ring's step 3 leaves the saved mesh's")
    if got != want:
        raise AssertionError(f"{label}: flash launches {got} are not the schedule's {want}")
    return {"flash_fwd": got[fwd_name], "flash_bwd_dq": got[dq_name],
            "flash_bwd_dkv": got[dkv_name]}


def phase_train_mesh(torch, cfg, card, f32_layers: int = 2):
    """Mesh training ("train mesh"): four ranks on the one card on a gloo
    group (CUDA tensors; ``ops/collectives`` copies what gloo cannot take
    through pinned host memory and counts it), started once; legs (a)-(d)
    of ``MESH_LEGS`` at ``cfg`` (FLAGSHIP_MODERN, full width) in bf16, then
    (a)-(d) in f32 at 2 layers; then (e), a world-1 NCCL group in this process
    running the mesh step at ``MeshShape()``.  Each leg: B 4, S 1024, remat
    "blocks", lr 3e-4, 3 steps from seeded weights, held against the
    single-card step (``MESH_TOL``, ``MESH_PARAM_UNITS``), its flash launches against the
    schedule's; (e) also probes the collectives' capture and runs its step
    graphed against an eager twin (:func:`world1_legs`).  In the same pool, legs (f)-(i): the pipeline
    (``PP_LEGS``) in bf16 at ``cfg`` and in f32 at 2 layers, expert
    parallelism (``EP``) and the tensor-parallel MLP (``TP_MLP``), (j)
    ``data.TokenBatches`` feeding leg (b)'s step (``TOKENS_LEG``) and (k)
    the mesh checkpoint of leg (b)'s step (``CKPT_LEG``), each printing its
    seconds; (l) the mesh step at ``KV_SPLIT_LEG``'s fewer KV groups than
    model ranks, in bf16 and f32, held as (a)-(d) are.  Returns the
    launches by kernels-line row."""
    import shutil
    from pathlib import Path

    from k8s_dra_driver_torch.parallel.ranks import RankPool

    b, steps = MESH_TRAIN["b"], MESH_TRAIN["steps"]
    total: dict = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    if DEV == "cuda":
        torch.cuda.empty_cache()
    f32 = dataclasses.replace(cfg, n_layers=f32_layers, dtype=torch.float32)
    with RankPool(4, backend="gloo", device_type=DEV, timeout_s=600) as pool:
        for leg_cfg, keys in ((cfg, "abcd"), (f32, "abcd")):
            for key in keys:
                what, layout, kw = MESH_LEGS[key]
                label = (f"train mesh ({key}) {what}, {str(leg_cfg.dtype)[6:]} "
                         f"L={leg_cfg.n_layers}")
                t1 = time.perf_counter()
                results = pool.run(mesh_leg, leg_cfg, layout, kw, steps, b, DEV)
                log(f"{label}: {time.perf_counter() - t1:.1f} s"
                    + (" (the 4 gloo ranks started in it)" if key + str(leg_cfg.dtype)
                       == "atorch.bfloat16" else ""))
                add(_mesh_report(torch, label, results, leg_cfg, steps, card,
                                 _mesh_flash_expected(layout, kw, leg_cfg.n_layers, steps)))
        what, layout, kw, n_kv = KV_SPLIT_LEG
        for leg_cfg in (cfg, f32):
            leg_cfg = dataclasses.replace(leg_cfg, n_kv_heads=n_kv)
            label = (f"train mesh (l) {what} {layout[1]}, n_kv_heads {n_kv}, "
                     f"{str(leg_cfg.dtype)[6:]} L={leg_cfg.n_layers}")
            t1 = time.perf_counter()
            results = pool.run(mesh_leg, leg_cfg, layout, kw, steps, b, DEV)
            log(f"{label}: {time.perf_counter() - t1:.1f} s")
            add(_mesh_report(torch, label, results, leg_cfg, steps, card,
                             _mesh_flash_expected(layout, kw, leg_cfg.n_layers, steps)))
        for leg_cfg in (cfg, f32):
            for key, (what, layout, kw) in PP_LEGS.items():
                label = (f"train mesh ({key}) {what} {layout[1]}, {str(leg_cfg.dtype)[6:]} "
                         f"L={leg_cfg.n_layers}")
                t1 = time.perf_counter()
                results = pool.run(pp_leg, leg_cfg, layout, kw, steps, b, DEV)
                log(f"{label}: {time.perf_counter() - t1:.1f} s")
                if kw["tp_mode"] == "megatron-sp":
                    log(f"{label}: the rings' hops go through the host on gloo: correctness "
                        f"and bytes, not overlap")
                add(_mesh_report(torch, label, results, leg_cfg, steps, card, None))
        label = (f"train mesh (h) expert parallelism {{'data': 4}}, {EP['experts']} experts "
                 f"top {EP['k']}, T {EP['tokens']}, d {EP['d']}, d_ff {EP['d_ff']}")
        t1 = time.perf_counter()
        _ep_report(torch, label, pool.run(ep_leg, DEV, EP), card)
        log(f"{label}: {time.perf_counter() - t1:.1f} s")
        label = (f"train mesh (i) sharded_tp_mlp {{'model': 4}} bidirectional, "
                 f"[{TP_MLP['b']}, {TP_MLP['s']}, {TP_MLP['d']}] x [{TP_MLP['d']}, "
                 f"{TP_MLP['d_ff']}]")
        t1 = time.perf_counter()
        _tp_mlp_report(torch, label, pool.run(tp_mlp_leg, DEV, TP_MLP), card)
        log(f"{label}: {time.perf_counter() - t1:.1f} s")
        label = (f"train mesh (j) TokenBatches into (b) {TOKENS_LEG['layout'][1]}, "
                 f"{str(cfg.dtype)[6:]} L={cfg.n_layers}, [{TOKENS_LEG['rows']}, {cfg.max_seq}] "
                 f"tokens, B {b}")
        t1 = time.perf_counter()
        add(_tokens_report(torch, label, pool.run(tokens_leg, cfg, steps, b, DEV), cfg, steps,
                           card))
        log(f"{label}: {time.perf_counter() - t1:.1f} s")
        label = (f"train mesh (k) mesh checkpoint of (b) {CKPT_LEG['layout'][1]}, restored "
                 f"there and onto {CKPT_LEG['ring'][1]}, {str(cfg.dtype)[6:]} L={cfg.n_layers}")
        where = Path(__file__).resolve().parent / "build" / "chip_smoke_mesh_checkpoint"
        shutil.rmtree(where, ignore_errors=True)
        t1 = time.perf_counter()
        try:
            add(_checkpoint_report(torch, label, pool.run(checkpoint_leg, cfg, b, DEV,
                                                          str(where)), cfg, card))
        finally:
            shutil.rmtree(where, ignore_errors=True)
        log(f"{label}: {time.perf_counter() - t1:.1f} s")
    add(world1_legs(torch, cfg, card, steps, b))
    return total


def world1_legs(torch, cfg, card, steps: int, b: int) -> dict:
    """Leg (e): a world-1 NCCL group in this process (gloo in a CPU
    rehearsal: NCCL takes CUDA tensors only) running the mesh step at
    ``MeshShape()`` as :func:`mesh_leg` runs a leg, held as (a)-(d) are;
    then :func:`collective_capture_probe` and :func:`world1_graph_leg`.
    Returns the launches by kernels-line row."""
    import torch.distributed as dist

    from k8s_dra_driver_torch.parallel.ranks import free_port, init_ranks

    total: dict = {}
    backend = "nccl" if DEV == "cuda" else "gloo"
    label = f"train mesh (e) world-1 {backend}, MeshShape(), {str(cfg.dtype)[6:]} L={cfg.n_layers}"
    t1 = time.perf_counter()
    init_ranks(0, 1, backend, free_port(), DEV)
    try:
        results = [mesh_leg(cfg, (0, {}), {}, steps, b, DEV)]
        log(f"{label}: {time.perf_counter() - t1:.1f} s")
        total = _mesh_report(torch, label, results, cfg, steps, card,
                             _mesh_flash_expected((0, {}), {}, cfg.n_layers, steps))
        t1 = time.perf_counter()
        collective_capture_probe(torch, f"train mesh (e) capture probe, world-1 {backend}")
        log(f"train mesh (e) capture probe: {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        graphed = world1_graph_leg(torch, cfg, b, card, f"train mesh (e) graphed, {backend}")
        log(f"train mesh (e) graphed: {time.perf_counter() - t1:.1f} s")
    finally:
        dist.destroy_process_group()
    return {k: n + graphed[k] for k, n in total.items()}


def _traffic(vocab: int, n: int, max_prompt: int, max_new: int, seed: int):
    r = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        plen = int(r.randint(16, max_prompt + 1))
        reqs.append((r.randint(0, vocab, size=plen).tolist(), int(r.randint(32, max_new + 1))))
    return reqs


def _dense_reference(params):
    """The plain dense path's params: int4 matrices replaced by their exact
    dequantized weights, so the reference runs no kernel."""
    from k8s_dra_driver_torch.models import quant

    out = dict(params)
    out["blocks"] = [
        {k: (v.dequant() if isinstance(v, quant.Quantized4Matrix) else v) for k, v in blk.items()}
        for blk in params["blocks"]
    ]
    return out


def _zero_serving_counts():
    from k8s_dra_driver_torch.models import serve

    counts = serve.launch_counts()
    serve.add_launch_counts({key: -n for key, n in counts.items()})


def _serving_engine(cfg, params, cache_dtype):
    from k8s_dra_driver_torch.models.paged import PagedServeEngine

    return PagedServeEngine(
        params=params, cfg=cfg, n_slots=8, n_blocks=8 * 24 + 1, block_size=16,
        prompt_bucket=256, cache_dtype=cache_dtype, sync_interval=8,
        preempt_on_stall=False, device=DEV,
    )


def graph_pool_bytes(torch, graph) -> int:
    """Bytes of the segments the caching allocator holds in ``graph``'s
    private memory pool."""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def graph_bookkeeping(torch, label, eng):
    """Print each of the engine's CUDA graphs (calls, capture time, pool
    bytes); fail if there are more than the engine's bound (a paged
    engine's ``graph_bound``: 4, plus a chunk program per width a chunk or
    a prefix hit's suffix can take when those features are on; 4 for the
    dense engine) or a graph called twice was not captured."""
    max_graphs = getattr(eng, "graph_bound", 4)
    graphs = eng.graphs
    total = 0
    for name, prog in graphs.items():
        pool = graph_pool_bytes(torch, prog.graph) if prog.graph is not None else 0
        total += pool
        capture = ("not captured" if prog.capture_s is None
                   else f"captured in {prog.capture_s * 1e3:.1f} ms")
        log(f"{label}: graph {name!r}: {prog.calls} calls, {capture}, pool {pool / 2**20:.2f} MiB")
    log(f"{label}: {len(graphs)} graphs, pools {total / 2**20:.2f} MiB together")
    if not 0 < len(graphs) <= max_graphs:
        raise AssertionError(f"{label}: {len(graphs)} graphs (want 1-{max_graphs})")
    if any(p.graph is None for p in graphs.values() if p.calls >= 2):
        raise AssertionError(f"{label}: a graph called twice was never captured")


def phase_serve(torch, label, cfg, params, reqs, *, cache_dtype, logit_tol):
    """Serve ``reqs`` through the engine, its programs as CUDA graphs (the
    main path); check every stream teacher-forced against the plain dense
    decode path, and the run against an eager twin engine
    (``serve.disable_graphs()``) on the same requests: completions,
    statuses, host syncs, stalls, final pool bytes outside the null block
    and every kernel launch count identical.  Returns the paged and int4 launch counts of the
    graphed run."""
    from k8s_dra_driver_torch.models import decode, serve
    from k8s_dra_driver_torch.models.paged import NULL_BLOCK
    from k8s_dra_driver_torch.ops import int4_matmul as i4
    from k8s_dra_driver_torch.ops import paged_attention as pa

    def drive(eager):
        eng = _serving_engine(cfg, params, cache_dtype)
        sync(torch)
        _zero_serving_counts()
        t0 = time.perf_counter()
        with serve.disable_graphs() if eager else contextlib.nullcontext():
            comps = eng.pump(reqs)
        sync(torch)
        wall = time.perf_counter() - t0
        if i4.launches != sum(i4.kernel_launches.values()):
            raise AssertionError(f"{label}: int4 launches {i4.launches} are not the kernels' sum")
        return eng, comps, wall, serve.launch_counts()

    eng, comps, wall, all_counts = drive(eager=False)
    counts = {"paged_attention": pa.launches["append"],
              "paged_attention_window": pa.launches["window"],
              "int4_matmul": i4.kernel_launches["int4_splitk"],
              "int4_matmul_prefill": i4.kernel_launches["int4_wgmma"]}
    generated = sum(len(c.generated) for c in comps)
    if len(comps) != len(reqs):
        raise AssertionError(f"{label}: {len(comps)} completions for {len(reqs)} requests")
    log(f"{label}: {len(comps)} requests, {generated} tokens in {wall:.2f} s = "
        f"{generated / wall:.1f} tokens/s (graphed); {eng.decode_steps} decode steps, "
        f"{wall / max(eng.decode_steps, 1) * 1e3:.2f} ms wall per step (admissions included); "
        f"host_syncs {eng.host_syncs}, stalled_steps {eng.stalled_steps}")
    graph_bookkeeping(torch, label, eng)

    twin, twin_comps, twin_wall, twin_counts = drive(eager=True)
    log(f"{label}: eager twin: {twin_wall:.2f} s = {generated / twin_wall:.1f} tokens/s; "
        f"host_syncs {twin.host_syncs}, stalled_steps {twin.stalled_steps}")
    streams = sorted((c.request_id, c.generated, c.status) for c in comps)
    if streams != sorted((c.request_id, c.generated, c.status) for c in twin_comps):
        raise AssertionError(f"{label}: graphed and eager completions differ")
    if (eng.host_syncs, eng.stalled_steps) != (twin.host_syncs, twin.stalled_steps):
        raise AssertionError(f"{label}: graphed and eager host syncs or stalls differ")
    differ = sorted(
        {int(b) for a, b_ in ((eng._cache.k, twin._cache.k), (eng._cache.v, twin._cache.v))
         for b in torch.nonzero((a != b_).transpose(0, 1).flatten(1).any(1)).flatten().tolist()}
    )
    # the null block is the sink of prefill's stripes past a prompt's own
    # blocks: one indexed write with repeated indices, whose winner PyTorch
    # leaves unspecified; nothing reads it as history
    log(f"{label}: pool blocks whose bytes differ between graphed and eager: {differ} "
        f"(block {NULL_BLOCK} is the null block)")
    if any(b != NULL_BLOCK for b in differ):
        raise AssertionError(f"{label}: graphed and eager pools differ after the drain")
    if all_counts != twin_counts:
        raise AssertionError(
            f"{label}: launch counts differ: graphed {all_counts}, eager {twin_counts}"
        )
    log(f"{label}: graphed == eager twin: {len(streams)} completions with statuses, host "
        f"syncs, stalls, pool bytes outside the null block and launch counts {all_counts}")
    del twin, twin_comps

    ref = _dense_reference(params)
    by_id = {c.request_id: c for c in comps}
    exact = total = 0
    worst_gap = 0.0
    for rid, (prompt, max_tokens) in enumerate(reqs):
        c = by_id[rid]
        if len(c.generated) != max_tokens:
            raise AssertionError(f"{label}: request {rid} generated {len(c.generated)} of {max_tokens}")
        seq = torch.tensor([c.tokens], device=DEV)
        cache = decode.init_cache(cfg, 1, seq.shape[1], dtype=cache_dtype, device=DEV)
        logits, _ = decode.decode_chunk(ref, cache, seq, 0, cfg=cfg)
        logits = logits[0, len(prompt) - 1 : -1]               # predicts each generated token
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{label}: non-finite reference logits")
        gen = torch.tensor(c.generated, device=DEV)
        best = logits.max(dim=-1).values
        picked = logits.gather(1, gen[:, None])[:, 0]
        gap = (best - picked).max().item()
        worst_gap = max(worst_gap, gap)
        exact += int((logits.argmax(dim=-1) == gen).sum().item())
        total += len(c.generated)
        if gap > logit_tol:
            raise AssertionError(
                f"{label}: request {rid} picked a token {gap:.4g} below the reference argmax"
            )
    log(f"{label}: teacher-forced vs plain dense decode: exact argmax {exact}/{total} "
        f"({exact / total:.4f}), worst logit gap {worst_gap:.4g} (tolerance {logit_tol}: "
        f"{TOL_WHY[cache_dtype == torch.float32]})")
    log(f"{label}: launches {counts}")
    if counts["paged_attention"] == 0:
        raise AssertionError(f"{label}: the paged kernel was never launched")
    SERVED[label] = {c.request_id: c.generated for c in comps}
    del eng
    steady_decode(torch, label, cfg, params, cache_dtype=cache_dtype)
    return counts


def steady_decode(torch, label, cfg, params, *, cache_dtype, rounds=4, bursts=4):
    """Decode-only step time at the serving batch, eager against graphed:
    two engines with the same 8 resident requests (prompt 128; none retires
    inside the window), one run eagerly (``serve.disable_graphs()``), one
    with its programs as CUDA graphs.  After 3 warm-up bursts each (the
    graphed engine's first call runs eagerly, its second captures), the two
    alternate for ``rounds`` rounds of ``bursts`` 8-step bursts each, on
    the host clock around a synchronised window (eager, graphed, eager,
    ...; their streams stay identical, so their contexts match).  Then one
    burst of each under ``torch.profiler``: the device's busy share, and
    the paged call's device time per call inside the graph.  The least time
    the card could take for a step reads every stored parameter byte and
    each row's K/V once.  Fails if the graphed step is slower than the
    eager one."""
    from k8s_dra_driver_torch.models import serve
    from k8s_dra_driver_torch.models.quant import quantized_bytes

    r = np.random.RandomState(SEED + 7)
    prompts = [r.randint(0, cfg.vocab_size, size=128).tolist() for _ in range(8)]
    engines = {}
    for mode in ("eager", "graphed"):
        eng = _serving_engine(cfg, params, cache_dtype)
        with serve.disable_graphs() if mode == "eager" else contextlib.nullcontext():
            for p in prompts:
                eng.submit(p, max_tokens=8 * (3 + rounds * bursts + 2))
            for _ in range(3):  # warm-up bursts
                eng.step_burst()
        engines[mode] = eng
    times = {"eager": [], "graphed": []}
    for _ in range(rounds):
        for mode, eng in engines.items():
            with serve.disable_graphs() if mode == "eager" else contextlib.nullcontext():
                sync(torch)
                t0 = time.perf_counter()
                for _ in range(bursts):
                    eng.step_burst()
                sync(torch)
            times[mode].append((time.perf_counter() - t0) / (8 * bursts) * 1e3)
    itemsize = torch.empty((), dtype=cache_dtype).element_size()
    mean_ctx = 128 + 8 * 3 + 8 * rounds * bursts / 2
    kv = 8 * mean_ctx * 2 * cfg.n_layers * cfg.kv_heads * cfg.head_dim * itemsize
    weights = quantized_bytes(params)[0]
    b_ms, _ = bound(weights + kv, 0, "bfloat16")
    med = {mode: float(np.median(t)) for mode, t in times.items()}
    STEADY_MS.update({(label, mode): t for mode, t in med.items()})
    for mode in ("eager", "graphed"):
        log(f"{label}: steady decode B=8 ctx~{mean_ctx:.0f}, {mode}: "
            f"{' / '.join(f'{t:.3f}' for t in times[mode])} ms per step by round "
            f"(median {med[mode]:.3f} ms, {8 / med[mode] * 1e3:.0f} tokens/s)")
    log(f"{label}: steady decode bound {b_ms * 1e3:.1f} us per step "
        f"({weights / 1e6:.1f} MB parameters + {kv / 1e6:.1f} MB K/V); graphed / eager "
        f"{med['graphed'] / med['eager']:.3f}")
    eager, graphed = engines["eager"], engines["graphed"]
    if [st.tokens for st in eager._slots] != [st.tokens for st in graphed._slots]:
        raise AssertionError(f"{label}: the eager and graphed steady streams differ")
    graph_bookkeeping(torch, f"{label} steady", graphed)
    with serve.disable_graphs():
        profile_window(torch, f"{label}: profile of one eager 8-step burst", eager.step_burst,
                       watch=("paged_", "int4_"))
    prof = profile_window(torch, f"{label}: profile of one graphed 8-step burst",
                          graphed.step_burst, watch=("paged_", "int4_"))
    if prof is not None:
        partial = [r_ for r_ in prof["rows"] if "paged_attention_partial" in r_[2]]
        merge = [r_ for r_ in prof["rows"] if "paged_attention_merge" in r_[2]]
        calls = sum(r_[1] for r_ in partial)
        if calls:
            p_us = sum(r_[0] for r_ in partial) / calls
            m_us = sum(r_[0] for r_ in merge) / calls
            log(f"{label}: graphed burst: paged call {p_us + m_us:.2f} us of device time per "
                f"call over {calls} calls (partial {p_us:.2f}, merge {m_us:.2f} us)")
        busy_ms = prof["busy_us"] / 8 / 1e3
        kernels = sum(r_[1] for r_ in prof["rows"])
        log(f"{label}: graphed burst: device busy {busy_ms:.3f} ms per step over {kernels} "
            f"kernels, {prof['busy_us'] / prof['window_us']:.3f} of the profiled window and "
            f"{busy_ms / med['graphed']:.3f} of the unprofiled graphed step ({med['graphed']:.3f} ms)")
    # the burst graph's span on the device, the gaps between its kernels
    # included: three replays back to back, after every check (they move the
    # device state on behind the engine's back; the engine is not used again)
    burst = graphed.graphs.get("burst k=8")
    if DEV == "cuda" and burst is not None and burst.graph is not None:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        sync(torch)
        start.record()
        for _ in range(3):
            burst.graph.replay()
        end.record()
        end.synchronize()
        span = start.elapsed_time(end) / 24
        log(f"{label}: the burst graph replayed alone: {span:.3f} ms per step on the device "
            f"(its kernels and the gaps between them); the rest of the graphed step, "
            f"{med['graphed'] - span:.3f} ms, is the host's")
    if med["graphed"] > med["eager"]:
        raise AssertionError(f"{label}: the graphed step ({med['graphed']:.3f} ms) is slower "
                             f"than the eager one ({med['eager']:.3f} ms)")


# the lifecycle phase's engine: the serving engine's geometry with top-k
# sampling, and a pool small enough that the seeded traffic preempts
LIFECYCLE = dict(n_slots=8, block_size=16, prompt_bucket=256, sync_interval=8, top_k=50)
LIFECYCLE_POOL = 49  # blocks, the null block included
LIFECYCLE_ROOMY = 8 * 14 + 1  # every slot at its longest stream (224 tokens)
LIFECYCLE_TEMP = 0.8
LIFECYCLE_POISON = dict(nan_logits_rate=1.0, slots=(2,), steps=(5,))
STEADY_MS: dict = {}  # steady-decode medians by phase label and mode
# the graphed bf16 steady decode step before the sampling tail joined it
# (PERF.md section 5, the serving table)
PRE_TAIL_BF16_STEP_MS = 1.229


def _lifecycle_traffic(vocab: int, seed: int, n: int = 16):
    """``n`` requests, prompts 16-96 tokens and 64-128 new ones; odd ones
    sampled at ``LIFECYCLE_TEMP`` with explicit seeds, even ones greedy;
    priorities 0 and 1 alternating by pairs, so each tier holds greedy
    and sampled requests (and either kind may be evicted)."""
    r = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        req = dict(prompt=r.randint(0, vocab, size=int(r.randint(16, 97))).tolist(),
                   max_tokens=int(r.randint(64, 129)), priority=(i // 2) % 2)
        if i % 2:
            req.update(temperature=LIFECYCLE_TEMP, seed=1000 + i)
        reqs.append(req)
    return reqs


def _lifecycle_engine(cfg, params, n_blocks, cache_dtype, fault_injector=None):
    from k8s_dra_driver_torch.models.paged import PagedServeEngine

    return PagedServeEngine(params=params, cfg=cfg, n_blocks=n_blocks, cache_dtype=cache_dtype,
                            device=DEV, fault_injector=fault_injector, **LIFECYCLE)


def lifecycle_drive(eng, reqs, cancel_after: int | None = 3, max_bursts: int = 5000):
    """Admit ``reqs`` FIFO as capacity frees and burst-step in between;
    after burst ``cancel_after`` cancel the resident request with the
    lowest id.  Runs until nothing is queued, resident or parked.  Returns
    ``(completions, ids ever parked, the cancelled id)``."""
    from k8s_dra_driver_torch.models import serve

    queue, comps, parked, cancelled = list(reqs), [], set(), None
    for burst in range(1, max_bursts + 1):
        while queue and eng.free_slots():
            try:
                eng.submit(**queue[0])
            except serve.NoCapacity:
                break
            queue.pop(0)
        eng.step_burst()
        parked |= {r["st"].request_id for r in eng._preempted}
        if burst == cancel_after:
            cancelled = min(st.request_id for st in eng._slots if st is not None)
            eng.cancel(cancelled)
        comps += eng.completions()
        if not queue and eng.free_slots() == eng.n_slots and not eng._preempted:
            return comps, parked, cancelled
    raise AssertionError(f"the lifecycle run did not drain in {max_bursts} bursts")


def _teacher_forced(torch, cfg, ref, req, c, cache_dtype, tol_greedy, tol_sampled):
    """The completion's tokens against the plain dense path: greedy tokens
    within ``tol_greedy`` of the dense argmax; each sampled token inside
    the dense top-k (to ``tol_sampled``) with its perturbed score (the
    dense logits over the temperature plus the port's Gumbel noise for its
    key and position) within ``tol_sampled`` of the best perturbed score
    among the tokens over the k-th value by more than ``tol_sampled``.
    Returns ``(worst gap, tokens that are the dense draw, tokens)``."""
    from k8s_dra_driver_torch.models import decode, prng

    plen, n = len(req["prompt"]), len(c.generated)
    seq = torch.tensor([c.tokens], device=DEV)
    cache = decode.init_cache(cfg, 1, seq.shape[1], dtype=cache_dtype, device=DEV)
    logits, _ = decode.decode_chunk(ref, cache, seq, 0, cfg=cfg)
    logits = logits[0, plen - 1 : plen - 1 + n].float()        # predicts each generated token
    if not torch.isfinite(logits).all():
        raise AssertionError(f"non-finite reference logits for request {c.request_id}")
    gen = torch.tensor(c.generated, device=DEV)
    temp = req.get("temperature", 0.0)
    if temp <= 0:
        best = logits.max(dim=-1).values
        gap = (best - logits.gather(1, gen[:, None])[:, 0]).max().item()
        exact = int((logits.argmax(dim=-1) == gen).sum().item())
        limit = tol_greedy
    else:
        scaled = logits / temp
        kth = torch.topk(scaled, LIFECYCLE["top_k"], dim=-1).values[:, -1]
        pos = torch.arange(plen - 1, plen - 1 + n, dtype=torch.int32, device=DEV)
        keys = prng.prng_key(req["seed"]).to(DEV).expand(n, 2)
        perturbed = scaled + prng.gumbel(prng.fold_in(keys, pos), (cfg.vocab_size,))
        # the competitors: tokens in the engine's top-k whatever its logits
        # within the tolerance; one within it of the k-th value may have
        # fallen outside the engine's mask, and Gumbel noise is large
        sure = scaled >= kth[:, None] + tol_sampled
        best = torch.where(sure, perturbed, float("-inf")).max(dim=-1).values
        picked = perturbed.gather(1, gen[:, None])[:, 0]
        outside = (kth - scaled.gather(1, gen[:, None])[:, 0]).clamp_min(0)
        gap = torch.maximum(best - picked, outside).max().item()
        exact = int((torch.where(scaled >= kth[:, None], perturbed, float("-inf"))
                     .argmax(dim=-1) == gen).sum().item())
        limit = tol_sampled
    if gap > limit:
        raise AssertionError(
            f"request {c.request_id} (temperature {temp}) picked a token {gap:.4g} below the "
            f"dense path's choice (limit {limit:.4g})")
    return gap, exact, n


def _prng_on_the_card(torch):
    """Threefry's known answers on the card; bits and uniforms for 8 keys
    over [8, 32768] equal to the CPU's bit for bit."""
    from k8s_dra_driver_torch.models import prng

    mask = 0xFFFFFFFF
    for key, count, want in [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                             ((mask, mask), (mask, mask), (0x1CB996FC, 0xBB002BE7)),
                             ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                              (0xC4923A9C, 0x483DF7A0))]:
        y0, y1 = prng.threefry2x32(torch.tensor(key, device=DEV),
                                   torch.tensor([count[0]], device=DEV),
                                   torch.tensor([count[1]], device=DEV))
        if (int(y0), int(y1)) != want:
            raise AssertionError(f"threefry{key, count} = {int(y0):#x}, {int(y1):#x}, want {want}")
    keys = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, 2**32, size=(8, 2), dtype=np.uint64).astype(np.int64))
    shape = (8, 32768)
    bits_equal = torch.equal(prng.random_bits(keys.to(DEV), shape).cpu(),
                             prng.random_bits(keys, shape))
    u_equal = torch.equal(prng.uniform(keys.to(DEV), shape).cpu(), prng.uniform(keys, shape))
    g_dev, g_cpu = prng.gumbel(keys.to(DEV), shape).cpu(), prng.gumbel(keys, shape)
    log(f"prng on the card: threefry's 3 known answers hold; random bits {bits_equal}, "
        f"uniforms {u_equal} bit for bit against the CPU over 8 keys x {shape}; Gumbel noise "
        f"max |card - cpu| {(g_dev - g_cpu).abs().max().item():.3g} (each device's own log)")
    if not (bits_equal and u_equal):
        raise AssertionError("random bits or uniforms on the card differ from the CPU's")


def sampling_tail_cost(torch, cfg, greedy_step_ms: float):
    """The sampling tail (``serve.sample_next`` at batch 8 over the vocab,
    top-k 50) alone: one captured CUDA graph of 8 calls timed by events
    (ms per call), one eager call and one graph replay under the profiler
    (kernels per call, device time).  Prints its share of the greedy
    step.  Returns the ms per call."""
    from k8s_dra_driver_torch.models import graphs, serve

    g = torch.Generator(device=DEV).manual_seed(SEED)
    logits = torch.randn((8, cfg.vocab_size), generator=g, device=DEV) * 3
    pos = torch.arange(100, 108, dtype=torch.int32, device=DEV)
    temps = torch.full((8,), LIFECYCLE_TEMP, device=DEV)
    keys = torch.arange(16, dtype=torch.int64, device=DEV).reshape(8, 2)
    out = torch.zeros((8,), dtype=torch.int32, device=DEV)

    def tail8():
        for _ in range(8):
            out.copy_(serve.sample_next(logits, pos, temps, keys, top_k=LIFECYCLE["top_k"]))

    tail8()  # eager: builds the iota outside the capture
    graph, _ = graphs.cuda_capture(tail8, torch.device(DEV))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(5):
        sync(torch)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 8)
    ms = float(np.median(times))
    eager = profile_window(torch, "sampling tail: profile of one eager call",
                           lambda: serve.sample_next(logits, pos, temps, keys,
                                                     top_k=LIFECYCLE["top_k"]))
    replay = profile_window(torch, "sampling tail: profile of one graph replay (8 calls)",
                            graph.replay)
    kernels = sum(r_[1] for r_ in eager["rows"]) if eager else None
    dev_ms = replay["busy_us"] / 8 / 1e3 if replay else None
    log(f"sampling tail at batch 8 x {cfg.vocab_size}, top-k {LIFECYCLE['top_k']}: "
        f"{ms:.4f} ms per call in a CUDA graph ({' / '.join(f'{t:.4f}' for t in times)}), "
        f"{kernels} kernels per call, device time {dev_ms} ms per call in the profiled replay; "
        f"{ms / greedy_step_ms:.3f} of the greedy graphed step ({greedy_step_ms:.3f} ms)")
    return ms


def steady_sampled_vs_greedy(torch, cfg, params, cache_dtype, rounds=4, bursts=4):
    """Steady decode at batch 8, graphed, all 8 slots sampled against all 8
    greedy (the tail runs for both): 3 warm-up bursts each, then
    ``rounds`` alternating rounds of ``bursts`` 8-step bursts on the host
    clock.  Returns the medians in ms per step by mode."""
    r = np.random.RandomState(SEED + 9)
    prompts = [r.randint(0, cfg.vocab_size, size=128).tolist() for _ in range(8)]
    engines = {}
    for mode in ("greedy", "sampled"):
        eng = _lifecycle_engine(cfg, params, LIFECYCLE_ROOMY + 32, cache_dtype)
        for i, p in enumerate(prompts):
            eng.submit(p, max_tokens=8 * (3 + rounds * bursts + 2),
                       temperature=LIFECYCLE_TEMP if mode == "sampled" else 0.0, seed=i)
        for _ in range(3):
            eng.step_burst()
        engines[mode] = eng
    times = {mode: [] for mode in engines}
    for _ in range(rounds):
        for mode, eng in engines.items():
            sync(torch)
            t0 = time.perf_counter()
            for _ in range(bursts):
                eng.step_burst()
            sync(torch)
            times[mode].append((time.perf_counter() - t0) / (8 * bursts) * 1e3)
    med = {mode: float(np.median(t)) for mode, t in times.items()}
    for mode in engines:
        log(f"serve bf16 lifecycle: steady decode B=8, graphed, all {mode}: "
            f"{' / '.join(f'{t:.3f}' for t in times[mode])} ms per step by round "
            f"(median {med[mode]:.3f} ms)")
    return med


def phase_serve_lifecycle(torch, cfg, params, *, cache_dtype, tol_greedy=0.25):
    """The paged engine's request lifecycle at full width in bf16: sampled
    and greedy requests with priorities, a pool that preempts, a cancel
    after the third burst and one slot poisoned at one step, graphed (the
    main path) against an eager twin, against a roomy fault-free run, and
    teacher-forced against the plain dense path; the PRNG on the card; the
    sampling tail's cost.  Returns the paged append launches of the
    graphed run."""
    from k8s_dra_driver_torch.models.paged import NULL_BLOCK
    from k8s_dra_driver_torch.ops import paged_attention as pa
    from k8s_dra_driver_torch.utils import faults

    label = "serve bf16 lifecycle"
    reqs = _lifecycle_traffic(cfg.vocab_size, SEED + 11)
    tol_sampled = tol_greedy / LIFECYCLE_TEMP

    runs = []

    def drive(eager, n_blocks=LIFECYCLE_POOL, faulty=True):
        inj = None
        if faulty:
            inj = faults.FaultInjector(SEED)
            inj.arm(faults.FaultProfile(name="poison", **LIFECYCLE_POISON))
        eng = _lifecycle_engine(cfg, params, n_blocks, cache_dtype, inj)
        comps, parked, cancelled = lifecycle_drive(eng, reqs, 3 if faulty else None)
        runs.append((parked, cancelled))
        return eng, comps

    eng, comps, counts = _engine_twin(
        torch, label, drive, ("preempted_count", "quarantined", "host_syncs", "stalled_steps"),
        pool_from=NULL_BLOCK + 1)
    (parked, cancelled), _ = runs
    append = counts[(pa.__name__, "append")]
    statuses = {}
    for c in comps:
        statuses[c.status] = statuses.get(c.status, 0) + 1
    log(f"{label}: pool {LIFECYCLE_POOL} blocks (null block included) of {LIFECYCLE['block_size']} "
        f"tokens, {len(reqs)} requests; statuses {statuses}; preempted_count "
        f"{eng.preempted_count} (requests parked {sorted(parked)}); quarantined "
        f"{eng.quarantined}; cancelled {cancelled}; paged append launches {append} (graphed run)")
    if eng.preempted_count < 1 or len(eng.quarantined) != 1 or statuses.get("cancelled") != 1:
        raise AssertionError(f"{label}: the run must preempt, quarantine one request and "
                             f"cancel one: {eng.preempted_count}, {eng.quarantined}, {statuses}")
    if len(comps) != len(reqs) or append == 0:
        raise AssertionError(f"{label}: {len(comps)} completions, {append} paged launches")

    roomy, roomy_comps = drive(eager=False, n_blocks=LIFECYCLE_ROOMY, faulty=False)
    roomy_parked = runs[-1][0]
    if roomy.preempted_count or roomy_parked or roomy.stalled_steps:
        raise AssertionError(f"{label}: the roomy run stalled or preempted")
    want = {c.request_id: c.generated for c in roomy_comps}
    differ = []
    for c in comps:
        if c.request_id in parked:
            differ += [c.request_id] if c.generated != want[c.request_id][: len(c.generated)] else []
        elif c.status == "ok":
            if c.generated != want[c.request_id]:
                raise AssertionError(f"{label}: request {c.request_id}, never preempted, "
                                     "differs from the roomy run")
        elif c.generated != want[c.request_id][: len(c.generated)]:
            raise AssertionError(f"{label}: {c.status} request {c.request_id} is not a "
                                 "prefix of its roomy stream")
    log(f"{label}: row independence: every never-preempted stream equals the roomy fault-free "
        f"run's bit for bit, the cancelled and quarantined ones are prefixes of theirs; "
        f"preempted streams differing from the roomy run: {len(differ)} of {len(parked)} "
        f"{sorted(differ)} (held teacher-forced below)")
    del roomy, roomy_comps

    ref = _dense_reference(params)
    worst = {"greedy": 0.0, "sampled": 0.0}
    exact = {"greedy": [0, 0], "sampled": [0, 0]}
    for c in comps:
        req = reqs[c.request_id]
        kind = "sampled" if req.get("temperature", 0.0) > 0 else "greedy"
        gap, hit, n = _teacher_forced(torch, cfg, ref, req, c, cache_dtype, tol_greedy,
                                      tol_sampled)
        worst[kind] = max(worst[kind], gap)
        exact[kind][0] += hit
        exact[kind][1] += n
    log(f"{label}: teacher-forced vs plain dense decode: greedy tokens the dense argmax "
        f"{exact['greedy'][0]}/{exact['greedy'][1]}, worst logit gap {worst['greedy']:.4g} "
        f"(tolerance {tol_greedy}); sampled tokens the dense draw {exact['sampled'][0]}/"
        f"{exact['sampled'][1]}, worst perturbed-score gap {worst['sampled']:.4g} (tolerance "
        f"{tol_sampled:.4g} = {tol_greedy} / temperature {LIFECYCLE_TEMP}: "
        f"{TOL_WHY[False]})")
    del eng, comps

    _prng_on_the_card(torch)
    med = steady_sampled_vs_greedy(torch, cfg, params, cache_dtype)
    tail_ms = sampling_tail_cost(torch, cfg, med["greedy"])
    old = STEADY_MS.get(("serve bf16", "graphed"))
    log(f"{label}: the sampling tail costs {tail_ms:.4f} ms of the {med['greedy']:.3f} ms greedy "
        f"step ({tail_ms / med['greedy']:.3f}); all sampled / all greedy "
        f"{med['sampled'] / med['greedy']:.3f}; serve bf16 steady decode graphed "
        f"{old if old is None else f'{old:.3f}'} ms this run against {PRE_TAIL_BF16_STEP_MS} "
        f"ms recorded before the tail")
    return {"paged_attention": append}


# the dense engine's phase: the serving engines' slots, bucket and burst
DENSE = dict(n_slots=8, prompt_bucket=256, sync_interval=8)
DENSE_PREFIX = dict(prefix_bucket=64, prefix_cache_entries=8)
DENSE_SNAPSHOT_AFTER = 4  # bursts
DENSE_QUEUE_LIMIT = 4


def _dense_engine(cfg, params, cache_dtype, **kw):
    from k8s_dra_driver_torch.models.serve import ServeEngine

    return ServeEngine(params=params, cfg=cfg, cache_dtype=cache_dtype, device=DEV,
                       **dict(DENSE, **kw))


def _dense_prefix_traffic(vocab: int, seed: int, n: int = 16):
    """``n`` greedy requests, each one of two seeded 64-token system
    prompts (alternating) and 16-160 tokens of its own, 32-64 new tokens."""
    r = np.random.RandomState(seed)
    systems = [r.randint(0, vocab, size=64).tolist() for _ in range(2)]
    return [dict(prompt=systems[i % 2] + r.randint(0, vocab, size=int(r.randint(16, 161))).tolist(),
                 max_tokens=int(r.randint(32, 65))) for i in range(n)]


def _greedy_dicts(reqs):
    return [dict(prompt=p, max_tokens=m) for p, m in reqs]


DENSE_TWIN_ATTRS = ("host_syncs", "prefix_hits", "prefix_misses", "quarantined")
PAGED_TWIN_ATTRS = ("host_syncs", "stalled_steps", "preempted_count", "quarantined",
                    "prefix_hits", "prefix_misses")


def _engine_twin(torch, label, drive, attrs=DENSE_TWIN_ATTRS, pool_from=0, twin="eager"):
    """``drive(is_twin) -> (engine, completions)`` run as the main path
    (graphed, launch counts zeroed just before) and as its twin: eagerly
    (``twin="eager"``, under ``serve.disable_graphs()``) or graphed too (any
    other name: ``drive`` builds the twin, e.g. with telemetry off):
    completions with their statuses, the engine counters ``attrs``, the
    final cache bytes from block ``pool_from`` on (1 for a paged pool:
    block 0 is the null block, the sink of prefill's spare stripes), the
    draft cache's bytes where the engine speculates, and every launch count
    must be identical.  Returns the main engine, its completions and its
    launch counts."""
    from k8s_dra_driver_torch.models import serve

    runs = []
    for is_twin in (False, True):
        sync(torch)
        _zero_serving_counts()
        t0 = time.perf_counter()
        eager = is_twin and twin == "eager"
        with serve.disable_graphs() if eager else contextlib.nullcontext():
            eng, comps = drive(is_twin)
        sync(torch)
        runs.append((eng, comps, time.perf_counter() - t0, serve.launch_counts()))
    (eng, comps, wall, counts), (other, twin_comps, twin_wall, twin_counts) = runs
    streams = sorted((c.request_id, c.generated, c.status) for c in comps)
    if streams != sorted((c.request_id, c.generated, c.status) for c in twin_comps):
        raise AssertionError(f"{label}: graphed and {twin} completions differ")
    for attr in attrs:
        if getattr(eng, attr) != getattr(other, attr):
            raise AssertionError(f"{label}: graphed and {twin} {attr} differ: "
                                 f"{getattr(eng, attr)} against {getattr(other, attr)}")
    for a, b_ in ((eng._cache.k, other._cache.k), (eng._cache.v, other._cache.v)):
        if not torch.equal(a[:, pool_from:], b_[:, pool_from:]):
            raise AssertionError(f"{label}: graphed and {twin} caches differ from block "
                                 f"{pool_from} on after the drain")
    scales = [(getattr(eng._cache, n), getattr(other._cache, n)) for n in ("k_scale", "v_scale")
              if getattr(eng._cache, n, None) is not None]
    if not all(torch.equal(a[:, pool_from:], b_[:, pool_from:]) for a, b_ in scales):
        raise AssertionError(f"{label}: graphed and {twin} pool scales differ from block "
                             f"{pool_from} on after the drain")
    if getattr(eng, "_d_cache", None) is not None and not all(
            torch.equal(a, b_) for a, b_ in zip(eng._d_cache, other._d_cache)):
        raise AssertionError(f"{label}: graphed and {twin} draft caches differ after the drain")
    if counts != twin_counts:
        raise AssertionError(f"{label}: launch counts differ: graphed {counts}, {twin} "
                             f"{twin_counts}")
    generated = sum(len(c.generated) for c in comps)
    log(f"{label}: {len(comps)} requests, {generated} tokens in {wall:.2f} s graphed "
        f"({generated / wall:.1f} tokens/s), {twin_wall:.2f} s {twin} ({generated / twin_wall:.1f} "
        f"tokens/s); {', '.join(f'{a} {getattr(eng, a)}' for a in attrs)}; graphed == {twin} "
        f"twin in completions, statuses, {', '.join(attrs)}, cache bytes"
        f"{' and scales' if scales else ''}{f' from block {pool_from}' if pool_from else ''}"
        f"{', draft cache bytes' if getattr(eng, '_d_cache', None) is not None else ''} "
        f"and launch counts")
    graph_bookkeeping(torch, label, eng)
    return eng, comps, counts


def _teacher_forced_all(torch, label, cfg, params, reqs, comps, cache_dtype, tol, by_id=None,
                        why=None):
    """Every completion teacher-forced against the plain dense path
    (``_teacher_forced``); ``reqs[request_id]`` unless ``by_id`` maps ids
    to requests; ``why`` the tolerance's reason (default ``TOL_WHY``'s for
    the cache's dtype).  Prints and returns the count of tokens that are
    the dense choice."""
    ref = _dense_reference(params)
    worst, hit, total = 0.0, 0, 0
    for c in comps:
        req = (by_id or reqs)[c.request_id]
        gap, h, n = _teacher_forced(torch, cfg, ref, req, c, cache_dtype, tol,
                                    tol / LIFECYCLE_TEMP)
        worst, hit, total = max(worst, gap), hit + h, total + n
    log(f"{label}: teacher-forced vs plain dense decode: {hit}/{total} tokens the dense choice, "
        f"worst gap {worst:.4g} (tolerance {tol} greedy, {tol / LIFECYCLE_TEMP:.4g} sampled: "
        f"{why or TOL_WHY[cache_dtype == torch.float32]})")
    return hit


def snapshot_lifecycle_drive(eng, reqs, *, cancel_after, pick_cancel, snapshot_after,
                             snapshot_parked=False, max_bursts=5000):
    """Admit ``reqs`` FIFO as capacity frees and burst-step in between;
    after burst ``cancel_after`` cancel the request ``pick_cancel(eng)``
    names; after burst ``snapshot_after`` take ``snapshot_active()`` as
    JSON, and with ``snapshot_parked`` again after the first burst that
    leaves requests parked.  Returns ``(completions, the cancelled id,
    {name: (JSON, ids done by then, the requests still queued then, entry
    kinds)})``."""
    from k8s_dra_driver_torch.models import serve

    queue, comps, cancelled, snaps = list(reqs), [], None, {}

    def snapshot(name):
        admitting = {eng._slots[a["slot"]].request_id for a in getattr(eng, "_admitting", ())}
        parked = {r["st"].request_id for r in getattr(eng, "_preempted", ())}
        text = json.dumps(eng.snapshot_active())
        kinds = {"resident": 0, "admitting": 0, "parked": 0}
        for entry in json.loads(text)["requests"]:
            rid = entry["request_id"]
            kinds["admitting" if rid in admitting else "parked" if rid in parked
                  else "resident"] += 1
        snaps[name] = (text, {c.request_id for c in comps}, list(queue), kinds)

    for burst in range(1, max_bursts + 1):
        while queue and eng.free_slots():
            try:
                eng.submit(**queue[0])
            except serve.NoCapacity:
                break
            queue.pop(0)
        eng.step_burst()
        if burst == cancel_after:
            cancelled = pick_cancel(eng)
            eng.cancel(cancelled)
        comps += eng.completions()
        if burst == snapshot_after:
            snapshot(f"after burst {burst}")
        if snapshot_parked and getattr(eng, "_preempted", ()) and "parked" not in snaps:
            snapshot("parked")
        if (not queue and eng.free_slots() == eng.n_slots
                and not getattr(eng, "_preempted", ())):
            return comps, cancelled, snaps
    raise AssertionError(f"the lifecycle run did not drain in {max_bursts} bursts")


def _without_traces(text: str) -> str:
    """A snapshot's JSON less each entry's telemetry trace: its stamps are
    the host clock's, so two runs of one schedule differ only there."""
    doc = json.loads(text)
    for entry in doc["requests"]:
        entry.pop("trace", None)
    return json.dumps(doc)


def _oldest_resident(eng):
    return min(st.request_id for st in eng._slots if st is not None)


def _newest_admitting(eng):
    """The newest request still admitting behind the queue's head."""
    return max(eng._slots[a["slot"]].request_id for a in eng._admitting[1:])


def dense_steady_decode(torch, cfg, params, cache_dtype, rounds=4, bursts=4):
    """Decode-only step time at batch 8: the dense engine eager and graphed
    and the paged engine graphed, each with the same 8 resident requests
    (prompt 128), after 3 warm-up bursts, in ``rounds`` alternating rounds
    of ``bursts`` 8-step bursts on the host clock; one profiled burst of
    each.  The dense step's bound reads every stored parameter byte and the
    whole ``[L, 8, max_seq, Hkv, hd]`` K and V, which its masked attention
    reads every step.  Fails if the graphed dense step is slower than the
    eager one."""
    from k8s_dra_driver_torch.models import serve
    from k8s_dra_driver_torch.models.quant import quantized_bytes

    r = np.random.RandomState(SEED + 7)
    prompts = [r.randint(0, cfg.vocab_size, size=128).tolist() for _ in range(8)]
    engines = {}
    for mode in ("dense eager", "dense graphed", "paged graphed"):
        eng = (_serving_engine(cfg, params, cache_dtype) if mode.startswith("paged")
               else _dense_engine(cfg, params, cache_dtype))
        with serve.disable_graphs() if mode.endswith("eager") else contextlib.nullcontext():
            for p in prompts:
                eng.submit(p, max_tokens=8 * (3 + rounds * bursts + 2))
            for _ in range(3):
                eng.step_burst()
        engines[mode] = eng
    times = {mode: [] for mode in engines}
    for _ in range(rounds):
        for mode, eng in engines.items():
            with serve.disable_graphs() if mode.endswith("eager") else contextlib.nullcontext():
                sync(torch)
                t0 = time.perf_counter()
                for _ in range(bursts):
                    eng.step_burst()
                sync(torch)
            times[mode].append((time.perf_counter() - t0) / (8 * bursts) * 1e3)
    itemsize = torch.empty((), dtype=cache_dtype).element_size()
    weights = quantized_bytes(params)[0]
    kv = 2 * cfg.n_layers * 8 * cfg.max_seq * cfg.kv_heads * cfg.head_dim * itemsize
    b_ms, _ = bound(weights + kv, 0, "bfloat16")
    med = {mode: float(np.median(t)) for mode, t in times.items()}
    for mode in engines:
        log(f"serve dense: steady decode B=8 ctx~{128 + 8 * 3 + 8 * rounds * bursts / 2:.0f}, "
            f"{mode}: {' / '.join(f'{t:.3f}' for t in times[mode])} ms per step by round "
            f"(median {med[mode]:.3f} ms, range {min(times[mode]):.3f}-{max(times[mode]):.3f})")
    log(f"serve dense: dense step bound {b_ms * 1e3:.1f} us ({weights / 1e6:.1f} MB parameters + "
        f"{kv / 1e6:.1f} MB of K and V, the whole cache); dense graphed / paged graphed "
        f"{med['dense graphed'] / med['paged graphed']:.3f}")
    dense = [engines[m] for m in ("dense eager", "dense graphed")]
    if [st.tokens for st in dense[0]._slots] != [st.tokens for st in dense[1]._slots]:
        raise AssertionError("serve dense: the eager and graphed steady streams differ")
    for mode, eng in engines.items():
        with serve.disable_graphs() if mode.endswith("eager") else contextlib.nullcontext():
            prof = profile_window(torch, f"serve dense: profile of one {mode} 8-step burst",
                                  eng.step_burst)
        if prof is not None:
            log(f"serve dense: {mode} burst: device busy {prof['busy_us'] / 8 / 1e3:.3f} ms per "
                f"step over {sum(r_[1] for r_ in prof['rows'])} kernels")
    if med["dense graphed"] > med["dense eager"]:
        raise AssertionError(f"serve dense: the graphed step ({med['dense graphed']:.3f} ms) is "
                             f"slower than the eager one ({med['dense eager']:.3f} ms)")


def phase_serve_dense(torch, cfg, params, reqs, *, cache_dtype, tol=0.25):
    """The dense ``ServeEngine`` at full width in six legs: the serving
    run's 16 requests graphed against an eager twin and teacher-forced; the
    prefix cache over two shared system prompts (against a prefix-off twin);
    the lifecycle (sampled requests, top-k 50, a cancel, a poisoned slot)
    graphed against eager, with a snapshot after burst 4 restored through
    JSON into a fresh engine; int4 block weights, both int4 kernels
    launching; steady decode beside the paged engine; shedding on a
    queue limit.  Returns the int4 launch counts of the int4 leg."""
    from k8s_dra_driver_torch.models import quant
    from k8s_dra_driver_torch.ops import int4_matmul as i4
    from k8s_dra_driver_torch.utils import faults

    label = "serve dense"
    bf16 = _greedy_dicts(reqs)

    def leg(name, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"{label}: leg {name}: {time.perf_counter() - t0:.1f} s")
        return out

    def bf16_leg():
        def drive(eager):
            eng = _dense_engine(cfg, params, cache_dtype)
            return eng, eng.pump(reqs)

        eng, comps, _ = _engine_twin(torch, f"{label} bf16", drive)
        short = [c.request_id for c in comps
                 if len(c.generated) != bf16[c.request_id]["max_tokens"]]
        if len(comps) != len(reqs) or short:
            raise AssertionError(f"{label} bf16: {len(comps)} completions, short {short}")
        _teacher_forced_all(torch, f"{label} bf16", cfg, params, bf16, comps, cache_dtype, tol)

    def prefix_leg():
        preqs = _dense_prefix_traffic(cfg.vocab_size, SEED + 13)
        eng = _dense_engine(cfg, params, cache_dtype, **DENSE_PREFIX)
        comps = eng.pump(preqs)
        off = _dense_engine(cfg, params, cache_dtype).pump(preqs)
        log(f"{label} prefix: prefix_hits {eng.prefix_hits}, prefix_misses {eng.prefix_misses} "
            f"(expected 14 / 2)")
        if (eng.prefix_hits, eng.prefix_misses) != (14, 2) or len(comps) != len(preqs):
            raise AssertionError(f"{label} prefix: hits/misses {eng.prefix_hits}/"
                                 f"{eng.prefix_misses}, {len(comps)} completions")
        graph_bookkeeping(torch, f"{label} prefix", eng)
        want = {c.request_id: c.generated for c in off}
        same = sum(c.generated == want[c.request_id] for c in comps)
        log(f"{label} prefix: streams equal to the prefix-off twin's: {same} of {len(comps)} "
            f"(reported, not required: cuBLAS may sum the suffix's M = 192 product in another "
            f"order than the full prefill's M = 256)")
        _teacher_forced_all(torch, f"{label} prefix", cfg, params, preqs, comps, cache_dtype, tol)

    def lifecycle_leg():
        lreqs = _lifecycle_traffic(cfg.vocab_size, SEED + 11)
        for r_ in lreqs:
            r_.pop("priority")
        snaps = []

        def drive(eager):
            inj = faults.FaultInjector(SEED)
            inj.arm(faults.FaultProfile(name="poison", **LIFECYCLE_POISON))
            eng = _dense_engine(cfg, params, cache_dtype, top_k=LIFECYCLE["top_k"],
                                fault_injector=inj)
            comps, cancelled, snap = snapshot_lifecycle_drive(
                eng, lreqs, cancel_after=3, pick_cancel=_oldest_resident,
                snapshot_after=DENSE_SNAPSHOT_AFTER)
            snaps.append((snap[f"after burst {DENSE_SNAPSHOT_AFTER}"][:3], cancelled))
            return eng, comps

        eng, comps, _ = _engine_twin(torch, f"{label} lifecycle", drive)
        (snap, cancelled), (twin_snap, _) = snaps
        statuses = {}
        for c in comps:
            statuses[c.status] = statuses.get(c.status, 0) + 1
        log(f"{label} lifecycle: statuses {statuses}; quarantined {eng.quarantined}; cancelled "
            f"{cancelled}")
        if (len(eng.quarantined) != 1 or statuses.get("cancelled") != 1
                or (_without_traces(snap[0]), *snap[1:]) != (_without_traces(twin_snap[0]),
                                                             *twin_snap[1:])):
            raise AssertionError(f"{label} lifecycle: want one quarantine, one cancel and equal "
                                 f"snapshots: {eng.quarantined}, {statuses}")
        _teacher_forced_all(torch, f"{label} lifecycle", cfg, params, lreqs, comps, cache_dtype,
                            tol)
        # the snapshot after burst 4, restored into a fresh engine that then
        # takes the requests still queued at that point
        text, done_before, queued = snap
        fresh = _dense_engine(cfg, params, cache_dtype, top_k=LIFECYCLE["top_k"])
        restored = fresh.restore(json.loads(text))
        rcomps = fresh.pump(queued)
        main = {c.request_id: c for c in comps}
        ids = sorted(c.request_id for c in rcomps)
        if ids != sorted(set(main) - done_before):
            raise AssertionError(f"{label} lifecycle restore: completions for {ids}")
        same = sum(c.generated == main[c.request_id].generated for c in rcomps)
        prefix = sum(main[c.request_id].status == "quarantined"
                     and c.generated[: len(main[c.request_id].generated)]
                     == main[c.request_id].generated for c in rcomps)
        log(f"{label} lifecycle restore: {len(restored)} requests restored from "
            f"{len(text)} bytes of JSON, {len(queued)} queued after them; streams equal to the "
            f"uninterrupted run's: {same} of {len(rcomps)} (the quarantined one, poisoned after "
            f"the snapshot, runs on: its uninterrupted stream a prefix of the restored one: "
            f"{prefix})")
        _teacher_forced_all(torch, f"{label} lifecycle restore", cfg, params, lreqs, rcomps,
                            cache_dtype, tol)

    def int4_leg():
        p4 = quant.quantize_blocks(params, bits=4)
        ireqs = bf16[:8]
        sync(torch)
        _zero_serving_counts()
        eng = _dense_engine(cfg, p4, cache_dtype)
        comps = eng.pump(ireqs)
        sync(torch)
        counts = {"int4_matmul": i4.kernel_launches["int4_splitk"],
                  "int4_matmul_prefill": i4.kernel_launches["int4_wgmma"]}
        log(f"{label} int4: launches on the dense path {counts} (split-K at M = 8 in steps, "
            f"bursts and first tokens; wgmma at M = 256 in admissions)")
        if not all(counts.values()) or len(comps) != len(ireqs):
            raise AssertionError(f"{label} int4: an int4 kernel was never launched: {counts}")
        graph_bookkeeping(torch, f"{label} int4", eng)
        _teacher_forced_all(torch, f"{label} int4", cfg, p4, ireqs, comps, cache_dtype, tol)
        return counts

    def shed_leg():
        eng = _dense_engine(cfg, params, cache_dtype)
        admitted = []
        submit = eng.submit

        def counted(*a, **k):
            admitted.append(a[0] if a else k["prompt"])
            return submit(*a, **k)

        eng.submit = counted
        comps = eng.pump(reqs, queue_limit=DENSE_QUEUE_LIMIT)
        shed = [c for c in comps if c.status == "shed"]
        want = len(reqs) - DENSE["n_slots"] - DENSE_QUEUE_LIMIT  # lengths alone decide it
        calls = eng.graphs["admission"].calls if "admission" in eng.graphs else len(admitted)
        log(f"{label} shed: queue_limit {DENSE_QUEUE_LIMIT} over {len(reqs)} requests: "
            f"shed_count {eng.shed_count} (the lengths decide it: {want}, what the CPU run of "
            f"this leg sheds), "
            f"{len(admitted)} admissions, admission program calls {calls}, retry-after "
            f"{eng.last_shed.retry_after_s if eng.last_shed else None} s")
        if eng.shed_count != want or len(shed) != want or calls != len(reqs) - want or any(
                c.tokens in admitted for c in shed):
            raise AssertionError(f"{label} shed: {eng.shed_count} shed, {calls} admissions")

    leg("bf16", bf16_leg)
    leg("prefix", prefix_leg)
    leg("lifecycle", lifecycle_leg)
    counts = leg("int4", int4_leg)
    leg("steady decode", lambda: dense_steady_decode(torch, cfg, params, cache_dtype))
    leg("shed", shed_leg)
    return counts


def _int4_recorder(torch, i4):
    """Wrap ``i4.int4_matmul`` to keep the first x of each product shape
    the path gives it (a program's first call runs eagerly, so every shape
    shows there).  Returns ``(inputs, restore)``."""
    inputs: dict = {}
    wrapper = i4.int4_matmul

    def recorded(x, packed, scale, group_size):
        shape = (x.numel() // x.shape[-1], x.shape[-1], packed.shape[1], x.dtype)
        if shape not in inputs and not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
            inputs[shape] = (x.reshape(-1, x.shape[-1]).clone(), packed, scale, group_size)
        return wrapper(x, packed, scale, group_size)

    i4.int4_matmul = recorded

    def restore():
        i4.int4_matmul = wrapper

    return inputs, restore


def _int4_by_program(eng, i4):
    """Wrap ``eng._run`` to count each int4 kernel's launches by program
    (a burst under its name less " k=K").  Returns the dict it fills."""
    by_program: dict = {}
    run = eng._run

    def counted(name, fn):
        before = dict(i4.kernel_launches)
        out = run(name, fn)
        got = by_program.setdefault(name.split(" k=")[0], dict.fromkeys(before, 0))
        for k in before:
            got[k] += i4.kernel_launches[k] - before[k]
        return out

    eng._run = counted
    return by_program


def _hold_int4_inputs(torch, label, i4, inputs):
    """Each recorded product shape's kernel against the plain version on
    the path's own x within ``INT4_STEP``.  Returns ``{kernel: [M, ...]}``."""
    kernels = set()
    for (m, k, n, dtype), (x, packed, scale, group) in sorted(
            inputs.items(), key=lambda item: item[0][:3]):
        dname = str(dtype).split(".")[-1]
        kern = i4.kernel_for(m, dtype)
        got = i4.int4_matmul(x, packed, scale, group)
        want = i4.int4_matmul_plain(x, packed, scale, group)
        err, limit, top, _, over = int4_check(x, packed, scale, got, want, INT4_STEP[dname][0])
        log(f"{label} M={m} K={k} N={n} {dname} ({kern}), the path's own x: max_abs_err "
            f"{err:.3g}, limit there {limit:.3g}, max|plain| {top:.3g}; elements over the "
            f"limit {over}")
        if over:
            raise AssertionError(f"{label}: {kern} disagrees with the plain version at "
                                 f"M={m} K={k} N={n}")
        kernels.add((kern, m))
    return {kern: sorted(m for kk, m in kernels if kk == kern) for kern, _ in kernels}


# the paged engine's admission phase: the serving engines' slots, bucket
# and burst; a 16-block prefix store and 4-block chunks
ADMISSION = dict(n_slots=8, block_size=16, prompt_bucket=256, sync_interval=8,
                 prefix_cache_blocks=16, prefill_chunk_blocks=4)
ADMISSION_POOL = 8 * 24 + 1   # every slot at 384 tokens: this traffic never stalls
ADMISSION_TIGHT = 73          # blocks, the null block included: about half the working set
ADMISSION_SNAPSHOT_AFTER = 4  # bursts
ADMISSION_CANCEL_AFTER = 2    # bursts: the newest request still admitting is cancelled
HEAD_OF_LINE_ROUNDS = 4       # arrivals per engine: the residents' 256 tokens outlast 4 rounds


def _admission_engine(cfg, params, cache_dtype, **kw):
    from k8s_dra_driver_torch.models.paged import PagedServeEngine

    kw = dict(ADMISSION, **kw)
    kw.setdefault("n_blocks", ADMISSION_POOL)
    return PagedServeEngine(params=params, cfg=cfg, cache_dtype=cache_dtype, device=DEV, **kw)


def _admission_lifecycle_traffic(vocab: int, seed: int, n: int = 16):
    """``n`` requests, each one of two seeded 64-token system prompts
    (alternating) and 16-96 tokens of its own, 64-128 new tokens; odd ones
    sampled at ``LIFECYCLE_TEMP`` with explicit seeds; priorities 0 and 1
    alternating by pairs."""
    r = np.random.RandomState(seed)
    systems = [r.randint(0, vocab, size=64).tolist() for _ in range(2)]
    reqs = []
    for i in range(n):
        req = dict(prompt=systems[i % 2] + r.randint(0, vocab, size=int(r.randint(16, 97))).tolist(),
                   max_tokens=int(r.randint(64, 129)), priority=(i // 2) % 2)
        if i % 2:
            req.update(temperature=LIFECYCLE_TEMP, seed=1000 + i)
        reqs.append(req)
    return reqs


def leak_audit(label, eng):
    """Nothing resident, admitting or parked: every block is free but the
    store's, and every live reference is a store entry's own."""
    store = eng._prefix_store
    refs = dict(eng._alloc._refs)
    ok = (eng.free_blocks == eng.n_blocks - 1 - len(store)
          and refs == {b: 1 for b in store.values()}
          and not eng._preempted and eng.free_slots() == eng.n_slots)
    log(f"{label}: leak audit: free blocks {eng.free_blocks} = {eng.n_blocks} - 1 - "
        f"{len(store)} stored: {ok}")
    if not ok:
        raise AssertionError(f"{label}: leak audit failed: free {eng.free_blocks}, store "
                             f"{len(store)}, references {len(refs)}")


def phase_serve_admission(torch, cfg, params, *, cache_dtype, tol=0.25):
    """Chunked admission and the prefix store in the paged engine at full
    width, in six legs: the prefix traffic graphed against an eager twin
    and teacher-forced; the same traffic with chunking, the store or both
    off; the head-of-line gap and time to first token of a 256-token
    arrival among 7 decoding residents, chunked and whole; the admission
    time with 0 and 15 cached blocks; the lifecycle on a tight pool
    (preemption of requests holding shared blocks, a cancel while
    admitting, snapshots restored through JSON, a leak audit); int4 block
    weights at 1-block chunks (the split-K kernel at M = 16)."""
    from k8s_dra_driver_torch.models import quant
    from k8s_dra_driver_torch.ops import int4_matmul as i4

    label = "serve bf16 admission"
    preqs = _dense_prefix_traffic(cfg.vocab_size, SEED + 13)

    def leg(name, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"{label}: leg {name}: {time.perf_counter() - t0:.1f} s")
        return out

    def graphed_leg():
        def drive(eager):
            eng = _admission_engine(cfg, params, cache_dtype)
            return eng, eng.pump(preqs)

        eng, comps, _ = _engine_twin(torch, f"{label} prefix+chunked", drive, PAGED_TWIN_ATTRS,
                                     pool_from=1)
        short = [c.request_id for c in comps if len(c.generated) != preqs[c.request_id]["max_tokens"]]
        if len(comps) != len(preqs) or short or eng.prefix_hits == 0:
            raise AssertionError(f"{label}: {len(comps)} completions, short {short}, "
                                 f"{eng.prefix_hits} hits")
        log(f"{label}: programs {sorted(eng.graphs)}, {len(eng.graphs)} of the bound "
            f"{eng.graph_bound}")
        leak_audit(label, eng)
        _teacher_forced_all(torch, label, cfg, params, preqs, comps, cache_dtype, tol)
        return {c.request_id: c.generated for c in comps}

    def features_off_leg(main):
        outs = {}
        for name, kw in (("chunking off", dict(prefill_chunk_blocks=0)),
                         ("prefixes off", dict(prefix_cache_blocks=0)),
                         ("both off", dict(prefill_chunk_blocks=0, prefix_cache_blocks=0))):
            eng = _admission_engine(cfg, params, cache_dtype, **kw)
            outs[name] = {c.request_id: c.generated for c in eng.pump(preqs)}
            log(f"{label} {name}: prefix hits / misses {eng.prefix_hits} / "
                f"{eng.prefix_misses}, {len(eng.graphs)} graphs of the bound {eng.graph_bound}")
        base = outs.pop("both off")
        for name, out in (("chunked with prefixes", main), *outs.items()):
            same = sum(out[rid] == base[rid] for rid in base)
            log(f"{label}: {name}: streams equal to the both-off engine's: {same} of "
                f"{len(base)} (reported, not required: a suffix or chunk product at another M "
                f"may take another cuBLAS order than the whole prefill at M = 256)")

    def head_of_line_leg(rounds=HEAD_OF_LINE_ROUNDS):
        """Per engine (4-block chunks, whole admission): each round times
        a burst alone, then a fresh 256-token arrival (no hit, one new
        token) among the 7 decoding residents: its time to first token
        and the residents' longest gap between bursts until then.  The
        engines alternate within each round, in turn first."""
        r = np.random.RandomState(SEED + 17)
        residents = [r.randint(0, cfg.vocab_size, size=32).tolist() for _ in range(7)]
        warm, *arrivals = (r.randint(0, cfg.vocab_size, size=256).tolist()
                           for _ in range(rounds + 1))
        engines = {}
        for chunk in (4, 0):
            eng = _admission_engine(cfg, params, cache_dtype, prefill_chunk_blocks=chunk)
            eng.submit(warm, max_tokens=1)  # builds and captures the arrival's programs
            for p in residents:
                eng.submit(p, max_tokens=256)
            while eng._admitting or eng.free_slots() != 1:
                eng.step_burst()
            for _ in range(2):  # the burst's second call captures it, out of the timed rounds
                eng.step_burst()
            activated = []
            advance = eng._advance_admission

            def timed(advance=advance, eng=eng, activated=activated):
                before = len(eng._admitting)
                advance()
                if before and not eng._admitting:
                    activated.append(time.perf_counter())  # its first token was read back

            eng._advance_admission = timed
            engines[chunk] = (eng, activated)
        out = {4: [], 0: []}
        for rnd, arrival in enumerate(arrivals):
            for chunk in ((4, 0) if rnd % 2 == 0 else (0, 4)):
                eng, activated = engines[chunk]
                activated.clear()
                sync(torch)
                ends = [time.perf_counter()]
                eng.step_burst()
                ends.append(time.perf_counter())
                t_sub = time.perf_counter()
                eng.submit(arrival, max_tokens=1)  # retires at its first token
                if not chunk:
                    activated.append(time.perf_counter())
                while not activated:
                    eng.step_burst()
                    ends.append(time.perf_counter())
                if len(ends) == 2:  # whole admission: the burst after it
                    eng.step_burst()
                    ends.append(time.perf_counter())
                if eng.free_slots() != 1:
                    raise AssertionError(f"{label} head-of-line: a resident finished in round "
                                         f"{rnd}: the rounds outlast the residents")
                gaps = np.diff(ends) * 1e3
                ttft = (activated[0] - t_sub) * 1e3
                out[chunk].append((ttft, float(gaps[1:].max()), float(gaps[0])))
                log(f"{label} head-of-line round {rnd}, prefill_chunk_blocks {chunk}: time to "
                    f"first token {ttft:.3f} ms; resident gaps {' / '.join(f'{g:.3f}' for g in gaps)} "
                    f"ms (a burst alone, then while it admits); longest gap less a burst alone "
                    f"{gaps[1:].max() - gaps[0]:.3f} ms")
        med = {}
        for chunk, rows in out.items():
            ttft, longest, alone = (np.array(col) for col in zip(*rows))
            med[chunk] = (float(np.median(ttft)), float(np.median(longest - alone)),
                          float(np.median(longest)), float(np.median(alone)))
            log(f"{label} head-of-line, prefill_chunk_blocks {chunk}, medians of {len(rows)} "
                f"arrivals: time to first token {med[chunk][0]:.3f} ms; the stall the admission "
                f"adds to the residents' longest gap {med[chunk][1]:.3f} ms (longest gap "
                f"{med[chunk][2]:.3f} ms, a burst alone {med[chunk][3]:.3f} ms)")
        log(f"{label} head-of-line: chunked / whole: time to first token "
            f"{med[4][0] / med[0][0]:.3f}; added stall {med[4][1] / med[0][1]:.3f}")

    def admission_cost_leg():
        r = np.random.RandomState(SEED + 19)
        eng = _admission_engine(cfg, params, cache_dtype, prefill_chunk_blocks=0)

        def admit(prompt):
            sync(torch)
            t0 = time.perf_counter()
            eng.submit(prompt, max_tokens=1)  # retires at its first token
            sync(torch)
            return (time.perf_counter() - t0) * 1e3

        fresh = [r.randint(0, cfg.vocab_size, size=256).tolist() for _ in range(7)]
        for p in fresh[:2]:
            admit(p)  # builds and captures the prefill program
        miss = [admit(p) for p in fresh[2:]]
        shared = r.randint(0, cfg.vocab_size, size=256).tolist()
        admit(shared)  # stores its 15 storable blocks
        hits_before = eng.prefix_hits
        for _ in range(2):
            admit(shared)  # builds and captures "chunk 16", the 16-token suffix
        hit = [admit(shared) for _ in range(5)]
        if eng.prefix_hits - hits_before != 7 * 15:  # each of the 7 ran "chunk 16"
            raise AssertionError(f"{label} admission: {eng.prefix_hits - hits_before} hits")
        log(f"{label} admission cost (256-token prompt, unchunked, graphed): no hit "
            f"{' / '.join(f'{t:.2f}' for t in miss)} ms (median {np.median(miss):.2f}); 15 "
            f"cached blocks, a 16-token suffix {' / '.join(f'{t:.2f}' for t in hit)} ms "
            f"(median {np.median(hit):.2f}); hit / miss {np.median(hit) / np.median(miss):.3f}")

    def lifecycle_leg():
        lreqs = _admission_lifecycle_traffic(cfg.vocab_size, SEED + 23)
        drives = []

        def drive(eager):
            eng = _admission_engine(cfg, params, cache_dtype, n_blocks=ADMISSION_TIGHT,
                                    top_k=LIFECYCLE["top_k"])
            comps, cancelled, snaps = snapshot_lifecycle_drive(
                eng, lreqs, cancel_after=ADMISSION_CANCEL_AFTER, pick_cancel=_newest_admitting,
                snapshot_after=ADMISSION_SNAPSHOT_AFTER, snapshot_parked=True)
            drives.append((cancelled, snaps))
            return eng, comps

        eng, comps, _ = _engine_twin(torch, f"{label} lifecycle", drive, PAGED_TWIN_ATTRS,
                                     pool_from=1)
        (cancelled, snaps), (_, twin_snaps) = drives
        if ({k: _without_traces(v[0]) for k, v in snaps.items()}
                != {k: _without_traces(v[0]) for k, v in twin_snaps.items()}):
            raise AssertionError(f"{label} lifecycle: graphed and eager snapshots differ")
        statuses = {}
        for c in comps:
            statuses[c.status] = statuses.get(c.status, 0) + 1
        main = {c.request_id: c for c in comps}
        log(f"{label} lifecycle: pool {ADMISSION_TIGHT} blocks (null block included), "
            f"{len(lreqs)} requests, statuses {statuses}; preempted_count "
            f"{eng.preempted_count}; request {cancelled} cancelled while admitting "
            f"({len(main[cancelled].generated)} tokens)")
        kinds = {name: snap[3] for name, snap in snaps.items()}
        log(f"{label} lifecycle: snapshot entries by kind {kinds}")
        if (eng.preempted_count < 1 or statuses.get("cancelled") != 1
                or main[cancelled].generated or len(comps) != len(lreqs)
                or set(snaps) != {"after burst 4", "parked"}
                or not (kinds["after burst 4"]["resident"] and kinds["after burst 4"]["admitting"])
                or not kinds["parked"]["parked"]):
            raise AssertionError(f"{label} lifecycle: want preemptions, one cancel while "
                                 f"admitting, and snapshots holding resident, admitting and "
                                 f"parked entries: {eng.preempted_count}, {statuses}, {kinds}")
        leak_audit(f"{label} lifecycle", eng)
        _teacher_forced_all(torch, f"{label} lifecycle", cfg, params, lreqs,
                            [c for c in comps if c.generated], cache_dtype, tol)
        del eng
        # each snapshot restored through JSON into a fresh engine, which then
        # takes the requests still queued at that point
        for name, (text, done_before, queued, _) in snaps.items():
            fresh = _admission_engine(cfg, params, cache_dtype, n_blocks=ADMISSION_TIGHT,
                                      top_k=LIFECYCLE["top_k"])
            restored = fresh.restore(json.loads(text))
            rcomps = fresh.pump(queued)
            ids = sorted(c.request_id for c in rcomps)
            if ids != sorted(set(main) - done_before):
                raise AssertionError(f"{label} lifecycle restore {name}: completions for {ids}")
            same = sum(c.generated == main[c.request_id].generated for c in rcomps)
            log(f"{label} lifecycle restore ({name}): {len(restored)} requests restored from "
                f"{len(text)} bytes of JSON, {len(queued)} queued after them; streams equal to "
                f"the uninterrupted run's: {same} of {len(rcomps)} (the rest held "
                f"teacher-forced: a re-prefill at another M may move a near tie)")
            leak_audit(f"{label} lifecycle restore ({name})", fresh)
            _teacher_forced_all(torch, f"{label} lifecycle restore ({name})", cfg, params, lreqs,
                                rcomps, cache_dtype, tol)

    def int4_leg():
        p4 = quant.quantize_blocks(params, bits=4)
        ireqs = preqs[:6]
        inputs, restore = _int4_recorder(torch, i4)
        try:
            sync(torch)
            _zero_serving_counts()
            eng = _admission_engine(cfg, p4, cache_dtype, prefill_chunk_blocks=1)
            by_program = _int4_by_program(eng, i4)
            comps = eng.pump(ireqs)
            sync(torch)
            splitk = i4.kernel_launches["int4_splitk"]
            log(f"{label} int4 (prefill_chunk_blocks 1): launches by program {by_program}")
            chunk16 = by_program.get("chunk 16", {})
            if not chunk16.get("int4_splitk") or chunk16.get("int4_wgmma") or len(comps) != 6:
                raise AssertionError(f"{label} int4: the 16-token chunks did not go through "
                                     f"int4_splitk alone: {by_program}")
            graph_bookkeeping(torch, f"{label} int4", eng)
            _zero_serving_counts()
            whole = _admission_engine(cfg, p4, cache_dtype, prefill_chunk_blocks=0)
            wcomps = whole.pump(ireqs)
            sync(torch)
            wcounts = dict(i4.kernel_launches)
        finally:
            restore()
        _teacher_forced_all(torch, f"{label} int4", cfg, p4, ireqs, comps, cache_dtype, tol)
        log(f"{label} int4 unchunked twin (suffixes after the stored system prompt, whole "
            f"prefills): launches {wcounts}")
        if not wcounts["int4_wgmma"]:
            raise AssertionError(f"{label} int4: int4_wgmma never launched: {wcounts}")
        _teacher_forced_all(torch, f"{label} int4 unchunked", cfg, p4, ireqs, wcomps,
                            cache_dtype, tol)
        log(f"{label} int4: int4_splitk launches at M = 16 (the chunks) "
            f"{chunk16['int4_splitk']}, of {splitk} on the chunked path; "
            f"int4_wgmma {wcounts['int4_wgmma']} on the unchunked twin")
        ms = _hold_int4_inputs(torch, f"{label} int4", i4, inputs)
        log(f"{label} int4: {len(inputs)} product shapes of the path held against the plain "
            f"version elementwise (INT4_STEP); M by kernel {ms}")
        if 16 not in ms.get("int4_splitk", ()) or not ms.get("int4_wgmma"):
            raise AssertionError(f"{label} int4: the path's shapes missed a kernel: {ms}")

    main_streams = leg("graphed", graphed_leg)
    leg("features off", lambda: features_off_leg(main_streams))
    leg("head-of-line", head_of_line_leg)
    leg("admission cost", admission_cost_leg)
    leg("lifecycle", lifecycle_leg)
    leg("int4", int4_leg)


# speculative serving: the serving engines' slots, block and bucket, a
# verify window of 5 (4 draft tokens and the bonus)
SPEC = dict(n_slots=8, block_size=16, prompt_bucket=256, sync_interval=8, spec_gamma=4)
SPEC_TIGHT = 73               # blocks, the null block included, for the lifecycle
SPEC_SNAPSHOT_AFTER = 4       # rounds
SPEC_TIMING_ROUNDS = 4        # alternating rounds of the timing leg
SPEC_DECODE = dict(batch=8, prompt=128, steps=64)  # the offline speculative_decode


def _spec_engine(cfg, params, cache_dtype, **kw):
    from k8s_dra_driver_torch.models.paged import PagedServeEngine

    kw = dict(SPEC, **kw)
    kw.setdefault("n_blocks", 8 * 24 + 1)  # every slot at 384 tokens: no stall
    return PagedServeEngine(params=params, cfg=cfg, cache_dtype=cache_dtype, device=DEV, **kw)


def _spec_lifecycle_traffic(vocab: int, seed: int, n: int = 16):
    """The admission phase's lifecycle traffic, greedy (speculation
    verifies the argmax): two 64-token system prompts, priorities 0 and 1
    by pairs."""
    reqs = _admission_lifecycle_traffic(vocab, seed, n)
    for r_ in reqs:
        r_.pop("temperature", None)
        r_.pop("seed", None)
    return reqs


def _split_round(torch, label, eng):
    """Device time of one eager round of ``eng`` and of its two parts run
    alone on the state it leaves (each writes only positions the next
    round rewrites from the committed frontier): the draft's proposals
    and the verify pass; the rest (the tail and the state writes) is the
    round less both.  Kernel time summed over device events, as
    ``profile_window`` sums it.  Returns ``(draft, verify, rest)`` in us,
    or None without device events."""
    from k8s_dra_driver_torch.models import paged, serve

    def busy(fn):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
            sync(torch)
        return out, sum(getattr(ev, "self_device_time_total", 0) for ev in prof.key_averages()
                        if ev.device_type == DeviceType.CUDA)

    try:
        gamma, cfg = eng.spec_gamma, eng.cfg
        with serve.disable_graphs():
            _, round_us = busy(eng.step)
            pos = eng._pos.clamp(max=cfg.max_seq - 1 - gamma)
            (_, proposed), draft_us = busy(lambda: serve.draft_propose(
                eng.draft_params, eng._d_cache, eng._last, pos, eng._active, cfg=cfg,
                gamma=gamma))
            window = torch.cat([eng._last[:, None], proposed], dim=1)
            _, verify_us = busy(lambda: paged.paged_decode_chunk(
                eng.params, eng._cache, eng._table, window, pos, cfg=cfg, active=eng._active))
        if round_us <= 0:
            log(f"{label}: the profile holds no device events")
            return None
        rest = round_us - draft_us - verify_us
        log(f"{label}: one eager round, device time {round_us:.0f} us; alone, the draft's "
            f"{gamma} steps and priming step {draft_us:.0f} us ({draft_us / round_us:.3f}), the "
            f"verify pass {verify_us:.0f} us ({verify_us / round_us:.3f}); the rest "
            f"{rest:.0f} us ({rest / round_us:.3f})")
        return draft_us, verify_us, rest
    except Exception as exc:  # the profiler is a reading aid, not a check
        log(f"{label}: split profile not taken: {type(exc).__name__}: {exc}")
        return None


def _record_append_windows(torch, pa, nq: int, pools=()):
    """Wrap the append wrapper to keep, per layer, the first window of
    ``nq`` queries the path gives it (q, new k/v, the layer's pools before
    the write, table, pos, write mask), outside any capture; with ``pools``
    (engines' K pools) only a window writing into one of them.  Returns
    ``(records by layer, restore)``."""
    rec: dict = {}
    wrapper = pa.paged_append_attention

    def recording(q, new_k, new_v, k_pools, v_pools, block_table, pos, layer, write_mask=None):
        if (q.shape[1] == nq and layer not in rec
                and (not pools or any(k_pools.data_ptr() == p.data_ptr() for p in pools))
                and not (q.is_cuda and torch.cuda.is_current_stream_capturing())):
            rec[layer] = tuple(None if t is None else t.clone() for t in (
                q, new_k, new_v, k_pools[layer], v_pools[layer], block_table, pos, write_mask))
        return wrapper(q, new_k, new_v, k_pools, v_pools, block_table, pos, layer,
                       write_mask=write_mask)

    pa.paged_append_attention = recording

    def restore():
        pa.paged_append_attention = wrapper

    return rec, restore


def _hold_append_windows(torch, label, pa, rec, cfg, cache_dtype):
    """The append kernel on each recorded window (:func:`_record_append_windows`)
    against its plain version, layer by layer: output within ``paged_check``'s
    limits, written pool pages equal from block 1."""
    dname = str(cache_dtype).split(".")[-1]
    step, cap, _ = PAGED_STEP[dname]
    worst, nq = 0.0, None
    if sorted(rec) != list(range(cfg.n_layers)):
        raise AssertionError(f"{label}: windows recorded for layers {sorted(rec)}")
    for layer, (q, nk, nv, kp, vp, table, pos, wm) in sorted(rec.items()):
        nq = q.shape[1]
        k1, v1, k2, v2 = kp[None].clone(), vp[None].clone(), kp[None].clone(), vp[None].clone()
        got, _, _ = pa.paged_append_attention(q, nk, nv, k1, v1, table, pos, 0, write_mask=wm)
        want_out = pa.paged_append_attention_plain(q, nk, nv, k2, v2, table, pos, 0,
                                                   write_mask=wm)
        mag = pa.paged_append_attention_plain(
            q.float(), nk.float(), nv.float().abs(), kp[None].float(),
            vp[None].float().abs(), table, pos, 0, write_mask=wm)
        err, limit, top, over = paged_check(got, want_out, mag, step, cap)
        pages = torch.equal(k1[:, 1:], k2[:, 1:]) and torch.equal(v1[:, 1:], v2[:, 1:])
        worst = max(worst, err)
        if layer in (0, cfg.n_layers - 1):
            log(f"{label}: layer {layer} window: nq {nq}, q {tuple(q.shape)}, pools "
                f"{tuple(kp.shape)}, table {tuple(table.shape)}, pos {pos.tolist()}, write mask "
                f"{None if wm is None else wm.tolist()}")
        if over or not pages:
            raise AssertionError(f"{label}: the append kernel at nq {nq} disagrees with its "
                                 f"plain version in layer {layer}: {over} elements over the "
                                 f"limit, written pages equal {pages}")
    log(f"{label}: the append kernel at nq {nq} on the path's own inputs, {len(rec)} layers: "
        f"worst max_abs_err {worst:.4g} (paged_check limits, {dname}); written pool pages "
        f"equal the plain version's from block 1")
    return worst


def phase_serve_spec(torch, cfg, params, reqs, *, cache_dtype, tol=0.25):
    """Speculative serving at full width (``spec_gamma`` 4, the int8
    self-draft unless a leg says otherwise), in six legs: the serving run's
    16 requests through the paged engine graphed (the main path) against an
    eager twin, counted against the plain graphed engine's streams and
    teacher-forced, with the append kernel held against its plain version
    on the first verify window's own inputs (nq 5) in every layer; int4
    target and self-draft (``int4_splitk`` at M 8 in the draft,
    ``int4_wgmma`` at M 40 in the verify pass), each product shape held on
    its own x; the dense engine graphed against eager and
    ``speculative_decode`` at batch 8 against ``greedy_decode``; the
    prefix store and 4-block chunks with speculation, graphed against
    eager, and a lifecycle on a tight pool with a snapshot restored; the
    round's time beside the plain step's.  Returns the graphed main run's
    launch counts."""
    from k8s_dra_driver_torch.models import decode, quant, serve, speculative
    from k8s_dra_driver_torch.ops import int4_matmul as i4
    from k8s_dra_driver_torch.ops import paged_attention as pa

    label = "serve bf16 spec"
    gamma = SPEC["spec_gamma"]
    greedy = _greedy_dicts(reqs)
    out: dict = {}

    def leg(name, fn):
        t0 = time.perf_counter()
        res = fn()
        log(f"{label}: leg {name}: {time.perf_counter() - t0:.1f} s")
        return res

    def main_leg():
        def drive(eager):
            eng = _spec_engine(cfg, params, cache_dtype)
            return eng, eng.pump(reqs)

        rec, restore = _record_append_windows(torch, pa, gamma + 1)
        try:
            eng, comps, counts = _engine_twin(torch, label, drive, PAGED_TWIN_ATTRS, pool_from=1)
        finally:
            restore()
        short = [c.request_id for c in comps
                 if len(c.generated) != greedy[c.request_id]["max_tokens"]]
        if len(comps) != len(reqs) or short:
            raise AssertionError(f"{label}: {len(comps)} completions, short {short}")
        generated = sum(len(c.generated) for c in comps)
        log(f"{label}: {eng.host_syncs} rounds for {generated} tokens; acceptance "
            f"{eng.spec_accepted / max(eng.spec_drafted, 1):.4f} ({eng.spec_accepted} of "
            f"{eng.spec_drafted} drafted); graphs {sorted(eng.graphs)} within the bound "
            f"{eng.graph_bound}")
        plain = _serving_engine(cfg, params, cache_dtype)
        want = {c.request_id: c.generated for c in plain.pump(reqs)}
        same = sum(c.generated == want[c.request_id] for c in comps)
        log(f"{label}: streams equal to the plain graphed paged engine's: {same} of {len(comps)} "
            f"(reported, not required: the verify products run at M = 40, not 8, and cuBLAS may "
            f"take other kernels, so a near tie may flip; every token is held teacher-forced)")
        _teacher_forced_all(torch, label, cfg, params, greedy, comps, cache_dtype, tol)
        _hold_append_windows(torch, label, pa, rec, cfg, cache_dtype)
        out["counts"] = counts

    def int4_leg():
        p4 = quant.quantize_blocks(params, bits=4)
        ireqs = reqs[:6]
        inputs, restore = _int4_recorder(torch, i4)
        try:
            sync(torch)
            _zero_serving_counts()
            eng = _spec_engine(cfg, p4, cache_dtype, draft_params=p4)
            by_program = _int4_by_program(eng, i4)
            comps = eng.pump(ireqs)
            sync(torch)
        finally:
            restore()
        log(f"{label} int4 (int4 target and int4 self-draft): launches by program {by_program}")
        rnd = by_program.get("spec round", {})
        if not rnd.get("int4_splitk") or not rnd.get("int4_wgmma") or len(comps) != len(ireqs):
            raise AssertionError(f"{label} int4: the round did not launch both kernels: "
                                 f"{by_program}")
        graph_bookkeeping(torch, f"{label} int4", eng)
        _teacher_forced_all(torch, f"{label} int4", cfg, p4, _greedy_dicts(ireqs), comps,
                            cache_dtype, tol)
        ms = _hold_int4_inputs(torch, f"{label} int4", i4, inputs)
        log(f"{label} int4: {len(inputs)} product shapes of the path held against the plain "
            f"version elementwise (INT4_STEP); M by kernel {ms}")
        if 8 not in ms.get("int4_splitk", ()) or 8 * (gamma + 1) not in ms.get("int4_wgmma", ()):
            raise AssertionError(f"{label} int4: want the draft at M = 8 through int4_splitk and "
                                 f"the verify pass at M = {8 * (gamma + 1)} through int4_wgmma: "
                                 f"{ms}")

    def dense_leg():
        def drive(eager):
            eng = _dense_engine(cfg, params, cache_dtype, spec_gamma=gamma)
            return eng, eng.pump(reqs)

        eng, comps, _ = _engine_twin(torch, f"{label} dense", drive)
        short = [c.request_id for c in comps
                 if len(c.generated) != greedy[c.request_id]["max_tokens"]]
        if len(comps) != len(reqs) or short:
            raise AssertionError(f"{label} dense: {len(comps)} completions, short {short}")
        log(f"{label} dense: {eng.host_syncs} rounds; acceptance "
            f"{eng.spec_accepted / max(eng.spec_drafted, 1):.4f}")
        _teacher_forced_all(torch, f"{label} dense", cfg, params, greedy, comps, cache_dtype, tol)
        # the offline speculative_decode at batch 8 against greedy_decode
        r = np.random.RandomState(SEED + 29)
        b, plen, steps = SPEC_DECODE["batch"], SPEC_DECODE["prompt"], SPEC_DECODE["steps"]
        prompt = torch.from_numpy(r.randint(0, cfg.vocab_size, size=(b, plen))).to(DEV)
        draft = quant.quantize_blocks(params)
        sync(torch)
        t0 = time.perf_counter()
        toks, stats = speculative.speculative_decode(params, draft, prompt, steps, cfg,
                                                     gamma=gamma, cache_dtype=cache_dtype,
                                                     return_stats=True, device=DEV)
        sync(torch)
        spec_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = decode.greedy_decode(params, prompt, steps, cfg, cache_dtype=cache_dtype,
                                    batch_prefill=True, device=DEV)
        sync(torch)
        greedy_s = time.perf_counter() - t0
        if tuple(toks.shape) != (b, plen + steps) or not torch.equal(toks[:, :plen], prompt):
            raise AssertionError(f"{label} speculative_decode: shape {tuple(toks.shape)}")
        rows = [serve.Completion(request_id=i, tokens=toks[i].tolist(),
                                 generated=toks[i, plen:].tolist()) for i in range(b)]
        by_id = {i: dict(prompt=prompt[i].tolist(), max_tokens=steps) for i in range(b)}
        _teacher_forced_all(torch, f"{label} speculative_decode", cfg, params, None, rows,
                            cache_dtype, tol, by_id=by_id)
        same = int((toks == want).all(dim=1).sum())
        log(f"{label} speculative_decode B={b}, prompt {plen}, {steps} steps, gamma {gamma}: "
            f"rows equal to greedy_decode's {same} of {b} (reported: another M, near ties); "
            f"rounds {int(stats.rounds)}, acceptance {float(stats.acceptance):.4f}, tokens per "
            f"round {float(stats.tokens_per_round):.3f} (batch-summed); {spec_s:.3f} s "
            f"(first call eager, then one capture) against greedy_decode {greedy_s:.3f} s eager")

    def composition_leg():
        preqs = _dense_prefix_traffic(cfg.vocab_size, SEED + 13)

        def drive(eager):
            eng = _admission_engine(cfg, params, cache_dtype, spec_gamma=gamma)
            return eng, eng.pump(preqs)

        eng, comps, _ = _engine_twin(torch, f"{label} prefix+chunked", drive, PAGED_TWIN_ATTRS,
                                     pool_from=1)
        if len(comps) != len(preqs) or eng.prefix_hits == 0:
            raise AssertionError(f"{label} prefix+chunked: {len(comps)} completions, "
                                 f"{eng.prefix_hits} hits")
        log(f"{label} prefix+chunked: graphs {sorted(eng.graphs)}, {len(eng.graphs)} of the "
            f"bound {eng.graph_bound}")
        leak_audit(f"{label} prefix+chunked", eng)
        _teacher_forced_all(torch, f"{label} prefix+chunked", cfg, params, preqs, comps,
                            cache_dtype, tol)
        lreqs = _spec_lifecycle_traffic(cfg.vocab_size, SEED + 23)
        eng = _admission_engine(cfg, params, cache_dtype, spec_gamma=gamma, n_blocks=SPEC_TIGHT)
        comps, _, snaps = snapshot_lifecycle_drive(eng, lreqs, cancel_after=None,
                                                   pick_cancel=None,
                                                   snapshot_after=SPEC_SNAPSHOT_AFTER)
        main = {c.request_id: c for c in comps}
        text, done_before, queued, kinds = snaps[f"after burst {SPEC_SNAPSHOT_AFTER}"]
        log(f"{label} lifecycle: pool {SPEC_TIGHT} blocks (null block included), {len(lreqs)} "
            f"requests, preempted_count {eng.preempted_count}, stalled_steps "
            f"{eng.stalled_steps}; snapshot after round {SPEC_SNAPSHOT_AFTER}: {kinds}")
        if (eng.preempted_count < 1 or len(comps) != len(lreqs)
                or any(c.status != "ok" for c in comps)):
            raise AssertionError(f"{label} lifecycle: want preemptions and every request ok: "
                                 f"{eng.preempted_count}, {[c.status for c in comps]}")
        leak_audit(f"{label} lifecycle", eng)
        _teacher_forced_all(torch, f"{label} lifecycle", cfg, params, lreqs, comps, cache_dtype,
                            tol)
        fresh = _admission_engine(cfg, params, cache_dtype, spec_gamma=gamma,
                                  n_blocks=SPEC_TIGHT)
        restored = fresh.restore(json.loads(text))
        rcomps = fresh.pump(queued)
        ids = sorted(c.request_id for c in rcomps)
        if ids != sorted(set(main) - done_before):
            raise AssertionError(f"{label} lifecycle restore: completions for {ids}")
        same = sum(c.generated == main[c.request_id].generated for c in rcomps)
        log(f"{label} lifecycle restore: {len(restored)} requests restored from {len(text)} "
            f"bytes of JSON, {len(queued)} queued after them; streams equal to the "
            f"uninterrupted run's: {same} of {len(rcomps)} (reported, not required)")
        leak_audit(f"{label} lifecycle restore", fresh)
        _teacher_forced_all(torch, f"{label} lifecycle restore", cfg, params, lreqs, rcomps,
                            cache_dtype, tol)

    def timing_leg(rounds=SPEC_TIMING_ROUNDS, bursts=4, spec_rounds=8):
        """Three engines with the same 8 resident requests (prompt 128):
        the plain graphed paged engine (``bursts`` 8-step bursts a window),
        speculation with the int8 self-draft and with the target's first 2
        layers as the draft (``spec_rounds`` rounds a window), after warm-up
        (capture included), in alternating windows on the host clock."""
        r = np.random.RandomState(SEED + 7)
        prompts = [r.randint(0, cfg.vocab_size, size=128).tolist() for _ in range(8)]
        shallow = dict(params, blocks=params["blocks"][:2])
        engines = {
            "plain": _serving_engine(cfg, params, cache_dtype),
            "spec int8 self-draft": _spec_engine(cfg, params, cache_dtype),
            "spec 2-layer draft": _spec_engine(cfg, params, cache_dtype, draft_params=shallow),
        }
        for name, eng in engines.items():
            for p in prompts:
                eng.submit(p, max_tokens=600)
            for _ in range(3):
                eng.step_burst()
        rows = {name: [] for name in engines}
        for rnd in range(rounds):
            order = list(engines) if rnd % 2 == 0 else list(reversed(engines))
            for name in order:
                eng = engines[name]
                n = bursts if name == "plain" else spec_rounds
                before = (sum(len(st.tokens) for st in eng._slots), eng.spec_drafted,
                          eng.spec_accepted)
                sync(torch)
                t0 = time.perf_counter()
                for _ in range(n):
                    eng.step_burst()
                sync(torch)
                ms = (time.perf_counter() - t0) * 1e3
                committed = sum(len(st.tokens) for st in eng._slots) - before[0]
                rows[name].append((ms, n, committed, eng.spec_drafted - before[1],
                                   eng.spec_accepted - before[2]))
        med = {}
        for name, rs in rows.items():
            if name == "plain":
                per_step = [ms / (n * 8) for ms, n, *_ in rs]
                med[name] = float(np.median(per_step))
                log(f"{label} timing, plain graphed paged engine: "
                    f"{' / '.join(f'{t:.3f}' for t in per_step)} ms per step by window (median "
                    f"{med[name]:.3f}); each step commits one token a row")
                continue
            per_round = [ms / n for ms, n, *_ in rs]
            per_row_round = [c / (n * 8) for _, n, c, *_ in rs]
            per_token = [ms / (c / 8) for ms, _, c, *_ in rs]
            acc = sum(a for *_, a in rs) / max(sum(d for *_, d, _ in rs), 1)
            med[name] = float(np.median(per_token))
            log(f"{label} timing, {name}: {' / '.join(f'{t:.3f}' for t in per_round)} ms per "
                f"round by window (median {np.median(per_round):.3f}); tokens committed a row "
                f"per round {' / '.join(f'{t:.3f}' for t in per_row_round)} (median "
                f"{np.median(per_row_round):.3f}); acceptance {acc:.4f}; ms per committed token "
                f"a row {' / '.join(f'{t:.3f}' for t in per_token)} (median {med[name]:.3f}); "
                f"against the plain step {med[name] / med['plain']:.3f}x")
        ctx = {name: int(np.mean([len(st.tokens) for st in eng._slots]))
               for name, eng in engines.items()}
        log(f"{label} timing: mean context at the end {ctx}")
        draft_costs(engines["spec int8 self-draft"], ctx["spec int8 self-draft"])
        for name, eng in engines.items():
            prof = profile_window(torch, f"{label} timing: profile of one graphed "
                                  f"{'8-step burst' if name == 'plain' else 'round'}, {name}",
                                  eng.step_burst, watch=("paged_attention",))
            if prof is not None:
                log(f"{label} timing, {name}: device busy {prof['busy_us'] / 1e3:.3f} ms over "
                    f"{sum(r_[1] for r_ in prof['rows'])} kernels")
            if name != "plain":
                _split_round(torch, f"{label} timing, {name}", eng)

    def draft_costs(eng, context):
        """Two costs of every int8 draft step, each by CUDA events (L2
        flushed) beside its bound: dequantizing the draft's block matrices
        (``quant.mat``, as ``matmul_last`` does on every call) and the
        dense masked attention over the draft cache, every layer."""
        timer = Timer(torch)
        mats = [w for blk in eng.draft_params["blocks"] for w in blk.values()
                if isinstance(w, quant.QuantizedMatrix)]
        deq_ms = timer.ms(lambda: [quant.mat(w) for w in mats])
        n = sum(w.q.numel() for w in mats)
        deq_bound, _ = bound(n + 4 * sum(w.scale.numel() for w in mats) + 2 * n, n, "bfloat16")
        k, v = eng._d_cache
        q = torch.randn((8, 1, cfg.n_heads, cfg.head_dim), device=DEV).to(cache_dtype)
        pos = torch.full((8, 1), context, device=DEV)
        mask = (torch.arange(k.shape[2], device=DEV)[None, None, :] <= pos[:, :, None])[:, None]
        attn_ms = timer.ms(lambda: [decode._masked_attention(q, k[li], v[li], mask)
                                    for li in range(k.shape[0])])
        kv = 2 * k[:, :8].numel() * k.element_size()
        attn_bound, _ = bound(kv, 4 * 8 * cfg.n_heads * cfg.head_dim * k.shape[2] * k.shape[0],
                              "bfloat16")
        log(f"{label} timing: int8 draft step costs: dequantizing its {len(mats)} block "
            f"matrices ({n / 1e6:.1f} M weights) {deq_ms:.3f} ms (bound {deq_bound * 1e3:.1f} "
            f"us: int8 and scales read, bf16 written); the dense masked attention over the "
            f"draft cache [{k.shape[0]} layers, 8, {k.shape[2]}, {cfg.kv_heads}, "
            f"{cfg.head_dim}] at context {context} {attn_ms:.3f} ms (bound {attn_bound * 1e3:.1f} "
            f"us: the whole K and V read)")

    leg("main", main_leg)
    leg("int4", int4_leg)
    leg("dense", dense_leg)
    leg("composition", composition_leg)
    leg("timing", timing_leg)
    return {"paged_attention": out["counts"][(pa.__name__, "append")]}


# the telemetry phase: the lifecycle engine's geometry and traffic, a pool
# that preempts, a cancel, a poisoned slot and a queue limit that sheds
TELEMETRY_QUEUE_LIMIT = 6     # requests left waiting after each admission round
TELEMETRY_CANCEL_AFTER = 3    # bursts
TELEMETRY_TIMING_ROUNDS = 4   # alternating rounds of 4 graphed 8-step bursts
# EngineStats fields an engine keeps itself, so a telemetry-off twin reports them too
ENGINE_STATS = ("n_slots", "resident_slots", "free_slots", "queue_depth", "admitting",
                "preempted", "free_blocks", "quarantined", "shed_count", "host_syncs",
                "sync_interval")


def _check_traces(label, eng, comps, n_requests):
    """The telemetry-on engine's account of a drained run: ``completed`` is
    every request that was not shed and the statuses sum to all of them;
    ``tokens_generated`` counts the tokens committed in bursts, i.e. every
    generated token less each activation's first one; every activated
    trace runs ``queued_at <= submitted_at <= admitted_at ==
    first_token_at <= retired_at`` and its bursts' tokens sum to its
    ``generated - 1``.  Returns the stats."""
    st = eng.stats()
    sheds = st.statuses.get("shed", 0)
    if sum(st.statuses.values()) != n_requests or st.completed != n_requests - sheds:
        raise AssertionError(f"{label}: statuses {st.statuses}, completed {st.completed} for "
                             f"{n_requests} requests")
    activated, bursts = 0, 0
    for c in comps:
        if c.request_id < 0:
            continue
        tr = eng.telemetry.trace(c.request_id)
        if tr is None or tr["status"] != c.status or tr["generated"] != len(c.generated):
            raise AssertionError(f"{label}: request {c.request_id}'s trace {tr} does not "
                                 f"match its completion ({c.status}, {len(c.generated)})")
        if tr["first_token_at"] is None:
            continue  # cancelled while admitting
        activated += 1
        bursts += len(tr["bursts"])
        if not (tr["queued_at"] <= tr["submitted_at"] <= tr["admitted_at"]
                == tr["first_token_at"] <= tr["retired_at"]):
            raise AssertionError(f"{label}: request {c.request_id}'s timeline is out of "
                                 f"order: {tr}")
        if not tr["bursts_dropped"] and sum(b["tokens"] for b in tr["bursts"]) != tr["generated"] - 1:
            raise AssertionError(f"{label}: request {c.request_id}'s bursts do not sum to its "
                                 f"generated tokens less the first")
    generated = sum(len(c.generated) for c in comps)
    if st.tokens_generated != generated - activated:
        raise AssertionError(f"{label}: tokens_generated {st.tokens_generated}, want "
                             f"{generated} generated less {activated} first tokens")
    log(f"{label}: stats: completed {st.completed}, statuses {st.statuses}, tokens_generated "
        f"{st.tokens_generated} ({generated} generated less {activated} first tokens), bursts "
        f"{st.bursts}, host_syncs {st.host_syncs}; {activated} timelines in order, {bursts} "
        f"burst records; TTFT p50/p90 {st.ttft_p50_s * 1e3:.2f}/{st.ttft_p90_s * 1e3:.2f} ms, "
        f"TPOT p50/p90 {st.tpot_p50_s * 1e3:.3f}/{st.tpot_p90_s * 1e3:.3f} ms")
    return st


def _telemetry_twin(torch, label, make, drive, n_requests, attrs=PAGED_TWIN_ATTRS, pool_from=1):
    """``make(telemetry_enabled) -> engine`` and ``drive(engine) ->
    completions``: the graphed engine with telemetry on (the main path)
    against its graphed telemetry-off twin (:func:`_engine_twin`), then
    the same graph calls per program and ``stats()`` fields the engine
    keeps itself, and the on engine's own account (:func:`_check_traces`).
    Returns the on engine, its completions and its launch counts."""
    engines = []

    def run(off):
        engines.append(make(not off))
        return engines[-1], drive(engines[-1])

    on, comps, counts = _engine_twin(torch, label, run, attrs, pool_from, twin="telemetry-off")
    off = engines[1]
    calls = {name: prog.calls for name, prog in on.graphs.items()}
    off_calls = {name: prog.calls for name, prog in off.graphs.items()}
    if calls != off_calls:
        raise AssertionError(f"{label}: graph calls differ: on {calls}, off {off_calls}")
    on_stats, off_stats = on.stats().to_json(), off.stats().to_json()
    differ = {f: (on_stats[f], off_stats[f]) for f in ENGINE_STATS if on_stats[f] != off_stats[f]}
    if differ:
        raise AssertionError(f"{label}: stats differ between telemetry on and off: {differ}")
    if off_stats["completed"] or off.telemetry.trace(0) is not None:
        raise AssertionError(f"{label}: the telemetry-off engine recorded a request")
    log(f"{label}: telemetry on == off also in graph calls {calls} and the stats fields "
        f"{', '.join(ENGINE_STATS)}")
    _check_traces(label, on, comps, n_requests)
    return on, comps, counts


def _dtoh_copies(prof) -> int:
    """Device-to-host copies in a profile's device events."""
    return sum(n for _, n, key in prof["rows"] if "DtoH" in key or "Device -> Pageable" in key)


def telemetry_cost(torch, label, cfg, params, cache_dtype, card, rounds=TELEMETRY_TIMING_ROUNDS,
                   bursts=4):
    """Host time that telemetry adds to steady graphed decode: two engines
    (telemetry on and off) with the same 8 residents (prompt 128; none
    retires inside the window), 3 warm-up bursts each, then ``rounds``
    alternating rounds of ``bursts`` 8-step bursts on the host clock
    around a synchronised window; medians.  Reported, not gated.  Then one
    profiled burst of the on engine, which must copy from the device to
    the host once (the burst's readback)."""
    from k8s_dra_driver_torch.models.paged import PagedServeEngine

    r = np.random.RandomState(SEED + 7)
    prompts = [r.randint(0, cfg.vocab_size, size=128).tolist() for _ in range(8)]
    engines = {}
    for mode in ("on", "off"):
        eng = PagedServeEngine(params=params, cfg=cfg, cache_dtype=cache_dtype, device=DEV,
                               n_blocks=8 * 24 + 1, telemetry_enabled=mode == "on",
                               **dict(LIFECYCLE, top_k=0))
        for p in prompts:
            eng.submit(p, max_tokens=8 * (3 + rounds * bursts + 2))
        for _ in range(3):
            eng.step_burst()
        engines[mode] = eng
    times = {"on": [], "off": []}
    for _ in range(rounds):
        for mode, eng in engines.items():
            sync(torch)
            t0 = time.perf_counter()
            for _ in range(bursts):
                eng.step_burst()
            sync(torch)
            times[mode].append((time.perf_counter() - t0) / bursts * 1e3)
    if [st.tokens for st in engines["on"]._slots] != [st.tokens for st in engines["off"]._slots]:
        raise AssertionError(f"{label}: the timing engines' streams differ")
    med = {mode: float(np.median(t)) for mode, t in times.items()}
    for mode in ("on", "off"):
        log(f"{label} timing: telemetry {mode}: {' / '.join(f'{t:.3f}' for t in times[mode])} "
            f"ms per graphed 8-step burst by round (median {med[mode]:.3f} ms, "
            f"{med[mode] / 8:.4f} ms per step)")
    log(f"{label} timing: telemetry adds {med['on'] - med['off']:.4f} ms per burst "
        f"({(med['on'] - med['off']) / med['off']:.4f} of the off burst; 8 residents, 64 "
        f"commits and 2 clock reads a burst; {card})")
    prof = profile_window(torch, f"{label}: profile of one telemetry-on graphed burst",
                          engines["on"].step_burst, top=4)
    if prof is None:
        log(f"{label}: device-to-host copies in a burst: not measured (no device events)")
    else:
        n = _dtoh_copies(prof)
        log(f"{label}: device-to-host copies in one telemetry-on burst: {n} (the readback)")
        if n != 1:
            raise AssertionError(f"{label}: {n} device-to-host copies in one burst, want 1")
    return med


def phase_serve_telemetry(torch, cfg, params, reqs, *, cache_dtype, card):
    """Request telemetry at full width in bf16 (8 slots, block 16, bucket
    256, sync interval 8): each graphed engine with telemetry on (the main
    path) against its graphed ``telemetry_enabled=False`` twin
    (:func:`_telemetry_twin`): the paged engine on the serving run's 16
    requests, on the lifecycle traffic (a 49-block pool that preempts, a
    cancel after burst 3, one slot poisoned, ``pump(queue_limit=6)``
    shedding) and with int4 block weights (both int4 kernels must launch);
    the dense engine and a γ = 4 speculative paged engine on the serving
    requests (each round's commits, handed to the open burst, sum to the
    committed tokens); then telemetry's host cost in steady decode.
    Returns the launch counts of the graphed on engines, by leg."""
    from k8s_dra_driver_torch.models import quant, serve
    from k8s_dra_driver_torch.models.paged import PagedServeEngine
    from k8s_dra_driver_torch.ops import int4_matmul as i4
    from k8s_dra_driver_torch.ops import paged_attention as pa
    from k8s_dra_driver_torch.utils import faults

    label = "serve bf16 telemetry"
    greedy = _greedy_dicts(reqs)
    out: dict = {}

    def leg(name, fn):
        t0 = time.perf_counter()
        fn()
        log(f"{label}: leg {name}: {time.perf_counter() - t0:.1f} s")

    def paged(enabled, p=params, n_blocks=8 * 24 + 1, **kw):
        return PagedServeEngine(params=p, cfg=cfg, n_blocks=n_blocks, cache_dtype=cache_dtype,
                                device=DEV, telemetry_enabled=enabled,
                                **dict(dict(LIFECYCLE, top_k=0), **kw))

    def serving_leg():
        _, _, out["serving"] = _telemetry_twin(
            torch, f"{label} serving", paged, lambda e: e.pump(greedy), len(reqs))

    def lifecycle_leg():
        lreqs = _lifecycle_traffic(cfg.vocab_size, SEED + 11)

        def make(enabled):
            inj = faults.FaultInjector(SEED)
            inj.arm(faults.FaultProfile(name="poison", **LIFECYCLE_POISON))
            return paged(enabled, n_blocks=LIFECYCLE_POOL, fault_injector=inj, top_k=50)

        def drive(eng):
            step_burst, bursts = eng.step_burst, [0]

            def counted():  # the pump's bursts, with a cancel after the third
                n = step_burst()
                bursts[0] += 1
                if bursts[0] == TELEMETRY_CANCEL_AFTER:
                    eng.cancel(min(st.request_id for st in eng._slots if st is not None))
                return n

            eng.step_burst = counted
            return eng.pump(lreqs, queue_limit=TELEMETRY_QUEUE_LIMIT)

        eng, comps, out["lifecycle"] = _telemetry_twin(
            torch, f"{label} lifecycle", make, drive, len(lreqs))
        statuses = eng.stats().statuses
        log(f"{label} lifecycle: {eng.preempted_count} preemptions, {eng.shed_count} shed, "
            f"statuses {statuses}")
        if not (eng.preempted_count and eng.shed_count and statuses.get("cancelled")
                and statuses.get("quarantined")):
            raise AssertionError(f"{label} lifecycle: the traffic did not preempt, shed, "
                                 f"cancel and quarantine")
        events = {e["event"] for c in comps if c.request_id >= 0
                  for e in eng.telemetry.trace(c.request_id)["events"]}
        if not {"preempt", "readmit"} <= events:
            raise AssertionError(f"{label} lifecycle: trace events {sorted(events)}")

    def int4_leg():
        p4 = quant.quantize_blocks(params, bits=4)
        _, _, counts = _telemetry_twin(
            torch, f"{label} int4", lambda enabled: paged(enabled, p=p4),
            lambda e: e.pump(greedy), len(reqs))
        out["int4"] = counts
        if not (counts[(i4.__name__, "int4_splitk")] and counts[(i4.__name__, "int4_wgmma")]):
            raise AssertionError(f"{label} int4: an int4 kernel was never launched: {counts}")

    def dense_leg():
        _telemetry_twin(
            torch, f"{label} dense",
            lambda enabled: _dense_engine(cfg, params, cache_dtype, telemetry_enabled=enabled),
            lambda e: e.pump(greedy), len(reqs), DENSE_TWIN_ATTRS, pool_from=0)

    def spec_leg():
        commits = []

        def drive(eng):
            on_commit = eng.telemetry.on_commit

            def counted(request_id, n=1):
                if eng.telemetry.enabled:
                    commits.append(n)
                on_commit(request_id, n)

            eng.telemetry.on_commit = counted
            return eng.pump(greedy)

        eng, comps, out["spec"] = _telemetry_twin(
            torch, f"{label} spec",
            lambda enabled: _spec_engine(cfg, params, cache_dtype, telemetry_enabled=enabled),
            drive, len(reqs))
        committed = sum(len(c.generated) - 1 for c in comps)
        on_commits = sum(commits)
        if eng.stats().tokens_generated != committed or on_commits != committed:
            raise AssertionError(f"{label} spec: on_commit summed {on_commits}, tokens_generated "
                                 f"{eng.stats().tokens_generated}, rounds committed {committed}")
        log(f"{label} spec: {eng.host_syncs} rounds, on_commit sums to the {committed} tokens "
            f"the rounds committed")

    leg("serving", serving_leg)
    leg("lifecycle", lifecycle_leg)
    leg("int4", int4_leg)
    leg("dense", dense_leg)
    leg("spec", spec_leg)
    leg("timing", lambda: telemetry_cost(torch, label, cfg, params, cache_dtype, card))
    append = (pa.__name__, "append")
    return {
        "paged_attention": sum(out[k][append] for k in ("serving", "lifecycle", "spec")),
        "int4_matmul": out["int4"][(i4.__name__, "int4_splitk")],
        "int4_matmul_prefill": out["int4"][(i4.__name__, "int4_wgmma")],
    }


# the LoRA phases: the serving geometry with a bank of two seeded adapters
# (rank 8, alpha 16, the four block matrices) beside the identity row
LORA = dict(rank=8, alpha=16.0)
# B's std: the JAX tests' 0.3 at d 64 puts scale * A @ B far above the
# base weights at d 1024, where the bf16 merge the teacher-forced check
# decodes rounds the sum far off the adapted forward; the identity leg
# prints both stds' readings (``_b_std_reading``)
LORA_B_STD = 0.05
LORA_B_STD_TESTS = 0.3        # tests/test_lora_serve.py's
LORA_TIGHT = 73               # blocks, the null block included, for the preemption leg
LORA_TIMING_ROUNDS = 4        # alternating rounds of 4 graphed 8-step bursts
LORA_TRAIN = dict(b=4, steps=5, lr=1e-3)


def _lora_bank(torch, cfg, b_std=LORA_B_STD):
    """``(LoraConfig, [adapter 1, adapter 2], bank)``: each adapter's A from
    ``lora.init_adapters`` (std 1/r) and B normal with std ``b_std``, from
    its own seed; the bank on the card, row 0 the identity."""
    from k8s_dra_driver_torch.models import lora

    lcfg = lora.LoraConfig(**LORA)
    adapters = []
    for k in (1, 2):
        g = torch.Generator(device=DEV).manual_seed(SEED + 100 + k)
        ad = lora.init_adapters(g, cfg, lcfg)
        for blk in ad["blocks"]:
            for ab in blk.values():
                ab["b"] = b_std * torch.randn(ab["b"].shape, generator=g, device=DEV)
        adapters.append(ad)
    return lcfg, adapters, lora.stack_adapters(cfg, lcfg, adapters)


def _b_std_reading(torch, label, cfg, params, prompt, cache_dtype):
    """Why ``LORA_B_STD``: for B std ``LORA_B_STD_TESTS`` and
    ``LORA_B_STD``, one prompt through the plain dense path three ways:
    adapter 1 applied by the bank's delta hooks (as the engines apply it),
    the bf16 ``lora.merge`` the teacher-forced check decodes, and the base.
    Prints, for each std, the largest logit difference between the first
    two (what the check's 0.25 gap has to absorb) and the positions whose
    argmax adapter 1 moves off the base's.  Returns ``{std: (difference,
    moved, positions)}``."""
    from k8s_dra_driver_torch.models import decode, lora

    ref = _dense_reference(params)
    x = torch.tensor([prompt], dtype=torch.long, device=DEV)
    ids = torch.ones((1,), dtype=torch.int32, device=DEV)

    def logits(p, adapters=None):
        cache = decode.init_cache(cfg, 1, x.shape[1], dtype=cache_dtype, device=DEV)
        out, _ = decode.decode_chunk(p, cache, x, 0, cfg=cfg, adapters=adapters)
        return out[0].float()

    base = logits(ref).argmax(-1)
    readings = {}
    for std in (LORA_B_STD_TESTS, LORA_B_STD):
        lcfg, adapters, bank = _lora_bank(torch, cfg, std)
        adapted = logits(ref, (bank, ids))
        merged = logits(lora.merge(ref, adapters[0], lcfg))
        if not (torch.isfinite(adapted).all() and torch.isfinite(merged).all()):
            raise AssertionError(f"{label}: B std {std}: logits not finite")
        diff = (adapted - merged).abs().max().item()
        moved = int((adapted.argmax(-1) != base).sum())
        readings[std] = (diff, moved, x.shape[1])
        log(f"{label}: B std {std}: adapter 1 by the delta hooks against its bf16 merge on a "
            f"{x.shape[1]}-token prompt, largest logit difference {diff:.6g}; positions whose "
            f"argmax it moves off the base's {moved} of {x.shape[1]}")
        del adapters, bank, merged
    return readings


def _lora_engine(cfg, params, cache_dtype, bank, **kw):
    """The serving run's paged engine (``_serving_engine``'s geometry) with
    ``bank``."""
    from k8s_dra_driver_torch.models.paged import PagedServeEngine

    kw = dict(dict(n_slots=8, n_blocks=8 * 24 + 1, block_size=16, prompt_bucket=256,
                   sync_interval=8, preempt_on_stall=False), **kw)
    return PagedServeEngine(params=params, cfg=cfg, cache_dtype=cache_dtype, adapter_bank=bank,
                            device=DEV, **kw)


def _teacher_forced_by_adapter(torch, label, cfg, params, lcfg, adapters, reqs, comps,
                               cache_dtype, tol):
    """Each completion teacher-forced (``_teacher_forced_all``) against the
    plain dense path of its own adapter's merged model (``lora.merge`` of
    the plain path's params; adapter 0: the base).  ``reqs[request_id]``
    carries the adapter."""
    from k8s_dra_driver_torch.models import lora

    base = _dense_reference(params)
    for k in range(len(adapters) + 1):
        group = [c for c in comps if reqs[c.request_id].get("adapter", 0) == k]
        if group:
            model = base if k == 0 else lora.merge(base, adapters[k - 1], lcfg)
            _teacher_forced_all(torch, f"{label}, adapter {k}", cfg, model, reqs, group,
                                cache_dtype, tol)
            del model


def _preempted_ids(eng, comps) -> set:
    return {c.request_id for c in comps
            if any(e["event"] == "preempt" for e in eng.telemetry.trace(c.request_id)["events"])}


def alternating_bursts(torch, engines: dict, prompts, rounds: int, bursts: int,
                       submit_kw=lambda name, i: {}) -> dict:
    """Steady decode of ``engines`` ({name: engine}) with the same
    residents (``prompts``; ``submit_kw(name, i)`` extra submit arguments),
    none retiring inside the window: 3 warm-up bursts each (a graphed
    engine captures in them), then ``rounds`` rounds of ``bursts`` bursts,
    the engines taking turns (reversed every other round), on the host
    clock around a synchronised window.  Returns {name: [ms per step by
    round]}; a burst is ``sync_interval`` steps."""
    for name, eng in engines.items():
        for i, p in enumerate(prompts):
            eng.submit(p, max_tokens=eng.sync_interval * (3 + rounds * bursts + 2),
                       **submit_kw(name, i))
        for _ in range(3):
            eng.step_burst()
    times = {name: [] for name in engines}
    for rnd in range(rounds):
        for name in (list(engines) if rnd % 2 == 0 else list(reversed(engines))):
            eng = engines[name]
            sync(torch)
            t0 = time.perf_counter()
            for _ in range(bursts):
                eng.step_burst()
            sync(torch)
            times[name].append((time.perf_counter() - t0) / (bursts * eng.sync_interval) * 1e3)
    return times


def phase_serve_lora(torch, cfg, params, reqs, *, cache_dtype, card, tol=0.25):
    """Per-request LoRA at full width in bf16 (8 slots, block 16, bucket
    256, sync interval 8; a bank of two seeded adapters and the identity,
    rank 8, alpha 16, all four block matrices), in seven legs, each timed:
    the serving run's 16 requests with adapters 0, 1, 2 in turn through the
    paged engine graphed (the main path) against an eager twin, every
    token teacher-forced against its own adapter's merged model, the
    append kernel held against its plain version on the path's first
    window (nq 1) in every layer; adapter-0 streams against a bank-less
    engine's (equal required; every adapted stream must differ), then the
    B std readings (``_b_std_reading``); one prompt under adapters 1, 2 and 1 with
    the prefix store (no hit across adapters, a hit for the same one);
    preemption on a tight pool (re-admitted rows teacher-forced under
    their adapters, never-preempted streams equal to the roomy run's); γ 4
    with the int8 self-draft under the bank, graphed against eager,
    acceptance printed; the int4 base under the bank (``int4_splitk`` and
    ``int4_wgmma`` both reached, each product shape held on the path's own
    x); the dense engine under the bank, graphed against eager; then the
    adapted graphed step against the bank-less one.  Returns the main
    path's launch counts."""
    from k8s_dra_driver_torch.models import burnin, lora, quant, serve
    from k8s_dra_driver_torch.ops import int4_matmul as i4
    from k8s_dra_driver_torch.ops import paged_attention as pa

    label = "serve bf16 lora"
    lcfg, adapters, bank = _lora_bank(torch, cfg)
    rows = lora.bank_size(bank)
    areqs = [dict(prompt=p, max_tokens=m, adapter=i % rows) for i, (p, m) in enumerate(reqs)]
    one = sum(t.numel() for t in burnin.param_leaves(adapters[0]))
    gathered = 2 * 8 * one * 4  # A and B rows for 8 slots, f32, read and written
    g_ms, _ = bound(gathered, 0, "bfloat16")
    log(f"{label}: bank of {rows} rows (the identity and 2 adapters, rank {lcfg.rank}, alpha "
        f"{lcfg.alpha}, targets {list(lcfg.targets)}, B std {LORA_B_STD}); {one} f32 values an "
        f"adapter ({one * 4 / 1e6:.2f} MB); a batch of 8 gathers its rows for every layer and "
        f"target each step: {gathered / 1e6:.1f} MB read and written, {g_ms * 1e3:.1f} us of "
        f"bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    out: dict = {}

    def leg(name, fn):
        t0 = time.perf_counter()
        fn()
        log(f"{label}: leg {name}: {time.perf_counter() - t0:.1f} s")

    def check_lengths(tag, comps, want_reqs):
        short = [c.request_id for c in comps
                 if c.status != "ok" or len(c.generated) != want_reqs[c.request_id]["max_tokens"]]
        if len(comps) != len(want_reqs) or short:
            raise AssertionError(f"{tag}: {len(comps)} completions, short or not ok {short}")

    def main_leg():
        def drive(eager):
            eng = _lora_engine(cfg, params, cache_dtype, bank)
            return eng, eng.pump(areqs)

        rec, restore = _record_append_windows(torch, pa, 1)
        try:
            eng, comps, counts = _engine_twin(torch, label, drive, PAGED_TWIN_ATTRS, pool_from=1)
        finally:
            restore()
        check_lengths(label, comps, areqs)
        _teacher_forced_by_adapter(torch, label, cfg, params, lcfg, adapters, areqs, comps,
                                   cache_dtype, tol)
        _hold_append_windows(torch, label, pa, rec, cfg, cache_dtype)
        out["counts"] = counts
        out["main"] = {c.request_id: c.generated for c in comps}

    def identity_leg():
        plain = _serving_engine(cfg, params, cache_dtype)
        want = {c.request_id: c.generated for c in plain.pump(reqs)}
        ids0 = [i for i, r_ in enumerate(areqs) if r_["adapter"] == 0]
        differ = [i for i in ids0 if out["main"][i] != want[i]]
        stayed = [i for i, r_ in enumerate(areqs) if r_["adapter"] and out["main"][i] == want[i]]
        log(f"{label} identity: adapter-0 streams equal to the bank-less graphed engine's: "
            f"{len(ids0) - len(differ)} of {len(ids0)}; adapted streams that left the base's: "
            f"{len(areqs) - len(ids0) - len(stayed)} of {len(areqs) - len(ids0)}")
        if differ:
            raise AssertionError(f"{label} identity: adapter-0 requests {differ} differ from "
                                 f"the bank-less engine's")
        if stayed:
            raise AssertionError(f"{label} identity: adapted requests {stayed} kept the "
                                 f"bank-less engine's stream: the bank does not move them")
        _b_std_reading(torch, f"{label} identity", cfg, params,
                       next(r_["prompt"] for r_ in areqs if r_["adapter"]), cache_dtype)

    def prefix_leg():
        r = np.random.RandomState(SEED + 41)
        prompt = r.randint(0, cfg.vocab_size, size=104).tolist()  # 6 storable blocks
        eng = _lora_engine(cfg, params, cache_dtype, bank, prefix_cache_blocks=16)
        runs, hits = [], []
        for adapter in (1, 2, 1):
            comps = eng.pump([dict(prompt=prompt, max_tokens=48, adapter=adapter)])
            runs.append(comps[0])
            hits.append(eng.prefix_hits)
        by_id = {c.request_id: dict(prompt=prompt, max_tokens=48, adapter=a)
                 for c, a in zip(runs, (1, 2, 1))}
        log(f"{label} prefix: one 104-token prompt under adapters 1, 2, 1: prefix hits after "
            f"each {hits}, misses {eng.prefix_misses}; the repeat's stream equal to the first's "
            f"{runs[0].generated == runs[2].generated} (reported: a hit runs the suffix chunk, "
            f"another product shape); adapters 1 and 2 differ "
            f"{runs[0].generated != runs[1].generated}")
        if hits[0] != 0 or hits[1] != hits[0] or hits[2] <= hits[1]:
            raise AssertionError(f"{label} prefix: hits {hits}: want none across adapters and "
                                 f"one for the same adapter")
        if runs[0].generated == runs[1].generated:
            raise AssertionError(f"{label} prefix: adapters 1 and 2 gave the same stream")
        _teacher_forced_by_adapter(torch, f"{label} prefix", cfg, params, lcfg, adapters, by_id,
                                   runs, cache_dtype, tol)
        leak_audit(f"{label} prefix", eng)

    def preemption_leg():
        eng = _lora_engine(cfg, params, cache_dtype, bank, n_blocks=LORA_TIGHT,
                           preempt_on_stall=True)
        comps = eng.pump(areqs)
        check_lengths(f"{label} preemption", comps, areqs)
        parked = _preempted_ids(eng, comps)
        if eng.preempted_count < 1 or not parked:
            raise AssertionError(f"{label} preemption: pool {LORA_TIGHT} never preempted")
        by_id = {c.request_id: c.generated for c in comps}
        kept = [i for i in by_id if i not in parked]
        differ = [i for i in kept if by_id[i] != out["main"][i]]
        same = sum(by_id[i] == out["main"][i] for i in parked)
        log(f"{label} preemption: pool {LORA_TIGHT} blocks (null block included), "
            f"{eng.preempted_count} preemptions of requests {sorted(parked)} (adapters "
            f"{sorted(areqs[i]['adapter'] for i in parked)}), stalled steps "
            f"{eng.stalled_steps}; never-preempted streams equal to the roomy run's: "
            f"{len(kept) - len(differ)} of {len(kept)}; re-admitted ones: {same} of {len(parked)} "
            f"(reported: a re-prefill runs another product shape)")
        if differ:
            raise AssertionError(f"{label} preemption: never-preempted requests {differ} differ "
                                 f"from the roomy run")
        _teacher_forced_by_adapter(torch, f"{label} preemption", cfg, params, lcfg, adapters,
                                   areqs, [c for c in comps if c.request_id in parked],
                                   cache_dtype, tol)

    def spec_leg():
        sreqs = areqs[:8]

        def drive(eager):
            eng = _spec_engine(cfg, params, cache_dtype, adapter_bank=bank)
            return eng, eng.pump(sreqs)

        eng, comps, _ = _engine_twin(torch, f"{label} spec", drive, PAGED_TWIN_ATTRS,
                                     pool_from=1)
        check_lengths(f"{label} spec", comps, sreqs)
        per_round = {}
        for k in range(rows):
            mine = [c for c in comps if sreqs[c.request_id]["adapter"] == k]
            rounds_k = sum(len(eng.telemetry.trace(c.request_id)["bursts"]) for c in mine)
            per_round[k] = round(sum(len(c.generated) - 1 for c in mine) / max(rounds_k, 1), 3)
        log(f"{label} spec: γ {eng.spec_gamma}, int8 self-draft of the base: {eng.host_syncs} "
            f"rounds; acceptance {eng.spec_accepted / max(eng.spec_drafted, 1):.4f} "
            f"({eng.spec_accepted} of {eng.spec_drafted} drafted); tokens a request commits "
            f"a round, by adapter {per_round} (1 + its accepted proposals)")
        _teacher_forced_by_adapter(torch, f"{label} spec", cfg, params, lcfg, adapters, sreqs,
                                   comps, cache_dtype, tol)

    def int4_leg():
        p4 = quant.quantize_blocks(params, bits=4)
        ireqs = areqs[:6]
        inputs, restore = _int4_recorder(torch, i4)
        try:
            sync(torch)
            _zero_serving_counts()
            eng = _lora_engine(cfg, p4, cache_dtype, bank)
            by_program = _int4_by_program(eng, i4)
            comps = eng.pump(ireqs)
            sync(torch)
            counts = serve.launch_counts()
        finally:
            restore()
        check_lengths(f"{label} int4", comps, ireqs)
        log(f"{label} int4 (int4 base, bf16 bank): launches by program {by_program}")
        burst, prefill = by_program.get("burst", {}), by_program.get("prefill", {})
        if not burst.get("int4_splitk") or not prefill.get("int4_wgmma"):
            raise AssertionError(f"{label} int4: want the bursts through int4_splitk and the "
                                 f"prefills through int4_wgmma: {by_program}")
        graph_bookkeeping(torch, f"{label} int4", eng)
        _teacher_forced_by_adapter(torch, f"{label} int4", cfg, p4, lcfg, adapters, ireqs, comps,
                                   cache_dtype, tol)
        ms = _hold_int4_inputs(torch, f"{label} int4", i4, inputs)
        log(f"{label} int4: {len(inputs)} product shapes of the path held against the plain "
            f"version elementwise (INT4_STEP); M by kernel {ms}")
        out["int4"] = counts

    def dense_leg():
        dreqs = areqs[:8]

        def drive(eager):
            eng = _dense_engine(cfg, params, cache_dtype, adapter_bank=bank)
            return eng, eng.pump(dreqs)

        eng, comps, _ = _engine_twin(torch, f"{label} dense", drive)
        check_lengths(f"{label} dense", comps, dreqs)
        _teacher_forced_by_adapter(torch, f"{label} dense", cfg, params, lcfg, adapters, dreqs,
                                   comps, cache_dtype, tol)

    def timing_leg(rounds=LORA_TIMING_ROUNDS, bursts=4):
        """The adapted and the bank-less graphed engine with the same 8
        residents (prompt 128; adapters 0, 1, 2 in turn on the adapted
        one), 3 warm-up bursts each, then alternating rounds of ``bursts``
        8-step bursts, host clock, medians; one profiled burst each."""
        r = np.random.RandomState(SEED + 7)
        prompts = [r.randint(0, cfg.vocab_size, size=128).tolist() for _ in range(8)]
        engines = {"adapted": _lora_engine(cfg, params, cache_dtype, bank),
                   "bank-less": _serving_engine(cfg, params, cache_dtype)}
        times = alternating_bursts(
            torch, engines, prompts, rounds, bursts,
            lambda name, i: dict(adapter=i % rows) if name == "adapted" else {})
        med = {name: float(np.median(t)) for name, t in times.items()}
        for name, t in times.items():
            log(f"{label} timing, {name}: {' / '.join(f'{x:.3f}' for x in t)} ms per graphed "
                f"step by round (median {med[name]:.3f})")
        log(f"{label} timing: the adapted step {med['adapted'] / med['bank-less']:.3f}x the "
            f"bank-less one (+{med['adapted'] - med['bank-less']:.3f} ms; {card})")
        for name, eng in engines.items():
            prof = profile_window(torch, f"{label} timing: profile of one graphed 8-step burst, "
                                  f"{name}", eng.step_burst, watch=("paged_attention",))
            if prof is not None:
                n = sum(r_[1] for r_ in prof["rows"])
                log(f"{label} timing, {name}: device busy {prof['busy_us'] / 8e3:.3f} ms and "
                    f"{n / 8:.0f} kernels per step")
        out["timing"] = med

    leg("main", main_leg)
    leg("identity", identity_leg)
    leg("prefix", prefix_leg)
    leg("preemption", preemption_leg)
    leg("spec", spec_leg)
    leg("int4", int4_leg)
    leg("dense", dense_leg)
    leg("timing", timing_leg)
    return {
        "paged_attention": out["counts"][(pa.__name__, "append")],
        "int4_matmul": out["int4"][(i4.__name__, "int4_splitk")],
        "int4_matmul_prefill": out["int4"][(i4.__name__, "int4_wgmma")],
    }


def _record_flash_inputs(torch, fa):
    """Wrap the dQ wrapper to keep the first backward call's inputs (q, k,
    v, lse, dout, delta: one layer's, the step's own shapes) outside any
    capture.  Returns ``(record, restore)``."""
    rec: dict = {}
    wrapper = fa._dq_bhsd

    def recording(q, k, v, lse, dout, delta, causal):
        if not rec and not (q.is_cuda and torch.cuda.is_current_stream_capturing()):
            rec.update(q=q.clone(), k=k.clone(), v=v.clone(), dout=dout.clone(), causal=causal)
        return wrapper(q, k, v, lse, dout, delta, causal)

    fa._dq_bhsd = recording

    def restore():
        fa._dq_bhsd = wrapper

    return rec, restore


def phase_train_lora(torch, cfg, *, b: int = LORA_TRAIN["b"], steps: int = LORA_TRAIN["steps"]):
    """Adapter-only training of ``cfg`` at S = max_seq in bf16 through the
    flash kernels (``lora.build_lora_train_step``, rank 8, alpha 16, the four
    block matrices, lr 1e-3): the graphed step (the main path; flash counts
    zeroed just before) against an eager twin from the same seeds, bit for
    bit over ``steps`` steps, the loss falling and the base unchanged; the
    flash forward, dQ and dK/dV kernels held against their plain versions
    on one layer's inputs from the step itself; then ms per step and peak
    memory beside the full graphed step in alternating rounds.  Returns
    the main path's flash launch counts."""
    from k8s_dra_driver_torch.models import burnin, lora, serve
    from k8s_dra_driver_torch.ops import flash_attention as fa

    label = "train lora"
    s = cfg.max_seq
    lcfg = lora.LoraConfig(**LORA)
    tokens = _train_tokens(torch, cfg, b, SEED + 3)
    base = burnin.init_params(torch.Generator(device=DEV).manual_seed(SEED + 5), cfg)
    before = [t.clone() for t in burnin.param_leaves(base)]
    runs = {}
    rec, restore = _record_flash_inputs(torch, fa)
    try:
        for mode in ("graphed", "eager"):
            fns = lora.build_lora_train_step(cfg, lcfg, lr=LORA_TRAIN["lr"], attention="flash",
                                             device=DEV)
            sync(torch)
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            ad, st = fns.init(torch.Generator(device=DEV).manual_seed(SEED + 6))
            sync(torch)
            _zero_flash_counts()
            with serve.disable_graphs() if mode == "eager" else contextlib.nullcontext():
                losses = [fns.step(ad, st, base, tokens)[2] for _ in range(steps)]
            sync(torch)
            runs[mode] = dict(fns=fns, ad=ad, st=st, losses=torch.stack(losses),
                              counts=(dict(fa.launches), dict(fa.fwd_launches),
                                      dict(fa.bwd_launches)),
                              peak=torch.cuda.max_memory_allocated() - start)
    finally:
        restore()
    graphed, eager = runs["graphed"], runs["eager"]
    counts, fwd, bwd = graphed["counts"]
    losses = graphed["losses"].tolist()
    n_ad = lora.adapter_param_count(graphed["ad"])
    log(f"{label} B={b} S={s} L={cfg.n_layers}: {n_ad} adapter values ({n_ad / 1e6:.3f} M, Adam "
        f"moments for those alone); losses over {steps} graphed steps on one batch "
        + " ".join(f"{x:.4f}" for x in losses))
    log(f"{label}: launches {counts}, by kernel {fwd} {bwd}")
    _graph_line(torch, label, graphed["fns"])
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall")
    n = cfg.n_layers * steps
    if counts != {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n} or fwd != {
            "flash_fwd_wgmma": 2 * n, "flash_fwd_fma": 0} or bwd != {
            "flash_bwd_dq_wgmma": n, "flash_bwd_dq_fma": 0,
            "flash_bwd_dkv_wgmma": n, "flash_bwd_dkv_fma": 0}:
        raise AssertionError(f"{label}: flash launch counts {counts} {fwd} {bwd} are not the "
                             f"main path's")
    if eager["counts"] != graphed["counts"]:
        raise AssertionError(f"{label}: graphed and eager launch counts differ")
    if graphed["fns"].captures != 1 or eager["fns"].captures != 0:
        raise AssertionError(f"{label}: captures graphed {graphed['fns'].captures}, eager "
                             f"{eager['fns'].captures} (want 1 and 0)")

    def bit_equal(when, with_losses=True):
        loss_ok = not with_losses or graphed["losses"].equal(eager["losses"])
        differ = _differing(_state_leaves(graphed["ad"], graphed["st"]),
                            _state_leaves(eager["ad"], eager["st"]))
        untouched = all(torch.equal(x, y) for x, y in zip(burnin.param_leaves(base), before))
        log(f"{label}: graphed == eager twin {when}: losses {loss_ok}; adapter, count, mu and "
            f"nu leaves that differ: {differ}; the base bit for bit unchanged: {untouched}")
        if not loss_ok or differ or not untouched:
            raise AssertionError(f"{label}: graphed and eager differ, or the base moved, {when}")

    bit_equal(f"after {steps} steps")
    # the flash kernels on one layer's inputs from the step itself
    if not rec:
        raise AssertionError(f"{label}: no flash backward call was recorded")
    q, k, v, dout, causal = rec["q"], rec["k"], rec["v"], rec["dout"], rec["causal"]
    step, why = FLASH_STEP["bfloat16"]
    got_fwd = fa._forward_bhsd(q, k, v, causal)
    out_p, lse_p = fa.flash_forward_plain(q, k, v, causal)
    grads = fa._backward_bhsd(q, k, v, out_p, lse_p, dout, causal)
    grads_p = fa.flash_backward_plain(q, k, v, out_p, lse_p, dout, causal)
    want = (out_p, lse_p, *grads_p)
    check = flash_check((*got_fwd, *grads), want, flash_limits(q, k, v, dout, causal, want, step))
    for name, (err, limit, top, rms, over, differ) in check.items():
        log(f"{label}: flash {name} on the step's own inputs {tuple(q.shape)} {q.dtype}: "
            f"max_abs_err {err:.3g}, limit there {limit:.3g}, max|plain| {top:.3g}; elements "
            f"over the limit {over}")
        if over:
            raise AssertionError(f"{label}: flash {name} disagrees with its plain version")
    del got_fwd, grads, grads_p, want
    # ms per step and peak memory beside the full graphed step
    full = burnin.build_train_step(cfg, attention="flash", remat="blocks", lr=3e-4, device=DEV)
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    params, state = full.init(torch.Generator(device=DEV).manual_seed(SEED + 5))
    for _ in range(3):
        full.step(params, state, tokens)
    sync(torch)
    full_peak = torch.cuda.max_memory_allocated() - start
    times = alternating_rounds(torch, {
        "lora": (lambda: graphed["fns"].step(graphed["ad"], graphed["st"], base, tokens),
                 contextlib.nullcontext),
        "full": (lambda: full.step(params, state, tokens), contextlib.nullcontext),
    }, 4, 5)
    med = {name: float(np.median(t)) for name, t in times.items()}
    for name, t in times.items():
        log(f"{label} timing, {name} graphed step: {' / '.join(f'{x:.2f}' for x in t)} ms by "
            f"round (median {med[name]:.2f} ms, {b * s / med[name] * 1e3:.0f} tokens/s)")
    log(f"{label}: the LoRA step {med['lora'] / med['full']:.3f}x the full step; peak memory "
        f"allocated: LoRA {graphed['peak'] / 2**30:.2f} GiB (its adapters, Adam state and "
        f"transients over the base it reads), full {full_peak / 2**30:.2f} GiB (params, AdamW "
        f"state and transients)")
    profile_window(torch, f"{label}: profile of one graphed LoRA step",
                   lambda: graphed["fns"].step(graphed["ad"], graphed["st"], base, tokens),
                   top=8, watch=("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma"))
    if not all(torch.equal(x, y) for x, y in zip(burnin.param_leaves(base), before)):
        raise AssertionError(f"{label}: the base moved over the timing rounds")
    return {"flash_fwd": fwd["flash_fwd_wgmma"], "flash_bwd_dq": bwd["flash_bwd_dq_wgmma"],
            "flash_bwd_dkv": bwd["flash_bwd_dkv_wgmma"]}


# mixture-of-experts at the flagship's widths: Mixtral-8x7B's 8 experts and
# top-2 routing (its published config.json: num_local_experts 8,
# num_experts_per_tok 2) over FLAGSHIP_MODERN
MOE = dict(n_experts=8, moe_top_k=2)
MOE_TIMING_ROUNDS = 4         # alternating rounds of 4 graphed 8-step bursts
MOE_TRAIN = dict(b=4, steps=4)
KV_QUANT = ("int8", "int4")


def moe_config(cfg):
    return dataclasses.replace(cfg, **MOE)


def _routing_recorder(torch, burnin, n_layers: int, n_experts: int):
    """Wrap ``burnin.top_k_experts`` to count each layer's expert choices
    and keep each call's routing margin per token (the k-th best score
    less the next one: how far the choice is from a tie); calls come layer
    by layer, so call i is layer i mod L.  Returns ``(counts [L][E],
    margins [calls], restore)``."""
    counts = [[0] * n_experts for _ in range(n_layers)]
    margins: list = []
    wrapped = burnin.top_k_experts

    def recorded(scores, k):
        vals, idx = wrapped(scores, k)
        top = scores.sort(dim=-1, descending=True).values
        margins.append((top[:, k - 1] - top[:, k]) if k < scores.shape[-1] else
                       torch.full_like(top[:, 0], float("inf")))
        hist = torch.bincount(idx.flatten(), minlength=n_experts).tolist()
        layer = counts[len(margins) % n_layers - 1]
        for e, n in enumerate(hist):
            layer[e] += n
        return vals, idx

    burnin.top_k_experts = recorded

    def restore():
        burnin.top_k_experts = wrapped

    return counts, margins, restore


def _moe_teacher_forced(torch, label, cfg, params, reqs, comps, cache_dtype, tol, gate):
    """Every greedy completion of an MoE model against the plain dense
    path, teacher-forced: each token's logit gap below the dense argmax,
    and the dense path's routing margins (:func:`_routing_recorder`),
    smallest over layers at the token's own position and up to it.  A
    routing near-tie flips an expert when the two paths round their bf16
    activations at other places, and the flipped expert's output moves
    the logits by more than any rounding does, so the tokens over ``tol``
    are printed beside those margins; with ``gate`` any token over ``tol``
    fails.  Returns the per-layer expert choices on the served tokens."""
    from k8s_dra_driver_torch.models import burnin, decode

    ref = _dense_reference(params)
    counts, margins, restore = _routing_recorder(torch, burnin, cfg.n_layers, cfg.n_experts)
    over, worst, exact, total, typical = [], 0.0, 0, 0, []
    try:
        for c in comps:
            plen, n = len(reqs[c.request_id]["prompt"]), len(c.generated)
            seq = torch.tensor([c.tokens], device=DEV)
            cache = decode.init_cache(cfg, 1, seq.shape[1], dtype=cache_dtype, device=DEV)
            margins.clear()
            logits, _ = decode.decode_chunk(ref, cache, seq, 0, cfg=cfg)
            logits = logits[0, plen - 1: plen - 1 + n].float()
            if not torch.isfinite(logits).all():
                raise AssertionError(f"{label}: non-finite reference logits")
            gen = torch.tensor(c.generated, device=DEV)
            gaps = logits.max(dim=-1).values - logits.gather(1, gen[:, None])[:, 0]
            at = torch.stack(margins).min(dim=0).values       # [positions], over layers
            upto = torch.cummin(at, dim=0).values
            typical.append(at[plen - 1: plen - 1 + n])
            worst = max(worst, gaps.max().item())
            exact += int((gaps == 0).sum().item())
            total += n
            for j in torch.nonzero(gaps > tol).flatten().tolist():
                p_ = plen - 1 + j
                over.append((c.request_id, j, round(gaps[j].item(), 4),
                             round(at[p_].item(), 5), round(upto[p_].item(), 5)))
    finally:
        restore()
    med = torch.cat(typical).median().item()
    log(f"{label}: teacher-forced vs plain dense decode: {exact}/{total} tokens the dense "
        f"argmax, worst gap {worst:.4g}; {len(over)} tokens over {tol} "
        f"({TOL_WHY[cache_dtype == torch.float32]}); the dense path's routing margin, median "
        f"over served positions {med:.4g}")
    if over:
        log(f"{label}: over the gap (request, token, gap, routing margin there, smallest up to "
            f"there): {over[:12]}{' ...' if len(over) > 12 else ''}")
    if gate and over:
        raise AssertionError(f"{label}: {len(over)} tokens over the {tol} logit gap")
    return counts


def phase_serve_moe(torch, cfg, params, reqs, *, cache_dtype, card, tol=0.25):
    """A mixture-of-experts model at the flagship's widths (``MOE``: 8
    experts, top-2, every expert on every token) in bf16 with random
    weights from a seed, in six legs, each timed: the serving run's first
    8 requests through the paged engine graphed (the main path, the append
    kernel) against an eager twin, the append kernel held against its
    plain version on the path's first window in every layer, every token
    teacher-forced against the plain dense path (reported with the
    routing margins: in bf16 a near-tie flips an expert between the two
    paths; ``_moe_teacher_forced``), the experts chosen per layer on those
    tokens printed (the run fails if one expert takes every choice); the
    dense engine the same way; both engines in f32 at 2 layers, every
    token held within 1e-3 of the plain dense argmax; the int4 base
    (``int4_splitk`` and ``int4_wgmma`` on the attention projections, each
    product shape held on the path's own x); γ 4 with the int8 self-draft,
    graphed against eager; then the graphed MoE step beside the dense-MLP
    one in alternating rounds, one profiled burst each (device time and
    kernels per step) and the bytes bound.  Returns the main path's launch
    counts."""
    from k8s_dra_driver_torch.models import burnin, quant, serve
    from k8s_dra_driver_torch.ops import int4_matmul as i4
    from k8s_dra_driver_torch.ops import paged_attention as pa

    label = "serve moe"
    mcfg = moe_config(cfg)
    mparams = burnin.init_params(torch.Generator(device=DEV).manual_seed(SEED + 61), mcfg)
    counted = {"experts": 0, "attention": 0, "embedding": 0, "other": 0}
    for key, leaf in [(k, v) for k, v in mparams.items() if k != "blocks"] + [
            (k, v) for blk in mparams["blocks"] for k, v in blk.items()]:
        part = ("experts" if key.startswith("expert") or key == "router" else
                "attention" if key in ("qkv", "attn_out") else
                "embedding" if key == "embed" else "other")
        counted[part] += leaf.numel()
    total = sum(counted.values())
    log(f"{label}: FLAGSHIP_MODERN with {MOE} (Mixtral-8x7B's routing at the flagship's "
        f"widths): {total / 1e6:.1f} M parameters, {quant.quantized_bytes(mparams)[0] / 1e9:.3f} GB in bf16 "
        f"(router f32); " + ", ".join(f"{k} {v / 1e6:.1f} M" for k, v in counted.items()))
    mreqs = _greedy_dicts(reqs[:8])
    out: dict = {}

    def leg(name, fn):
        t0 = time.perf_counter()
        fn()
        log(f"{label}: leg {name}: {time.perf_counter() - t0:.1f} s")

    def check_lengths(tag, comps, want):
        short = [c.request_id for c in comps
                 if c.status != "ok" or len(c.generated) != want[c.request_id]["max_tokens"]]
        if len(comps) != len(want) or short:
            raise AssertionError(f"{tag}: {len(comps)} completions, short or not ok {short}")

    def paged_leg():
        def drive(twin):
            eng = _serving_engine(mcfg, mparams, cache_dtype)
            return eng, eng.pump(mreqs)

        rec, restore = _record_append_windows(torch, pa, 1)
        try:
            eng, comps, counts = _engine_twin(torch, label, drive, PAGED_TWIN_ATTRS, pool_from=1)
        finally:
            restore()
        check_lengths(label, comps, mreqs)
        _hold_append_windows(torch, label, pa, rec, mcfg, cache_dtype)
        choices = _moe_teacher_forced(torch, label, mcfg, mparams, mreqs, comps, cache_dtype, tol,
                                      gate=False)
        for li, row in enumerate(choices):
            log(f"{label}: layer {li} expert choices on the served tokens "
                f"{row} (top-{mcfg.moe_top_k} of {mcfg.n_experts}, {sum(row)} in all)")
            if max(row) == sum(row):
                raise AssertionError(f"{label}: layer {li} routes every choice to one expert")
        out["counts"] = counts
        out["paged"] = {c.request_id: c.generated for c in comps}

    def dense_leg():
        def drive(twin):
            eng = _dense_engine(mcfg, mparams, cache_dtype)
            return eng, eng.pump(mreqs)

        _, comps, _ = _engine_twin(torch, f"{label} dense", drive)
        check_lengths(f"{label} dense", comps, mreqs)
        same = sum(c.generated == out["paged"][c.request_id] for c in comps)
        log(f"{label} dense: streams equal to the paged engine's: {same} of {len(comps)} "
            f"(reported: bf16 batch products round at other places)")
        _moe_teacher_forced(torch, f"{label} dense", mcfg, mparams, mreqs, comps, cache_dtype, tol,
                            gate=False)

    def f32_leg():
        """The paged and the dense engine over the MoE model in f32 at 2
        layers (full width): f32 rounding leaves routing near-ties alone,
        so every token is held within 1e-3 of the plain dense argmax."""
        cfg32 = dataclasses.replace(mcfg, n_layers=2, dtype=torch.float32)
        p32 = burnin.init_params(torch.Generator(device=DEV).manual_seed(SEED + 62), cfg32)
        for kind, make in (("paged", _serving_engine), ("dense", _dense_engine)):
            def drive(twin, make=make):
                eng = make(cfg32, p32, torch.float32)
                return eng, eng.pump(mreqs)

            tag = f"{label} f32 {kind}"
            _, comps, counts = _engine_twin(
                torch, tag, drive, PAGED_TWIN_ATTRS if kind == "paged" else DENSE_TWIN_ATTRS,
                pool_from=1 if kind == "paged" else 0)
            check_lengths(tag, comps, mreqs)
            _moe_teacher_forced(torch, tag, cfg32, p32, mreqs, comps, torch.float32, 1e-3,
                                gate=True)
            if kind == "paged":
                out["f32"] = counts

    def int4_leg():
        p4 = quant.quantize_blocks(mparams, bits=4)
        kinds = {k: type(v).__name__ for k, v in p4["blocks"][0].items()}
        log(f"{label} int4: block leaves {kinds}")
        if not isinstance(p4["blocks"][0]["expert_up"], torch.Tensor):
            raise AssertionError(f"{label} int4: the expert stacks were quantized")
        ireqs = mreqs[:6]
        inputs, restore = _int4_recorder(torch, i4)
        try:
            sync(torch)
            _zero_serving_counts()
            eng = _serving_engine(mcfg, p4, cache_dtype)
            by_program = _int4_by_program(eng, i4)
            comps = eng.pump(ireqs)
            sync(torch)
            counts = serve.launch_counts()
        finally:
            restore()
        check_lengths(f"{label} int4", comps, ireqs)
        log(f"{label} int4: launches by program {by_program}")
        burst, prefill = by_program.get("burst", {}), by_program.get("prefill", {})
        if not burst.get("int4_splitk") or not prefill.get("int4_wgmma"):
            raise AssertionError(f"{label} int4: want the bursts through int4_splitk and the "
                                 f"prefills through int4_wgmma: {by_program}")
        graph_bookkeeping(torch, f"{label} int4", eng)
        _moe_teacher_forced(torch, f"{label} int4", mcfg, p4, ireqs, comps, cache_dtype, tol,
                            gate=False)
        ms = _hold_int4_inputs(torch, f"{label} int4", i4, inputs)
        log(f"{label} int4: {len(inputs)} product shapes (the attention projections) held "
            f"against the plain version elementwise (INT4_STEP); M by kernel {ms}")
        out["int4"] = counts

    def spec_leg():
        def drive(twin):
            eng = _spec_engine(mcfg, mparams, cache_dtype)
            return eng, eng.pump(mreqs)

        eng, comps, _ = _engine_twin(torch, f"{label} spec", drive, PAGED_TWIN_ATTRS,
                                     pool_from=1)
        check_lengths(f"{label} spec", comps, mreqs)
        log(f"{label} spec: γ {eng.spec_gamma}, int8 self-draft (attention matrices int8, "
            f"expert stacks bf16): {eng.host_syncs} rounds; acceptance "
            f"{eng.spec_accepted / max(eng.spec_drafted, 1):.4f} ({eng.spec_accepted} of "
            f"{eng.spec_drafted} drafted)")
        same = sum(c.generated == out["paged"][c.request_id] for c in comps)
        log(f"{label} spec: streams equal to the plain paged engine's: {same} of {len(comps)} "
            f"(reported: the verify window rounds at other places than a step)")
        _moe_teacher_forced(torch, f"{label} spec", mcfg, mparams, mreqs, comps, cache_dtype, tol,
                            gate=False)

    def timing_leg(rounds=MOE_TIMING_ROUNDS, bursts=4):
        r = np.random.RandomState(SEED + 63)
        prompts = [r.randint(0, cfg.vocab_size, size=128).tolist() for _ in range(8)]
        engines = {"moe": _serving_engine(mcfg, mparams, cache_dtype),
                   "dense-MLP": _serving_engine(cfg, params, cache_dtype)}
        times = alternating_bursts(torch, engines, prompts, rounds, bursts)
        med = {name: float(np.median(t)) for name, t in times.items()}
        for name, t in times.items():
            log(f"{label} timing, {name}: {' / '.join(f'{x:.3f}' for x in t)} ms per graphed "
                f"step by round (median {med[name]:.3f})")
        ctx = 128 + 8 * (3 + rounds * bursts)
        kv = 8 * ctx * 2 * mcfg.n_layers * mcfg.kv_heads * mcfg.head_dim * 2
        for name, p_ in (("moe", mparams), ("dense-MLP", params)):
            b_ms, _ = bound(quant.quantized_bytes(p_)[0] + kv, 0, "bfloat16")
            log(f"{label} timing, {name}: bytes bound {b_ms:.3f} ms a step (parameters "
                f"{quant.quantized_bytes(p_)[0] / 1e9:.3f} GB + KV {kv / 1e6:.1f} MB at B 8, context {ctx}, "
                f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); median {med[name] / b_ms:.2f}x it")
        log(f"{label} timing: the MoE step {med['moe'] / med['dense-MLP']:.3f}x the dense-MLP "
            f"step ({card})")
        for name, eng in engines.items():
            prof = profile_window(torch, f"{label} timing: profile of one graphed 8-step burst, "
                                  f"{name}", eng.step_burst, watch=("paged_attention",))
            if prof is not None:
                n = sum(r_[1] for r_ in prof["rows"])
                log(f"{label} timing, {name}: device busy {prof['busy_us'] / 8e3:.3f} ms and "
                    f"{n / 8:.0f} kernels per step")

    leg("paged", paged_leg)
    leg("dense", dense_leg)
    leg("f32", f32_leg)
    leg("int4", int4_leg)
    leg("spec", spec_leg)
    leg("timing", timing_leg)
    return {
        "paged_attention": (out["counts"][(pa.__name__, "append")]
                            + out["f32"][(pa.__name__, "append")]),
        "int4_matmul": out["int4"][(i4.__name__, "int4_splitk")],
        "int4_matmul_prefill": out["int4"][(i4.__name__, "int4_wgmma")],
    }


def phase_train_moe(torch, cfg, *, b: int = MOE_TRAIN["b"], steps: int = MOE_TRAIN["steps"]):
    """bf16 training of the MoE model (``MOE`` over ``cfg``) at S = max_seq
    through the flash kernels, remat "blocks": the graphed step (the main
    path; flash counts zeroed just before) against an eager twin from the
    same seed, bit for bit over ``steps`` steps, the loss falling; ms per
    graphed step, tokens/s and peak memory; one profiled step.  Returns
    the main path's flash launch counts."""
    from k8s_dra_driver_torch.models import burnin, serve
    from k8s_dra_driver_torch.ops import flash_attention as fa

    label = "train moe"
    mcfg = moe_config(cfg)
    s = mcfg.max_seq
    tokens = _train_tokens(torch, mcfg, b, SEED + 3)
    runs = {}
    for mode in ("graphed", "eager"):
        fns = burnin.build_train_step(mcfg, attention="flash", remat="blocks", lr=3e-4,
                                      device=DEV)
        sync(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        params, state = fns.init(torch.Generator(device=DEV).manual_seed(SEED + 65))
        sync(torch)
        _zero_flash_counts()
        with serve.disable_graphs() if mode == "eager" else contextlib.nullcontext():
            losses = [fns.step(params, state, tokens)[2] for _ in range(steps)]
        sync(torch)
        runs[mode] = dict(fns=fns, params=params, state=state, losses=torch.stack(losses),
                          counts=(dict(fa.launches), dict(fa.fwd_launches),
                                  dict(fa.bwd_launches)),
                          peak=torch.cuda.max_memory_allocated() - base)
    graphed, eager = runs["graphed"], runs["eager"]
    counts, fwd, bwd = graphed["counts"]
    losses = graphed["losses"].tolist()
    log(f"{label} B={b} S={s} L={mcfg.n_layers} {MOE}: losses over {steps} graphed steps on one "
        f"batch " + " ".join(f"{x:.4f}" for x in losses))
    log(f"{label}: launches {counts}, by kernel {fwd} {bwd}")
    _graph_line(torch, label, graphed["fns"])
    log(f"{label}: peak memory allocated over the {steps} steps under remat 'blocks': graphed "
        f"{graphed['peak'] / 2**30:.2f} GiB, eager {eager['peak'] / 2**30:.2f} GiB (model, "
        f"AdamW state and the step's transients)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall")
    n = mcfg.n_layers * steps
    if counts != {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n} or fwd != {
            "flash_fwd_wgmma": 2 * n, "flash_fwd_fma": 0} or bwd != {
            "flash_bwd_dq_wgmma": n, "flash_bwd_dq_fma": 0,
            "flash_bwd_dkv_wgmma": n, "flash_bwd_dkv_fma": 0}:
        raise AssertionError(f"{label}: flash launch counts {counts} {fwd} {bwd} are not the "
                             f"main path's")
    if eager["counts"] != graphed["counts"]:
        raise AssertionError(f"{label}: graphed and eager launch counts differ")
    if graphed["fns"].captures != 1 or eager["fns"].captures != 0:
        raise AssertionError(f"{label}: captures graphed {graphed['fns'].captures}, eager "
                             f"{eager['fns'].captures} (want 1 and 0)")
    differ = _differing(_state_leaves(graphed["params"], graphed["state"]),
                        _state_leaves(eager["params"], eager["state"]))
    loss_ok = graphed["losses"].equal(eager["losses"])
    log(f"{label}: graphed == eager twin after {steps} steps: losses {loss_ok}; params, count, "
        f"mu and nu leaves that differ: {differ}")
    if not loss_ok or differ:
        raise AssertionError(f"{label}: the graphed and eager steps differ")
    del eager, runs
    times = alternating_rounds(torch, {"graphed": (
        lambda: graphed["fns"].step(graphed["params"], graphed["state"], tokens),
        contextlib.nullcontext)}, 2, 3)["graphed"]
    med = float(np.median(times))
    log(f"{label}: {' / '.join(f'{x:.2f}' for x in times)} ms per graphed step by round "
        f"(median {med:.2f} ms, {b * s / med * 1e3:.0f} tokens/s)")
    profile_window(torch, f"{label}: profile of one graphed step",
                   lambda: graphed["fns"].step(graphed["params"], graphed["state"], tokens),
                   top=10, watch=("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma"))
    return {"flash_fwd": fwd["flash_fwd_wgmma"], "flash_bwd_dq": bwd["flash_bwd_dq_wgmma"],
            "flash_bwd_dkv": bwd["flash_bwd_dkv_wgmma"]}


def _kv_codec_on_the_card(torch, label):
    """``quantize_kv_blocks``/``dequant_kv_blocks`` on a fixed f32 input on
    the card against the CPU's, byte for byte (bytes, scales, values), for
    both modes."""
    from k8s_dra_driver_torch.models import quant

    x = torch.from_numpy(
        (np.random.RandomState(SEED + 71).standard_normal((8, 64, 4, 64, 16)) * 2)
        .astype(np.float32))
    x[0, 1] = 0.0
    for kv_dtype in KV_QUANT:
        q_c, s_c = quant.quantize_kv_blocks(x, kv_dtype)
        q_d, s_d = quant.quantize_kv_blocks(x.to(DEV), kv_dtype)
        same = (torch.equal(q_d.cpu(), q_c) and torch.equal(s_d.cpu(), s_c) and torch.equal(
            quant.dequant_kv_blocks(q_d, s_d).cpu(), quant.dequant_kv_blocks(q_c, s_c)))
        log(f"{label}: {kv_dtype} codec on the card == the CPU's on {tuple(x.shape)} f32 "
            f"(bytes, scales, dequantized values): {same}")
        if not same:
            raise AssertionError(f"{label}: the {kv_dtype} codec differs between the card and "
                                 f"the CPU")


def phase_serve_kv_quant(torch, cfg, params, reqs, *, card):
    """Quantized KV pools (``kv_dtype`` "int8" and "int4") at
    FLAGSHIP_MODERN in bf16 under the bf16 serving engine's
    ``pool_hbm_bytes``: the blocks each budget holds; for each mode the
    serving run's first 8 requests graphed against an eager twin
    (completions, counters, pool bytes and scales from block 1, launch
    counts: the append kernel never launches, the route is plain PyTorch),
    each stream's first difference from the bf16 pool's stream (reported);
    the block codec on the card against the CPU; ms per graphed step
    beside the bf16 kernel step in alternating rounds."""
    from k8s_dra_driver_torch.models import paged
    from k8s_dra_driver_torch.ops import paged_attention as pa

    label = "serve kv quant"
    qreqs = _greedy_dicts(reqs[:8])
    geometry = dict(n_slots=8, block_size=16, prompt_bucket=256, sync_interval=8,
                    preempt_on_stall=False)
    budget = (8 * 24 + 1) * paged.kv_block_bytes(cfg, 16, torch.bfloat16)

    def engine(kv_dtype):
        return paged.PagedServeEngine(params=params, cfg=cfg, cache_dtype=torch.bfloat16,
                                      kv_dtype=kv_dtype, pool_hbm_bytes=budget, device=DEV,
                                      **geometry)

    blocks = {kv: engine(kv).n_blocks for kv in (None, *KV_QUANT)}
    log(f"{label}: pool_hbm_bytes {budget} ({budget / 2**20:.1f} MiB) holds "
        + ", ".join(f"{kv or 'bfloat16'} {n} blocks ({n / blocks[None]:.3f}x)"
                    for kv, n in blocks.items())
        + f"; a block costs {[paged.kv_block_bytes(cfg, 16, kv or torch.bfloat16) for kv in blocks]}"
          f" B (values and scales)")
    base = engine(None)
    want = {c.request_id: c.generated for c in base.pump(qreqs)}
    del base
    for kv_dtype in KV_QUANT:
        def drive(twin, kv_dtype=kv_dtype):
            eng = engine(kv_dtype)
            return eng, eng.pump(qreqs)

        eng, comps, counts = _engine_twin(torch, f"{label} {kv_dtype}", drive, PAGED_TWIN_ATTRS,
                                          pool_from=1)
        if counts.get((pa.__name__, "append"), 0) or len(comps) != len(qreqs):
            raise AssertionError(f"{label} {kv_dtype}: {len(comps)} completions, launches "
                                 f"{counts}: a quantized pool takes no paged kernel")
        first = {}
        for c in comps:
            base_ = want[c.request_id]
            first[c.request_id] = next(
                (i for i, (a, b_) in enumerate(zip(c.generated, base_)) if a != b_), None)
        log(f"{label} {kv_dtype}: each stream's first token that differs from the bf16 pool's "
            f"(None: equal throughout; reported, not gated): {first}")
    _kv_codec_on_the_card(torch, label)
    r = np.random.RandomState(SEED + 73)
    prompts = [r.randint(0, cfg.vocab_size, size=128).tolist() for _ in range(8)]
    rounds, bursts = 4, 4
    engines = {kv or "bfloat16": engine(kv) for kv in (None, *KV_QUANT)}
    times = alternating_bursts(torch, engines, prompts, rounds, bursts)
    med = {name: float(np.median(t)) for name, t in times.items()}
    for name, t in times.items():
        log(f"{label} timing, {name}: {' / '.join(f'{x:.3f}' for x in t)} ms per graphed step "
            f"by round (median {med[name]:.3f}, {med[name] / med['bfloat16']:.3f}x the bf16 "
            f"kernel step; {card})")
    for name in KV_QUANT:
        prof = profile_window(torch, f"{label} timing: profile of one graphed 8-step burst, "
                              f"{name}", engines[name].step_burst)
        if prof is not None:
            n = sum(r_[1] for r_ in prof["rows"])
            log(f"{label} timing, {name}: device busy {prof['busy_us'] / 8e3:.3f} ms and "
                f"{n / 8:.0f} kernels per step")


HANDOFF = dict(n_slots=8, block_size=16, prompt_bucket=256, sync_interval=8,
               preempt_on_stall=False)
HANDOFF_POOL = 8 * 24 + 1      # blocks, the null block included: this traffic never stalls
HANDOFF_PREFIX_BLOCKS = 16     # the prefix tier leg's store
HANDOFF_TIMING = 5             # timed repeats of each part, after 2 warm-ups
HANDOFF_TIMING_BUCKET = 272    # the timing leg's decode engine: 257 tokens of history fit


def _handoff_engine(cfg, params, cache_dtype, **kw):
    from k8s_dra_driver_torch.models.paged import PagedServeEngine

    kw = dict(HANDOFF, **kw)
    kw.setdefault("n_blocks", HANDOFF_POOL)
    return PagedServeEngine(params=params, cfg=cfg, cache_dtype=cache_dtype, device=DEV, **kw)


def _held_kv(eng, slot: int, valid_len: int) -> list:
    """Device copies of what ``eng`` holds for ``slot`` at positions below
    ``valid_len``: a dense cache's rows, and a float pool's blocks as rows,
    ``[L, valid_len, Hkv, hd]``; a quantized pool's whole blocks and their
    scales (its payload carries the blocks' padded extent)."""
    cache = eng._cache
    if not hasattr(eng, "_owned"):
        return [t[:, slot, :valid_len].clone() for t in (cache.k, cache.v)]
    ids = eng._owned[slot][: -(-valid_len // eng.block_size)]
    if cache.quantized:
        return [t[:, ids].clone() for t in cache]
    n_layers, _, hkv, hd, bs = cache.k.shape
    return [t[:, ids].permute(0, 1, 4, 2, 3).reshape(n_layers, len(ids) * bs, hkv, hd)
            [:, :valid_len].clone() for t in (cache.k, cache.v)]


def _fallback_counts() -> dict:
    from k8s_dra_driver_torch.utils.metrics import REGISTRY, parse_prom_text

    got = parse_prom_text(REGISTRY.render()).get("tpu_disagg_fallback_total", {})
    return {dict(key)["reason"]: int(n) for key, n in got.items()}


def phase_serve_handoff(torch, cfg, params, *, cache_dtype, card, tol=0.25):
    """KV handoff, the wire frames and the fleet prefix tier at
    FLAGSHIP_MODERN in bf16: 8 seeded requests (prompts of 16-256 tokens,
    32-64 new ones), 8 slots, block 16, bucket 256, in six legs, each
    timed.  (a) a paged prefill engine with ``handoff=True`` hands off
    through the port's ``to_wire``/``from_wire`` to a graphed paged decode
    engine (the main path: launch counts zeroed just before the restore),
    held against an eager twin (streams, counters, pool bytes from block
    1, launches); the injected blocks equal the source's byte for byte;
    the append kernel on each layer's first injected decode window against
    its plain version on that engine's pool; every token teacher-forced
    within the 0.25 gap; streams equal to the unsplit graphed engine's
    counted.  (b) the same with int8 pools (blocks and scales byte for
    byte; no paged kernel).  (c) the dense bf16 engine's handoffs into the
    paged bf16 engine.  (d) (a)'s bf16 payloads into an int8 pool:
    re-prefilled, ``incompatible`` counted 8 times.  (e) the fleet prefix
    tier: ``export_prefix_kv`` of a 256-token prompt from a paged engine
    with a 16-block store, over the wire into a second engine's
    ``inject_prefix_kv``, whose next ``submit`` hits every pulled block and
    whose first token is the first engine's cold one.  (f) host-clock
    medians of 5 for a 256-token request: capture, ``to_wire``,
    ``from_wire`` and inject, against the same request's re-prefill
    (``"kv"`` absent), and the payload's size in bf16 and int8.  Returns
    the append kernel's launches on the main paths of (a) and (c), (a)'s
    streams by request id and (f)'s bf16 medians by part."""
    from k8s_dra_driver_torch.models import serve
    from k8s_dra_driver_torch.ops import paged_attention as pa

    label = "serve bf16 handoff"
    hreqs = _greedy_dicts(_traffic(cfg.vocab_size, 8, 256, 64, SEED + 81))
    out: dict = {}

    def leg(name, fn):
        t0 = time.perf_counter()
        fn()
        log(f"{label}: leg {name}: {time.perf_counter() - t0:.1f} s")

    def handed_off(tag, pre):
        """Every request through ``pre`` with ``handoff=True``, each payload
        through the wire and back; the source's K/V kept at capture."""
        src, capture = {}, pre._capture_kv

        def capturing(slot, valid_len):
            src[pre._slots[slot].request_id] = _held_kv(pre, slot, valid_len)
            return capture(slot, valid_len)

        pre._capture_kv = capturing
        for r in hreqs:
            pre.submit(handoff=True, **r)
        entries = [dict(e, kv=serve.KVSlice.from_wire(e["kv"].to_wire(e["request_id"]))[1])
                   for e in pre.take_handoffs()]
        if len(entries) != len(hreqs) or pre.free_slots() != pre.n_slots:
            raise AssertionError(f"{tag}: {len(entries)} handoffs, {pre.free_slots()} free slots")
        kv0 = entries[0]["kv"]
        log(f"{tag}: {len(entries)} handoffs through the wire frame, payloads "
            f"{sum(e['kv'].nbytes for e in entries) / 2**20:.3f} MiB together ({kv0.dtype}, "
            f"block_size {kv0.block_size}; valid lengths {[e['kv'].valid_len for e in entries]})")
        return entries, src

    def check_injected(tag, eng, entries, src):
        held = 0
        for slot, st in enumerate(eng._slots):
            if st is None:
                continue
            kv = next(e["kv"] for e in entries if e["request_id"] == st.request_id)
            mine = _held_kv(eng, slot, kv.valid_len)
            if not all(torch.equal(a, b) for a, b in zip(mine, src[st.request_id], strict=True)):
                raise AssertionError(f"{tag}: request {st.request_id}'s injected K/V differ from "
                                     f"the source's")
            held += 1
        if held != len(entries):
            raise AssertionError(f"{tag}: {held} of {len(entries)} entries resident after restore")

    def inject_leg(tag, pre, make_dec, kernel, unsplit=None):
        entries, src = handed_off(tag, pre)
        before = _fallback_counts()

        def drive(twin):
            eng = make_dec()
            eng.restore({"next_id": len(hreqs), "requests": entries})
            check_injected(tag, eng, entries, src)
            eng.run_until_drained()
            return eng, eng.completions()

        rec, restore = _record_append_windows(torch, pa, 1) if kernel else ({}, lambda: None)
        try:
            eng, comps, counts = _engine_twin(torch, tag, drive, PAGED_TWIN_ATTRS, pool_from=1)
        finally:
            restore()
        log(f"{tag}: injected K/V equal the source's byte for byte"
            f"{' (blocks and scales)' if eng._cache.quantized else ''}, all {len(entries)} "
            f"requests, in both runs")
        short = [c.request_id for c in comps
                 if c.status != "ok" or len(c.generated) != hreqs[c.request_id]["max_tokens"]]
        if len(comps) != len(hreqs) or short:
            raise AssertionError(f"{tag}: {len(comps)} completions, short or not ok {short}")
        if _fallback_counts() != before:
            raise AssertionError(f"{tag}: fallbacks counted {_fallback_counts()}")
        appended = counts.get((pa.__name__, "append"), 0)
        if kernel:
            if appended == 0:
                raise AssertionError(f"{tag}: the append kernel never launched")
            _hold_append_windows(torch, tag, pa, rec, cfg, cache_dtype)
        elif appended:
            raise AssertionError(f"{tag}: a quantized pool launched the append kernel")
        _teacher_forced_all(torch, tag, cfg, params, hreqs, comps, cache_dtype, tol)
        if unsplit is not None:
            same = sum(c.generated == unsplit[c.request_id] for c in comps)
            log(f"{tag}: streams equal to the unsplit graphed engine's, token for token: {same} "
                f"of {len(comps)} (reported; expected {len(comps)}: the same bytes, the same "
                f"programs)")
        return entries, appended, {c.request_id: c.generated for c in comps}

    def unsplit(**kw):
        eng = _handoff_engine(cfg, params, cache_dtype, **kw)
        return {c.request_id: c.generated for c in eng.pump(hreqs)}

    def paged_leg():
        out["unsplit"] = unsplit()
        out["entries"], out["a"], out["streams"] = inject_leg(
            f"{label} (a) paged", _handoff_engine(cfg, params, cache_dtype),
            lambda: _handoff_engine(cfg, params, cache_dtype), True, out["unsplit"])

    def int8_leg():
        inject_leg(f"{label} (b) int8", _handoff_engine(cfg, params, cache_dtype, kv_dtype="int8"),
                   lambda: _handoff_engine(cfg, params, cache_dtype, kv_dtype="int8"), False,
                   unsplit(kv_dtype="int8"))

    def dense_leg():
        tag = f"{label} (c) dense -> paged"
        entries, out["c"], _ = inject_leg(tag, _dense_engine(cfg, params, cache_dtype),
                                       lambda: _handoff_engine(cfg, params, cache_dtype), True,
                                       out["unsplit"])
        # where the streams part from (a)'s: each engine's first-token step
        # rewrites position plen - 1 through its own attention
        paged_ = {e["request_id"]: e for e in out["entries"]}

        def same(e, last):
            theirs = paged_[e["request_id"]]["kv"]
            return all(np.array_equal(getattr(e["kv"], n)[:, :last],
                                      getattr(theirs, n)[:, :last]) for n in ("k", "v"))

        log(f"{tag}: against the paged prefill's handoffs of (a): payloads equal "
            f"{sum(same(e, None) for e in entries)} of {len(entries)}, equal but for position "
            f"plen - 1 {sum(same(e, -1) for e in entries)}, first tokens equal "
            f"{sum(e['tokens'] == paged_[e['request_id']]['tokens'] for e in entries)} (reported: "
            f"the first-token step rewrites position plen - 1 through the dense masked "
            f"attention in one engine and the paged kernel in the other)")

    def incompatible_leg():
        tag = f"{label} (d) bf16 -> int8"
        before = _fallback_counts().get("incompatible", 0)
        eng = _handoff_engine(cfg, params, cache_dtype, kv_dtype="int8")
        eng.restore({"next_id": len(hreqs), "requests": out["entries"]})
        counted = _fallback_counts().get("incompatible", 0) - before
        eng.run_until_drained()
        comps = eng.completions()
        log(f"{tag}: incompatible counted {counted}, {len(comps)} streams re-prefilled, "
            f"statuses {sorted({c.status for c in comps})}")
        if counted != len(hreqs) or len(comps) != len(hreqs) or any(
                c.status != "ok" for c in comps):
            raise AssertionError(f"{tag}: incompatible {counted}, {len(comps)} completions")
        _teacher_forced_all(torch, tag, cfg, params, hreqs, comps, cache_dtype, tol)

    def tier_leg():
        tag = f"{label} (e) prefix tier"
        prompt = np.random.RandomState(SEED + 82).randint(0, cfg.vocab_size, size=256).tolist()
        req = dict(prompt=prompt, max_tokens=32)
        owner = _handoff_engine(cfg, params, cache_dtype, prefix_cache_blocks=HANDOFF_PREFIX_BLOCKS)
        peer = _handoff_engine(cfg, params, cache_dtype, prefix_cache_blocks=HANDOFF_PREFIX_BLOCKS)
        (cold,) = owner.pump([req])
        kv = owner.export_prefix_kv(prompt)
        frame = kv.to_wire(7)
        installed = peer.inject_prefix_kv(prompt, serve.KVSlice.from_wire(frame)[1])
        ids = [[eng._prefix_store[eng._prefix_key(prompt, i)]
                for i in range(len(eng._prefix_store))] for eng in (owner, peer)]
        same_blocks = all(torch.equal(a[:, ids[0]], b[:, ids[1]])
                          for a, b in ((owner._cache.k, peer._cache.k),
                                       (owner._cache.v, peer._cache.v)))
        (hot,) = peer.pump([req])
        log(f"{tag}: exported {kv.valid_len} tokens ({len(ids[0])} blocks, "
            f"{len(frame) / 2**20:.3f} MiB on the wire), {installed} installed, pulled blocks "
            f"equal the owner's {same_blocks}; the next submit's hits {peer.prefix_hits} blocks, misses {peer.prefix_misses}; first "
            f"token {hot.generated[0]} against the owner's cold {cold.generated[0]}; whole stream "
            f"equal {hot.generated == cold.generated} (reported)")
        if (installed != 240 or not same_blocks or peer.prefix_hits != 15
                or hot.generated[0] != cold.generated[0]):
            raise AssertionError(f"{tag}: installed {installed}, blocks equal {same_blocks}, hits "
                                 f"{peer.prefix_hits}, first tokens {hot.generated[0]} / "
                                 f"{cold.generated[0]}")
        _teacher_forced_all(torch, tag, cfg, params, [req], [hot], cache_dtype, tol)

    def timing_leg():
        prompt = np.random.RandomState(SEED + 83).randint(0, cfg.vocab_size, size=256).tolist()
        for kv_dtype in (None, "int8"):
            tag = f"{label} (f) timing, {kv_dtype or 'bfloat16'}"
            src = _handoff_engine(cfg, params, cache_dtype, kv_dtype=kv_dtype)
            # the history (prompt and first token, 257) must fit the decode
            # engine's bucket, or restore refuses the entry before its payload
            dec = _handoff_engine(cfg, params, cache_dtype, kv_dtype=kv_dtype,
                                  prompt_bucket=HANDOFF_TIMING_BUCKET)
            src.submit(prompt, max_tokens=64)
            entry = src.snapshot_active()["requests"][0]
            parts = {name: [] for name in ("capture", "to_wire", "from_wire", "inject",
                                           "re-prefill")}

            def clocked(name, fn, i):
                sync(torch)
                t0 = time.perf_counter()
                res = fn()
                sync(torch)
                if i >= 2:
                    parts[name].append((time.perf_counter() - t0) * 1e3)
                return res

            before = _fallback_counts()
            for i in range(2 + HANDOFF_TIMING):
                kv = clocked("capture", lambda: src._capture_kv(0, 256), i)
                frame = clocked("to_wire", lambda: kv.to_wire(0), i)
                _, got = clocked("from_wire", lambda: serve.KVSlice.from_wire(frame), i)
                for part, doc in (("inject", dict(entry, kv=got)), ("re-prefill", entry)):
                    restored = clocked(part, lambda: dec.restore(
                        {"next_id": 1, "requests": [doc]}), i)
                    if restored != [0] or dec.free_slots() != dec.n_slots - 1:
                        raise AssertionError(f"{tag}: {part} restored {restored}, "
                                             f"{dec.free_slots()} free slots")
                    dec.release_active()
            if _fallback_counts() != before or dec.completions():
                raise AssertionError(f"{tag}: fallbacks {_fallback_counts()} or completions")
            med = {name: float(np.median(t)) for name, t in parts.items()}
            out.setdefault("timing", {})[kv_dtype or "bfloat16"] = med
            scales = 0 if kv.k_scale is None else kv.k_scale.nbytes + kv.v_scale.nbytes
            log(f"{tag}: payload of a 256-token prompt {(kv.nbytes - scales) / 2**20:.3f} MiB"
                f"{f' + {scales / 2**10:.1f} KiB of scales' if scales else ''}, frame "
                f"{len(frame) / 2**20:.3f} MiB; host-clock medians of {HANDOFF_TIMING} (ms, a sync "
                f"around each part): " + ", ".join(f"{n} {m:.3f}" for n, m in med.items())
                + f"; capture + wire + inject "
                f"{sum(med[n] for n in ('capture', 'to_wire', 'from_wire', 'inject')):.3f} "
                f"against re-prefill {med['re-prefill']:.3f} ({card})")
            for name, t in parts.items():
                log(f"{tag}: {name}: {' / '.join(f'{x:.3f}' for x in t)} ms")

    leg("(a) paged -> paged", paged_leg)
    leg("(b) int8", int8_leg)
    leg("(c) dense -> paged", dense_leg)
    leg("(d) bf16 -> int8", incompatible_leg)
    leg("(e) prefix tier", tier_leg)
    leg("(f) timing", timing_leg)
    return {"paged_attention": out["a"] + out["c"], "streams": out["streams"],
            "timing": out["timing"]["bfloat16"]}


# "serve workers": leg (a) of "serve bf16 handoff" across two worker
# processes (``python -m k8s_dra_driver_torch.models.transport``), this
# script the supervisor; each worker's engine is (a)'s
WORKER_ENGINE = dict(HANDOFF, kind="paged", n_blocks=HANDOFF_POOL)
WORKER_F32_LAYERS = 2
WORKER_TIMEOUT_S = 300  # a worker's start, or a stream's completion, beyond this fails


def _worker_doc(cfg, cache_dtype, seed: int, port: int, name: str, role: str,
                hold: bool) -> dict:
    """The reference's worker document for one paged engine of ``cfg``."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = str(cfg.dtype).split(".")[-1]
    engine = dict(WORKER_ENGINE, cache_dtype=str(cache_dtype).split(".")[-1])
    return {"cfg": fields, "engines": [engine], "seed": seed, "host": "127.0.0.1",
            "port": port, "name": name, "role": role, "hold_ticks": hold}


class _WorkerPeer:
    """One spawned worker as the supervisor sees it: its process, its
    connection once its HELLO named it, and when each thing arrived."""

    def __init__(self, name: str, proc, err_path, t0: float):
        self.name, self.proc, self.err_path, self.t0 = name, proc, err_path, t0
        self.conn = None  # a SocketConn once the worker's HELLO arrived
        self.buf = None   # its FrameBuffer, which may already hold frames
        self.ready_s = None

    def stderr_tail(self) -> str:
        return self.err_path.read_text()[-3000:]

    def check_ready(self, tag: str) -> None:
        """Its first stdout line must be ``{"ready": true, "pid": ...}``."""
        line = self.proc.stdout.readline()
        if not line or json.loads(line) != {"ready": True, "pid": self.proc.pid}:
            raise AssertionError(f"{tag}: worker {self.name}: ready line {line!r}")
        self.ready_s = time.perf_counter() - self.t0

    def launches(self) -> dict:
        err = self.err_path.read_text()
        line = [x for x in err.splitlines() if x.startswith("worker kernel launches: ")]
        if not line:
            raise AssertionError(f"worker {self.name}: no launch line; stderr tail:\n{err[-3000:]}")
        return json.loads(line[-1].split(": ", 1)[1])


@contextlib.contextmanager
def _spawned_workers(tag, cfg, cache_dtype, seed: int, port: int, tmp, workers):
    """Spawn one ``python -m k8s_dra_driver_torch.models.transport`` worker
    per ``(name, role, hold_ticks)`` of ``workers``, each dialing ``port``,
    and yield them by name as :class:`_WorkerPeer` s.  The caller hangs up
    before the block ends; then each worker has 60 s to exit (it is killed
    after) and must have exited 0."""
    import os
    from pathlib import Path

    root = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items() if k != "DRA_FAULTS"}
    env["PYTHONPATH"] = os.pathsep.join(x for x in (str(root), env.get("PYTHONPATH", "")) if x)
    peers = {}
    try:
        for name, role, hold in workers:
            path = Path(tmp) / f"{tag.replace(' ', '_')}_{name}.json"
            path.write_text(json.dumps(_worker_doc(cfg, cache_dtype, seed, port, name, role,
                                                   hold=hold)))
            err_path = path.with_suffix(".stderr")
            args = [sys.executable, "-m", "k8s_dra_driver_torch.models.transport", str(path)]
            if DEV == "cpu":  # a rehearsal on the CPU
                args += ["--device", "cpu"]
            with open(err_path, "w") as err:
                proc = subprocess.Popen(args, cwd=root, env=env, stdout=subprocess.PIPE,
                                        stderr=err, text=True)
            peers[name] = _WorkerPeer(name, proc, err_path, time.perf_counter())
        yield peers
    finally:
        for peer in peers.values():
            try:
                peer.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                peer.proc.kill()
                peer.proc.wait()
    for peer in peers.values():
        if peer.proc.returncode != 0:
            raise AssertionError(f"{tag}: worker {peer.name} exited {peer.proc.returncode}; "
                                 f"stderr tail:\n{peer.stderr_tail()}")


def _serve_two_workers(torch, tag, cfg, cache_dtype, seed: int, reqs, tmp) -> dict:
    """Spawn a prefill worker and a decode worker (its ticks held), submit
    ``reqs`` to the prefill one, forward each HANDOFF as a KV frame to the
    decode one, resume it once every ACK is in, and gather the completions;
    then hang up and read each worker's launch line.  Returns the streams,
    the per-request clocks and the start-up times."""
    import socket

    from k8s_dra_driver_torch.models import transport as T

    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.bind(("127.0.0.1", 0))
    listener.listen(4)
    workers = (("prefill", "prefill", False), ("decode", "decode", True))
    with _spawned_workers(tag, cfg, cache_dtype, seed, listener.getsockname()[1], tmp,
                          workers) as peers:
        try:
            listener.settimeout(WORKER_TIMEOUT_S)
            while any(p.conn is None for p in peers.values()):
                sock, _ = listener.accept()
                buf = T.FrameBuffer()
                sock.settimeout(30)
                hello = None
                while hello is None:
                    buf.feed(sock.recv(1 << 16))
                    hello = next((json.loads(b) for f, b in buf.frames() if f == T.HELLO), None)
                peer = peers[hello["name"]]
                peer.check_ready(tag)
                if hello["pid"] != peer.proc.pid:
                    raise AssertionError(f"{tag}: worker {peer.name}: hello {hello}")
                peer.conn = T.SocketConn(sock, peer=peer.name)
                peer.buf = buf
            pre, dec = peers["prefill"], peers["decode"]
            handoff_at, ack_at, frame_bytes, comps, other = {}, {}, {}, {}, {}
            deadline = time.monotonic() + WORKER_TIMEOUT_S

            def frames_of(peer):
                """The frames that have arrived from ``peer`` (none: a short nap)."""
                if time.monotonic() > deadline:
                    raise AssertionError(f"{tag}: {len(handoff_at)} handoffs, {len(ack_at)} acks, "
                                         f"{len(comps)} completions in {WORKER_TIMEOUT_S} s")
                if peer.proc.poll() is not None:
                    raise AssertionError(f"{tag}: worker {peer.name} exited "
                                         f"{peer.proc.returncode}; stderr tail:\n"
                                         f"{peer.stderr_tail()}")
                data = peer.conn.recv_available()
                if not data:
                    time.sleep(0.0002)
                    return []
                peer.buf.feed(data)
                return list(peer.buf.frames())

            def from_decode(ftype, body):
                if ftype == T.ACK:
                    doc = json.loads(body)
                    if doc.get("outcome") != "ok" or not doc.get("placed"):
                        raise AssertionError(f"{tag}: ACK {doc}")
                    if doc["rid"] in ack_at:
                        raise AssertionError(f"{tag}: a second ACK for {doc['rid']}")
                    ack_at[doc["rid"]] = time.perf_counter()
                elif ftype == T.COMPLETION:
                    doc = json.loads(body)
                    if doc["request_id"] in comps:
                        raise AssertionError(f"{tag}: request {doc['request_id']} completed "
                                             f"twice")
                    comps[doc["request_id"]] = (doc, time.perf_counter())
                else:
                    other[ftype] = other.get(ftype, 0) + 1

            t_submit = time.perf_counter()
            for seq, r in enumerate(reqs):
                pre.conn.send(T.encode_frame(T.SUBMIT, json.dumps(
                    {"seq": seq, "prompt": r["prompt"], "max_tokens": r["max_tokens"],
                     "kwargs": {}}).encode()))
            # each HANDOFF, as it is taken, goes on as a KV frame and its ACK
            # is awaited before the next: HANDOFF taken to ACK received is one
            # request's round trip, no other request's queued behind it
            while len(ack_at) < len(reqs):
                for ftype, body in frames_of(pre):
                    if ftype == T.SUBMITTED:
                        doc = json.loads(body)
                        if not doc["ok"] or doc["rid"] != doc["seq"]:
                            raise AssertionError(f"{tag}: submit answered {doc}")
                    elif ftype == T.HANDOFF:
                        taken = time.perf_counter()
                        meta, wire = T.decode_meta_frame(body)
                        rid = int(meta["request_id"])
                        if rid in handoff_at or not wire:
                            raise AssertionError(f"{tag}: handoff of {rid} repeated or KV-less")
                        handoff_at[rid] = taken
                        meta["_correlation"] = f"handoff-req-{rid}"
                        frame = T.encode_meta_frame(T.KV, meta, wire)
                        frame_bytes[rid] = len(frame)
                        dec.conn.send(frame, request_id=rid)
                        while rid not in ack_at:
                            for f, b in frames_of(dec):
                                from_decode(f, b)
                    else:
                        other[ftype] = other.get(ftype, 0) + 1
            resumed = time.perf_counter()
            dec.conn.send(T.encode_frame(T.CONTROL, json.dumps({"op": "resume"}).encode()))
            while len(comps) < len(reqs):
                for f, b in frames_of(dec):
                    from_decode(f, b)
            t_done = time.perf_counter()
        finally:
            listener.close()
            for peer in peers.values():
                if peer.conn is not None:
                    peer.conn.close()
    return dict(comps=comps, handoff_at=handoff_at, ack_at=ack_at, frame_bytes=frame_bytes,
                t_submit=t_submit, resumed=resumed, t_done=t_done, other=other,
                ready={n: p.ready_s for n, p in peers.items()},
                spawned={n: p.t0 for n, p in peers.items()},
                launches={n: p.launches() for n, p in peers.items()})


def _in_process_handoff(torch, cfg, params, cache_dtype, reqs) -> dict:
    """Leg (a)'s path in this process, each part clocked with a sync
    around it: every request through a prefill engine with
    ``handoff=True`` (capture), its payload through ``to_wire`` and
    ``from_wire``, each entry restored into the decode engine by itself
    (inject, as a worker places a KV frame), then the decode engine
    drained.  Returns the streams and the parts' medians (ms)."""
    from k8s_dra_driver_torch.models import serve

    pre = _handoff_engine(cfg, params, cache_dtype)
    dec = _handoff_engine(cfg, params, cache_dtype)
    parts = {name: [] for name in ("capture", "to_wire", "from_wire", "inject")}

    def clocked(name, fn):
        sync(torch)
        t0 = time.perf_counter()
        res = fn()
        sync(torch)
        parts[name].append((time.perf_counter() - t0) * 1e3)
        return res

    capture = pre._capture_kv
    pre._capture_kv = lambda slot, n: clocked("capture", lambda: capture(slot, n))
    for r in reqs:
        pre.submit(handoff=True, **r)
    for e in pre.take_handoffs():
        frame = clocked("to_wire", lambda: e["kv"].to_wire(e["request_id"]))
        _, kv = clocked("from_wire", lambda: serve.KVSlice.from_wire(frame))
        clocked("inject", lambda: dec.restore({"next_id": 0, "requests": [dict(e, kv=kv)]},
                                              merge=True))
    dec.run_until_drained()
    return dict(streams={c.request_id: c.generated for c in dec.completions()},
                med={name: float(np.median(t)) for name, t in parts.items()})


def phase_serve_workers(torch, cfg, params, handoff, *, card, tol=0.25):
    """Leg (a) of "serve bf16 handoff" across a process boundary ("serve
    workers"): this script listens on 127.0.0.1 and spawns two workers on
    the card, a ``role: "prefill"`` one and a ``role: "decode"`` one, each
    one paged engine of (a)'s (8 slots, block 16, bucket 256, its weights
    from seed 0 on the card, as this script's), and sends (a)'s 8 requests
    to the prefill worker; each ``HANDOFF`` frame goes on to the decode
    worker as a ``KV`` frame, and once every ``ACK`` is in the decode
    worker resumes its ticks.  Gates: every request completes once, every
    ACK ok and placed, every token teacher-forced within the 0.25 gap, the
    streams (a)'s in this run bit for bit (``handoff["streams"]``), the
    decode worker's append launches above 0.  Then the same in f32 at 2
    layers (weights from seed 1, tolerance 1e-3), against an in-process
    run of (a)'s path.  Printed: each worker's start (ready line, first
    handoff or completion), the KV frame's bytes a request, the host-clock
    median of 8 from HANDOFF received to ACK received beside the
    in-process capture, wire and inject medians, and tokens/s from the
    first SUBMIT to the last COMPLETION.  Returns the decode workers'
    append launches."""
    import tempfile
    import types

    from k8s_dra_driver_torch.models import burnin

    label = "serve workers"
    hreqs = _greedy_dicts(_traffic(cfg.vocab_size, 8, 256, 64, SEED + 81))
    appends = 0
    cfg32 = dataclasses.replace(cfg, n_layers=WORKER_F32_LAYERS, dtype=torch.float32)
    runs = (("bf16", cfg, params, torch.bfloat16, SEED, tol),
            ("f32", cfg32, None, torch.float32, SEED + 1, 1e-3))
    with tempfile.TemporaryDirectory() as tmp:
        for name, cfg_, params_, cache_dtype, seed, tol_ in runs:
            tag = f"{label} {name}"
            t0 = time.perf_counter()
            if params_ is None:
                params_ = burnin.init_params(torch.Generator(device=DEV).manual_seed(seed), cfg_)
            local = _in_process_handoff(torch, cfg_, params_, cache_dtype, hreqs)
            run = _serve_two_workers(torch, tag, cfg_, cache_dtype, seed, hreqs, tmp)
            comps = run["comps"]
            streams = {rid: doc["generated"] for rid, (doc, _) in comps.items()}
            bad = [rid for rid, (doc, _) in comps.items()
                   if doc["status"] != "ok" or len(doc["generated"]) != hreqs[rid]["max_tokens"]]
            if sorted(comps) != list(range(len(hreqs))) or bad:
                raise AssertionError(f"{tag}: completions {sorted(comps)}, short or not ok {bad}")
            want = handoff["streams"] if name == "bf16" else local["streams"]
            same = sum(streams[rid] == want[rid] for rid in want)
            log(f"{tag}: streams equal to {'(a)' if name == 'bf16' else 'the in-process path'}'s "
                f"bit for bit: {same} of {len(want)}; the in-process path's against (a)'s: "
                f"{sum(local['streams'][r] == want[r] for r in want)} of {len(want)}")
            if same != len(want):
                raise AssertionError(f"{tag}: the two-process streams differ from the in-process "
                                     f"ones for {[r for r in want if streams[r] != want[r]]}")
            sns = [types.SimpleNamespace(request_id=rid, generated=doc["generated"],
                                         tokens=doc["tokens"]) for rid, (doc, _) in comps.items()]
            _teacher_forced_all(torch, tag, cfg_, params_, hreqs, sns, cache_dtype, tol_)
            launched = run["launches"]
            log(f"{tag}: kernel launches by worker {json.dumps(launched, sort_keys=True)}")
            n_append = launched["decode"].get("paged_attention:append", 0)
            if not n_append and DEV == "cuda":  # a CPU rehearsal takes the plain version
                raise AssertionError(f"{tag}: the decode worker never launched the append kernel")
            appends += n_append
            waits = [(run["ack_at"][r] - run["handoff_at"][r]) * 1e3 for r in sorted(comps)]
            first_handoff = min(run["handoff_at"].values()) - run["spawned"]["prefill"]
            first_done = min(t for _, t in comps.values()) - run["spawned"]["decode"]
            tokens = sum(len(s) for s in streams.values())
            wall = run["t_done"] - run["t_submit"]
            inproc = local["med"] if name != "bf16" else handoff["timing"]
            log(f"{tag}: start-up: prefill worker ready line {run['ready']['prefill']:.2f} s, "
                f"first handoff {first_handoff:.2f} s; decode worker ready line "
                f"{run['ready']['decode']:.2f} s, first completion {first_done:.2f} s (from each "
                f"spawn); KV frame bytes a request {sorted(run['frame_bytes'].values())}; "
                f"HANDOFF received to ACK received, host clock, median of {len(waits)} "
                f"{float(np.median(waits)):.3f} ms ({' / '.join(f'{w:.3f}' for w in waits)}); "
                f"in process: " + ", ".join(f"{k} {inproc[k]:.3f}" for k in
                                            ("capture", "to_wire", "from_wire", "inject"))
                + f" ms ({'(f) medians of a 256-token prompt' if name == 'bf16' else 'medians of these 8 requests'}); "
                f"two-process run {tokens} tokens in {wall:.3f} s, {tokens / wall:.1f} tokens/s "
                f"(first SUBMIT to last COMPLETION); other frames {run['other']}; "
                f"{time.perf_counter() - t0:.1f} s in all ({card})")
    return appends


# "serve disagg": the reference's disaggregated serving headline
# (bench.py's serving_disagg) through the port's own DisaggRouter at
# FLAGSHIP_MODERN in bf16, in this process and across worker processes
DISAGG = dict(block_size=16, prompt_bucket=256, sync_interval=8, preempt_on_stall=False)
# 4 long requests queued ahead of 8 short ones.  A long prompt is 255
# tokens, not 256: a handoff's history (the prompt and its first token)
# must fit the decode engine's bucket of 256, or restore refuses the entry
# in both packages; 255 also keeps a long prompt at 16 blocks of 16
DISAGG_MIX = dict(n_long=4, long_prompt=255, long_tokens=128, n_short=8, short_prompt=16,
                  short_tokens=8)
DISAGG_UNIFIED = dict(n_slots=8, n_blocks=8 * 24 + 1)   # every slot a whole long stream
DISAGG_PREFILL = dict(n_slots=4, n_blocks=4 * 16 + 1)   # a prefill slot holds a prompt only
DISAGG_DECODE = dict(n_slots=4, n_blocks=4 * 24 + 1)    # a decode slot holds a whole stream
# requests through each run's engines before the clock starts: each engine
# runs its programs eagerly once and captures them on the second call.  The
# first, a long prompt, goes through alone: the eager decode window it gives
# a decode engine is where (a) holds the append kernel against its plain
# version, at a context of several 64-key page ranges, as the measured
# long streams give it
DISAGG_WARMUP = dict(n=8, prompt=16, max_tokens=24, long_prompt=255)
# leg (c): the first transfer dropped (its 1 s of accounted latency moot),
# the second 1 s over its 0.25 s deadline, the third corrupted
DISAGG_FAULTS = (dict(name="drop", handoff_drop_rate=1.0, limit=1),
                 dict(name="late", handoff_latency_s=1.0, limit=2),
                 dict(name="corrupt", handoff_corrupt_rate=1.0, limit=1))


def _disagg_engine(cfg, params, **kw):
    from k8s_dra_driver_torch.models.paged import PagedServeEngine

    return PagedServeEngine(params=params, cfg=cfg, cache_dtype=kw.pop("cache_dtype"),
                            device=DEV, **DISAGG, **kw)


def _disagg_warmup(vocab: int) -> list:
    """The warm-up: one long request, then ``n`` short ones."""
    w = DISAGG_WARMUP
    sizes = [w["long_prompt"]] + [w["prompt"]] * w["n"]
    return [dict(prompt=np.random.RandomState(SEED + 92 + i).randint(0, vocab, size=n).tolist(),
                 max_tokens=w["max_tokens"]) for i, n in enumerate(sizes)]


def _disagg_traffic(vocab: int, seed: int) -> list:
    """The reference's mix at the smoke's sizes: greedy, longs first."""
    r, m = np.random.RandomState(seed), DISAGG_MIX
    longs = [r.randint(0, vocab, size=m["long_prompt"]).tolist() for _ in range(m["n_long"])]
    shorts = [r.randint(0, vocab, size=m["short_prompt"]).tolist() for _ in range(m["n_short"])]
    return ([dict(prompt=p, max_tokens=m["long_tokens"]) for p in longs]
            + [dict(prompt=p, max_tokens=m["short_tokens"]) for p in shorts])


def _tails(samples: list) -> str:
    """p50 and p99 in ms, bench.py's rank rule."""
    xs = sorted(samples)
    if not xs:
        return "none"
    pick = lambda q: xs[min(len(xs) - 1, int(q * (len(xs) - 1) + 0.5))]  # noqa: E731
    return f"p50 {pick(0.5) * 1e3:.3f} ms, p99 {pick(0.99) * 1e3:.3f} ms"


def _prompt_of(c) -> tuple:
    return tuple(c.tokens[: len(c.tokens) - len(c.generated)])


def _short_tails(engines, comps, shorts) -> tuple[str, str]:
    """The short requests' TTFT and end-to-end tails, from the request
    traces of the engines they retire on (one timeline across the pools;
    a later engine's trace of an id wins, as ``bench.py`` merges them)."""
    traces = {}
    for eng in engines:
        for c in comps:
            tr = eng.telemetry.trace(c.request_id)
            if tr is not None and _prompt_of(c) in shorts:
                traces[c.request_id] = tr
    return tuple(_tails([tr[k] for tr in traces.values() if tr[k] is not None])
                 for k in ("ttft_s", "e2e_s"))


def _check_served(label, reqs, comps) -> dict:
    """Every request completed once, ok, at its token count; returns the
    requests by the completions' ids."""
    by_prompt = {tuple(r["prompt"]): r for r in reqs}
    ids = [c.request_id for c in comps]
    bad = [c.request_id for c in comps if c.status != "ok" or _prompt_of(c) not in by_prompt
           or len(c.generated) != by_prompt[_prompt_of(c)]["max_tokens"]]
    if (len(comps) != len(reqs) or len(set(ids)) != len(ids) or bad
            or {_prompt_of(c) for c in comps} != set(by_prompt)):
        raise AssertionError(f"{label}: {len(comps)} completions of {len(reqs)} requests, "
                             f"ids {sorted(ids)}, short or not ok {bad}")
    return {c.request_id: by_prompt[_prompt_of(c)] for c in comps}


def _count_delta(before: dict, after: dict) -> dict:
    """What each count gained from ``before`` to ``after`` (the changed ones)."""
    return {k: after.get(k, 0) - before.get(k, 0) for k in after if after.get(k, 0) != before.get(k, 0)}


def _graph_launches(engines) -> dict:
    """The launch counts the engines' CUDA graphs have added so far: each
    call adds what a replay does (the eager first call launched the same);
    a program never captured counts nothing (none on the CPU)."""
    got: dict = {}
    for eng in engines:
        for prog in eng.graphs.values():
            for key, n in prog.replay_counts.items():
                got[key] = got.get(key, 0) + n * prog.calls
    return got


def _disagg_in_process(torch, label, cfg, params, reqs, cache_dtype, tol, card) -> dict:
    """Legs (a) and (c): the unified engine, then the router over 2 prefill
    and 2 decode engines, each after a warm-up through its own engines;
    then the router again under ``DISAGG_FAULTS``."""
    from k8s_dra_driver_torch.models import disagg, serve
    from k8s_dra_driver_torch.ops import paged_attention as pa
    from k8s_dra_driver_torch.utils.faults import FaultInjector, FaultProfile

    shorts = {tuple(r["prompt"]) for r in reqs if r["max_tokens"] == DISAGG_MIX["short_tokens"]}
    warm = _disagg_warmup(cfg.vocab_size)
    tokens = sum(r["max_tokens"] for r in reqs)
    append = (pa.__name__, "append")
    out: dict = {}

    tag = f"{label} (a) unified"
    uni = _disagg_engine(cfg, params, cache_dtype=cache_dtype, **DISAGG_UNIFIED)
    uni.pump([dict(r) for r in warm])
    sync(torch)
    t0 = time.perf_counter()
    uni_comps = uni.pump([dict(r) for r in reqs])
    sync(torch)
    uni_wall = time.perf_counter() - t0
    _check_served(tag, reqs, uni_comps)
    ttft, e2e = _short_tails([uni], uni_comps, shorts)
    log(f"{tag}: one graphed paged engine, {DISAGG_UNIFIED['n_slots']} slots, "
        f"{DISAGG_UNIFIED['n_blocks']} blocks: {len(reqs)} requests, {tokens} tokens in "
        f"{uni_wall:.3f} s, {tokens / uni_wall:.1f} tokens/s (after {len(warm)} warm-up requests); "
        f"short requests' TTFT {ttft}, end to end {e2e} ({card})")

    tag = f"{label} (a) disaggregated"
    pre = [_disagg_engine(cfg, params, cache_dtype=cache_dtype, **DISAGG_PREFILL)
           for _ in range(2)]
    dec = [_disagg_engine(cfg, params, cache_dtype=cache_dtype, **DISAGG_DECODE)
           for _ in range(2)]
    router = disagg.DisaggRouter(prefill=pre, decode=dec)
    fell: list = []
    fallback = router._fallback

    def noted(entry, reason):
        fell.append((int(entry["request_id"]), reason))
        return fallback(entry, reason)

    router._fallback = noted
    rec, restore = _record_append_windows(torch, pa, 1, pools=[e._cache.k for e in dec])
    try:
        router.pump([dict(warm[0])])
    finally:
        restore()
    router.pump([dict(r) for r in warm[1:]])
    if router.fallbacks or router.handoffs != len(warm):
        raise AssertionError(f"{tag}: warm-up handoffs {router.handoffs}, fallbacks "
                             f"{router.fallbacks}")
    _hold_append_windows(torch, f"{tag} (the long warm-up stream's first window in its decode "
                         f"engine's pool)", pa, rec, cfg, cache_dtype)
    reach = int(rec[0][6].max())
    if reach < 2 * pa.SPLIT_KEYS:
        raise AssertionError(f"{tag}: the held window reaches position {reach}, within two "
                             f"{pa.SPLIT_KEYS}-key page ranges")
    free0 = [e.free_blocks for e in pre + dec]
    dec0 = _graph_launches(dec)
    handoffs0, counts0 = router.handoffs, dict(router.channel.counts)
    sync(torch)
    _zero_serving_counts()
    t0 = time.perf_counter()
    comps = router.pump([dict(r) for r in reqs])
    sync(torch)
    wall = time.perf_counter() - t0
    out["launches"] = serve.launch_counts().get(append, 0)
    appended = _count_delta(dec0, _graph_launches(dec)).get(append, 0)
    by_id = _check_served(tag, reqs, comps)
    counts = _count_delta(counts0, dict(router.channel.counts))
    if (router.handoffs - handoffs0 != len(reqs) or fell or counts != {"ok": len(reqs)}):
        raise AssertionError(f"{tag}: handoffs {router.handoffs - handoffs0}, fallbacks {fell}, "
                             f"channel outcomes {counts}")
    if [e.free_blocks for e in pre + dec] != free0 or any(
            e.free_blocks != e.n_blocks - 1 for e in pre + dec):
        raise AssertionError(f"{tag}: free blocks {[e.free_blocks for e in pre + dec]} after the "
                             f"drain, {free0} before")
    if not appended and DEV == "cuda":  # a CPU rehearsal takes the plain version
        raise AssertionError(f"{tag}: the decode pools never launched the append kernel")
    _teacher_forced_all(torch, tag, cfg, params, reqs, comps, cache_dtype, tol, by_id=by_id)
    uni_by = {_prompt_of(c): c.generated for c in uni_comps}
    same = sum(c.generated == uni_by[_prompt_of(c)] for c in comps)
    ttft, e2e = _short_tails(dec + pre, comps, shorts)
    log(f"{tag}: DisaggRouter over 2 prefill engines ({DISAGG_PREFILL['n_slots']} slots, "
        f"{DISAGG_PREFILL['n_blocks']} blocks) and 2 decode engines ({DISAGG_DECODE['n_slots']} "
        f"slots, {DISAGG_DECODE['n_blocks']} blocks), one set of weights: {len(reqs)} requests, "
        f"{tokens} tokens in {wall:.3f} s, {tokens / wall:.1f} tokens/s (after {len(warm)} warm-up "
        f"requests); short requests' TTFT {ttft}, end to end {e2e}; handoffs {len(reqs)}, "
        f"fallbacks 0, channel {counts}; append launches {appended} in the decode pools' graphs, "
        f"{out['launches']} in all; streams equal to the unified engine's bit for bit: {same} "
        f"of {len(comps)} (reported); every pool's blocks back ({card})")
    for doc in disagg.debug_disagg_doc()["disagg"]:
        if doc["router_seq"] == router.seq:
            ch = doc["channel"]
            log(f"{tag}: debug_disagg_doc channel: claim {ch['claim']['name']} "
                f"({ch['bandwidth_gbps']} Gb/s, deadline {ch['transfer_deadline_s']} s, budget "
                f"{ch['max_in_flight_bytes']} B), in flight {ch['in_flight_bytes']} B / "
                f"{ch['in_flight_transfers']}, outcomes {ch['outcomes']}, bytes moved "
                f"{ch['bytes_moved']}")

    tag = f"{label} (c) fallback ladder"
    inj = FaultInjector(seed=SEED + 93)
    for kw in DISAGG_FAULTS:
        inj.arm(FaultProfile(**kw))
    router.channel.fault_injector = inj
    fell.clear()
    handoffs0, counts0, fallbacks0 = router.handoffs, dict(router.channel.counts), router.fallbacks
    comps = router.pump([dict(r) for r in reqs])
    router.channel.fault_injector = None
    by_id = _check_served(tag, reqs, comps)
    counts = _count_delta(counts0, dict(router.channel.counts))
    reasons = sorted(r for _, r in fell)
    if (reasons != ["corrupt", "deadline", "dropped"] or router.fallbacks - fallbacks0 != 3
            or counts != {"ok": len(reqs) - 3, "dropped": 1, "deadline": 1, "corrupt": 1}
            or router.handoffs - handoffs0 != len(reqs)):
        raise AssertionError(f"{tag}: fallbacks {fell}, channel outcomes {counts}")
    if any(e.free_blocks != e.n_blocks - 1 for e in pre + dec):
        raise AssertionError(f"{tag}: free blocks {[e.free_blocks for e in pre + dec]}")
    fallen = {rid for rid, _ in fell}
    _teacher_forced_all(torch, f"{tag}, the re-prefilled streams", cfg, params, reqs,
                        [c for c in comps if c.request_id in fallen], cache_dtype, tol,
                        by_id=by_id)
    log(f"{tag}: fallbacks by request {sorted(fell)}, each re-prefilled on a decode engine; "
        f"channel outcomes {counts}; the other {len(reqs) - 3} handoffs ok; every pool's "
        f"blocks back; injections {inj.stats()}")
    return out


def _disagg_workers(torch, label, cfg, params, reqs, handoff, cache_dtype, tol, card, tmp):
    """Leg (b): the port's ``TransportHub`` and the two workers of "serve
    workers" behind a ``DisaggRouter`` of two ``RemotePool``s and a
    ``TransportChannel``; after a warm-up, each worker's launch counts
    restart at 0 (``CONTROL zero_launches``), so its exit line counts the
    measured run only."""
    from k8s_dra_driver_torch.models import disagg, obs_plane
    from k8s_dra_driver_torch.models import transport as T

    tag = f"{label} (b) two workers"
    hub = T.TransportHub(host="127.0.0.1", liveness_timeout_s=WORKER_TIMEOUT_S,
                         ack_timeout_s=WORKER_TIMEOUT_S)
    links = {}
    t_spawn = time.perf_counter()
    workers = [(f"disagg-{role}", role, False) for role in ("prefill", "decode")]
    with _spawned_workers(tag, cfg, cache_dtype, SEED, hub.port, tmp, workers) as peers:
        try:
            deadline = time.monotonic() + WORKER_TIMEOUT_S
            while len(links) < len(peers):
                hub.poll()
                for name, peer in peers.items():
                    if peer.proc.poll() is not None:
                        raise AssertionError(f"{tag}: worker {name} exited {peer.proc.returncode} "
                                             f"before its link; stderr tail:\n"
                                             f"{peer.stderr_tail()}")
                    link = hub.links.get(name)
                    if name not in links and link is not None and not link.dead:
                        links[name] = link
                if time.monotonic() > deadline:
                    raise AssertionError(f"{tag}: workers {sorted(set(peers) - set(links))} did "
                                         f"not dial in {WORKER_TIMEOUT_S} s")
                time.sleep(0.01)
            for peer in peers.values():
                peer.check_ready(tag)
            ready_s = time.perf_counter() - t_spawn
            pools = {name: T.RemotePool(link, name=f"{name}-pool") for name, link in links.items()}
            pre_pool = pools["disagg-prefill"]
            channel = T.TransportChannel(links["disagg-decode"])
            router = disagg.DisaggRouter(prefill=pre_pool, decode=pools["disagg-decode"],
                                         channel=channel)
            # the workers run their programs eagerly once and capture them
            # on the second call: a warm-up first, as in (a)
            warm = _disagg_warmup(cfg.vocab_size)
            t0 = time.perf_counter()
            _check_served(f"{tag} warm-up", warm, router.pump([dict(r) for r in warm]))
            warm_s = time.perf_counter() - t0
            for link in links.values():
                link.send_json(T.CONTROL, {"op": "zero_launches"})
            handoffs0, counts0 = router.handoffs, dict(channel.counts)
            handoff_at, sent_at, ack_at, acks = {}, {}, {}, []
            drain, await_ack = pre_pool._drain_frames, channel._await_ack

            def draining():
                n0 = len(pre_pool._handoffs)
                drain()
                now = time.perf_counter()
                for e in pre_pool._handoffs[n0:]:
                    handoff_at.setdefault(int(e["request_id"]), now)

            def awaiting(rid):
                sent_at[rid] = time.perf_counter()  # the KV frame has just gone out
                ack = await_ack(rid)
                ack_at[rid] = time.perf_counter()
                acks.append(ack)
                return ack

            pre_pool._drain_frames, channel._await_ack = draining, awaiting
            t_submit = time.perf_counter()
            comps = router.pump([dict(r) for r in reqs])
            t_done = time.perf_counter()
            by_id = _check_served(tag, reqs, comps)
            bad = [a for a in acks if a is None or a.get("outcome") != "ok" or not a.get("placed")]
            counts = _count_delta(counts0, dict(channel.counts))
            if (bad or len(acks) != len(reqs) or router.fallbacks
                    or router.handoffs - handoffs0 != len(reqs) or counts != {"ok": len(reqs)}):
                raise AssertionError(f"{tag}: acks {acks}, fallbacks {router.fallbacks}, "
                                     f"handoffs {router.handoffs - handoffs0}, channel {counts}")
            _teacher_forced_all(torch, tag, cfg, params, reqs, comps, cache_dtype, tol,
                                by_id=by_id)
            want = {tuple(r["prompt"]): handoff["streams"][rid] for rid, r in enumerate(reqs)}
            same = sum(c.generated == want[_prompt_of(c)] for c in comps)
            waits = {part: [(b[r] - a[r]) * 1e3 for r in sorted(ack_at)] for part, (a, b) in (
                ("HANDOFF received to ACK received", (handoff_at, ack_at)),
                ("HANDOFF received to KV sent (the router's queue)", (handoff_at, sent_at)),
                ("KV sent to ACK received", (sent_at, ack_at)))}
            fleet = obs_plane.FLEET.bundle_doc(journal_limit=1)["instances"]
            frames = {name: st["frames"] for name, st in fleet.items()}
            generated = sum(len(c.generated) for c in comps)
            wall = t_done - t_submit
        finally:
            hub.close()
            for link in hub.links.values():
                link.conn.close()
    launched = {name: peer.launches() for name, peer in peers.items()}
    n_append = launched["disagg-decode"].get("paged_attention:append", 0)
    if not n_append and DEV == "cuda":
        raise AssertionError(f"{tag}: the decode worker never launched the append kernel")
    log(f"{tag}: the port's TransportHub, a prefill and a decode worker ({ready_s:.2f} s to both "
        f"ready lines, a warm-up of {len(warm)} requests {warm_s:.2f} s), a RemotePool each and a "
        f"TransportChannel: {len(comps)} requests once each, {len(acks)} ACKs ok and placed, "
        f"fallbacks 0; streams equal to \"serve workers\"' bit for bit: {same} of {len(comps)} "
        f"(reported); host clock, medians of {len(acks)} by request id: " + "; ".join(
            f"{part} {float(np.median(x)):.3f} ms ({' / '.join(f'{v:.3f}' for v in x)})"
            for part, x in waits.items())
        + f"; FLEET ingested TELEM frames {frames} "
        f"(instances {sorted(frames)}); {generated} tokens in {wall:.3f} s, "
        f"{generated / wall:.1f} tokens/s (first SUBMIT to last COMPLETION); kernel launches by "
        f"worker since the warm-up {json.dumps(launched, sort_keys=True)} ({card})")
    return n_append


def phase_serve_disagg(torch, cfg, params, handoff, *, card, tol=0.25):
    """The port's ``DisaggRouter`` on the card ("serve disagg").  (a) the
    reference's disaggregated mix (``bench.py``'s ``serving_disagg``) at
    FLAGSHIP_MODERN in bf16: 4 long requests (255-token prompts, 128 new
    tokens) queued ahead of 8 short ones (16, 8), greedy, through one
    graphed paged engine of 8 slots, then through the router over 2
    prefill engines (4 slots, 4 x 16 blocks + the null block) and 2 decode
    engines (4 slots, 4 x 24 + 1), one set of weights, block 16, bucket
    256, sync interval 8; each run after a warm-up through its own
    engines.  Gates: every request once at its token count, 12 handoffs,
    no fallback and every transfer ``ok``, every token teacher-forced
    within the 0.25 gap, append launches in the decode pools, the append
    kernel against its plain version on the first window a long warm-up
    stream gives its decode engine's pool (past two 64-key page ranges),
    every pool's blocks back.  (b) "serve workers"' two worker processes
    and its 8 requests behind the port's ``TransportHub``, two
    ``RemotePool`` s and a ``TransportChannel``: every request once, every
    ACK ok, no fallback, teacher-forced, the decode worker's append
    launches in the measured run.  (c) (a)'s router again, its channel dropping the first
    transfer, putting the second over its deadline and corrupting the
    third: those three fall back under their reasons and re-prefill
    (teacher-forced), the others ``ok``, no block leaked.  Returns the
    append launches of (a)'s disaggregated run and of (b)'s decode
    worker."""
    import tempfile

    label = "serve disagg"
    cache_dtype = torch.bfloat16
    reqs = _disagg_traffic(cfg.vocab_size, SEED + 91)
    t0 = time.perf_counter()
    out = _disagg_in_process(torch, label, cfg, params, reqs, cache_dtype, tol, card)
    log(f"{label}: legs (a) and (c) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wreqs = _greedy_dicts(_traffic(cfg.vocab_size, 8, 256, 64, SEED + 81))
    with tempfile.TemporaryDirectory() as tmp:
        workers = _disagg_workers(torch, label, cfg, params, wreqs, handoff, cache_dtype, tol,
                                  card, tmp)
    log(f"{label}: leg (b) {time.perf_counter() - t0:.1f} s")
    return out["launches"] + workers


# -- serve fleet ------------------------------------------------------------------------

FLEET = dict(n_slots=4, block_size=16, prompt_bucket=256, sync_interval=8,
             preempt_on_stall=False)
FLEET_STORE = 128  # prefix store blocks: more than leg (a) stores, so nothing is evicted
# leg (a): every slot at its longest stream (a 192-token prompt and 32 new
# tokens, 14 blocks), the store full, and the null block
FLEET_PREFIX_POOL = 4 * 14 + FLEET_STORE + 1
FLEET_POOL = 4 * 15 + 1  # legs (b), (c): a 200-token prompt and 32 new tokens, 15 blocks a slot
# leg (a)'s trace: the reference's shared-prefix family, 32 arrivals over 4
# system prompts of 128 tokens (Zipf), 12 users, turns of 16 tokens
FLEET_SHARED = dict(base=dict(seed=11, duration_s=36.0, base_rate_rps=1.0, stream_len_max=32),
                    n_system_prompts=4, system_len_tokens=128, n_users=12, turn_tokens=16,
                    max_turns=4)
# legs (b), (c): a diurnal trace with a 6x flash crowd, prompts up to 200
# tokens (median about 100), streams up to 32
FLEET_CROWD = dict(seed=5, duration_s=30.0, base_rate_rps=1.0, prompt_len_mu=4.6,
                   prompt_len_max=200, stream_len_max=32)
FLEET_CROWD_AT = (8.0, 8.0, 6.0)  # start s, duration s, multiplier
# scales up under the crowd's queue, down while the tail still streams
FLEET_POLICY = dict(min_replicas=1, max_replicas=3, up_ticks=2, down_ticks=3, cooldown_s=2.0,
                    target_util_low=0.5)
FLEET_DT = 0.5  # simulated seconds a tick of legs (b) and (c)
FLEET_WARMUP = dict(prompt=200, max_tokens=8, n=2)  # a warm-up engine's requests, one at a time


def _fleet_engine(cfg, params, cache_dtype, n_blocks, **kw):
    from k8s_dra_driver_torch.models.paged import PagedServeEngine

    return PagedServeEngine(params=params, cfg=cfg, cache_dtype=cache_dtype, device=DEV,
                            n_blocks=n_blocks, **FLEET, **kw)


def _fleet_warmup(eng, vocab: int, seed: int) -> None:
    """Each program of a fresh engine runs eagerly once and captures on its
    second call: two requests, one at a time (no prefix of the traffic)."""
    w = FLEET_WARMUP
    for i in range(w["n"]):
        prompt = np.random.RandomState(seed + i).randint(0, vocab, size=w["prompt"]).tolist()
        eng.pump([dict(prompt=prompt, max_tokens=w["max_tokens"])])


def _program_calls(engines) -> dict:
    return {(id(e), name): prog.calls for e in engines for name, prog in e.graphs.items()}


def _fleet_drive(torch, router, reqs, on_tick=None, on_submit=None, engines=(),
                 max_ticks: int = 20000):
    """Submit ``reqs`` in order as the fleet admits them (a request it cannot
    admit waits at the head), one router tick between rounds, until every
    stream is back.  ``on_submit(i, rid)`` after each admission (synchronized,
    so its time is the admission's), ``on_tick()`` after each tick.  Returns
    (completions, request index by id, admission seconds by request index,
    the indices whose admission ran one of ``engines``' programs for the
    first or second time (eagerly, or capturing it), wall seconds)."""
    pending, comps, adm, ids, first_use = list(range(len(reqs))), [], {}, {}, set()
    t0 = time.perf_counter()
    for _ in range(max_ticks):
        while pending:
            r = reqs[pending[0]]
            calls = _program_calls(engines)
            ts = time.perf_counter()
            try:
                rid = router.submit(r["prompt"], r["max_tokens"])
            except RuntimeError:
                break
            sync(torch)
            adm[pending[0]] = time.perf_counter() - ts
            if any(n <= 2 and n > calls.get(key, 0) for key, n in _program_calls(engines).items()):
                first_use.add(pending[0])
            ids[rid] = pending[0]
            if on_submit is not None:
                on_submit(pending[0], rid)
            pending.pop(0)
        router.tick()
        if on_tick is not None:
            on_tick()
        comps += router.completions()
        if not pending and len(comps) >= len(reqs) and _router_idle(router):
            break
    else:
        raise AssertionError(f"{len(comps)} of {len(reqs)} streams back in {max_ticks} ticks")
    sync(torch)
    return comps, ids, adm, first_use, time.perf_counter() - t0


def _router_idle(router) -> bool:
    if hasattr(router, "idle"):
        return router.idle()
    return router.prefill.idle() and router.decode.idle() and not router._staged


def _autoscale_events():
    """Tee the port journal's ``autoscale`` records (the journal is a
    bounded ring).  Returns (events, restore)."""
    from k8s_dra_driver_torch.utils.journal import JOURNAL

    events, record = [], JOURNAL.record

    def spy(component, event, correlation="", **attrs):
        if component == "autoscale":
            events.append((event, correlation, dict(attrs)))
        return record(component, event, correlation=correlation, **attrs)

    JOURNAL.record = spy

    def restore():
        JOURNAL.record = record

    return events, restore


def _balanced(label, engines, store=False):
    """Every engine's blocks back: free (plus stored, with a prefix store)
    equal to the pool less the null block."""
    got = [e.free_blocks + (sum(len(s) for s in e._prefix_stores) if store else 0)
           for e in engines]
    if got != [e.n_blocks - 1 for e in engines]:
        raise AssertionError(f"{label}: blocks free{' + stored' if store else ''} {got}, pools "
                             f"{[e.n_blocks - 1 for e in engines]}")


def _served_by_id(label, reqs, comps, ids) -> dict:
    """Every request completed once, ok, with its prompt and token count,
    matched by the id it was admitted under (``ids``: id -> request index;
    a trace may repeat a prompt).  Returns the requests by id."""
    got = sorted(c.request_id for c in comps)
    bad = [c.request_id for c in comps if c.request_id not in ids or c.status != "ok"
           or _prompt_of(c) != tuple(reqs[ids[c.request_id]]["prompt"])
           or len(c.generated) != reqs[ids[c.request_id]]["max_tokens"]]
    if got != sorted(ids) or len(ids) != len(reqs) or bad:
        raise AssertionError(f"{label}: {len(comps)} completions of {len(reqs)} requests "
                             f"({len(ids)} admitted), duplicated or missing "
                             f"{sorted(set(got) ^ set(ids))[:8]}, short or not ok {bad}")
    return {rid: reqs[i] for rid, i in ids.items()}


def _held_or_gapped(torch, label, cfg, params, reqs, comps, ids, want, cache_dtype, tol):
    """Streams against ``want`` (by request index): equal ones counted, every
    token teacher-forced within ``tol`` of the plain dense argmax.  Returns
    the count of equal streams."""
    by_id = _served_by_id(label, reqs, comps, ids)
    same = sum(tuple(c.generated) == tuple(want[ids[c.request_id]]) for c in comps)
    _teacher_forced_all(torch, label, cfg, params, reqs, comps, cache_dtype, tol, by_id=by_id)
    return same


def _fleet_prefix_leg(torch, label, cfg, params, cache_dtype, tol, card) -> int:
    """Leg (a): the shared-prefix trace through three paged engines behind a
    ``FleetRouter`` with the port's ``FleetPrefixTier`` (a
    ``LocalPrefixSource`` each), then the same trace through a tier-less
    fleet of three more.  Returns the measured runs' append launches."""
    from k8s_dra_driver_torch.models import fleet, fleet_prefix, serve, workload
    from k8s_dra_driver_torch.ops import paged_attention as pa

    w = workload
    kw = dict(FLEET_SHARED)
    spec = w.SharedPrefixSpec(base=w.WorkloadSpec(**kw.pop("base")), **kw)
    trace = list(w.generate_shared_prefix(spec))
    reqs = [dict(prompt=w.shared_prefix_tokens(a, vocab=cfg.vocab_size), max_tokens=a.max_tokens)
            for a in trace]
    append = (pa.__name__, "append")
    tokens = sum(r["max_tokens"] for r in reqs)
    runs: dict = {}
    launches = 0
    for tiered in (True, False):
        tag = f"{label} (a) {'with the tier' if tiered else 'without a tier'}"
        engines = {n: _fleet_engine(cfg, params, cache_dtype, FLEET_PREFIX_POOL,
                                    prefix_cache_blocks=FLEET_STORE) for n in ("A", "B", "C")}
        router = fleet.FleetRouter(list(engines.items()))
        tier = None
        if tiered:
            tier = fleet_prefix.FleetPrefixTier(fleet_prefix.FleetPrefixIndex())
            router.attach_prefix_tier(tier)  # a LocalPrefixSource per engine
        if tiered:
            rec, restore = _record_append_windows(torch, pa, 1, pools=[engines["A"]._cache.k])
            try:
                _fleet_warmup(engines["A"], cfg.vocab_size, SEED + 95)
            finally:
                restore()
            _hold_append_windows(torch, f"{tag} (engine A's first warm-up decode window)", pa,
                                 rec, cfg, cache_dtype)
        else:
            _fleet_warmup(engines["A"], cfg.vocab_size, SEED + 95)
        for i, n in enumerate(("B", "C")):
            _fleet_warmup(engines[n], cfg.vocab_size, SEED + 97 + 2 * i)
        kinds, pulls, exports, injects, checked = {}, [], [], [], []
        hits0 = {n: e.prefix_hits for n, e in engines.items()}
        if tiered:
            prepare = tier.prepare
            last = {}

            def prepared(name, engine, prompt, **k):
                last["kind"] = prepare(name, engine, prompt, **k)
                return last["kind"]

            tier.prepare = prepared
            for n, eng in engines.items():
                src = tier._sources[n]
                pull, export, inject = src.pull, eng.export_prefix_kv, eng.inject_prefix_kv

                def timed_pull(*a, _pull=pull, **k):
                    t0 = time.perf_counter()
                    kv = _pull(*a, **k)
                    pulls.append(time.perf_counter() - t0)
                    return kv

                def timed_export(*a, _export=export, **k):
                    t0 = time.perf_counter()
                    kv = _export(*a, **k)
                    exports.append(time.perf_counter() - t0)
                    return kv

                def timed_inject(prompt, kv, *a, _inject=inject, _eng=eng, _own=export, **k):
                    sync(torch)
                    t0 = time.perf_counter()
                    n_tok = _inject(prompt, kv, *a, **k)
                    sync(torch)
                    injects.append(time.perf_counter() - t0)
                    if n_tok:  # the blocks written hold the owner's export's bytes
                        have = _eng.local_prefix_depth(prompt)
                        mine = _own(prompt)
                        lo = have - n_tok
                        checked.append(all(
                            np.array_equal(getattr(mine, p)[:, lo:have], getattr(kv, p)[:, lo:have])
                            for p in ("k", "v")))
                    return n_tok

                src.pull, eng.export_prefix_kv, eng.inject_prefix_kv = (
                    timed_pull, timed_export, timed_inject)

            def submitted(i, rid):
                kinds[i] = last.pop("kind")
        else:
            before = {}

            def submitted(i, rid):
                eng = router._owner[rid].engine
                kinds[i] = "local" if eng.prefix_hits > before.get(id(eng), 0) else "cold"
                before.update({id(e): e.prefix_hits for e in engines.values()})

            before.update({id(e): e.prefix_hits for e in engines.values()})
        sync(torch)
        _zero_serving_counts()
        comps, ids, adm, first_use, wall = _fleet_drive(torch, router, reqs, on_submit=submitted,
                                                        engines=engines.values())
        launches += serve.launch_counts().get(append, 0)
        _balanced(tag, engines.values(), store=True)
        runs[tiered] = dict(comps=comps, ids=ids, adm=adm, kinds=kinds, wall=wall)
        by = {k: [adm[i] for i, v in kinds.items() if v == k] for k in ("local", "remote", "cold")}
        warm = {k: [adm[i] for i, v in kinds.items() if v == k and i not in first_use]
                for k in ("local", "remote", "cold")}
        line = (f"{tag}: FleetRouter over 3 paged engines ({FLEET['n_slots']} slots, "
                f"{FLEET_PREFIX_POOL} blocks, store {FLEET_STORE} blocks), {len(reqs)} arrivals "
                f"of generate_shared_prefix (4 system prompts of 128 tokens), {tokens} tokens in "
                f"{wall:.3f} s, {tokens / wall:.1f} tokens/s; admissions "
                f"{ {k: len(v) for k, v in by.items()} }; TTFT (router.submit to the first token "
                f"on the card, synchronized) by admission: "
                + "; ".join(f"{k} {_tails(v)}" for k, v in by.items())
                + f"; of the {len(reqs) - len(first_use)} admissions whose programs all replayed "
                "(the others ran a program eagerly or captured it): "
                + "; ".join(f"{k} {len(v)}, {_tails(v)}" for k, v in warm.items()))
        if tiered:
            if not tier.counts["remote"]:
                raise AssertionError(f"{tag}: no remote pull; tier counts {tier.counts}, "
                                     f"fallbacks {tier.fallbacks}")
            if not checked or not all(checked):
                raise AssertionError(f"{tag}: injected blocks equal to the owner's export: "
                                     f"{checked}")
            stores = {n: {fleet_prefix.prefix_digest(k) for k in e._prefix_stores[0]}
                      for n, e in engines.items()}
            index = tier.index
            held = set().union(*stores.values())
            strays = [e.key for e in index._entries.values() if e.key not in stores[e.owner]]
            if set(index._entries) != held or strays:
                raise AssertionError(f"{tag}: index entries {len(index)}, stored prefixes "
                                     f"{len(held)}, entries whose owner lacks them {len(strays)}")
            led = index.ledger()
            med = lambda xs: float(np.median(xs)) * 1e3 if xs else float("nan")  # noqa: E731
            wire = [p - e for p, e in zip(pulls, exports)]
            line += (f"; tier counts {tier.counts}, fallbacks {tier.fallbacks}; pulls "
                     f"{len(pulls)}: median ms export {med(exports):.3f}, wire (to_wire + "
                     f"from_wire) {med(wire):.3f}, inject {med(injects):.3f}, pull (export + "
                     f"wire) {med(pulls):.3f}; injected blocks equal to the owner's export: "
                     f"{len(checked)} of {len(checked)}; index {led.entries} entries "
                     f"{dict(led.blocks)} by owner = the {len(held)} prefixes the engines' "
                     f"stores hold ({ {n: len(s) for n, s in stores.items()} } blocks)")
        else:
            line += "; engines' own prefix hits (blocks) " + str(
                {n: e.prefix_hits - hits0[n] for n, e in engines.items()})
        log(line + f" ({card})")
    plain = runs[False]
    want = {plain["ids"][c.request_id]: c.generated for c in plain["comps"]}
    tag = f"{label} (a)"
    same = _held_or_gapped(torch, tag, cfg, params, reqs, runs[True]["comps"], runs[True]["ids"],
                           want, cache_dtype, tol)
    _held_or_gapped(torch, f"{tag} without a tier", cfg, params, reqs, plain["comps"],
                    plain["ids"], want, cache_dtype, tol)
    pulled = [i for i, k in runs[True]["kinds"].items() if k == "remote"]
    log(f"{tag}: streams with the tier equal to the tier-less run's: {same} of {len(reqs)}; the "
        f"{len(pulled)} pulled requests' TTFT with the tier {_tails([runs[True]['adm'][i] for i in pulled])}"
        f", the same requests without a tier {_tails([runs[False]['adm'][i] for i in pulled])} "
        f"({card})")
    return launches


def _crowd_traffic(vocab: int):
    from k8s_dra_driver_torch.models import workload as w

    spec = w.WorkloadSpec(flash_crowds=(w.FlashCrowd(*FLEET_CROWD_AT),), **FLEET_CROWD)
    trace = list(w.generate(spec))
    return trace, [dict(prompt=w.prompt_tokens(a, vocab=vocab, limit=None),
                        max_tokens=a.max_tokens) for a in trace]


def _autoscale_leg(torch, label, cfg, params, cache_dtype, tol, card, trace, reqs, want):
    """Leg (b): the port's ``FleetAutoscaler`` over a ``FleetRouter`` that
    starts with one paged engine, the crowd trace arriving on a simulated
    clock.  Returns the measured run's append launches."""
    from k8s_dra_driver_torch.models import autoscaler, fleet, serve, workload
    from k8s_dra_driver_torch.ops import paged_attention as pa

    tag = f"{label} (b) autoscaler"
    append = (pa.__name__, "append")
    clock = workload.SimClock()
    base = _fleet_engine(cfg, params, cache_dtype, FLEET_POOL)
    _fleet_warmup(base, cfg.vocab_size, SEED + 101)
    spawned, spawn_s = [], {}

    def factory():
        t0 = time.perf_counter()
        eng = _fleet_engine(cfg, params, cache_dtype, FLEET_POOL)
        burst = eng.step_burst

        def first_burst(*a, **k):
            out = burst(*a, **k)
            if id(eng) not in spawn_s:
                sync(torch)
                spawn_s[id(eng)] = time.perf_counter() - t0
            return out

        eng.step_burst = first_burst
        spawned.append(eng)
        return eng

    router = fleet.FleetRouter([("as-base", base)], clock=clock)
    asc = autoscaler.FleetAutoscaler(router, engine_factory=factory, clock=clock,
                                     policy=autoscaler.AutoscalerPolicy(**FLEET_POLICY))
    drains, drain = [], router.drain

    def timed_drain(name, reason="scale_down"):
        t0 = time.perf_counter()
        moved = drain(name, reason)
        sync(torch)
        drains.append((name, len(moved), time.perf_counter() - t0))
        return moved

    router.drain = timed_drain
    events, restore = _autoscale_events()
    arrivals = iter(enumerate(trace))
    nxt = next(arrivals, None)
    backlog, comps, over_time, ids = [], [], [], {}
    sync(torch)
    _zero_serving_counts()
    t0 = time.perf_counter()
    try:
        for _ in range(20000):
            now = clock.advance(FLEET_DT)
            while nxt is not None and nxt[1].t <= now:
                backlog.append(nxt[0])
                nxt = next(arrivals, None)
            while backlog:
                r = reqs[backlog[0]]
                try:
                    ids[router.submit(r["prompt"], r["max_tokens"])] = backlog[0]
                except RuntimeError:
                    break
                backlog.pop(0)
            router.tick()
            asc.tick(queue_depth=len(backlog))
            comps += router.completions()
            live = sum(1 for r in router.replicas if r.state != fleet.DRAINED)
            if not over_time or over_time[-1][1] != live:
                over_time.append((round(now, 1), live))
            if nxt is None and not backlog and len(comps) >= len(reqs) and router.idle():
                break
        else:
            raise AssertionError(f"{tag}: {len(comps)} of {len(reqs)} streams back")
        sync(torch)
    finally:
        restore()
    wall = time.perf_counter() - t0
    launches = serve.launch_counts().get(append, 0)
    same = _held_or_gapped(torch, tag, cfg, params, reqs, comps, ids, want, cache_dtype, tol)
    _balanced(tag, [base] + spawned)
    names = [e for e, _, _ in events]
    begins = {c: e.split(".")[0] for e, c, _ in events if e.endswith(".begin")}
    resumed = {c: e.split(".")[0] for e, c, _ in events if e.endswith(".resumed")}
    ups = [c for c, kind in resumed.items() if kind == "scale_up"]
    downs = [(c, a) for e, c, a in events if e == "scale_down.resumed"]
    live_moves = [a for c, a in downs if a["moved"] > 0]
    served = [e.stats().tokens_generated for e in spawned]
    spawned_appends = {i: _graph_launches([e]).get(append, 0) for i, e in enumerate(spawned)}
    if (not ups or not downs or not live_moves or resumed.items() - begins.items()
            or any(not c.startswith("scale-") for c in begins)):
        raise AssertionError(f"{tag}: autoscale events {events}")
    if not any(served) or (DEV == "cuda" and not any(spawned_appends.values())):
        raise AssertionError(f"{tag}: spawned replicas' tokens {served}, append launches in "
                             f"their graphs {spawned_appends}")
    log(f"{tag}: AutoscalerPolicy({FLEET_POLICY}) over a FleetRouter of one paged engine "
        f"({FLEET['n_slots']} slots, {FLEET_POOL} blocks), {len(reqs)} arrivals of generate() with "
        f"a {FLEET_CROWD_AT[2]:g}x flash crowd at {FLEET_CROWD_AT[0]:g}-"
        f"{FLEET_CROWD_AT[0] + FLEET_CROWD_AT[1]:g} s, {FLEET_DT} simulated s a tick: actions "
        f"{asc.actions}, spawn failures {asc.spawn_failures}; replicas over (simulated s, live) "
        f"{over_time}; journal {names}; scale-downs' streams moved "
        f"{[a['moved'] for _, a in downs]}; every request once, lost 0, duplicated 0; streams "
        f"equal to one engine's: {same} of {len(reqs)}; every pool's blocks back; "
        f"{sum(len(c.generated) for c in comps)} tokens in {wall:.3f} s, "
        f"{sum(len(c.generated) for c in comps) / wall:.1f} tokens/s ({card})")
    for i, eng in enumerate(spawned):
        log(f"{tag}: spawned replica {i}: factory call to its first burst "
            f"{spawn_s.get(id(eng), float('nan')) * 1e3:.1f} ms, {served[i]} tokens served, append "
            f"launches in its graphs {spawned_appends[i]}")
        if DEV == "cuda":
            graph_bookkeeping(torch, f"{tag} spawned replica {i}", eng)
    for name, moved, s in drains:
        log(f"{tag}: drain of {name}: {moved} streams snapshotted and merge-restored onto the "
            f"survivors in {s * 1e3:.1f} ms")
    return launches


def _pool_move_leg(torch, label, cfg, params, cache_dtype, tol, card, reqs, want):
    """Leg (c): ``PoolRebalancer`` over the port's ``DisaggRouter`` (two
    prefill and two decode paged engines) moving one replica between the
    pools through ``FleetAutoscaler.scale_move`` while streams are in
    flight.  Returns the measured run's append launches."""
    from k8s_dra_driver_torch.models import autoscaler, disagg, serve
    from k8s_dra_driver_torch.ops import paged_attention as pa

    tag = f"{label} (c) pool move"
    append = (pa.__name__, "append")
    engines = [_fleet_engine(cfg, params, cache_dtype, FLEET_POOL) for _ in range(4)]
    for i, eng in enumerate(engines):
        _fleet_warmup(eng, cfg.vocab_size, SEED + 103 + 2 * i)
    router = disagg.DisaggRouter(prefill=engines[:2], decode=engines[2:])
    policy = autoscaler.AutoscalerPolicy(min_replicas=1, max_replicas=4)
    pre_s = autoscaler.FleetAutoscaler(router.prefill, lambda: None, policy=policy)
    dec_s = autoscaler.FleetAutoscaler(router.decode, lambda: None, policy=policy)
    # any imbalance votes, one vote acts, and the cooldown holds it to one move
    rb = autoscaler.PoolRebalancer(router, pre_s, dec_s, autoscaler.RebalancePolicy(
        dominance=1.0, min_samples=1, vote_ticks=1, cooldown_s=1e9))
    state = {"submitted": 0, "done": 0, "in_flight_at_move": None}

    def on_submit(i, rid):
        state["submitted"] += 1

    def on_tick():
        d = rb.tick()
        if d["corr"] is not None:
            state["in_flight_at_move"] = state["submitted"] - state["done"]
            state["decision"] = d

    events, restore = _autoscale_events()
    completions = router.completions

    def counted():
        out = completions()
        state["done"] += len(out)
        return out

    router.completions = counted
    sync(torch)
    _zero_serving_counts()
    try:
        comps, ids, _, _, wall = _fleet_drive(torch, router, reqs, on_tick=on_tick,
                                              on_submit=on_submit)
    finally:
        restore()
    launches = serve.launch_counts().get(append, 0)
    same = _held_or_gapped(torch, tag, cfg, params, reqs, comps, ids, want, cache_dtype, tol)
    _balanced(tag, engines)
    moves = [(e, c) for e, c, _ in events if e.startswith("scale_move")]
    corrs = {c for _, c in moves}
    if (rb.moves != 1 or [e for e, _ in moves] != ["scale_move.begin", "scale_move.resumed"]
            or len(corrs) != 1 or not next(iter(corrs)).startswith("scale-")
            or not state["in_flight_at_move"]):
        raise AssertionError(f"{tag}: moves {rb.moves}, events {events}, in flight at the move "
                             f"{state['in_flight_at_move']}")
    d = state["decision"]
    log(f"{tag}: DisaggRouter over 2 prefill and 2 decode paged engines ({FLEET['n_slots']} "
        f"slots, {FLEET_POOL} blocks), PoolRebalancer (dominance 1, one vote, one move): vote "
        f"{d['vote']} under {d['corr']} with {state['in_flight_at_move']} streams in flight "
        f"(stage attribution {json.dumps(d['attribution'], sort_keys=True)}); pools now "
        f"prefill {[r.name for r in router.prefill.replicas]}, decode "
        f"{[(r.name, r.state) for r in router.decode.replicas]}; handoffs {router.handoffs}, "
        f"fallbacks {router.fallbacks}; every request once; streams equal to one engine's: "
        f"{same} of {len(reqs)}; every pool's blocks back; "
        f"{sum(len(c.generated) for c in comps)} tokens in {wall:.3f} s ({card})")
    return launches


def phase_serve_fleet(torch, cfg, params, *, card, tol=0.25):
    """The port's fleet prefix tier, autoscaler and workload generator on
    the card ("serve fleet"), FLAGSHIP_MODERN in bf16, paged engines of 4
    slots, block 16, bucket 256, sync interval 8, each after a warm-up.
    (a) ``generate_shared_prefix`` (32 arrivals over 4 system prompts of
    128 tokens) through a ``FleetRouter`` of 3 engines with prefix stores
    and the port's ``FleetPrefixTier`` (a ``LocalPrefixSource`` each), then
    through 3 more without a tier: remote pulls > 0, the blocks each pull
    injected equal to the owner's export, the index equal to the engines'
    stores, no block leaked, every stream equal to the tier-less run's or
    teacher-forced within the 0.25 gap (both runs teacher-forced); pull
    times (export, wire, inject) and TTFT by admission kind.  The append
    kernel is held against its plain version on the first warm-up decode
    window of engine A.  (b) ``generate`` with a flash crowd through a
    ``FleetAutoscaler`` over a router of one engine, new engines built on
    the card by its factory: at least one scale-up whose replica serves
    (append launches in its graphs), one scale-down that moves live
    streams, every stream once and teacher-forced, blocks back, the
    journal's events under their correlations.  (c) the same requests
    through a ``DisaggRouter`` of 2 + 2 engines while a ``PoolRebalancer``
    moves one replica between the pools (``scale_move``) with streams in
    flight: every stream once and teacher-forced, blocks back, the move's
    two events under one correlation.  Returns the measured runs' append
    launches."""
    label = "serve fleet"
    cache_dtype = torch.bfloat16
    t0 = time.perf_counter()
    launches = _fleet_prefix_leg(torch, label, cfg, params, cache_dtype, tol, card)
    log(f"{label}: leg (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trace, reqs = _crowd_traffic(cfg.vocab_size)
    single = _fleet_engine(cfg, params, cache_dtype, FLEET_POOL)
    _fleet_warmup(single, cfg.vocab_size, SEED + 111)
    one = single.pump([dict(r) for r in reqs])
    _check_served(f"{label} one engine", reqs, one)  # the crowd's prompts are unique
    index = {tuple(r["prompt"]): i for i, r in enumerate(reqs)}
    want = {index[_prompt_of(c)]: c.generated for c in one}
    launches += _autoscale_leg(torch, label, cfg, params, cache_dtype, tol, card, trace, reqs, want)
    log(f"{label}: leg (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches += _pool_move_leg(torch, label, cfg, params, cache_dtype, tol, card, reqs, want)
    log(f"{label}: leg (c) {time.perf_counter() - t0:.1f} s")
    return launches


def phase_selftest(torch, card):
    """``tpuinfo.selftest.run_selftest()`` (its subprocess, the card by
    default): ``ok``, platform "gpu", one device a visible card, each with
    a latency."""
    from k8s_dra_driver_torch.tpuinfo import selftest

    t0 = time.perf_counter()
    report = selftest.run_selftest(timeout_s=120)
    log(f"selftest: {json.dumps(report, sort_keys=True)} in {time.perf_counter() - t0:.1f} s "
        f"({card})")
    ids = [d.get("id") for d in report.get("devices", [])]
    if (report.get("ok") is not True or report.get("platform") != "gpu"
            or ids != list(range(torch.cuda.device_count()))
            or not all(d.get("ok") is True and d.get("latency_ms", -1) >= 0
                       for d in report["devices"])):
        raise AssertionError(f"selftest: the report is off: {report}")


# "serve mesh": the serving run's traffic on 4 ranks of one card over
# MeshShape(data=4): 8 slots (2 a rank), block 16, bucket 256, sync
# interval 8; the pool is 4 shards of a null block and 48 blocks, the
# single-card engine's 24 blocks a slot (this traffic never stalls)
SERVE_MESH = dict(n_slots=8, prompt_bucket=256, sync_interval=8)
SERVE_MESH_PAGED = dict(block_size=16, n_blocks=4 * (1 + 2 * 24), preempt_on_stall=False)
SERVE_MESH_LAYOUT = (0, {"data": 4})
SERVE_MESH_F32 = dict(n_layers=2, requests=8)
SERVE_MESH_ATTRS = ("host_syncs", "stalled_steps", "prefix_hits", "prefix_misses", "quarantined")
SERVED: dict = {}  # label -> {request id: generated tokens} of the single-card phases


def serve_mesh_rank(kind: str, cfg, seed: int, reqs, dev: str) -> dict:
    """One rank of "serve mesh": the engine (``kind`` "paged" or "dense")
    sharded over ``SERVE_MESH_LAYOUT`` with seeded weights (the same on
    every rank), ``reqs`` through ``pump`` graphed (the main path, launch
    and collective counts zeroed just before), then an eager twin
    (``serve.disable_graphs()``) that must give this rank the same
    completions, statuses, counters, launch counts and cache bytes (a
    paged pool's from its shard's block 1).  Returns the graphed run's
    completions, counters and numbers."""
    import torch.distributed as dist

    from k8s_dra_driver_torch.models import burnin, serve
    from k8s_dra_driver_torch.models.paged import PagedServeEngine
    from k8s_dra_driver_torch.ops import collectives
    from k8s_dra_driver_torch.ops import paged_attention as pa

    torch = _leg_setup(dev)
    mesh = _rank_mesh(SERVE_MESH_LAYOUT, dev)
    params = burnin.init_params(torch.Generator(device=DEV).manual_seed(seed), cfg)
    pool_from = 1 if kind == "paged" else 0
    runs = {}
    for name in ("graphed", "eager"):
        kw = dict(params=params, cfg=cfg, cache_dtype=cfg.dtype, mesh=mesh, slot_axis="data",
                  device=DEV, **SERVE_MESH)
        eng = (PagedServeEngine(**kw, **SERVE_MESH_PAGED) if kind == "paged"
               else serve.ServeEngine(**kw))
        sync(torch)
        dist.barrier()
        _zero_serving_counts()
        collectives.reset_counts()
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with serve.disable_graphs() if name == "eager" else contextlib.nullcontext():
            comps = eng.pump(reqs)
        sync(torch)
        runs[name] = dict(
            eng=eng, wall=time.perf_counter() - t0, counts=serve.launch_counts(),
            append=pa.launches["append"], comm=dict(collectives.comm_bytes),
            host=dict(collectives.host_bytes),
            peak=torch.cuda.max_memory_allocated() if DEV == "cuda" else 0,
            streams=sorted((c.request_id, c.generated, c.status) for c in comps), comps=comps)
    g, e = runs["graphed"], runs["eager"]
    rank = dist.get_rank()
    if g["streams"] != e["streams"]:
        raise AssertionError(f"rank {rank}: graphed and eager completions differ")
    for attr in SERVE_MESH_ATTRS:
        if getattr(g["eng"], attr, None) != getattr(e["eng"], attr, None):
            raise AssertionError(f"rank {rank}: graphed and eager {attr} differ")
    if g["counts"] != e["counts"]:
        raise AssertionError(f"rank {rank}: launch counts differ: {g['counts']}, {e['counts']}")
    for a, b_ in zip(g["eng"]._cache[:2], e["eng"]._cache[:2]):
        if not torch.equal(a[:, pool_from:], b_[:, pool_from:]):
            raise AssertionError(f"rank {rank}: graphed and eager caches differ from "
                                 f"{'block' if pool_from else 'row'} {pool_from} on")
    eng = g["eng"]
    graphs = {name: (prog.calls, graph_pool_bytes(torch, prog.graph) if prog.graph is not None
                     else 0, prog.graph is not None) for name, prog in eng.graphs.items()}
    stats = eng.stats().to_json()
    return dict(
        comps=g["comps"], streams=g["streams"],
        counters={a: getattr(eng, a, None) for a in SERVE_MESH_ATTRS + ("free_blocks",)}
        | {k: stats[k] for k in ("completed", "statuses", "tokens_generated", "bursts",
                                 "host_syncs", "free_slots", "free_blocks")},
        wall=g["wall"], eager_wall=e["wall"], decode_steps=getattr(eng, "decode_steps", None),
        comm=g["comm"], host=g["host"], peak=g["peak"], append=g["append"], graphs=graphs,
        graph_bound=getattr(eng, "graph_bound", 4))


def _append_at_batch_2(torch, label, ctx: int = 512):
    """The append kernel at the sharded engine's batch (2 rows a rank),
    bf16, nq 1, context ``ctx``: each pair of rows of a B 8 case held
    elementwise against its plain version (``PAGED_STEP``), and equal bit
    for bit to the same rows of the B 8 call (a row's split-K result does
    not depend on the batch)."""
    from k8s_dra_driver_torch.ops import paged_attention as pa

    step, cap, _ = PAGED_STEP["bfloat16"]
    kp, vp, table, pos, q, nk, nv = _paged_case(torch, torch.bfloat16, 1, [ctx] * 8)
    layer = 3
    out8, _, _ = pa.paged_append_attention(q, nk, nv, kp.clone(), vp.clone(), table, pos, layer)
    worst, same = 0.0, True
    for lo in range(0, 8, 2):
        rows = slice(lo, lo + 2)
        args = (q[rows], nk[rows], nv[rows])
        k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        out2, _, _ = pa.paged_append_attention(*args, k1, v1, table[rows], pos[rows], layer)
        plain = pa.paged_append_attention_plain(*args, k2, v2, table[rows], pos[rows], layer)
        mag = pa.paged_append_attention_plain(
            q[rows].float(), nk[rows].float(), nv[rows].float().abs(), kp.float(),
            vp.float().abs(), table[rows], pos[rows], layer)
        sync(torch)
        err, limit, top, over = paged_check(out2, plain, mag, step, cap)
        same = same and bool(torch.equal(out2, out8[rows]))
        worst = max(worst, err)
        if over or not (torch.equal(k1[:, 1:], k2[:, 1:]) and torch.equal(v1[:, 1:], v2[:, 1:])):
            raise AssertionError(f"{label}: the append kernel at B 2 disagrees (rows {lo}-{lo + 1}:"
                                 f" {over} elements over the limit)")
        del k1, v1, k2, v2
    log(f"{label}: append kernel bf16 B 2 nq 1 ctx {ctx}, four row pairs of a B 8 case: "
        f"max_abs_err {worst:.3g} against the plain version (elementwise PAGED_STEP limits), "
        f"equal bit for bit to the same rows of the B 8 call: {same}")
    if not same:
        raise AssertionError(f"{label}: a row's append result depends on the batch")


def _serve_mesh_report(torch, label, results, kind, cfg, params, reqs, single, tol, card) -> int:
    """Hold "serve mesh"'s gates on the ranks' results and print its
    numbers; returns the append kernel's launches summed over the ranks."""
    head = results[0]
    for r in results[1:]:
        if (r["streams"], r["counters"]) != (head["streams"], head["counters"]):
            raise AssertionError(f"{label}: the ranks' completions or counters differ")
    comps = head["comps"]
    if len(comps) != len(reqs) or {c.status for c in comps} != {"ok"}:
        raise AssertionError(f"{label}: {len(comps)} completions for {len(reqs)} requests")
    c = head["counters"]
    log(f"{label}: every rank's completions, statuses and counters identical: {c}")
    log(f"{label}: each rank's graphed run == its eager twin in completions, statuses, "
        f"{', '.join(SERVE_MESH_ATTRS)}, launch counts and cache bytes"
        f"{' from block 1' if kind == 'paged' else ''}")
    _teacher_forced_all(torch, label, cfg, params, _greedy_dicts(reqs), comps, cfg.dtype, tol)
    equal = sum(single[x.request_id] == x.generated for x in comps)
    log(f"{label}: {equal}/{len(comps)} streams equal to the single-card engine's (each rank's "
        f"products run at M 2 where the single card's run at M 8: near ties may flip)")
    if c["host_syncs"] != c["bursts"]:
        raise AssertionError(f"{label}: {c['host_syncs']} host syncs for {c['bursts']} bursts")
    generated = sum(len(x.generated) for x in comps)
    walls = [r["wall"] for r in results]
    steps = head["decode_steps"] or c["bursts"] * SERVE_MESH["sync_interval"]
    log(f"{label}: {generated} tokens in {np.median(walls):.2f} s graphed, "
        f"{np.median([r['eager_wall'] for r in results]):.2f} s eager (median over ranks); "
        f"{np.median(walls) / steps * 1e3:.2f} ms a decode step on the host clock over "
        f"{steps} steps, admissions included (4 ranks sharing one card: not a scaling figure; "
        f"{card})")
    bursts = c["bursts"]
    sent = [r["comm"]["all_gather"] / bursts for r in results]
    host = [r["host"]["all_gather"] / bursts for r in results]
    log(f"{label}: the burst's trace gather per rank: {' '.join(f'{x:.0f}' for x in sent)} B "
        f"sent a burst, {' '.join(f'{x:.0f}' for x in host)} B a burst copied to the host")
    log(f"{label}: first-token broadcasts per rank: "
        f"{' '.join(str(r['comm']['broadcast']) for r in results)} B sent in all (the "
        f"admissions of the slots a rank holds)")
    log(f"{label}: host_syncs a burst {c['host_syncs'] / bursts:.3g} ({c['host_syncs']} over "
        f"{bursts} bursts)")
    for rank, r in enumerate(results):
        pools = sum(p for _, p, _ in r["graphs"].values())
        log(f"{label}: rank {rank}: {len(r['graphs'])} graphs ({', '.join(f'{n!r} {calls} calls' for n, (calls, _, _) in r['graphs'].items())}), pools {pools / 2**20:.2f} MiB, "
            f"peak memory {r['peak'] / 2**30:.2f} GiB, append launches {r['append']}")
        if not 0 < len(r["graphs"]) <= r["graph_bound"]:
            raise AssertionError(f"{label}: rank {rank} has {len(r['graphs'])} graphs")
        if any(calls >= 2 and not captured for calls, _, captured in r["graphs"].values()):
            raise AssertionError(f"{label}: rank {rank}: a graph called twice was never captured")
    launches = sum(r["append"] for r in results)
    if kind == "paged" and not all(r["append"] for r in results):
        raise AssertionError(f"{label}: a rank never launched the append kernel")
    log(f"{label}: append launches summed over ranks {launches}")
    return launches


def phase_serve_mesh(torch, cfg, params, reqs, *, card, tol=0.25):
    """Slot-sharded serving ("serve mesh"): the append kernel at the
    sharded batch (B 2), then four ranks on the one card on a gloo group
    (one ``RankPool``): the paged engine over ``MeshShape(data=4)``
    (``SERVE_MESH``) at ``cfg`` in bf16 on the serving run's 16 requests,
    then the dense engine in f32 at 2 layers on 8 requests (gated at
    1e-3).  Returns the append launches summed over the ranks."""
    from k8s_dra_driver_torch.models import burnin, serve
    from k8s_dra_driver_torch.parallel.ranks import RankPool

    label = "serve mesh"
    _append_at_batch_2(torch, label)
    cfg32 = dataclasses.replace(cfg, n_layers=SERVE_MESH_F32["n_layers"], dtype=torch.float32)
    p32 = burnin.init_params(torch.Generator(device=DEV).manual_seed(SEED + 1), cfg32)
    reqs32 = _traffic(cfg32.vocab_size, SERVE_MESH_F32["requests"], 256, 64, SEED + 1)
    single32 = {c.request_id: c.generated for c in serve.ServeEngine(
        params=p32, cfg=cfg32, cache_dtype=torch.float32, device=DEV, **SERVE_MESH).pump(reqs32)}
    if DEV == "cuda":
        torch.cuda.empty_cache()
    with RankPool(4, backend="gloo", device_type=DEV, timeout_s=600) as pool:
        sub = f"{label} paged bf16 {SERVE_MESH_LAYOUT[1]} L={cfg.n_layers}"
        t1 = time.perf_counter()
        results = pool.run(serve_mesh_rank, "paged", cfg, SEED, reqs, DEV)
        log(f"{sub}: {time.perf_counter() - t1:.1f} s (the 4 gloo ranks started in it)")
        launches = _serve_mesh_report(torch, sub, results, "paged", cfg, params, reqs,
                                      SERVED["serve bf16"], tol, card)
        sub = f"{label} dense f32 {SERVE_MESH_LAYOUT[1]} L={cfg32.n_layers}"
        t1 = time.perf_counter()
        results = pool.run(serve_mesh_rank, "dense", cfg32, SEED + 1, reqs32, DEV)
        log(f"{sub}: {time.perf_counter() - t1:.1f} s")
        _serve_mesh_report(torch, sub, results, "dense", cfg32, p32, reqs32, single32, 1e-3, card)
    return launches


# "entry point": the dry run over 8 ranks, the size that runs every leg
ENTRY_DRYRUN_RANKS = 8
# the lines the JAX package's dry run prints at 8 devices, each loss masked
ENTRY_DRYRUN_LINES = (
    "dryrun_multichip: mesh data=1 seq=2 model=4 loss=<masked>",
    "dryrun_multichip: mesh data=1 seq=2 model=4 (gqa kv=2 + rope) loss=<masked>",
    "dryrun_multichip: mesh pipe=2 data=2 model=2 (pipeline, megatron) loss=<masked>",
    "dryrun_multichip: mesh pipe=2 data=2 model=2 (pipeline, megatron-sp) loss=<masked>",
    "dryrun_multichip: mesh pipe=2 data=2 model=2 (pipeline, gqa kv=2 + rope, megatron) "
    "loss=<masked>",
    "dryrun_multichip: mesh pipe=2 data=2 model=2 (pipeline, gqa kv=2 + rope, megatron-sp) "
    "loss=<masked>",
    "dryrun_multichip: mesh slice=2 data=2 model=2 (multislice hybrid-dp over dcn) "
    "loss=<masked>",
    "dryrun_multichip: mesh expert=8 (top-2 moe grad) ok",
    "dryrun_multichip: mesh model=8 (overlapped tp-mlp grad) ok",
    "dryrun_multichip: mesh data=8 (sharded serving, 32 tokens) ok",
    "dryrun_multichip: mesh data=8 (sharded PAGED serving + spec + lora, 32 tokens, bit-equal "
    "single-device) ok",
    "dryrun_multichip: mesh data=8 (MoE top-2 serving, 32 tokens, bit-equal single-device) ok",
    "dryrun_multichip: mesh slice=2 (multislice DP serving over ('slice','data'), 16 tokens, "
    "bit-equal single-slice) ok",
)
# the dry run's kernel counters as kernels-line rows (None: the flash
# wrapper's per-pass totals, which repeat its per-kernel counts)
POD_KERNEL_ROWS = {
    "flash_attention:flash_fwd": None, "flash_attention:flash_bwd_dq": None,
    "flash_attention:flash_bwd_dkv": None,
    "flash_attention:flash_fwd_wgmma": "flash_fwd", "flash_attention:flash_fwd_fma": "flash_fwd_f32",
    "flash_attention:flash_bwd_dq_wgmma": "flash_bwd_dq",
    "flash_attention:flash_bwd_dq_fma": "flash_bwd_dq_f32",
    "flash_attention:flash_bwd_dkv_wgmma": "flash_bwd_dkv",
    "flash_attention:flash_bwd_dkv_fma": "flash_bwd_dkv_f32",
    "paged_attention:append": "paged_attention", "paged_attention:window": "paged_attention_window",
}


WANT_DEMO = dict(completed=4, generated_tokens=36, sharded_over=0)


def _demo_gates(sub, summary, shards):
    """The consumer demo's summary: 4 requests, 36 tokens, sharded over
    ``shards``, a prefix hit and free blocks left."""
    log(f"{sub}: summary {json.dumps(summary, sort_keys=True)}")
    bad = {k: summary.get(k) for k, v in dict(WANT_DEMO, sharded_over=shards).items()
           if summary.get(k) != v}
    if bad or not summary["prefix_block_hits"] > 0 or not summary["pool_free_blocks"] > 0:
        raise AssertionError(f"{sub}: the demo's summary is off: {summary}")


def _demo_stderr(sub, err: str) -> dict:
    """The consumer's stderr line after its demo: ``serve_demo_seconds``
    and ``kernel_launches`` by ``module:kernel``."""
    for line in reversed(err.strip().splitlines()):
        if line.startswith('{"kernel_launches"'):
            doc = json.loads(line)
            log(f"{sub}: the demo took {doc['serve_demo_seconds']:.2f} s in the child, "
                f"launches {doc['kernel_launches']}")
            return doc
    raise AssertionError(f"{sub}: no launch line on the consumer's stderr:\n{err[-2000:]}")


def _pod_command(args, env_extra: dict, timeout: float = 600):
    """``python -m <args>`` from the repository root in an environment
    without the claim variables of this process, plus ``env_extra``:
    (exit code, stdout, stderr, seconds)."""
    import os
    from pathlib import Path

    root = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "MEGASCALE_", "JAX_COORDINATOR")) and k != "LOCAL_RANK"}
    env["PYTHONPATH"] = os.pathsep.join(x for x in (str(root), env.get("PYTHONPATH", "")) if x)
    env.update(env_extra)
    if DEV == "cpu":  # a rehearsal on the CPU
        args = [*args, "--device", "cpu"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr, time.perf_counter() - t0


def _demo_streams_held(torch, label, params, streams, cache_dtype, tol):
    """Every token of the demo's streams teacher-forced against the plain
    dense path (the bank's adapter adds zeros: its B starts at 0)."""
    import types

    from k8s_dra_driver_torch import consumer
    from k8s_dra_driver_torch.models import burnin

    cfg = burnin.ModelConfig(**consumer.DEMO_CFG)
    reqs = {rid: dict(prompt=list(p), max_tokens=m) for rid, (p, m, _) in
            enumerate(consumer.DEMO_REQUESTS)}
    comps = [types.SimpleNamespace(request_id=rid, generated=gen, tokens=reqs[rid]["prompt"] + gen)
             for rid, gen in sorted(streams.items())]
    _teacher_forced_all(torch, label, cfg, params, None, comps, cache_dtype, tol, by_id=reqs,
                        why=f"{cfg.dtype} weights and activations rounded at other places by "
                            f"the paged kernel and the engine's batched products than by the "
                            f"batch-1 dense path; the pool and the dense cache {cache_dtype}")


def pod_demo_rank(dev: str) -> dict:
    """Leg (d) on one of two ranks sharing the card: ``consumer.serve_demo``
    over ``MeshShape(data=2)``, the append count zeroed just before."""
    from k8s_dra_driver_torch import consumer
    from k8s_dra_driver_torch.ops import paged_attention as pa
    from k8s_dra_driver_torch.parallel import mesh as pm

    torch = _leg_setup(dev)
    mesh = pm.build_mesh([0, 1], pm.MeshShape(data=2), dev)
    sync(torch)
    pa.add_launch_counts({k: -n for k, n in pa.launch_counts().items()})
    t0 = time.perf_counter()
    summary, streams = consumer.serve_demo(dev, mesh=mesh)
    sync(torch)
    return dict(summary=summary, streams=streams, seconds=time.perf_counter() - t0,
                append=pa.launches["append"])


def _tiny_layer0_heads(torch, n_model: int):
    """The dry run's first leg, layer 0, on rank 0 of ``(model n)``: its
    attention inputs q, k, v ``[B·H_rank, S, 16]``, recomputed here (the
    whole model drawn from seed 0 as every rank draws it, tokens from seed
    1, rank 0's heads of ``TINY``'s 8, through the whole projection where
    the rank multiplies by its columns)."""
    from k8s_dra_driver_torch.models import burnin
    from k8s_dra_driver_torch.ops import flash_attention as fa

    cfg = burnin.TINY
    params = burnin.init_params(torch.Generator(device=DEV).manual_seed(0), cfg)
    tokens = burnin.sample_tokens(torch.Generator(device=DEV).manual_seed(1), cfg, 4, 64)
    with torch.no_grad():
        x = params["embed"][tokens] + params["pos_embed"][:64]
        q, k, v = burnin.qkv_proj(x, params["blocks"][0], cfg)
    heads = slice(0, cfg.n_heads // n_model)
    return tuple(fa.to_bh(t[:, :, heads].contiguous()) for t in (q, k, v))


def _flash_at_d16(torch, label, n_model: int) -> dict:
    """The flash forward, dQ and dK/dV at D 16 in bf16 on the dry run's
    first leg's layer-0 inputs (rank 0's heads of ``(model n_model)``):
    causal over the whole sequence, and in the ring's mode on its two
    halves (the forward's f32 partials, the backward with the merge's
    global lse: what the leg runs over ``seq`` 2), each elementwise against
    its plain version (``FLASH_STEP``).  Returns the worst error by
    kernels-line row."""
    from k8s_dra_driver_torch.ops import flash_attention as fa

    q, k, v = _tiny_layer0_heads(torch, n_model)
    bh, s, d = q.shape
    dout = torch.randn(q.shape, generator=torch.Generator(device=DEV).manual_seed(SEED + 23),
                       device=DEV).to(q.dtype)
    step = FLASH_STEP[str(q.dtype).split(".")[-1]][0]
    out, lse = fa._forward_bhsd(q, k, v, True)
    out_p, lse_p = fa.flash_forward_plain(q, k, v, True)
    grads = fa._backward_bhsd(q, k, v, out_p, lse_p, dout, True)
    want = (out_p, lse_p, *fa.flash_backward_plain(q, k, v, out_p, lse_p, dout, True))
    sync(torch)
    rows = flash_check((out, lse, *grads), want, flash_limits(q, k, v, dout, True, want, step))
    _check_rows(f"{label} flash as the leg calls it, bf16 BH={bh} S={s} D={d} causal=True", rows)
    worst = {"flash_fwd": rows["out"][0], "flash_bwd_dq": rows["dq"][0],
             "flash_bwd_dkv": max(rows["dk"][0], rows["dv"][0])}
    half = s // 2
    ring = flash_ring_mode(torch, bh, half, d, operands=(
        q[:, half:].contiguous(), k[:, half:].contiguous(), v[:, half:].contiguous(),
        k[:, :half].contiguous(), v[:, :half].contiguous(), dout[:, half:].contiguous()))
    return {n: max(worst[n], ring[n]) for n in worst}


def phase_pod_entry_points(torch, card, tol=0.25):
    """The pod's own entry points ("pod entry points"), each leg timed: (a)
    ``python -m k8s_dra_driver_torch.consumer --check --serve-demo`` with
    ``TPU_VISIBLE_DEVICES=0``; (b) ``--check`` on a claim of cards 0,1 on
    this one card: exit 1, "DEVICE MISMATCH", before any process group;
    (c) ``consumer.serve_demo`` in this process, every token teacher-forced,
    the append kernel at nq 1 and nq 3 held against its plain version on
    each layer's first window; (d) the demo on 2 gloo ranks sharing the
    card over ``MeshShape(data=2)``, every token teacher-forced, the streams
    equal to (c)'s counted.  (The dry run runs at 8 ranks in "entry
    point", :func:`phase_entry_point`.)  Returns the launches by
    kernels-line row."""
    from k8s_dra_driver_torch import consumer
    from k8s_dra_driver_torch.models import burnin, lora
    from k8s_dra_driver_torch.ops import paged_attention as pa
    from k8s_dra_driver_torch.parallel.ranks import RankPool

    label = "pod entry points"
    total: dict = {}

    sub = f"{label} (a) consumer --check --serve-demo, TPU_VISIBLE_DEVICES=0"
    rc, out, err, secs = _pod_command(["k8s_dra_driver_torch.consumer", "--check",
                                       "--serve-demo"], {"TPU_VISIBLE_DEVICES": "0"})
    log(f"{sub}: exit {rc} in {secs:.1f} s; stdout:\n" + out.rstrip())
    if rc != 0:
        raise AssertionError(f"{sub}: exit {rc}; stderr tail:\n{err[-3000:]}")
    _demo_gates(sub, json.loads(out.strip().splitlines()[-1])["serve_demo"], 0)

    sub = f"{label} (b) consumer --check --serve-demo, TPU_VISIBLE_DEVICES=0,1 on one card"
    rc, out, err, secs = _pod_command(["k8s_dra_driver_torch.consumer", "--check",
                                       "--serve-demo"], {"TPU_VISIBLE_DEVICES": "0,1"}, 120)
    log(f"{sub}: exit {rc} in {secs:.1f} s; stderr: {err.strip()}")
    if rc != 1 or "DEVICE MISMATCH" not in err or "Traceback" in err or "serve_demo" in out:
        raise AssertionError(f"{sub}: want exit 1 with DEVICE MISMATCH before any group; got "
                             f"{rc}, stdout {out!r}, stderr {err[-2000:]!r}")

    sub = f"{label} (c) serve_demo on the card"
    cfg = burnin.ModelConfig(**consumer.DEMO_CFG)
    params = burnin.init_params(torch.Generator(device=DEV).manual_seed(0), cfg)
    lcfg = lora.LoraConfig(rank=4)
    gen = torch.Generator(device=DEV).manual_seed(7)
    bank = lora.stack_adapters(cfg, lcfg, [lora.init_adapters(gen, cfg, lcfg)])
    if any(blk[t]["b"].abs().max().item() for blk in bank["blocks"] for t in blk):
        raise AssertionError(f"{sub}: the demo's adapter has a nonzero B")
    recs = {}
    restores = []
    for nq in (1, 1 + consumer.DEMO_ENGINE["spec_gamma"]):
        recs[nq], restore = _record_append_windows(torch, pa, nq)
        restores.append(restore)
    pa.add_launch_counts({k: -n for k, n in pa.launch_counts().items()})
    t0 = time.perf_counter()
    try:
        summary, single = consumer.serve_demo(DEV, params=params, bank=bank)
        sync(torch)
    finally:
        for restore in reversed(restores):
            restore()
    appends = pa.launches["append"]
    log(f"{sub}: {time.perf_counter() - t0:.1f} s, append launches {appends}")
    _demo_gates(sub, summary, 0)
    pool_dtype = next(iter(recs[1].values()))[3].dtype
    _demo_streams_held(torch, sub, params, single, pool_dtype, tol)
    for nq, rec in recs.items():
        _hold_append_windows(torch, f"{sub} nq {nq}", pa, rec, cfg, pool_dtype)
    if not appends:
        raise AssertionError(f"{sub}: the append kernel was never launched")
    total["paged_attention"] = appends

    sub = f"{label} (d) serve_demo on 2 gloo ranks sharing the card, MeshShape(data=2)"
    t0 = time.perf_counter()
    with RankPool(2, backend="gloo", device_type=DEV, timeout_s=600) as pool:
        results = pool.run(pod_demo_rank, DEV)
    log(f"{sub}: {time.perf_counter() - t0:.1f} s (the 2 ranks started in it); the demo "
        f"{' / '.join(f'{r['seconds']:.1f}' for r in results)} s by rank; append launches "
        f"{' '.join(str(r['append']) for r in results)} by rank")
    head = results[0]
    if results[1]["streams"] != head["streams"] or results[1]["summary"] != head["summary"]:
        raise AssertionError(f"{sub}: the two ranks' streams or summaries differ")
    _demo_gates(sub, head["summary"], 2)
    _demo_streams_held(torch, sub, params, head["streams"], pool_dtype, tol)
    equal = sum(head["streams"][rid] == single[rid] for rid in single)
    log(f"{sub}: {equal}/{len(single)} streams equal to (c)'s single-card streams (a rank's "
        f"products run at M 1, the single card's at M 2: near ties may flip)")
    if not all(r["append"] for r in results):
        raise AssertionError(f"{sub}: a rank never launched the append kernel")
    total["paged_attention"] += sum(r["append"] for r in results)
    return total


# "driver node": the driver's node half on the card.  The enumeration
# child imports no torch; the time-sliced consumers hold the lease around
# TS_WORK matmuls of TS_SIZE x TS_SIZE in bf16 (about 0.25 s on an H100)
ENUM_CHILD = r"""
import dataclasses, json, sys, time
from k8s_dra_driver_torch.tpuinfo import binding
t0 = time.perf_counter()
topo = binding.enumerate_topology()
t1 = time.perf_counter()
binding.enumerate_topology()
t2 = time.perf_counter()
print(json.dumps({"topology": dataclasses.asdict(topo), "cold_ms": (t1 - t0) * 1e3,
                  "warm_ms": (t2 - t1) * 1e3, "torch": "torch" in sys.modules}), flush=True)
sys.stdin.readline()  # held open while the parent looks for a context
"""
TS_SIZE, TS_WORK = 4096, 1000
TS_CHILD = r"""
import json, sys, time
import torch
from k8s_dra_driver_torch import consumer
ctx = consumer.attach(init_distributed=False)
dev = torch.device(sys.argv[2])
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
a = torch.randn(%(n)d, %(n)d, device=dev, dtype=torch.bfloat16)
for _ in range(3):
    a @ a
sync()
print(json.dumps({"ready": True}), flush=True)
sys.stdin.readline()  # the go: both children ask for the lease together
asked = time.time()
with ctx.lease(consumer_id=sys.argv[1]) as grant:
    t0 = time.time()
    for _ in range(%(work)d):
        a @ a
    sync()
    t1 = time.time()
print(json.dumps({"asked": asked, "t0": t0, "t1": t1, "grant": grant,
                  "strategy": ctx.sharing_strategy}), flush=True)
""" % {"n": TS_SIZE, "work": TS_WORK}
CUDA_NODES = ("/dev/nvidiactl", "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools")


def _smi_cards() -> list[dict]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,uuid,pci.bus_id,memory.total,name",
         "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=30)
    cards = []
    for line in out.stdout.strip().splitlines():
        index, uuid, bus, mem, name = [x.strip() for x in line.split(",")]
        # a sandboxed nvidia-smi may print "[N/A]" for the bus id: torch's is checked too
        cards.append(dict(index=int(index), uuid=uuid.lower(),
                          pci=bus.lower()[-12:] if ":" in bus else None,
                          mem_mib=int(mem), name=name))
    return cards


def _compute_pids() -> list[int]:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return [int(x) for x in out.stdout.split() if x.strip().isdigit()]


def _child_env() -> dict:
    import os
    from pathlib import Path

    root = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "TPUINFO_", "MEGASCALE_", "JAX_COORDINATOR"))
           and k != "LOCAL_RANK"}
    env["PYTHONPATH"] = os.pathsep.join(x for x in (str(root), env.get("PYTHONPATH", "")) if x)
    return env


def _driver_enumeration(torch, label, card) -> dict:
    """Leg (a): real-mode enumeration in a child that never imports torch,
    against nvidia-smi and torch; the child holds no context while alive."""
    import os

    from k8s_dra_driver_torch.tpuinfo import binding

    sub = f"{label} (a) enumeration"
    t0 = time.perf_counter()
    binding.library_path().unlink(missing_ok=True)
    binding.build()
    build_ms = (time.perf_counter() - t0) * 1e3
    free_before = torch.cuda.mem_get_info(0)[0]
    child = subprocess.Popen([sys.executable, "-c", ENUM_CHILD], env=_child_env(),
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        line = child.stdout.readline()
        if not line:
            raise AssertionError(f"{sub}: the child printed nothing: {child.stderr.read()[-2000:]}")
        doc = json.loads(line)
        pids = _compute_pids()
        free_during = torch.cuda.mem_get_info(0)[0]
    finally:
        child.stdin.close()
        child.wait(timeout=60)
    topo = doc["topology"]
    log(f"{sub}: shim built in {build_ms:.0f} ms; enumeration cold {doc['cold_ms']:.2f} ms, "
        f"warm {doc['warm_ms']:.3f} ms ({card}); {json.dumps(topo)}")
    log(f"{sub}: compute apps {pids} (this process {os.getpid()}, the child {child.pid}); "
        f"the card's free memory {free_before / 2**20:.0f} MiB before the child, "
        f"{free_during / 2**20:.0f} MiB while it lived")
    if doc["torch"]:
        raise AssertionError(f"{sub}: the enumeration child imported torch")
    if child.pid in pids or free_before - free_during > 64 * 2**20:
        raise AssertionError(f"{sub}: the enumeration child holds a context on the card")
    smi = _smi_cards()
    n = torch.cuda.device_count()
    if topo["mode"] != "real" or len(topo["chips"]) != n or len(smi) != n:
        raise AssertionError(f"{sub}: {len(topo['chips'])} cards enumerated, torch sees {n}, "
                             f"nvidia-smi {len(smi)}")
    if topo["dims"] != [n, 1, 1] or topo["host_count"] != 1 or topo["topology"] != f"{n}x1":
        raise AssertionError(f"{sub}: not an {n} x 1 slice: {topo}")
    by_pci = {}
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        pci = f"{getattr(p, 'pci_domain_id', 0):04x}:{getattr(p, 'pci_bus_id', 0):02x}:" \
              f"{getattr(p, 'pci_device_id', 0):02x}.0"
        by_pci[pci] = p
    for chip, want in zip(topo["chips"], smi):  # both in PCI bus order
        p = by_pci.get(chip["pci_address"])
        if p is None and n == 1 and not hasattr(torch.cuda.get_device_properties(0),
                                                "pci_bus_id"):
            p = torch.cuda.get_device_properties(0)  # this torch reports no PCI address
        torch_uuid = str(getattr(p, "uuid", "")).lower().removeprefix("gpu-")
        checks = {
            "uuid": chip["uuid"].lower() == want["uuid"],
            "pci": want["pci"] in (None, chip["pci_address"]),
            "torch pci": p is not None,
            "memory": p is not None and chip["hbm_bytes"] == p.total_memory,
            "smi memory": abs(chip["hbm_bytes"] / 2**20 - want["mem_mib"]) < 0.02 * want["mem_mib"],
            "sms": p is not None and chip["cores"] == p.multi_processor_count,
            "torch uuid": len(torch_uuid) != 36 or chip["uuid"].lower() == f"gpu-{torch_uuid}",
            "node": os.path.exists(chip["device_path"]),
            "healthy": chip["healthy"] and not chip["health_reason"],
        }
        log(f"{sub}: {chip['device_path']} {chip['uuid']} {chip['pci_address']} "
            f"{chip['hbm_bytes']} B (nvidia-smi {want['mem_mib']} MiB) {chip['cores']} SMs: "
            f"{checks}")
        if not all(checks.values()):
            raise AssertionError(f"{sub}: the enumeration disagrees: {checks}")
    return {"build_ms": build_ms, "cold_ms": doc["cold_ms"], "warm_ms": doc["warm_ms"]}


class _StubRun:
    def __init__(self, report):
        self._report = report

    def cancel(self):
        pass

    def result(self):
        return self._report


def _card_health(server, name) -> tuple:
    for s in server.list("ResourceSlice"):
        for d in s.spec.devices:
            if d.name == name:
                attrs = d.basic.attributes
                return (attrs["healthy"].value,
                        attrs["healthReason"].value if "healthReason" in attrs else "")
    raise AssertionError(f"no published device {name}")


def _claim(objects, name, uid, device, config=None):
    """A claim as kube-scheduler leaves it: one result on this node's pool."""
    doc = {"apiVersion": "resource.k8s.io/v1beta1", "kind": "ResourceClaim",
           "metadata": {"name": name, "namespace": "default", "uid": uid},
           "spec": {"devices": {"requests": [{"name": "gpu",
                                              "deviceClassName": "tpu.google.com"}]}},
           "status": {"allocation": {"devices": {
               "results": [{"request": "gpu", "driver": "tpu.google.com", "pool": "node-0",
                            "device": device}],
               "config": [] if config is None else [{
                   "source": "FromClaim", "requests": [],
                   "opaque": {"driver": "tpu.google.com", "parameters": config}}]}}}}
    return objects.from_json(doc)


def _claim_container(cdi_root, uid, cdi_ids) -> tuple[dict, list]:
    """What a CDI runtime gives the claim's container: the environment
    (the base spec's common edits, then each named device's) and the
    device nodes of every CDI id the claim's result names."""
    from pathlib import Path

    specs = [json.loads(p.read_text()) for p in sorted(Path(cdi_root).glob("*.json"))]
    base = next(s for s in specs if "containerEdits" in s)
    env = dict(e.split("=", 1) for e in base["containerEdits"].get("env", []))
    nodes = []
    for cdi_id in cdi_ids:
        name = cdi_id.split("=", 1)[1]
        (dev,) = [d for s in specs for d in s["devices"] if d["name"] == name]
        edits = dev["containerEdits"]
        env.update(dict(e.split("=", 1) for e in edits.get("env", [])))
        nodes += [n["path"] for n in edits.get("deviceNodes", []) if n["path"] not in nodes]
    return env, nodes


def phase_driver_node(torch, card):
    """The driver's node half on the card ("driver node"), each leg timed:
    (a) the shim built, then real-mode enumeration in a child without
    torch, against nvidia-smi and torch (count, UUID, memory, SMs, PCI
    address, node present and healthy), the child holding no context on
    the card (``nvidia-smi --query-compute-apps``, the card's free memory);
    (b) ``Driver`` publishing into the port's in-memory API server, the
    slice printed; (c) the self-test sweep on the idle card (the overlay
    stays empty), then a stub report failing card 0: published unhealthy
    ``selftest-failed`` and its prepare refused; a passing stub restores
    it; (d) a one-card claim written as kube-scheduler would, prepared:
    the CDI ids' device nodes exist, the consumer child with the spec's
    environment exits 0 from ``--check --serve-demo`` with "pod entry
    points" (a)'s gates and its append launches counted, twice, in turns
    with (a)'s command (the faster prepared demo within 1.25 x + 0.5 s of
    the faster plain one), unprepare removes the spec and the checkpoint
    entry; (e) a TimeSlicing claim (interval Long, a 20 ms
    quantum) with the port's host-mode daemon as a process: two consumer
    children hold ``lease()`` around ``TS_WORK`` matmuls, their host-clock
    spans do not overlap.  Returns the launches by kernels-line row."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from k8s_dra_driver_torch.kube import objects
    from k8s_dra_driver_torch.kube.fakeserver import InMemoryAPIServer
    from k8s_dra_driver_torch.plugin import driver as pdriver
    from k8s_dra_driver_torch.tpuinfo import selftest

    label = "driver node"
    if DEV == "cpu":  # a rehearsal: a fake host of 4 chips, no enumeration leg
        os.environ["TPUINFO_FAKE_TOPOLOGY"] = "v5e-4"
        times = {}
    else:
        os.environ.pop("TPUINFO_FAKE_TOPOLOGY", None)  # the card, never a fake topology
        times = _driver_enumeration(torch, label, card)

    sub = f"{label} (b) publish"
    tmp = Path(tempfile.mkdtemp(prefix="driver-node-"))
    server = InMemoryAPIServer()
    t0 = time.perf_counter()
    drv = pdriver.Driver(server, pdriver.DriverConfig(
        node_name="node-0", cdi_root=str(tmp / "cdi"), checkpoint_path=str(tmp / "cp.json"),
        socket_dir=str(tmp / "s"), publish=False, selftest_interval_s=3600.0))
    times["driver_init_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    if not drv.publish_resources():
        raise AssertionError(f"{sub}: publishing failed")
    times["publish_ms"] = (time.perf_counter() - t0) * 1e3
    drv.config.publish = True  # the sweeps below republish on change
    (published,) = server.list("ResourceSlice")
    log(f"{sub}: Driver() {times['driver_init_ms']:.1f} ms (enumeration and the base CDI spec), "
        f"publish {times['publish_ms']:.2f} ms ({card}); the slice: "
        f"{json.dumps(objects.to_json(published))}")
    chips = drv.state.topology.chips
    cards = [d for d in published.spec.devices if d.basic.attributes["type"].value == "tpu"]
    if len(cards) != len(chips) or {d.basic.attributes["uuid"].value for d in cards} != \
            {c.uuid for c in chips}:
        raise AssertionError(f"{sub}: the slice's cards are not the enumerated ones")
    first = f"tpu-{chips[0].index}"

    sub = f"{label} (c) self-test sweep"
    reports = []
    real_start = selftest.start_selftest

    def recorded(**kw):
        run = real_start(**kw, device=DEV)
        result = run.result

        def keep():
            reports.append(result())
            return reports[-1]

        run.result = keep
        return run

    drv._selftest_join_grace_s = 300.0  # the probe folds into this sweep
    selftest.start_selftest = recorded
    try:
        t0 = time.perf_counter()
        drv.refresh_inventory()
        times["selftest_sweep_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        selftest.start_selftest = real_start
    (report,) = reports
    log(f"{sub}: the sweep took {times['selftest_sweep_ms']:.0f} ms with the probe ({card}); "
        f"report {json.dumps(report, sort_keys=True)}")
    times["probe_latency_ms"] = [d.get("latency_ms") for d in report.get("devices", [])]
    if not report.get("ok") or report.get("platform") != ("gpu" if DEV == "cuda" else "cpu") \
            or drv.state._health_overlay \
            or _card_health(server, first) != (True, ""):
        raise AssertionError(f"{sub}: the idle card did not pass: {report}, overlay "
                             f"{drv.state._health_overlay}")
    n = len(chips)
    outcomes = []
    for oks in ([False] + [True] * (n - 1), [True] * n):
        selftest.start_selftest = lambda **kw: _StubRun({  # noqa: E731
            "ok": all(oks), "platform": "gpu",
            "devices": [{"id": i, "platform": "gpu", "ok": ok} for i, ok in enumerate(oks)]})
        try:
            drv._last_selftest = 0.0
            drv.refresh_inventory()
        finally:
            selftest.start_selftest = real_start
        claim = server.create(_claim(objects, f"probe-{len(outcomes)}",
                                     f"uid-probe-{len(outcomes)}", first))
        res = drv.node_prepare_resources([pdriver.ClaimRef(
            claim.metadata.uid, claim.metadata.name, "default")])[claim.metadata.uid]
        drv.node_unprepare_resources([pdriver.ClaimRef(
            claim.metadata.uid, claim.metadata.name, "default")])
        outcomes.append((_card_health(server, first), res.error))
    log(f"{sub}: a failing stub report: {outcomes[0]}; a passing one: {outcomes[1]}")
    if outcomes[0][0] != (False, "selftest-failed") or "unhealthy" not in outcomes[0][1] \
            or outcomes[1] != ((True, ""), ""):
        raise AssertionError(f"{sub}: the overlay did not fence and restore the card: "
                             f"{outcomes}")

    sub = f"{label} (d) prepared consumer"
    claim = server.create(_claim(objects, "demo", "uid-demo", first))
    ref = pdriver.ClaimRef("uid-demo", "demo", "default")
    t0 = time.perf_counter()
    res = drv.node_prepare_resources([ref])["uid-demo"]
    times["prepare_ms"] = (time.perf_counter() - t0) * 1e3
    if res.error:
        raise AssertionError(f"{sub}: prepare failed: {res.error}")
    env, nodes = _claim_container(tmp / "cdi", "uid-demo", res.devices[0]["cdi_device_ids"])
    log(f"{sub}: prepared in {times['prepare_ms']:.2f} ms ({card}): {res.devices}; "
        f"environment {env}; device nodes {nodes}")
    missing = [p for p in nodes if not os.path.exists(p)]
    want_nodes = [chips[0].device_path] + [p for p in CUDA_NODES if os.path.exists(p)]
    if DEV == "cpu":  # a fake topology's nodes do not exist
        missing = []
    if missing or nodes != want_nodes or env.get("TPU_VISIBLE_DEVICES") != str(chips[0].index):
        raise AssertionError(f"{sub}: the spec's nodes {nodes} (missing {missing}) or its "
                             f"environment {env} are off")
    # the demo as "pod entry points" (a) runs it and in the claim's
    # environment, in turns: the host's noise moves both alike
    seconds: dict = {"plain": [], "prepared": []}
    appends = 0
    for which in ("plain", "prepared", "prepared", "plain"):
        rc, out, err, secs = _pod_command(
            ["k8s_dra_driver_torch.consumer", "--check", "--serve-demo"],
            env if which == "prepared" else {"TPU_VISIBLE_DEVICES": "0"})
        log(f"{sub} [{which}]: exit {rc} in {secs:.1f} s; stdout:\n" + out.rstrip())
        if rc != 0:
            raise AssertionError(f"{sub} [{which}]: exit {rc}; stderr tail:\n{err[-3000:]}")
        _demo_gates(f"{sub} [{which}]", json.loads(out.strip().splitlines()[-1])["serve_demo"], 0)
        demo = _demo_stderr(f"{sub} [{which}]", err)
        seconds[which].append(demo["serve_demo_seconds"])
        if which == "prepared":
            n = demo["kernel_launches"].get("paged_attention:append", 0)
            if not n and DEV == "cuda":
                raise AssertionError(f"{sub}: the append kernel was never launched")
            appends += n
    times["demo_s"] = seconds
    limit = 1.25 * min(seconds["plain"]) + 0.5
    log(f"{sub}: the demo {seconds['prepared']} s prepared against {seconds['plain']} s as "
        f"pod entry points (a) runs it (limit on the faster prepared run {limit:.2f} s)")
    if min(seconds["prepared"]) > limit:
        raise AssertionError(f"{sub}: the demo is slower in the prepared environment")
    t0 = time.perf_counter()
    res = drv.node_unprepare_resources([ref])["uid-demo"]
    times["unprepare_ms"] = (time.perf_counter() - t0) * 1e3
    checkpoint = json.loads((tmp / "cp.json").read_text())
    if res.error or (tmp / "cdi" / "k8s.tpu.google.com-claim-uid-demo.json").exists() \
            or "uid-demo" in checkpoint["preparedClaims"]:
        raise AssertionError(f"{sub}: unprepare left the claim behind: {res}")
    log(f"{sub}: unprepared in {times['unprepare_ms']:.2f} ms ({card})")

    sub = f"{label} (e) time slicing"
    config = {"apiVersion": "resource.tpu.google.com/v1alpha1", "kind": "TpuConfig",
              "sharing": {"strategy": "TimeSlicing", "timeSlicingConfig": {"interval": "Long"}}}
    server.create(_claim(objects, "shared", "uid-shared", first, config))
    ref = pdriver.ClaimRef("uid-shared", "shared", "default")
    res = drv.node_prepare_resources([ref])["uid-shared"]
    if res.error:
        raise AssertionError(f"{sub}: prepare failed: {res.error}")
    env, _ = _claim_container(tmp / "cdi", "uid-shared", res.devices[0]["cdi_device_ids"])
    log(f"{sub}: environment {env}")
    child_env = _child_env()
    daemon = subprocess.Popen(
        [sys.executable, "-m", "k8s_dra_driver_torch.plugin.topology_daemon", "--host-mode",
         "--socket-dir", str(tmp / "s")], env=child_env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    consumers = []
    try:
        log(f"{sub}: {daemon.stdout.readline().strip()}")
        for name in ("consumer-a", "consumer-b"):
            consumers.append(subprocess.Popen(
                [sys.executable, "-c", TS_CHILD, name, DEV], env={**child_env, **env},
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        for c in consumers:
            if not c.stdout.readline():
                raise AssertionError(f"{sub}: a consumer died: {c.stderr.read()[-2000:]}")
        for c in consumers:
            c.stdin.write("go\n")
            c.stdin.flush()
        spans = []
        for c in consumers:
            line, err = c.communicate(timeout=300)
            if c.returncode != 0:
                raise AssertionError(f"{sub}: a consumer exited {c.returncode}: {err[-2000:]}")
            spans.append(json.loads(line.strip().splitlines()[-1]))
    finally:
        for c in consumers:
            if c.poll() is None:
                c.kill()
        daemon.terminate()
        daemon.wait(timeout=30)
    spans.sort(key=lambda s: s["t0"])
    first_span, second = spans
    times["lease_wait_ms"] = [(s["t0"] - s["asked"]) * 1e3 for s in spans]
    log(f"{sub}: spans {[(round(s['t0'], 4), round(s['t1'], 4)) for s in spans]} (host clock), "
        f"each {[round((s['t1'] - s['t0']) * 1e3, 1) for s in spans]} ms; the lease waits "
        f"{[round(w, 1) for w in times['lease_wait_ms']]} ms ({card}); grants "
        f"{[s['grant'] for s in spans]}")
    if any(s["strategy"] != "time-slicing" for s in spans) or first_span["t1"] > second["t0"]:
        raise AssertionError(f"{sub}: the time-sliced spans overlap: {spans}")
    drv.node_unprepare_resources([ref])
    log(f"{label}: times {json.dumps(times)} ({card})")
    shutil.rmtree(tmp, ignore_errors=True)
    return {"paged_attention": appends}


# "driver loop": the closed loop on the card, from a quickstart spec to a
# consumer running in the prepared claim's environment
LOOP_NODE = "node-0"
LOOP_CYCLES, LOOP_ROUND = 100, 25  # claim-to-prepared cycles a kind, cycles a round


def _loop_claims(server, namespace) -> dict:
    return {c.metadata.name: c for c in server.list("ResourceClaim", namespace=namespace)}


def _http(port: int, path: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read()


def _cycle_ms(samples) -> dict:
    a = np.asarray(samples)
    return {"p50": float(np.percentile(a, 50)), "p99": float(np.percentile(a, 99)),
            "n": int(a.size)}


def _plugin_main_child(label, n_devices, root, card) -> dict:
    """Leg (e)'s last part: ``python -m k8s_dra_driver_torch.plugin.main
    --fake-cluster`` as a child (the card in real mode; a fake host on the
    CPU): it publishes, serves the handshake and ``/healthz`` and exits 0
    on SIGTERM."""
    import re
    import signal
    import threading
    from pathlib import Path

    from k8s_dra_driver_torch.plugin import grpc_service

    sub = f"{label} (e) plugin main"
    args = [sys.executable, "-m", "k8s_dra_driver_torch.plugin.main", "--fake-cluster",
            "--node-name", "node-main", "--cdi-root", str(root / "cdi"),
            "--plugin-path", str(root / "p"), "--registry-path", str(root / "r"),
            "--parted-state-path", str(root / "parted.json"), "--http-port", "0",
            "--cleanup-interval-s", "1"]
    if DEV == "cpu":  # a rehearsal: the fake host of the other legs
        args += ["--fake-topology", "v5e-4", "--fake-host-id", "0"]
    lines: list[str] = []
    t0 = time.perf_counter()
    child = subprocess.Popen(args, env=_child_env(), cwd=Path(__file__).resolve().parent,
                             stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    reader = threading.Thread(target=lambda: lines.extend(child.stderr), daemon=True)
    reader.start()
    try:
        while not any("serving on" in ln for ln in lines):
            if child.poll() is not None or time.perf_counter() - t0 > 120:
                raise AssertionError(f"{sub}: no serving line:\n{''.join(lines)[-3000:]}")
            time.sleep(0.02)
        ready_ms = (time.perf_counter() - t0) * 1e3
        text = "".join(lines)
        published = int(re.search(r"; (\d+) devices published", text)[1])
        port = int(re.search(r"diagnostics on http://127\.0\.0\.1:(\d+)/metrics", text)[1])
        healthz = _http(port, "/healthz")
        client = grpc_service.RegistrationClient(str(root / "r" / "tpu.google.com-reg.sock"))
        try:
            info = client.handshake()
        finally:
            client.close()
        child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    reader.join(timeout=10)
    text = "".join(lines)
    log(f"{sub}: serving {ready_ms:.0f} ms after spawn ({card}); {published} devices "
        f"published; /healthz {healthz!r}; handshake {info.type} {info.name} "
        f"{info.endpoint}; exit {rc} on SIGTERM; stderr:\n{text.rstrip()}")
    if rc != 0 or healthz != b"ok" or published != n_devices or "Traceback" in text \
            or info.endpoint != str(root / "p" / "dra.sock") or "shutting down" not in text:
        raise AssertionError(f"{sub}: the plugin binary misbehaved (exit {rc}, "
                             f"{published} of {n_devices} devices)")
    return {"main_ready_ms": ready_ms}


def _scheduler_throughput(label, card, hosts=4, claims_per_round=16, rounds=6) -> dict:
    """Leg (f): the reference bench's ``run_scheduler_throughput`` shape
    (``bench.py:87``) over the port's allocator: 4 fake v5e-16 hosts, 16
    single-chip claims a round round-robin (every chip taken), then freed;
    round 0 warms the index and the verdict memos."""
    import tempfile

    from k8s_dra_driver_torch.e2e import harness
    from k8s_dra_driver_torch.utils.metrics import REGISTRY

    sub = f"{label} (f) scheduler throughput"
    cluster = harness.make_cluster(hosts=hosts, topology="v5e-16",
                                   work_dir=tempfile.mkdtemp(prefix="driver-loop-sched-"))
    nodes = [f"tpu-host-{i}" for i in range(hosts)]
    labels = {n: cluster.node_labels(n) for n in nodes}
    counters = {k: REGISTRY.counter(f"dra_{k}_total") for k in
                ("cel_evals", "alloc_index_hits", "alloc_index_misses")}

    def one_round(r: int) -> None:
        names = []
        for k in range(claims_per_round):
            node = nodes[k % hosts]
            name = f"thr-{r}-{k}"
            claim = cluster.server.create(harness.simple_claim(name))
            cluster.allocator.allocate(claim, node_name=node, node_labels=labels[node])
            names.append(name)
        for name in names:
            cluster.allocator.deallocate(cluster.server.get("ResourceClaim", name, "default"))
            cluster.server.delete("ResourceClaim", name, "default")

    one_round(0)
    before = {k: c.value() for k, c in counters.items()}
    t0 = time.perf_counter()
    for r in range(1, rounds):
        one_round(r)
    elapsed = time.perf_counter() - t0
    n = (rounds - 1) * claims_per_round
    got = {k: int(c.value() - before[k]) for k, c in counters.items()}
    out = {"allocations": n, "allocations_per_s": n / elapsed,
           "cel_evals_per_allocation": got["cel_evals"] / n, **got}
    log(f"{sub}: {hosts} hosts, {claims_per_round} claims a round, {rounds - 1} steady rounds: "
        f"{out['allocations_per_s']:.1f} allocations/s (host clock, {card}); CEL evaluations "
        f"{got['cel_evals']} ({out['cel_evals_per_allocation']:.3f} an allocation); index hits "
        f"{got['alloc_index_hits']}, misses {got['alloc_index_misses']}")
    if got["cel_evals"] != 0 or got["alloc_index_misses"] != 0 or not got["alloc_index_hits"]:
        raise AssertionError(f"{sub}: the steady rounds re-evaluated selectors or rebuilt pools")
    return out


def phase_driver_loop(torch, card):
    """The closed loop on the card ("driver loop"): one node over the real
    card (the port's ``InMemoryAPIServer`` with ``install_device_classes``,
    a real-mode ``Driver``, the port's ``Allocator`` in ``e2e.harness.
    Cluster``) and a ``DiagnosticsServer`` on port 0.  (a) ``apply_spec``
    of ``tpu-test2`` (two containers sharing a one-chip template claim):
    the DeviceClass's CEL picks exactly the published cards, the allocator
    gives the pod the card, the CDI ids' nodes exist, both containers'
    claim names the card, and the consumer child in the claim's
    environment exits 0 from ``--check --serve-demo`` with "pod entry
    points" (a)'s gates, its append launches counted; (b) ``tpu-test1``'s
    two one-chip pods on one card (a fake host's other chips held): the
    second raises the spec runner's ``SpecError`` after its unwind, its
    claim unallocated and the checkpoint holding the first claim only;
    (c) ``tpu-test3``: deleting ``pod0`` leaves the shared claim prepared,
    deleting ``pod1`` unprepares and deallocates it; (d) a stub self-test
    report fences every card: a one-chip claim fails in the allocator on
    the class's ``healthy == true`` and never reaches the node; a passing
    report restores the cards and the same claim schedules and prepares;
    (g) the diagnostics server's ``/metrics`` carries the allocator's
    families, ``/debug/journal?component=e2e`` the harness's events and
    ``/debug/state`` the prepared claim; (e) the kubelet's face:
    ``PluginServer`` on short sockets, the registration handshake, the
    reference bench's claim-to-prepared cycle (``bench.py:34``) over the
    socket and in process in alternating rounds, the CDI ids over the wire
    equal to the in-process ones, and ``python -m
    k8s_dra_driver_torch.plugin.main --fake-cluster`` as a child; (f) the
    reference bench's scheduler throughput (``bench.py:87``).  Returns the
    launches by kernels-line row."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from k8s_dra_driver_torch.e2e import harness, spec_runner
    from k8s_dra_driver_torch.kube import objects
    from k8s_dra_driver_torch.kube.fakeserver import InMemoryAPIServer
    from k8s_dra_driver_torch.plugin import driver as pdriver
    from k8s_dra_driver_torch.plugin import grpc_service
    from k8s_dra_driver_torch.scheduler import allocator as palloc
    from k8s_dra_driver_torch.tpuinfo import selftest
    from k8s_dra_driver_torch.utils.diagnostics import DiagnosticsServer
    from k8s_dra_driver_torch.utils.metrics import parse_prom_text

    label = "driver loop"
    specs = Path(__file__).resolve().parent / "demo" / "specs" / "quickstart"
    if DEV == "cpu":  # a rehearsal: a fake host of 4 chips
        os.environ["TPUINFO_FAKE_TOPOLOGY"] = "v5e-4"
    else:
        os.environ.pop("TPUINFO_FAKE_TOPOLOGY", None)  # the card, never a fake topology
    tmp = Path(tempfile.mkdtemp(prefix="driver-loop-"))
    sock_root = Path(tempfile.mkdtemp(prefix="dra-", dir="/tmp"))
    server = InMemoryAPIServer()
    harness.install_device_classes(server)
    server.create(objects.Node(metadata=objects.ObjectMeta(
        name=LOOP_NODE, labels={"kubernetes.io/hostname": LOOP_NODE})))
    drv = pdriver.Driver(server, pdriver.DriverConfig(
        node_name=LOOP_NODE, cdi_root=str(tmp / "cdi"), checkpoint_path=str(tmp / "cp.json"),
        socket_dir=str(tmp / "s"), selftest_interval_s=3600.0))
    cluster = harness.Cluster(server=server)
    cluster.nodes[LOOP_NODE] = harness.FakeNode(name=LOOP_NODE, state=drv.state)
    diag = DiagnosticsServer(port=0, bind_host="127.0.0.1", state_provider=lambda: {
        "node": LOOP_NODE, "allocatable": sorted(drv.state.allocatable.devices),
        "prepared_claims": drv.state.prepared_claim_uids()})
    diag.start()
    times: dict = {"allocate_ms": []}
    real_allocate = cluster.allocator.allocate

    def timed_allocate(*args, **kw):
        t0 = time.perf_counter()
        try:
            return real_allocate(*args, **kw)
        finally:
            times["allocate_ms"].append((time.perf_counter() - t0) * 1e3)

    cluster.allocator.allocate = timed_allocate
    try:
        (published,) = server.list("ResourceSlice")
        devices = published.spec.devices
        cards = [d.name for d in devices if d.basic.attributes["type"].value == "tpu"]
        index = {d.name: d.basic.attributes["index"].value for d in devices if d.name in cards}
        (tpu_class,) = [dc for dc in server.list("DeviceClass")
                        if dc.metadata.name == harness.TPU_CLASS]
        picked = [d.name for d in devices if palloc._matches_selectors(
            palloc._Candidate(driver=published.spec.driver, pool=published.spec.pool.name,
                              device=d), tpu_class.spec.selectors)]
        log(f"{label}: the slice publishes {[d.name for d in devices]}; the class "
            f"{harness.TPU_CLASS}'s CEL {[s.cel.expression for s in tpu_class.spec.selectors]} "
            f"picks {picked}")
        if picked != cards or not cards or (DEV == "cuda"
                                            and len(cards) != torch.cuda.device_count()):
            raise AssertionError(f"{label}: the class picks {picked}, the cards are {cards}")

        sub = f"{label} (a) tpu-test2"
        t0 = time.perf_counter()
        (pod,) = spec_runner.apply_spec(cluster, specs / "tpu-test2.yaml")
        times["apply_ms"] = (time.perf_counter() - t0) * 1e3
        (claim,) = _loop_claims(server, "tpu-test2").values()
        (dev,) = pod.devices
        results = [r.device for r in claim.status.allocation.devices.results]
        env, nodes = _claim_container(tmp / "cdi", claim.metadata.uid, dev["cdi_device_ids"])
        pod_doc = server.get("Pod", pod.name, pod.namespace)
        claimed = [[c["name"] for c in ctr["resources"]["claims"]]
                   for ctr in pod_doc.spec["containers"]]
        log(f"{sub}: apply_spec {times['apply_ms']:.2f} ms, allocate "
            f"{times['allocate_ms'][-1]:.3f} ms (host clock, {card}); the pod on {pod.node} with "
            f"{pod.devices}; containers' claims {claimed}; environment {env}; device nodes {nodes}")
        want_index = str(index.get(dev["device_name"]))
        missing = [p for p in nodes if not os.path.exists(p)] if DEV == "cuda" else []
        if results != [dev["device_name"]] or dev["device_name"] not in cards \
                or claimed != [["shared-tpu"], ["shared-tpu"]] or missing \
                or env.get("TPU_VISIBLE_DEVICES") != want_index \
                or pod.env.get("TPU_VISIBLE_DEVICES") != want_index:
            raise AssertionError(f"{sub}: the allocation {results}, the containers' claims "
                                 f"{claimed}, missing nodes {missing} or the environment is off")
        rc, out, err, secs = _pod_command(
            ["k8s_dra_driver_torch.consumer", "--check", "--serve-demo"], env)
        log(f"{sub}: the consumer exited {rc} in {secs:.1f} s; stdout:\n" + out.rstrip())
        if rc != 0:
            raise AssertionError(f"{sub}: exit {rc}; stderr tail:\n{err[-3000:]}")
        _demo_gates(sub, json.loads(out.strip().splitlines()[-1])["serve_demo"], 0)
        demo = _demo_stderr(sub, err)
        appends = demo["kernel_launches"].get("paged_attention:append", 0)
        if not appends and DEV == "cuda":
            raise AssertionError(f"{sub}: the append kernel was never launched")
        times["demo_s"] = demo["serve_demo_seconds"]
        cluster.delete_pod(pod.name, pod.namespace)
        if server.get("ResourceClaim", claim.metadata.name, "tpu-test2").status.allocation \
                or drv.state.cdi.claim_spec_path(claim.metadata.uid).exists():
            raise AssertionError(f"{sub}: deleting the pod left its claim behind")

        sub = f"{label} (b) tpu-test1"
        hog = None
        if len(cards) > 1:  # a fake host: hold every chip but one
            hog = cluster.allocator.allocate(
                server.create(harness.simple_claim("hog", count=len(cards) - 1)),
                node_name=LOOP_NODE)
        try:
            spec_runner.apply_spec(cluster, specs / "tpu-test1.yaml")
        except spec_runner.SpecError as exc:
            message = str(exc)
        else:
            raise AssertionError(f"{sub}: two one-chip pods fitted on one card")
        claims = _loop_claims(server, "tpu-test1")
        held = {uid for uid in json.loads((tmp / "cp.json").read_text())["preparedClaims"]}
        pods = sorted(p.metadata.name for p in server.list("Pod", namespace="tpu-test1"))
        first, second = claims["pod0-tpu"], claims["pod1-tpu"]
        log(f"{sub}: SpecError {message!r}; pods {pods}; the checkpoint holds "
            f"{sorted(held)} (pod0-tpu {first.metadata.uid})")
        if "tpu-test1/pod1 is unschedulable" not in message or pods != ["pod0"] \
                or first.status.allocation is None or second.status.allocation is not None \
                or held != {first.metadata.uid}:
            raise AssertionError(f"{sub}: the failed pod left something half-done")
        cluster.delete_pod("pod0", "tpu-test1")
        if hog is not None:
            cluster.allocator.deallocate(server.get("ResourceClaim", "hog", "default"))

        sub = f"{label} (c) tpu-test3"
        pods = spec_runner.apply_spec(cluster, specs / "tpu-test3.yaml")
        shared = server.get("ResourceClaim", "shared-tpu", "tpu-test3")
        uid = shared.metadata.uid
        steps = []
        for name in ("pod0", "pod1"):
            cluster.delete_pod(name, "tpu-test3")
            c = server.get("ResourceClaim", "shared-tpu", "tpu-test3")
            cp = json.loads((tmp / "cp.json").read_text())["preparedClaims"]
            steps.append((c.status.allocation is not None, len(c.status.reserved_for),
                          uid in drv.state.prepared_claim_uids(),
                          drv.state.cdi.claim_spec_path(uid).exists(), uid in cp))
        log(f"{sub}: pods {[(p.name, p.devices[0]['device_name']) for p in pods]}; after "
            f"deleting pod0, pod1 (allocated, consumers, prepared, spec file, checkpoint): "
            f"{steps}")
        if len({p.devices[0]["device_name"] for p in pods}) != 1 \
                or steps != [(True, 1, True, True, True), (False, 0, False, False, False)]:
            raise AssertionError(f"{sub}: the shared claim's teardown is off: {steps}")

        sub = f"{label} (d) the fence"
        real_start = selftest.start_selftest

        def sweep(oks):
            selftest.start_selftest = lambda **kw: _StubRun({  # noqa: E731
                "ok": all(oks), "platform": "gpu",
                "devices": [{"id": i, "platform": "gpu", "ok": ok} for i, ok in enumerate(oks)]})
            try:
                drv._last_selftest = 0.0
                drv.refresh_inventory()
            finally:
                selftest.start_selftest = real_start
            return [_card_health(server, c) for c in cards]

        fenced = sweep([False] * len(cards))
        claim = server.create(harness.simple_claim("fenced-claim"))
        try:
            cluster.schedule_and_prepare(claim, LOOP_NODE)
        except palloc.AllocationError as exc:
            refusal = str(exc)
        else:
            raise AssertionError(f"{sub}: a fenced card was allocated")
        seen = (drv.state.prepared_claim_uids(),
                drv.state.cdi.claim_spec_path(claim.metadata.uid).exists())
        restored = sweep([True] * len(cards))
        claim = server.get("ResourceClaim", "fenced-claim", "default")
        t0 = time.perf_counter()
        prepared = cluster.schedule_and_prepare(claim, LOOP_NODE)
        times["schedule_and_prepare_ms"] = (time.perf_counter() - t0) * 1e3
        log(f"{sub}: fenced {fenced}; the allocator refused: {refusal!r}; the node saw "
            f"{seen}; restored {restored}; then scheduled and prepared in "
            f"{times['schedule_and_prepare_ms']:.2f} ms ({card}): {prepared}")
        if any(h != (False, "selftest-failed") for h in fenced) or "cannot satisfy" not in refusal \
                or seen != ([], False) or any(h != (True, "") for h in restored) \
                or [d["device_name"] for d in prepared][0] not in cards:
            raise AssertionError(f"{sub}: the fence did not close the loop")

        sub = f"{label} (g) diagnostics"
        metrics = parse_prom_text(_http(diag.port, "/metrics").decode())
        families = {k: sum(metrics.get(k, {}).values()) for k in (
            "dra_alloc_index_hits_total", "dra_alloc_index_misses_total", "dra_cel_evals_total",
            "dra_cel_memo_hits_total", "dra_cel_memo_misses_total")}
        journal = json.loads(_http(diag.port, "/debug/journal?component=e2e&limit=1000"))
        events = {(e["event"], (e.get("attrs") or {}).get("pod") or
                   (e.get("attrs") or {}).get("claim")) for e in journal["events"]}
        state = json.loads(_http(diag.port, "/debug/state"))
        log(f"{sub}: /metrics {families}; /debug/journal?component=e2e {sorted(events)}; "
            f"/debug/state {state}")
        want_events = {("delete_pod", "pod"), ("delete_pod", "pod0"), ("delete_pod", "pod1"),
                       ("schedule_and_prepare", "fenced-claim")}
        if any(k not in metrics for k in families) or not families["dra_cel_evals_total"] \
                or not families["dra_alloc_index_hits_total"] or not want_events <= events \
                or state["prepared_claims"] != [claim.metadata.uid]:
            raise AssertionError(f"{sub}: the diagnostics server does not show the loop")
        cluster.unprepare_and_deallocate(claim, LOOP_NODE)
        cluster.allocator.allocate = real_allocate

        sub = f"{label} (e) kubelet face"
        plugin = grpc_service.PluginServer(drv, plugin_dir=str(sock_root / "p"),
                                           registry_dir=str(sock_root / "r"))
        sockets = [plugin.plugin_socket, plugin.registry_socket]
        if any(len(s.encode()) >= 100 for s in sockets):
            raise AssertionError(f"{sub}: socket paths too long for a unix socket: {sockets}")
        plugin.start()
        client = registration = None
        try:
            registration = grpc_service.RegistrationClient(plugin.registry_socket)
            info = registration.handshake()
            if (info.type, info.name, info.endpoint, list(info.supported_versions)) != (
                    "DRAPlugin", "tpu.google.com", plugin.plugin_socket, ["v1beta1"]) \
                    or not plugin.registered.is_set():
                raise AssertionError(f"{sub}: the handshake is off: {info}")
            client = grpc_service.DRAClient(plugin.plugin_socket)
            samples: dict = {"wire": [], "in process": []}
            mismatched = []

            def cycle(i, kind):
                name = f"cycle-{i}"
                t0 = time.perf_counter()
                claim = server.create(harness.simple_claim(name))
                allocated = cluster.allocator.allocate(
                    claim, node_name=LOOP_NODE, node_labels=cluster.node_labels(LOOP_NODE))
                ref = pdriver.ClaimRef(allocated.metadata.uid, name, "default")
                if kind == "wire":
                    res = client.node_prepare_resources([ref]).claims[ref.uid]
                    error, ids = res.error, [list(d.cdi_device_ids) for d in res.devices]
                else:
                    res = drv.node_prepare_resources([ref])[ref.uid]
                    error, ids = res.error, [d["cdi_device_ids"] for d in res.devices]
                samples[kind].append((time.perf_counter() - t0) * 1e3)
                if error:
                    raise AssertionError(f"{sub}: prepare of {name} failed: {error}")
                if kind == "wire":  # the in-process answer (prepare is idempotent)
                    again = drv.node_prepare_resources([ref])[ref.uid]
                    if ids != [d["cdi_device_ids"] for d in again.devices]:
                        mismatched.append((name, ids))
                    client.node_unprepare_resources([ref])
                else:
                    drv.node_unprepare_resources([ref])
                cluster.allocator.deallocate(server.get("ResourceClaim", name, "default"))
                server.delete("ResourceClaim", name, "default")

            i = 0
            for kind in ("wire", "in process", "in process", "wire") * (
                    LOOP_CYCLES // LOOP_ROUND // 2):
                for _ in range(LOOP_ROUND):
                    cycle(i, kind)
                    i += 1
        finally:
            for c in (client, registration):
                if c is not None:
                    c.close()
            plugin.stop()
        cycles = {k: _cycle_ms(v) for k, v in samples.items()}
        times["cycle_ms"] = cycles
        log(f"{sub}: sockets {sockets}; handshake {info.type} {info.name}; claim-to-prepared "
            f"(create, allocate, NodePrepareResources; host clock, {card}) over the socket "
            f"p50 {cycles['wire']['p50']:.3f} / p99 {cycles['wire']['p99']:.3f} ms, in process "
            f"p50 {cycles['in process']['p50']:.3f} / p99 {cycles['in process']['p99']:.3f} ms, "
            f"{LOOP_CYCLES} cycles each in alternating rounds of {LOOP_ROUND} (the reference "
            f"bench's budget 1000 ms)")
        if mismatched or drv.state.prepared_claim_uids():
            raise AssertionError(f"{sub}: the CDI ids over the wire differ from the "
                                 f"in-process ones ({mismatched[:2]}) or a claim stayed")
        times.update(_plugin_main_child(label, len(devices), sock_root / "main", card))
        times["throughput"] = _scheduler_throughput(label, card)
    finally:
        cluster.allocator.allocate = real_allocate
        diag.stop()
        shutil.rmtree(sock_root, ignore_errors=True)
    times["allocate_ms"] = {"n": len(times["allocate_ms"]),
                            "median": float(np.median(times["allocate_ms"]))}
    log(f"{label}: times {json.dumps(times)} ({card})")
    shutil.rmtree(tmp, ignore_errors=True)
    return {"paged_attention": appends}


def forward_flops(cfg, batch: int, seq: int) -> int:
    """FLOPs of one forward: 2 per weight per token (the tied logits'
    table included) plus QK^T and PV, 4·B·H·S²·hd a layer."""
    return (2 * model_weights(cfg) * batch * seq
            + 4 * batch * cfg.n_heads * seq * seq * cfg.head_dim * cfg.n_layers)


def _entry_forward(torch, label, card) -> None:
    """Leg (a): ``entry.entry()``'s forward as ``entry.compiled_forward``
    (call 1 eager, call 2 capture and replay), the graph's logits bit for
    bit the eager call's, finite, ``[8, 1024, 32768]`` f32; capture ms,
    pool MiB and peak memory; host-clock ms of a replay and of an eager
    call in alternating rounds beside the bound."""
    from k8s_dra_driver_torch import entry

    fn, (params, tokens) = entry.entry(DEV)
    cfg = fn.keywords["cfg"]
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prog = entry.compiled_forward(fn, params, tokens, DEV)
    eager = prog()
    graphed = prog()
    sync(torch)
    peak = torch.cuda.max_memory_allocated() - base
    equal = bool(graphed.equal(eager))
    finite = bool(torch.isfinite(graphed).all())
    log(f"{label}: logits {tuple(graphed.shape)} {graphed.dtype}; graph == eager bit for bit "
        f"{equal}; finite {finite}; captured in {prog.capture_s * 1e3:.1f} ms, pool "
        f"{graph_pool_bytes(torch, prog.graph) / 2**20:.1f} MiB; peak memory over the two "
        f"calls {peak / 2**30:.2f} GiB above the weights and tokens")
    if not (equal and finite) or tuple(graphed.shape) != (entry.BATCH, cfg.max_seq,
                                                          cfg.vocab_size):
        raise AssertionError(f"{label}: the graphed forward is not the eager one's")
    del eager, graphed

    def run_eager():
        with torch.no_grad():
            fn(params, tokens)

    times = alternating_rounds(torch, {"graphed": (prog, contextlib.nullcontext),
                                       "eager": (run_eager, contextlib.nullcontext)},
                               rounds=4, per_round=3)
    flops = forward_flops(cfg, entry.BATCH, cfg.max_seq)
    bound = flops / PEAK_OPS["bfloat16"] * 1e3
    med = {k: float(np.median(t)) for k, t in times.items()}
    for k, t in times.items():
        log(f"{label} {k}: {' / '.join(f'{x:.2f}' for x in t)} ms a forward by round (median "
            f"{med[k]:.2f}; {flops / med[k] / 1e9:.1f} TFLOP/s = "
            f"{flops / med[k] / 1e9 / 989:.4f} of 989 TFLOP/s)")
    log(f"{label}: {flops / 1e12:.3f} TFLOP a forward (bound {bound:.2f} ms at 989 TFLOP/s); "
        f"graphed / eager {med['graphed'] / med['eager']:.3f}; 4 alternating rounds of 3; "
        f"{card}")
    prof = profile_window(torch, f"{label}: profile of one graphed forward", prog, top=8)
    if prof is not None:
        device_time_by_class(f"{label}: graphed forward", prof)


def phase_entry_point(torch, card):
    """The port's entry point ("entry point", ``k8s_dra_driver_torch/entry.py``),
    each leg timed: (a) :func:`_entry_forward`; (b) the classic
    ``FLAGSHIP`` forward on seeds 2 and 3, ``[8, 1024, 32768]`` finite, two
    calls bit for bit; (c) ``entry.dryrun_multichip(8)``, 8 gloo ranks
    sharing the card: every line of the reference's set at 8 (losses
    masked, finite), the flash launches summed over ranks the first leg's
    schedule (the ring over ``seq`` 2 at ``model`` 4), the append kernel
    launched, and the flash kernels at D 16 on that leg's layer-0 inputs
    against their plain versions.  Returns the launches by kernels-line
    row."""
    from k8s_dra_driver_torch import entry
    from k8s_dra_driver_torch.models import burnin
    from k8s_dra_driver_torch.parallel.mesh import auto_mesh_shape

    label = "entry point"
    t0 = time.perf_counter()
    _entry_forward(torch, f"{label} (a) entry() forward, FLAGSHIP_MODERN, B 8 x 1024", card)
    log(f"{label} (a): {time.perf_counter() - t0:.1f} s")

    sub = f"{label} (b) classic FLAGSHIP forward, B 8 x 1024"
    t0 = time.perf_counter()
    cfn, (cparams, ctokens) = entry.classic(DEV)
    with torch.no_grad():
        outs = [cfn(cparams, ctokens) for _ in range(2)]
    sync(torch)
    log(f"{sub}: logits {tuple(outs[0].shape)} {outs[0].dtype}, finite "
        f"{bool(torch.isfinite(outs[0]).all())}, two calls bit for bit {bool(outs[0].equal(outs[1]))}; "
        f"{time.perf_counter() - t0:.1f} s (weights and both calls)")
    ccfg = cfn.keywords["cfg"]
    if (tuple(outs[0].shape) != (entry.BATCH, ccfg.max_seq, ccfg.vocab_size)
            or not torch.isfinite(outs[0]).all() or not outs[0].equal(outs[1])):
        raise AssertionError(f"{sub}: the classic forward's logits are off")
    del outs, cparams, ctokens
    if DEV == "cuda":
        torch.cuda.empty_cache()

    n = ENTRY_DRYRUN_RANKS
    sub = f"{label} (c) dryrun_multichip({n}), gloo ranks sharing the card"
    t0 = time.perf_counter()
    proc = entry.dryrun_multichip(n, DEV)
    log(f"{sub}: exit 0 in {time.perf_counter() - t0:.1f} s")
    lines = [line for line in proc.stdout.splitlines() if line.startswith("dryrun_multichip:")]
    masked = [line.split(" loss=")[0] + " loss=<masked>" if " loss=" in line else line
              for line in lines]
    losses = [float(line.split(" loss=")[1]) for line in lines if " loss=" in line]
    if tuple(masked) != ENTRY_DRYRUN_LINES or not np.isfinite(losses).all():
        raise AssertionError(f"{sub}: the lines are not the reference's set at {n}: {masked}")
    report = json.loads(proc.stderr.split("dryrun launches summed over ranks:")[1].splitlines()[0])
    counts: dict = {}
    for leg, by_kernel in report.items():
        log(f"{sub}: leg {leg!r}: kernel launches summed over ranks {by_kernel}")
        for key, k in by_kernel.items():
            row = POD_KERNEL_ROWS[key]
            if row is not None:
                counts[row] = counts.get(row, 0) + k
    shape = auto_mesh_shape(n, want_seq=True)
    layout = (0, {"data": shape.data, "seq": shape.seq, "model": shape.model})
    fwd_n, bwd_n = _mesh_flash_expected(layout, {}, burnin.TINY.n_layers, 1)
    flash = {k: counts.get(k, 0) for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    log(f"{sub}: flash launches summed over ranks {flash} (the first leg's schedule on "
        f"{layout[1]}: forward {fwd_n}, dQ and dK/dV {bwd_n} each); append "
        f"{counts.get('paged_attention', 0)}")
    if flash != {"flash_fwd": fwd_n, "flash_bwd_dq": bwd_n, "flash_bwd_dkv": bwd_n}:
        raise AssertionError(f"{sub}: flash launches {flash} are not the schedule's")
    if not counts.get("paged_attention"):
        raise AssertionError(f"{sub}: the paged legs never launched the append kernel")
    worst = _flash_at_d16(torch, sub, shape.model)
    log(f"{sub}: flash kernels at D 16 on the first leg's inputs, worst max_abs_err {worst}")
    return counts


def profile_window(torch, label: str, fn, top: int = 8, host_top: int = 0, watch=()):
    """Run ``fn`` once under ``torch.profiler`` and print the device's busy
    time over the window and the kernels that take it (and, with
    ``host_top``, the host ops with the most self CPU time; with ``watch``,
    the device time of the kernels whose names hold each string).  Returns
    ``{"window_us", "busy_us", "rows": [(device us, count, name)]}``, or
    None when the profile holds no device events.  Only events
    that ran on the device are summed: a CPU op's own device time repeats
    the time of the kernels it launched, so the sum over all events counts
    those kernels twice (printed beside, for comparison with earlier runs
    that summed it)."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync(torch)
            window_us = (time.perf_counter() - t0) * 1e6
        rows, host, all_events = [], [], 0.0
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", 0)
            all_events += dev_us
            if ev.device_type == DeviceType.CUDA and dev_us > 0:
                rows.append((dev_us, ev.count, ev.key))
            elif ev.device_type == DeviceType.CPU:
                host.append((ev.self_cpu_time_total, ev.count, ev.key))
        busy = sum(r_[0] for r_ in rows)
        if busy <= 0:
            log(f"{label}: the profile holds no device events")
            return None
        log(f"{label}: window {window_us:.0f} us, device busy {busy:.0f} us "
            f"({busy / window_us:.3f} of the window; the sum over all events, CPU ops "
            f"included, is {all_events:.0f} us)")
        for dev_us, count, key in sorted(rows, reverse=True)[:top]:
            log(f"    {dev_us:9.0f} us  {dev_us / busy:.3f}  x{count:<5d} {key[:90]}")
        for name in watch:
            hits = [r_ for r_ in rows if name in r_[2]]
            log(f"{label}: kernels named {name}: {sum(r_[0] for r_ in hits):.0f} us over "
                f"{sum(r_[1] for r_ in hits)} launches "
                f"({sum(r_[0] for r_ in hits) / busy:.3f} of the device time)")
        if host_top:
            log(f"{label}: host ops by self CPU time ({sum(r_[1] for r_ in host)} ops, "
                f"{sum(r_[0] for r_ in host):.0f} us under the profiler)")
            for cpu_us, count, key in sorted(host, reverse=True)[:host_top]:
                log(f"    {cpu_us:9.0f} us  x{count:<5d} {key[:90]}")
        return {"window_us": window_us, "busy_us": busy, "rows": rows}
    except Exception as exc:  # the profiler is a reading aid, not a check
        log(f"{label}: profile not taken: {type(exc).__name__}: {exc}")
        return None


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only", file=sys.stderr)
        return 2
    try:
        from k8s_dra_driver_torch.models import burnin, quant
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 1

    # every float32 comparison below is against full-precision products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed = []
    launches: dict = {}
    kernel_numbers: dict = {}

    def run(name, fn):
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception:
            traceback.print_exc()
            log(f"== phase {name}: FAILED")
            failed.append(name)
            return None
        log(f"== phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
        return out

    card = run("environment", lambda: phase_environment(torch))
    if card is None:
        return 1
    timer = Timer(torch)
    kernel_numbers = run("kernels", lambda: phase_kernels(torch, timer)) or {}
    kernel_numbers.update(run("flash kernels", lambda: phase_flash_kernels(torch, timer)) or {})

    cfg = burnin.FLAGSHIP_MODERN
    reqs = _traffic(cfg.vocab_size, 16, 256, 128, SEED)
    params = burnin.init_params(torch.Generator(device=DEV).manual_seed(SEED), cfg)

    def serve_bf16():
        launches["bf16"] = phase_serve(
            torch, "serve bf16", cfg, params, reqs, cache_dtype=torch.bfloat16, logit_tol=0.25,
        )

    def serve_int4():
        p4 = quant.quantize_blocks(params, bits=4)
        launches["int4"] = phase_serve(
            torch, "serve int4", cfg, p4, reqs, cache_dtype=torch.bfloat16, logit_tol=0.25,
        )
        # decode steps (M = 8) go through the split-K kernel, admissions
        # (M = prompt bucket 256) through the wgmma kernel
        if launches["int4"]["int4_matmul"] == 0 or launches["int4"]["int4_matmul_prefill"] == 0:
            raise AssertionError(f"an int4 kernel was never launched: {launches['int4']}")

    def serve_f32():
        cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
        p32 = burnin.init_params(torch.Generator(device=DEV).manual_seed(SEED + 1), cfg32)
        reqs32 = _traffic(cfg32.vocab_size, 8, 256, 64, SEED + 1)
        launches["f32"] = phase_serve(
            torch, "serve f32", cfg32, p32, reqs32, cache_dtype=torch.float32, logit_tol=1e-3,
        )

    def serve_lifecycle():
        launches["lifecycle"] = phase_serve_lifecycle(torch, cfg, params,
                                                      cache_dtype=torch.bfloat16)

    def serve_dense():
        launches["dense int4"] = phase_serve_dense(torch, cfg, params, reqs,
                                                   cache_dtype=torch.bfloat16)

    run("serve bf16", serve_bf16)
    run("serve int4", serve_int4)
    run("serve f32", serve_f32)
    run("serve bf16 lifecycle", serve_lifecycle)
    run("serve dense", serve_dense)
    run("serve bf16 admission",
        lambda: phase_serve_admission(torch, cfg, params, cache_dtype=torch.bfloat16))

    def serve_spec():
        launches["spec"] = phase_serve_spec(torch, cfg, params, reqs, cache_dtype=torch.bfloat16)

    run("serve bf16 spec", serve_spec)

    def serve_telemetry():
        launches["telemetry"] = phase_serve_telemetry(torch, cfg, params, reqs,
                                                      cache_dtype=torch.bfloat16, card=card)

    run("serve bf16 telemetry", serve_telemetry)

    def serve_lora():
        launches["lora"] = phase_serve_lora(torch, cfg, params, reqs,
                                            cache_dtype=torch.bfloat16, card=card)

    run("serve bf16 lora", serve_lora)

    def serve_moe():
        launches["moe"] = phase_serve_moe(torch, cfg, params, reqs, cache_dtype=torch.bfloat16,
                                          card=card)

    run("serve moe", serve_moe)
    run("serve kv quant", lambda: phase_serve_kv_quant(torch, cfg, params, reqs, card=card))

    def serve_handoff():
        launches["handoff"] = phase_serve_handoff(torch, cfg, params, cache_dtype=torch.bfloat16,
                                                  card=card)

    run("serve bf16 handoff", serve_handoff)

    def serve_workers():
        launches["workers"] = phase_serve_workers(torch, cfg, params, launches["handoff"],
                                                  card=card)

    run("serve workers", serve_workers)

    def serve_disagg():
        launches["disagg"] = phase_serve_disagg(torch, cfg, params, launches["handoff"],
                                                card=card)

    run("serve disagg", serve_disagg)

    def serve_fleet():
        launches["fleet"] = phase_serve_fleet(torch, cfg, params, card=card)

    run("serve fleet", serve_fleet)

    def serve_mesh():
        launches["mesh"] = phase_serve_mesh(torch, cfg, params, reqs, card=card)

    run("serve mesh", serve_mesh)
    del params

    def train_bf16():
        launches["train"] = phase_train_bf16(torch, cfg)

    def train_lora():
        launches["train_lora"] = phase_train_lora(torch, cfg)

    def train_f32():
        launches["train_f32"] = phase_train_f32(torch, cfg)

    def train_moe():
        launches["train_moe"] = phase_train_moe(torch, cfg)

    run("train bf16", train_bf16)
    run("train lora", train_lora)
    run("train moe", train_moe)
    run("remat policies", lambda: phase_remat(torch, cfg))
    run("resume", lambda: phase_resume(torch, cfg))
    run("train f32", train_f32)

    def train_mesh():
        launches["train_mesh"] = phase_train_mesh(torch, cfg, card)

    run("train mesh", train_mesh)

    def pod_entry_points():
        launches["pod"] = phase_pod_entry_points(torch, card)

    run("pod entry points", pod_entry_points)

    def driver_node():
        launches["driver"] = phase_driver_node(torch, card)

    run("driver node", driver_node)

    def driver_loop():
        launches["loop"] = phase_driver_loop(torch, card)

    run("driver loop", driver_loop)

    def entry_point():
        launches["entry"] = phase_entry_point(torch, card)

    run("entry point", entry_point)
    run("selftest", lambda: phase_selftest(torch, card))

    if failed:
        log(f"chip_smoke: failed phases {failed}")
        return 1
    # each kernel's launches on the path that runs it: paged append on the
    # bf16 serving run, the speculative one (its verify windows, nq 5), the
    # telemetry-on engines, the adapted run and the MoE paged run; both int4
    # kernels on the int4 serving run, the telemetry-on int4 engine, the
    # int4 base under the bank and the MoE int4 base; flash on the bf16,
    # LoRA and MoE training runs and the f32 forward on the f32 training
    # run; the read-only paged kernel is on no path (0); the quantized
    # pools take no kernel; the handoff phase's decode engines after an
    # inject run the append kernel too, and so do the sharded paged
    # engine's ranks (summed over ranks); the mesh legs' flash launches,
    # summed over ranks, join the bf16 and f32 flash rows (leg (e) also its
    # graphed twin's run); so do the driver node's (the prepared consumer's
    # demo, read from its launch line), the driver loop's (the consumer's demo
    # in the claim the allocator gave tpu-test2's pod, read from its launch
    # line) and the pod entry points' (the demo's appends
    # in this process and on its two ranks) and the entry point's (the dry
    # run's flash and appends at 8, summed over its ranks); the
    # serve workers phase adds its decode workers' appends, read from
    # their launch lines; the serve disagg phase its disaggregated run's
    # appends (prefill and decode engines) and its decode worker's; the
    # serve fleet phase its measured runs' appends (both fleets of (a), the
    # autoscaled fleet with its spawned replicas, the pool move's engines)
    tel, lora_serve, moe = launches["telemetry"], launches["lora"], launches["moe"]
    main_counts = {
        "paged_attention": (launches["bf16"]["paged_attention"]
                            + launches["spec"]["paged_attention"] + tel["paged_attention"]
                            + lora_serve["paged_attention"] + moe["paged_attention"]
                            + launches["handoff"]["paged_attention"] + launches["mesh"]
                            + launches["workers"] + launches["disagg"] + launches["fleet"]),
        "paged_attention_window": launches["bf16"]["paged_attention_window"],
        "int4_matmul": (launches["int4"]["int4_matmul"] + tel["int4_matmul"]
                        + lora_serve["int4_matmul"] + moe["int4_matmul"]),
        "int4_matmul_prefill": (launches["int4"]["int4_matmul_prefill"]
                                + tel["int4_matmul_prefill"] + lora_serve["int4_matmul_prefill"]
                                + moe["int4_matmul_prefill"]),
        **{name: n + launches["train_lora"][name] + launches["train_moe"][name]
           + launches["train_mesh"][name] for name, n in launches["train"].items()},
        **{name: n + launches["train_mesh"][name] for name, n in launches["train_f32"].items()},
    }
    log(f"card: {card}")
    kernels = []
    for name, meta in KERNELS.items():
        nums = kernel_numbers[name]
        kernels.append({
            "name": name, **meta,
            "launches": (main_counts[name] + launches["pod"].get(name, 0)
                         + launches["driver"].get(name, 0) + launches["loop"].get(name, 0)
                         + launches["entry"].get(name, 0)),
            "max_abs_err": nums["max_abs_err"], "ms": nums["ms"], "plain_ms": nums["plain_ms"],
            "bound_ms": nums["bound_ms"], "bound_by": nums["bound_by"],
            "library_ms": nums["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
