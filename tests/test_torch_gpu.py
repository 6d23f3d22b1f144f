"""The PyTorch port's CUDA kernels on the card: each against its plain
PyTorch version, the paged engine and the flash train step on the card
against the same on the CPU.  Every test here is marked ``gpu`` and skips without a card.
The file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: paged attention elementwise within step * (|plain| + mag) +
2^-16 * mag, mag the plain version's softmax weights applied to |V| in
f32, step one bf16 step (2^-7 + 2^-16) in bf16 (P rounded to bf16 on each
side: in the kernel against its split's max before normalisation, in the
plain version after it; both within one step of mag) and 2^-16 in f32
(sums in another order: splits merged by their (m, l); TF32 off), and
never above the limit these tests held before, atol + rtol * |plain|
with atol = rtol = 3e-2 in bf16 and 1e-5 in f32;
appended pool bytes and greedy streams identical.  int4: each
element within step * |plain| + 2^-16 * mag, mag = |x| @ |dequant(W)|,
step one bf16 step (2^-7 + 2^-16) in bf16 and 0 in f32 (f32 sums in
another order, then one rounding of the output); identity rows give the
dequantized weights bit for bit.  Flash
kernels: out, dq, dk and dv each elementwise within step * (|plain| +
mag) + 2^-16 * mag_f32.  mag is the same sum over absolute terms (sum_k
p|v| / l, scale sum_k |ds||k|, scale sum_q |ds||q|, sum_q p|dout|);
mag_f32 is mag for out and dv; for dq and dk it takes p (|dout||v| +
|dout||out|), the absolute size of the two f32 dots whose difference dS
is, in place of |dS| (the order of f32 sums decides dS near 0).  step is 2^-16 in f32 (sums in another order)
and one bf16 step, 2^-7 + 2^-16, in bf16 (P rounded on each side against
another max in the forward; in the backward, f32 sums in another order
move a rounding of P or dS to the next bf16 value; each output rounded
once).  lse within 2^-16 (1 + |lse|).
Train-step losses within 1e-5 relative of the CPU's.  PRNG: threefry's
known answers, random bits and uniforms equal the CPU's bit for bit;
Gumbel noise within 4 float32 ulps of its size, 2^-21 (1 + |g|) (each
device's own ``log``).  The sampled, preempting engine graphed equals
its eager twin in everything, as the greedy one does; so do the dense
engine, whose greedy streams on the card equal the CPU's, and the paged
engine with chunked admission and the prefix store, and both engines'
speculative rounds (whose f32 streams equal the CPU's too).  A bf16 int4
chunk writes the pool its CPU twin writes within one bf16 step; the append
kernel at a served verify window (nq = gamma + 1) holds the paged limits
and writes the pages its plain version writes.  A graphed engine with
telemetry on equals its telemetry-off twin in streams, host syncs, graph
calls and launches.  An engine with a LoRA bank (adapters mixed per
request; with speculation or the prefix store) graphed equals its eager
twin in everything, its f32 streams the CPU's, its adapter-0 streams a
bank-less engine's; the LoRA train step graphed equals its eager twin bit
for bit, the base unchanged, and its f32 losses are within 1e-5 relative
of the CPU's.  An MoE model's engines (int4 base included) and train step
graphed equal their eager twins in everything, their f32 streams and
losses the CPU's (1e-5 relative).  A quantized pool's engine (int8, int4;
with speculation over a window wider than a block, and with chunks and the
store) graphed equals its eager twin in streams, pool bytes and scales,
launches no paged kernel, and its f32 streams equal the CPU's; the block
codec on the card gives the CPU's bytes and scales.  After a paged -> paged
handoff through the wire frame, the decode engine's injected blocks hold
the source's bytes and scales, and its graphs equal its eager twin."""

import contextlib

import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import decode as td
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models import prng
from k8s_dra_driver_torch.models import quant as tq
from k8s_dra_driver_torch.models import serve as ts
from k8s_dra_driver_torch.ops import flash_attention as tfa
from k8s_dra_driver_torch.ops import int4_matmul as ti4
from k8s_dra_driver_torch.ops import paged_attention as tpa
from k8s_dra_driver_torch.utils import faults as tf

pytestmark = pytest.mark.gpu

PAGED_STEP = {torch.float32: 2 ** -16, torch.bfloat16: 2 ** -7 + 2 ** -16}
PAGED_CAP = {torch.float32: 1e-5, torch.bfloat16: 3e-2}  # the earlier atol = rtol


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pools(dev, dtype, *, layers=2, hkv=2, d=16, bs=8, b=3, mb=6, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_pool = 1 + b * mb
    k = torch.randn((layers, n_pool, hkv, d, bs), generator=g).to(dev, dtype)
    v = torch.randn((layers, n_pool, hkv, d, bs), generator=g).to(dev, dtype)
    table = (torch.randperm(b * mb, generator=g) + 1).reshape(b, mb).to(dev, torch.int32)
    return k, v, table, g


def _paged_close(got, want, mag):
    """Each element within step * (|plain| + mag) + 2^-16 * mag (the
    module's docstring)."""
    assert mag.shape == want.shape
    limit = PAGED_STEP[want.dtype] * (want.float().abs() + mag) + 2 ** -16 * mag
    limit = torch.minimum(limit, PAGED_CAP[want.dtype] * (1 + want.float().abs()))
    err = (got.float() - want.float()).abs()
    over = int((err > limit).sum())
    assert over == 0, (f"{over} elements over their limit; max_abs_err {err.max().item()}, "
                       f"max|plain| {want.float().abs().max().item()}")


def _window_positions(spec, nq, split):
    """Row positions; "edges" puts rows at the kernel's split boundaries
    (``split`` keys per split) in a table of 1024 positions."""
    if spec != "edges":
        return spec
    if nq == 1:  # contexts 1, split - 1, split, split + 1 and 1024
        return [0, split - 2, split - 1, split, 1023]
    # pos = split - 1: the second split holds only keys masked for query 0;
    # pos = split - 2: the window crosses a page and a split boundary
    return [split - 1, split - 2, 0, 1024 - nq, 2 * split + 5]


# (d, bs, mb, nq, positions): the small pools, then D 64 and 128 at the
# serving block size, a row of 1024 positions, rows at the split boundaries
PAGED_CASES = [
    (16, 8, 6, 1, [0, 20, 47]), (16, 8, 6, 3, [6, 14, 45]),
    (32, 4, 40, 3, [0, 62, 130]),  # bf16 rows of 8 bytes: P.V one element at a time
    (64, 16, 64, 1, "edges"), (128, 16, 64, 1, "edges"),
    (64, 16, 64, 4, "edges"), (128, 16, 64, 4, "edges"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "d,bs,mb,nq,pos", PAGED_CASES,
    ids=[f"paged-d{c[0]}-nq{c[3]}{'-edges' if c[4] == 'edges' else ''}" for c in PAGED_CASES],
)
def test_append_kernel_matches_plain(cuda, dtype, d, bs, mb, nq, pos):
    split = tpa.split_schedule(bs, mb)[0] * bs
    pos = _window_positions(pos, nq, split)
    b, hq = len(pos), 8
    k, v, table, g = _pools(cuda, dtype, d=d, bs=bs, b=b, mb=mb)
    q = torch.randn((b, nq, hq, d), generator=g).to(cuda, dtype)
    nk = torch.randn((b, nq, 2, d), generator=g).to(cuda, dtype)
    nv = torch.randn((b, nq, 2, d), generator=g).to(cuda, dtype)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    wmask = (torch.arange(b, device=cuda) % 3 != 1).to(torch.int32)  # row 1 does not write
    k2, v2 = k.clone(), v.clone()
    mag = tpa.paged_append_attention_plain(
        q.float(), nk.float(), nv.float().abs(), k.float(), v.float().abs(), table, pos, 1,
        write_mask=wmask,
    )
    before = tpa.launches["append"]
    out, _, _ = tpa.paged_append_attention(q, nk, nv, k, v, table, pos, 1, write_mask=wmask)
    want = tpa.paged_append_attention_plain(q, nk, nv, k2, v2, table, pos, 1, write_mask=wmask)
    torch.cuda.synchronize()
    assert tpa.launches["append"] == before + 1
    _paged_close(out, want, mag)
    assert torch.equal(k[:, 1:], k2[:, 1:]) and torch.equal(v[:, 1:], v2[:, 1:])
    again, _, _ = tpa.paged_append_attention(q, nk, nv, k, v, table, pos, 1, write_mask=wmask)
    assert torch.equal(again, out)
    got_w = tpa.paged_window_attention(q, k2[1], v2[1], table, pos)
    want_w = tpa.paged_window_attention_plain(q, k2[1], v2[1], table, pos)
    mag_w = tpa.paged_window_attention_plain(
        q.float(), k2[1].float(), v2[1].float().abs(), table, pos
    )
    _paged_close(got_w, want_w, mag_w)
    assert torch.equal(tpa.paged_window_attention(q, k2[1], v2[1], table, pos), got_w)
    # no write_mask: every row writes (layer 0, untouched so far on both sides)
    mag = tpa.paged_append_attention_plain(
        q.float(), nk.float(), nv.float().abs(), k2.float(), v2.float().abs(), table, pos, 0
    )
    out, _, _ = tpa.paged_append_attention(q, nk, nv, k, v, table, pos, 0)
    want = tpa.paged_append_attention_plain(q, nk, nv, k2, v2, table, pos, 0)
    _paged_close(out, want, mag)
    assert torch.equal(k[:, 1:], k2[:, 1:]) and torch.equal(v[:, 1:], v2[:, 1:])


def test_paged_kernel_raises_instead_of_falling_back(cuda):
    k, v, table, g = _pools(cuda, torch.float32, d=24)
    q = torch.randn((3, 1, 4, 24), generator=g).to(cuda)
    pos = torch.zeros((3,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_window_attention(q, k[0], v[0], table, pos)
    k, v, table, g = _pools(cuda, torch.float32)
    shifted = torch.zeros(k[0].numel() + 1, device=cuda)[1:].view(k[0].shape)  # 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        tpa.paged_window_attention(q[..., :16].contiguous(), shifted, v[0], table, pos)


INT4_STEP = {torch.float32: 0.0, torch.bfloat16: 2 ** -7 + 2 ** -16}


def _int4_close(x, packed, scale, got, want):
    """Each element within step * |plain| + 2^-16 * mag, mag = |x| @
    |dequant(W)| (the module's docstring)."""
    w = ti4.dequant_int4(packed, scale, 64, x.dtype).float()
    mag = x.float().abs() @ w.abs()
    limit = INT4_STEP[x.dtype] * want.float().abs() + 2 ** -16 * mag
    err = (got.float() - want.float()).abs()
    over = int((err > limit).sum())
    assert over == 0, (f"{over} elements over their limit; max_abs_err {err.max().item()}, "
                       f"max|plain| {want.float().abs().max().item()}")


def _int4_counts(fn):
    before = dict(ti4.kernel_launches)
    total = ti4.launches
    out = fn()
    moved = {n: ti4.kernel_launches[n] - before[n] for n in before}
    assert ti4.launches - total == sum(moved.values())
    return out, moved


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 8, 40])
def test_int4_kernel_matches_plain(cuda, dtype, m):
    g = torch.Generator(device="cpu").manual_seed(m)
    w = tq.Quantized4Matrix.quantize((torch.randn((256, 192), generator=g) * 0.1).to(dtype))
    packed, scale = w.packed.to(cuda), w.scale.to(cuda)
    x = torch.randn((m, 256), generator=g).to(cuda, dtype)
    before = ti4.launches
    got = ti4.int4_matmul(x, packed, scale, 64)
    want = ti4.int4_matmul_plain(x, packed, scale, 64)
    torch.cuda.synchronize()
    assert ti4.launches == before + 1
    _int4_close(x, packed, scale, got, want)
    # identity rows read the kernels' dequantized weights exactly: 8 rows
    # through the split-K kernel, all 256 through the wgmma one (bf16)
    eye = torch.eye(256, dtype=dtype, device=cuda)
    assert torch.equal(ti4.int4_matmul(eye[:8], packed, scale, 64), w.dequant()[:8].to(cuda))
    assert torch.equal(ti4.int4_matmul(eye, packed, scale, 64), w.dequant().to(cuda))
    with pytest.raises(ValueError, match="int4 kernel takes"):
        ti4.int4_matmul(x[:, :128], packed[:32, :100].contiguous(), scale[:2, :100].contiguous(), 64)


# the four block matrices of FLAGSHIP_MODERN, then K whose last split holds
# fewer groups than the others (192 in the wgmma kernel, 704 in both)
INT4_SHAPES = [(1024, 1536), (1024, 1024), (1024, 4096), (4096, 1024), (192, 256), (704, 4096)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", INT4_SHAPES)
@pytest.mark.parametrize("m", [1, 8, 16, 17, 40, 256, 300])
def test_int4_kernels_hold_elementwise_limits(cuda, dtype, k, n, m):
    """Both kernels against the plain version at every M the rule sends
    them; the counter of the kernel the rule names moves, the other not."""
    g = torch.Generator(device="cpu").manual_seed(k + n + m)
    w = tq.Quantized4Matrix.quantize((torch.randn((k, n), generator=g) * k ** -0.5).to(dtype))
    packed, scale = w.packed.to(cuda), w.scale.to(cuda)
    x = torch.randn((m, k), generator=g).to(cuda, dtype)
    got, moved = _int4_counts(lambda: ti4.int4_matmul(x, packed, scale, 64))
    want = ti4.int4_matmul_plain(x, packed, scale, 64)
    torch.cuda.synchronize()
    name = "int4_splitk" if dtype == torch.float32 or m <= 16 else "int4_wgmma"
    assert ti4.kernel_for(m, dtype) == name
    assert moved == {n_: int(n_ == name) for n_ in moved}
    _int4_close(x, packed, scale, got, want)


@pytest.mark.parametrize("m", [8, 256])
def test_int4_kernels_give_the_same_bits_every_call(cuda, m):
    """The split-K sums meet in a fixed order: repeated calls agree bit
    for bit (mlp_down, the most splits)."""
    g = torch.Generator(device="cpu").manual_seed(3)
    w = tq.Quantized4Matrix.quantize((torch.randn((4096, 1024), generator=g) / 64).to(torch.bfloat16))
    packed, scale = w.packed.to(cuda), w.scale.to(cuda)
    x = torch.randn((m, 4096), generator=g).to(cuda, torch.bfloat16)
    first = ti4.int4_matmul(x, packed, scale, 64)
    for _ in range(3):
        assert torch.equal(ti4.int4_matmul(x, packed, scale, 64), first)


@pytest.mark.parametrize("bits", [None, 4])
def test_engine_on_the_card_matches_the_cpu_engine(cuda, bits):
    """f32 weights and pool: the card's streams (kernels) equal the CPU's
    (plain versions), and the main path launched both kernels."""
    cfg = tb.ModelConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
                         n_layers=2, d_ff=128, max_seq=64, rope=True, dtype=torch.float32)
    params = tb.init_params(torch.Generator().manual_seed(0), cfg)
    if bits:
        params = tq.quantize_blocks(params, bits=bits)
    r = np.random.RandomState(1)
    reqs = [(r.randint(0, 128, size=r.randint(3, 20)).tolist(), int(r.randint(4, 20)))
            for _ in range(6)]
    kw = dict(cfg=cfg, n_slots=3, n_blocks=12, block_size=8, prompt_bucket=24,
              sync_interval=4, preempt_on_stall=False)
    cpu = tp.PagedServeEngine(params=params, device="cpu", **kw)
    want = {c.request_id: c.generated for c in cpu.pump(reqs)}
    on_card = _to(params, cuda)
    tpa.launches["append"] = ti4.launches = 0
    eng = tp.PagedServeEngine(params=on_card, device=cuda, **kw)
    got = {c.request_id: c.generated for c in eng.pump(reqs)}
    assert got == want
    assert eng.host_syncs == cpu.host_syncs and eng.stalled_steps == cpu.stalled_steps
    assert tpa.launches["append"] > 0
    assert (ti4.launches > 0) == bool(bits)


def _small_engine_params(bits, dev):
    cfg = tb.ModelConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
                         n_layers=2, d_ff=128, max_seq=64, rope=True, dtype=torch.float32)
    params = tb.init_params(torch.Generator().manual_seed(0), cfg)
    if bits:
        params = tq.quantize_blocks(params, bits=bits)
    return cfg, _to(params, dev)


def _tight_drive(eng, seed=8):
    """Three slots, block 4, sync interval 4, 19 blocks
    (``_TIGHT``): four admissions of prompt 9, one request retiring in the
    first burst, 4-step bursts until the pool runs dry, then 1-step bursts
    until every resident slot stalls (the CPU twin is
    ``test_torch_paged_serve.tight_drive``)."""
    r = np.random.RandomState(seed)
    queue = [(r.randint(0, 128, size=9).tolist(), m) for m in (30, 2, 30, 30)]
    while True:
        while queue and eng.free_slots():
            eng.submit(*queue.pop(0))
        if eng.step_burst() == 0:
            return eng.completions()


_TIGHT = dict(n_slots=3, block_size=4, prompt_bucket=24, n_blocks=19, sync_interval=4)


def _cache_tensors(cache) -> list:
    """A cache's tensors: k and v, and a quantized pool's scales (a float
    paged pool's scale fields are None)."""
    return [t for t in cache if t is not None]


def _launch_counts():
    return {**tpa.launch_counts(), **{f"int4.{k}": n for k, n in ti4.launch_counts().items()}}


@pytest.mark.parametrize("bits", [None, 4])
@pytest.mark.parametrize("case", ["sync1", "sync4", "tight"])
def test_graphed_engine_matches_the_eager_engine(cuda, bits, case):
    """The engine's programs as CUDA graphs against the same engine run
    eagerly (``serve.disable_graphs()``): streams, statuses, host syncs,
    stalls, pool bytes outside the null block and kernel launch counts
    identical; at most four
    graphs, each captured once; the tight pool runs the 1-step burst."""
    cfg, params = _small_engine_params(bits, cuda)
    r = np.random.RandomState(1)
    reqs = [(r.randint(0, 128, size=r.randint(3, 20)).tolist(), int(r.randint(4, 20)))
            for _ in range(6)]
    if case == "tight":
        kw, drive = _TIGHT, _tight_drive
    else:
        kw = dict(n_slots=3, n_blocks=12, block_size=8, prompt_bucket=24,
                  sync_interval=1 if case == "sync1" else 4)
        drive = lambda eng: eng.pump(reqs)  # noqa: E731

    def serve(eager):
        tpa.add_launch_counts({k: -n for k, n in tpa.launch_counts().items()})
        ti4.add_launch_counts({k: -n for k, n in ti4.launch_counts().items()})
        eng = tp.PagedServeEngine(params=params, cfg=cfg, device=cuda,
                                  preempt_on_stall=False, **kw)
        with ts.disable_graphs() if eager else contextlib.nullcontext():
            comps = drive(eng)
        torch.cuda.synchronize()
        streams = sorted((c.request_id, c.generated, c.status) for c in comps)
        return eng, streams, _launch_counts()

    graphed, streams, counts = serve(eager=False)
    eager, want, want_counts = serve(eager=True)
    assert streams == want
    assert (graphed.host_syncs, graphed.stalled_steps) == (eager.host_syncs, eager.stalled_steps)
    # outside the null block 0: prefill's stripes past a prompt's blocks
    # all land there, in one indexed write whose winner is unspecified
    assert torch.equal(graphed._cache.k[:, 1:], eager._cache.k[:, 1:])
    assert torch.equal(graphed._cache.v[:, 1:], eager._cache.v[:, 1:])
    assert counts == want_counts and counts["append"] > 0
    assert (counts["int4.launches"] > 0) == bool(bits)
    assert eager.graphs == {}
    names = set(graphed.graphs)
    assert 0 < len(names) <= 4
    assert all(g.graph is not None for g in graphed.graphs.values() if g.calls >= 2)
    if case == "tight":
        assert names == {"prefill", "first token", "burst k=4", "burst k=1"}
        assert graphed.stalled_steps > 0
        assert all(g.calls >= 3 for g in graphed.graphs.values())  # replays alone too


def test_prng_on_the_card_equals_the_cpu(cuda):
    """Threefry's known answers, random bits and uniforms for 8 keys over
    ``[8, 32768]`` bit for bit, Gumbel noise within its limit."""
    mask = 0xFFFFFFFF
    for key, count, want in [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                             ((mask, mask), (mask, mask), (0x1CB996FC, 0xBB002BE7)),
                             ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                              (0xC4923A9C, 0x483DF7A0))]:
        y0, y1 = prng.threefry2x32(torch.tensor(key, device=cuda),
                                   torch.tensor([count[0]], device=cuda),
                                   torch.tensor([count[1]], device=cuda))
        assert (int(y0), int(y1)) == want
    keys = torch.from_numpy(np.random.RandomState(0).randint(
        0, 2**32, size=(8, 2), dtype=np.uint64).astype(np.int64))
    shape = (8, 32768)
    assert torch.equal(prng.random_bits(keys.to(cuda), shape).cpu(),
                       prng.random_bits(keys, shape))
    assert torch.equal(prng.uniform(keys.to(cuda), shape).cpu(), prng.uniform(keys, shape))
    got, want = prng.gumbel(keys.to(cuda), shape).cpu(), prng.gumbel(keys, shape)
    assert ((got - want).abs() <= 2**-21 * (1 + want.abs())).all()
    pos = torch.arange(8, dtype=torch.int32) * 1000
    assert torch.equal(prng.fold_in(keys.to(cuda), pos.to(cuda)).cpu(), prng.fold_in(keys, pos))


def _lifecycle_drive(eng, reqs, cancel_after=2):
    """Admit ``reqs`` as capacity frees, cancel the lowest resident request
    id after ``cancel_after`` bursts, step until nothing is queued,
    resident or parked.  Returns the completions."""
    queue, comps, bursts = list(reqs), [], 0
    while queue or eng.free_slots() < eng.n_slots or getattr(eng, "_preempted", ()):
        while queue and eng.free_slots():
            try:
                eng.submit(**queue[0])
            except ts.NoCapacity:
                break
            queue.pop(0)
        eng.step_burst()
        bursts += 1
        if bursts == cancel_after:
            resident = [st.request_id for st in eng._slots if st is not None]
            assert eng.cancel(min(resident))
        comps += eng.completions()
    return comps


@pytest.mark.parametrize("sync_interval", [1, 4])
def test_graphed_lifecycle_engine_matches_the_eager_engine(cuda, sync_interval):
    """Sampled and greedy requests with priorities on a pool that
    preempts, a cancel and a poisoned slot: the graphed engine equals its
    eager twin in streams, statuses, preemptions, quarantines, host syncs,
    stalls, pool bytes outside the null block and launch counts, with at
    most four graphs."""
    cfg, params = _small_engine_params(None, cuda)
    r = np.random.RandomState(2)
    reqs = [dict(prompt=r.randint(0, 128, size=r.randint(3, 9)).tolist(),
                 max_tokens=int(r.randint(8, 20)), temperature=0.8 * (i % 2),
                 seed=10 + i, priority=i % 2) for i in range(8)]

    def serve(eager):
        tpa.add_launch_counts({k: -n for k, n in tpa.launch_counts().items()})
        inj = tf.FaultInjector(3)
        inj.arm(tf.FaultProfile(nan_logits_rate=1.0, slots=(1,), steps=(4,)))
        eng = tp.PagedServeEngine(params=params, cfg=cfg, device=cuda, n_slots=3,
                                  n_blocks=9, block_size=4, prompt_bucket=32, top_k=20,
                                  sync_interval=sync_interval, fault_injector=inj)
        with ts.disable_graphs() if eager else contextlib.nullcontext():
            comps = _lifecycle_drive(eng, reqs)
        torch.cuda.synchronize()
        streams = sorted((c.request_id, c.generated, c.status) for c in comps)
        return eng, streams, _launch_counts()

    graphed, streams, counts = serve(eager=False)
    eager, want, want_counts = serve(eager=True)
    assert streams == want and counts == want_counts and counts["append"] > 0
    assert {s for _, _, s in streams} == {"ok", "cancelled", "quarantined"}
    for attr in ("preempted_count", "quarantined", "host_syncs", "stalled_steps", "free_blocks"):
        assert getattr(graphed, attr) == getattr(eager, attr), attr
    assert graphed.preempted_count > 0
    assert torch.equal(graphed._cache.k[:, 1:], eager._cache.k[:, 1:])
    assert torch.equal(graphed._cache.v[:, 1:], eager._cache.v[:, 1:])
    assert 0 < len(graphed.graphs) <= 4 and eager.graphs == {}
    assert all(g.graph is not None for g in graphed.graphs.values() if g.calls >= 2)


def _dense_traffic(case):
    """The dense engine's cases: greedy requests (``sync1``, ``sync4``),
    requests over two shared 6-token system prompts (``prefix``), and
    sampled and greedy ones (``lifecycle``, driven with a cancel and a
    poisoned slot)."""
    r = np.random.RandomState(4)
    if case == "prefix":
        systems = [r.randint(0, 128, size=6).tolist() for _ in range(2)]
        return [(systems[i % 2] + r.randint(0, 128, size=r.randint(1, 12)).tolist(),
                 int(r.randint(4, 16))) for i in range(7)]
    if case == "lifecycle":
        return [dict(prompt=r.randint(0, 128, size=r.randint(3, 12)).tolist(),
                     max_tokens=int(r.randint(8, 20)), temperature=0.8 * (i % 2), seed=10 + i)
                for i in range(7)]
    return [(r.randint(0, 128, size=r.randint(3, 20)).tolist(), int(r.randint(4, 20)))
            for _ in range(6)]


@pytest.mark.parametrize("bits", [None, 4])
@pytest.mark.parametrize("case", ["sync1", "sync4", "prefix", "lifecycle"])
def test_graphed_dense_engine_matches_the_eager_engine(cuda, bits, case):
    """The dense engine's programs as CUDA graphs against the same engine
    run eagerly: streams, statuses, host syncs, prefix hits, quarantines,
    cache bytes and kernel launch counts identical, at most four graphs,
    each called twice captured; and the card's greedy streams equal the
    CPU engine's."""
    cfg, params = _small_engine_params(bits, cuda)
    reqs = _dense_traffic(case)
    kw = dict(n_slots=3, prompt_bucket=24, sync_interval=1 if case == "sync1" else 4)
    if case == "prefix":
        kw.update(prefix_bucket=6, prefix_cache_entries=2)
    if case == "lifecycle":
        kw.update(top_k=20)

    def serve(eager, device=cuda):
        tpa.add_launch_counts({k: -n for k, n in tpa.launch_counts().items()})
        ti4.add_launch_counts({k: -n for k, n in ti4.launch_counts().items()})
        inj = None
        if case == "lifecycle":
            inj = tf.FaultInjector(3)
            inj.arm(tf.FaultProfile(nan_logits_rate=1.0, slots=(1,), steps=(3,)))
        p = params if device == cuda else _to(params, "cpu")
        eng = ts.ServeEngine(params=p, cfg=cfg, device=device, fault_injector=inj, **kw)
        with ts.disable_graphs() if eager else contextlib.nullcontext():
            if case == "lifecycle":
                comps = _lifecycle_drive(eng, reqs, cancel_after=2)
            else:
                comps = eng.pump(reqs)
        if device == cuda:
            torch.cuda.synchronize()
        streams = sorted((c.request_id, c.generated, c.status) for c in comps)
        return eng, streams, _launch_counts()

    graphed, streams, counts = serve(eager=False)
    eager, want, want_counts = serve(eager=True)
    assert streams == want and counts == want_counts
    for attr in ("host_syncs", "prefix_hits", "prefix_misses", "quarantined"):
        assert getattr(graphed, attr) == getattr(eager, attr), attr
    assert torch.equal(graphed._cache.k, eager._cache.k)
    assert torch.equal(graphed._cache.v, eager._cache.v)
    assert (counts["int4.launches"] > 0) == bool(bits) and counts["append"] == 0
    assert eager.graphs == {} and 0 < len(graphed.graphs) <= 4
    assert all(g.graph is not None for g in graphed.graphs.values() if g.calls >= 2)
    if case == "prefix":
        assert set(graphed.graphs) == {"admission", "prefix admission", "burst k=4"}
        assert graphed.prefix_hits > 0
    if case == "lifecycle":
        assert {s for _, _, s in streams} == {"ok", "cancelled", "quarantined"}
    else:
        _, on_cpu, _ = serve(eager=True, device=torch.device("cpu"))
        assert streams == on_cpu


def test_dense_engine_int4_launches_both_kernels(cuda):
    """bf16 int4 block weights: decode steps (M = n_slots) go through the
    split-K kernel and admissions (M = the prompt bucket, over 16) through
    the wgmma one, both inside the dense engine's graphs."""
    cfg = tb.ModelConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
                         n_layers=2, d_ff=128, max_seq=64, rope=True, dtype=torch.bfloat16)
    params = _to(tq.quantize_blocks(tb.init_params(torch.Generator().manual_seed(0), cfg),
                                    bits=4), cuda)
    ti4.add_launch_counts({k: -n for k, n in ti4.launch_counts().items()})
    eng = ts.ServeEngine(params=params, cfg=cfg, device=cuda, n_slots=3, prompt_bucket=24,
                         sync_interval=4, cache_dtype=torch.bfloat16)
    comps = eng.pump(_dense_traffic("sync4"))
    torch.cuda.synchronize()
    assert len(comps) == 6 and all(c.status == "ok" for c in comps)
    assert ti4.kernel_launches["int4_splitk"] > 0 and ti4.kernel_launches["int4_wgmma"] > 0
    assert {"admission", "burst k=4"} <= set(eng.graphs)
    assert all(g.graph is not None for g in eng.graphs.values() if g.calls >= 2)


def _admission_traffic(seed=5, n=8):
    """Requests sharing one of two 16-token system prompts, 1-12 tokens of
    their own and 4-16 new ones; odd ones sampled with seeds."""
    r = np.random.RandomState(seed)
    systems = [r.randint(0, 128, size=16).tolist() for _ in range(2)]
    return [dict(prompt=systems[i % 2] + r.randint(0, 128, size=int(r.randint(1, 13))).tolist(),
                 max_tokens=int(r.randint(4, 17)), temperature=0.8 * (i % 2), seed=i)
            for i in range(n)]


@pytest.mark.parametrize("bits", [None, 4])
@pytest.mark.parametrize("chunk,n_blocks", [(0, 40), (2, 40), (2, 9)],
                         ids=["prefix", "prefix-chunked", "prefix-chunked-tight"])
def test_graphed_admission_engine_matches_the_eager_engine(cuda, bits, chunk, n_blocks):
    """The prefix store, chunked or not (the tight pool preempts requests
    holding shared blocks), graphed against the same engine run eagerly:
    streams, statuses, host syncs, stalls, preemptions, prefix hits,
    misses and store, pool bytes outside the null block and kernel launch
    counts identical; the graphs stay within ``graph_bound``, each
    captured once."""
    cfg, params = _small_engine_params(bits, cuda)
    reqs = _admission_traffic()
    kw = dict(n_slots=3, n_blocks=n_blocks, block_size=8, prompt_bucket=32, sync_interval=3,
              top_k=5, prefix_cache_blocks=4, prefill_chunk_blocks=chunk)

    def serve(eager):
        tpa.add_launch_counts({k: -n for k, n in tpa.launch_counts().items()})
        ti4.add_launch_counts({k: -n for k, n in ti4.launch_counts().items()})
        eng = tp.PagedServeEngine(params=params, cfg=cfg, device=cuda, **kw)
        with ts.disable_graphs() if eager else contextlib.nullcontext():
            comps = eng.pump(reqs)
        torch.cuda.synchronize()
        streams = sorted((c.request_id, c.generated, c.status) for c in comps)
        return eng, streams, _launch_counts()

    graphed, streams, counts = serve(eager=False)
    eager, want, want_counts = serve(eager=True)
    assert streams == want and len(streams) == len(reqs)
    for attr in ("host_syncs", "stalled_steps", "preempted_count", "prefix_hits",
                 "prefix_misses", "_prefix_store"):
        assert getattr(graphed, attr) == getattr(eager, attr), attr
    assert torch.equal(graphed._cache.k[:, 1:], eager._cache.k[:, 1:])
    assert torch.equal(graphed._cache.v[:, 1:], eager._cache.v[:, 1:])
    assert counts == want_counts and counts["append"] > 0
    assert graphed.prefix_hits > 0 and (n_blocks > 9 or graphed.preempted_count > 0)
    names = set(graphed.graphs)
    assert 0 < len(names) <= graphed.graph_bound == 4 + 3  # widths 8, 16, 24
    assert any(n.startswith("chunk") for n in names)  # with chunk 0, the suffixes
    assert all(g.graph is not None for g in graphed.graphs.values() if g.calls >= 2)
    assert graphed.free_blocks == n_blocks - 1 - len(graphed._prefix_store)


def test_int4_chunk_at_m16_launches_the_split_k_kernel(cuda):
    """bf16 int4 block weights: a 16-token chunk (M = 16) goes through
    ``int4_splitk`` alone and a 32-token one through ``int4_wgmma`` alone;
    inside an engine at ``prefill_chunk_blocks=1`` every chunk replays
    "chunk 16", which launches the split-K kernel and not the other."""
    cfg = tb.ModelConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
                         n_layers=2, d_ff=128, max_seq=64, rope=True, dtype=torch.bfloat16)
    params = _to(tq.quantize_blocks(tb.init_params(torch.Generator().manual_seed(0), cfg),
                                    bits=4), cuda)
    r = np.random.RandomState(3)
    prompt = torch.from_numpy(r.randint(0, 128, size=(1, 64)).astype(np.int32)).to(cuda)
    row = torch.tensor([[3, 1, 6, 2]], dtype=torch.int32, device=cuda)
    for width, kernel in ((16, "int4_splitk"), (32, "int4_wgmma")):
        cache = tp.init_paged_cache(cfg, 8, 16, dtype=torch.bfloat16, device=cuda)
        ti4.add_launch_counts({k: -n for k, n in ti4.launch_counts().items()})
        tp.paged_prefill_chunk(params, prompt, cache, row, torch.tensor(1, device=cuda),
                               cfg=cfg, chunk_len=width)
        torch.cuda.synchronize()
        assert ti4.kernel_launches[kernel] > 0 and ti4.launches == ti4.kernel_launches[kernel]
        written = row[0, 1: 1 + width // 16].long()  # the chunk's blocks, after one done
        assert torch.isfinite(cache.k.float()).all() and cache.k[:, written].any()
    ti4.add_launch_counts({k: -n for k, n in ti4.launch_counts().items()})
    eng = tp.PagedServeEngine(params=params, cfg=cfg, device=cuda, n_slots=3, n_blocks=40,
                              block_size=16, prompt_bucket=64, sync_interval=4,
                              cache_dtype=torch.bfloat16, prefill_chunk_blocks=1)
    comps = eng.pump([(r.randint(0, 128, size=40).tolist(), 6) for _ in range(4)])
    torch.cuda.synchronize()
    assert len(comps) == 4 and all(c.status == "ok" for c in comps)
    chunk16 = eng.graphs["chunk 16"]
    assert chunk16.calls >= 8 and chunk16.graph is not None
    assert chunk16._delta[(ti4.__name__, "int4_splitk")] > 0
    assert chunk16._delta[(ti4.__name__, "int4_wgmma")] == 0


def _spec_traffic(seed=6, n=6):
    """Greedy requests (speculation verifies the argmax), prompts of 3-19
    tokens, 4-19 new ones."""
    r = np.random.RandomState(seed)
    return [(r.randint(0, 128, size=r.randint(3, 20)).tolist(), int(r.randint(4, 20)))
            for _ in range(n)]


def _spec_engine(kind, params, cfg, device, **kw):
    kw = dict(n_slots=3, prompt_bucket=24, sync_interval=4, spec_gamma=3, **kw)
    if kind == "dense":
        return ts.ServeEngine(params=params, cfg=cfg, device=device, **kw)
    return tp.PagedServeEngine(params=params, cfg=cfg, device=device, n_blocks=40,
                               block_size=8, **kw)


@pytest.mark.parametrize("bits", [None, 4])
@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_graphed_spec_engine_matches_the_eager_engine(cuda, kind, bits):
    """Speculative rounds (gamma 3; the int8 self-draft, or with int4
    blocks the int4 self-draft) as CUDA graphs against the same engine run
    eagerly: streams, host syncs, acceptance counts, cache bytes (the pool
    from block 1), the draft cache's bytes and kernel launch counts
    identical; the paged verify window runs the append kernel at nq 4; at
    most the engine's bound of graphs, each called twice captured; and the
    card's f32 streams equal the CPU engine's."""
    cfg, params = _small_engine_params(bits, cuda)
    reqs = _spec_traffic()
    nq = []
    wrapper = tpa.paged_append_attention

    def serve(eager, device=cuda):
        tpa.add_launch_counts({k: -n for k, n in tpa.launch_counts().items()})
        ti4.add_launch_counts({k: -n for k, n in ti4.launch_counts().items()})
        p = params if device == cuda else _to(params, "cpu")
        kw = dict(draft_params=p) if bits else {}
        eng = _spec_engine(kind, p, cfg, device, **kw)
        with ts.disable_graphs() if eager else contextlib.nullcontext():
            comps = eng.pump(reqs)
        if device == cuda:
            torch.cuda.synchronize()
        streams = sorted((c.request_id, c.generated, c.status) for c in comps)
        return eng, streams, _launch_counts()

    def counting(q, *a, **k):
        nq.append(q.shape[1])
        return wrapper(q, *a, **k)

    tpa.paged_append_attention = counting
    try:
        graphed, streams, counts = serve(eager=False)
    finally:
        tpa.paged_append_attention = wrapper
    eager, want, want_counts = serve(eager=True)
    assert streams == want and counts == want_counts and len(streams) == len(reqs)
    for attr in ("host_syncs", "spec_drafted", "spec_accepted"):
        assert getattr(graphed, attr) == getattr(eager, attr), attr
    start = 1 if kind == "paged" else 0  # the null block: a window's spare positions
    for a, b in zip(_cache_tensors(graphed._cache), _cache_tensors(eager._cache)):
        assert torch.equal(a[:, start:], b[:, start:])
    for a, b in zip(graphed._d_cache, eager._d_cache):
        assert torch.equal(a, b)
    assert (counts["int4.launches"] > 0) == bool(bits)
    assert (counts["append"] > 0) == (kind == "paged") and (4 in nq) == (kind == "paged")
    assert eager.graphs == {} and {"spec round", "draft prefill"} <= set(graphed.graphs)
    assert len(graphed.graphs) <= getattr(graphed, "graph_bound", 4)
    assert all(g.graph is not None for g in graphed.graphs.values() if g.calls >= 2)
    if not bits:
        _, on_cpu, _ = serve(eager=True, device=torch.device("cpu"))
        assert streams == on_cpu


@pytest.mark.parametrize("kind,kw", [
    ("paged", dict(sync_interval=4)),
    ("paged", dict(sync_interval=4, prefill_chunk_blocks=1, prefix_cache_blocks=4)),
    ("paged", dict(sync_interval=4, spec_gamma=3)),
    ("dense", dict(sync_interval=4)),
], ids=["paged", "paged-chunked", "paged-spec", "dense"])
def test_graphed_telemetry_twin_on_the_card(cuda, kind, kw):
    """Request telemetry on the card: a graphed engine with telemetry on
    against its graphed ``telemetry_enabled=False`` twin: the same streams,
    host syncs, graph calls per program and kernel launches; the on
    engine's stats count every request and its timelines are in order,
    each request's bursts summing to its tokens after the first."""
    cfg, params = _small_engine_params(None, cuda)
    reqs = _spec_traffic(seed=9, n=7)

    def serve(enabled):
        tpa.add_launch_counts({k: -n for k, n in tpa.launch_counts().items()})
        if kind == "dense":
            eng = ts.ServeEngine(params=params, cfg=cfg, device=cuda, n_slots=3, prompt_bucket=24,
                                 telemetry_enabled=enabled, **kw)
        else:
            eng = tp.PagedServeEngine(params=params, cfg=cfg, device=cuda, n_slots=3,
                                      n_blocks=40, block_size=8, prompt_bucket=24,
                                      telemetry_enabled=enabled, **kw)
        comps = eng.pump(reqs)
        torch.cuda.synchronize()
        streams = sorted((c.request_id, c.generated, c.status) for c in comps)
        calls = {name: g.calls for name, g in eng.graphs.items()}
        return eng, streams, calls, _launch_counts()

    on, streams, calls, counts = serve(True)
    off, want, want_calls, want_counts = serve(False)
    assert streams == want and calls == want_calls and counts == want_counts
    assert on.host_syncs == off.host_syncs > 0 and calls
    st = on.stats()
    assert st.completed == len(reqs) == sum(st.statuses.values()) and st.host_syncs == on.host_syncs
    assert st.tokens_generated == sum(len(g) - 1 for _, g, _ in streams)
    for rid, gen, _ in streams:
        tr = on.telemetry.trace(rid)
        assert (tr["queued_at"] <= tr["submitted_at"] <= tr["admitted_at"]
                == tr["first_token_at"] <= tr["retired_at"])
        assert sum(b["tokens"] for b in tr["bursts"]) == len(gen) - 1
    assert off.stats().completed == 0 and off.telemetry.trace(0) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spec_verify_window_kernel_matches_plain_on_a_served_input(cuda, dtype):
    """The append kernel at the verify window's ``nq = gamma + 1`` on the
    inputs a served round gives it (each layer's first window: q, new k/v,
    the pools before the write, table, positions, write mask; weights and
    pool in ``dtype``), against its plain version: output elementwise
    (``_paged_close``) and the written pool pages identical from block 1."""
    cfg = tb.ModelConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
                         d_ff=128, max_seq=64, rope=True, dtype=dtype)
    params = _to(tb.init_params(torch.Generator().manual_seed(0), cfg), cuda)
    gamma = 3
    rec = {}
    wrapper = tpa.paged_append_attention

    def recording(q, new_k, new_v, k_pools, v_pools, table, pos, layer, write_mask=None):
        if q.shape[1] == gamma + 1 and layer not in rec:
            rec[layer] = tuple(None if t is None else t.clone() for t in (
                q, new_k, new_v, k_pools[layer], v_pools[layer], table, pos, write_mask))
        return wrapper(q, new_k, new_v, k_pools, v_pools, table, pos, layer,
                       write_mask=write_mask)

    tpa.paged_append_attention = recording
    try:
        with ts.disable_graphs():
            eng = _spec_engine("paged", params, cfg, cuda, cache_dtype=dtype)
            eng.pump(_spec_traffic(seed=7, n=4))
    finally:
        tpa.paged_append_attention = wrapper
    assert sorted(rec) == list(range(cfg.n_layers))
    for q, nk, nv, kp, vp, table, pos, wm in rec.values():
        k1, v1, k2, v2 = (t[None].clone() for t in (kp, vp, kp, vp))
        got, _, _ = tpa.paged_append_attention(q, nk, nv, k1, v1, table, pos, 0, write_mask=wm)
        want = tpa.paged_append_attention_plain(q, nk, nv, k2, v2, table, pos, 0, write_mask=wm)
        mag = tpa.paged_append_attention_plain(
            q.float(), nk.float(), nv.float().abs(), kp[None].float(), vp[None].float().abs(),
            table, pos, 0, write_mask=wm)
        torch.cuda.synchronize()
        assert q.shape[1] == gamma + 1 and wm is not None and bool(wm.any())
        _paged_close(got, want, mag)
        assert torch.equal(k1[:, 1:], k2[:, 1:]) and torch.equal(v1[:, 1:], v2[:, 1:])


def test_capture_of_a_host_read_raises(cuda, monkeypatch):
    """A program that reads the device from the host cannot be captured:
    the capture raises, names the program, and nothing runs eagerly in its
    place (the paged kernel's count does not move)."""
    cfg, params = _small_engine_params(None, cuda)

    def finite_rows_with_a_host_read(logits):
        torch.isfinite(logits).all().item()
        return torch.isfinite(logits).all(dim=-1)

    monkeypatch.setattr(td, "finite_rows", finite_rows_with_a_host_read)
    eng = tp.PagedServeEngine(params=params, cfg=cfg, device=cuda, n_slots=3, n_blocks=12,
                              block_size=8, prompt_bucket=24, sync_interval=4)
    eng.submit([5, 6, 7], max_tokens=8)  # first call of each program: eager
    before = tpa.launches["append"]
    free = eng.free_blocks
    with pytest.raises(ts.GraphCaptureError, match="first token"):
        eng.submit([8, 9, 10, 11], max_tokens=8)  # second call: captured
    assert tpa.launches["append"] == before
    assert eng.free_blocks == free and eng.free_slots() == 2
    assert eng.graphs["first token"].graph is None
    torch.cuda.synchronize()
    assert torch.ones(4, device=cuda).sum().item() == 4  # the card still works


def _to(params, dev):
    def leaf(x):
        if isinstance(x, tq.Quantized4Matrix):
            return tq.Quantized4Matrix(x.packed.to(dev), x.scale.to(dev), x.group_size, x.dtype)
        return x.to(dev)

    out = {k: leaf(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [{k: leaf(v) for k, v in blk.items()} for blk in params["blocks"]]
    return out


FLASH_STEP = {torch.float32: 2 ** -16, torch.bfloat16: 2 ** -7 + 2 ** -16}


def _flash_close(q, k, v, causal, got, want, step, dout=None):
    """``got``/``want``: (out, lse), or (out, lse, dq, dk, dv) with the
    backward run on want's out and lse, each element within step * (|plain|
    + mag) + 2^-16 * mag_f32 (the module's docstring)."""
    out_p, lse_p = want[:2]
    mag = tfa.flash_forward_plain(q, k, v.abs(), causal, out_dtype=torch.float32)[0]
    limits = [step * (out_p.float().abs() + mag) + 2 ** -16 * mag, 2 ** -16 * (1 + lse_p.abs())]
    if dout is not None:
        d32, v32, q32, k32 = (x.float() for x in (dout, v, q, k))
        p = torch.exp(tfa._scores(q, k, causal) - lse_p[..., None])
        dp = torch.einsum("bqd,bkd->bqk", d32, v32)
        ds = (p * (dp - tfa._delta(dout, out_p)[..., None])).to(q.dtype).float().abs()
        dots = p * (torch.einsum("bqd,bkd->bqk", d32.abs(), v32.abs())
                    + (d32 * out_p.float()).abs().sum(-1)[..., None])
        sc = tfa._scale(q.shape[-1])
        w = step * ds + 2 ** -16 * dots
        dq_p, dk_p, dv_p = (x.float().abs() for x in want[2:])
        limits += [
            step * dq_p + sc * torch.einsum("bqk,bkd->bqd", w, k32.abs()),
            step * dk_p + sc * torch.einsum("bqk,bqd->bkd", w, q32.abs()),
            step * dv_p + (step + 2 ** -16) * torch.einsum(
                "bqk,bqd->bkd", p.to(dout.dtype).float(), d32.abs()),
        ]
    for name, g_, w_, limit in zip(("out", "lse", "dq", "dk", "dv"), got, want, limits):
        err = (g_.float() - w_.float()).abs()
        over = int((err > limit).sum())
        assert over == 0, (f"{name}: {over} elements over their limit; max_abs_err "
                           f"{err.max().item()}, max|plain| {w_.float().abs().max().item()}")


def _bit_equal(got, want, name):
    differ = int((got != want).sum())
    assert differ == 0, (f"{name}: {differ} elements differ, by up to "
                         f"{(got.float() - want.float()).abs().max().item()}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 129, 200, 257, 1024])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_kernels_match_plain(cuda, dtype, causal, s, d):
    """Forward (out, lse), dQ and dK/dV each against its plain version on
    the same inputs (the backward on the plain forward's out and lse),
    every element within its limit, at every head dim and at S with one
    row, one whole tile, a ragged last tile, many tiles, or an odd number of
    tiles with a ragged last one (S 129, 257: the f32 kernels' 2-stage K/V
    rings wrap onto a partial tile); the kernels the
    dtype rule names launch (bf16: the wgmma ones, f32: the fma ones) and
    the others do not."""
    g = torch.Generator(device="cpu").manual_seed(7 * s + d)
    q, k, v, dout = (torch.randn((2, s, d), generator=g).to(cuda, dtype) for _ in range(4))
    before = dict(tfa.launches)
    by_kernel = {**tfa.fwd_launches, **tfa.bwd_launches}
    out, lse = tfa._forward_bhsd(q, k, v, causal)
    want_out, want_lse = tfa.flash_forward_plain(q, k, v, causal)
    got = tfa._backward_bhsd(q, k, v, want_out, want_lse, dout, causal)
    want = tfa.flash_backward_plain(q, k, v, want_out, want_lse, dout, causal)
    torch.cuda.synchronize()
    assert all(x.dtype == dtype for x in got)
    _flash_close(q, k, v, causal, (out, lse, *got), (want_out, want_lse, *want),
                 FLASH_STEP[dtype], dout)
    assert {n: tfa.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    names = (tfa.forward_kernel_for(dtype), *tfa.backward_kernel_for(dtype))
    assert all(n.endswith("wgmma" if dtype == torch.bfloat16 else "fma") for n in names)
    after = {**tfa.fwd_launches, **tfa.bwd_launches}
    assert {n: after[n] - by_kernel[n] for n in after} == {n: int(n in names) for n in after}


def test_flash_forward_keeps_f32_partials_over_bf16(cuda):
    g = torch.Generator(device="cpu").manual_seed(9)
    q, k, v = (torch.randn((2, 96, 64), generator=g).to(cuda, torch.bfloat16) for _ in range(3))
    before = tfa.fwd_launches["flash_fwd_wgmma"]
    out, lse = tfa._forward_bhsd(q, k, v, True, out_dtype=torch.float32)
    assert tfa.fwd_launches["flash_fwd_wgmma"] == before + 1
    want, want_lse = tfa.flash_forward_plain(q, k, v, True, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    _flash_close(q, k, v, True, (out, lse), (want, want_lse), FLASH_STEP[torch.bfloat16])


def test_flash_autograd_launches_the_kernels(cuda):
    """``flash_attention`` on [B, S, H, D]: the backward through FlashCore
    launches dQ and dK/dV, and its gradients are the kernels' own on the
    saved forward, bit for bit."""
    g = torch.Generator(device="cpu").manual_seed(5)
    q, k, v, w = (torch.randn((2, 128, 4, 32), generator=g).to(cuda) for _ in range(4))
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
    tfa.launches.update({n: 0 for n in tfa.launches})
    out = tfa.flash_attention(q, k, v)
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    assert tfa.launches == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    bq, bk, bv = (tfa.to_bh(x.detach()) for x in (q, k, v))
    o, lse = tfa._forward_bhsd(bq, bk, bv, True)
    want = tfa._backward_bhsd(bq, bk, bv, o, lse, tfa.to_bh(w), True)
    for x, y, name in zip(got, want, ("dq", "dk", "dv")):
        _bit_equal(x, tfa.from_bh(y, 2, 4), name)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"), (torch.float32, "fma")])
def test_flash_core_backward_runs_the_dtypes_kernels(cuda, dtype, route):
    """A ``FlashCore`` backward launches the dQ and dK/dV kernels of its
    dtype once each and the other route's never."""
    g = torch.Generator(device="cpu").manual_seed(11)
    q, k, v, w = (torch.randn((4, 192, 64), generator=g).to(cuda, dtype) for _ in range(4))
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
    out = tfa.FlashCore.apply(q, k, v, True)
    tfa.bwd_launches.update(dict.fromkeys(tfa.bwd_launches, 0))
    torch.autograd.grad((out.float() * w.float()).sum(), (q, k, v))
    assert tfa.backward_kernel_for(dtype) == (f"flash_bwd_dq_{route}", f"flash_bwd_dkv_{route}")
    assert tfa.bwd_launches == {n: int(n.endswith(route)) for n in tfa.bwd_launches}


# S 129 and 257: an odd number of tiles with a ragged last one, so the f32
# kernels' 2-stage ring wraps onto a partial tile
RING_CASES = [(16, 129), (16, 257), (128, 129), (128, 257)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,s", RING_CASES)
def test_flash_f32_backward_ring_wraps(cuda, causal, d, s):
    """The f32 dQ and dK/dV kernels against their plain versions (on the
    plain forward's out and lse) where the ring wraps onto a ragged tile,
    every element within the limits of ``test_flash_kernels_match_plain``;
    only the fma backward kernels launch."""
    g = torch.Generator(device="cpu").manual_seed(3 * s + d + causal)
    q, k, v, dout = (torch.randn((3, s, d), generator=g).to(cuda) for _ in range(4))
    out, lse = tfa.flash_forward_plain(q, k, v, causal)
    before = dict(tfa.bwd_launches)
    got = tfa._backward_bhsd(q, k, v, out, lse, dout, causal)
    want = tfa.flash_backward_plain(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    assert {n: tfa.bwd_launches[n] - before[n] for n in before} == {
        "flash_bwd_dq_fma": 1, "flash_bwd_dkv_fma": 1, "flash_bwd_dq_wgmma": 0,
        "flash_bwd_dkv_wgmma": 0}
    _flash_close(q, k, v, causal, (out, lse, *got), (out, lse, *want),
                 FLASH_STEP[torch.float32], dout)


@pytest.mark.parametrize("dtype,d,s,causal", [
    *((dt, d, 1024, True) for dt in (torch.float32, torch.bfloat16) for d in (64, 128)),
    *((torch.float32, d, s, c) for d, s in RING_CASES for c in (True, False)),
])
def test_flash_backward_gives_the_same_bits_every_call(cuda, dtype, d, s, causal):
    """Every dQ, dK and dV element is written by one block, summed in a
    fixed order: repeated calls agree bit for bit (in f32 also where the
    ring wraps onto a ragged tile)."""
    g = torch.Generator(device="cpu").manual_seed(d)
    q, k, v, dout = (torch.randn((8, s, d), generator=g).to(cuda, dtype) for _ in range(4))
    out, lse = tfa._forward_bhsd(q, k, v, causal)
    first = tfa._backward_bhsd(q, k, v, out, lse, dout, causal)
    for _ in range(2):
        for x, y, name in zip(tfa._backward_bhsd(q, k, v, out, lse, dout, causal), first,
                              ("dq", "dk", "dv")):
            _bit_equal(x, y, name)


@pytest.mark.parametrize("d,s,causal", [
    *((d, 1024, True) for d in (64, 128)),
    *((d, s, c) for d, s in RING_CASES for c in (True, False)),
])
def test_flash_f32_forward_gives_the_same_bits_every_call(cuda, d, s, causal):
    """Every out and lse element of the f32 forward is written by one block,
    its sums in a fixed order (the row sum over a half-warp's lanes too):
    repeated calls agree bit for bit, also where the K/V ring wraps onto a
    ragged tile."""
    g = torch.Generator(device="cpu").manual_seed(d + s)
    q, k, v = (torch.randn((8, s, d), generator=g).to(cuda) for _ in range(3))
    first = tfa._forward_bhsd(q, k, v, causal)
    for _ in range(2):
        for x, y, name in zip(tfa._forward_bhsd(q, k, v, causal), first, ("out", "lse")):
            _bit_equal(x, y, name)


def test_flash_kernel_raises_instead_of_falling_back(cuda):
    """A head dim or dtype no kernel takes raises, forward and backward; a
    misaligned base, which TMA and 16-byte cp.async refuse, is refused by the
    backward launchers and the f32 forward's themselves, and the wrapper hands
    them an aligned copy instead of dropping to another kernel."""
    z = torch.zeros((2, 64, 24), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfa._forward_bhsd(z, z, z, True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa._forward_bhsd(z[..., :16].half(), z[..., :16].half(), z[..., :16].half(), True)
    g = torch.Generator(device="cpu").manual_seed(4)
    q, k, v, dout = (torch.randn((2, 96, 64), generator=g).to(cuda, torch.bfloat16)
                     for _ in range(4))
    out, lse = tfa._forward_bhsd(q, k, v, True)
    delta = tfa._delta(dout, out)
    for bad in (q.half(), q.float()):
        with pytest.raises(ValueError, match="float32 or bfloat16|share"):
            tfa._dq_bhsd(bad, k, v, lse, dout, delta, True)
        with pytest.raises(ValueError, match="float32 or bfloat16|share"):
            tfa._dkv_bhsd(bad, k, v, lse, dout, delta, True)
    buf = torch.empty(q.numel() + 8, dtype=q.dtype, device=cuda)
    shifted = buf[1:1 + q.numel()].view(q.shape).copy_(q)  # 2 bytes past a 16-byte boundary
    assert shifted.data_ptr() % 16
    lib = tfa._build.load("flash_attention", tfa._LAUNCHERS)
    stream = torch.cuda.current_stream().cuda_stream
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    ptrs = (shifted.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr())
    scale = tfa._scale(64)
    for name, outs in (("flash_bwd_dq_wgmma", (dq,)), ("flash_bwd_dkv_wgmma", (dk, dv))):
        rc = getattr(lib, name)(64, *ptrs, *(o.data_ptr() for o in outs), 2, 96, 1, scale,
                                stream)
        assert rc != 0
        with pytest.raises(RuntimeError, match="launch failed"):
            tfa._build.check("flash_attention", rc, name)
    # the f32 backward reads by 16-byte cp.async: its launchers refuse a
    # misaligned base too
    q32, k32, v32, dout32 = (x.float() for x in (q, k, v, dout))
    buf32 = torch.empty(q32.numel() + 4, device=cuda)
    shifted32 = buf32[1:1 + q32.numel()].view(q32.shape).copy_(q32)  # 4 bytes past
    ptrs32 = (shifted32.data_ptr(), k32.data_ptr(), v32.data_ptr(), dout32.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    dq32, dk32, dv32 = (torch.empty_like(q32) for _ in range(3))
    for name, outs in (("flash_bwd_dq_fma", (dq32,)), ("flash_bwd_dkv_fma", (dk32, dv32))):
        rc = getattr(lib, name)(64, *ptrs32, *(o.data_ptr() for o in outs), 2, 96, 1, scale,
                                stream)
        assert rc != 0
    # and so does the f32 forward, which copies K and V the same way
    assert lib.flash_fwd_fma(64, *ptrs32[:3], dq32.data_ptr(), lse.data_ptr(), 1, 2, 96, 1, scale,
                             stream) != 0
    before = dict(tfa.bwd_launches)
    got = tfa._backward_bhsd(shifted, k, v, out, lse, dout, True, delta=delta)
    assert {n: tfa.bwd_launches[n] - before[n] for n in before} == {
        "flash_bwd_dq_wgmma": 1, "flash_bwd_dkv_wgmma": 1, "flash_bwd_dq_fma": 0,
        "flash_bwd_dkv_fma": 0}
    for x, y, name in zip(got, tfa._backward_bhsd(q, k, v, out, lse, dout, True, delta=delta),
                          ("dq", "dk", "dv")):
        _bit_equal(x, y, name)


def test_flash_train_step_on_the_card_matches_the_cpu(cuda):
    """Two f32 steps of ``build_train_step(attention="flash")`` on the card
    (kernels) and on the CPU (plain versions) from the same params: equal
    losses within 1e-5 relative; the card's step launched the forward
    kernel twice per layer per step (remat recomputes it) and each
    backward kernel once."""
    cfg = tb.ModelConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
                         n_layers=2, d_ff=128, max_seq=64, rope=True, dtype=torch.float32)
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, 128, size=(2, 64)))
    losses = {}
    for dev in ("cpu", cuda):
        fns = tb.build_train_step(cfg, attention="flash", device=dev)
        params = _to(tb.init_params(torch.Generator(device="cpu").manual_seed(0), cfg), dev)
        state = tb.make_optimizer().init(params)
        tfa.launches.update({n: 0 for n in tfa.launches})
        losses[str(dev)] = [fns.step(params, state, toks)[2].item() for _ in range(2)]
    assert tfa.launches == {"flash_fwd": 2 * 2 * 2, "flash_bwd_dq": 2 * 2, "flash_bwd_dkv": 2 * 2}
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)


# -- the train step as one CUDA graph ---------------------------------------

_TRAIN_CFG = dict(vocab_size=256, d_model=128, n_heads=4, n_kv_heads=2, n_layers=2,
                  d_ff=256, max_seq=128, rope=True)


def _train_state(cfg, fns, seed=0):
    return fns.init(torch.Generator(device="cuda").manual_seed(seed))


def _state_leaves(params, state):
    return [*tb.param_leaves(params), state["count"], *state["mu"], *state["nu"]]


def _train_tokens(cfg, b=4, seed=2):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                                size=(b, cfg.max_seq)))


def _zero_flash():
    tfa.add_launch_counts({k: -n for k, n in tfa.launch_counts().items()})


@pytest.mark.parametrize("accum_steps", [1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_graphed_train_step_matches_the_eager_step(cuda, dtype, accum_steps):
    """``build_train_step(...).step`` on the card replays one CUDA graph
    from its third call: over 4 steps its losses, params, moments and count
    equal an eager twin's (``serve.disable_graphs()``) bit for bit, with the
    same flash launch counts; one capture, and the returned loss is a copy
    the next replay leaves alone."""
    cfg = tb.ModelConfig(dtype=dtype, **_TRAIN_CFG)
    toks = _train_tokens(cfg)
    runs = {}
    for eager in (False, True):
        fns = tb.build_train_step(cfg, attention="flash", accum_steps=accum_steps, device=cuda)
        params, state = _train_state(cfg, fns)
        _zero_flash()
        with ts.disable_graphs() if eager else contextlib.nullcontext():
            losses = [fns.step(params, state, toks)[2] for _ in range(4)]
        torch.cuda.synchronize()
        assert int(state["count"]) == 4
        runs[eager] = (fns, losses, _state_leaves(params, state), tfa.launch_counts())
    (fns, losses, leaves, counts), (twin, want, want_leaves, want_counts) = runs[False], runs[True]
    assert fns.captures == 1 and fns.graphed.program.graph is not None
    assert twin.captures == 0 and twin.graphed.program is None
    assert len({x.data_ptr() for x in losses}) == 4
    for a, b in zip(losses, want):
        _bit_equal(a, b, "loss")
    for a, b in zip(leaves, want_leaves):
        _bit_equal(a, b, "state")
    assert counts == want_counts
    n = cfg.n_layers * 4 * accum_steps
    route = "wgmma" if dtype == torch.bfloat16 else "fma"
    assert counts[f"flash_fwd_{route}"] == 2 * n
    assert counts[f"flash_bwd_dq_{route}"] == counts[f"flash_bwd_dkv_{route}"] == n
    assert losses[-1].item() < losses[0].item()


def test_remat_policies_agree_in_the_graphed_step(cuda):
    """"dots", "blocks" and "none" in the graphed bf16 step: 3 steps from
    the same init give the same losses and params bit for bit; the flash
    forward runs twice a layer a step under "dots" and "blocks" (the
    recompute reruns it), once under "none"."""
    cfg = tb.ModelConfig(dtype=torch.bfloat16, **_TRAIN_CFG)
    toks = _train_tokens(cfg)
    runs = {}
    for remat in ("dots", "blocks", "none"):
        fns = tb.build_train_step(cfg, attention="flash", remat=remat, device=cuda)
        params, state = _train_state(cfg, fns)
        _zero_flash()
        losses = torch.stack([fns.step(params, state, toks)[2] for _ in range(3)])
        torch.cuda.synchronize()
        assert fns.captures == 1
        runs[remat] = (losses, tb.param_leaves(params), dict(tfa.fwd_launches))
    for remat in ("dots", "blocks"):
        _bit_equal(runs[remat][0], runs["none"][0], f"{remat} losses")
        for a, b in zip(runs[remat][1], runs["none"][1]):
            _bit_equal(a, b, f"{remat} params")
    per_step = {remat: runs[remat][2]["flash_fwd_wgmma"] // (3 * cfg.n_layers) for remat in runs}
    assert per_step == {"dots": 2, "blocks": 2, "none": 1}


def test_train_step_capture_of_a_host_read_raises(cuda, monkeypatch):
    """A train step that reads the device from the host cannot be captured:
    the capture raises GraphCaptureError naming the train step, nothing runs
    eagerly in its place (params and count as the eager call left them),
    and the card still works."""
    cfg = tb.ModelConfig(dtype=torch.float32, **_TRAIN_CFG)
    fns = tb.build_train_step(cfg, attention="flash", device=cuda)
    params, state = _train_state(cfg, fns)
    toks = _train_tokens(cfg)
    real = tb.shift_nll

    def shift_nll_with_a_host_read(logits, tokens):
        loss = real(logits, tokens)
        loss.item()
        return loss

    monkeypatch.setattr(tb, "shift_nll", shift_nll_with_a_host_read)
    fns.step(params, state, toks)  # first call: eager
    torch.cuda.synchronize()
    before = [t.clone() for t in _state_leaves(params, state)]
    with pytest.raises(ts.GraphCaptureError, match="train step"):
        fns.step(params, state, toks)
    torch.cuda.synchronize()
    assert int(state["count"]) == 1 and fns.captures == 0
    for a, b in zip(_state_leaves(params, state), before):
        _bit_equal(a, b, "state after a failed capture")
    assert torch.ones(4, device=cuda).sum().item() == 4


def test_restore_in_place_replays_without_a_new_capture(cuda, tmp_path):
    """The reference's resume test on the graphed step: 2 steps, save, step
    3, restore into the same tensors, step 3 again: the same loss bit for
    bit, from the graph already captured."""
    from k8s_dra_driver_torch.models.train_checkpoint import TrainCheckpointer

    cfg = tb.ModelConfig(dtype=torch.bfloat16, **_TRAIN_CFG)
    fns = tb.build_train_step(cfg, attention="flash", device=cuda)
    params, state = _train_state(cfg, fns)
    toks = _train_tokens(cfg)
    for _ in range(2):
        fns.step(params, state, toks)
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    ckpt.save(2, (params, state))
    _, _, l3 = fns.step(params, state, toks)
    captures = fns.captures
    ptrs = [t.data_ptr() for t in _state_leaves(params, state)]
    assert ckpt.restore(like=(params, state)) == (params, state)
    assert [t.data_ptr() for t in _state_leaves(params, state)] == ptrs
    assert int(state["count"]) == 2
    _, _, l3b = fns.step(params, state, toks)
    _bit_equal(l3b, l3, "resumed loss")
    assert fns.captures == captures == 1
    ckpt.close()


def test_graphed_train_step_replay_runs_the_flash_kernels(cuda):
    """A replay's profile holds the three flash kernels of the dtype (the
    forward twice a layer, dQ and dK/dV once), launched from inside the
    graph."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = tb.ModelConfig(dtype=torch.bfloat16, **_TRAIN_CFG)
    fns = tb.build_train_step(cfg, attention="flash", device=cuda)
    params, state = _train_state(cfg, fns)
    toks = _train_tokens(cfg)
    for _ in range(2):
        fns.step(params, state, toks)  # eager, then captured
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fns.step(params, state, toks)
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            kernels[ev.key] = kernels.get(ev.key, 0) + ev.count
    for name, per_layer in (("flash_fwd_wgmma", 2), ("flash_bwd_dq_wgmma", 1),
                            ("flash_bwd_dkv_wgmma", 1)):
        hits = sum(n for key, n in kernels.items() if name in key)
        assert hits == per_layer * cfg.n_layers, (name, kernels)
    assert fns.graphed.program.calls == 3


# -- LoRA: adapted engines and the adapter-only train step -------------------

def _lora_bank_on(cfg, dev, seed=3):
    """``(LoraConfig, bank)``: two adapters with A from ``init_adapters``
    and B 0.3 times a normal (the JAX tests' recipe), stacked on ``dev``."""
    from k8s_dra_driver_torch.models import lora as tl

    lcfg = tl.LoraConfig(rank=4, alpha=8.0)
    g = torch.Generator().manual_seed(seed)
    ads = []
    for _ in range(2):
        ad = tl.init_adapters(g, cfg, lcfg)
        for blk in ad["blocks"]:
            for name, ab in blk.items():
                blk[name] = {"a": ab["a"].to(dev),
                             "b": (0.3 * torch.randn(ab["b"].shape, generator=g)).to(dev)}
        ads.append(ad)
    return lcfg, tl.stack_adapters(cfg, lcfg, ads)


def _lora_engine(kind, params, cfg, device, bank, **kw):
    kw = dict(dict(n_slots=3, prompt_bucket=24, sync_interval=4, adapter_bank=bank), **kw)
    if kind == "dense":
        return ts.ServeEngine(params=params, cfg=cfg, device=device, **kw)
    return tp.PagedServeEngine(params=params, cfg=cfg, device=device, n_blocks=40,
                               block_size=8, **kw)


@pytest.mark.parametrize("case", ["sync4", "spec", "prefix"])
@pytest.mark.parametrize("bits", [None, 4])
@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_graphed_lora_engine_matches_the_eager_engine(cuda, kind, bits, case):
    """Adapters 0, 1, 2 mixed in every burst (with speculation, gamma 3,
    or with the prefix store), as CUDA graphs against the same engine run
    eagerly: streams, host syncs, cache bytes (the pool from block 1) and
    launch counts identical, the per-slot ids kept in one buffer; the
    card's f32 streams equal the CPU engine's, and its adapter-0 streams
    a bank-less graphed engine's."""
    cfg, params = _small_engine_params(bits, cuda)
    if case == "spec" and bits:
        pytest.skip("an int4 target needs its draft given; the int8 self-draft is f32 here")
    extra = {"sync4": {}, "spec": dict(spec_gamma=3),
             "prefix": dict(prompt_bucket=40, **(dict(prefix_cache_blocks=4) if kind == "paged"
                                                 else dict(prefix_bucket=8)))}[case]
    system = list(range(40, 56))
    reqs = [dict(prompt=(system if case == "prefix" else []) + p, max_tokens=m, adapter=i % 3)
            for i, (p, m) in enumerate(_spec_traffic(n=7))]
    _, bank = _lora_bank_on(cfg, cuda)

    def serve(eager, device=cuda, with_bank=True):
        tpa.add_launch_counts({k: -n for k, n in tpa.launch_counts().items()})
        ti4.add_launch_counts({k: -n for k, n in ti4.launch_counts().items()})
        p = params if device == cuda else _to(params, "cpu")
        b = None
        if with_bank:
            b = bank if device == cuda else {
                "blocks": [{n: {k: t.cpu() for k, t in ab.items()} for n, ab in blk.items()}
                           for blk in bank["blocks"]], "scale": bank["scale"]}
        eng = _lora_engine(kind, p, cfg, device, b, **extra)
        ids = None if b is None else eng._adapter_ids.data_ptr()
        run = reqs if with_bank else [dict(r, adapter=0) for r in reqs]
        with ts.disable_graphs() if eager else contextlib.nullcontext():
            comps = eng.pump(run)
        if device == cuda:
            torch.cuda.synchronize()
        assert b is None or eng._adapter_ids.data_ptr() == ids
        return eng, {c.request_id: (c.generated, c.status) for c in comps}, _launch_counts()

    graphed, streams, counts = serve(eager=False)
    eager, want, want_counts = serve(eager=True)
    assert streams == want and counts == want_counts and len(streams) == len(reqs)
    assert graphed.host_syncs == eager.host_syncs
    start = 1 if kind == "paged" else 0
    for a, b in zip(_cache_tensors(graphed._cache), _cache_tensors(eager._cache)):
        assert torch.equal(a[:, start:], b[:, start:])
    assert (counts["int4.launches"] > 0) == bool(bits)
    assert len(graphed.graphs) <= getattr(graphed, "graph_bound", 4)
    assert all(g.graph is not None for g in graphed.graphs.values() if g.calls >= 2)
    _, base_streams, _ = serve(eager=False, with_bank=False)
    assert all(streams[i] == base_streams[i] for i, r in enumerate(reqs) if r["adapter"] == 0)
    assert any(streams[i] != base_streams[i] for i, r in enumerate(reqs) if r["adapter"])
    if not bits:
        _, on_cpu, _ = serve(eager=True, device=torch.device("cpu"))
        assert streams == on_cpu


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graphed_lora_train_step_matches_the_eager_step(cuda, dtype):
    """``lora.build_lora_train_step(attention="flash")`` on the card: three
    graphed steps (one capture) against three eager ones from the same
    adapters, bit for bit (losses, adapters, count, moments), the flash
    kernels launched as a remat "blocks" step launches them, the base bit
    for bit unchanged; in f32 the losses within 1e-5 of the CPU's."""
    from k8s_dra_driver_torch.models import lora as tl

    cfg = tb.ModelConfig(**dict(_TRAIN_CFG, dtype=dtype))
    lcfg = tl.LoraConfig(rank=4, alpha=8.0)
    base = tb.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    before = [t.clone() for t in tb.param_leaves(base)]
    toks = _train_tokens(cfg)
    runs = {}
    for mode in ("graphed", "eager"):
        fns = tl.build_lora_train_step(cfg, lcfg, lr=1e-2, attention="flash")
        ad, st = fns.init(torch.Generator(device="cuda").manual_seed(1))
        _zero_flash()
        with ts.disable_graphs() if mode == "eager" else contextlib.nullcontext():
            losses = torch.stack([fns.step(ad, st, base, toks)[2] for _ in range(3)])
        torch.cuda.synchronize()
        runs[mode] = (fns, ad, st, losses, dict(tfa.launches))
    (gf, gad, gst, gl, gc), (ef, ead, est, el, ec) = runs["graphed"], runs["eager"]
    assert gf.captures == 1 and ef.captures == 0
    assert torch.equal(gl, el) and gc == ec
    assert gc == {"flash_fwd": 2 * 2 * 3, "flash_bwd_dq": 2 * 3, "flash_bwd_dkv": 2 * 3}
    for a, b in zip(_state_leaves(gad, gst), _state_leaves(ead, est)):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(tb.param_leaves(base), before))
    assert gl[-1] < gl[0]
    if dtype == torch.float32:
        cpu_fns = tl.build_lora_train_step(cfg, lcfg, lr=1e-2, attention="flash", device="cpu")
        cpu_base = _to(base, "cpu")
        ad, st = cpu_fns.init(torch.Generator().manual_seed(1))
        first = tl.init_adapters(torch.Generator(device="cuda").manual_seed(1), cfg, lcfg)
        for x, y in zip(tb.param_leaves(ad), tb.param_leaves(first)):
            x.copy_(y.cpu())
        cpu = [cpu_fns.step(ad, st, cpu_base, toks)[2].item() for _ in range(3)]
        np.testing.assert_allclose(gl.cpu().numpy(), cpu, rtol=1e-5)


# -- mixture-of-experts and quantized pools -------------------------------------

_MOE = dict(n_experts=4, moe_top_k=2)


@pytest.mark.parametrize("bits", [None, 4])
@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_graphed_moe_engine_matches_the_eager_engine(cuda, kind, bits):
    """An MoE model (4 experts, top-2, every expert on every token) served
    as CUDA graphs against the same engine run eagerly: streams, host
    syncs, cache bytes (the pool from block 1) and launch counts
    identical, each graph captured once; the card's f32 streams equal the
    CPU engine's; the int4 base launches the int4 kernels on the attention
    projections and leaves the expert stacks in f32."""
    cfg = tb.ModelConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
                         d_ff=128, max_seq=64, rope=True, dtype=torch.float32, **_MOE)
    params = tb.init_params(torch.Generator().manual_seed(0), cfg)
    if bits:
        params = tq.quantize_blocks(params, bits=bits)
        assert isinstance(params["blocks"][0]["expert_up"], torch.Tensor)
    reqs = _spec_traffic(n=7)

    def serve(eager, device=cuda):
        tpa.add_launch_counts({k: -n for k, n in tpa.launch_counts().items()})
        ti4.add_launch_counts({k: -n for k, n in ti4.launch_counts().items()})
        kw = dict(n_slots=3, prompt_bucket=24, sync_interval=4)
        p = _to(params, device)
        if kind == "dense":
            eng = ts.ServeEngine(params=p, cfg=cfg, device=device, **kw)
        else:
            eng = tp.PagedServeEngine(params=p, cfg=cfg, device=device, n_blocks=40,
                                      block_size=8, **kw)
        with ts.disable_graphs() if eager else contextlib.nullcontext():
            comps = eng.pump(reqs)
        if device == cuda:
            torch.cuda.synchronize()
        return eng, {c.request_id: (c.generated, c.status) for c in comps}, _launch_counts()

    graphed, streams, counts = serve(eager=False)
    eager, want, want_counts = serve(eager=True)
    assert streams == want and counts == want_counts and len(streams) == len(reqs)
    assert graphed.host_syncs == eager.host_syncs
    start = 1 if kind == "paged" else 0
    for a, b in zip(_cache_tensors(graphed._cache), _cache_tensors(eager._cache)):
        assert torch.equal(a[:, start:], b[:, start:])
    assert (counts["int4.launches"] > 0) == bool(bits)
    assert (counts["append"] > 0) == (kind == "paged")
    assert all(g.graph is not None for g in graphed.graphs.values() if g.calls >= 2)
    if not bits:
        _, on_cpu, _ = serve(eager=True, device=torch.device("cpu"))
        assert streams == on_cpu


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_graphed_moe_train_step_matches_the_eager_step(cuda, dtype):
    """``build_train_step(attention="flash")`` over an MoE model on the
    card: three graphed steps (one capture) against three eager ones from
    the same init, bit for bit (losses, params, count, moments), the
    flash kernels launched as a remat "blocks" step launches them, the
    loss falling; in f32 the losses within 1e-5 relative of the CPU's."""
    cfg = tb.ModelConfig(dtype=dtype, **_TRAIN_CFG, **_MOE)
    toks = _train_tokens(cfg)
    runs = {}
    for mode in ("graphed", "eager"):
        fns = tb.build_train_step(cfg, attention="flash", device=cuda)
        params, state = _train_state(cfg, fns)
        _zero_flash()
        with ts.disable_graphs() if mode == "eager" else contextlib.nullcontext():
            losses = torch.stack([fns.step(params, state, toks)[2] for _ in range(3)])
        torch.cuda.synchronize()
        runs[mode] = (fns, losses, _state_leaves(params, state), dict(tfa.launches))
    (gf, gl, gleaves, gc), (ef, el, eleaves, ec) = runs["graphed"], runs["eager"]
    assert gf.captures == 1 and ef.captures == 0
    _bit_equal(gl, el, "losses")
    for a, b in zip(gleaves, eleaves):
        _bit_equal(a, b, "state")
    assert gc == ec == {"flash_fwd": 2 * 2 * 3, "flash_bwd_dq": 2 * 3, "flash_bwd_dkv": 2 * 3}
    assert gl[-1] < gl[0]
    if dtype == torch.float32:
        cpu_fns = tb.build_train_step(cfg, attention="flash", device="cpu")
        params, state = cpu_fns.init(torch.Generator().manual_seed(0))
        first, _ = _train_state(cfg, tb.build_train_step(cfg, attention="flash", device=cuda))
        for x, y in zip(tb.param_leaves(params), tb.param_leaves(first)):
            x.copy_(y.cpu())
        cpu = [cpu_fns.step(params, state, toks)[2].item() for _ in range(3)]
        np.testing.assert_allclose(gl.cpu().numpy(), cpu, rtol=1e-5)


@pytest.mark.parametrize("case", ["sync4", "spec", "prefix"])
@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_graphed_quantized_pool_engine_matches_the_eager_engine(cuda, kv_dtype, case):
    """A quantized pool (the reference's XLA route in plain PyTorch) served
    as CUDA graphs against the same engine run eagerly: streams, host
    syncs, pool bytes and scales from block 1 identical, each graph
    captured once, and no paged kernel launched; the card's f32 streams
    equal the CPU engine's.  With speculation the verify window (gamma 4)
    is wider than a block of 4: the quantized route takes any window."""
    cfg, params = _small_engine_params(None, cuda)
    extra = {"sync4": {}, "spec": dict(spec_gamma=4, block_size=4, n_blocks=80),
             "prefix": dict(prompt_bucket=40, prefix_cache_blocks=4, prefill_chunk_blocks=1)}[case]
    system = list(range(40, 56))
    reqs = [((system if case == "prefix" else []) + p, m) for p, m in _spec_traffic(n=7)]

    def serve(eager, device=cuda):
        tpa.add_launch_counts({k: -n for k, n in tpa.launch_counts().items()})
        kw = dict(dict(n_slots=3, prompt_bucket=24, sync_interval=4, n_blocks=40, block_size=8,
                       kv_dtype=kv_dtype), **extra)
        eng = tp.PagedServeEngine(params=params if device == cuda else _to(params, "cpu"),
                                  cfg=cfg, device=device, **kw)
        with ts.disable_graphs() if eager else contextlib.nullcontext():
            comps = eng.pump(reqs)
        if device == cuda:
            torch.cuda.synchronize()
        return eng, {c.request_id: (c.generated, c.status) for c in comps}, tpa.launch_counts()

    graphed, streams, counts = serve(eager=False)
    eager, want, want_counts = serve(eager=True)
    assert streams == want and len(streams) == len(reqs)
    assert counts == want_counts == {"append": 0, "window": 0}
    assert graphed.host_syncs == eager.host_syncs and graphed._cache.kv_dtype == kv_dtype
    for a, b in zip(_cache_tensors(graphed._cache), _cache_tensors(eager._cache)):
        assert torch.equal(a[:, 1:], b[:, 1:])
    assert len(graphed.graphs) <= graphed.graph_bound
    assert all(g.graph is not None for g in graphed.graphs.values() if g.calls >= 2)
    _, on_cpu, _ = serve(eager=True, device=torch.device("cpu"))
    assert streams == on_cpu


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_kv_block_codec_on_the_card_equals_the_cpu(cuda, kv_dtype):
    """``quantize_kv_blocks`` and ``dequant_kv_blocks`` on the card give
    the CPU's bytes, scales and values on the same f32 input (an all-zero
    block and x.5 ties included)."""
    x = torch.from_numpy((np.random.RandomState(3).standard_normal((2, 6, 2, 16, 8)) * 3)
                         .astype(np.float32))
    x[0, 1] = 0.0
    x[1, 2] = torch.tensor([0.5, 1.5, 2.5, -2.5]).repeat(64).reshape(2, 16, 8)
    qc, sc = tq.quantize_kv_blocks(x, kv_dtype)
    qd, sd = tq.quantize_kv_blocks(x.to(cuda), kv_dtype)
    assert torch.equal(qd.cpu(), qc) and torch.equal(sd.cpu(), sc)
    assert torch.equal(tq.dequant_kv_blocks(qd, sd).cpu(), tq.dequant_kv_blocks(qc, sc))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graphed_engine_after_a_handoff_matches_the_eager_engine(cuda, dtype, kv_dtype):
    """A paged -> paged handoff on the card through the wire frame: the
    decode engine's injected blocks hold the source's bytes (and scales),
    the graphed decode engine equals its eager twin in streams, host syncs,
    launches and pool bytes from block 1 (the inject writes the pool the
    graphs were captured over, in place), the append kernel launches on a
    float pool, and the f32 streams equal the CPU engine's."""
    cfg, params = _small_engine_params(None, cuda)
    reqs = [dict(prompt=p, max_tokens=m) for p, m in _spec_traffic(n=5)]
    kw = dict(n_slots=3, prompt_bucket=24, sync_interval=4, n_blocks=40, block_size=8,
              cache_dtype=dtype, kv_dtype=kv_dtype)

    def serve(eager, device=cuda):
        p = params if device == cuda else _to(params, "cpu")
        pre = tp.PagedServeEngine(params=p, cfg=cfg, device=device, **kw)
        for r in reqs:
            pre.submit(handoff=True, **r)
        entries = []
        for e in pre.take_handoffs():
            rid, kv = ts.KVSlice.from_wire(e["kv"].to_wire(e["request_id"]))
            entries.append(dict(e, kv=kv))
        tpa.add_launch_counts({k: -n for k, n in tpa.launch_counts().items()})
        dec = tp.PagedServeEngine(params=p, cfg=cfg, device=device, **kw)
        with ts.disable_graphs() if eager else contextlib.nullcontext():
            dec.restore({"next_id": len(reqs), "requests": entries})
            for slot, st in enumerate(dec._slots):
                if st is not None:
                    kv = next(e["kv"] for e in entries if e["request_id"] == st.request_id)
                    got = dec._capture_kv(slot, kv.valid_len)
                    for name in ("k", "v", "k_scale", "v_scale"):
                        if getattr(kv, name) is not None:
                            assert np.array_equal(getattr(got, name), getattr(kv, name)), name
            dec.run_until_drained()
            comps = dec.completions()
        if device == cuda:
            torch.cuda.synchronize()
        return dec, {c.request_id: (c.generated, c.status) for c in comps}, tpa.launch_counts()

    graphed, streams, counts = serve(eager=False)
    eager, want, want_counts = serve(eager=True)
    assert streams == want and len(streams) == len(reqs)
    assert counts == want_counts and (counts["append"] > 0) == (kv_dtype is None)
    assert graphed.host_syncs == eager.host_syncs
    for a, b in zip(_cache_tensors(graphed._cache), _cache_tensors(eager._cache)):
        assert torch.equal(a[:, 1:], b[:, 1:])
    assert all(g.graph is not None for g in graphed.graphs.values() if g.calls >= 2)
    if dtype == torch.float32:
        _, on_cpu, _ = serve(eager=True, device=torch.device("cpu"))
        assert streams == on_cpu
