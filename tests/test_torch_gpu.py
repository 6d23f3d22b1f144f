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
Train-step losses within 1e-5 relative of the CPU's."""

import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models import quant as tq
from k8s_dra_driver_torch.ops import flash_attention as tfa
from k8s_dra_driver_torch.ops import int4_matmul as ti4
from k8s_dra_driver_torch.ops import paged_attention as tpa

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
@pytest.mark.parametrize("s", [1, 63, 64, 65, 200, 1024])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_kernels_match_plain(cuda, dtype, causal, s, d):
    """Forward (out, lse), dQ and dK/dV each against its plain version on
    the same inputs (the backward on the plain forward's out and lse),
    every element within its limit, at every head dim and at S with one
    row, one whole tile, a ragged last tile or many tiles; the kernels the
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


def test_flash_kernel_raises_instead_of_falling_back(cuda):
    """A head dim or dtype no kernel takes raises, forward and backward; a
    misaligned base, which TMA and 16-byte cp.async refuse, is refused by the
    backward launchers themselves, and the wrapper hands them an aligned copy
    instead of dropping to another kernel."""
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
