"""The PyTorch port's CUDA kernels on the card: each against its plain
PyTorch version, and the paged engine on the card against the same engine
on the CPU.  Every test here is marked ``gpu`` and skips without a card.
The file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: float32 within 1e-5 (sums in another order; TF32 off); bf16
within 3e-2 (outputs of magnitude ~1 rounded to bf16, probabilities
rounded before normalisation in the kernel and after it in the plain
version); appended pool bytes and greedy streams identical."""

import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models import quant as tq
from k8s_dra_driver_torch.ops import int4_matmul as ti4
from k8s_dra_driver_torch.ops import paged_attention as tpa

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,pos", [(1, [0, 20, 47]), (3, [6, 14, 45])])
def test_append_kernel_matches_plain(cuda, dtype, nq, pos):
    k, v, table, g = _pools(cuda, dtype)
    b, hq, d = 3, 8, 16
    q = torch.randn((b, nq, hq, d), generator=g).to(cuda, dtype)
    nk = torch.randn((b, nq, 2, d), generator=g).to(cuda, dtype)
    nv = torch.randn((b, nq, 2, d), generator=g).to(cuda, dtype)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    wmask = torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda)
    k2, v2 = k.clone(), v.clone()
    before = tpa.launches["append"]
    out, _, _ = tpa.paged_append_attention(q, nk, nv, k, v, table, pos, 1, write_mask=wmask)
    want = tpa.paged_append_attention_plain(q, nk, nv, k2, v2, table, pos, 1, write_mask=wmask)
    torch.cuda.synchronize()
    assert tpa.launches["append"] == before + 1
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(k[:, 1:], k2[:, 1:]) and torch.equal(v[:, 1:], v2[:, 1:])
    got_w = tpa.paged_window_attention(q, k2[1], v2[1], table, pos)
    want_w = tpa.paged_window_attention_plain(q, k2[1], v2[1], table, pos)
    torch.testing.assert_close(got_w.float(), want_w.float(), atol=TOL[dtype], rtol=TOL[dtype])


def test_paged_kernel_raises_instead_of_falling_back(cuda):
    k, v, table, g = _pools(cuda, torch.float32, d=24)
    q = torch.randn((3, 1, 4, 24), generator=g).to(cuda)
    pos = torch.zeros((3,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_window_attention(q, k[0], v[0], table, pos)


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
    tol = TOL[dtype] * max(1.0, want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=TOL[dtype])
    eye = torch.eye(256, dtype=dtype, device=cuda)
    assert torch.equal(ti4.int4_matmul(eye, packed, scale, 64), w.dequant().to(cuda))
    with pytest.raises(ValueError, match="int4 kernel takes"):
        ti4.int4_matmul(x[:, :128], packed[:32, :100].contiguous(), scale[:2, :100].contiguous(), 64)


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
