"""KV handoff and the fleet prefix tier in the PyTorch port (both engines'
``submit(handoff=True)``, ``take_handoffs``, ``snapshot_active(
include_kv=True)``, the inject branch of ``restore`` and the prefix tier's
surface) against the JAX package's engines, on the CPU, with the JAX
package's weights (``weights.params_from_jax``), at two sizes: a 2-layer
GQA model and the 1-layer one of ``tests/test_torch_fleet.py``.

* Handoff entries equal the JAX engines' field for field; payloads agree
  as ``tests/test_torch_paged_admission.py`` holds pools (float32 within
  1e-5; bf16 within one bf16 step; quantized values within one level,
  scales within 1e-5 relative), and dense and paged payloads of one
  prompt are the same bytes.
* An inject continues every stream (greedy and sampled) bit for bit as
  the port's own unsplit run does, and as the JAX engine's; the injected
  rows or blocks hold the payload's bytes.  Quantized payloads inject into
  a pool of their own format; the others, and payloads of another model,
  re-prefill and count ``tpu_disagg_fallback_total{reason="incompatible"}``;
  a full pool parks the entry and counts ``no_capacity``.  A failed write
  refunds its blocks.  Speculation re-prefills the draft; LoRA carries
  the adapter.
* Port replicas behind the reference's ``DisaggRouter`` (its channel clean
  or corrupting every payload) and behind either package's
  ``FleetPrefixTier`` serve every stream
  as one port engine does; the tier's pulled prefix injects and the next
  admission hits, the engines' hooks firing with the reference's
  arguments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import fleet as tfleet
from k8s_dra_driver_torch.models import fleet_prefix as tfp
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models import serve as ts
from k8s_dra_driver_torch.models.weights import bank_from_jax, params_from_jax
from k8s_dra_driver_torch.utils import journal as tj
from k8s_dra_driver_torch.utils import metrics as tm
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import fleet as jfleet
from k8s_dra_driver_tpu.models import fleet_prefix as jfp
from k8s_dra_driver_tpu.models import lora as jl
from k8s_dra_driver_tpu.models import paged as jp
from k8s_dra_driver_tpu.models import serve as js
from k8s_dra_driver_tpu.models.disagg import DisaggRouter
from k8s_dra_driver_tpu.models.workload import SimClock
from k8s_dra_driver_tpu.utils import journal as jj
from k8s_dra_driver_tpu.utils.faults import FaultInjector

CONFIGS = {
    "gqa": (jb.ModelConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
                           d_ff=128, max_seq=64, rope=True, dtype=jnp.float32),
            dict(dense=dict(n_slots=3, prompt_bucket=32),
                 paged=dict(n_slots=3, n_blocks=40, block_size=8, prompt_bucket=32))),
    "fleet": (jb.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
                             max_seq=64),
              dict(dense=dict(n_slots=3, prompt_bucket=16),
                   paged=dict(n_slots=3, n_blocks=33, block_size=4, prompt_bucket=16))),
}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_STEP = 2 ** -7 + 2 ** -16
KINDS = ("dense", "paged")
COMBOS = [(a, b) for a in KINDS for b in KINDS]
COMBO_IDS = [f"{a}_to_{b}" for a, b in COMBOS]
JLORA = jl.LoraConfig(rank=4, alpha=8.0)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module, restored afterwards: the
    suite's other workers keep their cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _fresh_registry():
    tm.REGISTRY.reset()
    tj.JOURNAL.clear()
    yield


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (jcfg, _) in CONFIGS.items():
        jparams = jb.init_params(jax.random.PRNGKey(0), jcfg)
        out[name] = (jcfg, tb.ModelConfig.from_reference(jcfg), jparams,
                     params_from_jax(jparams, device="cpu"))
    return out


def _engine(models, cfg, kind, pkg="port", dtype="f32", **kw):
    jcfg, tcfg, jparams, tparams = models[cfg]
    kw = dict(CONFIGS[cfg][1][kind], **kw)
    if pkg == "jax":
        kw["cache_dtype"] = DTYPES[dtype][0]
        if kind == "dense":
            return js.ServeEngine(params=jparams, cfg=jcfg, **kw)
        return jp.PagedServeEngine(params=jparams, cfg=jcfg, attn_impl="xla", **kw)
    kw["cache_dtype"] = DTYPES[dtype][1]
    if kind == "dense":
        return ts.ServeEngine(params=tparams, cfg=tcfg, device="cpu", **kw)
    return tp.PagedServeEngine(params=tparams, cfg=tcfg, device="cpu", **kw)


def _traffic(cfg, n=3, seed=8, sampled=True):
    """``n`` requests of 8-20 prompt tokens (one exactly a block of 8) and
    6-8 new tokens, the second sampled at 0.8 with a seed.  Seed 8: the
    1-layer model computes in bf16 (its config's default dtype), and at
    seed 7 its first request's first token is a one-step bf16 tie (39 and
    36 at 1.671875 and 1.6640625) that each package rounds its own way."""
    vocab = CONFIGS[cfg][0].vocab_size
    bucket = CONFIGS[cfg][1]["dense"]["prompt_bucket"]
    r = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        plen = 8 if i == 0 else int(r.randint(5, min(20, bucket - 2)))
        req = dict(prompt=r.randint(0, vocab, size=plen).tolist(),
                   max_tokens=int(r.randint(6, 9)), seed=100 + i)
        if sampled and i == 1:
            req["temperature"] = 0.8
        reqs.append(req)
    return reqs


def _hand_off(eng, reqs) -> list:
    for r in reqs:
        eng.submit(handoff=True, **r)
    eng.run_until_drained()  # a chunked admission hands off when it activates
    assert eng.completions() == []
    return eng.take_handoffs()


def _wire(entries) -> list:
    """Each entry's payload through the port's own frame and back."""
    out = []
    for e in entries:
        rid, kv = ts.KVSlice.from_wire(e["kv"].to_wire(e["request_id"]))
        assert rid == e["request_id"]
        out.append(dict(e, kv=kv))
    return out


def _streams(comps) -> dict:
    return {c.request_id: (c.generated, c.status) for c in comps}


def _drain(eng) -> dict:
    eng.run_until_drained()
    return _streams(eng.completions())


def _fallbacks() -> dict:
    got = tm.parse_prom_text(tm.REGISTRY.render()).get("tpu_disagg_fallback_total", {})
    return {dict(key)["reason"]: int(n) for key, n in got.items()}


def _as_f32(a, label: str) -> np.ndarray:
    """A float payload's values in float32 (the port's bf16 words widened)."""
    a = np.asarray(a)
    if label == "bfloat16" and a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _levels(a, label: str) -> np.ndarray:
    """A quantized payload's integer levels (int4 nibbles unpacked)."""
    a = np.asarray(a)
    if label == "int4":
        return np.concatenate([(a & 0xF).astype(np.int16) - 8, (a >> 4).astype(np.int16) - 8],
                              axis=-1)
    return a.astype(np.int16)


def _assert_payload_close(got, want, bf16_compute=False):
    """The port's payload against the reference's: the same geometry; the
    values as the pool tests hold pools.  A model that computes in bf16
    (``bf16_compute``, the 1-layer config) rounds its activations in both
    packages, each its own way, before the K/V projections: its values are
    held within two bf16 steps of the layer's largest magnitude (seen: 1.23
    steps)."""
    for name in ("valid_len", "n_layers", "kv_heads", "head_dim", "dtype", "block_size"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.nbytes == want.nbytes
    for name in ("k", "v"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape, name
        if got.block_size > 0:
            assert np.abs(_levels(a, got.dtype) - _levels(b, got.dtype)).max() <= 1, name
            np.testing.assert_allclose(getattr(got, f"{name}_scale"),
                                       getattr(want, f"{name}_scale"), rtol=1e-5, atol=0)
            continue
        a, b = _as_f32(a, got.dtype), _as_f32(b, got.dtype)
        if bf16_compute:
            for layer in range(got.n_layers):
                assert (np.abs(a[layer] - b[layer]).max()
                        <= 2 * BF16_STEP * np.abs(b[layer]).max()), (name, layer)
            continue
        if got.dtype == "float32":
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
            continue
        diff = np.abs(a - b)
        assert not (diff[0] > BF16_STEP * np.abs(b[0]) + 2 ** -16).any(), name
        for layer in range(1, got.n_layers):
            assert diff[layer].max() <= BF16_STEP * np.abs(b[layer]).max(), (name, layer)


def _same_bytes(a, b) -> bool:
    return all(np.ascontiguousarray(getattr(a, n)).tobytes()
               == np.ascontiguousarray(getattr(b, n)).tobytes()
               for n in ("k", "v", "k_scale", "v_scale") if getattr(a, n) is not None)


def _assert_injected(eng, entries):
    """Each restored slot's rows or blocks hold its payload's bytes."""
    by_id = {e["request_id"]: e["kv"] for e in entries}
    seen = 0
    for slot, st in enumerate(eng._slots):
        if st is not None and st.request_id in by_id:
            kv = by_id[st.request_id]
            assert _same_bytes(eng._capture_kv(slot, kv.valid_len), kv), st.request_id
            seen += 1
    assert seen


# -- the entries -----------------------------------------------------------------------

ENTRY_CASES = [(cfg, kind, dt, None) for cfg in CONFIGS for kind in KINDS for dt in DTYPES] + [
    ("gqa", "paged", "f32", q) for q in ("int8", "int4")]


@pytest.mark.parametrize("cfg,kind,dtype,kv_dtype", ENTRY_CASES,
                         ids=[f"{c}-{k}-{q or d}" for c, k, d, q in ENTRY_CASES])
def test_handoff_entries_equal_the_jax_engines(models, cfg, kind, dtype, kv_dtype):
    """The same requests handed off by a JAX engine and a port engine: the
    same entries (request, tokens, sampler state, adapter, priority), the
    same payload geometry and values within the pools' tolerance, every
    slot and block back, one counted host sync a capture, and the same
    ``request.handoff`` journal records."""
    reqs = _traffic(cfg)
    jj.JOURNAL.clear()
    kw = {} if kv_dtype is None else dict(kv_dtype=kv_dtype)
    entries, syncs, records = {}, {}, {}
    for pkg, journal in (("jax", jj.JOURNAL), ("port", tj.JOURNAL)):
        eng = _engine(models, cfg, kind, pkg, dtype, **kw)
        entries[pkg] = _hand_off(eng, reqs)
        syncs[pkg] = eng.host_syncs
        assert eng.free_slots() == eng.n_slots
        if kind == "paged":
            assert eng.free_blocks == eng.n_blocks - 1
        records[pkg] = [(e["correlation"], e["attrs"]["slot"], e["attrs"]["kv_bytes"])
                        for e in journal.tail(component="serve")
                        if e["event"] == "request.handoff"]
    assert syncs["port"] == syncs["jax"] == len(reqs)
    assert records["port"] == records["jax"] and len(records["port"]) == len(reqs)
    for te, je in zip(entries["port"], entries["jax"], strict=True):
        assert set(te) == set(je)
        assert {k: v for k, v in te.items() if k not in ("kv", "trace")} == {
            k: v for k, v in je.items() if k not in ("kv", "trace")}
        assert te["kv"].valid_len == len(te["tokens"]) - 1
        _assert_payload_close(te["kv"], je["kv"],
                              bf16_compute=CONFIGS[cfg][0].dtype == jnp.bfloat16)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_payload_bytes_equal_across_engine_kinds(models, cfg):
    """A prompt's payload is the same bytes from the dense engine and the
    paged one (the paged prefill is the dense one, scattered)."""
    reqs = _traffic(cfg, sampled=False)
    dense, paged = (_hand_off(_engine(models, cfg, kind), reqs) for kind in KINDS)
    for a, b in zip(dense, paged, strict=True):
        assert _same_bytes(a["kv"], b["kv"]) and a["kv"].checksum() == b["kv"].checksum()


# -- inject ----------------------------------------------------------------------------

@pytest.mark.parametrize("pre,dec", COMBOS, ids=COMBO_IDS)
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_inject_continues_every_stream(models, cfg, pre, dec):
    """Handed off over the port's wire frame and injected, every stream
    (greedy and sampled) is the port's own unsplit run bit for bit, and
    the JAX engine's; nothing falls back."""
    reqs = _traffic(cfg)
    want = _streams(_engine(models, cfg, dec).pump(reqs))
    assert _streams(_engine(models, cfg, dec, "jax").pump(reqs)) == want
    entries = _wire(_hand_off(_engine(models, cfg, pre), reqs))
    eng = _engine(models, cfg, dec)
    assert eng.restore({"next_id": len(reqs), "requests": entries}) == list(range(len(reqs)))
    _assert_injected(eng, entries)
    assert _drain(eng) == want
    assert _fallbacks() == {}
    if dec == "paged":
        assert eng.free_blocks == eng.n_blocks - 1
        injects = [e for e in tj.JOURNAL.tail(component="serve") if e["event"] == "request.restore"]
        assert [e["attrs"].get("kv_inject") for e in injects] == [True] * len(reqs)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_quantized_payloads_inject_into_a_matching_pool(models, kv_dtype):
    """A quantized pool's payload (raw levels over the padded blocks and
    their scales) lands byte for byte in a pool of its format, and the
    streams are the unsplit run's, and the JAX engine's."""
    reqs = _traffic("gqa")
    want = _streams(_engine(models, "gqa", "paged", kv_dtype=kv_dtype).pump(reqs))
    assert _streams(_engine(models, "gqa", "paged", "jax", kv_dtype=kv_dtype).pump(reqs)) == want
    entries = _wire(_hand_off(_engine(models, "gqa", "paged", kv_dtype=kv_dtype), reqs))
    for e in entries:
        kv = e["kv"]
        nb = -(-kv.valid_len // 8)
        last = 8 if kv_dtype == "int4" else 16
        assert kv.quantized and kv.dtype == kv_dtype and kv.block_size == 8
        assert kv.k.shape == (2, nb * 8, 2, last) and kv.k_scale.shape == (2, nb, 2)
    eng = _engine(models, "gqa", "paged", kv_dtype=kv_dtype)
    eng.restore({"next_id": len(reqs), "requests": entries})
    _assert_injected(eng, entries)
    assert _drain(eng) == want and _fallbacks() == {}


def _incompatible(models, case):
    """(prefill engine, decode engine) of each mismatch."""
    pairs = {
        "bf16 into a float32 dense cache": (("gqa", "paged", "bf16", {}),
                                            ("gqa", "dense", "f32", {})),
        "bf16 into a float32 pool": (("gqa", "dense", "bf16", {}), ("gqa", "paged", "f32", {})),
        "int8 into a float pool": (("gqa", "paged", "f32", dict(kv_dtype="int8")),
                                   ("gqa", "paged", "f32", {})),
        "int8 into a dense cache": (("gqa", "paged", "f32", dict(kv_dtype="int8")),
                                    ("gqa", "dense", "f32", {})),
        "int8 into an int4 pool": (("gqa", "paged", "f32", dict(kv_dtype="int8")),
                                   ("gqa", "paged", "f32", dict(kv_dtype="int4"))),
        "float32 into an int8 pool": (("gqa", "paged", "f32", {}),
                                      ("gqa", "paged", "f32", dict(kv_dtype="int8"))),
        "int8 at block 8 into block 4": (("gqa", "paged", "f32", dict(kv_dtype="int8")),
                                         ("gqa", "paged", "f32",
                                          dict(kv_dtype="int8", block_size=4, n_blocks=80))),
        "another model's payload": (("fleet", "paged", "f32", {}), ("gqa", "paged", "f32", {})),
    }
    (c1, k1, d1, kw1), (c2, k2, d2, kw2) = pairs[case]
    return (lambda: _engine(models, c1, k1, "port", d1, **kw1),
            lambda: _engine(models, c2, k2, "port", d2, **kw2), c1)


INCOMPATIBLE = ["bf16 into a float32 dense cache", "bf16 into a float32 pool",
                "int8 into a float pool", "int8 into a dense cache", "int8 into an int4 pool",
                "float32 into an int8 pool", "int8 at block 8 into block 4",
                "another model's payload"]


@pytest.mark.parametrize("case", INCOMPATIBLE)
def test_an_incompatible_payload_re_prefills(models, case):
    """A payload the decode engine cannot hold byte for byte re-prefills:
    the streams are those of the same entries restored without payloads,
    and each counts ``incompatible``."""
    make_pre, make_dec, cfg = _incompatible(models, case)
    entries = _wire(_hand_off(make_pre(), _traffic(cfg, sampled=False)))
    twin = make_dec()
    twin.restore({"next_id": 3, "requests": [dict(e, kv=None) for e in entries]})
    want = _drain(twin)
    assert _fallbacks() == {}
    eng = make_dec()
    eng.restore({"next_id": 3, "requests": entries})
    assert _fallbacks() == {"incompatible": len(entries)}
    assert _drain(eng) == want


def test_a_full_pool_parks_the_entry(models):
    """No slot and blocks for an injection now: the entry parks without its
    payload (``no_capacity``), re-admits by re-prefill when a retirement
    frees blocks, and its stream is the unsplit run's."""
    reqs = _traffic("gqa", sampled=False)[:2]
    want = _streams(_engine(models, "gqa", "paged").pump(reqs))
    entries = _wire(_hand_off(_engine(models, "gqa", "paged"), reqs))
    eng = _engine(models, "gqa", "paged", n_blocks=5)  # 4 usable blocks
    eng.submit(list(range(1, 26)), max_tokens=4)  # all 4 for its whole stream
    assert eng.restore({"next_id": 2, "requests": entries[1:]}, merge=True) == [1]
    assert _fallbacks() == {"no_capacity": 1} and len(eng._preempted) == 1
    got = _drain(eng)
    assert got[1] == want[1] and got[0][1] == "ok"
    assert eng.free_blocks == 4


def test_a_failed_inject_refunds_its_blocks(models, monkeypatch):
    """A write that raises mid-inject (restore or the prefix tier's)
    refunds the blocks it took and leaves no slot or store entry."""
    entries = _wire(_hand_off(_engine(models, "gqa", "paged"), _traffic("gqa")))
    owner = _engine(models, "gqa", "paged", prefix_cache_blocks=8)
    prompt = list(range(1, 30))
    owner.pump([dict(prompt=prompt, max_tokens=2)])
    pulled = owner.export_prefix_kv(prompt)
    assert pulled is not None and pulled.valid_len == 24

    def boom(self, ids, stripes):
        raise RuntimeError("boom")

    monkeypatch.setattr(tp.PagedServeEngine, "_write_stripes", boom)
    eng = _engine(models, "gqa", "paged", prefix_cache_blocks=8)
    with pytest.raises(RuntimeError, match="boom"):
        eng.restore({"next_id": 3, "requests": entries})
    with pytest.raises(RuntimeError, match="boom"):
        eng.inject_prefix_kv(prompt, pulled)
    assert eng.free_blocks == eng.n_blocks - 1 and eng.free_slots() == eng.n_slots
    assert not eng._table_np.any() and not eng._prefix_store and not eng._alloc._refs


@pytest.mark.parametrize("kind", KINDS)
def test_speculation_re_prefills_the_draft(models, kind):
    """A speculating decode engine injects the target's payload and
    re-prefills the draft's rows (the draft cache never travels): its draft
    cache equals a re-prefilled twin's, and the streams the unsplit
    speculative run's."""
    reqs = _traffic("gqa", sampled=False)
    want = _streams(_engine(models, "gqa", kind, spec_gamma=2).pump(reqs))
    entries = _wire(_hand_off(_engine(models, "gqa", kind), reqs))
    eng, twin = (_engine(models, "gqa", kind, spec_gamma=2) for _ in range(2))
    eng.restore({"next_id": 3, "requests": entries})
    twin.restore({"next_id": 3, "requests": [dict(e, kv=None) for e in entries]})
    assert all(torch.equal(a, b) for a, b in zip(eng._d_cache, twin._d_cache))
    assert _drain(eng) == want == _drain(twin)
    assert eng.spec_drafted > 0


def _numpy_adapter(seed: int) -> dict:
    r = np.random.RandomState(seed)
    dims = jb.block_matrix_shapes(CONFIGS["gqa"][0])
    return {"blocks": [
        {name: {"a": (r.standard_normal((dims[name][0], JLORA.rank)) / JLORA.rank
                      ).astype(np.float32),
                "b": (0.3 * r.standard_normal((JLORA.rank, dims[name][1]))).astype(np.float32)}
         for name in JLORA.targets}
        for _ in range(CONFIGS["gqa"][0].n_layers)
    ]}


@pytest.mark.parametrize("kind", KINDS)
def test_lora_carries_the_adapter(models, kind):
    """The entry carries each request's adapter and the decode engine
    serves it from its own bank: the streams are the unsplit banked run's,
    and an adapted one leaves the base's."""
    jbank = jl.stack_adapters(CONFIGS["gqa"][0], JLORA,
                              [jax.tree.map(jnp.asarray, _numpy_adapter(s)) for s in (1, 2)])
    bank = bank_from_jax(jbank, device="cpu")
    reqs = [dict(r, adapter=i) for i, r in enumerate(_traffic("gqa", sampled=False))]
    want = _streams(_engine(models, "gqa", kind, adapter_bank=bank).pump(reqs))
    entries = _wire(_hand_off(_engine(models, "gqa", kind, adapter_bank=bank), reqs))
    assert [e["adapter"] for e in entries] == [0, 1, 2]
    eng = _engine(models, "gqa", kind, adapter_bank=bank)
    eng.restore({"next_id": 3, "requests": entries})
    assert [st.adapter for st in eng._slots if st is not None] == [0, 1, 2]
    assert _drain(eng) == want
    base = _streams(_engine(models, "gqa", kind).pump(
        [{k: v for k, v in r.items() if k != "adapter"} for r in reqs]))
    assert base[0] == want[0] and (base[1] != want[1] or base[2] != want[2])


@pytest.mark.parametrize("src,dst", COMBOS, ids=COMBO_IDS)
def test_a_snapshot_with_payloads_restores_by_inject(models, src, dst):
    """``snapshot_active(include_kv=True)`` mid-stream carries each
    resident's rows; a fresh engine of either kind injects them and every
    stream continues as the uninterrupted run's."""
    reqs = _traffic("gqa")
    want = _streams(_engine(models, "gqa", src).pump(reqs))
    eng = _engine(models, "gqa", src)
    for r in reqs:
        eng.submit(**r)
    eng.step()
    eng.step()
    snap = eng.snapshot_active(include_kv=True)
    done = _streams(eng.completions())
    assert all(e["kv"].valid_len == len(e["tokens"]) - 1 for e in snap["requests"])
    eng.release_active()
    other = _engine(models, "gqa", dst)
    other.restore({**snap, "requests": _wire(snap["requests"])})
    _assert_injected(other, snap["requests"])
    assert {**done, **_drain(other)} == want
    assert _fallbacks() == {}


# -- the reference's disaggregated router -------------------------------------------------

ROUTER_REQS = [
    {"prompt": [7, 8, 9], "max_tokens": 6, "seed": 5},
    {"prompt": [3, 4], "max_tokens": 6, "temperature": 0.7, "seed": 9},
    {"prompt": [11, 12, 13, 14], "max_tokens": 6, "seed": 21},
    {"prompt": [1, 2], "max_tokens": 6, "seed": 33},
    {"prompt": [21, 22, 23], "max_tokens": 6, "seed": 44},
]


def _by_prompt(comps) -> dict:
    return {tuple(c.tokens[: len(c.tokens) - len(c.generated)]): (tuple(c.generated), c.status)
            for c in comps}


@pytest.mark.parametrize("channel", ["clean", "corrupting"])
@pytest.mark.parametrize("pre,dec", COMBOS, ids=COMBO_IDS)
def test_torch_replicas_behind_the_disagg_router(models, pre, dec, channel):
    """A port prefill replica and a port decode replica behind the
    reference's ``DisaggRouter`` serve every stream as one port engine
    does, one completion each; a channel corrupting every payload makes
    every handoff fall back to a re-prefill, with the same streams; paged
    pools end where they started."""
    want = _by_prompt(_engine(models, "fleet", dec).pump([dict(r) for r in ROUTER_REQS]))
    p, d = _engine(models, "fleet", pre), _engine(models, "fleet", dec)
    inj = FaultInjector.from_env("handoff_corrupt=1.0,seed=5") if channel != "clean" else None
    router = DisaggRouter(prefill=[p], decode=[d], fault_injector=inj)
    done = router.pump([dict(r) for r in ROUTER_REQS])
    assert len(done) == len(ROUTER_REQS) and _by_prompt(done) == want
    n = len(ROUTER_REQS)
    assert router.handoffs == n
    assert router.channel.counts == {"ok" if channel == "clean" else "corrupt": n}
    assert router.fallbacks == (0 if channel == "clean" else n)
    for eng in (p, d):
        if isinstance(eng, tp.PagedServeEngine):
            assert eng.free_blocks == eng.n_blocks - 1


# -- the fleet prefix tier ---------------------------------------------------------------

def _tier_run(engines: dict, warm: list, pulled: list, tier_pkg: str = "reference"):
    """The tier of ``tier_pkg`` ("reference" or "port") over ``engines``
    {"A", "B"} behind that package's ``FleetRouter``: A serves ``warm`` then ``pulled`` (its store keeps the
    last and evicts the first), A's slots fill, and the router sends
    ``pulled`` to B, which pulls the prefix from A through the tier's wire
    round trip.  Returns (B's completion, tier, every hook call, A's cold
    completion)."""
    fleet, fp = (jfleet, jfp) if tier_pkg == "reference" else (tfleet, tfp)
    clock = SimClock()
    router = fleet.FleetRouter(list(engines.items()), clock=clock)
    tier = fp.FleetPrefixTier(fp.FleetPrefixIndex(clock=clock), clock=clock)
    router.attach_prefix_tier(tier)
    calls = []
    for name, eng in engines.items():
        for hook in ("on_prefix_store", "on_prefix_evict"):
            inner = getattr(eng, hook)
            setattr(eng, hook, lambda *a, _i=inner, _n=name, _h=hook: (
                calls.append((_n, _h, a)), _i(*a)))
    a, b = engines["A"], engines["B"]
    (cold,) = a.pump([dict(prompt=warm, max_tokens=6, seed=3)])
    (cold,) = a.pump([dict(prompt=pulled, max_tokens=6, seed=3)])
    for i in range(a.n_slots):
        a.submit([40 + i, 41 + i, 42 + i], max_tokens=4, seed=3)
    router.submit(pulled, 6, seed=3)
    mine = []
    for _ in range(200):
        for eng in (a, b):
            eng.step()
            mine += [c for c in eng.completions() if c.tokens[: len(pulled)] == pulled]
        if all(e.free_slots() == e.n_slots for e in (a, b)):
            break
    return mine, tier, calls, cold


# the reference's tier keeps the ids "dense" and "paged" it had before the port's tier came
TIER_CASES = [(k, t) for t in ("reference", "port") for k in KINDS]


@pytest.mark.parametrize("kind,tier_pkg", TIER_CASES,
                         ids=[k if t == "reference" else f"{k}-port_tier" for k, t in TIER_CASES])
def test_torch_replicas_behind_the_fleet_prefix_tier(models, kind, tier_pkg):
    """Two port replicas behind the ``FleetPrefixTier`` and ``FleetRouter``
    of ``tier_pkg`` (the JAX engines behind the reference's): the hooks
    publish and withdraw (their calls, replica by replica, the JAX
    engines' in the same run), B pulls the prefix A holds, it injects, B's
    admission hits it, and the stream is A's cold one."""
    kw = dict(prefix_cache_blocks=3) if kind == "paged" else dict(prefix_bucket=8,
                                                                  prefix_cache_entries=1)
    warm, pulled = list(range(1, 15)), list(range(20, 34))
    runs = {}
    for pkg in ("jax", "port"):
        engines = {n: _engine(models, "fleet", kind, pkg, **kw) for n in ("A", "B")}
        runs[pkg] = (*_tier_run(engines, warm, pulled, tier_pkg if pkg == "port" else "reference"),
                     engines["B"])
    (mine, tier, calls, cold, b), (_, jtier, jcalls, _, _) = runs["port"], runs["jax"]
    assert calls == jcalls
    assert {h for _, h, _ in calls} == {"on_prefix_store", "on_prefix_evict"}
    assert [c.generated for c in mine] == [cold.generated]
    assert tier.counts == jtier.counts and tier.counts["remote"] == 1
    depth = 12 if kind == "paged" else 8
    assert b.local_prefix_depth(pulled) == depth
    assert b.prefix_hits == (3 if kind == "paged" else 1)
    assert tier.index.ledger().blocks == jtier.index.ledger().blocks


@pytest.mark.parametrize("kind", KINDS)
def test_prefix_export_and_inject_round_trip(models, kind):
    """``export_prefix_kv`` of one port engine, through the wire into
    another's ``inject_prefix_kv``: the tokens installed, the next admission
    a hit whose stream is the cold one; the payload the JAX engine's within
    1e-5, and it injects into the JAX engine as well (from the reference's
    own decode of the port's frame)."""
    kw = dict(prefix_cache_blocks=8) if kind == "paged" else dict(prefix_bucket=16,
                                                                  prefix_cache_entries=4)
    prompt = list(range(1, 21))
    owner, peer = (_engine(models, "gqa", kind, **kw) for _ in range(2))
    jowner, jpeer = (_engine(models, "gqa", kind, "jax", **kw) for _ in range(2))
    (cold,) = owner.pump([dict(prompt=prompt, max_tokens=6, seed=3)])
    jowner.pump([dict(prompt=prompt, max_tokens=6, seed=3)])
    kv = owner.export_prefix_kv(prompt)
    _assert_payload_close(kv, jowner.export_prefix_kv(prompt))
    frame = kv.to_wire(3)
    assert peer.inject_prefix_kv(prompt, ts.KVSlice.from_wire(frame)[1]) == 16
    assert peer.inject_prefix_kv(prompt, kv) == 0  # already stored
    assert jpeer.inject_prefix_kv(prompt, js.KVSlice.from_wire(frame)[1]) == 16
    (hot,) = peer.pump([dict(prompt=prompt, max_tokens=6, seed=3)])
    assert hot.generated == cold.generated and peer.prefix_hits == (2 if kind == "paged" else 1)
