"""Speculative serving in the PyTorch port's engines (``serve.ServeEngine``
and ``paged.PagedServeEngine`` with ``spec_gamma > 0``) against the JAX
package's engines on the CPU, with the same weights
(``weights.params_from_jax``), drafts and seeded traffic.

Tolerances (those of tests/test_torch_paged_serve.py, which explains
them): greedy token streams, completion statuses, host syncs (one a
round), stalls, preemptions, prefix hits and misses identical; a float32
cache or pool within atol = rtol = 1e-5 (pools from block 1 on: block 0 is
the null block, the sink of a verify window past a slot's owned blocks).
Streams are also held against the port's plain engines: speculation
changes when tokens commit, never which."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import decode as td
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models import quant as tq
from k8s_dra_driver_torch.models import serve as ts
from k8s_dra_driver_torch.models.weights import params_from_jax
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import paged as jp
from k8s_dra_driver_tpu.models import quant as jq
from k8s_dra_driver_tpu.models import serve as js

JCFG = jb.ModelConfig(
    vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
    d_ff=128, max_seq=64, rope=True, dtype=jnp.float32,
)
TCFG = tb.ModelConfig.from_reference(JCFG)
# Learned position embeddings: a verify window past ``max_seq`` reads the
# table's last row, as the reference's gather clamps.
JCFG_ABS = jb.ModelConfig(**{**JCFG.__dict__, "rope": False})
TCFG_ABS = tb.ModelConfig.from_reference(JCFG_ABS)
ENGINES = {
    "dense": dict(n_slots=3, prompt_bucket=24),
    "paged": dict(n_slots=3, block_size=8, prompt_bucket=32),
}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module, restored afterwards: the
    suite's other workers keep their cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def weights():
    params = jb.init_params(jax.random.PRNGKey(0), JCFG)
    return params, params_from_jax(params, device="cpu")


def _draft(weights, name):
    """``(JAX draft, port draft)``: None is each engine's int8 self-draft."""
    jparams, tparams = weights
    if name == "int8":
        return None, None
    if name == "self":
        return jparams, tparams
    if name == "shallow":
        return (dict(jparams, blocks=jparams["blocks"][:1]),
                dict(tparams, blocks=tparams["blocks"][:1]))
    j4 = jq.quantize_blocks(jparams, bits=4, kernel=False)
    return j4, params_from_jax(j4, device="cpu")


def _pair(weights, kind, draft="int8", cfgs=(JCFG, TCFG), **kw):
    """A JAX engine and a port engine of ``kind`` with the same settings."""
    jparams, tparams = weights
    jcfg, tcfg = cfgs
    jdraft, tdraft = _draft(weights, draft) if kw.get("spec_gamma") else (None, None)
    kw = dict(ENGINES[kind], **kw)
    if kind == "dense":
        je = js.ServeEngine(params=jparams, cfg=jcfg, draft_params=jdraft, **kw)
        te = ts.ServeEngine(params=tparams, cfg=tcfg, draft_params=tdraft, device="cpu", **kw)
    else:
        jkw = dict(attn_impl="xla", **kw)
        if jkw.pop("kernel", False):
            jkw.update(attn_impl="kernel", interpret=True)
        kw.pop("kernel", None)
        je = jp.PagedServeEngine(params=jparams, cfg=jcfg, draft_params=jdraft, **jkw)
        te = tp.PagedServeEngine(params=tparams, cfg=tcfg, draft_params=tdraft, device="cpu",
                                 **kw)
    return je, te


def _plain(weights, kind, **kw):
    """The port's engine of ``kind`` without speculation."""
    _, tparams = weights
    kw = dict(ENGINES[kind], **kw)
    if kind == "dense":
        return ts.ServeEngine(params=tparams, cfg=TCFG, device="cpu", **kw)
    return tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu", **kw)


def _streams(comps):
    return {c.request_id: (c.generated, c.status) for c in comps}


def _counters(eng):
    out = dict(host_syncs=eng.host_syncs, free=eng.free_slots())
    if hasattr(eng, "stalled_steps"):
        out.update(stalls=eng.stalled_steps, preempted=eng.preempted_count,
                   hits=eng.prefix_hits, misses=eng.prefix_misses, blocks=eng.free_blocks)
    return out


def _assert_caches_close(te, je, kind):
    start = 1 if kind == "paged" else 0
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(te._cache, name).numpy()[:, start:],
                                   np.asarray(getattr(je._cache, name))[:, start:],
                                   atol=1e-5, rtol=1e-5)


def _traffic(n=7, seed=3, budget=(4, 20), plen=(3, 20)):
    r = np.random.RandomState(seed)
    return [(r.randint(0, 128, size=r.randint(*plen)).tolist(), int(r.randint(*budget)))
            for _ in range(n)]


def _guard_programs(monkeypatch):
    """Make every tensor-to-host read raise inside the programs the card
    captures as graphs (the spec rounds and the draft prefill)."""

    def refuse(*_a, **_k):
        raise AssertionError("host read inside a program")

    def guard(mod, name):
        fn = getattr(mod, name)

        def guarded(*a, **k):
            with monkeypatch.context() as m:
                for attr in ("item", "tolist", "__bool__", "cpu", "numpy"):
                    m.setattr(torch.Tensor, attr, refuse)
                return fn(*a, **k)
        monkeypatch.setattr(mod, name, guarded)

    guard(ts, "_spec_round")
    guard(ts, "_prefill_draft_row")
    guard(tp, "_paged_spec_round")


def _rounds(eng):
    """Step until idle; returns the steps taken."""
    n = 0
    while eng.free_slots() < eng.n_slots or getattr(eng, "_preempted", ()):
        eng.step()
        n += 1
        assert n < 500
    return n


# -- both engines -----------------------------------------------------------------

@pytest.mark.parametrize("gamma,draft", [(1, "int8"), (3, "int8"), (2, "shallow")])
@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_streams_and_host_syncs_identical_to_jax(weights, monkeypatch, kind, gamma, draft):
    """Seven requests over three slots, joining as slots free: the JAX
    engine's streams, host syncs and cache bytes, and the plain engine's
    streams."""
    reqs = _traffic()
    je, te = _pair(weights, kind, draft, spec_gamma=gamma, sync_interval=3)
    want = _streams(je.pump(reqs))
    _guard_programs(monkeypatch)
    got = _streams(te.pump(reqs))
    assert got == want and len(got) == 7
    assert _counters(te) == _counters(je)
    _assert_caches_close(te, je, kind)
    assert got == _streams(_plain(weights, kind).pump(reqs))
    assert te._d_cache.k.shape[0] == (1 if draft == "shallow" else 2)
    assert 0 < te.spec_accepted <= te.spec_drafted


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_full_acceptance_round_count(weights, kind):
    """The target as its own draft accepts everything: one token at
    admission, then ``gamma + 1`` a round (the paged engine at block 4,
    so a round's window crosses blocks), and every block comes back."""
    gamma, steps = 3, 20
    extra = dict(block_size=4, n_blocks=20) if kind == "paged" else {}
    prompt = _traffic(1, seed=5)[0][0]
    je, te = _pair(weights, kind, "self", spec_gamma=gamma, **extra)
    counts = []
    for eng in (je, te):
        free = getattr(eng, "free_blocks", None)
        eng.submit(prompt, steps)
        counts.append((_rounds(eng), eng.host_syncs, eng.completions()[0].generated))
        assert getattr(eng, "free_blocks", None) == free
    assert counts[0] == counts[1]
    assert counts[1][0] == counts[1][1] == -(-(steps - 1) // (gamma + 1))
    assert te.spec_accepted == te.spec_drafted == gamma * counts[1][0]
    plain = _plain(weights, kind, **extra)
    plain.submit(prompt, steps)
    plain.run_until_drained()
    assert counts[1][2] == plain.completions()[0].generated


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_eos_clips_mid_round(weights, kind):
    """An eos inside a round's accepted tokens ends the stream there, as
    the plain engine's does."""
    prompt = _traffic(1, seed=5)[0][0]
    plain = _plain(weights, kind)
    plain.submit(prompt, 14)
    plain.run_until_drained()
    stream = plain.completions()[0].generated
    # the first token that appears first inside a round (full acceptance:
    # one token at admission, then four a round)
    eos = next(t for i, t in enumerate(stream) if stream.index(t) == i and (i + 1) % 4 > 1)
    want = stream[: stream.index(eos) + 1]
    outs = []
    for eng in _pair(weights, kind, "self", spec_gamma=3, eos_id=eos):
        eng.submit(prompt, 14)
        rounds = _rounds(eng)
        outs.append((eng.completions()[0].generated, rounds))
    assert outs[0] == outs[1] and outs[1][0] == want and len(want) < len(stream)


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_slack_bound_is_exact(weights, kind):
    """``prompt + max_tokens + gamma - 1 == max_seq`` admits and runs to
    its budget (the deepest verify write is the cache's last position);
    one token more is refused, as is a temperature."""
    gamma, plen = 4, 3
    max_tokens = JCFG.max_seq - plen - gamma + 1
    outs = []
    for eng in _pair(weights, kind, "int8", spec_gamma=gamma):
        eng.submit([1, 2, 3], max_tokens)
        _rounds(eng)
        outs.append((eng.completions()[0].generated, eng.host_syncs))
        with pytest.raises(ValueError, match="slack"):
            eng.submit([1, 2, 3], max_tokens + 1)
        with pytest.raises(ValueError, match="temperature"):
            eng.submit([1, 2, 3], 4, temperature=0.7)
    assert outs[0] == outs[1] and len(outs[1][0]) == max_tokens


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_draft_cache_isolated_per_slot(weights, kind):
    """One slot, three requests in turn: a retired request's draft rows
    never leak into the next one's proposals (the draft prefill zeroes the
    row past the prompt), so acceptance and streams match the JAX engine
    and the streams the plain engine."""
    prompts = [p for p, _ in _traffic(3, seed=5)]
    outs = []
    for eng in _pair(weights, kind, "self", spec_gamma=2, n_slots=1):
        for prompt in prompts:
            eng.submit(prompt, 8)
            _rounds(eng)
        outs.append((_streams(eng.completions()), eng.host_syncs))
    plain = _plain(weights, kind, n_slots=1)
    for prompt in prompts:
        plain.submit(prompt, 8)
        plain.run_until_drained()
    assert outs[0] == outs[1] and outs[1][0] == _streams(plain.completions())


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_snapshot_mid_stream_restores_across_packages(weights, kind, direction):
    """A speculative engine's snapshot after two rounds restores into the
    other package's speculative engine; both continue alike, and as the
    uninterrupted run."""
    reqs = _traffic(3, seed=11, budget=(10, 20), plen=(3, 9))  # histories fit the bucket
    want = _streams(_pair(weights, kind, "int8", spec_gamma=3)[1].pump(reqs))
    je, te = _pair(weights, kind, "int8", spec_gamma=3)
    writer = je if direction == "jax-to-port" else te
    for prompt, mt in reqs:
        writer.submit(prompt, mt)
    writer.step()
    writer.step()
    done = _streams(writer.completions())
    snap = json.loads(json.dumps(writer.snapshot_active()))
    assert len(snap["requests"]) + len(done) == 3 and snap["requests"]
    outs = []
    for eng in _pair(weights, kind, "int8", spec_gamma=3):
        eng.restore(json.loads(json.dumps(snap)))
        _rounds(eng)
        outs.append((_streams(eng.completions()), eng.host_syncs))
    assert outs[0] == outs[1]
    assert {**done, **outs[1][0]} == want


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_programs_keep_their_buffers_and_their_bound(weights, monkeypatch, kind):
    """Through admissions, retirements and a restore the speculative
    programs read nothing to the host, every buffer they read keeps its
    address, and the engine runs at most its bound of programs (the
    dense engine four, the paged one ``graph_bound``)."""
    te = _pair(weights, kind, "int8", spec_gamma=2, sync_interval=2)[1]
    names = ["_d_cache", "_cache", "_active", "_last", "_pos", "_prompt", "_admit"]

    def ptrs():
        out = {}
        for n in names:
            v = getattr(te, n)
            out[n] = (v.k.data_ptr(), v.v.data_ptr()) if hasattr(v, "k") else v.data_ptr()
        return out

    before = ptrs()
    ran = set()
    run = te._run

    def checked(name, fn):
        assert ptrs() == before
        ran.add(name)
        return run(name, fn)

    te._run = checked
    _guard_programs(monkeypatch)
    reqs = _traffic(5, seed=7)
    te.pump(reqs[:4])
    te.submit(*reqs[4])
    te.step_burst()
    snap = te.snapshot_active()
    te.release_active()
    te.restore(snap)
    te.run_until_drained()
    assert ptrs() == before
    assert {"spec round", "draft prefill"} <= ran
    assert not any(n.startswith("burst") for n in ran)  # a round takes the burst's place
    assert len(ran) <= getattr(te, "graph_bound", 4)
    if kind == "paged":
        assert te.graph_bound == 4 + 2
    assert te.graphs == {}


def _spy_window_ends(monkeypatch):
    """Record the last position of every active row's window that the
    engines' rounds score (``decode.decode_chunk`` and
    ``paged.paged_decode_chunk`` with ``active``)."""
    ends = []

    def spy(fn, at):
        def wrapped(*args, active=None, **kw):
            if active is not None:
                window, pos = args[at], args[at + 1]
                pos = torch.as_tensor(pos).expand(window.shape[0])[active]
                ends.extend((pos + window.shape[1] - 1).tolist())
            return fn(*args, active=active, **kw)
        return wrapped

    monkeypatch.setattr(td, "decode_chunk", spy(td.decode_chunk, 2))
    monkeypatch.setattr(tp, "paged_decode_chunk", spy(tp.paged_decode_chunk, 3))
    return ends


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_unrestorable_entries_under_speculation(weights, monkeypatch, kind, rope):
    """Three restored entries under ``spec_gamma=4``, with rotary or learned
    position embeddings, each held against the JAX engine: a sampled one
    continues greedily from the restore on, as the reference's rounds
    verify the argmax; a greedy one with the verify window's slack
    continues; and one without the slack continues too, as the reference's
    does: its last rounds' windows reach past ``max_seq`` (checked), their
    writes there are dropped (the dense cache wraps them onto positions
    they write back unchanged, the paged table's extra null columns take
    them), learned position embeddings read the table's last row there, as
    the reference's gather clamps, and the budget clip stops the stream
    before any query past ``max_seq`` commits.  Without RoPE the one-layer
    draft rejects often enough that a window starts within ``gamma`` of
    ``max_seq``; the int8 self-draft's full acceptance does not.

    There the JAX paged engine does not drop those writes: its block-id
    gather clamps the column past the table onto the row's last block, so
    the window's positions past ``max_seq`` overwrite that block's first
    positions, which the window's own queries then attend, and entry 1's
    stream leaves the one its dense engine and the port's plain engines
    give.  The port drops them in both engines, so without RoPE the paged
    engine's entry 1 is held against the JAX dense engine's, and the JAX
    paged engine's difference is checked, so that it shows if it goes."""
    if rope:
        pair = (weights, kind, "int8")
        extra = {}
    else:
        jparams = jb.init_params(jax.random.PRNGKey(0), JCFG_ABS)
        pair = ((jparams, params_from_jax(jparams, device="cpu")), kind, "shallow")
        extra = dict(cfgs=(JCFG_ABS, TCFG_ABS))
    je, te = _pair(*pair, spec_gamma=4, **extra)
    entry = dict(deadline=None, key=[0, 0], adapter=0, priority=0)
    snap = {"next_id": 3, "requests": [
        dict(entry, request_id=0, tokens=[1, 2, 3, 4], prompt_len=3, max_tokens=6,
             temperature=0.8),
        dict(entry, request_id=1, tokens=[1, 2, 3, 4], prompt_len=3, max_tokens=60,
             temperature=0.0),
        dict(entry, request_id=2, tokens=[1, 2, 3, 4], prompt_len=3, max_tokens=6,
             temperature=0.0),
    ]}
    assert je.restore(json.loads(json.dumps(snap))) == [0, 1, 2]
    assert te.restore(json.loads(json.dumps(snap))) == [0, 1, 2]
    je.run_until_drained()
    ends = _spy_window_ends(monkeypatch)
    te.run_until_drained()
    want, got = _streams(je.completions()), _streams(te.completions())
    if kind == "paged" and not rope:
        jd, _ = _pair(pair[0], "dense", pair[2], spec_gamma=4, **extra)
        assert jd.restore(json.loads(json.dumps(snap))) == [0, 1, 2]
        jd.run_until_drained()
        dense = _streams(jd.completions())
        assert dense[1] != want[1]  # the JAX paged engine's clamped write
        want[1] = dense[1]
    assert {r: st for r, (_, st) in got.items()} == {0: "ok", 1: "ok", 2: "ok"}
    assert got == want
    assert len(got[0][0]) == len(got[2][0]) == 6
    assert len(got[1][0]) == 60  # the reference resumes it, and so does the port
    assert max(ends) >= TCFG.max_seq


# -- the paged engine ---------------------------------------------------------------

def _system_traffic(n=6, seed=3, sys_tokens=16, vocab=128):
    """``n`` greedy requests, each one of two seeded system prompts
    (alternating) of two 8-token blocks and 1-12 tokens of its own, 4-16
    new tokens."""
    r = np.random.RandomState(seed)
    systems = [r.randint(0, vocab, size=sys_tokens).tolist() for _ in range(2)]
    return [dict(prompt=systems[i % 2] + r.randint(0, vocab, size=int(r.randint(1, 13))).tolist(),
                 max_tokens=int(r.randint(4, 17))) for i in range(n)]


@pytest.mark.parametrize("sync_interval", [1, 3])
def test_prefix_store_chunks_and_speculation_compose(weights, monkeypatch, sync_interval):
    """The prefix store, 1-block chunks and speculation together: the JAX
    engine's streams, host syncs, hits and misses, and the plain engine's
    streams."""
    reqs = _system_traffic(n=7, seed=17)
    kw = dict(n_blocks=40, sync_interval=sync_interval, prefix_cache_blocks=4,
              prefill_chunk_blocks=1)
    je, te = _pair(weights, "paged", "int8", spec_gamma=3, **kw)
    want = _streams(je.pump(reqs))
    _guard_programs(monkeypatch)
    got = _streams(te.pump(reqs))
    assert got == want and len(got) == 7
    assert _counters(te) == _counters(je) and te.prefix_hits > 0
    _assert_caches_close(te, je, "paged")
    assert got == _streams(_plain(weights, "paged", **kw).pump(reqs))


@pytest.fixture
def bundles(tmp_path, monkeypatch):
    """The JAX engine's wedge path writes a diagnostics bundle: keep it in
    the test's temporary directory."""
    from k8s_dra_driver_tpu.utils.watchdog import WATCHDOG

    monkeypatch.setattr(WATCHDOG, "_bundle_dir", str(tmp_path))


@pytest.mark.parametrize("prefix", [0, 4])
def test_tight_pool_preempts_and_readmits_at_lookahead_gamma(weights, bundles, prefix):
    """Growth covers the verify window (``lookahead = gamma``, clamped to
    what a slot can still commit); on a 7-block pool slots stall, requests
    are preempted and re-admitted (their draft rows re-prefilled from the
    parked tokens), all as in the JAX engine."""
    r = np.random.RandomState(23)
    reqs = [dict(prompt=r.randint(0, 128, size=int(r.randint(4, 14))).tolist(),
                 max_tokens=int(r.randint(12, 24))) for _ in range(6)]
    kw = dict(n_blocks=8, sync_interval=2, prefix_cache_blocks=prefix)
    je, te = _pair(weights, "paged", "int8", spec_gamma=3, **kw)
    want = _streams(je.pump(reqs))
    got = _streams(te.pump(reqs))
    assert got == want and len(got) == 6
    assert _counters(te) == _counters(je)
    assert te.preempted_count > 0 and te.stalled_steps > 0
    assert got == _streams(_plain(weights, "paged", n_blocks=60).pump(reqs))


def test_int4_draft_streams_identical_to_jax(weights):
    """An int4 self-draft (``quantize_blocks(bits=4)``; on the card its
    products go through the int4 kernels): the JAX engine's streams and
    host syncs."""
    reqs = _traffic(4, seed=41)
    je, te = _pair(weights, "paged", "int4", spec_gamma=2, n_blocks=40)
    assert isinstance(te.draft_params["blocks"][0]["qkv"], tq.Quantized4Matrix)
    assert _streams(te.pump(reqs)) == _streams(je.pump(reqs))
    assert _counters(te) == _counters(je)


def test_against_the_jax_kernel_in_interpret_mode(weights):
    """The JAX engine's verify window through its Pallas kernel (interpret
    mode, ``nq = gamma + 1``) against the port's, whose CPU path is the
    kernel's plain version."""
    reqs = _traffic(3, seed=31, budget=(4, 9))
    je, te = _pair(weights, "paged", "int8", spec_gamma=2, n_blocks=40, kernel=True)
    assert je.attn_impl == "kernel"
    assert _streams(te.pump(reqs)) == _streams(je.pump(reqs))
    assert _counters(te) == _counters(je)


def test_verify_windows_stay_inside_the_table(weights, monkeypatch):
    """The append kernel's rule ``pos + nq <= max_blocks * bs`` holds on
    every verify call: for active rows by ``check_submit``'s slack bound,
    for retired rows, whose device position runs past the slack when the
    host clips a round's commit, by the round's clamp."""
    gamma = 4
    te = _pair(weights, "paged", "self", spec_gamma=gamma)[1]
    from k8s_dra_driver_torch.ops import paged_attention as tpa

    seen, raw = [], []
    wrapper = tpa.paged_append_attention

    def checked(q, new_k, new_v, k_pools, v_pools, table, pos, layer, write_mask=None):
        if q.shape[1] == gamma + 1 and layer == 0:
            seen.append(int((pos.long() + q.shape[1]).max()) - table.shape[1] * k_pools.shape[4])
            raw.append(int(te._pos.max()))
        return wrapper(q, new_k, new_v, k_pools, v_pools, table, pos, layer,
                       write_mask=write_mask)

    monkeypatch.setattr(tpa, "paged_append_attention", checked)
    # full acceptance commits 5 a round: 57 tokens end one token into the
    # 12th round, whose other 4 the host clips, so that row's device
    # position ends at 63, past the slack (59); the second request, admitted
    # 3 rounds later, is still running then
    te.submit([1, 2, 3], 57)
    for _ in range(3):
        te.step()
    te.submit([4, 5, 6], JCFG.max_seq - 3 - gamma + 1)  # at the bound
    _rounds(te)
    assert len(te.completions()) == 2
    assert seen and max(seen) <= 0
    assert max(raw) > JCFG.max_seq - 1 - gamma  # a retired row sat past the slack


def test_verify_window_past_a_block_serves_on_the_cpu(weights):
    """``spec_gamma + 1 > block_size`` (a window of 5 over blocks of 4): the
    CPU's plain path serves it, as the reference's XLA path does, with the
    JAX engine's streams, host syncs and pool counts."""
    reqs = _traffic(5, seed=43)
    je, te = _pair(weights, "paged", "int8", spec_gamma=4, block_size=4)
    assert _streams(te.pump(reqs)) == _streams(je.pump(reqs))
    assert _counters(te) == _counters(je)


def test_verify_window_must_fit_a_block(weights):
    """On the card the append kernel takes a window of at most one block,
    so ``check_verify_window`` refuses a CUDA engine with ``spec_gamma + 1 >
    block_size`` (called directly: no card needed); the CPU takes any."""
    with pytest.raises(ValueError, match="exceeds block_size"):
        tp.check_verify_window(4, 4, "cuda")
    tp.check_verify_window(3, 4, "cuda")
    tp.check_verify_window(4, 4, "cpu")
    _, tparams = weights
    eng = tp.PagedServeEngine(params=tparams, cfg=TCFG, device="cpu", block_size=4,
                              spec_gamma=3)
    assert eng._d_cache.k.shape == (2, eng.n_slots, JCFG.max_seq, 2, 16)
