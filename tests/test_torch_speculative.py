"""Greedy speculative decoding in the PyTorch port
(``models/speculative.py``) against the JAX package's
``speculative_decode`` and ``greedy_decode`` on the CPU, with the same
weights (``weights.params_from_jax``) and seeded prompts.

Tolerances: token streams and every ``SpecStats`` count identical (the
acceptance rule is integer arithmetic on argmaxes; a draft's near tie
could move a count, and these seeds have none); ``accept_advance``
identical on random arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import decode as td
from k8s_dra_driver_torch.models import quant as tq
from k8s_dra_driver_torch.models import speculative as ts
from k8s_dra_driver_torch.models.weights import params_from_jax
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import decode as jd
from k8s_dra_driver_tpu.models import quant as jq
from k8s_dra_driver_tpu.models import speculative as js

JCFG = jb.ModelConfig(
    vocab_size=96, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
    d_ff=64, max_seq=64, rope=True, dtype=jnp.float32,
)
TCFG = tb.ModelConfig.from_reference(JCFG)


@pytest.fixture(scope="module")
def weights():
    params = jb.init_params(jax.random.PRNGKey(0), JCFG)
    return params, params_from_jax(params, device="cpu")


@pytest.fixture(scope="module")
def prompt():
    return np.random.RandomState(1).randint(0, JCFG.vocab_size, size=(3, 5)).astype(np.int32)


def _drafts(jparams):
    """The JAX package's drafts by name: the int8 self-draft, the target
    itself (full acceptance), its first layer, and a draft with permuted
    weights (near-zero acceptance)."""
    rng = jax.random.PRNGKey(7)
    return {
        "int8": jq.quantize_blocks(jparams),
        "self": jparams,
        "shallow": dict(jparams, blocks=jparams["blocks"][:1]),
        "adversarial": jax.tree.map(
            lambda x: jax.random.permutation(rng, x.ravel()).reshape(x.shape), jparams
        ),
    }


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_accept_advance_matches_jax(seed):
    r = np.random.RandomState(seed)
    b, gamma = 6, 1 + seed
    proposed = r.randint(0, 3, size=(b, gamma)).astype(np.int32)
    target = r.randint(0, 3, size=(b, gamma + 1)).astype(np.int32)
    target[0, :gamma] = proposed[0]  # one row accepts everything
    active = r.rand(b) > 0.3
    j_acc, j_adv = js.accept_advance(jnp.asarray(proposed), jnp.asarray(target),
                                     jnp.asarray(active))
    t_acc, t_adv = ts.accept_advance(torch.from_numpy(proposed), torch.from_numpy(target),
                                     torch.from_numpy(active))
    np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))
    np.testing.assert_array_equal(t_adv.numpy(), np.asarray(j_adv))
    assert t_adv.dtype == torch.int32 and int(t_adv[0]) == (gamma + 1) * int(active[0])


@pytest.mark.parametrize("draft,gamma,steps", [
    ("int8", 1, 12), ("int8", 2, 12), ("int8", 3, 20), ("int8", 4, 20),
    ("self", 4, 20), ("shallow", 3, 16), ("adversarial", 4, 12),
])
def test_speculative_decode_matches_jax_and_greedy(weights, prompt, draft, gamma, steps):
    """Token for token the JAX package's ``speculative_decode`` and the
    port's ``greedy_decode``, with equal ``SpecStats``."""
    jparams, tparams = weights
    jdraft = _drafts(jparams)[draft]
    tdraft = params_from_jax(jdraft, device="cpu")
    jout, jstats = js.speculative_decode(jparams, jdraft, jnp.asarray(prompt), steps, JCFG,
                                         gamma=gamma, return_stats=True)
    tout, tstats = ts.speculative_decode(tparams, tdraft, prompt, steps, TCFG, gamma=gamma,
                                         return_stats=True, device="cpu")
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    greedy = td.greedy_decode(tparams, prompt, steps, TCFG, batch_prefill=True, device="cpu")
    assert torch.equal(tout, greedy)
    np.testing.assert_array_equal(np.asarray(jd.greedy_decode(
        jparams, jnp.asarray(prompt), steps, cfg=JCFG, batch_prefill=True)), tout.numpy())
    assert [int(x) for x in tstats] == [int(x) for x in jstats]
    assert int(tstats.emitted) == steps * prompt.shape[0]
    assert float(tstats.acceptance) == pytest.approx(float(jstats.acceptance))
    assert float(tstats.tokens_per_round) == pytest.approx(float(jstats.tokens_per_round))
    if draft == "self":  # full acceptance: gamma + 1 a round
        assert float(tstats.acceptance) == 1.0
        assert int(tstats.rounds) == -(-steps // (gamma + 1))


def test_int8_self_draft_from_the_ports_quantizer(weights, prompt):
    """The port's own int8 quantization of the converted weights is the
    JAX self-draft, byte for byte, so the run is the JAX run."""
    jparams, tparams = weights
    jout, jstats = js.speculative_decode(jparams, jq.quantize_blocks(jparams),
                                         jnp.asarray(prompt), 16, JCFG, gamma=3,
                                         return_stats=True)
    tout, tstats = ts.speculative_decode(tparams, tq.quantize_blocks(tparams), prompt, 16, TCFG,
                                         gamma=3, return_stats=True, device="cpu")
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert [int(x) for x in tstats] == [int(x) for x in jstats]


def test_bf16_cache_emits_every_token(weights, prompt):
    """A bfloat16 cache runs and emits every token (greedy equality holds
    within one cache dtype only, as the reference says)."""
    _, tparams = weights
    out, stats = ts.speculative_decode(tparams, tq.quantize_blocks(tparams), prompt, 8, TCFG,
                                       gamma=3, cache_dtype=torch.bfloat16, return_stats=True,
                                       device="cpu")
    assert out.shape == (3, 13) and torch.equal(out[:, :5], torch.from_numpy(prompt).long())
    assert int(stats.emitted) == 8 * 3


def test_rounds_read_nothing_to_the_host_but_their_flag(weights, prompt, monkeypatch):
    """A round is one fixed-shape function of its state tensors (a CUDA
    graph on the card): no host read inside it."""
    _, tparams = weights
    inner = ts._decode_round

    def guarded(*a, **k):
        def refuse(*_a, **_k):
            raise AssertionError("host read inside a round")

        with monkeypatch.context() as m:
            for name in ("item", "tolist", "__bool__", "cpu", "numpy"):
                m.setattr(torch.Tensor, name, refuse)
            return inner(*a, **k)

    monkeypatch.setattr(ts, "_decode_round", guarded)
    out = ts.speculative_decode(tparams, tparams, prompt, 6, TCFG, gamma=2, device="cpu")
    assert out.shape == (3, 11)


def test_validation_messages_match_jax(weights, prompt):
    jparams, tparams = weights
    for fn, params, args in ((js.speculative_decode, jparams, (jnp.asarray(prompt),)),
                             (ts.speculative_decode, tparams, (prompt,))):
        kw = dict(device="cpu") if fn is ts.speculative_decode else {}
        cfg = TCFG if fn is ts.speculative_decode else JCFG
        with pytest.raises(ValueError, match="steps must be >= 1"):
            fn(params, params, *args, 0, cfg, **kw)
        with pytest.raises(ValueError, match="gamma must be >= 1"):
            fn(params, params, *args, 4, cfg, gamma=0, **kw)
        # 5 + 56 + 4 = 65 > 64; one step fewer fits exactly
        with pytest.raises(ValueError, match="needs gamma slack"):
            fn(params, params, *args, 56, cfg, gamma=4, **kw)
    assert ts.speculative_decode(tparams, tparams, prompt, 55, TCFG, gamma=4,
                                 device="cpu").shape == (3, 60)


def test_defaults_to_the_card(weights, prompt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tparams = weights
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.speculative_decode(tparams, tparams, prompt, 4, TCFG)
