"""The port's PRNG (``models/prng.py``), sampling tail
(``serve.sample_next``) and dense ``decode.sample_decode`` against
``jax.random`` and the JAX package's functions, on the CPU.

Tolerances: keys, ``fold_in``, random bits and uniforms bit for bit;
Gumbel noise within 1e-6 absolute (``-log(-log(u))`` goes through each
library's own float32 ``log``, which differ by an ulp on some inputs);
sampled tokens exactly, any mismatch reported with its margin (the gap
between the two tokens' perturbed scores)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import decode as td
from k8s_dra_driver_torch.models import prng
from k8s_dra_driver_torch.models import serve as ts
from k8s_dra_driver_torch.models.weights import params_from_jax
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import decode as jd
from k8s_dra_driver_tpu.models import serve as js

MASK = 0xFFFFFFFF
GUMBEL_ATOL = 1e-6


def _keys(n, seed=0):
    """``n`` random keys as uint32 numpy ``[n, 2]``."""
    return np.random.RandomState(seed).randint(0, 2**32, size=(n, 2), dtype=np.uint64).astype(
        np.uint32
    )


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, -1, 2**31 - 1, 2**32 + 5])
def test_prng_key_matches_jax(seed):
    assert prng.prng_key(seed).tolist() == np.asarray(jax.random.PRNGKey(seed)).tolist()


@pytest.mark.parametrize("key,count,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((MASK, MASK), (MASK, MASK), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
], ids=["zeros", "ones", "pi"])
def test_threefry_known_answers(key, count, want):
    y0, y1 = prng.threefry2x32(torch.tensor(key), torch.tensor([count[0]]),
                               torch.tensor([count[1]]))
    assert (int(y0), int(y1)) == want


def test_threefry_matches_jax_on_random_keys_and_counters():
    r = np.random.RandomState(1)
    for key in _keys(6, seed=2):
        count = r.randint(0, 2**32, size=(2, 257), dtype=np.uint64).astype(np.uint32)
        # jax hashes the pairs (count[:n], count[n:]) of a flat count of 2n
        want = np.asarray(jax_prng.threefry_2x32(jnp.asarray(key), jnp.asarray(count.ravel())))
        y0, y1 = prng.threefry2x32(_t(key), _t(count[0]), _t(count[1]))
        np.testing.assert_array_equal(np.concatenate([y0.numpy(), y1.numpy()]),
                                      want.astype(np.int64))


def test_fold_in_matches_jax_for_positions_0_to_4095():
    keys = _keys(4096, seed=3)
    pos = np.arange(4096, dtype=np.int32)
    want = np.asarray(jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(pos)))
    got = prng.fold_in(_t(keys), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # one key over every position, as a slot folds its base key per step
    one = np.broadcast_to(keys[:1], (4096, 2))
    want = np.asarray(jax.vmap(jax.random.fold_in)(jnp.asarray(one), jnp.asarray(pos)))
    got = prng.fold_in(_t(one), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


SHAPES = [(8, 128), (3, 32768), (5, 7)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_random_bits_match_jax(shape):
    keys = _keys(4, seed=4)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, shape, jnp.uint32))(jnp.asarray(keys)))
    got = prng.random_bits(_t(keys), shape)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # a single key without a batch axis
    np.testing.assert_array_equal(prng.random_bits(_t(keys[0]), shape).numpy(),
                                  want[0].astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_uniform_bit_for_bit_and_gumbel_within_tolerance(shape):
    keys = _keys(4, seed=5)
    tiny = np.finfo(np.float32).tiny
    want_u = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, shape, jnp.float32, minval=tiny, maxval=1.0)
    )(jnp.asarray(keys)))
    got_u = prng.uniform(_t(keys), shape).numpy()
    np.testing.assert_array_equal(got_u.view(np.int32), want_u.view(np.int32))
    want_g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, shape, jnp.float32))(
        jnp.asarray(keys)))
    got_g = prng.gumbel(_t(keys), shape).numpy()
    np.testing.assert_allclose(got_g, want_g, atol=GUMBEL_ATOL, rtol=0)


def _logits(b, v, seed):
    """Logits with near ties: a few rows share their top values."""
    r = np.random.RandomState(seed)
    x = r.randn(b, v).astype(np.float32) * 3
    x[::7, 1] = x[::7, 0]  # exact ties on some rows
    return x


def _mismatches(got, want, logits, pos, temps, keys, top_k):
    """Rows where the tokens differ, each with the gap between the two
    tokens' perturbed scores under the port's noise."""
    out = []
    scaled = logits / torch.clamp_min(temps, 1e-6)[:, None]
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    noise = prng.gumbel(prng.fold_in(keys, pos), logits.shape[-1:]) + scaled
    for row in np.flatnonzero(got != want):
        g, w = int(got[row]), int(want[row])
        out.append((int(row), g, w, float(noise[row, g] - noise[row, w])))
    return out


@pytest.mark.parametrize("top_k", [0, 1, 5])
def test_sample_next_matches_jax(top_k):
    b, v = 64, 1000
    x = _logits(b, v, seed=6 + top_k)
    temps = np.array([0.0, -1.0, 0.5, 1.5] * (b // 4), np.float32)
    keys = _keys(b, seed=7)
    pos = np.random.RandomState(8).randint(0, 4096, size=b).astype(np.int32)
    want = np.asarray(js.sample_next(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(temps),
                                     jnp.asarray(keys), top_k=top_k))
    logits, t_pos, t_temps, t_keys = (torch.from_numpy(x), torch.from_numpy(pos),
                                      torch.from_numpy(temps), _t(keys))
    got = ts.sample_next(logits, t_pos, t_temps, t_keys, top_k=top_k)
    assert got.dtype == torch.int32
    bad = _mismatches(got.numpy(), want, logits, t_pos, t_temps, t_keys, top_k)
    assert not bad, f"(row, port token, jax token, score margin): {bad}"
    # greedy rows took the first maximum; sampled rows drew something else somewhere
    greedy = temps <= 0
    np.testing.assert_array_equal(got.numpy()[greedy], x[greedy].argmax(-1))
    if top_k != 1:
        assert (got.numpy()[~greedy] != x[~greedy].argmax(-1)).any()


def test_top_k_1_at_temperature_2_is_greedy():
    x = _logits(16, 300, seed=9)
    got = ts.sample_next(torch.from_numpy(x), torch.arange(16, dtype=torch.int32),
                         torch.full((16,), 2.0), _t(_keys(16, seed=10)), top_k=1)
    np.testing.assert_array_equal(got.numpy(), x.argmax(-1))


def test_sample_next_reads_nothing_to_the_host(monkeypatch):
    """The tail runs inside the engine's captured programs: no tensor may
    be read to the host while it runs."""
    x = torch.from_numpy(_logits(8, 256, seed=11))
    args = (torch.arange(8, dtype=torch.int32), torch.tensor([0.0, 0.8] * 4),
            _t(_keys(8, seed=12)))
    want = ts.sample_next(x, *args, top_k=5)

    def refuse(*_a, **_k):
        raise AssertionError("host read inside the sampling tail")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "__bool__", "cpu", "numpy"):
            m.setattr(torch.Tensor, name, refuse)
        got = ts.sample_next(x, *args, top_k=5)
        bits = prng.random_bits(args[2], (3, 5))
    assert torch.equal(got, want) and bits.shape == (8, 3, 5)


@pytest.mark.parametrize("n", [1, 5, 64])
def test_split_matches_jax(n):
    for key in _keys(3, seed=13):
        want = np.asarray(jax.random.split(jnp.asarray(key), n))
        np.testing.assert_array_equal(prng.split(_t(key), n).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("batch_prefill", [False, True])
@pytest.mark.parametrize("temperature,top_k", [(0.8, 0), (1.3, 5), (0.0, 0)])
def test_sample_decode_matches_jax(temperature, top_k, batch_prefill):
    """The dense sampled continuation (one key for the batch, split by
    position) against the JAX package's, at a small size; temperature 0 is
    ``greedy_decode``."""
    jcfg = jb.ModelConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
                          d_ff=128, max_seq=64, rope=True, dtype=jnp.float32)
    jparams = jb.init_params(jax.random.PRNGKey(0), jcfg)
    prompt = np.random.RandomState(1).randint(0, 128, size=(3, 7)).astype(np.int32)
    want = np.asarray(jd.sample_decode(jparams, jnp.asarray(prompt), 12, jcfg,
                                       key=jax.random.PRNGKey(5), temperature=temperature,
                                       top_k=top_k, batch_prefill=batch_prefill))
    got = td.sample_decode(params_from_jax(jparams, device="cpu"), prompt, 12,
                           tb.ModelConfig.from_reference(jcfg), key=prng.prng_key(5),
                           temperature=temperature, top_k=top_k, batch_prefill=batch_prefill,
                           device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    if temperature > 0:
        greedy = np.asarray(jd.greedy_decode(jparams, jnp.asarray(prompt), 12, jcfg))
        assert (want != greedy).any()  # the draw did sample
