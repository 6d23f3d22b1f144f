"""The port's entry point (``k8s_dra_driver_torch/entry.py``) against
``__graft_entry__.py`` and the JAX package, on the CPU.

* ``FLAGSHIP`` is the reference's classic flagship field for field;
* the classic layout (learned positions, MHA) forward at FLAGSHIP's widths
  narrowed to 2 layers at d_model 128, f32, on the JAX weights carried
  across by ``weights.params_from_jax``: logits within atol = rtol = 1e-4
  (``tests/test_torch_burnin.py``'s bound: the same products summed in
  another order);
* ``entry(device="cpu")``: the modern flagship, params from seed 0, tokens
  ``[8, 1024]`` int32 from seed 1 (the full-width forward is not run here);
* ``dryrun_multichip``: its command, and the reference's messages for a
  child that exits nonzero or outlives the watchdog (stubbed commands);
* every entry point raises without a card unless asked for the CPU.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from k8s_dra_driver_torch import entry
from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models.weights import params_from_jax
from k8s_dra_driver_tpu.models import burnin as jb

ATOL = RTOL = 1e-4


def test_flagship_is_the_reference_field_for_field():
    assert tb.ModelConfig.from_reference(jb.FLAGSHIP) == tb.FLAGSHIP
    assert (tb.FLAGSHIP.n_kv_heads, tb.FLAGSHIP.rope) == (None, False)
    assert tb.ModelConfig.from_reference(jb.FLAGSHIP_MODERN) == tb.FLAGSHIP_MODERN


def test_classic_layout_forward_matches_jax():
    jcfg = dataclasses.replace(jb.FLAGSHIP, n_layers=2, d_model=128, dtype=jnp.float32)
    jp = jb.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tb.ModelConfig.from_reference(jcfg)
    assert "pos_embed" in jp and tcfg.kv_heads == tcfg.n_heads
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, size=(2, 48)).astype(np.int32)
    want = np.asarray(jb.forward(jp, jnp.asarray(toks), jcfg, remat="none"))
    got = tb.forward(params_from_jax(jp, device="cpu"), torch.from_numpy(toks), tcfg).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 48, jcfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_entry_gives_the_modern_flagship_and_its_seeded_batch(monkeypatch):
    seeds = []
    real_init = tb.init_params

    def init(generator, cfg):
        seeds.append((generator.initial_seed(), generator.device.type, cfg))
        return real_init(generator, cfg)

    monkeypatch.setattr(tb, "init_params", init)
    fn, (params, tokens) = entry.entry(device="cpu")
    cfg = tb.FLAGSHIP_MODERN
    assert seeds == [(0, "cpu", cfg)]
    assert fn.func is tb.forward and fn.keywords == {"cfg": cfg}
    assert tokens.shape == (8, cfg.max_seq) and tokens.dtype == torch.int32
    assert torch.equal(tokens, tb.sample_tokens(torch.Generator().manual_seed(1), cfg, 8, 1024))
    assert params["embed"].shape == (cfg.vocab_size, cfg.d_model)
    assert "pos_embed" not in params and len(params["blocks"]) == cfg.n_layers
    assert {t.dtype for t in tb.param_leaves(params)} == {torch.bfloat16}
    assert params["blocks"][0]["qkv"].shape == (1024, (16 + 2 * 4) * 64)


def test_main_runs_the_reference_steps_in_order(monkeypatch, capsys):
    """The reference's ``__main__`` at a small width: the modern forward,
    the classic one, then the dry run at 8 (stubbed here)."""
    small = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=1, d_ff=64, max_seq=16,
                 dtype=torch.float32)
    monkeypatch.setattr(tb, "FLAGSHIP_MODERN", tb.ModelConfig(**small, n_kv_heads=2, rope=True))
    monkeypatch.setattr(tb, "FLAGSHIP", tb.ModelConfig(**small))
    calls = []
    monkeypatch.setattr(entry, "dryrun_multichip", lambda n, dev: calls.append((n, dev.type)))
    assert entry.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        "entry forward ok: logits (8, 16, 64) torch.float32 (eager: the CPU captures no graph)",
        "classic flagship forward ok: logits (8, 16, 64)",
    ]
    assert calls == [(8, "cpu")]


def test_dryrun_command_takes_the_device():
    cmd = entry._dryrun_command(8, torch.device("cpu"))
    assert cmd == [sys.executable, "-m", "k8s_dra_driver_torch.e2e.dryrun", "8", "--device", "cpu"]
    assert entry._dryrun_command(4, torch.device("cuda"))[3:] == ["4"]
    assert entry.DRYRUN_TIMEOUT_S == graft.DRYRUN_TIMEOUT_S


def _stub(monkeypatch, code):
    monkeypatch.setattr(entry, "_dryrun_command", lambda n, dev: [sys.executable, "-c", code])


def test_dryrun_multichip_prints_the_child_and_names_a_nonzero_exit(monkeypatch, capsys):
    _stub(monkeypatch, "import sys; print('a line'); sys.stderr.write('boom'); sys.exit(3)")
    with pytest.raises(RuntimeError) as exc:
        entry.dryrun_multichip(8, device="cpu")
    assert str(exc.value) == "dryrun_multichip(8) exited rc=3; stderr tail: 'boom'"
    assert capsys.readouterr().out == "a line\n"
    _stub(monkeypatch, "import sys; print('ok'); sys.stderr.write('launches')")
    proc = entry.dryrun_multichip(2, device="cpu")
    assert (proc.returncode, proc.stdout, proc.stderr) == (0, "ok\n", "launches")


def test_dryrun_multichip_watchdog(monkeypatch):
    monkeypatch.setattr(entry, "DRYRUN_TIMEOUT_S", 1.0)
    _stub(monkeypatch, "import sys, time; sys.stderr.write('stuck'); sys.stderr.flush(); "
                       "time.sleep(60)")
    with pytest.raises(RuntimeError) as exc:
        entry.dryrun_multichip(4, device="cpu")
    assert str(exc.value) == ("dryrun_multichip(4) timed out after 1s (the child should never "
                              "hang; stderr tail: 'stuck')")


def test_every_entry_point_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (entry.entry, entry.classic, lambda: entry.dryrun_multichip(8),
                 lambda: entry.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
