"""The port's training checkpointer (``models/train_checkpoint.py``), the
single-device cases of ``tests/test_train_checkpoint.py`` on the CPU: a
preempted job resumes bit-exact, only the newest ``keep`` steps stay, a
restore with nothing saved raises; and the port's own contract, a restore
into ``like`` that writes in place (what a CUDA graph of the step needs)
and refuses a ``like`` that does not match."""

import dataclasses

import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models.train_checkpoint import TrainCheckpointer

CFG = dataclasses.replace(tb.TINY, dtype=torch.float32)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module, restored afterwards: the
    suite's other workers keep their cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _trained(steps=2):
    fns = tb.build_train_step(CFG, lr=1e-2, device="cpu")
    params, opt_state = fns.init(torch.Generator().manual_seed(0))
    tokens = tb.sample_tokens(torch.Generator().manual_seed(1), CFG, batch=2, seq=32)
    for _ in range(steps):
        fns.step(params, opt_state, tokens)
    return fns, params, opt_state, tokens


def _leaves(params, opt_state):
    return [*tb.param_leaves(params), opt_state["count"], *opt_state["mu"], *opt_state["nu"]]


def test_single_device_roundtrip_resumes_bit_exact(tmp_path):
    fns, params, opt_state, tokens = _trained(2)
    ckpt = TrainCheckpointer(tmp_path / "ckpt", keep=2)
    ckpt.save(2, (params, opt_state))
    _, _, l3 = fns.step(params, opt_state, tokens)

    # resume from the checkpoint and repeat step 3: bit-exact
    assert ckpt.latest_step() == 2
    r_params, r_opt = ckpt.restore(like=(params, opt_state))
    _, _, l3b = fns.step(r_params, r_opt, tokens)
    assert torch.equal(l3, l3b)
    ckpt.close()


def test_keep_limit_garbage_collects(tmp_path):
    ckpt = TrainCheckpointer(tmp_path / "ckpt", keep=2)
    state = {"w": torch.arange(4.0)}
    for step in (1, 2, 3):
        ckpt.save(step, state)
    assert ckpt.all_steps() == [2, 3]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["2", "3"]
    ckpt.close()


def test_restore_missing_raises(tmp_path):
    ckpt = TrainCheckpointer(tmp_path / "empty")
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ckpt.restore()
    ckpt.close()


def test_restore_like_writes_in_place_and_plain_restore_is_on_the_cpu(tmp_path):
    """``like``'s tensors are the ones filled (same objects, same
    addresses) with the saved bits; a later save does not see updates made
    after an earlier one returned; without ``like`` the tree comes back."""
    fns, params, opt_state, tokens = _trained(2)
    want = [t.clone() for t in _leaves(params, opt_state)]
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    ckpt.save(2, (params, opt_state), wait=False)
    fns.step(params, opt_state, tokens)  # moves every leaf on after the save returned
    ptrs = [(id(t), t.data_ptr()) for t in _leaves(params, opt_state)]
    out = ckpt.restore(like=(params, opt_state))
    assert out[0] is params and out[1] is opt_state
    got = _leaves(params, opt_state)
    assert [(id(t), t.data_ptr()) for t in got] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    plain = ckpt.restore(2)
    assert isinstance(plain, tuple) and plain[1]["count"] == 2
    assert all(t.device.type == "cpu" and torch.equal(a, t)
               for a, t in zip(want, _leaves(*plain)))
    ckpt.close()


@pytest.mark.parametrize("bad", ["shape", "dtype", "keys", "length"])
def test_restore_into_a_mismatched_like_raises(tmp_path, bad):
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    ckpt.save(0, {"w": torch.zeros(4), "m": [torch.zeros(2), torch.zeros(3)]})
    like = {"w": torch.ones(4), "m": [torch.ones(2), torch.ones(3)]}
    if bad == "shape":
        like["w"] = torch.ones(5)
    elif bad == "dtype":
        like["m"][1] = torch.ones(3, dtype=torch.bfloat16)
    elif bad == "keys":
        like["x"] = like.pop("w")
    else:
        like["m"].append(torch.ones(1))
    with pytest.raises(ValueError, match="not match"):
        ckpt.restore(0, like=like)
    ckpt.close()


def test_a_saved_step_is_not_overwritten(tmp_path):
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    ckpt.save(1, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="already saved"):
        ckpt.save(1, {"w": torch.ones(2)})
    assert torch.equal(ckpt.restore(1)["w"], torch.zeros(2))
    assert not any(p.name.startswith(".tmp") for p in (tmp_path / "ckpt").iterdir())
    ckpt.close()
