"""The mesh and pipeline train steps as one graph each, on four gloo ranks
on the CPU.

A gloo group cannot be captured (it stages CUDA tensors through the host),
so here each graphed step is given a stand-in capture
(``torch_mesh_ranks.StandInCapture``): the program's Python runs once under
a dispatch mode that refuses host reads, host copies and data-dependent
shapes, as a CUDA capture does, and leaves the params and optimizer state
as they were; a replay reruns the program with the counters held, as a
graph replays its kernels and none of the wrappers' Python.  The checks:

* 3 graphed steps equal their eager twin (built without a capture: on
  gloo ``graphed`` is None) bit for bit, losses and every shard and
  optimizer tensor; the byte counters after the 3 replays equal the eager
  run's (the holder adds the capture's bytes at every replay);
* against the JAX package's single-device step (``test_torch_mesh_train``'s
  reference, built once per config): losses within 1e-5 relative, params
  after 3 steps within 1e-4 relative L2 of each leaf and 3 x lr of every
  element, the tolerances stated there;
* one capture for 3 calls; a longer batch or another params tree
  captures anew; a capture that raises is a ``GraphCaptureError`` naming
  the program, with the shards, state and counters as call 1 left them.
"""

import numpy as np
import pytest

from k8s_dra_driver_torch.parallel.ranks import RankPool
from tests import torch_mesh_ranks as R
from tests.test_torch_mesh_train import (
    CFG,
    LOSS_RTOL,
    LR,
    PARAM_RTOL_L2,
    STEPS,
    _flat,
    _reference,
)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, backend="gloo", device_type="cpu", timeout_s=120)
    yield p
    p.close()


# case: (step, layout, options, how the batch is fed, the reference's accum_steps)
CASES = {
    "mesh-data2-model2": ("mesh", (0, {"data": 2, "model": 2}), {}, "whole", 1),
    "mesh-flash-seq4": ("mesh", (0, {"seq": 4}), {"attention": "flash"}, "whole", 1),
    "mesh-accum2-rowblocks": ("mesh", (0, {"data": 2, "model": 2}), {"accum_steps": 2},
                              "blocks", 2),
    "pp-pipe2-model2": ("pp", (0, {"pipe": 2, "model": 2}), {"n_micro": 2}, "whole", 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_graphed_step_equals_its_eager_twin_and_the_reference(pool, case):
    kind, layout, kw, feed, accum = CASES[case]
    params, tokens, losses, _, after = _reference(CFG, accum_steps=accum)
    results = pool.run(R.graph_case, kind, CFG, layout, params, tokens, STEPS, feed, **kw)
    head = results[0]
    for r in results:
        assert r["graphed"] == r["eager"] == head["graphed"]
        assert r["same"]
        assert (r["captures"], r["calls"], r["replays"]) == (1, STEPS, STEPS - 1)
        assert r["bytes_graphed"] == r["bytes_eager"]
        assert r["eager_holder"] is None
    assert sum(sum(r["bytes_eager"][0].values()) for r in results) > 0
    np.testing.assert_allclose(head["graphed"], losses, rtol=LOSS_RTOL, atol=0)
    for g, w in zip(_flat(head["after"]), _flat(after), strict=True):
        assert np.linalg.norm(g - w) <= PARAM_RTOL_L2 * np.linalg.norm(w)
        np.testing.assert_allclose(g, w, atol=STEPS * LR, rtol=0)


def test_a_new_batch_shape_or_params_tree_captures_anew(pool):
    params, tokens, *_ = _reference(CFG)
    for seen, graphs, calls in pool.run(R.recapture_case, CFG, (0, {"data": 2, "model": 2}),
                                        params, tokens):
        assert seen == [1, 2, 3] and graphs == 3 and calls == 2


@pytest.mark.parametrize("kind,layout,kw,name", [
    ("mesh", (0, {"data": 2, "model": 2}), {}, "mesh train step"),
    ("pp", (0, {"pipe": 2, "model": 2}), {"n_micro": 2}, "pipeline train step"),
])
def test_a_failed_capture_raises_and_leaves_the_step_as_it_was(pool, kind, layout, kw, name):
    params, tokens, *_ = _reference(CFG)
    for err, kept, counts_kept, graph in pool.run(R.failed_capture_case, kind, CFG, layout,
                                                  params, tokens, **kw):
        assert err[0] == "GraphCaptureError"
        assert f"capturing {name} as a CUDA graph failed" in err[1]
        assert "not permitted when stream is capturing" in err[1]
        assert kept and counts_kept and graph is None


def test_the_stand_in_refuses_what_a_graph_cannot_hold():
    import torch

    with pytest.raises(RuntimeError, match="cannot hold"), R.HostTraffic():
        torch.tensor(True)
    with pytest.raises(RuntimeError, match="cannot hold"), R.HostTraffic():
        torch.ones(3).sum().item()
    with pytest.raises(RuntimeError, match="cannot hold"), R.HostTraffic():
        x = torch.ones(3)
        x[x > 0]
    with R.HostTraffic():
        torch.full((), True, dtype=torch.bool)


def test_gloo_steps_stay_eager(pool):
    for holders, nccl in pool.run(R.gloo_holders, CFG, (0, {"data": 2, "model": 2}),
                                  (0, {"pipe": 2, "model": 2})):
        assert holders == [(None, 0), (None, 0)] and nccl is False
