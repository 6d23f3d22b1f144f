"""The port's multi-card dry run (``e2e/dryrun.py``) on four gloo ranks on
the CPU, against the JAX package's dry run at 4 devices, run once in a
subprocess with ``force_cpu_env`` as ``__graft_entry__.dryrun_multichip``
runs it (meanwhile the port's runs).

The two print the same lines in the same order once each loss is masked
(the weights differ: each package draws its own from its seed), so the
same legs ran on the same meshes and served the same token counts, every
sharded engine bit-equal to its single-card twin; every loss is finite.
At 4 the multislice training leg (N >= 8) is skipped by both.  A leg made
to fail stops the run with its name and a nonzero exit.
"""

import math
import os
import pathlib
import re
import subprocess
import sys

import pytest

from k8s_dra_driver_torch.e2e import dryrun
from k8s_dra_driver_torch.parallel.ranks import RankPool
from tests import torch_pod_ranks as R

REPO = pathlib.Path(__file__).resolve().parents[1]
LOSS = re.compile(r"loss=(\S+)")


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, backend="gloo", device_type="cpu", timeout_s=120)
    yield p
    p.close()


@pytest.fixture(scope="module")
def runs(pool):
    """(the JAX dry run's stdout lines, the port's report), the JAX one in
    a subprocess while the port's runs."""
    from k8s_dra_driver_tpu.e2e.dryrun import force_cpu_env

    env = dict(os.environ)
    force_cpu_env(env, 4)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    proc = subprocess.Popen([sys.executable, "-m", "k8s_dra_driver_tpu.e2e.dryrun", "4"],
                            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        report = dryrun.run_dryrun(4, "cpu", pool=pool)
        out, err = proc.communicate(timeout=540)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-2000:]
    return out.splitlines(), report


def _masked(lines):
    return [LOSS.sub("loss=<masked>", line) for line in lines]


def test_the_reference_lines_in_order(runs):
    jax_lines, report = runs
    assert _masked(report["lines"]) == _masked(jax_lines)
    assert len(report["lines"]) == 12


def test_every_loss_is_finite_and_the_token_counts_agree(runs):
    jax_lines, report = runs
    for lines in (jax_lines, report["lines"]):
        losses = [float(m.group(1)) for line in lines for m in LOSS.finditer(line)]
        assert len(losses) == 6 and all(math.isfinite(x) for x in losses)
    tokens = re.compile(r"(\d+) tokens")
    assert ([tokens.findall(line) for line in report["lines"]]
            == [tokens.findall(line) for line in jax_lines])


def test_the_multislice_training_leg_needs_8(runs):
    jax_lines, report = runs
    for lines in (jax_lines, report["lines"]):
        assert not any("multislice hybrid-dp" in line for line in lines)
    assert report["launches"]["multislice train"] == {}


def test_a_failing_leg_names_itself_and_exits_nonzero(pool, capsys):
    assert pool.run(R.drop_a_token) == [True] * 4
    rc = dryrun.main(["dryrun", "4", "--device", "cpu"], pool=pool)
    err = capsys.readouterr().err
    assert rc == 1
    assert "dryrun_multichip: leg 'sharded paged serving' FAILED" in err
    assert "sharded paged streams diverged" in err


def test_the_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_dryrun(4)
