"""The port's driver-facing entry points (``__graft_entry__.py``): the
flagship forward with its example args, and the multi-card dry run in a
subprocess behind a watchdog.

``entry(device)`` returns ``(fn, (params, tokens))``: ``FLAGSHIP_MODERN``'s
forward (GQA, RoPE) on weights from seed 0 and a batch of 8 x ``max_seq``
tokens from seed 1.  ``dryrun_multichip(n, device)`` runs ``python -m
k8s_dra_driver_torch.e2e.dryrun n`` in a child process.

``python -m k8s_dra_driver_torch.entry [--device cpu]`` runs what the
reference's ``__main__`` runs, one line each: the modern forward as one
CUDA graph (``GraphedProgram("forward", ...)``, the counterpart of
``jax.jit(fn)``), held bit for bit against an eager call; the classic
``FLAGSHIP`` forward (MHA, learned positions) on seeds 2 and 3; then the
dry run at 8.  The forward's attention is the plain ``_full_attention``,
as the reference's is XLA: this path launches no kernel of its own.

Device rule: the card unless the caller asks for the CPU; without a card
every entry point raises unless given ``device="cpu"`` (``--device cpu``),
and the dry run's child then gets ``--device cpu`` too.  The CPU captures
no graph, so there the forward runs eagerly.
"""

from __future__ import annotations

import argparse
import functools
import os
import pathlib
import signal
import subprocess
import sys

import torch

from k8s_dra_driver_torch.device import resolve_device
from k8s_dra_driver_torch.models import burnin
from k8s_dra_driver_torch.models.graphs import GraphedProgram

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]

DRYRUN_TIMEOUT_S = float(os.environ.get("GRAFT_DRYRUN_TIMEOUT_S", "540"))
BATCH = 8  # the example batch's rows, each max_seq tokens


def _example(cfg, device, seeds: tuple[int, int]):
    """``cfg``'s forward with params from ``seeds[0]`` and ``BATCH`` rows
    of ``max_seq`` tokens from ``seeds[1]``, each from a generator on the
    device."""
    dev = resolve_device(device)
    params = burnin.init_params(torch.Generator(device=dev).manual_seed(seeds[0]), cfg)
    tokens = burnin.sample_tokens(torch.Generator(device=dev).manual_seed(seeds[1]), cfg,
                                  batch=BATCH, seq=cfg.max_seq)
    return functools.partial(burnin.forward, cfg=cfg), (params, tokens)


def entry(device="cuda"):
    """``(fn, (params, tokens))``: the forward step of the flagship model in
    its modern config (``FLAGSHIP_MODERN``), params from seed 0, tokens
    ``[8, 1024]`` int32 from seed 1."""
    return _example(burnin.FLAGSHIP_MODERN, device, (0, 1))


def classic(device="cuda"):
    """The classic ``FLAGSHIP`` (MHA, learned positions) as :func:`entry`
    gives the modern one: params from seed 2, tokens from seed 3."""
    return _example(burnin.FLAGSHIP, device, (2, 3))


def compiled_forward(fn, params, tokens, device) -> GraphedProgram:
    """``fn(params, tokens)`` without gradients as a ``GraphedProgram``
    named "forward": call 1 runs eagerly, call 2 captures and replays,
    later calls replay (on the card; the CPU captures nothing, so call it
    once there).  The output lives in the graph's pool."""

    def run():
        with torch.no_grad():
            return fn(params, tokens)

    return GraphedProgram("forward", run, resolve_device(device))


def _dryrun_command(n_devices: int, device: torch.device) -> list:
    cmd = [sys.executable, "-m", "k8s_dra_driver_torch.e2e.dryrun", str(n_devices)]
    return cmd + ["--device", "cpu"] if device.type == "cpu" else cmd


def dryrun_multichip(n_devices: int, device="cuda") -> subprocess.CompletedProcess:
    """Run ``k8s_dra_driver_torch.e2e.dryrun`` over ``n_devices`` ranks in a
    child process on ``device`` (default the card; raises without one
    unless ``device="cpu"``), behind a watchdog of ``DRYRUN_TIMEOUT_S``
    seconds (``GRAFT_DRYRUN_TIMEOUT_S``, default 540): a hang becomes an
    error naming it, and the child's whole process group (its ranks) is
    killed.  Prints the child's standard output; a nonzero exit raises
    with the tail of its standard error.  Returns the finished process
    (its standard error carries the launches by leg)."""
    dev = resolve_device(device)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_REPO_ROOT), env.get("PYTHONPATH", "")) if p
    )
    cmd = _dryrun_command(n_devices, dev)
    proc = subprocess.Popen(cmd, cwd=_REPO_ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        os.killpg(proc.pid, signal.SIGKILL)
        _, err = proc.communicate()
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) timed out after {DRYRUN_TIMEOUT_S:.0f}s "
            f"(the child should never hang; stderr tail: {err[-2000:]!r})"
        ) from exc
    if out:
        print(out, end="", flush=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) exited rc={proc.returncode}; "
            f"stderr tail: {err[-2000:]!r}"
        )
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def main(argv: list[str] | None = None) -> int:
    """The reference's ``__main__``: the modern forward (graph == eager on
    the card), the classic forward, the dry run at 8; returns 1 when the
    graph's logits are not the eager call's."""
    parser = argparse.ArgumentParser(prog="python -m k8s_dra_driver_torch.entry")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    dev = resolve_device(parser.parse_args(argv).device)
    fn, (params, tokens) = entry(dev)
    program = compiled_forward(fn, params, tokens, dev)
    out = program()
    if dev.type == "cuda":
        eager, out = out, program()
        torch.cuda.synchronize(dev)
        if not torch.equal(out, eager):
            print(f"entry forward FAILED: the graph's logits are not the eager call's "
                  f"(largest difference {(out - eager).abs().max().item()})", flush=True)
            return 1
        del eager
        how = "one CUDA graph, bit for bit the eager call's"
    else:
        how = "eager: the CPU captures no graph"
    print(f"entry forward ok: logits {tuple(out.shape)} {out.dtype} ({how})", flush=True)
    del program, out, params, tokens
    cfn, (cparams, ctokens) = classic(dev)
    with torch.no_grad():
        cout = cfn(cparams, ctokens)
    print(f"classic flagship forward ok: logits {tuple(cout.shape)}", flush=True)
    del cout, cparams, ctokens
    dryrun_multichip(8, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
