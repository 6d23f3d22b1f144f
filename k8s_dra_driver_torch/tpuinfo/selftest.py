"""The card's runtime self-test (``k8s_dra_driver_tpu/tpuinfo/selftest.py``,
ported: the port imports nothing of the JAX package).

    python -m k8s_dra_driver_torch.tpuinfo.selftest [--json] [--size N]
        [--timeout S] [--device cpu]

Enumeration sees a card that is present; this runs it.  On each visible
CUDA device (or the CPU under ``--device cpu``) a deterministic probe: an
identity matmul in bf16, exact, so any wrong lane or accumulation breaks
the equality with no tolerance, and the closed-form sum of an f32 iota;
with the latency of its second run, timed after a synchronise.  The
report has the reference's keys: ``ok``, ``platform`` (JAX's name for
the backend: "gpu" on the card, "cpu"), ``devices`` (each ``id``,
``platform``, ``ok``, ``latency_ms`` or ``error``) and, when the backend
could not start, ``error``; ``main`` exits 2 when it is not ``ok``.

The probe runs in a SUBPROCESS behind a timeout by default
(:func:`run_selftest`): a health check that hangs with a hung device
would be worse than none.  ``--timeout 0`` probes in-process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

DEFAULT_SIZE = 512
DEFAULT_TIMEOUT_S = 180.0


def _platform(device) -> str:
    return "gpu" if device.type == "cuda" else device.type


def _identity(size: int, device):
    import torch

    return torch.eye(size, dtype=torch.bfloat16, device=device)


def _probe(m) -> bool:
    """Identity times identity equals identity, exactly, and the iota's sum
    is n (n - 1) / 2; one host sync for both."""
    import torch

    mm_exact = torch.all(torch.matmul(m, m) == m)
    n = m.shape[0]
    iota_ok = torch.arange(n, dtype=torch.float32, device=m.device).sum() == n * (n - 1) / 2
    return bool(torch.logical_and(mm_exact, iota_ok))


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_selftest(device, size: int = DEFAULT_SIZE) -> dict:
    """Run the probe on one ``torch.device``."""
    result = {"id": device.index or 0, "platform": _platform(device), "ok": False}
    try:
        eye = _identity(size, device)
        _probe(eye)  # first run: the library's handles and kernels load
        _sync(device)
        start = time.perf_counter()
        ok = _probe(eye)
        result["latency_ms"] = round((time.perf_counter() - start) * 1e3, 2)
        result["ok"] = ok
        if not ok:
            result["error"] = "probe mismatch: matmul/iota returned wrong values"
    except Exception as exc:  # noqa: BLE001 - each device reports, none aborts
        result["error"] = f"{type(exc).__name__}: {exc}"
    return result


def run_inprocess(size: int = DEFAULT_SIZE, device: str = "cuda") -> dict:
    """Probe every visible CUDA device (or the CPU with ``device="cpu"``)
    in this process; a backend that cannot start is a failed report, not
    a fallback."""
    try:
        import torch

        if device == "cpu":
            devices = [torch.device("cpu")]
        else:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    except Exception as exc:  # noqa: BLE001 - backend init is a probe result
        return {"ok": False, "platform": None, "devices": [],
                "error": f"backend init failed: {type(exc).__name__}: {exc}"}
    results = [device_selftest(d, size=size) for d in devices]
    return {
        "ok": all(r["ok"] for r in results),
        "platform": _platform(devices[0]) if devices else None,
        "devices": results,
    }


class SelftestRun:
    """One in-flight probe subprocess, cancellable (a claim that prepares
    wants the card to itself)."""

    def __init__(self, proc: subprocess.Popen, timeout_s: float):
        self._proc = proc
        self._timeout_s = timeout_s
        self.cancelled = False

    def alive(self) -> bool:
        return self._proc.poll() is None

    def cancel(self) -> None:
        """Kill the probe (idempotent); its result() becomes cancelled."""
        self.cancelled = True
        if self._proc.poll() is None:
            self._proc.kill()

    def result(self) -> dict:
        """Block up to the timeout and parse the report; a probe past it
        is killed and reported as timed out."""
        try:
            stdout, stderr = self._proc.communicate(timeout=self._timeout_s)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.communicate()
            return {"ok": False, "platform": None, "devices": [],
                    "error": f"selftest timed out after {self._timeout_s:.0f}s "
                             "(hung device link?)"}
        if self.cancelled:
            return {"ok": False, "platform": None, "devices": [],
                    "cancelled": True, "error": "selftest cancelled"}
        for line in reversed(stdout.splitlines()):
            line = line.strip()
            if line.startswith("{"):
                try:
                    return json.loads(line)
                except json.JSONDecodeError:
                    break
        return {"ok": False, "platform": None, "devices": [],
                "error": f"selftest rc={self._proc.returncode}, no JSON "
                         f"(stderr tail: {stderr[-500:]!r})"}


def start_selftest(timeout_s: float = DEFAULT_TIMEOUT_S, size: int = DEFAULT_SIZE,
                   device: str = "cuda") -> SelftestRun:
    """Launch the probe subprocess (``--timeout 0``: the child probes
    in-process, this layer is the watchdog) in this environment, the
    repository root on its path and ``CUDA_DEVICE_ORDER=PCI_BUS_ID``: its
    devices in PCI bus order, the enumerator's card order, so report entry
    ``i`` is published card ``i``."""
    cmd = [sys.executable, "-m", "k8s_dra_driver_torch.tpuinfo.selftest",
           "--json", "--size", str(size), "--timeout", "0"]
    if device != "cuda":
        cmd += ["--device", device]
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (repo_root, env.get("PYTHONPATH", "")) if p)
    env["CUDA_DEVICE_ORDER"] = "PCI_BUS_ID"
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)
    return SelftestRun(proc, timeout_s)


def run_selftest(timeout_s: float = DEFAULT_TIMEOUT_S, size: int = DEFAULT_SIZE,
                 device: str = "cuda") -> dict:
    """:func:`start_selftest` and its result in one call."""
    return start_selftest(timeout_s=timeout_s, size=size, device=device).result()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="CUDA runtime self-test")
    ap.add_argument("--json", action="store_true", help="one JSON line to stdout")
    ap.add_argument("--size", type=int, default=DEFAULT_SIZE)
    ap.add_argument(
        "--timeout", type=float, default=DEFAULT_TIMEOUT_S,
        help="the probe subprocess's timeout (0 = probe in this process)",
    )
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default) or the CPU")
    args = ap.parse_args(argv)
    if args.timeout > 0:
        report = run_selftest(timeout_s=args.timeout, size=args.size, device=args.device)
    else:
        report = run_inprocess(size=args.size, device=args.device)
    if args.json:
        print(json.dumps(report))
    else:
        print(f"platform: {report.get('platform')}")
        for dev in report["devices"]:
            status = "OK" if dev["ok"] else f"FAIL ({dev.get('error', '?')})"
            lat = f" {dev['latency_ms']}ms" if "latency_ms" in dev else ""
            print(f"  device {dev['id']}: {status}{lat}")
        if report.get("error"):
            print(f"error: {report['error']}")
    # 2: the probe says unhealthy (argparse failures exit otherwise)
    return 0 if report["ok"] else 2


if __name__ == "__main__":
    sys.exit(main())
