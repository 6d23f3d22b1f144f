"""The card's self-test in the PyTorch port
(``k8s_dra_driver_torch/tpuinfo/selftest.py``) on the CPU
(``--device cpu``), as ``tests/test_selftest.py``'s ``TestProbe`` holds
the reference's: the probe passes in process and in its subprocess, a hung
child is a timeout result, the command's human and JSON outputs; the
report's keys are the reference's ``run_inprocess``'s; a corrupted probe
reports "probe mismatch"; without a card and without ``--device cpu`` the
report is not ``ok`` and the command exits 2."""

import json

import torch

from k8s_dra_driver_torch.tpuinfo import selftest
from k8s_dra_driver_tpu.tpuinfo import selftest as jselftest


def test_inprocess_passes_on_cpu():
    report = selftest.run_inprocess(size=32, device="cpu")
    assert report["ok"] is True and report["platform"] == "cpu"
    assert report["devices"]
    for dev in report["devices"]:
        assert dev["ok"] is True and dev["platform"] == "cpu"
        assert dev["latency_ms"] >= 0


def test_report_keys_equal_the_reference():
    """The port's CPU report and the reference's (JAX on the CPU, as many
    devices as the suite's XLA flags give it; the port probes the one
    CPU): the same keys at the top and for every device, and device 0 the
    same but for its latency."""
    mine, theirs = selftest.run_inprocess(size=32, device="cpu"), jselftest.run_inprocess(size=32)
    assert set(mine) == set(theirs) == {"ok", "platform", "devices"}
    keys = {"id", "platform", "ok", "latency_ms"}
    assert all(set(d) == keys for d in mine["devices"] + theirs["devices"])
    assert len(mine["devices"]) == 1

    def but_latency(d):
        return {k: v for k, v in d.items() if k != "latency_ms"}

    assert but_latency(mine["devices"][0]) == but_latency(theirs["devices"][0])
    assert (mine["ok"], mine["platform"]) == (theirs["ok"], theirs["platform"])


def test_subprocess_roundtrip():
    report = selftest.run_selftest(timeout_s=120, size=32, device="cpu")
    assert report["ok"] is True and report["platform"] == "cpu"
    assert report["devices"]


def test_timeout_is_a_result_not_a_hang():
    report = selftest.run_selftest(timeout_s=0.01, size=32, device="cpu")
    assert report["ok"] is False
    assert "timed out" in report["error"]


def test_cli_human_output(capsys):
    rc = selftest.main(["--size", "32", "--device", "cpu"])
    assert rc == 0
    assert "device 0: OK" in capsys.readouterr().out


def test_cli_json_single_line(capsys):
    rc = selftest.main(["--size", "32", "--json", "--device", "cpu", "--timeout", "0"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip())
    assert report["ok"] is True


def test_a_corrupted_probe_reports_a_mismatch(monkeypatch, capsys):
    """An "identity" with a 2 on its diagonal squares to 4: the exact
    comparison catches it; the report says so and the command exits 2."""
    monkeypatch.setattr(selftest, "_identity",
                        lambda size, device: 2 * torch.eye(size, dtype=torch.bfloat16,
                                                           device=device))
    report = selftest.run_inprocess(size=32, device="cpu")
    assert report["ok"] is False
    assert "probe mismatch" in report["devices"][0]["error"]
    assert selftest.main(["--size", "32", "--json", "--device", "cpu", "--timeout", "0"]) == 2
    assert "probe mismatch" in capsys.readouterr().out


def test_without_a_card_the_report_fails(monkeypatch, capsys):
    """The default device is the card: without one the report is not ok,
    says why, and the command exits 2 (no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    report = selftest.run_inprocess(size=32)
    assert report == {"ok": False, "platform": None, "devices": [],
                      "error": "backend init failed: RuntimeError: no CUDA device is available"}
    assert selftest.main(["--size", "32", "--json", "--timeout", "0"]) == 2
    assert json.loads(capsys.readouterr().out)["ok"] is False
