"""Request telemetry in the PyTorch port (``models/telemetry.py``,
``utils/{metrics,journal,tracing}.py`` and the engines' calls into them)
against the JAX package's, on the CPU, with the same weights
(``weights.params_from_jax``) and seeded traffic.

Everything is held exactly: ``stats()`` field for field (the host-clock
times aside), each request's ``trace()`` key for key under one
step-per-read fake clock installed on both engines' telemetry (so the
port reads its clock at the reference's points, in the reference's
order), the ``tpu_serve_*`` samples of each package's registry (the
two host-clock families, step seconds and tokens per second, by sample
count only), and streams and ``host_syncs`` of a telemetry-off twin."""

import json
import time

import jax
import numpy as np
import pytest
import torch

from k8s_dra_driver_torch.models import burnin as tb
from k8s_dra_driver_torch.models import paged as tp
from k8s_dra_driver_torch.models import serve as ts
from k8s_dra_driver_torch.models import telemetry as tt
from k8s_dra_driver_torch.models.weights import params_from_jax
from k8s_dra_driver_torch.utils import faults as tf
from k8s_dra_driver_torch.utils import journal as tj
from k8s_dra_driver_torch.utils import metrics as tm
from k8s_dra_driver_torch.utils import tracing as ttr
from k8s_dra_driver_tpu.models import burnin as jb
from k8s_dra_driver_tpu.models import paged as jp
from k8s_dra_driver_tpu.models import serve as js
from k8s_dra_driver_tpu.models import telemetry as jt
from k8s_dra_driver_tpu.utils import faults as jf
from k8s_dra_driver_tpu.utils import metrics as jm

JCFG = jb.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq=64)
TCFG = tb.ModelConfig.from_reference(JCFG)
DENSE = dict(n_slots=3, prompt_bucket=16)
PAGED = dict(n_slots=3, n_blocks=33, block_size=4, prompt_bucket=16)
# EngineStats fields that read the host's own clock
TIMES = {"engine_seq", "last_step_s", "uptime_s", "heartbeat_age_s"}
# tpu_serve_* families whose values are host-clock times, not telemetry-clock ones
HOST_TIMED = ("tpu_serve_step_seconds", "tpu_serve_tokens_per_second")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _reset_port_observability():
    """The port's registry, journal and span buffer fresh per test, as the
    suite's conftest resets the JAX package's."""
    tm.REGISTRY.reset()
    tj.JOURNAL.clear()
    ttr.TRACES.clear()
    yield


@pytest.fixture(scope="module")
def weights():
    params = jb.init_params(jax.random.PRNGKey(0), JCFG)
    return params, params_from_jax(params, device="cpu")


class StepClock:
    """A fake monotonic clock that advances one second per read."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


def _pair(weights, kind, *, fault=None, **kw):
    """A JAX engine and a port engine of ``kind`` with the same settings,
    each with its own step-per-read clock from the same start."""
    jparams, tparams = weights
    jinj = tinj = None
    if fault is not None:
        jinj, tinj = (pkg.FaultInjector(0) for pkg in (jf, tf))
        jinj.arm(jf.FaultProfile(name="chaos", **fault))
        tinj.arm(tf.FaultProfile(name="chaos", **fault))
    if kind == "dense":
        kw = dict(DENSE, **kw)
        je = js.ServeEngine(params=jparams, cfg=JCFG, fault_injector=jinj, **kw)
        te = ts.ServeEngine(params=tparams, cfg=TCFG, fault_injector=tinj, device="cpu", **kw)
    else:
        kw = dict(PAGED, **kw)
        je = jp.PagedServeEngine(params=jparams, cfg=JCFG, attn_impl="xla", fault_injector=jinj,
                                 **kw)
        te = tp.PagedServeEngine(params=tparams, cfg=TCFG, fault_injector=tinj, device="cpu",
                                 **kw)
    je.telemetry.clock, te.telemetry.clock = StepClock(), StepClock()
    return je, te


def _traffic(n=7, seed=3, plen=(2, 15), budget=(3, 12), **extra):
    r = np.random.RandomState(seed)
    return [dict(prompt=r.randint(0, 64, size=int(r.randint(*plen))).tolist(),
                 max_tokens=int(r.randint(*budget)), **extra) for _ in range(n)]


def _streams(comps):
    return sorted((c.request_id, c.generated, c.status) for c in comps)


def _counters(eng) -> dict:
    doc = eng.stats().to_json()
    return {k: v for k, v in doc.items() if k not in TIMES}


def _serve_samples(registry, parse) -> dict:
    """``{sample name: {labels: value}}`` of the ``tpu_serve_*`` families,
    the host-clock families reduced to their sample counts."""
    out = {}
    for name, samples in parse(registry.render()).items():
        if not name.startswith("tpu_serve_"):
            continue
        if name.startswith(HOST_TIMED) and not name.endswith("_count"):
            samples = len(samples)
        out[name] = samples
    return out


CASES = {
    "dense greedy": dict(kind="dense", sync_interval=3),
    "dense step": dict(kind="dense", sync_interval=1, deadline=4),
    "dense spec": dict(kind="dense", spec_gamma=2),
    "paged greedy": dict(kind="paged", sync_interval=3),
    "paged spec": dict(kind="paged", spec_gamma=2),
    "paged chunked": dict(kind="paged", sync_interval=2, prefill_chunk_blocks=1,
                          prefix_cache_blocks=4),
    "paged tight": dict(kind="paged", sync_interval=2, n_blocks=11),
    "paged faults": dict(kind="paged", sync_interval=1, queue_limit=2,
                         fault=dict(nan_logits_rate=1.0, slots=(1,), steps=(3,))),
}


def _run_case(weights, case):
    kw = dict(CASES[case])
    kind = kw.pop("kind")
    deadline = kw.pop("deadline", None)
    queue_limit = kw.pop("queue_limit", None)
    reqs = _traffic(plen=(5, 15)) if "prefill_chunk_blocks" in kw else _traffic()
    if deadline is not None:
        reqs = [dict(r, deadline=deadline) if i % 2 else r for i, r in enumerate(reqs)]
    je, te = _pair(weights, kind, **kw)
    out = []
    for eng in (je, te):
        comps = eng.pump(reqs, queue_limit=queue_limit)
        out.append((eng, comps))
    return je, te, out


@pytest.mark.parametrize("case", sorted(CASES))
def test_stats_traces_and_metrics_equal_the_jax_engine(weights, case):
    """On the same traffic: the completions, ``stats()`` field for field
    (times aside), every request's trace key for key under the fake clock,
    and the ``tpu_serve_*`` samples of the two registries."""
    je, te, ((_, jcomps), (_, tcomps)) = _run_case(weights, case)
    assert _streams(tcomps) == _streams(jcomps)
    assert [f for f in tt.EngineStats.__dataclass_fields__] == [
        f for f in jt.EngineStats.__dataclass_fields__]
    assert type(te.stats()) is tt.EngineStats
    assert _counters(te) == _counters(je)
    ids = sorted({c.request_id for c in jcomps if c.request_id >= 0})
    assert ids and all(te.telemetry.trace(r) == je.telemetry.trace(r) for r in ids)
    assert sum(te.stats().statuses.values()) == len(tcomps)  # sheds never complete
    assert _serve_samples(tm.REGISTRY, tm.parse_prom_text) == _serve_samples(
        jm.REGISTRY, jm.parse_prom_text)
    tail = tj.JOURNAL.tail(limit=2048, component="serve")
    assert {e["correlation"] for e in tail if "correlation" in e} >= {f"req-{r}" for r in ids}


def test_case_coverage(weights):
    """The cases above reach every telemetry call site: admission chunks,
    preemption and re-admission events, a shed, a deadline and a
    quarantine (counted once, on the port's engines)."""
    seen = {}
    for case in ("paged chunked", "paged tight", "paged faults", "dense step"):
        _, te, ((_, _), (_, comps)) = _run_case(weights, case)
        events = [e["event"] for c in comps if c.request_id >= 0
                  for e in te.telemetry.trace(c.request_id)["events"]]
        seen[case] = (sorted(set(events)), te.stats().statuses)
    assert "admission_chunk" in seen["paged chunked"][0]
    assert {"preempt", "readmit"} <= set(seen["paged tight"][0])
    assert {"shed", "quarantined"} <= set(seen["paged faults"][1])
    assert "deadline_exceeded" in seen["dense step"][1]


@pytest.mark.parametrize("kind,kw", [("dense", dict(sync_interval=3)),
                                     ("paged", dict(sync_interval=3, spec_gamma=2))])
def test_telemetry_off_twin_keeps_streams_and_host_syncs(weights, kind, kw):
    """Telemetry on and off: the same streams, ``host_syncs`` and bursts'
    worth of device work; the off engine keeps no trace and its clock is
    never read."""
    _, tparams = weights
    make = ts.ServeEngine if kind == "dense" else tp.PagedServeEngine
    base = dict(DENSE if kind == "dense" else PAGED, **kw)
    on = make(params=tparams, cfg=TCFG, device="cpu", **base)
    off = make(params=tparams, cfg=TCFG, device="cpu", telemetry_enabled=False, **base)

    def refuse():
        raise AssertionError("a disabled telemetry read its clock")

    off.telemetry.clock = refuse
    reqs = _traffic(6, seed=11)
    assert _streams(on.pump(reqs)) == _streams(off.pump(reqs))
    assert on.host_syncs == off.host_syncs > 0
    off.telemetry.clock = time.monotonic  # stats() reads the uptime, on or off
    assert off.telemetry.trace(0) is None and on.telemetry.trace(0)["status"] == "ok"
    assert off.stats().completed == 0 and on.stats().completed == len(reqs)


@pytest.mark.parametrize("src_pkg", ["jax", "port"])
@pytest.mark.parametrize("src_kind,dst_kind", [("paged", "dense"), ("dense", "paged")])
def test_snapshot_trace_survives_a_restore_across_packages(weights, src_pkg, src_kind,
                                                           dst_kind):
    """A snapshot taken mid-stream from an engine of either package
    carries each request's trace through JSON; restored into a JAX engine
    and a port engine (fresh equal fake clocks), the rebuilt timelines are
    equal key for key, keep the original anchors, count one migration and
    run to "ok"."""
    reqs = _traffic(3, seed=5, budget=(6, 12))
    jsrc, tsrc = _pair(weights, src_kind, sync_interval=2)
    src = jsrc if src_pkg == "jax" else tsrc
    for r in reqs:
        src.submit(**r)
    src.step_burst()
    text = json.dumps(src.snapshot_active())
    snap = json.loads(text)
    assert all("trace" in e for e in snap["requests"])
    jdst, tdst = _pair(weights, dst_kind, sync_interval=2)
    assert sorted(jdst.restore(json.loads(text))) == sorted(tdst.restore(json.loads(text)))
    jdst.run_until_drained()
    tdst.run_until_drained()
    assert _streams(tdst.completions()) == _streams(jdst.completions())
    for e in snap["requests"]:
        rid = e["request_id"]
        tr = tdst.telemetry.trace(rid)
        assert tr == jdst.telemetry.trace(rid)
        assert tr["migrations"] == 1 and tr["status"] == "ok"
        assert tr["queued_at"] == e["trace"]["queued_at"]
        assert tr["engines"] == [type(src).__name__, type(tdst).__name__]
        names = [x["event"] for x in tr["events"]]
        assert names[names.index("migrate_in"):][:2] == ["migrate_in", "restore"]


def test_release_drops_traces_and_journals_each_request(weights):
    """``release_active`` forgets the released requests' traces (no status
    is tallied) and journals each one, as the reference does."""
    je, te = _pair(weights, "paged", sync_interval=2, prefill_chunk_blocks=1)
    for eng in (je, te):
        for r in _traffic(3, seed=9, plen=(5, 15)):
            eng.submit(**r)
        eng.step_burst()
        assert eng.release_active() == 3
    assert _counters(te) == _counters(je)
    assert te.stats().in_flight == 0 and te.stats().completed == 0
    released = [e for e in tj.JOURNAL.tail(component="serve") if e["event"] == "request.released"]
    assert len(released) == 3


# -- the reference's fake-clock cases on the port's module -------------------------

class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


class _HostA:
    """A weakref-able engine stand-in."""

    n_slots = 4
    sync_interval = 8
    host_syncs = 0

    def free_slots(self):
        return 4


class _HostB(_HostA):
    pass


def _scrape():
    return tm.parse_prom_text(tm.REGISTRY.render())


def _status_key(status):
    return (("status", status),)


def _ok_timeline_derives_every_slo():
    clk = FakeClock(100.0)
    tel = tt.EngineTelemetry(_HostA(), clock=clk)
    clk.t = 100.5
    tel.on_admit(7, prompt_len=3, max_tokens=9, submitted_at=tel.now(), queued_at=100.0)
    clk.t = 101.0
    tel.burst_begin(4, step_no=1)
    tel.on_commit(7, 4)
    clk.t = 101.8
    tel.burst_end(occupancy=2)
    clk.t = 102.5
    tel.on_retire(7, "ok", 5)
    tr = tel.trace(7)
    assert tr["status"] == "ok" and tr["generated"] == 5
    assert tr["queue_wait_s"] == pytest.approx(0.5)
    assert tr["ttft_s"] == pytest.approx(0.5)
    assert tr["e2e_s"] == pytest.approx(2.5)
    assert tr["tpot_s"] == pytest.approx(0.5)
    (burst,) = tr["bursts"]
    assert burst["tokens"] == 4 and burst["t0"] == 101.0 and burst["t1"] == 101.8
    doc = _scrape()
    ok = _status_key("ok")
    assert doc["tpu_serve_ttft_seconds_count"][ok] == 1
    assert doc["tpu_serve_ttft_seconds_sum"][ok] == pytest.approx(0.5)
    assert doc["tpu_serve_queue_wait_seconds_sum"][ok] == pytest.approx(0.5)
    assert doc["tpu_serve_e2e_seconds_sum"][ok] == pytest.approx(2.5)
    assert doc["tpu_serve_tpot_seconds_sum"][ok] == pytest.approx(0.5)
    assert doc["tpu_serve_burst_committed_tokens_count"][()] == 1
    assert doc["tpu_serve_batch_occupancy"][()] == 2


def _direct_submit_has_zero_queue_wait():
    clk = FakeClock(5.0)
    tel = tt.EngineTelemetry(_HostA(), clock=clk)
    tel.on_admit(1, prompt_len=2, max_tokens=4, submitted_at=5.0)
    clk.t = 6.0
    tel.on_retire(1, "ok", 1)
    tr = tel.trace(1)
    assert tr["queued_at"] == tr["submitted_at"] == 5.0
    assert tr["queue_wait_s"] == 0.0


def _chunked_admission_stamps_ttft_at_final_chunk():
    clk = FakeClock(10.0)
    tel = tt.EngineTelemetry(_HostA(), clock=clk)
    tel.on_admit(1, prompt_len=32, max_tokens=4, submitted_at=10.0, queued_at=9.0,
                 activated=False)
    clk.t = 10.2
    tel.on_admission_chunk(1)
    clk.t = 10.4
    tel.on_admission_chunk(1)
    clk.t = 10.6
    tel.on_activate(1)
    tr = tel.trace(1)
    assert tr["admission_chunks"] == 2
    assert tr["admitted_at"] == tr["first_token_at"] == 10.6
    assert tr["ttft_s"] == pytest.approx(1.6)
    assert tr["generated"] == 1


def _single_token_request_has_no_tpot():
    clk = FakeClock(0.0)
    tel = tt.EngineTelemetry(_HostA(), clock=clk)
    tel.on_admit(1, prompt_len=2, max_tokens=1, submitted_at=0.0)
    clk.t = 1.0
    tel.on_retire(1, "ok", 1)
    assert tel.trace(1)["tpot_s"] is None
    assert "tpu_serve_tpot_seconds_count" not in _scrape()


def _shed_observes_queue_wait_under_shed_status():
    clk = FakeClock(50.0)
    tel = tt.EngineTelemetry(_HostA(), clock=clk)
    clk.t = 51.5
    tel.on_shed(queued_at=50.0)
    doc = _scrape()
    assert doc["tpu_serve_queue_wait_seconds_sum"][_status_key("shed")] == pytest.approx(1.5)
    assert tel.stats().statuses == {"shed": 1}


def _mid_burst_retiree_flushes_before_status():
    clk = FakeClock(0.0)
    tel = tt.EngineTelemetry(_HostA(), clock=clk)
    tel.on_admit(3, prompt_len=2, max_tokens=8, submitted_at=0.0)
    clk.t = 1.0
    tel.burst_begin(8)
    tel.on_commit(3, 2)
    clk.t = 1.5
    tel.on_retire(3, "deadline_exceeded", 3)
    tr = tel.trace(3)
    assert tr["status"] == "deadline_exceeded" and tr["generated"] == 3
    assert len(tr["bursts"]) == 1 and tr["bursts"][0]["tokens"] == 2
    clk.t = 2.0
    tel.burst_end(occupancy=0)
    tr = tel.trace(3)
    assert tr["generated"] == 3 and len(tr["bursts"]) == 1


def _disabled_telemetry_is_inert():
    tel = tt.EngineTelemetry(_HostA(), enabled=False, clock=FakeClock())
    assert tel.now() is None
    tel.on_admit(1, prompt_len=2, max_tokens=4)
    tel.burst_begin(4)
    tel.on_commit(1, 4)
    tel.burst_end(1)
    tel.on_retire(1, "ok", 5)
    assert tel.trace(1) is None
    assert "tpu_serve_ttft_seconds_count" not in _scrape()


def _migration_merges_one_contiguous_timeline():
    clk = FakeClock(5.0)
    tel_a = tt.EngineTelemetry(_HostA(), clock=clk)
    tel_a.on_admit(2, prompt_len=2, max_tokens=8, submitted_at=5.0, queued_at=4.0)
    clk.t = 6.0
    tel_a.burst_begin(4)
    tel_a.on_commit(2, 4)
    clk.t = 6.5
    tel_a.burst_end(1)
    doc = json.loads(json.dumps(tel_a.export_trace(2)))
    tel_b = tt.EngineTelemetry(_HostB(), clock=clk)
    clk.t = 7.0
    tel_b.import_trace(2, doc)
    tel_b.on_restore(2, resumed_at=7)
    clk.t = 8.0
    tel_b.on_retire(2, "ok", 0)
    tr = tel_b.trace(2)
    assert tr["migrations"] == 1
    assert tr["engines"] == ["_HostA", "_HostB"]
    assert tr["queued_at"] == 4.0 and tr["submitted_at"] == 5.0
    assert tr["ttft_s"] == pytest.approx(1.0)
    assert tr["e2e_s"] == pytest.approx(4.0)
    assert tr["generated"] == 5
    names = [e["event"] for e in tr["events"]]
    assert "migrate_in" in names and "restore" in names


@pytest.mark.parametrize("case", [
    _ok_timeline_derives_every_slo, _direct_submit_has_zero_queue_wait,
    _chunked_admission_stamps_ttft_at_final_chunk, _single_token_request_has_no_tpot,
    _shed_observes_queue_wait_under_shed_status, _mid_burst_retiree_flushes_before_status,
    _disabled_telemetry_is_inert, _migration_merges_one_contiguous_timeline,
], ids=lambda f: f.__name__.strip("_"))
def test_fake_clock_slo_math(case):
    """The reference's ``TestFakeClockSloMath`` cases
    (``tests/test_serve_telemetry.py``) on the port's telemetry and
    registry."""
    case()


def test_metric_families_are_the_reference_ones():
    """Every ``tpu_serve_*`` family the port registers exists in the JAX
    package's registry with the same help string, type and buckets."""
    port = {n: m for n, m in tm.REGISTRY._metrics.items() if n.startswith("tpu_serve_")}
    ref = jm.REGISTRY._metrics
    assert len(port) == 22
    for name, m in port.items():
        assert type(m).__name__ == type(ref[name]).__name__ and m.help == ref[name].help
        assert getattr(m, "buckets", None) == getattr(ref[name], "buckets", None)
