"""The port's workload generator and simulator
(``k8s_dra_driver_torch/models/workload.py``) against the reference's
(``k8s_dra_driver_tpu/models/workload.py``), on the CPU.  Nothing here
touches a tensor: both packages get the same seeded specs and the results
must be equal.

* ``generate`` and ``generate_shared_prefix`` give the same arrivals field
  for field (diurnal, flash crowds, custom SLO tiers, Zipf shared prefixes).
* ``prompt_tokens``, ``shared_prefix_tokens`` and ``sim_prefix_chain`` agree
  at vocab 64 and 32768.
* ``SimEngine`` pumps, snapshots, restores and hands off to the same
  completions, counters and stats.
* ``replay`` over each package's ``FleetRouter`` and ``DisaggRouter`` of its
  own ``SimEngine``s gives the same ``to_json()`` except ``wall_s``, also with
  a ``SloBurnRateMonitor`` fed and with ``tokens_fn``/``submit_extra``
  threading a prefix chain into engines that publish to a
  ``FleetPrefixIndex``.
"""

import dataclasses

import pytest

from k8s_dra_driver_torch.models import disagg as td
from k8s_dra_driver_torch.models import fleet as tfleet
from k8s_dra_driver_torch.models import fleet_prefix as tfp
from k8s_dra_driver_torch.models import obs_plane as tobs
from k8s_dra_driver_torch.models import workload as tw
from k8s_dra_driver_torch.utils import journal as tj
from k8s_dra_driver_torch.utils import metrics as tm
from k8s_dra_driver_tpu.models import disagg as jd
from k8s_dra_driver_tpu.models import fleet as jfleet
from k8s_dra_driver_tpu.models import fleet_prefix as jfp
from k8s_dra_driver_tpu.models import obs_plane as jobs
from k8s_dra_driver_tpu.models import workload as jw
from k8s_dra_driver_tpu.utils import journal as jj
from k8s_dra_driver_tpu.utils import metrics as jm

PKG = {
    "reference": dict(w=jw, fleet=jfleet, disagg=jd, fp=jfp, obs=jobs, journal=jj.JOURNAL,
                      registry=jm.REGISTRY),
    "port": dict(w=tw, fleet=tfleet, disagg=td, fp=tfp, obs=tobs, journal=tj.JOURNAL,
                 registry=tm.REGISTRY),
}


@pytest.fixture(autouse=True)
def _fresh_state():
    for pkg in PKG.values():
        pkg["registry"].reset()
        pkg["journal"].clear()
    yield


def _spec(w, **kw):
    """A WorkloadSpec of package ``w``; SLO tiers and flash crowds are
    given as plain tuples and built with that package's classes."""
    if "slo_tiers" in kw:
        kw["slo_tiers"] = tuple(w.SloTier(*t) for t in kw["slo_tiers"])
    if "flash_crowds" in kw:
        kw["flash_crowds"] = tuple(w.FlashCrowd(*f) for f in kw["flash_crowds"])
    return w.WorkloadSpec(**kw)


SPECS = {
    "diurnal": dict(seed=3, duration_s=300.0, base_rate_rps=6.0),
    "flash_crowds": dict(seed=42, duration_s=120.0, base_rate_rps=12.0, diurnal_amplitude=0.3,
                         diurnal_period_s=120.0,
                         flash_crowds=((30.0, 20.0, 4.0), (70.0, 5.0, 8.0))),
    "tiers": dict(seed=7, duration_s=200.0, base_rate_rps=4.0, prompt_len_mu=4.5,
                  prompt_len_sigma=1.1, prompt_len_max=200, stream_len_min=4,
                  stream_len_alpha=1.6, stream_len_max=32,
                  slo_tiers=((0.2, 0.5, 0.05), (0.8, 2.0, 0.2))),
}
# the replays' trace: a flash crowd over a third of it, ~500 arrivals
REPLAY_SPEC = dict(seed=42, duration_s=60.0, base_rate_rps=6.0, diurnal_amplitude=0.3,
                   diurnal_period_s=60.0, flash_crowds=((20.0, 10.0, 4.0),))
SHARED = {
    "zipf": dict(base=dict(seed=11, duration_s=120.0, base_rate_rps=6.0), n_system_prompts=4,
                 system_len_tokens=128, n_users=12, turn_tokens=16, max_turns=4),
    "flat": dict(base=dict(seed=5, duration_s=90.0, base_rate_rps=8.0), n_system_prompts=8,
                 system_zipf_alpha=0.0, system_len_tokens=48, n_users=64),
}


def _shared_spec(w, name):
    kw = dict(SHARED[name])
    return w.SharedPrefixSpec(base=_spec(w, **kw.pop("base")), **kw)


def _trace(w, name):
    if name in SPECS:
        return list(w.generate(_spec(w, **SPECS[name])))
    return list(w.generate_shared_prefix(_shared_spec(w, name)))


@pytest.mark.parametrize("name", list(SPECS) + [f"shared_{n}" for n in SHARED])
def test_traces_equal_field_for_field(name):
    key = name.removeprefix("shared_")
    ref, port = _trace(jw, key), _trace(tw, key)
    assert len(ref) > 20
    assert [tuple(a) for a in port] == [tuple(a) for a in ref]
    assert type(port[0])._fields == type(ref[0])._fields
    if key in SPECS:
        for t in (0.0, 31.0, 72.5, 119.0):
            assert tw.rate_at(_spec(tw, **SPECS[key]), t) == jw.rate_at(_spec(jw, **SPECS[key]), t)
        assert tw.peak_rate(_spec(tw, **SPECS[key])) == jw.peak_rate(_spec(jw, **SPECS[key]))


@pytest.mark.parametrize("vocab", [64, 32768])
def test_prompt_materialisation_equal(vocab):
    plain, shared = _trace(jw, "tiers"), _trace(jw, "zipf")
    for a in plain:
        pa = tw.Arrival(*a)
        for limit in (24, None, 3):
            assert tw.prompt_tokens(pa, vocab, limit) == jw.prompt_tokens(a, vocab, limit)
    for a in shared:
        pa = tw.PrefixArrival(*a)
        for limit in (None, 100):
            assert tw.shared_prefix_tokens(pa, vocab, limit) == jw.shared_prefix_tokens(a, vocab, limit)
        for bs in (0, 16, 7):
            assert tw.sim_prefix_chain(pa, bs) == jw.sim_prefix_chain(a, bs)


def _completion_fields(cs):
    return [(c.request_id, list(c.tokens), list(c.generated), c.status, c.error) for c in cs]


def _sim_lifecycle(w):
    """One SimEngine through pump, a snapshot mid-flight restored into a
    second engine (merge), a handoff and a cancel."""
    clock = w.SimClock()
    sink = w.SimSink()
    a = w.SimEngine(clock=clock, n_slots=3, n_blocks=40, decode_tps=10.0, sink=sink)
    b = w.SimEngine(clock=clock, n_slots=6, n_blocks=64, sink=sink)
    out = {"pump": _completion_fields(a.pump([dict(prompt=[1, 2, 3], max_tokens=5),
                                              dict(prompt=[4, 5], max_tokens=9),
                                              dict(prompt=[6], max_tokens=2)]))}
    for p in ([7, 8, 9], [10, 11], [12]):
        a.submit(p, 20)
    for _ in range(3):
        clock.advance(0.2)
        a.step_burst()
    snap = a.snapshot_active()
    out["snapshot"] = snap
    out["restored"] = b.restore(snap, merge=True)
    out["released"] = a.release_active()
    rid = b.submit([13, 14], 6, handoff=True)
    cancelled = b.submit([15], 30)
    out["cancel"] = b.cancel(cancelled)
    for _ in range(400):
        clock.advance(0.1)
        b.step_burst()
        if b.free_slots() == b.n_slots:
            break
    out["handoffs"] = [{k: (v.checksum(), v.nbytes) if k == "kv" else v for k, v in h.items()}
                       for h in b.take_handoffs()]
    out["handoff_rid"] = rid
    out["done"] = _completion_fields(a.completions() + b.completions())
    out["sink"] = dict(sink.first_token_t)
    # engine_seq is the object's id: each run its own
    out["stats"] = [{k: v for k, v in dataclasses.asdict(e.stats()).items() if k != "engine_seq"}
                    for e in (a, b)]
    out["free"] = (a.free_blocks if hasattr(a, "free_blocks") else a._free_blocks,
                   b._free_blocks)
    return out


def test_sim_engine_pumps_snapshots_restores_and_hands_off_alike():
    ref, port = _sim_lifecycle(jw), _sim_lifecycle(tw)
    assert port == ref
    assert ref["handoffs"] and ref["restored"] and ref["cancel"]


def _replay(pkg, kind):
    """``replay`` of a seeded trace through package ``pkg``'s router of
    its own SimEngines.  kinds: "fleet", "disagg", "burn" (a fleet with a
    SloBurnRateMonitor fed), "prefix" (a shared-prefix trace, prompts by
    ``shared_prefix_tokens``, chains through ``submit_extra`` into engines
    publishing to a FleetPrefixIndex the router scores by)."""
    m = PKG[pkg]
    w = m["w"]
    clock, sink = w.SimClock(), w.SimSink()
    kw = dict(n_slots=4, n_blocks=256, decode_tps=30.0)
    extra = {}
    monitor = None
    if kind == "prefix":
        index = m["fp"].FleetPrefixIndex(clock=clock, ttl_s=600.0)
        engines = [(n, w.SimEngine(clock=clock, sink=sink, name=n, prefill_tps=400.0,
                                   prefix_block_tokens=16, prefix_cache_blocks=64,
                                   prefix_index=index, **kw)) for n in ("A", "B", "C")]
        router = m["fleet"].FleetRouter(engines, clock=clock)
        router.attach_prefix_index(index)
        trace = w.generate_shared_prefix(_shared_spec(w, "zipf"))
        extra = dict(tokens_fn=w.shared_prefix_tokens,
                     submit_extra=lambda a: {"prefix_chain": w.sim_prefix_chain(a, 16)})
    elif kind == "disagg":
        router = m["disagg"].DisaggRouter(
            prefill=[w.SimEngine(clock=clock, sink=sink, **kw)],
            decode=[w.SimEngine(clock=clock, sink=sink, **kw) for _ in range(2)], clock=clock)
        trace = w.generate(_spec(w, **REPLAY_SPEC))
    else:
        router = m["fleet"].FleetRouter([w.SimEngine(clock=clock, sink=sink, **kw)
                                         for _ in range(3)], clock=clock)
        trace = w.generate(_spec(w, **REPLAY_SPEC))
        if kind == "burn":
            monitor = m["obs"].SloBurnRateMonitor(error_budget=0.05, alert_threshold=2.0)
    streams = []
    rep = w.replay(trace, router, clock=clock, sink=sink, dt=0.1, queue_limit=64,
                   burn_monitor=monitor, vocab=32768 if kind == "prefix" else 64,
                   on_completion=lambda c: streams.append(
                       (c.request_id, tuple(c.generated), c.status)), **extra)
    doc = rep.to_json()
    doc.pop("wall_s")
    out = {"report": doc, "streams": streams}
    if monitor is not None:
        st = monitor.stats()
        out["burn"] = (st["transitions"], monitor.timeline(), monitor.alerting)
    if kind == "prefix":
        out["hits"] = [e.prefix_hits for _, e in engines]
        out["ledger"] = index.ledger()
        out["ledger"] = (out["ledger"].blocks, out["ledger"].entries, out["ledger"].pinned)
    return out


@pytest.mark.parametrize("kind", ["fleet", "disagg", "burn", "prefix"])
def test_replay_reports_equal(kind):
    ref, port = _replay("reference", kind), _replay("port", kind)
    assert port == ref
    rep = ref["report"]
    assert rep["offered"] > 100 and rep["lost"] == 0
    assert rep["completed"] + rep["shed"] == rep["offered"]
    if kind == "prefix":
        assert sum(h["remote"] for h in ref["hits"]) > 0
    if kind == "burn":
        assert ref["burn"][1]
