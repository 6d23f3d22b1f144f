"""The port's diagnostics server and log format
(``k8s_dra_driver_torch/utils/{diagnostics,logging}.py``) against the
reference's, on the CPU, over real HTTP.

Both packages' ``DiagnosticsServer`` run on port 0, each over a registry
and a journal of its own holding the same series and events.  They must
serve the same endpoint set (status, content type, and for the JSON
endpoints the same top-level keys), the same 404 and the same ``/healthz``;
``/metrics`` is the exposition of the server's registry, byte for byte the
other package's, and federates the same way once the observability plane
holds a worker's snapshot; the journal's filters select the same events;
``/debug/stacks`` has the same shape.  The log formats (JSON lines with an
exception, and text) are equal with the record's clock fixed.
"""

import json
import logging
import sys
import urllib.error
import urllib.request

import pytest

from k8s_dra_driver_torch.models import obs_plane as port_obs
from k8s_dra_driver_torch.utils import diagnostics as port_diag
from k8s_dra_driver_torch.utils import journal as port_journal
from k8s_dra_driver_torch.utils import logging as port_logging
from k8s_dra_driver_torch.utils import metrics as port_metrics
from k8s_dra_driver_tpu.models import obs_plane as ref_obs
from k8s_dra_driver_tpu.utils import diagnostics as ref_diag
from k8s_dra_driver_tpu.utils import journal as ref_journal
from k8s_dra_driver_tpu.utils import logging as ref_logging
from k8s_dra_driver_tpu.utils import metrics as ref_metrics

PACKAGES = {"reference": (ref_diag, ref_metrics, ref_journal, ref_obs),
            "port": (port_diag, port_metrics, port_journal, port_obs)}
ENDPOINTS = ("/metrics", "/healthz", "/debug/state", "/debug/traces", "/debug/journal",
             "/debug/stacks", "/debug/serve", "/debug/fleet", "/debug/disagg",
             "/debug/transport", "/debug/autoscale", "/debug/fleet-journal",
             "/debug/fleet-traces", "/nope", "/debug")


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, None, b""


@pytest.fixture
def servers():
    """Per package: (its server, its registry, its journal), the same
    series and events in each."""
    out = {}
    try:
        for name, (diag, metrics, journal, _) in PACKAGES.items():
            reg, jr = metrics.Registry(), journal.Journal()
            reg.counter("dra_test_hits_total", "endpoint test hits").inc(3, op="prepare")
            reg.histogram("dra_test_seconds", "a histogram", buckets=(0.1, 1.0)).observe(0.5)
            for i in range(6):
                jr.record("e2e" if i % 2 else "allocator", f"event-{i}",
                          correlation=f"c{i % 3}", step=i)
            srv = diag.DiagnosticsServer(port=0, registry=reg, journal=jr,
                                         bind_host="127.0.0.1",
                                         state_provider=lambda: {"node": "n0", "claims": []})
            srv.start()
            out[name] = (srv, reg, jr)
        yield out
    finally:
        for srv, _, _ in out.values():
            srv.stop()


def _shape(path, status, ctype, body):
    """Status and content type, and a JSON document's top-level keys (the
    stacks' keys are thread names: their shape is tested below)."""
    if ctype == "application/json":
        doc = json.loads(body)
        keyed = isinstance(doc, dict) and path != "/debug/stacks"
        return status, ctype, sorted(doc) if keyed else type(doc).__name__
    return status, ctype


def test_the_endpoint_set(servers):
    got = {name: [_shape(path, *_get(srv.port, path)) for path in ENDPOINTS]
           for name, (srv, _, _) in servers.items()}
    assert got["port"] == got["reference"]
    by_path = dict(zip(ENDPOINTS, got["port"]))
    assert by_path["/nope"] == (404, None) and by_path["/debug"] == (404, None)
    assert all(by_path[p][0] == 200 for p in ENDPOINTS if p not in ("/nope", "/debug"))
    for srv, _, _ in servers.values():
        assert _get(srv.port, "/healthz") == (200, "text/plain", b"ok")
        assert json.loads(_get(srv.port, "/debug/state")[2]) == {"node": "n0", "claims": []}


def test_metrics_is_the_registry_s_exposition(servers):
    bodies = {}
    for name, (srv, reg, _) in servers.items():
        status, ctype, body = _get(srv.port, "/metrics")
        assert (status, ctype) == (200, "text/plain; version=0.0.4")
        assert body.decode() == reg.render()
        bodies[name] = body
    assert bodies["port"] == bodies["reference"]
    parsed = port_metrics.parse_prom_text(bodies["port"].decode())
    assert parsed["dra_test_hits_total"] == {(("op", "prepare"),): 3.0}
    assert parsed["dra_test_seconds_count"] == {(): 1.0}


def test_metrics_federate_a_worker_s_snapshot(servers):
    doc = {"metrics": "tpu_serve_requests_total{status=\"ok\"} 7.0\nup 1.0\n", "mono": 1.0}
    try:
        bodies = {}
        for name, (srv, reg, _) in servers.items():
            fleet = PACKAGES[name][3].FLEET
            fleet.ingest("worker-0", dict(doc))
            body = _get(srv.port, "/metrics")[2].decode()
            assert body == fleet.render_federated(reg)
            bodies[name] = body
        assert bodies["port"] == bodies["reference"]
        assert 'tpu_serve_requests_total{instance="worker-0",status="ok"} 7.0' in bodies["port"] \
            or 'tpu_serve_requests_total{status="ok",instance="worker-0"} 7.0' in bodies["port"]
    finally:
        for _, _, _, obs in PACKAGES.values():
            obs.FLEET.clear()


@pytest.mark.parametrize("query", ["", "?limit=2", "?component=e2e", "?correlation=c1",
                                   "?component=allocator&correlation=c2&limit=1",
                                   "?limit=bogus"])
def test_journal_filters(servers, query):
    got = {}
    for name, (srv, _, _) in servers.items():
        doc = json.loads(_get(srv.port, f"/debug/journal{query}")[2])
        for e in doc["events"]:
            e.pop("ts")
        got[name] = doc
    assert got["port"] == got["reference"]
    assert got["port"]["recorded"] == 6


def test_stacks_have_the_same_shape(servers):
    for srv, _, _ in servers.values():
        doc = json.loads(_get(srv.port, "/debug/stacks")[2])
        assert doc and all(isinstance(k, str) and isinstance(v, list)
                           and all(isinstance(x, str) for x in v) for k, v in doc.items())
        assert any("serve_forever" in "".join(v) for v in doc.values())


def _record(exc_info=None) -> logging.LogRecord:
    record = logging.LogRecord("tpu-dra-plugin", logging.ERROR, __file__, 10,
                               "prepare %s failed", ("claim-a",), exc_info)
    record.created, record.msecs = 1760000000.25, 250.0
    return record


def test_log_lines_are_the_reference_s(monkeypatch):
    try:
        raise ValueError("no such device")
    except ValueError:
        exc_info = sys.exc_info()
    lines = {}
    for name, mod in (("reference", ref_logging), ("port", port_logging)):
        monkeypatch.setenv("LOG_FORMAT", "json")
        json_logger = mod.get_logger(f"log-format-json-{name}", level="debug")
        monkeypatch.setenv("LOG_FORMAT", "text")
        text_logger = mod.get_logger(f"log-format-text-{name}")
        (jh,), (th,) = json_logger.handlers, text_logger.handlers
        assert json_logger.level == logging.DEBUG and text_logger.level == logging.INFO
        assert not json_logger.propagate and jh.stream is sys.stderr
        lines[name] = [jh.formatter.format(_record()), jh.formatter.format(_record(exc_info)),
                       th.formatter.format(_record())]
    assert lines["port"] == lines["reference"]
    doc = json.loads(lines["port"][1])
    assert doc["msg"] == "prepare claim-a failed" and doc["exc"]["type"] == "ValueError"
    assert lines["port"][2].endswith(" E tpu-dra-plugin] prepare claim-a failed")
