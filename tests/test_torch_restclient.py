"""The port's REST client and mock API server (``k8s_dra_driver_torch/
kube/restclient.py``, ``e2e/mock_api.py``) against the reference's, on the
CPU, over real HTTP on localhost.

Every case of the reference's ``tests/test_restclient.py`` runs cross-wired:
the port's ``RESTClient`` against the reference's ``MockKubeAPI``, and the
reference's client against the port's mock, so both directions of the wire
are held.  Each case's log (objects as ``to_json`` dicts, errors as type
name, message and code, uids drawn from one deterministic sequence) must
equal the same case run with the reference's client against its own mock.
The kubeconfig loader and the rate limiter are compared directly.
"""

import importlib
import itertools
import threading
import time
import types
import uuid

import pytest

MODULES = dict(restclient="kube.restclient", mock_api="e2e.mock_api",
               fakeserver="kube.fakeserver", objects="kube.objects", faults="utils.faults",
               journal="utils.journal", metrics="utils.metrics",
               slice_manager="controller.slice_manager", harness="e2e.harness",
               driver="plugin.driver", allocator="scheduler.allocator")
PKG = {name: types.SimpleNamespace(**{k: importlib.import_module(f"{root}.{m}")
                                      for k, m in MODULES.items()})
       for name, root in (("reference", "k8s_dra_driver_tpu"), ("port", "k8s_dra_driver_torch"))}
WIRINGS = {"port client, reference mock": ("port", "reference"),
           "reference client, port mock": ("reference", "port")}
FAST = dict(qps=1000, burst=1000)


def outcome(c, fn):
    """``("ok", json)`` of what ``fn`` returns, or ``("raised", type name,
    message, code)``."""
    try:
        got = fn()
    except Exception as exc:
        return ("raised", type(exc).__name__, str(exc), getattr(exc, "code", None))
    if isinstance(got, list):
        return ("ok", [c.objects.to_json(o) for o in got])
    if hasattr(type(got), "KIND"):
        return ("ok", c.objects.to_json(got))
    return ("ok", got)


def wait_until(pred, timeout=5.0):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.02)
    return pred()


def run(scenario, client_pkg, mock_pkg, monkeypatch, **kw):
    """``scenario(c, m, api, client, **kw)`` with ``client_pkg``'s client
    (token "sekrit", the limiter out of the way) against a fresh
    ``mock_pkg`` mock, uids from 1 up."""
    counter = itertools.count(1)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter)))
    c, m = PKG[client_pkg], PKG[mock_pkg]
    api = m.mock_api.MockKubeAPI(token="sekrit").start()
    try:
        client = c.restclient.RESTClient(
            c.restclient.KubeClientConfig(server=api.url, token="sekrit", **FAST))
        return scenario(c, m, api, client, **kw)
    finally:
        stop(api)


def stop(api):
    """Stop ``api`` without waiting out its serving loop's half-second
    poll: its streams end now, its listener within the poll."""
    api._closing.set()
    threading.Thread(target=api.stop, daemon=True).start()


def crossed(scenario, wiring, monkeypatch, **kw):
    got = run(scenario, *WIRINGS[wiring], monkeypatch, **kw)
    want = run(scenario, "reference", "reference", monkeypatch, **kw)
    assert got == want
    return got


def node(c, name, **labels):
    return c.objects.Node(metadata=c.objects.ObjectMeta(name=name, labels=labels))


def crud(c, m, api, client):
    log = [outcome(c, lambda: client.create(node(c, "n1", a="b")))]
    got = client.get("Node", "n1")
    got.metadata.labels["c"] = "d"
    log += [outcome(c, lambda: client.update(got)), outcome(c, lambda: client.delete("Node", "n1")),
            outcome(c, lambda: client.get("Node", "n1")),
            outcome(c, lambda: client.delete("Node", "n1")),
            outcome(c, lambda: client.create(node(c, "n2"))),
            outcome(c, lambda: client.create(node(c, "n2")))]
    return log


def namespaced(c, m, api, client):
    claim = c.objects.ResourceClaim(metadata=c.objects.ObjectMeta(name="c1", namespace="team-a"))
    return [outcome(c, lambda: client.create(claim)),
            outcome(c, lambda: client.get("ResourceClaim", "c1", "team-a")),
            outcome(c, lambda: client.list("ResourceClaim", namespace="team-b")),
            outcome(c, lambda: client.list("ResourceClaim", namespace="team-a")),
            outcome(c, lambda: client.list("ResourceClaim")),
            outcome(c, lambda: client.get("ResourceClaim", "c1", "team-b"))]


def selected(c, m, api, client):
    client.create(node(c, "a", d="1"))
    client.create(node(c, "b", d="2", e="x"))
    client.create(node(c, "c", d="2"))
    return [outcome(c, lambda: client.list("Node", label_selector={"d": "2"})),
            outcome(c, lambda: client.list("Node", label_selector={"d": "2", "e": "x"})),
            outcome(c, lambda: client.list("Node", label_selector={"d": "3"})),
            outcome(c, lambda: client.list(
                "Node", field_selector=lambda o: o.metadata.name != "a"))]


def conflict_and_token(c, m, api, client):
    client.create(node(c, "n1"))
    a, b = client.get("Node", "n1"), client.get("Node", "n1")
    log = [outcome(c, lambda: client.update(a)), outcome(c, lambda: client.update(b))]
    for token in ("wrong", ""):
        bad = c.restclient.RESTClient(c.restclient.KubeClientConfig(
            server=api.url, token=token, **FAST))
        log += [outcome(c, lambda: bad.get("Node", "n1")), outcome(c, bad.probe)]
    return log


def watch_stream(c, m, api, client):
    client.create(node(c, "pre"))
    events = []
    w = client.watch("Node", lambda e: events.append((e.type, e.object.metadata.name)))
    try:
        replayed = list(events)
        assert wait_until(lambda: api.server._watches)
        api.server.create(m.objects.Node(metadata=m.objects.ObjectMeta(name="live")))
        api.server.delete("Node", "pre")
        assert wait_until(lambda: len(events) >= 3)
    finally:
        w.stop()
    return replayed, events


def no_lost_event(c, m, api, client):
    client.create(node(c, "pre"))
    events = []
    w = client.watch("Node", lambda e: events.append((e.type, e.object.metadata.name)))
    try:
        api.server.create(m.objects.Node(metadata=m.objects.ObjectMeta(name="gap")))
        assert wait_until(lambda: any(n == "gap" for _, n in events))
    finally:
        w.stop()
    return events[0], sorted({n for _, n in events})


def probe(c, m, api, client):
    return outcome(c, client.probe)


def relist_replace(c, m, api, client):
    events = []
    w = c.fakeserver.Watch(api.server, "Node",
                           lambda e: events.append((e.type, e.object.metadata.name)))
    client.create(node(c, "stale"))
    client.create(node(c, "kept"))
    for obj in client.list("Node"):  # delivered before the gap
        client._deliver(w, c.fakeserver.WatchEvent("ADDED", obj))
    client.delete("Node", "stale")  # vanishes during the outage
    first = client._relist(w, "Node")
    log = [list(events), first]
    client._relist(w, "Node")
    return log + [events]


def relist_failure(c, m, api, client, patch):
    relist_errors = c.metrics.REGISTRY.counter("dra_watch_relist_errors_total")
    before = relist_errors.value(kind="Node")
    c.journal.JOURNAL.clear()
    client.create(node(c, "n0"))
    events = []
    w = client.watch("Node", lambda e: events.append((e.type, e.object.metadata.name)))
    try:
        assert wait_until(lambda: api.server._watches)
        fail = {"on": True}
        real_relist = type(client)._relist

        def flaky_relist(watch, kind):
            if fail["on"]:
                fail["on"] = False  # fail once, then heal
                raise c.fakeserver.APIError(500, "relist blown")
            return real_relist(client, watch, kind)

        patch.setattr(client, "_relist", flaky_relist)
        api.server.faults = m.faults.FaultInjector()
        api.server.faults.arm(m.faults.FaultProfile(name="outage", watch_gone=2))
        for sw in list(api.server._watches):
            sw.stop()
        assert wait_until(lambda: not fail["on"])
        api.server.create(m.objects.Node(metadata=m.objects.ObjectMeta(name="after")))
        assert wait_until(lambda: any(n == "after" for _, n in events))
    finally:
        w.stop()
    fails = [e["event"] for e in c.journal.JOURNAL.tail(component="restclient")]
    return (relist_errors.value(kind="Node") - before, fails, api.server.faults.stats(),
            sorted({n for _, n in events}))


def error_frame(c, m, api, client):
    client.create(node(c, "n0"))
    events = []
    reconnects = c.metrics.REGISTRY.counter("dra_watch_reconnects_total")
    before = reconnects.value(kind="Node")
    api.server.faults = m.faults.FaultInjector()  # the stream reads it as it opens
    w = client.watch("Node", lambda e: events.append((e.type, e.object.metadata.name)))
    try:
        assert wait_until(lambda: api.server._watches)
        api.server.faults.arm(m.faults.FaultProfile(name="frames", watch_error_frames=1))
        assert wait_until(lambda: api.server.faults.stats())
        api.server.create(m.objects.Node(metadata=m.objects.ObjectMeta(name="after")))
        assert wait_until(lambda: any(n == "after" for _, n in events))
    finally:
        w.stop()
    return (api.server.faults.stats(), sorted({n for _, n in events}),
            reconnects.value(kind="Node") - before >= 1)


def stream_ended(c, m, api, client):
    client.create(node(c, "n0"))
    events = []
    w = client.watch("Node", lambda e: events.append((e.type, e.object.metadata.name)))
    try:
        assert wait_until(lambda: api.server._watches)
        for sw in list(api.server._watches):
            sw.stop()
        api.server.create(m.objects.Node(metadata=m.objects.ObjectMeta(name="after")))
        assert wait_until(lambda: any(n == "after" for _, n in events))
    finally:
        w.stop()
    return sorted({n for _, n in events})


def driver_stack(c, m, api, client, tmp_path):
    m.harness.install_device_classes(api.server)
    driver = c.driver.Driver(client, c.driver.DriverConfig(
        node_name="rest-host", cdi_root=str(tmp_path / "cdi"),
        checkpoint_path=str(tmp_path / "cp.json"),
        topology_env={"TPUINFO_FAKE_TOPOLOGY": "v5e-16", "TPUINFO_FAKE_HOST_ID": "0"}))
    (published,) = api.server.list("ResourceSlice")
    claim = client.create(c.harness.simple_claim("rest-claim"))
    allocated = c.allocator.Allocator(client).allocate(claim, node_name="rest-host")
    ref = c.driver.ClaimRef(uid=allocated.metadata.uid, name="rest-claim", namespace="default")
    result = driver.node_prepare_resources([ref])[ref.uid]
    devices = [{k: v.replace(str(tmp_path), "<tmp>") if isinstance(v, str) else v
                for k, v in d.items()} for d in result.devices]
    undone = driver.node_unprepare_resources([ref])[ref.uid].error
    return (m.objects.to_json(published), c.objects.to_json(allocated.status), result.error,
            devices, undone)


def slice_manager(c, m, api, client):
    sm = c.slice_manager
    mgr = sm.SliceManager(client)
    mgr.start()
    try:
        assert wait_until(lambda: api.server._watches)
        api.server.create(m.objects.Node(metadata=m.objects.ObjectMeta(
            name="h0", labels={sm.SLICE_DOMAIN_LABEL: "d", sm.SLICE_HOST_ID_LABEL: "0"})))
        assert wait_until(lambda: [s for s in api.server.list("ResourceSlice")
                                   if s.spec.pool.name == "slice-d"])
        published = [m.objects.to_json(s) for s in api.server.list("ResourceSlice")]
    finally:
        mgr.stop()
    return published, [s.metadata.name for s in api.server.list("ResourceSlice")]


CASES = {"crud": crud, "namespaced": namespaced, "label selector": selected,
         "conflict and token": conflict_and_token, "probe": probe,
         "relist replace": relist_replace}


@pytest.mark.parametrize("wiring", WIRINGS)
@pytest.mark.parametrize("case", CASES)
def test_requests_answer_as_the_reference_s(monkeypatch, case, wiring):
    log = crossed(CASES[case], wiring, monkeypatch)
    if case == "crud":
        assert [e[0] for e in log] == ["ok", "ok", "ok", "raised", "raised", "ok", "raised"]
        assert log[3][1] == "NotFound" and log[6][1] == "AlreadyExists"
    if case == "conflict and token":
        assert log[1][1] == "Conflict" and {e[3] for e in log[2:]} == {401}


@pytest.mark.parametrize("wiring", WIRINGS)
def test_watch_replay_and_stream(monkeypatch, wiring):
    replayed, events = crossed(watch_stream, wiring, monkeypatch)
    assert replayed == [("ADDED", "pre")]
    assert ("ADDED", "live") in events and ("DELETED", "pre") in events


@pytest.mark.parametrize("wiring", WIRINGS)
def test_no_lost_event_between_list_and_watch(monkeypatch, wiring):
    first, names = crossed(no_lost_event, wiring, monkeypatch)
    assert first == ("ADDED", "pre") and names == ["gap", "pre"]


@pytest.mark.parametrize("wiring", WIRINGS)
def test_relist_failure_counted_not_swallowed(monkeypatch, wiring):
    count, fails, stats, names = crossed(relist_failure, wiring, monkeypatch,
                                         patch=monkeypatch)
    assert count == 1 and fails == ["watch.relist_fail"] and names == ["after", "n0"]
    assert stats == {"watch_gone": 2}


@pytest.mark.parametrize("wiring", WIRINGS)
@pytest.mark.parametrize("how", ["error frame", "stream ended"])
def test_the_watch_survives_a_broken_stream(monkeypatch, wiring, how):
    got = crossed(error_frame if how == "error frame" else stream_ended, wiring, monkeypatch)
    if how == "error frame":
        assert got == ({"watch_error_frames": 1}, ["after", "n0"], True)
    else:
        assert got == ["after", "n0"]


@pytest.mark.parametrize("wiring", WIRINGS)
def test_driver_stack_over_rest(monkeypatch, wiring, tmp_path):
    published, status, error, devices, undone = crossed(driver_stack, wiring, monkeypatch,
                                                        tmp_path=tmp_path)
    assert len(published["spec"]["devices"]) == 9
    assert error == "" and len(devices) == 1 and undone == ""


@pytest.mark.parametrize("wiring", WIRINGS)
def test_slice_manager_watches_nodes_over_http(monkeypatch, wiring):
    published, after = crossed(slice_manager, wiring, monkeypatch)
    (doc,) = [s for s in published if s["spec"]["pool"]["name"] == "slice-d"]
    assert doc["spec"]["devices"][0]["basic"]["attributes"]["workerId"] == {"int": 0}
    assert after == []


KUBECONFIG = """
apiVersion: v1
kind: Config
current-context: ctx
contexts:
  - name: ctx
    context: {{cluster: c, user: u}}
  - name: other
    context: {{cluster: c2, user: u2}}
clusters:
  - name: c
    cluster:
      server: https://1.2.3.4:6443
      certificate-authority-data: {ca}
  - name: c2
    cluster:
      server: http://5.6.7.8:8080
      insecure-skip-tls-verify: true
users:
  - name: u
    user:
      token: tok123
  - name: u2
    user:
      client-certificate: /certs/c.crt
      client-key-data: {key}
"""


@pytest.mark.parametrize("context", ["", "other", "missing"])
def test_kubeconfig_parsing(tmp_path, context):
    import base64
    import dataclasses

    ca = base64.b64encode(b"fake-ca-pem").decode()
    key = base64.b64encode(b"fake-key-pem").decode()
    (tmp_path / "kubeconfig").write_text(KUBECONFIG.format(ca=ca, key=key))
    got = {}
    for name, c in PKG.items():
        cfg = c.restclient.KubeClientConfig.from_kubeconfig(tmp_path / "kubeconfig", context)
        doc = dataclasses.asdict(cfg)
        for k in ("ca_file", "client_key_file"):  # materialised into temp files
            if doc[k] and doc[k].startswith("/tmp"):
                doc[k] = open(doc[k], "rb").read()
        got[name] = doc
    assert got["port"] == got["reference"]
    if context == "":
        assert got["port"]["server"] == "https://1.2.3.4:6443"
        assert got["port"]["token"] == "tok123" and got["port"]["ca_file"] == b"fake-ca-pem"
    if context == "other":
        assert got["port"]["insecure_skip_verify"] and got["port"]["client_key_file"] == \
            b"fake-key-pem"
    assert (got["port"]["qps"], got["port"]["burst"]) == (5.0, 10)


def test_load_precedence(tmp_path, monkeypatch):
    (tmp_path / "kc").write_text(
        "current-context: x\ncontexts: [{name: x, context: {cluster: c, user: u}}]\n"
        "clusters: [{name: c, cluster: {server: http://env-server}}]\n"
        "users: [{name: u, user: {token: t}}]\n"
    )
    (tmp_path / "flag").write_text(
        (tmp_path / "kc").read_text().replace("env-server", "flag-server"))
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "kc"))
    got = {}
    for name, c in PKG.items():
        load = c.restclient.KubeClientConfig.load
        got[name] = [load().server, load(str(tmp_path / "flag")).server]
    monkeypatch.delenv("KUBECONFIG")
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    for name, c in PKG.items():
        got[name].append(outcome(c, c.restclient.KubeClientConfig.load))
    assert got["port"] == got["reference"]
    assert got["port"][:2] == ["http://env-server", "http://flag-server"]
    assert got["port"][2][:2] == ("raised", "APIError")


def test_rate_limiter_enforces_qps():
    from k8s_dra_driver_torch.kube.restclient import _RateLimiter

    rl = _RateLimiter(qps=50, burst=2)
    start = time.monotonic()
    for _ in range(6):
        rl.wait()
    # 2 burst + 4 refills at 50/s: at least 80 ms
    assert time.monotonic() - start >= 0.06
    import dataclasses

    assert dataclasses.asdict(PKG["port"].restclient.KubeClientConfig()) == \
        dataclasses.asdict(PKG["reference"].restclient.KubeClientConfig())
