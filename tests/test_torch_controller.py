"""The port's cluster controller (``k8s_dra_driver_torch/controller/``)
against the reference's, on the CPU.

* ``SliceManager``: the same Node event sequences go to a manager of each
  package, each over its own ``InMemoryAPIServer`` with uids from one
  deterministic sequence; at every checkpoint the published
  ResourceSlices (``to_json`` dicts), the domains and the reserved seat
  windows must be equal.  The sequences cover a domain's first and last
  node, worker order, a relabel, a malformed and a duplicate host id, a
  200-host domain chunked at 128 and shrunk, window exhaustion parked and
  retried under an injected clock, slice-group pools, conflicting group
  labels, a late start, shutdown and a leadership handover.
* ``LeaderElector``: the same ``tick``/``release`` sequences under one
  fake clock give the same leader and equal ``Lease`` objects; the run
  loop's transitions are equal; a port elector and a reference elector
  share one lease over HTTP; lease stamps agree.
* ``controller.main``: ``build_parser`` is the reference's; the binary
  with ``--fake-cluster`` exits 0 on SIGTERM; an unreachable server gives
  2; ``--extender-port 0`` gives 2 naming ROADMAP item 23; over a mock
  API's kubeconfig it publishes seats, with and without
  ``--leader-elect``, and on SIGTERM releases the lease and keeps the
  seats (leader election) or deletes them (a lone controller).
"""

import importlib
import itertools
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import types
import uuid
from pathlib import Path

import pytest

MODULES = dict(slice_manager="controller.slice_manager", leaderelection="controller.leaderelection",
               main="controller.main", fakeserver="kube.fakeserver", objects="kube.objects",
               restclient="kube.restclient", mock_api="e2e.mock_api")
PKG = {name: types.SimpleNamespace(**{k: importlib.import_module(f"{root}.{m}")
                                      for k, m in MODULES.items()})
       for name, root in (("reference", "k8s_dra_driver_tpu"), ("port", "k8s_dra_driver_torch"))}
REPO_ROOT = Path(__file__).resolve().parent.parent
LIMIT = PKG["port"].slice_manager.MEMBERSHIP_PER_SLICE_LIMIT


def _deterministic_uids(monkeypatch):
    counter = itertools.count(1)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter)))


class Cluster:
    """One package's server and manager, driven by name."""

    def __init__(self, pkg, clock=None, start=True, **kw):
        self.p = PKG[pkg]
        self.sm = self.p.slice_manager
        self.server = self.p.fakeserver.InMemoryAPIServer()
        if clock is not None:
            kw["clock"] = clock
        self.mgr = self.sm.SliceManager(self.server, **kw)
        if start:
            self.mgr.start()

    def add(self, name, domain=None, host_id=0, group=None):
        labels = {"kubernetes.io/hostname": name}
        if domain:
            labels[self.sm.SLICE_DOMAIN_LABEL] = domain
            labels[self.sm.SLICE_HOST_ID_LABEL] = str(host_id)
        if group:
            labels[self.sm.SLICE_GROUP_LABEL] = group
        self.server.create(self.p.objects.Node(metadata=self.p.objects.ObjectMeta(
            name=name, labels=labels)))

    def relabel(self, name, **labels):
        node = self.server.get("Node", name)
        for key, value in labels.items():
            label = getattr(self.sm, f"SLICE_{key.upper()}_LABEL")
            node.metadata.labels[label] = value
        self.server.update(node)

    def delete(self, name):
        self.server.delete("Node", name)

    def quietly(self, fn, names):
        """``fn(name)`` for every name but the last with the manager's
        publish held back (its domain state still follows each event),
        then the last as a plain event: the large domains' O(n^2) of
        republishes would otherwise dominate the test."""
        self.mgr._publish = lambda: None
        try:
            for name in names[:-1]:
                fn(name)
        finally:
            del self.mgr._publish
        fn(names[-1])

    def state(self):
        slices = sorted(self.server.list("ResourceSlice"), key=lambda s: s.metadata.name)
        return ([self.p.objects.to_json(s) for s in slices], self.mgr.domains(),
                {d: list(w) for d, w in sorted(self.mgr._offsets.items())})


def first_and_last(c):
    c.add("h0", "v5e-32-a", 0)
    yield
    c.add("h1", "v5e-32-a", 1)
    yield
    c.delete("h0")
    yield
    c.delete("h1")
    yield


def worker_order(c):
    for hid in (2, 0, 1, 3):
        c.add(f"h{hid}", "d", hid)
    yield


def relabel(c):
    c.add("h0", "d1", 0)
    c.add("h1", "d1", 1)
    yield
    c.relabel("h0", domain="d2")
    yield
    c.relabel("h1", host_id="0", domain="d2")
    yield


def malformed_host_id(c):
    c.add("h0", "d", 0)
    c.add("hbad", "d", "host-1")
    yield
    c.add("hneg", "d", -1)
    c.relabel("hbad", host_id="1")
    yield


def duplicate_host_id(c):
    c.add("h0", "d", 0)
    c.add("h0b", "d", 0)
    yield
    c.delete("h0")
    yield


def big_domain(c):
    c.quietly(lambda h: c.add(h, "big", int(h[1:])), [f"h{hid}" for hid in range(200)])
    yield
    c.quietly(c.delete, [f"h{hid}" for hid in range(LIMIT, 200)])
    yield
    c.quietly(c.delete, [f"h{hid}" for hid in range(8, LIMIT)])
    yield


def windows(c):
    c.quietly(lambda h: c.add(h, "big", int(h[3:])), [f"big{hid}" for hid in range(LIMIT + 7)])
    yield
    for i in range(14):
        c.add(f"s{i}", f"small{i}", 0)
    c.add("sx", "overflow", 0)
    yield


def exhaustion(c):
    for i in range(2048 // LIMIT):
        c.add(f"h{i}", f"d{i}", 0)
    c.add("hx", "overflow", 0)
    yield
    c.delete("h3")
    yield
    c.mgr.retry_pending()
    yield


def groups(c):
    for s in range(2):
        for h in range(2):
            c.add(f"n{s}{h}", f"dom-{s}", h, group="job-a")
    c.add("m0", "dom-x", 0, group="job-b")
    yield
    c.delete("n10")
    c.delete("n11")
    yield
    c.relabel("m0", group="job-a")
    yield


def conflicting_groups(c):
    c.add("n0", "dom-0", 0, group="job-a")
    c.add("n1", "dom-0", 1, group="job-b")
    yield
    c.delete("n0")
    yield


def late_start(c):
    c.mgr.stop()
    c.add("h0", "d", 0)
    c.add("h1", "d", 1)
    yield
    c.mgr.start()
    yield


def shutdown(c):
    c.add("h0", "d", 0)
    c.add("g0", "e", 0, group="g")
    yield
    c.mgr.stop()
    yield


def handover(c):
    c.add("h0", "d", 0)
    yield
    other = c.sm.SliceManager(c.server)
    other.start()
    yield
    c.mgr.stop(delete_owned=False)
    yield
    c.add("h1", "d", 1)
    yield
    other.stop()
    yield


SCENARIOS = {f.__name__.replace("_", " "): f for f in (
    first_and_last, worker_order, relabel, malformed_host_id, duplicate_host_id, big_domain,
    windows, exhaustion, groups, conflicting_groups, late_start, shutdown, handover)}


def run_manager(pkg, scenario, monkeypatch):
    _deterministic_uids(monkeypatch)
    kw = {}
    if scenario == "exhaustion":
        fake_time = itertools.count(0, 120.0)  # 120 s a clock() call
        kw = dict(clock=lambda: next(fake_time), retry_timeout_s=60.0)
    c = Cluster(pkg, **kw)
    log = [c.state() for _ in SCENARIOS[scenario](c)]
    c.mgr.stop()
    return log


def _generations(log) -> list:
    """Each checkpoint's pool generations and resource versions, which the
    log then drops."""
    return [[(s["spec"]["pool"].pop("generation", 0), s["metadata"].pop("resourceVersion"))
             for s in slices] for slices, _, _ in log]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_slice_manager_publishes_as_the_reference_s(monkeypatch, scenario):
    got = {pkg: run_manager(pkg, scenario, monkeypatch) for pkg in PKG}
    if scenario == "late start":
        # the port publishes the informer's replay once, the reference once
        # a replayed Node: the same slices, one pool write instead of two
        assert (_generations(got["port"]), _generations(got["reference"])) == \
            ([[], [(0, "3")]], [[], [(1, "4")]])
    assert got["port"] == got["reference"]
    log = got["port"]

    def seats(step, pool_prefix="slice-"):
        return [d["basic"]["attributes"]["workerId"]["int"] for s in log[step][0]
                if s["spec"]["pool"]["name"].startswith(pool_prefix) for d in s["spec"]["devices"]]

    if scenario == "worker order":
        assert seats(0) == [0, 1, 2, 3]
    if scenario == "big domain":
        assert sorted(len(s["spec"]["devices"]) for s in log[0][0]) == [72, LIMIT]
        assert sorted(seats(0)) == list(range(200)) and log[0][2] == {"big": [0, LIMIT]}
        assert log[1][2] == log[2][2] == {"big": [0]} and sorted(seats(2)) == list(range(8))
    if scenario == "exhaustion":
        pools = [{s["spec"]["pool"]["name"] for s in step[0]} for step in log]
        assert "slice-overflow" not in pools[0] and "slice-overflow" in pools[2]
    if scenario in ("malformed host id", "duplicate host id"):
        assert seats(0) == [0]
    if scenario == "shutdown":
        assert log[0][0] and log[1][0] == []


@pytest.mark.parametrize("seats", [3, 64])
def test_a_new_leader_takes_over_without_shrinking_the_pool(monkeypatch, seats):
    """A second manager starting over N published seats (a leadership
    handover): the port's leaves the pool as it is; the reference's
    rewrites it with 1, 2, ... N seats in turn, which a watcher sees."""
    got = {}
    for pkg in PKG:
        _deterministic_uids(monkeypatch)
        c = Cluster(pkg)
        c.quietly(lambda h: c.add(h, "d", int(h[1:])), [f"h{i}" for i in range(seats)])
        seen = []
        w = c.server.watch("ResourceSlice", lambda e: seen.append(
            (e.type, len(e.object.spec.devices), e.object.spec.pool.generation)), replay=False)
        c.mgr.stop(delete_owned=False)
        other = c.sm.SliceManager(c.server)
        other.start()
        w.stop()
        got[pkg] = (seen, c.state())
        other.stop()
    assert got["port"][0] == []
    assert got["reference"][0] == [("MODIFIED", n, n) for n in range(1, seats + 1)]
    _generations([got["port"][1]])
    _generations([got["reference"][1]])
    assert got["port"][1] == got["reference"][1]


class FakeClock:
    def __init__(self):
        self.now = 1_000_000.0

    def __call__(self):
        return self.now


ELECTIONS = {
    "first acquires": [("tick", "a")],
    "standby blocked until expiry": [("tick", "a"), ("tick", "b"), ("advance", 10),
                                     ("tick", "b"), ("advance", 6), ("tick", "b"),
                                     ("tick", "a")],
    "renewal": [("tick", "a")] + [("advance", 10), ("tick", "a"), ("tick", "b")] * 5,
    "clean release": [("tick", "a"), ("tick", "b"), ("release", "a"), ("tick", "b"),
                      ("release", "a"), ("advance", 0.75), ("tick", "a")],
    "fractional clock": [("advance", 0.999), ("tick", "a"), ("advance", 14.5), ("tick", "b"),
                         ("advance", 0.501), ("tick", "b"), ("advance", 3.25), ("tick", "a")],
}


def run_election(pkg, steps, monkeypatch):
    _deterministic_uids(monkeypatch)
    le = PKG[pkg].leaderelection
    server = PKG[pkg].fakeserver.InMemoryAPIServer()
    clock = FakeClock()
    electors = {i: le.LeaderElector(server, le.LeaderElectionConfig(identity=i),
                                    clock=clock) for i in "ab"}
    log = []
    for op, arg in steps:
        if op == "advance":
            clock.now += arg
            continue
        got = electors[arg].tick() if op == "tick" else electors[arg].release()
        lease = server.get("Lease", "tpu-dra-controller", "tpu-dra-driver")
        log.append((op, arg, got, {i: e.is_leader for i, e in electors.items()},
                    PKG[pkg].objects.to_json(lease)))
    return log


@pytest.mark.parametrize("election", ELECTIONS)
def test_elector_ticks_as_the_reference_s(monkeypatch, election):
    got = {pkg: run_election(pkg, ELECTIONS[election], monkeypatch) for pkg in PKG}
    assert got["port"] == got["reference"]
    if election == "standby blocked until expiry":
        assert [e[2] for e in got["port"]] == [True, False, False, True, False]
        assert got["port"][3][4]["spec"]["leaseTransitions"] == 1


@pytest.mark.parametrize("flaky", [False, True])
def test_run_loop_transitions(monkeypatch, flaky):
    got = {}
    for pkg in PKG:
        _deterministic_uids(monkeypatch)
        le = PKG[pkg].leaderelection
        server = PKG[pkg].fakeserver.InMemoryAPIServer()
        a = le.LeaderElector(server, le.LeaderElectionConfig(identity="a", lease_duration_s=5.0),
                             clock=FakeClock())
        if flaky:
            calls, real_get = {"n": 0}, server.get

            def flaky_get(*args, real_get=real_get, calls=calls, **kwargs):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise RuntimeError("transient apiserver error")
                return real_get(*args, **kwargs)

            server.get = flaky_get
        events, slept, stop = [], [], threading.Event()

        def sleeper(s, slept=slept, stop=stop):
            slept.append(s)
            if len(slept) >= 3:
                stop.set()

        a.run(on_started_leading=lambda ev=events: ev.append("start"),
              on_stopped_leading=lambda ev=events: ev.append("stop"), stop=stop, sleeper=sleeper)
        lease = PKG[pkg].fakeserver.InMemoryAPIServer.get(server, "Lease", "tpu-dra-controller",
                                                          "tpu-dra-driver")
        got[pkg] = (events, slept, PKG[pkg].objects.to_json(lease))
    assert got["port"] == got["reference"]
    assert got["port"][0] == ["start", "stop"] and "holderIdentity" not in got["port"][2]["spec"]


def test_stamps_agree():
    ref, port = PKG["reference"].leaderelection, PKG["port"].leaderelection
    for t in (0, 1.0, 1_000_000.25, 1_700_000_000.999999, 4_102_444_799.5):
        assert port._stamp(t) == ref._stamp(t)
        assert port._parse(port._stamp(t)) == ref._parse(ref._stamp(t))
    assert port._parse("") == ref._parse("") == 0.0


def test_port_and_reference_electors_share_one_lease(monkeypatch):
    """A port elector and a reference elector, each through its own
    package's REST client, against one mock API: one holder at a time,
    expiry judged alike, release handed over at once."""
    mock = PKG["port"].mock_api.MockKubeAPI().start()
    clock = FakeClock()
    try:
        electors = {}
        for identity, pkg in (("port", "port"), ("reference", "reference")):
            p = PKG[pkg]
            client = p.restclient.RESTClient(p.restclient.KubeClientConfig(
                server=mock.url, qps=1000, burst=1000))
            electors[identity] = p.leaderelection.LeaderElector(
                client, p.leaderelection.LeaderElectionConfig(identity=identity), clock=clock)
        seen = []
        for op, who, dt in [("tick", "port", 0), ("tick", "reference", 0),
                            ("tick", "reference", 14), ("tick", "port", 0),
                            ("tick", "reference", 14.5), ("tick", "reference", 0.5),
                            ("tick", "port", 0), ("release", "reference", 0),
                            ("tick", "port", 0)]:
            clock.now += dt
            e = electors[who]
            seen.append((who, e.tick() if op == "tick" else e.release()))
        lease = mock.server.get("Lease", "tpu-dra-controller", "tpu-dra-driver")
    finally:
        mock._closing.set()
        mock.stop()
    assert seen == [("port", True), ("reference", False), ("reference", False), ("port", True),
                    ("reference", False), ("reference", True), ("port", False),
                    ("reference", None), ("port", True)]
    assert lease.spec.holder_identity == "port" and lease.spec.lease_transitions == 2


MIRRORS = sorted(set(re.findall(r'os\.environ\.get\("([A-Z_]+)"',
                                Path(PKG["reference"].main.__file__).read_text()))
                 - {"POD_NAME"})
VALUES = {"RETRY_TIMEOUT_S": "7.5", "HTTP_PORT": "8080", "EXTENDER_PORT": "9090",
          "FAKE_CLUSTER": "true", "LEADER_ELECT": "true"}


def _options(parser) -> list:
    return [(a.option_strings, a.dest, a.default, getattr(a.type, "__name__", a.type),
             a.help, a.nargs, a.const, a.required) for a in parser._actions]


def test_the_controller_parser_is_the_reference_s(monkeypatch):
    for name in MIRRORS:
        monkeypatch.delenv(name, raising=False)
    port, ref = PKG["port"].main.build_parser(), PKG["reference"].main.build_parser()
    assert _options(port) == _options(ref) and port.prog == ref.prog == "tpu-dra-controller"
    assert len(MIRRORS) == 9
    for name in MIRRORS:
        monkeypatch.setenv(name, VALUES.get(name, f"/from-env/{name.lower()}"))
        got = vars(PKG["port"].main.build_parser().parse_args([]))
        assert got == vars(PKG["reference"].main.build_parser().parse_args([]))
        monkeypatch.delenv(name)
        assert got != vars(PKG["port"].main.build_parser().parse_args([]))


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in MIRRORS and k != "KUBECONFIG"}
    env["PYTHONPATH"] = os.pathsep.join(x for x in (str(REPO_ROOT), env.get("PYTHONPATH", ""))
                                        if x)
    env["POD_NAME"] = "controller-test"
    return env


def _controller(args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "k8s_dra_driver_torch.controller.main", *args],
                            env=_env(), cwd=REPO_ROOT, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)


def _kubeconfig(path: Path, url: str, token: str = "") -> Path:
    path.write_text(json.dumps({
        "current-context": "c", "contexts": [{"name": "c", "context": {"cluster": "k",
                                                                       "user": "u"}}],
        "clusters": [{"name": "k", "cluster": {"server": url}}],
        "users": [{"name": "u", "user": {"token": token}}]}))
    return path


@pytest.mark.parametrize("args,needle", [
    (["--extender-port", "0", "--fake-cluster"], "ROADMAP item 23"),
    (["--kubeconfig", "KUBECONFIG"], "cannot reach an API server"),
])
def test_the_controller_refuses_with_2(tmp_path, args, needle):
    args = [str(_kubeconfig(tmp_path / "kc", "http://127.0.0.1:9")) if a == "KUBECONFIG" else a
            for a in args]
    proc = subprocess.run([sys.executable, "-m", "k8s_dra_driver_torch.controller.main", *args],
                          env=_env(), cwd=REPO_ROOT, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2 and needle in proc.stderr, proc.stderr
    assert "Traceback" not in proc.stderr


def test_fake_cluster_controller_stops_on_sigterm():
    proc = _controller(["--fake-cluster", "--http-port", "0"])
    lines: list[str] = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stderr), daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 60
        while not any("diagnostics on" in ln for ln in lines):
            assert proc.poll() is None and time.monotonic() < deadline, "".join(lines)
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    reader.join(timeout=10)
    text = "".join(lines)
    assert "slice manager watching" in text and "Traceback" not in text


@pytest.mark.parametrize("leader_elect", [True, False])
def test_the_controller_publishes_over_a_kubeconfig(tmp_path, leader_elect):
    p = PKG["port"]
    sm = p.slice_manager
    mock = p.mock_api.MockKubeAPI(token="t0k").start()
    args = ["--kubeconfig", str(_kubeconfig(tmp_path / "kc", mock.url, "t0k"))]
    proc = _controller(args + (["--leader-elect"] if leader_elect else []))
    lines: list[str] = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stderr), daemon=True)
    reader.start()

    def wait(pred, what):
        deadline = time.monotonic() + 60
        while not pred():
            assert proc.poll() is None and time.monotonic() < deadline, (what, "".join(lines))
            time.sleep(0.05)

    try:
        if leader_elect:
            wait(lambda: any(lease.spec.holder_identity == "controller-test"
                             for lease in mock.server.list("Lease")), "the lease")
        wait(lambda: any(w.kind == "Node" for w in mock.server._watches), "the Node watch")
        for h in range(3):
            mock.server.create(p.objects.Node(metadata=p.objects.ObjectMeta(
                name=f"h{h}", labels={sm.SLICE_DOMAIN_LABEL: "d", sm.SLICE_HOST_ID_LABEL: str(h)})))

        def seats():
            return sorted(d.basic.attributes["workerId"].value
                          for s in mock.server.list("ResourceSlice") for d in s.spec.devices)

        wait(lambda: seats() == [0, 1, 2], "three seats")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        after = seats()
        leases = [(x.spec.holder_identity, x.spec.renew_time) for x in mock.server.list("Lease")]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        mock._closing.set()
        mock.stop()
    reader.join(timeout=10)
    assert "Traceback" not in "".join(lines)
    if leader_elect:  # a handover keeps the seats for the next leader
        assert after == [0, 1, 2] and leases == [("", "")]
    else:  # a lone controller's shutdown deletes its owned slices
        assert after == [] and leases == []
