"""The port's CEL subset (``k8s_dra_driver_torch/scheduler/cel.py``) against
the reference's, on the CPU.

The sources: every expression of the reference's ``tests/test_cel.py`` (its
results, its errors, the quantity and short-circuit cases and the regex
guard's patterns; not its 500-deep parse, whose outcome depends on the
recursion limit the test worker runs under), every CEL selector of the
quickstart, selectors and sharing specs under ``demo/specs/``, the
DeviceClass selectors ``install_device_classes`` writes, and seeded random
sources over the reference fuzz's alphabet.  Each is evaluated in both
packages over ``tests/test_cel.py``'s environment and over the ``device``
environment of every device a fake v5e-16 host publishes (each package's
own allocator builds it from its own published slice).  Results must be
equal; a bad expression raises ``CELError`` with the same message in both.
"""

from pathlib import Path

import numpy as np
import pytest
import yaml

import tests.test_cel as ref_cases
from k8s_dra_driver_torch.e2e import harness as port_harness
from k8s_dra_driver_torch.kube import fakeserver as port_fakeserver
from k8s_dra_driver_torch.scheduler import allocator as port_allocator
from k8s_dra_driver_torch.scheduler import cel as port_cel
from k8s_dra_driver_tpu.e2e import harness as ref_harness
from k8s_dra_driver_tpu.kube import fakeserver as ref_fakeserver
from k8s_dra_driver_tpu.scheduler import allocator as ref_allocator
from k8s_dra_driver_tpu.scheduler import cel as ref_cel

SPECS = Path(__file__).resolve().parent.parent / "demo" / "specs"
PACKAGES = {"reference": (ref_cel, ref_harness, ref_allocator, ref_fakeserver),
            "port": (port_cel, port_harness, port_allocator, port_fakeserver)}


def _params(fn) -> list:
    (mark,) = [m for m in fn.pytestmark if m.name == "parametrize"]
    return [p if isinstance(p, str) else p[0] for p in mark.args[1]]


def _reference_sources() -> list[str]:
    evals = _params(ref_cases.test_eval)
    errors = [e for e in _params(ref_cases.test_errors) if len(e) < 400]
    quantity = ["quantity('16Gi')", "quantity('1500M') > quantity('1Gi')",
                "false && unknownVar == 1", "true || unknownVar == 1"]
    target = "'aaaaaaaaaaaaaaaaaaaaaaaaaaaaaa'"
    bad = ["(a+)+b", "(a*)*", "((a+)b)+", "(\\d+)*x", "a" * 300, "(a|a)+", "(a|ab)*x"]
    good = ["'tpu-v5e'.matches('v5e|v6e')", "'tpu-v5e'.matches('tpu-.*')",
            "'tpu-v5e'.matches('^tpu-v[0-9]+e$')", "'abab'.matches('(ab)+')",
            "'xy'.matches('a{2,3}')", "'1+2'.matches('([0-9+])+')"]
    return evals + errors + quantity + [f"{target}.matches('{b}')" for b in bad] + good


def _selectors(node) -> list[str]:
    if isinstance(node, dict):
        out = [node["cel"]["expression"]] if isinstance(node.get("cel"), dict) else []
        return out + [e for v in node.values() for e in _selectors(v)]
    if isinstance(node, list):
        return [e for v in node for e in _selectors(v)]
    return []


def _spec_sources() -> list[str]:
    found: list[str] = []
    for sub in ("quickstart", "selectors", "sharing"):
        for path in sorted((SPECS / sub).glob("*.yaml")):
            for doc in yaml.safe_load_all(path.read_text()):
                found += [e for e in _selectors(doc) if e not in found]
    return found


REFERENCE_SOURCES = _reference_sources()
SPEC_SOURCES = _spec_sources()


def _random_sources(n: int, seed: int = 0) -> list[str]:
    alphabet = list("abcdefghijklmnopqrstuvwxyzSW.att rs[]()'\"0123456789+-*/%&|!<>=,?:_")
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(alphabet, size=int(rng.integers(1, 61)))) for _ in range(n)]


def _outcome(cel, src, env):
    try:
        return ("ok", cel.evaluate(src, env))
    except cel.CELError as exc:
        return ("CELError", str(exc))


def _test_env(cel) -> dict:
    """``tests/test_cel.py``'s ENV in this package's AttrBag."""
    bag = cel.AttrBag
    return {"device": bag(
        driver="tpu.google.com",
        attributes=bag({"tpu.google.com": bag(type="tpu", index=3, productName="tpu-v5e",
                                              healthy=True, shape="2x2")}),
        capacity=bag({"tpu.google.com": bag(hbm="16Gi")}),
    )}


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    """Per package: [(label, env)], ``tests/test_cel.py``'s environment and
    one for each device the host publishes (the allocator's own ``env``)."""
    out = {}
    for name, (cel, harness, allocator, _) in PACKAGES.items():
        cluster = harness.make_cluster(
            hosts=1, topology="v5e-16", work_dir=str(tmp_path_factory.mktemp(name)))
        got = [("test_cel ENV", _test_env(cel))]
        for s in sorted(cluster.server.list("ResourceSlice"), key=lambda s: s.metadata.name):
            for d in s.spec.devices:
                cand = allocator._Candidate(driver=s.spec.driver, pool=s.spec.pool.name, device=d)
                got.append((d.name, cand.env))
        out[name] = got
    assert [label for label, _ in out["reference"]] == [label for label, _ in out["port"]]
    assert [env for _, env in out["reference"]] == [env for _, env in out["port"]]
    assert len(out["port"]) > 8  # the chips and the subslice shapes
    return out


def _compare(envs, sources):
    for src in sources:
        for (label, ref_env), (_, port_env) in zip(envs["reference"], envs["port"]):
            want = _outcome(ref_cel, src, ref_env)
            got = _outcome(port_cel, src, port_env)
            assert got == want, (src, label)


def test_the_sources_were_found():
    assert len(REFERENCE_SOURCES) == 19 + 27 + 4 + 7 + 6
    assert any("healthy" not in s and "productName" in s for s in SPEC_SOURCES)
    assert len(SPEC_SOURCES) >= 5


@pytest.mark.parametrize("src", REFERENCE_SOURCES)
def test_reference_expressions(envs, src):
    _compare(envs, [src])


@pytest.mark.parametrize("src", SPEC_SOURCES)
def test_spec_selectors(envs, src):
    _compare(envs, [src])
    # a spec's selector picks at least one published device of this host
    # or names an attribute this host lacks (an error, a non-match)
    assert any(_outcome(port_cel, src, env)[0] == "ok" for _, env in envs["port"][1:])


def test_device_class_selectors(envs):
    """The selectors ``install_device_classes`` writes, read back from each
    package's API server."""
    exprs = {}
    for name, (_, harness, _, fakeserver) in PACKAGES.items():
        server = fakeserver.InMemoryAPIServer()
        harness.install_device_classes(server)
        exprs[name] = {dc.metadata.name: [s.cel.expression for s in dc.spec.selectors]
                       for dc in server.list("DeviceClass")}
    assert exprs["port"] == exprs["reference"] and len(exprs["port"]) == 4
    _compare(envs, [e for sels in exprs["port"].values() for e in sels])


@pytest.mark.parametrize("seed", range(4))
def test_random_sources(envs, seed):
    _compare(envs, _random_sources(100, seed))


def test_compile_cache_is_bounded_and_shared_by_source():
    assert port_cel._CACHE_CAPACITY == ref_cel._CACHE_CAPACITY
    first = port_cel.compile_expr("1 + 2 == 3")
    assert port_cel.compile_expr("1 + 2 == 3") is first
    for i in range(port_cel._CACHE_CAPACITY + 1):
        port_cel.compile_expr(f"{i} == {i}")
    assert len(port_cel._cache) == port_cel._CACHE_CAPACITY
    assert port_cel.compile_expr("1 + 2 == 3") is not first
