"""The port's own Prometheus-style metrics registry
(``k8s_dra_driver_tpu/utils/metrics.py``, copied: the port imports nothing
of the JAX package).

Counters, gauges and histograms with labels, rendered in the Prometheus
text exposition format, and ``parse_prom_text``, its inverse.  The
serving engines and ``models/telemetry`` register the reference's
``tpu_serve_*`` families here, under the same names, help strings,
labels and buckets; :data:`REGISTRY` is a separate object from the JAX
package's, so nothing the port records lands there.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field

_DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0
)


def _label_key(labels: dict[str, str] | None) -> tuple:
    return tuple(sorted((labels or {}).items()))


def format_value(v: float) -> str:
    """Render one sample value for the text exposition format.  repr() of
    a Python float is the SHORTEST string that parses back to exactly the
    same double (float(format_value(v)) == v — the precision round-trip
    the parse-back tests pin), and the non-finite spellings are the ones
    the Prometheus text format defines ("+Inf"/"-Inf"/"NaN", not Python's
    "inf"/"nan", which scrapers reject)."""
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(v)


def escape_label_value(value: str) -> str:
    """Prometheus text-exposition escaping for label values: backslash,
    double quote and newline must be escaped or the rendered line is
    unparseable (and a crafted value could inject whole bogus samples)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{escape_label_value(v)}"' for k, v in key) + "}"


@dataclass
class Counter:
    """Mutation and render are lock-protected: a scrape may run on another
    thread while the engine loop updates."""

    name: str
    help: str
    _values: dict[tuple, float] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            out.append(f"{self.name}{_label_str(key)} {format_value(v)}")
        return out


@dataclass
class Gauge:
    name: str
    help: str
    _values: dict[tuple, float] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = value

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            out.append(f"{self.name}{_label_str(key)} {format_value(v)}")
        return out


@dataclass
class Histogram:
    name: str
    help: str
    buckets: tuple = _DEFAULT_BUCKETS
    _counts: dict[tuple, list[int]] = field(default_factory=dict)
    _sums: dict[tuple, float] = field(default_factory=dict)
    _totals: dict[tuple, int] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def __post_init__(self):
        # Normalize declared buckets once so observe/quantile/render agree:
        # sorted, deduplicated, and with non-finite bounds DROPPED — the
        # +Inf bucket is implicit in the exposition format (rendered from
        # _totals), so an explicit float("inf") bound would emit a second,
        # misspelled le="inf" line that scrapers reject.  Original bound
        # objects are kept (not coerced to float) so an int bound 1 still
        # renders le="1", not le="1.0".
        seen: set[float] = set()
        norm = []
        for bound in sorted(self.buckets, key=float):
            fb = float(bound)
            if not math.isfinite(fb) or fb in seen:
                continue
            seen.add(fb)
            norm.append(bound)
        self.buckets = tuple(norm)

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def count(self, **labels) -> int:
        with self._lock:
            return self._totals.get(_label_key(labels), 0)

    def clear(self) -> None:
        with self._lock:
            self._counts.clear()
            self._sums.clear()
            self._totals.clear()

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            keys = sorted(self._totals)
            counts = {k: list(self._counts[k]) for k in keys}
            sums = dict(self._sums)
            totals = dict(self._totals)
        for key in keys:
            for i, bound in enumerate(self.buckets):
                bucket_key = key + (("le", str(bound)),)
                out.append(f"{self.name}_bucket{_label_str(bucket_key)} {counts[key][i]}")
            inf_key = key + (("le", "+Inf"),)
            out.append(f"{self.name}_bucket{_label_str(inf_key)} {totals[key]}")
            out.append(f"{self.name}_sum{_label_str(key)} {format_value(sums[key])}")
            out.append(f"{self.name}_count{_label_str(key)} {totals[key]}")
        return out


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, lambda: Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help))

    def histogram(self, name: str, help: str = "", buckets: tuple = _DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(name, lambda: Histogram(name, help, buckets))

    def _get_or_create(self, name, factory):
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = factory()
            return self._metrics[name]

    def reset(self) -> None:
        """Zero every registered metric's recorded values, KEEPING the
        metric objects: modules bind them at import time (e.g.
        models/serve.py's ``_M_TOKENS``), so dropping the dict would
        silently fork live metrics off the rendered output.  Tests reset
        the registry between cases so their asserts are absolute."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.clear()

    def render(self) -> str:
        with self._lock:
            lines = []
            for metric in self._metrics.values():
                lines.extend(metric.render())
            return "\n".join(lines) + "\n"


def _parse_value(text: str) -> float:
    if text == "+Inf":
        return math.inf
    if text == "-Inf":
        return -math.inf
    if text == "NaN":
        return math.nan
    return float(text)


def _parse_labels(raw: str) -> tuple:
    """Inverse of _label_str's body: scan comma-separated k="v" pairs,
    undoing escape_label_value's three escapes."""
    labels = []
    i, n = 0, len(raw)
    while i < n:
        while i < n and raw[i] in ", ":
            i += 1
        if i >= n:
            break
        eq = raw.index("=", i)
        key = raw[i:eq]
        if eq + 1 >= n or raw[eq + 1] != '"':
            raise ValueError(f"malformed label pair at offset {i}: {raw!r}")
        j = eq + 2
        buf = []
        while j < n and raw[j] != '"':
            if raw[j] == "\\" and j + 1 < n:
                nxt = raw[j + 1]
                buf.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, "\\" + nxt))
                j += 2
            else:
                buf.append(raw[j])
                j += 1
        if j >= n:
            raise ValueError(f"unterminated label value: {raw!r}")
        labels.append((key, "".join(buf)))
        i = j + 1
    return tuple(sorted(labels))


def parse_prom_text(text: str) -> dict[str, dict[tuple, float]]:
    """Parse the text exposition format back into
    ``{metric_name: {label_key: value}}`` — the inverse of
    ``Registry.render()``.  Exists so tests can pin the round-trip
    contract (``parse_prom_text(render())`` recovers every sample value
    exactly, including ``le="+Inf"`` buckets and float sums to the last
    ulp) instead of grepping rendered lines with brittle substrings."""
    out: dict[str, dict[tuple, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            raw, value_part = rest.rsplit("}", 1)
            labels = _parse_labels(raw)
        else:
            name, value_part = line.split(None, 1)
            labels = ()
        out.setdefault(name, {})[labels] = _parse_value(value_part.strip())
    return out


REGISTRY = Registry()
