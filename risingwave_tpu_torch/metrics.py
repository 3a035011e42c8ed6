"""Metrics kernel — counters/histograms with labels.

Port of the registry half of ``risingwave_tpu/metrics.py`` (:1-177,
``REGISTRY`` :591), host only: what ``resilience.py``, ``event_log.py``
and the checkpoint layer record into. The dashboard, the HTTP endpoint
and the recompile counters are not ported.

Reference: src/common/metrics/ (prometheus registry + label-guarded
metrics, guarded_metrics.rs) and the per-executor ``StreamingMetrics``
struct (src/stream/src/executor/monitor/streaming_stats.rs:44).

v0: an in-process registry with the prometheus text exposition format
(``render()``), no HTTP endpoint yet. Counters are plain floats on the
host — metric updates must NEVER force a device sync, so executors
record shapes/capacities and host-side timings only.
"""

from __future__ import annotations

import threading
from collections import defaultdict, deque
from typing import Dict, Tuple

import numpy as np

_Labels = Tuple[Tuple[str, str], ...]


def _labels(kv: Dict[str, str]) -> _Labels:
    return tuple(sorted(kv.items()))


class Counter:
    def __init__(self, registry, name: str):
        self.name = name
        self._values: Dict[_Labels, float] = defaultdict(float)
        self._lock = registry._lock

    def inc(self, value: float = 1.0, **labels: str) -> None:
        with self._lock:
            self._values[_labels(labels)] += value

    def get(self, **labels: str) -> float:
        return self._values.get(_labels(labels), 0.0)

    def total(self) -> float:
        """Sum across every label set, snapshotted under the registry
        lock (safe against a hot-path label insertion mid-iteration) —
        the public surface forensic readers use instead of touching
        ``_values`` directly."""
        with self._lock:
            return sum(self._values.values())


class Histogram:
    """Windowed histogram: quantiles come from a bounded per-label-set
    reservoir (deque of the most recent ``window`` observations) while
    ``_count``/``_sum`` stay exact monotonic totals — a long-running
    node's memory no longer grows with every observation (previously an
    unbounded list per label set)."""

    DEFAULT_WINDOW = 4096

    def __init__(self, registry, name: str, window: int = None):
        self.name = name
        self.window = window or self.DEFAULT_WINDOW
        self._obs: Dict[_Labels, deque] = {}
        self._count: Dict[_Labels, int] = defaultdict(int)
        self._sum: Dict[_Labels, float] = defaultdict(float)
        self._lock = registry._lock

    def observe(self, value: float, **labels: str) -> None:
        key = _labels(labels)
        with self._lock:
            dq = self._obs.get(key)
            if dq is None:
                dq = self._obs[key] = deque(maxlen=self.window)
            dq.append(value)
            self._count[key] += 1
            self._sum[key] += value

    def percentile(self, q: float, **labels: str) -> float:
        obs = self._obs.get(_labels(labels))
        return float(np.percentile(obs, q)) if obs else 0.0

    def count(self, **labels: str) -> int:
        return self._count.get(_labels(labels), 0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{label-string: {p50, p99, count, sum}} across every label
        set — the bench's per-stage breakdown surface."""
        with self._lock:
            keys = list(self._obs)
        out = {}
        for key in keys:
            obs = list(self._obs.get(key, ()))
            if not obs:
                continue
            lbl = ",".join(f"{k}={v}" for k, v in key) or "-"
            out[lbl] = {
                "p50": round(float(np.percentile(obs, 50)), 3),
                "p99": round(float(np.percentile(obs, 99)), 3),
                "count": self._count.get(key, len(obs)),
                "sum": round(self._sum.get(key, 0.0), 3),
            }
        return out


class Gauge:
    def __init__(self, registry, name: str):
        self.name = name
        self._values: Dict[_Labels, float] = defaultdict(float)
        self._lock = registry._lock

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_labels(labels)] = value

    def get(self, **labels: str) -> float:
        return self._values.get(_labels(labels), 0.0)


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, Counter] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.gauges: Dict[str, Gauge] = {}
        self._server = None

    def counter(self, name: str) -> Counter:
        if name not in self.counters:
            self.counters[name] = Counter(self, name)
        return self.counters[name]

    def histogram(self, name: str) -> Histogram:
        if name not in self.histograms:
            self.histograms[name] = Histogram(self, name)
        return self.histograms[name]

    def gauge(self, name: str) -> Gauge:
        if name not in self.gauges:
            self.gauges[name] = Gauge(self, name)
        return self.gauges[name]

    def render(self) -> str:
        """Prometheus text exposition."""
        lines = []
        for name, c in sorted(self.counters.items()):
            lines.append(f"# TYPE {name} counter")
            for labels, v in sorted(c._values.items()):
                lbl = ",".join(f'{k}="{val}"' for k, val in labels)
                lines.append(f"{name}{{{lbl}}} {v}" if lbl else f"{name} {v}")
        for name, g in sorted(self.gauges.items()):
            lines.append(f"# TYPE {name} gauge")
            for labels, v in sorted(g._values.items()):
                lbl = ",".join(f'{k}="{val}"' for k, val in labels)
                lines.append(f"{name}{{{lbl}}} {v}" if lbl else f"{name} {v}")
        for name, h in sorted(self.histograms.items()):
            lines.append(f"# TYPE {name} summary")
            for labels, obs in sorted(h._obs.items()):
                lbl = ",".join(f'{k}="{val}"' for k, val in labels)
                base = f"{name}{{{lbl}}}" if lbl else name
                win = list(obs)  # quantiles over the bounded window
                for q in (0.5, 0.9, 0.99):
                    ql = (
                        f'{{{lbl},quantile="{q}"}}'
                        if lbl
                        else f'{{quantile="{q}"}}'
                    )
                    lines.append(
                        f"{name}{ql} {float(np.percentile(win, q * 100))}"
                    )
                # count/sum are exact totals (monotonic), not windowed
                lines.append(f"{base}_count {h._count.get(labels, len(win))}")
                lines.append(f"{base}_sum {h._sum.get(labels, sum(win))}")
        return "\n".join(lines) + "\n"

    render_prometheus = render


REGISTRY = MetricsRegistry()

