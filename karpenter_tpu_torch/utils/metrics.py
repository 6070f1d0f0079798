"""Minimal Prometheus-style metrics registry (no external dependency).

Ref: pkg/metrics/constants.go — namespace "karpenter", duration buckets
matching controller-runtime; gauges/histograms rendered in text exposition
format for scraping.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Sequence, Tuple

NAMESPACE = "karpenter"

# ref: metrics.DurationBuckets — 5ms..60s ramp used by the reference.
DURATION_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.45,
    0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.25, 1.5, 1.75, 2.0, 2.5, 3.0, 4.0, 5.0,
    6.0, 7.0, 8.0, 9.0, 10.0, 15.0, 20.0, 25.0, 30.0, 40.0, 50.0, 60.0,
)

LabelValues = Tuple[str, ...]


def escape_label_value(value) -> str:
    """Text-exposition-format escaping for label VALUES: backslash, double
    quote, and newline must be escaped or the rendered line is malformed and
    the whole /metrics page fails to parse (Prometheus exposition spec §
    'Comments, help text, and type information'). Reason strings routinely
    carry quotes (exception reprs) — they flow in via sweep_failures_total."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def render_labels(names: Sequence[str], values: LabelValues) -> str:
    """'k1="v1",k2="v2"' with values escaped — the one label serializer both
    metric types render through, so escaping cannot drift between them."""
    return ",".join(
        f'{n}="{escape_label_value(v)}"' for n, v in zip(names, values)
    )


class _Timer:
    """Histogram.measure() context manager, hoisted to module level — the
    previous closure built a fresh class object per measured block, which at
    one measure per reconcile was real storm-path overhead."""

    __slots__ = ("_histogram", "_labels", "start")

    def __init__(self, histogram: "Histogram", labels: LabelValues):
        self._histogram = histogram
        self._labels = labels

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._histogram.observe(time.perf_counter() - self.start, *self._labels)
        return False


class Gauge:
    metric_type = "gauge"

    def __init__(self, name: str, help_text: str, labels: Sequence[str] = ()):
        self.name = name
        self.help = help_text
        self.label_names = tuple(labels)
        self._values: Dict[LabelValues, float] = {}  # vet: guarded-by(self._lock)
        self._lock = threading.Lock()

    def set(self, value: float, *label_values: str) -> None:
        with self._lock:
            self._values[tuple(label_values)] = value

    def inc(self, *label_values: str, amount: float = 1.0) -> None:
        with self._lock:
            key = tuple(label_values)
            self._values[key] = self._values.get(key, 0.0) + amount

    def get(self, *label_values: str) -> float:
        with self._lock:
            return self._values.get(tuple(label_values), 0.0)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    def remove_where(self, predicate) -> None:
        """Drop series whose label tuple matches — lets pollers clear stale
        series (a vanished zone must not keep reporting its last count)."""
        with self._lock:
            for key in [k for k in self._values if predicate(k)]:
                del self._values[key]

    def render(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.metric_type}",
        ]
        with self._lock:
            for label_values, value in sorted(self._values.items()):
                if self.label_names:
                    labels = render_labels(self.label_names, label_values)
                    lines.append(f"{self.name}{{{labels}}} {value}")
                else:
                    # Label-free series (e.g. backend_probe_result) render
                    # without the empty brace pair.
                    lines.append(f"{self.name} {value}")
        return lines


class Counter(Gauge):
    """Monotonic counter: inc() only, rendered with the counter type so
    rate()/increase() work in PromQL."""

    metric_type = "counter"

    def set(self, value: float, *label_values: str) -> None:
        raise TypeError(f"{self.name} is a Counter; use inc(), not set()")


class Histogram:
    def __init__(
        self,
        name: str,
        help_text: str,
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DURATION_BUCKETS,
    ):
        self.name = name
        self.help = help_text
        self.label_names = tuple(labels)
        self.buckets = tuple(buckets)
        self._counts: Dict[LabelValues, List[int]] = {}  # vet: guarded-by(self._lock)
        self._sums: Dict[LabelValues, float] = {}  # vet: guarded-by(self._lock)
        self._totals: Dict[LabelValues, int] = {}  # vet: guarded-by(self._lock)
        self._lock = threading.Lock()

    def observe(self, value: float, *label_values: str) -> None:
        # Per-bin (non-cumulative) storage, one bisect per observe: every
        # reconcile crosses this under a process-wide lock, and an O(buckets)
        # loop here convoys the 8-way selection pool during a pod storm
        # (sampled as the single largest busy stack in bench_pod_storm).
        # render() restores Prometheus's cumulative view.
        key = tuple(label_values)
        index = bisect.bisect_left(self.buckets, value)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
            counts[index] += 1  # index == len(buckets) → the +Inf bin
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def observe_many(self, values: Sequence[float], *label_values: str) -> None:
        """Record a batch of observations under ONE lock acquisition — the
        reconcile loops observe per-key durations chunk-at-a-time so a
        128-thread pool doesn't convoy on this lock (one acquire per chunk
        instead of per reconcile)."""
        if not values:
            return
        key = tuple(label_values)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
            total = 0.0
            for value in values:
                counts[bisect.bisect_left(self.buckets, value)] += 1
                total += value
            self._sums[key] = self._sums.get(key, 0.0) + total
            self._totals[key] = self._totals.get(key, 0) + len(values)

    def measure(self, *label_values: str):
        """Context manager timing a block (ref: metrics.Measure defer-timer)."""
        return _Timer(self, label_values)

    def count(self, *label_values: str) -> int:
        with self._lock:
            return self._totals.get(tuple(label_values), 0)

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            for key, counts in sorted(self._counts.items()):
                base = render_labels(self.label_names, key)
                sep = "," if base else ""
                running = 0
                for bound, count in zip(self.buckets, counts):
                    running += count
                    lines.append(
                        f'{self.name}_bucket{{{base}{sep}le="{bound}"}} {running}'
                    )
                lines.append(
                    f'{self.name}_bucket{{{base}{sep}le="+Inf"}} {self._totals[key]}'
                )
                lines.append(f"{self.name}_sum{{{base}}} {self._sums[key]}")
                lines.append(f"{self.name}_count{{{base}}} {self._totals[key]}")
        return lines


class Registry:
    def __init__(self):
        self._metrics: List = []  # vet: guarded-by(self._lock)
        self._lock = threading.Lock()

    def gauge(self, name: str, help_text: str, labels: Sequence[str] = ()) -> Gauge:
        metric = Gauge(f"{NAMESPACE}_{name}", help_text, labels)
        with self._lock:
            self._metrics.append(metric)
        return metric

    def counter(self, name: str, help_text: str, labels: Sequence[str] = ()) -> Counter:
        metric = Counter(f"{NAMESPACE}_{name}", help_text, labels)
        with self._lock:
            self._metrics.append(metric)
        return metric

    def histogram(
        self, name: str, help_text: str, labels: Sequence[str] = (), buckets=DURATION_BUCKETS
    ) -> Histogram:
        metric = Histogram(f"{NAMESPACE}_{name}", help_text, labels, buckets)
        with self._lock:
            self._metrics.append(metric)
        return metric

    def render(self) -> str:
        lines: List[str] = []
        with self._lock:
            for metric in self._metrics:
                lines.extend(metric.render())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()
