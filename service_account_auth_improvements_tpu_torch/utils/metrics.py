"""Minimal Prometheus client: counters, gauges, histograms + text format.

The port's own copy of the subset of
``service_account_auth_improvements_tpu/controlplane/metrics/registry.py``
that the serving path uses (the port imports nothing of the JAX package).
Rendering is byte-for-byte the same as the original's.
"""

from __future__ import annotations

import threading


def escape_label_value(value: str) -> str:
    """Escape a label value per the Prometheus text exposition format."""
    return (str(value)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n"))


def escape_help(text: str) -> str:
    """HELP lines escape backslash and line-feed (quotes are legal)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def format_labels(names, values) -> str:
    """``{a="x",b="y"}`` (or "" for the unlabeled series)."""
    if not values:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in zip(names, values)
    )
    return "{" + inner + "}"


class Registry:
    def __init__(self):
        self._metrics: list[_Metric] = []
        self._lock = threading.Lock()

    def register(self, m: "_Metric"):
        with self._lock:
            if any(existing.name == m.name for existing in self._metrics):
                raise ValueError(
                    f"duplicate metric name {m.name!r} in registry"
                )
            self._metrics.append(m)

    def render(self) -> str:
        with self._lock:
            return "\n".join(m.render() for m in self._metrics) + "\n"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str = "", labels: tuple = (),
                 *, registry: Registry):
        self.name = name
        self.help = help_
        self.label_names = tuple(labels)
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()
        registry.register(self)

    def labels(self, *values) -> "_Child":
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: want {len(self.label_names)} labels"
            )
        return _Child(self, tuple(str(v) for v in values))

    def _add(self, key: tuple, amount: float):
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def render(self) -> str:
        lines = [
            f"# HELP {self.name} {escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        with self._lock:
            items = sorted(self._values.items())
            if not items and not self.label_names:
                items = [((), 0.0)]
            for values, v in items:
                lines.append(
                    f"{self.name}{format_labels(self.label_names, values)}"
                    f" {v}"
                )
        return "\n".join(lines)


class _Child:
    def __init__(self, metric: _Metric, values: tuple):
        self.metric = metric
        self.values = values

    def inc(self, amount: float = 1.0):
        self.metric._add(self.values, amount)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0):
        self._add((), amount)

    def _add(self, key: tuple, amount: float):
        if amount < 0:
            # counters are monotonic; a decrement would read as a reset
            raise ValueError(f"{self.name}: counters can only increase")
        super()._add(key, amount)


class Gauge(_Metric):
    kind = "gauge"

    def inc(self, amount: float = 1.0):
        self._add((), amount)


class Histogram(_Metric):
    kind = "histogram"
    DEFAULT_BUCKETS = (
        0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60,
    )

    def __init__(self, name, help_="", labels=(), buckets=None, *,
                 registry: Registry):
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._counts: dict[tuple, list] = {}
        self._sums: dict[tuple, float] = {}
        super().__init__(name, help_, labels, registry=registry)

    def observe(self, value: float):
        with self._lock:
            counts = self._counts.setdefault(
                (), [0] * (len(self.buckets) + 1)
            )
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            counts[-1] += 1
            self._sums[()] = self._sums.get((), 0.0) + value

    def render(self) -> str:
        lines = [
            f"# HELP {self.name} {escape_help(self.help)}",
            f"# TYPE {self.name} histogram",
        ]
        bucket_names = self.label_names + ("le",)
        with self._lock:
            for key in sorted(self._counts):
                counts = self._counts[key]  # already cumulative per bucket
                for i, b in enumerate(self.buckets):
                    lines.append(
                        f"{self.name}_bucket"
                        f"{format_labels(bucket_names, key + (b,))} "
                        f"{counts[i]}"
                    )
                lines.append(
                    f"{self.name}_bucket"
                    f"{format_labels(bucket_names, key + ('+Inf',))} "
                    f"{counts[-1]}"
                )
                base = format_labels(self.label_names, key)
                lines.append(f"{self.name}_sum{base} {self._sums[key]}")
                lines.append(f"{self.name}_count{base} {counts[-1]}")
        return "\n".join(lines)
