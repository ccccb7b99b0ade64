"""User metrics: ``Counter``, ``Gauge`` and ``Histogram`` with tag keys.

The port of ``ray_tpu/util/metrics.py``. Metrics register with the
process's ``REGISTRY``; the metrics agent
(``ray_tpu_torch._private.metrics_agent``, started by
``init(metrics_port=...)``) serves them, beside the runtime's own
families, in the Prometheus text format at ``/metrics``. Not ported yet
(ROADMAP item 12): serve's Prometheus collector.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Sequence


class _Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, "Metric"] = {}
        self._collectors: list = []

    def register(self, metric: "Metric") -> None:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None and existing is not metric:
                # Silent replacement would drop the old handle's series
                # from exposition while it keeps accumulating invisibly.
                raise ValueError(
                    f"Metric {metric.name!r} is already registered; "
                    f"reuse the existing instance")
            self._metrics[metric.name] = metric

    def add_collector(self, fn):
        """fn() -> list[str] of exposition lines, called per scrape.
        Returns a callable that deregisters the collector."""
        with self._lock:
            self._collectors.append(fn)

        def remove():
            with self._lock:
                try:
                    self._collectors.remove(fn)
                except ValueError:
                    pass

        return remove

    def scrape(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        lines: list[str] = []
        for metric in metrics:
            lines.extend(metric._expose())
        for fn in collectors:
            try:
                lines.extend(fn())
            except Exception:
                import logging

                logging.getLogger("ray_tpu_torch").exception(
                    "metrics collector %r failed during scrape", fn)
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()


REGISTRY = _Registry()


def _escape_label(value: str) -> str:
    """Prometheus text format: \\, ", and newline must be escaped in
    label values or the whole scrape fails to parse."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_tags(tags: dict[str, str] | None) -> str:
    if not tags:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(tags.items()))
    return "{" + inner + "}"


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] | None = None):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._lock = threading.Lock()
        self._default_tags: dict[str, str] = {}
        REGISTRY.register(self)

    def set_default_tags(self, tags: dict[str, str]) -> None:
        with self._lock:
            self._default_tags = dict(tags)

    def _merge(self, tags: dict[str, str] | None) -> tuple:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        extra = set(merged) - set(self.tag_keys)
        if extra:
            raise ValueError(
                f"Unknown tag(s) {sorted(extra)} for metric {self.name!r}; "
                f"declared tag_keys={list(self.tag_keys)}")
        return tuple(sorted(merged.items()))


class Counter(Metric):
    """A monotonic counter."""

    def __init__(self, name, description="", tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._values: dict[tuple, float] = defaultdict(float)

    def inc(self, value: float = 1.0, tags: dict | None = None) -> None:
        if value < 0:
            raise ValueError("Counter increments must be non-negative")
        key = self._merge(tags)
        with self._lock:
            self._values[key] += value

    def _expose(self) -> list[str]:
        with self._lock:
            items = list(self._values.items())
        lines = [f"# HELP {self.name} {self.description}",
                 f"# TYPE {self.name} counter"]
        for key, value in items:
            lines.append(f"{self.name}{_fmt_tags(dict(key))} {value}")
        return lines


class Gauge(Metric):
    """A point-in-time value."""

    def __init__(self, name, description="", tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, tags: dict | None = None) -> None:
        key = self._merge(tags)
        with self._lock:
            self._values[key] = float(value)

    def _expose(self) -> list[str]:
        with self._lock:
            items = list(self._values.items())
        lines = [f"# HELP {self.name} {self.description}",
                 f"# TYPE {self.name} gauge"]
        for key, value in items:
            lines.append(f"{self.name}{_fmt_tags(dict(key))} {value}")
        return lines


class Histogram(Metric):
    """A bucketed distribution."""

    def __init__(self, name, description="", boundaries=None, tag_keys=None):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries or
                                 (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                                  1.0, 2.5, 5.0, 10.0))
        self._buckets: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = defaultdict(float)
        self._counts: dict[tuple, int] = defaultdict(int)

    def observe(self, value: float, tags: dict | None = None) -> None:
        key = self._merge(tags)
        with self._lock:
            buckets = self._buckets.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            for i, bound in enumerate(self.boundaries):
                if value <= bound:
                    buckets[i] += 1
                    break
            else:
                buckets[-1] += 1
            self._sums[key] += value
            self._counts[key] += 1

    def _expose(self) -> list[str]:
        with self._lock:
            keys = list(self._buckets)
            snapshot = {k: (list(self._buckets[k]), self._sums[k],
                            self._counts[k]) for k in keys}
        lines = [f"# HELP {self.name} {self.description}",
                 f"# TYPE {self.name} histogram"]
        for key, (buckets, total, count) in snapshot.items():
            tags = dict(key)
            cumulative = 0
            for bound, n in zip(self.boundaries, buckets):
                cumulative += n
                lines.append(
                    f"{self.name}_bucket"
                    f"{_fmt_tags({**tags, 'le': str(bound)})} {cumulative}")
            cumulative += buckets[-1]
            lines.append(
                f"{self.name}_bucket{_fmt_tags({**tags, 'le': '+Inf'})} "
                f"{cumulative}")
            lines.append(f"{self.name}_sum{_fmt_tags(tags)} {total}")
            lines.append(f"{self.name}_count{_fmt_tags(tags)} {count}")
        return lines
