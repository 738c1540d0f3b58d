"""Metric primitives: counters, gauges and log-bucketed streaming
histograms (``repro.obs.metrics``, copied).

The registry (`Metrics`) keys every instrument by ``(kind, name, labels)``
where ``labels`` is a sorted tuple of ``(key, value)`` pairs — per-tenant
series are just the same metric name with a ``client=`` / ``job=`` label.
Everything is host-side pure-python bookkeeping: observing a value never
touches a device array, so telemetry cannot introduce device syncs or new
jit traces.

Histograms are streaming and log-2 bucketed: bucket ``i`` holds values in
``(LO * 2**(i-1), LO * 2**i]`` with ``LO = 1e-6`` (1 microsecond), bucket 0
holds everything ``<= LO``.  Percentiles report the upper edge of the bucket
containing the rank — deterministic, O(#buckets) memory, and accurate to
2x which is all a latency SLO needs.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

LabelKey = Tuple[Tuple[str, object], ...]


class Counter:
    """Monotonically increasing count (tokens, admissions, faults)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0

    def inc(self, amount: float = 1) -> None:
        self.value += amount


class Gauge:
    """Point-in-time level (free pages, committed HBM bytes)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0.0

    def set(self, value: float) -> None:
        self.value = value

    def add(self, delta: float) -> None:
        self.value += delta


class Histogram:
    """Log-2 bucketed streaming histogram with exact count/sum/min/max."""

    __slots__ = ("counts", "n", "total", "vmin", "vmax")

    #: lower edge of bucket 0 — 1 microsecond, fine enough for tick phases.
    LO = 1e-6

    def __init__(self) -> None:
        self.counts: Dict[int, int] = {}
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        i = 0 if v <= self.LO else int(math.ceil(math.log2(v / self.LO)))
        self.counts[i] = self.counts.get(i, 0) + 1
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    @classmethod
    def upper_edge(cls, bucket: int) -> float:
        return cls.LO * (2.0 ** bucket)

    def percentile(self, p: float) -> float:
        """Upper edge of the bucket holding the p-th percentile rank.

        Clamped to the exact observed max so p100 is exact.
        """
        if self.n == 0:
            return 0.0
        rank = max(1, int(math.ceil(self.n * p / 100.0)))
        cum = 0
        for i in sorted(self.counts):
            cum += self.counts[i]
            if cum >= rank:
                return min(self.upper_edge(i), self.vmax)
        return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def merge(self, other: "Histogram") -> "Histogram":
        for i, c in other.counts.items():
            self.counts[i] = self.counts.get(i, 0) + c
        self.n += other.n
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted(labels.items()))


class Metrics:
    """Registry of labeled instruments.

    ``counter/gauge/histogram`` are get-or-create so call sites stay a single
    line; instruments are plain attribute bumps after the dict lookup.
    """

    def __init__(self) -> None:
        self._data: Dict[Tuple[str, str, LabelKey], object] = {}

    def _get(self, kind: str, cls, name: str, labels: Dict[str, object]):
        key = (kind, name, _label_key(labels))
        inst = self._data.get(key)
        if inst is None:
            inst = self._data[key] = cls()
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", Histogram, name, labels)

    def merged_histogram(self, name: str) -> Histogram:
        """One histogram folding together every label set under ``name``."""
        out = Histogram()
        for (kind, n, _), inst in self._data.items():
            if kind == "histogram" and n == name:
                out.merge(inst)
        return out

    def samples(self) -> List[dict]:
        """Flat, JSON-ready dump of every instrument (sorted, deterministic)."""
        rows: List[dict] = []
        for (kind, name, labels) in sorted(self._data, key=lambda k: (k[1], k[0], k[2])):
            inst = self._data[(kind, name, labels)]
            row = {"metric": name, "type": kind, "labels": {k: v for k, v in labels}}
            if kind == "histogram":
                h: Histogram = inst  # type: ignore[assignment]
                row.update(
                    count=h.n,
                    sum=h.total,
                    min=(None if h.n == 0 else h.vmin),
                    max=(None if h.n == 0 else h.vmax),
                    buckets={str(i): h.counts[i] for i in sorted(h.counts)},
                    p50=h.percentile(50),
                    p99=h.percentile(99),
                )
            else:
                row["value"] = inst.value  # type: ignore[union-attr]
            rows.append(row)
        return rows
