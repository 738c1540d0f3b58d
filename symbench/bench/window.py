"""What a run measured, handed to the metric readers, and the statistics
they share."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np


def percentile(values, q) -> Optional[float]:
    """The ``q``-th percentile (linear between order statistics), None for
    no values."""
    return float(np.percentile(np.asarray(values, float), q)) \
        if len(values) else None


def median(values) -> Optional[float]:
    return float(np.median(np.asarray(values, float))) if len(values) else None


@dataclasses.dataclass
class Tick:
    """One engine tick of the window: its host-clock span, the prefill rows
    it admitted, the decode rows it stepped and their summed context (keys
    attended), and the profiled stretch it fell in ("device", "host", or
    "" when the profiler was off)."""
    t0: float
    t1: float
    prefill_rows: int = 0
    decode_rows: int = 0
    ctx_sum: int = 0
    profiled: str = ""
    prompts: List[int] = dataclasses.field(default_factory=list)
    ctxs: List[int] = dataclasses.field(default_factory=list)
    flops: float = 0.0


@dataclasses.dataclass
class Run:
    """A run's window. ``kind`` is ``serve`` or ``train``; ``mix`` and
    ``arch`` are the traffic and configuration files; ``t0``/``t1`` the
    window's edges on the host clock; ``ticks`` the window's ticks;
    ``flops`` the useful model FLOPs of the work done in it; ``trace`` and
    ``trace_host`` the reduced traces of a traced run's device and host
    stretches (None otherwise); ``peak`` the
    card's peaks (None for a card the table lacks)."""
    kind: str
    cell: str
    arch: dict
    mix: dict
    t0: float
    t1: float
    ticks: List[Tick]
    flops: Optional[float] = None
    trace: Any = None
    trace_host: Any = None
    peak: Optional[dict] = None
    # serving: requests due in the window and those finished in it
    due: List[Any] = dataclasses.field(default_factory=list)
    finished: List[Any] = dataclasses.field(default_factory=list)
    prefill_tokens: int = 0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def untraced_end(self) -> float:
        """Where the window's untraced part ends: the first profiled
        stretch's opening in a traced run (a profiler's cost stays with the
        process once it has run), else the window's end."""
        return self.extra.get("traced_from") or self.t1

    def untraced_ticks(self):
        return [t for t in self.ticks if t.t1 <= self.untraced_end]

    def unprofiled(self):
        """(useful FLOPs, seconds) of the window's untraced part: what a
        rate read in a traced run divides."""
        return (sum(t.flops for t in self.untraced_ticks()),
                self.untraced_end - self.t0)


def tick_summary(ticks) -> str:
    """Host-clock tick times of a window, in a line of the run's log."""
    d = sorted((t.t1 - t.t0) * 1e3 for t in ticks)
    if not d:
        return "none"
    q = lambda f: d[min(len(d) - 1, int(f * len(d)))]
    return (f"n {len(d)} min {d[0]:.1f} p50 {q(0.5):.1f} p90 {q(0.9):.1f} "
            f"max {d[-1]:.1f}")
