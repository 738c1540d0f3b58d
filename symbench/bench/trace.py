"""The profiler over stretches of the window, and the reduction of their
traces to what the per-layer readers need.

A traced run profiles two stretches one after the other, in the second
half of its window. The device stretch records device activity alone
(CUDA activity: kernels, copies and the runtime calls that launched them),
so the device's busy and idle time, its operations and the kernels'
rooflines are read there; even so its launches cost the host more (about
a fifth more per training tick on the H100, and the cost stays for the
rest of the process once a profiler has run), so a traced run's
host-clock readings come from its ticks before the first stretch. The
first start itself takes seconds, during which an open loop's arrivals
queue: its device stretch opens on their prefill. The host
stretch also records host operations, which slows the host several-fold,
but gives the program's phases (its ``repro_torch.obs/<phase>`` ranges, with telemetry attached),
so the device time launched by a phase and the idle gaps by what the host
was doing are read there. Each trace is exported as Chrome JSON into
``TMPDIR``, read back and deleted once the window has closed. A device
operation is a ``kernel``, ``gpu_memcpy`` or ``gpu_memset`` event; its
launch is the runtime call with the same correlation id. A host stretch is
the ``symbench/traced`` range opened around it. A device stretch runs from
its first device operation (or a marker kernel launched as it opens, when
the trace caught it: kernels launched at once after the profiler starts
can be missed) to the end of a marker kernel launched as it closes.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, List, Tuple

import torch

WINDOW = "symbench/traced"
MARKER = "i1e"             # the marker kernels' op (special.i1e), unused else
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OBS = "repro_torch.obs/"


@dataclasses.dataclass
class Trace:
    """Times in microseconds of the trace's clock."""
    t0: float
    t1: float
    ops: List[Tuple[str, float, float, int]]      # name, start, dur, corr
    launch_ts: Dict[int, float]
    spans: List[Tuple[str, float, float]]         # phase, start, end

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6


class Profiler:
    """``start()`` / ``stop()`` at tick boundaries; ``stop`` exports what was
    recorded into ``TMPDIR`` at once (a device-only trace exported after
    another profiler session has run comes out with every device time 0);
    ``trace()``, after the window has closed, reads, reduces and deletes
    it. ``host`` adds host operations."""

    def __init__(self, host: bool = False):
        self.host_ops = host

    @staticmethod
    def marker():
        torch.special.i1e(torch.ones(1, device="cuda"))

    def start(self):
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if self.host_ops:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.rf = torch.profiler.record_function(WINDOW)
        self.rf.__enter__()
        self.marker()

    def stop(self):
        self.marker()
        torch.cuda.synchronize()
        self.rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        fd, self.path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        self.prof.export_chrome_trace(self.path)
        self.prof = None

    def trace(self) -> Trace:
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)
        return reduce(events)


def reduce(events) -> Trace:
    t0 = t1 = None
    marks = []
    ops, launch, spans = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat == "kernel" and MARKER in name:
            marks.append((ts, ts + dur))
        elif cat in DEVICE_CATS:
            ops.append((name, ts, dur, args.get("correlation", -1)))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launch[args["correlation"]] = ts
        elif cat == "user_annotation":
            if name == WINDOW:
                t0, t1 = ts, ts + dur
            elif name.startswith(OBS):
                spans.append((name[len(OBS):], ts, ts + dur))
    if t0 is None:
        if not marks or not ops:
            raise RuntimeError("the profiler's trace lacks its closing "
                               "marker or any device work")
        t0 = min([m[0] for m in marks] + [o[1] for o in ops])
        t1 = max([m[1] for m in marks] + [o[1] + o[2] for o in ops])
    ops.sort(key=lambda o: o[1])
    return Trace(t0, t1, ops, launch, spans)


def merged(tr: Trace):
    """The union of device activity inside the traced range, as sorted
    disjoint intervals."""
    out = []
    for _, s, d, _ in tr.ops:
        a, b = max(s, tr.t0), min(s + d, tr.t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in merged(tr)) * 1e-6


def idle_gaps(tr: Trace, top: int = 10):
    """Idle device time by what the host was doing: each gap goes to the
    innermost program phase open at its midpoint (``harness`` outside
    them). [[name, seconds], ...], longest first."""
    spans = sorted(tr.spans, key=lambda s: s[2] - s[1])
    edges = [tr.t0] + [x for iv in merged(tr) for x in iv] + [tr.t1]
    by = collections.Counter()
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = next((s[0] for s in spans if s[1] <= mid <= s[2]), "harness")
        by["host:" + name] += (b - a) * 1e-6
    return [[k, v] for k, v in by.most_common(top)]


def device_ops(tr: Trace, top: int = 10, width: int = 120):
    """Device time by operation name, [[name, seconds], ...], most first."""
    by = collections.Counter()
    for name, s, d, _ in tr.ops:
        a, b = max(s, tr.t0), min(s + d, tr.t1)
        if b > a:
            by[name[:width]] += (b - a) * 1e-6
    return [[k, v] for k, v in by.most_common(top)]


def launched_in(tr: Trace, phase: str):
    """Device operations whose launch lies inside a ``phase`` range."""
    ranges = sorted((s[1], s[2]) for s in tr.spans if s[0] == phase)
    out = []
    for op in tr.ops:
        ts = tr.launch_ts.get(op[3])
        if ts is not None and any(a <= ts <= b for a, b in ranges):
            out.append(op)
    return out


def ops_named(tr: Trace, fragments):
    return [op for op in tr.ops if any(f in op[0] for f in fragments)]


class Stretches:
    """A traced run's profiled stretches, one after the other from
    ``begin`` (a share of the window) on: ``plan`` is ((name, host, enough,
    limit_s), ...), where ``enough(counts)`` says when the stretch has seen
    what it needs (``counts``: profiled "prefill" and "decode" ticks, and
    all "ticks") and ``limit_s`` caps its length. Call ``before_tick`` at
    each tick boundary (it returns the stretch the next tick falls in, or
    ""), ``count`` after the tick, and ``finish`` once the window has
    closed."""

    def __init__(self, plan, begin: float = 0.5):
        self.plan, self.begin = list(plan), begin
        self.profilers = {name: Profiler(host) for name, host, _, _ in plan}
        self.i, self.active, self.seconds = 0, None, 0.0
        self.first_start = None

    def before_tick(self, now, t_start, t_end) -> str:
        if self.active is not None:
            name, _, enough, limit = self.plan[self.i]
            if enough(self.counts) or now - self.t0 >= limit or now >= t_end:
                self.profilers[name].stop()
                self.seconds += time.perf_counter() - self.t0
                self.active, self.i = None, self.i + 1
        if self.active is None and self.i < len(self.plan) and \
                now >= t_start + self.begin * (t_end - t_start) and \
                now < t_end:
            self.active = self.plan[self.i][0]
            self.counts = collections.Counter()
            if self.first_start is None:
                self.first_start = time.perf_counter()
            # the first start initialises the tracing for seconds: a
            # stretch's length counts from its return
            self.profilers[self.active].start()
            self.t0 = time.perf_counter()
        return self.active or ""

    def count(self, prefill: bool, decode: bool):
        if self.active is not None:
            self.counts["ticks"] += 1
            self.counts["prefill"] += prefill
            self.counts["decode"] += decode and not prefill

    def finish(self):
        """(traces by stretch name, the host clock when the first stretch
        opened, or None)."""
        if self.active is not None:
            self.profilers[self.active].stop()
            self.active, self.i = None, self.i + 1
        done = [name for name, _, _, _ in self.plan[:self.i]]
        return {name: self.profilers[name].trace() for name in done}, \
            self.first_start
