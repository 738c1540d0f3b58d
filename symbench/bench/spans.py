"""The program's span records on a device stretch's clock, and what the
``program_span`` readers take from them.

``repro_torch.obs`` keeps one record per span occurrence (name, parent,
start and end in ``time.perf_counter_ns()``, thread, engine and its tick)
and one anchor pair ``(perf_counter_ns, time_ns)`` in its ``Obs``'s span
log; ``repro_torch.obs.latest_span_log()`` keeps the log of the ``Obs``
made last after the run's engine is gone, and the readers take from it the
records that overlap the traced part of the window (a program without it
gives no records, and the readers nothing). A torch profiler's Chrome
trace stamps an event at ``time_ns / 1e3 - baseTimeNanoseconds / 1e3``
microseconds, with one base for every trace of a process (Kineto sets it
once), so the base is read from a short CPU-only session exported when
the readers run, and a record's time ``t`` maps to
``(t - perf0 + wall0 - base) / 1e3``.

The mapping checks itself before any reader uses it: the device stretch's
``Memcpy DtoH`` copies are the losses' copies to the host, which the
engine makes inside its ``device_sync`` span, so each one's runtime
launch must lie inside a mapped ``device_sync``. Its residual is how far
it lies outside the nearest one. When any residual exceeds
``TOLERANCE_US``, or the stretch holds no such copy to check with, the
mapping is refused and every reader returns None: no number rather than a
wrong one. The largest residual is written to standard error.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import tempfile
from typing import Dict, List, Optional

from bench import trace

DTOH = "Memcpy DtoH"
TOLERANCE_US = 50.0
PARTS = ("grads", "optimizer", "between")
ROUTING = ("moe_route", "moe_dispatch", "moe_combine")


@dataclasses.dataclass
class Span:
    """One occurrence, in microseconds of the trace's clock."""
    name: str
    start: float
    end: float
    parent: Optional[int]
    tick: tuple                       # (engine, tick number)


@dataclasses.dataclass
class Mapped:
    spans: Dict[int, Span]            # by record id
    residual_us: float
    copies: int


def mapped(run) -> Optional[Mapped]:
    """The run's span records on its device stretch's clock, or None;
    computed once per run."""
    extra = getattr(run, "extra", None)
    if extra is None:
        return None
    if "spans_mapped" not in extra:
        recorded = records(run) if run.trace is not None else None
        extra["spans_mapped"] = None if not recorded else _map(
            run.trace, recorded, trace_base_ns())
    return extra["spans_mapped"]


def records(run) -> Optional[dict]:
    """``{"anchor", "records"}``: the program's span records (as dicts)
    that overlap the run's traced part, from the last ``Obs``'s span log;
    None for a program that keeps none or a run that traced nothing."""
    from repro_torch import obs
    latest = getattr(obs, "latest_span_log", None)
    log = latest() if latest is not None else None
    t0 = run.extra.get("traced_from")
    if log is None or t0 is None:
        return None
    return {"anchor": log.anchor, "records": [
        r._asdict() for r in log.between(int(t0 * 1e9), int(run.t1 * 1e9))]}


def trace_base_ns() -> Optional[int]:
    """The process's profiler trace base, ``baseTimeNanoseconds`` of a
    short CPU-only session exported now (None where the export lacks
    it)."""
    import torch
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.zeros(1).add_(1)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("baseTimeNanoseconds")
    finally:
        os.remove(path)


def _map(tr, recorded, base_ns) -> Optional[Mapped]:
    if base_ns is None:
        return None
    perf0, wall0 = recorded["anchor"]
    off = wall0 - perf0 - base_ns
    spans = {r["id"]: Span(r["name"], (r["start_ns"] + off) / 1e3,
                           (r["end_ns"] + off) / 1e3, r["parent"],
                           (r["engine"], r["tick"]))
             for r in recorded["records"]}
    syncs = [(s.start, s.end) for s in spans.values()
             if s.name == "device_sync"]
    residuals = []
    for name, start, _, corr in tr.ops:
        if not name.startswith(DTOH) or not tr.t0 <= start <= tr.t1:
            continue
        ts = tr.launch_ts.get(corr)
        residuals.append(math.inf if ts is None else min(
            (max(a - ts, ts - b, 0.0) for a, b in syncs), default=math.inf))
    if not residuals:
        _say("no loss copy in the device stretch to check the mapping "
             "with: span metrics left out")
        return None
    worst = max(residuals)
    _say(f"{len(residuals)} loss copies, largest launch residual from "
         f"device_sync {worst:.3f} us (limit {TOLERANCE_US:g})"
         + ("" if worst <= TOLERANCE_US else ": span metrics left out"))
    if worst > TOLERANCE_US:
        return None
    return Mapped(spans, worst, len(residuals))


def _say(msg):
    print(f"[symbench spans] {msg}", file=sys.stderr, flush=True)


def _part(m: Mapped, s: Optional[Span]) -> str:
    """``grads`` under a forward or backward, ``optimizer`` under an
    optimizer span, else ``between`` (an MoE span counts with its
    ancestor)."""
    while s is not None:
        if s.name in ("forward", "backward"):
            return "grads"
        if s.name == "optimizer":
            return "optimizer"
        s = m.spans.get(s.parent)
    return "between"


def idle_shares(run) -> Optional[Dict[str, float]]:
    """The device stretch's idle time by the part of the step open at each
    gap's midpoint (``trace.idle_gaps`` over the mapped spans, each
    relabelled with its part; ``harness`` counts as ``between``), in
    percent of the stretch's wall time; the three sum to
    ``device_idle_pct``."""
    m = mapped(run)
    if m is None:
        return None
    tr = run.trace
    by_part = dataclasses.replace(tr, spans=[
        (_part(m, s), s.start, s.end) for s in m.spans.values()
        if s.end > tr.t0 and s.start < tr.t1])
    out = dict.fromkeys(PARTS, 0.0)
    for name, seconds in trace.idle_gaps(by_part, top=None):
        part = name[len("host:"):]
        out[part if part in out else "between"] += seconds
    return {k: 100.0 * v / tr.window_s for k, v in out.items()}


def _launched_in(tr, spans_) -> List[tuple]:
    """``trace.launched_in`` over those of the mapped spans that overlap
    the stretch's launches (the records cover the rest of the window
    too)."""
    lo, hi = min(tr.launch_ts.values()), max(tr.launch_ts.values())
    return trace.launched_in(dataclasses.replace(tr, spans=[
        ("in", s.start, s.end) for s in spans_
        if s.end >= lo and s.start <= hi]), "in")


def launches_per_tick(run) -> Optional[float]:
    """Device operations launched inside the ``train_step`` spans of the
    engine ticks whose every train step lies in the device stretch, per
    such tick."""
    m = mapped(run)
    if m is None:
        return None
    tr = run.trace
    steps = [s for s in m.spans.values() if s.name == "train_step"]
    cut = {s.tick for s in steps if s.start < tr.t0 or s.end > tr.t1}
    whole = [s for s in steps if s.tick not in cut]
    ticks = {s.tick for s in whole}
    if not ticks:
        return None
    return len(_launched_in(tr, whole)) / len(ticks)


def routing_share(run) -> Optional[float]:
    """Device time of the operations launched inside the MoE body's
    routing spans (``moe_route``, ``moe_dispatch``, ``moe_combine``) over
    all device time of the stretch, in percent; None without such
    spans."""
    m = mapped(run)
    if m is None:
        return None
    tr = run.trace
    routing = [s for s in m.spans.values() if s.name in ROUTING]
    total = sum(op[2] for op in tr.ops)
    if not routing or not total:
        return None
    return 100.0 * sum(op[2] for op in _launched_in(tr, routing)) / total
