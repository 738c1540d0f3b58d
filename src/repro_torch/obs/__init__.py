"""repro_torch.obs — tick-level telemetry of the port's engines
(``repro.obs``).

One ``Obs`` object bundles the three telemetry surfaces and is passed to the
engines as ``obs=`` (``ServingEngine`` / ``FinetuneEngine`` /
``SymbiosisEngine.from_spec``):

- ``obs.metrics``: labeled counters, gauges and log-bucketed histograms
  (per-tenant tokens, pages, memory charges, queue wait, time to first
  token, inter-token latency; the engines' ``stats`` dicts are mirrored in
  as gauges at snapshot time, ``stats`` staying the compatibility view).
- ``obs.span(name)``: reusable tick-phase spans that open a
  ``torch.profiler.record_function`` range and feed per-phase latency
  histograms; ``obs.trace_span(name)`` the trace-only spans inside a
  phase (the train step's forward, backward and optimizer, the MoE
  body's parts), which feed no histogram.
- ``obs.span_log``: every span's occurrences (name, parent, start, end,
  thread, engine and tick) in a bounded buffer, with the count of those
  dropped and a ``(perf_counter_ns, time_ns)`` anchor;
  ``span_log.between(t0_ns, t1_ns)`` returns those of a stretch;
  ``latest_span_log()`` the log of the ``Obs`` made last, which outlives
  it, so an in-process reader (a benchmark) takes a run's records after
  the run's engines are gone.
- ``obs.events`` / ``obs.event(...)``: the structured, drainable event log
  (client-visible through ``engine.drain_events(client=...)``).

Contracts (``tests/test_torch_obs.py``, ``chip_smoke.py`` phase 12):

- ``obs=None`` (the default) is a hard no-op: the engines' tick loops see
  only ``if self._obs is not None`` guards and one shared null context,
  and this package is never imported on that path.
- Enabled telemetry adds no device synchronisation inside a tick (every
  timestamp is a host ``perf_counter`` at a tick or phase boundary), no
  kernel launch and no new step or bucket, and leaves the engines'
  outputs bit for bit unchanged.
- The feed is JAX's: the same workload gives the same events and the same
  counter and gauge values, and the exports are byte for byte JAX's files.
  Trace-only spans and the span log are outside it: they add no metric
  series and nothing exported.

``obs.request_capture(log_dir, ticks=N)`` arms a ``torch.profiler``
capture of the next N engine ticks (a Chrome trace in ``log_dir``).
Export with ``repro_torch.obs.export`` (JSONL and Prometheus text) or the
``python -m repro_torch.obs`` CLI.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.events import UNSET, Event, EventLog
from repro_torch.obs.metrics import Counter, Gauge, Histogram, Metrics
from repro_torch.obs.trace import CaptureWindow, Span, SpanLog, SpanRecord

__all__ = [
    "Obs", "Metrics", "Counter", "Gauge", "Histogram",
    "Event", "EventLog", "Span", "SpanLog", "SpanRecord", "CaptureWindow",
    "UNSET", "write_files", "latest_span_log",
]

MAX_SPANS = 65536   # span occurrences the span log keeps
_LATEST: List[SpanLog] = []   # the span log of the Obs made last


def latest_span_log() -> Optional[SpanLog]:
    """The span log of the ``Obs`` made last in this process (kept after
    that ``Obs`` and its engines are gone, until the next ``Obs``), None
    before any."""
    return _LATEST[-1] if _LATEST else None


def write_files(obs: "Obs", out_dir: str) -> Tuple[str, str]:
    """Write ``obs`` as ``telemetry.jsonl`` and ``metrics.prom`` into
    ``out_dir`` (what both CLIs' ``--obs DIR`` leave); returns the paths."""
    from repro_torch.obs import export
    os.makedirs(out_dir, exist_ok=True)
    return (export.write_jsonl(os.path.join(out_dir, "telemetry.jsonl"), obs),
            export.write_prometheus(os.path.join(out_dir, "metrics.prom"),
                                    obs))


class Obs:
    """Telemetry facade shared by (possibly several) engines."""

    def __init__(self, *, max_events: int = 10000) -> None:
        self.metrics = Metrics()
        self.events = EventLog(maxlen=max_events)
        self.span_log = SpanLog(maxlen=MAX_SPANS)
        _LATEST[:] = [self.span_log]
        self._spans: Dict[str, Span] = {}
        self._trace_spans: Dict[str, Span] = {}
        self._engines: Dict[str, object] = {}
        self._capture = CaptureWindow()
        self._compiled: set = set()

    # -- engine registration / stats compatibility view ------------------
    def attach(self, label: str, engine) -> str:
        """Register an engine so snapshots mirror its ``stats`` dict."""
        base, n = label, 1
        while label in self._engines and self._engines[label] is not engine:
            n += 1
            label = f"{base}_{n}"
        self._engines[label] = engine
        return label

    def sync_stats(self) -> None:
        """Mirror every attached engine's ``stats`` dict into gauges,
        ``engine_stat{engine=...,key=...}`` (``stats`` stays the
        authoritative view: checkpoints round-trip it)."""
        for label, eng in self._engines.items():
            for k, v in getattr(eng, "stats", {}).items():
                self.metrics.gauge("engine_stat", engine=label, key=k).set(v)

    # -- spans / tick boundaries -----------------------------------------
    def span(self, name: str) -> Span:
        """The span of tick phase ``name``: its occurrences go to the span
        log, its durations to ``span_seconds{phase=name}``."""
        sp = self._spans.get(name)
        if sp is None:
            sp = self._spans[name] = Span(
                name, self.metrics.histogram("span_seconds", phase=name),
                self.span_log)
        return sp

    def trace_span(self, name: str) -> Span:
        """A trace-only span (a part of a phase): its occurrences go to the
        span log and nowhere else, so the feed stays JAX's."""
        sp = self._trace_spans.get(name)
        if sp is None:
            sp = self._trace_spans[name] = Span(name, None, self.span_log)
        return sp

    def tick_start(self, engine: str, tick: int) -> float:
        """Tick ``tick`` of ``engine`` starts: the span log stamps both on
        the occurrences that follow."""
        self.span_log.tick = (engine, tick)
        dev = getattr(self._engines.get(engine), "device", None)
        kind = self._capture.on_tick_start(
            cuda=getattr(dev, "type", None) == "cuda")
        if kind is not None:
            self.event(kind, engine=engine, log_dir=self._capture.log_dir or "")
        return time.perf_counter()

    def tick_end(self, engine: str, tick: int, t0: float) -> None:
        self.metrics.histogram("tick_seconds", engine=engine).observe(
            time.perf_counter() - t0)
        kind = self._capture.on_tick_end()
        if kind is not None:
            self.event(kind, engine=engine, tick=tick)

    def request_capture(self, log_dir: str, ticks: int = 1) -> None:
        """Arm a one-shot profiler capture for the next ``ticks`` engine ticks."""
        self._capture.request(log_dir, ticks)

    @property
    def capture_path(self) -> Optional[str]:
        """The Chrome trace the last capture window wrote (None before)."""
        return self._capture.trace_path

    # -- events -----------------------------------------------------------
    def event(self, kind: str, **kw) -> Event:
        return self.events.emit(kind, **kw)

    def drain_events(self, *, client=UNSET, kind: Optional[str] = None,
                     engine: Optional[str] = None) -> List[Event]:
        """Destructive filtered drain (client= filters the tenant field)."""
        return self.events.drain(tenant=client, kind=kind, engine=engine)

    # -- step-build hook ---------------------------------------------------
    def on_dispatch_compile(self, owner, family: str, key, epoch: int) -> None:
        """Report that a hot-path step of ``owner`` was built (JAX: a jitted
        function grew its cache). The first sighting of (owner, epoch,
        family, key) is a ``compile`` event, a repeat a ``recompile``; each
        bumps ``jit_compiles_total`` / ``jit_recompiles_total``. Its
        caller is ``analysis.tracecount.dispatch``, as in JAX."""
        sig = (id(owner), epoch, family, repr(key))
        kind = "compile" if sig not in self._compiled else "recompile"
        self._compiled.add(sig)
        self.metrics.counter(f"jit_{kind}s_total", family=family).inc()
        # the owner's attach label ("serving" / "finetune"), so engine-
        # filtered drains include the event; unattached owners fall back to
        # their class name
        label = next((l for l, e in self._engines.items() if e is owner),
                     type(owner).__name__)
        self.event(kind, engine=label, family=family, key=repr(key))

    # -- snapshot ----------------------------------------------------------
    def snapshot(self) -> dict:
        self.sync_stats()
        return {
            "metrics": self.metrics.samples(),
            "events": [e.asdict() for e in self.events.peek()],
            "dropped_events": self.events.dropped,
        }
