"""Tick-phase spans and the on-demand profiler capture window
(``repro.obs.trace``, on ``torch.profiler`` in place of ``jax.profiler``).

A ``Span`` is a reusable context manager for one named tick phase
(``admit``, ``prefill``, ``prefill_compact_gather``, ``compact_gather``,
``jit_dispatch``, ``device_sync``, ``scatter``, ``health_audit``,
``train_step``) or, trace-only, for a part of one (the train step's
``forward``, ``backward`` and ``optimizer``; the MoE body's ``moe_route``,
``moe_dispatch``, ``moe_experts`` and ``moe_combine``). Entering it opens
a ``torch.profiler.record_function("repro_torch.obs/<name>")`` range, so
the names appear in a ``torch.profiler`` trace (a host-side annotation:
it never waits for the device). Its exit appends one ``SpanRecord`` to
the owner's ``SpanLog`` and, unless it is trace-only, records its
duration into the phase's latency histogram (``span_seconds``, the feed
JAX's has). Timestamps are taken only at span boundaries and spans never
synchronise, so the engine's asynchronous launches are unchanged.

``CaptureWindow`` arms a one-shot ``torch.profiler.profile`` over the next
N engine ticks: started at the first armed tick's start, stopped at the
N-th tick's end, its Chrome trace written into ``log_dir``. It records CPU
activity, plus CUDA when the ticking engine's device is a card. Capture
is best effort, as in JAX: a profiler error is returned as the
``capture_failed`` event kind, never raised into the tick loop. Stopping
the profiler waits for the device once (the profiler flushes the
window's kernel records), at the window's last tick end; ticks outside a
window are untouched.
"""
from __future__ import annotations

import collections
import itertools
import os
import threading
import time
import weakref
from typing import List, NamedTuple, Optional

import torch


class SpanRecord(NamedTuple):
    """One occurrence of a span. ``id`` numbers occurrences in the order
    they opened; ``parent`` is the ``id`` of the innermost span open on
    the same thread when this one opened or, on a thread with none open
    (autograd's device threads, which run a backward for the thread that
    called it), of the innermost span on the thread that opened a span
    last; None at the top. ``start_ns`` / ``end_ns`` are
    ``time.perf_counter_ns()``, ``thread`` is ``threading.get_native_id()``
    (the thread id of a profiler trace), and ``engine`` and ``tick`` name
    the last engine tick started (``Obs.tick_start``; "" and -1 before
    any)."""
    id: int
    name: str
    parent: Optional[int]
    start_ns: int
    end_ns: int
    thread: int
    engine: str
    tick: int


class _Frames(list):
    """One thread's open spans, each a frame [id, name, parent, start_ns,
    profiler range]; ``tid`` its thread's native id."""
    __slots__ = ("tid", "__weakref__")


class SpanLog:
    """The bounded in-memory buffer of span occurrences: the last
    ``maxlen`` ``SpanRecord``s, ``dropped`` counting those that fell out,
    the per-thread stacks of open spans (held by each thread alone, so a
    stack goes when its thread ends), ``tick`` the (engine, tick) stamped
    on new records, and one ``anchor`` pair ``(perf_counter_ns, time_ns)``
    read together, which maps a record's times onto the wall clock."""

    def __init__(self, maxlen: int) -> None:
        self.records = collections.deque(maxlen=maxlen)
        self.dropped = 0
        self.tick = ("", -1)
        self.anchor = (time.perf_counter_ns(), time.time_ns())
        self._ids = itertools.count()
        self._local = threading.local()
        self._stacks = weakref.WeakValueDictionary()   # live threads' stacks
        self._threads = itertools.count()
        self._lock = threading.Lock()

    def _stack(self) -> _Frames:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = _Frames()
            st.tid = threading.get_native_id()
            with self._lock:
                self._stacks[next(self._threads)] = st
        return st

    def open(self, name: str) -> None:
        """Push a frame on the calling thread's stack."""
        st = self._stack()
        if st:
            parent = st[-1][0]
        else:
            with self._lock:
                stacks = list(self._stacks.values())
            # slices: another thread may pop its last frame meanwhile
            tops = [top[0] for s in stacks if s is not st
                    for top in (s[-1:],) if top]
            parent = max(tops, key=lambda f: f[3])[0] if tops else None
        rf = torch.profiler.record_function(f"repro_torch.obs/{name}")
        rf.__enter__()
        st.append([next(self._ids), name, parent, time.perf_counter_ns(), rf])

    def close(self, exc_type, exc, tb) -> int:
        """Pop the calling thread's innermost frame, record it and return
        its duration in nanoseconds."""
        end = time.perf_counter_ns()
        st = self._local.stack
        sid, name, parent, start, rf = st.pop()
        rf.__exit__(exc_type, exc, tb)
        rec = SpanRecord(sid, name, parent, start, end, st.tid, *self.tick)
        with self._lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(rec)
        return end - start

    def between(self, t0_ns: int, t1_ns: int) -> List[SpanRecord]:
        """The records whose occurrence overlaps [t0_ns, t1_ns] of
        ``time.perf_counter_ns()``, in the order they closed."""
        with self._lock:
            recs = list(self.records)
        return [r for r in recs if r.end_ns >= t0_ns and r.start_ns <= t1_ns]


class Span:
    """Reusable context manager for one named span, re-entrant and safe on
    any thread: each occurrence's state is a frame on its thread's stack
    in ``log``. ``hist`` is the phase's latency histogram, None for a
    trace-only span."""

    __slots__ = ("name", "_hist", "_log")

    def __init__(self, name: str, hist, log: SpanLog) -> None:
        self.name = name
        self._hist = hist  # obs-owned Histogram for this phase, or None
        self._log = log

    def __enter__(self) -> "Span":
        self._log.open(self.name)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dt = self._log.close(exc_type, exc, tb)
        if self._hist is not None:
            self._hist.observe(dt * 1e-9)
        return False


class CaptureWindow:
    """One-shot profiler capture armed for the next N ticks.

    ``request`` arms; the owning ``Obs`` calls ``on_tick_start`` /
    ``on_tick_end`` from the engine tick boundaries. Returns event kinds
    ("capture_start", "capture_stop", "capture_failed") so the caller can
    log them; None when nothing happened. ``trace_path`` is the last
    written Chrome trace."""

    def __init__(self) -> None:
        self.log_dir: Optional[str] = None
        self.ticks_left = 0
        self.active = False
        self.trace_path: Optional[str] = None
        self._prof = None
        self._dir = None

    def request(self, log_dir: str, ticks: int = 1) -> None:
        self.log_dir = str(log_dir)
        self.ticks_left = max(1, int(ticks))

    def on_tick_start(self, cuda: bool = False) -> Optional[str]:
        if self.active or self.log_dir is None:
            return None
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            os.makedirs(self.log_dir, exist_ok=True)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        except Exception:
            self.log_dir = None
            self.ticks_left = 0
            return "capture_failed"
        self._prof, self._dir = prof, self.log_dir
        self.active = True
        return "capture_start"

    def on_tick_end(self) -> Optional[str]:
        if not self.active:
            return None
        self.ticks_left -= 1
        if self.ticks_left > 0:
            return None
        self.active = False
        self.log_dir = None
        prof, self._prof = self._prof, None
        try:
            prof.stop()
            n = 0
            while os.path.exists(os.path.join(self._dir, f"trace_{n:03d}.json")):
                n += 1
            path = os.path.join(self._dir, f"trace_{n:03d}.json")
            prof.export_chrome_trace(path)
        except Exception:
            return "capture_failed"
        self.trace_path = path
        return "capture_stop"
