"""Tick-phase spans and the on-demand profiler capture window
(``repro.obs.trace``, on ``torch.profiler`` in place of ``jax.profiler``).

A ``Span`` is a reusable context manager for one named tick phase
(``admit``, ``prefill``, ``prefill_compact_gather``, ``compact_gather``,
``jit_dispatch``, ``device_sync``, ``scatter``, ``health_audit``,
``train_step``). Entering it opens a
``torch.profiler.record_function("repro_torch.obs/<name>")`` range, so the
phase names appear in a ``torch.profiler`` trace (a host-side annotation:
it never waits for the device), and its exit records a ``perf_counter``
pair into the phase's latency histogram. Timestamps are taken only at
phase boundaries and spans never synchronise, so the engine's
asynchronous launches are unchanged.

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

import os
import time
from typing import Optional

import torch


class Span:
    """Reusable single-threaded context manager for one tick phase."""

    __slots__ = ("name", "_hist", "_t0", "_rf")

    def __init__(self, name: str, hist) -> None:
        self.name = name
        self._hist = hist  # obs-owned Histogram for this phase
        self._t0 = 0.0
        self._rf = None

    def __enter__(self) -> "Span":
        self._rf = torch.profiler.record_function(f"repro_torch.obs/{self.name}")
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dt = time.perf_counter() - self._t0
        self._rf.__exit__(exc_type, exc, tb)
        self._rf = None
        self._hist.observe(dt)
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
