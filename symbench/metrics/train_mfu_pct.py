"""Useful model FLOPs of the work done in the window (``bench.flops``: no
padding, no recomputation, top-k experts only) over the window times the
card's dense bf16 peak, in percent, over the window's untraced part (a
traced run's ticks before its first profiled stretch)."""


def read(run):
    if run.flops is None or run.peak is None:
        return None
    f, seconds = run.unprofiled()
    return 100.0 * f / (seconds * run.peak["flops"])
