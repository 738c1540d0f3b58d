"""Median host-clock time of the window's engine ticks that ran a decode and
no prefill (enqueue, the logits' copy, sampling, retirement), over the
window's untraced part (a traced run's ticks before its first profiled
stretch)."""
from bench.window import median


def read(run):
    return median([(t.t1 - t.t0) * 1e3 for t in run.untraced_ticks()
                   if t.decode_rows and not t.prefill_rows])
