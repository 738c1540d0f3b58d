"""Admission wait, 90th percentile over every request due in the window:
the engine's admission stamp minus the due time (the wait so far for one
not admitted when the window closes)."""
from bench.window import percentile


def read(run):
    return percentile([((r.admit_t or run.t1) - due) * 1e3
                       for r, due in run.due], 90)
