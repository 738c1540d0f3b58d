"""The device stretch's wall time not covered by any device operation, over
its wall time, in percent (the device stretch records device activity
alone, so the host runs at its own pace)."""
from bench import trace


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    w = run.trace.window_s
    return 100.0 * (w - trace.busy_s(run.trace)) / w
