"""Device time of the operations launched inside the engine's prefill phase
(its ``repro_torch.obs/prefill`` range) in the host stretch's ticks, per
1,000 prompt tokens those ticks admitted."""
from bench import trace


def read(run):
    if run.trace_host is None:
        return None
    tokens = sum(sum(t.prompts) for t in run.ticks if t.profiled == "host")
    if not tokens:
        return None
    dev_us = sum(op[2] for op in trace.launched_in(run.trace_host, "prefill"))
    if not dev_us:
        return None
    return dev_us * 1e-3 / (tokens / 1000.0)
