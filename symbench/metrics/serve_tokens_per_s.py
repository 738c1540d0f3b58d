"""Generated tokens per second: the engine's decode tokens plus the first
tokens sampled at prefill (admissions), between the window's edges, over
the window."""


def read(run):
    s0, s1 = run.extra["stats0"], run.extra["stats1"]
    n = (s1["decode_tokens"] - s0["decode_tokens"]
         + s1["admitted"] - s0["admitted"])
    return n / run.seconds
