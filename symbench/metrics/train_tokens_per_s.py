"""Tokens of every optimizer step completed in the window, over the
window (the engine's ``train_tokens`` at the window's edges)."""


def read(run):
    s0, s1 = run.extra["stats0"], run.extra["stats1"]
    return (s1["train_tokens"] - s0["train_tokens"]) / run.seconds
