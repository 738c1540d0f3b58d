"""The device stretch's idle time whose gap midpoint lies inside a train
step's ``optimizer`` span (schedule, clip, AdamW, finite probe, commits),
over the stretch's wall time, in percent (``bench.spans``)."""
from bench import spans


def read(run):
    shares = spans.idle_shares(run)
    return None if shares is None else shares["optimizer"]
