"""The device stretch's idle time whose gap midpoint lies inside a train
step's ``forward`` or ``backward`` span (an MoE span counting with its
ancestor), over the stretch's wall time, in percent (``bench.spans``)."""
from bench import spans


def read(run):
    shares = spans.idle_shares(run)
    return None if shares is None else shares["grads"]
