"""The device stretch's idle time outside every ``forward``, ``backward``
and ``optimizer`` span (the row gather, ``compact_gather``, the losses'
copy, ``scatter``, ``admit``, the harness), over the stretch's wall time,
in percent; with ``idle_in_grads_pct`` and ``idle_in_optimizer_pct`` it
sums to ``device_idle_pct`` (``bench.spans``)."""
from bench import spans


def read(run):
    shares = spans.idle_shares(run)
    return None if shares is None else shares["between"]
