"""Device time of the operations launched inside the MoE body's
``moe_route``, ``moe_dispatch`` and ``moe_combine`` spans (router product,
top-k, aux loss, slot positions, the dispatch's scatter, the gather and
weighted sum, in the forward and in the backward's recompute) over all
device time of the device stretch, in percent (``bench.spans``)."""
from bench import spans


def read(run):
    return spans.routing_share(run)
