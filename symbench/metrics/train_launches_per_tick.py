"""Device operations (kernels, copies, sets) whose runtime launch lies
inside a ``train_step`` span, per engine tick of the device stretch: a
count, the same in every run of a cell (``bench.spans``)."""
from bench import spans


def read(run):
    return spans.launches_per_tick(run)
