"""Time to first token, 90th percentile over every request due in the
window: first token minus the due time; a request with no first token when
the window closes counts with its wait so far."""
from bench.window import percentile


def read(run):
    return percentile([((r.first_token_t or run.t1) - due) * 1e3
                       for r, due in run.due], 90)
