"""Time per output token, 90th percentile over the requests finished in the
window with two tokens or more: (finish - first token) / (tokens - 1),
every stall a request sat through included."""
from bench.window import percentile


def read(run):
    return percentile([(r.finish_t - r.first_token_t)
                       / (r.generated.shape[1] - 1) * 1e3
                       for r in run.finished
                       if r.status == "ok" and r.generated.shape[1] > 1], 90)
