"""The paged decode-attention kernel's share of its roofline in the traced
ticks of the device stretch: the sum over its launches (one per layer and decode tick) of the
least time the rows' live keys allow (``bench.flops.decode_attn_bytes`` and
``decode_attn_layer_flops`` over the card's peaks), over the sum of the
launches' device time, in percent."""
from bench import flops, trace


def read(run):
    if run.trace is None or run.peak is None:
        return None
    m = flops.dims(run.arch)
    blk = run.arch["serve"]["page_block"]
    ticks = [t for t in run.ticks if t.profiled == "device"
             and t.decode_rows]
    ops = trace.ops_named(run.trace, ("split_kernel",))
    if not ticks or len(ops) != m.L * len(ticks):
        return None
    least = 0.0
    for t in ticks:
        nbytes = sum(flops.decode_attn_bytes(m, c, blk) for c in t.ctxs)
        f = sum(flops.decode_attn_layer_flops(m, c) for c in t.ctxs)
        least += m.L * flops.bound_s(nbytes, f, run.peak)
    return 100.0 * least / (sum(op[2] for op in ops) * 1e-6)
