"""Matrix-product kernels' device time over all device time in the device
stretch, in percent (cuBLAS and CUTLASS kernels by name)."""
from bench import trace

GEMM = ("gemm", "nvjet", "xmma", "cutlass", "gemv", "wgmma")


def read(run):
    if run.trace is None:
        return None
    total = sum(op[2] for op in run.trace.ops)
    if not total:
        return None
    mm = sum(op[2] for op in trace.ops_named(run.trace, GEMM))
    return 100.0 * mm / total
