"""Public SGMV op: dispatch by device (see ``repro_torch.kernels``)."""
from __future__ import annotations

from repro_torch.kernels._dispatch import launches_kernel
from repro_torch.kernels.sgmv.sgmv import sgmv_cuda, sgmv_plain


def sgmv(x, A, B, block_adapter, *, block_t: int = 128, scale: float = 1.0):
    """Multi-adapter LoRA delta over a packed token buffer.

    x [T, din]; A [n, din, r]; B [n, r, dout]; block_adapter int32 with up
    to ceil(T / block_t) ids (adapter id per token block; negative, or no
    id at all, = dead block: zeros). Any T: the last block may be short,
    as the JAX op gives by padding. ``block_t=1`` gives one adapter per row
    (the compacted decode tick); ``block_t=S`` one per prompt row (the
    compacted prefill). A CUDA tensor launches the CUDA kernel; a CPU
    tensor runs its plain version."""
    fn = sgmv_cuda if launches_kernel(x) else sgmv_plain
    return fn(x, A, B, block_adapter, block_t=block_t, scale=scale)
