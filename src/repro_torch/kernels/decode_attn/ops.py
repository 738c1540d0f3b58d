"""Public decode-attention op: dispatch by device (see ``repro_torch.kernels``).

Only the paged (``block_tbl=``) branch of ``repro.kernels.decode_attn.ops.
decode_attn`` is ported: the dense-cache kernel and the int8 paged kernel
are still to port (ROADMAP Queue 2).
"""
from __future__ import annotations

from repro_torch.kernels import launches_kernel
from repro_torch.kernels.decode_attn.decode_attn import (
    paged_decode_attn_cuda, paged_decode_attn_plain)


def decode_attn(q, k, v, pos, *, block_tbl, window: int = 0):
    """Single-token GQA decode attention over paged pools.

    q [B, K, G, hd]; k/v page pools [P, page_block, K, hd] shared across
    rows; ``block_tbl`` [B, n_blocks] int32 page ids (entries past a row's
    pages may hold any value: they are clamped and position-masked); pos [B]
    int32 last valid index. A CUDA tensor launches the CUDA kernel; a CPU
    tensor runs its plain version."""
    fn = paged_decode_attn_cuda if launches_kernel(q) else \
        paged_decode_attn_plain
    return fn(q, k, v, block_tbl, pos, window=window)
