"""Public decode-attention op: dispatch by device (see ``repro_torch.kernels``).

Only the paged (``block_tbl=``) branch of ``repro.kernels.decode_attn.ops.
decode_attn`` is ported, over bf16/fp32 pools and over int8 pools with
per-head scales; the dense-cache kernel is still to port (ROADMAP Queue 2).
"""
from __future__ import annotations

from repro_torch.kernels import launches_kernel
from repro_torch.kernels.decode_attn.decode_attn import (
    paged_decode_attn_cuda, paged_decode_attn_plain,
    paged_decode_attn_quant_cuda, paged_decode_attn_quant_plain)


def decode_attn(q, k, v, pos, *, block_tbl, window: int = 0, k_scale=None,
                v_scale=None):
    """Single-token GQA decode attention over paged pools.

    q [B, K, G, hd]; k/v page pools [P, page_block, K, hd] shared across
    rows; ``block_tbl`` [B, n_blocks] int32 page ids (entries past a row's
    pages may hold any value: they are clamped and position-masked); pos [B]
    int32 last valid index. ``k_scale``/``v_scale`` [P, page_block, K, 1]
    f32 switch to int8 pools dequantized per head. A CUDA tensor launches
    the CUDA kernel; a CPU tensor runs its plain version."""
    cuda = launches_kernel(q)
    if k_scale is None and v_scale is None:
        fn = paged_decode_attn_cuda if cuda else paged_decode_attn_plain
        return fn(q, k, v, block_tbl, pos, window=window)
    fn = paged_decode_attn_quant_cuda if cuda else paged_decode_attn_quant_plain
    return fn(q, k, k_scale, v, v_scale, block_tbl, pos, window=window)
