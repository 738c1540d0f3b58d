"""Public decode-attention op: dispatch by device (see ``repro_torch.kernels``).

Both layouts of ``repro.kernels.decode_attn.ops.decode_attn``: a dense
[B, T, K, hd] cache, and paged pools (``block_tbl=``) over bf16/fp32
entries or int8 entries with per-head scales.
"""
from __future__ import annotations

from repro_torch.kernels._dispatch import launches_kernel
from repro_torch.kernels.decode_attn.decode_attn import (
    decode_attn_cuda, decode_attn_plain, paged_decode_attn_cuda,
    paged_decode_attn_plain, paged_decode_attn_quant_cuda,
    paged_decode_attn_quant_plain)


def _dense_block_kv(T: int, block_kv: int):
    """Largest divisor of T in (block_kv/2, block_kv] — avoids materializing
    zero-pads for mildly non-dividing depths; degenerate depths keep the old
    pad-to-multiple behaviour. (The JAX wrapper's choice, which the plain
    version's chunks follow; the CUDA kernel picks its own chunk.)"""
    bkv = min(block_kv, T)
    if T % bkv == 0:
        return bkv, 0
    for cand in range(bkv, max(bkv // 2, 1), -1):
        if T % cand == 0:
            return cand, 0
    return bkv, (-T) % bkv


def decode_attn(q, k, v, pos, *, block_kv: int = 512, window: int = 0,
                block_tbl=None, k_scale=None, v_scale=None):
    """Single-token GQA decode attention. q [B, K, G, hd]; pos [B] int32
    last valid index (-1: nothing to attend, the output is exact zeros).
    Optional sliding window.

    Dense (no ``block_tbl``): k/v [B, T, K, hd], walked in chunks of a
    divisor of T near ``block_kv`` (chunks outside [pos-window+1, pos]
    skipped). Paged: k/v are page pools [P, page_block, K, hd] shared
    across rows, ``block_tbl`` [B, n_blocks] int32 page ids (entries past a
    row's pages may hold any value: they are clamped and position-masked);
    ``k_scale``/``v_scale`` [P, page_block, K, 1] f32 switch to int8 pools
    dequantized per head (paged only). A CUDA tensor launches the CUDA
    kernel; a CPU tensor runs its plain version."""
    cuda = launches_kernel(q)
    quant = k_scale is not None or v_scale is not None
    if block_tbl is None:
        if quant:
            raise ValueError("decode_attn: int8 scales need the paged layout "
                             "(block_tbl=)")
        if cuda:
            return decode_attn_cuda(q, k, v, pos, window=window)
        bkv, _ = _dense_block_kv(k.shape[1], block_kv)
        return decode_attn_plain(q, k, v, pos, block_kv=bkv, window=window)
    if not quant:
        fn = paged_decode_attn_cuda if cuda else paged_decode_attn_plain
        return fn(q, k, v, block_tbl, pos, window=window)
    fn = paged_decode_attn_quant_cuda if cuda else paged_decode_attn_quant_plain
    return fn(q, k, k_scale, v, v_scale, block_tbl, pos, window=window)
