"""Public flash-attention op: dispatch by device (see ``repro_torch.kernels``)."""
from __future__ import annotations

from repro_torch.kernels._dispatch import launches_kernel
from repro_torch.kernels.flash_attn.flash_attn import (
    _shapes, flash_attn_cuda, flash_attn_plain)


def flash_attn(q, k, v, *, block_q: int = 256, block_kv: int = 512,
               causal: bool = True, window: int = 0):
    """Causal GQA flash attention. q [B,S,H,hd]; k/v [B,T,K,hd].

    Arbitrary S/T under ``causal``: kv positions >= T are never attended
    (the JAX wrapper lets query rows >= T see its zero pad keys when S > T;
    this op keeps the documented contract). Non-causal inputs need
    T % block_kv == 0 (``block_kv`` capped at T, floored at 8), as in the
    JAX op, else ValueError. The window applies under ``causal`` only. A
    CUDA tensor launches the CUDA kernel, whose tiles are its own; a CPU
    tensor runs the plain version with the JAX op's blocks."""
    B, S, H, hd, T, K = _shapes(q, k, v)
    bq = min(block_q, max(8, S))
    bkv = min(block_kv, max(8, T))
    if not causal and T % bkv:
        raise ValueError("non-causal flash_attn requires T % block_kv == 0")
    if launches_kernel(q):
        return flash_attn_cuda(q, k, v, causal=causal, window=window)
    return flash_attn_plain(q, k, v, block_q=bq, block_kv=bkv, causal=causal,
                            window=window)
