"""Un-blocked oracle for the SGMV (segmented gather matrix-vector) LoRA op."""
from __future__ import annotations

import torch


def sgmv_ref(x, A, B, block_adapter, *, block_t: int, scale: float = 1.0):
    """Segmented LoRA delta over a token-packed buffer (``repro.kernels.sgmv.
    ref.sgmv_ref``).

    x [T, din], T % block_t == 0; A [n, din, r]; B [n, r, dout];
    block_adapter [T // block_t] int32 adapter id per token block (negative
    = dead block -> zeros). Returns y [T, dout] = (x @ A[a]) @ B[a] * scale.
    """
    T, din = x.shape
    nb = T // block_t
    dout = B.shape[-1]
    xb = x.reshape(nb, block_t, din)
    a = block_adapter.long().clamp(0, A.shape[0] - 1)
    h = torch.einsum("bti,bir->btr", xb.float(), A[a].float())
    y = torch.einsum("btr,bro->bto", h, B[a].float()) * scale
    y = torch.where((block_adapter >= 0)[:, None, None], y, torch.zeros_like(y))
    return y.reshape(T, dout).to(x.dtype)
