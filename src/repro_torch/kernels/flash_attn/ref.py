"""Un-blocked oracle for causal GQA flash attention (prefill/train forward)."""
from __future__ import annotations

import math

import torch


def flash_attn_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,S,H,hd]; k/v [B,T,K,hd] (H % K == 0). Self-attention positions
    are the natural ranges (prefill: q position i attends kv <= i); the
    window applies under ``causal`` only. Returns [B,S,H,hd]."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    kr = k.repeat_interleave(G, dim=2) if G > 1 else k
    vr = v.repeat_interleave(G, dim=2) if G > 1 else v
    s = torch.einsum("bshd,bthd->bhst", q.float(), kr.float()) / math.sqrt(hd)
    if causal:
        qp = torch.arange(S, device=q.device)[:, None]
        kp = torch.arange(T, device=q.device)[None, :]
        m = qp >= kp
        if window:
            m &= (qp - kp) < window
        s = torch.where(m[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", p, vr.float())
    return out.to(q.dtype)
