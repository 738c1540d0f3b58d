"""Un-blocked oracle for GQA decode attention over a dense or paged cache."""
from __future__ import annotations

import math

import torch


def paged_view(pool, tbl):
    """Gather a dense per-slot view from a page pool (the block-table
    gather). pool [P, block, ...]; tbl [B, n_blocks] page ids, clamped into
    [0, P) as the JAX gather clamps. Returns [B, n_blocks * block, ...].
    Test oracle only: no decode path materializes this view."""
    P, blk = pool.shape[:2]
    B, n_blocks = tbl.shape
    v = pool[tbl.long().clamp(0, P - 1)]
    return v.reshape(B, n_blocks * blk, *pool.shape[2:])


def gather_paged_kv(k, v, block_tbl):
    """Dense per-row K and V views from paged pools (test oracle)."""
    return paged_view(k, block_tbl), paged_view(v, block_tbl)


def decode_attn_ref(q, k, v, pos, *, window: int = 0, block_tbl=None):
    """Single-token GQA attention with a full softmax (the numerical oracle).

    q [B, K, G, hd]; k/v [B, T, K, hd], or page pools [P, block, K, hd]
    addressed through ``block_tbl`` [B, n_blocks]; pos [B] last valid
    index. Optional sliding window. Returns out [B, K, G, hd]."""
    if block_tbl is not None:
        k, v = gather_paged_kv(k, v, block_tbl)
    hd = q.shape[-1]
    T = k.shape[1]
    s = torch.einsum("bkgh,btkh->bkgt", q.float(), k.float()) / math.sqrt(hd)
    t = torch.arange(T, device=q.device)[None, :]
    pos = pos.long()[:, None]
    valid = t <= pos
    if window:
        valid &= (pos - t) < window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", p, v.float())
    return out.to(q.dtype)
