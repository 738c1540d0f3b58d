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


def _per_score(scale):
    """Per-entry scales [B, T, K, 1] -> [B, K, 1, T], beside the scores."""
    return scale[..., 0].permute(0, 2, 1)[:, :, None, :]


def decode_attn_ref(q, k, v, pos, *, window: int = 0, block_tbl=None,
                    k_scale=None, v_scale=None):
    """Single-token GQA attention with a full softmax (the numerical oracle).

    q [B, K, G, hd]; k/v [B, T, K, hd], or page pools [P, block, K, hd]
    addressed through ``block_tbl`` [B, n_blocks]; pos [B] last valid
    index. Optional sliding window. ``k_scale``/``v_scale`` [.., K, 1]
    (paged like k/v when ``block_tbl`` is given) switch to int8 entries
    dequantized per head: the k-scale multiplies the scores, the v-scale
    the probabilities. Returns out [B, K, G, hd]."""
    if block_tbl is not None:
        k, v = gather_paged_kv(k, v, block_tbl)
        if k_scale is not None:
            k_scale = paged_view(k_scale, block_tbl)
            v_scale = paged_view(v_scale, block_tbl)
    hd = q.shape[-1]
    T = k.shape[1]
    s = torch.einsum("bkgh,btkh->bkgt", q.float(), k.float()) / math.sqrt(hd)
    if k_scale is not None:
        s = s * _per_score(k_scale)
    t = torch.arange(T, device=q.device)[None, :]
    pos = pos.long()[:, None]
    valid = t <= pos
    if window:
        valid &= (pos - t) < window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * _per_score(v_scale)
    out = torch.einsum("bkgt,btkh->bkgh", p, v.float())
    return out.to(q.dtype)
