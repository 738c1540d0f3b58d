"""Paged decode attention: the CUDA kernel's launch wrapper and its plain
PyTorch version.

``paged_decode_attn_cuda`` launches ``csrc/paged_decode_attn.cu`` (which
replaces the TPU kernel ``repro.kernels.decode_attn.decode_attn.
paged_decode_attn_pallas``): single-query GQA attention per row, reading
K/V pages in place from a pool [P, blk, K, hd] through the block table,
skipping pages outside [pos-window+1, pos], with an fp32 online softmax.
``paged_decode_attn_plain`` runs the same blocked math as PyTorch ops, one
step per table column over all rows at once, like the JAX twin ``_stream``
(``_page_update`` is the per-page step of both).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NAME = "paged_decode_attn"
SOURCE = "src/repro_torch/csrc/paged_decode_attn.cu"
REPLACES = "src/repro/kernels/decode_attn/decode_attn.py:255"
_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _shapes(q, pool_k, pool_v, tbl, pos):
    B, K, G, hd = q.shape
    P, blk = pool_k.shape[:2]
    if pool_k.shape != (P, blk, K, hd) or pool_v.shape != pool_k.shape:
        raise ValueError(f"paged decode attention: pools {tuple(pool_k.shape)}"
                         f"/{tuple(pool_v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if tbl.ndim != 2 or tbl.shape[0] != B or pos.shape != (B,):
        raise ValueError(f"paged decode attention: tbl {tuple(tbl.shape)} / "
                         f"pos {tuple(pos.shape)} need {B} rows")
    return B, K, G, hd, P, blk, tbl.shape[1]


def _page_update(q, k, v, t0, p, m, l, acc, *, window: int):
    """One page's contribution to every row's running softmax state.
    q [B,K,G,hd] f32; k/v [B,blk,K,hd] f32; p [B]; m/l [B,K,G,1];
    acc [B,K,G,hd]. Returns updated (m, l, acc)."""
    s = torch.einsum("bkgh,btkh->bkgt", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    t = t0 + torch.arange(k.shape[1], device=q.device)
    mask = t[None, :] <= p[:, None]
    if window:
        mask &= (p[:, None] - t[None, :]) < window
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, _NEG))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    ps = torch.exp(s - m_new)
    l = l * alpha + ps.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bkgt,btkh->bkgh", ps, v)
    return m_new, l, acc


def paged_decode_attn_plain(q, pool_k, pool_v, tbl, pos, *, window: int = 0):
    """Plain version: one step per table column; each step gathers exactly
    the pages the column names (ids clamped into [0, P)) and updates the
    rows for which that page is live."""
    B, K, G, hd, P, blk, nb = _shapes(q, pool_k, pool_v, tbl, pos)
    qf = q.float()
    p = pos.long()
    m = torch.full((B, K, G, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, hd), dtype=torch.float32, device=q.device)
    lo = (p - window + 1) if window else torch.zeros_like(p)
    for c in range(nb):
        t0 = c * blk
        page = tbl[:, c].long().clamp(0, P - 1)
        m_new, l_new, acc_new = _page_update(
            qf, pool_k[page].float(), pool_v[page].float(), t0, p, m, l, acc,
            window=window)
        live = ((t0 <= p) & (t0 + blk > lo))[:, None, None, None]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def paged_decode_attn_cuda(q, pool_k, pool_v, tbl, pos, *, window: int = 0):
    """Launch the CUDA kernel: one block per (row, KV head)."""
    B, K, G, hd, P, blk, nb = _shapes(q, pool_k, pool_v, tbl, pos)
    dtype = _DTYPES.get(q.dtype)
    if dtype is None or pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise TypeError(f"paged decode attention: q/pools must share float32 "
                        f"or bfloat16, got {q.dtype}/{pool_k.dtype}/"
                        f"{pool_v.dtype}")
    if not all(t.is_cuda and t.device == q.device
               for t in (pool_k, pool_v, tbl, pos)):
        raise ValueError("paged decode attention: all tensors must be on one "
                         "CUDA device")
    if not (q.is_contiguous() and pool_k.is_contiguous()
            and pool_v.is_contiguous()):
        raise ValueError("paged decode attention: q and pools must be "
                         "contiguous")
    tbl = tbl.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = _build.load(NAME, _bind)
    err = lib.paged_decode_attn(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tbl.data_ptr(),
        pos.data_ptr(), out.data_ptr(), B, K, G, hd, P, blk, nb, window,
        1.0 / math.sqrt(hd), dtype, _build.stream_ptr(q))
    _build.check(lib, err, "paged decode attention")
    paged_decode_attn_cuda.launches += 1
    return out


paged_decode_attn_cuda.launches = 0


def _bind(lib):
    lib.paged_decode_attn.argtypes = ([ctypes.c_void_p] * 6
                                      + [ctypes.c_int] * 8
                                      + [ctypes.c_float, ctypes.c_int,
                                         ctypes.c_void_p])
    lib.paged_decode_attn.restype = ctypes.c_int

