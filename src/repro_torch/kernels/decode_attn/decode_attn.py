"""Decode attention: the CUDA kernels' launch wrappers and their plain
PyTorch versions.

``paged_decode_attn_cuda`` launches the paged layout of ``csrc/
decode_attn.cu`` (which replaces the TPU kernel ``repro.kernels.
decode_attn.decode_attn.paged_decode_attn_pallas``): single-query GQA
attention per row, K/V read in place from a pool [P, blk, K, hd] through
the block table, cut into splits of ``PAGED_SPLIT_PAGES`` pages, one block
per (row, KV head, split), splits outside [pos-window+1, pos] skipped; the
split that finishes last merges the splits' softmax states in the same
launch. ``decode_attn_cuda`` launches the dense layout of the same source
(replacing ``decode_attn_pallas``): the dense cache [B, T, K, hd] in
splits of ``DENSE_SPLIT`` tokens, then a combine kernel.
``paged_decode_attn_quant_cuda`` launches the same paged split over int8
pools with f32 per-head scales [P, blk, K, 1] (replacing
``paged_decode_attn_quant_pallas``), splits of ``PAGED_QUANT_SPLIT_PAGES``
pages, one launch per call. ``paged_decode_attn_plain``,
``paged_decode_attn_quant_plain`` and ``decode_attn_plain`` run the same
blocked math as PyTorch ops, one step per table column (or, dense, per
``block_kv`` chunk) over all rows at once, like the JAX twin ``_stream``
(``_page_update`` is the per-page step of all six).
``decode_attn_split_plain``, ``paged_decode_attn_split_plain`` and
``paged_decode_attn_quant_split_plain`` write out the split kernels'
split-and-combine math for the tests.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

NAME = "decode_attn"      # the split kernels: paged (bf16/fp32, int8), dense
SOURCE = "src/repro_torch/csrc/decode_attn.cu"
REPLACES = "src/repro/kernels/decode_attn/decode_attn.py:255"
DENSE_REPLACES = "src/repro/kernels/decode_attn/decode_attn.py:102"
QUANT_SOURCE = SOURCE
QUANT_REPLACES = "src/repro/kernels/decode_attn/decode_attn.py:274"
# the paged kernel's pages per split (one block each), over bf16 and over
# int8 pools: the fastest of 1, 2, 4 and 8 at the serving path's shape,
# page_block 16 (tools/kernel_sweeps.py); a call with longer pages takes
# fewer (``split_pages``)
PAGED_SPLIT_PAGES = 2
PAGED_QUANT_SPLIT_PAGES = 4
DENSE_SPLIT = 256     # the dense kernel's tokens per split (one block each)
MAX_HD = 256          # the split kernels' largest head dimension
MAX_SPLIT = 512       # and their most tokens per split
_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _shapes(q, pool_k, pool_v, tbl, pos, pool_ks=None, pool_vs=None):
    B, K, G, hd = q.shape
    P, blk = pool_k.shape[:2]
    if pool_k.shape != (P, blk, K, hd) or pool_v.shape != pool_k.shape:
        raise ValueError(f"paged decode attention: pools {tuple(pool_k.shape)}"
                         f"/{tuple(pool_v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if (pool_ks is None) != (pool_vs is None):
        raise ValueError("paged decode attention: pass both scale pools or "
                         "neither")
    if pool_ks is not None and (pool_ks.shape != (P, blk, K, 1)
                                or pool_vs.shape != pool_ks.shape):
        raise ValueError(f"paged decode attention: scale pools "
                         f"{tuple(pool_ks.shape)}/{tuple(pool_vs.shape)} need "
                         f"{(P, blk, K, 1)}")
    if tbl.ndim != 2 or tbl.shape[0] != B or pos.shape != (B,):
        raise ValueError(f"paged decode attention: tbl {tuple(tbl.shape)} / "
                         f"pos {tuple(pos.shape)} need {B} rows")
    return B, K, G, hd, P, blk, tbl.shape[1]


def _per_score(scale):
    """Per-entry scales [B, blk, K] -> [B, K, 1, blk], beside the scores."""
    return scale.permute(0, 2, 1)[:, :, None, :]


def _page_update(q, k, v, ks, vs, t0, p, m, l, acc, *, window: int):
    """One page's contribution to every row's running softmax state.
    q [B,K,G,hd] f32; k/v [B,blk,K,hd] f32; ks/vs [B,blk,K] f32 scales or
    None; p [B]; m/l [B,K,G,1]; acc [B,K,G,hd]. Returns updated (m, l,
    acc). The k-scale multiplies the scores before the 1/sqrt(hd) factor;
    the denominator sums the raw exponentials and only the numerator is
    weighted by the v-scale (the JAX order, op for op)."""
    s = torch.einsum("bkgh,btkh->bkgt", q, k)
    if ks is not None:
        s = s * _per_score(ks)
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    t = t0 + torch.arange(k.shape[1], device=q.device)
    mask = t[None, :] <= p[:, None]
    if window:
        mask &= (p[:, None] - t[None, :]) < window
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, _NEG))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    ps = torch.exp(s - m_new)
    l = l * alpha + ps.sum(dim=-1, keepdim=True)
    if vs is not None:
        ps = ps * _per_score(vs)
    acc = acc * alpha + torch.einsum("bkgt,btkh->bkgh", ps, v)
    return m_new, l, acc


def _online_softmax(q, pos, chunks, *, blk: int, window: int):
    """The running softmax over ``chunks``, an iterable of (t0, k, v, ks,
    vs) with k/v [B, blk, K, hd] and ks/vs [B, blk, K] or None: each chunk
    updates the rows for which it is live (it meets [pos-window+1, pos]).
    Returns acc / max(l, 1e-30) in q's dtype."""
    B, K, G, hd = q.shape
    qf = q.float()
    p = pos.long()
    m = torch.full((B, K, G, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, hd), dtype=torch.float32, device=q.device)
    lo = (p - window + 1) if window else torch.zeros_like(p)
    for t0, k, v, ks, vs in chunks:
        m_new, l_new, acc_new = _page_update(
            qf, k.float(), v.float(), ks, vs, t0, p, m, l, acc, window=window)
        live = ((t0 <= p) & (t0 + blk > lo))[:, None, None, None]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _stream(q, pool_k, pool_v, pool_ks, pool_vs, tbl, pos, *, window: int):
    """One step per table column; each step gathers exactly the pages the
    column names (ids clamped into [0, P))."""
    B, K, G, hd, P, blk, nb = _shapes(q, pool_k, pool_v, tbl, pos, pool_ks,
                                      pool_vs)

    def pages():
        for c in range(nb):
            page = tbl[:, c].long().clamp(0, P - 1)
            ks = pool_ks[page][..., 0] if pool_ks is not None else None
            vs = pool_vs[page][..., 0] if pool_vs is not None else None
            yield c * blk, pool_k[page], pool_v[page], ks, vs
    return _online_softmax(q, pos, pages(), blk=blk, window=window)


def paged_decode_attn_plain(q, pool_k, pool_v, tbl, pos, *, window: int = 0):
    """Plain version of ``paged_decode_attn_cuda``."""
    return _stream(q, pool_k, pool_v, None, None, tbl, pos, window=window)


def paged_decode_attn_quant_plain(q, pool_k, pool_ks, pool_v, pool_vs, tbl,
                                  pos, *, window: int = 0):
    """Plain version of ``paged_decode_attn_quant_cuda``."""
    return _stream(q, pool_k, pool_v, pool_ks, pool_vs, tbl, pos,
                   window=window)


def _dense_shapes(q, k, v, pos):
    B, K, G, hd = q.shape
    if k.ndim != 4 or k.shape[0] != B or k.shape[2:] != (K, hd) \
            or v.shape != k.shape or k.shape[1] < 1:
        raise ValueError(f"dense decode attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if pos.shape != (B,):
        raise ValueError(f"dense decode attention: pos {tuple(pos.shape)} "
                         f"needs {B} rows")
    return B, K, G, hd, k.shape[1]


def decode_attn_plain(q, k, v, pos, *, block_kv: int, window: int = 0):
    """Plain version of ``decode_attn_cuda`` with the TPU kernel's blocks:
    chunks of ``block_kv`` tokens over a dense cache [B, T, K, hd], the last
    one zero-padded as the JAX wrapper pads (its pad positions lie past
    every pos, so they are masked)."""
    B, K, G, hd, T = _dense_shapes(q, k, v, pos)
    pad = (-T) % block_kv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    chunks = ((t0, k[:, t0:t0 + block_kv], v[:, t0:t0 + block_kv], None,
               None) for t0 in range(0, T + pad, block_kv))
    return _online_softmax(q, pos, chunks, blk=block_kv, window=window)


def _split_combine(q, k, v, pos, ks, vs, *, split: int, window: int):
    """The split kernels' math over a dense [B, T, K, hd] view: each split
    of ``split`` tokens that holds a valid position keeps (m, l, acc) over
    its valid tokens; the combine weighs the live splits by e^(m_s - M) and
    divides by max(sum, 1e-30), so a row with no live split (pos -1) is
    exact zeros. With int8 entries, ks/vs [B, T, K] are their scales: the
    score is q.k * ks / sqrt(hd), the denominator sums the raw
    exponentials and only the numerator weighs them by vs."""
    B, K, G, hd, T = _dense_shapes(q, k, v, pos)
    p = pos.long()
    lo = (p - window + 1).clamp_min(0) if window else torch.zeros_like(p)
    hi = p.clamp(max=T - 1)
    qf = q.float()
    ms, ls, accs, lives = [], [], [], []
    for t0 in range(0, T, split):
        t = torch.arange(t0, min(t0 + split, T), device=q.device)
        valid = (t[None, :] >= lo[:, None]) & (t[None, :] <= hi[:, None])
        s = torch.einsum("bkgh,btkh->bkgt", qf, k[:, t0:t0 + split].float())
        if ks is not None:
            s = s * _per_score(ks[:, t0:t0 + split])
        s = s * (1.0 / math.sqrt(hd))
        s = torch.where(valid[:, None, None, :], s, torch.full_like(s, _NEG))
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        ls.append(e.sum(dim=-1, keepdim=True))
        if vs is not None:
            e = e * _per_score(vs[:, t0:t0 + split])
        accs.append(torch.einsum("bkgt,btkh->bkgh", e,
                                 v[:, t0:t0 + split].float()))
        ms.append(m)
        lives.append(valid.any(dim=-1)[:, None, None, None])
    live = torch.stack(lives)                       # [nsplit, B, 1, 1, 1]
    m = torch.stack(ms).masked_fill(~live, _NEG)
    w = torch.exp(m - m.amax(dim=0)) * live         # dead splits weigh 0
    l = (w * torch.stack(ls)).sum(dim=0)
    acc = (w * torch.stack(accs)).sum(dim=0)
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def decode_attn_split_plain(q, k, v, pos, *, split: int, window: int = 0):
    """The dense kernel's math as PyTorch ops (tests only): the cache cut
    into splits of ``split`` tokens, merged as ``_split_combine`` says."""
    return _split_combine(q, k, v, pos, None, None, split=split,
                          window=window)


def _pages(pool, tbl, P):
    """Token t of row b: row t % blk of page tbl[b, t // blk] clamped into
    [0, P), as a dense [B, nb * blk, ...] view."""
    pages = tbl.long().clamp(0, P - 1)
    return pool[pages].reshape((tbl.shape[0], -1) + pool.shape[2:])


def paged_decode_attn_split_plain(q, pool_k, pool_v, tbl, pos, *,
                                  split_pages: int, window: int = 0):
    """The paged kernel's math as PyTorch ops (tests only): over the
    table's tokens, the dense kernel's split-and-combine with splits of
    ``split_pages`` pages."""
    B, K, G, hd, P, blk, nb = _shapes(q, pool_k, pool_v, tbl, pos)
    return _split_combine(q, _pages(pool_k, tbl, P), _pages(pool_v, tbl, P),
                          pos, None, None, split=split_pages * blk,
                          window=window)


def paged_decode_attn_quant_split_plain(q, pool_k, pool_ks, pool_v, pool_vs,
                                        tbl, pos, *, split_pages: int,
                                        window: int = 0):
    """The paged kernel's math over int8 pools (tests only): as
    ``paged_decode_attn_split_plain``, each token's k- and v-scale of its
    head applied in the JAX order (``_split_combine``)."""
    B, K, G, hd, P, blk, nb = _shapes(q, pool_k, pool_v, tbl, pos, pool_ks,
                                      pool_vs)
    return _split_combine(
        q, _pages(pool_k, tbl, P), _pages(pool_v, tbl, P), pos,
        _pages(pool_ks, tbl, P)[..., 0], _pages(pool_vs, tbl, P)[..., 0],
        split=split_pages * blk, window=window)


def _check_launch(q, pools, tbl, pos, what):
    """The kernel's dtype code for q; raises unless every tensor is on q's
    CUDA device and q and the pools are contiguous."""
    dtype = _DTYPES.get(q.dtype)
    if dtype is None:
        raise TypeError(f"{what}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    if not all(t.is_cuda and t.device == q.device
               for t in (*pools, tbl, pos) if t is not None):
        raise ValueError(f"{what}: all tensors must be on one CUDA device")
    if not all(t.is_contiguous() for t in (q, *pools)):
        raise ValueError(f"{what}: q and pools must be contiguous")
    return dtype


def _check_rows(q, k, v, what):
    """Raises unless the split kernels take these rows: hd a multiple of 16
    bytes' worth of elements up to ``MAX_HD``, one dtype."""
    hd = q.shape[-1]
    if hd * q.element_size() % 16 or hd > MAX_HD:
        raise ValueError(f"{what}: the kernel takes hd a multiple of "
                         f"{16 // q.element_size()} up to {MAX_HD}, got {hd}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")


def _check_aligned(tensors, what):
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: q and the keys and values must start "
                         "on 16-byte boundaries")


def split_pages(tuned: int, blk: int, what: str) -> int:
    """Pages per split for pages of ``blk`` tokens: the tuned count, or as
    many as fit the kernel's ``MAX_SPLIT`` tokens (at least one), so any
    page length up to ``MAX_SPLIT`` runs."""
    if blk > MAX_SPLIT:
        raise ValueError(f"{what}: pages of {blk} tokens pass the kernel's "
                         f"{MAX_SPLIT}-token splits")
    return min(tuned, max(1, MAX_SPLIT // blk))


_workspace: dict = {}


def _paged_workspace(device, n_acc: int, n_ml: int, n_tickets: int):
    """The paged kernel's scratch on ``device``: fp32 partial states (acc,
    then (m, l)) and int32 tickets, at least the given sizes. Allocated, the
    tickets zeroed, only when a call needs more than the last one held
    (grow-only); otherwise reused, so a call allocates, clears and launches
    nothing beside its kernel. The kernel leaves every ticket at 0. One
    workspace per device: calls on one stream at a time, as the port makes
    them."""
    ws = _workspace.get(device)
    need = (n_acc, n_ml, n_tickets)
    if ws is None or any(t.numel() < n for t, n in zip(ws, need)):
        size = [max(n, 0 if ws is None else t.numel())
                for t, n in zip(ws or (None,) * 3, need)]
        ws = (torch.empty(size[0], dtype=torch.float32, device=device),
              torch.empty(size[1], dtype=torch.float32, device=device),
              torch.zeros(size[2], dtype=torch.int32, device=device))
        _workspace[device] = ws
    return ws


def paged_decode_attn_cuda(q, pool_k, pool_v, tbl, pos, *, window: int = 0):
    """Launch the paged split kernel: one block per (row, KV head with up to
    4 of its query heads, split of ``PAGED_SPLIT_PAGES`` pages, fewer for
    pages longer than ``MAX_SPLIT // PAGED_SPLIT_PAGES`` tokens); the split
    that finishes last merges the row's splits. One launch per call. hd
    must make 16-byte rows, at most ``MAX_HD``; pages at most ``MAX_SPLIT``
    tokens."""
    B, K, G, hd, P, blk, nb = _shapes(q, pool_k, pool_v, tbl, pos)
    what = "paged decode attention"
    _check_rows(q, pool_k, pool_v, what)
    pages = split_pages(PAGED_SPLIT_PAGES, blk, what)
    dtype = _check_launch(q, (pool_k, pool_v), tbl, pos, what)
    _check_aligned((q, pool_k, pool_v), what)
    tbl = tbl.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    nsplit = -(-nb // pages)
    part_acc, part_ml, tickets = _paged_workspace(
        q.device, B * K * nsplit * G * hd, B * K * nsplit * G * 2, B * K * G)
    lib = _build.load(NAME, _bind)
    err = lib.decode_attn_paged(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tbl.data_ptr(),
        pos.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        tickets.data_ptr(), out.data_ptr(), B, K, G, hd, P, blk, nb,
        pages, window, 1.0 / math.sqrt(hd), dtype,
        _build.stream_ptr(q))
    _build.check(lib, err, what)
    paged_decode_attn_cuda.launches += 1
    return out


paged_decode_attn_cuda.launches = 0


def paged_decode_attn_quant_cuda(q, pool_k, pool_ks, pool_v, pool_vs, tbl,
                                 pos, *, window: int = 0):
    """Launch the paged split kernel over int8 pools [P, blk, K, hd] with
    f32 scales [P, blk, K, 1]: as ``paged_decode_attn_cuda``, splits of
    ``PAGED_QUANT_SPLIT_PAGES`` pages (fewer for long pages), one launch
    per call, its scratch
    shared with it (one stream at a time); output in q's dtype. hd must be
    a multiple of 16, at most ``MAX_HD``."""
    B, K, G, hd, P, blk, nb = _shapes(q, pool_k, pool_v, tbl, pos, pool_ks,
                                      pool_vs)
    what = "int8 paged decode attention"
    if pool_k.dtype != torch.int8 or pool_v.dtype != torch.int8:
        raise TypeError(f"{what}: pools must be int8, got "
                        f"{pool_k.dtype}/{pool_v.dtype}")
    if pool_ks.dtype != torch.float32 or pool_vs.dtype != torch.float32:
        raise TypeError(f"{what}: scales must be float32, got "
                        f"{pool_ks.dtype}/{pool_vs.dtype}")
    dtype = _check_launch(q, (pool_k, pool_ks, pool_v, pool_vs), tbl, pos,
                          what)
    if hd % 16 or hd > MAX_HD:
        raise ValueError(f"{what}: the kernel takes hd a multiple of 16 up "
                         f"to {MAX_HD}, got {hd}")
    pages = split_pages(PAGED_QUANT_SPLIT_PAGES, blk, what)
    _check_aligned((q, pool_k, pool_v), what)
    tbl = tbl.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    nsplit = -(-nb // pages)
    part_acc, part_ml, tickets = _paged_workspace(
        q.device, B * K * nsplit * G * hd, B * K * nsplit * G * 2, B * K * G)
    lib = _build.load(NAME, _bind)
    err = lib.decode_attn_paged_quant(
        q.data_ptr(), pool_k.data_ptr(), pool_ks.data_ptr(), pool_v.data_ptr(),
        pool_vs.data_ptr(), tbl.data_ptr(), pos.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(),
        out.data_ptr(), B, K, G, hd, P, blk, nb, pages,
        window, 1.0 / math.sqrt(hd), dtype, _build.stream_ptr(q))
    _build.check(lib, err, what)
    paged_decode_attn_quant_cuda.launches += 1
    return out


paged_decode_attn_quant_cuda.launches = 0


def decode_attn_cuda(q, k, v, pos, *, window: int = 0):
    """Launch the dense kernels: one block per (row, KV head, split of
    ``DENSE_SPLIT`` tokens), then one per (row, KV head) to combine; both
    launches count. hd must make 16-byte rows, at most ``MAX_HD``."""
    B, K, G, hd, T = _dense_shapes(q, k, v, pos)
    what = "dense decode attention"
    _check_rows(q, k, v, what)
    dtype = _check_launch(q, (k, v), None, pos, what)
    _check_aligned((q, k, v), what)
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    nsplit = -(-T // DENSE_SPLIT)
    part_acc = torch.empty((B, K, nsplit, G, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, K, nsplit, G, 2), dtype=torch.float32,
                          device=q.device)
    lib = _build.load(NAME, _bind)
    err = lib.decode_attn_dense(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(), B, K, G, hd,
        T, DENSE_SPLIT, window, 1.0 / math.sqrt(hd), dtype,
        _build.stream_ptr(q))
    _build.check(lib, err, "dense decode attention")
    decode_attn_cuda.launches += 2
    return out


decode_attn_cuda.launches = 0


def _bind(lib):
    tail = [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.decode_attn_dense.argtypes = ([ctypes.c_void_p] * 7
                                      + [ctypes.c_int] * 7 + tail)
    lib.decode_attn_dense.restype = ctypes.c_int
    lib.decode_attn_paged.argtypes = ([ctypes.c_void_p] * 9
                                      + [ctypes.c_int] * 9 + tail)
    lib.decode_attn_paged.restype = ctypes.c_int
    lib.decode_attn_paged_quant.argtypes = ([ctypes.c_void_p] * 11
                                            + [ctypes.c_int] * 9 + tail)
    lib.decode_attn_paged_quant.restype = ctypes.c_int
