"""Shared neural building blocks (PyTorch, functional) — the attention
(self, encoder and cross), the paged and dense decode paths and the MLPs
of ``repro.models.blocks``.

Every frozen-base matmul goes through a ``LinearFns`` hook, the port's form
of the paper's VirtLayer splice: the default hook runs the matmul inline;
``core.virtlayer`` substitutes hooks that add per-client LoRA deltas.
``expert`` carries the MoE family's stacked expert products, which no
adapter hook ever sees.
Linear weights keep the JAX layout [din, dout] (``x @ w``).

Paged KV caches hold K/V in a pool of fixed-size pages [P, block, K, hd]
shared by many sequence slots; slot b maps logical position t to
``pool[tbl[b, t // block], t % block]``. Writes go IN PLACE into the pool
tensor (the JAX package donated the pool buffer to the same effect); reads
go through the paged decode-attention kernel, which reads the pages in
place through the table. An int8 cache keeps four pools per layer, the
int8 entries ``k``/``v`` and their per-head f32 scales ``k_s``/``v_s``
[P, block, K, 1], all written through the same index. JAX drops
out-of-range scatter writes (``mode="drop"``); torch has no such mode and
an out-of-range page on the card is an illegal address, so the write
helpers point each dropped write at a kept one (``_drop_index``): every
scatter keeps a fixed shape and never waits on the host.

Dense KV caches hold one [T, K, hd] row per slot (T = max_seq, or a ring of
depth T). A decode step writes its token's lane IN PLACE (JAX selects over
the whole T axis); the unquantized, non-ring case attends through the dense
decode-attention kernel, the ring and int8 cases in plain torch, as JAX.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import plain_kernels  # noqa: F401 (test oracle)
from repro_torch.kernels.decode_attn import decode_attn


def _default_dense(x, w, b, path):
    y = x @ w
    return y + b if b is not None else y


def _default_expert(x, w, path):
    """JAX's ``einsum("eci,eio->eco")`` (computed outside any Pallas
    kernel there) as one batched product."""
    return torch.bmm(x, w)


class LinearFns(NamedTuple):
    """Hook for base-model linear layers.

    dense(x, w, b, path): x [..., din] @ w [din, dout] (+ b) -> [..., dout]
    expert(x, w, path):   x [E, C, din] @ w [E, din, dout] -> [E, C, dout]
    """
    dense: Callable
    expert: Callable = _default_expert


DEFAULT_LIN = LinearFns(dense=_default_dense)


# ---------------------------------------------------------------------------
# Initializers (the JAX package's distributions, drawn from a torch.Generator)
# ---------------------------------------------------------------------------

def dense_init(gen, din, dout, dtype, device):
    scale = 1.0 / math.sqrt(din)
    w = torch.empty((din, dout), dtype=torch.float32, device=device)
    return w.uniform_(-scale, scale, generator=gen).to(dtype)


def embed_init(gen, vocab, d, dtype, device):
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------

def rmsnorm_init(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * params["scale"].float()).to(dt)


def head_rmsnorm(scale, x, eps: float = 1e-6):
    """qk-norm: normalize the last (head) dim. scale [hd]."""
    return rmsnorm({"scale": scale}, x, eps)


def rope_frequencies(hd: int, theta: float, device):
    return theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                   device=device) / hd)


def apply_rope(x, positions, theta: float):
    """Split-half RoPE in fp32. x [..., S, H, hd]; positions [..., S] int."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs          # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                  # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attn_init(gen, cfg, dtype, device):
    hd = cfg.hd
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.hp * hd, dtype, device),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype, device),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype, device),
        "wo": dense_init(gen, cfg.hp * hd, cfg.d_model, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _pick_chunk(S: int, B: int, H: int, T: int, chunk_q: int,
                budget_bytes: float = 256e6) -> int:
    """Query-chunk size: a divisor of S bounding the fp32 score buffer
    B*H*c*T*4 <= budget."""
    c = chunk_q
    while c > 16 and (S % c or B * H * c * T * 4 > budget_bytes):
        c //= 2
    while S % c and c > 1:
        c -= 1
    return max(c, 1)


def mha_forward(params, cfg, x, positions, lin: LinearFns, *,
                causal: bool = True, kv_x=None, ext_kv=None,
                path_prefix: str = "", chunk_q: int = 1024):
    """Attention over a sequence (training, prefill, the encoder and
    cross-attention), the plain chunked branch of
    ``repro.models.blocks.mha_forward``. x [B,S,d]; positions [B,S].
    Returns (out [B,S,d], k, v) with k/v [B,T,K,hd] post-RoPE — the values
    the cache stores, so the caller projects K/V once (the JAX prefill
    projects them a second time to capture them).

    Self-attention (``kv_x`` None) is causal by position, or with
    ``causal=False`` (an encoder) attends every lane. ``kv_x`` [B,T,d]
    makes the call cross-attention: K/V are projected from ``kv_x``, every
    lane is attended and nothing is rotated (JAX rotates self-attention
    only). RoPE applies where ``cfg.rope_theta > 0``.

    ``ext_kv`` — optional ``(k, v, positions)``: ALREADY-PROJECTED (post
    qk-norm, post-RoPE) external K/V lanes [B,E,K,hd] with positions [B,E],
    put in front of this call's own K/V before the GQA repeat: the suffix
    prefill attends over a row's shared-prefix pages this way. A lane
    whose position fails the causal mask (unused lanes carry a huge
    position) gets an exact-zero softmax weight. The returned k/v are this
    call's own."""
    B, S, _ = x.shape
    hd, K, H = cfg.hd, cfg.n_kv_heads, cfg.hp
    G = H // K
    src = x if kv_x is None else kv_x
    Tk = src.shape[1]
    q = lin.dense(x, params["wq"], params.get("bq"), path_prefix + "q")
    k = lin.dense(src, params["wk"], params.get("bk"), path_prefix + "k")
    v = lin.dense(src, params["wv"], params.get("bv"), path_prefix + "v")
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, Tk, K, hd)
    v = v.reshape(B, Tk, K, hd)
    if cfg.qk_norm:
        q = head_rmsnorm(params["q_norm"], q)
        k = head_rmsnorm(params["k_norm"], k)
    if kv_x is None and cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    masked = causal and kv_x is None
    ka, va, kv_pos = k, v, positions
    if ext_kv is not None:
        ek, ev, epos = ext_kv
        ka = torch.cat([ek.to(k.dtype), k], dim=1)
        va = torch.cat([ev.to(v.dtype), v], dim=1)
        kv_pos = torch.cat([epos.to(positions.dtype), positions], dim=1)
    T = ka.shape[1]
    kr = ka.repeat_interleave(G, dim=2) if G > 1 else ka    # [B,T,H,hd]
    vr = va.repeat_interleave(G, dim=2) if G > 1 else va
    scale = 1.0 / math.sqrt(hd)
    window = cfg.sliding_window

    def attend(qc, pc):
        s = torch.einsum("bshd,bthd->bhst", qc, kr).float() * scale
        if masked:
            m = pc[:, None, :, None] >= kv_pos[:, None, None, :]
            if window:
                m &= (pc[:, None, :, None] - kv_pos[:, None, None, :]) \
                    < window
            s = s.masked_fill(~m, -1e30)
        p = torch.softmax(s, dim=-1).to(vr.dtype)
        return torch.einsum("bhst,bthd->bshd", p, vr)

    chunk = _pick_chunk(S, B, H, T, chunk_q, budget_bytes=1e9)
    out = torch.cat([attend(q[:, i:i + chunk], positions[:, i:i + chunk])
                     for i in range(0, S, chunk)], dim=1)
    out = out.reshape(B, S, H * hd)
    return lin.dense(out, params["wo"], params.get("bo"), path_prefix + "o"), \
        k, v


def quantize_head(x):
    """Per-head symmetric int8 quantization. x [..., hd] ->
    (q int8 [..., hd], scale f32 [..., 1]). Divides by the scale (not by
    multiplying with its reciprocal) and rounds half to even, as
    ``jnp.round`` does, so equal inputs give the JAX package's bits."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _decode_qkv(params, cfg, x, pos, lin: LinearFns, path_prefix: str):
    """Single-token q/k/v projections + qk-norm + RoPE. x [B,1,d]; pos [B].
    Returns q [B,1,H,hd], k/v [B,1,K,hd]."""
    B = x.shape[0]
    hd, K, H = cfg.hd, cfg.n_kv_heads, cfg.hp
    q = lin.dense(x, params["wq"], params.get("bq"),
                  path_prefix + "q").reshape(B, 1, H, hd)
    k = lin.dense(x, params["wk"], params.get("bk"),
                  path_prefix + "k").reshape(B, 1, K, hd)
    v = lin.dense(x, params["wv"], params.get("bv"),
                  path_prefix + "v").reshape(B, 1, K, hd)
    if cfg.qk_norm:
        q = head_rmsnorm(params["q_norm"], q)
        k = head_rmsnorm(params["k_norm"], k)
    if cfg.rope_theta > 0:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
    return q, k, v


def _paged_attend(params, cfg, q, pools, tbl, pos, lin: LinearFns,
                  path_prefix: str):
    """Attention of one query token read in place from paged pools through
    the decode-attention kernel. q [B,1,H,hd]; pools = (k, v) or (k, k_s,
    v, v_s); tbl [B, n_blocks]; pos [B]. Returns [B,1,d_model] after the
    o-projection."""
    B = q.shape[0]
    hd, K, H = cfg.hd, cfg.n_kv_heads, cfg.hp
    qg = q.reshape(B, K, H // K, hd).contiguous()
    kw = {}
    if len(pools) == 4:
        pool_k, pool_ks, pool_v, pool_vs = pools
        kw = {"k_scale": pool_ks, "v_scale": pool_vs}
    else:
        pool_k, pool_v = pools
    out = decode_attn(qg, pool_k, pool_v, pos, window=cfg.sliding_window,
                      block_tbl=tbl, **kw)
    out = out.reshape(B, 1, H * hd)
    return lin.dense(out, params["wo"], params.get("bo"), path_prefix + "o")


# ---------------------------------------------------------------------------
# Paged KV writes (in place)
# ---------------------------------------------------------------------------

def _drop_index(keep, page, off, n_pages: int):
    """Fixed-shape stand-in for JAX's ``mode="drop"`` over N candidate
    writes (keep, page, off all [N]). A dropped write is pointed at the
    first kept write: same source, page and offset, so duplicates carry the
    same bytes. When nothing is kept, every write points at one clamped
    address and ``paged_write`` writes back what is there. No host sync and
    no data-dependent shape: CUDA-graph capture of a step needs both.
    Returns (src [N], page [N], off [N], any_kept [])."""
    # [1], not a 0-dim index: indexing with a tensor stays on the device
    first = keep.long().argmax(dim=0, keepdim=True)   # first kept, else 0
    src = torch.where(keep, torch.arange(keep.shape[0], device=keep.device),
                      first)
    page = torch.where(keep, page, page[first]).clamp(0, n_pages - 1)
    off = torch.where(keep, off, off[first])
    return src, page, off, keep.any()


def token_write_index(tbl, pos, n_pages: int, blk: int, active=None):
    """Where one token per row lands (``_drop_index`` over the B rows). A
    row is dropped when inactive, when its position is past the table, or
    when the table names a page outside [0, n_pages) — the out-of-range
    sentinel of unmapped entries."""
    pos = pos.long()
    col = pos // blk
    keep = col < tbl.shape[1]
    page = tbl.gather(1, col.clamp_max(tbl.shape[1] - 1)[:, None])[:, 0].long()
    keep &= (page >= 0) & (page < n_pages)
    if active is not None:
        keep &= active
    return _drop_index(keep, page, pos % blk, n_pages)


def prefill_write_index(tbl, S: int, n_pages: int, blk: int, lengths=None,
                        start=None):
    """Where a prefill's tokens land (``_drop_index`` over the B*S
    positions, row-major). ``start`` [B] (optional) shifts row b's token t
    to logical position start[b] + t — the suffix prefill, which writes
    past a row's shared-prefix pages; a column past the table is clipped
    to its last entry, as JAX's ``mode="clip"``. A position is dropped
    when it is at or past the row's length (right padding never touches
    the pool) or its table entry names a page outside [0, n_pages)."""
    t = torch.arange(S, device=tbl.device)
    if start is None:
        page = tbl[:, t // blk].long()                     # [B, S]
        off = (t % blk).expand_as(page)
    else:
        logical = start.long()[:, None] + t[None, :]
        col = (logical // blk).clamp_max(tbl.shape[1] - 1)
        page = tbl.gather(1, col).long()
        off = logical % blk
    keep = (page >= 0) & (page < n_pages)
    if lengths is not None:
        keep &= t[None, :] < lengths.long()[:, None]
    return _drop_index(keep.reshape(-1), page.reshape(-1), off.reshape(-1),
                       n_pages)


def paged_write(pool, index, x, page_offset: int = 0):
    """Write the candidate rows x [N, ...] (a decode step's B tokens, or a
    prefill's B*S positions flattened) at ``index`` (``token_write_index``
    / ``prefill_write_index``), IN PLACE. ``page_offset`` addresses one
    layer's page range of a layer-fused pool."""
    src, page, off, any_kept = index
    page = page + page_offset
    val = x[src].to(pool.dtype)
    pool[page, off] = torch.where(any_kept, val, pool[page, off])


def mha_decode_paged(params, cfg, x, pool_k, pool_v, tbl, pos,
                     lin: LinearFns, *, write, path_prefix: str = ""):
    """Single-token decode against a paged KV cache.

    pool_k/v [P, block, K, hd]; tbl [B, n_blocks]; pos [B]; ``write`` is the
    step's ``token_write_index`` with its pages offset to this layer's
    (inactive rows already dropped). The new token's K/V is written through
    the table first (IN PLACE), then the kernel attends over the pages in
    place — so it reads the current token from the pool. Returns out
    [B,1,d]."""
    q, k, v = _decode_qkv(params, cfg, x, pos, lin, path_prefix)
    paged_write(pool_k, write, k[:, 0])
    paged_write(pool_v, write, v[:, 0])
    return _paged_attend(params, cfg, q, (pool_k, pool_v), tbl, pos, lin,
                         path_prefix)


def mha_decode_quant_paged(params, cfg, x, pool_k, pool_ks, pool_v, pool_vs,
                           tbl, pos, lin: LinearFns, *, write,
                           path_prefix: str = ""):
    """Paged + int8 decode: pools hold int8 entries [P, block, K, hd] and
    f32 per-head scales [P, block, K, 1]. Same contract as
    ``mha_decode_paged``: the new token's K/V is quantized and its four
    leaves written IN PLACE through the same ``write`` index, then the
    int8 kernel dequantizes each page as it streams. Returns out
    [B,1,d]."""
    q, k, v = _decode_qkv(params, cfg, x, pos, lin, path_prefix)
    kq, ks = quantize_head(k[:, 0])
    vq, vs = quantize_head(v[:, 0])
    for pool, val in ((pool_k, kq), (pool_ks, ks), (pool_v, vq),
                      (pool_vs, vs)):
        paged_write(pool, write, val)
    return _paged_attend(params, cfg, q, (pool_k, pool_ks, pool_v, pool_vs),
                         tbl, pos, lin, path_prefix)


# ---------------------------------------------------------------------------
# Dense KV caches: one [B, T, K, hd] row per slot (T = max_seq, or a ring of
# depth T under a sliding window)
# ---------------------------------------------------------------------------

def ring_valid_mask(pos, window: int):
    """Live lanes of a ring and their absolute positions: lane s holds the
    position p with p % window == s, p <= pos and p > pos - window.
    Returns (mask [B, window] bool, abs_pos [B, window] int32)."""
    s = torch.arange(window, device=pos.device)[None, :]
    p = pos.long()[:, None]
    abs_pos = torch.div(p - s, window, rounding_mode="floor") * window + s
    mask = (abs_pos >= 0) & (abs_pos <= p)
    return mask, abs_pos.to(torch.int32)


def _decode_valid(cfg, pos, T: int, ring: bool):
    """[B, T] validity of cache lanes for a query at position pos (on a
    ring, ``ring_valid_mask``'s lanes)."""
    if ring:
        valid, lane_pos = ring_valid_mask(pos, T)
    else:
        valid = torch.arange(T, device=pos.device)[None, :] <= pos[:, None]
        lane_pos = torch.arange(T, device=pos.device)[None, :]
    if cfg.sliding_window:
        valid &= (pos.long()[:, None] - lane_pos) < cfg.sliding_window
    return valid


def _decode_attend(params, cfg, q, cache_k, cache_v, valid, lin: LinearFns,
                   path_prefix: str):
    """Attention of one query token against a dense [B, T, K, hd] cache view
    as plain torch ops (the ring cache's path): grouped GQA scores in fp32,
    masked by ``valid`` [B, T], softmax cast to the cache dtype, as JAX."""
    B = q.shape[0]
    hd, K, H = cfg.hd, cfg.n_kv_heads, cfg.hp
    qg = q.reshape(B, 1, K, H // K, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, cache_k).float() \
        * (1.0 / math.sqrt(hd))
    s = s.masked_fill(~valid[:, None, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", p, cache_v).reshape(B, 1, H * hd)
    return lin.dense(out, params["wo"], params.get("bo"), path_prefix + "o")


def _decode_attend_quant(params, cfg, q, cache_k, cache_ks, cache_v, cache_vs,
                         valid, lin: LinearFns, path_prefix: str, out_dtype):
    """Attention of one query token against an int8 [B, T, K, hd] cache view
    with per-entry f32 scales [B, T, K, 1], in JAX's order of scaling: the
    k-scale on the fp32 scores, the v-scale on the probabilities, an fp32
    PV product cast to ``out_dtype``."""
    B = q.shape[0]
    hd, K, H = cfg.hd, cfg.n_kv_heads, cfg.hp
    qg = q.reshape(B, 1, K, H // K, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg.float(), cache_k.float())
    s = s * cache_ks[..., 0].permute(0, 2, 1)[:, :, None, None, :] \
        * (1.0 / math.sqrt(hd))
    s = s.masked_fill(~valid[:, None, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    pv = p * cache_vs[..., 0].permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bkgst,btkh->bskgh", pv, cache_v.float()).to(out_dtype)
    return lin.dense(out.reshape(B, 1, H * hd), params["wo"],
                     params.get("bo"), path_prefix + "o")


def dense_write_index(pos, T: int, ring: bool, active=None):
    """Where one token per row lands in a dense cache: lane ``pos`` (``pos %
    T`` on a ring), kept where the row is active and, off a ring, where the
    lane exists. Returns (rows [B], lane [B], keep [B]): fixed shapes, no
    host sync."""
    pos = pos.long()
    lane = pos % T if ring else pos.clamp(0, T - 1)
    keep = torch.ones_like(pos, dtype=torch.bool) if ring else pos < T
    if active is not None:
        keep = keep & active
    return torch.arange(pos.shape[0], device=pos.device), lane, keep


def dense_write(cache, index, x):
    """Write x [B, ...] (one token per row) into cache [B, T, ...] IN PLACE
    at ``index`` (``dense_write_index``): a row that is not kept writes
    back what its lane holds, so its bits stay."""
    rows, lane, keep = index
    old = cache[rows, lane]
    keep = keep.reshape(keep.shape + (1,) * (old.ndim - 1))
    cache[rows, lane] = torch.where(keep, x.to(cache.dtype), old)


def mha_decode(params, cfg, x, cache_k, cache_v, pos, lin: LinearFns, *,
               write, path_prefix: str = "", ring: bool = False):
    """Single-token decode against a dense cache. x [B,1,d]; cache_k/v
    [B,T,K,hd], one layer's slab, written IN PLACE; pos [B]; ``write`` the
    step's ``dense_write_index`` (an inactive row keeps its lanes: JAX
    writes every row with a select over T and its caller's merge restores
    the inactive ones). Returns out [B,1,d].

    ``ring`` treats the cache as a ring of depth T (slot pos % T, validity
    from absolute positions; ``cfg.sliding_window`` <= T) and attends in
    plain torch, as JAX does. Off a ring the attention is the dense
    decode-attention kernel (``kernels.decode_attn``: the CUDA kernel on a
    CUDA tensor, its plain version on a CPU one), lanes t <= pos inside the
    window. Two departures from JAX, whose dense path is a plain einsum
    (``_decode_attend``, plain there so that GSPMD can shard the cache on
    T) and never reaches its dense kernel: the kernel keeps the
    probabilities in fp32 through PV, where the einsum casts them to the
    cache dtype; and it sums the softmax in splits."""
    q, k, v = _decode_qkv(params, cfg, x, pos, lin, path_prefix)
    dense_write(cache_k, write, k[:, 0])
    dense_write(cache_v, write, v[:, 0])
    if ring:
        valid = _decode_valid(cfg, pos, cache_k.shape[1], ring=True)
        return _decode_attend(params, cfg, q, cache_k, cache_v, valid, lin,
                              path_prefix)
    B = q.shape[0]
    hd, K, H = cfg.hd, cfg.n_kv_heads, cfg.hp
    out = decode_attn(q.reshape(B, K, H // K, hd).contiguous(), cache_k,
                      cache_v, pos, window=cfg.sliding_window)
    return lin.dense(out.reshape(B, 1, H * hd), params["wo"],
                     params.get("bo"), path_prefix + "o")


def mha_decode_quant(params, cfg, x, cache_k, cache_ks, cache_v, cache_vs,
                     pos, lin: LinearFns, *, write, path_prefix: str = "",
                     ring: bool = False):
    """Single-token decode against an int8 dense cache: entries [B,T,K,hd]
    and f32 per-head scales [B,T,K,1], the token's four leaves quantized
    and written IN PLACE through ``write``, then plain-torch attention
    (``_decode_attend_quant``), ring or not, as in JAX, where no kernel
    serves this layout. Returns out [B,1,d]."""
    q, k, v = _decode_qkv(params, cfg, x, pos, lin, path_prefix)
    kq, ks = quantize_head(k[:, 0])
    vq, vs = quantize_head(v[:, 0])
    for cache, val in ((cache_k, kq), (cache_ks, ks), (cache_v, vq),
                       (cache_vs, vs)):
        dense_write(cache, write, val)
    valid = _decode_valid(cfg, pos, cache_k.shape[1], ring)
    return _decode_attend_quant(params, cfg, q, cache_k, cache_ks, cache_v,
                                cache_vs, valid, lin, path_prefix, x.dtype)


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------

def cross_decode(params, cfg, x, enc_k, enc_v, lin: LinearFns, *,
                 path_prefix: str = "xattn_"):
    """Cross-attention of one decoder token against its row's fixed
    encoder cache (``repro.models.blocks.cross_decode``, a plain einsum
    there too). x [B,1,d]; enc_k/v [B,Te,K,hd]. Returns out [B,1,d]."""
    B = x.shape[0]
    hd, K, H = cfg.hd, cfg.n_kv_heads, cfg.hp
    q = lin.dense(x, params["wq"], params.get("bq"),
                  path_prefix + "q").reshape(B, 1, K, H // K, hd)
    s = torch.einsum("bskgh,btkh->bkgst", q, enc_k).float() / math.sqrt(hd)
    p = torch.softmax(s, dim=-1).to(enc_v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", p, enc_v).reshape(B, 1, H * hd)
    return lin.dense(out, params["wo"], params.get("bo"), path_prefix + "o")


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg, dtype, device, d_ff=None, gelu: bool = False,
             bias: bool = False):
    """SwiGLU ``gate`` / ``up`` / ``down``, or with ``gelu`` the
    whisper-style ``fc1`` / ``fc2`` (with ``bias``, zero ``b1`` / ``b2``)."""
    d_ff = d_ff or cfg.d_ff
    if gelu:
        p = {"fc1": dense_init(gen, cfg.d_model, d_ff, dtype, device),
             "fc2": dense_init(gen, d_ff, cfg.d_model, dtype, device)}
        if bias:
            p["b1"] = torch.zeros((d_ff,), dtype=dtype, device=device)
            p["b2"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
        return p
    return {"gate": dense_init(gen, cfg.d_model, d_ff, dtype, device),
            "up": dense_init(gen, cfg.d_model, d_ff, dtype, device),
            "down": dense_init(gen, d_ff, cfg.d_model, dtype, device)}


def mlp_forward(params, x, lin: LinearFns, *, path_prefix: str = ""):
    """SwiGLU MLP, or the GELU MLP of a params tree with ``fc1`` (JAX's
    ``jax.nn.gelu``, whose default is the tanh approximation)."""
    if "fc1" in params:
        h = lin.dense(x, params["fc1"], params.get("b1"), path_prefix + "fc1")
        h = F.gelu(h, approximate="tanh")
        return lin.dense(h, params["fc2"], params.get("b2"),
                         path_prefix + "fc2")
    g = lin.dense(x, params["gate"], None, path_prefix + "gate")
    u = lin.dense(x, params["up"], None, path_prefix + "up")
    return lin.dense(F.silu(g) * u, params["down"], None, path_prefix + "down")
