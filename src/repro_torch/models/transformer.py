"""Decoder-only transformer (dense, MoE and VLM backbones): the training
forward, the paged and the dense KV layouts — ``repro.models.transformer``.

Parameters are plain dicts of tensors: ``embed`` [V,d], ``final_norm``,
``lm_head`` [d,V] and ``layers``, a list with one dict per layer (the JAX
package stacks layers on a leading [L] axis and scans; here ``lax.scan`` is
a Python loop over that list). The ``LinCtx`` hook threads Symbiosis split
execution through every frozen matmul; ``adapter`` is a PEFT tree whose
``layers`` leaves carry a leading [L] axis and are sliced per layer. A
prefix-tuning adapter adds its own attention branch (``_prefix_attend``),
gated per row in a mixed-method batch.

Heterogeneous layers: a layer's FFN is a dense ``mlp`` or an MoE ``moe``
(``models.moe``, drop-free on every serving path), Arctic's MoE layers
carrying a dense ``mlp`` in parallel too. The first
``cfg.first_dense_layers`` layers (JAX's unrolled ``pre_layers``) are
dense; every later layer has the structure of the first of them (JAX's
scanned layers share one). The port keeps them all in the one ``layers``
list and every KV cache over all ``n_layers`` layers (``convert`` folds
JAX's separate pre-layer trees in as layer 0). A VLM batch may carry
``img_embed`` [B, Ti, d] (``data.pipeline.frontend_stub``): the image
tokens lead the text, positions run over both, and prefill caches both.

Paged caches keep one tensor per pool leaf, [L, P, blk, K, hd]: ``k`` and
``v`` in the activation dtype or, for an int8 cache, ``k``/``v`` in int8
and their per-head f32 scales ``k_s``/``v_s`` [L, P, blk, K, 1]. The layer
axis is fused into the page axis ([L*P, ...], a view) and layer i
addresses its pages through ``tbl + i*P``, as in the JAX package — the pool
is never sliced or copied; decode and prefill write it IN PLACE.

Dense caches (no ``block_tbl``) keep the same leaves as [L, B, T, K, hd]
(``_s`` scales [L, B, T, K, 1]): layer i's slab ``leaf[i]`` is a contiguous
[B, T, K, hd] view that the dense decode-attention kernel reads as it is.
``window`` makes T a ring of depth ``min(window, max_seq)`` (decode with
``ring=True``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.config import VLM, ModelConfig, check_family
from repro_torch.models import blocks, moe as moe_lib
from repro_torch.models.blocks import DEFAULT_LIN, LinearFns


class LinCtx(NamedTuple):
    """Linear-hook context. ``top`` serves embed/lm_head; ``for_layer``
    binds a per-layer adapter slice into a LinearFns."""
    top: LinearFns
    for_layer: Callable[[Any], LinearFns]


DEFAULT_CTX = LinCtx(top=DEFAULT_LIN, for_layer=lambda adapter_slice: DEFAULT_LIN)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _is_moe(cfg: ModelConfig, layer_idx: int) -> bool:
    """Whether layer ``layer_idx`` has an MoE FFN: every layer from
    ``first_dense_layers`` on is shaped like that first one."""
    n_pre = cfg.first_dense_layers
    if layer_idx < n_pre:
        return False
    return cfg.is_moe_layer(n_pre)


def _layer_init(gen, cfg: ModelConfig, layer_idx: int, dtype, device):
    p = {
        "ln1": blocks.rmsnorm_init(cfg.d_model, dtype, device),
        "ln2": blocks.rmsnorm_init(cfg.d_model, dtype, device),
        "attn": blocks.attn_init(gen, cfg, dtype, device),
    }
    if _is_moe(cfg, layer_idx):
        p["moe"] = moe_lib.moe_init(gen, cfg, dtype, device)
        if cfg.dense_residual:
            p["mlp"] = blocks.mlp_init(gen, cfg, dtype, device)
    else:
        p["mlp"] = blocks.mlp_init(gen, cfg, dtype, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random base parameters from ``generator`` (which must live on
    ``device``), with the JAX package's distributions: linears uniform in
    ±1/sqrt(din), embeddings normal * 0.02, norm scales 1."""
    check_family(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg.param_dtype)
    params = {
        "embed": blocks.embed_init(generator, cfg.vocab, cfg.d_model, dtype, dev),
        "final_norm": blocks.rmsnorm_init(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = blocks.dense_init(generator, cfg.d_model, cfg.vocab,
                                              dtype, dev)
    params["layers"] = [_layer_init(generator, cfg, i, dtype, dev)
                        for i in range(cfg.n_layers)]
    return params


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------

def _tree_index(tree, i):
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def _adapter_layer(adapter, i):
    """Layer i's slice of an adapter tree (leaves [L, ...] -> [...])."""
    if adapter is None:
        return None
    return _tree_index(adapter["layers"], i)


def _prefix_entries(adapter_slice):
    """[(prefix_k, prefix_v, rows_mask or None), ...] of a per-layer
    adapter slice. A plain slice carries its prefix leaves at top level
    (mask None: every row attends the prefix); a MIXED-method slice nests
    one ``m<id>`` sub-dict per bank, and a prefix bank's carries per-row
    leaves and the ``prefix_rows`` membership mask that gates its add."""
    if not isinstance(adapter_slice, dict):
        return []
    out = []
    if "prefix_k" in adapter_slice:
        out.append((adapter_slice["prefix_k"], adapter_slice["prefix_v"],
                    adapter_slice.get("prefix_rows")))
    for name in sorted(adapter_slice):
        sub = adapter_slice[name]
        if isinstance(sub, dict) and "prefix_k" in sub:
            out.append((sub["prefix_k"], sub["prefix_v"],
                        sub.get("prefix_rows")))
    return out


def _prefix_attend(attn_p, cfg: ModelConfig, h, prefix_kv, lin: LinearFns):
    """Prefix tuning: the queries also attend to learned virtual K/V, as a
    separate softmax branch added to the attention output (the JAX
    package's additive form). prefix_k/v are [n_prefix, K, hd] shared by
    the batch, or per-row [B, n_prefix, K, hd] in a compacted batch. q and
    o go through the layer's linear hooks (no bias); scores and softmax in
    fp32, cast back to the activation dtype; the branch is scaled by
    0.1."""
    B, S, _ = h.shape
    hd, K, H = cfg.hd, cfg.n_kv_heads, cfg.n_heads
    G = H // K
    pk, pv = prefix_kv
    q = lin.dense(h, attn_p["wq"], None, "q").reshape(B, S, K, G, hd)
    rows = "b" if pk.ndim == 4 else ""
    s = torch.einsum(f"bskgh,{rows}pkh->bkgsp", q, pk.to(h.dtype)).float()
    p = torch.softmax(s / math.sqrt(hd), dim=-1).to(h.dtype)
    out = torch.einsum(f"bkgsp,{rows}pkh->bskgh", p, pv.to(h.dtype))
    return lin.dense(out.reshape(B, S, H * hd), attn_p["wo"], None, "o") * 0.1


def _apply_prefixes(attn, attn_p, cfg: ModelConfig, h, adapter_slice,
                    lin: LinearFns):
    """Fold every prefix adapter's branch into the attention output; in a
    mixed batch only the bank's member rows take it (a select keeps the
    other rows' bits: adding a zeroed branch would turn -0.0 into +0.0)."""
    for pk, pv, rows in _prefix_entries(adapter_slice):
        pfx = _prefix_attend(attn_p, cfg, h, (pk, pv), lin)
        if rows is None:
            attn = attn + pfx
        else:
            attn = torch.where(rows.reshape(rows.shape + (1,) * (attn.ndim - 1)),
                               attn + pfx, attn)
    return attn


def _ffn(p, cfg: ModelConfig, h, lin: LinearFns, with_aux: bool, *,
         capacity_factor=None, moe_dispatch: str = "scatter", rows: int = 1):
    """The layer's FFN: (y, aux). An MoE layer's aux is its load-balance
    loss (Arctic's dense residual added in parallel), per group of
    ``rows`` (``moe.moe_forward``), None without ``with_aux``; a dense
    layer's is None. Serving callers keep the defaults: drop-free."""
    if "moe" in p:
        y, aux = moe_lib.moe_forward(p["moe"], cfg, h, lin,
                                     capacity_factor=capacity_factor,
                                     dispatch=moe_dispatch,
                                     with_aux=with_aux, rows=rows)
        if "mlp" in p:
            y = y + blocks.mlp_forward(p["mlp"], h, lin)
        return y, aux
    return blocks.mlp_forward(p["mlp"], h, lin), None


def _layer_forward(p, cfg: ModelConfig, x, positions, lin: LinearFns,
                   adapter_slice=None, *, ext_kv=None, with_aux=False,
                   **moe_kw):
    """One layer over a sequence: (x, k, v, aux), with its own K/V
    [B,S,K,hd] (``ext_kv`` lanes, see ``blocks.mha_forward``, are attended
    to but not returned) and its FFN's aux loss or None (``_ffn``, which
    takes ``moe_kw``)."""
    h = blocks.rmsnorm(p["ln1"], x)
    attn, k, v = blocks.mha_forward(p["attn"], cfg, h, positions, lin,
                                    ext_kv=ext_kv)
    attn = _apply_prefixes(attn, p["attn"], cfg, h, adapter_slice, lin)
    x = x + attn
    y, aux = _ffn(p, cfg, blocks.rmsnorm(p["ln2"], x), lin, with_aux,
                  **moe_kw)
    return x + y, k, v, aux


def _layer_decode(p, cfg: ModelConfig, x, pools, pos, lin: LinearFns,
                  adapter_slice=None, *, tbl, write, ring: bool = False):
    """One layer's single-token step against (layer-fused) page pools, or,
    with ``tbl`` None, against this layer's dense slabs; an int8 cache is
    told by its ``k_s`` leaf, as in the JAX package."""
    h = blocks.rmsnorm(p["ln1"], x)
    if tbl is None:
        if "k_s" in pools:
            attn = blocks.mha_decode_quant(
                p["attn"], cfg, h, pools["k"], pools["k_s"], pools["v"],
                pools["v_s"], pos, lin, write=write, ring=ring)
        else:
            attn = blocks.mha_decode(p["attn"], cfg, h, pools["k"],
                                     pools["v"], pos, lin, write=write,
                                     ring=ring)
    elif "k_s" in pools:
        attn = blocks.mha_decode_quant_paged(
            p["attn"], cfg, h, pools["k"], pools["k_s"], pools["v"],
            pools["v_s"], tbl, pos, lin, write=write)
    else:
        attn = blocks.mha_decode_paged(p["attn"], cfg, h, pools["k"],
                                       pools["v"], tbl, pos, lin, write=write)
    attn = _apply_prefixes(attn, p["attn"], cfg, h, adapter_slice, lin)
    x = x + attn
    return x + _ffn(p, cfg, blocks.rmsnorm(p["ln2"], x), lin, False)[0]


def embed_tokens(cfg, params, tokens, lin: LinearFns):
    return params["embed"][tokens.long()].to(_dtype(cfg.dtype))


def _embed_batch(cfg, params, batch, lin: LinearFns):
    """Token embeddings [B, S_total, d]: a VLM batch's ``img_embed``
    [B, Ti, d] leads its text (S_total = Ti + S)."""
    x = embed_tokens(cfg, params, batch["tokens"], lin)
    if cfg.arch == VLM and "img_embed" in batch:
        x = torch.cat([batch["img_embed"].to(x.dtype), x], dim=1)
    return x


def lm_head(cfg, params, x, lin: LinearFns):
    w = params.get("lm_head")
    if w is None:
        w = params["embed"].T
    return lin.dense(x, w, None, "lm_head")


# ---------------------------------------------------------------------------
# Forward (train / scoring)
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params, batch, ctx: LinCtx = DEFAULT_CTX,
            adapter=None, *, remat: bool = True, with_aux: bool = False,
            capacity_factor=None, moe_dispatch: str = "scatter",
            rows: int = 1):
    """Training / scoring forward over whole sequences. batch: tokens [B,S]
    (+ ``img_embed`` [B,Ti,d] for a VLM: the image prefix, then the text).
    Returns logits [B,S_total,V], or with ``with_aux`` (logits, aux) where
    aux is the MoE layers' summed load-balance loss (JAX's second output;
    0 for the dense family), [rows] when ``rows > 1``.

    ``capacity_factor`` (None: drop-free), ``moe_dispatch`` and ``rows``
    go to every MoE layer (``moe.moe_forward``): with ``rows=R`` the B
    sequences are R bank rows of B/R each, and each row routes and drops
    alone. A training call (``with_aux`` under grad) recomputes each MoE
    body in the backward. Attention is the plain ``blocks.mha_forward``,
    as in the JAX package, whose training forward reaches no kernel.
    ``remat`` recomputes each layer body in the backward
    (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint`` of
    the scan body), so only the layer inputs are held between the
    passes."""
    x = _embed_batch(cfg, params, batch, ctx.top)
    B, S_total = x.shape[:2]
    positions = torch.arange(S_total, device=x.device)[None, :] \
        .expand(B, S_total)
    aux = torch.zeros((rows,) if rows > 1 else (), dtype=torch.float32,
                      device=x.device) if with_aux else None
    moe_kw = dict(capacity_factor=capacity_factor, moe_dispatch=moe_dispatch,
                  rows=rows)
    for i, p in enumerate(params["layers"]):
        ad = _adapter_layer(adapter, i)
        lin = ctx.for_layer(ad)

        def body(x, p=p, lin=lin, ad=ad):
            x, _, _, a = _layer_forward(p, cfg, x, positions, lin, ad,
                                        with_aux=with_aux, **moe_kw)
            return x, a

        if remat:
            x, a = torch.utils.checkpoint.checkpoint(body, x,
                                                     use_reentrant=False)
        else:
            x, a = body(x)
        if a is not None:
            aux = aux + a
    x = blocks.rmsnorm(params["final_norm"], x)
    logits = lm_head(cfg, params, x, ctx.top)
    return (logits, aux) if with_aux else logits


# ---------------------------------------------------------------------------
# KV caches (paged or dense), decode and prefill
# ---------------------------------------------------------------------------

def default_block_table(batch_size: int, max_seq: int, page_block: int,
                        pool_pages: int = 0, device="cuda"):
    """(n_blocks, pool size, initial table) for a paged cache: identity
    layout for an auto-sized pool, zeros (caller-managed) otherwise."""
    n_blocks = -(-max_seq // page_block)
    if pool_pages:
        return n_blocks, pool_pages, torch.zeros(
            (batch_size, n_blocks), dtype=torch.int32, device=device)
    tbl = torch.arange(batch_size * n_blocks, dtype=torch.int32,
                       device=device).reshape(batch_size, n_blocks)
    return n_blocks, batch_size * n_blocks, tbl


def pool_leaves(shape, dtype, quant: bool, device):
    """Zeroed KV leaves of one cache. shape = (..., K, hd): {"k", "v"} in
    ``dtype``, or with ``quant`` int8 {"k", "v"} and f32 per-head scales
    {"k_s", "v_s"} of shape (..., K, 1)."""
    if not quant:
        return {n: torch.zeros(shape, dtype=dtype, device=device)
                for n in ("k", "v")}
    scales = shape[:-1] + (1,)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(scales, dtype=torch.float32, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_s": torch.zeros(scales, dtype=torch.float32, device=device)}


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               *, window: int = 0, quant: bool = False, page_block: int = 0,
               pool_pages: int = 0, device="cuda"):
    """KV cache of ``batch_size`` slots, ``pos`` [B] and the leaves of
    ``pool_leaves`` (with ``quant``, int8 entries and f32 scales).

    ``page_block > 0``: paged, pools [L, P, page_block, K, hd] and
    ``block_tbl`` [B, n_blocks]; pool_pages=0 fully provisions. Otherwise
    dense, [L, B, T, K, hd] with T = max_seq, or with ``window > 0`` a ring
    of depth ``min(window, max_seq)`` (decode it with ``ring=True``)."""
    check_family(cfg)
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg.dtype)
    K, hd = cfg.n_kv_heads, cfg.hd
    pos = torch.zeros((batch_size,), dtype=torch.int32, device=dev)
    if not page_block:
        T = min(window, max_seq) if window else max_seq
        return {"layers": pool_leaves((cfg.n_layers, batch_size, T, K, hd),
                                      dtype, quant, dev), "pos": pos}
    if window:
        raise ValueError("the paged cache subsumes the ring-buffer variant "
                         "(window=)")
    _, P, tbl = default_block_table(batch_size, max_seq, page_block,
                                    pool_pages, dev)
    shape = (cfg.n_layers, P, page_block, K, hd)
    return {"layers": pool_leaves(shape, dtype, quant, dev), "pos": pos,
            "block_tbl": tbl}


def _fused(layers):
    """[L, P, ...] pool leaves as [L*P, ...] views (no copy) + (L, P, blk)."""
    L, P, blk = layers["k"].shape[:3]
    return ({n: t.view((L * P,) + t.shape[2:]) for n, t in layers.items()},
            L, P, blk)


def decode_step(cfg: ModelConfig, params, cache, token, ctx: LinCtx = DEFAULT_CTX,
                adapter=None, *, ring: bool = False, active=None):
    """One decode step. token [B] int. Returns (logits [B,V], new cache).

    The KV leaves are written IN PLACE (the new cache holds the same
    tensors); ``active`` [B] bool drops the writes of inactive rows (their
    pos/logits are discarded by the caller's merge). A paged cache is
    written through its block table; a dense one at lane ``pos``, or
    ``pos % T`` with ``ring`` (ignored on a paged cache, as in JAX)."""
    pos = cache["pos"]
    tbl = cache.get("block_tbl")
    x = embed_tokens(cfg, params, token[:, None], ctx.top)
    if tbl is None:
        T = cache["layers"]["k"].shape[2]
        write = blocks.dense_write_index(pos, T, ring, active)
        for i, p in enumerate(params["layers"]):
            ad = _adapter_layer(adapter, i)
            slabs = {n: t[i] for n, t in cache["layers"].items()}
            x = _layer_decode(p, cfg, x, slabs, pos, ctx.for_layer(ad), ad,
                              tbl=None, write=write, ring=ring)
    else:
        fused, _, Pl, blk = _fused(cache["layers"])
        src, page, off, any_kept = blocks.token_write_index(tbl, pos, Pl,
                                                            blk, active)
        for i, p in enumerate(params["layers"]):
            ad = _adapter_layer(adapter, i)
            x = _layer_decode(p, cfg, x, fused, pos, ctx.for_layer(ad), ad,
                              tbl=tbl + i * Pl,
                              write=(src, page + i * Pl, off, any_kept))
    x = blocks.rmsnorm(params["final_norm"], x)
    logits = lm_head(cfg, params, x, ctx.top)[:, 0]
    return logits, dict(cache, pos=pos + 1)


def _dense_prefill_write(leaf, val, write_rows):
    """Write a prefill's K/V (or scales) val [B, S, ...] into one layer's
    dense slab [B, T, ...] at lanes [0, S) IN PLACE, every position of the
    row (pads included, as JAX's ``dynamic_update_slice``); rows where
    ``write_rows`` [B] is False keep their bits."""
    S = val.shape[1]
    val = val.to(leaf.dtype)
    if write_rows is not None:
        keep = write_rows.reshape((-1,) + (1,) * (val.ndim - 1))
        val = torch.where(keep, val, leaf[:, :S])
    leaf[:, :S] = val


def prefill(cfg: ModelConfig, params, batch, cache, ctx: LinCtx = DEFAULT_CTX,
            adapter=None, *, lengths=None, starts=None, ext_blocks: int = 0,
            write_rows=None):
    """Prefill over right-padded prompts, filling the cache IN PLACE.

    ``lengths`` [B] (optional) are the true prompt lengths: logits are taken
    at each row's last real position and decode resumes at ``pos =
    lengths``. K/V are projected once per layer and used for both the
    attention and the cache write; an int8 cache stores them quantized
    per head, while the attention uses them as computed, so prefill logits
    do not depend on the cache's format.

    A paged cache is written only at positions < lengths (a row of length 0
    writes nothing). A dense cache takes every one of the S positions at
    lanes [0, S) — pads past a row's length are harmless, as in JAX: decode
    writes lane ``pos`` before it reads it — and ``write_rows`` [B] bool
    (dense only; the port's in-place form of its JAX callers' merge) keeps
    the bits of the rows where it is False.

    A VLM batch's ``img_embed`` [B, Ti, d] leads every row: positions run
    over the Ti + S tokens, all Ti image tokens and the row's ``lengths``
    text tokens are cached, logits are taken at position Ti + lengths - 1
    and decode resumes at Ti + lengths (JAX's ``prefix``).

    ``starts`` [B] (optional, paged only) makes this a SUFFIX prefill: row
    b already holds ``starts[b]`` tokens of K/V in the pages its table
    names (shared prefix pages mapped at admission), this call's tokens sit
    at logical positions ``starts[b] + t``, decode resumes at ``starts +
    lengths``, and the first ``ext_blocks`` table entries of every row are
    read as external K/V lanes (``blocks.mha_forward``'s ``ext_kv``); a
    lane at or past the row's start is masked by position. Table entries
    are clamped into the pool before the gather (an unmapped entry holds
    the out-of-range sentinel; torch does not clamp as JAX's gather does),
    and each layer's lanes are gathered BEFORE that layer writes its
    suffix (JAX gathers every layer's before its scan). ``ext_blocks > 0``
    needs ``starts`` and an unquantized cache: int8 K/V does not
    round-trip."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x = _embed_batch(cfg, params, batch, ctx.top)
    S = x.shape[1]                                   # S_total
    prefix = S - tokens.shape[1]                     # leading image tokens
    if lengths is not None:
        lengths = prefix + lengths.to(torch.int32)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    tbl = cache.get("block_tbl")
    if tbl is None:
        if starts is not None:
            raise ValueError("suffix prefill (starts=) needs a paged cache")
        layers = cache["layers"]
    else:
        if write_rows is not None:
            raise ValueError("write_rows is for dense caches: a paged row "
                             "of length 0 writes nothing")
        if starts is not None:
            starts = starts.to(torch.int32)
            positions = starts[:, None] + positions
        layers, _, Pl, blk = _fused(cache["layers"])
        index = blocks.prefill_write_index(tbl, S, Pl, blk, lengths,
                                           start=starts)
    if ext_blocks:
        if starts is None:
            raise ValueError("ext_blocks needs starts (suffix prefill)")
        if "k_s" in layers:
            raise ValueError("shared-prefix prefill needs an unquantized "
                             "paged cache (int8 K/V doesn't round-trip)")
        etbl = tbl[:, :ext_blocks].long().clamp(0, Pl - 1)       # [B, E]
        lane = torch.arange(ext_blocks * blk, device=tbl.device)[None, :]
        epos = torch.where(lane < starts[:, None], lane, 1 << 30)
    for i, p in enumerate(params["layers"]):
        ad = _adapter_layer(adapter, i)
        ext = None
        if ext_blocks:
            ext = tuple(layers[n][etbl + i * Pl].reshape(
                (B, ext_blocks * blk) + layers[n].shape[2:])
                for n in ("k", "v")) + (epos,)
        x, k, v, _ = _layer_forward(p, cfg, x, positions, ctx.for_layer(ad),
                                    ad, ext_kv=ext)
        if "k_s" in layers:
            parts = zip(("k", "k_s", "v", "v_s"),
                        blocks.quantize_head(k) + blocks.quantize_head(v))
        else:
            parts = (("k", k), ("v", v))
        for name, val in parts:
            if tbl is None:
                _dense_prefill_write(layers[name][i], val, write_rows)
            else:
                blocks.paged_write(layers[name], index, val.flatten(0, 1),
                                   page_offset=i * Pl)
    x = blocks.rmsnorm(params["final_norm"], x)
    if lengths is None:
        logits = lm_head(cfg, params, x[:, -1:], ctx.top)[:, 0]
        pos = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    else:
        last = (lengths.long() - 1).clamp_min(0)
        xg = x[torch.arange(B, device=x.device), last][:, None]
        logits = lm_head(cfg, params, xg, ctx.top)[:, 0]
        pos = lengths.to(torch.int32)
    if starts is not None:            # decode resumes after prefix + suffix
        pos = starts + pos
    return logits, dict(cache, pos=pos)
