"""Decoder-only dense transformer: the training forward and the paged KV
layout — the dense branch of ``repro.models.transformer``.

Parameters are plain dicts of tensors: ``embed`` [V,d], ``final_norm``,
``lm_head`` [d,V] and ``layers``, a list with one dict per layer (the JAX
package stacks layers on a leading [L] axis and scans; here ``lax.scan`` is
a Python loop over that list). The ``LinCtx`` hook threads Symbiosis split
execution through every frozen matmul; ``adapter`` is a PEFT tree whose
``layers`` leaves carry a leading [L] axis and are sliced per layer.

Paged caches keep one tensor per pool leaf, [L, P, blk, K, hd]: ``k`` and
``v`` in the activation dtype or, for an int8 cache, ``k``/``v`` in int8
and their per-head f32 scales ``k_s``/``v_s`` [L, P, blk, K, 1]. The layer
axis is fused into the page axis ([L*P, ...], a view) and layer i
addresses its pages through ``tbl + i*P``, as in the JAX package — the pool
is never sliced or copied; decode and prefill write it IN PLACE.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.config import DENSE, ModelConfig
from repro_torch.models import blocks
from repro_torch.models.blocks import DEFAULT_LIN, LinearFns


class LinCtx(NamedTuple):
    """Linear-hook context. ``top`` serves embed/lm_head; ``for_layer``
    binds a per-layer adapter slice into a LinearFns."""
    top: LinearFns
    for_layer: Callable[[Any], LinearFns]


DEFAULT_CTX = LinCtx(top=DEFAULT_LIN, for_layer=lambda adapter_slice: DEFAULT_LIN)


def _check_dense(cfg: ModelConfig):
    if cfg.arch != DENSE:
        raise ValueError(f"the port serves the dense family; {cfg.name} is "
                         f"{cfg.arch!r}")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _layer_init(gen, cfg: ModelConfig, dtype, device):
    return {
        "ln1": blocks.rmsnorm_init(cfg.d_model, dtype, device),
        "ln2": blocks.rmsnorm_init(cfg.d_model, dtype, device),
        "attn": blocks.attn_init(gen, cfg, dtype, device),
        "mlp": blocks.mlp_init(gen, cfg, dtype, device),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random base parameters from ``generator`` (which must live on
    ``device``), with the JAX package's distributions: linears uniform in
    ±1/sqrt(din), embeddings normal * 0.02, norm scales 1."""
    _check_dense(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg.param_dtype)
    params = {
        "embed": blocks.embed_init(generator, cfg.vocab, cfg.d_model, dtype, dev),
        "final_norm": blocks.rmsnorm_init(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = blocks.dense_init(generator, cfg.d_model, cfg.vocab,
                                              dtype, dev)
    params["layers"] = [_layer_init(generator, cfg, dtype, dev)
                        for _ in range(cfg.n_layers)]
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


def _layer_forward(p, cfg: ModelConfig, x, positions, lin: LinearFns):
    """One layer over a sequence; also returns its K/V [B,S,K,hd]."""
    h = blocks.rmsnorm(p["ln1"], x)
    attn, k, v = blocks.mha_forward(p["attn"], cfg, h, positions, lin)
    x = x + attn
    h = blocks.rmsnorm(p["ln2"], x)
    return x + blocks.mlp_forward(p["mlp"], h, lin), k, v


def _layer_decode(p, cfg: ModelConfig, x, pools, pos, lin: LinearFns, *,
                  tbl, write):
    """One layer's single-token step against (layer-fused) page pools; an
    int8 cache is told by its ``k_s`` leaf, as in the JAX package."""
    h = blocks.rmsnorm(p["ln1"], x)
    if "k_s" in pools:
        attn = blocks.mha_decode_quant_paged(
            p["attn"], cfg, h, pools["k"], pools["k_s"], pools["v"],
            pools["v_s"], tbl, pos, lin, write=write)
    else:
        attn = blocks.mha_decode_paged(p["attn"], cfg, h, pools["k"],
                                       pools["v"], tbl, pos, lin, write=write)
    x = x + attn
    h = blocks.rmsnorm(p["ln2"], x)
    return x + blocks.mlp_forward(p["mlp"], h, lin)


def embed_tokens(cfg, params, tokens, lin: LinearFns):
    return params["embed"][tokens.long()].to(_dtype(cfg.dtype))


def lm_head(cfg, params, x, lin: LinearFns):
    w = params.get("lm_head")
    if w is None:
        w = params["embed"].T
    return lin.dense(x, w, None, "lm_head")


# ---------------------------------------------------------------------------
# Forward (train / scoring)
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params, batch, ctx: LinCtx = DEFAULT_CTX,
            adapter=None, *, remat: bool = True):
    """Training / scoring forward over whole sequences. batch: tokens [B,S].
    Returns logits [B,S,V] (the dense family has no auxiliary loss).
    Attention is the plain ``blocks.mha_forward``, as in the JAX package,
    whose training forward reaches no kernel. ``remat`` recomputes each
    layer body in the backward (``torch.utils.checkpoint``, the JAX
    package's ``jax.checkpoint`` of the scan body), so only the layer
    inputs are held between the passes."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens, ctx.top)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    for i, p in enumerate(params["layers"]):
        lin = ctx.for_layer(_adapter_layer(adapter, i))

        def body(x, p=p, lin=lin):
            return _layer_forward(p, cfg, x, positions, lin)[0]

        if remat:
            x = torch.utils.checkpoint.checkpoint(body, x, use_reentrant=False)
        else:
            x = body(x)
    x = blocks.rmsnorm(params["final_norm"], x)
    return lm_head(cfg, params, x, ctx.top)


# ---------------------------------------------------------------------------
# Paged cache, decode and prefill
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
    """Zeroed pool leaves of one paged cache. shape = (..., K, hd): {"k",
    "v"} in ``dtype``, or with ``quant`` int8 {"k", "v"} and f32 per-head
    scales {"k_s", "v_s"} of shape (..., K, 1)."""
    if not quant:
        return {n: torch.zeros(shape, dtype=dtype, device=device)
                for n in ("k", "v")}
    scales = shape[:-1] + (1,)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(scales, dtype=torch.float32, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_s": torch.zeros(scales, dtype=torch.float32, device=device)}


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               *, page_block: int, pool_pages: int = 0, quant: bool = False,
               device="cuda"):
    """Paged cache: pools {"k","v"} [L, P, page_block, K, hd] (with
    ``quant``, int8 plus f32 scales {"k_s","v_s"} [L, P, page_block, K,
    1]), ``pos`` [B] and ``block_tbl`` [B, n_blocks]. pool_pages=0 fully
    provisions."""
    _check_dense(cfg)
    if not page_block:
        raise ValueError("the port serves the paged KV layout only "
                         "(page_block > 0)")
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg.dtype)
    _, P, tbl = default_block_table(batch_size, max_seq, page_block,
                                    pool_pages, dev)
    shape = (cfg.n_layers, P, page_block, cfg.n_kv_heads, cfg.hd)
    return {"layers": pool_leaves(shape, dtype, quant, dev),
            "pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
            "block_tbl": tbl}


def _fused(layers):
    """[L, P, ...] pool leaves as [L*P, ...] views (no copy) + (L, P, blk)."""
    L, P, blk = layers["k"].shape[:3]
    return ({n: t.view((L * P,) + t.shape[2:]) for n, t in layers.items()},
            L, P, blk)


def decode_step(cfg: ModelConfig, params, cache, token, ctx: LinCtx = DEFAULT_CTX,
                adapter=None, *, active=None):
    """One decode step. token [B] int. Returns (logits [B,V], new cache).

    The pools are written IN PLACE (the new cache holds the same pool
    tensors); ``active`` [B] bool drops the pool writes of inactive rows
    (their pos/logits are discarded by the caller's merge)."""
    pos = cache["pos"]
    tbl = cache["block_tbl"]
    x = embed_tokens(cfg, params, token[:, None], ctx.top)
    fused, _, Pl, blk = _fused(cache["layers"])
    src, page, off, any_kept = blocks.token_write_index(tbl, pos, Pl, blk,
                                                        active)
    for i, p in enumerate(params["layers"]):
        ad = _adapter_layer(adapter, i)
        x = _layer_decode(p, cfg, x, fused, pos, ctx.for_layer(ad),
                          tbl=tbl + i * Pl,
                          write=(src, page + i * Pl, off, any_kept))
    x = blocks.rmsnorm(params["final_norm"], x)
    logits = lm_head(cfg, params, x, ctx.top)[:, 0]
    return logits, {"layers": cache["layers"], "pos": pos + 1, "block_tbl": tbl}


def prefill(cfg: ModelConfig, params, batch, cache, ctx: LinCtx = DEFAULT_CTX,
            adapter=None, *, lengths=None):
    """Prefill over right-padded prompts, filling the paged cache IN PLACE.

    ``lengths`` [B] (optional) are the true prompt lengths: logits are taken
    at each row's last real position, decode resumes at ``pos = lengths``,
    and only positions < lengths are written (a row of length 0 writes
    nothing). K/V are projected once per layer and used for both the
    attention and the cache write; an int8 cache stores them quantized
    per head, while the attention uses them as computed, so prefill logits
    do not depend on the cache's format."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens, ctx.top)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    tbl = cache["block_tbl"]
    fused, _, Pl, blk = _fused(cache["layers"])
    index = blocks.prefill_write_index(tbl, S, Pl, blk, lengths)
    for i, p in enumerate(params["layers"]):
        ad = _adapter_layer(adapter, i)
        x, k, v = _layer_forward(p, cfg, x, positions, ctx.for_layer(ad))
        k, v = k.flatten(0, 1), v.flatten(0, 1)
        if "k_s" in fused:
            parts = zip(("k", "k_s", "v", "v_s"),
                        blocks.quantize_head(k) + blocks.quantize_head(v))
        else:
            parts = (("k", k), ("v", v))
        for name, val in parts:
            blocks.paged_write(fused[name], index, val, page_offset=i * Pl)
    x = blocks.rmsnorm(params["final_norm"], x)
    if lengths is None:
        logits = lm_head(cfg, params, x[:, -1:], ctx.top)[:, 0]
        pos = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    else:
        last = (lengths.long() - 1).clamp_min(0)
        xg = x[torch.arange(B, device=x.device), last][:, None]
        logits = lm_head(cfg, params, xg, ctx.top)[:, 0]
        pos = lengths.to(torch.int32)
    return logits, {"layers": cache["layers"], "pos": pos, "block_tbl": tbl}
