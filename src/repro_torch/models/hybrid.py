"""Jamba-style hybrid (Mamba + attention 1:7 interleave, MoE every 2nd
layer): the serving path of ``repro.models.hybrid``.

Layer pattern: a period of ``cfg.attn_every`` sublayers (Jamba: 8),
sublayers 0..p-2 Mamba and p-1 attention, the FFN of sublayer j an MoE
where ``j % moe_every == moe_offset`` (Jamba: the odd ones), else a dense
MLP. The ``n_layers / p`` periods are GROUPS: the params hold ``groups``, a
list with one dict of ``sub{j}`` dicts per group (JAX stacks the groups on
a leading [G] axis and scans; here a Python loop over the list).

Adapters have one leaf per GROUP, ``{"groups": {path: [G, ...]}}``, bound
once per group as in JAX's ``_group_forward``: a q/v target reaches the
group's one attention sublayer, a gate/up/down or router target every MLP
or MoE sublayer of the group with the same weights. No sublayer reads
prefix K/V, as in JAX: a prefix adapter leaves the base as it is.

Caches: ``{"groups": {"sub{j}": leaves stacked on [G]}, "pos" [B]}`` (+
``block_tbl`` [B, n_blocks] when paged). An attention sublayer keeps
``k``/``v``, dense [G, B, T, K, hd] or paged pools [G, P, blk, K, hd]
(one [G*P, ...] view, group g addressed through ``tbl + g*P``, as
``transformer`` fuses its layers); a Mamba sublayer keeps per-slot ``h``
[G, B, ED, N] and ``conv`` [G, B, K-1, ED], fp32 on either layout. Every
write is IN PLACE: decode's per-slot writes are gated by ``active``,
prefill's by ``write_rows``, and the paged pools by the write index.

The Mamba state runs through every position of a prefill, so prompts must
come at their true length (the engine prefills one request per call,
unpadded), and JAX's chunk contract holds (``mamba.selective_scan``).
Attention sublayers reuse ``blocks``: the paged decode kernel on pages,
the dense decode kernel on the dense layout (the port's stated departure
from JAX's einsum there); MoE sublayers ``models.moe``, drop-free on the
serving paths. The prefill takes each attention sublayer's K/V from its
``mha_forward`` (JAX projects them a second time; the values are the
same).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.config import HYBRID, ModelConfig
from repro_torch.models import blocks, mamba as mamba_lib, moe as moe_lib
from repro_torch.models.transformer import (DEFAULT_CTX, LinCtx, _dtype,
                                            _dense_prefill_write, _ffn,
                                            _tree_index, default_block_table,
                                            embed_tokens, lm_head)


def _check(cfg: ModelConfig):
    if cfg.arch != HYBRID:
        raise ValueError(f"{cfg.name} is of the {cfg.arch!r} family, not "
                         "hybrid")
    if not cfg.attn_every or cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers is no whole "
                         f"number of {cfg.attn_every}-layer periods")


def sub_is_attn(cfg: ModelConfig, j: int) -> bool:
    """Whether sublayer ``j`` of a period is attention (else Mamba)."""
    return j == cfg.attn_every - 1


def sub_is_moe(cfg: ModelConfig, j: int) -> bool:
    """Whether sublayer ``j`` of a period has an MoE FFN."""
    return cfg.n_experts > 0 and j % cfg.moe_every == cfg.moe_offset


def n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _group_init(gen, cfg: ModelConfig, dtype, device):
    group = {}
    for j in range(cfg.attn_every):
        p = {"ln1": blocks.rmsnorm_init(cfg.d_model, dtype, device),
             "ln2": blocks.rmsnorm_init(cfg.d_model, dtype, device)}
        if sub_is_attn(cfg, j):
            p["attn"] = blocks.attn_init(gen, cfg, dtype, device)
        else:
            p["mamba"] = mamba_lib.mamba_init(gen, cfg, dtype, device)
        if sub_is_moe(cfg, j):
            p["moe"] = moe_lib.moe_init(gen, cfg, dtype, device)
        else:
            p["mlp"] = blocks.mlp_init(gen, cfg, dtype, device)
        group[f"sub{j}"] = p
    return group


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random base parameters from ``generator`` (on ``device``), with the
    JAX package's distributions (``lm_head`` always present, as JAX's
    hybrid builds it)."""
    _check(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg.param_dtype)
    return {
        "embed": blocks.embed_init(generator, cfg.vocab, cfg.d_model, dtype,
                                   dev),
        "final_norm": blocks.rmsnorm_init(cfg.d_model, dtype, dev),
        "lm_head": blocks.dense_init(generator, cfg.d_model, cfg.vocab,
                                     dtype, dev),
        "groups": [_group_init(generator, cfg, dtype, dev)
                   for _ in range(n_groups(cfg))],
    }


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               *, page_block: int = 0, pool_pages: int = 0, quant=False,
               window: int = 0, device="cuda"):
    """Zeroed cache of ``batch_size`` slots: ``page_block > 0`` pages the
    attention sublayers' K/V (pools [G, P, page_block, K, hd] and one
    ``block_tbl``; ``pool_pages=0`` fully provisions); otherwise dense
    [G, B, max_seq, K, hd]. Mamba state is per slot on both. The int8 and
    ring layouts are for the pure-KV families, as in JAX."""
    _check(cfg)
    if quant or window:
        raise ValueError("the hybrid cache has no int8 (quant=) or ring "
                         "(window=) layout")
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg.dtype)
    G, ed = n_groups(cfg), cfg.mamba_expand * cfg.d_model
    kv_lead, tbl = (batch_size, max_seq), None
    if page_block:
        _, P, tbl = default_block_table(batch_size, max_seq, page_block,
                                        pool_pages, dev)
        kv_lead = (P, page_block)
    kv_shape = (G,) + kv_lead + (cfg.n_kv_heads, cfg.hd)
    f32 = torch.float32
    groups = {}
    for j in range(cfg.attn_every):
        if sub_is_attn(cfg, j):
            groups[f"sub{j}"] = {
                n: torch.zeros(kv_shape, dtype=dtype, device=dev)
                for n in ("k", "v")}
        else:
            groups[f"sub{j}"] = {
                "h": torch.zeros((G, batch_size, ed, cfg.d_state), dtype=f32,
                                 device=dev),
                "conv": torch.zeros((G, batch_size, cfg.d_conv - 1, ed),
                                    dtype=f32, device=dev)}
    cache = {"groups": groups,
             "pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev)}
    if tbl is not None:
        cache["block_tbl"] = tbl
    return cache


# ---------------------------------------------------------------------------
# Bodies
# ---------------------------------------------------------------------------

def _adapter_group(adapter, g):
    """Group g's slice of an adapter tree (leaves [G, ...] -> [...])."""
    if adapter is None:
        return None
    return _tree_index(adapter["groups"], g)


def _write_rows(leaf, val, rows):
    """leaf [B, ...] <- val IN PLACE, only the rows where ``rows`` [B] is
    True (all of them for None)."""
    val = val.to(leaf.dtype)
    if rows is not None:
        val = torch.where(rows.reshape((-1,) + (1,) * (val.ndim - 1)), val,
                          leaf)
    leaf.copy_(val)


def _group_seq(gp, cfg, x, positions, lin, *, states=None, on_kv=None,
               with_aux=False, **moe_kw):
    """One period over a sequence: (x, aux, {j: new Mamba state}).
    ``states[j]`` is Mamba sublayer j's carried state (None: zeros);
    ``on_kv(j, k, v)`` takes attention sublayer j's post-RoPE K/V. aux is
    the MoE sublayers' summed load-balance loss from zero (None without
    ``with_aux``)."""
    aux = None
    if with_aux:
        rows = moe_kw.get("rows", 1)
        aux = torch.zeros((rows,) if rows > 1 else (), dtype=torch.float32,
                          device=x.device)
    new = {}
    for j in range(cfg.attn_every):
        p = gp[f"sub{j}"]
        h = blocks.rmsnorm(p["ln1"], x)
        if "attn" in p:
            y, k, v = blocks.mha_forward(p["attn"], cfg, h, positions, lin)
            if on_kv is not None:
                on_kv(j, k, v)
        else:
            y, new[j] = mamba_lib.mamba_forward(
                p["mamba"], cfg, h, lin, None if states is None else states[j])
        x = x + y
        y, a = _ffn(p, cfg, blocks.rmsnorm(p["ln2"], x), lin, with_aux,
                    **moe_kw)
        if a is not None:
            aux = aux + a
        x = x + y
    return x, aux, new


def forward(cfg: ModelConfig, params, batch, ctx: LinCtx = DEFAULT_CTX,
            adapter=None, *, remat: bool = True, with_aux: bool = False,
            capacity_factor=None, moe_dispatch: str = "scatter",
            rows: int = 1):
    """Scoring forward over whole sequences, batch tokens [B, S]: logits
    [B, S, V], or with ``with_aux`` (logits, aux), the MoE sublayers' summed
    load-balance loss. Mamba state starts at zero. ``remat`` recomputes
    each group in the backward (JAX's ``jax.checkpoint`` of the scan
    body); the MoE knobs go to every MoE sublayer (``moe.moe_forward``)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens, ctx.top)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    aux = torch.zeros((rows,) if rows > 1 else (), dtype=torch.float32,
                      device=x.device) if with_aux else None
    moe_kw = dict(capacity_factor=capacity_factor, moe_dispatch=moe_dispatch,
                  rows=rows)
    for g, gp in enumerate(params["groups"]):
        lin = ctx.for_layer(_adapter_group(adapter, g))

        def body(x, gp=gp, lin=lin):
            x, a, _ = _group_seq(gp, cfg, x, positions, lin,
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


def _pool_shape(groups):
    """(P, page_block) of a paged cache's attention pools [G, P, blk, ...]."""
    for sub in groups.values():
        if "k" in sub:
            return sub["k"].shape[1:3]
    raise ValueError("a hybrid cache without an attention sublayer")


def _fused(leaf):
    """[G, P, ...] pool as its [G*P, ...] view (no copy)."""
    return leaf.view((leaf.shape[0] * leaf.shape[1],) + leaf.shape[2:])


def prefill(cfg: ModelConfig, params, batch, cache, ctx: LinCtx = DEFAULT_CTX,
            adapter=None, *, lengths=None, write_rows=None, starts=None,
            ext_blocks: int = 0):
    """Prefill over prompts at their true length, filling the cache IN
    PLACE. Each Mamba sublayer starts from the state the cache holds (the
    caller zeroes an admitted slot first) and its final state is written
    back; ``write_rows`` [B] bool keeps the bits of the rows where it is
    False, in the per-slot leaves (Mamba state; dense K/V rows, of which
    lanes [0, S) are written). Paged pools take positions < ``lengths``
    only (a row of length 0 writes nothing). ``lengths`` [B] also picks
    each row's logits at its last real position and starts ``pos`` there.
    The shared-prefix suffix prefill (``starts``, ``ext_blocks``) is for
    the pure-KV families, as in JAX."""
    if starts is not None or ext_blocks:
        raise ValueError("the hybrid family prefills whole prompts: no "
                         "suffix prefill (starts=, ext_blocks=)")
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens, ctx.top)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    if lengths is not None:
        lengths = lengths.to(torch.int32)
    grp = cache["groups"]
    tbl = cache.get("block_tbl")
    if tbl is not None:
        P, blk = _pool_shape(grp)
        index = blocks.prefill_write_index(tbl, S, P, blk, lengths)
    for g, gp in enumerate(params["groups"]):
        def on_kv(j, k, v, g=g):
            for name, val in (("k", k), ("v", v)):
                leaf = grp[f"sub{j}"][name]
                if tbl is None:
                    _dense_prefill_write(leaf[g], val, write_rows)
                else:
                    blocks.paged_write(_fused(leaf), index, val.flatten(0, 1),
                                       page_offset=g * P)

        states = {j: {n: t[g] for n, t in grp[f"sub{j}"].items()}
                  for j in range(cfg.attn_every) if "h" in grp[f"sub{j}"]}
        x, _, new = _group_seq(gp, cfg, x, positions,
                               ctx.for_layer(_adapter_group(adapter, g)),
                               states=states, on_kv=on_kv)
        for j, st in new.items():
            for n, val in st.items():
                _write_rows(grp[f"sub{j}"][n][g], val, write_rows)
    x = blocks.rmsnorm(params["final_norm"], x)
    if lengths is None:
        logits = lm_head(cfg, params, x[:, -1:], ctx.top)[:, 0]
        pos = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    else:
        last = (lengths.long() - 1).clamp_min(0)
        xg = x[torch.arange(B, device=x.device), last][:, None]
        logits = lm_head(cfg, params, xg, ctx.top)[:, 0]
        pos = lengths
    return logits, dict(cache, pos=pos)


def decode_step(cfg: ModelConfig, params, cache, token, ctx: LinCtx = DEFAULT_CTX,
                adapter=None, *, active=None, ring: bool = False):
    """One decode step. token [B] int. Returns (logits [B, V], new cache).

    Every write is IN PLACE and ``active`` [B] bool drops those of inactive
    rows: their K/V lane or page entry and their Mamba state keep their
    bits (their logits are the caller's to discard). K/V go through the
    paged or the dense decode kernel (``blocks``). ``ring`` is for the
    pure-KV families' ring cache."""
    if ring:
        raise ValueError("the hybrid cache has no ring layout")
    pos = cache["pos"]
    tbl = cache.get("block_tbl")
    grp = cache["groups"]
    x = embed_tokens(cfg, params, token[:, None], ctx.top)
    if tbl is None:
        T = next(sub["k"] for sub in grp.values() if "k" in sub).shape[2]
        write = blocks.dense_write_index(pos, T, False, active)
    else:
        P, blk = _pool_shape(grp)
        src, page, off, any_kept = blocks.token_write_index(tbl, pos, P, blk,
                                                            active)
    for g, gp in enumerate(params["groups"]):
        lin = ctx.for_layer(_adapter_group(adapter, g))
        for j in range(cfg.attn_every):
            p, leaves = gp[f"sub{j}"], grp[f"sub{j}"]
            h = blocks.rmsnorm(p["ln1"], x)
            if "attn" in p:
                if tbl is None:
                    y = blocks.mha_decode(p["attn"], cfg, h, leaves["k"][g],
                                          leaves["v"][g], pos, lin,
                                          write=write)
                else:
                    y = blocks.mha_decode_paged(
                        p["attn"], cfg, h, _fused(leaves["k"]),
                        _fused(leaves["v"]), tbl + g * P, pos, lin,
                        write=(src, page + g * P, off, any_kept))
            else:
                y, st = mamba_lib.mamba_forward(
                    p["mamba"], cfg, h, lin,
                    {n: t[g] for n, t in leaves.items()})
                for n, val in st.items():
                    _write_rows(leaves[n][g], val, active)
            x = x + y
            x = x + _ffn(p, cfg, blocks.rmsnorm(p["ln2"], x), lin, False)[0]
    x = blocks.rmsnorm(params["final_norm"], x)
    logits = lm_head(cfg, params, x, ctx.top)[:, 0]
    return logits, dict(cache, pos=pos + 1)
