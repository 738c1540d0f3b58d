"""Whisper-style encoder-decoder backbone — ``repro.models.encdec``.

The mel-spectrogram and conv frontend is the one allowed stub: a batch
carries precomputed frame embeddings ``frames`` [B, Te, d]
(``data.pipeline.frontend_stub``). The backbone is a bidirectional
encoder over the frames and a causal decoder with cross-attention,
learned positional embeddings (no RoPE), GELU MLPs with bias and MHA.

Params: ``{"embed", "enc_pos" [Te, d], "dec_pos" [MAX_DEC_POS, d],
"enc_norm", "final_norm", "lm_head", "enc_layers", "dec_layers"}``, the
two stacks lists of one dict per layer (JAX stacks each on a leading
axis and scans). An adapter tree has the same two containers,
``{"enc_layers", "dec_layers"}``, leaves [L_enc, ...] and [L, ...]. The
adapter's paths are the self-attentions' ``q k v o`` of both stacks;
cross-attention's are ``xattn_q`` and so on and the MLP's ``fc1`` /
``fc2``, which no adapter names: LoRA on ``q`` / ``v`` reaches the
self-attentions only, an IA3 ``down`` leaf is carried and never read,
and no layer reads a prefix adapter, as in JAX.

Caches: ``{"layers": {"k", "v", "cross_k", "cross_v"}, "pos" [B],
("block_tbl" [B, n_blocks])}``. ``k`` / ``v`` are the decoder's
self-attention K/V, paged ([L, P, blk, K, hd] pools read through the
table by the paged decode kernel) or dense ([L, B, T, K, hd] rows read by
the dense decode kernel), as ``models.transformer`` keeps them;
``cross_k`` / ``cross_v`` [L, B, Te, K, hd] hold each slot's encoder K/V,
dense per slot in both layouts (JAX names the four ``self_k``,
``self_v``, ``cross_k``, ``cross_v`` beside ``pos``; ``convert`` maps
them). Every write is IN PLACE: prefill's gated by ``write_rows`` (the
dense rows and the cross caches) and by ``lengths`` (the pages), decode's
by ``active``.

Under autograd every encoder layer runs under ``torch.utils.checkpoint``
(JAX checkpoints each): 1,500 frames per row make the encoder's
activations the step's largest, so only each layer's input is held
between the passes.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.common.tree import tree_leaves
from repro_torch.config import ENCDEC, ModelConfig
from repro_torch.models import blocks
from repro_torch.models.transformer import (DEFAULT_CTX, LinCtx, _dtype,
                                            _dense_prefill_write, _fused,
                                            _tree_index,
                                            default_block_table,
                                            embed_tokens, lm_head)

MAX_DEC_POS = 32768   # learned decoder positions, JAX's table size
CROSS = ("cross_k", "cross_v")


def _check(cfg: ModelConfig):
    if cfg.arch != ENCDEC:
        raise ValueError(f"{cfg.name} is of the {cfg.arch!r} family, not "
                         "encdec")


def _enc_layer_init(gen, cfg, dtype, device):
    return {"ln1": blocks.rmsnorm_init(cfg.d_model, dtype, device),
            "ln2": blocks.rmsnorm_init(cfg.d_model, dtype, device),
            "attn": blocks.attn_init(gen, cfg, dtype, device),
            "mlp": blocks.mlp_init(gen, cfg, dtype, device, gelu=True,
                                   bias=True)}


def _dec_layer_init(gen, cfg, dtype, device):
    return {"ln1": blocks.rmsnorm_init(cfg.d_model, dtype, device),
            "ln_x": blocks.rmsnorm_init(cfg.d_model, dtype, device),
            "ln2": blocks.rmsnorm_init(cfg.d_model, dtype, device),
            "attn": blocks.attn_init(gen, cfg, dtype, device),
            "xattn": blocks.attn_init(gen, cfg, dtype, device),
            "mlp": blocks.mlp_init(gen, cfg, dtype, device, gelu=True,
                                   bias=True)}


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random base parameters from ``generator`` (on ``device``), with the
    JAX package's distributions."""
    _check(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg.param_dtype)
    d = cfg.d_model
    return {
        "embed": blocks.embed_init(generator, cfg.vocab, d, dtype, dev),
        "enc_pos": blocks.embed_init(generator, cfg.n_frontend_tokens, d,
                                     dtype, dev),
        "dec_pos": blocks.embed_init(generator, MAX_DEC_POS, d, dtype, dev),
        "enc_norm": blocks.rmsnorm_init(d, dtype, dev),
        "final_norm": blocks.rmsnorm_init(d, dtype, dev),
        "lm_head": blocks.dense_init(generator, d, cfg.vocab, dtype, dev),
        "enc_layers": [_enc_layer_init(generator, cfg, dtype, dev)
                       for _ in range(cfg.n_enc_layers)],
        "dec_layers": [_dec_layer_init(generator, cfg, dtype, dev)
                       for _ in range(cfg.n_layers)],
    }


def _layer_adapter(adapter, key, i):
    """Layer i's slice of an adapter tree's ``key`` container."""
    if adapter is None or key not in adapter:
        return None
    return _tree_index(adapter[key], i)


def _recording(x, ad) -> bool:
    """Whether autograd records this layer: grad on, and its input or an
    adapter leaf it reads requiring grad (no layer reads a prefix leaf).
    Only then is the layer checkpointed: a checkpoint holds its inputs
    whether or not they require grad."""
    if not torch.is_grad_enabled():
        return False
    read = {} if ad is None else {k: v for k, v in ad.items()
                                  if not k.startswith("prefix_")}
    return x.requires_grad or any(t.requires_grad for t in tree_leaves(read))


def _enc_layer(p, cfg, x, positions, lin):
    h = blocks.rmsnorm(p["ln1"], x)
    x = x + blocks.mha_forward(p["attn"], cfg, h, positions, lin,
                               causal=False)[0]
    h = blocks.rmsnorm(p["ln2"], x)
    return x + blocks.mlp_forward(p["mlp"], h, lin)


def encode(cfg: ModelConfig, params, frames, ctx: LinCtx = DEFAULT_CTX,
           adapter=None):
    """frames [B, Te, d] (the frontend stub's output) -> encoder states
    [B, Te, d], every layer checkpointed while autograd records it."""
    B, T, _ = frames.shape
    x = frames.to(_dtype(cfg.dtype))
    x = x + params["enc_pos"][None, :T].to(x.dtype)
    positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
    for i, p in enumerate(params["enc_layers"]):
        ad = _layer_adapter(adapter, "enc_layers", i)
        lin = ctx.for_layer(ad)

        def body(x, p=p, lin=lin):
            return _enc_layer(p, cfg, x, positions, lin)

        if _recording(x, ad):
            x = torch.utils.checkpoint.checkpoint(body, x,
                                                  use_reentrant=False)
        else:
            x = body(x)
    return blocks.rmsnorm(params["enc_norm"], x)


def _dec_layer(p, cfg, x, positions, enc, lin):
    """One decoder layer over a sequence: (x, k, v, xk, xv) with its own
    self-attention K/V [B, S, K, hd] and its cross K/V [B, Te, K, hd]
    projected from ``enc`` (what prefill caches)."""
    h = blocks.rmsnorm(p["ln1"], x)
    y, k, v = blocks.mha_forward(p["attn"], cfg, h, positions, lin)
    x = x + y
    h = blocks.rmsnorm(p["ln_x"], x)
    y, xk, xv = blocks.mha_forward(p["xattn"], cfg, h, positions, lin,
                                   kv_x=enc, path_prefix="xattn_")
    x = x + y
    h = blocks.rmsnorm(p["ln2"], x)
    return x + blocks.mlp_forward(p["mlp"], h, lin), k, v, xk, xv


def _embed_dec(cfg, params, tokens, ctx):
    """Decoder inputs: token embeddings plus learned positions [0, S)."""
    S = tokens.shape[1]
    x = embed_tokens(cfg, params, tokens, ctx.top)
    return x + params["dec_pos"][None, :S].to(x.dtype)


def forward(cfg: ModelConfig, params, batch, ctx: LinCtx = DEFAULT_CTX,
            adapter=None, *, remat: bool = True, with_aux: bool = False,
            capacity_factor=None, moe_dispatch: str = "scatter",
            rows: int = 1):
    """Training / scoring forward: the encoder over ``batch["frames"]``
    [B, Te, d] and the teacher-forced decoder over ``batch["tokens"]`` [B,
    S]. Returns logits [B, S, V], or with ``with_aux`` (logits, aux) with
    a zero aux (JAX's second output; [rows] when ``rows > 1``). ``remat``
    recomputes each decoder layer in the backward (the encoder's are
    recomputed whenever autograd records them), where autograd records
    it. The MoE knobs are taken and unused, so every family's forward has
    one signature."""
    enc = encode(cfg, params, batch["frames"], ctx, adapter)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed_dec(cfg, params, tokens, ctx)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    for i, p in enumerate(params["dec_layers"]):
        ad = _layer_adapter(adapter, "dec_layers", i)
        lin = ctx.for_layer(ad)

        def body(x, enc, p=p, lin=lin):
            return _dec_layer(p, cfg, x, positions, enc, lin)[0]

        if remat and (enc.requires_grad or _recording(x, ad)):
            x = torch.utils.checkpoint.checkpoint(body, x, enc,
                                                  use_reentrant=False)
        else:
            x = body(x, enc)
    x = blocks.rmsnorm(params["final_norm"], x)
    logits = lm_head(cfg, params, x, ctx.top)
    if not with_aux:
        return logits
    return logits, torch.zeros((rows,) if rows > 1 else (),
                               dtype=torch.float32, device=x.device)


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               *, page_block: int = 0, pool_pages: int = 0, quant=False,
               window: int = 0, device="cuda"):
    """Zeroed decode state of ``batch_size`` slots: the decoder's
    self-attention K/V paged (``page_block > 0``: pools [L, P, page_block,
    K, hd] and ``block_tbl``; ``pool_pages`` 0 fully provisions) or dense
    ([L, B, max_seq, K, hd]), and the cross caches [L, B, Te, K, hd],
    dense per slot in both. There is no int8 or ring layout (the engine's
    ``serve_cache_kwargs`` drops ``kv_quant``, as JAX's)."""
    _check(cfg)
    if quant or window:
        raise ValueError("the encoder-decoder cache has no int8 (quant=) or "
                         "ring (window=) layout")
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg.dtype)
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    cross = (L, batch_size, cfg.n_frontend_tokens, K, hd)
    layers = {n: torch.zeros(cross, dtype=dtype, device=dev) for n in CROSS}
    cache = {"pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev)}
    if page_block:
        _, P, tbl = default_block_table(batch_size, max_seq, page_block,
                                        pool_pages, dev)
        lead = (L, P, page_block)
        cache["block_tbl"] = tbl
    else:
        lead = (L, batch_size, max_seq)
    for n in ("k", "v"):
        layers[n] = torch.zeros(lead + (K, hd), dtype=dtype, device=dev)
    cache["layers"] = {n: layers[n] for n in ("k", "v") + CROSS}
    return cache


def _self_pools(layers):
    """The self-attention pools [L, P, ...] as [L*P, ...] views (no copy)
    and (P, blk): layer i addresses its pages through ``tbl + i*P`` (the
    cross caches are per slot, not pools)."""
    pools, _, P, blk = _fused({n: layers[n] for n in ("k", "v")})
    return pools, P, blk


def prefill(cfg: ModelConfig, params, batch, cache, ctx: LinCtx = DEFAULT_CTX,
            adapter=None, *, lengths=None, write_rows=None, starts=None,
            ext_blocks: int = 0):
    """Encode ``batch["frames"]``, fill the cross caches, then prefill the
    decoder prompts ``batch["tokens"]`` [B, S], IN PLACE.

    ``lengths`` [B] (optional) takes each row's logits at its last real
    position and starts ``pos`` there (right-padded decoder prompts are
    exact: the self-attention is causal and decode writes a pad lane
    before it reads it). Paged pools take positions < lengths only; dense
    rows take lanes [0, S); ``write_rows`` [B] bool keeps the dense rows'
    and the cross caches' bits where it is False. Each layer projects its
    self and cross K/V once, for its attention and its cache (JAX projects
    them a second time to capture them: the same values). The suffix
    prefill over shared-prefix pages (``starts``, ``ext_blocks``) is the
    pure-KV families', as in JAX."""
    if starts is not None or ext_blocks:
        raise ValueError("the encoder-decoder family prefills whole "
                         "prompts: no suffix prefill (starts=, ext_blocks=)")
    tokens = batch["tokens"]
    B, S = tokens.shape
    enc = encode(cfg, params, batch["frames"], ctx, adapter)
    x = _embed_dec(cfg, params, tokens, ctx)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    leaves = cache["layers"]
    tbl = cache.get("block_tbl")
    if lengths is not None:
        lengths = lengths.to(torch.int32)
    if tbl is not None:
        pools, Pl, blk = _self_pools(leaves)
        index = blocks.prefill_write_index(tbl, S, Pl, blk, lengths)
    for i, p in enumerate(params["dec_layers"]):
        lin = ctx.for_layer(_layer_adapter(adapter, "dec_layers", i))
        x, k, v, xk, xv = _dec_layer(p, cfg, x, positions, enc, lin)
        for name, val in (("k", k), ("v", v)):
            if tbl is None:
                _dense_prefill_write(leaves[name][i], val, write_rows)
            else:
                blocks.paged_write(pools[name], index, val.flatten(0, 1),
                                   page_offset=i * Pl)
        for name, val in zip(CROSS, (xk, xv)):
            _dense_prefill_write(leaves[name][i], val, write_rows)
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
    """One decode step, token [B] int: (logits [B, V], new cache). The
    self-attention goes through the paged decode kernel on pages
    (``blocks.mha_decode_paged``) or the dense one on dense rows
    (``blocks.mha_decode``), the new token's K/V written IN PLACE first
    (dropped for rows where ``active`` [B] is False); cross-attention
    reads the row's encoder cache in plain torch (``blocks.cross_decode``,
    a plain einsum in JAX too). The learned position is gathered at
    ``clip(pos, 0, MAX_DEC_POS - 1)``: an idle row at pos -1 reads
    position 0. There is no ring layout (``ring=True`` is refused)."""
    if ring:
        raise ValueError("the encoder-decoder cache has no ring layout")
    pos = cache["pos"]
    tbl = cache.get("block_tbl")
    leaves = cache["layers"]
    x = embed_tokens(cfg, params, token[:, None], ctx.top)
    x = x + params["dec_pos"][pos.long().clamp(0, MAX_DEC_POS - 1)][:, None] \
        .to(x.dtype)
    if tbl is None:
        write = blocks.dense_write_index(pos, leaves["k"].shape[2], False,
                                         active)
    else:
        pools, Pl, blk = _self_pools(leaves)
        src, page, off, any_kept = blocks.token_write_index(tbl, pos, Pl,
                                                            blk, active)
    for i, p in enumerate(params["dec_layers"]):
        lin = ctx.for_layer(_layer_adapter(adapter, "dec_layers", i))
        h = blocks.rmsnorm(p["ln1"], x)
        if tbl is None:
            y = blocks.mha_decode(p["attn"], cfg, h, leaves["k"][i],
                                  leaves["v"][i], pos, lin, write=write)
        else:
            y = blocks.mha_decode_paged(
                p["attn"], cfg, h, pools["k"], pools["v"], tbl + i * Pl, pos,
                lin, write=(src, page + i * Pl, off, any_kept))
        x = x + y
        h = blocks.rmsnorm(p["ln_x"], x)
        x = x + blocks.cross_decode(p["xattn"], cfg, h, leaves["cross_k"][i],
                                    leaves["cross_v"][i], lin)
        h = blocks.rmsnorm(p["ln2"], x)
        x = x + blocks.mlp_forward(p["mlp"], h, lin)
    x = blocks.rmsnorm(params["final_norm"], x)
    logits = lm_head(cfg, params, x, ctx.top)[:, 0]
    return logits, dict(cache, pos=pos + 1)
