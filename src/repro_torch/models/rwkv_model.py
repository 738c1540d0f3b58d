"""RWKV6 model assembly — ``repro.models.rwkv_model``: attention-free, an
O(1) decode state per slot.

Params: ``{"embed", "final_norm", "lm_head", "layers": [L dicts of
{"time_mix", "channel_mix", "ln1", "ln2"}]}`` (JAX stacks the layers on a
leading [L] axis and scans; here a Python loop over the list).

Caches: ``{"layers": {"wkv" [L, B, H, hd, hd] fp32, "tm_x", "cm_x"
[L, B, 1, d] in the activation dtype}, "pos" [B]}``: each layer's wkv
state and its two token-shift tails (the NORMED inputs of the time and
channel mixes at the last position). JAX keeps the three leaves flat
beside ``pos``; the port puts them under ``layers``, so that a bank lays
them out layer-major [L, C, B, ...] as it does dense K/V rows and every
bank step reads one layer container (``convert`` maps the two). Every
write is IN PLACE: prefill's gated by ``write_rows``, decode's by
``active``.

The state runs through every position of a prefill, so prompts must come
at their true length (the engine prefills one request per call,
unpadded), and JAX's chunk contract holds (``rwkv.wkv6_scan``: a length
over 128 must be a multiple of 128). No layer reads a prefix adapter, as
in JAX.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.config import RWKV, ModelConfig
from repro_torch.models import blocks, rwkv as rwkv_lib
from repro_torch.models.hybrid import _read_rows, _write_rows
from repro_torch.models.transformer import (DEFAULT_CTX, LinCtx, _dtype,
                                            _adapter_layer, embed_tokens,
                                            lm_head)

STATE = ("wkv", "tm_x", "cm_x")


def _check(cfg: ModelConfig):
    if cfg.arch != RWKV:
        raise ValueError(f"{cfg.name} is of the {cfg.arch!r} family, not "
                         "rwkv")


def _layer_init(gen, cfg: ModelConfig, dtype, device):
    p = rwkv_lib.rwkv_init(gen, cfg, dtype, device)
    p["ln1"] = blocks.rmsnorm_init(cfg.d_model, dtype, device)
    p["ln2"] = blocks.rmsnorm_init(cfg.d_model, dtype, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random base parameters from ``generator`` (on ``device``), with the
    JAX package's distributions."""
    _check(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg.param_dtype)
    return {
        "embed": blocks.embed_init(generator, cfg.vocab, cfg.d_model, dtype,
                                   dev),
        "final_norm": blocks.rmsnorm_init(cfg.d_model, dtype, dev),
        "lm_head": blocks.dense_init(generator, cfg.d_model, cfg.vocab,
                                     dtype, dev),
        "layers": [_layer_init(generator, cfg, dtype, dev)
                   for _ in range(cfg.n_layers)],
    }


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int = 0,
               dtype=None, *, page_block: int = 0, pool_pages: int = 0,
               quant=False, window: int = 0, device="cuda"):
    """Zeroed decode state of ``batch_size`` slots. ``max_seq`` is ignored:
    the state is O(1) in the sequence. There is nothing to page, quantize
    or ring (the engine's ``serve_cache_kwargs`` passes none of these, as
    JAX's)."""
    _check(cfg)
    if page_block or quant or window:
        raise ValueError("the RWKV state has no paged (page_block=), int8 "
                         "(quant=) or ring (window=) layout")
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg.dtype)
    L, d, H = cfg.n_layers, cfg.d_model, cfg.d_model // cfg.hd
    return {"layers": {
        "wkv": torch.zeros((L, batch_size, H, cfg.hd, cfg.hd),
                           dtype=torch.float32, device=dev),
        "tm_x": torch.zeros((L, batch_size, 1, d), dtype=dtype, device=dev),
        "cm_x": torch.zeros((L, batch_size, 1, d), dtype=dtype, device=dev)},
        "pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev)}


def _layer(p, cfg: ModelConfig, x, lin, state):
    """One RWKV layer. ``state`` (wkv, tm_x, cm_x) or None (zeros: a
    training sequence). Returns (x, (wkv', tm tail, cm tail))."""
    wkv, tm_x, cm_x = (None, None, None) if state is None else state
    if wkv is None:
        H = cfg.d_model // cfg.hd
        wkv = torch.zeros((x.shape[0], H, cfg.hd, cfg.hd),
                          dtype=torch.float32, device=x.device)
    h = blocks.rmsnorm(p["ln1"], x)
    y, wkv, tm_tail = rwkv_lib.time_mix(p["time_mix"], cfg, h, lin, wkv, tm_x)
    x = x + y
    h = blocks.rmsnorm(p["ln2"], x)
    y, cm_tail = rwkv_lib.channel_mix(p["channel_mix"], h, lin, cm_x)
    return x + y, (wkv, tm_tail, cm_tail)


def forward(cfg: ModelConfig, params, batch, ctx: LinCtx = DEFAULT_CTX,
            adapter=None, *, remat: bool = True, with_aux: bool = False,
            capacity_factor=None, moe_dispatch: str = "scatter",
            rows: int = 1):
    """Scoring forward over whole sequences, batch tokens [B, S]: logits
    [B, S, V], or with ``with_aux`` (logits, aux) with a zero aux (JAX's
    second output; [rows] when ``rows > 1``). The state starts at zero.
    ``remat`` recomputes each layer in the backward (JAX's
    ``jax.checkpoint`` of the scan body). The MoE knobs are taken and
    unused, so every family's forward has one signature."""
    x = embed_tokens(cfg, params, batch["tokens"], ctx.top)
    for i, p in enumerate(params["layers"]):
        lin = ctx.for_layer(_adapter_layer(adapter, i))

        def body(x, p=p, lin=lin):
            return _layer(p, cfg, x, lin, None)[0]

        if remat:
            x = torch.utils.checkpoint.checkpoint(body, x,
                                                  use_reentrant=False)
        else:
            x = body(x)
    x = blocks.rmsnorm(params["final_norm"], x)
    logits = lm_head(cfg, params, x, ctx.top)
    if not with_aux:
        return logits
    return logits, torch.zeros((rows,) if rows > 1 else (),
                               dtype=torch.float32, device=x.device)


def _run_with_state(cfg, params, x, cache, ctx, adapter, rows, slots=None):
    """Every layer from the cache's state, each layer's new state written
    back IN PLACE on ``rows`` (None: every row) as soon as it is made;
    ``slots`` [B]: the state leaves are a bank's rows, batch row b row
    ``slots[b]``."""
    leaves = cache["layers"]
    for i, p in enumerate(params["layers"]):
        lin = ctx.for_layer(_adapter_layer(adapter, i))
        old = tuple(_read_rows(leaves[n][i], slots) for n in STATE)
        x, new = _layer(p, cfg, x, lin, old)
        for n, val, o in zip(STATE, new, old):
            _write_rows(leaves[n][i], val, rows, slots, o)
    return blocks.rmsnorm(params["final_norm"], x)


def prefill(cfg: ModelConfig, params, batch, cache, ctx: LinCtx = DEFAULT_CTX,
            adapter=None, *, lengths=None, write_rows=None, starts=None,
            ext_blocks: int = 0, slots=None):
    """Prefill over prompts at their true length, from the state the cache
    holds (the caller zeroes an admitted slot first), writing each layer's
    state IN PLACE on the rows where ``write_rows`` [B] is True (all for
    None); ``slots`` [B] long reads the state leaves as a bank's rows [L,
    C*B, ...], batch row b row ``slots[b]``. ``lengths`` [B] picks each
    row's logits at its last real position and advances ``pos`` by it (by
    S without); the tails are taken at position S - 1, as in JAX, so pads
    would run into the state.
    The shared-prefix suffix prefill (``starts``, ``ext_blocks``) is for
    the pure-KV families, as in JAX."""
    if starts is not None or ext_blocks:
        raise ValueError("the RWKV family prefills whole prompts: no suffix "
                         "prefill (starts=, ext_blocks=)")
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens, ctx.top)
    x = _run_with_state(cfg, params, x, cache, ctx, adapter, write_rows,
                        slots)
    if lengths is None:
        logits = lm_head(cfg, params, x[:, -1:], ctx.top)[:, 0]
        pos = cache["pos"] + S
    else:
        lengths = lengths.to(torch.int32)
        last = (lengths.long() - 1).clamp_min(0)
        xg = x[torch.arange(B, device=x.device), last][:, None]
        logits = lm_head(cfg, params, xg, ctx.top)[:, 0]
        pos = cache["pos"] + lengths
    return logits, dict(cache, pos=pos)


def decode_step(cfg: ModelConfig, params, cache, token, ctx: LinCtx = DEFAULT_CTX,
                adapter=None, *, active=None, ring: bool = False):
    """One decode step, token [B] int: (logits [B, V], new cache). Each
    layer's state is written IN PLACE and ``active`` [B] bool drops the
    writes of inactive rows (their logits are the caller's to discard).
    ``ring`` names a KV cache layout; the RWKV state has none, so it is
    taken and ignored, as the masked step passes it to every family."""
    x = embed_tokens(cfg, params, token[:, None], ctx.top)
    x = _run_with_state(cfg, params, x, cache, ctx, adapter, active)
    logits = lm_head(cfg, params, x, ctx.top)[:, 0]
    return logits, dict(cache, pos=cache["pos"] + 1)
