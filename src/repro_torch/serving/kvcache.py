"""KV-cache sizing and the analytic placement cost (the ``"kv"`` kind of
``repro.serving.kvcache``, the pure-KV families: dense, MoE and VLM; and
its ``"hybrid"``, ``"rwkv"`` and ``"encdec"`` kinds).

``cache_bytes`` is what the engine's ``PlacementRouter`` charges against
device memory for a request's lifetime: ``quant=True`` prices int8 entries
plus one f32 scale per head per token for K and V each, and
``page_block > 0`` rounds the context up to whole pages (what the paged
allocator pins). ``decode_token_cost`` is the router's per-token latency
model of the on-card placement. The ring-buffer helpers
(``ring_cache_init``, ``ring_write``, and ``ring_valid_mask`` from
``models.blocks``, which decodes over rings with it) are the
sliding-window cache of depth ``window``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.hardware import H100, Chip
from repro_torch.config import ENCDEC, HYBRID, RWKV, ModelConfig, check_family
from repro_torch.models.blocks import dense_write, dense_write_index
from repro_torch.models.blocks import ring_valid_mask  # noqa: F401 (as JAX's)


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Shape/bytes description of one client's decode state."""
    kind: str                    # "kv" | "hybrid" | "rwkv" | "encdec"
    bytes_per_token: int         # marginal device bytes per context token
    fixed_bytes: int             # state independent of the sequence length

    def total_bytes(self, seq_len: int, batch: int) -> int:
        return self.fixed_bytes * batch + self.bytes_per_token * seq_len * batch


def _dt_bytes(cfg: ModelConfig) -> int:
    return getattr(torch, cfg.dtype).itemsize


def make_cache_spec(cfg: ModelConfig, *, quant: bool = False) -> CacheSpec:
    """The decode-state spec: for a pure-KV model, K and V of every one of
    its ``n_layers`` layers per token (an MoE's dense first layers
    included), in the activation dtype or, with ``quant``, int8 entries
    plus a f32 scale per head. For a hybrid, K and V of its attention
    layers (one per ``attn_every``) per token, and a fixed per-slot state
    of every Mamba layer: ``h`` [ED, d_state] and ``conv`` [d_conv - 1,
    ED], both f32 (JAX's formula, its ``quant`` row too). For RWKV, no
    bytes per token and a fixed per-slot state of every layer: the f32
    wkv state [H, hd, hd] and the two token-shift rows [d] in the
    activation dtype (JAX's formula). For the encoder-decoder, the
    decoder's K and V per token and a fixed per-slot cross cache of
    ``n_frontend_tokens`` K/V rows per decoder layer (JAX's formula, its
    ``quant`` row too)."""
    check_family(cfg)
    if quant:
        kv_row = cfg.n_kv_heads * (cfg.hd * 1 + 4) * 2
    else:
        kv_row = cfg.n_kv_heads * cfg.hd * _dt_bytes(cfg) * 2
    if cfg.arch == RWKV:
        H = cfg.d_model // cfg.hd
        fixed = cfg.n_layers * (H * cfg.hd * cfg.hd * 4
                                + 2 * cfg.d_model * _dt_bytes(cfg))
        return CacheSpec("rwkv", 0, fixed)
    if cfg.arch == HYBRID:
        n_attn = cfg.n_layers // cfg.attn_every
        n_mamba = cfg.n_layers - n_attn
        ed = cfg.mamba_expand * cfg.d_model
        fixed = n_mamba * (ed * cfg.d_state * 4 + (cfg.d_conv - 1) * ed * 4)
        return CacheSpec("hybrid", n_attn * kv_row, fixed)
    if cfg.arch == ENCDEC:
        fixed = cfg.n_layers * cfg.n_frontend_tokens * kv_row
        return CacheSpec("encdec", cfg.n_layers * kv_row, fixed)
    return CacheSpec("kv", cfg.n_layers * kv_row, 0)


def fits_hbm(cfg: ModelConfig, seq_len: int, batch: int, *, chip: Chip = H100,
             reserved_fraction: float = 0.35) -> bool:
    """Does this client's cache fit beside its share of the base?
    ``reserved_fraction`` approximates base weights + activations."""
    spec = make_cache_spec(cfg)
    return spec.total_bytes(seq_len, batch) < chip.hbm_bytes * (1 - reserved_fraction)


def decode_token_cost(cfg: ModelConfig, seq_len: int, *,
                      chip: Chip = H100) -> float:
    """Analytic per-token decode seconds of a client whose cache and
    attention sit on the card: its cache streamed once at the card's memory
    rate, infinite when the cache exceeds 65% of device memory. Base-layer
    compute is left out. Priced on the unquantized spec, as in the JAX
    package (whose ``placement="gpu"`` branch this is)."""
    spec = make_cache_spec(cfg)
    total = spec.bytes_per_token * seq_len + spec.fixed_bytes
    if total > chip.hbm_bytes * 0.65:
        return float("inf")
    return total / chip.hbm_bandwidth


def cache_bytes(cfg: ModelConfig, seq_len: int, batch: int = 1, *,
                quant: bool = False, page_block: int = 0) -> int:
    """Device bytes of one client's decode state for ``seq_len`` context;
    ``page_block > 0`` rounds the context up to whole pages."""
    if page_block:
        seq_len = -(-seq_len // page_block) * page_block
    return make_cache_spec(cfg, quant=quant).total_bytes(seq_len, batch)


# ---------------------------------------------------------------------------
# Sliding-window ring-buffer cache
# ---------------------------------------------------------------------------

def ring_cache_init(cfg: ModelConfig, batch: int, window: int, dtype=None,
                    device="cuda"):
    """Zeroed ring of ``window`` lanes per slot: k/v [L, B, window, K, hd]
    and ``pos`` [B]."""
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.n_layers, batch, window, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def ring_write(cache_k, cache_v, k, v, pos, window: int):
    """Write one token's K/V at lane pos % window of each row, IN PLACE
    (JAX selects over the window; ``blocks.dense_write`` on a ring).
    cache_k/v [B, window, K, hd]; k/v [B, 1, K, hd]; pos [B]. Returns
    (cache_k, cache_v)."""
    index = dense_write_index(pos, window, ring=True)
    dense_write(cache_k, index, k[:, 0])
    dense_write(cache_v, index, v[:, 0])
    return cache_k, cache_v
