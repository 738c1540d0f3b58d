"""Symbiosis system composition — the serving half of ``repro.core.symbiosis``
that the paged, single-bank LoRA path runs.

One frozen base serves a BANK of clients. Bank caches keep per-slot leaves
with a leading client axis (``pos`` [C, B], ``block_tbl`` [C, B, n_blocks])
and ONE global page pool per KV leaf, [L, C*P, blk, K, hd]: client c owns
the page range [c*P, (c+1)*P) by allocator convention, and block tables
carry global page ids. The compacted steps gather the active (client, slot)
rows across clients into one batch, run the model once, and scatter the
per-slot results back under the row mask; the pools are written in place
through the gathered tables (the JAX steps donated the cache buffers).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.config import AdapterConfig, DENSE, ModelConfig, ServeConfig
from repro_torch.core import adapters as adapters_lib
from repro_torch.core.virtlayer import make_compact_ctx
from repro_torch.models import get_model
from repro_torch.models.transformer import default_block_table, pool_leaves


def init_system(cfg: ModelConfig, acfg: AdapterConfig, n_clients: int,
                generator: torch.Generator, *, device="cuda",
                adapter_dtype=torch.float32):
    """Returns (base_params, client_bank). No optimizer state: the port
    serves but does not train yet."""
    base = get_model(cfg).init_params(generator, device)
    bank = adapters_lib.init_client_bank(cfg, acfg, n_clients, generator,
                                         dtype=adapter_dtype, device=device)
    return base, bank


def serve_cache_kwargs(cfg: ModelConfig, scfg: ServeConfig):
    """Cache-construction kwargs implied by a ServeConfig: the paged layout
    and, with ``kv_quant``, int8 entries with per-head scales."""
    kw = {}
    if scfg.page_block and cfg.arch == DENSE:
        kw["page_block"] = scfg.page_block
        if scfg.pool_pages:
            kw["pool_pages"] = scfg.pool_pages
    if scfg.kv_quant and cfg.arch == DENSE:
        kw["quant"] = True
    return kw


def init_client_caches(cfg: ModelConfig, n_clients: int, batch: int,
                       max_seq: int, dtype=None, *, page_block: int,
                       pool_pages: int = 0, quant: bool = False,
                       device="cuda"):
    """Bank caches: ``pos`` [C, B] and ``block_tbl`` [C, B, n_blocks] per
    slot, and the GLOBAL FLAT page pools {"k","v"} [L, C*P, blk, K, hd]
    (with ``quant``: int8 {"k","v"} and f32 {"k_s","v_s"} [L, C*P, blk, K,
    1])."""
    if not page_block:
        raise ValueError("the port serves the paged KV layout only")
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    _, P, tbl = default_block_table(batch, max_seq, page_block, pool_pages,
                                    dev)
    shape = (cfg.n_layers, n_clients * P, page_block, cfg.n_kv_heads, cfg.hd)
    return {"layers": pool_leaves(shape, dtype, quant, dev),
            "pos": torch.zeros((n_clients, batch), dtype=torch.int32,
                               device=dev),
            "block_tbl": tbl[None].repeat(n_clients, 1, 1)}


def _check_paged(cfg, scfg, what):
    if "page_block" not in serve_cache_kwargs(cfg, scfg):
        raise ValueError(f"{what} requires the paged KV layout (ServeConfig."
                         "page_block > 0) on the dense family")


def _gather_rows(caches, clients, slots):
    """Per-row view of the bank caches for rows (clients[i], slots[i]):
    the pools pass through (flat already); pos and table rows are
    gathered. Returns (flat row ids, compact cache)."""
    C, B = caches["pos"].shape
    rows = clients.long() * B + slots.long()
    return rows, {"layers": caches["layers"],
                  "pos": caches["pos"].reshape(C * B)[rows],
                  "block_tbl": caches["block_tbl"].reshape(C * B, -1)[rows]}


def _scatter_pos(caches, rows, row_mask, new_pos):
    """Write the live rows' positions back IN PLACE. Padding rows alias real
    slots, so every row adds its position change (zero for padding) with an
    accumulating scatter: integers, exact, a fixed shape, no host sync."""
    flat = caches["pos"].view(-1)
    delta = torch.where(row_mask, new_pos.to(torch.int32) - flat[rows], 0)
    flat.index_put_((rows,), delta, accumulate=True)


def make_compact_decode_step(cfg: ModelConfig, acfg: AdapterConfig,
                             scfg: ServeConfig):
    """Compute-proportional decode tick over ONLY the active slots:

      fn(base, bank, caches, tokens, clients, slots, row_mask)
        -> (logits [n_rows, V], finite [n_rows] bool, new caches)

    Row i is slot ``slots[i]`` of client ``clients[i]`` feeding
    ``tokens[i]``; ``row_mask`` False marks padding rows, whose logits are
    garbage and whose writes are dropped. ``finite`` is the probe the
    engine quarantines on. Per-row LoRA goes through SGMV, attention
    through the paged decode kernel. The caches are updated IN PLACE and
    returned; the step never waits on the host."""
    _check_paged(cfg, scfg, "compact decode")
    model = get_model(cfg)

    def compact(base, bank, caches, tokens, clients, slots, row_mask):
        rows, cache = _gather_rows(caches, clients, slots)
        ctx = make_compact_ctx(cfg, acfg, clients)
        adapter = adapters_lib.compact_adapter_bank(bank)
        logits, new = model.decode_step(base, cache, tokens, ctx, adapter,
                                        active=row_mask)
        _scatter_pos(caches, rows, row_mask, new["pos"])
        return logits, torch.isfinite(logits).all(dim=-1), caches

    return compact


def make_compact_prefill(cfg: ModelConfig, acfg: AdapterConfig,
                         scfg: ServeConfig):
    """Cross-client compacted PREFILL: every same-tick admission rides ONE
    ragged batch.

      fn(base, bank, caches, tokens, lengths, clients, slots, row_mask)
        -> (logits [n_rows, V], finite [n_rows] bool, new caches)

    ``tokens`` [n_rows, S_pad] are right-padded prompts with true
    ``lengths``; padding rows carry length 0 and write nothing. This is the
    JAX step with ``starts`` all zero and ``ext_blocks=0`` (shared-prefix
    pages are not ported yet). Per-row LoRA goes through SGMV with one
    S_pad-token block per row. Caches are updated IN PLACE and returned."""
    _check_paged(cfg, scfg, "compact prefill")
    model = get_model(cfg)

    def compact(base, bank, caches, tokens, lengths, clients, slots,
                row_mask):
        rows, cache = _gather_rows(caches, clients, slots)
        ctx = make_compact_ctx(cfg, acfg, clients)
        adapter = adapters_lib.compact_adapter_bank(bank)
        logits, new = model.prefill(base, {"tokens": tokens}, cache, ctx,
                                    adapter, lengths=lengths)
        _scatter_pos(caches, rows, row_mask, new["pos"])
        return logits, torch.isfinite(logits).all(dim=-1), caches

    return compact
