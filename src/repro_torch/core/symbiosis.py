"""Symbiosis system composition — the serving half (the paged, compacted
path over single or mixed banks of LoRA, IA3 and prefix clients with
shared-prefix suffix prefills and the copy-on-write page copy; the masked
bank-wide decode and per-client prefill over paged or dense caches; the
multi-client prefill and decode), and the fine-tuning half, of
``repro.core.symbiosis``.

One frozen base serves a BANK of clients. Bank caches keep per-slot leaves
with a leading client axis (``pos`` [C, B], ``block_tbl`` [C, B, n_blocks]).
A paged bank keeps ONE global page pool per KV leaf, [L, C*P, blk, K, hd]:
client c owns the page range [c*P, (c+1)*P) by allocator convention, and
block tables carry global page ids. A dense bank keeps its KV leaves
layer-major, [L, C, B, T, K, hd] (JAX: client-major [C, L, B, T, K, hd];
``convert`` carries them across), so one layer's C*B slot rows are one
contiguous [C*B, T, K, hd] slab for the dense decode-attention kernel.
The compacted steps gather the active (client, slot) rows across clients
into one batch, run the model once, and scatter the per-slot results back
under the row mask; the masked steps run every slot of the bank as one
batch of C*B rows in (client, slot) order, each row's adapter its
client's. Every cache write is in place (the JAX steps donated the cache
buffers). An RWKV model has no pages (``serve_cache_kwargs`` drops them):
its bank caches hold its per-slot state alone, layer-major, and it takes
the masked steps and the per-client prefill. An encoder-decoder model
pages its decoder's self-attention K/V and keeps each slot's cross cache
([L, C, B, Te, K, hd] in a bank); its prefills need the batch's
``frames``, so it takes the bank-wide ``make_multi_client_prefill``
(frames beside the tokens) and the decode steps; the per-client prefill,
whose caller passes tokens only, refuses it (JAX's raises ``KeyError:
'frames'``), and the compacted prefill refuses it as JAX's does.

Fine-tuning (LoRA, IA3 and prefix): ``make_row_grad_fn`` is one job's
loss and adapter grads, ``make_baseline_train_step`` the dedicated
single-job trainer (and, by default, the torch-like memory baseline),
``make_compact_train_step`` the multi-job tick of
``training.FinetuneEngine`` over one bank of jobs, each with its own AdamW
state, schedule position and data, ``make_multi_client_train_step`` C
clients on one schedule, and ``make_mixed_step`` a train step and a
bank-wide decode against the same base (paper §4.4). The JAX steps
``vmap`` the row program over the bank rows with the base unbatched; here
the rows' batches run as ONE forward whose base linears see every row's
tokens (§3.7 batching) while each row's adapter acts on its own sequences
only (a LoRA ``bmm`` per row, a per-row IA3 scale, each sequence given
its row's prefix), and ``torch.autograd.grad`` of the sum of the per-row
losses yields each row's own grads. An MoE model routes each row's
tokens alone in that forward (``moe_forward(rows=R)``: the row's own
capacity, dropped tokens and aux loss, as JAX's ``vmap`` gives a row), and
a VLM batch's ``img_embed`` or an encoder-decoder batch's ``frames``
rides beside its tokens, sliced as they are.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.common.nullspan import null_span
from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.config import (ENCDEC, HYBRID, RWKV, AdapterConfig,
                                ModelConfig, ServeConfig, TrainConfig,
                                check_family)
from repro_torch.core import adapters as adapters_lib
from repro_torch.core.virtlayer import (make_bank_ctx, make_client_ctx,
                                        make_compact_ctx, make_mixed_ctx)
from repro_torch.models import get_model
from repro_torch.models.hybrid import sub_is_attn
from repro_torch.models.losses import lm_loss
from repro_torch.optim import adamw_update, adamw_update_hyper, warmup_cosine


def init_system(cfg: ModelConfig, acfg: AdapterConfig, n_clients: int,
                generator: torch.Generator, *, device="cuda",
                adapter_dtype=torch.float32):
    """Returns (base_params, client_bank). No optimizer state: a
    fine-tuning job brings its own (``optim.adamw_init``)."""
    base = get_model(cfg).init_params(generator, device)
    bank = adapters_lib.init_client_bank(cfg, acfg, n_clients, generator,
                                         dtype=adapter_dtype, device=device)
    return base, bank


def serve_cache_kwargs(cfg: ModelConfig, scfg: ServeConfig):
    """Cache-construction kwargs implied by a ServeConfig: the paged layout
    (``page_block > 0``) and, with ``kv_quant``, int8 entries with
    per-head scales. No ``page_block`` means the dense layout. The pure-KV
    families (dense, MoE, VLM) take both; the hybrid pages its attention
    sublayers' K/V and, as in JAX, drops ``kv_quant`` (its Mamba state is
    never quantized, and JAX quantizes pure-KV caches only); RWKV, whose
    state is O(1) per slot, drops both, as in JAX: it has no KV to page;
    the encoder-decoder pages its decoder's self-attention K/V and drops
    ``kv_quant``, as in JAX."""
    check_family(cfg)
    kw = {}
    if scfg.page_block and cfg.arch != RWKV:
        kw["page_block"] = scfg.page_block
        if scfg.pool_pages:
            kw["pool_pages"] = scfg.pool_pages
    if scfg.kv_quant and cfg.arch not in (HYBRID, RWKV, ENCDEC):
        kw["quant"] = True
    return kw


def _container(caches) -> str:
    """The layer container of a cache tree: ``layers`` (an RWKV model's
    state too), or a hybrid model's ``groups``."""
    return "groups" if "groups" in caches else "layers"


def init_client_caches(cfg: ModelConfig, n_clients: int, batch: int,
                       max_seq: int, dtype=None, *, window: int = 0,
                       quant: bool = False, page_block: int = 0,
                       pool_pages: int = 0, device="cuda"):
    """Bank caches: ``init_cache``'s tree for ``batch`` slots with a client
    axis inserted in each per-slot leaf at its slot axis
    (``cache_slot_axes``): ``pos`` [C, B], dense KV rows layer-major [L, C,
    B, T, K, hd] (T = max_seq, or a ring of ``min(window, max_seq)``), a
    hybrid model's Mamba state [G, C, B, ...], an RWKV model's state [L, C,
    B, ...], an encoder-decoder's cross caches [L, C, B, Te, K, hd]. Paged,
    the pools are GLOBAL
    and FLAT, [L, C*P, blk, K, hd] (client c owns pages [c*P, (c+1)*P)),
    and ``block_tbl`` is [C, B, n_blocks], every client's the one-client
    default. With ``quant``: int8 {"k","v"} and f32 {"k_s","v_s"} scales
    [..., K, 1]."""
    dev = resolve_device(device)
    kw = {k: v for k, v in (("window", window), ("quant", quant),
                            ("page_block", page_block),
                            ("pool_pages", pool_pages)) if v}
    one = get_model(cfg).init_cache(batch, max_seq, dtype, device=dev, **kw)
    return stack_client_caches(cfg, max_seq, [one] * n_clients, offset=False,
                               **kw)


def _kv_names(cache_kw):
    return ("k", "k_s", "v", "v_s") if cache_kw.get("quant") else ("k", "v")


def cache_slot_axes(cfg: ModelConfig, max_seq: int, **cache_kw):
    """Per-leaf slot axis of ONE client's cache (``init_cache``'s tree):
    ``pos`` 0; dense KV leaves ([L, B, T, ...], a hybrid's [G, B, T, ...]),
    a hybrid's Mamba state ([G, B, ...]), an RWKV model's ``wkv``,
    ``tm_x`` and ``cm_x`` and an encoder-decoder's ``cross_k`` /
    ``cross_v`` ([L, B, ...]) 1; paged pools (no slot axis:
    their writes are gated inside the model) and ``block_tbl``
    (engine-managed) None. The JAX function derives this map by building
    the cache at two batch sizes; the port knows its trees and writes it
    down, the same map on every leaf. The bank steps read every slot and
    page axis from here and ``cache_page_axes``."""
    paged = bool(cache_kw.get("page_block"))
    kv = None if paged else 1
    if cfg.arch == HYBRID:
        axes = {"groups": {
            f"sub{j}": ({"k": kv, "v": kv} if sub_is_attn(cfg, j)
                        else {"h": 1, "conv": 1})
            for j in range(cfg.attn_every)}, "pos": 0}
    elif cfg.arch == RWKV:
        axes = {"layers": {"wkv": 1, "tm_x": 1, "cm_x": 1}, "pos": 0}
    elif cfg.arch == ENCDEC:
        axes = {"layers": {"k": kv, "v": kv, "cross_k": 1, "cross_v": 1},
                "pos": 0}
    else:
        axes = {"layers": {n: kv for n in _kv_names(cache_kw)}, "pos": 0}
    if paged:
        axes["block_tbl"] = None
    return axes


def cache_page_axes(cfg: ModelConfig, max_seq: int, **cache_kw):
    """Per-leaf page axis of ONE client's PAGED cache: pools [L, P, ...]
    (a hybrid's [G, P, ...]) 1; ``pos``, ``block_tbl`` and per-slot state
    None (the twin of ``cache_slot_axes``)."""
    if not cache_kw.get("page_block"):
        raise ValueError("page axes exist only for paged caches")
    axes = tree_map(lambda ax: 1 if ax is None else None,
                    cache_slot_axes(cfg, max_seq, **cache_kw))
    axes["block_tbl"] = None
    return axes


def _slot_mask(mask, ax, ndim):
    """Reshape a [n_slots] mask to broadcast along axis ``ax`` of an
    ``ndim``-rank leaf."""
    shape = [1] * ndim
    shape[ax] = mask.shape[-1]
    return mask.reshape(shape)


def _slot_leaves(cache, axes):
    """[(leaf, slot axis)] of the per-slot leaves in a cache's layer
    container (dense KV rows, Mamba state; not the pools), in the order
    ``tree_leaves`` walks them. The axis is the model-level one: a bank
    leaf carries its client axis there, its slots right after."""
    key = _container(cache)
    return [(t, ax) for t, ax in zip(tree_leaves(cache[key]),
                                     tree_leaves(axes[key])) if ax is not None]


def stack_client_caches(cfg: ModelConfig, max_seq: int, per_client, *,
                        offset: bool = True, **cache_kw):
    """Stack per-client model caches (``init_cache`` trees, e.g. after
    standalone prefills on identity tables) into the BANK layout: each
    per-slot leaf gains the client axis at its slot axis (``pos`` [C, B],
    dense KV [L, C, B, T, ...], Mamba state [G, C, B, ...]); paged pools
    fold into the one global flat pool on their page axis (client c's
    pages land in [c*P, (c+1)*P)) and block tables are offset to global
    page ids (``offset=False`` keeps them as they are: the bank of
    ``init_client_caches``). The inverse convention of JAX's
    ``init_client_caches``."""
    axes = cache_slot_axes(cfg, max_seq, **cache_kw)
    key = _container(per_client[0])
    out = {key: tree_map(lambda ax, *ts: torch.cat(ts, dim=1) if ax is None
                         else torch.stack(ts, dim=ax),
                         axes[key], *(pc[key] for pc in per_client)),
           "pos": torch.stack([pc["pos"] for pc in per_client])}
    if cache_kw.get("page_block"):
        tbl = torch.stack([pc["block_tbl"] for pc in per_client])
        if offset:
            P = next(t.shape[1] for t, ax in zip(
                tree_leaves(per_client[0][key]), tree_leaves(axes[key]))
                if ax is None)
            tbl = tbl + (torch.arange(len(per_client), dtype=tbl.dtype,
                                      device=tbl.device) * P)[:, None, None]
        out["block_tbl"] = tbl
    return out


def _check_paged(cfg, scfg, what):
    """Refuse ``what`` without pages, in JAX's words (an RWKV model has
    none whatever ``page_block`` says: ``serve_cache_kwargs``)."""
    if "page_block" not in serve_cache_kwargs(cfg, scfg):
        raise ValueError(f"{what} requires the paged KV layout (ServeConfig."
                         "page_block > 0 on an attention-bearing family)")


def _decode_written(cfg: ModelConfig, axes):
    """``axes`` with the per-slot leaves a decode step only READS mapped to
    None: an encoder-decoder's cross caches, written at prefill. The
    compacted decode gathers them for its rows and scatters nothing back
    (the bits it would write are the ones there: 2 x L x Te x K x hd
    elements per row per tick)."""
    if cfg.arch != ENCDEC:
        return axes
    return dict(axes, layers=dict(axes["layers"], cross_k=None, cross_v=None))


def _gather_rows(caches, axes, clients, slots):
    """Per-row view of the bank caches for rows (clients[i], slots[i]):
    the pools pass through (flat already); pos, table rows and every other
    per-slot leaf (a hybrid's Mamba state: copies, written back by
    ``_scatter_rows``) are gathered. Returns (flat row ids, compact
    cache)."""
    C, B = caches["pos"].shape
    rows = clients.long() * B + slots.long()
    key = _container(caches)
    return rows, {key: tree_map(
        lambda t, ax: t if ax is None else t.flatten(ax, ax + 1)
        .index_select(ax, rows), caches[key], axes[key]),
        "pos": caches["pos"].reshape(C * B)[rows],
        "block_tbl": caches["block_tbl"].reshape(C * B, -1)[rows]}


def _scatter_pos(caches, rows, row_mask, new_pos):
    """Write the live rows' positions back IN PLACE. Padding rows alias real
    slots, so every row adds its position change (zero for padding) with an
    accumulating scatter: integers, exact, a fixed shape, no host sync."""
    flat = caches["pos"].view(-1)
    delta = torch.where(row_mask, new_pos.to(torch.int32) - flat[rows], 0)
    flat.index_put_((rows,), delta, accumulate=True)


def _scatter_rows(caches, compact, axes, rows, row_mask):
    """Write the live rows of the compact cache's per-slot leaves (a
    hybrid's Mamba state) back into the bank IN PLACE. Padding rows alias
    real slots, so each is pointed at the first live row (same slot, same
    bytes: JAX drops them with ``mode="drop"``), and with no live row every
    row writes back what its slot holds. Fixed shapes, no host sync; the
    pure-KV families have no such leaf and launch nothing here."""
    pairs = [(full, part, ax) for (full, ax), (part, _) in
             zip(_slot_leaves(caches, axes), _slot_leaves(compact, axes))]
    if not pairs:
        return
    first = row_mask.long().argmax(dim=0, keepdim=True)
    src = torch.where(row_mask, torch.arange(rows.shape[0],
                                             device=rows.device), first)
    dst = rows[src]
    any_kept = row_mask.any()
    for full, part, ax in pairs:
        flat = full.flatten(ax, ax + 1)
        flat.index_copy_(ax, dst, torch.where(
            any_kept, part.index_select(ax, src), flat.index_select(ax, dst)))


def _row_ctx(cfg, acfg, bank, clients, locals_=None, methods=None):
    """(LinCtx, re-laid adapter tree) of one compacted batch: a single
    bank's (``acfg`` one AdapterConfig, rows named by ``clients``) or, for
    a tuple of AdapterConfigs, the mixed banks' (rows named by their bank
    ``methods`` and their ``locals_`` index within it); ``acfg`` None runs
    the bare base."""
    if acfg is None:
        return make_client_ctx(cfg, None), None
    if isinstance(acfg, tuple):
        return (make_mixed_ctx(cfg, acfg, locals_, methods),
                adapters_lib.compact_mixed_bank(bank, locals_, methods))
    return (make_compact_ctx(cfg, acfg, clients),
            adapters_lib.compact_adapter_bank(bank, clients))


def make_compact_decode_step(cfg: ModelConfig, acfg, scfg: ServeConfig):
    """Compute-proportional decode tick over ONLY the active slots.

    Single bank (``acfg`` an AdapterConfig):

      fn(base, bank, caches, tokens, clients, slots, row_mask)
        -> (logits [n_rows, V], finite [n_rows] bool, new caches)

    MIXED banks (``acfg`` a tuple of AdapterConfigs, the engine's bank
    registry):

      fn(base, banks, caches, tokens, clients, slots, methods, locals_,
         row_mask) -> (logits, finite, new caches)

    with ``banks`` the matching tuple of client-stacked trees,
    ``methods[i]`` row i's bank and ``locals_[i]`` its client index within
    that bank (``clients[i]`` stays the GLOBAL cache client). Each row's
    math is bitwise its single-bank run's (``virtlayer.make_mixed_ctx``).

    Row i is slot ``slots[i]`` of client ``clients[i]`` feeding
    ``tokens[i]``; ``row_mask`` False marks padding rows, whose logits are
    garbage and whose writes are dropped. ``finite`` is the probe the
    engine quarantines on. Per-row LoRA goes through SGMV, attention
    through the paged decode kernel. A hybrid model's Mamba state is
    gathered per row and its live rows written back (padding rows
    dropped); an encoder-decoder's cross caches are gathered and, read
    only, not written back (``_decode_written``). The caches are updated
    IN PLACE and returned; the step never waits on the host."""
    _check_paged(cfg, scfg, "compact decode")
    model = get_model(cfg)
    acfg = tuple(acfg) if isinstance(acfg, (tuple, list)) else acfg
    axes = cache_slot_axes(cfg, scfg.max_seq,
                           **serve_cache_kwargs(cfg, scfg))
    written = _decode_written(cfg, axes)

    def run(base, bank, caches, tokens, clients, slots, row_mask,
            locals_=None, methods=None):
        rows, cache = _gather_rows(caches, axes, clients, slots)
        ctx, adapter = _row_ctx(cfg, acfg, bank, clients, locals_, methods)
        logits, new = model.decode_step(base, cache, tokens, ctx, adapter,
                                        active=row_mask)
        _scatter_rows(caches, new, written, rows, row_mask)
        _scatter_pos(caches, rows, row_mask, new["pos"])
        return logits, torch.isfinite(logits).all(dim=-1), caches

    def compact_mixed(base, banks, caches, tokens, clients, slots, methods,
                      locals_, row_mask):
        return run(base, banks, caches, tokens, clients, slots, row_mask,
                   locals_, methods)

    return compact_mixed if isinstance(acfg, tuple) else run


def make_compact_prefill(cfg: ModelConfig, acfg, scfg: ServeConfig, *,
                         ext_blocks: int = 0):
    """Cross-client compacted PREFILL: every same-tick admission, across
    clients and banks, rides ONE ragged batch.

    Single bank:

      fn(base, bank, caches, tokens, lengths, starts, clients, slots,
         row_mask) -> (logits [n_rows, V], finite [n_rows] bool, new caches)

    MIXED banks (``acfg`` a tuple, as ``make_compact_decode_step``):

      fn(base, banks, caches, tokens, lengths, starts, clients, slots,
         methods, locals_, row_mask) -> (logits, finite, new caches)

    ``tokens`` [n_rows, S_pad] are right-padded prompt SUFFIXES with true
    ``lengths``; ``starts`` [n_rows] are the tokens already cached in the
    row's mapped shared-prefix pages (0: the full prompt). Padding rows
    carry length 0 and write nothing. ``ext_blocks`` is the number of
    leading table entries each row reads as shared-prefix K/V lanes
    (``transformer.prefill``); rows with fewer cached blocks mask the rest
    by position, and 0 is the full prefill. Per-row LoRA goes through SGMV
    with one S_pad-token block per row. Caches are updated IN PLACE and
    returned. The hybrid and encoder-decoder families are refused, in
    JAX's words: the hybrid's recurrent state cannot take right-padded
    rows, and an encoder-decoder's rows carry no frames."""
    _check_paged(cfg, scfg, "compact prefill")
    if cfg.arch in (HYBRID, ENCDEC):
        raise ValueError(
            f"compact prefill serves the pure-KV families (dense/MoE/VLM); "
            f"{cfg.arch} admissions stay on the per-client prefill path")
    if ext_blocks and scfg.kv_quant:
        raise ValueError("shared-prefix prefill (ext_blocks > 0) requires "
                         "an unquantized KV cache")
    model = get_model(cfg)
    acfg = tuple(acfg) if isinstance(acfg, (tuple, list)) else acfg

    axes = cache_slot_axes(cfg, scfg.max_seq,
                           **serve_cache_kwargs(cfg, scfg))

    def run(base, bank, caches, tokens, lengths, starts, clients, slots,
            row_mask, locals_=None, methods=None):
        rows, cache = _gather_rows(caches, axes, clients, slots)
        ctx, adapter = _row_ctx(cfg, acfg, bank, clients, locals_, methods)
        logits, new = model.prefill(base, {"tokens": tokens}, cache, ctx,
                                    adapter, lengths=lengths, starts=starts,
                                    ext_blocks=ext_blocks)
        _scatter_pos(caches, rows, row_mask, new["pos"])
        return logits, torch.isfinite(logits).all(dim=-1), caches

    def compact_mixed(base, banks, caches, tokens, lengths, starts, clients,
                      slots, methods, locals_, row_mask):
        return run(base, banks, caches, tokens, lengths, starts, clients,
                   slots, row_mask, locals_, methods)

    return compact_mixed if isinstance(acfg, tuple) else run


def _bank_rows(caches, axes):
    """A dense bank cache as one batch of its C*B slot rows in (client,
    slot) order: each per-slot leaf [.., C, B, ..] as its [.., C*B, ..]
    view and ``pos`` [C*B] (views: writes land in the bank cache)."""
    key = _container(caches)
    return {key: tree_map(lambda t, ax: t.flatten(ax, ax + 1), caches[key],
                          axes[key]),
            "pos": caches["pos"].view(-1)}


def _row_clients(C: int, B: int, device):
    """Each of C*B slot rows' client, in (client, slot) order."""
    return torch.arange(C, dtype=torch.int32, device=device) \
        .repeat_interleave(B)


def _check_dense(scfg, what):
    if scfg.page_block:
        raise ValueError(f"{what} runs on the dense KV layout: its bank "
                         "caches carry a client axis that page pools fold "
                         "away (ServeConfig.page_block = 0)")


def _slot_zeroer(slots, slot_mask):
    """``zero(rows, ax)``: zero the admitted ``slots`` of a bank rows view
    (row axis ``ax``) in place, reading one row: each slot that is not
    admitted writes the first admitted slot's zeros again, or, with none
    admitted, slot 0's own bits back."""
    # slots are consecutive: the first admitted one without a host read
    tgt = torch.where(slot_mask, slots,
                      slots[:1] + slot_mask.to(torch.int32).argmax())
    none = ~slot_mask.any()

    def zero(rows, ax):
        one = torch.where(none, rows.index_select(ax, tgt[:1]), 0)
        rows.index_copy_(ax, tgt, one.expand(
            [tgt.shape[0] if d == ax else -1 for d in range(one.ndim)]))

    return zero


def make_client_prefill(cfg: ModelConfig, acfg, scfg: ServeConfig):
    """Masked single-client prefill — the engine's per-request admission:
    the model runs ONCE over one client's ``max_b`` slot rows and only the
    admitted slots take the result.

      fn(base, bank, caches, c, a, tokens, lengths, slot_mask)
        -> (logits [max_b, V], caches)

    ``c`` is the client's index into the CACHES, ``a`` its adapter's index
    into ``bank`` (a single-bank engine passes ``a == c``): host ints or
    one-element index tensors, as JAX's are traced scalars, so one program
    serves every client (the engine passes tensors: its prefill's call
    signature is the same for every client, a closed set);
    ``tokens`` [max_b, S_pad] right-padded prompts on the admitted rows,
    dummies elsewhere; ``lengths`` [max_b] their true lengths (the engine
    gives other rows 0); ``slot_mask`` [max_b] bool the admitted slots.
    Every per-slot leaf of the admitted slots is zeroed first, as JAX's
    ``zero_slots`` leaves it (dense KV rows over all T lanes, a hybrid's
    Mamba state, an RWKV model's state; ``pos`` as the prefill reads it),
    and the prefill writes those leaves on the admitted rows only (dense
    KV: lanes [0, S_pad)). Paged pools are written only where
    lengths > 0. Other slots and clients keep their bits; ``pos`` takes
    the new value on the admitted slots. LoRA goes through SGMV (one
    S_pad-token block per row), IA3 and prefix through the row hooks, every
    row the client's adapter. The model reads and writes the client's slot
    rows of the bank in place, by index (``slots``), layer by layer: a
    layer's rows are gathered where the model reads them, and written by
    ``index_copy_``, so nothing of the client's state is copied whole and
    the bank's tensors keep their storage. Caches are written IN PLACE and
    returned.
    The encoder-decoder family is refused: the call carries no frames
    (JAX's raises ``KeyError: 'frames'``)."""
    check_family(cfg, frameless="make_client_prefill")
    model = get_model(cfg)
    axes = cache_slot_axes(cfg, scfg.max_seq,
                           **serve_cache_kwargs(cfg, scfg))

    def prefill_one(base, bank, caches, c, a, tokens, lengths, slot_mask):
        B = tokens.shape[0]
        c, a = as_index(c, tokens.device), as_index(a, tokens.device)
        ctx, adapter = _row_ctx(cfg, acfg, bank, a.to(torch.int32).repeat(B))
        key = _container(caches)
        slots = c * B + torch.arange(B, device=tokens.device)   # bank rows
        pos_c = caches["pos"].view(-1).index_select(0, slots)
        cache = {key: tree_map(lambda t, ax: t if ax is None else t.view(
                     t.shape[:ax] + (-1,) + t.shape[ax + 2:]),
                     caches[key], axes[key]),          # [.., C*B, ..] views
                 "pos": torch.where(slot_mask, 0, pos_c)}
        if "block_tbl" in caches:
            cache["block_tbl"] = caches["block_tbl"].index_select(0, c)[0]
        kw, zero = {}, _slot_zeroer(slots, slot_mask)
        for rows, ax in _slot_leaves(cache, axes):     # zero_slots
            zero(rows, ax)
            kw = {"write_rows": slot_mask, "slots": slots}
        logits, new = model.prefill(base, {"tokens": tokens}, cache, ctx,
                                    adapter, lengths=lengths, **kw)
        caches["pos"].view(-1).index_copy_(
            0, slots, torch.where(slot_mask, new["pos"], pos_c))
        return logits, caches

    return prefill_one


def make_masked_decode_step(cfg: ModelConfig, acfg, scfg: ServeConfig, *,
                            ring: bool = False):
    """Bank-wide decode tick with per-slot advance control.

      fn(base, bank, caches, tokens [C, B], active [C, B])
        -> (logits [C, B, V], caches)

    Every slot of the bank runs, as ONE batch of C*B rows in (client,
    slot) order, each row's adapter its client's (LoRA through SGMV with
    ``block_t`` 1, IA3 and prefix through the row hooks); only the
    ``active`` slots write their token and advance ``pos``, every other
    slot keeps its bits. Logits of inactive slots are garbage.

    Paged caches: this is ``make_compact_decode_step`` run over all C*B
    rows with ``active`` as the row mask — the same program, so when every
    slot is active the two agree bit for bit (the JAX step reaches the
    same computation through the kernels' ``custom_vmap`` rules, which
    fold the client axis into rows against the shared pool). ``ring`` is
    ignored there, as in JAX. Dense caches: one layer's C*B rows are one
    contiguous slab for the dense decode-attention kernel (``ring``: plain
    attention over a ring of depth T). Caches are written IN PLACE and
    returned."""
    model = get_model(cfg)
    cache_kw = serve_cache_kwargs(cfg, scfg)
    paged = "page_block" in cache_kw
    compact = make_compact_decode_step(cfg, acfg, scfg) if paged else None
    axes = cache_slot_axes(cfg, scfg.max_seq, **cache_kw)

    def decode(base, bank, caches, tokens, active):
        C, B = caches["pos"].shape
        clients = _row_clients(C, B, tokens.device)
        act = active.reshape(C * B)
        if paged:
            slots = torch.arange(B, dtype=torch.int32,
                                 device=tokens.device).repeat(C)
            logits, _, caches = compact(base, bank, caches,
                                        tokens.reshape(C * B), clients,
                                        slots, act)
            return logits.reshape(C, B, -1), caches
        ctx, adapter = _row_ctx(cfg, acfg, bank, clients)
        rows = _bank_rows(caches, axes)
        logits, new = model.decode_step(base, rows, tokens.reshape(C * B),
                                        ctx, adapter, ring=ring, active=act)
        rows["pos"].copy_(torch.where(act, new["pos"], rows["pos"]))
        return logits.reshape(C, B, -1), caches

    return decode


def make_multi_client_prefill(cfg: ModelConfig, acfg, scfg: ServeConfig):
    """Bank-wide prefill over a dense bank (the seed engine's admission):

      fn(base, bank, caches, batch, write_clients=None)
        -> (logits [C, B, V], caches)

    ``batch["tokens"]`` [C, B, S]: every client's B rows run as ONE batch
    of C*B rows, each with its client's adapter, writing lanes [0, S) of
    every row and ``pos`` = S. Every other leaf of ``batch`` rides beside
    the tokens, [C, B, ...] flattened alike (an encoder-decoder's
    ``frames`` [C, B, Te, d], whose encoder states fill the rows' cross
    caches). ``write_clients`` [C] bool (the port's in-place form of the
    JAX engine's merge) limits the writes to those clients' rows. Caches
    are written IN PLACE and returned."""
    _check_dense(scfg, "the multi-client prefill")
    model = get_model(cfg)
    axes = cache_slot_axes(cfg, scfg.max_seq,
                           **serve_cache_kwargs(cfg, scfg))

    def prefill(base, bank, caches, batch, write_clients=None):
        tokens = batch["tokens"]
        C, B, S = tokens.shape
        ctx, adapter = _row_ctx(cfg, acfg, bank,
                                _row_clients(C, B, tokens.device))
        rows = _bank_rows(caches, axes)
        write_rows = (None if write_clients is None
                      else write_clients.repeat_interleave(B))
        logits, new = model.prefill(base, {k: v.flatten(0, 1)
                                           for k, v in batch.items()},
                                    rows, ctx, adapter, write_rows=write_rows)
        rows["pos"].copy_(new["pos"] if write_rows is None else
                          torch.where(write_rows, new["pos"], rows["pos"]))
        return logits.reshape(C, B, -1), caches

    return prefill


def make_multi_client_decode_step(cfg: ModelConfig, acfg, scfg: ServeConfig,
                                  *, ring: bool = False):
    """Every slot of a dense bank decodes one token:

      fn(base, bank, caches, tokens [C, B]) -> (logits [C, B, V], caches)

    the masked step with every slot active (``ring``: a ring cache)."""
    _check_dense(scfg, "the multi-client decode step")
    masked = make_masked_decode_step(cfg, acfg, scfg, ring=ring)

    def decode(base, bank, caches, tokens):
        active = torch.ones(tokens.shape, dtype=torch.bool,
                            device=tokens.device)
        return masked(base, bank, caches, tokens, active)

    return decode


def as_index(i, device):
    """A host int or a one-element index tensor as a [1] long tensor on
    ``device`` (a host int by a fill: no copy from the host, no wait)."""
    if isinstance(i, torch.Tensor):
        return i.reshape(1).to(device=device, dtype=torch.long)
    return torch.full((1,), int(i), dtype=torch.long, device=device)


def make_page_copy(cfg: ModelConfig, scfg: ServeConfig):
    """Copy-on-write of a shared-prefix tail page:

      fn(caches, src, dst) -> caches

    page ``dst`` of every pool leaf becomes a bitwise copy of page ``src``
    across every layer: per leaf, the source page gathered by index and
    written into the destination by an in-place ``index_copy_``, so the
    pools keep their ``data_ptr`` and the host never waits. ``src``/``dst``
    are global page ids: host ints or one-element index tensors (JAX's are
    traced scalars; the engine passes tensors, so one program serves every
    copy)."""
    _check_paged(cfg, scfg, "page copy")
    page_axes = cache_page_axes(cfg, scfg.max_seq,
                                **serve_cache_kwargs(cfg, scfg))

    def copy_page(caches, src, dst):
        key = _container(caches)
        pools = [(leaf, pax) for leaf, pax in zip(
            tree_leaves(caches[key]), tree_leaves(page_axes[key]))
            if pax is not None]
        dev = pools[0][0].device
        src, dst = as_index(src, dev), as_index(dst, dev)
        for leaf, pax in pools:
            leaf.index_copy_(pax, dst, leaf.index_select(pax, src))
        return caches

    return copy_page


# ---------------------------------------------------------------------------
# Fine-tuning
# ---------------------------------------------------------------------------

def _requiring_grad(tree):
    """The same tensors as new autograd leaves that require grad (views of
    the same memory: nothing is copied)."""
    return tree_map(lambda x: x.detach().requires_grad_(True), tree)


def _value_and_grad(loss_fn, differentiate_base: bool, span=null_span):
    """fn(adapter, base, batch) -> (loss, adapter grads) for a ``loss_fn``
    that returns one loss or per-row losses [R] (the grads of their sum:
    rows share no adapter, so each row gets its own). With
    ``differentiate_base`` the base enters as tensors that require grad, so
    autograd holds every base linear's input for a weight gradient, as a
    torch trainer does; that gradient is never asked for. A leaf the loss
    does not reach (a prefix adapter on the hybrid, which reads none) gets
    zeros, as ``jax.grad`` gives it. The loss runs in ``span("forward")``,
    ``torch.autograd.grad`` in ``span("backward")``."""

    def fn(adapter, base, batch):
        ad = _requiring_grad(adapter)
        if differentiate_base:
            base = _requiring_grad(base)
        with torch.enable_grad():
            with span("forward"):
                loss = loss_fn(ad, base, batch)
            leaves = tree_leaves(ad)
            with span("backward"):
                grads = torch.autograd.grad(loss.sum(), leaves,
                                            allow_unused=True) \
                    if loss.requires_grad else [None] * len(leaves)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        return loss.detach(), tree_unflatten(adapter, grads)

    return fn


def _accumulate(grad_fn, nmb: int, axis: int):
    """``grad_fn`` over ``nmb`` microbatches of the batch axis ``axis``: the
    mean of per-microbatch means, fp32 accumulators (the JAX ``lax.scan``).
    A factor that does not strictly divide the batch runs it whole."""
    if not nmb or nmb <= 1:
        return grad_fn

    def fn(adapter, base, batch):
        B = batch["tokens"].shape[axis]
        if B % nmb or B == nmb:
            return grad_fn(adapter, base, batch)
        n = B // nmb
        l_acc, g_acc = None, None
        for k in range(nmb):
            mb = {key: v.narrow(axis, k * n, n) for key, v in batch.items()}
            l, g = grad_fn(adapter, base, mb)
            if g_acc is None:
                l_acc = torch.zeros_like(l, dtype=torch.float32)
                g_acc = tree_map(lambda x: torch.zeros_like(
                    x, dtype=torch.float32), g)
            g_acc = tree_map(lambda a, gg: a + gg.float() / nmb, g_acc, g)
            l_acc = l_acc + l / nmb
        return l_acc, g_acc

    return fn


def make_row_grad_fn(cfg: ModelConfig, acfg: AdapterConfig, *,
                     remat: bool = True, memory_optimized: bool = True,
                     microbatch: int = 0, moe_dispatch: str = "scatter",
                     capacity_factor=None, differentiate_base: bool = False,
                     span=null_span):
    """One JOB's loss-and-grads closure: ``fn(adapter, base, batch[B, ...])
    -> (loss, adapter_grads)``; ``microbatch > 1`` accumulates grads over
    B/microbatch-sized slices (mean of per-microbatch means, fp32). The
    loss is ``lm_loss`` with the MoE layers' aux loss (``capacity_factor``
    None: drop-free, as JAX's default here); a VLM batch's ``img_embed``
    leads its text. ``differentiate_base=True`` makes the base's linears
    hold their inputs for the backward: the torch-like memory baseline of
    Fig 9/10. ``span`` is the span factory of the forward, the backward
    and the MoE body (``_value_and_grad``, ``LinearFns.span``)."""
    model = get_model(cfg)
    ctx = make_client_ctx(cfg, acfg, memory_optimized=memory_optimized,
                          span=span)

    def client_loss(adapter, base, batch):
        logits, aux = model.forward(base, batch, ctx, adapter, remat=remat,
                                    with_aux=True,
                                    capacity_factor=capacity_factor,
                                    moe_dispatch=moe_dispatch)
        return lm_loss(logits, batch["labels"], batch.get("mask"), aux)

    return _accumulate(_value_and_grad(client_loss, differentiate_base, span),
                       microbatch, axis=0)


def _make_rows_grad_fn(cfg: ModelConfig, acfg: AdapterConfig, *,
                       remat: bool, memory_optimized: bool, microbatch: int,
                       moe_dispatch: str, capacity_factor, span=null_span):
    """R bank rows at once: ``fn(params[R, ...], base, batch[R, B, ...]) ->
    (losses [R], grads [R, ...])``. One forward over the rows' R*B
    sequences, every leaf of the batch (a VLM's ``img_embed`` too)
    flattened to [R*B, ...]; each MoE layer routes each row's B sequences
    alone (``rows=R``: its own capacity, drops and aux), and each row's
    loss is ``lm_loss`` of its own logits with its own aux."""
    model = get_model(cfg)

    def rows_loss(params, base, batch):
        R, B = batch["tokens"].shape[:2]
        ctx = make_bank_ctx(cfg, acfg, R, memory_optimized=memory_optimized,
                            span=span)
        logits, aux = model.forward(
            base, {k: v.flatten(0, 1) for k, v in batch.items()}, ctx,
            adapters_lib.compact_adapter_bank(params, per_row=B),
            remat=remat, with_aux=True, capacity_factor=capacity_factor,
            moe_dispatch=moe_dispatch, rows=R)
        logits = logits.reshape((R, B) + logits.shape[1:])
        mask = batch.get("mask")
        return torch.stack([lm_loss(logits[i], batch["labels"][i],
                                    None if mask is None else mask[i], aux[i])
                            for i in range(R)])

    return _accumulate(_value_and_grad(rows_loss, not memory_optimized, span),
                       microbatch, axis=1)


def make_multi_client_train_step(cfg: ModelConfig, acfg: AdapterConfig,
                                 tcfg: TrainConfig, *,
                                 moe_dispatch: str = "scatter",
                                 capacity_factor=1.25):
    """C clients fine-tune their own adapters against the shared base, on
    one schedule (``tcfg``):

      fn(base, bank, opt, batch, step) -> (bank, opt, metrics)

    ``bank`` / ``opt`` carry a leading client axis [C] (``opt.step`` [C]),
    ``batch`` leaves are [C, B, ...] and ``step`` is the schedule position
    (an int or a scalar tensor). One merged forward and backward over the
    C*B sequences (the base products see every client's tokens), with
    ``tcfg.microbatch`` accumulation over the per-client batch axis (the
    whole batch when the factor does not strictly divide B), then each
    client's AdamW update at ``tcfg``'s values: ``adamw_update_hyper``
    with every row alike, which equals JAX's ``vmap(adamw_update)`` row by
    row. New trees are returned; the inputs are left as they were. An MoE
    model's experts take ``capacity_factor`` (JAX's default here, 1.25:
    tokens past a client's capacity drop), per client.
    ``metrics``: ``loss`` [C], ``gnorm`` [C], ``lr``."""
    rows = _make_rows_grad_fn(cfg, acfg, remat=tcfg.remat,
                              memory_optimized=tcfg.memory_optimized_backward,
                              microbatch=tcfg.microbatch,
                              moe_dispatch=moe_dispatch,
                              capacity_factor=capacity_factor)
    clip = tcfg.max_grad_norm if tcfg.max_grad_norm else float("inf")

    def train_step(base, bank, opt, batch, step):
        C = batch["tokens"].shape[0]
        dev = opt.step.device
        lr = warmup_cosine(torch.as_tensor(step, device=dev), tcfg.lr,
                           tcfg.warmup_steps, tcfg.total_steps)
        every = lambda v: torch.full((C,), v, dtype=torch.float32, device=dev)
        losses, grads = rows(bank, base, batch)
        bank, opt, gnorms = adamw_update_hyper(
            bank, grads, opt, lr.expand(C), every(tcfg.weight_decay),
            every(clip))
        return bank, opt, {"loss": losses, "gnorm": gnorms, "lr": lr}

    return train_step


def make_mixed_step(cfg: ModelConfig, acfg: AdapterConfig, tcfg: TrainConfig,
                    scfg: ServeConfig, *, moe_dispatch: str = "scatter",
                    capacity_factor=1.25):
    """Fine-tuning clients take a train step while inference clients
    decode, all against the same resident base (paper §4.4):

      fn(base, ft_bank, ft_opt, ft_batch, inf_bank, inf_caches, inf_tokens,
         step) -> (ft_bank, ft_opt, inf_caches, logits, metrics)

    ``make_multi_client_train_step`` then ``make_multi_client_decode_step``
    (a dense bank: every slot decodes one token, caches written in
    place). The live-service form is ``training.SymbiosisEngine``. The
    train half takes ``capacity_factor`` (JAX's default, 1.25) and
    ``moe_dispatch``."""
    train_step = make_multi_client_train_step(
        cfg, acfg, tcfg, moe_dispatch=moe_dispatch,
        capacity_factor=capacity_factor)
    decode_step = make_multi_client_decode_step(cfg, acfg, scfg)

    def mixed(base, ft_bank, ft_opt, ft_batch, inf_bank, inf_caches,
              inf_tokens, step):
        ft_bank, ft_opt, metrics = train_step(base, ft_bank, ft_opt, ft_batch,
                                              step)
        logits, inf_caches = decode_step(base, inf_bank, inf_caches,
                                         inf_tokens)
        return ft_bank, ft_opt, inf_caches, logits, metrics

    return mixed


def make_baseline_train_step(cfg: ModelConfig, acfg: AdapterConfig,
                             tcfg: TrainConfig, *,
                             memory_optimized: bool = False,
                             moe_dispatch: str = "scatter",
                             capacity_factor=None):
    """Dedicated single-job trainer — the oracle every FinetuneEngine job
    is compared against, and (by default, ``memory_optimized=False``) the
    torch-like memory baseline, whose base linears hold their inputs.
    ``memory_optimized=True`` runs the §3.6 client path.

      fn(base, adapter, opt, batch, step) -> (adapter, opt, metrics)"""
    row_grads = make_row_grad_fn(cfg, acfg, remat=tcfg.remat,
                                 memory_optimized=memory_optimized,
                                 microbatch=tcfg.microbatch,
                                 moe_dispatch=moe_dispatch,
                                 capacity_factor=capacity_factor,
                                 differentiate_base=not memory_optimized)

    def train_step(base, adapter, opt, batch, step):
        step = torch.as_tensor(step, device=opt.step.device)
        lr = warmup_cosine(step, tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)
        l, grads = row_grads(adapter, base, batch)
        adapter, opt, gnorm = adamw_update(adapter, grads, opt, lr,
                                           weight_decay=tcfg.weight_decay,
                                           max_grad_norm=tcfg.max_grad_norm)
        return adapter, opt, {"loss": l, "gnorm": gnorm, "lr": lr}

    return train_step


def _rows_finite(losses, grads):
    """Per-row probe: the loss AND every grad leaf finite ([R] bool)."""
    ok = torch.isfinite(losses)
    for g in tree_leaves(grads):
        ok = ok & torch.isfinite(g).flatten(1).all(dim=1)
    return ok


def _commit(full_tree, rows_tree, slots, keep):
    """Write row i of ``rows_tree`` into slot ``slots[i]`` of ``full_tree``
    IN PLACE where ``keep[i]``; other slots keep their bits. A fixed-shape
    stand-in for JAX's scatter with ``mode="drop"`` (no host sync): a
    dropped row is pointed at the first kept row (same slot, same bytes),
    and when nothing is kept every row writes back what its slot holds."""
    R = slots.shape[0]
    first = keep.long().argmax(dim=0, keepdim=True)
    src = torch.where(keep, torch.arange(R, device=keep.device), first)
    dst = slots[src]
    any_kept = keep.any()
    for full, rows in zip(tree_leaves(full_tree), tree_leaves(rows_tree)):
        val = torch.where(any_kept, rows[src].to(full.dtype), full[dst])
        full.index_copy_(0, dst, val)


def make_compact_train_step(cfg: ModelConfig, acfg: AdapterConfig, *,
                            microbatch: int = 0, remat: bool = True,
                            memory_optimized: bool = True,
                            moe_dispatch: str = "scatter",
                            capacity_factor=None, span=null_span):
    """Job-masked, slot-compacted multi-job train step — the FinetuneEngine's
    tick over ONE bank (jobs sharing an AdapterConfig, batch shape and
    microbatching, each with its OWN AdamW state, schedule position and
    data).

      fn(base, bank, opt, batch, slots, row_mask, hyper)
        -> (bank, opt, metrics)

    * ``bank`` / ``opt`` — job-stacked trees with a leading [cap] slot axis
      (``opt`` an ``AdamWState`` whose ``step`` is [cap]), updated IN PLACE
      and returned: only the gathered rows' slots are ever rewritten, so
      slots outside the call stay bit for bit untouched.
    * ``batch`` — leaves [R, B, ...]: row i is the job in slot ``slots[i]``
      with its own batch; ``row_mask`` False marks padding rows, whose
      writes are dropped.
    * ``hyper`` — per-row [R] tensors: ``step`` (the job's schedule
      position), ``lr``, ``warmup``, ``total`` (its warmup-cosine
      schedule), ``wd`` and ``gnorm`` (clip threshold; inf = no clipping).

    ``metrics["finite"]`` is the per-row probe over the loss and every grad
    leaf; a row commits only when ``row_mask & finite``, so a row whose
    step went non-finite keeps its last clean state. A one-row bucket runs
    the solo ``make_row_grad_fn`` program, as the JAX step's ``R == 1``
    branch does. ``memory_optimized=False`` runs the torch-like baseline
    (base linears hold their inputs), as ``make_baseline_train_step``
    does. An MoE model routes each row alone (``capacity_factor`` None:
    drop-free, JAX's default here), so a row's loss and grads do not depend
    on the rows beside it. ``span`` is the span factory of its parts:
    ``forward`` and ``backward`` of each microbatch, the MoE body's, and
    ``optimizer`` (schedule, clip, AdamW, finite probe and both commits);
    the shared null span by default."""
    moe_kw = dict(moe_dispatch=moe_dispatch, capacity_factor=capacity_factor,
                  span=span)
    solo = make_row_grad_fn(cfg, acfg, remat=remat,
                            memory_optimized=memory_optimized,
                            microbatch=microbatch,
                            differentiate_base=not memory_optimized, **moe_kw)
    merged = _make_rows_grad_fn(cfg, acfg, remat=remat,
                                memory_optimized=memory_optimized,
                                microbatch=microbatch, **moe_kw)

    def train_step(base, bank, opt, batch, slots, row_mask, hyper):
        slots = slots.long()
        params = tree_map(lambda x: x[slots], bank)
        ostate = tree_map(lambda x: x[slots], opt)
        if slots.shape[0] == 1:
            l1, g1 = solo(tree_map(lambda x: x[0], params), base,
                          {k: v[0] for k, v in batch.items()})
            losses, grads = l1[None], tree_map(lambda x: x[None], g1)
        else:
            losses, grads = merged(params, base, batch)
        with span("optimizer"):
            lr = warmup_cosine(hyper["step"], hyper["lr"], hyper["warmup"],
                               hyper["total"])
            new_p, new_o, gnorms = adamw_update_hyper(
                params, grads, ostate, lr, hyper["wd"], hyper["gnorm"])
            finite = _rows_finite(losses, grads)
            keep = row_mask & finite
            _commit(bank, new_p, slots, keep)
            _commit(opt, new_o, slots, keep)
        return bank, opt, {"loss": losses, "gnorm": gnorms, "lr": lr,
                           "finite": finite}

    return train_step
