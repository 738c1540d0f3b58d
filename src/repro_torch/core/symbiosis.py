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
buffers).

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
losses yields each row's own grads.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.config import (AdapterConfig, DENSE, ModelConfig,
                                ServeConfig, TrainConfig)
from repro_torch.core import adapters as adapters_lib
from repro_torch.core.virtlayer import (make_bank_ctx, make_client_ctx,
                                        make_compact_ctx, make_mixed_ctx)
from repro_torch.models import get_model
from repro_torch.models.losses import lm_loss
from repro_torch.models.transformer import default_block_table, pool_leaves
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
    per-head scales. No ``page_block`` means the dense layout."""
    kw = {}
    if scfg.page_block and cfg.arch == DENSE:
        kw["page_block"] = scfg.page_block
        if scfg.pool_pages:
            kw["pool_pages"] = scfg.pool_pages
    if scfg.kv_quant and cfg.arch == DENSE:
        kw["quant"] = True
    return kw


def init_client_caches(cfg: ModelConfig, n_clients: int, batch: int,
                       max_seq: int, dtype=None, *, window: int = 0,
                       quant: bool = False, page_block: int = 0,
                       pool_pages: int = 0, device="cuda"):
    """Bank caches: ``pos`` [C, B] per slot and either, paged, ``block_tbl``
    [C, B, n_blocks] and the GLOBAL FLAT page pools {"k","v"} [L, C*P, blk,
    K, hd], or, dense, the layer-major slot rows {"k","v"} [L, C, B, T, K,
    hd] (T = max_seq, or a ring of ``min(window, max_seq)``). With
    ``quant``: int8 {"k","v"} and f32 {"k_s","v_s"} scales [..., K, 1]."""
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    K, hd = cfg.n_kv_heads, cfg.hd
    pos = torch.zeros((n_clients, batch), dtype=torch.int32, device=dev)
    if not page_block:
        T = min(window, max_seq) if window else max_seq
        shape = (cfg.n_layers, n_clients, batch, T, K, hd)
        return {"layers": pool_leaves(shape, dtype, quant, dev), "pos": pos}
    if window:
        raise ValueError("the paged cache subsumes the ring-buffer variant "
                         "(window=)")
    _, P, tbl = default_block_table(batch, max_seq, page_block, pool_pages,
                                    dev)
    shape = (cfg.n_layers, n_clients * P, page_block, K, hd)
    return {"layers": pool_leaves(shape, dtype, quant, dev), "pos": pos,
            "block_tbl": tbl[None].repeat(n_clients, 1, 1)}


def _kv_names(cache_kw):
    return ("k", "k_s", "v", "v_s") if cache_kw.get("quant") else ("k", "v")


def cache_slot_axes(cfg: ModelConfig, max_seq: int, **cache_kw):
    """Per-leaf slot axis of ONE client's cache (``init_cache``'s tree):
    ``pos`` 0; dense KV leaves [L, B, T, ...] 1; paged pools (no slot axis:
    their writes are gated inside the model) and ``block_tbl``
    (engine-managed) None. The JAX function derives this map by building
    the cache at two batch sizes; the port knows its trees and writes it
    down, the same map on every leaf."""
    paged = bool(cache_kw.get("page_block"))
    axes = {"layers": {n: None if paged else 1
                       for n in _kv_names(cache_kw)}, "pos": 0}
    if paged:
        axes["block_tbl"] = None
    return axes


def cache_page_axes(cfg: ModelConfig, max_seq: int, **cache_kw):
    """Per-leaf page axis of ONE client's PAGED cache: pools [L, P, ...] 1,
    ``pos`` and ``block_tbl`` None (the twin of ``cache_slot_axes``)."""
    if not cache_kw.get("page_block"):
        raise ValueError("page axes exist only for paged caches")
    return {"layers": {n: 1 for n in _kv_names(cache_kw)}, "pos": None,
            "block_tbl": None}


def _slot_mask(mask, ax, ndim):
    """Reshape a [n_slots] mask to broadcast along axis ``ax`` of an
    ``ndim``-rank leaf."""
    shape = [1] * ndim
    shape[ax] = mask.shape[-1]
    return mask.reshape(shape)


def stack_client_caches(cfg: ModelConfig, max_seq: int, per_client,
                        **cache_kw):
    """Stack per-client model caches (``init_cache`` trees, e.g. after
    standalone prefills on identity tables) into the BANK layout: ``pos``
    gains a leading client axis; dense KV leaves stack layer-major, [L, C,
    B, T, ...]; paged pools fold into the one global flat pool (client c's
    pages land in [c*P, (c+1)*P)) and block tables are offset to global
    page ids. The inverse convention of ``init_client_caches``."""
    C = len(per_client)
    pos = torch.stack([pc["pos"] for pc in per_client])
    names = per_client[0]["layers"].keys()
    if not cache_kw.get("page_block"):
        return {"layers": {n: torch.stack([pc["layers"][n]
                                           for pc in per_client], dim=1)
                           for n in names}, "pos": pos}
    P = per_client[0]["layers"]["k"].shape[1]
    tbl = torch.stack([pc["block_tbl"] for pc in per_client])
    off = torch.arange(C, dtype=tbl.dtype, device=tbl.device) * P
    return {"layers": {n: torch.cat([pc["layers"][n] for pc in per_client],
                                    dim=1) for n in names},
            "pos": pos, "block_tbl": tbl + off[:, None, None]}


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
    through the paged decode kernel. The caches are updated IN PLACE and
    returned; the step never waits on the host."""
    _check_paged(cfg, scfg, "compact decode")
    model = get_model(cfg)
    acfg = tuple(acfg) if isinstance(acfg, (tuple, list)) else acfg

    def run(base, bank, caches, tokens, clients, slots, row_mask,
            locals_=None, methods=None):
        rows, cache = _gather_rows(caches, clients, slots)
        ctx, adapter = _row_ctx(cfg, acfg, bank, clients, locals_, methods)
        logits, new = model.decode_step(base, cache, tokens, ctx, adapter,
                                        active=row_mask)
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
    returned."""
    _check_paged(cfg, scfg, "compact prefill")
    if ext_blocks and scfg.kv_quant:
        raise ValueError("shared-prefix prefill (ext_blocks > 0) requires "
                         "an unquantized KV cache")
    model = get_model(cfg)
    acfg = tuple(acfg) if isinstance(acfg, (tuple, list)) else acfg

    def run(base, bank, caches, tokens, lengths, starts, clients, slots,
            row_mask, locals_=None, methods=None):
        rows, cache = _gather_rows(caches, clients, slots)
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


def _bank_rows(caches):
    """A dense bank cache as one batch of its C*B slot rows in (client,
    slot) order: [L, C, B, ...] leaves as [L, C*B, ...] views and ``pos``
    [C*B] (views: writes land in the bank cache)."""
    return {"layers": {n: t.view((t.shape[0], -1) + t.shape[3:])
                       for n, t in caches["layers"].items()},
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


def make_client_prefill(cfg: ModelConfig, acfg, scfg: ServeConfig):
    """Masked single-client prefill — the engine's per-request admission:
    the model runs ONCE over one client's ``max_b`` slot rows and only the
    admitted slots take the result.

      fn(base, bank, caches, c, a, tokens, lengths, slot_mask)
        -> (logits [max_b, V], caches)

    ``c`` is the client's index into the CACHES, ``a`` its adapter's index
    into ``bank`` (a single-bank engine passes ``a == c``), both host ints;
    ``tokens`` [max_b, S_pad] right-padded prompts on the admitted rows,
    dummies elsewhere; ``lengths`` [max_b] their true lengths (the engine
    gives other rows 0); ``slot_mask`` [max_b] bool the admitted slots.
    Dense caches: the admitted slots' rows are zeroed over all T lanes,
    as JAX's ``zero_slots`` leaves them, then the prefill writes lanes [0,
    S_pad) of those rows only. Paged caches: the pools are written only
    where lengths > 0. Other slots and clients keep their bits; ``pos``
    takes the new value on the admitted slots. LoRA goes through SGMV (one
    S_pad-token block per row), IA3 and prefix through the row hooks, every
    row the client's adapter. Caches are written IN PLACE and returned."""
    model = get_model(cfg)
    paged = "page_block" in serve_cache_kwargs(cfg, scfg)

    def prefill_one(base, bank, caches, c, a, tokens, lengths, slot_mask):
        c, a = int(c), int(a)
        rows = torch.full((tokens.shape[0],), a, dtype=torch.int32,
                          device=tokens.device)
        ctx, adapter = _row_ctx(cfg, acfg, bank, rows)
        if paged:
            cache = {"layers": caches["layers"], "pos": caches["pos"][c],
                     "block_tbl": caches["block_tbl"][c]}
            kw = {}
        else:
            cache = {"layers": {n: t[:, c] for n, t in
                                caches["layers"].items()},
                     "pos": caches["pos"][c]}
            for leaf in cache["layers"].values():       # zero_slots
                leaf.masked_fill_(_slot_mask(slot_mask, 1, leaf.ndim), 0)
            kw = {"write_rows": slot_mask}
        logits, new = model.prefill(base, {"tokens": tokens}, cache, ctx,
                                    adapter, lengths=lengths, **kw)
        caches["pos"][c] = torch.where(slot_mask, new["pos"],
                                       caches["pos"][c])
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
    paged = "page_block" in serve_cache_kwargs(cfg, scfg)
    compact = make_compact_decode_step(cfg, acfg, scfg) if paged else None

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
        rows = _bank_rows(caches)
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
    every row and ``pos`` = S. ``write_clients`` [C] bool (the port's
    in-place form of the JAX engine's merge) limits the writes to those
    clients' rows. Caches are written IN PLACE and returned."""
    _check_dense(scfg, "the multi-client prefill")
    model = get_model(cfg)

    def prefill(base, bank, caches, batch, write_clients=None):
        tokens = batch["tokens"]
        C, B, S = tokens.shape
        ctx, adapter = _row_ctx(cfg, acfg, bank,
                                _row_clients(C, B, tokens.device))
        rows = _bank_rows(caches)
        write_rows = (None if write_clients is None
                      else write_clients.repeat_interleave(B))
        logits, new = model.prefill(base, {"tokens": tokens.reshape(C * B, S)},
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


def make_page_copy(cfg: ModelConfig, scfg: ServeConfig):
    """Copy-on-write of a shared-prefix tail page:

      fn(caches, src, dst) -> caches

    page ``dst`` of every pool leaf becomes a bitwise copy of page ``src``
    across every layer: one in-place ``copy_`` per leaf between two views
    of the pool, so the pools keep their ``data_ptr`` and the host never
    waits. ``src``/``dst`` are global page ids (host ints)."""
    _check_paged(cfg, scfg, "page copy")

    def copy_page(caches, src, dst):
        for leaf in caches["layers"].values():
            leaf[:, dst].copy_(leaf[:, src])
        return caches

    return copy_page


# ---------------------------------------------------------------------------
# Fine-tuning
# ---------------------------------------------------------------------------

def _requiring_grad(tree):
    """The same tensors as new autograd leaves that require grad (views of
    the same memory: nothing is copied)."""
    return tree_map(lambda x: x.detach().requires_grad_(True), tree)


def _value_and_grad(loss_fn, differentiate_base: bool):
    """fn(adapter, base, batch) -> (loss, adapter grads) for a ``loss_fn``
    that returns one loss or per-row losses [R] (the grads of their sum:
    rows share no adapter, so each row gets its own). With
    ``differentiate_base`` the base enters as tensors that require grad, so
    autograd holds every base linear's input for a weight gradient, as a
    torch trainer does; that gradient is never asked for."""

    def fn(adapter, base, batch):
        ad = _requiring_grad(adapter)
        if differentiate_base:
            base = _requiring_grad(base)
        with torch.enable_grad():
            loss = loss_fn(ad, base, batch)
            grads = torch.autograd.grad(loss.sum(), tree_leaves(ad))
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
                     microbatch: int = 0, differentiate_base: bool = False):
    """One JOB's loss-and-grads closure: ``fn(adapter, base, batch[B, ...])
    -> (loss, adapter_grads)``; ``microbatch > 1`` accumulates grads over
    B/microbatch-sized slices (mean of per-microbatch means, fp32).
    ``differentiate_base=True`` makes the base's linears hold their inputs
    for the backward: the torch-like memory baseline of Fig 9/10."""
    model = get_model(cfg)
    ctx = make_client_ctx(cfg, acfg, memory_optimized=memory_optimized)

    def client_loss(adapter, base, batch):
        logits = model.forward(base, batch, ctx, adapter, remat=remat)
        return lm_loss(logits, batch["labels"], batch.get("mask"))

    return _accumulate(_value_and_grad(client_loss, differentiate_base),
                       microbatch, axis=0)


def _make_rows_grad_fn(cfg: ModelConfig, acfg: AdapterConfig, *,
                       remat: bool, memory_optimized: bool, microbatch: int):
    """R bank rows at once: ``fn(params[R, ...], base, batch[R, B, ...]) ->
    (losses [R], grads [R, ...])``. One forward over the rows' R*B
    sequences; each row's loss is ``lm_loss`` of its own logits."""
    model = get_model(cfg)

    def rows_loss(params, base, batch):
        R, B = batch["tokens"].shape[:2]
        ctx = make_bank_ctx(cfg, acfg, R, memory_optimized=memory_optimized)
        logits = model.forward(
            base, {"tokens": batch["tokens"].flatten(0, 1)}, ctx,
            adapters_lib.compact_adapter_bank(params, per_row=B),
            remat=remat)
        logits = logits.reshape((R, B) + logits.shape[1:])
        mask = batch.get("mask")
        return torch.stack([lm_loss(logits[i], batch["labels"][i],
                                    None if mask is None else mask[i])
                            for i in range(R)])

    return _accumulate(_value_and_grad(rows_loss, not memory_optimized),
                       microbatch, axis=1)


def make_multi_client_train_step(cfg: ModelConfig, acfg: AdapterConfig,
                                 tcfg: TrainConfig):
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
    row. New trees are returned; the inputs are left as they were.
    ``metrics``: ``loss`` [C], ``gnorm`` [C], ``lr``."""
    rows = _make_rows_grad_fn(cfg, acfg, remat=tcfg.remat,
                              memory_optimized=tcfg.memory_optimized_backward,
                              microbatch=tcfg.microbatch)
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
                    scfg: ServeConfig):
    """Fine-tuning clients take a train step while inference clients
    decode, all against the same resident base (paper §4.4):

      fn(base, ft_bank, ft_opt, ft_batch, inf_bank, inf_caches, inf_tokens,
         step) -> (ft_bank, ft_opt, inf_caches, logits, metrics)

    ``make_multi_client_train_step`` then ``make_multi_client_decode_step``
    (a dense bank: every slot decodes one token, caches written in
    place). The live-service form is ``training.SymbiosisEngine``."""
    train_step = make_multi_client_train_step(cfg, acfg, tcfg)
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
                             memory_optimized: bool = False):
    """Dedicated single-job trainer — the oracle every FinetuneEngine job
    is compared against, and (by default, ``memory_optimized=False``) the
    torch-like memory baseline, whose base linears hold their inputs.
    ``memory_optimized=True`` runs the §3.6 client path.

      fn(base, adapter, opt, batch, step) -> (adapter, opt, metrics)"""
    row_grads = make_row_grad_fn(cfg, acfg, remat=tcfg.remat,
                                 memory_optimized=memory_optimized,
                                 microbatch=tcfg.microbatch,
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
                            memory_optimized: bool = True):
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
    does."""
    solo = make_row_grad_fn(cfg, acfg, remat=remat,
                            memory_optimized=memory_optimized,
                            microbatch=microbatch,
                            differentiate_base=not memory_optimized)
    merged = _make_rows_grad_fn(cfg, acfg, remat=remat,
                                memory_optimized=memory_optimized,
                                microbatch=microbatch)

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
        lr = warmup_cosine(hyper["step"], hyper["lr"], hyper["warmup"],
                           hyper["total"])
        new_p, new_o, gnorms = adamw_update_hyper(params, grads, ostate, lr,
                                                  hyper["wd"], hyper["gnorm"])
        finite = _rows_finite(losses, grads)
        keep = row_mask & finite
        _commit(bank, new_p, slots, keep)
        _commit(opt, new_o, slots, keep)
        return bank, opt, {"loss": losses, "gnorm": gnorms, "lr": lr,
                           "finite": finite}

    return train_step
