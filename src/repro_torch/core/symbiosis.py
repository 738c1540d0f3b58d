"""Symbiosis system composition — the serving half that the paged,
compacted path runs (single or mixed banks of LoRA, IA3 and prefix
clients, shared-prefix suffix prefills and the copy-on-write page copy),
and the fine-tuning half, of ``repro.core.symbiosis``.

One frozen base serves a BANK of clients. Bank caches keep per-slot leaves
with a leading client axis (``pos`` [C, B], ``block_tbl`` [C, B, n_blocks])
and ONE global page pool per KV leaf, [L, C*P, blk, K, hd]: client c owns
the page range [c*P, (c+1)*P) by allocator convention, and block tables
carry global page ids. The compacted steps gather the active (client, slot)
rows across clients into one batch, run the model once, and scatter the
per-slot results back under the row mask; the pools are written in place
through the gathered tables (the JAX steps donated the cache buffers).

Fine-tuning: ``make_row_grad_fn`` is one job's loss and adapter grads,
``make_baseline_train_step`` the dedicated single-job trainer (and, by
default, the torch-like memory baseline), and ``make_compact_train_step``
the multi-job tick of ``training.FinetuneEngine`` over one bank of jobs,
each with its own AdamW state, schedule position and data. The JAX step
``vmap``s the row program over the bank rows with the base unbatched; here
the rows' batches run as ONE forward whose base linears see every row's
tokens (§3.7 batching) while each row's LoRA delta is its own ``bmm``, and
``torch.autograd.grad`` of the sum of the per-row losses yields each row's
own grads.
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


def _row_ctx(cfg, acfg, bank, clients, locals_=None, methods=None):
    """(LinCtx, re-laid adapter tree) of one compacted batch: a single
    bank's (``acfg`` one AdapterConfig, rows named by ``clients``) or, for
    a tuple of AdapterConfigs, the mixed banks' (rows named by their bank
    ``methods`` and their ``locals_`` index within it)."""
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
            adapters_lib.compact_adapter_bank(params), remat=remat)
        logits = logits.reshape((R, B) + logits.shape[1:])
        mask = batch.get("mask")
        return torch.stack([lm_loss(logits[i], batch["labels"][i],
                                    None if mask is None else mask[i])
                            for i in range(R)])

    return _accumulate(_value_and_grad(rows_loss, not memory_optimized),
                       microbatch, axis=1)


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
