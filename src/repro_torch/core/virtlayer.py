"""VirtLayer: the client-side splice over frozen base layers (paper §3.2) —
``make_client_ctx`` (without privacy), ``make_compact_ctx`` and
``make_mixed_ctx`` of ``repro.core.virtlayer``, and ``make_bank_ctx`` for
the merged multi-job training batch.

A context's ``LinearFns`` run the frozen base matmul and fold in the
client's adapter on targeted paths (the LoRA delta, or the IA3 scale of
the output, or of the input for ``down``); model code is untouched. With
``memory_optimized`` (the default) the base matmul is ``frozen_dense``,
whose backward holds the weight only (§3.6); False runs the plain product,
the torch-like baseline of the Fig 9/10 comparison.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.config import AdapterConfig, ModelConfig
from repro_torch.core import adapters as adapters_lib
from repro_torch.core.frozen_linear import (frozen_dense, frozen_expert,
                                            plain_dense, plain_expert)
from repro_torch.models.blocks import LinearFns
from repro_torch.models.transformer import LinCtx


def _ctx(base, hook, pre=None) -> LinCtx:
    """LinCtx whose layer linears run ``pre(x, path, ad_slice)`` on the
    input (IA3's ``down`` scaling), the base product, then ``hook(y, x,
    path, ad_slice)`` on its output, x being the scaled input; embed and
    lm_head get the bare base. ``base`` is a (dense, expert) pair; the
    MoE experts' products run the bare base in every context: no adapter
    hook sees them (JAX's contexts do the same)."""
    base_dense, base_expert = base

    def expert(x, w, path):
        return base_expert(x, w)

    def for_layer(ad_slice) -> LinearFns:
        def dense(x, w, b, path):
            if pre is not None:
                x = pre(x, path, ad_slice)
            return hook(base_dense(x, w, b), x, path, ad_slice)

        return LinearFns(dense=dense, expert=expert)

    return LinCtx(top=LinearFns(dense=lambda x, w, b, path: base_dense(x, w, b),
                                expert=expert),
                  for_layer=for_layer)


def _base(memory_optimized: bool = True):
    return ((frozen_dense, frozen_expert) if memory_optimized
            else (plain_dense, plain_expert))


def make_client_ctx(cfg: ModelConfig, acfg: Optional[AdapterConfig] = None,
                    *, memory_optimized: bool = True) -> LinCtx:
    """Context for ONE client's adapter (``for_layer`` binds its per-layer
    slice); ``acfg=None`` runs the bare base."""
    if acfg is None:
        return _ctx(_base(memory_optimized), lambda y, x, path, ad: y)
    return _ctx(_base(memory_optimized),
                lambda y, x, path, ad: adapters_lib.apply_adapter(
                    y, x, path, ad, acfg, cfg),
                lambda x, path, ad: adapters_lib.pre_scale(x, path, ad, acfg,
                                                           cfg))


def make_compact_ctx(cfg: ModelConfig, acfg: AdapterConfig,
                     rows_client) -> LinCtx:
    """Context for a COMPACTED multi-client batch: ``rows_client`` [n_rows]
    maps each row to its client, per-layer adapter slices arrive
    client-stacked ([C, ...], see ``adapters.compact_adapter_bank``);
    LoRA deltas are applied per row through the SGMV kernel, IA3 scales
    per row."""
    return _ctx(_base(),
                lambda y, x, path, ad: adapters_lib.apply_adapter_rows(
                    y, x, path, ad, acfg, cfg, rows_client),
                lambda x, path, ad: adapters_lib.pre_scale_rows(
                    x, path, ad, acfg, cfg, rows_client))


def make_mixed_ctx(cfg: ModelConfig, acfgs, rows_local,
                   rows_method) -> LinCtx:
    """Context for a MIXED-METHOD compacted batch: the serving engine's
    banks (LoRA of any rank, IA3, prefix) in one step. ``acfgs`` is the
    bank tuple (method id = position), ``rows_local`` [n_rows] each row's
    client index WITHIN its bank, ``rows_method`` [n_rows] its bank id;
    per-layer adapter slices arrive as ``{"m<id>": <bank slice>}`` (see
    ``adapters.compact_mixed_bank``). Every bank's hook runs over the whole
    batch GATED per row: LoRA rows of other banks get dead SGMV ids, IA3
    scales are gathered with clamped ids, and every application merges
    through ``torch.where`` on the bank's membership mask, so each row is
    bitwise what its single-method run computes."""
    banks = [(f"m{m}", acfg, rows_method == m) for m, acfg in enumerate(acfgs)]

    def sub(ad, key):
        return ad.get(key) if isinstance(ad, dict) else None

    def pre(x, path, ad):
        for key, acfg, mask in banks:
            x = adapters_lib.pre_scale_rows(x, path, sub(ad, key), acfg, cfg,
                                            rows_local, rows_mask=mask)
        return x

    def hook(y, x, path, ad):
        for key, acfg, mask in banks:
            y = adapters_lib.apply_adapter_rows(y, x, path, sub(ad, key),
                                                acfg, cfg, rows_local,
                                                rows_mask=mask)
        return y

    return _ctx(_base(), hook, pre)


def make_bank_ctx(cfg: ModelConfig, acfg: AdapterConfig, n_rows: int, *,
                  memory_optimized: bool = True) -> LinCtx:
    """Context for a merged multi-job training batch: ``n_rows`` bank rows'
    batches back to back on the batch axis, per-layer adapter slices
    row-stacked ([n_rows, ...]). The base linears see every row's tokens in
    one product (§3.7 batching); each row's LoRA delta or IA3 scale is
    applied by ``adapters.apply_adapter_bank``, the IA3 ``down`` input
    scale by ``adapters.pre_scale_bank``."""
    return _ctx(_base(memory_optimized),
                lambda y, x, path, ad: adapters_lib.apply_adapter_bank(
                    y, x, path, ad, acfg, cfg, n_rows),
                lambda x, path, ad: adapters_lib.pre_scale_bank(
                    x, path, ad, acfg, cfg, n_rows))
