"""VirtLayer: the client-side splice over frozen base layers (paper §3.2) —
``make_client_ctx`` (with the §3.8 privacy protocol), ``make_compact_ctx``,
``make_mixed_ctx`` and ``attach_privacy`` of ``repro.core.virtlayer``, and
``make_bank_ctx`` for the merged multi-job training batch.

A context's ``LinearFns`` run the frozen base matmul and fold in the
client's adapter on targeted paths (the LoRA delta, or the IA3 scale of
the output, or of the input for ``down``); model code is untouched. With
``memory_optimized`` (the default) the base matmul is ``frozen_dense``,
whose backward holds the weight only (§3.6); False runs the plain product,
the torch-like baseline of the Fig 9/10 comparison.

Privacy (§3.8): ``attach_privacy`` puts each layer's noise effects
(``n @ W``) into the client's adapter tree under ``_priv``, a list with one
entry per layer that the layer loop slices like the adapter's leaves; a
context built with ``privacy_noise`` runs a path's base product through
``privacy.private_dense`` wherever the layer's entry names that path.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.common.nullspan import null_span
from repro_torch.config import DENSE, MOE, VLM, AdapterConfig, ModelConfig
from repro_torch.core import adapters as adapters_lib
from repro_torch.core import privacy as privacy_lib
from repro_torch.core.frozen_linear import (frozen_dense, frozen_expert,
                                            plain_dense, plain_expert)
from repro_torch.models.blocks import LinearFns
from repro_torch.models.transformer import LinCtx

PRIV_KEY = "_priv"


def _ctx(base, hook, pre=None, core=None, span=null_span) -> LinCtx:
    """LinCtx whose layer linears run ``pre(x, path, ad_slice)`` on the
    input (IA3's ``down`` scaling), the base product (or ``core(x, w, b,
    path, ad_slice)`` in its place: the private product), then ``hook(y,
    x, path, ad_slice)`` on its output, x being the scaled input; embed
    and lm_head get the bare base. ``base`` is a (dense, expert) pair; the
    MoE experts' products run the bare base in every context: no adapter
    hook sees them (JAX's contexts do the same). ``span`` is the layers'
    span factory (``LinearFns.span``)."""
    base_dense, base_expert = base

    def expert(x, w, path):
        return base_expert(x, w)

    def for_layer(ad_slice) -> LinearFns:
        def dense(x, w, b, path):
            if pre is not None:
                x = pre(x, path, ad_slice)
            y = (base_dense(x, w, b) if core is None
                 else core(x, w, b, path, ad_slice))
            return hook(y, x, path, ad_slice)

        return LinearFns(dense=dense, expert=expert, span=span)

    return LinCtx(top=LinearFns(dense=lambda x, w, b, path: base_dense(x, w, b),
                                expert=expert, span=span),
                  for_layer=for_layer)


def _base(memory_optimized: bool = True):
    return ((frozen_dense, frozen_expert) if memory_optimized
            else (plain_dense, plain_expert))


def _private_core(base_dense, noise, variant: int):
    """The base product of a private context: a path the layer's ``_priv``
    entry names runs ``private_dense`` with the noise's and the effect's
    variant ``variant`` (the effect detached: JAX's ``stop_gradient``);
    every other product, and every layer without an entry, the plain
    base."""
    def core(x, w, b, path, ad):
        eff = ad.get(PRIV_KEY) if isinstance(ad, dict) else None
        if eff is None or path not in eff:
            return base_dense(x, w, b)
        n = privacy_lib.select_variant(noise, path, variant)
        return privacy_lib.private_dense(base_dense, x, w, b, path, n,
                                         eff[path][variant].detach())
    return core


def make_client_ctx(cfg: ModelConfig, acfg: Optional[AdapterConfig] = None,
                    *, memory_optimized: bool = True, privacy_noise=None,
                    privacy_variant: int = 0, span=null_span) -> LinCtx:
    """Context for ONE client's adapter (``for_layer`` binds its per-layer
    slice); ``acfg=None`` runs the bare base. ``privacy_noise`` (path ->
    [V, din], the client's secret) turns on §3.8 for the paths whose
    effects ``attach_privacy`` put into the adapter tree, with variant
    ``privacy_variant``. ``span``: the layers' span factory."""
    base = _base(memory_optimized)
    core = (None if privacy_noise is None
            else _private_core(base[0], privacy_noise, privacy_variant))
    if acfg is None:
        return _ctx(base, lambda y, x, path, ad: y, core=core, span=span)
    return _ctx(base,
                lambda y, x, path, ad: adapters_lib.apply_adapter(
                    y, x, path, ad, acfg, cfg),
                lambda x, path, ad: adapters_lib.pre_scale(x, path, ad, acfg,
                                                           cfg),
                core=core, span=span)


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
                  memory_optimized: bool = True, span=null_span) -> LinCtx:
    """Context for a merged multi-job training batch: ``n_rows`` bank rows'
    batches back to back on the batch axis, per-layer adapter slices
    row-stacked ([n_rows, ...]). The base linears see every row's tokens in
    one product (§3.7 batching); each row's LoRA delta or IA3 scale is
    applied by ``adapters.apply_adapter_bank``, the IA3 ``down`` input
    scale by ``adapters.pre_scale_bank``. ``span``: the layers' span
    factory."""
    return _ctx(_base(memory_optimized),
                lambda y, x, path, ad: adapters_lib.apply_adapter_bank(
                    y, x, path, ad, acfg, cfg, n_rows),
                lambda x, path, ad: adapters_lib.pre_scale_bank(
                    x, path, ad, acfg, cfg, n_rows), span=span)


def attach_privacy(adapter_tree, cfg: ModelConfig, base_params, noise,
                   container: str = "layers"):
    """A new adapter tree whose ``container`` carries each layer's noise
    effects ``n @ W`` (``privacy.noise_effect``) under ``_priv``: a list
    with one entry per layer, a dict path -> [V, dout] (views of one
    stacked [L, V, dout] tensor per path), so the layer loop slices it
    beside the adapter's leaves. The paths are those of ``noise`` among
    q, k, v, o and, where the layers have a dense MLP, gate, up and down.

    The dense, MoE and VLM families, as in JAX. JAX's tree covers its
    stacked ``layers`` only: an MoE base's first dense layers (its
    ``pre_layers``, folded into the port's ``layers``) get a ``None``
    entry and run the plain base, no noise."""
    if cfg.arch not in (DENSE, MOE, VLM):
        raise ValueError(f"attach_privacy supports the dense, MoE and VLM "
                         f"families, not {cfg.arch}")
    layers = base_params[container]
    n_pre = cfg.first_dense_layers if container == "layers" else 0
    stacked = layers[n_pre:]
    names = {"q": ("attn", "wq"), "k": ("attn", "wk"), "v": ("attn", "wv"),
             "o": ("attn", "wo")}
    if "mlp" in stacked[0]:
        names.update(gate=("mlp", "gate"), up=("mlp", "up"),
                     down=("mlp", "down"))
    weights = {p: [layer[a][b] for layer in stacked]
               for p, (a, b) in names.items() if p in noise}
    eff = privacy_lib.noise_effect(noise, weights)
    per_layer = [None] * n_pre + [{p: e[j] for p, e in eff.items()}
                                  for j in range(len(stacked))]
    out = dict(adapter_tree) if adapter_tree else {}
    out[container] = dict(out.get(container) or {}, **{PRIV_KEY: per_layer})
    return out
