"""VirtLayer: the client-side splice over frozen base layers (paper §3.2) —
``make_client_ctx`` (without privacy) and ``make_compact_ctx`` of
``repro.core.virtlayer``.

A context's ``LinearFns`` run the frozen base matmul and fold in the
client's LoRA delta on targeted paths; model code is untouched.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.config import AdapterConfig, ModelConfig
from repro_torch.core import adapters as adapters_lib
from repro_torch.core.frozen_linear import frozen_dense
from repro_torch.models.blocks import LinearFns
from repro_torch.models.transformer import LinCtx

_TOP = LinearFns(dense=lambda x, w, b, path: frozen_dense(x, w, b))


def make_client_ctx(cfg: ModelConfig,
                    acfg: Optional[AdapterConfig] = None) -> LinCtx:
    """Context for ONE client's adapter (``for_layer`` binds its per-layer
    slice); ``acfg=None`` runs the bare base."""

    def for_layer(ad_slice) -> LinearFns:
        def dense(x, w, b, path):
            y = frozen_dense(x, w, b)
            if acfg is not None:
                y = adapters_lib.apply_adapter(y, x, path, ad_slice, acfg, cfg)
            return y

        return LinearFns(dense=dense)

    return LinCtx(top=_TOP, for_layer=for_layer)


def make_compact_ctx(cfg: ModelConfig, acfg: AdapterConfig,
                     rows_client) -> LinCtx:
    """Context for a COMPACTED multi-client batch: ``rows_client`` [n_rows]
    maps each row to its client, per-layer adapter slices arrive
    client-stacked ([C, ...], see ``adapters.compact_adapter_bank``) and
    LoRA deltas are applied per row through the SGMV kernel."""

    def for_layer(ad_slice) -> LinearFns:
        def dense(x, w, b, path):
            return adapters_lib.apply_adapter_rows(
                frozen_dense(x, w, b), x, path, ad_slice, acfg, cfg,
                rows_client)

        return LinearFns(dense=dense)

    return LinCtx(top=_TOP, for_layer=for_layer)
