"""LoRA adapters — the LoRA branch of ``repro.core.adapters``.

An adapter tree mirrors the model's layer container: ``{"layers": {path:
{"A": [L, din, r], "B": [L, r, dout]}}}`` for one client; a client BANK
stacks clients on a leading axis, ``{"layers": {path: {"A": [C, L, din, r],
"B": [C, L, r, dout]}}}`` — the JAX package's layout, so banks cross over
through numpy unchanged (``convert.bank_from_numpy``).

Three ways to apply a delta: one client's tree (``apply_adapter``), a
compacted serving batch whose rows name their client (``apply_adapter_rows``,
through the SGMV kernel), and a merged training batch of bank rows
(``apply_adapter_bank``, a ``bmm`` pair outside any kernel, as the JAX
training step computes it).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.config import AdapterConfig, DENSE, ModelConfig
from repro_torch.kernels.sgmv import sgmv


def _dense_target_dims(cfg: ModelConfig) -> Dict[str, tuple]:
    hd, d = cfg.hd, cfg.d_model
    return {
        "q": (d, cfg.hp * hd),
        "k": (d, cfg.n_kv_heads * hd),
        "v": (d, cfg.n_kv_heads * hd),
        "o": (cfg.hp * hd, d),
        "gate": (d, cfg.d_ff),
        "up": (d, cfg.d_ff),
        "down": (cfg.d_ff, d),
    }


def resolve_targets(cfg: ModelConfig, acfg: AdapterConfig):
    """[(path, (din, dout))] of the adapter's targets this model has."""
    if cfg.arch != DENSE:
        raise ValueError(f"the port's adapters serve the dense family; "
                         f"{cfg.name} is {cfg.arch!r}")
    dims = _dense_target_dims(cfg)
    return [(t, dims[t]) for t in acfg.targets if t in dims]


def _check_lora(acfg: AdapterConfig):
    if acfg.method != "lora":
        raise ValueError(f"the port serves LoRA adapters; {acfg.method!r} "
                         "is not ported yet")


def init_adapter(cfg: ModelConfig, acfg: AdapterConfig, generator, *,
                 dtype=torch.float32, device="cuda"):
    """One client's LoRA tree: A ~ normal / sqrt(din), B = 0 (a fresh
    adapter adds nothing), per layer."""
    _check_lora(acfg)
    L = cfg.n_layers
    tree = {}
    for path, (din, dout) in resolve_targets(cfg, acfg):
        a = torch.randn((L, din, acfg.rank), generator=generator,
                        dtype=torch.float32, device=device) / math.sqrt(din)
        tree[path] = {"A": a.to(dtype),
                      "B": torch.zeros((L, acfg.rank, dout), dtype=dtype,
                                       device=device)}
    return {"layers": tree}


def init_client_bank(cfg: ModelConfig, acfg: AdapterConfig, n_clients: int,
                     generator, *, dtype=torch.float32, device="cuda"):
    """Stack n_clients adapters along a leading client axis (one bank)."""
    per = [init_adapter(cfg, acfg, generator, dtype=dtype, device=device)
           for _ in range(n_clients)]
    return {"layers": {path: {m: torch.stack([c["layers"][path][m]
                                              for c in per])
                              for m in ("A", "B")}
                       for path in per[0]["layers"]}}


def adapter_bytes(cfg: ModelConfig, acfg: AdapterConfig,
                  dtype=torch.float32) -> tuple:
    """(param_count, param_bytes) of one client's adapter in ``dtype``
    (``init_adapter``'s default fp32): what a fine-tuning job pins beyond
    the shared base (the AdamW moments add 2 x param_count x 4 bytes)."""
    _check_lora(acfg)
    n = sum(cfg.n_layers * acfg.rank * (din + dout)
            for _, (din, dout) in resolve_targets(cfg, acfg))
    return n, n * torch.empty((), dtype=dtype).element_size()


def apply_adapter(y, x, path, ad_slice, acfg: AdapterConfig, cfg: ModelConfig):
    """Post-hook for one client: given base output y = base(x), add the
    LoRA delta of ``path`` (A/B cast to the activation dtype first)."""
    leaf = ad_slice.get(path) if isinstance(ad_slice, dict) else None
    if leaf is None:
        return y
    _check_lora(acfg)
    delta = (x @ leaf["A"].to(x.dtype)) @ leaf["B"].to(x.dtype)
    return y + (acfg.alpha / acfg.rank) * delta


def apply_adapter_rows(y, x, path, ad_slice, acfg: AdapterConfig,
                       cfg: ModelConfig, rows_client):
    """Post-hook for a compacted batch whose rows belong to different
    clients. ``ad_slice`` leaves are client-stacked [C, ...];
    ``rows_client`` [n] int32 maps each row to its client. Decode rows are
    [n, 1, d] (one SGMV block per token); compacted PREFILL rows are
    [n, S, d] (one S-token block per row, all owned by that row's adapter).
    A/B are cast to the activation dtype before the kernel, as in JAX."""
    leaf = ad_slice.get(path) if isinstance(ad_slice, dict) else None
    if leaf is None:
        return y
    _check_lora(acfg)
    n = x.shape[0]
    S = x.shape[1] if x.ndim == 3 else 1
    delta = sgmv(x.reshape(n * S, x.shape[-1]), leaf["A"].to(x.dtype),
                 leaf["B"].to(x.dtype), rows_client, block_t=S,
                 scale=acfg.alpha / acfg.rank)
    return y + delta.reshape(y.shape)


def apply_adapter_bank(y, x, path, ad_slice, acfg: AdapterConfig,
                       cfg: ModelConfig, n_rows: int):
    """Post-hook for a merged multi-job training batch: x [n_rows * B, S,
    din] holds the bank rows' batches back to back and ``ad_slice`` leaves
    are row-stacked ([n_rows, din, r] / [n_rows, r, dout]). The LoRA delta
    of every row is one ``bmm`` pair over [n_rows, B*S, din] (what the JAX
    step's ``vmap`` of ``apply_adapter`` computes), A/B cast to the
    activation dtype first."""
    leaf = ad_slice.get(path) if isinstance(ad_slice, dict) else None
    if leaf is None:
        return y
    _check_lora(acfg)
    xr = x.reshape(n_rows, -1, x.shape[-1])
    delta = torch.bmm(torch.bmm(xr, leaf["A"].to(x.dtype)),
                      leaf["B"].to(x.dtype))
    return y + (acfg.alpha / acfg.rank) * delta.reshape(y.shape)


def compact_adapter_bank(bank):
    """Re-lay a client-stacked bank for a compacted row batch: leaves
    [C, L, ...] become layer-major [L, C, ...] views (no copy), so the
    model's per-layer slice is a client-stacked [C, ...] leaf applied per
    row by ``apply_adapter_rows`` (SGMV takes the strided client axis as
    is). LoRA leaves need no per-row gather, so unlike the JAX function
    this one takes no row map."""
    return {"layers": {path: {m: t.transpose(0, 1) for m, t in leaf.items()}
                       for path, leaf in bank["layers"].items()}}
