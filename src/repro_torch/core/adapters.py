"""PEFT adapters: LoRA, IA3 and prefix tuning — ``repro.core.adapters``
for every family.

An adapter tree mirrors the model's layer container, one client's leaves
carrying a leading [L] axis: LoRA ``{"layers": {path: {"A": [L, din, r],
"B": [L, r, dout]}}}``, IA3 ``{"layers": {path: {"scale": [L, n]}}}`` (n
the output dim, the input dim for ``down``), prefix ``{"layers":
{"prefix_k", "prefix_v": [L, n_prefix, K, hd]}}``. A client BANK stacks
clients on a leading axis ([C, L, ...]) — the JAX package's layout, so
banks cross over through numpy unchanged (``convert.bank_from_numpy``).
The hybrid family's container is ``groups``, one leaf per period of
``attn_every`` sublayers ([G, ...], G = n_layers / attn_every), which
every sublayer of the group that calls the target path shares
(``models.hybrid``): ``adapter_bytes`` counts G leaves, as JAX does.
An RWKV model's targets are its own linears (``r k v g o cm_k cm_v
cm_r``, ``_rwkv_target_dims``); the conventional ``q`` names ``r``, and a
target it lacks (``down``, ``up``) resolves to nothing, as in JAX. Its
prefix leaves are built as JAX builds them and read by no layer.
An encoder-decoder model's tree has two containers, ``enc_layers``
([L_enc, ...] leaves) and ``dec_layers`` ([L, ...]), each with the dense
family's leaves (``adapter_layout``); its linears' paths are the
self-attentions' ``q k v o``, cross-attention's ``xattn_*`` and the GELU
MLP's ``fc1`` / ``fc2``, so LoRA and IA3 act on the self-attentions only,
an IA3 ``down`` leaf is carried and never read, and the prefix leaves are
read by no layer, as in JAX.

An MoE model adds the ``router`` target [d, n_experts] (its input is the
fp32 hidden state). Every layer carries the same leaves, as JAX's
``_layer_adapter`` builds them: the router leaf of a dense-FFN layer, and
the ``gate`` / ``up`` / ``down`` leaves of an MoE layer (whose shared
experts are ``shared_*`` paths and whose routed experts have no hook), are
carried and never read. JAX keeps the layers before
``cfg.first_dense_layers`` in a separate ``pre_layers`` list; the port keeps
them as the first rows of the one [L] axis, as it keeps the base layers
and the KV caches (``convert`` carries banks across), so ``compact_*`` and
``_relay`` need no second container and ``adapter_bytes`` counts the same
L layers.

Ways to apply an adapter: one client's tree (``apply_adapter`` /
``pre_scale``), a compacted serving batch whose rows name their client
(``apply_adapter_rows`` / ``pre_scale_rows``: LoRA through the SGMV kernel,
IA3 by per-row gathers), several banks of different methods in one
compacted batch (``compact_mixed_bank``, every application gated per row),
and a merged training batch of bank rows, each row B sequences
(``apply_adapter_bank`` / ``pre_scale_bank``: a LoRA ``bmm`` pair outside
any kernel, as the JAX training step computes it, or each row's IA3 scale
over its own B*S tokens; ``compact_adapter_bank`` with ``per_row=B``
hands each sequence its row's prefix). Prefix adapters act inside the
model (``transformer._prefix_attend``).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.common.tree import tree_map
from repro_torch.config import (ENCDEC, HYBRID, RWKV, AdapterConfig,
                                ModelConfig, check_family)
from repro_torch.kernels.sgmv import sgmv


def _dense_target_dims(cfg: ModelConfig) -> Dict[str, tuple]:
    hd, d = cfg.hd, cfg.d_model
    dims = {
        "q": (d, cfg.hp * hd),
        "k": (d, cfg.n_kv_heads * hd),
        "v": (d, cfg.n_kv_heads * hd),
        "o": (cfg.hp * hd, d),
        "gate": (d, cfg.d_ff),
        "up": (d, cfg.d_ff),
        "down": (cfg.d_ff, d),
    }
    if cfg.n_experts:
        dims["router"] = (d, cfg.n_experts)
    return dims


def _rwkv_target_dims(cfg: ModelConfig) -> Dict[str, tuple]:
    d = cfg.d_model
    return {"r": (d, d), "k": (d, d), "v": (d, d), "g": (d, d),
            "o": (d, d), "cm_k": (d, cfg.d_ff), "cm_v": (cfg.d_ff, d),
            "cm_r": (d, d)}


# RWKV has no q projection: the conventional q target names r
_RWKV_ALIAS = {"q": "r"}


# Default target sets per PEFT method (what the CLI hands to jobs that do
# not pick their own): LoRA on the attention block, IA3 on k/v and the FFN
# intermediate, prefix on q/v (its K/V act in the model; the targets only
# name the method's placement).
DEFAULT_TARGETS = {
    "lora": ("q", "k", "v", "o"),
    "ia3": ("k", "v", "down"),
    "prefix": ("q", "v"),
}


def adapter_layout(cfg: ModelConfig) -> tuple:
    """((container key, leaves per client), ...) of ``cfg``'s adapter
    trees: ``(("groups", G),)`` for the hybrid family, ``(("enc_layers",
    L_enc), ("dec_layers", L))`` for the encoder-decoder, ``(("layers",
    L),)`` else."""
    if cfg.arch == HYBRID:
        return (("groups", cfg.n_layers // cfg.attn_every),)
    if cfg.arch == ENCDEC:
        return (("enc_layers", cfg.n_enc_layers), ("dec_layers", cfg.n_layers))
    return (("layers", cfg.n_layers),)


def resolve_targets(cfg: ModelConfig, acfg: AdapterConfig):
    """[(path, (din, dout))] of the adapter's targets this model has (on
    RWKV, ``q`` as ``r``)."""
    check_family(cfg)
    if cfg.arch == RWKV:
        dims = _rwkv_target_dims(cfg)
        targets = [_RWKV_ALIAS.get(t, t) for t in acfg.targets]
    else:
        dims, targets = _dense_target_dims(cfg), acfg.targets
    return [(t, dims[t]) for t in targets if t in dims]


def init_adapter(cfg: ModelConfig, acfg: AdapterConfig, generator, *,
                 dtype=torch.float32, device="cuda"):
    """One client's tree, per layer: LoRA A ~ normal / sqrt(din) and B = 0
    (a fresh adapter adds nothing); IA3 scales of 1 on the output dim (the
    input dim for ``down``); prefix K/V ~ normal * 0.02, [n_prefix, K,
    hd]. The JAX package's distributions. The hybrid family's tree holds
    one leaf per group under ``groups``, the encoder-decoder's one per
    layer under ``enc_layers`` then ``dec_layers`` (``adapter_layout``)."""
    if acfg.method not in ("lora", "ia3", "prefix"):
        raise ValueError(f"unknown PEFT method {acfg.method!r}")
    return {key: _container_init(cfg, acfg, L, generator, dtype, device)
            for key, L in adapter_layout(cfg)}


def _container_init(cfg, acfg, L, generator, dtype, device):
    """One container's leaves, [L, ...] each (``init_adapter``)."""
    tree = {}
    for path, (din, dout) in resolve_targets(cfg, acfg):
        if acfg.method == "lora":
            a = torch.randn((L, din, acfg.rank), generator=generator,
                            dtype=torch.float32, device=device) / math.sqrt(din)
            tree[path] = {"A": a.to(dtype),
                          "B": torch.zeros((L, acfg.rank, dout), dtype=dtype,
                                           device=device)}
        elif acfg.method == "ia3":
            n = din if path == "down" else dout
            tree[path] = {"scale": torch.ones((L, n), dtype=dtype,
                                              device=device)}
    if acfg.method == "prefix":
        shape = (L, acfg.n_prefix, cfg.n_kv_heads, cfg.hd)
        for name in ("prefix_k", "prefix_v"):
            tree[name] = (torch.randn(shape, generator=generator,
                                      dtype=torch.float32, device=device)
                          * 0.02).to(dtype)
    return tree


def init_client_bank(cfg: ModelConfig, acfg: AdapterConfig, n_clients: int,
                     generator, *, dtype=torch.float32, device="cuda"):
    """Stack n_clients adapters along a leading client axis (one bank)."""
    per = [init_adapter(cfg, acfg, generator, dtype=dtype, device=device)
           for _ in range(n_clients)]
    return tree_map(lambda *leaves: torch.stack(leaves), *per)


def adapter_bytes(cfg: ModelConfig, acfg: AdapterConfig,
                  dtype=torch.float32) -> tuple:
    """(param_count, param_bytes) of one client's adapter in ``dtype``
    (``init_adapter``'s default fp32): what a client pins beyond the shared
    base, and what ``PlacementRouter.route_bank`` charges per client (a
    fine-tuning job's AdamW moments add 2 x param_count x 4 bytes). A
    hybrid model's adapter has one leaf per group, an encoder-decoder's one
    per layer of both stacks (``adapter_layout``)."""
    L = sum(n for _, n in adapter_layout(cfg))
    if acfg.method == "lora":
        n = sum(L * acfg.rank * (din + dout)
                for _, (din, dout) in resolve_targets(cfg, acfg))
    elif acfg.method == "ia3":
        n = sum(L * (din if path == "down" else dout)
                for path, (din, dout) in resolve_targets(cfg, acfg))
    elif acfg.method == "prefix":
        n = 2 * L * acfg.n_prefix * cfg.n_kv_heads * cfg.hd
    else:
        raise ValueError(f"unknown PEFT method {acfg.method!r}")
    return n, n * torch.empty((), dtype=dtype).element_size()


def apply_adapter(y, x, path, ad_slice, acfg: AdapterConfig, cfg: ModelConfig):
    """Post-hook for one client: given base output y = base(x), add the
    LoRA delta of ``path`` (A/B cast to the activation dtype first) or
    multiply by the IA3 scale (``down`` is scaled on its input, by
    ``pre_scale``). Prefix adapters act in the model, not here."""
    leaf = ad_slice.get(path) if isinstance(ad_slice, dict) else None
    if leaf is None:
        return y
    if acfg.method == "lora":
        # one-row ``bmm`` pair, the product ``apply_adapter_bank`` runs for
        # R rows: a job's delta has the same bits alone and in a bank (a
        # plain ``mm`` rounds differently at some shapes on the CPU)
        xr = x.reshape(1, -1, x.shape[-1])
        delta = torch.bmm(torch.bmm(xr, leaf["A"].to(x.dtype)[None]),
                          leaf["B"].to(x.dtype)[None])
        return y + (acfg.alpha / acfg.rank) * delta.reshape(y.shape)
    if acfg.method == "ia3" and path != "down":
        return y * leaf["scale"].to(y.dtype)
    return y


def pre_scale(x, path, ad_slice, acfg: AdapterConfig, cfg: ModelConfig):
    """Pre-hook for one client: IA3 scales the input of ``down``."""
    if acfg.method != "ia3" or path != "down":
        return x
    leaf = ad_slice.get(path) if isinstance(ad_slice, dict) else None
    return x if leaf is None else x * leaf["scale"].to(x.dtype)


# ---------------------------------------------------------------------------
# Compacted batches (the serving engine's prefill and decode rows)
# ---------------------------------------------------------------------------
#
# Every row may belong to a different client, so a layer's adapter slice
# arrives CLIENT-STACKED ([C, ...]) with a row -> client map. LoRA deltas go
# through the SGMV kernel; IA3 scales and prefix K/V are gathered per row.
# MIXED-method batches (several banks in one step) also pass ``rows_mask``
# [n] bool, True where the row belongs to THIS bank. Non-member rows must
# come out bitwise untouched, so every application is merged through
# ``torch.where`` (a select keeps bits; adding a zero delta would turn -0.0
# into +0.0), a non-member LoRA row gets the dead id -1 (SGMV writes exact
# zeros for it), and gather ids are clamped into the bank (a non-member
# row's local id belongs to another bank).


def _row_shape(mask, ref):
    """A [n] mask broadcast along the remaining axes of ``ref``."""
    return mask.reshape((ref.shape[0],) + (1,) * (ref.ndim - 1))


def _row_scales(leaf, rows_client, rows_mask, ref):
    """The IA3 scale of each row, shaped to multiply ``ref`` [n, ..., d]."""
    ids = rows_client.long()
    if rows_mask is not None:
        ids = ids.clamp(0, leaf["scale"].shape[0] - 1)
    s = leaf["scale"][ids]
    return s.reshape((ref.shape[0],) + (1,) * (ref.ndim - 2) + (-1,)) \
        .to(ref.dtype)


def apply_adapter_rows(y, x, path, ad_slice, acfg: AdapterConfig,
                       cfg: ModelConfig, rows_client, rows_mask=None):
    """Post-hook for a compacted batch whose rows belong to different
    clients. ``ad_slice`` leaves are client-stacked [C, ...];
    ``rows_client`` [n] int32 maps each row to its client in this bank;
    ``rows_mask`` [n] bool marks the rows this bank owns (None: all rows,
    the single-bank path). Decode rows are [n, 1, d] (one SGMV block per
    token); compacted PREFILL rows are [n, S, d] (one S-token block per
    row, all owned by that row's adapter); the MoE router's input has the
    same rows (``moe._route``). (JAX's router reads the batch flattened
    to [n*S, d], one block per TOKEN, so in its compacted and mixed
    prefill the first n tokens take the n rows' routers and the rest none;
    its per-client prefill applies each row's own, as here.) A/B are cast
    to the activation dtype before the kernel, as in JAX."""
    leaf = ad_slice.get(path) if isinstance(ad_slice, dict) else None
    if leaf is None:
        return y
    if acfg.method == "lora":
        n = x.shape[0]
        S = x.shape[1] if x.ndim == 3 else 1
        ids = rows_client if rows_mask is None else \
            torch.where(rows_mask, rows_client, -1)   # dead rows: zeros
        delta = sgmv(x.reshape(n * S, x.shape[-1]), leaf["A"].to(x.dtype),
                     leaf["B"].to(x.dtype), ids, block_t=S,
                     scale=acfg.alpha / acfg.rank)
        out = y + delta.reshape(y.shape)
    elif acfg.method == "ia3" and path != "down":
        out = y * _row_scales(leaf, rows_client, rows_mask, y)
    else:
        return y
    return out if rows_mask is None else \
        torch.where(_row_shape(rows_mask, y), out, y)


def pre_scale_rows(x, path, ad_slice, acfg: AdapterConfig, cfg: ModelConfig,
                   rows_client, rows_mask=None):
    """Compacted-batch pre-hook: IA3 scales the input of ``down`` per row
    (gated by ``rows_mask`` in mixed-method batches)."""
    if acfg.method != "ia3" or path != "down":
        return x
    leaf = ad_slice.get(path) if isinstance(ad_slice, dict) else None
    if leaf is None:
        return x
    out = x * _row_scales(leaf, rows_client, rows_mask, x)
    return out if rows_mask is None else \
        torch.where(_row_shape(rows_mask, x), out, x)


def apply_adapter_bank(y, x, path, ad_slice, acfg: AdapterConfig,
                       cfg: ModelConfig, n_rows: int):
    """Post-hook for a merged multi-job training batch: x [n_rows * B, S,
    din] holds the bank rows' batches back to back and ``ad_slice`` leaves
    are row-stacked ([n_rows, din, r] / [n_rows, r, dout], IA3 [n_rows,
    n]). The LoRA delta of every row is one ``bmm`` pair over [n_rows,
    B*S, din] (what the JAX step's ``vmap`` of ``apply_adapter``
    computes), A/B cast to the activation dtype first; an IA3 row scales
    its own B*S tokens' outputs (``down`` is scaled on its input, by
    ``pre_scale_bank``)."""
    leaf = ad_slice.get(path) if isinstance(ad_slice, dict) else None
    if leaf is None:
        return y
    if acfg.method == "lora":
        xr = x.reshape(n_rows, -1, x.shape[-1])
        delta = torch.bmm(torch.bmm(xr, leaf["A"].to(x.dtype)),
                          leaf["B"].to(x.dtype))
        return y + (acfg.alpha / acfg.rank) * delta.reshape(y.shape)
    if acfg.method == "ia3" and path != "down":
        return _bank_scaled(y, leaf, n_rows)
    return y


def _bank_scaled(t, leaf, n_rows):
    """``t`` [n_rows * B, ..., n] times each row's IA3 scale [n_rows, n]."""
    s = leaf["scale"].to(t.dtype)
    tr = t.reshape((n_rows, -1) + t.shape[1:])
    return (tr * s.reshape((n_rows,) + (1,) * (tr.ndim - 2) + (-1,))) \
        .reshape(t.shape)


def pre_scale_bank(x, path, ad_slice, acfg: AdapterConfig, cfg: ModelConfig,
                   n_rows: int):
    """Merged-batch pre-hook: each row's IA3 scale on the input of its own
    sequences' ``down`` projection."""
    if acfg.method != "ia3" or path != "down":
        return x
    leaf = ad_slice.get(path) if isinstance(ad_slice, dict) else None
    return x if leaf is None else _bank_scaled(x, leaf, n_rows)


_PREFIX_LEAVES = ("prefix_k", "prefix_v")


def _relay(container, rows, per_row: int = 1):
    """One bank's layer container for a compacted row batch: parameter
    leaves [C, L, ...] become layer-major [L, C, ...] views (no copy), so
    the model's per-layer slice is a client-stacked [C, ...] leaf applied
    per row (SGMV takes the strided client axis as is). Prefix leaves flow
    through the model (``transformer._prefix_attend``), not the linear
    hook, so they are laid out per ROW instead, [L, n, n_prefix, K, hd]:
    gathered by ``rows`` with the ids clamped into the bank (in a mixed
    batch a row of another bank carries that bank's local id), or, with
    ``rows`` None, each bank row repeated for its ``per_row`` sequences (an
    expand, whose backward sums the copies' grads by a plain reduction:
    run to run the same bits on the card, where the gather's accumulating
    backward need not be)."""
    res = {}
    for path, leaf in container.items():
        if path in _PREFIX_LEAVES and rows is None:
            n = leaf.shape[0]
            res[path] = leaf.unsqueeze(1).expand(
                (n, per_row) + leaf.shape[1:]).flatten(0, 1).transpose(0, 1)
        elif path in _PREFIX_LEAVES:
            ids = rows.long().clamp(0, leaf.shape[0] - 1)
            res[path] = leaf[ids].transpose(0, 1)
        else:
            res[path] = {m: t.transpose(0, 1) for m, t in leaf.items()}
    return res


def compact_adapter_bank(bank, rows_client=None, *, per_row: int = 1):
    """Re-lay a client-stacked bank for a compacted row batch whose rows
    name their client in ``rows_client`` [n] (needed only by prefix
    leaves, see ``_relay``). A merged training batch passes no ids and
    ``per_row=B``: bank row i owns sequences [i*B, (i+1)*B), and each of
    them takes row i's prefix. The container (``layers``, or a hybrid
    bank's ``groups``) keeps its key."""
    return {key: _relay(c, rows_client, per_row) for key, c in bank.items()}


def compact_mixed_bank(banks, rows_local, rows_method):
    """Re-lay SEVERAL banks for one compacted mixed-method row batch.

    ``banks[m]`` is bank m's client-stacked tree, ``rows_local`` [n] each
    row's index WITHIN its own bank and ``rows_method`` [n] that bank's id.
    Each bank's re-laid container nests under an ``m<id>`` key:
    ``virtlayer.make_mixed_ctx`` applies bank m's hook to exactly the rows
    whose method id is m, and a prefix bank ships its membership mask
    beside its per-row leaves (``prefix_rows`` [L, n]) so the model gates
    the prefix-attention add; every row then computes bitwise what its
    single-method run computes, whatever its neighbours' methods. (The JAX
    function, through ``_mixed_stacked`` and ``_mixed_flat``, also re-lays
    list containers, ``pre_layers``; the port's trees keep those layers on
    the [L] axis.) The banks share their container keys (``layers``, a
    hybrid model's ``groups``, or an encoder-decoder's ``enc_layers`` and
    ``dec_layers``), each re-laid alike."""
    out = {key: {} for key in banks[0]}
    for m, bank in enumerate(banks):
        for key in out:
            res = _relay(bank[key], rows_local)
            if "prefix_k" in res:
                L, n = res["prefix_k"].shape[:2]
                res["prefix_rows"] = (rows_method == m)[None].expand(L, n)
            out[key][f"m{m}"] = res
    return out
