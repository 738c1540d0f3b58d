"""Carry state across from the JAX package, as numpy arrays.

The JAX side hands its trees over with ``jax.tree.map(np.asarray, tree)``;
nothing here imports JAX. Layouts:

* base params: the JAX tree stacks layers on a leading [L] axis
  (``layers.attn.wq`` [L, d, H*hd], ...); the port keeps a list with one
  dict per layer. Every other leaf keeps its shape ([din, dout] linears,
  [E, din, dout] expert stacks).
* the MoE family's first ``cfg.first_dense_layers`` layers: JAX keeps them
  apart, in a ``pre_layers`` list beside the [L - n_pre] stack, in the
  params, adapter banks and caches alike; the port puts them first on its
  one layer axis (the layer list, the banks' [L] axis, the caches' [L]
  axis — one fused page pool over all L layers, so page copies, prefix
  sharing and ``engine_state`` cover them as they stand). The ``to_numpy``
  functions split them off again when given the config.
* the hybrid family: JAX stacks its periods on a leading [G] axis
  (``groups.sub{j}.mamba.in_proj`` [G, d, 2*ED], ...); the port keeps a
  ``groups`` list with one dict of ``sub{j}`` dicts per group.
* adapter banks: ``{"layers": {path: {"A": [C, L, din, r], "B": [C, L, r,
  dout]}}}`` (LoRA), ``{"layers": {path: {"scale": [C, L, n]}}}`` (IA3)
  and ``{"layers": {"prefix_k", "prefix_v": [C, L, n_prefix, K, hd]}}``
  (prefix) in both packages; a hybrid bank has ``groups`` and [C, G, ...]
  leaves in both.
* paged bank caches: ``{"layers": {"k", "v": [L, C*P, blk, K, hd]},
  "pos": [C, B], "block_tbl": [C, B, n_blocks]}`` in both packages.
* dense bank caches (no ``block_tbl``, ``pos`` [C, B]): JAX stacks them
  client-major, ``{"layers": {"k", "v": [C, L, B, T, K, hd]}}``; the port
  keeps them layer-major, [L, C, B, T, K, hd], so that one layer's C*B
  slot rows are one contiguous slab for the dense decode-attention
  kernel. A model-level dense cache (``pos`` [B]) is [L, B, T, K, hd] in
  both. int8 caches carry their ``k_s`` / ``v_s`` scales the same way.
* hybrid caches: ``{"groups": {"sub{j}": {"k", "v"} or {"h", "conv"}},
  "pos", ("block_tbl")}``, leaves [G, ...], the same at model level in
  both packages. In a bank JAX stacks every per-slot leaf (the Mamba
  state, dense K/V rows) client-major, [C, G, B, ...]; the port puts the
  client axis after the group axis, [G, C, B, ...], as it lays out dense
  KV rows (paged pools [G, C*P, ...] alike in both).
* RWKV caches: JAX keeps its state flat, ``{"wkv" [L, B, H, hd, hd],
  "tm_x", "cm_x" [L, B, 1, d], "pos"}``; the port puts the three leaves
  under ``layers`` (``models.rwkv_model``), [L, B, ...] at model level and
  layer-major [L, C, B, ...] in a bank (JAX: client-major [C, L, B, ...]),
  as dense KV rows. RWKV params are the ``layers`` stack of any family
  (``decay`` and ``bonus`` fp32 leaves in both).
* the encoder-decoder family: JAX stacks two layer containers,
  ``enc_layers`` [L_enc, ...] and ``dec_layers`` [L, ...]; the port keeps
  two per-layer lists. Its banks are ``{"enc_layers", "dec_layers"}``
  with [C, L_enc, ...] and [C, L, ...] leaves in both packages. Its
  caches: JAX's ``{"self_k", "self_v", "cross_k", "cross_v", "pos",
  ("block_tbl")}`` are the port's ``{"layers": {"k", "v", "cross_k",
  "cross_v"}, "pos", ("block_tbl")}`` (``models.encdec``): at model level
  the same leaves ([L, ...]); in a bank the self-attention pools [L, C*P,
  ...] alike, and the per-slot leaves (the cross caches, and dense K/V
  rows) client-major [C, L, B, ...] in JAX, layer-major [L, C, B, ...] in
  the port.

bfloat16 arrays (numpy's ``ml_dtypes`` bfloat16) cross as their 16-bit
patterns, so no value is rounded on the way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.tree import tree_leaves


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:        # JAX hands over read-only buffers
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes      # numpy's bfloat16, shipped with JAX's numpy stack
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _zip(fn, trees):
    """``fn`` over the matching leaves of trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: _zip(fn, [t[k] for t in trees]) for k in trees[0]}
    return fn(*trees)


def _n_pre(cfg) -> int:
    return 0 if cfg is None else cfg.first_dense_layers


_STACKS = ("layers", "groups", "enc_layers", "dec_layers")


def params_from_numpy(cfg, tree, device):
    """JAX base params (numpy leaves) -> the port's per-layer (or, for the
    hybrid, per-group) lists, JAX's ``pre_layers`` first in ``layers``;
    an encoder-decoder's two stacks each become a list."""
    stacks = [k for k in _STACKS if k in tree]
    out = {k: _map(lambda a: tensor_from_numpy(a, device), v)
           for k, v in tree.items() if k not in stacks + ["pre_layers"]}
    for stacked in stacks:
        pre = [] if stacked != "layers" else [
            _map(lambda a: tensor_from_numpy(a, device), layer)
            for layer in tree.get("pre_layers", [])]
        n = len(tree_leaves(tree[stacked])[0])
        out[stacked] = pre + [
            _map(lambda a, i=i: tensor_from_numpy(a[i], device),
                 tree[stacked]) for i in range(n)]
    return out


def params_to_numpy(params, cfg=None):
    """Inverse of ``params_from_numpy``: the layers after ``cfg``'s
    ``first_dense_layers`` stacked back on [L], those before it in
    ``pre_layers``; a hybrid's groups on [G]; an encoder-decoder's two
    lists each on its own axis."""
    stacks = [k for k in _STACKS if k in params]
    out = {k: _map(tensor_to_numpy, v) for k, v in params.items()
           if k not in stacks}
    for stacked in stacks:
        per = [_map(tensor_to_numpy, layer) for layer in params[stacked]]
        n_pre = _n_pre(cfg) if stacked == "layers" else 0
        if n_pre:
            out["pre_layers"] = per[:n_pre]
        out[stacked] = _zip(lambda *leaves: np.stack(leaves), per[n_pre:])
    return out


def _fold_pre(tree, axis: int):
    """A JAX tree's ``pre_layers`` leaves put first on the layer ``axis``
    of its ``layers`` leaves (the pre-layer leaf lacks that axis)."""
    if "pre_layers" not in tree:
        return tree
    out = {k: v for k, v in tree.items() if k != "pre_layers"}
    out["layers"] = _zip(
        lambda full, *pre: np.concatenate(
            [np.expand_dims(np.asarray(a), axis) for a in pre]
            + [np.asarray(full)], axis=axis),
        [tree["layers"]] + list(tree["pre_layers"]))
    return out


def _split_pre(tree, axis: int, n_pre: int):
    """Inverse of ``_fold_pre`` on numpy leaves."""
    if not n_pre:
        return tree
    out = dict(tree)
    layers = tree["layers"]
    out["pre_layers"] = [_map(lambda a, i=i: np.ascontiguousarray(
        np.take(a, i, axis=axis)), layers) for i in range(n_pre)]
    out["layers"] = _map(lambda a: np.ascontiguousarray(
        np.take(a, range(n_pre, a.shape[axis]), axis=axis)), layers)
    return out


def bank_from_numpy(acfg, tree, device):
    """Client-stacked LoRA, IA3 or prefix bank (numpy leaves) -> torch,
    same layout; JAX's ``pre_layers`` go first on the [C, L, ...] leaves'
    layer axis."""
    if acfg.method not in ("lora", "ia3", "prefix"):
        raise ValueError(f"unknown PEFT method {acfg.method!r}")
    return _map(lambda a: tensor_from_numpy(a, device), _fold_pre(tree, 1))


def bank_to_numpy(tree, cfg=None):
    """Inverse of ``bank_from_numpy``: numpy leaves in JAX's layout, the
    first ``cfg.first_dense_layers`` layers split off as ``pre_layers``."""
    return _split_pre(_map(tensor_to_numpy, tree), 1, _n_pre(cfg))


_POOLS = ("k", "v", "k_s", "v_s")


def _bank_slot_leaves(fn, tree):
    """``fn`` over the per-slot leaves of a BANK cache's layer container
    (``layers`` / ``groups``): every leaf but a paged bank's pools; other
    leaves, and a model-level cache (``pos`` [B]) whole, as they are."""
    if not (isinstance(tree, dict) and "pos" in tree
            and np.ndim(tree["pos"]) == 2):
        return tree
    paged = "block_tbl" in tree

    def walk(t, name=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return t if paged and name in _POOLS else fn(t)

    return {k: walk(v) if k in ("layers", "groups") else v
            for k, v in tree.items()}


def _pre_axis(tree) -> int:
    """The layer axis of a JAX bank's per-slot leaves: 1 behind the client
    axis in a dense bank, 0 in a paged one's pools and a model cache."""
    dense_bank = (isinstance(tree, dict) and "pos" in tree
                  and "block_tbl" not in tree and np.ndim(tree["pos"]) == 2)
    return 1 if dense_bank else 0


_RWKV_STATE = ("wkv", "tm_x", "cm_x")
# JAX's encoder-decoder cache leaves -> the port's ``layers`` names
_ENCDEC_LEAVES = {"self_k": "k", "self_v": "v", "cross_k": "cross_k",
                  "cross_v": "cross_v"}


def caches_from_numpy(tree, device):
    """JAX caches (numpy leaves) -> torch: JAX's ``pre_layers`` first on
    the layer axis, an RWKV cache's flat state under ``layers``, and a
    bank's per-slot leaves (dense KV rows, a hybrid's Mamba state, the
    RWKV state) from client-major [C, L, ...] to [L, C, ...]
    (contiguous); an encoder-decoder cache's four leaves under ``layers``
    (``self_k`` / ``self_v`` as ``k`` / ``v``); anything else in the same
    layout."""
    if isinstance(tree, dict) and "wkv" in tree:
        tree = {"layers": {n: tree[n] for n in _RWKV_STATE},
                **{k: v for k, v in tree.items() if k not in _RWKV_STATE}}
    if isinstance(tree, dict) and "cross_k" in tree:
        tree = {"layers": {n: tree[j] for j, n in _ENCDEC_LEAVES.items()},
                **{k: v for k, v in tree.items() if k not in _ENCDEC_LEAVES}}
    out = _map(lambda a: tensor_from_numpy(a, device),
               _fold_pre(tree, _pre_axis(tree)))
    return _bank_slot_leaves(lambda t: t.transpose(0, 1).contiguous(), out)


def caches_to_numpy(caches, cfg=None):
    """The port's caches -> numpy leaves in JAX's layout, for comparison
    with JAX (the inverse of ``caches_from_numpy``; give ``cfg`` to split
    off an MoE model's first dense layers as ``pre_layers``)."""
    out = _bank_slot_leaves(lambda a: np.ascontiguousarray(
        np.swapaxes(a, 0, 1)), _map(tensor_to_numpy, caches))
    if "wkv" in out.get("layers", {}):
        out = {**out.pop("layers"), **out}
    if "cross_k" in out.get("layers", {}):
        layers = out.pop("layers")
        out = {**{j: layers[n] for j, n in _ENCDEC_LEAVES.items()}, **out}
    return _split_pre(out, _pre_axis(caches), _n_pre(cfg))
