"""Carry state across from the JAX package, as numpy arrays.

The JAX side hands its trees over with ``jax.tree.map(np.asarray, tree)``;
nothing here imports JAX. Layouts:

* base params: the JAX tree stacks layers on a leading [L] axis
  (``layers.attn.wq`` [L, d, H*hd], ...); the port keeps a list with one
  dict per layer. Every other leaf keeps its shape ([din, dout] linears).
* adapter banks: ``{"layers": {path: {"A": [C, L, din, r], "B": [C, L, r,
  dout]}}}`` (LoRA), ``{"layers": {path: {"scale": [C, L, n]}}}`` (IA3)
  and ``{"layers": {"prefix_k", "prefix_v": [C, L, n_prefix, K, hd]}}``
  (prefix) in both packages.
* paged bank caches: ``{"layers": {"k", "v": [L, C*P, blk, K, hd]},
  "pos": [C, B], "block_tbl": [C, B, n_blocks]}`` in both packages.
* dense bank caches (no ``block_tbl``, ``pos`` [C, B]): JAX stacks them
  client-major, ``{"layers": {"k", "v": [C, L, B, T, K, hd]}}``; the port
  keeps them layer-major, [L, C, B, T, K, hd], so that one layer's C*B
  slot rows are one contiguous slab for the dense decode-attention
  kernel. A model-level dense cache (``pos`` [B]) is [L, B, T, K, hd] in
  both. int8 caches carry their ``k_s`` / ``v_s`` scales the same way.

bfloat16 arrays (numpy's ``ml_dtypes`` bfloat16) cross as their 16-bit
patterns, so no value is rounded on the way.
"""
from __future__ import annotations

import numpy as np
import torch


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


def params_from_numpy(cfg, tree, device):
    """JAX base params (numpy leaves) -> the port's per-layer structure."""
    out = {k: _map(lambda a: tensor_from_numpy(a, device), v)
           for k, v in tree.items() if k != "layers"}
    out["layers"] = [_map(lambda a, i=i: tensor_from_numpy(a[i], device),
                          tree["layers"])
                     for i in range(cfg.n_layers)]
    return out


def params_to_numpy(params):
    """Inverse of ``params_from_numpy``: layers stacked back on [L]."""
    out = {k: _map(tensor_to_numpy, v) for k, v in params.items()
           if k != "layers"}
    per = [_map(tensor_to_numpy, layer) for layer in params["layers"]]

    def stack(*leaves):
        return np.stack(leaves)

    def zip_map(trees):
        if isinstance(trees[0], dict):
            return {k: zip_map([t[k] for t in trees]) for k in trees[0]}
        return stack(*trees)

    out["layers"] = zip_map(per)
    return out


def bank_from_numpy(acfg, tree, device):
    """Client-stacked LoRA, IA3 or prefix bank (numpy leaves) -> torch,
    same layout."""
    if acfg.method not in ("lora", "ia3", "prefix"):
        raise ValueError(f"unknown PEFT method {acfg.method!r}")
    return _map(lambda a: tensor_from_numpy(a, device), tree)


def _dense_bank(tree) -> bool:
    return (isinstance(tree, dict) and "pos" in tree
            and "block_tbl" not in tree and tree["pos"].ndim == 2)


def caches_from_numpy(tree, device):
    """JAX caches (numpy leaves) -> torch: a dense bank's KV leaves from
    [C, L, ...] to layer-major [L, C, ...] (contiguous), anything else in
    the same layout."""
    out = _map(lambda a: tensor_from_numpy(a, device), tree)
    if _dense_bank(tree):
        out["layers"] = {n: t.transpose(0, 1).contiguous()
                         for n, t in out["layers"].items()}
    return out


def caches_to_numpy(caches):
    """The port's caches -> numpy leaves in JAX's layout, for comparison
    with JAX (the inverse of ``caches_from_numpy``)."""
    out = _map(tensor_to_numpy, caches)
    if _dense_bank(caches):
        out["layers"] = {n: np.ascontiguousarray(np.swapaxes(a, 0, 1))
                         for n, a in out["layers"].items()}
    return out
