"""AdamW (``repro.optim.adamw``): the fine-tuning client's optimizer.

Optimizer state is client-side runtime state: a multi-job bank stacks every
state leaf on a leading row axis, and ``adamw_update_hyper`` updates the
stacked rows at once, each with its own learning rate, weight decay and
clip threshold. All moments are fp32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32: [] for one job, [R] for stacked rows
    m: object
    v: object


def adamw_init(params) -> AdamWState:
    zeros = lambda t: tree_map(
        lambda x: torch.zeros_like(x, dtype=torch.float32), t)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros(params), v=zeros(params))


def _global_norm(leaves):
    """sqrt of the sum of squares of ``leaves``, leaf by leaf in order, in
    fp32. The stacked form calls this on each row's slices, so a row's norm
    is the one job's norm bit for bit."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


def _clip_scale(max_norm, norm):
    # a tensor quotient: a number over a tensor would be computed as a
    # reciprocal times the number, not as the stacked form's division
    max_norm = torch.as_tensor(max_norm, dtype=torch.float32,
                               device=norm.device)
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    norm = _global_norm(tree_leaves(grads))
    scale = _clip_scale(max_norm, norm)
    return tree_map(lambda g: g * scale, grads), norm


def _update(p, g, m, v, lr, bc1, bc2, b1, b2, eps, weight_decay):
    g32 = g.float()
    m = b1 * m + (1 - b1) * g32
    v = b2 * v + (1 - b2) * g32 * g32
    u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if weight_decay is not None:
        u = u + weight_decay * p.float()
    return (p.float() - lr * u).to(p.dtype), m, v


def _apply(params, grads, state, step, lr, bc1, bc2, wd, b1, b2, eps,
           rows=lambda x, leaf: x):
    """Update every leaf; ``rows`` lays a per-row value out against a
    stacked leaf (identity for one job)."""
    out = [_update(p, g, m, v, rows(lr, p), rows(bc1, p), rows(bc2, p), b1,
                   b2, eps, None if wd is None else rows(wd, p))
           for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                                 tree_leaves(state.m), tree_leaves(state.v))]
    return (tree_unflatten(params, [o[0] for o in out]),
            AdamWState(step=step,
                       m=tree_unflatten(state.m, [o[1] for o in out]),
                       v=tree_unflatten(state.v, [o[2] for o in out])))


def adamw_update(params, grads, state: AdamWState, lr, *, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.0, max_grad_norm=0.0):
    """One job's update. ``max_grad_norm`` 0 means no clipping; the norm is
    returned either way."""
    if max_grad_norm:
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    else:
        gnorm = _global_norm(tree_leaves(grads))
    step = state.step + 1
    t = step.float()
    new_p, new_s = _apply(params, grads, state, step, lr, 1.0 - b1 ** t,
                          1.0 - b2 ** t, weight_decay if weight_decay else None,
                          b1, b2, eps)
    return new_p, new_s, gnorm


def adamw_update_hyper(params, grads, state: AdamWState, lr, weight_decay,
                       max_grad_norm, *, b1=0.9, b2=0.999, eps=1e-8):
    """``adamw_update`` over R stacked rows with PER-ROW hyperparameters:
    every leaf of ``params``/``grads``/``state`` carries a leading [R] axis,
    ``state.step`` is [R], and ``lr``, ``weight_decay`` and
    ``max_grad_norm`` are [R] fp32 tensors (the JAX function's ``vmap``
    over bank rows, written out). Returns (params, state, gnorm [R]).

    Each row equals ``adamw_update`` of that row alone bit for bit at every
    setting: the clip scale and the decay term are applied unconditionally,
    with "no clip" as ``max_grad_norm = inf`` (the scale is exactly 1.0)
    and "no decay" as ``weight_decay = 0.0`` (``u + 0.0 * p == u``); each
    row's norm and bias corrections are computed on that row alone by the
    code the one-job form runs, and everything else is elementwise."""
    leaves = tree_leaves(grads)
    R = leaves[0].shape[0]
    gnorm = torch.stack([_global_norm([g[i] for g in leaves])
                         for i in range(R)])
    step = state.step + 1
    t = [step[i].float() for i in range(R)]
    bc1 = torch.stack([1.0 - b1 ** ti for ti in t])
    bc2 = torch.stack([1.0 - b2 ** ti for ti in t])
    scale = _clip_scale(max_grad_norm, gnorm)

    def rows(x, leaf):          # [R] -> [R, 1, ...] against a stacked leaf
        return x.reshape((R,) + (1,) * (leaf.ndim - 1))

    grads = tree_map(lambda g: g * rows(scale, g), grads)
    new_p, new_s = _apply(params, grads, state, step, lr, bc1, bc2,
                          weight_decay, b1, b2, eps, rows)
    return new_p, new_s, gnorm
