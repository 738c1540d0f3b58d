"""Frozen-base and client-isolation passes (the port of
``repro.analysis.taint``).

* ``check_frozen_base`` — JAX's is a forward taint pass over the jaxpr:
  no output may be a freshly computed tensor of a base leaf's shape
  derived from the base. Eager PyTorch has no jaxpr, so the port runs the
  step and requires three things: every base leaf's ``_version`` and bits
  unchanged (a write through a kernel's raw pointer bumps no version, so
  the bits are checked too); no base leaf requiring grad or holding a
  ``.grad``; and no output a tensor with a base leaf's shape and dtype
  other than that base leaf itself (signatures an update argument shares
  are excluded, as in JAX: a LoRA leaf may share a base leaf's shape).

* ``check_client_isolation`` / ``check_row_isolation`` — differential
  probes, as in JAX: corrupt one client's adapter slice (or one train
  row's inputs), rerun the same step from a copy of the same state, and
  require every other client's logits, pages and slot rows (or every
  other row's params and optimizer state) to be bit for bit unchanged,
  torch against torch. The port's steps write their state in place, so
  each run starts from its own copy of it.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.analysis.aliasing import tensor_paths
from repro_torch.analysis.report import PassResult
from repro_torch.common.tree import tree_leaves, tree_map

_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


def leaf_sig(t: torch.Tensor) -> tuple:
    return t.dtype, tuple(t.shape)


def _digest(t: torch.Tensor) -> torch.Tensor:
    """[2] int64: the sum and the sum of squares of the leaf's bits read
    as integers (a changed element changes them), computed on its device
    without a copy of the leaf to the host."""
    x = t.detach().contiguous().reshape(-1)
    x = x.view(_INT_OF_SIZE[x.element_size()]).to(torch.int64)
    return torch.stack([x.sum(), (x * x).sum()])


def check_frozen_base(fn: Callable, args: tuple, *, base_argnum: int = 0,
                      update_argnums: tuple = (), target: str,
                      pass_name: str = "taint") -> PassResult:
    """Run ``fn(*args)`` once: the base stays frozen and no output is a
    freshly produced base-shaped tensor."""
    res = PassResult(pass_name, target)
    base = tensor_paths(args[base_argnum])
    versions = [t._version for _, t in base]
    digests = [_digest(t) for _, t in base]
    base_sigs = {leaf_sig(t) for _, t in base}
    for i in update_argnums:
        base_sigs -= {leaf_sig(t) for _, t in tensor_paths(args[i])}
    base_ptrs = {(t.data_ptr(), leaf_sig(t)) for _, t in base}
    out = fn(*args)
    res.checked["base_leaves"] = len(base)
    for (path, t), v, d in zip(base, versions, digests):
        if t._version != v or not torch.equal(_digest(t), d):
            res.add(f"frozen-base leaf {path} changed during the step — the "
                    "step writes the shared base", path=path)
        if t.requires_grad or t.grad is not None:
            res.add(f"frozen-base leaf {path} requires grad or holds a "
                    ".grad after the step — the base became trainable",
                    path=path)
    for i, (path, t) in enumerate(tensor_paths(out)):
        sig = leaf_sig(t)
        if sig in base_sigs and (t.data_ptr(), sig) not in base_ptrs:
            res.add(f"output {path} is a freshly computed base-weight-shaped "
                    f"tensor {t.dtype}{list(t.shape)} — the step produces "
                    "an updated base", output=path, dtype=str(t.dtype),
                    shape=list(t.shape))
    return res


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def _clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, tree)


def _drop(t: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """``t`` without the indices [lo, hi) on ``axis``."""
    return torch.cat([t.narrow(axis, 0, lo),
                      t.narrow(axis, hi, t.shape[axis] - hi)], dim=axis)


def check_client_isolation(fn: Callable, base, bank, caches,
                           extra_args: tuple, *, clients, victim: int,
                           pool_pages: int, page_axes, slot_axes,
                           out_row_axis: int = 0, target: str,
                           pass_name: str = "taint.isolation") -> PassResult:
    """Corrupt ``victim``'s adapter slice; other clients must be unaffected.

    ``fn(base, bank, caches, *extra_args) -> (out, new_caches)`` with
    ``out`` carrying a row axis mapped to clients by ``clients``; each run
    starts from its own copy of ``caches``. ``page_axes`` / ``slot_axes``
    are trees matching ``caches`` that give each leaf's global-pool page
    axis (client c owns pages [c*P, (c+1)*P)) or its client axis (None:
    neither), as ``core.symbiosis.cache_page_axes`` and
    ``cache_slot_axes`` give them."""
    res = PassResult(pass_name, target)
    out0, caches0 = fn(base, bank, _clone(caches), *extra_args)

    def corrupt(p):
        if isinstance(p, torch.Tensor) and p.ndim >= 1 and \
                p.shape[0] > victim:
            p = p.clone()
            p[victim] = 1e9
        return p

    out1, caches1 = fn(base, tree_map(corrupt, bank), _clone(caches),
                       *extra_args)
    clients = [int(c) for c in clients]
    other = [r for r, c in enumerate(clients) if c != victim]
    res.checked["other_rows"] = len(other)
    for r in other:
        if not _bit_equal(out0.select(out_row_axis, r),
                          out1.select(out_row_axis, r)):
            res.add(f"corrupting client {victim}'s adapter changed the "
                    f"output of row {r} (client {clients[r]}) — adapter "
                    "state leaks across clients", row=r, victim=victim)
    n = 0
    for (path, l0), l1, pa, sa in zip(
            tensor_paths(caches0), tree_leaves(caches1),
            tree_leaves(page_axes), tree_leaves(slot_axes)):
        if pa is not None:
            a0, a1 = (_drop(t, pa, victim * pool_pages,
                            (victim + 1) * pool_pages) for t in (l0, l1))
        elif sa is not None:
            a0, a1 = (_drop(t, sa, victim, victim + 1) for t in (l0, l1))
        else:
            continue
        n += 1
        if not _bit_equal(a0, a1):
            res.add(f"corrupting client {victim}'s adapter changed cache "
                    f"leaf {path} outside client {victim}'s pages/slots — "
                    "cache writes leak across clients", leaf=path,
                    victim=victim)
    res.checked["cache_leaves_checked"] = n
    return res


def check_row_isolation(step: Callable, args: tuple, *, perturb_row: int,
                        victim_slot: int, perturb_argnums: tuple,
                        state_argnums: tuple = (1, 2),
                        row_state_outs: tuple = (0, 1), target: str,
                        pass_name: str = "taint.isolation") -> PassResult:
    """Perturb one train row's inputs; other rows' state must be unaffected.

    ``step(*args)`` returns a tuple whose entries named by
    ``row_state_outs`` are trees with a leading bank-slot axis (the bank,
    the optimizer state), written in place into the arguments named by
    ``state_argnums``: each run starts from its own copy of those.
    ``perturb_argnums`` name the arguments whose ``[perturb_row]`` slice is
    corrupted (the batch, the per-row hyperparameters); ``victim_slot`` is
    the slot that row writes: every OTHER slot must come out bit for bit
    the same."""
    res = PassResult(pass_name, target)

    def run(perturb):
        def corrupt(x):
            if isinstance(x, torch.Tensor) and x.ndim >= 1 and \
                    x.shape[0] > perturb_row:
                x = x.clone()
                x[perturb_row] = 3 if not x.is_floating_point() else 1e6
            return x
        return step(*(_clone(a) if i in state_argnums
                      else tree_map(corrupt, a) if perturb and
                      i in perturb_argnums else a
                      for i, a in enumerate(args)))

    out0, out1 = run(False), run(True)
    n = 0
    for oi in row_state_outs:
        for (path, l0), l1 in zip(tensor_paths(out0[oi]),
                                  tree_leaves(out1[oi])):
            if l0.ndim < 1 or l0.shape[0] <= victim_slot:
                continue
            n += 1
            if not _bit_equal(_drop(l0, 0, victim_slot, victim_slot + 1),
                              _drop(l1, 0, victim_slot, victim_slot + 1)):
                res.add(f"perturbing train row {perturb_row}'s inputs "
                        f"changed output {oi} leaf {path} outside bank slot "
                        f"{victim_slot} — per-row fine-tuning state leaks "
                        "across jobs", output_index=oi, leaf=path)
    res.checked["row_leaves_checked"] = n
    return res
