"""In-place pass: a step's persistent state comes back in the same storage
(the port's counterpart of ``repro.analysis.aliasing.check_donation``).

JAX donates the page pools, caches, bank and optimizer state to its jitted
steps and proves from the compiled HLO that every donated buffer survives
as an input-output alias (a donation XLA silently drops materialises a
fresh pool-sized copy every step), and that no frozen-base parameter is
aliased. Eager PyTorch has no HLO: the port's steps write their state in
place and return it, so the pass runs the step and checks the storage
itself. Every leaf of a state argument must come back (in the step's
output, at the same path) with the ``data_ptr`` it went in with, and no
leaf of the frozen base may be written (its ``_version``, which every
in-place op bumps, unchanged).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.analysis.report import PassResult


def leaf_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in ``common.tree.tree_leaves`` order (dict keys
    sorted), paths written as ``['layers'][0]['wq']``."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in leaf_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        if hasattr(tree, "_fields"):
            return [pl for name, t in zip(tree._fields, tree)
                    for pl in leaf_paths(t, f"{prefix}.{name}")]
        return [pl for i, t in enumerate(tree)
                for pl in leaf_paths(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tensor_paths(tree) -> list[tuple[str, torch.Tensor]]:
    return [(p, t) for p, t in leaf_paths(tree) if isinstance(t, torch.Tensor)]


def check_in_place(fn: Callable, args: tuple, *, state: dict,
                   base_argnum: int = 0, target: str,
                   pass_name: str = "inplace") -> PassResult:
    """Run ``fn(*args)`` once; its state must come back in place.

    ``state`` maps each state argument's index to where the output returns
    it: an output index, or None when the output is that state itself
    (``make_page_copy``). Every tensor leaf returned there must keep the
    ``data_ptr`` the argument's leaf at the same path had before the call
    (and the tree its paths), and every frozen-base leaf its
    ``_version``."""
    res = PassResult(pass_name, target)
    before = {i: [(p, t.data_ptr()) for p, t in tensor_paths(args[i])]
              for i in state}
    base = tensor_paths(args[base_argnum])
    versions = [t._version for _, t in base]
    out = fn(*args)
    n = 0
    for i, oi in state.items():
        got = tensor_paths(out if oi is None else out[oi])
        if [p for p, _ in got] != [p for p, _ in before[i]]:
            res.add(f"argument {i}'s state came back with other leaves: "
                    f"{len(got)} against {len(before[i])} going in",
                    arg=i)
            continue
        for (path, ptr), (_, t) in zip(before[i], got):
            n += 1
            if t.data_ptr() != ptr:
                res.add(f"state leaf arg{i}{path} came back in new storage "
                        "— the step rebuilt it instead of writing it in "
                        "place (a fresh state-sized copy every step)",
                        path=f"arg{i}{path}")
    for (path, t), v in zip(base, versions):
        if t._version != v:
            res.add(f"frozen-base leaf {path} was written in place "
                    f"(_version {v} -> {t._version}) — the step overwrites "
                    "shared base weights", path=path)
    res.checked["state_leaves"] = n
    res.checked["base_leaves"] = len(base)
    return res
