"""Pool-copy and MoE-recompute audits of one eager step: the port's
counterparts of ``repro.analysis.jaxpr_passes`` (``check_pool_copies`` and
``check_moe_checkpointed``), which walk a jaxpr.

* ``check_pool_copies`` runs the step under a ``TorchDispatchMode`` that
  sees every op the step runs (its plain versions on the CPU; on the card,
  the kernels' wrappers allocate their outputs through torch ops the mode
  sees too). An op that reads a protected pool (or a view of it) and
  produces a tensor of at least a protected pool's bytes in fresh storage
  materialises a pool-sized copy on the hot path. In-place writes into a
  pool and views of it share its storage and pass, as JAX's scatter /
  dynamic-update-slice and bitcast forms do. (JAX matches exact pool
  signatures; bytes and the pool's storage are what eager PyTorch sees: a
  large activation computed from other tensors is not a pool copy.)
* ``check_moe_checkpointed`` runs a training forward under
  ``torch.autograd.graph.saved_tensors_hooks``: while an MoE body runs
  (``models.moe.moe_forward``), the tensors autograd saves for the
  backward may be its input only. A recomputed body (``torch.utils.
  checkpoint``) saves its input and nothing else (JAX: every ``top_k`` under
  a ``remat``); a body run plainly saves its routing and expert
  activations. This is the rule the fine-tuning charge counts on (MoE
  bodies count as their input plus one recomputed body).
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.report import PassResult


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _PoolAudit(TorchDispatchMode):
    def __init__(self, pools: set, threshold: int):
        super().__init__()
        self.pools = pools
        self.threshold = threshold
        self.n_ops = 0
        self.n_inplace = 0
        self.hits: list[tuple[str, torch.dtype, tuple]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        ins = {_storage(t) for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)}
        if not ins & self.pools:
            return out
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or \
                    t.untyped_storage().nbytes() < self.threshold:
                continue
            if _storage(t) in ins:
                self.n_inplace += func._schema.is_mutable
            else:
                self.hits.append((str(func), t.dtype, tuple(t.shape)))
        return out


def check_pool_copies(fn: Callable, args: tuple, protected, *, target: str,
                      pass_name: str = "poolcopy") -> PassResult:
    """Run ``fn(*args)`` once; no op that reads a ``protected`` leaf may
    produce a tensor of at least the smallest protected leaf's bytes in
    storage none of its inputs holds."""
    res = PassResult(pass_name, target)
    threshold = min(t.untyped_storage().nbytes() for t in protected)
    res.checked["protected_leaves"] = len(protected)
    res.checked["threshold_bytes"] = threshold
    audit = _PoolAudit({_storage(t) for t in protected}, threshold)
    with audit:
        fn(*args)
    for op, dtype, shape in audit.hits:
        res.add(f"op '{op}' materializes a pool-sized tensor "
                f"{dtype}{list(shape)} in fresh storage, outside in-place "
                "writes into the pool", op=op, shape=list(shape))
    res.checked["ops"] = audit.n_ops
    res.checked["inplace_writes"] = audit.n_inplace
    return res


@contextlib.contextmanager
def _watch_moe(enter: Callable, leave: Callable):
    """Call ``enter(x)`` as each MoE body starts on its input ``x`` and
    ``leave()`` as it ends."""
    from repro_torch.models import moe as moe_lib
    orig = moe_lib.moe_forward

    def watched(params, cfg, x, *a, **kw):
        enter(x)
        try:
            return orig(params, cfg, x, *a, **kw)
        finally:
            leave()

    moe_lib.moe_forward = watched
    try:
        yield
    finally:
        moe_lib.moe_forward = orig


def check_moe_checkpointed(fn: Callable, args: tuple, *, target: str,
                           pass_name: str = "poolcopy.moe_remat"
                           ) -> PassResult:
    """Run a training step ``fn(*args)`` once: every tensor an MoE body
    saves for the backward must be that body's input."""
    res = PassResult(pass_name, target)
    bodies, open_ = [], []          # (input, [saved tensors]) per body

    def pack(t):
        if open_:
            open_[-1][1].append(t)
        return t

    with _watch_moe(lambda x: open_.append((x, [])),
                    lambda: bodies.append(open_.pop())), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*args)
    res.checked["moe_bodies"] = len(bodies)
    n_saved = 0
    for i, (x, saved) in enumerate(bodies):
        for t in saved:
            n_saved += 1
            if _storage(t) != _storage(x):
                res.add(f"MoE body {i} saves a {t.dtype}{list(t.shape)} "
                        "tensor that is not its input for the backward — the "
                        "route/dispatch/combine body keeps expert-sized "
                        "activations instead of being recomputed",
                        body=i, shape=list(t.shape))
    res.checked["saved_in_bodies"] = n_saved
    return res
