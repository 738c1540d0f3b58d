"""Frozen base linears — the forward of ``repro.core.frozen_linear``.

The JAX package wraps the frozen matmul in a custom VJP whose residual is
the weight alone (paper §3.6). The port serves inference only so far, so
it needs just the forward; the memory-optimized backward comes with
fine-tuning (as a ``torch.autograd.Function``).
"""
from __future__ import annotations


def frozen_dense(x, w, b=None):
    """x [..., din] @ w [din, dout] (+ b)."""
    y = x @ w
    return y + b if b is not None else y
