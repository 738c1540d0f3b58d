"""Memory-optimized frozen base linears (paper §3.6), the port of
``repro.core.frozen_linear``.

For a frozen linear the gradient of the output with respect to the input
is the weight itself, so the backward needs no stored activation:
``dx = dy @ wᵀ`` from the resident weight. This keeps the base's memory
flat in the number of fine-tuning clients (Fig 9/10).

``frozen_dense`` is a ``torch.autograd.Function`` whose only saved tensor
is the weight (already resident: no extra memory), never ``x``, and whose
backward returns ``dx`` and no weight or bias gradient. PyTorch's own
``x @ w`` also skips saving ``x`` while ``w`` does not require grad; the
``Function`` makes the guarantee structural, whatever the caller marks as
requiring grad (the torch-like baseline marks the base, see
``core.symbiosis.make_row_grad_fn``). Where autograd records nothing
(inference, or no input requiring grad) the product runs inline.
``frozen_expert`` is the same for the MoE family's stacked experts: x [E,
C, din] @ w [E, din, dout] as one ``bmm``, ``dx = dy @ wᵀ`` per expert.
"""
from __future__ import annotations

import torch


def plain_dense(x, w, b=None):
    """x @ w (+ b), the product autograd records as it is (the torch-like
    baseline: with ``w`` requiring grad it saves ``x``)."""
    y = x @ w
    return y + b if b is not None else y


class _FrozenDense(torch.autograd.Function):
    @staticmethod
    def forward(x, w, b):
        return plain_dense(x, w, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        # residual: ONLY the weight, never the activation (paper §3.6)
        ctx.save_for_backward(inputs[1])

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        dx = g @ w.T if ctx.needs_input_grad[0] else None
        return dx, None, None


def frozen_dense(x, w, b=None):
    """x [..., din] @ w [din, dout] (+ b) with the memory-optimized
    backward (paper §3.6)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        return _FrozenDense.apply(x, w, b)
    return plain_dense(x, w, b)


def plain_expert(x, w):
    """x [E, C, din] @ w [E, din, dout] as autograd records it (the
    torch-like baseline)."""
    return torch.bmm(x, w)


class _FrozenExpert(torch.autograd.Function):
    @staticmethod
    def forward(x, w):
        return plain_expert(x, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])       # the weight only

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        dx = torch.bmm(g, w.transpose(1, 2)) if ctx.needs_input_grad[0] \
            else None
        return dx, None


def frozen_expert(x, w):
    """x [E, C, din] @ w [E, din, dout] (a frozen expert bank) with the
    memory-optimized backward (paper §3.6)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _FrozenExpert.apply(x, w)
    return plain_expert(x, w)
