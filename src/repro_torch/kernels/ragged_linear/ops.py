"""Public ragged-linear op: dispatch by device (see ``repro_torch.kernels``).

The TPU wrapper's padding to tiles (``repro.kernels.ragged_linear.ops``)
is tiling, not semantics: the CUDA kernel bounds-checks any shape and the
plain version slices its tiles, so neither pads.
"""
from __future__ import annotations

from repro_torch.kernels._dispatch import launches_kernel
from repro_torch.kernels.ragged_linear.ragged_linear import (
    ragged_linear_cuda, ragged_linear_plain)


def ragged_linear(buf, w, b=None, n_live=None):
    """Packed-buffer frozen linear: buf [budget, din] @ w [din, dout] (+ b),
    slots >= n_live zeroed (None = every slot live). ``n_live`` is an int
    or a 0-d integer tensor on buf's device. A CUDA tensor launches the
    CUDA kernel; a CPU tensor runs its plain version."""
    fn = ragged_linear_cuda if launches_kernel(buf) else ragged_linear_plain
    return fn(buf, w, b, n_live)
