"""Un-blocked oracle for the token-packed frozen base linear."""
from __future__ import annotations

import torch


def ragged_linear_ref(buf, w, b, n_live):
    """y = buf @ w (+ b) with rows >= n_live zeroed.

    buf [budget, din]; w [din, dout]; b [dout] or None; n_live an int or a
    0-d integer tensor. The zeroing reproduces the packed-buffer contract:
    dead slots hold garbage and must not leak into unpacked outputs."""
    y = buf.float() @ w.float()
    if b is not None:
        y = y + b.float()
    live = (torch.arange(buf.shape[0], device=buf.device) < n_live)[:, None]
    return torch.where(live, y, torch.zeros_like(y)).to(buf.dtype)
