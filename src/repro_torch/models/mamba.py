"""Mamba (S6) block of the Jamba hybrid — ``repro.models.mamba``.

Base/client split, as in JAX: ``in_proj``, ``x_proj``, ``dt_proj`` and
``out_proj`` are frozen base linears behind the ``LinearFns`` hook, under
JAX's path names; the depthwise causal conv, A, D and the selective scan
are client-side stateful ops (paper §3.2). The per-slot state is ``h``
[B, ED, N] fp32 and ``conv`` [B, K-1, ED] (the last K-1 conv inputs).

The selective scan keeps JAX's contract: time runs in chunks of
``min(chunk, S)`` steps (256 by default) and a length that is no multiple
of the chunk is refused with JAX's message, so the port serves exactly the
prompt lengths JAX serves. JAX scans each chunk with
``lax.associative_scan``; PyTorch has no public associative scan, so here
each block of ``SCAN_BLOCK`` steps runs a doubling (Hillis-Steele) scan of
JAX's combine ``(a_l * a_r, b_l * a_r + b_r)`` in fp32, the [B, ED, N]
state carried from block to block: the same recurrence, its sums in
another order, and temporaries of ``SCAN_BLOCK`` steps whatever the chunk.
The readout over N is a fixed tree of elementwise adds (``_sum_last``):
unlike a batched product (JAX's ``einsum``), its per-row result cannot
depend on how many rows the batch holds. Under autograd each block is
checkpointed, as JAX checkpoints its chunk body, so training keeps one
[B, ED, N] state per block, not the block's temporaries. Plain PyTorch
throughout: JAX computes all of this outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models.blocks import LinearFns, dense_init

# steps per doubling scan: its temporaries are [B, SCAN_BLOCK, ED, N] fp32
SCAN_BLOCK = 64


def mamba_init(gen, cfg, dtype, device):
    d = cfg.d_model
    ed = cfg.mamba_expand * d
    N = cfg.d_state
    dt_rank = max(1, d // 16)
    A = torch.arange(1, N + 1, dtype=torch.float32, device=device) \
        .repeat(ed, 1)
    conv_w = torch.randn((cfg.d_conv, ed), generator=gen,
                         dtype=torch.float32, device=device) * 0.1
    return {
        "in_proj": dense_init(gen, d, 2 * ed, dtype, device),   # -> x, z
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((ed,), dtype=dtype, device=device),
        "x_proj": dense_init(gen, ed, dt_rank + 2 * N, dtype, device),
        "dt_proj": dense_init(gen, dt_rank, ed, dtype, device),
        "dt_bias": torch.zeros((ed,), dtype=torch.float32, device=device),
        "A_log": torch.log(A),                                   # [ED, N]
        "D": torch.ones((ed,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, ed, d, dtype, device),
    }


def _sum_last(t):
    """Sum over the last axis as a fixed tree of elementwise adds (halves
    added pairwise, an odd tail carried), so each row's bits depend on its
    own values only."""
    while t.shape[-1] > 1:
        half = t.shape[-1] // 2
        s = t[..., :half] + t[..., half:2 * half]
        t = torch.cat([s, t[..., 2 * half:]], dim=-1) \
            if t.shape[-1] % 2 else s
    return t[..., 0]


def _scan_block(h, x, dt, Bc, Cc, A):
    """One block of the scan from state ``h`` [B,ED,N]: x, dt [B,c,ED] and
    Bc, Cc [B,c,N] fp32. Returns (y [B,c,ED] without the skip term, the
    last state [B,ED,N], a view of the block's states)."""
    dtc = dt[..., None]                                            # [B,c,ED,1]
    a = torch.exp(dtc * A)                                         # [B,c,ED,N]
    b = dtc * Bc[:, :, None, :] * x[..., None]                     # [B,c,ED,N]
    c, s = a.shape[1], 1
    while s < c:                    # inclusive scan: (a, b)[t] o= (a, b)[t-s]
        b = torch.cat([b[:, :s], b[:, :-s] * a[:, s:] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], dim=1)
        s *= 2
    hs = a * h[:, None] + b                                        # [B,c,ED,N]
    return _sum_last(hs * Cc[:, :, None, :]), hs[:, -1]


def _scan_block_saved(h, x, dt, Bc, Cc, A):
    """``_scan_block`` for the backward: the last state copied out of the
    block's states, so that nothing kept for the backward pins them."""
    y, h = _scan_block(h, x, dt, Bc, Cc, A)
    return y, h.clone()


def selective_scan(x, dt, Bc, Cc, A, D, h0, chunk: int = 256):
    """Selective SSM. x [B,S,ED]; dt [B,S,ED] (softplus'd); Bc, Cc [B,S,N];
    A [ED,N] (negative); D [ED]; h0 [B,ED,N]. Returns (y [B,S,ED] fp32,
    h_final [B,ED,N] fp32).

    Discretization (ZOH): a_t = exp(dt_t * A); b_t = dt_t * B_t * x_t;
    h_t = a_t * h_{t-1} + b_t; y_t = C_t . h_t + D * x_t.

    Under autograd each block runs under ``torch.utils.checkpoint`` (JAX
    checkpoints its chunk body): the backward keeps each block's inputs
    and the [B,ED,N] state carried into it, and recomputes the block's
    [B,c,ED,N] temporaries one block at a time. The values are those of
    the unrecorded scan."""
    S = x.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq {S} % chunk {chunk} != 0")
    x, dt, Bc, Cc = (t.float() for t in (x, dt, Bc, Cc))
    h = h0.float()
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, Bc, Cc, h, A))
    ys = []
    for t0 in range(0, S, SCAN_BLOCK):
        blk = slice(t0, t0 + SCAN_BLOCK)
        args = (h, x[:, blk], dt[:, blk], Bc[:, blk], Cc[:, blk], A)
        if train:
            y, h = torch.utils.checkpoint.checkpoint(
                _scan_block_saved, *args, use_reentrant=False,
                preserve_rng_state=False)
        else:
            y, h = _scan_block(*args)
        ys.append(y)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    return y + x * D, h


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv. x [B,S,ED]; w [K,ED]; conv_state [B,K-1,ED]
    or None (zeros). Returns (out [B,S,ED], new state [B,K-1,ED]) in x's
    dtype, the state the last K-1 inputs (carried ones too when S < K-1)."""
    K = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                                # [B,S+K-1,ED]
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return out + b, new_state


def mamba_forward(p, cfg, x, lin: LinearFns, state, *, path_prefix: str = "",
                  chunk: int = 256):
    """x [B,S,d]; ``state`` {"h" [B,ED,N], "conv" [B,K-1,ED]} or None
    (zeros). Returns (y [B,S,d], new state {"h" fp32, "conv" in x's
    dtype}). The gate's silu runs in fp32 and the conv output's in x's
    dtype, as in JAX. ``F.softplus`` returns its input above 20 where
    ``jax.nn.softplus`` adds log1p(exp(-x)), at most 2.1e-9 there."""
    Bsz, S, d = x.shape
    ed = cfg.mamba_expand * d
    N = cfg.d_state
    dt_rank = max(1, d // 16)
    if state is None:
        state = {"h": torch.zeros((Bsz, ed, N), dtype=torch.float32,
                                  device=x.device),
                 "conv": torch.zeros((Bsz, cfg.d_conv - 1, ed),
                                     dtype=torch.float32, device=x.device)}
    xz = lin.dense(x, p["in_proj"], None, path_prefix + "in_proj")
    xi, z = xz.chunk(2, dim=-1)                                    # [B,S,ED]
    xi, conv_state = _causal_conv(xi, p["conv_w"], p["conv_b"], state["conv"])
    xi = F.silu(xi)
    dbc = lin.dense(xi, p["x_proj"], None, path_prefix + "x_proj")
    dt, Bc, Cc = dbc.split([dt_rank, N, N], dim=-1)
    dt = lin.dense(dt, p["dt_proj"], None, path_prefix + "dt_proj")
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                                     # [ED,N] < 0
    y, h = selective_scan(xi, dt, Bc, Cc, A, p["D"], state["h"], chunk=chunk)
    y = (y * F.silu(z.float())).to(x.dtype)
    out = lin.dense(y, p["out_proj"], None, path_prefix + "out_proj")
    return out, {"h": h, "conv": conv_state}
