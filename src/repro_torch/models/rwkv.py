"""RWKV6 ("Finch") blocks — ``repro.models.rwkv``: attention-free linear
attention with a data-dependent decay.

Base/client split, as in JAX: every projection (``r k v g o`` of the time
mix, ``cm_k cm_v cm_r`` of the channel mix) is a frozen base linear behind
the ``LinearFns`` hook, under JAX's path names; the token shift, the
data-dependent decay (the small ``w1`` / ``w2`` products, plain fp32
matmuls as in JAX) and the wkv recurrence are client-side ops. Dtypes are
JAX's: ``decay`` and ``bonus`` are fp32 leaves in any model, the decay
``w`` is rounded to the activation dtype before the recurrence, which runs
in fp32, and the per-head norm is fp32 before the cast and the ``silu(g)``
gate.

The recurrence keeps JAX's chunk contract: time runs in chunks of
``min(chunk, S)`` steps (128 by default) and a length that is no multiple
of the chunk is refused with JAX's message. JAX scans each chunk token by
token (``lax.scan``); here each block of ``WKV_BLOCK`` steps runs a
doubling (Hillis-Steele) scan of the pair (w_t, k_tᵀv_t) composed as
``(a2 * a1, a2 * b1 + b2)`` in fp32, the state carried from block to
block: the same recurrence, its sums in another order, every op
elementwise. The readout ``r_t (S_{t-1} + diag(bonus) k_tᵀv_t)`` sums over
dk with a fixed add tree (``mamba._sum_last``), so each row's bits depend
on its own values only. The state is held transposed inside the scan,
[B, H, dv, dk], so that dk is the last axis of every product. Under
autograd each block is checkpointed, as JAX checkpoints its chunk body:
training keeps each block's inputs and carried state, not its
[B, c, H, dk, dv] temporaries. Plain PyTorch throughout: JAX computes all
of this outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models.blocks import LinearFns, dense_init
from repro_torch.models.mamba import _sum_last

# steps per doubling scan: its temporaries are [B, WKV_BLOCK, H, dk, dv] fp32
WKV_BLOCK = 64


def rwkv_init(gen, cfg, dtype, device):
    """One layer's time-mix and channel-mix params, JAX's distributions:
    mix coefficients 0.5, ``decay`` and ``bonus`` zero in fp32, ``ln_x``
    ones, the linears ``dense_init``."""
    d = cfg.d_model
    H = d // cfg.hd

    def half():
        return torch.full((d,), 0.5, dtype=dtype, device=device)

    def lin(din, dout):
        return dense_init(gen, din, dout, dtype, device)

    tm = {"mix_r": half(), "mix_k": half(), "mix_v": half(),
          "mix_g": half(), "mix_w": half(),
          "decay": torch.zeros((d,), dtype=torch.float32, device=device),
          "w1": lin(d, 64), "w2": lin(64, d),
          "bonus": torch.zeros((H, cfg.hd), dtype=torch.float32,
                               device=device),
          "wr": lin(d, d), "wk": lin(d, d), "wv": lin(d, d), "wg": lin(d, d),
          "wo": lin(d, d),
          "ln_x": torch.ones((d,), dtype=dtype, device=device)}
    cm = {"mix_k": half(), "mix_r": half(),
          "wk": lin(d, cfg.d_ff), "wv": lin(cfg.d_ff, d), "wr": lin(d, d)}
    return {"time_mix": tm, "channel_mix": cm}


def _shift(x, last):
    """Token shift: ``last`` [B,1,d] (None: zeros) then x without its final
    step."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


def _mix(x, xs, m):
    return x * m + xs * (1.0 - m)


def _wkv_block(st, r, k, v, w, bonus):
    """One block of the recurrence from the transposed state ``st``
    [B,H,dv,dk]: r, k, w [B,c,H,dk] and v [B,c,H,dv] fp32, ``bonus``
    [H,dk]. Returns (out [B,c,H,dv], the last state [B,H,dv,dk]).

    The readout splits as r_t S_{t-1} + (r_t . (bonus * k_t)) v_t, so the
    bonus term costs [B,c,H,dk] work, not a pass over the states; each
    doubling round is one fused multiply-add and a copy."""
    kv = v[..., :, None] * k[..., None, :]                      # [B,c,H,dv,dk]
    a, b = w, kv
    c, s = w.shape[1], 1
    while s < c:                    # inclusive scan: (a, b)[t] o= (a, b)[t-s]
        b = torch.cat([b[:, :s], torch.addcmul(
            b[:, s:], b[:, :-s], a[:, s:, :, None, :])], dim=1)
        a = torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], dim=1)
        s *= 2
    hs = torch.addcmul(b, a[:, :, :, None, :], st[:, None])     # S_t
    prev = torch.cat([st[:, None], hs[:, :-1]], dim=1) if c > 1 \
        else st[:, None]                                         # S_{t-1}
    out = _sum_last(r[:, :, :, None, :] * prev) \
        + _sum_last(r * bonus * k)[..., None] * v
    return out, hs[:, -1]


def _wkv_block_saved(st, r, k, v, w, bonus):
    """``_wkv_block`` for the backward: the last state copied out of the
    block's states, so that nothing kept for the backward pins them."""
    out, st = _wkv_block(st, r, k, v, w, bonus)
    return out, st.clone()


def wkv6_scan(r, k, v, w, bonus, state, chunk: int = 128):
    """The wkv6 recurrence. r, k [B,S,H,dk]; v [B,S,H,dv]; w [B,S,H,dk]
    (decay in (0, 1), rounded to r's dtype first, as JAX); bonus [H,dk];
    state [B,H,dk,dv]. Returns (out [B,S,H,dv] fp32, state' [B,H,dk,dv]
    fp32):

      S_t = diag(w_t) S_{t-1} + k_tᵀ v_t
      o_t = r_t (S_{t-1} + diag(bonus) k_tᵀ v_t)

    Under autograd (grad enabled and an input requiring grad) each block
    runs under ``torch.utils.checkpoint``: the backward keeps each block's
    inputs and the state carried into it, and recomputes its temporaries
    one block at a time. The values are those of the unrecorded scan."""
    S = r.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq {S} % chunk {chunk} != 0")
    w = w.to(r.dtype)
    r, k, v, w = (t.float() for t in (r, k, v, w))
    st = state.float().transpose(-1, -2)
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, w, bonus, st))
    outs = []
    for t0 in range(0, S, WKV_BLOCK):
        blk = slice(t0, t0 + WKV_BLOCK)
        args = (st, r[:, blk], k[:, blk], v[:, blk], w[:, blk], bonus)
        if train:
            out, st = torch.utils.checkpoint.checkpoint(
                _wkv_block_saved, *args, use_reentrant=False,
                preserve_rng_state=False)
        else:
            out, st = _wkv_block(*args)
        outs.append(out)
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out, st.transpose(-1, -2)


def time_mix(p, cfg, x, lin: LinearFns, state, last_x, *, path_prefix=""):
    """RWKV6 time mix. x [B,S,d]; state [B,H,dk,dv] fp32; last_x [B,1,d] or
    None (zeros). Returns (y [B,S,d], state', x[:, -1:])."""
    B, S, d = x.shape
    hd = cfg.hd
    H = d // hd
    xs = _shift(x, last_x)
    xr, xk, xv, xg, xw = (_mix(x, xs, p[m]) for m in
                          ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w"))
    r = lin.dense(xr, p["wr"], None, path_prefix + "r").reshape(B, S, H, hd)
    k = lin.dense(xk, p["wk"], None, path_prefix + "k").reshape(B, S, H, hd)
    v = lin.dense(xv, p["wv"], None, path_prefix + "v").reshape(B, S, H, hd)
    g = lin.dense(xg, p["wg"], None, path_prefix + "g")
    # the data-dependent decay: two fp32 products of the client's own params
    dd = torch.tanh(xw.float() @ p["w1"].float()) @ p["w2"].float()
    w = torch.exp(-torch.exp(p["decay"] + dd)).reshape(B, S, H, hd)
    o32, state = wkv6_scan(r, k, v, w, p["bonus"], state)
    # per-head rms norm in fp32 (JAX's stand-in for the group norm), gated
    o32 = o32 * torch.rsqrt((o32 * o32).mean(dim=-1, keepdim=True) + 1e-6)
    out = (o32.reshape(B, S, d) * p["ln_x"].float()).to(x.dtype)
    out = out * F.silu(g)
    out = lin.dense(out, p["wo"], None, path_prefix + "o")
    return out, state, x[:, -1:]


def channel_mix(p, x, lin: LinearFns, last_x, *, path_prefix=""):
    """RWKV6 channel mix: a squared-relu FFN gated by sigmoid(r). Returns
    (y [B,S,d], x[:, -1:])."""
    xs = _shift(x, last_x)
    xk = _mix(x, xs, p["mix_k"])
    xr = _mix(x, xs, p["mix_r"])
    k = lin.dense(xk, p["wk"], None, path_prefix + "cm_k")
    k = torch.square(F.relu(k))
    kv = lin.dense(k, p["wv"], None, path_prefix + "cm_v")
    r = torch.sigmoid(lin.dense(xr, p["wr"], None, path_prefix + "cm_r"))
    return r * kv, x[:, -1:]
