"""Mixture-of-Experts FFN with capacity-based dispatch, the port of
``repro.models.moe``.

DeepSeek-MoE's fine-grained experts (shared + routed top-k) and Arctic's
dense residual in parallel with the MoE (in ``transformer``). Expert
weights are frozen base parameters, stacked [E, din, dout]; the router is
a client-tunable layer when an adapter targets ``router``.

Two dispatch strategies, as in JAX:

* ``scatter`` (the serving path): scatter-add each (token, slot) into its
  expert's capacity buffer [E, cap, d], run the experts as three batched
  products (``LinearFns.expert``), gather-combine back. JAX's
  ``.at[dest].add(mode="drop")`` / ``.get(mode="fill")`` have no torch
  counterpart (an out-of-range ``index_add_`` is a device assert), so a
  dropped slot goes to one spare row ``E*cap`` that is discarded. Kept
  destinations are unique, so adding into zeros is exact (and turns a
  ``-0.0`` into ``+0.0`` as JAX's add does).
* ``einsum``: the one-hot dispatch/combine einsums, O(T*k*E*cap); the test
  oracle.

Routing runs in fp32 (JAX ``moe.py:62``) with TF32 off for the router
product whatever the process's setting: one flipped expert changes a
token. Top-k is a stable descending sort, so ties go to the lower expert
index as ``jax.lax.top_k`` gives them (a zero hidden state, e.g. a padding
row, gives all-equal logits).

Left to the fine-tuning slice: JAX wraps the body in ``closure_convert`` +
``jax.checkpoint`` for a bitwise vmap-vs-solo backward; without
differentiation that wrapper is the identity, so ``moe_forward`` here is
the body alone. The serving paths pass ``with_aux=False``: the aux loss is
never computed there (XLA drops the unused value from JAX's jitted steps).
No op here makes the host wait for the device: the one-hot masks are
comparisons (``F.one_hot`` checks its input's range on the host).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models import blocks
from repro_torch.models.blocks import LinearFns, dense_init


def _one_hot(idx, n: int):
    """[..., n] int64 one-hot of ``idx`` (all zeros where idx is outside
    [0, n), as ``jax.nn.one_hot``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def moe_init(gen, cfg, dtype, device):
    E, d, fe = cfg.n_experts, cfg.d_model, cfg.ffn_hidden

    def stacked(din, dout):
        return torch.stack([dense_init(gen, din, dout, dtype, device)
                            for _ in range(E)])

    p = {"router": dense_init(gen, d, E, torch.float32, device),
         "experts": {"gate": stacked(d, fe), "up": stacked(d, fe),
                     "down": stacked(fe, d)}}
    if cfg.n_shared_experts:
        p["shared"] = blocks.mlp_init(gen, cfg, dtype, device,
                                      d_ff=fe * cfg.n_shared_experts)
    return p


def _capacity(n_tokens: int, E: int, k: int, factor) -> int:
    """factor=None: drop-free (top-k indices are distinct, so an expert
    takes at most one slot per token and cap = n_tokens never drops) — the
    exact mode every serving path runs. A float factor is the lossy
    training knob. Padded to a multiple of 8, at least 8."""
    cap = n_tokens if factor is None else int(n_tokens * k / E * factor)
    return max(8, ((cap + 7) // 8) * 8)


@contextlib.contextmanager
def _full_fp32():
    """fp32 products without TF32 inside, the setting restored after."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _route(params, cfg, x, lin: LinearFns, path_prefix: str,
           with_aux: bool = True):
    """Router over x [B,S,d]: (gate_vals [T,k] f32, idx [T,k] int64, aux
    scalar f32, or None without ``with_aux``), T = B*S. The router product
    reads x unflattened, so an adapter hook sees its B rows (JAX's reads
    [T,d]; the product is the same)."""
    E, k = cfg.n_experts, cfg.top_k
    T = x.shape[0] * x.shape[1]
    with _full_fp32():
        logits = lin.dense(x.float(), params["router"], None,
                           path_prefix + "router").reshape(T, E)
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = vals[:, :k], order[:, :k]                      # [T,k]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    if not with_aux:
        return gate_vals, idx, None
    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(0)                                              # [E]
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device) \
        .index_add_(0, idx.reshape(-1),
                    torch.ones((T * k,), dtype=torch.float32,
                               device=x.device)) / (T * k)
    aux = E * torch.sum(me * ce)
    return gate_vals, idx, aux


def _slot_positions(idx, E: int, cap: int):
    """Each (token, slot)'s position in its expert's capacity buffer, in
    token order, and whether it fits."""
    T, k = idx.shape
    onehot = _one_hot(idx.reshape(T * k), E)                        # [T*k,E]
    pos = torch.cumsum(onehot, dim=0) - 1
    pos_in_e = (pos * onehot).sum(-1).reshape(T, k)                 # [T,k]
    return pos_in_e, pos_in_e < cap


def _expert_ffn(params, xe, lin: LinearFns, path_prefix: str):
    ex = params["experts"]
    g = lin.expert(xe, ex["gate"], path_prefix + "experts_gate")
    u = lin.expert(xe, ex["up"], path_prefix + "experts_up")
    return lin.expert(F.silu(g) * u, ex["down"],
                      path_prefix + "experts_down")                 # [E,cap,d]


def moe_forward(params, cfg, x, lin: LinearFns, *, path_prefix: str = "",
                capacity_factor=None, dispatch: str = "scatter",
                with_aux: bool = True):
    """x [B,S,d] -> ([B,S,d], aux_loss scalar; None without ``with_aux``).

    capacity_factor=None (the default) is drop-free and exact; a float
    caps each expert buffer at factor * T * k / E rows (padded to 8), and
    the (token, slot) pairs past it, in token order, are dropped exactly
    as JAX drops them."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    cap = _capacity(T, E, k, capacity_factor)

    gate_vals, idx, aux = _route(params, cfg, x, lin, path_prefix, with_aux)
    pos_in_e, keep = _slot_positions(idx, E, cap)
    weights = (gate_vals * keep).to(x.dtype)                        # [T,k]

    if dispatch == "scatter":
        dest = torch.where(keep, idx * cap + pos_in_e, E * cap).reshape(-1)
        src = xt.repeat_interleave(k, dim=0)                        # [T*k,d]
        xe = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=x.device) \
            .index_add_(0, dest, src)[:E * cap]
        ye = _expert_ffn(params, xe.reshape(E, cap, d), lin, path_prefix)
        gathered = ye.reshape(E * cap, d)[dest.clamp_max(E * cap - 1)]
        gathered = torch.where(keep.reshape(-1, 1), gathered, 0) \
            .reshape(T, k, d)                                       # fill 0
        yt = (gathered * weights[..., None]).sum(dim=1)
    elif dispatch == "einsum":
        disp = (_one_hot(idx, E).to(x.dtype)[..., :, None]
                * _one_hot(pos_in_e, cap).to(x.dtype)[..., None, :]
                * keep[..., None, None].to(x.dtype))                # [T,k,E,cap]
        xe = torch.einsum("td,tkec->ecd", xt, disp)
        ye = _expert_ffn(params, xe, lin, path_prefix)
        combine = disp * gate_vals[..., None, None].to(x.dtype)
        yt = torch.einsum("ecd,tkec->td", ye, combine)
    else:
        raise ValueError(f"unknown dispatch {dispatch}")

    if "shared" in params:
        yt = yt + blocks.mlp_forward(params["shared"], xt, lin,
                                     path_prefix=path_prefix + "shared_") \
            .to(yt.dtype)
    return yt.reshape(B, S, d).to(x.dtype), aux
