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

Training: a merged bank step passes ``rows=R``, and each row's tokens
route, drop and pay their aux loss alone, as in JAX's ``vmap`` of the row
program. JAX wraps the body in ``closure_convert`` + ``jax.checkpoint``;
here a training call (grad enabled, aux asked for) runs it under
``torch.utils.checkpoint``: the layer saves its input only and the
backward recomputes the body. The serving paths pass ``with_aux=False``:
the aux loss is never computed there (XLA drops the unused value from
JAX's jitted steps) and the body runs alone, no launch added.
No op here makes the host wait for the device: the one-hot masks are
comparisons (``F.one_hot`` checks its input's range on the host).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

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
           with_aux: bool = True, rows: int = 1):
    """Router over x [B,S,d]: (gate_vals [T,k] f32, idx [T,k] int64, aux),
    T = B*S. The router product reads x unflattened, so an adapter hook
    sees its B rows (JAX's reads [T,d]; the product is the same). The
    tokens form ``rows`` groups of T/rows, and each group's load-balance
    aux loss is over its own tokens alone: aux [rows] f32 (a scalar for
    ``rows=1``), or None without ``with_aux``."""
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
    # load-balance auxiliary loss (Switch-style), one per group
    Tg = T // rows
    me = probs.reshape(rows, Tg, E).mean(1)                         # [R,E]
    group = torch.arange(rows, device=x.device).repeat_interleave(Tg * k)
    ce = torch.zeros((rows * E,), dtype=torch.float32, device=x.device) \
        .index_add_(0, group * E + idx.reshape(-1),
                    torch.ones((T * k,), dtype=torch.float32,
                               device=x.device)).reshape(rows, E) / (Tg * k)
    aux = E * torch.sum(me * ce, dim=-1)                            # [R]
    return gate_vals, idx, aux[0] if rows == 1 else aux


def _slot_positions(idx, E: int, cap: int, rows: int = 1):
    """Each (token, slot)'s position in its expert's capacity buffer, in
    token order within its group of T/rows tokens, and whether it fits."""
    T, k = idx.shape
    onehot = _one_hot(idx.reshape(rows, T * k // rows), E)          # [R,Tg*k,E]
    pos = torch.cumsum(onehot, dim=1) - 1
    pos_in_e = (pos * onehot).sum(-1).reshape(T, k)                 # [T,k]
    return pos_in_e, pos_in_e < cap


def _expert_ffn(params, xe, lin: LinearFns, path_prefix: str):
    ex = params["experts"]
    g = lin.expert(xe, ex["gate"], path_prefix + "experts_gate")
    u = lin.expert(xe, ex["up"], path_prefix + "experts_up")
    return lin.expert(F.silu(g) * u, ex["down"],
                      path_prefix + "experts_down")                 # [E,cap,d]


def _body(params, cfg, x, lin: LinearFns, path_prefix: str,
          capacity_factor, dispatch: str, with_aux: bool, rows: int):
    """route -> dispatch -> experts -> combine (+ the shared experts)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    Tg = T // rows
    xt = x.reshape(T, d)
    cap = _capacity(Tg, E, k, capacity_factor)
    C = rows * cap                                  # buffer rows per expert

    gate_vals, idx, aux = _route(params, cfg, x, lin, path_prefix, with_aux,
                                 rows)
    pos_in_e, keep = _slot_positions(idx, E, cap, rows)
    weights = (gate_vals * keep).to(x.dtype)                        # [T,k]

    if dispatch == "scatter":
        group = torch.arange(rows, device=x.device) \
            .repeat_interleave(Tg)[:, None]                         # [T,1]
        dest = torch.where(keep, idx * C + group * cap + pos_in_e,
                           E * C).reshape(-1)
        src = xt.repeat_interleave(k, dim=0)                        # [T*k,d]
        xe = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device) \
            .index_add_(0, dest, src)[:E * C]
        ye = _expert_ffn(params, xe.reshape(E, C, d), lin, path_prefix)
        gathered = ye.reshape(E * C, d)[dest.clamp_max(E * C - 1)]
        gathered = torch.where(keep.reshape(-1, 1), gathered, 0) \
            .reshape(T, k, d)                                       # fill 0
        yt = (gathered * weights[..., None]).sum(dim=1)
    elif dispatch == "einsum":
        disp = (_one_hot(idx, E).to(x.dtype)[..., :, None]
                * _one_hot(pos_in_e, cap).to(x.dtype)[..., None, :]
                * keep[..., None, None].to(x.dtype)) \
            .reshape(rows, Tg, k, E, cap)                           # [R,Tg,k,E,cap]
        xe = torch.einsum("rtd,rtkec->ercd", xt.reshape(rows, Tg, d), disp)
        ye = _expert_ffn(params, xe.reshape(E, C, d), lin, path_prefix)
        combine = disp * gate_vals.reshape(rows, Tg, k)[..., None, None] \
            .to(x.dtype)
        yt = torch.einsum("ercd,rtkec->rtd", ye.reshape(E, rows, cap, d),
                          combine).reshape(T, d)
    else:
        raise ValueError(f"unknown dispatch {dispatch}")

    if "shared" in params:
        yt = yt + blocks.mlp_forward(params["shared"], xt, lin,
                                     path_prefix=path_prefix + "shared_") \
            .to(yt.dtype)
    return yt.reshape(B, S, d).to(x.dtype), aux


def moe_forward(params, cfg, x, lin: LinearFns, *, path_prefix: str = "",
                capacity_factor=None, dispatch: str = "scatter",
                with_aux: bool = True, rows: int = 1):
    """x [B,S,d] -> ([B,S,d], aux_loss; None without ``with_aux``).

    ``rows`` groups the B sequences into that many groups of B/rows (a
    merged bank step's rows, each a job's batch): each group routes alone,
    as JAX's ``vmap`` of the row program sees it. A group has its own
    capacity, slot positions, dropped pairs and aux loss (aux [rows]; a
    scalar for ``rows=1``), and the capacity buffers of all groups are one
    [E, rows*cap, d] tensor, group r's slots at ``r*cap`` on, so each expert
    weight is still ONE batched product whatever ``rows`` is.

    capacity_factor=None (the default) is drop-free and exact; a float
    caps each group's expert buffer at factor * (B/rows)*S * k / E rows
    (padded to 8), and the (token, slot) pairs past it, in token order, are
    dropped exactly as JAX drops them.

    A call that asks for the aux loss with grad enabled is a training call:
    the body runs under ``torch.utils.checkpoint`` (JAX's
    ``jax.checkpoint``), so the layer saves only its inputs and the
    backward recomputes the routing, the dispatch buffers and the expert
    hiddens. Tensors the ``lin`` hook closes over (a router-targeted
    adapter's leaves) take their grads through the recomputed region. The
    serving paths pass ``with_aux=False`` and run the body alone."""
    args = (params, cfg, x, lin, path_prefix, capacity_factor, dispatch,
            with_aux, rows)
    if with_aux and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            _body, *args, use_reentrant=False, preserve_rng_state=False)
    return _body(*args)
