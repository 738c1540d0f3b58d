"""Activation privacy for multi-tenancy (paper §3.8), the port of
``repro.core.privacy``.

The provider of the frozen base sees the activations a client ships to the
base linears and could extract the client's adapter from them. The client
adds noise ``n`` to those activations; the *noise effect* ``n_eff = n @ W``
is computed once per noise value (the bias-free executor flow) and
subtracted from every noisy output:

    y = ((x + n) @ W + b) - (n @ W)  ==  x @ W + b      (exact, linearity)

Only linear base layers can be protected this way. Several pre-drawn noise
vectors (variants) rotate across layers or iterations, so the executor
cannot align the noisy activations it sees with one noise value.

The noise is drawn from a ``torch.Generator`` the caller seeds (JAX draws
from ``jax.random``): the same seed gives the same noise in the port, not
JAX's.
"""
from __future__ import annotations

import torch


def make_noise(generator: torch.Generator, paths_dims, n_variants: int = 2,
               scale: float = 1.0, dtype=torch.float32):
    """Per-path noise bank: path -> [n_variants, din] on the generator's
    device, drawn in fp32 path by path in sorted order, scaled, then cast
    to ``dtype``."""
    noise = {}
    for path, (din, _dout) in sorted(paths_dims.items()):
        n = torch.randn((n_variants, din), generator=generator,
                        device=generator.device, dtype=torch.float32)
        noise[path] = (n * scale).to(dtype)
    return noise


def noise_effect(noise, weights):
    """``n_eff = n @ W`` for every (path, variant): the bias-free executor
    flow of §3.8.

    ``weights``: path -> W [din, dout] (giving [V, dout]), a stacked
    [L, din, dout] or the port's per-layer list of [din, dout] (giving
    [L, V, dout], which the layer loop slices). ``n`` is cast to W's
    dtype before the product, as in JAX."""
    eff = {}
    for path, n in noise.items():
        w = weights[path]
        if isinstance(w, (list, tuple)):
            eff[path] = torch.stack([n.to(wl.dtype) @ wl for wl in w])
        else:
            eff[path] = n.to(w.dtype) @ w
    return eff


def private_dense(base_dense, x, w, b, path, n, n_eff):
    """One private base-layer call: ``n`` [din] and ``n_eff`` [dout] are
    the selected variant's; ``base_dense`` is the (memory-optimized)
    frozen linear. The noise is cast to the activation's dtype before the
    add and the effect to the output's before the subtraction, as in JAX:
    in bf16 the cancellation rounds."""
    y_noisy = base_dense(x + n.to(x.dtype), w, b)
    return y_noisy - n_eff.to(y_noisy.dtype)


def select_variant(noise_or_eff, path, variant: int):
    """Variant ``variant`` of ``path``'s bank ([V, d] or [L, V, d])."""
    bank = noise_or_eff[path]
    return bank.select(bank.ndim - 2, variant)
