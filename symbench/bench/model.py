"""The model under test as the program takes it: its ``ModelConfig`` built
from a configuration file, and its frozen base and adapters drawn from the
run's seed on the device, in a few large calls, in the dtype they are
served in (bf16 base, fp32 router as the port keeps it).

The draws follow the port's distributions: linears uniform in
+-1/sqrt(din), the embedding normal * 0.02, norm scales 1; a LoRA A normal
/ sqrt(din) and B normal * ``b_scale`` (nonzero, so every tenant's adapter
differs and the per-row routing of the adapter products matters). Each
kind of weight is one tensor over all layers (experts too); the per-layer
dicts the program reads hold views of it.
"""
from __future__ import annotations

import math

import torch

from bench.flops import dims

def model_config(arch: dict):
    """The port's ``ModelConfig`` for a configuration file (its family's
    ``model_config`` given the fields every family shares)."""
    m = dims(arch)
    common = dict(name=arch["name"], n_layers=m.L, d_model=m.d,
                  n_heads=m.H, n_kv_heads=m.K, d_ff=m.dff, vocab=m.V,
                  head_dim=0 if m.hd == m.d // m.H else m.hd,
                  tie_embeddings=m.tied, rope_theta=arch["rope_theta"],
                  dtype=arch["torch_dtype"], param_dtype=arch["torch_dtype"],
                  source=arch["source"])
    return m.family.model_config(arch, m, common)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def _uniform(shape, din, dtype, gen, device):
    s = 1.0 / math.sqrt(din)
    return torch.empty(shape, dtype=dtype, device=device).uniform_(
        -s, s, generator=gen)


def served_dtype(arch: dict) -> torch.dtype:
    return getattr(torch, arch["torch_dtype"])


def make_base(arch: dict, gen: torch.Generator, device):
    """The frozen base in the port's layout, in the configuration's dtype:
    ``embed``, ``final_norm``, ``lm_head`` (unless tied) and one dict per
    layer (attention here, the feed-forward from the family's
    ``ffn_weights``), all layers of a kind drawn in one call."""
    m = dims(arch)
    dtype = served_dtype(arch)
    L, d, q, kv = m.L, m.d, m.H * m.hd, m.K * m.hd
    uni = lambda shape, din, dt=dtype: _uniform(shape, din, dt, gen, device)
    base = {"embed": torch.empty((m.V, d), dtype=dtype, device=device)
            .normal_(0.0, 0.02, generator=gen),
            "final_norm": {"scale": torch.ones((d,), dtype=dtype,
                                               device=device)}}
    if not m.tied:
        base["lm_head"] = uni((d, m.V), d)
    wq, wk, wv, wo = uni((L, d, q), d), uni((L, d, kv), d), \
        uni((L, d, kv), d), uni((L, q, d), q)
    norms = torch.ones((2, L, d), dtype=dtype, device=device)
    ffn = m.family.ffn_weights(arch, m, uni)
    base["layers"] = [
        {"ln1": {"scale": norms[0, i]}, "ln2": {"scale": norms[1, i]},
         "attn": {"wq": wq[i], "wk": wk[i], "wv": wv[i], "wo": wo[i]},
         **ffn[i]} for i in range(L)]
    return base


def target_io(arch: dict, target: str):
    """(din, dout) of an adapter target."""
    m = dims(arch)
    return {"q": (m.d, m.H * m.hd), "k": (m.d, m.K * m.hd),
            "v": (m.d, m.K * m.hd), "o": (m.H * m.hd, m.d),
            "gate": (m.d, m.dff), "up": (m.d, m.dff), "down": (m.dff, m.d),
            "router": (m.d, m.E)}[target]


def make_lora(arch: dict, bank: dict, n: int, gen: torch.Generator, device,
              dtype):
    """``n`` LoRA adapters stacked on a leading axis, the port's tree:
    ``{"layers": {target: {"A": [n, L, din, r], "B": [n, L, r, dout]}}}``."""
    L, r = dims(arch).L, bank["rank"]
    tree = {}
    for t in bank["targets"]:
        din, dout = target_io(arch, t)
        a = torch.randn((n, L, din, r), generator=gen, device=device,
                        dtype=torch.float32) / math.sqrt(din)
        b = torch.randn((n, L, r, dout), generator=gen, device=device,
                        dtype=torch.float32) * bank["b_scale"]
        tree[t] = {"A": a.to(dtype), "B": b.to(dtype)}
    return {"layers": tree}


def adapter_config(bank: dict):
    from repro_torch.config import AdapterConfig
    return AdapterConfig(method="lora", rank=bank["rank"],
                         alpha=float(bank["alpha"]),
                         targets=tuple(bank["targets"]))
