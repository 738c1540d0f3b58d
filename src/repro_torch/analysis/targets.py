"""Standard hot-path step targets the analysis passes run over (the port of
``repro.analysis.targets``).

A ``StepTarget`` bundles one hot-path step exactly as an engine calls it:
the step function from ``core.symbiosis``, concrete tiny-config arguments
on a device, the state it writes in place (JAX: its donation signature)
and where it returns that state, and the protected-state metadata each
pass needs (the frozen base, the page pools). The CLI and the tier-1
mutation tests both take these bundles, so what is analysed IS the program
the engines run, at test-sized shapes. ``all_targets()`` covers JAX's
families: serving on dense, hybrid, RWKV and enc-dec; training on dense,
MoE, hybrid, RWKV and enc-dec.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.config import (DENSE, ENCDEC, HYBRID, MOE, RWKV, VLM,
                                AdapterConfig, ModelConfig, ServeConfig,
                                TrainConfig)
from repro_torch.core import adapters as adapters_lib
from repro_torch.core import symbiosis
from repro_torch.optim import AdamWState

LORA = AdapterConfig(method="lora", rank=4, alpha=8.0, targets=("q", "v"))


def tiny_config(arch: str = DENSE, **kw) -> ModelConfig:
    """Analysis-sized model config (JAX's: the tier-1 test shapes)."""
    base = {"name": f"analysis-{arch}", "arch": arch, "n_layers": 2,
            "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
            "vocab": 128, "dtype": "float32", "param_dtype": "float32"}
    if arch == MOE:
        base.update(n_experts=4, top_k=2, n_shared_experts=1, d_expert=32,
                    first_dense_layers=1, n_layers=3)
    if arch == RWKV:
        base.update(n_heads=4, n_kv_heads=4, head_dim=16)
    if arch == HYBRID:
        base.update(n_layers=4, attn_every=2, n_experts=4, top_k=2,
                    moe_every=2, moe_offset=1, d_state=8, d_conv=4)
    if arch == ENCDEC:
        base.update(n_enc_layers=2, n_frontend_tokens=8, rope_theta=0.0,
                    n_kv_heads=4)
    if arch == VLM:
        base.update(n_frontend_tokens=8)
    base.update(kw)
    return ModelConfig(**base)


@dataclasses.dataclass
class StepTarget:
    """One hot-path step and what the passes need to judge it."""

    name: str
    fn: Callable
    args: tuple
    # state argument -> the output index that returns it in place (None:
    # the output is that state); JAX's donate_argnums
    state: dict
    base_argnum: int = 0
    # pool-copy protection: leaves that must only be written in place
    protected_leaves: list = dataclasses.field(default_factory=list)
    kind: str = "serving"             # serving | train
    arch: str = DENSE
    # runtime isolation-probe hook (None: the static passes only)
    isolation: Any = None


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def pool_leaves(cfg, scfg, caches):
    """The global-pool cache leaves, identified structurally (never by
    shape): the leaves with a page axis."""
    page_axes = symbiosis.cache_page_axes(
        cfg, scfg.max_seq, **symbiosis.serve_cache_kwargs(cfg, scfg))
    return [t for t, pax in zip(tree_leaves(caches), tree_leaves(page_axes))
            if pax is not None]


def _serving_state(cfg, acfg, scfg, device, *, n_clients=2, max_b=2,
                   seed=0):
    base, bank = symbiosis.init_system(cfg, acfg, n_clients,
                                       _gen(device, seed), device=device)
    cache_kw = symbiosis.serve_cache_kwargs(cfg, scfg)
    caches = symbiosis.init_client_caches(cfg, n_clients, max_b, scfg.max_seq,
                                          device=device, **cache_kw)
    if "page_block" in cache_kw:
        # disjoint global pages per (client, slot), as the engine's
        # allocator would push them: client c owns [c*P, (c+1)*P)
        n_blocks = -(-scfg.max_seq // scfg.page_block)
        P = max_b * n_blocks
        tbl = np.zeros((n_clients, max_b, n_blocks), np.int32)
        for c in range(n_clients):
            for s in range(max_b):
                tbl[c, s] = c * P + s * n_blocks + np.arange(n_blocks)
        caches = dict(caches, block_tbl=torch.tensor(tbl, device=device))
    return base, bank, caches


def serving_targets(arch: str = DENSE, device="cuda") -> list:
    """The ServingEngine's steps on ``arch``: the per-client prefill on
    pages (none for enc-dec, whose engine admits nothing), the compacted
    prefill without and with a shared-prefix row and the mixed-bank
    compacted decode (the pure-KV families), the compacted decode on pages,
    the masked decode on the dense layout, and for RWKV (no pages) its
    dense prefill at the true prompt length."""
    dev = resolve_device(device)
    T = lambda a: torch.tensor(a, device=dev)      # noqa: E731
    cfg = tiny_config(arch)
    C, B = 2, 2
    out = []
    scfg_p = ServeConfig(n_clients=C, max_seq=32, page_block=8)
    paged = "page_block" in symbiosis.serve_cache_kwargs(cfg, scfg_p)

    # attention families right-pad to the engine's bucket (8 for a 6-token
    # prompt); the recurrent-bearing families prefill at the true length
    S_pad = 8 if arch in (DENSE, MOE, VLM) else 6
    toks = np.zeros((B, S_pad), np.int32)
    toks[0, :6] = np.arange(1, 7)
    lengths = np.array([6, 0], np.int32)
    mask = np.array([True, False])
    zero = torch.zeros((1,), dtype=torch.long, device=dev)

    nb = 4
    clients = np.array([0, 0, 1, 0], np.int32)
    slots = np.array([0, 1, 0, 0], np.int32)
    rmask = np.array([True, True, True, False])
    dtoks = np.ones((nb,), np.int32)

    if paged:
        base, bank, caches = _serving_state(cfg, LORA, scfg_p, dev,
                                            n_clients=C, max_b=B)
        pool = pool_leaves(cfg, scfg_p, caches)
        if arch != ENCDEC:
            out.append(StepTarget(
                name=f"serving_prefill[{arch}-paged]",
                fn=symbiosis.make_client_prefill(cfg, LORA, scfg_p),
                args=(base, bank, caches, zero, zero, T(toks), T(lengths),
                      T(mask)),
                state={2: 1}, protected_leaves=pool, arch=arch))
        if arch in (DENSE, MOE, VLM):
            ptoks = np.zeros((nb, S_pad), np.int32)
            ptoks[:3, :6] = np.arange(1, 7)
            plens = np.array([6, 6, 6, 0], np.int32)
            for label, ext, starts in (("paged", 0, [0, 0, 0, 0]),
                                       ("shared", 1, [8, 0, 0, 0])):
                out.append(StepTarget(
                    name=f"compact_prefill[{arch}-{label}]",
                    fn=symbiosis.make_compact_prefill(cfg, LORA, scfg_p,
                                                      ext_blocks=ext),
                    args=(base, bank, caches, T(ptoks), T(plens),
                          T(np.array(starts, np.int32)), T(clients),
                          T(slots), T(rmask)),
                    state={2: 2}, protected_leaves=pool, arch=arch))
        out.append(StepTarget(
            name=f"compact_decode[{arch}-paged]",
            fn=symbiosis.make_compact_decode_step(cfg, LORA, scfg_p),
            args=(base, bank, caches, T(dtoks), T(clients), T(slots),
                  T(rmask)),
            state={2: 2}, protected_leaves=pool, arch=arch,
            isolation={"clients": clients, "victim": 1, "scfg": scfg_p,
                       "extra": (T(dtoks), T(clients), T(slots), T(rmask))}))

    # the dense layout: the masked bank-wide decode
    scfg_d = ServeConfig(n_clients=C, max_seq=32)
    base_d, bank_d, caches_d = _serving_state(cfg, LORA, scfg_d, dev,
                                              n_clients=C, max_b=B)
    active = np.zeros((C, B), bool)
    active[0, 0] = active[1, 1] = True
    out.append(StepTarget(
        name=f"masked_decode[{arch}-dense]",
        fn=symbiosis.make_masked_decode_step(cfg, LORA, scfg_d),
        args=(base_d, bank_d, caches_d, T(np.ones((C, B), np.int32)),
              T(active)),
        state={2: 1}, arch=arch))
    if not paged:
        # the pure-recurrent family admits through the dense prefill
        out.append(StepTarget(
            name=f"serving_prefill[{arch}-dense]",
            fn=symbiosis.make_client_prefill(cfg, LORA, scfg_d),
            args=(base_d, bank_d, caches_d, zero, zero, T(toks), T(lengths),
                  T(mask)),
            state={2: 1}, arch=arch))

    # the mixed-method registry: lora + ia3 + prefix in one compacted tick
    if arch == DENSE:
        ia3 = AdapterConfig(method="ia3", targets=("k", "v", "down"))
        prefix = AdapterConfig(method="prefix", targets=("q", "v"),
                               n_prefix=4)
        g = _gen(dev, 3)
        bank_i = adapters_lib.init_client_bank(cfg, ia3, 1, g, device=dev)
        bank_p = adapters_lib.init_client_bank(cfg, prefix, 1, g, device=dev)
        bank_l = tree_map(lambda x: x[:1], bank)
        caches_m = symbiosis.init_client_caches(
            cfg, 3, B, scfg_p.max_seq, device=dev,
            **symbiosis.serve_cache_kwargs(cfg, scfg_p))
        mclients = np.array([0, 1, 2, 0], np.int32)    # global cache ids
        methods = np.array([0, 1, 2, 0], np.int32)     # each row's bank
        out.append(StepTarget(
            name="compact_decode[mixed-lora+ia3+prefix]",
            fn=symbiosis.make_compact_decode_step(cfg, (LORA, ia3, prefix),
                                                  scfg_p),
            args=(base, (bank_l, bank_i, bank_p), caches_m, T(dtoks),
                  T(mclients), T(slots), T(methods),
                  T(np.zeros((nb,), np.int32)), T(rmask)),
            state={2: 2}, protected_leaves=pool_leaves(cfg, scfg_p, caches_m),
            arch=arch))
    return out


def _stacked_opt(bank):
    """Zero AdamW state for every slot of a bank (step [cap])."""
    cap = tree_leaves(bank)[0].shape[0]
    zeros = lambda t: torch.zeros_like(t, dtype=torch.float32)  # noqa: E731
    return AdamWState(step=torch.zeros((cap,), dtype=torch.int32,
                                       device=tree_leaves(bank)[0].device),
                      m=tree_map(zeros, bank), v=tree_map(zeros, bank))


def train_targets(arch: str = DENSE, device="cuda") -> list:
    """The FinetuneEngine's compact multi-job train step and the solo
    baseline step (its oracle). The engine's step writes the bank and the
    optimizer state in place; the baseline step returns new ones (the
    dedicated trainer, not a hot path), so only its base is held."""
    dev = resolve_device(device)
    T = lambda a: torch.tensor(a, device=dev)      # noqa: E731
    cfg = tiny_config(arch)
    cap, R, Bt, St = 4, 2, 2, 8
    base, bank = symbiosis.init_system(cfg, LORA, cap, _gen(dev, 1),
                                       device=dev)
    opt = _stacked_opt(bank)
    rng = np.random.default_rng(0)
    batch = {"tokens": T(rng.integers(0, cfg.vocab, (R, Bt, St))),
             "labels": T(rng.integers(0, cfg.vocab, (R, Bt, St)))}
    if arch == ENCDEC:
        batch["frames"] = T((rng.normal(size=(R, Bt, cfg.n_frontend_tokens,
                                             cfg.d_model)) * 0.02)
                            .astype(np.float32))
    slots = np.array([0, 2], np.int32)
    hyper = {"step": T(np.array([0, 5], np.int32)),
             "lr": T(np.array([1e-3, 2e-3], np.float32)),
             "warmup": T(np.array([2.0, 2.0], np.float32)),
             "total": T(np.array([10.0, 10.0], np.float32)),
             "wd": T(np.array([0.0, 0.01], np.float32)),
             "gnorm": T(np.array([np.inf, 1.0], np.float32))}
    out = [StepTarget(
        name=f"compact_train[{arch}-lora]",
        fn=symbiosis.make_compact_train_step(cfg, LORA),
        args=(base, bank, opt, batch, T(slots), T(np.array([True, True])),
              hyper),
        state={1: 0, 2: 1}, kind="train", arch=arch,
        isolation={"perturb_row": 1, "victim_slot": int(slots[1]),
                   "perturb_argnums": (3, 6)})]
    tcfg = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    out.append(StepTarget(
        name=f"baseline_train[{arch}-lora]",
        fn=symbiosis.make_baseline_train_step(cfg, LORA, tcfg,
                                              memory_optimized=True),
        args=(base, tree_map(lambda x: x[0].clone(), bank),
              tree_map(lambda x: x[0].clone(), opt),
              {k: v[0] for k, v in batch.items()}, 0),
        state={}, kind="train", arch=arch))
    return out


def all_targets(device="cuda") -> list:
    """The CLI's bundle, JAX's families: serving on dense, hybrid, RWKV and
    enc-dec; training on dense, MoE, hybrid, RWKV and enc-dec."""
    return ([t for arch in (DENSE, HYBRID, RWKV, ENCDEC)
             for t in serving_targets(arch, device)]
            + [t for arch in (DENSE, MOE, HYBRID, RWKV, ENCDEC)
               for t in train_targets(arch, device)])
