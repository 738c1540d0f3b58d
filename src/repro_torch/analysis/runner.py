"""Run the analysis passes over the standard hot-path targets (the port of
``repro.analysis.runner``).

``run_static`` runs the per-target passes where JAX runs its own: the
in-place check on every target (JAX: donation), the pool-copy audit on
every target with page pools, the MoE recompute audit on MoE training and
the frozen-base check on training; ``run_isolation`` the differential
probes; ``run_buckets`` JAX's engine workload (staggered serving, a live
``admit_bank``, a 2-job fine-tuning churn) under the trace-count guard.
JAX's collective audit (``run_collectives``) has no counterpart on one
card.
"""
from __future__ import annotations

import numpy as np

from repro_torch import resolve_device
from repro_torch.analysis import aliasing, audit, taint, tracecount
from repro_torch.analysis.report import PassResult
from repro_torch.analysis.targets import LORA, all_targets, tiny_config
from repro_torch.config import DENSE, MOE, FinetuneConfig, ServeConfig
from repro_torch.core import symbiosis


def run_static(targets) -> list:
    results = []
    for t in targets:
        results.append(aliasing.check_in_place(
            t.fn, t.args, state=t.state, base_argnum=t.base_argnum,
            target=t.name))
        if t.protected_leaves:
            results.append(audit.check_pool_copies(
                t.fn, t.args, t.protected_leaves, target=t.name))
        if t.arch == MOE and t.kind == "train":
            results.append(audit.check_moe_checkpointed(
                t.fn, t.args, target=t.name))
        if t.kind == "train":
            results.append(taint.check_frozen_base(
                t.fn, t.args, base_argnum=t.base_argnum,
                update_argnums=tuple(t.state), target=t.name))
    return results


def _decode_pair(fn):
    """A compacted decode step's (logits, finite, caches) as the
    (out, caches) pair the isolation probe takes."""
    def run(*args):
        out = fn(*args)
        return out[0], out[-1]
    return run


def run_isolation(targets) -> list:
    """Differential client / row isolation probes on the compacted steps."""
    results = []
    for t in targets:
        iso = t.isolation
        if not iso:
            continue
        if t.kind == "serving":
            scfg = iso["scfg"]
            cfg = tiny_config(t.arch)
            cache_kw = symbiosis.serve_cache_kwargs(cfg, scfg)
            page_axes = symbiosis.cache_page_axes(cfg, scfg.max_seq,
                                                  **cache_kw)
            slot_axes = dict(symbiosis.cache_slot_axes(cfg, scfg.max_seq,
                                                       **cache_kw),
                             block_tbl=0)
            base, bank, caches = t.args[:3]
            n_blocks = -(-scfg.max_seq // scfg.page_block)
            results.append(taint.check_client_isolation(
                _decode_pair(t.fn), base, bank, caches, iso["extra"],
                clients=iso["clients"], victim=iso["victim"],
                pool_pages=2 * n_blocks,      # max_b * n_blocks per client
                page_axes=page_axes, slot_axes=slot_axes, target=t.name))
        else:
            results.append(taint.check_row_isolation(
                t.fn, t.args, perturb_row=iso["perturb_row"],
                victim_slot=iso["victim_slot"],
                perturb_argnums=iso["perturb_argnums"],
                state_argnums=tuple(t.state), target=t.name))
    return results


def run_buckets(device="cuda", *, obs=None) -> PassResult:
    """JAX's engine workload under the trace-count guard: serving ticks with
    staggered admissions and a live ``admit_bank`` growth, then a
    fine-tuning churn; every step signature must land in the declared
    domains. ``obs`` (one ``Obs``) is attached to both engines."""
    from repro_torch.core.engine_spec import BankSpec, EngineSpec
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.training import (FinetuneEngine, FinetuneJob,
                                      make_job_stream)
    import torch

    dev = resolve_device(device)
    cfg = tiny_config(DENSE)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)  # noqa
    with tracecount.guard("engine-workload") as g:
        scfg = ServeConfig(n_clients=2, max_seq=32, page_block=8)
        base, bank = symbiosis.init_system(cfg, LORA, 2, gen(0), device=dev)
        spec = EngineSpec(cfg=cfg, banks=(BankSpec("tenants", LORA,
                                                   capacity=2),),
                          serve=scfg, max_batch_per_client=2)
        eng = ServingEngine(spec, base, [bank], device=dev, obs=obs)
        rng = np.random.default_rng(0)
        for c in range(2):
            eng.submit(Request(client_id=c,
                               prompt=rng.integers(0, cfg.vocab, (1, 6))
                               .astype(np.int32),
                               max_new_tokens=3))
        eng.run()
        # live bank growth: new client ids, grown buckets, a new epoch
        extra = symbiosis.init_system(cfg, LORA, 1, gen(9), device=dev)[1]
        adm = eng.admit_bank(LORA, extra)
        eng.submit(Request(client_id=adm.client_ids[0],
                           prompt=rng.integers(0, cfg.vocab, (1, 6))
                           .astype(np.int32), max_new_tokens=3))
        eng.run()
        eng.retire_bank(adm)

        ft = FinetuneEngine(
            EngineSpec(cfg=cfg, finetune=FinetuneConfig(max_jobs=4)), base,
            device=dev, obs=obs)
        for i in range(2):
            ft.submit(FinetuneJob(acfg=LORA,
                                  data=make_job_stream(cfg, 2, 8, seed=i,
                                                       device=dev),
                                  batch_size=2, seq_len=8, steps=2))
        ft.run()
    return g.result()


def run_all(*, device="cuda") -> list:
    targets = all_targets(device)
    results = run_static(targets)
    results.append(run_buckets(device))
    results.extend(run_isolation(targets))
    return results
