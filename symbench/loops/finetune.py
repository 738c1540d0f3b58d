"""The fine-tuning loop (``"loop": "finetune"``): jobs of one or more banks
on one shared frozen base through ``FinetuneEngine.train_tick``.

Set-up draws the base and every job's starting LoRA adapter (B nonzero)
from the seed, builds the engine, submits the jobs with those adapters and
fresh AdamW states, and runs the first ``setup_ticks`` ticks: every job's
first steps go through the same engine, call and data streams the window
then drives. Their losses, the first step's gradient (read back from each
job's first moment) and the adapters after them are kept for the check.
The window then runs ticks for ``--seconds``; its edges are tick
boundaries, and every tick ends with the losses' copy to the host.
"""
from __future__ import annotations

import gc
import time

import torch

from bench import check, flops, model, traffic
from bench.trace import Stretches
from bench.window import Run, Tick, tick_summary

BETA1 = 0.9


def _leaves(tree):
    """{(target, "A" | "B"): tensor} of a one-job adapter tree."""
    return {(t, n): leaf[n] for t, leaf in tree["layers"].items()
            for n in ("A", "B")}


def build(arch, mix, seed, device, stream=traffic.JobStream, obs=False):
    from repro_torch.config import FinetuneConfig
    from repro_torch.core.engine_spec import BankSpec, EngineSpec
    from repro_torch.optim import adamw_init
    from repro_torch.training import FinetuneEngine, FinetuneJob
    cfg = model.model_config(arch)
    gen = model.generator(seed, device)
    base = model.make_base(arch, gen, device)
    V = flops.dims(arch).V
    jobs, specs, j = [], [], 0
    for b, bank in enumerate(mix["banks"]):
        acfg = model.adapter_config(bank)
        specs.append(BankSpec(f"bank{b}", acfg, bank["jobs"]))
        stacked = model.make_lora(arch, bank, bank["jobs"], gen, device,
                                  torch.float32)
        for k in range(bank["jobs"]):
            ad = {"layers": {t: {n: w[k].clone() for n, w in leaf.items()}
                             for t, leaf in stacked["layers"].items()}}
            job = FinetuneJob(
                acfg=acfg, data=stream(seed, j, mix["batch"], mix["seq"], V,
                                       device),
                batch_size=mix["batch"], seq_len=mix["seq"],
                steps=mix["step_budget"], lr=mix["lr"],
                weight_decay=mix["weight_decay"],
                warmup_steps=mix["warmup_steps"],
                total_steps=mix["step_budget"],
                max_grad_norm=mix["max_grad_norm"], name=f"job{j}",
                init_adapter=ad, init_opt=adamw_init(ad))
            jobs.append((job, bank, {k2: v.clone() for k2, v in
                                     _leaves(ad).items()}))
            j += 1
    spec = EngineSpec(cfg=cfg, banks=tuple(specs), finetune=FinetuneConfig(
        max_jobs=len(jobs), memory_optimized=mix["memory_optimized"],
        remat=mix["remat"]))
    if obs:
        from repro_torch.obs import Obs
        obs = Obs()
    eng = FinetuneEngine(spec, base, device=device, obs=obs or None)
    for job, _, _ in jobs:
        eng.submit(job)
    return base, jobs, eng


def first_steps(eng, jobs, n):
    """Run ``n`` ticks; returns per job {"losses", "grads", "change"}."""
    out = {}
    for t in range(n):
        eng.train_tick()
        if t == 0:
            for job, _, _ in jobs:
                _, opt, _ = eng.job_state(job)
                out[job.name] = {"grads": {k: m / (1 - BETA1) for k, m in
                                           _leaves(opt.m).items()}}
    for job, _, init in jobs:
        ad, _, _ = eng.job_state(job)
        got = _leaves(ad)
        out[job.name]["change"] = {k: got[k].float() - init[k]
                                   for k in init}
        out[job.name]["losses"] = list(job.losses[:n])
    return out


def reference(arch, base, jobs, mix, n, fp8=False):
    """The reference's readings of every job's first ``n`` steps (with
    ``fp8``, the control's)."""
    return {job.name: _ref_job(arch, base, job, bank, init, mix, n, fp8)
            for job, bank, init in jobs}


def _ref_job(arch, base, job, bank, init, mix, n, fp8=False):
    adapter = {t: (init[(t, "A")], init[(t, "B")]) for t in bank["targets"]}
    batches = [job.data.batch(s) for s in range(n)]
    hyper = dict(lr=mix["lr"], warmup_steps=mix["warmup_steps"],
                 total_steps=mix["step_budget"],
                 weight_decay=mix["weight_decay"],
                 max_grad_norm=mix["max_grad_norm"])
    return check.reference_job(arch, base, adapter,
                               bank["alpha"] / bank["rank"], batches, hyper,
                               fp8=fp8)


def run(arch, mix, cell, seed, seconds, trace, device, log):
    """One run of a fine-tuning cell: (Run, result fields, check numbers);
    a traced run's engine has telemetry attached, for its phases."""
    base, jobs, eng = build(arch, mix, seed, device, obs=trace)
    n = mix["setup_ticks"]
    prog = first_steps(eng, jobs, n)
    log(f"built, {n} set-up ticks done at {time.perf_counter():.3f}")
    st = eng.stats
    # a traced run: a device stretch of trace_ticks ticks, then a host
    # stretch of one
    stretches = Stretches((
        ("device", False, lambda c: c["ticks"] >= mix["trace_ticks"], 30.0),
        ("host", True, lambda c: c["ticks"] >= 1, 30.0))) if trace else None
    m = flops.dims(arch)
    per_step = {job.name: flops.train_step_flops(
        m, mix["batch"], mix["seq"], bank["targets"], bank["rank"])
        for job, bank, _ in jobs}
    ticks, sync = [], (torch.cuda.synchronize if device != "cpu"
                       else lambda: None)
    sync()
    t_start = time.perf_counter()
    snap0 = dict(st)
    steps0 = {job.name: len(job.losses) for job, _, _ in jobs}
    while True:
        now = time.perf_counter()
        if now >= t_start + seconds:
            break
        stage = stretches.before_tick(now, t_start, t_start + seconds) \
            if stretches else ""
        before = {job.name: len(job.losses) for job, _, _ in jobs}
        t0 = time.perf_counter()
        eng.train_tick()
        t1 = time.perf_counter()
        if stage:
            stretches.count(False, False)
        tk = Tick(t0, t1, profiled=stage)
        tk.flops = sum((len(job.losses) - before[job.name]) * per_step[
            job.name] for job, _, _ in jobs)
        ticks.append(tk)
    sync()
    t_end = time.perf_counter()
    snap1 = dict(st)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    traces, traced_from = stretches.finish() if stretches else ({}, None)
    w = Run(kind="train", cell=cell, arch=arch, mix=mix, t0=t_start,
            t1=t_end, ticks=ticks, trace=traces.get("device"),
            trace_host=traces.get("host"), flops=sum(t.flops for t in ticks))
    w.extra.update(stats0=snap0, stats1=snap1, traced_from=traced_from)
    attempted = sum(len(job.losses) - steps0[job.name]
                    for job, _, _ in jobs) + (snap1["dropped_steps"]
                                              - snap0["dropped_steps"])
    failed = snap1["dropped_steps"] - snap0["dropped_steps"]
    log(f"ticks (ms) {tick_summary(ticks)}")
    log(f"window {w.seconds:.3f} s: {len(ticks)} ticks, "
        f"{snap1['train_tokens'] - snap0['train_tokens']} tokens, "
        f"peak memory {peak / 1e9:.2f} GB")
    eng_jobs = [(job, bank, init) for job, bank, init in jobs]
    del eng
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference(arch, base, eng_jobs, mix, n)
    numbers = check.train_numbers(prog, ref)
    log(f"reference over {len(jobs)} jobs x {n} steps in "
        f"{time.perf_counter() - t_ref:.1f} s")
    return w, dict(attempted=attempted, failed=failed, peak=peak), numbers


class HalfStream:
    """A job stream whose batches leave their second half out of the loss
    (the fault "half of the batch left out, the mean taken over the
    rest")."""

    def __init__(self, *args):
        self.inner = traffic.JobStream(*args)
        self.batch_size, self.seq = self.inner.batch_size, self.inner.seq

    def batch(self, step):
        b = dict(self.inner.batch(step))
        mask = torch.ones(b["tokens"].shape, device=b["tokens"].device)
        mask[self.batch_size // 2:] = 0.0
        b["mask"] = mask
        return b


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def readings(arch, mix, cell, seed, control, fault, seconds, device, log):
    """The readings that set the cell's limits (``control.py``), with no
    window: the program's set-up steps against the reference; with
    ``control`` the fp8 control's steps against it, and with ``fault`` a
    program whose data leaves half of every batch out of the loss."""
    base, jobs, eng = build(arch, mix, seed, device)
    n = mix["setup_ticks"]
    prog = first_steps(eng, jobs, n)
    del eng
    _free()
    ref = reference(arch, base, jobs, mix, n)
    out = {"seed": seed, "sound": check.train_numbers(prog, ref)}
    if control:
        low = reference(arch, base, jobs, mix, n, fp8=True)
        out["control"] = check.train_numbers(low, ref)
    if fault:
        del base, jobs
        _free()
        base, jobs, eng = build(arch, mix, seed, device, stream=HalfStream)
        bad = first_steps(eng, jobs, n)
        del eng
        _free()
        # the reference sees every sequence of the batch
        for job, _, _ in jobs:
            job.data = job.data.inner
        ref2 = reference(arch, base, jobs, mix, n)
        out["half_batch"] = check.train_numbers(bad, ref2)
    return out
