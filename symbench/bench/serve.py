"""What the serving loops share (``symbench/loops/serve_open.py``: requests
submitted at their due times whatever the engine is doing;
``symbench/loops/serve_backlog.py``: a queue larger than the window can
finish, handed over as slots free). Both drive ``ServingEngine``'s
``service_tick`` and read its public counters and each request's stamps.

A run: draw the base and the tenants' adapters from the seed; build the
engine; warm the prefill shapes the mix uses (its prompt-length buckets at
its row counts); fill to a steady state and measure ``--seconds`` (the
loop's ``drive``); the window's edges are tick boundaries. After it
closes, the device's peak memory is read, the engine is dropped, and a
sample of the finished requests is held against the reference.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench import check, flops, model, traffic
from bench.trace import Stretches
from bench.window import Run, Tick, tick_summary


def pool_pages(arch: dict, mix: dict) -> int:
    s = arch["serve"]
    per_page = s["page_block"] * s["kv_bytes_per_token"]
    return int(s["kv_budget_bytes"] // (mix["tenants"] * per_page))


def build(arch: dict, mix: dict, seed: int, device, obs=None):
    from repro_torch.config import ServeConfig
    from repro_torch.core.engine_spec import BankSpec, EngineSpec
    from repro_torch.serving.engine import ServingEngine
    cfg = model.model_config(arch)
    gen = model.generator(seed, device)
    base = model.make_base(arch, gen, device)
    bank = model.make_lora(arch, mix["bank"], mix["tenants"], gen, device,
                           model.served_dtype(arch))
    scfg = ServeConfig(n_clients=mix["tenants"], max_seq=mix["max_seq"],
                       policy=mix["policy"],
                       page_block=arch["serve"]["page_block"],
                       pool_pages=pool_pages(arch, mix), kv_quant=False)
    spec = EngineSpec(cfg=cfg, banks=(BankSpec(
        "tenants", model.adapter_config(mix["bank"]), mix["tenants"]),),
        serve=scfg, max_batch_per_client=mix["slots_per_tenant"])
    eng = ServingEngine(spec, base, [bank], device=device, obs=obs)
    return base, bank, eng


def warm(eng, mix: dict, vocab: int, seed: int):
    """Run the mix's prefill shapes once: ``rows`` requests of each warm
    length side by side, and each ``extra`` [rows, length] pair, two
    tokens each."""
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng([seed, 3])
    w = mix["warm"]
    shapes = [(w["rows"], n) for n in w["prompt_lengths"]] + \
        [tuple(x) for x in w.get("extra", [])]
    took = []
    for rows, n in shapes:
        for c in range(rows):
            eng.submit(Request(c % mix["tenants"], rng.integers(
                0, vocab, (1, n)).astype(np.int32), 2))
        t = time.perf_counter()
        eng.run()
        took.append(f"{rows}x{n} {time.perf_counter() - t:.2f}s")
    return took


class Loop:
    """Submission, ticking and the per-tick bookkeeping of a serving run."""

    def __init__(self, eng, m, lora, trace: bool):
        self.eng, self.m, self.lora = eng, m, lora
        self.next = 0
        self.tracked = []            # (request, due time on the host clock)
        self.pending = []            # submitted, not yet admitted
        self.live = []               # admitted, not yet finished
        self.progress = {}           # id(request) -> tokens generated
        self.ticks = []
        self.mismatch = 0
        # a traced run: a device stretch of 2 prefill and 15 decode-only
        # ticks (5 s at most), then a host stretch of 1 and 1 (3 s at most:
        # host profiling slows every tick, and the open loop's arrivals
        # queue meanwhile)
        self.stretches = Stretches((
            ("device", False, lambda c: c["prefill"] >= 2
             and c["decode"] >= 15, 5.0),
            ("host", True, lambda c: c["prefill"] >= 1
             and c["decode"] >= 1, 3.0))) if trace else None
        self.stage = ""
        self.lag = []
        self.watched, self.watch_until = {}, 0.0
        self.retired = False

    def watch(self, share: float, seed: int):
        """Keep the logits the engine samples from for a ``share`` of the
        requests submitted from now until ``watch_until`` (host clock; set
        when the window opens), drawn from the seed: wraps the engine's
        per-request sampler, which hands each request's logits rows to it
        on the host. Requests of the fill count: most of a window's
        finished requests were submitted before it."""
        self.watch_share, self.watch_until = share, float("inf")
        self.watch_rng = np.random.default_rng([seed, 4])
        self.watched = {}
        sample = self.eng._sample

        def keep(logits, req):
            rows = self.watched.get(id(req))
            if rows is not None:
                rows.append(np.array(logits[0], dtype=np.float32))
            return sample(logits, req)
        self.eng._sample = keep

    def submit(self, item, due_abs):
        from repro_torch.serving.engine import Request
        r = Request(item.tenant, item.prompt, item.max_new)
        if time.perf_counter() < self.watch_until and \
                self.watch_rng.random() < self.watch_share:
            self.watched[id(r)] = []
        self.eng.submit(r)
        self.lag.append(r.submit_t - due_abs)
        self.tracked.append((r, due_abs))
        self.pending.append(r)

    def tick(self, in_window: bool):
        st = self.eng.stats
        dec0 = st["decode_tokens"]
        t0 = time.perf_counter()
        self.eng.service_tick()
        t1 = time.perf_counter()
        newly = [r for r in self.pending if r.admit_t]
        if newly:
            self.pending = [r for r in self.pending if not r.admit_t]
        for r in newly:
            self.progress[id(r)] = 1 if r.first_token_t else 0
            self.live.append(r)
        ctxs = []
        for r in self.live:
            if r.status != "ok":
                continue
            g = self.progress[id(r)]
            ctxs.append(r.prompt.shape[1] + g)
            self.progress[id(r)] = g + 1
        rows, ctx = len(ctxs), sum(ctxs)
        if rows != st["decode_tokens"] - dec0:
            self.mismatch += 1
        n_live = len(self.live)
        self.live = [r for r in self.live if not r.finish_t]
        self.retired = self.retired or len(self.live) < n_live
        tk = Tick(t0, t1, prefill_rows=len(newly), decode_rows=rows,
                  ctx_sum=ctx, profiled=self.stage,
                  prompts=[r.prompt.shape[1] for r in newly], ctxs=ctxs)
        tk.flops = self.tick_flops(tk)
        if in_window:
            self.ticks.append(tk)
        if self.stage:
            self.stretches.count(bool(newly), bool(rows))
        return tk

    def maybe_profile(self, now, t_start, t_end):
        if self.stretches is not None:
            self.stage = self.stretches.before_tick(now, t_start, t_end)

    def finish(self):
        """After the window: the traced run's traces by stretch and when
        the first opened, or ({}, None)."""
        self.stage = ""
        return self.stretches.finish() if self.stretches else ({}, None)

    def tick_flops(self, tk) -> float:
        m = self.m
        return (sum(flops.prefill_flops(m, S, self.lora) for S in tk.prompts)
                + tk.decode_rows * flops.decode_flops(m, 0, self.lora)
                + flops.attn_decode_flops(m, tk.ctx_sum))


def run(arch, mix, cell, seed, seconds, trace, device, log, drive, due_in,
        control=False, reference=True):
    """One run of a serving cell: (Run, result fields, check numbers).
    ``drive(lp, items, mix, seconds)`` fills and runs the window, returning
    its start and the engine's counters there; ``due_in(lp, t_start,
    t_end)`` gives the window's requests with their due times. ``control``
    adds the fp8 control's reading to the numbers, and ``reference=False``
    (the rate sweep) skips the check."""
    obs = None
    if trace:
        from repro_torch.obs import Obs
        obs = Obs()
    base, bank, eng = build(arch, mix, seed, device, obs)
    m = flops.dims(arch)
    lora = ((mix["bank"]["targets"], mix["bank"]["rank"]),)
    items = traffic.serving_items(mix, seed, seconds, m.V, mix["tenants"])
    log(f"warm-up (rows x prompt: 2 tokens each) {warm(eng, mix, m.V, seed)}")
    lp = Loop(eng, m, lora, trace)
    st = eng.stats
    chk = mix["check"]
    lp.watch(chk["watched_share"], seed)
    t_start, snap0 = drive(lp, items, mix, seconds)
    torch_sync(device)
    t_end = time.perf_counter()
    snap1 = dict(st)
    traces, traced_from = lp.finish()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    due = due_in(lp, t_start, t_end)
    finished = [r for r, _ in lp.tracked
                if r.finish_t and t_start <= r.finish_t <= t_end]
    w = Run(kind="serve", cell=cell, arch=arch, mix=mix, t0=t_start,
            t1=t_end, ticks=lp.ticks, trace=traces.get("device"))
    w.trace_host = traces.get("host")
    w.due, w.finished = due, finished
    w.flops = None if lp.mismatch else sum(t.flops for t in lp.ticks)
    w.extra.update(stats0=snap0, stats1=snap1, decode_mismatch=lp.mismatch,
                   waiting_at_end=len(lp.pending), traced_from=traced_from,
                   lag_max=max(lp.lag) if lp.lag else 0.0,
                   lag_median=float(np.median(lp.lag)) if lp.lag else 0.0)
    failed = sum(1 for r, _ in due if r.status != "ok")
    log(f"ticks (ms) {tick_summary(lp.ticks)}; most prefill rows in a tick "
        f"{max((t.prefill_rows for t in lp.ticks), default=0)}")
    log(f"window {w.seconds:.3f} s: {len(due)} requests attempted, "
        f"{len(finished)} finished, {len(w.ticks)} ticks, "
        f"{snap1['decode_tokens'] - snap0['decode_tokens']} decode tokens, "
        f"generator lag max {w.extra['lag_max'] * 1e3:.1f} ms, "
        f"peak memory {peak / 1e9:.2f} GB")
    if not reference:
        return w, dict(attempted=len(due), failed=failed, peak=peak), {}
    # correctness: free the program's state, then the reference over a
    # sample of the watched requests finished in the window
    ok_done = [r for r in finished if r.status == "ok"
               and len(lp.watched.get(id(r), ())) == r.generated.shape[1]]
    picked = check.sample(ok_done, seed, chk["served_tokens"],
                          chk["max_requests"])
    kept = {id(r): np.stack(lp.watched[id(r)]) for r in picked}
    eng.caches = None
    del eng, lp
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    scale = mix["bank"]["alpha"] / mix["bank"]["rank"]
    numbers = check.served_gaps(
        arch, base, lambda c: check.client_adapter(bank, scale, c), picked,
        kept, device, control=control) if picked else \
        {"served_logit_gap": None, "served_logit_err": None}
    log(f"reference over {len(picked)} requests "
        f"({sum(r.generated.shape[1] for r in picked)} served tokens) in "
        f"{time.perf_counter() - t_ref:.1f} s")
    return w, dict(attempted=len(due), failed=failed, peak=peak), numbers


def torch_sync(device):
    if device != "cpu":
        torch.cuda.synchronize()


def readings(run, arch, mix, cell, seed, control, fault, seconds, device,
             log):
    """The readings that set a serving cell's limits (``control.py``): the
    cell as ``run.py`` runs it, then over the same sampled requests the
    served tokens' gap and logit error; with ``control`` the fp8 control's
    and the gap of each served token altered where it is produced."""
    _, _, nums = run(arch, mix, cell, seed, seconds, False, device, log,
                     control=control)
    out = {"seed": seed, "sound": {
        k: nums[k] for k in ("served_logit_gap", "served_logit_err")}}
    if "control_logit_gap" in nums:
        out["control"] = {"served_logit_gap": nums["control_logit_gap"],
                          "served_logit_err": nums["control_logit_err"]}
        out["altered_token"] = {"served_logit_gap": nums["altered_logit_gap"]}
    return out
