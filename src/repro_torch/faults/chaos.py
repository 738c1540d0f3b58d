"""Seeded chaos sweep: fault containment under load (``repro.faults.chaos``).

Drives the port's engines (fine-tuning, serving, and the symbiotic
interleave) against a ``FaultPlan`` adversary and checks the three
robustness contracts on every scenario, the port against itself, bit for
bit:

* **Containment.** The engine never crashes; every survivor's committed
  state (token streams, adapter params, optimizer state, loss history)
  equals a clean run of the same workload byte for byte, and every
  victim's committed prefix equals the clean run's up to its last clean
  tick.
* **Conservation.** After the drain, free plus allocated pages equal the
  pool, slot maps invert exactly, and the router's live counters equal its
  capacities minus outstanding placements (``faults.audit``).
* **Recovery.** Kill, then restore from the newest VALID whole-engine
  checkpoint, resumes every tenant bit for bit; corrupted checkpoint files
  (a flipped bit, a truncation) are rejected by CRC and restore falls back
  to the last good one.

On the H100 the merged train step is not bank-size invariant: its base
linears run one product over the bucket's rows, and a GPU BLAS picks its
kernel by the product's shape, so a job's bits depend on the rows beside
it (JAX's step keeps the same one product; ``bank_rows_drift`` measures
the dependence). A faulted job that trains in other buckets than the
clean run's then drifts from it by rounding, and the bitwise contract
fails there; the fine-tuning report carries ``loss_drift`` and
``state_drift`` (0.0 where the runs agree bit for bit) so a card run can
be held to a rounding tolerance instead.

The workloads are JAX's: the same tiny fp32 config, seeds, fault plans,
hooks and prompts (drawn with numpy from the seed). The weights are drawn
on the CPU from the seed and moved to the device, so a CPU run and a card
run serve the same model. Run it::

    PYTHONPATH=src python -m repro_torch.faults.chaos [--seed N] [--report out.json] [--device cpu]

or through the ``chaos``-marked tests (``pytest -m chaos
tests/test_torch_chaos.py``).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch


def _tiny_cfg():
    from repro_torch.config import DENSE, ModelConfig
    return ModelConfig(name="tiny-chaos", arch=DENSE, n_layers=2,
                       d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                       vocab=128, dtype="float32", param_dtype="float32")


def _lora():
    from repro_torch.config import AdapterConfig
    return AdapterConfig(method="lora", rank=4, alpha=8.0,
                         targets=("q", "v"))


def _system(cfg, n_clients: int, seed: int, device):
    """The base and a LoRA bank of ``n_clients``, drawn on the CPU from
    ``seed`` and moved to ``device``."""
    from repro_torch.common.tree import tree_map
    from repro_torch.core import symbiosis
    base, bank = symbiosis.init_system(
        cfg, _lora(), n_clients, torch.Generator().manual_seed(seed),
        device="cpu")
    to = lambda t: t.to(device)                     # noqa: E731
    return tree_map(to, base), tree_map(to, bank)


def _trees_equal(a, b) -> bool:
    from repro_torch.common.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) for x, y in zip(la, lb))


def _drift(a, b) -> float:
    """The largest |a - b| of any leaf, over that leaf's largest
    magnitude (0.0 where the trees are equal bit for bit)."""
    from repro_torch.common.tree import tree_leaves
    out = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if not torch.equal(x, y):
            d = (x.double() - y.double()).abs().max().item()
            out = max(out, d / max(y.double().abs().max().item(), 1e-30))
    return out


def _losses_drift(got: List[float], want: List[float]) -> float:
    return max((abs(x - y) for x, y in zip(got, want)), default=0.0)


def _check(errors: List[str], ok: bool, msg: str):
    if not ok:
        errors.append(msg)


def _serve_spec(cfg, n_clients: int):
    from repro_torch.config import ServeConfig
    from repro_torch.core.engine_spec import BankSpec, EngineSpec
    scfg = ServeConfig(n_clients=n_clients, max_seq=32, page_block=8,
                       pool_pages=8)
    return EngineSpec(cfg=cfg, banks=(BankSpec("tenants", _lora(),
                                               n_clients),),
                      serve=scfg, max_batch_per_client=2)


def _finetune_engine(cfg, base, device, max_jobs: int, **kw):
    from repro_torch.config import FinetuneConfig
    from repro_torch.core.engine_spec import EngineSpec
    from repro_torch.training.engine import FinetuneEngine
    return FinetuneEngine(EngineSpec(cfg=cfg, finetune=FinetuneConfig(
        max_jobs=max_jobs)), base, device=device, debug=True, **kw)


# ---------------------------------------------------------------------------
# fine-tuning scenario
# ---------------------------------------------------------------------------

def _make_jobs(cfg, n_jobs: int, steps: int, schedules: Dict[int, Dict],
               device):
    """Every job gets a FaultyStream (survivors with empty schedules) so
    the stacked batch trees agree across the bank."""
    from repro_torch.faults.plan import FaultyStream
    from repro_torch.training.job import FinetuneJob, make_job_stream
    jobs = []
    for i in range(n_jobs):
        stream = FaultyStream(make_job_stream(cfg, 2, 16, seed=i,
                                              device=device),
                              schedules.get(i, {}))
        jobs.append(FinetuneJob(acfg=_lora(), data=stream, batch_size=2,
                                seq_len=16, steps=steps, name=f"job{i}",
                                seed=i))
    return jobs


def _run_finetune(cfg, base, jobs, device, *, fault_hook=None):
    eng = _finetune_engine(cfg, base, device, 8, fault_hook=fault_hook)
    for j in jobs:
        eng.submit(j)
    done = eng.run()
    return eng, done


def finetune_scenario(seed: int, *, n_jobs: int = 6, steps: int = 8,
                      device="cuda") -> dict:
    """Stream faults (NaN batches, transient errors, exhaustion) plus
    injected admission allocation failures against a bank of jobs."""
    from repro_torch import resolve_device
    from repro_torch.faults.audit import check_conservation
    from repro_torch.faults.plan import AllocHook, FaultPlan

    dev = resolve_device(device)
    errors: List[str] = []
    # kinds weighted toward transients: a fatal fault ends its victim's
    # stream, so an all-fatal plan fires only a fraction of its events
    plan = FaultPlan(seed, n_tenants=n_jobs, n_faults=5 * n_jobs,
                     kinds=("stream_error", "stream_error", "nan_batch",
                            "stream_error", "stream_end"),
                     window=(0, steps - 1))
    alloc_at = {1, 3, 5}                    # admission attempts that fault
    cfg = _tiny_cfg()
    base, _ = _system(cfg, 1, seed, dev)

    clean_jobs = _make_jobs(cfg, n_jobs, steps, {}, dev)
    _, clean_done = _run_finetune(cfg, base, clean_jobs, dev)
    clean = {j.name: j for j in clean_done}

    schedules = {t: plan.stream_schedule(t) for t in range(n_jobs)}
    hook = AllocHook(alloc_at)
    jobs = _make_jobs(cfg, n_jobs, steps, schedules, dev)
    eng, done = _run_finetune(cfg, base, jobs, dev, fault_hook=hook)

    _check(errors, len(done) == n_jobs,
           f"finetune: {len(done)}/{n_jobs} jobs retired")
    loss_drift = state_drift = 0.0
    for j in done:
        ref = clean[j.name]
        loss_drift = max(loss_drift, _losses_drift(j.losses, ref.losses))
        if j.status == "finished":
            state_drift = max(state_drift,
                              _drift(j.result.adapter, ref.result.adapter),
                              _drift(j.result.opt, ref.result.opt))
            _check(errors, j.losses == ref.losses,
                   f"finetune: {j.name} losses diverged from clean run")
            _check(errors, _trees_equal(j.result.adapter, ref.result.adapter),
                   f"finetune: {j.name} adapter not bitwise clean")
            _check(errors, _trees_equal(j.result.opt, ref.result.opt),
                   f"finetune: {j.name} optimizer state not bitwise clean")
        else:
            # fatal fault / exhausted retries: the committed prefix must
            # still be bitwise clean (quarantine never commits a bad step)
            _check(errors, bool(schedules.get(int(j.name[3:]))),
                   f"finetune: {j.name} ended {j.status} with no fault "
                   "scheduled")
            _check(errors,
                   j.losses == ref.losses[:len(j.losses)],
                   f"finetune: {j.name} committed prefix diverged")
    _check(errors, hook.fired > 0, "finetune: no alloc faults fired")
    cons = check_conservation(eng)
    _check(errors, not cons, f"finetune: conservation: {cons}")

    fired_stream = sum(1 for t, sched in schedules.items()
                       for call in sched
                       if call < jobs[t].data.calls)
    injected = {"stream": fired_stream, "alloc": hook.fired}
    return {"scenario": "finetune", "injected": injected,
            "total": fired_stream + hook.fired,
            "engine_faults": eng.stats["faults"],
            "quarantined": eng.stats["quarantined"],
            "finished_early": eng.stats["finished_early"],
            "loss_drift": loss_drift, "state_drift": state_drift,
            "errors": errors}


def bank_rows_drift(cfg, acfg, S: int, *, steps: int = 2, seed: int = 0,
                    device="cuda") -> dict:
    """Bank-size invariance of the compact train step: job 0's losses and
    adapter / AdamW state over ``steps`` steps alone (a one-row bucket)
    against the same job at every position of buckets of 2, 4 and 8 rows
    (other jobs beside it; from 4 rows a padding row and a NaN row too).
    Returns ``{(rows, position): (loss drift, state drift)}`` for every
    placement where any bit differs (``_losses_drift`` / ``_drift``); empty
    where a row's bits never depend on its bucket."""
    from repro_torch import resolve_device
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.core import adapters, symbiosis
    from repro_torch.optim import adamw_init
    from repro_torch.training.job import make_job_stream

    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    to = lambda t: t.to(dev)                        # noqa: E731
    base = tree_map(to, symbiosis.init_system(cfg, acfg, 1, g,
                                              device="cpu")[0])
    step = symbiosis.make_compact_train_step(cfg, acfg)
    ads = []
    for i in range(8):
        a = adapters.init_adapter(cfg, acfg, torch.Generator().manual_seed(i),
                                  device="cpu")
        for leaf in tree_leaves(a):
            leaf.add_(torch.randn(leaf.shape, generator=g) * 0.02)
        ads.append(tree_map(to, a))
    streams = [make_job_stream(cfg, 2, S, seed=i, device=dev)
               for i in range(8)]
    hyper_of = (("lr", 1e-3), ("warmup", 1.0), ("total", 8.0), ("wd", 0.01),
                ("gnorm", 1.0))

    def run(layout):            # job per row: its slot; None pads, 7 is NaN
        R = len(layout)
        bank = tree_map(lambda *xs: torch.stack(xs), *ads)
        opt = adamw_init(bank)._replace(
            step=torch.zeros(8, dtype=torch.int32, device=dev))
        slots = torch.tensor([j or 0 for j in layout], dtype=torch.int32,
                             device=dev)
        live = torch.tensor([j is not None for j in layout], device=dev)
        losses = []
        for t in range(steps):
            rows = []
            for j in layout:
                b = dict(streams[j or 0].batch(t))
                b["mask"] = torch.full(b["labels"].shape, float(
                    "nan") if j == 7 else float(j is not None), device=dev)
                rows.append(b)
            batch = {k: torch.stack([b[k] for b in rows]) for k in rows[0]}
            hyper = {"step": torch.full((R,), t, dtype=torch.int32,
                                        device=dev)}
            hyper.update({k: torch.full((R,), v, device=dev)
                          for k, v in hyper_of})
            bank, opt, m = step(base, bank, opt, batch, slots, live, hyper)
            losses.append(m["loss"][layout.index(0)].item())
        return losses, [x[0].clone() for x in tree_leaves((bank, opt))]

    want_losses, want_state = run([0])
    out = {}
    for R in (2, 4, 8):
        for pos in range(R):
            rest = [(1, 2, 3, 4, 5, 6, 7)[k % 7] for k in range(R - 1)]
            if R >= 4:
                rest[0] = None
            losses, state = run(rest[:pos] + [0] + rest[pos:])
            drift = (_losses_drift(losses, want_losses),
                     _drift(state, want_state))
            if losses != want_losses or drift[1]:
                out[(R, pos)] = drift
    return out


# ---------------------------------------------------------------------------
# serving scenario
# ---------------------------------------------------------------------------

def _poison_client(bank, client: int):
    """NaN out one client's adapter rows (the nan_adapter fault kind), in a
    copy of the bank."""
    from repro_torch.common.tree import tree_map

    def leaf(x):
        x = x.clone()
        if x.shape[0] > client:
            x[client] = float("nan")
        return x

    return tree_map(leaf, bank)


def serving_scenario(seed: int, *, n_clients: int = 4,
                     reqs_per_client: int = 4, device="cuda") -> dict:
    """Poisoned-adapter (non-finite logits) faults, injected admission
    allocation failures and request-stream faults (a transient hiccup and
    a stream that runs dry) against a paged serving bank, with telemetry
    attached, so the quarantine / backoff / retry / reject trail is checked
    through the client-visible ``drain_events`` feed."""
    from repro_torch import resolve_device
    from repro_torch.faults.audit import check_conservation
    from repro_torch.faults.plan import AllocHook, FaultPlan, FaultyRequestStream
    from repro_torch.obs import Obs
    from repro_torch.serving.engine import Request, ServingEngine

    dev = resolve_device(device)
    errors: List[str] = []
    cfg = _tiny_cfg()
    spec = _serve_spec(cfg, n_clients)
    base, bank = _system(cfg, n_clients, seed, dev)
    plan = FaultPlan(seed + 1, n_tenants=n_clients, n_faults=4,
                     kinds=("nan_adapter",))
    # cap the victim set so at least two survivors exercise containment
    victims = set(sorted(plan.victims("nan_adapter"))[:max(1, n_clients - 2)])
    rng = np.random.default_rng(seed)
    prompts = [[rng.integers(1, cfg.vocab, (1, 6)).astype(np.int32)
                for _ in range(reqs_per_client)] for _ in range(n_clients)]

    # stream-fault victims: a SURVIVOR takes a transient hiccup (retried
    # after backoff, same prompt: must stay bitwise), and one nan victim's
    # stream runs dry (rejected at admission, never admitted)
    surv = sorted(set(range(n_clients)) - victims)
    s_err = surv[0]
    v_end = sorted(victims)[0]
    err_stream = FaultyRequestStream(prompts[s_err][0], {0: "stream_error"})
    end_stream = FaultyRequestStream(prompts[v_end][0], {0: "stream_end"})

    def submit_all(eng, streams=False):
        for i in range(reqs_per_client):
            for c in range(n_clients):
                stream = None
                if streams and i == 0 and c == s_err:
                    stream = err_stream
                elif streams and i == 0 and c == v_end:
                    stream = end_stream
                if stream is not None:
                    eng.submit(Request(client_id=c, prompt=None,
                                       prompt_stream=stream,
                                       max_new_tokens=4, arrive_tick=0))
                else:
                    eng.submit(Request(client_id=c,
                                       prompt=prompts[c][i].copy(),
                                       max_new_tokens=4, arrive_tick=0))

    def build(bank_tree, hook=None, obs=None):
        return ServingEngine(spec, base, [bank_tree], device=dev, debug=True,
                             fault_hook=hook, obs=obs)

    clean_eng = build(bank)
    submit_all(clean_eng)
    clean = clean_eng.run()
    # keyed by prompt bytes: a transient admission fault legally delays a
    # retried request by a tick, which can reorder retirement WITHIN a
    # client; the bitwise contract is per request, not per position
    clean_of = {}
    for r in clean:
        clean_of.setdefault(r.client_id, {})[r.prompt.tobytes()] = \
            r.generated.copy()

    poisoned = bank
    for v in victims:
        poisoned = _poison_client(poisoned, v)
    hook = AllocHook({1, 4, 7})
    obs = Obs()
    eng = build(poisoned, hook, obs=obs)
    submit_all(eng, streams=True)
    done = eng.run()

    got = {}
    for r in done:
        got.setdefault(r.client_id, []).append(r)
    for c in range(n_clients):
        rs = got.get(c, [])
        _check(errors, len(rs) == reqs_per_client,
               f"serving: client {c} retired {len(rs)}/{reqs_per_client}")
        if c in victims:
            _check(errors, all(r.status in ("quarantined", "rejected")
                               for r in rs),
                   f"serving: victim {c} produced non-quarantined requests")
        else:
            _check(errors, all(r.status == "ok" for r in rs),
                   f"serving: survivor {c} has non-ok requests")
            for r in rs:
                ref = clean_of[c].get(r.prompt.tobytes())
                _check(errors,
                       ref is not None and np.array_equal(r.generated, ref),
                       f"serving: survivor {c} stream diverged")
    _check(errors, hook.fired > 0, "serving: no alloc faults fired")
    _check(errors, err_stream.calls >= 2,
           "serving: stream_error request was never retried")
    _check(errors, end_stream.calls >= 1,
           "serving: stream_end request was never fetched")
    _check(errors,
           all(v in eng._quarantined_clients for v in victims),
           "serving: victims not client-quarantined after repeated faults")
    cons = check_conservation(eng)
    _check(errors, not cons, f"serving: conservation: {cons}")

    # the same containment trail must be observable through the
    # client-visible event feed
    ev = eng.drain_events()
    kinds = {e.kind for e in ev}
    for want in ("backoff", "retry", "quarantine", "reject"):
        _check(errors, want in kinds,
               f"serving: no {want!r} event in the telemetry feed")
    _check(errors,
           any(e.kind == "retry" and e.tenant == s_err for e in ev),
           "serving: stream_error retry not visible as a retry event")

    injected = {"nan_adapter": eng.stats["quarantined_requests"],
                "alloc": hook.fired,
                "stream_error": 1, "stream_end": 1}
    return {"scenario": "serving", "injected": injected,
            "total": sum(injected.values()),
            "engine_faults": eng.stats["faults"],
            "quarantined_clients": sorted(eng._quarantined_clients),
            "errors": errors}


# ---------------------------------------------------------------------------
# symbiotic interleave + kill/restore + checkpoint corruption
# ---------------------------------------------------------------------------

def symbiotic_scenario(seed: int, workdir: str, *, n_jobs: int = 4,
                       n_clients: int = 2, steps: int = 8,
                       device="cuda") -> dict:
    """Faulted fine-tuning interleaved with serving over ONE shared base;
    mid-run whole-engine checkpoint, kill, corrupt the newest checkpoint on
    disk, restore (it must fall back CRC-clean), and finish: the resumed
    run must match the uninterrupted one bit for bit."""
    from repro_torch import resolve_device
    from repro_torch.checkpoint import load_engine_state
    from repro_torch.faults.audit import check_conservation
    from repro_torch.faults.plan import FaultPlan, corrupt_flip, corrupt_truncate
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.training.service import SymbiosisEngine

    dev = resolve_device(device)
    errors: List[str] = []
    cfg = _tiny_cfg()
    spec = _serve_spec(cfg, n_clients)
    base, bank = _system(cfg, n_clients, seed, dev)
    plan = FaultPlan(seed + 2, n_tenants=n_jobs, n_faults=3 * n_jobs,
                     kinds=("stream_error", "stream_error", "nan_batch"),
                     window=(0, steps - 1))
    schedules = {t: plan.stream_schedule(t) for t in range(n_jobs)}
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab, (1, 6)).astype(np.int32)
               for _ in range(n_clients)]

    def build():
        serving = ServingEngine(spec, base, [bank], device=dev, debug=True)
        return SymbiosisEngine(serving=serving, finetune=_finetune_engine(
            cfg, base, dev, 4))

    def submit_all(sym):
        for c in range(n_clients):
            sym.submit(Request(client_id=c, prompt=prompts[c].copy(),
                               max_new_tokens=6))
        for j in _make_jobs(cfg, n_jobs, steps, schedules, dev):
            sym.submit(j)

    def finish(sym):
        reqs, jobs = sym.run()
        fired = sum(1 for j in jobs for call in j.data.schedule
                    if call < j.data.calls)
        return ({r.client_id: r.generated.copy() for r in reqs},
                {j.name: (j.status, list(j.losses),
                          None if j.result is None else j.result.adapter)
                 for j in jobs}, fired)

    # uninterrupted faulted run (the resume oracle)
    sym_a = build()
    submit_all(sym_a)
    for _ in range(2):
        sym_a.tick()
    ref_reqs, ref_jobs, fired_stream = finish(sym_a)

    # interrupted twin: same 2 ticks, checkpoint twice, corrupt the newest
    ckdir = os.path.join(workdir, "engine_ckpt")
    sym_b = build()
    submit_all(sym_b)
    sym_b.tick()
    sym_b.checkpoint(ckdir)                          # seq 0 (stale)
    sym_b.tick()
    seq = sym_b.checkpoint(ckdir)                    # seq 1 (resume point)
    del sym_b                                        # "kill"

    # a corrupted LATER checkpoint must be skipped by CRC, falling back to
    # the newest valid one (seq 1)
    victim_new = os.path.join(ckdir, f"engine_{seq + 1:08d}.ckpt")
    shutil.copy(os.path.join(ckdir, f"engine_{seq:08d}.ckpt"), victim_new)
    corrupt_flip(victim_new, seed=seed)
    victim_new2 = os.path.join(ckdir, f"engine_{seq + 2:08d}.ckpt")
    shutil.copy(os.path.join(ckdir, f"engine_{seq:08d}.ckpt"), victim_new2)
    corrupt_truncate(victim_new2)
    got_seq, _ = load_engine_state(ckdir)
    _check(errors, got_seq == seq,
           f"symbiotic: restore picked seq {got_seq}, wanted last-good {seq}")

    sym_c = build()
    restored = sym_c.restore(ckdir)
    _check(errors, restored == seq,
           f"symbiotic: restored seq {restored} != {seq}")
    got_reqs, got_jobs, _ = finish(sym_c)

    _check(errors, set(got_reqs) == set(ref_reqs),
           "symbiotic: restored run finished a different request set")
    for c, gen in ref_reqs.items():
        _check(errors, np.array_equal(got_reqs.get(c), gen),
               f"symbiotic: client {c} stream diverged after restore")
    _check(errors, set(got_jobs) == set(ref_jobs),
           "symbiotic: restored run finished a different job set")
    for name, (status, losses, adapter) in ref_jobs.items():
        g_status, g_losses, g_adapter = got_jobs[name]
        _check(errors, g_status == status and g_losses == losses,
               f"symbiotic: job {name} trajectory diverged after restore")
        if adapter is not None:
            _check(errors, _trees_equal(g_adapter, adapter),
                   f"symbiotic: job {name} adapter not bitwise after restore")
    for eng in (sym_c.serving, sym_c.finetune):
        cons = check_conservation(eng)
        _check(errors, not cons, f"symbiotic: conservation: {cons}")

    injected = {"stream": fired_stream, "ckpt_corrupt": 2}
    return {"scenario": "symbiotic", "injected": injected,
            "total": fired_stream + 2,
            "restored_seq": restored, "errors": errors}


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def run_sweep(seed: int = 0, workdir: Optional[str] = None,
              min_faults: int = 30, min_kinds: int = 4,
              device="cuda") -> dict:
    """Run every scenario and return the containment report (never raises
    on contract violations: check ``report["ok"]`` / ``report["errors"]``)."""
    import tempfile
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="chaos_")
    results = [finetune_scenario(seed, device=device),
               serving_scenario(seed, device=device),
               symbiotic_scenario(seed, workdir, device=device)]
    kinds = set()
    total = 0
    errors: List[str] = []
    for r in results:
        total += r["total"]
        kinds |= {k for k, n in r["injected"].items() if n > 0}
        errors += r["errors"]
    if total < min_faults:
        errors.append(f"only {total} faults fired (need >= {min_faults})")
    if len(kinds) < min_kinds:
        errors.append(f"only {len(kinds)} fault kinds fired "
                      f"(need >= {min_kinds})")
    return {"seed": seed, "total_injected": total, "kinds": sorted(kinds),
            "scenarios": results, "errors": errors, "ok": not errors}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="seeded fault-injection chaos sweep of the port")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", type=str, default=None,
                    help="write the JSON containment report here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    report = run_sweep(args.seed, device=args.device)
    out = json.dumps(report, indent=2, default=str)
    if args.report:
        with open(args.report, "w") as f:
            f.write(out + "\n")
    print(out)
    if not report["ok"]:
        print("\nchaos sweep FAILED:\n  " + "\n  ".join(report["errors"]))
        return 1
    print(f"\nchaos sweep OK: {report['total_injected']} faults across "
          f"{len(report['kinds'])} kinds, all contained")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
