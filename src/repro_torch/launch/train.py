"""Multi-job fine-tuning CLI of the port (``repro.launch.train``): a thin
front end of the FinetuneEngine (fine-tuning as a service) on one device,
the card by default. ``--peft mixed`` cycles LoRA / IA3 / prefix across
jobs (each with the method's ``DEFAULT_TARGETS``): heterogeneous banks
sharing one engine and one base. ``--ckpt-dir`` writes every finished
job's adapter and optimizer state (``checkpoint.save_job_state``, the JAX
package's format):

  PYTHONPATH=src python -m repro_torch.launch.train --full-size --clients 4 \
      --steps 20 --seq 256 --batch 2 [--peft lora|ia3|prefix|mixed] \
      [--ckpt-dir DIR]
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --full-size \
      --arch deepseek-moe-16b --clients 4 --steps 10 --seq 256
  PYTHONPATH=src python -m repro_torch.launch.train --full-size \
      --arch llava-next-mistral-7b --clients 2 --batch 1 --remat
  PYTHONPATH=src python -m repro_torch.launch.train --full-size \
      --arch rwkv6-7b --clients 4 --steps 10 --seq 256 --batch 1
  PYTHONPATH=src python -m repro_torch.launch.train --full-size \
      --arch whisper-small --clients 4 --steps 10 --seq 128

Every ``--arch`` of the port trains: the dense, MoE and VLM families (an
MoE model's experts drop-free, as the JAX engine's; a VLM job's batches
lead with the stubbed image prefix, ``n_frontend_tokens`` positions), the
hybrid and RWKV (``--seq`` within the recurrence's chunk contract: at
most 256 tokens or a multiple of 256 on the hybrid, 128 on RWKV), and
the encoder-decoder (whisper-small: each job's batches carry the stubbed
audio frames, ``n_frontend_tokens`` of them per row, beside ``--seq``
decoder tokens; a reduced config has ``--layers`` layers in each stack
and 16 frames).
Without ``--full-size`` the model is a reduced config (``--layers``,
``--d-model``). ``--remat`` recomputes each layer in the backward.
``--obs DIR`` attaches telemetry and writes ``telemetry.jsonl`` and
``metrics.prom`` into DIR after the run. ``--mesh`` is not ported yet and
raises. Weights are random, drawn from ``--seed``; each job's data is the
synthetic Markov stream of its index.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_job_state
from repro_torch.config import (TRAIN_FAMILIES, AdapterConfig, FinetuneConfig,
                                check_family)
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.adapters import DEFAULT_TARGETS
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.models import get_model
from repro_torch.training import FinetuneEngine, FinetuneJob, make_job_stream


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen3-4b")
    ap.add_argument("--clients", type=int, default=4,
                    help="concurrent fine-tuning jobs")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=2,
                    help="per-job batch (paper uses 2)")
    ap.add_argument("--peft", default="lora",
                    choices=("lora", "ia3", "prefix", "mixed"))
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--full-size", action="store_true",
                    help="the full config; default: a reduced one")
    ap.add_argument("--no-memory-optimized", action="store_true")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer body in the backward")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--mesh", nargs=2, type=int, default=None,
                    metavar=("DATA", "MODEL"))
    ap.add_argument("--obs", default=None, metavar="DIR",
                    help="attach telemetry and write telemetry.jsonl + "
                         "metrics.prom into DIR at exit")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.mesh:
        raise SystemExit("--mesh is not ported yet: the port trains on one "
                         "device")

    cfg = get_config(args.arch)
    try:
        check_family(cfg, TRAIN_FAMILIES, "fine-tunes")
    except ValueError as e:
        raise SystemExit(f"--arch {args.arch}: {e}")
    dev = resolve_device(args.device)
    if not args.full_size:
        cfg = cfg.reduced(n_layers=args.layers, d_model=args.d_model)
    base = get_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(args.seed), dev)
    fcfg = FinetuneConfig(max_jobs=args.clients,
                          memory_optimized=not args.no_memory_optimized,
                          remat=args.remat)
    obs = None
    if args.obs is not None:
        from repro_torch.obs import Obs
        obs = Obs()
    engine = FinetuneEngine(EngineSpec(cfg=cfg, finetune=fcfg), base,
                            device=dev, obs=obs)
    methods = (("lora", "ia3", "prefix") if args.peft == "mixed"
               else (args.peft,))
    jobs = []
    for c in range(args.clients):
        method = methods[c % len(methods)]
        acfg = AdapterConfig(method=method, rank=args.rank,
                             targets=DEFAULT_TARGETS[method])
        jobs.append(FinetuneJob(
            acfg=acfg, data=make_job_stream(cfg, args.batch, args.seq, seed=c,
                                            device=dev),
            batch_size=args.batch, seq_len=args.seq, steps=args.steps,
            lr=args.lr, warmup_steps=max(1, args.steps // 10),
            microbatch=args.microbatch, seed=c, name=f"{method}-{c}"))
        engine.submit(jobs[-1])

    print(f"[train] {cfg.name} on {dev} | {args.clients} jobs x {args.peft} "
          f"(rank {args.rank}) | seq {args.seq} batch {args.batch}")
    t0 = time.perf_counter()
    tick = 0
    while engine.pending():
        engine.train_tick()
        tick += 1
        if tick % max(1, args.steps // 10) == 0 or not engine.pending():
            losses = [round(j.losses[-1], 3) for j in jobs if j.losses]
            tok_s = engine.stats["train_tokens"] / (time.perf_counter() - t0)
            print(f"  tick {tick:4d} loss/job={losses} ({tok_s:,.0f} tok/s)")
    first = float(np.mean([j.result.losses[0] for j in jobs]))
    last = float(np.mean([j.result.losses[-1] for j in jobs]))
    print(f"[train] done: mean loss {first:.3f} -> {last:.3f} "
          f"({100 * (first - last) / first:.0f}% drop) in "
          f"{time.perf_counter() - t0:.1f}s | banks={len(engine._banks)} "
          f"steps={engine.stats['train_steps']}")
    if args.ckpt_dir:
        for j in jobs:
            save_job_state(args.ckpt_dir, j.result.step, j.result.adapter,
                           j.result.opt, name=j.name, cfg=cfg)
        print(f"[train] per-job checkpoints -> "
              f"{args.ckpt_dir}/step_{jobs[0].result.step:08d}")
    if obs is not None:
        from repro_torch.obs import write_files
        print("[train] telemetry written to %s and %s"
              % write_files(obs, args.obs))
    return first, last


if __name__ == "__main__":
    main()
