"""Multi-tenant serving CLI of the port (``repro.launch.serve``'s, for the
dense, MoE, VLM, hybrid and RWKV families; whisper-small is refused).

Serves a bank of LoRA clients against one shared base with the port's
ServingEngine, on the card by default. With no ``--page-block`` (0, as in
JAX) the KV cache is the dense layout, one ``max_seq``-deep row per slot,
decoded by the masked bank-wide step; ``--page-block N`` serves N-token
pages through the compacted step:

  PYTHONPATH=src python -m repro_torch.launch.serve --full-size
  PYTHONPATH=src python -m repro_torch.launch.serve --full-size --page-block 16
  PYTHONPATH=src python -m repro_torch.launch.serve --full-size --page-block 16 --kv-quant
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b --full-size --page-block 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-next-mistral-7b --full-size --page-block 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b --full-size --page-block 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --full-size

An MoE model routes drop-free (exact); a VLM is served as its text
backbone, as JAX's engine serves it (no image prefix). A hybrid (Jamba)
prefills one request per call at its true length, within JAX's chunk
contract (a prompt of at most 256 tokens, or a multiple of 256), and its
layout line says what the engine runs (``--kv-quant`` is dropped, as in
JAX). jamba-v0.1-52b at full size is about 103 GB in bf16: its full depth
fits no single 80 GB card. RWKV (rwkv6-7b, about 15 GB in bf16 at full
depth) keeps an O(1) state per slot and no K/V: its prompts prefill one
request per call at their true length (at most 128 tokens, or a multiple
of 128), and ``--page-block`` and ``--kv-quant`` are dropped, as in JAX,
so the layout line reports ``dense``. The encoder-decoder family
(``--arch whisper-small``) is refused with ``ValueError`` before anything
is built: its prefill needs frames, and the engine's requests carry
tokens only (JAX's CLI raises ``KeyError: 'frames'`` at its first
admission).

``--device cpu`` runs the reduced config on the CPU through the kernels'
plain versions. Weights are random, drawn from ``--seed``. ``--obs DIR``
attaches telemetry and writes ``telemetry.jsonl`` and ``metrics.prom``
into DIR after the run (check them with ``python -m repro_torch.obs
--check``). After the run it prints the scheduler-simulated timeline of
the finished requests under ``--policy`` (``simulate_policy``).
``--privacy`` is refused: JAX's CLI declares it and reads it nowhere,
and a client turns §3.8 on through its own context
(``virtlayer.make_client_ctx(privacy_noise=...)`` over an adapter tree
from ``attach_privacy``), so a switch that did nothing would serve without
noise silently. ``--mesh`` is declared as in JAX and exits "not ported
yet".
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import AdapterConfig, ServeConfig, check_family
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import symbiosis
from repro_torch.core.engine_spec import BankSpec, EngineSpec
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="granite-3-8b")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--policy", default="opportunistic",
                    choices=("lockstep", "nolockstep", "opportunistic"))
    ap.add_argument("--stagger", type=int, default=0,
                    help="ticks between request arrivals (mid-stream joins)")
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--page-block", type=int, default=0,
                    help="tokens per KV page (0 = dense KV cache)")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="pages per client pool (0 = full provisioning)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV entries with per-head f32 scales")
    ap.add_argument("--privacy", action="store_true",
                    help="refused: privacy is a client context")
    ap.add_argument("--mesh", nargs=2, type=int, default=None,
                    metavar=("DATA", "MODEL"))
    ap.add_argument("--obs", default=None, metavar="DIR",
                    help="attach telemetry and write telemetry.jsonl + "
                         "metrics.prom into DIR at exit")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.privacy:
        raise SystemExit("--privacy is not an engine switch: a client turns "
                         "privacy on through its context, "
                         "repro_torch.core.virtlayer.make_client_ctx("
                         "privacy_noise=...) over an adapter tree from "
                         "attach_privacy")
    if args.mesh:
        raise SystemExit("--mesh is not ported yet: the port serves on one "
                         "device")

    cfg = get_config(args.arch)
    check_family(cfg, frameless="the serve CLI")
    dev = resolve_device(args.device)
    if not args.full_size:
        cfg = cfg.reduced()
    acfg = AdapterConfig(method="lora", rank=8, targets=("q", "v"))
    scfg = ServeConfig(n_clients=args.clients, policy=args.policy,
                       max_seq=args.prompt_len + args.max_new + 8,
                       page_block=args.page_block, pool_pages=args.pool_pages,
                       kv_quant=args.kv_quant, seed=args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    base, bank = symbiosis.init_system(cfg, acfg, args.clients, gen,
                                       device=dev,
                                       adapter_dtype=getattr(torch, cfg.dtype))
    spec = EngineSpec(cfg=cfg, banks=(BankSpec("tenants", acfg,
                                               capacity=args.clients),),
                      serve=scfg, max_batch_per_client=args.batch)
    obs = None
    if args.obs is not None:
        from repro_torch.obs import Obs
        obs = Obs()
    eng = ServingEngine(spec, base, [bank], device=dev, obs=obs)

    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        eng.submit(Request(
            client_id=i % args.clients,
            prompt=rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
            .astype(np.int32),
            max_new_tokens=args.max_new, arrive_tick=i * args.stagger))
    kv = (f"paged(block={scfg.page_block}, pool={eng._pool_pages})"
          if eng._paged else "dense")
    print(f"[serve] {cfg.name} on {dev} | {args.clients} clients | "
          f"{args.requests} requests | policy={args.policy} | "
          f"kv={kv}{'+int8' if eng._quant else ''}")
    t0 = time.perf_counter()
    done = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total = sum(r.generated.size for r in done)
    print(f"[serve] {len(done)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:,.0f} tok/s) | engine stats: {eng.stats}")
    sim = eng.simulate_policy(done)
    print(f"[serve] policy timeline ({args.policy}): {sim.summary()}")
    if obs is not None:
        from repro_torch.obs import write_files
        print("[serve] telemetry written to %s and %s"
              % write_files(obs, args.obs))
    return done


if __name__ == "__main__":
    main()
