"""CLI of the port's telemetry (``python -m repro.obs``'s).

Validate telemetry files (exit 1 on malformed or partial input)::

    PYTHONPATH=src python -m repro_torch.obs --check telemetry.jsonl metrics.prom

Write a small telemetry sample: a tiny obs-enabled serving run with one
injected request-stream fault, so the events cover the backoff and retry
path (on the card unless ``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.obs --demo --out obs_demo [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List


def _demo(out_dir: str, device: str) -> List[str]:
    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.config import DENSE, AdapterConfig, ModelConfig, ServeConfig
    from repro_torch.core import symbiosis
    from repro_torch.core.engine_spec import BankSpec, EngineSpec
    from repro_torch.faults.plan import FaultyRequestStream
    from repro_torch.obs import Obs, export
    from repro_torch.serving.engine import Request, ServingEngine

    dev = resolve_device(device)
    cfg = ModelConfig(name="tiny-obs", arch=DENSE, n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                      dtype="float32", param_dtype="float32")
    acfg = AdapterConfig(method="lora", rank=4, alpha=8.0, targets=("q", "v"))
    n_clients = 2
    scfg = ServeConfig(n_clients=n_clients, max_seq=32, page_block=8,
                       pool_pages=8)
    base, bank = symbiosis.init_system(
        cfg, acfg, n_clients, torch.Generator(device=dev).manual_seed(0),
        device=dev)
    spec = EngineSpec(cfg=cfg, banks=(BankSpec("tenants", acfg, n_clients),),
                      serve=scfg, max_batch_per_client=2)
    obs = Obs()
    eng = ServingEngine(spec, base, [bank], device=dev, obs=obs)
    rng = np.random.default_rng(0)
    for c in range(n_clients):
        p = rng.integers(1, cfg.vocab, (1, 6)).astype(np.int32)
        eng.submit(Request(client_id=c, prompt=p, max_new_tokens=4))
    # one stream-backed request whose first fetch faults, so the demo
    # telemetry exercises the backoff/retry event path
    p = rng.integers(1, cfg.vocab, (1, 6)).astype(np.int32)
    eng.submit(Request(client_id=0, prompt=None, max_new_tokens=4,
                       prompt_stream=FaultyRequestStream(
                           p, {0: "stream_error"})))
    eng.run()
    return [export.write_jsonl(os.path.join(out_dir, "telemetry.jsonl"), obs),
            export.write_prometheus(os.path.join(out_dir, "metrics.prom"),
                                    obs)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="validate / demo the port's telemetry files")
    ap.add_argument("--check", nargs="+", metavar="FILE", default=None,
                    help="validate telemetry files (.jsonl / .prom); "
                         "exits non-zero on malformed or partial input")
    ap.add_argument("--demo", action="store_true",
                    help="run a tiny obs-enabled serving workload and "
                         "write sample telemetry")
    ap.add_argument("--out", default="obs_demo", metavar="DIR",
                    help="output directory for --demo (default: obs_demo)")
    ap.add_argument("--device", default="cuda",
                    help="device of the --demo run (default: cuda)")
    args = ap.parse_args(argv)
    if not args.check and not args.demo:
        ap.error("nothing to do: pass --check FILE... and/or --demo")
    rc = 0
    if args.demo:
        for p in _demo(args.out, args.device):
            print(f"wrote {p}")
    if args.check:
        from repro_torch.obs.export import check_file
        problems: List[str] = []
        for p in args.check:
            problems += check_file(p)
        for msg in problems:
            print(f"CHECK FAIL: {msg}", file=sys.stderr)
        if problems:
            rc = 1
        else:
            print(f"ok: {len(args.check)} telemetry file(s) valid")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
