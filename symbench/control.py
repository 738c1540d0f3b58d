#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's own on many seeds, the
fp8 control's (the reference computed with every base product in float8
e4m3, put in the program's place) and, for fine-tuning, a planted fault's.

    python3 symbench/control.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 51]

Serving cells run the cell as ``run.py`` does (set-up, fill, a window of
``--seconds``) and then read, over the same sampled requests, both the
served tokens' gap and the gap of the token the control puts first.
Fine-tuning cells need no window: each seed builds the cell, runs its
set-up steps and holds them against the reference; a control seed also
holds the control's steps against it, and a fault seed a program whose
data leaves half of every batch out of the loss. One JSON line per seed.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, os.path.join(ROOT, "src")]


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    from bench import manifest
    man = manifest.load(ROOT)
    cell = manifest.workload(man, args.workload)
    arch = manifest.config(man, cell["config"], ROOT)
    mix = manifest.traffic(cell["traffic"])
    import torch
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.build(mix["kernels"])
    log = lambda m: print(f"[control] {m}", file=sys.stderr, flush=True)
    seconds = args.seconds or man["run_seconds"]
    loop = manifest.loop(mix)
    for seed in args.seeds:
        out = loop.readings(arch, mix, cell["name"], seed,
                            seed in args.control_seeds,
                            seed in args.fault_seeds, seconds, "cuda", log)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
