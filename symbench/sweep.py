#!/usr/bin/env python3
"""Find the highest arrival rate an open-loop serving cell sustains: run the
cell's mix at each rate (fill, then a window of ``--seconds``) and print
per rate the requests due, admitted and still waiting at the window's
close, the admission wait and the latency tails. The knee is the last rate
whose queue does not grow; the cell's mix is then set to about four fifths
of it.

    python3 symbench/sweep.py --workload <open-loop cell> \\
        --rates 0.6,0.8,1.0,1.2 --seconds 30 --seed 7
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, os.path.join(ROOT, "src")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    from bench import manifest
    man = manifest.load(ROOT)
    cell = manifest.workload(man, args.workload)
    arch = manifest.config(man, cell["config"], ROOT)
    mix = manifest.traffic(cell["traffic"])
    import torch
    if not torch.cuda.is_available():
        print("sweep.py needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.build(mix["kernels"])
    log = lambda m: print(f"[sweep] {m}", file=sys.stderr, flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        m = dict(mix, arrivals=dict(mix["arrivals"], rate_per_s=rate))
        try:
            w, res, _ = manifest.loop(mix).run(
                arch, m, cell["name"], args.seed, args.seconds, False,
                "cuda", log, reference=False)
        except torch.OutOfMemoryError:
            # the queue outgrew the card: past the knee
            print(json.dumps({"rate": rate, "out_of_memory": True}),
                  flush=True)
            torch.cuda.empty_cache()
            break
        out = {"rate": rate, "due": len(w.due),
               "admitted": sum(1 for r, _ in w.due if r.admit_t),
               "waiting_at_end": w.extra["waiting_at_end"]}
        for name in ("queue_wait_p90_ms", "ttft_p90_ms", "tpot_p90_ms",
                     "serve_tokens_per_s", "decode_tick_ms"):
            out[name] = manifest.reader(name)(w)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
