#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 symbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. The cell, its configuration file and its traffic mix are found by name
through ``BENCHMARK.json``; with ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones. The last line of
standard output is the result (JSON); standard error ends with each number
compared against its limit. Exit codes: 2 without the cards, 3 when the
JAX package was loaded.
"""
import time

PERF0 = time.perf_counter()
BOOT0 = time.clock_gettime(time.CLOCK_BOOTTIME)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, os.path.join(ROOT, "src")]
BANNED = ("jax", "jaxlib", "flax", "repro")
DEVICE = "cuda"


def process_age() -> float:
    """Seconds from this process's start to BOOT0 (the interpreter's own
    start-up included)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(0.0, BOOT0 - started)
    except (OSError, ValueError, IndexError):
        return 0.0


def log(msg):
    print(f"[symbench {time.perf_counter() - PERF0:8.3f}] {msg}",
          file=sys.stderr, flush=True)


def banned_modules():
    return sorted(n for n in sys.modules if n.split(".")[0] in BANNED)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import manifest
    man = manifest.load(ROOT)
    cell = manifest.workload(man, args.workload)
    arch = manifest.config(man, cell["config"], ROOT)
    mix = manifest.traffic(cell["traffic"])

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"{cell['chips']} CUDA device(s) needed, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " found")
        return 2
    from bench import check, flops
    from repro_torch.kernels import _build
    _build.build(mix["kernels"])
    kind = torch.cuda.get_device_name(0)
    age = process_age()
    w, res, numbers = manifest.loop(mix).run(
        arch, mix, cell["name"], args.seed, args.seconds, bool(args.trace),
        DEVICE, log)
    bad = banned_modules()
    if bad:
        log(f"the JAX package or JAX was loaded: {bad}")
        return 3
    w.peak = flops.peaks(kind)
    setup_s = age + (w.t0 - PERF0)
    metrics = {}
    for m in manifest.metrics_of(man, cell["name"], bool(args.trace)):
        value = setup_s if m["name"] == "setup_s" else \
            manifest.reader(m["name"])(w)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": res["peak"]}
    ok, checks = check.verdict(numbers, check.limits(cell["name"]))
    out = {"correct": ok, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device}
    if args.trace and w.trace is not None:
        from bench import trace
        device.update(busy_s=trace.busy_s(w.trace),
                      window_s=w.trace.window_s)
        out["breakdown"] = {"device_ops": trace.device_ops(w.trace),
                            "idle_gaps": trace.idle_gaps(w.trace_host
                                                         or w.trace)}
    out["checks"] = checks
    log(f"setup_s {setup_s:.3f}; window {w.seconds:.3f} s; " + ", ".join(
        f"{k} {v['value']:.6g} {v['unit']}" for k, v in metrics.items()))
    for name, c in checks.items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
