"""Invariant-checker CLI: ``python -m repro_torch.analysis --all [--json]``.

Runs every pass over the standard hot-path targets (``targets.py``) and
exits nonzero if any error-severity violation survives. It runs on the
card unless ``--device cpu`` is given (the kernels' plain versions); on a
machine with no card, without ``--device cpu``, it raises.

  --static     in-place / poolcopy / moe-remat / frozen-base passes only
  --buckets    engine workload under the trace-count guard only
  --isolation  differential client/row isolation probes only
  --mesh       JAX's collective audit: refused, the port serves on one
               device
  --all        everything (the default)
  --json       machine-readable report on stdout
  --out PATH   also write the JSON report to PATH
"""
import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--all", action="store_true", help="run every pass")
    ap.add_argument("--static", action="store_true")
    ap.add_argument("--buckets", action="store_true")
    ap.add_argument("--isolation", action="store_true")
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--out", default=None, help="write JSON report here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh:
        raise SystemExit("--mesh is not ported yet: the port serves on one "
                         "device")
    if not (args.all or args.static or args.buckets or args.isolation):
        args.all = True

    from repro_torch import resolve_device
    from repro_torch.analysis import runner
    from repro_torch.analysis.report import render_report, report_payload
    from repro_torch.analysis.targets import all_targets

    dev = resolve_device(args.device)
    results = []
    targets = (all_targets(dev) if args.all or args.static or args.isolation
               else [])
    if args.all or args.static:
        results.extend(runner.run_static(targets))
    if args.all or args.buckets:
        results.append(runner.run_buckets(dev))
    if args.all or args.isolation:
        results.extend(runner.run_isolation(targets))

    payload = report_payload(results)
    print(render_report(results, as_json=args.json))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
    return 0 if payload["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
