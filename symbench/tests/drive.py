"""Drive ``run.py``'s whole run on the CPU at a tiny size: the look for a
card, the configuration files and the kernel build are patched, everything
else (the loops, the metric readers, the reference and the verdict) runs
as on the chip."""
from __future__ import annotations

import contextlib
import copy
import io
import json

import tiny

# limits for the tiny fp32 cells: a sound run reads ~1e-6 (fp32 on both
# sides), so these leave it three orders of room and catch any fault
TINY_LIMITS = {"served_logit_gap": 1e-3, "served_logit_err": 1e-3,
               "loss_gap": 1e-4,
               "first_grad_gap": 1e-3, "change_gap": 1e-3}
# the serving cells of the tiny runs (no serving cell is in BENCHMARK.json
# yet), with the metrics such a cell would report
SERVE_CELLS = [
    {"name": "tiny-serve-open", "config": "granite-3-8b",
     "traffic": "serve_open", "chips": 1},
    {"name": "tiny-serve-backlog", "config": "deepseek-moe-16b",
     "traffic": "serve_backlog", "chips": 1}]
SERVE_METRICS = [
    {"name": "ttft_p90_ms", "unit": "ms", "workloads": ["tiny-serve-open"]},
    {"name": "tpot_p90_ms", "unit": "ms",
     "workloads": ["tiny-serve-open", "tiny-serve-backlog"]},
    {"name": "serve_tokens_per_s", "unit": "tokens/s",
     "workloads": ["tiny-serve-backlog"]}]


def manifest_with_serving():
    """BENCHMARK.json with the tiny serving cells and their metrics added."""
    from bench import manifest
    man = copy.deepcopy(manifest.load())
    man["workloads"] += SERVE_CELLS
    man["end_to_end"] += SERVE_METRICS
    return man


def run_cell(monkeypatch, cell, seed=4000000001, seconds=2.0, trace=0):
    """(exit code, result dict or None, stderr text) of one tiny run."""
    import torch

    import run
    from bench import check, manifest
    from repro_torch.kernels import _build
    for name, value in (("is_available", lambda: True),
                        ("device_count", lambda: 1),
                        ("get_device_name", lambda i=0: "tiny CPU stand-in"),
                        ("synchronize", lambda *a: None),
                        ("max_memory_allocated", lambda *a: 0),
                        ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(_build, "build", lambda names: {})
    man = manifest_with_serving()
    monkeypatch.setattr(manifest, "load", lambda root=None: man)
    monkeypatch.setattr(manifest, "config",
                        lambda man, name, root=None: tiny.arch(name))
    monkeypatch.setattr(manifest, "traffic", lambda name: (
        tiny.serve_mix(name) if name.startswith("serve")
        else tiny.train_mix(name)))
    monkeypatch.setattr(check, "limits", lambda cell: dict(TINY_LIMITS))
    monkeypatch.setattr(run, "DEVICE", "cpu")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
