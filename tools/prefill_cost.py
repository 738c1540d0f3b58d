#!/usr/bin/env python3
"""Per-client prefill, copy-on-write and dispatch cost at the serving
phases' shapes.

    python3 tools/prefill_cost.py [TREE]

Needs one CUDA device and ``nvcc``. Imports the port from ``TREE/src``
(default: this repository), so two checkouts can be compared in turns on
one card. Weights are random, drawn from fixed seeds.

* The engine's per-client admission (``ServingEngine._client_prefill_call``:
  the masked prefill of one client's slot rows, its logits brought to the
  host) at ``chip_smoke.py``'s shapes: phase 9a (granite-3-8b, 40 layers
  bf16, the dense layout [L, C, B, T, K, hd] = [40, 4, 2, 512, 8, 128], a
  256-token bucket), phase 15b (jamba-v0.1-52b at full width, 2 of its 4
  periods, the dense layout with max_seq 1024, a 256-token prompt) and
  phase 17b (rwkv6-7b, 32 layers, 8 clients of 4 slots, max_seq 512, a
  128-token prompt). One slot of client 1 is admitted. Two warm calls,
  then ten, each between synchronisations: the median ms on the host's
  clock, and the device memory the call held beyond what was allocated
  before it (the peak).
* The copy-on-write of one tail page (``symbiosis.make_page_copy``) over
  phase 8's granite pools ([40, 4 x 64 pages, 16, 8, 128] bf16, K and V),
  with the page ids as the engine passes them: 200 calls back to back (the
  host's us per call, no synchronisation inside), then 50 between CUDA
  events (device ms per call).
* Where the tree has ``repro_torch.analysis``: ``tracecount.dispatch`` with
  telemetry attached, over phase 4's decode-step arguments (granite's base,
  a 4-client bank, its paged caches), against the plain call: 2,000 calls
  each, seven times, the median us per call.

The last line is one JSON object with every number printed above it.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

TREE = Path(sys.argv[1] if len(sys.argv) > 1
            else Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(TREE / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

DEV = "cuda"
OUT: dict = {"tree": str(TREE)}


def log(msg):
    print(msg, flush=True)


def system(cfg, acfg, n_clients, seed):
    from repro_torch.core import symbiosis
    g = torch.Generator(device=DEV).manual_seed(seed)
    return symbiosis.init_system(cfg, acfg, n_clients, g, device=DEV,
                                 adapter_dtype=torch.bfloat16)


def free():
    gc.collect()
    torch.cuda.empty_cache()


def admission(label, cfg, acfg, scfg, max_b, S_pad, length):
    """Median host ms and peak bytes of one client's masked prefill."""
    from repro_torch.core.engine_spec import BankSpec, EngineSpec
    from repro_torch.serving.engine import ServingEngine
    base, bank = system(cfg, acfg, scfg.n_clients, seed=3)
    spec = EngineSpec(cfg=cfg, banks=(BankSpec("tenants", acfg,
                                               scfg.n_clients),),
                      serve=scfg, max_batch_per_client=max_b)
    eng = ServingEngine(spec, base, [bank], device=DEV)
    rng = np.random.default_rng(0)
    toks = np.zeros((max_b, S_pad), np.int32)
    toks[0, :length] = rng.integers(0, cfg.vocab, length)
    mask = np.zeros((max_b,), bool)
    mask[0] = True
    lengths = np.where(mask, length, 0).astype(np.int32)
    times, peaks = [], []
    for i in range(12):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng._client_prefill_call(1, toks, lengths, mask)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
            peaks.append(torch.cuda.max_memory_allocated() - before)
    slot_bytes = sum(t.numel() * t.element_size() for t in _slot_leaves(eng))
    ms, peak = statistics.median(times), max(peaks)
    log(f"[{label}] {cfg.name}, {cfg.n_layers} layers: per-client prefill "
        f"(S_pad {S_pad}, 1 of {max_b} slots) {ms:.3f} ms median of "
        f"{len(times)} ({', '.join(f'{t:.3f}' for t in times)}); held "
        f"beyond the allocation before it {peak:,} B at its peak; the "
        f"client's per-slot state {slot_bytes // scfg.n_clients:,} B")
    OUT[label] = {"prefill_ms": ms, "prefill_ms_all": times,
                  "peak_bytes": peak,
                  "client_slot_bytes": slot_bytes // scfg.n_clients}
    del eng, base, bank
    free()


def _slot_leaves(eng):
    from repro_torch.core import symbiosis
    axes = symbiosis.cache_slot_axes(
        eng.cfg, eng.scfg.max_seq,
        **symbiosis.serve_cache_kwargs(eng.cfg, eng.scfg))
    return [t for t, _ in symbiosis._slot_leaves(eng.caches, axes)]


def page_copy(cfg, base):
    from repro_torch.config import ServeConfig
    from repro_torch.core import symbiosis
    scfg = ServeConfig(n_clients=4, max_seq=512, page_block=16)
    caches = symbiosis.init_client_caches(
        cfg, 4, 2, scfg.max_seq, device=DEV,
        **symbiosis.serve_cache_kwargs(cfg, scfg))
    copy = symbiosis.make_page_copy(cfg, scfg)
    as_index = getattr(symbiosis, "as_index", None)
    ids = ((lambda i: as_index(i, DEV)) if as_index is not None
           else (lambda i: i))
    for _ in range(3):
        copy(caches, ids(5), ids(9))
    torch.cuda.synchronize()
    host = []
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(200):
            copy(caches, ids(5), ids(9))
        host.append((time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(50):
        copy(caches, ids(5), ids(9))
    end.record()
    torch.cuda.synchronize()
    dev_ms = start.elapsed_time(end) / 50
    us = statistics.median(host)
    log(f"[page copy] granite pools {list(caches['layers']['k'].shape)}: "
        f"{us:.1f} us of host time per call (median of 7 x 200), "
        f"{dev_ms:.4f} ms per call between CUDA events (50 calls)")
    OUT["page_copy"] = {"host_us": us, "device_ms": dev_ms}
    del caches
    free()


class _Obs:
    def on_dispatch_compile(self, *args):
        pass


class _Owner:
    _trace_epoch = 0

    def __init__(self, base):
        self.base = base
        self._obs = _Obs()

    def trace_domain(self):
        from repro_torch.analysis import tracecount
        return tracecount.TraceDomain().declare("decode", unbounded=True)


def dispatch_cost(cfg, base, bank):
    try:
        tracecount = importlib.import_module("repro_torch.analysis.tracecount")
    except ImportError:
        log("[dispatch] no repro_torch.analysis in this tree")
        return
    from repro_torch.config import ServeConfig
    from repro_torch.core import symbiosis
    scfg = ServeConfig(n_clients=4, max_seq=512, page_block=16)
    caches = symbiosis.init_client_caches(
        cfg, 4, 2, scfg.max_seq, device=DEV,
        **symbiosis.serve_cache_kwargs(cfg, scfg))
    args = (base, bank, caches, torch.zeros((8,), dtype=torch.int32,
                                            device=DEV),
            torch.ones((8,), dtype=torch.bool, device=DEV))
    owner = _Owner(base)

    def step(*a):
        return None

    n_leaves = len(list(_walk(args)))
    runs = {"dispatch": [], "plain": []}
    for _ in range(7):
        for name, call in (
                ("dispatch", lambda: tracecount.dispatch(
                    owner, "decode", (), step, *args)),
                ("plain", lambda: step(*args))):
            t0 = time.perf_counter()
            for _ in range(2000):
                call()
            runs[name].append((time.perf_counter() - t0) / 2000 * 1e6)
    d, p = (statistics.median(runs[k]) for k in ("dispatch", "plain"))
    log(f"[dispatch] watched (telemetry attached) over {n_leaves} argument "
        f"leaves ({len(list(_walk(base)))} of them the base): {d:.2f} us "
        f"per call against {p:.2f} us plain (median of 7 x 2,000)")
    OUT["dispatch"] = {"watched_us": d, "plain_us": p, "leaves": n_leaves}
    del caches
    free()


def _walk(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _walk(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _walk(v)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("prefill_cost: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.config import AdapterConfig, ServeConfig
    from repro_torch.configs import get_config
    lora = AdapterConfig(method="lora", rank=8, alpha=16.0,
                         targets=("q", "v"))
    granite = get_config("granite-3-8b")
    admission("9a", granite, lora,
              ServeConfig(n_clients=4, max_seq=512, policy="opportunistic"),
              max_b=2, S_pad=256, length=200)
    base, bank = system(granite, lora, 4, seed=2)
    page_copy(granite, base)
    dispatch_cost(granite, base, bank)
    del base, bank
    free()
    jamba = get_config("jamba-v0.1-52b")
    jamba = dataclasses.replace(jamba, n_layers=2 * jamba.attn_every)
    admission("15b", jamba,
              AdapterConfig(method="lora", rank=8, alpha=16.0,
                            targets=("q", "v", "router")),
              ServeConfig(n_clients=4, max_seq=1024, policy="opportunistic"),
              max_b=2, S_pad=256, length=256)
    admission("17b", get_config("rwkv6-7b"),
              AdapterConfig(method="lora", rank=8, alpha=16.0,
                            targets=("q", "v", "cm_k")),
              ServeConfig(n_clients=8, max_seq=512, policy="opportunistic"),
              max_b=4, S_pad=128, length=128)
    print(json.dumps(OUT))
    return 0


if __name__ == "__main__":
    sys.exit(main())
