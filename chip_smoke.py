#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (it builds the port's CUDA kernels from
``src/repro_torch/csrc`` into ``build/repro_torch``); without a card it
exits non-zero and prints no result. Phases, each raising on failure:

1. device and build: the card's name and power limit, both kernels built;
2. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes (granite-3-8b: K=8, G=4, hd=128, page 16; SGMV
   din 4096, dout 4096/1024, rank 8), fp32 at atol = rtol = 1e-5 (TF32 off)
   and bf16 at 2e-2 against the plain version run in fp32 on the same bf16
   inputs;
3. model wiring: granite-3-8b at full width, 2 layers, one compacted
   prefill and one decode step with the kernels and under
   ``blocks.plain_kernels()``, logits compared at 2e-2; the kernel pass
   runs under ``torch.cuda.set_sync_debug_mode("error")``, so neither step
   may make the host wait for the device (as far as that mode, a PyTorch
   prototype, detects syncs);
4. serving at full size: granite-3-8b, 40 layers, bf16 random weights, 4
   LoRA clients, 8 staggered requests, greedy, with both kernels' launch
   counts checked per tick; then an 8-row decode tick timed unprofiled
   and traced once with torch.profiler (device activity only): device
   busy share, kernels per tick, top kernels by device time;
5. timings at the phase-4 shapes: kernel (L2-cold and L2-warm), plain
   version, a library yardstick and the memory/compute bound.

The second-to-last line is the JSON kernel summary, the last
``{"ok": true, "device": {...}}``. Weights are random, drawn from seeds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.config import AdapterConfig, ServeConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import symbiosis  # noqa: E402
from repro_torch.core.engine_spec import BankSpec, EngineSpec  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12         # H100 SXM HBM3
BF16_FLOPS = 989e12               # H100 SXM dense bf16 tensor-core peak
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
SENTINEL = 1 << 30
DEV = "cuda"
# the kernel modules (the packages re-export ops functions of the same name)
da = importlib.import_module("repro_torch.kernels.decode_attn.decode_attn")
sg = importlib.import_module("repro_torch.kernels.sgmv.sgmv")
KERNELS = {"paged_decode_attn": da, "sgmv": sg}
WRAPPERS = {"paged_decode_attn": da.paged_decode_attn_cuda, "sgmv": sg.sgmv_cuda}


def log(msg):
    print(msg, flush=True)


def compare(what, got, want, tol):
    """Max |got - want|; raises unless |got - want| <= atol + rtol*|want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > tol["atol"] + tol["rtol"] * want.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside "
                             f"{tol}, max abs err {float(err.max()):.3e}")
    return float(err.max())


def gen(seed):
    return torch.Generator(device=DEV).manual_seed(seed)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_case(B, K, G, hd, blk, nb, seed, pos=None, dtype=torch.float32):
    g = gen(seed)
    P = B * nb + 7
    q = torch.randn((B, K, G, hd), generator=g, device=DEV)
    pk = torch.randn((P, blk, K, hd), generator=g, device=DEV)
    pv = torch.randn((P, blk, K, hd), generator=g, device=DEV)
    tbl = torch.randperm(P, generator=g, device=DEV)[:B * nb].reshape(B, nb)
    if pos is None:
        pos = torch.randint(0, nb * blk, (B,), generator=g, device=DEV)
    else:
        pos = torch.tensor(pos, device=DEV)
    cols = torch.arange(nb, device=DEV)[None, :]
    tbl = torch.where(cols > (pos // blk)[:, None], SENTINEL + 3 * P, tbl)
    return (q.to(dtype), pk.to(dtype), pv.to(dtype), tbl.to(torch.int32),
            pos.to(torch.int32))


PAGED_CASES = {   # (B, K, G, hd, blk, nb, window, pos)
    "granite_pos0_page_edges": (16, 8, 4, 128, 16, 32, 0,
                                [0, 15, 16, 31, 32, 47, 48, 100, 127, 128,
                                 200, 255, 256, 300, 400, 511]),
    "granite_one_row": (1, 8, 4, 128, 16, 32, 0, [271]),
    "granite_uneven_rows": (5, 8, 4, 128, 16, 32, 0, None),
    "granite_window": (8, 8, 4, 128, 16, 32, 100, None),
    "g1_hd64": (6, 8, 1, 64, 16, 32, 0, None),
}


def check_paged(errs):
    for i, (name, (B, K, G, hd, blk, nb, window, pos)) in enumerate(
            PAGED_CASES.items()):
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            q, pk, pv, tbl, p = paged_case(B, K, G, hd, blk, nb, 100 + i, pos,
                                           dtype)
            got = da.paged_decode_attn_cuda(q, pk, pv, tbl, p, window=window)
            want = da.paged_decode_attn_plain(q.float(), pk.float(), pv.float(),
                                              tbl, p, window=window)
            torch.cuda.synchronize()
            e = compare(f"paged_decode_attn {name} {dtype}", got, want, tol)
            errs.append(e)
            log(f"[phase 2] paged_decode_attn {name:24s} {str(dtype):15s} "
                f"max_abs_err={e:.3e}")


SGMV_CASES = {    # (rows, block_t, dout, ids)
    "decode_1row_q": (1, 1, 4096, [2]),
    "decode_5rows_v": (5, 1, 1024, [0, -1, 3, 9, 1]),
    "decode_16rows_q": (16, 1, 4096, [0, 1, 2, 3, -1, 5, 1, 1, 0, 2, 3, 3, 7,
                                      -1, 2, 0]),
    "decode_16rows_v": (16, 1, 1024, [3, 2, 1, 0, 0, -1, 4, 1, 2, 2, 3, 1, 0,
                                      0, -1, 3]),
    "prefill_S128_q": (3, 128, 4096, [1, -1, 9]),
    "prefill_S256_v": (2, 256, 1024, [3, 0]),
}


def check_sgmv(errs):
    din, r, n = 4096, 8, 4
    for i, (name, (rows, bt, dout, ids)) in enumerate(SGMV_CASES.items()):
        g = gen(200 + i)
        x = torch.randn((rows * bt, din), generator=g, device=DEV)
        bank_a = torch.randn((n, 3, din, r), generator=g, device=DEV) / din ** 0.5
        bank_b = torch.randn((n, 3, r, dout), generator=g, device=DEV) * 0.05
        ids_t = torch.tensor(ids, dtype=torch.int32, device=DEV)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            # layer-major views of a [C, L, ...] bank: a strided client axis,
            # as the serving path passes it
            xd = x.to(dtype)
            Ad = bank_a.to(dtype).transpose(0, 1)[1]
            Bd = bank_b.to(dtype).transpose(0, 1)[1]
            got = sg.sgmv_cuda(xd, Ad, Bd, ids_t, block_t=bt, scale=2.0)
            want = sg.sgmv_plain(xd.float(), Ad.float(), Bd.float(), ids_t,
                                 block_t=bt, scale=2.0)
            torch.cuda.synchronize()
            e = compare(f"sgmv {name} {dtype}", got, want, tol)
            dead = (ids_t < 0).repeat_interleave(bt)
            if got[dead].any():
                raise AssertionError(f"sgmv {name}: dead rows not zero")
            errs.append(e)
            log(f"[phase 2] sgmv {name:30s} {str(dtype):15s} max_abs_err={e:.3e}")


# ---------------------------------------------------------------------------
# phases 3 and 4: the model and the serving engine through the kernels
# ---------------------------------------------------------------------------

LORA = AdapterConfig(method="lora", rank=8, alpha=16.0, targets=("q", "v"))


def make_system(cfg, n_clients, seed):
    """bf16 base and LoRA bank from a seeded generator on the card; the
    bank's B matrices (zero at init) are drawn too, so every client's
    adapter differs and the SGMV routing matters."""
    g = gen(seed)
    base, bank = symbiosis.init_system(cfg, LORA, n_clients, g, device=DEV,
                                       adapter_dtype=torch.bfloat16)
    for leaf in bank["layers"].values():
        leaf["B"].copy_(torch.randn(leaf["B"].shape, generator=g, device=DEV)
                        * 0.05)
    return base, bank


@contextlib.contextmanager
def no_host_sync():
    """Raise on any operation that makes the host wait for the device."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def model_wiring():
    """Full-width granite, 2 layers: compacted prefill + decode with the
    kernels and under plain_kernels(); logits must agree at bf16 tolerance.
    The kernel pass must not sync the host (a CUDA graph could capture
    it)."""
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=2)
    C, max_b, max_seq, blk = 4, 2, 512, 16
    scfg = ServeConfig(n_clients=C, max_seq=max_seq, page_block=blk)
    base, bank = make_system(cfg, C, seed=1)
    nb, P = max_seq // blk, max_b * (max_seq // blk)
    rng = np.random.default_rng(3)
    lengths = rng.integers(64, 257, C).astype(np.int32)
    toks = np.zeros((C, 256), np.int32)
    tbl = np.full((C, max_b, nb), SENTINEL, np.int32)
    for c, L in enumerate(lengths):
        toks[c, :L] = rng.integers(0, cfg.vocab, L)
        tbl[c, 0, :L // blk + 1] = c * P + np.arange(L // blk + 1)
    rows = [torch.tensor(a, device=DEV) for a in
            (np.arange(C, dtype=np.int32), np.zeros(C, np.int32),
             np.ones(C, bool))]
    prefill = symbiosis.make_compact_prefill(cfg, LORA, scfg)
    decode = symbiosis.make_compact_decode_step(cfg, LORA, scfg)
    out, nxt = [], None
    for plain in (False, True):
        caches = symbiosis.init_client_caches(cfg, C, max_b, max_seq,
                                              page_block=blk, pool_pages=P,
                                              device=DEV)
        caches["block_tbl"] = torch.tensor(tbl, device=DEV)
        prompts = (torch.tensor(toks, device=DEV),
                   torch.tensor(lengths, device=DEV))
        with blocks.plain_kernels() if plain else no_host_sync():
            lg1, _, caches = prefill(base, bank, caches, *prompts, *rows)
            if nxt is None:
                nxt = lg1.argmax(-1).to(torch.int32)
            lg2, _, caches = decode(base, bank, caches, nxt, *rows)
        out.append((lg1, lg2))
    torch.cuda.synchronize()
    e1 = compare("model prefill logits", out[0][0], out[1][0], BF16_TOL)
    e2 = compare("model decode logits", out[0][1], out[1][1], BF16_TOL)
    log(f"[phase 3] granite-3-8b width, 2 layers: prefill logits max_abs_err="
        f"{e1:.3e}, decode logits max_abs_err={e2:.3e} (kernels vs plain); "
        "no host sync in the kernel pass")


def _timed(fn, bucket):
    def run(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        bucket.append(time.perf_counter() - t)
        return out
    return run


def serve_full():
    """granite-3-8b at full depth and width behind the port's engine."""
    cfg = get_config("granite-3-8b")
    C, L = 4, cfg.n_layers
    scfg = ServeConfig(n_clients=C, max_seq=512, page_block=16,
                       policy="opportunistic")
    spec = EngineSpec(cfg=cfg, banks=(BankSpec("tenants", LORA, C),),
                      serve=scfg, max_batch_per_client=2)
    t0 = time.perf_counter()
    base, bank = make_system(cfg, C, seed=2)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(base))
    log(f"[phase 4] {cfg.name}: {L} layers, {n_params / 1e9:.2f} B params "
        f"bf16 initialised in {time.perf_counter() - t0:.1f} s")
    # warm-up engine: first cuBLAS/allocator use stays out of the timed run
    warm = ServingEngine(spec, base, [bank], device=DEV)
    warm.submit(Request(0, np.arange(64, dtype=np.int32)[None], 2))
    warm.run()
    del warm

    eng = ServingEngine(spec, base, [bank], device=DEV)
    rng = np.random.default_rng(4)
    reqs = [Request(client_id=i % C, max_new_tokens=16, arrive_tick=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        (1, int(rng.integers(64, 257))))
                    .astype(np.int32)) for i in range(8)]
    for r in reqs:
        eng.submit(r)
    pre_t, dec_t, tick_t, step_t = [], [], [], []
    eng._prefill_step = _timed(eng._prefill_step, pre_t)
    eng._decode_step = _timed(eng._decode_step, dec_t)
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    more = True
    while more:
        before = (da.paged_decode_attn_cuda.launches, sg.sgmv_cuda.launches,
                  eng.stats["ticks"], eng.stats["compact_prefill_batches"])
        torch.cuda.synchronize()
        t_tick = time.perf_counter()
        more = eng.service_tick()
        torch.cuda.synchronize()
        t_tick = time.perf_counter() - t_tick
        d_da, d_sg, d_tick, d_pre = (
            a - b for a, b in zip((da.paged_decode_attn_cuda.launches,
                                   sg.sgmv_cuda.launches, eng.stats["ticks"],
                                   eng.stats["compact_prefill_batches"]),
                                  before))
        if d_da != L * d_tick or d_sg != 2 * L * (d_tick + d_pre):
            raise AssertionError(
                f"tick {eng._tick}: {d_da} decode-attention and {d_sg} SGMV "
                f"launches for {d_tick} decode ticks and {d_pre} prefills")
        if d_tick and not d_pre:
            tick_t.append(t_tick)
            step_t.append(dec_t[-1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: w.launches for n, w in WRAPPERS.items()}
    done = eng.drain_done()
    if len(done) != len(reqs) or eng.stats["quarantined_requests"]:
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished, "
                             f"{eng.stats['quarantined_requests']} with "
                             "non-finite logits")
    for r in done:
        g = r.generated
        if r.status != "ok" or g.shape != (1, 16) or g.min() < 0 \
                or g.max() >= cfg.vocab:
            raise AssertionError(f"request of client {r.client_id}: status "
                                 f"{r.status}, tokens {g}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel never launched on the main path: "
                             f"{launches}")
    st = eng.stats
    log(f"[phase 4] served {len(done)} requests ({st['prefill_tokens']} prompt "
        f"+ {st['decode_tokens'] + len(done)} generated tokens) in {wall:.3f} s; "
        f"{st['ticks']} decode ticks, {st['compact_prefill_batches']} "
        f"prefill batches, launches {launches}")
    log(f"[phase 4] prefill {st['prefill_tokens'] / sum(pre_t):.1f} tokens/s "
        f"({sum(pre_t) * 1e3:.2f} ms over {len(pre_t)} batches); decode "
        f"{st['decode_tokens'] / sum(dec_t):.1f} tokens/s; decode-step ms "
        f"{statistics.median(dec_t) * 1e3:.3f} (median), "
        f"{statistics.mean(dec_t) * 1e3:.3f} (mean) over {len(dec_t)} steps")
    log(f"[phase 4] {len(tick_t)} ticks without admission: decode-step ms "
        f"{statistics.median(step_t) * 1e3:.3f}, service-tick ms "
        f"{statistics.median(tick_t) * 1e3:.3f} (medians; the tick adds the "
        f"logits' copy to the host, sampling and retirement)")
    log(f"[phase 4] launches per decode tick: paged_decode_attn "
        f"{launches['paged_decode_attn'] / st['ticks']:g}; sgmv per decode "
        f"tick or prefill batch "
        f"{launches['sgmv'] / (st['ticks'] + st['compact_prefill_batches']):g}"
        f" (checked tick by tick)")
    profile_tick(cfg, base, bank, spec)
    lengths = [r.prompt.shape[1] for r in reqs]
    return launches, cfg, eng.caches, bank, lengths


def profile_tick(cfg, base, bank, spec):
    """An 8-row decode tick: its median over 5 unprofiled ticks on the host
    clock, then one tick traced by torch.profiler with device activity only.
    The device's busy share is the union of the traced kernel intervals
    over the unprofiled median tick (and over the traced tick's own host
    time, which tracing lengthens). Also the kernel count and the kernels
    that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    eng = ServingEngine(spec, base, [bank], device=DEV)
    rng = np.random.default_rng(5)
    for i in range(8):
        eng.submit(Request(i % 4, rng.integers(0, cfg.vocab, (1, 192))
                           .astype(np.int32), 16))
    eng.service_tick()               # admission, prefill, first decode tick
    eng.service_tick()
    ticks = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.service_tick()
        torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t0)
    tick_us = statistics.median(ticks) * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.service_tick()
        torch.cuda.synchronize()
        traced_us = (time.perf_counter() - t0) * 1e6
    kern = sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    if not kern:
        log(f"[phase 4] decode tick (8 rows): {tick_us / 1e3:.3f} ms median "
            "unprofiled; profiler saw no device events: device busy share "
            "not measured")
        return
    busy, end = 0.0, float("-inf")
    for e in kern:
        s, t = e.time_range.start, e.time_range.end
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    by_name = {}
    for e in kern:
        n, d = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, d + e.time_range.elapsed_us())
    log(f"[phase 4] decode tick (8 rows): {tick_us / 1e3:.3f} ms median "
        f"unprofiled, {traced_us / 1e3:.3f} ms traced; device busy "
        f"{busy / 1e3:.3f} ms = {100 * busy / tick_us:.1f}% of the "
        f"unprofiled tick ({100 * busy / traced_us:.1f}% of the traced "
        f"one); {len(kern)} kernels")
    for name, (n, d) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"[phase 4]   {d / 1e3:8.3f} ms  {n:5d}x  {name[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 5: timings at the serving path's shapes
# ---------------------------------------------------------------------------

_L2_FLUSH = []


def time_ms(fn, n=30, warmup=3, l2_cold=True):
    """Median device time of one call (CUDA events around each call). With
    ``l2_cold`` a 256 MB write before each call (outside the events) evicts
    the card's 50 MB L2, so the call reads its inputs from HBM, as on the
    serving path, where a layer's weights pass through L2 between two
    calls of a kernel."""
    if l2_cold and not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(64 << 20, dtype=torch.int32, device=DEV))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        if l2_cold:
            _L2_FLUSH[0].zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, flops):
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / BF16_FLOPS * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def time_decode_attn(cfg, caches, lengths):
    """8 rows (the bucket of phase 4) over the engine's own layer-fused pool,
    pages drawn from the first layer's range."""
    L, Pl, blk, K, hd = caches["layers"]["k"].shape
    pool_k, pool_v = (caches["layers"][n].view((L * Pl, blk, K, hd))
                      for n in ("k", "v"))
    B, G, nb = 8, cfg.q_per_kv, caches["block_tbl"].shape[-1]
    g = gen(7)
    q = torch.randn((B, K, G, hd), generator=g, device=DEV).to(torch.bfloat16)
    pos = torch.tensor([L + 15 for L in lengths[:B]], dtype=torch.int32,
                       device=DEV)
    tbl = torch.randperm(Pl, generator=g, device=DEV)[:B * nb].reshape(B, nb)
    cols = torch.arange(nb, device=DEV)[None, :]
    tbl = torch.where(cols > (pos // blk)[:, None], SENTINEL, tbl) \
        .to(torch.int32)
    P = pool_k.shape[0]
    # the builtin has no inspectable signature; its docstring names the flag
    sdpa_gqa = "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or "")

    def library():
        pages = tbl.long().clamp(0, P - 1)
        k = pool_k[pages].reshape(B, nb * blk, K, hd).transpose(1, 2)
        v = pool_v[pages].reshape(B, nb * blk, K, hd).transpose(1, 2)
        t = torch.arange(nb * blk, device=DEV)
        mask = (t[None, :] <= pos[:, None])[:, None, None, :]
        qh = q.reshape(B, K * G, 1, hd)
        if sdpa_gqa:
            return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(
            qh, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1),
            attn_mask=mask)

    got = da.paged_decode_attn_cuda(q, pool_k, pool_v, tbl, pos)
    lib_err = float((got.float() - library().reshape(B, K, G, hd).float())
                    .abs().max())
    ms = time_ms(lambda: da.paged_decode_attn_cuda(q, pool_k, pool_v, tbl, pos))
    warm_ms = time_ms(lambda: da.paged_decode_attn_cuda(q, pool_k, pool_v,
                                                        tbl, pos),
                      l2_cold=False)
    plain_ms = time_ms(lambda: da.paged_decode_attn_plain(
        q, pool_k, pool_v, tbl, pos), n=20)
    lib_ms = time_ms(library)
    tokens = int((pos.long() + 1).sum())
    nbytes = (2 * q.numel() * 2 + 2 * tokens * K * hd * 2 + tbl.numel() * 4
              + pos.numel() * 4)
    bound_ms, by = bound(nbytes, 4 * tokens * K * G * hd)
    log(f"[phase 5] paged_decode_attn B={B} K={K} G={G} hd={hd} blk={blk} "
        f"pool={P} pages, {tokens} live tokens, L2-cold: kernel {ms:.4f} ms "
        f"(L2-warm {warm_ms:.4f}), plain {plain_ms:.4f} ms, gather+SDPA "
        f"{lib_ms:.4f} ms (differs by {lib_err:.2e}), bound {bound_ms:.4f} "
        f"ms ({by})")
    return dict(ms=ms, ms_l2_warm=warm_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)


def time_sgmv(bank):
    """q-projection LoRA delta of one layer, decode (8 rows, block_t=1) and
    compacted prefill (4 rows of 256 tokens) shapes."""
    A = bank["layers"]["q"]["A"].transpose(0, 1)[0]      # [C, din, r] view
    Bw = bank["layers"]["q"]["B"].transpose(0, 1)[0]
    n, din, r = A.shape
    dout = Bw.shape[-1]
    results = {}
    for label, rows, bt in (("decode", 8, 1), ("prefill", 4, 256)):
        g = gen(8)
        x = torch.randn((rows * bt, din), generator=g, device=DEV) \
            .to(torch.bfloat16)
        ids = torch.arange(rows, device=DEV, dtype=torch.int32) % n
        scale = LORA.alpha / LORA.rank

        def library():
            safe = ids.long().clamp(0, n - 1).repeat_interleave(bt)
            h = torch.bmm(x[:, None, :], A[safe])
            y = torch.bmm(h, Bw[safe])[:, 0] * scale
            live = (ids >= 0).repeat_interleave(bt)[:, None]
            return torch.where(live, y, torch.zeros_like(y))

        got = sg.sgmv_cuda(x, A, Bw, ids, block_t=bt, scale=scale)
        # the yardstick rounds h to bf16 between its two products, the
        # kernel keeps it in fp32: the difference is reported, not held
        lib_err = float((got.float() - library().float()).abs().max())
        ms = time_ms(lambda: sg.sgmv_cuda(x, A, Bw, ids, block_t=bt,
                                          scale=scale))
        warm_ms = time_ms(lambda: sg.sgmv_cuda(x, A, Bw, ids, block_t=bt,
                                               scale=scale), l2_cold=False)
        plain_ms = time_ms(lambda: sg.sgmv_plain(x, A, Bw, ids, block_t=bt,
                                                 scale=scale), n=20)
        lib_ms = time_ms(library)
        T = rows * bt
        n_used = len(set(ids.tolist()))
        nbytes = (T * din * 2 + n_used * (din * r + r * dout) * 2
                  + ids.numel() * 4 + T * dout * 2)
        bound_ms, by = bound(nbytes, 2 * T * r * (din + dout))
        log(f"[phase 5] sgmv {label} T={T} block_t={bt} din={din} r={r} "
            f"dout={dout}, L2-cold: kernel {ms:.4f} ms (L2-warm "
            f"{warm_ms:.4f}), plain {plain_ms:.4f} ms, gather+bmm "
            f"{lib_ms:.4f} ms (differs by {lib_err:.2e}), bound "
            f"{bound_ms:.4f} ms ({by})")
        results[label] = dict(ms=ms, ms_l2_warm=warm_ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=by,
                              library_ms=lib_ms)
    return results["decode"]


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    log(f"[phase 1] torch {torch.__version__} CUDA {torch.version.cuda} on "
        f"{kind}")
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 comparisons
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    reports = _build.build(list(KERNELS))
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[phase 1] {name}: {line.strip()}")
    log(f"[phase 1] built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    errs = {"paged_decode_attn": [], "sgmv": []}
    check_paged(errs["paged_decode_attn"])
    check_sgmv(errs["sgmv"])
    log(f"[phase 2] kernels agree with their plain versions "
        f"({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    model_wiring()
    torch.cuda.empty_cache()
    log(f"[phase 3] done ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    launches, cfg, caches, bank, lengths = serve_full()
    log(f"[phase 4] done ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    timings = {"paged_decode_attn": time_decode_attn(cfg, caches, lengths),
               "sgmv": time_sgmv(bank)}
    log(f"[phase 5] done ({time.perf_counter() - t:.1f} s); total "
        f"{time.perf_counter() - t_start:.1f} s")

    summary = [dict(name=name, route="cuda", source=mod.SOURCE,
                    replaces=mod.REPLACES, launches=launches[name],
                    max_abs_err=max(errs[name]), **timings[name])
               for name, mod in KERNELS.items()]
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
