#!/usr/bin/env python3
"""Tile-width and split-size sweeps of the port's redesigned Hopper kernels.

    python3 tools/kernel_sweeps.py [ragged dense flash paged paged_quant sgmv]

Needs one CUDA device and ``nvcc``. Times are L2-cold (a 256 MB write
before each call, outside the CUDA events), medians of 30 calls. Five
sweeps, printed one line per shape after the card's name and power limit:

1. the ragged linear's tensor-core entry point at each of its tile widths
   (BN 256, 128, 64) for granite-3-8b's seven projection shapes with 1,001
   of 1,024, 1,030 of 2,048 and 2,048 of 2,048 rows live, beside
   ``torch.addmm`` over the whole buffer and the width ``tile_width``
   picks. The committed source is compiled once more (into ``build/``)
   with two extra C entry points, one that takes BN from its caller and one
   that returns ``tile_width``'s choice, so the sweep times the kernel the
   port launches; each width is first held against the plain version;
2. dense decode attention at ``chip_smoke.py``'s phase-6 shape and at
   phase 9's layer slab with splits of 32 to 512 tokens: the call's time,
   its device time with the enqueue hidden (``chip_smoke.device_ms``), and
   the split and combine kernels' device times by ``torch.profiler``,
   beside SDPA with a mask and GQA;
3. flash attention's tensor-core entry point at kv tiles of 64 and 128 rows
   and rings of 2 and 3 stages, at ``chip_smoke.py``'s phase-5 shape
   (granite's [1, 4096, 32, 128], causal) and gemma2-27b's windowed
   [1, 8192, 32, 128] over 16 KV heads, beside SDPA; the source is compiled
   once more with an extra C entry point that takes both from its caller,
   each pair first held against SDPA's output;
4. paged decode attention at 1, 2, 4 and 8 pages per split at phase 5's
   shape (8 rows of granite heads over a 40-layer pool of 16-token pages,
   the rows' positions those of ``chip_smoke.py``'s requests), L2-cold and
   L2-warm by events and L2-cold by ``chip_smoke.device_ms`` (events
   around a call of tens of us also count the host's enqueue; there the
   calls queue behind a spin kernel), beside the
   page gather + SDPA yardstick, each split size first held against the
   plain version; then the same over int8 pools with f32 scales
   (``PAGED_QUANT_SPLIT_PAGES``);
5. SGMV's tile: columns per block at decode (8 rows, block_t 1) and tokens
   x columns per block at prefill (4 rows of 256 tokens), for granite's q
   (dout 4096) and v (dout 1024) projections at rank 8 over 4 adapters,
   L2-cold by ``chip_smoke.device_ms``, each tile first held against the
   plain version.
"""
from __future__ import annotations

import ctypes
import importlib
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

DEV = "cuda"
rl = importlib.import_module("repro_torch.kernels.ragged_linear.ragged_linear")
da = importlib.import_module("repro_torch.kernels.decode_attn.decode_attn")
fa = importlib.import_module("repro_torch.kernels.flash_attn.flash_attn")
sg = importlib.import_module("repro_torch.kernels.sgmv.sgmv")

SWEEP_ENTRIES = r'''
extern "C" int sweep_ragged_linear_tc(const void* x, const void* w, const void* bias,
                                      void* y, int n_live, int budget, int din, int dout,
                                      long long ldw, int bn, int sms, void* stream) {
  CUtensorMap mx, mw;
  if (!tc::encode(&mx, x, budget, din, din, tc::kBK, tc::kBM) ||
      !tc::encode(&mw, w, din, dout, ldw, tc::kBoxW, tc::kBK))
    return tc::kTensorMapError;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long t = (long long)((budget + tc::kBM - 1) / tc::kBM) * ((dout + bn - 1) / bn);
  const int grid = (int)(t < sms ? t : sms);
  if (bn == 256)
    return tc::launch<256>(mx, mw, bias, nullptr, n_live, y, budget, din, dout, grid, s);
  if (bn == 128)
    return tc::launch<128>(mx, mw, bias, nullptr, n_live, y, budget, din, dout, grid, s);
  return tc::launch<64>(mx, mw, bias, nullptr, n_live, y, budget, din, dout, grid, s);
}

extern "C" int sweep_tile_width(int rows, int dout, int sms) {
  return tc::tile_width(rows, dout, sms);
}
'''
FLASH_ENTRY = r'''
extern "C" int sweep_flash_attn_tc(const void* q, const void* k, const void* v, void* out,
                                   int B, int S, int T, int H, int K, int causal, int window,
                                   float scale, int bkv, int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bkv == 64 && stages == 2)
    return tc::run<64, 2>(q, k, v, out, B, S, T, H, K, causal, window, scale, s);
  if (bkv == 64 && stages == 3)
    return tc::run<64, 3>(q, k, v, out, B, S, T, H, K, causal, window, scale, s);
  if (bkv == 128 && stages == 3)
    return tc::run<128, 3>(q, k, v, out, B, S, T, H, K, causal, window, scale, s);
  return tc::run<128, 2>(q, k, v, out, B, S, T, H, K, causal, window, scale, s);
}

extern "C" int sweep_flash_tile() { return tc::kBKV * 10 + tc::kStages; }
'''
PROJECTIONS = {"q, o": (4096, 4096), "k, v": (4096, 1024),
               "gate, up": (4096, 12800), "down": (12800, 4096)}
ROWS = ((1024, 1001), (2048, 1030), (2048, 2048))   # budget, live rows
_FLUSH = []


def time_ms(fn, n=30, l2_cold=True):
    if not _FLUSH:
        _FLUSH.append(torch.empty(64 << 20, dtype=torch.int32, device=DEV))
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        if l2_cold:
            _FLUSH[0].zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sweep_library(name, entries):
    """``csrc/<name>.cu`` plus the sweep's extra entry points, built into
    build/ beside the port's libraries (its headers from csrc/)."""
    src = (_build.CSRC / f"{name}.cu").read_text() + entries
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"{name}_sweep.cu"
    so = _build.BUILD_DIR / f"lib{name}_sweep.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-o", str(so), str(cu)], check=True, capture_output=True,
                   text=True)
    lib = ctypes.CDLL(str(so))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def ragged_sweep():
    lib = sweep_library("ragged_linear", SWEEP_ENTRIES)
    lib.sweep_ragged_linear_tc.argtypes = ([ctypes.c_void_p] * 4
                                           + [ctypes.c_int] * 4
                                           + [ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_void_p])
    lib.sweep_ragged_linear_tc.restype = ctypes.c_int
    lib.sweep_tile_width.argtypes = [ctypes.c_int] * 3
    lib.sweep_tile_width.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def call(x, w, n, bn):
        y = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype, device=DEV)
        err = lib.sweep_ragged_linear_tc(
            x.data_ptr(), w.data_ptr(), None, y.data_ptr(), n, x.shape[0],
            x.shape[1], w.shape[1], w.stride(0), bn, sms, stream)
        _build.check(lib, err, f"ragged linear sweep (BN {bn})")
        return y

    g = torch.Generator(device=DEV).manual_seed(1)
    for name, (din, dout) in PROJECTIONS.items():
        w = (torch.randn((din, dout), generator=g, device=DEV)
             / din ** 0.5).to(torch.bfloat16)
        for budget, n in ROWS:
            x = torch.randn((budget, din), generator=g, device=DEV) \
                .to(torch.bfloat16)
            want = rl.ragged_linear_plain(x.float(), w.float(), None, n)
            for bn in (256, 128, 64):
                got = call(x, w, n, bn).float()
                bad = (got - want).abs() > 2e-2 + 2e-2 * want.abs()
                if bad.any() or got[n:].any():
                    raise AssertionError(f"{name} {budget} {n} BN {bn}: "
                                         f"{int(bad.sum())} elements off")
            ms = {bn: time_ms(lambda: call(x, w, n, bn))
                  for bn in (256, 128, 64)}
            zero = torch.zeros((dout,), dtype=torch.bfloat16, device=DEV)
            addmm = time_ms(lambda: torch.addmm(zero, x, w))
            picked = lib.sweep_tile_width(n, dout, sms)
            best = min(ms, key=ms.get)
            print(f"ragged_linear {name:8s} {budget}x{din}x{dout}, {n} live: "
                  + ", ".join(f"BN {bn} {t:.4f} ms" for bn, t in ms.items())
                  + f"; addmm {addmm:.4f} ms; tile_width picks {picked}, "
                  f"fastest {best}", flush=True)


def dense_sweep():
    """Phase 6's cache [8, 4096, 8, 128] (positions spread over it) and
    phase 9's layer slab [8, 512, 8, 128] (positions 15 past phase 4's
    prompts), each split size held against the plain version first."""
    B, K, G, hd = 8, 8, 4, 128
    lengths = [r.prompt.shape[1] for r in chip_smoke.make_requests(
        get_config("granite-3-8b"), 4)]
    g = torch.Generator(device=DEV).manual_seed(10)
    chosen = da.DENSE_SPLIT
    for T, pos in ((4096, torch.linspace(0, 4095, B, device=DEV).round()),
                   (512, torch.tensor([n + 15 for n in lengths],
                                      device=DEV))):
        pos = pos.to(torch.int32)
        q = torch.randn((B, K, G, hd), generator=g, device=DEV) \
            .to(torch.bfloat16)
        k, v = (torch.randn((B, T, K, hd), generator=g, device=DEV)
                .to(torch.bfloat16) for _ in range(2))
        mask = (torch.arange(T, device=DEV)[None, :]
                <= pos[:, None].long())[:, None, None, :]
        sdpa = chip_smoke.device_ms(lambda: F.scaled_dot_product_attention(
            q.reshape(B, K * G, 1, hd), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True))
        want = da.decode_attn_plain(q.float(), k.float(), v.float(), pos,
                                    block_kv=512)
        try:
            for split in (32, 64, 128, 256, 512):
                da.DENSE_SPLIT = split
                err = float((da.decode_attn_cuda(q, k, v, pos).float()
                             - want).abs().max())
                ms = time_ms(lambda: da.decode_attn_cuda(q, k, v, pos))
                dev = chip_smoke.device_ms(
                    lambda: da.decode_attn_cuda(q, k, v, pos))
                with chip_smoke.traced() as prof:
                    for _ in range(5):
                        _FLUSH[0].zero_()
                        da.decode_attn_cuda(q, k, v, pos)
                kern = {name: sum(e.device_time_total
                                  for e in prof.key_averages()
                                  if name in e.key) / 5
                        for name in ("split_kernel", "dense_combine_kernel")}
                print(f"decode_attn dense {[B, T, K, hd]} bf16, "
                      f"{int((pos.long() + 1).sum())} live tokens, split "
                      f"{split}: {ms:.4f} ms, device {dev:.4f} ms (split "
                      f"kernel {kern['split_kernel']:.1f} us, combine "
                      f"{kern['dense_combine_kernel']:.1f} us), max abs err "
                      f"{err:.2e}; SDPA with a mask, device {sdpa:.4f} ms"
                      f" (the port splits by {chosen})", flush=True)
        finally:
            da.DENSE_SPLIT = chosen


def flash_sweep():
    lib = sweep_library("flash_attn", FLASH_ENTRY)
    lib.sweep_flash_attn_tc.argtypes = ([ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 7
                                        + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p])
    lib.sweep_flash_attn_tc.restype = ctypes.c_int
    tile = lib.sweep_flash_tile()
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=DEV).manual_seed(11)
    for S, H, K, window in ((4096, 32, 8, 0), (8192, 32, 16, 4096)):
        q = torch.randn((1, S, H, 128), generator=g, device=DEV).bfloat16()
        k, v = (torch.randn((1, S, K, 128), generator=g, device=DEV)
                .bfloat16() for _ in range(2))
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            t = torch.arange(S, device=DEV)
            kw = dict(attn_mask=(t[:, None] >= t[None, :])
                      & (t[:, None] - t[None, :] < window))
        else:
            kw = dict(is_causal=True)

        def sdpa():
            return chip_smoke.sdpa_gqa(qh, kh, vh, **kw).transpose(1, 2)
        want = sdpa().float()
        flops = 4 * H * 128 * chip_smoke.visible_pairs(S, S, window)

        def call(bkv, stages):
            out = torch.empty_like(q)
            err = lib.sweep_flash_attn_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1,
                S, S, H, K, 1, window, 1 / 128 ** 0.5, bkv, stages, stream)
            _build.check(lib, err, f"flash sweep (kv {bkv}, {stages} stages)")
            return out
        ms = {}
        for bkv in (64, 128):
            for stages in (2, 3):
                got = call(bkv, stages).float()
                bad = (got - want).abs() > 2e-2 + 2e-2 * want.abs()
                if bad.any():
                    raise AssertionError(f"flash kv {bkv} x {stages} stages: "
                                         f"{int(bad.sum())} elements off")
                ms[bkv, stages] = time_ms(lambda: call(bkv, stages))
        lib_ms = time_ms(sdpa)
        print(f"flash_attn_tc [1,{S},{H},128] over {K} KV heads, causal, "
              f"window {window}: " + ", ".join(
                  f"kv {b} x {st} stages {t:.4f} ms "
                  f"({flops / t / 1e9:.1f} TFLOP/s)"
                  for (b, st), t in ms.items())
              + f"; SDPA {lib_ms:.4f} ms; the port's entry takes kv "
              f"{tile // 10} x {tile % 10} stages, fastest "
              f"{min(ms, key=ms.get)}", flush=True)
        del q, k, v, qh, kh, vh, want


def paged_sweep(quant=False):
    """Phase 5's paged shape: 8 bf16 rows of granite heads (K 8, G 4, hd
    128) over a pool of 40 layers x 256 pages of 16 tokens, the table drawn
    from the first layer's pages, positions 15 past the requests'
    prompts; with ``quant``, int8 pools drawn over [-127, 127] with f32
    scales."""
    cfg = get_config("granite-3-8b")
    lengths = [r.prompt.shape[1] for r in chip_smoke.make_requests(cfg, 4)]
    B, K, G, hd, blk, Pl, L = 8, cfg.n_kv_heads, cfg.q_per_kv, cfg.hd, 16, 256, 40
    nb = Pl // B
    g = torch.Generator(device=DEV).manual_seed(7)
    pk, pv = (torch.randn((L * Pl, blk, K, hd), generator=g, device=DEV)
              .bfloat16() for _ in range(2))
    q = torch.randn((B, K, G, hd), generator=g, device=DEV).bfloat16()
    pos = torch.tensor([n + 15 for n in lengths], dtype=torch.int32,
                       device=DEV)
    tbl = torch.randperm(Pl, generator=g, device=DEV)[:B * nb].reshape(B, nb)
    cols = torch.arange(nb, device=DEV)[None, :]
    tbl = torch.where(cols > (pos // blk)[:, None], chip_smoke.SENTINEL,
                      tbl).to(torch.int32)
    const = "PAGED_QUANT_SPLIT_PAGES" if quant else "PAGED_SPLIT_PAGES"
    if quant:
        pk, pv = (torch.randint(-127, 128, pk.shape, generator=g, device=DEV,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((L * Pl, blk, K, 1), generator=g, device=DEV)
                  * 0.025 + 0.005 for _ in range(2))
        want = da.paged_decode_attn_quant_plain(q.float(), pk, ks, pv, vs,
                                                tbl, pos)

        def call():
            return da.paged_decode_attn_quant_cuda(q, pk, ks, pv, vs, tbl, pos)

        def library():
            return chip_smoke.sdpa_over_pages(q, pk, pv, tbl, pos,
                                              dequant=(ks, vs))
    else:
        want = da.paged_decode_attn_plain(q.float(), pk.float(), pv.float(),
                                          tbl, pos)

        def call():
            return da.paged_decode_attn_cuda(q, pk, pv, tbl, pos)

        def library():
            return chip_smoke.sdpa_over_pages(q, pk, pv, tbl, pos)
    lib_ms = time_ms(library)
    chosen = getattr(da, const)
    try:
        for pages in (1, 2, 4, 8):
            setattr(da, const, pages)
            err = float((call().float() - want).abs().max())
            if err > 2e-2:
                raise AssertionError(f"{const} {pages}: max err {err}")
            print(f"paged_decode_attn{'_quant' if quant else ''} q "
                  f"{list(q.shape)}, {int((pos + 1).sum())} live tokens, "
                  f"{pages} pages ({pages * blk} tokens) per "
                  f"split: {time_ms(call):.4f} ms L2-cold, "
                  f"{time_ms(call, l2_cold=False):.4f} ms L2-warm, device "
                  f"time, enqueue hidden, "
                  f"{chip_smoke.device_ms(call):.4f} ms "
                  f"L2-cold, max abs err {err:.2e}; page gather"
                  f"{' + dequantize' if quant else ''} + SDPA "
                  f"{lib_ms:.4f} ms; the port takes {chosen}", flush=True)
    finally:
        setattr(da, const, chosen)


def sgmv_sweep():
    """Phase 5's SGMV shapes over layer views of a 4-client rank-8 bank:
    decode at each column tile, prefill at each (tokens, columns) tile."""
    din, r, n, L = 4096, 8, 4, 3
    g = torch.Generator(device=DEV).manual_seed(8)
    chosen = (sg.DECODE_COLS, sg.PREFILL_TOKENS, sg.PREFILL_COLS)
    decode_tiles = [(1, c, None) for c in (64, 128, 256, 512, 1024)]
    prefill_tiles = [(1, None, c) for c in (256,)] + [
        (t, None, c) for t in (4, 8) for c in (512, 1024, 2048, 4096)]
    try:
        for dout in (4096, 1024):
            bank_a = (torch.randn((n, L, din, r), generator=g, device=DEV)
                      / din ** 0.5).bfloat16()
            bank_b = (torch.randn((n, L, r, dout), generator=g, device=DEV)
                      * 0.05).bfloat16()
            A, B = bank_a.transpose(0, 1)[1], bank_b.transpose(0, 1)[1]
            for label, rows, bt, tiles in (("decode", 8, 1, decode_tiles),
                                           ("prefill", 4, 256, prefill_tiles)):
                x = torch.randn((rows * bt, din), generator=g,
                                device=DEV).bfloat16()
                ids = torch.arange(rows, device=DEV, dtype=torch.int32) % n
                want = sg.sgmv_plain(x.float(), A.float(), B.float(), ids,
                                     block_t=bt, scale=2.0)

                def call():
                    return sg.sgmv_cuda(x, A, B, ids, block_t=bt, scale=2.0)
                times = []
                for tokens, dcols, pcols in tiles:
                    if bt == 1:
                        sg.DECODE_COLS = dcols
                    else:
                        sg.PREFILL_TOKENS, sg.PREFILL_COLS = tokens, pcols
                    got = call().float()
                    bad = (got - want).abs() > 2e-2 + 2e-2 * want.abs()
                    if bad.any():
                        raise AssertionError(f"sgmv {label} tile {tokens} x "
                                             f"{dcols or pcols}: "
                                             f"{int(bad.sum())} elements off")
                    times.append((chip_smoke.device_ms(call),
                                  tokens, dcols or pcols))
                print(f"sgmv {label} x [{rows * bt}, {din}] block_t {bt} "
                      f"dout {dout}, device time, enqueue hidden, L2-cold, "
                      f"by tokens x columns per block: " + ", ".join(
                          f"{t} x {c} {ms:.4f} ms" for ms, t, c in times)
                      + f"; fastest {min(times)[1]} x {min(times)[2]}; the "
                      f"port takes {chosen}", flush=True)
    finally:
        sg.DECODE_COLS, sg.PREFILL_TOKENS, sg.PREFILL_COLS = chosen


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_sweeps: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    for name in sys.argv[1:] or SWEEPS:
        SWEEPS[name]()
    return 0


# every sweep by name: ``python3 tools/kernel_sweeps.py [name ...]`` runs
# the named ones, in order (all of them without arguments)
SWEEPS = {"ragged": ragged_sweep, "dense": dense_sweep, "flash": flash_sweep,
          "paged": paged_sweep, "paged_quant": lambda: paged_sweep(quant=True),
          "sgmv": sgmv_sweep}


if __name__ == "__main__":
    sys.exit(main())
