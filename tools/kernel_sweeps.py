#!/usr/bin/env python3
"""Tile-width and split-size sweeps of the port's redesigned Hopper kernels.

    python3 tools/kernel_sweeps.py

Needs one CUDA device and ``nvcc``. Times are L2-cold (a 256 MB write
before each call, outside the CUDA events), medians of 30 calls. Two
sweeps, printed one line per shape after the card's name and power limit:

1. the ragged linear's tensor-core entry point at each of its tile widths
   (BN 256, 128, 64) for granite-3-8b's seven projection shapes with 1,001
   of 1,024, 1,030 of 2,048 and 2,048 of 2,048 rows live, beside
   ``torch.addmm`` over the whole buffer and the width ``tile_width``
   picks. The committed source is compiled once more (into ``build/``)
   with two extra C entry points, one that takes BN from its caller and one
   that returns ``tile_width``'s choice, so the sweep times the kernel the
   port launches; each width is first held against the plain version;
2. dense decode attention at ``chip_smoke.py``'s phase-6 shape with splits
   of 64 to 512 tokens: the call's time, and the split and combine kernels'
   device times by ``torch.profiler``, beside SDPA with a mask and GQA.
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

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402

DEV = "cuda"
rl = importlib.import_module("repro_torch.kernels.ragged_linear.ragged_linear")
da = importlib.import_module("repro_torch.kernels.decode_attn.decode_attn")

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
PROJECTIONS = {"q, o": (4096, 4096), "k, v": (4096, 1024),
               "gate, up": (4096, 12800), "down": (12800, 4096)}
ROWS = ((1024, 1001), (2048, 1030), (2048, 2048))   # budget, live rows
_FLUSH = []


def time_ms(fn, n=30):
    if not _FLUSH:
        _FLUSH.append(torch.empty(64 << 20, dtype=torch.int32, device=DEV))
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        _FLUSH[0].zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sweep_library():
    """The kernel source plus the two sweep entry points, built into
    build/ beside the port's libraries."""
    src = (_build.CSRC / "ragged_linear.cu").read_text() + SWEEP_ENTRIES
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "ragged_linear_sweep.cu"
    so = _build.BUILD_DIR / "libragged_linear_sweep.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.sweep_ragged_linear_tc.argtypes = ([ctypes.c_void_p] * 4
                                           + [ctypes.c_int] * 4
                                           + [ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_void_p])
    lib.sweep_ragged_linear_tc.restype = ctypes.c_int
    lib.sweep_tile_width.argtypes = [ctypes.c_int] * 3
    lib.sweep_tile_width.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def ragged_sweep():
    lib = sweep_library()
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
    from torch.profiler import ProfilerActivity, profile
    B, T, K, G, hd = 8, 4096, 8, 4, 128
    g = torch.Generator(device=DEV).manual_seed(10)
    q = torch.randn((B, K, G, hd), generator=g, device=DEV).to(torch.bfloat16)
    k, v = (torch.randn((B, T, K, hd), generator=g, device=DEV)
            .to(torch.bfloat16) for _ in range(2))
    pos = torch.linspace(0, T - 1, B, device=DEV).round().to(torch.int32)
    mask = (torch.arange(T, device=DEV)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(
        q.reshape(B, K * G, 1, hd), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True))
    want = da.decode_attn_plain(q.float(), k.float(), v.float(), pos,
                                block_kv=512)
    chosen = da.DENSE_SPLIT
    try:
        for split in (64, 128, 256, 512):
            da.DENSE_SPLIT = split
            err = float((da.decode_attn_cuda(q, k, v, pos).float() - want)
                        .abs().max())
            ms = time_ms(lambda: da.decode_attn_cuda(q, k, v, pos))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    _FLUSH[0].zero_()
                    da.decode_attn_cuda(q, k, v, pos)
                torch.cuda.synchronize()
            dev = {name: sum(e.device_time_total for e in prof.key_averages()
                             if name in e.key) / 5
                   for name in ("dense_split_kernel", "dense_combine_kernel")}
            print(f"decode_attn dense {[B, T, K, hd]} bf16, split {split}: "
                  f"{ms:.4f} ms (split kernel {dev['dense_split_kernel']:.1f} "
                  f"us, combine {dev['dense_combine_kernel']:.1f} us), max "
                  f"abs err {err:.2e}; SDPA with a mask {sdpa:.4f} ms",
                  flush=True)
    finally:
        da.DENSE_SPLIT = chosen


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_sweeps: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    ragged_sweep()
    dense_sweep()
    return 0


if __name__ == "__main__":
    sys.exit(main())
