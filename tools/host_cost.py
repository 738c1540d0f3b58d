#!/usr/bin/env python3
"""Host time per call of the serving path's kernel wrappers.

    python3 tools/host_cost.py [TREE]

Needs one CUDA device and ``nvcc``. Imports the port from ``TREE/src``
(default: this repository), so two checkouts can be compared in turns on
one card. At phase 4's decode shapes (granite-3-8b: 8 rows, a rank-8 LoRA
bank of 4 clients held as a layer view, q [8, 8, 4, 128] over a pool of
10,240 pages of 16 tokens, bf16 and int8 with f32 scales), it times 200
back-to-back calls of each wrapper with no synchronisation inside (the
kernels take less device time than the host takes to enqueue them, so the
host's clock reads the wrapper's checks, its ctypes call and the launch),
seven times, and prints the median microseconds per call.
"""
from __future__ import annotations

import importlib
import statistics
import sys
import time
from pathlib import Path

TREE = Path(sys.argv[1] if len(sys.argv) > 1
            else Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(TREE / "src"))

import torch  # noqa: E402

DEV = "cuda"


def main() -> int:
    if not torch.cuda.is_available():
        print("host_cost: no CUDA device", file=sys.stderr)
        return 1
    sg = importlib.import_module("repro_torch.kernels.sgmv.sgmv")
    da = importlib.import_module("repro_torch.kernels.decode_attn.decode_attn")
    g = torch.Generator(device=DEV).manual_seed(0)
    n, L, din, r = 4, 40, 4096, 8
    A = torch.randn((n, L, din, r), generator=g, device=DEV).bfloat16()
    B = torch.randn((n, L, r, 4096), generator=g, device=DEV).bfloat16()
    A, B = A.transpose(0, 1)[3], B.transpose(0, 1)[3]    # [n, ...] views
    x = torch.randn((8, din), generator=g, device=DEV).bfloat16()
    ids = torch.arange(8, device=DEV, dtype=torch.int32) % n
    P, blk, K, hd, nb = 10240, 16, 8, 128, 32
    q = torch.randn((8, K, 4, hd), generator=g, device=DEV).bfloat16()
    pk, pv = (torch.randint(-127, 128, (P, blk, K, hd), generator=g,
                            device=DEV, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((P, blk, K, 1), generator=g, device=DEV) * 0.02
              for _ in range(2))
    bk, bv = (torch.randn((P, blk, K, hd), generator=g, device=DEV).bfloat16()
              for _ in range(2))
    tbl = torch.randperm(P, generator=g, device=DEV)[:8 * nb] \
        .reshape(8, nb).to(torch.int32)
    pos = torch.tensor([100, 200, 300, 150, 250, 64, 400, 500], device=DEV,
                       dtype=torch.int32)
    calls = {
        "sgmv decode": lambda: sg.sgmv_cuda(x, A, B, ids, block_t=1,
                                            scale=2.0),
        "int8 paged": lambda: da.paged_decode_attn_quant_cuda(
            q, pk, ks, pv, vs, tbl, pos),
        "bf16 paged": lambda: da.paged_decode_attn_cuda(q, bk, bv, tbl, pos),
    }
    out = []
    for name, fn in calls.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        per = []
        for _ in range(7):
            t = time.perf_counter()
            for _ in range(200):
                fn()
            per.append((time.perf_counter() - t) / 200 * 1e6)
            torch.cuda.synchronize()
        out.append(f"{name} {statistics.median(per):.2f} us")
    print(f"{TREE.name}: host us per call (median of 7 x 200): "
          + "; ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
