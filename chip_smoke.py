#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (it builds the port's CUDA kernels from
``src/repro_torch/csrc`` into ``build/repro_torch``); without a card it
exits non-zero and prints no result. Phases, each raising on failure:

1. device and build: the card's name and power limit, every kernel built;
2. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes (granite-3-8b: K=8, G=4, hd=128, page 16, tables
   with sentinels past each row's pages, rows at pos -1 whose output must
   be exact zeros, one 8,192-token row over a 512-column table and a
   window whose edge cuts a split; the bf16 attention kernel one launch per
   call; the int8 attention kernel, one launch per call too, on the same
   cases over int8 pools drawn over [-127, 127] with f32 scales; SGMV din
   4096, dout 4096/1024, rank 8, one launch per call, including the inputs
   ``sgmv_pallas`` accepts (ids in range or negative), those the JAX op
   takes by padding (T no multiple of block_t, fewer ids than blocks, the
   default block_t of 128), a block_t-256 prefill with a short last block,
   and ranks 16 and 12, dead rows exact +0.0), fp32 at atol = rtol
   = 1e-5 (TF32 off) and bf16 at 2e-2 against the plain version run in
   fp32 on the same bf16 inputs; dense decode attention (split-KV and a
   combine) at granite's K=8, G=4, hd=128 over phase 9's layer slab
   [8, 512, 8, 128] at its decode positions (15 past phase 4's prompts),
   with and without a window, over T=4096 (one row at pos -1, whose output must be
   exact zeros; one case with a window), a prime T, T=32,768 in one row
   (128 splits) and a window whose edge cuts a split; flash attention at
   granite's H=32, K=8 (S=T=2048 causal, and non-causal cross
   S=512/T=2048), gemma2-27b's H=32, K=16 with its 4096 window at
   S=T=8192, and S > T with rows that see no key (exact zeros), each case
   in bf16 on the tensor-core entry point and in fp32 on the SIMT one, and
   stablelm-12b's hd 160 (causal, and cross non-causal) in both dtypes on
   the SIMT one, and whisper-small's hd 64 (1,500 frames, non-causal; a
   448-token causal decoder), hd 96, 256, 80 and 112 (a last partial
   column chunk of 32, 16 and 48) on the SIMT entry in both dtypes (each
   launch's entry checked by its counter); paged decode
   (bf16 and int8) also at page_block 64, 256 and 512, fewer pages per
   split; the ragged linear, rows
   past the live count exact +0.0, each launch's entry point checked by
   its counter: bf16 on the tensor cores at din 4096 / dout 12800 with a
   bias (n_live 1001 of 1024, and 700 of 2048 counted on the card), at
   4096 / 4096 with 1030 of 2048 live (each of the kernel's three tile
   widths runs), at edges no tile divides (1000 x 4104 x 1000, 999 live),
   at n_live 0, and
   on a column view of a granite ``up`` weight at offset 1024; bf16 on the
   SIMT kernel at 1000 x 4100 x 1001 and on the view at offset 4; every
   fp32 case on the SIMT kernel;
3. model wiring: granite-3-8b at full width, 2 layers, bf16 and int8
   caches, one compacted prefill and one decode step with the kernels and
   under ``blocks.plain_kernels()``, logits compared at 2e-2; the kernel
   pass runs under ``torch.cuda.set_sync_debug_mode("error")``, so neither
   step may make the host wait for the device (as far as that mode, a
   PyTorch prototype, detects syncs); then phase 9's dense layout (2
   layers, 4 clients x 2 slots, max_seq 512): a per-client prefill into
   each client's first slot and one masked decode tick over the 8 slot
   rows, with the kernels (the dense kernel 2 launches per layer, SGMV 2
   per layer per call) and under ``plain_kernels()``, logits at 2e-2;
4. serving at full size: granite-3-8b, 40 layers, bf16 random weights, 4
   LoRA clients, 8 staggered requests, greedy, with the kernels' launch
   counts checked per tick; then an 8-row decode tick timed unprofiled
   and traced once with torch.profiler (device activity only): device
   busy share, kernels per tick (no more than before the attention and
   SGMV kernels were split across blocks), top kernels by device time,
   the SGMV and attention kernels' device time per tick beside their aims;
4b. the same 8 requests over int8 KV pages (``kv_quant=True``) behind a
   ``PlacementRouter`` whose one slot holds 4 of the requests' int8
   charges but not all 8, so admission queues on the card: 40 int8
   attention launches and no bf16 ones per decode tick, the same first
   token per request as phase 4, the router's ledger conserved and empty
   after the drain; the same 8-row tick profile, beside phase 4's;
5. timings at the phase-4, 4b and 6 shapes: kernel (L2-cold and L2-warm,
   and the device time with the host's enqueue hidden behind a spin
   kernel, beside its aim for the int8 attention kernel and SGMV at decode
   and prefill), plain version, a library
   yardstick and the memory/compute bound (the dense decode kernel first
   held against its plain version on the timed inputs at 2e-2, its error
   in the kernel line's maximum); each granite-shape
   ragged-linear and bf16 flash launch must take the tensor cores; flash's
   and SDPA's max errors against the plain version;
6. the slice without a serving path: the port's public kernel ops and
   the §3.7 packed base executor. A ``BaseExecutor`` over phase 4's own
   granite-3-8b weights (40 layers x 7 projections, held as views) runs
   every (layer, projection) for 4 clients' bf16 segments of 37, 200, 64
   and 700 tokens (budget 1024), then of 1,030 tokens (budget 2048, past
   the live count 7 of 16 row tiles are dead): exactly one ragged-linear
   launch per call, on the tensor cores, every output held against
   ``frozen_dense`` at 2e-2, the pass timed between synchronisations; each
   pass runs again traced by torch.profiler (device activity only) for
   its device time in the ragged-linear kernels; then
   ``kernels.decode_attn`` on a dense [8, 4096, 8, 128] bf16 cache (two
   launches: split and combine) and ``kernels.flash_attn`` on
   [1, 4096, 32, 128] causal (one, on the tensor cores), held against
   their plain versions;
7. fine-tuning on the card, whose path runs none of the kernels (the
   JAX training forward reaches no Pallas kernel): 7a granite-3-8b's
   width, 2 layers, fp32, the compact multi-job step over 4 jobs of 2 x
   256 tokens against each job's ``make_baseline_train_step`` (losses at
   1e-4; adapters and AdamW moments at rtol 1e-4 with an atol of 1e-3 of
   each leaf's largest magnitude, at most 1e-4), then a padding row and a
   NaN-poisoned row that must commit nothing while the other rows equal
   the unpoisoned call bit for bit, and ``frozen_dense``'s dx against
   autograd with the weight its only saved tensor; 7b a ``FinetuneEngine``
   over phase 4's 40-layer base, 5 LoRA jobs (rank 8, q and v, 3 steps)
   behind a router whose slot makes the fifth wait: finite losses, the
   ledger conserved and empty, job 0's losses against its solo run at
   atol 2e-3 and its adapter's update (final minus initial) within 0.25
   of the solo run's in relative norm, tick
   times on the host clock and one tick traced (device activity only);
   7c the peak memory beyond the base of one step at 1 and 4 jobs, §3.6
   path and torch-like baseline (printed); 7d a ``SymbiosisEngine``
   serving phase 4's requests beside 4 jobs on the same base tensors:
   every greedy stream equal to phase 4's, every job's losses to 7b's,
   the launch counts to phase 4's (tick by tick);
8. mixed-method banks and shared-prefix pages on phase 4's base tensors
   (bf16 pools, page_block 16, max_seq 512): banks LoRA r8 (q, v), IA3
   (k, v, down) and prefix (16 tokens), 2 clients each, behind a router
   whose slot holds the bank charges and the requests' pages; each client
   sends its own 232-token template + 40, + 1, + 24 and + another 1
   tokens, 3 ticks apart, 16 new tokens greedy; a LoRA r16 (q, k, v, o)
   bank is admitted at tick 4 (its clients send template + 40 and + 1)
   and retired after the drain. ``debug=True`` audits conservation every
   tick; after the drain every refcount is 0, every page back in its
   owner's free list and the router ledger empty once the banks are
   released. The prefix hits, pages shared, copies on write and computed
   prompt tokens equal the counts the JAX engine gives for the same
   schedule (pinned from ``tests/test_torch_prefix_cache.py``); every
   published page equals its copy at publish when its last reference
   drops, and every copy-on-write page its source on the copied tokens;
   SGMV launches per decode tick or prefill batch equal the count derived
   from the registry (3 per layer, 9 once the r16 bank joins), paged
   attention one per layer, int8 none. The workload again with the IA3
   scales x 1.5: every other bank's stream and pool page bit for bit.
   Then, at granite's width with 2 layers, a suffix prefill over 14
   shared pages against the full prefill (fp32 at 1e-5, TF32 off; bf16
   at 2e-2) and an 8-row mixed decode step against each bank's
   single-method step (its rows bit for bit). Printed: the workload with
   ``prefix_cache=False`` (streams equal to the shared run's, and where
   one differs, the step and its top-2 logit gap), hit and miss prefill
   batch times, and an 8-row mixed decode tick profiled as phase 4's;
9. the dense KV layout and the masked bank-wide step on phase 4's base
   tensors and bank (4 LoRA clients x 2 slots, ``max_seq`` 512, phase 4's
   8 requests), launch counts checked tick by tick: 9a ``page_block=0``
   under each policy, the dense decode kernel 2 x 40 launches per decode
   tick (split and combine), paged attention none, SGMV 80 per decode
   tick and per per-client prefill; every request's stream equal bit for
   bit to it served alone by a fresh dense engine (a request that a
   ragged per-client prefill carried at a larger bucket than its own: to
   that ragged batch served alone, its own solo run printed); the streams
   printed against phase 4's; 9b ``compact_decode=False`` on phase 4's
   pages, 40 paged launches per decode tick, streams printed against
   phase 4's, and one all-active 8-row masked step against the compacted
   step on copies of the same caches, logits and pools bit for bit; 9c
   int8 dense caches, finite, no attention kernel (plain torch, as JAX);
   9d an 8-row dense tick and a masked paged tick with 2 of 8 slots
   active profiled as phase 4's, printed beside it. Phase 5 times the
   dense kernel at phase 9's slab too ([8, 512, 8, 128], positions 15
   past phase 4's prompts): the kernel line's timing, its launches phase
   9a's;
10. every PEFT method fine-tunes on phase 4's base tensors, and tenants'
   state survives a crash. 10a at granite's width, 2 layers, fp32: the
   compact step over an IA3 bank (k, v, down) and a prefix bank (16
   tokens, q, v), 4 rows each, every row against its solo step (7a's
   tolerance), a padding and a NaN row committing nothing, bit for bit;
   per method ``make_multi_client_train_step`` against the compact step at
   the same hyperparameters (7a's tolerance; bit for bit printed) and
   ``make_mixed_step`` against its train and decode halves run apart, bit
   for bit, every launch count set to 0 just before it and read just
   after (the dense decode kernel 2 per layer, SGMV 2 per layer for LoRA,
   nothing else), and its decode half's logits and caches against the
   decode step under ``plain_kernels()`` at 1e-5 (8 rows, T 64, fp32: the
   kernels at the shape this path gives them; no launch in that pass);
   10b a ``FinetuneEngine(debug=True)`` at full size with 2 LoRA r8, 2 IA3
   and 2 prefix jobs of 2 x 256 tokens, 3 steps each: every job's losses
   and adapter update against its solo run (7b's tolerances), tick times, one
   tick per bank timed and traced, and the peak memory beyond the base of
   one step at 1 job per method beside ``job_hbm_bytes``' charge
   (printed); 10c the engine killed after 2 ticks and resumed by a fresh
   engine from ``engine_state()`` through a CRC-framed blob (a newer copy
   with a flipped byte skipped): every job's losses, adapter and AdamW
   state bit for bit the uninterrupted run's; an IA3 job poisoned to NaN
   at its third batch quarantined with its last clean state in
   ``quarantine_dir``, restored bit for bit; 10d a ``SymbiosisEngine``
   serving phase 4's 8 requests beside the six jobs: every stream and
   launch count phase 4's, every job's losses, adapter and AdamW state
   10b's bit for bit.

The second-to-last line is the JSON kernel summary, the last
``{"ok": true, "device": {...}}``. Weights are random, drawn from seeds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.checkpoint import (load_engine_state,  # noqa: E402
                                    restore_job_state, save_engine_state)
from repro_torch.common.hardware import H100  # noqa: E402
from repro_torch.common.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.config import (AdapterConfig, FinetuneConfig,  # noqa: E402
                                ServeConfig, TrainConfig)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import adapters, symbiosis  # noqa: E402
from repro_torch.core.base_executor import BaseExecutor, _bucket  # noqa: E402
from repro_torch.core.frozen_linear import frozen_dense  # noqa: E402
from repro_torch.core.engine_spec import BankSpec, EngineSpec  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.models import blocks, get_model  # noqa: E402
from repro_torch.optim import AdamWState, adamw_init  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.router import PlacementRouter, Slot  # noqa: E402
from repro_torch.training import (FinetuneEngine, FinetuneJob,  # noqa: E402
                                  SymbiosisEngine, job_hbm_bytes,
                                  make_job_stream)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
SENTINEL = 1 << 30
DEV = "cuda"
# the kernel modules (the packages re-export ops functions of the same name)
da = importlib.import_module("repro_torch.kernels.decode_attn.decode_attn")
sg = importlib.import_module("repro_torch.kernels.sgmv.sgmv")
fa = importlib.import_module("repro_torch.kernels.flash_attn.flash_attn")
rl = importlib.import_module("repro_torch.kernels.ragged_linear.ragged_linear")
KERNELS = {   # name: (launch wrapper, source, the TPU kernel it replaces)
    "paged_decode_attn": (da.paged_decode_attn_cuda, da.SOURCE, da.REPLACES),
    "paged_decode_attn_quant": (da.paged_decode_attn_quant_cuda,
                                da.QUANT_SOURCE, da.QUANT_REPLACES),
    "sgmv": (sg.sgmv_cuda, sg.SOURCE, sg.REPLACES),
    "decode_attn": (da.decode_attn_cuda, da.SOURCE, da.DENSE_REPLACES),
    "flash_attn": (fa.flash_attn_cuda, fa.SOURCE, fa.REPLACES),
    "ragged_linear": (rl.ragged_linear_cuda, rl.SOURCE, rl.REPLACES),
}


def reset_counts():
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0
    for counts in (rl.ragged_linear_cuda.by_entry, fa.flash_attn_cuda.by_entry):
        for entry in counts:
            counts[entry] = 0


def read_counts():
    return {name: w.launches for name, (w, _, _) in KERNELS.items()}


def launch_count(name):
    return KERNELS[name][0].launches


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
    "granite_pos_minus_one": (4, 8, 4, 128, 16, 32, 0, [-1, 40, -1, 300]),
    # one 8,192-token row over a 512-column table: many splits to merge
    "granite_one_row_8192": (1, 8, 4, 128, 16, 512, 0, [8191]),
    # pages longer than the tuned splits: the wrapper takes fewer pages per
    # split (one page of 512 tokens is one split)
    "granite_page_block_64": (4, 8, 4, 128, 64, 8, 0, [0, 63, 64, 511]),
    "granite_page_block_256": (3, 8, 4, 128, 256, 3, 40, [255, 256, 767]),
    "granite_page_block_512": (2, 8, 4, 128, 512, 2, 0, [511, 1000]),
    # window edges 7 and 39 tokens into a split of any power-of-two pages
    "granite_window_cuts_a_split": (3, 8, 4, 128, 16, 32, 70,
                                    [300, 108, 511]),
}


def zeros_at_pos_minus_one(what, got, pos):
    """Rows at pos -1 attend nothing: exact +0.0."""
    dead = got[pos < 0]
    if dead.any() or torch.signbit(dead).any():
        raise AssertionError(f"{what}: a row at pos -1 is not exact zeros")


def check_paged(errs):
    for i, (name, (B, K, G, hd, blk, nb, window, pos)) in enumerate(
            PAGED_CASES.items()):
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            q, pk, pv, tbl, p = paged_case(B, K, G, hd, blk, nb, 100 + i, pos,
                                           dtype)
            before = launch_count("paged_decode_attn")
            got = da.paged_decode_attn_cuda(q, pk, pv, tbl, p, window=window)
            if launch_count("paged_decode_attn") != before + 1:
                raise AssertionError(f"paged_decode_attn {name}: not one "
                                     "launch")
            want = da.paged_decode_attn_plain(q.float(), pk.float(), pv.float(),
                                              tbl, p, window=window)
            torch.cuda.synchronize()
            e = compare(f"paged_decode_attn {name} {dtype}", got, want, tol)
            zeros_at_pos_minus_one(f"paged_decode_attn {name}", got, p)
            errs.append(e)
            log(f"[phase 2] paged_decode_attn {name:24s} {str(dtype):15s} "
                f"max_abs_err={e:.3e}")


def check_paged_quant(errs):
    """The int8 kernel on the same cases: int8 pools over the full
    [-127, 127] range, f32 per-head scales, q in fp32 and in bf16."""
    for i, (name, (B, K, G, hd, blk, nb, window, pos)) in enumerate(
            PAGED_CASES.items()):
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            q, _, _, tbl, p = paged_case(B, K, G, hd, blk, nb, 300 + i, pos,
                                         dtype)
            g = gen(400 + i)
            P = B * nb + 7
            pk, pv = (torch.randint(-127, 128, (P, blk, K, hd), generator=g,
                                    device=DEV, dtype=torch.int8)
                      for _ in range(2))
            ks, vs = (torch.rand((P, blk, K, 1), generator=g, device=DEV)
                      * 0.025 + 0.005 for _ in range(2))
            before = launch_count("paged_decode_attn_quant")
            got = da.paged_decode_attn_quant_cuda(q, pk, ks, pv, vs, tbl, p,
                                                  window=window)
            if launch_count("paged_decode_attn_quant") != before + 1:
                raise AssertionError(f"paged_decode_attn_quant {name}: not "
                                     "one launch")
            want = da.paged_decode_attn_quant_plain(q.float(), pk, ks, pv, vs,
                                                    tbl, p, window=window)
            torch.cuda.synchronize()
            e = compare(f"paged_decode_attn_quant {name} {dtype}", got, want,
                        tol)
            zeros_at_pos_minus_one(f"paged_decode_attn_quant {name}", got, p)
            if got.dtype != q.dtype:
                raise AssertionError(f"int8 attention returned {got.dtype} "
                                     f"for q in {q.dtype}")
            errs.append(e)
            log(f"[phase 2] paged_decode_attn_quant {name:24s} "
                f"{str(dtype):15s} max_abs_err={e:.3e}")


SGMV_CASES = {    # (T, block_t, dout, rank, ids), din 4096
    "decode_1row_q": (1, 1, 4096, 8, [2]),
    "decode_5rows_v": (5, 1, 1024, 8, [0, -1, 3, 9, 1]),
    "decode_16rows_q": (16, 1, 4096, 8, [0, 1, 2, 3, -1, 5, 1, 1, 0, 2, 3, 3,
                                         7, -1, 2, 0]),
    "decode_16rows_v": (16, 1, 1024, 8, [3, 2, 1, 0, 0, -1, 4, 1, 2, 2, 3, 1,
                                         0, 0, -1, 3]),
    "prefill_S128_q": (384, 128, 4096, 8, [1, -1, 9]),
    "prefill_S256_v": (512, 256, 1024, 8, [3, 0]),
    # what sgmv_pallas (unclamped index_map) accepts: ids in range or dead
    "pallas_ids_decode_8rows_q": (8, 1, 4096, 8, [0, 3, -1, 2, 1, -1, 3, 0]),
    "pallas_ids_prefill_S64_v": (256, 64, 1024, 8, [2, -1, 0, 3]),
    # what the JAX op takes by padding: T no multiple of block_t, fewer ids
    # than blocks (the rest dead), the default block_t of 128
    "t100_block32_last_short": (100, 32, 4096, 8, [1, 2, -1, 0]),
    "t64_block16_2_of_4_ids": (64, 16, 1024, 8, [3, 1]),
    "t300_default_block_1_id": (300, 128, 4096, 8, [2]),
    # the prefill shape in blocks of 256, the last one short
    "prefill_block256_short_last": (1000, 256, 4096, 8, [0, 1, 2, 3]),
    # rank 16 (the fast path's other rank) and 12 (the generic path)
    "rank16_decode_q": (8, 1, 4096, 16, [0, 1, 2, 3, 3, 2, -1, 0]),
    "rank16_prefill_v": (300, 128, 1024, 16, [1, 0, 2]),
    "rank12_decode_v": (5, 1, 1024, 12, [3, -1, 0, 1, 1]),
    "rank12_prefill_q": (200, 64, 4096, 12, [2, 0, -1, 1]),
}


def check_sgmv(errs):
    din, n = 4096, 4
    for i, (name, (T, bt, dout, r, ids)) in enumerate(SGMV_CASES.items()):
        g = gen(200 + i)
        x = torch.randn((T, din), generator=g, device=DEV)
        bank_a = torch.randn((n, 3, din, r), generator=g, device=DEV) / din ** 0.5
        bank_b = torch.randn((n, 3, r, dout), generator=g, device=DEV) * 0.05
        ids_t = torch.tensor(ids, dtype=torch.int32, device=DEV)
        live = torch.zeros(T, dtype=torch.bool, device=DEV)
        for b, a in enumerate(ids):
            live[b * bt:(b + 1) * bt] = a >= 0
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            # layer-major views of a [C, L, ...] bank: a strided client axis,
            # as the serving path passes it
            xd = x.to(dtype)
            Ad = bank_a.to(dtype).transpose(0, 1)[1]
            Bd = bank_b.to(dtype).transpose(0, 1)[1]
            before = launch_count("sgmv")
            got = sg.sgmv_cuda(xd, Ad, Bd, ids_t, block_t=bt, scale=2.0)
            if launch_count("sgmv") != before + 1:
                raise AssertionError(f"sgmv {name}: not one launch")
            want = sg.sgmv_plain(xd.float(), Ad.float(), Bd.float(), ids_t,
                                 block_t=bt, scale=2.0)
            torch.cuda.synchronize()
            e = compare(f"sgmv {name} {dtype}", got, want, tol)
            dead = got[~live]
            if dead.any() or torch.signbit(dead).any():
                raise AssertionError(f"sgmv {name}: dead rows not exact +0.0")
            errs.append(e)
            log(f"[phase 2] sgmv {name:30s} {str(dtype):15s} max_abs_err={e:.3e}")


def plain_call(op, *args, **kw):
    """The public op's plain version on the card, with the op's own
    blocks."""
    with kernels.plain_kernels():
        return op(*args, **kw)


def plain_op(op, *args, **kw):
    """``plain_call`` in fp32 on the same inputs (bf16 ones widened
    exactly): the reference a kernel is held against."""
    return plain_call(op, *[a.float() if torch.is_tensor(a)
                            and a.is_floating_point() else a for a in args],
                      **kw)


DENSE_CASES = {   # (B, T, window, pos): granite K=8, G=4, hd=128
    # phase 9's layer slab (4 clients x 2 slots, max_seq 512) at its decode
    # positions (None: ``slab_positions``), and a window cutting the rows
    "phase9_slab_T512": (8, 512, 0, None),
    "phase9_slab_T512_window": (8, 512, 100, None),
    "granite_T4096": (4, 4096, 0, [-1, 0, 2047, 4095]),
    "granite_T4096_window": (4, 4096, 1000, [100, 1500, 4095, 999]),
    "granite_T4093_prime": (2, 4093, 0, [4092, 77]),
    "granite_B1_T32768_many_splits": (1, 32768, 0, [32767]),
    "granite_window_cuts_a_split": (2, 4096, 300, [700, 4095]),
}


def slab_positions():
    """Phase 9's decode positions: 15 past each of phase 4's 8 prompts."""
    return [r.prompt.shape[1] + 15
            for r in make_requests(get_config("granite-3-8b"), 4)]


def check_dense(errs):
    K, G, hd = 8, 4, 128
    for i, (name, (B, T, window, pos)) in enumerate(DENSE_CASES.items()):
        g = gen(500 + i)
        q = torch.randn((B, K, G, hd), generator=g, device=DEV)
        k = torch.randn((B, T, K, hd), generator=g, device=DEV)
        v = torch.randn((B, T, K, hd), generator=g, device=DEV)
        p = torch.tensor(slab_positions() if pos is None else pos,
                         dtype=torch.int32, device=DEV)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            got = da.decode_attn_cuda(qd, kd, vd, p, window=window)
            want = plain_op(kernels.decode_attn, qd, kd, vd, p, window=window)
            torch.cuda.synchronize()
            e = compare(f"decode_attn {name} {dtype}", got, want, tol)
            zeros_at_pos_minus_one(f"decode_attn {name}", got, p)
            errs.append(e)
            log(f"[phase 2] decode_attn {name:24s} {str(dtype):15s} "
                f"max_abs_err={e:.3e}")


FLASH_CASES = {   # (B, S, T, H, K, causal, window, hd)
    "granite_causal_2048": (1, 2048, 2048, 32, 8, True, 0, 128),
    "granite_cross_512x2048": (1, 512, 2048, 32, 8, False, 0, 128),
    "gemma2_window_8192": (1, 8192, 8192, 32, 16, True, 4096, 128),
    "s_above_t_no_key_rows": (2, 300, 200, 8, 2, True, 50, 128),
    # stablelm-12b: 32 / 8 heads of 160 (the SIMT entry in both dtypes)
    "stablelm_hd160_causal_1024": (1, 1024, 1024, 32, 8, True, 0, 160),
    "stablelm_hd160_cross_100x300": (2, 100, 300, 32, 8, False, 0, 160),
    # whisper-small: 12 heads of 64, 1,500 encoder frames (non-causal) and
    # a 448-token causal decoder; and hd 96 and 256 (the SIMT entry)
    "whisper_hd64_encoder_1500": (1, 1500, 1500, 12, 12, False, 0, 64),
    "whisper_hd64_causal_448": (2, 448, 448, 12, 12, True, 0, 64),
    "hd96_window_512": (1, 512, 512, 16, 4, True, 100, 96),
    "hd256_causal_1024": (1, 1024, 1024, 16, 8, True, 0, 256),
    # a last partial 64-column chunk of 16 and of 48 columns (hd 160 and
    # 96 leave 32): the SIMT kernel's column guard at every remainder
    "hd80_causal_512": (1, 512, 512, 16, 4, True, 0, 80),
    "hd112_cross_100x300": (2, 100, 300, 8, 8, False, 0, 112),
}


def check_flash(errs):
    """Every case in fp32 on the SIMT entry point and in bf16 on the
    tensor-core one at hd 128, on the SIMT one at every other head dim
    (each launch's entry asserted by its counter)."""
    for i, (name, (B, S, T, H, K, causal, window, hd)) in enumerate(
            FLASH_CASES.items()):
        g = gen(600 + i)
        q = torch.randn((B, S, H, hd), generator=g, device=DEV)
        k = torch.randn((B, T, K, hd), generator=g, device=DEV)
        v = torch.randn((B, T, K, hd), generator=g, device=DEV)
        bf16_entry = fa.WGMMA if hd == fa.HEAD_DIM else fa.SIMT
        for dtype, tol, entry in ((torch.float32, F32_TOL, fa.SIMT),
                                  (torch.bfloat16, BF16_TOL, bf16_entry)):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            before = dict(fa.flash_attn_cuda.by_entry)
            got = fa.flash_attn_cuda(qd, kd, vd, causal=causal, window=window)
            took = [e for e, c in fa.flash_attn_cuda.by_entry.items()
                    if c != before[e]]
            if took != [entry]:
                raise AssertionError(f"flash_attn {name} {dtype}: took "
                                     f"{took}, not {entry}")
            # non-causal: one kv block, since the op's blocks must divide T
            want = plain_op(kernels.flash_attn, qd, kd, vd, causal=causal,
                            window=window, **({} if causal else
                                              {"block_kv": T}))
            torch.cuda.synchronize()
            e = compare(f"flash_attn {name} {dtype}", got, want, tol)
            blind = got[:, T + window - 1:] if causal and window else got[:, :0]
            if blind.any() or torch.signbit(blind).any():
                raise AssertionError(f"flash_attn {name}: rows that see no "
                                     "key are not exact zeros")
            errs.append(e)
            log(f"[phase 2] flash_attn {name:28s} hd {hd} {str(dtype):15s} "
                f"{entry:5s} max_abs_err={e:.3e}")
            del got, want


RAGGED_CASES = {  # (budget, din, dout, n_live, live count on the card,
    #                bf16 entry point; fp32 always takes the SIMT one). The
    #                tensor-core cases cover its three tile widths: 256 (up),
    #                128 (o at 1,030 of 2,048), 64 (the last two)
    "granite_up_1001_of_1024": (1024, 4096, 12800, 1001, False, rl.WGMMA),
    "granite_up_700_of_2048": (2048, 4096, 12800, 700, True, rl.WGMMA),
    "granite_o_1030_of_2048": (2048, 4096, 4096, 1030, False, rl.WGMMA),
    "tc_no_tile_divides": (1000, 4104, 1000, 999, True, rl.WGMMA),
    "n_live_0": (256, 4096, 4096, 0, True, rl.WGMMA),
    "simt_no_tile_divides": (1000, 4100, 1001, 999, True, rl.SIMT),
}
UP_VIEW = (1024, 4096, 1001)  # budget, view columns, n_live: a column view
#                               of granite's up [4096, 12800] at offset 1024


def check_ragged_case(name, x, w, b, n, n_live, want_entry, errs):
    """One launch against the plain version in fp32 on the same inputs;
    the entry point it took (by its counter) must be ``want_entry``."""
    before = dict(rl.ragged_linear_cuda.by_entry)
    got = rl.ragged_linear_cuda(x, w, b, n_live)
    took = [e for e, c in rl.ragged_linear_cuda.by_entry.items()
            if c != before[e]]
    if took != [want_entry]:
        raise AssertionError(f"ragged_linear {name} {x.dtype}: took {took}, "
                             f"not {want_entry}")
    want = plain_op(kernels.ragged_linear, x, w, b, n_live)
    torch.cuda.synchronize()
    tol = F32_TOL if x.dtype == torch.float32 else BF16_TOL
    e = compare(f"ragged_linear {name} {x.dtype}", got, want, tol)
    tail = got[n:]
    if tail.any() or torch.signbit(tail).any():
        raise AssertionError(f"ragged_linear {name}: rows past n_live are "
                             "not exact +0.0")
    errs.append(e)
    log(f"[phase 2] ragged_linear {name:24s} {str(x.dtype):15s} "
        f"{want_entry:5s} max_abs_err={e:.3e}")


def check_ragged(errs):
    for i, (name, (budget, din, dout, n, on_card, entry)) in enumerate(
            RAGGED_CASES.items()):
        g = gen(700 + i)
        x = torch.randn((budget, din), generator=g, device=DEV)
        w = (torch.rand((din, dout), generator=g, device=DEV) * 2 - 1) \
            / din ** 0.5
        b = torch.randn((dout,), generator=g, device=DEV) * 0.1
        n_live = torch.tensor(n, dtype=torch.int32, device=DEV) if on_card \
            else n
        for dtype in (torch.float32, torch.bfloat16):
            check_ragged_case(name, *(t.to(dtype) for t in (x, w, b)), n,
                              n_live, entry if dtype == torch.bfloat16
                              else rl.SIMT, errs)
    budget, cols, n = UP_VIEW
    g = gen(750)
    up = ((torch.rand((4096, 12800), generator=g, device=DEV) * 2 - 1) / 64) \
        .to(torch.bfloat16)
    x = torch.randn((budget, 4096), generator=g, device=DEV)
    for off, entry in ((1024, rl.WGMMA), (4, rl.SIMT)):
        w = up[:, off:off + cols]
        check_ragged_case(f"up_view_at_{off}", x.to(torch.bfloat16), w, None,
                          n, n, entry, errs)


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


def model_wiring(quant):
    """Full-width granite, 2 layers: compacted prefill + decode with the
    kernels and under plain_kernels(), over bf16 or (``quant``) int8
    caches; logits must agree at bf16 tolerance. The kernel pass must not
    sync the host (a CUDA graph could capture it)."""
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=2)
    C, max_b, max_seq, blk = 4, 2, 512, 16
    scfg = ServeConfig(n_clients=C, max_seq=max_seq, page_block=blk,
                       kv_quant=quant)
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
                                              quant=quant, device=DEV)
        caches["block_tbl"] = torch.tensor(tbl, device=DEV)
        prompts = (torch.tensor(toks, device=DEV),
                   torch.tensor(lengths, device=DEV),
                   torch.zeros(C, dtype=torch.int32, device=DEV))
        with blocks.plain_kernels() if plain else no_host_sync():
            lg1, _, caches = prefill(base, bank, caches, *prompts, *rows)
            if nxt is None:
                nxt = lg1.argmax(-1).to(torch.int32)
            lg2, _, caches = decode(base, bank, caches, nxt, *rows)
        out.append((lg1, lg2))
    torch.cuda.synchronize()
    e1 = compare("model prefill logits", out[0][0], out[1][0], BF16_TOL)
    e2 = compare("model decode logits", out[0][1], out[1][1], BF16_TOL)
    log(f"[phase 3] granite-3-8b width, 2 layers, "
        f"{'int8' if quant else 'bf16'} caches: prefill logits max_abs_err="
        f"{e1:.3e}, decode logits max_abs_err={e2:.3e} (kernels vs plain); "
        "no host sync in the kernel pass")


def dense_wiring():
    """Full-width granite, 2 layers, phase 9's dense layout (4 clients x 2
    slots, max_seq 512): a per-client prefill into each client's first
    slot, then one masked decode tick over the 8 slot rows with the first
    slots active, with the kernels and under plain_kernels(). Logits must
    agree at bf16 tolerance; the kernel pass must launch the dense kernel
    2 per layer in the tick and SGMV 2 per layer per call, the plain pass
    nothing."""
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=2)
    C, max_b, max_seq, L = 4, 2, 512, cfg.n_layers
    scfg = ServeConfig(n_clients=C, max_seq=max_seq, page_block=0)
    base, bank = make_system(cfg, C, seed=1)
    rng = np.random.default_rng(5)
    lengths = rng.integers(64, 257, C).astype(np.int32)
    toks = np.zeros((C, max_b, 256), np.int32)
    for c, n in enumerate(lengths):
        toks[c, 0, :n] = rng.integers(0, cfg.vocab, n)
    slot_mask = torch.tensor([True, False], device=DEV)
    active = torch.zeros((C, max_b), dtype=torch.bool, device=DEV)
    active[:, 0] = True
    prefill = symbiosis.make_client_prefill(cfg, LORA, scfg)
    decode = symbiosis.make_masked_decode_step(cfg, LORA, scfg)
    out, nxt = [], None
    for plain in (False, True):
        caches = symbiosis.init_client_caches(cfg, C, max_b, max_seq,
                                              device=DEV)
        torch.cuda.synchronize()
        reset_counts()
        with blocks.plain_kernels() if plain else contextlib.nullcontext():
            lg1 = []
            for c, n in enumerate(lengths):
                lg, caches = prefill(
                    base, bank, caches, c, c, torch.tensor(toks[c],
                                                           device=DEV),
                    torch.tensor([n, 0], dtype=torch.int32, device=DEV),
                    slot_mask)
                lg1.append(lg[0])
            lg1 = torch.stack(lg1)
            if nxt is None:
                nxt = torch.zeros((C, max_b), dtype=torch.int32, device=DEV)
                nxt[:, 0] = lg1.argmax(-1)
            lg2, caches = decode(base, bank, caches, nxt, active)
        torch.cuda.synchronize()
        want = {n: 0 for n in KERNELS}
        if not plain:
            want.update(decode_attn=2 * L, sgmv=2 * L * (C + 1))
        if read_counts() != want:
            raise AssertionError(f"[phase 3] dense tick launches "
                                 f"{read_counts()}, want {want}")
        out.append((lg1, lg2[:, 0]))
    e1 = compare("dense prefill logits", out[0][0], out[1][0], BF16_TOL)
    e2 = compare("dense decode logits", out[0][1], out[1][1], BF16_TOL)
    log(f"[phase 3] granite-3-8b width, 2 layers, dense caches [L, C, B, T, "
        f"K, hd] = {list(caches['layers']['k'].shape)}: per-client prefill "
        f"logits max_abs_err={e1:.3e}, masked decode logits (4 of 8 slots "
        f"active) max_abs_err={e2:.3e} (kernels vs plain; decode_attn "
        f"{2 * L}, sgmv {2 * L * (C + 1)} launches in the kernel pass)")


def _timed(fn, bucket):
    def run(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        bucket.append(time.perf_counter() - t)
        return out
    return run


def make_requests(cfg, C):
    """The 8 staggered one-row requests of phases 4 and 4b: prompts of
    64-256 tokens, 16 new tokens each, one arrival per tick."""
    rng = np.random.default_rng(4)
    return [Request(client_id=i % C, max_new_tokens=16, arrive_tick=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        (1, int(rng.integers(64, 257))))
                    .astype(np.int32)) for i in range(8)]


def serve_spec(cfg, quant):
    C = 4
    scfg = ServeConfig(n_clients=C, max_seq=512, page_block=16,
                       policy="opportunistic", kv_quant=quant)
    return EngineSpec(cfg=cfg, banks=(BankSpec("tenants", LORA, C),),
                      serve=scfg, max_batch_per_client=2)


def drive(eng, reqs, label, attn_name, idle_name):
    """Serve ``reqs`` to completion with every launch count set to 0 just
    before and read just after; per tick, the attention kernel
    ``attn_name`` must launch once per layer and decode tick, ``idle_name``
    never, and SGMV twice per layer and decode tick or prefill batch.
    Returns the counts and the timings."""
    L = eng.cfg.n_layers
    attn, idle, sgmv = (KERNELS[n][0] for n in (attn_name, idle_name, "sgmv"))
    for r in reqs:
        eng.submit(r)
    pre_t, dec_t, tick_t, step_t = [], [], [], []
    eng._prefill_step = _timed(eng._prefill_step, pre_t)
    eng._decode_step = _timed(eng._decode_step, dec_t)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    more = True
    while more:
        before = (attn.launches, idle.launches, sgmv.launches,
                  eng.stats["ticks"], eng.stats["compact_prefill_batches"])
        torch.cuda.synchronize()
        t_tick = time.perf_counter()
        more = eng.service_tick()
        torch.cuda.synchronize()
        t_tick = time.perf_counter() - t_tick
        d_at, d_idle, d_sg, d_tick, d_pre = (
            a - b for a, b in zip((attn.launches, idle.launches,
                                   sgmv.launches, eng.stats["ticks"],
                                   eng.stats["compact_prefill_batches"]),
                                  before))
        if d_at != L * d_tick or d_idle or d_sg != 2 * L * (d_tick + d_pre):
            raise AssertionError(
                f"[{label}] tick {eng._tick}: {d_at} {attn_name}, "
                f"{d_idle} {idle_name} and {d_sg} SGMV launches for "
                f"{d_tick} decode ticks and {d_pre} prefills")
        if d_tick and not d_pre:
            tick_t.append(t_tick)
            step_t.append(dec_t[-1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    done = eng.drain_done()
    if len(done) != len(reqs) or eng.stats["quarantined_requests"]:
        raise AssertionError(f"[{label}] {len(done)} of {len(reqs)} requests "
                             f"finished, {eng.stats['quarantined_requests']} "
                             "with non-finite logits")
    for r in done:
        g = r.generated
        if r.status != "ok" or g.shape != (1, 16) or g.min() < 0 \
                or g.max() >= eng.cfg.vocab:
            raise AssertionError(f"[{label}] request of client {r.client_id}:"
                                 f" status {r.status}, tokens {g}")
    if not (launches[attn_name] and launches["sgmv"]):
        raise AssertionError(f"[{label}] a kernel never launched on the "
                             f"path: {launches}")
    st = eng.stats
    log(f"[{label}] served {len(done)} requests ({st['prefill_tokens']} "
        f"prompt + {st['decode_tokens'] + len(done)} generated tokens) in "
        f"{wall:.3f} s; {st['ticks']} decode ticks, "
        f"{st['compact_prefill_batches']} prefill batches, peak in flight "
        f"{st['peak_inflight']}, launches {launches}")
    log(f"[{label}] prefill {st['prefill_tokens'] / sum(pre_t):.1f} tokens/s "
        f"({sum(pre_t) * 1e3:.2f} ms over {len(pre_t)} batches); decode "
        f"{st['decode_tokens'] / sum(dec_t):.1f} tokens/s; decode-step ms "
        f"{statistics.median(dec_t) * 1e3:.3f} (median), "
        f"{statistics.mean(dec_t) * 1e3:.3f} (mean) over {len(dec_t)} steps")
    log(f"[{label}] {len(tick_t)} ticks without admission: decode-step ms "
        f"{statistics.median(step_t) * 1e3:.3f}, service-tick ms "
        f"{statistics.median(tick_t) * 1e3:.3f} (medians; the tick adds the "
        f"logits' copy to the host, sampling and retirement)")
    log(f"[{label}] launches per decode tick: {attn_name} "
        f"{launches[attn_name] / st['ticks']:g}; "
        f"sgmv per decode tick or prefill batch "
        f"{launches['sgmv'] / (st['ticks'] + st['compact_prefill_batches']):g}"
        f" (checked tick by tick)")
    return launches, dict(step_ms=statistics.median(step_t) * 1e3,
                          tick_ms=statistics.median(tick_t) * 1e3)


def warm_up(spec, base, bank):
    """First cuBLAS/allocator use (and, for int8, the quantizer's first
    launches) stays out of the timed runs."""
    warm = ServingEngine(spec, base, [bank], device=DEV)
    warm.submit(Request(0, np.arange(64, dtype=np.int32)[None], 2))
    warm.run()


def serve_full():
    """granite-3-8b at full depth and width behind the port's engine."""
    cfg = get_config("granite-3-8b")
    C, L = 4, cfg.n_layers
    spec = serve_spec(cfg, quant=False)
    t0 = time.perf_counter()
    base, bank = make_system(cfg, C, seed=2)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(base))
    log(f"[phase 4] {cfg.name}: {L} layers, {n_params / 1e9:.2f} B params "
        f"bf16 initialised in {time.perf_counter() - t0:.1f} s")
    warm_up(spec, base, bank)
    eng = ServingEngine(spec, base, [bank], device=DEV)
    reqs = make_requests(cfg, C)
    launches, times = drive(eng, reqs, "phase 4", "paged_decode_attn",
                            "paged_decode_attn_quant")
    times.update(profile_tick(cfg, base, [bank], spec, "phase 4"))
    first = [int(r.generated[0, 0]) for r in reqs]
    lengths = [r.prompt.shape[1] for r in reqs]
    streams = [r.generated.copy() for r in reqs]
    return (launches, cfg, eng.caches, base, bank, lengths, first, times,
            streams)


def serve_quant(cfg, base, bank, first, times4):
    """Phase 4b: the same requests over int8 pages, admitted by a router
    whose one slot holds the 4 largest of the requests' int8 charges, not
    all 8."""
    C = 4
    spec = serve_spec(cfg, quant=True)
    warm_up(spec, base, bank)
    reqs = make_requests(cfg, C)
    blk = spec.serve.page_block
    charges = sorted(kvcache.cache_bytes(cfg, r.prompt.shape[1]
                                         + r.max_new_tokens, 1, quant=True,
                                         page_block=blk) for r in reqs)
    router = PlacementRouter(cfg, [Slot(0, free_hbm=sum(charges[-4:]))])
    eng = ServingEngine(spec, base, [bank], device=DEV, router=router)
    log(f"[phase 4b] kv=paged(block={blk})+int8: "
        f"{kvcache.make_cache_spec(cfg, quant=True).bytes_per_token} B per "
        f"token against {kvcache.make_cache_spec(cfg).bytes_per_token} in "
        f"bf16; router slot {sum(charges[-4:])} B, requests charge "
        f"{charges[0]}..{charges[-1]} B ({sum(charges)} B in all)")
    admitted = {}
    try_admit = eng._try_admit

    def record_admission(req):
        slots = try_admit(req)
        if slots is not None:
            admitted[id(req)] = eng._tick
        return slots
    eng._try_admit = record_admission
    launches, times = drive(eng, reqs, "phase 4b", "paged_decode_attn_quant",
                            "paged_decode_attn")
    waits = [admitted[id(r)] - r.arrive_tick for r in reqs]
    if eng.stats["peak_inflight"] >= len(reqs) or not any(waits):
        raise AssertionError(f"[phase 4b] the router never queued: peak in "
                             f"flight {eng.stats['peak_inflight']}, waits "
                             f"{waits}")
    got = [int(r.generated[0, 0]) for r in reqs]
    if got != first:
        raise AssertionError(f"[phase 4b] first tokens {got} differ from "
                             f"phase 4's {first}: prefill logits must not "
                             "depend on the cache format")
    errs = router.conservation_errors()
    used = router.utilization()
    if errs or used["committed_bytes"] or used["placements"]:
        raise AssertionError(f"[phase 4b] router after the drain: {errs}, "
                             f"{used}")
    log(f"[phase 4b] ticks each request waited for the router: {waits}; "
        f"first tokens equal phase 4's; router ledger conserved and empty "
        f"after the drain")
    times.update(profile_tick(cfg, base, [bank], spec, "phase 4b"))
    log("[phase 4b] beside phase 4 (bf16 -> int8): " + ", ".join(
        f"{k} {times4[k]:.3f} -> {times[k]:.3f}" for k in times
        if k in times4))
    return launches, eng.caches, [r.prompt.shape[1] for r in reqs]


# Kernels per traced 8-row decode tick before the attention kernels were
# split across blocks and SGMV across dout tiles, as this script counted
# them on the H100 (phase 4b's count differs by one from run to run): every
# kernel stays one launch per call, so the count must not rise.
KERNELS_PER_TICK_BEFORE = {"phase 4": 3469, "phase 4b": 4589}
# traced device time per 8-row decode tick that the SGMV launches (80) and
# the attention launches (40) aim to stay under, ms
TICK_AIMS_MS = {"sgmv": 1.0, "split_kernel": 1.0}


def device_profile(prof):
    """(busy ms, kernels, {name: (count, us)}) of a trace's device events."""
    kern = sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    busy, end, by_name = 0.0, float("-inf"), {}
    for e in kern:
        s, t = e.time_range.start, e.time_range.end
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
        n, d = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, d + e.time_range.elapsed_us())
    return busy / 1e3, len(kern), by_name


def profile_tick(cfg, base, banks, spec, label, n_req=8, **engine_kw):
    """A decode tick of ``n_req`` one-row requests (8: every slot of phase
    4's bank) over ``banks``' clients in turn: its median over 5
    unprofiled ticks on the host clock, then one tick traced by
    torch.profiler with device activity only.
    The device's busy share is the union of the traced kernel intervals
    over the unprofiled median tick (and over the traced tick's own host
    time, which tracing lengthens). Also the kernel count and the kernels
    that take the most device time. ``engine_kw`` goes to the engine."""
    eng = ServingEngine(spec, base, banks, device=DEV, **engine_kw)
    rng = np.random.default_rng(5)
    for i in range(n_req):
        eng.submit(Request(i % eng.n_clients, rng.integers(
            0, cfg.vocab, (1, 192)).astype(np.int32), 16))
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
    with traced() as prof:
        t0 = time.perf_counter()
        eng.service_tick()
        torch.cuda.synchronize()
        traced_us = (time.perf_counter() - t0) * 1e6
    busy_ms, n_kern, by_name = device_profile(prof)
    busy = busy_ms * 1e3
    out = {"tick8_ms": tick_us / 1e3}
    what = f"decode tick ({n_req} of 8 slots active)"
    if not n_kern:
        log(f"[{label}] {what}: {tick_us / 1e3:.3f} ms median "
            "unprofiled; profiler saw no device events: device busy share "
            "not measured")
        return out
    before = KERNELS_PER_TICK_BEFORE.get(label)
    log(f"[{label}] {what}: {tick_us / 1e3:.3f} ms median "
        f"unprofiled, {traced_us / 1e3:.3f} ms traced; device busy "
        f"{busy / 1e3:.3f} ms = {100 * busy / tick_us:.1f}% of the "
        f"unprofiled tick ({100 * busy / traced_us:.1f}% of the traced "
        f"one); {n_kern} kernels" + (
            "" if before is None else f" (at most {before}: every kernel one "
            "launch per call)"))
    if before is not None and n_kern > before:
        raise AssertionError(f"[{label}] {n_kern} kernels per decode tick,"
                             f" more than {before}")
    for name, (n, d) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"[{label}]   {d / 1e3:8.3f} ms  {n:5d}x  {name[:90]}")
    for key, aim in TICK_AIMS_MS.items():   # the attention is split_kernel
        n = sum(c for name, (c, _) in by_name.items() if key in name)
        d = sum(t for name, (_, t) in by_name.items() if key in name) / 1e3
        log(f"[{label}] {key}: {n} launches, {d:.3f} ms of device time per "
            f"tick, aim <= {aim} ms: {'met' if d <= aim else 'missed'}")
        out[f"{key}_tick_ms"] = d
    n = sum(c for name, (c, _) in by_name.items() if "dense_combine" in name)
    if n:    # the dense layout's attention: split_kernel + dense_combine
        d = sum(t for name, (_, t) in by_name.items()
                if "dense_combine" in name) / 1e3
        log(f"[{label}] dense_combine: {n} launches, {d:.3f} ms; the dense "
            f"decode kernel (split + combine) "
            f"{out['split_kernel_tick_ms'] + d:.3f} ms of device time per "
            "tick")
        out["dense_attn_tick_ms"] = out["split_kernel_tick_ms"] + d
    out.update(busy_ms=busy / 1e3, busy_pct=100 * busy / tick_us,
               kernels_per_tick=float(n_kern))
    return out


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


def device_ms(fn, n=20):
    """Median device time of one L2-cold call of ``fn`` (one kernel launch)
    over ``n`` calls, with the host's enqueue hidden. The events of
    ``time_ms`` also count the device's wait for the host to enqueue the
    launch, which the 256 MB flush hides only while the wrapper's host time
    is shorter than the flush (and L2-warm, with no flush, never): a kernel
    of tens of us reads slower there than it runs. Here a spin kernel
    (``torch.cuda._sleep``) holds the stream while the host enqueues all
    ``n`` rounds of (flush, start event, call, end event), so each pair of
    events brackets work that was queued before the device reached it. If
    the spin was over before the last round was enqueued, the rounds run
    again behind a spin four times as long."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(64 << 20, dtype=torch.int32, device=DEV))
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 25                   # ~17 ms at the H100's 1.98 GHz
    for _ in range(4):
        spun = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        spun.record()
        rounds = []
        for _ in range(n):
            _L2_FLUSH[0].zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            rounds.append((start, end))
        ahead = not spun.query()
        torch.cuda.synchronize()
        if ahead:
            return statistics.median(s.elapsed_time(e) for s, e in rounds)
        cycles *= 4
    raise AssertionError(f"[phase 5] the host took longer to enqueue {n} "
                         f"calls than a spin of {cycles // 4} cycles")


@contextlib.contextmanager
def traced(idle_s=0.05):
    """torch.profiler (device activity only) over the block, the device
    idle for ``idle_s`` before and after it. The profiler keeps a device
    event only if it falls inside the trace's window on the host's clock,
    so a skew between the two clocks would drop the kernels at the
    window's edges."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(idle_s)
        yield prof
        torch.cuda.synchronize()
        time.sleep(idle_s)


def bound(nbytes, flops):
    """The least time for the work: bytes over the H100's HBM rate, or its
    operations over the dense bf16 tensor-core peak, whichever is larger
    (every attention and SGMV case here is bound by bytes by a wide margin;
    the bf16 ragged linear, on ``wgmma``, by operations)."""
    b_ms = nbytes / H100.hbm_bandwidth * 1e3
    f_ms = flops / H100.peak_flops_bf16 * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def attn_rows(cfg, caches, lengths):
    """8 decode rows (the bucket of phases 4 and 4b) over an engine's own
    layer-fused pools, pages drawn from the first layer's range: q in bf16,
    positions 15 past each request's prompt, sentinel past the last page.
    Returns (q, pools {leaf: [L*P, blk, K, hd|1]}, tbl, pos)."""
    L, Pl, blk, K, hd = caches["layers"]["k"].shape
    pools = {n: t.view((L * Pl,) + t.shape[2:])
             for n, t in caches["layers"].items()}
    B, G, nb = 8, cfg.q_per_kv, caches["block_tbl"].shape[-1]
    g = gen(7)
    q = torch.randn((B, K, G, hd), generator=g, device=DEV).to(torch.bfloat16)
    pos = torch.tensor([n + 15 for n in lengths[:B]], dtype=torch.int32,
                       device=DEV)
    tbl = torch.randperm(Pl, generator=g, device=DEV)[:B * nb].reshape(B, nb)
    cols = torch.arange(nb, device=DEV)[None, :]
    tbl = torch.where(cols > (pos // blk)[:, None], SENTINEL, tbl) \
        .to(torch.int32)
    return q, pools, tbl, pos


def sdpa_over_pages(q, k, v, tbl, pos, dequant=None):
    """The library yardstick: gather the table's pages into dense K/V
    (with ``dequant`` = (k_scale, v_scale) pools, dequantize them to q's
    dtype), then one ``scaled_dot_product_attention``."""
    B, K, G, hd = q.shape
    P, blk = k.shape[:2]
    nb = tbl.shape[1]
    pages = tbl.long().clamp(0, P - 1)
    k, v = k[pages], v[pages]
    if dequant is not None:
        k = (k.to(q.dtype) * dequant[0][pages]).to(q.dtype)
        v = (v.to(q.dtype) * dequant[1][pages]).to(q.dtype)
    k = k.reshape(B, nb * blk, K, hd).transpose(1, 2)
    v = v.reshape(B, nb * blk, K, hd).transpose(1, 2)
    t = torch.arange(nb * blk, device=DEV)
    mask = (t[None, :] <= pos[:, None])[:, None, None, :]
    qh = q.reshape(B, K * G, 1, hd)
    # the builtin has no inspectable signature; its docstring names the flag
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        out = F.scaled_dot_product_attention(qh, k, v, attn_mask=mask,
                                             enable_gqa=True)
    else:
        out = F.scaled_dot_product_attention(
            qh, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1),
            attn_mask=mask)
    return out.reshape(B, K, G, hd)


def time_attention(label, kernel, plain, library, q, tbl, pos, pool_bytes):
    """Kernel L2-cold and L2-warm, its device time with the host's enqueue
    hidden (``device_ms``), plain version and library yardstick, and
    the byte bound: ``pool_bytes`` (the live tokens' pool bytes), plus q
    and out in bf16, the table and the positions. Returns the JSON fields,
    the yardstick's time as ``library_ms``."""
    got = kernel()
    lib_err = float((got.float() - library().float()).abs().max())
    ms = time_ms(kernel)
    warm_ms = time_ms(kernel, l2_cold=False)
    dev_ms = device_ms(kernel)
    plain_ms = time_ms(plain, n=20)
    lib_ms = time_ms(library)
    B, K, G, hd = q.shape
    tokens = int((pos.long() + 1).sum())
    nbytes = (2 * q.numel() * 2 + pool_bytes(tokens) + tbl.numel() * 4
              + pos.numel() * 4)
    bound_ms, by = bound(nbytes, 4 * tokens * K * G * hd)
    log(f"[phase 5] {label} B={B} K={K} G={G} hd={hd}, {tokens} live "
        f"tokens, L2-cold: kernel {ms:.4f} ms (L2-warm {warm_ms:.4f}; device "
        f"time, enqueue hidden, {dev_ms:.4f}{aim_note(label, dev_ms)}), "
        f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms (differs by "
        f"{lib_err:.2e}), bound {bound_ms:.4f} ms ({by}, {nbytes} B)")
    return dict(ms=ms, ms_l2_warm=warm_ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=lib_ms)


def time_decode_attn(cfg, caches, lengths):
    """The bf16 kernel over phase 4's pool; the yardstick is page gather +
    SDPA."""
    q, pools, tbl, pos = attn_rows(cfg, caches, lengths)
    pk, pv = pools["k"], pools["v"]
    _, blk, K, hd = pk.shape
    log(f"[phase 5] paged_decode_attn over phase 4's pool: "
        f"{pk.shape[0]} pages of {blk} tokens; library = page gather + SDPA")
    return time_attention(
        "paged_decode_attn",
        lambda: da.paged_decode_attn_cuda(q, pk, pv, tbl, pos),
        lambda: da.paged_decode_attn_plain(q, pk, pv, tbl, pos),
        lambda: sdpa_over_pages(q, pk, pv, tbl, pos), q, tbl, pos,
        lambda tokens: 2 * tokens * K * hd * 2)


def time_decode_attn_quant(cfg, caches, lengths):
    """The int8 kernel over phase 4b's pool. No single PyTorch call computes
    attention over int8 pages with per-head scales; the yardstick is three:
    page gather, dequantize to bf16, SDPA."""
    q, pools, tbl, pos = attn_rows(cfg, caches, lengths)
    pk, pks, pv, pvs = (pools[n] for n in ("k", "k_s", "v", "v_s"))
    _, blk, K, hd = pk.shape
    log(f"[phase 5] paged_decode_attn_quant over phase 4b's int8 pool: "
        f"{pk.shape[0]} pages of {blk} tokens; no single PyTorch call "
        "computes this function (library_ms is null): the yardstick below is "
        "three calls, page gather, dequantize to bf16, SDPA")
    out = time_attention(
        "paged_decode_attn_quant",
        lambda: da.paged_decode_attn_quant_cuda(q, pk, pks, pv, pvs, tbl, pos),
        lambda: da.paged_decode_attn_quant_plain(q, pk, pks, pv, pvs, tbl,
                                                 pos),
        lambda: sdpa_over_pages(q, pk, pv, tbl, pos, dequant=(pks, pvs)),
        q, tbl, pos, lambda tokens: 2 * tokens * K * (hd + 4))
    # no one call: library_ms is null, the three calls' time has its own key
    out["gather_dequant_sdpa_ms"] = out.pop("library_ms")
    out["library_ms"] = None
    return out


# device time (enqueue hidden) each redesigned kernel aims to stay under
# at phase 5's shapes, ms
DEVICE_AIMS_MS = {"paged_decode_attn_quant": 0.020, "sgmv decode": 0.010,
                  "sgmv prefill": 0.020}


def aim_note(label, dev_ms):
    aim = DEVICE_AIMS_MS.get(label)
    if aim is None:
        return ""
    return f", aim <= {aim} ms: {'met' if dev_ms <= aim else 'missed'}"


def time_sgmv(bank):
    """LoRA deltas of one layer at the serving path's shapes: decode (8
    rows, block_t=1) for the q and v projections and compacted prefill (4
    rows of 256 tokens) for q. Returns the q decode fields, with the
    others' under ``decode_v`` and ``prefill``."""
    results = {}
    for label, path, rows, bt in (("decode", "q", 8, 1),
                                  ("decode_v", "v", 8, 1),
                                  ("prefill", "q", 4, 256)):
        A = bank["layers"][path]["A"].transpose(0, 1)[0]   # [C, din, r] view
        Bw = bank["layers"][path]["B"].transpose(0, 1)[0]
        n, din, r = A.shape
        dout = Bw.shape[-1]
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

        def kernel():
            return sg.sgmv_cuda(x, A, Bw, ids, block_t=bt, scale=scale)
        ms = time_ms(kernel)
        warm_ms = time_ms(kernel, l2_cold=False)
        dev_ms = device_ms(kernel)
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
            f"{warm_ms:.4f}; device time, enqueue hidden, {dev_ms:.4f}"
            f"{aim_note('sgmv ' + label, dev_ms)}), plain {plain_ms:.4f} ms, "
            f"gather+bmm {lib_ms:.4f} ms (differs by {lib_err:.2e}), bound "
            f"{bound_ms:.4f} ms ({by})")
        results[label] = dict(ms=ms, ms_l2_warm=warm_ms, device_ms=dev_ms,
                              plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=by, library_ms=lib_ms)
    out = results.pop("decode")
    out.update(results)
    return out


DENSE_SHAPE = (8, 4096, 8, 4, 128)     # phase 6's dense cache: B, T, K, G, hd
FLASH_SHAPE = (1, 4096, 32, 8, 128)    # phase 6's prefill: B, S=T, H, K, hd


def dense_inputs(seed):
    """bf16 q [B, K, G, hd] and a dense cache [B, T, K, hd], positions
    spread evenly over [0, T - 1]."""
    B, T, K, G, hd = DENSE_SHAPE
    g = gen(seed)
    q = torch.randn((B, K, G, hd), generator=g, device=DEV).to(torch.bfloat16)
    k = torch.randn((B, T, K, hd), generator=g, device=DEV).to(torch.bfloat16)
    v = torch.randn((B, T, K, hd), generator=g, device=DEV).to(torch.bfloat16)
    pos = torch.linspace(0, T - 1, B, device=DEV).round().to(torch.int32)
    return q, k, v, pos


def flash_inputs(seed, S=None, K=None):
    B, S0, H, K0, hd = FLASH_SHAPE
    S, K = S or S0, K or K0
    g = gen(seed)
    return tuple(torch.randn((B, S, n, hd), generator=g, device=DEV)
                 .to(torch.bfloat16) for n in (H, K, K))


def sdpa_gqa(q, k, v, **kw):
    """One ``scaled_dot_product_attention`` over [B, heads, len, hd] views,
    the KV heads shared by groups of query heads."""
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    G = q.shape[1] // k.shape[1]
    return F.scaled_dot_product_attention(
        q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1), **kw)


def timing_fields(label, kernel, plain, library, nbytes, flops, shape,
                  rows=None):
    """Kernel L2-cold and L2-warm, its device time with the host's enqueue
    hidden (``device_ms``), plain version, one library call (L2-cold, and
    its device time the same way), and the bound; the library call's
    difference from the kernel (over the first ``rows`` rows, where given)
    is reported."""
    lib_err = float((kernel()[:rows].float() - library()[:rows].float())
                    .abs().max())
    ms = time_ms(kernel)
    warm_ms = time_ms(kernel, l2_cold=False)
    dev_ms = device_ms(kernel, n=10)
    plain_ms = time_ms(plain, n=10, warmup=1)
    lib_ms = time_ms(library)
    lib_dev_ms = device_ms(library, n=10)
    bound_ms, by = bound(nbytes, flops)
    log(f"[phase 5] {label} {shape}, L2-cold: kernel {ms:.4f} ms (L2-warm "
        f"{warm_ms:.4f}; device time, enqueue hidden, {dev_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms (device {lib_dev_ms:.4f};"
        f" differs by {lib_err:.2e}), bound {bound_ms:.4f} ms ({by}, {nbytes}"
        f" B, {flops:.4g} flops)")
    return dict(ms=ms, ms_l2_warm=warm_ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=lib_ms, library_device_ms=lib_dev_ms)


def serving_dense_inputs(lengths, seed):
    """bf16 q [8, K, G, hd] and a dense cache [8, 512, K, hd] at granite's
    K=8, G=4, hd=128 (phase 9's layer slab: 4 clients x 2 slots, max_seq
    512), positions 15 past each of phase 4's 8 prompts, as ``attn_rows``
    places them."""
    B, T, K, G, hd = 8, 512, 8, 4, 128
    g = gen(seed)
    q = torch.randn((B, K, G, hd), generator=g, device=DEV).to(torch.bfloat16)
    k = torch.randn((B, T, K, hd), generator=g, device=DEV).to(torch.bfloat16)
    v = torch.randn((B, T, K, hd), generator=g, device=DEV).to(torch.bfloat16)
    pos = torch.tensor([n + 15 for n in lengths[:B]], dtype=torch.int32,
                       device=DEV)
    return q, k, v, pos


def time_dense_decode(q, k, v, pos, label, errs):
    """Dense decode over q [B, K, G, hd] and a cache [B, T, K, hd], first
    held against its plain version on the same inputs (bf16 tolerance; the
    error appended to ``errs``); library: SDPA with a position mask and
    GQA."""
    B, K, G, hd = q.shape
    T = k.shape[1]
    e = compare(f"[phase 5] {label} against plain",
                da.decode_attn_cuda(q, k, v, pos),
                plain_op(kernels.decode_attn, q, k, v, pos), BF16_TOL)
    errs.append(e)
    log(f"[phase 5] {label}: kernel against plain max_abs_err={e:.3e} "
        f"({BF16_TOL})")
    mask = (torch.arange(T, device=DEV)[None, :] <= pos[:, None].long())
    mask = mask[:, None, None, :]

    def library():
        out = sdpa_gqa(q.reshape(B, K * G, 1, hd), k.transpose(1, 2),
                       v.transpose(1, 2), attn_mask=mask)
        return out.reshape(B, K, G, hd)
    tokens = int((pos.long() + 1).sum())
    nbytes = 2 * q.numel() * 2 + 2 * tokens * K * hd * 2 + pos.numel() * 4
    return timing_fields(
        label, lambda: da.decode_attn_cuda(q, k, v, pos),
        lambda: plain_call(kernels.decode_attn, q, k, v, pos), library,
        nbytes, 4 * tokens * K * G * hd,
        f"q {list(q.shape)} cache {list(k.shape)}, {tokens} live tokens")


def visible_pairs(S, T, window):
    """(query, key) pairs a causal mask with this window lets through."""
    i = torch.arange(S, dtype=torch.float64)
    n = torch.clamp(i + 1, max=T)
    if window:
        n = torch.clamp(n, max=window)
    return int(n.sum())


def time_flash(S=None, K=None, window=0):
    """Causal flash attention on the tensor-core entry point; library: SDPA
    ``is_causal`` (with a window, an explicit mask). The kernel's and
    SDPA's max errors against the plain version in fp32 are logged side by
    side."""
    q, k, v = flash_inputs(11, S, K)
    B, S, H, hd = q.shape
    K = k.shape[2]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if window:
        t = torch.arange(S, device=DEV)
        mask = (t[:, None] >= t[None, :]) & (t[:, None] - t[None, :] < window)
        kw = dict(attn_mask=mask)
    else:
        kw = dict(is_causal=True)

    def library():
        return sdpa_gqa(qh, kh, vh, **kw).transpose(1, 2)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())   # q, k, v, out
    flops = 4 * B * H * hd * visible_pairs(S, S, window)
    before = dict(fa.flash_attn_cuda.by_entry)
    want = plain_op(kernels.flash_attn, q, k, v, window=window)
    err = (fa.flash_attn_cuda(q, k, v, window=window).float() - want).abs()
    lib_err = (library().float() - want).abs()
    del want
    out = timing_fields(
        "flash_attn", lambda: fa.flash_attn_cuda(q, k, v, window=window),
        lambda: plain_call(kernels.flash_attn, q, k, v, window=window),
        library, nbytes, flops,
        f"q [{B},{S},{H},{hd}] k/v [{B},{S},{K},{hd}] causal window {window}")
    took = {e: c - before[e] for e, c in fa.flash_attn_cuda.by_entry.items()}
    if took[fa.SIMT] or not took[fa.WGMMA]:
        raise AssertionError(f"[phase 5] flash_attn bf16 took the entry "
                             f"points {took}")
    log(f"[phase 5] flash_attn [{B},{S},{H},{hd}] window {window}: every "
        f"launch on the tensor cores ({took[fa.WGMMA]}); device time, enqueue "
        f"hidden, {out['device_ms']:.4f} ms; "
        f"{flops / out['ms'] / 1e9:.1f} TFLOP/s, {out['ms'] / out['library_ms']:.2f}x "
        f"SDPA; max (mean) abs err against the plain version in fp32: "
        f"kernel {float(err.max()):.3e} ({float(err.mean()):.3e}), SDPA "
        f"{float(lib_err.max()):.3e} ({float(lib_err.mean()):.3e})")
    return out


def time_ragged(w, n_live, budget):
    """One packed projection over phase 4's weight ``w`` (no bias, as
    granite's). Library: ``torch.addmm`` over the whole buffer, which
    computes every row and does not zero those past the live count."""
    g = gen(12)
    din, dout = w.shape
    x = torch.randn((budget, din), generator=g, device=DEV).to(w.dtype)
    b = torch.zeros((dout,), dtype=w.dtype, device=DEV)
    nbytes = 2 * (n_live * din + din * dout + budget * dout)
    before = dict(rl.ragged_linear_cuda.by_entry)
    out = timing_fields(
        "ragged_linear", lambda: rl.ragged_linear_cuda(x, w, None, n_live),
        lambda: plain_call(kernels.ragged_linear, x, w, None, n_live),
        lambda: torch.addmm(b, x, w), nbytes, 2 * n_live * din * dout,
        f"buf [{budget},{din}] @ w [{din},{dout}], n_live {n_live}",
        rows=n_live)
    took = {e: c - before[e] for e, c in rl.ragged_linear_cuda.by_entry.items()}
    if took[rl.SIMT] or not took[rl.WGMMA]:
        raise AssertionError(f"[phase 5] ragged_linear at a granite shape "
                             f"took the entry points {took}")
    log(f"[phase 5] ragged_linear {budget}x{din}x{dout}: every launch on the "
        f"tensor cores ({took[rl.WGMMA]}); {out['ms'] / out['library_ms']:.2f}x "
        f"addmm, {2 * n_live * din * dout / out['ms'] / 1e9:.1f} TFLOP/s")
    return out


# ---------------------------------------------------------------------------
# phase 6: the public kernel ops and the packed base executor
# ---------------------------------------------------------------------------

PROJECTIONS = (("q", "attn", "wq"), ("k", "attn", "wk"), ("v", "attn", "wv"),
               ("o", "attn", "wo"), ("gate", "mlp", "gate"),
               ("up", "mlp", "up"), ("down", "mlp", "down"))
SEGMENTS = ((37, 200, 64, 700), (37, 200, 64, 729))   # 1,001 and 1,030 tokens


def ragged_device_ms(fn):
    """Run ``fn`` once traced by torch.profiler (device activity only):
    (device ms in the ragged-linear kernels, their count, all device ms,
    traced wall s between synchronisations, the other kernels' (ms, count,
    name) by device time)."""
    with traced() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    mine = [e for e in kern if "ragged_linear" in e.name]
    others = {}
    for e in kern:
        if "ragged_linear" not in e.name:
            ms, n = others.get(e.name, (0.0, 0))
            others[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(((ms, n, name) for name, (ms, n) in others.items()),
                 reverse=True)
    return (sum(e.time_range.elapsed_us() for e in mine) / 1e3, len(mine),
            sum(e.time_range.elapsed_us() for e in kern) / 1e3, wall, top)


def base_executor_path(cfg, base):
    """Every (layer, projection) of ``base`` through one ``BaseExecutor``,
    for each segment set: a pass timed between synchronisations, every
    call one launch on the tensor-core entry point and every output held
    against ``frozen_dense``; then the same pass again, traced, for the
    device time in the ragged-linear kernels."""
    weights = {(i, path): (layer[grp][name], None)
               for i, layer in enumerate(base["layers"])
               for path, grp, name in PROJECTIONS}
    ex = BaseExecutor(weights, device=DEV)
    if any(ex.weights[key][0] is not w for key, (w, _) in weights.items()):
        raise AssertionError("[phase 6] the executor copied a weight")
    g = gen(13)
    by_entry = rl.ragged_linear_cuda.by_entry
    for lens in SEGMENTS:
        segs = {din: [torch.randn((n, din), generator=g, device=DEV)
                      .to(torch.bfloat16) for n in lens]
                for din in {w.shape[0] for w, _ in weights.values()}}
        worst, wall = 0.0, 0.0
        for key, (w, _) in weights.items():
            before = dict(by_entry)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = ex.run_layer(*key, segs[w.shape[0]])
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            took = {e: c - before[e] for e, c in by_entry.items()}
            if took != {rl.WGMMA: 1, rl.SIMT: 0}:
                raise AssertionError(f"[phase 6] {key}: ragged-linear "
                                     f"launches {took}, not one on the "
                                     "tensor cores")
            for s, o in zip(segs[w.shape[0]], outs):
                worst = max(worst, compare(f"[phase 6] {key}", o,
                                           frozen_dense(s, w), BF16_TOL))
        total = sum(lens)
        budget = _bucket(total)
        flops = 2 * total * sum(w.numel() for w, _ in weights.values())
        log(f"[phase 6] base executor, {cfg.name}: {len(weights)} packed "
            f"projections ({cfg.n_layers} layers x {len(PROJECTIONS)}), "
            f"segments {list(lens)} = {total} tokens in budget {budget} "
            f"({-(-total // 128)} of {budget // 128} row tiles live): "
            f"{wall:.3f} s synchronised, {total * len(weights) / wall:.0f} "
            f"token-projections/s, {flops / wall / 1e12:.2f} TFLOP/s; max "
            f"abs err against frozen_dense {worst:.3e} (bf16, {BF16_TOL}); "
            "every launch on the tensor cores")

        def again():
            for key, (w, _) in weights.items():
                ex.run_layer(*key, segs[w.shape[0]])
        dev_ms, n, all_ms, traced, top = ragged_device_ms(again)
        if n != len(weights):
            raise AssertionError(f"[phase 6] traced pass: {n} ragged-linear "
                                 f"kernels, not {len(weights)}")
        log(f"[phase 6]   traced again: {dev_ms:.3f} ms of device time in "
            f"{n} ragged-linear kernels ({flops / dev_ms / 1e9:.1f} TFLOP/s) "
            f"and {all_ms:.3f} ms in all kernels, against {wall * 1e3:.3f} "
            f"ms synchronised unprofiled ({traced * 1e3:.3f} ms traced): the "
            f"host holds {100 * (1 - all_ms / (wall * 1e3)):.1f}% of the "
            "unprofiled pass; the other kernels by device time:")
        for ms, count, name in top[:4]:
            log(f"[phase 6]     {ms:8.3f} ms  {count:5d}x  {name[:90]}")
    if ex.stats["calls"] != 2 * len(SEGMENTS) * len(weights):
        raise AssertionError(f"[phase 6] executor stats {ex.stats}")
    log(f"[phase 6] executor stats {ex.stats}")


def public_ops():
    """``kernels.decode_attn`` (dense: two launches, split and combine) and
    ``kernels.flash_attn`` (one) at phase 6's shapes, against their plain
    versions."""
    q, k, v, pos = dense_inputs(14)
    cache = list(k.shape)
    before = launch_count("decode_attn")
    got = kernels.decode_attn(q, k, v, pos)
    if launch_count("decode_attn") != before + 2:
        raise AssertionError("[phase 6] kernels.decode_attn did not launch "
                             "the dense split and combine kernels once each")
    e1 = compare("[phase 6] decode_attn", got,
                 plain_op(kernels.decode_attn, q, k, v, pos), BF16_TOL)
    q, k, v = flash_inputs(15)
    before = fa.flash_attn_cuda.by_entry[fa.WGMMA]
    got = kernels.flash_attn(q, k, v)
    if fa.flash_attn_cuda.by_entry[fa.WGMMA] != before + 1:
        raise AssertionError("[phase 6] kernels.flash_attn did not launch "
                             "the tensor-core flash kernel once")
    e2 = compare("[phase 6] flash_attn", got,
                 plain_op(kernels.flash_attn, q, k, v), BF16_TOL)
    log(f"[phase 6] kernels.decode_attn dense {cache} bf16, pos "
        f"{pos.tolist()}: max abs err {e1:.3e}; kernels.flash_attn "
        f"{list(q.shape)} causal: max abs err {e2:.3e} (against the plain "
        "versions)")


def time_unserved(base, lengths, dense_errs):
    """Phase 5 for the dense decode kernel at phase 9's serving shape (the
    kernel line's timing) and at phase 6's, and for the kernels of phase 6
    at its shapes, a granite projection of phase 4's own weights for the
    ragged linear; and two logged extras, gemma2-27b's windowed prefill and
    the ragged linear's dead-tile skip."""
    B, S, H, K, hd = FLASH_SHAPE
    up = base["layers"][0]["mlp"]["up"]
    out = {"decode_attn": time_dense_decode(
        *serving_dense_inputs(lengths, 16), "decode_attn (phase 9 slab)",
        dense_errs),
        "flash_attn": time_flash(),
        "ragged_linear": time_ragged(up, sum(SEGMENTS[0]), 1024)}
    time_dense_decode(*dense_inputs(10), "decode_attn (phase 6)", dense_errs)
    time_flash(S=2 * S, K=2 * K, window=S)   # gemma2-27b: K=16, window 4096
    skip = time_ragged(up, sum(SEGMENTS[1]), 2048)["ms"]
    full = time_ragged(up, 2048, 2048)["ms"]
    log(f"[phase 5] ragged_linear dead-tile skip at budget 2048: "
        f"{skip:.4f} ms with {sum(SEGMENTS[1])} live rows against "
        f"{full:.4f} ms with all 2048 live (L2-cold)")
    return out


PATH6 = ("decode_attn", "flash_attn", "ragged_linear")


def phase6(cfg, base):
    """The base executor and the public ops with every launch count set to
    0 just before and read just after; returns phase 6's counts of its
    kernels after checking them: one ragged linear per (pass, layer,
    projection), two passes (timed, traced) per segment set, all on the
    tensor cores; two dense decode launches (split, combine), one flash,
    nothing else."""
    reset_counts()
    base_executor_path(cfg, base)
    public_ops()
    torch.cuda.synchronize()
    counts = read_counts()
    want = {n: 0 for n in KERNELS}
    want.update(decode_attn=2, flash_attn=1, ragged_linear=2 * len(SEGMENTS)
                * cfg.n_layers * len(PROJECTIONS))
    entries = dict(rl.ragged_linear_cuda.by_entry)
    flash = dict(fa.flash_attn_cuda.by_entry)
    if counts != want or entries[rl.SIMT] or flash[fa.SIMT]:
        raise AssertionError(f"[phase 6] launches {counts} ({entries}, "
                             f"flash {flash}), expected {want}, none on a "
                             "SIMT entry")
    log(f"[phase 6] launches {counts} (as expected; ragged_linear by entry "
        f"point {entries}, flash_attn {flash})")
    return {n: counts[n] for n in PATH6}


# ---------------------------------------------------------------------------
# phase 7: fine-tuning on the card
# ---------------------------------------------------------------------------

F32_STEP_TOL = dict(atol=1e-4, rtol=1e-4)
# 7b: job 0 in the bank against its solo run, bf16 (reading on the H100:
# 3.9e-4 on losses of ~11 that move ~1e-2 a step)
LOSS_7B_TOL = dict(atol=2e-3, rtol=0.0)
# its adapter's update (final minus initial) against the solo run's, in
# relative norm: a missing or doubled update reads 1; Adam's first steps
# move each weight by ~lr * sign(grad), so a weight whose grad is within
# bf16 rounding of zero may step the other way in one of the two runs
UPDATE_7B_REL = 0.25
# kernel-name fragments of cuBLAS's matrix products on the H100
GEMM_NAMES = ("nvjet", "gemm", "xmma", "cutlass")
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 256, 3


def state_tol(want):
    """7a's tolerance for one adapter or AdamW leaf: rtol 1e-4 and an atol
    of 1e-3 of the leaf's largest magnitude, at most 1e-4, so a second
    moment of ~1e-6 is held to its own scale."""
    return dict(atol=min(1e-4, 1e-3 * float(want.abs().max())), rtol=1e-4)


def tree_clone(tree):
    return tree_map(lambda x: x.clone(), tree)


def random_lora(cfg, n, seed):
    """``n`` LoRA trees stacked on a leading axis, fp32, A and B drawn (a
    fresh adapter's B is zero, which would leave the B grads alone)."""
    g = gen(seed)
    bank = adapters.init_client_bank(cfg, LORA, n, g, device=DEV)
    for leaf in bank["layers"].values():
        leaf["B"].copy_(torch.randn(leaf["B"].shape, generator=g, device=DEV)
                        * 0.02)
    return bank


def train_batches(cfg, n_rows, seed):
    """One step's batch for ``n_rows`` jobs, [R, B, S], from the synthetic
    pipeline."""
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=TRAIN_S,
                            n_clients=n_rows, batch_per_client=TRAIN_B,
                            seed=seed, device=DEV)
    return ds.batch(0)


def step7a_hyper(R):
    return {"step": torch.tensor([0, 3, 1, 7][:R], dtype=torch.int32,
                                 device=DEV),
            "lr": torch.tensor([1e-3, 3e-4, 2e-3, 5e-4][:R], device=DEV),
            "warmup": torch.tensor([2.0, 0.0, 1.0, 3.0][:R], device=DEV),
            "total": torch.tensor([10.0, 8.0, 6.0, 20.0][:R], device=DEV),
            "wd": torch.tensor([0.0, 0.1, 0.0, 0.01][:R], device=DEV),
            "gnorm": torch.tensor([1.0, float("inf"), 0.5, 2.0][:R],
                                  device=DEV)}


def compact_rows_check(cfg, base, acfg, bank, batch_seed, label):
    """The compact step for 4 rows of ``bank`` (8 slots, fp32) against
    each row's ``make_baseline_train_step``; then a call with a padding row
    and a NaN-poisoned row, against the same call unpoisoned."""
    R, cap = 4, 8
    slots = torch.tensor([5, 2, 7, 0], dtype=torch.int32, device=DEV)
    opt = AdamWState(step=torch.arange(cap, dtype=torch.int32, device=DEV),
                     m=tree_map(lambda x: torch.randn_like(x) * 1e-3, bank),
                     v=tree_map(lambda x: torch.rand_like(x) * 1e-6, bank))
    batch = train_batches(cfg, R, batch_seed)
    hyper = step7a_hyper(R)
    step = symbiosis.make_compact_train_step(cfg, acfg, remat=False)
    start = (tree_clone(bank), tree_clone(opt))
    t0 = time.perf_counter()
    new_bank, new_opt, m = step(base, tree_clone(bank), tree_clone(opt),
                                batch, slots, torch.ones(R, dtype=torch.bool,
                                                         device=DEV), hyper)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    if not m["finite"].all():
        raise AssertionError(f"{label} non-finite rows {m['finite']}")
    worst = 0.0
    for i in range(R):
        s = int(slots[i])
        tcfg = TrainConfig(lr=float(hyper["lr"][i]),
                           warmup_steps=int(hyper["warmup"][i]),
                           total_steps=int(hyper["total"][i]),
                           weight_decay=float(hyper["wd"][i]),
                           max_grad_norm=(0.0 if torch.isinf(hyper["gnorm"][i])
                                          else float(hyper["gnorm"][i])),
                           remat=False)
        solo = symbiosis.make_baseline_train_step(cfg, acfg, tcfg)
        a, o, sm = solo(base, tree_map(lambda x: x[s].clone(), start[0]),
                        tree_map(lambda x: x[s].clone(), start[1]),
                        {k: v[i] for k, v in batch.items()},
                        int(hyper["step"][i]))
        worst = max(worst, compare(f"{label} row {i} loss", m["loss"][i],
                                   sm["loss"], F32_STEP_TOL))
        for name, x, y in (("adapter", new_bank, a), ("m", new_opt.m, o.m),
                           ("v", new_opt.v, o.v)):
            for xl, yl in zip(tree_leaves(x), tree_leaves(y)):
                worst = max(worst, compare(f"{label} row {i} {name}",
                                           xl[s], yl, state_tol(yl)))
    log(f"{label} {cfg.name} width, 2 layers, fp32, {acfg.method} "
        f"{acfg.targets}: compact step over {R} rows x {TRAIN_B} x "
        f"{TRAIN_S} tokens ({t_step * 1e3:.1f} ms, first call) against each "
        f"row's make_baseline_train_step: losses "
        f"{[round(float(x), 4) for x in m['loss']]}, max abs err {worst:.3e}"
        f" (losses {F32_STEP_TOL}; states rtol 1e-4, atol 1e-3 x max|leaf| "
        f"up to 1e-4)")

    mask = torch.tensor([True, True, True, False], device=DEV)
    clean = dict(batch, mask=torch.ones(batch["labels"].shape, device=DEV))
    poisoned = dict(clean, mask=clean["mask"].clone())
    poisoned["mask"][1] = float("nan")                  # the row at slot 2
    outs = []
    for b in (clean, poisoned):
        st = step(base, tree_clone(start[0]), tree_clone(start[1]), b, slots,
                  mask, hyper)
        outs.append(st)
    if not outs[0][2]["finite"].all() or bool(outs[1][2]["finite"][1]) \
            or not outs[1][2]["finite"][[0, 2]].all():
        raise AssertionError(f"{label} probes {outs[0][2]['finite']} / "
                             f"{outs[1][2]['finite']}")
    for full, ref, before in zip(tree_leaves(outs[1][:2]),
                                 tree_leaves(outs[0][:2]),
                                 tree_leaves(start)):
        for s in (2, 0, 1, 3, 4, 6):       # poisoned, padding, outside
            if not torch.equal(full[s], before[s]):
                raise AssertionError(f"{label} slot {s} changed")
        for s in (5, 7):                   # survivors
            if not torch.equal(full[s], ref[s]):
                raise AssertionError(f"{label} survivor slot {s} differs "
                                     "from the unpoisoned run")
    log(f"{label} {acfg.method}: a padding row and a NaN-poisoned row "
        "committed nothing (their slots and the slots outside the call bit "
        "for bit); the other rows equal the unpoisoned call bit for bit")


def f32_granite(n_layers=2):
    return dataclasses.replace(get_config("granite-3-8b"), n_layers=n_layers,
                               dtype="float32", param_dtype="float32")


def check_step_on_card():
    """7a: granite-3-8b's width, 2 layers, fp32 (TF32 off): the compact
    step's rows against their solo steps, a padding and a NaN row
    (``compact_rows_check``); then ``frozen_dense``'s dx and residuals."""
    cfg = f32_granite()
    base = get_model(cfg).init_params(gen(70), DEV)
    bank = tree_map(lambda x: x.repeat((2,) + (1,) * (x.ndim - 1)),
                    random_lora(cfg, 4, 71))
    compact_rows_check(cfg, base, LORA, bank, 72, "[phase 7a]")

    g = gen(73)
    x = torch.randn((TRAIN_B * TRAIN_S, cfg.d_model), generator=g,
                    device=DEV, requires_grad=True)
    w = base["layers"][0]["mlp"]["up"]
    gy = torch.randn((x.shape[0], w.shape[1]), generator=g, device=DEV)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = frozen_dense(x, w)
    (dx,) = torch.autograd.grad(y, [x], gy)
    x2 = x.detach().requires_grad_(True)
    (dx_ref,) = torch.autograd.grad(x2 @ w, [x2], gy)
    e = compare("[phase 7a] frozen_dense dx", dx, dx_ref, F32_TOL)
    if saved != [tuple(w.shape)]:
        raise AssertionError(f"[phase 7a] frozen_dense saved {saved}")
    log(f"[phase 7a] frozen_dense [{x.shape[0]}, {w.shape[0]}] @ "
        f"{list(w.shape)}: dx max abs err {e:.3e} against autograd through "
        f"x @ w ({F32_TOL}); saved for the backward: {saved} (the weight "
        "only)")
    del base, bank
    torch.cuda.empty_cache()


def train_jobs(cfg, n, steps=TRAIN_STEPS, first_seed=0):
    return [FinetuneJob(acfg=LORA, batch_size=TRAIN_B, seq_len=TRAIN_S,
                        steps=steps, lr=1e-3, warmup_steps=1,
                        seed=first_seed + i, name=f"job-{first_seed + i}",
                        data=make_job_stream(cfg, TRAIN_B, TRAIN_S,
                                             seed=first_seed + i, device=DEV))
            for i in range(n)]


def solo_run(cfg, base, job):
    """The job alone through ``make_baseline_train_step`` (its method, the
    torch-like baseline) from the adapter the engine initialises for its
    seed: its losses, the initial adapter and the final one."""
    tcfg = TrainConfig(lr=job.lr, weight_decay=job.weight_decay,
                       warmup_steps=job.warmup_steps,
                       total_steps=job.schedule_total,
                       max_grad_norm=job.max_grad_norm, remat=False)
    step = symbiosis.make_baseline_train_step(cfg, job.acfg, tcfg)
    gen_ = torch.Generator(device=DEV).manual_seed(job.seed)
    a = adapters.init_adapter(cfg, job.acfg, gen_, device=DEV)
    first = tree_clone(a)
    o = adamw_init(a)
    stream = make_job_stream(cfg, TRAIN_B, TRAIN_S, seed=job.seed, device=DEV)
    out = []
    for t in range(job.steps):
        a, o, m = step(base, a, o, stream.batch(t), t)
        out.append(float(m["loss"]))
    return out, first, a


def update_rel_diff(got, want, first):
    """|| (got - first) - (want - first) || / || want - first || over every
    leaf: how far one run's optimizer updates are from another's (a
    missing update reads 1)."""
    num = den = 0.0
    for g, w, f in zip(tree_leaves(got), tree_leaves(want),
                       tree_leaves(first)):
        num += float(((g.float() - w.float()) ** 2).sum())
        den += float(((w.float() - f.float()) ** 2).sum())
    return (num / den) ** 0.5


def timed_ticks(eng):
    """Drive ``eng`` to the end; host-clock seconds of each train tick
    (synchronised)."""
    ticks = []
    more = True
    while more:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        more = eng.train_tick()
        torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t0)
    return ticks


def serve_train(cfg, base):
    """7b: the service at full size behind a router whose slot holds 4
    jobs' charges, not 5; returns the 4 jobs' losses and tick times."""
    jobs = train_jobs(cfg, 5)
    charge = job_hbm_bytes(cfg, jobs[0])
    router = PlacementRouter(cfg, [Slot(0, free_hbm=4.5 * charge)])
    eng = FinetuneEngine(EngineSpec(cfg=cfg, finetune=FinetuneConfig()), base,
                         device=DEV, router=router)
    admitted = {}
    try_admit = eng._try_admit

    def record(job):
        ok = try_admit(job)
        if ok:
            admitted[job.name] = eng.stats["train_ticks"]
        return ok
    eng._try_admit = record
    for j in jobs:
        eng.submit(j)
    ticks = timed_ticks(eng)
    if len(eng.finished) != 5 or any(j.status != "finished" for j in jobs):
        raise AssertionError(f"[phase 7b] statuses {[j.status for j in jobs]}")
    losses = [j.losses for j in jobs]
    if not all(len(x) == TRAIN_STEPS and np.isfinite(x).all()
               for x in losses):
        raise AssertionError(f"[phase 7b] losses {losses}")
    if admitted["job-4"] < TRAIN_STEPS or eng.stats["peak_jobs"] != 4:
        raise AssertionError(f"[phase 7b] the router never held job 4 back: "
                             f"admitted at {admitted}, peak "
                             f"{eng.stats['peak_jobs']}")
    used = router.utilization()
    if router.conservation_errors() or used["committed_bytes"] \
            or used["placements"]:
        raise AssertionError(f"[phase 7b] router after the drain: "
                             f"{router.conservation_errors()}, {used}")
    solo, first, solo_adapter = solo_run(cfg, base, jobs[0])
    e = compare("[phase 7b] job 0 losses against its solo run",
                torch.tensor(losses[0]), torch.tensor(solo), LOSS_7B_TOL)
    upd = update_rel_diff(jobs[0].result.adapter, solo_adapter, first)
    if not upd <= UPDATE_7B_REL:
        raise AssertionError(f"[phase 7b] job 0's adapter update is {upd:.3e}"
                             f" (relative norm) from its solo run's, limit "
                             f"{UPDATE_7B_REL}")
    st = eng.stats
    tokens = TRAIN_B * TRAIN_S
    steady = ticks[1:TRAIN_STEPS]            # 4 rows, after the first tick
    log(f"[phase 7b] {cfg.name}: {cfg.n_layers} layers bf16, 5 LoRA jobs "
        f"(rank {LORA.rank}, q and v, {TRAIN_B} x {TRAIN_S} tokens, "
        f"{TRAIN_STEPS} steps each), router slot {4.5 * charge:.0f} B for "
        f"job charges of {charge} B: job 4 admitted at tick "
        f"{admitted['job-4']} (the others at 0); {st['train_ticks']} train "
        f"ticks, {st['train_steps']} steps, {st['train_tokens']} tokens, "
        f"stats {st}; router ledger conserved and empty after the drain")
    log(f"[phase 7b] losses {[[round(x, 4) for x in l] for l in losses]}; "
        f"job 0 against its solo make_baseline_train_step: {solo} (max abs "
        f"err {e:.3e}, {LOSS_7B_TOL}); its adapter's update against the "
        f"solo run's: {upd:.3e} relative norm (limit {UPDATE_7B_REL})")
    log(f"[phase 7b] tick ms (host clock, synchronised): "
        f"{[round(t * 1e3, 3) for t in ticks]}; 4-row ticks after the "
        f"first: {4 * tokens} tokens per tick, "
        f"{statistics.median(steady) * 1e3:.3f} ms median, "
        f"{4 * tokens / statistics.median(steady):.0f} tokens/s")
    return losses[:4], ticks


def profile_train_tick(cfg, base):
    """One 4-row train tick traced by torch.profiler (device activity only)
    after three unprofiled ones: device busy time, kernels per tick and the
    top kernels by device time."""
    eng = FinetuneEngine(EngineSpec(cfg=cfg, finetune=FinetuneConfig()), base,
                         device=DEV)
    for j in train_jobs(cfg, 4, steps=6, first_seed=10):
        eng.submit(j)
    eng.train_tick()
    ticks = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.train_tick()
        torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t0)
    tick_ms = statistics.median(ticks) * 1e3
    with traced() as prof:
        t0 = time.perf_counter()
        eng.train_tick()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, n_kern, by_name = device_profile(prof)
    if not n_kern:
        log(f"[phase 7b] train tick (4 rows): {tick_ms:.3f} ms median "
            "unprofiled; the profiler saw no device events: device busy "
            "not measured")
        return
    gemm = [(n, d) for name, (n, d) in by_name.items()
            if any(k in name for k in GEMM_NAMES)]
    gemm_ms = sum(d for _, d in gemm) / 1e3
    log(f"[phase 7b] train tick (4 rows x {TRAIN_B * TRAIN_S} tokens): "
        f"{tick_ms:.3f} ms median of 3 unprofiled, {traced_ms:.3f} ms traced;"
        f" device busy {busy_ms:.3f} ms = {100 * busy_ms / tick_ms:.1f}% of "
        f"the unprofiled tick; {n_kern} kernels per tick, "
        f"{sum(n for n, _ in gemm)} of them matrix products taking "
        f"{gemm_ms:.3f} ms ({100 * gemm_ms / busy_ms:.1f}% of the busy time); "
        "top kernels:")
    for name, (n, d) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"[phase 7b]   {d / 1e3:8.3f} ms  {n:5d}x  {name[:90]}")


def train_memory(cfg, base):
    """7c: peak device memory beyond what is resident (base, bank) for one
    bank step at 1 and 4 jobs, with the §3.6 path and the torch-like
    baseline, at FinetuneConfig's remat. Printed, not asserted."""
    remat = FinetuneConfig().remat
    out = {}
    for mo in (True, False):
        step = symbiosis.make_compact_train_step(cfg, LORA, remat=remat,
                                                 memory_optimized=mo)
        for R in (1, 4):
            bank = random_lora(cfg, R, 74)
            opt = AdamWState(step=torch.zeros(R, dtype=torch.int32,
                                              device=DEV),
                             m=tree_map(torch.zeros_like, bank),
                             v=tree_map(torch.zeros_like, bank))
            batch = train_batches(cfg, R, 75)
            hyper = step7a_hyper(R)
            args = (torch.arange(R, dtype=torch.int32, device=DEV),
                    torch.ones(R, dtype=torch.bool, device=DEV))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            step(base, bank, opt, batch, *args, hyper)
            torch.cuda.synchronize()
            out[(mo, R)] = (torch.cuda.max_memory_allocated() - before) / 2**30
            del bank, opt, batch
    torch.cuda.empty_cache()
    log(f"[phase 7c] peak device memory beyond the resident base and bank, "
        f"one bank step ({cfg.n_layers} layers bf16, {TRAIN_B} x {TRAIN_S} "
        f"tokens per job, remat={remat}), GiB: " + "; ".join(
            f"{'§3.6' if mo else 'baseline'} {R} job{'s' if R > 1 else ''} "
            f"{gib:.3f}" for (mo, R), gib in out.items()))
    for R in (1, 4):
        log(f"[phase 7c] {R} job(s): the baseline holds "
            f"{out[(False, R)] - out[(True, R)]:.3f} GiB more than §3.6")
    log(f"[phase 7c] from 1 to 4 jobs: §3.6 grows "
        f"{out[(True, 4)] / out[(True, 1)]:.2f}x, the baseline "
        f"{out[(False, 4)] / out[(False, 1)]:.2f}x")


def serve_and_train(cfg, base, bank, streams4, launches4, times4, losses7b,
                    ticks7b):
    """7d: one SymbiosisEngine over the same base object: phase 4's 8
    requests beside 7b's first 4 jobs, every launch count set to 0 just
    before and read just after."""
    spec = dataclasses.replace(serve_spec(cfg, quant=False),
                               finetune=FinetuneConfig())
    sym = SymbiosisEngine.from_spec(spec, base, serving_banks=[bank],
                                    device=DEV)
    if sym.serving.base is not base or sym.finetune.base is not base:
        raise AssertionError("[phase 7d] an engine holds another base")
    reqs = make_requests(cfg, 4)
    jobs = train_jobs(cfg, 4)
    for item in reqs + jobs:
        sym.submit(item)
    L = cfg.n_layers
    serving = sym.serving
    attn, sgmv = KERNELS["paged_decode_attn"][0], KERNELS["sgmv"][0]
    tick_t, serve_t, train_t = [], [], []
    serving.service_tick = _timed(serving.service_tick, serve_t)
    sym.finetune.train_tick = _timed(sym.finetune.train_tick, train_t)
    prefill_t = []
    serving._prefill_step = _timed(serving._prefill_step, prefill_t)
    torch.cuda.synchronize()
    reset_counts()
    more = True
    while more:
        before = (attn.launches, sgmv.launches, serving.stats["ticks"],
                  serving.stats["compact_prefill_batches"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        more = sym.tick()
        torch.cuda.synchronize()
        tick_t.append(time.perf_counter() - t0)
        d_at, d_sg, d_tick, d_pre = (a - b for a, b in zip(
            (attn.launches, sgmv.launches, serving.stats["ticks"],
             serving.stats["compact_prefill_batches"]), before))
        if d_at != L * d_tick or d_sg != 2 * L * (d_tick + d_pre):
            raise AssertionError(f"[phase 7d] a tick launched {d_at} "
                                 f"attention and {d_sg} SGMV kernels for "
                                 f"{d_tick} decode ticks, {d_pre} prefills")
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != launches4:
        raise AssertionError(f"[phase 7d] launches {counts}, phase 4's "
                             f"serving path launched {launches4}")
    done_r, done_j = serving.drain_done(), sym.finetune.finished
    if len(done_r) != 8 or len(done_j) != 4:
        raise AssertionError(f"[phase 7d] {len(done_r)} requests and "
                             f"{len(done_j)} jobs finished")
    for i, r in enumerate(reqs):
        if not np.array_equal(r.generated, streams4[i]):
            raise AssertionError(f"[phase 7d] request {i}'s greedy stream "
                                 "differs from phase 4's")
    worst = 0.0
    for j, want_l in zip(jobs, losses7b):
        got, ref = np.array(j.losses), np.array(want_l)
        rel = np.abs(got - ref) / np.abs(ref)
        if got.shape != ref.shape or not (rel <= 1e-3).all():
            raise AssertionError(f"[phase 7d] {j.name} losses {got} against "
                                 f"7b's {ref}")
        worst = max(worst, float(rel.max()))
    st = sym.stats
    log(f"[phase 7d] SymbiosisEngine over phase 4's base object: 8 requests "
        f"beside 4 jobs in {st['ticks']} ticks ({st['decode_ticks']} serving,"
        f" {st['train_ticks']} train); every greedy stream equals phase 4's "
        f"exactly; job losses equal 7b's (max relative difference "
        f"{worst:.2e}, limit 1e-3); launches {counts}, the serving path's of "
        f"phase 4 (checked tick by tick)")
    ms = lambda ts: [round(t * 1e3, 3) for t in ts]
    n_pre = serving.stats["compact_prefill_batches"]
    log(f"[phase 7d] tick ms (host clock, synchronised; each a serving tick, "
        f"the first {TRAIN_STEPS} then a train tick, the first {n_pre} with "
        f"an admission's prefill): {ms(tick_t)}; of which serving "
        f"{ms(serve_t)}, training {ms(train_t)}, prefill steps "
        f"{ms(prefill_t)}")
    log(f"[phase 7d] medians beside the engines alone: train tick after the "
        f"first {statistics.median(train_t[1:]) * 1e3:.3f} ms (7b "
        f"{statistics.median(ticks7b[1:TRAIN_STEPS]) * 1e3:.3f}); serving "
        f"tick without admission "
        f"{statistics.median(serve_t[n_pre:]) * 1e3:.3f} ms (phase 4 "
        f"{times4['tick_ms']:.3f}); prefill step "
        f"{statistics.median(prefill_t) * 1e3:.3f} ms")


def phase7(cfg, base, bank, streams4, launches4, times4):
    """Fine-tuning on the card: 7a the step at full width, 7b the service
    at full size, 7c memory, 7d serving and training on one base."""
    check_step_on_card()
    losses7b, ticks7b = serve_train(cfg, base)
    profile_train_tick(cfg, base)
    train_memory(cfg, base)
    serve_and_train(cfg, base, bank, streams4, launches4, times4, losses7b,
                    ticks7b)


# ---------------------------------------------------------------------------
# phase 8: mixed-method banks and shared-prefix pages
# ---------------------------------------------------------------------------

# the serving schedule: each client of the first banks sends, P8_EVERY
# ticks apart, its own 232-token template followed by 40 tokens, 1, 24 and
# another 1 (the two single tokens differ); the bank admitted at tick
# P8_ADMIT sends template + 40 and template + 1 from tick P8_LATE_FIRST.
# Every request takes 16 new tokens, greedy; 4 slots per client.
P8_TEMPLATE, P8_EVERY, P8_NEW, P8_MAX_B, P8_BLK = 232, 3, 16, 4, 16
P8_TAILS, P8_LATE_TAILS = (40, 1, 24, 1), (40, 1)
P8_ADMIT, P8_LATE_FIRST = 4, 5
# the schedule's prefix counts, from the same schedule run through the JAX
# engine at tiny width on the CPU (tests/test_torch_prefix_cache.py::
# test_phase8_schedule_matches_reference); they depend only on prompt
# lengths, token equality, page_block, slots and arrivals
P8_PINNED = {"prefix_hits": 20, "pages_shared": 280, "cow_copies": 6,
             "prefill_tokens": 6974, "prefill_tokens_computed": 2446}


def phase8_work(vocab, clients, tails, first_tick, seed):
    """Phase 8's requests (dicts of ``Request`` fields) for ``clients``:
    per client a template of P8_TEMPLATE tokens and one request per entry
    of ``tails``, that many tokens after the template, P8_EVERY ticks
    apart from ``first_tick``. Single-token tails take the client's two
    distinct tokens in turn, so the first and the second differ."""
    rng = np.random.default_rng(seed)
    work = []
    for c in clients:
        tpl = rng.integers(0, vocab, P8_TEMPLATE)
        one = int(rng.integers(0, vocab))
        ones = iter((one, (one + 1) % vocab))
        for i, n in enumerate(tails):
            tail = ([next(ones)] if n == 1
                    else list(rng.integers(0, vocab, n)))
            work.append(dict(client_id=c, max_new_tokens=P8_NEW,
                             arrive_tick=first_tick + P8_EVERY * i,
                             prompt=np.concatenate([tpl, tail])
                             .astype(np.int32)[None, :]))
    return work


P8_ACFGS = (AdapterConfig(method="lora", rank=8, alpha=16.0,
                           targets=("q", "v")),
            AdapterConfig(method="ia3", targets=("k", "v", "down")),
            AdapterConfig(method="prefix", targets=("q", "v"), n_prefix=16))
P8_LATE_ACFG = AdapterConfig(method="lora", rank=16, alpha=32.0,
                             targets=("q", "k", "v", "o"))


def p8_bank(cfg, acfg, n, seed, dtype=torch.bfloat16):
    """A bank of ``n`` clients, every adapter non-trivial: LoRA B drawn
    (zero at init), IA3 scales 1 + 0.2 * normal, prefix K/V normal."""
    g = gen(seed)
    bank = adapters.init_client_bank(cfg, acfg, n, g, dtype=dtype,
                                     device=DEV)
    for path, leaf in bank["layers"].items():
        if acfg.method == "lora":
            leaf["B"].copy_(torch.randn(leaf["B"].shape, generator=g,
                                        device=DEV) * 0.05)
        elif acfg.method == "ia3":
            leaf["scale"].copy_(1 + 0.2 * torch.randn(
                leaf["scale"].shape, generator=g, device=DEV))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=g, device=DEV))
    return bank


def sgmv_per_layer(cfg, bank_cfgs):
    """SGMV launches per layer of a compacted step, from the registry: one
    per LoRA bank and targeted projection, and, for every prefix bank, one
    per LoRA bank targeting q or o (the prefix branch's own q and o go
    through the linear hooks)."""
    lora = [a for a in bank_cfgs if a.method == "lora"]
    n_prefix = sum(a.method == "prefix" for a in bank_cfgs)
    return (sum(len(adapters.resolve_targets(cfg, a)) for a in lora)
            + n_prefix * sum(("q" in a.targets) + ("o" in a.targets)
                             for a in lora))


def p8_spec(cfg, acfgs):
    scfg = ServeConfig(n_clients=2 * len(acfgs), max_seq=512,
                       page_block=P8_BLK, policy="opportunistic")
    return EngineSpec(cfg=cfg, banks=tuple(
        BankSpec(f"{a.method}{m}", a, 2) for m, a in enumerate(acfgs)),
        serve=scfg, max_batch_per_client=P8_MAX_B)


def p8_serve(cfg, base, banks, late_bank, *, prefix_cache=None, label,
             watch=False):
    """Phase 8's workload on one engine behind a router (debug=True: the
    conservation audit after every tick), the late bank admitted at tick
    P8_ADMIT and retired after the drain. Checks the SGMV and attention
    launches of every tick against the registry. With ``watch``, also
    holds every published page against its copy at its last deref and
    every copy-on-write destination against its source. Returns the
    requests, the engine, per-request top-2 logit gaps per step, the
    prefill calls' (ext, rows, suffix tokens, ms) and the decode steps'
    ms."""
    L = cfg.n_layers
    work = phase8_work(cfg.vocab, range(6), P8_TAILS, 0, seed=0)
    late = phase8_work(cfg.vocab, (6, 7), P8_LATE_TAILS, P8_LATE_FIRST,
                       seed=1)
    charges = [adapters.adapter_bytes(cfg, a)[1] * 2
               for a in P8_ACFGS + (P8_LATE_ACFG,)]
    pages = [kvcache.cache_bytes(cfg, w["prompt"].shape[1] + P8_NEW, 1,
                                 page_block=P8_BLK) for w in work + late]
    router = PlacementRouter(cfg, [Slot(0, free_hbm=sum(charges)
                                        + sum(pages))])
    eng = ServingEngine(p8_spec(cfg, P8_ACFGS), base, banks, device=DEV,
                        router=router, debug=True, prefix_cache=prefix_cache)
    reqs = [Request(**w) for w in work]
    for r in reqs:
        eng.submit(r)
    gaps = {}
    sample = eng._sample

    def record_gap(logits, req):
        top = np.sort(logits, axis=-1)[:, -2:]
        gaps.setdefault(id(req), []).append(float((top[:, 1]
                                                   - top[:, 0]).min()))
        return sample(logits, req)
    eng._sample = record_gap
    pre, dec_t = [], []
    prefill = eng._prefill_step

    def timed_prefill(ext, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(ext, *args)
        torch.cuda.synchronize()
        mask = args[-1]
        pre.append((ext, int(mask.sum()), int(args[4][mask].sum()),
                    (time.perf_counter() - t0) * 1e3))
        if watch:
            check_cow()
        return out
    eng._prefill_step = timed_prefill
    published, cow, checked = {}, [], [0, 0]
    if watch:
        index = eng._prefix_index
        publish, deref, lookup = index.publish, index.deref, index.lookup
        tails = {}

        def page_of(p):
            return [t[:, p].clone() for t in eng.caches["layers"].values()]

        def watch_publish(*a):
            took = publish(*a)
            for p in took:
                published[p] = page_of(p)
            return took

        def watch_deref(p):
            last = deref(p)
            if last:
                now = page_of(p)
                if not all(torch.equal(x, y) for x, y in
                           zip(published.pop(p), now)):
                    raise AssertionError(f"[{label}] shared page {p} changed "
                                         "between its publish and its last "
                                         "deref")
                checked[0] += 1
            return last

        def watch_lookup(*a):
            hit = lookup(*a)
            if hit.tail_page is not None:
                tails[hit.tail_page] = hit.tail_tokens
            return hit
        index.publish, index.deref = watch_publish, watch_deref
        index.lookup = watch_lookup
        page_copy = eng._page_copy

        def watch_copy(caches, src, dst):
            cow.append((src, dst, tails[src]))
            return page_copy(caches, src, dst)
        eng._page_copy = watch_copy

    def check_cow():
        while cow:
            src, dst, n = cow.pop()
            for t in eng.caches["layers"].values():
                if not torch.equal(t[:, dst, :n], t[:, src, :n]):
                    raise AssertionError(f"[{label}] copy-on-write page {dst}"
                                         f" differs from its source {src} on "
                                         f"the {n} copied tokens")
            checked[1] += 1

    attn, idle, sg = (KERNELS[n][0] for n in (
        "paged_decode_attn", "paged_decode_attn_quant", "sgmv"))
    adm, late_reqs = None, []
    per_tick = {}
    torch.cuda.synchronize()
    reset_counts()
    more = True
    while more:
        if eng._tick == P8_ADMIT and adm is None:
            adm = eng.admit_bank(P8_LATE_ACFG, late_bank)
            late_reqs = [Request(**w) for w in late]
            for r in late_reqs:
                eng.submit(r)
        decode = eng._decode_step
        eng._decode_step = _timed(decode, dec_t)
        per_layer = sgmv_per_layer(cfg, eng.bank_cfgs)
        before = (attn.launches, idle.launches, sg.launches,
                  eng.stats["ticks"], eng.stats["compact_prefill_batches"])
        more = eng.service_tick()
        eng._decode_step = decode
        d_at, d_idle, d_sg, d_tick, d_pre = (
            a - b for a, b in zip((attn.launches, idle.launches, sg.launches,
                                   eng.stats["ticks"],
                                   eng.stats["compact_prefill_batches"]),
                                  before))
        if d_at != L * d_tick or d_idle or \
                d_sg != per_layer * L * (d_tick + d_pre):
            raise AssertionError(
                f"[{label}] tick {eng._tick}: {d_at} paged attention, "
                f"{d_idle} int8 and {d_sg} SGMV launches for {d_tick} decode "
                f"ticks and {d_pre} prefills ({per_layer} SGMV per layer)")
        if d_tick:
            per_tick[len(eng.bank_cfgs)] = (d_sg // (d_tick + d_pre), d_at)
    torch.cuda.synchronize()
    reqs += late_reqs
    done = eng.drain_done()
    if len(done) != len(reqs) or any(r.status != "ok" for r in reqs):
        raise AssertionError(f"[{label}] {len(done)} of {len(reqs)} finished,"
                             f" statuses {[r.status for r in reqs]}")
    for r in reqs:
        g = r.generated
        if g.shape != (1, P8_NEW) or g.min() < 0 or g.max() >= cfg.vocab:
            raise AssertionError(f"[{label}] client {r.client_id}: {g}")
    P = eng._pool_pages
    if eng._prefix_index.page_refs() or eng._slot_shared or any(
            sorted(f) != list(range(c * P, (c + 1) * P))
            for c, f in enumerate(eng._free_pages)):
        raise AssertionError(f"[{label}] after the drain: refs "
                             f"{eng._prefix_index.page_refs()}, pages not "
                             "all back in their owners' free lists")
    banks_held = router.utilization()
    eng.retire_bank(adm)
    eng.release_banks()
    used = router.utilization()
    if router.conservation_errors() or used["placements"] \
            or used["committed_bytes"] or banks_held["placements"] != 4:
        raise AssertionError(f"[{label}] router after the drain: "
                             f"{router.conservation_errors()}, {banks_held}"
                             f" with the banks, {used} after their release")
    if watch and (published or checked[1] != eng.stats["cow_copies"]):
        raise AssertionError(f"[{label}] {len(published)} published pages "
                             f"never released, {checked[1]} copy-on-write "
                             "pages checked")
    return dict(reqs=reqs, eng=eng, gaps=[gaps[id(r)] for r in reqs],
                pre=pre, dec_t=dec_t, per_tick=per_tick, checked=checked)


def p8_mixed_rows(cfg2, base2, banks2):
    """One 8-row mixed decode step at granite's width (2 layers, bf16),
    then each bank's single-method step over the same rows with the other
    banks' rows masked out and pointed at this bank's client 0, every step
    from a copy of the same caches: each bank's rows equal bit for bit."""
    C, max_b, max_seq = 6, 2, 512
    scfg = ServeConfig(n_clients=C, max_seq=max_seq, page_block=P8_BLK)
    nb, P = max_seq // P8_BLK, max_b * (max_seq // P8_BLK)
    rng = np.random.default_rng(8)
    rows = [(c, 0) for c in range(C)] + [(0, 1), (4, 1)]
    lengths = rng.integers(40, 250, len(rows)).astype(np.int32)
    toks = np.zeros((8, 256), np.int32)
    tbl = np.full((C, max_b, nb), SENTINEL, np.int32)
    nxt = [c * P for c in range(C)]
    for r, ((c, s), n) in enumerate(zip(rows, lengths)):
        toks[r, :n] = rng.integers(0, cfg2.vocab, n)
        need = n // P8_BLK + 1
        tbl[c, s, :need] = np.arange(nxt[c], nxt[c] + need)
        nxt[c] += need
    clients = np.array([c for c, _ in rows], np.int32)
    t = {k: torch.tensor(v, device=DEV) for k, v in dict(
        toks=toks, lens=lengths, clients=clients,
        slots=np.array([s for _, s in rows], np.int32),
        methods=clients // 2, locals_=clients % 2,
        mask=np.ones(8, bool)).items()}
    caches = symbiosis.init_client_caches(cfg2, C, max_b, max_seq,
                                          page_block=P8_BLK, pool_pages=P,
                                          device=DEV)
    caches["block_tbl"] = torch.tensor(tbl, device=DEV)
    lg, _, caches = symbiosis.make_compact_prefill(cfg2, P8_ACFGS, scfg)(
        base2, banks2, caches, t["toks"], t["lens"],
        torch.zeros_like(t["lens"]), t["clients"], t["slots"], t["methods"],
        t["locals_"], t["mask"])
    nxt_tok = lg.argmax(-1).to(torch.int32)

    def fresh():
        return {"layers": {k: v.clone() for k, v in caches["layers"].items()},
                "pos": caches["pos"].clone(), "block_tbl": caches["block_tbl"]}

    reset_counts()
    mixed, _, _ = symbiosis.make_compact_decode_step(cfg2, P8_ACFGS, scfg)(
        base2, banks2, fresh(), nxt_tok, t["clients"], t["slots"],
        t["methods"], t["locals_"], t["mask"])
    mixed_launches = read_counts()
    for m, acfg in enumerate(P8_ACFGS):
        own = t["methods"] == m
        # bank m over every GLOBAL client (the ids the caches are keyed
        # by): its clients hold their adapters, the others its client 0
        ids = torch.tensor([c % 2 if c // 2 == m else 0 for c in range(C)],
                           device=DEV)
        single_bank = tree_map(lambda x: x[ids], banks2[m])
        single, _, _ = symbiosis.make_compact_decode_step(cfg2, acfg, scfg)(
            base2, single_bank, fresh(), nxt_tok, t["clients"], t["slots"],
            own)
        if not torch.equal(single[own], mixed[own]):
            d = (single[own].float() - mixed[own].float()).abs().max()
            raise AssertionError(f"[phase 8] {acfg.method} rows of the mixed "
                                 f"step differ from its single-method step "
                                 f"(max abs {float(d):.3e})")
    log(f"[phase 8] mixed rows: one 8-row decode step over LoRA r8 (q, v), "
        f"IA3 and prefix banks at {cfg2.name} width, 2 layers, bf16: every "
        f"bank's rows equal its single-method step's bit for bit (launches "
        f"of the mixed step {mixed_launches})")


def p8_suffix_prefill(dtype, tol):
    """At granite's width, 2 layers, over LoRA, IA3 and prefix banks: client
    0 of each bank publishes template + 40 tokens from slot 0; slot 1's
    template + 24 then prefills only its 32-token suffix over the 14 shared
    pages (``starts`` 224, ``ext_blocks`` 16), against the full prefill of
    the same prompts into fresh caches. Logits and the K/V written at the
    suffix positions agree at ``tol``; both paths run the kernels. Returns
    the 2-layer config, base and banks."""
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    cfg2 = dataclasses.replace(get_config("granite-3-8b"), n_layers=2,
                               dtype=name, param_dtype=name)
    base2 = get_model(cfg2).init_params(gen(41), DEV)
    banks2 = [p8_bank(cfg2, a, 2, 42 + m, dtype) for m, a in
              enumerate(P8_ACFGS)]
    C, max_b, max_seq = 6, 2, 512
    scfg = ServeConfig(n_clients=C, max_seq=max_seq, page_block=P8_BLK)
    nb, P = max_seq // P8_BLK, max_b * (max_seq // P8_BLK)
    work = phase8_work(cfg2.vocab, (0, 2, 4), (40, 24), 0, seed=5)
    pub, con = work[0::2], work[1::2]
    n_shared = P8_TEMPLATE // P8_BLK                 # 14 full pages
    start = n_shared * P8_BLK
    clients = torch.tensor([0, 2, 4, 0], dtype=torch.int32, device=DEV)
    methods, locals_ = clients // 2, clients % 2
    mask = torch.tensor([True, True, True, False], device=DEV)

    def step(caches, prompts, slot, starts, ext):
        S = max(p.shape[1] for p in prompts) - int(starts.max())
        toks = np.zeros((4, S), np.int32)
        lens = np.zeros(4, np.int32)
        for r, (p, s0) in enumerate(zip(prompts, starts.tolist())):
            toks[r, :p.shape[1] - s0] = p[0, s0:]
            lens[r] = p.shape[1] - s0
        slots = torch.full((4,), slot, dtype=torch.int32, device=DEV)
        fn = symbiosis.make_compact_prefill(cfg2, P8_ACFGS, scfg,
                                            ext_blocks=ext)
        return fn(base2, banks2, caches, torch.tensor(toks, device=DEV),
                  torch.tensor(lens, device=DEV), starts.to(DEV), clients,
                  slots, methods, locals_, mask)

    def fresh(tbl):
        c = symbiosis.init_client_caches(cfg2, C, max_b, max_seq,
                                         page_block=P8_BLK, pool_pages=P,
                                         device=DEV)
        c["block_tbl"] = torch.tensor(tbl, device=DEV)
        return c

    tbl = np.full((C, max_b, nb), SENTINEL, np.int32)
    for c in (0, 2, 4):
        tbl[c, 0, :18] = c * P + np.arange(18)               # publisher
        tbl[c, 1, :n_shared] = tbl[c, 0, :n_shared]          # shared pages
        tbl[c, 1, n_shared:16] = c * P + 18 + np.arange(16 - n_shared)
    zeros = torch.zeros(4, dtype=torch.int32)
    shared = fresh(tbl)
    step(shared, [w["prompt"] for w in pub], 0, zeros, 0)
    reset_counts()
    lg_s, _, shared = step(shared, [w["prompt"] for w in con], 1,
                           torch.tensor([start] * 3 + [0], dtype=torch.int32),
                           16)
    if not launch_count("sgmv"):
        raise AssertionError("[phase 8] the suffix prefill launched no SGMV")
    full = fresh(tbl)
    lg_f, _, full = step(full, [w["prompt"] for w in con], 1, zeros, 0)
    torch.cuda.synchronize()
    e = compare(f"[phase 8] suffix prefill logits ({name})", lg_s[:3],
                lg_f[:3], tol)
    own = torch.tensor(tbl[[0, 2, 4], 1, n_shared:16].ravel(), device=DEV)
    ekv = max(compare(f"[phase 8] suffix K/V ({name}, {n})", t[:, own],
                      full["layers"][n][:, own], tol)
              for n, t in shared["layers"].items())
    log(f"[phase 8] suffix prefill over {n_shared} shared pages (start "
        f"{start}, ext_blocks 16, 32 suffix tokens per row) against the "
        f"full prefill, {cfg2.name} width, 2 layers, {name}, LoRA + IA3 + "
        f"prefix rows: logits max_abs_err={e:.3e}, suffix K/V "
        f"max_abs_err={ekv:.3e} ({tol})")
    return cfg2, base2, banks2


def first_diff(a, b):
    """The first step at which two [1, n] streams differ, or None."""
    d = np.nonzero(a[0] != b[0])[0]
    return int(d[0]) if len(d) else None


def phase8(cfg, base, times4):
    """Mixed-method banks and shared-prefix pages at full size on phase 4's
    base tensors, then the step-level checks at granite's width."""
    L = cfg.n_layers
    banks = [p8_bank(cfg, a, 2, 80 + m) for m, a in enumerate(P8_ACFGS)]
    late_bank = p8_bank(cfg, P8_LATE_ACFG, 2, 84)
    t0 = time.perf_counter()
    run = p8_serve(cfg, base, banks, late_bank, label="phase 8", watch=True)
    wall = time.perf_counter() - t0
    eng, reqs = run["eng"], run["reqs"]
    st = eng.stats
    got = {k: st[k] for k in P8_PINNED}
    if got != P8_PINNED or not all(st[k] for k in P8_PINNED):
        raise AssertionError(f"[phase 8] prefix counts {got}, pinned "
                             f"{P8_PINNED}")
    log(f"[phase 8] {cfg.name}: {L} layers bf16, banks LoRA r8 (q, v), IA3 "
        f"(k, v, down), prefix ({P8_ACFGS[2].n_prefix} tokens), 2 clients "
        f"each, then LoRA r16 (q, k, v, o) admitted at tick {P8_ADMIT} and "
        f"retired after the drain; {len(reqs)} requests served in "
        f"{wall:.3f} s, {st['ticks']} decode ticks, "
        f"{st['compact_prefill_batches']} prefill batches, peak in flight "
        f"{st['peak_inflight']}; conservation audited every tick; refcounts "
        "0, every page back with its owner and the router ledger empty "
        "after the drain and the banks' release")
    log(f"[phase 8] prefix hits {st['prefix_hits']}, pages shared "
        f"{st['pages_shared']}, copies on write {st['cow_copies']}, prompt "
        f"tokens {st['prefill_tokens']} of which computed "
        f"{st['prefill_tokens_computed']} (as pinned from the JAX engine's "
        f"run of the same schedule); {run['checked'][0]} published pages "
        f"unchanged at their last deref, {run['checked'][1]} copied pages "
        "equal their sources on the copied tokens")
    for n, (sg_tick, at_tick) in sorted(run["per_tick"].items()):
        log(f"[phase 8] with {n} banks: sgmv {sg_tick} per decode tick or "
            f"prefill batch ({sgmv_per_layer(cfg, (P8_ACFGS + (P8_LATE_ACFG,))[:n])}"
            f" per layer, from the registry; phase 4: {2 * L}), paged "
            f"attention {at_tick} per decode tick (phase 4: {L}), int8 "
            "attention 0 (checked tick by tick)")
    pre = run["pre"]
    log("[phase 8] prefill batches (ext_blocks, rows, computed tokens, ms): "
        + ", ".join(f"({e}, {r}, {n}, {ms:.3f})" for e, r, n, ms in pre))
    miss = [ms for e, _, _, ms in pre if e == 0]
    hit = [ms for e, _, _, ms in pre if e > 0]
    log(f"[phase 8] a miss batch's prefill {miss[0]:.3f} ms (6 rows of 272 "
        f"tokens) against a hit batch's {hit[0]:.3f} ms (6 rows of 9 suffix"
        f" tokens over 14 shared pages); decode-step ms median "
        f"{statistics.median(run['dec_t']) * 1e3:.3f}")
    P = eng._pool_pages
    keep = [c for c in range(eng.n_clients) if eng._method_of[c] != 1]
    pools = {n: torch.cat([t[:, c * P:(c + 1) * P] for c in keep], dim=1)
             for n, t in eng.caches["layers"].items()}
    streams = [r.generated.copy() for r in reqs]
    del run, eng
    # the same workload with the IA3 bank's scales x 1.5: every other
    # bank's stream and page bit for bit as before
    banks_b = list(banks)
    banks_b[1] = tree_map(lambda x: x * 1.5, banks[1])
    run2 = p8_serve(cfg, base, banks_b, late_bank, label="phase 8 isolation")
    eng2 = run2["eng"]
    ia3 = [i for i, r in enumerate(run2["reqs"]) if eng2._method_of[
        r.client_id] == 1]
    for i, r in enumerate(run2["reqs"]):
        if i not in ia3 and not np.array_equal(r.generated, streams[i]):
            raise AssertionError(f"[phase 8] request {i} (client "
                                 f"{r.client_id}) changed with the IA3 "
                                 "bank's scales")
    for n, t in eng2.caches["layers"].items():
        now = torch.cat([t[:, c * P:(c + 1) * P] for c in keep], dim=1)
        if not torch.equal(now, pools[n]):
            raise AssertionError(f"[phase 8] pool {n}: pages of the other "
                                 "banks' clients changed with the IA3 "
                                 "bank's scales")
    moved = sum(not np.array_equal(run2["reqs"][i].generated, streams[i])
                for i in ia3)
    log(f"[phase 8] isolation: with the IA3 bank's scales x 1.5, all "
        f"{len(streams) - len(ia3)} streams of the other banks' clients and "
        f"their {len(keep) * P} pool pages equal the first run's bit for "
        f"bit ({moved} of the {len(ia3)} IA3 streams moved)")
    del run2, eng2, pools
    run3 = p8_serve(cfg, base, banks, late_bank, prefix_cache=False,
                    label="phase 8 unshared")
    same = 0
    for i, r in enumerate(run3["reqs"]):
        d = first_diff(r.generated, streams[i])
        if d is None:
            same += 1
        else:
            log(f"[phase 8]   unshared request {i} (client {r.client_id}) "
                f"first differs at step {d}, where its top-2 logit gap was "
                f"{run3['gaps'][i][d]:.4f}")
    log(f"[phase 8] prefix_cache=False: {same} of {len(streams)} streams "
        f"equal the shared run's (printed, not gated: base products of other"
        f" row counts round otherwise in bf16); its prefill batches "
        f"(ext_blocks, rows, tokens, ms): " + ", ".join(
            f"({e}, {r}, {n}, {ms:.3f})" for e, r, n, ms in run3["pre"]))
    del run3
    torch.cuda.empty_cache()
    p8_suffix_prefill(torch.float32, F32_TOL)
    cfg2, base2, banks2 = p8_suffix_prefill(torch.bfloat16, BF16_TOL)
    p8_mixed_rows(cfg2, base2, banks2)
    del base2, banks2
    torch.cuda.empty_cache()
    times = profile_tick(cfg, base, banks, p8_spec(cfg, P8_ACFGS),
                         "phase 8")
    log("[phase 8] mixed 8-row tick beside phase 4's: " + ", ".join(
        f"{k} {times4[k]:.3f} -> {times[k]:.3f}" for k in times
        if k in times4))


# ---------------------------------------------------------------------------
# phase 9: the dense KV layout and the masked bank-wide step
# ---------------------------------------------------------------------------

P9_POLICIES = ("opportunistic", "nolockstep", "lockstep")
# per layer and tick: the kernels each run must launch (decode tick) and
# SGMV per decode tick or prefill call; every other counted kernel 0
P9_ATTN = {"9a": {"decode_attn": 2}, "9b": {"paged_decode_attn": 1},
           "9c": {}}


def p9_spec(cfg, page_block, quant=False, policy="opportunistic"):
    """Phase 4's spec on another layout or policy."""
    spec = serve_spec(cfg, quant)
    return dataclasses.replace(spec, serve=dataclasses.replace(
        spec.serve, page_block=page_block, policy=policy))


def p9_serve(cfg, base, bank, spec, label, attn, **engine_kw):
    """Serve phase 4's requests on ``spec`` with the launch
    counts checked tick by tick: per decode tick each ``attn`` kernel its
    count per layer, SGMV twice per layer per decode tick or prefill call,
    every other counted kernel 0. Records each request's top-2
    logit gap per step and the requests each ragged per-client prefill
    carried. Returns (requests, engine, gaps, ragged groups, launches,
    decode-step ms)."""
    L = cfg.n_layers
    eng = ServingEngine(spec, base, [bank], device=DEV, **engine_kw)
    reqs = make_requests(cfg, 4)
    for r in reqs:
        eng.submit(r)
    gaps, groups, dec_t = {}, [], []
    sample, ragged = eng._sample, eng._prefill_ragged

    def record_gap(logits, req):
        top = np.sort(logits, axis=-1)[:, -2:]
        gaps.setdefault(id(req), []).append(float((top[:, 1]
                                                   - top[:, 0]).min()))
        return sample(logits, req)

    def record_group(c, items):
        groups.append([id(r) for r, _ in items])
        return ragged(c, items)
    eng._sample, eng._prefill_ragged = record_gap, record_group
    eng._decode_step = _timed(eng._decode_step, dec_t)
    torch.cuda.synchronize()
    reset_counts()
    more = True
    while more:
        before = (read_counts(), eng.stats["ticks"], eng.stats["prefill_calls"])
        more = eng.service_tick()
        now = read_counts()
        d = {n: now[n] - before[0][n] for n in now}
        d_tick = eng.stats["ticks"] - before[1]
        d_pre = eng.stats["prefill_calls"] - before[2]
        want = {n: attn.get(n, 0) * L * d_tick for n in d}
        want["sgmv"] = 2 * L * (d_tick + d_pre)
        if d != want:
            raise AssertionError(
                f"[{label}] tick {eng._tick}: launches {d} for {d_tick} "
                f"decode ticks and {d_pre} prefill calls; want {want}")
    torch.cuda.synchronize()
    launches = read_counts()
    done = eng.drain_done()
    if len(done) != len(reqs) or eng.stats["quarantined_requests"] \
            or not all(r.status == "ok" and np.isfinite(gaps[id(r)]).all()
                       for r in reqs):
        raise AssertionError(f"[{label}] {len(done)} of {len(reqs)} requests "
                             f"finished, {eng.stats['quarantined_requests']} "
                             "quarantined or with non-finite logits")
    for r in reqs:
        g = r.generated
        if g.min() < 0 or g.max() >= cfg.vocab:
            raise AssertionError(f"[{label}] tokens out of range: {g}")
    return reqs, eng, gaps, groups, launches, dec_t


def p9_vs(label, reqs, gaps, streams, what):
    """Print each stream against ``streams`` (first differing step and the
    top-2 logit gap there in this run); returns how many are equal."""
    same = 0
    for i, r in enumerate(reqs):
        d = first_diff(r.generated, streams[i])
        if d is None:
            same += 1
        else:
            log(f"[{label}]   request {i} (client {r.client_id}) first "
                f"differs from {what} at step {d}, where its top-2 logit gap "
                f"was {gaps[id(r)][d]:.4f}")
    log(f"[{label}] {same} of {len(reqs)} streams equal {what}")
    return same


def p9_alone(cfg, base, bank, spec, reqs):
    """The streams of ``reqs`` served together (all arriving at tick 0) by a
    fresh engine of ``spec``: one request alone, or the requests of one
    ragged per-client prefill, at that prefill's shapes."""
    eng = ServingEngine(spec, base, [bank], device=DEV)
    mine = [Request(client_id=r.client_id, prompt=r.prompt.copy(),
                    max_new_tokens=r.max_new_tokens) for r in reqs]
    for r in mine:
        eng.submit(r)
    eng.run()
    return [r.generated for r in mine]


def p9_dense(cfg, base, bank, streams4):
    """9a: the dense layout under every policy, tick-checked; each request's
    stream bit for bit equal to it served alone by a fresh dense engine
    (a request that a ragged per-client prefill carried at another bucket
    than its own: to its ragged batch served alone, the same shapes, and
    printed against its own solo run). Returns the first run's launches
    and its decode-step ms."""
    solo = {}
    first = None
    for policy in P9_POLICIES:
        spec = p9_spec(cfg, 0, policy=policy)
        t0 = time.perf_counter()
        reqs, eng, gaps, groups, launches, dec_t = p9_serve(
            cfg, base, bank, spec, f"phase 9a {policy}", P9_ATTN["9a"])
        wall = time.perf_counter() - t0
        st = eng.stats
        log(f"[phase 9a] {policy}: kv=dense [L, C, B, T, K, hd] = "
            f"{list(eng.caches['layers']['k'].shape)}; {len(reqs)} requests "
            f"in {wall:.3f} s, {st['ticks']} decode ticks (masked, 8 rows), "
            f"{st['prefill_calls']} per-client prefills of which "
            f"{st['ragged_prefill_batches']} ragged, launches {launches} "
            f"(checked tick by tick: decode_attn 2 x {cfg.n_layers} per "
            f"decode tick, paged 0, sgmv {2 * cfg.n_layers} per decode tick "
            "and per prefill call); decode-step ms "
            f"{statistics.median(dec_t) * 1e3:.3f} (median)")
        spec0 = p9_spec(cfg, 0)
        by_id = {id(r): r for r in reqs}
        in_group = {}
        for g in groups:
            rs = [by_id[i] for i in g]
            pad = eng._bucket(max(r.prompt.shape[1] for r in rs))
            if any(eng._bucket(r.prompt.shape[1]) != pad for r in rs):
                for r, got in zip(rs, p9_alone(cfg, base, bank, spec0, rs)):
                    in_group[id(r)] = got
        for i, r in enumerate(reqs):
            if i not in solo:
                solo[i] = p9_alone(cfg, base, bank, spec0, [r])[0]
            want = in_group.get(id(r), solo[i])
            if not np.array_equal(r.generated, want):
                raise AssertionError(
                    f"[phase 9a] {policy}: request {i}'s stream differs from "
                    f"it served alone ({'its ragged batch' if id(r) in in_group else 'solo'}) "
                    f"at step {first_diff(r.generated, want)}")
        log(f"[phase 9a] {policy}: every stream equals its run alone on a "
            f"fresh dense engine, bit for bit ({len(in_group)} of them, "
            "carried by a ragged prefill at a larger bucket, against that "
            "ragged batch alone)")
        if in_group:
            p9_vs(f"phase 9a {policy}", [r for r in reqs if id(r) in in_group],
                  gaps, [solo[i] for i, r in enumerate(reqs)
                         if id(r) in in_group], "its own solo run")
        if first is None:
            first = (launches, dec_t)
            p9_vs("phase 9a", reqs, gaps, streams4, "phase 4's (paged) stream")
        del eng
    return first


def p9_steps_equal(cfg, base, bank):
    """9b's step check: every slot of phase 4's bank active, the masked step
    and the compacted step over the 8 rows in (client, slot) order, on
    copies of the same caches: logits and pools bit for bit."""
    spec = p9_spec(cfg, 16)
    eng = ServingEngine(spec, base, [bank], device=DEV)
    rng = np.random.default_rng(6)
    for i in range(8):
        eng.submit(Request(i % 4, rng.integers(0, cfg.vocab, (1, 160))
                           .astype(np.int32), 16))
    eng.service_tick()
    eng._sync_tbl()
    if not eng._active_mask.all():
        raise AssertionError("[phase 9b] not every slot is active")
    other = tree_map(torch.clone, eng.caches)
    masked = symbiosis.make_masked_decode_step(cfg, LORA, spec.serve)
    C, B = eng._active_mask.shape
    tok = torch.tensor(eng._last_tok, device=DEV)
    lm, caches = masked(base, bank, eng.caches, tok,
                        torch.ones((C, B), dtype=torch.bool, device=DEV))
    before = launch_count("paged_decode_attn")
    rows = (torch.arange(C, device=DEV).repeat_interleave(B).to(torch.int32),
            torch.arange(B, device=DEV).repeat(C).to(torch.int32))
    lc, _, other = eng._decode_step(base, bank, other, tok.reshape(-1),
                                    *rows, torch.ones(C * B, dtype=torch.bool,
                                                      device=DEV))
    torch.cuda.synchronize()
    if launch_count("paged_decode_attn") != before + cfg.n_layers:
        raise AssertionError("[phase 9b] the compacted step did not launch "
                             "the paged kernel once per layer")
    if not torch.equal(lm.reshape(C * B, -1), lc):
        raise AssertionError("[phase 9b] masked and compacted logits differ")
    for n in caches["layers"]:
        if not torch.equal(caches["layers"][n], other["layers"][n]):
            raise AssertionError(f"[phase 9b] pool {n} differs")
    if not torch.equal(caches["pos"], other["pos"]):
        raise AssertionError("[phase 9b] positions differ")
    log(f"[phase 9b] all-active 8-row step: masked and compacted, on copies "
        f"of the same caches, equal bit for bit (logits {list(lc.shape)}, "
        f"every pool leaf and pos)")


def phase9(cfg, base, bank, streams4, times4):
    """The dense layout, the masked paged ablation and int8 dense caches on
    phase 4's base tensors and bank; then the profiled ticks. Returns the
    dense kernel's launches on its main-path run (9a, opportunistic)."""
    L = cfg.n_layers
    warm_up(p9_spec(cfg, 0), base, bank)
    launches, dec_t = p9_dense(cfg, base, bank, streams4)
    torch.cuda.empty_cache()

    spec = p9_spec(cfg, 16)
    reqs, eng, gaps, _, l9b, dec_b = p9_serve(
        cfg, base, bank, spec, "phase 9b", P9_ATTN["9b"],
        compact_decode=False)
    log(f"[phase 9b] compact_decode=False on phase 4's pages: "
        f"{eng.stats['ticks']} masked decode ticks, launches {l9b} "
        f"(paged {L} per decode tick, checked tick by tick); decode-step ms "
        f"{statistics.median(dec_b) * 1e3:.3f} (median; 9a dense "
        f"{statistics.median(dec_t) * 1e3:.3f})")
    p9_vs("phase 9b", reqs, gaps, streams4, "phase 4's stream")
    del eng
    p9_steps_equal(cfg, base, bank)
    torch.cuda.empty_cache()

    spec = p9_spec(cfg, 0, quant=True)
    warm_up(spec, base, bank)
    reqs, eng, gaps, _, l9c, _ = p9_serve(cfg, base, bank, spec, "phase 9c",
                                          P9_ATTN["9c"])
    log(f"[phase 9c] kv=dense+int8: finite, launches {l9c} (no attention "
        f"kernel: plain torch, as JAX; checked tick by tick)")
    p9_vs("phase 9c", reqs, gaps, streams4, "phase 4's stream")
    del eng
    torch.cuda.empty_cache()

    t9 = profile_tick(cfg, base, [bank], p9_spec(cfg, 0), "phase 9d dense")
    log("[phase 9d] dense 8-row tick beside phase 4's: " + ", ".join(
        f"{k} {times4[k]:.3f} -> {t9[k]:.3f}" for k in t9 if k in times4))
    t9 = profile_tick(cfg, base, [bank], p9_spec(cfg, 16),
                      "phase 9d masked", n_req=2, compact_decode=False)
    log("[phase 9d] masked paged tick (2 of 8 slots) beside phase 4's "
        "(8 of 8, compacted): " + ", ".join(
            f"{k} {times4[k]:.3f} -> {t9[k]:.3f}" for k in t9 if k in times4))
    return launches["decode_attn"]


# ---------------------------------------------------------------------------
# phase 10: every PEFT method fine-tunes on the shared base; crash recovery
# ---------------------------------------------------------------------------

P10_ACFGS = {"lora": LORA,
             "ia3": AdapterConfig(method="ia3", targets=("k", "v", "down")),
             "prefix": AdapterConfig(method="prefix", targets=("q", "v"),
                                     n_prefix=16)}
P10_METHODS = ("lora", "lora", "ia3", "ia3", "prefix", "prefix")
# the multi-client and mixed steps' one schedule, at a step past warmup
P10_TCFG = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=10,
                       max_grad_norm=1.0, weight_decay=0.01, remat=False)
P10_STEP = 3


def random_bank(cfg, acfg, n, seed):
    """``n`` fp32 adapters of ``acfg`` stacked: LoRA B drawn, IA3 scales
    around 1, prefix K/V as initialised (drawn)."""
    if acfg.method == "lora":
        return random_lora(cfg, n, seed)
    g = gen(seed)
    bank = adapters.init_client_bank(cfg, acfg, n, g, device=DEV)
    for leaf in bank["layers"].values():
        if isinstance(leaf, dict):
            leaf["scale"].add_(torch.randn(leaf["scale"].shape, generator=g,
                                           device=DEV) * 0.1)
    return bank


def p10_opt(bank, step):
    n = tree_leaves(bank)[0].shape[0]
    return AdamWState(step=torch.full((n,), step, dtype=torch.int32,
                                      device=DEV),
                      m=tree_map(lambda x: torch.randn_like(x) * 1e-3, bank),
                      v=tree_map(lambda x: torch.rand_like(x) * 1e-6, bank))


def max_diff(a, b):
    """Largest |a - b| over matching leaves (0.0: bit for bit, when every
    leaf is also ``torch.equal``)."""
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def trees_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def p10_multi_vs_compact(cfg, base, acfg, bank):
    """``make_multi_client_train_step`` over 4 clients against the compact
    step over the same 4 rows with every row at the same hyperparameters:
    losses at 7a's tolerance, states at ``state_tol``; bit for bit
    printed."""
    opt = p10_opt(bank, P10_STEP)
    batch = train_batches(cfg, 4, 102)
    multi = symbiosis.make_multi_client_train_step(cfg, acfg, P10_TCFG)
    b1, o1, m1 = multi(base, tree_clone(bank), tree_clone(opt), batch,
                       P10_STEP)
    every = lambda v: torch.full((4,), v, dtype=torch.float32, device=DEV)
    hyper = {"step": torch.full((4,), P10_STEP, dtype=torch.int32,
                                device=DEV),
             "lr": every(P10_TCFG.lr), "warmup": every(P10_TCFG.warmup_steps),
             "total": every(P10_TCFG.total_steps),
             "wd": every(P10_TCFG.weight_decay),
             "gnorm": every(P10_TCFG.max_grad_norm)}
    compact = symbiosis.make_compact_train_step(cfg, acfg, remat=False)
    b2, o2, m2 = compact(base, tree_clone(bank), tree_clone(opt), batch,
                         torch.arange(4, dtype=torch.int32, device=DEV),
                         torch.ones(4, dtype=torch.bool, device=DEV), hyper)
    worst = compare(f"[phase 10a] {acfg.method} multi-client losses",
                    m1["loss"], m2["loss"], F32_STEP_TOL)
    for x, y in zip(tree_leaves((b1, o1.m, o1.v)),
                    tree_leaves((b2, o2.m, o2.v))):
        worst = max(worst, compare(f"[phase 10a] {acfg.method} multi-client "
                                   "state", x, y, state_tol(y)))
    log(f"[phase 10a] {acfg.method}: make_multi_client_train_step (4 clients,"
        f" step {P10_STEP}, lr {P10_TCFG.lr}, clip {P10_TCFG.max_grad_norm}, "
        f"wd {P10_TCFG.weight_decay}) against the compact step at the same "
        f"hyperparameters: max abs err {worst:.3e}; bit for bit: "
        f"{trees_equal((b1, o1, m1['loss']), (b2, o2, m2['loss']))}")


def p10_mixed(cfg, base, acfg, bank):
    """``make_mixed_step`` (4 clients train, then a dense 4-client x 2-slot
    bank decodes one token after a 16-token prefill) against its two
    halves run apart, bit for bit; every launch count set to 0 just before
    the mixed step and read just after: the dense decode kernel 2 per
    layer, SGMV 2 per layer for LoRA on q and v, nothing else. The decode
    half's kernels are held against their plain versions at this shape
    (8 rows, T 64, a row's whole cache one partial split, fp32): the
    decode step under ``plain_kernels()`` on copies of the same caches and
    tokens, logits and caches at ``F32_TOL``, no launch in that pass."""
    L = cfg.n_layers
    scfg = ServeConfig(n_clients=4, max_seq=64)
    inf = random_bank(cfg, acfg, 4, 103)
    caches = symbiosis.init_client_caches(cfg, 4, 2, 64, device=DEV)
    toks = torch.randint(0, cfg.vocab, (4, 2, 16), generator=gen(104),
                         device=DEV, dtype=torch.int32)
    logits, caches = symbiosis.make_multi_client_prefill(cfg, acfg, scfg)(
        base, inf, caches, {"tokens": toks})
    tok = logits.argmax(-1).to(torch.int32)
    opt = p10_opt(bank, P10_STEP)
    batch = train_batches(cfg, 4, 105)
    apart_caches, plain_caches = tree_clone(caches), tree_clone(caches)
    mixed = symbiosis.make_mixed_step(cfg, acfg, P10_TCFG, scfg)
    torch.cuda.synchronize()
    reset_counts()
    out = mixed(base, tree_clone(bank), tree_clone(opt), batch, inf, caches,
                tok, P10_STEP)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {name: 0 for name in KERNELS}
    want["decode_attn"] = 2 * L
    want["sgmv"] = 2 * L if acfg.method == "lora" else 0
    if counts != want:
        raise AssertionError(f"[phase 10a] {acfg.method} mixed step launched "
                             f"{counts}, expected {want}")
    b, o, m = symbiosis.make_multi_client_train_step(cfg, acfg, P10_TCFG)(
        base, tree_clone(bank), tree_clone(opt), batch, P10_STEP)
    lg, c = symbiosis.make_multi_client_decode_step(cfg, acfg, scfg)(
        base, inf, apart_caches, tok)
    if not trees_equal((out[0], out[1], out[2], out[3], out[4]["loss"],
                        out[4]["gnorm"]),
                       (b, o, c, lg, m["loss"], m["gnorm"])):
        raise AssertionError(f"[phase 10a] {acfg.method} mixed step differs "
                             "from its halves run apart (max abs "
                             f"{max_diff(out[:4], (b, o, c, lg)):.3e})")
    if not torch.isfinite(out[3]).all():
        raise AssertionError(f"[phase 10a] {acfg.method} mixed logits")
    torch.cuda.synchronize()
    reset_counts()
    with blocks.plain_kernels():
        plg, pc = symbiosis.make_multi_client_decode_step(cfg, acfg, scfg)(
            base, inf, plain_caches, tok)
    torch.cuda.synchronize()
    if any(read_counts().values()):
        raise AssertionError(f"[phase 10a] {acfg.method} plain decode pass "
                             f"launched {read_counts()}")
    err = compare(f"[phase 10a] {acfg.method} mixed decode logits against "
                  "plain", out[3], plg, F32_TOL)
    for x, y in zip(tree_leaves(out[2]), tree_leaves(pc)):
        err = max(err, compare(f"[phase 10a] {acfg.method} mixed decode "
                               "caches against plain", x, y, F32_TOL))
    log(f"[phase 10a] {acfg.method}: make_mixed_step (4 clients train, 4 x 2 "
        f"slots decode, dense, max_seq 64) equals its halves run apart bit "
        f"for bit (bank, AdamW state, caches, logits, losses, gnorms); "
        f"launches {counts}; its decode logits and caches against the decode "
        f"step under plain_kernels() (no launch): max abs err {err:.3e} "
        f"({F32_TOL})")


def phase10a():
    """10a: granite's width, 2 layers, fp32: the compact step over an IA3
    and a prefix bank against solo steps, padding and NaN rows; the
    multi-client step against the compact step; the mixed step against
    its halves, per method."""
    cfg = f32_granite()
    base = get_model(cfg).init_params(gen(100), DEV)
    for m in ("ia3", "prefix"):
        acfg = P10_ACFGS[m]
        bank = tree_map(lambda x: x.repeat((2,) + (1,) * (x.ndim - 1)),
                        random_bank(cfg, acfg, 4, 101))
        compact_rows_check(cfg, base, acfg, bank, 106, "[phase 10a]")
    for m in ("lora", "ia3", "prefix"):
        bank = random_bank(cfg, P10_ACFGS[m], 4, 107)
        p10_multi_vs_compact(cfg, base, P10_ACFGS[m], bank)
        p10_mixed(cfg, base, P10_ACFGS[m], bank)
    del base
    torch.cuda.empty_cache()


def p10_jobs(cfg, steps=TRAIN_STEPS, first_seed=0, data=None):
    """Two LoRA r8 (q, v), two IA3 (k, v, down) and two prefix (16 tokens)
    jobs of 2 x 256 tokens; ``data(job_index, stream)`` may wrap a
    stream."""
    jobs = []
    for i, m in enumerate(P10_METHODS):
        seed = first_seed + i
        stream = make_job_stream(cfg, TRAIN_B, TRAIN_S, seed=seed, device=DEV)
        jobs.append(FinetuneJob(
            acfg=P10_ACFGS[m], batch_size=TRAIN_B, seq_len=TRAIN_S,
            steps=steps, lr=1e-3, warmup_steps=1, seed=seed,
            name=f"{m}-{seed}",
            data=stream if data is None else data(i, stream)))
    return jobs


def p10_engine(cfg, base, **kw):
    return FinetuneEngine(EngineSpec(cfg=cfg, finetune=FinetuneConfig()),
                          base, device=DEV, debug=True, **kw)


def p10_bank_ticks(cfg, base):
    """One tick per bank (2 rows each): the host-clock ms of two
    synchronised calls and one traced call's device busy time and
    kernels."""
    eng = p10_engine(cfg, base)
    for j in p10_jobs(cfg, steps=4, first_seed=20):
        eng.submit(j)
    eng.train_tick()                              # admits, first use
    for key, bank in eng._banks.items():
        host = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._bank_tick(bank)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        with traced() as prof:
            eng._bank_tick(bank)
        busy, n, by_name = device_profile(prof)
        gemm = sum(c for name, (c, _) in by_name.items()
                   if any(k in name for k in GEMM_NAMES))
        busy_txt = (f"device busy {busy:.3f} ms "
                    f"({100 * busy / statistics.median(host):.1f}% of the "
                    f"host-clock tick), {n} kernels ({gemm} matrix products)"
                    if n else "device busy not measured (no device events "
                    "traced)")
        log(f"[phase 10b] {key.acfg.method} bank tick (2 rows x {TRAIN_B} x "
            f"{TRAIN_S} tokens): host ms {[round(x, 3) for x in host]}; "
            f"{busy_txt}")


def p10_memory(cfg, base):
    """Peak device memory beyond the resident base and bank of one bank
    step at 1 job per method (§3.6 path, FinetuneConfig's remat), beside
    the job's ``job_hbm_bytes`` charge."""
    remat = FinetuneConfig().remat
    out = []
    for i, m in enumerate(("lora", "ia3", "prefix")):
        acfg = P10_ACFGS[m]
        step = symbiosis.make_compact_train_step(cfg, acfg, remat=remat)
        bank = random_bank(cfg, acfg, 1, 110 + i)
        opt = p10_opt(bank, 0)
        batch = train_batches(cfg, 1, 111)
        args = (torch.zeros(1, dtype=torch.int32, device=DEV),
                torch.ones(1, dtype=torch.bool, device=DEV))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        step(base, bank, opt, batch, *args, step7a_hyper(1))
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - before) / 2**30
        charge = job_hbm_bytes(cfg, p10_jobs(cfg)[2 * i], remat=remat)
        out.append(f"{m} {peak:.3f} GiB (charge {charge / 2**30:.3f} GiB, "
                   f"{peak * 2**30 / charge:.1f}x)")
        del bank, opt, batch
    torch.cuda.empty_cache()
    log(f"[phase 10b] peak device memory beyond the resident base and bank, "
        f"one bank step at 1 job ({cfg.n_layers} layers bf16, {TRAIN_B} x "
        f"{TRAIN_S} tokens, remat={remat}), beside job_hbm_bytes: "
        + "; ".join(out))


def p10_results(jobs):
    return {j.name: (j.losses, j.result.adapter, j.result.opt) for j in jobs}


def phase10b(cfg, base):
    """10b: a FinetuneEngine(debug=True) over phase 4's base with the six
    jobs: every job's losses against its solo run; returns the results
    (the uninterrupted run of 10c) and the tick times."""
    jobs = p10_jobs(cfg)
    eng = p10_engine(cfg, base)
    for j in jobs:
        eng.submit(j)
    ticks = timed_ticks(eng)
    if any(j.status != "finished" or len(j.losses) != TRAIN_STEPS
           or not np.isfinite(j.losses).all() for j in jobs):
        raise AssertionError(f"[phase 10b] {[(j.status, j.losses) for j in jobs]}")
    if len(eng._banks) != 3 or eng.stats["peak_jobs"] != 6:
        raise AssertionError(f"[phase 10b] banks {len(eng._banks)}, stats "
                             f"{eng.stats}")
    worst, upd = 0.0, []
    for j in jobs:
        solo, first, solo_adapter = solo_run(cfg, base, j)
        worst = max(worst, compare(f"[phase 10b] {j.name} losses against its "
                                   "solo run", torch.tensor(j.losses),
                                   torch.tensor(solo), LOSS_7B_TOL))
        upd.append(round(update_rel_diff(j.result.adapter, solo_adapter,
                                         first), 4))
        if not upd[-1] <= UPDATE_7B_REL:
            raise AssertionError(f"[phase 10b] {j.name}'s adapter update is "
                                 f"{upd[-1]:.3e} (relative norm) from its "
                                 f"solo run's, limit {UPDATE_7B_REL}")
    tokens = 6 * TRAIN_B * TRAIN_S
    log(f"[phase 10b] {cfg.name}: {cfg.n_layers} layers bf16, FinetuneEngine"
        f"(debug=True) with 2 LoRA r8 (q, v), 2 IA3 (k, v, down) and 2 "
        f"prefix (16 tokens) jobs of {TRAIN_B} x {TRAIN_S} tokens, "
        f"{TRAIN_STEPS} steps each, 3 banks; stats {eng.stats}")
    log(f"[phase 10b] losses {[[round(x, 4) for x in j.losses] for j in jobs]}"
        f"; against each job's solo make_baseline_train_step: max abs err "
        f"{worst:.3e} ({LOSS_7B_TOL}); adapter updates against the solo "
        f"runs' (relative norm): {upd} (limit {UPDATE_7B_REL})")
    log(f"[phase 10b] tick ms (host clock, synchronised; 3 banks of 2 rows "
        f"each, {tokens} tokens per tick): "
        f"{[round(t * 1e3, 3) for t in ticks]}; after the first "
        f"{statistics.median(ticks[1:]) * 1e3:.3f} ms median, "
        f"{tokens / statistics.median(ticks[1:]):.0f} tokens/s")
    p10_bank_ticks(cfg, base)
    p10_memory(cfg, base)
    return p10_results(jobs), ticks


class NanAt:
    """A job stream whose batch at step ``at`` carries a NaN loss mask
    (every other batch a mask of ones)."""

    def __init__(self, inner, at):
        self.inner, self.at = inner, at

    def batch(self, step):
        b = dict(self.inner.batch(step))
        b["mask"] = torch.full(b["labels"].shape,
                               float("nan") if step == self.at else 1.0,
                               device=b["labels"].device)
        return b


def flip_payload_byte(path):
    """XOR the last byte of an engine blob (inside its pickle payload)."""
    with open(path, "r+b") as f:
        f.seek(-1, 2)
        b = f.read(1)
        f.seek(-1, 2)
        f.write(bytes([b[0] ^ 0xFF]))


def phase10c(cfg, base, ref):
    """10c: the engine killed after 2 ticks and resumed by a fresh engine
    from the newest valid blob (a corrupted newer copy skipped) ends every
    job bit for bit as the uninterrupted run ``ref``; a NaN-poisoned job's
    quarantine checkpoint restores its last clean state bit for bit."""
    with tempfile.TemporaryDirectory() as d:
        eng = p10_engine(cfg, base)
        for j in p10_jobs(cfg):
            eng.submit(j)
        eng.train_tick()
        save_engine_state(d, eng.engine_state())
        eng.train_tick()
        t0 = time.perf_counter()
        path = save_engine_state(d, eng.engine_state())
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        newest = os.path.join(d, "engine_00000002.ckpt")
        shutil.copy(path, newest)
        flip_payload_byte(newest)
        del eng                                          # the crash
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        seq, state = load_engine_state(d)
        fresh = p10_engine(cfg, base)
        fresh.load_engine_state(state)
        t_load = time.perf_counter() - t0
        if seq != 1:
            raise AssertionError(f"[phase 10c] restored blob {seq}, wanted 1 "
                                 "(the corrupted blob 2 must be skipped)")
        got = p10_results(fresh.run())
    if sorted(got) != sorted(ref):
        raise AssertionError(f"[phase 10c] jobs {sorted(got)} against "
                             f"{sorted(ref)}")
    diffs = {name: max_diff((got[name][1], got[name][2]),
                            (ref[name][1], ref[name][2]))
             for name in ref}
    same = {name: got[name][0] == ref[name][0]
            and trees_equal((got[name][1], got[name][2]),
                            (ref[name][1], ref[name][2])) for name in ref}
    if not all(same.values()):
        worst = max(diffs, key=diffs.get)
        raise AssertionError(f"[phase 10c] resumed jobs differ from the "
                             f"uninterrupted run: {same}; largest state "
                             f"difference {diffs[worst]:.3e} ({worst}); "
                             f"losses {[(got[n][0], ref[n][0]) for n in ref]}")
    log(f"[phase 10c] engine_state after 2 of {TRAIN_STEPS} ticks: blob of "
        f"{size} B written in {t_save * 1e3:.1f} ms; a copy with one payload "
        f"byte flipped as the newest blob was skipped (restored seq {seq}); "
        f"a fresh engine loaded it in {t_load * 1e3:.1f} ms and ran to the "
        f"end: all 6 jobs' losses, adapters and AdamW states equal the "
        f"uninterrupted run's (10b) bit for bit")

    with tempfile.TemporaryDirectory() as d:
        jobs = p10_jobs(cfg, steps=3, first_seed=30,
                        data=lambda i, s: NanAt(s, 2 if i == 2 else -1))
        jobs = [jobs[2], jobs[4]]                    # an IA3 and a prefix job
        eng = p10_engine(cfg, base, quarantine_dir=d)
        for j in jobs:
            eng.submit(j)
        eng.run()
        bad, ok = jobs
        if (bad.status, ok.status) != ("quarantined", "finished") \
                or bad.result.step != 2:
            raise AssertionError(f"[phase 10c] statuses {bad.status} / "
                                 f"{ok.status}, step {bad.result.step}")
        like = tree_map(torch.zeros_like, bad.result.adapter)
        ad, opt = restore_job_state(d, 2, like, adamw_init(like),
                                    name=bad.name, device=DEV)
        if not trees_equal((ad, opt), (bad.result.adapter, bad.result.opt)):
            raise AssertionError("[phase 10c] the quarantine checkpoint "
                                 "differs from the job's last clean state")
    log(f"[phase 10c] {bad.name}, its third batch poisoned to NaN: "
        f"quarantined after 2 clean steps, its checkpoint in quarantine_dir "
        f"restores that state bit for bit (restore_job_state); {ok.name} "
        f"beside it finished")


def phase10d(cfg, base, bank, streams4, launches4, ref):
    """10d: a SymbiosisEngine serving phase 4's 8 requests beside 10b's six
    jobs on the same base object: every greedy stream equal to phase 4's,
    the launch counts phase 4's, each job's losses, final adapter and
    AdamW state 10b's bit for bit (interleaving changes when a bank tick
    runs, not its program or its inputs)."""
    spec = dataclasses.replace(serve_spec(cfg, quant=False),
                               finetune=FinetuneConfig())
    sym = SymbiosisEngine.from_spec(spec, base, serving_banks=[bank],
                                    device=DEV)
    sym.finetune.debug = True
    reqs = make_requests(cfg, 4)
    jobs = p10_jobs(cfg)
    for item in reqs + jobs:
        sym.submit(item)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    while sym.tick():
        pass
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    counts = read_counts()
    if counts != launches4:
        raise AssertionError(f"[phase 10d] launches {counts}, phase 4's "
                             f"serving path launched {launches4}")
    for i, r in enumerate(reqs):
        if not np.array_equal(r.generated, streams4[i]):
            raise AssertionError(f"[phase 10d] request {i}'s greedy stream "
                                 "differs from phase 4's")
    for j in jobs:
        want = ref[j.name]
        if j.status != "finished" or j.losses != want[0] \
                or not trees_equal((j.result.adapter, j.result.opt), want[1:]):
            raise AssertionError(
                f"[phase 10d] {j.name} {j.status} losses {j.losses} against "
                f"10b's {want[0]}; largest state difference "
                f"{max_diff((j.result.adapter, j.result.opt), want[1:]):.3e}")
    st = sym.stats
    log(f"[phase 10d] SymbiosisEngine over phase 4's base object: 8 requests "
        f"beside 6 LoRA / IA3 / prefix jobs in {st['ticks']} ticks "
        f"({st['decode_ticks']} serving, {st['train_ticks']} train, "
        f"{t_all:.2f} s): every greedy stream equals phase 4's exactly; "
        f"launches {counts}, phase 4's; every job's losses, final adapter and "
        f"AdamW state equal 10b's bit for bit")


def phase10(cfg, base, bank, streams4, launches4):
    """Every PEFT method fine-tunes on the shared base, and tenants' state
    survives a crash: 10a the steps at full width, 10b the engine at full
    size, 10c recovery, 10d beside serving."""
    t = time.perf_counter()
    phase10a()
    log(f"[phase 10a] done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    ref, _ = phase10b(cfg, base)
    log(f"[phase 10b] done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    phase10c(cfg, base, ref)
    log(f"[phase 10c] done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    phase10d(cfg, base, bank, streams4, launches4, ref)
    log(f"[phase 10d] done ({time.perf_counter() - t:.1f} s)")
    torch.cuda.empty_cache()


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
    reports = _build.build(sorted({Path(src).stem
                                   for _, src, _ in KERNELS.values()}))
    for name, rep in reports.items():
        entry = ""                    # the mangled instantiation reported on
        for line in rep.splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif "registers" in line or "spill" in line:
                log(f"[phase 1] {name} {entry}: {line.strip()}")
    log(f"[phase 1] built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    errs = {name: [] for name in KERNELS}
    check_paged(errs["paged_decode_attn"])
    check_paged_quant(errs["paged_decode_attn_quant"])
    check_sgmv(errs["sgmv"])
    check_dense(errs["decode_attn"])
    check_flash(errs["flash_attn"])
    check_ragged(errs["ragged_linear"])
    torch.cuda.empty_cache()
    log(f"[phase 2] kernels agree with their plain versions "
        f"({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    model_wiring(quant=False)
    model_wiring(quant=True)
    dense_wiring()
    torch.cuda.empty_cache()
    log(f"[phase 3] done ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    (launches, cfg, caches, base, bank, lengths, first, times4,
     streams4) = serve_full()
    log(f"[phase 4] done ({time.perf_counter() - t:.1f} s)")
    launches4 = dict(launches)
    t = time.perf_counter()
    launches_q, caches_q, lengths_q = serve_quant(cfg, base, bank, first,
                                                  times4)
    launches["paged_decode_attn_quant"] = launches_q["paged_decode_attn_quant"]
    log(f"[phase 4b] done ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    timings = {"paged_decode_attn": time_decode_attn(cfg, caches, lengths),
               "paged_decode_attn_quant": time_decode_attn_quant(
                   cfg, caches_q, lengths_q),
               "sgmv": time_sgmv(bank)}
    del caches, caches_q
    torch.cuda.empty_cache()
    timings.update(time_unserved(base, lengths, errs["decode_attn"]))
    log(f"[phase 5] done ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    launches.update(phase6(cfg, base))
    log(f"[phase 6] done ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    phase7(cfg, base, bank, streams4, launches4, times4)
    log(f"[phase 7] done ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    phase8(cfg, base, times4)
    log(f"[phase 8] done ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    launches["decode_attn"] = phase9(cfg, base, bank, streams4, times4)
    log(f"[phase 9] done ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    phase10(cfg, base, bank, streams4, launches4)
    log(f"[phase 10] done ({time.perf_counter() - t:.1f} s); total "
        f"{time.perf_counter() - t_start:.1f} s")

    # launches: phase 4's counts, phase 4b's for the int8 kernel, phase 9a's
    # for the dense decode kernel (its serving path) and phase 6's for the
    # kernels no serving path runs (each the path that runs the kernel,
    # counted from 0 over that path alone)
    summary = [dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches[name], max_abs_err=max(errs[name]),
                    **timings[name])
               for name, (_, src, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
