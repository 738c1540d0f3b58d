"""Base executor: the shared frozen-layer service (paper §3.2) —
``repro.core.base_executor`` in PyTorch.

The host-level executor of the opportunistic-batching engine: it owns the
frozen per-layer weights, accepts per-client layer requests as ragged token
segments, packs them into a token-budget buffer (``core.packing``) and runs
one packed linear per (layer, path) through the ragged-linear kernel
(``kernels.ragged_linear``), which skips the buffer's dead row tiles and
writes exact zeros past the live count. The result equals ``frozen_dense``
per segment (the JAX executor's matmul); nothing new reaches a user.

Packed buffers are padded to the next power-of-two token budget (at least
64), which bounds the shapes the kernel sees.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import packing
from repro_torch.kernels import ragged_linear


def _bucket(n: int, floor: int = 64) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


class BaseExecutor:
    """Holds frozen base weights; serves per-layer batched execution."""

    def __init__(self, layer_weights: Dict[Tuple[int, str], Tuple],
                 device="cuda"):
        """layer_weights: (layer_idx, path) -> (W [din, dout], b or None),
        tensors on ``device`` (views are kept as they are, never copied)."""
        self.device = resolve_device(device)
        for key, (w, b) in layer_weights.items():
            for t in (w, b):
                if t is not None and t.device.type != self.device.type:
                    raise ValueError(f"weights {key} live on {t.device}, "
                                     f"the executor on {self.device}")
        self.weights = layer_weights
        self._stats = {"calls": 0, "tokens": 0, "batched_requests": 0}

    def run_layer(self, layer: int, path: str,
                  segments: List[torch.Tensor]) -> List[torch.Tensor]:
        """Execute one base layer for a batch of client segments.

        segments: list of [Ti, din] tensors on the executor's device
        (ragged — no padding, paper §3.7). Returns the per-client outputs,
        split back out. One ragged-linear launch per call."""
        w, b = self.weights[(layer, path)]
        for s in segments:
            if s.device.type != self.device.type:
                raise ValueError(f"segment on {s.device}, the executor on "
                                 f"{self.device}")
        lens = [s.shape[0] for s in segments]
        total = sum(lens)
        budget = _bucket(total)
        S_max = max(lens)
        stacked = torch.nn.utils.rnn.pad_sequence(segments, batch_first=True)
        packed = packing.pack(stacked, torch.tensor(lens, dtype=torch.int32,
                                                    device=stacked.device),
                              budget)
        out = ragged_linear(packed.buf, w, b, n_live=total)
        unpacked = packing.unpack(packed, out, S_max)
        self._stats["calls"] += 1
        self._stats["tokens"] += total
        self._stats["batched_requests"] += len(segments)
        return [unpacked[i, :lens[i]] for i in range(len(segments))]

    @property
    def stats(self):
        s = dict(self._stats)
        s["avg_batch"] = s["batched_requests"] / max(1, s["calls"])
        return s


def calibrate_layer_cost(din: int = 512, dout: int = 512, reps: int = 5,
                         device="cuda"):
    """Measure (fixed overhead, per-token cost) in seconds of a packed
    base-layer call (the executor's ragged linear) on ``device`` — used to
    parameterize the scheduler simulation. On the card each timing is taken
    between two synchronisations, so it covers the device's work."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    w = torch.zeros((din, dout), dtype=torch.float32, device=dev)
    costs = {}
    for n in (64, 1024):
        x = torch.ones((n, din), dtype=torch.float32, device=dev)
        ragged_linear(x, w)
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            ragged_linear(x, w)
        sync()
        costs[n] = (time.perf_counter() - t0) / reps
    per_token = (costs[1024] - costs[64]) / (1024 - 64)
    overhead = max(1e-6, costs[64] - 64 * per_token)
    return overhead, max(per_token, 1e-9)
