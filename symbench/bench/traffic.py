"""The one traffic generator: every mix is a data file read here.

A mix's sizes and its Poisson arrival gaps are drawn once from the file's
``shape_seed`` and kept in one order drawn from it too, so every ``--seed``
serves the same requests at the same times; the run's seed draws the token
ids and the tenants. Where a prefill's cost is set by the longest prompt
it pads to and arrivals queue behind it, the order is part of the work: a
run's tail swung with it when the seed permuted it (PERF.md).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch


@dataclasses.dataclass
class Item:
    """One request of a serving mix: its due time in seconds after the
    traffic starts (open loop; 0 for a backlog), tenant, prompt and output
    budget."""
    due: float
    tenant: int
    prompt: np.ndarray            # [1, S] int32
    max_new: int


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths from a {dist: lognormal, median, sigma, min, max}
    spec, rounded and clipped."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"no length distribution {spec['dist']!r}")
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def _draw(mix: dict, n: int, rng: np.random.Generator):
    p = lengths(mix["prompt"], n, rng)
    o = lengths(mix["output"], n, rng)
    arr = mix.get("arrivals")
    gaps = rng.exponential(1.0 / arr["rate_per_s"], n) if arr \
        else np.zeros(n)
    return gaps, p, o


def shapes(mix: dict, seconds: float):
    """The fixed multisets of (gaps, prompt lengths, output lengths) of a
    mix at a window length, the same for every run seed: for an open loop
    (a mix with Poisson ``arrivals``) one for the fill and one for the
    window (with a margin), so the window holds the same requests whatever
    the seed; for a backlog one."""
    rng = np.random.default_rng(mix["shape_seed"])
    if "arrivals" not in mix:
        return [_draw(mix, int(mix["backlog"]["requests"]), rng)]
    rate = mix["arrivals"]["rate_per_s"]
    n_fill = max(1, int(round(rate * mix["fill_seconds"])))
    n_win = int(np.ceil(rate * seconds * 1.5)) + 32
    return [_draw(mix, n_fill, rng), _draw(mix, n_win, rng)]


def serving_items(mix: dict, seed: int, seconds: float, vocab: int,
                  n_tenants: int) -> List[Item]:
    """The run's requests in submission order: each multiset of
    ``shapes`` in its fixed order (gaps, prompt and output lengths each
    permuted on their own by ``shape_seed``), then joined; an open loop's window requests are due
    from the fill's end on (a fill request drawn past it is due at its
    end). Tenants: uniform at random
    (``"tenants_order": "uniform"``) or round-robin."""
    rng = np.random.default_rng([seed, 1])
    order = np.random.default_rng([mix["shape_seed"], 1])
    parts = [[order.permutation(a) for a in part]
             for part in shapes(mix, seconds)]
    p, o = (np.concatenate([part[i] for part in parts]) for i in (1, 2))
    # the fill's arrivals from 0, cut at the fill's end; the window's from
    # the fill's end on
    due = np.cumsum(parts[0][0]) - parts[0][0][0]
    if len(parts) > 1:
        fill = mix["fill_seconds"]
        due = np.concatenate([np.minimum(due, fill),
                              fill + np.cumsum(parts[1][0])])
    n = len(p)
    if mix.get("tenants_order", "round_robin") == "uniform":
        tenants = rng.integers(0, n_tenants, n)
    else:
        tenants = np.arange(n) % n_tenants
    return [Item(float(due[i]), int(tenants[i]),
                 rng.integers(0, vocab, (1, int(p[i]))).astype(np.int32),
                 int(o[i])) for i in range(n)]


class JobStream:
    """A fine-tuning job's data: ``batch(step)`` is ``{"tokens", "labels"}``
    [batch, seq] int32 on the device, drawn from (run seed, job, step)
    alone, so a step's batch never depends on what ran before it. Labels
    are the next tokens."""

    def __init__(self, seed: int, job: int, batch: int, seq: int, vocab: int,
                 device):
        self.seed, self.job, self.batch_size, self.seq = seed, job, batch, seq
        self.vocab, self.device = vocab, device

    def batch(self, step: int):
        key = (self.seed * 1_000_003 + self.job * 10_007 + step) % (1 << 63)
        g = torch.Generator(device=self.device).manual_seed(key)
        t = torch.randint(0, self.vocab, (self.batch_size, self.seq + 1),
                          generator=g, device=self.device, dtype=torch.int64)
        return {"tokens": t[:, :-1].to(torch.int32),
                "labels": t[:, 1:].to(torch.int32)}
