"""Placement router: the provider's admission control (the on-card half of
``repro.serving.router``).

Given a request (context length, batch) and the card slots with their free
device memory, place the request's cache beside the base executor on the
first slot it fits, priced with the analytic model of
``serving.kvcache``. ``ServingEngine`` uses it as admission control: a
request is admitted only when ``route()`` finds (and commits) a
placement, and its charge is released when its slots free, so queued
requests take the capacity the moment it returns. ``route_train``
charges a fine-tuning job's state the same way (``training.FinetuneEngine``),
and ``route_bank`` a serving bank's resident adapters. Every placement
lives on a card slot, so ``release`` refunds each mode alike.

The port's engine keeps every cache on the card, so the reference's
off-card placements (``gpu_offload``, ``hetero``) are not offered: a
request that fits no slot waits. The JAX router prices latency with its
module's default chip whatever a slot says; this one prices with the
``chip`` it is given (default the H100), so a comparison with the
reference passes the same chip to both.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.common.hardware import H100, Chip
from repro_torch.config import ModelConfig
from repro_torch.serving.kvcache import cache_bytes, decode_token_cost


class NoCapacity(RuntimeError):
    """No slot fits the charge: the tenant stays queued until capacity
    returns."""


class AdmissionStall(RuntimeError):
    """Queued work can never be admitted: no free capacity, and nothing
    running in the engine that raised it that could free any. Under a
    SHARED router another engine may still free some
    (``training.SymbiosisEngine``)."""


@dataclasses.dataclass
class Slot:
    """One card's client-side capacity (base executor excluded)."""
    slot_id: int
    free_hbm: float

    def fits(self, nbytes: float) -> bool:
        return nbytes <= self.free_hbm


@dataclasses.dataclass
class Placement:
    slot_id: int
    est_s_per_token: float
    cache_bytes: int
    mode: str = "gpu"        # gpu (a request's cache) | train | bank


class PlacementRouter:
    """Routes client sessions onto card slots."""

    def __init__(self, cfg: ModelConfig, slots: List[Slot], *,
                 chip: Chip = H100):
        self.cfg = cfg
        self.chip = chip
        self.slots = {s.slot_id: s for s in slots}
        # conservation ledger: the initial capacities and the identity list
        # of outstanding placements; conservation_errors() recomputes free
        # capacity from them and reports any drift
        self._initial = {s.slot_id: s.free_hbm for s in slots}
        self._committed: List[Placement] = []

    def route(self, context_len: int, batch: int = 1, *,
              latency_sensitive: bool = True, alloc_tokens: int = 0,
              quant: bool = False) -> Placement:
        """Commit the request's cache to the first slot it fits.
        ``context_len`` drives the latency estimate; ``alloc_tokens``
        (0: ``context_len``) the memory charge, i.e. the tokens the cache
        layout pins; ``quant`` prices int8 entries. Raises NoCapacity
        when no slot fits. ``latency_sensitive`` is accepted and has no
        effect: it only steers the reference's off-card placements, which
        this router does not offer."""
        del latency_sensitive
        need = cache_bytes(self.cfg, alloc_tokens or context_len, batch,
                           quant=quant)
        cost = decode_token_cost(self.cfg, context_len, chip=self.chip)
        for s in self.slots.values():
            if cost != float("inf") and s.fits(need):
                p = Placement(s.slot_id, cost * batch, need)
                self.commit(p)
                return p
        raise NoCapacity(
            f"no slot fits {need / 1e9:.1f} GB cache "
            f"(context {context_len} x batch {batch})")

    def route_train(self, nbytes: float, *,
                    latency_sensitive: bool = False) -> Placement:
        """Commit one FINE-TUNING job's client-side state (adapter + AdamW
        moments + activations, ``training.job_charge_bytes``) to
        the first slot it fits. Training state is touched every step, so it
        is placed on the card only; the FinetuneEngine releases the charge
        when the job retires. Raises NoCapacity when no slot fits.
        ``latency_sensitive`` is accepted for symmetry with ``route`` and
        ignored, as the reference's is."""
        del latency_sensitive
        for s in self.slots.values():
            if s.fits(nbytes):
                p = Placement(s.slot_id, 0.0, int(nbytes), "train")
                self.commit(p)
                return p
        raise NoCapacity(
            f"no accelerator slot fits {nbytes / 1e9:.2f} GB of training "
            f"state (adapter + optimizer + activations)")

    def route_bank(self, nbytes: float) -> Placement:
        """Commit one SERVING bank's resident adapter weights (the
        client-stacked trees a mixed-bank engine keeps on the card for its
        lifetime: ``adapter_bytes`` times the bank's clients) to the first
        slot it fits. Adapters are read every decode tick, so they are
        placed on the card only; the engine releases the charge through
        ``ServingEngine.release_banks`` or ``retire_bank``. Raises
        NoCapacity when no slot fits."""
        for s in self.slots.values():
            if s.fits(nbytes):
                p = Placement(s.slot_id, 0.0, int(nbytes), "bank")
                self.commit(p)
                return p
        raise NoCapacity(
            f"no accelerator slot fits {nbytes / 1e9:.3f} GB of serving-bank "
            f"adapter weights")

    def commit(self, p: Placement):
        self.slots[p.slot_id].free_hbm -= p.cache_bytes
        self._committed.append(p)

    def release(self, p: Placement):
        # identity scan: two tenants can hold field-equal placements
        for i, q in enumerate(self._committed):
            if q is p:
                del self._committed[i]
                break
        else:
            raise RuntimeError(
                f"release of a placement that was never committed (or was "
                f"already released): {p}")
        self.slots[p.slot_id].free_hbm += p.cache_bytes

    def utilization(self) -> dict:
        """Live against initial capacity per slot, and the outstanding
        placements; host reads only."""
        return {
            "slots": {sid: {"free_hbm": s.free_hbm,
                            "initial_hbm": self._initial[sid]}
                      for sid, s in self.slots.items()},
            "placements": len(self._committed),
            "committed_bytes": sum(p.cache_bytes for p in self._committed),
        }

    def conservation_errors(self) -> List[str]:
        """Recompute every capacity from the initial snapshot minus the
        outstanding placements; drift from the live counters means a
        leaked or double-released charge. Empty list == conserved."""
        want = dict(self._initial)
        for p in self._committed:
            want[p.slot_id] -= p.cache_bytes
        return [f"slot {sid}: free_hbm {s.free_hbm:.0f} != ledger "
                f"{want[sid]:.0f} (leaked/double-released charge)"
                for sid, s in self.slots.items()
                if abs(s.free_hbm - want[sid]) > 1.0]
