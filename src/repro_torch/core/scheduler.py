"""Tick policies of the live serving engine (``repro.core.scheduler.
TickPolicy``; the event-driven simulation stays in the JAX package)."""
from __future__ import annotations

from typing import List


class TickPolicy:
    """The three batching policies as rules for the engine's tick loop:

    * ``lockstep``      — new requests join only when the in-flight batch
                          has fully drained; every tick batches all active
                          clients.
    * ``nolockstep``    — no cross-client batching: each tick serves one
                          ready client (round-robin).
    * ``opportunistic`` — continuous batching: requests join and leave
                          mid-stream and every tick batches exactly the
                          clients that are ready.

    The policy only chooses WHICH ready clients execute a tick, never the
    math of any sequence's own token stream."""

    NAMES = ("lockstep", "nolockstep", "opportunistic")

    def __init__(self, name: str):
        if name not in self.NAMES:
            raise ValueError(f"unknown policy {name!r}; pick from {self.NAMES}")
        self.name = name
        self._rr = 0

    def admit_now(self, n_inflight: int) -> bool:
        """May new requests be admitted while others are in flight?"""
        return n_inflight == 0 if self.name == "lockstep" else True

    def serving_set(self, ready: List[int]) -> List[int]:
        """Which of the ready clients join this decode tick."""
        if not ready:
            return []
        if self.name == "nolockstep":
            pick = sorted(ready)[self._rr % len(ready)]
            self._rr += 1
            return [pick]
        return sorted(ready)
