"""The fault classes the fine-tuning engine raises and catches (from
``repro.faults.plan``; the fault-injection plans wait for the chaos
harness)."""
from __future__ import annotations

from repro_torch.faults.health import FatalFault


class StreamExhausted(Exception):
    """The data stream ran dry before the job's step budget. Not a fault
    classification — the engine catches it explicitly and completes the job
    as ``finished_early`` (charges released)."""


class NonFiniteFault(FatalFault):
    """A tenant's per-row loss/grads went non-finite (the in-step probe
    tripped). Fatal: the state that produced it is suspect."""
