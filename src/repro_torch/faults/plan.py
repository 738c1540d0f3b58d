"""Deterministic fault injection — ``repro.faults.plan`` on torch tensors.

``FaultPlan`` turns one integer seed into a reproducible schedule of
injected faults (which tenant, which kind, when), drawn with
``np.random.default_rng(seed)`` as in the JAX package, so one seed gives
the same schedule in both. The fault kinds mirror what a multi-tenant
service sees:

* ``nan_batch``    — a training batch whose loss mask is NaN: the row's
                     loss and every grad leaf go non-finite; the step's
                     finite probe drops the row's commit.
* ``nan_adapter``  — a serving client's adapter rows poisoned with NaN
                     (applied by the driver, not by a stream): its logits
                     go non-finite, the request is quarantined.
* ``stream_error`` — a transient exception out of a data or prompt stream:
                     retried with backoff from clean state.
* ``stream_end``   — the stream runs dry: the job finishes early, the
                     request is rejected.
* ``alloc_fail``   — an allocation failure mid-admission (transient): the
                     admission rolls back and retries.
* ``ckpt_corrupt`` — a checkpoint file bit-flipped or truncated on disk:
                     the CRC rejects it, restore falls back.
* ``ckpt_write``   — the checkpoint write itself fails (``CkptWriteHook``):
                     no new snapshot lands, the previous one stays newest.

``FaultyStream`` and ``FaultyRequestStream`` key their schedules by CALL
COUNT, not step: a retried step or fetch draws a clean batch or the same
prompt, which is what makes transient-fault recovery bit for bit. Clean
training batches carry a loss mask of 1.0, bitwise the same as no mask
(``models.losses.lm_loss`` fills ``mask=None`` with ones); wrap every job
of a bank (survivors with empty schedules) so the stacked batches agree.
"""
from __future__ import annotations

import dataclasses
import os
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.faults.health import FatalFault, TransientFault

KINDS = ("nan_batch", "nan_adapter", "stream_error", "stream_end",
         "alloc_fail", "ckpt_corrupt", "ckpt_write")
_STREAM_KINDS = ("nan_batch", "stream_error", "stream_end")
# prompts carry no loss mask: only the delivery faults apply to requests
_REQUEST_KINDS = ("stream_error", "stream_end")


class StreamError(TransientFault):
    """Injected transient data-stream exception (an IO hiccup)."""


class StreamExhausted(Exception):
    """The data stream ran dry before the job's step budget. Not a fault
    classification — the engines catch it explicitly and complete the job
    as ``finished_early`` (or reject the request)."""


class AllocationFault(TransientFault):
    """Injected allocation failure mid-admission (pool or arena
    exhaustion). Transient: the admission rolls back and the tenant
    retries."""


class CkptWriteFault(TransientFault):
    """Injected checkpoint-write IO error (ENOSPC, EIO, a crash mid-write).
    The snapshot that failed to land is simply absent: the previous one
    stays the newest valid blob (last good wins), and best-effort writers
    (quarantine checkpoints) swallow it."""


class NonFiniteFault(FatalFault):
    """A tenant's per-row loss, grads or logits went non-finite (the
    in-step probe tripped). Fatal: the state that produced it is
    suspect."""


class FaultyStream:
    """Wrap a job data stream with a call-count-keyed fault schedule.

    ``schedule`` maps call index -> kind (``nan_batch`` | ``stream_error``
    | ``stream_end``). Every batch that goes out carries a ``mask`` tensor
    on the inner batch's device. Picklable (part of the engine snapshot):
    the call counter rides along, so a restored engine replays the same
    schedule position."""

    def __init__(self, inner, schedule: Optional[Dict[int, str]] = None):
        self.inner = inner
        self.schedule = dict(schedule or {})
        self.calls = 0

    def batch(self, step: int):
        call = self.calls
        self.calls += 1
        kind = self.schedule.get(call)
        if kind == "stream_error":
            raise StreamError(f"injected stream error (call {call})")
        if kind == "stream_end":
            raise StreamExhausted(f"injected stream end (call {call})")
        b = dict(self.inner.batch(step))
        labels = b["labels"]
        fill = float("nan") if kind == "nan_batch" else 1.0
        b["mask"] = torch.full(labels.shape, fill, dtype=torch.float32,
                               device=labels.device)
        return b


class FaultyRequestStream:
    """Serving twin of ``FaultyStream``: a request's prompt delivery.

    A ``Request`` submitted with ``prompt=None, prompt_stream=...`` has its
    prompt resolved by the engine through ``fetch()`` at admission. Keyed
    by call count: ``stream_error`` raises a transient ``StreamError`` (the
    client backs off and the retried fetch draws the SAME prompt, so the
    finished stream is bitwise an unfaulted run's), ``stream_end`` raises
    ``StreamExhausted`` (the request is rejected). Picklable: the call
    counter rides along in engine snapshots."""

    def __init__(self, prompt, schedule: Optional[Dict[int, str]] = None):
        self.prompt = np.asarray(prompt, np.int32)
        self.schedule = dict(schedule or {})
        self.calls = 0

    def fetch(self):
        call = self.calls
        self.calls += 1
        kind = self.schedule.get(call)
        if kind == "stream_error":
            raise StreamError(f"injected request-stream error (call {call})")
        if kind == "stream_end":
            raise StreamExhausted(f"injected request-stream end (call {call})")
        return self.prompt


class AllocHook:
    """Admission fault hook: raises ``AllocationFault`` on scheduled
    admission-attempt indices. Pass as an engine's ``fault_hook``; the
    engine calls it once per admission attempt inside its transactional
    block, before any page or slot is taken."""

    def __init__(self, at: Iterable[int] = ()):
        self.at = set(at)
        self.calls = 0
        self.fired = 0

    def __call__(self, point: str, tenant) -> None:
        call = self.calls
        self.calls += 1
        if call in self.at:
            self.fired += 1
            raise AllocationFault(
                f"injected allocation failure ({point}, attempt {call})")


class CkptWriteHook:
    """Checkpoint-write fault hook, installed with
    ``checkpoint.set_write_fault_hook`` and consulted by every checkpoint
    writer before its payload reaches a final filename. Keyed by write
    call index. Two failure shapes:

    * ``mode="io_error"`` — raise before any byte lands: the atomic
      staging of ``save_engine_state`` and the manifest-last protocol of
      ``save_checkpoint`` mean no new snapshot appears.
    * ``mode="torn"`` — leave a truncated frame AT the final engine-blob
      path (a power cut), then raise: restore must reject it and fall back
      to the last good blob. Leaf-file checkpoints (``frame is None``)
      degrade to ``io_error``."""

    def __init__(self, at: Iterable[int] = (), mode: str = "io_error"):
        if mode not in ("io_error", "torn"):
            raise ValueError(f"unknown ckpt_write mode {mode!r}")
        self.at = set(at)
        self.mode = mode
        self.calls = 0
        self.fired = 0

    def __call__(self, point: str, path: str, frame) -> None:
        call = self.calls
        self.calls += 1
        if call not in self.at:
            return
        self.fired += 1
        if self.mode == "torn" and frame is not None:
            with open(path, "wb") as f:
                f.write(bytes(frame[: max(1, len(frame) // 2)]))
        raise CkptWriteFault(
            f"injected checkpoint-write fault ({self.mode}, {point}, "
            f"write {call}): {path}")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str       # one of KINDS
    tenant: int     # scenario-local victim index
    at: int         # stream call index / attempt index / tick it fires at


class FaultPlan:
    """Seeded, reproducible fault schedule over ``n_tenants`` tenants.

    Kinds round-robin through ``kinds`` (every requested kind is covered);
    victims and firing times come from ``np.random.default_rng(seed)``. The
    same (seed, n_tenants, n_faults, kinds, window) always gives the same
    events."""

    def __init__(self, seed: int, *, n_tenants: int, n_faults: int,
                 kinds: Sequence[str] = KINDS,
                 window: Tuple[int, int] = (1, 6)):
        for k in kinds:
            if k not in KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        rng = np.random.default_rng(seed)
        events = []
        for i in range(n_faults):
            events.append(FaultEvent(
                kind=kinds[i % len(kinds)],
                tenant=int(rng.integers(n_tenants)),
                at=int(rng.integers(window[0], window[1]))))
        self.events: Tuple[FaultEvent, ...] = tuple(events)
        self.seed = seed
        self.n_tenants = n_tenants

    def of_kind(self, *kinds: str) -> List[FaultEvent]:
        return [e for e in self.events if e.kind in kinds]

    def counts(self) -> Dict[str, int]:
        return dict(Counter(e.kind for e in self.events))

    def victims(self, *kinds: str) -> set:
        return {e.tenant for e in (self.of_kind(*kinds) if kinds
                                   else self.events)}

    def stream_schedule(self, tenant: int) -> Dict[int, str]:
        """Call index -> kind for ``FaultyStream`` (stream kinds; the first
        event wins a contested call index)."""
        sched: Dict[int, str] = {}
        for e in self.events:
            if e.tenant == tenant and e.kind in _STREAM_KINDS:
                sched.setdefault(e.at, e.kind)
        return sched

    def request_schedule(self, tenant: int) -> Dict[int, str]:
        """Call index -> kind for ``FaultyRequestStream`` (delivery kinds;
        the first event wins a contested call index)."""
        sched: Dict[int, str] = {}
        for e in self.events:
            if e.tenant == tenant and e.kind in _REQUEST_KINDS:
                sched.setdefault(e.at, e.kind)
        return sched

    def alloc_schedule(self) -> set:
        """Admission-attempt indices at which ``AllocHook`` fires."""
        return {e.at for e in self.of_kind("alloc_fail")}

    def ckpt_write_schedule(self) -> set:
        """Checkpoint-write call indices at which ``CkptWriteHook`` fires."""
        return {e.at for e in self.of_kind("ckpt_write")}


# ---------------------------------------------------------------------------
# on-disk corruption (the ckpt_corrupt kind and the corruption tests)

def corrupt_flip(path: str, *, seed: int = 0) -> int:
    """XOR one seeded byte of ``path`` with 0xFF (always a real change).
    Returns the flipped offset."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if not data:
        raise ValueError(f"{path} is empty")
    off = int(np.random.default_rng(seed).integers(len(data)))
    data[off] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))
    return off


def corrupt_truncate(path: str, keep: Optional[int] = None) -> int:
    """Truncate ``path`` (default: to half its size). Returns kept bytes."""
    size = os.path.getsize(path)
    keep = size // 2 if keep is None else keep
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep
