"""Per-tenant health state machine (``repro.faults.health``, copied).

Every fine-tuning job carries a ``HealthRecord`` walking::

    HEALTHY --fault--> SUSPECT --retries left--> RESUMED (-> HEALTHY)
                           |
                           +--fatal / retries exhausted--> QUARANTINED
                                                               |
                                                               v
                                                           RETIRED

Transient faults (a stream hiccup) earn a bounded exponential backoff
measured in ENGINE TICKS — deterministic, no wall clock — and the tenant
retries from its last clean state. Fatal faults (non-finite loss/grads,
retries exhausted) quarantine the tenant: it is retired and its bank slot
and router charge are released. Survivors never observe any of this: their
committed state is what it would be had the faulty tenant never been
admitted after its last clean tick.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class HealthState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"          # transient fault, backing off before retry
    QUARANTINED = "quarantined"  # fatal: checkpointed + retired, charges freed
    RETIRED = "retired"          # left the engine (clean completion included)
    RESUMED = "resumed"          # recovered from SUSPECT; HEALTHY on next clean tick


class TransientFault(Exception):
    """Marker base for injected/classified faults that are worth retrying
    (the tenant's state is still clean — the fault hit before commit)."""


class FatalFault(Exception):
    """Marker base for faults that immediately quarantine the tenant."""


def classify(exc: BaseException) -> str:
    """'transient' or 'fatal'. IO-shaped errors (stream hiccups, filesystem
    races) are worth retrying; everything else — including programming
    errors — quarantines rather than loops."""
    if isinstance(exc, TransientFault):
        return "transient"
    if isinstance(exc, FatalFault):
        return "fatal"
    if isinstance(exc, (OSError, IOError, TimeoutError, ConnectionError)):
        return "transient"
    return "fatal"


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Retry/backoff/quarantine knobs (defaults used by both engines)."""
    max_retries: int = 3          # consecutive transient faults before fatal
    backoff_base: int = 1         # ticks of backoff after the 1st fault
    max_backoff: int = 8          # backoff ceiling (ticks)
    client_quarantine_after: int = 2   # serving: faulty REQUESTS before the
    #                                    whole client is refused admission

    def backoff(self, failures: int) -> int:
        """Deterministic exponential backoff: 1, 2, 4, ... capped."""
        return min(self.backoff_base * (2 ** max(failures - 1, 0)),
                   self.max_backoff)


@dataclasses.dataclass
class HealthRecord:
    """One tenant's health trajectory. Pure host state — picklable, part of
    the engine checkpoint."""
    state: HealthState = HealthState.HEALTHY
    failures: int = 0             # consecutive transient faults
    total_faults: int = 0         # lifetime count (report/telemetry)
    next_eligible_tick: int = 0   # SUSPECT tenants skip ticks before this
    history: List[Tuple[int, str, str]] = dataclasses.field(
        default_factory=list)     # (tick, state, reason)

    def _log(self, tick: int, reason: str):
        self.history.append((tick, self.state.value, reason))

    @property
    def active(self) -> bool:
        return self.state not in (HealthState.QUARANTINED, HealthState.RETIRED)

    def eligible(self, tick: int) -> bool:
        """May this tenant run work at ``tick``? (backoff gate)"""
        return self.active and tick >= self.next_eligible_tick

    def last_transition(self) -> Optional[Tuple[int, str, str]]:
        """Newest ``(tick, state, reason)`` history entry — the payload the
        engines attach to health events (docs/observability.md)."""
        return self.history[-1] if self.history else None

    def ok(self, tick: int):
        """A clean committed tick: clears SUSPECT/RESUMED back to HEALTHY."""
        if self.state is HealthState.SUSPECT:
            self.state = HealthState.RESUMED
            self._log(tick, "recovered")
        elif self.state is HealthState.RESUMED:
            self.state = HealthState.HEALTHY
            self._log(tick, "clean")
        self.failures = 0

    def trip(self, tick: int, reason: str, policy: HealthPolicy) -> str:
        """Record a fault at ``tick``; returns the verdict: 'retry' (tenant
        goes SUSPECT with backoff) or 'quarantine' (caller must checkpoint +
        retire + release)."""
        self.total_faults += 1
        self.failures += 1
        if self.failures > policy.max_retries:
            self.state = HealthState.QUARANTINED
            self._log(tick, f"retries exhausted: {reason}")
            return "quarantine"
        self.state = HealthState.SUSPECT
        self.next_eligible_tick = tick + policy.backoff(self.failures)
        self._log(tick, reason)
        return "retry"

    def quarantine(self, tick: int, reason: str):
        self.total_faults += 1
        self.state = HealthState.QUARANTINED
        self._log(tick, reason)

    def retire(self, tick: int, reason: str = "done"):
        if self.state is not HealthState.QUARANTINED:
            self.state = HealthState.RETIRED
        self._log(tick, reason)
