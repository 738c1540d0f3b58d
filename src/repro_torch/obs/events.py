"""Structured, drainable event log: the client-visible side of telemetry
(``repro.obs.events``, copied).

Events are the discrete state changes a tenant can observe: ``admit``,
``retire``, ``reject``, ``bank_growth``, ``bank_retire``, ``quarantine``,
``retry``, ``backoff``, ``health``, ``compile`` / ``recompile``,
``capture_start`` / ``capture_stop`` / ``capture_failed``.  The engines emit
them (faults/health transitions; ``compile`` / ``recompile`` come from
``Obs.on_dispatch_compile``); clients pull them with ``drain`` — filtered
drains remove only the matching events and leave the rest queued for other
consumers.

The log is bounded: past ``maxlen`` the oldest events are dropped and
counted, never silently.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

#: sentinel distinguishing "no tenant filter" from "tenant is None".
UNSET = object()


@dataclasses.dataclass(frozen=True)
class Event:
    """One engine state change.  ``tenant`` is a client id (serving) or job
    name (training); ``data`` is a sorted tuple of (key, value) pairs so the
    event is hashable and deterministic to serialize."""

    seq: int
    kind: str
    engine: str = ""
    tick: int = 0
    tenant: object = None
    data: Tuple[Tuple[str, object], ...] = ()

    def asdict(self) -> dict:
        return {
            "seq": self.seq,
            "kind": self.kind,
            "engine": self.engine,
            "tick": self.tick,
            "tenant": self.tenant,
            "data": {k: v for k, v in self.data},
        }


class EventLog:
    def __init__(self, maxlen: int = 10000) -> None:
        self.maxlen = int(maxlen)
        self.dropped = 0
        self._seq = 0
        self._buf: List[Event] = []

    def __len__(self) -> int:
        return len(self._buf)

    def emit(self, kind: str, *, engine: str = "", tick: int = 0,
             tenant: object = None, **data) -> Event:
        ev = Event(self._seq, kind, engine, int(tick), tenant,
                   tuple(sorted(data.items())))
        self._seq += 1
        if len(self._buf) >= self.maxlen:
            del self._buf[0]
            self.dropped += 1
        self._buf.append(ev)
        return ev

    def _match(self, ev: Event, tenant, kind, engine) -> bool:
        if tenant is not UNSET and ev.tenant != tenant:
            return False
        if kind is not None and ev.kind != kind:
            return False
        if engine is not None and ev.engine != engine:
            return False
        return True

    def peek(self, *, tenant=UNSET, kind: Optional[str] = None,
             engine: Optional[str] = None) -> List[Event]:
        """Non-destructive filtered view."""
        return [e for e in self._buf if self._match(e, tenant, kind, engine)]

    def drain(self, *, tenant=UNSET, kind: Optional[str] = None,
              engine: Optional[str] = None) -> List[Event]:
        """Remove and return matching events; non-matching events stay queued."""
        out, keep = [], []
        for e in self._buf:
            (out if self._match(e, tenant, kind, engine) else keep).append(e)
        self._buf = keep
        return out
