"""Opportunistic batching policies (paper §3.7, Tables 4/5), as
``repro.core.scheduler``: the live engine's ``TickPolicy`` and the
event-driven simulation of the base executor (``simulate``).

In the simulation each client alternates client-side compute with a
base-layer request per layer, and the base executor serializes batched
executions; the policy decides how long a layer batch may wait:

* ``lockstep``      — a layer executes only when ALL active clients'
                      requests for it have arrived;
* ``nolockstep``    — every request executes at once, batch of 1;
* ``opportunistic`` — a request waits at most ``wait_fraction`` x its own
                      iteration cost (latency-sensitive ones not at all),
                      and whatever accumulated is batched.

Pure Python on the host: the same events in the same order and the same
float operations as the reference, so its results are equal to the
reference's exactly.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List


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


@dataclass
class ClientSpec:
    client_id: int
    n_tokens: int                 # tokens per base-layer request
    client_side_time: float       # seconds of client-side compute per layer
    n_iterations: int = 1         # fine-tune steps or decode tokens to run
    latency_sensitive: bool = False


@dataclass
class SimResult:
    makespan: float
    per_client_latency: Dict[int, float]
    avg_batch_size: float
    total_tokens: int
    throughput: float
    n_executions: int

    def summary(self):
        lat = sum(self.per_client_latency.values()) / max(
            1, len(self.per_client_latency))
        return {"throughput_tok_s": self.throughput, "mean_latency_s": lat,
                "avg_batch": self.avg_batch_size, "makespan_s": self.makespan}


def simulate(clients: List[ClientSpec], n_layers: int, policy: str,
             exec_overhead: float, per_token_cost: float,
             wait_fraction: float = 0.1, backward: bool = False) -> SimResult:
    """Run the event-driven, work-conserving executor.

    A layer batch becomes ready per the policy (at once / when every
    active client arrived / after a size-aware deadline); the executor,
    when idle, dispatches the oldest ready layer with EVERYTHING pending
    on it, so batches keep accumulating while it is busy. An
    opportunistic executor that is idle never waits on a deadline: it
    takes the layer whose first request is oldest. An execution of n
    tokens costs ``exec_overhead + n * per_token_cost`` seconds.
    ``backward=True`` doubles the layer walk (a fine-tuning step's forward
    and backward)."""
    total_layers = n_layers * (2 if backward else 1)
    events = []                      # (time, seq, kind, payload)
    seq = 0

    def push(t, kind, payload):
        nonlocal seq
        heapq.heappush(events, (t, seq, kind, payload))
        seq += 1

    iters_left = {c.client_id: c.n_iterations for c in clients}
    spec = {c.client_id: c for c in clients}
    start_time = {c.client_id: 0.0 for c in clients}
    latencies: Dict[int, List[float]] = {c.client_id: [] for c in clients}
    pending: Dict[int, List] = {}    # layer -> [(client_id, arrive_t)]
    ready_at: Dict[int, float] = {}  # layer -> time it became ready
    exec_busy = False
    n_exec = 0
    batch_sizes = []

    def exec_cost(tokens):
        return exec_overhead + tokens * per_token_cost

    def mark_ready(layer, t):
        if layer in pending and pending[layer] and layer not in ready_at:
            ready_at[layer] = t

    def try_dispatch(now):
        nonlocal exec_busy, n_exec
        if exec_busy:
            return
        if ready_at:
            layer = min(ready_at, key=ready_at.get)
            del ready_at[layer]
        elif policy == "opportunistic" and pending:
            layer = min(pending, key=lambda lay: pending[lay][0][1])
        else:
            return
        if policy == "nolockstep":
            entries = [pending[layer].pop(0)]
            if not pending[layer]:
                del pending[layer]
            else:
                ready_at[layer] = now          # the rest stays ready
        else:
            entries = pending.pop(layer)
        tokens = sum(spec[cid].n_tokens for cid, _ in entries)
        exec_busy = True
        n_exec += 1
        batch_sizes.append(len(entries))
        push(now + exec_cost(tokens), "exec_done", (layer, entries))

    active = {c.client_id for c in clients}

    def lockstep_check(now):
        for lay in list(pending):
            if pending[lay] and {e[0] for e in pending[lay]} >= active:
                mark_ready(lay, now)

    for c in clients:
        push(c.client_side_time, "request", (c.client_id, 0))

    now = 0.0
    while events:
        now, _, kind, payload = heapq.heappop(events)
        if kind == "request":
            cid, layer = payload
            if layer >= total_layers:
                latencies[cid].append(now - start_time[cid])
                iters_left[cid] -= 1
                if iters_left[cid] > 0:
                    start_time[cid] = now
                    push(now + spec[cid].client_side_time, "request", (cid, 0))
                else:
                    active.discard(cid)
                    if policy == "lockstep":
                        lockstep_check(now)
                        try_dispatch(now)
                continue
            pending.setdefault(layer, []).append((cid, now))
            if policy == "nolockstep":
                mark_ready(layer, now)
            elif policy == "lockstep":
                lockstep_check(now)
            else:                      # opportunistic: size-aware deadline
                iter_cost = (spec[cid].client_side_time
                             + exec_cost(spec[cid].n_tokens))
                wait = (0.0 if spec[cid].latency_sensitive
                        else wait_fraction * iter_cost)
                if wait == 0.0:
                    mark_ready(layer, now)
                else:
                    push(now + wait, "deadline", layer)
            try_dispatch(now)
        elif kind == "deadline":
            mark_ready(payload, now)
            try_dispatch(now)
        elif kind == "exec_done":
            layer, entries = payload
            exec_busy = False
            for cid, _ in entries:
                push(now + spec[cid].client_side_time, "request",
                     (cid, layer + 1))
            try_dispatch(now)

    per_client = {cid: (sum(ls) / len(ls) if ls else 0.0)
                  for cid, ls in latencies.items()}
    tokens_total = sum(c.n_tokens * c.n_iterations for c in clients)
    return SimResult(
        makespan=now,
        per_client_latency=per_client,
        avg_batch_size=(sum(batch_sizes) / len(batch_sizes)
                        if batch_sizes else 0.0),
        total_tokens=tokens_total,
        throughput=tokens_total / max(now, 1e-9),
        n_executions=n_exec,
    )
