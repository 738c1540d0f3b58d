"""SymbiosisEngine: inference and fine-tuning time-sharing ONE frozen base
(``repro.training.service``).

A provider keeps a single resident copy of the base and multiplexes it
between a ``ServingEngine`` (continuous-batching decode over LoRA, IA3 and
prefix clients) and a ``FinetuneEngine`` (fine-tuning as a service over
jobs of the same three methods) instead
of deploying one model replica per workload (paper §4.4). This wrapper
interleaves the two engines' ticks on one device and one stream, one after
the other: training never calls the paged decode kernels, so their
per-device workspace is never shared across streams. Because the base is
frozen and each engine owns its client-side state, interleaving changes
WHEN work runs, never its math: every request's stream and every job's
trajectory equal each engine's alone. ``checkpoint`` writes both engines'
snapshots (``engine_state``) as one CRC-framed blob; ``restore`` loads the
newest valid one into freshly built engines, which resume every tenant bit
for bit (a corrupt newer blob is skipped: last good wins). With one ``Obs``
shared by both engines (``from_spec(obs=)``) their spans, metrics and
events land in one registry and one event log, labelled ``serving`` and
``finetune``; ``drain_events`` merges the feeds in sequence order.
"""
from __future__ import annotations

import re
from typing import Optional

from repro_torch.checkpoint import load_engine_state, save_engine_state
from repro_torch.common.tree import tree_leaves
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.router import AdmissionStall
from repro_torch.training.engine import FinetuneEngine
from repro_torch.training.job import FinetuneJob


class SymbiosisEngine:
    """Tick-interleaves a serving engine and a fine-tuning engine that hold
    the SAME base tensors (checked leaf by leaf at construction: a copy
    would double the base's memory and defeat the point)."""

    def __init__(self, serving: Optional[ServingEngine] = None,
                 finetune: Optional[FinetuneEngine] = None):
        if serving is None and finetune is None:
            raise ValueError("need at least one of serving / finetune")
        if serving is not None and finetune is not None:
            s_leaves = tree_leaves(serving.base)
            f_leaves = tree_leaves(finetune.base)
            if len(s_leaves) != len(f_leaves) or any(
                    a is not b for a, b in zip(s_leaves, f_leaves)):
                raise ValueError(
                    "serving and finetune engines must share ONE frozen "
                    "base (identical tensors, not copies)")
        self.serving = serving
        self.finetune = finetune
        self.stats = {"ticks": 0, "decode_ticks": 0, "train_ticks": 0,
                      "admission_stalls": 0}

    @classmethod
    def from_spec(cls, spec: EngineSpec, base_params, *, serving_banks=None,
                  router=None, device="cuda", policy: Optional[str] = None,
                  health_policy=None, fault_hook=None, obs=None,
                  **serving_kw):
        """Build the service from ONE ``EngineSpec``: a ``ServingEngine``
        when ``spec.serve`` is set (over ``serving_banks``, one
        client-stacked adapter tree per spec bank), a ``FinetuneEngine``
        when ``spec.finetune`` is set, both over the same base tensors and,
        when given, one shared ``router``. ``health_policy`` and
        ``fault_hook`` go to both engines (the hook tells them apart by its
        point, ``"serve_admit"`` or ``"train_admit"``). One ``obs`` is
        shared by both engines."""
        serving = None
        if spec.serve is not None:
            if serving_banks is None:
                raise ValueError("spec.serve is set: pass serving_banks= "
                                 "(one adapter tree per spec bank)")
            serving = ServingEngine(spec, base_params, serving_banks,
                                    router=router, device=device,
                                    policy=policy,
                                    health_policy=health_policy,
                                    fault_hook=fault_hook, obs=obs,
                                    **serving_kw)
        finetune = None
        if spec.finetune is not None:
            finetune = FinetuneEngine(spec, base_params, router=router,
                                      device=device,
                                      health_policy=health_policy,
                                      fault_hook=fault_hook, obs=obs)
        return cls(serving=serving, finetune=finetune)

    # ------------------------------------------------------------------
    def submit(self, item):
        """Route a ``Request`` to serving, a ``FinetuneJob`` to training."""
        if isinstance(item, Request):
            if self.serving is None:
                raise ValueError("no serving engine attached")
            self.serving.submit(item)
        elif isinstance(item, FinetuneJob):
            if self.finetune is None:
                raise ValueError("no finetune engine attached")
            self.finetune.submit(item)
        else:
            raise TypeError(f"cannot route {type(item).__name__}")

    def tick(self) -> bool:
        """One service tick: a serving tick (if serving work exists), then
        a train tick (if jobs exist). Returns True while either engine
        still has work.

        Each engine's own stuck detection (``AdmissionStall``: "can never
        be admitted") assumes nothing outside it will ever free capacity.
        Under a SHARED PlacementRouter a queued request may be waiting on
        memory a job holds (or the other way round), so a stall in one
        engine is fatal only when the OTHER engine holds nothing that could
        free. Every other error, a failed kernel launch or an out-of-memory
        error among them, propagates."""
        did = False
        if self.serving is not None and self.serving.pending():
            try:
                self.serving.service_tick()
                self.stats["decode_ticks"] += 1
                did = True
            except AdmissionStall:
                if not (self.finetune is not None and self.finetune.n_active):
                    raise          # nothing training-side will ever free
                self.stats["admission_stalls"] += 1
        if self.finetune is not None and self.finetune.pending():
            try:
                self.finetune.train_tick()
                self.stats["train_ticks"] += 1
                did = True
            except AdmissionStall:
                if not (self.serving is not None and self.serving.n_inflight):
                    raise          # nothing serving-side will ever free
                self.stats["admission_stalls"] += 1
        if did:
            self.stats["ticks"] += 1
        return did

    def drain_events(self, *, client=None, kind=None) -> list:
        """Both engines' client-visible events, merged in sequence order.
        An ``Obs`` the engines share is drained once; distinct ones are
        each drained and the results merged."""
        seen, out = set(), []
        for eng in (self.serving, self.finetune):
            obs = getattr(eng, "_obs", None)
            if obs is None or id(obs) in seen:
                continue
            seen.add(id(obs))
            if client is None:
                out.extend(obs.drain_events(kind=kind))
            else:
                out.extend(obs.drain_events(client=client, kind=kind))
        out.sort(key=lambda e: e.seq)
        return out

    def run(self):
        """Drive both workloads to completion against the shared base.
        Returns (finished Requests, finished FinetuneJobs)."""
        while self.tick():
            pass
        done_reqs = self.serving.drain_done() if self.serving else []
        done_jobs = []
        if self.finetune is not None:
            done_jobs, self.finetune.finished = self.finetune.finished, []
        return done_reqs, done_jobs

    # ------------------------------------------------------------------
    # crash recovery
    # ------------------------------------------------------------------
    def checkpoint(self, directory) -> int:
        """Write both engines' snapshots and the wrapper's stats as one
        CRC-framed blob (``checkpoint.save_engine_state``, atomic); returns
        its sequence number. ``restore`` into freshly built engines resumes
        every tenant bit for bit."""
        state = {
            "serving": (None if self.serving is None
                        else self.serving.engine_state()),
            "finetune": (None if self.finetune is None
                         else self.finetune.engine_state()),
            "stats": dict(self.stats),
        }
        path = save_engine_state(directory, state)
        return int(re.search(r"engine_(\d+)\.ckpt$", path).group(1))

    def restore(self, directory) -> int:
        """Load the newest VALID snapshot in ``directory`` (corrupt blobs
        are skipped: last good wins) into this freshly built service;
        returns the sequence number restored."""
        seq, state = load_engine_state(directory)
        if state["serving"] is not None:
            if self.serving is None:
                raise RuntimeError("the snapshot holds serving state but no "
                                   "serving engine is attached")
            self.serving.load_engine_state(state["serving"])
        if state["finetune"] is not None:
            if self.finetune is None:
                raise RuntimeError("the snapshot holds fine-tuning state but "
                                   "no finetune engine is attached")
            self.finetune.load_engine_state(state["finetune"])
        self.stats.update(state["stats"])
        return seq
