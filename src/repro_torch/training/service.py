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
trajectory equal each engine's alone. ``checkpoint`` / ``restore`` wait
for the serving engine's half of crash recovery (its health records and
quarantines are not ported yet); the fine-tuning half's is
``FinetuneEngine.engine_state``.
"""
from __future__ import annotations

from typing import Optional

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
                  router=None, device="cuda",
                  **serving_kw):
        """Build the service from ONE ``EngineSpec``: a ``ServingEngine``
        when ``spec.serve`` is set (over ``serving_banks``, one
        client-stacked adapter tree per spec bank), a ``FinetuneEngine``
        when ``spec.finetune`` is set, both over the same base tensors and,
        when given, one shared ``router``."""
        serving = None
        if spec.serve is not None:
            if serving_banks is None:
                raise ValueError("spec.serve is set: pass serving_banks= "
                                 "(one adapter tree per spec bank)")
            serving = ServingEngine(spec, base_params, serving_banks,
                                    router=router, device=device, **serving_kw)
        finetune = None
        if spec.finetune is not None:
            finetune = FinetuneEngine(spec, base_params, router=router,
                                      device=device)
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
        """Both engines' client-visible events, merged. The engines emit
        events only with ``obs`` telemetry, which is not ported yet, so
        there are none."""
        return []

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
