"""Fine-tuning jobs: the unit of admission of fine-tuning as a service
(``repro.training.job``).

A ``FinetuneJob`` is one tenant's fine-tuning request: its own PEFT
selection (``AdapterConfig``: LoRA of any rank, IA3 or prefix), its own
optimizer hyperparameters and warmup-cosine schedule, its own data stream
and grad-accum microbatching, and a step budget after which the engine
retires it and hands back its final state. Jobs join and leave the service
independently (paper §3, §5: many adapters fine-tuned at once against one
shared frozen base).

Resumption: a retired job's ``JobResult`` can seed a NEW job via
``init_adapter`` / ``init_opt`` / ``start_step``; the re-admitted job
continues the same optimizer trajectory (its schedule position and data
stream both key off the global step count). ``FinetuneEngine.engine_state``
pickles each job with its stream: ``make_job_stream``'s holds numpy state
and a ``torch.device`` only, and its batches depend on the step asked for
alone, so it pickles whole and resumes where the job stood.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

from repro_torch.common.tree import tree_map
from repro_torch.config import AdapterConfig, ModelConfig
from repro_torch.data import make_client_batches


@dataclasses.dataclass(eq=False)        # identity eq: engines key on id(job)
class FinetuneJob:
    """One fine-tuning tenant. ``data.batch(step) -> {tokens [B, S], labels
    [B, S], ...}`` must be deterministic in ``step`` for a resumed job to
    reproduce the original trajectory."""
    acfg: AdapterConfig
    data: Any                             # per-step batch stream (see above)
    batch_size: int
    seq_len: int
    steps: int = 10                       # optimizer-step budget (global count)
    lr: float = 1e-3
    weight_decay: float = 0.0
    warmup_steps: int = 0
    total_steps: int = 0                  # schedule horizon; 0 -> ``steps``
    max_grad_norm: float = 1.0            # 0 -> no clipping
    microbatch: int = 0                   # grad-accum factor (0/1 -> off)
    name: str = ""
    seed: int = 0                         # adapter init seed (fresh jobs)
    # --- resumption (all three or none) ---
    init_adapter: Any = None
    init_opt: Any = None
    start_step: int = 0
    # --- engine-filled ---
    losses: List[float] = dataclasses.field(default_factory=list)
    result: Optional["JobResult"] = None
    # lifecycle: queued | active | finished | finished_early | quarantined
    status: str = "queued"
    health: Optional[Any] = None          # faults.HealthRecord, engine-filled

    @property
    def schedule_total(self) -> int:
        return self.total_steps or self.steps


@dataclasses.dataclass
class JobResult:
    """A retired job's client-side state, as handed back by the service."""
    adapter: Any
    opt: Any
    step: int                             # optimizer steps completed (global)
    losses: List[float]


class _ClientSliceStream:
    """One client slice of a multi-client batch stream, leaves [B, ...]."""

    def __init__(self, stream):
        self._stream = stream

    def batch(self, step):
        return tree_map(lambda x: x[0], self._stream.batch(step))


def make_job_stream(cfg: ModelConfig, batch: int, seq_len: int, *,
                    seed: int = 0, device="cuda"):
    """Deterministic per-job data stream: one client slice of the synthetic
    Markov pipeline, leaves [B, ...] on ``device``."""
    return _ClientSliceStream(make_client_batches(cfg, 1, batch, seq_len,
                                                  seed=seed, device=device))
