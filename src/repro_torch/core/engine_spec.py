"""Declarative engine construction: ``EngineSpec`` + ``BankSpec`` (the JAX
package's, without the device mesh).

    spec = EngineSpec(cfg=model_cfg,
                      banks=(BankSpec("lora8", lora_cfg, capacity=4),),
                      serve=ServeConfig(max_seq=512, page_block=16),
                      finetune=FinetuneConfig(max_jobs=8))
    engine = ServingEngine(spec, base, [bank])
    trainer = FinetuneEngine(spec, base)

A spec names at least one of ``serve=`` and ``finetune=``: a training-only
spec needs no serving config.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.config import (AdapterConfig, FinetuneConfig, ModelConfig,
                                ServeConfig)


@dataclasses.dataclass(frozen=True)
class BankSpec:
    """One named adapter bank: clients (serving) or job slots (training)
    sharing a PEFT method and rank."""

    name: str
    acfg: AdapterConfig
    capacity: int

    def __post_init__(self):
        if not self.name:
            raise ValueError("BankSpec needs a name")
        if self.capacity < 1:
            raise ValueError(f"bank {self.name!r}: capacity must be >= 1")


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Declarative description of one symbiotic deployment."""

    cfg: ModelConfig
    banks: Tuple[BankSpec, ...] = ()
    serve: Optional[ServeConfig] = None
    finetune: Optional[FinetuneConfig] = None
    max_batch_per_client: int = 4

    def __post_init__(self):
        object.__setattr__(self, "banks", tuple(self.banks))
        names = [b.name for b in self.banks]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate bank names: {names}")
        if self.max_batch_per_client < 1:
            raise ValueError("max_batch_per_client must be >= 1")
        if self.serve is None and self.finetune is None:
            raise ValueError("EngineSpec needs at least one of serve= / "
                             "finetune=")
