"""Configuration dataclasses of the PyTorch port: model / adapter / train /
fine-tuning / serve.

A copy of the JAX package's ``repro.config`` limited to what the port's
dense serving paths (LoRA, IA3 and prefix banks) and its fine-tuning
service (the same three methods) read. The port keeps its own copy so that
it imports nothing of the JAX package; the fields it keeps have the same
names and defaults, so a dense config describes the same model in both.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence


# Architecture family. The port serves the dense family only; a config of
# any other family is refused where a model or engine is built.
DENSE = "dense"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    head_pad: int = 0                 # extra zero-weight q-heads
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0           # 0 -> full attention
    # --- dtypes ---
    dtype: str = "bfloat16"           # activations
    param_dtype: str = "bfloat16"     # frozen base weights
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def hp(self) -> int:
        """Padded q-head count used by the attention implementation."""
        return self.n_heads + self.head_pad

    @property
    def q_per_kv(self) -> int:
        return self.hp // self.n_kv_heads

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                vocab: int = 512) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke runs (dense families)."""
        heads = max(1, min(self.n_heads, d_model // 64))
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        return dataclasses.replace(
            self, name=self.name + "-smoke", n_layers=n_layers,
            d_model=d_model, n_heads=heads, n_kv_heads=kv,
            head_dim=64 if self.head_dim else 0, d_ff=d_model * 3,
            vocab=vocab, dtype="float32", param_dtype="float32")


@dataclass(frozen=True)
class AdapterConfig:
    """A client's PEFT selection; serving and fine-tuning take all three
    methods. Frozen: the engines look a bank up by value
    (``ServingEngine.admit_bank``, ``FinetuneEngine``'s bank keys)."""
    method: str = "lora"              # lora | ia3 | prefix
    rank: int = 8                     # lora
    alpha: float = 16.0               # lora
    targets: Sequence[str] = ("q", "v")   # subset of q,k,v,o,gate,up,down
    n_prefix: int = 16                # prefix tuning: virtual tokens per layer


@dataclass(frozen=True)
class TrainConfig:
    """One trainer's knobs (``core.symbiosis.make_baseline_train_step``,
    ``make_multi_client_train_step``). JAX's ``n_clients`` and ``seed`` are
    left out: no step reads them (the client count is the batch's)."""
    microbatch: int = 0               # 0 -> no gradient accumulation
    lr: float = 1e-4
    weight_decay: float = 0.0
    warmup_steps: int = 10
    total_steps: int = 100
    max_grad_norm: float = 1.0
    remat: bool = True                # activation checkpointing of the layer body
    memory_optimized_backward: bool = True   # §3.6; False = torch-like baseline


@dataclass(frozen=True)
class FinetuneConfig:
    """Fine-tuning-as-a-service configuration (``training.FinetuneEngine``).

    * ``max_jobs`` — service-wide concurrent-job ceiling across all banks;
      a job that does not fit yet stays queued without blocking later ones.
    * ``memory_optimized`` — §3.6 frozen-base backward for every job; False
      runs the torch-like baseline, which holds every base linear's input
      for the backward.
    * ``remat`` — activation checkpointing of the layer body in every step.
    """
    max_jobs: int = 16
    memory_optimized: bool = True
    remat: bool = False


@dataclass(frozen=True)
class ServeConfig:
    """Serving-engine configuration (see ``repro.config.ServeConfig``).

    * ``page_block`` — tokens per KV page; 0 (the default, as in JAX) keeps
      the dense layout: one ``max_seq``-deep cache row per slot.
    * ``pool_pages`` — pages per client pool; 0 sizes the pool for full
      provisioning (``max_batch_per_client * ceil(max_seq/page_block)``).
    * ``kv_quant`` — int8 KV entries with per-head f32 scales.
    """
    n_clients: int = 8
    max_seq: int = 2048
    policy: str = "opportunistic"     # lockstep | nolockstep | opportunistic
    page_block: int = 0
    pool_pages: int = 0
    kv_quant: bool = False
    seed: int = 0
