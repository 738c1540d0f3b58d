"""Configuration dataclasses of the PyTorch port: model / adapter / train /
fine-tuning / serve.

A copy of the JAX package's ``repro.config`` limited to what the port's
serving paths and its fine-tuning service (the dense, MoE, VLM, hybrid,
RWKV and encoder-decoder families; LoRA, IA3 and prefix banks) read. The port keeps its own
copy so that it imports nothing of the JAX package; the fields it keeps
have the same names and defaults, so a config describes the same model in
both.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence


# Architecture families. The port runs every family's model, serving
# steps and fine-tuning; the encoder-decoder family's requests are refused
# by the serving engine, whose requests carry tokens only (``check_family``
# with ``frameless=``).
DENSE = "dense"
MOE = "moe"
VLM = "vlm"        # LLaVA backbone (dense + patch-embedding frontend stub)
HYBRID = "hybrid"  # Jamba: Mamba + attention interleave + MoE
RWKV = "rwkv"      # attention-free, data-dependent decay (RWKV6)
ENCDEC = "encdec"  # Whisper backbone (audio frontend stubbed: frames)
FAMILIES = (DENSE, MOE, VLM, HYBRID, RWKV, ENCDEC)
TRAIN_FAMILIES = (DENSE, MOE, VLM, HYBRID, RWKV, ENCDEC)


def check_family(cfg: "ModelConfig", families=FAMILIES, what="serves", *,
                 frameless: str = ""):
    """Refuse ``cfg`` unless its family is one of ``families``, which the
    port ``what`` (serves, fine-tunes). ``frameless`` names a caller that
    hands the model tokens only (the serving engine's ``submit``, the
    per-client prefill, the serve CLI): an encoder-decoder
    model needs its ``frames`` there, and JAX's engine passes none (its
    prefill raises ``KeyError: 'frames'``), so the port refuses the call
    before it changes any state."""
    if cfg.arch not in families:
        raise ValueError(f"{cfg.name} is of the {cfg.arch!r} family: not "
                         f"ported yet; the port {what} the "
                         f"{'/'.join(families)} families")
    if frameless and cfg.arch == ENCDEC:
        raise ValueError(f"{frameless} refuses {cfg.name}: an 'encdec' "
                         "prefill needs frames, and JAX's serving engine "
                         "passes no frames (tokens only: its prefill raises "
                         "KeyError: 'frames')")


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
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0                 # per-expert hidden dim; 0 -> d_ff
    moe_every: int = 1                # MoE FFN where layer % moe_every == moe_offset
    moe_offset: int = 0
    first_dense_layers: int = 0       # DeepSeek-MoE: first layer(s) dense
    dense_residual: bool = False      # Arctic: dense FFN in parallel with MoE
    # --- Hybrid (Jamba) ---
    attn_every: int = 0               # attention on layers where (layer+1) % attn_every == 0
    d_state: int = 16                 # Mamba state dim
    d_conv: int = 4
    mamba_expand: int = 2
    # --- Encoder-decoder (Whisper) ---
    n_enc_layers: int = 0
    n_frontend_tokens: int = 0        # encoder frames (audio) / image patch
                                      # tokens (VLM): stubbed frontends
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

    @property
    def ffn_hidden(self) -> int:
        return self.d_expert or self.d_ff

    def is_moe_layer(self, layer: int) -> bool:
        if self.n_experts == 0:
            return False
        return layer % self.moe_every == self.moe_offset

    def is_attn_layer(self, layer: int) -> bool:
        """Hybrid: whether decoder layer ``layer`` is attention (the others
        are Mamba); every layer of the other families is."""
        if self.arch != HYBRID:
            return True
        return (layer + 1) % self.attn_every == 0

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                n_experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke runs."""
        heads = max(1, min(self.n_heads, d_model // 64))
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        changes = dict(
            name=self.name + "-smoke", n_layers=n_layers,
            d_model=d_model, n_heads=heads, n_kv_heads=kv,
            head_dim=64 if self.head_dim else 0, d_ff=d_model * 3,
            vocab=vocab, dtype="float32", param_dtype="float32")
        if self.n_experts:
            changes.update(
                n_experts=min(self.n_experts, n_experts),
                top_k=min(self.top_k, 2),
                n_shared_experts=min(self.n_shared_experts, 1),
                d_expert=(d_model // 2) if self.d_expert else 0,
                moe_every=self.moe_every,
                moe_offset=min(self.moe_offset, n_layers - 1),
                first_dense_layers=min(self.first_dense_layers, 1))
        if self.arch == HYBRID:
            changes.update(attn_every=2, n_layers=max(n_layers, 2))
        if self.arch == ENCDEC:
            changes.update(n_enc_layers=n_layers, n_frontend_tokens=16)
        if self.arch == VLM:
            changes.update(n_frontend_tokens=16)
        return dataclasses.replace(self, **changes)


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
    * ``wait_fraction`` — the simulated opportunistic policy's wait, as a
      fraction of a request's cost (``ServingEngine.simulate_policy``).
    """
    n_clients: int = 8
    max_seq: int = 2048
    policy: str = "opportunistic"     # lockstep | nolockstep | opportunistic
    page_block: int = 0
    pool_pages: int = 0
    kv_quant: bool = False
    seed: int = 0
    wait_fraction: float = 0.1
