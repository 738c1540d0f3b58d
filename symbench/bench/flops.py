"""FLOP and byte arithmetic of the benchmark, and its table of peaks.

Counts are the work the model needs, not what a kernel happens to do:
a matrix product of an [n, din] input with a [din, dout] weight is
2 * n * din * dout operations; causal attention over S positions is
4 * H * hd * S * (S + 1) / 2 per layer (scores and the weighted sum, the
causal half only); a decode token at context c attends to c keys. An MoE
layer counts its router, its ``num_experts_per_tok`` routed experts and its
shared experts per token, not the drop-free capacity buffers the program
may compute over. Padding rows and padded positions are never counted.
Fine-tuning counts the forward and the backward's input gradients of the
frozen base (no weight gradient is asked of it), the LoRA products' forward,
input and weight gradients, and no recomputation.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

from bench import manifest

# Published dense peaks by ``torch.cuda.get_device_name()``: NVIDIA's H100 SXM
# data sheet, bf16 tensor cores without sparsity, HBM3 bandwidth.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 989e12, "bytes_per_s": 3.35e12,
                              "memory_bytes": 80e9},
}


def peaks(kind: str):
    """The peaks of a card, or None for a card the table lacks."""
    return PEAKS.get(kind)


def dims(arch: dict) -> SimpleNamespace:
    """The sizes of a configuration file's model (Hugging Face key names)."""
    d = arch["hidden_size"]
    H = arch["num_attention_heads"]
    return SimpleNamespace(
        d=d, L=arch["num_hidden_layers"], H=H,
        K=arch["num_key_value_heads"], hd=arch.get("head_dim", d // H),
        V=arch["vocab_size"], dff=arch["intermediate_size"],
        E=arch.get("n_routed_experts", 0),
        topk=arch.get("num_experts_per_tok", 0),
        n_shared=arch.get("n_shared_experts", 0),
        de=arch.get("moe_intermediate_size", 0),
        n_dense=arch.get("first_k_dense_replace", 0),
        tied=arch.get("tie_word_embeddings", False),
        family=manifest.family(arch))


def layer_matmul_params(m, layer: int) -> int:
    """Weights one token multiplies in ``layer``: attention's and the
    family's feed-forward's (routed experts: top-k)."""
    attn = m.d * m.H * m.hd + 2 * m.d * m.K * m.hd + m.H * m.hd * m.d
    return attn + m.family.ffn_matmul_params(m, layer)


def base_flops_per_token(m) -> float:
    """Forward matrix products of every layer for one token (no head)."""
    return 2.0 * sum(layer_matmul_params(m, i) for i in range(m.L))


def head_flops(m) -> float:
    """The output head for one row of logits."""
    return 2.0 * m.d * m.V


def lora_flops_per_token(m, targets, rank: int) -> float:
    """Forward LoRA products of one token: x @ A then @ B on each target;
    a ``router`` target acts on the family's routed layers only."""
    io = {"q": (m.d, m.H * m.hd), "k": (m.d, m.K * m.hd),
          "v": (m.d, m.K * m.hd), "o": (m.H * m.hd, m.d),
          "gate": (m.d, m.dff), "up": (m.d, m.dff), "down": (m.dff, m.d),
          "router": (m.d, m.E)}
    total = 0.0
    for t in targets:
        din, dout = io[t]
        layers = m.family.router_layers(m) if t == "router" else m.L
        total += layers * 2.0 * rank * (din + dout)
    return total


def attn_prefill_flops(m, S: int, start: int = 0) -> float:
    """Causal attention of S new positions after ``start`` cached ones."""
    keys = S * start + S * (S + 1) / 2
    return m.L * 4.0 * m.H * m.hd * keys


def attn_decode_flops(m, ctx: int) -> float:
    """One decode token attending to ``ctx`` keys (itself included)."""
    return m.L * 4.0 * m.H * m.hd * ctx


def prefill_flops(m, S: int, lora=()) -> float:
    """A prompt of S tokens: every layer over every token, logits at its
    last position. ``lora`` is ((targets, rank), ...) of the row's bank."""
    f = S * base_flops_per_token(m) + head_flops(m) + attn_prefill_flops(m, S)
    for targets, rank in lora:
        f += S * lora_flops_per_token(m, targets, rank)
    return f


def decode_flops(m, ctx: int, lora=()) -> float:
    f = base_flops_per_token(m) + head_flops(m) + attn_decode_flops(m, ctx)
    for targets, rank in lora:
        f += lora_flops_per_token(m, targets, rank)
    return f


def train_step_flops(m, batch: int, seq: int, targets, rank: int) -> float:
    """One optimizer step of one job on ``batch`` sequences of ``seq``
    tokens: base and head forward plus input gradients (2x the forward),
    LoRA forward, input and weight gradients (3x), attention forward and
    backward (3x)."""
    n = batch * seq
    base = n * (base_flops_per_token(m) + head_flops(m))
    lora = n * lora_flops_per_token(m, targets, rank)
    attn = batch * attn_prefill_flops(m, seq)
    return 2.0 * base + 3.0 * lora + 3.0 * attn


def decode_attn_bytes(m, ctx: int, page_block: int, elem: int = 2) -> float:
    """What one row's paged decode attention needs per layer: the K and V
    of its ``ctx`` live keys, q and out, and its block-table entries."""
    kv = 2 * ctx * m.K * m.hd * elem
    qo = 2 * m.H * m.hd * elem
    return kv + qo + 4 * math.ceil(ctx / page_block)


def decode_attn_layer_flops(m, ctx: int) -> float:
    return 4.0 * m.H * m.hd * ctx


def bound_s(nbytes: float, flops: float, pk: dict) -> float:
    """The least time for the work: bytes over the HBM rate or operations
    over the bf16 peak, whichever is larger."""
    return max(nbytes / pk["bytes_per_s"], flops / pk["flops"])
