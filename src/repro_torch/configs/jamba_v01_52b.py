"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
every 2nd layer. [arXiv:2403.19887] 32L d_model=4096 32H(kv=8) d_ff=14336
vocab=65536. About 51.6 B params: 103 GB in bf16, more than one 80 GB
card holds, so the card serves it cut in depth (whole 8-layer periods)."""
from repro_torch.config import ModelConfig, HYBRID

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch=HYBRID,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    n_experts=16,
    top_k=2,
    moe_every=2,            # MoE FFN every 2nd sublayer...
    moe_offset=1,           # ...on odd positions within the period
    attn_every=8,           # attention on sublayer 7 of each 8-layer period
    d_state=16,
    d_conv=4,
    mamba_expand=2,
    source="arXiv:2403.19887 (Jamba: 1:7 attn:mamba, MoE every 2)",
)
