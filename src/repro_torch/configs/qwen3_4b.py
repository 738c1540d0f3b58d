"""qwen3-4b — dense, GQA (32H/8KV), qk-norm, head_dim=128.
[hf:Qwen/Qwen3-8B family] 36L d_model=2560 d_ff=9728 vocab=151936.
long_500k skipped (full attention)."""
from repro_torch.config import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="qwen3-4b",
    arch=DENSE,
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,           # decoupled head dim (Qwen3)
    d_ff=9728,
    vocab=151_936,
    qk_norm=True,
    source="hf:Qwen/Qwen3-8B (qk_norm, GQA; 4B sibling config)",
)
