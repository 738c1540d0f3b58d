"""granite-3-8b — dense, GQA (32H/8KV).
[hf:ibm-granite/granite-3.0-2b-base family] 40L d_model=4096 d_ff=12800
vocab=49155. long_500k skipped (full attention)."""
from repro_torch.config import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="granite-3-8b",
    arch=DENSE,
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49_155,
    source="hf:ibm-granite/granite-3.0-2b-base (8b sibling config)",
)
