"""stablelm-12b — dense, GQA (32H/8KV).
[hf:stabilityai/stablelm-2-1_6b family] 40L d_model=5120 d_ff=13824 vocab=100352.
long_500k skipped (full attention)."""
from repro_torch.config import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="stablelm-12b",
    arch=DENSE,
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100_352,
    source="hf:stabilityai/stablelm-2-1_6b (scaled family member)",
)
