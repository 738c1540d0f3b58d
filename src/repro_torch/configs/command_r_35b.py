"""command-r-35b — dense, GQA (64H/8KV), no-bias.
[hf:CohereForAI/c4ai-command-r-v01] 40L d_model=8192 d_ff=22528 vocab=256000.
long_500k skipped (full attention; see DESIGN.md §6)."""
from repro_torch.config import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="command-r-35b",
    arch=DENSE,
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256_000,
    source="hf:CohereForAI/c4ai-command-r-v01 (GQA, no-bias)",
)
