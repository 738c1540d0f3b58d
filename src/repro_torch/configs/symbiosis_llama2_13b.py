"""symbiosis-llama2-13b — the paper's own primary evaluation model
(Table 3: Llama2-13B, 26 GB, 40 layers). Used by the paper-table benchmarks;
not part of the assigned-architecture pool."""
from repro_torch.config import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="symbiosis-llama2-13b",
    arch=DENSE,
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,          # Llama2 is MHA
    d_ff=13824,
    vocab=32_000,
    source="paper Table 3 (Llama2-13B, the main Symbiosis eval model)",
)
