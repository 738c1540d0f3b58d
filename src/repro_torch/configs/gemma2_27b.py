"""gemma2-27b — the paper's largest eval model (Table 3: 56 GB, 46 layers,
sharded-remote config in Fig 17). Dense, GQA (32H/16KV), wide FFN.
[paper Table 3 / hf:google/gemma-2-27b] Not in the assigned pool — included
to mirror the paper's own eval set (logit softcapping omitted; noted)."""
from repro_torch.config import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="gemma2-27b",
    arch=DENSE,
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256_128,
    sliding_window=4096,     # gemma2 alternates local/global; modeled as SWA
    source="paper Table 3 (Gemma2-27B; Fig 17 sharded-remote eval)",
)
