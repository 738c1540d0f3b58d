"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed experts, top-6,
first layer dense. [arXiv:2401.06066] 28L d_model=2048 16H(kv=16)
d_expert=1408 vocab=102400. long_500k skipped (full attention)."""
from repro_torch.config import ModelConfig, MOE

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    arch=MOE,
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,          # MHA (kv=16)
    d_ff=1408,              # per-expert hidden (fine-grained)
    d_expert=1408,
    vocab=102_400,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    first_dense_layers=1,   # layer 0 uses a dense FFN (paper-faithful)
    moe_every=1,
    source="arXiv:2401.06066 (DeepSeekMoE: fine-grained + shared experts)",
)
