"""arctic-480b — 128-expert top-2 MoE with a dense residual MLP in parallel.
[hf:Snowflake/snowflake-arctic-base] 35L d_model=7168 56H(kv=8)
d_expert=4864 vocab=32000. Largest assigned config; stresses
expert-parallel sharding + compile-time memory fit.
long_500k skipped (full attention)."""
from repro_torch.config import ModelConfig, MOE

CONFIG = ModelConfig(
    name="arctic-480b",
    arch=MOE,
    n_layers=35,
    d_model=7168,
    n_heads=56,
    head_pad=8,             # §Perf it5: zero-weight pad 56->64 q-heads so
                            # attention shards 16-way (exact; see DESIGN.md)
    n_kv_heads=8,
    d_ff=4864,
    d_expert=4864,
    vocab=32_000,
    n_experts=128,
    top_k=2,
    dense_residual=True,    # Arctic: dense MLP in parallel with the MoE FFN
    moe_every=1,
    source="hf:Snowflake/snowflake-arctic-base (dense-MoE hybrid residual)",
)
