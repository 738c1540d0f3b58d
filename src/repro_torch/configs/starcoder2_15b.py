"""starcoder2-15b — paper Table 3 eval model (60 GB fp32 in the paper's
remote-execution experiment, §4.2.2). Dense, GQA (48H/4KV).
[paper Table 3 / hf:bigcode/starcoder2-15b] Not in the assigned pool."""
from repro_torch.config import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="starcoder2-15b",
    arch=DENSE,
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49_152,
    sliding_window=4096,
    source="paper Table 3 (Starcoder2-15B; remote-execution eval §4.2.2)",
)
