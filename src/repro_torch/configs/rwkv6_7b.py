"""rwkv6-7b — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892] 32L d_model=4096 d_ff=14336 vocab=65536, head size 64.
About 7.5 B params: 15 GB in bf16, so one card holds its full depth. The
decode state is O(1) in the sequence: 1 MiB of fp32 wkv state per layer
and two token-shift rows."""
from repro_torch.config import ModelConfig, RWKV

CONFIG = ModelConfig(
    name="rwkv6-7b",
    arch=RWKV,
    n_layers=32,
    d_model=4096,
    n_heads=64,           # d_model / head_size(64)
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab=65536,
    source="arXiv:2404.05892 (RWKV6 'Finch', data-dependent decay)",
)
