"""llava-next-mistral-7b — VLM: Mistral-7B dense backbone consuming anyres
patch embeddings from a STUBBED ViT/projector frontend.
[hf:llava-hf/llava-v1.6-mistral-7b-hf] 32L d_model=4096 32H(kv=8) d_ff=14336
vocab=32000; 2880 image tokens (anyres 2x2 grid + base, 576 each).
long_500k skipped (full attention)."""
from repro_torch.config import ModelConfig, VLM

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    arch=VLM,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32_000,
    n_frontend_tokens=2880,  # anyres: 5 tiles x 576 patches (stubbed ViT)
    sliding_window=4096,     # Mistral-style SWA
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (anyres tiling, stub ViT)",
)
