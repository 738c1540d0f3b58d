"""whisper-small — encoder-decoder audio backbone (conv/mel frontend is a
STUB: the batch carries 1500 precomputed frame embeddings).
[arXiv:2212.04356] 12L enc + 12L dec, d_model=768 12H(kv=12, MHA) d_ff=3072
vocab=51865, GELU MLP with bias, learned positions (rope_theta=0)."""
from repro_torch.config import ENCDEC, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    arch=ENCDEC,
    n_layers=12,            # decoder layers
    n_enc_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,          # MHA
    d_ff=3072,
    vocab=51_865,
    n_frontend_tokens=1500,  # 30 s of audio at 50 frames/s (stubbed frontend)
    rope_theta=0.0,         # learned absolute positions, Whisper-faithful
    source="arXiv:2212.04356 (Whisper; enc-dec, conv frontend stubbed)",
)
