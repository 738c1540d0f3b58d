"""Model registry: uniform interface over the families the port serves."""
from __future__ import annotations

from types import SimpleNamespace

from repro_torch.config import ENCDEC, HYBRID, RWKV, ModelConfig, check_family
from repro_torch.models import encdec, hybrid, rwkv_model, transformer


def get_model(cfg: ModelConfig):
    """Namespace with init_params / init_cache / forward / prefill /
    decode_step, all taking ``cfg`` pre-bound. The dense, MoE and VLM
    families share ``models.transformer``, the hybrid has ``models.hybrid``,
    RWKV ``models.rwkv_model`` and the encoder-decoder family
    ``models.encdec`` (as in JAX)."""
    check_family(cfg)
    module = {HYBRID: hybrid, RWKV: rwkv_model,
              ENCDEC: encdec}.get(cfg.arch, transformer)

    def bind(fn_name):
        fn = getattr(module, fn_name)
        return lambda *a, **kw: fn(cfg, *a, **kw)

    return SimpleNamespace(
        cfg=cfg,
        init_params=bind("init_params"),
        init_cache=bind("init_cache"),
        forward=bind("forward"),
        prefill=bind("prefill"),
        decode_step=bind("decode_step"),
    )
