"""Model registry: uniform interface over the families the port serves."""
from __future__ import annotations

from types import SimpleNamespace

from repro_torch.config import ModelConfig, check_family
from repro_torch.models import transformer


def get_model(cfg: ModelConfig):
    """Namespace with init_params / init_cache / forward / prefill /
    decode_step, all taking ``cfg`` pre-bound. The dense, MoE and VLM
    families share ``models.transformer`` (as in JAX); the recurrent,
    hybrid and encoder-decoder families are not ported yet."""
    check_family(cfg)

    def bind(fn_name):
        fn = getattr(transformer, fn_name)
        return lambda *a, **kw: fn(cfg, *a, **kw)

    return SimpleNamespace(
        cfg=cfg,
        init_params=bind("init_params"),
        init_cache=bind("init_cache"),
        forward=bind("forward"),
        prefill=bind("prefill"),
        decode_step=bind("decode_step"),
    )
