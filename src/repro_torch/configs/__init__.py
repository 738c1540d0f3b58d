"""Model configs served by the PyTorch port.

``get_config(arch_id)`` resolves the ``--arch`` CLI flag, as
``repro.configs.get_config`` does, over the families the port runs
(dense, MoE, VLM, hybrid, RWKV and encoder-decoder); every config cites its source in
``CONFIG.source``. arctic-480b (about 960 GB in bf16) fits no single card:
it is registered for its ``reduced()`` variant; jamba-v0.1-52b (about 103
GB in bf16) fits one card only cut in depth; rwkv6-7b (about 15 GB)
and whisper-small (about 0.6 GB) fit whole.
"""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

# arch-id -> module name (dense, MoE, VLM, hybrid, RWKV and enc-dec configs)
ARCHS = {
    "granite-3-8b": "granite_3_8b",
    "command-r-35b": "command_r_35b",
    "stablelm-12b": "stablelm_12b",
    "qwen3-4b": "qwen3_4b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "arctic-480b": "arctic_480b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "symbiosis-llama2-13b": "symbiosis_llama2_13b",
    "gemma2-27b": "gemma2_27b",
    "starcoder2-15b": "starcoder2_15b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "rwkv6-7b": "rwkv6_7b",
    "whisper-small": "whisper_small",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown or unported arch {arch_id!r}; the port "
                       f"serves: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch_id]}")
    return mod.CONFIG
