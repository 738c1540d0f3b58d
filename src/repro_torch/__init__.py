"""Symbiosis in PyTorch for NVIDIA Hopper: paged multi-tenant LoRA serving.

A port of the JAX package ``repro`` (which stays the reference). Module
paths mirror ``src/repro/`` so each counterpart is easy to find. The port
imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of
``repro``. Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Asking for CUDA without a card
    raises: the port never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
