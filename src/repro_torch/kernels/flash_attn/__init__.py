from repro_torch.kernels.flash_attn.flash_attn import (
    flash_attn_cuda, flash_attn_plain)
from repro_torch.kernels.flash_attn.ops import flash_attn
from repro_torch.kernels.flash_attn.ref import flash_attn_ref

__all__ = ["flash_attn", "flash_attn_cuda", "flash_attn_plain",
           "flash_attn_ref"]
