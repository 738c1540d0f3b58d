from repro_torch.kernels.decode_attn.decode_attn import (
    decode_attn_cuda, decode_attn_plain, paged_decode_attn_cuda,
    paged_decode_attn_plain, paged_decode_attn_quant_cuda,
    paged_decode_attn_quant_plain)
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.kernels.decode_attn.ref import (
    decode_attn_ref, gather_paged_kv, paged_view)

__all__ = ["decode_attn", "decode_attn_cuda", "decode_attn_plain",
           "decode_attn_ref", "gather_paged_kv", "paged_view",
           "paged_decode_attn_cuda", "paged_decode_attn_plain",
           "paged_decode_attn_quant_cuda", "paged_decode_attn_quant_plain"]
