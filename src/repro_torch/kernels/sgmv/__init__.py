from repro_torch.kernels.sgmv.ops import sgmv
from repro_torch.kernels.sgmv.ref import sgmv_ref
from repro_torch.kernels.sgmv.sgmv import sgmv_cuda, sgmv_plain

__all__ = ["sgmv", "sgmv_ref", "sgmv_cuda", "sgmv_plain"]
