from repro_torch.kernels.ragged_linear.ops import ragged_linear
from repro_torch.kernels.ragged_linear.ragged_linear import (
    ragged_linear_cuda, ragged_linear_plain)
from repro_torch.kernels.ragged_linear.ref import ragged_linear_ref

__all__ = ["ragged_linear", "ragged_linear_cuda", "ragged_linear_plain",
           "ragged_linear_ref"]
