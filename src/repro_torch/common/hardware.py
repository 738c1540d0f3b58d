"""Hardware constants of the port's target card, for the analytic placement
and roofline models (the port's counterpart of ``repro.common.hardware``,
which describes a TPU; none of its values are used here)."""
from dataclasses import dataclass


@dataclass(frozen=True)
class Chip:
    name: str
    peak_flops_bf16: float          # FLOP/s, dense tensor-core peak
    hbm_bandwidth: float            # bytes/s
    hbm_bytes: float                # device memory


# NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 80 GB.
H100 = Chip(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    hbm_bandwidth=3.35e12,
    hbm_bytes=80e9,
)
