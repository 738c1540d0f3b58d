"""The Symbiosis split-execution core in PyTorch (``repro.core``'s port).

frozen_linear — frozen base linears (forward)
virtlayer     — client-side splice (VirtLayer analogue, §3.2)
adapters      — LoRA banks through the SGMV kernel
packing       — token-budget ragged packing (§3.7)
scheduler     — opportunistic batching policies (§3.7)
base_executor — host-level packed frozen-layer service (§3.2, §3.7)
engine_spec   — declarative EngineSpec/BankSpec engine construction
symbiosis     — multi-client serve step composition
"""
from repro_torch.core import packing
from repro_torch.core.base_executor import BaseExecutor, calibrate_layer_cost

__all__ = ["BaseExecutor", "calibrate_layer_cost", "packing"]
