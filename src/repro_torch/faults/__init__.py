from repro_torch.faults.health import (FatalFault, HealthPolicy, HealthRecord,
                                       HealthState, TransientFault, classify)
from repro_torch.faults.plan import NonFiniteFault, StreamExhausted

__all__ = ["FatalFault", "HealthPolicy", "HealthRecord", "HealthState",
           "NonFiniteFault", "StreamExhausted", "TransientFault", "classify"]
