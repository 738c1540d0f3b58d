"""Fault containment of the multi-tenant engines (``repro.faults``): the
per-tenant health state machine, deterministic fault injection and the
conservation audits."""
from repro_torch.faults.health import (FatalFault, HealthPolicy, HealthRecord,
                                       HealthState, TransientFault, classify)
from repro_torch.faults.plan import (KINDS, AllocationFault, AllocHook,
                                     CkptWriteFault, CkptWriteHook,
                                     FaultEvent, FaultPlan, FaultyRequestStream,
                                     FaultyStream, NonFiniteFault, StreamError,
                                     StreamExhausted, corrupt_flip,
                                     corrupt_truncate)
from repro_torch.faults.audit import (check_conservation,
                                      finetune_conservation,
                                      serving_conservation)

__all__ = ["KINDS", "AllocHook", "AllocationFault", "CkptWriteFault",
           "CkptWriteHook", "FatalFault", "FaultEvent", "FaultPlan",
           "FaultyRequestStream", "FaultyStream", "HealthPolicy",
           "HealthRecord", "HealthState", "NonFiniteFault", "StreamError",
           "StreamExhausted", "TransientFault", "check_conservation", "classify",
           "corrupt_flip", "corrupt_truncate", "finetune_conservation",
           "serving_conservation"]
