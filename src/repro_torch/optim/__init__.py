from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     adamw_update_hyper, clip_by_global_norm)
from repro_torch.optim.schedules import warmup_cosine

__all__ = ["AdamWState", "adamw_init", "adamw_update", "adamw_update_hyper",
           "clip_by_global_norm", "warmup_cosine"]
