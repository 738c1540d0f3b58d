from repro_torch.checkpoint.ckpt import (CheckpointCorruptError,
                                         latest_step, load_engine_state,
                                         restore_checkpoint,
                                         restore_job_state, save_checkpoint,
                                         save_engine_state, save_job_state,
                                         set_write_fault_hook)

__all__ = ["CheckpointCorruptError", "latest_step", "load_engine_state",
           "restore_checkpoint", "restore_job_state", "save_checkpoint",
           "save_engine_state", "save_job_state", "set_write_fault_hook"]
