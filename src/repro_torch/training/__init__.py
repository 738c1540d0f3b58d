from repro_torch.training.engine import (BankKey, FinetuneEngine,
                                         job_activation_bytes,
                                         job_charge_bytes, job_hbm_bytes,
                                         job_working_bytes)
from repro_torch.training.job import FinetuneJob, JobResult, make_job_stream
from repro_torch.training.service import SymbiosisEngine

__all__ = ["BankKey", "FinetuneEngine", "FinetuneJob", "JobResult",
           "SymbiosisEngine", "job_activation_bytes", "job_charge_bytes",
           "job_hbm_bytes", "job_working_bytes", "make_job_stream"]
