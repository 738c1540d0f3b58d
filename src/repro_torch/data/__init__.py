from repro_torch.data.pipeline import (ClientBatchStream, SyntheticLMDataset,
                                       frontend_stub, make_client_batches)

__all__ = ["ClientBatchStream", "SyntheticLMDataset", "frontend_stub",
           "make_client_batches"]
