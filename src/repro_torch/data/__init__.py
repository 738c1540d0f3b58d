from repro_torch.data.pipeline import (ClientBatchStream, SyntheticLMDataset,
                                       make_client_batches)

__all__ = ["ClientBatchStream", "SyntheticLMDataset", "make_client_batches"]
