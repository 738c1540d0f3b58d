from repro_torch.serving.engine import Request, SamplingParams, ServingEngine

__all__ = ["Request", "SamplingParams", "ServingEngine"]
