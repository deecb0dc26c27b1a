from repro_torch.serve.engine import GenerationResult, ServeEngine

__all__ = ["GenerationResult", "ServeEngine"]
