"""Host-side data: synthetic MODIS-like masks and scenes, the tile
pipeline, and the synthetic LM token stream (NumPy, apart from the
pipeline's engine calls)."""

from repro_torch.data import modis, pipeline, scenes, synthetic

__all__ = ["modis", "pipeline", "scenes", "synthetic"]
