"""Synthetic LM data of the port (the JAX package's ``data/``)."""
from repro_torch.data.pipeline import SyntheticLMData

__all__ = ["SyntheticLMData"]
