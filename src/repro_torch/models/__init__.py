"""Model families (so far: the dense, MoE and VLM decoders)."""

from .families import Model, build_model

__all__ = ["Model", "build_model"]
