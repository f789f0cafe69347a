"""Model families (this slice: the dense and VLM decoders)."""

from .families import Model, build_model

__all__ = ["Model", "build_model"]
