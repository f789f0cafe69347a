"""Model families (so far: the dense, MoE and VLM decoders, the Mamba2 SSM and
the zamba2 hybrid)."""

from .families import HybridModel, Model, SSMModel, build_model

__all__ = ["HybridModel", "Model", "SSMModel", "build_model"]
