"""Model families: the dense, MoE and VLM decoders, the Mamba2 SSM, the zamba2
hybrid and the whisper encoder-decoder."""

from .families import EncDecModel, HybridModel, Model, SSMModel, build_model

__all__ = ["EncDecModel", "HybridModel", "Model", "SSMModel", "build_model"]
