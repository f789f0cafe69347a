"""pixtral-12b [vlm] — Pixtral-ViT frontend (stub) + Mistral-Nemo decoder.

[hf:mistralai/Pixtral-12B-2409]: 40L, d_model=5120, 32 heads (GQA kv=8,
head_dim=128), d_ff=14336, vocab=131072. The vision encoder is a STUB per the
assignment carve-out: ``input_specs`` supplies precomputed patch embeddings
(B, 256, 5120) and their scatter positions.
"""

from repro_torch.core import Family, ModelConfig, register

FULL = ModelConfig(
    arch_id="pixtral-12b",
    family=Family.VLM,
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1e6,
    vision_tokens=256,
    source="hf:mistralai/Pixtral-12B-2409",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, vision_tokens=4)


register(FULL, smoke)
