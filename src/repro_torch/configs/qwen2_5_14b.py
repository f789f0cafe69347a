"""qwen2.5-14b [dense] — GQA + QKV bias [hf:Qwen/Qwen2.5-0.5B arch family].

48L, d_model=5120, 40 heads (GQA kv=8, head_dim=128), d_ff=13824, vocab=152064.
"""

from repro_torch.core import Family, ModelConfig, register

FULL = ModelConfig(
    arch_id="qwen2.5-14b",
    family=Family.DENSE,
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=512)


register(FULL, smoke)
