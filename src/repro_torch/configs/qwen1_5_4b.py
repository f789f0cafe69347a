"""qwen1.5-4b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B arch family].

40L, d_model=2560, 20 heads (kv=20, head_dim=128), d_ff=6912, vocab=151936.
"""

from repro_torch.core import Family, ModelConfig, register

FULL = ModelConfig(
    arch_id="qwen1.5-4b",
    family=Family.DENSE,
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-0.5B",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab=512)


register(FULL, smoke)
