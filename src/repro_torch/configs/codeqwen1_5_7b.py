"""codeqwen1.5-7b [dense] — qwen1.5 architecture [hf:Qwen/CodeQwen1.5-7B].

32L, d_model=4096, 32 heads (kv=32 — MHA-equal GQA), d_ff=13440, vocab=92416,
QKV bias.
"""

from repro_torch.core import Family, ModelConfig, register

FULL = ModelConfig(
    arch_id="codeqwen1.5-7b",
    family=Family.DENSE,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/CodeQwen1.5-7B",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
        vocab=512)


register(FULL, smoke)
