"""zamba2-1.2b [hybrid] — Mamba2 backbone + weight-shared attention blocks
[arXiv:2411.15242].

38L, d_model=2048, shared attention block (32 heads, kv=32, d_ff=8192) applied
every 6 Mamba2 layers; ssm_state=64. Sub-quadratic: runs long_500k.
"""

from repro_torch.core import Family, ModelConfig, SSMConfig, register

FULL = ModelConfig(
    arch_id="zamba2-1.2b",
    family=Family.HYBRID,
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=1),
    shared_attn_every=6,
    source="arXiv:2411.15242",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=512, shared_attn_every=2,
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, n_groups=1))


register(FULL, smoke)
