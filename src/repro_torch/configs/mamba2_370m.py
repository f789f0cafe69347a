"""mamba2-370m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060].

48L, d_model=1024, ssm_state=128, vocab=50280. Sub-quadratic: runs long_500k.
"""

from repro_torch.core import Family, ModelConfig, SSMConfig, register

FULL = ModelConfig(
    arch_id="mamba2-370m",
    family=Family.SSM,
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1),
    source="arXiv:2405.21060",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, n_layers=2, d_model=128, vocab=512,
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, n_groups=1))


register(FULL, smoke)
