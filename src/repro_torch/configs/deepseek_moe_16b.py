"""deepseek-moe-16b [moe] — fine-grained experts, 2 shared + 64 routed top-6
[arXiv:2401.06066].

28L, d_model=2048, 16 heads (kv=16), per-expert d_ff=1408, vocab=102400.
"""

from repro_torch.core import Family, ModelConfig, MoEConfig, register

FULL = ModelConfig(
    arch_id="deepseek-moe-16b",
    family=Family.MOE,
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    rope_theta=1e4,
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared_experts=2),
    source="arXiv:2401.06066",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64, num_shared_experts=1))


register(FULL, smoke)
