"""olmoe-1b-7b [moe] — 64 experts, top-8 routing [arXiv:2409.02060].

16L, d_model=2048, 16 heads (kv=16), per-expert d_ff=1024, vocab=50304.
1B active / 7B total parameters.
"""

from repro_torch.core import Family, ModelConfig, MoEConfig, register

FULL = ModelConfig(
    arch_id="olmoe-1b-7b",
    family=Family.MOE,
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    rope_theta=1e4,
    moe=MoEConfig(num_experts=64, top_k=8, d_expert=1024),
    source="arXiv:2409.02060",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab=512, moe=MoEConfig(num_experts=4, top_k=2, d_expert=64))


register(FULL, smoke)
