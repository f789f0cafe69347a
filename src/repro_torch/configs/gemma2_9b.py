"""gemma2-9b [dense] — local/global alternating attention + logit softcaps
[arXiv:2408.00118].

42L, d_model=3584, 16 heads (GQA kv=8, head_dim=256), d_ff=14336, vocab=256000.
Sliding window 4096 on even (local) layers; attn softcap 50, final softcap 30;
post-sub-block RMSNorms; embeddings scaled by sqrt(d); tied embeddings.

long_500k runs via the ``long_context`` beyond-paper variant (all layers
sliding-window — see DESIGN.md §4): use ``LONG_CONTEXT`` below.
"""

import dataclasses

from repro_torch.core import Family, ModelConfig, register

FULL = ModelConfig(
    arch_id="gemma2-9b",
    family=Family.DENSE,
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4096,
    local_global_alternating=True,
    post_norm=True,
    scale_embed=True,
    tie_embeddings=True,
    source="arXiv:2408.00118",
)

LONG_CONTEXT = dataclasses.replace(FULL, long_context=True)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, sliding_window=8)


register(FULL, smoke)
