"""whisper-small [audio] — encoder-decoder, conv frontend stub [arXiv:2212.04356].

12L encoder + 12L decoder, d_model=768, 12 heads (kv=12), d_ff=3072,
vocab=51865, sinusoidal positions. The mel-spectrogram + conv feature extractor
is a STUB per the assignment carve-out: ``input_specs`` supplies precomputed
frame embeddings (B, 1500, 768).

Decode shapes run (decoder has a KV cache); long_500k skipped (full attention).
"""

from repro_torch.core import Family, ModelConfig, register

FULL = ModelConfig(
    arch_id="whisper-small",
    family=Family.AUDIO,
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    pos_emb="sinusoidal",
    enc_layers=12,
    enc_frames=1500,
    source="arXiv:2212.04356",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=512, enc_layers=2, enc_frames=16)


register(FULL, smoke)
