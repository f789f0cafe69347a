"""Deterministic synthetic data (the port's own copy of ``repro/data/pipeline.py``).

Batch contents are a pure function of (config, shape, seed, step): a noisy
order-2 Markov chain over a small state space embedded in the full vocab, so
models learn and loss falls. Batches are bit-identical to the reference's for
the same arguments (``tests/test_torch_train.py`` checks it). Batches are numpy
arrays; the caller moves them to its device. The reference's background
``Prefetcher`` comes with the launch slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.config import Family, InputShape, ModelConfig


class SyntheticDataset:
    def __init__(self, cfg: ModelConfig, shape: InputShape, seed: int = 0,
                 n_states: int = 64):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.n_states = min(n_states, cfg.vocab)
        # fixed random transition structure (the "language")
        r = np.random.default_rng(seed + 1)
        self.table = r.integers(0, self.n_states,
                                size=(self.n_states, self.n_states))
        self._flat_table = np.ascontiguousarray(self.table).reshape(-1)

    def _tokens(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        """Markov token stream. All randomness is drawn up front, in the order
        the reference draws it, so every batch matches the reference's."""
        out = rng.integers(0, self.n_states, size=(batch, seq + 1))
        if seq >= 2:
            # overwrite with markov structure 90% of the time
            masks = rng.random((seq - 1, batch)) < 0.9
            flat, n = self._flat_table, self.n_states
            for t in range(2, seq + 1):
                nxt = flat[out[:, t - 1] * n + out[:, t - 2]]
                np.copyto(out[:, t], nxt, where=masks[t - 2])
        return out.astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for a global step: tokens, labels + family-specific frontends."""
        cfg, shape = self.cfg, self.shape
        rng = np.random.default_rng((self.seed, step))
        toks = self._tokens(rng, shape.global_batch, shape.seq_len)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == Family.AUDIO:
            batch["frames"] = rng.standard_normal(
                (shape.global_batch, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        if cfg.family == Family.VLM and cfg.vision_tokens:
            n = cfg.vision_tokens
            batch["vision_embeds"] = rng.standard_normal(
                (shape.global_batch, n, cfg.d_model)).astype(np.float32)
            pos = np.stack([rng.choice(shape.seq_len, size=n, replace=False)
                            for _ in range(shape.global_batch)])
            batch["vision_pos"] = np.sort(pos, axis=-1).astype(np.int32)
        return batch
