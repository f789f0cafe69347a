"""Deterministic synthetic data (the port's own copy of ``repro/data/pipeline.py``).

Batch contents are a pure function of (config, shape, seed, step): a noisy
order-2 Markov chain over a small state space embedded in the full vocab, so
models learn and loss falls. Batches are bit-identical to the reference's for
the same arguments (``tests/test_torch_train.py`` checks it). Batches are numpy
arrays; the caller moves them to its device. :class:`Prefetcher` builds the
next step's batch on a background thread while the current step runs.
"""

from __future__ import annotations

import concurrent.futures
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


class Prefetcher:
    """One-batch-ahead prefetch on a background thread (the reference's,
    ``repro/data/pipeline.py:88``).

    Batch synthesis is host work (``batch = f(config, step)``), so it can
    overlap the device step: after serving step ``s`` the batches of ``s + 1
    .. s + lookahead`` are already being built. Random access stays correct:
    a step with no prefetch in flight is built at once, so a rollback that
    jumps back replays the same batches (determinism is the dataset's; the
    prefetcher only changes when the work happens, never what). ``close()``
    cancels what is pending and ends the thread; the prefetcher is also a
    context manager::

        with Prefetcher(ds) as pf:
            run_with_recovery(..., get_batch=pf.batch, ...)
    """

    def __init__(self, dataset, lookahead: int = 1):
        self.dataset = dataset
        self.lookahead = max(0, int(lookahead))
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="data-prefetch")
        self._pending: Dict[int, concurrent.futures.Future] = {}

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        fut = self._pending.pop(step, None)
        out = fut.result() if fut is not None else self.dataset.batch(step)
        for s in range(step + 1, step + 1 + self.lookahead):
            if s not in self._pending:
                self._pending[s] = self._pool.submit(self.dataset.batch, s)
        return out

    def close(self) -> None:
        for fut in self._pending.values():
            fut.cancel()
        self._pending.clear()
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
