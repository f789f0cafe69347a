"""Deterministic synthetic data and its background prefetch."""

from .pipeline import Prefetcher, SyntheticDataset

__all__ = ["Prefetcher", "SyntheticDataset"]
