"""Deterministic synthetic data."""

from .pipeline import SyntheticDataset

__all__ = ["SyntheticDataset"]
