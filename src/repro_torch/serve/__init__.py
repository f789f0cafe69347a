"""Serving: decode attention against the KV cache."""
