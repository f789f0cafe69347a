"""Decoder-layer execution (this slice: the local placement)."""
