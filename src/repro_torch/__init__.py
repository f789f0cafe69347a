"""PyTorch / CUDA port of the repro package (see README.md)."""
