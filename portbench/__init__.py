"""Benchmark of the PyTorch and CUDA port."""
