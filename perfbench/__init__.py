"""Benchmark of m3d_torch, the PyTorch and CUDA port, on NVIDIA H100 cards.

perfbench/README.md says how to run a cell and how to add one.
"""
