"""m3d_torch: the PyTorch/CUDA port of m3d's 3D Mask R-CNN.

Public tensors keep the JAX package's layout: volumes and feature maps are
[B, H, W, D, C] (channels last), boxes are (y1, x1, z1, y2, x2, z2).
Imports torch, numpy and scipy only; never jax, flax or m3d.
"""
