"""3D convolution on channels-last tensors (port of ``ZConv`` in
m3d/ops/conv3d.py).

Public tensors keep the JAX layout [B, H, W, D, C]. ``x.permute(0, 4, 1, 2, 3)``
of such a tensor is an [B, C, H, W, D] view whose memory is already
``torch.channels_last_3d``, so ``F.conv3d`` runs on it without a copy and its
output permutes back the same way. ``conv3d_zdec`` and ``conv3d_s2d`` of the
JAX package are TPU workarounds and have no counterpart here.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def same_padding(kernel_size, strides, in_sizes, dilation):
    """Per-axis (lo, hi) SAME padding as XLA computes it: lo = total // 2."""
    pads = []
    for k, s, n, dl in zip(kernel_size, strides, in_sizes, dilation):
        eff = (k - 1) * dl + 1
        out = -(-n // s)
        total = max((out - 1) * s + eff - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, D, C] -> [B, C, H, W, D] view (channels_last_3d memory)."""
    return x.permute(0, 4, 1, 2, 3)


def to_channels_last(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W, D] -> [B, H, W, D, C] view."""
    return x.permute(0, 2, 3, 4, 1)


def pad_channels_last(x, pads, value: float = 0.0):
    """Pad the three spatial axes of a [B, H, W, D, C] tensor."""
    if not any(lo or hi for lo, hi in pads):
        return x
    (py, pyh), (px, pxh), (pz, pzh) = pads
    return F.pad(x, (0, 0, pz, pzh, px, pxh, py, pyh), value=value)


class ZConv(nn.Module):
    """Conv3d with the JAX module's padding rules, on [B, H, W, D, C].

    ``padding`` is "SAME", "VALID" or explicit per-axis (lo, hi) pairs.
    Parameters are float32 (``weight`` [Cout, Cin, ky, kx, kz], ``bias``
    [Cout]); with ``dtype`` set, input and weight are cast to it before the
    conv, and the bias joins the conv in it (flax adds it right after).
    """

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides=(1, 1, 1),
                 padding="SAME", kernel_dilation=(1, 1, 1),
                 use_bias: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.strides = tuple(int(s) for s in strides)
        self.padding = padding
        self.dilation = tuple(int(d) for d in kernel_dilation)
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features, *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def _pads(self, x):
        if isinstance(self.padding, str):
            if self.padding.upper() == "VALID":
                return [(0, 0)] * 3
            return same_padding(self.kernel_size, self.strides,
                                x.shape[1:4], self.dilation)
        return [tuple(p) for p in self.padding]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        x = x.to(dtype)
        pads = self._pads(x)
        sym = all(lo == hi for lo, hi in pads)
        if not sym:
            x = pad_channels_last(x, pads)
        w = self.weight.to(dtype).contiguous(
            memory_format=torch.channels_last_3d)
        b = None if self.bias is None else self.bias.to(dtype)
        y = F.conv3d(to_ncdhw(x), w, b, self.strides,
                     tuple(lo for lo, _ in pads) if sym else 0,
                     self.dilation)
        return to_channels_last(y)
