"""3D ResNet backbone (port of m3d/models/backbone.py).

Conv3D stem 7^3 with explicit [(3, 3)] * 3 padding, max-pool 3^3 with SAME
(-inf) padding, four bottleneck stages. BatchNorm (momentum 0.9, eps 1e-5)
runs on its running statistics unless its ``batch_stats`` flag is set
(TRAIN_BN: ``MaskRCNN.bn_mode``), as flax's ``use_running_average``.

Submodule names follow the flax tree (``BNRelu_0``, ``Bottleneck_3``,
``res3a_branch2a`` ...) so a flax checkpoint maps onto this module by name
(m3d_torch/checkpoints.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from m3d_torch.ops.conv3d import (ZConv, pad_channels_last, same_padding,
                                  to_channels_last, to_ncdhw)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` on the last axis, in float32, the result in
    ``dtype`` (flax promotes to the float32 statistics, then casts).

    ``batch_stats`` False (the default, whatever ``nn.Module.training``
    says): (x - running_mean) * rsqrt(running_var + eps) * weight + bias.
    ``batch_stats`` True (TRAIN_BN): the batch's mean and biased variance
    over every axis but the last (E[x^2] - E[x]^2 clamped at 0, as flax
    computes it) normalise the batch, and the running statistics move as
    flax moves them: ``ra = momentum * ra + (1 - momentum) * batch`` (the
    opposite convention of torch.nn.BatchNorm's momentum, and the biased
    variance). With ``group`` (a ``m3d_torch.parallel.mesh.Axis``) the
    batch statistics cover every rank of it: the sums and sums of squares
    are all-reduced (with autograd) before the division, so each rank
    normalises with the whole batch's statistics, as one process would."""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5, dtype: torch.dtype | None = None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.batch_stats = False
        self.group = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        xf = x.float()
        if self.batch_stats:
            axes = tuple(range(x.dim() - 1))
            if self.group is None or self.group.size == 1:
                mean = xf.mean(axes)
                var = torch.clamp_min((xf * xf).mean(axes) - mean * mean,
                                      0.0)
            else:
                n = xf.numel() // xf.shape[-1] * self.group.size
                s = self.group.all_reduce(
                    torch.stack([xf.sum(axes), (xf * xf).sum(axes)]))
                mean = s[0] / n
                var = torch.clamp_min(s[1] / n - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean) * mul + self.bias
        return y.to(self.dtype or x.dtype)


class BNRelu(nn.Module):
    """BatchNorm (momentum 0.9) + optional relu; holds the flax BatchNorm
    under its reference layer name."""

    def __init__(self, name_bn: str, features: int, relu: bool = True,
                 dtype=None):
        super().__init__()
        self.name_bn = name_bn
        self.relu = relu
        self.add_module(name_bn, BatchNorm(features, 0.9, dtype=dtype))

    def forward(self, x):
        x = getattr(self, self.name_bn)(x)
        return F.relu(x) if self.relu else x


class Bottleneck(nn.Module):
    """ResNet bottleneck; identity shortcut unless ``conv_shortcut``."""

    def __init__(self, cin: int, filters, stage: int, block: str,
                 strides=(1, 1, 1), conv_shortcut: bool = False, dtype=None):
        super().__init__()
        f1, f2, f3 = filters
        cname = f"res{stage}{block}_branch"
        bname = f"bn{stage}{block}_branch"
        self.names = [cname + s for s in ("2a", "2b", "2c", "1")]
        self.conv_shortcut = conv_shortcut
        self.add_module(self.names[0], ZConv(cin, f1, (1, 1, 1), strides,
                                             "VALID", dtype=dtype))
        self.BNRelu_0 = BNRelu(bname + "2a", f1, dtype=dtype)
        self.add_module(self.names[1], ZConv(f1, f2, (3, 3, 3), dtype=dtype))
        self.BNRelu_1 = BNRelu(bname + "2b", f2, dtype=dtype)
        self.add_module(self.names[2], ZConv(f2, f3, (1, 1, 1),
                                             padding="VALID", dtype=dtype))
        self.BNRelu_2 = BNRelu(bname + "2c", f3, relu=False, dtype=dtype)
        if conv_shortcut:
            self.add_module(self.names[3], ZConv(cin, f3, (1, 1, 1), strides,
                                                 "VALID", dtype=dtype))
            self.BNRelu_3 = BNRelu(bname + "1", f3, relu=False, dtype=dtype)

    def forward(self, x):
        c2a, c2b, c2c, c1 = (getattr(self, n, None) for n in self.names)
        y = self.BNRelu_0(c2a(x))
        y = self.BNRelu_1(c2b(y))
        y = self.BNRelu_2(c2c(y))
        sc = self.BNRelu_3(c1(x)) if self.conv_shortcut else x
        return F.relu(y + sc)


def stage_strides(level_strides):
    """Per-stage (stem conv, stem pool, C3, C4, C5) strides from the config's
    cumulative per-level BACKBONE_STRIDES (first four levels = C2..C5)."""
    s = [tuple(int(v) for v in lv) for lv in level_strides[:4]]
    if not s[0][0] == s[0][1] == 4:
        raise ValueError(f"C2 must be at xy-stride 4, got {s[0]}")
    z0 = s[0][2]
    if z0 not in (1, 2, 4):
        raise ValueError(f"C2 z-stride must be 1, 2 or 4, got {z0}")
    stem_z = 2 if z0 >= 2 else 1
    pool_z = z0 // stem_z
    stages = []
    for i in (1, 2, 3):
        r = tuple(s[i][a] // s[i - 1][a] for a in range(3))
        if not all(f >= 1 and s[i][a] == s[i - 1][a] * f
                   for a, f in enumerate(r)):
            raise ValueError("BACKBONE_STRIDES must grow by integer per-axis "
                             f"factors; level {i}: {s[i]} vs {s[i - 1]}")
        stages.append(r)
    return (2, 2, stem_z), (2, 2, pool_z), *stages


def max_pool_same(x, window, strides):
    """flax ``nn.max_pool(padding="SAME")`` on [B, H, W, D, C]: pads with
    -inf (lo = total // 2), then a VALID max-pool."""
    pads = same_padding(window, strides, x.shape[1:4], (1, 1, 1))
    x = pad_channels_last(x, pads, value=float("-inf"))
    return to_channels_last(F.max_pool3d(to_ncdhw(x), window, strides))


class ResNet3D(nn.Module):
    """Returns (C1, C2, C3, C4, C5) feature maps, channels last."""

    def __init__(self, architecture: str = "resnet50", dtype=None,
                 level_strides=((4, 4, 1), (8, 8, 1), (16, 16, 1),
                                (32, 32, 1), (64, 64, 1)),
                 in_channels: int = 1):
        super().__init__()
        if architecture not in ("resnet50", "resnet101"):
            raise ValueError(f"unknown backbone {architecture!r}")
        self.dtype = dtype
        stem_s, self.pool_s, s3, s4, s5 = stage_strides(level_strides)
        self.conv1 = ZConv(in_channels, 64, (7, 7, 7), stem_s,
                           [(3, 3)] * 3, dtype=dtype)
        self.BNRelu_0 = BNRelu("bn_conv1", 64, dtype=dtype)
        n4 = {"resnet50": 5, "resnet101": 22}[architecture]
        plan = [((64, 64, 256), 2, 2, (1, 1, 1)),
                ((128, 128, 512), 3, 3, s3),
                ((256, 256, 1024), 4, n4, s4),
                ((512, 512, 2048), 5, 2, s5)]
        cin, idx = 64, 0
        self.stage_ends = []
        for filters, stage_id, n_identity, first in plan:
            for i in range(n_identity + 1):
                blk = Bottleneck(cin, filters, stage_id, chr(97 + i),
                                 first if i == 0 else (1, 1, 1),
                                 conv_shortcut=(i == 0), dtype=dtype)
                self.add_module(f"Bottleneck_{idx}", blk)
                cin = filters[2]
                idx += 1
            self.stage_ends.append(idx)

    def forward(self, x):
        x = x.to(self.dtype or x.dtype)
        x = self.BNRelu_0(self.conv1(x))
        c1 = x = max_pool_same(x, (3, 3, 3), self.pool_s)
        outs = [c1]
        start = 0
        for end in self.stage_ends:
            for i in range(start, end):
                x = getattr(self, f"Bottleneck_{i}")(x)
            outs.append(x)
            start = end
        return tuple(outs)
