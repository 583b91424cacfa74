"""RPN head shared across pyramid levels (port of m3d/models/rpn_head.py).

3^3 conv 512 relu -> 1^3 conv 256 relu -> 1^3 class conv (2 * apl) and 1^3
bbox conv (6 * apl). Flattening to [B, A, 2] / [B, A, 6] is cell-major,
anchor-minor, the order of the anchor pyramid.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from m3d_torch.ops.conv3d import ZConv


class RPNHead(nn.Module):
    def __init__(self, in_channels: int, anchors_per_location: int,
                 anchor_stride: int = 1, dtype=None):
        super().__init__()
        k = anchors_per_location
        s = (anchor_stride,) * 3
        self.rpn_conv_shared1 = ZConv(in_channels, 512, (3, 3, 3), s,
                                      dtype=dtype)
        self.rpn_conv_shared2 = ZConv(512, 256, (1, 1, 1), dtype=dtype)
        self.rpn_class_raw = ZConv(256, 2 * k, (1, 1, 1), dtype=dtype)
        self.rpn_bbox_pred = ZConv(256, 6 * k, (1, 1, 1), dtype=dtype)

    def forward(self, feature_map):
        shared = F.relu(self.rpn_conv_shared1(feature_map))
        shared = F.relu(self.rpn_conv_shared2(shared))
        b = feature_map.shape[0]
        logits = self.rpn_class_raw(shared).reshape(b, -1, 2).float()
        deltas = self.rpn_bbox_pred(shared).reshape(b, -1, 6).float()
        return logits, torch.softmax(logits, dim=-1), deltas
