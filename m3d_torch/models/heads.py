"""FPN classifier and mask heads (port of m3d/models/heads.py).

ClassifierHead: pool^3 "FC" conv -> 1^3 conv (both + frozen BN + relu) ->
class logits Dense with the +-10 logit clip -> softmax; bbox Dense
``num_classes * 6``. The pool^3 VALID conv over a pool^3 input is one matrix
product (m3d.ops.conv3d.conv3d_fc), computed here as one too.

MaskHead: 4x 3^3 convs with a dilated-residual block (conv3b, dilation 2,
additive merge), a 2x transposed-conv upsample, a 1^3 conv in the compute
dtype and a float32 sigmoid -> [B, T, 2m, 2m, 2m, num_classes].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from m3d_torch.models.backbone import FrozenBatchNorm
from m3d_torch.ops.conv3d import ZConv, to_channels_last, to_ncdhw


class Dense(nn.Module):
    """flax Dense in float32: weight [out, in] (transposed from flax)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.linear(x.float(), self.weight, self.bias)


class ClassifierHead(nn.Module):
    def __init__(self, in_channels: int, pool_size: int, num_classes: int,
                 fc_layers_size: int = 1024, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.fc_layers_size = fc_layers_size
        self.dtype = dtype
        p = pool_size
        self.mrcnn_class_conv1 = ZConv(in_channels, fc_layers_size, (p, p, p),
                                       padding="VALID", dtype=dtype)
        self.mrcnn_class_bn1 = FrozenBatchNorm(fc_layers_size, dtype=dtype)
        self.mrcnn_class_conv2 = ZConv(fc_layers_size, fc_layers_size,
                                       (1, 1, 1), dtype=dtype)
        self.mrcnn_class_bn2 = FrozenBatchNorm(fc_layers_size, dtype=dtype)
        self.mrcnn_class_logits = Dense(fc_layers_size, num_classes)
        self.mrcnn_bbox_fc = Dense(fc_layers_size, num_classes * 6)

    def conv1_as_matmul(self, x):
        """[n, p, p, p, C] -> [n, F]: the full-extent VALID conv as one
        product in the compute dtype (float32 accumulation), plus bias."""
        conv = self.mrcnn_class_conv1
        dtype = self.dtype or x.dtype
        w = conv.weight.to(dtype).permute(2, 3, 4, 1, 0).reshape(
            -1, conv.weight.shape[0])
        y = x.reshape(x.shape[0], -1).to(dtype) @ w
        return y + conv.bias.to(dtype)

    def forward(self, x):
        """x: [B, T, p, p, p, C] -> (logits [B, T, K], probs [B, T, K],
        bbox [B, T, K, 6])."""
        b, t = x.shape[:2]
        x = self.conv1_as_matmul(x.reshape(b * t, *x.shape[2:]))
        x = F.relu(self.mrcnn_class_bn1(x))
        x = x.reshape(b * t, 1, 1, 1, -1)
        x = F.relu(self.mrcnn_class_bn2(self.mrcnn_class_conv2(x)))
        shared = x.reshape(b, t, self.fc_layers_size)
        logits = self.mrcnn_class_logits(shared).clamp(-10.0, 10.0)
        probs = torch.softmax(logits, dim=-1)
        bbox = self.mrcnn_bbox_fc(shared).reshape(b, t, self.num_classes, 6)
        return logits, probs, bbox


class ConvTranspose(nn.Module):
    """flax ConvTranspose (SAME padding, stride == kernel) on channels-last
    tensors. ``weight`` is torch's [Cin, Cout, k...] layout; the checkpoint
    loader flips flax's kernel on every spatial axis to match."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 dtype=None):
        super().__init__()
        self.stride = tuple(int(k) for k in kernel_size)
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.zeros(in_features, features, *self.stride))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        dtype = self.dtype or x.dtype
        w = self.weight.to(dtype).contiguous(
            memory_format=torch.channels_last_3d)
        y = F.conv_transpose3d(to_ncdhw(x.to(dtype)), w, self.bias.to(dtype),
                               self.stride)
        return to_channels_last(y)


class MaskHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int,
                 conv_channel: int = 256, dtype=None):
        super().__init__()
        cc = conv_channel
        self.dtype = dtype
        self.blocks = [("mrcnn_mask_conv1", "mrcnn_mask_bn1", 1),
                       ("mrcnn_mask_conv2", "mrcnn_mask_bn2", 1),
                       ("mrcnn_mask_conv3", "mrcnn_mask_bn3", 1),
                       ("mrcnn_mask_conv3b", "mrcnn_mask_bn3b", 2),
                       ("mrcnn_mask_conv4", "mrcnn_mask_bn4", 1)]
        cin = in_channels
        for conv, bn, dil in self.blocks:
            self.add_module(conv, ZConv(cin, cc, (3, 3, 3),
                                        kernel_dilation=(dil,) * 3,
                                        dtype=dtype))
            self.add_module(bn, FrozenBatchNorm(cc, dtype=dtype))
            cin = cc
        self.mrcnn_mask_deconv = ConvTranspose(cc, cc, (2, 2, 2), dtype=dtype)
        self.mrcnn_mask = ZConv(cc, num_classes, (1, 1, 1), dtype=dtype)

    def _conv_bn_relu(self, i, x):
        conv, bn, _ = self.blocks[i]
        return F.relu(getattr(self, bn)(getattr(self, conv)(x)))

    def forward(self, x):
        """x: [B, T, m, m, m, C] -> masks [B, T, 2m, 2m, 2m, num_classes]."""
        b, t = x.shape[:2]
        x = x.reshape(b * t, *x.shape[2:]).to(self.dtype or x.dtype)
        x = self._conv_bn_relu(0, x)
        x = self._conv_bn_relu(1, x)
        res = self._conv_bn_relu(2, x)
        dil = self._conv_bn_relu(3, res)
        x = self._conv_bn_relu(4, res + dil)
        x = F.relu(self.mrcnn_mask_deconv(x))
        x = torch.sigmoid(self.mrcnn_mask(x).float())
        return x.reshape(b, t, *x.shape[1:])
