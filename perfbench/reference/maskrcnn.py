"""Plain PyTorch reference of 3D Mask R-CNN inference, in float32.

The yardstick that decides ``correct`` for the inference cells. It imports
nothing of the program: it is a frozen copy of the port's plain paths
(trunk, FPN, RPN head, proposals, pyramid ROIAlign by gather, classifier
head, detection refinement, mask head), computed in float32 with TF32 off
(``float32_math``), with exact greedy NMS in place of the port's capped
fixpoint. Parameter names follow the flax tree, as the port's state dict
does, so one converted checkpoint (perfbench/weights.py) loads into both.

``Reference(config, fp8=True)`` is the control: every convolution and matrix
product takes its input and weight rounded to float8 e4m3 (one scale per
tensor, amax to 448), the next precision below the configuration's
bfloat16; accumulation stays float32.

Tensors are channels last, [B, H, W, D, C]; boxes (y1, x1, z1, y2, x2, z2),
normalized by (H, W, D).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

LOG_SCALE_LIMIT = math.log(1000.0 / 16.0)
FP8_MAX = 448.0


@contextlib.contextmanager
def float32_math():
    """TF32 off for cuDNN and matmul inside the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one per-tensor scale, back in
    float32."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class Ctx:
    """Precision of the products: float32, or float8 inputs (control)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, t):
        return fp8_round(t) if self.fp8 else t.float()


def same_padding(kernel, strides, sizes, dilation):
    pads = []
    for k, s, n, dl in zip(kernel, strides, sizes, dilation):
        eff = (k - 1) * dl + 1
        out = -(-n // s)
        total = max((out - 1) * s + eff - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def chlast(x):
    return x.permute(0, 2, 3, 4, 1)


class Conv(nn.Module):
    def __init__(self, cin, cout, k, strides=(1, 1, 1), padding="SAME",
                 dilation=(1, 1, 1)):
        super().__init__()
        self.k = (k,) * 3 if isinstance(k, int) else tuple(k)
        self.strides, self.padding = tuple(strides), padding
        self.dilation = tuple(dilation)
        self.weight = nn.Parameter(torch.zeros(cout, cin, *self.k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, ctx: Ctx):
        if self.padding == "VALID":
            pads = [(0, 0)] * 3
        elif self.padding == "SAME":
            pads = same_padding(self.k, self.strides, x.shape[1:4],
                                self.dilation)
        else:
            pads = [tuple(p) for p in self.padding]
        (a, b), (c, d), (e, f) = pads
        x = F.pad(ctx.q(x), (0, 0, e, f, c, d, a, b))
        y = F.conv3d(ncdhw(x), ctx.q(self.weight), self.bias.float(),
                     self.strides, 0, self.dilation)
        return chlast(y)


class BatchNorm(nn.Module):
    """Inference BatchNorm on the running statistics (eps 1e-5)."""

    def __init__(self, n):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        return ((x - self.running_mean) * torch.rsqrt(self.running_var + 1e-5)
                * self.weight + self.bias)


class BNRelu(nn.Module):
    def __init__(self, name, n, relu=True):
        super().__init__()
        self.name_bn, self.relu = name, relu
        self.add_module(name, BatchNorm(n))

    def forward(self, x):
        x = getattr(self, self.name_bn)(x)
        return F.relu(x) if self.relu else x


class Bottleneck(nn.Module):
    def __init__(self, cin, filters, stage, block, strides, shortcut):
        super().__init__()
        f1, f2, f3 = filters
        c, b = f"res{stage}{block}_branch", f"bn{stage}{block}_branch"
        self.names = [c + s for s in ("2a", "2b", "2c", "1")]
        self.shortcut = shortcut
        self.add_module(self.names[0], Conv(cin, f1, 1, strides, "VALID"))
        self.BNRelu_0 = BNRelu(b + "2a", f1)
        self.add_module(self.names[1], Conv(f1, f2, 3))
        self.BNRelu_1 = BNRelu(b + "2b", f2)
        self.add_module(self.names[2], Conv(f2, f3, 1, padding="VALID"))
        self.BNRelu_2 = BNRelu(b + "2c", f3, relu=False)
        if shortcut:
            self.add_module(self.names[3], Conv(cin, f3, 1, strides, "VALID"))
            self.BNRelu_3 = BNRelu(b + "1", f3, relu=False)

    def forward(self, x, ctx):
        a, b, c, s = (getattr(self, n, None) for n in self.names)
        y = self.BNRelu_0(a(x, ctx))
        y = self.BNRelu_1(b(y, ctx))
        y = self.BNRelu_2(c(y, ctx))
        sc = self.BNRelu_3(s(x, ctx)) if self.shortcut else x
        return F.relu(y + sc)


def stage_strides(level_strides):
    s = [tuple(int(v) for v in lv) for lv in level_strides[:4]]
    z0 = s[0][2]
    stem_z = 2 if z0 >= 2 else 1
    rest = [tuple(s[i][a] // s[i - 1][a] for a in range(3)) for i in (1, 2, 3)]
    return (2, 2, stem_z), (2, 2, z0 // stem_z), *rest


class ResNet(nn.Module):
    def __init__(self, depth_blocks, level_strides, cin):
        super().__init__()
        stem, self.pool_s, s3, s4, s5 = stage_strides(level_strides)
        self.conv1 = Conv(cin, 64, 7, stem, [(3, 3)] * 3)
        self.BNRelu_0 = BNRelu("bn_conv1", 64)
        plan = [((64, 64, 256), 2, 2, (1, 1, 1)),
                ((128, 128, 512), 3, 3, s3),
                ((256, 256, 1024), 4, depth_blocks, s4),
                ((512, 512, 2048), 5, 2, s5)]
        cin, idx, self.ends = 64, 0, []
        for filters, stage, n_id, first in plan:
            for i in range(n_id + 1):
                self.add_module(f"Bottleneck_{idx}", Bottleneck(
                    cin, filters, stage, chr(97 + i),
                    first if i == 0 else (1, 1, 1), i == 0))
                cin, idx = filters[2], idx + 1
            self.ends.append(idx)

    def forward(self, x, ctx):
        x = self.BNRelu_0(self.conv1(x, ctx))
        pads = same_padding((3, 3, 3), self.pool_s, x.shape[1:4], (1, 1, 1))
        (a, b), (c, d), (e, f) = pads
        x = F.pad(x, (0, 0, e, f, c, d, a, b), value=float("-inf"))
        x = chlast(F.max_pool3d(ncdhw(x), 3, self.pool_s))
        outs, start = [], 0
        for end in self.ends:
            for i in range(start, end):
                x = getattr(self, f"Bottleneck_{i}")(x, ctx)
            outs.append(x)
            start = end
        return outs


def upsample_to(x, factors, ref):
    for axis, f in zip((1, 2, 3), factors):
        if f > 1:
            x = x.repeat_interleave(f, dim=axis)
    return x[:, :ref.shape[1], :ref.shape[2], :ref.shape[3], :]


class FPN(nn.Module):
    def __init__(self, channels, up, p6_stride):
        super().__init__()
        self.up, self.p6_stride = up, tuple(p6_stride)
        for name, cin in (("fpn_c5p5", 2048), ("fpn_c4p4", 1024),
                          ("fpn_c3p3", 512), ("fpn_c2p2", 256)):
            self.add_module(name, Conv(cin, channels, 1))
        for name in ("fpn_p2", "fpn_p3", "fpn_p4", "fpn_p5"):
            self.add_module(name, Conv(channels, channels, 3))

    def forward(self, c2, c3, c4, c5, ctx):
        f54, f43, f32 = self.up
        p5 = self.fpn_c5p5(c5, ctx)
        p4 = upsample_to(p5, f54, c4) + self.fpn_c4p4(c4, ctx)
        p3 = upsample_to(p4, f43, c3) + self.fpn_c3p3(c3, ctx)
        p2 = upsample_to(p3, f32, c2) + self.fpn_c2p2(c2, ctx)
        p2, p3 = self.fpn_p2(p2, ctx), self.fpn_p3(p3, ctx)
        p4, p5 = self.fpn_p4(p4, ctx), self.fpn_p5(p5, ctx)
        sy, sx, sz = self.p6_stride
        return [p2, p3, p4, p5, p5[:, ::sy, ::sx, ::sz, :]]


class RPNHead(nn.Module):
    def __init__(self, c, k):
        super().__init__()
        self.rpn_conv_shared1 = Conv(c, 512, 3)
        self.rpn_conv_shared2 = Conv(512, 256, 1)
        self.rpn_class_raw = Conv(256, 2 * k, 1)
        self.rpn_bbox_pred = Conv(256, 6 * k, 1)

    def forward(self, x, ctx):
        s = F.relu(self.rpn_conv_shared1(x, ctx))
        s = F.relu(self.rpn_conv_shared2(s, ctx))
        b = x.shape[0]
        logits = self.rpn_class_raw(s, ctx).reshape(b, -1, 2)
        return torch.softmax(logits, -1), self.rpn_bbox_pred(s, ctx).reshape(
            b, -1, 6)


class Dense(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, ctx):
        return ctx.q(x) @ ctx.q(self.weight).t() + self.bias


class ClassifierHead(nn.Module):
    def __init__(self, c, p, k, fc):
        super().__init__()
        self.k, self.fc = k, fc
        self.mrcnn_class_conv1 = Conv(c, fc, p, padding="VALID")
        self.mrcnn_class_bn1 = BatchNorm(fc)
        self.mrcnn_class_conv2 = Conv(fc, fc, 1)
        self.mrcnn_class_bn2 = BatchNorm(fc)
        self.mrcnn_class_logits = Dense(fc, k)
        self.mrcnn_bbox_fc = Dense(fc, 6 * k)

    def forward(self, x, ctx):
        """x [n, p, p, p, C] -> probs [n, K], deltas [n, K, 6]."""
        conv = self.mrcnn_class_conv1
        w = conv.weight.permute(2, 3, 4, 1, 0).reshape(-1, self.fc)
        y = ctx.q(x.reshape(x.shape[0], -1)) @ ctx.q(w) + conv.bias
        y = F.relu(self.mrcnn_class_bn1(y))
        w2 = self.mrcnn_class_conv2.weight.reshape(self.fc, self.fc)
        y = ctx.q(y) @ ctx.q(w2).t() + self.mrcnn_class_conv2.bias
        y = F.relu(self.mrcnn_class_bn2(y))
        logits = self.mrcnn_class_logits(y, ctx).clamp(-10.0, 10.0)
        deltas = self.mrcnn_bbox_fc(y, ctx).reshape(-1, self.k, 6)
        return torch.softmax(logits, -1), deltas


class MaskHead(nn.Module):
    BLOCKS = (("mrcnn_mask_conv1", "mrcnn_mask_bn1", 1),
              ("mrcnn_mask_conv2", "mrcnn_mask_bn2", 1),
              ("mrcnn_mask_conv3", "mrcnn_mask_bn3", 1),
              ("mrcnn_mask_conv3b", "mrcnn_mask_bn3b", 2),
              ("mrcnn_mask_conv4", "mrcnn_mask_bn4", 1))

    def __init__(self, c, k, cc):
        super().__init__()
        cin = c
        for conv, bn, dil in self.BLOCKS:
            self.add_module(conv, Conv(cin, cc, 3, dilation=(dil,) * 3))
            self.add_module(bn, BatchNorm(cc))
            cin = cc
        deconv = nn.Module()
        deconv.weight = nn.Parameter(torch.zeros(cc, cc, 2, 2, 2))
        deconv.bias = nn.Parameter(torch.zeros(cc))
        self.mrcnn_mask_deconv = deconv
        self.mrcnn_mask = Conv(cc, k, 1)

    def _cbr(self, i, x, ctx):
        conv, bn, _ = self.BLOCKS[i]
        return F.relu(getattr(self, bn)(getattr(self, conv)(x, ctx)))

    def forward(self, x, ctx):
        """x [n, m, m, m, C] -> masks [n, 2m, 2m, 2m, K]."""
        x = self._cbr(1, self._cbr(0, x, ctx), ctx)
        res = self._cbr(2, x, ctx)
        x = self._cbr(4, res + self._cbr(3, res, ctx), ctx)
        d = self.mrcnn_mask_deconv
        x = chlast(F.conv_transpose3d(ncdhw(ctx.q(x)), ctx.q(d.weight),
                                      d.bias, 2))
        return torch.sigmoid(self.mrcnn_mask(F.relu(x), ctx))


# Boxes, proposals, NMS ----------------------------------------------------

def apply_deltas(boxes, deltas, clip_log_scale):
    h = boxes[..., 3] - boxes[..., 0]
    w = boxes[..., 4] - boxes[..., 1]
    d = boxes[..., 5] - boxes[..., 2]
    cy, cx, cz = (boxes[..., 0] + 0.5 * h, boxes[..., 1] + 0.5 * w,
                  boxes[..., 2] + 0.5 * d)
    logs = deltas[..., 3:]
    if clip_log_scale:
        logs = logs.clamp(-LOG_SCALE_LIMIT, LOG_SCALE_LIMIT)
    cy, cx, cz = (cy + deltas[..., 0] * h, cx + deltas[..., 1] * w,
                  cz + deltas[..., 2] * d)
    h, w, d = (h * torch.exp(logs[..., 0]), w * torch.exp(logs[..., 1]),
               d * torch.exp(logs[..., 2]))
    y1, x1, z1 = cy - 0.5 * h, cx - 0.5 * w, cz - 0.5 * d
    return torch.stack([y1, x1, z1, y1 + h, x1 + w, z1 + d], -1)


def volume(b):
    return (b[..., 3] - b[..., 0]) * (b[..., 4] - b[..., 1]) * (
        b[..., 5] - b[..., 2])


def iou(a, b, eps=1e-10):
    """[..., A, 6] x [..., M, 6] -> [..., A, M], in the op order of the
    port's NMS (and of JAX's)."""
    va, vb = volume(a), volume(b)
    a, b = a[..., :, None, :], b[..., None, :, :]
    d = [torch.clamp_min(torch.minimum(a[..., k + 3], b[..., k + 3])
                         - torch.maximum(a[..., k], b[..., k]), 0.0)
         for k in range(3)]
    inter = d[0] * d[1] * d[2]
    return inter / torch.clamp_min(va[..., :, None] + vb[..., None, :]
                                   - inter, eps)


def greedy_nms(boxes, scores, thr, max_out, valid=None):
    """Exact greedy NMS of one image's [N, 6] boxes: indices kept, in
    descending score order (stable on ties), at most ``max_out``. Runs the
    triangular suppression fixpoint to convergence, which is the greedy
    set."""
    if valid is not None:
        boxes, scores = boxes[valid], scores[valid]
        ids = torch.nonzero(valid).flatten()
    else:
        ids = torch.arange(scores.shape[0], device=scores.device)
    if scores.numel() == 0:
        return ids[:0]
    order = torch.sort(scores, descending=True, stable=True).indices
    bs = boxes[order]
    sup = torch.triu(iou(bs, bs) > thr, diagonal=1).float()
    alive = torch.ones(bs.shape[0], dtype=torch.bool, device=bs.device)
    while True:
        nxt = ~((alive.float() @ sup) > 0.5)
        if bool((nxt == alive).all()):
            break
        alive = nxt
    return ids[order[alive]][:max_out]


# ROIAlign ----------------------------------------------------------------

def roi_levels(boxes, shape, num_levels=4):
    h = boxes[:, 3] - boxes[:, 0]
    w = boxes[:, 4] - boxes[:, 1]
    d = boxes[:, 5] - boxes[:, 2]
    vol = torch.clamp_min(h * w * d, 1e-12)
    img = shape[:, 0] * shape[:, 1] * shape[:, 2]
    lvl = torch.log2(torch.pow(vol, 1 / 3) / (224.0 / torch.pow(img, 1 / 3)))
    lvl = 4 + torch.round(lvl).long()
    return lvl.clamp(2, 1 + num_levels) - 2


def sanitize(boxes, shape):
    """Clip to [0, 1] with positive extents (1e-6 in y/x, one voxel in z),
    as the port's ROIAlign entries do."""
    y1, x1, z1 = (boxes[:, i].clamp(0.0, 1.0) for i in range(3))
    y2 = torch.maximum(boxes[:, 3].clamp(0.0, 1.0), y1 + 1e-6)
    x2 = torch.maximum(boxes[:, 4].clamp(0.0, 1.0), x1 + 1e-6)
    z2 = torch.maximum(boxes[:, 5].clamp(0.0, 1.0),
                       z1 + 1.0 / shape[:, 2].clamp_min(1.0))
    return torch.stack([y1, x1, z1, y2, x2, z2], -1)


def axis_positions(lo, hi, size, p):
    span = size - 1.0
    if p > 1:
        frac = torch.arange(p, device=lo.device, dtype=torch.float32) / (p - 1)
        return lo[:, None] * span[:, None] + ((hi - lo) * span)[:, None] * frac
    return (0.5 * (lo + hi) * span)[:, None]


def sample(fm, img, pos):
    """Trilinear samples of [B, H, W, D, C] at per-row positions (three
    [n, p] grids in voxel units) from image ``img`` [n]; 0 outside."""
    b, h, w, d, c = fm.shape
    flat = fm.reshape(-1, c)
    n = img.shape[0]
    corners = []
    for q, size in zip(pos, (h, w, d)):
        inb = (q >= 0) & (q <= size - 1)
        qc = q.clamp(0, size - 1)
        i0 = torch.floor(qc).long().clamp(0, size - 1)
        corners.append((i0, (i0 + 1).clamp(max=size - 1), qc - i0, inb))
    (y0, y1, wy, my), (x0, x1, wx, mx), (z0, z1, wz, mz) = corners
    p = [g.shape[1] for g in pos]
    out = torch.zeros(n, *p, c, device=fm.device)
    base = img.long() * (h * w * d)
    for cy, ay in ((y0, 1 - wy), (y1, wy)):
        for cx, ax in ((x0, 1 - wx), (x1, wx)):
            for cz, az in ((z0, 1 - wz), (z1, wz)):
                idx = (base[:, None, None, None] + cy[:, :, None, None] * (w * d)
                       + cx[:, None, :, None] * d + cz[:, None, None, :])
                wgt = ay[:, :, None, None] * ax[:, None, :, None] \
                    * az[:, None, None, :]
                out += flat[idx.reshape(-1)].reshape(n, *p, c) * wgt[..., None]
    m = my[:, :, None, None] & mx[:, None, :, None] & mz[:, None, None, :]
    out = torch.where(m[..., None], out, torch.zeros((), device=fm.device))
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def roi_align(fms, boxes, img, shape, p):
    """Pyramid ROIAlign of rows (boxes [n, 6], image index [n]) over
    P2..P5: [n, p, p, p, C]."""
    shp = shape[img.long()]
    boxes = sanitize(boxes.float(), shp)
    lv = roi_levels(boxes, shp, len(fms))
    out = torch.zeros(boxes.shape[0], p, p, p, fms[0].shape[-1],
                      device=boxes.device)
    for level, fm in enumerate(fms):
        rows = torch.nonzero(lv == level).flatten()
        if rows.numel() == 0:
            continue
        dims = fm.shape[1:4]
        pos = [axis_positions(boxes[rows, a], boxes[rows, a + 3],
                              torch.full((rows.numel(),), float(dims[a]),
                                         device=boxes.device), p)
               for a in range(3)]
        out[rows] = sample(fm, img[rows], pos)
    return out


# The model ---------------------------------------------------------------

class Reference(nn.Module):
    """Float32 (or float8-input, ``fp8``) 3D Mask R-CNN inference from a
    configuration dict in the port's schema (perfbench/configs/*.json
    ``model``)."""

    ROW_BLOCK = 1024      # classifier rows per block
    MASK_BLOCK = 16       # mask-head rows per block

    def __init__(self, cfg: dict, fp8: bool = False):
        super().__init__()
        self.cfg = cfg
        self.ctx = Ctx(fp8)
        s = [tuple(v) for v in cfg["BACKBONE_STRIDES"]]
        c = int(cfg["TOP_DOWN_PYRAMID_SIZE"])
        k = int(cfg["NUM_CLASSES"])
        n_scales, n_levels = len(cfg["RPN_ANCHOR_SCALES"]), len(s)
        per_level = max(1, n_scales // n_levels)
        self.resnet = ResNet({"resnet50": 5, "resnet101": 22}[cfg["BACKBONE"]],
                             s, int(cfg.get("IMAGE_CHANNEL_COUNT", 1)))
        up = tuple(tuple(s[i + 1][a] // s[i][a] for a in range(3))
                   for i in (2, 1, 0))
        self.fpn = FPN(c, up, tuple(max(1, s[4][i] // s[3][i])
                                    for i in range(3)))
        self.rpn = RPNHead(c, per_level * len(cfg["RPN_ANCHOR_RATIOS"]))
        self.classifier = ClassifierHead(c, int(cfg["POOL_SIZE"]), k,
                                         int(cfg["FPN_CLASSIF_FC_LAYERS_SIZE"]))
        self.mask_head = MaskHead(c, k, int(cfg["HEAD_CONV_CHANNEL"]))

    # stages --------------------------------------------------------------
    def features(self, image):
        """[B, H, W, D, C] -> P2..P6, one image at a time."""
        per = []
        for i in range(image.shape[0]):
            c = self.resnet(image[i:i + 1].float(), self.ctx)
            per.append(self.fpn(*c, self.ctx))
        return [torch.cat([p[lv] for p in per]) for lv in range(5)]

    def rpn_scores_boxes(self, fms, anchors):
        """Foreground scores [B, A] and every anchor decoded, clipped and
        min-sized [B, A, 6], as the proposal layer makes its candidates."""
        outs = [self.rpn(p, self.ctx) for p in fms]
        probs = torch.cat([o[0] for o in outs], 1)
        deltas = torch.cat([o[1] for o in outs], 1)
        std = torch.tensor(self.cfg["RPN_BBOX_STD_DEV"], device=deltas.device)
        d = (deltas * std).clamp(-3.0, 3.0)
        boxes = apply_deltas(anchors[None].float(), d, False).clamp(0.0, 1.0)
        min_z = max(1.0 / max(float(self.cfg["IMAGE_DEPTH"]), 1.0), 1e-4)
        y2 = torch.maximum(boxes[..., 3], boxes[..., 0] + 1e-6)
        x2 = torch.maximum(boxes[..., 4], boxes[..., 1] + 1e-6)
        z2 = torch.maximum(boxes[..., 5], boxes[..., 2] + min_z)
        boxes = torch.stack([boxes[..., 0], boxes[..., 1], boxes[..., 2],
                             y2, x2, z2], -1)
        return probs[..., 1], boxes

    def proposals(self, scores, boxes):
        """Top PRE_NMS_LIMIT candidates, exact greedy NMS, padded with
        zero boxes: ([B, N, 6], valid [B, N], floor [B]). ``floor`` is the
        least score a proposal of the image may have: the last kept one's
        where the list is full, else the PRE_NMS_LIMIT-th candidate's."""
        n = int(self.cfg["POST_NMS_ROIS_INFERENCE"])
        k = min(int(self.cfg["PRE_NMS_LIMIT"]), scores.shape[1])
        out = torch.zeros(scores.shape[0], n, 6, device=scores.device)
        valid = torch.zeros(scores.shape[0], n, dtype=torch.bool,
                            device=scores.device)
        floor = torch.zeros(scores.shape[0], device=scores.device)
        for b in range(scores.shape[0]):
            top = torch.sort(scores[b], descending=True, stable=True
                             ).indices[:k]
            keep = greedy_nms(boxes[b, top], scores[b, top],
                              float(self.cfg["RPN_NMS_THRESHOLD"]), n)
            out[b, :keep.numel()] = boxes[b, top[keep]]
            valid[b, :keep.numel()] = True
            floor[b] = scores[b, top[keep[-1]] if keep.numel() == n
                              else top[-1]]
        return out, valid, floor

    def classify(self, rois, meta, fms):
        """Classifier over every [B, N, 6] slot, in row blocks: (probs
        [B, N, K], deltas [B, N, K, 6])."""
        b, n = rois.shape[:2]
        shape = meta[:, 5:8].float()
        img = torch.arange(b, device=rois.device).repeat_interleave(n)
        flat = rois.reshape(-1, 6)
        probs, deltas = [], []
        p = int(self.cfg["POOL_SIZE"])
        for s in range(0, flat.shape[0], self.ROW_BLOCK):
            x = roi_align(fms[:4], flat[s:s + self.ROW_BLOCK],
                          img[s:s + self.ROW_BLOCK], shape, p)
            pr, de = self.classifier(x, self.ctx)
            probs.append(pr)
            deltas.append(de)
        return (torch.cat(probs).reshape(b, n, -1),
                torch.cat(deltas).reshape(b, n, -1, 6))

    def refine(self, rois, probs, deltas, meta):
        """Detections [B, M, 8] and valid [B, M] from the classifier's
        outputs (the port's refine_detections_batch, exact greedy NMS)."""
        cfg = self.cfg
        m = int(cfg["DETECTION_MAX_INSTANCES"])
        bsz = rois.shape[0]
        det = torch.zeros(bsz, m, 8, device=rois.device)
        valid = torch.zeros(bsz, m, dtype=torch.bool, device=rois.device)
        std = torch.tensor(cfg["BBOX_STD_DEV"], device=rois.device)
        for b in range(bsz):
            h, w, d = (float(v) for v in meta[b, 5:8])
            scale = torch.tensor([h, w, d, h, w, d], device=rois.device)
            fg = probs[b, :, 1]
            keep = (fg >= float(cfg["DETECTION_MIN_CONFIDENCE"])) & (
                rois[b].abs().sum(-1) > 0)
            px = apply_deltas(rois[b] * scale, deltas[b, :, 1] * std, True)
            px = torch.minimum(px.clamp_min(0.0), scale)
            ext = px[:, 3:] - px[:, :3]
            keep &= (ext[:, 0] >= 1.0) & (ext[:, 1] >= 1.0) & (ext[:, 2] >= 0.5)
            nb = px
            if cfg.get("DETECTION_NMS_XY_ONLY", False):
                nb = px.clone()
                nb[:, 2], nb[:, 5] = 0.0, 1.0
            kept = greedy_nms(nb, fg, float(cfg["DETECTION_NMS_THRESHOLD"]),
                              m, valid=keep)
            t = kept.numel()
            det[b, :t, :6] = px[kept] / scale
            det[b, :t, 6] = 1.0
            det[b, :t, 7] = fg[kept]
            valid[b, :t] = True
        return det, valid

    def masks(self, boxes, img, meta, fms):
        """Mask probabilities [n, 2m, 2m, 2m, K] for rows (boxes [n, 6],
        image index [n]), in row blocks."""
        m = int(self.cfg["MASK_POOL_SIZE"])
        shape = meta[:, 5:8].float()
        out = []
        for s in range(0, boxes.shape[0], self.MASK_BLOCK):
            x = roi_align(fms[:4], boxes[s:s + self.MASK_BLOCK],
                          img[s:s + self.MASK_BLOCK], shape, m)
            out.append(self.mask_head(x, self.ctx))
        if not out:
            k = int(self.cfg["NUM_CLASSES"])
            return torch.zeros(0, 2 * m, 2 * m, 2 * m, k, device=meta.device)
        return torch.cat(out)

    @torch.no_grad()
    def infer(self, image, meta, anchors):
        """The whole pipeline: the same dict as the port's inference
        entries (the control puts this, at ``fp8``, in the program's
        place)."""
        fms = self.features(image)
        scores, boxes = self.rpn_scores_boxes(fms, anchors)
        props, pvalid, _ = self.proposals(scores, boxes)
        probs, deltas = self.classify(props, meta, fms)
        det, dvalid = self.refine(props, probs, deltas, meta)
        b, n = dvalid.shape
        m2 = 2 * int(self.cfg["MASK_POOL_SIZE"])
        k = int(self.cfg["NUM_CLASSES"])
        masks = torch.zeros(b, n, m2, m2, m2, k, device=image.device)
        rows = torch.nonzero(dvalid)
        if rows.numel():
            masks[rows[:, 0], rows[:, 1]] = self.masks(
                det[rows[:, 0], rows[:, 1], :6], rows[:, 0], meta, fms)
        return {"detections": det, "detections_valid": dvalid,
                "mrcnn_masks": masks, "mrcnn_probs": probs,
                "mrcnn_bbox": deltas, "proposals": props,
                "proposals_valid": pvalid}
