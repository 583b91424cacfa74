"""3D box math on torch tensors (port of m3d/boxes.py).

Boxes are ``(y1, x1, z1, y2, x2, z2)``. Normalized coordinates divide pixel
coordinates by ``(H, W, D)`` with no ``-1`` shift. Deltas are
``(dy, dx, dz, log dh, log dw, log dd)`` relative to the box center/size.
Every function broadcasts over leading axes and computes in float32.
"""

from __future__ import annotations

import math

import torch

# Matterport-style log-scale clamp (reference: core/utils.py:443-446).
LOG_SCALE_LIMIT = math.log(1000.0 / 16.0)


def box_hwd(boxes):
    """Per-box (h, w, d) extents. boxes: [..., 6]."""
    h = boxes[..., 3] - boxes[..., 0]
    w = boxes[..., 4] - boxes[..., 1]
    d = boxes[..., 5] - boxes[..., 2]
    return h, w, d


def box_volume(boxes):
    h, w, d = box_hwd(boxes)
    return h * w * d


def overlaps_3d(boxes1, boxes2, eps: float = 1e-10):
    """Broadcasted pairwise 3D IoU: [..., N, 6] x [..., M, 6] -> [..., N, M].

    Inputs are assumed well-formed (y2 >= y1 etc.), as in m3d.boxes.
    """
    b1 = boxes1.float().unsqueeze(-2)   # [..., N, 1, 6]
    b2 = boxes2.float().unsqueeze(-3)   # [..., 1, M, 6]
    lo = torch.maximum(b1[..., :3], b2[..., :3])
    hi = torch.minimum(b1[..., 3:], b2[..., 3:])
    inter = (hi - lo).clamp_min(0.0).prod(dim=-1)
    union = (box_volume(b1) + box_volume(b2) - inter).clamp_min(eps)
    return (inter / union).clamp(0.0, 1.0)


def apply_deltas(boxes, deltas, clip_log_scale: bool = True):
    """Apply (dy,dx,dz,ldh,ldw,ldd) deltas to [..., 6] boxes.

    Deltas must already be de-standardized (multiplied by BBOX_STD_DEV).
    """
    boxes = boxes.float()
    deltas = deltas.float()
    h, w, d = box_hwd(boxes)
    cy = boxes[..., 0] + 0.5 * h
    cx = boxes[..., 1] + 0.5 * w
    cz = boxes[..., 2] + 0.5 * d

    dh, dw, dd = deltas[..., 3], deltas[..., 4], deltas[..., 5]
    if clip_log_scale:
        dh = dh.clamp(-LOG_SCALE_LIMIT, LOG_SCALE_LIMIT)
        dw = dw.clamp(-LOG_SCALE_LIMIT, LOG_SCALE_LIMIT)
        dd = dd.clamp(-LOG_SCALE_LIMIT, LOG_SCALE_LIMIT)

    cy = cy + deltas[..., 0] * h
    cx = cx + deltas[..., 1] * w
    cz = cz + deltas[..., 2] * d
    h = h * torch.exp(dh)
    w = w * torch.exp(dw)
    d = d * torch.exp(dd)

    y1 = cy - 0.5 * h
    x1 = cx - 0.5 * w
    z1 = cz - 0.5 * d
    return torch.stack([y1, x1, z1, y1 + h, x1 + w, z1 + d], dim=-1)


def _scale6(image_shape, like):
    """[..., 6] (H, W, D, H, W, D) scale broadcastable against ``like``."""
    h, w, d = (torch.as_tensor(s, dtype=torch.float32, device=like.device)
               for s in image_shape[:3])
    return torch.stack(torch.broadcast_tensors(h, w, d, h, w, d), dim=-1)


def norm_boxes(boxes, image_shape, clip: bool = True):
    """Pixel -> normalized [0,1] by dividing by (H, W, D) — no -1 shift."""
    out = boxes.float() / _scale6(image_shape, boxes)
    return out.clamp(0.0, 1.0) if clip else out


def denorm_boxes(boxes, image_shape):
    """Normalized [0,1] -> pixel (float; caller rounds if needed)."""
    return boxes.float() * _scale6(image_shape, boxes)


def enforce_min_size(boxes, min_yx: float = 1e-6, min_z: float = 1e-4):
    """Push y2/x2/z2 up so each box has positive extent."""
    y1, x1, z1 = boxes[..., 0], boxes[..., 1], boxes[..., 2]
    y2 = torch.maximum(boxes[..., 3], y1 + min_yx)
    x2 = torch.maximum(boxes[..., 4], x1 + min_yx)
    z2 = torch.maximum(boxes[..., 5], z1 + min_z)
    return torch.stack([y1, x1, z1, y2, x2, z2], dim=-1)
