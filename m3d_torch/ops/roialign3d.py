"""Pyramid 3D ROIAlign over flat ROI lists (port of the flat/compact subset
of m3d/ops/roialign3d.py).

Sampling follows TF crop_and_resize, generalized to 3-D:

  for crop size p > 1:   pos_i = b1 * (S - 1) + i * (b2 - b1) * (S - 1) / (p - 1)
  for crop size p == 1:  pos   = 0.5 * (b1 + b2) * (S - 1)

with out-of-range positions giving 0. Each ROI is routed to one FPN level
(``compute_roi_levels``) and sampled trilinearly from it. Boxes are
sanitized exactly as the JAX entries do, and non-finite outputs become 0.
"""

from __future__ import annotations

import torch

from m3d_torch.image_meta import parse_image_meta
from m3d_torch.ops.roialign_compact import (flatten_pyramid, roialign_compact,
                                            trilinear_gather)


def axis_positions(lo, hi, size, crop: int):
    """Sample positions along one axis. lo/hi/size: [N]. Returns [N, crop]."""
    span = size.float() - 1.0
    if crop > 1:
        frac = torch.arange(crop, dtype=torch.float32,
                            device=lo.device) / (crop - 1)
        return lo[:, None] * span[:, None] + (
            (hi - lo)[:, None] * span[:, None]) * frac[None, :]
    return (0.5 * (lo + hi) * span)[:, None]


def compute_roi_levels(boxes, image_shape, num_levels: int = 4):
    """FPN level per ROI (0 == P2):
    clamp(4 + round(log2(cbrt(vol_norm) * cbrt(HWD) / 224)), 2, 5) - 2.
    image_shape: (H, W, D), each [N] or scalar, in pixels."""
    h = boxes[..., 3] - boxes[..., 0]
    w = boxes[..., 4] - boxes[..., 1]
    d = boxes[..., 5] - boxes[..., 2]
    vol = torch.clamp_min(h * w * d, 1e-12)
    image_volume = (image_shape[0].float() * image_shape[1].float()
                    * image_shape[2].float())
    lvl = torch.log2(torch.pow(vol, 1.0 / 3.0)
                     / (224.0 / torch.pow(image_volume, 1.0 / 3.0)))
    lvl = 4 + torch.round(lvl).to(torch.int32)
    return (lvl.clamp(2, 2 + num_levels - 1) - 2).to(torch.int32)


def sanitize_flat_rois(boxes, batch_idx, image_meta, num_levels: int):
    """Clip boxes to [0, 1], give each positive extent (1e-6 in y/x, one
    voxel of its image in z) and route it to a level. Returns
    (boxes [N, 6] float32, levels [N] int32)."""
    image_shape = parse_image_meta(image_meta.float())["image_shape"]
    boxes = boxes.detach().float()
    shp = image_shape[batch_idx.long()]
    d_img = shp[:, 2].clamp_min(1.0)
    y1 = boxes[:, 0].clamp(0.0, 1.0)
    x1 = boxes[:, 1].clamp(0.0, 1.0)
    z1 = boxes[:, 2].clamp(0.0, 1.0)
    y2 = torch.maximum(boxes[:, 3].clamp(0.0, 1.0), y1 + 1e-6)
    x2 = torch.maximum(boxes[:, 4].clamp(0.0, 1.0), x1 + 1e-6)
    z2 = torch.maximum(boxes[:, 5].clamp(0.0, 1.0), z1 + 1.0 / d_img)
    boxes = torch.stack([y1, x1, z1, y2, x2, z2], dim=-1)
    levels = compute_roi_levels(boxes, (shp[:, 0], shp[:, 1], shp[:, 2]),
                                num_levels)
    return boxes, levels


def _pool_size(pool_size) -> int:
    if isinstance(pool_size, (tuple, list)):
        if len(set(pool_size)) != 1:
            raise ValueError(f"only cubic pools are supported: {pool_size}")
        pool_size = pool_size[0]
    return int(pool_size)


def _level_positions(boxes, levels, feature_maps, p: int):
    """Per-ROI level extents [N, 3] (int64) and sample positions, three
    [N, p] float32 grids."""
    dims = torch.tensor([tuple(fm.shape[1:4]) for fm in feature_maps],
                        dtype=torch.long, device=boxes.device)
    rd = dims[levels.long()]
    pos = tuple(axis_positions(boxes[:, a], boxes[:, a + 3], rd[:, a], p)
                for a in range(3))
    return rd, pos


def gather_flat_sanitized(boxes, levels, batch_idx, feature_maps, p: int):
    """Gather-path ROIAlign over sanitized, routed boxes. Returns
    [N, p, p, p, C] in the features' dtype (float32 math), NaN-scrubbed."""
    flat, offsets, _, cells = flatten_pyramid(feature_maps)
    rd, pos = _level_positions(boxes, levels, feature_maps, p)
    off = torch.tensor(offsets, dtype=torch.long, device=boxes.device)
    base = batch_idx.long() * cells + off[levels.long()]
    out = trilinear_gather(
        flat, base, dims=tuple(rd[:, a].float() for a in range(3)),
        strides=(rd[:, 1] * rd[:, 2], rd[:, 2], torch.ones_like(rd[:, 2])),
        positions=pos)
    out = torch.where(torch.isfinite(out), out, out.new_zeros(()))
    return out.to(feature_maps[0].dtype)


def pyramid_roi_align_flat(boxes, batch_idx, image_meta, feature_maps,
                           pool_size):
    """Pyramid ROIAlign over a flat ROI list ([N, 6] boxes, [N] source-image
    indices); computes every row. Returns [N, p, p, p, C]."""
    p = _pool_size(pool_size)
    boxes, levels = sanitize_flat_rois(boxes, batch_idx, image_meta,
                                       len(feature_maps))
    return gather_flat_sanitized(boxes, levels, batch_idx, feature_maps, p)


def pyramid_roi_align_compact(boxes, batch_idx, total, image_meta,
                              feature_maps, pool_size):
    """Pyramid ROIAlign over a compacted flat ROI list (rows grouped by
    image, live rows first); only rows < ``total`` are computed, later rows
    are zero. ``total`` is a [] int32 tensor on the features' device and is
    never read on the host. Returns [N, p, p, p, C] in the features' dtype.
    """
    p = _pool_size(pool_size)
    dev = feature_maps[0].device
    batch_idx = batch_idx.to(device=dev, dtype=torch.int32)
    boxes, levels = sanitize_flat_rois(boxes, batch_idx, image_meta,
                                       len(feature_maps))
    _, pos = _level_positions(boxes, levels, feature_maps, p)
    pos = torch.stack(pos, dim=1).contiguous()                  # [N, 3, p]
    total = torch.as_tensor(total, device=dev).to(torch.int32).reshape(())
    fms = [fm.contiguous() for fm in feature_maps]
    return roialign_compact(levels.contiguous(), batch_idx.contiguous(),
                            total, pos, fms)
