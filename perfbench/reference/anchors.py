"""Normalized anchor pyramid of a configuration (frozen copy of the port's
anchor generation, numpy only): per level, scales distributed over the
levels, height = width = scale and depth = scale * ratio (ratios divided by
VOXEL_Z_OVER_Y), clipped to the image, min extents 1 voxel in y/x and 0.5
in z, divided by (H, W, D)."""

from __future__ import annotations

import numpy as np


def backbone_shapes(cfg: dict) -> list[tuple[int, int, int]]:
    h, w, d = (int(cfg["IMAGE_SIZE"]), int(cfg["IMAGE_SIZE"]),
               int(cfg["IMAGE_DEPTH"]))
    return [(-(-h // s[0]), -(-w // s[1]), -(-d // s[2]))
            for s in cfg["BACKBONE_STRIDES"]]


def distribute_scales(scales, levels: int):
    scales = sorted(scales)
    n = len(scales)
    if n < levels:
        return [[scales[min(i, n - 1)]] for i in range(levels)]
    per, extra = divmod(n, levels)
    out, start = [], 0
    for i in range(levels):
        end = start + per + (1 if i < extra else 0)
        out.append(scales[start:end])
        start = end
    return out


def level_anchors(scale, ratios, shape, stride, anchor_stride, max_depth):
    sy, sx, sz = stride
    gy, gx, gz = np.meshgrid(np.arange(0, shape[0], anchor_stride) * sy,
                             np.arange(0, shape[1], anchor_stride) * sx,
                             np.arange(0, shape[2], anchor_stride) * sz,
                             indexing="ij")
    base = []
    for r in ratios:
        hh = float(scale)
        dd = float(np.clip(float(scale) * float(r), 0.5, max_depth))
        base.append([-hh / 2, -hh / 2, -dd / 2, hh / 2, hh / 2, dd / 2])
    base = np.asarray(base, np.float32)
    shifts = np.stack([gy.ravel(), gx.ravel(), gz.ravel()] * 2,
                      axis=1).astype(np.float32)
    return (base[None] + shifts[:, None]).reshape(-1, 6)


def anchors(cfg: dict) -> np.ndarray:
    """[A, 6] float32 normalized anchors, in the RPN head's output order."""
    h, w, d = (int(cfg["IMAGE_SIZE"]), int(cfg["IMAGE_SIZE"]),
               int(cfg["IMAGE_DEPTH"]))
    k = float(cfg.get("VOXEL_Z_OVER_Y", 1.0))
    ratios = [r / k for r in cfg["RPN_ANCHOR_RATIOS"]] if k != 1.0 \
        else list(cfg["RPN_ANCHOR_RATIOS"])
    shapes = backbone_shapes(cfg)
    parts = []
    for lv, scales in enumerate(distribute_scales(cfg["RPN_ANCHOR_SCALES"],
                                                  len(shapes))):
        for s in scales:
            parts.append(level_anchors(s, ratios, shapes[lv],
                                       tuple(cfg["BACKBONE_STRIDES"][lv]),
                                       int(cfg.get("RPN_ANCHOR_STRIDE", 1)),
                                       d))
    a = np.concatenate(parts)
    a[:, 0] = np.clip(a[:, 0], 0, h - 1)
    a[:, 1] = np.clip(a[:, 1], 0, w - 1)
    a[:, 2] = np.clip(a[:, 2], 0, d - 1)
    a[:, 3] = np.clip(a[:, 3], 1, h)
    a[:, 4] = np.clip(a[:, 4], 1, w)
    a[:, 5] = np.clip(a[:, 5], 1, d)
    a[:, 3] = np.maximum(a[:, 3], a[:, 0] + 1.0)
    a[:, 4] = np.maximum(a[:, 4], a[:, 1] + 1.0)
    a[:, 5] = np.maximum(a[:, 5], a[:, 2] + 0.5)
    scale = np.array([h, w, d, h, w, d], np.float32)
    return np.clip(a / scale, 0.0, 1.0).astype(np.float32)
