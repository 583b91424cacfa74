"""Anchor generation (the port's own copy of m3d/anchors.py, numpy only).

Anisotropic-Z anchors: height = width = scale, depth = scale * ratio clipped
to [0.5, IMAGE_DEPTH] (reference: core/utils.py:1026-1081 generate_anchors).
Scales are distributed across FPN levels rather than one-per-level
(reference: core/utils.py:1084-1142 generate_pyramid_anchors).

The pixel->normalized pipeline (clip, min-size, divide by H/W/D) follows the
RPN orchestrator (reference: core/models.py:3475-3528 RPN.get_anchors).
"""

from __future__ import annotations

import numpy as np


def _stride_triple(stride):
    if isinstance(stride, (int, np.integer)):
        return (int(stride),) * 3
    stride = tuple(int(s) for s in stride)
    if len(stride) == 3:
        return stride
    if len(stride) == 2:
        return (stride[0], stride[0], stride[1])
    return (stride[0],) * 3


def generate_anchors(scales, ratios, feature_shape, feature_stride, anchor_stride,
                     max_depth=None) -> np.ndarray:
    """Anchors for one FPN level, in pixel coordinates. Returns [A, 6].

    Layout matches the reference exactly: the grid is meshed over (y, x, z)
    with 'ij' indexing and the per-cell anchors (scale-major, ratio-minor) are
    the fastest-varying axis (reference: core/utils.py:1040-1080).
    """
    sy, sx, sz = _stride_triple(feature_stride)

    shifts_y = np.arange(0, feature_shape[0], anchor_stride) * sy
    shifts_x = np.arange(0, feature_shape[1], anchor_stride) * sx
    shifts_z = np.arange(0, feature_shape[2], anchor_stride) * sz
    gy, gx, gz = np.meshgrid(shifts_y, shifts_x, shifts_z, indexing="ij")

    if np.isscalar(scales):
        scales = [scales]
    if np.isscalar(ratios):
        ratios = [ratios]

    base = []
    for scale in scales:
        for ratio in ratios:
            height = width = float(scale)
            depth = float(scale) * float(ratio)
            depth = np.clip(depth, 0.5, max_depth) if max_depth is not None else max(0.5, depth)
            base.append([-height / 2, -width / 2, -depth / 2,
                         height / 2, width / 2, depth / 2])
    base = np.asarray(base, dtype=np.float32)  # [K, 6]

    shifts = np.stack(
        [gy.ravel(), gx.ravel(), gz.ravel(), gy.ravel(), gx.ravel(), gz.ravel()],
        axis=1,
    ).astype(np.float32)  # [cells, 6]

    anchors = base[None, :, :] + shifts[:, None, :]
    return anchors.reshape(-1, 6)


def distribute_scales(scales, num_levels: int) -> list[list[float]]:
    """Assign sorted scales to FPN levels (reference: core/utils.py:1099-1110).

    With n_scales >= L: near-even contiguous chunks, extras going to the lowest
    levels. With n_scales < L: level i gets scales[min(i, n-1)].
    """
    scales = sorted(list(scales))
    n = len(scales)
    out: list[list[float]] = []
    if n >= num_levels:
        per, extra = divmod(n, num_levels)
        start = 0
        for i in range(num_levels):
            end = start + per + (1 if i < extra else 0)
            out.append(scales[start:end])
            start = end
    else:
        for i in range(num_levels):
            out.append([scales[min(i, n - 1)]])
    return out


def generate_pyramid_anchors(scales, ratios, feature_shapes, feature_strides,
                             anchor_stride, max_depth=None, verbose: bool = False) -> np.ndarray:
    """All-level anchor pyramid in pixel coordinates. Returns [A_total, 6].

    Concatenation order: level-major, then scale, then the per-cell layout of
    generate_anchors — this must match the RPN head's flattened output order.
    Reference: core/utils.py:1084-1142.
    """
    num_levels = len(feature_shapes)
    level_scales = distribute_scales(scales, num_levels)

    parts = []
    for level in range(num_levels):
        stride = _stride_triple(feature_strides[level])
        for scale in level_scales[level]:
            parts.append(
                generate_anchors(scale, ratios, feature_shapes[level], stride,
                                 anchor_stride, max_depth)
            )
        if verbose:
            count = sum(p.shape[0] for p in parts)
            print(f"  P{level + 2}: shape={feature_shapes[level]} stride={stride} "
                  f"scales={level_scales[level]} (cum anchors={count})")
    return np.concatenate(parts, axis=0)


def anchors_per_location(scales, ratios, num_levels: int) -> list[int]:
    """Anchors per feature-map cell at each level (scales_at_level * n_ratios)."""
    level_scales = distribute_scales(scales, num_levels)
    return [len(ls) * len(list(ratios)) for ls in level_scales]


def normalized_pyramid_anchors(config, image_shape=None, voxel_z_over_y=None) -> np.ndarray:
    """Full pipeline: pixel anchors -> clip -> min sizes -> normalize /(H,W,D).

    Reference: core/models.py:3475-3528 (RPN.get_anchors): clips to the image,
    enforces y/x extents >= 1px and z extent >= 0.5px, then divides by
    (H, W, D). Returns float32 [A, 6] normalized anchors.
    """
    if image_shape is None:
        image_shape = config.IMAGE_SHAPE
    H, W, D = int(image_shape[0]), int(image_shape[1]), int(image_shape[2])
    feature_shapes = config.backbone_shapes(image_shape)

    ratios = list(config.RPN_ANCHOR_RATIOS)
    if voxel_z_over_y is not None and voxel_z_over_y != 1.0:
        # Anisotropic voxels: z-extent ratios are expressed relative to the
        # physical voxel size (reference: core/data_generators.py:760-811,
        # 1113-1140 rebuild anchors with VOXEL_Z_OVER_Y-derived z extents).
        ratios = [r / float(voxel_z_over_y) for r in ratios]

    anchors = generate_pyramid_anchors(
        config.RPN_ANCHOR_SCALES,
        ratios,
        feature_shapes,
        config.BACKBONE_STRIDES,
        config.RPN_ANCHOR_STRIDE,
        max_depth=D,
    )

    # Clip to image bounds: mins to [0, S-1], maxes to [1, S]
    # (reference: core/models.py:3496-3501).
    anchors[:, 0] = np.clip(anchors[:, 0], 0, H - 1)
    anchors[:, 1] = np.clip(anchors[:, 1], 0, W - 1)
    anchors[:, 2] = np.clip(anchors[:, 2], 0, D - 1)
    anchors[:, 3] = np.clip(anchors[:, 3], 1, H)
    anchors[:, 4] = np.clip(anchors[:, 4], 1, W)
    anchors[:, 5] = np.clip(anchors[:, 5], 1, D)

    # Min extents: 1px in y/x, 0.5px in z (clipping can zero out edge anchors).
    anchors[:, 3] = np.maximum(anchors[:, 3], anchors[:, 0] + 1.0)
    anchors[:, 4] = np.maximum(anchors[:, 4], anchors[:, 1] + 1.0)
    anchors[:, 5] = np.maximum(anchors[:, 5], anchors[:, 2] + 0.5)

    scale = np.array([H, W, D, H, W, D], dtype=np.float32)
    return np.clip(anchors / scale, 0.0, 1.0).astype(np.float32)


def bucket_image_shape(shape, xy_multiple: int = 64, z_multiple: int = 8):
    """Round a volume shape UP to the compile-bucket grid.

    XY must be multiples of 64 (the backbone's stride pyramid constraint,
    reference core/models.py:3173-3176); z rounds to sublane-friendly
    multiples of 8. Images are zero-padded up to the bucket and the true
    extent rides in image_meta's window — one compiled graph serves every
    volume in the bucket (the reference instead re-patches offline).
    """
    h, w, d = (int(v) for v in shape[:3])
    rh = max(xy_multiple, -(-h // xy_multiple) * xy_multiple)
    rw = max(xy_multiple, -(-w // xy_multiple) * xy_multiple)
    rd = max(z_multiple, -(-d // z_multiple) * z_multiple)
    return (rh, rw, rd)


class AnchorCache:
    """Per-shape normalized anchor pyramid cache (the reference's
    RPN._anchor_cache, core/models.py:3478-3528, generalized to buckets)."""

    def __init__(self, config, voxel_z_over_y=None):
        self.config = config
        self.voxel_z_over_y = voxel_z_over_y
        self._cache: dict[tuple, np.ndarray] = {}

    def get(self, image_shape) -> np.ndarray:
        key = tuple(int(v) for v in image_shape[:3])
        if key not in self._cache:
            self._cache[key] = normalized_pyramid_anchors(
                self.config, image_shape=key,
                voxel_z_over_y=self.voxel_z_over_y,
            )
        return self._cache[key]
