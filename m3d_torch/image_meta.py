"""Canonical image metadata vector (port of m3d/image_meta.py).

Layout (reference: core/models.py:7462-7532 compose/parse_image_meta):

    [image_id(1), original_shape(4), image_shape(4), window(6), scale(1),
     active_class_ids(NUM_CLASSES)]
"""

from __future__ import annotations

import numpy as np
import torch


def compose_image_meta(image_id, original_image_shape, image_shape, window,
                       scale, active_class_ids) -> np.ndarray:
    """Pack image attributes into a flat float32 vector."""
    return np.asarray(
        [int(image_id)]
        + list(original_image_shape)
        + list(image_shape)
        + list(window)
        + [float(scale)]
        + list(active_class_ids),
        dtype=np.float32,
    )


def parse_image_meta(meta: torch.Tensor) -> dict[str, torch.Tensor]:
    """Unpack a [B, META] meta tensor into a dict of views."""
    return {
        "image_id": meta[:, 0],
        "original_image_shape": meta[:, 1:5],
        "image_shape": meta[:, 5:9],
        "window": meta[:, 9:15],
        "scale": meta[:, 15],
        "active_class_ids": meta[:, 16:],
    }


def default_meta(config, image_id: int = 0) -> np.ndarray:
    """Meta for an unpadded, unscaled image of the config's nominal shape."""
    H, W, D, C = (int(v) for v in config.IMAGE_SHAPE)
    shape4 = [H, W, D, C]
    window = [0, 0, 0, H, W, D]
    active = [1] * int(config.NUM_CLASSES)
    return compose_image_meta(image_id, shape4, shape4, window, 1.0, active)
