"""Inference inputs (port of ``pad_to`` and the inference mode of
``MrcnnGenerator`` in m3d/data/generators.py).

A volume is zero-padded up to its compile bucket (XY a multiple of 64, z a
multiple of 8) and its anchors come from a per-bucket cache; the true extent
rides in the meta window so evaluation can crop back.
"""

from __future__ import annotations

import numpy as np

from m3d_torch.anchors import AnchorCache, bucket_image_shape
from m3d_torch.image_meta import compose_image_meta


def pad_to(arr, n, axis=0):
    """Zero-pad (or truncate) arr along axis to length n."""
    arr = np.asarray(arr)
    cur = arr.shape[axis]
    if cur == n:
        return arr
    if cur > n:
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(0, n)
        return arr[tuple(sl)]
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, n - cur)
    return np.pad(arr, pad)


class MrcnnGenerator:
    """Single-image inference inputs over a dataset (the inference mode of
    JAX's generator; reference: core/data_generators.py:1220-1283)."""

    def __init__(self, dataset, config):
        self.dataset = dataset
        self.config = config
        self._anchor_cache = AnchorCache(
            config,
            voxel_z_over_y=float(getattr(config, "VOXEL_Z_OVER_Y", 1.0)))

    def get_input_prediction(self, image_id):
        """{"image": [1, PH, PW, PD, 1] float32, "image_meta": [1, META],
        "anchors": [A, 6]} for the image padded up to its bucket."""
        image = self.dataset.load_image(image_id)
        H, W, D = image.shape[:3]
        PH, PW, PD = bucket_image_shape((H, W, D))
        if (PH, PW, PD) != (H, W, D):
            image = np.pad(
                image, [(0, PH - H), (0, PW - W), (0, PD - D), (0, 0)])
        meta = compose_image_meta(
            image_id, (H, W, D, 1), (PH, PW, PD, 1), (0, 0, 0, H, W, D), 1.0,
            [1] * int(self.config.NUM_CLASSES),
        )
        return {
            "image": image[None].astype(np.float32),
            "image_meta": meta[None],
            "anchors": self._anchor_cache.get((PH, PW, PD)),
        }
