"""Mini-masks (port of m3d/utils/minimask.py): instance masks stored cropped
to their GT boxes and resized to a small cube (MINI_MASK_SHAPE), for
USE_MINI_MASK. Numpy on the host, on the port's own ``resize_trilinear``.
JAX's ``expand_mask`` has no caller there but its tests and is not ported.
"""

from __future__ import annotations

import numpy as np

from m3d_torch.utils.unmold import resize_trilinear


def minimize_mask(bbox, mask, mini_shape):
    """bbox: [N, 6] pixel boxes; mask: [H, W, D, N]. Returns
    [mini_h, mini_w, mini_d, N] bool."""
    n = mask.shape[-1]
    mini = np.zeros(tuple(mini_shape) + (n,), bool)
    for i in range(n):
        y1, x1, z1, y2, x2, z2 = (int(v) for v in bbox[i][:6])
        crop = mask[y1:y2, x1:x2, z1:z2, i].astype(np.float32)
        if crop.size == 0:
            continue
        mini[..., i] = resize_trilinear(crop, mini_shape) >= 0.5
    return mini

