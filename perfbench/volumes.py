"""The benchmark's volume generator (a frozen copy of the port's synthetic
generator, numpy and scipy only) and the seeded pool a cell's batches are
drawn from.

``create_volume`` places random ellipsoids, cuboids and pyramids (base size
15, scale range 2x, random 3-axis rotation, z-squashed by
``voxel_z_over_y``) without overlap, adds Poisson, Gaussian and uniform
noise and scales to 8 bits. Unlike the port's copy it takes the number of
objects to place, so that every seed's pool holds the same number of
objects (the work of the per-ROI stages follows it). ``normalize_volume``
is the datasets' percentile clip, z-score and tanh.

``make_pool`` generates a few source volumes on the host and derives each
pool volume from one on the device by an orientation and a roll chosen by
the seed, which is far cheaper than generating every volume.
"""

from __future__ import annotations

import numpy as np
import torch

BASE_SIZE = 15
SCALE_RANGE = 2.0


def seeded_rng(seed: int, stream: int) -> np.random.RandomState:
    """RandomState for (seed, stream); any non-negative seed, however
    large."""
    return np.random.RandomState(
        np.random.SeedSequence([int(seed), int(stream)]).generate_state(4))


def _rotate_random(obj, rng):
    from scipy.ndimage import affine_transform

    obj = np.pad(obj, 1, mode="constant")
    rot = np.eye(3)
    for i, j in ((1, 2), (0, 2), (0, 1)):
        a = np.deg2rad(rng.uniform(0, 360))
        r = np.eye(3)
        r[i, i], r[i, j] = np.cos(a), -np.sin(a)
        r[j, i], r[j, j] = np.sin(a), np.cos(a)
        rot = r @ rot
    corners = np.array([[y, x, z] for y in (0, obj.shape[0])
                        for x in (0, obj.shape[1]) for z in (0, obj.shape[2])],
                       float)
    center_in = (np.asarray(obj.shape) - 1) / 2.0
    spans = (rot @ (corners - center_in).T).T
    out_shape = np.ceil(spans.max(0) - spans.min(0)).astype(int) + 1
    inv = rot.T
    offset = center_in - inv @ ((out_shape - 1) / 2.0)
    out = affine_transform(obj.astype(np.float32), inv, offset=offset,
                           output_shape=tuple(out_shape), order=1,
                           mode="constant", cval=0.0, prefilter=False)
    return (out >= 0.5).astype(np.uint8)


def _crop_to_content(obj):
    pos = np.where(obj > 0)
    if pos[0].size == 0:
        return obj[:1, :1, :1]
    return obj[tuple(slice(p.min(), p.max() + 1) for p in pos)]


def make_ellipsoid(rng, base=BASE_SIZE, srange=SCALE_RANGE):
    r = [max(1, int(base * rng.uniform(1 / srange, srange))) for _ in range(3)]
    m = 2 * max(r)
    c = m // 2
    zz, yy, xx = np.mgrid[0:m, 0:m, 0:m]
    vol = (((xx - c) / r[0]) ** 2 + ((yy - c) / r[1]) ** 2
           + ((zz - c) / r[2]) ** 2) <= 1
    return _crop_to_content(_rotate_random(vol.astype(np.uint8), rng))


def make_cuboid(rng, base=BASE_SIZE, srange=SCALE_RANGE):
    dims = [max(2, 2 * int(base * rng.uniform(1 / srange, srange)))
            for _ in range(3)]
    return _crop_to_content(_rotate_random(np.ones(dims, np.uint8), rng))


def make_pyramid(rng, base=BASE_SIZE, srange=SCALE_RANGE):
    ly, lx, lz = (max(2, 2 * int(base * rng.uniform(1 / srange, srange)))
                  for _ in range(3))
    pyr = np.zeros((ly, lx, lz), np.uint8)
    for z in range(lz):
        pyr[:int((1 - z / lz) * ly), :int((1 - z / lz) * lx), z] = 1
    return _crop_to_content(_rotate_random(pyr, rng))


SHAPES = (make_ellipsoid, make_cuboid, make_pyramid)


def create_volume(image_shape, rng, n_objects: int,
                  voxel_z_over_y: float = 1.0) -> np.ndarray:
    """One uint8 [Y, X, Z] volume with up to ``n_objects`` objects (fewer
    only where 100 placements in a row fail)."""
    k = max(float(voxel_z_over_y), 1.0)
    cap = min(image_shape[:2]) if k > 1.0 else min(image_shape)
    base = min(BASE_SIZE, max(2, cap // 4))
    img = np.zeros(image_shape)
    seg = np.zeros(image_shape, np.uint8)
    n = trials = 0
    while n < n_objects and trials <= 100:
        obj = SHAPES[rng.randint(len(SHAPES))](rng, base=base)
        if k > 1.0 and obj.shape[2] > 1:
            from scipy.ndimage import zoom

            obj = _crop_to_content((zoom(obj.astype(np.float32),
                                         (1.0, 1.0, 1.0 / k), order=1)
                                    >= 0.5).astype(np.uint8))
            if obj.max() == 0:
                trials += 1
                continue
        dy, dx, dz = (s // 2 for s in obj.shape)
        if (dy >= image_shape[0] // 2 or dx >= image_shape[1] // 2
                or dz >= image_shape[2] // 2):
            trials += 1
            continue
        cy = rng.randint(dy, image_shape[0] - dy)
        cx = rng.randint(dx, image_shape[1] - dx)
        cz = rng.randint(dz, image_shape[2] - dz)
        c = np.array(np.where(obj))
        c[0] = np.clip(c[0] + cy - dy, 0, image_shape[0] - 1)
        c[1] = np.clip(c[1] + cx - dx, 0, image_shape[1] - 1)
        c[2] = np.clip(c[2] + cz - dz, 0, image_shape[2] - 1)
        occ = np.unique(seg[c[0], c[1], c[2]])
        if occ.size != 1 or occ[0] != 0:
            trials += 1
            continue
        seg[c[0], c[1], c[2]] = n + 1
        img[c[0], c[1], c[2]] += rng.uniform(0.02, 0.10)
        n += 1
    img = rng.poisson(img * 10).astype(np.float64) / 10.0
    img = img + rng.normal(0, 0.05, img.shape) + rng.uniform(0, 0.01,
                                                             img.shape)
    span = img.max() - img.min()
    return (255 * (img - img.min()) / (span if span > 0 else 1.0)).astype(
        np.uint8)


def normalize_volume(image: np.ndarray) -> np.ndarray:
    """Percentile clip [1, 99], z-score, tanh(x / 2): float32 [..., 1]."""
    image = image.astype(np.float32)
    p1, p99 = np.percentile(image, [1, 99])
    image = np.clip(image, p1, p99)
    mean, std = image.mean(), image.std()
    image = (image - mean) / std if std > 0 else image - mean
    return np.tanh(image * 0.5)[..., None].astype(np.float32)


def orient(vol: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th of the 16 orientations of a [Y, X, Z, C] volume with a
    square y/x face: bit 0 flips y, bit 1 flips x, bit 2 swaps y and x,
    bit 3 flips z."""
    if k & 4:
        vol = vol.transpose(0, 1)
    dims = [a for a, bit in ((0, 1), (1, 2), (2, 8)) if k & bit]
    return torch.flip(vol, dims) if dims else vol


def make_pool(shape, objects, per_source: int, shift: int, source_seed: int,
              seed: int, device, voxel_z_over_y: float = 1.0) -> torch.Tensor:
    """[len(objects) * per_source, Y, X, Z, 1] float32 on ``device``.

    The sources (source i with ``objects[i]`` objects) come from
    ``source_seed``, the same for every run, so every seed's pool holds the
    same objects and the per-ROI work does not move with the seed. The seed
    picks each source's ``per_source`` distinct orientations and a roll of
    up to ``shift`` voxels in y and x for each pool volume: the same objects
    in other places and poses."""
    rng = seeded_rng(seed, 1 << 21)
    out = []
    for i, n_obj in enumerate(objects):
        vol = create_volume(tuple(shape), seeded_rng(source_seed, i),
                            int(n_obj), voxel_z_over_y)
        src = torch.from_numpy(normalize_volume(vol)).to(device)
        for k in rng.choice(16, size=per_source, replace=False):
            dy, dx = (int(v) for v in rng.randint(-shift, shift + 1, 2))
            out.append(torch.roll(orient(src, int(k)), (dy, dx), (0, 1))
                       .contiguous())
    return torch.stack(out)


def batch_order(seed: int, pool: int, batch: int):
    """Endless pool indices, ``batch`` at a time: each pass over the pool
    in a fresh seeded order."""
    rng = seeded_rng(seed, 1 << 20)
    buf = []
    while True:
        while len(buf) < batch:
            buf.extend(rng.permutation(pool).tolist())
        yield buf[:batch]
        buf = buf[batch:]
