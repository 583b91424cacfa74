"""Synthetic labeled volumes and their normalization (port of
``create_volume`` in m3d/data/synthetic.py and ``normalize_volume`` in
m3d/data/datasets.py; numpy and scipy only, no pandas).

Random ellipsoids / cuboids / pyramids (base size 15, scale range 2x, random
3-axis rotation), non-overlapping placement, Poisson + Gaussian + uniform
background noise, 8-bit volumes. The same seed gives the same volume as the
JAX package's generator (tests/test_torch_host.py checks it).
"""

from __future__ import annotations

import numpy as np

BASE_SIZE = 15
SCALE_RANGE = 2.0
NUM_MAX_OBJECTS = 20


def _rotate_random(obj: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Random 3-axis rotation of a binary solid.

    The reference chains three scipy ``rotate(reshape=True)`` calls
    (generate_data.py), each of which runs a cubic-spline affine per 2-D
    slice — ~250 ms per object. Composing the three rotations into ONE 3-D
    affine with linear interpolation is ~30x faster and equivalent for
    binary occupancy masks (thresholded at 0.5).
    """
    from scipy.ndimage import affine_transform

    obj = np.pad(obj, 1, mode="constant")
    rot = np.eye(3)
    for axes in ((1, 2), (0, 2), (0, 1)):
        a = np.deg2rad(rng.uniform(0, 360))
        r = np.eye(3)
        (i, j) = axes
        r[i, i] = np.cos(a); r[i, j] = -np.sin(a)
        r[j, i] = np.sin(a); r[j, j] = np.cos(a)
        rot = r @ rot
    # Output bounding box of the rotated input extents (reshape=True analog).
    corners = np.array([[y, x, z] for y in (0, obj.shape[0])
                        for x in (0, obj.shape[1]) for z in (0, obj.shape[2])],
                       float)
    center_in = (np.asarray(obj.shape) - 1) / 2.0
    spans = (rot @ (corners - center_in).T).T
    out_shape = np.ceil(spans.max(0) - spans.min(0)).astype(int) + 1
    center_out = (out_shape - 1) / 2.0
    # affine_transform maps output coords -> input coords: inverse rotation.
    inv = rot.T
    offset = center_in - inv @ center_out
    out = affine_transform(obj.astype(np.float32), inv, offset=offset,
                           output_shape=tuple(out_shape), order=1,
                           mode="constant", cval=0.0, prefilter=False)
    return (out >= 0.5).astype(np.uint8)


def _crop_to_content(obj: np.ndarray) -> np.ndarray:
    pos = np.where(obj > 0)
    if pos[0].size == 0:
        return obj[:1, :1, :1]
    sl = tuple(slice(p.min(), p.max() + 1) for p in pos)
    return obj[sl]


def make_ellipsoid(rng, base=BASE_SIZE, srange=SCALE_RANGE):
    r = [max(1, int(base * rng.uniform(1 / srange, srange))) for _ in range(3)]
    m = 2 * max(r)
    c = m // 2
    zz, yy, xx = np.mgrid[0:m, 0:m, 0:m]
    # axes named (y, x, z) like the reference's loop order
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
        ys = int((1 - z / lz) * ly)
        xs = int((1 - z / lz) * lx)
        pyr[:ys, :xs, z] = 1
    return _crop_to_content(_rotate_random(pyr, rng))


SHAPE_FACTORIES = [(make_ellipsoid, 1), (make_cuboid, 2), (make_pyramid, 3)]


def _apply_noise(img, rng):
    out = rng.poisson(img * 10).astype(np.float64) / 10.0
    out = out + rng.normal(0, 0.05, img.shape)
    out = out + rng.uniform(0, 0.01, img.shape)
    return out


def create_volume(image_shape, rng, num_max_objects=NUM_MAX_OBJECTS,
                  classes=None, base=None, voxel_z_over_y: float = 1.0):
    """Fabricate one labeled volume.

    Returns (img_uint8 [Y,X,Z], seg_uint8, masks [Y,X,Z,N] uint8,
    boxes [N,6] int, class_ids [N]).

    ``base`` scales object size; defaults to the reference's 15 but is
    capped so objects fit shallow (anisotropic) volumes.

    ``voxel_z_over_y`` > 1 fabricates anisotropic-acquisition objects (the
    rats/HeLa regime: z voxels physically taller than xy, so a round cell
    spans ~1/k as many z voxels — reference configs VOXEL_Z_OVER_Y): object
    size follows the XY extents and each object is z-squashed by the factor.
    """
    classes = classes if classes is not None else SHAPE_FACTORIES
    k = max(float(voxel_z_over_y), 1.0)
    if base is None:
        cap_src = min(image_shape[:2]) if k > 1.0 else min(image_shape)
        base = min(BASE_SIZE, max(2, cap_src // 4))
    img = np.zeros(image_shape)
    seg = np.zeros(image_shape, np.uint8)
    n_target = rng.randint(3, num_max_objects + 1)
    masks = np.zeros((*image_shape, n_target), np.uint8)
    boxes, class_ids = [], []

    n = 0
    trials = 0
    while n < n_target and trials <= 100:
        factory, cls = classes[rng.randint(len(classes))]
        obj = factory(rng, base=base)
        if k > 1.0 and obj.shape[2] > 1:
            from scipy.ndimage import zoom

            obj = (zoom(obj.astype(np.float32), (1.0, 1.0, 1.0 / k),
                        order=1) >= 0.5).astype(np.uint8)
            obj = _crop_to_content(obj)
            if obj.max() == 0:
                trials += 1
                continue
        dy, dx, dz = (s // 2 for s in obj.shape)
        if (dy >= image_shape[0] // 2 or dx >= image_shape[1] // 2
                or dz >= image_shape[2] // 2):
            trials += 1
            continue
        cy = rng.randint(dy, image_shape[0] - dy - 1 + 1)
        cx = rng.randint(dx, image_shape[1] - dx - 1 + 1)
        cz = rng.randint(dz, image_shape[2] - dz - 1 + 1)
        coords = np.array(np.where(obj))
        coords[0] += cy - dy
        coords[1] += cx - dx
        coords[2] += cz - dz
        coords[0] = np.clip(coords[0], 0, image_shape[0] - 1)
        coords[1] = np.clip(coords[1], 0, image_shape[1] - 1)
        coords[2] = np.clip(coords[2], 0, image_shape[2] - 1)

        occupied = np.unique(seg[coords[0], coords[1], coords[2]])
        if occupied.size != 1 or occupied[0] != 0:
            trials += 1
            continue

        seg[coords[0], coords[1], coords[2]] = n + 1
        img[coords[0], coords[1], coords[2]] += rng.uniform(0.02, 0.10)
        masks[coords[0], coords[1], coords[2], n] = 1

        ys, xs, zs = coords
        boxes.append([ys.min(), xs.min(), zs.min(),
                      ys.max() + 1, xs.max() + 1, zs.max() + 1])
        class_ids.append(cls)
        n += 1

    masks = masks[..., :n]
    img = _apply_noise(img, rng)
    span = img.max() - img.min()
    img = 255 * (img - img.min()) / (span if span > 0 else 1.0)
    return (img.astype(np.uint8), seg, masks,
            np.asarray(boxes, np.int64).reshape(-1, 6),
            np.asarray(class_ids, np.int64))


def normalize_volume(image: np.ndarray) -> np.ndarray:
    """Percentile clip [1,99] -> z-score -> tanh(x*0.5), float32 [...,1].

    Reference: core/data_generators.py:1603-1630 (ToyDataset.load_image).
    """
    image = image.astype(np.float32)
    p1, p99 = np.percentile(image, [1, 99])
    image = np.clip(image, p1, p99)
    mean, std = image.mean(), image.std()
    image = (image - mean) / std if std > 0 else image - mean
    image = np.tanh(image * 0.5)
    return image[..., np.newaxis].astype(np.float32, copy=False)


def make_volumes(batch: int, size: int, first_seed: int = 1000):
    """The bench workload: ``batch`` normalized cubic volumes from seeds
    first_seed + i, with their GT pixel boxes. Returns ([B, S, S, S, 1]
    float32, list of [n_i, 6] float32)."""
    vols, gt_boxes = [], []
    for i in range(batch):
        rng = np.random.RandomState(first_seed + i)
        img, _seg, _masks, boxes, _cls = create_volume((size, size, size), rng)
        vols.append(normalize_volume(img))
        gt_boxes.append(np.asarray(boxes, np.float32))
    return np.stack(vols), gt_boxes
