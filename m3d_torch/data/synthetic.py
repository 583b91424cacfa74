"""Synthetic labeled volumes, their on-disk dataset tree, and their
normalization (port of m3d/data/synthetic.py and of ``normalize_volume`` in
m3d/data/datasets.py; numpy and scipy only, no pandas, no PIL).

Random ellipsoids / cuboids / pyramids (base size 15, scale range 2x, random
3-axis rotation), non-overlapping placement, Poisson + Gaussian + uniform
background noise, 8-bit volumes. The same seed gives the same volume, and
``generate_experiment`` the same files, as the JAX package's generator
(tests/test_torch_host.py, tests/test_torch_data.py):

  images/NNNNNN.tiff           uint8 volume, (Z, Y, X) pages
  seg/NNNNNN.tiff              uint8 instance-label volume
  masks/NNNNNN.pickle          bz2-compressed pickle, float64 (Z, Y, X, N)
  classes_and_boxes/NNNNNN.dat lines: cls  z1 y1 x1 z2 y2 x2 (tab-separated)
  csvs/NNNNNN.csv              per-object stats
  datasets/{train,test}.csv    manifests (split_dataset)

    python -m m3d_torch.data.synthetic --train_dir DIR --train_image_nb N \
        --image_size S [--image_depth D] [--seed K] [--split]
"""

from __future__ import annotations

import argparse
import bz2
import csv
import os
import pickle

import numpy as np

from m3d_torch.utils.tiffio import imwrite_volume

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


def write_volume(out_dir: str, name: str, img, seg, masks, boxes, class_ids):
    """Write one volume in the reference's on-disk formats.

    The loader convention (core/data_generators.py:1603-1716) treats TIFFs and
    mask pickles as (Z, Y, X[, N]) z-stacks — true for real microscopy — and
    reads .dat columns with the reorder [2,3,1,5,6,4]. The reference's own
    generator writes (Y, X, Z) arrays, which only round-trips because its
    synthetic volumes are cubes; we write genuinely (Z, Y, X)-ordered files so
    anisotropic synthetic volumes load correctly too.
    """
    imwrite_volume(os.path.join(out_dir, "images", f"{name}.tiff"),
                   np.transpose(img, (2, 0, 1)))
    imwrite_volume(os.path.join(out_dir, "seg", f"{name}.tiff"),
                   np.transpose(seg, (2, 0, 1)))
    with bz2.BZ2File(os.path.join(out_dir, "masks", f"{name}.pickle"), "w") as f:
        pickle.dump(np.transpose(masks, (2, 0, 1, 3)).astype(np.float64), f)
    # .dat column order (cls, z1, y1, x1, z2, y2, x2): the loader's
    # [2,3,1,5,6,4] reorder then yields (y1,x1,z1,y2,x2,z2).
    with open(os.path.join(out_dir, "classes_and_boxes", f"{name}.dat"), "w") as f:
        for cls, b in zip(class_ids, boxes):
            y1, x1, z1, y2, x2, z2 = b
            f.write(f"{cls}\t{z1}\t{y1}\t{x1}\t{z2}\t{y2}\t{x2}\n")
    # per-volume stats CSV (columns mirror generate_data.py:63-79)
    with open(os.path.join(out_dir, "csvs", f"{name}.csv"), "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["", "image", "label", "class", "noise",
                     "y1", "x1", "z1", "y2", "x2", "z2", "ryx", "ryz", "rxz"])
        for i, (cls, b) in enumerate(zip(class_ids, boxes)):
            wr.writerow([i, name, i + 1, cls, 0.0, *b, 1.0, 1.0, 1.0])


def generate_experiment(train_image_nb: int, image_size, train_dir: str,
                        seed: int = 0, image_depth=None,
                        voxel_z_over_y: float = 1.0):
    """Generate a dataset directory tree (reference: generate_data.py:200-220).

    ``voxel_z_over_y`` > 1 generates anisotropic-acquisition volumes
    (rats/HeLa regime — objects sized by XY, z-squashed by the factor)."""
    for sub in ("classes_and_boxes", "seg", "masks", "images", "csvs"):
        os.makedirs(os.path.join(train_dir, sub), exist_ok=True)
    depth = image_depth or image_size
    image_shape = (image_size, image_size, depth)
    for i in range(train_image_nb):
        rng = np.random.RandomState(seed + i)
        name = str(i + 1).zfill(6)
        write_volume(train_dir, name,
                     *create_volume(image_shape, rng,
                                    voxel_z_over_y=voxel_z_over_y))
    return train_dir


def split_dataset(data_dir: str, test_ratio: float = 0.2):
    """Write datasets/{train,test}.csv manifests (reference: generate_datasets.py)."""
    names = sorted(
        os.path.splitext(f)[0] for f in os.listdir(os.path.join(data_dir, "images"))
    )
    perm = np.random.RandomState(0).permutation(len(names))
    n_test = max(1, int(len(names) * test_ratio)) if len(names) > 1 else 0
    splits = {
        "test": [names[i] for i in perm[:n_test]],
        "train": [names[i] for i in perm[n_test:]],
    }
    os.makedirs(os.path.join(data_dir, "datasets"), exist_ok=True)
    for split, split_names in splits.items():
        path = os.path.join(data_dir, "datasets", f"{split}.csv")
        with open(path, "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(["names", "images", "segs", "cabs", "masks"])
            for nm in split_names:
                wr.writerow([
                    nm,
                    os.path.join(data_dir, "images", f"{nm}.tiff"),
                    os.path.join(data_dir, "seg", f"{nm}.tiff"),
                    os.path.join(data_dir, "classes_and_boxes", f"{nm}.dat"),
                    os.path.join(data_dir, "masks", f"{nm}.pickle"),
                ])
    return data_dir


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Write a synthetic labeled-volume dataset tree")
    parser.add_argument("--train_dir", type=str, default="./data/")
    parser.add_argument("--train_image_nb", type=int, default=100)
    parser.add_argument("--image_size", type=int, default=128)
    parser.add_argument("--image_depth", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--voxel_z_over_y", type=float, default=1.0)
    parser.add_argument("--split", action="store_true",
                        help="also write datasets/{train,test}.csv")
    args = parser.parse_args(argv)
    generate_experiment(args.train_image_nb, args.image_size, args.train_dir,
                        args.seed, args.image_depth, args.voxel_z_over_y)
    if args.split:
        split_dataset(args.train_dir)


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


def proposal_like_boxes(rng: np.random.RandomState, n: int,
                        per_object: int = 100) -> np.ndarray:
    """[n, 6] float32 normalized boxes clustered the way RPN proposals
    cluster around objects in a thin volume (256 x 256 x 12, as the hela
    configs see it): one object per ``per_object`` boxes, each box the
    object's box jittered by ~15 % of its size, so that many pairs overlap
    above an NMS threshold of 0.7 and suppression chains run long."""
    objects = max(n // per_object, 1)
    c = rng.uniform(0.0, 1.0, (objects, 3)).astype(np.float32)
    size = np.stack([rng.uniform(0.02, 0.08, objects),
                     rng.uniform(0.02, 0.08, objects),
                     rng.uniform(0.2, 0.6, objects)], -1).astype(np.float32)
    k = rng.randint(0, objects, n)
    jit = rng.normal(0, 0.15, (n, 3)).astype(np.float32) * size[k]
    lo = np.clip(c[k] - size[k] / 2 + jit, 0.0, 1.0)
    hi = np.clip(lo + size[k] * rng.uniform(0.85, 1.15, (n, 3)), 0.0, 1.0)
    return np.concatenate([lo, np.maximum(hi, lo + 1e-3)],
                          -1).astype(np.float32)


if __name__ == "__main__":
    main()
