"""Dataset registry and loaders (port of ``_pick_column``, ``Dataset``,
``ToyDataset`` and ``ToyHeadDataset`` in m3d/data/datasets.py; no pandas).

``ToyDataset`` reads ``datasets/{train,test}.csv`` manifests (separator
sniffed among ``,;\\t``, fuzzy column matching), TIFF images with the
reference's (Z, Y, X) -> (Y, X, Z) transpose and the percentile-clip +
z-score + tanh(x * 0.5) normalization, boxes from ``.dat`` files with the
reference's column reorder [2, 3, 1, 5, 6, 4], and masks from bz2 pickles.
``ToyHeadDataset`` reads TARGET_GENERATION's ``datasets/{train,test}.csv``
manifests and their npz artifacts, bit-packed target masks included.
"""

from __future__ import annotations

import bz2
import copy
import csv
import os
import pickle

import numpy as np

from m3d_torch.data.synthetic import normalize_volume
from m3d_torch.utils.tiffio import imread_volume


def _pick_column(columns, *candidates, required=True):
    cols = {c.lower(): c for c in columns}
    for cand in candidates:
        k = cand.lower()
        if k in cols:
            return cols[k]
        for lc, orig in cols.items():
            if k in lc:
                return orig
    if required:
        raise KeyError(f"none of columns {candidates} found in {list(columns)}")
    return None


def read_manifest(path: str) -> tuple[list[str], list[dict]]:
    """(columns, rows) of a CSV manifest whose separator is sniffed from its
    header line among ``,``, ``;`` and tab, as pandas'
    ``read_csv(sep=None, engine="python")`` sniffs it."""
    with open(path, newline="") as f:
        text = f.read()
    header = text.splitlines()[0] if text else ""
    try:
        dialect = csv.Sniffer().sniff(header, delimiters=",;\t")
    except csv.Error:  # one column: no separator to find
        dialect = csv.excel
    rows = [r for r in csv.reader(text.splitlines(), dialect) if r]
    if not rows:
        raise ValueError(f"{path}: empty manifest")
    columns = rows[0]
    return columns, [dict(zip(columns, r)) for r in rows[1:]]


class Dataset:
    """Image/class registry (reference: core/data_generators.py:1403-1556)."""

    def __init__(self):
        self.image_info: list[dict] = []
        self.class_info: list[dict] = [
            {"source": "", "id": 0, "name": "BG"}
        ]

    def add_class(self, source, class_id, class_name):
        for info in self.class_info:
            if info["source"] == source and info["id"] == class_id:
                return
        self.class_info.append(
            {"source": source, "id": class_id, "name": class_name}
        )

    def add_image(self, source, image_id, path, **kwargs):
        info = {"id": image_id, "source": source, "path": path}
        info.update(kwargs)
        self.image_info.append(info)

    def prepare(self):
        self.num_classes = len(self.class_info)
        self.class_ids = np.arange(self.num_classes)
        self.class_names = [c["name"] for c in self.class_info]
        self.num_images = len(self.image_info)
        self.image_ids = np.arange(self.num_images)

    def subset(self, ids):
        """Shallow-copy view over a subset of image ids."""
        view = copy.copy(self)
        view.image_info = [self.image_info[i] for i in ids]
        view.prepare()
        return view

    def filter_positive(self):
        """Drop images with no valid GT box or an unreadable box file,
        reading only the cheap box files (reference:
        core/data_generators.py:1431-1473)."""
        keep = []
        for i in range(len(self.image_info)):
            try:
                boxes, _, _ = self.load_data(i, masks_needed=False)
            except Exception:  # noqa: BLE001 — skip unreadable samples
                continue
            if boxes.shape[0]:
                keep.append(i)
        return self.subset(keep)

    # To be provided by subclasses
    def load_image(self, image_id):
        raise NotImplementedError

    def load_data(self, image_id, masks_needed=True):
        raise NotImplementedError


class ToyDataset(Dataset):
    """Raw-volume dataset from datasets/{train,test}.csv manifests."""

    def load_dataset(self, data_dir, is_train=True, class_names=("neuron",)):
        for idx, name in enumerate(class_names):
            self.add_class("dataset", idx + 1, name)
        split = "train" if is_train else "test"
        columns, rows = read_manifest(
            os.path.join(data_dir, "datasets", f"{split}.csv"))

        col_images = _pick_column(columns, "images", "image", "img", "path")
        col_segs = _pick_column(columns, "segs", "seg", "labels", required=False)
        col_cabs = _pick_column(columns, "cabs", "cab", "boxes")
        col_masks = _pick_column(columns, "masks", "mask")

        for i, row in enumerate(rows):
            self.add_image(
                "dataset",
                image_id=i,
                path=row[col_images],
                seg_path=row[col_segs] if col_segs else None,
                cab_path=row[col_cabs],
                m_path=row[col_masks],
            )

    def load_image(self, image_id):
        info = self.image_info[image_id]
        image = imread_volume(info["path"])
        # Reference convention: file treated as (Z, Y, X) -> (Y, X, Z)
        # (core/data_generators.py:1609-1610).
        image = np.transpose(image, (1, 2, 0))
        return normalize_volume(image)

    def load_data(self, image_id, masks_needed=True):
        """Returns (boxes [N,6] int32 px, class_ids [N] int32, masks [H,W,D,N])."""
        info = self.image_info[image_id]
        cabs = np.loadtxt(info["cab_path"], ndmin=2, dtype=np.int32)
        if cabs.size:
            # Column reorder matching the loader's axis convention
            # (reference: core/data_generators.py:1648).
            boxes = cabs[:, [2, 3, 1, 5, 6, 4]]
            class_ids = cabs[:, 0]
            # The synthetic generator writes shape classes 1..3 while most
            # configs declare a single foreground class (NUM_CLASSES=2):
            # extra ids fold into the last registered class.
            nc = getattr(self, "num_classes", 0)
            if nc:
                class_ids = np.clip(class_ids, 0, nc - 1)
            valid = (
                (boxes[:, 3] > boxes[:, 0])
                & (boxes[:, 4] > boxes[:, 1])
                & (boxes[:, 5] > boxes[:, 2])
                & (boxes[:, :3] >= 0).all(axis=1)
            )
            boxes, class_ids = boxes[valid], class_ids[valid]
        else:
            boxes = np.zeros((0, 6), np.int32)
            class_ids = np.zeros((0,), np.int32)

        if not masks_needed:
            return boxes, class_ids, None

        if boxes.shape[0] == 0:
            img = self.load_image(image_id)
            masks = np.zeros((*img.shape[:3], 0), np.float32)
            return boxes, class_ids, masks

        # The pickles are the dataset's own files (synthetic.write_volume).
        with bz2.BZ2File(info["m_path"], "rb") as f:
            m = pickle.load(f)
        masks = np.transpose(m, (1, 2, 0, 3)).astype(np.float32, copy=False)

        if masks.shape[-1] != boxes.shape[0]:
            n = min(masks.shape[-1], boxes.shape[0])
            masks, boxes, class_ids = masks[..., :n], boxes[:n], class_ids[:n]
        return boxes, class_ids, masks


class ToyHeadDataset(Dataset):
    """Pre-generated head-target artifacts written by target generation
    (reference: core/data_generators.py:1781-1866). Manifest columns, by
    name or alias: rois, rois_aligned (ra), mask_aligned (ma),
    target_class_ids (tci), target_bbox (tb), target_mask (tm), each a
    path to an .npz (or .npy) file."""

    def load_dataset(self, data_dir, is_train=True):
        self.add_class("dataset", 1, "neuron")
        split = "train" if is_train else "test"
        columns, rows = read_manifest(
            os.path.join(data_dir, "datasets", f"{split}.csv"))
        cols = {
            "rois": _pick_column(columns, "rois"),
            "ra": _pick_column(columns, "rois_aligned", "ra"),
            "ma": _pick_column(columns, "mask_aligned", "ma"),
            "tci": _pick_column(columns, "target_class_ids", "tci"),
            "tb": _pick_column(columns, "target_bbox", "tb"),
            "tm": _pick_column(columns, "target_mask", "tm"),
        }
        for i, row in enumerate(rows):
            self.add_image("dataset", image_id=i, path=row[cols["rois"]],
                           **{k: row[c] for k, c in cols.items()})

    @staticmethod
    def _load_array(path):
        """The first array of an .npz, or an .npy."""
        if str(path).endswith(".npz"):
            with np.load(path, allow_pickle=True) as z:
                return z[list(z.keys())[0]]
        return np.load(path, allow_pickle=True)

    @staticmethod
    def _unpack_mask(arr, shape):
        """Decode bit-packed masks (reference:
        core/data_generators.py:1908-1921)."""
        if arr.dtype == np.uint8 and arr.ndim == 1:
            bits = np.unpackbits(arr, count=int(np.prod(shape)))
            return bits.reshape(shape).astype(np.float32)
        return arr.astype(np.float32)

    def load_data(self, image_id):
        """The six target arrays of one image, as a dict."""
        info = self.image_info[image_id]
        tm = self._load_array(info["tm"])
        if tm.dtype == np.uint8 and tm.ndim == 1:
            # Bit-packed: the shape is stored beside the bits.
            with np.load(str(info["tm"]), allow_pickle=True) as z:
                if "shape" not in z:
                    raise ValueError(f"packed mask without shape: "
                                     f"{info['tm']}")
                tm = self._unpack_mask(z["mask"], tuple(z["shape"]))
        else:
            tm = tm.astype(np.float32)
        return {
            "rois": self._load_array(info["rois"]).astype(np.float32),
            "rois_aligned": self._load_array(info["ra"]).astype(np.float32),
            "mask_aligned": self._load_array(info["ma"]).astype(np.float32),
            "target_class_ids": self._load_array(info["tci"]).astype(
                np.int32),
            "target_bbox": self._load_array(info["tb"]).astype(np.float32),
            "target_mask": tm,
        }

    def filter_by_positive_count(self, min_positive: int = 1):
        """Keep the images with at least ``min_positive`` positive
        targets (unreadable ones are dropped)."""
        keep = []
        for i in range(len(self.image_info)):
            try:
                tci = self._load_array(self.image_info[i]["tci"])
            except Exception:  # noqa: BLE001 — skip unreadable samples
                continue
            if int((np.asarray(tci) > 0).sum()) >= min_positive:
                keep.append(i)
        return self.subset(keep)
