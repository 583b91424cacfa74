"""Batch generators (port of m3d/data/generators.py): host numpy pipelines
feeding the device.

- ``RPNGenerator``: RPN training batches (image, rpn_match, rpn_bbox) with
  the augmentations, GT jitter and ATSS targets; e2e batches and
  single-image targeting batches with GT padded to MAX_GT_INSTANCES
  (``pad_to``). Same RandomState calls in the same order as JAX's, so a
  seed gives the same batches.
- ``MrcnnGenerator``: full-training batches (GT with the augmentations,
  RPN targets from the un-jittered GT) and single-image inference inputs.
  A volume is zero-padded up to its bucket (XY a multiple of 64, z a
  multiple of 8) and its anchors come from a per-bucket cache; the true
  extent rides in the meta window so evaluation can crop back.
- ``HeadGenerator``: batches of TARGET_GENERATION's artifacts, with
  weak-positive demotion by mask coverage, optional ROI shuffling and
  positive balancing, and a nearest resize where the artifacts' pool
  differs from the config's (``nearest_resize_3d``).
- ``prefetch_to_device``: a queue of batches already on the device,
  copied from pinned host memory without blocking (``to_device``).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from m3d_torch.anchors import (AnchorCache, bucket_image_shape,
                               normalized_pyramid_anchors)
from m3d_torch.data.augment import apply_minimal_augs_3d, jitter_boxes_3d
from m3d_torch.data.rpn_targets import build_rpn_targets
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


def nearest_resize_3d(vol, out_shape):
    """Nearest-neighbour spatial resize of [..., H, W, D, C] blocks (adapts
    pre-generated aligned features to the config's pool sizes; reference:
    core/data_generators.py:385-423)."""
    vol = np.asarray(vol)
    h, w, d = vol.shape[-4:-1]
    oh, ow, od = out_shape
    iy = np.minimum((np.arange(oh) * h / oh).astype(int), h - 1)
    ix = np.minimum((np.arange(ow) * w / ow).astype(int), w - 1)
    iz = np.minimum((np.arange(od) * d / od).astype(int), d - 1)
    return vol[..., iy[:, None, None], ix[None, :, None], iz[None, None, :], :]


class RPNGenerator:
    """Endless iterator over batches: mode "training" gives {image,
    rpn_match, rpn_bbox}; modes "e2e" and "targeting" (batch size 1, no
    augmentation) give {image, image_meta, gt_class_ids, gt_boxes,
    gt_masks} with GT padded to MAX_GT_INSTANCES and boxes normalized.
    ``augment`` None follows AUGMENT (training mode only, as in JAX);
    True/False override it."""

    MODES = ("training", "e2e", "targeting")

    def __init__(self, dataset, config, mode: str, shuffle=True,
                 seed: int = 0, telemetry=None, augment=None):
        self.mode = mode
        if self.mode not in self.MODES:
            raise ValueError(f"RPNGenerator mode {self.mode!r}: only "
                             f"{self.MODES} are ported (ROADMAP.md §1)")
        self.dataset = dataset
        self.config = config
        self.shuffle = shuffle
        self.telemetry = telemetry
        self.augment = augment
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.batch_size = (1 if mode == "targeting"
                           else int(config.BATCH_SIZE))
        self.anchors = normalized_pyramid_anchors(
            config, voxel_z_over_y=float(getattr(config, "VOXEL_Z_OVER_Y",
                                                 1.0)))
        self._order = np.arange(len(dataset.image_info))

    def reset(self):
        """Restore the rng and order, so a validation pass draws the same
        batches every epoch."""
        self.rng = np.random.RandomState(self.seed)
        self._order = np.arange(len(self.dataset.image_info))
        return self

    def __len__(self):
        return max(1, len(self.dataset.image_info) // self.batch_size)

    def load_image_gt(self, image_id, augment=None):
        """(image [H, W, D, 1], boxes [N, 6] float32 px, class_ids, masks)."""
        cfg = self.config
        image = self.dataset.load_image(image_id)
        boxes, class_ids, masks = self.dataset.load_data(image_id)
        boxes = boxes.astype(np.float32)
        if self.augment is not None:
            do_aug = self.augment
        else:
            do_aug = cfg.AUGMENT if augment is None else augment
        if do_aug and self.mode == "training":
            image, boxes, masks = apply_minimal_augs_3d(image, boxes, masks,
                                                        cfg, rng=self.rng)
        return image, boxes, class_ids, masks

    def _sample_training(self, image_id):
        cfg = self.config
        image, boxes, class_ids, _ = self.load_image_gt(image_id)
        target_boxes = boxes
        if getattr(cfg, "RPN_AUGMENT_GT", False) and boxes.size:
            target_boxes = jitter_boxes_3d(
                boxes, count=int(cfg.RPN_GT_JITTER_PER_BOX),
                scale_sigma=float(cfg.RPN_GT_JITTER_SCALE_SIGMA),
                trans=tuple(cfg.RPN_GT_JITTER_TRANS),
                img_shape=image.shape[:3],
                iou_thr=float(cfg.RPN_GT_JITTER_IOU_THR), rng=self.rng)
        rpn_match, rpn_bbox = build_rpn_targets(
            self.anchors, class_ids, target_boxes, cfg, rng=self.rng,
            telemetry=self.telemetry)
        return image, rpn_match, rpn_bbox

    def _sample_gt(self, image_id, augment=False):
        """GT sample with normalized boxes, padded to MAX_GT_INSTANCES."""
        cfg = self.config
        image, boxes, class_ids, masks = self.load_image_gt(image_id,
                                                            augment=augment)
        H, W, D = image.shape[:3]
        scale = np.array([H, W, D, H, W, D], np.float32)
        boxes_norm = (np.clip(boxes / scale, 0.0, 1.0) if boxes.size
                      else boxes.reshape(0, 6))
        G = int(cfg.MAX_GT_INSTANCES)
        meta = compose_image_meta(image_id, (H, W, D, 1), (H, W, D, 1),
                                  (0, 0, 0, H, W, D), 1.0,
                                  [1] * int(cfg.NUM_CLASSES))
        if masks is None:
            masks = np.zeros((H, W, D, 0), np.float32)
        if getattr(cfg, "USE_MINI_MASK", False):
            from m3d_torch.utils.minimask import minimize_mask

            masks = minimize_mask(boxes.astype(np.int32), masks,
                                  tuple(int(v) for v in cfg.MINI_MASK_SHAPE))
        return {
            "image": image.astype(np.float32),
            "image_meta": meta,
            "gt_class_ids": pad_to(class_ids.astype(np.int32), G),
            "gt_boxes": pad_to(boxes_norm.astype(np.float32), G),
            "gt_masks": pad_to(masks.astype(np.float32), G, axis=3),
        }

    def __iter__(self):
        if len(self._order) < self.batch_size:
            raise ValueError(
                f"dataset has {len(self._order)} images < batch_size "
                f"{self.batch_size}: no batch can ever be formed")
        while True:
            if self.shuffle:
                self.rng.shuffle(self._order)
            for start in range(0, len(self._order) - self.batch_size + 1,
                               self.batch_size):
                yield self.get_batch(self._order[start:start
                                                 + self.batch_size])

    def get_batch(self, ids):
        if self.mode == "training":
            samples = [self._sample_training(i) for i in ids]
            return {"image": np.stack([s[0] for s in samples]),
                    "rpn_match": np.stack([s[1] for s in samples]),
                    "rpn_bbox": np.stack([s[2] for s in samples])}
        samples = [self._sample_gt(i, augment=self.mode != "targeting")
                   for i in ids]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device``; on a card from pinned memory,
    copied with ``non_blocking``."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if torch.device(device).type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def prefetch_to_device(iterator, device, size: int = 2):
    """Yield the iterator's numpy batches as dicts of tensors on
    ``device``, ``size`` batches ahead (PREFETCH_BUFFERS). On a card each
    array is pinned and copied with ``non_blocking``, so the copy overlaps
    the device's work on the batch before it. Assembly runs on the
    caller's thread, when a batch is taken."""
    queue = collections.deque()

    def enqueue():
        try:
            queue.append(to_device(next(iterator), device))
        except StopIteration:
            pass

    for _ in range(size):
        enqueue()
    while queue:
        yield queue.popleft()
        enqueue()


class MrcnnGenerator(RPNGenerator):
    """Full Mask R-CNN batches (reference: core/data_generators.py:
    1091-1341). Mode "training": the GT batch of ``_sample_gt`` with
    AUGMENT (``augment`` overrides it), plus RPN targets built from the
    un-jittered GT, on the generator's one RandomState in JAX's order.
    Each image is sampled once; JAX's ``get_batch`` samples it again for
    each of its five GT keys, so with AUGMENT its rows can mix flips
    (ROADMAP.md §3). Mode "inference": ``get_input_prediction``."""

    MODES = ("training", "inference")

    def __init__(self, dataset, config, mode: str = "inference",
                 shuffle=True, seed: int = 0, telemetry=None, augment=None):
        super().__init__(dataset, config, mode, shuffle=shuffle, seed=seed,
                         telemetry=telemetry, augment=augment)
        self._anchor_cache = AnchorCache(
            config,
            voxel_z_over_y=float(getattr(config, "VOXEL_Z_OVER_Y", 1.0)))

    def get_batch(self, ids):
        if self.mode != "training":
            return super().get_batch(ids)
        samples = [self._sample_gt(i, augment=self.config.AUGMENT)
                   for i in ids]
        gt = {k: np.stack([s[k] for s in samples])
              for k in ("image", "image_meta", "gt_class_ids", "gt_boxes",
                        "gt_masks")}
        matches, bboxes = [], []
        for b in range(len(ids)):
            H, W, D = gt["image"][b].shape[:3]
            scale = np.array([H, W, D, H, W, D], np.float32)
            m, bb = build_rpn_targets(self.anchors, gt["gt_class_ids"][b],
                                      gt["gt_boxes"][b] * scale, self.config,
                                      rng=self.rng)
            matches.append(m)
            bboxes.append(bb)
        gt["rpn_match"] = np.stack(matches)
        gt["rpn_bbox"] = np.stack(bboxes)
        return gt

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


class HeadGenerator:
    """Endless iterator over batches of pre-generated head targets
    (``ToyHeadDataset``; reference: core/data_generators.py:180-683), the
    same RandomState draws in the same order as JAX's.

    Per image: the artifacts resized to POOL_SIZE / MASK_POOL_SIZE where
    they differ; positives whose target mask covers less than
    HEAD_MIN_POSITIVE_COVERAGE (default 0.06) of the crop demoted to
    background; positives first (shuffled with HEAD_SHUFFLE_ROIS, capped
    at round(T * HEAD_POS_FRAC) with HEAD_BALANCE_POS), then negatives, to
    T = TRAIN_ROIS_PER_IMAGE slots, zero-padded."""

    def __init__(self, dataset, config, shuffle=True, seed: int = 0):
        self.dataset = dataset
        self.config = config
        self.shuffle = shuffle
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.batch_size = int(config.BATCH_SIZE)
        self._order = np.arange(len(dataset.image_info))

    def reset(self):
        """Restore the rng and order, so a validation pass draws the same
        ROI samples every epoch."""
        self.rng = np.random.RandomState(self.seed)
        self._order = np.arange(len(self.dataset.image_info))
        return self

    def __len__(self):
        return max(1, len(self.dataset.image_info) // self.batch_size)

    def _sample(self, image_id):
        cfg = self.config
        data = self.dataset.load_data(image_id)
        T = int(cfg.TRAIN_ROIS_PER_IMAGE)
        P = int(cfg.POOL_SIZE)
        MP = int(cfg.MASK_POOL_SIZE)
        ra, ma = data["rois_aligned"], data["mask_aligned"]
        tci = data["target_class_ids"].reshape(-1)
        tb, tm = data["target_bbox"], data["target_mask"]
        rois = data["rois"]
        n = min(len(tci), ra.shape[0], ma.shape[0], 200 * 10)  # sanity cap
        ra, ma, tci, tb, tm, rois = (a[:n] for a in (ra, ma, tci, tb, tm,
                                                     rois))
        if ra.shape[1:4] != (P, P, P):
            ra = nearest_resize_3d(ra, (P, P, P))
        if ma.shape[1:4] != (MP, MP, MP):
            ma = nearest_resize_3d(ma, (MP, MP, MP))
        # Weak-positive demotion by mask coverage (reference:
        # core/data_generators.py:506-551).
        min_cov = float(getattr(cfg, "HEAD_MIN_POSITIVE_COVERAGE", 0.06))
        pos = tci > 0
        if pos.any() and tm.size:
            cov = tm.reshape(tm.shape[0], -1).mean(axis=1)
            tci = np.where(pos & (cov < min_cov), 0, tci)
            pos = tci > 0
        pos_idx = np.where(pos)[0]
        neg_idx = np.where(~pos)[0]
        if getattr(cfg, "HEAD_SHUFFLE_ROIS", False):
            self.rng.shuffle(pos_idx)
            self.rng.shuffle(neg_idx)
        if getattr(cfg, "HEAD_BALANCE_POS", False):
            pos_idx = pos_idx[:max(1, int(round(T * float(cfg.HEAD_POS_FRAC))))]
        pos_idx = pos_idx[:T]
        neg_idx = neg_idx[:T - len(pos_idx)]
        sel = np.concatenate([pos_idx, neg_idx]).astype(int)
        return {
            "rois": pad_to(rois[sel], T),
            "rois_aligned": pad_to(ra[sel], T).astype(np.float32),
            "mask_aligned": pad_to(ma[sel], T).astype(np.float32),
            "target_class_ids": pad_to(tci[sel], T).astype(np.int32),
            "target_bbox": pad_to(tb[sel], T).astype(np.float32),
            "target_mask": pad_to(tm[sel], T).astype(np.float32),
        }

    def __iter__(self):
        if len(self._order) < self.batch_size:
            raise ValueError(
                f"head-target dataset has {len(self._order)} images < "
                f"batch_size {self.batch_size}: no batch can ever be formed "
                "(was target generation run, and did it keep any images?)")
        while True:
            if self.shuffle:
                self.rng.shuffle(self._order)
            for start in range(0, len(self._order) - self.batch_size + 1,
                               self.batch_size):
                ids = self._order[start:start + self.batch_size]
                samples = [self._sample(i) for i in ids]
                yield {k: np.stack([s[k] for s in samples])
                       for k in samples[0]}
