"""Configuration system (the port's own copy of m3d/config.py, numpy only).

Kept in step with m3d/config.py by tests/test_torch_host.py, which compares
every default and derived value.

Accepts the exact JSON schema of the reference (reference: core/config.py:17-119
defines ~90 flat keyword parameters; the reference's configs are
plain JSON dicts of those keys). Unknown keys are kept as attributes so config
files with extra, code-path-specific keys (e.g. HEAD_MIN_POSITIVE_COVERAGE,
RPN_MIN_Z_EXTENT, TRAIN_PHASE — read via getattr in the reference) keep working.

Derived values (IMAGE_SHAPE, BATCH_SIZE, IMAGE_META_SIZE, ANCHOR_NB) follow
reference: core/config.py:142-301.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

# Defaults mirror the reference's keyword defaults (core/config.py:17-119).
_DEFAULTS: dict[str, Any] = {
    # Data
    "DATA_DIR": "data/",
    "NUM_CLASSES": 2,
    "CLASS_NAMES": ["neuron"],
    "IMAGE_SIZE": 256,
    "IMAGE_DEPTH": 12,
    "IMAGE_CHANNEL_COUNT": 1,
    "MAX_GT_INSTANCES": 50,
    "TARGET_RATIO": 0.2,
    "USE_MINI_MASK": False,
    "MINI_MASK_SHAPE": (56, 56, 56),
    "RPN_BBOX_STD_DEV": [0.1, 0.1, 0.1, 0.2, 0.2, 0.2],
    "BBOX_STD_DEV": [0.1, 0.1, 0.1, 0.2, 0.2, 0.2],
    "EVALUATION_STEPS": 100,
    "OUTPUT_DIR": "data/output/",
    # General
    "MODE": "training",
    # RPN
    "BACKBONE": "resnet50",
    "BACKBONE_STRIDES": [(4, 4, 1), (8, 8, 1), (16, 16, 1), (32, 32, 1), (64, 64, 2)],
    "TOP_DOWN_PYRAMID_SIZE": 256,
    "RPN_ANCHOR_SCALES": (24, 39, 56, 84, 96),
    "RPN_ANCHOR_RATIOS": [0.05, 0.075, 0.1, 0.15, 0.25],
    "RPN_ANCHOR_STRIDE": 1,
    "RPN_TRAIN_ANCHORS_PER_IMAGE": 1024,
    "RPN_NMS_THRESHOLD": 0.9,
    "PRE_NMS_LIMIT": 10000,
    "POST_NMS_ROIS_TRAINING": 3000,
    "POST_NMS_ROIS_INFERENCE": 1500,
    # Head
    "TRAIN_ROIS_PER_IMAGE": 512,
    "ROI_POSITIVE_RATIO": 0.33,
    "POOL_SIZE": 7,
    "MASK_POOL_SIZE": 14,
    "FPN_CLASSIF_FC_LAYERS_SIZE": 1024,
    "HEAD_CONV_CHANNEL": 256,
    # Classifier-stage ROI cap (reference limit_rois, core/models.py:1254-
    # 1270). The reference gates its cap on the accidental heuristic
    # HEAD_CONV_CHANNEL < IMAGE_SHAPE[0] (reference default 1000); m3d makes
    # it explicit opt-in: 0 = disabled, >0 = cap score-sorted proposals.
    "HEAD_MAX_ROIS": 0,
    "MASK_SHAPE": [28, 28, 28],
    "TELEMETRY": True,
    "TELEMETRY_SAMPLE": 0.02,
    # Instance-match IoU for evaluation metrics. Default 0.5 = the
    # reference's compute_matches/compute_ap default (core/utils.py:1160,
    # 1211), so "det recall @IoU0.5" labels hold without per-config overrides.
    "EVAL_DET_IOU": 0.5,
    "MIN_ROI_SIZE": 15,
    # Detection
    "DETECTION_MAX_INSTANCES": 50,
    "DETECTION_MIN_CONFIDENCE": 0.2,
    "DETECTION_NMS_THRESHOLD": 0.45,
    "RPN_POSITIVE_IOU": 0.60,
    "RPN_NEGATIVE_IOU": 0.30,
    # Training
    "IMAGES_PER_GPU": 1,
    "GPU_COUNT": 1,
    "LOSS_WEIGHTS": {
        "rpn_class_loss": 1.0,
        "rpn_bbox_loss": 1.0,
        "mrcnn_class_loss": 1.0,
        "mrcnn_bbox_loss": 1.0,
        "mrcnn_mask_loss": 1.0,
        "mrcnn_obj_loss": 0.5,
        "mrcnn_margin_loss": 0.0,
    },
    "TRAIN_BN": False,
    "LEARNING_LAYERS": "all",
    "OPTIMIZER": {"name": "SGD", "parameters": {}},
    "WEIGHT_DIR": None,
    "RPN_WEIGHTS": None,
    "HEAD_WEIGHTS": None,
    "MASK_WEIGHTS": None,
    "EPOCHS": 1,
    "FROM_EPOCH": 0,
    "WEIGHT_DECAY": 0.0001,
    # Opt-in reference-exact L2 decay: divide each tensor's penalty by its
    # element count (reference core/models.py:3380-3384). Default keeps the
    # Keras-conventional un-normalized decay all committed runs trained with.
    "WEIGHT_DECAY_SIZE_NORMALIZED": False,
    "EVAL_TOPK_RPN": 512,
    "EVAL_MATCH_IOU": 0.50,
    "EVAL_MATCH_IOU_GRID": [0.30, 0.40, 0.50],
    "EVAL_TOPK_GRID": [500, 1000, 2000, 4000, 6000, 8000],
    # AutoTune
    "AUTO_TUNE_RPN": False,
    "AUTO_TUNE_SAVE_PATCH": True,
    "AUTO_TUNE_SNAP_SCALE_STEP": 8,
    "AUTO_TUNE_SNAP_RATIO_STEP": 0.02,
    "AUTO_TUNE_RATIO_RANGE": [0.04, 0.30],
    "AUTO_TUNE_SCALES_LIMIT": 8,
    "AUTO_TUNE_RATIOS_LIMIT": 8,
    "MIN_POSITIVE_TARGETS": 25,
    # Augmentation
    "AUGMENT": True,
    "AUG_PROB": 0.5,
    "AUG_FLIP_Y": True,
    "AUG_FLIP_X": True,
    "AUG_FLIP_Z": False,
    "AUG_BRIGHTNESS_DELTA": 0.03,
    "AUG_GAUSS_NOISE_STD": 0.0,
    "RPN_AUGMENT_GT": True,
    "RPN_GT_JITTER_PER_BOX": 3,
    "RPN_GT_JITTER_SCALE_SIGMA": 0.10,
    "RPN_GT_JITTER_TRANS": [2, 2, 1],
    "ATSS_TOPK": 12,
    "ATSS_MIN_POS_PER_GT": 3,
    "RPN_GT_JITTER_IOU_THR": 0.4,
    "VOXEL_Z_OVER_Y": 1.0,
    "HEAD_SHUFFLE_ROIS": False,
    "HEAD_BALANCE_POS": False,
    "HEAD_POS_FRAC": 0.25,
    # TPU-native extras (not in the reference schema; safe defaults)
    "SEED": 0,
    "DEVICES_PER_HOST": None,      # None -> use all local devices for data parallel
    "COMPUTE_DTYPE": "bfloat16",   # conv/matmul compute dtype on TPU
    "PREFETCH_BUFFERS": 2,         # host->HBM double buffering depth
    "RPN_POSITIVE_RATIO": 0.5,     # read via getattr in reference targets code
}


def _stride_triple(stride) -> tuple[int, int, int]:
    """Normalize a stride spec (int | (s,) | (sxy, sz) | (sy, sx, sz)) to a triple."""
    if isinstance(stride, (int, np.integer)):
        return (int(stride),) * 3
    stride = tuple(int(s) for s in stride)
    if len(stride) == 3:
        return stride
    if len(stride) == 2:
        return (stride[0], stride[0], stride[1])
    return (stride[0],) * 3


class Config:
    """Flat config object; construct with ``Config(**json_dict)``.

    Same call surface as the reference (core/config.py:383-388 loads JSON and
    splats it into the constructor). Unknown keys become attributes.
    """

    def __init__(self, **kwargs: Any) -> None:
        # Keys the user actually set (vs defaults) — lets consumers like
        # rpn_evaluation distinguish an explicitly-configured EVAL_TOPK_RPN
        # cutoff from the default (which would otherwise silently widen the
        # eval grid on every run).
        explicit = kwargs.pop("_explicit_keys", None)
        self._explicit_keys = frozenset(
            explicit if explicit is not None else kwargs)
        params = dict(_DEFAULTS)
        params.update(kwargs)
        for key, value in params.items():
            setattr(self, key, value)

        # Array-ize std devs (reference: core/config.py:158-159).
        self.RPN_BBOX_STD_DEV = np.asarray(self.RPN_BBOX_STD_DEV, dtype=np.float32)
        self.BBOX_STD_DEV = np.asarray(self.BBOX_STD_DEV, dtype=np.float32)

        # Derived (reference: core/config.py:142, 228-241, 298, 301).
        self.IMAGE_SHAPE = np.array(
            [self.IMAGE_SIZE, self.IMAGE_SIZE, self.IMAGE_DEPTH, self.IMAGE_CHANNEL_COUNT]
        )
        self.BATCH_SIZE = int(self.IMAGES_PER_GPU) * int(self.GPU_COUNT)
        self.IMAGE_META_SIZE = 1 + 4 + 4 + 6 + 1 + int(self.NUM_CLASSES)

        self.BACKBONE_STRIDES = [_stride_triple(s) for s in self.BACKBONE_STRIDES]
        anchor_nb = 0.0
        for sy, sx, sz in self.BACKBONE_STRIDES:
            anchor_nb += (
                (self.IMAGE_SHAPE[0] / sy)
                * (self.IMAGE_SHAPE[1] / sx)
                * (self.IMAGE_SHAPE[2] / sz)
            )
        self.ANCHOR_NB = int(anchor_nb)

    # ------------------------------------------------------------------
    def backbone_shapes(self, image_shape=None) -> np.ndarray:
        """FPN level spatial shapes [L, (H, W, D)] from per-axis strides.

        Reference: core/models.py:127-147 (compute_backbone_shapes).
        """
        if image_shape is None:
            image_shape = self.IMAGE_SHAPE
        shapes = []
        for sy, sx, sz in self.BACKBONE_STRIDES:
            shapes.append(
                [
                    int(np.ceil(image_shape[0] / sy)),
                    int(np.ceil(image_shape[1] / sx)),
                    int(np.ceil(image_shape[2] / sz)),
                ]
            )
        return np.array(shapes)

    def display(self) -> None:
        """Print all config values (reference: core/config.py:372-380)."""
        print("\nConfigurations:")
        for a in sorted(vars(self)):
            if not a.startswith("_"):
                print("{:30} {}".format(a, getattr(self, a)))
        print("\n")

    def to_dict(self) -> dict[str, Any]:
        out = {}
        for k, v in vars(self).items():
            if k.startswith("_"):
                continue
            if isinstance(v, np.ndarray):
                v = v.tolist()
            out[k] = v
        return out

    def replace(self, **kwargs: Any) -> "Config":
        """Functional update returning a new Config."""
        d = {k: v for k, v in vars(self).items() if not k.startswith("_")}
        for derived in ("IMAGE_SHAPE", "BATCH_SIZE", "IMAGE_META_SIZE", "ANCHOR_NB"):
            d.pop(derived, None)
        d.update(kwargs)
        d["_explicit_keys"] = set(self._explicit_keys) | set(kwargs)
        return Config(**d)


def resolve_auto_confidence(config, default: float = 0.2) -> float:
    """Resolve ``DETECTION_MIN_CONFIDENCE: "auto"``.

    The reference's evaluation ends with a confidence histogram and a
    recommended threshold the user is told to copy into their config
    (core/models.py:7144-7164). "auto" closes that loop: it reads the
    ``recommended_confidence`` from the last MRCNN_EVALUATION summary
    written next to this config's OUTPUT_DIR and uses it directly, falling
    back to the reference class default (core/config.py:67) when no
    evaluation has run yet. Mutates config in place so graph constructors that
    bake the threshold in (m3d/models/mask_rcnn.py) see a float, and
    returns the resolved value.
    """
    raw = getattr(config, "DETECTION_MIN_CONFIDENCE", default)
    if not (isinstance(raw, str) and raw.lower() == "auto"):
        return float(raw)
    resolved = float(default)
    src = None
    out_dir = str(getattr(config, "OUTPUT_DIR", "") or "")
    candidates = [os.path.join(out_dir, "evaluation_summary.json")]
    # Training configs usually point OUTPUT_DIR at .../<stage>/; the eval
    # stage of the same run family lives in a sibling directory.
    parent = os.path.dirname(out_dir.rstrip("/"))
    if parent:
        candidates.append(
            os.path.join(parent, "eval", "evaluation_summary.json"))
    for cand in candidates:
        try:
            with open(cand) as f:
                rec = json.load(f).get("recommended_confidence")
            if rec is not None:
                resolved, src = float(rec), cand
                break
        except (OSError, ValueError):
            continue
    print(f"[config] DETECTION_MIN_CONFIDENCE=auto -> {resolved:.3f}"
          + (f" (from {src})" if src else f" (default; no evaluation "
             f"summary found near {out_dir or '<unset>'})"))
    config.DETECTION_MIN_CONFIDENCE = resolved
    return resolved


def load_config(config_path: str) -> Config:
    """Load a JSON config file (reference: core/config.py:383-388)."""
    with open(config_path) as config_file:
        config_dict = json.load(config_file)
    return Config(**config_dict)

