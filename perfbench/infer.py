"""What the inference entries share: the system under test built from a
configuration file (``m3d_torch``'s own model, weight loader and anchors),
the image meta the benchmark composes, and the inference check.

An entry module (perfbench/entries/<name>.py) defines ``Entry``, a subclass
that says which call of the program the window drives and which of its
stages the traced run spans.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from perfbench import check_infer
from perfbench.weights import seeded_state


def image_meta(cfg: dict, batch: int) -> np.ndarray:
    """[B, META] float32: id, original and image shape (H, W, D, C), the
    whole-image window, scale 1, every class active."""
    h, w, d = (int(cfg["IMAGE_SIZE"]), int(cfg["IMAGE_SIZE"]),
               int(cfg["IMAGE_DEPTH"]))
    c = int(cfg.get("IMAGE_CHANNEL_COUNT", 1))
    row = ([0, h, w, d, c, h, w, d, c, 0, 0, 0, h, w, d, 1.0]
           + [1] * int(cfg["NUM_CLASSES"]))
    meta = np.tile(np.asarray(row, np.float32), (batch, 1))
    meta[:, 0] = np.arange(batch)
    return meta


def reference_state(config: dict, seed: int, device, root: str):
    """The weights the benchmark hands to both sides: the configuration's
    checkpoint read by the benchmark's own decoder, or a seeded state for
    the reference model's shapes."""
    from perfbench.reference.maskrcnn import Reference
    from perfbench.weights import checkpoint_state

    w = config["weights"]
    if w["kind"] == "checkpoint":
        return checkpoint_state(os.path.join(root, w["path"]))
    with torch.device("meta"):
        shapes = {k: tuple(v.shape)
                  for k, v in Reference(config["model"]).state_dict().items()}
    return seeded_state(shapes, seed, device)


class InferEntry:
    """Batch inference through ``m3d_torch``: the model, its weights and
    its anchors, built as the port's evaluation builds them."""

    CHECK = check_infer

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 root: str):
        from m3d_torch.anchors import normalized_pyramid_anchors
        from m3d_torch.checkpoints import (load_params, params_from_jax,
                                           restore_by_name)
        from m3d_torch.config import Config
        from m3d_torch.models.mask_rcnn import MaskRCNN

        self.device = torch.device(device)
        self.config = Config(**config["model"])
        self.model = MaskRCNN.from_config(self.config, mode="inference",
                                          device=self.device).eval()
        w = config["weights"]
        if w["kind"] == "checkpoint":
            tree, _ = load_params(os.path.join(root, w["path"]))
            stats = restore_by_name(self.model, params_from_jax(tree))
            if stats["missing"] or stats["skipped"]:
                raise RuntimeError(f"checkpoint does not cover the model: "
                                   f"{stats}")
        else:
            state = reference_state(config, seed, self.device, root)
            self.model.load_state_dict(state, strict=True)
        self.anchors = torch.as_tensor(normalized_pyramid_anchors(
            self.config, voxel_z_over_y=float(self.config.VOXEL_Z_OVER_Y)),
            device=self.device)
        self.meta = torch.as_tensor(image_meta(config["model"],
                                               int(traffic["batch"])),
                                    device=self.device)

    def spans(self):
        """(owner, attribute, stage) of the stages the traced run spans."""
        raise NotImplementedError

    def __call__(self, images):
        raise NotImplementedError

    @staticmethod
    def live(out: dict) -> dict:
        """Rows each per-ROI head had to compute, from outputs on the
        host."""
        return {"classifier_rows": int(out["proposals_valid"].sum()),
                "mask_rows": int(out["detections_valid"].sum())}

    def close(self) -> None:
        del self.model, self.anchors, self.meta
