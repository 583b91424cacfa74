"""RPN evaluation task (port of ``RPNTrainer.__init__``,
``prepare_datasets``, ``init_variables`` and ``make_proposal_fn`` in
m3d/train/rpn.py). RPN training and head-target generation are not ported
yet (ROADMAP.md §1).

The model is built as JAX builds it, with ``mode="training"`` (so
POST_NMS_ROIS_TRAINING sets the proposal count), and runs in ``.eval()``
with frozen BatchNorm, as JAX's proposal function clones it with
``train_bn=False``.
"""

from __future__ import annotations

import torch

from m3d_torch.anchors import normalized_pyramid_anchors
from m3d_torch.checkpoints import load_params, params_from_jax, restore_by_name
from m3d_torch.data.datasets import ToyDataset
from m3d_torch.models.mask_rcnn import MaskRCNN, init_params


class RPNTrainer:
    def __init__(self, config, device="cuda"):
        self.config = config
        h, w = int(config.IMAGE_SHAPE[0]), int(config.IMAGE_SHAPE[1])
        if h % 64 or w % 64:
            raise ValueError("IMAGE_SHAPE height & width must be multiples of 64")
        self.device = torch.device(device)
        self.model = MaskRCNN.from_config(config, mode="training",
                                          device=self.device).eval()
        self.anchors = normalized_pyramid_anchors(
            config, voxel_z_over_y=float(getattr(config, "VOXEL_Z_OVER_Y", 1.0))
        )

    def prepare_datasets(self):
        cfg = self.config
        train = ToyDataset()
        train.load_dataset(cfg.DATA_DIR, is_train=True,
                           class_names=tuple(cfg.CLASS_NAMES))
        train.prepare()
        train = train.filter_positive()
        test = ToyDataset()
        test.load_dataset(cfg.DATA_DIR, is_train=False,
                          class_names=tuple(cfg.CLASS_NAMES))
        test.prepare()
        test = test.filter_positive()
        return train, test

    def init_variables(self):
        """Seeded weights (SEED), then RPN_WEIGHTS restored by name.
        Returns the model."""
        init_params(self.model, int(getattr(self.config, "SEED", 0)))
        weights = getattr(self.config, "RPN_WEIGHTS", None)
        if weights:
            tree, _ = load_params(weights)
            stats = restore_by_name(self.model, params_from_jax(tree))
            print(f"[RPNTrainer] restored {weights}: {stats}")
        return self.model

    def make_proposal_fn(self):
        """image [1, H, W, D, C] (numpy) -> (proposals [P, 6] normalized,
        valid [P]) as host numpy arrays."""
        model = self.model
        anchors = torch.as_tensor(self.anchors, device=self.device)

        def predict(image):
            out = model.forward_rpn(
                torch.as_tensor(image, device=self.device), anchors)
            return (out["proposals"][0].float().cpu().numpy(),
                    out["proposals_valid"][0].cpu().numpy())

        return predict
