"""Assembled 3D Mask R-CNN (port of m3d/models/mask_rcnn.py, inference
stages of the adaptive path).

One ``nn.Module`` owns every parameter under the flax tree's names
(``resnet``, ``fpn``, ``rpn``, ``classifier``, ``mask_head``), so a flax
checkpoint loads by name (m3d_torch/checkpoints.py). Its methods are the
composable stages m3d_torch/models/inference.py chains: ``extract_features``,
``rpn_forward``, ``propose``, ``classify_rois_flat``, ``mask_align_compact``
and ``apply_mask_head``. The monolithic graph (``classify_rois``,
``mask_rois``, ``__call__``) is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from m3d_torch.models.backbone import ResNet3D
from m3d_torch.models.fpn import FPN3D
from m3d_torch.models.heads import ClassifierHead, MaskHead
from m3d_torch.models.proposal import generate_proposals
from m3d_torch.models.rpn_head import RPNHead
from m3d_torch.ops.roialign3d import (pyramid_roi_align_compact,
                                      pyramid_roi_align_flat)


class MaskRCNN(nn.Module):
    def __init__(self, backbone: str = "resnet50",
                 top_down_pyramid_size: int = 256, num_classes: int = 2,
                 pool_size: int = 7, mask_pool_size: int = 14,
                 fc_layers_size: int = 1024, head_conv_channel: int = 256,
                 num_ratios: int = 5, anchor_stride: int = 1,
                 backbone_strides=((4, 4, 1), (8, 8, 1), (16, 16, 1),
                                   (32, 32, 1), (64, 64, 1)),
                 p6_stride=(2, 2, 1), image_depth: int = 12,
                 rpn_bbox_std_dev=(0.1, 0.1, 0.1, 0.2, 0.2, 0.2),
                 bbox_std_dev=(0.1, 0.1, 0.1, 0.2, 0.2, 0.2),
                 rpn_nms_threshold: float = 0.9, pre_nms_limit: int = 10000,
                 post_nms_rois: int = 1500,
                 detection_min_confidence: float = 0.2,
                 detection_nms_threshold: float = 0.45,
                 detection_max_instances: int = 50,
                 detection_nms_xy_only: bool = False, head_max_rois: int = 0,
                 in_channels: int = 1, dtype=torch.bfloat16):
        super().__init__()
        self.pool_size = pool_size
        self.mask_pool_size = mask_pool_size
        self.image_depth = image_depth
        self.rpn_bbox_std_dev = tuple(rpn_bbox_std_dev)
        self.bbox_std_dev = tuple(bbox_std_dev)
        self.rpn_nms_threshold = rpn_nms_threshold
        self.pre_nms_limit = pre_nms_limit
        self.post_nms_rois = post_nms_rois
        self.detection_min_confidence = detection_min_confidence
        self.detection_nms_threshold = detection_nms_threshold
        self.detection_max_instances = detection_max_instances
        self.detection_nms_xy_only = detection_nms_xy_only
        self.head_max_rois = head_max_rois

        s = backbone_strides
        up = tuple(tuple(s[i + 1][a] // s[i][a] for a in range(3))
                   for i in (2, 1, 0))
        c = top_down_pyramid_size
        self.resnet = ResNet3D(backbone, dtype, level_strides=s,
                               in_channels=in_channels)
        self.fpn = FPN3D((256, 512, 1024, 2048), c, p6_stride, dtype,
                         upsample_factors=up)
        self.rpn = RPNHead(c, num_ratios, anchor_stride, dtype)
        self.classifier = ClassifierHead(c, pool_size, num_classes,
                                         fc_layers_size, dtype)
        self.mask_head = MaskHead(c, num_classes, head_conv_channel, dtype)

    @classmethod
    def from_config(cls, config, mode: str = "inference", device="cuda",
                    **overrides):
        """Build from a reference-schema Config (m3d_torch.config.Config),
        with its parameters on ``device``."""
        scales = list(config.RPN_ANCHOR_SCALES)
        strides = config.BACKBONE_STRIDES
        if len(scales) > len(strides):
            raise ValueError("more RPN anchor scales than FPN levels would "
                             "misalign the RPN outputs with the anchors")
        post_nms = (config.POST_NMS_ROIS_TRAINING
                    if mode in ("training", "targeting")
                    else config.POST_NMS_ROIS_INFERENCE)
        kw = dict(
            backbone=config.BACKBONE,
            top_down_pyramid_size=int(config.TOP_DOWN_PYRAMID_SIZE),
            num_classes=int(config.NUM_CLASSES),
            pool_size=int(config.POOL_SIZE),
            mask_pool_size=int(config.MASK_POOL_SIZE),
            fc_layers_size=int(config.FPN_CLASSIF_FC_LAYERS_SIZE),
            head_conv_channel=int(config.HEAD_CONV_CHANNEL),
            num_ratios=len(config.RPN_ANCHOR_RATIOS),
            anchor_stride=int(config.RPN_ANCHOR_STRIDE),
            backbone_strides=tuple(tuple(int(v) for v in s) for s in strides),
            p6_stride=tuple(max(1, strides[4][i] // strides[3][i])
                            for i in range(3)),
            image_depth=int(config.IMAGE_DEPTH),
            rpn_bbox_std_dev=tuple(float(v) for v in config.RPN_BBOX_STD_DEV),
            bbox_std_dev=tuple(float(v) for v in config.BBOX_STD_DEV),
            rpn_nms_threshold=float(config.RPN_NMS_THRESHOLD),
            pre_nms_limit=int(config.PRE_NMS_LIMIT),
            post_nms_rois=int(post_nms),
            detection_min_confidence=float(config.DETECTION_MIN_CONFIDENCE),
            detection_nms_threshold=float(config.DETECTION_NMS_THRESHOLD),
            detection_max_instances=int(config.DETECTION_MAX_INSTANCES),
            detection_nms_xy_only=bool(
                getattr(config, "DETECTION_NMS_XY_ONLY", False)),
            head_max_rois=int(getattr(config, "HEAD_MAX_ROIS", 0) or 0),
            in_channels=int(config.IMAGE_CHANNEL_COUNT),
            dtype=torch.bfloat16
            if str(getattr(config, "COMPUTE_DTYPE", "bfloat16")) == "bfloat16"
            else torch.float32,
        )
        kw.update(overrides)
        return cls(**kw).to(device)

    # Composable stages ------------------------------------------------
    def extract_features(self, image):
        """image [B, H, W, D, C] -> (P2, P3, P4, P5, P6)."""
        _, c2, c3, c4, c5 = self.resnet(image)
        return self.fpn(c2, c3, c4, c5)

    def rpn_forward(self, feature_maps):
        """Shared RPN head on P2..P6, concatenated along anchors."""
        outs = [self.rpn(p) for p in feature_maps]
        return tuple(torch.cat([o[i] for o in outs], dim=1) for i in range(3))

    def propose(self, rpn_probs, rpn_deltas, anchors):
        return generate_proposals(
            rpn_probs, rpn_deltas, anchors, self.rpn_bbox_std_dev,
            proposal_count=self.post_nms_rois,
            nms_threshold=self.rpn_nms_threshold,
            pre_nms_limit=self.pre_nms_limit, image_depth=self.image_depth)

    def classify_rois_flat(self, boxes_flat, batch_idx, image_meta,
                           mrcnn_feature_maps):
        """Classifier stage over a flat ROI list (gather-path ROIAlign + FC
        head). Returns ([N, K] logits, [N, K] probs, [N, K, 6] deltas)."""
        aligned = pyramid_roi_align_flat(boxes_flat, batch_idx, image_meta,
                                         list(mrcnn_feature_maps),
                                         self.pool_size)
        logits, probs, deltas = self.classifier(aligned[None])
        return logits[0], probs[0], deltas[0]

    def mask_align_compact(self, boxes_flat, batch_idx, total, image_meta,
                           mrcnn_feature_maps):
        """Mask-stage ROIAlign over a compacted flat ROI list (live rows
        first, gated on the device tensor ``total``): the Hopper kernel on
        CUDA. Returns [N, m, m, m, C]."""
        return pyramid_roi_align_compact(boxes_flat, batch_idx, total,
                                         image_meta, list(mrcnn_feature_maps),
                                         self.mask_pool_size)

    def apply_mask_head(self, aligned):
        """Mask-head convolutions on pre-aligned [B, T, m, m, m, C]."""
        return self.mask_head(aligned)
