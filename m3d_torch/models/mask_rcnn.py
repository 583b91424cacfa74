"""Assembled 3D Mask R-CNN (port of m3d/models/mask_rcnn.py, inference).

One ``nn.Module`` owns every parameter under the flax tree's names
(``resnet``, ``fpn``, ``rpn``, ``classifier``, ``mask_head``), so a flax
checkpoint loads by name (m3d_torch/checkpoints.py). Its methods are the
composable stages m3d_torch/models/inference.py chains: ``extract_features``,
``rpn_forward``, ``propose``, ``classify_rois_flat``, ``mask_align_compact``
and ``apply_mask_head``; and the monolithic graph's stages,
``classify_rois`` (fused ROIAlign + FC kernel) and ``mask_rois`` (padded
ROIAlign kernel), which ``forward`` (JAX's ``__call__``) chains over every
padded slot. ``rpn_outputs`` stops after the proposals, with gradients
into the RPN outputs and feature maps (the MRCNN train step);
``forward_rpn`` is the same without gradients (RPN evaluation, target
generation, the e2e head step's frozen trunk); ``forward_rpn_train`` is
the RPN training forward (with gradients, no proposals) and
``forward_heads`` the heads on pre-aligned features. BatchNorm runs on
batch statistics only after ``bn_mode(True)`` on a model built with
``train_bn`` (TRAIN_BN and a mode other than "inference", as JAX's
``from_config``), never because of ``nn.Module.train()``.
``init_params`` seeds the weights no checkpoint covers, with JAX's
distributions.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from m3d_torch.checkpoints import TRANSPOSED_CONVS
from m3d_torch.models.backbone import BatchNorm, ResNet3D
from m3d_torch.models.detection import refine_detections_batch
from m3d_torch.models.fpn import FPN3D
from m3d_torch.models.heads import ClassifierHead, MaskHead
from m3d_torch.models.proposal import generate_proposals
from m3d_torch.models.rpn_head import RPNHead
from m3d_torch.ops.roialign3d import (fused_classifier_ok,
                                      pyramid_roi_align_auto,
                                      pyramid_roi_align_compact,
                                      pyramid_roi_align_fc,
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
                 train_bn: bool = False, in_channels: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.train_bn = train_bn
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
            # Inference always uses the running statistics.
            train_bn=bool(config.TRAIN_BN) and mode != "inference",
            in_channels=int(config.IMAGE_CHANNEL_COUNT),
            dtype=torch.bfloat16
            if str(getattr(config, "COMPUTE_DTYPE", "bfloat16")) == "bfloat16"
            else torch.float32,
        )
        kw.update(overrides)
        return cls(**kw).to(device)

    def bn_mode(self, train: bool, group=None) -> "MaskRCNN":
        """BatchNorm on batch statistics, updating the running ones, when
        ``train`` and the model was built with ``train_bn`` (a training
        step under TRAIN_BN); else on the running statistics (every
        evaluation, proposal and targeting forward, as JAX's
        ``clone(train_bn=False)``). ``group``: the mesh axis whose ranks
        share the batch (data parallelism), None for one process. Returns
        the model."""
        on = bool(train) and self.train_bn
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.batch_stats = on
                m.group = group
        return self

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
                           mrcnn_feature_maps, head=None):
        """Classifier stage over a flat ROI list (gather-path ROIAlign + FC
        head). Returns ([N, K] logits, [N, K] probs, [N, K, 6] deltas).
        ``head``: the classifier's parameters and buffers to run it on
        (``torch.func.functional_call``; a traced branch passes them in),
        by default its own."""
        aligned = pyramid_roi_align_flat(boxes_flat, batch_idx, image_meta,
                                         list(mrcnn_feature_maps),
                                         self.pool_size)
        if head is None:
            logits, probs, deltas = self.classifier(aligned[None])
        else:
            logits, probs, deltas = torch.func.functional_call(
                self.classifier, head, (aligned[None],), strict=True)
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

    def classify_rois(self, rois, image_meta, mrcnn_feature_maps):
        """Classifier stage over padded [B, N, 6] ROIs. Where the fused
        ROIAlign + FC entry takes the features (always on the card), the
        pooled tensor is never written: conv1's float32 output gets its
        bias in float32 and the head runs ``from_fc``. Otherwise padded
        ROIAlign and the whole head. Returns ([B, N, K] logits, probs,
        [B, N, K, 6] deltas)."""
        feats = list(mrcnn_feature_maps)
        if fused_classifier_ok(self.pool_size, feats):
            conv = self.classifier.mrcnn_class_conv1
            fc = pyramid_roi_align_fc(rois, image_meta, feats,
                                      self.pool_size, conv.weight,
                                      kernel="kron")
            return self.classifier(fc + conv.bias.float(), from_fc=True)
        aligned = pyramid_roi_align_auto(rois, image_meta, feats,
                                         self.pool_size)
        return self.classifier(aligned)

    def mask_rois(self, rois, image_meta, mrcnn_feature_maps):
        """Mask stage over every padded [B, N, 6] slot: padded ROIAlign
        (the kernel on the card) and the mask head."""
        aligned = pyramid_roi_align_auto(rois, image_meta,
                                         list(mrcnn_feature_maps),
                                         self.mask_pool_size)
        return self.mask_head(aligned)

    def rpn_outputs(self, image, anchors, feats=None):
        """RPN forward with proposal generation (JAX
        ``MaskRCNN.forward_rpn``). image [B, H, W, D, C] and anchors [A, 6]
        are tensors on the model's device; ``feats``, a pyramid already
        computed from ``image`` (the Y-sharded trunk's), replaces the
        trunk. Returns the RPN outputs and the feature maps with their
        graph, and the proposals made from the detached outputs (JAX's
        ``stop_gradient`` on the proposals)."""
        if feats is None:
            feats = self.extract_features(image.float())
        logits, probs, deltas = self.rpn_forward(list(feats))
        with torch.no_grad():
            proposals, valid = self.propose(probs, deltas, anchors)
        return {
            "rpn_class_logits": logits,
            "rpn_probs": probs,
            "rpn_bbox": deltas,
            "proposals": proposals,
            "proposals_valid": valid,
            "feature_maps": feats,
        }

    @torch.no_grad()
    def forward_rpn(self, image, anchors):
        """``rpn_outputs`` without gradients."""
        return self.rpn_outputs(image, anchors)

    def forward_rpn_train(self, image):
        """RPN training forward (JAX ``forward_rpn_train``): trunk and RPN
        head with gradients, no proposals. Returns the RPN outputs."""
        feats = self.extract_features(image.float())
        logits, probs, deltas = self.rpn_forward(list(feats))
        return {"rpn_class_logits": logits, "rpn_probs": probs,
                "rpn_bbox": deltas}

    def forward_heads(self, rois_aligned, mask_aligned):
        """Classifier and mask heads on pre-aligned [B, T, p, p, p, C] and
        [B, T, m, m, m, C] features (JAX ``forward_heads``)."""
        logits, probs, bbox = self.classifier(rois_aligned)
        return {"mrcnn_class_logits": logits, "mrcnn_probs": probs,
                "mrcnn_bbox": bbox, "mrcnn_masks": self.mask_head(mask_aligned)}

    @torch.no_grad()
    def forward(self, image, image_meta, anchors):
        """Monolithic inference (JAX ``MaskRCNN.__call__``): every padded
        proposal and detection slot is computed. image [B, H, W, D, C],
        image_meta [B, META] and anchors [A, 6] are tensors on the model's
        device. Returns the same dict as JAX's."""
        return self.forward_from_features(self.extract_features(
            image.float()), image_meta, anchors)

    @torch.no_grad()
    def forward_from_features(self, feats, image_meta, anchors):
        """``forward`` after the trunk, on the (P2..P6) pyramid ``feats``:
        the RPN head, proposals, classifier, detections and masks."""
        _, probs, deltas = self.rpn_forward(list(feats))
        proposals, prop_valid = self.propose(probs, deltas, anchors)
        cap = int(self.head_max_rois or 0)
        if cap and cap < proposals.shape[1]:
            proposals = proposals[:, :cap]
            prop_valid = prop_valid[:, :cap]
        image_meta = image_meta.float()
        mrcnn_feats = list(feats[:4])
        _, cls_probs, cls_bbox = self.classify_rois(proposals, image_meta,
                                                    mrcnn_feats)
        detections, det_valid = refine_detections_batch(
            proposals, cls_probs, cls_bbox, image_meta, self.bbox_std_dev,
            self.detection_min_confidence, self.detection_nms_threshold,
            self.detection_max_instances,
            nms_xy_only=self.detection_nms_xy_only)
        masks = self.mask_rois(detections[..., :6], image_meta, mrcnn_feats)
        return {
            "detections": detections,
            "detections_valid": det_valid,
            "mrcnn_masks": masks,
            "mrcnn_probs": cls_probs,
            "mrcnn_bbox": cls_bbox,
            "proposals": proposals,
            "proposals_valid": prop_valid,
        }


# Initialisers that differ from flax's default lecun_normal (JAX:
# m3d/models/heads.py:36-47, 87-88, 106; m3d/models/rpn_head.py:45).
NORMAL_STD = {"classifier.mrcnn_class_logits.weight": 0.01,
              "classifier.mrcnn_bbox_fc.weight": 0.001,
              "rpn.rpn_bbox_pred.weight": 0.001}
FG_PRIOR = 0.15
# Standard deviation of the standard normal truncated to [-2, 2]; flax's
# truncated_normal variance scaling divides by it.
TRUNC_STD = 0.87962566103423978


def class_bias(num_classes: int) -> torch.Tensor:
    """The class-logit bias JAX starts from: log-odds of a 0.15 foreground
    prior, background first."""
    fg = math.log(FG_PRIOR / (1 - FG_PRIOR))
    bias = torch.full((num_classes,), fg, dtype=torch.float32)
    bias[0] = -math.log((1 - FG_PRIOR) / FG_PRIOR)
    return bias


@torch.no_grad()
def init_params(model: nn.Module, seed: int) -> nn.Module:
    """Seeded initialisation with JAX's distributions (m3d/models/
    mask_rcnn.py ``init_params``): every kernel lecun_normal (truncated to
    two standard deviations, standard deviation 1 / sqrt(fan in), fan in
    counted in flax's layout), except the three of ``NORMAL_STD``, which
    are plain normals; biases 0 except the class logits' (``class_bias``);
    BatchNorm scales and statistics keep their constructor values. Values
    are drawn on the CPU from ``torch.Generator().manual_seed(seed)`` in
    ``named_parameters`` order, so a seed gives the same weights on every
    device. Checkpoints restored afterwards overwrite what they cover."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, p in model.named_parameters():
        if name.endswith("mrcnn_class_logits.bias"):
            p.copy_(class_bias(p.shape[0]))
        if p.ndim < 2:
            continue
        if name in NORMAL_STD:
            p.copy_(torch.randn(p.shape, generator=gen) * NORMAL_STD[name])
            continue
        # torch layouts: conv [Cout, Cin, k...], dense [out, in],
        # transposed conv [Cin, Cout, k...]; flax's fan in is k^3 * Cin.
        fan_out_axis = 1 if name.rsplit(".", 2)[-2] in TRANSPOSED_CONVS else 0
        fan_in = p.numel() // p.shape[fan_out_axis]
        w = torch.empty(p.shape)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        p.copy_(w * (fan_in ** -0.5 / TRUNC_STD))
    return model
