"""Entry ``monolithic``: ``MaskRCNN.forward``, the graph that computes every
padded proposal and detection slot (monolithic bundles, MRCNN_EVALUATION
with chunks 0)."""

from __future__ import annotations

from perfbench.infer import InferEntry


class Entry(InferEntry):
    def __call__(self, images):
        return self.model(images, self.meta, self.anchors)

    def spans(self):
        from m3d_torch.models import mask_rcnn

        return [(self.model, "extract_features", "trunk"),
                (self.model, "rpn_forward", "proposals"),
                (self.model, "propose", "proposals"),
                (self.model, "classify_rois", "classifier"),
                (mask_rcnn, "refine_detections_batch", "detection"),
                (self.model, "mask_rois", "mask")]
