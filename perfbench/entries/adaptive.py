"""Entry ``adaptive``: ``m3d_torch.models.inference.adaptive_inference``.
The traffic's ``chunks`` is ``"default"`` (the model's ``default_chunks``,
the default path of every in-process inference and evaluation) or
``[classifier, mask]`` rows a chunk (0: that stage monolithic)."""

from __future__ import annotations

from perfbench.infer import InferEntry


class Entry(InferEntry):
    def __init__(self, config, traffic, seed, device, root):
        super().__init__(config, traffic, seed, device, root)
        from m3d_torch.models import inference

        self.inference = inference
        chunks = traffic["chunks"]
        self.chunks = (inference.default_chunks(self.model)
                       if chunks == "default" else tuple(map(int, chunks)))

    def __call__(self, images):
        return self.inference.adaptive_inference(
            self.model, images, self.meta, self.anchors,
            classifier_chunk=self.chunks[0], mask_chunk=self.chunks[1],
            device=self.device)

    def spans(self):
        inf = self.inference
        return [(self.model, "extract_features", "trunk"),
                (self.model, "rpn_forward", "proposals"),
                (self.model, "propose", "proposals"),
                (inf, "compacted_classifier_stage", "classifier"),
                (self.model, "classify_rois", "classifier"),
                (inf, "refine_detections_batch", "detection"),
                (inf, "compacted_mask_stage", "mask"),
                (self.model, "mask_rois", "mask")]
