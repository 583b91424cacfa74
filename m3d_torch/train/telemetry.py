"""Telemetry: sampled counters/histograms of anchor/GT/proposal geometry
(port of m3d/train/telemetry.py; numpy, the same RandomState draws; its
``update_scalars`` and ``log_config_params`` have no caller there and are
not ported).

Parity with the reference Telemetry subsystem (core/utils.py:1599-1957): the
same JSONL record shape is appended to ``<save_dir>/telemetry.jsonl`` each
epoch:

    {"epoch": N, "cnt": {...}, "hist": {name: {count,min,p25,p50,p75,max,
     mean,std}}, "extra": {...}, "top": {"scales": [...], "ratios": [...]},
     "suggest": {"scales": [...], "ratios": [...]}}

``suggest`` quantizes the observed GT/positive-anchor/ROI geometry into
ready-to-paste RPN_ANCHOR_SCALES / RPN_ANCHOR_RATIOS values.

Unlike the reference's class-level globals, this is an instance you own —
multiple trainers don't share state.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np


def _percentiles(arr):
    if not len(arr):
        return {}
    a = np.asarray(arr, np.float32)
    return {
        "count": int(a.size),
        "min": float(a.min()),
        "p25": float(np.percentile(a, 25)),
        "p50": float(np.percentile(a, 50)),
        "p75": float(np.percentile(a, 75)),
        "max": float(a.max()),
        "mean": float(a.mean()),
        "std": float(a.std()),
    }


class Telemetry:
    def __init__(self, config=None, save_dir=None, sample: float | None = None,
                 rng=None):
        self.config = config
        self.save_dir = save_dir or (config and getattr(config, "WEIGHT_DIR", None))
        self.enabled = bool(getattr(config, "TELEMETRY", True)) if config else True
        self.sample = (
            sample
            if sample is not None
            else float(getattr(config, "TELEMETRY_SAMPLE", 0.05)) if config else 0.05
        )
        self.rng = rng or np.random.RandomState(0)
        self.reset()

    def reset(self):
        self.cnt = defaultdict(int)
        self.hist = defaultdict(list)

    def _sampled(self):
        return self.enabled and self.rng.rand() <= self.sample

    # ------------------------------------------------------------------
    def update_gt_stats(self, gt_boxes):
        """GT geometry: XY extent, Z extent, z/xy ratio (utils.py:1617-1631)."""
        if not self.enabled or gt_boxes is None or len(gt_boxes) == 0:
            return
        g = np.asarray(gt_boxes, np.float32)[:128]
        dy, dx, dz = g[:, 3] - g[:, 0], g[:, 4] - g[:, 1], g[:, 5] - g[:, 2]
        xy = np.sqrt(np.maximum(1.0, dx * dy))
        self.hist["gt_xy"].extend(xy.tolist())
        self.hist["gt_dz"].extend(dz.tolist())
        self.hist["gt_ratio_est"].extend((dz / np.maximum(1.0, xy)).tolist())

    def update_rpn_targets(self, anchors, iou_max, match):
        """Pos/neg/neutral counts, positive IoU histogram, positive-anchor
        scale/ratio attribution (utils.py:1652-1697)."""
        if not self._sampled():
            return
        match = np.asarray(match)
        self.cnt["rpn_pos"] += int((match == 1).sum())
        self.cnt["rpn_neg"] += int((match == -1).sum())
        self.cnt["rpn_neu"] += int((match == 0).sum())

        pos = match == 1
        if pos.any():
            vals = np.asarray(iou_max)[pos]
            vals = vals[vals > 0.05]
            if vals.size > 256:
                vals = self.rng.choice(vals, 256, replace=False)
            self.hist["rpn_iou_max"].extend([float(v) for v in vals])

            idx = np.where(pos)[0]
            if idx.size > 256:
                idx = self.rng.choice(idx, 256, replace=False)
            a = np.asarray(anchors)[idx]
            dy, dx, dz = a[:, 3] - a[:, 0], a[:, 4] - a[:, 1], a[:, 5] - a[:, 2]
            xy = np.sqrt(np.maximum(1.0, dy * dx))
            self.hist["pos_dz"].extend(dz.tolist())
            self.hist["pos_xy"].extend(xy.tolist())
            self._attribute(xy, dz)

    def _attribute(self, xy, dz):
        cfg = self.config
        scales = np.asarray(
            getattr(cfg, "RPN_ANCHOR_SCALES", [32, 64, 96, 128, 160]), np.float32
        )
        ratios = np.asarray(
            getattr(cfg, "RPN_ANCHOR_RATIOS", [0.1, 0.2, 0.3]), np.float32
        )
        s_idx = np.argmin(np.abs(xy[:, None] - scales[None, :]), axis=1)
        est_ratio = dz / np.maximum(1.0, scales[s_idx])
        r_idx = np.argmin(np.abs(est_ratio[:, None] - ratios[None, :]), axis=1)
        for v in scales[s_idx]:
            self.cnt[f"pos_scale_{int(v)}"] += 1
        for v in ratios[r_idx]:
            self.cnt[f"pos_ratio_{v:.3f}"] += 1

    def update_rpn_proposals(self, rois, gt_boxes):
        """Proposal-vs-GT hit rate and ROI geometry (utils.py:1700-1763).
        Inputs in pixel coordinates."""
        if not self.enabled or rois is None or gt_boxes is None:
            return
        rois, gt_boxes = np.asarray(rois), np.asarray(gt_boxes)
        if rois.size == 0 or gt_boxes.size == 0:
            return
        R, G = min(len(rois), 256), min(len(gt_boxes), 64)
        r = rois[self.rng.choice(len(rois), R, replace=False)] if len(rois) > R else rois
        g = (gt_boxes[self.rng.choice(len(gt_boxes), G, replace=False)]
             if len(gt_boxes) > G else gt_boxes)

        lo = np.maximum(r[:, None, :3], g[None, :, :3])
        hi = np.minimum(r[:, None, 3:], g[None, :, 3:])
        inter = np.prod(np.maximum(0.0, hi - lo), axis=-1)
        vol_r = np.prod(r[:, 3:] - r[:, :3], axis=1)[:, None]
        vol_g = np.prod(g[:, 3:] - g[:, :3], axis=1)[None, :]
        iou = inter / (vol_r + vol_g - inter + 1e-9)

        thr = float(getattr(self.config, "EVAL_DET_IOU", 0.40)) if self.config else 0.4
        self.cnt["prop_hits"] += int((iou >= thr).any(axis=0).sum())
        self.cnt["prop_total"] += int(g.shape[0])

        dz = r[:, 5] - r[:, 2]
        xy = np.sqrt(np.maximum(1.0, (r[:, 4] - r[:, 1]) * (r[:, 3] - r[:, 0])))
        self.hist["roi_dz"].extend(dz[:64].tolist())
        self.hist["roi_xy"].extend(xy[:64].tolist())

    # ------------------------------------------------------------------
    @staticmethod
    def _snap_vals(vals, step, lo, hi, ndigits=3):
        xs = set()
        for v in vals:
            if v is None or not np.isfinite(v):
                continue
            v = min(hi, max(lo, float(v)))
            xs.add(round(round(v / step) * step, ndigits))
        return sorted(xs)

    def snapshot_and_reset(self, epoch, save_dir=None, extra=None):
        snap = {
            "epoch": int(epoch),
            "cnt": {str(k): int(v) for k, v in self.cnt.items()},
            "hist": {k: _percentiles(v) for k, v in self.hist.items()},
        }
        if extra:
            snap["extra"] = {
                str(k): (float(v) if isinstance(v, (int, float, np.floating,
                                                    np.integer)) else v)
                for k, v in extra.items()
            }

        # top-N observed scales/ratios (utils.py:1842-1862)
        def top_n(prefix, cast, n=10):
            items = [
                (cast(k[len(prefix):]), v)
                for k, v in snap["cnt"].items()
                if k.startswith(prefix)
            ]
            items.sort(key=lambda kv: (-kv[1], kv[0]))
            return [{"value": k, "count": int(v)} for k, v in items[:n]]

        snap["top"] = {
            "scales": top_n("pos_scale_", int),
            "ratios": top_n("pos_ratio_", float),
        }

        # suggested anchor scales/ratios (utils.py:1864-1905)
        xy_vals = []
        for key in ("gt_xy", "pos_xy", "roi_xy"):
            h = snap["hist"].get(key, {})
            if "p50" in h:
                xy_vals += [h.get("p25", 0.0), h.get("p50", 0.0), h.get("p75", 0.0)]
        hi_xy = max(256.0, snap["hist"].get("roi_xy", {}).get("max", 256.0))
        scales_suggest = [
            int(s) for s in self._snap_vals(xy_vals, 8, 8, hi_xy, 0)
        ][:8]

        est = []
        gt_rat = snap["hist"].get("gt_ratio_est", {})
        for k in ("p25", "p50", "p75"):
            if k in gt_rat:
                est.append(float(gt_rat[k]))
        roi_xy = snap["hist"].get("roi_xy", {})
        roi_dz = snap["hist"].get("roi_dz", {})
        if all(k in roi_xy and k in roi_dz for k in ("p25", "p50", "p75")):
            for k in ("p25", "p50", "p75"):
                est.append(float(roi_dz[k]) / max(1e-6, float(roi_xy[k])))
        snap["suggest"] = {
            "scales": scales_suggest,
            "ratios": self._snap_vals(est, 0.02, 0.04, 0.30)[:8],
        }

        save_dir = save_dir or self.save_dir or "./weights"
        os.makedirs(save_dir, exist_ok=True)
        try:
            with open(os.path.join(save_dir, "telemetry.jsonl"), "a",
                      encoding="utf-8") as f:
                f.write(json.dumps(snap, ensure_ascii=False) + "\n")
        except OSError as e:
            print(f"[Telemetry] write failed: {e}")
        self.reset()
        return snap
