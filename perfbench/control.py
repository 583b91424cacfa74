"""The readings a cell's limits are set from, and what takes the program's
place to show that the check fails.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,... \
        --substitutes control,half_batch,... --substitute-seeds 7,8,9 \
        [--seconds 3]

runs, in one process on the card, the cell's run (set-up, a short window
at the cell's own load, the check) once per ``--seeds`` seed with the
program, then once per ``--substitute-seeds`` seed with each substitute in
the program's place, and prints one JSON line per run with every number
the check worked out (``numbers``) and whether the cell's limits pass it.
The benchmark's own runs never run a substitute.

- ``control``: the reference itself, computed with float8 e4m3 inputs to
  every convolution and product (the precision below the configurations'
  bfloat16), through its own proposals, detections and masks.
- ``half_batch``: the program run on the first half of each batch, its
  outputs standing for the whole batch (the second half's volumes are
  never computed).
- ``altered_answer``: the program's outputs with one valid detection's box
  moved by a tenth of the image where it is produced.
- ``topk_reversed``: the program with its proposal layer taking the
  PRE_NMS_LIMIT lowest-scored anchors in place of the highest.
- ``proposal_nms_skipped``: the program with its proposal layer keeping
  the best POST_NMS_ROIS_INFERENCE candidates without suppression.
- ``detection_nms_skipped``: the program with its detection layer keeping
  the best DETECTION_MAX_INSTANCES rows without suppression.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control(cell, entry, seed, dev):
    from perfbench.infer import image_meta, reference_state
    from perfbench.reference.anchors import anchors
    from perfbench.reference.maskrcnn import Reference, float32_math

    cfg = cell.config["model"]
    ref = Reference(cfg, fp8=True).to(dev)
    ref.load_state_dict(reference_state(cell.config, seed, dev, cell.root),
                        strict=True)
    anc = torch.as_tensor(anchors(cfg), device=dev)
    meta = torch.as_tensor(image_meta(cfg, int(cell.traffic["batch"])),
                           device=dev)

    def call(images):
        with float32_math():
            return ref.infer(images, meta, anc)
    return call


def half_batch(cell, entry, seed, dev):
    def call(images):
        h = images.shape[0] // 2
        first = images[:h]
        return entry(torch.cat([first, first[:images.shape[0] - h]]))
    return call


def altered_answer(cell, entry, seed, dev):
    def call(images):
        out = dict(entry(images))
        rows = torch.nonzero(out["detections_valid"])
        if rows.numel():
            det = out["detections"].clone()
            b, i = rows[0].tolist()
            det[b, i, :6] = det[b, i, :6] + 0.1
            out["detections"] = det
        return out
    return call


@contextlib.contextmanager
def patched(module, attr: str, value):
    old = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield
    finally:
        setattr(module, attr, old)


def planted(module_name: str, attr: str, fake):
    """A substitute: the program, with ``module_name.attr`` replaced by
    ``fake`` for the length of each call."""
    def substitute(cell, entry, seed, dev):
        module = importlib.import_module(module_name)

        def call(images):
            with patched(module, attr, fake):
                return entry(images)
        return call
    return substitute


def lowest_k(scores, k: int):
    vals, idx = torch.sort(scores, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def no_suppression(boxes, scores, iou_threshold, max_output, valid=None,
                   **_):
    """The best ``max_output`` rows by score, none suppressed, in the
    program's NMS's return form (indices, valid)."""
    s = scores.float()
    if valid is not None:
        s = torch.where(valid, s, torch.full_like(s, float("-inf")))
    take = min(max_output, s.shape[1])
    idx = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :take]
    ok = torch.gather(s, 1, idx) > float("-inf")
    pad = max_output - take
    if pad:
        idx = torch.cat([idx, idx.new_zeros(idx.shape[0], pad)], 1)
        ok = torch.cat([ok, ok.new_zeros(ok.shape[0], pad)], 1)
    return idx, ok


SUBSTITUTES = {
    "control": control, "half_batch": half_batch,
    "altered_answer": altered_answer,
    "topk_reversed": planted("m3d_torch.models.proposal", "top_k_stable",
                             lowest_k),
    "proposal_nms_skipped": planted("m3d_torch.models.proposal", "nms_3d",
                                    no_suppression),
    "detection_nms_skipped": planted("m3d_torch.models.detection", "nms_3d",
                                     no_suppression),
}


def read_checkpoints_once() -> None:
    """Every run of this process reads the same checkpoint: decode it once
    for the program's loader and once for the reference's (neither changes
    what it returns)."""
    import functools

    import m3d_torch.checkpoints as program_ckpt
    from perfbench import weights

    program_ckpt.load_params = functools.cache(program_ckpt.load_params)
    weights.checkpoint_state = functools.cache(weights.checkpoint_state)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--substitutes", default="control")
    ap.add_argument("--substitute-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from perfbench import harness

    if not torch.cuda.is_available():
        print("perfbench.control: needs a CUDA card", file=sys.stderr)
        return 1
    read_checkpoints_once()
    seeds = [int(s) for s in args.substitute_seeds.split(",") if s]
    runs = [(int(s), None) for s in args.seeds.split(",") if s] + [
        (seed, side) for side in args.substitutes.split(",") if side
        for seed in seeds]
    for seed, side in runs:
        r = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                             "cuda", all_numbers=True,
                             substitute=SUBSTITUTES[side] if side else None)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": side or "program",
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "failed": r["failed"],
                          "numbers": r["numbers"],
                          "metrics": {k: v["value"]
                                      for k, v in r["metrics"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
