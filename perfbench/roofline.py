"""The yardstick's arithmetic: the H100's published peaks, the least time
of a kernel's work (each input byte read once, each output byte written
once, its operations on the unit that does them), the work of each ROIAlign
kernel from its launch's logical shapes (a frozen copy of the arithmetic
the port's smoke run used), and the operations of a whole inference step
for ``mfu``.

Peaks: NVIDIA's H100 SXM data sheet, dense: 989 TFLOP/s bf16 on the tensor
cores, 67 TFLOP/s float32 outside them, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import math

import torch

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, f32_ops: float = 0.0, bf16_ops: float = 0.0):
    """Least seconds for the bytes and operations: memory, float32 units
    and tensor cores work at once, so the largest of the three."""
    return max(nbytes / HBM_BYTES_PER_S, f32_ops / FP32_FLOPS,
               bf16_ops / BF16_FLOPS)


def touched_voxels(levels, bat, total: int, pos, fms) -> int:
    """Distinct feature voxels the first ``total`` rows' 8-tap samples
    read (pos [N, 3, p] in level voxels)."""
    count = 0
    for lv, fm in enumerate(fms):
        rows = torch.nonzero(levels[:total] == lv).flatten()
        if rows.numel() == 0:
            continue
        b, h, w, d = fm.shape[:4]
        occ = torch.zeros(b, h, w, d, dtype=torch.bool, device=pos.device)
        for r in rows.split(512):
            idx = []
            for a, size in enumerate((h, w, d)):
                pc = pos[r, a].clamp(0, size - 1)
                i0 = pc.floor().long()
                idx.append(torch.cat([i0, (i0 + 1).clamp(max=size - 1)], 1))
            yy, xx, zz = idx
            occ[bat[r].long()[:, None, None, None], yy[:, :, None, None],
                xx[:, None, :, None], zz[:, None, None, :]] = True
        count += int(occ.sum())
    return count


def compact_work(levels, bat, total: int, pos, fms):
    """(bytes, float32 ops) of the compact ROIAlign: every output row
    written, the live rows' voxels and row metadata read, ~16 float32
    operations per live output element."""
    n, _, p = pos.shape
    c, item = fms[0].shape[-1], fms[0].element_size()
    nbytes = (n * p ** 3 * c * item
              + touched_voxels(levels, bat, total, pos, fms) * c * item
              + pos.numel() * 4 + 8 * n + 4)
    return nbytes, 16.0 * total * p ** 3 * c


def compact_args_work(args):
    """Work of one ``roialign_compact(levels, batch, total, pos, fms)``
    call."""
    levels, bat, total, pos, fms = args
    nbytes, f32 = compact_work(levels, bat, int(total), pos, fms)
    return nbytes, f32, 0.0


def padded_args_work(args):
    """Work of one ``roialign_padded(levels, pos, fms, n_per_image)``
    call: the compact kernel's, every row live."""
    levels, pos, fms, n_per_image = args
    n = pos.shape[0]
    bat = torch.arange(n, device=pos.device) // int(n_per_image)
    nbytes, f32 = compact_work(levels, bat, n, pos, fms)
    return nbytes, f32, 0.0


def slab_touched(levels, bat, origins, wy, wx, wz, fms, off, cnt):
    """Distinct voxels the rows in [off, off + cnt) read with a nonzero
    weight, and the taps (nonzero weight products) they sum."""
    rows = torch.arange(off, off + cnt, device=wy.device)
    voxels, taps = 0, 0.0
    for lv, fm in enumerate(fms):
        r_all = rows[levels[rows] == lv]
        if r_all.numel() == 0:
            continue
        b, h, w, d = fm.shape[:4]
        occ = torch.zeros(b, h + 1, w + 1, d + 1, dtype=torch.bool,
                          device=wy.device)
        for r in r_all.split(256):
            idx, nnz = [], []
            for a, (wt, size) in enumerate(zip((wy, wx, wz), (h, w, d))):
                ww = wt[r]
                co = origins[r, a].long()[:, None] + torch.arange(
                    ww.shape[2], device=wy.device)
                nz = (ww != 0) & ((co >= 0) & (co < size))[:, None, :]
                idx.append(torch.where(nz.any(1), co,
                                       torch.full_like(co, size)))
                nnz.append(nz.sum((1, 2)).double())
            taps += float((nnz[0] * nnz[1] * nnz[2]).sum())
            occ[bat[r].long()[:, None, None, None], idx[0][:, :, None, None],
                idx[1][:, None, :, None], idx[2][:, None, None, :]] = True
        voxels += int(occ[:, :h, :w, :d].sum())
    return voxels, taps


def fc_args_work(args):
    """Work of one fused ROIAlign + FC call (levels, batch, origins, wy,
    wx, wz, fms, wk, bounds): its F-wide float32 output rows written, the
    rows in bounds' voxels, weights and metadata read, the FC weight read
    once; 2 float32 operations a tap and channel, and 2 * rows * K * F
    tensor-core operations."""
    levels, bat, origins, wy, wx, wz, fms, wk, bounds = args
    off, cnt = (int(v) for v in bounds.tolist())
    n, p = wy.shape[:2]
    c, item = fms[0].shape[-1], fms[0].element_size()
    voxels, taps = slab_touched(levels, bat, origins, wy, wx, wz, fms, off,
                                cnt)
    f, k = wk.shape
    nbytes = (n * f * 4 + k * f * wk.element_size() + voxels * c * item
              + 20 * cnt + cnt * p * (wy.shape[2] + wx.shape[2]
                                      + wz.shape[2]) * 4 + 8)
    return nbytes, 2.0 * taps * c, 2.0 * cnt * k * f


# Operations of an inference step (mfu) -----------------------------------

def _conv_macs(module, x, y) -> float:
    w = module.weight
    return float(y[0].numel() if isinstance(y, tuple) else y.numel()) \
        * w.shape[1] * math.prod(w.shape[2:])


def step_flops(cfg: dict) -> dict:
    """Operations (2 x multiply-adds of every convolution and matrix
    product) of the reference model at ``cfg``'s shapes: ``image`` for the
    trunk, FPN and RPN head of one image, ``classifier_row`` per ROI of the
    classifier head, ``mask_row`` per ROI of the mask head."""
    from perfbench.reference.maskrcnn import Conv, Reference

    with torch.device("meta"):
        ref = Reference(cfg)
    macs = [0.0]
    hooks = [m.register_forward_hook(lambda mod, i, o: macs.__setitem__(
        0, macs[0] + _conv_macs(mod, i, o)))
        for m in ref.modules() if isinstance(m, Conv)]
    image = torch.zeros(1, int(cfg["IMAGE_SIZE"]), int(cfg["IMAGE_SIZE"]),
                        int(cfg["IMAGE_DEPTH"]),
                        int(cfg.get("IMAGE_CHANNEL_COUNT", 1)), device="meta")
    with torch.no_grad():
        fms = ref.features(image)
        for p in fms:
            ref.rpn(p, ref.ctx)
        image_macs = macs[0]
        m = int(cfg["MASK_POOL_SIZE"])
        c = int(cfg["TOP_DOWN_PYRAMID_SIZE"])
        macs[0] = 0.0
        ref.mask_head(torch.zeros(1, m, m, m, c, device="meta"), ref.ctx)
        cc = int(cfg["HEAD_CONV_CHANNEL"])
        mask_macs = macs[0] + m ** 3 * cc * cc * 8   # the 2x transposed conv
    for h in hooks:
        h.remove()
    p = int(cfg["POOL_SIZE"])
    f = int(cfg["FPN_CLASSIF_FC_LAYERS_SIZE"])
    k = int(cfg["NUM_CLASSES"])
    cls_macs = p ** 3 * c * f + f * f + f * k + f * 6 * k
    return {"image": 2.0 * image_macs, "classifier_row": 2.0 * cls_macs,
            "mask_row": 2.0 * mask_macs}
