"""Slab pyramid ROIAlign: the Hopper kernel, its wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``_kernel`` (m3d/ops/pallas_roialign.py, entry
``pallas_pyramid_roi_align``): the span-tiered branch of
``pyramid_roi_align_pallas`` and the fallback rows of the fused classifier
run it. The kernel source is m3d_torch/csrc/roialign_slab.cu; its header
note gives the function, the bound on an H100 and the design.

``roialign_slab`` keeps the TPU entry's contract:

  levels, batch_idx: [N] int32; origins: [N, 3] int32 slab origins (as
  ``axis_slab_weights`` places them against the zero-padded levels);
  wy, wx, wz: [N, p, sy], [N, p, sx], [N, p, sz] float32 weights;
  feature_maps: 4 x [B, H_l, W_l, D_l, C] channels-last; bounds: [2] int32
  (offset, count) on the features' device.

It returns [N, p, p, p, C] in the features' dtype; rows in
[offset, offset + count) hold sum_{a,b,k} wy*wx*wz * F[o + (a, b, k)],
other rows are zero. A voxel at or beyond a level's extent reads 0, which
is what the TPU entry's zero-padded levels give, so the levels are passed
unpadded. The entry is the ``torch.library`` op ``m3d_torch::roialign_slab``,
so an exported graph (m3d_torch/serve.py) calls it: on a CPU tensor it runs
``roialign_slab_plain``; on a CUDA tensor it launches the kernel or raises;
under tracing its fake gives the output's shape and dtype only.
"""

from __future__ import annotations

import torch

from m3d_torch.ops.cuda_build import (CudaLibrary, I, LaunchCount, P,
                                      on_card, stream_of)
from m3d_torch.ops.roialign_compact import (flatten_pyramid,
                                            refuse_feature_grad)

LIB = CudaLibrary("roialign_slab", {
    "roialign_slab_launch": [P] * 4 + [I] * 12 + [P] * 8 + [I] * 6 + [P]})
KERNEL = LaunchCount()


def check_slab_inputs(levels, batch_idx, origins, wy, wx, wz, feature_maps,
                      bounds):
    """Shared input checks of the slab-contract kernels; returns
    (N, p, (sy, sx, sz), C). A feature map that needs a gradient is
    refused: neither kernel has a backward."""
    dev = wy.device
    refuse_feature_grad(feature_maps, "slab ROIAlign")
    if len(feature_maps) != 4:
        raise ValueError(f"expected 4 pyramid levels, got {len(feature_maps)}")
    f0 = feature_maps[0]
    dtypes = ((torch.bfloat16,) if dev.type == "cuda"
              else (torch.bfloat16, torch.float32))
    if f0.dtype not in dtypes:
        raise TypeError(f"unsupported feature dtype {f0.dtype} on {dev}")
    b, c = f0.shape[0], f0.shape[-1]
    if c % 2:
        raise ValueError(f"channel count must be even, got {c}")
    for fm in feature_maps:
        if (fm.device != dev or fm.dtype != f0.dtype or fm.dim() != 5
                or fm.shape[0] != b or fm.shape[-1] != c
                or not fm.is_contiguous()):
            raise ValueError("feature maps must be contiguous [B,H,W,D,C] "
                             "tensors of one dtype on the weights' device")
    n, p = wy.shape[:2]
    for name, w in (("wy", wy), ("wx", wx), ("wz", wz)):
        if (w.device != dev or w.dtype != torch.float32 or w.dim() != 3
                or w.shape[:2] != (n, p) or not w.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 [N, p, s]")
    for name, t, shape in (("levels", levels, (n,)),
                           ("batch_idx", batch_idx, (n,)),
                           ("origins", origins, (n, 3)),
                           ("bounds", bounds, (2,))):
        if (t.device != dev or t.dtype != torch.int32 or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 {shape} "
                             f"on {dev}")
    return n, p, (wy.shape[2], wx.shape[2], wz.shape[2]), c


def roialign_slab_plain(levels, batch_idx, origins, wy, wx, wz, feature_maps,
                        bounds, rows_per_chunk: int = 32):
    """Plain PyTorch version: each live row's slab gathered (zero beyond
    the level's extent) and contracted with the three weight matrices by
    dense einsums in float32, ``rows_per_chunk`` rows at a time. Output in
    the features' dtype; rows outside ``bounds`` are zero. Reads
    ``bounds`` on the host."""
    n, p = wy.shape[:2]
    sizes = (wy.shape[2], wx.shape[2], wz.shape[2])
    dev = wy.device
    f0 = feature_maps[0]
    c = f0.shape[-1]
    out = torch.zeros((n, p, p, p, c), dtype=f0.dtype, device=dev)
    off, cnt = (int(v) for v in bounds.tolist())
    lo, hi = max(off, 0), min(off + cnt, n)
    if lo >= hi:
        return out
    flat, offsets, dims, cells = flatten_pyramid(feature_maps)
    dims_lut = torch.tensor(dims, dtype=torch.long, device=dev)
    off_lut = torch.tensor(offsets, dtype=torch.long, device=dev)
    for s in range(lo, hi, rows_per_chunk):
        rows = torch.arange(s, min(s + rows_per_chunk, hi), device=dev)
        lv = levels[rows].long()
        rd = dims_lut[lv]                                         # [r, 3]
        base = batch_idx[rows].long() * cells + off_lut[lv]
        coords, valid = [], []
        for a, size in enumerate(sizes):
            co = origins[rows, a].long()[:, None] + torch.arange(size,
                                                                 device=dev)
            valid.append((co >= 0) & (co < rd[:, a:a + 1]))
            coords.append(torch.minimum(co.clamp_min(0), rd[:, a:a + 1] - 1))
        (cy, cx, cz), (vy, vx, vz) = coords, valid
        sy_, sx_ = (rd[:, 1] * rd[:, 2])[:, None, None, None], \
            rd[:, 2][:, None, None, None]
        idx = (base[:, None, None, None] + cy[:, :, None, None] * sy_
               + cx[:, None, :, None] * sx_ + cz[:, None, None, :])
        slab = flat.index_select(0, idx.reshape(-1)).float().reshape(
            len(rows), *sizes, c)
        inside = (vy[:, :, None, None] & vx[:, None, :, None]
                  & vz[:, None, None, :])
        slab = torch.where(inside[..., None], slab, slab.new_zeros(()))
        t = torch.einsum("rps,rsxzc->rpxzc", wy[rows], slab)
        t = torch.einsum("rqx,rpxzc->rpqzc", wx[rows], t)
        t = torch.einsum("rkz,rpqzc->rpqkc", wz[rows], t)
        out[rows] = t.to(f0.dtype)
    return out


@torch.library.custom_op("m3d_torch::roialign_slab", mutates_args=(),
                         device_types="cpu")
def _slab_op(levels: torch.Tensor, batch_idx: torch.Tensor,
             origins: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor,
             wz: torch.Tensor, feature_maps: list[torch.Tensor],
             bounds: torch.Tensor) -> torch.Tensor:
    return roialign_slab_plain(levels, batch_idx, origins, wy, wx, wz,
                               feature_maps, bounds)


@_slab_op.register_kernel("cuda")
def _slab_launch(levels, batch_idx, origins, wy, wx, wz, feature_maps,
                 bounds):
    dev = wy.device
    n, p = wy.shape[:2]
    c = feature_maps[0].shape[-1]
    out = torch.empty((n, p, p, p, c), dtype=feature_maps[0].dtype,
                      device=dev)
    if n == 0:
        return out
    dims = [int(v) for fm in feature_maps for v in fm.shape[1:4]]
    with torch.cuda.device(dev):
        LIB.call("roialign_slab_launch",
                 *(fm.data_ptr() for fm in feature_maps), *dims,
                 levels.data_ptr(), batch_idx.data_ptr(), origins.data_ptr(),
                 wy.data_ptr(), wx.data_ptr(), wz.data_ptr(),
                 bounds.data_ptr(), out.data_ptr(), n, p, wy.shape[2],
                 wx.shape[2], wz.shape[2], c, stream_of(wy))
    KERNEL.launches += 1
    return out


@_slab_op.register_fake
def _slab_fake(levels, batch_idx, origins, wy, wx, wz, feature_maps,
               bounds):
    n, p = wy.shape[:2]
    f0 = feature_maps[0]
    return wy.new_empty((n, p, p, p, f0.shape[-1]), dtype=f0.dtype)


def roialign_slab(levels, batch_idx, origins, wy, wx, wz, feature_maps,
                  bounds):
    """Slab ROIAlign; see the module docstring for the contract."""
    check_slab_inputs(levels, batch_idx, origins, wy, wx, wz, feature_maps,
                      bounds)
    on_card(wy.device, "slab ROIAlign")
    return _slab_op(levels, batch_idx, origins, wy, wx, wz,
                    list(feature_maps), bounds)
