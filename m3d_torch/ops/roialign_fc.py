"""Slab pyramid ROIAlign fused with the classifier's pool-cube FC conv: the
Hopper kernel, its wrapper and its plain PyTorch version.

Replaces the TPU kernels ``_kernel_slab_fc_kron`` and ``_kernel_slab_fc``
(m3d/ops/pallas_roialign.py, entries ``pallas_pyramid_roi_align_fc_kron``
and ``pallas_pyramid_roi_align_fc``). Both compute one function from the
same inputs (the Kronecker weight of the first is built from the second's
``wy``/``wx``), so one kernel, m3d_torch/csrc/roialign_fc.cu, serves both;
its header note gives the function, the bound on an H100 and the design.

``roialign_fc`` takes the slab contract of m3d_torch/ops/roialign_slab.py
(levels, batch_idx, origins, wy, wx, wz, feature_maps, bounds) plus ``wk``,
the FC weight in the kernel's K order ([p^3 * C, F] in the features'
dtype, ``conv1_weight_kf``). It returns [N, F] float32 without bias: rows in
[offset, offset + count) hold the pooled row (rounded to the features'
dtype) times ``wk``, other rows are zero. On a CPU tensor it runs
``roialign_fc_plain``; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from m3d_torch.ops.cuda_build import (CudaLibrary, I, LaunchCount, P, on_card,
                                      stream_of)
from m3d_torch.ops.roialign_slab import check_slab_inputs, roialign_slab_plain

LIB = CudaLibrary("roialign_fc", {
    "roialign_fc_launch": [P] * 4 + [I] * 12 + [P] * 9 + [I] * 7 + [P]})
KERNEL = LaunchCount()
K_CHUNK = 64  # channels per K chunk of the kernel: C must be a multiple


def conv1_weight_kf(weight, dtype):
    """torch conv weight [F, C, p, p, p] -> [p^3 * C, F] in ``dtype``, K
    ordered (y, x, z, c) as the pooled row [p, p, p, C] flattens."""
    return weight.permute(2, 3, 4, 1, 0).reshape(-1, weight.shape[0]).to(
        dtype).contiguous()


def roialign_fc_plain(levels, batch_idx, origins, wy, wx, wz, feature_maps,
                      wk, bounds):
    """Plain PyTorch version: the slab gather on the rows in ``bounds``,
    rounded to the features' dtype, then one float32 matmul with ``wk``."""
    pooled = roialign_slab_plain(levels, batch_idx, origins, wy, wx, wz,
                                 feature_maps, bounds)
    return pooled.reshape(pooled.shape[0], -1).float() @ wk.float()


def roialign_fc(levels, batch_idx, origins, wy, wx, wz, feature_maps, wk,
                bounds):
    """Fused ROIAlign + FC; see the module docstring for the contract."""
    n, p, (sy, sx, sz), c = check_slab_inputs(
        levels, batch_idx, origins, wy, wx, wz, feature_maps, bounds)
    dev = wy.device
    f0 = feature_maps[0]
    if (wk.dim() != 2 or wk.shape[0] != p ** 3 * c or wk.dtype != f0.dtype
            or wk.device != dev or not wk.is_contiguous()):
        raise ValueError(f"wk must be contiguous [{p ** 3 * c}, F] "
                         f"{f0.dtype} on {dev}")
    f = wk.shape[1]
    if not on_card(dev, "fused ROIAlign+FC"):
        return roialign_fc_plain(levels, batch_idx, origins, wy, wx, wz,
                                 feature_maps, wk, bounds)
    if c % K_CHUNK or f % 8:
        raise ValueError(f"the kernel needs C % {K_CHUNK} == 0 and F % 8 == "
                         f"0, got C={c}, F={f}")
    if any(t.data_ptr() % 16 for t in (*feature_maps, wk)):
        raise ValueError("features and wk must be 16-byte aligned")
    out = torch.empty((n, f), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    dims = [int(v) for fm in feature_maps for v in fm.shape[1:4]]
    with torch.cuda.device(dev):
        LIB.call("roialign_fc_launch",
                 *(fm.data_ptr() for fm in feature_maps), *dims,
                 levels.data_ptr(), batch_idx.data_ptr(), origins.data_ptr(),
                 wy.data_ptr(), wx.data_ptr(), wz.data_ptr(),
                 bounds.data_ptr(), wk.data_ptr(), out.data_ptr(), n, p, sy,
                 sx, sz, c, f, stream_of(wy))
    KERNEL.launches += 1
    return out
