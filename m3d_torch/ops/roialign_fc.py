"""Slab pyramid ROIAlign fused with the classifier's pool-cube FC conv: the
Hopper kernel, its wrapper and its plain PyTorch version.

Replaces the TPU kernels ``_kernel_slab_fc_kron`` and ``_kernel_slab_fc``
(m3d/ops/pallas_roialign.py, entries ``pallas_pyramid_roi_align_fc_kron``
and ``pallas_pyramid_roi_align_fc``). Both compute one function from the
same inputs (the Kronecker weight of the first is built from the second's
``wy``/``wx``), so one kernel, m3d_torch/csrc/roialign_fc.cu, serves both;
its header note gives the function, the bound on an H100 and the design
(persistent, warp-specialised wgmma with TMA-fed weight tiles, K split on
the device from ``bounds``).

``roialign_fc`` takes the slab contract of m3d_torch/ops/roialign_slab.py
(levels, batch_idx, origins, wy, wx, wz, feature_maps, bounds) plus ``wk``,
the FC weight as [F, p^3 * C] in the features' dtype, K ordered as the
pooled [p, p, p, C] row flattens (``conv1_weight_fk``). It returns [N, F]
float32 without bias: rows in [offset, offset + count) hold the pooled row
(rounded to the features' dtype) times ``wk``, other rows are zero. The
entry is the ``torch.library`` op ``m3d_torch::roialign_fc``, so an exported
graph (m3d_torch/serve.py) calls it: on a CPU tensor it runs
``roialign_fc_plain``; on a CUDA tensor it launches the kernel or raises;
under tracing its fake gives the output's shape and dtype only.
"""

from __future__ import annotations

import torch

from m3d_torch.ops.cuda_build import (CudaLibrary, I, LaunchCount, P, on_card,
                                      stream_of)
from m3d_torch.ops.roialign_slab import check_slab_inputs, roialign_slab_plain

LIB = CudaLibrary("roialign_fc", {
    "roialign_fc_launch": [P] * 4 + [I] * 12 + [P] * 10 + [I] * 8 + [P]},
    link=("-lcuda",))
KERNEL = LaunchCount()
K_CHUNK = 64   # channels per K step of the kernel: C must be a multiple
F_GROUP = 512  # outputs per work item: the workspace holds [SMs, 64, 512]


def conv1_weight_fk(weight, dtype):
    """torch conv weight [F, C, p, p, p] -> [F, p^3 * C] in ``dtype``, K
    ordered (y, x, z, c) as the pooled row [p, p, p, C] flattens.

    The result is kept on ``weight`` and reused while the parameter's
    storage and version counter are unchanged: an in-place update (an
    optimizer step, ``load_state_dict``) rebuilds it on the next call.
    Under ``torch.export`` nothing is kept: the re-layout becomes part of
    the graph, which takes the weight as an argument."""
    if torch.compiler.is_exporting():
        return weight.permute(0, 2, 3, 4, 1).reshape(
            weight.shape[0], -1).to(dtype).contiguous()
    key = (weight.data_ptr(), weight._version, dtype, weight.device)
    cached = getattr(weight, "_m3d_fk", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    with torch.no_grad():
        wk = weight.permute(0, 2, 3, 4, 1).reshape(weight.shape[0], -1).to(
            dtype).contiguous()
    weight._m3d_fk = (key, wk)
    return wk


def roialign_fc_plain(levels, batch_idx, origins, wy, wx, wz, feature_maps,
                      wk, bounds):
    """Plain PyTorch version: the slab gather on the rows in ``bounds``,
    rounded to the features' dtype, then one float32 matmul with ``wk``
    (as [K, F], the operand layout of conv3d_fc's matmul, so both sum in
    one order)."""
    pooled = roialign_slab_plain(levels, batch_idx, origins, wy, wx, wz,
                                 feature_maps, bounds)
    return (pooled.reshape(pooled.shape[0], -1).float()
            @ wk.float().t().contiguous())


def fc_kernel_takes(c: int, f: int) -> bool:
    """True when the kernel takes C channels and F outputs (C % K_CHUNK and
    F % 8 both 0). The classifier's fused route asks this of the shapes
    alone, on every device, and sends every row to its fallback otherwise
    (m3d_torch.ops.roialign3d._roi_align_fc_flat_core)."""
    return c % K_CHUNK == 0 and f % 8 == 0


@torch.library.custom_op("m3d_torch::roialign_fc", mutates_args=(),
                         device_types="cpu")
def _fc_op(levels: torch.Tensor, batch_idx: torch.Tensor,
           origins: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor,
           wz: torch.Tensor, feature_maps: list[torch.Tensor],
           wk: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    return roialign_fc_plain(levels, batch_idx, origins, wy, wx, wz,
                             feature_maps, wk, bounds)


@_fc_op.register_kernel("cuda")
def _fc_launch(levels, batch_idx, origins, wy, wx, wz, feature_maps, wk,
               bounds):
    dev = wy.device
    n, p = wy.shape[:2]
    sy, sx, sz = wy.shape[2], wx.shape[2], wz.shape[2]
    c, f = feature_maps[0].shape[-1], wk.shape[0]
    if not fc_kernel_takes(c, f):
        raise ValueError(f"the kernel needs C % {K_CHUNK} == 0 and F % 8 == "
                         f"0, got C={c}, F={f}")
    if any(t.data_ptr() % 16 for t in (*feature_maps, wk)):
        raise ValueError("features and wk must be 16-byte aligned")
    out = torch.empty((n, f), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ws = torch.empty((sms, 64, F_GROUP), dtype=torch.float32, device=dev)
    dims = [int(v) for fm in feature_maps for v in fm.shape[1:4]]
    with torch.cuda.device(dev):
        LIB.call("roialign_fc_launch",
                 *(fm.data_ptr() for fm in feature_maps), *dims,
                 levels.data_ptr(), batch_idx.data_ptr(), origins.data_ptr(),
                 wy.data_ptr(), wx.data_ptr(), wz.data_ptr(),
                 bounds.data_ptr(), wk.data_ptr(), out.data_ptr(),
                 ws.data_ptr(), n, p, sy, sx, sz, c, f, sms,
                 stream_of(wy))
    KERNEL.launches += 1
    return out


@_fc_op.register_fake
def _fc_fake(levels, batch_idx, origins, wy, wx, wz, feature_maps, wk,
             bounds):
    return wy.new_empty((wy.shape[0], wk.shape[0]), dtype=torch.float32)


def roialign_fc(levels, batch_idx, origins, wy, wx, wz, feature_maps, wk,
                bounds):
    """Fused ROIAlign + FC; see the module docstring for the contract."""
    n, p, _, c = check_slab_inputs(
        levels, batch_idx, origins, wy, wx, wz, feature_maps, bounds)
    dev = wy.device
    f0 = feature_maps[0]
    if (wk.dim() != 2 or wk.shape[1] != p ** 3 * c or wk.dtype != f0.dtype
            or wk.device != dev or not wk.is_contiguous()):
        raise ValueError(f"wk must be contiguous [F, {p ** 3 * c}] "
                         f"{f0.dtype} on {dev}")
    on_card(dev, "fused ROIAlign+FC")
    return _fc_op(levels, batch_idx, origins, wy, wx, wz, list(feature_maps),
                  wk, bounds)
