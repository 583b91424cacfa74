"""Compact pyramid ROIAlign: the Hopper kernel, its wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``_kernel_vmem_compact``
(m3d/ops/pallas_roialign.py, entry ``pallas_pyramid_roi_align_vmem_compact``)
on the adaptive mask stage. The kernel source is
m3d_torch/csrc/roialign_compact.cu; its header note gives the function, the
bound on an H100 and the design.

``roialign_compact`` takes the flat ROI rows already routed to levels, with
per-axis sample positions computed as m3d.ops.roialign3d._axis_positions
does (m3d_torch.ops.roialign3d.pyramid_roi_align_compact prepares them):

  levels, batch_idx: [N] int32; total: [] int32 live leading rows;
  pos: [N, 3, p] float32 (y, x, z positions); feature_maps: 4 x
  [B, H_l, W_l, D_l, C] channels-last.

It returns [N, p, p, p, C] in the features' dtype, rows at or beyond
``total`` exactly zero. The kernel has no backward: both entries raise,
on any device, for a feature map that needs a gradient. Both are
``torch.library`` ops (``m3d_torch::roialign_compact``,
``m3d_torch::roialign_padded``), so an exported graph (m3d_torch/serve.py)
calls them: on a CPU tensor they run ``roialign_compact_plain``; on a CUDA
tensor they launch the kernel or raise; under tracing their fakes give the
output's shape and dtype only. The library is built
with nvcc into m3d_torch/_build/ on first use (m3d_torch/ops/cuda_build.py)
and rebuilt when the source changes.

``roialign_padded`` is the padded entry (TPU kernel ``_kernel_vmem``, entry
``pallas_pyramid_roi_align_vmem``): the same kernel over image-major rows
with every row live.
"""

from __future__ import annotations

import torch

from m3d_torch.ops.cuda_build import (CudaLibrary, I, LaunchCount, P, on_card,
                                      stream_of)


def trilinear_gather(flat, base, dims, strides, positions):
    """Trilinear samples from a flat [T, C] buffer (the gather formulation of
    m3d.ops.roialign3d._gather_interp), computed in float32.

    base: [N] int64 row offset of each ROI's source volume; dims: three [N]
    float extents (H, W, D); strides: three [N] int64 flat strides;
    positions: three [N, p] float32 grids. Returns [N, py, px, pz, C]
    float32 with out-of-range samples zero (no NaN scrub here).
    """
    n = positions[0].shape[0]
    py, px, pz = (p.shape[1] for p in positions)
    c = flat.shape[-1]
    corners = []
    for pos, size in zip(positions, dims):
        size = size[:, None]
        in_b = (pos >= 0.0) & (pos <= size - 1.0)
        pos_c = torch.minimum(torch.maximum(pos, torch.zeros_like(pos)),
                              size - 1.0)
        i0 = torch.floor(pos_c)
        w1 = pos_c - i0
        # NaN positions give garbage indices: clamp them into range (JAX's
        # gather clamps too); in_b zeroes those samples.
        i0 = torch.minimum(torch.clamp_min(i0.long(), 0), size.long() - 1)
        i1 = torch.minimum(i0 + 1, size.long() - 1)
        corners.append((i0, i1, w1, in_b))
    (y0, y1, wy, my), (x0, x1, wx, mx), (z0, z1, wz, mz) = corners
    sy, sx, sz = (s[:, None, None, None] for s in strides)
    in_bounds = (my[:, :, None, None] & mx[:, None, :, None]
                 & mz[:, None, None, :])

    out = torch.zeros((n, py, px, pz, c), dtype=torch.float32,
                      device=flat.device)
    for cy, wyc in ((y0, 1.0 - wy), (y1, wy)):
        for cx, wxc in ((x0, 1.0 - wx), (x1, wx)):
            for cz, wzc in ((z0, 1.0 - wz), (z1, wz)):
                idx = (base[:, None, None, None]
                       + cy[:, :, None, None] * sy
                       + cx[:, None, :, None] * sx
                       + cz[:, None, None, :] * sz)
                vals = flat.index_select(0, idx.reshape(-1)).float()
                w = (wyc[:, :, None, None] * wxc[:, None, :, None]
                     * wzc[:, None, None, :])
                out = out + vals.reshape(n, py, px, pz, c) * w[..., None]
    return torch.where(in_bounds[..., None], out, out.new_zeros(()))


def flatten_pyramid(feature_maps):
    """4 x [B, H, W, D, C] -> ([B * cells, C] buffer, per-level offsets,
    per-level (H, W, D), cells per image)."""
    bsz, c = feature_maps[0].shape[0], feature_maps[0].shape[-1]
    dims, offsets, parts = [], [], []
    offset = 0
    for fm in feature_maps:
        h, w, d = fm.shape[1:4]
        dims.append((h, w, d))
        offsets.append(offset)
        offset += h * w * d
        parts.append(fm.reshape(bsz, h * w * d, c))
    flat = torch.cat(parts, dim=1).reshape(bsz * offset, c)
    return flat, offsets, dims, offset


def roialign_compact_plain(levels, batch_idx, total, pos, feature_maps):
    """Plain PyTorch version of the kernel (float32 math, output in the
    features' dtype). Computes every row and zeroes rows >= total."""
    n, _, p = pos.shape
    dev = pos.device
    flat, offsets, dims, cells = flatten_pyramid(feature_maps)
    dims_lut = torch.tensor(dims, dtype=torch.long, device=dev)
    off_lut = torch.tensor(offsets, dtype=torch.long, device=dev)
    lv = levels.long()
    rd = dims_lut[lv]
    base = batch_idx.long() * cells + off_lut[lv]
    out = trilinear_gather(
        flat, base, dims=tuple(rd[:, a].float() for a in range(3)),
        strides=(rd[:, 1] * rd[:, 2], rd[:, 2], torch.ones_like(rd[:, 2])),
        positions=(pos[:, 0], pos[:, 1], pos[:, 2]))
    live = torch.arange(n, device=dev) < total.to(dev)
    keep = torch.isfinite(out) & live[:, None, None, None, None]
    out = torch.where(keep, out, torch.zeros((), device=dev))
    return out.to(feature_maps[0].dtype)


LIB = CudaLibrary("roialign_compact", {
    "roialign_compact_launch": [P] * 4 + [I] * 12 + [P] * 5 + [I] * 3 + [P]})
KERNEL = LaunchCount()   # roialign_compact (TPU kernel _kernel_vmem_compact)
PADDED = LaunchCount()   # roialign_padded (TPU kernel _kernel_vmem)


def needs_feature_grad(feature_maps) -> bool:
    """True where autograd would want a gradient of ``feature_maps``."""
    return torch.is_grad_enabled() and any(fm.requires_grad
                                           for fm in feature_maps)


def refuse_feature_grad(feature_maps, what: str) -> None:
    """Raise where a feature map needs a gradient: no kernel (and no TPU
    kernel it replaces) defines a backward, so its result would come back
    silently detached. Such callers take the differentiable gather
    (``pyramid_roi_align``; ``pyramid_roi_align_auto`` picks it). The
    wrappers' input checks are the one place that calls this."""
    if needs_feature_grad(feature_maps):
        raise RuntimeError(f"{what}: a feature map requires a gradient and "
                           f"the kernel has no backward; use the gather "
                           f"(pyramid_roi_align)")


def _check(levels, batch_idx, total, pos, feature_maps):
    """The wrappers' input checks (``batch_idx`` and ``total`` None: the
    padded entry, which builds them)."""
    dev = pos.device
    refuse_feature_grad(feature_maps, "compact ROIAlign")
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
                             "tensors of one dtype on the positions' device")
    if pos.dtype != torch.float32 or pos.dim() != 3 or pos.shape[1] != 3 \
            or not pos.is_contiguous():
        raise ValueError("pos must be contiguous float32 [N, 3, p]")
    n = pos.shape[0]
    for name, t in (("levels", levels), ("batch_idx", batch_idx)):
        if t is not None and (t.device != dev or t.dtype != torch.int32
                              or t.shape != (n,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 [N] on {dev}")
    if total is not None and (total.device != dev or total.dtype != torch.int32
                              or total.numel() != 1):
        raise ValueError(f"total must be one int32 on {dev}")


def _launch(levels, batch_idx, total, pos, feature_maps, count):
    """Launch the kernel (no launch for zero rows); adds to ``count`` only
    where it launches."""
    n, _, p = pos.shape
    f0 = feature_maps[0]
    c = f0.shape[-1]
    if c % 8 or any(fm.data_ptr() % 16 for fm in feature_maps):
        raise ValueError(f"the kernel needs C % 8 == 0 and 16-byte aligned "
                         f"features, got C={c}")
    out = torch.empty((n, p, p, p, c), dtype=f0.dtype, device=pos.device)
    if n == 0:
        return out
    dims = [int(v) for fm in feature_maps for v in fm.shape[1:4]]
    with torch.cuda.device(pos.device):
        LIB.call("roialign_compact_launch",
                 *(fm.data_ptr() for fm in feature_maps), *dims,
                 levels.data_ptr(), batch_idx.data_ptr(), total.data_ptr(),
                 pos.data_ptr(), out.data_ptr(), n, p, c, stream_of(pos))
    count.launches += 1
    return out


def _padded_rows(n: int, n_per_image: int, dev):
    """batch_idx = i // n_per_image and total = N of the padded entry."""
    batch_idx = torch.div(torch.arange(n, device=dev, dtype=torch.int32),
                          n_per_image, rounding_mode="floor")
    return batch_idx, torch.full((), n, dtype=torch.int32, device=dev)


def _rows_fake(pos, feature_maps):
    n, _, p = pos.shape
    f0 = feature_maps[0]
    return pos.new_empty((n, p, p, p, f0.shape[-1]), dtype=f0.dtype)


@torch.library.custom_op("m3d_torch::roialign_compact", mutates_args=(),
                         device_types="cpu")
def _compact_op(levels: torch.Tensor, batch_idx: torch.Tensor,
                total: torch.Tensor, pos: torch.Tensor,
                feature_maps: list[torch.Tensor]) -> torch.Tensor:
    return roialign_compact_plain(levels, batch_idx, total, pos,
                                  feature_maps)


@_compact_op.register_kernel("cuda")
def _compact_launch(levels, batch_idx, total, pos, feature_maps):
    return _launch(levels, batch_idx, total, pos, feature_maps, KERNEL)


@_compact_op.register_fake
def _compact_fake(levels, batch_idx, total, pos, feature_maps):
    return _rows_fake(pos, feature_maps)


@torch.library.custom_op("m3d_torch::roialign_padded", mutates_args=(),
                         device_types="cpu")
def _padded_op(levels: torch.Tensor, pos: torch.Tensor,
               feature_maps: list[torch.Tensor],
               n_per_image: int) -> torch.Tensor:
    return roialign_compact_plain(
        levels, *_padded_rows(pos.shape[0], n_per_image, pos.device), pos,
        feature_maps)


@_padded_op.register_kernel("cuda")
def _padded_launch(levels, pos, feature_maps, n_per_image):
    return _launch(levels, *_padded_rows(pos.shape[0], n_per_image,
                                         pos.device),
                   pos, feature_maps, PADDED)


@_padded_op.register_fake
def _padded_fake(levels, pos, feature_maps, n_per_image):
    return _rows_fake(pos, feature_maps)


def roialign_compact(levels, batch_idx, total, pos, feature_maps):
    """Compact ROIAlign; see the module docstring for the contract."""
    _check(levels, batch_idx, total, pos, feature_maps)
    on_card(pos.device, "compact ROIAlign")
    return _compact_op(levels, batch_idx, total, pos, list(feature_maps))


def roialign_padded(levels, pos, feature_maps, n_per_image: int):
    """Padded pyramid ROIAlign (the function of the TPU kernel
    ``_kernel_vmem``): image-major rows, ``n_per_image`` per image, every
    row computed. The compact kernel computes it with ``batch_idx = i //
    n_per_image`` and ``total = N`` (a device tensor: no host sync); its
    launches count under ``PADDED``. Returns [N, p, p, p, C]."""
    n = pos.shape[0]
    if n_per_image <= 0 or n % n_per_image:
        raise ValueError(f"{n} rows are not whole images of {n_per_image}")
    _check(levels, None, None, pos, feature_maps)
    on_card(pos.device, "padded ROIAlign")
    return _padded_op(levels, pos, list(feature_maps), int(n_per_image))
