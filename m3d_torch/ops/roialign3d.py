"""Pyramid 3D ROIAlign (port of m3d/ops/roialign3d.py): ``crop_and_resize_3d``
(the mask-target crop), flat, compact and padded gather entries, the kernel entries of the monolithic graph
(``pyramid_roi_align_pallas``, ``pyramid_roi_align_auto``) and the fused
ROIAlign + classifier FC (``pyramid_roi_align_fc``, ``_flat``).

Sampling follows TF crop_and_resize, generalized to 3-D:

  for crop size p > 1:   pos_i = b1 * (S - 1) + i * (b2 - b1) * (S - 1) / (p - 1)
  for crop size p == 1:  pos   = 0.5 * (b1 + b2) * (S - 1)

with out-of-range positions giving 0. Each ROI is routed to one FPN level
(``compute_roi_levels``) and sampled trilinearly from it. Boxes are
sanitized exactly as the JAX entries do, and non-finite outputs become 0.
"""

from __future__ import annotations

import torch

from m3d_torch import trace
from m3d_torch.image_meta import parse_image_meta
from m3d_torch.ops.conv3d import conv3d_fc
from m3d_torch.ops.roialign_compact import (flatten_pyramid,
                                            needs_feature_grad,
                                            roialign_compact,
                                            roialign_padded, trilinear_gather)
from m3d_torch.ops.roialign_fc import (conv1_weight_fk, fc_kernel_takes,
                                       roialign_fc)
from m3d_torch.ops.roialign_slab import roialign_slab

Z_ALIGN = 8  # slab z origins are 8-aligned, as the JAX entries place them


def axis_positions(lo, hi, size, crop: int):
    """Sample positions along one axis. lo/hi/size: [N]. Returns [N, crop]."""
    span = size.float() - 1.0
    if crop > 1:
        frac = torch.arange(crop, dtype=torch.float32,
                            device=lo.device) / (crop - 1)
        return lo[:, None] * span[:, None] + (
            (hi - lo)[:, None] * span[:, None]) * frac[None, :]
    return (0.5 * (lo + hi) * span)[:, None]


def crop_and_resize_3d(features, boxes, box_indices, crop_size,
                       method: str = "trilinear"):
    """Crop N boxes from a batch of volumes and resize each to
    ``crop_size`` (port of m3d.ops.roialign3d.crop_and_resize_3d; plain
    PyTorch, as JAX computes it outside any Pallas kernel).

    features: [B, H, W, D, C]; boxes: [N, 6] normalized (no gradient);
    box_indices: [N] batch index per box; method "trilinear" or "nearest".
    Returns [N, py, px, pz, C] in the features' dtype (float32 math).
    """
    b, h, w, d, c = features.shape
    py, px, pz = (int(v) for v in crop_size)
    boxes = boxes.detach().float()
    dev = features.device
    n = boxes.shape[0]
    sizes = [torch.full((n,), float(v), device=dev) for v in (h, w, d)]
    pos = tuple(axis_positions(boxes[:, a], boxes[:, a + 3], sizes[a], q)
                for a, q in enumerate((py, px, pz)))
    flat = features.reshape(b * h * w * d, c)
    base = box_indices.long() * (h * w * d)
    if method == "trilinear":
        strides = tuple(torch.full((n,), v, dtype=torch.long, device=dev)
                        for v in (w * d, d, 1))
        out = trilinear_gather(flat, base, sizes, strides, pos)
    elif method == "nearest":
        idx, inb = [], []
        for q, size in zip(pos, (h, w, d)):
            inb.append((q >= 0.0) & (q <= size - 1.0))
            idx.append(torch.round(q).clamp(0, size - 1).long())
        iy, ix, iz = idx
        flat_idx = (base[:, None, None, None] + iy[:, :, None, None] * (w * d)
                    + ix[:, None, :, None] * d + iz[:, None, None, :])
        out = flat.index_select(0, flat_idx.reshape(-1)).reshape(
            n, py, px, pz, c).float()
        m = inb[0][:, :, None, None] & inb[1][:, None, :, None] \
            & inb[2][:, None, None, :]
        out = torch.where(m[..., None], out, out.new_zeros(()))
    else:
        raise ValueError(f"unknown method {method!r}")
    return out.to(features.dtype)


def compute_roi_levels(boxes, image_shape, num_levels: int = 4):
    """FPN level per ROI (0 == P2):
    clamp(4 + round(log2(cbrt(vol_norm) * cbrt(HWD) / 224)), 2, 5) - 2.
    image_shape: (H, W, D), each [N] or scalar, in pixels."""
    h = boxes[..., 3] - boxes[..., 0]
    w = boxes[..., 4] - boxes[..., 1]
    d = boxes[..., 5] - boxes[..., 2]
    vol = torch.clamp_min(h * w * d, 1e-12)
    image_volume = (image_shape[0].float() * image_shape[1].float()
                    * image_shape[2].float())
    lvl = torch.log2(torch.pow(vol, 1.0 / 3.0)
                     / (224.0 / torch.pow(image_volume, 1.0 / 3.0)))
    lvl = 4 + torch.round(lvl).to(torch.int32)
    return (lvl.clamp(2, 2 + num_levels - 1) - 2).to(torch.int32)


def sanitize_flat_rois(boxes, batch_idx, image_meta, num_levels: int):
    """Clip boxes to [0, 1], give each positive extent (1e-6 in y/x, one
    voxel of its image in z) and route it to a level. Returns
    (boxes [N, 6] float32, levels [N] int32)."""
    image_shape = parse_image_meta(image_meta.float())["image_shape"]
    boxes = boxes.detach().float()
    shp = image_shape[batch_idx.long()]
    d_img = shp[:, 2].clamp_min(1.0)
    y1 = boxes[:, 0].clamp(0.0, 1.0)
    x1 = boxes[:, 1].clamp(0.0, 1.0)
    z1 = boxes[:, 2].clamp(0.0, 1.0)
    y2 = torch.maximum(boxes[:, 3].clamp(0.0, 1.0), y1 + 1e-6)
    x2 = torch.maximum(boxes[:, 4].clamp(0.0, 1.0), x1 + 1e-6)
    z2 = torch.maximum(boxes[:, 5].clamp(0.0, 1.0), z1 + 1.0 / d_img)
    boxes = torch.stack([y1, x1, z1, y2, x2, z2], dim=-1)
    levels = compute_roi_levels(boxes, (shp[:, 0], shp[:, 1], shp[:, 2]),
                                num_levels)
    return boxes, levels


def _pool_size(pool_size) -> int:
    if isinstance(pool_size, (tuple, list)):
        if len(set(pool_size)) != 1:
            raise ValueError(f"only cubic pools are supported: {pool_size}")
        pool_size = pool_size[0]
    return int(pool_size)


def _int_table(rows, device, site: str):
    """An int64 tensor of the nested int lists ``rows``, copied to
    ``device`` (on a card the copy waits for the stream: a host wait at
    ``table.<site>``). Under export it is built from ops, not as a tensor
    constant: the adaptive classifier runs in traced ``cond``
    branches, whose graphs cannot hold one."""
    if not torch.compiler.is_exporting():
        with trace.waits(f"table.{site}"):
            return torch.tensor(rows, dtype=torch.long, device=device)
    return torch.stack([
        torch.stack([torch.full((), int(v), dtype=torch.long, device=device)
                     for v in row]) if isinstance(row, (tuple, list))
        else torch.full((), int(row), dtype=torch.long, device=device)
        for row in rows])


def _level_positions(boxes, levels, feature_maps, p: int):
    """Per-ROI level extents [N, 3] (int64) and sample positions, three
    [N, p] float32 grids."""
    dims = _int_table([tuple(fm.shape[1:4]) for fm in feature_maps],
                      boxes.device, "_level_positions")
    rd = dims[levels.long()]
    pos = tuple(axis_positions(boxes[:, a], boxes[:, a + 3], rd[:, a], p)
                for a in range(3))
    return rd, pos


def gather_flat_sanitized(boxes, levels, batch_idx, feature_maps, p: int):
    """Gather-path ROIAlign over sanitized, routed boxes. Returns
    [N, p, p, p, C] in the features' dtype (float32 math), NaN-scrubbed."""
    flat, offsets, _, cells = flatten_pyramid(feature_maps)
    rd, pos = _level_positions(boxes, levels, feature_maps, p)
    off = _int_table(offsets, boxes.device, "gather_flat_sanitized")
    base = batch_idx.long() * cells + off[levels.long()]
    out = trilinear_gather(
        flat, base, dims=tuple(rd[:, a].float() for a in range(3)),
        strides=(rd[:, 1] * rd[:, 2], rd[:, 2], torch.ones_like(rd[:, 2])),
        positions=pos)
    out = torch.where(torch.isfinite(out), out, out.new_zeros(()))
    return out.to(feature_maps[0].dtype)


def pyramid_roi_align_flat(boxes, batch_idx, image_meta, feature_maps,
                           pool_size):
    """Pyramid ROIAlign over a flat ROI list ([N, 6] boxes, [N] source-image
    indices); computes every row. Returns [N, p, p, p, C]."""
    p = _pool_size(pool_size)
    boxes, levels = sanitize_flat_rois(boxes, batch_idx, image_meta,
                                       len(feature_maps))
    return gather_flat_sanitized(boxes, levels, batch_idx, feature_maps, p)


def pyramid_roi_align_compact(boxes, batch_idx, total, image_meta,
                              feature_maps, pool_size):
    """Pyramid ROIAlign over a compacted flat ROI list (rows grouped by
    image, live rows first); only rows < ``total`` are computed, later rows
    are zero. ``total`` is a [] int32 tensor on the features' device and is
    never read on the host. Returns [N, p, p, p, C] in the features' dtype.
    """
    p = _pool_size(pool_size)
    dev = feature_maps[0].device
    batch_idx = batch_idx.to(device=dev, dtype=torch.int32)
    boxes, levels = sanitize_flat_rois(boxes, batch_idx, image_meta,
                                       len(feature_maps))
    _, pos = _level_positions(boxes, levels, feature_maps, p)
    pos = torch.stack(pos, dim=1).contiguous()                  # [N, 3, p]
    total = torch.as_tensor(total, device=dev).to(torch.int32).reshape(())
    fms = [fm.contiguous() for fm in feature_maps]
    return roialign_compact(levels.contiguous(), batch_idx.contiguous(),
                            total, pos, fms)


# Padded [B, N] entries and the slab contract ------------------------------

def axis_slab_weights(pos, dim, slab: int, align: int = 1, origin_dim=None):
    """Per-axis slab origin and interpolation weights (port of
    m3d.ops.roialign3d._axis_slab_weights).

    pos: [N, p] sample positions in level coordinates; dim: [N] level
    extent; origin_dim: [N] extent used to place the slab (the padded
    extent), default ``dim``. Returns (origin [N] int32, W [N, p, slab]
    float32) with ``out_i = sum_s W[i, s] * F[origin + s]`` the clamped
    linear interpolation with zero extrapolation (exact when the span fits
    the slab).
    """
    dim = dim.float()[:, None]
    odim = dim[:, 0] if origin_dim is None else origin_dim.float()
    valid = (pos >= 0.0) & (pos <= dim - 1.0)
    pos_c = torch.minimum(torch.clamp_min(pos, 0.0), dim - 1.0)
    top = torch.clamp_min(odim - slab, 0.0)
    origin = torch.minimum(
        torch.clamp_min(torch.floor(pos_c.min(dim=1).values), 0.0), top)
    if align > 1:
        origin = torch.floor(origin / align) * align
        origin = torch.minimum(origin, torch.floor(top / align) * align)
    rel = (pos_c - origin[:, None]).clamp(0.0, slab - 1.0)
    i0 = torch.floor(rel)
    frac = rel - i0
    max_col = torch.clamp_max(dim - 1.0 - origin[:, None], float(slab - 1))
    i1 = torch.minimum(i0 + 1.0, max_col)
    cols = torch.arange(slab, dtype=torch.float32, device=pos.device)
    w0 = (cols == i0[..., None]).float() * (1.0 - frac)[..., None]
    w1 = (cols == i1[..., None]).float() * frac[..., None]
    w = (w0 + w1) * valid[..., None].float()
    return origin.to(torch.int32), w


def slab_sizes(feature_maps, cap_yx: int = 32, cap_z: int = 64):
    """Per-axis slab extents (sy, sx, sz) from the level extents: the
    largest extent on each axis, capped."""
    return (min(cap_yx, max(fm.shape[1] for fm in feature_maps)),
            min(cap_yx, max(fm.shape[2] for fm in feature_maps)),
            min(cap_z, max(fm.shape[3] for fm in feature_maps)))


def _slab_geometry(feature_maps, slab=None):
    """(sy, sx, sz) of the exact-coverage slab, z enlarged and 8-aligned
    as the JAX entries do, and the [L, 3] level extents the JAX entries pad
    the levels to (origins are placed against those)."""
    if slab is None:
        slab = slab_sizes(feature_maps)
    elif isinstance(slab, int):
        slab = (slab,) * 3
    s_y, s_x, slab_z = (int(v) for v in slab)
    max_d = max(fm.shape[3] for fm in feature_maps)
    if slab_z < max_d:
        slab_z += Z_ALIGN
    slab_z += (-slab_z) % Z_ALIGN
    padded = []
    for fm in feature_maps:
        hl, wl, dl = fm.shape[1:4]
        dz_pad = max(0, slab_z - dl) + (-max(dl, slab_z)) % Z_ALIGN
        padded.append((max(hl, s_y), max(wl, s_x), dl + dz_pad))
    with trace.waits("table._slab_geometry"):
        return (s_y, s_x, slab_z), torch.tensor(
            padded, dtype=torch.long, device=feature_maps[0].device)


def _cells_needed(pos, dim):
    pc = torch.minimum(torch.clamp_min(pos, 0.0), dim[:, None] - 1.0)
    return (torch.floor(pc.max(dim=1).values)
            - torch.floor(pc.min(dim=1).values)).to(torch.int32) + 2


def _slab_weights(pos, rd, pdims, slab):
    """Origins [N, 3] int32 and (wy, wx, wz) for one slab size."""
    out = [axis_slab_weights(pos[a], rd[:, a], slab[a],
                             align=Z_ALIGN if a == 2 else 1,
                             origin_dim=pdims[:, a]) for a in range(3)]
    origins = torch.stack([o for o, _ in out], dim=1).contiguous()
    return (origins, *(w.contiguous() for _, w in out))


def _flat_rows(boxes, image_meta, num_levels):
    """[B, N, 6] boxes -> sanitized flat boxes [B*N, 6], levels and image
    indices [B*N] int32 (image-major)."""
    bsz, n = boxes.shape[:2]
    batch_f = torch.arange(bsz, dtype=torch.int32,
                           device=boxes.device).repeat_interleave(n)
    boxes_f, levels_f = sanitize_flat_rois(boxes.reshape(bsz * n, 6), batch_f,
                                           image_meta, num_levels)
    return boxes_f, levels_f, batch_f


def pyramid_roi_align(boxes, image_meta, feature_maps, pool_size):
    """Gather-path ROIAlign over padded [B, N, 6] boxes (port of the
    trilinear m3d.ops.roialign3d.pyramid_roi_align): the CPU route and the
    plain reference of the kernel entries. Returns [B, N, p, p, p, C] in
    the features' dtype (float32 math), NaN-scrubbed."""
    p = _pool_size(pool_size)
    bsz, n = boxes.shape[:2]
    boxes_f, levels_f, batch_f = _flat_rows(boxes, image_meta,
                                            len(feature_maps))
    out = gather_flat_sanitized(boxes_f, levels_f, batch_f,
                                list(feature_maps), p)
    return out.reshape(bsz, n, *out.shape[1:])


def pyramid_roi_align_pallas(boxes, image_meta, feature_maps, pool_size,
                             slab=None):
    """Kernel ROIAlign over padded [B, N, 6] boxes (port of
    m3d.ops.roialign3d.pyramid_roi_align_pallas).

    ``slab=None``: every row through the padded kernel (TPU kernel
    ``_kernel_vmem``; on the TPU only for pyramids that fit its VMEM, but
    the Hopper kernel is exact at any extent, as is the tiered branch, so
    the function is the same). An explicit ``slab``: the span-tiered
    branch, each tier one slab-kernel launch over its (offset, count)
    range of the span-sorted rows. Returns [B, N, p, p, p, C] in the
    features' dtype.

    No kernel has a backward (nor has JAX's entry: "use the XLA path for
    training"), so a feature map that needs a gradient raises, on any
    device, in the input checks of the wrapper that each branch calls;
    ``pyramid_roi_align_auto`` sends those to the gather.
    """
    p = _pool_size(pool_size)
    fms = [fm.contiguous() for fm in feature_maps]
    bsz, n = boxes.shape[:2]
    boxes_f, levels_f, batch_f = _flat_rows(boxes.to(fms[0].device),
                                            image_meta, len(fms))
    if slab is None:
        _, pos = _level_positions(boxes_f, levels_f, fms, p)
        out = roialign_padded(levels_f.contiguous(),
                              torch.stack(pos, dim=1).contiguous(), fms, n)
        return out.reshape(bsz, n, *out.shape[1:])
    out = _tiered_slab(boxes_f, levels_f, batch_f, fms, p, slab)
    out = torch.where(torch.isfinite(out), out, out.new_zeros(()))
    return out.reshape(bsz, n, *out.shape[1:])


def _tiered_slab(boxes_f, levels_f, batch_f, fms, p, slab):
    """The span-tiered branch of pyramid_roi_align_pallas over flat rows:
    smaller slab tiers for rows whose sample span fits them, the full slab
    for the rest; counts and offsets stay on the device."""
    (s_y, s_x, slab_z), pdims_lut = _slab_geometry(fms, slab)
    tiers = []
    for ty, tx, tz in ((8, 8, 16), (16, 16, 24)):
        if ty < s_y or tx < s_x or tz < slab_z:
            tiers.append((min(ty, s_y), min(tx, s_x), min(tz, slab_z)))
    tiers.append((s_y, s_x, slab_z))
    rd, pos = _level_positions(boxes_f, levels_f, fms, p)
    rdf = rd.float()
    need = [_cells_needed(pos[a], rdf[:, a]) for a in range(3)]
    need[2] = need[2] + (Z_ALIGN - 1)
    tier_id = torch.full_like(levels_f, len(tiers) - 1)
    for t in range(len(tiers) - 2, -1, -1):
        fits = ((need[0] <= tiers[t][0]) & (need[1] <= tiers[t][1])
                & (need[2] <= tiers[t][2]))
        tier_id = torch.where(fits, torch.full_like(tier_id, t), tier_id)
    order = torch.argsort(tier_id, stable=True)
    inv = torch.argsort(order, stable=True)
    tier_s = tier_id[order]
    levels_s = levels_f[order].contiguous()
    batch_s = batch_f[order].contiguous()
    rd_s = rd[order]
    pos_s = [q[order] for q in pos]
    counts = torch.stack([(tier_id == t).sum()
                          for t in range(len(tiers))]).to(torch.int32)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    pdims = pdims_lut[levels_s.long()]
    out = None
    for t, tier in enumerate(tiers):
        origins, wy, wx, wz = _slab_weights(pos_s, rd_s, pdims, tier)
        bounds = torch.stack([offsets[t], counts[t]]).contiguous()
        part = roialign_slab(levels_s, batch_s, origins, wy, wx, wz, fms,
                             bounds)
        out = part if out is None else torch.where(
            (tier_s == t)[:, None, None, None, None], part, out)
    return out[inv]


def fused_classifier_ok(pool_size, feature_maps) -> bool:
    """True when the fused ROIAlign+FC entry serves the classifier stage: a
    cubic pool over four levels of bf16 or float32 features with an even C.
    The rule reads shapes and dtypes only, never the device, so a graph
    routes the same way wherever it was traced (the card takes bf16 alone:
    its kernels raise for float32 features, on this route and the other).
    Rows of a (C, F) the fused kernel cannot take go to its fallback route
    inside the entry (``fc_kernel_takes``)."""
    if isinstance(pool_size, (tuple, list)) and len(set(pool_size)) != 1:
        return False
    if len(feature_maps) != 4:
        return False
    f0 = feature_maps[0]
    return f0.dtype in (torch.bfloat16, torch.float32) and f0.shape[-1] % 2 == 0


def pyramid_roi_align_auto(boxes, image_meta, feature_maps, pool_size):
    """Padded [B, N] ROIAlign dispatch: the differentiable gather
    (``pyramid_roi_align``) where a feature map needs a gradient (the
    MRCNN train step with LEARNING_LAYERS "all" or "rpn", on any device),
    else the padded kernel entry (``pyramid_roi_align_pallas``: the kernel
    on a CUDA tensor, its plain version on a CPU tensor; the same function
    as the gather). The TPU cost model of the JAX dispatch is not carried
    over."""
    if needs_feature_grad(feature_maps):
        return pyramid_roi_align(boxes, image_meta, feature_maps, pool_size)
    return pyramid_roi_align_pallas(boxes, image_meta, feature_maps,
                                    pool_size)


def pyramid_roi_align_fc(boxes, image_meta, feature_maps, pool_size,
                         fc_weight, fc_slab_cap=(16, 16, 24),
                         kernel: str = "separable"):
    """Pyramid ROIAlign fused with the pool-cube FC conv over padded
    [B, N, 6] boxes (port of m3d.ops.roialign3d.pyramid_roi_align_fc).

    fc_weight: the conv weight in torch layout [F, C, p, p, p]. Returns
    [B, N, F] float32, bias not applied. ``kernel`` "kron" and "separable"
    name the two TPU formulations of one function: both are the same
    launch here.
    """
    bsz, n = boxes.shape[:2]
    fms = [fm.contiguous() for fm in feature_maps]
    boxes_f, levels_f, batch_f = _flat_rows(boxes.to(fms[0].device),
                                            image_meta, len(fms))
    out = _roi_align_fc_flat_core(boxes_f, levels_f, batch_f, fms,
                                  _pool_size(pool_size), fc_weight,
                                  fc_slab_cap, kernel)
    return out.reshape(bsz, n, -1)


def pyramid_roi_align_fc_flat(boxes, batch_idx, image_meta, feature_maps,
                              pool_size, fc_weight, fc_slab_cap=(16, 16, 24),
                              kernel: str = "kron"):
    """pyramid_roi_align_fc over a flat ROI list ([N, 6] boxes, [N] image
    indices). Returns [N, F] float32, bias not applied."""
    fms = [fm.contiguous() for fm in feature_maps]
    batch_idx = batch_idx.to(device=fms[0].device, dtype=torch.int32)
    boxes_f, levels_f = sanitize_flat_rois(boxes.to(fms[0].device), batch_idx,
                                           image_meta, len(fms))
    return _roi_align_fc_flat_core(boxes_f, levels_f, batch_idx, fms,
                                   _pool_size(pool_size), fc_weight,
                                   fc_slab_cap, kernel)


def _roi_align_fc_flat_core(boxes_f, levels_f, batch_f, fms, p, fc_weight,
                            fc_slab_cap, kernel):
    """Rows whose sample span fits ``fc_slab = min(fc_slab_cap, slab)`` go
    first, through the fused kernel with bounds (0, n_fit); the rest
    through the slab kernel at the exact-coverage slab with bounds
    (n_fit, N - n_fit) and ``conv3d_fc`` (over all N rows, as in JAX).
    The two are combined by row index and un-sorted. ``n_fit`` stays on
    the device: no host sync. Where the fused kernel cannot take the
    features' C or the weight's F (``fc_kernel_takes``), on any device,
    every row takes the fallback route and the fused entry is not called.
    """
    if kernel not in ("kron", "separable"):
        raise ValueError(f"unknown fused kernel {kernel!r}")
    n_flat = boxes_f.shape[0]
    slab, pdims_lut = _slab_geometry(fms)
    fc_slab = tuple(min(cap, s) for cap, s in zip(fc_slab_cap, slab))
    rd, pos = _level_positions(boxes_f, levels_f, fms, p)
    rdf = rd.float()
    fused = fc_kernel_takes(fms[0].shape[-1], fc_weight.shape[0])
    fits = ((_cells_needed(pos[0], rdf[:, 0]) <= fc_slab[0])
            & (_cells_needed(pos[1], rdf[:, 1]) <= fc_slab[1])
            & (_cells_needed(pos[2], rdf[:, 2]) + (Z_ALIGN - 1) <= fc_slab[2])
            & fused)
    order = torch.sort((~fits).to(torch.uint8), stable=True).indices
    inv = torch.argsort(order, stable=True)
    n_fit = fits.sum().to(torch.int32)
    levels_s = levels_f[order].contiguous()
    batch_s = batch_f[order].contiguous()
    rd_s = rd[order]
    pos_s = [q[order] for q in pos]
    pdims = pdims_lut[levels_s.long()]
    zero = torch.zeros((), dtype=torch.int32, device=n_fit.device)

    pooled = roialign_slab(levels_s, batch_s,
                           *_slab_weights(pos_s, rd_s, pdims, slab), fms,
                           torch.stack([n_fit, n_flat - n_fit]).contiguous())
    out = conv3d_fc(pooled, fc_weight,
                    out_dtype=torch.float32).reshape(n_flat, -1)
    if fused:
        wk = conv1_weight_fk(fc_weight, fms[0].dtype)
        out_fc = roialign_fc(levels_s, batch_s,
                             *_slab_weights(pos_s, rd_s, pdims, fc_slab), fms,
                             wk, torch.stack([zero, n_fit]).contiguous())
        idx = torch.arange(n_flat, device=n_fit.device)
        out = torch.where((idx < n_fit)[:, None], out_fc, out)
    out = out[inv]
    return torch.where(torch.isfinite(out), out, out.new_zeros(()))
