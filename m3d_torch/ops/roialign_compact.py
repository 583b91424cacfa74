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
``total`` exactly zero. On a CPU tensor it runs ``roialign_compact_plain``;
on a CUDA tensor it launches the kernel or raises. The library is built
with nvcc into m3d_torch/_build/ on first use (plain C ABI, loaded with
ctypes) and rebuilt when the source changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

SOURCE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                      "roialign_compact.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_ROWS = 65535  # grid.y limit


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


class _Kernel:
    """The built library and the wrapper's launch count."""

    def __init__(self):
        self.lib = None
        self.launches = 0
        self.build_seconds = None
        self.build_log = ""


KERNEL = _Kernel()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def build_library() -> str:
    """Compile csrc/roialign_compact.cu with nvcc unless a library built
    from the same source and flags exists. Returns the library path."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"roialign_compact_{tag}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    KERNEL.build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{KERNEL.build_log}")
    os.replace(tmp, path)
    KERNEL.build_seconds = time.perf_counter() - t0
    return path


def load_library():
    """Build (if needed) and load the kernel library; idempotent."""
    if KERNEL.lib is None:
        lib = ctypes.CDLL(build_library())
        fn = lib.roialign_compact_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        KERNEL.lib = lib
    return KERNEL.lib


def _check(levels, batch_idx, total, pos, feature_maps):
    dev = pos.device
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
        if t.device != dev or t.dtype != torch.int32 or t.shape != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 [N] on {dev}")
    if total.device != dev or total.dtype != torch.int32 or total.numel() != 1:
        raise ValueError(f"total must be one int32 on {dev}")
    if n > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows per launch, got {n}")


def roialign_compact(levels, batch_idx, total, pos, feature_maps):
    """Compact ROIAlign; see the module docstring for the contract."""
    _check(levels, batch_idx, total, pos, feature_maps)
    if pos.device.type == "cpu":
        return roialign_compact_plain(levels, batch_idx, total, pos,
                                      feature_maps)
    if pos.device.type != "cuda":
        raise RuntimeError(f"no compact ROIAlign kernel for {pos.device}")
    n, _, p = pos.shape
    f0 = feature_maps[0]
    c = f0.shape[-1]
    out = torch.empty((n, p, p, p, c), dtype=f0.dtype, device=pos.device)
    if n == 0:
        return out
    lib = load_library()
    dims = [int(v) for fm in feature_maps for v in fm.shape[1:4]]
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        err = lib.roialign_compact_launch(
            *(fm.data_ptr() for fm in feature_maps), *dims,
            levels.data_ptr(), batch_idx.data_ptr(), total.data_ptr(),
            pos.data_ptr(), out.data_ptr(), n, p, c, stream)
    if err != 0:
        raise RuntimeError(f"roialign_compact launch failed: CUDA error {err}")
    KERNEL.launches += 1
    return out
