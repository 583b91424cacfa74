"""Spatial-domain parallelism (port of m3d/parallel/spatial.py): one
volume's Y axis split over the ``space`` ranks of a ``(data, space)`` mesh.

JAX pins the trunk's input to Y shards and lets GSPMD insert the halo
exchanges the 7^3 / 3^3 convolutions need at shard boundaries. The port
writes them: before each convolution or pooling whose window spans Y, a
rank takes the edge rows of its neighbours (``halo``: one differentiable
all_gather of every rank's top and bottom slab, so autograd passes through
it; no send / recv, which the gloo twin of a shared card does not offer on
CUDA tensors). Each padding comes from the GLOBAL extent: the first and
last ranks pad as one process pads the whole volume (SAME, the stem's
explicit 3, the pool's -inf); interior edges take halo rows. A strided op
needs each shard to start on its stride, so the trunk runs sharded until
the first stage whose rows the ranks do not divide (or whose window
reaches past a neighbour), gathers there and runs the rest replicated
(``spatial_extract_features``' ``layout`` says which). The pyramid is
gathered once and the ROI stages run replicated on every rank through the
model's own stage functions, on the card through the port's kernels (JAX
takes its XLA gather there only because ``pallas_call`` does not
partition).

Autograd: every rank computes the same replicated loss L and back-
propagates L / (ranks); the gathers' backward sums over the ranks, so the
gradients summed over all ranks (``mesh.sync_grads``) are one process's.
Under TRAIN_BN, BatchNorm statistics of a Y-sharded tensor are summed over
``data`` x ``space``, of a replicated one over ``data`` only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from m3d_torch.models.backbone import max_pool_same
from m3d_torch.ops.conv3d import (pad_channels_last, same_padding,
                                  to_channels_last, to_ncdhw)
from m3d_torch.parallel.mesh import Mesh, make_mesh_nd

DATA_AXIS = "data"
SPACE_AXIS = "space"


def make_mesh_2d(n_data: int | None = None, n_space: int = 1,
                 devices=None) -> Mesh:
    """``(data, space)`` mesh; ``n_data`` defaults to ranks (``devices``,
    one a rank, else the process group's) / n_space. Rank r sits at
    (r // n_space, r % n_space): the space ranks of a data row are
    consecutive."""
    import torch.distributed as dist

    n_space = max(1, int(n_space))
    if n_data is None:
        world = len(devices) if devices is not None else (
            dist.get_world_size() if dist.is_initialized() else 1)
        n_data = max(1, world // n_space)
    return make_mesh_nd((DATA_AXIS, SPACE_AXIS), (int(n_data), n_space))


def image_sharding(mesh: Mesh, image):
    """This rank's block of a [B, H, W, D, C] batch: its data row's images
    (``B`` a multiple of the data axis, else all of them) and its Y rows."""
    d, s = mesh.axis(DATA_AXIS), mesh.axis(SPACE_AXIS)
    if d.size > 1 and image.shape[0] % d.size == 0:
        b = image.shape[0] // d.size
        image = image[d.index * b:(d.index + 1) * b]
    h = image.shape[1] // s.size
    return image[:, s.index * h:(s.index + 1) * h]


def halo(x, axis, lo: int, hi: int, fill: float = 0.0):
    """[B, h, ...] Y shard -> [B, lo + h + hi, ...]: ``lo`` rows of the
    previous rank above, ``hi`` rows of the next below; ``fill`` beyond
    the volume's edges. lo, hi <= h.

    Every rank builds the same graph (the edge ranks select their fill with
    ``where``, not with other operations): the gathers' backward collectives
    then run in the same order on every rank."""
    if lo == 0 and hi == 0:
        return x
    if axis.size == 1:
        return torch.cat([_rows(x, lo, fill), x, _rows(x, hi, fill)], 1)
    h, r, n = x.shape[1], axis.index, axis.size
    slab = torch.cat([x[:, h - lo:], x[:, :hi]], 1)   # [B, lo + hi, ...]
    every = axis.all_gather(slab[None], 0)           # [n, B, lo + hi, ...]
    fill_t = x.new_full((), fill)
    parts = []
    if lo:
        above = every[(r - 1) % n][:, :lo]
        parts.append(torch.where(torch.tensor(r == 0, device=x.device),
                                 fill_t, above))
    parts.append(x)
    if hi:
        below = every[(r + 1) % n][:, lo:]
        parts.append(torch.where(torch.tensor(r == n - 1, device=x.device),
                                 fill_t, below))
    return torch.cat(parts, 1)


def _rows(x, n, fill):
    return x.new_full((x.shape[0], n) + tuple(x.shape[2:]), fill)


def _y_window(k: int, s: int, lo: int, hi: int, rows: int, n: int):
    """(halo above, halo below) for a Y window ``k`` stride ``s`` padded
    (lo, hi) globally, on shards of ``rows`` of ``n`` ranks; None where the
    shards cannot run it exactly (the output would not split evenly, a
    shard would not start on the stride, or a halo would reach past a
    neighbour)."""
    total = rows * n
    out = (total + lo + hi - k) // s + 1
    below = k - s - lo
    if (rows % s or out != total // s or lo > rows or below > rows
            or below > hi or rows // s < 1):
        return None
    return lo, max(0, below)


class _Trunk:
    """Walks the model's ResNet3D + FPN3D over Y shards, each tensor with a
    flag: Y-sharded over ``space`` or replicated."""

    def __init__(self, model, mesh: Mesh):
        self.model, self.mesh = model, mesh
        self.space = mesh.axis(SPACE_AXIS)
        self.layout: list = []

    def gather(self, x, sharded):
        return (self.space.all_gather(x, 1), False) if sharded else (x,
                                                                      False)

    def fits(self, rows, k, s, pads):
        """Whether a Y window (k, s, pads) runs on shards of ``rows``."""
        return _y_window(k, s, *pads, rows, self.space.size) is not None

    def conv(self, conv, x, sharded):
        """``ZConv`` with its padding from the global extent; on a shard the
        Y padding comes from halo rows (zeros beyond the volume)."""
        k, s, dil = conv.kernel_size, conv.strides, conv.dilation
        rows = x.shape[1] * (self.space.size if sharded else 1)
        if isinstance(conv.padding, str):
            if conv.padding.upper() == "VALID":
                pads = [(0, 0)] * 3
            else:
                pads = same_padding(k, s, (rows,) + tuple(x.shape[2:4]), dil)
        else:
            pads = [tuple(p) for p in conv.padding]
        dtype = conv.dtype or x.dtype
        x = x.to(dtype)
        if sharded:
            assert dil[0] == 1, "a dilated Y window does not shard"
            lo, hi = _y_window(k[0], s[0], *pads[0], x.shape[1],
                               self.space.size)
            x = halo(x, self.space, lo, hi)
            pads = [(0, 0)] + pads[1:]
        x = pad_channels_last(x, pads)
        w = conv.weight.to(dtype).contiguous(
            memory_format=torch.channels_last_3d)
        b = None if conv.bias is None else conv.bias.to(dtype)
        y = F.conv3d(to_ncdhw(x), w, b, conv.strides, 0, dil)
        return to_channels_last(y)

    def bn(self, bnrelu, x, sharded):
        """BNRelu; under batch statistics, summed over data x space for a
        Y shard and over data for a replicated tensor."""
        bn = getattr(bnrelu, bnrelu.name_bn)
        group = bn.group
        if bn.batch_stats and sharded:
            bn.group = self.mesh.axis("all")
        try:
            x = bn(x)
        finally:
            bn.group = group
        return F.relu(x) if bnrelu.relu else x

    def pool(self, x, sharded, strides):
        if not sharded:
            return max_pool_same(x, (3, 3, 3), strides)
        rows = x.shape[1] * self.space.size
        pads = same_padding((3, 3, 3), strides, (rows,) + tuple(x.shape[2:4]),
                            (1, 1, 1))
        lo, hi = _y_window(3, strides[0], *pads[0], x.shape[1],
                           self.space.size)
        x = halo(x, self.space, lo, hi, float("-inf"))
        x = pad_channels_last(x, [(0, 0)] + pads[1:], value=float("-inf"))
        return to_channels_last(F.max_pool3d(to_ncdhw(x), (3, 3, 3),
                                             strides))

    def block(self, blk, x, sharded):
        c2a, c2b, c2c, c1 = (getattr(blk, n, None) for n in blk.names)
        s, rows = c2a.strides[0], x.shape[1]
        if sharded and not (self.fits(rows, 1, s, (0, 0))
                            and self.fits(rows // s, 3, 1, (1, 1))):
            x, sharded = self.gather(x, sharded)
        y = self.bn(blk.BNRelu_0, self.conv(c2a, x, sharded), sharded)
        y = self.bn(blk.BNRelu_1, self.conv(c2b, y, sharded), sharded)
        y = self.bn(blk.BNRelu_2, self.conv(c2c, y, sharded), sharded)
        sc = (self.bn(blk.BNRelu_3, self.conv(c1, x, sharded), sharded)
              if blk.conv_shortcut else x)
        return F.relu(y + sc), sharded

    def backbone(self, image):
        net = self.model.resnet
        x, sharded = image.to(net.dtype or image.dtype), self.space.size > 1
        c = net.conv1
        if sharded and not self.fits(x.shape[1], c.kernel_size[0],
                                     c.strides[0], tuple(c.padding[0])):
            x, sharded = self.gather(x, sharded)
        x = self.bn(net.BNRelu_0, self.conv(c, x, sharded), sharded)
        pool_s = net.pool_s
        if sharded and not self.fits(x.shape[1], 3, pool_s[0], same_padding(
                (3,), pool_s[:1], (x.shape[1] * self.space.size,), (1,))[0]):
            x, sharded = self.gather(x, sharded)
        x = self.pool(x, sharded, pool_s)
        self.layout.append(("C1", sharded))
        outs = []
        start = 0
        for i, end in enumerate(net.stage_ends):
            for j in range(start, end):
                x, sharded = self.block(getattr(net, f"Bottleneck_{j}"), x,
                                        sharded)
            outs.append((x, sharded))
            self.layout.append((f"C{i + 2}", sharded))
            start = end
        return outs

    def upsample_add(self, top, ref, factors, lateral):
        """``upsample_to(top, factors, ref) + lateral`` with either side
        sharded or not; a replicated top feeding a sharded lateral is
        cropped to the global extent, then to this rank's rows."""
        (t, t_sh), (r, r_sh), (lat, _) = top, ref, lateral
        for axis, f in zip((1, 2, 3), factors):
            if f > 1:
                t = t.repeat_interleave(f, dim=axis)
        if r_sh and not t_sh:
            h = r.shape[1]
            t = t[:, self.space.index * h:(self.space.index + 1) * h]
        t = t[:, :r.shape[1], :r.shape[2], :r.shape[3], :]
        return t + lat, r_sh

    def fpn(self, cs):
        fpn = self.model.fpn
        (c2, c3, c4, c5) = cs
        f54, f43, f32 = fpn.upsample_factors
        p5 = (self.conv(fpn.fpn_c5p5, *c5), c5[1])
        p4 = self.upsample_add(p5, c4, f54,
                               (self.conv(fpn.fpn_c4p4, *c4), c4[1]))
        p3 = self.upsample_add(p4, c3, f43,
                               (self.conv(fpn.fpn_c3p3, *c3), c3[1]))
        p2 = self.upsample_add(p3, c2, f32,
                               (self.conv(fpn.fpn_c2p2, *c2), c2[1]))
        out = []
        for name, (p, sh) in (("fpn_p2", p2), ("fpn_p3", p3),
                              ("fpn_p4", p4), ("fpn_p5", p5)):
            if sh and not self.fits(p.shape[1], 3, 1, (1, 1)):
                p, sh = self.gather(p, sh)
            out.append((self.conv(getattr(fpn, name), p, sh), sh))
        p5, sh5 = out[-1]
        sy, sx, sz = fpn.p6_stride
        if sh5 and p5.shape[1] % sy:
            p5, sh5 = self.gather(p5, sh5)
        out.append((p5[:, ::sy, ::sx, ::sz, :], sh5))
        for i, (_, sh) in enumerate(out):
            self.layout.append((f"P{i + 2}", sh))
        return out


def spatial_extract_features(model, image, mesh: Mesh, gather: bool = True,
                             layout: dict | None = None):
    """Backbone + FPN with the volume's Y axis sharded over ``space``.

    ``image``: [B, H, W, D, C], this data row's volumes at full height
    (``image_sharding`` cuts this rank's rows). Every convolution and the
    pool run on Y shards with halo rows until the first stage the shards
    cannot run exactly, then replicated. With ``gather`` the P2..P6 pyramid
    comes back whole on every space rank (one all_gather per sharded
    level); ``gather=False`` keeps each sharded level as this rank's rows.
    ``layout``, a dict, receives which levels ran sharded ({"C1": True,
    ..., "P6": False}). Returns (P2, P3, P4, P5, P6), as
    ``MaskRCNN.extract_features``."""
    space = mesh.axis(SPACE_AXIS)
    h = image.shape[1]
    if h % space.size:
        raise ValueError(f"{h} rows do not split over {space.size} space "
                         f"ranks")
    x = image.float()[:, space.index * (h // space.size):
                      (space.index + 1) * (h // space.size)]
    trunk = _Trunk(model, mesh)
    cs = trunk.backbone(x)
    feats = trunk.fpn(cs)
    if layout is not None:
        layout.update(trunk.layout)
    if gather:
        return tuple(trunk.gather(p, sh)[0] for p, sh in feats)
    return tuple(p for p, _ in feats)


def make_spatial_inference(model, mesh: Mesh, static_meta=None,
                           static_anchors=None):
    """Full Mask R-CNN inference with a Y-sharded trunk. Returns ``fn(image,
    image_meta, anchors)`` (or ``fn(image)`` when both statics are given):
    the trunk runs over ``space``, the pyramid is gathered once, and the
    proposal, classifier (the fused ROIAlign + FC kernel on the card, the
    slab kernel for its fallback rows), detection and mask (the padded
    ROIAlign kernel) stages run replicated, through
    ``MaskRCNN.forward_from_features`` (``forward`` after its trunk).
    ``image`` is this data row's batch at full height; the outputs are
    that batch's."""

    @torch.no_grad()
    def forward(image, image_meta, anchors):
        return model.forward_from_features(
            spatial_extract_features(model, image, mesh), image_meta, anchors)

    if static_meta is not None and static_anchors is not None:
        return lambda image: forward(image, static_meta, static_anchors)
    return forward


