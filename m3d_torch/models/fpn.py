"""3D Feature Pyramid Network (port of m3d/models/fpn.py).

P5 from C5 via a 1^3 conv, a top-down pathway of nearest-neighbour
upsampling (a repeat, then a crop to the lateral's extent) plus 1^3 lateral
convs, 3^3 smoothing convs, and P6 = strided subsample of P5.
"""

from __future__ import annotations

from torch import nn

from m3d_torch.ops.conv3d import ZConv


def upsample_to(x, factors, ref):
    """Nearest upsample of [B, H, W, D, C] by integer factors, cropped to
    ``ref``'s spatial extent (ceil-division level shapes can overshoot)."""
    for axis, f in zip((1, 2, 3), factors):
        if f > 1:
            x = x.repeat_interleave(f, dim=axis)
    return x[:, :ref.shape[1], :ref.shape[2], :ref.shape[3], :]


class FPN3D(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048), channels=256,
                 p6_stride=(2, 2, 1), dtype=None,
                 upsample_factors=((2, 2, 1), (2, 2, 1), (2, 2, 1))):
        super().__init__()
        self.p6_stride = tuple(p6_stride)
        self.upsample_factors = tuple(tuple(f) for f in upsample_factors)
        c2, c3, c4, c5 = in_channels
        for name, cin in (("fpn_c5p5", c5), ("fpn_c4p4", c4),
                          ("fpn_c3p3", c3), ("fpn_c2p2", c2)):
            self.add_module(name, ZConv(cin, channels, (1, 1, 1),
                                        dtype=dtype))
        for name in ("fpn_p2", "fpn_p3", "fpn_p4", "fpn_p5"):
            self.add_module(name, ZConv(channels, channels, (3, 3, 3),
                                        dtype=dtype))

    def forward(self, c2, c3, c4, c5):
        f54, f43, f32 = self.upsample_factors
        p5 = self.fpn_c5p5(c5)
        p4 = upsample_to(p5, f54, c4) + self.fpn_c4p4(c4)
        p3 = upsample_to(p4, f43, c3) + self.fpn_c3p3(c3)
        p2 = upsample_to(p3, f32, c2) + self.fpn_c2p2(c2)
        p2 = self.fpn_p2(p2)
        p3 = self.fpn_p3(p3)
        p4 = self.fpn_p4(p4)
        p5 = self.fpn_p5(p5)
        sy, sx, sz = self.p6_stride
        p6 = p5[:, ::sy, ::sx, ::sz, :]
        return p2, p3, p4, p5, p6
