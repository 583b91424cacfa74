"""The compact ROIAlign wrapper (m3d_torch/ops/roialign_compact.py): its
input checks and CPU path here, and its CUDA kernel against the plain
PyTorch version on the card (marker ``cuda``; skips without a card). Imports
no JAX, so the card's machine can run it:
``python -m pytest -m cuda tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from m3d_torch.ops import roialign3d as TR
from m3d_torch.ops import roialign_compact as TC

T = torch.from_numpy


def _pyramid(rng, b, c, depth=8):
    return [rng.randn(b, 16, 16, depth, c).astype(np.float32),
            rng.randn(b, 8, 8, depth, c).astype(np.float32),
            rng.randn(b, 4, 4, max(depth // 2, 1), c).astype(np.float32),
            rng.randn(b, 2, 2, max(depth // 4, 1), c).astype(np.float32)]


def _kernel_args(rng, n=12, total=7, c=8, dtype=torch.float32):
    feats = [T(f).to(dtype) for f in _pyramid(rng, 2, c)]
    levels = T((np.arange(n) % 4).astype(np.int32))
    bat = T(np.sort(rng.randint(0, 2, n)).astype(np.int32))
    pos = torch.stack([TR.axis_positions(
        T(lo), T(lo + 0.3), torch.tensor([f.shape[1 + a] for f in feats])[
            levels.long()], 14) for a, lo in enumerate(
                rng.uniform(0, 0.6, (3, n)).astype(np.float32))], 1)
    return [levels, bat, torch.tensor(total, dtype=torch.int32),
            pos.contiguous(), feats]


def test_wrapper_uses_plain_version_on_cpu():
    rng = np.random.RandomState(8)
    args = _kernel_args(rng)
    before = TC.KERNEL.launches
    got = TC.roialign_compact(*args)
    np.testing.assert_array_equal(got.numpy(),
                                  TC.roialign_compact_plain(*args).numpy())
    assert TC.KERNEL.launches == before      # no kernel on the CPU
    assert (got[7:] == 0).all() and got[:7].abs().sum() > 0
    bf = TC.roialign_compact(*args[:4],
                             [f.to(torch.bfloat16) for f in args[4]])
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("bad", ["levels_dtype", "pos_shape", "feat_dtype",
                                 "noncontig", "odd_channels", "three_levels",
                                 "total_shape"])
def test_wrapper_rejects_bad_inputs(bad):
    rng = np.random.RandomState(9)
    args = _kernel_args(rng)
    levels, bat, total, pos, feats = args
    if bad == "levels_dtype":
        args[0] = levels.long()
    elif bad == "pos_shape":
        args[3] = pos[:, :2].contiguous()
    elif bad == "feat_dtype":
        args[4] = [f.double() for f in feats]
    elif bad == "noncontig":
        args[4] = [feats[0].transpose(1, 2)] + feats[1:]
    elif bad == "odd_channels":
        args[4] = [f[..., :7].contiguous() for f in feats]
    elif bad == "three_levels":
        args[4] = feats[:3]
    elif bad == "total_shape":
        args[2] = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        TC.roialign_compact(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("total", [0, 1, 7, 12])
def test_kernel_matches_plain_on_card(total):
    """The CUDA kernel against its plain version on the card (bf16 inputs,
    float32 reference; tolerance one bf16 rounding of the output)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    rng = np.random.RandomState(10)
    args = _kernel_args(rng, total=total, c=256, dtype=torch.bfloat16)
    args = [a.cuda() if torch.is_tensor(a) else [f.cuda() for f in a]
            for a in args]
    got = TC.roialign_compact(*args).float()
    ref = TC.roialign_compact_plain(*args[:4], [f.float() for f in args[4]])
    assert (got[total:] == 0).all()
    assert (got - ref).abs().max() <= 1e-2 * ref.abs().max()
