"""The ROIAlign kernel wrappers (m3d_torch/ops/roialign_compact.py,
roialign_slab.py, roialign_fc.py): their input checks, their CPU path and
the fused kernel's prepared-weight cache here, and each CUDA kernel against
its plain PyTorch version on the card, at small shapes and at the main
path's shapes, plus the blockwise NMS at the hela configs' 30000 candidates
against the numpy oracle (marker ``cuda``; skips without a card). Imports no
JAX, so the card's machine can run it:
``python -m pytest -m cuda tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from m3d_torch.data.synthetic import proposal_like_boxes
from m3d_torch.ops import nms3d as TN
from m3d_torch.ops import roialign3d as TR
from m3d_torch.ops import roialign_compact as TC
from m3d_torch.ops import roialign_fc as TF
from m3d_torch.ops import roialign_slab as TS

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


def _slab_args(rng, n=12, c=8, dtype=torch.float32, random_weights=False,
               slab=(16, 16, 16)):
    """Slab-contract inputs: random boxes routed over all four levels,
    origins and weights as the fused classifier computes them (or random
    sparse weights)."""
    feats = [T(f).to(dtype) for f in _pyramid(rng, 2, c, depth=16)]
    levels = T((np.arange(n) % 4).astype(np.int32))
    bat = T(np.sort(rng.randint(0, 2, n)).astype(np.int32))
    lo = rng.uniform(0, 0.6, (n, 3)).astype(np.float32)
    boxes = T(np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (n, 3))], 1)
              .astype(np.float32))
    (sy, sx, sz), pdims = TR._slab_geometry(feats, slab)
    rd, pos = TR._level_positions(boxes, levels, feats, 7)
    origins, wy, wx, wz = TR._slab_weights(pos, rd, pdims[levels.long()],
                                           (sy, sx, sz))
    if random_weights:
        wy, wx, wz = (T(rng.randn(*w.shape).astype(np.float32)
                        * (rng.uniform(size=w.shape) < 0.3))
                      for w in (wy, wx, wz))
    return [levels, bat, origins, wy, wx, wz, feats]


def _to_card(args):
    return [a.cuda() if torch.is_tensor(a) else [f.cuda() for f in a]
            for a in args]


def test_padded_wrapper_uses_plain_version_on_cpu():
    rng = np.random.RandomState(11)
    levels, _, _, pos, feats = _kernel_args(rng, n=12)
    before = TC.PADDED.launches, TC.KERNEL.launches
    got = TC.roialign_padded(levels, pos, feats, 6)
    bat = torch.arange(12, dtype=torch.int32) // 6
    ref = TC.roialign_compact_plain(levels, bat, torch.tensor(12), pos, feats)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert (TC.PADDED.launches, TC.KERNEL.launches) == before
    with pytest.raises(ValueError):
        TC.roialign_padded(levels, pos, feats, 5)


def test_slab_and_fc_wrappers_use_plain_versions_on_cpu():
    rng = np.random.RandomState(12)
    args = _slab_args(rng)
    bounds = torch.tensor([2, 7], dtype=torch.int32)
    w = T(rng.randn(8, 8 * 7 ** 3).astype(np.float32))
    before = TS.KERNEL.launches, TF.KERNEL.launches
    got = TS.roialign_slab(*args, bounds)
    np.testing.assert_array_equal(
        got.numpy(), TS.roialign_slab_plain(*args, bounds).numpy())
    fc = TF.roialign_fc(*args, w, bounds)
    np.testing.assert_allclose(
        fc.numpy(), (got.reshape(12, -1) @ w.t()).numpy(), rtol=1e-5,
        atol=1e-5)
    assert (TS.KERNEL.launches, TF.KERNEL.launches) == before
    assert (got[:2] == 0).all() and (got[9:] == 0).all()
    assert got[2:9].abs().sum() > 0


@pytest.mark.parametrize("bad", ["levels_dtype", "bounds_shape", "w_dtype",
                                 "w_shape", "three_levels", "origins_shape",
                                 "wk_shape"])
def test_slab_and_fc_wrappers_reject_bad_inputs(bad):
    rng = np.random.RandomState(13)
    args = _slab_args(rng)
    bounds = torch.tensor([0, 12], dtype=torch.int32)
    wk = torch.zeros(8, 8 * 7 ** 3)
    if bad == "levels_dtype":
        args[0] = args[0].long()
    elif bad == "bounds_shape":
        bounds = bounds[:1]
    elif bad == "w_dtype":
        args[3] = args[3].double()
    elif bad == "w_shape":
        args[4] = args[4][:5].contiguous()
    elif bad == "three_levels":
        args[6] = args[6][:3]
    elif bad == "origins_shape":
        args[2] = args[2][:, :2].contiguous()
    if bad != "wk_shape":
        with pytest.raises((TypeError, ValueError)):
            TS.roialign_slab(*args, bounds)
    else:
        wk = wk[:, :-8].contiguous()
    with pytest.raises((TypeError, ValueError)):
        TF.roialign_fc(*args, wk, bounds)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")


@pytest.mark.cuda
def test_padded_kernel_matches_plain_on_card():
    """The compact kernel through the padded entry (TPU kernel
    _kernel_vmem): every row live. Tolerance one bf16 rounding."""
    _needs_card()
    rng = np.random.RandomState(14)
    levels, _, _, pos, feats = _to_card(
        _kernel_args(rng, c=256, dtype=torch.bfloat16))
    before = TC.PADDED.launches
    got = TC.roialign_padded(levels, pos, feats, 6).float()
    assert TC.PADDED.launches == before + 1
    bat = torch.arange(12, dtype=torch.int32, device="cuda") // 6
    ref = TC.roialign_compact_plain(levels, bat, torch.tensor(12).cuda(), pos,
                                    [f.float() for f in feats])
    assert (got - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("bounds", [(0, 0), (0, 1), (0, 12), (5, 4),
                                    ("random", 12)])
def test_slab_kernel_matches_plain_on_card(bounds):
    """The slab kernel against its plain version (bf16 inputs, float32
    reference; one bf16 rounding), rows outside bounds exactly zero."""
    _needs_card()
    rng = np.random.RandomState(15)
    rand = bounds[0] == "random"
    bounds = (0, 12) if rand else bounds
    args = _to_card(_slab_args(rng, c=256, dtype=torch.bfloat16,
                               random_weights=rand))
    tb = torch.tensor(bounds, dtype=torch.int32, device="cuda")
    got = TS.roialign_slab(*args, tb).float()
    ref = TS.roialign_slab_plain(*args[:6], [f.float() for f in args[6]], tb)
    lo, hi = bounds[0], bounds[0] + bounds[1]
    assert (got[:lo] == 0).all() and (got[hi:] == 0).all()
    assert (got - ref).abs().max() <= 1e-2 * max(ref.abs().max(), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("bounds", [(0, 0), (0, 1), (0, 70), (9, 60),
                                    ("random", 70)])
def test_fc_kernel_matches_plain_on_card(bounds):
    """The fused ROIAlign + FC kernel against its plain version: 70 rows
    (two row tiles, the second ragged), F = 40 (one ragged column tile),
    C = 256. Tolerance 1e-2 of the largest output: the pooled rows are
    rounded to bf16 on both sides, the sums run in another order."""
    _needs_card()
    rng = np.random.RandomState(16)
    rand = bounds[0] == "random"
    bounds = (0, 70) if rand else bounds
    args = _to_card(_slab_args(rng, n=70, c=256, dtype=torch.bfloat16,
                               random_weights=rand))
    w = torch.from_numpy(rng.randn(40, 256, 7, 7, 7).astype(np.float32)
                         * 0.01).cuda()
    wk = TF.conv1_weight_fk(w, torch.bfloat16)
    tb = torch.tensor(bounds, dtype=torch.int32, device="cuda")
    got = TF.roialign_fc(*args, wk, tb)
    ref = TF.roialign_fc_plain(*args, wk, tb)
    lo, hi = bounds[0], bounds[0] + bounds[1]
    assert (got[:lo] == 0).all() and (got[hi:] == 0).all()
    assert (got - ref).abs().max() <= 1e-2 * max(ref.abs().max(), 1e-30)


def _zero_row_calls(on_gpu: bool):
    """Each wrapper called with zero rows: (name, counter, call)."""
    rng = np.random.RandomState(17)
    dtype = torch.bfloat16 if on_gpu else torch.float32
    levels, bat, _, pos, feats = _kernel_args(rng, c=64, dtype=dtype)
    slab = _slab_args(rng, c=64, dtype=dtype)
    if on_gpu:
        levels, bat, pos, feats = _to_card([levels, bat, pos, feats])
        slab = _to_card(slab)
    dev = pos.device
    empty = [t[:0].contiguous() for t in (levels, bat, pos)]
    slab0 = [t[:0].contiguous() for t in slab[:6]] + [slab[6]]
    bounds = torch.zeros(2, dtype=torch.int32, device=dev)
    wk = torch.zeros(8, 64 * 7 ** 3, dtype=dtype, device=dev)
    total = torch.zeros((), dtype=torch.int32, device=dev)
    return {
        "compact": (TC.KERNEL, lambda: TC.roialign_compact(
            empty[0], empty[1], total, empty[2], feats)),
        "padded": (TC.PADDED, lambda: TC.roialign_padded(
            empty[0], empty[2], feats, 6)),
        "slab": (TS.KERNEL, lambda: TS.roialign_slab(*slab0, bounds)),
        "fc": (TF.KERNEL, lambda: TF.roialign_fc(*slab0, wk, bounds)),
    }


@pytest.mark.parametrize("name", ["compact", "padded", "slab", "fc"])
def test_zero_rows_launch_nothing_and_count_nothing(name, monkeypatch):
    """Each op's CUDA implementation (the kernel's route, called here on
    CPU tensors: the dispatcher sends a CPU tensor to the plain version)
    with zero rows returns an empty result, calls no library entry and
    leaves its launch count as it was."""
    def no_call(*args):
        raise AssertionError("a zero-row call reached the library")

    for mod in (TC, TS, TF):
        monkeypatch.setattr(mod.LIB, "call", no_call)
    rng = np.random.RandomState(17)
    levels, bat, _, pos, feats = _kernel_args(rng, c=64)
    slab = _slab_args(rng, c=64)
    empty = [t[:0].contiguous() for t in (levels, bat, pos)]
    slab0 = [t[:0].contiguous() for t in slab[:6]] + [slab[6]]
    bounds = torch.zeros(2, dtype=torch.int32)
    wk = torch.zeros(8, 64 * 7 ** 3)
    total = torch.zeros((), dtype=torch.int32)
    count, call = {
        "compact": (TC.KERNEL, lambda: TC._compact_launch(
            empty[0], empty[1], total, empty[2], feats)),
        "padded": (TC.PADDED, lambda: TC._padded_launch(
            empty[0], empty[2], feats, 6)),
        "slab": (TS.KERNEL, lambda: TS._slab_launch(*slab0, bounds)),
        "fc": (TF.KERNEL, lambda: TF._fc_launch(*slab0, wk, bounds)),
    }[name]
    before = count.launches
    out = call()
    assert out.shape[0] == 0
    assert count.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["compact", "padded", "slab", "fc"])
def test_zero_rows_count_nothing_on_card(name):
    """On the card, a zero-row call leaves the launch count unchanged."""
    _needs_card()
    count, call = _zero_row_calls(on_gpu=True)[name]
    before = count.launches
    assert call().shape[0] == 0
    assert count.launches == before


@pytest.mark.cuda
def test_fused_route_raises_on_card_for_features_it_cannot_take():
    """The fused kernel itself raises on the card for features it cannot
    take (C % 64 != 0) instead of moving to another route; the classifier
    stage never hands it such features (``fc_kernel_takes``)."""
    _needs_card()
    rng = np.random.RandomState(18)
    args = _to_card(_slab_args(rng, c=96, dtype=torch.bfloat16))
    assert TR.fused_classifier_ok(7, args[6])
    wk = torch.zeros(8, 96 * 7 ** 3, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):
        TF.roialign_fc(*args, wk,
                       torch.tensor([0, 12], dtype=torch.int32,
                                    device="cuda"))


@pytest.mark.cuda
def test_nms_blockwise_on_card_matches_oracle_at_hela_size():
    """nms_3d at N = 30000 (the hela configs' PRE_NMS_LIMIT, threshold 0.7,
    3000 outputs), B = 1, on the card: the blockwise branch, its kept set
    equal to the numpy oracle's."""
    _needs_card()
    rng = np.random.RandomState(40)
    boxes = proposal_like_boxes(rng, 30000)
    scores = rng.uniform(size=30000).astype(np.float32)
    idx, ok = TN.nms_3d(T(boxes[None]).cuda(), T(scores[None]).cuda(), 0.7,
                        3000)
    want = TN.nms_3d_numpy(boxes, scores, 0.7, 3000)
    np.testing.assert_array_equal(idx[0][ok[0]].cpu().numpy(), want)


def test_prepared_conv1_weight_is_cached_and_rebuilt_after_update():
    """conv1_weight_fk keeps its [F, K] result on the parameter: the same
    tensor while the parameter is unchanged, a new one after an in-place
    update (its version counter moves), and always the fresh layout."""
    rng = np.random.RandomState(19)
    w = torch.nn.Parameter(T(rng.randn(6, 8, 3, 3, 3).astype(np.float32)))

    def fresh():
        return w.detach().permute(0, 2, 3, 4, 1).reshape(6, -1).to(
            torch.bfloat16)

    a = TF.conv1_weight_fk(w, torch.bfloat16)
    assert a.shape == (6, 8 * 27) and a.is_contiguous()
    assert torch.equal(a, fresh())
    assert TF.conv1_weight_fk(w, torch.bfloat16) is a
    assert TF.conv1_weight_fk(w, torch.float32).dtype == torch.float32
    with torch.no_grad():
        w.mul_(2.0)
    b = TF.conv1_weight_fk(w, torch.bfloat16)
    assert b is not a and torch.equal(b, fresh())
    assert not torch.equal(a, b)
    w.data = w.data.clone()  # new storage, same values
    assert TF.conv1_weight_fk(w, torch.bfloat16) is not b


def _bench_pyramid(rng, c=256):
    """bf16 levels at the bench config's shapes (128^3, strides 4-32, B=4)
    on the card."""
    return [torch.from_numpy(rng.randn(4, s, s, s, c).astype(np.float32))
            .to(torch.bfloat16).cuda() for s in (32, 16, 8, 4)]


def _bench_fc_args(rng, feats, n, bounds, general=False):
    """Fused-kernel inputs at the bench shapes: n rows over all four levels,
    weights for the (16, 16, 24) slab as the fused classifier places them
    (or, with ``general``, random sparse weights with more than two taps
    per position), F = 512 outputs, C = 256."""
    levels = T((np.arange(n) % 4).astype(np.int32))
    bat = T(np.sort(rng.randint(0, 4, n)).astype(np.int32))
    lo = rng.uniform(0, 0.6, (n, 3)).astype(np.float32)
    boxes = T(np.concatenate([lo, lo + rng.uniform(0.05, 0.35, (n, 3))], 1)
              .astype(np.float32))
    cpu = [f[:1].cpu() for f in feats]  # geometry only needs the shapes
    slab, pdims = TR._slab_geometry(cpu)
    tier = tuple(min(a, b) for a, b in zip((16, 16, 24), slab))
    rd, pos = TR._level_positions(boxes, levels, cpu, 7)
    origins, wy, wx, wz = TR._slab_weights(pos, rd, pdims[levels.long()],
                                           tier)
    if general:
        wy, wx, wz = (T((rng.randn(*w.shape) * (rng.uniform(size=w.shape)
                                                < 0.3)).astype(np.float32))
                      for w in (wy, wx, wz))
    w = torch.from_numpy(rng.randn(512, 256, 7, 7, 7).astype(np.float32)
                         * 0.01)
    args = _to_card([levels, bat, origins, wy, wx, wz])
    return args + [feats, TF.conv1_weight_fk(w, torch.bfloat16).cuda(),
                   torch.tensor(bounds, dtype=torch.int32, device="cuda")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,bounds,general", [
    (2000, (0, 1957), False),   # A: the monolithic classifier
    (2000, (0, 70), False),     # B: the forced split's fused rows
    (125, (0, 125), False),     # C: one adaptive classifier chunk
    (2000, (0, 0), False), (2000, (0, 1), False), (2000, (0, 2000), False),
    (2000, (700, 600), False), (300, (10, 250), True)])
def test_fc_kernel_at_bench_shapes_on_card(n, bounds, general):
    """The redesigned fused kernel at the main path's shapes (F = 512,
    C = 256, p = 7) against its plain version: tolerance 1e-2 of the
    largest output (pooled rows rounded to bf16 on both sides, sums in
    another order), rows outside bounds exactly zero, and the same bits
    on a second call (the K split is summed in a fixed order)."""
    _needs_card()
    rng = np.random.RandomState(20 + n + bounds[1])
    feats = _bench_pyramid(rng)
    args = _bench_fc_args(rng, feats, n, bounds, general)
    before = TF.KERNEL.launches
    got = TF.roialign_fc(*args)
    assert TF.KERNEL.launches == before + 1
    ref = TF.roialign_fc_plain(*args)
    lo, hi = bounds[0], bounds[0] + bounds[1]
    assert (got[:lo] == 0).all() and (got[hi:] == 0).all()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-2 * max(ref.abs().max(), 1e-30)
    assert torch.equal(TF.roialign_fc(*args), got)


def _rats_pyramid(rng, c=256):
    """bf16 levels at the rats config's shapes (256 x 256 x 12, strides
    (4, 4, 1) to (32, 32, 1), B=4) on the card."""
    return [torch.from_numpy(rng.randn(4, s, s, 12, c).astype(np.float32))
            .to(torch.bfloat16).cuda() for s in (64, 32, 16, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,n,p,total", [
    ("mask", 200, 14, 0), ("mask", 200, 14, 1), ("mask", 200, 14, 37),
    ("mask", 200, 14, 200),
    ("classifier", 2000, 7, 2000),    # the adaptive classifier's rows
    ("rats_wide", 1000, 7, 1000)])    # P2 boxes wider than 32 cells
def test_compact_kernel_at_bench_shape_on_card(case, n, p, total):
    """The redesigned compact kernel at the adaptive stages' shapes against
    its plain version: the mask stage's (200 rows, p = 14, C = 256, also
    through the padded entry), the classifier's (2000 rows, p = 7, every
    row live), and rats' anisotropic 64 x 64 x 12 P2 pyramid with boxes
    spanning 35-45 cells in y and x, the rows a 32-cell slab clamps. One
    bf16 rounding of the largest output, rows >= total exactly zero."""
    _needs_card()
    rng = np.random.RandomState(30 + total)
    feats = _rats_pyramid(rng) if case == "rats_wide" else _bench_pyramid(rng)
    levels = torch.from_numpy((np.arange(n) % 4).astype(np.int32)).cuda()
    bat = torch.from_numpy(np.sort(rng.randint(0, 4, n)).astype(np.int32)) \
        .cuda()
    if case == "rats_wide":
        lo = rng.uniform(0.0, 0.3, (3, n)).astype(np.float32)
        hi = lo + rng.uniform(0.55, 0.7, (3, n)).astype(np.float32)
    else:
        lo = rng.uniform(-0.1, 0.7, (3, n)).astype(np.float32)
        hi = lo + 0.35
    pos = torch.stack([TR.axis_positions(T(lo[a]), T(hi[a]), torch.tensor(
        [f.shape[1 + a] for f in feats])[levels.long().cpu()], p)
        for a in range(3)], 1).contiguous().cuda()
    if case == "rats_wide":
        p2 = levels == 0
        assert ((pos[:, :2, -1] - pos[:, :2, 0])[p2] > 32).all()
    tt = torch.tensor(total, dtype=torch.int32, device="cuda")
    got = TC.roialign_compact(levels, bat, tt, pos, feats).float()
    assert got.shape == (n, p, p, p, 256)
    ref = TC.roialign_compact_plain(levels, bat, tt, pos,
                                    [f.float() for f in feats])
    assert (got[total:] == 0).all() and torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-2 * max(ref.abs().max(), 1e-30)
    if case == "mask" and total == n:
        pad = TC.roialign_padded(levels, pos, feats, 50).float()
        bat_p = torch.arange(n, dtype=torch.int32, device="cuda") // 50
        ref_p = TC.roialign_compact_plain(levels, bat_p, tt, pos,
                                          [f.float() for f in feats])
        assert (pad - ref_p).abs().max() <= 1e-2 * ref_p.abs().max()


def _dense_random(rng, w, rows):
    """w with the given rows replaced by random weights, ~30 % of each row's
    columns nonzero: far more than two taps a sample (the general path)."""
    w = w.clone()
    shape = (len(rows),) + tuple(w.shape[1:])
    w[rows] = T((rng.randn(*shape) * (rng.uniform(size=shape) < 0.3))
                .astype(np.float32))
    return w


def _bench_slab_args(rng, feats, n, bounds, tier, general=None):
    """Slab-kernel inputs at the bench shapes: n rows over all four levels,
    origins and weights for ``tier`` (capped at the exact-coverage slab) as
    axis_slab_weights places them; ``general`` "all" or "mixed" (every third
    row) replaces rows' weights by dense random ones."""
    levels = T((np.arange(n) % 4).astype(np.int32))
    bat = T(np.sort(rng.randint(0, 4, n)).astype(np.int32))
    lo = rng.uniform(0, 0.6, (n, 3)).astype(np.float32)
    boxes = T(np.concatenate([lo, lo + rng.uniform(0.05, 0.35, (n, 3))], 1)
              .astype(np.float32))
    cpu = [f[:1].cpu() for f in feats]  # geometry only needs the shapes
    slab, pdims = TR._slab_geometry(cpu)
    tier = tuple(min(a, b) for a, b in zip(tier, slab))
    rd, pos = TR._level_positions(boxes, levels, cpu, 7)
    origins, *ws = TR._slab_weights(pos, rd, pdims[levels.long()], tier)
    if general is not None:
        rows = np.arange(n) if general == "all" else np.arange(0, n, 3)
        ws = [_dense_random(rng, w, rows) for w in ws]
    return _to_card([levels, bat, origins, *ws]) + [
        feats, torch.tensor(bounds, dtype=torch.int32, device="cuda")]


@pytest.mark.cuda
@pytest.mark.parametrize("c,tier,bounds,general", [
    (256, (32, 32, 32), (0, 0), None), (256, (32, 32, 32), (0, 1), None),
    (256, (32, 32, 32), (0, 2000), None),
    (256, (32, 32, 32), (700, 600), None),
    (256, (32, 32, 32), (0, 2000), "all"),
    (256, (32, 32, 32), (100, 1800), "mixed"),
    (256, (8, 8, 16), (0, 2000), None), (256, (16, 16, 24), (0, 2000), None),
    (10, (32, 32, 32), (0, 2000), None), (10, (32, 32, 32), (300, 900),
                                          "mixed")])
def test_slab_kernel_at_bench_shapes_on_card(c, tier, bounds, general):
    """The redesigned slab kernel at the main path's shapes (2000 rows,
    p = 7, exact-coverage slab (32, 32, 32) and the two smaller tiers)
    against its plain version: fast rows (axis_slab_weights' two-tap form),
    general rows (dense random weights), both in one batch, and C = 10 (the
    two-channel path). Tolerance one bf16 rounding of the largest output;
    rows outside bounds exactly zero; one launch counted."""
    _needs_card()
    rng = np.random.RandomState(50 + c + bounds[1])
    feats = _bench_pyramid(rng, c)
    args = _bench_slab_args(rng, feats, 2000, bounds, tier, general)
    before = TS.KERNEL.launches
    got = TS.roialign_slab(*args).float()
    assert TS.KERNEL.launches == before + 1
    ref = TS.roialign_slab_plain(*args[:6], [f.float() for f in feats],
                                 args[7])
    lo, hi = bounds[0], bounds[0] + bounds[1]
    assert (got[:lo] == 0).all() and (got[hi:] == 0).all()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-2 * max(ref.abs().max(), 1e-30)
