"""TRAIN_BN of the port against m3d's on the CPU: the port's BatchNorm
against flax's ``nn.BatchNorm`` in training mode (output, input gradient
and running statistics after two updates, for the backbone's and
classifier's momentum 0.9 and the mask head's 0.99, in float32 and
bfloat16), and one RPN_TRAINING step with TRAIN_BN against JAX's own
jitted step at the TINY config of tests/test_torch_models.py.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3d.config import Config
from m3d_torch import checkpoints as T_ckpt
from m3d_torch.data.generators import to_device
from m3d_torch.models.backbone import BatchNorm
from test_torch_models import randomize
from test_torch_mrcnn_train import tiny_variables  # noqa: F401 (fixture)
from test_torch_train import _leaves
from test_torch_train_cli import (GRAB, STEP, _first_batches,
                                  train_data)  # noqa: F401 (fixture)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("momentum", [0.9, 0.99])
def test_batchnorm_train_matches_flax(momentum, dtype):
    """Two training-mode calls on [4, 5, 3, 2, 16] inputs (mean 0.5, std
    2) from seeded scale, bias and statistics: each output and input
    gradient (a seeded cotangent) within 1e-5 of flax's, relative to the
    array's largest value, and the running mean and variance after the
    two updates within 1e-5. In bfloat16 (inputs and cotangents bfloat16
    values) the output may differ by its one rounding to bfloat16 (2^-8
    relative) where the float32 values straddle a rounding boundary (none
    did here), and the input gradient by one bfloat16 step at the array's
    largest value (2^-7 of it): JAX rounds each of the gradient's three
    terms to bfloat16 before it sums them, the port sums them in float32
    and rounds once (measured: one step, 2^-6 at a largest value of
    2.66)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(5)
    c = 16
    scale, bias = rng.uniform(0.5, 1.5, c), rng.randn(c) * 0.1
    mean0, var0 = rng.randn(c) * 0.1, rng.uniform(0.5, 1.5, c)
    bn = nn.BatchNorm(use_running_average=False, momentum=momentum,
                      epsilon=1e-5, dtype=jdt)
    stats = {"mean": jnp.asarray(mean0, jnp.float32),
             "var": jnp.asarray(var0, jnp.float32)}
    params = {"scale": jnp.asarray(scale, jnp.float32),
              "bias": jnp.asarray(bias, jnp.float32)}
    mod = BatchNorm(c, momentum, dtype=tdt)
    mod.batch_stats = True
    with torch.no_grad():
        mod.weight.copy_(torch.tensor(scale))
        mod.bias.copy_(torch.tensor(bias))
        mod.running_mean.copy_(torch.tensor(mean0))
        mod.running_var.copy_(torch.tensor(var0))
    for call in range(2):
        x = jnp.asarray(rng.randn(4, 5, 3, 2, c) * 2 + 0.5, jdt)
        cot = jnp.asarray(rng.randn(*x.shape), jdt)

        def f(x, stats=stats):
            y, mut = bn.apply({"params": params, "batch_stats": stats}, x,
                              mutable=["batch_stats"])
            return y, mut["batch_stats"]

        y, vjp, stats = jax.vjp(f, x, has_aux=True)
        (gx,) = vjp(cot)
        xt = torch.tensor(np.asarray(x.astype(jnp.float32)), dtype=tdt,
                          requires_grad=True)
        yt = mod(xt)
        yt.backward(torch.tensor(np.asarray(cot.astype(jnp.float32)),
                                 dtype=tdt))
        assert yt.dtype == tdt and xt.grad.dtype == tdt
        for got, want, bf16_tol in ((yt, y, 2.0 ** -8), (xt.grad, gx, None)):
            got = got.detach().float().numpy()
            want = np.asarray(want.astype(jnp.float32))
            tol = 1e-5 * float(np.abs(want).max())
            if dtype == "bfloat16":
                tol = (np.maximum(tol, bf16_tol * np.abs(want)) if bf16_tol
                       else 2.0 ** -7 * float(np.abs(want).max()))
            np.testing.assert_array_less(np.abs(got - want), tol + 1e-30,
                                         err_msg=f"call {call}")
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(mod, name).numpy(),
                                   np.asarray(stats[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    mod.batch_stats = False
    with torch.no_grad():   # running statistics unchanged at inference
        before = mod.running_mean.clone()
        mod(torch.zeros(2, c, dtype=tdt))
        assert torch.equal(before, mod.running_mean)


def test_rpn_train_bn_step_matches_jax(tiny_variables, train_data,
                                       monkeypatch):
    """One RPN_TRAINING step with TRAIN_BN on the generators' first batch:
    the metrics within 1e-3 relative of JAX's step, and every backbone
    running statistic after the step within 1e-3 of each leaf's largest
    value of JAX's batch_stats, all of them moved (the heads' not run and
    unchanged); evaluation then runs on running statistics. On batch
    statistics this random-weight TINY trunk is ill-conditioned (flax's
    E[x^2] - E[x]^2 in float32; stage 5 has eight samples a channel):
    JAX's float32 feature maps lie 4e-4 relative from ones computed with
    float64 statistics, the port's 4e-5 (measured in the MRCNN step), and
    the loss differs by 3.8e-4 relative."""
    from m3d.train.rpn import RPNTrainer as JRPNTrainer
    from m3d_torch.config import Config as TConfig
    from m3d_torch.train.optim import Optimizer
    from m3d_torch.train.rpn import RPNTrainer

    v = randomize(tiny_variables, 13)
    _, _, batch = _first_batches(train_data, "training", monkeypatch)
    kw = dict(STEP, DATA_DIR=train_data, MODE="training", TRAIN_BN=True)
    copy = jax.tree_util.tree_map(jnp.array, v)
    step = JRPNTrainer(Config(**kw), mode="training").make_train_step(GRAB)
    _, _, jstats, jmet = step(copy["params"], GRAB.init(v["params"]),
                              copy["batch_stats"], batch)
    trainer = RPNTrainer(TConfig(**kw), device="cpu")
    model = trainer.model
    T_ckpt.restore_by_name(model, T_ckpt.params_from_jax(v))
    opt = Optimizer(trainer.config, dict(model.named_parameters()))
    tmet = trainer.make_train_step(opt)(to_device(batch, "cpu"))
    assert tmet.keys() == jmet.keys()
    for k in jmet:
        np.testing.assert_allclose(tmet[k], float(jmet[k]), rtol=1e-3,
                                   atol=1e-6, err_msg=k)
    got = _leaves(T_ckpt.params_to_jax(model.state_dict())["batch_stats"])
    want = _leaves(jax.device_get(jstats))
    src = _leaves(v["batch_stats"])
    assert got.keys() == want.keys()
    for k in want:
        trunk = k.startswith("resnet/")
        assert np.array_equal(got[k], src[k]) != trunk, k
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-3 * float(np.abs(want[k]).max()),
                                   err_msg=k)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert all(m.batch_stats for m in bns)   # the step's BatchNorm mode;
    trainer.make_proposal_fn()(batch["image"][:1])   # evaluation's:
    assert not any(m.batch_stats for m in bns)
