"""The port's parallelism (m3d_torch/parallel/{mesh,spatial,dryrun}.py) on
the CPU: a gloo twin of a multi-card run, four ranks in four processes, at
TINY in float32, held to the port's one-process functions and to JAX's
unsharded ones.

One module fixture starts one 4-rank gloo job (spawn, a FileStore in a
temp dir) that computes every case; each test reads its case. Data
parallelism: one RPN, one e2e HEAD and one MRCNN step at a global batch of
4 on a ``data`` mesh of 4 (JAX's target uniforms injected, each rank
keeping its rows), and the RPN step with TRAIN_BN; each held to the port's
one-process step on the same batch with JAX's DP tolerance
(tests/test_dp_equivalence.py: loss rel 1e-5, every parameter rtol 2e-5 /
atol 2e-6), and to JAX's jitted step with the tolerances of the one-process
parity tests (tests/test_torch_train_cli.py, tests/test_torch_mrcnn_train
.py). Spatial parallelism: ``spatial_extract_features`` at (1, 4) and
(2, 2) and ``make_spatial_inference`` at (1, 4), held to the one-process
functions with tests/test_spatial.py's 1e-4 and to JAX's with the
tolerances of tests/test_torch_models.py and tests/test_torch_monolithic
.py; the trunk's gradients through the halo rows at (1, 4) against one
process; ``dryrun_multichip(4)`` against its
one-rank run; the mesh layout; and the errors.

The rank job imports nothing of JAX: every JAX input reaches it as numpy.
Rank 0 writes its parameters and gradients to files, which each test
loads in turn (a TINY state dict is ~190 MB).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from m3d_torch.config import Config as TConfig
from m3d_torch.data.generators import to_device
from m3d_torch.parallel import mesh as M
from m3d_torch.parallel import spatial as S

WORLD = 4
N_PROP = 64              # STEP's POST_NMS_ROIS_TRAINING
DP_RTOL, DP_ATOL, DP_LOSS = 2e-5, 2e-6, 1e-5   # test_dp_equivalence.py
SPATIAL_TOL = 1e-4                             # test_spatial.py


# The rank job ------------------------------------------------------------

def _inject(module, uniforms):
    """``module``'s detection_targets_batch takes the whole batch's
    ``uniforms``, each rank its rows (by its ``shard``). Returns the
    original function."""
    real = module.detection_targets_batch

    def take(*a, **k):
        i, _ = k.pop("shard", None) or (0, 1)
        b = a[0].shape[0]
        return real(*a, **dict(k, uniforms=tuple(u[i * b:(i + 1) * b]
                                                  for u in uniforms)))

    module.detection_targets_batch = take
    return real


def rpn_step(kw, ckpt, batch, mesh):
    """One RPN_TRAINING step of the port (weights from ``ckpt``). Returns
    (metrics, model)."""
    from m3d_torch.train.optim import Optimizer
    from m3d_torch.train.rpn import RPNTrainer

    tr = RPNTrainer(TConfig(**dict(kw, RPN_WEIGHTS=ckpt)), device="cpu",
                    mesh=mesh)
    model = tr.init_variables()
    opt = Optimizer(tr.config, dict(model.named_parameters()))
    met = tr.make_train_step(opt)(to_device(M.shard_batch(mesh, batch),
                                            "cpu"))
    return met, model


def e2e_step(kw, ckpt, batch, uniforms, mesh):
    """One e2e HEAD_TRAINING step with the whole batch's uniforms."""
    from m3d_torch.train import head as T_head

    real = _inject(T_head, uniforms)
    try:
        tr = T_head.HeadTrainer(TConfig(**dict(kw, RPN_WEIGHTS=ckpt)),
                                device="cpu", mesh=mesh)
        opt = tr.prepare_e2e()
        met = tr.make_e2e_step(opt, None)(to_device(
            M.shard_batch(mesh, batch), "cpu"))
    finally:
        T_head.detection_targets_batch = real
    return met, tr.model


def mrcnn_step(kw, ckpt, batch, uniforms, mesh):
    """One MRCNN_TRAINING step with the whole batch's uniforms."""
    from m3d_torch.train import mrcnn as T_mrcnn

    real = _inject(T_mrcnn, uniforms)
    try:
        tcfg = TConfig(**dict(kw, RPN_WEIGHTS=ckpt))
        tr = T_mrcnn.MrcnnTrainer(tcfg, device="cpu", mesh=mesh)
        model = T_mrcnn.MaskRCNN.from_config(tcfg, mode="training",
                                             device="cpu").eval()
        opt = tr.prepare_train(model)
        met = tr.make_train_step(model, opt, None)(to_device(
            M.shard_batch(mesh, batch), "cpu"))
    finally:
        T_mrcnn.detection_targets_batch = real
    return met, model


def tiny_model(kw, state):
    from m3d_torch.checkpoints import restore_by_name
    from m3d_torch.models.mask_rcnn import MaskRCNN

    model = MaskRCNN.from_config(TConfig(**kw), device="cpu").eval()
    stats = restore_by_name(model, {k: torch.as_tensor(v)
                                    for k, v in state.items()})
    assert stats["missing"] == 0 and stats["skipped"] == 0, stats
    return model


def trunk_loss(model, feats, weights):
    """A scalar of every pyramid level: sum(P_l * W_l)."""
    return sum((f * torch.as_tensor(w)).sum() for f, w in zip(feats,
                                                               weights))


def _state(model, grads=False):
    return {k: (p.grad if grads else p).detach().numpy().copy()
            for k, p in model.named_parameters()
            if not grads or p.grad is not None}


def _checksum(model) -> float:
    return float(sum(p.detach().double().sum() for p in model.parameters()))


def _job(rank, inp):
    """Every case on one rank of a 4-rank gloo world. Rank 0 saves its
    parameters and gradients under ``inp["out"]``; every rank returns its
    metrics and checksums."""
    from m3d_torch.parallel.dryrun import _rank_step

    out, res = inp["out"], {}
    devices = ["cpu"] * WORLD
    mesh = M.make_mesh(TConfig(GPU_COUNT=WORLD), devices)
    res["mesh"] = (mesh.shape, mesh.coords, mesh.axis("data").index)
    res["rows"] = M.shard_batch(mesh, {"a": np.arange(8), "b": np.arange(3),
                                       "c": np.float32(1.0)})
    try:
        M.make_mesh(TConfig(GPU_COUNT=2))
    except ValueError as e:
        res["world_error"] = str(e)

    def save(name, model, grads=True):
        if rank == 0:
            torch.save({"params": _state(model),
                        "grads": _state(model, True) if grads else None,
                        "buffers": {k: b.numpy().copy() for k, b in
                                    model.named_buffers()}},
                       os.path.join(out, f"{name}.pt"))

    cases = (("rpn", rpn_step, (inp["ckpt"], inp["rpn_batch"])),
             ("bn", rpn_step, (inp["ckpt"], inp["rpn_batch"])),
             ("e2e", e2e_step, (inp["ckpt"], inp["e2e_batch"], inp["e2e_u"])),
             ("mrcnn", mrcnn_step, (inp["ckpt"], inp["mrcnn_batch"],
                                    inp["mrcnn_u"])))
    for name, fn, args in cases:
        met, model = fn(inp[f"{name}_kw"], *args, mesh)
        save(name, model)
        res[name] = {"metrics": met, "checksum": _checksum(model)}
        del model
    # The one-process references, one case a rank, on one thread (as
    # test_cli_gpu_count_training's: oneDNN's threaded reductions alone
    # move these steps past JAX's DP tolerance, measured there).
    name, fn, args = cases[rank]
    solo = M.Mesh(("data",), (1,), 0, {a: M.Axis(a, None, 1, 0)
                                       for a in ("data", "all")})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        met, model = fn(inp[f"{name}_kw_one"], *args, solo)
    finally:
        torch.set_num_threads(threads)
    torch.save({"metrics": met, "params": _state(model),
                "buffers": {k: b.numpy().copy()
                            for k, b in model.named_buffers()}},
               os.path.join(out, f"{name}_one.pt"))
    del model

    model = tiny_model(inp["tiny_kw"], inp["state"])
    image = torch.as_tensor(inp["image"])
    for shape in ((1, 4), (2, 2)):
        m2 = S.make_mesh_2d(*shape, devices)
        row = m2.coords[0]
        layout = {}
        with torch.no_grad():   # each data row: its images at full height
            feats = S.spatial_extract_features(
                model, image.chunk(shape[0])[row], m2, layout=layout)
        res[f"feats{shape}"] = ([f.numpy() for f in feats], layout, row)
        res[f"block{shape}"] = S.image_sharding(
            m2, torch.arange(4 * 8).reshape(4, 8, 1, 1, 1)).flatten().tolist()
    m14 = S.make_mesh_2d(1, 4, devices)
    got = S.make_spatial_inference(model, m14)(
        image, torch.as_tensor(inp["meta"]), torch.as_tensor(inp["anchors"]))
    res["infer"] = {k: v.numpy() for k, v in got.items()}

    model.zero_grad()
    feats = S.spatial_extract_features(model, image[:1], m14)
    M.scale_loss(m14, trunk_loss(model, feats, inp["grad_w"])).backward()
    M.sync_grads(m14, model.parameters())
    if rank == 0:
        torch.save({"grads": _state(model, True)},
                   os.path.join(out, "halo_grads.pt"))
    res["dryrun"] = _rank_step(rank, WORLD, devices)
    if rank == 1:   # the same step in one process (this rank, alone)
        from m3d_torch.parallel.dryrun import dryrun_step

        alone = M.Mesh(("data", "space"), (1, 1), 0, {
            a: M.Axis(a, None, 1, 0) for a in ("data", "space", "all")})
        res["dryrun_one"] = dryrun_step(WORLD, alone, "cpu")
    return res


# The fixture: the job's inputs from JAX's side, the job, the references --

@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """This module's own torch work on at most two threads: its four ranks
    and the other test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    """Six 64 x 64 x 8 volumes (four for training), as
    tests/test_torch_train_cli.py's."""
    from m3d_torch.data import synthetic as T_syn

    d = str(tmp_path_factory.mktemp("par_data"))
    T_syn.generate_experiment(6, 64, d, seed=21, image_depth=8)
    T_syn.split_dataset(d, test_ratio=0.34)
    return d


def _first_batch(data_dir, kw, mode):
    """The first batch of JAX's and the port's RPNGenerator for ``kw``
    (equal arrays)."""
    from m3d.config import Config
    from m3d.data.datasets import ToyDataset as JToy
    from m3d.data.generators import RPNGenerator as JGen
    from m3d_torch.data.datasets import ToyDataset as TToy
    from m3d_torch.data.generators import RPNGenerator as TGen
    from test_torch_native import jax_native

    jax_native()
    out = []
    for toy, gen, conf in ((JToy, JGen, Config), (TToy, TGen, TConfig)):
        ds = toy()
        ds.load_dataset(data_dir, is_train=True, class_names=("object",))
        ds.prepare()
        out.append(next(iter(gen(ds.filter_positive(), conf(**kw),
                                 mode=mode, seed=0))))
    for k in out[0]:
        np.testing.assert_array_equal(out[1][k], out[0][k], k)
    return out[1]


@pytest.fixture(scope="module")
def par(train_data, tmp_path_factory):
    """Inputs, the 4-rank job's results (rank order) and its output dir
    (removed after the module's tests)."""
    import jax

    from m3d.anchors import normalized_pyramid_anchors
    from m3d.config import Config
    from m3d.image_meta import default_meta
    from m3d.train import checkpoints as J_ckpt
    from test_torch_models import TINY, randomize
    from test_torch_mrcnn_train import MRCNN, jax_uniforms, mrcnn_batch
    from test_torch_train_cli import STEP

    from m3d_torch.checkpoints import params_from_jax

    out = str(tmp_path_factory.mktemp("par_out"))
    from m3d.models.mask_rcnn import MaskRCNN as JMaskRCNN
    from m3d.models.mask_rcnn import init_params

    jm = JMaskRCNN.from_config(Config(**TINY), mode="training")
    shapes = jax.eval_shape(lambda k: init_params(jm, k),
                            jax.random.PRNGKey(0))
    v = randomize(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), shapes), 13)
    ckpt = os.path.join(out, "src.msgpack")
    J_ckpt.save_params(ckpt, v)
    one = dict(IMAGES_PER_GPU=WORLD, GPU_COUNT=1)
    dp = dict(IMAGES_PER_GPU=1, GPU_COUNT=WORLD)
    kws = {"rpn": dict(STEP, MODE="training", DATA_DIR=train_data),
           "bn": dict(STEP, MODE="training", DATA_DIR=train_data,
                      TRAIN_BN=True),
           "e2e": dict(STEP, MODE="training_head_e2e", DATA_DIR=train_data),
           "mrcnn": dict(MRCNN, DATA_DIR=train_data)}
    mp = pytest.MonkeyPatch()
    try:
        batches = {
            "rpn": _first_batch(train_data, dict(kws["rpn"], **one),
                                "training"),
            "e2e": _first_batch(train_data, dict(kws["e2e"], **one), "e2e"),
            "mrcnn": mrcnn_batch(train_data, dict(kws["mrcnn"], **one), mp,
                                 ids=(0, 1, 2, 3))}
    finally:
        mp.undo()
    keys = {"e2e": jax.random.PRNGKey(5), "mrcnn": jax.random.PRNGKey(7)}
    uniforms = {k: jax_uniforms(key, WORLD, N_PROP) for k, key in
                keys.items()}
    cfg = Config(**TINY)
    image = np.random.RandomState(3).randn(2, 64, 64, 8, 1).astype(
        np.float32)
    rng = np.random.RandomState(9)
    state = {k: t.numpy() for k, t in params_from_jax(v).items()}
    model = tiny_model(TINY, state)
    with torch.no_grad():
        shapes = [tuple(f.shape[1:]) for f in model.extract_features(
            torch.as_tensor(image[:1]))]
    grad_w = [rng.randn(1, *s).astype(np.float32) for s in shapes]
    inp = {"out": out, "ckpt": ckpt,
           **{f"{k}_kw": dict(kw, **dp) for k, kw in kws.items()},
           **{f"{k}_kw_one": dict(kw, **one) for k, kw in kws.items()},
           "rpn_batch": batches["rpn"], "e2e_batch": batches["e2e"],
           "mrcnn_batch": batches["mrcnn"], "e2e_u": uniforms["e2e"],
           "mrcnn_u": uniforms["mrcnn"], "tiny_kw": TINY, "state": state,
           "image": image, "meta": np.tile(default_meta(cfg)[None], (2, 1)),
           "anchors": normalized_pyramid_anchors(cfg), "grad_w": grad_w}
    results = M.spawn(_job, WORLD, ["cpu"] * WORLD, args=(inp,),
                      run_dir=out, timeout=900)
    yield dict(inp=inp, res=results, v=v, kws=kws, one=one, batches=batches,
               uniforms=uniforms, keys=keys, model=model)
    shutil.rmtree(out, ignore_errors=True)   # ~3 GB of saved states


def _saved(par, name):
    return torch.load(os.path.join(par["inp"]["out"], f"{name}.pt"),
                      weights_only=False)


def _held_to_one_process(par, name, atol=lambda k: DP_ATOL, params=True):
    """The case's rank metrics and (with ``params``) parameters against the
    port's one process on the same batch (rank ``name``'s reference run;
    JAX's DP tolerance, ``atol(leaf)`` where a case says otherwise); every
    rank ends with the same parameters. Returns (rank 0's metrics, its
    saved state, the reference's)."""
    res = par["res"]
    sums = {r[name]["checksum"] for r in res}
    assert len(sums) == 1, sums
    met = res[0][name]["metrics"]
    assert all(r[name]["metrics"] == met for r in res)
    one = _saved(par, f"{name}_one")
    assert one["metrics"].keys() == met.keys()
    for k in met:
        np.testing.assert_allclose(met[k], one["metrics"][k], rtol=DP_LOSS,
                                   atol=DP_ATOL, err_msg=k)
    saved = _saved(par, name)
    for k, p in one["params"].items() if params else ():
        np.testing.assert_allclose(saved["params"][k], p, rtol=DP_RTOL,
                                   atol=atol(k), err_msg=k)
    return met, saved, one


class _Grads:
    """A model stand-in whose parameters carry saved gradients, for
    test_torch_train_cli's ``_assert_grads`` / ``_assert_params``."""

    def __init__(self, saved, grads=True):
        self.p = {}
        for k, v in saved["params"].items():
            t = torch.nn.Parameter(torch.as_tensor(v), requires_grad=False)
            g = saved["grads"].get(k) if grads else None
            t.grad = None if g is None else torch.as_tensor(g)
            self.p[k] = t

    def named_parameters(self):
        return self.p.items()


# Data parallelism --------------------------------------------------------

def test_dp_rpn_step(par):
    """RPN step at a global batch of 4 on a data mesh of 4: the one-process
    step's metrics and parameters (DP tolerance); JAX's jitted step's
    metrics (1e-4), gradients (FPN / RPN 1e-4, ResNet 2e-2 in norm, as
    test_rpn_train_step_matches_jax) and parameters after the step."""
    import jax
    import jax.numpy as jnp
    import optax

    from m3d.config import Config
    from m3d.train import optim as J_opt
    from m3d.train.rpn import RPNTrainer as JRPNTrainer
    from test_torch_train_cli import GRAB, _assert_grads, _assert_params

    met, saved, _ = _held_to_one_process(par, "rpn")
    v = par["v"]
    jcfg = Config(**dict(par["kws"]["rpn"], **par["one"]))
    jstep = JRPNTrainer(jcfg, mode="training").make_train_step(GRAB)
    _, grads, _, jmet = jstep(jax.tree_util.tree_map(jnp.array, v["params"]),
                              GRAB.init(v["params"]), v["batch_stats"],
                              par["batches"]["rpn"])
    tx = J_opt.build_optimizer(jcfg, v["params"])
    jnew = jax.jit(lambda p, g: optax.apply_updates(p, tx.update(
        g, tx.init(p), p)[0]))(v["params"], grads)   # eager: ~400 compiles
    for k in jmet:
        np.testing.assert_allclose(met[k], float(jmet[k]), rtol=1e-4,
                                   err_msg=k)
    got = _Grads(saved)
    names = list(saved["params"])
    _assert_grads(got, grads, names,
                  lambda k: 2e-2 if k.startswith("resnet.") else 1e-4)
    _assert_params(got, jnew, names)


def test_dp_e2e_head_step(par):
    """e2e HEAD_TRAINING step at a global batch of 4 on a data mesh of 4,
    JAX's target uniforms split over the ranks: the one-process step
    (DP tolerance), the frozen trunk unchanged, and JAX's jitted step's
    metrics (1e-4), head gradients (1e-4) and heads after the step."""
    import jax
    import jax.numpy as jnp

    from m3d.config import Config
    from m3d.train.head import HeadTrainer as JHeadTrainer
    from m3d.train.head import _is_frozen_for_e2e as j_frozen
    from test_torch_mrcnn_train import jax_new_params
    from test_torch_train_cli import GRAB, _assert_grads, _assert_params

    from m3d_torch.train.head import _is_frozen_for_e2e

    met, saved, _ = _held_to_one_process(par, "e2e")
    assert met["pos_count"] > 0
    v = par["v"]
    kw = dict(par["kws"]["e2e"], **par["one"])
    jstep = JHeadTrainer(Config(**kw)).make_e2e_step(GRAB)
    _, grads, _, jmet = jstep(jax.tree_util.tree_map(jnp.array, v["params"]),
                              GRAB.init(v["params"]), v["batch_stats"],
                              par["batches"]["e2e"], par["keys"]["e2e"])
    for k in jmet:
        np.testing.assert_allclose(met[k], float(jmet[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    heads = [k for k in saved["params"] if not _is_frozen_for_e2e(k)]
    got = _Grads(saved)
    _assert_grads(got, grads, heads, lambda k: 1e-4)
    _assert_params(got, jax_new_params(kw, v["params"], grads, j_frozen),
                   heads)
    src = {k: p for k, p in tiny_model(
        par["inp"]["tiny_kw"], par["inp"]["state"]).named_parameters()}
    for k in saved["params"]:
        if _is_frozen_for_e2e(k):
            np.testing.assert_array_equal(saved["params"][k],
                                          src[k].detach().numpy(), k)


# The MRCNN step's ResNet leaves after the step: the one-process step
# itself moves them by up to 3.5e-6 between 1 and 8 CPU threads (measured:
# res5c_branch2c, the gradient 3.5e-4 off at a scale of 5.6e-2, lr 0.01),
# more than JAX's DP atol of 2e-6; the head loss reaches them through the
# ROIAligns' gather. Every other leaf keeps JAX's DP tolerance.
MRCNN_RESNET_ATOL = 1e-5


def test_dp_mrcnn_step(par):
    """MRCNN_TRAINING step (LEARNING_LAYERS "all") at a global batch of 4
    on a data mesh of 4: the one-process step (DP tolerance, the ResNet
    leaves within ``MRCNN_RESNET_ATOL``) and JAX's jitted step's metrics
    (1e-4), gradients (test_torch_mrcnn_train's ``_tol``) and every leaf
    after the optimiser and MaxNorm."""
    from test_torch_mrcnn_train import _tol, jax_new_params, jax_step
    from test_torch_train_cli import _assert_grads, _assert_params

    met, saved, _ = _held_to_one_process(
        par, "mrcnn", atol=lambda k: MRCNN_RESNET_ATOL
        if k.startswith("resnet.") else DP_ATOL)
    assert met["class_pos_count"] > 0
    kw = dict(par["kws"]["mrcnn"], **par["one"])
    jmet, grads, _ = jax_step(kw, par["v"], par["batches"]["mrcnn"],
                              par["keys"]["mrcnn"])
    for k in jmet:
        np.testing.assert_allclose(met[k], float(jmet[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    got = _Grads(saved)
    names = list(saved["params"])
    _assert_grads(got, grads, names, _tol)
    _assert_params(got, jax_new_params(kw, par["v"]["params"], grads),
                   names)


def test_dp_train_bn_running_statistics(par):
    """TRAIN_BN on the RPN step over a data mesh of 4: BatchNorm's batch
    statistics are the whole batch's, so the step's metrics and every
    running mean and variance after it are the one-process step's (DP
    tolerance); the statistics moved. The parameters after the step are
    not held here: on random TINY weights the TRAIN_BN step's gradient is
    ill-conditioned (the one-process step itself moves them by up to
    1.2e-4 between 1 and 8 CPU threads, measured, its gradient 1.5 %
    off)."""
    _, saved, one = _held_to_one_process(par, "bn", params=False)
    moved = 0
    for k, b in one["buffers"].items():
        np.testing.assert_allclose(saved["buffers"][k], b, rtol=DP_RTOL,
                                   atol=DP_ATOL, err_msg=k)
        if k.endswith("running_mean"):
            moved += bool(np.abs(b).max() > 0)
    assert moved > 50, moved


# Spatial parallelism -----------------------------------------------------

@pytest.fixture(scope="module")
def jax_features(par):
    """JAX's jitted ``extract_features`` of the two images."""
    import jax

    from m3d.config import Config
    from m3d.models.mask_rcnn import MaskRCNN as JMaskRCNN

    from test_torch_models import TINY

    jm = JMaskRCNN.from_config(Config(**TINY), mode="inference")
    return jax.device_get(jax.jit(lambda v, img: jm.apply(
        v, img, method=JMaskRCNN.extract_features))(par["v"],
                                                    par["inp"]["image"]))


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_spatial_extract_features(par, jax_features, shape):
    """The pyramid of a Y-sharded trunk: every space rank holds the whole
    pyramid of its data row, equal to the one-process
    ``extract_features`` within 1e-4 and to JAX's within
    test_backbone_matches_jax's 1e-4 of each level's scale. At 64 rows
    over 4 space ranks C1-C4 and P2-P4 run sharded, C5, P5 and P6
    replicated; over 2 every level but P6 (P5's one row a shard is not on
    P6's stride of 2)."""
    res = par["res"]
    with torch.no_grad():
        ref = [f.numpy() for f in par["model"].extract_features(
            torch.as_tensor(par["inp"]["image"]))]
    jref = jax_features
    n_data, n_space = shape
    rows = {}
    for r in res:
        feats, layout, row = r[f"feats{shape}"]
        rows.setdefault(row, feats)
        for a, b in zip(feats, rows[row]):
            np.testing.assert_array_equal(a, b)   # space ranks agree
    got = [np.concatenate([rows[d][lvl] for d in range(n_data)])
           for lvl in range(5)]
    for g, w, j in zip(got, ref, jref):
        np.testing.assert_allclose(g, w, rtol=SPATIAL_TOL, atol=SPATIAL_TOL)
        scale = float(np.abs(np.asarray(j)).max())
        np.testing.assert_allclose(g / scale, np.asarray(j) / scale,
                                   rtol=1e-4, atol=1e-4)
    layout = res[0][f"feats{shape}"][1]
    want = {"C1", "C2", "C3", "C4", "P2", "P3", "P4"} if n_space == 4 else \
        {"C1", "C2", "C3", "C4", "C5", "P2", "P3", "P4", "P5"}
    assert {k for k, sh in layout.items() if sh} == want, layout


def test_spatial_inference(par):
    """``make_spatial_inference`` at (1, 4): every rank's outputs equal;
    the one-process ``MaskRCNN.forward``'s and JAX's jitted
    ``model.apply``'s within test_torch_monolithic's
    ``_assert_outputs_match`` (1e-4, equal valid sets; its exemption of
    classifier outputs on proposals clipped to the far border, whose
    sampling flips on one ulp of the feature maps)."""
    import jax

    from m3d.config import Config
    from m3d.models.mask_rcnn import MaskRCNN as JMaskRCNN
    from test_torch_models import TINY
    from test_torch_monolithic import _assert_outputs_match

    inp = par["inp"]
    args = [torch.as_tensor(inp[k]) for k in ("image", "meta", "anchors")]
    want = par["model"].forward(*args)
    outs = [r["infer"] for r in par["res"]]
    for o in outs[1:]:
        for k in o:
            np.testing.assert_array_equal(o[k], outs[0][k], k)
    got = {k: torch.as_tensor(v) for k, v in outs[0].items()}
    _assert_outputs_match({k: v.numpy() for k, v in want.items()}, got)
    jm = JMaskRCNN.from_config(Config(**TINY), mode="inference")
    ref = jax.device_get(jax.jit(lambda vv, img: jm.apply(
        vv, img, inp["meta"], inp["anchors"]))(par["v"], inp["image"]))
    _assert_outputs_match(ref, got)


def test_spatial_gradients_through_the_halo(par):
    """The trunk's gradients of sum_l(P_l * W_l) for one image at (1, 4)
    (two edge and two interior shards; the halo rows' and the gathers'
    backward carry them), summed over the ranks, against one process's,
    within 1e-4 of each leaf's gradient scale. One image: over a batch the
    one-process gradient of this random trunk is itself 1e-3 off between
    one call on the batch and a call per image (measured)."""
    model = par["model"]
    model.zero_grad()
    image = torch.as_tensor(par["inp"]["image"][:1])
    trunk_loss(model, model.extract_features(image),
               par["inp"]["grad_w"]).backward()
    saved = _saved(par, "halo_grads")["grads"]
    n = 0
    for k, p in model.named_parameters():
        if p.grad is None:
            assert k not in saved, k
            continue
        g = p.grad.numpy()
        scale = max(float(np.abs(g).max()), 1e-12)
        np.testing.assert_allclose(saved[k] / scale, g / scale,
                                   rtol=SPATIAL_TOL, atol=SPATIAL_TOL,
                                   err_msg=k)
        n += k.startswith("resnet.")
    model.zero_grad()
    assert n > 100, n


def test_dryrun_multichip_matches_one_rank(par):
    """``dryrun_multichip(4)``'s step on a (2, 2) mesh (rank 0 of the job)
    against the same step in one process (``dryrun_step`` with no mesh, run
    by rank 1 after the job): loss within 1e-5 relative, the parameters'
    norm after the step within 1e-6."""
    got, want = par["res"][0]["dryrun"], par["res"][1]["dryrun_one"]
    assert np.isfinite(got["loss"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=DP_LOSS)
    np.testing.assert_allclose(got["param_norm"], want["param_norm"],
                               rtol=1e-6)


# The mesh ----------------------------------------------------------------

def test_mesh_layout_and_shard_batch_rows(par):
    """JAX's test_mesh_2d_layout, one rank a device: a 1-D data mesh of 4
    (rank r at (r,)), a (2, 2) mesh (r at (r // 2, r % 2)); shard_batch
    gives rank r rows [2r, 2r + 2) of an 8-row leaf and the whole of a
    leaf the axis does not divide; image_sharding gives each rank its data
    row's images and its Y rows; the same world's mesh of 2 raises, naming
    both sizes. One process: a mesh of 1, and a (1, 1) 2-D mesh."""
    for r, res in enumerate(par["res"]):
        shape, coords, index = res["mesh"]
        assert shape == (WORLD,) and coords == (r,) and index == r
        np.testing.assert_array_equal(res["rows"]["a"], [2 * r, 2 * r + 1])
        np.testing.assert_array_equal(res["rows"]["b"], np.arange(3))
        assert "asks for 2 ranks" in res["world_error"]
        assert "world size 4" in res["world_error"]
        assert res["feats(2, 2)"][2] == r // 2
        d, sp = divmod(r, 2)     # image_sharding: data rows, then Y rows
        assert res["block(2, 2)"] == [8 * b + y for b in (2 * d, 2 * d + 1)
                                      for y in range(4 * sp, 4 * sp + 4)]
        assert res["block(1, 4)"] == [8 * b + y for b in range(4)
                                      for y in (2 * r, 2 * r + 1)]
    one = M.make_mesh()
    assert one.shape == (1,) and one.is_main and one.axis("data").group \
        is None
    m2 = S.make_mesh_2d(n_space=1)
    assert m2.axis_names == ("data", "space") and m2.shape == (1, 1)


def test_errors(tmp_path):
    """Too few devices (ranks on cards a CPU host lacks, a mesh bigger than
    this one process) and a world that differs from the mesh raise,
    naming both numbers."""
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match=r"2 ranks need 2 cards; "
                           r"torch.cuda.device_count\(\) is \d"):
            M.spawn(_job, 2)
    with pytest.raises(RuntimeError, match="a mesh of 3 ranks needs 3 "
                       "processes"):
        M.make_mesh(TConfig(GPU_COUNT=3))
    with pytest.raises(RuntimeError, match="a mesh of 2 ranks"):
        S.make_mesh_2d(1, 2)
    with pytest.raises(ValueError, match="2 devices for 3 ranks"):
        M.spawn(_job, 3, ["cpu", "cpu"])
