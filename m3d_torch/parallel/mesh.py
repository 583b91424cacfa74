"""Mesh data parallelism (port of m3d/parallel/mesh.py): one process per
card, ``torch.distributed`` process groups in place of a device mesh.

JAX's ``Mesh`` holds every device in one process and GSPMD partitions the
jitted step over it. Here each rank is a process of its own holding one
card; a ``Mesh`` is that rank's view of the layout: the axis names and
sizes, its coordinates, and an ``Axis`` (process group) per axis. The batch
of ``BATCH_SIZE = IMAGES_PER_GPU * GPU_COUNT`` rows is split over the
``data`` axis (``shard_batch``: rank r keeps rows [r b, (r + 1) b)); weights
are replicated (``replicate``: a broadcast from rank 0); the step computes
the loss of the whole batch (``Axis.all_gather`` of the outputs the losses
read, with autograd through it) and sums the gradients over the ranks
(``sync_grads``), so the update equals one process's on the whole batch.

The backend follows the device: ``nccl`` for ``cuda``, ``gloo`` for
``cpu``; a caller may pass ``backend="gloo"`` for ranks that share one card
(NCCL refuses two ranks on one device). Ranks meet through a ``FileStore``
in a directory of the run (``spawn``), never a fixed TCP port, or through
the environment ``torchrun`` sets.

Departure from JAX, by necessity: JAX's ``make_mesh`` silently takes fewer
devices when fewer exist. The port raises instead, naming both numbers: it
cannot put two NCCL ranks on one card, and a smaller world would change
``BATCH_SIZE``.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


def mesh_size(config) -> int:
    """Ranks a config asks for: DEVICES_PER_HOST if set, else GPU_COUNT
    (m3d/parallel/mesh.py:23-34)."""
    want = getattr(config, "DEVICES_PER_HOST", None) or None
    if want is None:
        want = int(getattr(config, "GPU_COUNT", 1))
    return max(1, int(want))


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


class _Gather(torch.autograd.Function):
    """all_gather along ``dim`` with autograd: the backward sums every
    rank's gradient of the gathered tensor (all_reduce, which every backend
    offers on both devices) and keeps this rank's part."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.n = dim, axis, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x, group=axis.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None, None


class _Sum(torch.autograd.Function):
    """all_reduce (sum) with autograd: the gradient of a sum over the ranks
    is the sum of every rank's gradient of it."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        x = x.contiguous().clone()
        dist.all_reduce(x, group=axis.group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


class Axis:
    """One mesh axis as this rank sees it: the process group of the ranks
    that differ from it only along the axis, their count and its index.
    Without a group (one process, or an axis of size 1 in a larger world)
    every collective is the identity; a world of one rank (``torchrun
    --nproc_per_node 1``) still runs them, through its group."""

    def __init__(self, name: str, group, size: int, index: int):
        self.name, self.group, self.size, self.index = name, group, size, index

    def all_gather(self, x, dim: int = 0):
        """Concatenate every rank's ``x`` along ``dim`` in rank order; the
        gradient reaches each rank's part."""
        return x if self.group is None else _Gather.apply(x, dim, self)

    def all_reduce(self, x):
        """Sum over the axis, with autograd (the backward sums too)."""
        return x if self.group is None else _Sum.apply(x, self)


class Mesh:
    """This rank's view of an ``axis_names``-shaped mesh of ``shape``
    ranks, numbered row-major (rank = coordinates in C order)."""

    def __init__(self, axis_names, shape, rank: int, axes: dict):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        self.size = int(np.prod(self.shape))
        self.rank = int(rank)
        self.coords = tuple(int(c) for c in np.unravel_index(rank,
                                                             self.shape))
        self.axes = axes

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes files and prints."""
        return self.rank == 0

    def axis(self, name: str) -> Axis:
        """An axis by name; "all" is every rank."""
        return self.axes[name]

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, rank "
                f"{self.rank} at {self.coords})")


def _world(config, devices):
    if devices is not None:
        return len(devices)
    return mesh_size(config) if config is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)


def _joined_world(n: int) -> int:
    """This process's world size, checked against the mesh's ``n``."""
    if not dist.is_initialized():
        if n == 1:
            return 1
        raise RuntimeError(
            f"a mesh of {n} ranks needs {n} processes in a process group; "
            f"this one is alone: start the ranks with python -m m3d_torch "
            f"(it spawns them) or torchrun --nproc_per_node {n}")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"the mesh asks for {n} ranks but the process "
                         f"group has world size {world}")
    return world


def make_mesh_nd(axis_names, shape) -> Mesh:
    """Mesh of ``shape`` over this process group. Every rank must call it
    with the same arguments (the sub-groups are created collectively)."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    world = _joined_world(n)
    rank = dist.get_rank() if world > 1 else 0
    coords = np.arange(n).reshape(shape)
    here = np.unravel_index(rank, shape)
    axes = {}
    for a, name in enumerate(axis_names):
        own = None
        # Every rank creates every group of the axis, in the same order.
        others = [i for i in range(len(shape)) if i != a]
        for fixed in np.ndindex(*[shape[i] for i in others]):
            idx = [slice(None)] * len(shape)
            for i, v in zip(others, fixed):
                idx[i] = v
            ranks = coords[tuple(idx)].reshape(-1).tolist()
            group = None
            if len(ranks) == world and dist.is_initialized():
                group = dist.group.WORLD
            elif len(ranks) > 1:
                group = dist.new_group(ranks)
            if rank in ranks:
                own = group
        axes[name] = Axis(name, own, shape[a], int(here[a]))
    axes["all"] = Axis("all", dist.group.WORLD if dist.is_initialized()
                       else None, n, rank)
    return Mesh(axis_names, shape, rank, axes)


def make_mesh(config=None, devices=None, data_axis: str = "data") -> Mesh:
    """1-D data-parallel mesh. Its size is ``len(devices)`` (the ranks'
    devices) when given, else the config's (DEVICES_PER_HOST, else
    GPU_COUNT), else the process group's. It must equal the process
    group's world size; one rank needs no process group."""
    return make_mesh_nd((data_axis,), (_world(config, devices),))


def batch_sharding(mesh: Mesh, n_rows: int, data_axis: str = "data"):
    """The rows of an ``n_rows`` batch this rank keeps: a slice, or None
    (all of them) where the axis does not divide ``n_rows``."""
    ax = mesh.axis(data_axis)
    if ax.size == 1 or n_rows % ax.size:
        return None
    b = n_rows // ax.size
    return slice(ax.index * b, (ax.index + 1) * b)


def shard_batch(mesh: Mesh, batch: dict, data_axis: str = "data") -> dict:
    """Every leaf's leading (batch) rows of this rank; a leaf whose leading
    size the axis does not divide is kept whole (replicated), as JAX's."""
    out = {}
    for k, v in batch.items():
        rows = batch_sharding(mesh, np.shape(v)[0], data_axis) \
            if np.ndim(v) >= 1 else None
        out[k] = v if rows is None else v[rows]
    return out


@torch.no_grad()
def replicate(mesh: Mesh, tree):
    """Rank 0's values of every tensor of ``tree`` (a tensor, a module, or
    a dict / list / tuple of them) on every rank, in place. Returns
    ``tree``."""
    ax = mesh.axis("all")
    if ax.group is None:
        return tree
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.state_dict().values())
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    elif isinstance(tree, (list, tuple)):
        tensors = list(tree)
    else:
        tensors = [tree]
    for t in tensors:
        dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t,
                       src=0, group=ax.group)
    return tree


def scale_loss(mesh: Mesh, loss):
    """What each rank back-propagates of the replicated whole-batch loss:
    ``loss / ranks``, so the gradients summed over the ranks (the gathers'
    backward included) are the loss's own."""
    ax = mesh.axis("all")
    return loss if ax.group is None else loss / ax.size


@torch.no_grad()
def sync_grads(mesh: Mesh, params) -> None:
    """Sum every parameter's gradient over all ranks, in one collective per
    dtype (a parameter without a gradient has none on any rank)."""
    ax = mesh.axis("all")
    if ax.group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=ax.group)
        off = 0
        for g in gs:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's ``obj`` (picklable) on every rank."""
    ax = mesh.axis("all")
    if ax.group is None:
        return obj
    box = [obj if mesh.is_main else None]
    dist.broadcast_object_list(box, src=0, group=ax.group)
    return box[0]


# Launching ranks -------------------------------------------------------

def init_rank(rank: int, world: int, store: str, backend: str,
              device=None) -> None:
    """Join a ``world``-rank process group through the FileStore at
    ``store``; on a card, make ``device`` this process's current one, on
    the CPU take one thread."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    else:   # ranks on the CPU (the twin of cards) share its cores
        torch.set_num_threads(1)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            world_size=world, rank=rank)


def _rank_main(rank, fn, args, world, store, backend, devices, out_dir):
    """One spawned rank: join, run ``fn(rank, *args)``, pickle the result
    (or the error) into ``out_dir``, leave."""
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        init_rank(rank, world, store, backend, devices[rank])
        res = ("ok", fn(rank, *args))
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        res = ("error", f"rank {rank}: {type(e).__name__}: {e}\n"
               + traceback.format_exc())
    with open(path + ".tmp", "wb") as f:
        pickle.dump(res, f)
    os.replace(path + ".tmp", path)
    if res[0] == "ok" and dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn, world: int, devices=None, backend: str | None = None,
          args=(), run_dir: str | None = None, timeout: float = 3600.0):
    """Run ``fn(rank, *args)`` in ``world`` new processes (the spawn start
    method) joined in one process group; returns the list of their results
    in rank order. ``fn`` and its results must pickle. ``devices``: one per
    rank (default: ``cuda:0 .. cuda:world-1``, which must exist);
    ``backend`` defaults to the devices' (``backend_for``). The ranks meet
    through a FileStore in a fresh directory under ``run_dir`` (default: the
    temp dir). A rank that fails stops all of them, and its error is raised
    here."""
    import torch.multiprocessing as mp

    if devices is None:
        have = torch.cuda.device_count()
        if have < world:
            raise ValueError(f"{world} ranks need {world} cards; "
                             f"torch.cuda.device_count() is {have}")
        devices = [torch.device("cuda", r) for r in range(world)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    backend = backend or backend_for(devices[0])
    tmp = tempfile.mkdtemp(prefix="m3d_ranks_", dir=run_dir)
    store = os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, fn, tuple(args), world,
                                                  store, backend, devices,
                                                  tmp), daemon=False)
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            for r in range(world):
                path = os.path.join(tmp, f"rank{r}.pkl")
                if r not in results and os.path.exists(path):
                    with open(path, "rb") as f:
                        results[r] = pickle.load(f)
                    if results[r][0] == "error":
                        raise RuntimeError(results[r][1])
                elif r not in results and procs[r].exitcode is not None:
                    time.sleep(0.5)   # its result file may be landing
                    if not os.path.exists(path):
                        raise RuntimeError(f"rank {r} exited with code "
                                           f"{procs[r].exitcode} and no "
                                           f"result")
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks not done after {timeout:.0f}s")
            time.sleep(0.05)
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
        for name in os.listdir(tmp):
            os.remove(os.path.join(tmp, name))
        os.rmdir(tmp)
    return [results[r][1] for r in range(world)]
