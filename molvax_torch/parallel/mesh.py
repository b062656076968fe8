"""The data-parallel mesh over ``torch.distributed``, and the collectives of
a data-parallel step and of the latent workloads.

Port of ``molvax/parallel/mesh.py``. The reference is one controller over a
GSPMD mesh: parameters replicated, the batch split along 'data', and the
gradient's all-reduce the psum the compiler inserts. Here every rank is a
process that holds a whole replica (NCCL between cards, gloo on the CPU),
and the collectives are explicit:

* ``replicate`` broadcasts rank 0's weights, Adam state and EMA, so that
  every rank starts equal;
* ``shard_batch`` / ``shard_stacked_batch`` give a rank its rows of the
  global batch (axis 0, or axis 1 of a (K, B, ...) stack);
* ``GradientMean`` all-reduces the flattened gradients between the
  backward and the update and divides them by the data size: the psum;
* ``map_rows`` runs a latent workload on a rank's share of the rows and
  gathers all of them to every rank.

The contract the reference's tests hold and this port keeps: an N-rank step
is the 1-rank step on the same global batch. Every random draw of a step is
keyed by the global row (``row_base``, the global index of a rank's first
row), so rank r draws the noise of its rows of the global batch.

Where ``model > 1`` the batch is replicated along the model axis, as
``P(DATA_AXIS)`` does in the reference: each model index has its own data
group of ``data`` ranks, and the ranks of one data index take the same
rows. The model axis is reserved, as in the reference (no tensor
parallelism at this model scale).

A mesh keeps a gloo group on the CPU beside the device group (the same
group where the world is gloo), for the host's own agreements: stop flags,
barriers around checkpoint writes, gathers of host results. None of these
makes the card wait.

With no ``torch.distributed`` world, ``make_mesh`` gives a 1-rank mesh that
makes no collective call: every function here is then the identity, so the
one-process path stays what it was.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A ``data`` x ``model`` grid of ranks (``ranks[d * model + m]``),
    this process's place on it, and its groups and device.

    ``group`` is this rank's data group (the ranks of its model index, on
    the world's backend), ``mesh_group`` all the mesh's ranks on that
    backend, ``host_group`` all of them on gloo. All three are None on a
    1-rank mesh without a world. A rank outside the grid (``member``
    False) has no place and no groups."""

    def __init__(self, ranks: Sequence[int], data: int, model: int, rank: int, device: torch.device,
                 group=None, mesh_group=None, host_group=None):
        self.ranks = tuple(ranks)
        self.data, self.model = data, model
        self.rank = rank
        self.device = device
        self.group, self.mesh_group, self.host_group = group, mesh_group, host_group
        self.member = rank in self.ranks
        pos = self.ranks.index(rank) if self.member else -1
        self.data_rank, self.model_rank = (pos // model, pos % model) if self.member else (-1, -1)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def collective(self) -> bool:
        """Whether the mesh makes collective calls (a world exists)."""
        return self.group is not None

    @property
    def is_main(self) -> bool:
        """The mesh's first rank: the one that writes files."""
        return self.member and self.ranks[0] == self.rank

    def row_base(self, local_rows: int) -> int:
        """The global index of this rank's first row of a batch of
        ``local_rows`` rows a rank."""
        return self.data_rank * local_rows

    def __repr__(self) -> str:
        return (f"Mesh({self.data}x{self.model}, ranks={list(self.ranks)}, rank={self.rank}, "
                f"data_rank={self.data_rank}, device={self.device})")


def world_size() -> int:
    """The ranks of the initialised world, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _device_of_rank(backend: str, device) -> torch.device:
    """The rank's device: ``device`` where given; else ``cuda:LOCAL_RANK``
    under NCCL (made current, as NCCL needs), the CPU under gloo."""
    if device is not None:
        return resolve_device(device)
    if backend == "nccl":
        dev = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', dist.get_rank() % torch.cuda.device_count()))}")
        torch.cuda.set_device(dev)
        return dev
    return torch.device("cpu")


def make_mesh(cfg=None, ranks: Optional[Sequence[int]] = None,
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """The mesh of ``cfg`` (a ``MeshConfig``: ``data_axis`` x ``model_axis``)
    over the first of ``ranks`` (default: every rank of the world), or, with
    no ``cfg``, all of ``ranks`` along 'data'. Raises as the reference
    where the ranks are too few.

    Where a world is initialised (``torchrun``'s environment or a caller's
    ``init_process_group``) every rank of it must call this, in the same
    order, members or not: the groups are made collectively. Without a
    world it gives the 1-rank mesh on ``device`` (the card unless the
    caller asks for the CPU), which makes no collective call."""
    world = world_size()
    ranks = list(range(world)) if ranks is None else list(ranks)
    if cfg is None:
        data, model = len(ranks), 1
    else:
        data, model = cfg.data_axis, cfg.model_axis
    want = data * model
    if want > len(ranks):
        raise ValueError(f"mesh {data}x{model} needs {want} devices, have {len(ranks)}")
    ranks = ranks[:want]
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh([0], 1, 1, 0, resolve_device(device))
    rank, backend = dist.get_rank(), dist.get_backend()
    whole = ranks == list(range(world))
    mesh_group = dist.group.WORLD if whole else dist.new_group(ranks)
    group = mesh_group
    if model > 1:
        for m in range(model):
            g = dist.new_group(ranks[m::model])
            if rank in ranks[m::model]:
                group = g
    host_group = mesh_group if backend == "gloo" else dist.new_group(ranks, backend="gloo")
    if rank not in ranks:
        return Mesh(ranks, data, model, rank, torch.device("cpu"))
    return Mesh(ranks, data, model, rank, _device_of_rank(backend, device), group, mesh_group, host_group)


def init_from_env(cpu: bool) -> bool:
    """Join the world that ``torchrun`` describes in the environment
    (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``): gloo where
    ``cpu``, else NCCL on card ``LOCAL_RANK``. Returns whether a world is
    initialised. NCCL's asynchronous error handling is turned off before
    the init unless the environment says otherwise: torch's CUDA Graphs
    notes ask for that before a collective is captured in a graph, as the
    chunk (``train.make_train_chunk``) captures the gradient's all-reduce."""
    if dist.is_initialized():
        return True
    if "MASTER_ADDR" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if cpu:
        dist.init_process_group("gloo")
    else:
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    return True


# -- the batch ---------------------------------------------------------------


def local_rows(mesh: Optional[Mesh], n: int) -> slice:
    """This rank's rows of a global batch of ``n`` rows (all of them
    without a mesh). ``n`` must divide by the data axis."""
    if mesh is None or mesh.data == 1:
        return slice(0, n)
    if n % mesh.data:
        raise ValueError(f"batch {n} not divisible by mesh data axis {mesh.data}")
    per = n // mesh.data
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def _pad_rows(mesh: Mesh, x):
    """``x`` (numpy or torch) with its first row repeated up to a multiple
    of the data axis (the reference's ``_pad_rows``), so that every rank
    takes an equal share."""
    rem = (-x.shape[0]) % mesh.data
    if not rem:
        return x
    if isinstance(x, np.ndarray):
        return np.concatenate([x, np.repeat(x[:1], rem, axis=0)], axis=0)
    return torch.cat([x, x[:1].expand(rem, *x.shape[1:])])


def map_rows(mesh: Optional[Mesh], x, fn):
    """``fn(part, row_base)`` over this rank's share of the rows of ``x``
    (padded by ``_pad_rows``; ``row_base`` the global index of the share's
    first row), each output (a tensor, or a tuple of them, rows along axis
    0) gathered to all of ``x``'s rows on every rank, on the host: the
    reference's data-parallel latent workloads, whose rows are independent.
    Without a mesh, ``fn(x, 0)``."""
    if mesh is None or not mesh.collective or mesh.size == 1:
        return fn(x, 0)
    padded = _pad_rows(mesh, x)
    rows = local_rows(mesh, padded.shape[0])
    out = fn(padded[rows], rows.start)
    if isinstance(out, tuple):
        return tuple(_gather_rows(mesh, o)[: x.shape[0]] for o in out)
    return _gather_rows(mesh, out)[: x.shape[0]]


def _put(mesh: Mesh, a, rows) -> torch.Tensor:
    """Rows ``rows`` (an index of ``a``) of a numpy array or tensor, on the
    mesh's device."""
    part = a[rows]
    if isinstance(part, np.ndarray):
        part = torch.from_numpy(np.ascontiguousarray(part))
    return part.to(mesh.device)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows (axis 0) of each global-batch array (numpy or
    torch; None passes through), on the mesh's device: the reference's
    ``batch_sharding`` placement."""
    out = tuple(None if a is None else _put(mesh, a, local_rows(mesh, a.shape[0])) for a in arrays)
    return out if len(out) > 1 else out[0]


def shard_stacked_batch(mesh: Mesh, *arrays):
    """As ``shard_batch`` for (K, B, ...) stacks, along axis 1: the
    reference's ``stacked_batch_sharding``."""
    out = tuple(None if a is None else _put(mesh, a, (slice(None), local_rows(mesh, a.shape[1])))
                for a in arrays)
    return out if len(out) > 1 else out[0]


# -- the state -----------------------------------------------------------------


def replicate(mesh: Optional[Mesh], state):
    """``state`` (a ``train.TrainState``) with rank 0's weights, Adam
    state, learning rate, EMA and counters on every rank of the mesh:
    broadcast into each rank's own tensors in place (their addresses stay,
    their versions advance)."""
    if mesh is None or not mesh.collective:
        return state
    from ..train.loop import _state_tensors

    src = mesh.ranks[0]
    with torch.no_grad():
        for t in _state_tensors(state):
            dist.broadcast(t, src=src, group=mesh.mesh_group)
    counters = [state.step, state.base_seed, state.opt_state.count]
    dist.broadcast_object_list(counters, src=src, group=mesh.host_group)
    state.opt_state.count = counters[2]
    return state._replace(step=counters[0], base_seed=counters[1])


# -- collectives -----------------------------------------------------------------


class GradientMean:
    """The gradients' all-reduce over the data axis, divided by its size:
    the psum GSPMD inserts between a step's backward and its update. The
    gradients are copied into one flat buffer made at the first call (the
    same buffer at every call after it, so a CUDA Graph that captures the
    all-reduce reads and writes fixed addresses), all-reduced in one call,
    divided, and copied back."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._buf = None
        self._key = None
        self._views: List[torch.Tensor] = []

    def __call__(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        grads = [g for g in grads if g is not None]
        key = [(tuple(g.shape), g.dtype, g.device) for g in grads]
        if len({k[1:] for k in key}) != 1:
            raise ValueError(f"GradientMean: the gradients are of several types or devices {sorted(set(key))}")
        if self._buf is None or self._key != key:
            self._buf = torch.empty(sum(g.numel() for g in grads), dtype=grads[0].dtype, device=grads[0].device)
            self._views = list(self._buf.split([g.numel() for g in grads]))
            self._key = key
        with torch.no_grad():
            torch.cat([g.reshape(-1) for g in grads], out=self._buf)
            dist.all_reduce(self._buf, group=self.mesh.group)
            self._buf.div_(self.mesh.data)
            for g, v in zip(grads, self._views):
                g.copy_(v.view_as(g))

    @property
    def numel(self) -> int:
        """Elements reduced a step (0 before the first)."""
        return 0 if self._buf is None else self._buf.numel()


def _gather_rows(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """The global batch from each data rank's equal share ``local`` (rows
    along axis 0), on every rank, through the host group: a CPU tensor
    out."""
    local = local.cpu().contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local, group=mesh.host_group)
    return torch.cat(parts[:: mesh.model])


def agree_any(mesh: Optional[Mesh], flag: bool) -> bool:
    """Whether ``flag`` holds on any rank of the mesh (the host group): a
    decision every rank then takes together."""
    if mesh is None or not mesh.collective or mesh.size == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(t.item())


def barrier(mesh: Optional[Mesh]) -> None:
    """Every rank of the mesh waits here for the others (the host group)."""
    if mesh is not None and mesh.collective and mesh.size > 1:
        dist.barrier(group=mesh.host_group)


def broadcast_object(mesh: Optional[Mesh], obj):
    """The main rank's ``obj`` on every rank of the mesh."""
    if mesh is None or not mesh.collective or mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=mesh.ranks[0], group=mesh.host_group)
    return box[0]
