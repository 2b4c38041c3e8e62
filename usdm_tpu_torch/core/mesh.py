"""Device meshes, placements and collectives over torch.distributed.

Port of usdm_tpu/core/mesh.py.  usdm_tpu builds a `jax.sharding.Mesh` over
the slice's devices, annotates arrays with NamedShardings and lets XLA
insert the collectives.  The port runs SPMD, one process per GPU (gloo
ranks on the CPU), over the group that core/distributed.py forms: a `Mesh`
lays the group's ranks out as usdm_tpu lays out `jax.devices()` and holds
one process group per axis (torch's DeviceMesh), and the trainers call the
collectives themselves, each over the group of its axis:

  * `all_gather` (all_gather_into_tensor): FSDP's gather of a weight at use;
  * `reduce_scatter` (reduce_scatter_tensor): a weight's gradient over data;
  * `all_reduce`: after a row-split product, and for counts and norms.

Every call adds one to `mesh.counts[f"{op}:{axis}"]`, so a caller can state
how many a step ran.  The differentiable forms (`gather_param`,
`copy_to_model`, `reduce_from_model`, `gather_vocab`) are autograd
Functions: an all-gather whose backward reduce-scatters, the identity whose
backward all-reduces (before a column-split product), the all-reduce whose
backward is the identity (after a row-split product), and the vocab
all-gather whose backward keeps this rank's block.

Axis conventions, as usdm_tpu's:
  "data"    : data parallel; FSDP shards params and optimizer state here
  "model"   : tensor parallel; attention heads / MLP hidden split here
  "replica" : multi-slice runs: plain data parallelism across slices
A placement spec is a tuple with one entry per dimension of a leaf: the
axis that dimension splits over, or None (usdm_tpu's PartitionSpec).
`use_mesh` is usdm_tpu's context manager; nothing reads an ambient mesh
here, every call takes its mesh.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from usdm_tpu_torch.core.tree import tree_leaves, tree_map

DATA_AXIS = "data"
MODEL_AXIS = "model"
REPLICA_AXIS = "replica"  # multi-slice runs: plain DP across slices


# ------------------------------------------------------------- layouts
def layout(n: int, dp: int = -1, tp: int = 1, num_slices: int = 1) -> np.ndarray:
    """The ranks 0..n-1 as a [num_slices, dp, tp] array, row-major, as
    usdm_tpu reshapes jax.devices() (create_mesh: [dp, tp]; create_dcn_mesh:
    [num_slices, dp, tp], the process boundary on the outer axis).  dp=-1
    takes every rank left.  Raises by name where the numbers do not fit."""
    if num_slices < 1 or tp < 1 or (dp < 1 and dp != -1):
        raise ValueError(f"mesh sizes must be positive: num_slices={num_slices} dp={dp} tp={tp}")
    if n % num_slices:
        raise ValueError(f"{n} ranks are not divisible into {num_slices} slices")
    per_slice = n // num_slices
    if dp == -1:
        if per_slice % tp:
            raise ValueError(f"{per_slice} ranks per slice are not divisible by tp={tp}")
        dp = per_slice // tp
    if num_slices * dp * tp != n:
        raise ValueError(f"num_slices({num_slices}) * dp({dp}) * tp({tp}) = "
                         f"{num_slices * dp * tp} != ranks({n})")
    return np.arange(n).reshape(num_slices, dp, tp)


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of a (data, model) or (replica, data, model) mesh
    over the initialized group: the axis names, the [*sizes] array of
    ranks, this rank's coordinate, one process group per axis, this rank's
    device, and the collectives run so far (`counts`)."""

    axis_names: Tuple[str, ...]
    ranks: np.ndarray
    rank: int
    groups: Dict[str, Any]
    device: torch.device
    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        if axis not in self.axis_names:
            return 0
        where = np.argwhere(self.ranks == self.rank)[0]
        return int(where[self.axis_names.index(axis)])

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The axes a batch's rows split over: data, and replica before it
        on a multi-slice mesh (usdm_tpu's batch_spec)."""
        return tuple(a for a in (REPLICA_AXIS, DATA_AXIS) if a in self.axis_names)

    @property
    def batch_shards(self) -> int:
        return math.prod(self.size(a) for a in self.batch_axes)

    @property
    def batch_index(self) -> int:
        """This rank's block of rows: row-major over batch_axes."""
        i = 0
        for a in self.batch_axes:
            i = i * self.size(a) + self.coord(a)
        return i


def _check_group(n: int, device) -> None:
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {n} ranks needs an initialized {n}-rank torch.distributed "
                           "group (usdm_tpu_torch.core.distributed.initialize: torchrun, or "
                           "--coordinator/--num_processes/--process_id)")
    size = dist.get_world_size()
    if size != n:
        raise ValueError(f"a mesh of {n} ranks needs a {n}-rank group, this one has {size} ranks")
    want = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if dist.get_backend() != want:
        raise ValueError(f"a mesh on {device} needs a {want} group, this one is "
                         f"{dist.get_backend()}")


def _build(ranks: np.ndarray, names: Tuple[str, ...], device) -> Mesh:
    from torch.distributed.device_mesh import DeviceMesh

    _check_group(ranks.size, device)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    dm = DeviceMesh(device.type, torch.from_numpy(ranks.copy()), mesh_dim_names=names)
    return Mesh(names, ranks, dist.get_rank(), {a: dm.get_group(a) for a in names}, device)


def create_mesh(dp: int = -1, tp: int = 1, device="cuda") -> Mesh:
    """A (data, model) mesh over the group's ranks; dp=-1 means every rank
    left.  Raises by name when the group lacks those ranks."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if dp != -1 and dp * tp != n:
        _check_group(dp * tp, device)
    return _build(layout(n, dp, tp)[0], (DATA_AXIS, MODEL_AXIS), device)


def single_device_mesh(device="cuda") -> Mesh:
    """A 1 x 1 mesh over a one-rank group."""
    return create_mesh(dp=1, tp=1, device=device)


def create_dcn_mesh(num_slices: int, dp: int = -1, tp: int = 1, device="cuda") -> Mesh:
    """A (replica, data, model) mesh: plain data parallelism across
    `num_slices` blocks of consecutive ranks, FSDP and TP within each.
    Batches split over (replica, data); params keep their (data, model)
    specs and are replicated across slices."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if dp != -1 and num_slices * dp * tp != n:
        _check_group(num_slices * dp * tp, device)
    return _build(layout(n, dp, tp, num_slices), (REPLICA_AXIS, DATA_AXIS, MODEL_AXIS), device)


@contextlib.contextmanager
def use_mesh(mesh: Mesh) -> Iterator[Mesh]:
    """usdm_tpu's `with use_mesh(mesh):` -> the mesh."""
    yield mesh


def param_count(params: Any) -> int:
    return sum(int(t.numel()) for t in tree_leaves(params))


# ------------------------------------------------------------- collectives
def all_reduce(x: torch.Tensor, mesh: Mesh, axes: Optional[Sequence[str]]) -> torch.Tensor:
    """Sum `x` in place over each axis of `axes`, one all-reduce an axis;
    None: over every rank, in one all-reduce."""
    if axes is None:  # the whole mesh: the group's every rank
        dist.all_reduce(x)
        mesh.counts["all_reduce:world"] += 1
        return x
    for a in axes:
        dist.all_reduce(x, group=mesh.groups[a])
        mesh.counts[f"all_reduce:{a}"] += 1
    return x


def all_reduce_coalesced(tensors: Sequence[torch.Tensor], mesh: Mesh,
                         axes: Sequence[str]) -> None:
    """Sum `tensors` in place over each axis of `axes`: one all-reduce an
    axis, of their concatenation."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce(flat, mesh, axes)
    with torch.no_grad():
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))


def all_reduce_grads(params: Any, mesh: Mesh) -> None:
    """Data parallelism's gradient sum: every leaf's `.grad` of a replicated
    params tree summed over the batch axes, one all-reduce an axis."""
    all_reduce_coalesced([t.grad for t in tree_leaves(params) if t.grad is not None], mesh,
                         mesh.batch_axes)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank of `axis`'s block of `x`, concatenated along `dim`."""
    n = mesh.size(axis)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mesh.groups[axis])
    mesh.counts[f"all_gather:{axis}"] += 1
    if dim == 0:
        return out
    return torch.cat(out.chunk(n), dim=dim)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block (along `dim`) of the sum of `x` over `axis`."""
    n = mesh.size(axis)
    src = x.contiguous() if dim == 0 else torch.cat([p.contiguous() for p in x.chunk(n, dim)])
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=mesh.groups[axis])
    mesh.counts[f"reduce_scatter:{axis}"] += 1
    return out


class _GatherParam(torch.autograd.Function):
    """FSDP at use: forward casts the shard to `dtype` and all-gathers it
    over `axis` along `dim`; backward reduce-scatters the full weight's
    gradient in f32 (a sum over the axis) and returns it in the shard's
    dtype."""

    @staticmethod
    def forward(ctx, shard, mesh, axis, dim, dtype):
        ctx.args = (mesh, axis, dim, shard.dtype)
        return all_gather(shard.to(dtype), mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, dim, dt = ctx.args
        return reduce_scatter(grad.float(), mesh, axis, dim).to(dt), None, None, None, None


class _CopyToModel(torch.autograd.Function):
    """The identity before a column-split product; backward all-reduces the
    partial input gradients over `model`."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.mesh, (MODEL_AXIS,)), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over `model` after a row-split product; backward is the
    identity."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.contiguous().clone(), mesh, (MODEL_AXIS,))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherVocab(torch.autograd.Function):
    """Every model rank's vocab block of `x` [..., V/tp] -> [..., V] (last
    dim); backward keeps this rank's block (every rank computes the same
    loss from the gathered logits)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.block = (x.shape[-1], mesh.coord(MODEL_AXIS))
        moved = x.movedim(-1, 0)
        return all_gather(moved, mesh, MODEL_AXIS, 0).movedim(0, -1)

    @staticmethod
    def backward(ctx, grad):
        n, r = ctx.block
        return grad.narrow(-1, r * n, n), None


def gather_param(shard: torch.Tensor, mesh: Mesh, dim: int, dtype: torch.dtype) -> torch.Tensor:
    return _GatherParam.apply(shard, mesh, DATA_AXIS, dim, dtype)


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)


def gather_vocab(x: torch.Tensor, mesh: Mesh, vocab: int) -> torch.Tensor:
    """The vocab-split logits gathered and cut to the true vocab: the padding
    rows (zero weights, engine/tp.py shard_vocab) never reach a softmax."""
    return _GatherVocab.apply(x, mesh)[..., :vocab]


# ------------------------------------------------------------- placements
@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where one leaf lives: `spec` (an axis or None per dimension) over
    `mesh`.  `shape` is the leaf's whole shape; a dimension that the axes
    do not divide may be padded with zeros (`pad`, the vocab rows) up to a
    multiple, and `gather` cuts the padding off again."""

    mesh: Mesh
    spec: tuple
    shape: Tuple[int, ...] = ()
    pad: bool = False

    def _splits(self):
        return [(d, a) for d, a in enumerate(self.spec) if a is not None]

    def local_shape(self) -> Tuple[int, ...]:
        out = list(self.shape)
        for d, a in self._splits():
            out[d] = -(-out[d] // self.mesh.size(a)) if self.pad else out[d] // self.mesh.size(a)
        return tuple(out)

    def check(self) -> None:
        for d, a in self._splits():
            n = self.mesh.size(a)
            if self.shape[d] % n and not self.pad:
                raise ValueError(f"dimension {d} of a {tuple(self.shape)} leaf does not divide "
                                 f"over {a}={n}")

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf `full` (a new tensor)."""
        if tuple(full.shape) != tuple(self.shape):
            raise ValueError(f"a leaf of {tuple(full.shape)} where {tuple(self.shape)} was laid out")
        self.check()
        x = full
        for d, a in self._splits():
            n, r = self.mesh.size(a), self.mesh.coord(a)
            rows = -(-x.shape[d] // n)
            lo, hi = min(r * rows, x.shape[d]), min((r + 1) * rows, x.shape[d])
            part = x.narrow(d, lo, hi - lo)
            if hi - lo < rows:
                pad = list(part.shape)
                pad[d] = rows - (hi - lo)
                part = torch.cat([part, part.new_zeros(pad)], dim=d)
            x = part
        x = x.contiguous()
        shares = x.untyped_storage().data_ptr() == full.untyped_storage().data_ptr()
        return x.clone() if shares else x

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's block (no autograd)."""
        x = local.detach().to(self.mesh.device)
        for d, a in reversed(self._splits()):
            x = all_gather(x, self.mesh, a, d)
        return x[tuple(slice(0, n) for n in self.shape)]

    def gather_to_host(self, local: torch.Tensor) -> Optional[torch.Tensor]:
        """The whole leaf on the host of rank 0 (None on the other ranks,
        which join the gathers): a checkpoint's or an export's leaf."""
        full = self.gather(local)
        return full.cpu() if self.mesh.rank == 0 else None

    @property
    def replicated_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.mesh.axis_names if a not in self.spec)


def sharding(mesh: Mesh, *spec) -> Sharding:
    return Sharding(mesh, tuple(spec))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def logical_to_sharding(mesh: Mesh, logical: Any) -> Any:
    """A tree of specs (tuples) -> a tree of Shardings over `mesh`."""
    return tree_map(lambda spec: Sharding(mesh, tuple(spec)), logical)


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's rows of every leaf of a global batch (numpy arrays or
    tensors, leading dim the rows): block `batch_index` of `batch_shards`
    over (replica, data), as usdm_tpu's P((replica, data), ...).  Raises
    when the rows do not divide."""
    n, i = mesh.batch_shards, mesh.batch_index

    def one(x):
        if getattr(x, "ndim", 0) < 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not divide over "
                             f"{'x'.join(mesh.batch_axes)}={n} ranks")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]

    if isinstance(batch, dict):
        return {k: one(v) for k, v in batch.items()}
    return one(batch)
