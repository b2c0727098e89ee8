"""The collectives of data- and tensor-parallel training on
``torch.distributed``: what GSPMD inserts into the JAX package's sharded
train step (asr_streaming_tpu/parallel/mesh.py, train/run.py).

One process per mesh entry (parallel/mesh.py: rank ``i`` in data row
``i // mp``, model column ``i % mp``).  ``ParallelGroups`` holds the
process groups:

  * one ``data`` group per model column: the ranks that hold the same
    shard of the weights and different rows of the batch; gradients are
    averaged over it;
  * one ``model`` group per data row: the ranks that hold the shards of
    one whole model and the same rows; the split products reduce over it.

The two ends of a split product (Megatron's f and g):

  * ``column_entry``, before a product whose weight is split by column:
    identity forward, the input's gradient summed over ``model`` backward
    (each rank's columns contribute a part of it);
  * ``row_exit``, after a product whose weight is split by row: the partial
    outputs summed over ``model`` forward, identity backward.

Without a mesh (``groups`` None) nothing here runs and the single-process
step is what it was.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import torch
import torch.distributed as dist

from asr_streaming_tpu_torch.parallel.mesh import (
    DeviceMesh, _map_named, _spec_for, gather_params, split_axis,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ParallelGroups:
    """This rank's place in the mesh and its two process groups."""
    mesh: DeviceMesh
    rank: int
    data: Optional[dist.ProcessGroup]
    model: Optional[dist.ProcessGroup]

    @property
    def data_parallel(self) -> int:
        return self.mesh.shape["data"]

    @property
    def model_parallel(self) -> int:
        return self.mesh.model_parallel


def make_groups(mesh: DeviceMesh, rank: int) -> Optional[ParallelGroups]:
    """Create every data and model group of ``mesh``.  Every rank of the
    default group calls this, in the same order (``new_group`` is
    collective), those beyond the mesh too: they get None, and log that
    they take no part, as JAX leaves the devices beyond its mesh idle."""
    dp, mp = mesh.shape["data"], mesh.shape["model"]
    data = model = None
    for c in range(mp):
        g = dist.new_group([r * mp + c for r in range(dp)])
        if rank < dp * mp and rank % mp == c:
            data = g
    for r in range(dp):
        g = dist.new_group([r * mp + c for c in range(mp)])
        if rank < dp * mp and rank // mp == r:
            model = g
    if rank >= dp * mp:
        log.info("rank %d is beyond the (data=%d, model=%d) mesh: idle",
                 rank, dp, mp)
        return None
    return ParallelGroups(mesh, rank, data, model)


class _ColumnEntry(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _RowExit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def column_entry(x: torch.Tensor, groups: Optional[ParallelGroups]):
    if groups is None or groups.model_parallel == 1:
        return x
    return _ColumnEntry.apply(x, groups.model)


def row_exit(x: torch.Tensor, groups: Optional[ParallelGroups]):
    if groups is None or groups.model_parallel == 1:
        return x
    return _RowExit.apply(x, groups.model)


def mean_over_data(tree, groups: ParallelGroups):
    """Each leaf all-reduced over the data group, as a mean."""
    if groups.data_parallel == 1:
        return tree

    def mean(name, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=groups.data)
        return g.div_(groups.data_parallel)

    return _map_named(mean, tree)


def global_sum_squares(grads, groups: ParallelGroups) -> torch.Tensor:
    """The squared norm of the whole model's gradient from this rank's
    shard: the split leaves' squares summed over the model group, the
    replicated leaves counted once."""
    split, whole = [], []

    def visit(name, g):
        (whole if split_axis(_spec_for(name, g)) is None else split).append(
            torch.sum(g * g))
        return g

    _map_named(visit, grads)
    zero = torch.zeros((), dtype=torch.float32,
                       device=(split + whole)[0].device)
    s = sum(split, zero)
    if groups.model_parallel > 1:
        s = s.clone()
        dist.all_reduce(s, group=groups.model)
    return s + sum(whole, zero)


def all_gather_model(tree, groups: ParallelGroups) -> dict:
    """The whole tree on every rank of the model group, from each rank's
    shard: ``parallel/mesh.py::gather_params`` of this rank's shard at its
    own column and copies filled with -0.0 at the others, the split
    leaves then summed over the group.  -0.0 + x is x for every x, so the
    sum is exact whatever the order.  An all-reduce moves CUDA tensors on
    NCCL and on gloo alike, where an all-gather of CUDA tensors does not
    work on gloo."""
    mp = groups.model_parallel
    tree = _map_named(lambda name, x: x.detach(), tree)
    if mp == 1:
        return _map_named(lambda name, x: x.clone(), tree)
    _, col = groups.mesh.coords(groups.rank)

    def split(name, x):
        return split_axis(_spec_for(name, x)) is not None

    def shard_at(c):
        return _map_named(lambda name, x: x if c == col or not split(name, x)
                          else torch.full_like(x, -0.0), tree)

    whole = gather_params([shard_at(c) for c in range(mp)], groups.mesh)

    def reduce(name, x):
        if split(name, x):
            dist.all_reduce(x, group=groups.model)
        return x

    return _map_named(reduce, whole)
