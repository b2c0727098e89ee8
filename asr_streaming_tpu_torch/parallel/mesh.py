"""The device mesh, and the layout of training over it.

Counterpart of asr_streaming_tpu/parallel/mesh.py.  A mesh has two axes:

  * ``data``: serving's slots (parallel/serving.py, each card owning a
    contiguous block of them) or training's batch rows;
  * ``model``: the tensor-parallel split of the Emformer's attention and
    FFN products and of the CTC head (training only; serving meshes have
    ``model`` = 1).

The JAX package writes the layout as PartitionSpecs and lets GSPMD insert
the collectives.  Here training runs one process per mesh entry (rank),
each holding its own shard of the tree (``shard_params``) and its own rows
of the batch (``shard_batch``); parallel/collectives.py holds the
reductions GSPMD would insert.  Rank ``i`` sits in data row ``i // mp`` and
model column ``i % mp``, the order of JAX's ``devices.reshape(n // mp,
mp)``, so a model group is consecutive ranks.

The attention's ``w_kv`` is ``[L, D, 2D]``, the K columns then the V
columns.  A plain column split at mp = 2 would give one rank all of K and
the other all of V; a rank needs the K and V columns of its own heads, so
each half is split on its own (``HALVED``) and ``gather_params`` restores
the ``[K | V]`` order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from asr_streaming_tpu_torch import resolve_device

MODEL = "model"
# leaves whose split axis holds two halves (K then V), each split apart
HALVED = ("w_kv", "b_kv")


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """The ordered devices of the mesh, ``(n // mp, mp)`` in row-major
    order.  A device may appear more than once: each entry is one shard
    (the one-card rehearsal of a split)."""
    devices: Tuple[torch.device, ...]
    model_parallel: int = 1

    def __post_init__(self):
        if self.model_parallel < 1 or len(self.devices) % self.model_parallel:
            raise ValueError(f"{len(self.devices)} devices do not split "
                             f"into model groups of {self.model_parallel}")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices) // self.model_parallel,
                "model": self.model_parallel}

    def coords(self, rank: int) -> Tuple[int, int]:
        """(data row, model column) of ``rank``."""
        return divmod(rank, self.model_parallel)


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A ('data', 'model') mesh over ``devices`` (default: every visible
    CUDA card, in ordinal order; raises without one), cut to the first
    ``n_devices``, ``model_parallel`` consecutive entries to a model
    group."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    return DeviceMesh(devices, model_parallel)


def data_parallel_for_batch(n_ranks: int, model_parallel: int,
                            batch_size: int) -> int:
    """The JAX CTC driver's rule (train/run.py:87-90): the largest data
    axis that divides the batch and fits ``n_ranks // model_parallel``."""
    avail = n_ranks // model_parallel
    if avail < 1:
        raise ValueError(f"{n_ranks} ranks cannot hold a model group of "
                         f"{model_parallel}")
    return max(d for d in range(1, avail + 1) if batch_size % d == 0)


def _spec_for(name: str, x) -> Tuple:
    """asr_streaming_tpu/parallel/mesh.py:spec_for, by leaf name: the
    PartitionSpec as a tuple (``()`` is replicated)."""
    if x.ndim == 0:
        return ()
    if name in ("ff_w1", "w_q", "w_kv"):
        return (None, None, MODEL)
    if name in ("ff_b1", "b_q", "b_kv"):
        return (None, MODEL)
    if name in ("ff_w2", "w_out"):
        return (None, MODEL, None)
    if name == "w1":                 # CTC hidden
        return (None, MODEL)
    if name == "b1" and x.ndim == 1:
        return (MODEL,)
    if name == "w2":
        return (MODEL, None)
    return ()


def _map_named(fn, tree, name=""):
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_named(fn, v, name) for v in tree]
    return fn(name, tree)


def param_pspecs(params: dict) -> dict:
    """The tree of specs: each leaf's PartitionSpec as a tuple, ``MODEL``
    at the axis split over the model group, ``()`` where replicated."""
    return _map_named(_spec_for, params)


def split_axis(spec: Tuple) -> Optional[int]:
    return spec.index(MODEL) if MODEL in spec else None


def _cut(name: str, x: torch.Tensor, axis: int, mp: int, col: int):
    halves = 2 if name in HALVED else 1
    if x.shape[axis] % (halves * mp):
        raise ValueError(f"{name}: axis {axis} of {tuple(x.shape)} does not "
                         f"split into {mp} model shards")
    parts = [h.chunk(mp, axis)[col] for h in x.chunk(halves, axis)]
    return torch.cat(parts, axis).clone()


def shard_params(params: dict, mesh: DeviceMesh, rank: int) -> dict:
    """``rank``'s shard of a whole tree (tensors, or numpy leaves as the
    JAX package's trees hold them): split leaves cut to the rank's model
    column, the others copied whole."""
    mp = mesh.model_parallel
    _, col = mesh.coords(rank)

    def shard(name, x):
        x = torch.as_tensor(x)
        axis = split_axis(_spec_for(name, x))
        if axis is None or mp == 1:
            return x.clone()
        return _cut(name, x, axis, mp, col)

    return _map_named(shard, params)


def gather_params(shards: List[dict], mesh: DeviceMesh) -> dict:
    """The whole tree from the model group's shards (``shards[c]`` is
    column ``c``'s), in the JAX key layout: the inverse of
    ``shard_params``, bit for bit.  Replicated leaves come from column 0."""
    mp = mesh.model_parallel
    if len(shards) != mp:
        raise ValueError(f"{len(shards)} shards for a model group of {mp}")

    def gather(name, *parts):
        axis = split_axis(_spec_for(name, parts[0]))
        if axis is None or mp == 1:
            return parts[0].clone()
        halves = 2 if name in HALVED else 1
        return torch.cat([torch.cat([p.chunk(halves, axis)[h]
                                     for p in parts], axis)
                          for h in range(halves)], axis)

    return _zip_named(gather, shards)


def _zip_named(fn, trees, name=""):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_named(fn, [t[k] for t in trees], k) for k in first}
    if isinstance(first, (list, tuple)):
        return [_zip_named(fn, [t[i] for t in trees], name)
                for i in range(len(first))]
    return fn(name, *trees)


def batch_pspec() -> Tuple:
    return ("data",)


def shard_batch(batch, mesh: DeviceMesh, rank: int):
    """``rank``'s contiguous rows of the global batch: every leaf (a
    tensor or array, or a tuple / NamedTuple of them) cut along axis 0
    into the data axis's blocks."""
    dp = mesh.shape["data"]
    row, _ = mesh.coords(rank)

    def rows(x):
        if x.shape[0] % dp:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"over {dp} data shards")
        per = x.shape[0] // dp
        return x[row * per:(row + 1) * per]

    if isinstance(batch, tuple):
        parts = [rows(x) for x in batch]
        return type(batch)(*parts) if hasattr(batch, "_fields") else \
            type(batch)(parts)
    return rows(batch)
