"""Multi-GPU data-parallel serving: the slot axis split over local cards.

Counterpart of asr_streaming_tpu/parallel/serving.py.  One scheduler's
fixed slot array is cut into ``n`` contiguous blocks, shard ``i`` owning
slots ``[i*B/n, (i+1)*B/n)`` (the JAX package's ``P("data")``), and each
shard's carried state, audio context and emission buffer live on its
card.  Every tick runs the unsharded serving step (models/serving.py,
kernels A, B and E included) once per shard on that shard's rows, with
the weights copied once to each distinct card.  Shards share nothing, so
there are zero collectives and no ``torch.distributed``: each shard's
step is enqueued on its card's current stream with no host
synchronisation inside, the cards run side by side, and the host joins
the shards' packs in slot order (streaming/scheduler.py::wait_pack).

A sharded value is a list with one entry per shard, in slot order: the
per-slot inputs (segment, flags), the state, context and emission
buffer, and the output packs.  A mesh may name one card more than once;
its shards then run one after another on that card.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

from asr_streaming_tpu_torch.models.emformer import EmformerState
from asr_streaming_tpu_torch.models.rnnt import PredictorState, RNNTStreamState
from asr_streaming_tpu_torch.models.rnnt_beam import BeamState
from asr_streaming_tpu_torch.models.serving import (
    BeamServingState, ServingConfig, ServingTickOutput, make_serving_step,
)
from asr_streaming_tpu_torch.parallel.mesh import DeviceMesh, make_mesh
from asr_streaming_tpu_torch.utils.checkpoint import params_from_numpy

# the CPU shards make_serving_mesh(device="cpu") allows: the counterpart
# of the JAX tests' virtual 8-device CPU mesh (tests/conftest.py)
CPU_SHARDS = 8


def serving_state_slot_axes(cfg: ServingConfig):
    """The slot axis of every carried state leaf, in the state's own
    structure (the counterpart of ``serving_state_pspecs``).

    EmformerState leaves are [L, B, ...] (axis 1) but ``length`` [B];
    the RNNT predictor's h/c are [layers, B, H]; the device beam's leaves
    are [B, W, ...] except pred_h/pred_c [L, B, W, H]."""
    enc = EmformerState(mem=1, lc_k=1, lc_v=1, length=0)
    if cfg.model_kind == "rnnt":
        if cfg.en_beam_width_device:
            return BeamServingState(
                encoder=enc,
                beam=BeamState(tokens=0, lengths=0, scores=0, h1=0, h2=0,
                               pred_h=1, pred_c=1, pred_out=0))
        return RNNTStreamState(encoder=enc,
                               predictor=PredictorState(h=1, c=1),
                               last_token=0)
    return enc


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested NamedTuples (and ``rest``, which
    share ``tree``'s structure)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, *leaves)
                            for leaves in zip(tree, *rest)))
    return fn(tree, *rest)


def data_parallel_size(mesh: DeviceMesh) -> int:
    return mesh.shape["data"]


def _rows_per_shard(mesh: DeviceMesh, n_slots: int) -> int:
    dp = data_parallel_size(mesh)
    if n_slots % dp:
        raise ValueError(f"max_slots={n_slots} is not a multiple of the "
                         f"mesh's data axis ({dp} shards)")
    return n_slots // dp


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device for the block (nothing for a
    CPU shard)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _split(x: torch.Tensor, axis: int, mesh: DeviceMesh,
           non_blocking: bool = False) -> List[torch.Tensor]:
    """x cut along ``axis`` into the shards' blocks, each on its device
    (a copy, contiguous)."""
    per = _rows_per_shard(mesh, x.shape[axis])
    out = []
    for i, dev in enumerate(mesh.devices):
        part = x.narrow(axis, i * per, per)
        moved = part.to(dev, non_blocking=non_blocking)
        out.append(moved.clone() if moved is part else moved.contiguous())
    return out


def split_rows(x: torch.Tensor, mesh: DeviceMesh) -> List[torch.Tensor]:
    """A per-slot host tensor [B, ...] (pinned, for the card) as the
    shards' blocks, each copy started without waiting."""
    return _split(x, 0, mesh, non_blocking=True)


def join_shards(shards: list, axes, device=None):
    """The shards of one sharded value joined along their slot axes on
    ``device`` (default: the first shard's): the unsharded value.  For
    checks and tests; ``axes`` is an int or ``serving_state_slot_axes``."""
    dev = device or _first_leaf(shards[0]).device
    return _tree_map(lambda ax, *parts: torch.cat(
        [p.to(dev) for p in parts], ax), axes, *shards)


def _first_leaf(tree):
    while isinstance(tree, tuple):
        tree = tree[0]
    return tree


def replicate_params(params, mesh: DeviceMesh) -> list:
    """The weights for each shard: one copy per distinct device, shared
    by that device's shards.  A list already made by this function is
    returned as it is."""
    if isinstance(params, list):
        if len(params) != data_parallel_size(mesh):
            raise ValueError(f"{len(params)} parameter replicas for "
                             f"{data_parallel_size(mesh)} shards")
        return params
    copies = {}
    for dev in mesh.devices:
        if dev not in copies:
            with on_device(dev):
                copies[dev] = params_from_numpy(params, dev)
    return [copies[dev] for dev in mesh.devices]


def shard_serving_arrays(cfg: ServingConfig, mesh: DeviceMesh, state, ctx,
                         emission):
    """The carried arrays of ``max_slots`` slots cut into the shards'
    blocks, each placed on its device: (states, contexts, emission
    buffers), one entry per shard (emission may be None)."""
    axes = serving_state_slot_axes(cfg)
    per_leaf = _tree_map(lambda x, ax: _split(x, ax, mesh), state, axes)
    n = data_parallel_size(mesh)
    states = [_tree_map(lambda leaf: leaf[i], per_leaf) for i in range(n)]
    ctxs = _split(ctx, 0, mesh)
    ems = None if emission is None else _split(emission, 0, mesh)
    return states, ctxs, ems


def make_sharded_stepper(cfg: ServingConfig, mesh: DeviceMesh, params):
    """The serving step over the mesh's ``data`` axis, with the signature
    of the Scheduler's stepper: (params, cfg, segment, contain, active,
    new_stream, reset, state, ctx, emission) -> ServingTickOutput, every
    per-slot argument and result a list with one entry per shard.

    ``params`` (host or device weights, or replicas already made) are
    copied once per distinct device; the stepper's ``params`` attribute
    holds the replicas to pass back in."""
    step_fn = make_serving_step(cfg)

    def stepper(params, cfg, segment, contain, active, new_stream, reset,
                state, ctx, emission):
        outs = []
        for i, dev in enumerate(mesh.devices):
            with on_device(dev):
                outs.append(step_fn(
                    params[i], cfg, segment[i], contain[i], active[i],
                    new_stream[i], reset[i], state[i], ctx[i],
                    None if emission is None else emission[i]))
        return ServingTickOutput(
            pack=[o.pack for o in outs], state=[o.state for o in outs],
            emission=None if emission is None else [o.emission
                                                    for o in outs],
            ctx=[o.ctx for o in outs])

    stepper.params = replicate_params(params, mesh)
    return stepper


def make_serving_mesh(n_chips: Optional[int] = None,
                      device=None) -> DeviceMesh:
    """('data', 'model'=1) mesh over the local cards for serving: the
    first ``n_chips`` (None or 0: all of them); raises past the cards
    ``torch.cuda.device_count()`` sees.  ``device="cpu"`` (tests) builds
    ``n_chips`` CPU shards, at most CPU_SHARDS (default: all of them)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        avail, what = CPU_SHARDS, "CPU shards allowed"
    else:
        avail, what = torch.cuda.device_count(), "visible to torch (cuda)"
    n = n_chips or avail
    if n > avail or n < 1:
        raise ValueError(f"data_parallel={n} chips requested but only "
                         f"{avail} {what}")
    if dev.type == "cpu":
        return make_mesh(devices=[dev] * n)
    return make_mesh(n)
