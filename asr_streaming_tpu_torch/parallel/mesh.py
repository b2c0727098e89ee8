"""The device mesh of multi-GPU serving.

Counterpart of the serving part of asr_streaming_tpu/parallel/mesh.py
(``make_mesh``).  Serving splits one axis, ``data``: the scheduler's slots,
each card owning a contiguous block of them (parallel/serving.py).  The
``model`` axis is 1: tensor parallelism (``param_pspecs``,
``shard_params``, ``shard_batch``) is a training layout and is ported with
the training stack (ROADMAP.md, queue 1, item 7.5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from asr_streaming_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """The ordered devices of the ``data`` axis.  A device may appear more
    than once: each entry is one shard (the one-card rehearsal of a split)."""
    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": 1}


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A ('data', 'model'=1) mesh over ``devices`` (default: every visible
    CUDA card, in ordinal order; raises without one), cut to the first
    ``n_devices``."""
    if model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: tensor parallelism is a "
            "training layout, not ported yet (ROADMAP.md, queue 1, item 7.5)")
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    return DeviceMesh(devices)
