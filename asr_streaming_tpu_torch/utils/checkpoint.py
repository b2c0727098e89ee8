"""Parameter checkpoints in the JAX package's ``.npz`` format.

Counterpart of asr_streaming_tpu/utils/checkpoint.py: a flat ``.npz`` of
the nested parameter dict, keys joined by ``"::"``.  The ``__meta__``
entry that fixture files carry is ignored.  ``params_from_numpy`` carries
a JAX-package parameter tree (as numpy arrays) over into this package's
tensors: the layouts are the same (weights ``[in, out]``, layers stacked
``[L, ...]``), so the conversion is a copy.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

SEP = "::"
META_KEY = "__meta__"


def _flatten(params, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in params.items():
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        else:
            out[key] = np.asarray(v)
    return out


def save_params(path: str, params: dict) -> None:
    np.savez(path, **_flatten(params))


def load_params(path: str, like: Optional[dict] = None) -> dict:
    """Load a nested dict of numpy arrays.  With ``like`` (a template
    dict of tensors or arrays), only the template's keys are read, each
    checked for shape and cast to the template leaf's dtype and device."""
    with np.load(path, allow_pickle=False) as blob:
        if like is None:
            out: dict = {}
            for key in blob.files:
                if key == META_KEY:
                    continue
                parts = key.split(SEP)
                node = out
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = blob[key]
            return out
        return _restore(like, blob, "")


def _restore(like: dict, blob, prefix: str) -> dict:
    out = {}
    for k, leaf in like.items():
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(leaf, dict):
            out[k] = _restore(leaf, blob, key)
            continue
        arr = blob[key]
        assert tuple(arr.shape) == tuple(leaf.shape), \
            (key, arr.shape, tuple(leaf.shape))
        if isinstance(leaf, torch.Tensor):
            out[k] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=leaf.device, dtype=leaf.dtype)
        else:
            out[k] = arr.astype(leaf.dtype)
    return out


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None):
    """Nested dict of numpy arrays (or tensors) -> nested dict of tensors
    on ``device``.  ``dtype`` (when given) applies to floating-point
    leaves only."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(
        np.array(tree))                       # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def overlay_params(params: dict, tree: dict) -> dict:
    """``params`` with every leaf that ``tree`` (nested numpy arrays, as
    ``load_params`` returns them) also holds replaced by that array, cast
    to the replaced leaf's dtype and device; shapes must agree.  Keys of
    ``tree`` that ``params`` lacks are an error; leaves it lacks stay (a
    partial checkpoint, such as a fixture's frontend and encoder)."""
    out = dict(params)
    for k, v in tree.items():
        if k not in params:
            raise KeyError(f"checkpoint key {k!r} is not a parameter")
        leaf = params[k]
        if isinstance(v, dict):
            out[k] = overlay_params(leaf, v)
            continue
        if tuple(np.shape(v)) != tuple(leaf.shape):
            raise ValueError(f"{k}: checkpoint shape {np.shape(v)} != "
                             f"{tuple(leaf.shape)}")
        out[k] = torch.from_numpy(np.array(v)).to(device=leaf.device,
                                                  dtype=leaf.dtype)
    return out
