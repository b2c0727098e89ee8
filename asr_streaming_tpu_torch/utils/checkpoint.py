"""Parameter checkpoints in the JAX package's ``.npz`` format.

Counterpart of asr_streaming_tpu/utils/checkpoint.py: a flat ``.npz`` of
the nested parameter dict, keys joined by ``"::"`` (list items by their
index).  ``load_params_auto`` also takes the reference's torch
checkpoints, converted at load (tools/convert_*.py).  The ``__meta__``
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
    items = params.items() if isinstance(params, dict) else enumerate(params)
    for k, v in items:
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
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
    tree of dicts and lists of tensors or arrays), only the template's
    keys are read, each checked for shape and cast to the template
    leaf's dtype and device."""
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


def _restore(like, blob, prefix: str):
    """``like``'s nesting (dicts and lists, as ``_flatten`` keys them)
    with each leaf read from ``blob``."""
    is_list = isinstance(like, (list, tuple))
    out = {}
    for k, leaf in (enumerate(like) if is_list else like.items()):
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(leaf, (dict, list, tuple)):
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
    return list(out.values()) if is_list else out


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None):
    """Nested dicts (and lists) of numpy arrays (or tensors) -> the same
    nesting of tensors on ``device``.  ``dtype`` (when given) applies to
    floating-point leaves only."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
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
        if isinstance(v, dict) != isinstance(leaf, dict):
            raise KeyError(f"checkpoint key {k!r}: a subtree where the "
                           "parameters hold a leaf, or the reverse")
        if isinstance(v, dict):
            out[k] = overlay_params(leaf, v)
            continue
        if tuple(np.shape(v)) != tuple(leaf.shape):
            raise ValueError(f"{k}: checkpoint shape {np.shape(v)} != "
                             f"{tuple(leaf.shape)}")
        out[k] = torch.from_numpy(np.array(v)).to(device=leaf.device,
                                                  dtype=leaf.dtype)
    return out


def _max_layer_index(keys, pattern: str) -> int:
    """1 + the largest integer ``pattern`` captures across state-dict
    keys."""
    import re

    rx = re.compile(pattern)
    idx = [int(m.group(1)) for k in keys for m in [rx.search(str(k))] if m]
    if not idx:
        raise ValueError(f"no state-dict keys match {pattern!r}")
    return 1 + max(idx)


def load_params_auto(path: str, like: dict) -> dict:
    """``like`` (the serving params, tensors) with a checkpoint merged in,
    converting a reference torch checkpoint at load.  Counterpart of
    asr_streaming_tpu/utils/checkpoint.py::load_params_auto:

      * ``.npz``: this format, possibly partial (a bootstrap ``am.npz``
        holds only the converted encoder);
      * ``.ckpt``: the reference's Vietnamese Lightning checkpoint
        (``state_dict`` with nested ``encoder``/``decoder`` dicts or flat
        prefixed keys);
      * ``.pt``/``.pth``: the reference's English torchaudio
        ``emformer_rnnt_base`` state dict.

    Layer counts come from the state-dict keys.  Subtrees the checkpoint
    lacks keep ``like``'s values (with a warning naming them); a key that
    ``like`` lacks raises ``KeyError``."""
    if not path.endswith((".ckpt", ".pt", ".pth")):
        return _merge_and_report(like, load_params(path), path)

    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    keys = list(sd.keys())
    if any(str(k).startswith(("transcriber.", "predictor.", "joiner."))
           for k in keys):
        from asr_streaming_tpu_torch.tools.convert_rnnt_checkpoint import (
            convert_rnnt_state_dict,
        )
        loaded = convert_rnnt_state_dict(
            sd,
            num_layers=_max_layer_index(
                keys, r"transcriber\..*emformer_layers\.(\d+)\."),
            pred_layers=_max_layer_index(
                keys, r"predictor\.lstm_layers\.(\d+)\."))
    else:
        from asr_streaming_tpu_torch.tools.convert_checkpoint import (
            convert_ctc_state_dict, convert_encoder_state_dict,
        )
        if "encoder" in sd and isinstance(sd["encoder"], dict):
            enc_sd, dec_sd = sd["encoder"], sd["decoder"]
        else:
            enc_sd = {k[len("encoder."):]: v for k, v in sd.items()
                      if str(k).startswith("encoder.")}
            dec_sd = {k[len("decoder."):]: v for k, v in sd.items()
                      if str(k).startswith("decoder.")}
        loaded = {"encoder": {
            **convert_encoder_state_dict(
                enc_sd,
                num_layers=_max_layer_index(
                    enc_sd, r"emformer_layers\.(\d+)\.")),
            "ctc": convert_ctc_state_dict(dec_sd),
        }}
    return _merge_and_report(like, loaded, path)


def _merge_and_report(like: dict, loaded: dict, path: str) -> dict:
    """overlay_params, with a warning naming the top-level subtrees the
    checkpoint did not touch (they keep their initialized values)."""
    merged = overlay_params(like, loaded)
    untouched = sorted(set(like) - set(loaded))
    if untouched:
        import logging
        logging.getLogger(__name__).warning(
            "checkpoint %s left %s at initialized values (partial "
            "checkpoints are expected for bootstrap subtree files — "
            "verify this is intended)", path, untouched)
    return merged
