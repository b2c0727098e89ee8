"""Data- and tensor-parallel CTC steps held against the single-process
step.

The sharded step (train/ctc.py with parallel/collectives.py's groups) must
be the single-process step of the same global batch.  ``run_layouts``
spawns ``WORLD`` ranks on one ``torch.distributed`` group and runs, in
turn, each layout of ``LAYOUTS`` (data x model: 2 x 1, 1 x 2, 2 x 2; the ranks beyond
a layout's mesh sit it out): every rank cuts its shard of the same whole
weights and its rows of the same batch, takes the loss and the gradients
and one optimizer step, and the model group gathers the gradients and the
updated weights back to whole leaves (``all_gather_model``).  Rank 0 writes
them; ``compare`` measures them against ``reference``, the unsharded step
in this process.

The geometry is the JAX package's own sharded-step test
(tests/test_multichip.py: d_model 32, 4 heads, FFN 64, CTC hidden 32, two
layers, a batch of eight [160, 128] feature rows with ten labels).  The
ranks talk over NCCL when each has its own card and over ``gloo``
otherwise (the CPU, or all ranks on ``cuda:0``: NCCL refuses two ranks on
one card).  The tests run it on the CPU, and ``chip_smoke.py`` (phase 14)
on the card.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import tempfile
from typing import Dict, Tuple

import numpy as np
import torch

from asr_streaming_tpu_torch.models.asr import ASRConfig
from asr_streaming_tpu_torch.models.emformer import EmformerConfig
from asr_streaming_tpu_torch.models.encoder import EncoderConfig
from asr_streaming_tpu_torch.train import ctc
from asr_streaming_tpu_torch.utils.checkpoint import (
    load_params, params_from_numpy, save_params,
)

LAYOUTS: Tuple[Tuple[int, int], ...] = ((2, 1), (1, 2), (2, 2))
WORLD = 4
VOCAB = 24
WARMUP = 10
# loss relative, gradient leaves relative L2, updated weights max abs
# (``compare``; ``bounds`` adds the key bias's)
BOUNDS = {"loss": 1e-5, "grads": 1e-4, "params": 1e-5}


def tiny_config() -> ASRConfig:
    emf = EmformerConfig(d_model=32, num_heads=4, ffn_dim=64, num_layers=2)
    return ASRConfig(encoder=EncoderConfig(
        input_dim=128, d_model=32, vocab_size=VOCAB, ctc_hidden_dim=32,
        emformer=emf))


def tiny_batch(seed: int = 1) -> Dict[str, np.ndarray]:
    """The JAX sharded-step test's batch, drawn the same way."""
    rng = np.random.default_rng(seed)
    return {"feats": rng.standard_normal((8, 160, 128)).astype(np.float32),
            "feat_lens": np.full((8,), 160, np.int32),
            "labels": rng.integers(2, VOCAB, (8, 10)).astype(np.int32),
            "label_lens": np.full((8,), 10, np.int32)}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


def _batch(arrays, device) -> ctc.Batch:
    return ctc.Batch(*(torch.as_tensor(np.asarray(arrays[k])).to(device)
                       for k in ctc.Batch._fields))


def one_step(enc: dict, cfg: ASRConfig, batch: ctc.Batch, groups=None):
    """(loss, grads, updated encoder) of one CTC step from fresh
    optimizer state."""
    loss, grads = ctc.make_loss_and_grads(cfg, groups)(enc, batch)
    opt = ctc.make_optimizer(cfg, warmup_steps=WARMUP, groups=groups)
    new, _, _ = ctc.make_train_step(cfg, opt, groups)(
        {"encoder": enc}, opt.init(enc), batch)
    return float(loss), grads, new["encoder"]


def reference(enc: dict, cfg: ASRConfig, arrays, device) -> dict:
    """The single-process step on the whole batch."""
    loss, grads, new = one_step(params_from_numpy(enc, device), cfg,
                                _batch(arrays, device))
    return {"loss": loss, "grads": _numpy(grads), "params": _numpy(new)}


def _rank(rank, port, device, backend, work, cfg):
    import torch.distributed as dist

    from asr_streaming_tpu_torch.parallel.collectives import (
        all_gather_model, make_groups,
    )
    from asr_streaming_tpu_torch.parallel.mesh import (
        make_mesh, shard_batch, shard_params,
    )

    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        if backend == "nccl":
            dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        enc = load_params(os.path.join(work, "encoder.npz"))
        with np.load(os.path.join(work, "batch.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        for dp, mp in LAYOUTS:
            mesh = make_mesh(devices=[dev] * (dp * mp), model_parallel=mp)
            groups = make_groups(mesh, rank)
            if groups is None:
                continue
            shard = params_from_numpy(shard_params(enc, mesh, rank), dev)
            rows = shard_batch(ctc.Batch(*(arrays[k] for k in
                                           ctc.Batch._fields)), mesh, rank)
            loss, grads, new = one_step(shard, cfg,
                                        _batch(rows._asdict(), dev), groups)
            grads = all_gather_model(grads, groups)
            new = all_gather_model(new, groups)
            if rank == 0:
                save_params(os.path.join(work, f"{dp}x{mp}.npz"),
                            {"loss": torch.tensor(loss), "grads": grads,
                             "params": new})
        if rank == 0:
            with open(os.path.join(work, "modules.json"), "w") as f:
                json.dump(foreign_modules(), f)
    finally:
        dist.destroy_process_group()


def foreign_modules():
    """The modules of jax or of the JAX package this process holds (the
    port imports neither)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "asr_streaming_tpu"))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_layouts(enc: dict, cfg: ASRConfig, arrays, device="cpu") -> dict:
    """Spawn ``WORLD`` ranks that run each layout on the whole encoder
    ``enc`` (a tree of tensors or arrays) and the global batch
    ``arrays``; returns {(dp, mp): {"loss", "grads", "params"}}, the
    gradients and weights gathered whole; the backend under ``"backend"``
    and rank 0's ``foreign_modules()`` under ``"foreign_modules"``."""
    import torch.multiprocessing as tmp

    backend = "gloo"
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() >= WORLD:
        backend = "nccl"
    with tempfile.TemporaryDirectory() as work:
        save_params(os.path.join(work, "encoder.npz"), _numpy(enc))
        np.savez(os.path.join(work, "batch.npz"), **arrays)
        tmp.spawn(_rank, args=(free_port(), str(device), backend, work, cfg),
                  nprocs=WORLD, join=True)
        with open(os.path.join(work, "modules.json")) as f:
            out = {"backend": backend, "foreign_modules": json.load(f)}
        for dp, mp in LAYOUTS:
            blob = load_params(os.path.join(work, f"{dp}x{mp}.npz"))
            out[(dp, mp)] = {"loss": float(blob["loss"]),
                             "grads": blob["grads"], "params": blob["params"]}
    return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree, np.float64)


def bounds(cfg: ASRConfig) -> dict:
    """``BOUNDS`` and the key bias's (``compare``): twice the learning
    rate of the first update, the most two Adam first steps can differ
    by.  It bounds nothing finer: it catches only a non-finite update or
    one that breaks Adam's rule."""
    lr = ctc.noam_annealing(1.0, cfg.encoder.d_model, WARMUP)(0)
    return {**BOUNDS, "key_bias": 2 * lr}


def compare(got: dict, want: dict) -> dict:
    """The errors of one layout against the reference: the loss
    (relative), the worst gradient leaf (relative L2) and the worst
    updated weight (max abs).

    The key half of ``b_kv`` is apart: a key bias shifts every score of a
    query alike and the softmax removes it, so its gradient is 0 in exact
    arithmetic and both sides hold rounding noise there (5e-9 against
    leaves near 1).  Adam's first update divides a gradient by its own
    size, so each side moves those weights by up to the learning rate in
    the noise's sign; ``key_bias`` is their largest difference, held only
    to ``bounds``' rule-of-Adam limit."""
    g_err = 0.0
    want_g = dict(_leaves(want["grads"]))
    for path, g in _leaves(got["grads"]):
        w = want_g[path]
        assert g.shape == w.shape, (path, g.shape, w.shape)
        g_err = max(g_err, float(np.linalg.norm(g - w)
                                 / max(np.linalg.norm(w), 1e-30)))
    want_p = dict(_leaves(want["params"]))
    p_err = k_err = 0.0
    for path, p in _leaves(got["params"]):
        d = np.abs(p - want_p[path])
        if path.endswith("/b_kv"):
            key, d = np.split(d, 2, axis=-1)
            k_err = max(k_err, float(key.max()))
        p_err = max(p_err, float(d.max()))
    return {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "grads": g_err, "params": p_err, "key_bias": k_err}
