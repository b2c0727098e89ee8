"""CTC training for the streaming encoder (the Vietnamese model).

Counterpart of asr_streaming_tpu/train/ctc.py: the same chunk-scanned
encoder forward that serving runs (train == serve), the CTC loss, the
Noam warmup schedule (the reference's NoamAnnealing, streaming_decoder_v1,
lightspeech, optims, scheduler.py:5-50) and clip + AdamW.  Only ``params["encoder"]`` is
trained; the frontend buffers pass through.

The Emformer trains on its eager route (``training_config``): the CUDA
kernels of the stack, layer and attention routes have no backward, and
their wrappers refuse a call that autograd would record.

Data- and tensor-parallel training (``make_train_step(..., groups=)``,
one process per rank, parallel/collectives.py): each rank runs its rows
of the batch through its shard of the encoder, the gradients are averaged
over the data group, and the clip takes the norm of the whole model.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from asr_streaming_tpu_torch.models.asr import ASRConfig
from asr_streaming_tpu_torch.models.emformer import EmformerConfig
from asr_streaming_tpu_torch.models.encoder import encoder_forward
from asr_streaming_tpu_torch.ops.sequence import make_padding_mask
from asr_streaming_tpu_torch.parallel.collectives import (
    global_sum_squares, mean_over_data,
)
from asr_streaming_tpu_torch.train import optim
from asr_streaming_tpu_torch.train.losses import ctc_loss


def eager_emformer(emf: EmformerConfig) -> EmformerConfig:
    """The Emformer config a trainer runs: the eager route (the JAX
    trainers' XLA path), set on the dataclass whatever ASR_PALLAS_MODE
    says."""
    return dataclasses.replace(emf, route="eager", fused_attention=False,
                               quant="none")


def training_config(cfg: ASRConfig) -> ASRConfig:
    return dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, emformer=eager_emformer(cfg.encoder.emformer)))


def noam_annealing(base_lr: float, d_model: int, warmup_steps: int,
                   min_lr: float = 0.0, max_lr: Optional[float] = None):
    """NoamAnnealing: lr = base * d_model^-0.5 * min(step^-0.5,
    step * warmup^-1.5), clamped to [min_lr, max_lr], step clamped to at
    least 1 (so updates 0 and 1 share a rate), in f32 as the JAX
    schedule computes it."""
    norm = d_model ** -0.5

    def schedule(count: int) -> float:
        step = torch.tensor(max(count, 1), dtype=torch.float32)
        lr = base_lr * norm * torch.minimum(step ** -0.5,
                                            step * warmup_steps ** -1.5)
        if max_lr is not None:
            lr = torch.clamp(lr, max=max_lr)
        return float(torch.clamp(lr, min=min_lr))

    return schedule


class Batch(NamedTuple):
    feats: torch.Tensor        # [B, T, n_mels]
    feat_lens: torch.Tensor    # [B] int
    labels: torch.Tensor       # [B, Lmax] int (blank=0 padding)
    label_lens: torch.Tensor   # [B] int


def check_model_parallel(cfg: ASRConfig, model_parallel: int) -> None:
    """A tensor-parallel split must cut whole heads, FFN columns and CTC
    hidden columns (the JAX package pads a ragged split silently)."""
    enc = cfg.encoder
    for name, n in (("num_heads", enc.emformer.num_heads),
                    ("ffn_dim", enc.emformer.ffn_dim),
                    ("ctc_hidden_dim", enc.ctc_hidden_dim)):
        if n % model_parallel:
            raise ValueError(f"model_parallel={model_parallel} does not "
                             f"divide {name}={n}")


def ctc_loss_fn(params: dict, cfg: ASRConfig, batch: Batch,
                tp=None) -> torch.Tensor:
    """Mean per-sequence CTC loss of the encoder on ``batch``, the
    Emformer on its eager route whatever ``cfg`` names.  ``tp``: the
    encoder is this rank's tensor-parallel shard."""
    cfg = training_config(cfg)
    log_probs, out_lens = encoder_forward(
        params["encoder"], cfg.encoder, batch.feats, batch.feat_lens, tp)
    logit_pad = (~make_padding_mask(out_lens, log_probs.shape[1])).to(
        torch.float32)
    label_pad = (~make_padding_mask(batch.label_lens,
                                    batch.labels.shape[1])).to(torch.float32)
    return ctc_loss(log_probs, logit_pad, batch.labels, label_pad,
                    blank_id=0).mean()


def make_optimizer(cfg: ASRConfig, base_lr: float = 1.0,
                   warmup_steps: int = 10_000,
                   weight_decay: float = 1e-6, groups=None
                   ) -> optim.GradientTransformation:
    """Clip + AdamW.  With ``groups`` (a rank of a mesh) the clip's norm
    is the whole model's; AdamW is elementwise and runs on the shard."""
    schedule = noam_annealing(base_lr, cfg.encoder.d_model, warmup_steps)
    sum_squares = None
    if groups is not None:
        def sum_squares(grads):
            return global_sum_squares(grads, groups)
    return optim.chain(
        optim.clip_by_global_norm(5.0, sum_squares),
        optim.adamw(schedule, b1=0.9, b2=0.98, eps=1e-9,
                    weight_decay=weight_decay))


def make_loss_and_grads(cfg: ASRConfig, groups=None):
    """loss_and_grads(encoder_params, batch) -> (loss, grads): the CTC
    loss and its gradient tree, with ``groups`` each averaged over the
    data group (the shard's gradient of the global batch's loss)."""
    if groups is not None:
        check_model_parallel(cfg, groups.model_parallel)

    def loss_and_grads(enc, batch: Batch):
        loss, grads = optim.value_and_grad(
            lambda e: ctc_loss_fn({"encoder": e}, cfg, batch, groups), enc)
        if groups is not None:
            grads = mean_over_data(grads, groups)
            loss = mean_over_data({"loss": loss}, groups)["loss"]
        return loss, grads

    return loss_and_grads


def make_train_step(cfg: ASRConfig, optimizer: optim.GradientTransformation,
                    groups=None):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss).
    Only params['encoder'] is trained; init opt_state with
    optimizer.init(params['encoder']).

    With ``groups`` (parallel/collectives.py::make_groups; ``optimizer``
    from ``make_optimizer(..., groups=)``), ``params`` is this rank's
    shard (parallel/mesh.py::shard_params) and ``batch`` its rows
    (``shard_batch``): the gradients and the loss are averaged over the
    data group, so with equal rows per rank the step is the
    single-process step of the global batch."""
    loss_and_grads = make_loss_and_grads(cfg, groups)

    def train_step(params, opt_state, batch: Batch):
        enc = params["encoder"]
        loss, grads = loss_and_grads(enc, batch)
        updates, opt_state = optimizer.update(grads, opt_state, enc)
        enc = optim.apply_updates(enc, updates)
        return {**params, "encoder": enc}, opt_state, loss

    return train_step
