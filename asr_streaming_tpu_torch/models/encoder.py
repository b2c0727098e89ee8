"""Streaming acoustic encoder + CTC head (Vietnamese path).

Counterpart of asr_streaming_tpu/models/encoder.py:

  log-mel [B, T, 128]
    -> input_linear (128 -> d_model/stride, no bias)
    -> time reduction stride 4 (stack frames)
    -> Emformer (20 layers, carried state)
    -> CTC head: Linear -> SiLU -> Linear -> log_softmax

``input_linear`` and the CTC head are plain products outside any TPU
kernel; they go to torch.matmul.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from asr_streaming_tpu_torch import resolve_device
from asr_streaming_tpu_torch.models.emformer import (
    EmformerConfig, EmformerState, _linear_init, emformer_forward,
    emformer_stream_step, init_emformer_params, init_emformer_state,
)
from asr_streaming_tpu_torch.parallel.collectives import column_entry, row_exit


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    input_dim: int = 128            # mel bins
    d_model: int = 512
    stride: int = 4                 # time-reduction factor
    vocab_size: int = 803
    ctc_hidden_dim: int = 1024
    emformer: EmformerConfig = dataclasses.field(default_factory=EmformerConfig)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.emformer.compute_dtype

    @classmethod
    def vietnamese(cls, compute_dtype: torch.dtype = torch.float32
                   ) -> "EncoderConfig":
        return cls(emformer=EmformerConfig(compute_dtype=compute_dtype))


def init_encoder_params(gen: torch.Generator, cfg: EncoderConfig,
                        device=None) -> dict:
    """Random weights from ``gen`` on ``device`` (default CUDA; raises
    without it)."""
    device = resolve_device(device)
    reduced_dim = cfg.d_model // cfg.stride
    w_in, _ = _linear_init(gen, cfg.input_dim, reduced_dim)
    ctc_w1, ctc_b1 = _linear_init(gen, cfg.d_model, cfg.ctc_hidden_dim)
    ctc_w2, ctc_b2 = _linear_init(gen, cfg.ctc_hidden_dim, cfg.vocab_size)
    return {
        "input_linear": {"w": w_in.to(device)},
        "emformer": init_emformer_params(gen, cfg.emformer, device),
        "ctc": {"w1": ctc_w1.to(device), "b1": ctc_b1.to(device),
                "w2": ctc_w2.to(device), "b2": ctc_b2.to(device)},
    }


def init_encoder_state(cfg: EncoderConfig, batch_size: int,
                       device=None) -> EmformerState:
    return init_emformer_state(cfg.emformer, batch_size,
                               resolve_device(device))


def _time_reduction(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Stack ``stride`` consecutive frames into the feature dim."""
    b, t, d = x.shape
    pad = (stride - t % stride) % stride
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    return x.reshape(b, (t + pad) // stride, d * stride)


def _pre_emformer(params: dict, cfg: EncoderConfig,
                  feats: torch.Tensor) -> torch.Tensor:
    cdt = cfg.compute_dtype
    x = torch.matmul(feats.to(cdt), params["input_linear"]["w"].to(cdt))
    return _time_reduction(x, cfg.stride).to(torch.float32)


def ctc_head(params: dict, cfg: EncoderConfig,
             enc: torch.Tensor, tp=None) -> torch.Tensor:
    """Linear -> SiLU -> Linear -> log_softmax.  Under ``tp``
    (parallel/collectives.py's groups) ``w1``/``b1`` hold this rank's
    hidden columns and ``w2`` its rows: one reduction over the model
    group, then ``b2``."""
    p = params["ctc"]
    cdt = cfg.compute_dtype
    h = F.silu(torch.matmul(column_entry(enc.to(cdt), tp), p["w1"].to(cdt))
               + p["b1"].to(cdt))
    logits = (row_exit(torch.matmul(h, p["w2"].to(cdt)), tp)
              + p["b2"].to(cdt)).to(torch.float32)
    return torch.log_softmax(logits, -1)


def encoder_stream_step(params: dict, cfg: EncoderConfig,
                        feats: torch.Tensor, state: EmformerState,
                        reset=None, advance=None
                        ) -> Tuple[torch.Tensor, EmformerState]:
    """feats [B, T_mel, input_dim] for one chunk (T_mel reduces to exactly
    U + R frames) -> (log_probs [B, U, vocab], new_state)."""
    x = _pre_emformer(params, cfg, feats)
    em = cfg.emformer
    assert x.shape[1] == em.segment_length + em.right_context_length, (
        f"chunk reduces to {x.shape[1]} frames, expected "
        f"{em.segment_length}+{em.right_context_length}")
    enc, new_state = emformer_stream_step(params["emformer"], em, x, state,
                                          reset=reset, advance=advance)
    return ctc_head(params, cfg, enc), new_state


def encoder_forward(params: dict, cfg: EncoderConfig, feats: torch.Tensor,
                    feat_lens: Optional[torch.Tensor] = None, tp=None):
    """Offline forward (the streaming step over chunks).  Returns
    (log_probs [B, T_out, vocab], out_lens in emission frames).  ``tp``:
    ``params`` is a tensor-parallel shard (``emformer_forward``,
    ``ctc_head``); the log-probs are whole on every rank."""
    x = _pre_emformer(params, cfg, feats)
    enc, _ = emformer_forward(params["emformer"], cfg.emformer, x, tp=tp)
    enc = enc[:, :x.shape[1]]
    log_probs = ctc_head(params, cfg, enc, tp)
    out_lens = None
    if feat_lens is not None:
        out_lens = torch.clamp(torch.div(feat_lens - 1, cfg.stride,
                                         rounding_mode="floor") + 1,
                               max=log_probs.shape[1])
    return log_probs, out_lens
